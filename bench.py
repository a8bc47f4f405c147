"""Benchmark: full SCP solves/s on one GPU (BASELINE.md target: >= 1000
solves/s on solo12 trot, N=50).

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", ...},
naming the device it ran on (platform, device_kind, count, the card's
name and power limit), the matmul precision and XLA_FLAGS.  The headline
number carries its own accuracy (x_err_inf/u_err_inf of an UNPERTURBED
scenario vs the f64 eps=1e-7+polish reference), every accuracy tier runs
at the HEADLINE's batch/rho/cadence settings so tiers are comparable,
and the record additionally contains an N=165 reference-shape row, a
stochastic row, a per-problem latency distribution, the sweep-kernel
checks and the warm-started MPC tick latency.

Timing methodology: every throughput/latency metric runs k back-to-back
solves inside ONE jitted lax.scan (cycling pre-staged inputs via a
traced index, or threading a ~1e-30 carry perturbation, so nothing
hoists), reads back one scalar, and takes the difference quotient
between two chain lengths: the per-call dispatch and readback constants
cancel and the number is device time per solve.  A timed run needs a
GPU and exits non-zero without one; `--trace-only` lowers every program
without running it and works on the CPU.
"""
import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from centroidal_mpc_tpu.config import presets
from centroidal_mpc_tpu.ops.admm import QPSettings
from centroidal_mpc_tpu.parallel.batch import batched_solve, tile_ocp_config
from centroidal_mpc_tpu.utils.compile_cache import enable_compile_cache
from centroidal_mpc_tpu.utils.profiling import gpu_name_and_power_limit

BASELINE_SOLVES_PER_S = 1000.0


def per_call_time(solve_fn, inputs, k=10, trials=3):
    """Amortized per-solve seconds: in-jit scan chains of back-to-back
    solves at two lengths; the difference quotient cancels the per-call
    constants (see module docstring).  `solve_fn` maps one arg-tuple to
    a solution pytree; `inputs` is a list of distinct arg-tuples, cycled
    per step via a traced index so the loop body cannot be hoisted."""
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *inputs)
    n_in = len(inputs)

    @functools.partial(jax.jit, static_argnums=1)
    def chain(st, kk):
        def body(carry, i):
            args = jax.tree.map(
                lambda a: jax.lax.dynamic_index_in_dim(a, i % n_in,
                                                       keepdims=False), st)
            sol = solve_fn(*args)
            # reduce over ALL leaves so no output (and no work feeding
            # it) is dead-code-eliminated -- same liveness as the
            # latency probe (round-2 advisor finding)
            acc = sum(l.sum().astype(jnp.float32)
                      for l in jax.tree.leaves(sol))
            return carry + acc * 1e-20, None
        out, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32),
                              jnp.arange(kk), length=kk)
        return out

    k1, k2 = 2, 2 + k
    float(chain(stacked, k1)), float(chain(stacked, k2))  # compile

    def best(kk):
        b = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            float(chain(stacked, kk))
            b = min(b, time.perf_counter() - t0)
        return b

    return max((best(k2) - best(k1)) / (k2 - k1), 1e-9)


def chip_latency_distribution(solve_fn, inputs, k=6, trials=2):
    """Per-PROBLEM device time distribution.

    One jitted chain runs k solves of the SAME problem index back to
    back; a ~1e-30 carry perturbation of the initial state threads each
    solve's output into the next one's input so XLA cannot hoist the
    loop-invariant solve out of the scan.  The difference quotient per
    problem is device time; the distribution over distinct problems
    (different perturbed initial states -> different ADMM iteration
    counts) is the single-solve latency distribution without host
    dispatch."""
    import numpy as np
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *inputs)

    @functools.partial(jax.jit, static_argnums=1)
    def chain(st, kk, idx):
        def body(carry, _):
            cfg, X0, U0 = jax.tree.map(
                lambda a: jax.lax.dynamic_index_in_dim(a, idx,
                                                       keepdims=False), st)
            # thread the carry into the input at ~1e-30 scale: defeats
            # hoisting/CSE without perturbing the solve
            X0 = X0 + carry * 1e-30
            cfg = cfg.replace(x_init=cfg.x_init + carry * 1e-30)
            sol = solve_fn(cfg, X0, U0)
            acc = sum(l.sum().astype(jnp.float32)
                      for l in jax.tree.leaves(sol))
            return carry + acc * 1e-20, None
        out, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32),
                              None, length=kk)
        return out

    k1, k2 = 1, 1 + k
    idx0 = jnp.zeros((), jnp.int32)
    float(chain(stacked, k1, idx0)), float(chain(stacked, k2, idx0))

    times = []
    for i in range(len(inputs)):
        idx = jnp.asarray(i, jnp.int32)

        def best(kk):
            b = float("inf")
            for _ in range(trials):
                t0 = time.perf_counter()
                float(chain(stacked, kk, idx))
                b = min(b, time.perf_counter() - t0)
            return b

        times.append(max((best(k2) - best(k1)) / (k2 - k1), 1e-9))
    ts = np.asarray(times) * 1e3
    return {"p50_ms": round(float(np.percentile(ts, 50)), 3),
            "p99_ms": round(float(np.percentile(ts, 99)), 3),
            "min_ms": round(float(ts.min()), 3),
            "max_ms": round(float(ts.max()), 3),
            "n_problems": len(inputs)}


def ref_cache_path(preset, stochastic=False, ref_max_iter=20000) -> str:
    """Path of the cached f64 reference solution of `preset`."""
    import hashlib
    h = hashlib.sha1(repr((preset, stochastic, ref_max_iter))
                     .encode()).hexdigest()[:12]
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "ref_cache",
                        f"{preset.name}{'_stoch' if stochastic else ''}"
                        f"_{h}.npz")


def f64_reference(preset, args, stochastic=False):
    """The reference operating point (OSQP eps=1e-7 + polish,
    src/scp_solver.py:62-63) solved in f64 on the host CPU backend.

    Results are cached under benchmarks/ref_cache/ keyed by a hash of
    the full preset repr (concrete scalars/tuples) + settings
    (`ref_cache_path`): the XLA:CPU compile of the f64 SCP program costs
    minutes per preset, and the reference solution itself is
    deterministic f64 -- so bench runs load the committed cache and only
    recompute when the problem actually changes."""
    import numpy as np
    from centroidal_mpc_tpu.solver.scp import solve_scp

    cache = ref_cache_path(preset, stochastic, args.ref_max_iter)
    if not args.trace_only and not args.no_ref_cache \
            and os.path.exists(cache):
        d = np.load(cache)
        return d["X"], d["U"]

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        qp64 = QPSettings(eps_abs=1e-7, eps_rel=1e-7,
                          max_iter=args.ref_max_iter,
                          adaptive_rho=True, polish=True)
        p64 = presets.build_problem(preset, stochastic=stochastic,
                                    dtype=jnp.float64, qp=qp64)
        p64 = dataclasses.replace(
            p64, scp=dataclasses.replace(p64.scp, qp_backend="block"))
        if args.trace_only:
            jax.jit(lambda c, x, u: solve_scp(
                p64.model, p64.plan.schedule, c, x, u,
                p64.scp)).lower(p64.ocp, p64.X0, p64.U0)
            return np.zeros(p64.X0.shape), np.zeros(p64.U0.shape)
        sol64 = solve_scp(p64.model, p64.plan.schedule, p64.ocp,
                          p64.X0, p64.U0, p64.scp)
        assert bool(sol64.success), "f64 reference SCP failed"
        X, U = (np.asarray(sol64.X, np.float64),
                np.asarray(sol64.U, np.float64))
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    np.savez(cache, X=X, U=U)
    return X, U


@contextlib.contextmanager
def xla_scan_sweeps():
    """Trace the block solver with the XLA scan sweeps on every platform:
    on a GPU, the fused sweep kernel's comparison (kernel_parity,
    benchmarks/sweep_ab.py).  Programs keep what was traced inside."""
    from unittest import mock

    from centroidal_mpc_tpu.ops import blockqp
    with mock.patch.object(blockqp, "_sequential_sweeps",
                           blockqp._scan_sweeps):
        yield


def qp_settings(args, eps=None, polish=None):
    return QPSettings(
        eps_abs=args.eps if eps is None else eps,
        eps_rel=args.eps if eps is None else eps,
        max_iter=args.qp_max_iter,
        adaptive_rho=(args.rho == "always"),
        adaptive_rho_mode="always", sweep_method=args.sweep,
        factor_method=args.factor,
        polish=args.polish if polish is None else polish,
        check_interval=args.check_interval, alpha=args.alpha,
        # At the headline eps the dual-refinement CG only has to beat
        # the accept gate, not a tight dual threshold: 8 iterations /
        # 1 restart (u_err 5.9e-5 vs 3.0e-5 with the full budget --
        # both well inside the 1e-4 bar).  The tight tiers restore the
        # full CG budget via per-tier overrides.
        polish_iters=args.polish_alm_iters,
        polish_rounds=args.polish_rounds,
        polish_cg_iters=args.polish_cg_iters,
        polish_cg_restarts=args.polish_cg_restarts,
        # below the f32 ADMM floor (tight-eps tiers) the loop stalls;
        # exit after 30 no-improvement checks and let the refinement
        # polish close the gap instead of burning qp_max_iter
        stall_segments=args.stall_segments)


def build_f32_problem(args, preset, eps=None, polish=None,
                      stochastic=False):
    prob = presets.build_problem(preset, stochastic=stochastic,
                                 dtype=jnp.float32,
                                 qp=qp_settings(args, eps, polish))
    return dataclasses.replace(
        prob, scp=dataclasses.replace(prob.scp, qp_backend=args.backend,
                                      norm_method="power"))


def bench_inputs(prob, batch, n_variants=4, perturb=True):
    """Distinct pre-staged inputs so chained calls cannot alias/cache.
    Scenario 0 of variant 0 is UNPERTURBED: its solution is directly
    comparable to the f64 reference solve of the preset (the headline
    accuracy label)."""
    key = jax.random.PRNGKey(0)
    dx = jnp.zeros((batch, 9), jnp.float32)
    if perturb and batch > 1:
        dx = dx.at[1:, :2].set(
            0.005 * jax.random.normal(key, (batch - 1, 2), jnp.float32))
    X0 = (jnp.broadcast_to(prob.X0, (batch,) + prob.X0.shape)
          + dx[:, None, :])
    U0 = jnp.broadcast_to(prob.U0, (batch,) + prob.U0.shape)
    inputs = []
    for r in range(n_variants):
        X0r = X0 + 1e-4 * r
        inputs.append((tile_ocp_config(prob.ocp, X0r[:, 0], X0r[:, -1],
                                       X0r), X0r, U0))
    return inputs, U0


def solution_errors(sol, X_ref, U_ref, scenario=0):
    import numpy as np
    x_err = float(jnp.max(jnp.abs(
        sol.X[scenario].astype(jnp.float32)
        - jnp.asarray(np.asarray(X_ref), jnp.float32))))
    u_err = float(jnp.max(jnp.abs(
        sol.U[scenario].astype(jnp.float32)
        - jnp.asarray(np.asarray(U_ref), jnp.float32))))
    return round(x_err, 8), round(u_err, 8)


def accuracy_tiers(args, preset, X_ref, U_ref):
    """Accuracy-at-speed table at the HEADLINE's batch, rho mode,
    check cadence and alpha (VERDICT round 3, weak item 1: the round-3
    tiers ran different batch/rho settings than the headline, producing
    an unexplained 8.5x throughput spread at the same eps).  Only eps
    and polish vary across tiers."""
    # The 1e-5 tier relies on the two-float (hi, lo) dual carried
    # through the polish CG and the final residual evaluation
    # (ops/blockqp._two_sum): one f32 ulp of the O(1e2) scaled equality
    # duals is the size of the whole eps=1e-5 residual.
    tiers = [(5e-4, False, {}), (5e-4, True, {}),
             (1e-4, True, {"polish_cg_iters": 15,
                           "polish_cg_restarts": 2}),
             (1e-5, True, {"polish_rho_ramp": 10.0,
                           "polish_cg_restarts": 3,
                           "polish_cg_iters": 20})]
    out = []
    for eps, polish, over in tiers:
        prob = build_f32_problem(args, preset, eps=eps, polish=polish)
        if over:
            qp2 = dataclasses.replace(prob.scp.qp, **over)
            prob = dataclasses.replace(
                prob, scp=dataclasses.replace(prob.scp, qp=qp2))
        solve = jax.jit(lambda c, x, u, _p=prob: batched_solve(
            _p.model, _p.plan.schedule, c, x, u, _p.scp))
        inputs, _ = bench_inputs(prob, args.batch, n_variants=2)
        if args.trace_only:
            solve.lower(*inputs[0])
            out.append({"eps": eps, "polish": polish, "traced": True})
            continue
        sol = solve(*inputs[0])
        jax.block_until_ready(sol)
        x_err, u_err = solution_errors(sol, X_ref, U_ref)
        t = per_call_time(solve, inputs, max(args.chain // 2, 3), 2)
        out.append({"eps": eps, "polish": polish,
                    "solves_per_s": round(args.batch / t, 1),
                    "success_frac": round(
                        float(jnp.mean(sol.success.astype(jnp.float32))),
                        3),
                    "mean_qp_iters": round(
                        float(jnp.mean(sol.qp_iterations)), 0),
                    "x_err_inf": x_err, "u_err_inf": u_err})
    return out


def latency_distribution(solve1, in1, n_probes: int):
    """Host-observed p50/p99 single-solve latency: one jitted call and
    one scalar readback per probe, dispatch included."""
    import numpy as np

    @jax.jit
    def probe(*a):
        sol = solve1(*a)
        return sum(l.sum().astype(jnp.float32)
                   for l in jax.tree.leaves(sol))

    float(probe(*in1[0]))  # compile
    ts = []
    for i in range(n_probes):
        t0 = time.perf_counter()
        float(probe(*in1[i % len(in1)]))
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return (float(np.percentile(ts, 50) * 1e3),
            float(np.percentile(ts, 99) * 1e3))


def kernel_parity(args, preset):
    """Compiled sweep-kernel self-certification: CI runs the kernel in
    interpret mode only, so every bench run solves one batch with the
    kernel (the GPU's sequential sweeps) AND with the XLA scan sweeps
    and compares the solutions.  Both run at a DEEP-POLISHED operating point (the
    eps=1e-4 accuracy tier: each lands ~8e-6 from the true solution, so
    their mutual deviation is ~1e-5 and the 1e-3 gate has 100x margin).
    Returns a dict recorded in the bench JSON."""
    batch = min(args.batch, 64)
    prob = build_f32_problem(args, preset, eps=1e-4, polish=True)
    qp_deep = dataclasses.replace(prob.scp.qp, polish_cg_iters=15,
                                  polish_cg_restarts=2)
    inputs, _ = bench_inputs(prob, batch, n_variants=1)
    scp_s = dataclasses.replace(prob.scp, qp=qp_deep)
    sols = []
    for sweeps in (contextlib.nullcontext, xla_scan_sweeps):
        solve = jax.jit(lambda c, x, u: batched_solve(
            prob.model, prob.plan.schedule, c, x, u, scp_s))
        with sweeps():
            sols.append(solve(*inputs[0]))
        jax.block_until_ready(sols[-1])
    sol_k, sol_ref = sols
    x_err = float(jnp.max(jnp.abs(sol_k.X - sol_ref.X)))
    u_err = float(jnp.max(jnp.abs(sol_k.U - sol_ref.U)))
    # scale-relative: X is O(0.2 m) CoM coordinates, U is O(10 N) forces
    x_rel = x_err / max(float(jnp.abs(sol_ref.X).max()), 1e-30)
    u_rel = u_err / max(float(jnp.abs(sol_ref.U).max()), 1e-30)
    it_diff = float(jnp.mean(jnp.abs(
        sol_k.qp_iterations.astype(jnp.float32)
        - sol_ref.qp_iterations.astype(jnp.float32))))
    tol = args.parity_tol if args.parity_tol is not None else 1e-3
    return {"x_err_inf": x_err, "u_err_inf": u_err,
            "x_err_rel": x_rel, "u_err_rel": u_rel,
            "mean_qp_iter_diff": it_diff, "tol_rel": tol,
            "ok": bool(x_rel < tol and u_rel < tol)}


def kernel_exact(args):
    """Exact compiled-kernel check: the sweep kernel against the XLA
    scan sweep on the same blocked-Cholesky factor of a well-conditioned
    random block-tridiagonal system at the headline shape (51 knots,
    V=22).  On a cond ~30 system two f32 algorithms agree to
    ~cond * eps_f32 * sqrt(V) ~ 1e-5; the 1e-4 gate catches any
    miscompile far below the band of the full-solve parity check."""
    from centroidal_mpc_tpu.ops import blockqp

    b, n, v = args.batch, 50, 22
    key = jax.random.PRNGKey(7)
    k1, k2, k3 = jax.random.split(key, 3)
    off = 0.2 * jax.random.normal(k1, (b, n, v, v), jnp.float32)
    r = jax.random.normal(k2, (b, n + 1, v, v), jnp.float32)
    diag = (jnp.einsum("bkij,bklj->bkil", r, r) / v
            + 3.0 * jnp.eye(v, dtype=jnp.float32))
    rhs = jax.random.normal(k3, (b, n + 1, v), jnp.float32)

    def solve(sweeps):
        return jax.jit(jax.vmap(lambda d, o, q: sweeps(
            blockqp._block_tridiag_cholesky(d, o), q)))

    out_k = solve(blockqp._kernel_sweeps)(diag, off, rhs)
    out_x = solve(blockqp._scan_sweeps)(diag, off, rhs)
    scale = float(jnp.abs(out_x).max())
    err = float(jnp.abs(out_k - out_x).max()) / max(scale, 1e-30)
    return {"rel_err": err, "tol": 1e-4, "ok": bool(err < 1e-4)}


def mpc_tick(args, preset):
    """Warm-started receding-horizon tick latency (solver/mpc.py), the
    deployment story (VERDICT round 3, item 9).  Chip time per tick via
    an in-jit chain of ticks (the MpcState carry serializes the chain
    naturally -- no hoisting risk).

    Latency mode: polish off.  The receding-horizon loop re-solves every
    10 ms tick from a 1-knot-shifted warm start and closes residuals
    with LQR feedback, so the per-tick QP runs at the loose-eps
    operating point and skips the refinement polish."""
    from centroidal_mpc_tpu.solver.mpc import MpcController

    prob = build_f32_problem(args, preset, eps=5e-4, polish=False)
    # the free-terminal window QP family converges poorly at the
    # batch-throughput fixed rho (measured 460-650 iterations/tick vs
    # 92 for the full-horizon problem); single-solve ticks use lazy
    # 'cond' rho adaptation instead (cheap unbatched -- lax.cond does
    # not execute both branches outside vmap)
    qp_tick = dataclasses.replace(prob.scp.qp, adaptive_rho=True,
                                  adaptive_rho_mode="cond")
    settings = dataclasses.replace(prob.scp, max_iterations=1, qp=qp_tick)
    cfg = prob.ocp.replace(terminal_equality=False)
    window = min(args.mpc_window, prob.plan.schedule.horizon - 1)
    ctl = MpcController(model=prob.model, schedule=prob.plan.schedule,
                        cfg=cfg, settings=settings, window=window)
    state0 = ctl.init_state(prob.X0, prob.U0)
    x0 = jnp.asarray(prob.X0[0], jnp.float32)

    @functools.partial(jax.jit, static_argnums=1)
    def chain(st, kk):
        def body(carry, _):
            s, x, acc = carry
            s, sol = ctl.step(s, x + acc * 1e-30)
            acc = acc + sum(l.sum().astype(jnp.float32)
                            for l in jax.tree.leaves(sol)) * 1e-20
            # perfect-tracking closed loop: next tick measures the
            # plan's next knot (a fixed x_meas would fall ever further
            # behind the sliding window and inflate QP iterations)
            return (s, sol.X[1], acc), None
        (s, x, acc), _ = jax.lax.scan(
            body, (st, x0, jnp.zeros((), jnp.float32)), None, length=kk)
        return acc

    if args.trace_only:
        chain.lower(state0, 3)
        return None
    k1, k2 = 2, 2 + max(args.chain, 6)
    float(chain(state0, k1)), float(chain(state0, k2))  # compile

    def best(kk):
        b = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            float(chain(state0, kk))
            b = min(b, time.perf_counter() - t0)
        return b

    return round(max((best(k2) - best(k1)) / (k2 - k1), 1e-9) * 1e3, 3)


def stochastic_record(args, preset):
    """Chance-constrained mode as a first-class metric (VERDICT round 3,
    item 2: previously only a help-text claim)."""
    batch = min(args.batch, 64)
    X_ref, U_ref = f64_reference(preset, args, stochastic=True)
    prob = build_f32_problem(args, preset, eps=5e-4, polish=True,
                             stochastic=True)
    solve = jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))
    inputs, _ = bench_inputs(prob, batch, n_variants=2)
    if args.trace_only:
        solve.lower(*inputs[0])
        return {"traced": True}
    sol = solve(*inputs[0])
    jax.block_until_ready(sol)
    x_err, u_err = solution_errors(sol, X_ref, U_ref)
    t = per_call_time(solve, inputs, max(args.chain // 2, 3), 2)
    return {"batch": batch,
            "solves_per_s": round(batch / t, 1),
            "success_frac": round(
                float(jnp.mean(sol.success.astype(jnp.float32))), 3),
            "mean_qp_iters": round(float(jnp.mean(sol.qp_iterations)), 0),
            "x_err_inf": x_err, "u_err_inf": u_err}


def n165_record(args):
    """The reference's own problem shape (VERDICT round 3, missing item
    3): solo12 trot at N=165 (conf_solo12_trot.py:50) on the chip, with
    throughput and accuracy vs its f64 reference solve."""
    preset = presets.PRESETS["solo12_trot"]
    batch = min(args.batch, args.n165_batch)
    X_ref, U_ref = f64_reference(preset, args)
    prob = build_f32_problem(args, preset, eps=5e-4, polish=True)
    solve = jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))
    inputs, _ = bench_inputs(prob, batch, n_variants=2)
    if args.trace_only:
        solve.lower(*inputs[0])
        return {"traced": True}
    sol = solve(*inputs[0])
    jax.block_until_ready(sol)
    x_err, u_err = solution_errors(sol, X_ref, U_ref)
    t = per_call_time(solve, inputs, max(args.chain // 2, 3), 2)
    return {"horizon": 165, "batch": batch,
            "solves_per_s": round(batch / t, 1),
            "success_frac": round(
                float(jnp.mean(sol.success.astype(jnp.float32))), 3),
            "mean_qp_iters": round(float(jnp.mean(sol.qp_iterations)), 0),
            "x_err_inf": x_err, "u_err_inf": u_err}


def preset_matrix(args):
    """Driver-captured per-preset on-chip rows (VERDICT round-4 item 4:
    the five-preset coverage numbers lived only in PARITY prose).  For
    each robot/gait preset beyond the headline: a small-batch
    full-horizon throughput row with success fraction and u_err vs the
    preset's cached f64 eps=1e-7+polish reference, plus the rho mode
    used.  The talos wrench6 row pins the measured rho-mode
    sensitivity as data: the solo12-tuned fixed rho=0.1 converges only
    ~1/32 lanes on the CoP/force-scaled wrench6 QP family, so that row
    runs adaptive_rho_mode='always' (PARITY round 4)."""
    rows = {}
    batch = min(args.batch, args.preset_batch)
    for name in [p for p in args.preset_matrix.split(",") if p]:
        preset = presets.PRESETS[name]
        rho_always = preset.robot.n_u_per_contact == 6
        X_ref = U_ref = None
        if not args.trace_only:
            X_ref, U_ref = f64_reference(preset, args)
        prob = build_f32_problem(args, preset, eps=5e-4, polish=True)
        if rho_always:
            qp2 = dataclasses.replace(prob.scp.qp, adaptive_rho=True,
                                      adaptive_rho_mode="always")
            prob = dataclasses.replace(
                prob, scp=dataclasses.replace(prob.scp, qp=qp2))
        solve = jax.jit(lambda c, x, u, _p=prob: batched_solve(
            _p.model, _p.plan.schedule, c, x, u, _p.scp))
        inputs, _ = bench_inputs(prob, batch, n_variants=2)
        if args.trace_only:
            solve.lower(*inputs[0])
            rows[name] = {"traced": True}
            continue
        sol = solve(*inputs[0])
        jax.block_until_ready(sol)
        x_err, u_err = solution_errors(sol, X_ref, U_ref)
        t = per_call_time(solve, inputs, max(args.chain // 2, 3), 2)
        rows[name] = {
            "horizon": int(prob.plan.schedule.horizon), "batch": batch,
            "solves_per_s": round(batch / t, 1),
            "success_frac": round(
                float(jnp.mean(sol.success.astype(jnp.float32))), 3),
            "mean_qp_iters": round(float(jnp.mean(sol.qp_iterations)), 0),
            "rho_mode": "always" if rho_always else args.rho,
            "x_err_inf": x_err, "u_err_inf": u_err}
    return rows


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--chain", type=int, default=10,
                    help="solves per timed chain (difference quotient)")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--preset", default="solo12_trot_n50",
                    choices=sorted(presets.PRESETS))
    ap.add_argument("--backend", default="block",
                    choices=["block", "dense"])
    ap.add_argument("--latency-probes", type=int, default=200,
                    help="0 disables the host-observed latency numbers")
    ap.add_argument("--chip-latency-problems", type=int, default=12,
                    help="distinct problems for the chip-side latency "
                         "distribution; 0 disables")
    ap.add_argument("--sweep", default="scan", choices=["scan", "assoc"],
                    help="backsolve sweeps: sequential (on a GPU the "
                         "fused kernel, ops/sweep_kernel.py; elsewhere "
                         "XLA scans) or associative scan")
    ap.add_argument("--factor", default="cholesky",
                    choices=["cholesky", "thomas"],
                    help="block-tridiagonal factorization backend")
    ap.add_argument("--eps", type=float, default=5e-4,
                    help="ADMM eps_abs/eps_rel")
    ap.add_argument("--polish", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="active-set refinement polish after ADMM (the "
                         "f32 path to the 1e-4 parity bar; --no-polish "
                         "for the raw-ADMM operating point)")
    ap.add_argument("--rho", default="fixed", choices=["fixed", "always"],
                    help="fixed rho, or batched scheduled adaptation")
    ap.add_argument("--no-accuracy", action="store_true",
                    help="skip the accuracy-at-speed tier table")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the sweep-kernel checks (kernel_parity, "
                         "kernel_exact)")
    ap.add_argument("--no-stochastic", action="store_true",
                    help="skip the stochastic-mode record")
    ap.add_argument("--no-n165", action="store_true",
                    help="skip the N=165 reference-shape record")
    ap.add_argument("--no-presets", action="store_true",
                    help="skip the per-preset coverage matrix")
    ap.add_argument("--preset-matrix",
                    default="solo12_pace,solo12_bound,bolt_pace,"
                            "talos_pace",
                    help="comma list of presets for the coverage matrix")
    ap.add_argument("--preset-batch", type=int, default=32)
    ap.add_argument("--no-mpc", action="store_true",
                    help="skip the MPC tick-latency record")
    ap.add_argument("--mpc-window", type=int, default=20)
    ap.add_argument("--n165-batch", type=int, default=32)
    ap.add_argument("--parity-tol", type=float, default=None,
                    help="relative tolerance for the kernel parity check "
                         "(default 1e-3; both paths run deep-polished at "
                         "eps=1e-4 so their expected deviation is ~1e-5; "
                         "a miscompiled kernel differs by O(1) and is "
                         "additionally caught at ~1e-5 by the "
                         "kernel_exact check)")
    ap.add_argument("--qp-max-iter", type=int, default=4000,
                    help="ADMM iteration cap (throughput + tier solves)")
    ap.add_argument("--check-interval", type=int, default=10,
                    help="residual-check cadence: smaller stops closer "
                         "to true convergence")
    ap.add_argument("--alpha", type=float, default=1.7,
                    help="ADMM over-relaxation (1.7 converges in ~92 "
                         "iters vs 96 at the OSQP-default 1.6; 1.9 "
                         "diverges on this problem family)")
    ap.add_argument("--polish-alm-iters", type=int, default=12,
                    help="refinement-polish ALM sweeps per round")
    ap.add_argument("--polish-rounds", type=int, default=3,
                    help="active-set detection rounds of the polish: "
                         "with 2, a scenario that stops at its loose eps "
                         "can keep a mislabeled row and land 2e-3 to "
                         "1.5e-1 from its f64 solution (PERF.md)")
    ap.add_argument("--polish-cg-iters", type=int, default=8,
                    help="dual-refinement CG iterations per phase")
    ap.add_argument("--polish-cg-restarts", type=int, default=1)
    ap.add_argument("--stall-segments", type=int, default=30,
                    help="no-improvement residual checks before the "
                         "ADMM loop hands over to the polish (0 "
                         "disables)")
    ap.add_argument("--no-ref-cache", action="store_true",
                    help="recompute the f64 reference solves instead of "
                         "loading benchmarks/ref_cache/")
    ap.add_argument("--ref-max-iter", type=int, default=20000,
                    help="ADMM iteration cap for the f64 reference solve")
    ap.add_argument("--trace-only", action="store_true",
                    help="jit-lower every configured program without "
                         "compiling/executing (CI smoke on the CPU; the "
                         "GPU-only sweep-kernel checks are skipped)")
    return ap


def validate_args(args):
    """Fail fast on values that would crash at trace time or silently
    diverge (round-3 advisor findings)."""
    if args.check_interval < 1:
        raise SystemExit("--check-interval must be >= 1 (the ADMM loop "
                         "segments max_iter into check_interval blocks)")
    if not 0.0 < args.alpha < 2.0:
        raise SystemExit("--alpha must be in (0, 2): ADMM over-"
                         "relaxation outside that range diverges")
    if args.batch < 1 or args.chain < 1 or args.qp_max_iter < 1:
        raise SystemExit("--batch/--chain/--qp-max-iter must be >= 1")


def run(args):
    """Everything main() does, parameterized; returns the record dict.
    Driven at tiny scale by tests/test_bench_smoke.py so every bench
    configuration is CI-traced."""
    validate_args(args)
    dev = jax.devices()[0]
    if not args.trace_only and dev.platform != "gpu":
        raise SystemExit(f"bench.py times the GPU; found {dev.platform} "
                         "(use --trace-only to lower the programs on CPU)")
    preset = presets.PRESETS[args.preset]
    prob = build_f32_problem(args, preset)
    batch = args.batch

    solve = jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))
    inputs, U0 = bench_inputs(prob, batch)

    # headline accuracy label: f64 reference at the OSQP operating point
    X_ref = U_ref = None
    if not args.no_accuracy:
        X_ref, U_ref = f64_reference(preset, args)

    record = {
        "metric": "scp_solves_per_s_per_chip",
        "value": 0.0, "unit": "solves/s", "vs_baseline": 0.0,
        "batch": batch,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "card": (gpu_name_and_power_limit()
                            if dev.platform == "gpu" else None)},
        # no global flag: the solver pins its products at its entry
        # points (utils/precision.py)
        "matmul_precision": "highest (pinned by the library)",
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        # self-describing operating point (round-3 advisor finding:
        # bench defaults diverged from QPSettings defaults silently)
        "settings": {
            "preset": args.preset, "backend": args.backend,
            "factor": args.factor, "sweep": args.sweep,
            "eps": args.eps, "polish": args.polish, "rho": args.rho,
            "check_interval": args.check_interval, "alpha": args.alpha,
            "qp_max_iter": args.qp_max_iter,
            "polish_cg": [prob.scp.qp.polish_cg_iters,
                          prob.scp.qp.polish_cg_restarts],
            "polish_alm": [prob.scp.qp.polish_iters,
                           prob.scp.qp.polish_rounds]},
    }

    if args.trace_only:
        solve.lower(*inputs[0])
        if args.latency_probes > 0 or args.chip_latency_problems > 0:
            in1, _ = bench_inputs(prob, 1, n_variants=1)
            solve.lower(*in1[0])
        if not args.no_accuracy:
            record["accuracy_tiers"] = accuracy_tiers(args, preset,
                                                      X_ref, U_ref)
        if not args.no_mpc:
            mpc_tick(args, preset)
        if not args.no_stochastic:
            record["stochastic"] = stochastic_record(args, preset)
        if not args.no_presets:
            record["presets"] = preset_matrix(args)
        record["trace_only"] = True
        record["_stderr"] = "# trace-only run (no execution)"
        return record

    sol = solve(*inputs[0])  # compile + warm up
    n_success = int(jnp.sum(sol.success))

    t_solve = per_call_time(solve, inputs, args.chain, args.trials)
    solves_per_s = batch / t_solve

    record.update({
        "value": round(solves_per_s, 2),
        "vs_baseline": round(solves_per_s / BASELINE_SOLVES_PER_S, 3),
        "n_success": n_success,
        "mean_qp_iters": round(float(jnp.mean(sol.qp_iterations)), 1),
    })
    if X_ref is not None:
        x_err, u_err = solution_errors(sol, X_ref, U_ref)
        record["x_err_inf"] = x_err
        record["u_err_inf"] = u_err

    # single-solve latency: amortized device time at batch 1, the
    # per-problem device-time distribution, and the host-observed
    # distribution (dispatch included)
    lat_ms = p50_ms = p99_ms = float("nan")
    if args.latency_probes > 0 or args.chip_latency_problems > 0:
        solve1 = jax.jit(lambda c, x, u: batched_solve(
            prob.model, prob.plan.schedule, c, x, u, prob.scp))
        in1 = []
        key = jax.random.PRNGKey(1)
        dxs = 0.005 * jax.random.normal(
            key, (max(args.chip_latency_problems, 4), 2), jnp.float32)
        for r in range(max(args.chip_latency_problems, 4)):
            X1 = jnp.asarray(prob.X0, jnp.float32)[None]
            X1 = X1.at[:, :, :2].add(dxs[r][None, None, :])
            in1.append((tile_ocp_config(prob.ocp, X1[:, 0], X1[:, -1],
                                        X1), X1, U0[:1]))
        out = solve1(*in1[0])
        jax.block_until_ready(out)
        lat_ms = per_call_time(solve1, in1[:4], args.chain,
                               args.trials) * 1e3
        record["latency_chip_ms"] = round(lat_ms, 3)
        if args.chip_latency_problems > 0:
            record["chip_latency"] = chip_latency_distribution(
                solve1, in1[:args.chip_latency_problems])
        if args.latency_probes > 0:
            p50_ms, p99_ms = latency_distribution(
                solve1, in1[:4], args.latency_probes)
            record["latency_p50_ms"] = round(p50_ms, 3)
            record["latency_p99_ms"] = round(p99_ms, 3)

    if not args.no_parity:
        record["kernel_parity"] = kernel_parity(args, preset)
        record["kernel_exact"] = kernel_exact(args)

    if not args.no_accuracy:
        record["accuracy_tiers"] = accuracy_tiers(args, preset, X_ref,
                                                  U_ref)

    if not args.no_mpc:
        record["mpc_tick_ms"] = mpc_tick(args, preset)

    if not args.no_stochastic:
        record["stochastic"] = stochastic_record(args, preset)

    if not args.no_n165:
        record["n165"] = n165_record(args)

    if not args.no_presets:
        record["presets"] = preset_matrix(args)

    record["_stderr"] = (
        f"# backend={args.backend} batch={batch} "
        f"batch_time={t_solve*1e3:.2f}ms "
        f"success={n_success}/{batch} mean_qp_iters="
        f"{float(jnp.mean(sol.qp_iterations)):.0f} "
        f"latency_single={lat_ms:.2f}ms p50={p50_ms:.2f}ms "
        f"p99={p99_ms:.2f}ms "
        f"device={dev.device_kind}")
    return record


def main():
    args = build_parser().parse_args()
    enable_compile_cache()
    record = run(args)
    info = record.pop("_stderr")
    print(json.dumps(record))
    print(info, file=sys.stderr)


if __name__ == "__main__":
    main()
