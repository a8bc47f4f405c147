"""Smoke test of the SCP solver on one GPU, through the library's entry points.

    python chip_smoke.py              # phases a-g on one card
    python chip_smoke.py --four-cards # the scenario-sharded solve on 4 cards

Runs the main path once at the repository's real problem sizes, in f32,
with no global precision flag (the library pins its own matrix-product
precision), and checks every result against the committed f64 reference
solutions of the bench (`benchmarks/ref_cache/`, loaded by the bench's own
cache key; a miss is an error).  Phases (one card):

  a. the sweep kernel (ops/sweep_kernel.py) against the XLA scan sweep on
     the factor of a real headline QP batch, and against a dense f64
     solve;
  b. `batched_solve` of solo12_trot_n50 at batch 128 with the bench's
     headline settings;
  c. one unbatched `solve_scp` of the same problem;
  d. the chance-constrained (stochastic) problem at batch 16;
  e. the reference horizon (solo12_trot, N=165) at batch 8;
  f. `MpcController`: 20 warm-started ticks of a 20-knot window;
  g. `run_pipeline`: warm start, nominal and stochastic SCP, whole-body
     tracking and Monte-Carlo.

The jitted programs of a-f are lowered first and compiled side by side in
threads (compilation is host work), while g runs.  Earlier lines give the
card, JAX's view of it, and per phase its compile seconds (set-up) and
run seconds (smoke wall time); these are not metrics.  The last line is
one JSON object, printed only if every phase passed.  Without a GPU the
script exits non-zero before running anything.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import sys
import tempfile
import time

PARITY_TOL = 1e-4       # BASELINE parity bar: |X - X_ref|, |U - U_ref|
SHARD_BAND = 1e-3       # sharded vs unsharded (__graft_entry__.py)
KERNEL_TOL = 1e-4       # two f32 backsolves of one factor (bench.py)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of the phases (the real ones by default; the CPU
    rehearsal in tests/test_bench_smoke.py passes a tiny preset)."""

    headline: str = "solo12_trot_n50"
    headline_batch: int = 128
    stoch_batch: int = 16
    long: str = "solo12_trot"
    long_batch: int = 8
    mpc_window: int = 20
    mpc_ticks: int = 20
    pipeline_sims: int = 4


@dataclasses.dataclass
class Phase:
    name: str
    fn: object            # jitted callable
    args: tuple
    check: object         # check(output) -> summary str; raises
    runs: int = 1


class SmokeFailure(RuntimeError):
    pass


def _require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _reference(preset, stochastic=False):
    import numpy as np

    import bench
    path = bench.ref_cache_path(preset, stochastic)
    if not os.path.exists(path):
        raise SmokeFailure(f"f64 reference cache miss: {path}")
    d = np.load(path)
    return d["X"], d["U"]


def _errors(X, U, X_ref, U_ref):
    import numpy as np
    return (float(np.max(np.abs(np.asarray(X, np.float64) - X_ref))),
            float(np.max(np.abs(np.asarray(U, np.float64) - U_ref))))


def _batch_check(label, preset, stochastic=False):
    """All scenarios succeed; unperturbed scenario 0 within the parity
    bar of the f64 reference."""
    import numpy as np

    def check(sol):
        X_ref, U_ref = _reference(preset, stochastic)
        n_ok = int(np.sum(np.asarray(sol.success)))
        n = int(np.asarray(sol.success).size)
        x_err, u_err = _errors(sol.X[0], sol.U[0], X_ref, U_ref)
        _require(n_ok == n, f"{label}: {n_ok}/{n} scenarios succeeded")
        _require(x_err <= PARITY_TOL and u_err <= PARITY_TOL,
                 f"{label}: x_err {x_err:.3e} u_err {u_err:.3e} > "
                 f"{PARITY_TOL}")
        return (f"{n_ok}/{n} succeeded, scenario 0 x_err_inf {x_err:.3e} "
                f"u_err_inf {u_err:.3e}, mean qp iters "
                f"{float(np.mean(np.asarray(sol.qp_iterations))):.1f}")

    return check


def _bench_args(sizes: Sizes):
    import bench
    return bench.build_parser().parse_args(["--preset", sizes.headline])


def sweep_kernel_phase(sizes: Sizes) -> Phase:
    """a: the kernel and the scan sweep on the real headline factor."""
    import jax
    import jax.numpy as jnp

    import bench
    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.models.centroidal import compute_trajectory_data
    from centroidal_mpc_tpu.ops import blockqp

    args = _bench_args(sizes)
    prob = bench.build_f32_problem(args, presets.PRESETS[sizes.headline])
    inputs, _ = bench.bench_inputs(prob, sizes.headline_batch, n_variants=1)
    cfg_b, X_b, U_b = inputs[0]
    settings = prob.scp.qp
    dtype = jnp.float32

    def system(cfg, X, U):
        data = compute_trajectory_data(prob.model, prob.plan.schedule, X, U,
                                       with_covariance=False)
        qp = blockqp.build_block_qp(
            prob.model, prob.plan.schedule, cfg, X, U, data,
            jnp.asarray(prob.scp.trust_region_radius0, dtype),
            jnp.asarray(prob.scp.omega0, dtype))
        s = blockqp._ruiz(qp, settings.scaling_iters)
        rho_g = blockqp._rho_groups(settings, settings.rho, s)
        return blockqp._assemble_blocks(s, rho_g, settings.sigma)

    def both(cfg, X, U, rhs):
        diag, off = jax.vmap(system)(cfg, X, U)
        fac = jax.vmap(blockqp._block_tridiag_cholesky)(diag, off)
        solve = lambda sweeps: jax.vmap(sweeps)(fac, rhs)
        return (diag, off, solve(blockqp._kernel_sweeps),
                solve(blockqp._scan_sweeps))

    n1, v = X_b.shape[1], 22
    rhs = jax.random.normal(jax.random.PRNGKey(3),
                            (sizes.headline_batch, n1, v), dtype)

    def check(out):
        import numpy as np
        diag, off, w_k, w_s = (np.asarray(a, np.float64) for a in out)
        scale = np.abs(w_s).max()
        rel = float(np.abs(w_k - w_s).max() / scale)
        _require(rel <= KERNEL_TOL,
                 f"sweep kernel vs scan: rel err {rel:.3e} > {KERNEL_TOL}")
        # dense f64 solve of the assembled system, scenario 0
        n = diag.shape[1]
        M = np.zeros((n * v, n * v))
        for k in range(n):
            M[k * v:(k + 1) * v, k * v:(k + 1) * v] = diag[0, k]
        for k in range(n - 1):
            M[(k + 1) * v:(k + 2) * v, k * v:(k + 1) * v] = off[0, k]
            M[k * v:(k + 1) * v, (k + 1) * v:(k + 2) * v] = off[0, k].T
        w64 = np.linalg.solve(M, np.asarray(rhs[0], np.float64).ravel())
        s64 = np.abs(w64).max()
        e_k = float(np.abs(w_k[0].ravel() - w64).max() / s64)
        e_s = float(np.abs(w_s[0].ravel() - w64).max() / s64)
        _require(e_k <= max(2.0 * e_s, KERNEL_TOL),
                 f"sweep kernel vs f64 dense solve: {e_k:.3e}, scan "
                 f"{e_s:.3e}")
        return (f"kernel vs scan rel {rel:.3e}; vs f64 dense solve: "
                f"kernel {e_k:.3e}, scan {e_s:.3e} (cond(M) "
                f"{np.linalg.cond(M):.2e})")

    return Phase("a sweep_kernel", jax.jit(both),
                 (cfg_b, X_b, U_b, rhs), check)


def headline_phase(sizes: Sizes, batch=None) -> Phase:
    """b: batched_solve at the bench's headline operating point."""
    import jax

    import bench
    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.parallel.batch import batched_solve

    preset = presets.PRESETS[sizes.headline]
    prob = bench.build_f32_problem(_bench_args(sizes), preset)
    inputs, _ = bench.bench_inputs(prob, batch or sizes.headline_batch,
                                   n_variants=1)
    fn = jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))
    return Phase("b headline_batch", fn, inputs[0],
                 _batch_check("headline", preset))


def single_phase(sizes: Sizes) -> Phase:
    """c: one unbatched library solve_scp."""
    import jax

    import bench
    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.solver.scp import solve_scp

    preset = presets.PRESETS[sizes.headline]
    prob = bench.build_f32_problem(_bench_args(sizes), preset)
    fn = jax.jit(lambda c, x, u: solve_scp(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))

    def check(sol):
        X_ref, U_ref = _reference(preset)
        x_err, u_err = _errors(sol.X, sol.U, X_ref, U_ref)
        _require(bool(sol.success), "single solve failed")
        _require(x_err <= PARITY_TOL and u_err <= PARITY_TOL,
                 f"single: x_err {x_err:.3e} u_err {u_err:.3e}")
        return (f"success, x_err_inf {x_err:.3e} u_err_inf {u_err:.3e}, "
                f"qp iters {int(sol.qp_iterations)}")

    return Phase("c single_solve", fn, (prob.ocp, prob.X0, prob.U0), check)


def stochastic_phase(sizes: Sizes) -> Phase:
    """d: the chance-constrained problem, batched."""
    import jax

    import bench
    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.parallel.batch import batched_solve

    preset = presets.PRESETS[sizes.headline]
    prob = bench.build_f32_problem(_bench_args(sizes), preset, eps=5e-4,
                                   polish=True, stochastic=True)
    inputs, _ = bench.bench_inputs(prob, sizes.stoch_batch, n_variants=1)
    fn = jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))
    return Phase("d stochastic", fn, inputs[0],
                 _batch_check("stochastic", preset, stochastic=True))


def long_horizon_phase(sizes: Sizes) -> Phase:
    """e: the reference's own horizon (N=165)."""
    import jax

    import bench
    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.parallel.batch import batched_solve

    preset = presets.PRESETS[sizes.long]
    prob = bench.build_f32_problem(_bench_args(sizes), preset, eps=5e-4,
                                   polish=True)
    inputs, _ = bench.bench_inputs(prob, sizes.long_batch, n_variants=1)
    fn = jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))
    return Phase("e reference_horizon", fn, inputs[0],
                 _batch_check("reference horizon", preset))


def mpc_phase(sizes: Sizes) -> Phase:
    """f: warm-started receding-horizon ticks (bench.mpc_tick settings)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.solver.mpc import MpcController

    preset = presets.PRESETS[sizes.headline]
    prob = bench.build_f32_problem(_bench_args(sizes), preset, eps=5e-4,
                                   polish=False)
    qp_tick = dataclasses.replace(prob.scp.qp, adaptive_rho=True,
                                  adaptive_rho_mode="cond")
    settings = dataclasses.replace(prob.scp, max_iterations=1, qp=qp_tick)
    window = min(sizes.mpc_window, prob.plan.schedule.horizon - 1)
    ctl = MpcController(model=prob.model, schedule=prob.plan.schedule,
                        cfg=prob.ocp.replace(terminal_equality=False),
                        settings=settings, window=window)
    state0 = ctl.init_state(prob.X0, prob.U0)
    x0 = jnp.asarray(prob.X0[0], jnp.float32)

    def check(out):
        _, sols = out
        for t, sol in enumerate(sols):
            _require(bool(sol.success), f"mpc tick {t} did not succeed")
            _require(bool(np.all(np.isfinite(np.asarray(sol.X))))
                     and bool(np.all(np.isfinite(np.asarray(sol.U)))),
                     f"mpc tick {t}: non-finite plan")
        return f"{len(sols)} ticks succeeded with finite plans"

    return Phase("f mpc", jax.jit(ctl.step), (state0, x0), check,
                 runs=sizes.mpc_ticks)


def pipeline_phase(sizes: Sizes) -> str:
    """g: the end-to-end pipeline (runs eagerly; compiles as it goes)."""
    import numpy as np

    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.pipeline import run_pipeline
    from centroidal_mpc_tpu.utils.artifacts import ArtifactStore

    with tempfile.TemporaryDirectory() as out:
        res = run_pipeline(presets.PRESETS[sizes.headline],
                           store=ArtifactStore(out),
                           n_sims=sizes.pipeline_sims)
    _require(bool(res.nominal.success), "pipeline: nominal SCP failed")
    _require(res.stochastic is not None and bool(res.stochastic.success),
             "pipeline: stochastic SCP failed")
    _require(res.wb_traj is not None, "pipeline: no whole-body tracking")
    _require(res.mc_nominal is not None and res.mc_stochastic is not None,
             "pipeline: Monte-Carlo did not run")
    for k, v in res.eval_stats.items():
        _require(bool(np.all(np.isfinite(v))), f"pipeline: {k} not finite")
    return (f"nominal and stochastic succeeded; Monte-Carlo stats "
            f"{sorted(res.eval_stats)} finite")


def _run(phase: Phase, compiled):
    """Execute a compiled phase (MPC threads its state through ticks)."""
    import jax
    if phase.runs == 1:
        out = compiled(*phase.args)
        jax.block_until_ready(out)
        return out
    state, x = phase.args
    sols = []
    for _ in range(phase.runs):
        state, sol = compiled(state, x)
        jax.block_until_ready(sol)
        sols.append(sol)
        x = sol.X[1]   # perfect tracking: next tick measures knot 1
    return state, sols


def _compile(phase: Phase):
    t0 = time.perf_counter()
    compiled = phase.fn.lower(*phase.args).compile()
    return compiled, time.perf_counter() - t0


def _header():
    import jax

    from centroidal_mpc_tpu.utils.profiling import gpu_name_and_power_limit
    dev = jax.devices()[0]
    print(f"card (nvidia-smi name, power.limit): {gpu_name_and_power_limit()}")
    print(f"jax {jax.__version__}; device_kind {dev.device_kind}; "
          f"device count {len(jax.devices())}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


def _compile_all(phases, side_work=None):
    """Compile the phases in threads while `side_work` runs here; yields
    (phase, compiled, compile seconds) in order."""
    with concurrent.futures.ThreadPoolExecutor(len(phases)) as pool:
        futures = [pool.submit(_compile, p) for p in phases]
        if side_work is not None:
            side_work()
        for p, f in zip(phases, futures):
            compiled, secs = f.result()
            yield p, compiled, secs


def one_card(sizes: Sizes) -> None:
    t0 = time.perf_counter()
    phases = [sweep_kernel_phase(sizes), headline_phase(sizes),
              single_phase(sizes), stochastic_phase(sizes),
              long_horizon_phase(sizes), mpc_phase(sizes)]
    print(f"lowered {len(phases)} phase programs in "
          f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)

    def pipeline():
        t = time.perf_counter()
        summary = pipeline_phase(sizes)
        print(f"[g pipeline] smoke wall time (compile included) "
              f"{time.perf_counter() - t:.1f} s: {summary}", flush=True)

    for phase, compiled, secs in _compile_all(phases, pipeline):
        if phase.name.startswith("b"):
            print(f"[{phase.name}] memory_analysis: "
                  f"{compiled.memory_analysis()}")
        t = time.perf_counter()
        out = _run(phase, compiled)
        wall = time.perf_counter() - t
        summary = phase.check(out)
        print(f"[{phase.name}] set-up (compile) {secs:.1f} s; smoke wall "
              f"time {wall:.2f} s: {summary}", flush=True)


def four_cards(sizes: Sizes) -> None:
    """The scenario batch sharded over a 4-card mesh against the same
    batch solved unsharded on one card: every scenario succeeds, X and
    U agree within SHARD_BAND, the output shards sit on 4 cards and
    each card used memory.  Scenarios that deviate are printed with
    their ADMM counts and the polish acceptance of their last QP."""
    import jax
    import numpy as np

    import bench
    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.parallel.batch import (batched_solve,
                                                   make_sharded_solver,
                                                   scenario_mesh)

    _require(len(jax.devices()) >= 4,
             f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    preset = presets.PRESETS[sizes.headline]
    prob = bench.build_f32_problem(_bench_args(sizes), preset)
    inputs, _ = bench.bench_inputs(prob, sizes.headline_batch, n_variants=1)
    n = sizes.headline_batch
    sharded = make_sharded_solver(scenario_mesh(4), prob.model,
                                  prob.plan.schedule, prob.scp)
    one_card = jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))
    phases = [Phase("sharded", sharded, inputs[0], None),
              Phase("one card", one_card, inputs[0], None)]
    outs = {}
    for phase, compiled, secs in _compile_all(phases):
        t = time.perf_counter()
        outs[phase.name] = _run(phase, compiled)
        print(f"[{phase.name}] set-up (compile) {secs:.1f} s; smoke wall "
              f"time {time.perf_counter() - t:.2f} s", flush=True)
    sol, stats = outs["sharded"]
    ref = outs["one card"]
    Xs, Us = np.asarray(sol.X), np.asarray(sol.U)
    X_ref, U_ref = _reference(preset)
    x0_err, u0_err = _errors(Xs[0], Us[0], X_ref, U_ref)
    x_dev, u_dev = _errors(Xs, Us, np.asarray(ref.X, np.float64),
                           np.asarray(ref.U, np.float64))
    n_ok = int(np.asarray(stats["n_success"]))
    n_ok_ref = int(np.sum(np.asarray(ref.success)))
    shard_devs = sorted({s.device.id for s in sol.X.addressable_shards})
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in jax.devices()[:4]]
    dev_s = np.maximum(
        np.max(np.abs(Xs - np.asarray(ref.X)), axis=(1, 2)),
        np.max(np.abs(Us - np.asarray(ref.U)), axis=(1, 2)))
    far = np.nonzero(dev_s >= SHARD_BAND)[0].tolist()[:16]
    show = lambda o, f: np.asarray(getattr(o, f))[far].tolist()
    print(f"[four cards] sharded {n_ok}/{n} succeeded, one card "
          f"{n_ok_ref}/{n}; scenario 0 vs f64 x {x0_err:.3e} u "
          f"{u0_err:.3e}; sharded vs one card x {x_dev:.3e} u {u_dev:.3e}; "
          f"bitwise equal in {int(np.sum(dev_s == 0))}/{n} scenarios; at "
          f"or above {SHARD_BAND}: {far}, ADMM iterations "
          f"{show(sol, 'qp_iterations')} vs {show(ref, 'qp_iterations')}, "
          f"polished {show(sol, 'qp_polished')} vs "
          f"{show(ref, 'qp_polished')}; shards on devices {shard_devs}; "
          f"peak bytes {peaks}", flush=True)
    _require(n_ok == n, f"sharded: {n_ok}/{n} scenarios succeeded")
    _require(n_ok_ref == n, f"one card: {n_ok_ref}/{n} succeeded")
    _require(x0_err <= PARITY_TOL and u0_err <= PARITY_TOL,
             f"sharded scenario 0 vs f64: x {x0_err:.3e} u {u0_err:.3e}")
    _require(len(shard_devs) == 4,
             f"output shards on {len(shard_devs)} devices, not 4")
    _require(x_dev < SHARD_BAND and u_dev < SHARD_BAND,
             f"sharded vs one card: x {x_dev:.3e} u {u_dev:.3e} "
             f"(band {SHARD_BAND})")
    _require(all(p > 0 for p in peaks), f"peak bytes in use {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded solve on 4 cards and its "
                         "unsharded comparison")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1

    from centroidal_mpc_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}")
    _header()
    try:
        if args.four_cards:
            four_cards(Sizes())
        else:
            one_card(Sizes())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
