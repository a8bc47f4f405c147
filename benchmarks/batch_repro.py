"""Per-scenario results of the headline batch across batch shapes, on one GPU.

    python benchmarks/batch_repro.py [--no-f64] [--out FILE.json]

Solves the headline problem (solo12_trot_n50, the bench's headline
settings, 128 perturbed scenarios from `bench.bench_inputs`) with the
library's `batched_solve` twice: as one batch of 128, and as four
batches of 32 (the shapes one card of a four-card scenario mesh sees).
Scenarios are independent, so any difference between the two is
rounding that depends on the compiled program, and whatever the solver
makes of it.

Unless --no-f64, the same 128 scenarios are also solved in f64 at the
reference operating point (eps 1e-7 with polish, as `bench.f64_reference`
solves scenario 0 for the committed cache), on the GPU; each f32
result's distance from its f64 solution says which of two disagreeing
results is right.

Prints a summary and writes every per-scenario number to --out as JSON:
deviations, errors against f64, ADMM and SCP iteration counts, and the
status, stall exit and polish acceptance of each scenario's last QP.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from centroidal_mpc_tpu.config import presets  # noqa: E402
from centroidal_mpc_tpu.ops.admm import QPSettings  # noqa: E402
from centroidal_mpc_tpu.parallel.batch import (batched_solve,  # noqa: E402
                                               tile_ocp_config)
from centroidal_mpc_tpu.utils import compile_cache, profiling  # noqa: E402

BAND = 1e-3
FIELDS = ("qp_iterations", "iterations", "qp_status", "qp_stalled",
          "qp_polished", "success")


def f32_programs(preset, batch=128, parts=4):
    """(lowered batch program, its inputs, lowered slice program, the
    slices)."""
    args = bench.build_parser().parse_args(["--preset", preset.name])
    prob = bench.build_f32_problem(args, preset)
    inputs, _ = bench.bench_inputs(prob, batch, n_variants=1)
    solve = jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))
    per = batch // parts
    slices = [jax.tree.map(lambda a, i=i: a[i * per:(i + 1) * per],
                           inputs[0]) for i in range(parts)]
    return (solve.lower(*inputs[0]), inputs[0], solve.lower(*slices[0]),
            slices)


def f64_program(preset, inputs):
    """The reference operating point of bench.f64_reference, batched
    over the f32 inputs (lowered; run it under jax.enable_x64)."""
    _, X0_32, U0_32 = inputs
    with jax.enable_x64(True):
        qp64 = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000,
                          adaptive_rho=True, polish=True)
        p64 = presets.build_problem(preset, dtype=jnp.float64, qp=qp64)
        scp = dataclasses.replace(p64.scp, qp_backend="block")
        X0 = jnp.asarray(np.asarray(X0_32), jnp.float64)
        U0 = jnp.asarray(np.asarray(U0_32), jnp.float64)
        cfg = tile_ocp_config(p64.ocp, X0[:, 0], X0[:, -1], X0)
        solve = jax.jit(lambda c, x, u: batched_solve(
            p64.model, p64.plan.schedule, c, x, u, scp))
        return solve.lower(cfg, X0, U0), (cfg, X0, U0)


def solve_all(preset, with_f64, batch=128, parts=4):
    """Compile the programs side by side, then run them."""
    lo_whole, whole_in, lo_part, slices = f32_programs(preset, batch, parts)
    lowered = [lo_whole, lo_part]
    if with_f64:
        lo64, in64 = f64_program(preset, whole_in)
        lowered.append(lo64)
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(lambda lo: lo.compile(), lowered))
    whole = jax.device_get(compiled[0](*whole_in))
    pieces = [jax.device_get(compiled[1](*a)) for a in slices]
    sliced = jax.tree.map(lambda *xs: np.concatenate(xs), *pieces)
    ref = None
    if with_f64:
        with jax.enable_x64(True):
            ref = jax.device_get(compiled[2](*in64))
    return whole, sliced, ref


def per_scenario_max(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d.reshape(d.shape[0], -1).max(axis=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-f64", action="store_true")
    ap.add_argument("--out", default="chiprun_out/batch_repro.json")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"batch_repro.py runs on a GPU; found {dev.platform}")
    compile_cache.enable_compile_cache()
    card = profiling.gpu_name_and_power_limit()
    print(f"card: {card}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
          flush=True)
    preset = presets.PRESETS["solo12_trot_n50"]
    whole, sliced, ref = solve_all(preset, not args.no_f64)
    dx = per_scenario_max(whole.X, sliced.X)
    du = per_scenario_max(whole.U, sliced.U)
    rec = {"card": card, "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "dev_x": dx.tolist(), "dev_u": du.tolist(),
           "batch128": {f: np.asarray(getattr(whole, f)).tolist()
                        for f in FIELDS},
           "batch32x4": {f: np.asarray(getattr(sliced, f)).tolist()
                         for f in FIELDS}}
    far = np.nonzero(np.maximum(dx, du) >= BAND)[0]
    same = int(np.sum((dx == 0) & (du == 0)))
    print(f"batch 128 vs 4 x 32: bitwise equal in {same}/{dx.size} "
          f"scenarios; max dev x {dx.max():.3e} u {du.max():.3e}; "
          f"scenarios at or above {BAND}: {far.tolist()}", flush=True)
    for i in far:
        print(f"  scenario {i}: dev x {dx[i]:.3e} u {du[i]:.3e}; " + "; ".join(
            f"{f} {np.asarray(getattr(whole, f))[i]} vs "
            f"{np.asarray(getattr(sliced, f))[i]}" for f in FIELDS),
            flush=True)
    for name, sol in (("batch128", whole), ("batch32x4", sliced)):
        pol = np.asarray(sol.qp_polished)
        print(f"{name}: polished {int(pol.sum())}/{pol.size}, stalled "
              f"{int(np.sum(np.asarray(sol.qp_stalled)))}, SCP iterations "
              f"{np.bincount(np.asarray(sol.iterations)).tolist()}, "
              f"success {int(np.sum(np.asarray(sol.success)))}", flush=True)

    if ref is not None:
        X_c, U_c = bench.f64_reference(
            preset, bench.build_parser().parse_args([]))
        ok64 = int(np.sum(np.asarray(ref.success)))
        print(f"f64: {ok64}/{ref.success.size} succeeded; scenario 0 vs "
              f"the committed reference: x {np.abs(ref.X[0] - X_c).max():.3e}"
              f" u {np.abs(ref.U[0] - U_c).max():.3e}", flush=True)
        rec["f64_success"] = np.asarray(ref.success).tolist()
        for name, sol in (("batch128", whole), ("batch32x4", sliced)):
            ex = per_scenario_max(sol.X, ref.X)
            eu = per_scenario_max(sol.U, ref.U)
            pol = np.asarray(sol.qp_polished)
            rec[name]["err_x_f64"] = ex.tolist()
            rec[name]["err_u_f64"] = eu.tolist()
            worst = lambda e, m: f"{e[m].max():.3e}" if m.any() else "-"
            print(f"{name} vs f64: max err x {ex.max():.3e} u "
                  f"{eu.max():.3e}; scenarios with an error at or above "
                  f"{BAND}: {np.nonzero(np.maximum(ex, eu) >= BAND)[0].tolist()}"
                  f"; worst u err polished {worst(eu, pol)}, not polished "
                  f"{worst(eu, ~pol)}", flush=True)
            for i in far:
                print(f"  scenario {i}: err x {ex[i]:.3e} u {eu[i]:.3e}",
                      flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main()
