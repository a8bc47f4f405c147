"""Sweep kernel vs XLA scan sweep, on one GPU, in one process.

    python benchmarks/sweep_ab.py [--rounds 4] [--out FILE.json]

Two comparisons, each alternating the two versions (scan, kernel,
kernel, scan, ...) so that drift in clocks or power hits both alike:

  * the backsolve alone: 100 chained backsolves of one batch-128 factor
    at the headline shape (51 knots, V=22), inside one jitted loop;
  * end to end: `batched_solve` at solo12_trot_n50 batch 128 (the
    headline), batch 1, and solo12_trot (N=165) batch 32, with the
    bench's headline settings; the scan version is traced under
    `bench.xla_scan_sweeps()`, the kernel version as the library runs
    on a GPU.

Prints one line per measurement and writes every run to --out as JSON,
beside the card's name and power limit.  For the solves it also records,
per version, each scenario's ADMM and SCP iteration counts and the
status, stall exit and polish acceptance of its last QP, and the batch
time divided by the largest ADMM count (under vmap a batch runs as long
as its slowest scenario).
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from centroidal_mpc_tpu.config import presets  # noqa: E402
from centroidal_mpc_tpu.ops import blockqp  # noqa: E402
from centroidal_mpc_tpu.parallel.batch import batched_solve  # noqa: E402
from centroidal_mpc_tpu.utils import compile_cache, profiling  # noqa: E402

SWEEPS = ("scan", "kernel")
TRACE = {"scan": bench.xla_scan_sweeps, "kernel": contextlib.nullcontext}
CELLS = [("solo12_trot_n50", 128), ("solo12_trot_n50", 1),
         ("solo12_trot", 32)]
CHAIN = 100


def backsolve_programs(batch=128, n=50, v=22):
    """Jitted chains of CHAIN dependent backsolves, one per sweep."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    off = 0.2 * jax.random.normal(k1, (batch, n, v, v), jnp.float32)
    r = jax.random.normal(k2, (batch, n + 1, v, v), jnp.float32)
    diag = (jnp.einsum("bkij,bklj->bkil", r, r) / v
            + 3.0 * jnp.eye(v, dtype=jnp.float32))
    rhs = jax.random.normal(k3, (batch, n + 1, v), jnp.float32)
    fac = jax.jit(jax.vmap(blockqp._block_tridiag_cholesky))(diag, off)

    def chain(sweeps):
        def run(fac, rhs):
            one = jax.vmap(sweeps)
            return jax.lax.fori_loop(
                0, CHAIN, lambda _, w: 0.5 * one(fac, w) + rhs, rhs)
        return jax.jit(run)

    return {"scan": (chain(blockqp._scan_sweeps), (fac, rhs)),
            "kernel": (chain(blockqp._kernel_sweeps), (fac, rhs))}


def solve_programs(preset_name, batch):
    args = bench.build_parser().parse_args(["--preset", preset_name])
    prob = bench.build_f32_problem(args, presets.PRESETS[preset_name])
    inputs, _ = bench.bench_inputs(prob, batch, n_variants=1)
    return {sweep: (jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, prob.scp)), inputs[0])
        for sweep in SWEEPS}


def solve_counts(out):
    """Per-scenario counts of one batched solve."""
    status = collections.Counter(
        int(v) for v in np.asarray(out.qp_status).ravel())
    qp = np.asarray(out.qp_iterations).ravel()
    return {"qp_iters": qp.tolist(),
            "scp_iters": np.asarray(out.iterations).ravel().tolist(),
            "status_counts": {str(k): v for k, v in sorted(status.items())},
            "n_stalled": int(np.sum(np.asarray(out.qp_stalled))),
            "n_polished": int(np.sum(np.asarray(out.qp_polished))),
            "n_success": int(np.sum(np.asarray(out.success)))}


def timed(compiled, args, reps):
    out = compiled(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = compiled(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4,
                    help="alternating pairs per comparison")
    ap.add_argument("--out", default="chiprun_out/sweep_ab.json")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"sweep_ab.py times the GPU; found {dev.platform}")
    compile_cache.enable_compile_cache()
    card = profiling.gpu_name_and_power_limit()
    print(f"card: {card}; device_kind {dev.device_kind}", flush=True)

    programs = {("backsolve", 128): backsolve_programs()}
    for preset_name, batch in CELLS:
        programs[(preset_name, batch)] = solve_programs(preset_name, batch)
    # lowered here, one at a time (the scan trace patches a module);
    # compiled side by side
    lowered = {}
    for cell, progs in programs.items():
        for sweep, (fn, a) in progs.items():
            with TRACE[sweep]():
                lowered[(cell, sweep)] = fn.lower(*a)
    t0 = time.perf_counter()
    compiled = {}
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        futs = {key: pool.submit(lambda lo=lo: (
            time.perf_counter(), lo.compile(), time.perf_counter()))
            for key, lo in lowered.items()}
        for key, fut in futs.items():
            start, c, end = fut.result()
            compiled[key] = c
            print(f"compiled {key} in {end - start:.1f} s (set-up)",
                  flush=True)
    print(f"all compiles done after {time.perf_counter() - t0:.1f} s",
          flush=True)

    record = {"card": card, "device_kind": dev.device_kind,
              "chain": CHAIN, "cells": {}}
    for cell, progs in programs.items():
        reps = 20 if cell[0] == "backsolve" else 3
        runs = {s: [] for s in SWEEPS}
        counts = {}
        for r in range(args.rounds):
            order = SWEEPS if r % 2 == 0 else SWEEPS[::-1]
            for sweep in order:
                t, out = timed(compiled[(cell, sweep)], progs[sweep][1],
                               reps)
                runs[sweep].append(t)
                if cell[0] != "backsolve":
                    counts[sweep] = solve_counts(out)
        per = CHAIN if cell[0] == "backsolve" else 1
        summary = {s: {"runs_ms": [t * 1e3 / per for t in runs[s]],
                       "median_ms": float(np.median(runs[s]) * 1e3 / per)}
                   for s in SWEEPS}
        for s, c in counts.items():
            summary[s].update(c)
            summary[s]["ms_per_admm_iter_of_slowest"] = (
                summary[s]["median_ms"] / max(c["qp_iters"]))
        key = f"{cell[0]}_b{cell[1]}"
        record["cells"][key] = summary
        print(f"{key}: " + "; ".join(
            f"{s} median {summary[s]['median_ms']:.4f} ms runs "
            f"{[round(x, 4) for x in summary[s]['runs_ms']]}"
            for s in SWEEPS), flush=True)
        for s, c in counts.items():
            qp = np.asarray(c["qp_iters"])
            print(f"  {s}: ADMM iters mean {qp.mean():.2f} min {qp.min()} "
                  f"max {qp.max()}; SCP iters "
                  f"{dict(collections.Counter(c['scp_iters']))}; status "
                  f"{c['status_counts']}; stalled {c['n_stalled']}; "
                  f"polished {c['n_polished']}; success {c['n_success']}; "
                  f"ms per ADMM iter of the slowest "
                  f"{summary[s]['ms_per_admm_iter_of_slowest']:.4f}",
                  flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
