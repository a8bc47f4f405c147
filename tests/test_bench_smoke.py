"""CPU smoke test for every bench.py configuration and the chip smoke.

bench.run() and chip_smoke.py are what runs on the GPU; this test drives
the EXACT code paths at tiny scale on the CPU:

  * trace-only sweep: every bench configuration (factor in {cholesky,
    thomas}, sweep in {scan, assoc}, polish on/off, rho
    fixed/'always', stochastic, batch 32 and batch 1, the latency probe
    shape, and the full accuracy_tiers table) is jit-LOWERED --
    trace-time regressions raise without paying XLA compile time.
    Lowered for the CPU, the solver keeps its XLA scan sweeps.
  * the same for each jitted phase program of chip_smoke.py; both
    scripts refuse a timed run without a GPU.
"""
import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from centroidal_mpc_tpu.config import gaits, presets
from centroidal_mpc_tpu.ops import blockqp, sweep_kernel
from centroidal_mpc_tpu.ops.admm import QPSettings
from centroidal_mpc_tpu.solver.scp import solve_scp

TINY_NAME = "smoke_tiny_trot"
BATCH = 32


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    """Register an N=9 trot preset so bench.run() sees it by name.

    step-in-place: a 0.12 m step in 9 knots (0.09 s) is dynamically
    infeasible and the QP never converges; step_length=0 converges the
    f64 eps=1e-7 reference QP in ~75 ADMM iterations.
    """
    gait = dataclasses.replace(gaits.SOLO12_TROT, step_length=0.0,
                               step_knots=3, support_knots=1, nb_steps=1)
    preset = dataclasses.replace(presets.SOLO12_TROT, name=TINY_NAME,
                                 gait=gait)
    assert preset.horizon == 9
    presets.PRESETS[TINY_NAME] = preset
    yield preset
    del presets.PRESETS[TINY_NAME]


def run_bench(extra):
    args = bench.build_parser().parse_args(
        ["--preset", TINY_NAME, "--chain", "2", "--trials", "1",
         "--qp-max-iter", "150", "--eps", "1e-3"] + extra)
    record = bench.run(args)
    record.pop("_stderr")
    json.dumps(record)  # the driver contract: one JSON-serializable line
    return record


SKIP_EXTRAS = ["--no-stochastic", "--no-mpc", "--no-n165",
               "--no-presets",
               "--latency-probes", "0", "--chip-latency-problems", "0"]

TRACE_COMBOS = [
    # the full default record: the accuracy-tier table, the
    # latency-probe shape, the stochastic record and the MPC tick chain
    # (N=165 is never traced -- n165_record is skipped under
    # --trace-only); the preset coverage matrix traces via
    # --preset-matrix pointed at the tiny preset (the real 4-preset
    # matrix is full-horizon -- too heavy for smoke; its solve path is
    # identical, and the wrench6 family is covered by
    # tests/test_full_horizons.py)
    ["--factor", "cholesky", "--polish", "--batch", str(BATCH),
     "--latency-probes", "2", "--no-n165",
     "--preset-matrix", TINY_NAME],
    ["--factor", "cholesky", "--rho", "always",
     "--batch", str(BATCH), "--no-accuracy", "--no-parity"]
    + SKIP_EXTRAS,
    ["--sweep", "scan", "--no-polish",
     "--batch", str(BATCH), "--no-accuracy", "--no-parity"]
    + SKIP_EXTRAS,
    ["--factor", "cholesky", "--polish", "--batch", "1", "--no-accuracy"]
    + SKIP_EXTRAS,
    ["--factor", "thomas", "--sweep", "assoc", "--batch", "2",
     "--no-accuracy"] + SKIP_EXTRAS,
]


@pytest.mark.parametrize("combo", TRACE_COMBOS,
                         ids=lambda c: "_".join(
                             a.lstrip("-") for a in c if a.startswith("--")))
def test_trace_every_bench_configuration(combo):
    rec = run_bench(["--trace-only"] + combo)
    assert rec["device"]["platform"] == "cpu"
    sweep = combo[combo.index("--sweep") + 1] if "--sweep" in combo else "scan"
    assert rec["settings"]["sweep"] == sweep
    assert rec["trace_only"] is True
    if "accuracy_tiers" in rec:
        assert len(rec["accuracy_tiers"]) == 4


def test_timed_bench_refuses_cpu():
    """A timed run measures the GPU only; on the CPU it exits."""
    with pytest.raises(SystemExit, match="GPU"):
        run_bench(["--no-accuracy", "--no-parity"] + SKIP_EXTRAS)


SMOKE_PHASES = ["sweep_kernel_phase", "headline_phase", "single_phase",
                "stochastic_phase", "long_horizon_phase", "mpc_phase"]


@pytest.mark.parametrize("phase", SMOKE_PHASES)
def test_chip_smoke_phase_lowers(phase, monkeypatch):
    """Each jitted program of chip_smoke.py lowers at the tiny preset
    (phase a's direct kernel call through the interpreter)."""
    monkeypatch.setattr(blockqp, "block_tridiag_sweep", functools.partial(
        sweep_kernel.block_tridiag_sweep, interpret=True))
    sizes = chip_smoke.Sizes(headline=TINY_NAME, headline_batch=2,
                             stoch_batch=2, long=TINY_NAME, long_batch=2,
                             mpc_window=4, mpc_ticks=2)
    p = getattr(chip_smoke, phase)(sizes)
    p.fn.lower(*p.args)


def test_chip_smoke_exits_nonzero_without_gpu(capsys):
    """No accelerator: non-zero exit and no result line."""
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def _f64_reference(preset, stochastic=False):
    """bench.f64_reference's operating point, solved here (the tiny
    preset has no committed cache)."""
    qp64 = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000,
                      adaptive_rho=True, polish=True)
    p = presets.build_problem(preset, stochastic=stochastic,
                              dtype=jnp.float64, qp=qp64)
    scp = dataclasses.replace(p.scp, qp_backend="block")
    sol = solve_scp(p.model, p.plan.schedule, p.ocp, p.X0, p.U0, scp)
    return np.asarray(sol.X), np.asarray(sol.U)


def test_four_cards_on_virtual_devices(monkeypatch):
    """The --four-cards path on four virtual CPU devices at the tiny
    preset: the sharded and unsharded solves run and pass every check
    up to the last, the per-card memory one (CPU devices keep no
    memory statistics)."""
    monkeypatch.setattr(chip_smoke, "_reference", _f64_reference)
    sizes = chip_smoke.Sizes(headline=TINY_NAME, headline_batch=8)
    with pytest.raises(chip_smoke.SmokeFailure, match="peak bytes"):
        chip_smoke.four_cards(sizes)
