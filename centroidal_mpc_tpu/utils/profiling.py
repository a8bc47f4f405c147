"""Profiling and timing instrumentation.

The reference has no profiling at all (SURVEY.md section 5: an unused
`time` import and print statements).  Here: wall-clock stage timers with
device synchronization, solves/s accounting, a jax.profiler trace
context for device timeline capture, and the card identity every
measurement is reported with.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Dict, List, Optional

import jax


class StageTimer:
    """Accumulating per-stage wall-clock timer (device-synchronized)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass `sync=arrays` to block on device results."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:30s} {total*1e3:10.2f} ms total "
                         f"({n}x, {total/n*1e3:.2f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, read
    in a child process that stays off JAX (a card capped below its
    maximum power runs slower under load, so every number is reported
    beside this line)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.strip().splitlines()
    return lines[0] if lines else "nvidia-smi: no card"


def measure_solves_per_second(solve_fn, args_fn, batch: int,
                              repeats: int = 5) -> Dict[str, float]:
    """Steady-state throughput: best-of-`repeats` timed calls, each with
    fresh inputs from args_fn(i) so results cannot be cached."""
    out = solve_fn(*args_fn(0))
    jax.block_until_ready(out)
    times: List[float] = []
    for i in range(repeats):
        args = args_fn(i + 1)
        t0 = time.perf_counter()
        out = solve_fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {"best_s": best, "solves_per_s": batch / best,
            "mean_s": sum(times) / len(times)}
