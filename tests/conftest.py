"""Test configuration: force a virtual 8-device CPU mesh and float64.

The reference runs float64 on CPU; golden/parity tests therefore run on the
CPU backend with x64 enabled.  Multi-chip sharding tests use the 8 virtual
host devices (SURVEY.md section 4).  GPU behavior (f32, compiled kernels)
is covered by `python chip_smoke.py` and bench runs on the card; the GPU
kernel's arithmetic is tested here through the Pallas interpreter.

The platform is forced via jax.config (as well as JAX_PLATFORMS), so a
machine with a GPU still runs these tests on the CPU.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: the jitted SCP/ADMM programs are large;
# caching makes repeated test runs fast.  The cache dir is keyed by the
# host CPU feature set: XLA:CPU AOT artifacts are machine-specific, and
# loading entries written by a previous session on a different host
# crashes with SIGILL (observed when the environment migrated machines).
# OPT-IN ONLY (CMPC_JAX_CACHE=1), and JAX_COMPILATION_CACHE_DIR, where
# set, names the directory instead of the host-keyed default.  Round-2 full-suite runs crashed in
# put/get_executable_and_time; round 3 retried with the stdlib-zlib
# codec forced (nulling jax's zstd handles) -- warm per-file runs were
# fine (test_blockqp 131 s -> 77 s) but full-suite runs STILL segfault
# inside pxla compile (observed 2026-08-21 in test_rigid_body under
# both xdist and serial), so the fault is XLA:CPU executable
# deserialization on this platform, not the compression codec.  The
# cache therefore stays off for correctness runs.
#
# ROUND-4 REFINEMENT: the crash class is broader than the cache -- with
# the cache OFF, single-process runs of the full fast suite died twice
# (2026-08-21) with SIGSEGV/SIGABRT inside backend_compile_and_load at
# the ~60th test (test_infeasibility::test_real_problem_not_flagged_
# infeasible), while the SAME test passes in 25 s in a fresh process
# and every test file passes in per-file processes.  The fault is
# XLA:CPU compiler state in long-lived processes on this platform.
# Reliable local recipe: run per-file (for f in tests/test_*.py; do
# pytest $f; done) or accept occasional worker crashes under xdist.
if (os.environ.get("CMPC_JAX_CACHE") == "1"
        and not os.environ.get("JAX_COMPILATION_CACHE_DIR")):
    from jax._src import compilation_cache as _cc

    _cc.zstd = None
    _cc.zstandard = None  # force zlib; the zstd bindings also crashed
    import hashlib
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            _flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        _flags = ""
    _host_key = hashlib.sha1(
        (platform.machine() + _flags).encode()).hexdigest()[:12]
    import tempfile
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        tempfile.gettempdir(), f"jax_cache_centroidal_{_host_key}"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
