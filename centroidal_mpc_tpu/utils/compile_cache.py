"""JAX's persistent compilation cache for the command-line entry points.

The f32 SCP programs take minutes to compile on a GPU, so every process
that runs them keeps compiled code across runs.  Where the environment
names a cache (`JAX_COMPILATION_CACHE_DIR`), JAX reads it itself and
nothing is set here.  Otherwise the cache lives at a fixed path inside
the checkout, `<checkout>/.jax_cache` (git-ignored): the path is part of
the cache key, so it must not move between runs.
"""
from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
