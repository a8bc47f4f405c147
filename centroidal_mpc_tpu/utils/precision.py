"""Full-precision matrix products for the solver entry points.

On a GPU, XLA's default precision runs float32 matrix products in TF32
(about three decimal digits).  The ADMM residuals, the two-float dual of
the polish (ops/blockqp._two_sum) and the Newton-Schulz inverses
(ops/linalg.py) need true float32 products to reach the 1e-4 parity bar,
so every traced entry point of the solver opens a `highest` scope and
callers need set no global flag.
"""
from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Trace `fn` with every matrix product at `Precision.HIGHEST`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
