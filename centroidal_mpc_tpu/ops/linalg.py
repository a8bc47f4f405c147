"""Matmul-only linear-algebra primitives.

The 12x12 SPD solves inside the LQR gain recursion are batched over
scenarios x knots; these helpers keep them in plain batched matrix
products (no per-matrix factorization), at full f32 precision.
"""
from __future__ import annotations

import jax.numpy as jnp

from centroidal_mpc_tpu.utils.precision import highest_precision


@highest_precision
def spd_inverse(H: jnp.ndarray, iters: int = 16) -> jnp.ndarray:
    """Inverse of a symmetric positive-definite matrix via Jacobi-scaled
    Newton-Schulz iteration: X <- X (2I - H X), quadratically convergent.

    Jacobi preconditioning (D^{-1/2} H D^{-1/2}) brings the spectrum near
    1 so ~10-16 iterations reach f32/f64 accuracy for the mildly
    conditioned SPD systems in this codebase (R + B'PB with diagonal-
    dominant R).  Batched over leading dims; matmul-only.
    """
    d = jnp.diagonal(H, axis1=-2, axis2=-1)
    d_isqrt = 1.0 / jnp.sqrt(d)
    Ht = H * d_isqrt[..., :, None] * d_isqrt[..., None, :]
    n = H.shape[-1]
    eye = jnp.eye(n, dtype=H.dtype)
    # row-sum bound on lambda_max guarantees ||I - X0 Ht|| < 1
    lam = jnp.abs(Ht).sum(-1).max(-1)
    X = eye / lam[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - Ht @ X)
    return X * d_isqrt[..., :, None] * d_isqrt[..., None, :]


def spd_solve(H: jnp.ndarray, B: jnp.ndarray, iters: int = 16) -> jnp.ndarray:
    """Solve H X = B for SPD H via `spd_inverse` (matmul-only)."""
    return spd_inverse(H, iters) @ B
