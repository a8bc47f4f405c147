"""The block-tridiagonal backsolve as one Pallas kernel (Triton route).

Every ADMM iteration of the block solver solves M w = b with the
pre-inverted blocked-Cholesky factor (ops/blockqp._TridiagFactor): a
forward recurrence v_k = C_k^{-1} b_k - Pfwd_{k-1} v_{k-1}, the
knot-parallel d_k = C_k^{-T} v_k, and a backward recurrence
w_k = d_k - Pbwd_k w_{k+1}.  Under XLA these are two `lax.scan`s of
N dependent V x V matvecs each, every step a few small kernel launches.
Here one launch does the whole backsolve for one scenario: the knot loop
runs inside the program with the carry in registers, and vmap's
`pallas_call` batching rule adds the scenario axis as the grid.

Layout: the factor keeps its (knot, V, V) shape; V (22 for the quadruped
and humanoid presets) is widened to the next power of two by masked
loads, so no padded copy of the factor is ever made.  The next step's
operands are loaded one step ahead, which takes the load latency off the
recurrence.  Matvecs are elementwise multiply plus a row sum, exact f32
with no tensor-core (TF32) products.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# 4 warps hold the prefetched 32 x 32 operands at ~48 registers a thread
NUM_WARPS = 4


def _sweep_kernel(cinv_ref, cinvt_ref, pfwd_ref, pbwd_ref, b_ref,
                  w_ref, d_ref, *, n: int, v: int, vp: int,
                  interpret: bool):
    idx = jnp.arange(vp)
    vmask = idx < v
    mmask = vmask[:, None] & vmask[None, :]

    def mat(ref, k):
        return plgpu.load(ref.at[k, pl.ds(0, vp), pl.ds(0, vp)],
                          mask=mmask, other=0.0)

    def vec(ref, k):
        return plgpu.load(ref.at[k, pl.ds(0, vp)], mask=vmask, other=0.0)

    def put(ref, k, x):
        plgpu.store(ref.at[k, pl.ds(0, vp)], x, mask=vmask)

    def matvec(m, x):
        return jnp.sum(m * x[None, :], axis=1)

    # forward sweep; d_k = C_k^{-T} v_k is stored as it is produced
    def fwd_operands(k):
        return (mat(cinv_ref, k), mat(pfwd_ref, k - 1), mat(cinvt_ref, k),
                vec(b_ref, k))

    v0 = matvec(mat(cinv_ref, 0), vec(b_ref, 0))
    put(d_ref, 0, matvec(mat(cinvt_ref, 0), v0))

    def fwd(k, carry):
        v_prev, (cinv_k, pf_k, cinvt_k, b_k) = carry
        nxt = fwd_operands(jnp.minimum(k + 1, n))
        v_k = matvec(cinv_k, b_k) - matvec(pf_k, v_prev)
        put(d_ref, k, matvec(cinvt_k, v_k))
        return v_k, nxt

    if n > 0:
        jax.lax.fori_loop(1, n + 1, fwd, (v0, fwd_operands(1)))
    if not interpret:
        # d was written by other threads of this program
        plgpu.debug_barrier()

    # backward sweep, knots N-1 .. 0
    w_last = vec(d_ref, n)
    put(w_ref, n, w_last)

    def bwd_operands(k):
        return mat(pbwd_ref, k), vec(d_ref, k)

    def bwd(i, carry):
        w_next, (pb_k, d_k) = carry
        k = n - 1 - i
        nxt = bwd_operands(jnp.maximum(k - 1, 0))
        w_k = d_k - matvec(pb_k, w_next)
        put(w_ref, k, w_k)
        return w_k, nxt

    if n > 0:
        jax.lax.fori_loop(0, n, bwd, (w_last, bwd_operands(n - 1)))


@functools.partial(jax.jit, static_argnames=("interpret",))
def block_tridiag_sweep(cinv, cinvt, pfwd, pbwd, b, interpret: bool = False):
    """Solve M w = b from the pre-inverted factor; b, w shaped (N+1, V).

    cinv, cinvt: (N+1, V, V); pfwd, pbwd: (N, V, V).  Compiled for the
    GPU by the Triton route; `interpret=True` runs the Pallas interpreter
    instead (tests on a host without a GPU).  Any other backend refuses
    the compiled kernel.  Batch axes come from vmap.
    """
    n = pfwd.shape[0]
    v = b.shape[-1]
    vp = 1 << (v - 1).bit_length()
    kernel = functools.partial(_sweep_kernel, n=n, v=v, vp=vp,
                               interpret=interpret)
    out = jax.ShapeDtypeStruct(b.shape, b.dtype)
    w, _ = pl.pallas_call(
        kernel,
        out_shape=(out, out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="block_tridiag_sweep",
    )(cinv, cinvt, pfwd, pbwd, b)
    return w
