"""The fused backsolve kernel (ops/sweep_kernel.py) in interpret mode.

The compiled kernel needs a GPU (`python chip_smoke.py`, phase a, and
bench.py's kernel_exact / kernel_parity compare it there).  Here the
Pallas interpreter runs the same kernel body against the XLA scan sweeps
and a dense solve, and the whole block solver takes the same iterates
with either sweep.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from centroidal_mpc_tpu.config import presets
from centroidal_mpc_tpu.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu.ops import blockqp, sweep_kernel
from centroidal_mpc_tpu.ops.admm import QPSettings

interpret_sweep = functools.partial(sweep_kernel.block_tridiag_sweep,
                                    interpret=True)


def _random_block_tridiag(key, n, v, dtype=jnp.float64):
    """Random SPD block-tridiagonal system (diag, off, rhs)."""
    k1, k2, k3 = jax.random.split(key, 3)
    off = 0.3 * jax.random.normal(k1, (n, v, v), dtype)
    r = jax.random.normal(k2, (n + 1, v, v), dtype)
    diag = jnp.einsum("kij,klj->kil", r, r) / v + 2.0 * jnp.eye(
        v, dtype=dtype)
    # diagonal dominance over the couplings keeps M SPD
    diag = diag + 2.0 * jnp.eye(v, dtype=dtype) * jnp.abs(off).sum(
        axis=(1, 2)).max()
    rhs = jax.random.normal(k3, (n + 1, v), dtype)
    return diag, off, rhs


def _kernel_solve(diag, off, rhs):
    f = blockqp._block_tridiag_cholesky(diag, off)
    return interpret_sweep(f.Cinv, f.CinvT, f.Pfwd, f.Pbwd, rhs)


@pytest.mark.parametrize("n,v", [(7, 22), (5, 9)])
def test_kernel_matches_scan(n, v):
    """Same factor, same recurrences: the kernel (V widened to 32 and 16
    by masked loads) reproduces the scan sweeps to rounding."""
    diag, off, rhs = _random_block_tridiag(jax.random.PRNGKey(0), n, v)
    fac = blockqp._block_tridiag_cholesky(diag, off)
    ref = blockqp._scan_sweeps(fac, rhs)
    out = _kernel_solve(diag, off, rhs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-10, atol=1e-10)


def test_kernel_is_actual_inverse():
    """M w = b, with M assembled densely from its blocks."""
    n, v = 6, 9
    diag, off, rhs = _random_block_tridiag(jax.random.PRNGKey(1), n, v)
    w = _kernel_solve(diag, off, rhs)
    M = np.zeros(((n + 1) * v, (n + 1) * v))
    for k in range(n + 1):
        M[k * v:(k + 1) * v, k * v:(k + 1) * v] = diag[k]
    for k in range(n):
        M[(k + 1) * v:(k + 2) * v, k * v:(k + 1) * v] = off[k]
        M[k * v:(k + 1) * v, (k + 1) * v:(k + 2) * v] = off[k].T
    np.testing.assert_allclose(M @ np.asarray(w).ravel(),
                               np.asarray(rhs).ravel(), rtol=1e-8,
                               atol=1e-8)


def test_kernel_odd_batch_under_vmap():
    """vmap's pallas_call batching adds the scenario grid axis; an odd
    batch of three gives each scenario its own solve."""
    systems = [_random_block_tridiag(jax.random.PRNGKey(i), 4, 22)
               for i in range(3)]
    diag, off, rhs = (jnp.stack(x) for x in zip(*systems))
    out = jax.jit(jax.vmap(_kernel_solve))(diag, off, rhs)
    assert out.shape == rhs.shape
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(out[i]), np.asarray(_kernel_solve(*systems[i])),
            rtol=1e-12, atol=1e-12)


def test_compiled_kernel_refuses_cpu():
    """No silent interpreter fallback: without interpret=True the kernel
    only compiles for a GPU."""
    diag, off, rhs = _random_block_tridiag(jax.random.PRNGKey(2), 3, 9)
    f = blockqp._block_tridiag_cholesky(diag, off)
    with pytest.raises(ValueError, match="interpret"):
        sweep_kernel.block_tridiag_sweep(f.Cinv, f.CinvT, f.Pfwd, f.Pbwd,
                                         rhs)


def _trot_qp(dtype=jnp.float64):
    preset = dataclasses.replace(
        presets.SOLO12_TROT_N50,
        gait=dataclasses.replace(presets.SOLO12_TROT_N50.gait,
                                 step_knots=4, support_knots=2, nb_steps=1))
    return presets.build_problem(preset, dtype=dtype)


def _solve(prob, x, u, **over):
    data = compute_trajectory_data(prob.model, prob.plan.schedule, x, u,
                                   with_covariance=False)
    qp = blockqp.build_block_qp(
        prob.model, prob.plan.schedule, prob.ocp, x, u, data,
        jnp.asarray(100.0, jnp.float64), jnp.asarray(100.0, jnp.float64))
    st = QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=300, **over)
    w0 = blockqp.WVars(x=x, u=u, t=jnp.zeros(x.shape[0], x.dtype))
    return blockqp.solve_block_qp(qp, st, w0=w0)


def _interpreted_kernel_sweeps(f, b):
    return interpret_sweep(f.Cinv, f.CinvT, f.Pfwd, f.Pbwd, b)


@pytest.mark.parametrize("batched", [False, True])
def test_solve_block_qp_kernel_matches_scan(batched, monkeypatch):
    """The whole ADMM solve (with polish) walks the same iterate
    sequence with the kernel's sweeps as with the XLA scans: equal
    iteration counts and matching X/U, unbatched and under vmap."""
    prob = _trot_qp()
    if batched:
        B = 2
        X0 = jnp.broadcast_to(prob.X0, (B,) + prob.X0.shape)
        X0 = X0.at[:, 0, 0].add(1e-3 * jnp.arange(B))
        U0 = jnp.broadcast_to(prob.U0, (B,) + prob.U0.shape)
        over = dict(adaptive_rho=True, adaptive_rho_mode="always")
        solve = lambda: jax.vmap(
            lambda x, u: _solve(prob, x, u, **over))(X0, U0)
    else:
        solve = lambda: _solve(prob, prob.X0, prob.U0, adaptive_rho=False,
                               polish=True)
    sol_s = solve()
    monkeypatch.setattr(blockqp, "_sequential_sweeps",
                        _interpreted_kernel_sweeps)
    sol_k = solve()
    np.testing.assert_array_equal(np.asarray(sol_k.iterations),
                                  np.asarray(sol_s.iterations))
    np.testing.assert_allclose(np.asarray(sol_k.X), np.asarray(sol_s.X),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sol_k.U), np.asarray(sol_s.U),
                               rtol=1e-6, atol=1e-6)


def _lowered_text(platform):
    """solve_block_qp at the tiny trot, vmapped over two scenarios and
    lowered for `platform`."""
    prob = _trot_qp(jnp.float32)
    X0 = jnp.broadcast_to(prob.X0, (2,) + prob.X0.shape)
    U0 = jnp.broadcast_to(prob.U0, (2,) + prob.U0.shape)

    def solve(x, u):
        data = compute_trajectory_data(prob.model, prob.plan.schedule, x, u,
                                       with_covariance=False)
        qp = blockqp.build_block_qp(
            prob.model, prob.plan.schedule, prob.ocp, x, u, data,
            jnp.asarray(100.0, jnp.float32), jnp.asarray(100.0, jnp.float32))
        return blockqp.solve_block_qp(qp, QPSettings(max_iter=20, polish=True))

    traced = jax.jit(jax.vmap(solve)).trace(X0, U0)
    return traced.lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,has_kernel", [("cuda", True),
                                                 ("cpu", False)])
def test_platform_chooses_sweeps(platform, has_kernel):
    """The solver, not its caller, picks the sweeps: lowered for a GPU
    the f32 block solver calls the fused kernel, lowered for the CPU it
    keeps the XLA scans and no kernel."""
    text = _lowered_text(platform)
    assert ("block_tridiag_sweep" in text) == has_kernel
