"""Block-structured QP solver tests: equivalence with the dense path."""
import dataclasses

import jax

import jax.numpy as jnp
import numpy as np
import pytest

from centroidal_mpc_tpu.config import presets
from centroidal_mpc_tpu.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu.ops import blockqp
from centroidal_mpc_tpu.ops.admm import QPSettings, solve_qp
from centroidal_mpc_tpu.solver.ocp import build_qp, qp_dims
from centroidal_mpc_tpu.solver.scp import solve_scp


@pytest.fixture(scope="module")
def problem():
    prob = presets.build_problem(presets.SOLO12_TROT_N50, dtype=jnp.float64)
    data = compute_trajectory_data(prob.model, prob.plan.schedule,
                                   prob.X0, prob.U0)
    return prob, data


def _dense_of_block(prob, data, r, w):
    return build_qp(prob.model, prob.plan.schedule, prob.ocp, prob.X0,
                    prob.U0, data, jnp.asarray(r), jnp.asarray(w))


def test_block_operator_matches_dense_matrix(problem):
    """apply_A of the block path equals the dense A on random vectors."""
    prob, data = problem
    N, nu = prob.plan.horizon, 12
    qp_d = _dense_of_block(prob, data, 100.0, 100.0)
    qp_b = blockqp.build_block_qp(prob.model, prob.plan.schedule, prob.ocp,
                                  prob.X0, prob.U0, data,
                                  jnp.asarray(100.0), jnp.asarray(100.0))
    s = blockqp._ruiz(qp_b, 0)  # unscaled operator
    rng = np.random.default_rng(0)
    x = rng.normal(size=9 * (N + 1))
    u = rng.normal(size=nu * N)
    t = rng.normal(size=N + 1)
    z_dense = np.asarray(qp_d.A) @ np.concatenate([x, u, t, np.zeros(N)])
    w = blockqp.WVars(x=jnp.asarray(x.reshape(N + 1, 9)),
                      u=jnp.asarray(u.reshape(N, nu)), t=jnp.asarray(t))
    z = blockqp._apply_A(s, w)
    n, segs = qp_dims(prob.model, N)
    off, acc = {}, 0
    for k, v in segs.items():
        off[k] = acc
        acc += v
    np.testing.assert_allclose(np.asarray(z.init), z_dense[off["initial"]:off["initial"] + 9], atol=1e-10)
    np.testing.assert_allclose(np.asarray(z.dyn).reshape(-1),
                               z_dense[off["dynamics"]:off["dynamics"] + 9 * N], atol=1e-10)
    np.testing.assert_allclose(np.asarray(z.final), z_dense[off["final"]:off["final"] + 9], atol=1e-10)
    # dense friction rows are contact-major; block is (N, C, 5)
    fric_dense = z_dense[off["friction"]:off["friction"] + 4 * 5 * N]
    fric_block = np.asarray(z.fric).transpose(1, 0, 2).reshape(-1)
    np.testing.assert_allclose(fric_block, fric_dense, atol=1e-10)
    np.testing.assert_allclose(np.asarray(z.trust).reshape(-1),
                               z_dense[off["trust"]:off["trust"] + 8 * (N + 1)], atol=1e-10)
    np.testing.assert_allclose(np.asarray(z.slack),
                               z_dense[off["slack"]:off["slack"] + N + 1], atol=1e-10)


def test_apply_AT_is_adjoint(problem):
    prob, data = problem
    qp_b = blockqp.build_block_qp(prob.model, prob.plan.schedule, prob.ocp,
                                  prob.X0, prob.U0, data,
                                  jnp.asarray(100.0), jnp.asarray(100.0))
    s = blockqp._ruiz(qp_b, 3)
    N = prob.plan.horizon
    rng = np.random.default_rng(1)
    w = blockqp.WVars(x=jnp.asarray(rng.normal(size=(N + 1, 9))),
                      u=jnp.asarray(rng.normal(size=(N, 12))),
                      t=jnp.asarray(rng.normal(size=N + 1)))
    z = blockqp.ZGroups(*(jnp.asarray(rng.normal(size=np.asarray(a).shape))
                          for a in blockqp._apply_A(s, w)))
    lhs = sum(float(jnp.vdot(a, b)) for a, b in zip(blockqp._apply_A(s, w), z))
    rhs = sum(float(jnp.vdot(a, b)) for a, b in zip(w, blockqp._apply_AT(s, z)))
    assert abs(lhs - rhs) < 1e-8 * max(abs(lhs), 1.0)


def test_tridiag_factorization_solves_M(problem):
    """Block Cholesky solve agrees with dense solve of the assembled M."""
    prob, data = problem
    qp_b = blockqp.build_block_qp(prob.model, prob.plan.schedule, prob.ocp,
                                  prob.X0, prob.U0, data,
                                  jnp.asarray(100.0), jnp.asarray(100.0))
    s = blockqp._ruiz(qp_b, 5)
    settings = QPSettings()
    rho = jnp.asarray(0.1, jnp.float64)
    diag, off = blockqp._assemble_blocks(
        s, blockqp._rho_groups(settings, rho, s),
        jnp.asarray(1e-6, jnp.float64))
    N, V = diag.shape[0] - 1, diag.shape[1]
    # dense M from blocks
    M = np.zeros((diag.shape[0] * V, diag.shape[0] * V))
    for k in range(N + 1):
        M[k * V:(k + 1) * V, k * V:(k + 1) * V] = np.asarray(diag[k])
    for k in range(N):
        M[(k + 1) * V:(k + 2) * V, k * V:(k + 1) * V] = np.asarray(off[k])
        M[k * V:(k + 1) * V, (k + 1) * V:(k + 2) * V] = np.asarray(off[k]).T
    rng = np.random.default_rng(2)
    b = rng.normal(size=(N + 1, V))
    fac = blockqp._block_tridiag_cholesky(diag, off)
    w = blockqp._block_tridiag_solve(fac, jnp.asarray(b))
    w_dense = np.linalg.solve(M, b.reshape(-1)).reshape(N + 1, V)
    np.testing.assert_allclose(np.asarray(w), w_dense, rtol=1e-8, atol=1e-10)


def test_block_solution_matches_dense(problem):
    prob, data = problem
    qp_d = _dense_of_block(prob, data, 100.0, 100.0)
    qp_b = blockqp.build_block_qp(prob.model, prob.plan.schedule, prob.ocp,
                                  prob.X0, prob.U0, data,
                                  jnp.asarray(100.0), jnp.asarray(100.0))
    sd = solve_qp(qp_d, QPSettings())
    sb = blockqp.solve_block_qp(qp_b, QPSettings())
    assert bool(sb.converged)
    N = prob.plan.horizon
    Xd = np.asarray(sd.x[:9 * (N + 1)]).reshape(N + 1, 9)
    Ud = np.asarray(sd.x[9 * (N + 1):9 * (N + 1) + 12 * N]).reshape(N, 12)
    np.testing.assert_allclose(np.asarray(sb.X), Xd, atol=5e-5)
    np.testing.assert_allclose(np.asarray(sb.U), Ud, atol=5e-4)


def test_scp_block_backend_matches_dense(problem):
    prob, _ = problem
    sol_d = solve_scp(prob.model, prob.plan.schedule, prob.ocp,
                      prob.X0, prob.U0, prob.scp)
    scp_b = dataclasses.replace(prob.scp, qp_backend="block")
    sol_b = solve_scp(prob.model, prob.plan.schedule, prob.ocp,
                      prob.X0, prob.U0, scp_b)
    assert bool(sol_b.success)
    np.testing.assert_allclose(np.asarray(sol_b.X), np.asarray(sol_d.X),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(sol_b.U), np.asarray(sol_d.U),
                               atol=5e-4)


def test_wrench6_block_matches_dense():
    """Talos (wrench6 + CoP rows): block solution matches the dense path."""
    import dataclasses as dc
    preset = dc.replace(
        presets.TALOS_PACE,
        gait=dc.replace(presets.TALOS_PACE.gait, nb_steps=1))
    prob = presets.build_problem(preset, dtype=jnp.float64)
    data = compute_trajectory_data(prob.model, prob.plan.schedule,
                                   prob.X0, prob.U0)
    r, w = jnp.asarray(100.0), jnp.asarray(100.0)
    qp_d = build_qp(prob.model, prob.plan.schedule, prob.ocp, prob.X0,
                    prob.U0, data, r, w)
    qp_b = blockqp.build_block_qp(prob.model, prob.plan.schedule, prob.ocp,
                                  prob.X0, prob.U0, data, r, w)
    # this QP converges slowly at 1e-7 (verified feasible via HiGHS); the
    # parity claim is that both paths walk the SAME iterates, so a looser
    # tolerance with a tight solution comparison is the sharper test
    qs = QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=20000)
    sd = solve_qp(qp_d, qs)
    sb = blockqp.solve_block_qp(qp_b, qs)
    assert bool(sd.converged) and bool(sb.converged)
    N, nu = prob.plan.horizon, prob.model.n_u
    Xd = np.asarray(sd.x[:9 * (N + 1)]).reshape(N + 1, 9)
    Ud = np.asarray(sd.x[9 * (N + 1):9 * (N + 1) + nu * N]).reshape(N, nu)
    np.testing.assert_allclose(np.asarray(sb.X), Xd, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sb.U), Ud, atol=1e-6)
    # CoP box respected at active knots
    logic = np.asarray(prob.plan.schedule.logic)
    cop = np.asarray(sb.U).reshape(N, 2, 6)[:, :, :2]
    fhd = prob.preset.robot.foot_half_dims
    assert (cop[logic > 0][:, 0] <= fhd[0] + 1e-2).all()
    assert (cop[logic > 0][:, 0] >= -fhd[1] - 1e-2).all()

def test_polish_refines_loose_solve_to_tight_accuracy(problem):
    """eps=1e-3 + polish reaches the tight-eps solution (the OSQP
    polish-on semantics the reference runs with, src/scp_solver.py:62)."""
    prob, data = problem
    qp_b = blockqp.build_block_qp(prob.model, prob.plan.schedule, prob.ocp,
                                  prob.X0, prob.U0, data,
                                  jnp.asarray(100.0), jnp.asarray(100.0))
    tight = dataclasses.replace(prob.scp.qp, adaptive_rho=False)
    ref = blockqp.solve_block_qp(qp_b, tight)
    loose = dataclasses.replace(tight, eps_abs=1e-3, eps_rel=1e-3,
                                polish=True)
    sol = blockqp.solve_block_qp(qp_b, loose)
    assert bool(sol.converged)
    assert int(sol.iterations) < int(ref.iterations)
    # polished solution matches the tight reference well inside the
    # 1e-4 parity budget
    assert float(jnp.abs(sol.X - ref.X).max()) < 1e-4
    assert float(jnp.abs(sol.U - ref.U).max()) < 1e-3
    # and its KKT residuals are at least as good
    assert float(sol.prim_res) <= float(ref.prim_res) + 1e-9


def test_polish_never_degrades(problem):
    """Accept-if-both-improve: with polish on, residuals are never worse
    than the unpolished iterate (checked at several tolerances)."""
    prob, data = problem
    qp_b = blockqp.build_block_qp(prob.model, prob.plan.schedule, prob.ocp,
                                  prob.X0, prob.U0, data,
                                  jnp.asarray(100.0), jnp.asarray(100.0))
    for eps in (1e-2, 1e-4):
        base = dataclasses.replace(prob.scp.qp, adaptive_rho=False,
                                   eps_abs=eps, eps_rel=eps)
        raw = blockqp.solve_block_qp(qp_b, base)
        pol = blockqp.solve_block_qp(
            qp_b, dataclasses.replace(base, polish=True))
        assert float(pol.prim_res) <= float(raw.prim_res) + 1e-12
        assert float(pol.dual_res) <= float(raw.dual_res) + 1e-12


def test_f32_polish_reaches_parity_bar(problem):
    """SURVEY section-7c mixed-precision refinement (VERDICT round 3,
    item 1): a LOOSE (eps=5e-4, ~90 iteration) float32 solve plus the
    residual-form refinement polish reaches the BASELINE 1e-4-class
    parity bar against a tight (eps=1e-9 + polish) float64 reference --
    the f32-on-GPU accuracy story, verified here on the CPU backend
    (same arithmetic, same code path)."""
    prob, data = problem
    qp64 = blockqp.build_block_qp(prob.model, prob.plan.schedule,
                                  prob.ocp, prob.X0, prob.U0, data,
                                  jnp.asarray(100.0), jnp.asarray(100.0))
    tight = QPSettings(eps_abs=1e-9, eps_rel=1e-9, max_iter=40000,
                       adaptive_rho=True, polish=True)
    w064 = blockqp.WVars(x=prob.X0, u=prob.U0,
                         t=jnp.zeros(prob.X0.shape[0], jnp.float64))
    ref = blockqp.solve_block_qp(qp64, tight, w0=w064)
    assert bool(ref.converged)

    qp32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, qp64)
    loose = QPSettings(eps_abs=5e-4, eps_rel=5e-4, max_iter=4000,
                       adaptive_rho=False, check_interval=10, alpha=1.7,
                       polish=True)
    w032 = jax.tree.map(lambda a: a.astype(jnp.float32), w064)
    sol = blockqp.solve_block_qp(qp32, loose, w0=w032)
    assert bool(sol.converged)
    x_err = float(jnp.abs(sol.X.astype(jnp.float64) - ref.X).max())
    u_err = float(jnp.abs(sol.U.astype(jnp.float64) - ref.U).max())
    assert x_err < 1e-4, x_err
    assert u_err < 1e-4, u_err


def test_two_float_dual_certifies_tight_f32_tier(problem):
    """VERDICT round-4 item 3 (eps <= 1e-5 certification in f32): the
    polish carries the refined dual as a two-float (hi, lo) pair
    (ops/blockqp._two_sum) because one f32 ulp of the O(1e2) scaled
    equality duals is the size of the whole eps=1e-5 dual residual --
    round 4's 'f32 dual floor' (8% of bench lanes missing the
    convergence flag at u_err 3.8e-6) was dual storage/measurement
    precision, not solver accuracy.  This pins the fix on the CPU
    backend with the same f32 arithmetic: a tier-settings f32 solve of
    the N=50 trot QP must certify eps_abs=eps_rel=1e-5 and report a
    dual residual well under the relative threshold (on-chip evidence:
    BENCH_r05 accuracy_tiers eps=1e-5 success_frac 1.0 at batch 128).
    """
    prob, data = problem
    qp64 = blockqp.build_block_qp(prob.model, prob.plan.schedule,
                                  prob.ocp, prob.X0, prob.U0, data,
                                  jnp.asarray(100.0), jnp.asarray(100.0))
    qp32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, qp64)
    tier = QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000,
                      adaptive_rho=False, check_interval=10, alpha=1.7,
                      stall_segments=30, polish=True,
                      polish_rho_ramp=10.0, polish_cg_iters=20,
                      polish_cg_restarts=3)
    w0 = blockqp.WVars(x=qp32.qx * 0 + prob.X0.astype(jnp.float32),
                       u=prob.U0.astype(jnp.float32),
                       t=jnp.zeros(prob.X0.shape[0], jnp.float32))
    sol = blockqp.solve_block_qp(qp32, tier, w0=w0)
    assert bool(sol.converged), (float(sol.prim_res), float(sol.dual_res))
    # the dual threshold for this QP sits at ~2.6e-2 (unscaled,
    # relative); the two-float dual lands the median lane near 1e-3
    assert float(sol.dual_res) < 2.6e-2, float(sol.dual_res)
