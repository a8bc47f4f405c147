"""GuSTO-style SCP driver as a single jitted lax.while_loop.

Reference: solve_scp (src/scp_solver.py:118-179).  Per iteration: linearize
-> assemble QP -> solve -> trust-region accept/reject with the model
accuracy ratio rho; radius shrinks by beta_fail on inaccuracy, grows by
beta_succ (capped at the initial radius) on high accuracy, and the L1
penalty weight grows by gamma_fail when the solution leaves the trust
region.  Stop on max_iterations, omega > omega_max, or convergence.

Device/host behavior: the reference crosses device -> host -> C per
iteration (JAX linearization, numpy/scipy assembly, OSQP); here the entire
loop body is one XLA program, so batches of SCP solves vmap/shard cleanly.

Reference-compatibility notes (SURVEY.md section 2b):
  * the reference NEVER updates its linearization point: `traj_tuple` and
    `prev_traj_dict` stay equal to the initial trajectory for the whole
    loop (src/scp_solver.py:129-130 are the only assignments), so the
    convergence metric is identically zero and the loop terminates at the
    first accepted iterate.  `update_linearization=False` (default)
    replicates this; True gives the proper re-linearizing GuSTO loop.
  * trust-region membership uses the numpy *spectral* norm of the state
    difference matrix -- np.linalg.norm(M, 2) on a 2-D array
    (src/scp_solver.py:151) -- replicated here with jnp matrix norms.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from centroidal_mpc_tpu.contact.plan import ContactSchedule
from centroidal_mpc_tpu.models.centroidal import (CentroidalModel,
                                                  compute_trajectory_data,
                                                  model_accuracy)
from centroidal_mpc_tpu.ops.admm import QPSettings, solve_qp
from centroidal_mpc_tpu.ops import blockqp
from centroidal_mpc_tpu.solver.ocp import N_X, OcpConfig, build_qp, qp_dims
from centroidal_mpc_tpu.utils import struct
from centroidal_mpc_tpu.utils.precision import highest_precision


@dataclasses.dataclass(frozen=True)
class ScpSettings:
    """Static SCP parameters (reference conf_solo12_trot.py:93-94)."""

    trust_region_radius0: float = 100.0
    omega0: float = 100.0
    omega_max: float = 1e10
    rho0: float = 0.4
    rho1: float = 1.5
    beta_succ: float = 2.0
    beta_fail: float = 0.5
    gamma_fail: float = 5.0
    convergence_threshold: float = 1e-3
    max_iterations: int = 10
    update_linearization: bool = False  # reference-compat default
    # 'dense' = ops.admm on the assembled matrices (reference-layout
    # path); 'block' = ops.blockqp structure-exploiting solver (the
    # throughput path; point3 and wrench6 robots).
    qp_backend: str = "dense"
    # spectral norm for the trust-region test: 'svd' (exact, the
    # reference's np.linalg.norm(A, 2)) or 'power' (10-step power
    # iteration: matmuls only, and the radius margins are wide)
    norm_method: str = "svd"
    # DARE fixed-point iterations for the LQR gains (reference uses 2,
    # src/centroidal_model.py:217-228).  At the full reference horizon
    # (N=165) the 2-iteration gains do NOT stabilize the closed loop:
    # the covariance trace grows ~0 -> 715 over the horizon and the
    # chance back-offs make the stochastic QP infeasible (the reference
    # demo masks this by interpolating the nominal solution,
    # run_motion.py:110 / SURVEY.md 2b).  30 iterations keep Sigma small
    # enough (trace ~65) that the stochastic solve converges.
    lqr_iters: int = 2
    qp: QPSettings = QPSettings()


class ScpSolution(struct.PyTreeNode):
    """Result of one SCP solve (the last accepted iterate, like the
    reference's all_solution[...][-1] usage downstream)."""

    X: jnp.ndarray            # (N+1, nx)
    U: jnp.ndarray            # (N, nu)
    K: jnp.ndarray            # (N, nu, nx) LQR gains of the accepted iterate
    Sigma: jnp.ndarray        # (N+1, nx, nx)
    success: jnp.ndarray      # bool: last iteration accepted
    accepted: jnp.ndarray     # int: number of accepted iterates
    iterations: jnp.ndarray   # int: SCP iterations executed
    qp_iterations: jnp.ndarray  # int: cumulative ADMM iterations
    qp_converged: jnp.ndarray   # bool: all QP subproblems converged
    qp_status: jnp.ndarray      # int32 ops.admm.STATUS_* of the last QP
                                # (PRIMAL/DUAL_INFEASIBLE certify the
                                # abort cause, vs the reference's bare
                                # False return, src/scp_solver.py:146-148)
    qp_stalled: jnp.ndarray     # bool: the last QP left on its stall exit
    qp_polished: jnp.ndarray    # bool: the last QP kept its polished iterate
                                # (block backend; False on the dense one)
    radius: jnp.ndarray
    weight: jnp.ndarray
    rho: jnp.ndarray          # model-accuracy ratio of the last iteration


def _matrix_norm2(M, method: str = "svd"):
    """Largest singular value (numpy's np.linalg.norm(A, 2) on matrices)."""
    if method == "power":
        v = jnp.ones(M.shape[1], M.dtype) / jnp.sqrt(M.shape[1])
        for _ in range(10):
            w = M.T @ (M @ v)
            v = w / jnp.maximum(jnp.linalg.norm(w), 1e-30)
        return jnp.linalg.norm(M @ v)
    return jnp.linalg.svd(M, compute_uv=False)[0]


def _convergence_metric(X_curr, U_curr, X_prev, U_prev):
    """Reference `convergence` (src/scp_solver.py:51-56): relative spectral
    norm change of the control and state matrices."""
    return (_matrix_norm2(U_curr - U_prev) / _matrix_norm2(U_curr)
            + _matrix_norm2(X_curr - X_prev) / _matrix_norm2(X_curr))


@highest_precision
def solve_scp(model: CentroidalModel, schedule: ContactSchedule,
              cfg: OcpConfig, X0: jnp.ndarray, U0: jnp.ndarray,
              settings: ScpSettings = ScpSettings()) -> ScpSolution:
    """Solve the SCP problem from initial trajectory (X0, U0).  Jittable."""
    N = U0.shape[0]
    dtype = X0.dtype
    n, segs = qp_dims(model, N)
    m = sum(segs.values())

    class Carry(struct.PyTreeNode):
        X_lin: jnp.ndarray
        U_lin: jnp.ndarray
        X_cmp: jnp.ndarray   # comparison trajectory (reference prev_traj_dict)
        U_cmp: jnp.ndarray
        X_acc: jnp.ndarray   # last accepted solution
        U_acc: jnp.ndarray
        K_acc: jnp.ndarray
        Sigma_acc: jnp.ndarray
        radius: jnp.ndarray
        weight: jnp.ndarray
        it: jnp.ndarray
        success: jnp.ndarray
        accepted: jnp.ndarray
        qp_iters: jnp.ndarray
        qp_ok: jnp.ndarray
        qp_status: jnp.ndarray
        qp_stalled: jnp.ndarray
        qp_polished: jnp.ndarray
        rho: jnp.ndarray
        conv: jnp.ndarray
        warm_x: jnp.ndarray
        warm_y: jnp.ndarray
        warm_t: jnp.ndarray

    init = Carry(
        X_lin=X0, U_lin=U0, X_cmp=X0, U_cmp=U0,
        X_acc=X0, U_acc=U0,
        K_acc=jnp.zeros((N, model.n_u, N_X), dtype),
        Sigma_acc=jnp.zeros((N + 1, N_X, N_X), dtype),
        radius=jnp.asarray(settings.trust_region_radius0, dtype),
        weight=jnp.asarray(settings.omega0, dtype),
        it=jnp.zeros((), jnp.int32),
        success=jnp.asarray(False),
        accepted=jnp.zeros((), jnp.int32),
        qp_iters=jnp.zeros((), jnp.int32),
        qp_ok=jnp.asarray(True),
        qp_status=jnp.zeros((), jnp.int32),
        qp_stalled=jnp.asarray(False),
        qp_polished=jnp.asarray(False),
        rho=jnp.zeros((), dtype),
        conv=jnp.zeros((), dtype),
        # Block backend: primal warm start from the linearization
        # trajectory (the QP solution stays near it once the SCP is
        # tracking), duals threaded as the blockqp ZGroups pytree across
        # SCP iterations -- OSQP's warm_start=True semantics
        # (src/scp_solver.py:62).  Dense backend keeps the flat layout
        # and starts from zero.
        warm_x=jnp.concatenate([X0.reshape(-1), U0.reshape(-1)])
        if settings.qp_backend == "block" else jnp.zeros(n, dtype),
        warm_y=blockqp.zero_zgroups(N, schedule.logic.shape[1], dtype)
        if settings.qp_backend == "block" else jnp.zeros(m, dtype),
        warm_t=jnp.zeros(N + 1, dtype),
    )

    def cond(c: Carry):
        # reference while condition (src/scp_solver.py:133-134) plus the
        # QP-failure break (:146-148).
        not_converged = ~((c.it != 0) & c.success
                          & (c.conv < settings.convergence_threshold))
        return ((c.it < settings.max_iterations)
                & (c.weight < settings.omega_max)
                & not_converged & c.qp_ok)

    # Frozen-linearization mode (the solo12 reference semantics,
    # src/scp_solver.py:140 linearizing the initial trajectory every
    # iteration): X_lin/U_lin never change, so the linearization -- and
    # especially the LQR-gain chain, whose Newton-Schulz inverses are
    # ~100 sequential tiny matmuls per DARE -- is computed ONCE outside
    # the while_loop.  XLA does not hoist it on its own.
    data_const = None
    qp_const = None
    if not settings.update_linearization:
        data_const = compute_trajectory_data(
            model, schedule, X0, U0, lqr_iters=settings.lqr_iters,
            with_covariance=cfg.stochastic)
        if settings.qp_backend == "block":
            # the QP blocks are likewise frozen; only the trust-region
            # radius and the L1 penalty weight vary across iterations
            qp_const = blockqp.build_block_qp(
                model, schedule, cfg, X0, U0, data_const,
                jnp.asarray(settings.trust_region_radius0, dtype),
                jnp.asarray(settings.omega0, dtype))

    def body(c: Carry):
        if data_const is not None:
            data = data_const
        else:
            data = compute_trajectory_data(model, schedule, c.X_lin,
                                           c.U_lin,
                                           lqr_iters=settings.lqr_iters,
                                           with_covariance=cfg.stochastic)
        if settings.qp_backend == "block":
            if qp_const is not None:
                qp = qp_const.replace(
                    inv_omega=1.0 / c.weight,
                    trust_ub=c.radius + X0[:, 6:9] @ qp_const.penum.T)
            else:
                qp = blockqp.build_block_qp(model, schedule, cfg, c.X_lin,
                                            c.U_lin, data, c.radius,
                                            c.weight)
            w0 = blockqp.WVars(
                x=c.warm_x[:N_X * (N + 1)].reshape(N + 1, N_X),
                u=c.warm_x[N_X * (N + 1):].reshape(N, model.n_u),
                t=c.warm_t)
            bsol = blockqp.solve_block_qp(qp, settings.qp, w0=w0,
                                          y0=c.warm_y)
            X_sol, U_sol = bsol.X, bsol.U
            sol_warm_x = jnp.concatenate([X_sol.reshape(-1),
                                          U_sol.reshape(-1)])
            sol_warm_y, sol_warm_t = bsol.y, bsol.t
            sol_iters, sol_converged = bsol.iterations, bsol.converged
            sol_status = bsol.status
            sol_stalled, sol_polished = bsol.stalled, bsol.polished
        else:
            qp = build_qp(model, schedule, cfg, c.X_lin, c.U_lin, data,
                          c.radius, c.weight)
            sol = solve_qp(qp, settings.qp, x0=c.warm_x, y0=c.warm_y)
            X_sol = sol.x[:N_X * (N + 1)].reshape(N + 1, N_X)
            U_sol = sol.x[N_X * (N + 1):N_X * (N + 1)
                          + model.n_u * N].reshape(N, model.n_u)
            sol_warm_x, sol_warm_y, sol_warm_t = sol.x, sol.y, c.warm_t
            sol_iters, sol_converged = sol.iterations, sol.converged
            sol_status = sol.status
            sol_stalled = sol_polished = jnp.asarray(False)

        inside = (_matrix_norm2(X_sol - c.X_cmp, settings.norm_method)
                  < c.radius)
        rho = model_accuracy(model, schedule, X_sol, U_sol,
                             c.X_lin, c.U_lin, data)
        accurate = rho <= settings.rho1
        # A non-converged QP (infeasible or iteration-limited) is never
        # accepted; the loop condition also aborts, mirroring the
        # reference's bare-False return (src/scp_solver.py:146-148).
        accept = inside & accurate & sol_converged

        radius = jnp.where(
            inside & ~accurate, c.radius * settings.beta_fail,
            jnp.where(accept & (rho < settings.rho0),
                      jnp.minimum(settings.beta_succ * c.radius,
                                  settings.trust_region_radius0),
                      c.radius))
        weight = jnp.where(inside, c.weight, c.weight * settings.gamma_fail)

        sel = lambda a, b: jnp.where(accept, a, b)
        X_acc = sel(X_sol, c.X_acc)
        U_acc = sel(U_sol, c.U_acc)
        K_acc = sel(data.K, c.K_acc)
        Sigma_acc = sel(data.Sigma, c.Sigma_acc)

        if settings.update_linearization:
            X_lin = sel(X_sol, c.X_lin)
            U_lin = sel(U_sol, c.U_lin)
            X_cmp = sel(c.X_lin, c.X_cmp)
            U_cmp = sel(c.U_lin, c.U_cmp)
            conv = _convergence_metric(X_lin, U_lin, X_cmp, U_cmp)
        else:
            X_lin, U_lin, X_cmp, U_cmp = c.X_lin, c.U_lin, c.X_cmp, c.U_cmp
            conv = jnp.zeros((), dtype)  # reference: always 0 (see module doc)

        return Carry(
            X_lin=X_lin, U_lin=U_lin, X_cmp=X_cmp, U_cmp=U_cmp,
            X_acc=X_acc, U_acc=U_acc, K_acc=K_acc, Sigma_acc=Sigma_acc,
            radius=radius, weight=weight, it=c.it + 1, success=accept,
            accepted=c.accepted + accept.astype(jnp.int32),
            qp_iters=c.qp_iters + sol_iters,
            qp_ok=c.qp_ok & sol_converged,
            qp_status=sol_status,
            qp_stalled=sol_stalled, qp_polished=sol_polished,
            rho=rho, conv=conv, warm_x=sol_warm_x, warm_y=sol_warm_y,
            warm_t=sol_warm_t)

    c = jax.lax.while_loop(cond, body, init)
    return ScpSolution(
        X=c.X_acc, U=c.U_acc, K=c.K_acc, Sigma=c.Sigma_acc,
        success=c.success, accepted=c.accepted, iterations=c.it,
        qp_iterations=c.qp_iters, qp_converged=c.qp_ok,
        qp_status=c.qp_status,
        qp_stalled=c.qp_stalled, qp_polished=c.qp_polished,
        radius=c.radius, weight=c.weight, rho=c.rho)
