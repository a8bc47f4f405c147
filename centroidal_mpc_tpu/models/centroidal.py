"""Centroidal dynamics model.

Reference: src/centroidal_model.py.  State x = [com(3), lin_mom(3),
ang_mom(3)]; control u = per-contact forces (point3) or per-contact
(cop_x, cop_y, f, tau_z) wrenches (wrench6); explicit-Euler discretization
x+ = x + dt * xdot (reference integrate_model_one_step, :189-212).

Design departures from the reference (deliberate, accelerator-first):
  * trajectories are arrays shaped (N+1, nx) / (N, nu) -- the reference's
    flat-vector index bookkeeping (src/optimizer.py) dissolves into axes;
  * linearization is one `vmap` over knots (A/B/C for all N knots at once)
    with closed-form Jacobians instead of a sequential `fori_loop` of
    `jacfwd` calls (reference compute_trajectory_data, :257-291) -- the
    knots are independent given (X, U), so the loop was pure overhead;
  * only the genuinely sequential recursion (covariance propagation) uses
    `lax.scan`;
  * the model is a PyTreeNode: numeric parameters are leaves (so one
    compiled program serves any robot of identical dimensions), while shape
    determining metadata is static.

AD-based Jacobians are kept (`linearize_step_ad`) as a test oracle for the
closed forms.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from centroidal_mpc_tpu.config.robots import POINT3, WRENCH6, RobotSpec
from centroidal_mpc_tpu.contact.plan import ContactSchedule
from centroidal_mpc_tpu.utils import struct
from centroidal_mpc_tpu.utils.precision import highest_precision

N_X = 9


class CentroidalModel(struct.PyTreeNode):
    """Centroidal dynamics parameters (pytree)."""

    mass: jnp.ndarray          # scalar
    gravity: jnp.ndarray       # scalar (signed, -9.81)
    dt: jnp.ndarray            # scalar
    Q: jnp.ndarray             # (nx, nx) LQR state weights
    R: jnp.ndarray             # (nu, nu) LQR control weights
    cov_w: jnp.ndarray         # (n_w, n_w) contact-position noise
    cov_eta: jnp.ndarray       # (nx, nx) additive white noise
    contact_model: str = struct.field(pytree_node=False, default=POINT3)
    n_contacts: int = struct.field(pytree_node=False, default=4)

    @property
    def n_u_per_contact(self) -> int:
        return 3 if self.contact_model == POINT3 else 6

    @property
    def n_u(self) -> int:
        return self.n_contacts * self.n_u_per_contact

    @property
    def n_w(self) -> int:
        return self.n_contacts * 3

    @classmethod
    def from_spec(cls, robot: RobotSpec, dt: float, Q, R, cov_w, cov_eta,
                  dtype=jnp.float32) -> "CentroidalModel":
        # numpy leaves: the model is closed over by jitted solvers, and
        # numpy constants embed in the program as literals, with no
        # device transfer at lowering (see contact/plan.py).
        np_ = np.asarray
        return cls(
            mass=np_(robot.mass, dtype),
            gravity=np_(robot.gravity, dtype),
            dt=np_(dt, dtype),
            Q=np_(Q, dtype),
            R=np_(R, dtype),
            cov_w=np_(cov_w, dtype),
            cov_eta=np_(cov_eta, dtype),
            contact_model=robot.contact_model,
            n_contacts=robot.n_contacts,
        )


class TrajectoryData(struct.PyTreeNode):
    """Per-knot linearization data (the reference's traj_data dict,
    src/centroidal_model.py:261-268, minus the all-zero covariance-gradient
    tensors -- see `scp.py` for the compatibility discussion)."""

    f: jnp.ndarray      # (N, nx)      one-step integration at (x_k, u_k)
    A: jnp.ndarray      # (N, nx, nx)  d f / d x
    B: jnp.ndarray      # (N, nx, nu)  d f / d u
    C: jnp.ndarray      # (N, nx, n_w) d f / d contact positions
    K: jnp.ndarray      # (N, nu, nx)  LQR feedback gains
    Sigma: jnp.ndarray  # (N+1, nx, nx) state covariance


def _skew(v: jnp.ndarray) -> jnp.ndarray:
    """Cross-product matrix [v]x with v x w = _skew(v) @ w."""
    zero = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([zero, -v[..., 2], v[..., 1]], axis=-1),
        jnp.stack([v[..., 2], zero, -v[..., 0]], axis=-1),
        jnp.stack([-v[..., 1], v[..., 0], zero], axis=-1),
    ], axis=-2)


def _contact_wrench(model: CentroidalModel, x, u, pos, logic, rot):
    """Per-contact effective force and angular-momentum rate contribution.

    Returns (forces (C,3), ang_rates (C,3)); both already gated by the
    contact activation logic (reference src/centroidal_model.py:195-211).
    """
    c = model.n_contacts
    r = pos - x[:3]  # contact position relative to CoM
    if model.contact_model == POINT3:
        forces = u.reshape(c, 3) * logic[:, None]
        ang = jnp.cross(r, forces)
    else:  # WRENCH6: u_c = (cop_x, cop_y, fx, fy, fz, tau_z)
        uc = u.reshape(c, 6)
        forces = uc[:, 2:5] * logic[:, None]
        cop_world = jnp.einsum("cij,cj->ci", rot[:, :, :2], uc[:, :2])
        ang = (jnp.cross(r, forces)
               + jnp.cross(cop_world, uc[:, 2:5]) * logic[:, None]
               + rot[:, :, 2] * (uc[:, 5] * logic)[:, None])
    return forces, ang


def dynamics_step(model: CentroidalModel, x, u, pos, logic, rot):
    """One explicit-Euler step x+ = x + dt * xdot.

    Args shapes: x (nx,), u (nu,), pos (C,3), logic (C,), rot (C,3,3).
    Reference: integrate_model_one_step (src/centroidal_model.py:189-212).
    """
    m = model.mass
    forces, ang = _contact_wrench(model, x, u, pos, logic, rot)
    grav = jnp.zeros(3, x.dtype).at[2].set(m * model.gravity)
    xdot = jnp.concatenate([x[3:6] / m, forces.sum(0) + grav, ang.sum(0)])
    return x + model.dt * xdot


def linearize_step(model: CentroidalModel, x, u, pos, logic, rot):
    """Closed-form (f, A, B, C) of the discrete step at one knot.

    A = d step/dx (nx,nx), B = d step/du (nx,nu), C = d step/d pos (nx,3C).
    Matches jacfwd of `dynamics_step` (verified by tests against
    `linearize_step_ad`); reference computes these with three jacfwd calls
    per knot (src/centroidal_model.py:230-232).
    """
    n_c, dt, m = model.n_contacts, model.dt, model.mass
    dtype = x.dtype
    f = dynamics_step(model, x, u, pos, logic, rot)
    forces, _ = _contact_wrench(model, x, u, pos, logic, rot)
    skew_f = _skew(forces)                      # (C,3,3), logic included
    r = pos - x[:3]

    # A = I + dt * J_x
    A = jnp.eye(N_X, dtype=dtype)
    A = A.at[0:3, 3:6].add(dt / m * jnp.eye(3, dtype=dtype))
    # d/d com of sum (p_c - com) x f_c = + sum [f_c]x
    A = A.at[6:9, 0:3].add(dt * skew_f.sum(0))

    # B blocks per contact
    B = jnp.zeros((N_X, model.n_u), dtype=dtype)
    skew_r = _skew(r) * logic[:, None, None]    # d ang / d f_c = [p-c]x
    if model.contact_model == POINT3:
        lin_rows = jnp.einsum("c,ij->icj", logic, jnp.eye(3, dtype=dtype))
        B = B.at[3:6, :].set(lin_rows.reshape(3, -1) * dt)
        B = B.at[6:9, :].set(skew_r.transpose(1, 0, 2).reshape(3, -1) * dt)
    else:
        uc = u.reshape(n_c, 6)
        f_raw = uc[:, 2:5]
        cop_world = jnp.einsum("cij,cj->ci", rot[:, :, :2], uc[:, :2])
        blocks = jnp.zeros((n_c, N_X, 6), dtype=dtype)
        # d ang / d cop = -[f]x R[:, :2]   (w x f = -[f]x w)
        d_cop = -jnp.einsum("cij,cjk->cik", _skew(f_raw), rot[:, :, :2])
        blocks = blocks.at[:, 6:9, 0:2].set(d_cop * logic[:, None, None])
        blocks = blocks.at[:, 3:6, 2:5].set(
            jnp.eye(3, dtype=dtype)[None] * logic[:, None, None])
        blocks = blocks.at[:, 6:9, 2:5].set(
            skew_r + _skew(cop_world) * logic[:, None, None])
        blocks = blocks.at[:, 6:9, 5].set(rot[:, :, 2] * logic[:, None])
        B = blocks.transpose(1, 0, 2).reshape(N_X, model.n_u) * dt

    # C: d ang / d p_c = -[f_c]x
    C = jnp.zeros((N_X, model.n_w), dtype=dtype)
    C = C.at[6:9, :].set(-skew_f.transpose(1, 0, 2).reshape(3, -1) * dt)
    return f, A, B, C


def linearize_step_ad(model: CentroidalModel, x, u, pos, logic, rot):
    """AD oracle for `linearize_step` (jacfwd, like the reference)."""
    f = dynamics_step(model, x, u, pos, logic, rot)
    A = jax.jacfwd(dynamics_step, argnums=1)(model, x, u, pos, logic, rot)
    B = jax.jacfwd(dynamics_step, argnums=2)(model, x, u, pos, logic, rot)
    flat_step = lambda p: dynamics_step(model, x, u, p.reshape(pos.shape),
                                        logic, rot)
    C = jax.jacfwd(flat_step)(pos.reshape(-1))
    return f, A, B, C


@highest_precision
def lqr_gain(model: CentroidalModel, A, B, n_iter: int = 2,
             ns_iters: int = 6):
    """LQR feedback gain from an n_iter-truncated DARE fixed point.

    Reference: compute_lqr_feedback_gains (src/centroidal_model.py:217-228):
    P <- Q; repeat n_iter: P <- Q + A'PA - A'PB (R + B'PB)^-1 B'PA;
    K = -(R + B'PB)^-1 B'PA.  The SPD solves use the matmul-only
    Newton-Schulz inverse (ops/linalg.py), which batches over knots and
    scenarios as plain matrix products.

    ns_iters: the Jacobi-preconditioned H = R + B'PB sits at cond ~1e2,
    where the quadratic iteration is fully converged (f32 AND f64
    roundoff) by iteration 4 -- measured on the solo12 trot N=50
    matrices; 6 leaves two squaring steps of margin over the
    spd_inverse default of 16 it replaces.
    """
    from centroidal_mpc_tpu.ops.linalg import spd_inverse
    Q, R = model.Q, model.R

    def dare(P, _):
        AtP = A.T @ P
        AtPB = AtP @ B
        H_inv = spd_inverse(R + B.T @ P @ B, ns_iters)
        P_next = (Q + AtP @ A) - AtPB @ H_inv @ AtPB.T
        return P_next, None

    P, _ = jax.lax.scan(dare, Q, None, length=n_iter)
    return -spd_inverse(R + B.T @ P @ B, ns_iters) @ (B.T @ P @ A)


def propagate_covariance(model: CentroidalModel, A, B, C, K, sigma0=None):
    """Closed-loop covariance recursion over the horizon via scan.

    Sigma_{k+1} = (A_k + B_k K_k) Sigma_k (A_k + B_k K_k)' + C_k cov_w C_k'
                  + cov_eta
    which equals the reference's [A B] Sigma_xu [A B]' form with
    Sigma_xu = [[S, SK'], [KS, KSK']] (src/centroidal_model.py:234-238).
    Returns (N+1, nx, nx) with Sigma_0 = sigma0 (zeros by default, matching
    the reference's zero-initialized Covs buffer, :266).
    """
    dtype = A.dtype
    if sigma0 is None:
        sigma0 = jnp.zeros((N_X, N_X), dtype=dtype)

    def step(sigma, inputs):
        a, b, c, k = inputs
        acl = a + b @ k
        sigma_next = (acl @ sigma @ acl.T + c @ model.cov_w @ c.T
                      + model.cov_eta)
        return sigma_next, sigma_next

    _, sigmas = jax.lax.scan(step, sigma0, (A, B, C, K))
    return jnp.concatenate([sigma0[None], sigmas], axis=0)


@highest_precision
def compute_trajectory_data(model: CentroidalModel,
                            schedule: ContactSchedule,
                            X: jnp.ndarray, U: jnp.ndarray,
                            lqr_iters: int = 2,
                            with_covariance: bool = True) -> TrajectoryData:
    """Linearize the whole trajectory in one shot.

    Replaces the reference's sequential fori_loop of compute_everything
    (src/centroidal_model.py:257-291) with a vmap over knots plus a scan for
    the covariance recursion.  X: (N+1, nx); U: (N, nu).

    with_covariance=False skips the (genuinely sequential) covariance scan
    and returns zeros for Sigma -- the nominal OCP never reads it
    (back-offs exist only in stochastic mode), and the scan is a
    measurable fraction of the batched solve profile.
    """
    pos = schedule.positions_flat().reshape(schedule.horizon,
                                            schedule.n_contacts, 3)
    f, A, B, C = jax.vmap(linearize_step, in_axes=(None, 0, 0, 0, 0, 0))(
        model, X[:-1], U, pos, schedule.logic, schedule.orientation)
    K = jax.vmap(lqr_gain, in_axes=(None, 0, 0, None))(model, A, B,
                                                       lqr_iters)
    if with_covariance:
        Sigma = propagate_covariance(model, A, B, C, K)
    else:
        n = schedule.horizon
        Sigma = jnp.zeros((n + 1, N_X, N_X), A.dtype)
    return TrajectoryData(f=f, A=A, B=B, C=C, K=K, Sigma=Sigma)


def integrate_dynamics_trajectory(model: CentroidalModel,
                                  schedule: ContactSchedule,
                                  X: jnp.ndarray, U: jnp.ndarray):
    """Pointwise one-step integration at every knot: (N, nx).

    NOTE: like the reference (integrate_dynamics_trajectory,
    src/centroidal_model.py:243-255) this evaluates step(x_k, u_k) for each
    knot of the *given* trajectory -- it does not chain states.  For a true
    rollout use `rollout`.
    """
    pos = schedule.position
    return jax.vmap(dynamics_step, in_axes=(None, 0, 0, 0, 0, 0))(
        model, X[:-1], U, pos, schedule.logic, schedule.orientation)


def rollout(model: CentroidalModel, schedule: ContactSchedule,
            x0: jnp.ndarray, U: jnp.ndarray) -> jnp.ndarray:
    """Chained nonlinear rollout from x0 under controls U: (N+1, nx)."""

    def step(x, inputs):
        u, pos, logic, rot = inputs
        x_next = dynamics_step(model, x, u, pos, logic, rot)
        return x_next, x_next

    _, xs = jax.lax.scan(
        step, x0, (U, schedule.position, schedule.logic, schedule.orientation))
    return jnp.concatenate([x0[None], xs], axis=0)


def model_accuracy(model: CentroidalModel, schedule: ContactSchedule,
                   X_curr, U_curr, X_prev, U_prev,
                   data: TrajectoryData) -> jnp.ndarray:
    """GuSTO model-accuracy ratio rho.

    rho = sum_k |e_k|^2 / sum_k |l_k|^2 with
    l_k = f_k + A_k dx_k + B_k du_k (linear prediction around the previous
    trajectory) and e_k the *angular-momentum rows only* (6:9) of the
    nonlinear-vs-linear mismatch -- exactly the reference's
    compute_model_accuracy (src/scp_solver.py:71-87).
    """
    f_nl = integrate_dynamics_trajectory(model, schedule, X_curr, U_curr)
    dx = X_curr[:-1] - X_prev[:-1]
    du = U_curr - U_prev
    linear = (data.f + jnp.einsum("kij,kj->ki", data.A, dx)
              + jnp.einsum("kij,kj->ki", data.B, du))
    err = f_nl[:, 6:] - linear[:, 6:]
    return jnp.sum(err * err) / jnp.sum(linear * linear)
