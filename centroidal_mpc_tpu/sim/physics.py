"""Full-physics whole-body closed-loop simulator (the PyBullet role).

The reference validates plans with nb_sims sequential PyBullet episodes
(src/simulate_solo.py:184-344): a 1 kHz torque loop

    tau = tau_ff + Kp (q_des - q) + Kd (qd_des - qd) - Jc' K_lqr (h - h_des)

(:293-308) under random force pushes (N(0, 15 I) sampled, y component
applied for 200 ms from a random onset, :90-115, :286-291), logging the
centroidal state and foot positions for tracking-cost and foot-slippage
statistics (src/utils.py:94-114, :245-302).

Here the same experiment is one XLA program: the plant is the JAX
floating-base rigid-body engine (models/rigid_body.py) with a penalty
ground-contact model (spring-damper normal force + anchored Coulomb
friction), integrated semi-implicitly at 1 kHz inside a `lax.scan`, and
vmapped over all Monte-Carlo episodes at once.  The contact model is
deliberately DIFFERENT from the planner's KKT contact dynamics — an
independent plant, like PyBullet's LCP solver is to Crocoddyl's KKT — so
closed-loop statistics are a genuine cross-validation, including real foot
slippage (feet can slide when the friction cone saturates), which the
centroidal-only Monte-Carlo (sim/monte_carlo.py) cannot measure.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from centroidal_mpc_tpu.contact.terrain import FLAT, Terrain, TerrainArrays
from centroidal_mpc_tpu.models import rigid_body as rb
from centroidal_mpc_tpu.sim.monte_carlo import FORCE_COV, PUSH_MS
from centroidal_mpc_tpu.utils import struct
from centroidal_mpc_tpu.utils.precision import highest_precision


@dataclasses.dataclass(frozen=True)
class PhysicsSettings:
    """Penalty-contact plant parameters (solo12-scale defaults)."""

    dt: float = 0.001
    ground_kp: float = 5000.0      # normal spring [N/m]
    ground_kd: float = 50.0        # normal damper [N s/m]
    tangent_kp: float = 1500.0     # static-friction anchor spring [N/m]
    tangent_kd: float = 15.0       # tangential damper [N s/m]
    mu: float = 0.5                # Coulomb friction coefficient
    joint_damping: float = 0.005   # actuator/transmission damping [N m s]


class ClosedLoopReferences(struct.PyTreeNode):
    """Control-rate (1 kHz) references for the reference's torque law."""

    q_des: jnp.ndarray     # (T, nj) joint positions
    qd_des: jnp.ndarray    # (T, nj) joint velocities
    tau_ff: jnp.ndarray    # (T, nj) feedforward torques
    h_des: jnp.ndarray     # (T, 9) centroidal state [com, lin, ang]
    K_lqr: jnp.ndarray     # (T, nu, 9) centroidal LQR gains (ZOH)
    logic: jnp.ndarray     # (T, C) contact flags
    kp: jnp.ndarray        # PD gains (scalars)
    kd: jnp.ndarray


class PhysicsSimResult(struct.PyTreeNode):
    h: jnp.ndarray           # (S, T, 9) simulated centroidal states
    feet: jnp.ndarray        # (S, T, C, 3) world foot positions
    base_rpy: jnp.ndarray    # (S, T, 3)
    fell: jnp.ndarray        # (S,) base dropped below half nominal height
    push_force: jnp.ndarray  # (S, 3)
    push_start: jnp.ndarray  # (S,) control-step index


def build_references(wb_traj, X_centroidal, K_lqr, schedule,
                     n_inner: int = 10) -> ClosedLoopReferences:
    """Assemble 1 kHz references from a whole-body trajectory
    (models/whole_body.py track_centroidal_solution or the DDP layer's
    interpolation), the interpolated centroidal plan, and per-knot LQR
    gains from models/centroidal.compute_trajectory_data."""
    from centroidal_mpc_tpu.utils.interpolation import (
        interpolate_linear, interpolate_zero_order)
    X = np.asarray(X_centroidal)
    h_des = interpolate_linear(X, n_inner)
    n = X.shape[0] - 1
    K = interpolate_zero_order(
        np.asarray(K_lqr).reshape(n, -1), n_inner).reshape(
            n * n_inner, K_lqr.shape[1], K_lqr.shape[2])
    logic = np.repeat(np.asarray(schedule.logic), n_inner, axis=0)
    t = min(h_des.shape[0], wb_traj.q.shape[0], K.shape[0], logic.shape[0])
    dtype = wb_traj.q.dtype
    return ClosedLoopReferences(
        q_des=wb_traj.q[:t], qd_des=wb_traj.qdot[:t],
        tau_ff=wb_traj.tau_ff[:t],
        h_des=jnp.asarray(h_des[:t], dtype),
        K_lqr=jnp.asarray(K[:t], dtype),
        logic=jnp.asarray(logic[:t], dtype),
        kp=jnp.asarray(wb_traj.kp, dtype), kd=jnp.asarray(wb_traj.kd, dtype))


def surface_query(terrain: TerrainArrays, feet):
    """Active surface under each foot: the highest covering plane.

    feet: (C, 3).  Returns (p0 (C, 3), n (C, 3), z_surf (C,)) -- a plane
    point, the unit normal, and the plane height at each foot's xy.  Row 0
    of the terrain (flat ground) covers everywhere, so every foot always
    has a surface.  The TPU-native analog of PyBullet's collision query
    against the reference's stepstone boxes (src/simulate_solo.py:55-75).
    """
    dxy = feet[:, None, :2] - terrain.p0[None, :, :2]        # (C, S, 2)
    covers = (jnp.abs(dxy) <= terrain.half[None]).all(-1)    # (C, S)
    n = terrain.normal                                       # (S, 3)
    zs = (terrain.p0[None, :, 2]
          - (dxy[..., 0] * n[None, :, 0] + dxy[..., 1] * n[None, :, 1])
          / n[None, :, 2])                                   # (C, S)
    zs = jnp.where(covers, zs, -jnp.inf)
    idx = jnp.argmax(zs, axis=1)                             # (C,)
    rows = jnp.arange(feet.shape[0])
    # jnp.asarray: the terrain leaves are host numpy constants (see
    # Terrain.arrays), which cannot be fancy-indexed by traced indices
    return (jnp.asarray(terrain.p0)[idx], jnp.asarray(terrain.normal)[idx],
            zs[rows, idx])


def _contact_forces(settings: PhysicsSettings, feet, feet_vel, anchors,
                    dtype, terrain: TerrainArrays):
    """Penalty contact against the terrain's active surface planes:
    spring-damper normal force along each surface normal + anchored Coulomb
    friction in its tangent plane.

    Returns (forces (C, 3), new anchors (C, 3)).  Feet above their surface
    give zero force and re-anchor at their current position.  On flat
    ground (terrain row 0 only) this reduces exactly to the round-1
    z-spring / xy-anchor model.
    """
    p0, n, _ = surface_query(terrain, feet)
    pen = -jnp.sum((feet - p0) * n, axis=1)         # depth along the normal
    in_contact = pen > 0.0
    vn = jnp.sum(feet_vel * n, axis=1)
    fn = jnp.where(in_contact,
                   settings.ground_kp * pen - settings.ground_kd * vn, 0.0)
    fn = jnp.maximum(fn, 0.0)
    disp = feet - anchors
    disp_t = disp - n * jnp.sum(disp * n, axis=1, keepdims=True)
    vel_t = feet_vel - n * vn[:, None]
    ft_spring = (-settings.tangent_kp * disp_t
                 - settings.tangent_kd * vel_t)
    ft_norm = jnp.linalg.norm(ft_spring, axis=1) + 1e-12
    ft_max = settings.mu * fn
    scale = jnp.minimum(1.0, ft_max / ft_norm)
    ft = ft_spring * scale[:, None] * in_contact[:, None]
    # sliding or airborne feet re-anchor so the spring matches the applied
    # (clamped) force; sticking feet keep their anchor
    slid = (ft_norm > ft_max) | ~in_contact
    anchor_slide = feet + (ft + settings.tangent_kd
                           * vel_t) / settings.tangent_kp
    anchors_new = jnp.where(slid[:, None],
                            jnp.where(in_contact[:, None], anchor_slide,
                                      feet),
                            anchors)
    return ft + n * fn[:, None], anchors_new


def simulate_episode(spec: rb.RigidBodySpec, refs: ClosedLoopReferences,
                     x0: jnp.ndarray, push_force: jnp.ndarray,
                     push_start: jnp.ndarray, push_len: int,
                     settings: PhysicsSettings = PhysicsSettings(),
                     terrain: TerrainArrays | None = None):
    """One 1 kHz closed-loop episode; returns (h, feet, rpy) time series."""
    if terrain is None:
        terrain = FLAT.arrays(x0.dtype)
    dtype = x0.dtype
    nq, nv, nf = spec.nq, spec.nv, spec.n_feet
    t_total = refs.q_des.shape[0]
    ts = jnp.arange(t_total)
    push_active = ((ts >= push_start)
                   & (ts < push_start + push_len)).astype(dtype)
    f_push = jnp.zeros((3,), dtype).at[1].set(push_force[1])

    def control(q, v, t):
        """The reference torque law (src/simulate_solo.py:293-308)."""
        qj, vj = q[6:], v[6:]
        tau = (refs.tau_ff[t]
               + refs.kp * (refs.q_des[t] - qj)
               + refs.kd * (refs.qd_des[t] - vj))
        # centroidal LQR correction: delta f = K (h - h_des), mapped to
        # joints through the contact Jacobian of the active feet
        h = jnp.concatenate([rb.com_position(spec, q),
                             rb.centroidal_momentum(spec, q, v)])
        df = (refs.K_lqr[t] @ (h - refs.h_des[t])).reshape(nf, 3)
        df = df * refs.logic[t][:, None]
        jc = rb.contact_jacobian(spec, q)          # (C, 3, nv)
        dtau = -jnp.einsum("cij,ci->j", jc, df)[6:]
        return tau + dtau

    def step(carry, inputs):
        q, v, anchors = carry
        t, push_on = inputs
        tau = control(q, v, t) - settings.joint_damping * v[6:]
        feet = rb.foot_points(spec, q)
        jc = rb.contact_jacobian(spec, q).reshape(nf * 3, nv)
        feet_vel = (jc @ v).reshape(nf, 3)
        f_c, anchors = _contact_forces(settings, feet, feet_vel, anchors,
                                       dtype, terrain)
        m = rb.mass_matrix(spec, q)
        h_bias = rb.bias_forces(spec, q, v)
        gen = (jnp.concatenate([jnp.zeros((6,), dtype), tau])
               - h_bias + jc.T @ f_c.reshape(-1))
        # push: world force at the base origin through the base Jacobian
        j0 = rb.body_jacobians(spec, q)[0]
        wrench = jnp.concatenate([jnp.cross(q[0:3], f_push), f_push])
        gen = gen + push_on * (j0.T @ wrench)
        udot = jnp.linalg.solve(m, gen)
        q_new, v_new = rb.integrate_step(spec, q, v, udot, settings.dt)
        h = jnp.concatenate([rb.com_position(spec, q_new),
                             rb.centroidal_momentum(spec, q_new, v_new)])
        return (q_new, v_new, anchors), (h, feet, q_new[3:6])

    q0, v0 = x0[:nq], x0[nq:]
    anchors0 = rb.foot_points(spec, q0)
    (_, _, _), (h, feet, rpy) = jax.lax.scan(
        step, (q0, v0, anchors0), (ts, push_active))
    return h, feet, rpy


@highest_precision
def run_physics_monte_carlo(spec: rb.RigidBodySpec,
                            refs: ClosedLoopReferences, x0: jnp.ndarray,
                            key, n_sims: int,
                            settings: PhysicsSettings = PhysicsSettings(),
                            terrain: TerrainArrays | None = None,
                            ) -> PhysicsSimResult:
    """vmap `simulate_episode` over sampled pushes (the reference's
    nb_sims loop, src/simulate_solo.py:260)."""
    dtype = x0.dtype
    kf, kt = jax.random.split(key)
    forces = jax.random.multivariate_normal(
        kf, jnp.zeros(3, dtype), FORCE_COV * jnp.eye(3, dtype=dtype),
        shape=(n_sims,), dtype=dtype)
    push_len = int(round(PUSH_MS * 1e-3 / settings.dt))
    t_total = refs.q_des.shape[0]
    hi = max(t_total - push_len, 1)
    starts = jax.random.randint(kt, (n_sims,), 0, hi)
    h, feet, rpy = jax.vmap(
        lambda f, s: simulate_episode(spec, refs, x0, f, s, push_len,
                                      settings, terrain))(forces, starts)
    nominal_z = x0[2]
    fell = h[:, :, 2].min(axis=1) < 0.5 * nominal_z
    return PhysicsSimResult(h=h, feet=feet, base_rpy=rpy, fell=fell,
                            push_force=forces, push_start=starts)


def foot_slippage(result: PhysicsSimResult, refs: ClosedLoopReferences,
                  threshold: float = 1e-5,
                  terrain: TerrainArrays | None = None) -> jnp.ndarray:
    """(S,) cumulative stance-foot xy slip per episode (the reference's
    compute_norm_contact_slippage, src/utils.py:94-114) — measurable here
    because the plant's feet really slide when the friction cone
    saturates."""
    feet = result.feet                                  # (S, T, C, 3)
    d = jnp.linalg.norm(feet[:, 1:, :, :2] - feet[:, :-1, :, :2], axis=-1)
    stance = (refs.logic[1:] > 0).astype(d.dtype)       # (T-1, C)
    if terrain is None:
        terrain = FLAT.arrays(feet.dtype)
    surf = jax.vmap(jax.vmap(
        lambda f: surface_query(terrain, f)[2]))(feet)  # (S, T, C)
    below = feet[..., 2] < surf
    on_ground = below[:, 1:] & below[:, :-1]
    slip = d * stance[None] * on_ground.astype(d.dtype)
    return jnp.where(slip > threshold, slip, 0.0).sum(axis=(1, 2))


def foot_slippage_series(result: PhysicsSimResult,
                         refs: ClosedLoopReferences,
                         threshold: float = 1e-5,
                         terrain: TerrainArrays | None = None) -> jnp.ndarray:
    """(S, T-1) cumulative stance-foot slip over time per episode -- the
    time-resolved form behind the reference's cumulative-slippage figure
    (src/utils.py:304-385)."""
    feet = result.feet                                  # (S, T, C, 3)
    d = jnp.linalg.norm(feet[:, 1:, :, :2] - feet[:, :-1, :, :2], axis=-1)
    stance = (refs.logic[1:] > 0).astype(d.dtype)
    if terrain is None:
        terrain = FLAT.arrays(feet.dtype)
    surf = jax.vmap(jax.vmap(
        lambda f: surface_query(terrain, f)[2]))(feet)
    below = feet[..., 2] < surf
    on_ground = below[:, 1:] & below[:, :-1]
    slip = d * stance[None] * on_ground.astype(d.dtype)
    slip = jnp.where(slip > threshold, slip, 0.0).sum(axis=2)  # (S, T-1)
    return jnp.cumsum(slip, axis=1)


def tracking_cost(result: PhysicsSimResult, refs: ClosedLoopReferences,
                  weights=None) -> jnp.ndarray:
    """(S, T) cumulative centroidal tracking cost (the reference's
    plot_centroidal_tracking_cost statistic, src/utils.py:245-302)."""
    w = (jnp.ones((9,), result.h.dtype) if weights is None
         else jnp.asarray(weights, result.h.dtype))
    err = result.h - refs.h_des[None]
    return jnp.cumsum(jnp.einsum("stx,x,stx->st", err, w, err), axis=1)
