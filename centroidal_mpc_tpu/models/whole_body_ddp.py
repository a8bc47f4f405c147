"""Joint-space whole-body DDP on the rigid-body engine.

This is the full-dynamics counterpart of the reference's Crocoddyl stages
(reference src/whole_body_control.py): a trajectory optimization over the
floating-base rigid-body model with contact-constrained forward dynamics,
solved with the jitted iLQR in solver/ddp.py.  It covers both reference
modes:

  * ``TRACK_CENTROIDAL=False`` (stage 1, reference
    src/whole_body_control.py:168-291 + run_motion.py:16-30): track a
    CoM-progress heuristic and produce the dynamically-consistent
    whole-body warm start handed to the centroidal SCP
    (``wholeBody_to_centroidal_traj.npz``).
  * ``TRACK_CENTROIDAL=True`` (stage 3, :305-344 + run_motion.py:49-72):
    track the SCP solution (CoM + centroidal momentum + contact forces)
    and produce robot-ready joint trajectories.

TPU-native design notes (vs the reference's Crocoddyl/Pinocchio C++):

  * one action model for the whole horizon — gait phases are data (a
    per-knot contact mask gathered inside the jitted dynamics), not a
    Python list of per-phase C++ action models, so shapes stay static and
    the whole solve is a single XLA program;
  * dynamics = the dense contact-KKT solve of models/rigid_body.py
    (Crocoddyl's DifferentialActionModelContactFwdDynamics,
    reference src/whole_body_control.py:360-382) + semi-implicit Euler;
  * costs are least-squares residual models (as in Crocoddyl) solved by
    Gauss-Newton iLQR (solver/ddp.py:solve_ilqr_residual): stage
    derivatives come from ONE fused vmapped jacfwd per knot (dynamics +
    residuals share the KKT solve), the Riccati sweep is a `lax.scan`,
    and the line search rolls out all step sizes in parallel;
  * targets AND weights are device arguments of one jitted solve, so a
    single compiled program (persistent-cache stable) serves every gait,
    reference trajectory, and weight configuration;
  * costs mirror the reference's cost stack: swing-foot tracking
    (:360-382), CoM tracking (:312-318), centroidal-momentum tracking
    (:319-327), force regularization toward the SCP forces (:328-344),
    state/control regularization (:46-152).

State x = [q (6+nj), v (6+nj)]; control = joint torques (nj,).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from centroidal_mpc_tpu.contact.plan import ContactPlan
from centroidal_mpc_tpu.contact.swing import SwingTrajectories
from centroidal_mpc_tpu.models import kinematics as kin
from centroidal_mpc_tpu.models import rigid_body as rb
from centroidal_mpc_tpu.solver.ddp import (DdpSettings, DdpSolution,
                                           solve_ilqr_residual)
from centroidal_mpc_tpu.utils import struct
from centroidal_mpc_tpu.utils.precision import highest_precision


@dataclasses.dataclass(frozen=True)
class WholeBodyWeights:
    """Cost weights (roles mirror the reference's whole-body task weights,
    reference src/whole_body_control.py:46-152 and config
    conf_solo12_trot.py:88-90)."""

    foot: float = 1e6          # swing/stance foot position tracking
    com: float = 1e4           # CoM tracking
    lin_momentum: float = 1e1  # centroidal linear momentum tracking
    ang_momentum: float = 1e1  # centroidal angular momentum tracking
    force: float = 1e-2        # contact-force tracking toward the SCP plan
                               # (stage 1: toward weight distribution —
                               # regularizes touchdown force transients)
    posture: float = 1e-1      # joint posture regularization
    base_rpy: float = 1e1      # keep the base level
    velocity: float = 1e-1     # generalized-velocity regularization
    torque: float = 1e-3       # control regularization
    terminal_scale: float = 10.0


class WholeBodyTargets(struct.PyTreeNode):
    """Per-knot references at the planning rate (device pytree)."""

    contact_mask: jnp.ndarray   # (N, C)
    contact_ref: jnp.ndarray    # (N, C, 3) stance anchor points
    foot_target: jnp.ndarray    # (N, C, 3) world foot references
    com_target: jnp.ndarray     # (N+1, 3)
    mom_target: jnp.ndarray     # (N+1, 6) [linear, angular]
    force_target: jnp.ndarray   # (N, C, 3) SCP contact forces (zeros in
                                # stage-1 mode)


class WholeBodySolution(struct.PyTreeNode):
    """Solved whole-body trajectory + extracted per-knot data (the
    reference's get_solution_trajectories payload,
    src/whole_body_control.py:384-432)."""

    Q: jnp.ndarray         # (N+1, nq) configurations
    V: jnp.ndarray         # (N+1, nv) generalized velocities
    TAU: jnp.ndarray       # (N, nj) joint torques
    forces: jnp.ndarray    # (N, C, 3) contact forces from the KKT dynamics
    com: jnp.ndarray       # (N+1, 3)
    momentum: jnp.ndarray  # (N+1, 6) centroidal momentum [lin, ang]
    feet: jnp.ndarray      # (N+1, C, 3) world foot positions
    K: jnp.ndarray         # (N, nj, 2 nv) iLQR feedback gains
    cost: jnp.ndarray
    iterations: jnp.ndarray

    def centroidal_states(self) -> jnp.ndarray:
        """(N+1, 9) [com, lin momentum, ang momentum] — the
        wholeBody_to_centroidal_traj payload (reference
        run_motion.py:30, src/whole_body_control.py:396-399)."""
        return jnp.concatenate([self.com, self.momentum], axis=1)


def build_targets(plan: ContactPlan, swing: SwingTrajectories,
                  dt_ctrl: float,
                  X_centroidal: Optional[jnp.ndarray] = None,
                  U_centroidal: Optional[jnp.ndarray] = None,
                  dtype=jnp.float64) -> WholeBodyTargets:
    """Assemble per-knot references at the planning rate.

    Stage-3 mode (``TRACK_CENTROIDAL=True``): pass the SCP solution
    (X_centroidal (N+1, 9), U_centroidal (N, 3C)) — CoM/momentum/force
    targets come from it (reference src/whole_body_control.py:305-344).
    Stage-1 mode: omit them — CoM target is the contact-centroid progress
    heuristic (reference createSwingFootModel's comTask, :360-382) and
    momentum/force targets are zero.
    """
    logic = np.asarray(plan.schedule.logic, np.float64)        # (N, C)
    pos = np.asarray(plan.schedule.position, np.float64)       # (N, C, 3)
    n, n_c = logic.shape
    n_inner = int(round(plan.dt / dt_ctrl))

    # foot targets: stance -> placement, swing -> swing reference sampled
    # at the planning knots
    swing_pos = np.asarray(swing.pos).transpose(2, 0, 1)       # (T, C, 3)
    swing_knots = swing_pos[::n_inner][:n]
    foot_target = np.where(logic[:, :, None] > 0, pos, swing_knots)

    if X_centroidal is not None:
        Xc = np.asarray(X_centroidal, np.float64)
        com_target = Xc[:, 0:3]
        mom_target = Xc[:, 3:9]
    else:
        # contact-centroid CoM progress (solver/warm_start.py semantics)
        n_active = np.maximum(logic.sum(axis=1), 1.0)
        centroid = (pos * logic[:, :, None]).sum(axis=1) / n_active[:, None]
        com_target = np.zeros((n + 1, 3))
        com_target[:n, 0:2] = centroid[:, 0:2]
        com_target[:n, 2] = plan.robot.com_height + centroid[:, 2]
        com_target[n] = com_target[n - 1]
        mom_target = np.zeros((n + 1, 6))
    if U_centroidal is not None:
        u_arr = np.asarray(U_centroidal, np.float64)
        nuc = u_arr.shape[1] // n_c
        u_arr = u_arr.reshape(n, n_c, nuc)
        # wrench6 controls are (cop_x, cop_y, fx, fy, fz, tau_z); the
        # tracked force target is the linear force (reference
        # src/centroidal_model.py:104-119)
        force_target = u_arr[:, :, 2:5] if nuc == 6 else u_arr
    else:
        # weight distribution over active feet (the reference's own control
        # warm-start heuristic, centroidal_model.py:176-183) — tracking
        # toward it bounds the bilateral-KKT force transients at touchdown
        force_target = np.zeros((n, n_c, 3))
        fz = plan.robot.mass * 9.81 / np.maximum(logic.sum(axis=1), 1.0)
        force_target[:, :, 2] = fz[:, None] * logic

    return WholeBodyTargets(
        contact_mask=jnp.asarray(logic, dtype),
        contact_ref=jnp.asarray(pos, dtype),
        foot_target=jnp.asarray(foot_target, dtype),
        com_target=jnp.asarray(com_target, dtype),
        mom_target=jnp.asarray(mom_target, dtype),
        force_target=jnp.asarray(force_target, dtype))


def _com_matched_config(spec: rb.RigidBodySpec, com_target: jnp.ndarray,
                        feet: jnp.ndarray,
                        geom: kin.LegGeometry) -> jnp.ndarray:
    """Configuration with feet at `feet` (IK) and the *rigid-body* CoM (not
    the base origin) at `com_target`: the CoM translates 1:1 with the base
    up to the IK-induced joint change, so a few fixed-point steps converge.
    """
    dtype = com_target.dtype

    def assemble(base_pos):
        q_legs = kin.ik_all_legs(feet - base_pos[None, :], geom)
        return jnp.concatenate([base_pos, jnp.zeros((3,), dtype),
                                q_legs.reshape(-1)])

    b = com_target
    q = assemble(b)
    for _ in range(6):
        b = b + (com_target - rb.com_position(spec, q))
        q = assemble(b)
    return q


def leg_geometry_from_spec(spec: rb.RigidBodySpec
                           ) -> Optional[kin.LegGeometry]:
    """Recover a closed-form LegGeometry from a RigidBodySpec built in the
    3-DoF point-leg pattern (HAA about x at the hip, HFE about y at the
    lateral offset, KFE about y at the knee — solo12_spec / bolt_spec).
    Returns None for any other morphology (callers then fall back to the
    numeric IK path)."""
    if spec.contact_dim != 3 or spec.n_joints != 3 * spec.n_feet:
        return None
    hips, sides = [], []
    y_off = l_upper = l_lower = None
    for f, fb in enumerate(spec.foot_body):
        haa, hfe, kfe = fb - 2, fb - 1, fb
        if (spec.parent[haa] != 0 or spec.parent[hfe] != haa
                or spec.parent[kfe] != hfe):
            return None
        if not (np.allclose(spec.joint_axis[haa], [1, 0, 0])
                and np.allclose(spec.joint_axis[hfe], [0, 1, 0])
                and np.allclose(spec.joint_axis[kfe], [0, 1, 0])):
            return None
        hips.append(tuple(spec.joint_pos[haa]))
        off = spec.joint_pos[hfe]
        side = np.sign(off[1]) if abs(off[1]) > 1e-12 else np.sign(
            spec.joint_pos[haa][1])
        sides.append(float(side if side != 0 else 1.0))
        y_off = abs(float(off[1]))
        l_upper = -float(spec.joint_pos[kfe][2])
        l_lower = -float(spec.foot_pos[f][2])
    return kin.LegGeometry(y_off=y_off, l_upper=l_upper, l_lower=l_lower,
                           hips=tuple(hips), sides=tuple(sides))


def _numeric_config(spec: rb.RigidBodySpec, com_target: jnp.ndarray,
                    foot_targets: jnp.ndarray, q0: jnp.ndarray,
                    iters: int = 25) -> jnp.ndarray:
    """Whole-body IK by damped least squares (any morphology; the generic
    path for robots without closed-form legs, e.g. the talos 6-DoF legs).

    Residual: foot positions -> targets, foot orientations -> flat
    (contact_dim=6 only), CoM -> com_target, base orientation -> level.
    """
    dtype = com_target.dtype

    def residual(q):
        feet = rb.foot_points(spec, q)
        parts = [(feet - foot_targets).reshape(-1),
                 rb.com_position(spec, q) - com_target,
                 0.3 * q[3:6]]
        if spec.contact_dim == 6:
            Rf = rb.foot_orientations(spec, q)
            rot = 0.5 * jnp.stack(
                [Rf[:, 2, 1] - Rf[:, 1, 2],
                 Rf[:, 0, 2] - Rf[:, 2, 0],
                 Rf[:, 1, 0] - Rf[:, 0, 1]], axis=1)
            parts.insert(1, rot.reshape(-1))
        return jnp.concatenate(parts)

    def step(q, _):
        r = residual(q)
        J = jax.jacfwd(residual)(q)
        dq = jnp.linalg.solve(
            J.T @ J + 1e-8 * jnp.eye(spec.nq, dtype=dtype), J.T @ r)
        return q - dq, None

    q, _ = jax.lax.scan(step, q0, None, length=iters)
    return q


def default_joint_guess(spec: rb.RigidBodySpec) -> jnp.ndarray:
    """(nj,) numeric-IK seed: a small bend on every pitch (y-axis) joint,
    alternating sign down each chain so knees flex rather than lock at the
    straight-leg singularity."""
    qj = np.zeros(spec.n_joints)
    for i in range(1, spec.n_bodies):
        if abs(spec.joint_axis[i][1]) > 0.5:
            depth = 0
            j = i
            while spec.parent[j] != 0:
                if abs(spec.joint_axis[j][1]) > 0.5:
                    depth += 1
                j = spec.parent[j]
            qj[i - 1] = 0.3 if depth % 2 else -0.15
    return jnp.asarray(qj)


def standing_state(spec: rb.RigidBodySpec, targets: WholeBodyTargets,
                   geom: Optional[kin.LegGeometry] = None,
                   q_guess: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Initial whole-body state: joints from IK of the initial foot
    placements (closed-form for 3-DoF point legs, damped-least-squares
    otherwise), CoM at the initial CoM target, zero velocity."""
    geom = geom or leg_geometry_from_spec(spec)
    if geom is not None:
        q = _com_matched_config(spec, targets.com_target[0],
                                targets.foot_target[0], geom)
    else:
        dtype = targets.com_target.dtype
        if q_guess is None:
            q_guess = jnp.concatenate([
                targets.com_target[0], jnp.zeros((3,), dtype),
                default_joint_guess(spec).astype(dtype)])
        q = _numeric_config(spec, targets.com_target[0],
                            targets.foot_target[0], q_guess)
    return jnp.concatenate([q, jnp.zeros((spec.nv,), q.dtype)])


def quasi_static_torques(spec: rb.RigidBodySpec, q: jnp.ndarray,
                         mask: jnp.ndarray) -> jnp.ndarray:
    """(nj,) exact quasi-static joint torques.

    Solves the static base equilibrium exactly: the floating-base rows of
    M udot = S'tau - h + Jc'f have no torque, so at udot = 0 the contact
    forces must satisfy (Jc'f)[0:6] = h[0:6]; the minimum-norm active-feet
    solution comes from the pseudoinverse, then the joint rows give
    tau = (h - Jc'f)[6:] (inverse dynamics at zero velocity/acceleration).
    """
    dtype = q.dtype
    cd = spec.contact_dim
    h = rb.bias_forces(spec, q, jnp.zeros((spec.nv,), dtype))
    jc = rb.contact_frame_jacobian(spec, q).reshape(spec.n_feet * cd,
                                                    spec.nv)
    m3 = jnp.repeat(mask.astype(dtype), cd)
    a = (jc.T[0:6] * m3[None, :])                  # (6, cd*C) base rows
    f = a.T @ jnp.linalg.solve(a @ a.T + 1e-10 * jnp.eye(6, dtype=dtype),
                               h[0:6])
    return (h - jc.T @ (m3 * f))[6:]


def gravity_torque_warm_start(spec: rb.RigidBodySpec,
                              targets: WholeBodyTargets,
                              geom: Optional[kin.LegGeometry] = None,
                              q_guess: Optional[jnp.ndarray] = None,
                              ) -> jnp.ndarray:
    """(N, nj) torque warm start: per-knot CoM-matched IK posture + exact
    quasi-static inverse dynamics (the reference warm-starts FDDP from
    quasi-static postures, src/whole_body_control.py:168-201)."""
    mask = targets.contact_mask                          # (N, C)
    n = mask.shape[0]
    geom = geom or leg_geometry_from_spec(spec)
    if geom is not None:
        qs = jax.vmap(lambda c, f: _com_matched_config(spec, c, f, geom))(
            targets.com_target[:n], targets.foot_target)
    else:
        x0 = standing_state(spec, targets, q_guess=q_guess)
        qs = jax.vmap(lambda c, f: _numeric_config(
            spec, c, f, x0[:spec.nq], iters=10))(
                targets.com_target[:n], targets.foot_target)
    return jax.vmap(lambda q, m: quasi_static_torques(spec, q, m))(qs, mask)


def _weights_vector(w: WholeBodyWeights, dtype) -> jnp.ndarray:
    """Pack weights as a DYNAMIC argument so one compiled solver serves
    every weight configuration (stage-1 and stage-3 modes share the XLA
    program and the persistent compilation cache)."""
    return jnp.asarray([w.foot, w.com, w.lin_momentum, w.ang_momentum,
                        w.force, w.posture, w.base_rpy, w.velocity,
                        w.torque, w.terminal_scale], dtype)


@functools.partial(jax.jit,
                   static_argnames=("spec", "dt", "settings", "contact"))
def _solve_whole_body(spec: rb.RigidBodySpec, targets: WholeBodyTargets,
                      w: jnp.ndarray, x0: jnp.ndarray, U0: jnp.ndarray,
                      dt: float, settings: DdpSettings,
                      contact: rb.ContactDynamicsSettings,
                      X_traj=None) -> WholeBodySolution:
    n, n_c = targets.contact_mask.shape
    dtype = targets.com_target.dtype
    q_ref = x0[:spec.nq]
    sdt = jnp.sqrt(jnp.asarray(dt, dtype))

    def split(x):
        return x[:spec.nq], x[spec.nq:]

    def dynamics(x, u, k):
        q, v = split(x)
        udot, _ = rb.constrained_forward_dynamics(
            spec, q, v, u, targets.contact_mask[k], targets.contact_ref[k],
            contact)
        q_next, v_next = rb.integrate_step(spec, q, v, udot, dt)
        return jnp.concatenate([q_next, v_next])

    def state_residual(q, v, k):
        """Weighted tracking residuals (the reference's residual-model cost
        stack, src/whole_body_control.py:46-152 and :305-344)."""
        feet = rb.foot_points(spec, q)
        mom = rb.centroidal_momentum(spec, q, v)
        return jnp.concatenate([
            jnp.sqrt(w[0]) * (feet - targets.foot_target[k]).reshape(-1),
            jnp.sqrt(w[1]) * (rb.com_position(spec, q)
                              - targets.com_target[k]),
            jnp.sqrt(w[2]) * (mom[0:3] - targets.mom_target[k, 0:3]),
            jnp.sqrt(w[3]) * (mom[3:6] - targets.mom_target[k, 3:6]),
            jnp.sqrt(w[5]) * (q[6:] - q_ref[6:]),
            jnp.sqrt(w[6]) * q[3:6],
            jnp.sqrt(w[7]) * v,
        ])

    def stage_residual(x, u, k):
        q, v = split(x)
        _, f = rb.constrained_forward_dynamics(
            spec, q, v, u, targets.contact_mask[k], targets.contact_ref[k],
            contact)
        # flat feet (contact_dim=6) carry [force(3), torque(3)]; the
        # tracked target is the linear contact force
        e_f = ((f[:, :3] - targets.force_target[k])
               * targets.contact_mask[k][:, None]).reshape(-1)
        return sdt * jnp.concatenate([
            state_residual(q, v, k),
            jnp.sqrt(w[8]) * u,
            jnp.sqrt(w[4]) * e_f,
        ])

    def terminal_residual(x):
        q, v = split(x)
        return sdt * jnp.sqrt(w[9]) * state_residual(q, v, n)

    sol: DdpSolution = solve_ilqr_residual(
        dynamics, stage_residual, terminal_residual, x0, U0, settings,
        X_init=X_traj)

    # extraction (reference get_solution_trajectories,
    # src/whole_body_control.py:384-432)
    Q, V = sol.X[:, :spec.nq], sol.X[:, spec.nq:]
    ks = jnp.arange(n)

    def knot_forces(q, v, u, k):
        _, f = rb.constrained_forward_dynamics(
            spec, q, v, u, targets.contact_mask[k], targets.contact_ref[k],
            contact)
        return f * targets.contact_mask[k][:, None]

    forces = jax.vmap(knot_forces)(Q[:-1], V[:-1], sol.U, ks)
    com = jax.vmap(lambda q: rb.com_position(spec, q))(Q)
    momentum = jax.vmap(lambda q, v: rb.centroidal_momentum(spec, q, v))(Q, V)
    feet = jax.vmap(lambda q: rb.foot_points(spec, q))(Q)
    return WholeBodySolution(Q=Q, V=V, TAU=sol.U, forces=forces, com=com,
                             momentum=momentum, feet=feet, K=sol.K,
                             cost=sol.cost, iterations=sol.iterations)


def kinematic_state_warm_start(spec: rb.RigidBodySpec,
                               targets: WholeBodyTargets,
                               geom: Optional[kin.LegGeometry] = None,
                               ) -> jnp.ndarray:
    """(N+1, nx) state-trajectory warm start: per-knot CoM-matched IK
    postures (zero velocity) -- the reference's xs warm start handed to
    SolverFDDP (run_motion.py:24-27; quasi-static postures at
    src/whole_body_control.py:168-201).  Feed as solve_whole_body_ddp's
    X_traj to enable the FDDP gap-handling mode; the trajectory is NOT a
    rollout, which is exactly what FDDP tolerates and pure iLQR cannot."""
    mask = targets.contact_mask
    n = mask.shape[0]
    geom = geom or leg_geometry_from_spec(spec)
    foot_pad = jnp.concatenate([targets.foot_target,
                                targets.foot_target[-1:]], axis=0)
    if geom is not None:
        qs = jax.vmap(lambda c, f: _com_matched_config(spec, c, f, geom))(
            targets.com_target, foot_pad)
    else:
        x0 = standing_state(spec, targets)
        qs = jax.vmap(lambda c, f: _numeric_config(
            spec, c, f, x0[:spec.nq], iters=10))(
                targets.com_target, foot_pad)
    vs = jnp.zeros((n + 1, spec.nv), qs.dtype)
    return jnp.concatenate([qs, vs], axis=1)


@highest_precision
def solve_whole_body_ddp(
        spec: rb.RigidBodySpec,
        targets: WholeBodyTargets,
        dt: float,
        x0: Optional[jnp.ndarray] = None,
        U0: Optional[jnp.ndarray] = None,
        weights: WholeBodyWeights = WholeBodyWeights(),
        settings: DdpSettings = DdpSettings(iterations=60, exact_quu=True),
        contact: rb.ContactDynamicsSettings = rb.ContactDynamicsSettings(),
        X_traj: Optional[jnp.ndarray] = None,
) -> WholeBodySolution:
    """Solve the whole-body OCP with Gauss-Newton iLQR over the contact-KKT
    dynamics.

    One jitted program per (robot, horizon-shape, solver settings): the
    per-knot contact mode, the tracking targets, and the cost weights all
    enter as device arguments (gathered data), so a single compiled solver
    serves every gait, target trajectory, and weight configuration — and
    the persistent compilation cache makes repeat sessions instant.
    """
    dtype = targets.com_target.dtype
    if x0 is None:
        x0 = standing_state(spec, targets)
    if U0 is None:
        U0 = gravity_torque_warm_start(spec, targets)
    return _solve_whole_body(spec, targets, _weights_vector(weights, dtype),
                             x0, U0, float(dt), settings, contact,
                             X_traj=X_traj)


def interpolate_whole_body_solution(sol: WholeBodySolution, dt: float,
                                    dt_ctrl: float):
    """Upsample to the control rate (reference
    interpolate_whole_body_solution, src/whole_body_control.py:434-475:
    linear on q/qdot, ZOH on torques/forces/gains).  Returns a dict with
    the wholeBody_interpolated_traj payload (run_motion.py:68-72)."""
    from centroidal_mpc_tpu.utils.interpolation import (
        interpolate_linear, interpolate_zero_order)
    n_inner = int(round(dt / dt_ctrl))
    q = np.asarray(sol.Q)
    v = np.asarray(sol.V)
    tau = np.asarray(sol.TAU)
    n, n_c, cd = sol.forces.shape
    return {
        "q": interpolate_linear(q, n_inner),
        "qdot": interpolate_linear(v, n_inner),
        "tau_ff": interpolate_zero_order(tau, n_inner),
        "forces": interpolate_zero_order(
            np.asarray(sol.forces).reshape(n, n_c * cd), n_inner),
        "gains": interpolate_zero_order(
            np.asarray(sol.K).reshape(sol.K.shape[0], -1), n_inner),
    }
