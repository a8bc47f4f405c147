"""Whole-body tracking layer: centroidal solution -> robot-ready joint
trajectories.

The reference brackets the centroidal SCP with Crocoddyl whole-body DDP
(src/whole_body_control.py): stage 3 tracks the SCP solution and exports
1 kHz joint positions/velocities/feedforward torques + gains
(interpolate_whole_body_solution :434-475, .dat export :478-488).  Here the
same deliverable is produced kinematically from the closed-form solo12 leg
model (models/kinematics.py) under the massless-leg approximation the
centroidal model already makes:

  base pose     <- interpolated CoM path (identity orientation)
  foot targets  <- contact placements (stance) / swing references (flight)
  joints        <- closed-form IK per leg per control knot (vmapped)
  velocities    <- central finite differences at dt_ctrl
  tau_ff        <- -J(q)' f  from the SCP contact forces (ZOH)
  gains         <- the reference simulator's per-gait PD gains
                   (src/simulate_solo.py:303-308)

Everything is one jitted program over (T, 4, 3) tensors.  A full
joint-space DDP refinement can plug into solver/ddp.py with these
trajectories as warm start.
"""
from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from centroidal_mpc_tpu.contact.plan import ContactPlan
from centroidal_mpc_tpu.contact.swing import SwingTrajectories
from centroidal_mpc_tpu.models import kinematics as kin
from centroidal_mpc_tpu.utils import struct

# Reference PD gains per gait (src/simulate_solo.py:303-330).
PD_GAINS = {"TROT": (4.0, 0.2), "PACE": (4.0, 0.2), "BOUND": (3.0, 0.2)}


class WholeBodyTrajectory(struct.PyTreeNode):
    """1 kHz whole-body references (the reference's
    wholeBody_interpolated_traj payload, run_motion.py:68-72)."""

    base_pos: jnp.ndarray   # (T, 3)
    q: jnp.ndarray          # (T, 3 n_legs) joint positions (leg-major,
                            # solo12: FR, FL, HR, HL x 3)
    qdot: jnp.ndarray       # (T, 3 n_legs)
    tau_ff: jnp.ndarray     # (T, 3 n_legs) feedforward torques
    feet: jnp.ndarray       # (T, n_legs, 3) world foot targets
    kp: jnp.ndarray         # scalar PD gains
    kd: jnp.ndarray


def track_centroidal_solution(plan: ContactPlan, swing: SwingTrajectories,
                              X: jnp.ndarray, U: jnp.ndarray,
                              dt_ctrl: float,
                              geom: kin.LegGeometry = kin.SOLO12_LEGS,
                              base_height_offset: float = 0.0,
                              ) -> WholeBodyTrajectory:
    """Map an SCP solution to whole-body joint trajectories at dt_ctrl."""
    n = plan.horizon
    n_legs = geom.n_legs
    n_inner = int(round(plan.dt / dt_ctrl))
    t_total = n * n_inner
    dtype = X.dtype

    # base path: linear interpolation of the CoM (identity orientation)
    frac = (jnp.arange(n_inner, dtype=dtype) / n_inner)
    com = X[:, :3]
    base = (com[:-1, None, :]
            + frac[None, :, None] * (com[1:, None, :] - com[:-1, None, :]))
    base = base.reshape(t_total, 3)
    base = base.at[:, 2].add(base_height_offset)

    # world foot targets: stance -> placement, swing -> swing reference
    logic_ctrl = jnp.repeat(plan.schedule.logic, n_inner, axis=0)   # (T, C)
    pos_ctrl = jnp.repeat(plan.schedule.position, n_inner, axis=0)  # (T,C,3)
    swing_pos = jnp.asarray(swing.pos, dtype).transpose(2, 0, 1)[:t_total]
    feet_world = jnp.where(logic_ctrl[:, :, None] > 0, pos_ctrl, swing_pos)

    # IK per control knot (vmapped over time)
    feet_base = feet_world - base[:, None, :]
    q_legs = jax.vmap(kin.ik_all_legs, in_axes=(0, None))(feet_base, geom)

    # velocities: central differences
    qd = (jnp.roll(q_legs, -1, axis=0) - jnp.roll(q_legs, 1, axis=0)) / (
        2 * dt_ctrl)
    qd = qd.at[0].set((q_legs[1] - q_legs[0]) / dt_ctrl)
    qd = qd.at[-1].set((q_legs[-1] - q_legs[-2]) / dt_ctrl)

    # feedforward torques from the planned contact forces (ZOH)
    forces_ctrl = jnp.repeat(U.reshape(n, n_legs, 3), n_inner, axis=0)
    forces_ctrl = forces_ctrl * logic_ctrl[:, :, None]
    tau = jax.vmap(kin.feet_contact_torques, in_axes=(0, 0, None))(
        q_legs, forces_ctrl, geom)

    kp, kd = PD_GAINS.get(plan.gait.gait_type, (4.0, 0.2))
    nj = 3 * n_legs
    return WholeBodyTrajectory(
        base_pos=base, q=q_legs.reshape(t_total, nj),
        qdot=qd.reshape(t_total, nj), tau_ff=tau.reshape(t_total, nj),
        feet=feet_world, kp=jnp.asarray(kp, dtype),
        kd=jnp.asarray(kd, dtype))


def export_robot_dat(traj: WholeBodyTrajectory, out_dir) -> Dict[str, str]:
    """Write the robot-ready .dat files the reference exports
    (src/whole_body_control.py:478-488): one row per control knot,
    index followed by the 12 joint values."""
    from pathlib import Path
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = {}
    for name, arr in [("quadruped_positions", traj.q),
                      ("quadruped_velocities", traj.qdot),
                      ("quadruped_feedforward_torque", traj.tau_ff)]:
        a = np.asarray(arr)
        data = np.hstack([np.arange(a.shape[0])[:, None], a])
        path = out / f"{name}.dat"
        np.savetxt(path, data, fmt="%.18e")
        files[name] = str(path)
    return files
