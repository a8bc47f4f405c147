"""Contact-plan expansion: gait spec -> dense per-knot contact schedule.

The reference builds a dict of per-foot ``Debris`` lists (SE3 pose + ACTIVE
flag per knot, src/contact_plan.py:40-48, 112-264) and then re-packs them
into dense jnp arrays inside the model constructor
(src/centroidal_model.py:127-156).  Here the dense arrays ARE the contact
plan: a ``ContactSchedule`` pytree of static-shaped arrays

    logic:       (N, C)        1.0 where foot c is planted at knot k
    position:    (N, C, 3)     world-frame contact point (zeros when inactive)
    orientation: (N, C, 3, 3)  contact frame rotation (zeros when inactive,
                               matching the reference's jnp.zeros((3,3)) at
                               src/centroidal_model.py:144)

which the TPU compute path consumes directly (gather-free, static shapes).
Host-side phase metadata (``Phase`` records) is kept separately for
swing-foot trajectory generation and plotting.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from centroidal_mpc_tpu.config.gaits import DOUBLE_SUPPORT, SWING_FEET, GaitSpec
from centroidal_mpc_tpu.config.robots import RobotSpec
from centroidal_mpc_tpu.utils import struct


class ContactSchedule(struct.PyTreeNode):
    """Dense per-knot contact data; device-resident pytree."""

    logic: jnp.ndarray        # (N, C) float
    position: jnp.ndarray     # (N, C, 3) float
    orientation: jnp.ndarray  # (N, C, 3, 3) float

    @property
    def horizon(self) -> int:
        return self.logic.shape[0]

    @property
    def n_contacts(self) -> int:
        return self.logic.shape[1]

    def positions_flat(self) -> jnp.ndarray:
        """(N, 3C) view matching the reference's flattened contacts_position
        (src/centroidal_model.py:151)."""
        n, c, _ = self.position.shape
        return self.position.reshape(n, c * 3)


@dataclasses.dataclass(frozen=True)
class Phase:
    """Host-side phase record (the reference's per-phase Debris group)."""

    name: str
    t_start: float
    t_end: float
    knot_start: int
    knot_end: int               # exclusive
    active: np.ndarray          # (C,) bool
    positions: np.ndarray       # (C, 3); rows of swinging feet hold the
                                # placement the foot left (for swing interp)
    rotations: Optional[np.ndarray] = None  # (C, 3, 3) contact frames;
                                # None means identity (flat ground)


@dataclasses.dataclass(frozen=True)
class ContactPlan:
    """Full host-side expansion of a gait: phases + dense schedule."""

    robot: RobotSpec
    gait: GaitSpec
    dt: float
    phases: List[Phase]
    schedule: ContactSchedule

    @property
    def horizon(self) -> int:
        return self.schedule.horizon


def _foot_indices(robot: RobotSpec, swing_names: Sequence[str]) -> List[int]:
    return [i for i, name in enumerate(robot.foot_names) if name in swing_names]


def build_contact_plan(
    robot: RobotSpec,
    gait: GaitSpec,
    dt: float,
    initial_foot_positions: Optional[np.ndarray] = None,
    dtype=jnp.float32,
    terrain=None,
) -> ContactPlan:
    """Expand a gait into phases and a dense contact schedule.

    Reference semantics (src/contact_plan.py:112-264):
      * every phase lasts supportKnots*dt (double support) or stepKnots*dt
        (stepping);
      * during a stepping phase the named feet swing (inactive) while the
        others keep their current placements;
      * after a stepping phase the swung feet have advanced forward by
        stepLength along +x;
      * contact frames are identity on flat ground (axis=[-1,0], angle=0 in
        the reference).

    With a `terrain` (contact/terrain.Terrain), every foothold is snapped
    onto the highest covering surface: its z comes from the surface plane
    and its contact frame from the surface rotation -- the reference's
    rotated-`Debris` pathway (src/contact_plan.py:8-37, fill_debris_list
    :305-328), which feeds the solver's rotated friction pyramids.
    """
    if initial_foot_positions is None:
        foot_pos = robot.stance_positions_array().copy()
    else:
        foot_pos = np.array(initial_foot_positions, dtype=np.float64)
    n_c = robot.n_contacts
    biped = n_c == 2
    foot_rot = np.tile(np.eye(3), (n_c, 1, 1))

    def snap(c: int) -> None:
        if terrain is not None:
            z, r = terrain.surface_at(foot_pos[c, 0], foot_pos[c, 1])
            foot_pos[c, 2] = z
            foot_rot[c] = r

    for c in range(n_c):
        snap(c)

    phases: List[Phase] = []
    t_start = 0.0
    knot = 0
    for phase_name in gait.flat_phases(biped):
        knots = gait.phase_knots(phase_name)
        t_end = t_start + knots * dt
        swing = _foot_indices(robot, SWING_FEET[phase_name])
        active = np.ones(n_c, dtype=bool)
        active[swing] = False
        phases.append(
            Phase(
                name=phase_name,
                t_start=t_start,
                t_end=t_end,
                knot_start=knot,
                knot_end=knot + knots,
                active=active,
                positions=foot_pos.copy(),
                rotations=foot_rot.copy(),
            )
        )
        # Feet that swing land stepLength ahead (reference
        # src/contact_plan.py:188-189 etc. -- advancement happens after the
        # phase is emitted, so the *next* phase sees the stepped position).
        for c in swing:
            foot_pos[c, 0] += gait.step_length
            snap(c)
        t_start = t_end
        knot += knots

    n = knot
    logic = np.zeros((n, n_c))
    position = np.zeros((n, n_c, 3))
    orientation = np.zeros((n, n_c, 3, 3))
    for ph in phases:
        sl = slice(ph.knot_start, ph.knot_end)
        logic[sl] = ph.active.astype(np.float64)
        for c in range(n_c):
            if ph.active[c]:
                position[sl, c] = ph.positions[c]
                orientation[sl, c] = ph.rotations[c]

    # Host-side (numpy) leaves, deliberately: the schedule is closed over
    # by jitted solvers, where numpy constants embed into the program as
    # literals.  A device array closed over the same way has to be copied
    # back to the host at every jit lowering to be embedded, and building
    # a problem would put work on the device before any solve starts.
    schedule = ContactSchedule(
        logic=np.asarray(logic, dtype=dtype),
        position=np.asarray(position, dtype=dtype),
        orientation=np.asarray(orientation, dtype=dtype),
    )
    return ContactPlan(robot=robot, gait=gait, dt=dt, phases=phases,
                       schedule=schedule)


def interpolate_contact_positions(plan: ContactPlan, dt_ctrl: float) -> np.ndarray:
    """Per-control-knot contact positions, zero while swinging.

    Reference: src/contact_plan.py:50-68 (interpolate_contact_trajectory):
    each planning knot's placement is repeated dt/dt_ctrl times over the
    first N-1 knots.
    """
    n = plan.horizon
    n_inner = int(round(plan.dt / dt_ctrl))
    pos = np.asarray(plan.schedule.position)
    logic = np.asarray(plan.schedule.logic)
    gated = pos * logic[..., None]
    return np.repeat(gated[: n - 1], n_inner, axis=0)  # ((N-1)*inner, C, 3)
