"""Floating-base rigid-body dynamics in JAX (the Pinocchio/Crocoddyl role).

The reference's whole-body layer runs Crocoddyl's contact forward dynamics
on a Pinocchio model loaded from URDF (reference src/whole_body_control.py:
ContactModel3D + DifferentialActionModelContactFwdDynamics at :360-382).
This module is the accelerator-native equivalent: a small, dense, fully
differentiable rigid-body engine over a fixed-topology kinematic tree,
built for XLA —

  * everything is dense (nv, nv) / (6, nv) batched matmuls that vmap
    over knots/batches; no sparse branch-per-joint code paths;
  * body Jacobians are assembled at the WORLD ORIGIN so the mass matrix is
    one einsum  M = sum_i J_i' I_i J_i  over bodies (O(nb) batched
    matmuls instead of a Featherstone recursion — at nv=18 the recursion's
    asymptotic win is irrelevant and the einsum vectorizes better);
  * bias forces use the d'Alembert form  h = sum_i J_i'(I_i Jdot_i u +
    v_i x* I_i v_i - f_grav,i)  with the single Jdot_i u term taken by one
    `jax.jvp` through the Jacobian assembly — no hand-derived Coriolis
    recursion to get wrong;
  * contact-constrained forward dynamics solves the same KKT system as
    Crocoddyl (M udot - Jc' f = tau - h;  Jc udot = -gamma - baumgarte)
    with inactive contacts masked to lambda = 0 rows, keeping static
    shapes for jit/vmap over phase changes.

State convention: configuration q = [base position (3, world), base
orientation (3, xyz roll-pitch-yaw of R = Rz Ry Rx), joint angles (nj)];
generalized velocity u = [omega_base (3, body frame), v_base (3, body
frame), joint rates (nj)] (Featherstone angular-first order).  The mass
matrix therefore depends only on joint angles and the bias only enters
base pose through the gravity direction — the standard floating-base
formulation.  RPY keeps the DDP state a plain vector space; the pitch
singularity at +-90 deg is far outside locomotion base motion.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

GRAVITY = 9.81


def _skew(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.array([[0.0, -v[2], v[1]],
                      [v[2], 0.0, -v[0]],
                      [-v[1], v[0], 0.0]], dtype=v.dtype)


def rpy_to_matrix(rpy: jnp.ndarray) -> jnp.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy[0], rpy[1], rpy[2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    rx = jnp.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]], dtype=rpy.dtype)
    ry = jnp.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]], dtype=rpy.dtype)
    rz = jnp.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]], dtype=rpy.dtype)
    return rz @ ry @ rx


def rpy_rates_matrix(rpy: jnp.ndarray) -> jnp.ndarray:
    """E(rpy) with omega_world = E @ rpy_dot for R = Rz Ry Rx.

    Columns: the roll axis rotated through Rz Ry, the pitch axis through
    Rz, and the world z axis.
    """
    p, y = rpy[1], rpy[2]
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.array([[cp * cy, -sy, 0.0],
                      [cp * sy, cy, 0.0],
                      [-sp, 0.0, 1.0]], dtype=rpy.dtype)


@dataclasses.dataclass(frozen=True)
class RigidBodySpec:
    """Fixed-topology floating-base tree (static / numpy; hashable for jit).

    Body 0 is the floating base.  Bodies 1..nb-1 connect to `parent[i]` by
    a revolute joint: `joint_pos[i]` is the joint origin in the parent
    frame, `joint_axis[i]` the rotation axis in the child (= joint) frame.
    Inertial data per body: mass, com (body frame), rotational inertia
    about the com (body frame).  `foot_body` / `foot_pos` locate point
    feet for contact.
    """

    parent: Tuple[int, ...]
    joint_pos: np.ndarray      # (nb, 3); row 0 unused
    joint_axis: np.ndarray     # (nb, 3); row 0 unused
    mass: np.ndarray           # (nb,)
    com: np.ndarray            # (nb, 3)
    inertia: np.ndarray        # (nb, 3, 3)
    foot_body: Tuple[int, ...]
    foot_pos: np.ndarray       # (n_feet, 3) in the foot body frame
    contact_dim: int = 3       # 3 = point foot; 6 = flat foot (position +
                               # orientation, Crocoddyl ContactModel3D/6D)

    def __post_init__(self):
        for arr in ("joint_pos", "joint_axis", "mass", "com", "inertia",
                    "foot_pos"):
            object.__setattr__(self, arr, np.asarray(getattr(self, arr),
                                                     np.float64))

    @property
    def n_bodies(self) -> int:
        return len(self.parent)

    @property
    def n_joints(self) -> int:
        return self.n_bodies - 1

    @property
    def nq(self) -> int:
        return 6 + self.n_joints

    @property
    def nv(self) -> int:
        return 6 + self.n_joints

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def n_feet(self) -> int:
        return len(self.foot_body)

    @property
    def total_mass(self) -> float:
        return float(self.mass.sum())

    def __hash__(self):
        return hash((self.parent, self.foot_body, self.n_bodies,
                     self.contact_dim))

    def __eq__(self, other):
        return self is other


@functools.lru_cache(maxsize=None)
def solo12_spec() -> RigidBodySpec:
    """Solo12: base + 4x(hip, upper, lower), point feet.

    Memoized: RigidBodySpec equality is identity-based (jit static-arg
    key), so callers must share one instance to share compiled programs.

    Geometry matches models/kinematics.py (LegGeometry) exactly so the
    closed-form FK/IK layer and this engine agree.  Inertial values
    approximate the open-source solo12 description (total mass 2.5 kg as
    in config/robots.py; base inertia from the published URDF, leg links
    as uniform rods) — swap in measured URDF values for deployment.
    Body order: base, then FR(haa,upper,lower), FL, HR, HL — matching the
    FR,FL,HR,HL foot order of the centroidal layer (config/robots.py).
    """
    from centroidal_mpc_tpu.models.kinematics import SOLO12_LEGS as g
    hips = g.hip_positions()
    sides = g.side_signs()
    parent = [0]
    joint_pos = [np.zeros(3)]
    joint_axis = [np.zeros(3)]
    mass = [1.16115]
    com = [np.zeros(3)]
    inertia = [np.diag([0.00578574, 0.01938108, 0.02476124])]

    def rod_inertia(m, length):
        i = m * length * length / 12.0
        return np.diag([i, i, 2e-5])

    foot_body = []
    for leg in range(4):
        base_idx = len(parent)
        # HAA: child of base at the hip, axis x
        parent.append(0)
        joint_pos.append(hips[leg])
        joint_axis.append(np.array([1.0, 0.0, 0.0]))
        mass.append(0.140)
        com.append(np.array([0.0, sides[leg] * 0.02, 0.0]))
        inertia.append(np.diag([3e-5, 5e-5, 5e-5]))
        # HFE: child of HAA at the lateral offset, axis y
        parent.append(base_idx)
        joint_pos.append(np.array([0.0, sides[leg] * g.y_off, 0.0]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        mass.append(0.1434)
        com.append(np.array([0.0, 0.0, -g.l_upper / 2]))
        inertia.append(rod_inertia(0.1434, g.l_upper))
        # KFE: child of upper at the knee, axis y
        parent.append(base_idx + 1)
        joint_pos.append(np.array([0.0, 0.0, -g.l_upper]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        mass.append(0.0517)
        com.append(np.array([0.0, 0.0, -g.l_lower / 2]))
        inertia.append(rod_inertia(0.0517, g.l_lower))
        foot_body.append(base_idx + 2)

    return RigidBodySpec(parent=tuple(parent), joint_pos=np.array(joint_pos),
                         joint_axis=np.array(joint_axis),
                         mass=np.array(mass), com=np.array(com),
                         inertia=np.array(inertia),
                         foot_body=tuple(foot_body),
                         foot_pos=np.tile([0.0, 0.0, -g.l_lower], (4, 1)))


@functools.lru_cache(maxsize=None)
def bolt_spec() -> RigidBodySpec:
    """Bolt point-foot biped: base + 2x(HAA, HFE, KFE).

    The reference ships Bolt only as a whole-body config (conf_bolt.py,
    ee frames FL_ANKLE, FR_ANKLE); this spec completes the whole-body layer
    for it.  Geometry matches models/kinematics.py BOLT_LEGS (0.25 m leg
    segments above the config/robots.py:BOLT stance); the trunk-heavy
    mass split keeps the whole-body CoM near the base so BOLT's
    com_height (taken from the reference q0 base height) stays inside the
    leg workspace.  Leg order FL, FR (reference conf_bolt.py
    ee_frame_names).
    """
    from centroidal_mpc_tpu.models.kinematics import BOLT_LEGS as g
    hips = g.hip_positions()
    sides = g.side_signs()
    leg_masses = (0.08, 0.08, 0.04)
    base_mass = 1.3 - 2.0 * sum(leg_masses)
    parent = [0]
    joint_pos = [np.zeros(3)]
    joint_axis = [np.zeros(3)]
    mass = [base_mass]
    com = [np.zeros(3)]
    inertia = [np.diag([0.003, 0.004, 0.003])]

    def rod_inertia(m, length):
        i = m * length * length / 12.0
        return np.diag([i, i, 2e-5])

    foot_body = []
    for leg in range(2):
        base_idx = len(parent)
        parent.append(0)
        joint_pos.append(hips[leg])
        joint_axis.append(np.array([1.0, 0.0, 0.0]))
        mass.append(leg_masses[0])
        com.append(np.array([0.0, sides[leg] * 0.02, 0.0]))
        inertia.append(np.diag([3e-5, 5e-5, 5e-5]))
        parent.append(base_idx)
        joint_pos.append(np.array([0.0, sides[leg] * g.y_off, 0.0]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        mass.append(leg_masses[1])
        com.append(np.array([0.0, 0.0, -g.l_upper / 2]))
        inertia.append(rod_inertia(leg_masses[1], g.l_upper))
        parent.append(base_idx + 1)
        joint_pos.append(np.array([0.0, 0.0, -g.l_upper]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        mass.append(leg_masses[2])
        com.append(np.array([0.0, 0.0, -g.l_lower / 2]))
        inertia.append(rod_inertia(leg_masses[2], g.l_lower))
        foot_body.append(base_idx + 2)

    return RigidBodySpec(parent=tuple(parent), joint_pos=np.array(joint_pos),
                         joint_axis=np.array(joint_axis),
                         mass=np.array(mass), com=np.array(com),
                         inertia=np.array(inertia),
                         foot_body=tuple(foot_body),
                         foot_pos=np.tile([0.0, 0.0, -g.l_lower], (2, 1)))


@functools.lru_cache(maxsize=None)
def talos_spec() -> RigidBodySpec:
    """Talos legs model: torso base + 2x6-joint legs, flat feet (6D contact).

    The reference loads `example_robot_data` 'talos_legs' and relies on
    Crocoddyl ContactModel6D for the flat feet (src/whole_body_control.py
    TALOS branches, conf_talos.py ee frames right_sole_link,
    left_sole_link).  Joint chain per leg (the talos_legs ordering): hip
    yaw (z), hip roll (x), hip pitch (y), knee pitch (y), ankle pitch (y),
    ankle roll (x); the sole sits 0.107 m below the ankle.  Link lengths
    follow the published talos leg geometry (thigh 0.38 m, shin 0.325 m);
    inertial values are plausible approximations summing to the
    config/robots.py:TALOS 45 kg total — swap in measured URDF values for
    deployment.  Leg order RF, LF (reference conf_talos.py).
    """
    hip_y, hip_drop = 0.085, 0.075          # hips sit below the pelvis base
    l_thigh, l_shin, l_ankle = 0.38, 0.325, 0.107
    parent = [0]
    joint_pos = [np.zeros(3)]
    joint_axis = [np.zeros(3)]
    mass = [26.0]
    com = [np.array([-0.02, 0.0, 0.25])]    # torso com above the pelvis
    inertia = [np.diag([1.2, 1.0, 0.35])]

    def rod_inertia(m, length, r=0.05):
        i = m * (length * length / 12.0 + r * r / 4.0)
        return np.diag([i, i, m * r * r / 2.0])

    foot_body = []
    for leg, side in ((0, -1.0), (1, 1.0)):   # RF then LF
        base_idx = len(parent)
        # hip yaw (z)
        parent.append(0)
        joint_pos.append(np.array([0.0, side * hip_y, -hip_drop]))
        joint_axis.append(np.array([0.0, 0.0, 1.0]))
        mass.append(1.2)
        com.append(np.zeros(3))
        inertia.append(np.diag([4e-3, 4e-3, 4e-3]))
        # hip roll (x)
        parent.append(base_idx)
        joint_pos.append(np.zeros(3))
        joint_axis.append(np.array([1.0, 0.0, 0.0]))
        mass.append(1.5)
        com.append(np.zeros(3))
        inertia.append(np.diag([5e-3, 5e-3, 5e-3]))
        # hip pitch (y) -> thigh
        parent.append(base_idx + 1)
        joint_pos.append(np.zeros(3))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        mass.append(4.0)
        com.append(np.array([0.0, 0.0, -l_thigh / 2]))
        inertia.append(rod_inertia(4.0, l_thigh))
        # knee pitch (y) -> shin
        parent.append(base_idx + 2)
        joint_pos.append(np.array([0.0, 0.0, -l_thigh]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        mass.append(2.2)
        com.append(np.array([0.0, 0.0, -l_shin / 2]))
        inertia.append(rod_inertia(2.2, l_shin))
        # ankle pitch (y)
        parent.append(base_idx + 3)
        joint_pos.append(np.array([0.0, 0.0, -l_shin]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        mass.append(0.3)
        com.append(np.zeros(3))
        inertia.append(np.diag([1e-3, 1e-3, 1e-3]))
        # ankle roll (x) -> foot
        parent.append(base_idx + 4)
        joint_pos.append(np.zeros(3))
        joint_axis.append(np.array([1.0, 0.0, 0.0]))
        mass.append(0.3)
        com.append(np.array([0.02, 0.0, -l_ankle / 2]))
        inertia.append(np.diag([1e-3, 2e-3, 2e-3]))
        foot_body.append(base_idx + 5)

    return RigidBodySpec(parent=tuple(parent), joint_pos=np.array(joint_pos),
                         joint_axis=np.array(joint_axis),
                         mass=np.array(mass), com=np.array(com),
                         inertia=np.array(inertia),
                         foot_body=tuple(foot_body),
                         foot_pos=np.tile([0.0, 0.0, -l_ankle], (2, 1)),
                         contact_dim=6)


def _axis_rotation(axis: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues rotation about a unit axis."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    k = _skew(axis)
    eye = jnp.eye(3, dtype=theta.dtype)
    return eye + s * k + (1.0 - c) * (k @ k)


def forward_kinematics(spec: RigidBodySpec, q: jnp.ndarray):
    """World poses of every body: (nb, 3, 3) rotations, (nb, 3) origins."""
    dtype = q.dtype
    R = [rpy_to_matrix(q[3:6])]
    p = [q[0:3]]
    for i in range(1, spec.n_bodies):
        par = spec.parent[i]
        axis = jnp.asarray(spec.joint_axis[i], dtype)
        Rj = _axis_rotation(axis, q[6 + i - 1])
        R.append(R[par] @ Rj)
        p.append(p[par] + R[par] @ jnp.asarray(spec.joint_pos[i], dtype))
    return jnp.stack(R), jnp.stack(p)


def body_jacobians(spec: RigidBodySpec, q: jnp.ndarray) -> jnp.ndarray:
    """(nb, 6, nv) world-origin spatial Jacobians: v_i = J_i(q) @ u.

    Spatial velocity convention (omega_world; v_O) with v_O the velocity
    of the body-fixed point instantaneously at the world origin.  Column
    blocks: base twist (body frame) then each revolute rate, with joint
    j's world column s_j = (a_j; p_j x a_j).
    """
    dtype = q.dtype
    R, p = forward_kinematics(spec, q)
    nv, nb = spec.nv, spec.n_bodies
    # revolute joint axes/origins in world coordinates
    cols = [jnp.zeros((6,), dtype)]  # row 0 placeholder
    for i in range(1, nb):
        a_w = R[i] @ jnp.asarray(spec.joint_axis[i], dtype)
        cols.append(jnp.concatenate([a_w, jnp.cross(p[i], a_w)]))
    jacs = []
    for i in range(nb):
        J = jnp.zeros((6, nv), dtype)
        # base block: omega_w = R0 w_b ; v_O = R0 v_b + p0 x omega_w
        J = J.at[0:3, 0:3].set(R[0])
        J = J.at[3:6, 0:3].set(_skew(p[0]) @ R[0])
        J = J.at[3:6, 3:6].set(R[0])
        j = i
        while j != 0:
            J = J.at[:, 6 + j - 1].set(cols[j])
            j = spec.parent[j]
        jacs.append(J)
    return jnp.stack(jacs)


def spatial_inertias_world(spec: RigidBodySpec, q: jnp.ndarray) -> jnp.ndarray:
    """(nb, 6, 6) spatial inertias at the world origin."""
    dtype = q.dtype
    R, p = forward_kinematics(spec, q)
    coms = p + jnp.einsum("bij,bj->bi", R, jnp.asarray(spec.com, dtype))
    Ic_w = jnp.einsum("bij,bjk,blk->bil", R,
                      jnp.asarray(spec.inertia, dtype), R)
    m = jnp.asarray(spec.mass, dtype)

    def one(mass_i, c, ic):
        ch = _skew(c)
        top = jnp.concatenate([ic - mass_i * ch @ ch, mass_i * ch], axis=1)
        bot = jnp.concatenate([mass_i * ch.T, mass_i * jnp.eye(3, dtype=dtype)],
                              axis=1)
        return jnp.concatenate([top, bot], axis=0)

    return jax.vmap(one)(m, coms, Ic_w)


def mass_matrix(spec: RigidBodySpec, q: jnp.ndarray) -> jnp.ndarray:
    """(nv, nv) generalized mass matrix M(q) = sum_i J_i' I_i J_i."""
    J = body_jacobians(spec, q)
    I = spatial_inertias_world(spec, q)
    M = jnp.einsum("bri,brs,bsj->ij", J, I, J)
    return 0.5 * (M + M.T)


def _kinematic_qdot(spec: RigidBodySpec, q: jnp.ndarray,
                    u: jnp.ndarray) -> jnp.ndarray:
    """Coordinate rates from the generalized velocity."""
    R0 = rpy_to_matrix(q[3:6])
    omega_w = R0 @ u[0:3]
    pos_dot = R0 @ u[3:6]
    rpy_dot = jnp.linalg.solve(rpy_rates_matrix(q[3:6]), omega_w)
    return jnp.concatenate([pos_dot, rpy_dot, u[6:]])


def bias_forces(spec: RigidBodySpec, q: jnp.ndarray,
                u: jnp.ndarray) -> jnp.ndarray:
    """h(q, u): Coriolis/centrifugal + gravity generalized forces.

    d'Alembert over bodies: h = sum_i J_i' (I_i (Jdot_i u) + v_i x* I_i v_i
    - f_grav,i), with Jdot_i u from one jvp through body_jacobians along
    the coordinate rates.  Replaces the reference's Pinocchio RNEA calls.
    """
    dtype = q.dtype
    qdot = _kinematic_qdot(spec, q, u)
    J, Jdot = jax.jvp(lambda qq: body_jacobians(spec, qq), (q,), (qdot,))
    I = spatial_inertias_world(spec, q)
    v = jnp.einsum("brj,j->br", J, u)          # (nb, 6)
    mom = jnp.einsum("brs,bs->br", I, v)       # spatial momentum per body

    def vcross_star(v_i, f_i):
        w, vo = v_i[0:3], v_i[3:6]
        n, f = f_i[0:3], f_i[3:6]
        return jnp.concatenate([jnp.cross(w, n) + jnp.cross(vo, f),
                                jnp.cross(w, f)])

    bias_f = (jnp.einsum("brs,bs->br", I, jnp.einsum("brj,j->br", Jdot, u))
              + jax.vmap(vcross_star)(v, mom))
    # gravity wrench at the world origin per body: force m g at the com
    R, p = forward_kinematics(spec, q)
    coms = p + jnp.einsum("bij,bj->bi", R, jnp.asarray(spec.com, dtype))
    g_vec = jnp.array([0.0, 0.0, -GRAVITY], dtype)
    fg = jnp.asarray(spec.mass, dtype)[:, None] * g_vec[None, :]
    grav = jnp.concatenate([jnp.cross(coms, fg), fg], axis=1)
    return jnp.einsum("brj,br->j", J, bias_f - grav)


def foot_points(spec: RigidBodySpec, q: jnp.ndarray) -> jnp.ndarray:
    """(n_feet, 3) world foot positions."""
    dtype = q.dtype
    R, p = forward_kinematics(spec, q)
    feet = []
    for f, body in enumerate(spec.foot_body):
        feet.append(p[body] + R[body] @ jnp.asarray(spec.foot_pos[f], dtype))
    return jnp.stack(feet)


def contact_jacobian(spec: RigidBodySpec, q: jnp.ndarray) -> jnp.ndarray:
    """(n_feet, 3, nv) world-frame point-velocity Jacobians.

    From the world-origin body Jacobian: v_p = v_O + omega x p_f, i.e.
    Jc = J_lin - skew(p_f) J_ang.
    """
    J = body_jacobians(spec, q)
    feet = foot_points(spec, q)
    rows = []
    for f, body in enumerate(spec.foot_body):
        rows.append(J[body][3:6] - _skew(feet[f]) @ J[body][0:3])
    return jnp.stack(rows)


def foot_orientations(spec: RigidBodySpec, q: jnp.ndarray) -> jnp.ndarray:
    """(n_feet, 3, 3) world rotations of the foot bodies."""
    R, _ = forward_kinematics(spec, q)
    return jnp.stack([R[body] for body in spec.foot_body])


def contact_frame_jacobian(spec: RigidBodySpec, q: jnp.ndarray) -> jnp.ndarray:
    """(n_feet, contact_dim, nv) contact Jacobians.

    Point feet (contact_dim=3): the point-velocity rows of
    `contact_jacobian`.  Flat feet (contact_dim=6, Crocoddyl
    ContactModel6D role): [point velocity (3); world angular velocity (3)]
    per foot.
    """
    if spec.contact_dim == 3:
        return contact_jacobian(spec, q)
    J = body_jacobians(spec, q)
    feet = foot_points(spec, q)
    rows = []
    for f, body in enumerate(spec.foot_body):
        lin = J[body][3:6] - _skew(feet[f]) @ J[body][0:3]
        rows.append(jnp.concatenate([lin, J[body][0:3]], axis=0))
    return jnp.stack(rows)


def centroidal_momentum(spec: RigidBodySpec, q: jnp.ndarray,
                        u: jnp.ndarray) -> jnp.ndarray:
    """(6,) centroidal momentum [linear(3), angular-about-com(3)].

    The reference extracts this per knot with Pinocchio
    (src/whole_body_control.py:396-399) to hand the centroidal layer its
    warm start; here it feeds the same artifact.
    """
    J = body_jacobians(spec, q)
    I = spatial_inertias_world(spec, q)
    h_O = jnp.einsum("brs,bsj,j->r", I, J, u)   # (n; p) at world origin
    R, p = forward_kinematics(spec, q)
    dtype = q.dtype
    coms = p + jnp.einsum("bij,bj->bi", R, jnp.asarray(spec.com, dtype))
    m = jnp.asarray(spec.mass, dtype)
    com = (m[:, None] * coms).sum(0) / m.sum()
    lin = h_O[3:6]
    ang = h_O[0:3] - jnp.cross(com, lin)
    return jnp.concatenate([lin, ang])


def com_position(spec: RigidBodySpec, q: jnp.ndarray) -> jnp.ndarray:
    R, p = forward_kinematics(spec, q)
    coms = p + jnp.einsum("bij,bj->bi", R, jnp.asarray(spec.com, q.dtype))
    m = jnp.asarray(spec.mass, q.dtype)
    return (m[:, None] * coms).sum(0) / m.sum()


@dataclasses.dataclass(frozen=True)
class ContactDynamicsSettings:
    baumgarte_kp: float = 100.0    # position stabilization [1/s^2]
    baumgarte_kd: float = 20.0     # velocity stabilization [1/s]
    kkt_damping: float = 1e-9


def constrained_forward_dynamics(
        spec: RigidBodySpec, q: jnp.ndarray, u: jnp.ndarray,
        tau: jnp.ndarray, contact_mask: jnp.ndarray,
        contact_ref: jnp.ndarray,
        settings: ContactDynamicsSettings = ContactDynamicsSettings()):
    """Contact-constrained forward dynamics (Crocoddyl's KKT system).

        [ M   -Jc' ] [udot]   [ S' tau - h ]
        [ Jc    0  ] [ f  ] = [ -gamma - baumgarte ]

    solved as one dense symmetric system with inactive contacts masked to
    identity rows (f_i = 0), keeping shapes static across gait phases.
    contact_mask: (n_feet,) 1/0; contact_ref: (n_feet, 3) world anchor
    points for Baumgarte stabilization.  Flat feet (contact_dim=6,
    Crocoddyl ContactModel6D role) additionally constrain the foot angular
    velocity, with an orientation Baumgarte term toward the flat (identity)
    ground frame.  Returns (udot, forces (n_feet, contact_dim)).
    """
    dtype = q.dtype
    nv, nf, cd = spec.nv, spec.n_feet, spec.contact_dim
    M = mass_matrix(spec, q)
    h = bias_forces(spec, q, u)
    tau_gen = jnp.concatenate([jnp.zeros((6,), dtype), tau])

    Jc = contact_frame_jacobian(spec, q).reshape(nf * cd, nv)
    qdot = _kinematic_qdot(spec, q, u)
    _, gamma = jax.jvp(
        lambda qq: (contact_frame_jacobian(spec, qq).reshape(nf * cd, nv)
                    @ u),
        (q,), (qdot,))
    feet = foot_points(spec, q)
    pos_err = feet - contact_ref                        # (nf, 3)
    if cd == 6:
        # small-angle rotation error toward the flat ground frame:
        # 0.5 * vee(R - R') is the first-order log of R about identity
        Rf = foot_orientations(spec, q)
        rot_err = 0.5 * jnp.stack(
            [Rf[:, 2, 1] - Rf[:, 1, 2],
             Rf[:, 0, 2] - Rf[:, 2, 0],
             Rf[:, 1, 0] - Rf[:, 0, 1]], axis=1)        # (nf, 3)
        err = jnp.concatenate([pos_err, rot_err], axis=1).reshape(nf * cd)
    else:
        err = pos_err.reshape(nf * cd)
    vel = Jc @ u
    rhs_c = -(gamma + settings.baumgarte_kd * vel
              + settings.baumgarte_kp * err)

    mask = jnp.repeat(contact_mask.astype(dtype), cd)
    Jm = mask[:, None] * Jc
    nc = nf * cd
    kkt = jnp.zeros((nv + nc, nv + nc), dtype)
    kkt = kkt.at[:nv, :nv].set(M)
    kkt = kkt.at[:nv, nv:].set(-Jm.T)
    kkt = kkt.at[nv:, :nv].set(Jm)
    # inactive rows: f_i = 0 via identity diagonal; active rows get a tiny
    # dual damping for rank safety at singular leg extensions
    kkt = kkt.at[jnp.arange(nv, nv + nc), jnp.arange(nv, nv + nc)].set(
        jnp.where(mask > 0.5, -settings.kkt_damping, 1.0))
    rhs = jnp.concatenate([tau_gen - h, mask * rhs_c])
    sol = jnp.linalg.solve(kkt, rhs)
    return sol[:nv], sol[nv:].reshape(nf, cd)


def integrate_step(spec: RigidBodySpec, q: jnp.ndarray, u: jnp.ndarray,
                   udot: jnp.ndarray, dt: float):
    """Semi-implicit Euler: update velocity first, then configuration."""
    u_next = u + dt * udot
    q_next = q + dt * _kinematic_qdot(spec, q, u_next)
    return q_next, u_next


def robot_spec(name: str) -> RigidBodySpec:
    """Whole-body spec for a RobotSpec name ('solo12' | 'bolt' | 'talos').

    The memoized constructors guarantee one shared instance per robot
    (RigidBodySpec equality is identity-based, the jit static-arg key).
    """
    try:
        return {"solo12": solo12_spec, "bolt": bolt_spec,
                "talos": talos_spec}[name]()
    except KeyError:
        raise KeyError(f"no whole-body RigidBodySpec for robot {name!r}")
