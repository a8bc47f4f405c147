"""Whole-body layer for the biped/humanoid robots (bolt, talos).

The reference exercises Bolt and Talos only through its Crocoddyl
whole-body layer (conf_bolt.py, conf_talos.py — both gait + whole-body
weights only, SURVEY.md section 2a row 10); Talos uses flat-foot 6D
contacts (ContactModel6D).  These tests cover the JAX equivalents:
bolt_spec/talos_spec rigid-body models, the generic numeric-IK standing
path, flat-foot contact-KKT dynamics, and full whole-body DDP solves.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from centroidal_mpc_tpu.config import gaits
from centroidal_mpc_tpu.config.robots import BOLT, TALOS
from centroidal_mpc_tpu.contact.plan import build_contact_plan
from centroidal_mpc_tpu.contact.swing import compute_swing_trajectories
from centroidal_mpc_tpu.models import rigid_body as rb
from centroidal_mpc_tpu.models import whole_body_ddp as wbd
from centroidal_mpc_tpu.solver.ddp import DdpSettings

DT_CTRL = 0.001


def _plan_and_targets(robot, gait, dt):
    plan = build_contact_plan(robot, gait, dt, dtype=jnp.float64)
    swing = compute_swing_trajectories(plan, DT_CTRL)
    targets = wbd.build_targets(plan, swing, DT_CTRL, dtype=jnp.float64)
    return plan, targets


@pytest.fixture(scope="module")
def bolt_setup():
    gait = gaits.GaitSpec(gaits.PACE, step_length=0.0, step_height=0.04,
                          step_knots=6, support_knots=3, nb_steps=1)
    plan, targets = _plan_and_targets(BOLT, gait, 0.01)
    return rb.bolt_spec(), plan, targets


@pytest.fixture(scope="module")
def talos_setup():
    gait = gaits.GaitSpec(gaits.PACE, step_length=0.0, step_height=0.05,
                          step_knots=5, support_knots=2, nb_steps=1)
    plan, targets = _plan_and_targets(TALOS, gait, 0.03)
    return rb.talos_spec(), plan, targets


def test_spec_structure():
    bs, ts = rb.bolt_spec(), rb.talos_spec()
    assert bs.n_feet == 2 and bs.contact_dim == 3 and bs.nv == 12
    assert ts.n_feet == 2 and ts.contact_dim == 6 and ts.nv == 18
    np.testing.assert_allclose(bs.total_mass, BOLT.mass, atol=1e-9)
    np.testing.assert_allclose(ts.total_mass, TALOS.mass, atol=1e-9)


def test_leg_geometry_derivation():
    """solo12/bolt match the closed-form 3-DoF pattern; talos does not."""
    assert wbd.leg_geometry_from_spec(rb.solo12_spec()) is not None
    g = wbd.leg_geometry_from_spec(rb.bolt_spec())
    assert g is not None and g.n_legs == 2
    assert wbd.leg_geometry_from_spec(rb.talos_spec()) is None


def test_bolt_standing_and_quasi_static(bolt_setup):
    spec, _, targets = bolt_setup
    x0 = wbd.standing_state(spec, targets)
    q0 = x0[:spec.nq]
    np.testing.assert_allclose(np.asarray(rb.foot_points(spec, q0)),
                               np.asarray(targets.foot_target[0]), atol=1e-6)
    tau = wbd.quasi_static_torques(spec, q0, targets.contact_mask[0])
    udot, f = rb.constrained_forward_dynamics(
        spec, q0, jnp.zeros(spec.nv), tau, targets.contact_mask[0],
        targets.contact_ref[0])
    # two point contacts leave the pitch axis through the foot line
    # uncontrollable; equilibrium holds up to that physical residual
    assert float(jnp.abs(udot).max()) < 1.0
    assert abs(float(f[:, 2].sum()) - spec.total_mass * rb.GRAVITY) < 0.1


def test_talos_standing_numeric_ik_exact(talos_setup):
    spec, _, targets = talos_setup
    x0 = wbd.standing_state(spec, targets)
    q0 = x0[:spec.nq]
    np.testing.assert_allclose(np.asarray(rb.foot_points(spec, q0)),
                               np.asarray(targets.foot_target[0]), atol=1e-8)
    np.testing.assert_allclose(np.asarray(rb.com_position(spec, q0)),
                               np.asarray(targets.com_target[0]), atol=1e-8)
    # flat feet stay flat
    Rf = rb.foot_orientations(spec, q0)
    assert float(jnp.abs(Rf - jnp.eye(3)).max()) < 1e-8


def test_talos_quasi_static_equilibrium_exact(talos_setup):
    """Flat 6D contacts fully constrain the base: equilibrium is exact
    (unlike the point-foot biped)."""
    spec, _, targets = talos_setup
    x0 = wbd.standing_state(spec, targets)
    q0 = x0[:spec.nq]
    tau = wbd.quasi_static_torques(spec, q0, targets.contact_mask[0])
    udot, f = rb.constrained_forward_dynamics(
        spec, q0, jnp.zeros(spec.nv), tau, targets.contact_mask[0],
        targets.contact_ref[0])
    assert float(jnp.abs(udot).max()) < 1e-4
    assert f.shape == (2, 6)
    assert abs(float(f[:, 2].sum()) - spec.total_mass * rb.GRAVITY) < 1e-4


def test_talos_6d_contact_restrains_rotation(talos_setup):
    """A pure ankle torque against an active flat contact produces (almost)
    no foot rotation — the 6D rows absorb it as a contact torque."""
    spec, _, targets = talos_setup
    x0 = wbd.standing_state(spec, targets)
    q0 = x0[:spec.nq]
    tau = wbd.quasi_static_torques(spec, q0, targets.contact_mask[0])
    tau = tau.at[4].add(20.0)  # RF ankle pitch kick
    udot, f = rb.constrained_forward_dynamics(
        spec, q0, jnp.zeros(spec.nv), tau, targets.contact_mask[0],
        targets.contact_ref[0])
    jc = rb.contact_frame_jacobian(spec, q0).reshape(12, spec.nv)
    foot_acc = jc @ udot
    assert float(jnp.abs(foot_acc).max()) < 1e-3
    # the kick shows up as a contact torque on the RF foot
    assert float(jnp.abs(f[0, 3:6]).max()) > 1.0


_BIPED_DDP_SCRIPT = """
import json
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from centroidal_mpc_tpu.config import gaits
from centroidal_mpc_tpu.config.robots import BOLT, TALOS
from centroidal_mpc_tpu.contact.plan import build_contact_plan
from centroidal_mpc_tpu.contact.swing import compute_swing_trajectories
from centroidal_mpc_tpu.models import rigid_body as rb
from centroidal_mpc_tpu.models import whole_body_ddp as wbd
from centroidal_mpc_tpu.solver.ddp import DdpSettings

robot, spec, dt, step_height, step_knots, support_knots = __PARAMS__
gait = gaits.GaitSpec(gaits.PACE, step_length=0.0, step_height=step_height,
                      step_knots=step_knots, support_knots=support_knots,
                      nb_steps=1)
plan = build_contact_plan(robot, gait, dt, dtype=jnp.float64)
swing = compute_swing_trajectories(plan, 0.001)
targets = wbd.build_targets(plan, swing, 0.001, dtype=jnp.float64)
spec = spec()
sol = wbd.solve_whole_body_ddp(
    spec, targets, dt, settings=DdpSettings(iterations=30, exact_quu=True))
mask = np.asarray(targets.contact_mask)[:, :, None]
err = np.abs(np.asarray(sol.feet[:-1]) - np.asarray(targets.foot_target))
ds = np.asarray(targets.contact_mask).sum(1) == 2
fz = np.asarray(sol.forces)[ds, :, 2].sum(1)
print(json.dumps({
    "forces_shape": list(sol.forces.shape),
    "horizon": plan.horizon,
    "stance_err": float((err * mask).max()),
    "com_z_err": float(np.abs(np.asarray(sol.com)[:, 2]
                              - np.asarray(targets.com_target)[:, 2]).max()),
    "fz_mean": float(fz.mean()),
    "weight": spec.total_mass * rb.GRAVITY,
}))
"""


def _run_biped_ddp_isolated(params: str) -> dict:
    """Run a full biped whole-body DDP solve in a fresh interpreter.

    XLA:CPU repeatedly segfaults/aborts compiling these (large) programs
    inside the long-lived full-suite process (observed 2026-08: SIGSEGV /
    SIGABRT in backend_compile_and_load at exactly these DDP tests, while
    the same compiles succeed standalone every time).  A subprocess gives
    each compile a fresh LLVM state and keeps the one-command suite green.
    """
    import json
    import subprocess
    import sys
    script = _BIPED_DDP_SCRIPT.replace("__PARAMS__", params)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True,
        text=True, timeout=1800,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_bolt_whole_body_ddp():
    res = _run_biped_ddp_isolated(
        "(BOLT, rb.bolt_spec, 0.01, 0.04, 6, 3)")
    assert res["stance_err"] < 0.02             # stance feet pinned
    assert res["com_z_err"] < 0.05              # height held through gait


@pytest.mark.slow  # ~5 min one-off XLA:CPU compile (wrench6 humanoid);
# bolt stays in the fast suite as the biped whole-body representative
def test_talos_whole_body_ddp():
    res = _run_biped_ddp_isolated(
        "(TALOS, rb.talos_spec, 0.03, 0.05, 5, 2)")
    assert res["forces_shape"] == [res["horizon"], 2, 6]
    assert res["stance_err"] < 0.02
    assert res["com_z_err"] < 0.05
    assert abs(res["fz_mean"] - res["weight"]) < 60.0


def test_build_targets_wrench6_force_extraction(talos_setup):
    """Stage-3 target assembly slices the linear force out of wrench6
    centroidal controls (cop_x, cop_y, fx, fy, fz, tau_z)."""
    spec, plan, _ = talos_setup
    n = plan.horizon
    swing = compute_swing_trajectories(plan, DT_CTRL)
    Xc = np.zeros((n + 1, 9))
    Xc[:, 2] = TALOS.com_height
    Uc = np.zeros((n, 12))
    Uc[:, 4] = 200.0   # RF fz
    Uc[:, 10] = 180.0  # LF fz
    targets = wbd.build_targets(plan, swing, DT_CTRL,
                                X_centroidal=jnp.asarray(Xc),
                                U_centroidal=jnp.asarray(Uc),
                                dtype=jnp.float64)
    assert targets.force_target.shape == (n, 2, 3)
    np.testing.assert_allclose(np.asarray(targets.force_target[:, 0, 2]),
                               200.0)
    np.testing.assert_allclose(np.asarray(targets.force_target[:, 1, 2]),
                               180.0)
