"""Analytic warm starts for the SCP solve.

The reference warm-starts states from a whole-body DDP solve loaded off
disk and controls from a weight-distribution heuristic
(src/centroidal_model.py:158-187).  Its DYNAMICS_FIRST path (commented out,
:164-171) builds states from the active-contact centroid.  Both are
implemented here as pure functions; the DDP bracket lives in
models/whole_body.py.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from centroidal_mpc_tpu.config.robots import POINT3, RobotSpec
from centroidal_mpc_tpu.contact.plan import ContactSchedule


def centroid_state_warm_start(robot: RobotSpec, schedule: ContactSchedule,
                              dtype=None) -> jnp.ndarray:
    """(N+1, nx) state warm start: CoM above the active-contact centroid,
    zero momenta (reference's commented DYNAMICS_FIRST path,
    src/centroidal_model.py:164-171; centroid per src/utils.py:18-24)."""
    # Host-side numpy throughout: the schedule holds numpy leaves (see
    # contact/plan.py) and the warm start becomes X_track / x_init jit
    # constants, so nothing here may touch the device.
    logic = np.asarray(schedule.logic)
    pos = np.asarray(schedule.position)
    dtype = dtype or schedule.logic.dtype
    n = logic.shape[0]
    X = np.zeros((n + 1, 9))
    n_active = np.maximum(logic.sum(axis=1), 1.0)
    centroid = (pos * logic[:, :, None]).sum(axis=1) / n_active[:, None]
    X[:n, 0] = centroid[:, 0]
    X[:n, 1] = centroid[:, 1]
    X[:n, 2] = robot.com_height + centroid[:, 2]
    X[n] = X[n - 1]
    return np.asarray(X, dtype)


def ddp_warm_start(model, schedule: ContactSchedule, robot: RobotSpec,
                   state_weights=None, control_weights=None,
                   settings=None):
    """Dynamically-consistent warm start via the jitted iLQR solver.

    Plays the role of the reference's stage-1 whole-body DDP (tracks a
    CoM-progress reference, run_motion.py:16-30) on the centroidal
    dynamics: tracks the contact-centroid state path with control
    regularization around the weight-distribution heuristic.  The result
    satisfies the nonlinear dynamics exactly (it is a rollout), unlike the
    kinematic centroid path.  Returns (X (N+1, nx), U (N, nu)).
    """
    import jax
    import jax.numpy as jnp
    from centroidal_mpc_tpu.models.centroidal import dynamics_step
    from centroidal_mpc_tpu.solver.ddp import DdpSettings, solve_ilqr

    dtype = schedule.logic.dtype
    X_ref = centroid_state_warm_start(robot, schedule, dtype)
    U_ref = weight_distribution_control_warm_start(robot, schedule, dtype)

    # Build-time precompute: runs ENTIRELY on the host CPU backend and
    # hands back numpy.  The result becomes X_track / x_init jit
    # CONSTANTS in the solvers (see contact/plan.py), so it is wanted on
    # the host anyway; a batch-of-one iLQR over 50-165 knots is a chain
    # of tiny sequential steps that would leave a GPU idle, and on the
    # CPU backend the readback is a plain copy.
    with jax.default_device(jax.devices("cpu")[0]):
        wx = (jnp.asarray(state_weights, dtype)
              if state_weights is not None
              else jnp.asarray([1e3] * 3 + [1e1] * 3 + [1e1] * 3, dtype))
        wu = (jnp.asarray(control_weights, dtype)
              if control_weights is not None
              else jnp.full((robot.n_u,), 1e-3, dtype))
        # jnp views for traced-index access inside the solver (the
        # schedule and references are host-side numpy)
        pos_j, logic_j, rot_j = (jnp.asarray(schedule.position),
                                 jnp.asarray(schedule.logic),
                                 jnp.asarray(schedule.orientation))
        X_ref_j, U_ref_j = jnp.asarray(X_ref), jnp.asarray(U_ref)

        def dynamics(x, u, k):
            return dynamics_step(model, x, u, pos_j[k], logic_j[k],
                                 rot_j[k])

        def stage_cost(x, u, k):
            dx = x - X_ref_j[k]
            du = u - U_ref_j[k]
            return jnp.sum(wx * dx * dx) + jnp.sum(wu * du * du)

        def terminal_cost(x):
            dx = x - X_ref_j[-1]
            return 10.0 * jnp.sum(wx * dx * dx)

        sol = solve_ilqr(dynamics, stage_cost, terminal_cost, X_ref_j[0],
                         U_ref_j, settings or DdpSettings())
        X, U = np.asarray(sol.X), np.asarray(sol.U)
    return X.astype(dtype), U.astype(dtype)


def weight_distribution_control_warm_start(robot: RobotSpec,
                                           schedule: ContactSchedule,
                                           dtype=None) -> jnp.ndarray:
    """(N, nu) control warm start: each active contact carries an equal
    share of the robot weight, with 1e-3 tangential forces (reference
    src/centroidal_model.py:176-183)."""
    # Host-side numpy (see centroid_state_warm_start).
    logic = np.asarray(schedule.logic)
    dtype = dtype or schedule.logic.dtype
    n, c = logic.shape
    share = robot.weight_force / np.maximum(logic.sum(axis=1), 1.0)
    per_contact = np.zeros((n, c, robot.n_u_per_contact))
    fz_col = 2 if robot.contact_model == POINT3 else 4
    fx_col = 0 if robot.contact_model == POINT3 else 2
    per_contact[:, :, fx_col] = 1e-3 * logic
    per_contact[:, :, fx_col + 1] = 1e-3 * logic
    per_contact[:, :, fz_col] = share[:, None] * logic
    return np.asarray(per_contact.reshape(n, robot.n_u), dtype)
