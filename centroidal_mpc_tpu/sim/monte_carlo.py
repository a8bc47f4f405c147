"""Batched Monte-Carlo closed-loop evaluation on the centroidal model.

The reference validates solutions with nb_sims sequential PyBullet rollouts
under random pushes (src/simulate_solo.py:184-344): a force sampled from
N(0, 15 I) is applied along y for 200 ms starting at a random time, while a
centroidal LQR correction tracks the planned momentum.  Here the same
experiment runs natively on the centroidal dynamics: one `lax.scan` rollout
per scenario, vmapped over thousands of sims at once -- the whole
Monte-Carlo study is one device program (full-physics validation remains an
external harness; SURVEY.md section 7 step 8).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from centroidal_mpc_tpu.contact.plan import ContactSchedule
from centroidal_mpc_tpu.models.centroidal import (CentroidalModel,
                                                  dynamics_step)
from centroidal_mpc_tpu.utils import struct
from centroidal_mpc_tpu.utils.precision import highest_precision

# Reference disturbance model (src/simulate_solo.py:90-115, 281-291):
# 3D force ~ N(0, 15 I); only the y component is applied, for 200 ms.
FORCE_COV = 15.0
PUSH_MS = 200


class MonteCarloResult(struct.PyTreeNode):
    X_sim: jnp.ndarray        # (S, N+1, nx) closed-loop states
    U_sim: jnp.ndarray        # (S, N, nu) applied (feedback-corrected) forces
    push_force: jnp.ndarray   # (S, 3)
    push_start: jnp.ndarray   # (S,)


def sample_disturbances(key, n_sims: int, horizon: int, dt: float,
                        dtype=jnp.float32):
    """(forces (S,3), start knot (S,), duration knots): the reference's
    pseudorandom force pushes at planning rate."""
    kf, kt = jax.random.split(key)
    forces = jax.random.multivariate_normal(
        kf, jnp.zeros(3, dtype), FORCE_COV * jnp.eye(3, dtype=dtype),
        shape=(n_sims,), dtype=dtype)
    duration = max(int(round(PUSH_MS * 1e-3 / dt)), 1)
    hi = max(horizon - duration, 1)
    starts = jax.random.randint(kt, (n_sims,), 0, hi)
    return forces, starts, duration


def closed_loop_rollout(model: CentroidalModel, schedule: ContactSchedule,
                        X_ref, U_ref, K, x0, push_force, push_start,
                        push_len: int):
    """One disturbance rollout with LQR feedback.

    u_k = U_ref_k + K_k (x_k - X_ref_k); the push adds an external force on
    the base (y component only, like src/simulate_solo.py:289-291) to the
    linear-momentum rate for push_len knots.
    Returns (X (N+1, nx), U (N, nu)).
    """
    dtype = X_ref.dtype
    ks = jnp.arange(U_ref.shape[0])
    active = ((ks >= push_start) & (ks < push_start + push_len)).astype(dtype)
    f_ext = jnp.zeros(3, dtype).at[1].set(push_force[1])

    def step(x, inputs):
        u_ref, x_ref, k_gain, pos, logic, rot, act = inputs
        u = u_ref + k_gain @ (x - x_ref)
        x_next = dynamics_step(model, x, u, pos, logic, rot)
        x_next = x_next.at[3:6].add(model.dt * act * f_ext)
        return x_next, (x_next, u)

    _, (xs, us) = jax.lax.scan(
        step, x0, (U_ref, X_ref[:-1], K, schedule.position, schedule.logic,
                   schedule.orientation, active))
    return jnp.concatenate([x0[None], xs], axis=0), us


@highest_precision
def run_monte_carlo(model: CentroidalModel, schedule: ContactSchedule,
                    X_ref, U_ref, K, key, n_sims: int) -> MonteCarloResult:
    """vmap the rollout over n_sims sampled disturbances."""
    forces, starts, duration = sample_disturbances(
        key, n_sims, U_ref.shape[0], float(model.dt), X_ref.dtype)
    roll = jax.vmap(closed_loop_rollout,
                    in_axes=(None, None, None, None, None, None, 0, 0, None))
    X_sim, U_sim = roll(model, schedule, X_ref, U_ref, K, X_ref[0],
                        forces, starts, duration)
    return MonteCarloResult(X_sim=X_sim, U_sim=U_sim, push_force=forces,
                            push_start=starts)
