"""The LQR gains of the linearization, in f32 as the GPU runs them.

`lqr_gain` (truncated DARE with Newton-Schulz SPD inverses) serves every
dtype; these tests pin its f32 result to the f64 one on real trajectory
matrices, under vmap, and through `compute_trajectory_data`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from centroidal_mpc_tpu.config import presets
from centroidal_mpc_tpu.models import centroidal as cm


def _real_AB(preset_name, dtype):
    prob = presets.build_problem(presets.PRESETS[preset_name], dtype=dtype)
    sched = prob.plan.schedule
    pos = sched.positions_flat().reshape(sched.horizon,
                                         sched.n_contacts, 3)
    _, A, B, _ = jax.vmap(cm.linearize_step,
                          in_axes=(None, 0, 0, 0, 0, 0))(
        prob.model, prob.X0[:-1], prob.U0, pos, sched.logic,
        sched.orientation)
    return prob.model, A, B


def _gains(model, A, B):
    return jax.vmap(cm.lqr_gain, in_axes=(None, 0, 0, None))(model, A, B, 2)


@pytest.mark.parametrize("preset_name", ["solo12_trot_n50", "talos_pace"])
def test_f32_gains_match_f64(preset_name):
    K32 = _gains(*_real_AB(preset_name, jnp.float32))
    K64 = _gains(*_real_AB(preset_name, jnp.float64))
    assert K32.dtype == jnp.float32 and K32.shape == K64.shape
    scale = float(jnp.abs(K64).max())
    assert float(jnp.abs(K32.astype(jnp.float64) - K64).max()) \
        < 1e-4 * scale


def test_gains_under_scenario_vmap():
    """A scenario batch of trajectories gives each scenario the gains of
    its own per-scenario call."""
    model, A, B = _real_AB("solo12_trot_n50", jnp.float32)
    n = 4
    Ab = jnp.stack([A * (1.0 + 0.01 * i) for i in range(n)])
    Bb = jnp.stack([B * (1.0 - 0.01 * i) for i in range(n)])
    K_b = jax.jit(jax.vmap(lambda a, b: _gains(model, a, b)))(Ab, Bb)
    for i in range(n):
        K_i = _gains(model, Ab[i], Bb[i])
        scale = float(jnp.abs(K_i).max())
        assert float(jnp.abs(K_b[i] - K_i).max()) < 1e-6 * scale


def test_trajectory_data_f32_matches_f64():
    """compute_trajectory_data in f32 tracks the f64 linearization,
    gains and covariance to f32 accuracy."""
    p32 = presets.build_problem(presets.PRESETS["solo12_trot_n50"],
                                dtype=jnp.float32)
    p64 = presets.build_problem(presets.PRESETS["solo12_trot_n50"],
                                dtype=jnp.float64)
    d32 = cm.compute_trajectory_data(p32.model, p32.plan.schedule,
                                     p32.X0, p32.U0)
    d64 = cm.compute_trajectory_data(p64.model, p64.plan.schedule,
                                     p64.X0, p64.U0)
    for name in ("A", "B", "K", "Sigma"):
        a32 = np.asarray(getattr(d32, name), np.float64)
        a64 = np.asarray(getattr(d64, name))
        scale = max(np.abs(a64).max(), 1e-30)
        assert np.abs(a32 - a64).max() < 1e-4 * scale, name
