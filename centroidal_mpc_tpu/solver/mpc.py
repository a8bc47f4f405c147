"""Receding-horizon MPC over a long contact plan.

The reference solves one fixed-horizon trajectory per gait and replays it
open-loop (plus LQR feedback) -- there is no re-solve loop.  This module
adds the real MPC layer the framework is named for: a jitted step that,
given the current state estimate and tick index, slices an N_window
problem out of the full contact plan, warm-starts from the previous
solution shifted by one knot, and re-solves.  Everything is static-shape
(`lax.dynamic_slice` windows), so the step compiles once and runs at
planning rate; warm starting keeps ADMM iteration counts far below
cold-solve counts.

Terminal handling: the window's final-state equality targets the tracking
reference at the window end (gait-tracking MPC).  For deployment the step
pairs with the native trajectory bus (runtime/): solve -> publish -> the
1 kHz thread samples interpolated references.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from centroidal_mpc_tpu.contact.plan import ContactSchedule
from centroidal_mpc_tpu.models.centroidal import CentroidalModel, N_X
from centroidal_mpc_tpu.solver.ocp import OcpConfig
from centroidal_mpc_tpu.solver.scp import ScpSettings, ScpSolution, solve_scp
from centroidal_mpc_tpu.utils import struct


class MpcState(struct.PyTreeNode):
    """Carry between MPC ticks: warm start in window coordinates."""

    X_warm: jnp.ndarray   # (N_w+1, nx)
    U_warm: jnp.ndarray   # (N_w, nu)
    tick: jnp.ndarray     # scalar int: window start knot in the full plan


@dataclasses.dataclass(frozen=True)
class MpcController:
    """Static problem data + jitted step for receding-horizon solving."""

    model: CentroidalModel
    schedule: ContactSchedule     # full-plan schedule
    cfg: OcpConfig                # full-plan config (X_track over full plan)
    settings: ScpSettings
    window: int

    def init_state(self, X0_full: jnp.ndarray,
                   U0_full: jnp.ndarray) -> MpcState:
        """Warm start from the head of a full-plan trajectory."""
        n_w = self.window
        # jnp conversion: warm starts are host-side numpy by design (see
        # contact/plan.py), but MpcState is carried through .at[] updates
        return MpcState(X_warm=jnp.asarray(X0_full[:n_w + 1]),
                        U_warm=jnp.asarray(U0_full[:n_w]),
                        tick=jnp.zeros((), jnp.int32))

    @property
    def max_tick(self) -> int:
        return self.schedule.horizon - self.window

    def _window_problem(self, tick):
        n_w = self.window
        sched = ContactSchedule(
            logic=jax.lax.dynamic_slice_in_dim(self.schedule.logic, tick,
                                               n_w, 0),
            position=jax.lax.dynamic_slice_in_dim(self.schedule.position,
                                                  tick, n_w, 0),
            orientation=jax.lax.dynamic_slice_in_dim(
                self.schedule.orientation, tick, n_w, 0),
        )
        x_track = jax.lax.dynamic_slice_in_dim(self.cfg.X_track, tick,
                                               n_w + 1, 0)
        return sched, x_track

    def step(self, state: MpcState,
             x_meas: jnp.ndarray) -> Tuple[MpcState, ScpSolution]:
        """One MPC tick: re-solve the window from the measured state.

        Jittable; wrap with jax.jit (self is static via closure) for the
        deployment loop.
        """
        sched, x_track = self._window_problem(state.tick)
        cfg = self.cfg.replace(x_init=x_meas, x_final=x_track[-1],
                               X_track=x_track)
        X0 = state.X_warm.at[0].set(x_meas)
        sol = solve_scp(self.model, sched, cfg, X0, state.U_warm,
                        self.settings)
        # shift the solution one knot forward as the next warm start
        X_next = jnp.concatenate([sol.X[1:], sol.X[-1:]])
        U_next = jnp.concatenate([sol.U[1:], sol.U[-1:]])
        new_tick = jnp.minimum(state.tick + 1, self.max_tick)
        return MpcState(X_warm=X_next, U_warm=U_next, tick=new_tick), sol
