"""Scenario-batch and mesh-sharded SCP solving.

The reference is single-process, single-device, sequential (SURVEY.md
section 2d) -- its only "parallelism" is a Python loop over Monte-Carlo
sims.  Here batching is a transform, not a rewrite:

  * `batched_solve`: vmap of the whole jitted SCP program over a scenario
    axis (initial/final states, tracking targets, warm starts vary; the
    model and contact schedule are shared).  This is the throughput path --
    every ADMM matvec becomes a batched matmul.
  * `make_sharded_solver`: shard_map of the batched solver over a device
    mesh along the scenario axis ('scenarios'), with XLA collectives
    (NCCL on GPUs) reducing fleet-level statistics.  The cards of one
    host are joined all to all (NVLink), so a one-axis mesh is the
    whole layout.  Works identically on a virtual CPU mesh (tests) and
    the cards of a GPU host.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from centroidal_mpc_tpu.contact.plan import ContactSchedule
from centroidal_mpc_tpu.models.centroidal import CentroidalModel
from centroidal_mpc_tpu.solver.ocp import OcpConfig
from centroidal_mpc_tpu.solver.scp import ScpSettings, ScpSolution, solve_scp


def tile_ocp_config(cfg: OcpConfig, x_inits: jnp.ndarray,
                    x_finals: jnp.ndarray,
                    X_tracks: jnp.ndarray) -> OcpConfig:
    """Broadcast an OcpConfig over a batch of boundary conditions."""
    batch = x_inits.shape[0]
    tile = lambda a: jnp.broadcast_to(a, (batch,) + a.shape)
    return cfg.replace(x_init=x_inits, x_final=x_finals, X_track=X_tracks,
                       Wx=tile(cfg.Wx), Wu=tile(cfg.Wu),
                       pyramid=tile(cfg.pyramid),
                       xi=jnp.broadcast_to(cfg.xi, (batch,)),
                       cop_range=tile(cfg.cop_range))


def batched_solve(model: CentroidalModel, schedule: ContactSchedule,
                  cfg_batch: OcpConfig, X0: jnp.ndarray, U0: jnp.ndarray,
                  settings: ScpSettings) -> ScpSolution:
    """vmap the full SCP solve over the leading scenario axis of
    (cfg_batch, X0, U0); model and schedule are shared."""
    return jax.vmap(solve_scp,
                    in_axes=(None, None, 0, 0, 0, None))(
        model, schedule, cfg_batch, X0, U0, settings)


def scenario_mesh(n_devices: Optional[int] = None,
                  axis: str = "scenarios") -> Mesh:
    devices = jax.devices()[: n_devices or len(jax.devices())]
    return jax.make_mesh((len(devices),), (axis,), devices=devices)


def make_sharded_solver(mesh: Mesh, model: CentroidalModel,
                        schedule: ContactSchedule, settings: ScpSettings,
                        axis: str = "scenarios"):
    """Build a jitted, mesh-sharded batch solver.

    Returns solve(cfg_batch, X0, U0) -> (ScpSolution sharded over
    scenarios, fleet stats dict reduced with psum across the mesh).
    The scenario batch must divide the mesh axis size.
    """

    def _local(cfg_batch, X0, U0):
        sol = batched_solve(model, schedule, cfg_batch, X0, U0, settings)
        stats = {
            "n_success": jax.lax.psum(
                jnp.sum(sol.success.astype(jnp.int32)), axis),
            "qp_iterations": jax.lax.psum(jnp.sum(sol.qp_iterations), axis),
            "max_rho": jax.lax.pmax(jnp.max(sol.rho), axis),
        }
        return sol, stats

    sharded = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False)
    return jax.jit(sharded)
