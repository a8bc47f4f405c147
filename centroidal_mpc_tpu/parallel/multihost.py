"""Multi-host scaling: jax.distributed initialization + fleet solving.

The reference has no distributed story (SURVEY.md section 2d).  The
scaling design here follows the north star: scenario batches shard over
all devices of several hosts; collectives carry the psum'd fleet
statistics (parallel/batch.py) and the network only host coordination.
Multi-host runs are validated structurally on the CPU: the same code
path drives the gloo-coordinated CPU processes in tests and the virtual
8-device CPU mesh of `__graft_entry__.dryrun_multichip`.

Usage on a real slice (one process per host):

    from centroidal_mpc_tpu.parallel import multihost
    multihost.initialize()            # reads cluster env (GKE/GCE) or args
    solver, mesh = multihost.fleet_solver(model, schedule, settings)
    sol, stats = solver(cfg_global, X0_global, U0_global)

Inputs are global arrays; `make_array_from_process_local_data` handles the
host-local shard placement.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from centroidal_mpc_tpu.contact.plan import ContactSchedule
from centroidal_mpc_tpu.models.centroidal import CentroidalModel
from centroidal_mpc_tpu.parallel.batch import make_sharded_solver
from centroidal_mpc_tpu.solver.scp import ScpSettings

AXIS = "scenarios"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with cluster-env autodetection.

    No-op when the process group is already initialized or when running
    single-process (num_processes == 1 after autodetect).  On the CPU
    backend, cross-process collectives need the gloo implementation
    (default is single-process-only) -- set before initializing.
    """
    # NOTE: must not touch the XLA backend before initialize (even
    # jax.process_count() would initialize it) -- use is_initialized().
    if jax.distributed.is_initialized():
        return
    explicit = coordinator_address is not None
    if explicit and (num_processes or 1) > 1:
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass  # non-CPU backends / older flag name
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (ValueError, RuntimeError):
        if explicit:
            raise
        # single-process environment (no cluster env vars): run local


def global_mesh(axis: str = AXIS) -> Mesh:
    """One-axis mesh over every addressable device in the job."""
    return jax.make_mesh((jax.device_count(),), (axis,))


def fleet_solver(model: CentroidalModel, schedule: ContactSchedule,
                 settings: ScpSettings, axis: str = AXIS):
    """(solver, mesh): the shard_map batch solver over the global mesh.

    The batch axis of (cfg, X0, U0) shards across all devices of all
    hosts; fleet statistics reduce with psum.
    """
    mesh = global_mesh(axis)
    return make_sharded_solver(mesh, model, schedule, settings, axis), mesh


def shard_global_batch(mesh: Mesh, tree, axis: str = AXIS):
    """Place a host-replicated batch pytree as a sharded global array.

    Each process passes the SAME global numpy arrays; rows are distributed
    over the mesh axis.  (On multi-host, prefer building only the local
    rows and `shard_local_rows`.)
    """
    sharding = NamedSharding(mesh, P(axis))

    def place(a):
        return jax.device_put(np.asarray(a), sharding)

    return jax.tree.map(place, tree)


def shard_local_rows(mesh: Mesh, tree, axis: str = AXIS):
    """Assemble global sharded arrays from *process-local* batch rows.

    Each process passes only its own rows (batch_local = batch_global /
    process_count); the result is a global array sharded over the mesh
    axis.  This is the multi-host input path: no process ever materializes
    another host's shard."""
    sharding = NamedSharding(mesh, P(axis))

    def place(a):
        return jax.make_array_from_process_local_data(sharding,
                                                      np.asarray(a))

    return jax.tree.map(place, tree)


def scaling_report(solve_fn, args, batch: int, repeats: int = 3) -> dict:
    """Measure solves/s for the current device count (run at 1 host and at
    N hosts to compute the BASELINE scaling-efficiency row)."""
    import time
    out = solve_fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = solve_fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {
        "devices": jax.device_count(),
        "processes": jax.process_count(),
        "batch": batch,
        "solves_per_s": batch / best,
        "solves_per_s_per_device": batch / best / jax.device_count(),
    }
