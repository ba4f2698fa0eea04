"""Device mesh + sharding helpers (replaces the reference's NCCL DDP layer).

The reference's only multi-device strategy is data parallelism via
``MMDistributedDataParallel`` + NCCL allreduce (SURVEY.md §2.3,
reference mmdet/apis/train.py:113-121, tools/dist_train.sh). Here
that whole layer disappears: the train step is jitted over a
``jax.sharding.Mesh`` with the batch sharded on the ``data`` axis and params
replicated; XLA inserts the gradient all-reduce (NCCL on GPUs). Multi-host
extends the same mesh over processes (``jax.distributed.initialize``).

A ``model`` axis is part of the mesh shape for forward-compatible tensor
sharding (unused = size 1 in the OA-DG configs, which fit on one device).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Multi-host bring-up (replaces reference init_dist, tools/train.py:129
    + mmcv init_dist): call ``jax.distributed.initialize`` when a launcher
    environment is present, then every host sees the global device set and
    the mesh spans them. Returns (process_index, process_count).

    Launcher detection (reference launchers pytorch/slurm/mpi):
    - explicit args, or
    - JAX_COORDINATOR_ADDRESS [+ JAX_NUM_PROCESSES + JAX_PROCESS_ID], or
    - SLURM_* (jax auto-detects), or OMPI_COMM_WORLD_* (mpi).
    Single-process (no env): no-op.
    """
    import os
    if jax.process_count() > 1:                  # already initialized
        return jax.process_index(), jax.process_count()
    coord = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord is not None:
        nproc = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", 1))
        pid = process_id if process_id is not None else int(
            os.environ.get("JAX_PROCESS_ID", 0))
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nproc, process_id=pid)
    elif "SLURM_JOB_ID" in os.environ and int(
            os.environ.get("SLURM_NTASKS", 1)) > 1:
        jax.distributed.initialize()             # jax SLURM auto-detect
    elif int(os.environ.get("OMPI_COMM_WORLD_SIZE", 1)) > 1:
        jax.distributed.initialize()
    return jax.process_index(), jax.process_count()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n_data = n_data or (len(devices) // n_model)
    dev = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(dev, ("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard dim 0 (batch) over the data axis; everything else replicated."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Place a host batch dict onto the mesh, sharded over 'data'.

    Single-process: a plain sharded device_put of the host-global batch.
    Multi-host: each process holds only its LOCAL slice (the loader
    yields per-process batches, reference DistributedGroupSampler
    semantics) — assemble the global jax.Array from process-local data.
    """
    sh = batch_sharding(mesh)
    if jax.process_count() > 1:
        return jax.tree_util.tree_map(
            lambda x: jax.make_array_from_process_local_data(sh, np.asarray(x)),
            batch)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), batch)


def replicate(tree, mesh: Mesh):
    rep = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), tree)
