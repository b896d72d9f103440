"""Multi-host entry points (SURVEY.md SS2.2 "Multi-host").

The chunked/batched shard_map programs are host-count agnostic: under
jax.distributed each process contributes its local devices to one global
mesh and the SAME compiled program runs SPMD — XLA inserts the halo/carry
collectives from the sharding annotations, within a host and across hosts.
This module only handles process bootstrap and building global meshes;
there is no separate multi-host code path to test (the 8-device CPU mesh in
tests/ exercises the identical program).
"""

from __future__ import annotations

import logging

import numpy as np

import jax
from jax.sharding import Mesh

logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-process JAX (one process per host).

    Pass all three arguments: without them jax.distributed looks for a
    cluster environment, and fails where there is none. Call once per
    process before building global meshes.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    logger.info(
        "jax.distributed initialized: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def global_mesh(axis: str = "seq") -> Mesh:
    """1-D global mesh over every device of every host."""
    return Mesh(np.array(jax.devices()), (axis,))


def global_mesh_2d(data: int, seq: int) -> Mesh:
    """2-D (data, seq) global mesh. data*seq must equal the global device count."""
    devices = np.array(jax.devices())
    if data * seq != devices.size:
        raise ValueError(f"mesh {data}x{seq} != {devices.size} global devices")
    return Mesh(devices.reshape(data, seq), ("data", "seq"))
