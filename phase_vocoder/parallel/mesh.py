"""Device-mesh helpers (SURVEY.md SS2.2).

The reference has no distribution layer at all (single process, single GPU).
Here every parallel capability is expressed over a jax.sharding.Mesh: axis
"data" for utterance batches (DP) and axis "seq" for chunked long recordings
(sequence/context parallel). XLA lowers the collectives to the device
interconnect (NCCL between GPUs) — no hand-written transport.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["Mesh", "NamedSharding", "P", "make_mesh", "make_mesh_2d"]


def make_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    """1-D mesh over the first `n_devices` visible devices (default: all)."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n_devices]), (axis,))


def make_mesh_2d(data: int, seq: int) -> Mesh:
    """2-D (data, seq) mesh: DP over utterances x SP over time chunks."""
    devices = jax.devices()
    if data * seq > len(devices):
        raise ValueError(f"mesh {data}x{seq} exceeds {len(devices)} devices")
    arr = np.array(devices[: data * seq]).reshape(data, seq)
    return Mesh(arr, ("data", "seq"))
