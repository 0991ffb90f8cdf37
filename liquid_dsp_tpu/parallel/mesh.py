"""Device-mesh construction for sharded stream processing.

The reference is single-threaded C with no parallel axes (SURVEY.md §2.12);
the parallel design here is new:

  * axis "ch" — data parallelism over independent channels (the analog of
    firpfbch's M independent channel streams, reference firpfbch.c:383)
  * axis "t"  — sequence parallelism over contiguous time blocks, with
    filter-tail halos exchanged between neighbors (ppermute)

The GPUs of one host are joined all to all by NVLink, every pair at the
same rate, so the mesh follows the algorithm alone: any device order
serves the halo exchange equally.  Across hosts, keep "t" inside a host
and put "ch" across hosts (channels never communicate).
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["stream_mesh", "P", "NamedSharding"]


def stream_mesh(n_time: int = 1, n_channel: int = 1, devices=None) -> Mesh:
    """Create a (ch, t) mesh.  n_time * n_channel must equal device count.

    Devices fill the mesh in the given order; on an all-to-all NVLink
    host the order does not change the halo cost.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_time * n_channel != len(devices):
        raise ValueError(
            f"mesh {n_channel}x{n_time} != {len(devices)} devices")
    arr = np.array(devices).reshape(n_channel, n_time)
    return Mesh(arr, ("ch", "t"))
