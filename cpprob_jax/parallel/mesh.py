"""Device-mesh helpers.

The reference has **no** multi-device story (SURVEY.md §2.7: single-threaded
loop + a two-process ZeroMQ pipeline).  Here the particle dimension is the
data-parallel mesh axis: log-weight normalization, ESS, and resampling ride
XLA collectives over the interconnect (``psum``/``all_gather``), per BASELINE.json.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

PARTICLE_AXIS = "particles"

__all__ = [
    "PARTICLE_AXIS",
    "particle_mesh",
    "particle_sharding",
    "replicated_sharding",
]


def particle_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """1-D mesh over the particle axis.  Multi-host: call
    ``jax.distributed.initialize`` first and pass ``jax.devices()``."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (PARTICLE_AXIS,))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(PARTICLE_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
