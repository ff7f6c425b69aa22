"""Multi-host initialization helpers.

With several processes (one per host, or one per GPU), call
:func:`initialize_multihost` once per process before building meshes; all
`parallel/` code then spans processes automatically (the mesh covers
`jax.devices()`, and XLA hands the collectives to NCCL).  For CPU-based testing, :func:`virtual_devices` documents the
`xla_force_host_platform_device_count` recipe used by the test suite.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize_multihost", "virtual_devices", "is_multihost"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Thin wrapper over ``jax.distributed.initialize``.  Without a cluster
    manager to detect, pass all three arguments (``coordinator_address``
    as ``host:port``)."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multihost() -> bool:
    return jax.process_count() > 1


def virtual_devices(n: int = 8) -> str:
    """Returns the XLA_FLAGS value that gives ``n`` virtual CPU devices —
    must be set in the environment *before* the first JAX backend init."""
    return f"--xla_force_host_platform_device_count={n}"
