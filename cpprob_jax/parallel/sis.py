"""Mesh-sharded SIS: particles sharded over the ``particles`` axis; the model
is embarrassingly parallel so XLA partitions the vmapped program with zero
communication, and the weighted-moment reductions ride ``psum`` collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..inference.sis import ImportanceResult, make_particle_fn
from .mesh import particle_mesh, particle_sharding, replicated_sharding

__all__ = ["sis_sharded"]


def sis_sharded(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key: jax.Array,
    *,
    mesh: Optional[Mesh] = None,
    proposal_messenger: Optional[Callable[[], Any]] = None,
    donate: bool = True,
) -> ImportanceResult:
    """SIS with the particle axis sharded over ``mesh`` (defaults to all
    devices).  ``n_particles`` must divide evenly by the mesh size.

    The per-particle program is identical to the single-chip path
    (:func:`cpprob_jax.inference.sis.sis`); only the data layout changes —
    the XLA partitioner turns the sharded ``vmap`` into per-chip kernels and
    inserts no collectives until the caller reduces the result.
    """
    mesh = mesh or particle_mesh()
    n_dev = mesh.size
    if n_particles % n_dev != 0:
        raise ValueError(
            f"n_particles={n_particles} must be divisible by mesh size {n_dev}"
        )
    p_shard = particle_sharding(mesh)
    particle = make_particle_fn(model, args, proposal_messenger=proposal_messenger)

    # The key fans out INSIDE jit from a replicated scalar: no host-side
    # device_put onto the (possibly non-addressable, multi-process) global
    # sharding is ever needed, so the same code runs single-process on a
    # virtual mesh and SPMD across hosts under jax.distributed.
    @jax.jit
    def run(key):
        keys = jax.random.split(key, n_particles)
        keys = jax.lax.with_sharding_constraint(keys, p_shard)
        return jax.vmap(particle)(keys)

    log_w, predicts = run(key)
    return ImportanceResult(log_w, predicts)
