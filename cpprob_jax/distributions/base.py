"""Distribution base protocol for the probabilistic runtime.

The reference (CPProb) bolts capabilities onto Boost.Random distributions through
trait template specializations (``include/cpprob/distributions/utils_base.hpp:6-28``:
``logpdf<D>``, ``proposal<D>``, ``normalise<D>`` ...).  Here a distribution is a
frozen JAX dataclass pytree with methods — batched, differentiable, and traceable
under ``jit``/``vmap``/``grad``:

- ``sample(key, sample_shape=())``   vectorized draw (counterpart of Boost's
  ``operator()(URNG&)``)
- ``log_prob(x)``                    counterpart of the ``logpdf`` trait
- ``cdf(x)`` (where defined)         counterpart of the ``normalise`` trait's
  CDF-mass machinery used for truncation
- ``proposal_type`` / default proposal mapping lives in
  :mod:`cpprob_jax.inference.csis` (a static table, not C++ templates).

Parameters are stored as pytree leaves so distributions can be created inside
jitted code, vmapped over particle batches, and sharded over device meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "Distribution",
    "dist_dataclass",
    "promote_to_result_dtype",
]


def dist_dataclass(cls):
    """Decorator: frozen dataclass registered as a JAX pytree.

    All fields are pytree leaves (data); mark static fields with
    ``dataclasses.field(metadata=dict(static=True))``.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    return jax.tree_util.register_dataclass(cls)


class Distribution:
    """Abstract base.  Subclasses are frozen dataclass pytrees.

    ``event_ndim``: number of trailing dimensions of a single draw (0 for
    scalar distributions, 1 for vector distributions such as the diagonal MVN).
    """

    event_ndim: int = 0
    # Discrete distributions return integer draws; continuous ones float.
    is_discrete: bool = False

    # -- shape helpers --------------------------------------------------
    @property
    def batch_shape(self) -> Tuple[int, ...]:
        shapes = [
            jnp.shape(leaf) for leaf in jax.tree_util.tree_leaves(self)
        ]
        if not shapes:
            return ()
        # lax broadcast of all param shapes, minus event dims
        result: Tuple[int, ...] = ()
        for s in shapes:
            result = jnp.broadcast_shapes(result, s)
        if self.event_ndim:
            result = result[: len(result) - self.event_ndim] if len(result) >= self.event_ndim else ()
        return result

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return ()

    # -- core API -------------------------------------------------------
    def sample(self, key: jax.Array, sample_shape: Tuple[int, ...] = ()) -> jax.Array:
        raise NotImplementedError

    def log_prob(self, x: Any) -> jax.Array:
        raise NotImplementedError

    def cdf(self, x: Any) -> jax.Array:  # optional
        raise NotImplementedError(f"{type(self).__name__} has no cdf")

    # Moments (used by postprocess + tests); optional.
    @property
    def mean(self) -> jax.Array:
        raise NotImplementedError

    @property
    def variance(self) -> jax.Array:
        raise NotImplementedError


def promote_to_result_dtype(*arrays):
    """Promote params to a common inexact dtype (f32 by default policy)."""
    dtype = jnp.result_type(*arrays, jnp.zeros((), jnp.float32))
    if not jnp.issubdtype(dtype, jnp.inexact):
        dtype = jnp.float32
    return tuple(jnp.asarray(a, dtype) for a in arrays)
