"""Compensated (Kahan/Neumaier) floating-point accumulation helpers.

At >=10^7 particles a sequential f32 running sum of exp-shifted weights
loses ~log10(n_chunks) digits; the reference side-steps this by writing
per-trace doubles to disk (``state.cpp:262-267``).  On accelerators
f64 is slow (or emulated), so instead we carry an explicit compensation term
(Neumaier's variant of Kahan summation) alongside each running sum.
Error stays O(eps) independent of chunk count, matching f64 ground
truth to f32 resolution.  Used by :func:`cpprob_jax.inference.sis
.sis_streaming` for its streaming log-weight/moment merge.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["CompSum", "comp_zero", "comp_add", "comp_scale", "comp_value"]


class CompSum(NamedTuple):
    """A compensated running sum: ``value`` + ``comp`` (error term)."""

    value: jax.Array
    comp: jax.Array


def comp_zero(like) -> CompSum:
    z = jnp.zeros_like(jnp.asarray(like))
    return CompSum(z, z)


def _two_sum(a, b):
    """Error-free transformation: a + b = s + err exactly (Knuth)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def comp_add(acc: CompSum, x) -> CompSum:
    """Neumaier-compensated ``acc + x``."""
    s, err = _two_sum(acc.value, jnp.asarray(x, acc.value.dtype))
    return CompSum(s, acc.comp + err)


def comp_scale(acc: CompSum, a) -> CompSum:
    """Scale both the sum and its compensation by ``a`` (a <= 1 rescale,
    as in a max-shift logsumexp merge, keeps the invariant exact enough:
    the product error is O(eps * value) and absorbed next add)."""
    return CompSum(acc.value * a, acc.comp * a)


def comp_value(acc: CompSum) -> jax.Array:
    """Collapse to the best available estimate of the true sum."""
    return acc.value + acc.comp
