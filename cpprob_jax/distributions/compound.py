"""Compound distributions: Mixture, Truncated, Dirac, ABC.

Counterparts of the reference's custom distribution classes
(``mixture.hpp``, ``truncated.hpp``, ``dirac_delta.hpp``, ``abc.hpp``) —
re-designed as pytrees:

- :class:`Mixture` stacks component parameters on a leading axis (a static
  component *count*, dynamic parameters) so component log-probs evaluate as one
  vectorized op instead of a loop.
- :class:`Truncated` samples by inverse-CDF when the base supports it (exact,
  branch-free, vectorizes well) and falls back to a bounded ``lax.while_loop``
  rejection sampler like the reference's 1e6-try loop (``truncated.hpp:84-102``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special

from .base import Distribution, dist_dataclass, promote_to_result_dtype

__all__ = ["Mixture", "Truncated", "Dirac", "ABC", "DefensiveMixture"]


@dist_dataclass
class Mixture(Distribution):
    """Finite mixture.  ``components`` is a single distribution pytree whose
    parameter leaves carry a leading component axis of size K; ``weights`` is
    an unnormalized (K,) vector (cf. ``mixture.hpp:14-160``, coefficients via
    ``discrete_distribution``)."""

    components: Any   # Distribution pytree with leading K axis on every leaf
    weights: jax.Array  # (K,)

    @property
    def num_components(self):
        return jnp.shape(self.weights)[-1]

    def _log_weights(self):
        (w,) = promote_to_result_dtype(self.weights)
        logw = jnp.log(w)
        return logw - jsp_special.logsumexp(logw, axis=-1, keepdims=True)

    def sample(self, key, sample_shape=()):
        k_choice, k_comp = jax.random.split(key)
        logw = self._log_weights()
        idx = jax.random.categorical(k_choice, logw, axis=-1, shape=sample_shape)
        if sample_shape == ():
            comp = jax.tree_util.tree_map(lambda leaf: leaf[idx], self.components)
            return comp.sample(k_comp)
        # Vectorized: draw one sample from every component for each output
        # element, then select — avoids data-dependent gather shapes.
        all_draws = jax.vmap(
            lambda d, k: d.sample(k, sample_shape),
            in_axes=(0, 0),
        )(self.components, jax.random.split(k_comp, self.num_components))
        return jnp.take_along_axis(
            jnp.moveaxis(all_draws, 0, -1), idx[..., None], axis=-1
        )[..., 0]

    def log_prob(self, x):
        logw = self._log_weights()
        comp_lp = jax.vmap(lambda d: d.log_prob(x))(self.components)  # (K, ...)
        logw_b = jnp.moveaxis(
            jnp.broadcast_to(logw, comp_lp.shape[1:] + logw.shape[-1:]), -1, 0
        ) if comp_lp.ndim > 1 else logw
        return jsp_special.logsumexp(comp_lp + logw_b, axis=0)

    def cdf(self, x):
        logw = self._log_weights()
        comp_cdf = jax.vmap(lambda d: d.cdf(x))(self.components)  # (K, ...)
        w = jnp.exp(logw)
        w_b = jnp.moveaxis(
            jnp.broadcast_to(w, comp_cdf.shape[1:] + w.shape[-1:]), -1, 0
        ) if comp_cdf.ndim > 1 else w
        return jnp.sum(w_b * comp_cdf, axis=0)

    @property
    def mean(self):
        w = jnp.exp(self._log_weights())
        comp_means = jax.vmap(lambda d: d.mean)(self.components)
        return jnp.sum(w * comp_means, axis=0)


@dist_dataclass
class Truncated(Distribution):
    """Truncation of ``base`` to [low, high] (cf. ``truncated.hpp``;
    logpdf = base logpdf − log CDF-mass, ``utils_truncated.hpp:16-27``)."""

    base: Any
    low: jax.Array
    high: jax.Array

    _MAX_REJECTION_TRIES = 1_000_000  # reference bound, truncated.hpp:84-102

    @property
    def is_discrete(self):  # type: ignore[override]
        return self.base.is_discrete

    def _log_mass(self):
        lo_cdf = self.base.cdf(self.low)
        hi_cdf = self.base.cdf(self.high)
        return jnp.log(hi_cdf - lo_cdf)

    def sample(self, key, sample_shape=()):
        base = self.base
        if hasattr(base, "icdf"):
            low, high = promote_to_result_dtype(self.low, self.high)
            u_lo = base.cdf(low)
            u_hi = base.cdf(high)
            shape = sample_shape + jnp.broadcast_shapes(
                jnp.shape(u_lo), jnp.shape(u_hi)
            )
            u = jax.random.uniform(key, shape, dtype=u_lo.dtype)
            u = u_lo + (u_hi - u_lo) * u
            # Clamp away from exactly 0/1 for ndtri stability.
            tiny = jnp.finfo(u.dtype).tiny
            u = jnp.clip(u, tiny, 1.0 - jnp.finfo(u.dtype).epsneg)
            return jnp.clip(base.icdf(u), low, high)
        return self._rejection_sample(key, sample_shape)

    def _rejection_sample(self, key, sample_shape):
        low = jnp.asarray(self.low)
        high = jnp.asarray(self.high)
        x0 = self.base.sample(key, sample_shape)

        def cond(carry):
            _, x, tries = carry
            bad = (x < low) | (x > high)
            return jnp.any(bad) & (tries < self._MAX_REJECTION_TRIES)

        def body(carry):
            k, x, tries = carry
            k, sub = jax.random.split(k)
            x_new = self.base.sample(sub, sample_shape)
            bad = (x < low) | (x > high)
            return k, jnp.where(bad, x_new, x), tries + 1

        _, x, _ = jax.lax.while_loop(cond, body, (key, x0, jnp.int32(0)))
        return jnp.clip(x, low, high)

    def log_prob(self, x):
        x = jnp.asarray(x)
        inside = (x >= self.low) & (x <= self.high)
        lp = self.base.log_prob(x) - self._log_mass()
        return jnp.where(inside, lp, -jnp.inf)

    def cdf(self, x):
        lo_cdf = self.base.cdf(self.low)
        hi_cdf = self.base.cdf(self.high)
        c = (self.base.cdf(x) - lo_cdf) / (hi_cdf - lo_cdf)
        return jnp.clip(c, 0.0, 1.0)


@dist_dataclass
class Dirac(Distribution):
    """Point mass (cf. ``dirac_delta.hpp``) — the sampler half of ABC pairs."""

    value: jax.Array

    def sample(self, key, sample_shape=()):
        v = jnp.asarray(self.value)
        return jnp.broadcast_to(v, sample_shape + jnp.shape(v))

    def log_prob(self, x):
        v = jnp.asarray(self.value)
        x = jnp.asarray(x)
        eq = x == v
        # reduce over event dims if value is a vector
        while eq.ndim > max(x.ndim, v.ndim) - max(v.ndim, 0):
            eq = jnp.all(eq, axis=-1)
        zero = jnp.zeros(jnp.shape(eq), promote_to_result_dtype(v)[0].dtype)
        return jnp.where(eq, zero, -jnp.inf)

    @property
    def mean(self):
        return jnp.asarray(self.value)


@dataclasses.dataclass(frozen=True)
class ABC(Distribution):
    """Approximate-Bayesian-computation 'distribution': an arbitrary sampler
    plus an arbitrary log-density for likelihood-free ``observe``
    (cf. ``abc.hpp:49-140``, ``make_abc``).  Both callables must be
    JAX-traceable.  This class is deliberately *not* a pytree of its callables;
    use it only at trace time (sample sites / observe sites), never as a carry.
    """

    sampler: Callable[[jax.Array], jax.Array]
    logpdf_fn: Callable[[Any], jax.Array]

    def sample(self, key, sample_shape=()):
        if sample_shape != ():
            keys = jax.random.split(key, int(jnp.prod(jnp.asarray(sample_shape))))
            flat = jax.vmap(self.sampler)(keys)
            return flat.reshape(sample_shape + flat.shape[1:])
        return self.sampler(key)

    def log_prob(self, x):
        return self.logpdf_fn(x)


def make_abc(sampler, logpdf_fn):
    """Counterpart of ``cpprob::make_abc`` (``abc.hpp``)."""
    return ABC(sampler, logpdf_fn)


@dist_dataclass
class DefensiveMixture(Distribution):
    """Two-component defensive mixture over arbitrary (different-family)
    distributions: ``(1-lam) * proposal + lam * anchor``.

    The classic defensive-importance-sampling construction (Hesterberg
    1995): mixing a learned proposal with the prior bounds the importance
    weights by ``prior/...  <= 1/lam`` at any point the proposal
    under-covers, trading a (1-lam) efficiency factor for robustness to
    proposal over-confidence — e.g. an amortized inverse model serving a
    tempered (wider-than-trained) posterior.  Unlike :class:`Mixture` the
    two components need not share a family or parameter pytree."""

    proposal: Any
    anchor: Any
    lam: Any  # mixing weight on the anchor, in (0, 1)

    def sample(self, key, sample_shape=()):
        k_choice, k_p, k_a = jax.random.split(key, 3)
        pick_anchor = (
            jax.random.uniform(k_choice, sample_shape) < self.lam
        )
        a = self.anchor.sample(k_a, sample_shape)
        p = self.proposal.sample(k_p, sample_shape)
        # components may carry event dims beyond sample_shape (e.g. MVN):
        # right-pad the per-draw pick with singleton axes so it broadcasts
        event_ndim = max(a.ndim, p.ndim) - pick_anchor.ndim
        if event_ndim > 0:
            pick_anchor = pick_anchor.reshape(
                pick_anchor.shape + (1,) * event_ndim
            )
        return jnp.where(pick_anchor, a, p)

    def log_prob(self, x):
        lam = jnp.asarray(self.lam, jnp.float32)
        return jnp.logaddexp(
            jnp.log1p(-lam) + self.proposal.log_prob(x),
            jnp.log(lam) + self.anchor.log_prob(x),
        )
