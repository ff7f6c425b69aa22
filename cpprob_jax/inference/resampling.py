"""Particle resampling schemes (systematic / stratified / multinomial /
residual) — all O(N) vectorized, jit-safe.

The reference has no resampling at all (no SMC — thesis ch. 6.3); these are
designed per 'Parallel resampling in the particle filter' (Murray et al.,
arXiv:1301.4019): inverse-CDF lookups against the weight prefix-sum, compiled as a vectorized
scatter + running max or binary search (``jnp.searchsorted``) — no
sequential scan on the critical path.  The multi-device (sharded prefix-sum +
collective) variant lives in :mod:`cpprob_jax.parallel.resampling`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special

__all__ = [
    "systematic_resample",
    "stratified_resample",
    "multinomial_resample",
    "residual_resample",
    "ess",
    "get_resampler",
    "category_weights",
    "category_counts_systematic",
    "states_from_counts",
    "exchange_resample_discrete",
    "continuous_resample_values",
    "continuous_resample_values_lme",
    "sorted_systematic_resample_values",
    "sorted_systematic_resample_values_nd",
    "morton_key",
    "systematic_starts",
    "systematic_ticks",
    "fill_ancestors",
]


# Systematic slot arithmetic.  Output slot j sits at comb position j + u0 in
# slot units, so a particle whose inclusive weight prefix is P slots hands
# over to the next particle at slot ceil(P - u0).  P runs up to n_out, where a
# float32 no longer resolves u0 or a single slot (above 2^24), so P is kept
# exactly: an int32 count of whole slots and a uint32 fraction in units of
# 2^-32 slot.  Fractions are summed modulo 2^32 and every wrap carries one
# whole slot, so any prefix sum, sequential or sharded, is exact.

_TWO32 = 4294967296.0


def slot_units(w: jax.Array, scale) -> tuple[jax.Array, jax.Array]:
    """Split the non-negative slot counts ``w * scale`` into int32 whole slots
    and uint32 fractions (both exact for the float32 product)."""
    x = w * scale
    whole = jnp.floor(x)
    frac = ((x - whole) * _TWO32).astype(jnp.uint32)
    return whole.astype(jnp.int32), frac


def slot_prefix(whole: jax.Array, frac: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Exact inclusive prefix sums of split slot counts."""
    f = jnp.cumsum(frac, dtype=jnp.uint32)
    wrapped = f < jnp.concatenate([jnp.zeros((1,), jnp.uint32), f[:-1]])
    return jnp.cumsum(whole + wrapped.astype(jnp.int32)), f


def slot_add(a, b):
    """Exact sum of two split slot counts (broadcasting)."""
    f = a[1] + b[1]
    return a[0] + b[0] + (f < a[1]).astype(jnp.int32), f


def _as_float(x):
    return x[0].astype(jnp.float32) + x[1].astype(jnp.float32) / _TWO32


def comb_ticks(prefix, total, u0, n_out: int) -> jax.Array:
    """ceil(P * n_out / S - u0) for split prefixes P of the split total S,
    clipped to [0, n_out]: the first comb slot past each prefix.  The
    float32 scaling leaves S within a few slots of n_out; the comb spans S
    exactly, and the shift P * (S - n_out) / S (a few slots at most) is the
    only float32 term, so the result is exact to about 1e-6 slot."""
    whole, frac = prefix
    excess = (total[0] - n_out).astype(jnp.float32) + total[1].astype(
        jnp.float32) / _TWO32
    q = _as_float(prefix) * (excess / (n_out + excess)) + u0
    q_whole = jnp.floor(q)
    q_frac = ((q - q_whole) * _TWO32).astype(jnp.uint32)
    return jnp.clip(whole - q_whole.astype(jnp.int32)
                    + (frac > q_frac).astype(jnp.int32), 0, n_out)


def _exclusive(prefix):
    """Shift inclusive split prefixes to exclusive ones (leading zero)."""
    return tuple(jnp.concatenate([jnp.zeros((1,), x.dtype), x[:-1]])
                 for x in prefix)


def _last(prefix):
    return tuple(x[-1] for x in prefix)


def systematic_starts(w: jax.Array, u0, n_out: int) -> jax.Array:
    """First output slot of each particle under the systematic comb
    (u0 + j)/n_out for unnormalized weights ``w``: particle i owns slots
    [starts[i], starts[i+1]).  int32, nondecreasing, in [0, n_out]."""
    incl = slot_prefix(*slot_units(w, jnp.float32(n_out) / jnp.sum(w)))
    return comb_ticks(_exclusive(incl), _last(incl), u0, n_out)


def systematic_ticks(u0, weights: jax.Array, n_out: int) -> jax.Array:
    """Inclusive slot boundaries of a few weight segments (e.g. the K
    category weights of the exchange resampler): segment k owns slots
    [ticks[k-1], ticks[k]); the last tick is ``n_out``."""
    incl = slot_prefix(*slot_units(weights,
                                   jnp.float32(n_out) / jnp.sum(weights)))
    return comb_ticks(incl, _last(incl), u0, n_out).at[-1].set(n_out)


def fill_ancestors(starts: jax.Array, n_out: int) -> jax.Array:
    """Ancestor of every output slot from nondecreasing start slots:
    scatter each index at its first slot and take a running max."""
    idx = jnp.arange(starts.shape[0], dtype=jnp.int32)
    slots = jnp.zeros((n_out,), jnp.int32).at[starts].max(idx, mode="drop")
    return jax.lax.cummax(slots)


def ess(log_weights: jax.Array) -> jax.Array:
    """Kish effective sample size 1/sum(w_i^2) of normalized weights."""
    lw = log_weights - jsp_special.logsumexp(log_weights)
    return jnp.exp(-jsp_special.logsumexp(2.0 * lw))


def _normalized_cumsum(log_weights: jax.Array) -> jax.Array:
    lw = log_weights - jsp_special.logsumexp(log_weights)
    w = jnp.exp(lw)
    c = jnp.cumsum(w)
    # Guard the tail against accumulated rounding so searchsorted never
    # falls off the end.
    return c / c[-1]


def _ancestors_from_positions(cdf: jax.Array, u: jax.Array) -> jax.Array:
    return jnp.clip(
        jnp.searchsorted(cdf, u, side="right"), 0, cdf.shape[0] - 1
    ).astype(jnp.int32)


def systematic_resample(key: jax.Array, log_weights: jax.Array, n_out: int | None = None) -> jax.Array:
    """Systematic resampling: one uniform, comb of N evenly spaced positions.

    Lowest-variance O(N) scheme; the standard choice for SMC on accelerators.
    Particle i owns output slots [ceil(P_{i-1} - u0), ceil(P_i - u0)) for its
    exact weight prefix P in slots: one scatter of each index at its first
    slot and one running max, no binary search.  Returns int32 ancestor
    indices of shape (n_out,).
    """
    n = log_weights.shape[0]
    n_out = n if n_out is None else n_out
    u0 = jax.random.uniform(key, ())
    w = jnp.exp(log_weights - jnp.max(log_weights))
    return fill_ancestors(systematic_starts(w, u0, n_out), n_out)


def stratified_resample(key: jax.Array, log_weights: jax.Array, n_out: int | None = None) -> jax.Array:
    """Stratified resampling: one uniform per stratum."""
    n = log_weights.shape[0]
    n_out = n if n_out is None else n_out
    u = jax.random.uniform(key, (n_out,), dtype=log_weights.dtype)
    positions = (u + jnp.arange(n_out, dtype=log_weights.dtype)) / n_out
    return _ancestors_from_positions(_normalized_cumsum(log_weights), positions)


def multinomial_resample(key: jax.Array, log_weights: jax.Array, n_out: int | None = None) -> jax.Array:
    """Multinomial resampling via Gumbel-free categorical draws."""
    n = log_weights.shape[0]
    n_out = n if n_out is None else n_out
    return jax.random.categorical(key, log_weights, shape=(n_out,)).astype(jnp.int32)


def residual_resample(key: jax.Array, log_weights: jax.Array, n_out: int | None = None) -> jax.Array:
    """Residual resampling, static-shape formulation.

    Deterministic copies floor(N*w_i) are implemented without dynamic shapes:
    ancestor slot j takes index i where the cumulative integer-copy count
    crosses j; leftover slots are filled multinomially from the residual
    weights.  Shape-static => jit safe.
    """
    n = log_weights.shape[0]
    n_out = n if n_out is None else n_out
    lw = log_weights - jsp_special.logsumexp(log_weights)
    w = jnp.exp(lw)
    counts = jnp.floor(n_out * w).astype(jnp.int32)
    n_det = jnp.sum(counts)
    # deterministic part: slot j -> smallest i with cumsum(counts) > j
    ccount = jnp.cumsum(counts)
    slots = jnp.arange(n_out, dtype=jnp.int32)
    det_idx = jnp.clip(
        jnp.searchsorted(ccount, slots, side="right"), 0, n - 1
    ).astype(jnp.int32)
    # residual multinomial part
    resid = n_out * w - counts
    resid_idx = jax.random.categorical(
        key, jnp.log(jnp.maximum(resid, 1e-38)), shape=(n_out,)
    ).astype(jnp.int32)
    return jnp.where(slots < n_det, det_idx, resid_idx)


# ---------------------------------------------------------------------------
# Exchange (sorted-category) systematic resampling for discrete state spaces.
#
# Random-access scatter/gather runs far below streaming bandwidth, so the
# classic ancestors+gather resample can dominate an SMC sweep.  For a
# *discrete* scalar state space the whole epoch collapses to arithmetic on K
# scalars:
#
#   Particles are exchangeable, so any fixed reordering before systematic
#   resampling is statistically valid (E[c_i] = N w_i holds for every order;
#   sorted orderings *reduce* resampling variance — the Hilbert/state-sort
#   idea of Gerber & Chopin's SQMC, and Murray et al. arXiv:1301.4019 §V).
#   Under the sort-by-state order, the systematic comb hits each category's
#   contiguous weight segment, so the offspring counts per category are
#   m_k = ceil(N B_k - u0) - ceil(N B_{k-1} - u0) with B_k the cumulative
#   *category* weights — and the resampled population is exactly "m_0 copies
#   of state 0, m_1 of state 1, ...", synthesizable from the slot index.
#   No per-particle CDF, no scatter, no gather: K masked reductions + O(K)
#   scalar math + one elementwise fill.
#
# The post-resample population equals a permutation of the true sorted-order
# systematic resample; since resampling resets weights and the downstream
# dynamics are iid per particle given the state, the permutation is
# distribution-preserving for the filter, the evidence estimate, and all
# moments (only per-particle genealogy is not tracked).
# ---------------------------------------------------------------------------


def category_weights(log_weights: jax.Array, states: jax.Array, n_categories: int) -> jax.Array:
    """Normalized total weight per category: W_k = sum_i w_i [s_i = k].

    One streaming pass + a (n, K) one-hot contraction (MXU) — no scatter.
    """
    lw = log_weights - jsp_special.logsumexp(log_weights)
    w = jnp.exp(lw)
    onehot = (
        states[:, None] == jnp.arange(n_categories, dtype=states.dtype)[None, :]
    ).astype(w.dtype)
    return w @ onehot


def category_counts_systematic(u0: jax.Array, cat_weights: jax.Array, n_out: int) -> jax.Array:
    """Exact systematic offspring counts per category under the
    sorted-by-state particle ordering.

    ``cat_weights``: (K,) category weights; ``u0``: uniform in [0, 1).
    Returns int32 (K,) counts summing to ``n_out``.
    """
    ticks = systematic_ticks(u0, cat_weights, n_out)
    prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), ticks[:-1]])
    return ticks - prev


def states_from_counts(counts: jax.Array, n_out: int, dtype=jnp.int32) -> jax.Array:
    """Materialize the sorted resampled population: counts[0] copies of 0,
    counts[1] copies of 1, ...  Pure elementwise compares (K passes)."""
    ticks = jnp.cumsum(counts)
    j = jnp.arange(n_out, dtype=jnp.int32)
    return jnp.sum(
        (j[:, None] >= ticks[None, :]).astype(dtype), axis=1
    )


def exchange_resample_discrete(
    key: jax.Array, log_weights: jax.Array, states: jax.Array,
    n_categories: int, n_out: int | None = None,
) -> jax.Array:
    """Systematic resampling of a discrete-state population under the
    sorted-by-state exchangeable ordering; returns the new (sorted) states
    directly — no ancestors, no gather."""
    n_out = log_weights.shape[0] if n_out is None else n_out
    u0 = jax.random.uniform(key, ())
    cat_w = category_weights(log_weights, states, n_categories)
    counts = category_counts_systematic(u0, cat_w, n_out)
    return states_from_counts(counts, n_out, dtype=states.dtype)


def sorted_systematic_resample_values(
    key: jax.Array, log_weights: jax.Array, states: jax.Array,
    n_out: int | None = None,
) -> jax.Array:
    """Systematic resampling of a **scalar continuous** state population under
    the sorted-by-value exchangeable ordering; returns the new (sorted) states
    directly — no ancestor indices, no per-particle gather.

    The continuous-state sibling of :func:`exchange_resample_discrete`.
    Particles are exchangeable, so sorting by state value before systematic
    resampling is statistically valid (and variance-reducing — the ordered
    stratification of Gerber & Chopin's SQMC / Murray et al. 1301.4019 §V).
    Under the sorted order the output population is itself sorted, so it can
    be synthesized by a *carry-forward fill*: scatter each input's value at
    its first output slot (:func:`systematic_starts`) and take a running
    max — correct because values are ascending.  Cost: one fused
    ``lax.sort`` pair + one monotone scatter + one ``cummax``; this replaces
    the ancestors+gather epoch and its random-access gather (see the
    exchange-resampler notes above).

    Genealogy is not tracked (the output order is the sorted order), so the
    engine only uses this when no filtering history is stored.
    """
    n = log_weights.shape[0]
    n_out = n if n_out is None else n_out
    sorted_s, sorted_lw = jax.lax.sort((states, log_weights), num_keys=1)
    u0 = jax.random.uniform(key, ())
    starts = systematic_starts(jnp.exp(sorted_lw - jnp.max(sorted_lw)), u0,
                               n_out)
    # Colliding starts (zero-count particles) resolve to the largest collider
    # via .max — under ascending order that is exactly the slot's true owner.
    fill = jnp.full((n_out,), -jnp.inf, sorted_s.dtype)
    fill = fill.at[starts].max(sorted_s, mode="drop")
    return jax.lax.cummax(fill)


def sorted_systematic_resample_values_nd(key, log_weights, states,
                                         sort_key=None):
    """Systematic resampling of a **vector continuous** (n, D) population
    under a sorted-by-key exchangeable ordering; returns the new population
    directly (no genealogy).

    The vector sibling of :func:`sorted_systematic_resample_values`
   .  Any fixed
    value-derived key is a valid exchangeable ordering; sorting by a
    locality-preserving key reduces resampling variance (Gerber & Chopin's
    SQMC Hilbert ordering) — the default key is the first state coordinate
    (``sort_key=lambda s: s[:, 0]``); pass a Hilbert/Morton key for tighter
    stratification in higher D.  Unlike the scalar path, D-dim values cannot
    carry-forward fill, so ancestors are synthesized by the monotone
    scatter+cummax (exact) and applied with one gather of the sorted
    population — still ~2x cheaper than the unsorted ancestors path (the
    scatter is monotone) and it keeps the genealogy-free contract the fused
    chunk engines need.
    """
    n = log_weights.shape[0]
    keys_v = states[:, 0] if sort_key is None else sort_key(states)
    order = jnp.argsort(keys_v)
    sorted_s = states[order]
    sorted_lw = log_weights[order]
    u0 = jax.random.uniform(key, ())
    starts = systematic_starts(jnp.exp(sorted_lw - jnp.max(sorted_lw)), u0, n)
    return sorted_s[fill_ancestors(starts, n)]


def morton_key(states, bits: int = 10):
    """Z-order (Morton) sort key for (n, D) states, D <= 3: coordinates are
    rank-normalized to ``bits``-bit integers and bit-interleaved.  A
    locality-preserving key for :func:`sorted_systematic_resample_values_nd`
    — the practical stand-in for the Hilbert ordering of Gerber & Chopin's
    SQMC (Z-order preserves locality almost as well and is branch-free).
    """
    n, d = states.shape
    if d > 3:
        raise ValueError(f"morton_key supports D <= 3, got {d}")
    # rank-normalize each coordinate (robust to scale/outliers)
    ranks = jnp.argsort(jnp.argsort(states, axis=0), axis=0)
    q = (ranks * ((1 << bits) - 1) // jnp.maximum(n - 1, 1)).astype(jnp.uint32)

    def spread(x):
        # insert d-1 zero bits between the bits of x
        out = jnp.zeros_like(x)
        for b in range(bits):
            out = out | (((x >> b) & 1) << (b * d))
        return out

    keyv = jnp.zeros((n,), jnp.uint32)
    for j in range(d):
        keyv = keyv | (spread(q[:, j]) << j)
    return keyv


def continuous_resample_values(key, log_weights, states):
    """Systematic resample of a scalar or vector continuous population,
    returning the new value population directly (no genealogy): the
    sorted-key epoch for (n, D) states, sorted-fill for scalar states."""
    if getattr(states, "ndim", 0) == 2:
        return sorted_systematic_resample_values_nd(key, log_weights, states)
    return sorted_systematic_resample_values(key, log_weights, states)


def continuous_resample_values_lme(key, log_weights, states):
    """Like :func:`continuous_resample_values` but also returns
    ``log_mean_exp(log_weights)`` (the evidence increment)."""
    n = log_weights.shape[0]
    lme = jax.scipy.special.logsumexp(log_weights) - jnp.log(float(n))
    return continuous_resample_values(key, log_weights, states), lme


_RESAMPLERS = {
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "multinomial": multinomial_resample,
    "residual": residual_resample,
}


def get_resampler(name: str):
    try:
        return _RESAMPLERS[name]
    except KeyError:
        raise ValueError(
            f"unknown resampler {name!r}; choose from {sorted(_RESAMPLERS)}"
        ) from None
