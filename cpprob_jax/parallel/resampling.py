"""Distributed resampling over a particle-sharded mesh.

Runs inside ``jax.shard_map`` bodies: per-shard weight slices, XLA collectives
for the global quantities (SURVEY.md §2.7's plan; algorithmic shape
follows Murray et al., 'Parallel resampling in the particle filter',
arXiv:1301.4019).

Two schemes:

- ``collective``: *exact* global systematic resampling.  Per-shard prefix sums
  + a small ``all_gather`` of shard totals build the global CDF offsets; the
  comb positions for this shard's output slots are matched against the
  all-gathered CDF; ancestor states are fetched by global index from the
  all-gathered states.  O(N) total comm per resampling epoch, triggered only
  when ESS collapses.

- ``island``: zero-data-motion approximation (island particle model, Vergé
  et al. 2013): each shard resamples locally; shard-level weight totals are
  carried as island weights.  Only scalar collectives cross cards — the
  fast path for throughput benchmarks at very large N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special

from ..inference.resampling import (
    _exclusive,
    _last,
    comb_ticks,
    fill_ancestors,
    slot_add,
    slot_prefix,
    slot_units,
    systematic_starts,
)

__all__ = [
    "global_ess",
    "global_log_mean_exp",
    "sharded_systematic_ancestors",
    "ring_systematic_resample",
    "balanced_systematic_resample",
    "local_systematic_ancestors",
]


def global_log_mean_exp(log_w_local: jax.Array, axis_name: str) -> jax.Array:
    """logmeanexp over the full sharded weight vector (replicated result)."""
    n_local = log_w_local.shape[0]
    k = jax.lax.psum(1, axis_name)
    m_local = jnp.max(log_w_local)
    m = jax.lax.pmax(m_local, axis_name)
    s = jax.lax.psum(jnp.sum(jnp.exp(log_w_local - m)), axis_name)
    return m + jnp.log(s) - jnp.log(jnp.asarray(n_local * k, jnp.float32))


def global_ess(log_w_local: jax.Array, axis_name: str) -> jax.Array:
    """Kish ESS of the full sharded weight vector (replicated result)."""
    m = jax.lax.pmax(jnp.max(log_w_local), axis_name)
    w = jnp.exp(log_w_local - m)
    s1 = jax.lax.psum(jnp.sum(w), axis_name)
    s2 = jax.lax.psum(jnp.sum(w * w), axis_name)
    return (s1 * s1) / s2


def _global_starts(u0, log_w_local, axis_name):
    """Global systematic slot arithmetic over the sharded population, exact
    (see ``inference/resampling.py``): this shard's particles' first output
    slots (n_local,) and the replicated (k,) inclusive slot boundaries of
    the shards' weight segments (shard s owns slots [bounds[s-1], bounds[s])).
    Only scalars cross cards."""
    n_local = log_w_local.shape[0]
    my = jax.lax.axis_index(axis_name)
    n_total = n_local * jax.lax.psum(1, axis_name)
    m = jax.lax.pmax(jnp.max(log_w_local), axis_name)
    w = jnp.exp(log_w_local - m)
    sums = jax.lax.all_gather(jnp.sum(w), axis_name)
    local = slot_prefix(*slot_units(w, jnp.float32(n_total) / jnp.sum(sums)))
    seg = slot_prefix(*(jax.lax.all_gather(x[-1], axis_name) for x in local))
    offset = tuple(x[my] for x in _exclusive(seg))
    total = _last(seg)
    starts = comb_ticks(slot_add(_exclusive(local), offset), total, u0,
                        n_total)
    bounds = comb_ticks(seg, total, u0, n_total).at[-1].set(n_total)
    return starts, bounds


def sharded_systematic_ancestors(
    u0: jax.Array, log_w_local: jax.Array, axis_name: str
) -> jax.Array:
    """Exact global systematic resampling: returns *global* ancestor indices
    (int32, shape (n_local,)) for this shard's output slots
    [my*n_local, (my+1)*n_local).

    ``u0`` must be the same uniform on every shard (replicated key).
    """
    n_local = log_w_local.shape[0]
    my = jax.lax.axis_index(axis_name)
    n_total = n_local * jax.lax.psum(1, axis_name)
    starts, _ = _global_starts(u0, log_w_local, axis_name)
    # scatter+cummax over the full comb (no binary search), then slice this
    # shard's output slots
    full = jax.lax.all_gather(starts, axis_name).reshape(n_total)
    anc_full = fill_ancestors(full, n_total)
    return jax.lax.dynamic_slice(anc_full, (my * n_local,), (n_local,))


def ring_systematic_resample(
    u0: jax.Array, log_w_local: jax.Array, states_local, axis_name: str
):
    """Exact global systematic resampling with **O(N/shard) peak memory**:
    no all-gather of the population or its CDF.

    The full-materialization version (:func:`sharded_systematic_ancestors` +
    an ``all_gather`` of every shard's states) replicates O(N) memory and
    traffic per epoch — the SURVEY §7 hard part this removes.  Here the
    (states, start slots) block of each shard travels around the ring
    (``ppermute``, k-1 hops); when block ``s`` passes through, a shard fills
    exactly those of its output slots that block ``s``'s weight segment owns
    (Murray et al. arXiv:1301.4019 §IV's distributed inverse-CDF,
    restructured as a ring so per-shard memory stays O(n_local) and the hops
    pipeline over the interconnect).

    Produces bitwise the same resampled population as the materializing path:
    both read the same exact integer start slots, so block boundaries are
    integers that partition the output slots, and a slot's owner is the last
    particle starting at or before it.

    ``u0`` must be the same uniform on every shard.  Returns this shard's
    slice of the resampled population (tree like ``states_local``).
    """
    n_local = log_w_local.shape[0]
    my = jax.lax.axis_index(axis_name)
    k = jax.lax.psum(1, axis_name)
    starts, bounds = _global_starts(u0, log_w_local, axis_name)
    lo_b = jnp.concatenate([jnp.zeros((1,), jnp.int32), bounds[:-1]])

    # MY output slots
    j = my * n_local + jnp.arange(n_local, dtype=jnp.int32)
    out0 = jax.tree_util.tree_map(jnp.zeros_like, states_local)

    def round_body(r, carry):
        cur_states, cur_starts, out = carry
        s = jnp.mod(my - r, k)                  # block currently held
        inb = (j >= lo_b[s]) & (j < bounds[s])
        t = jnp.searchsorted(cur_starts, j, side="right") - 1
        t = jnp.clip(t, 0, n_local - 1).astype(jnp.int32)
        out = jax.tree_util.tree_map(
            lambda o, bs: jnp.where(
                inb.reshape((-1,) + (1,) * (o.ndim - 1)), bs[t], o
            ),
            out, cur_states,
        )
        # pass my current block to the right neighbor
        perm = [(i, (i + 1) % int(k)) for i in range(int(k))]
        nxt_states = jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, axis_name, perm), cur_states
        )
        return nxt_states, jax.lax.ppermute(cur_starts, axis_name, perm), out

    carry = (states_local, starts, out0)
    # k (mesh size) is static inside shard_map; unrolled Python loop keeps
    # the comm pattern explicit and lets XLA overlap hop r+1 with match r
    for r in range(int(k)):
        carry = round_body(r, carry)
    return carry[2]


def balanced_systematic_resample(
    u0: jax.Array, log_w_local: jax.Array, states_local, axis_name: str,
    bound: int | None = None, fallback: str = "ring",
):
    """Exact global systematic resampling with **O(bound) communication** —
    the scalable exact scheme for continuous (scalar or vector) states.

    Two-level decomposition of the natural-index-order systematic resample
    (Murray et al. arXiv:1301.4019 §V "resampling with redistribution",
    restructured for static shapes + ring neighbors):

    1. *Segment boundaries from scalars.*  The global comb is partitioned by
       shard: shard ``s``'s weight segment receives output slots
       ``[ticks[s-1], ticks[s])``, the exact integer slot boundaries
       computed identically on every shard from the all-gathered (k,) shard
       weight totals — the slot ranges partition [0, N) by construction.
    2. *Local production.*  Each shard computes the ancestors of its own
       produced slots against its local CDF (no particle data needed from
       anyone).  Offspring counts per shard deviate from ``n_local`` only by
       the cross-shard weight imbalance: ``ticks[s] - (s+1)*n_local =
       N*(B_s - (s+1)/k)``, which concentrates at O(cv * sqrt(N)) particles
       (cv = weight coefficient of variation; cv^2 = 1 at a 0.5-ESS
       trigger) — NOT O(N).
    3. *Boundary redistribution.*  The produced populations are re-balanced
       to ``n_local`` per shard by exchanging two fixed-size ``bound``-row
       buffers with the ring neighbors (``ppermute``).  Comm per shard per
       epoch: 2*bound rows vs the ring scheme's (k-1)*n_local — at 2^26
       particles per card, kilobytes instead of gigabytes.

    Exactness: identical in distribution to single-device systematic
    resampling (natural index order is a fixed exchangeable order); when the
    imbalance fits the bound it is slot-for-slot the same population as
    :func:`ring_systematic_resample`.  If the replicated imbalance check
    fails (pathological weight concentration on one shard), the epoch falls
    back to the exact ring inside ``lax.cond`` — correctness never degrades,
    only that epoch's comm.

    ``bound`` defaults to ``max(1024, n_local // 64)``; raise it if the
    fallback fires often at extreme shard counts.  ``u0`` must be replicated.
    Returns this shard's slice (tree like ``states_local``).
    """
    n_local = log_w_local.shape[0]
    my = jax.lax.axis_index(axis_name)
    k = jax.lax.psum(1, axis_name)
    if bound is None:
        bound = max(1024, n_local // 64)
    bound = min(bound, n_local)

    # -- 1. segment slot boundaries, replicated-deterministic ---------------
    starts, ticks = _global_starts(u0, log_w_local, axis_name)
    t_lo = jnp.where(my == 0, 0, ticks[jnp.maximum(my - 1, 0)])
    t_hi = ticks[my]

    # replicated imbalance check (pmax makes every shard agree)
    dev = jnp.maximum(
        jnp.abs(t_lo - my * n_local), jnp.abs(t_hi - (my + 1) * n_local)
    )
    fits = jax.lax.pmax(dev, axis_name) <= bound

    def balanced_path(_):
        # -- 2. local production into a static (n_local + 2*bound) buffer --
        cap = n_local + 2 * bound
        r = jnp.arange(cap, dtype=jnp.int32)
        j = t_lo + r                                     # produced slot ids
        valid = j < t_hi
        t = jnp.searchsorted(starts, j, side="right") - 1
        t = jnp.clip(t, 0, n_local - 1).astype(jnp.int32)
        produced = jax.tree_util.tree_map(lambda s: s[t], states_local)
        # mark invalid rows' slots out-of-band so assembly ignores them
        j_eff = jnp.where(valid, j, jnp.int32(-1))

        # -- 3. boundary redistribution with ring neighbors -----------------
        # head rows (smallest produced slots) belong to the LEFT neighbor's
        # target range when t_lo < my*n_local; tail rows to the RIGHT's
        perm_l = [(i, (i - 1) % int(k)) for i in range(int(k))]
        perm_r = [(i, (i + 1) % int(k)) for i in range(int(k))]

        head = jax.tree_util.tree_map(lambda x: x[:bound], produced)
        head_j = j_eff[:bound]
        n_mine = jnp.clip(t_hi - t_lo, 0, cap)
        tail_start = jnp.clip(n_mine - bound, 0, cap - bound)
        tail = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, tail_start, bound),
            produced,
        )
        tail_j = jax.lax.dynamic_slice_in_dim(j_eff, tail_start, bound)

        recv_from_right = jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, axis_name, perm_l), head
        )
        recv_from_right_j = jax.lax.ppermute(head_j, axis_name, perm_l)
        recv_from_left = jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, axis_name, perm_r), tail
        )
        recv_from_left_j = jax.lax.ppermute(tail_j, axis_name, perm_r)

        # -- assembly of my target slots [my*n_local, (my+1)*n_local) -------
        base = my * n_local
        i = jnp.arange(n_local, dtype=jnp.int32)

        def assemble(prod, rl, rr):
            # own contribution: produced rows are CONTIGUOUS in slot order,
            # so my slots are the shifted slice starting at (base - t_lo) —
            # a dynamic_slice instead of an n_local-row gather (r5; the
            # fits check guarantees |base - t_lo| <= bound, so slicing the
            # bound-padded buffer never clamps)
            own_ok = (base + i >= t_lo) & (base + i < t_hi)
            expand = (slice(None),) + (None,) * (prod.ndim - 1)
            padded = jnp.concatenate(
                [jnp.zeros((bound,) + prod.shape[1:], prod.dtype), prod]
            )
            own = jax.lax.dynamic_slice_in_dim(
                padded, base - t_lo + bound, n_local
            )
            out = jnp.where(own_ok[expand], own, jnp.zeros_like(
                prod, shape=(n_local,) + prod.shape[1:]))
            # neighbor contributions: scatter by slot index (each slot has a
            # unique producer, so no collisions; invalid rows scatter to the
            # out-of-range index n_local and are dropped)
            for buf, bj in ((rl, recv_from_left_j), (rr, recv_from_right_j)):
                rel = bj - base
                ok = (rel >= 0) & (rel < n_local)
                idx = jnp.where(ok, rel, n_local)
                out = out.at[idx].set(buf, mode="drop")
            return out

        return jax.tree_util.tree_map(
            assemble, produced, recv_from_left, recv_from_right
        )

    def ring_path(_):
        return ring_systematic_resample(u0, log_w_local, states_local,
                                        axis_name)

    if fallback == "none":
        # no exact-ring fallback compiled in: callers that size ``bound``
        # for their weight regime skip the fallback branch entirely (also
        # used to extract the scheme's true on-wire bytes from the
        # compiled HLO — the cond's untaken ring branch would otherwise
        # pollute the collective-op count)
        return balanced_path(None)
    return jax.lax.cond(fits, balanced_path, ring_path, operand=None)


def local_systematic_ancestors(
    u0: jax.Array, log_w_local: jax.Array, axis_name: str
) -> jax.Array:
    """Island-model resampling: systematic within the shard only; returns
    *local* ancestor indices.  The caller keeps the island's mean weight as
    the carried log-weight so evidence estimates stay unbiased at the island
    level."""
    n_local = log_w_local.shape[0]
    w = jnp.exp(log_w_local - jnp.max(log_w_local))
    # decorrelate the comb across shards
    u = jnp.mod(u0 + jax.lax.axis_index(axis_name).astype(jnp.float32)
                * 0.6180339887, 1.0)
    return fill_ancestors(systematic_starts(w, u, n_local), n_local)
