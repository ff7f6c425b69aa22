"""Mesh-sharded SMC: particles sharded over the mesh, time as ``lax.scan``,
resampling via collectives — the vectorized replacement for the reference's
nonexistent distributed story (SURVEY.md §2.7) and the core of the BASELINE
north-star (≥10M particles/s/chip, ≥85% weak scaling).

The whole sweep is ONE ``shard_map``-ped, jitted program: XLA sees per-chip
kernels with explicit ``psum``/``all_gather``/``pmax`` collectives only at the
ESS check and at (rare, ESS-triggered) resampling epochs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..inference.resampling import systematic_ticks
from ..inference.smc import StateSpaceModel
from .mesh import PARTICLE_AXIS, particle_mesh
from .resampling import (
    balanced_systematic_resample,
    global_ess,
    global_log_mean_exp,
    local_systematic_ancestors,
    ring_systematic_resample,
)

__all__ = ["ShardedSMCResult", "smc_sharded"]


class ShardedSMCResult(NamedTuple):
    final_states: jax.Array      # (N, ...) sharded over particles
    final_log_weights: jax.Array  # (N,) sharded
    log_evidence: jax.Array      # scalar (replicated)
    ess_history: jax.Array       # (T,) global ESS before each step
    resampled: jax.Array         # (T,) bool
    tracked: Optional[jax.Array]  # (T, ...) weighted means of track_fn, or None


def smc_sharded(
    model: StateSpaceModel,
    observations: jax.Array,
    n_particles: int,
    key: jax.Array,
    *,
    mesh: Optional[Mesh] = None,
    ess_threshold: float = 0.5,
    scheme: str = "collective",
    track_fn: Optional[Callable] = None,
    balance_bound: Optional[int] = None,
    chunk: int = 1,
) -> ShardedSMCResult:
    """Run SMC with the particle axis sharded over ``mesh``.

    ``scheme='collective'``: exact global systematic resampling (all-gather of
    the weight CDF + ancestor states).  ``scheme='balanced'``: exact global
    systematic resampling with **O(balance_bound) comm per epoch** — the
    scalable exact scheme for continuous (scalar or vector) states: scalar
    collectives pick per-shard offspring segments, production is local, and
    only fixed-size boundary buffers cross cards (automatic exact-ring
    fallback when cross-shard weight imbalance exceeds the bound; see
    :func:`~cpprob_jax.parallel.resampling.balanced_systematic_resample`).
    ``scheme='island'``: shard-local resampling, island weights carried in
    the particle weights — zero data motion, scalar collectives only.
    ``scheme='exchange'`` (discrete scalar states, requires
    ``model.state_categories``): exact global systematic resampling under the
    sorted-by-state exchangeable ordering — the resample is a ``psum`` of K
    category weights + O(K) scalar math, and each shard synthesizes its slice
    of the sorted global population from its global slot range.  No particle
    data crosses cards at all (see ``inference/resampling.py`` for the
    statistical argument).

    ``chunk`` > 1 (``scheme='exchange'``, a model with the fused discrete
    hooks of :func:`~cpprob_jax.ops.pallas_ssm.make_fused_discrete_ssm`,
    ``track_fn=None``): each shard runs the fused chunk kernel on its slice,
    ``chunk`` timesteps per call; the ESS check and the exchange resample
    move to chunk boundaries and cross cards as scalars only.
    """
    mesh = mesh or particle_mesh()
    n_dev = mesh.size
    if n_particles % n_dev != 0:
        raise ValueError(f"n_particles must divide by mesh size {n_dev}")
    n_local = n_particles // n_dev
    if scheme not in ("collective", "balanced", "island", "exchange"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if scheme == "exchange" and model.state_categories is None:
        raise ValueError(
            "scheme='exchange' needs a discrete state space "
            "(model.state_categories)"
        )
    if chunk > 1:
        if (scheme != "exchange" or model.fused_chunk_exchange_batch is None
                or model.fused_init_batch is None):
            raise ValueError(
                "chunk > 1 needs scheme='exchange' and a model with the fused "
                "discrete chunk and init hooks"
            )
        if track_fn is not None:
            raise ValueError("chunk > 1 does not support track_fn")
        return _smc_sharded_fused(
            model, observations, n_particles, key, mesh=mesh,
            ess_threshold=ess_threshold, chunk=chunk,
        )
    T = observations.shape[0]

    def shard_body(key_rep, obs):
        axis = PARTICLE_AXIS
        my = jax.lax.axis_index(axis)

        def local_keys(tag):
            k = jax.random.fold_in(key_rep, tag)
            k = jax.random.fold_in(k, my)
            return jax.random.split(k, n_local)

        # --- init (t = 0) ---
        init_keys = local_keys(0)
        states = jax.vmap(model.init_sample)(init_keys)
        log_w = jax.vmap(lambda s: model.obs_logpdf(s, obs[0], 0))(states)

        def resample(t, states, log_w, log_z):
            u_key = jax.random.fold_in(key_rep, 1_000_000 + 7)
            u0 = jax.random.uniform(jax.random.fold_in(u_key, t), ())
            if scheme == "collective":
                # exact global systematic resample with O(N/shard) peak
                # memory: ring ppermute of (states, CDF-segment) blocks —
                # never materializes the population or its CDF anywhere
                new_states = ring_systematic_resample(u0, log_w, states, axis)
                new_log_z = log_z + global_log_mean_exp(log_w, axis)
                return new_states, jnp.zeros_like(log_w), new_log_z
            elif scheme == "balanced":
                # exact, O(bound) comm; exact-ring fallback inside
                new_states = balanced_systematic_resample(
                    u0, log_w, states, axis, bound=balance_bound
                )
                new_log_z = log_z + global_log_mean_exp(log_w, axis)
                return new_states, jnp.zeros_like(log_w), new_log_z
            elif scheme == "exchange":
                K = model.state_categories
                # global max-shift for stable exp
                m = jax.lax.pmax(jnp.max(log_w), axis)
                w = jnp.exp(log_w - m)
                onehot = (
                    states[:, None]
                    == jnp.arange(K, dtype=states.dtype)[None, :]
                ).astype(w.dtype)
                cat_w = jax.lax.psum(w @ onehot, axis)      # (K,) global
                ticks = systematic_ticks(u0, cat_w, n_particles)
                # shard fills its global slot range [my*n_local, ...)
                j = my * n_local + jnp.arange(n_local, dtype=jnp.int32)
                new_states = jnp.sum(
                    (j[:, None] >= ticks[None, :-1]).astype(states.dtype),
                    axis=1,
                )
                new_log_z = log_z + global_log_mean_exp(log_w, axis)
                return new_states, jnp.zeros_like(log_w), new_log_z
            else:  # island
                anc = local_systematic_ancestors(u0, log_w, axis)
                new_states = jax.tree_util.tree_map(lambda s: s[anc], states)
                m = jnp.max(log_w)
                island_lw = m + jnp.log(jnp.mean(jnp.exp(log_w - m)))
                return new_states, jnp.full_like(log_w, island_lw), log_z

        def step(carry, y_and_t):
            y_t, t = y_and_t
            states, log_w, log_z = carry

            ess = global_ess(log_w, axis)
            do_resample = ess < ess_threshold * n_particles

            states_r, log_w_r, log_z_r = jax.lax.cond(
                do_resample,
                lambda _: resample(t, states, log_w, log_z),
                lambda _: (states, log_w, log_z),
                operand=None,
            )

            prop_keys = jax.vmap(
                lambda i: jax.random.fold_in(
                    jax.random.fold_in(jax.random.fold_in(key_rep, 2_000_000), t),
                    my * n_local + i,
                )
            )(jnp.arange(n_local))
            new_states = jax.vmap(lambda k, s: model.step_sample(k, s, t))(
                prop_keys, states_r
            )
            new_log_w = log_w_r + jax.vmap(
                lambda s: model.obs_logpdf(s, y_t, t)
            )(new_states)

            tracked = None
            if track_fn is not None:
                vals = jax.vmap(track_fn)(new_states)
                m = jax.lax.pmax(jnp.max(new_log_w), axis)
                w = jnp.exp(new_log_w - m)
                num = jax.lax.psum(jnp.sum(w * vals), axis)
                den = jax.lax.psum(jnp.sum(w), axis)
                tracked = num / den

            return (new_states, new_log_w, log_z_r), (ess, do_resample, tracked)

        ts = jnp.arange(1, T)
        (states_f, log_w_f, log_z), (ess_h, res_h, tracked_h) = jax.lax.scan(
            step, (states, log_w, jnp.zeros(())), (obs[1:], ts)
        )
        log_z = log_z + global_log_mean_exp(log_w_f, axis)
        return states_f, log_w_f, log_z, ess_h, res_h, tracked_h

    out_specs = (
        P(PARTICLE_AXIS),  # final states
        P(PARTICLE_AXIS),  # final log weights
        P(),               # log evidence (replicated)
        P(),               # ess history
        P(),               # resampled flags
        P(),               # tracked means
    )
    return _finish_smc_sharded(shard_body, mesh, out_specs, key,
                               observations, track_fn)


def _finish_smc_sharded(shard_body, mesh, out_specs, key, observations,
                        track_fn):
    if track_fn is None:
        # scan carries None through; drop from outputs
        def wrapper(key_rep, obs):
            s, w, z, e, r, _ = shard_body(key_rep, obs)
            return s, w, z, e, r
        mapped = jax.shard_map(
            wrapper, mesh=mesh, in_specs=(P(), P()), out_specs=out_specs[:5],
            check_vma=False,
        )
        run = jax.jit(mapped)
        s, w, z, e, r = run(key, observations)
        return ShardedSMCResult(s, w, z, e, r, None)
    mapped = jax.shard_map(
        shard_body, mesh=mesh, in_specs=(P(), P()), out_specs=out_specs,
        check_vma=False,
    )
    run = jax.jit(mapped)
    s, w, z, e, r, tr = run(key, observations)
    return ShardedSMCResult(s, w, z, e, r, tr)


def _smc_sharded_fused(
    model: StateSpaceModel,
    observations: jax.Array,
    n_particles: int,
    key: jax.Array,
    *,
    mesh: Mesh,
    ess_threshold: float,
    chunk: int,
) -> ShardedSMCResult:
    """Sharded SMC through the fused discrete kernel: each shard runs the
    init and chunk kernels on its slice with its own random streams.  The
    chunk-boundary ESS check and the exchange resample's K category weights
    are scalar collectives; each shard's kernel synthesizes its slice of the
    sorted resampled population from the global category ticks shifted to
    its slot range, so no particle data crosses cards."""
    from ..inference.smc import _chunk_observations

    n_local = n_particles // mesh.size

    def shard_body(key_rep, obs):
        axis = PARTICLE_AXIS
        my = jax.lax.axis_index(axis)

        def global_stats(out):
            # the hook's per-shard statistics, combined: with the common
            # shift m, shard mass S1 = n_local * exp(lme - m) and
            # S2 = S1^2 / ess
            s, w, ess, cat_w, lme = out
            m = jax.lax.pmax(lme, axis)
            s1 = n_local * jnp.exp(lme - m)
            s1_all = jax.lax.psum(s1, axis)
            s2_all = jax.lax.psum(
                jnp.where(s1 > 0, s1 * s1 / ess, 0.0), axis)
            return (s, w, s1_all * s1_all / s2_all,
                    jax.lax.psum(cat_w * s1, axis) / s1_all,
                    m + jnp.log(s1_all / n_particles))

        shard_key = jax.random.fold_in(
            jax.random.fold_in(key_rep, 2_000_000), my)
        u_key = jax.random.fold_in(key_rep, 1_000_000 + 7)
        states, log_w, ess, cat_w, lme = global_stats(model.fused_init_batch(
            jax.random.fold_in(shard_key, 0), n_local, obs[0]))
        ys_chunks, valid = _chunk_observations(obs, chunk)
        idx = 1 + jnp.arange(ys_chunks.shape[0], dtype=jnp.int32)

        def step(carry, xs):
            ys, n_valid, c = xs
            states, log_w, log_z, ess, cat_w, lme = carry
            do_resample = ess < ess_threshold * n_particles
            u0 = jax.random.uniform(jax.random.fold_in(u_key, c), ())
            ticks = (systematic_ticks(u0, cat_w, n_particles)[:-1]
                     - my * n_local)
            log_z = log_z + jnp.where(do_resample, lme, 0.0)
            out = global_stats(model.fused_chunk_exchange_batch(
                jax.random.fold_in(shard_key, c), states, log_w, ys,
                n_valid, do_resample.astype(jnp.int32), ticks))
            return (out[0], out[1], log_z) + out[2:], (ess, do_resample)

        carry0 = (states, log_w, jnp.zeros(()), ess, cat_w, lme)
        (states_f, log_w_f, log_z, _, _, lme_f), (ess_h, res_h) = (
            jax.lax.scan(step, carry0, (ys_chunks, valid, idx)))
        return states_f, log_w_f, log_z + lme_f, ess_h, res_h, None

    out_specs = (
        P(PARTICLE_AXIS), P(PARTICLE_AXIS), P(), P(), P(), P(),
    )
    return _finish_smc_sharded(shard_body, mesh, out_specs, key,
                               observations, None)
