"""Sequential Monte Carlo with ESS-triggered systematic resampling.

NEW capability relative to the reference: "CPProb does not implement SMC yet"
(thesis ch. 6.3; SURVEY.md §6) — the thesis ran its SMC comparison in Anglican.
Design:

- particles are a ``vmap`` axis; time is a ``lax.scan``;
- resample-or-not is data-dependent => ``lax.cond`` over gather-vs-identity
  (both branches shape-static, SURVEY.md §7 'hard parts');
- per-step weight updates and the resampling inverse-CDF are O(N) vectorized;
- the multi-device version shards the particle axis over a mesh
  (:mod:`cpprob_jax.parallel.smc`).

Models enter through the :class:`StateSpaceModel` protocol (init/step/observe
log-densities) — the sequential decomposition the reference's trace-at-a-time
design cannot express.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special

from .resampling import ess as _ess
from .resampling import (
    category_counts_systematic,
    category_weights,
    get_resampler,
    continuous_resample_values_lme,
    states_from_counts,
    systematic_ticks,
)

__all__ = ["StateSpaceModel", "SMCResult", "smc", "make_smc_step"]


@dataclasses.dataclass(frozen=True)
class StateSpaceModel:
    """Sequential model protocol for SMC.

    ``init_sample(key) -> state`` and ``step_sample(key, state, t) -> state``
    draw from the prior/transition (the SMC proposal by default);
    ``*_logpdf`` evaluate the corresponding densities —
    ``step_logpdf(new_state, state, t)`` is log p(new_state | state) (NEW
    state first; the guided RN correction and particle-Gibbs ancestor
    weights call it with that order); ``obs_logpdf(state, y, t)`` is the
    emission density.  All callables must be JAX-traceable and operate
    on a *single* particle — the engine vmaps them.

    Optional ``proposal_sample`` / ``proposal_logpdf`` (signature like
    ``step_sample`` plus the current observation) switch SMC to guided mode.
    """

    init_sample: Callable
    init_logpdf: Callable
    step_sample: Callable
    step_logpdf: Callable
    obs_logpdf: Callable
    proposal_sample: Optional[Callable] = None
    proposal_logpdf: Optional[Callable] = None
    init_proposal_sample: Optional[Callable] = None
    init_proposal_logpdf: Optional[Callable] = None
    # Optional population-batched fast paths: one PRNG key, whole-population
    # shapes ((n, ...) states).  When set, the engine skips the per-particle
    # key split + vmap.
    init_sample_batch: Optional[Callable] = None      # (key, n) -> (n, ...)
    step_sample_batch: Optional[Callable] = None      # (key, states, t) -> (n, ...)
    obs_logpdf_batch: Optional[Callable] = None       # (states, y, t) -> (n,)
    # Fused chunk for discrete states (``ops.pallas_ssm``): ys.shape[0]
    # propagate+reweight updates in one call, with the (flagged) chunk-start
    # exchange resample done in-kernel from the K-1 category tick boundaries,
    # and streaming statistics of the new weights:
    # (key, states, log_w, ys, n_valid, flag, ticks) ->
    #     (s', w', ess', cat_w'(K,), lme')
    fused_chunk_exchange_batch: Optional[Callable] = None
    # Fused initialization (prior states + t=0 reweight + the same
    # statistics): (key, n, y0) -> (states, log_w, ess, cat_w(K,), lme).
    fused_init_batch: Optional[Callable] = None
    # Emission simulator (key, state, t) -> y, needed to train amortized
    # proposals on prior rollouts (compile-mode analogue for SSMs).
    obs_sample: Optional[Callable] = None
    # For *discrete scalar* state spaces: the number of states.  Enables the
    # exchange (sorted-category) systematic resampler — resampling via K
    # category counts instead of per-particle scatter/gather (see
    # inference/resampling.py).  Statistically exact for the filter/evidence;
    # per-particle genealogy is not tracked, so the engine only uses it when
    # no history is stored.
    state_categories: Optional[int] = None
    # For *scalar continuous* state spaces: enables the sorted-population
    # systematic resampler (sort + carry-forward fill — no per-particle
    # gather; see resampling.sorted_systematic_resample_values).  Same
    # no-genealogy caveat as state_categories.
    scalar_state: bool = False
    # For small-D *vector continuous* state spaces ((n, D) states): enables
    # the sorted-key systematic resampler
    # (resampling.sorted_systematic_resample_values_nd).  Same no-genealogy
    # caveat.
    vector_state_dim: Optional[int] = None


class SMCResult(NamedTuple):
    """Filtering history + evidence estimate."""

    states: jax.Array          # (T, N, ...) particles after propagation at each t
    log_weights: jax.Array     # (T, N) unnormalized log-weights at each t
    ancestors: jax.Array       # (T, N) ancestor indices used at each t (identity when no resample)
    resampled: jax.Array       # (T,) bool, whether resampling triggered
    log_evidence: jax.Array    # scalar log Z estimate
    final_states: jax.Array    # (N, ...)
    final_log_weights: jax.Array  # (N,)

    def filtered_mean(self, fn=lambda s: s):
        """E[fn(z_t) | y_{1:t}] per timestep from the stored history."""
        vals = jax.vmap(jax.vmap(fn))(self.states)  # (T, N, ...)
        lw = self.log_weights - jsp_special.logsumexp(
            self.log_weights, axis=1, keepdims=True
        )
        w = jnp.exp(lw)
        extra = vals.ndim - 2
        w = w.reshape(w.shape + (1,) * extra)
        return jnp.sum(w * vals, axis=1)


def _log_mean_exp(lw, axis=None):
    n = lw.shape[axis] if axis is not None else lw.size
    return jsp_special.logsumexp(lw, axis=axis) - jnp.log(float(n))


def make_smc_step(
    model: StateSpaceModel,
    n_particles: int,
    ess_threshold: float,
    resampler: Callable,
    store_history: bool = True,
    exchange: bool = False,
    sorted_fill: bool = False,
):
    """Build the scan body: (key, states, log_w, log_Z, ess), y_t -> carry.

    Resampling first (adaptive, on the **carried** ESS of the incoming
    weights, computed at the end of the previous step), then propagation and
    reweighting.  Both
    ``lax.cond`` branches are shape-static; the no-resample branch performs an
    identity gather so the compiled program has one code path.

    ``exchange=True`` (discrete scalar states, ``model.state_categories``)
    swaps the scatter/gather systematic resample for the sorted-category
    counts formulation — see :mod:`cpprob_jax.inference.resampling`.
    """
    guided = model.proposal_sample is not None

    def step(carry, y_t_and_t):
        y_t, t = y_t_and_t
        key, states, log_w, log_z, ess = carry
        key, k_res, k_prop = jax.random.split(key, 3)

        do_resample = ess < ess_threshold * n_particles

        if sorted_fill:
            def resample_branch(_):
                new_states, lme = continuous_resample_values_lme(
                    k_res, log_w, states
                )
                new_log_z = log_z + lme
                anc = jnp.arange(n_particles, dtype=jnp.int32)
                return new_states, jnp.zeros_like(log_w), new_log_z, anc
        elif exchange:
            def resample_branch(_):
                u0 = jax.random.uniform(k_res, ())
                cat_w = category_weights(
                    log_w, states, model.state_categories
                )
                counts = category_counts_systematic(u0, cat_w, n_particles)
                new_states = states_from_counts(
                    counts, n_particles, dtype=states.dtype
                )
                new_log_z = log_z + _log_mean_exp(log_w)
                anc = jnp.arange(n_particles, dtype=jnp.int32)
                return new_states, jnp.zeros_like(log_w), new_log_z, anc
        else:
            def resample_branch(_):
                anc = resampler(k_res, log_w)
                new_states = jax.tree_util.tree_map(lambda s: s[anc], states)
                new_log_z = log_z + _log_mean_exp(log_w)
                return new_states, jnp.zeros_like(log_w), new_log_z, anc

        def keep_branch(_):
            anc = jnp.arange(n_particles, dtype=jnp.int32)
            return states, log_w, log_z, anc

        states_r, log_w_r, log_z_r, anc = jax.lax.cond(
            do_resample, resample_branch, keep_branch, operand=None
        )

        if guided:
            prop_keys = jax.random.split(k_prop, n_particles)
            new_states = jax.vmap(
                lambda k, s: model.proposal_sample(k, s, t, y_t)
            )(prop_keys, states_r)
            rn = jax.vmap(
                lambda ns, s: model.step_logpdf(ns, s, t)
                - model.proposal_logpdf(ns, s, t, y_t)
            )(new_states, states_r)
        elif model.step_sample_batch is not None:
            new_states = model.step_sample_batch(k_prop, states_r, t)
            rn = jnp.zeros_like(log_w_r)
        else:
            prop_keys = jax.random.split(k_prop, n_particles)
            new_states = jax.vmap(
                lambda k, s: model.step_sample(k, s, t)
            )(prop_keys, states_r)
            rn = jnp.zeros_like(log_w_r)

        if model.obs_logpdf_batch is not None:
            obs_lp = model.obs_logpdf_batch(new_states, y_t, t)
        else:
            obs_lp = jax.vmap(
                lambda s: model.obs_logpdf(s, y_t, t)
            )(new_states)
        new_log_w = log_w_r + rn + obs_lp
        new_ess = _ess(new_log_w)

        if store_history:
            ys = (new_states, new_log_w, anc, do_resample)
        else:
            ys = (do_resample,)
        return (key, new_states, new_log_w, log_z_r, new_ess), ys

    return step


def make_smc_step_exchange_fused_chunked(
    model: StateSpaceModel,
    n_particles: int,
    ess_threshold: float,
):
    """Scan body over observation *chunks*: one fused kernel call per chunk
    (particles held in registers across the chunk's steps), resampling
    decided at chunk boundaries from the previous chunk's streaming stats.

    Blocked adaptive resampling: the ESS trigger is evaluated every
    chunk-size steps instead of every step.  The evidence estimator stays
    unbiased for any adapted resampling schedule; chunk size trades
    device-memory traffic (1/chunk per step) against resampling granularity.
    The resample itself is O(K) scalar math: the kernel synthesizes the
    sorted resampled population from the K-1 tick boundaries.
    """

    def step(carry, xs):
        ys, n_valid = xs                     # (C,), int32
        key, states, log_w, log_z, ess, cat_w, lme = carry
        key, k_res, k_prop = jax.random.split(key, 3)

        do_resample = ess < ess_threshold * n_particles
        u0 = jax.random.uniform(k_res, ())
        ticks = systematic_ticks(u0, cat_w, n_particles)[:-1]
        log_z_r = log_z + jnp.where(do_resample, lme, 0.0)

        new_states, new_log_w, new_ess, new_cat_w, new_lme = (
            model.fused_chunk_exchange_batch(
                k_prop, states, log_w, ys, n_valid,
                do_resample.astype(jnp.int32), ticks,
            )
        )
        return (
            (key, new_states, new_log_w, log_z_r, new_ess, new_cat_w, new_lme),
            (do_resample,),
        )

    return step


def _chunk_observations(observations, chunk: int):
    """Pad (T-1,) tail observations into (n_chunks, chunk) + valid counts."""
    ys = observations[1:]
    t_rest = ys.shape[0]
    n_chunks = -(-t_rest // chunk)
    pad = n_chunks * chunk - t_rest
    ys = jnp.pad(ys, (0, pad))
    valid = jnp.minimum(
        jnp.maximum(t_rest - jnp.arange(n_chunks) * chunk, 0), chunk
    ).astype(jnp.int32)
    return ys.reshape(n_chunks, chunk), valid


def build_smc_run(
    model: StateSpaceModel,
    n_particles: int,
    *,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    store_history: bool = False,
    chunk: int = 1,
):
    """Build ``run(key, observations) -> SMCResult`` once; jit and reuse it
    across calls (keeps the compilation cache warm for benchmarking and
    repeated inference).  ``store_history=False`` keeps only the final
    particle population (no (T, N) buffers; the filtering history costs 2
    full-population writes per step).

    A discrete model with a ``fused_chunk_exchange_batch`` hook (and no
    history, systematic resampling) runs the fused sweep: one kernel call per
    ``chunk`` timesteps, with the ESS resampling trigger evaluated at chunk
    boundaries (blocked adaptive resampling, still an unbiased evidence
    estimator).  ``chunk`` > 1 needs that hook."""
    resampler = get_resampler(resampling)
    guided = model.proposal_sample is not None
    plain = not guided and not store_history and resampling == "systematic"
    exchange_ok = plain and model.state_categories is not None
    sorted_ok = (
        plain
        and (model.scalar_state or model.vector_state_dim is not None)
        and model.state_categories is None
    )
    chunk_exchange = (
        exchange_ok and model.fused_chunk_exchange_batch is not None
    )
    if chunk > 1 and not chunk_exchange:
        raise ValueError(
            "chunk > 1 needs a discrete model with a fused chunk hook and "
            "store_history=False with systematic resampling"
        )
    if chunk_exchange:
        step = make_smc_step_exchange_fused_chunked(
            model, n_particles, ess_threshold
        )
    else:
        step = make_smc_step(
            model, n_particles, ess_threshold, resampler, store_history,
            exchange=exchange_ok, sorted_fill=sorted_ok,
        )

    def chunked_result(step, carry0, observations):
        xs = _chunk_observations(observations, chunk)
        carry, (hist_r,) = jax.lax.scan(step, carry0, xs)
        # the carry holds the final weights' log-mean-exp already
        _, states_f, log_w_f, log_z, _, _, lme_f = carry
        resampled = jnp.concatenate([jnp.zeros((1,), bool), hist_r], axis=0)
        return SMCResult(
            None, None, None, resampled, log_z + lme_f, states_f, log_w_f
        )

    def run(key, observations):
        key, k_init, k_obs0 = jax.random.split(key, 3)
        if chunk_exchange and model.fused_init_batch is not None:
            # fully fused sweep: init + t=0 reweight + streaming stats in one
            # kernel call
            states0, log_w0, ess0, cat_w0, lme0 = model.fused_init_batch(
                k_init, n_particles, observations[0]
            )
            carry0 = (
                key, states0, log_w0, jnp.zeros(()), ess0, cat_w0, lme0
            )
            return chunked_result(step, carry0, observations)
        if model.init_proposal_sample is not None:
            init_keys = jax.random.split(k_init, n_particles)
            states0 = jax.vmap(
                lambda k: model.init_proposal_sample(k, observations[0])
            )(init_keys)
            rn0 = jax.vmap(
                lambda s: model.init_logpdf(s)
                - model.init_proposal_logpdf(s, observations[0])
            )(states0)
        elif model.init_sample_batch is not None:
            states0 = model.init_sample_batch(k_init, n_particles)
            rn0 = jnp.zeros((n_particles,))
        else:
            init_keys = jax.random.split(k_init, n_particles)
            states0 = jax.vmap(model.init_sample)(init_keys)
            rn0 = jnp.zeros((n_particles,))
        if model.obs_logpdf_batch is not None:
            log_w0 = rn0 + model.obs_logpdf_batch(states0, observations[0], 0)
        else:
            log_w0 = rn0 + jax.vmap(
                lambda s: model.obs_logpdf(s, observations[0], 0)
            )(states0)

        if chunk_exchange:
            cat_w0 = category_weights(
                log_w0, states0, model.state_categories
            )
            carry0 = (
                key, states0, log_w0, jnp.zeros(()), _ess(log_w0),
                cat_w0, _log_mean_exp(log_w0),
            )
            return chunked_result(step, carry0, observations)

        ts = jnp.arange(1, observations.shape[0])
        carry0 = (key, states0, log_w0, jnp.zeros(()), _ess(log_w0))
        (key_f, states_f, log_w_f, log_z, _ess_f), ys = jax.lax.scan(
            step, carry0, (observations[1:], ts)
        )
        log_z = log_z + _log_mean_exp(log_w_f)

        if store_history:
            hist_s, hist_w, hist_a, hist_r = ys
            states = jnp.concatenate([states0[None], hist_s], axis=0)
            log_ws = jnp.concatenate([log_w0[None], hist_w], axis=0)
            anc = jnp.concatenate(
                [jnp.arange(n_particles, dtype=jnp.int32)[None], hist_a],
                axis=0,
            )
            resampled = jnp.concatenate([jnp.zeros((1,), bool), hist_r], axis=0)
            return SMCResult(
                states, log_ws, anc, resampled, log_z, states_f, log_w_f
            )
        (hist_r,) = ys
        resampled = jnp.concatenate([jnp.zeros((1,), bool), hist_r], axis=0)
        return SMCResult(
            None, None, None, resampled, log_z, states_f, log_w_f
        )

    return run


def smc(
    model: StateSpaceModel,
    observations: jax.Array,
    n_particles: int,
    key: jax.Array,
    *,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    jit: bool = True,
) -> SMCResult:
    """Run SMC over ``observations`` of shape (T, ...).

    Evidence: log Z = sum over resampling epochs of log-mean-exp of the
    accumulated weights (the standard unbiased SMC estimator).
    """
    run = build_smc_run(
        model, n_particles, ess_threshold=ess_threshold, resampling=resampling,
        store_history=True,
    )
    if jit:
        run = jax.jit(run)
    return run(key, observations)
