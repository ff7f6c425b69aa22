"""Particle Gibbs: conditional SMC (CSMC) with ancestor sampling.

NEW capability relative to the reference (which has neither SMC nor any MCMC;
SURVEY.md §6): a Markov kernel on *trajectories* of a
:class:`~cpprob_jax.inference.smc.StateSpaceModel` whose invariant
distribution is the exact smoothing posterior p(z_{0:T} | y_{0:T})
(Andrieu, Doucet & Holenstein 2010, "Particle Markov chain Monte Carlo
methods"; ancestor sampling per Lindsten, Jordan & Schön 2014, PGAS).

Each sweep runs an SMC pass in which particle 0 is clamped to the reference
trajectory; ancestor sampling rejuvenates the reference's genealogy so the
kernel mixes even when N is small.  Shape: time is a ``lax.scan``,
particles a batch axis, the per-iteration loop an outer ``lax.scan``; the
whole ``particle_gibbs`` chain is one jitted program.  Multinomial resampling
is used for the free particles (the standard valid choice for CSMC).

Typical use: smoothing-posterior samples for SSMs, and as the trajectory step
of particle-Gibbs parameter learning (run :func:`csmc_sweep` inside a user
Gibbs loop that conditionally updates parameters given the trajectory).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special

from .smc import StateSpaceModel

__all__ = ["CSMCResult", "csmc_sweep", "particle_gibbs"]


class CSMCResult(NamedTuple):
    trajectory: jax.Array     # (T, ...) sampled smoothing trajectory
    log_evidence: jax.Array   # scalar CSMC log-Z estimate (biased; diagnostics)


def _tree_gather(states, idx):
    return jax.tree_util.tree_map(lambda s: s[idx], states)


def _tree_set0(states, value):
    return jax.tree_util.tree_map(lambda s, v: s.at[0].set(v), states, value)


def _log_mean_exp(lw):
    return jsp_special.logsumexp(lw) - jnp.log(float(lw.shape[0]))


def csmc_sweep(
    model: StateSpaceModel,
    observations: jax.Array,
    n_particles: int,
    key: jax.Array,
    reference: jax.Array,
    *,
    ancestor_sampling: bool = True,
) -> CSMCResult:
    """One conditional-SMC sweep: returns a fresh trajectory drawn from a
    kernel that leaves p(z_{0:T} | y_{0:T}) invariant given ``reference``
    (a (T, ...) trajectory, e.g. the previous sweep's output).

    ``ancestor_sampling=True`` draws a new ancestor for the clamped particle
    at every step, a_t^0 ~ w_{t-1}^i · p(ref_t | z_{t-1}^i) — this breaks the
    reference's path degeneracy and is what makes PG mix with small N
    (Lindsten et al. 2014).  Requires ``model.step_logpdf``.
    """
    T = observations.shape[0]
    n = n_particles

    def init_states(k):
        if model.init_sample_batch is not None:
            return model.init_sample_batch(k, n)
        return jax.vmap(model.init_sample)(jax.random.split(k, n))

    def step_states(k, states, t):
        if model.step_sample_batch is not None:
            return model.step_sample_batch(k, states, t)
        return jax.vmap(lambda kk, s: model.step_sample(kk, s, t))(
            jax.random.split(k, n), states
        )

    def obs_lp(states, y, t):
        if model.obs_logpdf_batch is not None:
            return model.obs_logpdf_batch(states, y, t)
        return jax.vmap(lambda s: model.obs_logpdf(s, y, t))(states)

    key, k0 = jax.random.split(key)
    states0 = _tree_set0(init_states(k0), _tree_gather(reference, 0))
    log_w0 = obs_lp(states0, observations[0], 0)

    def step(carry, inp):
        key, states, log_w, log_z = carry
        y_t, ref_t, t = inp
        key, k_anc, k_as, k_prop = jax.random.split(key, 4)

        # multinomial ancestors for the free particles
        anc = jax.random.categorical(k_anc, log_w, shape=(n,)).astype(jnp.int32)
        if ancestor_sampling:
            # a_t^0 ~ w_{t-1}^i * p(ref_t | z_{t-1}^i)
            trans_lp = jax.vmap(
                lambda s: model.step_logpdf(ref_t, s, t)
            )(states)
            a0 = jax.random.categorical(k_as, log_w + trans_lp).astype(jnp.int32)
        else:
            a0 = jnp.int32(0)
        anc = anc.at[0].set(a0)

        parents = _tree_gather(states, anc)
        new_states = _tree_set0(step_states(k_prop, parents, t), ref_t)
        new_log_w = obs_lp(new_states, y_t, t)
        log_z = log_z + _log_mean_exp(log_w)
        return (key, new_states, new_log_w, log_z), (new_states, anc)

    ts = jnp.arange(1, T)
    refs_rest = jax.tree_util.tree_map(lambda r: r[1:], reference)
    (key, states_f, log_w_f, log_z), (hist_s, hist_a) = jax.lax.scan(
        step, (key, states0, log_w0, jnp.zeros(())),
        (observations[1:], refs_rest, ts),
    )
    log_z = log_z + _log_mean_exp(log_w_f)

    # backward trajectory draw through the stored genealogy
    key, k_pick = jax.random.split(key)
    b_last = jax.random.categorical(k_pick, log_w_f).astype(jnp.int32)

    def back(b, sa):
        s_t, a_t = sa
        x_t = _tree_gather(s_t, b)
        return a_t[b], x_t

    b0, traj_rest_rev = jax.lax.scan(
        back, b_last, (hist_s, hist_a), reverse=True
    )
    x0 = _tree_gather(states0, b0)
    trajectory = jax.tree_util.tree_map(
        lambda h0, hr: jnp.concatenate([h0[None], hr], axis=0),
        x0, traj_rest_rev,
    )
    return CSMCResult(trajectory, log_z)


def particle_gibbs(
    model: StateSpaceModel,
    observations: jax.Array,
    n_particles: int,
    n_iters: int,
    key: jax.Array,
    *,
    ancestor_sampling: bool = True,
    init_reference: Optional[jax.Array] = None,
    burn_in: int = 0,
    jit: bool = True,
):
    """Particle-Gibbs chain: iterated CSMC sweeps, each conditioned on the
    previous sweep's trajectory.  Returns (T-major stacked) trajectories of
    shape (n_iters - burn_in, T, ...) distributed (asymptotically) as the
    smoothing posterior p(z_{0:T} | y_{0:T}).
    """
    T = observations.shape[0]

    def prior_rollout(k):
        k_i, k_s = jax.random.split(k)
        z0 = model.init_sample(k_i)

        def st(z, kt):
            kk, t = kt
            z = model.step_sample(kk, z, t)
            return z, z

        _, zs = jax.lax.scan(
            st, z0, (jax.random.split(k_s, T - 1), jnp.arange(1, T))
        )
        return jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([a[None], b], axis=0), z0, zs
        )

    def run(key, reference):
        def body(carry, k):
            ref = carry
            res = csmc_sweep(
                model, observations, n_particles, k, ref,
                ancestor_sampling=ancestor_sampling,
            )
            return res.trajectory, (res.trajectory, res.log_evidence)

        _, (trajs, log_zs) = jax.lax.scan(
            body, reference, jax.random.split(key, n_iters)
        )
        return trajs, log_zs

    key, k_ref = jax.random.split(key)
    reference = (
        init_reference if init_reference is not None else prior_rollout(k_ref)
    )
    if jit:
        run = jax.jit(run)
    trajs, log_zs = run(key, reference)
    if burn_in:
        trajs = jax.tree_util.tree_map(lambda x: x[burn_in:], trajs)
        log_zs = log_zs[burn_in:]
    return trajs, log_zs
