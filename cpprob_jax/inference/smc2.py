"""SMC² — sequential inference of static parameters AND states of a
state-space model (Chopin, Jacob & Papaspiliopoulos 2013).

Outer level: parameter particles θ_i weighted by the running particle-filter
evidence estimate Ẑ_t(θ_i); inner level: one bootstrap particle filter per θ.
When the outer ESS collapses, parameters are resampled and rejuvenated by a
particle-marginal Metropolis-Hastings (PMMH) move whose acceptance uses a
freshly re-run inner filter over the observations seen so far.

Shape: the inner filter is the same vectorized step used by
:mod:`cpprob_jax.inference.smc`, *additionally* vmapped over the θ axis —
states live as one (N_θ, N_x) array, the whole sweep (including rejuvenation
re-runs, masked to the observations seen so far) is one jitted scan.  Nothing
in the reference is remotely comparable (it has no SMC at all).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special

from .resampling import systematic_resample

__all__ = ["ParamSSM", "SMC2Result", "smc2"]


@dataclasses.dataclass(frozen=True)
class ParamSSM:
    """Parameterized SSM protocol.  All callables take a parameter pytree
    ``theta`` (leaves: scalars/arrays) and must be vmappable over it.

    - ``prior_sample(key) -> theta``; ``prior_logpdf(theta) -> logp``
    - ``init_sample(key, theta) -> x0``
    - ``step_sample(key, x, t, theta) -> x'``
    - ``obs_logpdf(x, y, t, theta) -> logp`` (vectorized over a particle axis
      of x is fine; the engine calls it with (N_x,) states)
    """

    prior_sample: Callable
    prior_logpdf: Callable
    init_sample: Callable
    step_sample: Callable
    obs_logpdf: Callable


class SMC2Result(NamedTuple):
    thetas: jax.Array            # pytree with leading (N_theta,) axis
    log_weights: jax.Array       # (N_theta,) outer weights
    log_evidence: jax.Array      # scalar: log p(y_{1:T})
    rejuvenations: jax.Array     # (T,) bool
    accept_rate: jax.Array       # mean PMMH acceptance over rejuvenation epochs

    @property
    def normalized_weights(self):
        return jax.nn.softmax(self.log_weights)

    def mean(self, leaf_fn=lambda th: th):
        w = self.normalized_weights
        vals = jax.vmap(leaf_fn)(self.thetas)
        w = w.reshape(w.shape + (1,) * (vals.ndim - 1))
        return jnp.sum(w * vals, axis=0)


def smc2(
    model: ParamSSM,
    observations: jax.Array,
    n_theta: int,
    n_x: int,
    key: jax.Array,
    *,
    ess_threshold: float = 0.5,
    rw_scale: float = 0.25,
    jit: bool = True,
) -> SMC2Result:
    """Run SMC² over observations (T, ...).

    ``rw_scale``: random-walk PMMH proposal scale, as a fraction of the
    current parameter-population standard deviation per leaf (adaptive).
    """
    T = observations.shape[0]

    # ---------------- inner particle filter pieces ----------------
    def pf_init(key, theta):
        keys = jax.random.split(key, n_x)
        xs = jax.vmap(lambda k: model.init_sample(k, theta))(keys)
        lw = jax.vmap(lambda x: model.obs_logpdf(x, observations[0], 0, theta))(xs)
        lz = jsp_special.logsumexp(lw) - jnp.log(float(n_x))
        return xs, lw, lz

    def pf_step(key, xs, lw, theta, y, t):
        """One bootstrap-PF step with always-resample (keeps shapes static and
        the evidence estimator unbiased)."""
        k_res, k_prop = jax.random.split(key)
        anc = systematic_resample(k_res, lw)
        xs = jax.tree_util.tree_map(lambda s: s[anc], xs)
        keys = jax.random.split(k_prop, n_x)
        xs = jax.vmap(lambda k, x: model.step_sample(k, x, t, theta))(keys, xs)
        lw_new = jax.vmap(lambda x: model.obs_logpdf(x, y, t, theta))(xs)
        incr = jsp_special.logsumexp(lw_new) - jnp.log(float(n_x))
        return xs, lw_new, incr

    def pf_full_masked(key, theta, t_now):
        """Re-run a full filter over obs[0..T-1], masking steps > t_now —
        yields Ẑ_{t_now}(θ) with static shapes (for PMMH at outer time t_now)."""
        key, k0 = jax.random.split(key)
        xs, lw, lz = pf_init(k0, theta)

        def body(carry, inp):
            xs, lw, lz, k = carry
            y, t = inp
            k, sub = jax.random.split(k)
            xs2, lw2, incr = pf_step(sub, xs, lw, theta, y, t)
            active = t <= t_now
            xs = jax.tree_util.tree_map(
                lambda a, b: jnp.where(active, b, a), xs, xs2
            )
            lw = jnp.where(active, lw2, lw)
            lz = lz + jnp.where(active, incr, 0.0)
            return (xs, lw, lz, k), None

        (xs, lw, lz, _), _ = jax.lax.scan(
            body, (xs, lw, lz, key),
            (observations[1:], jnp.arange(1, T)),
        )
        return xs, lw, lz

    v_pf_step = jax.vmap(pf_step, in_axes=(0, 0, 0, 0, None, None))
    v_pf_full = jax.vmap(pf_full_masked, in_axes=(0, 0, None))

    def rejuvenate(key, thetas, xs, lws, lzs, t_now):
        """PMMH move for every θ particle (after an outer resample)."""
        k_prop, k_run, k_acc = jax.random.split(key, 3)

        # adaptive RW proposal: scale per leaf from the population std
        def propose(leaf, k):
            std = jnp.std(leaf, axis=0, keepdims=True) + 1e-6
            return leaf + rw_scale * std * jax.random.normal(k, leaf.shape)

        leaves, treedef = jax.tree_util.tree_flatten(thetas)
        prop_keys = jax.random.split(k_prop, len(leaves))
        new_leaves = [propose(l, k) for l, k in zip(leaves, prop_keys)]
        thetas_prop = jax.tree_util.tree_unflatten(treedef, new_leaves)

        xs_p, lw_p, lz_p = v_pf_full(
            jax.random.split(k_run, n_theta), thetas_prop, t_now
        )
        prior_old = jax.vmap(model.prior_logpdf)(thetas)
        prior_new = jax.vmap(model.prior_logpdf)(thetas_prop)
        log_a = (lz_p + prior_new) - (lzs + prior_old)
        log_a = jnp.where(jnp.isnan(log_a), -jnp.inf, log_a)
        accept = jnp.log(jax.random.uniform(k_acc, (n_theta,))) < log_a

        def sel(a, b):
            acc = accept.reshape((n_theta,) + (1,) * (b.ndim - 1))
            return jnp.where(acc, b, a)

        thetas = jax.tree_util.tree_map(sel, thetas, thetas_prop)
        xs = jax.tree_util.tree_map(sel, xs, xs_p)
        lws = sel(lws, lw_p)
        lzs = sel(lzs, lz_p)
        return thetas, xs, lws, lzs, jnp.mean(accept.astype(jnp.float32))

    def run(key):
        key, k_th, k_pf = jax.random.split(key, 3)
        thetas = jax.vmap(model.prior_sample)(jax.random.split(k_th, n_theta))
        xs, lws, lzs = jax.vmap(pf_init)(jax.random.split(k_pf, n_theta), thetas)
        outer_lw = lzs                     # outer weight = running evidence
        log_evid = jnp.zeros(())

        def body(carry, inp):
            key, thetas, xs, lws, lzs, outer_lw, log_evid, acc_s, acc_n = carry
            y, t = inp
            key, k_step, k_res, k_rej = jax.random.split(key, 4)

            # advance every θ's inner filter one step
            xs, lws, incr = v_pf_step(
                jax.random.split(k_step, n_theta), xs, lws, thetas, y, t
            )
            lzs = lzs + incr
            # outer evidence increment: weighted mean of per-θ increments
            norm = jax.nn.softmax(outer_lw)
            log_evid = log_evid + jnp.log(
                jnp.maximum(jnp.sum(norm * jnp.exp(incr - jnp.max(incr))), 1e-38)
            ) + jnp.max(incr)
            outer_lw = outer_lw + incr

            # outer ESS check -> resample + PMMH rejuvenation
            lw_n = outer_lw - jsp_special.logsumexp(outer_lw)
            ess = jnp.exp(-jsp_special.logsumexp(2.0 * lw_n))
            do_rej = ess < ess_threshold * n_theta

            def rej_branch(_):
                anc = systematic_resample(k_res, outer_lw)
                th = jax.tree_util.tree_map(lambda s: s[anc], thetas)
                x = jax.tree_util.tree_map(lambda s: s[anc], xs)
                lw_i = lws[anc]
                lz_i = lzs[anc]
                th, x, lw_i, lz_i, a = rejuvenate(k_rej, th, x, lw_i, lz_i, t)
                return th, x, lw_i, lz_i, jnp.zeros_like(outer_lw), a

            def keep_branch(_):
                return thetas, xs, lws, lzs, outer_lw, jnp.zeros(())

            thetas2, xs2, lws2, lzs2, outer_lw2, a = jax.lax.cond(
                do_rej, rej_branch, keep_branch, operand=None
            )
            acc_s = acc_s + jnp.where(do_rej, a, 0.0)
            acc_n = acc_n + jnp.where(do_rej, 1.0, 0.0)
            return (
                key, thetas2, xs2, lws2, lzs2, outer_lw2, log_evid,
                acc_s, acc_n,
            ), do_rej

        # initial evidence = log-mean over θ of Ẑ_0
        carry0 = (
            key, thetas, xs, lws, lzs, outer_lw, _lme(lzs),
            jnp.zeros(()), jnp.zeros(()),
        )
        (key, thetas, xs, lws, lzs, outer_lw, log_evid, acc_s, acc_n), rej = (
            jax.lax.scan(body, carry0, (observations[1:], jnp.arange(1, T)))
        )
        rejuvenations = jnp.concatenate([jnp.zeros((1,), bool), rej])
        acc_rate = acc_s / jnp.maximum(acc_n, 1.0)
        return thetas, outer_lw, log_evid, rejuvenations, acc_rate

    def _lme(lz):
        return jsp_special.logsumexp(lz) - jnp.log(float(n_theta))

    if jit:
        run = jax.jit(run)
    thetas, outer_lw, log_evid, rej, acc = run(key)
    return SMC2Result(thetas, outer_lw, log_evid, rej, acc)
