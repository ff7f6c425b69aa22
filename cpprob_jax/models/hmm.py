"""3-state HMM with Gaussian emissions — counterpart of
``include/models/models.hpp:114-141`` (means (-1, 0, 1), fixed transition
matrix, uniform initial state; N=10 in the reference CLI, 16 in the thesis).

Two formulations of the *same* generative model:

- :func:`hmm` — trace form (Python loop over time at trace time), usable by
  SIS/CSIS exactly like the reference model function.
- :data:`hmm_ssm` — :class:`~cpprob_jax.inference.smc.StateSpaceModel` form
  (init/step), the sequential decomposition SMC needs for per-step
  resampling (the reference has no SMC; thesis ch. 6.3).

Exact oracles for any K-state Gaussian-emission HMM (forward recursion and
forward-backward in float64 numpy) sit beside them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import observe, predict, sample
from ..core.scanner import scan_sites
from ..distributions import Categorical, Normal, UniformInt
from ..inference.smc import StateSpaceModel

__all__ = [
    "HMM_MEANS", "HMM_TRANS", "hmm", "hmm_scan", "hmm_ssm",
    "hmm_exact_posterior", "discrete_hmm_log_evidence",
    "discrete_hmm_smoothed_marginals",
]

# numpy (not jnp) so importing the library never initializes a JAX backend
HMM_MEANS = np.array([-1.0, 0.0, 1.0], np.float32)
HMM_TRANS = np.array(
    [
        [0.10, 0.50, 0.40],
        [0.20, 0.20, 0.60],
        [0.15, 0.15, 0.70],
    ],
    np.float32,
)


def hmm(observations):
    """Trace-form HMM: the time loop unrolls at trace time (static length),
    addresses are per-step (``z[t]``) — the structured replacement of the
    reference's backtrace-distinct per-step addresses (``models.hpp:126-140``)."""
    observations = jnp.asarray(observations)
    T = observations.shape[0]
    means = jnp.asarray(HMM_MEANS)
    trans = jnp.asarray(HMM_TRANS)
    state = sample(UniformInt(0, 2), addr="z[0]")
    predict(state, "State")
    observe(Normal(means[state], 1.0), observations[0], addr="y[0]")
    for t in range(1, T):
        state = sample(Categorical(trans[state]), addr=f"z[{t}]")
        predict(state, "State")
        observe(Normal(means[state], 1.0), observations[t], addr=f"y[{t}]")
    return state


def hmm_scan(observations):
    """Scan-form HMM: identical generative model to :func:`hmm`, but the time
    loop is :func:`~cpprob_jax.core.scanner.scan_sites` — under plain handler
    stacks (structure discovery, compile-mode trace generation) it unrolls to
    the same per-step addresses ``z[t]``/``y[t]`` as :func:`hmm`; under the
    guided-inference stack it compiles as ONE ``lax.scan`` whose carry
    threads the proposal LSTM state, so guided-SIS compile time is O(1) in
    the trace length (use with ``CSIS(..., tie_addresses=True)``)."""
    observations = jnp.asarray(observations)
    means = jnp.asarray(HMM_MEANS)
    trans = jnp.asarray(HMM_TRANS)
    state = sample(UniformInt(0, 2), addr="z[0]")
    predict(state, "State")
    observe(Normal(means[state], 1.0), observations[0], addr="y[0]")

    def body(state, y_t, idx):
        state = sample(Categorical(trans[state]), addr=f"z[{idx}]")
        predict(state, "State")
        observe(Normal(means[state], 1.0), y_t, addr=f"y[{idx}]")
        return state, None

    state, _ = scan_sites(body, state, observations[1:], index_offset=1)
    return state


def _hmm_init(key):
    state = jax.random.randint(key, (), 0, 3)
    return state


def _hmm_init_logpdf(state):
    return jnp.full((), -jnp.log(3.0))


def _hmm_step_sample(key, state, t):
    logits = jnp.log(jnp.asarray(HMM_TRANS))[state]
    return jax.random.categorical(key, logits)


def _hmm_step_logpdf(new_state, state, t):
    return jnp.log(jnp.asarray(HMM_TRANS))[state, new_state]


def _hmm_obs_logpdf(state, y, t):
    mean = jnp.asarray(HMM_MEANS)[state]
    return Normal(mean, 1.0).log_prob(y)


def _hmm_init_batch(key, n):
    return jax.random.randint(key, (n,), 0, 3)


def _hmm_step_batch(key, states, t):
    # gather each particle's transition row, one categorical over the batch
    logits = jnp.log(jnp.asarray(HMM_TRANS))[states]  # (n, 3)
    return jax.random.categorical(key, logits, axis=-1)


def _hmm_obs_batch(states, y, t):
    mean = jnp.asarray(HMM_MEANS)[states]
    d = y - mean
    return -0.5 * d * d - 0.9189385332046727  # N(mean, 1) logpdf


hmm_ssm = StateSpaceModel(
    init_sample=_hmm_init,
    init_logpdf=_hmm_init_logpdf,
    step_sample=_hmm_step_sample,
    step_logpdf=_hmm_step_logpdf,
    obs_logpdf=_hmm_obs_logpdf,
    # t=0 emission uses the same obs_logpdf
    init_sample_batch=_hmm_init_batch,
    step_sample_batch=_hmm_step_batch,
    obs_logpdf_batch=_hmm_obs_batch,
    obs_sample=lambda key, s, t: jnp.asarray(HMM_MEANS)[s]
    + jax.random.normal(key, ()),
    # 3-state discrete space: enables the exchange (category-count)
    # systematic resampler — no scatter/gather on the resample epoch.
    state_categories=3,
)


def hmm_exact_posterior(observations):
    """Exact filtered/smoothed marginals via forward-backward (for tests;
    the thesis validates against the true posterior the same way, ch. 6.3).

    Pure numpy on the host: it's a correctness oracle over (3,)-vectors,
    tiny sequential scans that would only waste an accelerator.

    Returns (T, 3) smoothed posterior marginals p(z_t | y_{1:T}).
    """
    obs = np.asarray(observations, np.float64)
    T = obs.shape[0]
    means = np.asarray(HMM_MEANS, np.float64)
    trans = np.asarray(HMM_TRANS, np.float64)
    # N(mean, 1) emission densities, (T, 3)
    emis = np.exp(-0.5 * (obs[:, None] - means[None, :]) ** 2) / np.sqrt(
        2.0 * np.pi
    )

    alphas = np.zeros((T, 3))
    a = (1.0 / 3.0) * emis[0]
    alphas[0] = a / a.sum()
    for t in range(1, T):
        a = (alphas[t - 1] @ trans) * emis[t]
        alphas[t] = a / a.sum()

    betas = np.zeros((T, 3))
    betas[T - 1] = 1.0
    for t in range(T - 2, -1, -1):
        b = trans @ (emis[t + 1] * betas[t + 1])
        betas[t] = b / b.max()

    post = alphas * betas
    return post / post.sum(axis=1, keepdims=True)


def _gaussian_emissions(means, stds, obs):
    """(T, K) float64 emission densities N(obs_t; means_k, stds_k)."""
    return np.exp(-0.5 * ((obs[:, None] - means[None, :]) / stds) ** 2) / (
        stds * np.sqrt(2 * np.pi)
    )


def discrete_hmm_log_evidence(trans, means, stds, init_probs, observations):
    """Exact log p(y_{1:T}) for a K-state Gaussian-emission HMM via the
    forward recursion (float64, host numpy)."""
    trans = np.asarray(trans, np.float64)
    obs = np.asarray(observations, np.float64)
    emis = _gaussian_emissions(np.asarray(means, np.float64),
                               np.asarray(stds, np.float64), obs)
    alpha = np.asarray(init_probs, np.float64)
    log_z = 0.0
    for t in range(obs.shape[0]):
        a = (alpha if t == 0 else alpha @ trans) * emis[t]
        log_z += np.log(a.sum())
        alpha = a / a.sum()
    return float(log_z)


def discrete_hmm_smoothed_marginals(trans, means, stds, init_probs,
                                    observations):
    """Exact smoothed marginals p(z_t | y_{1:T}) (T, K) via forward-backward
    (float64, host numpy): the generic-K version of
    :func:`hmm_exact_posterior`."""
    trans = np.asarray(trans, np.float64)
    obs = np.asarray(observations, np.float64)
    emis = _gaussian_emissions(np.asarray(means, np.float64),
                               np.asarray(stds, np.float64), obs)
    T, K = obs.shape[0], trans.shape[0]
    alphas = np.zeros((T, K))
    a = np.asarray(init_probs, np.float64) * emis[0]
    alphas[0] = a / a.sum()
    for t in range(1, T):
        a = (alphas[t - 1] @ trans) * emis[t]
        alphas[t] = a / a.sum()
    betas = np.ones((T, K))
    for t in range(T - 2, -1, -1):
        b = trans @ (emis[t + 1] * betas[t + 1])
        betas[t] = b / b.sum()
    post = alphas * betas
    return post / post.sum(axis=1, keepdims=True)
