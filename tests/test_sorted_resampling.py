"""Sorted-population systematic resampling for scalar continuous states.

The continuous-state sibling of the exchange resampler: sort by state value
(valid for exchangeable particles; variance-reducing per SQMC / Murray et al.
arXiv:1301.4019 §V), then synthesize the sorted resampled population by a
carry-forward fill (scatter value at first slot + cummax) — no per-particle
gather.  Tests: exact agreement with sort + classic systematic ancestors +
gather, moment preservation, and the engine path on the linear-Gaussian SSM
vs the Kalman-filter oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cpprob_jax.inference.resampling import (
    fill_ancestors,
    sorted_systematic_resample_values,
    systematic_starts,
)
from cpprob_jax.inference.smc import build_smc_run
from cpprob_jax.models.linear_gaussian import (
    kalman_filter_1d,
    linear_gaussian_ssm,
)


def _population(seed, n):
    k1, k2 = jax.random.split(jax.random.key(seed))
    states = jax.random.normal(k1, (n,))
    log_w = 2.0 * jax.random.normal(k2, (n,))
    return states, log_w


def test_matches_sorted_ancestors_gather():
    """Carry-forward fill == sort + systematic ancestors + gather, exactly,
    for the same u0 (which jax.random derives from the same key)."""
    for seed in range(5):
        n = 512
        states, log_w = _population(seed, n)
        key = jax.random.key(100 + seed)
        new = sorted_systematic_resample_values(key, log_w, states)
        ss, slw = jax.lax.sort((states, log_w), num_keys=1)
        u0 = jax.random.uniform(key, ())
        anc = fill_ancestors(
            systematic_starts(jnp.exp(slw - jnp.max(slw)), u0, n), n)
        np.testing.assert_array_equal(np.asarray(new), np.asarray(ss[anc]))
        assert bool(jnp.all(jnp.diff(new) >= 0))


def test_weighted_moments_preserved():
    """Resampled population mean/var ≈ weighted mean/var of the input
    (within systematic-resampling MC error)."""
    n = 1 << 15
    states, log_w = _population(7, n)
    w = jnp.exp(log_w - jax.scipy.special.logsumexp(log_w))
    target_mean = float(jnp.sum(w * states))
    target_var = float(jnp.sum(w * (states - target_mean) ** 2))
    new = sorted_systematic_resample_values(jax.random.key(3), log_w, states)
    assert abs(float(jnp.mean(new)) - target_mean) < 0.02
    assert abs(float(jnp.var(new)) - target_var) / target_var < 0.05


def test_zero_weight_particles_never_selected():
    n = 256
    states = jnp.arange(n, dtype=jnp.float32)
    # only even-indexed particles have mass
    log_w = jnp.where(states % 2 == 0, 0.0, -jnp.inf)
    new = sorted_systematic_resample_values(jax.random.key(0), log_w, states)
    assert bool(jnp.all(new % 2 == 0))


def test_engine_sorted_path_matches_kalman():
    """SMC on the linear-Gaussian SSM with the sorted-fill resampler (enabled
    by scalar_state=True + store_history=False) tracks the Kalman filter."""
    T, n = 30, 4096
    key = jax.random.key(11)
    k_obs, k_run = jax.random.split(key)
    # simulate observations from the model
    xs = jnp.cumsum(jax.random.normal(k_obs, (T,)))
    ys = xs + jax.random.normal(jax.random.key(12), (T,))

    run = build_smc_run(
        linear_gaussian_ssm, n, ess_threshold=0.7, store_history=False
    )
    res = jax.jit(run)(k_run, ys)
    means, _vars, log_ev = kalman_filter_1d(ys)

    lw = res.final_log_weights - jax.scipy.special.logsumexp(
        res.final_log_weights
    )
    est = float(jnp.sum(jnp.exp(lw) * res.final_states))
    assert abs(est - float(means[-1])) < 0.15
    assert abs(float(res.log_evidence) - float(log_ev)) < 0.5
    assert bool(jnp.any(res.resampled))
