"""Exchange (sorted-category) systematic resampling tests.

The scheme reorders exchangeable particles by state before the systematic
comb (valid for any fixed reordering; sorted orders lower variance — Gerber &
Chopin SQMC, Murray et al. arXiv:1301.4019 §V), collapsing the resample epoch
to K category counts.  Tests: exact agreement with a direct systematic
resample under the sorted ordering, unbiasedness, and engine-path equivalence
on the HMM.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.inference.resampling import (
    category_counts_systematic,
    category_weights,
    exchange_resample_discrete,
    fill_ancestors,
    states_from_counts,
    systematic_starts,
)
from cpprob_jax.inference.smc import build_smc_run
from cpprob_jax.models.hmm import hmm_ssm


def _random_population(key, n, k=3):
    k1, k2 = jax.random.split(key)
    states = jax.random.randint(k1, (n,), 0, k)
    log_w = 2.0 * jax.random.normal(k2, (n,))
    return states, log_w


def test_counts_match_direct_systematic_on_sorted_order():
    """Sorting by state then running the classic scatter+cummax systematic
    resampler must give exactly the per-category counts of the counts
    formulation, for the same u0."""
    for seed in range(5):
        states, log_w = _random_population(jax.random.key(seed), 512)
        u0 = jnp.float32(0.31 + 0.1 * seed)
        order = jnp.argsort(states, stable=True)
        s_sorted, lw_sorted = states[order], log_w[order]
        anc = fill_ancestors(systematic_starts(
            jnp.exp(lw_sorted - jnp.max(lw_sorted)), u0, 512), 512)
        direct_counts = np.bincount(np.asarray(s_sorted[anc]), minlength=3)

        cat_w = category_weights(log_w, states, 3)
        counts = category_counts_systematic(u0, cat_w, 512)
        np.testing.assert_array_equal(np.asarray(counts), direct_counts)


def test_counts_sum_and_unbiasedness():
    states, log_w = _random_population(jax.random.key(42), 256)
    cat_w = np.asarray(category_weights(log_w, states, 3))
    n_out = 1024
    totals = np.zeros(3)
    n_draws = 400
    for i in range(n_draws):
        u0 = jax.random.uniform(jax.random.key(i), ())
        counts = np.asarray(category_counts_systematic(u0, cat_w, n_out))
        assert counts.sum() == n_out
        assert (counts >= 0).all()
        totals += counts
    # E[m_k] = n_out * W_k (systematic: |m_k - n W_k| < 1 per draw)
    np.testing.assert_allclose(totals / n_draws, n_out * cat_w, atol=1.0)


def test_states_from_counts():
    counts = jnp.asarray([3, 0, 4, 1], jnp.int32)
    out = np.asarray(states_from_counts(counts, 8))
    np.testing.assert_array_equal(out, [0, 0, 0, 2, 2, 2, 2, 3])


def test_exchange_resample_discrete_end_to_end():
    states, log_w = _random_population(jax.random.key(7), 512)
    new = exchange_resample_discrete(jax.random.key(8), log_w, states, 3)
    assert new.shape == (512,)
    assert new.dtype == states.dtype
    # sorted population
    assert bool(jnp.all(jnp.diff(new) >= 0))


def test_smc_exchange_path_matches_classic_evidence():
    """HMM SMC via the exchange path (state_categories=3) vs the classic
    gather path: log-evidence estimates agree within Monte-Carlo error."""
    T, N = 12, 4096
    rng = np.random.RandomState(3)
    obs = jnp.asarray(rng.normal(0.0, 1.2, size=T).astype(np.float32))

    classic_model = dataclasses.replace(hmm_ssm, state_categories=None)
    run_ex = jax.jit(build_smc_run(hmm_ssm, N, ess_threshold=0.6,
                                   store_history=False))
    run_cl = jax.jit(build_smc_run(classic_model, N, ess_threshold=0.6,
                                   store_history=False))

    z_ex = [float(run_ex(jax.random.key(i), obs).log_evidence)
            for i in range(8)]
    z_cl = [float(run_cl(jax.random.key(100 + i), obs).log_evidence)
            for i in range(8)]
    assert abs(np.mean(z_ex) - np.mean(z_cl)) < 4.0 * (
        np.std(z_ex) + np.std(z_cl) + 1e-3
    ) / np.sqrt(8)
    # both paths resampled at least once (otherwise the test is vacuous)
    r = run_ex(jax.random.key(0), obs)
    assert int(np.asarray(r.resampled).sum()) >= 1


def test_smc_exchange_filtered_moments_match_exact():
    """Filtered state frequencies from the exchange path track the exact
    forward-filter marginals."""
    from cpprob_jax.models.hmm import HMM_MEANS, HMM_TRANS, hmm_exact_posterior

    T, N = 10, 8192
    rng = np.random.RandomState(11)
    z = 0
    obs = []
    for t in range(T):
        if t > 0:
            z = rng.choice(3, p=HMM_TRANS[z])
        obs.append(rng.normal(HMM_MEANS[z], 1.0))
    obs = jnp.asarray(np.asarray(obs, np.float32))

    run = jax.jit(build_smc_run(hmm_ssm, N, ess_threshold=0.7,
                                store_history=False))
    res = run(jax.random.key(5), obs)
    # final-step filtered mean state vs exact filter
    lw = res.final_log_weights - jax.scipy.special.logsumexp(
        res.final_log_weights
    )
    mean_state = float(jnp.sum(jnp.exp(lw) * res.final_states))
    post = np.asarray(hmm_exact_posterior(obs))  # smoothed; final row = filtered
    exact_mean = float((post[-1] * np.arange(3)).sum())
    assert abs(mean_state - exact_mean) < 0.15
