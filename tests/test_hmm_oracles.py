"""The exact HMM oracles (forward recursion, forward-backward) against
brute-force enumeration of every state path."""

import itertools

import numpy as np
import pytest

from cpprob_jax.models.hmm import (
    HMM_MEANS,
    HMM_TRANS,
    discrete_hmm_log_evidence,
    discrete_hmm_smoothed_marginals,
    hmm_exact_posterior,
)


def _spec(K, seed):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(K), size=K), rng.normal(0, 2, K),
            rng.uniform(0.5, 1.5, K), rng.dirichlet(np.ones(K)),
            rng.normal(0, 2, 8))


def _path_weights(trans, means, stds, init, ys):
    """Joint density p(z, y) of every state path z (float64)."""
    K, T = len(init), len(ys)
    emis = np.exp(-0.5 * ((ys[:, None] - means) / stds) ** 2) / (
        stds * np.sqrt(2 * np.pi))
    paths = np.array(list(itertools.product(range(K), repeat=T)))
    p = init[paths[:, 0]] * emis[0, paths[:, 0]]
    for t in range(1, T):
        p = p * trans[paths[:, t - 1], paths[:, t]] * emis[t, paths[:, t]]
    return paths, p


@pytest.mark.parametrize("K,T", [(2, 1), (2, 6), (3, 5), (4, 4), (5, 3)])
def test_log_evidence_vs_enumeration(K, T):
    trans, means, stds, init, ys = _spec(K, 10 * K + T)
    _, p = _path_weights(trans, means, stds, init, ys[:T])
    np.testing.assert_allclose(
        discrete_hmm_log_evidence(trans, means, stds, init, ys[:T]),
        np.log(p.sum()), rtol=1e-12)


@pytest.mark.parametrize("K,T", [(2, 6), (3, 5), (4, 4)])
def test_smoothed_marginals_vs_enumeration(K, T):
    trans, means, stds, init, ys = _spec(K, 7 * K + T)
    paths, p = _path_weights(trans, means, stds, init, ys[:T])
    want = np.array([[p[paths[:, t] == k].sum() for k in range(K)]
                     for t in range(T)]) / p.sum()
    np.testing.assert_allclose(
        discrete_hmm_smoothed_marginals(trans, means, stds, init, ys[:T]),
        want, atol=1e-12)


def test_generic_marginals_match_reference_hmm_posterior():
    ys = np.random.default_rng(1).normal(0, 1.2, 7)
    np.testing.assert_allclose(
        discrete_hmm_smoothed_marginals(HMM_TRANS, HMM_MEANS, np.ones(3),
                                        np.full(3, 1 / 3), ys),
        hmm_exact_posterior(ys), atol=1e-6)
