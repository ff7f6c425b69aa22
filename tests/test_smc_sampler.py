"""Tempered SMC sampler tests: posterior moments + evidence vs analytic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.distributions import Beta, Bernoulli, Normal
from cpprob_jax.inference.smc_sampler import smc_sampler
from cpprob_jax.models import gaussian_unknown_mean_readme


def test_conjugate_gaussian_posterior_and_evidence(key):
    res = smc_sampler(
        gaussian_unknown_mean_readme, (3.0, 4.0), 2048, key,
        n_hmc_moves=3, hmc_step_size=0.5,
    )
    mus = np.asarray(res.samples["mu"])
    assert abs(mus.mean() - 2.32353) < 0.08
    assert abs(mus.var() - 1.05882) < 0.25
    # exact log evidence
    import scipy.stats as sps

    s0sq, ssq, mu0 = 1.5**2, 4.0, 1.0
    cov = np.array([[ssq + s0sq, s0sq], [s0sq, ssq + s0sq]])
    want = sps.multivariate_normal.logpdf([3.0, 4.0], [mu0, mu0], cov)
    assert abs(float(res.log_evidence) - want) < 0.1
    assert int(res.n_stages) >= 1
    assert float(res.accept_rate) > 0.3


def test_bounded_support(key):
    data = np.array([1, 1, 1, 0, 1, 1, 0, 1, 1, 1], np.int32)

    def m(y):
        p = ct.sample(Beta(2.0, 2.0), addr="p")
        for i in range(y.shape[0]):
            ct.observe(Bernoulli(p), y[i], addr=f"y[{i}]")

    res = smc_sampler(m, (data,), 2048, key, hmc_step_size=0.3)
    ps = np.asarray(res.samples["p"])
    assert ps.min() > 0 and ps.max() < 1
    assert abs(ps.mean() - 10.0 / 14.0) < 0.03
    # evidence = beta-binomial marginal
    from scipy.special import betaln

    want = betaln(2 + 8, 2 + 2) - betaln(2, 2)
    assert abs(float(res.log_evidence) - want) < 0.1


def test_multimodal_survives_tempering(key):
    """A well-separated bimodal posterior: tempering + moves keeps both modes
    populated (plain SIS/HMC would collapse to one)."""

    def m():
        x = ct.sample(Normal(0.0, 10.0), addr="x")
        # likelihood with two modes at +/-3
        ct.factor(
            jnp.logaddexp(
                Normal(3.0, 0.5).log_prob(x), Normal(-3.0, 0.5).log_prob(x)
            ),
            addr="bimodal",
        )

    res = smc_sampler(m, (), 4096, key, n_hmc_moves=2, hmc_step_size=0.3)
    xs = np.asarray(res.samples["x"])
    frac_pos = float((xs > 0).mean())
    assert 0.25 < frac_pos < 0.75  # both modes present
    assert abs(abs(xs).mean() - 3.0) < 0.3


def test_waste_free_conjugate_gaussian(key):
    """Waste-free SMC (Dau & Chopin 2022): resampled roots + kept chain
    states reach the same posterior/evidence as the standard sampler with the
    same MCMC budget."""
    res = smc_sampler(
        gaussian_unknown_mean_readme, (3.0, 4.0), 2048, key,
        waste_free=True, chain_length=8, hmc_step_size=0.5,
    )
    mus = np.asarray(res.samples["mu"])
    assert abs(mus.mean() - 2.32353) < 0.08
    assert abs(mus.var() - 1.05882) < 0.25
    import scipy.stats as sps

    s0sq, ssq, mu0 = 1.5**2, 4.0, 1.0
    cov = np.array([[ssq + s0sq, s0sq], [s0sq, ssq + s0sq]])
    want = sps.multivariate_normal.logpdf([3.0, 4.0], [mu0, mu0], cov)
    assert abs(float(res.log_evidence) - want) < 0.12
    assert float(res.accept_rate) > 0.3


def test_waste_free_validation():
    with pytest.raises(ValueError):
        smc_sampler(gaussian_unknown_mean_readme, (3.0, 4.0), 100,
                    jax.random.key(0), waste_free=True, chain_length=8)
    with pytest.raises(ValueError):
        smc_sampler(gaussian_unknown_mean_readme, (3.0, 4.0), 128,
                    jax.random.key(0), waste_free=True, chain_length=1)
