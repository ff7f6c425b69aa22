"""NUTS tests: conjugate posteriors, correlated targets, support transforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.distributions import Beta, Bernoulli, MultivariateNormalDiag, Normal
from cpprob_jax.inference.nuts import nuts
from cpprob_jax.models import gaussian_unknown_mean_readme


def test_conjugate_gaussian(key):
    res = nuts(
        gaussian_unknown_mean_readme, (3.0, 4.0), key,
        n_samples=1200, n_warmup=500, n_chains=4, max_depth=6,
    )
    mus = np.asarray(res.samples["mu"]).reshape(-1)
    assert abs(mus.mean() - 2.32353) < 0.05
    assert abs(mus.var() - 1.05882) < 0.12
    assert float(res.accept_rate.mean()) > 0.6


def test_anisotropic_gaussian(key):
    """Scales differing by 100x: NUTS with mass adaptation must recover both."""

    def m():
        ct.sample(
            MultivariateNormalDiag(
                jnp.array([1.0, -2.0]), jnp.array([10.0, 0.1])
            ),
            addr="x",
        )

    res = nuts(m, (), key, n_samples=2500, n_warmup=800, n_chains=4,
               max_depth=8)
    xs = np.asarray(res.samples["x"]).reshape(-1, 2)
    assert abs(xs[:, 0].mean() - 1.0) < 0.6
    assert abs(xs[:, 1].mean() + 2.0) < 0.02
    assert abs(xs[:, 0].std() - 10.0) < 1.5
    assert abs(xs[:, 1].std() - 0.1) < 0.02


def test_beta_bernoulli(key):
    data = np.array([1, 1, 1, 0, 1, 1, 0, 1, 1, 1], np.int32)

    def m(y):
        p = ct.sample(Beta(2.0, 2.0), addr="p")
        for i in range(y.shape[0]):
            ct.observe(Bernoulli(p), y[i], addr=f"y[{i}]")

    res = nuts(m, (data,), key, n_samples=1200, n_warmup=500, n_chains=4,
               max_depth=6)
    ps = np.asarray(res.samples["p"]).reshape(-1)
    assert abs(ps.mean() - 10.0 / 14.0) < 0.03
    assert ps.min() > 0.0 and ps.max() < 1.0


def test_matches_hmc_moments(key):
    from cpprob_jax.inference.hmc import hmc

    res_n = nuts(gaussian_unknown_mean_readme, (3.0, 4.0), key,
                 n_samples=1000, n_warmup=400, n_chains=2, max_depth=6)
    res_h = hmc(gaussian_unknown_mean_readme, (3.0, 4.0),
                jax.random.key(1), n_samples=1000, n_warmup=400, n_chains=2)
    mn = float(np.mean(np.asarray(res_n.samples["mu"])))
    mh = float(np.mean(np.asarray(res_h.samples["mu"])))
    assert abs(mn - mh) < 0.1


class TestChEES:
    def test_conjugate_gaussian(self, key):
        from cpprob_jax.inference.chees import chees_hmc

        res = chees_hmc(
            gaussian_unknown_mean_readme, (3.0, 4.0), key,
            n_samples=1200, n_warmup=600, n_chains=16, max_leapfrog=32,
        )
        mus = np.asarray(res.samples["mu"]).reshape(-1)
        assert abs(mus.mean() - 2.32353) < 0.05
        assert abs(mus.var() - 1.05882) < 0.12
        assert float(res.accept_rate.mean()) > 0.5

    def test_anisotropic_efficiency(self, key):
        """ChEES-adapted trajectories should mix the wide dimension at least
        as well as short fixed trajectories."""
        from cpprob_jax.inference.chees import chees_hmc
        from cpprob_jax.postprocess import effective_sample_size

        def m():
            ct.sample(
                MultivariateNormalDiag(
                    jnp.array([0.0, 0.0]), jnp.array([10.0, 1.0])
                ),
                addr="x",
            )

        res = chees_hmc(m, (), key, n_samples=1500, n_warmup=800,
                        n_chains=16, max_leapfrog=64)
        xs = res.samples["x"]  # (chains, samples, 2)
        ess_wide = float(effective_sample_size(xs[..., 0]))
        assert ess_wide > 1500  # mixes the sigma=10 dimension well
        assert abs(float(jnp.std(xs[..., 0])) - 10.0) < 1.5
