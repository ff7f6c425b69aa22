"""Distribution layer unit tests — the counterpart (and superset) of the
reference's ``tests/cpprob/logpdf.cpp``: every log_prob swept against scipy
ground truth over parameter grids, plus sampler moment checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps

from cpprob_jax import distributions as d

ATOL = 1e-5


def grid(*xs):
    return [np.asarray(v, np.float32) for v in np.meshgrid(*xs)]


class TestLogProb:
    def test_normal(self):
        for mu in [-2.0, 0.0, 3.5]:
            for sd in [0.5, 1.0, 7.2]:
                x = np.linspace(-10, 10, 41, dtype=np.float32)
                got = np.asarray(d.Normal(mu, sd).log_prob(x))
                want = sps.norm.logpdf(x, mu, sd)
                np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)

    def test_normal_sigma_zero_dirac(self):
        lp = d.Normal(2.0, 0.0).log_prob(jnp.array([2.0, 3.0]))
        assert lp[0] == 0.0 and np.isneginf(lp[1])

    def test_uniform(self):
        dist = d.Uniform(2.0, 9.5)
        x = np.array([1.9, 2.0, 5.0, 9.5, 9.6], np.float32)
        got = np.asarray(dist.log_prob(x))
        want = sps.uniform.logpdf(x, 2.0, 7.5)
        # boundary conventions differ; test interior + outside
        np.testing.assert_allclose(got[1:4], want[1:4], atol=ATOL)
        assert np.isneginf(got[0]) and np.isneginf(got[4])

    def test_poisson(self):
        for rate in [0.8, 3.0, 20.0]:
            k = np.arange(0, 40)
            got = np.asarray(d.Poisson(rate).log_prob(k))
            want = sps.poisson.logpmf(k, rate)
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_beta(self):
        x = np.linspace(0.01, 0.99, 21, dtype=np.float32)
        got = np.asarray(d.Beta(2.0, 3.0).log_prob(x))
        want = sps.beta.logpdf(x, 2.0, 3.0)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_gamma(self):
        x = np.linspace(0.1, 20, 21, dtype=np.float32)
        got = np.asarray(d.Gamma(2.0, 1.5).log_prob(x))
        want = sps.gamma.logpdf(x, 2.0, scale=1.5)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_laplace(self):
        x = np.linspace(-5, 5, 21, dtype=np.float32)
        got = np.asarray(d.Laplace(0.5, 2.0).log_prob(x))
        want = sps.laplace.logpdf(x, 0.5, 2.0)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)

    def test_exponential(self):
        x = np.linspace(0.0, 10, 21, dtype=np.float32)
        got = np.asarray(d.Exponential(1.7).log_prob(x))
        want = sps.expon.logpdf(x, scale=1 / 1.7)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_categorical(self):
        probs = np.array([0.2, 0.3, 0.5], np.float32) * 4.0  # unnormalized
        got = np.asarray(d.Categorical(probs).log_prob(np.arange(3)))
        want = np.log([0.2, 0.3, 0.5])
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert np.isneginf(d.Categorical(probs).log_prob(3))

    def test_uniform_int(self):
        dist = d.UniformInt(2, 7)
        got = np.asarray(dist.log_prob(np.arange(0, 10)))
        want = np.where((np.arange(10) >= 2) & (np.arange(10) <= 7),
                        -np.log(6.0), -np.inf)
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_bernoulli(self):
        got = np.asarray(d.Bernoulli(0.3).log_prob(np.array([0, 1])))
        np.testing.assert_allclose(got, np.log([0.7, 0.3]), atol=ATOL)

    def test_mvn_diag(self):
        loc = np.array([1.0, 2.0, 3.0], np.float32)
        scale = np.array([2.0, 1.0, 5.0], np.float32)
        x = np.array([0.0, 2.5, -1.0], np.float32)
        got = np.asarray(d.MultivariateNormalDiag(loc, scale).log_prob(x))
        want = sps.multivariate_normal.logpdf(x, loc, np.diag(scale**2))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)

    def test_mixture(self):
        comp = d.Normal(jnp.array([-1.0, 2.0]), jnp.array([0.5, 1.5]))
        mix = d.Mixture(comp, jnp.array([0.3, 0.7]))
        x = np.linspace(-4, 6, 21, dtype=np.float32)
        got = np.asarray(mix.log_prob(x))
        want = np.log(
            0.3 * sps.norm.pdf(x, -1.0, 0.5) + 0.7 * sps.norm.pdf(x, 2.0, 1.5)
        )
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_truncated_normal(self):
        base = d.Normal(0.5, 2.0)
        tr = d.Truncated(base, -1.0, 3.0)
        x = np.linspace(-2, 4, 25, dtype=np.float32)
        got = np.asarray(tr.log_prob(x))
        want = sps.truncnorm.logpdf(
            x, (-1.0 - 0.5) / 2.0, (3.0 - 0.5) / 2.0, loc=0.5, scale=2.0
        )
        inside = (x >= -1) & (x <= 3)
        np.testing.assert_allclose(got[inside], want[inside], atol=1e-4, rtol=1e-4)
        assert np.all(np.isneginf(got[~inside]))

    def test_min_max_discrete(self):
        dist = d.MinMaxDiscrete(3, jnp.array([1.0, 2.0, 1.0]))
        got = np.asarray(dist.log_prob(np.array([3, 4, 5, 6, 2])))
        want = np.log(np.array([0.25, 0.5, 0.25]))
        np.testing.assert_allclose(got[:3], want, atol=ATOL)
        assert np.isneginf(got[3]) and np.isneginf(got[4])

    def test_dirac(self):
        dist = d.Dirac(2.5)
        assert dist.log_prob(2.5) == 0.0
        assert np.isneginf(dist.log_prob(2.6))

    def test_abc(self):
        dist = d.make_abc(
            sampler=lambda k: jax.random.normal(k, ()),
            logpdf_fn=lambda x: -jnp.abs(x),
        )
        np.testing.assert_allclose(float(dist.log_prob(3.0)), -3.0, atol=ATOL)

    def test_min_max_continuous(self):
        dist = d.MinMaxContinuous(0.0, 10.0, 3.0, 6.0)
        # alpha = 0.3*4+1 = 2.2, beta = 0.7*4+1 = 3.8 on [0,10]
        x = np.linspace(0.5, 9.5, 19, dtype=np.float32)
        got = np.asarray(dist.log_prob(x))
        want = sps.beta.logpdf(x / 10.0, 2.2, 3.8) - np.log(10.0)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


class TestSamplers:
    """Moment checks with deterministic keys (n=200k, ~3-sigma bounds)."""

    N = 200_000

    def _check_moments(self, dist, key, mean, var, tol_sigma=4.0):
        xs = dist.sample(key, (self.N,))
        xs = np.asarray(xs, np.float64)
        se_mean = np.sqrt(var / self.N)
        assert abs(xs.mean() - mean) < tol_sigma * se_mean + 1e-6, (
            f"{type(dist).__name__}: mean {xs.mean()} vs {mean}"
        )
        rel = abs(xs.var() - var) / max(var, 1e-9)
        assert rel < 0.05, f"{type(dist).__name__}: var {xs.var()} vs {var}"

    def test_normal(self, key):
        self._check_moments(d.Normal(2.0, 3.0), key, 2.0, 9.0)

    def test_uniform(self, key):
        self._check_moments(d.Uniform(2.0, 9.5), key, 5.75, 7.5**2 / 12)

    def test_poisson(self, key):
        self._check_moments(d.Poisson(4.2), key, 4.2, 4.2)

    def test_beta(self, key):
        self._check_moments(d.Beta(2.0, 3.0), key, 0.4, 0.04)

    def test_gamma(self, key):
        self._check_moments(d.Gamma(2.0, 1.5), key, 3.0, 4.5)

    def test_laplace(self, key):
        self._check_moments(d.Laplace(1.0, 2.0), key, 1.0, 8.0)

    def test_categorical(self, key):
        dist = d.Categorical(jnp.array([0.2, 0.3, 0.5]))
        self._check_moments(dist, key, 1.3, float(dist.variance))

    def test_uniform_int(self, key):
        self._check_moments(d.UniformInt(2, 7), key, 4.5, 35 / 12)

    def test_bernoulli(self, key):
        self._check_moments(d.Bernoulli(0.3), key, 0.3, 0.21)

    def test_mixture(self, key):
        comp = d.Normal(jnp.array([-1.0, 2.0]), jnp.array([0.5, 1.5]))
        mix = d.Mixture(comp, jnp.array([0.3, 0.7]))
        mean = 0.3 * -1.0 + 0.7 * 2.0
        ex2 = 0.3 * (0.25 + 1.0) + 0.7 * (2.25 + 4.0)
        self._check_moments(mix, key, mean, ex2 - mean**2)

    def test_truncated_normal_icdf(self, key):
        tr = d.Truncated(d.Normal(0.0, 1.0), -1.0, 2.0)
        xs = np.asarray(tr.sample(key, (self.N,)))
        assert xs.min() >= -1.0 and xs.max() <= 2.0
        want_mean = sps.truncnorm.mean(-1.0, 2.0)
        assert abs(xs.mean() - want_mean) < 0.01

    def test_truncated_mixture_rejection(self, key):
        comp = d.Normal(jnp.array([-1.0, 2.0]), jnp.array([0.5, 1.5]))
        tr = d.Truncated(d.Mixture(comp, jnp.array([0.3, 0.7])), 0.0, 3.0)
        xs = np.asarray(jax.vmap(tr.sample)(jax.random.split(key, 20_000)))
        assert xs.min() >= 0.0 and xs.max() <= 3.0

    def test_mvn_diag(self, key):
        loc = jnp.array([1.0, 2.0])
        scale = jnp.array([2.0, 0.5])
        xs = np.asarray(d.MultivariateNormalDiag(loc, scale).sample(key, (self.N,)))
        assert xs.shape == (self.N, 2)
        np.testing.assert_allclose(xs.mean(0), [1.0, 2.0], atol=0.05)
        np.testing.assert_allclose(xs.var(0), [4.0, 0.25], rtol=0.05)


class TestJitVmap:
    def test_log_prob_jits(self, key):
        f = jax.jit(lambda x: d.Normal(0.0, 1.0).log_prob(x))
        assert np.isfinite(f(0.3))

    def test_sample_vmaps(self, key):
        keys = jax.random.split(key, 16)
        xs = jax.vmap(lambda k: d.Gamma(2.0, 1.0).sample(k))(keys)
        assert xs.shape == (16,)

    def test_grad_through_log_prob(self):
        g = jax.grad(lambda mu: d.Normal(mu, 1.0).log_prob(2.0))(0.0)
        np.testing.assert_allclose(float(g), 2.0, atol=1e-5)


class TestExtendedDistributions:
    """Beyond-reference additions: LogNormal, HalfNormal, StudentT, Cauchy."""

    def test_lognormal(self, key):
        dist = d.LogNormal(0.5, 0.8)
        x = np.linspace(0.05, 10, 21, dtype=np.float32)
        got = np.asarray(dist.log_prob(x))
        want = sps.lognorm.logpdf(x, 0.8, scale=np.exp(0.5))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        xs = np.asarray(dist.sample(key, (100_000,)))
        assert abs(xs.mean() - float(dist.mean)) < 0.05 * float(dist.mean)
        assert np.isneginf(dist.log_prob(-1.0))

    def test_halfnormal(self, key):
        dist = d.HalfNormal(2.0)
        x = np.linspace(0.0, 8, 17, dtype=np.float32)
        got = np.asarray(dist.log_prob(x))
        want = sps.halfnorm.logpdf(x, scale=2.0)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        xs = np.asarray(dist.sample(key, (100_000,)))
        assert xs.min() >= 0
        assert abs(xs.mean() - 2.0 * np.sqrt(2 / np.pi)) < 0.02

    def test_student_t(self, key):
        dist = d.StudentT(5.0, 1.0, 2.0)
        x = np.linspace(-8, 10, 25, dtype=np.float32)
        got = np.asarray(dist.log_prob(x))
        want = sps.t.logpdf(x, 5.0, loc=1.0, scale=2.0)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        xs = np.asarray(dist.sample(key, (200_000,)))
        assert abs(xs.mean() - 1.0) < 0.03

    def test_cauchy(self, key):
        dist = d.Cauchy(0.5, 1.5)
        x = np.linspace(-10, 10, 25, dtype=np.float32)
        got = np.asarray(dist.log_prob(x))
        want = sps.cauchy.logpdf(x, 0.5, 1.5)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(dist.cdf(x)), sps.cauchy.cdf(x, 0.5, 1.5), atol=1e-5
        )
        xs = np.asarray(dist.sample(key, (50_000,)))
        assert abs(np.median(xs) - 0.5) < 0.03

    def test_truncated_cauchy_icdf(self, key):
        tr = d.Truncated(d.Cauchy(0.0, 1.0), -2.0, 5.0)
        xs = np.asarray(tr.sample(key, (50_000,)))
        assert xs.min() >= -2.0 and xs.max() <= 5.0

    def test_mvn_full(self, key):
        cov = np.array([[2.0, 0.8], [0.8, 1.0]], np.float32)
        loc = np.array([1.0, -1.0], np.float32)
        dist = d.MultivariateNormalFull.from_covariance(loc, cov)
        x = np.array([0.5, 0.0], np.float32)
        got = float(dist.log_prob(x))
        want = sps.multivariate_normal.logpdf(x, loc, cov)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        xs = np.asarray(dist.sample(key, (200_000,)))
        np.testing.assert_allclose(xs.mean(0), loc, atol=0.02)
        np.testing.assert_allclose(np.cov(xs.T), cov, atol=0.03)


class TestDefensiveMixture:
    def test_log_prob_and_bounded_weights(self, key):
        from cpprob_jax.distributions import DefensiveMixture, Normal, Uniform

        prop = Normal(2.0, 0.05)         # over-confident proposal
        anchor = Uniform(0.0, 4.0)       # prior
        d = DefensiveMixture(prop, anchor, 0.25)
        xs = jnp.linspace(0.1, 3.9, 64)
        want = np.logaddexp(
            np.log(0.75) + np.asarray(prop.log_prob(xs)),
            np.log(0.25) + np.asarray(anchor.log_prob(xs)),
        )
        np.testing.assert_allclose(np.asarray(d.log_prob(xs)), want, rtol=1e-5)
        # defensive bound: prior/q <= 1/lam everywhere
        ratio = np.exp(np.asarray(anchor.log_prob(xs)) - np.asarray(d.log_prob(xs)))
        assert ratio.max() <= 1.0 / 0.25 + 1e-3

    def test_sampling_mixes(self, key):
        from cpprob_jax.distributions import DefensiveMixture, Normal, Uniform

        d = DefensiveMixture(Normal(2.0, 0.05), Uniform(0.0, 4.0), 0.5)
        xs = np.asarray(d.sample(key, (20_000,)))
        # half the mass is a tight spike at 2, half uniform on [0,4]
        frac_spike = np.mean(np.abs(xs - 2.0) < 0.2)
        assert 0.5 < frac_spike < 0.62
        assert xs.min() < 0.5 and xs.max() > 3.5

    def test_event_dim_components(self, key):
        """ADVICE r3 (low): components with event dims (MVN) must broadcast
        against the per-draw component pick."""
        from cpprob_jax.distributions import (
            DefensiveMixture,
            MultivariateNormalDiag,
        )

        d = DefensiveMixture(
            MultivariateNormalDiag(jnp.zeros(3), jnp.full(3, 0.1)),
            MultivariateNormalDiag(jnp.full(3, 5.0), jnp.full(3, 0.1)),
            0.5,
        )
        xs = np.asarray(d.sample(key, (512,)))
        assert xs.shape == (512, 3)
        # each DRAW is wholly one component (not mixed per coordinate)
        near0 = np.abs(xs) < 1.0
        near5 = np.abs(xs - 5.0) < 1.0
        assert np.all(near0.all(axis=1) | near5.all(axis=1))
        frac = near5.all(axis=1).mean()
        assert 0.4 < frac < 0.6
