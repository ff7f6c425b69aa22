"""SMC tests: resampling invariants, evidence vs exact Kalman, filtered
marginals vs forward-backward (HMM)."""

import jax
import jax.numpy as jnp
import numpy as np

from cpprob_jax.inference import resampling
from cpprob_jax.inference.smc import smc
from cpprob_jax.models import (
    hmm_exact_posterior,
    hmm_ssm,
    kalman_filter_1d,
    linear_gaussian_ssm,
    HMM_MEANS,
)


class TestResampling:
    def _uniformity(self, resampler, key):
        """Resampling uniform weights must be (nearly) a no-op in counts."""
        n = 1024
        lw = jnp.zeros((n,))
        anc = np.asarray(resampler(key, lw))
        counts = np.bincount(anc, minlength=n)
        assert counts.max() <= 2 and counts.min() >= 0
        assert anc.shape == (n,)

    def test_systematic_uniform(self, key):
        self._uniformity(resampling.systematic_resample, key)

    def test_stratified_uniform(self, key):
        self._uniformity(resampling.stratified_resample, key)

    def test_counts_proportional(self, key):
        """Expected offspring counts == N * w_i (unbiasedness), checked for
        systematic resampling where counts are deterministic ±1."""
        n = 1000
        w = np.random.RandomState(0).dirichlet(np.ones(20))
        lw = jnp.log(jnp.asarray(np.repeat(w / 50, 50)))
        anc = np.asarray(resampling.systematic_resample(key, lw))
        counts = np.bincount(anc // 50, minlength=20)
        np.testing.assert_allclose(counts / n, w, atol=1.5 / 50)

    def test_residual(self, key):
        n = 512
        lw = jnp.log(jnp.arange(1, n + 1, dtype=jnp.float32))
        anc = np.asarray(resampling.residual_resample(key, lw))
        assert anc.shape == (n,) and anc.min() >= 0 and anc.max() < n
        # heaviest weight must receive at least its floor count
        w_last = float(n / (n * (n + 1) / 2) * n)

    def test_multinomial(self, key):
        lw = jnp.log(jnp.array([0.1, 0.2, 0.7]))
        anc = np.asarray(resampling.multinomial_resample(key, lw, 10_000))
        frac = np.bincount(anc, minlength=3) / 10_000
        np.testing.assert_allclose(frac, [0.1, 0.2, 0.7], atol=0.02)

    def test_ess(self):
        assert abs(float(resampling.ess(jnp.zeros(100))) - 100.0) < 1e-3
        lw = jnp.array([0.0, -jnp.inf, -jnp.inf])
        assert abs(float(resampling.ess(lw)) - 1.0) < 1e-5


class TestSMC:
    def test_linear_gaussian_evidence(self, key):
        obs = jnp.asarray(np.random.RandomState(1).normal(0, 1.5, size=20),
                          dtype=jnp.float32)
        res = smc(linear_gaussian_ssm, obs, 8192, key)
        _, _, ll = kalman_filter_1d(obs)
        assert abs(float(res.log_evidence) - float(ll)) < 0.15

    def test_linear_gaussian_filtered_means(self, key):
        obs = jnp.asarray(np.random.RandomState(2).normal(0, 1.0, size=15),
                          dtype=jnp.float32)
        res = smc(linear_gaussian_ssm, obs, 16384, key)
        ms, ps, _ = kalman_filter_1d(obs)
        got = np.asarray(res.filtered_mean())
        np.testing.assert_allclose(got, np.asarray(ms), atol=0.08)

    def test_hmm_filtered_marginals(self, key):
        obs = jnp.array([0.9, 0.8, 0.7, 0.0, -0.025, 5.0, 2.0, 0.1, 0.0, 0.13])
        res = smc(hmm_ssm, obs, 16384, key)
        # forward-only marginals for filtering comparison
        exact_sm = np.asarray(hmm_exact_posterior(obs))
        # smoothing != filtering; compare last step where they coincide
        states_T = np.asarray(res.final_states)
        w = np.asarray(jax.nn.softmax(res.final_log_weights))
        for s in range(3):
            est = float(np.sum(w * (states_T == s)))
            assert abs(est - exact_sm[-1, s]) < 0.03

    def test_resampling_triggers(self, key):
        obs = jnp.asarray(np.random.RandomState(3).normal(0, 2.0, size=30),
                          dtype=jnp.float32)
        res = smc(linear_gaussian_ssm, obs, 1024, key, ess_threshold=0.9)
        assert bool(np.asarray(res.resampled).any())

    def test_no_resampling_matches_sis(self, key):
        """ess_threshold=0 disables resampling; SMC == sequential SIS, so the
        evidence estimate equals logmeanexp of final weights."""
        obs = jnp.asarray([0.1, -0.2, 0.3], dtype=jnp.float32)
        res = smc(linear_gaussian_ssm, obs, 4096, key, ess_threshold=0.0)
        assert not bool(np.asarray(res.resampled).any())
        lw = np.asarray(res.final_log_weights)
        want = np.log(np.mean(np.exp(lw - lw.max()))) + lw.max()
        np.testing.assert_allclose(float(res.log_evidence), want, rtol=1e-5)

    def test_multinomial_smc(self, key):
        obs = jnp.asarray([0.1, -0.2, 0.3, 0.5], dtype=jnp.float32)
        res = smc(
            linear_gaussian_ssm, obs, 2048, key, resampling="multinomial",
            ess_threshold=1.0,
        )
        assert np.isfinite(float(res.log_evidence))
