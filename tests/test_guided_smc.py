"""Guided SMC (learned per-step proposals): training converges, estimator
stays exact (RN-corrected), ESS improves over bootstrap SMC, plus DRO
regularizer sanity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.inference.regularize import chi_square_weights, dro_loss
from cpprob_jax.inference.smc import smc
from cpprob_jax.inference.smc_csis import guide_ssm, train_ssm_proposal
from cpprob_jax.models import (
    hmm_ssm,
    kalman_filter_1d,
    linear_gaussian_ssm,
)


class TestGuidedSMC:
    T = 12

    @pytest.fixture(scope="class")
    def lg_guide(self):
        params, losses = train_ssm_proposal(
            linear_gaussian_ssm, jax.random.key(0), self.T,
            kind="normal", steps=250, batch_size=256,
        )
        return params, losses

    def test_training_converges(self, lg_guide):
        _, losses = lg_guide
        assert float(losses[-10:].mean()) < float(losses[:10].mean())

    def test_guided_evidence_exact(self, lg_guide, key):
        params, _ = lg_guide
        obs = jnp.asarray(
            np.random.RandomState(3).normal(0, 1.3, self.T), jnp.float32
        )
        guided = guide_ssm(linear_gaussian_ssm, params, self.T, kind="normal")
        res = smc(guided, obs, 8192, key)
        _, _, ll = kalman_filter_1d(obs)
        assert abs(float(res.log_evidence) - float(ll)) < 0.15

    def test_guided_needs_fewer_resamples(self, lg_guide, key):
        """A good proposal keeps ESS higher -> fewer resampling epochs than
        the bootstrap filter on outlier-ish observations."""
        params, _ = lg_guide
        obs = jnp.asarray(
            np.random.RandomState(11).normal(0, 2.0, self.T), jnp.float32
        )
        guided = guide_ssm(linear_gaussian_ssm, params, self.T, kind="normal")
        res_g = smc(guided, obs, 4096, key, ess_threshold=0.5)
        res_b = smc(linear_gaussian_ssm, obs, 4096, key, ess_threshold=0.5)
        assert int(np.asarray(res_g.resampled).sum()) <= int(
            np.asarray(res_b.resampled).sum()
        )

    def test_discrete_hmm_guide(self, key):
        params, losses = train_ssm_proposal(
            hmm_ssm, jax.random.key(1), 8,
            kind="discrete", n_states=3, steps=150, batch_size=256,
        )
        assert float(losses[-1]) < float(losses[0])
        obs = jnp.array([0.9, -0.8, 0.7, 0.0, 1.1, -1.0, 0.5, 0.2])
        guided = guide_ssm(hmm_ssm, params, 8, kind="discrete", n_states=3)
        res_g = smc(guided, obs, 4096, key)
        res_b = smc(hmm_ssm, obs, 4096, key)
        # evidence must agree (both exact)
        assert abs(float(res_g.log_evidence) - float(res_b.log_evidence)) < 0.3


class TestDRO:
    def test_weights_sum_to_one(self):
        losses = jnp.asarray(np.random.RandomState(0).normal(0, 1, 64))
        w = chi_square_weights(losses, rho=0.5)
        np.testing.assert_allclose(float(jnp.sum(w)), 1.0, atol=1e-3)
        assert float(jnp.min(w)) >= 0.0

    def test_upweights_high_losses(self):
        losses = jnp.asarray(np.linspace(0, 1, 32), jnp.float32)
        w = np.asarray(chi_square_weights(losses, rho=0.5))
        assert w[-1] > w[0]

    def test_dro_loss_geq_mean(self):
        losses = jnp.asarray(np.random.RandomState(1).normal(0, 1, 64),
                             jnp.float32)
        assert float(dro_loss(losses, 0.5)) >= float(jnp.mean(losses)) - 1e-4

    def test_zero_rho_is_mean(self):
        losses = jnp.asarray(np.random.RandomState(2).normal(0, 1, 64),
                             jnp.float32)
        np.testing.assert_allclose(
            float(dro_loss(losses, 1e-8)), float(jnp.mean(losses)), atol=1e-2
        )

    def test_csis_with_dro_trains(self, key):
        from cpprob_jax.inference.csis import CSIS
        from cpprob_jax.models import gaussian_unknown_mean_readme

        eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
        params, losses = eng.compile(
            jax.random.key(0), steps=80, batch_size=64, dro_rho=0.3
        )
        assert np.isfinite(float(losses[-1]))
        res = eng.infer(params, (3.0, 4.0), 5000, key)
        assert np.isfinite(float(res.mean("Mean")))
