"""SHERPA-family model tests: histogram invariants, channel-conditioned
structure, ABC observe, CSIS with FC/LSTM/CNN3D observation embeddings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.core import handlers
from cpprob_jax.inference.csis import CSIS
from cpprob_jax.models import (
    CHANNEL_MOMENTA,
    calo_simulation,
    sherpa_calorimeter_wrapper,
    sherpa_mini,
    sherpa_mini_wrapper,
)


def _run_prior(model, args, key):
    tr = handlers.TraceHandler()
    pc = handlers.PredictCollector()
    with handlers.Seed(key), handlers.SimulateObserves(), tr, pc:
        out = model(*args)
    return out, tr, pc


class TestSherpaMini:
    def test_histogram_mass(self, key):
        with handlers.Seed(key), handlers.PredictCollector() as pc:
            img = sherpa_mini()
        channel = int(pc.predicts["Channel"][0])
        total_e = float(np.sum(CHANNEL_MOMENTA[: channel + 1, 3]))
        # nearly all deposits land inside [-1,1]^2 for these momenta
        assert float(jnp.sum(img)) <= total_e + 1e-4
        assert float(jnp.sum(img)) > 0.25 * total_e

    def test_wrapper_weights(self, key):
        # observing its own prior draw must give a finite log-weight
        with handlers.Seed(key):
            img = sherpa_mini()
        res = ct.sis(sherpa_mini_wrapper, (np.asarray(img),), 64, key)
        assert np.all(np.isfinite(np.asarray(res.log_weights)))

    def test_channel_identifiable(self, key):
        """SIS on a channel-0 image should put posterior mass on channel 0."""
        with handlers.Seed(jax.random.key(123)), handlers.PredictCollector() as pc:
            img = sherpa_mini()
        true_channel = int(pc.predicts["Channel"][0])
        res = ct.sis(sherpa_mini_wrapper, (np.asarray(img),), 256, key)
        emp = res.empirical("Channel")
        est = int(np.asarray(emp.map_estimate(4)))
        assert est == true_channel


class TestCalorimeter:
    def test_energy_deposition(self, key):
        particles = np.zeros((2, 8), np.float32)
        particles[0] = [1.0, 0.1, 3.0, 5.0, 0.2, 0.1, 211.0, 1.0]
        particles[1] = [0.5, -0.2, 2.0, 3.0, -0.1, 0.4, 11.0, 1.0]
        with handlers.Seed(key):
            hist = calo_simulation(particles)
        assert hist.shape == (35, 35, 20)
        assert float(jnp.sum(hist)) > 0.0

    def test_invisible_particle_deposits_nothing(self, key):
        particles = np.zeros((1, 8), np.float32)
        particles[0] = [1.0, 0.1, 3.0, 5.0, 0.2, 0.1, 211.0, 0.0]  # invisible
        with handlers.Seed(key):
            hist = calo_simulation(particles)
        assert float(jnp.sum(hist)) == 0.0

    def test_full_wrapper_abc(self, key):
        with handlers.Seed(jax.random.key(5)):
            obs_hist = calo_simulation(
                np.array([[1, 0.1, 3, 5, 0.2, 0.1, 211, 1]], np.float32)
            )
        res = ct.sis(
            sherpa_calorimeter_wrapper, (np.asarray(obs_hist),), 32, key
        )
        assert np.all(np.isfinite(np.asarray(res.log_weights)))
        assert "Decay Channel" in res.predicts
        assert "Momentum X" in res.predicts

    def test_abc_temper_scales_log_weights_exactly(self, key):
        """abc_temper is a power posterior: log-weights divide by tau
        exactly, so template ranking (and channel recovery) is invariant."""
        with handlers.Seed(jax.random.key(5)):
            obs_hist = calo_simulation(
                np.array([[1, 0.1, 3, 5, 0.2, 0.1, 211, 1]], np.float32)
            )

        def m1(obs):
            return sherpa_calorimeter_wrapper(obs, abc_temper=1.0)

        def m50(obs):
            return sherpa_calorimeter_wrapper(obs, abc_temper=50.0)

        r1 = ct.sis(m1, (np.asarray(obs_hist),), 64, key)
        r50 = ct.sis(m50, (np.asarray(obs_hist),), 64, key)
        np.testing.assert_allclose(
            np.asarray(r50.log_weights),
            np.asarray(r1.log_weights) / 50.0,
            rtol=1e-5, atol=1e-5,
        )
        assert float(r50.ess) > float(r1.ess)


class TestObsEmbeddings:
    def _tiny_model(self):
        from cpprob_jax.distributions import Normal

        def m(y):
            mu = ct.sample(Normal(0.0, 1.0), addr="mu")
            for i in range(4):
                ct.observe(Normal(mu, 0.5), y[i], addr=f"y[{i}]")
            ct.predict(mu, "Mu")

        return m

    def test_lstm_obs_embedding_trains(self, key):
        m = self._tiny_model()
        eng = CSIS(m, (jnp.zeros(4),), obs_embedding="lstm")
        params, losses = eng.compile(jax.random.key(0), steps=100, batch_size=64)
        assert float(losses[-1]) < float(losses[0])
        res = eng.infer(params, (jnp.full(4, 1.0),), 2000, key)
        assert float(res.ess) > 100

    def test_cnn3d_obs_embedding(self, key):
        from cpprob_jax.distributions import Normal

        def m(vol):
            mu = ct.sample(Normal(0.0, 1.0), addr="mu")
            ct.observe(
                ct.distributions.MultivariateNormalDiag(
                    jnp.full(8, mu), 0.5
                ),
                jnp.ravel(vol), addr="vol",
            )
            ct.predict(mu, "Mu")

        eng = CSIS(m, (jnp.zeros((2, 2, 2)),), obs_embedding="cnn3d",
                   obs_shape=(2, 2, 2))
        params, losses = eng.compile(jax.random.key(0), steps=80, batch_size=64)
        assert np.isfinite(float(losses[-1]))
        res = eng.infer(params, (jnp.full((2, 2, 2), 0.7),), 1000, key)
        assert np.isfinite(float(res.mean("Mu")))
