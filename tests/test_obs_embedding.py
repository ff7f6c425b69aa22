"""Structured observation embeddings (reference infcomp/nn/observation.py):
per-observe-site embedders (CNN3D for volumetric sites, MLP otherwise)
composed by an LSTM over the site sequence ('site-lstm'), and the end-to-end
SHERPA-scale guided test: CSIS with a CNN3D observation embedding on the 3-D
calorimeter recovers the decay channel better than prior SIS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.core import handlers
from cpprob_jax.distributions import MultivariateNormalDiag, Normal
from cpprob_jax.inference.csis import CSIS, embed_observation
from cpprob_jax.models.sherpa import sherpa_calorimeter_wrapper

BINS = (7, 7, 5)          # reduced-but-3D calorimeter volume for CI
MAXDEP = 256
VOX = BINS[0] * BINS[1] * BINS[2]


def calo_model(observed, temper=1.0):
    return sherpa_calorimeter_wrapper(
        observed, n_bins=BINS, max_deposits=MAXDEP, abc_temper=temper
    )


def _observed_for_channel(ch: int):
    """Simulate the calorimeter for a known channel (Substitute pins the
    channel-selecting uniform)."""
    tr = handlers.TraceHandler()
    with handlers.Seed(jax.random.key(7)), handlers.Substitute(
        {"channel_u": jnp.float32(ch + 0.5)}
    ), handlers.SimulateObserves(), tr:
        calo_model(jnp.zeros(VOX))
    return tr.trace["calo"]["value"]


def _channel_posterior(res):
    ch = np.asarray(res.predicts["Decay Channel"])
    w = np.asarray(res.normalized_weights)
    return np.array([(w * (ch == c)).sum() for c in range(4)])


class TestSiteLSTM:
    def test_mixed_shapes_embed_and_train(self):
        """Model with a volumetric observe + two scalar observes: 'site-lstm'
        builds a CNN3D embedder for the volume, MLPs for scalars, LSTM over
        the 3-site sequence; training runs and improves."""

        def model(vol_obs, y1, y2):
            mu = ct.sample(Normal(0.0, 1.0), addr="mu")
            base = jnp.zeros((4, 4, 3)) + mu
            ct.observe(
                MultivariateNormalDiag(base.ravel(), 0.5),
                jnp.ravel(jnp.asarray(vol_obs, jnp.float32)).reshape(48),
                addr="vol",
            )
            ct.observe(Normal(mu, 1.0), y1, addr="y1")
            ct.observe(Normal(mu, 1.0), y2, addr="y2")
            ct.predict(mu, "Mu")

        # NB: observe shape (48,) is flat here; reshape the volumetric site
        # in the model's own terms — shapes recorded from the trace
        eng = CSIS(
            model, (jnp.zeros(48), 0.0, 0.0),
            embedding_dim=32, obs_embedding="site-lstm",
        )
        assert eng.structure.observe_shapes == ((48,), (), ())
        params, losses = eng.compile(
            jax.random.key(0), steps=150, batch_size=64, unroll=10
        )
        assert float(losses[-1]) < float(losses[0])
        res = eng.infer(params, (jnp.full(48, 1.2), 1.2, 1.2), 500,
                        jax.random.key(1))
        assert np.isfinite(float(res.log_evidence))

    def test_volumetric_site_uses_conv3d(self):
        """A 3-D-shaped observe site gets a conv3d embedder in 'site-lstm'."""

        def model(vol):
            mu = ct.sample(Normal(0.0, 1.0), addr="mu")
            ct.observe(
                MultivariateNormalDiag(
                    (jnp.zeros(BINS) + mu).ravel().reshape(BINS), 1.0
                ),
                jnp.asarray(vol, jnp.float32),
                addr="vol",
            )
            ct.predict(mu, "Mu")

        eng = CSIS(
            model, (jnp.zeros(BINS),), embedding_dim=16,
            obs_embedding="site-lstm",
        )
        assert eng.structure.observe_shapes == (BINS,)
        params = eng.init(jax.random.key(0))
        assert "conv3d" in params["obs_net"]["sites"]["vol"]
        emb = embed_observation(
            params, jnp.zeros((3, VOX)), "site-lstm",
            structure=eng.structure,
        )
        assert emb.shape == (3, 16)


class TestSherpaCNN3DGuided:
    @pytest.fixture(scope="class")
    def engine(self):
        eng = CSIS(
            calo_model, (jnp.zeros(VOX),),
            embedding_dim=32, obs_embedding="cnn3d", obs_shape=BINS,
        )
        # 900 steps: the hadronic channel-3 product (pdg 211, deeper/noisier
        # shower) needs more training than the all-EM source did for the
        # CNN3D net to separate it (loss ~5.5 -> ~0.17)
        params, losses = eng.compile(
            jax.random.key(0), steps=900, batch_size=64, unroll=10,
            learning_rate=2e-3,
        )
        return eng, params, losses

    def test_training_improves(self, engine):
        _, _, losses = engine
        losses = np.asarray(losses)
        assert np.isfinite(losses).all()
        assert losses[-20:].mean() < losses[:20].mean()

    def test_guided_recovers_channel_better_than_prior(self, engine):
        """The thesis SHERPA capability: amortized CNN3D proposal identifies
        the decay channel from the calorimeter volume; guided SIS
        concentrates on it with far higher ESS than prior SIS."""
        eng, params, _ = engine
        n = 512
        wins_guided = 0
        ess_ratio = []
        for ch in [0, 1, 2, 3]:
            observed = _observed_for_channel(ch)
            guided = eng.infer(params, (observed,), n, jax.random.key(ch))
            prior = ct.sis(calo_model, (observed,), n, jax.random.key(ch))
            pg = _channel_posterior(guided)
            pp = _channel_posterior(prior)
            if int(pg.argmax()) == ch:
                wins_guided += 1
            # ESS comparison under a mild temper: at the exact counting
            # tolerance BOTH proposals are shot-noise-saturated (ESS ~ 1-5
            # out of 512) and the ratio is statistical noise; tempering by 4
            # keeps the posterior sharp while making ESS informative (see
            # models/sherpa.py abc_temper)
            g4 = eng.infer(params, (observed, jnp.float32(4.0)), n,
                           jax.random.key(100 + ch))
            p4 = ct.sis(calo_model, (observed, jnp.float32(4.0)), n,
                        jax.random.key(100 + ch))
            ess_ratio.append(float(g4.ess) / max(float(p4.ess), 1e-9))
            # guided posterior mass on the true channel at least matches prior
            assert pg[ch] > 0.5 * pp[ch] - 0.05, (ch, pg, pp)
        assert wins_guided >= 3, wins_guided
        # amortization pays: the CNN3D proposal routes particles to the right
        # channel, so guided ESS beats prior ESS for EVERY volume (the
        # channel choice alone is worth <= 4x)
        assert min(ess_ratio) > 1.0, ess_ratio
        assert np.mean(ess_ratio) > 1.5, ess_ratio
