"""Dynamic-structure CSIS (trace bucketing) tests.

Counterpart of the reference's subbatch-by-address-sequence training
(``infcomp/data_structures.py:32-41``): a model with a Python ``while`` on a
sampled value (untraceable under vmap/jit) trains one shared network from
host-generated traces bucketed by structure, and guided inference dispatches
heads by address with prior fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.distributions import Bernoulli, Normal
from cpprob_jax.inference.csis_dynamic import DynamicCSIS, sis_host

P_MORE = 0.4
K_MAX = 6
OBS_STD = 0.5


def dyn_model(y):
    """Geometric number of latent sites — genuinely dynamic structure."""
    k = 0
    while k < K_MAX and int(ct.sample(Bernoulli(P_MORE), addr=f"more[{k}]")) == 1:
        k += 1
    mu = ct.sample(Normal(float(k), 1.0), addr="mu")
    ct.observe(Normal(mu, OBS_STD), y, addr="y")
    ct.predict(mu, "Mu")
    return mu


def exact_posterior_mean_mu(y):
    """Enumerate k: p(k|y) ∝ p(k) N(y; k, 1+OBS_STD²); E[mu|y,k] conjugate."""
    v = 1.0 + OBS_STD**2
    pk = np.array(
        [P_MORE**k * (1 - P_MORE) for k in range(K_MAX)] + [P_MORE**K_MAX]
    )
    ks = np.arange(K_MAX + 1, dtype=np.float64)
    lik = np.exp(-0.5 * (y - ks) ** 2 / v) / np.sqrt(v)
    post_k = pk * lik
    post_k /= post_k.sum()
    prec = 1.0 + 1.0 / OBS_STD**2
    mu_given_k = (ks + y / OBS_STD**2) / prec
    return float((post_k * mu_given_k).sum())


@pytest.fixture(scope="module")
def trained():
    eng = DynamicCSIS(
        dyn_model, (0.0,), embedding_dim=32, bucket_batch=64, probe=128,
    )
    params, stats = eng.compile(jax.random.key(0), n_traces=6000)
    return eng, params, stats


def test_probe_finds_buckets(trained):
    eng, _, stats = trained
    assert stats["n_buckets"] >= 3           # several k-values realized
    assert "mu" in eng.spec_table
    assert "more[0]" in eng.spec_table
    assert eng.obs_dim == 1


def test_bucketed_training_losses_finite_and_improving(trained):
    _, _, stats = trained
    losses = np.asarray(stats["losses"])
    assert np.isfinite(losses).all()
    n = len(losses)
    assert losses[-n // 4 :].mean() < losses[: n // 4].mean()


def test_guided_inference_beats_prior(trained):
    eng, params, _ = trained
    y = 2.0
    n = 300
    guided = eng.infer(params, (y,), n, jax.random.key(5))
    prior = sis_host(dyn_model, (y,), n, jax.random.key(6))
    assert float(guided.ess) > 1.3 * float(prior.ess)
    # posterior mean of Mu vs enumeration
    want = exact_posterior_mean_mu(y)
    got = float(guided.mean("Mu"))
    assert abs(got - want) < 0.25, (got, want)


def test_prior_fallback_for_unknown_address(trained):
    """A site the probe never saw samples from the prior with RN = 0."""
    eng, params, _ = trained

    def model2(y):
        extra = ct.sample(Normal(0.0, 1.0), addr="never_seen")
        mu = ct.sample(Normal(0.0, 1.0), addr="mu")
        ct.observe(Normal(mu + 0.0 * extra, OBS_STD), y, addr="y")
        ct.predict(mu, "Mu")

    factory = eng.proposal_factory(params, (1.0,))
    res = sis_host(model2, (1.0,), 50, jax.random.key(7),
                   proposal_messenger=factory)
    assert np.isfinite(np.asarray(res.log_weights)).all()


def test_inconsistent_family_rejected():
    flip = {"n": 0}

    def bad():
        # same address alternates families across traces
        if flip["n"] % 2 == 0:
            ct.sample(Normal(0.0, 1.0), addr="x")
        else:
            ct.sample(Bernoulli(0.5), addr="x")
        flip["n"] += 1
        ct.observe(Normal(0.0, 1.0), 0.0, addr="y")

    with pytest.raises(ValueError, match="different families"):
        DynamicCSIS(bad, (), probe=4)


class TestVectorizedCompile:
    def test_vectorized_matches_and_speeds_up(self):
        """compile_vectorized: device-side batch generation trains to guided
        inference that beats prior; host work per trace drops by ~batch_size
        (traces/s measured before/after)."""
        import time

        eng = DynamicCSIS(
            dyn_model, (0.0,), embedding_dim=32, bucket_batch=64, probe=128,
        )
        n = 4096
        t0 = time.time()
        params_v, stats_v = eng.compile_vectorized(
            jax.random.key(0), n_traces=n, batch_size=64
        )
        t_vec = time.time() - t0
        assert stats_v["vectorized"] is True
        assert stats_v["n_buckets"] >= 3
        losses = np.asarray(stats_v["losses"])
        assert np.isfinite(losses).all()

        t0 = time.time()
        params_e, stats_e = eng.compile(jax.random.key(0), n_traces=n)
        t_eager = time.time() - t0
        print(f"traces/s vectorized {n / t_vec:,.0f} vs eager {n / t_eager:,.0f}")

        # guided inference from vectorized-trained params beats prior SIS
        y = 2.0
        guided = eng.infer(params_v, (y,), 300, jax.random.key(5))
        prior = sis_host(dyn_model, (y,), 300, jax.random.key(6))
        assert float(guided.ess) > 1.2 * float(prior.ess)
        w = np.asarray(guided.normalized_weights)
        got = float((w * np.asarray(guided.predicts["Mu"])).sum())
        assert abs(got - exact_posterior_mean_mu(y)) < 0.3

    def test_flow_on_continuous_falls_back(self):
        """A model branching on a continuous draw cannot be vectorized —
        compile_vectorized detects it at trace time and runs the host path."""

        def cont_flow_model(y):
            x = ct.sample(Normal(0.0, 1.0), addr="x")
            if float(x) > 0:                      # flow on continuous draw
                mu = ct.sample(Normal(1.0, 1.0), addr="mu_pos")
            else:
                mu = ct.sample(Normal(-1.0, 1.0), addr="mu_neg")
            ct.observe(Normal(mu, 1.0), y, addr="y")
            ct.predict(mu, "Mu")

        eng = DynamicCSIS(
            cont_flow_model, (0.0,), embedding_dim=16, probe=64,
        )
        params, stats = eng.compile_vectorized(
            jax.random.key(0), n_traces=256, batch_size=32
        )
        assert stats["vectorized"] is False
        assert np.isfinite(np.asarray(stats["losses"])).all()
