"""scan_sites — effect-aware lax.scan over model sites.

Fast path (Seed/LogWeight/PredictCollector/CSIS messenger stacks) must match
the unrolled execution statistically; fallback path (TraceHandler etc.) must
produce exactly the per-step addresses of the unrolled twin, so structure
discovery and CSIS training are unchanged.  The T=512 case pins the verdict
round-1 item: guided-SIS compile time O(#site groups), not O(T).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

import cpprob_jax as ct
from cpprob_jax.core import handlers
from cpprob_jax.inference.csis import CSIS, discover_structure
from cpprob_jax.inference.sis import sis
from cpprob_jax.models import hmm, hmm_exact_posterior, hmm_scan


def _marginals(res):
    states = np.asarray(res.predicts["State"])
    w = np.asarray(res.normalized_weights)
    return np.stack([(w[:, None] * (states == s)).sum(0) for s in range(3)], 1)


def _simulate_obs(T):
    tr = handlers.TraceHandler()
    with handlers.Seed(jax.random.key(99)), handlers.SimulateObserves(), tr:
        hmm(jnp.zeros(T))
    return jnp.stack([tr.trace[f"y[{t}]"]["value"] for t in range(T)])


class TestFallbackParity:
    def test_discovery_addresses_match_unrolled(self):
        """TraceHandler in the stack => unrolled fallback => identical
        addresses and site families to the hand-unrolled model."""
        T = 8
        s1 = discover_structure(hmm, (jnp.zeros(T),))
        s2 = discover_structure(hmm_scan, (jnp.zeros(T),))
        assert [x.addr for x in s1.sites] == [x.addr for x in s2.sites]
        assert [x.kind for x in s1.sites] == [x.kind for x in s2.sites]
        assert s1.observe_addrs == s2.observe_addrs

    def test_trace_values_roundtrip(self):
        """Same key => fallback scan model and unrolled model produce
        identical traces (same Seed count sequence)."""
        T = 6
        t1, t2 = handlers.TraceHandler(), handlers.TraceHandler()
        with handlers.Seed(jax.random.key(3)), handlers.SimulateObserves(), t1:
            hmm(jnp.zeros(T))
        with handlers.Seed(jax.random.key(3)), handlers.SimulateObserves(), t2:
            hmm_scan(jnp.zeros(T))
        for k in t1.trace:
            np.testing.assert_allclose(
                np.asarray(t1.trace[k]["value"]),
                np.asarray(t2.trace[k]["value"]),
            )


class TestFastPathSIS:
    def test_prior_sis_matches_unrolled(self):
        obs = _simulate_obs(16)
        exact = np.asarray(hmm_exact_posterior(obs))
        r1 = ct.sis(hmm, (obs,), 50_000, jax.random.key(0))
        r2 = ct.sis(hmm_scan, (obs,), 50_000, jax.random.key(0))
        assert r2.predicts["State"].shape == r1.predicts["State"].shape
        m1, m2 = _marginals(r1), _marginals(r2)
        # prior SIS on T=16 leaves ESS ~ few hundred => MC error ~ 1/sqrt(ESS)
        assert np.abs(m1 - m2).max() < 0.15
        assert np.abs(m1 - exact).max() < 0.12
        assert np.abs(m2 - exact).max() < 0.12
        assert abs(float(r1.log_evidence) - float(r2.log_evidence)) < 0.3


class TestFastPathGuided:
    def test_guided_scan_matches_unrolled_and_beats_prior(self):
        T = 16
        obs = _simulate_obs(T)
        exact = np.asarray(hmm_exact_posterior(obs))
        eng = CSIS(hmm_scan, (jnp.zeros(T),), tie_addresses=True)
        params, losses = eng.compile(
            jax.random.key(0), steps=400, batch_size=256, unroll=20
        )
        assert float(losses[-1]) < float(losses[0])

        n = 1000
        r_scan = eng.infer(params, (obs,), n, jax.random.key(5))
        factory = eng.proposal_factory(params, (obs,))
        r_unroll = sis(
            hmm, (obs,), n, jax.random.key(5), proposal_messenger=factory
        )
        r_prior = ct.sis(hmm, (obs,), n, jax.random.key(5))
        l2 = lambda r: float(np.sum((_marginals(r) - exact) ** 2))
        l2_scan, l2_unroll, l2_prior = l2(r_scan), l2(r_unroll), l2(r_prior)
        # the thesis headline: guided beats prior SIS by >= 3x summed-L2 at
        # 10^3 particles (thesis ch. 6.3)
        assert l2_prior > 3.0 * l2_scan, (l2_scan, l2_prior)
        assert l2_scan < 5.0 * max(l2_unroll, 1e-3), (l2_scan, l2_unroll)

    def test_t512_guided_compiles_fast(self):
        """The headline scaling property: guided SIS on a length-512 HMM —
        the scan fast path keeps the program O(#site groups), so build +
        compile + run stays interactive (the unrolled path would trace 512
        LSTM steps and take minutes to compile)."""
        T = 512
        eng = CSIS(hmm_scan, (jnp.zeros(T),), tie_addresses=True)
        params = eng.init(jax.random.key(0))
        obs = jnp.zeros(T)
        t0 = time.time()
        res = eng.infer(params, (obs,), 256, jax.random.key(1))
        dt = time.time() - t0
        assert np.isfinite(float(res.log_evidence))
        assert res.predicts["State"].shape == (256, T)
        assert dt < 90.0, f"guided T=512 took {dt:.1f}s"


class TestMixedHandlers:
    def test_logjoint_scan(self):
        """LogJoint (LogWeight subclass) threads through the scan carry:
        prior log-probs of all T sites accumulate (HMC potential path)."""
        T = 6
        obs = jnp.zeros(T)
        lj = handlers.LogJoint()
        with handlers.Seed(jax.random.key(0)), lj:
            hmm_scan(obs)
        lw = float(lj.log_weight)
        assert np.isfinite(lw)
        # includes T observe terms and T latent prior terms
        assert lw < -T * 0.5
