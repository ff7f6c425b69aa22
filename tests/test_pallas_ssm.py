"""Fused discrete kernel from a user HMM spec: the Triton kernel in
interpret mode (real counter-based random bits) against its same-bits XLA
reference and closed forms, plus XLA-path statistical validation vs the
exact oracles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.inference.smc import build_smc_run
from cpprob_jax.inference.smc_csis import guide_ssm, train_ssm_proposal
from cpprob_jax.models.hmm import (
    HMM_MEANS,
    HMM_TRANS,
    discrete_hmm_log_evidence,
    discrete_hmm_smoothed_marginals,
)
from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm

# a deliberately asymmetric 5-state chain (not the reference's 3-state one)
TRANS5 = np.array(
    [
        [0.50, 0.20, 0.10, 0.10, 0.10],
        [0.05, 0.60, 0.20, 0.10, 0.05],
        [0.10, 0.10, 0.40, 0.30, 0.10],
        [0.20, 0.05, 0.05, 0.50, 0.20],
        [0.10, 0.10, 0.10, 0.10, 0.60],
    ]
)
MEANS5 = np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
STDS5 = np.array([0.5, 1.0, 0.7, 1.2, 0.9])
INIT5 = np.array([0.3, 0.1, 0.2, 0.2, 0.2])
N = 2 * 1024


def _cyclic(K):
    """Deterministic transitions s -> s+1 mod K: closed-form state paths."""
    return np.roll(np.eye(K), 1, axis=1)


def _spec(K):
    """Transition matrix, means, stds and initial distribution at K states."""
    if K == 3:
        return HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3)
    if K == 5:
        return TRANS5, MEANS5, STDS5, INIT5
    rng = np.random.default_rng(K)
    return (rng.dirichlet(np.ones(K), size=K), np.linspace(-3.0, 3.0, K),
            np.linspace(0.5, 1.6, K), np.full(K, 1.0 / K))


def _logpdf(y, mean, std):
    return -0.5 * ((y - mean) / std) ** 2 - np.log(std) - 0.5 * np.log(
        2 * np.pi)


class TestBuilderValidation:
    def test_rejects_nonsquare(self):
        with pytest.raises(ValueError):
            make_fused_discrete_ssm(np.ones((3, 4)) / 4, np.zeros(3))

    def test_rejects_bad_rows(self):
        t = TRANS5.copy()
        t[0, 0] += 0.5
        with pytest.raises(ValueError):
            make_fused_discrete_ssm(t, MEANS5)

    def test_rejects_nonpositive_std(self):
        with pytest.raises(ValueError):
            make_fused_discrete_ssm(TRANS5, MEANS5, np.zeros(5))


class TestDiscreteKernelInterpret:
    """Cyclic transitions make every state path known, so the generated
    arithmetic (CDF loads, emission table, masking, exchange synthesis)
    is checked against closed forms on real random bits."""

    def _ssm(self, K=5, **kw):
        return make_fused_discrete_ssm(
            _cyclic(K), MEANS5[:K] if K == 5 else np.linspace(-3, 3, K),
            STDS5[:K] if K == 5 else np.linspace(0.5, 1.6, K),
            interpret=True, **kw)

    def test_chunk_deterministic_weights(self):
        ssm = self._ssm()
        states = jnp.full((N,), 3, jnp.int32)
        ys = jnp.array([0.5, -0.25, 1.0])
        s, w, ess, cat_w, lme = ssm.fused_chunk_exchange_batch(
            jax.random.key(0), states, jnp.zeros((N,)), ys, jnp.int32(3),
            jnp.int32(0), jnp.zeros((4,), jnp.int32),
        )
        # path 3 -> 4 -> 0 -> 1
        expected = sum(_logpdf(y, MEANS5[k], STDS5[k])
                       for y, k in zip(np.asarray(ys), (4, 0, 1)))
        assert np.all(np.asarray(s) == 1)
        np.testing.assert_allclose(np.asarray(w), expected, rtol=2e-5)
        np.testing.assert_allclose(float(ess), N, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(cat_w), [0, 1.0, 0, 0, 0],
                                   atol=1e-6)
        np.testing.assert_allclose(float(lme), expected, rtol=2e-5)

    def test_ragged_tail_masking(self):
        ssm = self._ssm()
        states = jnp.full((N,), 2, jnp.int32)
        ys = jnp.array([0.5, 99.0, 99.0])  # steps 2, 3 invalid
        s, w, _, _, _ = ssm.fused_chunk_exchange_batch(
            jax.random.key(0), states, jnp.zeros((N,)), ys, jnp.int32(1),
            jnp.int32(0), jnp.zeros((4,), jnp.int32),
        )
        assert np.all(np.asarray(s) == 3)
        np.testing.assert_allclose(np.asarray(w),
                                   _logpdf(0.5, MEANS5[3], STDS5[3]),
                                   rtol=2e-5)

    def test_exchange_synthesis(self):
        """flag=1: population synthesized from category ticks, weights
        reset (incoming states and weights ignored)."""
        ssm = self._ssm()
        states = jnp.full((N,), 4, jnp.int32)
        log_w = jnp.full((N,), -123.0)
        ticks = jnp.asarray([100, 300, 600, 900], jnp.int32)
        s, w, _, cat_w, _ = ssm.fused_chunk_exchange_batch(
            jax.random.key(0), states, log_w, jnp.array([0.0]), jnp.int32(1),
            jnp.int32(1), ticks,
        )
        parents = np.searchsorted(np.asarray(ticks), np.arange(N),
                                  side="right")
        np.testing.assert_array_equal(np.asarray(s), (parents + 1) % 5)
        np.testing.assert_allclose(
            np.asarray(w), _logpdf(0.0, MEANS5, STDS5)[(parents + 1) % 5],
            rtol=2e-5)
        counts = np.bincount((parents + 1) % 5, minlength=5)
        e = np.exp(np.asarray(w, np.float64))
        want = np.array([e[(parents + 1) % 5 == k].sum() for k in range(5)])
        np.testing.assert_allclose(np.asarray(cat_w), want / e.sum(),
                                   atol=1e-6)
        assert counts.sum() == N

    def test_chunk_deterministic_weights_k12(self):
        """K=12: eleven CDF loads per step, still exact."""
        means, stds = np.linspace(-3, 3, 12), np.linspace(0.5, 1.6, 12)
        ssm = self._ssm(K=12)
        states = jnp.full((N,), 7, jnp.int32)
        ys = jnp.array([0.5, -0.25])
        s, w, _, _, lme = ssm.fused_chunk_exchange_batch(
            jax.random.key(0), states, jnp.zeros((N,)), ys, jnp.int32(2),
            jnp.int32(0), jnp.zeros((11,), jnp.int32),
        )
        expected = (_logpdf(0.5, means[8], stds[8])
                    + _logpdf(-0.25, means[9], stds[9]))
        assert np.all(np.asarray(s) == 9)
        np.testing.assert_allclose(np.asarray(w), expected, rtol=2e-5)
        np.testing.assert_allclose(float(lme), expected, rtol=2e-5)

    def test_init_kernel(self):
        ssm = make_fused_discrete_ssm(TRANS5, MEANS5, STDS5,
                                      [0.0, 0.0, 1.0, 0.0, 0.0],
                                      interpret=True)
        s, w, ess, cat_w, lme = ssm.fused_init_batch(
            jax.random.key(0), N, jnp.float32(0.25)
        )
        assert np.all(np.asarray(s) == 2)
        np.testing.assert_allclose(np.asarray(w),
                                   _logpdf(0.25, MEANS5[2], STDS5[2]),
                                   rtol=2e-5)

    def test_init_distribution(self):
        ssm = make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5,
                                      interpret=True)
        s = ssm.fused_init_batch(jax.random.key(1), 8 * 1024,
                                 jnp.float32(0.0))[0]
        frac = np.bincount(np.asarray(s), minlength=5) / (8 * 1024)
        np.testing.assert_allclose(frac, INIT5, atol=0.02)


@pytest.mark.parametrize("island_every", [0, 4])
@pytest.mark.parametrize("K", [3, 5, 12])
def test_kernel_matches_same_bits_reference(K, island_every):
    """Interpret-mode kernel vs the plain XLA reference on the same bits:
    identical states, weights to rounding, identical partials; a sweep
    from the fused init through a chunk with a forced exchange resample
    and a ragged tail."""
    trans, means, stds, init = _spec(K)
    kw = dict(island_every=island_every, island_thresh=0.7)
    kern = make_fused_discrete_ssm(trans, means, stds, init, interpret=True,
                                   **kw)
    ref = make_fused_discrete_ssm(trans, means, stds, init, reference=True,
                                  **kw)
    ys = jnp.asarray(np.random.default_rng(K).normal(0, 1.5, 11),
                     jnp.float32)
    k0, k1 = jax.random.split(jax.random.key(K))
    ik, ir = (m.fused_init_batch(k0, N, ys[0]) for m in (kern, ref))
    np.testing.assert_array_equal(np.asarray(ik[0]), np.asarray(ir[0]))
    np.testing.assert_allclose(np.asarray(ik[1]), np.asarray(ir[1]),
                               rtol=1e-6)
    ticks = jnp.asarray(np.linspace(0, N, K + 1)[1:-1].astype(np.int32))
    ck, cr = (m.fused_chunk_exchange_batch(
        k1, ik[0], ik[1], ys[1:], jnp.int32(9), jnp.int32(1), ticks,
        partials=True) for m in (kern, ref))
    np.testing.assert_array_equal(np.asarray(ck.states),
                                  np.asarray(cr.states))
    np.testing.assert_allclose(np.asarray(ck.log_weights),
                               np.asarray(cr.log_weights), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ck.partials),
                               np.asarray(cr.partials), rtol=1e-5)
    if island_every:
        assert np.asarray(ck.partials)[:, 3 + K].max() >= 1.0


class TestDiscreteXLAStatistical:
    """The builder's XLA reference paths (used by the engine when the fused
    kernels are unavailable) must reproduce the exact forward-recursion
    evidence and smoothed marginals — same oracle discipline as the 3-state
    reference model's tests."""

    def test_log_evidence_and_marginals(self, key):
        # simulate observations from the true model
        rng = np.random.default_rng(0)
        T = 12
        z = rng.choice(5, p=INIT5)
        ys = []
        for _ in range(T):
            ys.append(MEANS5[z] + STDS5[z] * rng.standard_normal())
            z = rng.choice(5, p=TRANS5[z])
        ys = jnp.asarray(np.array(ys), jnp.float32)

        ssm = make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5,
                                      reference=True)
        # store_history=True runs the plain per-step XLA path
        xla_ssm = dataclasses.replace(
            ssm, fused_chunk_exchange_batch=None, fused_init_batch=None,
        )
        n = 65536
        run = build_smc_run(xla_ssm, n, store_history=True)
        res = jax.jit(run)(key, ys)
        exact = discrete_hmm_log_evidence(TRANS5, MEANS5, STDS5, INIT5, ys)
        # MC error of an SMC evidence estimate at n=65536 on T=12 is well
        # under 0.05 nats for this signal-to-noise
        assert abs(float(res.log_evidence) - exact) < 0.1, (
            float(res.log_evidence), exact)

        post = discrete_hmm_smoothed_marginals(
            TRANS5, MEANS5, STDS5, INIT5, ys
        )
        lw = res.log_weights[-1]
        wts = np.asarray(jax.nn.softmax(lw))
        sT = np.asarray(res.final_states)
        est = np.array([(wts * (sT == k)).sum() for k in range(5)])
        np.testing.assert_allclose(est, post[-1], atol=0.02)


class TestGuidedDiscreteXLA:
    def test_xla_guided_fallback_statistical(self, key):
        """A trained per-step proposal installed with ``guide_ssm`` runs the
        engine's guided path, and the evidence matches the exact forward
        recursion (the RN weights stay exact)."""
        K, T = 5, 10
        base = make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5,
                                       reference=True)
        params, _ = train_ssm_proposal(
            base, jax.random.key(0), T, kind="discrete", n_states=K,
            steps=200, batch_size=256, hidden=16,
        )
        g = guide_ssm(base, params, T, kind="discrete", n_states=K)
        rng = np.random.default_rng(1)
        z = rng.choice(K, p=INIT5)
        ys = []
        for _ in range(T):
            ys.append(MEANS5[z] + STDS5[z] * rng.standard_normal())
            z = rng.choice(K, p=TRANS5[z])
        ys = jnp.asarray(np.array(ys), jnp.float32)
        run = jax.jit(build_smc_run(g, 16384))
        lzs = [
            float(np.asarray(run(jax.random.key(i), ys).log_evidence))
            for i in range(4)
        ]
        exact = discrete_hmm_log_evidence(TRANS5, MEANS5, STDS5, INIT5, ys)
        assert abs(np.mean(lzs) - exact) < 0.1, (np.mean(lzs), exact)


class TestSpecIslandInterior:
    """island_every on the kernel-from-spec discrete family: the
    whole-sweep-with-live-ESS configuration for any user spec."""

    TRANS2 = np.array([[0.8, 0.2], [0.3, 0.7]])

    def _chunk(self, **kw):
        ssm = make_fused_discrete_ssm(self.TRANS2, [-1.0, 1.0],
                                      interpret=True, **kw)
        ys = jnp.asarray(np.linspace(-1, 1, 8), jnp.float32)
        return ssm.fused_chunk_exchange_batch(
            jax.random.key(7), jnp.zeros((N,), jnp.int32),
            jnp.zeros((N,), jnp.float32), ys, jnp.int32(8), jnp.int32(0),
            jnp.zeros((1,), jnp.int32), partials=True)

    def test_off_matches_plain_bitwise(self):
        base = self._chunk()
        # threshold 0: checks compiled in but never trigger
        off = self._chunk(island_every=4, island_thresh=0.0)
        np.testing.assert_array_equal(np.asarray(base[0]), np.asarray(off[0]))
        np.testing.assert_array_equal(np.asarray(base[1]), np.asarray(off[1]))
        assert np.asarray(off.partials)[:, 5].max() == 0.0

    def test_forced_trigger_resets_block(self):
        out = self._chunk(island_every=4, island_thresh=2.0)
        w = np.asarray(out.log_weights)
        assert np.isfinite(w).all()
        np.testing.assert_array_equal(np.asarray(out.partials)[:, 5],
                                      [1.0, 1.0])
        # every tile reset after step 4; its weights then share the
        # tile's log-mean (non-zero: the tile's mass is kept)
        base_w = np.asarray(self._chunk().log_weights)
        assert np.ptp(w) < np.ptp(base_w)
        assert w.max() < 0.0


def test_builder_rejects_odd_island_every():
    with pytest.raises(ValueError, match="even"):
        make_fused_discrete_ssm(TRANS5, MEANS5, island_every=3,
                                interpret=True)
