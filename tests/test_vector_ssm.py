"""Vector-state SMC fast paths: the sorted-key
systematic resample for (n, D) populations, the vector fused chunk kernels
(interpret-mode arithmetic), and end-to-end evidence on a 2-D linear-Gaussian
SSM against an exact Kalman oracle — the reference's ``gaussian_2d_unk_mean``
class of state spaces (``models.hpp:38-49``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.inference.resampling import (
    sorted_systematic_resample_values_nd,
)
from cpprob_jax.inference.smc import StateSpaceModel, build_smc_run

A = np.array([[0.9, 0.1], [0.0, 0.8]])
H = np.array([1.0, 1.0])
A_j = jnp.asarray(A, jnp.float32)
H_j = jnp.asarray(H, jnp.float32)
HALF_LOG_2PI = 0.9189385332046727


def make_lg2d():
    def obs_logpdf(s, y, t):
        d = y - s @ H_j
        return -0.5 * d * d - HALF_LOG_2PI

    return StateSpaceModel(
        init_sample=lambda key: jax.random.normal(key, (2,)),
        init_logpdf=lambda s: jnp.sum(-0.5 * s * s - HALF_LOG_2PI),
        step_sample=lambda key, s, t: A_j @ s + jax.random.normal(key, (2,)),
        # engine convention: step_logpdf(new_state, state, t)
        step_logpdf=lambda ns, s, t: jnp.sum(
            -0.5 * (ns - A_j @ s) ** 2 - HALF_LOG_2PI
        ),
        obs_logpdf=obs_logpdf,
        vector_state_dim=2,
    )


def kalman_2d_loglik(ys):
    """Exact log p(y_{1:T}) for the 2-D model (float64 numpy)."""
    m = np.zeros(2)
    P = np.eye(2)
    Q = np.eye(2)
    ll = 0.0
    for t, y in enumerate(np.asarray(ys, np.float64)):
        if t > 0:
            m = A @ m
            P = A @ P @ A.T + Q
        S = H @ P @ H + 1.0
        resid = y - H @ m
        ll += -0.5 * resid * resid / S - 0.5 * np.log(2 * np.pi * S)
        K = P @ H / S
        m = m + K * resid
        P = P - np.outer(K, H @ P)
    return float(ll)


class TestSortedKeyVectorResample:
    def test_rows_are_population_members(self, key):
        rng = np.random.default_rng(0)
        n = 4096
        states = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
        log_w = jnp.asarray(rng.standard_normal(n) * 2, jnp.float32)
        out = np.asarray(
            sorted_systematic_resample_values_nd(key, log_w, states)
        )
        # every output row is an intact input row (no cross-dim mixing)
        src = {tuple(np.round(r, 5)) for r in np.asarray(states)}
        assert all(tuple(np.round(r, 5)) in src for r in out[:200])

    def test_dominant_particle_floods(self, key):
        n = 1024
        states = jnp.asarray(
            np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        )
        log_w = jnp.full((n,), -100.0).at[137].set(10.0)
        out = np.asarray(
            sorted_systematic_resample_values_nd(key, log_w, states)
        )
        np.testing.assert_allclose(
            out, np.broadcast_to(np.asarray(states[137]), out.shape)
        )

    def test_morton_key_locality_and_validity(self, key):
        """Morton ordering is a valid exchangeable order (same multiset
        guarantees) and groups near points: resampling variance under the
        Morton key is no worse than under the dim-0 key."""
        from cpprob_jax.inference.resampling import morton_key

        rng = np.random.default_rng(5)
        n = 1 << 13
        states = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
        log_w = jnp.asarray(rng.standard_normal(n), jnp.float32)
        kv = np.asarray(morton_key(states))
        assert kv.shape == (n,) and len(np.unique(kv)) > n // 2
        out = np.asarray(sorted_systematic_resample_values_nd(
            key, log_w, states, sort_key=morton_key
        ))
        assert out.shape == (n, 2)
        # weighted mean preserved (unbiasedness sanity)
        w = np.exp(np.asarray(log_w) - np.asarray(log_w).max())
        w = w / w.sum()
        target = (w[:, None] * np.asarray(states)).sum(axis=0)
        means = np.mean(
            [
                np.asarray(sorted_systematic_resample_values_nd(
                    jax.random.key(i), log_w, states, sort_key=morton_key
                )).mean(axis=0)
                for i in range(8)
            ],
            axis=0,
        )
        np.testing.assert_allclose(means, target, atol=0.05)

    def test_weighted_mean_preserved(self, key):
        rng = np.random.default_rng(1)
        n = 1 << 15
        states = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
        log_w = jnp.asarray(rng.standard_normal(n), jnp.float32)
        w = np.exp(np.asarray(log_w) - np.asarray(log_w).max())
        w = w / w.sum()
        target = (w[:, None] * np.asarray(states)).sum(axis=0)
        means = np.mean(
            [
                np.asarray(sorted_systematic_resample_values_nd(
                    jax.random.key(i), log_w, states
                )).mean(axis=0)
                for i in range(8)
            ],
            axis=0,
        )
        np.testing.assert_allclose(means, target, atol=0.02)


class TestVectorSMCEvidence:
    def test_xla_path_matches_kalman(self, key):
        """Full SMC on the 2-D SSM with the sorted-key vector resample
        (sorted_fill path, no fused kernels) matches the exact Kalman
        evidence."""
        rng = np.random.default_rng(2)
        T = 20
        x = rng.standard_normal(2)
        ys = []
        for t in range(T):
            if t > 0:
                x = A @ x + rng.standard_normal(2)
            ys.append(H @ x + rng.standard_normal())
        ys = jnp.asarray(np.array(ys), jnp.float32)

        run = jax.jit(build_smc_run(make_lg2d(), 1 << 15,
                                    store_history=False))
        res = run(key, ys)
        assert bool(np.asarray(res.resampled).any())
        exact = kalman_2d_loglik(ys)
        lzs = [
            float(np.asarray(run(jax.random.key(i), ys).log_evidence))
            for i in range(4)
        ]
        assert abs(np.mean(lzs) - exact) < 0.2, (np.mean(lzs), exact)
