"""Numerics hardening (SURVEY.md §7 "Numerics"):

* compensated f32 streaming log-weight accumulation at >=10^7 particles
  matches f64 ground truth,
* Normal sigma=0 Dirac convention for cdf/icdf,
* degenerate Uniform(low == high) Dirac convention.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cpprob_jax.distributions import Normal, Uniform
from cpprob_jax.inference.sis import (
    _finalize_stats,
    _lift_chunk,
    _merge_stats,
)
from cpprob_jax.util.numerics import (
    CompSum,
    comp_add,
    comp_scale,
    comp_value,
    comp_zero,
)


class TestCompSum:
    def test_two_sum_recovers_lost_bits(self):
        # 1e8 + 1 in f32 loses the 1; the compensation keeps it
        acc = CompSum(jnp.float32(1e8), jnp.float32(0.0))
        acc = comp_add(acc, jnp.float32(1.0))
        # naive: value stays 1e8, comp holds the lost 1.0
        assert float(comp_value(acc)) != float(jnp.float32(1e8) + jnp.float32(1.0)) or float(acc.comp) != 0.0
        assert abs(float(acc.value) + float(acc.comp) - (1e8 + 1.0)) < 1.0

    def test_sequential_sum_matches_f64(self):
        rng = np.random.RandomState(0)
        xs = rng.uniform(0.1, 1.0, size=200_000).astype(np.float32)
        truth = np.sum(xs, dtype=np.float64)

        def body(acc, x):
            return comp_add(acc, x), None

        acc, _ = jax.lax.scan(body, comp_zero(jnp.float32(0)), jnp.asarray(xs))
        comp_err = abs(float(comp_value(acc)) - truth) / truth
        naive = float(jnp.sum(jnp.asarray(xs)))  # pairwise, for scale
        seq_naive = xs.astype(np.float32)
        s = np.float32(0.0)
        for chunk in np.split(seq_naive, 100):
            s = np.float32(s + chunk.sum(dtype=np.float32))
        naive_err = abs(float(s) - truth) / truth
        assert comp_err < 1e-6
        assert comp_err <= naive_err + 1e-7

    def test_scale_keeps_compensation(self):
        acc = CompSum(jnp.float32(1e8), jnp.float32(0.5))
        acc = comp_scale(acc, jnp.float32(0.5))
        assert float(acc.comp) == 0.25


class TestStreamingMergeAt1e7:
    def test_merge_matches_f64_ground_truth(self):
        """10^7 synthetic log-weights accumulated through the streaming
        f32 merge (2441 sequential chunk merges) agree with the f64
        ground-truth logsumexp to f32 resolution."""
        n = 10_000_000
        chunk = 4096
        n_chunks = n // chunk  # 2441 full chunks
        n = n_chunks * chunk
        rng = np.random.RandomState(1)
        # spread over ~20 nats so max-shift matters
        lw64 = rng.normal(-5.0, 4.0, size=n)
        # f64 ground truth
        m = lw64.max()
        s0_t = np.sum(np.exp(lw64 - m))
        log_z_t = m + np.log(s0_t) - np.log(n)
        ess_t = s0_t**2 / np.sum(np.exp(lw64 - m) ** 2)
        val_t = np.sum(np.exp(lw64 - m) * lw64) / s0_t  # weighted mean of lw

        lw32 = jnp.asarray(lw64.reshape(n_chunks, chunk), jnp.float32)

        def chunk_stats(lw):
            mc = jnp.max(lw)
            w = jnp.exp(lw - mc)
            return (
                mc, jnp.sum(w), jnp.sum(w * w),
                {"v": jnp.sum(w * lw)}, {"v": jnp.sum(w * lw * lw)},
            )

        @jax.jit
        def run(lw32):
            carry0 = _lift_chunk(chunk_stats(lw32[0]))

            def body(c, lw):
                return _merge_stats(c, chunk_stats(lw)), None

            carry, _ = jax.lax.scan(body, carry0, lw32[1:])
            return _finalize_stats(carry, n)

        log_z, ess, means, _ = run(lw32)
        assert abs(float(log_z) - log_z_t) < 1e-4, (float(log_z), log_z_t)
        assert abs(float(ess) / ess_t - 1.0) < 1e-3
        assert abs(float(means["v"]) - val_t) < 1e-3 * max(1.0, abs(val_t))


class TestDegenerateDistributions:
    def test_normal_sigma0_cdf_step(self):
        d = Normal(2.0, 0.0)
        assert float(d.cdf(1.9)) == 0.0
        assert float(d.cdf(2.0)) == 1.0
        assert float(d.cdf(2.1)) == 1.0
        assert np.isfinite(float(d.cdf(2.0)))

    def test_normal_sigma0_icdf_collapses(self):
        d = Normal(2.0, 0.0)
        for u in (0.0, 0.25, 0.5, 1.0):
            assert float(d.icdf(u)) == 2.0

    def test_normal_sigma0_batched_mixed(self):
        d = Normal(jnp.array([0.0, 1.0]), jnp.array([1.0, 0.0]))
        c = np.asarray(d.cdf(jnp.array([0.0, 0.5])))
        assert abs(c[0] - 0.5) < 1e-6
        assert c[1] == 0.0
        q = np.asarray(d.icdf(jnp.array([0.25, 0.25])))
        assert np.isfinite(q).all() and q[1] == 1.0

    def test_uniform_degenerate_dirac(self):
        d = Uniform(3.0, 3.0)
        assert float(d.log_prob(3.0)) == 0.0
        assert float(d.log_prob(2.9)) == -np.inf
        assert float(d.cdf(2.9)) == 0.0
        assert float(d.cdf(3.0)) == 1.0
        assert float(d.icdf(0.7)) == 3.0
        assert float(d.sample(jax.random.key(0))) == 3.0

    def test_uniform_nondegenerate_unchanged(self):
        d = Uniform(0.0, 2.0)
        assert abs(float(d.log_prob(1.0)) + np.log(2.0)) < 1e-6
        assert abs(float(d.cdf(0.5)) - 0.25) < 1e-6
