"""Counter-based generator shared by the fused SMC kernel and its XLA
reference: bit-compatibility with jax.random's Threefry, determinism,
stream separation and uniformity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import prng

from cpprob_jax.ops.counter_rng import threefry2x32, uniform_from_bits


@pytest.mark.parametrize("key", [(0, 0), (123, 456789), (0xFFFFFFFF, 7)])
def test_matches_jax_threefry(key):
    k = np.array(key, np.uint32)
    x = np.arange(64, dtype=np.uint32) * np.uint32(2654435761)
    y0, y1 = threefry2x32(jnp.uint32(k[0]), jnp.uint32(k[1]), x[:32], x[32:])
    want = prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x))
    np.testing.assert_array_equal(np.concatenate([y0, y1]), np.asarray(want))


def test_determinism_per_key():
    j = jnp.arange(4096, dtype=jnp.uint32)
    a = threefry2x32(jnp.uint32(1), jnp.uint32(2), jnp.uint32(5), j)
    b = threefry2x32(jnp.uint32(1), jnp.uint32(2), jnp.uint32(5), j)
    c = threefry2x32(jnp.uint32(1), jnp.uint32(3), jnp.uint32(5), j)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert np.mean(np.asarray(a[0]) == np.asarray(c[0])) < 1e-3


def test_distinct_streams_across_tiles_and_steps():
    """Counters (step pair, global particle index) never repeat a word
    across tiles or steps: no collisions among 2^18 draws."""
    j = jnp.arange(1 << 15, dtype=jnp.uint32)       # 32 tiles of 1024
    words = [threefry2x32(jnp.uint32(9), jnp.uint32(4), jnp.uint32(p), j)
             for p in range(4)]
    flat = np.concatenate([np.asarray(w) for pair in words for w in pair])
    # 2^18 uniform 32-bit words collide with probability ~ 2^36 / 2^33 = 8
    # pairs expected at most; far more means correlated streams
    assert len(flat) - len(np.unique(flat)) < 40


def test_island_stream_is_separate():
    """The island uniforms use counter word 0 with the top bit set; step
    pairs use words below 2^31, so the streams cannot share a counter."""
    from cpprob_jax.ops.pallas_ssm import _ISLAND_TAG

    tid = jnp.arange(64, dtype=jnp.uint32)
    isl = threefry2x32(jnp.uint32(9), jnp.uint32(4),
                       jnp.uint32(_ISLAND_TAG | 8), tid)[0]
    step = threefry2x32(jnp.uint32(9), jnp.uint32(4), jnp.uint32(8), tid)[0]
    assert not np.any(np.asarray(isl) == np.asarray(step))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chi_square_uniformity(seed):
    j = jnp.arange(1 << 16, dtype=jnp.uint32)
    b0, b1 = threefry2x32(jnp.uint32(seed), jnp.uint32(77), jnp.uint32(3), j)
    u = np.concatenate([np.asarray(uniform_from_bits(b0)),
                        np.asarray(uniform_from_bits(b1))])
    assert u.min() >= 0.0 and u.max() < 1.0
    bins = 64
    counts = np.bincount((u * bins).astype(int), minlength=bins)
    expected = len(u) / bins
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # chi-square with 63 dof: mean 63, sd ~11.2; 6 sd above the mean
    assert chi2 < 63 + 6 * np.sqrt(2 * 63), chi2


def test_uniform_from_bits_edges():
    bits = jnp.asarray([0, 255, 256, 0xFFFFFFFF], jnp.uint32)
    u = np.asarray(uniform_from_bits(bits))
    np.testing.assert_array_equal(u[:3], [0.0, 0.0, 2.0 ** -24])
    assert u[3] == np.float32(1.0 - 2.0 ** -24)


def test_kernel_tiles_draw_distinct_transitions():
    """In the kernel's reference, two tiles holding the same states at the
    same step take different transitions (their counters differ)."""
    from cpprob_jax.models.hmm import HMM_MEANS, HMM_TRANS
    from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm

    ssm = make_fused_discrete_ssm(HMM_TRANS, HMM_MEANS, reference=True)
    n = 2 * 1024
    s = ssm.fused_chunk_exchange_batch(
        jax.random.key(0), jnp.zeros((n,), jnp.int32), jnp.zeros((n,)),
        jnp.zeros((2,)), jnp.int32(2), jnp.int32(0),
        jnp.zeros((2,), jnp.int32))[0]
    s = np.asarray(s)
    assert np.mean(s[:1024] == s[1024:]) < 0.7
