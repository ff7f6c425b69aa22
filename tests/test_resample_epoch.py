"""The continuous resample epoch (sorted-fill systematic resampling, XLA
sort + monotone scatter + cummax): property cases at several sizes, and the
exact systematic slot arithmetic every systematic resampler shares."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.inference.resampling import (
    continuous_resample_values,
    continuous_resample_values_lme,
    sorted_systematic_resample_values,
    systematic_resample,
    systematic_starts,
    systematic_ticks,
)

SIZES = [1000, 16384, 40000]


def _values_only(key, log_w, vals):
    return continuous_resample_values(key, log_w, vals)


def _values_of_lme(key, log_w, vals):
    return continuous_resample_values_lme(key, log_w, vals)[0]


ENTRIES = {"values": _values_only, "values_lme": _values_of_lme}


def _population(seed, n, scale=2.0):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.normal(0, scale, n).astype(np.float32)),
            jnp.asarray(rng.normal(0, 1, n).astype(np.float32)))


@pytest.mark.parametrize("n", SIZES)
def test_exact_vs_own_starts(n):
    """The scatter + cummax fill must expand the epoch's own start slots
    exactly: slot range [start_i, start_{i+1}) holds sorted value i."""
    log_w, vals = _population(42, n)
    key = jax.random.key(n)
    out = np.asarray(sorted_systematic_resample_values(key, log_w, vals))
    sorted_v, sorted_lw = jax.lax.sort((vals, log_w), num_keys=1)
    u0 = float(jax.random.uniform(key, ()))
    starts = _exact_starts(jnp.exp(sorted_lw - jnp.max(sorted_lw)), u0, n)
    ends = np.concatenate([starts[1:], [n]])
    want = np.zeros(n, np.float32)
    sv = np.asarray(sorted_v)
    for i in np.nonzero(ends > starts)[0]:
        want[starts[i]:ends[i]] = sv[i]
    np.testing.assert_array_equal(out, want)


def _slots(w, n_out):
    """The float32 slot counts the resamplers split: w * (n_out / sum w)."""
    w = jnp.asarray(w, jnp.float32)
    return np.asarray(w * (jnp.float32(n_out) / jnp.sum(w)))


def _exact_starts(w, u0, n_out):
    """Independent exact reference of the comb starts
    ceil(P * n_out / S - u0), in Python integers, for the float32 slot
    counts in fixed point with 32 fractional bits (P: exclusive prefix, S:
    total)."""
    s = _slots(w, n_out).astype(np.float64)
    whole = np.floor(s)
    fixed = [(int(a) << 32) + int(b) for a, b in
             zip(whole, np.floor((s - whole) * 2.0**32))]
    total = sum(fixed)
    u = int(np.float64(np.float32(u0)) * 2.0**32)
    out, p = [], 0
    for f in fixed:
        num = p * n_out * 2**32 - u * total
        out.append(min(max(-((-num) // (total * 2**32)), 0), n_out))
        p += f
    return np.asarray(out)


def _reference_expand(u0, log_w, vals):
    """Float64 systematic resampling of the sorted population."""
    order = np.argsort(vals, kind="stable")
    lw, v = np.asarray(log_w, np.float64)[order], vals[order]
    n = len(lw)
    w = np.exp(lw - lw.max())
    w /= w.sum()
    prev = np.concatenate([[0.0], np.cumsum(w)[:-1]])
    st = np.clip(np.ceil(n * prev - u0), 0, n).astype(int)
    en = np.concatenate([st[1:], [n]])
    out = np.zeros(n, np.float32)
    for j in range(n):
        out[st[j]:en[j]] = v[j]
    return out


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("n", SIZES)
def test_multiset_and_moments(n, entry):
    log_w, vals = _population(0, n)
    key = jax.random.key(3)
    out = np.asarray(ENTRIES[entry](key, log_w, vals))
    ref = _reference_expand(float(jax.random.uniform(key, ())),
                            np.asarray(log_w), np.asarray(vals))
    # multiset agreement with the float64 reference: the epoch computes
    # slot boundaries in float32, so a few boundary slots shift by one
    edges = np.linspace(ref.min() - 1e-3, ref.max() + 1e-3, 4096)
    h_out, _ = np.histogram(out, edges)
    h_ref, _ = np.histogram(ref, edges)
    assert np.abs(h_out - h_ref).sum() / (2 * n) < 0.02
    w = np.exp(np.asarray(log_w, np.float64) - float(jnp.max(log_w)))
    w /= w.sum()
    v = np.asarray(vals, np.float64)
    wmean = float((w * v).sum())
    se = float(np.sqrt((w * (v - wmean) ** 2).sum() / n)) + 1e-3
    assert abs(out.mean() - wmean) < 6 * se, (out.mean(), wmean, se)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("n", [1000, 16384])
def test_degenerate_one_heavy_particle(n, entry):
    """One particle carries ~all the weight: every slot copies it."""
    log_w = np.full(n, -100.0, np.float32)
    log_w[n // 3] = 0.0
    vals = np.arange(n, dtype=np.float32)
    out = np.asarray(ENTRIES[entry](jax.random.key(1), jnp.asarray(log_w),
                                    jnp.asarray(vals)))
    assert (out == float(n // 3)).mean() > 0.999


@pytest.mark.parametrize("n", SIZES)
def test_uniform_weights_identity_multiset(n):
    """Equal weights: the resampled multiset equals the input multiset."""
    vals = np.random.default_rng(3).normal(0, 1, n).astype(np.float32)
    out = np.asarray(continuous_resample_values(
        jax.random.key(2), jnp.zeros(n, jnp.float32), jnp.asarray(vals)))
    np.testing.assert_array_equal(np.sort(out), np.sort(vals))


@pytest.mark.parametrize("scale", [0.1, 2.0, 30.0])
def test_evidence_increment(scale):
    """The epoch's evidence increment is log-mean-exp of the weights."""
    log_w, vals = _population(5, 16384, scale=scale)
    _, lme = continuous_resample_values_lme(jax.random.key(4), log_w, vals)
    lw = np.asarray(log_w, np.float64)
    want = lw.max() + np.log(np.mean(np.exp(lw - lw.max())))
    np.testing.assert_allclose(float(lme), want, rtol=1e-5, atol=1e-5)


# slot counts far above float32's 2^24 exact range: the failure mode of a
# float32 comb, which drops u0 and merges neighbouring slots there
BIG = [4096, 1 << 25, (1 << 28) + 12345, 3 << 26]


@pytest.mark.parametrize("n_out", BIG)
@pytest.mark.parametrize("spread", [0.0, 1.0, 4.0])
def test_starts_exact_vs_int64(n_out, spread):
    """Starts from the int32 + uint32 split prefix equal an int64
    fixed-point reference for the same float32 slot counts."""
    rng = np.random.default_rng(int(spread * 10) + n_out % 97)
    w = np.exp(spread * rng.normal(size=4096)).astype(np.float32)
    for u0 in (0.0, 0.3, 0.9999999):
        got = np.asarray(systematic_starts(jnp.asarray(w), u0, n_out))
        np.testing.assert_array_equal(got, _exact_starts(w, u0, n_out))


@pytest.mark.parametrize("n_out", BIG)
def test_offspring_floor_or_ceil_of_expected(n_out):
    """Systematic property at any scale: every particle's offspring count is
    the floor or the ceiling of its expected count n_out * w_i / W, and the
    counts sum to n_out."""
    w = np.exp(2.0 * np.random.default_rng(1).normal(size=2048))
    expected = n_out * w / w.sum()
    for u0 in (0.05, 0.5, 0.95):
        starts = np.asarray(systematic_starts(jnp.asarray(w, jnp.float32),
                                              u0, n_out), np.int64)
        counts = np.diff(np.append(starts, n_out))
        assert counts.sum() == n_out
        assert np.all(np.abs(counts - expected) < 1.0 + 1e-6 * expected)


def test_systematic_resample_above_float32_range():
    """A whole resample into 2^25 slots: offspring counts as above, and the
    comb offset still moves slots (a float32 comb ignores it there)."""
    n_out = 1 << 25
    lw = jnp.asarray(np.random.default_rng(2).normal(size=1024), jnp.float32)
    w = np.exp(np.asarray(lw, np.float64))
    expected = n_out * w / w.sum()
    runs = []
    for seed in range(2):
        anc = systematic_resample(jax.random.key(seed), lw, n_out)
        counts = np.bincount(np.asarray(anc), minlength=1024)
        assert np.all(np.abs(counts - expected) < 1.0 + 1e-6 * expected)
        runs.append(counts)
    assert np.any(runs[0] != runs[1])


def test_category_ticks_exact_at_scale():
    """Exchange-resampler ticks at 3 * 2^26 slots: each category's count is
    the floor or ceiling of its share and moves with u0."""
    n_out = 3 << 26
    cat_w = jnp.asarray([0.2, 0.3000001, 0.4999999], jnp.float32)
    share = n_out * np.asarray(cat_w, np.float64) / float(jnp.sum(cat_w))
    seen = set()
    for u0 in np.linspace(0.0, 0.999, 7):
        ticks = np.asarray(systematic_ticks(u0, cat_w, n_out), np.int64)
        counts = np.diff(np.concatenate([[0], ticks]))
        assert counts.sum() == n_out
        assert np.all(np.abs(counts - share) < 1.0 + 1e-6 * share)
        seen.add(tuple(counts))
    assert len(seen) > 1
