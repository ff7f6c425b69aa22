"""Fused discrete SMC kernel on the reference 3-state HMM.

The kernel draws its uniforms from a counter-based generator, so the Pallas
interpreter sees the same random bits as the card.  On the CPU the kernel
runs in interpret mode; tests marked ``gpu`` compile it for the card and
skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.inference.smc import build_smc_run
from cpprob_jax.models.hmm import HMM_MEANS, HMM_TRANS, hmm_ssm
from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm

HALF_LOG_2PI = 0.9189385332046727
N = 8 * 1024
N_GPU = 1 << 20


def _hmm(**kw):
    return make_fused_discrete_ssm(HMM_TRANS, HMM_MEANS, **kw)


def _one_step(model, key, s0, y):
    """One valid step from states ``s0`` (the pair's second step masked)."""
    ys = jnp.full((2,), y, jnp.float32)
    return model.fused_chunk_exchange_batch(
        key, s0, jnp.zeros(s0.shape), ys, jnp.int32(1), jnp.int32(0),
        jnp.zeros((2,), jnp.int32),
    )


def _transition_distribution(model, n):
    for s0 in range(3):
        s1 = _one_step(model, jax.random.key(7 + s0),
                       jnp.full((n,), s0, jnp.int32), 0.0)[0]
        frac = np.bincount(np.asarray(s1), minlength=3) / n
        np.testing.assert_allclose(frac, HMM_TRANS[s0], atol=0.02)


def _weight_update_exact(model, n):
    s1, w1 = _one_step(model, jax.random.key(3), jnp.zeros((n,), jnp.int32),
                       0.5)[:2]
    d = 0.5 - HMM_MEANS[np.asarray(s1)]
    np.testing.assert_allclose(np.asarray(w1), -0.5 * d * d - HALF_LOG_2PI,
                               atol=1e-5)


def _seed_determinism(model, n):
    s0 = jnp.zeros((n,), jnp.int32)
    s_a = _one_step(model, jax.random.key(11), s0, 0.0)[0]
    s_b = _one_step(model, jax.random.key(11), s0, 0.0)[0]
    s_c = _one_step(model, jax.random.key(12), s0, 0.0)[0]
    np.testing.assert_array_equal(np.asarray(s_a), np.asarray(s_b))
    assert np.any(np.asarray(s_a) != np.asarray(s_c))


def test_transition_distribution_interpret():
    _transition_distribution(_hmm(interpret=True), N)


def test_weight_update_exact_interpret():
    _weight_update_exact(_hmm(interpret=True), N)


def test_seed_determinism_interpret():
    _seed_determinism(_hmm(interpret=True), N)


@pytest.mark.gpu
def test_transition_distribution():
    _transition_distribution(_hmm(), N_GPU)


@pytest.mark.gpu
def test_weight_update_exact():
    _weight_update_exact(_hmm(), N_GPU)


@pytest.mark.gpu
def test_seed_determinism():
    _seed_determinism(_hmm(), N_GPU)


def test_pallas_available_gating():
    """Off the card the builder refuses the compiled kernel instead of
    switching path; interpret and reference runs are asked for explicitly."""
    if jax.default_backend() != "gpu":
        with pytest.raises(RuntimeError, match="needs a GPU"):
            _hmm()
    with pytest.raises(ValueError):
        _hmm(interpret=True, reference=True)
    with pytest.raises(ValueError, match="multiple of tile"):
        _hmm(interpret=True).fused_init_batch(jax.random.key(0), 1000,
                                              jnp.float32(0.0))


def test_pallas_model_structure():
    m = _hmm(interpret=True)
    assert m.fused_chunk_exchange_batch is not None
    assert m.fused_init_batch is not None
    assert m.init_sample_batch is not None
    assert m.state_categories == 3


def test_exchange_kernel_interpret_weight_and_synthesis():
    """One step with and without the chunk-start exchange resample: weight
    increments, streaming statistics, and the synthesized sorted population
    (seen through the kernel's transitions, which the reference reproduces
    bit for bit)."""
    kern = _hmm(interpret=True)
    logw = jnp.linspace(-1.0, 0.0, N)
    states = jnp.zeros((N,), jnp.int32)
    ys = jnp.asarray([0.7, 0.0], jnp.float32)
    key = jax.random.key(5)

    # flag off: weights carried through, incremented by N(y; mean, 1)
    s1, w1, ess, cat_w, lme = kern.fused_chunk_exchange_batch(
        key, states, logw, ys, jnp.int32(1), jnp.int32(0),
        jnp.zeros((2,), jnp.int32))
    s1 = np.asarray(s1)
    d = 0.7 - HMM_MEANS[s1]
    np.testing.assert_allclose(
        np.asarray(w1), np.asarray(logw) - 0.5 * d * d - HALF_LOG_2PI,
        atol=1e-5)
    w1 = np.asarray(w1, np.float64)
    e = np.exp(w1 - w1.max())
    np.testing.assert_allclose(float(ess), e.sum() ** 2 / (e * e).sum(),
                               rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(cat_w), [e[s1 == k].sum() / e.sum() for k in range(3)],
        atol=1e-5)
    np.testing.assert_allclose(float(lme), np.log(np.mean(np.exp(w1))),
                               rtol=1e-5)

    # flag on: population replaced by the sorted fill, weights reset
    ticks = jnp.asarray([N // 4, N // 2], jnp.int32)
    out_k = kern.fused_chunk_exchange_batch(
        key, states, logw, ys, jnp.int32(1), jnp.int32(1), ticks)
    out_r = _hmm(reference=True).fused_chunk_exchange_batch(
        key, states, logw, ys, jnp.int32(1), jnp.int32(1), ticks)
    s2 = np.asarray(out_k[0])
    np.testing.assert_array_equal(s2, np.asarray(out_r[0]))
    d = 0.7 - HMM_MEANS[s2]
    np.testing.assert_allclose(np.asarray(out_k[1]),
                               -0.5 * d * d - HALF_LOG_2PI, atol=1e-6)
    # the synthesized parents are sorted by state: each block of slots
    # moves per its parent's row of the transition matrix
    for parent, (lo, hi) in enumerate([(0, N // 4), (N // 4, N // 2),
                                       (N // 2, N)]):
        frac = np.bincount(s2[lo:hi], minlength=3) / (hi - lo)
        np.testing.assert_allclose(frac, HMM_TRANS[parent], atol=0.04)


def test_chunk_kernel_interpret_masking_and_synthesis():
    """Multi-step chunk: ragged-tail masking makes steps at or beyond
    n_valid the identity, so a 4-step chunk with n_valid=2 equals a 2-step
    chunk on the same key (same counters)."""
    kern = _hmm(interpret=True)
    logw = jnp.linspace(-1.0, 0.0, N)
    states = jnp.ones((N,), jnp.int32)
    ys = jnp.asarray([0.7, -0.3, 0.1, 0.9], jnp.float32)
    key = jax.random.key(2)
    zeros2 = jnp.zeros((2,), jnp.int32)

    def chunk(ys, n_valid):
        return kern.fused_chunk_exchange_batch(
            key, states, logw, ys, jnp.int32(n_valid), jnp.int32(0), zeros2)

    full, ragged, short = chunk(ys, 4), chunk(ys, 2), chunk(ys[:2], 2)
    for a, b in zip(ragged[:2], short[:2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.any(np.asarray(full[0]) != np.asarray(ragged[0]))
    # weights gain exactly the final step's emission term of each state
    # sequence: the last two steps of the full chunk add at least the
    # worst-case terms and at most the best-case terms
    gain = np.asarray(full[1]) - np.asarray(ragged[1])
    lo = sum(-0.5 * (abs(float(y)) + 1.0) ** 2 - HALF_LOG_2PI
             for y in ys[2:])
    assert np.all(gain >= lo - 1e-4) and np.all(gain <= -2 * HALF_LOG_2PI)


def test_island_interior_resample_interpret():
    """Tile-local island resampling inside a chunk:

    - threshold 0 (never collapse) is bitwise identical to no islands;
    - threshold 2 (always collapse) fires at every interior check
      (after steps 4, 8 and 12 of 16) in every tile, and each reset sets the
      tile's weights to its pre-resample log-mean (mass kept, so not 0)."""
    n = 2 * 1024
    states = jnp.zeros((n,), jnp.int32)
    log_w = jnp.zeros((n,), jnp.float32)
    ys = jnp.asarray(np.linspace(-1, 1, 16), jnp.float32)
    args = (jax.random.key(7), states, log_w, ys, jnp.int32(16),
            jnp.int32(0), jnp.zeros((2,), jnp.int32))
    base = _hmm(interpret=True).fused_chunk_exchange_batch(*args)
    off = _hmm(interpret=True, island_every=4,
               island_thresh=0.0).fused_chunk_exchange_batch(*args)
    np.testing.assert_array_equal(np.asarray(base[0]), np.asarray(off[0]))
    np.testing.assert_array_equal(np.asarray(base[1]), np.asarray(off[1]))

    out = _hmm(interpret=True, island_every=4, island_thresh=2.0
               ).fused_chunk_exchange_batch(*args, partials=True)
    fired = np.asarray(out.partials)[:, 3 + 3]
    np.testing.assert_array_equal(fired, [3.0, 3.0])
    w = np.asarray(out.log_weights)
    assert np.isfinite(w).all() and w.max() < 0.0
    # after the last reset only 4 steps remain, so the weight spread is
    # that of 4 emission terms, below that of 16
    assert np.ptp(w) < np.ptp(np.asarray(base[1]))


@pytest.mark.gpu
def test_exchange_kernel_gpu_matches_xla_exchange_path():
    """Fused sweep vs the plain XLA path of the same model: log-evidence
    agrees within MC error across seeds."""
    T, n = 12, N_GPU
    rng = np.random.RandomState(1)
    obs = jnp.asarray(rng.normal(0.0, 1.2, size=T).astype(np.float32))
    run_f = jax.jit(build_smc_run(_hmm(), n, ess_threshold=0.6))
    run_x = jax.jit(build_smc_run(hmm_ssm, n, ess_threshold=0.6))
    z_f = [float(run_f(jax.random.key(i), obs).log_evidence) for i in range(6)]
    z_x = [float(run_x(jax.random.key(50 + i), obs).log_evidence)
           for i in range(6)]
    assert abs(np.mean(z_f) - np.mean(z_x)) < 4.0 * (
        np.std(z_f) + np.std(z_x) + 1e-3
    ) / np.sqrt(6)


@pytest.mark.gpu
def test_chunked_smc_matches_per_step_path():
    """Chunked fused SMC (blocked adaptive resampling) vs the per-step fused
    path: log-evidence distributions agree within MC error."""
    T, n = 16, N_GPU
    rng = np.random.RandomState(2)
    obs = jnp.asarray(rng.normal(0.0, 1.2, size=T).astype(np.float32))
    model = _hmm()
    run_c = jax.jit(build_smc_run(model, n, ess_threshold=0.5, chunk=5))
    run_s = jax.jit(build_smc_run(model, n, ess_threshold=0.5))
    z_c = [float(run_c(jax.random.key(i), obs).log_evidence) for i in range(6)]
    z_s = [float(run_s(jax.random.key(70 + i), obs).log_evidence)
           for i in range(6)]
    assert abs(np.mean(z_c) - np.mean(z_s)) < 4.0 * (
        np.std(z_c) + np.std(z_s) + 1e-3
    ) / np.sqrt(6)
