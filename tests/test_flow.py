"""SplineFlow1D (neural-spline-flow proposal head) tests: distribution-level
correctness (normalization, invertibility, sampling consistency) and the
end-to-end CSIS flow head covering a bimodal posterior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.distributions import Normal, SplineFlow1D
from cpprob_jax.distributions.flow import _rqs, _spline_params
from cpprob_jax.inference.csis import CSIS

K = 8


def _rand_flow(seed=0, loc=0.7, scale=1.3):
    return SplineFlow1D(
        w_logits=jax.random.normal(jax.random.key(seed), (K,)),
        h_logits=jax.random.normal(jax.random.key(seed + 1), (K,)),
        d_raw=0.5 * jax.random.normal(jax.random.key(seed + 2), (K - 1,)),
        loc=jnp.float32(loc),
        scale=jnp.float32(scale),
    )


def test_log_prob_normalized():
    d = _rand_flow()
    xs = jnp.linspace(-14, 14, 20001)
    integral = float(jnp.trapezoid(jnp.exp(d.log_prob(xs)), xs))
    assert abs(integral - 1.0) < 1e-3


def test_sample_matches_density():
    d = _rand_flow(seed=5)
    s = d.sample(jax.random.key(9), (200_000,))
    xs = jnp.linspace(-14, 14, 20001)
    p = jnp.exp(d.log_prob(xs))
    m_int = float(jnp.trapezoid(p * xs, xs))
    v_int = float(jnp.trapezoid(p * xs * xs, xs)) - m_int**2
    assert abs(float(s.mean()) - m_int) < 0.02
    assert abs(float(s.var()) - v_int) < 0.05 * max(v_int, 0.1)


def test_spline_invertible():
    d = _rand_flow(seed=11)
    xs_, ys_, ds_ = _spline_params(d.w_logits, d.h_logits, d.d_raw, d.bound)
    z = jnp.linspace(-6.0, 6.0, 201)  # covers tails + interior
    x, ld_f = _rqs(z, xs_, ys_, ds_, inverse=False)
    z2, ld_i = _rqs(x, xs_, ys_, ds_, inverse=True)
    np.testing.assert_allclose(np.asarray(z2), np.asarray(z), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(ld_f + ld_i), 0.0, atol=1e-4
    )
    # monotone
    assert bool(jnp.all(jnp.diff(x) > 0))


def test_batched_params():
    db = SplineFlow1D(
        w_logits=jax.random.normal(jax.random.key(4), (32, K)),
        h_logits=jax.random.normal(jax.random.key(5), (32, K)),
        d_raw=jnp.zeros((32, K - 1)),
        loc=jnp.zeros((32,)),
        scale=jnp.ones((32,)),
    )
    assert db.sample(jax.random.key(6)).shape == (32,)
    assert db.log_prob(jnp.zeros(32)).shape == (32,)
    assert bool(jnp.all(jnp.isfinite(db.log_prob(jnp.linspace(-9, 9, 32)))))


def test_flow_head_covers_bimodal_posterior(key):
    """Same benchmark as the MDN head: y = x^2 + noise, bimodal posterior at
    +/-2 for y=4 — one spline head must keep both modes."""

    def m(y):
        x = ct.sample(Normal(0.0, 2.0), addr="x")
        ct.observe(Normal(x * x, 0.5), y, addr="y")
        ct.predict(x, "X")

    eng = CSIS(m, (0.0,), flow_bins=8)
    assert eng.structure.sites[0].kind == "nsf"
    assert eng.structure.sites[0].n_out == 3 * 8 + 1
    params, losses = eng.compile(jax.random.key(0), steps=400, batch_size=256)
    assert float(losses[-1]) < float(losses[0])
    res = eng.infer(params, (4.0,), 20_000, key)
    xs = np.asarray(res.predicts["X"])
    w = np.asarray(res.normalized_weights)
    frac_pos = float(np.sum(w * (xs > 0)))
    assert 0.15 < frac_pos < 0.85, f"mode collapse: frac_pos={frac_pos}"
    mean_abs = float(np.sum(w * np.abs(xs)))
    assert abs(mean_abs - 2.0) < 0.15
    res_p = ct.sis(m, (4.0,), 20_000, key)
    assert float(res.ess) > 2.0 * float(res_p.ess)


def test_flow_and_mdn_mutually_exclusive():
    def m(y):
        x = ct.sample(Normal(0.0, 1.0), addr="x")
        ct.observe(Normal(x, 1.0), y, addr="y")

    with pytest.raises(ValueError):
        CSIS(m, (0.0,), mdn_components=3, flow_bins=4)
