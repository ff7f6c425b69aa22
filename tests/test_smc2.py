"""SMC² tests: parameter recovery + evidence on a linear-Gaussian SSM with an
unknown observation scale (Kalman oracle available per θ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.distributions import LogNormal, Normal
from cpprob_jax.inference.smc2 import ParamSSM, smc2


def _kalman_ll(observations, r):
    """Exact log-evidence of the unit random-walk SSM with obs variance r."""
    m_pred, p_pred, ll = 0.0, 1.0, 0.0
    for y in np.asarray(observations):
        s = p_pred + r
        ll += float(Normal(m_pred, np.sqrt(s)).log_prob(y))
        k = p_pred / s
        m_pred = m_pred + k * (y - m_pred)
        p_pred = (1.0 - k) * p_pred + 1.0
    return ll


def _make_model():
    """x_t ~ N(x_{t-1}, 1); y_t ~ N(x_t, sigma) with unknown sigma ~ LogNormal(0, 0.5)."""

    return ParamSSM(
        prior_sample=lambda key: {"log_sigma": 0.5 * jax.random.normal(key, ())},
        prior_logpdf=lambda th: Normal(0.0, 0.5).log_prob(th["log_sigma"]),
        init_sample=lambda key, th: jax.random.normal(key, ()),
        step_sample=lambda key, x, t, th: x + jax.random.normal(key, ()),
        obs_logpdf=lambda x, y, t, th: Normal(x, jnp.exp(th["log_sigma"])).log_prob(y),
    )


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    true_sigma = 1.5
    x = 0.0
    ys = []
    for _ in range(25):
        x = rng.normal(x, 1.0)
        ys.append(rng.normal(x, true_sigma))
    return jnp.asarray(np.asarray(ys, np.float32)), true_sigma


def test_parameter_recovery(data, key):
    obs, true_sigma = data
    model = _make_model()
    res = smc2(model, obs, n_theta=256, n_x=256, key=key)
    sig = float(res.mean(lambda th: jnp.exp(th["log_sigma"])))
    assert abs(sig - true_sigma) < 0.45
    assert bool(np.asarray(res.rejuvenations).any())
    assert float(res.accept_rate) > 0.05


def test_evidence_close_to_marginalized(data, key):
    """SMC² log-evidence ~ log ∫ p(y|σ) p(σ) dσ (quadrature oracle)."""
    obs, _ = data
    model = _make_model()
    res = smc2(model, obs, n_theta=256, n_x=512, key=key)

    # quadrature over log_sigma prior
    from scipy.stats import norm as spnorm

    grid = np.linspace(-1.6, 1.6, 81)
    lp = np.array([
        _kalman_ll(obs, float(np.exp(g)) ** 2) + spnorm.logpdf(g, 0, 0.5)
        for g in grid
    ])
    step = grid[1] - grid[0]
    want = np.log(np.trapezoid(np.exp(lp - lp.max()), dx=step)) + lp.max()
    assert abs(float(res.log_evidence) - want) < 0.8


def test_outer_weights_finite(data, key):
    obs, _ = data
    res = smc2(_make_model(), obs, n_theta=128, n_x=128, key=key)
    assert np.all(np.isfinite(np.asarray(res.log_weights)))
