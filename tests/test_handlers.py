"""Effect-handler substrate tests: the four reference modes (sis, compile,
csis, dryrun — ``state.hpp:28-33``) as handler compositions, addressing,
rejection-guard keep-last semantics, masking."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.core import handlers
from cpprob_jax.distributions import Normal, UniformInt


def simple_model(y):
    mu = ct.sample(Normal(0.0, 1.0), addr="mu")
    ct.observe(Normal(mu, 1.0), y, addr="y")
    ct.predict(mu, "Mu")
    return mu


def test_seed_determinism(key):
    def run(k):
        with handlers.Seed(k):
            a = ct.sample(Normal(0.0, 1.0), addr="a")
            b = ct.sample(Normal(0.0, 1.0), addr="b")
        return a, b

    a1, b1 = run(key)
    a2, b2 = run(key)
    assert a1 == a2 and b1 == b2 and a1 != b1


def test_auto_addressing(key):
    tr = handlers.TraceHandler()
    with handlers.Seed(key), tr:
        ct.sample(Normal(0.0, 1.0))
        ct.sample(Normal(0.0, 1.0))
        ct.sample(UniformInt(0, 3))
    names = list(tr.trace)
    assert names == [
        "sample/Normal#0",
        "sample/Normal#1",
        "sample/UniformInt#0",
    ]


def test_scope_prefixing(key):
    tr = handlers.TraceHandler()
    with handlers.Seed(key), tr:
        with handlers.Scope("outer"):
            with handlers.Scope("inner"):
                ct.sample(Normal(0.0, 1.0), addr="x")
    assert list(tr.trace) == ["outer/inner/x"]


def test_log_weight_observe(key):
    lw = handlers.LogWeight()
    with handlers.Seed(key), lw:
        ct.observe(Normal(0.0, 1.0), 0.5, addr="y")
    want = float(Normal(0.0, 1.0).log_prob(0.5))
    np.testing.assert_allclose(float(lw.log_weight), want, rtol=1e-6)


def test_log_joint_includes_prior(key):
    lj = handlers.LogJoint()
    with handlers.Substitute({"mu": jnp.asarray(0.3)}), handlers.Seed(key), lj:
        simple_model(1.0)
    want = float(Normal(0.0, 1.0).log_prob(0.3) + Normal(0.3, 1.0).log_prob(1.0))
    np.testing.assert_allclose(float(lj.log_weight), want, rtol=1e-6)


def test_substitute_fixes_value(key):
    with handlers.Substitute({"mu": jnp.asarray(2.5)}), handlers.Seed(key):
        lw = handlers.LogWeight()
        with lw:
            mu = simple_model(1.0)
    assert float(mu) == 2.5


def test_replay(key):
    tr = handlers.TraceHandler()
    with handlers.Seed(key), tr:
        simple_model(1.0)
    with handlers.Replay(tr.trace), handlers.Seed(jax.random.key(99)):
        mu2 = simple_model(1.0)
    assert float(mu2) == float(tr.trace["mu"]["value"])


def test_simulate_observes(key):
    """Compile mode: observe ignores the given value and draws."""
    tr = handlers.TraceHandler()
    with handlers.Seed(key), handlers.SimulateObserves(), tr:
        simple_model(123.456)
    assert float(tr.trace["y"]["value"]) != 123.456


def test_rejection_guard_keeps_last(key):
    lw = handlers.LogWeight()
    with handlers.Seed(key), lw:
        with ct.rejection_sampling():
            # same address sampled twice with different RN increments: only
            # the last contribution must survive (state.cpp:225-238)
            ct.sample(Normal(0.0, 1.0), addr="x", obs=jnp.asarray(0.0))
            ct.sample(Normal(0.0, 1.0), addr="x", obs=jnp.asarray(1.0))
    want = float(Normal(0.0, 1.0).log_prob(1.0))
    np.testing.assert_allclose(float(lw.log_weight), want, rtol=1e-6)


def test_mask_zeroes_contribution(key):
    lw = handlers.LogWeight()
    with handlers.Seed(key), lw:
        with handlers.Mask(jnp.asarray(0.0)):
            ct.observe(Normal(0.0, 1.0), 5.0, addr="y")
    np.testing.assert_allclose(float(lw.log_weight), 0.0)


def test_factor(key):
    lw = handlers.LogWeight()
    with handlers.Seed(key), lw:
        ct.factor(-1.5, addr="penalty")
    np.testing.assert_allclose(float(lw.log_weight), -1.5)


def test_predict_collector_stacks(key):
    pc = handlers.PredictCollector()
    with handlers.Seed(key), pc:
        for t in range(3):
            ct.predict(jnp.asarray(float(t)), "State")
    out = pc.stacked()
    np.testing.assert_allclose(np.asarray(out["State"]), [0.0, 1.0, 2.0])


def test_dryrun_mode(key):
    """Seed alone = dryrun: model runs, no effects accumulated."""
    with handlers.Seed(key):
        mu = simple_model(1.0)
    assert np.isfinite(float(mu))


def test_sample_outside_handlers_raises():
    with pytest.raises(RuntimeError):
        ct.sample(Normal(0.0, 1.0), addr="x")


def test_handled_model_is_jittable(key):
    def weighted(k, y):
        lw = handlers.LogWeight()
        with handlers.Seed(k), lw:
            simple_model(y)
        return lw.log_weight

    j = jax.jit(weighted)
    np.testing.assert_allclose(
        float(j(key, 1.0)), float(weighted(key, 1.0)), rtol=1e-6
    )


def test_handled_model_vmaps(key):
    def weighted(k):
        lw = handlers.LogWeight()
        with handlers.Seed(k), lw:
            simple_model(1.0)
        return lw.log_weight

    out = jax.vmap(weighted)(jax.random.split(key, 32))
    assert out.shape == (32,) and np.all(np.isfinite(out))


def test_replay_repeated_addresses(key):
    """Repeated addresses replay by occurrence order (trace suffixes @i)."""
    def m():
        a = ct.sample(Normal(0.0, 1.0), addr="x")
        b = ct.sample(Normal(0.0, 1.0), addr="x")  # same address again
        return a, b

    tr = handlers.TraceHandler()
    with handlers.Seed(key), tr:
        a1, b1 = m()
    with handlers.Replay(tr.trace), handlers.Seed(jax.random.key(123)):
        a2, b2 = m()
    assert float(a2) == float(a1)
    assert float(b2) == float(b1)
    assert float(a1) != float(b1)
