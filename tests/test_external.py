"""External black-box simulator bridge: compile -> infer against an
out-of-process generator (reference premise
``src/models/sherpa.cpp:29-86``, ``README.md:5-13``)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.core import observe, predict, sample
from cpprob_jax.distributions import Uniform, UniformInt, make_abc
from cpprob_jax.external import SubprocessSimulator, observe_external
from cpprob_jax.inference.csis_dynamic import DynamicCSIS

_EXAMPLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "external_simulator.py",
)
GRID, OBS_DIM, N_CHANNELS = 8, 64, 3


@pytest.fixture(scope="module")
def sim():
    s = SubprocessSimulator(
        [sys.executable, _EXAMPLE, "--simulator"], OBS_DIM
    )
    yield s
    s.close()


def _abc_logpdf(simulated):
    def logpdf(observed):
        var = jnp.maximum(simulated, 1.0)
        d = observed - simulated
        return jnp.sum(-0.5 * d * d / var - 0.5 * jnp.log(2 * jnp.pi * var))
    return logpdf


def test_protocol_roundtrip(sim):
    out = sim(np.array([0.0, 30.0]))
    assert out.shape == (OBS_DIM,)
    assert out.sum() > 0
    batch = sim.batch(np.array([[0.0, 30.0], [2.0, 15.0], [1.0, 45.0]]))
    assert batch.shape == (3, OBS_DIM)
    # energy scales total deposit
    assert batch[2].sum() > batch[1].sum()


def test_pure_callback_seam_under_vmap(sim):
    """observe_external inside jit+vmap: the whole particle batch reaches the
    child in one pipelined exchange."""
    def f(p):
        return observe_external(sim, p, OBS_DIM).sum()

    tot = jax.jit(jax.vmap(f))(
        jnp.asarray([[0.0, 20.0], [1.0, 20.0], [2.0, 20.0], [1.0, 40.0]])
    )
    assert tot.shape == (4,)
    assert float(tot[3]) > float(tot[1])


def test_compile_infer_against_external_process(sim):
    """The reference workflow end-to-end: train a proposal from prior traces
    generated through the external process, then guided inference recovers
    the channel of a held-out event and beats the prior proposal's ESS."""

    def model_eager(observed):
        ch = sample(UniformInt(0, N_CHANNELS - 1), addr="Decay Channel")
        energy = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = jnp.asarray(
            sim(np.array([float(ch), float(energy)])), jnp.float32
        )
        observe(make_abc(lambda k: deposits, _abc_logpdf(deposits)),
                observed, addr="calo")
        predict(ch, "Channel")
        predict(energy, "Energy")

    def model_traced(observed):
        ch = sample(UniformInt(0, N_CHANNELS - 1), addr="Decay Channel")
        energy = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = observe_external(
            sim, jnp.stack([ch.astype(jnp.float32), energy]), OBS_DIM
        )
        observe(make_abc(lambda k: deposits, _abc_logpdf(deposits)),
                observed, addr="calo")
        predict(ch, "Channel")

    true_ch = 1
    observed = jnp.asarray(sim(np.array([true_ch, 35.0])), jnp.float32)

    eng = DynamicCSIS(model_eager, (jnp.zeros(OBS_DIM),), probe=8)
    params, stats = eng.compile(jax.random.key(0), n_traces=600)
    assert stats["losses"][-1] < stats["losses"][0]

    n = 128
    res_prior = ct.sis(model_traced, (observed,), n, jax.random.key(1))
    res_guided = eng.infer(params, (observed,), n, jax.random.key(2))

    def channel_post(res):
        w = np.asarray(res.normalized_weights)
        chs = np.asarray(res.predicts["Channel"])
        return np.array([(w * (chs == c)).sum() for c in range(N_CHANNELS)])

    post_p, post_g = channel_post(res_prior), channel_post(res_guided)
    assert post_p.argmax() == true_ch
    assert post_g.argmax() == true_ch
    assert post_g[true_ch] > 0.9
