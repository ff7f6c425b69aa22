"""Tied-address (scan-based) CSIS for long traces.

The reference's per-address module zoo (``infcomp/nn/nn.py:209-234``) grows
linearly with trace length; tying loop-indexed sites keeps parameters and
compile time O(#site groups) while the LSTM state carries per-step identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.inference.csis import (
    CSIS,
    discover_structure,
    init_csis_params,
    tie_structure,
)
from cpprob_jax.inference.sis import sis
from cpprob_jax.models import hmm, hmm_exact_posterior


def test_tie_structure_hmm():
    s = tie_structure(discover_structure(hmm, (jnp.zeros(8),)))
    # z[0] is UniformInt (own family), z[1..7] tie to one categorical group
    assert s.segments == ((0, 1), (1, 7))
    assert s.sites[0].pkey == "z[0]"
    assert all(x.pkey == "z[*]" for x in s.sites[1:])
    # addresses stay distinct
    assert [x.addr for x in s.sites] == [f"z[{t}]" for t in range(8)]


def test_tied_params_constant_in_trace_length():
    key = jax.random.key(0)
    p8 = init_csis_params(
        key, tie_structure(discover_structure(hmm, (jnp.zeros(8),))),
        embedding_dim=16,
    )
    p64 = init_csis_params(
        key, tie_structure(discover_structure(hmm, (jnp.zeros(64),))),
        embedding_dim=16,
    )
    assert set(p8["heads"]) == set(p64["heads"]) == {"z[0]", "z[*]"}
    # site-table params (heads + value embeddings + LSTM) are constant in T;
    # only the fc observation embedding scales with obs_dim
    for k in ("heads", "value_emb", "lstm"):
        n8 = sum(x.size for x in jax.tree_util.tree_leaves(p8[k]))
        n64 = sum(x.size for x in jax.tree_util.tree_leaves(p64[k]))
        assert n8 == n64, k


def test_tie_structure_non_contiguous_and_mixed():
    import cpprob_jax as ct
    from cpprob_jax.distributions import Normal

    def m(y):
        a = ct.sample(Normal(0.0, 1.0), addr="a")
        tot = a
        for t in range(3):
            tot = tot + ct.sample(Normal(0.0, 1.0), addr=f"w[{t}]")
        b = ct.sample(Normal(tot, 1.0), addr="b")
        for t in range(2):
            tot = tot + ct.sample(Normal(0.0, 1.0), addr=f"w[{t + 3}]")
        ct.observe(Normal(tot, 1.0), y, addr="y")

    s = tie_structure(discover_structure(m, (0.0,)))
    # two separate runs of w[...] (split by b), each tied to the same pkey
    assert s.segments == ((0, 1), (1, 3), (4, 1), (5, 2))
    assert s.sites[1].pkey == "w[*]" and s.sites[5].pkey == "w[*]"


def test_tied_csis_trains_and_guides_hmm():
    """End-to-end on the thesis-length (T=16) HMM: tied training converges
    and guided SIS beats prior SIS ESS and matches the exact smoothed
    posterior at the final step.  (Guided *SIS* weight variance still grows
    with T — long-horizon inference is guided SMC's job; tying makes the
    training/parameters O(1) in T.)"""
    T = 16
    engine = CSIS(hmm, (jnp.zeros(T),), embedding_dim=64, tie_addresses=True)
    params, losses = engine.compile(jax.random.key(3), steps=300,
                                    batch_size=256, unroll=25)
    assert float(jnp.mean(losses[-10:])) < float(jnp.mean(losses[:10]))

    # observations from a known state path
    rng = np.random.RandomState(2)
    from cpprob_jax.models.hmm import HMM_MEANS, HMM_TRANS

    z = 1
    obs = []
    for t in range(T):
        if t > 0:
            z = rng.choice(3, p=HMM_TRANS[z])
        obs.append(rng.normal(HMM_MEANS[z], 1.0))
    obs = jnp.asarray(np.asarray(obs, np.float32))

    n = 4096
    guided = engine.infer(params, (obs,), n, jax.random.key(4))
    prior = sis(hmm, (obs,), n, jax.random.key(103))
    assert float(guided.ess) > 1.5 * float(prior.ess)

    # posterior marginal at the final step vs exact forward-backward
    post = np.asarray(hmm_exact_posterior(obs))
    w = np.asarray(guided.normalized_weights)
    z_last = np.asarray(guided.predicts["State"])[:, -1]
    est = np.array([(w * (z_last == k)).sum() for k in range(3)])
    np.testing.assert_allclose(est, post[-1], atol=0.12)


def test_tied_and_untied_agree_statistically():
    """Same model/posterior through tied vs untied heads — both are valid
    amortized proposals; their guided estimates agree on the evidence."""
    T = 6
    obs = jnp.asarray([0.5, -0.5, 1.0, 0.0, -1.0, 0.8])
    z = []
    for tie in (False, True):
        engine = CSIS(hmm, (jnp.zeros(T),), embedding_dim=16,
                      tie_addresses=tie)
        params, _ = engine.compile(jax.random.key(1), steps=60,
                                   batch_size=64, unroll=10)
        res = engine.infer(params, (obs,), 4096, jax.random.key(2))
        z.append(float(res.log_evidence))
    assert abs(z[0] - z[1]) < 0.5
