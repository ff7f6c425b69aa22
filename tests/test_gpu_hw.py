"""Statistical tests of the compiled kernel on the card.

Marked ``gpu``: they skip off the card, and ``chip_smoke.py`` runs them on
it (``pytest -m gpu`` in its own process).  The same arithmetic is covered
on the CPU in interpret mode by ``test_pallas.py`` and ``test_pallas_ssm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.inference.smc import build_smc_run
from cpprob_jax.models.hmm import (
    HMM_MEANS,
    HMM_TRANS,
    discrete_hmm_log_evidence,
)
from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm

pytestmark = pytest.mark.gpu

TRANS5 = np.array(
    [
        [0.50, 0.20, 0.10, 0.10, 0.10],
        [0.05, 0.60, 0.20, 0.10, 0.05],
        [0.10, 0.10, 0.40, 0.30, 0.10],
        [0.20, 0.05, 0.05, 0.50, 0.20],
        [0.10, 0.10, 0.10, 0.10, 0.60],
    ]
)
MEANS5 = np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
STDS5 = np.array([0.5, 1.0, 0.7, 1.2, 0.9])
INIT5 = np.array([0.3, 0.1, 0.2, 0.2, 0.2])


def _simulate(trans, means, stds, init, T, seed=0):
    rng = np.random.default_rng(seed)
    K = trans.shape[0]
    z = rng.choice(K, p=init)
    ys = []
    for _ in range(T):
        ys.append(means[z] + stds[z] * rng.standard_normal())
        z = rng.choice(K, p=trans[z])
    return jnp.asarray(np.array(ys), jnp.float32)


@pytest.mark.parametrize("k", [5, 12])
def test_fused_spec_kernel_evidence(k):
    """The kernel built from a user spec reproduces the exact
    forward-recursion evidence on the card."""
    if k == 5:
        trans, means, stds, init = TRANS5, MEANS5, STDS5, INIT5
    else:
        rng = np.random.default_rng(12)
        trans = rng.dirichlet(np.ones(k), size=k)
        means = np.linspace(-3.0, 3.0, k)
        stds = np.linspace(0.5, 1.6, k)
        init = np.full(k, 1.0 / k)
    ys = _simulate(trans, means, stds, init, T=12, seed=k)
    ssm = make_fused_discrete_ssm(trans, means, stds, init)
    run = jax.jit(build_smc_run(ssm, 1 << 20, chunk=4, store_history=False))
    lz = float(np.asarray(run(jax.random.key(0), ys).log_evidence))
    exact = discrete_hmm_log_evidence(trans, means, stds, init, np.asarray(ys))
    assert abs(lz - exact) < 0.05, (lz, exact)


def test_guided_csis_serving_on_chip():
    """Compile a proposal on the card and serve guided inference through
    the cached jitted path: ESS beats prior-proposal SIS and the posterior
    mean matches the analytic conjugate value (README.md)."""
    import cpprob_jax as ct
    from cpprob_jax.inference.csis import CSIS
    from cpprob_jax.models import gaussian_unknown_mean_readme

    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
    params, losses = eng.compile(
        jax.random.key(0), steps=150, batch_size=64, unroll=10
    )
    assert float(losses[-10:].mean()) < float(losses[:10].mean())
    n = 4096
    res_g = eng.infer(params, (3.0, 4.0), n, jax.random.key(1))
    res_p = ct.sis(
        gaussian_unknown_mean_readme, (3.0, 4.0), n, jax.random.key(2)
    )

    def ess(res):
        w = np.asarray(res.normalized_weights)
        return 1.0 / np.sum(w * w)

    assert ess(res_g) > 1.5 * ess(res_p)
    assert abs(float(res_g.mean("Mean")) - 2.32353) < 0.1


def test_island_interior_resampling_evidence():
    """Whole-sweep fusion with tile-local island ESS resampling: logZ
    matches the exact forward recursion within MC error, the interior
    triggers fire, and the estimate agrees with the boundary-checked
    chunk=8 configuration."""
    T, n = 16, 1 << 20
    ys = _simulate(HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3), T,
                   seed=3)
    exact = discrete_hmm_log_evidence(
        HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3), ys)

    model = make_fused_discrete_ssm(HMM_TRANS, HMM_MEANS, island_every=4)
    run = build_smc_run(model, n, chunk=T, store_history=False)

    @jax.jit
    def multi(key):
        keys = jax.random.split(key, 8)

        def body(_, k):
            return None, run(k, ys).log_evidence
        _, lz = jax.lax.scan(body, None, keys)
        return lz

    lzs = np.asarray(multi(jax.random.key(0)))
    assert abs(lzs.mean() - exact) < 4 * lzs.std(ddof=1) / np.sqrt(8) + 0.02, (
        lzs.mean(), exact)

    run8 = build_smc_run(make_fused_discrete_ssm(HMM_TRANS, HMM_MEANS), n,
                         chunk=8, store_history=False)
    lz8 = np.asarray(jax.jit(
        lambda k: run8(k, ys).log_evidence)(jax.random.key(5)))
    assert abs(lzs.mean() - float(lz8)) < 0.05

    # the interior trigger fires (partials column 3 + K)
    s0, w0, _, cat_w0, _ = model.fused_init_batch(jax.random.key(1), n, ys[0])
    cum = jnp.cumsum(cat_w0)[:2]
    ticks = jnp.clip(jnp.ceil(n * cum - 0.3), 0, n).astype(jnp.int32)
    out = model.fused_chunk_exchange_batch(
        jax.random.key(2), s0, w0, ys[1:], jnp.int32(T - 1), jnp.int32(1),
        ticks, partials=True)
    fires = np.asarray(out.partials)[:, 6]
    assert fires.min() >= 1.0, fires
