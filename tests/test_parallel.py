"""Sharded execution tests on the 8-device virtual CPU mesh: sharded SIS
matches analytic posteriors; sharded SMC (collective scheme) matches the exact
Kalman evidence; distributed systematic resampling matches the single-device
resampler exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from cpprob_jax.inference import resampling as local_resampling
from cpprob_jax.models import (
    gaussian_posterior_analytic,
    gaussian_unknown_mean,
    kalman_filter_1d,
    linear_gaussian_ssm,
    hmm_ssm,
    HMM_MEANS,
)
from cpprob_jax.parallel import (
    PARTICLE_AXIS,
    particle_mesh,
    sharded_systematic_ancestors,
    sis_sharded,
    smc_sharded,
)


@pytest.fixture
def mesh(devices8):
    return particle_mesh(devices=devices8)


def test_sharded_sis_gaussian(mesh, key):
    res = sis_sharded(
        gaussian_unknown_mean, (3.0, 4.0), 160_000, key, mesh=mesh
    )
    mean, var = gaussian_posterior_analytic([3.0, 4.0])
    assert abs(float(res.mean("Mu")) - float(mean)) < 0.03
    assert abs(float(res.variance("Mu")) - float(var)) < 0.04


def test_distributed_systematic_matches_single_device(mesh, key):
    """The sharded prefix-sum resampler must produce exactly the ancestors of
    the reference single-device systematic resampler for the same u0."""
    n = 1024
    lw = jax.random.normal(key, (n,)) * 3.0
    u0 = jnp.float32(0.375)

    def body(lw_local):
        return sharded_systematic_ancestors(u0, lw_local, PARTICLE_AXIS)

    anc_sharded = jax.jit(
        jax.shard_map(
            body, mesh=mesh, in_specs=P(PARTICLE_AXIS),
            out_specs=P(PARTICLE_AXIS), check_vma=False,
        )
    )(lw)

    # single-device reference with identical comb
    cdf_w = jnp.exp(lw - jnp.max(lw))
    cdf = jnp.cumsum(cdf_w)
    cdf = cdf / cdf[-1]
    positions = (u0 + jnp.arange(n, dtype=cdf.dtype)) / n
    anc_ref = jnp.clip(jnp.searchsorted(cdf, positions, side="right"), 0, n - 1)

    np.testing.assert_array_equal(np.asarray(anc_sharded), np.asarray(anc_ref))


def test_collective_8dev_matches_single_device_moments(mesh, devices8, key):
    """Statistical equivalence of the collective (ring-exchange) scheme across
    mesh sizes at moderate N: the SAME inference on an 8-device mesh and on a
    1-device mesh must give log-evidence and filtering means that agree within
    Monte-Carlo error (cross-mesh evidence/moment
    agreement, not just compilation)."""
    obs = jnp.asarray(
        np.random.RandomState(11).normal(0, 1.1, size=20), dtype=jnp.float32
    )
    mesh1 = particle_mesh(devices=devices8[:1])
    n = 32768
    seeds = range(5)

    def run(m, s):
        return smc_sharded(
            linear_gaussian_ssm, obs, n, jax.random.key(100 + s), mesh=m,
            scheme="collective", track_fn=lambda x: x,
        )

    r8 = [run(mesh, s) for s in seeds]
    r1 = [run(mesh1, s) for s in seeds]
    z8 = np.array([float(r.log_evidence) for r in r8])
    z1 = np.array([float(r.log_evidence) for r in r1])
    # both match the exact Kalman evidence
    _, _, ll = kalman_filter_1d(obs)
    assert abs(z8.mean() - float(ll)) < 0.1
    assert abs(z1.mean() - float(ll)) < 0.1
    # and each other, within combined MC error
    se = (z8.std() + z1.std()) / np.sqrt(len(z8)) + 1e-3
    assert abs(z8.mean() - z1.mean()) < 4.0 * se
    # filtering means agree pointwise across mesh sizes
    m8 = np.mean([np.asarray(r.tracked) for r in r8], axis=0)
    m1 = np.mean([np.asarray(r.tracked) for r in r1], axis=0)
    np.testing.assert_allclose(m8, m1, atol=0.08)
    ms, _, _ = kalman_filter_1d(obs)
    np.testing.assert_allclose(m8, np.asarray(ms)[1:], atol=0.1)


def test_sharded_smc_collective_evidence(mesh, key):
    obs = jnp.asarray(
        np.random.RandomState(7).normal(0, 1.2, size=25), dtype=jnp.float32
    )
    res = smc_sharded(
        linear_gaussian_ssm, obs, 16384, key, mesh=mesh, scheme="collective"
    )
    _, _, ll = kalman_filter_1d(obs)
    assert abs(float(res.log_evidence) - float(ll)) < 0.15
    assert bool(np.asarray(res.resampled).any())


def test_sharded_smc_island_evidence(mesh, key):
    obs = jnp.asarray(
        np.random.RandomState(8).normal(0, 1.2, size=25), dtype=jnp.float32
    )
    res = smc_sharded(
        linear_gaussian_ssm, obs, 16384, key, mesh=mesh, scheme="island"
    )
    _, _, ll = kalman_filter_1d(obs)
    # island scheme is approximate; allow a wider budget
    assert abs(float(res.log_evidence) - float(ll)) < 0.5


def test_sharded_smc_tracked_means(mesh, key):
    obs = jnp.asarray(
        np.random.RandomState(9).normal(0, 1.0, size=12), dtype=jnp.float32
    )
    res = smc_sharded(
        linear_gaussian_ssm, obs, 8192, key, mesh=mesh,
        track_fn=lambda s: s,
    )
    ms, _, _ = kalman_filter_1d(obs)
    got = np.asarray(res.tracked)  # (T-1,) means for t=1..T-1
    np.testing.assert_allclose(got, np.asarray(ms)[1:], atol=0.1)


def test_sharded_smc_hmm(mesh, key):
    obs = jnp.array([0.9, -0.8, 0.7, 0.0, 1.1, -1.0, 0.5, 0.2])
    res = smc_sharded(
        hmm_ssm, obs, 8192, key, mesh=mesh,
        track_fn=lambda s: jnp.asarray(HMM_MEANS)[s],
    )
    assert np.isfinite(float(res.log_evidence))
    assert np.all(np.isfinite(np.asarray(res.tracked)))


def test_sharded_smc_exchange_hmm(mesh, key):
    """Exchange scheme (psum of K category weights, shard-local fill) agrees
    with the collective scheme's evidence on the HMM within MC error, and
    resamples at least once."""
    obs = jnp.array([0.9, -0.8, 0.7, 0.0, 1.1, -1.0, 0.5, 0.2, -0.4, 1.3])
    z_ex = [
        float(smc_sharded(hmm_ssm, obs, 8192, jax.random.key(i), mesh=mesh,
                          scheme="exchange", ess_threshold=0.7).log_evidence)
        for i in range(4)
    ]
    z_co = [
        float(smc_sharded(hmm_ssm, obs, 8192, jax.random.key(40 + i),
                          mesh=mesh, scheme="collective",
                          ess_threshold=0.7).log_evidence)
        for i in range(4)
    ]
    assert abs(np.mean(z_ex) - np.mean(z_co)) < 4.0 * (
        np.std(z_ex) + np.std(z_co) + 1e-3
    ) / np.sqrt(4)
    res = smc_sharded(hmm_ssm, obs, 8192, key, mesh=mesh, scheme="exchange",
                      ess_threshold=0.7)
    assert bool(np.asarray(res.resampled).any())
    # population states stay in {0,1,2} after synthesized fills
    states = np.asarray(res.final_states)
    assert states.min() >= 0 and states.max() <= 2


def test_sharded_smc_exchange_requires_categories(mesh, key):
    obs = jnp.array([0.1, 0.2])
    import pytest as _pytest
    with _pytest.raises(ValueError):
        smc_sharded(linear_gaussian_ssm, obs, 1024, key, mesh=mesh,
                    scheme="exchange")


def test_csis_infer_sharded(mesh, key):
    """Guided inference with particles sharded over the mesh: same posterior
    as the single-device path."""
    from cpprob_jax.inference.csis import CSIS
    from cpprob_jax.models import gaussian_unknown_mean_readme

    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
    params, _ = eng.compile(jax.random.key(0), steps=120, batch_size=128)
    res = eng.infer(params, (3.0, 4.0), 32_000, key, mesh=mesh)
    assert abs(float(res.mean("Mean")) - 2.32353) < 0.05
    assert float(res.ess) > 16_000  # guided proposal keeps ESS high


def test_csis_compile_data_parallel(mesh):
    """DP training over the mesh: batch sharded, grads all-reduced by XLA;
    loss trajectory matches the expected convergence."""
    from cpprob_jax.inference.csis import CSIS
    from cpprob_jax.models import gaussian_unknown_mean_readme

    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
    params, losses = eng.compile(
        jax.random.key(0), steps=100, batch_size=256, mesh=mesh, unroll=10
    )
    assert np.all(np.isfinite(np.asarray(losses)))
    assert float(losses[-10:].mean()) < float(losses[0])


class TestRingResample:
    """ring_systematic_resample: exact equivalence with the materializing
    collective resample (O(N/shard) memory, 2^20 x 8)."""

    def test_matches_materializing_path(self, devices8):
        import jax.numpy as jnp
        from jax.sharding import Mesh, PartitionSpec as P
        from cpprob_jax.parallel.resampling import (
            ring_systematic_resample, sharded_systematic_ancestors,
        )

        n = 1 << 20
        k = 8
        mesh = Mesh(devices8, ("particles",))
        rng = np.random.RandomState(0)
        log_w = jnp.asarray(rng.normal(0.0, 2.0, size=n).astype(np.float32))
        states = jnp.asarray(rng.randint(0, 1000, size=n).astype(np.int32))
        u0 = jnp.float32(0.3781)

        def old_body(log_w, states):
            anc = sharded_systematic_ancestors(u0, log_w, "particles")
            all_states = jax.lax.all_gather(states, "particles").reshape(n)
            return all_states[anc]

        def new_body(log_w, states):
            return ring_systematic_resample(u0, log_w, states, "particles")

        old = jax.jit(jax.shard_map(
            old_body, mesh=mesh,
            in_specs=(P("particles"), P("particles")),
            out_specs=P("particles"), check_vma=False,
        ))(log_w, states)
        new = jax.jit(jax.shard_map(
            new_body, mesh=mesh,
            in_specs=(P("particles"), P("particles")),
            out_specs=P("particles"), check_vma=False,
        ))(log_w, states)
        mismatch = int(np.sum(np.asarray(old) != np.asarray(new)))
        assert mismatch == 0, f"{mismatch}/{n} slots differ"

    def test_tree_states_and_weighted_concentration(self, devices8):
        """Pytree states resample correctly; a dominant particle floods the
        whole population across shard boundaries."""
        import jax.numpy as jnp
        from jax.sharding import Mesh, PartitionSpec as P
        from cpprob_jax.parallel.resampling import ring_systematic_resample

        n, k = 1024, 8
        mesh = Mesh(devices8, ("particles",))
        log_w = jnp.full((n,), -100.0).at[137].set(10.0)
        states = {
            "a": jnp.arange(n, dtype=jnp.int32),
            "b": jnp.arange(n, dtype=jnp.float32)[:, None] * jnp.ones((1, 3)),
        }

        def body(log_w, states):
            return ring_systematic_resample(
                jnp.float32(0.5), log_w, states, "particles"
            )

        out = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(P("particles"), P("particles")),
            out_specs=P("particles"), check_vma=False,
        ))(log_w, states)
        assert np.all(np.asarray(out["a"]) == 137)
        np.testing.assert_allclose(np.asarray(out["b"]), 137.0)


class TestBalancedResample:
    """balanced_systematic_resample: the exact scalable
    continuous-state scheme — O(bound) boundary comm, bitwise-equal to the
    exact ring scheme, exact-ring fallback on pathological imbalance."""

    def _run(self, devices8, body, *args):
        from jax.sharding import Mesh, PartitionSpec as P

        mesh = Mesh(devices8, ("particles",))
        n_args = len(args)
        return jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("particles"),) * n_args,
            out_specs=P("particles"), check_vma=False,
        ))(*args)

    @pytest.mark.parametrize("spread", [0.5, 2.0, 4.0])
    def test_bitwise_matches_ring(self, devices8, spread):
        from cpprob_jax.parallel.resampling import (
            balanced_systematic_resample, ring_systematic_resample,
        )

        n = 1 << 14
        rng = np.random.RandomState(int(spread * 10))
        log_w = jnp.asarray(rng.normal(0, spread, size=n).astype(np.float32))
        states = jnp.asarray(rng.normal(size=n).astype(np.float32))
        u0 = jnp.float32(0.137)

        ring = self._run(
            devices8,
            lambda lw, s: ring_systematic_resample(u0, lw, s, "particles"),
            log_w, states,
        )
        bal = self._run(
            devices8,
            lambda lw, s: balanced_systematic_resample(
                u0, lw, s, "particles", bound=256
            ),
            log_w, states,
        )
        assert np.array_equal(np.asarray(ring), np.asarray(bal))

    def test_vector_and_tree_states(self, devices8):
        from cpprob_jax.parallel.resampling import (
            balanced_systematic_resample, ring_systematic_resample,
        )

        n = 4096
        rng = np.random.RandomState(1)
        log_w = jnp.asarray(rng.normal(0, 2.0, size=n).astype(np.float32))
        states = {
            "x": jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)),
            "i": jnp.arange(n, dtype=jnp.int32),
        }
        u0 = jnp.float32(0.42)
        from jax.sharding import Mesh, PartitionSpec as P

        mesh = Mesh(devices8, ("particles",))
        spec = {"x": P("particles"), "i": P("particles")}
        ring = jax.jit(jax.shard_map(
            lambda lw, s: ring_systematic_resample(u0, lw, s, "particles"),
            mesh=mesh, in_specs=(P("particles"), spec), out_specs=spec,
            check_vma=False,
        ))(log_w, states)
        bal = jax.jit(jax.shard_map(
            lambda lw, s: balanced_systematic_resample(
                u0, lw, s, "particles", bound=128
            ),
            mesh=mesh, in_specs=(P("particles"), spec), out_specs=spec,
            check_vma=False,
        ))(log_w, states)
        assert np.array_equal(np.asarray(ring["x"]), np.asarray(bal["x"]))
        assert np.array_equal(np.asarray(ring["i"]), np.asarray(bal["i"]))

    def test_pathological_imbalance_falls_back_exact(self, devices8):
        """All weight on one shard exceeds any small bound; the lax.cond
        fallback must still produce the exact ring population."""
        from cpprob_jax.parallel.resampling import (
            balanced_systematic_resample, ring_systematic_resample,
        )

        n = 2048
        log_w = jnp.where(
            (jnp.arange(n) // (n // 8)) == 5, 0.0, -80.0
        ).astype(jnp.float32)
        states = jnp.arange(n, dtype=jnp.float32)
        u0 = jnp.float32(0.9)
        ring = self._run(
            devices8,
            lambda lw, s: ring_systematic_resample(u0, lw, s, "particles"),
            log_w, states,
        )
        bal = self._run(
            devices8,
            lambda lw, s: balanced_systematic_resample(
                u0, lw, s, "particles", bound=16
            ),
            log_w, states,
        )
        assert np.array_equal(np.asarray(ring), np.asarray(bal))
        # every survivor comes from shard 5's index range
        assert np.all((np.asarray(bal) >= 5 * n // 8)
                      & (np.asarray(bal) < 6 * n // 8))


@pytest.mark.parametrize("impl", ["interpret", "reference"])
def test_sharded_smc_fused_exchange(devices8, key, impl):
    """The fused discrete kernel per shard under ``smc_sharded(chunk=)``:
    the exchange resample forced at every chunk boundary (the last chunk
    ragged), evidence against the exact forward recursion."""
    from cpprob_jax.models import HMM_TRANS, discrete_hmm_log_evidence
    from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm

    mesh4 = particle_mesh(devices=devices8[:4])
    model = make_fused_discrete_ssm(HMM_TRANS, HMM_MEANS,
                                    **{impl: True})
    obs = jnp.asarray(np.linspace(-1.0, 1.0, 8), jnp.float32)
    exact = discrete_hmm_log_evidence(HMM_TRANS, HMM_MEANS, np.ones(3),
                                      np.full(3, 1 / 3), obs)
    zs = []
    for i in range(4):
        res = smc_sharded(model, obs, 4 * 2048, jax.random.fold_in(key, i),
                          mesh=mesh4, scheme="exchange", ess_threshold=1.0,
                          chunk=4)
        assert bool(np.asarray(res.resampled).all())
        assert res.final_states.shape == (4 * 2048,)
        zs.append(float(res.log_evidence))
    se = np.std(zs, ddof=1) / 2.0
    assert abs(np.mean(zs) - exact) < 4 * se + 0.05, (zs, exact)


def test_sharded_smc_fused_needs_exchange_and_hooks(mesh, key):
    from cpprob_jax.models import HMM_TRANS
    from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm

    obs = jnp.zeros((8,), jnp.float32)
    fused = make_fused_discrete_ssm(HMM_TRANS, HMM_MEANS, reference=True)
    with pytest.raises(ValueError, match="exchange"):
        smc_sharded(fused, obs, 8 * 1024, key, mesh=mesh, scheme="balanced",
                    chunk=4)
    with pytest.raises(ValueError, match="fused"):
        smc_sharded(hmm_ssm, obs, 8 * 1024, key, mesh=mesh,
                    scheme="exchange", chunk=4)


def test_sharded_smc_balanced_bitwise_matches_collective(mesh, key):
    """End-to-end: the balanced scheme's SMC sweep reproduces the collective
    (exact-ring) sweep bit-for-bit on a continuous SSM — same evidence, same
    final population — while moving only O(bound) data per epoch."""
    obs = jnp.asarray(
        np.random.RandomState(9).normal(0, 1.2, size=25), dtype=jnp.float32
    )
    res_c = smc_sharded(
        linear_gaussian_ssm, obs, 16384, key, mesh=mesh, scheme="collective"
    )
    res_b = smc_sharded(
        linear_gaussian_ssm, obs, 16384, key, mesh=mesh, scheme="balanced",
        balance_bound=512,
    )
    assert float(res_c.log_evidence) == float(res_b.log_evidence)
    assert np.array_equal(
        np.asarray(res_c.final_states), np.asarray(res_b.final_states)
    )
    assert bool(np.asarray(res_b.resampled).any())
    _, _, ll = kalman_filter_1d(obs)
    assert abs(float(res_b.log_evidence) - float(ll)) < 0.15


@pytest.mark.parametrize("scheme", ["balanced", "materializing"])
def test_sharded_offspring_exact_above_float32_range(devices8, scheme):
    """2^25 particles over 4 shards: every particle's offspring count is the
    floor or ceiling of its expected count, where a float32 comb merges
    neighbouring slots and drops the comb offset."""
    from cpprob_jax.parallel.resampling import balanced_systematic_resample

    n = 1 << 25
    mesh4 = particle_mesh(devices=devices8[:4])
    lw = jax.random.normal(jax.random.key(5), (n,))
    ids = jnp.arange(n, dtype=jnp.int32)

    def body(lw_l, ids_l):
        if scheme == "balanced":
            return balanced_systematic_resample(jnp.float32(0.37), lw_l,
                                                ids_l, PARTICLE_AXIS)
        return sharded_systematic_ancestors(jnp.float32(0.37), lw_l,
                                            PARTICLE_AXIS)

    out = jax.jit(jax.shard_map(
        body, mesh=mesh4, in_specs=(P(PARTICLE_AXIS),) * 2,
        out_specs=P(PARTICLE_AXIS), check_vma=False))(lw, ids)
    counts = np.bincount(np.asarray(out), minlength=n)
    w = np.exp(np.asarray(lw, np.float64))
    expected = n * w / w.sum()
    assert np.all(np.abs(counts - expected) < 1.0 + 1e-5 * expected)
