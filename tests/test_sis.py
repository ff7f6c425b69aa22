"""End-to-end SIS golden-posterior tests — the integration tests the reference
lacks (SURVEY.md §4): estimates must match analytic conjugate posteriors
within Monte-Carlo error."""

import jax
import jax.numpy as jnp
import numpy as np

import pytest

import cpprob_jax as ct
from cpprob_jax.models import (
    all_distr,
    gaussian_2d_unknown_mean,
    gaussian_posterior_analytic,
    gaussian_unknown_mean,
    gaussian_unknown_mean_readme,
    hmm,
    hmm_exact_posterior,
    linear_gaussian_1d,
    kalman_filter_1d,
    normal_rejection_sampling,
    linear_regression,
    poly_adjustment,
)


def test_gaussian_readme_constants(key):
    """The reference's headline correctness gate: posterior N(2.32353, 1.05882)
    for observations (3, 4) (README.md:100,118)."""
    res = ct.sis(gaussian_unknown_mean_readme, (3.0, 4.0), 200_000, key)
    assert abs(float(res.mean("Mean")) - 2.32353) < 0.02
    assert abs(float(res.variance("Mean")) - 1.05882) < 0.03


def test_gaussian_models_hpp_variant(key):
    res = ct.sis(gaussian_unknown_mean, (3.0, 4.0), 200_000, key)
    mean, var = gaussian_posterior_analytic([3.0, 4.0])
    assert abs(float(res.mean("Mu")) - float(mean)) < 0.02
    assert abs(float(res.variance("Mu")) - float(var)) < 0.03


def test_gaussian_2d(key):
    res = ct.sis(gaussian_2d_unknown_mean, (jnp.array([3.0, 4.0]),), 200_000, key)
    # per-dim conjugate: prior N(1,5) & N(2,3), lik var 2
    m0 = np.array([1.0, 2.0])
    v0 = np.array([5.0, 3.0])
    v = 1.0 / (1.0 / v0 + 1.0 / 2.0)
    m = v * (m0 / v0 + np.array([3.0, 4.0]) / 2.0)
    got_mean = np.asarray(res.mean("Mu"))
    np.testing.assert_allclose(got_mean, m, atol=0.05)
    np.testing.assert_allclose(np.asarray(res.variance("Mu")), v, atol=0.08)


def test_log_evidence_gaussian(key):
    """SIS log-evidence must match the analytic marginal likelihood."""
    res = ct.sis(gaussian_unknown_mean_readme, (3.0, 4.0), 400_000, key)
    # marginal: y ~ N(mu0, sigma0^2 + sigma^2) jointly correlated; compute
    # directly: p(y1,y2) = ∫ N(mu;1,1.5^2) N(y1;mu,4) N(y2;mu,4) dmu
    import scipy.stats as sps

    s0sq, ssq, mu0 = 1.5**2, 4.0, 1.0
    cov = np.array([[ssq + s0sq, s0sq], [s0sq, ssq + s0sq]])
    want = sps.multivariate_normal.logpdf([3.0, 4.0], [mu0, mu0], cov)
    assert abs(float(res.log_evidence) - want) < 0.01


def test_linear_gaussian_vs_kalman(key):
    obs = np.array([0.5, 1.0, 0.3, -0.2, 0.8], np.float32)
    res = ct.sis(linear_gaussian_1d, (obs,), 400_000, key)
    ms, ps, ll = kalman_filter_1d(obs)
    # smoothed mean of final state == filtered mean at T
    got = np.asarray(res.mean("State"))  # (T,) stacked predicts, weighted = smoothed
    assert abs(got[-1] - float(ms[-1])) < 0.02
    assert abs(float(res.log_evidence) - float(ll)) < 0.02


def test_hmm_posterior_vs_forward_backward(key):
    obs = np.array([0.9, 0.8, 0.7, 0.0, -0.025, -5.0, -2.0, -0.1, 0.0, 0.13],
                   np.float32)
    res = ct.sis(hmm, (obs,), 300_000, key)
    exact = np.asarray(hmm_exact_posterior(obs))  # (T, 3) smoothed marginals
    states = np.asarray(res.predicts["State"])  # (n, T)
    w = np.asarray(res.normalized_weights)
    for t in range(obs.shape[0]):
        for s in range(3):
            est = float(np.sum(w * (states[:, t] == s)))
            assert abs(est - exact[t, s]) < 0.03, (t, s, est, exact[t, s])


def test_rejection_sampling_model(key):
    res = ct.sis(normal_rejection_sampling, (3.0, 4.0), 100_000, key)
    mean, var = gaussian_posterior_analytic([3.0, 4.0])
    assert abs(float(res.mean("Mu")) - float(mean)) < 0.05
    assert abs(float(res.variance("Mu")) - float(var)) < 0.08


def test_linear_regression(key):
    pts = np.array(
        [[1, 2.1], [2, 3.9], [3, 5.3], [4, 7.7], [5, 10.2], [6, 12.9]],
        np.float32,
    )
    res = ct.sis(linear_regression, (pts,), 400_000, key)
    a = float(res.mean("a"))
    b = float(res.mean("b"))
    # posterior concentrates near the OLS fit (slope ~2.16, intercept ~-0.52)
    assert abs(a - 2.16) < 0.5
    assert abs(b + 0.52) < 1.2


def test_poly_adjustment_runs(key):
    pts = np.array([[1, 2.1], [2, 3.9], [3, 5.3]], np.float32)
    res = ct.sis(poly_adjustment, (pts,), 10_000, key)
    assert res.predicts["Coefficient"].shape == (10_000, 2)


def test_all_distr_smoke(key):
    res = ct.sis(all_distr, (0, 0), 4_000, key)
    assert np.all(np.isfinite(np.asarray(res.log_weights)))


def test_batched_sis_matches_unbatched(key):
    res1 = ct.sis(gaussian_unknown_mean, (3.0, 4.0), 4096, key)
    res2 = ct.sis(gaussian_unknown_mean, (3.0, 4.0), 4096, key, batch_size=512)
    np.testing.assert_allclose(
        np.sort(np.asarray(res1.log_weights)),
        np.sort(np.asarray(res2.log_weights)),
        rtol=1e-5,
    )


def test_ess_and_stats_printer(key):
    res = ct.sis(gaussian_unknown_mean_readme, (3.0, 4.0), 10_000, key)
    assert 0 < float(res.ess) <= 10_000
    text = ct.StatsPrinter(res).print()
    assert "Mean" in text


def test_streaming_matches_batch(key):
    from cpprob_jax.inference.sis import sis_streaming

    res = ct.sis(gaussian_unknown_mean_readme, (3.0, 4.0), 65536, key)
    stream = sis_streaming(
        gaussian_unknown_mean_readme, (3.0, 4.0), 65536, key, batch_size=4096
    )
    np.testing.assert_allclose(
        float(stream.mean("Mean")), float(res.mean("Mean")), rtol=1e-4
    )
    np.testing.assert_allclose(
        float(stream.variance("Mean")), float(res.variance("Mean")), rtol=1e-3
    )
    np.testing.assert_allclose(
        float(stream.log_evidence), float(res.log_evidence), rtol=1e-4
    )
    np.testing.assert_allclose(
        float(stream.ess), float(res.ess), rtol=1e-3
    )


def test_streaming_hmm_vector_predicts(key):
    from cpprob_jax.inference.sis import sis_streaming

    obs = np.array([0.9, 0.8, -1.0], np.float32)
    res = ct.sis(hmm, (obs,), 16384, key)
    stream = sis_streaming(hmm, (obs,), 16384, key, batch_size=2048)
    got = np.asarray(stream.mean("State"))
    want = np.asarray(res.mean("State"))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_streaming_checkpointed_matches_and_resumes(key, tmp_path):
    from cpprob_jax.inference.sis import (
        sis_streaming,
        sis_streaming_checkpointed,
    )

    dump = str(tmp_path / "partial.npz")
    stream = sis_streaming(
        gaussian_unknown_mean_readme, (3.0, 4.0), 32768, key, batch_size=2048
    )
    ck = sis_streaming_checkpointed(
        gaussian_unknown_mean_readme, (3.0, 4.0), 32768, key, 2048, dump,
        dump_every=4,
    )
    np.testing.assert_allclose(
        float(ck.log_evidence), float(stream.log_evidence), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(ck.mean("Mean")), float(stream.mean("Mean")), rtol=1e-5
    )

    # genuine interruption: kill the run right after its second dump, then
    # resume from the mid-run checkpoint and demand a bit-identical result
    import os as _os

    import numpy as onp

    full_lz = float(ck.log_evidence)
    with onp.load(dump) as full:
        assert int(full["chunks_done"]) == 16

    dump2 = str(tmp_path / "interrupted.npz")
    real_replace = _os.replace
    calls = {"n": 0}

    def dying_replace(src, dst):
        real_replace(src, dst)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt

    _os.replace = dying_replace
    try:
        with pytest.raises(KeyboardInterrupt):
            sis_streaming_checkpointed(
                gaussian_unknown_mean_readme, (3.0, 4.0), 32768, key, 2048,
                dump2, dump_every=4,
            )
    finally:
        _os.replace = real_replace
    with onp.load(dump2) as mid:
        assert int(mid["chunks_done"]) == 8  # partial results survived
    resumed = sis_streaming_checkpointed(
        gaussian_unknown_mean_readme, (3.0, 4.0), 32768, key, 2048, dump2,
        dump_every=4, resume=True,
    )
    assert float(resumed.log_evidence) == full_lz


def test_streaming_checkpointed_rejects_mismatched_shape(key, tmp_path):
    import pytest as _pytest

    from cpprob_jax.inference.sis import sis_streaming_checkpointed

    dump = str(tmp_path / "p.npz")
    sis_streaming_checkpointed(
        gaussian_unknown_mean_readme, (3.0, 4.0), 8192, key, 2048, dump
    )
    with _pytest.raises(ValueError):
        sis_streaming_checkpointed(
            gaussian_unknown_mean_readme, (3.0, 4.0), 16384, key, 2048, dump
        )
