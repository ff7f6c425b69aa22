"""Particle Gibbs / conditional SMC: statistical correctness against the
exact HMM forward-backward smoother (the thesis validates the same way,
ch. 6.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpprob_jax.inference import csmc_sweep, particle_gibbs
from cpprob_jax.models.hmm import hmm_exact_posterior, hmm_ssm


@pytest.fixture(scope="module")
def hmm_obs():
    return jnp.asarray(
        [0.9, -1.1, 0.2, 1.3, 0.8, -0.4, 1.0, -1.2, 0.1, 0.6], jnp.float32
    )


def test_csmc_sweep_shapes(hmm_obs, key):
    T = hmm_obs.shape[0]
    ref = jnp.zeros((T,), jnp.int32)
    res = csmc_sweep(hmm_ssm, hmm_obs, 16, key, ref)
    assert res.trajectory.shape == (T,)
    assert res.trajectory.dtype == jnp.int32
    assert np.all(np.asarray(res.trajectory) >= 0)
    assert np.all(np.asarray(res.trajectory) <= 2)
    assert np.isfinite(float(res.log_evidence))


def test_csmc_keeps_reference_reachable(hmm_obs, key):
    # With N=1 the only particle is the clamped reference: the sweep must
    # return it unchanged (CSMC degenerates to the identity kernel).
    T = hmm_obs.shape[0]
    ref = jnp.asarray([0, 1, 2, 0, 1, 2, 0, 1, 2, 0], jnp.int32)
    res = csmc_sweep(hmm_ssm, hmm_obs, 1, key, ref, ancestor_sampling=False)
    np.testing.assert_array_equal(np.asarray(res.trajectory), np.asarray(ref))


@pytest.mark.parametrize("ancestor_sampling", [True, False])
def test_particle_gibbs_matches_forward_backward(hmm_obs, key, ancestor_sampling):
    exact = np.asarray(hmm_exact_posterior(hmm_obs))  # (T, 3)
    trajs, _ = particle_gibbs(
        hmm_ssm, hmm_obs, n_particles=32, n_iters=600, key=key,
        ancestor_sampling=ancestor_sampling, burn_in=100,
    )
    trajs = np.asarray(trajs)  # (iters, T)
    emp = np.stack(
        [(trajs == k).mean(axis=0) for k in range(3)], axis=1
    )  # (T, 3)
    # MCMC error at 500 correlated draws: tolerate 0.08 absolute
    np.testing.assert_allclose(emp, exact, atol=0.08)


def test_ancestor_sampling_improves_mixing(hmm_obs, key):
    """Without AS the early-time genealogy collapses to the reference path;
    update rate of z_0 across sweeps must be higher with AS."""
    def rate(as_flag, k):
        trajs, _ = particle_gibbs(
            hmm_ssm, hmm_obs, n_particles=8, n_iters=300, key=k,
            ancestor_sampling=as_flag,
        )
        z0 = np.asarray(trajs)[:, 0]
        return float((z0[1:] != z0[:-1]).mean())

    k1, k2 = jax.random.split(key)
    assert rate(True, k1) >= rate(False, k2)


def test_particle_gibbs_logz_finite(hmm_obs, key):
    _, log_zs = particle_gibbs(hmm_ssm, hmm_obs, 16, 10, key)
    assert np.all(np.isfinite(np.asarray(log_zs)))
