"""Worker process for the multi-process jax.distributed test (not collected
by pytest — launched by ``tests/test_multiprocess.py``).

Each process owns 4 virtual CPU devices; ``jax.distributed`` glues them into
one 8-device global mesh over a Gloo backend, which is the shape of two
hosts with 4 local cards each.  The sharded SIS/SMC code
paths are the production ones — no test doubles.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    from cpprob_jax.parallel import initialize_multihost

    initialize_multihost(f"127.0.0.1:{port}", nproc, pid)
    assert jax.process_count() == nproc
    assert len(jax.local_devices()) == 4
    assert len(jax.devices()) == 4 * nproc

    import jax.numpy as jnp
    import numpy as np

    from cpprob_jax.models import (
        gaussian_posterior_analytic,
        gaussian_unknown_mean,
        kalman_filter_1d,
        linear_gaussian_ssm,
    )
    from cpprob_jax.parallel import particle_mesh, sis_sharded, smc_sharded

    mesh = particle_mesh()  # spans both processes' devices

    # sharded SIS across processes matches the analytic conjugate posterior
    res = sis_sharded(
        gaussian_unknown_mean, (3.0, 4.0), 64_000, jax.random.key(0),
        mesh=mesh,
    )
    m = float(res.mean("Mu"))
    mt, _ = gaussian_posterior_analytic([3.0, 4.0])
    assert abs(m - float(mt)) < 0.05, (m, float(mt))

    # sharded SMC (collective ring-exchange resampling crosses the process
    # boundary) matches the exact Kalman evidence
    obs = jnp.asarray(
        np.random.RandomState(7).normal(0, 1.1, size=12), jnp.float32
    )
    r2 = smc_sharded(
        linear_gaussian_ssm, obs, 16384, jax.random.key(1), mesh=mesh,
        scheme="collective",
    )
    _, _, ll = kalman_filter_1d(obs)
    z = float(r2.log_evidence)
    assert abs(z - float(ll)) < 0.3, (z, float(ll))

    # balanced scheme (exact, O(bound) boundary comm): the boundary ppermute
    # and the scalar all_gather cross the real process boundary, and the
    # result must be BITWISE the ring sweep's
    r3 = smc_sharded(
        linear_gaussian_ssm, obs, 16384, jax.random.key(1), mesh=mesh,
        scheme="balanced", balance_bound=512,
    )
    zb = float(r3.log_evidence)
    assert zb == z, (zb, z)

    print(f"[{pid}] OK sis={m:.5f} smc={z:.4f} balanced={zb:.4f}",
          flush=True)


if __name__ == "__main__":
    main()
