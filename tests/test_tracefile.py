"""Offline trace shards + native loader tests: format roundtrip, native/python
loader parity, offline CSIS training, native posterior parser."""

import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.inference.csis import CSIS
from cpprob_jax.io.tracefile import (
    TraceLoader,
    dump_traces,
    native_available,
    write_trace_shard,
)
from cpprob_jax.models import gaussian_unknown_mean_readme


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(0)
    for s in range(3):
        values = {
            "mu": rng.normal(size=64).astype(np.float32),
            "vec": rng.normal(size=(64, 2)).astype(np.float32),
        }
        obs = rng.normal(size=(64, 5)).astype(np.float32)
        write_trace_shard(str(d), values, obs, name=f"shard{s}")
    return str(d)


def _paths(d):
    return sorted(
        os.path.join(d, f) for f in os.listdir(d) if f.endswith(".cptt")
    )


def test_native_builds():
    assert native_available(), "native loader failed to build"


def test_python_loader_roundtrip(shard_dir):
    loader = TraceLoader(_paths(shard_dir), batch_size=16, force_python=True)
    assert loader.obs_dim == 5
    assert loader.site_names == ["mu", "vec"]
    assert loader.site_sizes == [1, 2]
    assert loader.total_traces == 192
    values, obs = loader.next_batch()
    assert obs.shape == (16, 5)
    assert values["mu"].shape == (16,)
    assert values["vec"].shape == (16, 2)


@pytest.mark.skipif(not native_available(), reason="no native lib")
def test_native_loader_matches_metadata(shard_dir):
    loader = TraceLoader(_paths(shard_dir), batch_size=16, n_threads=2)
    assert loader.native
    assert loader.obs_dim == 5
    assert loader.site_names == ["mu", "vec"]
    assert loader.total_traces == 192
    for _ in range(5):
        values, obs = loader.next_batch()
        assert obs.shape == (16, 5)
        assert np.all(np.isfinite(obs))
    loader.close()


@pytest.mark.skipif(not native_available(), reason="no native lib")
def test_native_rows_come_from_shards(shard_dir):
    """Every returned row must be an actual row of some shard."""
    loader_py = TraceLoader(_paths(shard_dir), batch_size=4, force_python=True)
    all_rows = np.concatenate(loader_py._py_shards, axis=0)
    loader = TraceLoader(_paths(shard_dir), batch_size=64, n_threads=1, seed=3)
    batch = loader.next_batch_raw()
    for row in batch:
        dists = np.abs(all_rows - row).sum(axis=1)
        assert dists.min() < 1e-6
    loader.close()


def test_offline_csis_training(tmp_path, key):
    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
    paths = eng.dump_traces(str(tmp_path), jax.random.key(0), 2048, 1024)
    assert len(paths) == 2
    loader = TraceLoader(paths, batch_size=128, seed=1)
    params, losses = eng.compile_offline(loader, jax.random.key(1), steps=150)
    assert float(losses[-10:].mean()) < float(losses[0])
    res = eng.infer(params, (3.0, 4.0), 10_000, key)
    assert abs(float(res.mean("Mean")) - 2.32353) < 0.1
    loader.close()


@pytest.mark.skipif(not native_available(), reason="no native lib")
def test_native_posterior_parser(tmp_path, key):
    import ctypes

    from cpprob_jax.io import dump_posterior
    from cpprob_jax.io.tracefile import _load_native

    res = ct.sis(gaussian_unknown_mean_readme, (3.0, 4.0), 300, key)
    path = str(tmp_path / "post")
    dump_posterior(path, res)

    lib = _load_native()
    lib.cpprob_posterior_n_particles.restype = ctypes.c_int64
    lib.cpprob_posterior_n_particles.argtypes = [ctypes.c_void_p]
    lib.cpprob_posterior_log_weights.restype = ctypes.POINTER(ctypes.c_double)
    lib.cpprob_posterior_log_weights.argtypes = [ctypes.c_void_p]
    lib.cpprob_posterior_values.restype = ctypes.POINTER(ctypes.c_double)
    lib.cpprob_posterior_values.argtypes = [ctypes.c_void_p]
    lib.cpprob_posterior_n_entries.restype = ctypes.c_int64
    lib.cpprob_posterior_n_entries.argtypes = [ctypes.c_void_p]
    lib.cpprob_posterior_free.argtypes = [ctypes.c_void_p]

    h = lib.cpprob_posterior_parse((path + ".real").encode())
    assert h
    n = lib.cpprob_posterior_n_particles(ctypes.c_void_p(h))
    assert n == 300
    lw = np.ctypeslib.as_array(
        lib.cpprob_posterior_log_weights(ctypes.c_void_p(h)), shape=(n,)
    )
    np.testing.assert_allclose(lw, np.asarray(res.log_weights), rtol=1e-6)
    ne = lib.cpprob_posterior_n_entries(ctypes.c_void_p(h))
    vals = np.ctypeslib.as_array(
        lib.cpprob_posterior_values(ctypes.c_void_p(h)), shape=(ne,)
    )
    np.testing.assert_allclose(
        vals, np.asarray(res.predicts["Mean"]), rtol=1e-5
    )
    lib.cpprob_posterior_free(ctypes.c_void_p(h))
