"""io (serialization, posterior dumps), util (ndarray flatten, checkpoints,
logger) and CLI tests."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.io import (
    dump_posterior,
    dump_posterior_npz,
    format_value,
    load_posterior,
    load_posterior_npz,
    parse_observes,
    parse_value,
)
from cpprob_jax.models import gaussian_unknown_mean_readme
from cpprob_jax.util import (
    TrainLogger,
    flatten_nested,
    latest_checkpoint,
    load_pytree,
    save_pytree,
    to_ndarray,
)


class TestSerialization:
    def test_parse_scalars(self):
        assert parse_value("3") == 3
        assert parse_value("3.5") == 3.5
        assert parse_value("( 1 2.5 )") == (1, 2.5)
        assert parse_value("[ 1 2 3 ]") == [1, 2, 3]

    def test_parse_nested(self):
        v = parse_value("( [ ( 0 1.5 ) ( 1 2 ) ] -3.25 )")
        assert v == ([(0, 1.5), (1, 2)], -3.25)

    def test_parse_observes_reference_syntax(self):
        # the reference CLI syntax: -o [[1 2.1] [2 3.9]]
        obs = parse_observes("[[1 2.1] [2 3.9] [3 5.3]]")
        assert len(obs) == 1
        np.testing.assert_allclose(
            obs[0], [[1, 2.1], [2, 3.9], [3, 5.3]], rtol=1e-6
        )

    def test_parse_observes_scalars(self):
        obs = parse_observes("3.0 4.0")
        assert obs == (3.0, 4.0)

    def test_roundtrip_format(self):
        v = ([1, 2, 3], (4.5, 6))
        assert parse_value(format_value(v)) == ([1, 2, 3], (4.5, 6))

    def test_posterior_dump_roundtrip(self, key, tmp_path):
        res = ct.sis(gaussian_unknown_mean_readme, (3.0, 4.0), 500, key)
        path = str(tmp_path / "posterior")
        dump_posterior(path, res)
        assert os.path.exists(path + ".ids")
        assert os.path.exists(path + ".real")
        predicts, log_w = load_posterior(path)
        np.testing.assert_allclose(
            np.asarray(predicts["Mean"], np.float32),
            np.asarray(res.predicts["Mean"]),
            rtol=1e-5,
        )
        np.testing.assert_allclose(
            log_w, np.asarray(res.log_weights), rtol=1e-5
        )

    def test_posterior_native_python_parity(self, key, tmp_path):
        """The wired-in native parser (load_posterior(native=True)) must
        agree exactly with the Python s-expression parser on a mixed
        int/real dump with repeated predicts."""
        from cpprob_jax.io.tracefile import native_available
        from cpprob_jax.models import hmm

        if not native_available():
            pytest.skip("no native lib")
        obs = jnp.array([0.9, -0.8, 0.7, 0.0, 1.1])
        res = ct.sis(hmm, (obs,), 400, key)
        path = str(tmp_path / "post")
        dump_posterior(path, res)
        pred_py, lw_py = load_posterior(path, native=False)
        pred_nat, lw_nat = load_posterior(path, native=True)
        np.testing.assert_allclose(lw_nat, lw_py, rtol=1e-12)
        assert pred_py.keys() == pred_nat.keys()
        for name in pred_py:
            np.testing.assert_allclose(
                np.asarray(pred_nat[name], np.float64),
                np.asarray(pred_py[name], np.float64),
                rtol=1e-12,
            )

    @pytest.mark.parametrize("native", [False, None])
    def test_mixed_int_real_dump_single_weight_vector(self, tmp_path, native):
        """ADVICE r3 (medium): a dump with BOTH .int and .real files (the
        SHERPA shape: int channel + real momentum) must yield ONE weight per
        particle, and StatsPrinter.from_dump must summarize it."""
        from cpprob_jax.inference.sis import ImportanceResult
        from cpprob_jax.postprocess.stats import StatsPrinter

        n = 50
        rng = np.random.default_rng(0)
        res = ImportanceResult(
            jnp.asarray(rng.standard_normal(n), jnp.float32),
            {
                "Channel": jnp.asarray(rng.integers(0, 4, n), jnp.int32),
                "Momentum": jnp.asarray(rng.standard_normal(n), jnp.float32),
            },
        )
        path = str(tmp_path / "mixed")
        dump_posterior(path, res)
        assert os.path.exists(path + ".int") and os.path.exists(path + ".real")
        predicts, log_w = load_posterior(path, native=native)
        assert log_w.shape == (n,)
        np.testing.assert_allclose(
            log_w, np.asarray(res.log_weights), rtol=1e-6
        )
        assert len(predicts["Channel"]) == n
        assert len(predicts["Momentum"]) == n
        s = StatsPrinter.from_dump(path, native=native).summary()
        assert s["Channel"]["kind"] == "int"
        assert s["Momentum"]["kind"] == "real"
        emp_mean = float(
            np.sum(
                np.exp(log_w - log_w.max()) * np.asarray(predicts["Momentum"])
            ) / np.sum(np.exp(log_w - log_w.max()))
        )
        np.testing.assert_allclose(
            float(s["Momentum"]["mean"]), emp_mean, rtol=1e-4
        )

    def test_posterior_npz_roundtrip(self, key, tmp_path):
        res = ct.sis(gaussian_unknown_mean_readme, (3.0, 4.0), 500, key)
        path = str(tmp_path / "posterior.npz")
        dump_posterior_npz(path, res)
        predicts, log_w = load_posterior_npz(path)
        np.testing.assert_allclose(
            predicts["Mean"], np.asarray(res.predicts["Mean"]), rtol=1e-6
        )


class TestNdarray:
    def test_scalar(self):
        assert to_ndarray(3.0).shape == ()

    def test_nested_ragged_padding(self):
        # ragged rows zero-padded (ndarray.hpp:361-467)
        out = to_ndarray([[1.0, 2.0], [3.0]])
        np.testing.assert_allclose(out, [[1.0, 2.0], [3.0, 0.0]])

    def test_tuple_mix(self):
        out = flatten_nested((1.0, [2.0, 3.0]))
        np.testing.assert_allclose(out[:1], [1.0])
        assert out.size >= 3

    def test_deep_nesting(self):
        out = to_ndarray([[[1.0], [2.0]], [[3.0], [4.0]]])
        assert out.shape == (2, 2, 1)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": jnp.arange(3.0), "b": [jnp.zeros((2, 2)), jnp.ones(())]}
        p = save_pytree(str(tmp_path / "ckpt-1"), tree)
        like = {"a": jnp.zeros(3), "b": [jnp.zeros((2, 2)), jnp.zeros(())]}
        loaded = load_pytree(p, like)
        np.testing.assert_allclose(np.asarray(loaded["a"]), [0, 1, 2])

    def test_shape_mismatch_raises(self, tmp_path):
        p = save_pytree(str(tmp_path / "ckpt-2"), {"a": jnp.zeros(3)})
        with pytest.raises(ValueError, match="shape"):
            load_pytree(p, {"a": jnp.zeros(4)})

    def test_latest(self, tmp_path):
        import time
        save_pytree(str(tmp_path / "ckpt-1"), {"a": jnp.zeros(1)})
        time.sleep(0.01)
        p2 = save_pytree(str(tmp_path / "ckpt-2"), {"a": jnp.zeros(1)})
        assert latest_checkpoint(str(tmp_path)) == p2


class TestLogger:
    def test_logs(self, capsys):
        lg = TrainLogger(stream=sys.stderr, print_every=1)
        lg.log(1.0, 64)
        lg.log(0.5, 64)
        err = capsys.readouterr().err
        assert "loss" in err and "traces/s" in err


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from cpprob_jax.cli import main; raise SystemExit(main())",
         ] + list(args),
        capture_output=True, text=True, env=env, timeout=600,
    )


class TestCLI:
    def test_list(self):
        r = _run_cli("--list", "--model", "x")
        assert r.returncode == 0
        assert "gaussian" in r.stdout and "hmm" in r.stdout

    def test_sis_gaussian(self):
        r = _run_cli("--model", "gaussian", "-m", "sis", "-n", "20000",
                     "-o", "3.0 4.0")
        assert r.returncode == 0, r.stderr
        assert "Mean" in r.stdout

    def test_dryrun(self):
        r = _run_cli("--model", "hmm", "-m", "dryrun")
        assert r.returncode == 0, r.stderr

    def test_dump_and_estimate(self, tmp_path):
        dump = str(tmp_path / "post")
        r = _run_cli("--model", "gaussian", "-m", "sis", "-n", "500",
                     "-o", "3.0 4.0", "--dump-path", dump)
        assert r.returncode == 0, r.stderr
        r2 = _run_cli("--model", "gaussian", "-m", "estimate",
                      "--dump-path", dump)
        assert r2.returncode == 0, r2.stderr
        assert "Mean" in r2.stdout

    def test_unknown_model(self):
        r = _run_cli("--model", "nope")
        assert r.returncode == 2

    def test_smc_mode(self):
        r = _run_cli("--model", "hmm", "-m", "smc", "-n", "4096",
                     "-o", "[0.9 0.8 0.7 0.0 1.1]")
        assert r.returncode == 0, r.stderr
        assert "log_evidence" in r.stdout

    def test_smc_mode_unsupported_model(self):
        r = _run_cli("--model", "gaussian", "-m", "smc", "-n", "16")
        assert r.returncode == 2

    def test_offline_compile_pipeline(self, tmp_path):
        shards = str(tmp_path / "shards")
        ck = str(tmp_path / "nn")
        r = _run_cli("--model", "gaussian", "-m", "compile",
                     "--dump-traces-dir", shards, "--n-traces", "2048",
                     "--batch-size", "64")
        assert r.returncode == 0, r.stderr
        r = _run_cli("--model", "gaussian", "-m", "compile",
                     "--traces-dir", shards, "--steps", "60",
                     "--batch-size", "128", "--ckpt-dir", ck)
        assert r.returncode == 0, r.stderr
        r = _run_cli("--model", "gaussian", "-m", "csis", "-n", "2000",
                     "-o", "3.0 4.0", "--ckpt-dir", ck)
        assert r.returncode == 0, r.stderr
        assert "Mean" in r.stdout


class TestOrbaxCheckpoint:
    def test_roundtrip(self, tmp_path):
        from cpprob_jax.util import load_pytree_orbax, save_pytree_orbax

        tree = {"w": jnp.arange(4.0), "b": jnp.ones((2,))}
        p = save_pytree_orbax(str(tmp_path / "ock"), tree)
        out = load_pytree_orbax(p)
        np.testing.assert_allclose(np.asarray(out["w"]), [0, 1, 2, 3])
        np.testing.assert_allclose(np.asarray(out["b"]), [1, 1])

    def test_pg_mode(self):
        r = _run_cli("--model", "hmm", "-m", "pg", "-n", "16",
                     "--iters", "50", "--burn-in", "10",
                     "-o", "[0.9 0.8 0.7 0.0 1.1]")
        assert r.returncode == 0, r.stderr
        assert "z[4]" in r.stdout

    def test_pg_mode_needs_ssm(self):
        r = _run_cli("--model", "gaussian", "-m", "pg", "-o", "3.0 4.0")
        assert r.returncode == 2

    def test_tempered_mode(self):
        r = _run_cli("--model", "gaussian", "-m", "tempered", "-n", "1024",
                     "-o", "3.0 4.0")
        assert r.returncode == 0, r.stderr
        assert "log_evidence" in r.stdout and "mu" in r.stdout
