"""CLI parity: the reference drives its whole workflow
through its CLI (``src/main.cpp:116-239``, ``infcomp/main.py:15-40``) —
compile-mode controls ``--obs_embedding`` (main.py:35), ``--resume``
(main.py:38), ``--save_after_n_traces`` (main.py:33-34) and Ctrl-C-safe
checkpointing (``train.py:47-53``) must be reachable from ours too, plus the
engine options (tie-addresses / mdn / flow-bins / dynamic)."""

import glob

import jax
import numpy as np
import pytest

from cpprob_jax.cli import main


class TestBasicModes:
    def test_list(self, capsys):
        assert main(["--model", "x", "--list"]) == 0
        out = capsys.readouterr().out
        assert "gaussian" in out and "hmm" in out

    def test_sis_gaussian(self, capsys):
        rc = main(["--model", "gaussian", "-m", "sis", "-n", "4000",
                   "-o", "3.0 4.0", "--seed", "1"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "Mean" in out
        # the README analytic posterior: 2.32353 / 1.05882
        mean = float(out.split("Mean:")[-1].split()[0])
        assert abs(mean - 2.32353) < 0.15


class TestCompileResumeRoundtrip:
    def test_compile_save_every_resume_csis(self, tmp_path, capsys):
        """compile (periodic saves) -> resume -> csis round trip, all through
        the CLI — the reference's main.py workflow end-to-end."""
        ckpt = str(tmp_path / "nn")
        rc = main(["--model", "gaussian", "-m", "compile", "--steps", "6",
                   "--batch-size", "16", "--ckpt-dir", ckpt,
                   "--save-every", "32", "--seed", "0"])
        assert rc == 0
        ckpts = glob.glob(ckpt + "/ckpt-*.npz")
        # every 32 traces at 16/step -> saves at steps 2,4,6; plus the final
        assert len(ckpts) >= 3

        rc = main(["--model", "gaussian", "-m", "compile", "--steps", "3",
                   "--batch-size", "16", "--ckpt-dir", ckpt, "--resume",
                   "--seed", "1"])
        assert rc == 0
        assert "resuming from" in capsys.readouterr().err

        rc = main(["--model", "gaussian", "-m", "csis", "-n", "800",
                   "-o", "3.0 4.0", "--ckpt-dir", ckpt, "--seed", "2"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "Mean" in out

    def test_resume_warm_starts_standard_engine(self, tmp_path, capsys,
                                                monkeypatch):
        """--resume must actually pass the loaded params into the standard
        (non-dynamic) engine's compile — the r4 advisor found it printed
        'resuming from' yet silently retrained from scratch."""
        from cpprob_jax.inference.csis import CSIS

        ckpt = str(tmp_path / "nn")
        rc = main(["--model", "gaussian", "-m", "compile", "--steps", "2",
                   "--batch-size", "8", "--ckpt-dir", ckpt, "--seed", "0"])
        assert rc == 0

        seen = {}
        orig = CSIS.compile

        def spy(self, key, *a, **kw):
            seen["params"] = kw.get("params")
            return orig(self, key, *a, **kw)

        monkeypatch.setattr(CSIS, "compile", spy)
        rc = main(["--model", "gaussian", "-m", "compile", "--steps", "2",
                   "--batch-size", "8", "--ckpt-dir", ckpt, "--resume",
                   "--seed", "1"])
        assert rc == 0
        assert "resuming from" in capsys.readouterr().err
        assert seen["params"] is not None

    def test_resume_without_ckpt_dir_errors(self, capsys):
        assert main(["--model", "gaussian", "-m", "compile", "--resume"]) == 2

    def test_save_every_without_ckpt_dir_errors(self, capsys):
        assert main(["--model", "gaussian", "-m", "compile",
                     "--save-every", "10"]) == 2


class TestCtrlCSafety:
    def test_compile_interrupt_returns_partial(self, tmp_path, key):
        """KeyboardInterrupt mid-training returns the partially trained
        params (and periodic checkpoints survive) instead of unwinding —
        reference ``train.py:47-53``."""
        from cpprob_jax.inference.csis import CSIS
        from cpprob_jax.models import gaussian_unknown_mean_readme
        from cpprob_jax.util import periodic_saver

        eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
        saver = periodic_saver(str(tmp_path), 16)
        calls = []

        def log_fn(loss, n):
            calls.append(loss)
            if len(calls) == 3:
                raise KeyboardInterrupt

        params, losses = eng.compile(
            key, steps=50, batch_size=16, log_fn=log_fn, saver=saver
        )
        assert params is not None
        assert 0 < losses.shape[0] < 50
        assert len(glob.glob(str(tmp_path) + "/ckpt-*.npz")) >= 1
        # the partial network still serves
        res = eng.infer(params, (3.0, 4.0), 200, jax.random.key(1))
        assert np.isfinite(np.asarray(res.log_weights)).all()


class TestEngineOptionFlags:
    def test_mdn_flag(self, tmp_path, capsys):
        ckpt = str(tmp_path / "nn")
        rc = main(["--model", "gaussian", "-m", "compile", "--steps", "2",
                   "--batch-size", "8", "--ckpt-dir", ckpt, "--mdn", "3"])
        assert rc == 0
        rc = main(["--model", "gaussian", "-m", "csis", "-n", "200",
                   "-o", "3.0 4.0", "--ckpt-dir", ckpt, "--mdn", "3"])
        assert rc == 0

    def test_defensive_flag(self, tmp_path, capsys):
        ckpt = str(tmp_path / "nn")
        rc = main(["--model", "gaussian", "-m", "compile", "--steps", "2",
                   "--batch-size", "8", "--ckpt-dir", ckpt])
        assert rc == 0
        rc = main(["--model", "gaussian", "-m", "csis", "-n", "200",
                   "-o", "3.0 4.0", "--ckpt-dir", ckpt,
                   "--defensive", "0.2"])
        assert rc == 0
        assert "Mean" in capsys.readouterr().out

    def test_obs_embedding_lstm_flag(self, tmp_path):
        ckpt = str(tmp_path / "nn")
        rc = main(["--model", "gaussian", "-m", "compile", "--steps", "2",
                   "--batch-size", "8", "--ckpt-dir", ckpt,
                   "--obs-embedding", "lstm"])
        assert rc == 0

    def test_dynamic_flag_roundtrip(self, tmp_path, capsys):
        ckpt = str(tmp_path / "nn")
        rc = main(["--model", "gaussian", "-m", "compile", "--steps", "2",
                   "--batch-size", "8", "--ckpt-dir", ckpt, "--dynamic"])
        assert rc == 0
        rc = main(["--model", "gaussian", "-m", "csis", "-n", "50",
                   "-o", "3.0 4.0", "--ckpt-dir", ckpt, "--dynamic"])
        assert rc == 0
        assert "Mean" in capsys.readouterr().out

    def test_dynamic_incompatible_with_tied(self):
        with pytest.raises(SystemExit):
            main(["--model", "gaussian", "-m", "compile", "--dynamic",
                  "--tie-addresses", "--steps", "1"])
