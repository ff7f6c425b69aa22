"""``chip_smoke.py``: the CPU rehearsal passes every phase at tiny sizes,
and without a GPU (or without the rest of the repo) the script fails
without printing a result line."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("CPPROB_GPU_TESTS", None)
    env.pop("XLA_FLAGS", None)  # one CPU device, not the suite's eight
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _result_line(stdout):
    lines = stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None


def test_rehearse_runs_every_phase():
    """About 35 s on an idle 8-core CPU; the limit leaves room for a
    loaded machine."""
    proc = _run(["chip_smoke.py", "--rehearse"], REPO, timeout=150)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = _result_line(proc.stdout)
    assert out["ok"] is True and out["device"]["platform"] == "cpu"
    assert "FAILED" not in proc.stdout
    for phase in ("hmm_sweeps", "same_bits", "csis_phase", "gpu_tests"):
        assert f"== phase {phase} done" in proc.stdout


def test_fails_without_gpu():
    proc = _run(["chip_smoke.py"], REPO, timeout=120)
    assert proc.returncode != 0
    assert _result_line(proc.stdout) is None


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path), timeout=120)
    assert proc.returncode != 0
    assert _result_line(proc.stdout) is None


def test_bench_fails_without_gpu():
    proc = _run(["bench.py"], REPO, timeout=120)
    assert proc.returncode != 0
    assert _result_line(proc.stdout) is None
