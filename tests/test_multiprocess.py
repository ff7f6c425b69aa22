"""True multi-process SPMD validation (SURVEY.md §4's 'multi-host collective
tests on CPU jax.distributed' recommendation): two OS processes x 4 virtual
CPU devices each form one 8-device global mesh over jax.distributed (Gloo),
and the production sharded SIS/SMC paths must produce correct statistics
across the process boundary.  This is the closest achievable stand-in for
two hosts of 4 cards each on the CPU (on cards: same code, NCCL instead of
Gloo)."""

import os
import socket
import subprocess
import sys


_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# hang protection: the communicate(timeout=540) below (pytest-timeout is not
# a dependency, so a timeout marker here would be a silent no-op)
def test_two_process_mesh_sis_and_smc():
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"[{pid}] OK" in out, out[-2000:]
