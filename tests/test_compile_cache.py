"""Placement of JAX's persistent compilation cache
(``util.compile_cache.enable_compile_cache``), checked in fresh processes
because JAX reads ``JAX_COMPILATION_CACHE_DIR`` when it is imported."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = (
    "import json, jax; "
    "from cpprob_jax.util.compile_cache import enable_compile_cache; "
    "path = enable_compile_cache(); "
    "print(json.dumps([path, jax.config.jax_compilation_cache_dir]))"
)


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_cache_defaults_to_repo_dir():
    path, configured = _probe(None)
    assert path == configured == os.path.join(REPO, ".jax_cache")


def test_cache_follows_environment(tmp_path):
    target = str(tmp_path / "jax-cache")
    path, configured = _probe(target)
    assert path == configured == target
