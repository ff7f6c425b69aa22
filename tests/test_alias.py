"""A former top-level package name resolves to cpprob_jax's own modules."""

import importlib
import importlib.util
import pathlib
import runpy
import sys

import pytest

import cpprob_jax
from cpprob_jax._alias import alias_package

REPO = pathlib.Path(__file__).resolve().parents[1]
PROBE = "cpprob_alias_probe"


def test_alias_shares_module_objects():
    alias_package(PROBE)
    mod = importlib.import_module(PROBE + ".inference.smc")
    assert mod is cpprob_jax.inference.smc
    assert importlib.import_module(PROBE) is cpprob_jax
    from cpprob_alias_probe.inference.smc import StateSpaceModel

    assert StateSpaceModel is cpprob_jax.inference.smc.StateSpaceModel
    # the shared module keeps its own spec
    assert mod.__spec__.name == "cpprob_jax.inference.smc"
    assert importlib.util.find_spec(PROBE + ".no_such_module") is None


def test_alias_runs_module_as_main(monkeypatch, capsys):
    alias_package(PROBE)
    monkeypatch.setattr(sys, "argv", ["cli", "--list"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_module(PROBE + ".cli", run_name="__main__")
    assert exc.value.code == 0
    assert "hmm" in capsys.readouterr().out


def test_former_package_directories_import():
    """Every alias package at the repository root imports as cpprob_jax."""
    found = [p.parent.name for p in REPO.glob("*/__init__.py")
             if "alias_package(__name__)" in p.read_text()]
    assert found
    for name in found:
        assert importlib.import_module(name) is cpprob_jax
        assert importlib.import_module(name + ".cli") is cpprob_jax.cli
