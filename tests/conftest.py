"""Test configuration: force an 8-device virtual CPU mesh so multi-device
sharding paths are exercised without accelerators (SURVEY.md §4's
recommendation; ``__graft_entry__.dryrun_multichip`` runs the same paths).

Tests that need the card carry the ``gpu`` marker and skip here.  On the
card, ``chip_smoke.py`` runs them in its own process with
``CPPROB_GPU_TESTS=1``, which keeps the backend JAX already opened."""

import os
import sys

_ON_CARD = os.environ.get("CPPROB_GPU_TESTS") == "1"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests off the card.  Decided per test, at run
    time, so every xdist worker collects the same tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")


@pytest.fixture
def key():
    return jax.random.key(0)


@pytest.fixture
def devices8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]
