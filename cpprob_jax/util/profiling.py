"""Profiling helpers — greenfield relative to the reference (SURVEY.md §5:
the reference has no tracing/profiling beyond progress prints).

``profile_trace`` wraps the JAX profiler (view in TensorBoard/XProf);
``StageTimer`` gives cheap wall-clock per-stage timing with device sync.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax

__all__ = ["profile_trace", "StageTimer", "env_versions",
           "card_name_and_power_limit"]


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first GPU as ``nvidia-smi`` reports it,
    read in a child process that never touches JAX; "unavailable" when
    there is no such tool.  A card set below its maximum power runs slower
    under load, so every measurement carries this line."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unavailable"
    return out[0].strip() if out else "unavailable"


def env_versions() -> Dict[str, str]:
    """Version stamp for printed measurements: jax/jaxlib/numpy/optax plus
    the platform, device and card (name and power limit) they were taken
    on.  The reference pins its toolchain in CI (.travis.yml:14-31); here
    the software stack travels with every number instead, so a silent jax
    upgrade or a card set to another power limit shows in the output."""
    import platform

    import numpy
    import optax

    try:
        import jaxlib

        jaxlib_v = getattr(jaxlib, "__version__", "unknown")
    except Exception:  # pragma: no cover
        jaxlib_v = "unavailable"
    dev = jax.devices()[0]
    return {
        "jax": jax.__version__,
        "jaxlib": jaxlib_v,
        "numpy": numpy.__version__,
        "optax": optax.__version__,
        "python": platform.python_version(),
        "backend": dev.platform,
        "device": str(dev),
        "device_kind": getattr(dev, "device_kind", "unknown"),
        "card": card_name_and_power_limit(),
    }


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a JAX profiler trace for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulates wall-clock per named stage; ``sync=True`` fences the device
    (a host read) before reading the clock so async dispatch doesn't hide
    compute in the wrong stage."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                jax.tree_util.tree_map(
                    lambda x: x.block_until_ready()
                    if hasattr(x, "block_until_ready") else x,
                    sync_on,
                )
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """JSON-friendly per-stage breakdown (for bench artifacts)."""
        return {
            name: {
                "total_s": total,
                "calls": self.counts[name],
                "mean_ms": total / self.counts[name] * 1e3,
            }
            for name, total in self.totals.items()
        }

    def report(self) -> str:
        lines = [f"{'stage':<24}{'total_s':>10}{'calls':>8}{'mean_ms':>10}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<24}{total:>10.3f}{n:>8}{total / n * 1e3:>10.2f}"
            )
        return "\n".join(lines)
