"""Posterior statistics reporting — counterpart of the reference's
``StatsPrinter`` (``include/cpprob/postprocess/stats_printer.hpp:25-120``):
real predicts → weighted mean/variance; integer predicts → normalized
distribution table + MAP + point count.
"""

from __future__ import annotations

from typing import Dict, Optional, TextIO

import jax.numpy as jnp
import numpy as np

from .empirical import EmpiricalDistribution

__all__ = ["StatsPrinter"]


class StatsPrinter:
    """Formats an :class:`~cpprob_jax.inference.sis.ImportanceResult` (or any
    predicts dict + log-weights) the way the reference prints parsed posterior
    files."""

    def __init__(self, result):
        self.result = result

    @classmethod
    def from_dump(cls, path: str, native: Optional[bool] = None):
        """Build from a reference-format posterior dump on disk — the full
        ``StatsPrinter{outfile}`` path (``stats_printer.hpp:25-40``): parse
        ``<path>.ids`` + ``.int``/``.real`` (native C++ parser when
        available), then summarize."""
        from ..inference.sis import ImportanceResult
        from ..io.serialization import load_posterior

        predicts, log_w = load_posterior(path, native=native)
        predicts = {
            k: np.asarray(v) for k, v in predicts.items() if len(v)
        }
        return cls(ImportanceResult(jnp.asarray(log_w), predicts))

    def summary(self) -> Dict[str, dict]:
        out = {}
        lw = self.result.log_weights
        for name, values in self.result.predicts.items():
            vals = np.asarray(values)
            emp = EmpiricalDistribution(jnp.asarray(values), lw)
            if np.issubdtype(vals.dtype, np.integer):
                num_values = int(vals.max()) + 1 if vals.size else 1
                table = np.asarray(emp.distribution(num_values))
                out[name] = {
                    "kind": "int",
                    "distribution": table,
                    "map": np.asarray(emp.map_estimate(num_values)),
                    "count": vals.shape[0],
                }
            else:
                out[name] = {
                    "kind": "real",
                    "mean": np.asarray(emp.mean),
                    "variance": np.asarray(emp.variance),
                    "ess": float(np.asarray(emp.ess)),
                    "count": vals.shape[0],
                }
        return out

    def print(self, file: Optional[TextIO] = None) -> str:
        lines = []
        for name, s in self.summary().items():
            if s["kind"] == "real":
                lines.append(
                    f"{name}:\n  Mean: {s['mean']}\n  Variance: {s['variance']}\n"
                    f"  ESS: {s['ess']:.1f}  (n={s['count']})"
                )
            else:
                dist_str = np.array2string(s["distribution"], precision=5)
                lines.append(
                    f"{name}:\n  Distribution: {dist_str}\n  MAP: {s['map']}\n"
                    f"  (n={s['count']})"
                )
        text = "\n".join(lines)
        print(text, file=file)
        return text
