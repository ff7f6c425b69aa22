"""Training/inference logger — counterpart of the reference's ``_Logger``
(``infcomp/logger.py:54-235``): formatted training table with rolling
validation loss, best tracking, traces/s, file + console sinks; plus a
hardware banner (``logger.py:11-22``).
"""

from __future__ import annotations

import sys
import time
from collections import deque
from typing import Optional, TextIO

__all__ = ["TrainLogger", "hardware_banner"]


def hardware_banner() -> str:
    import jax

    devs = jax.devices()
    lines = [
        f"cpprob_jax on {jax.default_backend()} — {len(devs)} device(s)",
    ]
    for d in devs[:8]:
        lines.append(f"  {d}")
    if len(devs) > 8:
        lines.append(f"  ... and {len(devs) - 8} more")
    return "\n".join(lines)


class TrainLogger:
    """Rolling-window loss table (window 50, like the reference's rolling
    'validation' loss, ``logger.py:127-178``)."""

    HEADER = (
        f"{'time':>10} {'step':>8} {'traces':>12} {'loss':>12} "
        f"{'rolling50':>12} {'best':>12} {'traces/s':>10}"
    )

    def __init__(
        self,
        file_path: Optional[str] = None,
        stream: TextIO = sys.stderr,
        print_every: int = 50,
    ):
        self.t0 = time.time()
        self.window: deque = deque(maxlen=50)
        self.best = float("inf")
        self.total_traces = 0
        self.step = 0
        self.print_every = print_every
        self.stream = stream
        self.file = open(file_path, "a") if file_path else None
        self._last_time = self.t0
        self._last_traces = 0
        self._emit(self.HEADER)

    def _emit(self, line: str):
        if self.stream is not None:
            print(line, file=self.stream)
        if self.file is not None:
            self.file.write(line + "\n")
            self.file.flush()

    def log(self, loss: float, n_traces: int):
        self.step += 1
        self.total_traces += n_traces
        self.window.append(loss)
        rolling = sum(self.window) / len(self.window)
        self.best = min(self.best, rolling)
        if self.step % self.print_every == 0:
            now = time.time()
            rate = (self.total_traces - self._last_traces) / max(
                now - self._last_time, 1e-9
            )
            self._last_time = now
            self._last_traces = self.total_traces
            elapsed = now - self.t0
            self._emit(
                f"{elapsed:>9.1f}s {self.step:>8} {self.total_traces:>12} "
                f"{loss:>12.4f} {rolling:>12.4f} {self.best:>12.4f} "
                f"{rate:>10.0f}"
            )

    def close(self):
        if self.file is not None:
            self.file.close()
