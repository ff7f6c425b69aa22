"""External black-box simulator bridge — the reference's defining premise,
inside compiled programs.

CPProb exists to do inference on "models written as arbitrary C++14
functions" that wrap *external, non-differentiable, non-introspectable*
simulators — its flagship model calls the SHERPA HEP event generator through
``while (!generator_->GenerateOneEvent())`` in another library's event loop
(``src/models/sherpa.cpp:29-86``, ``README.md:5-13``).  This module is that
capability here: a model body may call an out-of-process simulator, and both
the eager and the jitted/vmapped engines can still run it.

Two seams:

- :class:`SubprocessSimulator` — a persistent child process speaking a
  line protocol (one whitespace-separated float vector in, one out per
  event).  Language-agnostic: the child can be C++, Fortran, anything.
- :func:`observe_external` — a ``jax.pure_callback`` wrapper so the
  simulator call can sit *inside* traced code: under ``vmap`` the callback
  receives the whole particle batch at once and ships it to the child in
  one pipelined exchange, so the device keeps the before/after compute and the
  host round-trip is amortized over particles (the reference pays one
  synchronous ZMQ round trip *per sample statement*, ``socket.hpp:57-79``).

Eager engines (:class:`~cpprob_jax.inference.csis_dynamic.DynamicCSIS`,
``sis_host``) can simply call the simulator directly in the model body —
that path needs no wrapper at all.

Typical model shape (mirrors ``sherpa.cpp:49-68``: simulate, then ABC-observe
the detector response)::

    sim = SubprocessSimulator([...argv...], obs_dim=64)

    def model(observed):
        ch = sample(UniformInt(0, 3), addr="Decay Channel")
        e = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = observe_external(sim, jnp.stack([ch + 0.0, e]), 64)
        observe(make_abc(lambda k: deposits, abc_kernel(deposits)),
                observed, addr="calo")
        predict(ch, "Channel")
"""

from __future__ import annotations

import itertools
import subprocess
import threading
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SubprocessSimulator", "observe_external"]


class SubprocessSimulator:
    """Persistent out-of-process simulator speaking a text line protocol:
    parent writes one whitespace-separated float vector per event request,
    child answers with one whitespace-separated float vector per line.

    The child is any executable (``argv``); it must answer requests 1:1 in
    order.  ``batch`` pipelines a whole population of requests through the
    pipe with a writer thread (no deadlock on full pipe buffers).
    """

    def __init__(self, argv: Sequence[str], obs_dim: int,
                 start_timeout: float = 30.0):
        self.argv = list(argv)
        self.obs_dim = obs_dim
        self.proc = subprocess.Popen(
            self.argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1,
        )
        self._lock = threading.Lock()
        # handshake: child prints "ready <obs_dim>" on startup
        line = self.proc.stdout.readline()
        parts = line.split()
        if len(parts) != 2 or parts[0] != "ready":
            raise RuntimeError(
                f"simulator {self.argv!r} bad handshake: {line!r}"
            )
        child_dim = int(parts[1])
        if child_dim != obs_dim:
            raise RuntimeError(
                f"simulator obs_dim {child_dim} != declared {obs_dim}"
            )

    def __call__(self, params: np.ndarray) -> np.ndarray:
        return self.batch(np.asarray(params, np.float64)[None, :])[0]

    def batch(self, params: np.ndarray) -> np.ndarray:
        """Run one event per row of ``params`` (n, d) -> (n, obs_dim)."""
        params = np.asarray(params, np.float64)
        n = params.shape[0]
        lines = "\n".join(
            " ".join(repr(float(x)) for x in row) for row in params
        ) + "\n"
        out = np.empty((n, self.obs_dim), np.float32)
        with self._lock:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"simulator {self.argv!r} exited with "
                    f"{self.proc.returncode}"
                )
            writer = threading.Thread(
                target=self.proc.stdin.write, args=(lines,)
            )
            writer.start()
            for i in range(n):
                line = self.proc.stdout.readline()
                if not line:
                    raise RuntimeError("simulator closed its output pipe")
                out[i] = np.fromiter(
                    map(float, line.split()), np.float32,
                    count=self.obs_dim,
                )
            writer.join()
        return out

    def close(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_salt_counter = itertools.count(1)


def observe_external(sim: SubprocessSimulator, inputs, obs_dim: Optional[int]
                     = None, *, salt: Optional[int] = None):
    """Run the external simulator from inside traced (jit/vmap) code.

    ``inputs``: 1-D f32 array of simulator parameters for ONE event.  Under
    ``vmap`` (the particle axis), the host callback receives the whole
    (n, d) batch and makes a single pipelined exchange with the child
    process.  Returns the (obs_dim,) simulated observation per particle.

    The callback is declared non-differentiable black-box output — exactly
    the reference's contract for wrapped simulators.

    Purity caveat (ADVICE r3): ``jax.pure_callback`` assumes a *pure*
    function, while real simulators are stochastic.  To stop XLA from
    CSE-merging two calls with identical inputs into one simulator
    invocation, every trace-time call is salted with a distinct constant
    operand (override with ``salt=`` for reproducible program caching).
    A call whose result is entirely unused may still be elided from the
    compiled program — do not rely on external side effects of the child.
    """
    obs_dim = sim.obs_dim if obs_dim is None else obs_dim
    if salt is None:
        salt = next(_salt_counter) & 0x7FFFFFFF

    def cb(x, _salt):
        x = np.asarray(x)
        if x.ndim == 1:
            return sim.batch(x[None, :])[0]
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1])
        return sim.batch(flat).reshape(lead + (obs_dim,))

    return jax.pure_callback(
        cb,
        jax.ShapeDtypeStruct((obs_dim,), jnp.float32),
        jnp.asarray(inputs, jnp.float32),
        jnp.int32(salt),
        vmap_method="expand_dims",
    )
