"""Counter-based random bits: Threefry-2x32 with 20 rounds, in plain ``jnp``.

Salmon et al., "Parallel random numbers: as easy as 1, 2, 3" (SC 2011).  The
output is bit-identical to ``jax.random``'s own threefry2x32 for the same key
and counter words.  Written with nothing but uint32 add, shift, or and xor, so
the same function runs inside a Pallas kernel (either route, or the
interpreter) and in plain XLA: a kernel and its reference see the same bits
for the same (key, counter) pair.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["threefry2x32", "uniform_from_bits"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32-20 of counter words (x0, x1) under key words (k0, k1).

    All arguments are uint32 scalars or arrays that broadcast together; the
    result is the pair of uint32 output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform_from_bits(bits):
    """Top 24 bits of a uint32 word -> float32 in [0, 1), exactly."""
    top = (bits >> np.uint32(8)).astype(jnp.int32)
    return top.astype(jnp.float32) * np.float32(1.0 / (1 << 24))
