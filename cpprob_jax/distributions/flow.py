"""Normalizing-flow distribution for proposal heads: a univariate
location-scale rational-quadratic-spline flow (Durkan et al., "Neural Spline
Flows", NeurIPS 2019) over a standard-normal base.

Beyond the reference's proposal families (single Gaussian / truncated mixture,
``infcomp/distributions/proposal_distributions.py``): one spline head
represents multimodal *and* heavily skewed posteriors with exact, cheap
``log_prob`` (monotone piecewise-rational map — analytic forward, inverse and
Jacobian; no iterative inversion), which is what an importance-sampling
proposal needs.  All ops are elementwise + a K-way compare: vmap/jit
friendly, no gathers beyond a K-wide ``take_along_axis``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .base import Distribution, dist_dataclass

__all__ = ["SplineFlow1D"]

_HALF_LOG_2PI = 0.9189385332046727
_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3


def _spline_params(w_logits, h_logits, d_raw, bound):
    """Normalize raw head outputs into knot positions and derivatives.

    Returns (xs, ys, ds): knots (..., K+1) in x and y over [-B, B], and
    derivatives (..., K+1) with boundary derivatives pinned to 1 so the
    spline continues smoothly into the identity tails."""
    K = w_logits.shape[-1]
    w = jax.nn.softmax(w_logits, axis=-1)
    h = jax.nn.softmax(h_logits, axis=-1)
    w = _MIN_BIN + (1.0 - _MIN_BIN * K) * w
    h = _MIN_BIN + (1.0 - _MIN_BIN * K) * h
    xs = jnp.concatenate(
        [jnp.zeros_like(w[..., :1]), jnp.cumsum(w, axis=-1)], axis=-1
    )
    ys = jnp.concatenate(
        [jnp.zeros_like(h[..., :1]), jnp.cumsum(h, axis=-1)], axis=-1
    )
    xs = 2.0 * bound * xs - bound
    ys = 2.0 * bound * ys - bound
    d_in = _MIN_DERIV + jax.nn.softplus(d_raw)
    ones = jnp.ones_like(d_in[..., :1])
    ds = jnp.concatenate([ones, d_in, ones], axis=-1)
    return xs, ys, ds


def _gather_bin(arr, idx):
    arr_b = jnp.broadcast_to(arr, idx.shape + arr.shape[-1:])
    return jnp.take_along_axis(arr_b, idx[..., None], axis=-1)[..., 0]


def _rqs(z, xs, ys, ds, inverse: bool):
    """Monotone rational-quadratic spline on [-B, B] (identity outside).
    Returns (out, log|d out/d in|)."""
    K = xs.shape[-1] - 1
    bound = xs[..., -1]
    inside = (z > -bound) & (z < bound)
    zc = jnp.clip(z, -bound + 1e-6, bound - 1e-6)

    knots = ys if inverse else xs
    idx = jnp.clip(
        jnp.sum((zc[..., None] >= knots[..., :-1]).astype(jnp.int32), axis=-1)
        - 1,
        0,
        K - 1,
    )
    x0 = _gather_bin(xs, idx)
    x1 = _gather_bin(xs, idx + 1)
    y0 = _gather_bin(ys, idx)
    y1 = _gather_bin(ys, idx + 1)
    d0 = _gather_bin(ds, idx)
    d1 = _gather_bin(ds, idx + 1)
    dx = x1 - x0
    dy = y1 - y0
    s = dy / dx

    if not inverse:
        xi = (zc - x0) / dx
        xi1 = xi * (1.0 - xi)
        denom = s + (d1 + d0 - 2.0 * s) * xi1
        out = y0 + dy * (s * xi * xi + d0 * xi1) / denom
        deriv = (
            s * s * (d1 * xi * xi + 2.0 * s * xi1 + d0 * (1.0 - xi) ** 2)
            / (denom * denom)
        )
        logd = jnp.log(deriv)
    else:
        # solve the quadratic a xi^2 + b xi + c = 0 for xi (Durkan et al. A.3)
        t = zc - y0
        a = dy * (s - d0) + t * (d1 + d0 - 2.0 * s)
        b = dy * d0 - t * (d1 + d0 - 2.0 * s)
        c = -s * t
        disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
        xi = 2.0 * c / (-b - jnp.sqrt(disc))
        xi = jnp.clip(xi, 0.0, 1.0)
        xi1 = xi * (1.0 - xi)
        denom = s + (d1 + d0 - 2.0 * s) * xi1
        out = x0 + xi * dx
        deriv = (
            s * s * (d1 * xi * xi + 2.0 * s * xi1 + d0 * (1.0 - xi) ** 2)
            / (denom * denom)
        )
        logd = -jnp.log(deriv)

    out = jnp.where(inside, out, z)
    logd = jnp.where(inside, logd, 0.0)
    return out, logd


@dist_dataclass
class SplineFlow1D(Distribution):
    """x = loc + scale * f(z), z ~ N(0, 1), f a K-bin rational-quadratic
    spline on [-bound, bound] with identity tails.

    Head layout (CSIS kind ``"nsf"``): ``w_logits`` (..., K) bin widths,
    ``h_logits`` (..., K) heights, ``d_raw`` (..., K-1) interior derivatives,
    plus location and scale.
    """

    w_logits: jax.Array
    h_logits: jax.Array
    d_raw: jax.Array
    loc: jax.Array
    scale: jax.Array
    bound: float = dataclasses.field(default=4.0, metadata=dict(static=True))

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        z = jax.random.normal(key, shape)
        xs, ys, ds = _spline_params(
            self.w_logits, self.h_logits, self.d_raw, self.bound
        )
        x, _ = _rqs(z, xs, ys, ds, inverse=False)
        return self.loc + self.scale * x

    def log_prob(self, x):
        xs, ys, ds = _spline_params(
            self.w_logits, self.h_logits, self.d_raw, self.bound
        )
        u = (jnp.asarray(x, jnp.float32) - self.loc) / self.scale
        z, logd_inv = _rqs(u, xs, ys, ds, inverse=True)
        log_base = -0.5 * z * z - _HALF_LOG_2PI
        return log_base + logd_inv - jnp.log(self.scale)

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(
            self.w_logits.shape[:-1], jnp.shape(self.loc), jnp.shape(self.scale)
        )
