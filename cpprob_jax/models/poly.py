"""Polynomial / linear regression models — counterparts of
``include/models/poly_adjustment.hpp`` (``poly_adjustment<D,N>``,
``poly_adjustment_prior``, ``linear_regression``).

The reference's metaprior/``Builder`` template machinery (priors over the
observation-generating *arguments*, ``metapriors.hpp:17-58``) becomes ordinary
model code: a generator model (:func:`poly_adjustment_prior_gen`) whose
dataset size is drawn from a positive Poisson and whose x-coordinates are
drawn from a normal — run under ``SimulateObserves`` it generates synthetic
datasets for inference compilation, exactly what the C++ metapriors did.
Variable dataset size is handled the static-shape way: a static maximum plus a 0/1
mask (SURVEY.md §7 'hard parts').
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import handlers, metaobserve, observe, predict, sample
from ..distributions import Normal, Poisson, UniformInt

__all__ = [
    "generate_polynomial",
    "eval_poly",
    "poly_adjustment",
    "linear_regression",
    "poly_adjustment_prior_gen",
]


def generate_polynomial(degree: int):
    """coef_i ~ N(0, 10) for i in 0..degree (``poly_adjustment.hpp:16-24``)."""
    return [
        sample(Normal(0.0, 10.0), addr=f"coef[{i}]") for i in range(degree + 1)
    ]


def eval_poly(poly, x):
    """Horner evaluation (``poly_adjustment.hpp:26-31``)."""
    acc = jnp.zeros_like(jnp.asarray(x, jnp.result_type(x, jnp.float32)))
    for c in reversed(poly):
        acc = acc * x + c
    return acc


def poly_adjustment(points, degree: int = 1):
    """points: (N, 2) array of (x, y) pairs (``poly_adjustment.hpp:84-96``)."""
    points = jnp.asarray(points)
    poly = generate_polynomial(degree)
    for i in range(points.shape[0]):
        observe(
            Normal(eval_poly(poly, points[i, 0]), 1.0), points[i, 1],
            addr=f"y[{i}]",
        )
    for i, c in enumerate(poly):
        predict(c, "Coefficient")
    return poly


def linear_regression(points):
    """a, b ~ N(0, 10); y ~ N(a x + b, 1) (``poly_adjustment.hpp:57-80``)."""
    points = jnp.asarray(points)
    a = sample(Normal(0.0, 10.0), addr="a")
    b = sample(Normal(0.0, 10.0), addr="b")
    for i in range(points.shape[0]):
        metaobserve(Normal(3.0, 1.0), points[i, 0], addr=f"x[{i}]")
        observe(Normal(a * points[i, 0] + b, 1.0), points[i, 1], addr=f"y[{i}]")
    predict(a, "a")
    predict(b, "b")
    return a, b


def poly_adjustment_prior_gen(degree: int = 1, max_points: int = 32):
    """Metaprior'd generator (``poly_adjustment_prior``): dataset size
    n ~ 1 + Poisson(10) (positive Poisson), x_i ~ N(0, 10), y_i ~ N(poly(x), 1).

    Static-shape formulation: always max_points sites, masked beyond n.
    Returns (poly coefs, xs, ys, mask).
    """
    n = 1 + sample(Poisson(10.0), addr="n_points", control=False)
    n = jnp.minimum(n, max_points)
    poly = generate_polynomial(degree)
    xs, ys = [], []
    idx = jnp.arange(max_points)
    for i in range(max_points):
        active = (idx[i] < n).astype(jnp.float32)
        with handlers.Mask(active):
            x = sample(Normal(0.0, 10.0), addr=f"x[{i}]", control=False)
            # In compile mode observes are simulated; in inference they weight.
            y = observe(
                Normal(eval_poly(poly, x), 1.0), jnp.zeros(()), addr=f"y[{i}]"
            )
        xs.append(x)
        ys.append(y)
    for c in poly:
        predict(c, "Coefficient")
    return poly, jnp.stack(xs), jnp.stack(ys), (idx < n)
