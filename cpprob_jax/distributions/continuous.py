"""Continuous distributions (vectorized counterparts of the reference's
Boost.Random adoption + trait layer, ``include/cpprob/distributions/utils_*.hpp``).

All are batched pytree dataclasses: parameters may be scalars or arrays, and
``sample``/``log_prob`` broadcast.  ``cdf`` is provided where the reference's
``normalise`` trait needs it (truncation mass, cf. ``utils_normal_distribution.hpp:94-101``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special
from jax.scipy.stats import beta as jsp_beta
from jax.scipy.stats import gamma as jsp_gamma

from .base import Distribution, dist_dataclass, promote_to_result_dtype

__all__ = [
    "Normal",
    "Uniform",
    "Beta",
    "Gamma",
    "Laplace",
    "Exponential",
    "MultivariateNormalDiag",
    "MultivariateNormalFull",
    "MinMaxContinuous",
    "LogNormal",
    "HalfNormal",
    "StudentT",
    "Cauchy",
]

_HALF_LOG_2PI = 0.9189385332046727417803297364056176


@dist_dataclass
class Normal(Distribution):
    """N(loc, scale).  scale==0 degenerates to a Dirac delta, matching the
    reference's sigma=0 convention (``utils_normal_distribution.hpp:21-45``)."""

    loc: jax.Array
    scale: jax.Array

    def sample(self, key, sample_shape=()):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        shape = sample_shape + jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(scale))
        eps = jax.random.normal(key, shape, dtype=loc.dtype)
        return loc + scale * eps

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        # sigma == 0 => Dirac: 0 where x == loc else -inf
        safe_scale = jnp.where(scale == 0, 1.0, scale)
        z = (x - loc) / safe_scale
        lp = -0.5 * z * z - jnp.log(safe_scale) - _HALF_LOG_2PI
        dirac = jnp.where(x == loc, jnp.zeros_like(lp), -jnp.inf)
        return jnp.where(scale == 0, dirac, lp)

    def cdf(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        # sigma == 0 => Dirac: step function at loc (0 below, 1 at/above)
        safe_scale = jnp.where(scale == 0, 1.0, scale)
        c = jsp_special.ndtr((x - loc) / safe_scale)
        step = jnp.where(x >= loc, jnp.ones_like(c), jnp.zeros_like(c))
        return jnp.where(scale == 0, step, c)

    def icdf(self, u):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        # sigma == 0 => all quantiles collapse to loc (and 0*ndtri(0)=nan is
        # avoided explicitly)
        q = jsp_special.ndtri(jnp.asarray(u, loc.dtype))
        return jnp.where(scale == 0, loc, loc + scale * q)

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        s = jnp.asarray(self.scale)
        return jnp.broadcast_to(s * s, self.batch_shape)


@dist_dataclass
class Uniform(Distribution):
    """Uniform(low, high) on the half-open interval [low, high).

    Counterpart of ``boost::random::uniform_real_distribution``
    (``utils_uniform_real.hpp``).  Its CSIS proposal is a truncated mixture of
    normals — see :mod:`cpprob_jax.inference.csis`."""

    low: jax.Array
    high: jax.Array

    def sample(self, key, sample_shape=()):
        low, high = promote_to_result_dtype(self.low, self.high)
        shape = sample_shape + jnp.broadcast_shapes(jnp.shape(low), jnp.shape(high))
        u = jax.random.uniform(key, shape, dtype=low.dtype)
        return low + (high - low) * u

    def log_prob(self, x):
        low, high = promote_to_result_dtype(self.low, self.high)
        x = jnp.asarray(x, low.dtype)
        inside = (x >= low) & (x <= high)
        # degenerate low == high => Dirac at low (log_prob 0 there, -inf off)
        width = high - low
        lp = jnp.where(width == 0, 0.0, -jnp.log(jnp.where(width == 0, 1.0, width)))
        return jnp.where(inside, lp, -jnp.inf)

    def cdf(self, x):
        low, high = promote_to_result_dtype(self.low, self.high)
        x = jnp.asarray(x, low.dtype)
        width = high - low
        safe = jnp.where(width == 0, 1.0, width)
        c = jnp.clip((x - low) / safe, 0.0, 1.0)
        step = jnp.where(x >= low, jnp.ones_like(c), jnp.zeros_like(c))
        return jnp.where(width == 0, step, c)

    def icdf(self, u):
        low, high = promote_to_result_dtype(self.low, self.high)
        return low + (high - low) * jnp.asarray(u, low.dtype)

    @property
    def mean(self):
        low, high = promote_to_result_dtype(self.low, self.high)
        return jnp.broadcast_to(0.5 * (low + high), self.batch_shape)

    @property
    def variance(self):
        low, high = promote_to_result_dtype(self.low, self.high)
        d = high - low
        return jnp.broadcast_to(d * d / 12.0, self.batch_shape)


@dist_dataclass
class Beta(Distribution):
    alpha: jax.Array
    beta: jax.Array

    def sample(self, key, sample_shape=()):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        shape = sample_shape + jnp.broadcast_shapes(jnp.shape(a), jnp.shape(b))
        return jax.random.beta(key, a, b, shape=shape, dtype=a.dtype)

    def log_prob(self, x):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        return jsp_beta.logpdf(jnp.asarray(x, a.dtype), a, b)

    def cdf(self, x):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        return jsp_special.betainc(a, b, jnp.clip(jnp.asarray(x, a.dtype), 0.0, 1.0))

    @property
    def mean(self):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        return jnp.broadcast_to(a / (a + b), self.batch_shape)

    @property
    def variance(self):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        s = a + b
        return jnp.broadcast_to(a * b / (s * s * (s + 1)), self.batch_shape)


@dist_dataclass
class Gamma(Distribution):
    """Gamma(shape=concentration, scale).  Boost parameterizes by (alpha, beta=scale)."""

    concentration: jax.Array
    scale: jax.Array

    def sample(self, key, sample_shape=()):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        shape = sample_shape + jnp.broadcast_shapes(jnp.shape(a), jnp.shape(scale))
        return jax.random.gamma(key, a, shape=shape, dtype=a.dtype) * scale

    def log_prob(self, x):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        return jsp_gamma.logpdf(jnp.asarray(x, a.dtype), a, scale=scale)

    def cdf(self, x):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        x = jnp.asarray(x, a.dtype)
        return jsp_special.gammainc(a, jnp.maximum(x, 0.0) / scale)

    @property
    def mean(self):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        return jnp.broadcast_to(a * scale, self.batch_shape)

    @property
    def variance(self):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        return jnp.broadcast_to(a * scale * scale, self.batch_shape)


@dist_dataclass
class Laplace(Distribution):
    loc: jax.Array
    scale: jax.Array

    def sample(self, key, sample_shape=()):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        shape = sample_shape + jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(scale))
        eps = jax.random.laplace(key, shape, dtype=loc.dtype)
        return loc + scale * eps

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        return -jnp.abs(x - loc) / scale - jnp.log(2.0 * scale)

    def cdf(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        z = (x - loc) / scale
        return jnp.where(z < 0, 0.5 * jnp.exp(z), 1.0 - 0.5 * jnp.exp(-z))

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        s = jnp.asarray(self.scale)
        return jnp.broadcast_to(2.0 * s * s, self.batch_shape)


@dist_dataclass
class Exponential(Distribution):
    rate: jax.Array

    def sample(self, key, sample_shape=()):
        (rate,) = promote_to_result_dtype(self.rate)
        shape = sample_shape + jnp.shape(rate)
        return jax.random.exponential(key, shape, dtype=rate.dtype) / rate

    def log_prob(self, x):
        (rate,) = promote_to_result_dtype(self.rate)
        x = jnp.asarray(x, rate.dtype)
        return jnp.where(x >= 0, jnp.log(rate) - rate * x, -jnp.inf)

    def cdf(self, x):
        (rate,) = promote_to_result_dtype(self.rate)
        x = jnp.asarray(x, rate.dtype)
        return jnp.where(x >= 0, 1.0 - jnp.exp(-rate * x), 0.0)

    @property
    def mean(self):
        (rate,) = promote_to_result_dtype(self.rate)
        return 1.0 / rate

    @property
    def variance(self):
        (rate,) = promote_to_result_dtype(self.rate)
        return 1.0 / (rate * rate)


@dist_dataclass
class MultivariateNormalDiag(Distribution):
    """Diagonal-covariance MVN — the reference's ``multivariate_normal_distribution``
    is exactly a vector of independent normals plus a shape
    (``include/cpprob/distributions/multivariate_normal.hpp``)."""

    loc: jax.Array    # (..., d)
    scale: jax.Array  # (..., d) or scalar

    event_ndim = 1

    @property
    def event_shape(self):
        return (jnp.shape(self.loc)[-1],)

    def sample(self, key, sample_shape=()):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        shape = sample_shape + jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(jnp.broadcast_to(scale, jnp.shape(loc))))
        eps = jax.random.normal(key, shape, dtype=loc.dtype)
        return loc + scale * eps

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        scale_b = jnp.broadcast_to(scale, jnp.shape(loc))
        z = (x - loc) / scale_b
        per_dim = -0.5 * z * z - jnp.log(scale_b) - _HALF_LOG_2PI
        return jnp.sum(per_dim, axis=-1)

    @property
    def mean(self):
        return jnp.asarray(self.loc)

    @property
    def variance(self):
        s = jnp.broadcast_to(jnp.asarray(self.scale), jnp.shape(self.loc))
        return s * s


@dist_dataclass
class MultivariateNormalFull(Distribution):
    """Full-covariance MVN, Cholesky-parameterized (beyond the reference's
    diagonal-only ``multivariate_normal_distribution``).  ``scale_tril`` is
    the lower-triangular Cholesky factor of the covariance."""

    loc: jax.Array         # (..., d)
    scale_tril: jax.Array  # (..., d, d) lower triangular

    event_ndim = 1

    @property
    def event_shape(self):
        return (jnp.shape(self.loc)[-1],)

    @classmethod
    def from_covariance(cls, loc, cov):
        return cls(jnp.asarray(loc), jnp.linalg.cholesky(jnp.asarray(cov)))

    def sample(self, key, sample_shape=()):
        loc, = promote_to_result_dtype(self.loc)
        tril = jnp.asarray(self.scale_tril, loc.dtype)
        shape = sample_shape + jnp.shape(loc)
        eps = jax.random.normal(key, shape, dtype=loc.dtype)
        return loc + jnp.einsum("...ij,...j->...i", tril, eps)

    def log_prob(self, x):
        loc, = promote_to_result_dtype(self.loc)
        tril = jnp.asarray(self.scale_tril, loc.dtype)
        x = jnp.asarray(x, loc.dtype)
        d = jnp.shape(loc)[-1]
        diff = x - loc
        z = jax.scipy.linalg.solve_triangular(tril, diff[..., None], lower=True)[..., 0]
        log_det = jnp.sum(jnp.log(jnp.abs(jnp.diagonal(tril, axis1=-2, axis2=-1))), axis=-1)
        return -0.5 * jnp.sum(z * z, axis=-1) - log_det - d * _HALF_LOG_2PI

    @property
    def mean(self):
        return jnp.asarray(self.loc)

    @property
    def variance(self):
        tril = jnp.asarray(self.scale_tril)
        return jnp.sum(tril * tril, axis=-1)


@dist_dataclass
class LogNormal(Distribution):
    """exp(N(loc, scale)) — beyond the reference's set (extension for
    hierarchical/positive-scale modeling)."""

    loc: jax.Array
    scale: jax.Array

    def sample(self, key, sample_shape=()):
        return jnp.exp(Normal(self.loc, self.scale).sample(key, sample_shape))

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        safe_x = jnp.maximum(x, jnp.finfo(loc.dtype).tiny)
        lp = Normal(loc, scale).log_prob(jnp.log(safe_x)) - jnp.log(safe_x)
        return jnp.where(x > 0, lp, -jnp.inf)

    def cdf(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        safe_x = jnp.maximum(x, jnp.finfo(loc.dtype).tiny)
        return jnp.where(x > 0, Normal(loc, scale).cdf(jnp.log(safe_x)), 0.0)

    @property
    def mean(self):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        return jnp.exp(loc + 0.5 * scale * scale)

    @property
    def variance(self):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        s2 = scale * scale
        return (jnp.exp(s2) - 1.0) * jnp.exp(2.0 * loc + s2)


@dist_dataclass
class HalfNormal(Distribution):
    scale: jax.Array

    def sample(self, key, sample_shape=()):
        (scale,) = promote_to_result_dtype(self.scale)
        shape = sample_shape + jnp.shape(scale)
        return jnp.abs(jax.random.normal(key, shape, dtype=scale.dtype)) * scale

    def log_prob(self, x):
        (scale,) = promote_to_result_dtype(self.scale)
        x = jnp.asarray(x, scale.dtype)
        lp = Normal(0.0, scale).log_prob(x) + jnp.log(2.0)
        return jnp.where(x >= 0, lp, -jnp.inf)

    def cdf(self, x):
        (scale,) = promote_to_result_dtype(self.scale)
        x = jnp.asarray(x, scale.dtype)
        return jnp.where(x >= 0, 2.0 * Normal(0.0, scale).cdf(x) - 1.0, 0.0)

    @property
    def mean(self):
        (scale,) = promote_to_result_dtype(self.scale)
        return scale * jnp.sqrt(2.0 / jnp.pi)

    @property
    def variance(self):
        (scale,) = promote_to_result_dtype(self.scale)
        return scale * scale * (1.0 - 2.0 / jnp.pi)


@dist_dataclass
class StudentT(Distribution):
    df: jax.Array
    loc: jax.Array
    scale: jax.Array

    def sample(self, key, sample_shape=()):
        df, loc, scale = promote_to_result_dtype(self.df, self.loc, self.scale)
        shape = sample_shape + jnp.broadcast_shapes(
            jnp.shape(df), jnp.shape(loc), jnp.shape(scale)
        )
        t = jax.random.t(key, df, shape=shape, dtype=loc.dtype)
        return loc + scale * t

    def log_prob(self, x):
        df, loc, scale = promote_to_result_dtype(self.df, self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        z = (x - loc) / scale
        half = 0.5 * (df + 1.0)
        return (
            jsp_special.gammaln(half)
            - jsp_special.gammaln(0.5 * df)
            - 0.5 * jnp.log(df * jnp.pi)
            - jnp.log(scale)
            - half * jnp.log1p(z * z / df)
        )

    @property
    def mean(self):
        df, loc, _ = promote_to_result_dtype(self.df, self.loc, self.scale)
        return jnp.where(df > 1, loc, jnp.nan)

    @property
    def variance(self):
        df, _, scale = promote_to_result_dtype(self.df, self.loc, self.scale)
        return jnp.where(df > 2, scale * scale * df / (df - 2.0), jnp.nan)


@dist_dataclass
class Cauchy(Distribution):
    loc: jax.Array
    scale: jax.Array

    def sample(self, key, sample_shape=()):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        shape = sample_shape + jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(scale))
        return loc + scale * jax.random.cauchy(key, shape, dtype=loc.dtype)

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        z = (x - loc) / scale
        return -jnp.log(jnp.pi * scale * (1.0 + z * z))

    def cdf(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = jnp.asarray(x, loc.dtype)
        return 0.5 + jnp.arctan((x - loc) / scale) / jnp.pi

    def icdf(self, u):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        return loc + scale * jnp.tan(jnp.pi * (jnp.asarray(u, loc.dtype) - 0.5))


@dist_dataclass
class MinMaxContinuous(Distribution):
    """Beta distribution reparameterized by (min, max, mode, certainty) —
    counterpart of the reference's (deprecated) ``min_max_continuous_distribution``
    (``min_max_continuous.hpp``): alpha = mode_01*(k-2)+1, beta = (1-mode_01)*(k-2)+1,
    scaled from [0,1] to [min,max]."""

    low: jax.Array
    high: jax.Array
    mode: jax.Array
    certainty: jax.Array  # k > 2

    def _ab(self):
        low, high, mode, k = promote_to_result_dtype(self.low, self.high, self.mode, self.certainty)
        m01 = (mode - low) / (high - low)
        alpha = m01 * (k - 2.0) + 1.0
        beta = (1.0 - m01) * (k - 2.0) + 1.0
        return low, high, alpha, beta

    def sample(self, key, sample_shape=()):
        low, high, alpha, beta = self._ab()
        shape = sample_shape + jnp.broadcast_shapes(jnp.shape(alpha), jnp.shape(beta))
        x01 = jax.random.beta(key, alpha, beta, shape=shape, dtype=alpha.dtype)
        return low + (high - low) * x01

    def log_prob(self, x):
        low, high, alpha, beta = self._ab()
        x = jnp.asarray(x, alpha.dtype)
        x01 = (x - low) / (high - low)
        return jsp_beta.logpdf(x01, alpha, beta) - jnp.log(high - low)

    @property
    def mean(self):
        low, high, alpha, beta = self._ab()
        return low + (high - low) * alpha / (alpha + beta)
