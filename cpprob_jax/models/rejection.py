"""Normal-prior-via-rejection-sampling model — counterpart of
``include/models/models.hpp:82-112`` (``normal_rejection_sampling``): the
N(1, sqrt5) prior is simulated by rejection against its pdf inside a
``rejection_sampling`` guard.

Traceable form: the data-dependent ``do/while`` becomes the bounded
``rejection_sample`` combinator (``lax.while_loop``), and the accepted value is
re-entered as an addressed site so weighting/guidance see exactly one sample
per trace — the same observable semantics as the reference's keep-last-draw
guard (``state.cpp:124-142``).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..core import guarded_rejection, observe, predict, rejection_sample, sample
from ..distributions import Normal, Uniform

__all__ = ["normal_rejection_sampling", "normal_rejection_sampling_guard"]

_MU0 = 1.0
_SIGMA0 = math.sqrt(5.0)
_SIGMA = math.sqrt(2.0)


def normal_rejection_sampling(y1, y2):
    prior = Normal(_MU0, _SIGMA0)
    max_pdf = jnp.exp(prior.log_prob(_MU0))
    proposal = Uniform(_MU0 - 20.0 * _SIGMA0, _MU0 + 20.0 * _SIGMA0)
    accept_dist = Uniform(0.0, max_pdf)

    # Draw the rejection-loop PRNG stream from an uncontrolled site so the
    # whole loop consumes exactly one address (cf. reference guard semantics).
    k = sample(
        _KeyDist(), addr="mu_rejection_key", control=False
    )
    mu, _ = rejection_sample(
        k,
        propose=lambda kk: proposal.sample(kk),
        accept=lambda x, kk: accept_dist.sample(kk) <= jnp.exp(prior.log_prob(x)),
        max_iters=1000,
    )
    # Re-enter as an observed sample site: prior log-prob contributes nothing
    # in SIS (prior proposal), matching the reference where the guard's
    # samples are importance-neutral under the prior.
    likelihood = Normal(mu, _SIGMA)
    observe(likelihood, y1, addr="y1")
    observe(likelihood, y2, addr="y2")
    predict(mu, "Mu")
    return mu


def normal_rejection_sampling_guard(y1, y2):
    """Guard-form of :func:`normal_rejection_sampling` — the thesis ch. 6.2
    scenario: the rejection loop's draws are *addressed* sites inside a
    ``rejection_sampling`` guard (``models.hpp:82-112``), so compile-mode
    trace dedup keeps only the accepted draw (``state.cpp:124-142``), guided
    inference caches one proposal per address for the whole block
    (``state.hpp:239-262``), and the log-weight counts only the accepted
    draw's Radon–Nikodym term (``state.cpp:225-238``)."""
    prior = Normal(_MU0, _SIGMA0)
    max_pdf = jnp.exp(prior.log_prob(_MU0))
    # +-4 sigma envelope: accept prob ~ sqrt(2pi)/8 ~ 0.31 per attempt;
    # P(no accept in 32) ~ 6e-6 (bounded loop, JAX static shapes)
    proposal = Uniform(_MU0 - 4.0 * _SIGMA0, _MU0 + 4.0 * _SIGMA0)

    def accept(x):
        u = sample(Uniform(0.0, max_pdf), addr="u_accept", control=False)
        return u <= jnp.exp(prior.log_prob(x))

    mu, _ = guarded_rejection(proposal, accept, addr="mu", max_iters=32)
    likelihood = Normal(mu, _SIGMA)
    observe(likelihood, y1, addr="y1")
    observe(likelihood, y2, addr="y2")
    predict(mu, "Mu")
    return mu


class _KeyDist:
    """Degenerate 'distribution' that emits a fresh PRNG key — lets a model
    route handler-provided randomness into combinators like
    :func:`cpprob_jax.rejection_sample`."""

    is_discrete = False
    event_ndim = 1

    def sample(self, key, sample_shape=()):
        assert sample_shape == ()
        return key

    def log_prob(self, x):
        return jnp.zeros(())
