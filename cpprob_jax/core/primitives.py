"""The four primitive statements — the public model-writing API, matching the
reference's ``cpprob::sample`` / ``observe`` / ``predict`` / ``metaobserve``
(``include/cpprob/cpprob.hpp:28-114``) plus the ``rejection_sampling`` guard
(``cpprob.hpp:116-125``) and a bounded, traceable rejection-sampling combinator.

Models are plain Python functions calling these primitives; handled executions
are pure JAX functions (see :mod:`cpprob_jax.core.handlers`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from . import handlers
from .handlers import apply_stack, new_message

__all__ = [
    "sample",
    "observe",
    "predict",
    "factor",
    "metaobserve",
    "rejection_sampling",
    "rejection_sample",
    "guarded_rejection",
]


def sample(dist, *, addr: Optional[str] = None, control: bool = True, obs=None,
           postselect=None):
    """Draw a random value from ``dist`` at address ``addr``.

    ``control=False`` marks the site as not-to-be-guided: CSIS proposal
    messengers skip it and always use the prior (``cpprob.hpp:28-35``).
    ``obs`` conditions the site on a value (counterpart of substituting an
    observed sample site).
    ``postselect=(done, kept)`` freezes the site at ``kept`` once the traced
    bool ``done`` is set — used by :func:`guarded_rejection` to emulate
    rejection-loop exit under static shapes (the recorded value and any
    Radon–Nikodym weight are computed at the selected value).
    """
    if not handlers.current_stack():
        raise RuntimeError(
            "cpprob_jax.sample called outside any handler; wrap the model call "
            "in handlers.Seed(key) or use an inference engine"
        )
    msg = new_message(
        "sample", addr, dist=dist, value=obs, control=control,
        is_observed=obs is not None, postselect=postselect,
    )
    return apply_stack(msg)["value"]


def observe(dist, value, *, addr: Optional[str] = None):
    """Condition on ``value`` under likelihood ``dist``: accumulates
    ``log_prob(value)`` into the execution's log-weight
    (``cpprob.hpp:79-90``).  In compile mode (``SimulateObserves`` handler) the
    value is ignored and the observation simulated instead."""
    if not handlers.current_stack():
        return value
    msg = new_message("observe", addr, dist=dist, value=value, is_observed=True)
    return apply_stack(msg)["value"]


def predict(value, addr: Optional[str] = None):
    """Emit a posterior quantity of interest (``cpprob.hpp:92-106``)."""
    if not handlers.current_stack():
        return value
    msg = new_message("predict", addr, value=value)
    return apply_stack(msg)["value"]


def factor(log_factor, addr: Optional[str] = None):
    """Add an arbitrary term to the execution log-weight (likelihood-free /
    soft-constraint weighting; generalizes the reference's ABC observe)."""
    if not handlers.current_stack():
        return
    msg = new_message("factor", addr, value=jnp.asarray(log_factor))
    apply_stack(msg)


def metaobserve(dist, value, *, addr: Optional[str] = None):
    """Observe of a metaprior-drawn model argument (``cpprob.hpp:108-114``):
    simulated like an observe in compile mode (so trace generation draws the
    argument), but contributes **nothing** to the inference log-weight — the
    reference's metaobserve is a no-op outside compile mode."""
    if not handlers.current_stack():
        return value
    msg = new_message("metaobserve", addr, dist=dist, value=value, is_observed=True)
    return apply_stack(msg)["value"]


@contextlib.contextmanager
def rejection_sampling():
    """RAII-style guard: sample sites inside contribute only their *last*
    occurrence per address to the log-weight, and CSIS proposal caches are
    keyed per address within the block (``cpprob.hpp:116-125``,
    ``state.cpp:124-142,225-238``)."""
    with handlers.RejectionGuard():
        yield


def rejection_sample(
    key: jax.Array,
    propose: Callable[[jax.Array], Any],
    accept: Callable[[Any, jax.Array], jax.Array],
    max_iters: int = 10_000,
):
    """Bounded rejection sampler (traceable: a fixed-trip vectorized loop).

    The reference's models write data-dependent ``do { .. } while`` loops
    (``models.hpp:82-112``); under ``jit`` that is a ``lax.while_loop`` with an
    iteration bound.  ``propose(key) -> x`` draws a candidate; ``accept(x, key)
    -> bool`` decides.  Returns ``(x, n_iters)``.  Runs *outside* the handler
    stack (draws do not create sites); wrap the accepted value in a
    ``sample(..., obs=x)`` site if it must be addressed/guided.
    """

    def cond(carry):
        _, _, ok, it = carry
        return jnp.logical_and(jnp.logical_not(ok), it < max_iters)

    def body(carry):
        k, _, _, it = carry
        k, k_prop, k_acc = jax.random.split(k, 3)
        x = propose(k_prop)
        ok = accept(x, k_acc)
        return k, x, ok, it + 1

    k0, k_prop, k_acc = jax.random.split(key, 3)
    x0 = propose(k_prop)
    ok0 = accept(x0, k_acc)
    _, x, _, iters = jax.lax.while_loop(cond, body, (k0, x0, ok0, jnp.int32(1)))
    return x, iters


def guarded_rejection(
    dist,
    accept: Callable[[Any], jax.Array],
    *,
    addr: str,
    max_iters: int = 16,
):
    """Rejection loop written with *addressed* guard sites — the traceable
    form of the reference's ``rejection_sampling { do {..} while }`` pattern
    (``models.hpp:82-112`` + guard dedup ``state.cpp:124-142``).

    Each attempt samples at the SAME address ``addr`` inside a
    :func:`rejection_sampling` guard; once ``accept(x)`` fires, subsequent
    attempts re-emit the accepted value (``postselect``), so the **last
    occurrence per address is the accepted draw**.  Consequences matching the
    reference:

    - compile mode: :class:`~cpprob_jax.core.handlers.TraceHandler` keeps only
      the last draw, so CSIS trains on the *accepted-draw* distribution;
    - inference: :class:`~cpprob_jax.core.handlers.LogWeight` keeps only the
      last Radon–Nikodym term — the accepted draw's (``state.cpp:225-238``);
    - CSIS proposals are computed once per address and cached for the whole
      guard block (``state.hpp:239-262``).

    ``accept`` must be deterministic given ``x`` (stochastic acceptance draws
    go through their own ``control=False`` sites inside ``accept``).  Returns
    ``(value, accepted_mask)``; with probability ``(1-p)^max_iters`` no draw
    is accepted and the final raw draw is returned with ``accepted_mask``
    False (bounded loop — JAX static shapes).
    """
    done = jnp.zeros((), bool)
    kept = None
    with rejection_sampling():
        for _ in range(max_iters):
            if kept is None:
                x = sample(dist, addr=addr)
                kept = x
            else:
                x = sample(dist, addr=addr, postselect=(done, kept))
            ok = jnp.asarray(accept(x))
            kept = jnp.where(done, kept, jnp.where(ok, x, kept))
            done = jnp.logical_or(done, ok)
    return jnp.where(done, kept, x), done
