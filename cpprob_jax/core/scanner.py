"""Effect-aware ``scan`` over model sites — the compiled answer to long traces.

The reference's models write Python loops over sample statements; under jit
that unrolls to O(T) program size, and guided (CSIS) inference then compiles
O(T) LSTM steps (reference analogue: one RequestProposal RPC per site,
``state.hpp:236-280``).  :func:`scan_sites` lets a model express the loop as
a ``lax.scan`` whose body contains primitive statements:

- **fast path** (stack is Seed / LogWeight / PredictCollector / Scope /
  scan-aware messengers like the CSIS proposal messenger): the body is traced
  ONCE inside ``lax.scan``; per-iteration PRNG keys, log-weight increments,
  predict values, and messenger state (LSTM hidden, value embedding) thread
  through the scan carry.  Program size — and guided-SIS compile time — is
  O(#site groups), not O(T).
- **fallback** (any other handler installed — TraceHandler,
  SimulateObserves, Replay, ...): the loop unrolls in Python with concrete
  loop indices in the addresses (``z[1]``, ``z[2]``, ...), preserving full
  handler generality.  Structure discovery and compile-mode trace generation
  take this path, so a scan-form model has exactly the same trace addresses
  as its unrolled twin.

Addresses inside the body use the ``idx`` placeholder:
``sample(d, addr=f"z[{idx}]")`` — ``idx`` formats as the concrete index in
the fallback and as ``*`` in the fast path (where the site is shared across
iterations; proposal identity is carried by the messenger's scan state,
matching training-side address tying, ``inference/csis.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from . import handlers
from .handlers import LogWeight, Messenger, PredictCollector, Scope, Seed

__all__ = ["scan_sites", "SiteIndex"]


class SiteIndex:
    """Loop-index placeholder for site addresses inside ``scan_sites`` bodies:
    formats as the concrete index in the unrolled fallback, and as ``*`` in
    the scan fast path (tied addresses)."""

    __slots__ = ("value",)

    def __init__(self, value: Optional[int] = None):
        self.value = value

    def __str__(self):
        return "*" if self.value is None else str(self.value)

    def __format__(self, spec):
        return format(str(self), spec)

    def __repr__(self):
        return f"SiteIndex({self.value})"


def _classify(stack, length):
    """Partition the active handler stack for the fast path; None => fallback."""
    seed = None
    passthrough = []   # stateless messengers included verbatim (Scope)
    lw_handlers = []   # LogWeight (and subclasses) — accumulated via carry
    pc_handlers = []   # PredictCollector — collected via scan ys
    adapted = []       # (handler, adapter) for scan-aware messengers
    for h in stack:
        if isinstance(h, Seed):
            seed = h  # innermost Seed wins (matches per-site key semantics)
        elif isinstance(h, Scope):
            passthrough.append(h)
        elif isinstance(h, LogWeight):  # includes LogJoint
            lw_handlers.append(h)
        elif isinstance(h, PredictCollector):
            pc_handlers.append(h)
        else:
            make = getattr(h, "scan_adapter", None)
            ad = make(length) if make is not None else None
            if ad is None:
                return None
            adapted.append((h, ad))
    if seed is None:
        return None
    return seed, passthrough, lw_handlers, pc_handlers, adapted


def scan_sites(
    body: Callable,
    init: Any,
    xs: Any,
    *,
    length: Optional[int] = None,
    index_offset: int = 0,
):
    """Run ``body(carry, x, idx) -> (carry, out)`` over the leading axis of
    ``xs``, with primitive statements allowed inside the body.

    Returns ``(final_carry, stacked_outs)`` (outs stacked over iterations, or
    None if the body returns None).
    """
    if length is None:
        leaves = jax.tree_util.tree_leaves(xs)
        if not leaves:
            raise ValueError("scan_sites needs xs or an explicit length")
        length = leaves[0].shape[0]

    stack = handlers.current_stack()
    classified = _classify(stack, length)

    if classified is None:
        # ---- unrolled fallback: full handler generality ----
        carry = init
        outs = []
        for t in range(length):
            x_t = jax.tree_util.tree_map(lambda a: a[t], xs)
            carry, out = body(carry, x_t, SiteIndex(t + index_offset))
            outs.append(out)
        if outs and outs[0] is not None:
            outs = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *outs)
        else:
            outs = None
        return carry, outs

    seed, passthrough, lw_handlers, pc_handlers, adapted = classified
    base_key = seed._next_key()
    lw_types = [type(h) for h in lw_handlers]

    def step(scan_carry, x_and_t):
        x_t, t = x_and_t
        user_carry, lw_accs, ad_states = scan_carry
        inner_lws = [cls() for cls in lw_types]
        inner_pc = PredictCollector()
        step_msgrs = [
            ad.make(st) for (h, ad), st in zip(adapted, ad_states)
        ]
        inner = (
            [Seed(jax.random.fold_in(base_key, t))]
            + list(passthrough)
            + inner_lws
            + [inner_pc]
            + step_msgrs
        )
        saved = handlers._STACK[:]
        handlers._STACK[:] = inner
        try:
            new_carry, out = body(user_carry, x_t, SiteIndex(None))
        finally:
            handlers._STACK[:] = saved
        new_lw_accs = tuple(
            acc + lw.log_weight for acc, lw in zip(lw_accs, inner_lws)
        )
        new_states = tuple(
            ad.extract(m) for (h, ad), m in zip(adapted, step_msgrs)
        )
        preds = {
            name: (vals[0] if len(vals) == 1
                   else jnp.stack([jnp.asarray(v) for v in vals]))
            for name, vals in inner_pc.predicts.items()
        }
        return (new_carry, new_lw_accs, new_states), (out, preds)

    carry0 = (
        init,
        tuple(jnp.zeros(()) for _ in lw_handlers),
        tuple(ad.init for h, ad in adapted),
    )
    ts = jnp.arange(length, dtype=jnp.int32)
    (final_carry, lw_totals, final_states), (outs, preds) = jax.lax.scan(
        step, carry0, (xs, ts)
    )

    for h, total in zip(lw_handlers, lw_totals):
        h._terms.append(total)
    for h in pc_handlers:
        for name, arr in preds.items():
            h.predicts.setdefault(name, []).append(arr)
    for (h, ad), st in zip(adapted, final_states):
        ad.commit(st)

    if outs is None or (
        isinstance(outs, tuple) and len(outs) == 0
    ):
        outs = None
    return final_carry, outs
