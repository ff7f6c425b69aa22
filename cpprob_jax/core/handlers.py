"""Effect-handler substrate — the vectorized replacement of the reference's
global mode state machine (``include/cpprob/state.hpp``: ``StateType {compile,
csis, sis, dryrun}`` + static ``State``/``StateCompile``/``StateInfer``).

Instead of one global mutable mode, the primitives (:func:`cpprob_jax.sample`,
:func:`cpprob_jax.observe`, :func:`cpprob_jax.predict`, :func:`cpprob_jax.factor`)
dispatch through a stack of *messengers* installed as context managers.  All
messenger work happens at Python trace time, so a handled model is a **pure JAX
function** that can be jitted, vmapped over particles, differentiated, and
sharded over a device mesh.  The four reference modes are compositions:

- ``sis``     = ``Seed`` + ``LogWeight`` + ``PredictCollector``
- ``compile`` = ``Seed`` + ``SimulateObserves`` + ``TraceHandler``
- ``csis``    = ``sis`` + a proposal messenger (:mod:`cpprob_jax.inference.csis`)
- ``dryrun``  = ``Seed`` alone (effects disabled)

Messages carry traced arrays; messengers never hold cross-call state that a
jitted function would close over incorrectly (each handled execution builds a
fresh handler instance).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "Messenger",
    "Seed",
    "TraceHandler",
    "Substitute",
    "Replay",
    "LogWeight",
    "LogJoint",
    "PredictCollector",
    "SimulateObserves",
    "RejectionGuard",
    "Scope",
    "Mask",
    "apply_stack",
    "current_stack",
]

_STACK: List["Messenger"] = []


def current_stack() -> List["Messenger"]:
    return _STACK


class Messenger:
    """Base effect handler.  Subclasses override ``process_message`` (runs
    innermost-first, before the site's default behavior) and/or
    ``postprocess_message`` (runs outermost-first, after)."""

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        popped = _STACK.pop()
        assert popped is self, "handler stack corrupted"
        return False

    def process_message(self, msg: Dict[str, Any]) -> None:
        pass

    def postprocess_message(self, msg: Dict[str, Any]) -> None:
        pass


def new_message(mtype: str, name: Optional[str], dist=None, value=None, **kw) -> Dict[str, Any]:
    msg = {
        "type": mtype,          # 'sample' | 'observe' | 'predict' | 'factor'
        "name": name,           # address string (None => auto-named by Seed/Scope)
        "dist": dist,
        "value": value,
        "key": None,            # PRNG key provided by Seed
        "control": True,        # reference's `control` flag (cpprob.hpp:28-35)
        "is_observed": False,
        "log_weight": None,     # importance-weight increment for this site
        "proposal_dist": None,  # set by guided (CSIS) messengers
        "rejection": False,     # inside a rejection_sampling guard
        "postselect": None,     # (done_flag, kept_value): freeze the site's
                                # value once a rejection loop has accepted —
                                # the static-shape emulation of loop exit
        "mask": None,           # multiplicative mask on weight contributions
        "stop": False,
        "done": False,
    }
    msg.update(kw)
    return msg


def apply_stack(msg: Dict[str, Any]) -> Dict[str, Any]:
    """Run a site message through the handler stack.

    process_message: innermost (most recently entered) → outermost, until a
    handler sets ``stop``; then the site's default behavior; then
    postprocess_message over the handlers already visited, outermost-last.
    """
    stack = _STACK
    pointer = 0
    for pointer, handler in enumerate(reversed(stack)):
        handler.process_message(msg)
        if msg["stop"]:
            break

    default_process(msg)

    for handler in stack[len(stack) - pointer - 1:]:
        handler.postprocess_message(msg)
    return msg


def default_process(msg: Dict[str, Any]) -> None:
    """Default site behavior once all handlers ran.

    sample:  draw from the proposal distribution if a guided messenger
             installed one (accumulating the Radon–Nikodym correction,
             cf. ``cpprob.hpp:43-56``), else from the prior.
    observe: weight increment = log p(x) (cf. ``cpprob.hpp:87-89``).
    factor:  weight increment = value.
    """
    if msg["done"]:
        return
    mtype = msg["type"]
    if mtype == "sample":
        dist = msg["dist"]
        if msg["value"] is None:
            proposal = msg["proposal_dist"]
            if msg["key"] is None:
                raise RuntimeError(
                    f"sample site {msg['name']!r} needs a PRNG key: wrap the "
                    "model in cpprob_jax.handlers.Seed(key)"
                )
            x = (proposal if proposal is not None else dist).sample(msg["key"])
            if msg["postselect"] is not None:
                # rejection-loop exit emulation: once `done`, the site keeps
                # re-emitting the accepted value, so the LAST occurrence per
                # address is the accepted draw — the reference's keep-last
                # dedup (state.cpp:124-142) under static shapes.
                done, kept = msg["postselect"]
                x = jnp.where(done, kept, x)
            msg["value"] = x
            if proposal is not None:
                msg["log_weight"] = dist.log_prob(x) - proposal.log_prob(x)
        elif msg["proposal_dist"] is not None and msg["log_weight"] is None:
            x = msg["value"]
            msg["log_weight"] = dist.log_prob(x) - msg["proposal_dist"].log_prob(x)
        elif msg["is_observed"] and msg["log_weight"] is None:
            # conditioned sample site: likelihood contribution
            msg["log_weight"] = dist.log_prob(msg["value"])
    elif mtype in ("observe", "metaobserve"):
        if msg["value"] is None:
            # SimulateObserves cleared the value (compile mode): draw it.
            if msg["key"] is None:
                raise RuntimeError(
                    f"observe site {msg['name']!r} simulation needs a PRNG key"
                )
            msg["value"] = msg["dist"].sample(msg["key"])
            msg["log_weight"] = None
        elif mtype == "observe":
            msg["log_weight"] = msg["dist"].log_prob(msg["value"])
        # metaobserve: no weight contribution outside compile mode
        # (cpprob.hpp:108-114 — it only records/simulates during compile)
    elif mtype == "factor":
        msg["log_weight"] = msg["value"]
    msg["done"] = True


# ---------------------------------------------------------------------------
# Concrete messengers
# ---------------------------------------------------------------------------


class Seed(Messenger):
    """Provides per-site PRNG keys, replacing the reference's single global
    ``std::mt19937`` (``utils.cpp:16-20``).  Each site gets
    ``fold_in(base_key, site_index)`` — deterministic, order-stable, and
    parallel-safe under ``vmap`` over base keys.  Also performs auto-naming of
    anonymous sites (the traceable stand-in for the backtrace addresses of
    ``utils.cpp:71-128``: addresses must be static under ``jit``)."""

    def __init__(self, key: jax.Array):
        self.key = key
        self._count = 0
        self._name_counts: Dict[str, int] = collections.Counter()

    def _next_key(self):
        k = jax.random.fold_in(self.key, self._count)
        self._count += 1
        return k

    def process_message(self, msg):
        if msg["name"] is None:
            base = msg["type"]
            if msg["dist"] is not None:
                base = f"{msg['type']}/{type(msg['dist']).__name__}"
            n = self._name_counts[base]
            self._name_counts[base] += 1
            msg["name"] = f"{base}#{n}"
        if msg["type"] in ("sample", "observe", "metaobserve") and msg["key"] is None:
            msg["key"] = self._next_key()


class Scope(Messenger):
    """Prefix site addresses — the structured replacement of the reference's
    call-path addresses: nested scopes reproduce 'address = path through the
    program' without backtraces."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def process_message(self, msg):
        if msg["name"] is not None and not msg.get("_scoped_" + self.prefix, False):
            msg["name"] = f"{self.prefix}/{msg['name']}"
            msg["_scoped_" + self.prefix] = True


class TraceHandler(Messenger):
    """Records every site — counterpart of ``TraceCompile``/``TraceInfer``
    (``trace.hpp``).  ``trace`` maps address → message dict."""

    def __init__(self):
        self.trace: "collections.OrderedDict[str, Dict[str, Any]]" = collections.OrderedDict()

    def postprocess_message(self, msg):
        if msg["type"] in ("sample", "observe", "metaobserve"):
            name = msg["name"]
            if name in self.trace:
                if msg["rejection"]:
                    # inside a rejection guard: keep only the LAST draw per
                    # address — compile-mode dedup exactly as the reference's
                    # StateCompile guard exit (state.cpp:124-142); combined
                    # with `postselect` loop-exit freezing this records the
                    # accepted draw for NN training
                    self.trace[name] = dict(msg)
                    return
                # repeated address (loops without scoping): suffix occurrence
                i = 1
                while f"{name}@{i}" in self.trace:
                    i += 1
                name = f"{name}@{i}"
            self.trace[name] = dict(msg)


class Substitute(Messenger):
    """Fix values at sample sites (by address) — used to build potential
    functions for HMC/NUTS/SVI and for replaying traces."""

    def __init__(self, data: Dict[str, Any]):
        self.data = data

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["name"] in self.data and msg["value"] is None:
            msg["value"] = self.data[msg["name"]]


class Replay(Messenger):
    """Replay sample values from a recorded trace.  Repeated addresses are
    matched by occurrence order (TraceHandler stores them as ``name``,
    ``name@1``, ``name@2``, ...)."""

    def __init__(self, trace):
        self.trace = trace
        self._counts: Dict[str, int] = collections.Counter()

    def process_message(self, msg):
        if msg["type"] != "sample" or msg["value"] is not None:
            return
        name = msg["name"]
        if name is None:
            return
        i = self._counts[name]
        self._counts[name] += 1
        key = name if i == 0 else f"{name}@{i}"
        if key in self.trace:
            msg["value"] = self.trace[key]["value"]


class LogWeight(Messenger):
    """Accumulates the importance log-weight of one model execution —
    counterpart of ``StateInfer::increment_log_prob`` + ``TraceInfer::log_w_``
    (``state.cpp:212-223``).

    Contributions: observe-site log-probs, factor sites, and Radon–Nikodym
    terms from guided sample sites.  Sites inside a ``rejection_sampling``
    guard contribute *only their last occurrence per address*, matching the
    reference's dedup map (``state.cpp:225-238``).
    """

    def __init__(self):
        self._terms: List[jax.Array] = []
        self._rejection_terms: Dict[str, jax.Array] = {}

    def postprocess_message(self, msg):
        lw = msg["log_weight"]
        if lw is None:
            return
        if msg["mask"] is not None:
            lw = lw * msg["mask"]
        lw = jnp.sum(jnp.asarray(lw))
        if msg["rejection"] and msg["type"] == "sample":
            self._rejection_terms[msg["name"]] = lw  # keep-last semantics
        else:
            self._terms.append(lw)

    @property
    def log_weight(self) -> jax.Array:
        terms = self._terms + list(self._rejection_terms.values())
        if not terms:
            return jnp.zeros(())
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        return total


class LogJoint(LogWeight):
    """Like :class:`LogWeight` but also adds the *prior* log-prob of every
    (unguided, unobserved) sample site — yields the joint density used as the
    HMC/NUTS/SVI potential."""

    def postprocess_message(self, msg):
        if (
            msg["type"] == "sample"
            and msg["log_weight"] is None
            and msg["proposal_dist"] is None
            and msg["value"] is not None
        ):
            msg = dict(msg)
            msg["log_weight"] = msg["dist"].log_prob(msg["value"])
        super().postprocess_message(msg)


class PredictCollector(Messenger):
    """Collects ``predict`` sites — counterpart of ``TraceInfer``'s typed
    predict lists + address→id registry (``trace.hpp:37-62``).  Repeated
    predicts at one address (e.g. the HMM's per-step "State") are stacked in
    call order."""

    def __init__(self):
        self.predicts: "collections.OrderedDict[str, List[Any]]" = collections.OrderedDict()

    def postprocess_message(self, msg):
        if msg["type"] == "predict":
            self.predicts.setdefault(msg["name"], []).append(msg["value"])

    def stacked(self) -> Dict[str, jax.Array]:
        out = {}
        for name, vals in self.predicts.items():
            if len(vals) == 1:
                out[name] = jnp.asarray(vals[0])
                continue
            arrs = [jnp.asarray(v) for v in vals]
            if len({a.shape for a in arrs}) == 1:
                out[name] = jnp.stack(arrs)
            else:
                # mixed per-site scalars and scan-stacked (k, ...) blocks
                # (scan_sites fast path): concatenate on the leading axis
                nd = max(a.ndim for a in arrs)
                out[name] = jnp.concatenate(
                    [a if a.ndim == nd else a[None] for a in arrs], axis=0
                )
        return out


class SimulateObserves(Messenger):
    """Compile-mode behavior: ``observe(d, x)`` ignores ``x`` and *simulates*
    the observation by drawing from ``d`` (``cpprob.hpp:83-85`` →
    ``StateCompile::add_observe(distr(rng))``)."""

    def process_message(self, msg):
        if msg["type"] in ("observe", "metaobserve"):
            msg["value"] = None  # force a draw in default_process


class RejectionGuard(Messenger):
    """Marks sites as inside a rejection-sampling block — counterpart of the
    RAII ``cpprob::rejection_sampling`` guard (``cpprob.hpp:116-125``).
    Downstream, :class:`LogWeight` keeps only the last contribution per
    address and :class:`TraceHandler` consumers may dedup similarly
    (``state.cpp:124-142``)."""

    def process_message(self, msg):
        if msg["type"] == "sample":
            msg["rejection"] = True


class Mask(Messenger):
    """Multiplies weight contributions by a (possibly traced, 0/1) mask —
    the substrate for bounded-iteration variable-structure models where
    inactive steps must not contribute (JAX static shapes)."""

    def __init__(self, mask):
        self.mask = mask

    def process_message(self, msg):
        if msg["mask"] is None:
            msg["mask"] = self.mask
        else:
            msg["mask"] = msg["mask"] * self.mask
