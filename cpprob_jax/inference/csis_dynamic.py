"""Dynamic-structure CSIS: trace bucketing by address sequence.

The reference groups training traces into *subbatches* by a hash of their
address sequence so models with data-dependent structure (rejection loops,
random trace lengths) can train one shared network with per-address modules
(``infcomp/data_structures.py:32-41``, ``nn.py:93-128``).  This module is the
counterpart for models whose structure genuinely varies at Python level.

Design: *truly* dynamic Python control flow (``while`` on sampled
values) cannot be traced under ``jit``/``vmap`` at all, so

- **trace generation** runs host-side and eagerly, one trace at a time — the
  same execution model as the reference's C++ simulator loop (§3.2);
- traces accumulate in **buckets keyed by their address-sequence signature**;
  a full bucket triggers one *jitted* optimizer step specialized to that
  structure (one compiled program per structure, compile-cache-friendly —
  SURVEY.md §7 'subbatch trick');
- parameters are **keyed by address** and shared across buckets, exactly like
  the reference's per-address module table;
- **guided inference** uses an address-keyed messenger (head lookup by the
  address in the message, not by position — the reference's per-address
  dispatch) running eagerly per particle, with the reference's
  ``Distribution::NONE`` prior fallback for unseen addresses
  (``cpprob.hpp:52-56``).

Models whose dynamism is *bounded* should instead be written in static-max +
mask form (see ``models/poly.py``, ``core.rejection_sample``) and use the
vectorized :class:`~cpprob_jax.inference.csis.CSIS` — that is the fast path;
this module is the completeness path for everything else.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core import handlers
from .csis import (
    CSISProposalMessenger,
    ModelStructure,
    SiteSpec,
    _embed_value,
    _site_spec_from_dist,
    csis_loss,
    embed_observation,
    init_csis_params,
    make_proposal_dist,
)
from . import nn
from .sis import ImportanceResult

__all__ = ["DynamicCSIS", "DynamicProposalMessenger", "sis_host"]


def _trace_signature(sites: Tuple[SiteSpec, ...]) -> Tuple:
    return tuple(
        (s.addr, s.kind, s.meta, s.value_dim, s.discrete_k, s.n_out)
        for s in sites
    )


class DynamicProposalMessenger(handlers.Messenger):
    """Address-keyed guided proposals: the head for each sample site is looked
    up by the site's address (reference's per-address module dispatch,
    ``nn.py:191-207``); unknown addresses fall back to the prior with zero
    Radon-Nikodym correction (``Distribution::NONE``, ``cpprob.hpp:52-56``).

    Unlike :class:`CSISProposalMessenger` there is no expected site order —
    any address sequence the model takes at run time is guided for exactly
    the sites the network knows."""

    def __init__(self, params, spec_table: Dict[str, SiteSpec],
                 obs_emb: jax.Array):
        self.params = params
        self.spec_table = spec_table
        self.obs_emb = obs_emb
        self.obs_gate = nn.lstm_obs_gate(params["lstm"], obs_emb)
        E = params["lstm"][0]["wh"].shape[0]
        self.state = nn.lstm_zero_state(params["lstm"])
        self.prev_emb = jnp.zeros((E,))
        self._rejection_cache: Dict[str, Any] = {}

    def process_message(self, msg):
        if msg["type"] != "sample" or not msg["control"] or msg["is_observed"]:
            return
        if msg["value"] is not None or msg["proposal_dist"] is not None:
            return
        if msg["rejection"] and msg["name"] in self._rejection_cache:
            msg["proposal_dist"] = self._rejection_cache[msg["name"]]
            return
        spec = self.spec_table.get(msg["name"])
        if spec is None or spec.pkey not in self.params["heads"]:
            return  # prior fallback
        h, self.state = nn.lstm_step_split(
            self.params["lstm"], self.prev_emb, self.obs_gate, self.state
        )
        raw = nn.mlp_apply(self.params["heads"][spec.pkey], h)
        proposal = make_proposal_dist(spec, raw)
        msg["proposal_dist"] = proposal
        if msg["rejection"]:
            self._rejection_cache[msg["name"]] = proposal
        msg["_csis_spec"] = spec

    def postprocess_message(self, msg):
        spec = msg.pop("_csis_spec", None)
        if spec is not None:
            self.prev_emb = _embed_value(self.params, spec, msg["value"])


def sis_host(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key: jax.Array,
    proposal_messenger: Optional[Callable[[], Any]] = None,
) -> ImportanceResult:
    """Serial host-side SIS for models ``vmap`` cannot trace (Python control
    flow on sampled values) — the reference's execution model
    (``cpprob.hpp:194-201``), kept for completeness.  Predicts with varying
    shapes across particles are returned per-occurrence-padded."""
    keys = jax.random.split(key, n_particles)
    log_ws: List[float] = []
    predicts: Dict[str, List] = {}
    for i in range(n_particles):
        lw = handlers.LogWeight()
        pc = handlers.PredictCollector()
        ctxs = [handlers.Seed(keys[i]), lw, pc]
        if proposal_messenger is not None:
            ctxs.append(proposal_messenger())
        with _nested(ctxs):
            model(*args)
        log_ws.append(float(lw.log_weight))
        for name, vals in pc.stacked().items():
            predicts.setdefault(name, []).append(np.asarray(vals))
    out: Dict[str, jax.Array] = {}
    for name, rows in predicts.items():
        if len(rows) != n_particles:
            continue  # predict absent in some traces: skip (dynamic structure)
        shapes = {r.shape for r in rows}
        if len(shapes) == 1:
            out[name] = jnp.asarray(np.stack(rows))
    return ImportanceResult(jnp.asarray(np.asarray(log_ws, np.float32)), out)


class _nested:
    def __init__(self, ctxs):
        self.ctxs = ctxs

    def __enter__(self):
        for c in self.ctxs:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.ctxs):
            c.__exit__(*exc)
        return False


class DynamicCSIS:
    """Inference compilation for dynamic-structure models via trace bucketing.

    >>> engine = DynamicCSIS(model, args_template)
    >>> params, stats = engine.compile(jax.random.key(0), n_traces=20_000)
    >>> res = engine.infer(params, observed_args, 1_000, jax.random.key(1))
    """

    def __init__(
        self,
        model: Callable,
        args_template: Tuple,
        embedding_dim: int = nn.EMBEDDING_DIM,
        obs_embedding: str = "fc",
        bucket_batch: int = 64,
        probe: int = 128,
        probe_key: Optional[jax.Array] = None,
    ):
        self.model = model
        self.args_template = args_template
        self.embedding_dim = embedding_dim
        self.obs_embedding = obs_embedding
        self.bucket_batch = bucket_batch
        # spec table: union of sites over probed structures, keyed by address
        self.spec_table: Dict[str, SiteSpec] = {}
        self.obs_dim = 0
        self._loss_cache: Dict[Tuple, Callable] = {}
        self._probe(probe_key or jax.random.key(0), probe)

    # -- trace generation (host-side, eager; reference §3.2) ---------------

    def _trace_once(self, key):
        tr = handlers.TraceHandler()
        with _nested([handlers.Seed(key), handlers.SimulateObserves(), tr]):
            self.model(*self.args_template)
        sites: List[SiteSpec] = []
        values: Dict[str, np.ndarray] = {}
        obs_parts: List[np.ndarray] = []
        for name, site in tr.trace.items():
            if (
                site["type"] == "sample"
                and site["control"]
                and not site["is_observed"]
            ):
                spec = _site_spec_from_dist(name, site["dist"])
                if spec is not None:
                    sites.append(spec)
                    values[name] = np.asarray(site["value"])
            elif site["type"] in ("observe", "metaobserve"):
                obs_parts.append(
                    np.ravel(np.asarray(site["value"], np.float32))
                )
        obs = (
            np.concatenate(obs_parts) if obs_parts else np.zeros((1,), np.float32)
        )
        return tuple(sites), values, obs

    def _probe(self, key, n):
        keys = jax.random.split(key, n)
        obs_dims = set()
        for i in range(n):
            sites, _, obs = self._trace_once(keys[i])
            obs_dims.add(obs.shape[0])
            for s in sites:
                prev = self.spec_table.get(s.addr)
                if prev is not None and _trace_signature((prev,)) != _trace_signature((s,)):
                    raise ValueError(
                        f"address {s.addr!r} maps to different families "
                        "across traces; cannot share a head"
                    )
                self.spec_table[s.addr] = s
        if len(obs_dims) != 1:
            raise ValueError(
                "observation size varies across traces "
                f"({sorted(obs_dims)}); pad observes to a fixed shape"
            )
        self.obs_dim = obs_dims.pop()

    def _union_structure(self) -> ModelStructure:
        return ModelStructure(
            tuple(self.spec_table.values()), (), self.obs_dim
        )

    def init(self, key: jax.Array):
        return init_csis_params(
            key, self._union_structure(), self.embedding_dim,
            self.obs_embedding,
        )

    # -- bucketed training (reference's subbatching, data_structures.py) ---

    def compile(
        self,
        key: jax.Array,
        n_traces: int = 10_000,
        learning_rate: float = 1e-3,
        params=None,
        log_fn=None,
        saver=None,
    ):
        """Generate ``n_traces`` prior traces host-side, bucket them by
        address-sequence signature, and run one jitted optimizer step per
        full bucket (parameters shared across buckets by address).

        Returns ``(params, stats)`` with per-bucket counts and losses.
        Leftover partial buckets at the end are trained once with their
        actual size (one extra compile each).  ``saver``: periodic_saver
        called per trained bucket; Ctrl-C returns the partial params
        (reference ``train.py:47-53``)."""
        key, k_init = jax.random.split(key)
        if params is None:
            params = self.init(k_init)
        opt = optax.adam(learning_rate)
        opt_state = opt.init(params)

        buckets: Dict[Tuple, List] = {}
        counts: Dict[Tuple, int] = {}
        losses: List[float] = []

        def train_bucket(sig, rows):
            nonlocal params, opt_state
            sites = rows[0][0]
            structure = ModelStructure(sites, (), self.obs_dim)
            values = {
                s.addr: jnp.asarray(np.stack([r[1][s.addr] for r in rows]))
                for s in sites
            }
            obs = jnp.asarray(np.stack([r[2] for r in rows]))
            step = self._loss_cache.get((sig, len(rows)))
            if step is None:
                def _step(params, opt_state, values, obs,
                          structure=structure):
                    loss, grads = jax.value_and_grad(csis_loss)(
                        params, structure, values, obs, self.obs_embedding
                    )
                    updates, opt_state = opt.update(grads, opt_state)
                    return optax.apply_updates(params, updates), opt_state, loss
                step = jax.jit(_step)
                self._loss_cache[(sig, len(rows))] = step
            params, opt_state, loss = step(params, opt_state, values, obs)
            losses.append(float(loss))
            if log_fn is not None:
                log_fn(float(loss), len(rows))
            if saver is not None:
                saver.maybe_save(params, len(rows))

        keys = jax.random.split(key, n_traces)
        try:
            for i in range(n_traces):
                sites, values, obs = self._trace_once(keys[i])
                sig = _trace_signature(sites)
                buckets.setdefault(sig, []).append((sites, values, obs))
                counts[sig] = counts.get(sig, 0) + 1
                if len(buckets[sig]) >= self.bucket_batch:
                    train_bucket(sig, buckets.pop(sig))
            for sig, rows in list(buckets.items()):
                train_bucket(sig, rows)
        except KeyboardInterrupt:
            pass  # Ctrl-C-safe partial return
        stats = {
            "bucket_counts": {str(k[:2]): v for k, v in counts.items()},
            "n_buckets": len(counts),
            "losses": losses,
        }
        return params, stats

    # -- vectorized bucket training (device-side re-simulation) -------------

    _DISCRETE_KINDS = ("uniform_int", "categorical", "bernoulli", "poisson")

    def _pin_set(self, sites: Tuple[SiteSpec, ...], values) -> Dict[str, Any]:
        """Concrete values of the discrete (structure-driving) sites of one
        skeleton trace — Python control flow almost always branches on
        discrete draws (loop counts, branch flags, sizes)."""
        return {
            s.addr: np.asarray(values[s.addr])
            for s in sites
            if s.discrete_k > 0 or s.kind in self._DISCRETE_KINDS
        }

    def _make_vectorized_gen(self, sites: Tuple[SiteSpec, ...], pins):
        """jit(vmap) generator of fresh traces sharing a skeleton's control
        path: discrete sites substituted with the skeleton's concrete values
        (so Python flow stays concrete under vmap), everything else re-drawn
        from the conditional prior on device.  Composition = exact prior
        sampling; the pinned sites just have batch-level repetition.

        Raises (Tracer leak / concretization error) when the model branches
        on an *unpinned* site — caller falls back to host-eager generation.
        """
        free_addrs = [s.addr for s in sites if s.addr not in pins]
        model, args = self.model, self.args_template

        def one(k):
            tr = handlers.TraceHandler()
            with _nested([
                handlers.Seed(k), handlers.SimulateObserves(),
                handlers.Substitute(pins), tr,
            ]):
                model(*args)
            vals = {a: jnp.asarray(tr.trace[a]["value"]) for a in free_addrs}
            obs_parts = [
                jnp.ravel(jnp.asarray(site["value"], jnp.float32))
                for site in tr.trace.values()
                if site["type"] in ("observe", "metaobserve")
            ]
            obs = (
                jnp.concatenate(obs_parts)
                if obs_parts else jnp.zeros((1,), jnp.float32)
            )
            return vals, obs

        return jax.jit(lambda keys: jax.vmap(one)(keys))

    def compile_vectorized(
        self,
        key: jax.Array,
        n_traces: int = 10_000,
        batch_size: int = 64,
        learning_rate: float = 1e-3,
        params=None,
        log_fn=None,
    ):
        """Bucketed training with **device-side batch generation**: one host
        trace per batch discovers the structure (the skeleton); a cached
        jit(vmap) program then re-simulates ``batch_size`` fresh traces that
        share its control path (discrete sites pinned), and one jitted
        optimizer step trains on them.  Host work drops from O(n_traces)
        eager model executions to O(n_traces / batch_size).

        Falls back to the host-eager :meth:`compile` when the model's control
        flow depends on a continuous (unpinned) site — detected loudly at
        trace time, never silently wrong.

        Returns ``(params, stats)`` like :meth:`compile`, with
        ``stats['vectorized']`` flagging which path ran.
        """
        key, k_init = jax.random.split(key)
        if params is None:
            params = self.init(k_init)
        opt = optax.adam(learning_rate)
        opt_state = opt.init(params)

        gen_cache: Dict[Tuple, Callable] = {}
        step_cache: Dict[Tuple, Callable] = {}
        counts: Dict[Tuple, int] = {}
        losses: List[float] = []
        n_batches = max(1, n_traces // batch_size)

        keys = jax.random.split(key, 2 * n_batches).reshape(n_batches, 2)
        for b in range(n_batches):
            k_skel, k_batch = keys[b, 0], keys[b, 1]
            sites, values, _obs = self._trace_once(k_skel)
            sig = _trace_signature(sites)
            pins = self._pin_set(sites, values)
            gen_key = (sig, tuple(sorted(
                (a, v.tobytes()) for a, v in pins.items()
            )))
            gen = gen_cache.get(gen_key)
            if gen is None:
                try:
                    gen = self._make_vectorized_gen(sites, pins)
                    # force tracing now so flow-on-continuous models fail here
                    jax.eval_shape(gen, jax.random.split(k_batch, batch_size))
                except Exception:
                    if b == 0:
                        # model not vectorizable: host-eager completeness path
                        params, stats = self.compile(
                            key, n_traces=n_traces,
                            learning_rate=learning_rate, params=params,
                            log_fn=log_fn,
                        )
                        stats["vectorized"] = False
                        return params, stats
                    continue  # skip this structure, keep the fast path
                gen_cache[gen_key] = gen
            vals, obs = gen(jax.random.split(k_batch, batch_size))
            for a, v in pins.items():
                vals[a] = jnp.broadcast_to(
                    jnp.asarray(v), (batch_size,) + np.shape(v)
                )
            counts[sig] = counts.get(sig, 0) + batch_size

            structure = ModelStructure(sites, (), self.obs_dim)
            step = step_cache.get(sig)
            if step is None:
                def _step(params, opt_state, values, obs,
                          structure=structure):
                    loss, grads = jax.value_and_grad(csis_loss)(
                        params, structure, values, obs, self.obs_embedding
                    )
                    updates, opt_state = opt.update(grads, opt_state)
                    return optax.apply_updates(params, updates), opt_state, loss
                step = jax.jit(_step)
                step_cache[sig] = step
            params, opt_state, loss = step(params, opt_state, vals, obs)
            losses.append(float(loss))
            if log_fn is not None:
                log_fn(float(loss), batch_size)

        stats = {
            "bucket_counts": {str(k[:2]): v for k, v in counts.items()},
            "n_buckets": len(counts),
            "losses": losses,
            "vectorized": True,
        }
        return params, stats

    # -- guided inference ---------------------------------------------------

    def obs_vector(self, args: Tuple) -> jax.Array:
        tr = handlers.TraceHandler()
        with _nested([handlers.Seed(jax.random.key(0)), tr]):
            self.model(*args)
        parts = [
            np.ravel(np.asarray(site["value"], np.float32))
            for site in tr.trace.values()
            if site["type"] in ("observe", "metaobserve")
        ]
        return jnp.asarray(
            np.concatenate(parts) if parts else np.zeros((1,), np.float32)
        )

    def proposal_factory(self, params, args: Tuple):
        obs_emb = embed_observation(
            params, self.obs_vector(args), self.obs_embedding
        )
        spec_table = dict(self.spec_table)

        def factory():
            return DynamicProposalMessenger(params, spec_table, obs_emb)

        return factory

    def infer(
        self, params, args: Tuple, n_particles: int, key: jax.Array
    ) -> ImportanceResult:
        """Guided importance sampling, host-side serial particles (the only
        execution model possible for Python-dynamic structure — and the
        reference's own, ``cpprob.hpp:194-201``)."""
        return sis_host(
            self.model, args, n_particles, key,
            proposal_messenger=self.proposal_factory(params, args),
        )
