"""CSIS — inference compilation (Le, Baydin & Wood 2017), in JAX.

The reference splits CSIS across two processes: a C++ simulator and a PyTorch
LSTM talking FlatBuffers-over-ZeroMQ, with one synchronous RPC **per sample
statement** (``state.hpp:236-280``, ``socket.hpp:57-79``, SURVEY.md §3.2-3.4).
Here the whole pipeline is in-process and on-device:

- *compile* (training): prior traces are generated by ``vmap`` of the model
  under ``SimulateObserves`` — thousands of traces per jitted step instead of
  the reference's ~4-300 traces/s over the socket (thesis ch. 6.2);
- the proposal network (obs-embedding MLP + per-address value embeddings +
  2-layer LSTM + per-address proposal heads, mirroring ``infcomp/nn/nn.py``)
  is pure pytree params;
- *inference*: a messenger installs the network inside the particle program,
  so each sample site's proposal evaluation is a batched matmul over all
  particles on the MXU — the RequestProposal/ReplyProposal round-trip
  (``infcomp.fbs:161-168``) becomes three fused ops;
- unseen/mismatched addresses fall back to the prior proposal exactly like the
  reference's ``Distribution::NONE`` path (``cpprob.hpp:52-56``).

Static model structure (the address sequence) is discovered by running the
model once in compile mode — the compiled stand-in for the reference's
subbatch-by-address-sequence trick (``data_structures.py:32-41``): one
compiled program per structure.
"""

from __future__ import annotations

import dataclasses
import re
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core import handlers
from ..distributions import (
    Bernoulli,
    Beta,
    Categorical,
    Exponential,
    Gamma,
    Laplace,
    MinMaxDiscrete,
    Mixture,
    MultivariateNormalDiag,
    Normal,
    Poisson,
    Truncated,
    Uniform,
    UniformInt,
)
from . import nn
from .sis import ImportanceResult, sis

__all__ = ["CSIS", "SiteSpec", "ModelStructure", "discover_structure", "tie_structure"]

_N_MIX = 8  # reference: truncated mixture of 8 normals (prior_distributions.py:59-65)

# Cache sentinel: an infer() signature whose model does Python control flow
# on arg values and therefore cannot be traced with args as jit inputs.
_UNTRACEABLE = object()


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Static description of one controlled sample site."""

    addr: str
    kind: str                 # proposal family
    meta: Tuple[float, ...]   # static support parameters (low/high/K/...)
    value_dim: int            # flattened event size (1 for scalars)
    discrete_k: int           # >0: embedding-table size for bounded ints
    n_out: int                # head output width
    # parameter-table key; None = the address itself.  Tied sites (same base
    # address `name[t]`, same family) share one key -> one value-embedding +
    # head, so params and training compile time are O(#groups) not O(T).
    param_key: Optional[str] = None

    @property
    def pkey(self) -> str:
        return self.param_key if self.param_key is not None else self.addr


@dataclasses.dataclass(frozen=True)
class ModelStructure:
    sites: Tuple[SiteSpec, ...]
    observe_addrs: Tuple[str, ...]
    obs_dim: int
    # (start, length) segments over `sites`; length > 1 marks a run of
    # consecutive tied sites that the training loss executes as a lax.scan.
    segments: Tuple[Tuple[int, int], ...] = ()
    # per-observe-site value shapes (same order as observe_addrs) — lets the
    # structured obs embedding split the flat obs vector back into sites
    # (reference consumes observes as a real sequence, observation.py:39-53)
    observe_shapes: Tuple[Tuple[int, ...], ...] = ()

    def iter_segments(self):
        if self.segments:
            return self.segments
        return tuple((i, 1) for i in range(len(self.sites)))


_ADDR_INDEX_RE = re.compile(r"^(.*)\[(\d+)\]$")


def tie_structure(structure: ModelStructure) -> ModelStructure:
    """Tie repeated sites: consecutive addresses ``base[i]`` with identical
    (kind, meta, value_dim, discrete_k, n_out) share one parameter key
    ``base[*]`` and form a scan segment.

    The compiled answer to long traces: the reference's per-address module zoo
    (``nn.py:209-234``) is linear in trace length in both parameters and
    (for us) compile time; weight tying across a loop's iterations keeps the
    per-step proposal identity through the LSTM state + step values while
    making the program length O(#groups).
    """
    sites = list(structure.sites)
    new_sites: List[SiteSpec] = []
    segments: List[Tuple[int, int]] = []
    i = 0
    while i < len(sites):
        m = _ADDR_INDEX_RE.match(sites[i].addr)
        run = 1
        if m is not None:
            base = m.group(1)
            tmpl = sites[i]
            j = i + 1
            while j < len(sites):
                mj = _ADDR_INDEX_RE.match(sites[j].addr)
                if (
                    mj is None
                    or mj.group(1) != base
                    or (sites[j].kind, sites[j].meta, sites[j].value_dim,
                        sites[j].discrete_k, sites[j].n_out)
                    != (tmpl.kind, tmpl.meta, tmpl.value_dim,
                        tmpl.discrete_k, tmpl.n_out)
                ):
                    break
                j += 1
            run = j - i
        if run > 1:
            pkey = f"{base}[*]"
            for k in range(i, i + run):
                new_sites.append(
                    dataclasses.replace(sites[k], param_key=pkey)
                )
        else:
            new_sites.append(sites[i])
        segments.append((i, run))
        i += run
    return dataclasses.replace(
        structure, sites=tuple(new_sites), segments=tuple(segments)
    )


def _site_spec_from_dist(addr: str, dist) -> Optional[SiteSpec]:
    """Map a prior distribution instance to its proposal head spec — the
    static counterpart of the reference's ``proposal<D>`` trait type map
    (``utils_*.hpp``; SURVEY.md §2.2 table)."""
    if isinstance(dist, Normal):
        return SiteSpec(addr, "normal", (), 1, 0, 2)
    if isinstance(dist, Uniform):
        low = float(np.asarray(dist.low))
        high = float(np.asarray(dist.high))
        return SiteSpec(addr, "uniform", (low, high), 1, 0, 3 * _N_MIX)
    if isinstance(dist, UniformInt):
        low = int(np.asarray(dist.low))
        high = int(np.asarray(dist.high))
        k = high - low + 1
        return SiteSpec(addr, "uniform_int", (low, k), 1, k, k)
    if isinstance(dist, MinMaxDiscrete):
        low = int(np.asarray(dist.low))
        k = int(np.shape(dist.probs)[-1])
        return SiteSpec(addr, "uniform_int", (low, k), 1, k, k)
    if isinstance(dist, Categorical):
        k = int(np.shape(dist.probs)[-1])
        return SiteSpec(addr, "categorical", (k,), 1, k, k)
    if isinstance(dist, Poisson):
        return SiteSpec(addr, "poisson", (), 1, 0, 1)
    if isinstance(dist, Bernoulli):
        return SiteSpec(addr, "bernoulli", (), 1, 2, 1)
    if isinstance(dist, Beta):
        return SiteSpec(addr, "beta", (), 1, 0, 2)
    if isinstance(dist, Gamma):
        return SiteSpec(addr, "gamma", (), 1, 0, 2)
    if isinstance(dist, Laplace):
        return SiteSpec(addr, "laplace", (), 1, 0, 2)
    if isinstance(dist, Exponential):
        return SiteSpec(addr, "exponential", (), 1, 0, 1)
    if isinstance(dist, MultivariateNormalDiag):
        d = int(np.shape(dist.loc)[-1])
        return SiteSpec(addr, "mvn_diag", (d,), d, 0, 2 * d)
    # Beyond the reference's 4-type parse set (infcomp/traits.py:28-34):
    # bounded-support priors (Truncated) reuse the truncated-mixture-of-
    # normals head; Mixture priors get a mixture-density head sized to the
    # prior's component count (the posterior is typically as multimodal as
    # the prior).  Requires static scalar bounds/weights at discovery time.
    if isinstance(dist, Truncated):
        try:
            low = float(np.asarray(dist.low))
            high = float(np.asarray(dist.high))
        except (TypeError, ValueError):
            return None  # data-dependent bounds -> prior fallback
        if np.isfinite(low) and np.isfinite(high) and np.ndim(dist.low) == 0:
            return SiteSpec(addr, "uniform", (low, high), 1, 0, 3 * _N_MIX)
        return None
    if isinstance(dist, Mixture):
        try:
            k = max(int(np.shape(dist.weights)[-1]), 4)
        except (TypeError, ValueError):
            return None
        leaves = jax.tree_util.tree_leaves(dist.components)
        if leaves and all(np.ndim(l) == 1 for l in leaves):  # scalar comps
            return SiteSpec(addr, "mdn", (k,), 1, 0, 3 * k)
        return None
    # Dirac/ABC priors: no NN proposal -> prior fallback
    # (``Distribution::NONE``, cpprob.hpp:52-56).
    return None


def make_proposal_dist(spec: SiteSpec, raw: jax.Array):
    """Raw head outputs -> proposal distribution, applying the constraint
    projections of ``infcomp/distributions/projections.py`` (softplus for
    positive, softmax for simplex, interval sigmoid for bounded means)."""
    kind = spec.kind
    if kind == "normal":
        return Normal(raw[..., 0], nn.softplus(raw[..., 1]))
    if kind == "mdn":
        # mixture-density head for multimodal posteriors (beyond the
        # reference's single-Gaussian ProposalNormal)
        (k,) = spec.meta
        k = int(k)
        logits = raw[..., :k]
        means = raw[..., k : 2 * k]
        stds = nn.softplus(raw[..., 2 * k :]) + 1e-3
        comps = Normal(jnp.moveaxis(means, -1, 0), jnp.moveaxis(stds, -1, 0))
        return Mixture(comps, jax.nn.softmax(logits, axis=-1))
    if kind == "nsf":
        # neural-spline-flow head (Durkan et al. 2019) — beyond-reference:
        # one head covers multimodal AND skewed posteriors exactly
        (k,) = spec.meta
        k = int(k)
        w = raw[..., :k]
        hh = raw[..., k : 2 * k]
        d = raw[..., 2 * k : 3 * k - 1]
        loc = raw[..., 3 * k - 1]
        scale = nn.softplus(raw[..., 3 * k]) + 1e-3
        from ..distributions import SplineFlow1D

        return SplineFlow1D(w, hh, d, loc, scale)
    if kind == "uniform":
        low, high = spec.meta
        logits = raw[..., :_N_MIX]
        means = low + jax.nn.sigmoid(raw[..., _N_MIX : 2 * _N_MIX]) * (high - low)
        stds = nn.softplus(raw[..., 2 * _N_MIX :]) * (high - low) * 0.1 + 1e-4
        # low/high carried as (_N_MIX,) leaves so Mixture's vmap-over-components
        # sees a component axis on every leaf
        comps = Truncated(
            Normal(jnp.moveaxis(means, -1, 0), jnp.moveaxis(stds, -1, 0)),
            jnp.full((_N_MIX,), low),
            jnp.full((_N_MIX,), high),
        )
        return Mixture(comps, jax.nn.softmax(logits, axis=-1))
    if kind == "uniform_int":
        low, k = spec.meta
        return MinMaxDiscrete(int(low), jax.nn.softmax(raw, axis=-1))
    if kind == "categorical":
        return Categorical(jax.nn.softmax(raw, axis=-1))
    if kind == "poisson":
        return Poisson(nn.softplus(raw[..., 0]))
    if kind == "bernoulli":
        return Bernoulli(jax.nn.sigmoid(raw[..., 0]))
    if kind == "beta":
        return Beta(nn.softplus(raw[..., 0]) + 1.0, nn.softplus(raw[..., 1]) + 1.0)
    if kind == "gamma":
        return Gamma(nn.softplus(raw[..., 0]) + 0.5, nn.softplus(raw[..., 1]))
    if kind == "laplace":
        return Laplace(raw[..., 0], nn.softplus(raw[..., 1]))
    if kind == "exponential":
        return Exponential(nn.softplus(raw[..., 0]))
    if kind == "mvn_diag":
        (d,) = spec.meta
        d = int(d)
        return MultivariateNormalDiag(raw[..., :d], nn.softplus(raw[..., d:]))
    raise ValueError(f"no proposal family for kind {kind!r}")


def discover_structure(model: Callable, args: Tuple) -> ModelStructure:
    """One compile-mode execution (concrete, outside jit) to read the static
    address sequence, prior families, and observation layout."""
    tr = handlers.TraceHandler()
    with handlers.Seed(jax.random.key(0)), handlers.SimulateObserves(), tr:
        model(*args)
    sites: List[SiteSpec] = []
    observe_addrs: List[str] = []
    observe_shapes: List[Tuple[int, ...]] = []
    obs_dim = 0
    for name, site in tr.trace.items():
        if site["type"] == "sample" and site["control"] and not site["is_observed"]:
            spec = _site_spec_from_dist(name, site["dist"])
            if spec is not None:
                sites.append(spec)
        elif site["type"] in ("observe", "metaobserve"):
            observe_addrs.append(name)
            shp = tuple(np.shape(site["value"]))
            observe_shapes.append(shp)
            obs_dim += int(np.prod(shp) or 1)
    return ModelStructure(
        tuple(sites), tuple(observe_addrs), obs_dim,
        observe_shapes=tuple(observe_shapes),
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_csis_params(
    key: jax.Array,
    structure: ModelStructure,
    embedding_dim: int = nn.EMBEDDING_DIM,
    obs_embedding: str = "fc",
    obs_shape: Optional[Tuple[int, ...]] = None,
) -> Dict[str, Any]:
    """Static parameter pytree: observation embedding (fc | lstm | cnn3d —
    the reference's ``--obs_embedding`` options + ``ObserveEmbeddingCNN3D4C``),
    stacked LSTM, and one (value-embedding, head) pair per address — the
    static table replacing the reference's dynamically-grown module zoo
    (``nn.py:209-234``, which rebuilt the optimizer every time a new address
    appeared; jit-hostile)."""
    E = embedding_dim
    key, k_obs, k_lstm = jax.random.split(key, 3)
    if obs_embedding == "fc":
        # 4-layer FC observation embedding (observation.py:16-36)
        obs_net = nn.mlp_init(k_obs, [max(structure.obs_dim, 1), E, E, E])
    elif obs_embedding == "lstm":
        obs_net = nn.lstm_init(k_obs, 1, E, layers=1)
    elif obs_embedding == "cnn3d":
        if obs_shape is None or len(obs_shape) != 3:
            raise ValueError("obs_embedding='cnn3d' needs a 3-D obs_shape")
        obs_net = nn.conv3d_init(k_obs, out_dim=E)
    elif obs_embedding == "site-lstm":
        # structured observes: one embedder per observe SITE (CNN3D for
        # volumetric sites, MLP otherwise), then an LSTM over the site
        # sequence — parity with the reference's sequence-consuming
        # ObserveEmbeddingLSTM/CNN3D (observation.py:39-93), unlike the
        # flat-vector modes above
        if not structure.observe_shapes:
            raise ValueError(
                "obs_embedding='site-lstm' needs observe sites with recorded "
                "shapes (structure.observe_shapes)"
            )
        site_emb = {}
        for addr, shp in zip(structure.observe_addrs,
                             structure.observe_shapes):
            key, sub = jax.random.split(key)
            if len(shp) == 3:
                site_emb[addr] = {"conv3d": nn.conv3d_init(sub, out_dim=E)}
            else:
                size = int(np.prod(shp)) if shp else 1
                site_emb[addr] = {"mlp": nn.mlp_init(sub, [size, E, E])}
        obs_net = {
            "sites": site_emb,
            "seq_lstm": nn.lstm_init(k_obs, E, E, layers=1),
        }
    else:
        raise ValueError(f"unknown obs_embedding {obs_embedding!r}")
    params: Dict[str, Any] = {
        "obs_net": obs_net,
        "lstm": nn.lstm_init(k_lstm, 2 * E, E, layers=2),
        "value_emb": {},
        "heads": {},
    }
    seen = set()
    for spec in structure.sites:
        pk = spec.pkey
        if pk in seen:
            continue
        seen.add(pk)
        key, k_emb, k_head = jax.random.split(key, 3)
        if spec.discrete_k > 0:
            params["value_emb"][pk] = nn.embedding_init(
                k_emb, spec.discrete_k, E
            )
        else:
            params["value_emb"][pk] = nn.mlp_init(
                k_emb, [spec.value_dim, E, E]
            )
        params["heads"][pk] = nn.mlp_init(k_head, [E, E, spec.n_out])
    return params


def embed_observation(
    params, obs, obs_embedding: str = "fc",
    obs_shape: Optional[Tuple[int, ...]] = None,
    structure: Optional[ModelStructure] = None,
):
    """obs: (..., obs_dim) flat observation vector(s) -> (..., E)."""
    if obs_embedding == "fc":
        return nn.mlp_apply(params["obs_net"], obs)
    if obs_embedding == "lstm":
        # treat the flat vector as a length-obs_dim sequence of scalars
        xs = jnp.moveaxis(obs[..., None], -2, 0)  # (T, ..., 1)
        return nn.lstm_embed_sequence(params["obs_net"], xs)
    if obs_embedding == "cnn3d":
        vol = obs.reshape(obs.shape[:-1] + tuple(obs_shape))
        return nn.conv3d_apply(params["obs_net"], vol)
    if obs_embedding == "site-lstm":
        if structure is None or not structure.observe_shapes:
            raise ValueError("site-lstm embedding needs the model structure")
        embs = []
        off = 0
        for addr, shp in zip(structure.observe_addrs,
                             structure.observe_shapes):
            size = int(np.prod(shp)) if shp else 1
            chunk = obs[..., off : off + size]
            off += size
            p = params["obs_net"]["sites"][addr]
            if "conv3d" in p:
                vol = chunk.reshape(chunk.shape[:-1] + shp)
                embs.append(nn.conv3d_apply(p["conv3d"], vol))
            else:
                embs.append(nn.mlp_apply(p["mlp"], chunk))
        xs = jnp.stack(embs, axis=0)  # (S, ..., E): sequence over sites
        return nn.lstm_embed_sequence(
            params["obs_net"]["seq_lstm"], xs
        )
    raise ValueError(f"unknown obs_embedding {obs_embedding!r}")


def _embed_value(params, spec: SiteSpec, value):
    table_or_mlp = params["value_emb"][spec.pkey]
    if spec.discrete_k > 0:
        low = int(spec.meta[0]) if spec.kind == "uniform_int" else 0
        idx = jnp.clip(
            jnp.asarray(value, jnp.int32) - low, 0, spec.discrete_k - 1
        )
        return nn.embedding_lookup(table_or_mlp, idx)
    v = jnp.asarray(value, jnp.float32)
    if spec.value_dim == 1:
        v = v[..., None]
    return nn.mlp_apply(table_or_mlp, v)


# ---------------------------------------------------------------------------
# Training (the reference's `compile` mode, §3.2-3.3)
# ---------------------------------------------------------------------------


def make_trace_batch_fn(model: Callable, args: Tuple, structure: ModelStructure):
    """Build ``gen(key, n) -> (site_values dict, obs matrix)``: n prior traces
    with simulated observations, fully vectorized (replaces the ZMQ
    RequestTraces/ReplyTraces handshake)."""

    def one(key):
        tr = handlers.TraceHandler()
        with handlers.Seed(key), handlers.SimulateObserves(), tr:
            model(*args)
        values = {
            spec.addr: tr.trace[spec.addr]["value"] for spec in structure.sites
        }
        # per-site activity masks: variable-structure models are written as
        # static-max + Mask (the static-shape replacement for the reference's
        # address-sequence subbatching, data_structures.py:32-41) — masked-out
        # sites must not contribute to the training loss
        masks = {
            spec.addr: (
                jnp.asarray(tr.trace[spec.addr]["mask"], jnp.float32)
                if tr.trace[spec.addr]["mask"] is not None
                else jnp.ones(())
            )
            for spec in structure.sites
        }
        values["__masks__"] = masks
        obs = jnp.concatenate(
            [
                jnp.ravel(jnp.asarray(tr.trace[a]["value"], jnp.float32))
                for a in structure.observe_addrs
            ]
        ) if structure.observe_addrs else jnp.zeros((1,))
        return values, obs

    def gen(key, n):
        return jax.vmap(one)(jax.random.split(key, n))

    return gen


def csis_loss(
    params, structure: ModelStructure, values, obs,
    obs_embedding: str = "fc", obs_shape=None, dro_rho=None,
):
    """Mean over traces of Σ_sites −log q(x | proposal) (``nn.py:150-170``).
    ``dro_rho``: chi-square-ball distributionally-robust reweighting of the
    per-trace losses (cf. ``infcomp/nn/regularize.py``)."""
    E = params["lstm"][0]["wh"].shape[0]
    n = obs.shape[0]
    masks = values.get("__masks__", {})
    obs_emb = embed_observation(
        params, obs, obs_embedding, obs_shape, structure
    )  # (n, E)
    # obs half of the layer-0 input gates, computed once per trace instead of
    # once per site (exact split of the concat dot; see nn.lstm_obs_gate)
    obs_gate = nn.lstm_obs_gate(params["lstm"], obs_emb)
    state = nn.lstm_zero_state(params["lstm"], (n,))
    prev_emb = jnp.zeros((n, E))
    total = jnp.zeros((n,))
    for start, length in structure.iter_segments():
        spec = structure.sites[start]
        if length == 1:
            h, state = nn.lstm_step_split(
                params["lstm"], prev_emb, obs_gate, state
            )
            raw = nn.mlp_apply(params["heads"][spec.pkey], h)     # (n, n_out)
            proposal = make_proposal_dist(spec, raw)
            v = values[spec.addr]
            nll = -proposal.log_prob(v)
            m = masks.get(spec.addr)
            if m is not None:
                nll = nll * m
            total = total + nll
            prev_emb = _embed_value(params, spec, v)
        else:
            # tied run base[i..i+length): one shared head, time as lax.scan —
            # program size O(1) in the run length (long-trace CSIS)
            addrs = [
                structure.sites[k].addr for k in range(start, start + length)
            ]
            vs = jnp.stack([jnp.asarray(values[a]) for a in addrs], axis=0)
            ms = jnp.stack(
                [
                    jnp.broadcast_to(
                        jnp.asarray(
                            masks.get(a, jnp.ones(())), jnp.float32
                        ),
                        (n,),
                    )
                    for a in addrs
                ],
                axis=0,
            )

            def seg_body(carry, inp, spec=spec):
                state, prev_emb, total = carry
                v, mk = inp
                h, state = nn.lstm_step_split(
                    params["lstm"], prev_emb, obs_gate, state
                )
                raw = nn.mlp_apply(params["heads"][spec.pkey], h)
                proposal = make_proposal_dist(spec, raw)
                total = total + (-proposal.log_prob(v)) * mk
                prev_emb = _embed_value(params, spec, v)
                return (state, prev_emb, total), None

            (state, prev_emb, total), _ = jax.lax.scan(
                seg_body, (state, prev_emb, total), (vs, ms)
            )
    if dro_rho is not None:
        from .regularize import dro_loss

        return dro_loss(total, dro_rho)
    return jnp.mean(total)


# ---------------------------------------------------------------------------
# Guided inference messenger (the reference's csis mode, §3.4)
# ---------------------------------------------------------------------------


class CSISProposalMessenger(handlers.Messenger):
    """Installs NN proposals at controlled sample sites inside the particle
    program.  Python-level state (site pointer, LSTM hidden, previous value)
    lives at trace time; the emitted ops batch over particles under ``vmap``.

    Prior-fallback semantics: a site whose address does not match the next
    expected address (or has no trained head) samples from the prior with
    zero Radon–Nikodym correction — the reference's ``Distribution::NONE``
    behavior (``cpprob.hpp:52-56``, ``server.py:25-27``).  During a
    ``rejection_sampling`` block the proposal for a given address is computed
    once and cached (``state.hpp:239-262``)."""

    def __init__(
        self, params, structure: ModelStructure, obs_emb: jax.Array,
        first_step=None, defensive=None,
    ):
        self.params = params
        # defensive-mixture weight on the prior (Hesterberg 1995): bounds
        # importance weights when the learned proposal under-covers — e.g.
        # serving a tempered/wider posterior than the inverse model was
        # trained on.  None = pure learned proposal.
        self.defensive = defensive
        self.structure = structure
        # obs_emb is embedded ONCE per inference call (outside the particle
        # program; cf. the reference's cached obs embedding, nn.py:179-189) and
        # enters each particle as a broadcast constant.
        self.obs_emb = obs_emb
        # constant half of the layer-0 input gates (hoisted out of the vmapped
        # particle program by XLA — see nn.lstm_obs_gate)
        self.obs_gate = nn.lstm_obs_gate(params["lstm"], obs_emb)
        E = params["lstm"][0]["wh"].shape[0]
        self.state = nn.lstm_zero_state(params["lstm"])
        self.prev_emb = jnp.zeros((E,))
        # The first site's LSTM input ([zeros, obs_emb]) is identical across
        # particles; precomputing its (h, state) outside the particle program
        # avoids XLA constant-folding an O(n_particles) dot at compile time.
        self._first_step = first_step
        self.ptr = 0
        self._rejection_cache: Dict[str, Any] = {}
        self._rejection_spec: Dict[str, SiteSpec] = {}

    def process_message(self, msg):
        if msg["type"] != "sample" or not msg["control"] or msg["is_observed"]:
            return
        if msg["value"] is not None or msg["proposal_dist"] is not None:
            return
        if msg["rejection"] and msg["name"] in self._rejection_cache:
            msg["proposal_dist"] = self._rejection_cache[msg["name"]]
            return
        if self.ptr >= len(self.structure.sites):
            return
        spec = self.structure.sites[self.ptr]
        if msg["name"] is not None and msg["name"] != spec.addr:
            return  # unknown address -> prior fallback
        if self.ptr == 0 and self._first_step is not None:
            h, self.state = self._first_step
        else:
            h, self.state = nn.lstm_step_split(
                self.params["lstm"], self.prev_emb, self.obs_gate, self.state
            )
        raw = nn.mlp_apply(self.params["heads"][spec.pkey], h)
        proposal = make_proposal_dist(spec, raw)
        if self.defensive is not None:
            from ..distributions import DefensiveMixture

            proposal = DefensiveMixture(proposal, msg["dist"], self.defensive)
        msg["proposal_dist"] = proposal
        if msg["rejection"]:
            self._rejection_cache[msg["name"]] = proposal
            self._rejection_spec[msg["name"]] = spec
        msg["_csis_spec"] = spec

    def scan_adapter(self, n_iters: int):
        """Fast-path hook for :func:`cpprob_jax.core.scanner.scan_sites`:
        when the next ``m * n_iters`` sites are tied with iteration period
        ``m`` (``tie_addresses=True``), guided inference over the loop runs
        as ONE ``lax.scan`` whose carry holds (LSTM state, prev-value
        embedding) — compile time O(#site groups) instead of O(T), the
        inference-side twin of the training loss's scan segments.

        Returns None (=> unrolled fallback) when the upcoming sites don't
        tile into a tied pattern."""
        sites = self.structure.sites
        total = len(sites) - self.ptr
        for m in range(1, 9):
            if m * n_iters > total:
                break
            tmpl = sites[self.ptr : self.ptr + m]
            if not all(s.param_key is not None for s in tmpl):
                continue
            ok = all(
                sites[self.ptr + t * m + j].pkey == tmpl[j].pkey
                for t in range(n_iters)
                for j in range(m)
            )
            if ok:
                return _CSISScanAdapter(self, tuple(tmpl), m * n_iters)
        return None

    def postprocess_message(self, msg):
        spec = msg.pop("_csis_spec", None)
        if spec is not None:
            self.prev_emb = _embed_value(self.params, spec, msg["value"])
            self.ptr += 1
        elif msg.get("rejection") and msg["name"] in self._rejection_spec:
            # repeated guard attempt (cached proposal): keep refreshing the
            # previous-value embedding so after the guard the LSTM conditions
            # on the accepted draw — matching the training-side trace, whose
            # keep-last dedup records exactly that value
            self.prev_emb = _embed_value(
                self.params, self._rejection_spec[msg["name"]], msg["value"]
            )


class _CSISScanStep(handlers.Messenger):
    """Per-iteration proposal messenger used inside the ``scan_sites`` fast
    path: same LSTM-step/head math as :class:`CSISProposalMessenger` but with
    the (LSTM state, prev-value embedding) supplied as traced scan-carry
    values and the site specs fixed to the tied iteration template."""

    def __init__(self, params, specs, obs_emb, lstm_state, prev_emb):
        self.params = params
        self.specs = specs
        self.obs_emb = obs_emb
        self.obs_gate = nn.lstm_obs_gate(params["lstm"], obs_emb)
        self.state = lstm_state
        self.prev_emb = prev_emb
        self.j = 0

    def process_message(self, msg):
        if msg["type"] != "sample" or not msg["control"] or msg["is_observed"]:
            return
        if msg["value"] is not None or msg["proposal_dist"] is not None:
            return
        if self.j >= len(self.specs):
            return
        spec = self.specs[self.j]
        if msg["name"] is not None and msg["name"] not in (
            spec.addr, spec.pkey
        ):
            return  # unknown address -> prior fallback
        h, self.state = nn.lstm_step_split(
            self.params["lstm"], self.prev_emb, self.obs_gate, self.state
        )
        raw = nn.mlp_apply(self.params["heads"][spec.pkey], h)
        msg["proposal_dist"] = make_proposal_dist(spec, raw)
        msg["_csis_spec"] = spec

    def postprocess_message(self, msg):
        spec = msg.pop("_csis_spec", None)
        if spec is not None:
            self.prev_emb = _embed_value(self.params, spec, msg["value"])
            self.j += 1


class _CSISScanAdapter:
    """scan_sites adapter: threads the proposal messenger's state through the
    scan carry and advances the outer messenger past the consumed sites."""

    def __init__(self, msgr: "CSISProposalMessenger", specs, n_consumed: int):
        self.msgr = msgr
        self.specs = specs
        self.n_consumed = n_consumed
        self.init = (msgr.state, msgr.prev_emb)

    def make(self, state):
        return _CSISScanStep(
            self.msgr.params, self.specs, self.msgr.obs_emb,
            state[0], state[1],
        )

    def extract(self, m: _CSISScanStep):
        return (m.state, m.prev_emb)

    def commit(self, final_state):
        self.msgr.state, self.msgr.prev_emb = final_state
        self.msgr.ptr += self.n_consumed


# ---------------------------------------------------------------------------
# High-level engine
# ---------------------------------------------------------------------------


class CSIS:
    """Compile + infer, counterpart of ``cpprob::compile`` (``cpprob.hpp:127-171``)
    and ``cpprob::inference(StateType::csis, ...)`` (``cpprob.hpp:173-203``).

    >>> engine = CSIS(model, args_template)
    >>> params, losses = engine.compile(jax.random.key(0), steps=500)
    >>> result = engine.infer(params, observed_args, 10_000, jax.random.key(1))
    """

    def __init__(
        self,
        model: Callable,
        args_template: Tuple,
        embedding_dim: int = nn.EMBEDDING_DIM,
        obs_embedding: str = "fc",
        obs_shape: Optional[Tuple[int, ...]] = None,
        mdn_components: int = 0,
        flow_bins: int = 0,
        tie_addresses: bool = False,
    ):
        """``mdn_components`` > 0 upgrades Normal-prior sites to
        mixture-density proposal heads with that many Gaussian components —
        needed when the posterior over a site is multimodal (a single-Gaussian
        head like the reference's ProposalNormal collapses to one mode).

        ``flow_bins`` > 0 instead upgrades Normal-prior sites to
        location-scale rational-quadratic-spline flow heads with that many
        bins (:class:`~cpprob_jax.distributions.SplineFlow1D`) — multimodal
        and skewed posteriors with one head.  Mutually exclusive with
        ``mdn_components``.

        ``tie_addresses=True`` shares one (value-embedding, head) pair across
        consecutive loop-indexed sites ``name[t]`` of the same family and runs
        those runs as a ``lax.scan`` in the training loss — parameters and
        compile time become O(#site groups) instead of O(trace length), which
        is what makes CSIS practical for 10^3+-step models."""
        self.model = model
        self.args_template = args_template
        self.structure = discover_structure(model, args_template)
        self._tie = tie_addresses
        if mdn_components > 0 and flow_bins > 0:
            raise ValueError("choose one of mdn_components / flow_bins")
        if mdn_components > 0:
            self.structure = dataclasses.replace(
                self.structure,
                sites=tuple(
                    dataclasses.replace(
                        s, kind="mdn", meta=(mdn_components,),
                        n_out=3 * mdn_components,
                    ) if s.kind == "normal" else s
                    for s in self.structure.sites
                ),
            )
        if flow_bins > 0:
            self.structure = dataclasses.replace(
                self.structure,
                sites=tuple(
                    dataclasses.replace(
                        s, kind="nsf", meta=(flow_bins,),
                        n_out=3 * flow_bins + 1,
                    ) if s.kind == "normal" else s
                    for s in self.structure.sites
                ),
            )
        if tie_addresses:
            self.structure = tie_structure(self.structure)
        self.embedding_dim = embedding_dim
        self.obs_embedding = obs_embedding
        self.obs_shape = obs_shape
        self._gen = make_trace_batch_fn(model, args_template, self.structure)
        # jitted guided-inference programs, keyed by (n_particles, batch
        # size, observation structure) — see infer()
        self._infer_cache: Dict[Any, Callable] = {}

    def init(self, key: jax.Array):
        return init_csis_params(
            key, self.structure, self.embedding_dim,
            self.obs_embedding, self.obs_shape,
        )

    def compile(
        self,
        key: jax.Array,
        steps: int = 400,
        batch_size: int = 64,
        learning_rate: float = 1e-3,
        params=None,
        log_fn=None,
        dro_rho=None,
        unroll: int = 1,
        mesh=None,
        saver=None,
    ):
        """Online training from freshly simulated prior traces (minibatch 64,
        Adam — the reference defaults, ``main.py:28``, ``nn.py:166-169``).
        ``dro_rho`` enables chi-square-ball robust reweighting.
        ``unroll`` > 1 runs that many optimizer steps per dispatch via
        ``lax.scan`` — amortizes host-dispatch latency.  ``mesh``: shard the trace batch over the mesh's
        ``particles`` axis (data-parallel training; XLA all-reduces the
        gradients, parameters stay replicated).

        ``saver``: a :class:`~cpprob_jax.util.checkpoint.periodic_saver`;
        called after every dispatch with the fresh params and the number of
        traces consumed (``--save_after_n_traces``, reference
        ``infcomp/util.py:29-37``).  The loop is Ctrl-C-safe: on
        KeyboardInterrupt it returns the partially trained params instead of
        unwinding (reference ``infcomp/train.py:47-53``)."""
        key, k_init = jax.random.split(key)
        if params is None:
            params = self.init(k_init)
        opt = optax.adam(learning_rate)
        opt_state = opt.init(params)
        structure = self.structure
        gen = self._gen

        obs_embedding, obs_shape = self.obs_embedding, self.obs_shape

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            from ..parallel.mesh import PARTICLE_AXIS

            batch_sharding = NamedSharding(mesh, PartitionSpec(PARTICLE_AXIS))
        else:
            batch_sharding = None

        def one_step(carry, key):
            params, opt_state = carry
            k_data, _ = jax.random.split(key)
            values, obs = gen(k_data, batch_size)
            if batch_sharding is not None:
                constrain = lambda x: jax.lax.with_sharding_constraint(
                    x, batch_sharding
                ) if getattr(x, "ndim", 0) >= 1 else x
                values = jax.tree_util.tree_map(constrain, values)
                obs = constrain(obs)
            loss, grads = jax.value_and_grad(csis_loss)(
                params, structure, values, obs, obs_embedding, obs_shape,
                dro_rho,
            )
            updates, opt_state = opt.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        @jax.jit
        def train_chunk(params, opt_state, key):
            keys = jax.random.split(key, unroll)
            (params, opt_state), losses = jax.lax.scan(
                one_step, (params, opt_state), keys
            )
            return params, opt_state, losses

        all_losses = []
        done = 0
        try:
            while done < steps:
                key, sub = jax.random.split(key)
                params, opt_state, losses = train_chunk(params, opt_state, sub)
                take = min(unroll, steps - done)
                chunk = losses[:take]
                all_losses.append(chunk)
                done += take
                if log_fn is not None:
                    for l in chunk:
                        log_fn(float(l), batch_size)
                if saver is not None:
                    saver.maybe_save(params, take * batch_size)
        except KeyboardInterrupt:
            pass  # Ctrl-C-safe: hand back the partially trained network
        if not all_losses:
            return params, jnp.zeros((0,))
        return params, jnp.concatenate(all_losses)

    def dump_traces(self, directory: str, key, n_traces: int,
                    shard_size: int = 4096):
        """Offline compile mode: dump prior-trace shards to disk
        (``compile(..., dump_folder=...)``, ``cpprob.hpp:133-139``)."""
        from ..io.tracefile import dump_traces as _dump

        return _dump(self, directory, key, n_traces, shard_size)

    def compile_offline(
        self,
        loader,
        key: jax.Array,
        steps: int = 400,
        learning_rate: float = 1e-3,
        params=None,
        log_fn=None,
        saver=None,
    ):
        """Train from dumped trace shards via a :class:`TraceLoader`
        (native mmap+prefetch when built) — the ``RequesterFile`` offline path
        (``client.py:60-91``).  ``saver``/Ctrl-C semantics as in
        :meth:`compile`."""
        key, k_init = jax.random.split(key)
        if params is None:
            params = self.init(k_init)
        opt = optax.adam(learning_rate)
        opt_state = opt.init(params)
        structure = self.structure
        obs_embedding, obs_shape = self.obs_embedding, self.obs_shape

        # cast loaded integer-valued sites back to int for embedding lookups
        int_sites = {
            s.addr for s in structure.sites if s.discrete_k > 0
        }

        @jax.jit
        def train_step(params, opt_state, values, obs):
            loss, grads = jax.value_and_grad(csis_loss)(
                params, structure, values, obs, obs_embedding, obs_shape
            )
            updates, opt_state = opt.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        losses = []
        try:
            for _ in range(steps):
                values, obs = loader.next_batch()
                masks = {
                    k[len("__mask__"):]: v
                    for k, v in values.items() if k.startswith("__mask__")
                }
                values = {
                    k: (np.asarray(v, np.int32) if k in int_sites else v)
                    for k, v in values.items() if not k.startswith("__mask__")
                }
                if masks:
                    values["__masks__"] = masks
                params, opt_state, loss = train_step(
                    params, opt_state, values, obs
                )
                losses.append(loss)
                if log_fn is not None:
                    log_fn(float(loss), obs.shape[0])
                if saver is not None:
                    saver.maybe_save(params, int(obs.shape[0]))
        except KeyboardInterrupt:
            pass  # Ctrl-C-safe partial return (train.py:47-53)
        if not losses:
            return params, jnp.zeros((0,))
        return params, jnp.stack(losses)

    def obs_vector(self, args: Tuple) -> jax.Array:
        """Flatten the observed values (in observe-site order) into the
        network's observation vector — the counterpart of
        ``StateInfer::send_start_inference``'s tuple→NDArray flattening
        (``state.hpp:188-207``)."""
        tr = handlers.TraceHandler()
        with handlers.Seed(jax.random.key(0)), tr:
            self.model(*args)
        if not self.structure.observe_addrs:
            return jnp.zeros((1,))
        return jnp.concatenate(
            [
                jnp.ravel(jnp.asarray(tr.trace[a]["value"], jnp.float32))
                for a in self.structure.observe_addrs
            ]
        )

    def proposal_factory(self, params, args: Tuple, defensive=None):
        obs_vec = self.obs_vector(args)
        obs_emb = embed_observation(
            params, jnp.asarray(obs_vec, jnp.float32),
            self.obs_embedding, self.obs_shape, self.structure,
        )
        structure = self.structure
        # precompute the particle-independent first LSTM step (see messenger)
        E = params["lstm"][0]["wh"].shape[0]
        x0 = jnp.concatenate([jnp.zeros((E,)), obs_emb], axis=-1)
        first_step = nn.lstm_step(
            params["lstm"], x0, nn.lstm_zero_state(params["lstm"])
        )

        def factory():
            return CSISProposalMessenger(
                params, structure, obs_emb, first_step, defensive=defensive
            )

        return factory

    def infer(
        self,
        params,
        args: Tuple,
        n_particles: int,
        key: jax.Array,
        mesh=None,
        defensive=None,
        **sis_kwargs,
    ) -> ImportanceResult:
        """Guided importance sampling; pass ``mesh`` to shard particles over a
        device mesh (the proposal network is replicated, particles + their
        LSTM states partition — zero-communication guided inference).

        ``defensive``: mixture weight on the PRIOR at every guided site
        (defensive importance sampling, Hesterberg 1995) — caps the damage
        an over-confident amortized proposal can do (weights bounded by
        1/defensive where it under-covers), at a (1-defensive) efficiency
        cost when the proposal is right.

        The serving path: the guided program is jitted ONCE per
        (n_particles, batch_size, observation shapes) with ``params`` and the
        observed ``args`` as *traced* inputs, so repeated calls — new
        observations, refreshed parameters — skip tracing entirely.  This is
        the in-process replacement of the reference's inference server loop
        (``infcomp/inference.py:8-28``): "start inference, then answer any
        number of queries with the loaded network"."""
        if mesh is not None:
            factory = self.proposal_factory(params, args, defensive=defensive)
            from ..parallel.sis import sis_sharded

            return sis_sharded(
                self.model, args, n_particles, key, mesh=mesh,
                proposal_messenger=factory,
            )
        batch_size = sis_kwargs.pop("batch_size", None)
        if sis_kwargs:  # uncommon options: fall back to the uncached path
            factory = self.proposal_factory(params, args, defensive=defensive)
            return sis(
                self.model, args, n_particles, key,
                proposal_messenger=factory, batch_size=batch_size,
                **sis_kwargs,
            )
        if defensive is not None:
            defensive = float(defensive)  # hashable for the cache key
        args = jax.tree_util.tree_map(jnp.asarray, args)
        abstract = tuple(
            (jnp.shape(x), str(jnp.result_type(x)))
            for x in jax.tree_util.tree_leaves(args)
        )
        cache_key = (n_particles, batch_size, defensive,
                     jax.tree_util.tree_structure(args), abstract)
        fn = self._infer_cache.get(cache_key)
        if fn is _UNTRACEABLE:
            # signature previously failed tracing — skip straight to eager
            factory = self.proposal_factory(params, args, defensive=defensive)
            return sis(
                self.model, args, n_particles, key,
                proposal_messenger=factory, batch_size=batch_size,
            )
        if fn is None:
            def run(params, args, key):
                factory = self.proposal_factory(params, args,
                                                defensive=defensive)
                return sis(
                    self.model, args, n_particles, key,
                    proposal_messenger=factory, batch_size=batch_size,
                    jit=False,
                )

            fn = jax.jit(run)
            self._infer_cache[cache_key] = fn
        try:
            return fn(params, args, key)
        except (jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError,
                jax.errors.TracerBoolConversionError, jax.errors.TracerIntegerConversionError):
            # the model does Python-level control flow on arg values: args
            # cannot be traced inputs — fall back to baking them in as
            # concrete closure values (one trace per distinct args).  Mark
            # the signature untraceable so later calls skip the re-trace.
            self._infer_cache[cache_key] = _UNTRACEABLE
            factory = self.proposal_factory(params, args, defensive=defensive)
            return sis(
                self.model, args, n_particles, key,
                proposal_messenger=factory, batch_size=batch_size,
            )

    def infer_many(
        self,
        params,
        args: Tuple,
        n_particles: int,
        keys: jax.Array,
        defensive=None,
    ) -> ImportanceResult:
        """Batched serving: run ``len(keys)`` independent guided
        importance-sampling queries inside ONE jitted dispatch (a
        ``lax.scan`` over the cached serving program).

        Every dispatch pays a fixed host cost (launch, transfer, fetch);
        serving that answers query streams should batch them through this
        entry.  Returns an :class:`ImportanceResult` whose
        leaves carry a leading ``(len(keys),)`` axis."""
        keys = jnp.asarray(keys)
        cache_key = ("many", n_particles, defensive, keys.shape[0],
                     jax.tree_util.tree_structure(args), tuple(
                         (jnp.shape(x), str(jnp.result_type(x)))
                         for x in jax.tree_util.tree_leaves(args)))
        fn = self._infer_cache.get(cache_key)
        if fn is None:
            def run(params, args, keys):
                factory = self.proposal_factory(params, args,
                                                defensive=defensive)

                def body(_, k):
                    r = sis(self.model, args, n_particles, k,
                            proposal_messenger=factory, jit=False)
                    return None, r

                _, results = jax.lax.scan(body, None, keys)
                return results

            fn = jax.jit(run)
            self._infer_cache[cache_key] = fn
        args = jax.tree_util.tree_map(jnp.asarray, args)
        return fn(params, args, keys)
