"""Sequential importance sampling (SIS), vectorized.

The reference runs one trace at a time in a serial loop
(``cpprob.hpp:194-201``); here the particle dimension is a ``vmap`` batch axis
inside one jitted program — a million particles is one XLA launch, and the
same program shards over a device mesh (see :mod:`cpprob_jax.parallel`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import handlers
from ..util.numerics import CompSum, comp_add, comp_scale, comp_value

__all__ = [
    "make_particle_fn",
    "make_prior_fn",
    "sis",
    "sis_streaming",
    "sis_streaming_checkpointed",
    "ImportanceResult",
    "StreamingResult",
]


def make_particle_fn(
    model: Callable,
    args: Tuple = (),
    kwargs: Optional[dict] = None,
    proposal_messenger: Optional[Callable[[], Any]] = None,
):
    """Build ``particle(key) -> (log_weight, predicts)``: one weighted model
    execution (the body of the reference's hot loop, ``cpprob.hpp:194-201``,
    now a pure function to be vmapped over particles).

    ``proposal_messenger``: zero-arg factory returning a messenger that guides
    sample sites (CSIS); ``None`` = prior proposal (plain SIS).
    """
    kwargs = kwargs or {}

    def particle(key):
        lw = handlers.LogWeight()
        pc = handlers.PredictCollector()
        ctx = [handlers.Seed(key), lw, pc]
        if proposal_messenger is not None:
            ctx.append(proposal_messenger())
        with _nested(ctx):
            model(*args, **kwargs)
        return lw.log_weight, pc.stacked()

    return particle


def make_prior_fn(model: Callable, args: Tuple = (), kwargs: Optional[dict] = None):
    """Build ``prior(key) -> trace dict`` running the model in compile mode:
    observes are *simulated* (``cpprob.hpp:83-85``) and every site recorded —
    the trace-generation half of inference compilation (§3.2 of SURVEY.md)."""
    kwargs = kwargs or {}

    def prior(key):
        tr = handlers.TraceHandler()
        with _nested([handlers.Seed(key), handlers.SimulateObserves(), tr]):
            model(*args, **kwargs)
        return {
            name: {"value": site["value"], "type": site["type"]}
            for name, site in tr.trace.items()
        }

    return prior


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


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ImportanceResult:
    """Particles + log-weights — the in-memory counterpart of the reference's
    dumped posterior files (``state.cpp:250-267``)."""

    log_weights: jax.Array              # (n,)
    predicts: Dict[str, jax.Array]      # name -> (n, ...) stacked predict values

    @property
    def num_particles(self) -> int:
        return self.log_weights.shape[0]

    @property
    def normalized_weights(self) -> jax.Array:
        return jax.nn.softmax(self.log_weights)

    @property
    def log_evidence(self) -> jax.Array:
        """log(1/N sum w_i) — the marginal-likelihood estimate."""
        n = self.log_weights.shape[0]
        return jax.scipy.special.logsumexp(self.log_weights) - jnp.log(float(n))

    @property
    def ess(self) -> jax.Array:
        """Kish effective sample size 1 / sum(w_i^2)."""
        lw = self.log_weights - jax.scipy.special.logsumexp(self.log_weights)
        return jnp.exp(-jax.scipy.special.logsumexp(2.0 * lw))

    def empirical(self, name: str):
        from ..postprocess import EmpiricalDistribution

        return EmpiricalDistribution(self.predicts[name], self.log_weights)

    def mean(self, name: str) -> jax.Array:
        return self.empirical(name).mean

    def variance(self, name: str) -> jax.Array:
        return self.empirical(name).variance


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StreamingResult:
    """Constant-memory SIS summary: log-evidence, ESS, and weighted
    mean/variance per predict — no per-particle storage."""

    log_evidence: jax.Array
    ess: jax.Array
    means: Dict[str, jax.Array]
    variances: Dict[str, jax.Array]
    n_particles: int = dataclasses.field(metadata={"static": True})

    def mean(self, name):
        return self.means[name]

    def variance(self, name):
        return self.variances[name]


def _make_chunk_stats(particle: Callable, batch_size: int):
    """Per-chunk streaming statistics: (max-shift, sum w, sum w^2, weighted
    value sums / square sums per predict)."""

    def chunk_stats(keys):
        log_w, predicts = jax.vmap(particle)(keys)
        m = jnp.max(log_w)
        w = jnp.exp(log_w - m)
        s0 = jnp.sum(w)
        s0_sq = jnp.sum(w * w)
        sums = {}
        sqs = {}
        for name, vals in predicts.items():
            vals = jnp.asarray(vals, jnp.float32)
            wshape = w.reshape((batch_size,) + (1,) * (vals.ndim - 1))
            sums[name] = jnp.sum(wshape * vals, axis=0)
            sqs[name] = jnp.sum(wshape * vals * vals, axis=0)
        return m, s0, s0_sq, sums, sqs

    return chunk_stats


def _lift_chunk(chunk):
    """Promote a plain per-chunk stat tuple into a compensated carry
    (every running sum becomes a :class:`CompSum`)."""
    m, s0, s0_sq, sums, sqs = chunk
    lift = lambda x: CompSum(x, jnp.zeros_like(x))
    return (
        m, lift(s0), lift(s0_sq),
        {k: lift(v) for k, v in sums.items()},
        {k: lift(v) for k, v in sqs.items()},
    )


def _merge_stats(carry, chunk):
    """Online max-shift logsumexp merge of a compensated carry with a fresh
    plain chunk — associative up to rounding, and Neumaier-compensated so
    the sequential f32 accumulation error stays O(eps) independent of chunk
    count (validated against f64 at 10^7 particles in
    ``tests/test_numerics.py``)."""
    m, s0, s0_sq, sums, sqs = carry
    mc, c0, c0_sq, csums, csqs = chunk
    new_m = jnp.maximum(m, mc)
    a = jnp.exp(m - new_m)
    b = jnp.exp(mc - new_m)
    s0 = comp_add(comp_scale(s0, a), c0 * b)
    s0_sq = comp_add(comp_scale(s0_sq, a * a), c0_sq * b * b)
    sums = {k: comp_add(comp_scale(sums[k], a), csums[k] * b) for k in sums}
    sqs = {k: comp_add(comp_scale(sqs[k], a), csqs[k] * b) for k in sqs}
    return new_m, s0, s0_sq, sums, sqs


def _finalize_stats(carry, n_particles):
    m, s0, s0_sq, sums, sqs = carry
    s0v = comp_value(s0)
    s0_sqv = comp_value(s0_sq)
    log_z = m + jnp.log(s0v) - jnp.log(float(n_particles))
    ess = (s0v * s0v) / jnp.maximum(s0_sqv, 1e-38)
    means = {k: comp_value(sums[k]) / s0v for k in sums}
    variances = {k: comp_value(sqs[k]) / s0v - means[k] ** 2 for k in sums}
    return log_z, ess, means, variances


def sis_streaming(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key: jax.Array,
    batch_size: int,
    *,
    proposal_messenger: Optional[Callable[[], Any]] = None,
    jit: bool = True,
) -> StreamingResult:
    """SIS with **streaming** weighted-moment accumulation: particles run in
    chunks of ``batch_size`` under ``lax.scan`` and only running sums survive
    — memory is O(batch_size), so particle counts are bounded by time, not
    HBM (the reference's append-per-trace files are the disk analogue;
    state.cpp:262-267).  Uses the online max-shift logsumexp merge for
    stability at any scale."""
    if n_particles % batch_size != 0:
        raise ValueError("n_particles must be divisible by batch_size")
    n_chunks = n_particles // batch_size
    particle = make_particle_fn(model, args, proposal_messenger=proposal_messenger)
    chunk_stats = _make_chunk_stats(particle, batch_size)

    def run(key):
        keys = jax.random.split(key, n_particles).reshape(n_chunks, batch_size)

        carry0 = _lift_chunk(chunk_stats(keys[0]))

        def body(carry, ks):
            return _merge_stats(carry, chunk_stats(ks)), None

        carry, _ = jax.lax.scan(body, carry0, keys[1:])
        return _finalize_stats(carry, n_particles)

    if jit:
        run = jax.jit(run)
    log_z, ess, means, variances = run(key)
    return StreamingResult(log_z, ess, means, variances, n_particles)


def sis_streaming_checkpointed(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key: jax.Array,
    batch_size: int,
    dump_path: str,
    *,
    dump_every: int = 16,
    proposal_messenger: Optional[Callable[[], Any]] = None,
    resume: bool = True,
) -> StreamingResult:
    """Streaming SIS with **on-disk partial dumps**: after every
    ``dump_every`` chunks the running sufficient statistics are atomically
    written to ``dump_path`` (npz), so an interrupted run keeps its partial
    results and ``resume=True`` continues exactly where it stopped — the
    reference's append-only posterior files give the same guarantee one trace
    at a time (``state.cpp:262-267``); here the checkpoint is O(#predicts),
    not O(#particles).

    The particle key stream is a pure function of ``key`` and the chunk
    index, so a resumed run is bit-identical to an uninterrupted one.
    """
    import numpy as np

    if n_particles % batch_size != 0:
        raise ValueError("n_particles must be divisible by batch_size")
    n_chunks = n_particles // batch_size
    particle = make_particle_fn(model, args, proposal_messenger=proposal_messenger)
    chunk_stats = _make_chunk_stats(particle, batch_size)

    @jax.jit
    def run_group(carry, keys_group):
        def body(c, ks):
            return _merge_stats(c, chunk_stats(ks)), None

        carry, _ = jax.lax.scan(body, carry, keys_group)
        return carry

    # neutral element: m = -inf, zero compensated sums (shape-inferred
    # without running a chunk)
    shapes = jax.eval_shape(chunk_stats, jax.random.split(key, batch_size))
    _, _, _, sum_shapes, sq_shapes = shapes
    zc = lambda v: CompSum(jnp.zeros(v.shape, v.dtype), jnp.zeros(v.shape, v.dtype))
    carry = (
        jnp.float32(-jnp.inf), zc(jnp.zeros(())), zc(jnp.zeros(())),
        {k: zc(v) for k, v in sum_shapes.items()},
        {k: zc(v) for k, v in sq_shapes.items()},
    )
    done = 0

    import os

    if resume and os.path.exists(dump_path):
        with np.load(dump_path) as ck:
            if int(ck["batch_size"]) != batch_size or int(
                ck["n_particles"]
            ) != n_particles:
                raise ValueError(
                    f"checkpoint {dump_path!r} was written for "
                    f"n_particles={int(ck['n_particles'])}, "
                    f"batch_size={int(ck['batch_size'])}"
                )
            done = int(ck["chunks_done"])
            # pre-compensation checkpoints (no '#c' keys) resume with zero
            # compensation terms — only the O(eps) correction is lost
            lc = lambda stem: CompSum(
                jnp.asarray(ck[stem]),
                jnp.asarray(ck[stem + "#c"])
                if stem + "#c" in ck.files
                else jnp.zeros_like(jnp.asarray(ck[stem])),
            )
            carry = (
                jnp.asarray(ck["m"]), lc("s0"), lc("s0_sq"),
                {k: lc(f"sum:{k}") for k in sum_shapes},
                {k: lc(f"sq:{k}") for k in sq_shapes},
            )

    def save(carry, done):
        m, s0, s0_sq, sums, sqs = jax.device_get(carry)
        payload = {
            "m": m, "s0": s0.value, "s0#c": s0.comp,
            "s0_sq": s0_sq.value, "s0_sq#c": s0_sq.comp,
            "chunks_done": done, "batch_size": batch_size,
            "n_particles": n_particles,
        }
        for k, v in sums.items():
            payload[f"sum:{k}"], payload[f"sum:{k}#c"] = v.value, v.comp
        for k, v in sqs.items():
            payload[f"sq:{k}"], payload[f"sq:{k}#c"] = v.value, v.comp
        tmp = dump_path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, dump_path)

    all_keys = jax.random.split(key, n_particles).reshape(n_chunks, batch_size)
    while done < n_chunks:
        g = min(dump_every, n_chunks - done)
        carry = run_group(carry, all_keys[done : done + g])
        done += g
        save(carry, done)

    log_z, ess, means, variances = jax.jit(
        partial(_finalize_stats, n_particles=n_particles)
    )(carry)
    return StreamingResult(log_z, ess, means, variances, n_particles)


def sis(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key: jax.Array,
    *,
    proposal_messenger: Optional[Callable[[], Any]] = None,
    batch_size: Optional[int] = None,
    jit: bool = True,
) -> ImportanceResult:
    """Vectorized SIS: counterpart of
    ``cpprob::inference(StateType::sis, f, observes, n)`` (``cpprob.hpp:173-203``).

    ``batch_size`` bounds peak memory: particles run in ``n // batch_size``
    sequential super-steps of ``batch_size`` vmapped lanes (``lax.map`` over a
    reshaped key array), which keeps arbitrarily large particle counts inside
    fixed HBM.
    """
    particle = make_particle_fn(model, args, proposal_messenger=proposal_messenger)

    def run(key):
        keys = jax.random.split(key, n_particles)
        if batch_size is None or batch_size >= n_particles:
            log_w, predicts = jax.vmap(particle)(keys)
        else:
            if n_particles % batch_size != 0:
                raise ValueError("n_particles must be divisible by batch_size")
            keys = keys.reshape(n_particles // batch_size, batch_size, *keys.shape[1:])
            log_w, predicts = jax.lax.map(jax.vmap(particle), keys)
            log_w = log_w.reshape(n_particles)
            predicts = jax.tree_util.tree_map(
                lambda x: x.reshape((n_particles,) + x.shape[2:]), predicts
            )
        return log_w, predicts

    if jit:
        run = jax.jit(run)
    log_w, predicts = run(key)
    return ImportanceResult(log_w, predicts)
