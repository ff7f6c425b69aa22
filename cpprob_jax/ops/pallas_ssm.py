"""Fused discrete-state SMC: a K-state Gaussian-emission HMM chunk as one
Pallas kernel on the Triton route.

Why a kernel.  The plain XLA step cannot fuse across ``lax.scan`` steps: every
step reads and writes state and weight in device memory and then makes
separate passes for the ESS and log-sum-exp reductions.  Here one program owns
a power-of-two tile of particles, loads (state, log-weight) once, runs the
chunk's time steps with both held in registers, and writes them back together
with per-tile partials: about 8 B read and 8 B written per particle per chunk.

Per step and particle: one uniform from a counter-based generator
(:mod:`.counter_rng`, keyed on (key, step pair, global particle index); one
Threefry call feeds two steps), K-1 loads from the transition-CDF row of the
current state, and one load of the emission log-density of the new state from
a per-step table built outside the kernel.  The tables are a few hundred bytes
and stay in L1.

Semantics, shared by the kernel and its XLA reference:

- chunk-start exchange resampling: when ``flag`` is set, the incoming
  population is replaced by the sorted resampled one, synthesized from the
  global slot index against the K-1 category tick boundaries
  (``inference/resampling.py``), and weights restart at 0;
- ragged tail: steps at or beyond ``n_valid`` are the identity;
- islands (``island_every`` > 0): every that many steps each tile checks its
  own Kish ESS and, below ``island_thresh``, exchange-resamples itself and
  sets every weight to the tile's log-mean weight, which preserves the
  tile's mass so the engine's global evidence estimator is unchanged;
- partials per tile: (max, sum e, sum e^2, K category sums of e, islands
  fired), reduced across tiles by a second small XLA pass, because blocks
  run in no order.

The same tile function (:func:`_tile_sweep`) is the kernel body and, under
``vmap`` over tiles, the plain XLA reference: same arithmetic on the same
random bits, so the two agree exactly on states and to rounding on weights.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .counter_rng import threefry2x32, uniform_from_bits

__all__ = [
    "make_fused_discrete_ssm",
    "DiscreteSweep",
    "discrete_sweep",
]

_HALF_LOG_2PI = 0.9189385332046727
# particles per program and warps per program: the fastest of tiles 256 to
# 2048 and 4 or 8 warps on an H100 (PERF.md, PR 1)
_TILE = 1024
_NUM_WARPS = 4
# counter word 0 of the per-tile island uniforms; step-pair counters are
# below 2^31, so the two streams never share a counter
_ISLAND_TAG = 0x80000000
_MAX_STATES = 32


def _pow2_pad(x):
    """Zero-pad a 1-D table to a power-of-two length (Triton block rule)."""
    size = 1 << max(0, int(np.ceil(np.log2(max(x.shape[0], 1)))))
    return jnp.pad(jnp.asarray(x), (0, size - x.shape[0]))


def _n_partials(K: int) -> int:
    return 1 << int(np.ceil(np.log2(3 + K + 1)))


def _tile_sweep(tid, s, w, keys, ctrl, cdf, g, *, K, n_steps, tile,
                island_every, island_thresh, init):
    """Advance one tile of particles through a chunk.

    ``tid``: tile index; ``s``/``w``: (tile,) int32 states and float32
    log-weights (ignored when ``init``); ``keys``: 2 uint32 key words;
    ``ctrl``: int32 [flag, ticks (K-1), n_valid]; ``cdf``: float32
    transition-CDF rows, row K holding the initial distribution's CDF; ``g``:
    float32 (n_steps*K) emission log-densities per (step, state).  The tables
    are refs inside the kernel and arrays in the reference; both index the
    same way.  Returns (s, w, partials as a list of scalars)."""
    j = tid * tile + jnp.arange(tile, dtype=jnp.int32)
    ju = j.astype(jnp.uint32)
    k0, k1 = keys[0], keys[1]
    n_valid = ctrl[K]

    def step(t, u, s, w):
        row = s * K
        ns = jnp.zeros_like(s)
        for k in range(K - 1):
            ns = ns + (u >= cdf[row + k]).astype(jnp.int32)
        valid = t < n_valid
        return (jnp.where(valid, ns, s),
                jnp.where(valid, w + g[t * K + ns], w))

    def pair(p, carry):
        s, w = carry
        b0, b1 = threefry2x32(k0, k1, p.astype(jnp.uint32), ju)
        s, w = step(2 * p, uniform_from_bits(b0), s, w)
        return step(2 * p + 1, uniform_from_bits(b1), s, w)

    n_fired = jnp.int32(0)
    if init:
        b0, _ = threefry2x32(k0, k1, np.uint32(0), ju)
        s = jnp.full((tile,), K, jnp.int32)
        s, w = step(0, uniform_from_bits(b0), s, jnp.zeros((tile,),
                                                           jnp.float32))
    else:
        flag = ctrl[0] > 0
        synth = jnp.zeros((tile,), jnp.int32)
        for k in range(K - 1):
            synth = synth + (j >= ctrl[1 + k]).astype(jnp.int32)
        s = jnp.where(flag, synth, s)
        w = jnp.where(flag, 0.0, w)
        seg = island_every or n_steps
        for lo in range(0, n_steps, seg):
            hi = min(lo + seg, n_steps)
            s, w = jax.lax.fori_loop(lo // 2, hi // 2, pair, (s, w))
            if island_every and hi < n_steps:
                s, w, fired = _island(tid, j, s, w, k0, k1, hi, n_valid,
                                      K=K, tile=tile,
                                      island_thresh=island_thresh)
                n_fired = n_fired + fired

    m = jnp.max(w)
    e = jnp.exp(w - m)
    vals = [m, jnp.sum(e), jnp.sum(e * e)]
    vals += [jnp.sum(jnp.where(s == k, e, 0.0)) for k in range(K)]
    vals.append(n_fired.astype(jnp.float32))
    return s, w, vals


def _island(tid, j, s, w, k0, k1, t_done, n_valid, *, K, tile,
            island_thresh):
    """Tile-local ESS check after ``t_done`` steps; on collapse, systematic
    exchange resample of the tile from its own category weights."""
    n_blk = float(tile)
    m = jnp.max(w)
    e = jnp.exp(w - m)
    se = jnp.sum(e)
    se2 = jnp.sum(e * e)
    collapse = (se * se < island_thresh * n_blk * se2) & (t_done < n_valid)
    b0, _ = threefry2x32(k0, k1, np.uint32(_ISLAND_TAG | t_done),
                         tid.astype(jnp.uint32))
    u0 = uniform_from_bits(b0)
    j_local = (j - tid * tile).astype(jnp.float32)
    cum = jnp.float32(0.0)
    synth = jnp.zeros_like(s)
    for k in range(K - 1):
        cum = cum + jnp.sum(jnp.where(s == k, e, 0.0))
        tick = jnp.clip(jnp.ceil(n_blk * (cum / se) - u0), 0.0, n_blk)
        synth = synth + (j_local >= tick).astype(jnp.int32)
    lme = m + jnp.log(se) - np.float32(np.log(n_blk))
    return (jnp.where(collapse, synth, s), jnp.where(collapse, lme, w),
            collapse.astype(jnp.int32))


def _kernel(keys_ref, ctrl_ref, cdf_ref, g_ref, *refs, init, n_part, **kw):
    if init:
        s_in = w_in = None
        out_s_ref, out_w_ref, part_ref = refs
    else:
        s_ref, w_ref, out_s_ref, out_w_ref, part_ref = refs
        s_in, w_in = s_ref[...], w_ref[...]
    s, w, vals = _tile_sweep(pl.program_id(0), s_in, w_in, keys_ref,
                             ctrl_ref, cdf_ref, g_ref, init=init, **kw)
    out_s_ref[...] = s
    out_w_ref[...] = w
    lane = jnp.arange(n_part, dtype=jnp.int32)
    row = jnp.zeros((n_part,), jnp.float32)
    for idx, v in enumerate(vals):
        row = jnp.where(lane == idx, v, row)
    part_ref[...] = row


class DiscreteSweep(NamedTuple):
    """Outputs of one fused chunk (or init) call."""

    states: jax.Array        # (n,) int32
    log_weights: jax.Array   # (n,) float32
    ess: jax.Array           # Kish ESS of the new weights
    cat_w: jax.Array         # (K,) normalized category weights
    lme: jax.Array           # log-mean-exp of the new weights
    partials: jax.Array      # (n_tiles, P) per-tile partials


def _stats(partials, n: int, K: int):
    m_b, s1_b, s2_b = partials[:, 0], partials[:, 1], partials[:, 2]
    m = jnp.max(m_b)
    scale = jnp.exp(m_b - m)
    s1 = jnp.sum(s1_b * scale)
    s2 = jnp.sum(s2_b * scale * scale)
    ess = s1 * s1 / jnp.maximum(s2, 1e-38)
    cat_w = (jnp.sum(partials[:, 3:3 + K] * scale[:, None], axis=0)
             / jnp.maximum(s1, 1e-38))
    lme = m + jnp.log(jnp.maximum(s1, 1e-38)) - jnp.log(float(n))
    return ess, cat_w, lme


def discrete_sweep(keys, states, log_w, ctrl, cdf, g, *, n, K, n_steps,
                   island_every=0, island_thresh=0.5, init=False,
                   impl="kernel"):
    """Run one chunk (or the init step, ``init=True``) over ``n`` particles.

    ``impl``: ``"kernel"`` compiles the Triton kernel for the GPU,
    ``"interpret"`` runs the same kernel in the Pallas interpreter, and
    ``"reference"`` runs the tile function as plain XLA under ``vmap``.
    Table layouts as in :func:`_tile_sweep`; ``n_steps`` must be even."""
    tile = _TILE
    if n % tile:
        raise ValueError(f"n_particles={n} must be a multiple of tile={tile}")
    if n_steps % 2 or (island_every and island_every % 2):
        raise ValueError("n_steps and island_every must be even")
    n_tiles = n // tile
    n_part = _n_partials(K)
    kw = dict(K=K, n_steps=n_steps, tile=tile, island_every=island_every,
              island_thresh=island_thresh)
    if impl == "reference":
        def one(tid, s, w):
            s, w, vals = _tile_sweep(tid, s, w, keys, ctrl, cdf, g,
                                     init=init, **kw)
            vals = jnp.stack(vals)
            return s, w, jnp.pad(vals, (0, n_part - vals.shape[0]))

        tids = jnp.arange(n_tiles, dtype=jnp.int32)
        if init:
            s, w, parts = jax.vmap(lambda t: one(t, None, None))(tids)
        else:
            s, w, parts = jax.vmap(one)(tids, states.reshape(n_tiles, tile),
                                        log_w.reshape(n_tiles, tile))
        s, w = s.reshape(n), w.reshape(n)
    elif impl in ("kernel", "interpret"):
        def whole(x):
            return pl.BlockSpec(x.shape, lambda i: (0,))

        tile_spec = pl.BlockSpec((tile,), lambda i: (i,))
        tables = (keys, ctrl, cdf, g)
        pops = () if init else (states, log_w)
        s, w, parts = pl.pallas_call(
            lambda *refs: _kernel(*refs, init=init, n_part=n_part, **kw),
            grid=(n_tiles,),
            in_specs=[whole(x) for x in tables] + [tile_spec] * len(pops),
            out_specs=[tile_spec, tile_spec,
                       pl.BlockSpec((n_part,), lambda i: (i,))],
            out_shape=[
                jax.ShapeDtypeStruct((n,), jnp.int32),
                jax.ShapeDtypeStruct((n,), jnp.float32),
                jax.ShapeDtypeStruct((n_tiles * n_part,), jnp.float32),
            ],
            compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=1),
            backend="triton",
            interpret=impl == "interpret",
            name="discrete_smc_init" if init else "discrete_smc_chunk",
        )(*tables, *pops)
        parts = parts.reshape(n_tiles, n_part)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    ess, cat_w, lme = _stats(parts, n, K)
    return DiscreteSweep(s, w, ess, cat_w, lme, parts)


def make_fused_discrete_ssm(
    trans,
    means,
    stds=None,
    init_probs=None,
    *,
    island_every: int = 0,
    island_thresh: float = 0.5,
    interpret: bool = False,
    reference: bool = False,
):
    """Build a :class:`StateSpaceModel` for a K-state HMM with Gaussian
    emissions ``y_t ~ N(means[z_t], stds[z_t])``: the XLA paths of any SSM
    plus the fused chunk and init hooks that ``build_smc_run`` drives.

    >>> ssm = make_fused_discrete_ssm(trans5, means5, stds5, island_every=8)
    >>> run = build_smc_run(ssm, 1 << 24, chunk=16)

    The hooks compile the Triton kernel, which needs a GPU: elsewhere the
    builder raises unless ``interpret=True`` (Pallas interpreter) or
    ``reference=True`` (the same tile function as plain XLA, same bits).
    ``island_every`` > 0 adds tile-local ESS checks inside a chunk, so a
    whole-sweep chunk keeps the adaptive trigger live."""
    from ..inference.smc import StateSpaceModel

    trans = np.asarray(trans, np.float64)
    K = trans.shape[0]
    if trans.ndim != 2 or trans.shape != (K, K):
        raise ValueError(f"transition matrix must be square, got {trans.shape}")
    if not np.allclose(trans.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("transition rows must sum to 1")
    if K > _MAX_STATES:
        raise ValueError(
            f"K={K}: the kernel unrolls K-1 CDF loads per step and supports "
            f"K <= {_MAX_STATES}; use the XLA path for larger state spaces"
        )
    means = np.asarray(means, np.float64).reshape(K)
    stds = (np.ones(K) if stds is None
            else np.asarray(stds, np.float64)).reshape(K)
    if np.any(stds <= 0):
        raise ValueError("emission stds must be positive")
    init_probs = (np.full(K, 1.0 / K) if init_probs is None
                  else np.asarray(init_probs, np.float64).reshape(K))
    if island_every % 2:
        raise ValueError("island_every must be even")
    if interpret and reference:
        raise ValueError("pass at most one of interpret and reference")
    impl = "interpret" if interpret else "reference" if reference else "kernel"
    if impl == "kernel" and jax.default_backend() != "gpu":
        raise RuntimeError(
            "make_fused_discrete_ssm compiles a Triton kernel and needs a GPU "
            f"(backend is {jax.default_backend()!r}); pass interpret=True or "
            "reference=True to run it elsewhere"
        )

    cdf_rows = np.concatenate([np.cumsum(trans, axis=1),
                               np.cumsum(init_probs)[None]], axis=0)
    cdf_j = _pow2_pad(cdf_rows.ravel().astype(np.float32))
    means_j = jnp.asarray(means, jnp.float32)
    stds_j = jnp.asarray(stds, jnp.float32)
    inv2var_j = jnp.asarray(0.5 / stds**2, jnp.float32)
    lognorm_j = jnp.asarray(-np.log(stds) - _HALF_LOG_2PI, jnp.float32)
    log_trans = jnp.asarray(np.log(np.maximum(trans, 1e-38)), jnp.float32)
    log_init = jnp.asarray(np.log(np.maximum(init_probs, 1e-38)), jnp.float32)
    sweep_kw = dict(K=K, island_every=island_every,
                    island_thresh=island_thresh, impl=impl)

    def emission_table(ys):
        d = jnp.asarray(ys, jnp.float32)[:, None] - means_j[None, :]
        return _pow2_pad((-(d * d) * inv2var_j + lognorm_j).ravel())

    def keys_of(key):
        return jax.random.bits(key, (2,), jnp.uint32)

    def ctrl_of(flag, ticks, n_valid):
        return jnp.concatenate([
            jnp.asarray(flag, jnp.int32).reshape(1),
            jnp.asarray(ticks, jnp.int32).reshape(K - 1),
            jnp.asarray(n_valid, jnp.int32).reshape(1),
        ])

    def fused_chunk(key, states, log_w, ys, n_valid, flag, ticks,
                    partials=False):
        """The engine's chunk hook; ``partials=True`` returns the whole
        :class:`DiscreteSweep` (per-tile partials, islands fired)."""
        n_steps = ys.shape[0] + ys.shape[0] % 2
        ys = jnp.pad(ys, (0, n_steps - ys.shape[0]))
        out = discrete_sweep(
            keys_of(key), states, log_w, _pow2_pad(ctrl_of(flag, ticks,
                                                             n_valid)),
            cdf_j, emission_table(ys), n=states.shape[0], n_steps=n_steps,
            **sweep_kw)
        return out if partials else out[:5]

    def fused_init(key, n, y0):
        ctrl = _pow2_pad(ctrl_of(0, jnp.zeros((K - 1,), jnp.int32), 1))
        out = discrete_sweep(
            keys_of(key), None, None, ctrl, cdf_j,
            emission_table(jnp.reshape(y0, (1,))), n=n, n_steps=2,
            init=True, **sweep_kw)
        return out[:5]

    def obs_logpdf(s, y, t):
        d = y - means_j[s]
        return -(d * d) * inv2var_j[s] + lognorm_j[s]

    return StateSpaceModel(
        init_sample=lambda key: jax.random.categorical(key, log_init),
        init_logpdf=lambda s: log_init[s],
        step_sample=lambda key, s, t: jax.random.categorical(key,
                                                             log_trans[s]),
        # engine convention: step_logpdf(new_state, state, t)
        step_logpdf=lambda s_new, s, t: log_trans[s, s_new],
        obs_logpdf=obs_logpdf,
        init_sample_batch=lambda key, n: jax.random.categorical(
            key, log_init, shape=(n,)
        ),
        step_sample_batch=lambda key, states, t: jax.random.categorical(
            key, log_trans[states], axis=-1
        ),
        obs_logpdf_batch=obs_logpdf,
        obs_sample=lambda key, s, t: means_j[s]
        + stds_j[s] * jax.random.normal(key, ()),
        state_categories=K,
        fused_chunk_exchange_batch=fused_chunk,
        fused_init_batch=fused_init,
    )
