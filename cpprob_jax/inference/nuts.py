"""NUTS — No-U-Turn Sampler, iterative jittable formulation.

North-star extension (the reference has no MCMC).  This is the standard
iterative tree-doubling algorithm with multinomial sampling within subtrees
and biased progressive sampling across doublings (Betancourt 2017), in the
checkpoint formulation that runs under ``jit``/``vmap`` with static bounds
(cf. NumPyro's iterative NUTS; 'Efficiently Vectorized MCMC on Modern
Accelerators', arXiv:2503.17405, for why fixed-bound trees matter on SIMD
hardware): a subtree of depth d needs only ``max_depth`` momentum checkpoints
for all internal U-turn checks.

Warmup shares the HMC machinery: dual-averaging step size on the mean
acceptance statistic + Welford diagonal mass with cross-chain statistics.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .hmc import HMCResult, _dual_averaging_init, _dual_averaging_update
from .potential import FlatModel, flatten_model

__all__ = ["nuts", "make_nuts_kernel"]

_MAX_DELTA_ENERGY = 1000.0


def _is_turning(inv_mass, r_left, r_right, r_sum):
    v_left = inv_mass * r_left
    v_right = inv_mass * r_right
    r_sum_c = r_sum - 0.5 * (r_left + r_right)
    return (jnp.dot(v_left, r_sum_c) <= 0) | (jnp.dot(v_right, r_sum_c) <= 0)


def _leaf_to_ckpt_idxs(n):
    """leaf index (within a subtree) -> (idx_min, idx_max) checkpoint range."""

    def bit_pos(state):
        x, c = state
        return x >> 1, c + 1

    x, idx_max = jax.lax.while_loop(
        lambda s: s[0] > 0, bit_pos, (n >> 1, jnp.int32(0))
    )

    def trailing_ones(state):
        x, c = state
        return x >> 1, c + 1

    _, num_subtrees = jax.lax.while_loop(
        lambda s: (s[0] & 1) == 1, trailing_ones, (n, jnp.int32(0))
    )
    idx_min = idx_max - num_subtrees + 1
    return idx_min, idx_max


def _iterative_turning(inv_mass, r_ckpts, r_sum_ckpts, r, r_sum, idx_min, idx_max):
    def cond(state):
        i, turning = state
        return (i >= idx_min) & (~turning)

    def body(state):
        i, _ = state
        subtree_r_sum = r_sum - r_sum_ckpts[i] + r_ckpts[i]
        turning = _is_turning(inv_mass, r_ckpts[i], r, subtree_r_sum)
        return i - 1, turning

    _, turning = jax.lax.while_loop(cond, body, (idx_max, False))
    return turning


class _TreeState(NamedTuple):
    z_left: jax.Array
    r_left: jax.Array
    z_right: jax.Array
    r_right: jax.Array
    z_prop: jax.Array
    log_weight: jax.Array     # log sum of exp(-dH) over tree leaves
    r_sum: jax.Array
    diverging: jax.Array
    turning: jax.Array
    sum_accept: jax.Array     # sum of min(1, exp(-dH)) for adaptation stat
    num_leaves: jax.Array


def make_nuts_kernel(
    potential: Callable,
    max_depth: int = 10,
):
    """One NUTS transition for one chain:
    ``kernel(key, z, eps, inv_mass) -> (z', mean_accept, U(z'))``."""
    grad_fn = jax.value_and_grad(potential)

    def leapfrog(z, r, eps, inv_mass):
        _, g = grad_fn(z)
        r = r - 0.5 * eps * g
        z = z + eps * inv_mass * r
        _, g = grad_fn(z)
        r = r - 0.5 * eps * g
        return z, r

    def energy(z, r, inv_mass):
        return potential(z) + 0.5 * jnp.sum(inv_mass * r * r)

    def build_subtree(key, z0, r0, direction, depth_count, eps, inv_mass, h0):
        """2^depth leapfrogs from (z0, r0) in ``direction``; multinomial
        proposal within the subtree; checkpointed internal U-turn checks.
        ``depth_count`` is dynamic; we run a while_loop up to it."""
        dim = z0.shape[0]
        signed_eps = direction * eps
        r_ckpts = jnp.zeros((max_depth + 1, dim))
        r_sum_ckpts = jnp.zeros((max_depth + 1, dim))

        def cond(state):
            k = state[0]
            ts = state[1]
            return (k < depth_count) & (~ts.turning) & (~ts.diverging)

        def body(state):
            k, ts, z, r, r_ckpts, r_sum_ckpts, key = state
            z, r = leapfrog(z, r, signed_eps, inv_mass)
            h = energy(z, r, inv_mass)
            delta = h - h0
            delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
            diverging = delta > _MAX_DELTA_ENERGY
            lw_leaf = -delta
            new_log_weight = jnp.logaddexp(ts.log_weight, lw_leaf)
            # multinomial within-subtree proposal
            key, k_acc = jax.random.split(key)
            take = jnp.log(jax.random.uniform(k_acc, ())) < (
                lw_leaf - new_log_weight
            )
            z_prop = jnp.where(take, z, ts.z_prop)
            r_sum = ts.r_sum + r
            accept_p = jnp.minimum(1.0, jnp.exp(-delta))

            idx_min, idx_max = _leaf_to_ckpt_idxs(k)
            is_even = (k & 1) == 0
            r_ckpts = jnp.where(
                is_even, r_ckpts.at[idx_max].set(r), r_ckpts
            )
            r_sum_ckpts = jnp.where(
                is_even, r_sum_ckpts.at[idx_max].set(r_sum), r_sum_ckpts
            )
            turning = jnp.where(
                is_even,
                False,
                _iterative_turning(
                    inv_mass, r_ckpts, r_sum_ckpts, r, r_sum, idx_min, idx_max
                ),
            )
            ts = _TreeState(
                ts.z_left, ts.r_left, z, r, z_prop, new_log_weight, r_sum,
                diverging, turning, ts.sum_accept + accept_p,
                ts.num_leaves + 1,
            )
            return k + 1, ts, z, r, r_ckpts, r_sum_ckpts, key

        ts0 = _TreeState(
            z0, r0, z0, r0, z0, -jnp.inf, jnp.zeros(dim),
            jnp.asarray(False), jnp.asarray(False), jnp.zeros(()),
            jnp.zeros(()),
        )
        _, ts, z, r, _, _, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), ts0, z0, r0, r_ckpts, r_sum_ckpts, key)
        )
        return ts

    def kernel(key, z, eps, inv_mass):
        dim = z.shape[0]
        key, k_mom = jax.random.split(key)
        r = jax.random.normal(k_mom, (dim,)) / jnp.sqrt(inv_mass)
        h0 = energy(z, r, inv_mass)

        init = _TreeState(
            z, r, z, r, z, jnp.zeros(()), r,
            jnp.asarray(False), jnp.asarray(False), jnp.zeros(()),
            jnp.ones(()),
        )

        def cond(state):
            depth, ts, _ = state
            return (depth < max_depth) & (~ts.turning) & (~ts.diverging)

        def body(state):
            depth, ts, key = state
            key, k_dir, k_sub, k_bias = jax.random.split(key, 4)
            direction = jnp.where(
                jax.random.bernoulli(k_dir, 0.5), 1.0, -1.0
            )
            z0 = jnp.where(direction > 0, ts.z_right, ts.z_left)
            r0 = jnp.where(direction > 0, ts.r_right, ts.r_left)
            sub = build_subtree(
                k_sub, z0, r0, direction, jnp.int32(1) << depth, eps,
                inv_mass, h0,
            )
            # biased progressive sampling across the doubling
            log_accept = jnp.minimum(0.0, sub.log_weight - ts.log_weight)
            take = jnp.log(jax.random.uniform(k_bias, ())) < log_accept
            take = take & (~sub.diverging) & (~sub.turning)
            z_prop = jnp.where(take, sub.z_prop, ts.z_prop)

            z_left = jnp.where(direction > 0, ts.z_left, sub.z_right)
            r_left = jnp.where(direction > 0, ts.r_left, sub.r_right)
            z_right = jnp.where(direction > 0, sub.z_right, ts.z_right)
            r_right = jnp.where(direction > 0, sub.r_right, ts.r_right)
            r_sum = ts.r_sum + sub.r_sum
            turning = sub.turning | _is_turning(
                inv_mass, r_left, r_right, r_sum
            )
            ts = _TreeState(
                z_left, r_left, z_right, r_right, z_prop,
                jnp.logaddexp(ts.log_weight, sub.log_weight), r_sum,
                sub.diverging, turning,
                ts.sum_accept + sub.sum_accept,
                ts.num_leaves + sub.num_leaves,
            )
            return depth + 1, ts, key

        _, ts, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), init, key))
        mean_accept = ts.sum_accept / jnp.maximum(ts.num_leaves - 1.0, 1.0)
        return ts.z_prop, mean_accept, potential(ts.z_prop)

    return kernel


def nuts(
    model: Callable,
    args: Tuple,
    key: jax.Array,
    *,
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_chains: int = 4,
    max_depth: int = 8,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    flat: Optional[FlatModel] = None,
    jit: bool = True,
) -> HMCResult:
    """Adaptive NUTS over the model's continuous latents; same result type and
    warmup scheme as :func:`cpprob_jax.inference.hmc.hmc`."""
    flat = flat or flatten_model(model, args)
    dim = flat.dim
    kernel = make_nuts_kernel(flat.potential, max_depth)
    vkernel = jax.vmap(kernel, in_axes=(0, 0, None, None))

    def run(key):
        key, k_init = jax.random.split(key)
        z0 = jax.vmap(flat.initial_position)(jax.random.split(k_init, n_chains))

        da0 = _dual_averaging_init(initial_step_size)
        welford0 = (jnp.zeros((dim,)), jnp.zeros((dim,)), jnp.zeros(()))

        def warm_step(carry, k):
            z, da, (w_mean, w_m2, w_n) = carry
            eps = jnp.exp(da["log_eps"])
            inv_mass = jnp.where(
                w_n > 10.0,
                jnp.maximum(w_m2 / jnp.maximum(w_n - 1.0, 1.0), 1e-3),
                jnp.ones((dim,)),
            )
            keys = jax.random.split(k, n_chains)
            z, acc, _ = vkernel(keys, z, eps, inv_mass)
            da = _dual_averaging_update(da, jnp.mean(acc), target_accept)
            zm = jnp.mean(z, axis=0)
            delta = zm - w_mean
            w_n = w_n + 1.0
            w_mean = w_mean + delta / w_n
            w_m2 = w_m2 + delta * (zm - w_mean)
            return (z, da, (w_mean, w_m2, w_n)), None

        (z, da, welford), _ = jax.lax.scan(
            warm_step, (z0, da0, welford0),
            jax.random.split(key, n_warmup + 1)[1:],
        )
        eps = jnp.exp(da["log_eps_bar"])
        w_mean, w_m2, w_n = welford
        inv_mass = jnp.where(
            w_n > 10.0,
            jnp.maximum(w_m2 / jnp.maximum(w_n - 1.0, 1.0), 1e-3),
            jnp.ones((dim,)),
        )

        def samp_step(z, k):
            keys = jax.random.split(k, n_chains)
            z, acc, pe = vkernel(keys, z, eps, inv_mass)
            return z, (z, acc, pe)

        key, k_samp = jax.random.split(key)
        z, (zs, accs, pes) = jax.lax.scan(
            samp_step, z, jax.random.split(k_samp, n_samples)
        )
        zs = jnp.swapaxes(zs, 0, 1)
        accs = jnp.mean(jnp.swapaxes(accs, 0, 1), axis=1)
        pes = jnp.swapaxes(pes, 0, 1)
        return zs, accs, pes, eps, inv_mass

    if jit:
        run = jax.jit(run)
    zs, accs, pes, eps, inv_mass = run(key)
    constrained = jax.vmap(jax.vmap(flat.constrain))(zs)
    return HMCResult(zs, constrained, accs, eps, inv_mass, pes)
