"""ChEES-HMC: cross-chain adaptive trajectory lengths (Hoffman, Radul &
Sountsov 2021; used inside SMC samplers by arXiv:2504.02627).

The jittered-HMC kernel (see :mod:`cpprob_jax.inference.hmc`) leaves the mean
trajectory length as a hyperparameter; ChEES tunes it by gradient ascent on
the Change in the Estimator of the Expected Squared jump distance:

    g ∝ E_chains[ a · (||z'-z̄'||² - ||z-z̄||²) · ((z'-z̄')·p') ]

where a is the acceptance probability and the means are **across chains** —
exactly the cross-chain adaptation shape this framework uses for step size and
mass (a ``pmean`` when chains shard over hosts).  All chains execute the same
static-bound leapfrog loop with a masked readout, so the adaptation never
breaks SIMD lockstep.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .hmc import HMCResult, _dual_averaging_init, _dual_averaging_update
from .potential import FlatModel, flatten_model

__all__ = ["chees_hmc"]


def _halton(i, base=2):
    """Low-discrepancy jitter sequence (float in (0,1)) — traced-friendly."""
    # 16-bit radical inverse in the given base
    result = jnp.zeros_like(i, dtype=jnp.float32)
    f = jnp.float32(1.0 / base)
    ii = i
    for _ in range(16):
        result = result + f * (ii % base).astype(jnp.float32)
        ii = ii // base
        f = f / base
    return jnp.clip(result, 1e-3, 1.0)


def chees_hmc(
    model: Callable,
    args: Tuple,
    key: jax.Array,
    *,
    n_samples: int = 1000,
    n_warmup: int = 800,
    n_chains: int = 16,
    max_leapfrog: int = 64,
    initial_step_size: float = 0.1,
    initial_traj_length: float = 1.0,
    target_accept: float = 0.75,
    traj_learning_rate: float = 0.025,
    flat: Optional[FlatModel] = None,
    jit: bool = True,
) -> HMCResult:
    """Adaptive HMC with ChEES trajectory-length tuning.  Returns the same
    result type as :func:`cpprob_jax.inference.hmc.hmc`."""
    flat = flat or flatten_model(model, args)
    dim = flat.dim
    grad_fn = jax.grad(flat.potential)

    def kernel(key, z, eps, inv_mass, n_sel):
        """One chain transition with readout at leapfrog step ``n_sel``."""
        k_mom, k_acc = jax.random.split(key)
        p = jax.random.normal(k_mom, z.shape) / jnp.sqrt(inv_mass)

        def body(carry, i):
            z_c, p_c, z_keep, p_keep = carry
            p_half = p_c - 0.5 * eps * grad_fn(z_c)
            z_n = z_c + eps * inv_mass * p_half
            p_n = p_half - 0.5 * eps * grad_fn(z_n)
            take = i + 1 == n_sel
            z_keep = jnp.where(take, z_n, z_keep)
            p_keep = jnp.where(take, p_n, p_keep)
            return (z_n, p_n, z_keep, p_keep), None

        (_, _, z_new, p_new), _ = jax.lax.scan(
            body, (z, p, z, p), jnp.arange(max_leapfrog)
        )

        def h(zz, pp):
            return flat.potential(zz) + 0.5 * jnp.sum(inv_mass * pp * pp)

        log_accept = jnp.minimum(0.0, h(z, p) - h(z_new, p_new))
        log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
        accept_p = jnp.exp(log_accept)
        accept = jnp.log(jax.random.uniform(k_acc, ())) < log_accept
        z_out = jnp.where(accept, z_new, z)
        return z_out, z_new, p_new, accept_p

    vkernel = jax.vmap(kernel, in_axes=(0, 0, None, None, None))

    def chees_grad(z, z_prop, p_prop, accept_p):
        zb = jnp.mean(z, axis=0)
        zpb = jnp.mean(z_prop, axis=0)
        dz = jnp.sum((z_prop - zpb) ** 2, axis=1) - jnp.sum((z - zb) ** 2, axis=1)
        proj = jnp.sum((z_prop - zpb) * p_prop, axis=1)
        w = accept_p
        g = jnp.sum(w * dz * proj) / jnp.maximum(jnp.sum(w), 1e-6)
        return g

    def run(key):
        key, k_init = jax.random.split(key)
        z0 = jax.vmap(flat.initial_position)(jax.random.split(k_init, n_chains))

        da0 = _dual_averaging_init(initial_step_size)
        welford0 = (jnp.zeros((dim,)), jnp.zeros((dim,)), jnp.zeros(()))
        log_T0 = jnp.log(initial_traj_length)
        adam0 = (jnp.zeros(()), jnp.zeros(()))  # m, v for log_T

        def warm_step(carry, inp):
            i, k = inp
            z, da, welford, log_T, adam = carry
            w_mean, w_m2, w_n = welford
            eps = jnp.exp(da["log_eps"])
            inv_mass = jnp.where(
                w_n > 10.0,
                jnp.maximum(w_m2 / jnp.maximum(w_n - 1.0, 1.0), 1e-3),
                jnp.ones((dim,)),
            )
            # jittered trajectory: halton(i) * T / eps leapfrogs
            u = _halton(i)
            n_sel = jnp.clip(
                jnp.ceil(u * jnp.exp(log_T) / eps).astype(jnp.int32),
                1, max_leapfrog,
            )
            keys = jax.random.split(k, n_chains)
            z_new, z_prop, p_prop, acc = vkernel(keys, z, eps, inv_mass, n_sel)

            # ChEES update on log T (Adam), normalized gradient
            g = chees_grad(z, z_prop, p_prop, acc)
            m, v = adam
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            log_T = log_T + traj_learning_rate * m / (jnp.sqrt(v) + 1e-8)
            log_T = jnp.clip(
                log_T,
                jnp.log(eps),
                jnp.log(eps * max_leapfrog),
            )

            da = _dual_averaging_update(da, jnp.mean(acc), target_accept)
            zm = jnp.mean(z_new, axis=0)
            delta = zm - w_mean
            w_n = w_n + 1.0
            w_mean = w_mean + delta / w_n
            w_m2 = w_m2 + delta * (zm - w_mean)
            return (z_new, da, (w_mean, w_m2, w_n), log_T, (m, v)), None

        key, k_warm = jax.random.split(key)
        (z, da, welford, log_T, _), _ = jax.lax.scan(
            warm_step,
            (z0, da0, welford0, log_T0, adam0),
            (jnp.arange(n_warmup), jax.random.split(k_warm, n_warmup)),
        )
        eps = jnp.exp(da["log_eps_bar"])
        w_mean, w_m2, w_n = welford
        inv_mass = jnp.where(
            w_n > 10.0,
            jnp.maximum(w_m2 / jnp.maximum(w_n - 1.0, 1.0), 1e-3),
            jnp.ones((dim,)),
        )

        def samp_step(z, inp):
            i, k = inp
            u = _halton(i + n_warmup)
            n_sel = jnp.clip(
                jnp.ceil(u * jnp.exp(log_T) / eps).astype(jnp.int32),
                1, max_leapfrog,
            )
            keys = jax.random.split(k, n_chains)
            z, _, _, acc = vkernel(keys, z, eps, inv_mass, n_sel)
            pe = jax.vmap(flat.potential)(z)
            return z, (z, acc, pe)

        key, k_samp = jax.random.split(key)
        z, (zs, accs, pes) = jax.lax.scan(
            samp_step, z,
            (jnp.arange(n_samples), jax.random.split(k_samp, n_samples)),
        )
        zs = jnp.swapaxes(zs, 0, 1)
        accs = jnp.mean(jnp.swapaxes(accs, 0, 1), axis=1)
        pes = jnp.swapaxes(pes, 0, 1)
        return zs, accs, pes, eps, inv_mass, jnp.exp(log_T)

    if jit:
        run = jax.jit(run)
    zs, accs, pes, eps, inv_mass, traj = run(key)
    constrained = jax.vmap(jax.vmap(flat.constrain))(zs)
    return HMCResult(zs, constrained, accs, eps, inv_mass, pes)
