"""HMC with cross-chain adaptation — gradient-based engine over the trace
representation (north-star extension; the reference has no MCMC at all).

Design choices:

- Chains are a ``vmap`` axis: one jitted program advances all chains in
  lockstep; on a mesh, chains shard like particles.
- Trajectory lengths are **jittered** (uniform over [1, L]) rather than
  NUTS-style data-dependent: fixed-shape trajectories keep every chain on the
  same instruction stream, which vectorizes where NUTS's per-chain dynamic
  trees serialize (cf. 'Efficiently Vectorized MCMC on Modern Accelerators',
  arXiv:2503.17405).  A NUTS variant lives in :mod:`cpprob_jax.inference.nuts`.
- Warmup: dual-averaging step size (target accept 0.8) + Welford diagonal
  mass, both adapted on statistics averaged **across chains** (cross-chain
  adaptation as called for in BASELINE.json — a ``psum`` when chains shard
  over hosts).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .potential import FlatModel, flatten_model

__all__ = ["HMCResult", "hmc", "make_hmc_kernel"]


class HMCResult(NamedTuple):
    positions: jax.Array        # (n_chains, n_samples, dim) unconstrained
    samples: dict               # addr -> (n_chains, n_samples, ...) constrained
    accept_rate: jax.Array      # (n_chains,)
    step_size: jax.Array        # scalar, adapted
    inv_mass: jax.Array         # (dim,) adapted diagonal inverse mass
    potential_energy: jax.Array  # (n_chains, n_samples)


def make_hmc_kernel(
    potential: Callable,
    max_leapfrog: int,
    jitter: bool = True,
):
    """One transition for one chain: (key, z, eps, inv_mass) -> (z', accept_p,
    U(z')).  Jittered trajectory: all `max_leapfrog` steps run (static shape);
    the proposal is read out at a uniformly chosen step via a masked select —
    no dynamic shapes, MXU/VPU stays busy."""
    grad_fn = jax.grad(potential)

    def kernel(key, z, eps, inv_mass):
        k_mom, k_len, k_acc = jax.random.split(key, 3)
        p = jax.random.normal(k_mom, z.shape) / jnp.sqrt(inv_mass)

        if jitter:
            # pick the readout step uniformly in [1, max_leapfrog]
            n_sel = jax.random.randint(k_len, (), 1, max_leapfrog + 1)
        else:
            n_sel = jnp.asarray(max_leapfrog)

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
            return potential(zz) + 0.5 * jnp.sum(inv_mass * pp * pp)

        h0 = h(z, p)
        h1 = h(z_new, p_new)
        log_accept = jnp.minimum(0.0, h0 - h1)
        log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
        accept = jnp.log(jax.random.uniform(k_acc, ())) < log_accept
        z_out = jnp.where(accept, z_new, z)
        return z_out, jnp.exp(log_accept), potential(z_out)

    return kernel


def _dual_averaging_init(eps0):
    return {
        "log_eps": jnp.log(eps0),
        "log_eps_bar": jnp.log(eps0),
        "h_bar": jnp.zeros(()),
        "mu": jnp.log(10.0 * eps0),
        "t": jnp.zeros(()),
    }


def _dual_averaging_update(state, accept_prob, target=0.8):
    t = state["t"] + 1.0
    gamma, t0, kappa = 0.05, 10.0, 0.75
    h_bar = (1.0 - 1.0 / (t + t0)) * state["h_bar"] + (
        target - accept_prob
    ) / (t + t0)
    log_eps = state["mu"] - jnp.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state["log_eps_bar"]
    return {
        "log_eps": log_eps,
        "log_eps_bar": log_eps_bar,
        "h_bar": h_bar,
        "mu": state["mu"],
        "t": t,
    }


def hmc(
    model: Callable,
    args: Tuple,
    key: jax.Array,
    *,
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_chains: int = 4,
    max_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    jitter: bool = True,
    flat: Optional[FlatModel] = None,
    jit: bool = True,
) -> HMCResult:
    """Run adaptive HMC; returns constrained samples per latent address."""
    flat = flat or flatten_model(model, args)
    dim = flat.dim
    kernel = make_hmc_kernel(flat.potential, max_leapfrog, jitter)
    vkernel = jax.vmap(kernel, in_axes=(0, 0, None, None))

    def run(key):
        key, k_init = jax.random.split(key)
        z0 = jax.vmap(flat.initial_position)(jax.random.split(k_init, n_chains))

        # ---- warmup: dual averaging + Welford mass, cross-chain stats ----
        da0 = _dual_averaging_init(initial_step_size)
        welford0 = (
            jnp.zeros((dim,)),          # mean
            jnp.zeros((dim,)),          # M2
            jnp.zeros(()),              # count
        )

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
            # cross-chain mean accept drives one shared step size
            da = _dual_averaging_update(da, jnp.mean(acc), target_accept)
            # Welford over all chains' positions
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

        # ---- sampling ----
        def samp_step(z, k):
            keys = jax.random.split(k, n_chains)
            z, acc, pe = vkernel(keys, z, eps, inv_mass)
            return z, (z, acc, pe)

        key, k_samp = jax.random.split(key)
        z, (zs, accs, pes) = jax.lax.scan(
            samp_step, z, jax.random.split(k_samp, n_samples)
        )
        # (n_samples, n_chains, dim) -> (n_chains, n_samples, dim)
        zs = jnp.swapaxes(zs, 0, 1)
        accs = jnp.mean(jnp.swapaxes(accs, 0, 1), axis=1)
        pes = jnp.swapaxes(pes, 0, 1)
        return zs, accs, pes, eps, inv_mass

    if jit:
        run = jax.jit(run)
    zs, accs, pes, eps, inv_mass = run(key)
    constrained = jax.vmap(jax.vmap(flat.constrain))(zs)
    return HMCResult(zs, constrained, accs, eps, inv_mass, pes)
