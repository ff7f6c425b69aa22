"""Adaptive tempered SMC sampler for *arbitrary* models (static latents).

Complements :mod:`cpprob_jax.inference.smc` (which needs a sequential
decomposition): here SMC moves a particle population from the prior to the
posterior through a likelihood-tempered path

    pi_beta(z) ∝ p(z) · L(z)^beta,   0 = beta_0 < ... < beta_K = 1,

with (1) adaptive tempering — the next beta is chosen by bisection so the
incremental weights keep a target conditional ESS, (2) systematic resampling,
and (3) HMC rejuvenation moves targeting pi_beta.  This is the standard
SMC-sampler recipe ('An invitation to sequential Monte Carlo samplers',
arXiv:2007.11936), built for the compiler: the whole run is one jitted
``lax.while_loop`` over temperature epochs with vmapped particles, and the
number of epochs is bounded statically.

Gives: posterior samples for models where SIS weights would degenerate, plus
an unbiased log-evidence estimate — none of which the reference can do
(it has neither SMC nor MCMC; SURVEY.md §6).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special

from ..core import handlers
from .potential import FlatModel, flatten_model
from .resampling import systematic_resample

__all__ = ["TemperedSMCResult", "smc_sampler"]


class TemperedSMCResult(NamedTuple):
    positions: jax.Array        # (N, dim) unconstrained posterior particles
    samples: dict               # addr -> (N, ...) constrained
    log_evidence: jax.Array     # scalar
    n_stages: jax.Array         # temperature epochs used
    betas_used: jax.Array       # (max_stages,) padded with 1.0
    accept_rate: jax.Array      # mean HMC-move acceptance over the run


def _split_log_joint(model: Callable, args: Tuple, flat: FlatModel):
    """log prior density and log likelihood as separate functions of flat z.

    Prior = sum of sample-site log-probs (+ transform Jacobians);
    likelihood = sum of observe/factor contributions.
    """

    def unpack(z):
        values = {}
        jac = jnp.zeros(())
        i = 0
        for l in flat.latents:
            zi = z[i : i + l.size].reshape(l.shape)
            values[l.addr] = l.transform.forward(zi)
            jac = jac + jnp.sum(l.transform.log_det(zi))
            i += l.size
        return values, jac

    def log_prior(z):
        values, jac = unpack(z)
        # accumulate only sample-site priors via a trace
        tr = handlers.TraceHandler()
        with handlers.Substitute(values), tr:
            model(*args)
        total = jac
        for name, site in tr.trace.items():
            if site["type"] == "sample" and not site["is_observed"]:
                total = total + jnp.sum(site["dist"].log_prob(site["value"]))
        return total

    def log_lik(z):
        values, _ = unpack(z)
        lw = handlers.LogWeight()
        with handlers.Substitute(values), lw:
            model(*args)
        return lw.log_weight

    return log_prior, log_lik


def smc_sampler(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key: jax.Array,
    *,
    target_cess: float = 0.9,
    n_hmc_moves: int = 2,
    hmc_step_size: float = 0.2,
    hmc_leapfrogs: int = 8,
    max_stages: int = 50,
    waste_free: bool = False,
    chain_length: int = 8,
    flat: Optional[FlatModel] = None,
    jit: bool = True,
) -> TemperedSMCResult:
    """Adaptive likelihood-tempered SMC from prior to posterior.

    ``waste_free=True`` switches the move step to waste-free SMC (Dau &
    Chopin, JRSS-B 2022): instead of every particle running ``n_hmc_moves``
    and discarding the intermediate states, ``n_particles // chain_length``
    ancestors are resampled and each runs a length-``chain_length`` HMC chain
    whose **every** state (including the start) enters the next population.
    Same MCMC budget, P× the effective population — all intermediate
    computation is kept, none is wasted.  Requires
    ``n_particles % chain_length == 0``.
    """
    if waste_free:
        if chain_length < 2:
            raise ValueError("waste_free needs chain_length >= 2")
        if n_particles % chain_length != 0:
            raise ValueError(
                "n_particles must be divisible by chain_length "
                f"({n_particles} % {chain_length} != 0)"
            )
    n_roots = n_particles // chain_length if waste_free else n_particles
    flat = flat or flatten_model(model, args)
    dim = flat.dim
    log_prior, log_lik = _split_log_joint(model, args, flat)
    v_log_lik = jax.vmap(log_lik)

    def tempered_potential(z, beta):
        return -(log_prior(z) + beta * log_lik(z))

    grad_pot = jax.grad(tempered_potential, argnums=0)

    def hmc_move(key, z, beta, eps):
        k_mom, k_acc = jax.random.split(key)
        p = jax.random.normal(k_mom, z.shape)

        def leap(carry, _):
            z, p = carry
            p = p - 0.5 * eps * grad_pot(z, beta)
            z = z + eps * p
            p = p - 0.5 * eps * grad_pot(z, beta)
            return (z, p), None

        (z_new, p_new), _ = jax.lax.scan(leap, (z, p), None, length=hmc_leapfrogs)
        h0 = tempered_potential(z, beta) + 0.5 * jnp.sum(p * p)
        h1 = tempered_potential(z_new, beta) + 0.5 * jnp.sum(p_new * p_new)
        log_a = jnp.minimum(0.0, h0 - h1)
        log_a = jnp.where(jnp.isnan(log_a), -jnp.inf, log_a)
        accept = jnp.log(jax.random.uniform(k_acc, ())) < log_a
        return jnp.where(accept, z_new, z), jnp.exp(log_a)

    def next_beta(beta, loglik):
        """Bisect for beta' in (beta, 1] with conditional ESS ~ target."""

        def cess(b):
            lw = (b - beta) * loglik
            lw = lw - jnp.max(lw)
            w = jnp.exp(lw)
            return (jnp.sum(w) ** 2) / (n_particles * jnp.sum(w * w))

        def body(_, carry):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            ok = cess(mid) >= target_cess
            return jax.lax.cond(
                ok, lambda: (mid, hi), lambda: (lo, mid)
            )

        ok_full = cess(1.0) >= target_cess
        lo, hi = jax.lax.fori_loop(0, 20, body, (beta, 1.0))
        return jnp.where(ok_full, 1.0, lo)

    def run(key):
        key, k_init = jax.random.split(key)
        zs = jax.vmap(flat.initial_position)(
            jax.random.split(k_init, n_particles)
        )

        def cond(state):
            _, _, beta, _, _, stage, _, _ = state
            return (beta < 1.0) & (stage < max_stages)

        def body(state):
            key, zs, beta, log_z, betas, stage, acc_sum, acc_n = state
            loglik = v_log_lik(zs)
            beta_new = next_beta(beta, loglik)
            lw = (beta_new - beta) * loglik
            log_z = log_z + jsp_special.logsumexp(lw) - jnp.log(
                jnp.asarray(n_particles, jnp.float32)
            )
            key, k_res, k_mov = jax.random.split(key, 3)
            if waste_free:
                # resample M = N/P roots; every chain state (root included)
                # becomes a particle of the next population
                anc = systematic_resample(k_res, lw, n_out=n_roots)
                roots = zs[anc]

                def one_chain(key, z):
                    def mv(carry, k):
                        z, a_sum = carry
                        z, a = hmc_move(k, z, beta_new, hmc_step_size)
                        return (z, a_sum + a), z

                    (zf, a_sum), path = jax.lax.scan(
                        mv, (z, jnp.zeros(())),
                        jax.random.split(key, chain_length - 1),
                    )
                    chain = jnp.concatenate([z[None], path], axis=0)  # (P, dim)
                    return chain, a_sum / (chain_length - 1)

                chains, accs = jax.vmap(one_chain)(
                    jax.random.split(k_mov, n_roots), roots
                )
                zs = chains.reshape(n_particles, dim)
            else:
                anc = systematic_resample(k_res, lw)
                zs = zs[anc]

                def one_move(key, z):
                    def mv(carry, k):
                        z, a_sum = carry
                        z, a = hmc_move(k, z, beta_new, hmc_step_size)
                        return (z, a_sum + a), None

                    (z, a_sum), _ = jax.lax.scan(
                        mv, (z, jnp.zeros(())),
                        jax.random.split(key, n_hmc_moves),
                    )
                    return z, a_sum / n_hmc_moves

                zs, accs = jax.vmap(one_move)(
                    jax.random.split(k_mov, n_particles), zs
                )
            betas = betas.at[stage].set(beta_new)
            return (
                key, zs, beta_new, log_z, betas, stage + 1,
                acc_sum + jnp.mean(accs), acc_n + 1.0,
            )

        betas0 = jnp.ones((max_stages,))
        state = (
            key, zs, jnp.zeros(()), jnp.zeros(()), betas0, jnp.int32(0),
            jnp.zeros(()), jnp.zeros(()),
        )
        key, zs, beta, log_z, betas, stage, acc_sum, acc_n = (
            jax.lax.while_loop(cond, body, state)
        )
        return zs, log_z, stage, betas, acc_sum / jnp.maximum(acc_n, 1.0)

    if jit:
        run = jax.jit(run)
    zs, log_z, stage, betas, acc = run(key)
    samples = jax.vmap(flat.constrain)(zs)
    return TemperedSMCResult(zs, samples, log_z, stage, betas, acc)
