"""Guided SMC: learned per-step proposals for state-space models.

Combines the two headline engines — SMC (per-step resampling) and inference
compilation (amortized proposals) — a capability beyond the reference (which
has neither SMC nor proposals for sequential models; its thesis ran SMC in
Anglican, ch. 6.3).

A small MLP q(z_t | z_{t-1}, y_t) is trained on prior rollouts of the SSM to
approximate the locally-optimal proposal; at inference it plugs into
:func:`cpprob_jax.inference.smc.smc` through the ``proposal_sample`` /
``proposal_logpdf`` hooks, with the Radon–Nikodym correction keeping the
estimator exact.  Currently supports discrete-state SSMs (categorical
proposal head) and scalar-Gaussian SSMs (normal head).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from . import nn
from .smc import StateSpaceModel

__all__ = ["train_ssm_proposal", "guide_ssm"]


def _make_net(key, in_dim, out_dim, hidden=64):
    return nn.mlp_init(key, [in_dim, hidden, hidden, out_dim])


def train_ssm_proposal(
    model: StateSpaceModel,
    key: jax.Array,
    T: int,
    *,
    kind: str,                   # 'discrete' (n_states) or 'normal'
    n_states: int = 0,
    steps: int = 300,
    batch_size: int = 256,
    learning_rate: float = 1e-3,
    hidden: int = 64,
):
    """Train q(z_t | z_{t-1}, y_t) to match the smoothing-consistent
    conditional p(z_t | z_{t-1}, y_t) ∝ p(z_t|z_{t-1}) p(y_t|z_t) by maximum
    likelihood on prior rollouts (z, y both simulated — amortized over y like
    CSIS's compile mode).

    Returns (params, losses).  Input features: [embed(z_{t-1}), y_t, t/T].
    """
    if kind == "discrete":
        in_dim = n_states + 2
        out_dim = n_states
    elif kind == "normal":
        in_dim = 3
        out_dim = 2
    else:
        raise ValueError(f"unknown proposal kind {kind!r}")

    key, k_net = jax.random.split(key)
    params = _make_net(k_net, in_dim, out_dim, hidden)

    def features(z_prev, y, t):
        tf = jnp.asarray(t, jnp.float32) / T
        if kind == "discrete":
            return jnp.concatenate(
                [jax.nn.one_hot(z_prev, n_states),
                 jnp.asarray(y, jnp.float32)[None], tf[None]]
            )
        return jnp.stack([jnp.asarray(z_prev, jnp.float32),
                          jnp.asarray(y, jnp.float32), tf])

    def rollout(key):
        """One prior trajectory with simulated observations — the compile-mode
        analogue for SSMs (needs ``model.obs_sample(key, state, t)``)."""
        k_init, k_rest = jax.random.split(key)
        z0 = model.init_sample(k_init)

        def step(carry, t):
            z, k = carry
            k, kz, ky = jax.random.split(k, 3)
            z_new = model.step_sample(kz, z, t)
            y = _obs_sample(ky, z_new, t)
            return (z_new, k), (z, z_new, y)

        k0, ky0 = jax.random.split(k_rest)
        y0 = _obs_sample(ky0, z0, 0)
        (zT, _), (z_prevs, z_news, ys) = jax.lax.scan(
            step, (z0, k0), jnp.arange(1, T)
        )
        return z_prevs, z_news, ys  # each (T-1, ...)

    _obs_sample = model.obs_sample
    if _obs_sample is None:
        raise ValueError(
            "train_ssm_proposal needs model.obs_sample(key, state, t); "
            "set the StateSpaceModel.obs_sample field"
        )

    def loss_fn(params, key):
        keys = jax.random.split(key, batch_size)
        z_prevs, z_news, ys = jax.vmap(rollout)(keys)  # (B, T-1, ...)
        ts = jnp.broadcast_to(jnp.arange(1, T), (batch_size, T - 1))

        def site_nll(z_prev, z_new, y, t):
            x = features(z_prev, y, t)
            raw = nn.mlp_apply(params, x)
            if kind == "discrete":
                logp = jax.nn.log_softmax(raw)
                return -logp[z_new]
            mean, log_std = raw[0], raw[1]
            std = nn.softplus(log_std)
            d = (jnp.asarray(z_new, jnp.float32) - mean) / std
            return 0.5 * d * d + jnp.log(std) + 0.9189385332046727

        nll = jax.vmap(jax.vmap(site_nll))(z_prevs, z_news, ys, ts)
        return jnp.mean(jnp.sum(nll, axis=1))

    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, key)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = train_step(params, opt_state, sub)
        losses.append(loss)
    return params, jnp.stack(losses)


def guide_ssm(
    model: StateSpaceModel,
    params,
    T: int,
    *,
    kind: str,
    n_states: int = 0,
) -> StateSpaceModel:
    """Return a copy of ``model`` with the trained proposal installed (SMC
    then runs in guided mode with exact RN weights)."""

    def features(z_prev, y, t):
        tf = jnp.asarray(t, jnp.float32) / T
        if kind == "discrete":
            return jnp.concatenate(
                [jax.nn.one_hot(z_prev, n_states),
                 jnp.asarray(y, jnp.float32)[None], tf[None]]
            )
        return jnp.stack([jnp.asarray(z_prev, jnp.float32),
                          jnp.asarray(y, jnp.float32), tf])

    def proposal_sample(key, z_prev, t, y):
        raw = nn.mlp_apply(params, features(z_prev, y, t))
        if kind == "discrete":
            return jax.random.categorical(key, jax.nn.log_softmax(raw))
        mean, log_std = raw[0], raw[1]
        return mean + nn.softplus(log_std) * jax.random.normal(key, ())

    def proposal_logpdf(z_new, z_prev, t, y):
        raw = nn.mlp_apply(params, features(z_prev, y, t))
        if kind == "discrete":
            return jax.nn.log_softmax(raw)[z_new]
        mean, log_std = raw[0], raw[1]
        std = nn.softplus(log_std)
        d = (jnp.asarray(z_new, jnp.float32) - mean) / std
        return -0.5 * d * d - jnp.log(std) - 0.9189385332046727

    return dataclasses.replace(
        model,
        proposal_sample=proposal_sample,
        proposal_logpdf=proposal_logpdf,
        # guided mode bypasses the batched fast paths
        step_sample_batch=None,
        obs_logpdf_batch=None,
    )
