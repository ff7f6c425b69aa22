"""Neural building blocks for inference compilation — pure pytree params +
functions (no framework), so the proposal network lives *inside* the jitted
particle kernel and batches over particles on the MXU.

Counterparts of the reference's PyTorch modules:
- MLP value/observation embeddings (``infcomp/distributions/embeddings.py:26-46``,
  ``infcomp/nn/observation.py:16-36``)
- bounded-integer embedding lookup (``embeddings.py:74-87``)
- 2-layer LSTM core, hidden 128 (``infcomp/nn/nn.py:32-38``, ``settings.py:15``)
- constraint projections: softplus for positive params, logsoftmax for
  simplices, sigmoid interval mapping (``infcomp/distributions/projections.py``)
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "mlp_init",
    "mlp_apply",
    "embedding_init",
    "embedding_lookup",
    "lstm_init",
    "lstm_obs_gate",
    "lstm_step",
    "lstm_step_split",
    "lstm_zero_state",
    "lstm_embed_sequence",
    "conv3d_init",
    "conv3d_apply",
    "softplus",
    "EMBEDDING_DIM",
]

EMBEDDING_DIM = 128  # reference default (settings.py:15)


def softplus(x):
    return jax.nn.softplus(x) + 1e-6


def _kaiming(key, shape, fan_in):
    # Kaiming-normal init, matching the reference's init scheme (util.py:107-112)
    return jax.random.normal(key, shape) * math.sqrt(2.0 / max(fan_in, 1))


def mlp_init(key, sizes: Sequence[int]) -> List[Dict[str, jax.Array]]:
    """MLP with ReLU hidden activations; ``sizes = [in, h1, ..., out]``."""
    layers = []
    for i in range(len(sizes) - 1):
        key, sub = jax.random.split(key)
        layers.append(
            {
                "w": _kaiming(sub, (sizes[i], sizes[i + 1]), sizes[i]),
                "b": jnp.zeros((sizes[i + 1],)),
            }
        )
    return layers


def mlp_apply(layers, x):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = jax.nn.relu(x)
    return x


def embedding_init(key, num: int, dim: int):
    return jax.random.normal(key, (num, dim)) * 0.1


def embedding_lookup(table, idx):
    return table[jnp.asarray(idx, jnp.int32)]


def lstm_init(key, input_dim: int, hidden: int, layers: int = 2):
    """Stacked LSTM params (reference: 2 layers, nn.py:36-40)."""
    params = []
    for l in range(layers):
        in_dim = input_dim if l == 0 else hidden
        key, k1, k2 = jax.random.split(key, 3)
        params.append(
            {
                "wx": _kaiming(k1, (in_dim, 4 * hidden), in_dim),
                "wh": _kaiming(k2, (hidden, 4 * hidden), hidden),
                "b": jnp.zeros((4 * hidden,)),
            }
        )
    return params


def lstm_zero_state(params, batch_shape: Tuple[int, ...] = ()):
    hidden = params[0]["wh"].shape[0]
    return [
        (
            jnp.zeros(batch_shape + (hidden,)),
            jnp.zeros(batch_shape + (hidden,)),
        )
        for _ in params
    ]


def lstm_embed_sequence(params, xs):
    """Observation-sequence embedding: run the stacked LSTM over the leading
    axis of ``xs`` (T, ..., input_dim), return the last top-layer output —
    counterpart of ``ObserveEmbeddingLSTM`` (``observation.py:39-53``)."""
    batch_shape = xs.shape[1:-1]
    state0 = lstm_zero_state(params, batch_shape)

    def body(state, x):
        h, state = lstm_step(params, x, state)
        return state, h

    _, hs = jax.lax.scan(body, state0, xs)
    return hs[-1]


def conv3d_init(key, channels=(1, 4, 8), kernel: int = 3, out_dim: int = EMBEDDING_DIM):
    """3-D CNN observation embedding — counterpart of
    ``ObserveEmbeddingCNN3D4C`` (``observation.py:56-93``) for volumetric
    observations (e.g. the 35x35x20 calorimeter)."""
    params = {"convs": [], "head": None}
    for cin, cout in zip(channels[:-1], channels[1:]):
        key, sub = jax.random.split(key)
        fan_in = cin * kernel**3
        params["convs"].append(
            {
                "w": _kaiming(sub, (cout, cin, kernel, kernel, kernel), fan_in),
                "b": jnp.zeros((cout,)),
            }
        )
    key, sub = jax.random.split(key)
    params["head"] = mlp_init(sub, [channels[-1], out_dim])
    return params


def conv3d_apply(params, vol):
    """``vol``: (..., D, H, W) -> (..., out_dim).  Per-volume standardization,
    SAME conv stack + ReLU, global average pool, dense head.

    The standardization is load-bearing at calorimeter scale: raw deposits
    are O(0.005-0.1) GeV spread over tens of thousands of mostly-zero
    voxels, so without it the mean-pooled activations (and their gradients)
    vanish and training plateaus at the prior (loss = ln K exactly)."""
    batch_shape = vol.shape[:-3]
    x = vol.reshape((-1, 1) + vol.shape[-3:])  # (N, C=1, D, H, W)
    mu = jnp.mean(x, axis=(-3, -2, -1), keepdims=True)
    sd = jnp.std(x, axis=(-3, -2, -1), keepdims=True)
    x = (x - mu) / (sd + 1e-6)
    for conv in params["convs"]:
        x = jax.lax.conv_general_dilated(
            x, conv["w"], window_strides=(1, 1, 1), padding="SAME",
            dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
        ) + conv["b"][None, :, None, None, None]
        x = jax.nn.relu(x)
    x = jnp.mean(x, axis=(-3, -2, -1))          # global average pool -> (N, C)
    x = mlp_apply(params["head"], x)
    return x.reshape(batch_shape + (x.shape[-1],))


def _lstm_cell(layer_params, x_gates, h, c):
    gates = x_gates + h @ layer_params["wh"] + layer_params["b"]
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    i = jax.nn.sigmoid(i)
    f = jax.nn.sigmoid(f + 1.0)  # forget-gate bias 1
    g = jnp.tanh(g)
    o = jax.nn.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * jnp.tanh(c_new)
    return h_new, c_new


def lstm_step(params, x, state):
    """One step of the stacked LSTM.  ``x``: (..., input_dim); ``state``:
    list of (h, c) per layer.  Returns (top_h, new_state)."""
    new_state = []
    inp = x
    for layer_params, (h, c) in zip(params, state):
        h_new, c_new = _lstm_cell(layer_params, inp @ layer_params["wx"], h, c)
        new_state.append((h_new, c_new))
        inp = h_new
    return inp, new_state


def lstm_obs_gate(params, obs_emb):
    """Precompute the observation-embedding half of the layer-0 input gates.

    The proposal LSTM's layer-0 input is ``concat([value_emb, obs_emb])``
    (reference ``infcomp/nn/nn.py:32-38``); splitting the input dot as
    ``value_emb @ wx[:E] + obs_emb @ wx[E:]`` is exact (same contraction,
    reassociated) and lets this half be computed ONCE per trace instead of
    once per site — and, when ``obs_emb`` is fixed for a whole inference
    call, XLA folds it to a constant.
    """
    value_dim = params[0]["wx"].shape[0] - obs_emb.shape[-1]
    return obs_emb @ params[0]["wx"][value_dim:]


def lstm_step_split(params, x_val, obs_gate, state):
    """``lstm_step(params, concat([x_val, obs_emb]), state)`` with the
    observation contribution precomputed by :func:`lstm_obs_gate`."""
    lp0 = params[0]
    x_gates = x_val @ lp0["wx"][: x_val.shape[-1]] + obs_gate
    h_new, c_new = _lstm_cell(lp0, x_gates, *state[0])
    new_state = [(h_new, c_new)]
    inp = h_new
    for layer_params, (h, c) in zip(params[1:], state[1:]):
        h_new, c_new = _lstm_cell(layer_params, inp @ layer_params["wx"], h, c)
        new_state.append((h_new, c_new))
        inp = h_new
    return inp, new_state
