"""Load the JAX package's weights into the port.

The port's modules mirror the reference's module tree and parameter
names (`layers.0.self_attn.q_proj.weight`,
`ernie.embeddings.word_embeddings.weight`, ...) and keep its layouts
(`Linear.weight` is [in, out] and `Embedding.weight` [vocab, dim] in
both), so a reference `state_dict()` — a Transformer's or an ERNIE
model's — turned into numpy arrays, maps name for name onto the port's
modules:

    np_state = {k: np.asarray(v) for k, v in jax_layer.state_dict().items()}
    port_layer.load_state_dict(from_jax_state(np_state))

Both packages then compute the same function; the parity tests rely on
this. A quantized JAX net (`quantize_net`, or an engine built with
`quantize="int8"`) carries `weight_q` (int8) and `weight_scale` buffers
in place of `weight`; it loads into a port net on which `quantize_net`
has run, which has the same buffers:

    quantize_net(port_decoder, port_embed, port_project)
    port_decoder.load_state_dict(from_jax_state(np_state))
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_state"]


def from_jax_state(np_state):
    """{name: numpy array} -> {name: CPU torch tensor} with the same
    names, dtypes kept: int8 stays int8, float64 arrays from an x64
    session become float32 (the port's parameters are float32)."""
    out = {}
    for name, arr in np_state.items():
        arr = np.asarray(arr)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return out
