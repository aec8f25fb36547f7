"""Load the JAX package's weights into the port.

The port's modules mirror the reference's module tree and parameter
names (`layers.0.self_attn.q_proj.weight`,
`ernie.embeddings.word_embeddings.weight`, ...) and keep its layouts
(`Linear.weight` is [in, out], `Embedding.weight` [vocab, dim] and
`Conv2D.weight` OIHW in both), so a reference `state_dict()` — a
Transformer's, an ERNIE model's or a ResNet's, buffers such as
BatchNorm's `_mean` / `_variance` included — turned into numpy arrays,
maps name for name onto the port's modules:

    np_state = {k: np.asarray(v) for k, v in jax_layer.state_dict().items()}
    port_layer.load_state_dict(from_jax_state(np_state))

Both packages then compute the same function; the parity tests rely on
this. A quantized JAX net (`quantize_net`, or an engine built with
`quantize="int8"`) carries `weight_q` (int8) and `weight_scale` buffers
in place of `weight`; it loads into a port net on which `quantize_net`
has run, which has the same buffers:

    quantize_net(port_decoder, port_embed, port_project)
    port_decoder.load_state_dict(from_jax_state(np_state))

`ErnieForPretraining` loads the same way: its masked-LM decoder is tied
to the word embeddings and brings no weight of its own.

An eager JAX optimizer's `state_dict()` (its slots turned into numpy
arrays) becomes the port optimizer's through `from_jax_optimizer_state`,
so a run continues from a JAX checkpoint:

    np_opt = {k: v if k in ("_step_count", "LR_Scheduler")
              else np.asarray(v._data)
              for k, v in jax_opt.state_dict().items()}
    port_opt.set_state_dict(from_jax_optimizer_state(np_opt, names))

The JAX optimizer keys a slot ``"{p.name}__{slot}"`` by the Parameter's
own name (``param_12``); `names` ({JAX name: port name}, for example
``dict(zip((p.name for p in jax_model.parameters()),
(n for n, _ in port_model.named_parameters())))``) renames the keys to
the port optimizer's names. Without it the keys stay, and the port's
`set_state_dict` falls back to matching slots by position, as the JAX
package's does.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_state", "from_jax_optimizer_state"]


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


def from_jax_optimizer_state(np_state, names=None):
    """A JAX optimizer's `state_dict()` with numpy slots -> the port
    optimizer's: slots become CPU tensors (float64 -> float32, as above),
    `_step_count` and `LR_Scheduler` pass through, and each slot key's
    parameter name is renamed through `names` where it has an entry."""
    names = names or {}
    out = {}
    for key, value in np_state.items():
        if key in ("_step_count", "LR_Scheduler"):
            out[key] = value
            continue
        pname, slot = key.rsplit("__", 1)
        out[f"{names.get(pname, pname)}__{slot}"] = \
            from_jax_state({key: value})[key]
    return out
