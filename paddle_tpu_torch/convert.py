"""Load the JAX package's weights into the port.

The port's modules mirror the reference's module tree and parameter
names (`layers.0.self_attn.q_proj.weight`,
`ernie.embeddings.word_embeddings.weight`, ...) and keep its layouts
(`Linear.weight` is [in, out], `Embedding.weight` [vocab, dim],
`Conv2D.weight` OIHW and `Conv2DTranspose.weight` [in, out / groups, kh,
kw] in both), so a reference `state_dict()` — a Transformer's, an ERNIE
model's, a ResNet's, LeNet's, a VGG's or a MobileNet's, buffers such as
the batch norms' `_mean` / `_variance` included — turned into numpy
arrays, maps name for name onto the port's modules:

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

The layers of the model-building library load the same way: the MoE's
`moe.router`, `moe.experts.weight_in` / `weight_out`, the RNN cells'
`weight_ih` / `weight_hh` / `bias_ih` / `bias_hh` (`cells.<i>.` in a
stack), the norms' `weight` / `bias`, `SpectralNorm`'s `weight_u` /
`weight_v` buffers. A JAX MoE layer also carries `aux_loss_val`, its
non-persistable aux-loss channel, which the JAX `state_dict()` lets
through for a nested layer; it is no state (the port keeps the aux loss
as `MoELayer.aux_loss`), and `from_jax_state` drops it.

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

On a mesh (`parallel`), each rank takes its block of every tensor that
its sharding rules split: `from_jax_state(np_state, rules, mesh)` and
`from_jax_optimizer_state(np_opt, names, rules, mesh)` (a slot takes its
parameter's block, as the mesh trainer's slots do). The full state comes
back through `SpmdTrainer.sync_to_layer` or `full_params`, comparable
array by array with the JAX trainer's.

A sharded serving engine's rank holds blocks cut by the serving rules
fitted to each shape (`parallel.fitted_sharding`: a split that does not
divide a dim drops axes): `from_jax_state(np_state, serving_param_rules(
layout), mesh, fitted=True)` gives a rank the blocks of the JAX engine's
step net (`decoder.*`, `embed.weight`, `project.weight`) under either
layout, fsdp included, as `serving.sharded.shard_serving_net` cuts them.

A JAX static-graph `Scope` (after the JAX startup program ran, say)
comes across through `from_jax_scope`: its values as numpy arrays fill
the port's `fluid.Scope` on a device, so the port's Executor runs a
program on the JAX package's weights (the two packages' initializers
draw from different generators):

    values = {n: np.asarray(v) for n, v in jax_scope._values.items()
              if v is not None}
    from_jax_scope(values, port_scope, device="cpu")

A JAX parameter-server job's tables come across through `to_pserver`:
its pservers' snapshot (the same C server, the same file format) loads
into the port's pservers, and dense numpy parameters initialise theirs.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_state", "from_jax_optimizer_state", "to_pserver",
           "from_jax_scope"]


def _block(name, t, rules, mesh, fitted=False):
    """This rank's block of tensor `name` under the rules (the whole
    tensor without rules; `fitted`: the split fitted to the shape)."""
    if rules is None:
        return t
    from .parallel.sharding import fitted_sharding, named_sharding

    spec = rules.spec_for(name, t.dim())
    sh = fitted_sharding(tuple(t.shape), spec, mesh) if fitted else \
        named_sharding(spec, mesh)
    return sh.shard(t)


def from_jax_state(np_state, rules=None, mesh=None, fitted=False):
    """{name: numpy array} -> {name: CPU torch tensor} with the same
    names, dtypes kept: int8 stays int8, float64 arrays from an x64
    JAX process become float32 (the port's parameters are float32). A MoE
    layer's `aux_loss_val` channel is dropped. With `rules`
    (`parallel.ShardingRules`), each tensor is this rank's block of it
    on `mesh` (None: the installed one); `fitted` fits each split to the
    tensor's shape, as the sharded serving engines do."""
    out = {}
    for name, arr in np_state.items():
        if name.rsplit(".", 1)[-1] == "aux_loss_val":
            continue
        arr = np.asarray(arr)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
        out[name] = _block(name, t, rules, mesh, fitted)
    return out


def to_pserver(comm, dense=None, snapshot_dir=None):
    """Carry a JAX parameter-server job's tables to the port's pservers
    behind `comm` (a `distributed.ps.Communicator`): `snapshot_dir` holds
    the JAX pservers' snapshot (`checkpoint_notify(dir)` there, one
    `pserver_<i>.ptps` a pserver), loaded into each of the port's, sparse
    rows and their optimizer state included; `dense` ({name: numpy
    array}) initialises the dense tables (float32, as the server holds
    them)."""
    if snapshot_dir is not None:
        comm.checkpoint_notify(snapshot_dir, load=True)
    for name, arr in (dense or {}).items():
        arr = np.asarray(arr, np.float32)
        comm._client_for(name).init_dense(name, arr)
        comm._dense_shapes[name] = tuple(arr.shape)


def from_jax_optimizer_state(np_state, names=None, rules=None, mesh=None):
    """A JAX optimizer's `state_dict()` with numpy slots -> the port
    optimizer's: slots become CPU tensors (float64 -> float32, as above),
    `_step_count` and `LR_Scheduler` pass through, and each slot key's
    parameter name is renamed through `names` where it has an entry. With
    `rules`, each slot is this rank's block of it, cut as its (renamed)
    parameter is."""
    names = names or {}
    out = {}
    for key, value in np_state.items():
        if key in ("_step_count", "LR_Scheduler"):
            out[key] = value
            continue
        pname, slot = key.rsplit("__", 1)
        pname = names.get(pname, pname)
        t = from_jax_state({key: value})[key]
        out[f"{pname}__{slot}"] = _block(pname, t, rules, mesh)
    return out


def from_jax_scope(values, scope=None, device="cpu"):
    """Fill the port's static `Scope` (None: the global one) with a JAX
    Scope's values, {name: numpy array}, as tensors on `device`. Dtypes
    are kept (a static program's float64 stays float64, as in the JAX
    Scope); a bfloat16 array (ml_dtypes) becomes a torch bfloat16
    tensor. Returns the scope."""
    from .core.device import resolve_device
    from .fluid.executor import global_scope

    scope = global_scope() if scope is None else scope
    dev = resolve_device(device)
    for name, arr in values.items():
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr).copy())
        scope._values[name] = t.to(dev)
    return scope
