"""Static op lowerings: op type -> a torch function over an execution env
(the JAX package's `fluid/lowering.py`).

Each fluid op type has a lowering that reads its input vars from the env,
computes with the port's `ops/kernels.py` and torch, and writes its
outputs. The Executor (fluid/executor.py) resolves every op's lowering
once per program signature and then runs them in program order on the
Executor's device, op by op, as the reference's executor.cc does; the JAX
package traces the same lowerings into one XLA computation instead.

A lowering gets (ctx, op); ctx gives env lookups and a deterministic
stream of random seeds: an op's draws depend on (run seed, op uid, draw
count) only, so `jax_autodiff`'s re-run of a forward slice draws the
same dropout masks as the forward pass did.

Ported here: every registration of the JAX `lowering.py` and the fused
inference targets the Predictor's passes form (`fused_sdpa`,
`multihead_matmul`, `skip_layernorm`, `fused_fc_elementwise_layernorm`,
`fused_embedding_eltwise_layernorm`). `fused_sdpa` and
`multihead_matmul` run `ops.attention.sdpa`: on the card a key-padding
mask takes the flash forward kernel. Every other op type raises
NotImplementedError naming ROADMAP item 8b (the rest of the op library),
or the item its runtime waits for. Sequence (LoD) feeds come with 8b too:
the lowerings here see dense tensors only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import kernels as K
from .dtypes import convert_dtype, to_torch

_REGISTRY = {}

ITEM_8B = "ROADMAP item 8b"


def register(op_type):
    def deco(fn):
        _REGISTRY[op_type] = fn
        return fn
    return deco


# op types whose lowering waits for a later sub-item than 8b
_WAITS = {
    "jax_exported": "ROADMAP item 8d (jit artifacts)",
    "lod_reset": "ROADMAP item 8b (LoD feeds)",
}


def get_lowering(op_type):
    fn = _REGISTRY.get(op_type)
    if fn is None:
        raise NotImplementedError(
            f"static op {op_type!r} has no lowering in the port yet: it "
            f"comes with {_WAITS.get(op_type, ITEM_8B)}")
    return fn


def has_lowering(op_type):
    return op_type in _REGISTRY


def lower_op(ctx, op, fn=None):
    """Run one op's lowering; on failure, attach the Python creation stack
    recorded on the OpDesc so errors point at user code (reference:
    framework/op_call_stack.cc)."""
    try:
        fn = fn or get_lowering(op.type)
        ctx.begin_op(op)
        return fn(ctx, op)
    except Exception as e:
        stack = op.attrs.get("op_callstack")
        if stack and hasattr(e, "add_note"):
            import traceback

            try:
                note = "".join(traceback.format_list(stack))
            except Exception:
                note = "\n".join(str(f) for f in stack)
            e.add_note("op %r was created at (most recent call last):\n%s"
                       % (op.type, note))
        raise


_M64 = (1 << 64) - 1


def mix_seed(*parts):
    """A 63-bit seed from integers (splitmix64 over each part in turn)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (int(p) & _M64)) & _M64
        h = (h + 0x9E3779B97F4A7C15) & _M64
        z = h
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        h = z ^ (z >> 31)
    return h & ((1 << 63) - 1)


class LowerCtx:
    """Execution environment handed to the lowerings of one run."""

    def __init__(self, env, run_seed, training=True, program=None,
                 base_env=None, device=None):
        self.env = env            # name -> torch tensor
        self.run_seed = run_seed
        self._rng_count = 0
        self._cur_op_uid = 0
        self.training = training
        self.program = program    # needed by control-flow ops (sub-blocks)
        # snapshot of env at global-block op 0 (persistables + feeds):
        # jax_autodiff re-runs its forward slice from here
        self.base_env = base_env
        self.device = torch.device("cpu") if device is None else device

    def inp(self, op, slot, idx=0, default=None):
        names = op.input(slot)
        if not names:
            return default
        return self.env[names[idx]]

    def inps(self, op, slot):
        return [self.env[n] for n in op.input(slot)]

    def out(self, op, slot, value, idx=0):
        names = op.output(slot)
        if names:
            self.env[names[idx]] = value

    def outs(self, op, slot, values):
        for n, v in zip(op.output(slot), values):
            self.env[n] = v

    def begin_op(self, op):
        self._cur_op_uid = getattr(op, "_uid", 0)
        self._rng_count = 0

    def next_seed(self):
        """The op's next draw seed: (run seed, op uid, draw count), so a
        pruned re-run reproduces the forward pass's draws exactly."""
        self._rng_count += 1
        return mix_seed(self.run_seed, self._cur_op_uid, self._rng_count)

    def generator(self):
        g = torch.Generator(device=self.device)
        g.manual_seed(self.next_seed())
        return g

    def tensor(self, value, dtype=None):
        """A constant on the run's device."""
        return torch.as_tensor(value, dtype=dtype, device=self.device)


def trace_block(program, block_idx, env, run_seed, training, device):
    """Run every op lowering of a sub-block over env (in place): the
    control-flow lowerings call this once per iteration or branch
    (reference: executor.cc:428 RunPartialPreparedContext re-entered per
    sub-block)."""
    ctx = LowerCtx(env, run_seed, training=training, program=program,
                   device=device)
    for op in program.block(block_idx).ops:
        lower_op(ctx, op)
    return env


def _require_program(ctx, op):
    if ctx.program is None:
        raise RuntimeError(
            f"op {op.type!r} needs sub-block access but this LowerCtx has "
            f"no program attached")
    return ctx.program


def _dt(name, default="float32"):
    return to_torch(convert_dtype(name if name is not None else default))


def _rows_add(base, rows, vals):
    """base with vals added at rows; rows outside base are dropped
    (the JAX scatter's mode="drop")."""
    keep = (rows >= 0) & (rows < base.shape[0])
    return base.index_add(0, rows[keep].long(), vals[keep].to(base.dtype))


# ============ autodiff (fluid/backward.py) ============

@register("jax_autodiff")
def _lower_jax_autodiff(ctx, op):
    """Static autodiff as ONE op (fluid/backward.py): re-run the slice of
    the forward segment (global-block ops[:fwd_op_count]) that the
    targets depend on under torch autograd with the params as leaves,
    then `torch.autograd.grad`; write the op's declared Grads vars.

    The slice is a backward slice from the targets that STOPS at the
    requested params: ops upstream of a param only matter through the
    param value, which is injected. Values that excluded ops produced come
    in as constants from the env. A random op in the slice draws as it did
    in the forward pass (its seed depends on the op's uid only).

    A lookup_table(is_sparse=True) param gets the JAX rows form: the
    gradient is taken w.r.t. the gathered rows of its sorted unique ids
    (padded with the out-of-range row V to the id count), and published
    as (rows, values)."""
    program = _require_program(ctx, op)
    blk = program.global_block()
    param_names = op.attrs["param_names"]
    loss_names = op.attrs.get("loss_names") or [op.attrs["loss_name"]]
    tg_names = op.attrs.get("target_grad_names") or [None] * len(loss_names)
    tg_names = [g or None for g in tg_names]  # "" sentinel -> no seed
    n_fwd = op.attrs["fwd_op_count"]
    fwd_ops = blk.ops[:n_fwd]
    base = ctx.base_env if ctx.base_env is not None else ctx.env

    pset = set(param_names)
    need = set(loss_names) | {g for g in tg_names if g is not None}
    keep = [False] * len(fwd_ops)
    for i in range(len(fwd_ops) - 1, -1, -1):
        fop = fwd_ops[i]
        if fop.type in ("feed", "fetch"):
            continue
        if need & set(fop.output_arg_names):
            keep[i] = True
            need |= set(fop.input_arg_names) - pset
    traced = [fop for i, fop in enumerate(fwd_ops) if keep[i]]
    excluded_out = set()
    for i, fop in enumerate(fwd_ops):
        if not keep[i]:
            excluded_out.update(fop.output_arg_names)

    sparse_names = [n for n in (op.attrs.get("sparse_param_names") or ())
                    if n in param_names]
    sparse_info = {}
    for w in sparse_names:
        ids_vals = []
        dense_consumer = False
        for fop in traced:
            if fop.type in ("lookup_table", "lookup_table_v2") and \
                    w in fop.input("W"):
                ids_vals.append(ctx.env[fop.input("Ids")[0]].reshape(-1))
            elif w in fop.input_arg_names:
                # tied weights: a dense gradient keeps the other path's
                dense_consumer = True
        if not ids_vals or dense_consumer:
            continue
        V = ctx.env[w].shape[0]
        ids_all = torch.cat(ids_vals).to(torch.int32)
        uids = torch.unique(ids_all, sorted=True)
        pad = ids_all.shape[0] - uids.shape[0]
        if pad:
            uids = torch.cat([uids, uids.new_full((pad,), V)])
        sparse_info[w] = (uids, V)

    leaves = []
    for n in param_names:
        if n in sparse_info:
            uids, V = sparse_info[n]
            val = ctx.env[n][uids.clamp(0, V - 1).long()]
        else:
            val = ctx.env[n]
        leaves.append(val.detach().requires_grad_(True))

    env2 = dict(base)
    env2.update({n: ctx.env[n].detach() for n in excluded_out
                 if n in ctx.env and torch.is_tensor(ctx.env[n])})
    env2.update(zip(param_names, leaves))
    for w, (uids, _V) in sparse_info.items():
        gathered = env2[w]           # the diff value IS the gathered rows
        env2[w] = ctx.env[w].detach()
        env2["@@SPARSE@" + w] = (uids, gathered)
    ctx2 = LowerCtx(env2, ctx.run_seed, training=ctx.training,
                    program=program, base_env=dict(base),
                    device=ctx.device)
    with torch.enable_grad():
        for fop in traced:
            lower_op(ctx2, fop)
        total = None
        for tname, gname in zip(loss_names, tg_names):
            tv = env2[tname]
            if gname is not None:
                term = (tv * env2[gname].detach()).sum()
            else:
                term = tv.sum()
            total = term if total is None else total + term
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    grads = [(sparse_info[n][0], g) if n in sparse_info else g
             for n, g in zip(param_names, grads)]
    # adopt the re-run's forward values (consistent with the grads: the
    # same masks) for the names the slice writes, params excepted
    written = set()
    for fop in traced:
        written.update(fop.output_arg_names)
    ctx.env.update({k: (v.detach() if torch.is_tensor(v) else v)
                    for k, v in env2.items()
                    if k in written and k not in pset})
    grad_outs = op.output("Grads")
    if not grad_outs:
        grad_outs = [n + "@GRAD" for n in param_names]
    for name, g in zip(grad_outs, grads):
        ctx.env[name] = g


# ============ elementwise (operators/elementwise/) ============

def _ew(fn):
    def lower(ctx, op):
        x = ctx.inp(op, "X")
        y = ctx.inp(op, "Y")
        if not torch.is_tensor(y):
            y = ctx.tensor(y, x.dtype)
        axis = op.attrs.get("axis", -1)
        if axis != -1 and y.dim() < x.dim():
            # paddle broadcast: align y's dims starting at `axis`
            shape = [1] * x.dim()
            for i, s in enumerate(y.shape):
                shape[axis + i] = s
            y = y.reshape(shape)
        ctx.out(op, "Out", fn(x, y))
    return lower


register("elementwise_add")(_ew(lambda x, y: x + y))
register("elementwise_sub")(_ew(lambda x, y: x - y))
register("elementwise_mul")(_ew(lambda x, y: x * y))
register("elementwise_div")(_ew(lambda x, y: x / y))
register("elementwise_max")(_ew(torch.maximum))
register("elementwise_min")(_ew(torch.minimum))
register("elementwise_pow")(_ew(lambda x, y: x ** y))
register("elementwise_mod")(_ew(lambda x, y: x % y))
register("elementwise_floordiv")(_ew(lambda x, y: x // y))


# ============ activations (operators/activation_op.cc) ============

def _unary(name, fn):
    @register(name)
    def lower(ctx, op, _fn=fn):
        ctx.out(op, "Out", _fn(ctx.inp(op, "X")))


for _n, _f in {
    "relu": K.relu, "relu6": K.relu6, "sigmoid": K.sigmoid,
    "tanh": K.tanh, "sqrt": torch.sqrt,
    "rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "exp": torch.exp, "log": torch.log,
    "square": lambda x: x * x, "abs": torch.abs,
    "floor": torch.floor, "ceil": torch.ceil,
    "round": torch.round, "sin": torch.sin,
    "cos": torch.cos, "sign": torch.sign,
    "reciprocal": lambda x: 1.0 / x, "softsign": K.softsign,
    "softplus": K.softplus, "mish": K.mish, "silu": K.silu,
    "swish": K.swish, "hard_swish": K.hardswish,
    "tanh_shrink": lambda x: x - torch.tanh(x),
    "erf": torch.erf, "logsigmoid": F.logsigmoid,
}.items():
    _unary(_n, _f)


@register("leaky_relu")
def _leaky(ctx, op):
    ctx.out(op, "Out", K.leaky_relu(ctx.inp(op, "X"),
                                    op.attrs.get("alpha", 0.02)))


@register("elu")
def _elu(ctx, op):
    ctx.out(op, "Out", K.elu(ctx.inp(op, "X"), op.attrs.get("alpha", 1.0)))


@register("gelu")
def _gelu(ctx, op):
    ctx.out(op, "Out", K.gelu(ctx.inp(op, "X"),
                              op.attrs.get("approximate", False)))


@register("hard_sigmoid")
def _hard_sigmoid(ctx, op):
    ctx.out(op, "Out", K.hardsigmoid(ctx.inp(op, "X"),
                                     op.attrs.get("slope", 0.2),
                                     op.attrs.get("offset", 0.5)))


@register("softmax")
def _softmax(ctx, op):
    ctx.out(op, "Out", K.softmax(ctx.inp(op, "X"),
                                 op.attrs.get("axis", -1)))


@register("log_softmax")
def _log_softmax(ctx, op):
    ctx.out(op, "Out", K.log_softmax(ctx.inp(op, "X"),
                                     op.attrs.get("axis", -1)))


@register("scale")
def _scale(ctx, op):
    ctx.out(op, "Out", K.scale(ctx.inp(op, "X"),
                               op.attrs.get("scale", 1.0),
                               op.attrs.get("bias", 0.0),
                               op.attrs.get("bias_after_scale", True)))


@register("clip")
def _clip(ctx, op):
    ctx.out(op, "Out", K.clip(ctx.inp(op, "X"), op.attrs.get("min"),
                              op.attrs.get("max")))


@register("pow")
def _pow(ctx, op):
    ctx.out(op, "Out", ctx.inp(op, "X") ** op.attrs.get("factor", 1.0))


@register("cast")
def _cast(ctx, op):
    ctx.out(op, "Out", ctx.inp(op, "X").to(_dt(op.attrs["out_dtype"])))


# ============ matmul / fc (operators/matmul_op.cc, mul_op.cc) ============

@register("matmul")
@register("matmul_v2")
def _matmul(ctx, op):
    x = ctx.inp(op, "X")
    y = ctx.inp(op, "Y")
    tx = op.attrs.get("transpose_X", op.attrs.get("trans_x", False))
    ty = op.attrs.get("transpose_Y", op.attrs.get("trans_y", False))
    out = K.matmul(x, y, tx, ty)
    alpha = op.attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.out(op, "Out", out)


def mul_op(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """fluid 'mul' op: flatten then 2-D matmul (operators/mul_op.cc)."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:x_num_col_dims])), -1)
    y2 = y.reshape(int(np.prod(ys[:y_num_col_dims])), -1)
    return torch.matmul(x2, y2).reshape(
        xs[:x_num_col_dims] + ys[y_num_col_dims:])


@register("mul")
def _mul(ctx, op):
    ctx.out(op, "Out", mul_op(ctx.inp(op, "X"), ctx.inp(op, "Y"),
                              op.attrs.get("x_num_col_dims", 1),
                              op.attrs.get("y_num_col_dims", 1)))


# ============ conv / pool ============

@register("conv2d")
@register("depthwise_conv2d")
def _conv2d(ctx, op):
    out = K.conv2d(ctx.inp(op, "Input"), ctx.inp(op, "Filter"),
                   op.attrs.get("strides", [1, 1]),
                   op.attrs.get("paddings", [0, 0]),
                   op.attrs.get("dilations", [1, 1]),
                   op.attrs.get("groups", 1))
    ctx.out(op, "Output", out)


@register("conv2d_transpose")
@register("conv_transpose")
def _conv2d_t(ctx, op):
    out = K.conv2d_transpose(ctx.inp(op, "Input"), ctx.inp(op, "Filter"),
                             op.attrs.get("strides", [1, 1]),
                             op.attrs.get("paddings", [0, 0]),
                             op.attrs.get("output_padding", [0, 0]),
                             op.attrs.get("dilations", [1, 1]),
                             op.attrs.get("groups", 1))
    ctx.out(op, "Output", out)


@register("pool2d")
def _pool2d(ctx, op):
    x = ctx.inp(op, "X")
    ptype = op.attrs.get("pooling_type", "max")
    if op.attrs.get("global_pooling", False):
        out = x.amax(dim=(2, 3), keepdim=True) if ptype == "max" else \
            x.mean(dim=(2, 3), keepdim=True)
    elif op.attrs.get("adaptive", False):
        out = K.adaptive_avg_pool2d(x, op.attrs["ksize"]) \
            if ptype == "avg" else K.adaptive_max_pool2d(x, op.attrs["ksize"])
    else:
        fn = K.max_pool2d if ptype == "max" else K.avg_pool2d
        kw = {}
        if ptype == "avg":
            kw["exclusive"] = op.attrs.get("exclusive", True)
        out = fn(x, op.attrs["ksize"], op.attrs.get("strides", [1, 1]),
                 op.attrs.get("paddings", [0, 0]),
                 op.attrs.get("ceil_mode", False), **kw)
    ctx.out(op, "Out", out)


# ============ norm ============

def _c_axis(layout):
    return 1 if str(layout).startswith("NC") else -1


@register("batch_norm")
def _batch_norm(ctx, op):
    x = ctx.inp(op, "X")
    scale = ctx.inp(op, "Scale")
    bias = ctx.inp(op, "Bias")
    mean = ctx.inp(op, "Mean")
    var = ctx.inp(op, "Variance")
    eps = op.attrs.get("epsilon", 1e-5)
    momentum = op.attrs.get("momentum", 0.9)
    c_axis = _c_axis(op.attrs.get("data_layout", "NCHW"))
    if op.attrs.get("is_test", False) or not ctx.training or \
            op.attrs.get("use_global_stats", False):
        ctx.out(op, "Y", K.batch_norm_infer(x, scale, bias, mean, var, eps,
                                            c_axis))
    else:
        y, nm, nv, bm, bv = K.batch_norm_train(x, scale, bias, mean, var,
                                               momentum, eps, c_axis)
        ctx.out(op, "Y", y)
        ctx.out(op, "MeanOut", nm)
        ctx.out(op, "VarianceOut", nv)
        ctx.out(op, "SavedMean", bm)
        ctx.out(op, "SavedVariance", bv)


def _flat_ln(x, scale, bias, eps, begin):
    """layer_norm over [begin:] with flat scale/bias (layer_norm_op.cc
    flattened-parameter convention)."""
    if scale is not None:
        scale = scale.reshape(x.shape[begin:])
    if bias is not None:
        bias = bias.reshape(x.shape[begin:])
    return K.layer_norm(x, scale, bias, eps, begin)


@register("layer_norm")
def _layer_norm(ctx, op):
    x = ctx.inp(op, "X")
    ctx.out(op, "Y", _flat_ln(x, ctx.inp(op, "Scale"), ctx.inp(op, "Bias"),
                              op.attrs.get("epsilon", 1e-5),
                              op.attrs.get("begin_norm_axis", 1)))


# ============ dropout / random ============

def dropout(x, generator, p=0.5, training=True, mode="upscale_in_train"):
    """The JAX `dropout` kernel's function, its keep mask drawn from
    `generator` (float32 uniforms below 1 - p)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < keep
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, zero).to(x.dtype)
    return torch.where(mask, x, zero).to(x.dtype)


@register("dropout")
def _dropout(ctx, op):
    x = ctx.inp(op, "X")
    p = op.attrs.get("dropout_prob", 0.5)
    is_test = op.attrs.get("is_test", False) or not ctx.training
    impl = op.attrs.get("dropout_implementation", "downgrade_in_infer")
    mode = "upscale_in_train" if impl == "upscale_in_train" else \
        "downscale_in_infer"
    gen = ctx.generator() if not is_test and p != 0.0 else None
    ctx.out(op, "Out", dropout(x, gen, p, not is_test, mode))


@register("uniform_random")
def _uniform_random(ctx, op):
    shape = tuple(int(s) for s in op.attrs["shape"])
    dt = _dt(op.attrs.get("dtype", "float32"))
    lo, hi = op.attrs.get("min", -1.0), op.attrs.get("max", 1.0)
    u = torch.rand(shape, generator=ctx.generator(), device=ctx.device,
                   dtype=torch.float32)
    ctx.out(op, "Out", (u * (hi - lo) + lo).to(dt))


@register("gaussian_random")
def _gaussian_random(ctx, op):
    shape = tuple(int(s) for s in op.attrs["shape"])
    dt = _dt(op.attrs.get("dtype", "float32"))
    n = torch.randn(shape, generator=ctx.generator(), device=ctx.device,
                    dtype=torch.float32)
    ctx.out(op, "Out", (n * op.attrs.get("std", 1.0) +
                        op.attrs.get("mean", 0.0)).to(dt))


@register("truncated_gaussian_random")
def _trunc_gaussian(ctx, op):
    shape = tuple(int(s) for s in op.attrs["shape"])
    dt = _dt(op.attrs.get("dtype", "float32"))
    v = torch.empty(shape, device=ctx.device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0,
                                generator=ctx.generator())
    ctx.out(op, "Out", (v * op.attrs.get("std", 1.0) +
                        op.attrs.get("mean", 0.0)).to(dt))


# ============ fill / assign ============

@register("fill_constant")
def _fill_constant(ctx, op):
    shape = tuple(int(s) for s in op.attrs["shape"])
    ctx.out(op, "Out", torch.full(shape, op.attrs.get("value", 0.0),
                                  dtype=_dt(op.attrs.get("dtype")),
                                  device=ctx.device))


@register("fill_constant_batch_size_like")
def _fill_cbsl(ctx, op):
    x = ctx.inp(op, "Input")
    shape = list(op.attrs["shape"])
    shape[op.attrs.get("output_dim_idx", 0)] = \
        x.shape[op.attrs.get("input_dim_idx", 0)]
    ctx.out(op, "Out", torch.full(tuple(int(s) for s in shape),
                                  op.attrs.get("value", 0.0),
                                  dtype=_dt(op.attrs.get("dtype")),
                                  device=ctx.device))


@register("assign")
def _assign(ctx, op):
    ctx.out(op, "Out", ctx.inp(op, "X"))


@register("assign_value")
def _assign_value(ctx, op):
    dt = convert_dtype(op.attrs.get("dtype", "float32"))
    vals = np.asarray(op.attrs["values"],
                      dtype=np.float32 if to_torch(dt) == torch.bfloat16
                      else dt).reshape(op.attrs["shape"])
    ctx.out(op, "Out", ctx.tensor(vals).to(to_torch(dt)))


@register("shape")
def _shape(ctx, op):
    ctx.out(op, "Out", ctx.tensor(list(ctx.inp(op, "Input").shape),
                                  torch.int32))


# ============ reshape / transpose / concat ... ============

@register("reshape")
@register("reshape2")
def _reshape(ctx, op):
    x = ctx.inp(op, "X")
    shape = list(op.attrs["shape"])
    # paddle: 0 means copy input dim
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    ctx.out(op, "Out", x.reshape(shape))


@register("transpose")
@register("transpose2")
def _transpose(ctx, op):
    ctx.out(op, "Out", K.transpose(ctx.inp(op, "X"), op.attrs["axis"]))


@register("concat")
def _concat(ctx, op):
    ctx.out(op, "Out", K.concat(ctx.inps(op, "X"),
                                op.attrs.get("axis", 0)))


@register("split")
@register("split_byref")
def _split(ctx, op):
    x = ctx.inp(op, "X")
    sections = op.attrs.get("sections") or op.attrs.get("num", 2)
    ctx.outs(op, "Out", K.split(x, sections, op.attrs.get("axis", 0)))


@register("stack")
def _stack(ctx, op):
    ctx.out(op, "Y", K.stack(ctx.inps(op, "X"), op.attrs.get("axis", 0)))


@register("squeeze")
@register("squeeze2")
def _squeeze(ctx, op):
    axes = op.attrs.get("axes") or None
    ctx.out(op, "Out", K.squeeze(ctx.inp(op, "X"), axes))


@register("unsqueeze")
@register("unsqueeze2")
def _unsqueeze(ctx, op):
    ctx.out(op, "Out", K.unsqueeze(ctx.inp(op, "X"), op.attrs["axes"]))


@register("flatten")
@register("flatten2")
def _flatten(ctx, op):
    x = ctx.inp(op, "X")
    axis = op.attrs.get("axis", 1)
    n = int(np.prod(tuple(x.shape[:axis]))) if axis > 0 else 1
    ctx.out(op, "Out", x.reshape(n, -1))


@register("flatten_contiguous_range")
def _flatten_range(ctx, op):
    ctx.out(op, "Out", K.flatten(ctx.inp(op, "X"),
                                 op.attrs.get("start_axis", 0),
                                 op.attrs.get("stop_axis", -1)))


@register("expand")
def _expand(ctx, op):
    ctx.out(op, "Out", K.tile(ctx.inp(op, "X"), op.attrs["expand_times"]))


@register("expand_v2")
def _expand_v2(ctx, op):
    ctx.out(op, "Out", K.expand(ctx.inp(op, "X"), op.attrs["shape"]))


@register("slice")
def _slice(ctx, op):
    ctx.out(op, "Out", K.slice_op(ctx.inp(op, "Input"), op.attrs["axes"],
                                  op.attrs["starts"], op.attrs["ends"]))


@register("gather")
def _gather(ctx, op):
    ctx.out(op, "Out", K.gather(ctx.inp(op, "X"), ctx.inp(op, "Index"),
                                op.attrs.get("axis", 0)))


@register("pad")
@register("pad2d")
def _pad(ctx, op):
    ctx.out(op, "Out", K.pad(ctx.inp(op, "X"), op.attrs["paddings"],
                             op.attrs.get("mode", "constant"),
                             op.attrs.get("pad_value",
                                          op.attrs.get("value", 0.0))))


# ============ reductions ============

def _reduce(ctx, op, fn):
    x = ctx.inp(op, "X")
    if op.attrs.get("reduce_all", False):
        return fn(x, None, op.attrs.get("keep_dim", False))
    return fn(x, op.attrs.get("dim", [0]), op.attrs.get("keep_dim", False))


for _n, _f in {"reduce_sum": K.reduce_sum, "reduce_mean": K.reduce_mean,
               "reduce_max": K.reduce_max, "reduce_min": K.reduce_min,
               "reduce_prod": K.reduce_prod}.items():
    register(_n)(lambda ctx, op, _f=_f: ctx.out(op, "Out",
                                                _reduce(ctx, op, _f)))


@register("mean")
def _mean(ctx, op):
    ctx.out(op, "Out", ctx.inp(op, "X").mean())


@register("sum")
def _sum(ctx, op):
    xs = ctx.inps(op, "X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.out(op, "Out", out)


# ============ losses / metrics ============

@register("softmax_with_cross_entropy")
def _swce(ctx, op):
    logits = ctx.inp(op, "Logits")
    label = ctx.inp(op, "Label")
    loss = K.softmax_with_cross_entropy(
        logits, label, op.attrs.get("soft_label", False),
        op.attrs.get("axis", -1), op.attrs.get("ignore_index", -100))
    ctx.out(op, "Loss", loss)
    ctx.out(op, "Softmax", K.softmax(logits, op.attrs.get("axis", -1)))


@register("cross_entropy")
@register("cross_entropy2")
def _ce(ctx, op):
    x = ctx.inp(op, "X")
    label = ctx.inp(op, "Label")
    if op.attrs.get("soft_label", False):
        loss = -(label * torch.log(torch.clamp(x, min=1e-12))).sum(
            -1, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == x.dim() and lbl.shape[-1] == 1:
            lbl = lbl[..., 0]
        picked = torch.gather(x, -1, lbl[..., None].long())
        loss = -torch.log(torch.clamp(picked, min=1e-12))
    ctx.out(op, "Y", loss)


@register("square_error_cost")
def _sec(ctx, op):
    ctx.out(op, "Out", K.mse_loss(ctx.inp(op, "X"), ctx.inp(op, "Y")))


@register("accuracy")
def _accuracy(ctx, op):
    out = ctx.inp(op, "Out")
    label = ctx.inp(op, "Label")
    if label.dim() == out.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    pred = out.argmax(-1)
    hit = pred == label
    ctx.out(op, "Accuracy", hit.to(torch.float32).mean())
    ctx.out(op, "Correct", hit.sum().to(torch.int32))
    ctx.out(op, "Total", ctx.tensor(label.shape[0], torch.int32))


@register("top_k")
@register("top_k_v2")
def _top_k(ctx, op):
    v, i = K.topk(ctx.inp(op, "X"), op.attrs.get("k", 1),
                  op.attrs.get("axis", -1),
                  op.attrs.get("largest", True))
    ctx.out(op, "Out", v)
    ctx.out(op, "Indices", i)


@register("arg_max")
def _arg_max(ctx, op):
    ctx.out(op, "Out", K.argmax(ctx.inp(op, "X"), op.attrs.get("axis"),
                                op.attrs.get("keepdims", False)))


@register("arg_min")
def _arg_min(ctx, op):
    ctx.out(op, "Out", K.argmin(ctx.inp(op, "X"), op.attrs.get("axis"),
                                op.attrs.get("keepdims", False)))


# ============ embedding / one-hot ============

@register("lookup_table")
@register("lookup_table_v2")
def _lookup(ctx, op):
    ids = ctx.inp(op, "Ids")
    w_name = op.input("W")[0]
    w = ctx.env[w_name]
    if ids.dim() >= 2 and ids.shape[-1] == 1 and op.type == "lookup_table":
        ids = ids[..., 0]
    pad = op.attrs.get("padding_idx", -1)
    sub = ctx.env.get("@@SPARSE@" + w_name)
    if sub is not None:
        # sparse-diff substitution (jax_autodiff): rows come from the
        # gathered differentiable slice, found by searchsorted over the
        # sorted unique-id table — gradient flows into rows only
        uids, gathered = sub
        pos = torch.searchsorted(uids, ids.to(uids.dtype).contiguous())
        pos = pos.clamp(0, gathered.shape[0] - 1)
        out = gathered[pos]
        if pad is not None and pad >= 0:
            out = out * (ids != pad)[..., None].to(out.dtype)
        ctx.out(op, "Out", out)
        return
    ctx.out(op, "Out", K.embedding(ids, w, pad))


@register("one_hot")
@register("one_hot_v2")
def _one_hot(ctx, op):
    ids = ctx.inp(op, "X")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    ctx.out(op, "Out", K.one_hot(ids, op.attrs["depth"]))


# ============ optimizer ops (operators/optimizers/) ============

@register("sgd")
def _sgd(ctx, op):
    p = ctx.inp(op, "Param")
    g = ctx.inp(op, "Grad")
    lr = ctx.inp(op, "LearningRate")
    if isinstance(g, tuple):  # SelectedRows (rows, values): row update only
        rows, vals = g
        ctx.out(op, "ParamOut",
                _rows_add(p, rows, -(lr * vals.to(p.dtype)).to(p.dtype)))
        return
    ctx.out(op, "ParamOut", p - lr * g.to(p.dtype))


@register("momentum")
def _momentum(ctx, op):
    p = ctx.inp(op, "Param")
    g = ctx.inp(op, "Grad")
    v = ctx.inp(op, "Velocity")
    lr = ctx.inp(op, "LearningRate")
    mu = op.attrs.get("mu", 0.9)
    nesterov = op.attrs.get("use_nesterov", False)
    if isinstance(g, tuple):  # SelectedRows: momentum_op.h's rule
        rows, vals = g
        vals = vals.to(p.dtype)
        v_new = _rows_add(mu * v, rows, vals)
        if nesterov:
            p_new = _rows_add(p - lr * mu * v_new, rows,
                              -(lr * vals).to(p.dtype))
        else:
            p_new = p - lr * v_new
        ctx.out(op, "ParamOut", p_new.to(p.dtype))
        ctx.out(op, "VelocityOut", v_new)
        return
    g = g.to(p.dtype)
    v_new = mu * v + g
    if nesterov:
        p_new = p - lr * (g + mu * v_new)
    else:
        p_new = p - lr * v_new
    ctx.out(op, "ParamOut", p_new)
    ctx.out(op, "VelocityOut", v_new)


@register("adam")
def _adam(ctx, op):
    p = ctx.inp(op, "Param")
    g = ctx.inp(op, "Grad")
    m = ctx.inp(op, "Moment1")
    v = ctx.inp(op, "Moment2")
    lr = ctx.inp(op, "LearningRate")
    b1p = ctx.inp(op, "Beta1Pow")
    b2p = ctx.inp(op, "Beta2Pow")
    b1 = op.attrs.get("beta1", 0.9)
    b2 = op.attrs.get("beta2", 0.999)
    eps = op.attrs.get("epsilon", 1e-8)
    if isinstance(g, tuple):
        # SelectedRows sparse adam (adam_op.h SparseAdamFunctor): moments
        # decay everywhere, grad adds on its rows
        rows, vals = g
        vals = vals.to(p.dtype)
        m_new = _rows_add(b1 * m, rows, (1 - b1) * vals)
        v_new = _rows_add(b2 * v, rows, (1 - b2) * vals * vals)
    else:
        g = g.to(p.dtype)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    ctx.out(op, "ParamOut", p_new)
    ctx.out(op, "Moment1Out", m_new)
    ctx.out(op, "Moment2Out", v_new)
    ctx.out(op, "Beta1PowOut", b1p * b1)
    ctx.out(op, "Beta2PowOut", b2p * b2)


@register("lamb")
def _lamb(ctx, op):
    p = ctx.inp(op, "Param")
    g = ctx.inp(op, "Grad")
    if isinstance(g, tuple):
        raise NotImplementedError(
            "lamb has no sparse (SelectedRows) update rule — the "
            "reference lamb_op is dense-only; train sparse embeddings "
            "with sgd/momentum/adam")
    g = g.to(p.dtype)
    m = ctx.inp(op, "Moment1")
    v = ctx.inp(op, "Moment2")
    lr = ctx.inp(op, "LearningRate")
    b1p = ctx.inp(op, "Beta1Pow")
    b2p = ctx.inp(op, "Beta2Pow")
    b1 = op.attrs.get("beta1", 0.9)
    b2 = op.attrs.get("beta2", 0.999)
    eps = op.attrs.get("epsilon", 1e-6)
    wd = op.attrs.get("weight_decay", 0.01)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    mhat = m_new / (1 - b1p)
    vhat = v_new / (1 - b2p)
    r = mhat / (torch.sqrt(vhat) + eps) + wd * p
    w_norm = torch.sqrt((p * p).sum())
    r_norm = torch.sqrt((r * r).sum())
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    ctx.out(op, "ParamOut", p - lr * trust * r)
    ctx.out(op, "Moment1Out", m_new)
    ctx.out(op, "Moment2Out", v_new)
    ctx.out(op, "Beta1PowOut", b1p * b1)
    ctx.out(op, "Beta2PowOut", b2p * b2)


@register("adagrad")
def _adagrad(ctx, op):
    p = ctx.inp(op, "Param")
    g = ctx.inp(op, "Grad").to(p.dtype)
    m = ctx.inp(op, "Moment")
    lr = ctx.inp(op, "LearningRate")
    eps = op.attrs.get("epsilon", 1e-6)
    m_new = m + g * g
    ctx.out(op, "ParamOut", p - lr * g / (torch.sqrt(m_new) + eps))
    ctx.out(op, "MomentOut", m_new)


@register("rmsprop")
def _rmsprop(ctx, op):
    p = ctx.inp(op, "Param")
    g = ctx.inp(op, "Grad").to(p.dtype)
    ms = ctx.inp(op, "MeanSquare")
    mom = ctx.inp(op, "Moment")
    lr = ctx.inp(op, "LearningRate")
    rho = op.attrs.get("decay", 0.95)
    eps = op.attrs.get("epsilon", 1e-6)
    mu = op.attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    ctx.out(op, "ParamOut", p - mom_new)
    ctx.out(op, "MeanSquareOut", ms_new)
    ctx.out(op, "MomentOut", mom_new)


@register("adadelta")
def _adadelta(ctx, op):
    p = ctx.inp(op, "Param")
    g = ctx.inp(op, "Grad").to(p.dtype)
    avg_sq = ctx.inp(op, "AvgSquaredGrad")
    avg_upd = ctx.inp(op, "AvgSquaredUpdate")
    rho = op.attrs.get("rho", 0.95)
    eps = op.attrs.get("epsilon", 1e-6)
    sq_new = rho * avg_sq + (1 - rho) * g * g
    upd = torch.sqrt(avg_upd + eps) / torch.sqrt(sq_new + eps) * g
    upd_new = rho * avg_upd + (1 - rho) * upd * upd
    ctx.out(op, "ParamOut", p - upd)
    ctx.out(op, "AvgSquaredGradOut", sq_new)
    ctx.out(op, "AvgSquaredUpdateOut", upd_new)


@register("adamax")
def _adamax(ctx, op):
    p = ctx.inp(op, "Param")
    g = ctx.inp(op, "Grad").to(p.dtype)
    m = ctx.inp(op, "Moment")
    inf_norm = ctx.inp(op, "InfNorm")
    b1p = ctx.inp(op, "Beta1Pow")
    lr = ctx.inp(op, "LearningRate")
    b1 = op.attrs.get("beta1", 0.9)
    b2 = op.attrs.get("beta2", 0.999)
    eps = op.attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf_norm, torch.abs(g))
    lr_t = lr / (1 - b1p)
    ctx.out(op, "ParamOut", p - lr_t * m_new / (inf_new + eps))
    ctx.out(op, "MomentOut", m_new)
    ctx.out(op, "InfNormOut", inf_new)
    ctx.out(op, "Beta1PowOut", b1p * b1)


@register("ftrl")
def _ftrl(ctx, op):
    p = ctx.inp(op, "Param")
    g = ctx.inp(op, "Grad").to(p.dtype)
    sq = ctx.inp(op, "SquaredAccumulator")
    lin = ctx.inp(op, "LinearAccumulator")
    lr = ctx.inp(op, "LearningRate")
    l1 = op.attrs.get("l1", 0.0)
    l2 = op.attrs.get("l2", 0.0)
    power = op.attrs.get("lr_power", -0.5)
    sq_new = sq + g * g
    sigma = (sq_new ** (-power) - sq ** (-power)) / lr
    lin_new = lin + g - sigma * p
    quad = sq_new ** (-power) / lr + 2 * l2
    pre = torch.clamp(lin_new, -l1, l1) - lin_new
    p_new = torch.where(torch.abs(lin_new) > l1, pre / quad,
                        torch.zeros_like(p))
    ctx.out(op, "ParamOut", p_new)
    ctx.out(op, "SquaredAccumOut", sq_new)
    ctx.out(op, "LinearAccumOut", lin_new)


# ============ grad clipping helpers ============

def _require_dense(x, op):
    if isinstance(x, tuple):
        raise NotImplementedError(
            f"op {op.type!r} cannot take a sparse (SelectedRows) gradient "
            f"— grad clipping/regularization over is_sparse embedding "
            f"grads is unsupported (reference restriction); drop the clip "
            f"or use a dense embedding")
    return x


@register("clip_by_norm")
def _clip_by_norm(ctx, op):
    ctx.out(op, "Out", K.clip_by_norm(_require_dense(ctx.inp(op, "X"), op),
                                      op.attrs["max_norm"]))


@register("squared_l2_norm")
def _sq_l2(ctx, op):
    x = _require_dense(ctx.inp(op, "X"), op)
    ctx.out(op, "Out", (x.to(torch.float32) ** 2).sum())


# ============ compare / logical (operators/controlflow/) ============

def _cmp(fn):
    def lower(ctx, op):
        ctx.out(op, "Out", fn(ctx.inp(op, "X"), ctx.inp(op, "Y")))
    return lower


register("less_than")(_cmp(lambda x, y: x < y))
register("less_equal")(_cmp(lambda x, y: x <= y))
register("greater_than")(_cmp(lambda x, y: x > y))
register("greater_equal")(_cmp(lambda x, y: x >= y))
register("equal")(_cmp(lambda x, y: x == y))
register("not_equal")(_cmp(lambda x, y: x != y))
register("logical_and")(_cmp(lambda x, y: x & y))
register("logical_or")(_cmp(lambda x, y: x | y))
register("logical_xor")(_cmp(lambda x, y: x ^ y))


@register("logical_not")
def _logical_not(ctx, op):
    ctx.out(op, "Out", ~ctx.inp(op, "X"))


# ============ scatter / gather_nd ============

@register("scatter")
def _scatter(ctx, op):
    x = ctx.inp(op, "X")
    ids = ctx.inp(op, "Ids")
    upd = ctx.inp(op, "Updates")
    if ids.dim() == 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    out = x.clone()
    out.index_put_((ids.long(),), upd.to(x.dtype),
                   accumulate=not op.attrs.get("overwrite", True))
    ctx.out(op, "Out", out)


@register("scatter_nd_add")
def _scatter_nd_add(ctx, op):
    x = ctx.inp(op, "X")
    idx = ctx.inp(op, "Index").long()
    upd = ctx.inp(op, "Updates")
    out = x.clone()
    out.index_put_(tuple(idx[..., d] for d in range(idx.shape[-1])),
                   upd.to(x.dtype), accumulate=True)
    ctx.out(op, "Out", out)


@register("gather_nd")
def _gather_nd(ctx, op):
    ctx.out(op, "Out", K.gather_nd(ctx.inp(op, "X"), ctx.inp(op, "Index")))


# ============ control flow (operators/controlflow/, recurrent_op.cc) =====
# The block runs op by op, so a while loop is a Python loop over its
# sub-block, a conditional block runs the taken branch only, and a
# recurrent op steps its sub-block over time.

def _as_pred(v):
    return bool(v.reshape(()).item())


@register("while")
def _while(ctx, op):
    prog = _require_program(ctx, op)
    blk_idx = op.attrs["sub_block"]
    carry_names = list(op.attrs["carry_names"])
    cond_name = op.input("Condition")[0]
    for n in carry_names:
        if isinstance(ctx.env.get(n), list):
            raise NotImplementedError(
                f"while: tensor-array {n!r} in loop carry is not "
                f"supported; carry a fixed-size buffer updated with "
                f"scatter instead (the JAX package's restriction)")
    base_env = dict(ctx.env)
    body_seed = ctx.next_seed()
    carry = {n: ctx.env[n] for n in carry_names}
    i = 0
    while _as_pred(carry[cond_name]):
        env = dict(base_env)
        env.update(carry)
        trace_block(prog, blk_idx, env, mix_seed(body_seed, i),
                    ctx.training, ctx.device)
        carry = {n: env[n] for n in carry_names}
        i += 1
    ctx.env.update(carry)


@register("conditional_block")
def _conditional_block(ctx, op):
    prog = _require_program(ctx, op)
    pred = _as_pred(ctx.env[op.input("Cond")[0]])
    carry = list(op.attrs["carry_names"])
    out_names = list(op.attrs["out_names"])
    seed_t, seed_f = ctx.next_seed(), ctx.next_seed()
    blk_idx, rets, seed = (op.attrs["sub_block_t"], op.attrs["true_rets"],
                           seed_t) if pred else \
        (op.attrs["sub_block_f"], op.attrs["false_rets"], seed_f)
    env = dict(ctx.env)
    trace_block(prog, blk_idx, env, seed, ctx.training, ctx.device)
    missing = [n for n in carry if n not in env]
    if missing:
        raise ValueError(
            f"cond: carried vars {missing} neither pre-exist nor are "
            f"written by both branches")
    for n, r in zip(out_names, rets):
        ctx.env[n] = env[r]
    for n in carry:
        ctx.env[n] = env[n]


@register("recurrent")
def _recurrent(ctx, op):
    prog = _require_program(ctx, op)
    a = op.attrs
    srcs = [ctx.env[n] for n in a["src_names"]]
    carry = [ctx.env[n] for n in a["boot_names"]]
    batch_major = a.get("batch_major", False)
    if batch_major:
        # DynamicRNN form over full-length rows: sequence (LoD) feeds,
        # whose rows stop at their lengths, come with ROADMAP item 8b
        srcs = [s.transpose(0, 1) for s in srcs]
    base_env = dict(ctx.env)
    body_seed = ctx.next_seed()
    T = srcs[0].shape[0] if srcs else 0
    steps = []
    for t in range(T):
        env = dict(base_env)
        env.update(zip(a["pre_names"], carry))
        env.update(zip(a["step_in_names"], [s[t] for s in srcs]))
        trace_block(prog, a["sub_block"], env, mix_seed(body_seed, t),
                    ctx.training, ctx.device)
        carry = [env[n] for n in a["new_names"]]
        steps.append([env[n] for n in a["step_out_names"]])
    for j, n in enumerate(a["out_names"]):
        y = torch.stack([s[j] for s in steps])
        ctx.env[n] = y.transpose(0, 1) if batch_major else y


# ====== LoDTensorArray ops (a python list in the env) ======

def _concrete_int(op, i):
    idx = op.attrs.get("static_index", -1)
    if idx is not None and idx >= 0:
        return idx
    return int(i.reshape(-1)[0].item()) if torch.is_tensor(i) else int(i)


@register("write_to_array")
def _write_to_array(ctx, op):
    x = ctx.inp(op, "X")
    i = ctx.inp(op, "I")
    name = op.output("Out")[0]
    arr = ctx.env.get(name)
    arr = list(arr) if isinstance(arr, list) else []
    idx = _concrete_int(op, i)
    if idx < len(arr):
        arr[idx] = x
    elif idx == len(arr):
        arr.append(x)
    else:
        raise IndexError(
            f"write_to_array: index {idx} beyond array length "
            f"{len(arr)} (sparse writes are not supported)")
    ctx.env[name] = arr


@register("read_from_array")
def _read_from_array(ctx, op):
    arr = ctx.inp(op, "X")
    if not isinstance(arr, list) or not arr:
        raise ValueError(
            f"read_from_array: {op.input('X')[0]!r} is empty or not a "
            f"tensor array")
    ctx.out(op, "Out", arr[_concrete_int(op, ctx.inp(op, "I"))])


@register("lod_array_length")
def _lod_array_length(ctx, op):
    arr = ctx.inp(op, "X")
    n = len(arr) if isinstance(arr, list) else 0
    ctx.out(op, "Out", ctx.tensor([n], torch.int64))


@register("tensor_array_to_tensor")
def _tensor_array_to_tensor(ctx, op):
    arr = ctx.inp(op, "X")
    axis = op.attrs.get("axis", 0)
    if op.attrs.get("use_stack", False):
        ctx.out(op, "Out", torch.stack(arr, axis))
    else:
        ctx.out(op, "Out", torch.cat(arr, axis))
    ctx.out(op, "OutIndex",
            ctx.tensor([a.shape[axis] for a in arr], torch.int32))


# ============ misc ============

@register("increment")
def _increment(ctx, op):
    x = ctx.inp(op, "X")
    ctx.out(op, "Out", x + ctx.tensor(op.attrs.get("step", 1.0), x.dtype))


@register("seq_pool_placeholder")
def _noop(ctx, op):
    pass


# ====== int8 quantized kernels (contrib/slim PTQ output ops) ======
# Activations quantize on the fly (scale calibrated offline), weights are
# stored int8, and the products accumulate exactly: the int8 operands go
# through a float64 product, whose sums of int8 products are exact.

def _quant_act_int8(x, s_in):
    return torch.clamp(torch.round(x / s_in), -127, 127).to(torch.int8)


def _dequant_scales(op):
    return np.asarray(op.attrs["weight_scales"], np.float32)


@register("quantized_mul")
@register("quantized_matmul")
@register("quantized_matmul_v2")
def _quantized_mul(ctx, op):
    x = ctx.inp(op, "X")
    w = ctx.inp(op, "Y")
    s_in = op.attrs["in_scale"]
    scales = _dequant_scales(op)
    if op.type == "quantized_mul":
        ncol = op.attrs.get("x_num_col_dims", 1)
        lead = tuple(x.shape[:ncol])
        xm = x.reshape(int(np.prod(lead)) if lead else 1, -1)
    else:
        if op.attrs.get("transpose_X", op.attrs.get("trans_x", False)):
            x = x.transpose(-1, -2)
        lead = tuple(x.shape[:-1])
        xm = x.reshape(-1, x.shape[-1])
        if op.attrs.get("transpose_Y", op.attrs.get("trans_y", False)):
            w = w.T
    xq = _quant_act_int8(xm, s_in)
    acc = torch.matmul(xq.to(torch.float64), w.to(torch.float64))
    if scales.size == acc.shape[1]:
        out = acc.to(torch.float32) * (
            s_in * ctx.tensor(scales, torch.float32))[None, :]
    else:
        out = acc.to(torch.float32) * (s_in * float(scales.reshape(-1)[0]))
    alpha = op.attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.out(op, "Out", out.reshape(lead + (out.shape[-1],)))


@register("quantized_conv2d")
@register("quantized_depthwise_conv2d")
def _quantized_conv2d(ctx, op):
    x = ctx.inp(op, "Input")
    w = ctx.inp(op, "Filter")
    s_in = op.attrs["in_scale"]
    scales = _dequant_scales(op)
    xq = _quant_act_int8(x, s_in)
    out = K.conv2d(xq.to(torch.float64), w.to(torch.float64),
                   op.attrs.get("strides", [1, 1]),
                   op.attrs.get("paddings", [0, 0]),
                   op.attrs.get("dilations", [1, 1]),
                   op.attrs.get("groups", 1)).to(torch.float32)
    if scales.ndim and scales.shape[0] == out.shape[1]:
        out = out * (s_in * ctx.tensor(scales, torch.float32))[
            None, :, None, None]
    else:
        out = out * (s_in * float(scales.reshape(-1)[0]))
    ctx.out(op, "Output", out)


# ====== book-era op additions (fluid/layers/nn.py 15.2k surface) ======

@register("sigmoid_cross_entropy_with_logits")
def _sce_logits(ctx, op):
    x = ctx.inp(op, "X")
    label = ctx.inp(op, "Label").to(x.dtype)
    ignore = op.attrs.get("ignore_index", -100)
    loss = torch.clamp(x, min=0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    mask = (label != ignore).to(x.dtype)
    loss = loss * mask
    if op.attrs.get("normalize", False):
        loss = loss / torch.clamp(mask.sum(), min=1.0)
    ctx.out(op, "Out", loss)


@register("smooth_l1_loss")
def _smooth_l1(ctx, op):
    x = ctx.inp(op, "X")
    y = ctx.inp(op, "Y")
    iw = ctx.inp(op, "InsideWeight")
    ow = ctx.inp(op, "OutsideWeight")
    sigma2 = float(op.attrs.get("sigma", 1.0)) ** 2
    d = x - y
    if iw is not None:
        d = d * iw
    ad = torch.abs(d)
    per = torch.where(ad < 1.0 / sigma2, 0.5 * d * d * sigma2,
                      ad - 0.5 / sigma2)
    if ow is not None:
        per = per * ow
    ctx.out(op, "Diff", d)
    ctx.out(op, "Out", per.reshape(per.shape[0], -1).sum(1, keepdim=True))


@register("label_smooth")
def _label_smooth(ctx, op):
    x = ctx.inp(op, "X")
    eps = op.attrs.get("epsilon", 0.1)
    prior = ctx.inp(op, "PriorDist")
    if prior is not None:
        ctx.out(op, "Out", x * (1.0 - eps) + eps * prior)
    else:
        ctx.out(op, "Out", x * (1.0 - eps) + eps / x.shape[-1])


@register("cumsum")
def _cumsum(ctx, op):
    x0 = ctx.inp(op, "X")
    axis = op.attrs.get("axis", -1)
    rev = op.attrs.get("reverse", False)
    x = torch.flip(x0, (axis,)) if rev else x0
    out = torch.cumsum(x, axis)
    if op.attrs.get("exclusive", False):
        out = out - x
    if rev:
        out = torch.flip(out, (axis,))
    ctx.out(op, "Out", out)


@register("reverse")
def _reverse(ctx, op):
    x = ctx.inp(op, "X")
    for ax in op.attrs.get("axis", [0]):
        x = torch.flip(x, (ax,))
    ctx.out(op, "Out", x)


@register("lod_reset")
def _lod_reset(ctx, op):
    raise NotImplementedError(
        "lod_reset sets a sequence (LoD) tensor's lengths: LoD feeds come "
        "with ROADMAP item 8b")


# ====== op-surface widening batch 2 (operators/*.cc parity) ======

for _n2, _f2 in {
    "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
    "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "expm1": torch.expm1, "selu": K.selu, "isnan_v2": torch.isnan,
    "isinf_v2": torch.isinf, "isfinite_v2": torch.isfinite,
    "fill_zeros_like": torch.zeros_like,
}.items():
    _unary(_n2, _f2)


@register("prelu")
def _prelu(ctx, op):
    x = ctx.inp(op, "X")
    alpha = ctx.inp(op, "Alpha")
    if op.attrs.get("mode", "all") == "channel" and alpha.dim() == 1 and \
            x.dim() >= 2:
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    ctx.out(op, "Out", torch.where(x > 0, x, alpha * x))


@register("group_norm")
def _group_norm(ctx, op):
    ctx.out(op, "Y", K.group_norm(
        ctx.inp(op, "X"), op.attrs["groups"], ctx.inp(op, "Scale"),
        ctx.inp(op, "Bias"), op.attrs.get("epsilon", 1e-5)))


@register("instance_norm")
def _instance_norm(ctx, op):
    ctx.out(op, "Y", K.instance_norm(
        ctx.inp(op, "X"), ctx.inp(op, "Scale"), ctx.inp(op, "Bias"),
        op.attrs.get("epsilon", 1e-5)))


@register("rms_norm")
def _rms_norm(ctx, op):
    ctx.out(op, "Y", K.rms_norm(ctx.inp(op, "X"), ctx.inp(op, "Scale"),
                                op.attrs.get("epsilon", 1e-6)))


@register("norm")
def _norm_op(ctx, op):
    """l2_normalize's backing op (norm_op.cc): x / ||x||_2 along axis."""
    x = ctx.inp(op, "X")
    axis = op.attrs.get("axis", -1)
    eps = op.attrs.get("epsilon", 1e-10)
    n = torch.sqrt((x * x).sum(axis, keepdim=True) + eps)
    ctx.out(op, "Out", x / n)
    ctx.out(op, "Norm", n)


@register("p_norm")
def _p_norm(ctx, op):
    ctx.out(op, "Out", K.norm(ctx.inp(op, "X"),
                              op.attrs.get("porder", 2.0),
                              op.attrs.get("axis", None),
                              op.attrs.get("keepdim", False)))


@register("frobenius_norm")
def _fro_norm(ctx, op):
    x = ctx.inp(op, "X")
    dims = tuple(op.attrs.get("dim", [-2, -1]))
    ctx.out(op, "Out", torch.sqrt((x * x).sum(
        dims, keepdim=op.attrs.get("keep_dim", False))))


@register("roll")
def _roll(ctx, op):
    axis = op.attrs.get("axis", None)
    ctx.out(op, "Out", K.roll(ctx.inp(op, "X"), op.attrs["shifts"],
                              axis if axis else None))


@register("flip")
def _flip(ctx, op):
    ctx.out(op, "Out", K.flip(ctx.inp(op, "X"), op.attrs["axis"]))


@register("cumprod")
def _cumprod(ctx, op):
    ctx.out(op, "Out", K.cumprod(ctx.inp(op, "X"), op.attrs.get("dim")))


@register("diag_v2")
def _diag_v2(ctx, op):
    ctx.out(op, "Out", K.diag(ctx.inp(op, "X"),
                              op.attrs.get("offset", 0),
                              op.attrs.get("padding_value", 0.0)))


@register("meshgrid")
def _meshgrid(ctx, op):
    ctx.outs(op, "Out", K.meshgrid(*ctx.inps(op, "X")))


@register("argsort")
def _argsort(ctx, op):
    x = ctx.inp(op, "X")
    axis = op.attrs.get("axis", -1)
    ids = K.argsort(x, axis, op.attrs.get("descending", False))
    ctx.out(op, "Indices", ids)
    ctx.out(op, "Out", torch.gather(x, axis, ids.long()))


@register("tril_triu")
def _tril_triu(ctx, op):
    fn = K.tril if op.attrs.get("lower", True) else K.triu
    ctx.out(op, "Out", fn(ctx.inp(op, "X"), op.attrs.get("diagonal", 0)))


@register("multiplex")
def _multiplex(ctx, op):
    ids = ctx.inp(op, "Ids")
    if ids.dim() == 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    ctx.out(op, "Out", K.multiplex(ctx.inps(op, "X"), ids))


@register("strided_slice")
def _strided_slice(ctx, op):
    ctx.out(op, "Out", K.strided_slice(
        ctx.inp(op, "Input"), op.attrs["axes"], op.attrs["starts"],
        op.attrs["ends"], op.attrs["strides"]))


@register("expand_as_v2")
def _expand_as(ctx, op):
    x = ctx.inp(op, "X")
    shape = op.attrs.get("target_shape")
    if shape is None:
        shape = ctx.inp(op, "Y").shape
    ctx.out(op, "Out", torch.broadcast_to(x, tuple(shape)))


@register("index_select")
def _index_select(ctx, op):
    ctx.out(op, "Out", K.index_select(
        ctx.inp(op, "X"), ctx.inp(op, "Index"), op.attrs.get("dim", 0)))


@register("index_sample")
def _index_sample(ctx, op):
    ctx.out(op, "Out", K.index_sample(ctx.inp(op, "X"),
                                      ctx.inp(op, "Index")))


@register("where")
def _where(ctx, op):
    ctx.out(op, "Out", K.where(ctx.inp(op, "Condition"),
                               ctx.inp(op, "X"), ctx.inp(op, "Y")))


def _bool_reduce(fn):
    def lower(ctx, op):
        x = ctx.inp(op, "X")
        keep = op.attrs.get("keep_dim", False)
        if op.attrs.get("reduce_all", False):
            out = fn(x.bool())
            ctx.out(op, "Out", out.reshape((1,) * x.dim()) if keep else out)
        else:
            ctx.out(op, "Out", fn(x.bool(), tuple(op.attrs.get("dim", [0])),
                                  keepdim=keep))
    return lower


register("reduce_all")(_bool_reduce(torch.all))
register("reduce_any")(_bool_reduce(torch.any))


@register("logsumexp")
def _logsumexp(ctx, op):
    ctx.out(op, "Out", K.logsumexp(
        ctx.inp(op, "X"),
        None if op.attrs.get("reduce_all", False)
        else tuple(op.attrs.get("axis", [0])),
        op.attrs.get("keepdim", False)))


@register("size")
def _size(ctx, op):
    ctx.out(op, "Out", ctx.tensor(ctx.inp(op, "Input").numel(),
                                  torch.int64))


@register("fill_any_like")
def _fill_any_like(ctx, op):
    x = ctx.inp(op, "X")
    dt = op.attrs.get("dtype", -1)
    out_dt = _dt(dt) if isinstance(dt, str) or dt not in (-1,) else x.dtype
    ctx.out(op, "Out", torch.full_like(x, op.attrs.get("value", 0.0),
                                       dtype=out_dt))


def _host_scalar(v):
    return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v
                      ).reshape(())


@register("range")
def _range(ctx, op):
    start, end, step = (float(_host_scalar(ctx.inp(op, s)))
                        for s in ("Start", "End", "Step"))
    # the JAX op: jnp.arange over Python floats (float32 values)
    ctx.out(op, "Out", ctx.tensor(np.arange(start, end, step)
                                  .astype(np.float32)))


@register("linspace")
def _linspace(ctx, op):
    s = float(_host_scalar(ctx.inp(op, "Start")))
    e = float(_host_scalar(ctx.inp(op, "Stop")))
    n = int(_host_scalar(ctx.inp(op, "Num")))
    ctx.out(op, "Out", ctx.tensor(np.linspace(s, e, n).astype(np.float32)))


@register("eye")
def _eye(ctx, op):
    n = int(op.attrs["num_rows"])
    m = int(op.attrs.get("num_columns") or n)
    ctx.out(op, "Out", torch.eye(n, m, dtype=_dt(op.attrs.get("dtype")),
                                 device=ctx.device))


@register("cos_sim")
def _cos_sim(ctx, op):
    """cos_sim_op.h (the word2vec book net's similarity head)."""
    x = ctx.inp(op, "X")
    y = ctx.inp(op, "Y")
    xn = torch.sqrt((x * x).sum(-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(-1, keepdim=True))
    ctx.out(op, "Out", (x * y).sum(-1, keepdim=True) /
            torch.clamp(xn * yn, min=1e-12))
    ctx.out(op, "XNorm", xn)
    ctx.out(op, "YNorm", yn)


@register("huber_loss")
def _huber(ctx, op):
    x = ctx.inp(op, "X")
    y = ctx.inp(op, "Y")
    delta = op.attrs.get("delta", 1.0)
    d = y - x
    ad = torch.abs(d)
    ctx.out(op, "Out", torch.where(ad <= delta, 0.5 * d * d,
                                   delta * (ad - 0.5 * delta)))
    ctx.out(op, "Residual", d)


@register("log_loss")
def _log_loss(ctx, op):
    p = ctx.inp(op, "Predicted")
    y = ctx.inp(op, "Labels")
    eps = op.attrs.get("epsilon", 1e-4)
    ctx.out(op, "Loss", -y * torch.log(p + eps) -
            (1 - y) * torch.log(1 - p + eps))


@register("affine_channel")
def _affine_channel(ctx, op):
    x = ctx.inp(op, "X")
    shape = (1, -1) + (1,) * (x.dim() - 2)
    ctx.out(op, "Out", x * ctx.inp(op, "Scale").reshape(shape) +
            ctx.inp(op, "Bias").reshape(shape))


@register("pixel_shuffle")
def _pixel_shuffle(ctx, op):
    x = ctx.inp(op, "X")
    r = op.attrs.get("upscale_factor", 1)
    b, c, h, w = x.shape
    x = x.reshape(b, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    ctx.out(op, "Out", x.reshape(b, c // (r * r), h * r, w * r))


def _interp_out_hw(op, x):
    oh = op.attrs.get("out_h", -1)
    ow = op.attrs.get("out_w", -1)
    scale = op.attrs.get("scale", 0.0)
    if (oh is None or oh <= 0) and scale:
        if isinstance(scale, (list, tuple)):
            sh, sw = (scale[0], scale[1]) if len(scale) > 1 else \
                (scale[0], scale[0])
        else:
            sh = sw = scale
        oh = int(x.shape[2] * sh)
        ow = int(x.shape[3] * sw)
    return oh, ow


@register("nearest_interp")
@register("nearest_interp_v2")
def _nearest_interp(ctx, op):
    x = ctx.inp(op, "X")
    ctx.out(op, "Out", K.interpolate_nearest(x, _interp_out_hw(op, x)))


@register("bilinear_interp")
@register("bilinear_interp_v2")
def _bilinear_interp(ctx, op):
    x = ctx.inp(op, "X")
    ctx.out(op, "Out", K.interpolate_bilinear(
        x, _interp_out_hw(op, x), op.attrs.get("align_corners", False),
        int(op.attrs.get("align_mode", 1))))


@register("grid_sampler")
def _grid_sampler(ctx, op):
    """grid_sampler_op: sampling at normalized grid coords [-1, 1] with
    the op's align_corners / mode / padding_mode attrs honored
    (bilinear|nearest, zeros|border padding), as the JAX lowering
    computes it."""
    x = ctx.inp(op, "X")
    grid = ctx.inp(op, "Grid")  # [B, H', W', 2] (gx, gy)
    B, C, H, W = x.shape
    align = op.attrs.get("align_corners", True)
    mode = op.attrs.get("mode", "bilinear")
    padding = op.attrs.get("padding_mode", "zeros")
    if mode not in ("bilinear", "nearest") or \
            padding not in ("zeros", "border"):
        raise NotImplementedError(
            f"grid_sampler mode={mode!r} padding_mode={padding!r} "
            f"unsupported (bilinear/nearest x zeros/border)")

    def denorm(g, size):
        if align:
            return (g + 1.0) * 0.5 * (size - 1)
        return ((g + 1.0) * size - 1.0) * 0.5

    gx = denorm(grid[..., 0], W)
    gy = denorm(grid[..., 1], H)
    in_x = (gx >= 0) & (gx <= W - 1)
    in_y = (gy >= 0) & (gy <= H - 1)
    bidx = torch.arange(B, device=x.device).reshape(B, 1, 1)

    def gather2(yy, xx):
        yy = torch.clamp(yy, 0, H - 1).to(torch.int32).long()
        xx = torch.clamp(xx, 0, W - 1).to(torch.int32).long()
        return x[bidx, :, yy, xx].permute(0, 3, 1, 2)  # [B, C, H', W']

    mask = (in_x & in_y)[:, None]
    if mode == "nearest":
        out = gather2(torch.round(gy), torch.round(gx))
    else:
        x0 = torch.floor(gx)
        y0 = torch.floor(gy)
        lx = torch.clamp(gx - x0, 0.0, 1.0)[:, None]
        ly = torch.clamp(gy - y0, 0.0, 1.0)[:, None]
        out = (gather2(y0, x0) * (1 - ly) * (1 - lx) +
               gather2(y0, x0 + 1) * (1 - ly) * lx +
               gather2(y0 + 1, x0) * ly * (1 - lx) +
               gather2(y0 + 1, x0 + 1) * ly * lx)
    if padding == "zeros":
        out = out * mask.to(out.dtype)
    ctx.out(op, "Output", out)


@register("fc")
def _fc_fused(ctx, op):
    """fc_fuse_pass output: mul + bias in one op (fc_op.cc parity)."""
    slot = "Input" if op.input("Input") else "X"
    x = ctx.inp(op, slot)
    w = ctx.inp(op, "W") if op.input("W") else ctx.inp(op, "Y")
    out = mul_op(x, w, op.attrs.get("in_num_col_dims", 1), 1)
    b = ctx.inp(op, "Bias")
    if b is not None:
        out = out + b
    ctx.out(op, "Out", out)


# ====== structured sequence losses + rnn units + ranking losses ======

def _full_lengths(t):
    return torch.full((t.shape[0],), t.shape[1], dtype=torch.int32,
                      device=t.device)


@register("warpctc")
def _warpctc(ctx, op):
    """warpctc_op over padded [B, T, C] logits with explicit
    LogitsLength / LabelLength (full length without them)."""
    from ..ops import sequence_losses as SL

    logits = ctx.inp(op, "Logits")
    label = ctx.inp(op, "Label")
    lg_len = ctx.inp(op, "LogitsLength")
    lb_len = ctx.inp(op, "LabelLength")
    if lg_len is None:
        lg_len = _full_lengths(logits)
    if lb_len is None:
        lb_len = _full_lengths(label)
    if label.dim() == 3 and label.shape[-1] == 1:
        label = label[..., 0]
    lp = F.log_softmax(logits.to(torch.float32), -1)
    loss = SL.ctc_loss(lp.movedim(1, 0), label, lg_len, lb_len,
                       blank=op.attrs.get("blank", 0))
    if op.attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(lg_len.reshape(-1).to(loss.dtype),
                                  min=1.0)
    ctx.out(op, "Loss", loss[:, None])


@register("linear_chain_crf")
def _linear_chain_crf(ctx, op):
    from ..ops import sequence_losses as SL

    em = ctx.inp(op, "Emission")
    label = ctx.inp(op, "Label")
    lens = ctx.inp(op, "Length")
    if lens is None:
        lens = _full_lengths(em)
    if label.dim() == 3 and label.shape[-1] == 1:
        label = label[..., 0]
    ll = SL.crf_log_likelihood(em, ctx.inp(op, "Transition"), label, lens)
    ctx.out(op, "LogLikelihood", ll[:, None])


@register("crf_decoding")
def _crf_decoding(ctx, op):
    from ..ops import sequence_losses as SL

    em = ctx.inp(op, "Emission")
    lens = ctx.inp(op, "Length")
    if lens is None:
        lens = _full_lengths(em)
    path, _ = SL.crf_decode(em, ctx.inp(op, "Transition"), lens)
    label = ctx.inp(op, "Label")
    if label is not None:
        # fluid contract: with Label given, output a 0/1 per-position
        # CORRECTNESS mask (crf_decoding_op.h), not the path itself
        if label.dim() == 3 and label.shape[-1] == 1:
            label = label[..., 0]
        path = (path == label.to(path.dtype)).to(torch.int64)
    ctx.out(op, "ViterbiPath", path)


@register("im2sequence")
def _im2sequence(ctx, op):
    """im2sequence_op (OCR pipelines): image patches -> row-major token
    sequence [B, out_h*out_w, C*kh*kw]."""
    x = ctx.inp(op, "X")
    kh, kw = op.attrs["kernels"]
    sh, sw = op.attrs.get("strides", [1, 1])
    pu, pl_, pd, pr = op.attrs.get("paddings", [0, 0, 0, 0])
    x = F.pad(x, (pl_, pr, pu, pd))
    cols = F.unfold(x, (kh, kw), stride=(sh, sw))   # [B, C*kh*kw, L]
    ctx.out(op, "Out", cols.transpose(1, 2))


@register("gru_unit")
def _gru_unit(ctx, op):
    from ..ops import sequence as S

    x = ctx.inp(op, "Input")
    hs = S.dynamic_gru(
        x[:, None, :],
        torch.ones((x.shape[0],), dtype=torch.int32, device=x.device),
        ctx.inp(op, "Weight"), ctx.inp(op, "Bias"),
        ctx.inp(op, "HiddenPrev"),
        gate_activation=op.attrs.get("gate_activation", "sigmoid"),
        candidate_activation=op.attrs.get("activation", "tanh"),
        origin_mode=op.attrs.get("origin_mode", False))
    ctx.out(op, "Hidden", hs[:, 0])


@register("lstm_unit")
def _lstm_unit(ctx, op):
    """lstm_unit_op.h: X already carries the 4 gate pre-activations in
    order (i, f, o, g); no recurrent weight inside the op."""
    x = ctx.inp(op, "X")
    c_prev = ctx.inp(op, "C_prev")
    fb = op.attrs.get("forget_bias", 0.0)
    D = x.shape[-1] // 4
    i = torch.sigmoid(x[:, :D])
    f = torch.sigmoid(x[:, D:2 * D] + fb)
    o = torch.sigmoid(x[:, 2 * D:3 * D])
    g = torch.tanh(x[:, 3 * D:])
    c = f * c_prev + i * g
    ctx.out(op, "C", c)
    ctx.out(op, "H", o * torch.tanh(c))


@register("margin_rank_loss")
def _margin_rank(ctx, op):
    label = ctx.inp(op, "Label")
    left = ctx.inp(op, "X1")
    right = ctx.inp(op, "X2")
    out = torch.clamp(-label * (left - right) + op.attrs.get("margin", 0.0),
                      min=0.0)
    ctx.out(op, "Out", out)
    ctx.out(op, "Activated", (out > 0).to(left.dtype))


@register("rank_loss")
def _rank_loss(ctx, op):
    label = ctx.inp(op, "Label")
    d = ctx.inp(op, "Left") - ctx.inp(op, "Right")
    # logaddexp(0, d) = log(1 + e^d), overflow-safe for large gaps
    ctx.out(op, "Out", torch.logaddexp(torch.zeros_like(d), d) - label * d)


@register("hinge_loss")
def _hinge_loss(ctx, op):
    logits = ctx.inp(op, "Logits")
    labels = ctx.inp(op, "Labels").to(logits.dtype)
    ctx.out(op, "Loss",
            torch.clamp(1.0 - (2.0 * labels - 1.0) * logits, min=0.0))


# ====== the fused inference targets (ir.py passes) ======

@register("fused_sdpa")
def _fused_sdpa(ctx, op):
    """Target of multihead_matmul_fuse_pass: scaled-dot-product attention
    over [B, H, T, D] (or [B*H, T, D]) tensors through `ops.attention.sdpa`:
    on the card a [B, 1, 1, T] (or absent) mask takes the flash forward
    kernel; a mask that varies per query or head raises there."""
    from ..ops import attention as A

    q = ctx.inp(op, "Q")
    k = ctx.inp(op, "K")
    v = ctx.inp(op, "V")
    mask = ctx.inp(op, "Mask")
    scale = float(op.attrs.get("scale", 1.0))
    squeeze = False
    if q.dim() == 3:  # [B*H, T, D]: lift to 4-D for the kernel
        q, k, v = (t[None] for t in (q, k, v))
        if mask is not None and mask.dim() == 3:
            mask = mask[None]
        squeeze = True
    # sdpa applies scale to q @ k^T itself; the pass folded the program's
    # scale/alpha into `scale`
    out = A.sdpa(q, k, v, mask=mask, scale=scale)
    ctx.out(op, "Out", out[0] if squeeze else out)


@register("skip_layernorm")
def _skip_layernorm(ctx, op):
    """skip_layernorm_op: layer_norm(X + Y) — the residual+LN pair the
    skip_layernorm_fuse_pass forms (ir/skip_layernorm_fuse_pass.cc)."""
    x = ctx.inp(op, "X")
    y = ctx.inp(op, "Y")
    ctx.out(op, "Out", _flat_ln(
        x + y, ctx.inp(op, "Scale"), ctx.inp(op, "Bias"),
        op.attrs.get("epsilon", 1e-5),
        int(op.attrs.get("begin_norm_axis", x.dim() - 1))))


@register("fused_fc_elementwise_layernorm")
def _fused_fc_eltwise_ln(ctx, op):
    """fused_fc_elementwise_layernorm_op.cc: layer_norm(fc(X) + Y)."""
    x = ctx.inp(op, "X")
    y = ctx.inp(op, "Y")
    out = mul_op(x, ctx.inp(op, "W"), int(op.attrs.get("in_num_col_dims", 1)),
                 1)
    b0 = ctx.inp(op, "Bias0")
    if b0 is not None:
        out = out + b0
    out = out.reshape(y.shape) + y
    ctx.out(op, "Out", _flat_ln(
        out, ctx.inp(op, "Scale"), ctx.inp(op, "Bias1"),
        op.attrs.get("epsilon", 1e-5),
        int(op.attrs.get("begin_norm_axis", out.dim() - 1))))


@register("multihead_matmul")
def _multihead_matmul(ctx, op):
    """Fused encoder attention (fused/multihead_matmul_op.cc): input
    [B, S, 3H] already projected by a merged QKV weight, or input + W/Bias
    to project here; BiasQK is the additive attention mask. The attention
    runs `ops.attention.sdpa` (the flash forward kernel on the card)."""
    from ..ops import attention as A

    x = ctx.inp(op, "Input")
    w = ctx.inp(op, "W")
    b = ctx.inp(op, "Bias")
    bias_qk = ctx.inp(op, "BiasQK")
    heads = op.attrs.get("head_number", 1)
    if w is not None:
        # W: [H, 3, heads, dh] merged qkv (the fuse pass layout)
        h = x.shape[-1]
        qkv = torch.einsum("bsh,htd->bstd", x, w.reshape(h, 3, -1))
        if b is not None:
            qkv = qkv + b.reshape(1, 1, 3, -1)
    else:
        qkv = x.reshape(x.shape[0], x.shape[1], 3, -1)
    bsz, slen = qkv.shape[0], qkv.shape[1]
    dh = qkv.shape[-1] // heads

    def split(i):
        return qkv[:, :, i].reshape(bsz, slen, heads, dh).transpose(1, 2)

    scale = op.attrs.get("alpha", 1.0 / float(np.sqrt(dh)))
    out = A.sdpa(split(0), split(1), split(2), mask=bias_qk, scale=scale)
    ctx.out(op, "Out", out.transpose(1, 2).reshape(bsz, slen, heads * dh))


@register("fused_embedding_eltwise_layernorm")
def _fused_emb_ln(ctx, op):
    ids = ctx.inps(op, "Ids")
    embs = ctx.inps(op, "Embs")
    eps = op.attrs.get("epsilon", 1e-5)
    acc = None
    for i, e in zip(ids, embs):
        v = e[i.reshape(i.shape[0], -1).long()]
        acc = v if acc is None else acc + v
    mu = acc.mean(-1, keepdim=True)
    var = acc.var(-1, unbiased=False, keepdim=True)
    ctx.out(op, "Out", (acc - mu) / torch.sqrt(var + eps) *
            ctx.inp(op, "Scale") + ctx.inp(op, "Bias"))


@register("jax_exported")
def _jax_exported(ctx, op):
    raise NotImplementedError(
        "jax_exported runs a jit-saved artifact: its counterpart comes "
        "with ROADMAP item 8d")


__all__ = ["register", "get_lowering", "has_lowering", "lower_op",
           "LowerCtx", "trace_block", "mix_seed", "mul_op", "dropout",
           "ITEM_8B"]
