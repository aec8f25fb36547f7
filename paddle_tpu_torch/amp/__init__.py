"""Automatic mixed precision.

Reference parity: imperative/amp_auto_cast.h:29 + fluid/dygraph/amp/
(auto_cast.py:90 amp_guard, loss_scaler.py:27 AmpScaler). The policy is
the JAX package's, applied where the JAX package applies it: at each op
of its eager dispatch, by the op's name, to the op's own inputs.

  * The port's functions that the JAX package dispatches by name
    (`nn.functional` and `tensor`: `linear`, `conv2d`, `layer_norm`,
    `cross_entropy`, `scaled_dot_product_attention` as "sdpa", `matmul`,
    `sum` as "reduce_sum", ... `_FUNCTIONAL_OPS`, `_TENSOR_OPS`), and
    the layers' own computations where the JAX layer calls one of them
    (`Linear` as "linear", `LayerNorm`, `Embedding`; `op`), cast their
    float tensor arguments on entry and run their bodies uncast: a
    `layer_norm` under O1 computes in float32 whatever its body does.
  * The Tensor operators of user code (`*` as "mul", `@` as "matmul",
    `+`, `-`, `/`, `**`, the reductions `.sum()` as "reduce_sum",
    `.mean()`, `.logsumexp()`, `.norm()`, and the casts `.to(dtype)`,
    `.float()`, ...)
    reach the policy through a `torch.overrides.TorchFunctionMode`
    active only inside `auto_cast` (`torch.Tensor` is not patched). It
    does not reach the torch calls inside the port's functions, nor a
    backward pass. Layout methods (view, reshape, transpose, indexing)
    keep their input's type where the JAX package's O2 also casts them;
    the next arithmetic op casts, so values agree.

Levels: O1 casts the WHITE_LIST ops to the amp dtype and the BLACK_LIST
ops to float32; O2 casts every op's float inputs to the amp dtype but
the black list's. Any other level behaves as O1, "O0" included, as in
the JAX package's code: only `enable=False` turns the casts off. Only
float32, float16 and bfloat16 tensors are cast, as in JAX (float64
stays). Consequences kept on purpose:
  * Under O2 `x.astype("float32")` (or `.float()`) first casts x to the
    amp dtype: a float32 tensor holding amp-dtype values.
  * Under "sdpa" a float mask is cast with q, k and v, so the kernels'
    float32 key bias carries the rounded values (-10000 in bf16 is
    -9984).
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_guard",
           "GradScaler", "AmpScaler", "decorate", "op"]

_state = threading.local()
_LOCK = threading.Lock()
#: auto_cast blocks open in any thread: 0 means every hook returns at
#: one module-global read
_ACTIVE = 0

# ops that run in low precision under O1 (fp16_lists.py:20 white_list)
WHITE_LIST = {"matmul", "linear", "conv2d", "conv1d", "bmm", "mul", "einsum",
              "sdpa"}
# ops kept in float32 (reductions, losses, norms: the black list)
BLACK_LIST = {"softmax_with_cross_entropy", "cross_entropy", "reduce_mean",
              "reduce_sum", "layer_norm", "batch_norm", "log_softmax",
              "norm", "logsumexp", "bce_logits", "bce_loss"}

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)


def _amp_dtype(name):
    return torch.bfloat16 if str(name).replace("torch.", "") in (
        "bfloat16", "bf16") else torch.float16


def _target(op_name):
    """The dtype the active policy gives the float inputs of `op_name`
    (None: leave them as they are)."""
    st = _state
    if op_name in st.black:
        return torch.float32
    if st.level == "O2" or op_name in st.white:
        return st.dtype
    return None


def _cast(x, dt):
    if isinstance(x, torch.Tensor) and x.dtype in _FLOATS and x.dtype != dt:
        return x.to(dt)
    if isinstance(x, (list, tuple)) and any(
            isinstance(t, torch.Tensor) for t in x):
        return type(x)(_cast(t, dt) for t in x)
    return x


def _cast_all(dt, args, kw):
    return (tuple(_cast(a, dt) for a in args),
            {k: _cast(v, dt) for k, v in kw.items()})


def _policy_applies():
    """This thread is inside an auto_cast that casts, outside any port
    function's body and outside a backward pass."""
    st = _state
    return (getattr(st, "dtype", None) is not None and not st.inside
            and torch._C._current_graph_task_id() == -1)


def op(name, fn):
    """`fn` under the policy as the JAX op `name` (a string, or a
    function of (args, kwargs) for the ops whose JAX name depends on an
    argument): its float tensor arguments are cast on entry, and its
    body runs with the policy off, as a JAX op's body runs on raw
    arrays."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        if not _ACTIVE or not _policy_applies():
            return fn(*args, **kw)
        dt = _target(name if isinstance(name, str) else name(args, kw))
        st = _state
        st.inside += 1          # the casts below are not user casts
        try:
            if dt is not None:
                args, kw = _cast_all(dt, args, kw)
            return fn(*args, **kw)
        finally:
            st.inside -= 1
    return wrapped


def _batch_norm_name(args, kw):
    training = kw.get("training", args[5] if len(args) > 5 else False)
    return "batch_norm" if training else "batch_norm_infer"


def _interp_name(args, kw):
    return "interp_" + kw.get("mode", args[3] if len(args) > 3
                              else "nearest")


#: the port's nn.functional functions that the JAX package dispatches by
#: name, with the names that differ from the function's own
_FUNCTIONAL_OPS = dict.fromkeys((
    "adaptive_avg_pool2d adaptive_max_pool2d affine_grid alpha_dropout "
    "avg_pool1d avg_pool2d conv1d conv2d conv2d_transpose "
    "cosine_similarity cross_entropy ctc_loss dropout elu embedding "
    "embedding_int8 gelu grid_sample group_norm gumbel_softmax hardshrink "
    "hardsigmoid hardswish hardtanh instance_norm kl_div l1_loss "
    "label_smooth layer_norm leaky_relu linear linear_int8 log_loss "
    "log_sigmoid log_softmax lora_delta max_pool1d max_pool2d maxout mish "
    "mse_loss nll_loss normalize npair_loss one_hot pad pixel_shuffle "
    "prelu relu relu6 selu sigmoid sigmoid_focal_loss silu softmax "
    "softplus softshrink softsign square_error_cost swish tanh tanhshrink "
    "temporal_shift unfold").split())
_FUNCTIONAL_OPS.update({
    "batch_norm": _batch_norm_name, "local_response_norm": "lrn",
    "smooth_l1_loss": "smooth_l1", "binary_cross_entropy": "bce_loss",
    "binary_cross_entropy_with_logits": "bce_logits",
    "margin_ranking_loss": "margin_ranking",
    "hinge_embedding_loss": "hinge_embedding",
    "interpolate": _interp_name, "scaled_dot_product_attention": "sdpa",
    "softmax_with_cross_entropy": "softmax_with_cross_entropy"})

#: the same for the port's tensor functions ("cast" is the JAX Tensor's
#: astype)
_TENSOR_OPS = dict.fromkeys((
    "add_n as_complex as_real atan2 atleast_1d bmm broadcast_to cast clip "
    "concat crop cross cumprod cumsum diag diff dist dot einsum expand "
    "expand_as flatten flip fmax fmin gather gather_nd hypot index_sample "
    "index_select inner kron lerp logsumexp masked_fill masked_select "
    "matmul matrix_power maximum median meshgrid minimum moveaxis "
    "multiplex nanmean nansum norm one_hot outer pad put_along_axis "
    "quantile repeat_interleave reshape roll rot90 scale scatter "
    "scatter_nd_add slice sort split squeeze stack stanh std "
    "strided_slice swapaxes t take_along_axis tile topk trace transpose "
    "tril triu unsqueeze unstack var where").split())
_TENSOR_OPS.update({"sum": "reduce_sum", "mean": "reduce_mean",
                    "max": "reduce_max", "min": "reduce_min",
                    "prod": "reduce_prod"})


def register(namespace, table):
    """Wrap the functions of a module's `namespace` named in `table` as
    amp ops (called at the end of nn/functional.py and tensor/ops.py)."""
    for fname, op_name in table.items():
        namespace[fname] = op(fname if op_name is None else op_name,
                              namespace[fname])


def _cast_op_name(func, args, kw):
    """"cast" for a Tensor cast method (`.to` and `.type` only when
    given a dtype), else None."""
    if func in _CAST_METHODS:
        return "cast"
    if func in (torch.Tensor.to, torch.Tensor.type) and (
            "dtype" in kw or any(isinstance(a, torch.dtype) for a in args)):
        return "cast"
    return None


_T = torch.Tensor
#: the torch functions of user code that the JAX package dispatches as
#: Tensor operators, by their JAX names
_TORCH_OPS = {
    **dict.fromkeys((_T.__mul__, _T.__rmul__, _T.mul, _T.multiply,
                     torch.mul, torch.multiply), "mul"),
    **dict.fromkeys((_T.__matmul__, _T.__rmatmul__, _T.matmul,
                     torch.matmul, torch.mm, _T.mm), "matmul"),
    **dict.fromkeys((torch.bmm, _T.bmm), "bmm"),
    torch.einsum: "einsum",
    **dict.fromkeys((_T.__add__, _T.__radd__, _T.add, torch.add), "add"),
    **dict.fromkeys((_T.__sub__, _T.__rsub__, _T.sub, torch.sub), "sub"),
    **dict.fromkeys((_T.__truediv__, _T.__rtruediv__, _T.div, torch.div,
                     torch.true_divide), "div"),
    _T.__floordiv__: "floordiv", _T.__mod__: "mod",
    **dict.fromkeys((_T.__pow__, _T.__rpow__, _T.pow, torch.pow), "pow"),
    **dict.fromkeys((_T.__neg__, _T.neg, torch.neg), "neg"),
    **dict.fromkeys((_T.__abs__, _T.abs, torch.abs), "abs"),
    # the JAX Tensor's reduction methods are its ops library's functions
    **dict.fromkeys((_T.sum, torch.sum), "reduce_sum"),
    **dict.fromkeys((_T.mean, torch.mean), "reduce_mean"),
    **dict.fromkeys((_T.logsumexp, torch.logsumexp), "logsumexp"),
    **dict.fromkeys((_T.norm, torch.norm), "norm"),
}
_CAST_METHODS = {_T.float, _T.half, _T.bfloat16, _T.double}


class _AmpMode(torch.overrides.TorchFunctionMode):
    """The policy at the Tensor operators of user code (module doc)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _policy_applies():
            name = _TORCH_OPS.get(func) or _cast_op_name(func, args, kwargs)
            dt = None if name is None else _target(name)
            if dt is not None:
                args, kwargs = _cast_all(dt, args, kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast / fluid amp_guard parity (the JAX package's
    policy; see the module doc). `enable=False` turns the policy off
    inside an enclosing auto_cast."""
    global _ACTIVE
    st = _state
    if not hasattr(st, "inside"):
        st.inside = 0
        st.depth = 0
    prev = (getattr(st, "dtype", None), getattr(st, "level", "O0"),
            getattr(st, "white", WHITE_LIST), getattr(st, "black",
                                                      BLACK_LIST))
    if enable:
        st.dtype = _amp_dtype(dtype)
        st.level = level
        st.white = WHITE_LIST | set(custom_white_list or ())
        st.black = (BLACK_LIST - set(custom_white_list or ())) | set(
            custom_black_list or ())
    else:
        st.dtype = None
        st.level = "O0"
    mode = None
    if st.depth == 0:
        mode = _AmpMode()
        mode.__enter__()
    st.depth += 1
    with _LOCK:
        _ACTIVE += 1
    try:
        yield
    finally:
        with _LOCK:
            _ACTIVE -= 1
        st.depth -= 1
        if mode is not None:
            mode.__exit__(None, None, None)
        st.dtype, st.level, st.white, st.black = prev


amp_guard = auto_cast


class GradScaler:
    """paddle.amp.GradScaler / fluid AmpScaler (loss_scaler.py:27) parity,
    the JAX package's state machine: dynamic loss scaling for any amp
    dtype (bf16 included), the scale times `decr_ratio` (not below 1)
    after `decr_every_n_nan_or_inf` consecutive steps with an inf or NaN
    gradient, times `incr_ratio` after `incr_every_n_steps` consecutive
    finite ones; a step with an inf or NaN gradient is skipped.
    `unscale_` multiplies each gradient by 1 / scale (not a division, so
    the gradients equal the JAX package's bit for bit) in one foreach
    pass, with one host sync for the finite check."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameters if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        torch._foreach_mul_(grads, 1.0 / self._scale)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        self._found_inf = not bool(finite)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        """The state was updated in step() (as in the JAX package)."""

    def _update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good": self._good, "bad": self._bad}

    def set_state_dict(self, s):
        self._scale = s.get("scale", self._scale)
        self._good = s.get("good", 0)
        self._bad = s.get("bad", 0)


AmpScaler = GradScaler


def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """paddle.amp.decorate parity: O2 casts the models' floating
    parameters and buffers to the amp dtype. `master_weight` and
    `save_dtype` are taken and not applied by the JAX package; the port
    refuses any value but None rather than ignore it."""
    if master_weight is not None or save_dtype is not None:
        raise NotImplementedError(
            "decorate: master_weight= and save_dtype= are not applied by "
            "the reference either; pass None")
    if level == "O2" and models is not None:
        ms = models if isinstance(models, (list, tuple)) else [models]
        for m in ms:
            m.to(dtype=_amp_dtype(dtype))
    if optimizers is None:
        return models
    return models, optimizers
