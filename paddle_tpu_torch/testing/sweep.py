"""The model-building library's sweep: every tensor function, every
`nn.functional` entry and every layer that came with the library, as a
case that runs forward and backward in float64 on any device, so the
card's results can be held to the CPU's (`chip_smoke.py` phase 34 a).

`cases()` returns the cases (inputs made from a numpy seed, small
shapes); `run(case, device)` gives the outputs and the gradients of
<outputs, a fixed random cotangent> with respect to the float inputs
(and a layer's parameters), on the CPU; `compare(a, b)` the largest
relative error of floats (each tensor's max |a - b| over its max |b|)
and whether every integer, boolean and non-tensor output is equal.
`EXCLUDED` names what the sweep leaves out, with the reason; a CPU test
holds `cases()` and `EXCLUDED` together to the library's names.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

Case = collections.namedtuple("Case", ["name", "fn", "args", "wrt",
                                       "creates", "layer"])

#: functions and layers the sweep leaves out, with the reason
EXCLUDED = {
    **{n: "random: only its statistics are checked (CPU tests)"
       for n in ("rand", "randn", "uniform", "normal", "randint",
                 "randperm", "bernoulli", "multinomial", "dropout",
                 "dropout2d", "alpha_dropout", "gumbel_softmax",
                 "Dropout2D", "AlphaDropout")},
    "draw_seed": "a host int drawn from a CPU generator",
    "utils_spectral_norm": "raises, as the JAX package's does",
    "scaled_dot_product_attention": "a hand kernel's wrapper (phases 2, 9)",
    "linear_int8": "a hand kernel's wrapper (phase 13)",
    "embedding_int8": "a hand kernel's wrapper (phase 13)",
    "lora_delta": "a hand kernel's wrapper (phase 13)",
    "ctc_loss": "log-softmaxes in float32 whatever its input, as the JAX "
                "function does (phase 35 b); its recursion is in op_cases",
}

#: functions of the op library's modules that `op_cases` leaves out
OP_EXCLUDED = {
    "sequence_losses.NEG": "a constant",
    "detection_train.ssd_loss": "computes in float32 whatever its input, "
                                "as the JAX function does (phase 35 c)",
}


def _s(shape, seed, lo=0.2, hi=2.0):
    r = np.random.RandomState(seed)
    return r.uniform(lo, hi, shape) * np.where(r.rand(*shape) < 0.5, -1, 1)


def _pos(shape, seed):
    return np.random.RandomState(seed).uniform(0.2, 2.0, shape)


def _probs(n, k, seed):
    return np.random.RandomState(seed).dirichlet(np.ones(k), n)


def cases():
    """The sweep's cases, in a fixed order."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    out = []

    def c(name, fn, args, wrt=(0,)):
        out.append(Case(name, fn, args, wrt, False, None))

    def new(name, fn):
        out.append(Case(name, fn, [], (), True, None))

    def lay(name, make, args, wrt=None):
        wrt = tuple(i for i, a in enumerate(args) if a.dtype.kind == "f") \
            if wrt is None else wrt
        out.append(Case(name, None, args, wrt, False, make))

    x34, x234 = _s((3, 4), 0), _s((2, 3, 4), 1)
    p34 = _pos((3, 4), 2)
    u34 = np.random.RandomState(3).uniform(-0.9, 0.9, (3, 4))
    i34 = np.random.RandomState(4).randint(-5, 6, (3, 4)).astype(np.int64)
    ties = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0],
                     [0.5, 0.5, 0.5, 2.0, 2.0, -1.0]])
    img = _s((2, 4, 5, 6), 5)
    lbl = (np.arange(12).reshape(3, 4) % 2).astype(np.float64)
    fwd_only = ()

    # ---- tensor/: creation
    new("to_tensor", lambda d: T.to_tensor(np.arange(6.0), device=d))
    new("zeros", lambda d: T.zeros([2, 3], "float64", device=d))
    new("ones", lambda d: T.ones([2, 3], "int64", device=d))
    new("full", lambda d: T.full([2, 2], 1.5, "float64", device=d))
    new("arange", lambda d: T.arange(2, 11, 3, device=d))
    new("linspace", lambda d: T.linspace(0, 1, 7, "float64", device=d))
    new("eye", lambda d: T.eye(3, 4, "float64", device=d))
    new("empty", lambda d: T.empty([2], "float64", device=d))
    for nm in ("zeros_like", "ones_like", "empty_like"):
        c(nm, getattr(T, nm), [x34], fwd_only)
    c("clone", T.clone, [x34])
    c("full_like", lambda a: T.full_like(a, 2.5), [x34], fwd_only)
    c("diag", lambda a: T.diag(a, 1, 2.0), [_s((3,), 6)])
    c("assign", lambda a: T.assign(a), [x34])
    # ---- math
    for nm in ("exp", "expm1", "sin", "cos", "tan", "tanh", "sinh", "cosh",
               "atan", "erf", "square", "abs", "neg", "stanh", "sign"):
        c(nm, getattr(T, nm), [x34])
    for nm in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt",
               "reciprocal", "digamma", "lgamma"):
        c(nm, getattr(T, nm), [p34])
    for nm in ("asin", "acos"):
        c(nm, getattr(T, nm), [u34])
    c("logit", T.logit, [np.random.RandomState(7).uniform(0.1, 0.9, (3, 4))])
    for nm in ("floor", "ceil", "round", "trunc", "frac", "isnan", "isinf",
               "isfinite"):
        c(nm, getattr(T, nm), [x34 * 3.3], fwd_only)
    for nm in ("add", "subtract", "multiply", "divide", "maximum",
               "minimum", "fmax", "fmin", "atan2", "hypot"):
        c(nm, getattr(T, nm), [x34, _s((3, 4), 8)], (0, 1))
    c("pow", lambda a: T.pow(a, 2.5), [p34])
    c("floor_divide", T.floor_divide, [i34, np.full((3, 4), 3, np.int64)],
      fwd_only)
    for nm in ("remainder", "mod"):
        c(nm, getattr(T, nm), [x34 * 3, np.full((3, 4), 0.7)])
    c("scale", lambda a: T.scale(a, 2.5, 0.5, False), [x34])
    c("clip", lambda a: T.clip(a, -0.8, 1.1), [x34])
    c("add_n", lambda a, b: T.add_n([a, b]), [x34, _s((3, 4), 9)], (0, 1))
    c("multiply_list", lambda a, b: T.multiply_list([a, b]),
      [x34, _s((3, 4), 10)], (0, 1))
    c("lerp", lambda a, b: T.lerp(a, b, 0.3), [x34, _s((3, 4), 11)], (0, 1))
    # ---- reductions
    for nm in ("sum", "mean", "max", "min", "prod", "logsumexp", "amax",
               "amin", "nansum", "nanmean"):
        c(nm, lambda a, _f=getattr(T, nm): _f(a, axis=[0, 2]), [x234])
    c("std", lambda a: T.std(a, axis=1), [x234])
    c("var", lambda a: T.var(a, axis=[0, 2], unbiased=False), [x234])
    c("median", lambda a: T.median(a, axis=1), [x34])
    c("quantile", lambda a: T.quantile(a, 0.3, axis=1), [x234])
    c("cumsum", lambda a: T.cumsum(a, axis=1), [x234])
    c("cumprod", lambda a: T.cumprod(a, dim=1), [p34])
    c("count_nonzero", lambda a: T.count_nonzero(a, axis=1), [i34],
      fwd_only)
    c("all", lambda a: T.all(a > 0, axis=1), [i34], fwd_only)
    c("any", lambda a: T.any(a > 3, axis=0), [i34], fwd_only)
    # ---- linalg
    c("matmul", lambda a, b: T.matmul(a, b, True, True),
      [_s((4, 3), 12), _s((5, 4), 13)], (0, 1))
    c("mm", T.mm, [x34, _s((4, 2), 14)], (0, 1))
    c("bmm", T.bmm, [x234, _s((2, 4, 2), 15)], (0, 1))
    c("dot", T.dot, [_s((5,), 16), _s((5,), 17)], (0, 1))
    c("t", T.t, [x34])
    c("transpose", lambda a: T.transpose(a, [2, 0, 1]), [x234])
    c("norm", lambda a: T.norm(a, 3, axis=1), [x234])
    c("dist", lambda a, b: T.dist(a, b, 1), [x34, _s((3, 4), 18)], (0, 1))
    c("cross", T.cross, [_s((4, 3), 19), _s((4, 3), 20)], (0, 1))
    c("matrix_power", lambda a: T.matrix_power(a, 3), [_s((3, 3), 21) / 2])
    c("einsum", lambda a, b: T.einsum("bij,jk->bik", a, b),
      [x234, _s((4, 5), 22)], (0, 1))
    c("tril", lambda a: T.tril(a, 1), [x34])
    c("triu", lambda a: T.triu(a, -1), [x34])
    c("kron", T.kron, [_s((2, 2), 23), _s((2, 3), 24)], (0, 1))
    c("outer", T.outer, [_s((3,), 25), _s((4,), 26)], (0, 1))
    c("inner", T.inner, [x34, _s((2, 4), 27)], (0, 1))
    c("trace", lambda a: T.trace(a, 1), [_s((4, 4), 28)])
    # ---- manipulation
    c("reshape", lambda a: T.reshape(a, [4, -1]), [x234])
    c("concat", lambda a, b: T.concat([a, b], 1), [x34, _s((3, 2), 29)],
      (0, 1))
    c("split", lambda a: T.split(a, [1, -1, 1], 2), [x234])
    c("chunk", lambda a: T.chunk(a, 3, 1), [x234])
    c("stack", lambda a, b: T.stack([a, b], 1), [x34, _s((3, 4), 30)],
      (0, 1))
    for nm in ("unstack", "unbind"):
        c(nm, lambda a, _f=getattr(T, nm): _f(a, 1), [x234])
    c("squeeze", lambda a: T.squeeze(a, [1, 2]), [_s((3, 1, 4, 1), 31)])
    c("unsqueeze", lambda a: T.unsqueeze(a, [0, 2]), [x34])
    c("flatten", lambda a: T.flatten(a, 1), [x234])
    c("expand", lambda a: T.expand(a, [2, 3, -1]), [_s((1, 4), 32)])
    c("expand_as", T.expand_as, [_s((1, 4), 33), x34], (0,))
    c("broadcast_to", lambda a: T.broadcast_to(a, [3, 4]), [_s((1, 4), 34)])
    c("tile", lambda a: T.tile(a, [2, 1, 3]), [x34])
    c("slice", lambda a: T.slice(a, [1, 2], [1, -3], [3, 10]), [x234])
    c("strided_slice", lambda a: T.strided_slice(a, [2, 1], [0, 2], [4, 0],
                                                 [2, -1]), [x234])
    c("gather", lambda a, i: T.gather(a, i, 1), [x234, np.array([2, 0, 2])],
      (0,))
    c("gather_nd", T.gather_nd, [x234, np.array([[0, 1], [1, 2]])], (0,))
    c("scatter", lambda a, i, u: T.scatter(a, i, u, False),
      [x34, np.array([2, 0]), _s((2, 4), 35)], (0, 2))
    c("scatter_nd_add", T.scatter_nd_add,
      [x34, np.array([[1], [1], [2]]), _s((3, 4), 36)], (0, 2))
    c("index_select", lambda a, i: T.index_select(a, i, 1),
      [x34, np.array([3, 1, 3])], (0,))
    c("index_sample", T.index_sample,
      [x34, np.array([[0, 3], [2, 2], [1, 0]])], (0,))
    c("masked_select", lambda a: T.masked_select(a, a > 0), [x34])
    c("masked_fill", lambda a: T.masked_fill(a, a > 0, -2.5), [x34])
    c("where", lambda a, b: T.where(a > 0, a, b), [x34, _s((3, 4), 37)],
      (0, 1))
    c("nonzero", lambda a: T.nonzero(a > 0), [i34], fwd_only)
    c("pad", lambda a: T.pad(a, [1, 2, 2, 1], "reflect"), [x34])
    c("roll", lambda a: T.roll(a, 2, 2), [x234])
    c("flip", lambda a: T.flip(a, [0, 2]), [x234])
    c("rot90", lambda a: T.rot90(a, 3), [x34])
    c("cast", lambda a: T.cast(a, "int32"), [x34 * 3], fwd_only)
    c("crop", lambda a: T.crop(a, [1, 2, 3], [1, 1, 0]), [x234])
    c("repeat_interleave", lambda a: T.repeat_interleave(a, 2, 1), [x34])
    c("moveaxis", lambda a: T.moveaxis(a, 0, 2), [x234])
    c("swapaxes", lambda a: T.swapaxes(a, 0, 2), [x234])
    c("as_real", lambda a: T.as_real(T.as_complex(a)), [_s((3, 2), 38)])
    c("as_complex", lambda a: T.as_real(T.as_complex(a)) * 2.0,
      [_s((3, 2), 39)])
    c("meshgrid", T.meshgrid, [_s((3,), 40), _s((2,), 41)], (0, 1))
    c("atleast_1d", T.atleast_1d, [np.array(2.5)])
    c("diff", lambda a: T.diff(a, 2, 2), [x234])
    c("take_along_axis", lambda a, i: T.take_along_axis(a, i, 1),
      [x34, np.array([[0, 3], [2, 2], [1, 0]])], (0,))
    c("put_along_axis", lambda a, i, v: T.put_along_axis(a, i, v, 1),
      [x34, np.array([[0, 3], [2, 1], [1, 0]]), _s((3, 2), 42)], (0, 2))
    # ---- search / sort
    c("argmax", lambda a: T.argmax(a, 1), [ties], fwd_only)
    c("argmin", lambda a: T.argmin(a, 1, True), [ties], fwd_only)
    c("topk", lambda a: T.topk(a, 4), [ties])
    c("argsort", lambda a: T.argsort(a, descending=True), [ties], fwd_only)
    c("sort", lambda a: T.sort(a, 1), [ties])
    c("unique", lambda a: T.unique(a, True, True, True),
      [np.array([3.0, 1.0, 3.0, 2.0, 1.0, 5.0])], fwd_only)
    c("searchsorted", lambda a, b: T.searchsorted(a, b, right=True),
      [np.array([1.0, 2.0, 2.0, 5.0]), np.array([2.0, 0.0, 6.0, 3.0])],
      fwd_only)
    c("histogram", lambda a: T.histogram(a, 5), [x34], fwd_only)
    c("bincount", lambda a: T.bincount(a, minlength=7),
      [np.array([0, 2, 2, 5, 1])], fwd_only)
    c("mode", lambda a: T.mode(a, 1),
      [np.array([[2.0, 1.0, 2.0, 1.0, 3.0], [4.0, 4.0, 0.0, 0.0, 0.0]])],
      fwd_only)
    c("kthvalue", lambda a: T.kthvalue(a, 2, 1), [ties])
    # ---- logic and misc
    for nm in ("equal", "not_equal", "less_than", "less_equal",
               "greater_than", "greater_equal", "bitwise_and", "bitwise_or",
               "bitwise_xor"):
        c(nm, getattr(T, nm), [i34, np.full((3, 4), 1, np.int64)], fwd_only)
    for nm in ("logical_and", "logical_or", "logical_xor"):
        c(nm, lambda a, b, _f=getattr(T, nm): _f(a > 0, b > -2),
          [i34, i34.T.copy().reshape(3, 4)], fwd_only)
    c("logical_not", lambda a: T.logical_not(a > 0), [i34], fwd_only)
    c("bitwise_not", T.bitwise_not, [i34], fwd_only)
    c("equal_all", T.equal_all, [i34, i34.copy()], fwd_only)
    c("allclose", lambda a: T.allclose(a, a + 1e-9), [x34], fwd_only)
    c("isclose", lambda a: T.isclose(a, a + 1e-3 * (a > 0)), [x34],
      fwd_only)
    for nm in ("numel", "shape", "rank", "is_empty", "is_tensor"):
        c(nm, getattr(T, nm), [x234], fwd_only)
    c("increment", lambda a: T.increment(a.clone(), 2.0), [x34], fwd_only)
    c("one_hot", lambda a: T.one_hot(a, 4), [np.array([[1, 0], [3, 2]])],
      fwd_only)
    c("multiplex", lambda a, b, i: T.multiplex([a, b], i),
      [x34, _s((3, 4), 43), np.array([[1], [0], [1]])], (0, 1))

    # ---- nn.functional
    for nm in ("relu", "relu6", "sigmoid", "tanh", "silu", "swish", "selu",
               "hardswish", "hardsigmoid", "softsign", "mish",
               "log_sigmoid", "tanhshrink", "hardshrink", "softshrink",
               "softplus"):
        c(f"F.{nm}", getattr(F, nm), [x34 * 2])
    c("F.relu_", lambda a: F.relu_(a * 1.0), [x34])
    c("F.flatten", lambda a: F.flatten(a, 1), [x234])
    c("F.gelu", lambda a: F.gelu(a, True), [x34])
    c("F.leaky_relu", lambda a: F.leaky_relu(a, 0.05), [x34])
    c("F.elu", lambda a: F.elu(a, 0.7), [x34])
    c("F.hardtanh", lambda a: F.hardtanh(a, -0.7, 0.9), [x34])
    c("F.prelu", F.prelu, [x234, np.array([0.1, 0.2, 0.3])], (0, 1))
    c("F.maxout", lambda a: F.maxout(a, 2), [_s((2, 4, 3), 44)])
    c("F.softmax", lambda a: F.softmax(a, 1), [x234])
    c("F.log_softmax", F.log_softmax, [x234])
    c("F.linear", F.linear, [x234, _s((4, 5), 45), _s((5,), 46)], (0, 1, 2))
    c("F.embedding", lambda i, w: F.embedding(i, w, 1),
      [np.array([[0, 2, 1], [3, 1, 1]]), _s((4, 3), 47)], (1,))
    c("F.one_hot", lambda a: F.one_hot(a, 5), [np.array([0, 4, 2])],
      fwd_only)
    c("F.conv1d", lambda x, w, b: F.conv1d(x, w, b, 2, 1),
      [_s((2, 3, 9), 48), _s((4, 3, 3), 49), _s((4,), 50)], (0, 1, 2))
    c("F.layer_norm", lambda x, w, b: F.layer_norm(x, [3, 4], w, b),
      [x234, _s((3, 4), 51), _s((3, 4), 52)], (0, 1, 2))
    c("F.group_norm", lambda x, w, b: F.group_norm(x, 2, w, b),
      [img, _s((4,), 53), _s((4,), 54)], (0, 1, 2))
    c("F.instance_norm", lambda x, w, b: F.instance_norm(x, weight=w,
                                                         bias=b),
      [img, _s((4,), 55), _s((4,), 56)], (0, 1, 2))
    c("F.normalize", F.normalize, [x234])
    c("F.local_response_norm", lambda a: F.local_response_norm(a, 3),
      [_s((2, 5, 3, 3), 57)])
    for nm in ("l1_loss", "mse_loss", "smooth_l1_loss", "square_error_cost"):
        c(f"F.{nm}", getattr(F, nm), [x34, _s((3, 4), 58) * 2], (0, 1))
    c("F.nll_loss", F.nll_loss,
      [np.log(_probs(5, 4, 59)), np.array([1, 0, 3, 2, 1])], (0,))
    c("F.binary_cross_entropy", F.binary_cross_entropy,
      [np.random.RandomState(60).uniform(0.2, 0.8, (3, 4)), lbl], (0,))
    c("F.binary_cross_entropy_with_logits",
      lambda a, b, w: F.binary_cross_entropy_with_logits(a, b, None, "sum",
                                                         w),
      [x34, lbl, _pos((4,), 61)], (0, 2))
    c("F.kl_div", lambda a, b: F.kl_div(a, b, "batchmean"),
      [np.log(_probs(3, 4, 62)), _probs(3, 4, 63)], (0, 1))
    c("F.margin_ranking_loss", F.margin_ranking_loss,
      [x34, _s((3, 4), 64), np.sign(_s((3, 4), 65))], (0, 1))
    c("F.hinge_embedding_loss", F.hinge_embedding_loss,
      [x34, np.sign(_s((3, 4), 66))], (0,))
    c("F.cosine_similarity", F.cosine_similarity, [x234, _s((2, 3, 4), 67)],
      (0, 1))
    c("F.log_loss", F.log_loss,
      [np.random.RandomState(68).uniform(0.1, 0.9, (3, 4)), lbl], (0,))
    c("F.sigmoid_focal_loss", F.sigmoid_focal_loss, [x34, lbl], (0,))
    c("F.label_smooth", lambda a, p: F.label_smooth(a, p, 0.2),
      [np.eye(4)[[0, 2, 1]], np.array([0.1, 0.2, 0.3, 0.4])], (0, 1))
    c("F.npair_loss", F.npair_loss,
      [_s((4, 5), 69), _s((4, 5), 70), np.array([0, 1, 0, 2])], (0, 1))
    c("F.cross_entropy", F.cross_entropy, [x34, np.array([1, 0, 3])], (0,))
    c("F.softmax_with_cross_entropy", F.softmax_with_cross_entropy,
      [x34, np.array([[1], [0], [3]])], (0,))
    c("F.interpolate", lambda a: F.interpolate(a, [7, 9], mode="bicubic",
                                               align_corners=True), [img])
    c("F.upsample", lambda a: F.upsample(a, [8, 3], mode="bilinear"),
      [img])
    c("F.interpolate_trilinear", lambda a: F.interpolate(
        a, [5, 3, 7], mode="trilinear"), [_s((1, 2, 3, 4, 5), 71)])
    c("F.interpolate_nearest", lambda a: F.interpolate(a, scale_factor=2),
      [img])
    c("F.pixel_shuffle", lambda a: F.pixel_shuffle(a, 2),
      [_s((2, 8, 3, 3), 72)])
    c("F.unfold", lambda a: F.unfold(a, [2, 3], [1, 2], 1),
      [_s((2, 3, 5, 6), 73)])
    c("F.grid_sample", lambda a, g: F.grid_sample(a, g, align_corners=False),
      [img, np.random.RandomState(74).uniform(-1.1, 1.1, (2, 3, 4, 2))],
      (0, 1))
    c("F.affine_grid", lambda t: F.affine_grid(t, [2, 1, 3, 4]),
      [_s((2, 2, 3), 75)])
    c("F.pad", lambda a: F.pad(a, [1, 2, 2, 1], "circular"), [img])
    c("F.temporal_shift", lambda a: F.temporal_shift(a, 2),
      [_s((4, 8, 2, 2), 76)])

    # ---- the layers that came with the library
    g = torch.Generator

    def mk(cls, *a, **kw):
        return lambda: cls(*a, **kw)

    def mkp(cls, *a, **kw):
        return lambda: cls(*a, device="cpu", generator=g().manual_seed(0),
                           **kw)

    x23 = _s((2, 3, 8), 77)
    for nm in ("Sigmoid", "Softsign", "Mish", "Hardswish", "Hardsigmoid",
               "Silu", "Swish", "LogSigmoid", "Tanhshrink", "GELU",
               "LeakyReLU", "ELU", "SELU", "Softmax", "LogSoftmax",
               "Softplus", "Hardtanh", "Hardshrink", "Softshrink"):
        lay(nm, mk(getattr(nn, nm)), [x23])
    lay("Maxout", mk(nn.Maxout, 2), [img])
    lay("PReLU", mkp(nn.PReLU, 4, 0.2), [img])
    lay("Upsample", mk(nn.Upsample, [7, 9], None, "bilinear"), [img])
    lay("UpsamplingBilinear2D", mk(nn.UpsamplingBilinear2D, [8, 4]), [img])
    lay("UpsamplingNearest2D", mk(nn.UpsamplingNearest2D, None, 2), [img])
    lay("PixelShuffle", mk(nn.PixelShuffle, 2), [img])
    lay("Pad2D", mk(nn.Pad2D, [1, 2, 0, 1], "replicate"), [img])
    lay("Unfold", mk(nn.Unfold, [2, 3]), [img])
    lay("CosineSimilarity", mk(nn.CosineSimilarity, 2),
        [x23, _s((2, 3, 8), 78)])
    lay("Bilinear", mkp(nn.Bilinear, 5, 6, 3), [_s((4, 5), 79),
                                                _s((4, 6), 80)])
    lay("Conv1D", mkp(nn.Conv1D, 3, 5, 3, padding=1), [_s((2, 3, 9), 81)])
    lay("GroupNorm", mkp(nn.GroupNorm, 2, 4), [img])
    lay("InstanceNorm2D", mkp(nn.InstanceNorm2D, 4), [img])
    # one process: the batch norm of its batch (the ranks' sums: phase 38)
    lay("SyncBatchNorm", lambda: nn.SyncBatchNorm(4, device="cpu"), [img])
    lay("LocalResponseNorm", mk(nn.LocalResponseNorm, 3), [img])
    lay("SpectralNorm", lambda: nn.SpectralNorm([6, 4, 3], 1, 2,
                                                device="cpu"),
        [_s((6, 4, 3), 82)])
    lay("RMSNorm", mkp(nn.RMSNorm, 8), [x23])
    lay("L1Loss", mk(nn.L1Loss), [x23, _s((2, 3, 8), 83)])
    lay("SmoothL1Loss", mk(nn.SmoothL1Loss, "sum", 0.5),
        [x23, _s((2, 3, 8), 84)])
    lay("NLLLoss", mk(nn.NLLLoss), [np.log(_probs(5, 4, 85)),
                                    np.array([1, 0, 3, 2, 1])])
    lay("BCELoss", mk(nn.BCELoss),
        [np.random.RandomState(86).uniform(0.1, 0.9, (3, 4)), lbl], (0,))
    lay("BCEWithLogitsLoss", mk(nn.BCEWithLogitsLoss), [x34, lbl], (0,))
    lay("KLDivLoss", mk(nn.KLDivLoss, "sum"),
        [np.log(_probs(3, 4, 87)), _probs(3, 4, 88)], (0,))
    lay("MarginRankingLoss", mk(nn.MarginRankingLoss, 0.2),
        [x34, _s((3, 4), 89), np.sign(_s((3, 4), 90))], (0, 1))
    lay("LayerList", lambda: nn.LayerList([nn.RMSNorm(
        8, device="cpu")]).__getitem__(0), [x23])
    lay("LayerDict", lambda: nn.LayerDict({"a": nn.Conv1D(
        3, 4, 1, device="cpu", generator=g().manual_seed(1))})["a"],
        [_s((2, 3, 5), 91)])
    lay("ParameterList", lambda: _Scale(nn.ParameterList(
        [torch.nn.Parameter(torch.full((8,), 1.5))])), [x23])
    lay("SimpleRNNCell", mkp(nn.SimpleRNNCell, 5, 6, "relu"),
        [_s((3, 5), 92), _s((3, 6), 93)])
    lay("LSTMCell", lambda: _LSTMStep(nn.LSTMCell(
        5, 6, device="cpu", generator=g().manual_seed(0))),
        [_s((3, 5), 94), _s((3, 6), 95), _s((3, 6), 96)])
    lay("GRUCell", mkp(nn.GRUCell, 5, 6), [_s((3, 5), 97), _s((3, 6), 98)])
    lay("RNN", lambda: nn.RNN(nn.GRUCell(4, 5, device="cpu",
                                         generator=g().manual_seed(0)),
                              is_reverse=True), [_s((3, 6, 4), 99)])
    for nm in ("SimpleRNN", "LSTM", "GRU"):
        lay(nm, mkp(getattr(nn, nm), 4, 5, 2, "bidirect"),
            [_s((3, 6, 4), 100)])
    lay("MoELayer", mkp(nn.MoELayer, 8, 16, 4, 1.0), [_s((2, 6, 8), 101)])
    return out


class _Scale(torch.nn.Module):
    """x times a ParameterList's first parameter."""

    def __init__(self, plist):
        super().__init__()
        self.plist = plist

    def forward(self, x):
        return x * self.plist[0]


class _LSTMStep(torch.nn.Module):
    """An LSTMCell fed (x, h, c) as three tensors."""

    def __init__(self, cell):
        super().__init__()
        self.cell = cell

    def forward(self, x, h, c):
        return self.cell(x, (h, c))


def _boxes(n, seed, size=20.0):
    r = np.random.RandomState(seed)
    xy = r.rand(n, 2) * size
    return np.concatenate([xy, xy + r.rand(n, 2) * size * 0.4 + 1.0], 1)


def op_cases():
    """The op library's sweep (`ops/sequence.py`, `sequence_losses.py`,
    `detection.py`, `detection_train.py`, `text/viterbi.py`,
    `vision/ops.py`; chip_smoke phase 35 f), in a fixed order; a case's
    name is "module.function" with its variant in brackets. Gradients
    where the JAX function is differentiable."""
    from ..ops import detection as D
    from ..ops import detection_train as DT
    from ..ops import sequence as S
    from ..ops import sequence_losses as SL
    from ..text.viterbi import viterbi_decode
    from ..vision import ops as VO

    out = []

    def c(name, fn, args, wrt=(0,)):
        out.append(Case(name, fn, args, wrt, False, None))

    def new(name, fn):
        out.append(Case(name, fn, [], (), True, None))

    def tup(d):
        return tuple(d[k] for k in sorted(d))

    lens = np.array([3, 1, 4, 0])
    x = _s((4, 5, 3), 200)
    c("sequence.seq_mask", lambda n: S.seq_mask(n, 5), [lens], ())
    for pt in ("sum", "average", "sqrt", "max", "min", "last", "first"):
        c(f"sequence.sequence_pool[{pt}]",
          lambda a, n, _p=pt: S.sequence_pool(a, n, _p, -1.0), [x, lens])
    c("sequence.sequence_softmax", S.sequence_softmax, [x, lens])
    c("sequence.sequence_expand_as", S.sequence_expand_as,
      [_s((4, 3), 201), x, lens], (0,))
    c("sequence.sequence_conv",
      lambda a, n, w, b: S.sequence_conv(a, n, w, 3, None, b),
      [x, lens, _s((9, 2), 202), _s((2,), 203)], (0, 2, 3))
    c("sequence.sequence_reverse", S.sequence_reverse, [x, lens])
    c("sequence.sequence_slice", S.sequence_slice,
      [x, lens, np.array([1, 0, 2, 0]), np.array([5, 1, 1, 2])])
    c("sequence.sequence_concat",
      lambda a, b, n, m: S.sequence_concat([a, b], [n, m]),
      [x, _s((4, 2, 3), 204), lens, np.array([2, 0, 1, 2])], (0, 1))
    c("sequence.sequence_reshape", lambda a, n: S.sequence_reshape(a, n, 1),
      [x, lens])
    c("sequence.sequence_enumerate",
      lambda a, n: S.sequence_enumerate(a, n, 3, -1),
      [np.random.RandomState(205).randint(1, 9, (4, 5)), lens], ())
    c("sequence.sequence_pad", lambda a, n: S.sequence_pad(a, n, -1.0, 7),
      [x, lens])
    c("sequence.sequence_unpad", S.sequence_unpad, [x, lens])
    c("sequence.sequence_scatter", S.sequence_scatter,
      [_s((4, 5), 206), np.array([[0, 2, 2], [1, 1, 0], [4, 3, 0],
                                  [0, 0, 0]]), _s((4, 3), 207),
       np.array([3, 2, 1, 0])], (0, 2))
    c("sequence.dynamic_lstm",
      lambda a, n, w, b: S.dynamic_lstm(a, n, w, b, is_reverse=True),
      [_s((4, 5, 8), 208) * 0.3, lens, _s((2, 8), 209) * 0.3,
       _s((1, 14), 210) * 0.1], (0, 2, 3))
    c("sequence.dynamic_gru",
      lambda a, n, w, b: S.dynamic_gru(a, n, w, b, origin_mode=True),
      [_s((4, 5, 6), 211) * 0.3, lens, _s((2, 6), 212) * 0.3,
       _s((1, 6), 213) * 0.1], (0, 2, 3))

    r = np.random.RandomState(214)
    logits = r.randn(6, 3, 5)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    c("sequence_losses.ctc_loss", SL.ctc_loss,
      [logp, np.array([[1, 2], [3, 3], [4, 0]]), np.array([6, 5, 4]),
       np.array([2, 2, 1])])
    em, tr = r.randn(3, 4, 3), r.randn(5, 3) * 0.5
    crf_lens = np.array([4, 2, 1])
    c("sequence_losses.crf_log_likelihood", SL.crf_log_likelihood,
      [em, tr, r.randint(0, 3, (3, 4)), crf_lens], (0, 1))
    c("sequence_losses.crf_decode", SL.crf_decode, [em, tr, crf_lens], ())
    c("viterbi.viterbi_decode", viterbi_decode, [em, r.randn(3, 3)], ())

    b8, b5 = _boxes(8, 215), _boxes(5, 216)
    sc8 = np.random.RandomState(217).rand(8)
    c("detection.box_area", D.box_area, [b8])
    c("detection.iou_matrix", D.iou_matrix, [b8, b5], (0, 1))
    c("detection.nms", lambda b, s: D.nms(b, s, 0.3, 0.1, 6), [b8, sc8], ())
    c("detection.multiclass_nms",
      lambda b, s: D.multiclass_nms(b, s, 0.1, 4, 6, 0.3),
      [np.stack([b8, _boxes(8, 218)]),
       np.random.RandomState(219).rand(2, 3, 8)], ())
    c("detection.box_clip", D.box_clip, [b8 - 5.0, np.array([12.0, 15.0])])
    c("detection.box_coder[encode]",
      lambda p, t: D.box_coder(p, [0.1, 0.1, 0.2, 0.2], t), [b8, b5],
      (0, 1))
    c("detection.box_coder[decode]",
      lambda p, v, t: D.box_coder(p, v, t, "decode_center_size"),
      [b8, np.random.RandomState(220).uniform(0.1, 0.3, (8, 4)),
       _s((2, 8, 4), 221) * 0.3], (0, 2))
    new("detection.prior_box", lambda d: D.prior_box(
        (3, 4), (48, 64), [8.0], [16.0], (2.0,), flip=True, clip=True,
        device=d))
    new("detection.anchor_generator", lambda d: D.anchor_generator(
        (3, 4), [16.0, 32.0], [0.5, 1.0], [16.0, 16.0], device=d))
    new("detection.density_prior_box", lambda d: D.density_prior_box(
        (2, 3), (32, 48), [8.0], [1.0, 2.0], [2], device=d))
    c("detection.yolo_box",
      lambda a, s: D.yolo_box(a, s, [10, 14, 23, 27], 3, 0.2),
      [_s((2, 16, 3, 4), 222), np.array([[96, 128], [64, 64]])], (0,))
    feat = _s((2, 3, 9, 10), 223)
    rois = np.array([[0.0, 0.0, 4.0, 4.0], [2.5, 1.0, 8.5, 7.0],
                     [-2.0, 3.0, 12.0, 14.0]])
    bid = np.array([0, 1, 1])
    c("detection.roi_align",
      lambda a, q, i: D.roi_align(a, q, i, (2, 3), 0.8, -1, True),
      [feat, rois, bid])
    c("detection.roi_pool", lambda a, q, i: D.roi_pool(a, q, i, 3),
      [np.random.RandomState(224).permutation(540).reshape(2, 3, 9, 10)
       / 50.0, rois, bid])
    c("detection.bipartite_match", D.bipartite_match,
      [np.random.RandomState(225).rand(3, 5)], ())

    anc = _boxes(16, 226, 40.0)
    gt = np.array([[5.0, 5.0, 25.0, 25.0], [20.0, 20.0, 40.0, 40.0],
                   [0.0, 0.0, 0.0, 0.0]])
    info = np.array([48.0, 48.0, 1.0])
    c("detection_train.decode_proposals", DT.decode_proposals,
      [anc, _s((16, 4), 227) * 0.3], (0, 1))
    c("detection_train.generate_proposals",
      lambda s, d, i, a: DT.generate_proposals(s, d, i, a, None, 12, 6,
                                               0.6, 2.0),
      [np.random.RandomState(228).rand(2, 16), _s((2, 16, 4), 229) * 0.1,
       np.stack([info, info]), anc], ())
    c("detection_train.rpn_target_assign",
      lambda a, g, z, i: tup(DT.rpn_target_assign(
          a, g, z, i, gt_count=2, rpn_batch_size_per_im=8,
          rpn_positive_overlap=0.4)),
      [anc, gt, np.zeros(3, np.int64), info], (0, 1))
    c("detection_train.retinanet_target_assign",
      lambda a, g, lab, z, i: tup(DT.retinanet_target_assign(
          a, g, lab, z, i, gt_count=2)),
      [anc, gt, np.array([3, 7, 0]), np.zeros(3, np.int64), info], (0, 1))
    c("detection_train.generate_proposal_labels",
      lambda q, g, k, z: tup(DT.generate_proposal_labels(
          q, 14, k, z, g, 1.5, batch_size_per_im=8, fg_fraction=0.5,
          class_nums=4)),
      [anc, gt, np.array([1, 3, 0]), np.zeros(3, np.int64)], (0, 1))
    c("detection_train.generate_mask_labels",
      lambda m, q, lab, gi: DT.generate_mask_labels(m, q, lab, gi, 5),
      [(np.random.RandomState(230).rand(2, 20, 24) > 0.5).astype(np.int64),
       _boxes(4, 231, 14.0), np.array([1, 0, 2, 1]), np.array([0, 1, 1, 0])],
      ())
    c("detection_train.distribute_fpn_proposals",
      lambda q: [t for lvl in DT.distribute_fpn_proposals(q, 4, 2, 5)[0]
                 for t in lvl] + [DT.distribute_fpn_proposals(q, 4)[1]],
      [np.array([[0, 0, 56, 56], [0, 0, 448, 448], [0, 0, 112, 112],
                 [0, 0, 9, 9], [0, 0, 224, 224]], np.float64)])
    c("detection_train.collect_fpn_proposals",
      lambda a, b, s, t: DT.collect_fpn_proposals([a, b], [s, t], [2, 1],
                                                  3),
      [b8[:3], b5[:2], sc8[:3], sc8[3:5]], (0, 1, 2, 3))
    c("detection_train.target_assign",
      lambda a, m: DT.target_assign(a, m, 7.0),
      [_s((2, 3, 4), 232), np.array([[2, -1, 0, 1], [1, 1, -1, 2]])])
    c("detection_train.mine_hard_examples",
      lambda cl, m, d: DT.mine_hard_examples(cl, m, d, neg_pos_ratio=2.0),
      [np.random.RandomState(233).rand(2, 8),
       np.array([[0, -1, -1, -1, 1, -1, -1, -1],
                 [-1, -1, -1, -1, -1, -1, -1, 0]]),
       np.random.RandomState(234).rand(2, 8)], ())
    c("detection_train.matrix_nms",
      lambda b, s: DT.matrix_nms(b, s, 0.1, 0.0, 5, 8, True, 0.5),
      [b8, np.random.RandomState(235).rand(3, 8)], ())

    c("vision.ops.nms",
      lambda b, s, k: VO.nms(b, 0.3, s, None, k, top_k=6),
      [b8, sc8, np.array([0, 1, 1, 0, 2, 2, 1, 0])], ())
    c("vision.ops.multiclass_nms",
      lambda b, s: VO.multiclass_nms(b, s, 0.1, 4, 6, 0.3),
      [b8, np.random.RandomState(236).rand(3, 8)], ())
    c("vision.ops.roi_align",
      lambda a, q, n: VO.roi_align(a, q, n, 2), [feat, rois,
                                                 np.array([1, 2])])
    c("vision.ops.roi_pool", lambda a, q, n: VO.roi_pool(a, q, n, 2),
      [np.random.RandomState(237).permutation(540).reshape(2, 3, 9, 10)
       / 50.0, rois, np.array([2, 1])])
    c("vision.ops.yolo_box",
      lambda a, s: VO.yolo_box(a, s, [10, 14, 23, 27], 3),
      [_s((1, 16, 2, 2), 238), np.array([[64, 64]])])
    c("vision.ops.prior_box",
      lambda f, i: VO.prior_box(f, i, [12.0], [20.0], [2.0],
                                steps=[16.0, 12.0]),
      [np.zeros((1, 2, 3, 4)), np.zeros((1, 3, 48, 64))], ())
    c("vision.ops.box_coder",
      lambda p, t: VO.box_coder(p, [0.1, 0.1, 0.2, 0.2], t), [b8, b5],
      (0, 1))
    c("vision.ops.iou_similarity", VO.iou_similarity, [b8, b5], (0, 1))
    c("vision.ops.bipartite_match", VO.bipartite_match,
      [np.random.RandomState(239).rand(3, 5)], ())
    c("vision.ops.box_clip", VO.box_clip, [b8 - 5.0, np.array([12.0, 15.0])])
    return out


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def run(case, device):
    """(outputs, gradients) of `case` on `device`, as CPU tensors (or
    Python values); float64 throughout."""
    dev = torch.device(device)
    if case.creates:
        outs = _flat(case.fn(dev))
        return [o.cpu() if isinstance(o, torch.Tensor) else o
                for o in outs], []
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
          case.args]
    ts = [t.requires_grad_(True) if i in case.wrt else t
          for i, t in enumerate(ts)]
    leaves = [t for i, t in enumerate(ts) if i in case.wrt]
    if case.layer is not None:
        mod = case.layer().double().to(dev)
        outs = _flat(mod(*ts))
        leaves += [p for p in mod.parameters() if p.requires_grad]
    else:
        outs = _flat(case.fn(*ts))
    total = None
    for j, o in enumerate(outs):
        if isinstance(o, torch.Tensor) and o.is_floating_point() and \
                o.requires_grad:
            cot = torch.from_numpy(np.random.RandomState(7 + j).uniform(
                0.5, 1.5, tuple(o.shape))).to(dev)
            term = (o * cot).sum()
            total = term if total is None else total + term
    grads = []
    if total is not None and leaves:
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if gr is None else gr
                 for t, gr in zip(leaves, grads)]
    return ([o.detach().cpu() if isinstance(o, torch.Tensor) else o
             for o in outs], [gr.detach().cpu() for gr in grads])


def _rel(a, b):
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if a.numel() == 0:
        return 0.0
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale > 0 else err


def compare(got, want):
    """(largest relative error over float tensors, every other output
    equal) of run()'s results `got` against `want`."""
    worst, equal = 0.0, True
    (go, gg), (wo, wg) = got, want
    if len(go) != len(wo) or len(gg) != len(wg):
        return float("inf"), False
    for a, b in list(zip(go, wo)) + list(zip(gg, wg)):
        if isinstance(b, torch.Tensor):
            if not isinstance(a, torch.Tensor) or a.shape != b.shape or \
                    a.dtype != b.dtype:
                return float("inf"), False
            if b.is_floating_point() or b.is_complex():
                worst = max(worst, _rel(a, b))
            else:
                equal = equal and torch.equal(a, b)
        else:
            equal = equal and a == b
    return worst, equal
