"""Paddle's tensor functions (`paddle.concat`, `paddle.topk`, ...), the
JAX package's `tensor/ops.py`, on torch tensors.

Arguments keep Paddle's names and meanings (`axis`, `keepdim`,
`num_or_sections`), and results Paddle's types: integer results are
int64 (the JAX package runs with x64), `topk` returns (values, indices),
`unique` a tensor or a tuple, `numel` / `rank` / `shape` tensors.
Where Paddle's meaning and torch's differ under one name, the JAX
function's holds:

  * `median` averages the two middle values of an even count
    (`torch.median` returns the lower one);
  * `split(x, num_or_sections)` takes a number of equal parts or the
    parts' sizes (`torch.split` takes a chunk size);
  * `gather` is an index_select along `axis`;
  * `std` / `var` are unbiased by default;
  * `topk`, `argsort`, `sort` and `unique` put equal values lower index
    first, as the JAX functions do;
  * `scatter(overwrite=False)` ADDS `updates` onto x's rows, as the JAX
    function computes it (Paddle's own zeroes those rows first).

These are plain functions on tensors. The JAX package also attaches
them to its Tensor class as methods; the port does not patch
`torch.Tensor`, so ``paddle.topk(x, 2)`` works and ``x.topk(2)`` is
torch's own method.

Creation functions take `device=None`, meaning the CUDA card
(`core.device.resolve_device`). The random functions (`rand`, `randn`,
`uniform`, `normal`, `randint`, `randperm`, `bernoulli`, `multinomial`)
draw on the CPU from `generator`, a CPU `torch.Generator` (None: torch's
default CPU generator), and move the result to the device, so one seed
gives the same numbers on every device.
"""
from __future__ import annotations

import builtins as _b

import numpy as np
import torch

from .. import amp as _amp
from ..core.device import resolve_device
from ..core.dtypes import convert_dtype, get_default_dtype
from ..ops import kernels as K


def to_tensor(data, dtype=None, place=None, stop_gradient=True, *,
              device=None):
    """A tensor of `data` on `device` (None: the card). A Python float
    (or list of them) becomes float32 unless `dtype` says otherwise; a
    numpy array keeps its dtype. `stop_gradient=False` makes a leaf that
    requires grad."""
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        arr = np.asarray(data)
        if dt is None and arr.dtype == np.float64 and not isinstance(
                data, (np.ndarray, np.generic)):
            dt = get_default_dtype()
        t = torch.as_tensor(arr)
    t = t.to(device=resolve_device(device), dtype=dt or t.dtype)
    if not stop_gradient:
        t = t.clone().requires_grad_(True)
    return t


def _t(x, like=None):
    """x as a tensor: a tensor as it is, anything else on `like`'s device
    (the card when there is no tensor to follow)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return to_tensor(x, device=dev)


def _dt(dtype, default=None):
    return convert_dtype(dtype) or default or get_default_dtype()


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


# ----------------------------- creation -----------------------------

def zeros(shape, dtype=None, *, device=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device(device))


def ones(shape, dtype=None, *, device=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=resolve_device(device))


def full(shape, fill_value, dtype=None, *, device=None):
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=resolve_device(device))


def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=convert_dtype(dtype))


def arange(start=0, end=None, step=1, dtype=None, *, device=None):
    """int64 when start, end and step are all ints, else float32."""
    if end is None:
        start, end = 0, start
    dt = convert_dtype(dtype)
    if dt is None:
        ints = _b.all(isinstance(v, (int, np.integer))
                      for v in (start, end, step))
        dt = torch.int64 if ints else get_default_dtype()
    return torch.arange(start, end, step, dtype=dt,
                        device=resolve_device(device))


def linspace(start, stop, num, dtype=None, *, device=None):
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=resolve_device(device))


def eye(num_rows, num_columns=None, dtype=None, *, device=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=_dt(dtype),
                     device=resolve_device(device))


def empty(shape, dtype=None, *, device=None):
    """Zeros (the JAX package's `empty`)."""
    return zeros(shape, dtype, device=device)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def diag(x, offset=0, padding_value=0.0):
    return K.diag(x, offset, padding_value)


def clone(x):
    return x.clone()


def assign(x, output=None):
    """A copy of x, or x copied into `output` in place."""
    src = _t(x, output)
    if output is not None:
        with torch.no_grad():
            output.copy_(src)
        return output
    return src.clone()


# ----------------------------- random -----------------------------

def _drawn(t, device):
    return t.to(resolve_device(device))


def rand(shape, dtype=None, *, device=None, generator=None):
    return _drawn(torch.rand(_shape(shape), dtype=_dt(dtype),
                             generator=generator), device)


def randn(shape, dtype=None, *, device=None, generator=None):
    return _drawn(torch.randn(_shape(shape), dtype=_dt(dtype),
                              generator=generator), device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, *, device=None,
            generator=None):
    t = torch.empty(_shape(shape), dtype=_dt(dtype))
    return _drawn(t.uniform_(min, max, generator=generator), device)


def normal(mean=0.0, std=1.0, shape=None, *, device=None, generator=None):
    t = torch.empty(_shape(shape), dtype=get_default_dtype())
    return _drawn(t.normal_(mean, std, generator=generator), device)


def randint(low=0, high=None, shape=(1,), dtype="int64", *, device=None,
            generator=None):
    if high is None:
        low, high = 0, low
    return _drawn(torch.randint(low, high, _shape(shape),
                                dtype=_dt(dtype, torch.int64),
                                generator=generator), device)


def randperm(n, dtype="int64", *, device=None, generator=None):
    return _drawn(torch.randperm(int(n), generator=generator).to(
        _dt(dtype, torch.int64)), device)


def bernoulli(x, *, generator=None):
    """0 / 1 draws with probabilities x, in x's dtype, on x's device."""
    p = x.detach().to("cpu", torch.float64)
    return torch.bernoulli(p, generator=generator).to(x.device, x.dtype)


def multinomial(x, num_samples=1, replacement=False, *, generator=None):
    """int64 category draws from the rows of x (unnormalised
    probabilities), on x's device."""
    p = x.detach().to("cpu", torch.float64)
    out = torch.multinomial(p, num_samples, replacement,
                            generator=generator)
    return out.to(x.device)


# ----------------------------- math -----------------------------

def _unary(name, fn):
    def f(x, name=None):
        return fn(_t(x))

    f.__name__ = name
    return f


exp = _unary("exp", torch.exp)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
square = _unary("square", lambda x: x * x)
abs = _unary("abs", torch.abs)  # noqa: A001
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)  # noqa: A001
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
erf = _unary("erf", torch.erf)
sign = _unary("sign", torch.sign)
reciprocal = _unary("reciprocal", lambda x: 1.0 / x)
neg = _unary("neg", torch.neg)
logit = _unary("logit", lambda x: torch.log(x / (1.0 - x)))
expm1 = _unary("expm1", torch.expm1)
digamma = _unary("digamma", torch.digamma)
lgamma = _unary("lgamma", torch.lgamma)
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda x: x - torch.trunc(x))
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)


def add(x, y, name=None):
    return _t(x, y) + y


def subtract(x, y, name=None):
    return _t(x, y) - y


def multiply(x, y, name=None):
    return _t(x, y) * y


def divide(x, y, name=None):
    return _t(x, y) / y


def floor_divide(x, y, name=None):
    return _t(x, y) // y


def remainder(x, y, name=None):
    return _t(x, y) % y


mod = remainder


def pow(x, y, name=None):  # noqa: A001
    return _t(x, y) ** y


def maximum(x, y, name=None):
    return torch.maximum(_t(x, y), _t(y, x))


def minimum(x, y, name=None):
    return torch.minimum(_t(x, y), _t(y, x))


def fmax(x, y, name=None):
    return torch.fmax(_t(x, y), _t(y, x))


def fmin(x, y, name=None):
    return torch.fmin(_t(x, y), _t(y, x))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    out = K.scale(_t(x), scale, bias, bias_after_scale)
    return globals()[act](out) if act else out


def clip(x, min=None, max=None, name=None):
    return torch.clamp(_t(x), min, max)


def add_n(inputs):
    if isinstance(inputs, torch.Tensor):
        return inputs
    out = inputs[0]
    for v in inputs[1:]:
        out = out + v
    return out


def multiply_list(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out * x
    return out


def atan2(x, y):
    return torch.atan2(x, y)


def hypot(x, y):
    return torch.hypot(x, y)


def lerp(x, y, weight):
    return x + weight * (y - x)


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


# ----------------------------- reductions -----------------------------

def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    out = K.reduce_sum(_t(x), axis, keepdim)
    dt = convert_dtype(dtype)
    return out if dt is None else out.to(dt)


def mean(x, axis=None, keepdim=False, name=None):
    return K.reduce_mean(_t(x), axis, keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return K.reduce_max(_t(x), axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return K.reduce_min(_t(x), axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    return K.reduce_prod(_t(x), axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return K.logsumexp(_t(x), axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    x = _t(x).bool()
    return torch.all(x) if axis is None and not keepdim else torch.all(
        x, dim=K._dims(x, axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    x = _t(x).bool()
    return torch.any(x) if axis is None and not keepdim else torch.any(
        x, dim=K._dims(x, axis), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False):
    x = _t(x)
    return torch.std(x, K._dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    x = _t(x)
    return torch.var(x, K._dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _sorted_last(x, axis):
    """x sorted along `axis` moved last (the whole tensor flattened for
    None), and the axis to put back."""
    if axis is None:
        return torch.sort(x.reshape(-1))[0], None
    return torch.sort(torch.movedim(x, axis, -1))[0], axis


def _put_back(out, x, axis, keepdim):
    if not keepdim:
        return out
    if axis is None:
        return out.reshape((1,) * x.dim())
    return out.unsqueeze(axis)


def median(x, axis=None, keepdim=False):
    """The middle value, or the mean of the two middle values for an even
    count ((lo + hi) * 0.5, jnp.median's midpoint)."""
    x = _t(x)
    s, ax = _sorted_last(x, axis)
    n = s.shape[-1]
    out = (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5
    return _put_back(out, x, ax, keepdim)


def quantile(x, q, axis=None, keepdim=False):
    """Linear interpolation between the order statistics around q * (n -
    1), weighted as jnp.quantile weighs them; a list q adds a leading
    axis."""
    x = _t(x)
    s, ax = _sorted_last(x, axis)
    n = s.shape[-1]
    qs = [q] if np.ndim(q) == 0 else list(np.asarray(q).reshape(-1))
    outs = []
    for qi in qs:
        pos = float(qi) * (n - 1)
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        hw = pos - lo
        outs.append(_put_back(s[..., lo] * (1.0 - hw) + s[..., hi] * hw,
                              x, ax, keepdim))
    return outs[0] if np.ndim(q) == 0 else torch.stack(outs)


def cumsum(x, axis=None, dtype=None, name=None):
    return K.cumsum(_t(x), axis)


def cumprod(x, dim=None, dtype=None, name=None):
    return K.cumprod(_t(x), dim)


def count_nonzero(x, axis=None, keepdim=False):
    x = _t(x)
    return (x != 0).sum(K._dims(x, axis), keepdim=keepdim).to(torch.int64)


def nansum(x, axis=None, keepdim=False):
    x = _t(x)
    return torch.nansum(x, K._dims(x, axis), keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False):
    x = _t(x)
    return torch.nanmean(x, K._dims(x, axis), keepdim=keepdim)


def amax(x, axis=None, keepdim=False):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False):
    return min(x, axis, keepdim)


# ----------------------------- linalg -----------------------------

def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return K.matmul(x, y, transpose_x, transpose_y)


def mm(x, y):
    return matmul(x, y)


def bmm(x, y):
    return K.bmm(x, y)


def dot(x, y):
    return K.dot(x, y)


def t(x):
    return K.t(x)


def transpose(x, perm, name=None):
    return K.transpose(x, perm)


def norm(x, p=2, axis=None, keepdim=False, name=None):
    return K.norm(x, p, axis, keepdim)


def dist(x, y, p=2):
    return K.norm(x - y, p)


def cross(x, y, axis=None):
    return torch.linalg.cross(x, y, dim=-1 if axis is None else axis)


def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


def einsum(eq, *xs):
    return K.einsum(eq, *xs)


def tril(x, diagonal=0):
    return K.tril(x, diagonal)


def triu(x, diagonal=0):
    return K.triu(x, diagonal)


def kron(x, y):
    return torch.kron(x, y)


def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


def inner(x, y):
    return torch.inner(x, y)


def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


# ----------------------------- manipulation -----------------------------

def _ints(v):
    if isinstance(v, torch.Tensor):
        return [int(s) for s in v.reshape(-1).tolist()]
    return [int(s) for s in (v if isinstance(v, (list, tuple)) else [v])]


def reshape(x, shape, name=None):
    return K.reshape(x, _ints(shape))


def concat(x, axis=0, name=None):
    return K.concat(x, int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """A list of parts: `num_or_sections` equal ones, or parts of the
    listed sizes (one may be -1)."""
    return K.split(x, num_or_sections, int(axis))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def stack(x, axis=0, name=None):
    return K.stack(x, axis)


def unstack(x, axis=0, num=None):
    return K.unstack(x, axis)


def unbind(x, axis=0):
    return unstack(x, axis)


def squeeze(x, axis=None, name=None):
    return K.squeeze(x, axis)


def unsqueeze(x, axis, name=None):
    return K.unsqueeze(x, axis)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return K.flatten(x, start_axis, stop_axis)


def expand(x, shape, name=None):
    return K.expand(x, _ints(shape))


def expand_as(x, y, name=None):
    return K.expand_as(x, y)


def broadcast_to(x, shape, name=None):
    return K.broadcast_to(x, _ints(shape))


def tile(x, repeat_times, name=None):
    return K.tile(x, _ints(repeat_times))


def slice(x, axes, starts, ends):  # noqa: A001
    return K.slice_op(x, axes, _ints(starts), _ints(ends))


def strided_slice(x, axes, starts, ends, strides):
    return K.strided_slice(x, axes, _ints(starts), _ints(ends),
                           _ints(strides))


def gather(x, index, axis=0, name=None):
    return K.gather(x, index, int(axis))


def gather_nd(x, index, name=None):
    return K.gather_nd(x, index)


def scatter(x, index, updates, overwrite=True, name=None):
    """overwrite=False adds `updates` onto x's rows (the JAX function);
    with duplicate indices and overwrite=True the winner depends on the
    order of the writes, as in the JAX package."""
    return K.scatter(x, index, updates, overwrite)


def scatter_nd_add(x, index, updates, name=None):
    return K.scatter_nd_add(x, index, updates)


def index_select(x, index, axis=0, name=None):
    return K.index_select(x, index, axis)


def index_sample(x, index):
    return K.index_sample(x, index)


def masked_select(x, mask, name=None):
    return K.masked_select(x, mask)


def masked_fill(x, mask, value):
    return torch.where(mask.bool(), torch.as_tensor(value, dtype=x.dtype,
                                                    device=x.device), x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return K.where(condition, _t(x, condition), _t(y, condition))


def nonzero(x, as_tuple=False):
    out = K.nonzero(x)
    if as_tuple:
        return tuple(out[:, i] for i in range(out.shape[1]))
    return out


def pad(x, paddings, mode="constant", value=0.0, data_format="NCHW",
        name=None):
    return K.pad(x, _ints(paddings), mode, value)


def roll(x, shifts, axis=None, name=None):
    return K.roll(x, shifts, axis)


def flip(x, axis, name=None):
    return K.flip(x, axis)


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


def cast(x, dtype):
    return x.to(convert_dtype(dtype))


def crop(x, shape=None, offsets=None):
    offsets = offsets or [0] * x.dim()
    idx = tuple(_b.slice(int(o), int(o) + int(s))
                for o, s in zip(offsets, _ints(shape)))
    return x[idx]


def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


def as_real(x):
    return torch.view_as_real(x)


def as_complex(x):
    return torch.view_as_complex(x.contiguous())


def meshgrid(*xs):
    return K.meshgrid(*xs)


def atleast_1d(*xs):
    outs = [torch.atleast_1d(x) for x in xs]
    return outs[0] if len(outs) == 1 else outs


def diff(x, n=1, axis=-1):
    return torch.diff(x, n, axis)


def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices.long(), axis)


def put_along_axis(x, indices, values, axis):
    """x with `values` written at `indices` along `axis` (values
    broadcast to the indices' shape)."""
    idx = indices.long()
    v = _t(values, x)
    return x.scatter(axis, idx, torch.broadcast_to(v.to(x.dtype),
                                                   idx.shape))


# ----------------------------- search/sort -----------------------------

def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return K.argmax(x, axis, keepdim, convert_dtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return K.argmin(x, axis, keepdim, convert_dtype(dtype))


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    return K.topk(x, int(k), axis, largest, sorted)


def argsort(x, axis=-1, descending=False, name=None):
    return K.argsort(x, axis, descending)


def sort(x, axis=-1, descending=False, name=None):  # noqa: A001
    return K.sort(x, axis, descending)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64"):
    if axis is not None:
        raise NotImplementedError("unique along an axis: the JAX package "
                                  "takes `axis` and applies nothing")
    return K.unique(x, return_index, return_inverse, return_counts)


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    out = K.searchsorted(sorted_sequence, values, right)
    return out.to(torch.int32 if out_int32 else torch.int64)


def histogram(x, bins=100, min=0, max=0):
    """int64 counts over `bins` equal bins of [min, max] (the data's own
    range when both are 0); the last bin holds max itself, values
    outside are dropped (jnp.histogram's rule)."""
    xf = x.reshape(-1).to(torch.float64)
    lo, hi = (float(xf.min()), float(xf.max())) if min == 0 and max == 0 \
        else (float(min), float(max))
    edges = torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                           device=x.device)
    idx = torch.searchsorted(edges, xf, right=True)
    idx = torch.where(xf == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 2)[1:bins + 1]


def bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights, minlength)


def mode(x, axis=-1, keepdim=False):
    """(the most frequent value, its count) along `axis`; among equally
    frequent values the smallest (scipy.stats.mode's rule)."""
    s = torch.sort(torch.movedim(x, axis, -1))[0]
    counts = (s[..., :, None] == s[..., None, :]).sum(-1)
    best = counts.max(-1, keepdim=True)[0]
    first = torch.argmax((counts == best).to(torch.int8), -1, keepdim=True)
    vals = torch.gather(s, -1, first)[..., 0]
    cnt = best[..., 0].to(torch.int64)
    if keepdim:
        vals, cnt = vals.unsqueeze(axis), cnt.unsqueeze(axis)
    return vals, cnt


def kthvalue(x, k, axis=-1, keepdim=False):
    """(the k-th smallest value, its index) along `axis`; equal values
    keep their order."""
    s, i = torch.sort(x, dim=axis, stable=True)
    v = s.select(axis, k - 1)
    ix = i.select(axis, k - 1)
    if keepdim:
        v, ix = v.unsqueeze(axis), ix.unsqueeze(axis)
    return v, ix.to(torch.int64)


# ----------------------------- logic -----------------------------

def equal(x, y):
    return _t(x, y) == y


def not_equal(x, y):
    return _t(x, y) != y


def less_than(x, y):
    return _t(x, y) < y


def less_equal(x, y):
    return _t(x, y) <= y


def greater_than(x, y):
    return _t(x, y) > y


def greater_equal(x, y):
    return _t(x, y) >= y


def equal_all(x, y):
    return torch.all(_t(x, y) == _t(y, x))


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.as_tensor(torch.allclose(x, y, rtol, atol, equal_nan),
                           device=x.device)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y, rtol, atol, equal_nan)


def logical_and(x, y, out=None):
    return torch.logical_and(x, y)


def logical_or(x, y, out=None):
    return torch.logical_or(x, y)


def logical_xor(x, y, out=None):
    return torch.logical_xor(x, y)


def logical_not(x, out=None):
    return torch.logical_not(x)


def bitwise_and(x, y):
    return torch.bitwise_and(x, y)


def bitwise_or(x, y):
    return torch.bitwise_or(x, y)


def bitwise_xor(x, y):
    return torch.bitwise_xor(x, y)


def bitwise_not(x):
    return torch.bitwise_not(x)


def is_empty(x):
    return torch.as_tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


# ----------------------------- misc -----------------------------

def numel(x):
    return torch.as_tensor(x.numel(), dtype=torch.int64, device=x.device)


def shape(x):
    return torch.as_tensor(list(x.shape), dtype=torch.int32,
                           device=x.device)


def rank(x):
    return torch.as_tensor(x.dim(), dtype=torch.int32, device=x.device)


def increment(x, value=1.0):
    """x += value in place; returns x."""
    with torch.no_grad():
        x.add_(value)
    return x


def one_hot(x, num_classes, name=None):
    return K.one_hot(x, num_classes)


def multiplex(inputs, index, name=None):
    return K.multiplex(inputs, index)


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]


# the JAX package's amp policy at the functions it dispatches by name
_amp.register(globals(), _amp._TENSOR_OPS)
