"""Linear, Embedding, LayerNorm, Dropout, the activations, the vision
layers (Sequential, Conv2D, Conv2DTranspose, the pools, the batch norms)
and the losses `hapi.Model` prepares, with the JAX package's parameter
layouts, names and initialisers.

`Linear.weight` keeps the reference's [in_features, out_features]
layout (y = x @ W + b), so a JAX `state_dict()` loads without any
transpose and no call transposes a weight. Parameters are drawn on the
CPU from an explicit `torch.Generator` (the global one when None) and
then moved to `device`, so one seed gives the same weights on every
device.

Serving-time int8: `Linear.quantize_int8()` and
`Embedding.quantize_int8()` replace the float32 `weight` Parameter with
the `weight_q` (int8) and `weight_scale` (float32) buffers of the JAX
package, so a JAX `state_dict()` of a quantized net loads by name.
A Linear an `AdapterPool` installed `_lora_idx` on adds the per-row
adapter delta inside a `lora_scope` (`ops.quant`).

The layers of the vision and Transformer slices are plain `nn.Module`s;
those added with the model-building library (the containers, the rest of
the activations, `Conv1D`, `GroupNorm`, `InstanceNorm2D`, `RMSNorm`,
`SpectralNorm`, the rest of the losses, ...) derive from `Layer` and
take `ParamAttr`s.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ... import amp as _amp
from ...core.device import resolve_device
from ...ops import kernels as K
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "Tanh", "ReLU",
           "ReLU6", "Identity", "Flatten", "Sequential", "Conv2D",
           "Conv2DTranspose", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D", "MaxPool1D", "AvgPool1D", "BatchNorm",
           "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "CrossEntropyLoss",
           "MSELoss", "LayerList", "ParameterList", "LayerDict", "Sigmoid",
           "Softsign", "Mish", "Hardswish", "Hardsigmoid", "Silu", "Swish",
           "LogSigmoid", "Tanhshrink", "GELU", "LeakyReLU", "ELU", "SELU",
           "PReLU", "Softmax", "LogSoftmax", "Softplus", "Hardtanh",
           "Hardshrink", "Softshrink", "Maxout", "Dropout2D", "AlphaDropout",
           "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D",
           "PixelShuffle", "Pad2D", "Unfold", "CosineSimilarity", "Bilinear",
           "Conv1D", "GroupNorm", "InstanceNorm2D", "LocalResponseNorm",
           "SpectralNorm", "RMSNorm", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss"]


class Dropout(nn.Module):
    """Upscale-in-train dropout, identity in eval (the reference's).
    `generator`: the torch.Generator its masks are drawn from, on the
    device of the inputs (None: that device's default generator);
    `SpmdTrainer` binds its own."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class ReLU6(nn.Module):
    def forward(self, x):
        return F.relu6(x)


class Identity(nn.Module):
    def forward(self, x):
        return x


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


#: children named "0", "1", ... in order, as the reference's Sequential
Sequential = nn.Sequential


def _addmm(x, weight, bias):
    y = torch.addmm(bias, x.reshape(-1, weight.shape[0]), weight)
    return y.reshape(*x.shape[:-1], weight.shape[1])


# the layers' computations under the amp policy, by the names of the JAX
# functions its layers call (amp.op)
_dense = _amp.op("linear", _addmm)
_embedding = _amp.op("embedding", torch.nn.functional.embedding)
_layer_norm = _amp.op("layer_norm", torch.nn.functional.layer_norm)


def _param(shape, device, init=None):
    t = torch.zeros(shape)
    if init is not None:
        init(t)
    return nn.Parameter(t.to(device))


def _quantize(layer):
    """Swap `layer.weight` for the int8 `weight_q` / float32
    `weight_scale` buffers (per output channel). One-way."""
    from ...ops import quant as Q

    w = layer.weight.detach()
    q, scale = Q.quantize_int8_weight(w)
    layer._weight_dtype = w.dtype
    layer.register_buffer("weight_q", q)
    layer.register_buffer("weight_scale", scale)
    layer.weight = None          # drops the float32 copy from the parameters
    return layer


class Linear(nn.Module):
    """y = x @ weight + bias; weight [in, out] Xavier-uniform, bias 0.
    After `quantize_int8()`, y = int8_matmul(x, weight_q, weight_scale) +
    bias."""

    def __init__(self, in_features, out_features, *, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        lim = math.sqrt(6.0 / (in_features + out_features))
        self.weight = _param(
            (in_features, out_features), dev,
            lambda t: t.uniform_(-lim, lim, generator=generator))
        self.bias = _param((out_features,), dev)

    @property
    def param_dtype(self):
        """The compute dtype of the outputs: the weight's, or after
        `quantize_int8()` the recorded pre-quantization dtype."""
        if self.weight is not None:
            return self.weight.dtype
        return self._weight_dtype

    @property
    def device(self):
        """Where the layer's weights live (float32 or int8)."""
        return (self.weight if self.weight is not None
                else self.weight_q).device

    def quantize_int8(self):
        """Serving-time weight quantization: the float32 weight becomes the
        symmetric per-output-channel int8 `weight_q` with float32
        `weight_scale` (`ops.quant.quantize_int8_weight`), and the forward
        runs the scaled int8 matmul. One-way (a serving engine owns the
        model it serves); the bias and the compute dtype stay."""
        if self.weight is None:
            return self
        return _quantize(self)

    def forward(self, x):
        if self.weight is None:
            y = F.linear_int8(x, self.weight_q, self.weight_scale, self.bias)
        else:
            y = _dense(x, self.weight, self.bias)
        # batched-LoRA hook: an AdapterPool installs `_lora_idx` on its
        # target layers; inside a `lora_scope` the per-row adapter delta
        # joins the output
        idx = self.__dict__.get("_lora_idx")
        if idx is not None:
            from ...ops.quant import current_lora

            ctx = current_lora()
            if ctx is not None:
                ids, banks = ctx
                A, B = banks[idx]
                y = y + F.lora_delta(x, A, B, ids)
        return y


class Embedding(nn.Module):
    """Token lookup; weight [num_embeddings, dim] ~ N(0, 1), or after
    `quantize_int8()` the int8 `weight_q` with `weight_scale`.
    `padding_idx`: that row starts at zero, and its lookups give zeros
    and no gradient. `sparse=True`: the weight's gradient is row-sparse
    (`F.embedding`), for the sparse optimizer rules and the PS push."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, *, device=None, generator=None):
        super().__init__()
        self._padding_idx = padding_idx
        self._sparse = bool(sparse)
        self.weight = _param(
            (num_embeddings, embedding_dim), resolve_device(device),
            lambda t: t.normal_(0.0, 1.0, generator=generator))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def quantize_int8(self):
        """Serving-time vocabulary-table quantization: the [V, D] table
        becomes int8 with per-output-channel float32 scales; a lookup
        gathers int8 rows and scales them (no dequantized table)."""
        if self.weight is None:
            return self
        return _quantize(self)

    def forward(self, x):
        if self.weight is None:
            return F.embedding_int8(x, self.weight_q, self.weight_scale,
                                    self._weight_dtype)
        if self._sparse or self._padding_idx is not None:
            return F.embedding(x, self.weight, self._padding_idx,
                               self._sparse)
        return _embedding(x, self.weight)


class LayerNorm(nn.Module):
    """Layer normalisation over the trailing dims (biased variance,
    epsilon inside the square root)."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = _param(self._normalized_shape, dev, lambda t: t.fill_(1))
        self.bias = _param(self._normalized_shape, dev)

    def forward(self, x):
        return _layer_norm(x, self._normalized_shape, self.weight, self.bias,
                           self._epsilon)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class Conv2D(nn.Module):
    """2-D convolution over NCHW, weight [out, in / groups, kh, kw] ~ N(0,
    2 / fan_in) (the reference's MSRA default, fan_in = in * kh * kw /
    groups), bias [out] zeros; `bias_attr=False` builds no bias."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        k = _pair(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        std = math.sqrt(2.0 / (in_channels * k[0] * k[1] // groups))
        self.weight = _param(
            (out_channels, in_channels // groups, k[0], k[1]), dev,
            lambda t: t.normal_(0.0, std, generator=generator))
        self.bias = None if bias_attr is False else _param((out_channels,),
                                                           dev)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups)


class Conv2DTranspose(nn.Module):
    """Transposed 2-D convolution over NCHW, weight [in, out / groups, kh,
    kw] Xavier-uniform (fans from that layout: fan_in = out / groups *
    kh * kw, fan_out = in * kh * kw, as the JAX initializer reads them),
    bias [out] zeros; `bias_attr=False` builds no bias."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        k = _pair(kernel_size)
        self._args = (stride, padding, output_padding, dilation, groups)
        shape = (in_channels, out_channels // groups, k[0], k[1])
        lim = math.sqrt(6.0 / ((shape[0] + shape[1]) * k[0] * k[1]))
        self.weight = _param(
            shape, dev, lambda t: t.uniform_(-lim, lim, generator=generator))
        self.bias = None if bias_attr is False else _param((out_channels,),
                                                           dev)

    def forward(self, x):
        return F.conv2d_transpose(x, self.weight, self.bias, *self._args)


class MaxPool2D(nn.Module):
    """Max pooling with -inf padding; `ceil_mode=True` raises."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.max_pool2d(x, *self._args)


class AvgPool2D(nn.Module):
    """Average pooling; `exclusive` leaves padded cells out of a window's
    count; `ceil_mode=True` raises."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode, exclusive)

    def forward(self, x):
        return F.avg_pool2d(x, *self._args)


class MaxPool1D(MaxPool2D):
    """Max pooling over the last axis of [N, C, L]."""

    def forward(self, x):
        return F.max_pool1d(x, *self._args)


class AvgPool1D(AvgPool2D):
    """Average pooling over the last axis of [N, C, L]."""

    def forward(self, x):
        return F.avg_pool1d(x, *self._args)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size)


class AdaptiveMaxPool2D(AdaptiveAvgPool2D):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self._output_size)


class _BatchNormBase(nn.Module):
    """Batch normalisation with the reference's semantics
    (`nn.functional.batch_norm`): weight 1, bias 0, float32 buffers
    `_mean` (0) and `_variance` (1) that training updates in place with
    ``momentum * running + (1 - momentum) * batch``. `data_format` "NCHW",
    "NCL", "NC" or "NCDHW" puts the channels on axis 1, any other (NHWC,
    NLC, NDHWC) last; `use_global_stats` normalizes with the running stats
    in training too. The port has no ParamAttr: `weight_attr` and
    `bias_attr` take None only."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        if weight_attr is not None or bias_attr is not None:
            raise NotImplementedError(
                "weight_attr / bias_attr: the port has no ParamAttr")
        dev = resolve_device(device)
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = _param((num_features,), dev, lambda t: t.fill_(1))
        self.bias = _param((num_features,), dev)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    #: the process group whose ranks' batches together are the batch the
    #: training statistics are of (`SyncBatchNorm`; the mesh trainer sets
    #: it under data parallelism); None: this rank's batch
    _sync_group = None

    def _stats_group(self):
        return self._sync_group

    def forward(self, x):
        group = self._stats_group() if self.training and not \
            self._use_global_stats else None
        if group is not None:
            return _sync_batch_norm(self, x, group)
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


def _sync_batch_norm(bn, x, group):
    """Training batch norm over the batches of `group`'s ranks: the
    per-channel sum, then the sum of squared deviations from the global
    mean, each summed over the group (forward and backward: the ranks'
    gradients are averaged afterwards), the biased variance, and the
    running stats updated from the global ones. A group of one rank is
    `F.batch_norm`."""
    import torch.distributed as dist

    from ...parallel.collectives import all_reduce_sum

    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return F.batch_norm(x, bn._mean, bn._variance, bn.weight, bn.bias,
                            training=True, momentum=bn._momentum,
                            epsilon=bn._epsilon, data_format=bn._data_format)
    c_axis = 1 if bn._data_format.startswith("NC") else x.dim() - 1
    axes = [a for a in range(x.dim()) if a != c_axis]
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    xf = x.float()
    count = torch.tensor([float(x.numel() // x.shape[c_axis])],
                         device=x.device)
    sums = all_reduce_sum(torch.cat([xf.sum(axes), count]), group)
    n = sums[-1]
    mean = sums[:-1] / n
    dev = xf - mean.reshape(shape)
    var = all_reduce_sum(dev.square().sum(axes), group) / n
    y = dev * torch.rsqrt(var + bn._epsilon).reshape(shape)
    y = y * bn.weight.float().reshape(shape) + bn.bias.float().reshape(shape)
    with torch.no_grad():
        m = bn._momentum
        bn._mean.copy_(m * bn._mean + (1.0 - m) * mean.detach())
        bn._variance.copy_(m * bn._variance + (1.0 - m) * var.detach())
    return y.to(x.dtype)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose training statistics are those of the whole
    batch over the data-parallel ranks (reference:
    operators/sync_batch_norm_op.cu, a sum of the partial moments): the
    group is `_sync_group` when set (the mesh trainer sets its batch
    axes' group), else the world's. At a world of one rank, and in eval,
    it is `BatchNorm`."""

    def _stats_group(self):
        if self._sync_group is not None:
            return self._sync_group
        import torch.distributed as dist

        return dist.group.WORLD if dist.is_initialized() else None

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every batch norm of `layer` replaced by a SyncBatchNorm holding
        the same parameters and buffers (the layer itself when it is
        one); returns the converted layer."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm.__new__(SyncBatchNorm)
            out.__dict__.update(layer.__dict__)
            out._parameters = dict(layer._parameters)
            out._buffers = dict(layer._buffers)
            out._modules = dict(layer._modules)
            return out
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class BatchNorm1D(_BatchNormBase):
    """Over [N, C] or [N, C, L] (NCL), or [N, L, C] (NLC)."""


class BatchNorm2D(_BatchNormBase):
    """Over [N, C, H, W] (NCHW) or [N, H, W, C] (NHWC)."""


class BatchNorm3D(_BatchNormBase):
    """Over [N, C, D, H, W] (NCDHW) or [N, D, H, W, C] (NDHWC)."""


class BatchNorm(_BatchNormBase):
    """The fluid form: `act` (a name in `nn.functional`, such as "relu")
    follows the normalisation; `use_global_stats=True` normalizes with
    the running stats in training too."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, use_global_stats=False,
                 *, device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device)
        self._act = act

    def forward(self, x):
        y = super().forward(x)
        return getattr(F, self._act)(y) if self._act else y


class CrossEntropyLoss(nn.Module):
    """`nn.functional.cross_entropy` with fixed arguments."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._args = dict(weight=weight, ignore_index=ignore_index,
                          reduction=reduction, soft_label=soft_label,
                          axis=axis, use_softmax=use_softmax)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._args)


class MSELoss(nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


# --------------------------------------------------------------------------
# the rest of the JAX package's `nn/layer/common.py`, on `Layer`: the
# containers, the remaining activations, convolutions, norms and losses,
# and the vision helpers. Parameter names, shapes and initialisers are the
# JAX ones, so `convert.from_jax_state` carries a JAX state across.
# --------------------------------------------------------------------------


class LayerList(Layer):
    """Sublayers named "0", "1", ... in order."""

    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, m in enumerate(layers):
            self._modules[str(i)] = m

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx % len(self._modules))]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx % len(self._modules)), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    """Parameters named "0", "1", ... in order."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx % len(self._parameters))]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


class LayerDict(Layer):
    """Sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            items = sublayers.items() if isinstance(sublayers, dict) \
                else sublayers
            for k, v in items:
                self.add_sublayer(k, v)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)


class _Fixed(Layer):
    """A layer that calls one functional entry with the arguments it was
    built with (Paddle's `name=` is taken and dropped)."""

    fn = None

    def __init__(self, *args, **kwargs):
        super().__init__()
        kwargs.pop("name", None)
        self._args, self._kwargs = args, kwargs

    def forward(self, *inputs):
        return type(self).fn(*inputs, *self._args, **self._kwargs)


def _fixed(name, fn):
    return type(name, (_Fixed,), {"fn": staticmethod(fn),
                                  "__doc__": f"`nn.functional.{fn.__name__}`"
                                             f" with fixed arguments."})


Sigmoid = _fixed("Sigmoid", F.sigmoid)
Softsign = _fixed("Softsign", F.softsign)
Mish = _fixed("Mish", F.mish)
Hardswish = _fixed("Hardswish", F.hardswish)
Hardsigmoid = _fixed("Hardsigmoid", F.hardsigmoid)
Silu = _fixed("Silu", F.silu)
Swish = _fixed("Swish", F.swish)
LogSigmoid = _fixed("LogSigmoid", F.log_sigmoid)
Tanhshrink = _fixed("Tanhshrink", F.tanhshrink)
GELU = _fixed("GELU", F.gelu)
LeakyReLU = _fixed("LeakyReLU", F.leaky_relu)
ELU = _fixed("ELU", F.elu)
SELU = _fixed("SELU", F.selu)
Softmax = _fixed("Softmax", F.softmax)
LogSoftmax = _fixed("LogSoftmax", F.log_softmax)
Softplus = _fixed("Softplus", F.softplus)
Hardtanh = _fixed("Hardtanh", F.hardtanh)
Hardshrink = _fixed("Hardshrink", F.hardshrink)
Softshrink = _fixed("Softshrink", F.softshrink)
Maxout = _fixed("Maxout", F.maxout)
PixelShuffle = _fixed("PixelShuffle", F.pixel_shuffle)
Unfold = _fixed("Unfold", F.unfold)
CosineSimilarity = _fixed("CosineSimilarity", F.cosine_similarity)
LocalResponseNorm = _fixed("LocalResponseNorm", F.local_response_norm)
L1Loss = _fixed("L1Loss", F.l1_loss)
NLLLoss = _fixed("NLLLoss", F.nll_loss)
BCELoss = _fixed("BCELoss", F.binary_cross_entropy)
BCEWithLogitsLoss = _fixed("BCEWithLogitsLoss",
                           F.binary_cross_entropy_with_logits)
SmoothL1Loss = _fixed("SmoothL1Loss", F.smooth_l1_loss)
KLDivLoss = _fixed("KLDivLoss", F.kl_div)
MarginRankingLoss = _fixed("MarginRankingLoss", F.margin_ranking_loss)


class PReLU(Layer):
    """weight [num_parameters] = `init`: one slope shared, or one per
    channel."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 generator=None):
        super().__init__(device=device, generator=generator)
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Dropout2D(Layer):
    """Drops whole channels; `generator` as `Dropout`'s."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, generator=self.generator)


class AlphaDropout(Dropout2D):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__(p, generator=generator)

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training, self.generator)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode = align_mode

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, name=None):
        super().__init__(size, scale_factor, "bilinear", True)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, name=None):
        super().__init__(size, scale_factor, "nearest")


class Pad2D(Layer):
    """Pads H and W: `padding` an int, or [left, right, top, bottom]."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding = list(padding) if isinstance(padding, (list, tuple)) \
            else [padding] * 4
        self.mode, self.value = mode, value

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value)


class Bilinear(Layer):
    """out[b, o] = x1[b] . weight[o] . x2[b] + bias[0, o]; weight [out,
    in1, in2] Xavier-uniform (read as OIHW), bias [1, out] zeros."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__(device=device, generator=generator)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return torch.einsum("bi,oij,bj->bo", x1, self.weight, x2) + self.bias


class Conv1D(Layer):
    """1-D convolution over [N, C, L]; weight [out, in / groups, k]
    Xavier-uniform (read as OIHW), bias [out] zeros."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        self._args = (stride, padding, dilation, groups)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, k], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, *self._args)


class _AffineNorm(Layer):
    """weight [c] ones and bias [c] zeros."""

    def _affine(self, c, weight_attr, bias_attr):
        self.weight = self.create_parameter(
            [c], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([c], attr=bias_attr, is_bias=True)


class GroupNorm(_AffineNorm):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self._num_groups, self._epsilon = num_groups, epsilon
        self._affine(num_channels, weight_attr, bias_attr)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon)


class InstanceNorm2D(_AffineNorm):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self._epsilon = epsilon
        self._affine(num_features, weight_attr, bias_attr)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class SpectralNorm(Layer):
    """weight / sigma_max(weight), sigma estimated by `power_iters` rounds
    of power iteration on the persistent buffers `weight_u`
    [weight_shape[dim]] and `weight_v` [the product of the rest], which
    each forward updates in place so the estimate converges across
    calls. They start as the JAX layer's: unit-norm draws of
    numpy.random.RandomState(0)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32", *, device=None):
        super().__init__(device=device)
        import numpy as np

        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = int(np.prod([s for i, s in enumerate(weight_shape) if i != dim]))
        rs = np.random.RandomState(0)
        dev = resolve_device(device)
        for name_, n in (("weight_u", h), ("weight_v", w)):
            a = rs.randn(n).astype(dtype)
            a = a / (np.linalg.norm(a) + 1e-12)
            self.register_buffer(name_, torch.from_numpy(a).to(dev))

    def forward(self, weight):
        # copies: the backward keeps the vectors it read, and the buffers
        # are written below
        out, u, v = K.spectral_normalize(weight, self.weight_u.clone(),
                                         self.weight_v.clone(), self._dim,
                                         self._power_iters, self._eps)
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return out


class RMSNorm(Layer):
    """x / rms(x) over the last axis, times weight [hidden] ones."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, *,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return K.rms_norm(x, self.weight, self._epsilon)


