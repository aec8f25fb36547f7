"""Elementwise / math static layers (fluid/layers/nn.py + ops.py subset)."""
from __future__ import annotations

import numpy as np

from ..dtypes import dtype_name
from ..framework import Variable
from ..layer_helper import LayerHelper


def _broadcast_shape(s1, s2):
    n = max(len(s1), len(s2))
    a = [1] * (n - len(s1)) + list(s1)
    b = [1] * (n - len(s2)) + list(s2)
    out = []
    for x, y in zip(a, b):
        if x in (-1, None) or y in (-1, None):
            out.append(-1)
        else:
            out.append(max(x, y))
    return out


def _elementwise(op_type, x, y, reverse=False, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type)
    if not isinstance(y, Variable):
        y = fill_constant_scalar(helper, x, y)
    if not isinstance(x, Variable):
        x = fill_constant_scalar(helper, y, x)
    if reverse:
        x, y = y, x
    out = helper.create_variable_for_type_inference(
        x.dtype, _broadcast_shape(x.shape, y.shape))
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def fill_constant_scalar(helper, like, value):
    out = helper.create_variable_for_type_inference(like.dtype, [1])
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [1],
                            "dtype": dtype_name(like.dtype),
                            "value": float(value)})
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, False, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, False, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, False, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, False, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, False, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, False, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, False, axis, act, name)


def _unary_layer(op_type, x, attrs=None, out_shape=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(
        x.dtype, out_shape if out_shape is not None else x.shape)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs or {})
    return out


def relu(x, name=None):
    return _unary_layer("relu", x)


def sigmoid(x, name=None):
    return _unary_layer("sigmoid", x)


def tanh(x, name=None):
    return _unary_layer("tanh", x)


def sqrt(x, name=None):
    return _unary_layer("sqrt", x)


def square(x, name=None):
    return _unary_layer("square", x)


def exp(x, name=None):
    return _unary_layer("exp", x)


def log(x, name=None):
    return _unary_layer("log", x)


def abs(x, name=None):  # noqa: A001
    return _unary_layer("abs", x)


def leaky_relu(x, alpha=0.02, name=None):
    return _unary_layer("leaky_relu", x, {"alpha": alpha})


def gelu(x, approximate=False):
    return _unary_layer("gelu", x, {"approximate": approximate})


def softmax(x, axis=-1, name=None, use_cudnn=False):
    return _unary_layer("softmax", x, {"axis": axis})


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="scale", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def clip(x, min, max, name=None):  # noqa: A002
    return _unary_layer("clip", x, {"min": float(min), "max": float(max)})


def mean(x, name=None):
    helper = LayerHelper("mean")
    out = helper.create_variable_for_type_inference(x.dtype, [1])
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={})
    return out


def _reduce_layer(op_type, x, dim=None, keep_dim=False):
    helper = LayerHelper(op_type)
    if dim is None:
        attrs = {"reduce_all": True, "keep_dim": keep_dim}
        shape = [1]
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"dim": list(dims), "keep_dim": keep_dim,
                 "reduce_all": False}
        shape = [s for i, s in enumerate(x.shape)
                 if i not in [d % len(x.shape) for d in dims]] or [1]
        if keep_dim:
            shape = [1 if i in [d % len(x.shape) for d in dims] else s
                     for i, s in enumerate(x.shape)]
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def reduce_sum(x, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", x, dim, keep_dim)


def reduce_mean(x, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", x, dim, keep_dim)


def reduce_max(x, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_max", x, dim, keep_dim)


def reduce_min(x, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_min", x, dim, keep_dim)


def reduce_prod(x, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_prod", x, dim, keep_dim)
