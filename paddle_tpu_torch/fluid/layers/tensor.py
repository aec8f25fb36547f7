"""Static tensor-manipulation layers (fluid/layers/tensor.py parity)."""
from __future__ import annotations

import numpy as np

from ..dtypes import convert_dtype, dtype_name
from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         type=None, stop_gradient=True):
    """fluid.layers.data / fluid.data: declares a feed var.

    fluid.layers.data historically prepends a -1 batch dim
    (append_batch_size=True); fluid.data does not."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    block = default_main_program().global_block()
    return block.create_var(name=name, shape=shape,
                            dtype=convert_dtype(dtype), is_data=True,
                            stop_gradient=stop_gradient,
                            lod_level=lod_level)


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(
            convert_dtype(dtype), list(shape))
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": dtype_name(convert_dtype(dtype)),
                            "value": float(value)})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    dt = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dt, x.shape)
    helper.append_op(type="cast", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"out_dtype": dtype_name(dt)})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat")
    shape = list(input[0].shape)
    try:
        shape[axis] = sum(v.shape[axis] for v in input)
    except TypeError:
        shape[axis] = -1
    out = helper.create_variable_for_type_inference(input[0].dtype, shape)
    helper.append_op(type="concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape")
    out = helper.create_variable_for_type_inference(x.dtype, list(shape))
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose")
    shape = [x.shape[p] for p in perm]
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split")
    axis = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        sections = None
        each = input.shape[axis] // n if input.shape[axis] > 0 else -1
        shapes = [[s if i != axis else each
                   for i, s in enumerate(input.shape)]] * n
        attrs = {"num": n, "axis": axis}
    else:
        sections = list(num_or_sections)
        shapes = [[s if i != axis else sec for i, s in
                   enumerate(input.shape)] for sec in sections]
        attrs = {"sections": sections, "axis": axis}
    outs = [helper.create_variable_for_type_inference(input.dtype, sh)
            for sh in shapes]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack")
    xs = list(x)
    shape = list(xs[0].shape)
    shape.insert(axis % (len(shape) + 1), len(xs))
    out = helper.create_variable_for_type_inference(xs[0].dtype, shape)
    helper.append_op(type="stack", inputs={"X": xs}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype,
                                                               input.shape)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]}, attrs={})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                arr.dtype, list(arr.shape))
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(arr.shape),
                                "dtype": arr.dtype.name,
                                "values": arr.reshape(-1).tolist()})
    return output


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    shape = list(input.shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    out = helper.create_variable_for_type_inference(np.float32,
                                                    shape + [depth])
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten")
    d0 = int(np.prod([s for s in x.shape[:axis]])) if axis > 0 else 1
    rest = [s for s in x.shape[axis:]]
    d1 = -1 if any(s in (-1, None) for s in rest) else int(np.prod(rest))
    if any(s in (-1, None) for s in x.shape[:axis]):
        d0 = -1
    out = helper.create_variable_for_type_inference(x.dtype, [d0, d1])
    helper.append_op(type="flatten", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze")
    shape = list(input.shape)
    for a in sorted(axes):
        shape.insert(a % (len(shape) + 1), 1)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(type="unsqueeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def squeeze(input, axes=None, name=None):
    helper = LayerHelper("squeeze")
    shape = [s for i, s in enumerate(input.shape)
             if not (s == 1 and (axes is None or i in axes))]
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(type="squeeze", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes or [])})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(convert_dtype(dtype),
                                                    list(shape))
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": mean, "std": std,
                            "dtype": dtype_name(convert_dtype(dtype))})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(convert_dtype(dtype),
                                                    list(shape))
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "min": min, "max": max,
                            "dtype": dtype_name(convert_dtype(dtype))})
    return out


def argmax(x, axis=0, name=None):
    helper = LayerHelper("arg_max")
    shape = [s for i, s in enumerate(x.shape) if i != axis % len(x.shape)]
    out = helper.create_variable_for_type_inference(np.int64, shape or [1])
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(np.int32,
                                                    [len(input.shape)])
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]}, attrs={})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    """fluid.layers.scatter parity (operators/scatter_op.cc): rows of
    `input` at `index` replaced (or accumulated) with `updates`."""
    helper = LayerHelper("scatter")
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    input.shape)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]},
                     attrs={"overwrite": overwrite})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather_nd",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]}, attrs={})
    return out


def scatter_nd_add(ref, index, updates, name=None):
    helper = LayerHelper("scatter_nd_add")
    out = helper.create_variable_for_type_inference(ref.dtype, ref.shape)
    helper.append_op(type="scatter_nd_add",
                     inputs={"X": [ref], "Index": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={})
    return out


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """fluid.layers.create_parameter parity."""
    from ..layer_helper import ParamAttr

    helper = LayerHelper("create_parameter")
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape=shape, dtype=dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("create_global_var")
    var = helper.create_global_variable(shape, dtype,
                                        persistable=persistable, name=name)
    # startup-program twin (like create_parameter): the var must be
    # registered in the startup block or Executor.run(startup) won't
    # persist the filled value into the scope
    sblock = helper.startup_program.global_block()
    svar = sblock.create_var(name=var.name, shape=list(shape),
                             dtype=var.dtype, persistable=True)
    from ..initializer import Constant

    Constant(value)(svar, sblock)
    return var
