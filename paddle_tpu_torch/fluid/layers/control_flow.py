"""Static-graph control flow (the JAX package's `fluid/layers/control_flow.py`).

The compare / logical builders and `increment` build ops this slice
lowers. The control-flow builders proper (`While`, `cond`, `case`,
`switch_case`, `StaticRNN`, `DynamicRNN`, `IfElse`) and the tensor-array
builders come with ROADMAP item 8b and raise until then; the `while`,
`conditional_block` and `recurrent` lowerings already run programs that
carry those ops (built by the JAX package and read from the wire).
"""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "While", "cond", "case", "switch_case", "StaticRNN", "increment",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "create_array", "array_write", "array_read", "array_length",
    "DynamicRNN", "IfElse",
]

ITEM_8B = "ROADMAP item 8b"


def _waits(name):
    def builder(*args, **kwargs):
        raise NotImplementedError(
            f"fluid.layers.{name}: the port's control-flow builders come "
            f"with {ITEM_8B}")
    builder.__name__ = name
    builder.__qualname__ = name
    return builder


def _cmp_layer(op_type, x, y, out=None):
    helper = LayerHelper(op_type)
    if not isinstance(y, Variable):
        from .math_ops import fill_constant_scalar

        y = fill_constant_scalar(helper, x, y)
    if out is None:
        out = helper.create_variable_for_type_inference("bool", x.shape)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={})
    return out


def less_than(x, y, force_cpu=None, cond=None, name=None):
    return _cmp_layer("less_than", x, y, cond)


def less_equal(x, y, cond=None, name=None):
    return _cmp_layer("less_equal", x, y, cond)


def greater_than(x, y, cond=None, name=None):
    return _cmp_layer("greater_than", x, y, cond)


def greater_equal(x, y, cond=None, name=None):
    return _cmp_layer("greater_equal", x, y, cond)


def equal(x, y, cond=None, name=None):
    return _cmp_layer("equal", x, y, cond)


def not_equal(x, y, cond=None, name=None):
    return _cmp_layer("not_equal", x, y, cond)


def _logical_layer(op_type, x, y, out=None):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference("bool", x.shape)
    inputs = {"X": [x]} if y is None else {"X": [x], "Y": [y]}
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={"Out": [out]}, attrs={})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical_layer("logical_and", x, y, out)


def logical_or(x, y, out=None, name=None):
    return _logical_layer("logical_or", x, y, out)


def logical_xor(x, y, out=None, name=None):
    return _logical_layer("logical_xor", x, y, out)


def logical_not(x, out=None, name=None):
    return _logical_layer("logical_not", x, None, out)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


While = _waits("While")
cond = _waits("cond")
case = _waits("case")
switch_case = _waits("switch_case")
StaticRNN = _waits("StaticRNN")
DynamicRNN = _waits("DynamicRNN")
IfElse = _waits("IfElse")
create_array = _waits("create_array")
fill_i64 = _waits("fill_i64")
array_write = _waits("array_write")
array_read = _waits("array_read")
array_length = _waits("array_length")
