"""LayerHelper: the glue every fluid layer uses to create params/vars/ops.

Reference parity: fluid/layer_helper.py (create_parameter wires startup-
program init ops; append_activation; bias handling)."""
from __future__ import annotations

from .dtypes import convert_dtype
from . import initializer as init
from .framework import (default_main_program, default_startup_program,
                        unique_name)


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, init.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"bad ParamAttr: {attr!r}")


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        self.name = kwargs.get("name") or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr=None, shape=None, dtype="float32",
                         is_bias=False, default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = convert_dtype(dtype)
        if default_initializer is None:
            default_initializer = init.Constant(0.0) if is_bias else \
                init.Xavier()
        initializer = attr.initializer or default_initializer
        name = attr.name or unique_name.generate(
            f"{self.name}.w" if not is_bias else f"{self.name}.b")
        # main-program view of the parameter — ALWAYS in the global block,
        # even when the op using it sits in a control-flow sub-block
        # (reference: Parameters live in block 0, framework.py:5053)
        p = self.main_program.global_block().create_parameter(
            name=name, shape=list(shape), dtype=dtype,
            optimize_attr={"learning_rate": attr.learning_rate},
            regularizer=attr.regularizer)
        p.trainable = attr.trainable
        # startup-program twin + its init op
        sblock = self.startup_program.global_block()
        sp = sblock.create_parameter(name=name, shape=list(shape),
                                     dtype=dtype)
        initializer(sp, sblock)
        return p

    def create_variable_for_type_inference(self, dtype=None, shape=None):
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=convert_dtype(dtype) if dtype else None,
            shape=list(shape) if shape else None)

    def create_global_variable(self, shape, dtype, persistable=True,
                               name=None):
        return self.block.create_var(
            name=name or unique_name.generate(f"{self.name}.global"),
            shape=list(shape), dtype=convert_dtype(dtype),
            persistable=persistable)

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_bias_op(self, out_var, bias, dim_start=1):
        tmp = self.create_variable_for_type_inference(out_var.dtype,
                                                      out_var.shape)
        self.append_op(type="elementwise_add",
                       inputs={"X": [out_var], "Y": [bias]},
                       outputs={"Out": [tmp]},
                       attrs={"axis": dim_start})
        return tmp

    def append_activation(self, out_var, act):
        if act is None:
            return out_var
        tmp = self.create_variable_for_type_inference(out_var.dtype,
                                                      out_var.shape)
        self.append_op(type=act, inputs={"X": [out_var]},
                       outputs={"Out": [tmp]}, attrs={})
        return tmp
