"""`Layer`, the Paddle 2.0 module base, on `torch.nn.Module`.

A model written the Paddle way (``class Net(paddle.nn.Layer)`` with
``self.create_parameter(...)``) runs on the port as it is, with one
difference: a Layer's parameters live on a device, `device=None` meaning
the CUDA card (`core.device.resolve_device`, asked when
`create_parameter` first runs, so a layer without parameters needs no
device), and its random parameters are drawn
from `generator`, a CPU `torch.Generator` (None: torch's default CPU
generator), then moved there:

    class Net(paddle.nn.Layer):
        def __init__(self, device=None):
            super().__init__(device=device)
            self.w = self.create_parameter([4, 3])
            self.b = self.create_parameter([3], is_bias=True)

        def forward(self, x):
            return x @ self.w + self.b

Paddle's names map onto torch's machinery: `add_parameter`,
`add_sublayer`, `register_buffer(persistable=)` (a non-persistable
buffer stays out of `state_dict()`), `sublayers`, `named_sublayers`,
`set_state_dict`, `clear_gradients`, and the forward pre- and post-hooks
(`register_forward_pre_hook`, `register_forward_post_hook`), whose
`HookRemoveHelper.remove()` takes them off again. `parameters()` returns
a list, as Paddle's does.

`ParamAttr` carries a parameter's name (`param_name` on the Parameter:
torch's `name` is read-only), initializer, rate multiplier
(`optimize_attr["learning_rate"]`, which the port's optimizers read),
regularizer, `trainable` (requires_grad) and `need_clip`.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from ...core.dtypes import convert_dtype, get_default_dtype
from .. import initializer as I

__all__ = ["ParamAttr", "Layer", "HookRemoveHelper"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> the default attr; False -> no parameter; a name or an
        initializer -> an attr holding it."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr) or attr is False:
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"bad param attr {attr!r}")


_name_counters = collections.defaultdict(int)


def _unique_name(prefix):
    _name_counters[prefix] += 1
    return f"{prefix}_{_name_counters[prefix] - 1}"


class HookRemoveHelper:
    """The handle a hook registration returns: `remove()` takes the hook
    off the layer."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        self._handle.remove()


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype=None, *, device=None,
                 generator=None):
        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        # resolved when a parameter is made: a layer without parameters
        # (an activation, a container) lives nowhere in particular
        self._device = device
        self._generator = generator
        self._full_name = _unique_name(
            name_scope or type(self).__name__.lower())

    # ---------------- parameters ----------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new Parameter of `shape` on the layer's device (not yet
        registered: assign it to an attribute or `add_parameter` it). The
        initializer is the attr's, else `default_initializer`, else zeros
        for a bias and XavierUniform for anything else. `attr=False`
        returns None (no parameter)."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dt = convert_dtype(dtype) or self._dtype
        if default_initializer is None:
            default_initializer = I.Constant(0.0) if is_bias else \
                I.XavierUniform()
        init = attr.initializer or default_initializer
        data = init(shape, dt, self._generator)
        p = nn.Parameter(data.to(resolve_device(self._device)),
                         requires_grad=bool(attr.trainable))
        # torch.Tensor's own `name` is read-only: Paddle's parameter name
        p.param_name = attr.name or _unique_name("param")
        p.trainable = bool(attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """Paddle's `persistable` (torch's `persistent`): a
        non-persistable buffer stays out of `state_dict()`."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=bool(keep))
        return tensor

    def parameters(self, include_sublayers=True, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return list(super().parameters(recurse=rec))

    # ---------------- traversal ----------------
    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    # ---------------- state ----------------
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy `state_dict` ({name: tensor or array}) into the layer's
        parameters and persistable buffers, in place. Returns (missing,
        unexpected) names."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        with torch.no_grad():
            for name, t in own.items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                v = state_dict[name]
                v = v.detach() if isinstance(v, torch.Tensor) else \
                    torch.as_tensor(np.asarray(v))
                t.copy_(v.reshape(t.shape).to(t.dtype))
        unexpected = [n for n in state_dict if n not in own]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ---------------- hooks ----------------
    def register_forward_pre_hook(self, hook):
        """hook(layer, inputs) -> None or new inputs (a tuple, or one
        value)."""
        return HookRemoveHelper(super().register_forward_pre_hook(hook))

    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs) -> None or new outputs."""
        return HookRemoveHelper(super().register_forward_hook(hook))

    def forward(self, *args, **kwargs):
        raise NotImplementedError
