"""Recurrent layers (the JAX package's `nn/layer/rnn.py`): the
`SimpleRNNCell`, `LSTMCell` and `GRUCell` cells, `RNN` over a sequence,
and the multi-layer, optionally bidirectional `SimpleRNN`, `LSTM` and
`GRU` stacks.

The parameters keep the JAX names and layouts: `weight_ih` [G * hidden,
input], `weight_hh` [G * hidden, hidden], `bias_ih`, `bias_hh` [G *
hidden] (G = 1, 4, 3), all U(-1/sqrt(hidden), 1/sqrt(hidden)); the
stacks hold their cells as `cells.<layer * directions + direction>`.
The gate order is the JAX one: LSTM (i, f, g, o), GRU (r, z, n) with n =
tanh(x_n + r * (h W_hn + b_hn)).

The time loop is a Python loop of torch ops, as the JAX package's eager
path runs (cuDNN's fused RNN would be a later optimisation). Initial
states default to zeros; the stacks take them as [layers * directions,
batch, hidden] ((h, c) for the LSTM) and return the final states in the
same layout. `sequence_length` raises: the JAX layers take it and apply
nothing, so a padded batch would silently run through its pads.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from .. import initializer as I
from .common import Dropout, LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "SimpleRNN", "LSTM", "GRU"]


def _no_lengths(sequence_length):
    if sequence_length is not None:
        raise NotImplementedError(
            "sequence_length is not supported: the JAX package takes it and "
            "applies nothing, so the port refuses it")


class RNNCellBase(Layer):
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        g = self.GATES * hidden_size
        self.weight_ih = self.create_parameter([g, input_size],
                                               weight_ih_attr,
                                               default_initializer=u)
        self.weight_hh = self.create_parameter([g, hidden_size],
                                               weight_hh_attr,
                                               default_initializer=u)
        self.bias_ih = self.create_parameter([g], bias_ih_attr, is_bias=True,
                                             default_initializer=u)
        self.bias_hh = self.create_parameter([g], bias_hh_attr, is_bias=True,
                                             default_initializer=u)

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        return torch.full((batch_ref.shape[batch_dim_idx], self.hidden_size),
                          init_value, dtype=batch_ref.dtype,
                          device=batch_ref.device)

    def _gates(self, x, h):
        return (x @ self.weight_ih.T + self.bias_ih,
                h @ self.weight_hh.T + self.bias_hh)


class SimpleRNNCell(RNNCellBase):
    """h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh), act tanh or relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         device=device, generator=generator)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        xg, hg = self._gates(inputs, states)
        z = xg + hg
        out = torch.tanh(z) if self.activation == "tanh" else torch.relu(z)
        return out, out


class LSTMCell(RNNCellBase):
    GATES = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         device=device, generator=generator)

    def forward(self, inputs, states=None):
        if states is None:
            h = c = self.get_initial_states(inputs)
        else:
            h, c = states
        xg, hg = self._gates(inputs, h)
        i, f, g, o = torch.chunk(xg + hg, 4, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    GATES = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         device=device, generator=generator)

    def forward(self, inputs, states=None):
        h = self.get_initial_states(inputs) if states is None else states
        xg, hg = self._gates(inputs, h)
        xr, xz, xn = torch.chunk(xg, 3, -1)
        hr, hz, hn = torch.chunk(hg, 3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        out = (1.0 - z) * n + z * h
        return out, out


class RNN(Layer):
    """A cell run over the time axis (1, or 0 with `time_major`),
    backwards with `is_reverse`; returns (outputs, final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_lengths(sequence_length)
        axis = 0 if self.time_major else 1
        steps = inputs.shape[axis]
        states, outs = initial_states, []
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for t in order:
            out, states = self.cell(inputs.select(axis, t), states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, axis), states


class _MultiLayerRNN(Layer):
    MODE = "RNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction {direction!r}")
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction != "forward"
        self.num_directions = 2 if self.bidirectional else 1
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)
        kw = dict(device=device, generator=generator)
        cells = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else \
                hidden_size * self.num_directions
            for _ in range(self.num_directions):
                if self.MODE == "LSTM":
                    cells.append(LSTMCell(in_sz, hidden_size, *attrs, **kw))
                elif self.MODE == "GRU":
                    cells.append(GRUCell(in_sz, hidden_size, *attrs, **kw))
                else:
                    cells.append(SimpleRNNCell(in_sz, hidden_size,
                                               activation, *attrs, **kw))
        self.cells = LayerList(cells)
        #: the inter-layer dropout (its masks from a generator on the
        #: inputs' device; SpmdTrainer binds its own)
        self.layer_dropout = Dropout(dropout)

    def _init(self, initial_states, idx):
        if initial_states is None:
            return None
        if self.MODE == "LSTM":
            h, c = initial_states
            return h[idx], c[idx]
        return initial_states[idx]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_lengths(sequence_length)
        x, finals = inputs, []
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.num_directions):
                idx = layer * self.num_directions + d
                out, st = RNN(self.cells[idx], is_reverse=d == 1,
                              time_major=self.time_major)(
                    x, self._init(initial_states, idx))
                outs.append(out)
                finals.append(st)
            x = outs[0] if len(outs) == 1 else torch.cat(outs, -1)
            if self.dropout and layer < self.num_layers - 1:
                x = self.layer_dropout(x)
        if self.MODE == "LSTM":
            return x, (torch.stack([s[0] for s in finals]),
                       torch.stack([s[1] for s in finals]))
        return x, torch.stack(finals)


class SimpleRNN(_MultiLayerRNN):
    MODE = "RNN"


class LSTM(_MultiLayerRNN):
    MODE = "LSTM"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         device=device, generator=generator)


class GRU(LSTM):
    MODE = "GRU"
