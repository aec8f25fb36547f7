"""The port's RNNs against the JAX package's, on the CPU.

The cells (`SimpleRNNCell` with tanh and relu, `LSTMCell`, `GRUCell`),
`RNN` forward and reversed, and the `SimpleRNN` / `LSTM` / `GRU` stacks
(2 layers, forward and bidirectional, batch-major and time-major, with
and without initial states) are built in JAX, loaded into the port
through `convert.from_jax_state`, and run on the same float32 inputs.
The outputs, the final states, and the gradients of <outputs and final
states, fixed random cotangents> with respect to the inputs, the initial
states and every parameter agree within rtol 2e-5 / atol 2e-6 (float32
recurrences of up to 7 steps, summed in another order). Inter-layer
dropout is held to the eval identity and to its mask rate;
`sequence_length` raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from _torch_parity import np_state

torch.set_num_threads(2)
RTOL, ATOL = 2e-5, 2e-6


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(layer, args, torch_side):
    """Outputs, input gradients and parameter gradients of
    sum_j <flat output j, cot_j>."""
    if torch_side:
        ts = [None if a is None else torch.from_numpy(a).requires_grad_(True)
              for a in args]
    else:
        ts = [None if a is None else paddle.to_tensor(a, stop_gradient=False)
              for a in args]
    call = [t for t in ts]
    if len(call) == 3:                      # (x, h0, c0): an LSTM's state
        call = [call[0], None if call[1] is None else (call[1], call[2])]
    outs = _flat(layer(*call))
    vals = [o.detach().numpy() if torch_side else np.asarray(o.numpy())
            for o in outs]
    total = None
    for j, (o, v) in enumerate(zip(outs, vals)):
        c = np.random.RandomState(10 + j).uniform(0.5, 1.5, v.shape).astype(
            np.float32)
        term = (o * (torch.from_numpy(c) if torch_side
                     else paddle.to_tensor(c))).sum()
        total = term if total is None else total + term
    total.backward()
    gin = [None if t is None else
           (t.grad.numpy() if torch_side else np.asarray(t.grad.numpy()))
           for t in ts]
    gp = {n: (p.grad.numpy() if torch_side else np.asarray(p.grad.numpy()))
          for n, p in layer.named_parameters()}
    return vals, gin, gp


def _check(jl, pl, args):
    state = np_state(jl)
    assert set(state) == set(pl.state_dict())
    pl.load_state_dict(convert.from_jax_state(state), strict=True)
    jv, jgi, jgp = _run(jl, args, False)
    pv, pgi, pgp = _run(pl, args, True)
    assert len(jv) == len(pv)
    for a, b in zip(pv, jv):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(pgi, jgi):
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert set(pgp) == set(jgp)
    for n in pgp:
        np.testing.assert_allclose(pgp[n], jgp[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("kind", ["rnn_tanh", "rnn_relu", "lstm", "gru"])
@pytest.mark.parametrize("with_state", [False, True])
def test_cells_match_jax(kind, with_state):
    paddle.seed(1)
    mk = {"rnn_tanh": lambda m, **k: m.SimpleRNNCell(5, 6, **k),
          "rnn_relu": lambda m, **k: m.SimpleRNNCell(5, 6, "relu", **k),
          "lstm": lambda m, **k: m.LSTMCell(5, 6, **k),
          "gru": lambda m, **k: m.GRUCell(5, 6, **k)}[kind]
    args = [_x((3, 5), 2)]
    if with_state:
        args += [_x((3, 6), 3)] + ([_x((3, 6), 4)] if kind == "lstm" else [])
    _check(mk(jnn), mk(tnn, device="cpu"), args)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_major", [False, True])
def test_rnn_wrapper_matches_jax(reverse, time_major):
    paddle.seed(2)
    jl = jnn.RNN(jnn.GRUCell(4, 5), is_reverse=reverse,
                 time_major=time_major)
    pl = tnn.RNN(tnn.GRUCell(4, 5, device="cpu"), is_reverse=reverse,
                 time_major=time_major)
    _check(jl, pl, [_x((6, 3, 4) if time_major else (3, 6, 4), 5)])


@pytest.mark.parametrize("mode", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("init", [False, True])
def test_stacks_match_jax(mode, direction, init):
    paddle.seed(3)
    jl = getattr(jnn, mode)(4, 5, num_layers=2, direction=direction)
    pl = getattr(tnn, mode)(4, 5, num_layers=2, direction=direction,
                            device="cpu")
    args = [_x((3, 7, 4), 6)]
    if init:
        n = 2 * (2 if direction == "bidirect" else 1)
        args += [_x((n, 3, 5), 7)] + ([_x((n, 3, 5), 8)]
                                      if mode == "LSTM" else [])
    _check(jl, pl, args)


def test_time_major_stack_matches_jax():
    paddle.seed(4)
    jl = jnn.LSTM(4, 5, num_layers=2, direction="bidirectional",
                  time_major=True)
    pl = tnn.LSTM(4, 5, num_layers=2, direction="bidirectional",
                  time_major=True, device="cpu")
    _check(jl, pl, [_x((7, 3, 4), 9)])


def test_stack_returns_the_jax_layouts():
    lstm = tnn.LSTM(4, 5, num_layers=3, direction="bidirect", device="cpu")
    out, (h, c) = lstm(torch.randn(2, 6, 4))
    assert out.shape == (2, 6, 10) and h.shape == c.shape == (6, 2, 5)
    names = [n for n, _ in lstm.named_parameters()]
    assert names[:4] == ["cells.0.weight_ih", "cells.0.weight_hh",
                         "cells.0.bias_ih", "cells.0.bias_hh"]
    assert len(names) == 4 * 6
    assert lstm.cells[2].weight_ih.shape == (20, 10)   # layer 2 sees 2 x 5


def test_inter_layer_dropout():
    g = torch.Generator().manual_seed(0)
    gru = tnn.GRU(8, 64, num_layers=2, dropout=0.5, device="cpu",
                  generator=g)
    x = torch.randn(4, 5, 8)
    gru.eval()
    a, b = gru(x)[0], gru(x)[0]
    assert torch.equal(a, b)
    gru.train()
    seen = []
    gru.layer_dropout.register_forward_hook(
        lambda m, i, o: seen.append(float((o == 0).double().mean())))
    c = gru(x)[0]
    assert not torch.equal(a, c) and abs(seen[0] - 0.5) < 0.05
    single = tnn.GRU(8, 16, num_layers=1, dropout=0.5, device="cpu")
    single.train()
    torch.testing.assert_close(single(x)[0], single.eval()(x)[0])


def test_sequence_length_raises():
    lstm = tnn.LSTM(4, 5, device="cpu")
    with pytest.raises(NotImplementedError, match="sequence_length"):
        lstm(torch.randn(2, 3, 4), sequence_length=torch.tensor([3, 2]))
    rnn = tnn.RNN(tnn.SimpleRNNCell(4, 5, device="cpu"))
    with pytest.raises(NotImplementedError, match="sequence_length"):
        rnn(torch.randn(2, 3, 4), sequence_length=torch.tensor([3, 2]))


def test_gru_formula_and_gate_order():
    """The JAX GRU: r and z from x and h, n = tanh(x_n + r * (h W_hn +
    b_hn)), h' = (1 - z) * n + z * h; the LSTM's gates in (i, f, g, o)."""
    cell = tnn.GRUCell(3, 2, device="cpu")
    x, h = torch.randn(4, 3), torch.randn(4, 2)
    xr, xz, xn = (x @ cell.weight_ih.T + cell.bias_ih).chunk(3, -1)
    hr, hz, hn = (h @ cell.weight_hh.T + cell.bias_hh).chunk(3, -1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    want = (1 - z) * torch.tanh(xn + r * hn) + z * h
    torch.testing.assert_close(cell(x, h)[0], want)
    lstm = tnn.LSTMCell(3, 2, device="cpu")
    c = torch.randn(4, 2)
    i, f, g, o = (x @ lstm.weight_ih.T + lstm.bias_ih
                  + h @ lstm.weight_hh.T + lstm.bias_hh).chunk(4, -1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2, (h2b, c2b) = lstm(x, (h, c))
    torch.testing.assert_close(c2b, c2)
    torch.testing.assert_close(h2, torch.sigmoid(o) * torch.tanh(c2))
