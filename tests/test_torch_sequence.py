"""Parity of the port's sequence ops (`paddle_tpu_torch/ops/sequence.py`)
with the JAX package's `ops/sequence.py`: the same seeded numpy inputs
through both, in float64. Values and gradients (of <outputs, a fixed
random cotangent>) within rtol 1e-10 (atol 1e-12); integer outputs and
lengths equal."""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sequence as JS
from paddle_tpu_torch.ops import sequence as TS

from _torch_op_parity import compare
from _torch_parity import smooth

LENS = np.array([3, 1, 4, 0])
def _x(shape, seed):
    return smooth(shape, seed)


@pytest.mark.parametrize("pool", ["sum", "average", "sqrt", "max", "min",
                                  "last", "first"])
def test_sequence_pool(pool):
    compare(lambda x: JS.sequence_pool(x, LENS, pool, pad_value=-2.5),
            lambda x: TS.sequence_pool(x, torch.tensor(LENS), pool,
                                       pad_value=-2.5),
            [_x((4, 5, 3), 1)], wrt=(0,))


@pytest.mark.parametrize("pool", ["sum", "average", "sqrt", "max", "min",
                                  "last"])
def test_sequence_pool_integer(pool):
    """Integer x: the average and sqrt divide in float32 and truncate
    back to the integer type."""
    x = np.random.RandomState(2).randint(-50, 50, (4, 5, 2))
    compare(lambda a: JS.sequence_pool(a, LENS, pool),
            lambda a: TS.sequence_pool(a, LENS, pool), [x])


def test_seq_mask_and_softmax():
    compare(lambda x: (JS.seq_mask(LENS, 5), JS.sequence_softmax(x, LENS)),
            lambda x: (TS.seq_mask(torch.tensor(LENS), 5),
                       TS.sequence_softmax(x, LENS)),
            [_x((4, 5), 3)], wrt=(0,))
    compare(lambda x: JS.sequence_softmax(x, LENS),
            lambda x: TS.sequence_softmax(x, LENS),
            [_x((4, 5, 2), 4)], wrt=(0,))


def test_sequence_expand_as():
    compare(lambda x, y: JS.sequence_expand_as(x, y, LENS),
            lambda x, y: TS.sequence_expand_as(x, y, LENS),
            [_x((4, 1, 3), 5), _x((4, 5, 3), 6)], wrt=(0,))


@pytest.mark.parametrize("ctx,start", [(3, None), (4, None), (3, 0),
                                       (2, -1)])
def test_sequence_conv(ctx, start):
    compare(lambda x, w, b: JS.sequence_conv(x, LENS, w, ctx, start, b),
            lambda x, w, b: TS.sequence_conv(x, LENS, w, ctx, start, b),
            [_x((4, 5, 3), 7), _x((ctx * 3, 2), 8), _x((2,), 9)],
            wrt=(0, 1, 2))


def test_sequence_reverse_slice_reshape():
    x = _x((4, 5, 2), 10)
    compare(lambda a: JS.sequence_reverse(a, LENS),
            lambda a: TS.sequence_reverse(a, LENS), [x], wrt=(0,))
    off, ln = np.array([1, 0, 5, 0]), np.array([5, 1, 2, 3])
    compare(lambda a: JS.sequence_slice(a, LENS, off, ln),
            lambda a: TS.sequence_slice(a, LENS, off, ln), [x], wrt=(0,))
    compare(lambda a: JS.sequence_reshape(a, LENS, 1),
            lambda a: TS.sequence_reshape(a, LENS, 1), [x], wrt=(0,))
    with pytest.raises(ValueError):
        TS.sequence_reshape(torch.from_numpy(x), LENS, 3)


def test_sequence_concat_and_scatter():
    l2 = np.array([2, 3, 0, 1])
    compare(lambda a, b: JS.sequence_concat([a, b], [LENS, l2]),
            lambda a, b: TS.sequence_concat([a, b], [LENS, l2]),
            [_x((4, 5, 2), 11), _x((4, 3, 2), 12)], wrt=(0, 1))
    ids = np.array([[0, 2, 2], [1, 1, 0], [4, 3, 0], [0, 0, 0]])
    up_l = np.array([3, 2, 1, 0])
    compare(lambda x, u: JS.sequence_scatter(x, ids, u, up_l),
            lambda x, u: TS.sequence_scatter(x, torch.tensor(ids), u, up_l),
            [_x((4, 5), 13), _x((4, 3), 14)], wrt=(0, 1))


def test_sequence_enumerate_pad_unpad():
    ids = np.random.RandomState(15).randint(1, 9, (4, 5))
    compare(lambda a: JS.sequence_enumerate(a, LENS, 3, pad_value=-1),
            lambda a: TS.sequence_enumerate(a, LENS, 3, pad_value=-1),
            [ids])
    x = _x((4, 5, 2), 16)
    for plen in (None, 3, 7):
        compare(lambda a: JS.sequence_pad(a, LENS, -1.5, plen),
                lambda a: TS.sequence_pad(a, LENS, -1.5, plen), [x],
                wrt=(0,))
    compare(lambda a: JS.sequence_unpad(a, LENS),
            lambda a: TS.sequence_unpad(a, LENS), [x], wrt=(0,))


@pytest.mark.parametrize("reverse,origin", [(False, False), (True, False),
                                            (False, True)])
def test_dynamic_gru(reverse, origin):
    """The fluid layout: weight [D, 3D] split [:, :2D] for u, r and
    [:, 2D:] for the candidate; state frozen and output zero past each
    row's length."""
    compare(lambda x, w, b, h: JS.dynamic_gru(x, LENS, w, b, h, reverse,
                                              origin_mode=origin),
            lambda x, w, b, h: TS.dynamic_gru(x, LENS, w, b, h, reverse,
                                              origin_mode=origin),
            [_x((4, 5, 9), 17) * 0.3, _x((3, 9), 18) * 0.3,
             _x((1, 9), 19) * 0.1, _x((4, 3), 20) * 0.5],
            wrt=(0, 1, 2, 3))


@pytest.mark.parametrize("peep,reverse", [(True, False), (False, True),
                                          (True, True)])
def test_dynamic_lstm(peep, reverse):
    """Gate order c~, i, f, o; the [1, 7D] bias carries the peepholes."""
    D = 3
    bias = _x((1, 7 * D if peep else 4 * D), 21) * 0.1
    compare(lambda x, w, b, h, c: JS.dynamic_lstm(
                x, LENS, w, b, h, c, use_peepholes=peep, is_reverse=reverse),
            lambda x, w, b, h, c: TS.dynamic_lstm(
                x, LENS, w, b, h, c, use_peepholes=peep, is_reverse=reverse),
            [_x((4, 5, 4 * D), 22) * 0.3, _x((D, 4 * D), 23) * 0.3, bias,
             _x((4, D), 24) * 0.5, _x((4, D), 25) * 0.5],
            wrt=(0, 1, 2, 3, 4))


def test_dynamic_lstm_activations_and_no_bias():
    compare(lambda x, w: JS.dynamic_lstm(
                x, LENS, w, None, use_peepholes=False,
                gate_activation="sigmoid", cell_activation="relu",
                candidate_activation="identity"),
            lambda x, w: TS.dynamic_lstm(
                x, LENS, w, None, use_peepholes=False,
                gate_activation="sigmoid", cell_activation="relu",
                candidate_activation="identity"),
            [_x((4, 5, 8), 26) * 0.3, _x((2, 8), 27) * 0.3], wrt=(0, 1))
    with pytest.raises(ValueError):
        TS.dynamic_lstm(torch.zeros(1, 2, 8), [2], torch.zeros(2, 8), None)


def test_op_sweep_covers_the_op_library_and_runs():
    """`testing.sweep.op_cases` (chip_smoke phase 35 f) holds a case for
    every function of the sequence, structured-loss and detection modules,
    `viterbi_decode` and `vision.ops`, or names it in OP_EXCLUDED with its
    reason; each case runs on the CPU and repeats bit for bit, with
    gradients where it takes them."""
    from paddle_tpu_torch.ops import detection, detection_train
    from paddle_tpu_torch.ops import sequence_losses
    from paddle_tpu_torch.testing import sweep
    from paddle_tpu_torch.vision import ops as vops

    names = {f"{m.__name__.rsplit('.', 1)[-1]}.{n}"
             for m in (TS, sequence_losses, detection, detection_train)
             for n in m.__all__}
    names |= {f"vision.ops.{n}" for n in vops.__all__}
    names.add("viterbi.viterbi_decode")
    cases = sweep.op_cases()
    covered = {c.name.split("[")[0] for c in cases}
    assert sorted(names - covered - set(sweep.OP_EXCLUDED)) == []
    assert not covered & set(sweep.OP_EXCLUDED)
    assert len({c.name for c in cases}) == len(cases)
    for c in cases:
        a, b = sweep.run(c, "cpu"), sweep.run(c, "cpu")
        assert sweep.compare(a, b) == (0.0, True), c.name
        assert c.creates or a[1] or not c.wrt, c.name
