"""The port's sparse embedding training against the JAX package's, on the
CPU (the counterpart of `tests/test_sparse_grad.py`'s eager cases; the
static ones wait for the port's static stack).

The same ids and weights, made with numpy, go through the JAX
`F.embedding(sparse=True)` / `nn.Embedding(sparse=True)` and the port's:
the port's gradient is an uncoalesced torch sparse COO tensor with one
row a looked-up id (B*S rows, concatenated on a second backward) whose
dense form equals the JAX `SelectedRows.to_dense()`; `paddle.grad`
returns a `SelectedRows`; SGD, Momentum (and Nesterov), Adam and lazy
Adam over it give the JAX optimizers' weights after 3 steps within
`test_sparse_grad.py`'s limits (rtol 1e-4, atol 1e-5), lazy Adam leaves
untouched rows bitwise where they were, and the refusals are JAX's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.sparse import SelectedRows as JRows
import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.sparse import (SelectedRows, SparseCooTensor, matmul,
                                     sparse_coo_tensor, sparse_csr_tensor)

torch.set_num_threads(1)

from _torch_parity import keep_global_rng  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("keep_global_rng")


def _jw(w):
    return jp.to_tensor(w, stop_gradient=False)


def _tw(w):
    return torch.nn.Parameter(torch.from_numpy(w.copy()))


def test_sparse_embedding_grad_is_rows_of_the_jax_selected_rows():
    V, D = 50, 8
    w = np.random.RandomState(0).randn(V, D).astype("float32")
    ids = np.array([[1, 3], [3, 7]], dtype="int64")
    jw = _jw(w)
    JF.embedding(jp.to_tensor(ids), jw, sparse=True).sum().backward()
    tw = _tw(w)
    TF.embedding(torch.from_numpy(ids), tw, sparse=True).sum().backward()
    g = tw.grad
    assert g.layout == torch.sparse_coo and not g.is_coalesced()
    assert g._nnz() == ids.size and g.shape == (V, D)
    rows = SelectedRows(g)
    assert rows.values.data_ptr() == g._values().data_ptr()   # no copy
    np.testing.assert_array_equal(rows.rows.numpy(), ids.ravel())
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jw.grad.to_dense()._data))
    # the dense path's gradient, as the JAX test compares
    td = _tw(w)
    TF.embedding(torch.from_numpy(ids), td).sum().backward()
    np.testing.assert_array_equal(rows.numpy(), td.grad.numpy())


def test_accumulation_concatenates_and_padding_idx_gets_nothing():
    V, D = 20, 4
    ids = np.array([0, 2, 2, 5], dtype="int64")
    jw = _jw(np.ones((V, D), "float32"))
    tw = _tw(np.ones((V, D), "float32"))
    for _ in range(2):
        JF.embedding(jp.to_tensor(ids), jw, padding_idx=0,
                     sparse=True).sum().backward()
        TF.embedding(torch.from_numpy(ids), tw, padding_idx=0,
                     sparse=True).sum().backward()
    assert isinstance(jw.grad, JRows)
    g = tw.grad
    # AccumulateGrad joins the two sparse gradients by torch's sparse add:
    # still sparse, never a dense [V, D]; on the CPU two sorted runs of
    # rows pair up entry by entry (here 4 entries, JAX concatenates to 8)
    assert g.layout == torch.sparse_coo
    assert ids.size <= g._nnz() <= 2 * ids.size
    dense = SelectedRows(g).numpy()
    np.testing.assert_array_equal(dense, np.asarray(jw.grad.to_dense()._data))
    assert np.all(dense[0] == 0)
    np.testing.assert_allclose(dense[2], 4.0)
    np.testing.assert_allclose(dense[5], 2.0)


def test_layer_sparse_and_padding_idx():
    """`nn.Embedding(V, D, padding_idx, sparse=True)`: the padding row
    starts at zero, its lookups are zeros, and the gradient is sparse."""
    emb = tnn.Embedding(10, 3, padding_idx=2, sparse=True, device="cpu")
    assert float(emb.weight.detach()[2].abs().sum()) == 0
    out = emb(torch.tensor([[2, 4]]))
    assert float(out[0, 0].abs().sum()) == 0
    out.sum().backward()
    assert emb.weight.grad.layout == torch.sparse_coo
    np.testing.assert_array_equal(SelectedRows(emb.weight.grad).numpy()[2],
                                  0.0)


def _train(lib, sparse, opt_name, kw, w0, ids, steps=3, lr=0.1):
    V, D = w0.shape
    if lib == "jax":
        emb = jnn.Embedding(V, D, sparse=sparse)
        with jp.no_grad():
            emb.weight.set_value(jp.to_tensor(w0))
        opt = getattr(jp.optimizer, opt_name)(
            learning_rate=lr, parameters=emb.parameters(), **kw)
        for _ in range(steps):
            y = emb(jp.to_tensor(ids))
            (y * y).sum().backward()
            opt.step()
            opt.clear_grad()
        return np.asarray(emb.weight._data)
    emb = tnn.Embedding(V, D, sparse=sparse, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(w0))
    opt = getattr(topt, opt_name)(learning_rate=lr,
                                  parameters=emb.parameters(), **kw)
    for _ in range(steps):
        y = emb(torch.from_numpy(ids))
        (y * y).sum().backward()
        if sparse:
            assert emb.weight.grad.layout == torch.sparse_coo
        opt.step()
        opt.clear_grad()
    return emb.weight.detach().numpy()


@pytest.mark.parametrize("opt_name,kw", [
    ("SGD", {}),
    ("Momentum", {"momentum": 0.9}),
    ("Momentum", {"momentum": 0.9, "use_nesterov": True}),
    ("Adam", {}),
    ("Adam", {"lazy_mode": True}),
    ("AdamW", {"lazy_mode": True, "weight_decay": 0.0}),
])
def test_sparse_rules_match_jax_after_three_steps(opt_name, kw):
    V, D = 30, 6
    w0 = np.random.RandomState(1).randn(V, D).astype("float32")
    ids = np.array([[2, 9, 2], [17, 9, 4]], dtype="int64")
    got = _train("port", True, opt_name, kw, w0, ids)
    want = _train("jax", True, opt_name, kw, w0, ids)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    untouched = np.setdiff1d(np.arange(V), np.unique(ids))
    if kw.get("lazy_mode"):
        # lazy: rows no id touched never move, bit for bit
        np.testing.assert_array_equal(got[untouched], w0[untouched])
    else:
        # the other rules are the dense update with the dense gradient
        dense = _train("port", False, opt_name, kw, w0, ids)
        np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-5)


def test_dense_parameters_keep_the_multi_tensor_path(monkeypatch):
    """A step with a sparse table and a dense Linear: the Linear goes
    through `optimizer.fused.apply`, the table through the lazy rule,
    and both match the JAX step."""
    from paddle_tpu_torch.optimizer import fused

    calls = []
    real = fused.apply
    monkeypatch.setattr(fused, "apply",
                        lambda opt, pg: calls.append(len(pg)) or
                        real(opt, pg))
    rs = np.random.RandomState(3)
    V, D = 40, 8
    w0 = rs.randn(V, D).astype("float32")
    lw = rs.randn(D, 1).astype("float32") * 0.3
    ids = rs.randint(0, V, (6, 3)).astype("int64")
    y = rs.randn(6, 1).astype("float32")

    jemb, jlin = jnn.Embedding(V, D, sparse=True), jnn.Linear(D, 1)
    with jp.no_grad():
        jemb.weight.set_value(jp.to_tensor(w0))
        jlin.weight.set_value(jp.to_tensor(lw))
        jlin.bias.set_value(jp.to_tensor(np.zeros(1, "float32")))
    jopt = jp.optimizer.Adam(0.05, parameters=jemb.parameters() +
                             jlin.parameters(), lazy_mode=True)
    temb = tnn.Embedding(V, D, sparse=True, device="cpu")
    tlin = tnn.Linear(D, 1, device="cpu")
    with torch.no_grad():
        temb.weight.copy_(torch.from_numpy(w0))
        tlin.weight.copy_(torch.from_numpy(lw))
        tlin.bias.zero_()
    topt_ = topt.Adam(0.05, parameters=list(temb.parameters()) +
                      list(tlin.parameters()), lazy_mode=True)
    for _ in range(3):
        loss = ((jlin(jemb(jp.to_tensor(ids)).sum(1)) -
                 jp.to_tensor(y)) ** 2).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        tl = ((tlin(temb(torch.from_numpy(ids)).sum(1)) -
               torch.from_numpy(y)) ** 2).mean()
        tl.backward()
        topt_.step()
        topt_.clear_grad()
    assert calls == [2, 2, 2]
    np.testing.assert_allclose(temb.weight.detach().numpy(),
                               np.asarray(jemb.weight._data), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tlin.weight.detach().numpy(),
                               np.asarray(jlin.weight._data), rtol=1e-4,
                               atol=1e-5)


def test_refusals_match_jax():
    """Weight decay and grad_clip over a sparse gradient raise, as in
    JAX; an optimizer without a sparse rule raises naming it."""
    ids = np.array([1, 4], dtype="int64")
    w0 = np.ones((6, 2), "float32")

    def run(lib, make):
        if lib == "jax":
            emb = jnn.Embedding(6, 2, sparse=True)
            opt = make(jp.optimizer, emb.parameters())
            emb(jp.to_tensor(ids)).sum().backward()
        else:
            emb = tnn.Embedding(6, 2, sparse=True, device="cpu")
            with torch.no_grad():
                emb.weight.copy_(torch.from_numpy(w0))
            opt = make(topt, list(emb.parameters()))
            emb(torch.from_numpy(ids)).sum().backward()
        opt.step()

    cases = [
        (ValueError, "weight_decay", lambda m, p: m.SGD(
            0.1, parameters=p, weight_decay=0.01)),
        (ValueError, "weight_decay", lambda m, p: m.AdamW(
            0.1, parameters=p, lazy_mode=True)),
        (NotImplementedError, "grad_clip", lambda m, p: m.SGD(
            0.1, parameters=p, grad_clip=(jnn if m is jp.optimizer else tnn)
            .ClipGradByGlobalNorm(1.0))),
        (NotImplementedError, "Adagrad has no sparse", lambda m, p:
            m.Adagrad(0.1, parameters=p)),
    ]
    for exc, match, make in cases:
        for lib in ("jax", "port"):
            with pytest.raises(exc, match=match):
                run(lib, make)


def test_paddle_grad_returns_selected_rows():
    V, D = 12, 4
    ids = np.array([1, 1, 7], dtype="int64")
    jw = _jw(np.ones((V, D), "float32"))
    (jg,) = jp.grad([JF.embedding(jp.to_tensor(ids), jw,
                                  sparse=True).sum()], [jw])
    tw = _tw(np.ones((V, D), "float32"))
    (g,) = tp.grad([TF.embedding(torch.from_numpy(ids), tw,
                                 sparse=True).sum()], [tw])
    assert isinstance(g, SelectedRows) and isinstance(jg, JRows)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg.to_dense()._data))
    assert tw.grad is None


def test_nonleaf_and_tied_weights_fall_back_to_dense():
    V, D = 10, 3
    ids = np.array([0, 4], dtype="int64")
    jw = _jw(np.ones((V, D), "float32"))
    JF.embedding(jp.to_tensor(ids), jw * 2.0, sparse=True).sum().backward()
    tw = _tw(np.ones((V, D), "float32"))
    TF.embedding(torch.from_numpy(ids), tw * 2.0,
                 sparse=True).sum().backward()
    assert tw.grad.layout == torch.strided
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jw.grad._data))
    # tied: the table also enters the loss densely, so the gradient sums
    # into a dense one and every row sees the tied term
    tt = _tw(np.ones((V, D), "float32"))
    (TF.embedding(torch.from_numpy(ids), tt, sparse=True).sum()
     + tt.mean()).backward()
    assert tt.grad.layout == torch.strided
    np.testing.assert_allclose(tt.grad.numpy()[9], 1.0 / (V * D))
    np.testing.assert_allclose(tt.grad.numpy()[4], 1.0 + 1.0 / (V * D))


def test_selected_rows_api_matches_jax():
    rs = np.random.RandomState(4)
    rows = np.array([5, 1, 5, 9, 1, 12])     # 12: a fill row past height
    vals = rs.randn(6, 3).astype("float32")
    j = JRows(rows, vals, 10)
    t = SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), 10)
    assert t.shape == j.shape == (10, 3)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    jm, tm = j.merge(), t.merge()
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_array_equal(tm.values.numpy(), np.asarray(jm.values))
    # shape-stable: the input's row count, the real rows first; the fill
    # rows (>= height, dropped by every consumer) hold JAX's unmerged
    # out-of-range rows, here zero rows at `height`
    js, ts = j.merge(shape_stable=True), t.merge(shape_stable=True)
    assert ts.rows.shape == np.asarray(js.rows).shape
    real = np.asarray(js.rows) < 10
    np.testing.assert_array_equal(ts.rows.numpy()[real],
                                  np.asarray(js.rows)[real])
    np.testing.assert_array_equal(ts.values.numpy()[real],
                                  np.asarray(js.values)[real])
    assert (ts.rows.numpy()[~real] >= 10).all()
    np.testing.assert_array_equal((t + t).numpy(), (j + j).numpy())
    dense = rs.randn(10, 3).astype("float32")
    # the port adds each merged row once, JAX each entry in turn
    np.testing.assert_allclose((t + torch.from_numpy(dense)).numpy(),
                               np.asarray(j + jp.to_tensor(dense)),
                               rtol=1e-6, atol=1e-6)
    assert t.to_sparse()._nnz() == 5
    assert t.astype("float64").dtype == torch.float64
    if not torch.cuda.is_available():
        # arrays land where device=None points: the card, absent here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SelectedRows(rows, vals, 10)


def test_coo_csr_and_matmul_match_jax():
    from paddle_tpu import sparse as JS

    idx = np.array([[0, 1, 1], [2, 0, 2]])
    vals = np.array([1.0, 2.0, 3.0], "float32")
    t = sparse_coo_tensor(torch.from_numpy(idx), torch.from_numpy(vals),
                          [2, 3])
    j = JS.sparse_coo_tensor(idx, vals, [2, 3])
    assert isinstance(t, SparseCooTensor) and t.shape == [2, 3]
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()._data))
    dup = (np.array([[0, 0], [1, 1]]), np.array([1.0, 5.0], "float32"))
    tc = sparse_coo_tensor(*map(torch.from_numpy, dup), [2, 2]).coalesce()
    jc = JS.sparse_coo_tensor(*dup, [2, 2]).coalesce()
    assert tc.nnz() == jc.nnz() == 1
    np.testing.assert_array_equal(tc.to_dense().numpy(),
                                  np.asarray(jc.to_dense()._data))
    csr = sparse_csr_tensor([0, 1, 3], [2, 0, 2], torch.from_numpy(vals),
                            [2, 3])
    np.testing.assert_array_equal(csr.to_dense().numpy(),
                                  t.to_dense().numpy())
    d = np.random.RandomState(3).randn(3, 5).astype("float32")
    np.testing.assert_allclose(matmul(t, torch.from_numpy(d)).numpy(),
                               np.asarray(JS.matmul(j, d)._data), rtol=1e-6)


def test_big_vocab_trains_without_a_dense_gradient():
    V, D = 200_000, 16
    emb = tnn.Embedding(V, D, sparse=True, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    opt = topt.Adam(0.05, parameters=emb.parameters(), lazy_mode=True)
    before = emb.weight[:100].detach().clone()
    (emb(torch.tensor([5, 77, 123456])) ** 2).sum().backward()
    assert emb.weight.grad._values().shape == (3, D)
    opt.step()
    moved = (emb.weight[:100] - before).abs().sum(1) > 0
    assert moved[5] and moved[77] and not moved[6] and not moved[0]


def test_jax_sparse_table_converts():
    """A JAX `Embedding(sparse=True)`'s state loads through
    `convert.from_jax_state` and gives the same lookups."""
    from paddle_tpu_torch.convert import from_jax_state

    jemb = jnn.Embedding(30, 4, sparse=True)
    temb = tnn.Embedding(30, 4, sparse=True, device="cpu")
    temb.load_state_dict(from_jax_state(
        {k: np.asarray(v) for k, v in jemb.state_dict().items()}))
    ids = np.array([[3, 29, 0]], dtype="int64")
    np.testing.assert_array_equal(
        temb(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jemb(jp.to_tensor(ids))._data))
