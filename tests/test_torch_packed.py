"""The port's packed (LoD-native) training path against the JAX package's,
on the CPU.

- `paddle_tpu_torch.core.lod` against `paddle_tpu.core.lod`: packing,
  `unpack`, `cls_flat_index`, `LoDTensor.to_packed` and the errors,
  equal exactly (both are numpy).
- The segment branch of the flash forward and both backward kernels:
  the port's `flash_attention(segment_ids=...)`, whose wrappers run the
  plain PyTorch versions on CPU tensors, against the JAX Pallas kernels
  in interpret mode (`block_q = block_k = 64`), over the causal x key
  bias grid, with attention dropout on (the keep bits equal the JAX
  counter hash bit for bit), in bf16, and with key ids that differ from
  the query ids. Segment lengths are not multiples of 64, so tiles that
  straddle a boundary and tiles the kernels skip both occur.
- Cross-segment leakage: another segment's q, k, v and dO leave a
  segment's output and gradients bitwise unchanged.
- `sdpa` routes segment ids to `flash_attention` and still refuses a
  per-query mask off the CPU.
- A tiny ERNIE fed packed rows (weights via `convert.from_jax_state`,
  dropout 0): logits and every gradient against the JAX model fed the
  same packed rows, and each sequence's packed logits against its
  padded logits.

Tolerances (those of `test_torch_training.py` and `test_torch_ernie.py`):
float32 attention outputs rtol / atol 2e-5 and gradients atol 5e-5
(reordered float32 sums over up to 256 keys); bf16 rtol / atol 2e-2 for
outputs and 6e-2 for gradients (p, ds and the outputs are rounded to
bf16 at different points of two differently ordered sums); ERNIE logits
rtol / atol 1e-5 and gradients atol 2e-5; packed against padded logits
rtol 2e-4 / atol 2e-5 (the JAX package's own packed-vs-padded bound:
the two layouts sum the same terms in another order and the padded
rows' pad keys carry a -1e4 bias, exp of which is 0 in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import lod as jlod
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import attention as JA
from paddle_tpu.parallel import functionalize
from paddle_tpu.text import ErnieConfig as JaxConfig
from paddle_tpu.text import ErnieForSequenceClassification as JaxErnie
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.text import (ErnieConfig,
                                   ErnieForSequenceClassification)

torch.set_num_threads(2)
NO_DROPOUT = dict(hidden_dropout=0.0, attn_dropout=0.0)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ragged_segs(lens_rows):
    """Per-row non-decreasing segment ids from per-row segment lengths."""
    return np.stack([np.concatenate(
        [np.full(n, i, np.int32) for i, n in enumerate(lens)])
        for lens in lens_rows])


@pytest.fixture
def one_intra_op_thread():
    """The port's side on one intra-op thread, as in
    `test_torch_training.py`: on two, the CPU `torch.exp` now and then
    returns one thread's half of a batch ~1e-4 less exact."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- lod.py

def _assert_packed_equal(got, want):
    for field in ("data", "segment_ids", "positions"):
        a, w = getattr(got, field), getattr(want, field)
        assert a.dtype == w.dtype, field
        np.testing.assert_array_equal(a, w, err_msg=field)
    assert got.spans == want.spans
    assert list(got.lengths) == list(want.lengths)
    assert (got.num_rows, got.row_len, got.fill) == \
        (want.num_rows, want.row_len, want.fill)
    np.testing.assert_array_equal(got.cls_flat_index(),
                                  want.cls_flat_index())
    assert got.cls_flat_index().dtype == want.cls_flat_index().dtype


@pytest.mark.parametrize("lens,T,row_len", [
    ([50, 30, 64, 20, 44, 10], 64, None),
    ([50, 30, 64, 20, 44, 10], 64, 128),
    ([1, 7, 3, 8, 8, 2, 5], 8, 8),
])
def test_pack_padded_equals_jax(lens, T, row_len):
    rs = np.random.RandomState(len(lens))
    padded = rs.randn(len(lens), T, 3).astype(np.float32)
    want = jlod.pack_padded(padded, lens, row_len=row_len)
    got = tlod.pack_padded(padded, lens, row_len=row_len)
    _assert_packed_equal(got, want)
    assert np.all(np.diff(got.segment_ids, axis=1) >= 0)
    for out in (None, rs.randn(*got.data.shape[:2], 5)):
        a, w = got.unpack(out), want.unpack(out)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
        assert a.lod() == w.lod()


def test_lod_tensor_round_trips_equal_jax():
    seqs = [np.arange(n, dtype=np.float32).reshape(n, 1) * (i + 1)
            for i, n in enumerate([7, 3, 5, 2])]
    jt, tt = (m.LoDTensor.from_sequences(seqs) for m in (jlod, tlod))
    assert tt.lod() == jt.lod() and tt.shape() == jt.shape()
    _assert_packed_equal(tt.to_packed(row_len=8), jt.to_packed(row_len=8))
    (tp, tl), (jp, jl) = tt.to_padded(), jt.to_padded()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)
    back = tlod.LoDTensor.from_padded(tp, tl)
    assert back.lod() == jt.lod()
    np.testing.assert_array_equal(np.asarray(back), np.asarray(jt))
    flat = tt.to_packed(row_len=8).data.reshape(-1, 1)
    for i, fi in enumerate(tt.to_packed(row_len=8).cls_flat_index()):
        np.testing.assert_array_equal(flat[fi], seqs[i][0])


def test_lod_errors_and_create_lod_tensor_equal_jax():
    for m in (jlod, tlod):
        with pytest.raises(ValueError, match="does not fit row_len 8"):
            m.pack_sequences([np.zeros((9, 2))], row_len=8)
        with pytest.raises(ValueError, match="invalid recursive_seq_lens"):
            m.create_lod_tensor(np.zeros((5, 1)), [[2, 2]])
    jt = jlod.create_lod_tensor([[1, 2], [3], [4, 5, 6]], [[2, 1, 3]])
    tt = tlod.create_lod_tensor([[1, 2], [3], [4, 5, 6]], [[2, 1, 3]])
    assert tt.lod() == jt.lod() == [[0, 2, 3, 6]]
    np.testing.assert_array_equal(np.asarray(tt), np.asarray(jt))
    assert tt.has_valid_recursive_sequence_lengths()
    assert tt.recursive_sequence_lengths() == [[2, 1, 3]]


def test_segment_bias_equals_jax():
    seg = _ragged_segs([[5, 3, 8], [10, 6]])
    kv = _ragged_segs([[7, 9], [4, 4, 8]])
    for args in ((seg,), (seg, kv)):
        want = np.asarray(JA.segment_bias(*[jnp.asarray(a) for a in args]))
        got = TA.segment_bias(*[torch.tensor(a) for a in args])
        assert got.dtype == torch.float32 and got.shape == (2, 1, 16, 16)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------ segment flash fwd + bwd vs JAX

def _jax_flash(q, k, v, bias, g, causal, p, seed, seg, kvseg, dtype):
    def loss(q, k, v, bias):
        out = JA.flash_attention(
            q, k, v, bias, causal, None, interpret=True, block_q=64,
            block_k=64, dropout_p=p,
            dropout_seed=jnp.array([seed], jnp.int32),
            segment_ids=jnp.asarray(seg),
            kv_segment_ids=None if kvseg is None else jnp.asarray(kvseg))
        return (out.astype(jnp.float32) * jnp.asarray(g)).sum(), out

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias, jnp.float32)
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    (_, out), grads = jax.value_and_grad(loss, argnums, has_aux=True)(
        *args, jb)
    return [np.asarray(out.astype(jnp.float32))] + [
        np.asarray(x.astype(jnp.float32)) for x in grads]


def _port_flash(q, k, v, bias, g, causal, p, seed, seg, kvseg, dtype):
    ts = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    tb = None if bias is None else torch.tensor(bias).requires_grad_()
    out = TA.flash_attention(
        *ts, tb, causal, None, block_q=64, block_k=64, dropout_p=p,
        dropout_seed=seed, segment_ids=torch.tensor(seg),
        kv_segment_ids=None if kvseg is None else torch.tensor(kvseg))
    (out.float() * torch.tensor(g)).sum().backward()
    grads = [t.grad for t in ts] + ([] if tb is None else [tb.grad])
    return [out.detach().float().numpy()] + [x.float().numpy()
                                             for x in grads]


# boundary-heavy rows: no segment length is a multiple of 64
_SEGS = [[100, 60, 96], [200, 40, 16]]


def _inputs(b=2, h=2, s=256, d=32, sk=None):
    sk = s if sk is None else sk
    q, g = _rand((b, h, s, d), 0), _rand((b, h, s, d), 3)
    k, v = _rand((b, h, sk, d), 1), _rand((b, h, sk, d), 2)
    # a small key bias (not a mask: a fully masked segment would leave
    # its queries with no visible key, where outputs are unspecified)
    return q, k, v, _rand((b, sk), 4) * 0.5, g


_GRID = [(bias, causal) for bias in (False, True) for causal in (False, True)]


@pytest.mark.parametrize("bias,causal", _GRID,
                         ids=[f"bias{int(b)}-causal{int(c)}"
                              for b, c in _GRID])
def test_segment_flash_fp32_matches_jax_kernels(bias, causal,
                                                one_intra_op_thread):
    q, k, v, kb, g = _inputs()
    kb = kb if bias else None
    seg = _ragged_segs(_SEGS)
    want = _jax_flash(q, k, v, kb, g, causal, 0.0, 0, seg, None,
                      jnp.float32)
    got = _port_flash(q, k, v, kb, g, causal, 0.0, None, seg, None,
                      torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for name, a, w in zip(["dq", "dk", "dv", "dbias"], got[1:], want[1:]):
        np.testing.assert_allclose(a, w, rtol=0, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_segment_flash_dropout_matches_jax_kernels(causal,
                                                   one_intra_op_thread):
    """Attention dropout 0.3 on: the port's keep bits equal the JAX
    counter hash bit for bit, and the forward and both backward passes
    match the JAX interpret-mode kernels, which draw the same bits."""
    q, k, v, kb, g = _inputs(b=1, s=256)
    seg = _ragged_segs([[100, 90, 66]])
    b, h, s = q.shape[:3]
    np.testing.assert_array_equal(
        TA.dropout_keep_reference(17, b, h, s, s, 64, 64, 0.3).numpy(),
        np.asarray(JA.dropout_keep_reference(17, b, h, s, s, 64, 64, 0.3)))
    want = _jax_flash(q, k, v, kb[:1], g, causal, 0.3, 17, seg, None,
                      jnp.float32)
    got = _port_flash(q, k, v, kb[:1], g, causal, 0.3, 17, seg, None,
                      torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for name, a, w in zip(["dq", "dk", "dv", "dbias"], got[1:], want[1:]):
        np.testing.assert_allclose(a, w, rtol=0, atol=5e-5, err_msg=name)


def test_segment_flash_bf16_matches_jax_kernels():
    q, k, v, kb, g = _inputs()
    seg = _ragged_segs(_SEGS)
    want = _jax_flash(q, k, v, kb, g, True, 0.1, -99, seg, None,
                      jnp.bfloat16)
    got = _port_flash(q, k, v, kb, g, True, 0.1, -99, seg, None,
                      torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2)
    for name, a, w in zip(["dq", "dk", "dv", "dbias"], got[1:], want[1:]):
        np.testing.assert_allclose(a, w, rtol=6e-2, atol=6e-2,
                                   err_msg=name)


def test_kv_segment_ids_differ_from_query_ids(one_intra_op_thread):
    """Cross-attention between packings of other lengths (sq 128, sk
    192): every query id has keys, so no row is degenerate."""
    q, k, v, kb, g = _inputs(s=128, sk=192)
    seg = _ragged_segs([[50, 40, 38], [70, 58]])
    kvseg = _ragged_segs([[60, 100, 32], [90, 102]])
    want = _jax_flash(q, k, v, kb, g, False, 0.0, 0, seg, kvseg,
                      jnp.float32)
    got = _port_flash(q, k, v, kb, g, False, 0.0, None, seg, kvseg,
                      torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for name, a, w in zip(["dq", "dk", "dv", "dbias"], got[1:], want[1:]):
        np.testing.assert_allclose(a, w, rtol=0, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_no_cross_segment_leakage(p):
    """Huge values in segment 1's q, k, v and dO leave segment 0's output
    and its dq, dk, dv bitwise unchanged, with and without dropout."""
    b, h, s, d = 1, 2, 256, 16
    seg = torch.tensor(_ragged_segs([[130, 126]]))
    base = [torch.tensor(_rand((b, h, s, d), i)) for i in range(4)]
    moved = [t.clone() for t in base]
    for t in moved:
        t[:, :, 130:] = 1e4 * torch.randn(b, h, s - 130, d,
                                          generator=torch.Generator()
                                          .manual_seed(5))

    def run(q, k, v, g):
        ts = [x.clone().requires_grad_() for x in (q, k, v)]
        out = TA.flash_attention(*ts, None, True, None, dropout_p=p,
                                 dropout_seed=3, segment_ids=seg)
        out.backward(g)
        return [out.detach()] + [t.grad for t in ts]

    for a, w in zip(run(*base), run(*moved)):
        assert torch.equal(a[:, :, :130], w[:, :, :130])
    assert run(*moved)[0][:, :, 130:].abs().max() > 10.0


# ---------------------------------------------------------------- dispatch

def test_sdpa_routes_segment_ids_to_flash_attention(monkeypatch):
    q = torch.tensor(_rand((2, 2, 64, 16), 11))
    seg = torch.tensor(_ragged_segs([[40, 24], [10, 54]]))
    want = TA.sdpa_reference(q, q, q, TA.segment_bias(seg))
    got = TA.sdpa(q, q, q, segment_ids=seg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # a padded-row key bias composes with the segment ids on the way
    kb = torch.zeros(2, 1, 1, 64)
    kb[1, ..., 60:] = -1e4
    seen = {}
    real = TA.flash_attention

    def spy(*args, **kw):
        seen.update(kw, bias=args[3])
        return real(*args, **kw)

    monkeypatch.setattr(TA, "flash_attention", spy)
    TA.sdpa(q, q, q, kb, dropout_p=0.1, dropout_seed=4, segment_ids=seg)
    assert seen["segment_ids"] is seg and seen["dropout_p"] == 0.1
    assert torch.equal(seen["bias"], kb.reshape(2, 64))


def test_sdpa_still_refuses_a_per_query_mask_off_the_cpu():
    """Segment ids are the per-query mask the kernels take; any other
    per-query mask still raises on the meta device, with or without
    segment ids, and runs the reference composition (segment mask
    folded in) on the CPU."""
    rich = torch.where(torch.ones(16, 16, dtype=torch.bool).tril(), 0.0,
                       -1e30)[None, None].expand(2, 1, 16, 16)
    seg = _ragged_segs([[9, 7], [16]])
    meta = torch.empty(2, 2, 16, 8, device="meta")
    for segment_ids in (None, torch.tensor(seg, device="meta")):
        with pytest.raises(NotImplementedError, match="per query"):
            TA.sdpa(meta, meta, meta, rich.to("meta"),
                    segment_ids=segment_ids)
    q = torch.tensor(_rand((2, 2, 16, 8), 12))
    got = TA.sdpa(q, q, q, rich, segment_ids=torch.tensor(seg))
    want = JA.sdpa_reference(jnp.asarray(q.numpy()), jnp.asarray(q.numpy()),
                             jnp.asarray(q.numpy()),
                             jnp.asarray(rich.numpy())
                             + JA.segment_bias(jnp.asarray(seg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ packed ERNIE

def _packed_batch(seed=0, lens=(50, 30, 64, 20, 44, 10), T=64, vocab=1024):
    rs = np.random.RandomState(seed)
    ids = np.zeros((len(lens), T), np.int64)
    mask = np.zeros((len(lens), T), np.float32)
    for i, n in enumerate(lens):
        ids[i, :n] = rs.randint(1, vocab, n)
        mask[i, :n] = 1.0
    labels = rs.randint(0, 2, (len(lens),)).astype(np.int64)
    return ids, mask, labels, tlod.pack_padded(ids, list(lens), row_len=T)


def _models(seed=0):
    paddle.seed(seed)
    jm = JaxErnie(JaxConfig.tiny(**NO_DROPOUT))
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    model = ErnieForSequenceClassification(ErnieConfig.tiny(**NO_DROPOUT),
                                           device="cpu")
    model.load_state_dict(convert.from_jax_state(sd), strict=True)
    return jm, model


def _packed_args(pk):
    return (pk.data.astype(np.int64), None, None,
            pk.positions.astype(np.int64), pk.segment_ids,
            pk.cls_flat_index().astype(np.int64))


def test_packed_ernie_logits_and_gradients_match_jax():
    jm, model = _models()
    _, _, labels, pk = _packed_batch()
    assert pk.num_rows < len(pk.lengths)           # rows are shared
    args = _packed_args(pk)
    fm = functionalize(jm)
    params, buffers = fm.params(), fm.buffers()

    def jloss(params):
        # keyword inputs reach the layer as they are (positional ones are
        # wrapped, None included)
        out, _ = fm.apply(params, buffers, None, jnp.asarray(args[0]),
                          training=True, **{
                              k: Tensor._wrap(jnp.asarray(a)) for k, a in
                              zip(("position_ids", "attn_segment_ids",
                                   "cls_flat_index"), args[3:])})
        lp = jax.nn.log_softmax(out.astype(jnp.float32), -1)
        return -jnp.take_along_axis(
            lp, jnp.asarray(labels)[:, None], -1).mean(), out

    (j_loss, j_out), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    model.train()
    out = model(*[None if a is None else torch.from_numpy(a)
                  for a in args])
    loss = torch.nn.functional.cross_entropy(out, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5,
                               atol=1e-5)
    assert {n for n, _ in model.named_parameters()} == set(j_grads)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grads[n]),
                                   rtol=0, atol=2e-5, err_msg=n)


def test_packed_ernie_logits_equal_padded():
    """Each sequence's logits from the packed rows equal its logits from
    the padded batch (dropout 0), in the port as in the JAX package."""
    _, model = _models(1)
    ids, mask, _, pk = _packed_batch(seed=1)
    model.eval()
    with torch.no_grad():
        want = model(torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask))
        got = model(*[None if a is None else torch.from_numpy(a)
                      for a in _packed_args(pk)])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)
