"""The port's int8 and gathered-LoRA ops against the JAX package's, on the
CPU.

Numpy in, numpy out. `quantize_int8_weight` gives the JAX int8 weights
and scales exactly (an all-zero column included); the plain versions of
the int8 matmul and gathered-LoRA kernels match the JAX Pallas kernels
in interpret mode within rtol / atol 1e-6 (float32 sums of at most 64
products in another order, on outputs of order 1; a bf16 x is cast to
float32 by both and the results rounded to bf16 alike); bank row 0
gives an exact zero. A JAX `state_dict()` of a quantized stack loads
into a quantized port stack and gives the JAX logits (atol 1e-5, as for
the float32 stack), and `AdapterPool` gives the JAX pool's rows, hits,
loads, evictions and banks over one scripted sequence of acquires and
releases.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import quant as JQ
from paddle_tpu.serving import AdapterPool as JAdapterPool
from paddle_tpu.serving import OutOfAdapters as JOutOfAdapters
from paddle_tpu.serving import quantize_net as jquantize_net
from paddle_tpu_torch.convert import from_jax_state
from paddle_tpu_torch.ops import quant as TQ
from paddle_tpu_torch.serving import AdapterPool, OutOfAdapters, quantize_net

torch.set_num_threads(2)
TOL = 1e-6


def _j(x, dtype=None):
    import jax.numpy as jnp

    return jnp.asarray(x, dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", [(48, 96), (97, 64), (3, 5, 7)])
def test_quantize_int8_weight_equals_jax(shape):
    rs = np.random.RandomState(len(shape) + shape[-1])
    w = (rs.randn(*shape) * 0.05).astype(np.float32)
    w[..., 3] = 0.0                                   # an all-zero column
    w.reshape(-1)[7] = 0.5 * np.abs(w).max()          # a rounding tie region
    jq, js = JQ.quantize_int8_weight(_j(w))
    tq, ts = TQ.quantize_int8_weight(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[3].item() == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mdn", [(16, 64, 128), (16, 64, 37)],
                         ids=["16x64x128", "ragged_n37"])
def test_int8_matmul_plain_matches_jax_kernel(mdn, dtype):
    import jax.numpy as jnp

    m, d, n = mdn
    rs = np.random.RandomState(n)
    x = rs.randn(m, d).astype(np.float32)
    q, s = JQ.quantize_int8_weight(_j((rs.randn(d, n) * 0.05)
                                      .astype(np.float32)))
    bias = rs.randn(n).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want = JQ.int8_matmul(_j(x, jdt), q, s, _j(bias), interpret=True)
    args = (_t(x).to(tdt), _t(np.asarray(q)), _t(np.asarray(s)), _t(bias))
    got = TQ.int8_matmul(*args)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL, atol=TOL)
    ref = TQ.int8_matmul_reference(*args)
    np.testing.assert_array_equal(ref.float().numpy(), got.float().numpy())


@pytest.mark.parametrize("r", [4, 8])
def test_lora_delta_plain_matches_jax_kernel(r):
    rs = np.random.RandomState(r)
    cap, d, dout = 4, 32, 48
    # banks at `register_random`'s default scale (0.1), x of unit scale
    A = (rs.randn(cap, d, r) * 0.1).astype(np.float32)
    B = (rs.randn(cap, r, dout) * 0.1).astype(np.float32)
    A[0] = B[0] = 0.0
    x = rs.randn(5, 2, d).astype(np.float32)
    ids = np.asarray([0, 1, 3, 2, 1], np.int32)
    want = np.asarray(JQ.lora_delta(_j(x), _j(A), _j(B), _j(ids),
                                    interpret=True))
    got = TQ.lora_delta(_t(x), _t(A), _t(B), ids).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.abs(got[0]).max() == 0.0              # the base row
    for i in range(1, 5):                           # each row its own id
        solo = TQ.lora_delta(_t(x[i:i + 1]), _t(A), _t(B), ids[i:i + 1])
        np.testing.assert_array_equal(got[i], solo.numpy()[0])
    # host ids as a list or a CPU tensor give the same; bad ids raise
    for form in (ids.tolist(), torch.from_numpy(ids)):
        np.testing.assert_array_equal(
            TQ.lora_delta(_t(x), _t(A), _t(B), form).numpy(), got)
    for bad in ([0, 1, 4, 2, 1], [0, -1, 3, 2, 1], [0, 1]):
        with pytest.raises(ValueError):
            TQ.lora_delta(_t(x), _t(A), _t(B), bad)


def test_merge_lora_weight_and_lora_scope():
    rs = np.random.RandomState(3)
    w = rs.randn(16, 24).astype(np.float32)
    a, b = rs.randn(16, 4).astype(np.float32), rs.randn(4, 24).astype(
        np.float32)
    np.testing.assert_allclose(TQ.merge_lora_weight(_t(w), a, b).numpy(),
                               np.asarray(JQ.merge_lora_weight(w, a, b)),
                               rtol=TOL, atol=TOL)
    assert TQ.current_lora() is None
    with TQ.lora_scope([1], ["outer"]):
        with TQ.lora_scope([2], ["inner"]):
            assert TQ.current_lora() == ([2], ["inner"])
        assert TQ.current_lora() == ([1], ["outer"])
    assert TQ.current_lora() is None


def _stacks():
    from test_torch_serving import build_stacks

    return build_stacks()


def test_quantized_jax_state_dict_loads_into_quantized_port_stack():
    from paddle_tpu.core.tensor import to_tensor
    from paddle_tpu_torch.core.bucketing import pad_prompt_row

    (jdec, jemb, jproj), (tdec, temb, tproj) = _stacks()
    assert jquantize_net(jdec, jemb, jproj) == quantize_net(tdec, temb,
                                                            tproj) == 22
    for t, j in ((tdec, jdec), (temb, jemb), (tproj, jproj)):
        state = {k: np.asarray(v._data if hasattr(v, "_data") else v)
                 for k, v in j.state_dict().items()}
        assert any(v.dtype == np.int8 for v in state.values())
        conv = from_jax_state(state)
        assert {k: v.dtype for k, v in conv.items()} == \
            {k: v.dtype for k, v in t.state_dict().items()}
        t.load_state_dict(conv)
    assert tdec.layers[0].linear1.weight is None
    assert tdec.layers[0].linear1.param_dtype == torch.float32
    rs = np.random.RandomState(4)
    prompt = rs.randint(2, 97, (11,)).astype(np.int32)
    mem = rs.randn(1, 5, 64).astype(np.float32)
    row, P0, Pb = pad_prompt_row(prompt, 1)
    mask = np.where(np.tril(np.ones((Pb, Pb), bool)), 0.0, -1e30)
    mask = (mask + np.where(np.arange(Pb) >= P0, -1e30, 0.0)[None])
    mask = mask.astype(np.float32)[None, None]
    want = np.asarray(jproj(jdec(jemb(to_tensor(row)), to_tensor(mem),
                                 to_tensor(mask)))._data)
    with torch.inference_mode():
        got = tproj(tdec(temb(_t(row).long()), _t(mem), _t(mask))).numpy()
    np.testing.assert_allclose(got[0, :P0], want[0, :P0], rtol=1e-5,
                               atol=1e-5)


def test_adapter_pool_lifecycle_matches_jax():
    """One scripted sequence of acquires and releases on both pools:
    capacity 3 (the base row and two adapter rows) for three tenants, so
    the sequence loads, hits, evicts the LRU row and meets
    OutOfAdapters."""
    (jdec, _, _), (tdec, _, _) = _stacks()
    jp = JAdapterPool(jdec, capacity=3, rank=4)
    tp = AdapterPool(tdec, capacity=3, rank=4)
    for i, name in enumerate(("a", "b", "c")):
        jp.register_random(name, seed=100 + i)
        tp.register_random(name, seed=100 + i)
    script = [("acq", "a"), ("acq", "b"), ("can", "c"), ("acq", "c"),
              ("acq", "a"), ("rel", "a"), ("rel", "a"), ("can", "a"),
              ("acq", "a"), ("rel", "a"), ("acq", "c"), ("rel", "c"),
              ("rel", "b"), ("acq", None), ("acq", "b"), ("rel", "b")]
    rows = {"jax": {}, "port": {}}
    for pool, key, oom in ((jp, "jax", JOutOfAdapters),
                           (tp, "port", OutOfAdapters)):
        seen = []
        for op, name in script:
            if op == "acq":
                try:
                    row = pool.acquire(name)
                except oom:
                    row = "out"
                rows[key][name] = row
                seen.append(row)
            elif op == "rel":
                pool.release(rows[key][name])
            else:
                seen.append(pool.can_acquire(name))
        seen.append((pool.loads, pool.hits, pool.misses, pool.evictions,
                     pool.refcount.tolist(), pool.bytes(), pool.check()))
        rows[key]["seen"] = seen
    assert rows["port"]["seen"] == rows["jax"]["seen"]
    assert "out" in rows["port"]["seen"]
    for (ja, jb), (ta, tb) in zip(jp.banks(), tp.banks()):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for (ji, jw), (ti, tw) in zip(jp.merged_weights("a"),
                                  tp.merged_weights("a")):
        assert ji == ti
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL,
                                   atol=TOL)
    with pytest.raises(KeyError):
        tp.acquire("nope")
    for name in (None, "base"):
        with pytest.raises(ValueError):
            tp.register(name, [])
    with pytest.raises(ValueError):
        AdapterPool(tdec, capacity=1)
