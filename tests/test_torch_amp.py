"""The port's mixed precision (`paddle_tpu_torch.amp`) against the JAX
package's `amp`, on the CPU.

The policy is the JAX package's: white-list ops cast their float inputs
to the amp dtype, black-list ops to float32, O2 casts every op but the
black list's, "O0" with `enable=True` behaves as O1 (the JAX code checks
only for O2), custom lists move ops between the lists.

  * Each op of the two lists, `*` and `@`, and three unlisted ops under
    `enable=False`, O0, O1, O2 and custom lists, with bfloat16 and
    float16: the output dtype equals the JAX op's; the values agree
    within one ulp of the output type at its largest entry (bf16 2^-8,
    f16 2^-11 of the binade: the same rounded inputs, products summed in
    another order) plus 1e-5 relative for float32 outputs.
  * O2's cast quirk: `.astype("float32")`, `cast`, `.float()` and
    `.to(torch.float32)` give float32 tensors holding amp-dtype values,
    exactly the JAX values.
  * The cast mask: under "sdpa" a float mask is cast with q, k and v, so
    the kernel's float32 key bias carries the rounded values (-10000 is
    -9984 in bf16); the output equals the plain call on the rounded mask
    bit for bit, and the JAX output within the ulp limit.
  * A 2-layer ERNIE eager step under `auto_cast` + `GradScaler` against
    JAX (limits in `test_ernie_amp_step_matches_jax`).
  * A scripted GradScaler sequence with injected infs: the scale, the
    good / bad counters, the skipped steps and the unscaled gradients
    equal the JAX scaler's exactly (bitwise).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as JA
from paddle_tpu.text import ErnieConfig as JaxConfig
from paddle_tpu.text import ErnieForSequenceClassification as JaxErnie
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp as TA
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.text import (ErnieConfig,
                                   ErnieForSequenceClassification)

NPDT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
        "float32": torch.float32}
#: mantissa bits of each output type (the ulp of x is 2^(e - bits))
BITS = {"bfloat16": 8, "float16": 11, "float32": 24}


def _rs(seed=0):
    return np.random.RandomState(seed)


def _f(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _inputs(name):
    """(float arrays, other arrays) of one op's case, from a seed."""
    rs = _rs(sum(map(ord, name)))
    if name in ("matmul", "@"):
        return [_f(rs, 4, 8), _f(rs, 8, 6)], []
    if name in ("*", "+", "relu", "softmax", "log_softmax", "logsumexp",
                "reduce_sum", "reduce_mean", "norm"):
        return [_f(rs, 4, 8)] + ([_f(rs, 4, 8)] if name in "*+" else []), []
    if name == "linear":
        return [_f(rs, 4, 8), _f(rs, 8, 6), _f(rs, 6)], []
    if name == "conv2d":
        return [_f(rs, 2, 3, 6, 6), _f(rs, 4, 3, 3, 3)], []
    if name == "conv1d":
        return [_f(rs, 2, 3, 8), _f(rs, 4, 3, 3)], []
    if name == "bmm":
        return [_f(rs, 2, 4, 8), _f(rs, 2, 8, 5)], []
    if name == "einsum":
        return [_f(rs, 4, 8), _f(rs, 8, 6)], []
    if name == "sdpa":
        mask = np.zeros((2, 1, 1, 8), np.float32)
        mask[1, ..., 5:] = -10000.0
        mask[0, ..., :3] = 0.1234567
        return [_f(rs, 2, 2, 8, 16), _f(rs, 2, 2, 8, 16),
                _f(rs, 2, 2, 8, 16), mask], []
    if name in ("cross_entropy", "softmax_with_cross_entropy"):
        return [_f(rs, 6, 5)], [rs.randint(0, 5, (6,)).astype(np.int64)]
    if name == "layer_norm":
        return [_f(rs, 4, 8), 1 + _f(rs, 8, scale=0.1), _f(rs, 8)], []
    if name == "batch_norm":
        return [_f(rs, 4, 3, 2, 2), np.zeros(3, np.float32),
                np.ones(3, np.float32), 1 + _f(rs, 3, scale=0.1),
                _f(rs, 3)], []
    if name == "bce_logits":
        return [_f(rs, 4, 5), (rs.rand(4, 5) > 0.5).astype(np.float32)], []
    if name == "bce_loss":
        p = 1 / (1 + np.exp(-_f(rs, 4, 5)))
        return [p.astype(np.float32),
                (rs.rand(4, 5) > 0.5).astype(np.float32)], []
    raise KeyError(name)


def _call(pkg, name, xs, other):
    """The op `name` of package `pkg` ("jax" or "port") on its tensors."""
    F = JF if pkg == "jax" else TF
    P = jp if pkg == "jax" else tp
    if name == "matmul":
        return P.matmul(*xs)
    if name == "@":
        return xs[0] @ xs[1]
    if name == "*":
        return xs[0] * xs[1]
    if name == "+":
        return xs[0] + xs[1]
    if name == "relu":
        return F.relu(xs[0])
    if name == "softmax":
        return F.softmax(xs[0])
    if name == "log_softmax":
        return F.log_softmax(xs[0])
    if name == "logsumexp":
        return P.logsumexp(xs[0], axis=-1)
    if name == "reduce_sum":
        return P.sum(xs[0])
    if name == "reduce_mean":
        return P.mean(xs[0])
    if name == "norm":
        return P.norm(xs[0])
    if name == "linear":
        return F.linear(*xs)
    if name == "conv2d":
        return F.conv2d(xs[0], xs[1], padding=1)
    if name == "conv1d":
        # the JAX conv1d refuses an int padding: "SAME" in both
        return F.conv1d(xs[0], xs[1], None, 1, "SAME")
    if name == "bmm":
        return P.bmm(*xs)
    if name == "einsum":
        return P.einsum("ij,jk->ik", *xs)
    if name == "sdpa":
        return F.scaled_dot_product_attention(*xs, training=False)
    if name == "cross_entropy":
        return F.cross_entropy(xs[0], other[0])
    if name == "softmax_with_cross_entropy":
        lab = other[0].reshape([6, 1]) if pkg == "jax" else other[0][:, None]
        return F.softmax_with_cross_entropy(xs[0], lab)
    if name == "layer_norm":
        return F.layer_norm(xs[0], [8], xs[1], xs[2])
    if name == "batch_norm":
        return F.batch_norm(xs[0], xs[1], xs[2], xs[3], xs[4], training=True)
    if name == "bce_logits":
        return F.binary_cross_entropy_with_logits(*xs)
    if name == "bce_loss":
        return F.binary_cross_entropy(*xs)
    raise KeyError(name)


WHITE = ("matmul", "@", "*", "linear", "conv2d", "conv1d", "bmm", "einsum",
         "sdpa")
BLACK = ("cross_entropy", "softmax_with_cross_entropy", "reduce_mean",
         "reduce_sum", "layer_norm", "batch_norm", "log_softmax", "norm",
         "logsumexp", "bce_logits", "bce_loss")
UNLISTED = ("+", "relu", "softmax")
#: (enable, level, custom_white_list, custom_black_list) of each policy
POLICIES = {
    "off": (False, "O1", None, None),
    "O0": (True, "O0", None, None),
    "O1": (True, "O1", None, None),
    "O2": (True, "O2", None, None),
    "custom": (True, "O1", {"layer_norm", "add"}, {"matmul", "mul"}),
}


def _jax_dtype(t):
    return np.dtype(t._data.dtype).name


def _port_dtype(t):
    return str(t.dtype).replace("torch.", "")


def _run(name, policy, amp_dtype):
    """(JAX output, its dtype name, port output, its dtype name). Black
    ops get amp-dtype inputs (so that their float32 cast shows), the
    others float32 ones."""
    xs, other = _inputs(name)
    enable, level, cw, cb = POLICIES[policy]
    in_dt = amp_dtype if name in BLACK else "float32"
    jxs = [jp.to_tensor(x).astype(in_dt) for x in xs]
    jother = [jp.to_tensor(o) for o in other]
    txs = [torch.from_numpy(x).to(NPDT[in_dt]) for x in xs]
    tother = [torch.from_numpy(o) for o in other]
    kw = dict(enable=enable, level=level, custom_white_list=cw,
              custom_black_list=cb, dtype=amp_dtype)
    with JA.auto_cast(**kw):
        jout = _call("jax", name, jxs, jother)
    with TA.auto_cast(**kw):
        tout = _call("port", name, txs, tother)
    return jout, _jax_dtype(jout), tout, _port_dtype(tout)


def _close(got, want, dtype):
    """Within one ulp of `dtype` at the largest |want| (plus float32's
    reordering, 1e-5 relative, for float32 outputs)."""
    w = np.asarray(want, np.float64)
    a = np.asarray(got, np.float64)
    top = float(np.abs(w).max()) if w.size else 0.0
    ulp = 2.0 ** (np.frexp(top)[1] - BITS[dtype]) if top > 0 else 0.0
    limit = ulp + (1e-5 * top if dtype == "float32" else 0.0)
    err = float(np.abs(a - w).max()) if w.size else 0.0
    assert err <= limit, f"{err} > {limit} ({dtype})"


def _np(t, jax):
    return np.asarray(t._data, np.float32) if jax else \
        t.detach().float().numpy()


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", WHITE + BLACK + UNLISTED)
def test_op_dtype_and_values_match_jax(name, policy, amp_dtype):
    jout, jdt, tout, tdt = _run(name, policy, amp_dtype)
    assert tdt == jdt, (name, policy, tdt, jdt)
    _close(_np(tout, False), _np(jout, True), tdt)


def test_policy_table_matches_jax():
    assert TA.WHITE_LIST == JA.WHITE_LIST
    assert TA.BLACK_LIST == JA.BLACK_LIST
    # the expected dtypes of the main cases, as a readable table
    for name, policy, want in (("matmul", "O1", "bfloat16"),
                               ("layer_norm", "O1", "float32"),
                               ("+", "O1", "float32"),
                               ("+", "O2", "bfloat16"),
                               ("matmul", "custom", "float32"),
                               ("layer_norm", "custom", "bfloat16"),
                               ("matmul", "off", "float32"),
                               ("matmul", "O0", "bfloat16")):
        assert _run(name, policy, "bfloat16")[3] == want, (name, policy)


def test_o2_cast_returns_amp_values_in_float32():
    x = _f(_rs(3), 5, 7) * 3.0
    with JA.auto_cast(level="O2"):
        jout = jp.to_tensor(x).astype("float32")
    want = np.asarray(jout._data)
    assert want.dtype == np.float32
    rounded = torch.from_numpy(x).bfloat16().float().numpy()
    np.testing.assert_array_equal(want, rounded)
    assert not np.array_equal(rounded, x)
    t = torch.from_numpy(x)
    with TA.auto_cast(level="O2"):
        outs = [tp.cast(t, "float32"), t.float(), t.to(torch.float32),
                t.type(torch.float32)]
        kept = t.to("cpu")              # no dtype: not a cast
    for o in outs:
        assert o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), want)
    assert torch.equal(kept, t)
    with TA.auto_cast(level="O1"):      # O1 does not cast "cast"
        np.testing.assert_array_equal(t.float().numpy(), x)


def test_sdpa_casts_the_float_mask_with_qkv():
    xs, _ = _inputs("sdpa")
    q, k, v, mask = (torch.from_numpy(x) for x in xs)
    with TA.auto_cast():
        got = TF.scaled_dot_product_attention(q, k, v, mask, training=False)
    bq, bk, bv, bm = (t.bfloat16() for t in (q, k, v, mask))
    assert float(bm.min()) == -9984.0
    bias = A._kv_bias(bm, 2, 8)
    assert bias.dtype == torch.float32 and float(bias.min()) == -9984.0
    assert torch.equal(got, TF.scaled_dot_product_attention(
        bq, bk, bv, bm, training=False))
    unrounded = TF.scaled_dot_product_attention(bq, bk, bv, mask,
                                                training=False)
    assert not torch.equal(got, unrounded)
    jout, jdt, _, tdt = _run("sdpa", "O1", "bfloat16")
    assert tdt == jdt == "bfloat16"
    _close(got.float().numpy(), _np(jout, True), "bfloat16")


def test_policy_stays_out_of_function_bodies_and_backward():
    """layer_norm's body runs in float32 under O1 (its inputs are cast
    on entry, nothing inside is); a backward pass inside auto_cast sees
    no casts; the mode leaves with the block."""
    x = torch.from_numpy(_f(_rs(4), 4, 8)).requires_grad_()
    w = torch.from_numpy(_f(_rs(5), 8, 8)).requires_grad_()
    with TA.auto_cast():
        y = TF.layer_norm(x @ w, [8])
        assert (x @ w).dtype == torch.bfloat16 and y.dtype == torch.float32
        y.sum().backward()
        assert x.grad.dtype == torch.float32 and w.grad.dtype == \
            torch.float32
        with TA.auto_cast(enable=False):
            assert (x @ w).dtype == torch.float32
        assert (x @ w).dtype == torch.bfloat16
    assert (x @ w).dtype == torch.float32
    assert TA._ACTIVE == 0
    assert not any(type(m).__name__ == "_AmpMode" for m in
                   torch.overrides._get_current_function_mode_stack())


def test_decorate_o2_and_refusals():
    net = tp.nn.Linear(4, 3, device="cpu")
    out = TA.decorate(net, level="O2")
    assert out is net and net.weight.dtype == torch.bfloat16
    opt = object()
    assert TA.decorate(net, opt, level="O1") == (net, opt)
    for kw in (dict(master_weight=True), dict(save_dtype="float32")):
        with pytest.raises(NotImplementedError, match="reference"):
            TA.decorate(net, **kw)
    with pytest.raises(NotImplementedError, match="auto_cast"):
        tp.Model(net).prepare(amp_configs={"level": "O1"})


# ----------------------------------------------------------------------
# the GradScaler's state machine
# ----------------------------------------------------------------------

SCRIPT = (False, False, True, False, True, True, False, False, False, True,
          False)


def test_grad_scaler_sequence_matches_jax_bitwise():
    """A scripted sequence of steps, some with an inf (or NaN) injected
    into one gradient: after each step the scale, the good and bad
    counters and found_inf equal the JAX scaler's, a skipped step leaves
    the parameters bitwise unchanged, and every unscaled gradient equals
    the JAX one bit for bit."""
    rs = _rs(11)
    shapes = [(3, 4), (4,), (5, 2)]
    init = [_f(rs, *s) for s in shapes]
    kw = dict(init_loss_scaling=2.0 ** 10, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=2)
    jps = [jp.to_tensor(x, stop_gradient=False) for x in init]
    tps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    jopt = jp.optimizer.SGD(0.25, parameters=jps)
    topt = tp.optimizer.SGD(0.25, parameters=tps)
    jsc, tsc = JA.GradScaler(**kw), TA.GradScaler(**kw)
    skipped = 0
    for step, bad in enumerate(SCRIPT):
        grads = [_f(rs, *s, scale=1e3) for s in shapes]
        if bad:
            g = grads[step % 3]
            g.flat[step % g.size] = np.inf if step % 2 else np.nan
        for p, g in zip(jps, grads):
            p.grad = jp.to_tensor(g)
        for p, g in zip(tps, grads):
            p.grad = torch.from_numpy(g.copy())
        before = [p.detach().clone() for p in tps]
        jsc.unscale_(jopt)
        tsc.unscale_(topt)
        for jq, tq in zip(jps, tps):
            np.testing.assert_array_equal(tq.grad.numpy(),
                                          np.asarray(jq.grad._data))
        assert tsc._found_inf == jsc._found_inf == bad
        # step() unscales again, as the JAX scaler's does: restore the
        # scaled gradients first
        for p, g in zip(jps, grads):
            p.grad = jp.to_tensor(g)
        for p, g in zip(tps, grads):
            p.grad = torch.from_numpy(g.copy())
        jsc.step(jopt)
        tsc.step(topt)
        assert tsc.state_dict() == jsc.state_dict(), step
        assert tsc.get_loss_scaling() == jsc.get_loss_scaling()
        for jq, tq, b in zip(jps, tps, before):
            np.testing.assert_array_equal(tq.detach().numpy(),
                                          np.asarray(jq._data))
            assert torch.equal(tq.detach(), b) == bad
        skipped += bad
    assert skipped == sum(SCRIPT)
    # the rule over the script: +2 finite steps double, 2 bad ones halve
    assert tsc.get_loss_scaling() == 2.0 ** 10 * 2 ** 2 / 2
    sd = tsc.state_dict()
    fresh = TA.GradScaler()
    fresh.set_state_dict(sd)
    assert fresh.state_dict() == sd


def test_grad_scaler_scale_minimize_and_disabled():
    x = torch.tensor([1.5, -2.0], requires_grad=True)
    sc = TA.GradScaler(init_loss_scaling=8.0)
    loss = (x * x).sum()
    assert float(sc.scale(loss).detach()) == 8.0 * float(loss.detach())
    opt = tp.optimizer.SGD(0.5, parameters=[x])
    sc.minimize(opt, sc.scale(loss))
    np.testing.assert_array_equal(x.detach().numpy(),
                                  np.float32([1.5, -2.0]) * 0.0)
    off = TA.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    assert off.get_loss_scaling() == 1.0


# ----------------------------------------------------------------------
# a 2-layer ERNIE eager step under auto_cast + GradScaler
# ----------------------------------------------------------------------

NO_DROPOUT = dict(hidden_dropout=0.0, attn_dropout=0.0)
#: per amp dtype: loss relative error, logits error in ulps of the type at
#: the largest logit, gradient relative L2 error per parameter (plus a
#: share of the largest gradient norm), parameter error after one SGD
#: step. The two packages round the same inputs to the amp dtype; each
#: 16-bit product sums in another order, and the backward rounds its
#: 16-bit cotangents too, so the gradients move by a few 16-bit ulps per
#: layer (read: loss 5.8e-4 / 5.9e-5, logits 1 / 2 ulps, median gradient
#: 1.5e-2 / 2.0e-3, parameters 2.9e-4 / 4.9e-5 for bf16 / f16).
ERNIE_LIMITS = {"bfloat16": (2e-3, 2, 6e-2, 1e-3),
                "float16": (2e-4, 4, 1e-2, 2e-4)}


def _ernie_step(pkg, model, batch, amp_dtype):
    """(loss, logits, logits dtype, unscaled gradients, parameters after
    the step, the scaler's state) of one step in package `pkg`."""
    ids, tt, mask, labels = batch
    jax = pkg == "jax"
    P, F, AMP = (jp, JF, JA) if jax else (tp, TF, TA)
    opt = P.optimizer.SGD(0.1, parameters=model.parameters())
    sc = AMP.GradScaler(init_loss_scaling=2.0 ** 10)
    if jax:
        ins = [jp.to_tensor(a) for a in (ids, tt, mask, labels)]
    else:
        model.train()
        ins = [torch.from_numpy(a) for a in (ids, tt, mask, labels)]
    with AMP.auto_cast(dtype=amp_dtype):
        logits = model(*ins[:3])
        loss = F.cross_entropy(logits, ins[3])
    sc.scale(loss).backward()
    sc.step(opt)                     # unscales the gradients in place
    named = list(model.named_parameters())
    grads = {n: _np(p.grad, jax) for n, p in named}
    params = {n: _np(p, jax) for n, p in named}
    return (float(loss if jax else loss.detach()), _np(logits, jax),
            _jax_dtype(logits) if jax else _port_dtype(logits), grads,
            params, sc.state_dict())


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
def test_ernie_amp_step_matches_jax(amp_dtype):
    """ErnieConfig.tiny (2 layers, hidden 64) at dropout 0, the JAX
    weights loaded into the port, one O1 step with a GradScaler and SGD:
    the loss, logits, every gradient, the parameters after the step and
    the scaler's state against JAX's within ERNIE_LIMITS."""
    jp.seed(0)
    jm = JaxErnie(JaxConfig.tiny(**NO_DROPOUT))
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = ErnieForSequenceClassification(ErnieConfig.tiny(**NO_DROPOUT),
                                        device="cpu")
    tm.load_state_dict(convert.from_jax_state(sd), strict=True)
    rs = _rs(0)
    ids = rs.randint(1, 1024, (3, 48)).astype(np.int64)
    mask = np.ones((3, 48), np.float32)
    mask[1, 30:] = 0.0
    mask[2, 10:] = 0.0
    batch = (ids, np.zeros_like(ids), mask,
             rs.randint(0, 2, (3,)).astype(np.int64))
    jl, jlog, jdt, jg, jpar, jst = _ernie_step("jax", jm, batch, amp_dtype)
    tl, tlog, tdt, tg, tpar, tst = _ernie_step("port", tm, batch, amp_dtype)
    loss_rel, logit_ulps, grad_l2, par_atol = ERNIE_LIMITS[amp_dtype]
    assert tdt == jdt == amp_dtype
    assert tst == jst and not any(np.isinf(list(jst.values())))
    assert abs(tl - jl) <= loss_rel * abs(jl)
    top = float(np.abs(jlog).max())
    ulp = 2.0 ** (np.frexp(top)[1] - BITS[amp_dtype])
    assert float(np.abs(tlog - jlog).max()) <= logit_ulps * ulp
    gmax = max(np.linalg.norm(g) for g in jg.values())
    assert set(tg) == set(jg)
    for n in jg:
        err = np.linalg.norm(tg[n] - jg[n])
        # k_proj's bias gets a zero gradient in exact arithmetic (softmax
        # ignores a shift its row shares): rounding noise, held by the
        # second term
        assert err <= grad_l2 * np.linalg.norm(jg[n]) + 1e-3 * gmax, n
        np.testing.assert_allclose(tpar[n], jpar[n], rtol=0, atol=par_atol,
                                   err_msg=n)
