"""The port's fused 1x1-conv + BatchNorm op against the JAX package's, on
the CPU.

The same numpy inputs (from a seed) go to the JAX op with
`interpret=True` (its Pallas kernels run on the CPU) and to the port's
`fused_scale_act_mm_stats`, whose autograd Function runs the kernels'
plain PyTorch versions on CPU tensors. Outputs, stats and the gradients
of x, scale, shift and w are compared with the stats cotangents in the
loss (the BN-chain path).

Tolerances: float32 as `tests/test_fused_conv.py` holds the JAX op to its
own reference: z rtol / atol 1e-5, the stats 1e-4 (sums over B * HW in
another order), gradients divided by the reference's largest entry
rtol 1e-5 / atol 2e-6. bf16 and mixed bf16 x / float32 w: every output
and gradient within 1e-2 of the JAX one's largest entry (z, xn, dz_eff
and dx are rounded to bf16, 2^-8 relative, and the two float32 sums
before each rounding come in another order, so a value may land on the
neighbouring bf16). The BN chain, two ops deep through `bn_scale_shift`:
gradients within 1e-5 of the largest entry (float32 sums divided by a
batch variance of about 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_conv as JFC
from paddle_tpu_torch.ops import fused_conv as TFC

torch.set_num_threads(2)


def _inputs(B, Ci, Co, HW, seed=0):
    rs = np.random.RandomState(seed)
    return dict(
        x=rs.randn(B, Ci, HW).astype("f4"),
        sc=(rs.rand(Ci) + 0.5).astype("f4"),
        sh=(rs.randn(Ci) * 0.1).astype("f4"),
        w=(rs.randn(Co, Ci) * 0.2).astype("f4"),
        gd=rs.randn(B, Co, HW).astype("f4"),
        cs=rs.randn(Co).astype("f4"),
        css=(rs.randn(Co) * 0.01).astype("f4"))


def _jax(a, relu, norm, xdt=jnp.float32, wdt=jnp.float32):
    def loss(x, sc, sh, w):
        z, s, ss = JFC.fused_scale_act_mm_stats(
            x, sc if norm else None, sh if norm else None, w, relu=relu,
            interpret=True)
        val = ((z.astype(jnp.float32) * a["gd"]).sum() + (s * a["cs"]).sum()
               + (ss * a["css"]).sum())
        return val, (z, s, ss)

    args = (jnp.asarray(a["x"], xdt), jnp.asarray(a["sc"]),
            jnp.asarray(a["sh"]), jnp.asarray(a["w"], wdt))
    (_, outs), grads = jax.value_and_grad(loss, (0, 1, 2, 3),
                                          has_aux=True)(*args)
    return [np.asarray(t.astype(jnp.float32)) for t in (*outs, *grads)]


def _port(a, relu, norm, xdt=torch.float32, wdt=torch.float32):
    x = torch.tensor(a["x"]).to(xdt).requires_grad_()
    sc = torch.tensor(a["sc"]).requires_grad_()
    sh = torch.tensor(a["sh"]).requires_grad_()
    w = torch.tensor(a["w"]).to(wdt).requires_grad_()
    z, s, ss = TFC.fused_scale_act_mm_stats(
        x, sc if norm else None, sh if norm else None, w, relu=relu)
    assert z.dtype == xdt and s.dtype == ss.dtype == torch.float32
    ((z.float() * torch.tensor(a["gd"])).sum() + (s * torch.tensor(
        a["cs"])).sum() + (ss * torch.tensor(a["css"])).sum()).backward()
    gsc = sc.grad if norm else torch.zeros_like(sc)
    gsh = sh.grad if norm else torch.zeros_like(sh)
    assert x.grad.dtype == xdt and w.grad.dtype == wdt
    return [t.detach().float().numpy()
            for t in (z, s, ss, x.grad, gsc, gsh, w.grad)]


_NAMES = ["z", "sum", "sumsq", "dx", "dscale", "dshift", "dw"]
_CASES = [(hw, relu, norm) for hw in (128, 200, 49) for relu in (True, False)
          for norm in (True, False)]


@pytest.mark.parametrize("hw,relu,norm", _CASES,
                         ids=[f"hw{h}-relu{int(r)}-norm{int(n)}"
                              for h, r, n in _CASES])
def test_fused_op_fp32_matches_jax_interpret(hw, relu, norm):
    """HW 128, 200 and 49 (no multiple of the kernels' 64-column tile but
    the first), ReLU on and off, with a norm and the identity: z, the
    stats and all four gradients."""
    a = _inputs(3, 16, 8, hw, seed=hw)
    want, got = _jax(a, relu, norm), _port(a, relu, norm)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for i in (1, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-4,
                                   err_msg=_NAMES[i])
    for i in range(3, 7):
        scale = float(np.abs(want[i]).max()) + 1e-6
        np.testing.assert_allclose(got[i] / scale, want[i] / scale,
                                   rtol=1e-5, atol=2e-6, err_msg=_NAMES[i])
    if not norm:
        assert not got[4].any() and not got[5].any()


@pytest.mark.parametrize("wdt", ["bfloat16", "float32"],
                         ids=["bf16", "mixed_bf16x_f32w"])
def test_fused_op_bf16_and_mixed_types_match_jax_interpret(wdt):
    a = _inputs(3, 16, 8, 200, seed=7)
    want = _jax(a, True, True, jnp.bfloat16, getattr(jnp, wdt))
    got = _port(a, True, True, torch.bfloat16, getattr(torch, wdt))
    for name, g, w in zip(_NAMES, got, want):
        err = np.abs(g - w).max()
        assert err <= 1e-2 * np.abs(w).max(), f"{name}: {err}"


@pytest.mark.parametrize("relu,norm", [(True, True), (False, False)])
def test_plain_backward_is_the_gradient_of_the_plain_forward(relu, norm):
    """In float32 (stored z = float32 z) the backward's formula equals
    torch autograd through `fused_fwd_reference`."""
    a = _inputs(2, 12, 5, 49, seed=3)

    def run(fn):
        ts = [torch.tensor(a[k]).requires_grad_() for k in
              ("x", "sc", "sh", "w")]
        sc, sh = (ts[1], ts[2]) if norm else (None, None)
        z, s, ss = fn(ts[0], sc, sh, ts[3], relu)
        ((z * torch.tensor(a["gd"])).sum() + (s * torch.tensor(a["cs"]))
         .sum() + (ss * torch.tensor(a["css"])).sum()).backward()
        return [t.grad for t in ts if t.grad is not None]

    for g, w in zip(run(TFC.fused_scale_act_mm_stats),
                    run(TFC.fused_fwd_reference)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_bn_scale_shift_matches_jax_with_gradients():
    rs = np.random.RandomState(2)
    x = rs.randn(4, 8, 64).astype("f4") * 2 + 0.5
    gamma = (rs.rand(8) + 0.5).astype("f4")
    beta = rs.randn(8).astype("f4")
    co = [rs.randn(8).astype("f4") for _ in range(4)]
    n = 4 * 64

    def jl(g, b, s, ss):
        outs = JFC.bn_scale_shift(g, b, s, ss, n, 1e-5)
        return sum((o * c).sum() for o, c in zip(outs, co)), outs

    jargs = [jnp.asarray(v) for v in (gamma, beta, x.sum((0, 2)),
                                      (x * x).sum((0, 2)))]
    (_, jouts), jgrads = jax.value_and_grad(jl, (0, 1, 2, 3),
                                            has_aux=True)(*jargs)
    targs = [torch.tensor(np.asarray(v)).requires_grad_() for v in jargs]
    touts = TFC.bn_scale_shift(*targs, n, 1e-5)
    sum((o * torch.tensor(c)).sum() for o, c in zip(touts, co)).backward()
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-6)
    for t, j in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("hw", [49, 200])
def test_two_op_bn_chain_gradients_match_jax(hw):
    """x -> fused(W1, identity) -> bn_scale_shift -> fused(W2, norm +
    ReLU) -> a loss over z and both stats: every gradient (x, W1, W2,
    gamma, beta) flows through the first op's stats."""
    B, C0, C1, C2 = 2, 12, 16, 8
    rs = np.random.RandomState(hw)
    x = rs.randn(B, C0, hw).astype("f4")
    w1 = (rs.randn(C1, C0) * 0.3).astype("f4")
    w2 = (rs.randn(C2, C1) * 0.3).astype("f4")
    g1 = (rs.rand(C1) + 0.5).astype("f4")
    b1 = (rs.randn(C1) * 0.1).astype("f4")
    gd = rs.randn(B, C2, hw).astype("f4")
    cs, css = rs.randn(C2).astype("f4"), rs.randn(C2).astype("f4") * 0.01
    n = B * hw

    def chain(fused, bnss, arr, x, w1, w2, g1, b1):
        z1, s1, ss1 = fused(x, None, None, w1, relu=False)
        sc, sh, _, _ = bnss(g1, b1, s1, ss1, n, 1e-5)
        z2, s2, ss2 = fused(z1, sc, sh, w2, relu=True)
        return ((z2 * arr(gd)).sum() + (s2 * arr(cs)).sum()
                + (ss2 * arr(css)).sum())

    jfused = lambda *a, relu: JFC.fused_scale_act_mm_stats(  # noqa: E731
        *a, relu=relu, interpret=True)
    args = (x, w1, w2, g1, b1)
    jgrads = jax.grad(
        lambda *a: chain(jfused, JFC.bn_scale_shift, jnp.asarray, *a),
        (0, 1, 2, 3, 4))(*[jnp.asarray(v) for v in args])
    ts = [torch.tensor(v).requires_grad_() for v in args]
    chain(TFC.fused_scale_act_mm_stats, TFC.bn_scale_shift, torch.tensor,
          *ts).backward()
    for name, t, j in zip(("x", "w1", "w2", "gamma", "beta"), ts, jgrads):
        scale = float(np.abs(np.asarray(j)).max())
        np.testing.assert_allclose(t.grad.numpy() / scale,
                                   np.asarray(j) / scale, rtol=0,
                                   atol=1e-5, err_msg=name)


def test_cpu_runs_the_plain_versions_and_the_op_checks_its_operands():
    a = _inputs(2, 8, 4, 49)
    x, sc, sh, w = (torch.tensor(a[k]) for k in ("x", "sc", "sh", "w"))
    before = dict(TFC.LAUNCHES)
    z, s, ss = TFC.fused_scale_act_mm_stats(x, sc, sh, w)
    assert TFC.LAUNCHES == before                 # no kernel on the CPU
    zr, sr, ssr = TFC.fused_fwd_reference(x, sc, sh, w)
    assert torch.equal(z, zr) and torch.equal(s, sr) and torch.equal(ss, ssr)
    with pytest.raises(ValueError, match="not \\[Co, 8\\]"):
        TFC.fused_scale_act_mm_stats(x, sc, sh, w.t())
    with pytest.raises(ValueError, match="together"):
        TFC.fused_scale_act_mm_stats(x, sc, None, w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TFC.fused_scale_act_mm_stats(x.double(), sc, sh, w)
