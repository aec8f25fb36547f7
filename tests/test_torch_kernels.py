"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA card and skips without one; the
file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch for CUDA:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Shapes go beyond the serving and training paths' (ragged and odd
lengths, end-aligned causal with sq != sk, head dims 40 and 128, bf16,
attention dropout). Tolerances: fp32 rtol 1e-5 / atol 2e-5 (reordered
sums); bf16 rtol / atol 1e-2 (the two sides may round an output to
neighbouring bf16 values, 2^-7 apart at magnitude 1). The backward
kernels' fp32 gradients: rtol 1e-4 / atol 1e-4 (sums of up to sk
products of O(1) terms in another order); bf16 gradients: the largest
|kernel - plain| at most 1e-3 of the plain version's largest entry (both
round ds and p to bf16 at the same points and accumulate in float32, so
they differ only by the order of the float32 sums; a fault such as a
missing 1/keep factor moves the largest entries by several percent).
"""
import pytest
import torch

from paddle_tpu_torch.ops import attention as TA

TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)}
GRAD_TOL = {torch.float32: (1e-4, 1e-4)}
REL_BF16_GRAD = 1e-3     # of the plain gradient's largest entry


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _rand(shape, seed, dev, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


def _pad_bias(lens, sk, dev, neg=-1e30):
    kpos = torch.arange(sk)
    bias = torch.where(kpos[None] >= torch.tensor(lens)[:, None], neg, 0.0)
    return bias.float().contiguous().to(dev)


# b, h, sq, sk, d, causal, key lengths (None = no bias), dtype
_FWD = {
    "prefill_causal_bias": (2, 3, 200, 200, 64, True, [130, 200],
                            torch.float32),
    "end_aligned_sq_lt_sk": (1, 2, 77, 131, 32, True, [100],
                             torch.float32),
    "one_row_cross": (4, 2, 1, 300, 128, False, None, torch.float32),
    "d128_ragged": (2, 2, 130, 130, 128, True, [60, 130], torch.float32),
    "d40_pad_bias": (1, 2, 70, 70, 40, False, [50], torch.float32),
    "bf16": (2, 2, 200, 200, 64, True, [150, 200], torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_FWD))
def test_flash_fwd_kernel_matches_plain(cuda, case):
    b, h, sq, sk, d, causal, lens, dt = _FWD[case]
    q = _rand((b, sq, h, d), 1, cuda, dt).transpose(1, 2)   # strided
    k = _rand((b, h, sk, d), 2, cuda, dt)
    v = _rand((b, h, sk, d), 3, cuda, dt)
    bias = None if lens is None else _pad_bias(lens, sk, cuda)
    before = TA.LAUNCHES["flash_fwd"]
    out, lse = TA.flash_attention_fwd(q, k, v, bias, causal)
    assert TA.LAUNCHES["flash_fwd"] == before + 1
    want, want_lse = TA.flash_attention_fwd_plain(q, k, v, bias, causal)
    rtol, atol = TOL[dt]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=2e-5)


# b, h, L, d, lengths, dtype
_DEC = {
    "ragged_L": (3, 2, 300, 64, [1, 300, 129], torch.float32),
    "d128_short": (2, 2, 77, 128, [77, 3], torch.float32),
    "long_cache": (2, 4, 4100, 64, [4100, 2000], torch.float32),
    "bf16": (2, 2, 300, 64, [300, 10], torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_DEC))
def test_flash_decode_kernel_matches_plain(cuda, case):
    b, h, L, d, lens, dt = _DEC[case]
    q = _rand((b, h, 1, d), 4, cuda, dt)
    k = _rand((b, h, L, d), 5, cuda, dt)
    v = _rand((b, h, L, d), 6, cuda, dt)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    bias = torch.zeros(b, L, device=cuda)
    bias[:, 1:min(L, 40)] = -1e30            # a pad hole after key 0
    before = TA.LAUNCHES["flash_decode"]
    got = TA.flash_decode(q, k, v, length, bias)
    assert TA.LAUNCHES["flash_decode"] == before + 1
    want = TA.flash_decode_plain(q, k, v, length, bias)
    rtol, atol = TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda):
    """The serving layers' call: decode against a pool view, the flash
    forward with the pad hole, both at the reference's semantics."""
    pool = _rand((4, 2, 64, 32), 7, cuda)
    view = pool[1:2, :, :48]                  # a slot's rows, strided
    q = _rand((1, 2, 1, 32), 8, cuda)
    got = TA.decode_attention(q, view, view, torch.tensor([20], device=cuda))
    want = TA.decode_attention_reference(q, view, view, 20)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
    qq, kk = _rand((1, 2, 16, 32), 9, cuda), _rand((1, 2, 16, 32), 10, cuda)
    mask = _pad_bias([11], 16, cuda)[:, None, None, :]
    got = TA.sdpa(qq, kk, kk, mask, is_causal=True)
    want = TA.sdpa_reference(qq, kk, kk, mask, is_causal=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


def _rich_mask(b, s, dev):
    """Causal plus a pad hole as one [b, 1, s, s] float mask: it varies
    per query, so it does not reduce to a per-key bias."""
    causal = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), 0.0,
                         -1e30)
    return (causal[None, None] + _pad_bias([s - 3] * b, s, "cpu")
            [:, None, None, :]).to(dev)


def test_sdpa_refuses_a_per_query_mask_off_the_cpu():
    """Off the CPU a mask no kernel takes raises instead of running the
    plain composition (checked here on the meta device, which holds no
    data; the card case is below)."""
    q = torch.empty(2, 2, 16, 32, device="meta")
    before = dict(TA.LAUNCHES)
    with pytest.raises(NotImplementedError, match="per query"):
        TA.sdpa(q, q, q, _rich_mask(2, 16, "meta"))
    assert TA.LAUNCHES == before
    cpu = _rand((2, 2, 16, 32), 14, "cpu")
    got = TA.sdpa(cpu, cpu, cpu, _rich_mask(2, 16, "cpu"))
    want = TA.sdpa_reference(cpu, cpu, cpu, _rich_mask(2, 16, "cpu"))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sdpa_refuses_dropout_under_a_per_query_mask():
    """Attention dropout rides the flash kernels only: under a mask that
    no kernel takes, sdpa raises on the CPU too."""
    q = _rand((2, 2, 16, 32), 16, "cpu")
    before = dict(TA.LAUNCHES)
    with pytest.raises(NotImplementedError, match="dropout"):
        TA.sdpa(q, q, q, _rich_mask(2, 16, "cpu"), dropout_p=0.1,
                dropout_seed=3)
    assert TA.LAUNCHES == before


@pytest.mark.cuda
def test_sdpa_refuses_a_per_query_mask_on_card(cuda):
    q = _rand((2, 2, 16, 32), 15, cuda)
    before = dict(TA.LAUNCHES)
    with pytest.raises(NotImplementedError, match="per query"):
        TA.sdpa(q, q, q, _rich_mask(2, 16, cuda))
    assert TA.LAUNCHES == before


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = _rand((1, 2, 8, 32), 11, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TA.flash_attention_fwd(q.half(), q.half(), q.half())
    wide = _rand((1, 2, 8, 192), 12, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        TA.flash_attention_fwd(wide, wide, wide)
    strided = _rand((1, 2, 8, 64), 13, cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        TA.flash_attention_fwd(strided, strided, strided)
    with pytest.raises(ValueError, match="bias"):
        TA.flash_attention_fwd(q, q, q, torch.zeros(1, 8, device=cuda,
                                                   dtype=torch.float64))
    with pytest.raises(ValueError, match="on different devices"):
        TA.flash_attention_fwd(q, q.cpu(), q)


# b, h, sq, sk, d, causal, key lengths (None = no bias), dropout_p, dtype
_BWD = {
    "ernie_like_bias_dropout": (2, 3, 256, 256, 64, False, [256, 150],
                                0.1, torch.float32),
    "causal_bias_dropout": (1, 2, 200, 200, 64, True, [130], 0.1,
                            torch.float32),
    "end_aligned_sq_lt_sk": (1, 2, 77, 131, 32, True, None, 0.0,
                             torch.float32),
    "d128_ragged": (2, 2, 130, 130, 128, False, [60, 130], 0.2,
                    torch.float32),
    "bf16_bias_dropout": (2, 2, 192, 192, 64, False, [192, 100], 0.1,
                          torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_BWD))
def test_flash_backward_kernels_match_plain(cuda, case):
    b, h, sq, sk, d, causal, lens, p, dt = _BWD[case]
    q = _rand((b, sq, h, d), 21, cuda, dt).transpose(1, 2)    # strided
    k = _rand((b, sk, h, d), 22, cuda, dt).transpose(1, 2)
    v = _rand((b, h, sk, d), 23, cuda, dt)
    g = _rand((b, sq, h, d), 24, cuda, dt).transpose(1, 2)
    bias = None if lens is None else _pad_bias(lens, sk, cuda, -1e4)
    drop = TA.drop_spec(p, -7, sq, sk, 64, 32)
    out, lse = TA.flash_attention_fwd(q, k, v, bias, causal, None, drop)
    want_out, want_lse = TA.flash_attention_fwd_plain(q, k, v, bias, causal,
                                                      None, drop)
    rtol, atol = TOL[dt]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=2e-5)
    before = dict(TA.LAUNCHES)
    got = TA.flash_attention_bwd(q, k, v, bias, want_out, want_lse, g,
                                 causal, None, drop)
    assert TA.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert TA.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = TA.flash_attention_bwd_plain(q, k, v, bias, want_out, want_lse,
                                        g, causal, None, drop)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None
            continue
        if dt == torch.bfloat16:
            err = (a.float() - w.float()).abs().max().item()
            limit = REL_BF16_GRAD * w.float().abs().max().item()
            assert err <= limit, f"{name}: max_abs_err {err} > {limit}"
            continue
        rtol, atol = GRAD_TOL[dt]
        torch.testing.assert_close(a.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
def test_flash_attention_autograd_on_card_matches_cpu(cuda):
    """The autograd Function on the card against the same Function on
    the CPU (plain versions): outputs and every gradient, dropout on.
    The dropout bits are a hash, so both devices drop the same logits."""
    b, h, s, d = 2, 2, 160, 64
    lens = [160, 97]
    res = {}
    for dev in ("cpu", cuda):
        q, k, v, g = (_rand((b, h, s, d), 30 + i, dev).requires_grad_(i < 3)
                      for i in range(4))
        bias = _pad_bias(lens, s, dev, -1e4).requires_grad_()
        out = TA.flash_attention(q, k, v, bias, False, None, dropout_p=0.1,
                                 dropout_seed=123)
        (out * g).sum().backward()
        res[str(dev)] = [t.detach().cpu() for t in
                         (out, q.grad, k.grad, v.grad, bias.grad)]
    for a, w in zip(res[str(cuda)], res["cpu"]):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_card_paths_never_reach_a_plain_version(cuda, monkeypatch):
    """With every plain version (and torch's SDPA) made to raise, a bf16
    ERNIE train step with dropout and a decode step still run on the
    card: the wrappers launch the kernels and nothing else."""
    from paddle_tpu_torch.optimizer import functional as fopt
    from paddle_tpu_torch.parallel import SpmdTrainer
    from paddle_tpu_torch.text import (ErnieConfig,
                                       ErnieForSequenceClassification)

    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for name in ("flash_attention_fwd_plain", "flash_attention_bwd_plain",
                 "flash_decode_plain", "_decode_partials_plain",
                 "sdpa_reference", "dropout_keep_reference"):
        monkeypatch.setattr(TA, name, boom)
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        boom)
    model = ErnieForSequenceClassification(
        ErnieConfig.tiny(), device=cuda,
        generator=torch.Generator().manual_seed(0))
    tr = SpmdTrainer(model, lambda out, y: torch.nn.functional.cross_entropy(
        out.float(), y), fopt.adamw(1e-3), compute_dtype="bfloat16",
        device=cuda)
    ids = torch.randint(1, 1024, (2, 96), generator=torch.Generator()
                        .manual_seed(1))
    mask = torch.ones(2, 96)
    mask[1, 60:] = 0
    TA.reset_launches()
    loss = tr.step((ids, torch.zeros_like(ids), mask), torch.tensor([0, 1]))
    assert torch.isfinite(loss).item()
    assert TA.LAUNCHES["flash_fwd"] == 2          # one per layer
    assert TA.LAUNCHES["flash_bwd_dq"] == 2
    assert TA.LAUNCHES["flash_bwd_dkv"] == 2
    q = _rand((2, 2, 1, 32), 40, cuda)
    kv = _rand((2, 2, 80, 32), 41, cuda)
    TA.decode_attention(q, kv, kv, torch.tensor([80, 7], device=cuda))
    assert TA.LAUNCHES["flash_decode"] == 1
