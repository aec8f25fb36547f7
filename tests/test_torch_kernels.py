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
The int8 matmul and gathered-LoRA kernels: the largest |kernel - plain|
at most 1e-5 of the plain version's largest entry in float32 (sums of up
to d products in another order) and 1e-2 of it for a bf16 x (the result
is rounded to bf16, 2^-8 relative). The fused 1x1-conv + BN kernels: in
float32 z and dx within 1e-5 of the plain version's largest entry (sums
of up to Ci or Co products), the stats, dW, dscale and dshift within 1e-4
(sums over B * HW positions, partials added in another order), in the
bf16 cases too, since those outputs are float32; a bf16 z or dx within
one bf16 ulp of each element, at most 1% of them differing (both sides
round float32 sums of the same bf16-rounded activation and dz_eff, so
only a sum within its reordering error of a rounding midpoint may land
on the neighbouring bf16; a kernel that skipped that rounding would
move a large share of the elements).
"""
import pytest
import torch

from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops import fused_conv as TFC
from paddle_tpu_torch.ops import quant as TQ

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


# b, h, T, L, d, lengths after the write, dtype
_VER = {
    "spec_T4_ragged": (8, 8, 4, 1060, 64, [4, 1060, 700, 300, 129, 128,
                                            1000, 513], torch.float32),
    "spec_T4_bf16": (4, 2, 4, 300, 64, [300, 10, 4, 133], torch.bfloat16),
    "one_token": (3, 2, 1, 200, 64, [1, 200, 129], torch.float32),
    "T9_d128": (2, 2, 9, 390, 128, [390, 20], torch.float32),
    "T256_d40": (1, 2, 256, 600, 40, [555], torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_VER))
def test_flash_verify_kernel_matches_plain(cuda, case):
    b, h, T, L, d, lens, dt = _VER[case]
    q = _rand((b, T, h, d), 50, cuda, dt).transpose(1, 2)   # strided
    k = _rand((b, h, L, d), 51, cuda, dt)
    v = _rand((b, h, L, d), 52, cuda, dt)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    bias = torch.zeros(b, L, device=cuda)
    bias[:, 1:min(L, 40)] = -1e30            # a pad hole after key 0
    before = TA.LAUNCHES["flash_verify"]
    got = TA.flash_verify(q, k, v, length, bias)
    assert TA.LAUNCHES["flash_verify"] == before + 1
    want = TA.flash_verify_plain(q, k, v, length, bias)
    rtol, atol = TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    ref = TA.verify_attention_reference(q, k, v, length, bias)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


def _paged_case(S, h, psz, mp, d, T, lens, q_dt, kv_dt, dev, seed=60):
    """Pages with a shuffled table: every slot maps pages from one
    permutation of the pool; some entries point at the trash row (N) or
    are unmapped (-1), past each slot's written length."""
    N = S * mp + 3
    g = torch.Generator().manual_seed(seed)
    table = torch.randperm(N, generator=g)[:S * mp].reshape(S, mp) \
        .to(torch.int32)
    for s, n in enumerate(lens):
        first_dead = -(-n // psz)
        if first_dead < mp:
            table[s, first_dead:] = -1 if s % 2 else N
    raw = [torch.randn(N + 1, h, psz, d, generator=g) for _ in range(2)]
    scales = [None, None]
    if kv_dt == torch.int8:
        for i, x in enumerate(raw):
            sc = x.abs().amax((2, 3), keepdim=True) / 127.0
            raw[i] = torch.round(x / sc).clamp(-127, 127)
            scales[i] = sc.to(dev).contiguous()
    kp, vp = (x.to(kv_dt).to(dev) for x in raw)
    q = torch.randn(S, T, h, d, generator=g).to(q_dt).to(dev).transpose(1, 2)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    bias = (torch.randn(S, mp * psz, generator=g) * 0.1).to(dev)
    bias[:, 3:9] = -1e30
    return q, kp, vp, scales[0], scales[1], table.to(dev), length, bias


# S, h, psz, mp, d, T, lengths after the write, q dtype, page dtype
_PAGED = {
    "decode_f32": (8, 8, 16, 67, 64, 1, [1, 1072, 700, 300, 129, 128, 1000,
                                         513], torch.float32, torch.float32),
    "decode_int8": (4, 2, 16, 9, 64, 1, [5, 144, 17, 100], torch.float32,
                    torch.int8),
    "decode_bf16_pages": (4, 2, 16, 9, 64, 1, [5, 144, 17, 100],
                          torch.float32, torch.bfloat16),
    "decode_bf16_q_d128": (2, 2, 8, 30, 128, 1, [240, 31], torch.bfloat16,
                           torch.bfloat16),
    "verify_T4_f32": (8, 8, 16, 67, 64, 4, [4, 1072, 700, 300, 129, 128,
                                            1000, 513], torch.float32,
                      torch.float32),
    "verify_T4_int8": (4, 2, 16, 9, 64, 4, [5, 144, 17, 100], torch.float32,
                       torch.int8),
    "verify_T256_f32": (2, 8, 16, 67, 64, 256, [1000, 300], torch.float32,
                        torch.float32),
    "verify_T7_bf16_q": (3, 2, 16, 12, 40, 7, [7, 192, 60], torch.bfloat16,
                         torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_PAGED))
def test_paged_kernels_match_plain(cuda, case):
    S, h, psz, mp, d, T, lens, q_dt, kv_dt = _PAGED[case]
    args = _paged_case(S, h, psz, mp, d, T, lens, q_dt, kv_dt, cuda)
    name = "paged_flash_decode" if T == 1 else "paged_flash_verify"
    before = TA.LAUNCHES[name]
    got = getattr(TA, name)(*args)
    assert TA.LAUNCHES[name] == before + 1
    want = getattr(TA, name + "_plain")(*args)
    rtol, atol = TOL[q_dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    # the dispatcher on the card is the kernel; the gather + dense plain
    # path (the CPU dispatch) agrees within the same limits
    q, kp, vp, ks, vs, table, length, bias = args
    kd = TA.paged_gather_kv(kp, ks, table, torch.float32)
    vd = TA.paged_gather_kv(vp, vs, table, torch.float32)
    ref = TA.verify_attention_reference(q.float(), kd, vd, length, bias)
    torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=atol)


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
                 "flash_verify_plain", "_verify_partials_plain",
                 "paged_flash_decode_plain", "paged_flash_verify_plain",
                 "_paged_partials_plain", "paged_gather_kv",
                 "sdpa_reference", "dropout_keep_reference",
                 "verify_attention_reference"):
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
    length = torch.tensor([80, 7], dtype=torch.int32, device=cuda)
    TA.verify_attention(_rand((2, 2, 3, 32), 42, cuda), kv, kv, length)
    assert TA.LAUNCHES["flash_verify"] == 1
    for T, name in ((1, "paged_flash_decode"), (3, "paged_flash_verify")):
        q, kp, vp, ks, vs, table, length, bias = _paged_case(
            2, 2, 16, 5, 32, T, [70, 9], torch.float32, torch.int8, cuda)
        fn = (TA.paged_decode_attention if T == 1 else
              TA.paged_verify_attention)
        fn(q, kp, vp, ks, vs, table, length, bias[:, None, None, :])
        assert TA.LAUNCHES[name] == 1


# m, d, n, x dtype: decode and verify steps (the skinny path, m <= 32,
# d split across blocks where n gives few column strips), the vocabulary
# projection (n = 37000, rows 8- but not 16-byte aligned), prefill tiles
# with ragged edges on every side
_I8 = {
    "decode_m8_512x2048": (8, 512, 2048, torch.float32),
    "decode_m8_2048x512_split_d": (8, 2048, 512, torch.float32),
    "m1_ragged_n37": (1, 100, 37, torch.float32),
    "m17_odd_n1001": (17, 300, 1001, torch.float32),
    "verify_m32_vocab": (32, 512, 37000, torch.float32),
    "m33_tiled_edges": (33, 70, 130, torch.float32),
    "prefill_m1024_2048x512": (1024, 2048, 512, torch.float32),
    "d3_tiny_depth": (40, 3, 65, torch.float32),
    "bf16_m8": (8, 512, 512, torch.bfloat16),
    "bf16_m200": (200, 512, 512, torch.bfloat16),
}
REL_QUANT = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel_close(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    limit = rel * want.float().abs().max().item()
    assert err <= limit, f"max |kernel - plain| {err} > {limit}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_I8))
def test_int8_matmul_kernel_matches_plain(cuda, case):
    m, d, n, dt = _I8[case]
    x = _rand((m, d), 50, cuda, dt)
    q, scale = TQ.quantize_int8_weight(_rand((d, n), 51, cuda) * 0.05)
    bias = _rand((n,), 52, cuda)
    before = TQ.LAUNCHES["int8_matmul"]
    got = TQ.int8_matmul(x, q, scale, bias)
    assert TQ.LAUNCHES["int8_matmul"] == before + 1
    assert got.dtype == dt and got.shape == (m, n)
    _rel_close(got, TQ.int8_matmul_reference(x, q, scale, bias),
               REL_QUANT[dt])


# b, s, d, r, n, capacity, ids, x dtype
_LORA = {
    "decode_b8_s1": (8, 1, 512, 8, 2048, 5, [0, 1, 2, 3, 4, 0, 2, 4],
                     torch.float32),
    "verify_b8_s4": (8, 4, 2048, 8, 512, 5, [4, 3, 2, 1, 0, 1, 0, 3],
                     torch.float32),
    "prefill_b1_s1024": (1, 1024, 512, 8, 2048, 5, [3], torch.float32),
    "rank32_ragged": (3, 37, 100, 32, 300, 4, [1, 0, 3], torch.float32),
    "rank1": (2, 5, 64, 1, 33, 2, [1, 1], torch.float32),
    "bf16_b8_s4": (8, 4, 512, 8, 512, 5, [0, 1, 2, 3, 4, 4, 3, 2],
                   torch.bfloat16),
}


def _banks(cap, d, r, n, dev):
    A = _rand((cap, d, r), 60, dev) * 0.05
    B = _rand((cap, r, n), 61, dev) * 0.05
    A[0] = 0.0
    B[0] = 0.0
    return A, B


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_LORA))
def test_lora_gather_kernel_matches_plain(cuda, case):
    b, s, d, r, n, cap, ids, dt = _LORA[case]
    x = _rand((b, s, d), 62, cuda, dt)
    A, B = _banks(cap, d, r, n, cuda)
    before = TQ.LAUNCHES["lora_gather"]
    got = TQ.lora_delta(x, A, B, ids)
    assert TQ.LAUNCHES["lora_gather"] == before + 1
    assert got.dtype == dt and got.shape == (b, s, n)
    _rel_close(got, TQ.lora_delta_reference(x, A, B, ids), REL_QUANT[dt])
    for i, row in enumerate(ids):
        if row == 0:                     # the base row: an exact zero
            assert torch.count_nonzero(got[i]).item() == 0


@pytest.mark.cuda
def test_quant_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = _rand((2, 3, 16), 70, cuda)
    A, B = _banks(3, 16, 4, 8, cuda)
    nan_x = x.clone()
    nan_x[1, 0, 0] = float("nan")
    out = TQ.lora_delta(nan_x, A, B, [1, 0])  # id 0 is computed, not skipped
    assert torch.isnan(out[1, 0]).all() and not torch.isnan(out[0]).any()
    for bad in ([0, 3], [-1, 0]):
        with pytest.raises(ValueError, match="outside"):
            TQ.lora_delta(x, A, B, bad)
    with pytest.raises(ValueError, match="outside"):
        TQ.lora_delta(x, A, B, torch.tensor([0, 5], device=cuda))
    wide = _rand((3, 16, 33), 71, cuda)
    with pytest.raises(ValueError, match="rank 33"):
        TQ.lora_delta(x, wide, _rand((3, 33, 8), 72, cuda), [0, 1])
    q, scale = TQ.quantize_int8_weight(_rand((16, 8), 73, cuda))
    with pytest.raises(ValueError, match="on different devices"):
        TQ.int8_matmul(x, q.cpu(), scale)
    with pytest.raises(ValueError, match="int8"):
        TQ.int8_matmul(x, q.float(), scale)


# B, Ci, Co, HW, relu, norm, x dtype, w dtype: a ResNet-50 conv1 shape,
# ragged HW (no multiple of the 64-column tile), Co / Ci not multiples of
# the 64-row tile, the identity, a mixed-type product, a dW split over
# many k-ranges, and a product smaller than one tile
_FC = {
    "resnet_conv1_b2_bf16": (2, 256, 64, 3136, True, True, torch.bfloat16,
                             torch.bfloat16),
    "hw49_f32": (3, 40, 70, 49, True, True, torch.float32, torch.float32),
    "identity_f32": (2, 16, 8, 200, False, False, torch.float32,
                     torch.float32),
    "relu_no_norm_bf16": (2, 33, 65, 77, True, False, torch.bfloat16,
                          torch.bfloat16),
    "mixed_bf16x_f32w": (2, 64, 32, 196, True, True, torch.bfloat16,
                         torch.float32),
    "split_dw_f32": (8, 64, 256, 784, True, True, torch.float32,
                     torch.float32),
    "tiny_f32": (1, 3, 5, 7, True, True, torch.float32, torch.float32),
}
# of the plain version's largest entry: float32 z and dx, then the float32
# stats, dW, dscale and dshift (in the bf16 cases too). A bf16 z or dx is
# held to one bf16 ulp of each element, with at most 1% of the elements
# differing: both sides round float32 sums of the same bf16-rounded
# operands.
REL_FC = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (None, 1e-4)}


def _fc_close(got, want, near):
    if near is not None:
        _rel_close(got, want, near)
        return
    a, b = got.float(), want.float()
    m = torch.maximum(a.abs(), b.abs())
    ulp = torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8)
    assert ((a - b).abs() / ulp).max().item() <= 1.0
    assert (a != b).float().mean().item() <= 1e-2


def _fc_case(B, Ci, Co, HW, norm, xdt, wdt, dev, seed=80):
    x = _rand((B, Ci, HW), seed, dev, xdt)
    sc = (_rand((Ci,), seed + 1, dev).abs() + 0.5) if norm else None
    sh = _rand((Ci,), seed + 2, dev) * 0.1 if norm else None
    w = (_rand((Co, Ci), seed + 3, dev) * Ci ** -0.5).to(wdt)
    dz = _rand((B, Co, HW), seed + 4, dev, xdt)
    ds = _rand((Co,), seed + 5, dev)
    dss = _rand((Co,), seed + 6, dev) * 0.01
    return x, sc, sh, w, dz, ds, dss


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_FC))
def test_fused_conv_kernels_match_plain(cuda, case):
    B, Ci, Co, HW, relu, norm, xdt, wdt = _FC[case]
    x, sc, sh, w, dz, ds, dss = _fc_case(B, Ci, Co, HW, norm, xdt, wdt, cuda)
    before = dict(TFC.LAUNCHES)
    got = TFC._fwd_cuda(x, sc, sh, w, relu)
    want = TFC.fused_fwd_reference(x, sc, sh, w, relu)
    assert TFC.LAUNCHES["fused_conv_fwd"] == before["fused_conv_fwd"] + 1
    assert got[0].dtype == xdt and got[0].shape == (B, Co, HW)
    near, far = REL_FC[xdt]
    _fc_close(got[0], want[0], near)
    _rel_close(got[1], want[1], far)
    _rel_close(got[2], want[2], far)
    z = want[0]                  # both backward versions read one stored z
    got = TFC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss, relu)
    want = TFC.fused_bwd_reference(x, sc, sh, w, z, dz, ds, dss, relu)
    assert TFC.LAUNCHES["fused_conv_bwd"] == before["fused_conv_bwd"] + 1
    assert got[0].dtype == xdt and got[1].dtype == torch.float32
    _fc_close(got[0], want[0], near)
    for g, wv in zip(got[1:], want[1:]):
        if norm or g is got[1]:
            _rel_close(g, wv, far)
        else:
            assert not g.any()         # no norm: dscale = dshift = 0


@pytest.mark.cuda
def test_fused_conv_kernels_are_deterministic_and_checked(cuda):
    """Partials are added in a fixed order: two runs agree bit for bit.
    The wrapper refuses what the kernels do not take."""
    x, sc, sh, w, dz, ds, dss = _fc_case(4, 96, 80, 300, True,
                                         torch.float32, torch.float32, cuda)
    a = TFC._fwd_cuda(x, sc, sh, w) + TFC._bwd_cuda(x, sc, sh, w,
                                                    x[:, :80], dz, ds, dss)
    b = TFC._fwd_cuda(x, sc, sh, w) + TFC._bwd_cuda(x, sc, sh, w,
                                                    x[:, :80], dz, ds, dss)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="different devices"):
        TFC.fused_scale_act_mm_stats(x, sc.cpu(), sh.cpu(), w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TFC.fused_scale_act_mm_stats(x.half(), sc, sh, w)


@pytest.mark.cuda
def test_fused_conv_on_card_launches_kernels_and_matches_cpu(cuda,
                                                             monkeypatch):
    """With the plain versions made to raise, the differentiable op runs
    forward and backward on the card through the two kernels, and its
    values and gradients equal the CPU's (float32)."""
    args = _fc_case(2, 48, 40, 196, True, torch.float32, torch.float32,
                    torch.device("cpu"))
    x, sc, sh, w, dz, ds, dss = args

    def run(dev):
        ts = [t.detach().to(dev).requires_grad_() for t in (x, sc, sh, w)]
        z, s, ss = TFC.fused_scale_act_mm_stats(*ts, relu=True)
        ((z * dz.to(dev)).sum() + (s * ds.to(dev)).sum()
         + (ss * dss.to(dev)).sum()).backward()
        return [t.detach().cpu() for t in (z, s, ss)] + [
            t.grad.cpu() for t in ts]

    cpu = run("cpu")

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(TFC, "fused_fwd_reference", boom)
    monkeypatch.setattr(TFC, "fused_bwd_reference", boom)
    TFC.reset_launches()
    card = run(cuda)
    assert TFC.LAUNCHES["fused_conv_fwd"] == 1
    assert TFC.LAUNCHES["fused_conv_bwd"] == 1
    for i, (g, wv) in enumerate(zip(card, cpu)):
        _rel_close(g, wv, 1e-5 if i in (0, 3) else 1e-4)
