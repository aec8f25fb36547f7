"""The route rules of the flash forward and the fused 1x1-conv + BN
forward and backward: which products run on the tensor cores (bf16
wgmma; float32 as 3xTF32 mma.sync) and which on the CUDA cores (SIMT,
float32 FMAs), and the launch counters the wrappers keep by route. The
wrappers count by the C entry points' own rules (`pt_flash_fwd_route`,
`pt_fused_conv_fwd_tensor_cores`, `pt_fused_conv_bwd_tensor_cores`).
The conv rules are asked of the built library (`fused_conv.fwd_route`,
`bwd_routes`), so their values are checked on the card; the counters,
the type checks and the bindings are checked on the CPU. So are the paged
verify's routes (`attention.paged_verify_route`, the C rule
`pt_paged_verify_route`: split-K for T <= 8, query-tiled above), its plan
(`pt_paged_verify_plan`) and the LoRA kernel's cluster plan
(`pt_lora_gather_plan`).
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import attention as TA  # noqa: E402
from paddle_tpu_torch.ops import fused_conv as TFC  # noqa: E402
from paddle_tpu_torch.ops import quant as TQ  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the conv route rules are asked "
                    "of the built CUDA library")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,route", [(BF, "wgmma"), (F32, "simt")])
def test_forward_route_is_the_tensor_cores_for_bf16_only(dtype, route):
    """Under attention dropout or segment ids (the training paths) only
    bf16 runs on the tensor cores: float32 keeps its FMAs on the CUDA
    cores, at any sq."""
    for sq in (1, 16, 17, 1024):
        assert TA.fwd_route(dtype, sq, dropout=True) == route
        assert TA.fwd_route(dtype, sq, segments=True) == route


@pytest.mark.parametrize("sq,route", [(1, "tf32x3_short"),
                                      (16, "tf32x3_short"),
                                      (17, "tf32x3"), (256, "tf32x3"),
                                      (1024, "tf32x3")])
def test_float32_forward_route_is_3xtf32_on_the_serving_paths(sq, route):
    """Without dropout and segment ids (every serving call: prefill,
    encoder, cross-attention) float32 runs on the tensor cores as
    3xTF32, split over the keys up to 16 query rows (the decode step's
    cross-attention); bf16 stays on wgmma."""
    assert TA.fwd_route(F32, sq) == route
    assert TA.fwd_route(BF, sq) == "wgmma"


def test_float32_forward_route_needs_sq():
    with pytest.raises(ValueError):
        TA.fwd_route(F32)


def test_forward_route_refuses_other_types():
    with pytest.raises(TypeError):
        TA.fwd_route(torch.float16)


_TYPES = [(BF, BF), (BF, F32), (F32, BF), (F32, F32)]


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", _TYPES)
def test_fused_forward_route_is_the_tensor_cores_for_bf16_x_and_w_only(
        cuda, xdt, wdt):
    """A bf16 x with a float32 W promotes its products to float32, so it
    stays on the SIMT kernel, as does a float32 x with any W."""
    want = "wgmma" if (xdt, wdt) == (BF, BF) else "simt"
    assert TFC.fwd_route(xdt, wdt) == want


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", _TYPES)
def test_backward_route_of_dx_is_the_forwards(cuda, xdt, wdt):
    """dx's products dz_eff * W are those of the forward's rule: wgmma
    only for a bf16 x and a bf16 W."""
    assert TFC.bwd_routes(xdt, wdt)[0] == TFC.fwd_route(xdt, wdt)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", _TYPES)
def test_backward_route_of_dw_follows_the_type_of_x(cuda, xdt, wdt):
    """dW's operands (dz_eff and the normalized activation) are x's type,
    whatever W's."""
    assert TFC.bwd_routes(xdt, wdt)[1] == ("wgmma" if xdt == BF else "simt")


def test_backward_route_refuses_other_types():
    """An x of another type is refused before the library is asked (so
    here, on the CPU, too)."""
    for rule in (TFC.fwd_route, TFC.bwd_routes):
        with pytest.raises(TypeError):
            rule(torch.float16, BF)


def test_route_counters_count_no_cpu_run():
    """The plain versions on the CPU launch nothing: every route counter
    stays at 0, and the counters name each route of each kernel."""
    TA.reset_launches()
    q = torch.randn(1, 2, 70, 64).to(BF)
    TA.flash_attention_fwd(q, q, q)
    x = torch.randn(2, 16, 49).to(BF)
    w = torch.randn(8, 16).to(BF).requires_grad_()
    z, s, ss = TFC.fused_scale_act_mm_stats(x, None, None, w, relu=False)
    (z.float().sum() + s.sum() + ss.sum()).backward()
    TA.flash_attention_fwd(q.float(), q.float(), q.float())
    TA.flash_attention_fwd(q[:, :, :3].float(), q.float(), q.float())
    assert TA.ROUTE_LAUNCHES == {"flash_fwd:wgmma": 0, "flash_fwd:tf32x3": 0,
                                 "flash_fwd:tf32x3_short": 0,
                                 "flash_fwd:simt": 0}
    assert TFC.ROUTE_LAUNCHES == {
        f"{k}:{r}": 0 for k in ("fused_conv_fwd", "fused_conv_bwd_dx",
                                "fused_conv_bwd_dw")
        for r in ("wgmma", "simt")}
    assert TA.ELEMENT_LOAD_LAUNCHES["flash_fwd"] == 0


def test_route_counters_are_branches_of_the_kernel_counts():
    """The route counters are zeroed with every kernel's count and stay
    out of `_build.launches()` (which counts each kernel once)."""
    TA.ROUTE_LAUNCHES["flash_fwd:wgmma"] = 3
    TA.ROUTE_LAUNCHES["flash_fwd:tf32x3_short"] = 2
    TFC.ROUTE_LAUNCHES["fused_conv_bwd_dw:simt"] = 2
    TFC.ROUTE_LAUNCHES["fused_conv_fwd:wgmma"] = 1
    TFC.ROUTE_LAUNCHES["fused_conv_bwd_dx:wgmma"] = 1
    assert not any(":" in k for k in _build.launches())
    TFC.reset_launches()
    assert not any(TA.ROUTE_LAUNCHES.values())
    assert not any(TFC.ROUTE_LAUNCHES.values())


def test_c_rules_are_bound_beside_the_entry_points():
    """The C route rules exist in the sources and are bound as helpers of
    their libraries, with the vector-loads rule of the flash forward and
    the dW split rule of the conv backward."""
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    helpers = {n for lib in _build._HELPERS.values() for n, _ in lib}
    for src, name in (("flash_fwd.cu", "pt_flash_fwd_route"),
                      ("flash_fwd.cu", "pt_flash_fwd_cluster"),
                      ("flash_fwd.cu", "pt_flash_fwd_vector_loads"),
                      ("fused_conv_fwd.cu",
                       "pt_fused_conv_fwd_tensor_cores"),
                      ("fused_conv_bwd.cu",
                       "pt_fused_conv_bwd_tensor_cores"),
                      ("fused_conv_bwd.cu", "pt_fused_conv_bwd_splits")):
        with open(os.path.join(csrc, src)) as f:
            assert f'extern "C" int {name}(' in f.read()
        assert name in helpers
    # the conv rules take the types of x and W (and the backward's product)
    argc = {n: len(a) for lib in _build._HELPERS.values() for n, a in lib}
    assert argc["pt_flash_fwd_route"] == 4
    assert argc["pt_flash_fwd_cluster"] == 4
    assert argc["pt_fused_conv_fwd_tensor_cores"] == 2
    assert argc["pt_fused_conv_bwd_tensor_cores"] == 3


@pytest.mark.cuda
def test_forward_route_mirror_is_the_c_rule(cuda):
    """`fwd_route` writes out `pt_flash_fwd_route`, by which the wrapper
    counts: the two agree on every type, sq and flag."""
    lib = _build.kernels()
    names = {0: "simt", 1: "wgmma", 2: "tf32x3", 3: "tf32x3_short"}
    for dt, code in ((F32, 0), (BF, 1)):
        for sq in (1, 2, 15, 16, 17, 64, 1024):
            for segs in (0, 1):
                for drop in (0, 1):
                    assert names[lib.flash_fwd_route(code, sq, segs, drop)] \
                        == TA.fwd_route(dt, sq, bool(segs), bool(drop))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,want", [
    (8, 8, 1, 256, 4), (1, 8, 1, 256, 4), (3, 2, 1, 1000, 8),
    (16, 8, 1, 77, 2), (1, 1, 1, 64, 1), (1, 8, 1024, 1024, 2),
    (1, 8, 1024, 256, 2), (16, 8, 256, 256, 1)])
def test_forward_cluster_splits_keys_to_fill_the_card(cuda, b, h, sq, sk,
                                                      want):
    """The float32 tensor-core routes split a (query tile, b*h) pair's key
    tiles over a cluster of up to 8 blocks, about two blocks an SM: the
    decode step's b8 h8 1 x 256 over 4 (one tile a block), the serving
    prefill and cross-attention (128 pairs) over 2, the encoder's 512
    pairs not at all; never more blocks than key tiles."""
    q = torch.empty(b, h, sq, 64, device=cuda)
    got = TA.fwd_cluster(q, sk)
    tiles = -(-sk // 64)
    assert 1 <= got <= min(8, tiles)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pairs = b * h * (1 if sq <= 16 else -(-sq // 64))
    rule = -(-2 * sms // pairs) if sq <= 16 else 2 * sms // pairs
    assert got == max(1, min(8, tiles, rule))
    if sms == 132:                 # the H100 SXM's count
        assert got == want
@pytest.mark.parametrize("m,d,n,want", [
    (1024, 2048, 512, 5), (1024, 512, 512, 4), (1024, 512, 2048, 1),
    (1024, 512, 37000, 1), (33, 70, 130, 1), (200, 512, 512, 4),
    (8, 2048, 512, 8), (8, 512, 37000, 1)])
def test_int8_splits_split_d_only_where_few_tiles_run(m, d, n, want):
    """The tiled path (m > 32) splits d across blocks only where its grid
    has fewer than 66 of the 128 x 128 tiles (n = 512 at a prompt
    bucket), at least 128 of d a split; the skinny path (m <= 32) aims at
    two blocks an SM, at most one a 256-wide chunk."""
    assert TQ._int8_splits(m, d, n) == want


def test_int8_route_counters_count_no_cpu_run():
    TQ.reset_launches()
    for m in (8, 64):
        x = torch.randn(m, 32)
        q, scale = TQ.quantize_int8_weight(torch.randn(32, 16))
        TQ.int8_matmul(x, q, scale)
    assert TQ.ROUTE_LAUNCHES == {"int8_matmul:skinny": 0,
                                 "int8_matmul:tiled": 0}
    assert "int8_matmul:tiled" not in _build.launches()


# ---------------------------------------------------- the paged verify


@pytest.mark.parametrize("T,d", [(0, 64), (-1, 64), (16, 0), (16, 129)])
def test_paged_verify_route_refuses_what_no_kernel_takes(T, d):
    """Refused before the library is asked (so here, on the CPU, too)."""
    with pytest.raises(ValueError, match="no kernel"):
        TA.paged_verify_route(T, d)


def test_paged_route_counters_count_no_cpu_run():
    """A tail-width and a spec-width verify on the CPU run the plain
    version: both route counters stay at 0, and they name the two
    routes."""
    TA.reset_launches()
    g = torch.Generator().manual_seed(0)
    S, h, psz, mp, d = 2, 2, 16, 6, 32
    kp = torch.randn(S * mp + 1, h, psz, d, generator=g)
    table = torch.arange(S * mp, dtype=torch.int32).reshape(S, mp)
    for T in (4, 32):
        q = torch.randn(S, h, T, d, generator=g)
        length = torch.tensor([T + 10, T], dtype=torch.int32)
        TA.paged_flash_verify(q, kp, kp, None, None, table, length)
    assert TA.PAGED_ROUTE_LAUNCHES == {"paged_flash_verify:split": 0,
                                       "paged_flash_verify:tiled": 0}
    assert TA.LAUNCHES["paged_flash_verify"] == 0


def test_paged_route_counters_are_branches_of_the_kernel_count():
    TA.PAGED_ROUTE_LAUNCHES["paged_flash_verify:tiled"] = 4
    assert "paged_flash_verify:tiled" not in _build.launches()
    TA.reset_launches()
    assert not any(TA.PAGED_ROUTE_LAUNCHES.values())


def test_paged_verify_and_lora_rules_are_bound():
    """The C rules exist in the sources and are bound as helpers of their
    libraries; the verify entry takes the output and the counters beside
    the split partials."""
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    helpers = {n: a for lib in _build._HELPERS.values() for n, a in lib}
    for src, name, argc in (("paged_verify.cu", "pt_paged_verify_route", 2),
                            ("paged_verify.cu", "pt_paged_verify_plan", 6),
                            ("lora_gather.cu", "pt_lora_gather_plan", 5)):
        with open(os.path.join(csrc, src)) as f:
            assert f'extern "C" int {name}(' in f.read()
        assert len(helpers[name]) == argc
    assert len(_build._SIGNATURES["paged_verify"][1]) == \
        len(_build._SIGNATURES["paged_decode"][1]) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("T,route", [(1, "split"), (2, "split"),
                                     (4, "split"), (5, "split"),
                                     (8, "split"), (9, "tiled"),
                                     (16, "tiled"), (32, "tiled"),
                                     (64, "tiled"), (512, "tiled")])
def test_paged_verify_route_is_split_to_eight_rows(cuda, T, route):
    """The speculative step (T = spec_k <= 8) keeps the split-K kernel;
    every tail-prefill bucket (T >= 32 on the serving path) is tiled."""
    for d in (40, 64, 128):
        assert TA.paged_verify_route(T, d) == route


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,W", [(1, 64, 36), (1, 256, 48), (1, 512, 64),
                                   (8, 256, 67)])
def test_paged_verify_plan_fills_the_card(cuda, S, T, W):
    """At the tail prefills (`PagedLayout.pattach`'s S 1 h 8 rows of
    W = 32 + T/16 pages, and the S 8 case of chip_smoke's phase 8) the
    plan aims at a block per SM in whole 64-key tiles a split, no split
    longer than 256 keys: the grid holds at least half a block per SM
    (the rounding to whole tiles), never a split without keys."""
    bq, ns, split = TA.paged_verify_plan(torch.empty(S, 8, T, 64,
                                                     device=cuda), W * 16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert bq in (16, 32, 64) and split % 64 == 0 and split <= 256
    assert ns == -(-W * 16 // split)
    assert 2 * ns * S * 8 * -(-T // bq) >= sms


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,rows,min_ctas", [(8, 1, 512, 1, 64),
                                                 (8, 4, 2048, 4, 64),
                                                 (1, 1024, 2048, 16, 132)])
def test_lora_plan_spreads_each_row_tile_over_a_cluster(cuda, b, s, d,
                                                        rows, min_ctas):
    """A row tile of the LoRA delta is one cluster of CTAs, each reducing
    its slice of d: a decode step (b 8, s 1) gets clusters of 8 or 16
    CTAs, a 1024-token join enough clusters to cover the card."""
    rt, c = TQ.lora_gather_plan(b, s, d, cuda)
    assert rt == rows and c in (1, 2, 4, 8, 16)
    assert b * -(-s // rt) * c >= min_ctas


@pytest.mark.cuda
def test_paged_verify_counts_launches_by_route(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    S, h, psz, mp, d = 2, 2, 16, 8, 64
    kp = torch.randn(S * mp + 1, h, psz, d, generator=g, device=cuda)
    table = torch.arange(S * mp, dtype=torch.int32,
                         device=cuda).reshape(S, mp)
    TA.reset_launches()
    for T in (4, 8, 9, 64):
        q = torch.randn(S, h, T, d, generator=g, device=cuda)
        length = torch.tensor([T + 30, T], dtype=torch.int32, device=cuda)
        TA.paged_flash_verify(q, kp, kp, None, None, table, length)
    assert TA.PAGED_ROUTE_LAUNCHES == {"paged_flash_verify:split": 2,
                                       "paged_flash_verify:tiled": 2}
    assert TA.LAUNCHES["paged_flash_verify"] == 4
