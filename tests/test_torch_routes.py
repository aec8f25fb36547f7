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

The plans of the kernels that merge their key splits in the kernel (the
int8 matmul's skinny route, m <= 32: `quant.skinny_plan`, the C rule
`pt_int8_matmul_skinny_plan`; the paged decode and the paged verify's
split route: `attention.paged_decode_plan`, the C rule
`pt_paged_decode_plan`; the dense decode: `attention.flash_decode_plan`,
the C rule `pt_flash_decode_plan`, which the dense verify follows) are
written out in Python and checked here over the serving shapes and the
edges; on the card the mirrors must equal the C rules. The paged
decode's merge, in the kernel's order (`testing.paged_decode_in_kernel`,
numpy), must equal the plain version's split-and-combine within 1e-6 of
its largest entry (tests/test_torch_merge.py holds the dense decode's,
the dense verify's and the split route's). The
`cuda` tests hold the kernels to their plain versions and to the
kernel-order emulation on the card, one launch a call and bitwise
repeatable; the dense verify also to the same bits over a cache whose
keys past each row's length are NaN (a rejected draft's stale block).
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import attention as TA  # noqa: E402
from paddle_tpu_torch.ops import fused_conv as TFC  # noqa: E402
from paddle_tpu_torch.ops import quant as TQ  # noqa: E402
from paddle_tpu_torch.testing import (  # noqa: E402
    dense_decode_case, dense_verify_case, flash_decode_in_kernel,
    flash_verify_in_kernel, nan_past_lengths, paged_decode_in_kernel,
    paged_read_case, paged_verify_in_kernel)

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
    # float16 has a route since the kernels' f16 instances (wgmma)
    assert TA.fwd_route(torch.float16) == "wgmma"
    for dt in (torch.float64, torch.int8):
        with pytest.raises(TypeError):
            TA.fwd_route(dt)


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
    bucket), at least 128 of d a split; the skinny path (m <= 32) splits
    it over a cluster of up to 8 blocks, one a 64-row stage at least, for
    about two blocks an SM (`skinny_plan`)."""
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
                            ("paged_verify.cu", "pt_paged_verify_plan", 7),
                            ("lora_gather.cu", "pt_lora_gather_plan", 7)):
        with open(os.path.join(csrc, src)) as f:
            assert f'extern "C" int {name}(' in f.read()
        assert len(helpers[name]) == argc
    # both write the output and plan their own splits; the verify also
    # takes the tiled route's partials and counters (four pointers), T and
    # the tiled plan's override beside the split route's
    assert len(_build._SIGNATURES["paged_verify"][1]) == \
        len(_build._SIGNATURES["paged_decode"][1]) + 6


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


# ------------------------------- the plans of the in-kernel split merges

#: (m, d, n) -> (8-row tiles of m, k-splits = blocks a cluster, k a split,
#: warps a block) on an H100 (132 SMs): the decode step (m 8) and the spec
#: verify step (m 32) over the decoder's and the vocabulary's shapes, and
#: the edges
_SKINNY_PLANS = {
    (8, 512, 512): (1, 8, 64, 4), (8, 512, 2048): (1, 8, 64, 4),
    (8, 2048, 512): (1, 8, 256, 8), (8, 512, 37000): (1, 1, 512, 4),
    (32, 512, 512): (4, 8, 64, 4), (32, 512, 2048): (4, 8, 64, 4),
    (32, 2048, 512): (4, 8, 256, 8), (32, 512, 37000): (4, 1, 512, 4),
    (1, 100, 37): (1, 2, 64, 4), (16, 2048, 2048): (2, 8, 256, 8),
    (17, 300, 1001): (4, 5, 64, 4), (32, 4096, 512): (4, 8, 512, 8),
    (8, 0, 512): (1, 1, 64, 4), (8, 2048, 37000): (1, 1, 2048, 4)}


@pytest.mark.parametrize("m,d,n", sorted(_SKINNY_PLANS))
def test_skinny_plan_at_the_serving_shapes(m, d, n):
    assert TQ.skinny_plan(m, d, n) == _SKINNY_PLANS[(m, d, n)]


@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 32])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_skinny_plan_splits_d_in_whole_stages_over_a_cluster(m, sms):
    """Every rank of a cluster gets a nonempty run of whole 64-row
    stages and the ranks cover d; at most 8 ranks, no more than the
    stages; a split only while the strips alone leave the card short of
    two blocks an SM; 8 warps a block only where the grid is short of a
    block an SM and a split holds whole 128-row stages."""
    for d in (1, 64, 65, 512, 2048, 4096):
        for n in (1, 37, 512, 2048, 37000):
            mt, c, kps, warps = TQ.skinny_plan(m, d, n, sms)
            assert mt == (1 if m <= 8 else 2 if m <= 16 else 4)
            stages = -(-d // 64)
            assert kps % 64 == 0 and 1 <= c <= min(8, stages)
            assert (c - 1) * kps < d <= c * kps
            strips = -(-n // 128)
            if c > 1:
                assert (c - 1) * strips < 2 * sms
            # 8 warps (128-row stages) only for a grid short of an SM each
            assert warps == (8 if strips * c < sms and kps % 128 == 0
                             else 4)
            assert TQ._int8_splits(m, d, n) == TQ.skinny_plan(m, d, n)[1]


@pytest.mark.parametrize("m", [0, 33, 1024])
def test_skinny_plan_refuses_the_tiled_route(m):
    with pytest.raises(ValueError, match="skinny"):
        TQ.skinny_plan(m, 512, 512)


#: (S, h, mp) -> (splits = blocks a cluster, pages a split) on an H100: the
#: paged serve's decode step (S 8, h 8, 67 pages of 16 at max_len 1056 + the
#: spec overhang) and the edges
_DECODE_PLANS = {(8, 8, 67): (7, 10), (8, 8, 1): (1, 1), (8, 8, 5): (5, 1),
                 (1, 8, 67): (8, 9), (16, 8, 67): (4, 17),
                 (64, 16, 67): (1, 67), (4, 2, 9): (5, 2)}


@pytest.mark.parametrize("S,h,mp", sorted(_DECODE_PLANS))
def test_paged_decode_plan_at_the_serving_shapes(S, h, mp):
    assert TA.paged_decode_plan(S, h, mp) == _DECODE_PLANS[(S, h, mp)]


@pytest.mark.parametrize("rows", [(1, 1), (1, 8), (8, 8), (16, 8),
                                  (64, 16)])
def test_paged_decode_plan_splits_whole_pages_over_a_cluster(rows):
    """For every mp from 1 to 67: every rank gets a nonempty run of whole
    pages and the ranks cover the row; at most 8 ranks and no more than
    the pages; a split only while the rows alone leave the card short of
    three blocks an SM."""
    S, h = rows
    for mp in range(1, 68):
        c, pps = TA.paged_decode_plan(S, h, mp)
        assert 1 <= c <= min(8, mp)
        assert (c - 1) * pps < mp <= c * pps
        if c > 1:
            assert (c - 1) * S * h < 3 * 132


@pytest.mark.parametrize("S,h,mp", [(-1, 8, 4), (2, 0, 4), (2, 8, 0)])
def test_paged_decode_plan_refuses_empty_rows(S, h, mp):
    with pytest.raises(ValueError, match="no plan"):
        TA.paged_decode_plan(S, h, mp)


def test_merge_plans_are_bound():
    """The C rules exist in the sources and are bound as helpers of their
    libraries (device, three sizes, the plan's override, the output
    array); the dense verify
    follows the dense decode's rule (`amerge::dense_plan`), and its entry
    takes the decode's arguments and T (both write the output)."""
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    helpers = {n: a for lib in _build._HELPERS.values() for n, a in lib}
    for src, name in (("int8_matmul.cu", "pt_int8_matmul_skinny_plan"),
                      ("paged_decode.cu", "pt_paged_decode_plan"),
                      ("flash_decode.cu", "pt_flash_decode_plan")):
        with open(os.path.join(csrc, src)) as f:
            assert f'extern "C" int {name}(' in f.read()
        assert len(helpers[name]) == 6
    for src in ("flash_decode.cu", "flash_verify.cu"):
        with open(os.path.join(csrc, src)) as f:
            assert "amerge::dense_plan(" in f.read()
    assert len(_build._SIGNATURES["flash_verify"][1]) == \
        len(_build._SIGNATURES["flash_decode"][1]) + 1


def _paged_decode_case(S, h, psz, mp, d, lens, kv_dt, hole, seed=60,
                       dev="cpu"):
    return paged_read_case(S, h, psz, mp, d, 1, lens, kv_dt, hole, seed, dev)


#: S, h, page size, mp, d, lengths, bias hole; the plan of each (S, h, mp)
#: splits the row over 5 ranks of 2 pages (32 keys): a slot with no written
#: key, slots whose last ranks see no key (17, 40), a hole over the first
#: split's keys of every slot (rows that see keys past it), d 40 and 128
_DECODE_EMU = {
    "length0_short_slots": (4, 2, 16, 9, 64, [0, 144, 17, 100], (3, 9)),
    "hole_over_the_first_split": (4, 2, 16, 9, 64, [0, 144, 40, 100],
                                  (0, 32)),
    "page8_d40": (3, 2, 8, 12, 40, [96, 9, 50], (10, 20)),
    "d128_one_page_splits": (2, 2, 16, 5, 128, [80, 33], (0, 16)),
}


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(_DECODE_EMU))
def test_in_kernel_merge_equals_the_combine(case, kv):
    """The kernel's arithmetic (groups of a split in key order, groups
    merged in group order, splits in rank order) against the plain
    version's partials of 128 keys and the logsumexp combine: within 1e-6
    of the largest entry; the slot with no written key is exactly 0."""
    S, h, psz, mp, d, lens, hole = _DECODE_EMU[case]
    kv_dt = torch.int8 if kv == "int8" else torch.float32
    args = _paged_decode_case(S, h, psz, mp, d, lens, kv_dt, hole)
    want = TA.paged_flash_decode_plain(*args)
    got = paged_decode_in_kernel(*args)
    assert got.shape == want.shape == (S, h, 1, d)
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item()
    for s, n in enumerate(lens):
        if n == 0:
            assert not got[s].any() and not want[s].any()


def test_in_kernel_merge_follows_the_plan():
    """One rank or eight: the same output within 1e-6 (the plan moves the
    order of the sums, not the function)."""
    args = _paged_decode_case(2, 2, 16, 20, 64, [300, 120], torch.float32,
                              (0, 40))
    one = paged_decode_in_kernel(*args, plan=(1, 20))
    eight = paged_decode_in_kernel(*args, plan=(7, 3))
    assert (one - eight).abs().max().item() <= 1e-6 * one.abs().max().item()


# ---------------------------------------------------- the merges on the card


@pytest.mark.cuda
def test_merge_plan_mirrors_are_the_c_rules(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in (1, 8, 16, 17, 32):
        for d in (0, 70, 512, 2048):
            for n in (5, 130, 512, 2048, 37000):
                assert TQ.skinny_plan_on_card(m, d, n, cuda) == \
                    TQ.skinny_plan(m, d, n, sms)
    for S, h in ((1, 8), (8, 8), (16, 8), (64, 16)):
        for mp in (1, 2, 9, 36, 67):
            assert TA.paged_decode_plan_on_card(S, h, mp, cuda) == \
                TA.paged_decode_plan(S, h, mp, sms)
        for L in (1, 31, 33, 300, 1056, 1060, 4100):
            assert TA.flash_decode_plan_on_card(S, h, L, cuda) == \
                TA.flash_decode_plan(S, h, L, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,n", [(8, 512, 512), (8, 2048, 512),
                                   (8, 512, 37000), (32, 512, 512),
                                   (32, 2048, 512), (32, 512, 37000),
                                   (1, 100, 37), (17, 300, 1001)])
def test_skinny_route_is_one_repeatable_launch(cuda, m, d, n):
    """Within 1e-5 of the plain version's largest entry; one launch a
    call on the skinny route (the k-splits merged in the kernel); the
    same bits on every call (the ranks' partials added in rank order)."""
    rs = np.random.RandomState(m + d + n)
    x = torch.from_numpy(rs.randn(m, d).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rs.randn(d, n).astype(np.float32) * 0.05)
    q, scale = (t.to(cuda) for t in TQ.quantize_int8_weight(w))
    TQ.reset_launches()
    got = TQ.int8_matmul(x, q, scale)
    again = TQ.int8_matmul(x, q, scale)
    assert TQ.LAUNCHES["int8_matmul"] == 2
    assert TQ.ROUTE_LAUNCHES == {"int8_matmul:skinny": 2,
                                 "int8_matmul:tiled": 0}
    assert torch.equal(got, again)
    want = TQ.int8_matmul_reference(x, q, scale)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


_DECODE_CARD = {
    **{f"{k}_{kv}": (*v, kv) for k, v in _DECODE_EMU.items()
       for kv in ("fp32", "bf16", "int8")},
    "serving_S8_h8_mp67_fp32": (8, 8, 16, 67, 64,
                                [60, 1072, 700, 300, 129, 0, 1000, 513],
                                (20, 40), "fp32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_DECODE_CARD))
def test_paged_decode_is_one_repeatable_launch(cuda, case):
    """Against the plain version (atol 2e-5) and the kernel-order
    emulation; one launch a call, the same bits on every call."""
    S, h, psz, mp, d, lens, hole, kv = _DECODE_CARD[case]
    kv_dt = {"fp32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}[kv]
    args = _paged_decode_case(S, h, psz, mp, d, lens, kv_dt, hole, dev=cuda)
    TA.reset_launches()
    got = TA.paged_flash_decode(*args)
    again = TA.paged_flash_decode(*args)
    assert TA.LAUNCHES["paged_flash_decode"] == 2
    assert torch.equal(got, again)
    want = TA.paged_flash_decode_plain(*args)
    assert (got - want).abs().max().item() <= 2e-5
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    emu = paged_decode_in_kernel(*args, plan=TA.paged_decode_plan(S, h, mp,
                                                                  sms))
    assert (got.cpu() - emu).abs().max().item() <= 2e-5


#: b, h, L, d, lengths, bias hole, dtype: the dense decode on the card (the
#: cases of tests/test_torch_merge.py and the dense pool's decode step)
_DENSE_CARD = {
    **{f"{k}_{n}": (*v, dt) for k, v in {
        "length0_ragged_L_d64": (4, 2, 300, 64, [0, 300, 37, 161], (5, 30)),
        "hole_over_split0_d64": (3, 2, 256, 64, [256, 200, 129], (0, 128)),
        "d40_ragged": (3, 2, 200, 40, [1, 199, 77], (50, 60)),
        "d128_ragged": (2, 2, 150, 128, [150, 17], (3, 9))}.items()
       for n, dt in (("fp32", F32), ("bf16", BF))},
    "serving_b8_h8_L1056_fp32": (8, 8, 1056, 64,
                                 [60, 1056, 700, 300, 129, 128, 1000, 513],
                                 (20, 40), F32),
}


def _close(got, want, dtype, what):
    """fp32: atol 2e-5; bf16: 1e-2 of the largest entry."""
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    limit = 2e-5 if dtype == F32 else 1e-2 * want.float().abs().max().item()
    assert err <= limit, f"{what}: {err} > {limit}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_DENSE_CARD))
def test_flash_decode_is_one_repeatable_launch(cuda, case):
    """Against the plain version and the kernel-order emulation (fp32
    atol 2e-5, bf16 1e-2 of the largest entry); one launch a call, the
    same bits on every call."""
    b, h, L, d, lens, hole, dt = _DENSE_CARD[case]
    args = dense_decode_case(b, h, L, d, lens, dt, hole, device=cuda)
    TA.reset_launches()
    got = TA.flash_decode(*args)
    again = TA.flash_decode(*args)
    assert TA.LAUNCHES["flash_decode"] == 2
    assert got.dtype == dt and torch.equal(got, again)
    _close(got, TA.flash_decode_plain(*args), dt, "plain")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _close(got, flash_decode_in_kernel(
        *args, plan=TA.flash_decode_plan(b, h, L, sms)), dt, "emulation")


#: b, h, L, d, lengths after the block's write (None: the block's own T),
#: bias hole: the dense verify on the card at tests/test_torch_merge.py's
#: cases (a row with n_valid == T, L 1060, d 40, 64 and 128)
_VERIFY_BASE = {
    "L1060_d64": (3, 2, 1060, 64, [None, 1060, 517], (20, 40)),
    "d40_ragged": (2, 2, 300, 40, [None, 263], (50, 60)),
    "d128_ragged": (2, 2, 200, 128, [150, None], (3, 9)),
}
#: name -> (b, h, L, d, lengths, hole, T, dtype): those cases at T 1, 4, 5
#: and 12 (one, one, two and two tiles of rows at d 64) in fp32 and bf16,
#: and the dense speculative step (b8 h8 T4 L1060, phase 2's lengths)
_VERIFY_CARD = {
    **{f"{k}_T{T}_{n}": (*v, T, dt) for k, v in _VERIFY_BASE.items()
       for T in (1, 4, 5, 12) for n, dt in (("fp32", F32), ("bf16", BF))},
    "serving_b8_h8_T4_L1060_fp32": (8, 8, 1060, 64,
                                    [60, 1060, 700, 300, 129, 128, 1000,
                                     513], (20, 40), 4, F32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_VERIFY_CARD))
def test_flash_verify_is_one_repeatable_launch(cuda, case):
    """Against the plain version and the kernel-order emulation (fp32
    atol 2e-5, bf16 1e-2 of the largest entry); one launch a call, the
    same bits on every call; and with NaN keys and values past each row's
    length (the stale block of a rejected draft) the same bits again: the
    kernel reads no key at or past n_valid."""
    b, h, L, d, lens, hole, T, dt = _VERIFY_CARD[case]
    lens = [T if n is None else n for n in lens]
    args = dense_verify_case(b, h, T, L, d, lens, dt, hole, seed=90 + T,
                             device=cuda)
    TA.reset_launches()
    got = TA.flash_verify(*args)
    again = TA.flash_verify(*args)
    assert TA.LAUNCHES["flash_verify"] == 2
    assert got.dtype == dt and torch.equal(got, again)
    _close(got, TA.flash_verify_plain(*args), dt, "plain")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _close(got, flash_verify_in_kernel(
        *args, plan=TA.flash_decode_plan(b, h, L, sms)), dt, "emulation")
    q, k, v, length, bias = args
    stale = TA.flash_verify(q, *nan_past_lengths(k, v, length), length, bias)
    assert torch.equal(stale, got)


#: S, h, page size, mp, d, T, lengths, bias hole, pages: the split route
#: (T <= 8) at tests/test_torch_merge.py's cases and the paged speculative
#: step (S8 h8 T4 mp67)
_SPLIT_CARD = {
    **{f"T{T}_{kv}": (4, 2, 8, 12, 64, T, [T + 40, T, 53, 96], (20, 24),
                      kv) for T in (1, 2, 4, 5, 8)
       for kv in ("fp32", "bf16", "int8")},
    "T8_d128_fp32": (3, 2, 16, 6, 128, 8, [90, 8, 41], (20, 24), "fp32"),
    "T3_d40_int8": (3, 2, 16, 6, 40, 3, [90, 3, 41], (20, 24), "int8"),
    "serving_S8_h8_T4_mp67_fp32": (8, 8, 16, 67, 64, 4,
                                   [60, 1072, 700, 300, 129, 4, 1000, 513],
                                   (20, 40), "fp32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_SPLIT_CARD))
def test_split_route_is_one_repeatable_launch(cuda, case):
    """The paged verify at T <= 8 on the card: one launch a call on the
    split route, which writes the output; the same bits on every call;
    atol 2e-5 of the plain version and of the kernel-order emulation."""
    S, h, psz, mp, d, T, lens, hole, kv = _SPLIT_CARD[case]
    kv_dt = {"fp32": F32, "bf16": BF, "int8": torch.int8}[kv]
    args = paged_read_case(S, h, psz, mp, d, T, lens, kv_dt, hole,
                           seed=80 + T, device=cuda)
    TA.reset_launches()
    got = TA.paged_flash_verify(*args)
    again = TA.paged_flash_verify(*args)
    assert TA.LAUNCHES["paged_flash_verify"] == 2
    assert TA.PAGED_ROUTE_LAUNCHES["paged_flash_verify:split"] == 2
    assert torch.equal(got, again)
    _close(got, TA.paged_flash_verify_plain(*args), F32, "plain")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _close(got, paged_verify_in_kernel(
        *args, plan=TA.paged_decode_plan(S, h, mp, sms)), F32, "emulation")


def test_probe_variants_still_apply_to_the_kernels():
    """tools/probe_decode_merge.py builds each design-step variant from
    anchored edits of the kernels' sources and of attn_merge.cuh: every
    anchor is still found exactly once, every edit changes its file, and
    the built source gets the probe functions."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import probe_decode_merge as probe

    for name, (src, edits) in probe.VARIANTS.items():
        fname, texts = probe.variant_source(name)
        assert fname == src and "probe_clusters" in texts[src]
        for f, text in texts.items():
            with open(os.path.join(probe.CSRC, f)) as fh:
                base = fh.read()
            if f == src:
                assert "probe_clusters" not in base
                text = text.rsplit('\nextern "C" int probe_clusters', 1)[0]
                text = text.rsplit("\ntemplate <class K>\nstatic int "
                                   "probe_run", 1)[0]
            assert (text != base) == any(e[0] == f for e in edits)
