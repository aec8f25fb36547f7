"""The route rules of the flash forward and the fused 1x1-conv + BN
forward and backward: which products run on the tensor cores (bf16
wgmma) and which on the CUDA cores (SIMT, float32 FMAs), and the launch
counters the wrappers keep by route. The wrappers count by the C entry
points' own rules (`pt_flash_fwd_tensor_cores`,
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
    assert TA.fwd_route(dtype) == route


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
    assert TA.ROUTE_LAUNCHES == {"flash_fwd:wgmma": 0, "flash_fwd:simt": 0}
    assert TFC.ROUTE_LAUNCHES == {
        f"{k}:{r}": 0 for k in ("fused_conv_fwd", "fused_conv_bwd_dx",
                                "fused_conv_bwd_dw")
        for r in ("wgmma", "simt")}
    assert TA.ELEMENT_LOAD_LAUNCHES["flash_fwd"] == 0


def test_route_counters_are_branches_of_the_kernel_counts():
    """The route counters are zeroed with every kernel's count and stay
    out of `_build.launches()` (which counts each kernel once)."""
    TA.ROUTE_LAUNCHES["flash_fwd:wgmma"] = 3
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
    for src, name in (("flash_fwd.cu", "pt_flash_fwd_tensor_cores"),
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
    assert argc["pt_fused_conv_fwd_tensor_cores"] == 2
    assert argc["pt_fused_conv_bwd_tensor_cores"] == 3


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
