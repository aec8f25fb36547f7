"""The route rules of the flash forward and the fused 1x1-conv + BN
forward and backward: which products run on the tensor cores (bf16
wgmma) and which on the CUDA cores (SIMT, float32 FMAs), and the launch
counters the wrappers keep by route. The wrappers count by the C entry
points' own rules (`pt_flash_fwd_tensor_cores`,
`pt_fused_conv_fwd_tensor_cores`, `pt_fused_conv_bwd_tensor_cores`).
The conv rules are asked of the built library (`fused_conv.fwd_route`,
`bwd_routes`), so their values are checked on the card; the counters,
the type checks and the bindings are checked on the CPU.
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
