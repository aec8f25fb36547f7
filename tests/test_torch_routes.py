"""The route rules of the flash forward and the fused 1x1-conv + BN
backward, on the CPU: which products run on the tensor cores (bf16
wgmma) and which on the CUDA cores (SIMT, float32-exact), and the launch
counters the wrappers keep by route. The wrappers count by the C entry
points' own rules (`pt_flash_fwd_tensor_cores`,
`pt_fused_conv_bwd_tensor_cores`), which `chip_smoke.py` holds to these
Python rules on the card.
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


@pytest.mark.parametrize("dtype,route", [(BF, "wgmma"), (F32, "simt")])
def test_forward_route_is_the_tensor_cores_for_bf16_only(dtype, route):
    assert TA.fwd_route(dtype) == route


def test_forward_route_refuses_other_types():
    with pytest.raises(TypeError):
        TA.fwd_route(torch.float16)


@pytest.mark.parametrize("xdt,dw", [(BF, "wgmma"), (F32, "simt")])
def test_backward_route_of_dw_follows_the_type_of_x(xdt, dw):
    """dW's operands (dz_eff and the normalized activation) are x's type,
    whatever W's; dx runs the SIMT kernel for every type, so the rule
    names dW's route only."""
    assert TFC.bwd_route(xdt) == dw


def test_backward_route_refuses_other_types():
    with pytest.raises(TypeError):
        TFC.bwd_route(torch.float16)


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
    assert TFC.ROUTE_LAUNCHES == {"fused_conv_bwd:wgmma": 0,
                                  "fused_conv_bwd:simt": 0}
    assert TA.ELEMENT_LOAD_LAUNCHES["flash_fwd"] == 0


def test_route_counters_are_branches_of_the_kernel_counts():
    """The route counters are zeroed with every kernel's count and stay
    out of `_build.launches()` (which counts each kernel once)."""
    TA.ROUTE_LAUNCHES["flash_fwd:wgmma"] = 3
    TFC.ROUTE_LAUNCHES["fused_conv_bwd:simt"] = 2
    assert not any(":" in k for k in _build.launches())
    TFC.reset_launches()
    assert not any(TA.ROUTE_LAUNCHES.values())
    assert not any(TFC.ROUTE_LAUNCHES.values())


def test_c_rules_are_bound_beside_the_entry_points():
    """The C route rules exist in the sources and are bound as helpers of
    their libraries, with the vector-loads rule of the forward and the
    dW split rule of the backward."""
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    helpers = {n for lib in _build._HELPERS.values() for n, _ in lib}
    for src, name in (("flash_fwd.cu", "pt_flash_fwd_tensor_cores"),
                      ("flash_fwd.cu", "pt_flash_fwd_vector_loads"),
                      ("fused_conv_bwd.cu",
                       "pt_fused_conv_bwd_tensor_cores"),
                      ("fused_conv_bwd.cu", "pt_fused_conv_bwd_splits")):
        with open(os.path.join(csrc, src)) as f:
            assert f'extern "C" int {name}(' in f.read()
        assert name in helpers
