"""PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside `paddle_tpu` (the JAX reference, which it
never imports). Layout mirrors the reference: `core/`, `ops/`, `nn/`,
`text/`, `optimizer/`, `parallel/`, `serving/`. The attention, int8
matmul and gathered-LoRA kernels are hand-written CUDA C++ in `csrc/`,
built with nvcc at first use (`ops/_build.py`). Entry points
run on the CUDA card unless the caller passes `device="cpu"`, where the
kernels' plain PyTorch versions run instead.
"""
from .core.device import resolve_device

__all__ = ["resolve_device"]
