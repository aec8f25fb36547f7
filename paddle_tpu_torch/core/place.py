"""Device places (the JAX package's `core/place.py`; reference:
platform/place.h:103).

`CUDAPlace(i)` is the port's accelerator place: the i-th CUDA card.
`TPUPlace` is kept for programs written against the JAX package and
names the same card. `set_device` is the caller's choice of where
`device=None` runs: `set_device("cpu")` asks for the CPU; until it is
called, every entry point runs on the card (`core.device`).
"""
from __future__ import annotations

import torch

from .device import default_device, set_default_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "set_device", "get_device", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "is_compiled_with_xpu",
           "accelerator_count", "to_torch_device"]


class Place:
    _idx: int

    def __init__(self, idx: int = 0):
        self._idx = int(idx)

    def get_device_id(self) -> int:
        return self._idx

    def __eq__(self, other):
        return type(self) is type(other) and self._idx == other._idx

    def __hash__(self):
        return hash((type(self).__name__, self._idx))

    def __repr__(self):
        return f"{type(self).__name__}({self._idx})"


class CPUPlace(Place):
    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(Place):
    """The i-th CUDA card."""


class TPUPlace(Place):
    """Kept for programs written against the JAX package: the i-th
    accelerator, which is a CUDA card here."""


class CUDAPinnedPlace(Place):
    def __repr__(self):
        return "CUDAPinnedPlace"


class XPUPlace(Place):
    pass


def to_torch_device(place):
    """The torch device of a Place (CPUPlace and CUDAPinnedPlace: the
    CPU)."""
    if isinstance(place, (CPUPlace, CUDAPinnedPlace)):
        return torch.device("cpu")
    if isinstance(place, XPUPlace):
        raise ValueError("XPUPlace: the port has no XPU backend")
    return torch.device("cuda", place.get_device_id())


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


def accelerator_count() -> int:
    return torch.cuda.device_count()


def set_device(device):
    """paddle.set_device: "cpu", or "gpu" / "gpu:i" (also "cuda:i" and,
    for the JAX package's programs, "tpu:i"), or a Place. Returns the
    Place; every later `device=None` runs there."""
    if isinstance(device, Place):
        dev = to_torch_device(device)
    else:
        name = str(device).lower()
        if name == "cpu":
            dev = torch.device("cpu")
        else:
            kind, _, idx = name.partition(":")
            if kind not in ("gpu", "cuda", "tpu"):
                raise ValueError(f"unknown device {device!r}")
            dev = torch.device("cuda", int(idx) if idx else 0)
    set_default_device(dev)
    return _place_of(dev)


def _place_of(dev):
    return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)


def get_device() -> str:
    """"cpu" or "gpu:i": where device=None runs."""
    dev = torch.device(default_device())
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"
