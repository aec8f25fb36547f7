"""Device resolution for the port's entry points.

Every entry point takes `device=None`, which means the CUDA card. On a
machine without one, asking for the card raises: the port never falls
back to the CPU on its own. Callers who want the CPU (the tests, the
plain reference runs) pass `device="cpu"` explicitly.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_default_device", "default_device"]

#: what device=None means: "cuda" until `paddle.set_device` names another
_DEFAULT = ["cuda"]


def set_default_device(device):
    """Make device=None mean `device` ("cpu", "cuda", "cuda:1"): the
    caller asking for it, as `paddle.set_device("cpu")` does."""
    _DEFAULT[0] = str(torch.device(device))


def default_device():
    """What device=None resolves to ("cuda" unless set)."""
    return _DEFAULT[0]


def resolve_device(device=None):
    """`torch.device` for an entry point's `device=` argument; None
    means "cuda" (or what `set_default_device` named). Raises
    RuntimeError when CUDA is asked for and no card is present."""
    dev = torch.device(_DEFAULT[0] if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:N": name the index so devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
