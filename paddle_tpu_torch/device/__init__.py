"""paddle.device (the JAX package's `device/`): the places, the current
device, the card count and a synchronize."""
import torch

from ..core.place import (CPUPlace, CUDAPlace, TPUPlace,  # noqa: F401
                          accelerator_count, get_device, set_device)

__all__ = ["CPUPlace", "CUDAPlace", "TPUPlace", "get_device", "set_device",
           "get_available_device", "device_count", "synchronize", "cuda"]


def get_available_device():
    return [get_device()]


def device_count():
    return accelerator_count()


def synchronize(device=None):
    """Wait for the card's queued work (no-op without a card)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


class cuda:  # namespace: paddle.device.cuda.*
    @staticmethod
    def device_count():
        return accelerator_count()

    @staticmethod
    def synchronize(device=None):
        synchronize(device)
