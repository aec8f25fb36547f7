"""Training drivers of the port: the one-device train step."""
from .spmd import SpmdTrainer

__all__ = ["SpmdTrainer"]
