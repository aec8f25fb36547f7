"""Optimizers of the port: the functional rules the trainer applies."""
from . import functional

__all__ = ["functional"]
