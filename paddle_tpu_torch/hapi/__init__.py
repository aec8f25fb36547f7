"""The high-level API of the port (the JAX package's `hapi`): `Model`,
`summary` and the callbacks."""
from . import callbacks
from .model import Model, summary

__all__ = ["Model", "callbacks", "summary"]
