"""Vision models of the port (the JAX package's `vision/`)."""
from . import models

__all__ = ["models"]
