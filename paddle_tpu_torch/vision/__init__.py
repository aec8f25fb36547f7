"""Vision of the port (the JAX package's `vision/`): the models, the
transforms and the dataset parsers."""
from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
