"""Vision of the port (the JAX package's `vision/`): the models, the
transforms, the dataset parsers and the detection operators (`ops`)."""
from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms"]
