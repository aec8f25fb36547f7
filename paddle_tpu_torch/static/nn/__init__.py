"""paddle.static.nn (the JAX package's `static/nn`)."""
from ...fluid.layers.nn import (batch_norm, conv2d, embedding, fc,  # noqa
                                layer_norm)
from ...fluid.layers.nn import pool2d  # noqa: F401
