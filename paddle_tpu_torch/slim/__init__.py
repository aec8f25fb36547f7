"""paddle.slim (the JAX package's `slim/`): quantization-aware training
on eager layers (`slim/quant.py`); post-training quantization waits for
the port's static stack and raises."""
from .quant import (ImperativeQuantAware, PostTrainingQuantization,
                    quant_post_static)

__all__ = ["PostTrainingQuantization", "quant_post_static",
           "ImperativeQuantAware"]
