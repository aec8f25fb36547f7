"""Paddle's tensor functions (the JAX package's `tensor/`), exported at
the top level as `paddle.concat`, `paddle.topk`, ... They are plain
functions on torch tensors: the JAX package attaches them to its Tensor
class as methods (`_patch_tensor_methods`), and the port does not patch
`torch.Tensor`."""
from . import ops  # noqa: F401
from .ops import *  # noqa: F401,F403
from .ops import __all__  # noqa: F401
