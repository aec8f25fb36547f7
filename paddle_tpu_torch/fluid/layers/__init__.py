"""fluid.layers (reference: python/paddle/fluid/layers/; the JAX package's
fluid/layers). The tensor, math and nn builders are ported; the
control-flow, sequence and detection builders raise until ROADMAP item 8b.
"""
from . import detection  # noqa: F401
from .control_flow import *  # noqa: F401,F403
from .math_ops import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .tensor import data  # noqa: F401
