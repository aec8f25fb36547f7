"""PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside `paddle_tpu` (the JAX reference, which it
never imports). Layout mirrors the reference: `core/`, `ops/`, `nn/`,
`text/`, `vision/`, `optimizer/`, `parallel/`, `distributed/`,
`serving/`, `io/`, `metric/`, `hapi/`, `tensor/`, `autograd/`,
`sparse/`, `distribution/`, `slim/`, `device/`, `utils/`, `dataset/`,
`fluid/`, `static/`, `inference/` (the static graph).
The attention, int8 matmul, gathered-LoRA and fused 1x1-conv +
BatchNorm kernels are hand-written CUDA C++ in `csrc/`, built
with nvcc at first use (`ops/_build.py`). Entry points run on the CUDA
card unless the caller passes `device="cpu"`, where the kernels' plain
PyTorch versions run instead.

The high-level API, as in the JAX package:

    import paddle_tpu_torch as paddle
    model = paddle.Model(paddle.vision.models.LeNet())
    model.prepare(paddle.optimizer.Adam(1e-3, parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    model.fit(train_dataset, epochs=2, batch_size=64)

The tensor functions sit at the top level as in Paddle (`paddle.concat`,
`paddle.topk`, `paddle.to_tensor`, ...; `tensor/`), with `ParamAttr`
and the dtype names; they are plain functions, and `torch.Tensor` is
not patched.
"""
from . import (autograd, dataset, device, distributed, distribution, fluid,
               hapi, inference, io, metric, nn, optimizer, parallel, slim,
               sparse, static, tensor, text, utils, vision)
from .autograd import enable_grad, grad, is_grad_enabled, no_grad
from .core.device import resolve_device
from .core.dtypes import get_default_dtype, set_default_dtype
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace,
                         XPUPlace, get_device, is_compiled_with_cuda,
                         is_compiled_with_tpu, is_compiled_with_xpu,
                         set_device)
from .core.random import get_seed, seed
from .framework import (disable_static, enable_static, in_dygraph_mode,
                        in_dynamic_mode)
from .hapi import Model, summary
from .hapi import callbacks
from .io import load, save
from .nn.layer.layers import ParamAttr
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_names
from .utils.flags import get_flags, set_flags
from torch import Tensor  # noqa: E402
from torch import bool as bool_  # noqa: E402
from torch import (bfloat16, complex64, complex128, float16,  # noqa: E402
                   float32, float64, int8, int16, int32, int64, uint8)

__all__ = ["Model", "ParamAttr", "callbacks", "distributed",
           "get_default_dtype", "hapi", "io", "load", "metric", "nn",
           "optimizer", "parallel", "resolve_device",
           "save", "set_default_dtype", "summary", "tensor", "vision",
           "autograd", "dataset", "device", "distribution", "slim",
           "sparse", "text", "utils", "grad", "no_grad", "enable_grad",
           "is_grad_enabled", "seed", "get_seed", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "TPUPlace", "XPUPlace", "set_device",
           "get_device", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "is_compiled_with_xpu", "get_flags", "set_flags", "Tensor",
           "enable_static", "disable_static", "in_dynamic_mode",
           "in_dygraph_mode", "fluid", "static", "inference",
           "bool_", "bfloat16", "float16", "float32", "float64", "int8",
           "int16", "int32", "int64", "uint8", "complex64",
           "complex128"] + list(_tensor_names)

