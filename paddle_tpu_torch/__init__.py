"""PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside `paddle_tpu` (the JAX reference, which it
never imports). Layout mirrors the reference: `core/`, `ops/`, `nn/`,
`text/`, `vision/`, `optimizer/`, `parallel/`, `distributed/`,
`serving/`, `io/`, `metric/`, `hapi/`, `tensor/`. The attention, int8 matmul, gathered-LoRA and fused
1x1-conv + BatchNorm kernels are hand-written CUDA C++ in `csrc/`, built
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
from . import (distributed, hapi, io, metric, nn, optimizer, parallel,
               tensor, vision)
from .core.device import resolve_device
from .core.dtypes import get_default_dtype, set_default_dtype
from .hapi import Model, summary
from .hapi import callbacks
from .io import load, save
from .nn.layer.layers import ParamAttr
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_names
from torch import bool as bool_  # noqa: E402
from torch import (bfloat16, float16, float32, float64, int8, int16,  # noqa
                   int32, int64, uint8)

__all__ = ["Model", "ParamAttr", "callbacks", "distributed",
           "get_default_dtype", "hapi", "io", "load", "metric", "nn",
           "optimizer", "parallel", "resolve_device",
           "save", "set_default_dtype", "summary", "tensor", "vision",
           "bool_", "bfloat16", "float16", "float32", "float64", "int8",
           "int16", "int32", "int64", "uint8"] + list(_tensor_names)
