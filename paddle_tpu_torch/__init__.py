"""PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside `paddle_tpu` (the JAX reference, which it
never imports). Layout mirrors the reference: `core/`, `ops/`, `nn/`,
`text/`, `vision/`, `optimizer/`, `parallel/`, `serving/`, `io/`,
`metric/`, `hapi/`. The attention, int8 matmul, gathered-LoRA and fused
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
"""
from . import hapi, io, metric, nn, optimizer, vision
from .core.device import resolve_device
from .hapi import Model, summary
from .hapi import callbacks
from .io import load, save

__all__ = ["Model", "callbacks", "hapi", "io", "load", "metric", "nn",
           "optimizer", "resolve_device", "save", "summary", "vision"]
