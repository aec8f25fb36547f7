"""The port's ResNet-50 against the JAX package's, on the CPU: a JAX
`resnet50(num_classes=10)` `state_dict()` (parameters and BN buffers)
loads into the port's through `convert.from_jax_state`, name for name.

Tolerances at 2 x 3 x 64 x 64: logits within 1e-4 (eval) and 5e-4
(train: each BN normalizes by a batch variance over as few as 8 values,
2 images x 2 x 2 positions in the last stage, which amplifies fifty
layers of reordered float32 sums; the JAX stem conv at this size is an
im2col einsum, the port's `F.conv2d`) of their largest entry; each
running-stat buffer within 1e-4 of its largest entry.
"""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.vision.models import resnet50 as jax_resnet50
from paddle_tpu_torch import convert
from paddle_tpu_torch.vision.models import resnet50

torch.set_num_threads(2)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np_state(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def test_resnet50_from_jax_state_matches_in_eval_and_train():
    """A JAX ResNet-50 (one train forward in, so its running stats are
    not the initial 0 / 1) loads name for name, buffers included; the
    logits agree in eval and in train mode, and so do the running stats
    the train forward leaves."""
    paddle.seed(0)
    jm = jax_resnet50(num_classes=10)
    x1, x2 = _rand((2, 3, 64, 64), 20), _rand((2, 3, 64, 64), 21)
    jm.train()
    jm(paddle.to_tensor(x1))
    sd = _np_state(jm)
    model = resnet50(num_classes=10, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(convert.from_jax_state(sd), strict=True)
    for mode, tol in (("eval", 1e-4), ("train", 5e-4)):
        getattr(jm, mode)()
        getattr(model, mode)()
        want = np.asarray(jm(paddle.to_tensor(x2))._data)
        with torch.no_grad():
            got = model(torch.tensor(x2)).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=tol, err_msg=mode)
    jsd = _np_state(jm)
    for name, t in model.state_dict().items():
        if name.endswith(("_mean", "_variance")):
            err = np.abs(t.numpy() - jsd[name]).max()
            assert err <= 1e-4 * np.abs(jsd[name]).max(), (name, err)
