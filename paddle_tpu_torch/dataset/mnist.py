"""Legacy paddle.dataset.mnist (dataset/mnist.py parity): yields
(flattened normalized image, label) like the fluid-era reader."""
from __future__ import annotations

import numpy as np

from ._reader import dataset_reader


def _make(mode, image_path=None, label_path=None):
    from ..vision.datasets import MNIST

    return MNIST(image_path=image_path, label_path=label_path, mode=mode)


def _flatten(ds):
    def reader():
        for i in range(len(ds)):
            img, lbl = ds[i]
            img = np.asarray(img, np.float32).reshape(-1) / 127.5 - 1.0
            yield img, int(np.asarray(lbl).reshape(-1)[0])

    return reader


def train(image_path=None, label_path=None):
    return _flatten(_make("train", image_path, label_path))


def test(image_path=None, label_path=None):
    return _flatten(_make("test", image_path, label_path))
