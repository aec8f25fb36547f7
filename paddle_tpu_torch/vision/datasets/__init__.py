"""Vision datasets (the JAX package's `vision/datasets`, the port's own
copy): the parsers of the reference's file formats over local paths.

  * `FakeData`: synthetic images, each drawn from a numpy seed of its
    index;
  * `MNIST` / `FashionMNIST`: idx-ubyte images and labels, optionally
    gzipped; images float32 [1, 28, 28] in [0, 1];
  * `Cifar10` / `Cifar100`: the tar of python pickles; float32 [3, 32, 32];
  * `DatasetFolder` / `ImageFolder`: one folder a class, samples in
    sorted order; `.npy` files load with numpy, other files through PIL
    where it is installed (a machine without PIL reads `.npy` only).

Nothing is downloaded: a missing path raises the JAX module's error.
Samples are numpy, so a dataset pickles into DataLoader workers.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["FakeData", "MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "DatasetFolder", "ImageFolder"]


class FakeData(Dataset):
    """Synthetic images dataset (deterministic; torchvision-FakeData-like)."""

    def __init__(self, size=1000, image_shape=(3, 224, 224), num_classes=10,
                 transform=None, dtype="float32"):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.dtype = dtype

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx % 65536)
        img = rng.standard_normal(self.image_shape).astype(self.dtype)
        label = np.asarray(idx % self.num_classes, dtype=np.int64)
        if self.transform:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.size


def _require(path, name):
    if path is None or not os.path.exists(path):
        raise RuntimeError(
            f"{name}: no network egress in this environment — pass the "
            f"local data file path explicitly (got {path!r}), or use "
            f"paddle_tpu_torch.vision.datasets.FakeData for synthetic data")


class MNIST(Dataset):
    """idx-ubyte MNIST reader (reference vision/datasets/mnist.py format)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        _require(image_path, "MNIST")
        _require(label_path, "MNIST")
        with gzip.open(image_path, "rb") if image_path.endswith(".gz") \
                else open(image_path, "rb") as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            self.images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                num, 1, rows, cols).astype(np.float32) / 255.0
        with gzip.open(label_path, "rb") if label_path.endswith(".gz") \
                else open(label_path, "rb") as f:
            struct.unpack(">II", f.read(8))
            self.labels = np.frombuffer(f.read(), dtype=np.uint8).astype(
                np.int64)
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


FashionMNIST = MNIST


class Cifar10(Dataset):
    """python-pickle CIFAR reader (reference vision/datasets/cifar.py)."""

    MODE_MAP = {"train": [f"data_batch_{i}" for i in range(1, 6)],
                "test": ["test_batch"]}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        _require(data_file, "Cifar10")
        images, labels = [], []
        with tarfile.open(data_file) as tf:
            for member in tf.getmembers():
                base = os.path.basename(member.name)
                if base in self.MODE_MAP[mode]:
                    d = pickle.load(tf.extractfile(member),
                                    encoding="bytes")
                    images.append(d[b"data"])
                    labels.extend(d.get(b"labels", d.get(b"fine_labels")))
        self.images = np.concatenate(images).reshape(
            -1, 3, 32, 32).astype(np.float32) / 255.0
        self.labels = np.asarray(labels, dtype=np.int64)
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    MODE_MAP = {"train": ["train"], "test": ["test"]}


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        _require(root, "DatasetFolder")
        self.root = root
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                self.samples.append((os.path.join(cdir, fn),
                                     self.class_to_idx[c]))
        self.transform = transform
        self.loader = loader or _default_loader

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"),
                          dtype=np.float32).transpose(2, 0, 1) / 255.0
    except ImportError:
        raise RuntimeError("PIL unavailable; use .npy image files")
