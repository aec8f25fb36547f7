"""Image transforms (the JAX package's `vision/transforms`, the port's own
copy): numpy in, numpy out, on CHW or HWC images, with the same results
bit for bit as the JAX module on the same input and the same Python
`random` state. A transform runs where the dataset runs: in a DataLoader
worker or in the main process, never on the card.

Quirks kept from the JAX module, so that the two agree:
  * `Resize` (and `RandomResizedCrop`, which calls it) samples the
    nearest pixel whatever `interpolation` says, "bilinear" included;
  * an image counts as CHW when it has three axes and the first is 1, 3
    or 4 long, else as HWC;
  * `ToTensor` divides by 255 only when the image's largest value
    exceeds 1.5;
  * the random transforms draw from Python's `random` module, which the
    DataLoader's workers do not reseed (they reseed numpy only): crops
    and flips taken in workers are not reproducible, in either package.
"""
from __future__ import annotations

import numbers
import random

import numpy as np

__all__ = ["Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "RandomResizedCrop", "Transpose",
           "to_tensor", "normalize", "resize"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img, dtype=np.float32)
        if arr.ndim == 3 and arr.shape[-1] in (1, 3, 4) and \
                self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, dtype=np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize(BaseTransform):
    """Nearest-pixel resize to `size`; `interpolation` is accepted and
    not applied (the JAX module's behaviour)."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)

    def _apply_image(self, img):
        img = np.asarray(img, dtype=np.float32)
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        if chw:
            c, h, w = img.shape
        else:
            h, w = img.shape[:2]
        oh, ow = self.size
        yi = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0,
                     h - 1).astype(np.int64)
        xi = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0,
                     w - 1).astype(np.int64)
        if chw:
            return img[:, yi][:, :, xi]
        return img[yi][:, xi]


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        h, w = (img.shape[1:] if chw else img.shape[:2])
        th, tw = self.size
        i = max(0, (h - th) // 2)
        j = max(0, (w - tw) // 2)
        return img[:, i:i + th, j:j + tw] if chw else \
            img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None):
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        if self.padding:
            p = self.padding
            pads = [(0, 0), (p, p), (p, p)] if chw else \
                [(p, p), (p, p)] + ([(0, 0)] if img.ndim == 3 else [])
            img = np.pad(img, pads)
        h, w = (img.shape[1:] if chw else img.shape[:2])
        th, tw = self.size
        i = random.randint(0, max(0, h - th))
        j = random.randint(0, max(0, w - tw))
        return img[:, i:i + th, j:j + tw] if chw else \
            img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
            return img[:, :, ::-1].copy() if chw else img[:, ::-1].copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
            return img[:, ::-1].copy() if chw else img[::-1].copy()
        return img


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3)):
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size)

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        h, w = (img.shape[1:] if chw else img.shape[:2])
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            tw = int(round((target * ar) ** 0.5))
            th = int(round((target / ar) ** 0.5))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                crop = img[:, i:i + th, j:j + tw] if chw else \
                    img[i:i + th, j:j + tw]
                return self._resize._apply_image(crop)
        return self._resize._apply_image(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        return np.asarray(img).transpose(self.order)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)
