"""The port's image transforms and dataset parsers against the JAX
package's, on the CPU, in the main process (the random transforms draw
from Python's `random`, which DataLoader workers do not reseed).

Transforms: every class and function of the JAX module on the same
image (CHW and HWC, uint8-valued and [0, 1]) under the same `random`
seed gives the same array, bit for bit (`assert_array_equal`, dtype
included). Parsers: files the test writes (MNIST idx, plain and
gzipped; the CIFAR-10 and CIFAR-100 tars of pickles; a `.npy` folder
and a PNG folder) load to the same arrays and labels in both packages;
a missing path raises the JAX error.
"""
import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest

import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
import paddle_tpu_torch.vision.datasets as TD
import paddle_tpu_torch.vision.transforms as TT


def _img(kind):
    rs = np.random.RandomState({"chw": 1, "hwc": 2, "unit": 3,
                                "gray": 4}[kind])
    if kind == "chw":
        return rs.randint(0, 256, (3, 20, 17)).astype(np.float32)
    if kind == "hwc":
        return rs.randint(0, 256, (19, 22, 3)).astype(np.uint8)
    if kind == "gray":
        return rs.rand(1, 16, 16).astype(np.float32)
    return rs.rand(18, 21).astype(np.float32)


_CASES = {
    "to_tensor": lambda m: m.ToTensor(),
    "to_tensor_hwc": lambda m: m.ToTensor("HWC"),
    "normalize": lambda m: m.Normalize(0.4, 0.2),
    "normalize_hwc": lambda m: m.Normalize(0.5, 0.25, data_format="HWC"),
    "resize_square": lambda m: m.Resize(12),
    "resize_up": lambda m: m.Resize((31, 9), interpolation="bilinear"),
    "center_crop": lambda m: m.CenterCrop(10),
    "center_crop_rect": lambda m: m.CenterCrop((7, 12)),
    "random_crop": lambda m: m.RandomCrop(9),
    "random_crop_pad": lambda m: m.RandomCrop((11, 8), padding=2),
    "hflip": lambda m: m.RandomHorizontalFlip(0.5),
    "vflip": lambda m: m.RandomVerticalFlip(0.7),
    "random_resized_crop": lambda m: m.RandomResizedCrop(14),
    "random_resized_crop_narrow": lambda m: m.RandomResizedCrop(
        (9, 13), scale=(0.5, 0.9), ratio=(0.5, 2.0)),
    "transpose": lambda m: m.Transpose((1, 0)),
}


def _same(make, img):
    """The transform `make(module)` of each package on `img`, four draws
    each from `random.seed(7)`: equal bit for bit, dtype included."""
    outs = []
    for mod in (JT, TT):
        t = make(mod)
        random.seed(7)
        outs.append([np.asarray(t(img)) for _ in range(4)])
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["chw", "hwc", "unit", "gray"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_transform_is_bitwise_the_jax_one(case, kind):
    img = _img(kind)
    if case == "transpose":
        img = img.reshape(img.shape[0], -1)
    _same(_CASES[case], img)


def test_compose_pipeline_is_bitwise_the_jax_one():
    """The training pipeline's shape: HWC uint8 in, CHW float32 out."""
    _same(lambda m: m.Compose([m.ToTensor(), m.RandomResizedCrop(8),
                               m.RandomHorizontalFlip(),
                               m.Normalize([0.5] * 3, [0.5] * 3)]),
          _img("hwc"))


def test_functional_forms_match_jax():
    img = _img("chw")
    _same(lambda m: m.Normalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.25]), img)
    np.testing.assert_array_equal(TT.to_tensor(img), JT.to_tensor(img))
    np.testing.assert_array_equal(TT.normalize(img, 3.0, 2.0),
                                  JT.normalize(img, 3.0, 2.0))
    np.testing.assert_array_equal(TT.resize(img, (5, 7)),
                                  JT.resize(img, (5, 7)))


def test_resize_samples_the_nearest_pixel_whatever_the_interpolation():
    """The JAX quirk the port keeps: "bilinear" is nearest."""
    img = np.arange(16, dtype=np.float32).reshape(1, 4, 4)
    out = TT.Resize(2, interpolation="bilinear")(img)
    np.testing.assert_array_equal(out, img[:, ::2, ::2])


# ---------------------------------------------------------------- parsers

def _idx(path, arr, magic, gz):
    head = struct.pack(">I", magic) + b"".join(
        struct.pack(">I", n) for n in arr.shape)
    data = head + arr.astype(np.uint8).tobytes()
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
        f.write(data)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_parser_matches_jax(tmp_path, gz):
    rs = np.random.RandomState(5)
    imgs = rs.randint(0, 256, (7, 28, 28))
    labels = rs.randint(0, 10, (7,))
    ext = ".gz" if gz else ""
    ip, lp = str(tmp_path / f"img{ext}"), str(tmp_path / f"lbl{ext}")
    _idx(ip, imgs, 2051, gz)
    _idx(lp, labels, 2049, gz)
    for cls in ("MNIST", "FashionMNIST"):
        j, t = getattr(JD, cls)(ip, lp), getattr(TD, cls)(ip, lp)
        assert len(t) == len(j) == 7
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)
        for i in (0, 6):
            for a, b in zip(t[i], j[i]):
                np.testing.assert_array_equal(a, b)
    assert t.images.shape == (7, 1, 28, 28) and t.images.dtype == np.float32


def _cifar_tar(path, names, label_key):
    rs = np.random.RandomState(6)
    with tarfile.open(path, "w:gz") as tf:
        for name in names:
            d = {b"data": rs.randint(0, 256, (3, 3072)).astype(np.uint8),
                 label_key: rs.randint(0, 10, 3).tolist()}
            raw = pickle.dumps(d)
            info = tarfile.TarInfo(f"cifar/{name}")
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))


@pytest.mark.parametrize("cls,names,key,mode", [
    ("Cifar10", ["data_batch_1", "data_batch_2", "test_batch"], b"labels",
     "train"),
    ("Cifar10", ["data_batch_1", "test_batch"], b"labels", "test"),
    ("Cifar100", ["train", "test"], b"fine_labels", "train"),
])
def test_cifar_parsers_match_jax(tmp_path, cls, names, key, mode):
    path = str(tmp_path / "cifar.tar.gz")
    _cifar_tar(path, names, key)
    j = getattr(JD, cls)(path, mode=mode)
    t = getattr(TD, cls)(path, mode=mode)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.images.shape[1:] == (3, 32, 32) and len(t) == len(j)


def test_dataset_folder_npy_and_png_match_jax(tmp_path):
    rs = np.random.RandomState(8)
    for c in ("b", "a"):
        os.makedirs(tmp_path / "npy" / c)
        for i in range(3):
            np.save(tmp_path / "npy" / c / f"{i}.npy",
                    rs.randint(0, 256, (6, 5, 3)).astype(np.uint8))
    j = JD.DatasetFolder(str(tmp_path / "npy"))
    t = TD.DatasetFolder(str(tmp_path / "npy"),
                         transform=TT.Compose([TT.ToTensor()]))
    assert t.class_to_idx == j.class_to_idx == {"a": 0, "b": 1}
    assert [s[1] for s in t.samples] == [s[1] for s in j.samples]
    img, lab = t[4]
    np.testing.assert_array_equal(img, JT.ToTensor()(j[4][0]))
    assert lab == j[4][1] == 1
    from PIL import Image

    os.makedirs(tmp_path / "png" / "x")
    Image.fromarray(rs.randint(0, 256, (4, 6, 3)).astype(np.uint8)).save(
        tmp_path / "png" / "x" / "0.png")
    np.testing.assert_array_equal(TD.ImageFolder(str(tmp_path / "png"))[0][0],
                                  JD.ImageFolder(str(tmp_path / "png"))[0][0])


def test_fake_data_matches_jax_and_missing_paths_raise(tmp_path):
    j = JD.FakeData(5, (3, 8, 8), 4)
    t = TD.FakeData(5, (3, 8, 8), 4, transform=TT.Normalize(0.5, 2.0))
    for i in range(5):
        np.testing.assert_array_equal(t[i][0],
                                      JT.Normalize(0.5, 2.0)(j[i][0]))
        assert t[i][1] == j[i][1]
    for ctor in (lambda m: m.MNIST(None, None),
                 lambda m: m.Cifar10(str(tmp_path / "none.tar")),
                 lambda m: m.DatasetFolder(str(tmp_path / "none"))):
        for mod in (JD, TD):
            with pytest.raises(RuntimeError, match="no network egress"):
                ctor(mod)
