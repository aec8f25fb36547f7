"""Legacy paddle.dataset.uci_housing (dataset/uci_housing.py parity)."""
from __future__ import annotations

from ._reader import dataset_reader

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS",
                 "RAD", "TAX", "PTRATIO", "B", "LSTAT", "convert"]


def _make(mode, data_file=None):
    from ..text.datasets import UCIHousing

    return UCIHousing(data_file=data_file, mode=mode,
                      download=data_file is None)


def train(data_file=None):
    return dataset_reader(lambda: _make("train", data_file))


def test(data_file=None):
    return dataset_reader(lambda: _make("test", data_file))
