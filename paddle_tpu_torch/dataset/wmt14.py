"""Legacy paddle.dataset.wmt14 (dataset/wmt14.py parity)."""
from __future__ import annotations

from ._reader import dataset_reader


def _make(mode, dict_size, data_file=None):
    from ..text.datasets import WMT14

    return WMT14(data_file=data_file, mode=mode, dict_size=dict_size,
                 download=data_file is None)


def train(dict_size, data_file=None):
    return dataset_reader(lambda: _make("train", dict_size, data_file))


def test(dict_size, data_file=None):
    return dataset_reader(lambda: _make("test", dict_size, data_file))


def gen(dict_size, data_file=None):
    return dataset_reader(lambda: _make("gen", dict_size, data_file))


def get_dict(dict_size, reverse=True, data_file=None):
    return _make("train", dict_size, data_file).get_dict(reverse)
