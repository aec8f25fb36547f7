"""Legacy paddle.dataset.imdb (dataset/imdb.py parity)."""
from __future__ import annotations

from ._reader import dataset_reader

_CACHE = {}


def _make(mode, data_file=None, cutoff=150):
    from ..text.datasets import Imdb

    key = (mode, data_file, cutoff)
    if key not in _CACHE:  # one tar scan per (mode, cutoff), not per epoch
        _CACHE[key] = Imdb(data_file=data_file, mode=mode, cutoff=cutoff,
                           download=data_file is None)
    return _CACHE[key]


def word_dict(data_file=None, cutoff=150):
    return _make("train", data_file, cutoff).word_idx


def train(word_idx=None, data_file=None, cutoff=150):
    return dataset_reader(lambda: _make("train", data_file, cutoff))


def test(word_idx=None, data_file=None, cutoff=150):
    return dataset_reader(lambda: _make("test", data_file, cutoff))
