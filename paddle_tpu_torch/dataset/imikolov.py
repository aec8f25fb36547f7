"""Legacy paddle.dataset.imikolov (dataset/imikolov.py parity)."""
from __future__ import annotations

from ._reader import dataset_reader

_CACHE = {}


def _make(mode, data_type, window_size, data_file=None, min_word_freq=50):
    from ..text.datasets import Imikolov

    key = (mode, data_type, window_size, data_file, min_word_freq)
    if key not in _CACHE:
        _CACHE[key] = Imikolov(
            data_file=data_file, data_type=data_type,
            window_size=window_size, mode=mode,
            min_word_freq=min_word_freq, download=data_file is None)
    return _CACHE[key]


def build_dict(min_word_freq=50, data_file=None):
    return _make("train", "SEQ", -1, data_file, min_word_freq).word_idx


def train(word_idx=None, n=5, data_type="NGRAM", data_file=None,
          min_word_freq=50):
    return dataset_reader(
        lambda: _make("train", data_type, n, data_file, min_word_freq))


def test(word_idx=None, n=5, data_type="NGRAM", data_file=None,
         min_word_freq=50):
    return dataset_reader(
        lambda: _make("test", data_type, n, data_file, min_word_freq))
