"""Legacy paddle.dataset.wmt16 (dataset/wmt16.py parity)."""
from __future__ import annotations

from ._reader import dataset_reader


def _make(mode, src_dict_size, trg_dict_size, src_lang, data_file=None):
    from ..text.datasets import WMT16

    return WMT16(data_file=data_file, mode=mode,
                 src_dict_size=src_dict_size, trg_dict_size=trg_dict_size,
                 lang=src_lang, download=data_file is None)


def train(src_dict_size, trg_dict_size, src_lang="en", data_file=None):
    return dataset_reader(
        lambda: _make("train", src_dict_size, trg_dict_size, src_lang,
                      data_file))


def test(src_dict_size, trg_dict_size, src_lang="en", data_file=None):
    return dataset_reader(
        lambda: _make("test", src_dict_size, trg_dict_size, src_lang,
                      data_file))


def validation(src_dict_size, trg_dict_size, src_lang="en", data_file=None):
    return dataset_reader(
        lambda: _make("val", src_dict_size, trg_dict_size, src_lang,
                      data_file))


def get_dict(lang, dict_size, reverse=False, data_file=None):
    return _make("train", dict_size, dict_size, "en",
                 data_file).get_dict(lang, reverse)
