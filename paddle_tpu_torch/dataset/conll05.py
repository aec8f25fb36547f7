"""Legacy paddle.dataset.conll05 (dataset/conll05.py parity)."""
from __future__ import annotations

from ._reader import dataset_reader


def _make(**kw):
    from ..text.datasets import Conll05st

    return Conll05st(**kw)


def get_dict(**kw):
    return _make(**kw).get_dict()


def get_embedding(emb_file=None, **kw):
    return _make(**kw).get_embedding(emb_file)


def test(**kw):
    return dataset_reader(lambda: _make(**kw))
