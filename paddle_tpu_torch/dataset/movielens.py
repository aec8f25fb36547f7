"""Legacy paddle.dataset.movielens (dataset/movielens.py parity)."""
from __future__ import annotations

from ..text.datasets.movielens import (MovieInfo, UserInfo,  # noqa: F401
                                       age_table)
from ._reader import dataset_reader


def _make(mode, data_file=None):
    from ..text.datasets import Movielens

    return Movielens(data_file=data_file, mode=mode,
                     download=data_file is None)


def train(data_file=None):
    return dataset_reader(lambda: _make("train", data_file))


def test(data_file=None):
    return dataset_reader(lambda: _make("test", data_file))


def get_movie_title_dict(data_file=None):
    return _make("train", data_file).movie_title_dict


def max_movie_id(data_file=None):
    return max(_make("train", data_file).movie_info)


def max_user_id(data_file=None):
    return max(_make("train", data_file).user_info)


def movie_categories(data_file=None):
    return _make("train", data_file).categories_dict
