"""MovieLens-1M rating dataset (text/datasets/movielens.py parity).

Format: ml-1m.zip with ml-1m/{movies,users,ratings}.dat ('::'-separated,
latin-1). Samples: user fields + movie fields + [rating*2-5].
"""
from __future__ import annotations

import re
import zipfile

import numpy as np

from ...io import Dataset
from ...dataset.common import _check_exists_and_download

URL = "https://dataset.bj.bcebos.com/movielens%2Fml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"

age_table = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self, categories_dict, movie_title_dict):
        return [
            [self.index],
            [categories_dict[c] for c in self.categories],
            [movie_title_dict[w.lower()] for w in self.title.split()],
        ]

    def __repr__(self):
        return (f"<MovieInfo id({self.index}), title({self.title}), "
                f"categories({self.categories})>")


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [[self.index], [0 if self.is_male else 1], [self.age],
                [self.job_id]]

    def __repr__(self):
        return (f"<UserInfo id({self.index}), gender({self.is_male}), "
                f"age({self.age}), job({self.job_id})>")


class Movielens(Dataset):
    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.data_file = _check_exists_and_download(
            data_file, URL, MD5, "sentiment", download)
        self.test_ratio = test_ratio
        np.random.seed(rand_seed)
        self._load_meta_info()
        self._load_data()

    def _load_meta_info(self):
        pattern = re.compile(r"^(.*)\((\d+)\)$")
        self.movie_info = {}
        self.movie_title_dict = {}
        self.categories_dict = {}
        self.user_info = {}
        with zipfile.ZipFile(self.data_file) as package:
            title_word_set = set()
            categories_set = set()
            with package.open("ml-1m/movies.dat") as movie_file:
                for line in movie_file:
                    line = line.decode("latin-1")
                    movie_id, title, categories = line.strip().split("::")
                    categories = categories.split("|")
                    categories_set.update(categories)
                    m = pattern.match(title)
                    title = m.group(1) if m else title
                    self.movie_info[int(movie_id)] = MovieInfo(
                        index=movie_id, categories=categories, title=title)
                    for w in title.split():
                        title_word_set.add(w.lower())
            for i, w in enumerate(sorted(title_word_set)):
                self.movie_title_dict[w] = i
            for i, c in enumerate(sorted(categories_set)):
                self.categories_dict[c] = i
            with package.open("ml-1m/users.dat") as user_file:
                for line in user_file:
                    line = line.decode("latin-1")
                    uid, gender, age, job, _ = line.strip().split("::")
                    self.user_info[int(uid)] = UserInfo(
                        index=uid, gender=gender, age=age, job_id=job)

    def _load_data(self):
        self.data = []
        is_test = self.mode == "test"
        with zipfile.ZipFile(self.data_file) as package:
            with package.open("ml-1m/ratings.dat") as rating:
                for line in rating:
                    line = line.decode("latin-1")
                    if (np.random.random() < self.test_ratio) == is_test:
                        uid, mov_id, r, _ = line.strip().split("::")
                        mov = self.movie_info[int(mov_id)]
                        usr = self.user_info[int(uid)]
                        self.data.append(
                            usr.value() +
                            mov.value(self.categories_dict,
                                      self.movie_title_dict) +
                            [[float(r) * 2 - 5.0]])

    def __getitem__(self, idx):
        return tuple(np.array(d) for d in self.data[idx])

    def __len__(self):
        return len(self.data)
