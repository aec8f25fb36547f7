"""IMDB sentiment dataset (text/datasets/imdb.py parity).

Format: aclImdb_v1.tar.gz with aclImdb/{train,test}/{pos,neg}/*.txt;
word dictionary built from the TRAIN split with a frequency cutoff,
'<unk>' appended last; labels: pos=0, neg=1.
"""
from __future__ import annotations

import collections
import re
import string
import tarfile

import numpy as np

from ...io import Dataset
from ...dataset.common import _check_exists_and_download

URL = "https://dataset.bj.bcebos.com/imdb%2FaclImdb_v1.tar.gz"
MD5 = "7c2ac02c03563afcf9b574c7e56c153a"


class Imdb(Dataset):
    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.data_file = _check_exists_and_download(
            data_file, URL, MD5, "imdb", download)
        self.word_idx = self._build_word_dict(cutoff)
        self._load_anno()

    def _tokenize(self, pattern):
        data = []
        trans = str.maketrans("", "", string.punctuation)
        with tarfile.open(self.data_file) as tarf:
            tf = tarf.next()
            while tf is not None:
                if bool(pattern.match(tf.name)):
                    data.append(
                        tarf.extractfile(tf).read().decode(
                            "latin-1").lower().translate(trans).split())
                tf = tarf.next()
        return data

    def _build_word_dict(self, cutoff):
        pattern = re.compile(r"aclImdb/train/.*\.txt$")
        word_freq = collections.defaultdict(int)
        for doc in self._tokenize(pattern):
            for word in doc:
                word_freq[word] += 1
        word_freq = [(k, v) for k, v in word_freq.items() if v > cutoff]
        dictionary = sorted(word_freq, key=lambda x: (-x[1], x[0]))
        words, _ = list(zip(*dictionary)) if dictionary else ((), ())
        word_idx = dict(zip(words, range(len(words))))
        word_idx["<unk>"] = len(words)
        return word_idx

    def _load_anno(self):
        pos = re.compile(rf"aclImdb/{self.mode}/pos/.*\.txt$")
        neg = re.compile(rf"aclImdb/{self.mode}/neg/.*\.txt$")
        unk = self.word_idx["<unk>"]
        self.docs, self.labels = [], []
        for doc in self._tokenize(pos):
            self.docs.append([self.word_idx.get(w, unk) for w in doc])
            self.labels.append(0)
        for doc in self._tokenize(neg):
            self.docs.append([self.word_idx.get(w, unk) for w in doc])
            self.labels.append(1)

    def __getitem__(self, idx):
        return (np.array(self.docs[idx]), np.array([self.labels[idx]]))

    def __len__(self):
        return len(self.docs)
