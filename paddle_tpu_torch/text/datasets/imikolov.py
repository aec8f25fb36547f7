"""PTB language-model dataset (text/datasets/imikolov.py parity).

Format: simple-examples tar with ./simple-examples/data/ptb.{train,valid}
.txt; word dict from train+valid with min frequency, '<s>'/'<e>' counted
per line, '<unk>' last; samples are NGRAMs (window_size) or full SEQs.
"""
from __future__ import annotations

import collections
import tarfile

import numpy as np

from ...io import Dataset
from ...dataset.common import _check_exists_and_download

URL = "https://dataset.bj.bcebos.com/imikolov%2Fsimple-examples.tgz"
MD5 = "30177ea32e27c525793142b6bf2c8e2d"


class Imikolov(Dataset):
    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, download=True):
        assert data_type.upper() in ("NGRAM", "SEQ"), data_type
        self.data_type = data_type.upper()
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.window_size = window_size
        self.min_word_freq = min_word_freq
        self.data_file = _check_exists_and_download(
            data_file, URL, MD5, "imikolov", download)
        self.word_idx = self._build_word_dict(min_word_freq)
        self._load_anno()

    @staticmethod
    def _word_count(f, word_freq=None):
        if word_freq is None:
            word_freq = collections.defaultdict(int)
        for line in f:
            for w in line.strip().split():
                word_freq[w] += 1
            word_freq["<s>"] += 1
            word_freq["<e>"] += 1
        return word_freq

    def _build_word_dict(self, cutoff):
        train_fn = "./simple-examples/data/ptb.train.txt"
        valid_fn = "./simple-examples/data/ptb.valid.txt"
        with tarfile.open(self.data_file) as tf:
            freq = self._word_count(
                _text(tf.extractfile(valid_fn)),
                self._word_count(_text(tf.extractfile(train_fn))))
            freq.pop("<unk>", None)
            freq = [x for x in freq.items() if x[1] > cutoff]
            dictionary = sorted(freq, key=lambda x: (-x[1], x[0]))
            words, _ = list(zip(*dictionary)) if dictionary else ((), ())
            word_idx = dict(zip(words, range(len(words))))
            word_idx["<unk>"] = len(words)
        return word_idx

    def _load_anno(self):
        fn = "./simple-examples/data/ptb.{}.txt".format(
            "train" if self.mode == "train" else "valid")
        self.data = []
        with tarfile.open(self.data_file) as tf:
            unk = self.word_idx["<unk>"]
            for line in _text(tf.extractfile(fn)):
                if self.data_type == "NGRAM":
                    assert self.window_size > -1, \
                        "NGRAM mode needs window_size > 0"
                    words = ["<s>"] + line.strip().split() + ["<e>"]
                    if len(words) < self.window_size:
                        continue
                    ids = [self.word_idx.get(w, unk) for w in words]
                    for i in range(self.window_size, len(ids) + 1):
                        self.data.append(
                            tuple(ids[i - self.window_size:i]))
                else:
                    words = ["<s>"] + line.strip().split() + ["<e>"]
                    ids = [self.word_idx.get(w, unk) for w in words]
                    self.data.append((ids[:-1], ids[1:]))

    def __getitem__(self, idx):
        return tuple(np.array(d) for d in self.data[idx])

    def __len__(self):
        return len(self.data)


def _text(f):
    for line in f:
        yield line.decode("utf-8") if isinstance(line, bytes) else line
