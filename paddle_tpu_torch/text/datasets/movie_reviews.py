"""NLTK movie_reviews sentiment dataset (movie_reviews.py parity).

The reference pulls the corpus through nltk; here the corpus zip (or an
extracted directory with pos/ and neg/ subdirs of .txt files) is passed
locally — the port downloads nothing.
"""
from __future__ import annotations

import collections
import os
import zipfile

import numpy as np

from ...io import Dataset


class MovieReviews(Dataset):
    def __init__(self, data_file=None, mode="train"):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        if data_file is None:
            raise RuntimeError(
                "MovieReviews needs data_file (the nltk movie_reviews "
                "corpus zip or an extracted pos/neg directory); this "
                "port downloads nothing")
        self.data_file = data_file
        docs = self._read_docs()
        word_freq = collections.defaultdict(int)
        for words, _ in docs:
            for w in words:
                word_freq[w] += 1
        items = sorted(word_freq.items(), key=lambda x: (-x[1], x[0]))
        self.word_idx = {w: i for i, (w, _) in enumerate(items)}
        # reference: 10% test split interleaved
        data = [([self.word_idx[w] for w in words], label)
                for words, label in docs]
        self.data = [d for i, d in enumerate(data)
                     if (i % 10 == 0) == (self.mode == "test")]

    def _read_docs(self):
        docs = []
        if os.path.isdir(self.data_file):
            for label, sub in ((0, "pos"), (1, "neg")):
                base = os.path.join(self.data_file, sub)
                for fn in sorted(os.listdir(base)):
                    with open(os.path.join(base, fn), "r",
                              errors="ignore") as f:
                        docs.append((f.read().lower().split(), label))
            return docs
        with zipfile.ZipFile(self.data_file) as z:
            for name in sorted(z.namelist()):
                low = name.lower()
                if not low.endswith(".txt"):
                    continue
                label = 0 if "/pos/" in low else (
                    1 if "/neg/" in low else None)
                if label is None:
                    continue
                docs.append(
                    (z.read(name).decode("latin-1").lower().split(),
                     label))
        return docs

    def __getitem__(self, idx):
        ids, label = self.data[idx]
        return np.array(ids), np.array([label])

    def __len__(self):
        return len(self.data)
