"""UCI Housing regression dataset (text/datasets/uci_housing.py parity).

Format: whitespace-separated floats, 14 per row; features normalized by
(x - mean) / (max - min); 80/20 train/test split.
"""
from __future__ import annotations

import numpy as np

from ...io import Dataset
from ...dataset.common import _check_exists_and_download

URL = "https://archive.ics.uci.edu/ml/machine-learning-databases/housing/housing.data"
MD5 = "d4accdce7a25600298819f8e28e8d593"


class UCIHousing(Dataset):
    def __init__(self, data_file=None, mode="train", download=True):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.data_file = _check_exists_and_download(
            data_file, URL, MD5, "uci_housing", download)
        self._load_data()

    def _load_data(self, feature_num=14, ratio=0.8):
        data = np.fromfile(self.data_file, sep=" ")
        data = data.reshape(data.shape[0] // feature_num, feature_num)
        maximums = data.max(axis=0)
        minimums = data.min(axis=0)
        avgs = data.sum(axis=0) / data.shape[0]
        for i in range(feature_num - 1):
            data[:, i] = (data[:, i] - avgs[i]) / \
                (maximums[i] - minimums[i])
        offset = int(data.shape[0] * ratio)
        self.data = data[:offset] if self.mode == "train" else data[offset:]

    def __getitem__(self, idx):
        row = self.data[idx]
        return (np.array(row[:-1]).astype("float32"),
                np.array(row[-1:]).astype("float32"))

    def __len__(self):
        return len(self.data)
