"""WMT14/WMT16 machine-translation datasets (wmt14.py / wmt16.py parity).

WMT14 format: tar with {train,test,gen}/{train,test,gen} tab-separated
src\ttrg lines plus *src.dict / *trg.dict vocabulary members (first
dict_size lines).
WMT16 format: tar with wmt16/{train,val,test} tab-separated en\tde
lines; dictionaries BUILT from the train corpus by frequency with
<s>/<e>/<unk> reserved.
"""
from __future__ import annotations

import collections
import os
import tarfile

import numpy as np

from ...io import Dataset
from ...dataset import common
from ...dataset.common import _check_exists_and_download

WMT14_URL = ("http://paddlemodels.bj.bcebos.com/wmt/wmt14.tgz")
WMT14_MD5 = "0791583d57d5beb693b9414c5b36798c"
WMT16_URL = ("http://paddlemodels.bj.bcebos.com/wmt/wmt16.tar.gz")
WMT16_MD5 = "0c38be43600334966403524a40dcd81e"

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2


class WMT14(Dataset):
    def __init__(self, data_file=None, mode="train", dict_size=-1,
                 download=True):
        assert mode.lower() in ("train", "test", "gen"), mode
        self.mode = mode.lower()
        self.data_file = _check_exists_and_download(
            data_file, WMT14_URL, WMT14_MD5, "wmt14", download)
        self.dict_size = dict_size if dict_size > 0 else 2 ** 31 - 1
        self._load_data()

    def _load_data(self):
        def to_dict(fd, size):
            out = {}
            for i, line in enumerate(fd):
                if i >= size:
                    break
                out[line.strip().decode("utf-8")] = i
            return out

        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as f:
            src_names = [m.name for m in f if m.name.endswith("src.dict")]
            trg_names = [m.name for m in f if m.name.endswith("trg.dict")]
            assert len(src_names) == 1 and len(trg_names) == 1
            self.src_dict = to_dict(f.extractfile(src_names[0]),
                                    self.dict_size)
            self.trg_dict = to_dict(f.extractfile(trg_names[0]),
                                    self.dict_size)
            fname = f"{self.mode}/{self.mode}"
            for name in [m.name for m in f if m.name.endswith(fname)]:
                for line in f.extractfile(name):
                    parts = line.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_words = parts[0].split()
                    src_ids = [self.src_dict.get(w, UNK_IDX)
                               for w in [START] + src_words + [END]]
                    trg_words = parts[1].split()
                    trg_ids = [self.trg_dict.get(w, UNK_IDX)
                               for w in trg_words]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    self.src_ids.append(src_ids)
                    self.trg_ids.append([self.trg_dict[START]] + trg_ids)
                    self.trg_ids_next.append(trg_ids +
                                             [self.trg_dict[END]])

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)

    def get_dict(self, reverse=False):
        if reverse:
            return ({v: k for k, v in self.src_dict.items()},
                    {v: k for k, v in self.trg_dict.items()})
        return self.src_dict, self.trg_dict


class WMT16(Dataset):
    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=True):
        assert mode.lower() in ("train", "test", "val"), mode
        assert lang in ("en", "de"), lang
        self.mode = mode.lower()
        self.lang = lang
        self.data_file = _check_exists_and_download(
            data_file, WMT16_URL, WMT16_MD5, "wmt16", download)
        self.src_dict_size = self._bounded(src_dict_size)
        self.trg_dict_size = self._bounded(trg_dict_size)
        self.src_dict = self._load_dict(lang, self.src_dict_size)
        self.trg_dict = self._load_dict(
            "de" if lang == "en" else "en", self.trg_dict_size)
        self._load_data()

    @staticmethod
    def _bounded(n):
        return n if n > 0 else 2 ** 31 - 1

    def _dict_path(self, lang, size):
        import hashlib

        base = os.path.join(
            os.path.expanduser(os.environ.get(
                "PADDLE_TPU_DATA_HOME", common.DATA_HOME)), "wmt16")
        os.makedirs(base, exist_ok=True)
        # key the cache on the CORPUS identity too: two different tars
        # must never share a vocabulary file
        st = os.stat(self.data_file)
        tag = hashlib.md5(
            f"{os.path.abspath(self.data_file)}:{st.st_size}:"
            f"{int(st.st_mtime)}".encode()).hexdigest()[:10]
        return os.path.join(base, f"{lang}_dict_{size}_{tag}.txt")

    def _load_dict(self, lang, size):
        path = self._dict_path(lang, size)
        if not os.path.exists(path):
            self._build_dict(path, size, lang)
        d = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                d[line.strip()] = i
        return d

    def _build_dict(self, path, size, lang):
        freq = collections.defaultdict(int)
        col = 0 if lang == "en" else 1
        with tarfile.open(self.data_file) as f:
            for line in f.extractfile("wmt16/train"):
                parts = line.decode("utf-8").strip().split("\t")
                if len(parts) != 2:
                    continue
                for w in parts[col].split():
                    freq[w] += 1
        with open(path, "w", encoding="utf-8") as out:
            out.write(f"{START}\n{END}\n{UNK}\n")
            for i, (word, _) in enumerate(sorted(
                    freq.items(), key=lambda x: (-x[1], x[0]))):
                if i + 3 >= size:
                    break
                out.write(word + "\n")

    def _load_data(self):
        start_id = self.src_dict[START]
        end_id = self.src_dict[END]
        unk_id = self.src_dict[UNK]
        src_col = 0 if self.lang == "en" else 1
        trg_col = 1 - src_col
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as f:
            for line in f.extractfile(f"wmt16/{self.mode}"):
                parts = line.decode("utf-8").strip().split("\t")
                if len(parts) != 2:
                    continue
                src_ids = [start_id] + [
                    self.src_dict.get(w, unk_id)
                    for w in parts[src_col].split()] + [end_id]
                trg_words = parts[trg_col].split()
                trg_ids = [self.trg_dict.get(w, unk_id)
                           for w in trg_words]
                self.src_ids.append(src_ids)
                self.trg_ids.append([start_id] + trg_ids)
                self.trg_ids_next.append(trg_ids + [end_id])

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)

    def get_dict(self, lang, reverse=False):
        d = self.src_dict if lang == self.lang else self.trg_dict
        return {v: k for k, v in d.items()} if reverse else d
