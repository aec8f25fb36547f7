"""paddle.dataset.common parity: data-home plumbing + file helpers.

Reference: python/paddle/dataset/common.py (DATA_HOME, md5file, download,
split/cluster_files_reader). Nothing is downloaded: `download` raises a
clear error directing callers to pass local files instead.
"""
from __future__ import annotations

import glob
import hashlib
import os
import pickle

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def download(url, module_name, md5sum, save_name=None):
    """No download: look in DATA_HOME for an already-placed file; never
    fetch. The reference downloads from bcebos here."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name or url.split("/")[-1].split("%2F")[-1])
    if os.path.exists(filename):
        return filename
    raise RuntimeError(
        f"dataset file {filename!r} not found and the port downloads "
        f"nothing; place the file there manually (source: {url}) "
        f"or pass data_file= to the dataset constructor")


def _check_exists_and_download(path, url, md5, module_name, download_flag):
    if path and os.path.exists(path):
        return path
    if not download_flag:
        raise ValueError(
            f"{path!r} not found and download is disabled; pass a valid "
            f"local path")
    return download(url, module_name, md5)


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """Split a reader's samples into pickled chunk files (common.py:split
    parity — used by cluster data prep)."""
    indx_f = 0
    lines = []
    for i, d in enumerate(reader()):
        lines.append(d)
        if (i + 1) % line_count == 0:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
            lines = []
            indx_f += 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """Read this trainer's shard of chunked files (common.py parity)."""

    def reader():
        flist = sorted(glob.glob(files_pattern))
        my = flist[trainer_id::trainer_count]
        for fn in my:
            with open(fn, "rb") as f:
                for d in loader(f):
                    yield d

    return reader
