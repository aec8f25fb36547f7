"""The port's `text` additions and `dataset/` against the JAX package's, on
the CPU (the counterpart of `tests/test_text_datasets.py`, whose fixture
writers it reuses: each archive is written here in the on-disk format
the reference downloads).

Every parser (Imdb, Imikolov, Movielens, MovieReviews, UCIHousing,
WMT14, WMT16, Conll05st) gives the JAX parser's items, array for array,
and its dictionaries; the legacy `dataset` readers yield the JAX
readers' samples; `common.download` raises as in JAX; `FakeTextDataset`
gives the JAX items; `ernie_tiny` and `ernie_base` loaded from the JAX
models' states give their outputs within 1e-5 (float32, reordered sums).
"""
import os
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.dataset as jdataset
import paddle_tpu.text as jtext
import paddle_tpu_torch.dataset as tdataset
import paddle_tpu_torch.text as ttext
from test_text_datasets import (conll_fixture, imdb_tar,  # noqa: F401
                                ml1m_zip, ptb_tar, wmt14_tar, _add_bytes)

torch.set_num_threads(2)

from _torch_parity import keep_global_rng  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("keep_global_rng")


def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        x = x if isinstance(x, (tuple, list)) else (x,)
        y = y if isinstance(y, (tuple, list)) else (y,)
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_imdb_imikolov_movielens(imdb_tar, ptb_tar, ml1m_zip):  # noqa
    for mode in ("train", "test"):
        _same_items(ttext.Imdb(data_file=imdb_tar, mode=mode, cutoff=1),
                    jtext.Imdb(data_file=imdb_tar, mode=mode, cutoff=1))
    for kw in (dict(data_type="NGRAM", window_size=2),
               dict(data_type="SEQ", window_size=-1)):
        t = ttext.Imikolov(data_file=ptb_tar, mode="train",
                           min_word_freq=2, **kw)
        j = jtext.Imikolov(data_file=ptb_tar, mode="train",
                           min_word_freq=2, **kw)
        assert t.word_idx == j.word_idx
        _same_items(t, j)
    for mode in ("train", "test"):
        kw = dict(data_file=ml1m_zip, mode=mode, test_ratio=0.2, rand_seed=0)
        _same_items(ttext.Movielens(**kw), jtext.Movielens(**kw))
    assert tdataset.movielens.max_movie_id(data_file=ml1m_zip) == \
        jdataset.movielens.max_movie_id(data_file=ml1m_zip)
    for name, mod_t, mod_j, kw in (
            ("imdb", tdataset.imdb, jdataset.imdb,
             dict(data_file=imdb_tar)),
            ("movielens", tdataset.movielens, jdataset.movielens,
             dict(data_file=ml1m_zip))):
        got = list(mod_t.train(**kw)())
        want = list(mod_j.train(**kw)())
        assert len(got) == len(want) > 0, name
        for a, b in zip(got, want):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_uci_housing_wmt_conll(tmp_path, wmt14_tar, conll_fixture,  # noqa
                               monkeypatch):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "housing.data")
    with open(path, "w") as f:
        for row in rng.rand(50, 14) * 10:
            f.write(" ".join(f"{v:.4f}" for v in row) + "\n")
    for mode in ("train", "test"):
        _same_items(ttext.UCIHousing(data_file=path, mode=mode),
                    jtext.UCIHousing(data_file=path, mode=mode))
    for mode in ("train", "test"):
        _same_items(ttext.WMT14(data_file=wmt14_tar, mode=mode, dict_size=5),
                    jtext.WMT14(data_file=wmt14_tar, mode=mode, dict_size=5))
    import tarfile

    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path / "home"))
    w16 = str(tmp_path / "wmt16.tar.gz")
    train = b"the cat\tdie katze\nthe dog\tder hund\nthe cat\tdie katze\n"
    with tarfile.open(w16, "w:gz") as tf:
        for part in ("train", "val", "test"):
            _add_bytes(tf, f"wmt16/{part}", train)
    kw = dict(data_file=w16, mode="train", src_dict_size=10,
              trg_dict_size=10, lang="en")
    t, j = ttext.WMT16(**kw), jtext.WMT16(**kw)
    assert t.src_dict == j.src_dict and t.trg_dict == j.trg_dict
    _same_items(t, j)
    tar_path, wd, vd, td = conll_fixture
    kw = dict(data_file=tar_path, word_dict_file=wd, verb_dict_file=vd,
              target_dict_file=td)
    t, j = ttext.Conll05st(**kw), jtext.Conll05st(**kw)
    _same_items(t, j)
    assert t.get_dict() == j.get_dict()
    got = list(tdataset.uci_housing.train(data_file=path)())
    want = list(jdataset.uci_housing.train(data_file=path)())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])


def _mnist_files(tmp_path):
    import struct

    rs = np.random.RandomState(6)
    imgs = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    lbls = rs.randint(0, 10, 5).astype(np.uint8)
    ip, lp = str(tmp_path / "imgs-idx3-ubyte"), str(tmp_path /
                                                     "lbls-idx1-ubyte")
    with open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + lbls.tobytes())
    return ip, lp


def test_legacy_readers_match_jax(tmp_path, ptb_tar, wmt14_tar,  # noqa
                                  conll_fixture, imdb_tar):
    """Every `dataset` module's readers and dictionaries over the same
    files: the port's samples equal the JAX package's."""
    tar_path, wd, vd, td = conll_fixture
    ip, lp = _mnist_files(tmp_path)
    conll = dict(data_file=tar_path, word_dict_file=wd, verb_dict_file=vd,
                 target_dict_file=td)
    cases = [
        ("conll05", "test", (), conll),
        ("imikolov", "train", (None, 2), dict(data_file=ptb_tar,
                                              min_word_freq=2)),
        ("imikolov", "test", (None, 2), dict(data_file=ptb_tar,
                                             min_word_freq=2)),
        ("wmt14", "train", (5,), dict(data_file=wmt14_tar)),
        ("wmt14", "test", (5,), dict(data_file=wmt14_tar)),
        ("mnist", "train", (ip, lp), {}),
        ("imdb", "test", (), dict(data_file=imdb_tar, cutoff=1)),
    ]
    for mod, fn, args, kw in cases:
        got = list(getattr(getattr(tdataset, mod), fn)(*args, **kw)())
        want = list(getattr(getattr(jdataset, mod), fn)(*args, **kw)())
        assert len(got) == len(want) > 0, (mod, fn)
        for a, b in zip(got, want):
            a, b = (a if isinstance(a, tuple) else (a,)), \
                (b if isinstance(b, tuple) else (b,))
            for u, v in zip(a, b):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert tdataset.conll05.get_dict(**conll) == \
        jdataset.conll05.get_dict(**conll)
    assert tdataset.imikolov.build_dict(2, data_file=ptb_tar) == \
        jdataset.imikolov.build_dict(2, data_file=ptb_tar)
    assert tdataset.wmt14.get_dict(5, data_file=wmt14_tar) == \
        jdataset.wmt14.get_dict(5, data_file=wmt14_tar)


def test_movie_reviews(tmp_path):
    path = str(tmp_path / "movie_reviews.zip")
    with zipfile.ZipFile(path, "w") as z:
        for i, text in enumerate(["a great fun film", "great great plot"]):
            z.writestr(f"movie_reviews/pos/cv00{i}.txt", text)
        for i, text in enumerate(["a dull bad film", "bad plot"]):
            z.writestr(f"movie_reviews/neg/cv00{i}.txt", text)
    for mode in ("train", "test"):
        _same_items(ttext.MovieReviews(data_file=path, mode=mode),
                    jtext.MovieReviews(data_file=path, mode=mode))
    with pytest.raises(RuntimeError):
        ttext.MovieReviews()


def test_download_raises_and_cluster_reader(tmp_path, monkeypatch):
    import importlib

    import paddle_tpu_torch.dataset.common as common

    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    importlib.reload(common)
    with pytest.raises(RuntimeError, match="downloads\\s+nothing"):
        common.download("http://example.com/x.tar", "x", "0")
    (tmp_path / "x").mkdir()
    (tmp_path / "x" / "x.tar").write_bytes(b"1")
    assert common.download("http://example.com/x.tar", "x", "0").endswith(
        "x.tar")
    common.split(lambda: iter(range(10)), 3,
                 suffix=str(tmp_path / "chunk-%05d.pickle"))
    got = sorted(sum((list(common.cluster_files_reader(
        str(tmp_path / "chunk-*.pickle"), 2, i)()) for i in range(2)), []))
    assert got == list(range(10))
    assert common.md5file(str(tmp_path / "x" / "x.tar")) == \
        jdataset.common.md5file(str(tmp_path / "x" / "x.tar"))
    assert sorted(tdataset.__all__) == sorted(jdataset.__all__)


def test_fake_text_dataset_matches_jax():
    t = ttext.FakeTextDataset(size=7, seq_len=5, vocab_size=50)
    j = jtext.FakeTextDataset(size=7, seq_len=5, vocab_size=50)
    _same_items(t, j)


@pytest.mark.parametrize("which", ["tiny", "base"])
def test_ernie_models_from_jax_states(which):
    from paddle_tpu_torch.convert import from_jax_state

    kw = dict(hidden_dropout=0.0, attn_dropout=0.0)
    if which == "base":
        kw.update(num_layers=1, vocab_size=1000)
    jp.seed(11)
    jm = getattr(jtext, f"ernie_{which}")(**kw)
    jm.eval()
    tm = getattr(ttext, f"ernie_{which}")(device="cpu", **kw)
    tm.load_state_dict(from_jax_state(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}))
    tm.eval()
    ids = np.random.RandomState(2).randint(1, 1000, (2, 12)).astype("int64")
    mask = np.ones((2, 12), "float32")
    mask[1, 9:] = 0
    jseq, jpool = jm(jp.to_tensor(ids), attention_mask=jp.to_tensor(mask))
    with torch.no_grad():
        tseq, tpool = tm(torch.from_numpy(ids),
                         attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq._data),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool._data),
                               rtol=1e-5, atol=1e-5)
    assert os.path.basename(ttext.models.__file__) == "models.py"
