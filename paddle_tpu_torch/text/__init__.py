"""Text models, generation and datasets: the ERNIE encoders
(`ernie_base`, `ernie_tiny`), the decoder step net, the eager greedy
oracle, Viterbi decoding, `FakeTextDataset` and the `datasets` parsers
(local files only)."""
import numpy as np

from ..io import Dataset
from . import datasets, viterbi
from .datasets import (Conll05st, Imdb, Imikolov, Movielens, MovieReviews,
                       UCIHousing, WMT14, WMT16)
from .generation import generate_eager
from .models import (ErnieConfig, ErnieEmbeddings, ErnieForPretraining,
                     ErnieForSequenceClassification, ErnieModel, ernie_base,
                     ernie_tiny)
from .viterbi import viterbi_decode

__all__ = ["generate_eager", "ErnieConfig", "ErnieEmbeddings",
           "ErnieForPretraining", "ErnieForSequenceClassification",
           "ErnieModel", "ernie_base", "ernie_tiny", "viterbi",
           "viterbi_decode", "datasets", "FakeTextDataset", "Conll05st",
           "Imdb", "Imikolov", "Movielens", "MovieReviews", "UCIHousing",
           "WMT14", "WMT16"]


class FakeTextDataset(Dataset):
    """Synthetic token sequences (classification style: ids, label), the
    JAX package's: item i draws its ids from numpy's RandomState(i %
    65536), so both packages give the same items."""

    def __init__(self, size=1000, seq_len=128, vocab_size=30000,
                 num_classes=2, seed=0):
        self.size = size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.num_classes = num_classes

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx % 65536)
        ids = rng.randint(1, self.vocab_size,
                          size=(self.seq_len,)).astype(np.int64)
        label = np.asarray(idx % self.num_classes, dtype=np.int64)
        return ids, label

    def __len__(self):
        return self.size
