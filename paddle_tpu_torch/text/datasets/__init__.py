"""NLP datasets (paddle.text.datasets parity), the JAX package's
`text/datasets/` copied into the port (pure Python over numpy).

Reference parity: python/paddle/text/datasets/ (Imdb, Imikolov,
Movielens, Conll05st, UCIHousing, WMT14, WMT16, MovieReviews). Nothing
is downloaded: constructors accept local archive
files in the SAME formats the reference downloads (aclImdb tar, PTB
simple-examples tar, ml-1m zip, conll05st tar, wmt tars) and raise a
clear error when a download would be required.
"""
from .conll05 import Conll05st  # noqa: F401
from .imdb import Imdb  # noqa: F401
from .imikolov import Imikolov  # noqa: F401
from .movie_reviews import MovieReviews  # noqa: F401
from .movielens import Movielens  # noqa: F401
from .uci_housing import UCIHousing  # noqa: F401
from .wmt import WMT14, WMT16  # noqa: F401

__all__ = ["Imdb", "Imikolov", "Movielens", "Conll05st", "UCIHousing",
           "WMT14", "WMT16", "MovieReviews"]
