"""Legacy paddle.dataset namespace (reader-generator style), the JAX
package's `dataset/` copied into the port (pure Python over numpy).

Reference parity: python/paddle/dataset/ — each module exposes
train()/test() functions returning sample GENERATORS (the fluid-1.x data
idiom consumed by DataLoader.from_generator / paddle.batch). Built over
the map-style datasets in paddle_tpu_torch.text.datasets and
paddle_tpu_torch.vision.datasets; local files only (no download).
"""
from . import common  # noqa: F401
from . import conll05  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import mnist  # noqa: F401
from . import movielens  # noqa: F401
from . import uci_housing  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401

__all__ = ["common", "conll05", "imdb", "imikolov", "mnist", "movielens",
           "uci_housing", "wmt14", "wmt16"]
