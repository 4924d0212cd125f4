"""Dataset package (reference python/paddle/dataset/__init__.py).

Each module provides reader creators with the reference's exact sample
schema; real files under DATA_HOME are used when present, else
deterministic synthetic data with learnable structure (zero-egress build).
"""

from . import common
from . import mnist
from . import cifar
from . import imdb
from . import imikolov
from . import uci_housing
from . import wmt14
from . import wmt16
from . import flowers
from . import movielens
from . import conll05
from . import sentiment
from . import voc2012
from . import mq2007

__all__ = ["common", "mnist", "cifar", "imdb", "imikolov", "uci_housing",
           "wmt14", "wmt16", "flowers", "movielens", "conll05", "sentiment",
           "voc2012", "mq2007"]
