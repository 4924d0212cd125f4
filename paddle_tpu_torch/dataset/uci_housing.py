"""UCI housing regression dataset (reference python/paddle/dataset/uci_housing.py).

Samples: (features: float32[13], price: float32[1]). Synthetic fallback is an
actual linear model + noise so fit_a_line converges.
"""

import numpy as np

from . import common

__all__ = ["train", "test"]

TRAIN_SIZE = 404
TEST_SIZE = 102
FEATURE_NUM = 13


def _synthetic(split, size):
    def reader():
        rs = common.synthetic_rng("uci_housing", split)
        w = common.synthetic_rng("uci_housing", "w").randn(FEATURE_NUM)
        for _ in range(size):
            x = rs.randn(FEATURE_NUM).astype("float32")
            y = float(x @ w + 0.1 * rs.randn())
            yield x, np.array([y], dtype="float32")

    return reader


def train():
    return _synthetic("train", TRAIN_SIZE)


def test():
    return _synthetic("test", TEST_SIZE)
