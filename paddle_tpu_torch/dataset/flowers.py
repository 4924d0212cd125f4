"""102-category flowers dataset (reference python/paddle/dataset/flowers.py).

Samples: (image: float32[3*224*224] flattened CHW in [0,1], label: int).
Synthetic fallback mirrors cifar's class-structured generator at 224x224.
"""

import numpy as np

from . import common

__all__ = ["train", "test", "valid"]

NUM_CLASSES = 102
TRAIN_SIZE = 512
TEST_SIZE = 128


def _synthetic(split, size):
    def reader():
        rs = common.synthetic_rng("flowers", split)
        protos = common.synthetic_rng("flowers", "protos").rand(
            NUM_CLASSES, 3, 7, 7)
        for _ in range(size):
            y = rs.randint(NUM_CLASSES)
            base = np.kron(protos[y], np.ones((1, 32, 32)))  # 3x224x224
            x = np.clip(base + 0.1 * rs.randn(3, 224, 224), 0, 1)
            yield x.astype("float32").flatten(), int(y)

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True):
    return _synthetic("train", TRAIN_SIZE)


def test(mapper=None, buffered_size=1024, use_xmap=True):
    return _synthetic("test", TEST_SIZE)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _synthetic("valid", TEST_SIZE)
