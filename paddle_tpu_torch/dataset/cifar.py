"""CIFAR-10/100 (reference python/paddle/dataset/cifar.py).

Samples: (image: float32[3072] in [0,1] flattened CHW, label: int).
Reads python-pickle batches from DATA_HOME/cifar when present, else
deterministic synthetic images with class-dependent color/texture structure.
"""

import os
import pickle
import tarfile

import numpy as np

from . import common

__all__ = ["train10", "test10", "train100", "test100"]

TRAIN_SIZE = 4096
TEST_SIZE = 512


def _tar_reader(path, sub_name):
    def reader():
        with tarfile.open(path, mode="r") as f:
            names = [n for n in f.getnames() if sub_name in n]
            for name in names:
                batch = pickle.load(f.extractfile(name), encoding="bytes")
                data = batch[b"data"]
                labels = batch.get(b"labels", batch.get(b"fine_labels"))
                for sample, label in zip(data, labels):
                    yield (sample / 255.0).astype("float32"), int(label)

    return reader


def _synthetic_reader(split, size, num_classes):
    def reader():
        rs = common.synthetic_rng(f"cifar{num_classes}", split)
        protos = common.synthetic_rng(
            f"cifar{num_classes}", "protos").rand(num_classes, 3, 8, 8)
        for _ in range(size):
            y = rs.randint(num_classes)
            base = np.kron(protos[y], np.ones((1, 4, 4)))  # 3x32x32
            x = np.clip(base + 0.15 * rs.randn(3, 32, 32), 0, 1)
            yield x.astype("float32").flatten(), int(y)

    return reader


def _reader(archive, sub_name, split, size, num_classes):
    p = common.cached_path("cifar", archive)
    if p:
        return _tar_reader(p, sub_name)
    return _synthetic_reader(split, size, num_classes)


def train10():
    return _reader("cifar-10-python.tar.gz", "data_batch", "train", TRAIN_SIZE, 10)


def test10():
    return _reader("cifar-10-python.tar.gz", "test_batch", "test", TEST_SIZE, 10)


def train100():
    return _reader("cifar-100-python.tar.gz", "train", "train", TRAIN_SIZE, 100)


def test100():
    return _reader("cifar-100-python.tar.gz", "test", "test", TEST_SIZE, 100)
