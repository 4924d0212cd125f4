"""MNIST dataset (reference python/paddle/dataset/mnist.py).

Samples: (image: float32[784] scaled to [-1,1], label: int64 in [0,10)).
Reads the standard idx-format files from DATA_HOME/mnist when present,
else a deterministic synthetic set with class-dependent pixel structure
(so models genuinely converge on it).
"""

import gzip
import struct

import numpy as np

from . import common

__all__ = ["train", "test"]

TRAIN_SIZE = 8192  # synthetic fallback sizes (real: 60000/10000)
TEST_SIZE = 1024


def _idx_reader(image_path, label_path):
    def reader():
        with gzip.open(image_path, "rb") as imgf, \
                gzip.open(label_path, "rb") as lblf:
            magic, n, rows, cols = struct.unpack(">IIII", imgf.read(16))
            lmagic, ln = struct.unpack(">II", lblf.read(8))
            for _ in range(n):
                img = np.frombuffer(
                    imgf.read(rows * cols), dtype=np.uint8)
                lbl = struct.unpack("B", lblf.read(1))[0]
                img = img.astype("float32") / 255.0 * 2.0 - 1.0
                yield img, int(lbl)

    return reader


def _synthetic_reader(split, size):
    def reader():
        rs = common.synthetic_rng("mnist", split)
        protos = common.synthetic_rng("mnist", "protos").rand(10, 784)
        for _ in range(size):
            y = rs.randint(10)
            x = protos[y] + 0.25 * rs.randn(784)
            x = np.clip(x, 0, 1).astype("float32") * 2.0 - 1.0
            yield x, int(y)

    return reader


def _reader(split, size):
    imgs = common.cached_path(
        "mnist", f"{split}-images-idx3-ubyte.gz")
    lbls = common.cached_path(
        "mnist", f"{split}-labels-idx1-ubyte.gz")
    if imgs and lbls:
        return _idx_reader(imgs, lbls)
    return _synthetic_reader(split, size)


def train():
    return _reader("train", TRAIN_SIZE)


def test():
    return _reader("t10k", TEST_SIZE)
