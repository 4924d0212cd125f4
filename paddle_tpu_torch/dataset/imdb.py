"""IMDB sentiment dataset (reference python/paddle/dataset/imdb.py).

Samples: (word_ids: list[int], label: 0/1). word_dict() -> {word: id}.
Synthetic fallback: two vocab regions with class-biased unigram draws so
sentiment models genuinely separate the classes.
"""

import numpy as np

from . import common

__all__ = ["train", "test", "word_dict"]

VOCAB_SIZE = 5148  # matches the reference's aclImdb word_dict cutoff order
TRAIN_SIZE = 2048
TEST_SIZE = 256


def word_dict():
    """{word: id}; synthetic vocabulary w0..wN + <unk>."""
    d = {f"w{i}": i for i in range(VOCAB_SIZE - 1)}
    d["<unk>"] = VOCAB_SIZE - 1
    return d


def _synthetic_reader(split, size):
    def reader():
        rs = common.synthetic_rng("imdb", split)
        half = VOCAB_SIZE // 2
        for _ in range(size):
            y = rs.randint(2)
            n = rs.randint(16, 128)
            # class-biased mixture: 70% from its half, 30% anywhere
            biased = rs.randint(y * half, y * half + half, n)
            noise = rs.randint(0, VOCAB_SIZE - 1, n)
            pick = rs.rand(n) < 0.7
            words = np.where(pick, biased, noise).tolist()
            yield words, int(y)

    return reader


def train(word_idx=None):
    return _synthetic_reader("train", TRAIN_SIZE)


def test(word_idx=None):
    return _synthetic_reader("test", TEST_SIZE)
