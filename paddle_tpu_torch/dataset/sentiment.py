"""NLTK movie-review sentiment dataset (reference
python/paddle/dataset/sentiment.py).

Samples: (word_ids: list[int], label: 0/1). get_word_dict() -> {word: id}.
The reference tokenizes nltk's movie_reviews corpus; the synthetic fallback
draws class-biased unigrams (same recipe as dataset/imdb.py, distinct
vocabulary size and corpus stats).
"""

import numpy as np

from . import common

__all__ = ["train", "test", "get_word_dict"]

VOCAB_SIZE = 39768  # nltk movie_reviews vocabulary order
TRAIN_SIZE = 1600
TEST_SIZE = 400


def get_word_dict():
    d = {f"w{i}": i for i in range(VOCAB_SIZE)}
    return d


def _reader(split, size):
    def reader():
        rs = common.synthetic_rng("sentiment", split)
        half = VOCAB_SIZE // 2
        for _ in range(size):
            y = int(rs.randint(2))
            n = int(rs.randint(20, 200))
            biased = rs.randint(y * half, y * half + half, n)
            noise = rs.randint(0, VOCAB_SIZE, n)
            pick = rs.rand(n) < 0.65
            yield np.where(pick, biased, noise).tolist(), y

    return reader


def train():
    return _reader("train", TRAIN_SIZE)


def test():
    return _reader("test", TEST_SIZE)
