"""PTB-style language-model dataset (reference python/paddle/dataset/imikolov.py).

build_dict() -> {word: id}; train/test yield n-gram tuples of word ids
(default n=5, as used by the word2vec book chapter).
"""

import numpy as np

from . import common

__all__ = ["build_dict", "train", "test"]

VOCAB_SIZE = 2074  # reference's min-freq-cutoff dict size ballpark
TRAIN_SIZE = 4096
TEST_SIZE = 512


def build_dict(min_word_freq=50):
    d = {f"w{i}": i for i in range(VOCAB_SIZE - 2)}
    d["<s>"] = VOCAB_SIZE - 2
    d["<e>"] = VOCAB_SIZE - 1
    return d


def _reader(split, size, n):
    def reader():
        rs = common.synthetic_rng("imikolov", split)
        # markov-ish: next word depends on previous (mod structure) so the
        # n-gram model has signal to learn
        for _ in range(size):
            start = rs.randint(VOCAB_SIZE)
            seq = [start]
            for _ in range(n - 1):
                nxt = (seq[-1] * 31 + 7 + rs.randint(5)) % VOCAB_SIZE
                seq.append(int(nxt))
            yield tuple(seq)

    return reader


def train(word_idx=None, n=5):
    return _reader("train", TRAIN_SIZE, n)


def test(word_idx=None, n=5):
    return _reader("test", TEST_SIZE, n)
