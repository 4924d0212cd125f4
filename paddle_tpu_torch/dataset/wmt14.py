"""WMT14 fr-en translation dataset (reference python/paddle/dataset/wmt14.py).

Samples: (src_ids, trg_ids, trg_next_ids) — source sentence, target sentence
with <s> prefix, target shifted with <e> suffix. Synthetic fallback: target
is a deterministic token-wise function of source, so seq2seq models can
genuinely learn the mapping.
"""

import numpy as np

from . import common

__all__ = ["train", "test"]

DICT_SIZE = 30000
START_ID, END_ID, UNK_ID = 0, 1, 2
TRAIN_SIZE = 2048
TEST_SIZE = 256


def _reader(split, size, src_dict_size, trg_dict_size):
    src_v = min(src_dict_size, DICT_SIZE)
    trg_v = min(trg_dict_size, DICT_SIZE)

    def reader():
        rs = common.synthetic_rng("wmt14", split)
        for _ in range(size):
            n = rs.randint(4, 16)
            src = rs.randint(3, src_v, n).tolist()
            trg = [(w * 17 + 3) % (trg_v - 3) + 3 for w in src]
            yield src, [START_ID] + trg, trg + [END_ID]

    return reader


def train(dict_size=DICT_SIZE):
    return _reader("train", TRAIN_SIZE, dict_size, dict_size)


def test(dict_size=DICT_SIZE):
    return _reader("test", TEST_SIZE, dict_size, dict_size)
