"""WMT16 en<->de translation dataset (reference
python/paddle/dataset/wmt16.py).

Samples: (src_ids, trg_ids, trg_ids_next) with <s>/<e>/<unk> conventions —
trg_ids is <s>-prefixed, trg_ids_next is the <e>-suffixed shift.
get_dict(lang, dict_size) -> {word: id}; fetch() is a no-op in the
zero-egress build.

Synthetic fallback mirrors dataset/wmt14.py: the "translation" is a
deterministic affine token map so seq2seq models can genuinely learn it.
"""

import numpy as np

from . import common

__all__ = ["train", "test", "validation", "get_dict", "fetch"]

TOTAL_EN_WORDS = 11250
TOTAL_DE_WORDS = 19220
TRAIN_SIZE = 2048
TEST_SIZE = 256

_START = 0  # <s>
_END = 1    # <e>
_UNK = 2    # <unk>


def get_dict(lang, dict_size, reverse=False):
    dict_size = min(dict_size,
                    TOTAL_EN_WORDS if lang == "en" else TOTAL_DE_WORDS)
    d = {"<s>": _START, "<e>": _END, "<unk>": _UNK}
    for i in range(3, dict_size):
        d[f"{lang}{i}"] = i
    if reverse:
        return {v: k for k, v in d.items()}
    return d


def fetch():
    """Zero-egress build: nothing to download."""
    return None


def _reader(split, size, src_dict_size, trg_dict_size):
    src_dict_size = min(src_dict_size, TOTAL_EN_WORDS)
    trg_dict_size = min(trg_dict_size, TOTAL_DE_WORDS)

    def reader():
        rs = common.synthetic_rng("wmt16", split)
        for _ in range(size):
            n = int(rs.randint(3, 16))
            src = rs.randint(3, src_dict_size, n)
            # learnable mapping: trg token = affine map of src token
            trg = 3 + (src * 7 + 11) % (trg_dict_size - 3)
            trg_in = np.concatenate([[_START], trg])
            trg_next = np.concatenate([trg, [_END]])
            yield (src.tolist(), trg_in.tolist(), trg_next.tolist())

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("train", TRAIN_SIZE, src_dict_size, trg_dict_size)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("test", TEST_SIZE, src_dict_size, trg_dict_size)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("val", TEST_SIZE, src_dict_size, trg_dict_size)
