"""CoNLL-2005 semantic role labeling dataset (reference
python/paddle/dataset/conll05.py).

Samples are 9-slot tuples of equal-length token sequences:
  (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids, mark, labels)
— the predicate-context windows and IOB label ids the SRL model consumes.
get_dict() -> (word_dict, verb_dict, label_dict); get_embedding() -> path
placeholder (the reference ships pretrained emb; synthetic build returns
a deterministic matrix instead).

Synthetic fallback: labels correlate with distance to the marked predicate
so an SRL model has real signal to fit.
"""

import numpy as np

from . import common

__all__ = ["get_dict", "get_embedding", "test"]

WORD_DICT_LEN = 44068
VERB_DICT_LEN = 3162
LABEL_DICT_LEN = 67  # IOB tags over 33 role types + O
TEST_SIZE = 512


def get_dict():
    word_dict = {f"w{i}": i for i in range(WORD_DICT_LEN)}
    verb_dict = {f"v{i}": i for i in range(VERB_DICT_LEN)}
    label_dict = {f"l{i}": i for i in range(LABEL_DICT_LEN)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Deterministic [WORD_DICT_LEN, 32] embedding matrix (stand-in for the
    reference's downloaded emb file)."""
    rs = common.synthetic_rng("conll05", "emb")
    return rs.uniform(-0.1, 0.1, (WORD_DICT_LEN, 32)).astype(np.float32)


def _reader(split, size):
    def reader():
        rs = common.synthetic_rng("conll05", split)
        for _ in range(size):
            n = int(rs.randint(5, 40))
            words = rs.randint(0, WORD_DICT_LEN, n)
            pred_pos = int(rs.randint(n))
            verb = int(rs.randint(VERB_DICT_LEN))

            def ctx(off):
                j = min(max(pred_pos + off, 0), n - 1)
                return np.full(n, words[j], dtype=np.int64)

            mark = np.zeros(n, np.int64)
            mark[pred_pos] = 1
            # role labels depend on signed distance to the predicate
            dist = np.arange(n) - pred_pos
            labels = (np.abs(dist) * 2 + (dist < 0)) % LABEL_DICT_LEN
            yield (words.tolist(), ctx(-2).tolist(), ctx(-1).tolist(),
                   ctx(0).tolist(), ctx(1).tolist(), ctx(2).tolist(),
                   np.full(n, verb, np.int64).tolist(), mark.tolist(),
                   labels.astype(np.int64).tolist())

    return reader


def test():
    return _reader("test", TEST_SIZE)
