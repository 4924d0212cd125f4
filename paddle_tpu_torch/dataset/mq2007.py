"""LETOR MQ2007 learning-to-rank dataset (reference
python/paddle/dataset/mq2007.py).

Three reader formats selected by `format`:
  pointwise: (feature [46] float32, relevance_score float)
  pairwise:  (relevant_doc [46], irrelevant_doc [46]) per query pair
  listwise:  (label_list, feature_list) per query

Synthetic fallback: each query draws a hidden weight vector; relevance is
a noisy linear score of the 46 LETOR features, so rank models can learn
genuine orderings.
"""

import numpy as np

from . import common

__all__ = ["train", "test"]

FEATURE_DIM = 46
TRAIN_QUERIES = 128
TEST_QUERIES = 32


def _gen_query(rs):
    ndocs = int(rs.randint(5, 20))
    feats = rs.rand(ndocs, FEATURE_DIM).astype(np.float32)
    w = rs.randn(FEATURE_DIM).astype(np.float32)
    score = feats @ w + rs.randn(ndocs).astype(np.float32) * 0.1
    # LETOR relevance grades 0/1/2 by score tercile
    order = np.argsort(score)
    rel = np.zeros(ndocs, np.int64)
    rel[order[ndocs // 3:]] = 1
    rel[order[2 * ndocs // 3:]] = 2
    return feats, rel


def _reader(split, nqueries, format):
    def reader():
        rs = common.synthetic_rng("mq2007", split)
        for _ in range(nqueries):
            feats, rel = _gen_query(rs)
            if format == "pointwise":
                for f, r in zip(feats, rel):
                    yield f, float(r)
            elif format == "pairwise":
                for i in range(len(rel)):
                    for j in range(len(rel)):
                        if rel[i] > rel[j]:
                            yield feats[i], feats[j]
            elif format == "listwise":
                yield rel.tolist(), [f for f in feats]
            else:
                raise ValueError(f"unknown format {format!r}")

    return reader


def train(format="pairwise"):
    return _reader("train", TRAIN_QUERIES, format)


def test(format="pairwise"):
    return _reader("test", TEST_QUERIES, format)
