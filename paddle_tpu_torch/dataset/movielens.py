"""MovieLens-1M recommender dataset (reference python/paddle/dataset/movielens.py).

Samples: (user_id, gender_id, age_id, job_id, movie_id, category_ids,
title_ids, rating). Synthetic fallback with consistent entity tables.
"""

import numpy as np

from . import common

__all__ = ["train", "test", "max_user_id", "max_movie_id", "max_job_id",
           "age_table", "movie_categories"]

NUM_USERS = 1000
NUM_MOVIES = 800
NUM_JOBS = 21
NUM_CATEGORIES = 18
TITLE_VOCAB = 1500
AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]
TRAIN_SIZE = 8192
TEST_SIZE = 1024


def max_user_id():
    return NUM_USERS


def max_movie_id():
    return NUM_MOVIES


def max_job_id():
    return NUM_JOBS - 1


def age_table():
    return list(AGE_TABLE)


def movie_categories():
    return {f"cat{i}": i for i in range(NUM_CATEGORIES)}


def _reader(split, size):
    def reader():
        rs = common.synthetic_rng("movielens", split)
        ers = common.synthetic_rng("movielens", "entities")
        user_bias = ers.randn(NUM_USERS + 1)
        movie_bias = ers.randn(NUM_MOVIES + 1)
        for _ in range(size):
            u = rs.randint(1, NUM_USERS + 1)
            m = rs.randint(1, NUM_MOVIES + 1)
            gender = rs.randint(2)
            age = rs.randint(len(AGE_TABLE))
            job = rs.randint(NUM_JOBS)
            cats = rs.randint(0, NUM_CATEGORIES,
                              rs.randint(1, 4)).tolist()
            title = rs.randint(0, TITLE_VOCAB, rs.randint(2, 6)).tolist()
            score = 3.0 + user_bias[u] + movie_bias[m] + 0.3 * rs.randn()
            rating = float(np.clip(round(score), 1, 5))
            yield u, gender, age, job, m, cats, title, rating

    return reader


def train():
    return _reader("train", TRAIN_SIZE)


def test():
    return _reader("test", TEST_SIZE)
