"""MovieLens (counterpart of
``paddle_tpu/dataset/movielens.py``, after the reference's python/paddle/dataset/movielens.py).

Schema per sample (the reference's recommender_system book input):
(user_id, gender_id, age_id, job_id, movie_id, category_ids, title_ids,
score). Synthetic preference model: score = affinity(user cluster,
movie cluster) + noise, so embeddings are learnable.
"""

from __future__ import annotations

import numpy as np

USER_COUNT = 944
MOVIE_COUNT = 1683
CATEGORY_COUNT = 19
TITLE_VOCAB = 5175
AGE_COUNT = 7
JOB_COUNT = 21


def max_user_id():
    return USER_COUNT - 1


def max_movie_id():
    return MOVIE_COUNT - 1


def max_job_id():
    return JOB_COUNT - 1


def movie_categories():
    return {f"cat{i}": i for i in range(CATEGORY_COUNT)}


def get_movie_title_dict():
    return {f"t{i}": i for i in range(TITLE_VOCAB)}


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            u = int(rng.randint(1, USER_COUNT))
            m = int(rng.randint(1, MOVIE_COUNT))
            gender = u % 2
            age = u % AGE_COUNT
            job = u % JOB_COUNT
            cats = sorted(set(
                rng.randint(0, CATEGORY_COUNT, rng.randint(1, 4))))
            title = rng.randint(0, TITLE_VOCAB,
                                rng.randint(2, 8)).astype(np.int64)
            affinity = 3.0 + 2.0 * np.cos((u % 8) - (m % 8))
            score = float(np.clip(affinity + rng.normal(0, 0.5), 1, 5))
            yield (u, gender, age, job, m,
                   [int(c) for c in cats], title.tolist(),
                   np.array([score], np.float32))
    return reader


def train():
    return _reader(4000, 51)


def test():
    return _reader(400, 52)
