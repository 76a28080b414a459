"""Recommender system (counterpart of ``paddle_tpu/models/recommender.py``;
reference tests/book/test_recommender_system.py): user and movie feature
towers -> cos_sim -> a scaled square-error regression on the rating.

The sequence features (movie categories and title) are padded with a
length, in place of LoD.
"""

from __future__ import annotations

import numpy as np

from .. import layers, nets, optimizer
from ..framework import Program, program_guard

MAX_CATS = 8
MAX_TITLE = 12

# the table sizes of the JAX package's movielens reader
# (paddle_tpu/dataset/movielens.py)
USER_COUNT = 944
MOVIE_COUNT = 1683
CATEGORY_COUNT = 19
TITLE_VOCAB = 5175
AGE_COUNT = 7
JOB_COUNT = 21
def _usr_tower():
    usr = layers.data("user_id", shape=[1], dtype="int64")
    gender = layers.data("gender_id", shape=[1], dtype="int64")
    age = layers.data("age_id", shape=[1], dtype="int64")
    job = layers.data("job_id", shape=[1], dtype="int64")

    # lookup_table drops the trailing [.,1] id dim: [B,1] ids -> [B,D]
    usr_emb = layers.embedding(usr, size=[USER_COUNT, 32],
                               param_attr="user_table")
    usr_fc = layers.fc(usr_emb, size=32)
    gender_fc = layers.fc(layers.embedding(
        gender, size=[2, 16], param_attr="gender_table"), size=16)
    age_fc = layers.fc(layers.embedding(
        age, size=[AGE_COUNT, 16],
        param_attr="age_table"), size=16)
    job_fc = layers.fc(layers.embedding(
        job, size=[JOB_COUNT, 16],
        param_attr="job_table"), size=16)

    concat = layers.concat([usr_fc, gender_fc, age_fc, job_fc], axis=1)
    return layers.fc(concat, size=200, act="tanh")


def _mov_tower():
    mov = layers.data("movie_id", shape=[1], dtype="int64")
    cats = layers.data("category_id", shape=[MAX_CATS, 1], dtype="int64")
    cats_len = layers.data("category_len", shape=[], dtype="int32")
    title = layers.data("movie_title", shape=[MAX_TITLE, 1], dtype="int64")
    title_len = layers.data("title_len", shape=[], dtype="int32")

    mov_emb = layers.embedding(mov, size=[MOVIE_COUNT, 32],
                               param_attr="movie_table")
    mov_fc = layers.fc(mov_emb, size=32)

    cat_emb = layers.embedding(cats, size=[CATEGORY_COUNT, 32])
    cat_pool = layers.sequence_pool(cat_emb, "sum", length=cats_len)

    title_emb = layers.embedding(title, size=[TITLE_VOCAB, 32])
    title_conv = nets.sequence_conv_pool(
        title_emb, num_filters=32, filter_size=3, act="tanh",
        pool_type="sum", length=title_len)

    concat = layers.concat([mov_fc, cat_pool, title_conv], axis=1)
    return layers.fc(concat, size=200, act="tanh")


def build(lr=0.2):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        usr = _usr_tower()
        mov = _mov_tower()
        inference = layers.cos_sim(usr, mov)
        scale_infer = layers.scale(inference, scale=5.0)
        label = layers.data("score", shape=[1], dtype="float32")
        cost = layers.square_error_cost(scale_infer, label)
        avg_cost = layers.mean(cost)
        test_program = main.clone(for_test=True)
        opt = optimizer.SGDOptimizer(learning_rate=lr)
        opt.minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["user_id", "gender_id", "age_id", "job_id",
                      "movie_id", "category_id", "category_len",
                      "movie_title", "title_len", "score"],
            "loss": avg_cost, "predict": scale_infer}


def make_batch(samples):
    """movielens rows -> padded feed dict."""
    n = len(samples)
    feed = {
        "user_id": np.zeros((n, 1), np.int64),
        "gender_id": np.zeros((n, 1), np.int64),
        "age_id": np.zeros((n, 1), np.int64),
        "job_id": np.zeros((n, 1), np.int64),
        "movie_id": np.zeros((n, 1), np.int64),
        "category_id": np.zeros((n, MAX_CATS, 1), np.int64),
        "category_len": np.zeros((n,), np.int32),
        "movie_title": np.zeros((n, MAX_TITLE, 1), np.int64),
        "title_len": np.zeros((n,), np.int32),
        "score": np.zeros((n, 1), np.float32),
    }
    for i, (uid, gender, age, job, mid, cats, title, score) in \
            enumerate(samples):
        feed["user_id"][i, 0] = uid
        feed["gender_id"][i, 0] = gender
        feed["age_id"][i, 0] = age
        feed["job_id"][i, 0] = job
        feed["movie_id"][i, 0] = mid
        cats = list(cats)[:MAX_CATS]
        title = list(title)[:MAX_TITLE]
        feed["category_id"][i, :len(cats), 0] = cats
        feed["category_len"][i] = len(cats)
        feed["movie_title"][i, :len(title), 0] = title
        feed["title_len"][i] = len(title)
        feed["score"][i, 0] = float(np.asarray(score).reshape(-1)[0])
    return feed


def make_fake_batch(batch_size, seed=0):
    """Random ids within each table, random lengths and ratings in [1, 5]."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(batch_size):
        n_cats = rng.randint(1, MAX_CATS + 1)
        n_title = rng.randint(1, MAX_TITLE + 1)
        samples.append((
            rng.randint(USER_COUNT), rng.randint(2), rng.randint(AGE_COUNT),
            rng.randint(JOB_COUNT), rng.randint(MOVIE_COUNT),
            rng.randint(0, CATEGORY_COUNT, n_cats),
            rng.randint(0, TITLE_VOCAB, n_title),
            float(rng.randint(1, 6))))
    return make_batch(samples)
