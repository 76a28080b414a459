"""word2vec n-gram model (counterpart of ``paddle_tpu/models/word2vec.py``;
reference tests/book/test_word2vec.py __network__): 4 embeddings sharing
one table -> concat -> fc sigmoid -> fc softmax -> cross_entropy, SGD."""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..framework import Program, program_guard

# the vocabulary of the JAX package's synthetic imikolov reader
# (paddle_tpu/dataset/imikolov.py), the default dict_size
VOCAB_SIZE = 2073
def build(dict_size=None, embed_size=32, hidden_size=256, lr=0.001):
    dict_size = dict_size or VOCAB_SIZE
    main, startup = Program(), Program()
    with program_guard(main, startup):
        words = [layers.data(n, shape=[1], dtype="int64")
                 for n in ("firstw", "secondw", "thirdw", "forthw")]
        next_word = layers.data("nextw", shape=[1], dtype="int64")

        embs = [layers.embedding(w, size=[dict_size, embed_size],
                                 param_attr="shared_w") for w in words]
        concat_embed = layers.concat(embs, axis=1)
        hidden1 = layers.fc(concat_embed, size=hidden_size, act="sigmoid")
        predict_word = layers.fc(hidden1, size=dict_size, act="softmax")
        cost = layers.cross_entropy(predict_word, next_word)
        avg_cost = layers.mean(cost)
        test_program = main.clone(for_test=True)
        opt = optimizer.SGDOptimizer(learning_rate=lr)
        opt.minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["firstw", "secondw", "thirdw", "forthw", "nextw"],
            "loss": avg_cost, "predict": predict_word,
            "config": {"dict_size": dict_size}}


def make_batch(samples):
    """n-gram tuples from dataset.imikolov -> feed dict."""
    arr = np.asarray(samples, np.int64)
    names = ["firstw", "secondw", "thirdw", "forthw", "nextw"]
    return {n: arr[:, i:i + 1] for i, n in enumerate(names)}


def make_fake_batch(batch_size, dict_size=VOCAB_SIZE, seed=0):
    """Random 5-grams: four context word ids and the next word's id."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, dict_size, (batch_size, 5)).astype(np.int64)
    return make_batch(ids)
