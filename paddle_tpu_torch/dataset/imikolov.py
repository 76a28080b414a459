"""Mikolov PTB language-model n-grams (counterpart of
``paddle_tpu/dataset/imikolov.py``, after the reference's python/paddle/dataset/imikolov.py).

Schema: `build_dict()` -> word->id map; `train(word_idx, n)` yields
n-word tuples (n-1 context ids, next id). Synthetic: a first-order
Markov chain over the vocab with a deterministic successor component so
an n-gram model has real signal to learn (loss decreases measurably in
a few steps), matching how the book test consumes it.
"""

from __future__ import annotations

import numpy as np

VOCAB_SIZE = 2073  # close to the reference PTB cutoff build_dict size


def build_dict(min_word_freq=50):
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _reader(n_samples, n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        # deterministic successor table + noise = learnable bigram signal
        succ = rng.permutation(VOCAB_SIZE)
        word = int(rng.randint(VOCAB_SIZE))
        window = []
        produced = 0
        while produced < n_samples:
            if rng.rand() < 0.8:
                word = int(succ[word])
            else:
                word = int(rng.randint(VOCAB_SIZE))
            window.append(word)
            if len(window) >= n:
                yield tuple(window[-n:])
                produced += 1
    return reader


def train(word_idx=None, n=5):
    return _reader(3000, n, 41)


def test(word_idx=None, n=5):
    return _reader(500, n, 42)
