"""CoNLL-2005 semantic role labelling (counterpart of
``paddle_tpu/dataset/conll05.py``, after the reference's
python/paddle/dataset/conll05.py), synthetic.

Each row, the label_semantic_roles book model's input: 8 feature
sequences (the word, its context at -2..+2, the predicate, the mark of
the predicate's position) and a label sequence over the 59-tag BIO set.
The tags are derived from the word ids near the predicate, "O" (0) from
7 positions away on.
"""

from __future__ import annotations

import numpy as np

WORD_VOCAB = 4000
PRED_VOCAB = 300
LABEL_COUNT = 59  # the reference's tag set


def get_dict():
    word_dict = {f"w{i}": i for i in range(WORD_VOCAB)}
    verb_dict = {f"v{i}": i for i in range(PRED_VOCAB)}
    label_dict = {f"l{i}": i for i in range(LABEL_COUNT)}
    return word_dict, verb_dict, label_dict


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ln = int(rng.randint(5, 40))
            words = rng.randint(0, WORD_VOCAB, ln).astype(np.int64)
            verb_pos = int(rng.randint(0, ln))
            verb = int(rng.randint(0, PRED_VOCAB))
            mark = np.zeros(ln, np.int64)
            mark[verb_pos] = 1
            dist = np.abs(np.arange(ln) - verb_pos)
            labels = ((words + dist) % (LABEL_COUNT - 1) + 1).astype(
                np.int64)
            labels[dist > 6] = 0  # O far from the predicate
            ctx = [np.roll(words, s) for s in (2, 1, 0, -1, -2)]
            yield (words.tolist(), *[c.tolist() for c in ctx],
                   [verb] * ln, mark.tolist(), labels.tolist())
    return reader


def train():
    return _reader(1000, 71)


def test():
    return _reader(100, 72)
