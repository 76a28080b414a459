"""WMT16 EN-DE (counterpart of
``paddle_tpu/dataset/wmt16.py``, after the reference's python/paddle/dataset/wmt16.py).

Schema: (src_ids, trg_ids, trg_next_ids) with <s>=0, <e>=1, <unk>=2 —
the reference's convention. Synthetic: target is a deterministic
per-token mapping of source (a learnable "translation": trg = perm(src)
shifted), lengths 4-30.
"""

from __future__ import annotations

import numpy as np

SRC_VOCAB = 1000
TRG_VOCAB = 1000
BOS, EOS, UNK = 0, 1, 2


def _perm():
    rng = np.random.RandomState(17)
    p = rng.permutation(np.arange(3, TRG_VOCAB))
    return p


_P = _perm()


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            length = int(rng.randint(4, 30))
            src = rng.randint(3, SRC_VOCAB, length).astype(np.int64)
            trg = _P[src - 3]
            trg_in = np.concatenate([[BOS], trg]).astype(np.int64)
            trg_next = np.concatenate([trg, [EOS]]).astype(np.int64)
            yield src.tolist(), trg_in.tolist(), trg_next.tolist()
    return reader


def train(src_dict_size=SRC_VOCAB, trg_dict_size=TRG_VOCAB,
          src_lang="en"):
    return _reader(2000, 41)


def test(src_dict_size=SRC_VOCAB, trg_dict_size=TRG_VOCAB,
         src_lang="en"):
    return _reader(200, 42)


def get_dict(lang, dict_size, reverse=False):
    d = {i: f"{lang}{i}" for i in range(dict_size)}
    return d if reverse else {v: k for k, v in d.items()}
