"""UCI housing (counterpart of
``paddle_tpu/dataset/uci_housing.py``, after the reference's python/paddle/dataset/uci_housing.py).

Schema: (features float32[13], price float32[1]), features normalized —
synthetic linear-plus-noise generator with the reference's feature count
and target scale (prices ~5-50).
"""

from __future__ import annotations

import numpy as np

_W = None


def _w():
    global _W
    if _W is None:
        _W = np.random.RandomState(7).uniform(-3, 3, 13).astype(np.float32)
    return _W


def _reader(n: int, seed: int):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            x = rng.normal(0, 1, 13).astype(np.float32)
            y = float(x @ _w() + 22.5 + rng.normal(0, 2.0))
            yield x, np.array([y], np.float32)
    return reader


def train():
    return _reader(404, 11)


def test():
    return _reader(102, 12)
