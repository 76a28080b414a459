"""Flowers-102 (counterpart of
``paddle_tpu/dataset/flowers.py``, after the reference's python/paddle/dataset/flowers.py).

Schema: (image float32[3*H*W] in [0,1], label int in [0,101]); the
reference yields 3x224x224 crops. Synthetic textures; `train(height,
width)` lets benchmarks pick the crop (default 224 like the original).
"""

from __future__ import annotations

import numpy as np

CLASS_COUNT = 102


def _sample(rng, label, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((3, h, w), np.float32)
    f1, f2 = 1 + label % 9, 1 + label % 6
    for c in range(3):
        phase = (label * (c + 1)) % 7
        img[c] = 0.5 + 0.45 * np.sin(f1 * xx / 17.0 + phase) * np.cos(
            f2 * yy / 13.0)
    img += rng.rand(3, h, w).astype(np.float32) * 0.15
    return np.clip(img, 0, 1).reshape(-1).astype(np.float32)


def _reader(n, seed, h, w):
    def reader():
        rng = np.random.RandomState(seed)
        labels = rng.randint(0, CLASS_COUNT, n)
        for i in range(n):
            yield _sample(rng, int(labels[i]), h, w), int(labels[i])
    return reader


def train(height=224, width=224, mapper=None, buffered_size=None,
          use_xmap=None):
    return _reader(1024, 61, height, width)


def test(height=224, width=224, mapper=None, buffered_size=None,
         use_xmap=None):
    return _reader(128, 62, height, width)


def valid(height=224, width=224):
    return _reader(128, 63, height, width)
