"""CIFAR (counterpart of
``paddle_tpu/dataset/cifar.py``, after the reference's python/paddle/dataset/cifar.py).

Schema: (image float32[3072] in [0,1] — 3x32x32 flattened, label int).
`train10/test10` = 10 classes, `train100/test100` = 100 classes.
Synthetic: class-colored texture patches + noise.
"""

from __future__ import annotations

import numpy as np

TRAIN_SIZE = 4096
TEST_SIZE = 512


def _sample(idx: int, label: int, num_classes: int) -> np.ndarray:
    rng = np.random.RandomState(999983 * label + idx)
    img = np.zeros((3, 32, 32), np.float32)
    base = np.array([(label * 37 % 255) / 255.0,
                     (label * 101 % 255) / 255.0,
                     (label * 197 % 255) / 255.0], np.float32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    freq = 1 + (label % 7)
    tex = 0.5 + 0.5 * np.sin(freq * xx / 4.0) * np.cos(
        (label % 5 + 1) * yy / 4.0)
    for c in range(3):
        img[c] = base[c] * tex + rng.rand(32, 32) * 0.2
    return np.clip(img, 0, 1).reshape(3072).astype(np.float32)


def _reader(n, num_classes, seed):
    def reader():
        rng = np.random.RandomState(seed)
        labels = rng.randint(0, num_classes, n)
        for i in range(n):
            yield _sample(i, int(labels[i]), num_classes), int(labels[i])
    return reader


def train10():
    return _reader(TRAIN_SIZE, 10, 21)


def test10():
    return _reader(TEST_SIZE, 10, 22)


def train100():
    return _reader(TRAIN_SIZE, 100, 23)


def test100():
    return _reader(TEST_SIZE, 100, 24)


def reader_creator(filename, sub_name, cycle=False):
    """Parse the REAL cifar-python tarball format (the reference's
    dataset/cifar.py:36 reader_creator): a tar(.gz) whose members with
    ``sub_name`` in their name are pickled dicts carrying b'data'
    (uint8 [N, 3072]) and b'labels' / b'fine_labels'. Yields
    (float32[3072] in [0,1], int label)."""
    import pickle
    import tarfile

    def read_batch(batch):
        data = batch[b"data"]
        labels = batch.get(b"labels", batch.get(b"fine_labels"))
        assert labels is not None, "batch has neither labels key"
        for sample, label in zip(data, labels):
            yield (np.asarray(sample) / 255.0).astype(np.float32), \
                int(label)

    def reader():
        with tarfile.open(filename, mode="r") as f:
            names = [m.name for m in f if sub_name in m.name]
            while True:
                for name in names:
                    batch = pickle.load(f.extractfile(name),
                                        encoding="bytes")
                    yield from read_batch(batch)
                if not cycle:
                    break

    return reader
