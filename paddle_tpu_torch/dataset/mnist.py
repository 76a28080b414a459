"""MNIST (counterpart of
``paddle_tpu/dataset/mnist.py``, after the reference's python/paddle/dataset/mnist.py).

Record schema matches the reference: each sample is (image, label) with
image a float32 vector of 784 values in [-1, 1] and label int in [0, 9].
Synthetic digits: class-dependent gaussian blobs rendered on the 28x28
grid, deterministic per index — separable enough that LeNet reaches
>90% accuracy in a few hundred steps (keeps the reference's book-test
behavior: loss decreases, accuracy climbs).
"""

from __future__ import annotations

import numpy as np

TRAIN_SIZE = 8192
TEST_SIZE = 1024


def _sample(idx: int, label: int) -> np.ndarray:
    rng = np.random.RandomState(100003 * label + idx)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    # class-specific stroke pattern: two gaussian blobs + a bar
    cx1, cy1 = 6 + (label % 5) * 4, 6 + (label // 5) * 10
    cx2, cy2 = 22 - (label % 3) * 5, 20 - (label % 4) * 3
    img = (np.exp(-((xx - cx1) ** 2 + (yy - cy1) ** 2) / 18.0)
           + np.exp(-((xx - cx2) ** 2 + (yy - cy2) ** 2) / 30.0))
    if label % 2:
        img += np.exp(-((yy - 14 - (label - 5)) ** 2) / 8.0) * 0.7
    img += rng.rand(28, 28).astype(np.float32) * 0.25
    img = img / img.max()
    return (img.reshape(784) * 2.0 - 1.0).astype(np.float32)


def _reader(n: int, seed: int):
    def reader():
        rng = np.random.RandomState(seed)
        labels = rng.randint(0, 10, n)
        for i in range(n):
            yield _sample(i, int(labels[i])), int(labels[i])
    return reader


def train():
    return _reader(TRAIN_SIZE, 1)


def test():
    return _reader(TEST_SIZE, 2)


def reader_creator(image_filename, label_filename, buffer_size=100):
    """Parse REAL idx-format MNIST files (the reference's
    dataset/mnist.py:40 reader_creator): gzipped big-endian idx —
    images magic 2051 ``>IIII`` header then uint8 pixels, labels magic
    2049 ``>II`` then uint8 labels. Yields (float32[784] scaled to
    [-1, 1], int label) like the synthetic readers."""
    import gzip
    import struct

    def reader():
        with gzip.GzipFile(image_filename, "rb") as f:
            img_buf = f.read()
        with gzip.GzipFile(label_filename, "rb") as f:
            lab_buf = f.read()
        magic_img, image_num, rows, cols = struct.unpack_from(
            ">IIII", img_buf, 0)
        if magic_img != 2051:
            raise ValueError(
                f"{image_filename}: bad idx image magic {magic_img}")
        magic_lab, label_num = struct.unpack_from(">II", lab_buf, 0)
        if magic_lab != 2049:
            raise ValueError(
                f"{label_filename}: bad idx label magic {magic_lab}")
        n = min(image_num, label_num)
        px = rows * cols
        off_img, off_lab = struct.calcsize(">IIII"), struct.calcsize(">II")
        for i in range(0, n, buffer_size):
            cnt = min(buffer_size, n - i)
            images = np.frombuffer(
                img_buf, ">u1", count=cnt * px,
                offset=off_img + i * px).reshape(cnt, px)
            images = images.astype(np.float32) / 255.0 * 2.0 - 1.0
            labels = np.frombuffer(lab_buf, ">u1", count=cnt,
                                   offset=off_lab + i)
            for j in range(cnt):
                yield images[j], int(labels[j])

    return reader
