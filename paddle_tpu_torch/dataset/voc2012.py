"""VOC2012 segmentation dataset (counterpart of
``paddle_tpu/dataset/voc2012.py``, after the reference's python/paddle/dataset/voc2012.py).

Schema: (image HWC uint8 array, label HW uint8 array) decoded from the
REAL VOCtrainval tar layout: ``VOCdevkit/VOC2012/ImageSets/
Segmentation/{trainval,train,val}.txt`` naming JPEG images under
``JPEGImages/`` and PNG class masks under ``SegmentationClass/``
(reference voc2012.py:37-66). When the tarball is absent (nothing is
downloaded) a deterministic synthetic set of image/mask pairs with the same
shapes is generated.
"""

from __future__ import annotations

import io
import tarfile

import numpy as np

from .common import local_or_none

__all__ = ["train", "test", "val"]

VOC_URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
           "VOCtrainval_11-May-2012.tar")
VOC_MD5 = "6cd6e144f989b92b3379bac3b3de84fd"
SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

CACHE_DIR = "voc2012"


def reader_creator(filename, sub_name):
    """Stream (image, mask) pairs for one split out of the tar."""
    from PIL import Image

    tarobject = tarfile.open(filename)
    name2mem = {m.name: m for m in tarobject.getmembers()}

    def reader():
        sets = tarobject.extractfile(name2mem[SET_FILE.format(sub_name)])
        for line in sets:
            key = line.strip().decode()
            if not key:
                continue
            data = tarobject.extractfile(
                name2mem[DATA_FILE.format(key)]).read()
            label = tarobject.extractfile(
                name2mem[LABEL_FILE.format(key)]).read()
            yield (np.array(Image.open(io.BytesIO(data))),
                   np.array(Image.open(io.BytesIO(label))))

    return reader


def _synthetic(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            h, w = int(rng.randint(32, 64)), int(rng.randint(32, 64))
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            mask = np.zeros((h, w), np.uint8)
            cls = int(rng.randint(1, 21))
            y0, x0 = int(rng.randint(0, h // 2)), int(rng.randint(0, w // 2))
            mask[y0:y0 + h // 2, x0:x0 + w // 2] = cls
            yield img, mask

    return reader


def _make(sub_name, n, seed):
    t = local_or_none(VOC_URL, CACHE_DIR)
    if t is not None:
        return reader_creator(t, sub_name)
    return _synthetic(n, seed)


def train():
    """trainval split, HWC order (reference voc2012.py:69)."""
    return _make("trainval", 64, 61)


def test():
    """train split (the reference's quirk: test() reads 'train')."""
    return _make("train", 32, 62)


def val():
    return _make("val", 32, 63)
