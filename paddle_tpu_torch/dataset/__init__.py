"""Datasets (counterpart of ``paddle_tpu/dataset``, after the reference's
python/paddle/dataset/). Each is the JAX package's deterministic
synthetic reader in plain numpy, with the original's record schema, value
ranges and reader API (``train()``/``test()`` return reader factories), so
the same seeds give the same rows in both packages; the real-format
parsers read the original archives where ``common.DATA_HOME`` holds them.
Nothing is downloaded. PIL is imported only by the functions that decode
images (``image``, ``voc2012``).
"""

from . import (cifar, common, conll05, flowers, image, imdb, imikolov,
               mnist, movielens, mq2007, sentiment, uci_housing,
               voc2012, wmt14, wmt16)

__all__ = ["cifar", "common", "conll05", "flowers", "image", "imdb",
           "imikolov", "mnist", "movielens", "mq2007", "sentiment",
           "uci_housing", "voc2012", "wmt14", "wmt16"]
