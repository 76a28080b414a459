"""Datasets (counterpart of ``paddle_tpu/dataset``, after the reference's
python/paddle/dataset/). Each is the JAX package's deterministic
synthetic reader in plain numpy, with the original's record schema, value
ranges and reader API (``train()``/``test()`` return reader factories), so
the same seeds give the same rows in both packages. Nothing is
downloaded."""

from . import conll05

__all__ = ["conll05"]
