"""``guard``, ``enabled`` and ``to_variable`` (counterpart of
``paddle_tpu/imperative/base.py``, after python/paddle/fluid/imperative/
base.py)."""

from __future__ import annotations

import contextlib

from ..place import CUDAPlace, Place
from . import tracer as tracer_mod
from .tracer import Tracer, VarBase


def enabled() -> bool:
    return tracer_mod._tracer is not None


@contextlib.contextmanager
def guard(place=None, seed: int = 0):
    """Enter imperative mode on ``place``: the card (``CUDAPlace(0)``)
    unless the caller passes another place, such as ``CPUPlace()``.
    Without a card and without a place it raises. An int first argument
    is the seed, as in the JAX package; the seed starts the tracer's
    ``torch.Generator``."""
    if isinstance(place, int):
        seed, place = place, None
    if place is None:
        place = CUDAPlace(0)
    device = place.torch_device if isinstance(place, Place) else place
    prev = tracer_mod._tracer
    tracer_mod._tracer = Tracer(seed, device)
    try:
        yield
    finally:
        tracer_mod._tracer = prev


def to_variable(value, block=None, name=None) -> VarBase:
    if isinstance(value, VarBase):
        return value
    return VarBase(value, stop_gradient=False, name=name or "")
