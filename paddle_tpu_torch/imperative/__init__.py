"""Imperative (dygraph) mode (counterpart of ``paddle_tpu/imperative``,
after the reference's proto-dygraph: ``Tracer`` tracer.h:40,
``VarBase``/``OpBase``/``Layer`` layer.h:104,191,233, RunBackward
layer.cc:274 and python/paddle/fluid/imperative/). Ops run eagerly on the
tracer's device through the same registry emitters the executor runs;
torch autograd records the graph and ``backward()`` walks it. No
ProgramDesc is involved. ``guard()`` runs on the card unless it is given
``CPUPlace()``.
"""

from .base import enabled, guard, to_variable
from .layers import (BatchNorm, Conv2D, Embedding, FC, Layer, Pool2D,
                     PyLayer)
from .optimizer import AdamOptimizer, SGDOptimizer
from .recompute import recompute
from .tracer import Tracer, VarBase, trace_op

__all__ = ["guard", "enabled", "to_variable", "Layer", "PyLayer",
           "FC", "Conv2D", "Pool2D", "BatchNorm", "Embedding",
           "Tracer", "VarBase", "trace_op", "SGDOptimizer",
           "AdamOptimizer", "recompute"]
