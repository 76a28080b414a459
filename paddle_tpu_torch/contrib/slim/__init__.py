"""Model compression (counterpart of ``paddle_tpu/contrib/slim``;
reference python/paddle/fluid/contrib/slim/): ``CompressPass`` drives
``Strategy`` callbacks over a training loop (``core``), ``ImitationGraph``
wraps a Program (``graph``), the magnitude and ratio pruners with the
iterative ``PruneStrategy`` (``prune``), and the yaml ``ConfigFactory``.
Quantization is ``contrib.quantize``."""

from . import core, graph, prune
from .core import CompressPass, ConfigFactory, Context, Strategy
from .graph import Graph, ImitationGraph, get_executor
from .prune import (MagnitudePruner, Pruner, PruneStrategy, RatioPruner,
                    SensitivePruneStrategy)

__all__ = ["core", "graph", "prune", "CompressPass", "ConfigFactory",
           "Context", "Strategy", "Graph", "ImitationGraph",
           "get_executor", "Pruner", "MagnitudePruner", "RatioPruner",
           "PruneStrategy", "SensitivePruneStrategy"]
