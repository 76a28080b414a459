"""slim.prune: the pruners and the iterative prune strategies
(reference contrib/slim/prune/)."""

from .prune_strategy import PruneStrategy, SensitivePruneStrategy
from .pruner import MagnitudePruner, Pruner, RatioPruner

__all__ = ["Pruner", "MagnitudePruner", "RatioPruner", "PruneStrategy",
           "SensitivePruneStrategy"]
