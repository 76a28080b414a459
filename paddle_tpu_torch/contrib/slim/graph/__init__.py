"""slim.graph: the graph a strategy compresses, and the executor that
runs it (reference contrib/slim/graph/)."""

from .executor import GraphExecutor, get_executor
from .graph import Graph, ImitationGraph

__all__ = ["Graph", "ImitationGraph", "GraphExecutor", "get_executor"]
