"""The executor adapter (reference contrib/slim/graph/executor.py
get_executor): runs a Graph's program on the Executor with the (feed,
fetches, scope) surface the strategies use. ``place`` None is the
card."""

from __future__ import annotations

__all__ = ["GraphExecutor", "get_executor"]


class GraphExecutor:
    def __init__(self, place=None):
        from ....executor import Executor

        self.place = place
        self.exe = Executor(place)

    def run(self, graph, scope=None, feed=None, fetches=None):
        fetch_list = list(fetches) if fetches else []
        return self.exe.run(graph.program(), feed=feed,
                            fetch_list=fetch_list, scope=scope)


def get_executor(graph, place=None):
    from .graph import ImitationGraph

    if not isinstance(graph, ImitationGraph):
        raise ValueError("get_executor expects an ImitationGraph")
    return GraphExecutor(place)
