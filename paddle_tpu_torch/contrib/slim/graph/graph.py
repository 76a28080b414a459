"""Graph wrappers (reference contrib/slim/graph/graph.py Graph,
ImitationGraph): the strategies address a Program through one surface."""

from __future__ import annotations

__all__ = ["Graph", "ImitationGraph"]


class Graph:
    """Base class of the graphs a strategy can compress."""

    def all_parameters(self):
        raise NotImplementedError

    def program(self):
        raise NotImplementedError


class ImitationGraph(Graph):
    """A Graph over a Program (graph.py:33 ImitationGraph), or over a
    CompiledProgram, which the executor runs as it is and whose program
    lists the parameters."""

    def __init__(self, program=None):
        from ....framework import default_main_program

        self._program = program or default_main_program()

    def all_parameters(self):
        return getattr(self._program, "_program",
                       self._program).all_parameters()

    def program(self):
        return self._program

    def global_block(self):
        return getattr(self._program, "_program",
                       self._program).global_block()
