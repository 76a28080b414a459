"""Analysis view over a Block's ops (counterpart of
``paddle_tpu/ir/graph.py``; reference ir/graph.h:63).

Programs built by the LayerHelper are SSA by construction (unique output
names), so the graph is a reader/writer index over the BlockDesc, enough
for the pattern passes, rather than a node soup. In-place rebinds
appear as multi-writer vars and are treated conservatively by passes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.desc import BlockDesc, OpDesc


class Graph:
    def __init__(self, program, block_idx: int = 0):
        self.program = program
        self.block = program.block(block_idx)
        self.desc: BlockDesc = self.block.desc
        self.rebuild()

    def rebuild(self):
        self.writers: Dict[str, List[int]] = {}
        self.readers: Dict[str, List[int]] = {}
        for i, op in enumerate(self.desc.ops):
            for n in op.input_arg_names():
                self.readers.setdefault(n, []).append(i)
            for n in op.output_arg_names():
                self.writers.setdefault(n, []).append(i)

    @property
    def ops(self) -> List[OpDesc]:
        return self.desc.ops

    def producer(self, var: str) -> Optional[int]:
        """Index of the single op writing `var`, else None."""
        w = self.writers.get(var, [])
        return w[0] if len(w) == 1 else None

    def consumers(self, var: str) -> List[int]:
        return self.readers.get(var, [])

    def single_consumer(self, var: str) -> Optional[int]:
        c = self.consumers(var)
        return c[0] if len(c) == 1 else None

    def is_fetched(self, var: str, protected) -> bool:
        """A var that must survive rewrites: fetch target / persistable."""
        if var in protected:
            return True
        vd = self.desc.vars.get(var)
        return bool(vd is not None and vd.persistable)

    def replace_ops(self, ops: List[OpDesc]):
        self.desc.ops = ops
        self.rebuild()

    def to_dot(self, name: str = "program") -> str:
        """graphviz dump (graph_viz_pass.cc analog)."""
        lines = [f"digraph {name} {{", "  rankdir=TB;",
                 '  node [shape=box, fontsize=10];']
        seen_vars = set()
        for i, op in enumerate(self.desc.ops):
            lines.append(f'  op{i} [label="{op.type}", '
                         'style=filled, fillcolor=lightsteelblue];')
            for n in op.input_arg_names():
                v = f'var_{n}'.replace(".", "_").replace("@", "_")
                if n not in seen_vars:
                    lines.append(f'  {v} [label="{n}", shape=ellipse, '
                                 'fontsize=9];')
                    seen_vars.add(n)
                lines.append(f"  {v} -> op{i};")
            for n in op.output_arg_names():
                v = f'var_{n}'.replace(".", "_").replace("@", "_")
                if n not in seen_vars:
                    lines.append(f'  {v} [label="{n}", shape=ellipse, '
                                 'fontsize=9];')
                    seen_vars.add(n)
                lines.append(f"  op{i} -> {v};")
        lines.append("}")
        return "\n".join(lines)
