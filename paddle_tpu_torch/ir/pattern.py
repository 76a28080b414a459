"""GraphPatternDetector analog (counterpart of ``paddle_tpu/ir/pattern.py``;
reference ir/graph_pattern_detector.cc).

The reference builds a PDPattern of PDNodes with per-node predicates and
runs subgraph isomorphism over the ir::Graph, feeding each match to a
handler. Desc-level equivalent: a pattern is an ordered list of
``PNode``s whose input/output slots reference symbolic var names;
matching walks the block's ops and binds symbols greedily with
backtracking. Enough expressive power for the fusion pass zoo
(linear/DAG chains with shared symbols), a fraction of the machinery.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from ..core.desc import OpDesc
from .graph import Graph


class PNode:
    """One op in a pattern.

    ``inputs``/``outputs``: slot -> symbol. A symbol binds to the
    concrete var name on first use and must agree everywhere after
    (graph_pattern_detector.h PDNode::LinksTo/LinksFrom analog).
    ``predicate``: optional extra check fn(op_desc, graph) -> bool.
    """

    def __init__(self, name: str, op_type: str,
                 inputs: Optional[Dict[str, str]] = None,
                 outputs: Optional[Dict[str, str]] = None,
                 predicate: Optional[Callable] = None):
        self.name = name
        self.op_type = op_type
        self.inputs = dict(inputs or {})
        self.outputs = dict(outputs or {})
        self.predicate = predicate


class Match:
    """One found subgraph: pattern node name -> op index, symbol -> var."""

    def __init__(self, ops: Dict[str, int], vars: Dict[str, str]):
        self.ops = ops
        self.vars = vars

    def op_indices(self) -> List[int]:
        return sorted(self.ops.values())


class GraphPatternDetector:
    """detector(graph).detect(pattern) -> non-overlapping Matches."""

    def __init__(self, graph: Graph):
        self.graph = graph

    # -- binding helpers ------------------------------------------------
    @staticmethod
    def _bind_slots(op: OpDesc, slot_map, getter, binding) -> Optional[dict]:
        new = {}
        for slot, sym in slot_map.items():
            names = getter(slot)
            if len(names) != 1:
                return None
            concrete = names[0]
            bound = binding.get(sym, new.get(sym))
            if bound is None:
                new[sym] = concrete
            elif bound != concrete:
                return None
        return new

    def _try_node(self, node: PNode, idx: int, binding) -> Optional[dict]:
        op = self.graph.ops[idx]
        if op.type != node.op_type:
            return None
        upd = self._bind_slots(op, node.inputs, op.input, binding)
        if upd is None:
            return None
        binding2 = dict(binding)
        binding2.update(upd)
        upd_out = self._bind_slots(op, node.outputs, op.output, binding2)
        if upd_out is None:
            return None
        binding2.update(upd_out)
        if node.predicate is not None and not node.predicate(op, self.graph):
            return None
        return binding2

    def detect(self, pattern: Sequence[PNode]) -> List[Match]:
        """All non-overlapping matches, anchored on the first node."""
        matches: List[Match] = []
        used: set = set()
        n_ops = len(self.graph.ops)

        def search(p_idx: int, binding, chosen: Dict[str, int]):
            if p_idx == len(pattern):
                return binding, dict(chosen)
            node = pattern[p_idx]
            for idx in range(n_ops):
                if idx in used or idx in chosen.values():
                    continue
                b2 = self._try_node(node, idx, binding)
                if b2 is None:
                    continue
                chosen[node.name] = idx
                res = search(p_idx + 1, b2, chosen)
                if res is not None:
                    return res
                del chosen[node.name]
            return None

        while True:
            res = search(0, {}, {})
            if res is None:
                break
            binding, chosen = res
            used.update(chosen.values())
            matches.append(Match(chosen, binding))
        return matches


def intermediates_safe(graph: Graph, match: Match, keep_syms,
                       protected) -> bool:
    """True when every matched var NOT in keep_syms is single-consumer
    and not fetched/persistable — i.e. the subgraph may be collapsed."""
    keep = {match.vars[s] for s in keep_syms if s in match.vars}
    idxs = set(match.op_indices())
    for sym, var in match.vars.items():
        if var in keep:
            continue
        if graph.is_fetched(var, protected):
            return False
        cons = graph.consumers(var)
        if any(c not in idxs for c in cons):
            return False
    return True
