"""Def-use analysis over op lists and programs (counterpart of
``paddle_tpu/ir/analyze.py``): the one home of the reader/writer indexes
and the moved-read legality rule that the pipeline's fusions and the
multi-tensor optimizer fuse share, the block-nesting-aware
``ProgramDefUse`` and the RNG-op sequence the verifier (ir/verify.py)
checks on the same index, so what the passes assume and what the
verifier checks cannot drift apart.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..core.desc import BlockDesc, OpDesc

__all__ = ["DefUse", "ProgramDefUse", "writer_counts", "read_positions",
           "write_positions", "rng_sequence", "CONTROL_ATTRS"]

# attrs that carry program structure (sub-blocks): ops holding them are
# control flow, and their sub-block's reads and writes surface on them
CONTROL_ATTRS = ("sub_block", "block", "sub_block_idx",
                 "__grad_sub_block__", "__ssa_sub_block__")


class DefUse:
    """Positional def-use index over one ordered op list.

    ``ops`` is never mutated; indexes are positions into the list as
    given. Empty names ("" grad holes) are ignored everywhere.
    """

    __slots__ = ("ops", "writers", "readers")

    def __init__(self, ops: Sequence[OpDesc]):
        self.ops = ops
        self.writers: Dict[str, List[int]] = {}
        self.readers: Dict[str, List[int]] = {}
        for i, op in enumerate(ops):
            for n in op.input_arg_names():
                if n:
                    self.readers.setdefault(n, []).append(i)
            for n in op.output_arg_names():
                if n:
                    self.writers.setdefault(n, []).append(i)

    def writer_counts(self) -> Dict[str, int]:
        return {n: len(w) for n, w in self.writers.items()}

    def read_positions(self, name: str) -> List[int]:
        return self.readers.get(name, [])

    def write_positions(self, name: str) -> List[int]:
        return self.writers.get(name, [])

    def readers_after(self, name: str, pos: int) -> List[int]:
        return [r for r in self.readers.get(name, ()) if r > pos]

    def external_reads(self) -> Set[str]:
        """Names read before any write in this list: the list's inputs
        (feeds, scope state, outer-block values)."""
        out: Set[str] = set()
        for n, reads in self.readers.items():
            w = self.writers.get(n)
            if w is None or reads[0] < w[0]:
                out.add(n)
        return out

    def single_writer(self, name: str) -> bool:
        return len(self.writers.get(name, ())) == 1

    def writes_between(self, name: str, lo: int, hi: int) -> bool:
        """True when any write of ``name`` lands in the half-open
        position range (lo, hi]: the interference test for a read
        moved from slot ``lo`` to slot ``hi``."""
        return any(lo < w <= hi for w in self.writers.get(name, ()))

    def moved_reads_safe(self, names: Iterable[str],
                         members: Sequence[int], placement: int) -> bool:
        """The moved-read rule every chain fusion relies on: a fused op
        placed at ``placement`` reads each of ``names`` there, while the
        original chain read it at its FIRST read among ``members``. The
        move is invisible iff no write of the name lands between those
        two slots (writes after ``placement``, the optimizer's in-place
        parameter update, are fine)."""
        for n in names:
            if not n:
                continue
            reads = [j for j in members
                     if n in self.ops[j].input_arg_names()]
            r0 = min(reads) if reads else placement
            if self.writes_between(n, r0, placement):
                return False
        return True

    def group_interference(self, members: Sequence[int],
                           member_reads: Set[str],
                           member_writes: Set[str]) -> Optional[int]:
        """The grouped-fuse legality probe (multi-tensor optimizer
        fuse): the fused op sits at the LAST member's slot, so a
        non-member op between the group's first and last member must
        not read or write anything a member writes, nor write anything
        a member reads. Returns the first offending position, or None
        when the group is safe to fuse."""
        mset = set(members)
        for j in range(min(members), max(members) + 1):
            if j in mset:
                continue
            op = self.ops[j]
            ins = set(op.input_arg_names())
            outs = set(op.output_arg_names())
            if (ins | outs) & member_writes or outs & member_reads:
                return j
        return None


class ProgramDefUse:
    """Block-nesting-aware def-use over a Program or ProgramDesc: a
    ``DefUse`` per block, in which a control-flow op (attr ``sub_block``)
    counts as reader and writer of every outer name its sub-block,
    transitively, reads and writes."""

    def __init__(self, program):
        desc = getattr(program, "desc", program)
        self.desc = desc
        self.blocks: List[BlockDesc] = list(desc.blocks)
        self._ext: Dict[int, Tuple[Set[str], Set[str]]] = {}
        self.block_du: Dict[int, DefUse] = {
            b.idx: DefUse(self._expanded_ops(b)) for b in self.blocks}

    def sub_block_idx(self, op: OpDesc) -> Optional[int]:
        for a in CONTROL_ATTRS:
            v = op.attrs.get(a)
            if isinstance(v, int) and 0 <= v < len(self.blocks):
                return v
        return None

    def _block_ext(self, idx: int) -> Tuple[Set[str], Set[str]]:
        """(reads, writes) of block ``idx`` that resolve outside it."""
        if idx in self._ext:
            return self._ext[idx]
        self._ext[idx] = (set(), set())  # a cycle reads nothing more
        blk = self.blocks[idx]
        reads: Set[str] = set()
        writes: Set[str] = set()
        for op in blk.ops:
            reads.update(n for n in op.input_arg_names() if n)
            writes.update(n for n in op.output_arg_names() if n)
            sub = self.sub_block_idx(op)
            if sub is not None and sub != idx:
                sr, sw = self._block_ext(sub)
                reads |= sr
                writes |= sw
        local = set(blk.vars)
        self._ext[idx] = (reads - local, writes - local)
        return self._ext[idx]

    def _expanded_ops(self, blk: BlockDesc) -> List[OpDesc]:
        """The block's ops, a control op's sub-block reads and writes
        folded into extra slots of a shadow desc."""
        out = []
        for op in blk.ops:
            sub = self.sub_block_idx(op)
            if sub is None or sub == blk.idx:
                out.append(op)
                continue
            sr, sw = self._block_ext(sub)
            out.append(OpDesc(op.type,
                              dict(op.inputs, __sub_reads__=sorted(sr)),
                              dict(op.outputs, __sub_writes__=sorted(sw)),
                              op.attrs))
        return out

    def def_use(self, block_idx: int = 0) -> DefUse:
        return self.block_du[block_idx]


def writer_counts(ops: Sequence[OpDesc]) -> Dict[str, int]:
    return DefUse(ops).writer_counts()


def read_positions(ops: Sequence[OpDesc]) -> Dict[str, List[int]]:
    return DefUse(ops).readers


def write_positions(ops: Sequence[OpDesc]) -> Dict[str, List[int]]:
    return DefUse(ops).writers


def rng_sequence(ops: Sequence[OpDesc]) -> List[str]:
    """The types of the random ops in the list, in order. The generator
    advances once per random op in program order, so a pass that removes,
    duplicates or reorders one changes every later draw: the invariant
    the pipeline keeps and the pass verifier checks."""
    from .. import registry
    return [op.type for op in ops
            if registry.has_op(op.type) and registry.lookup(op.type).needs_rng]
