"""Def-use analysis over ordered op lists (counterpart of the
``DefUse`` view of ``paddle_tpu/ir/analyze.py``): the one home of the
reader/writer indexes and the moved-read legality rule that the
pipeline's fusions and the multi-tensor optimizer fuse share.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set

from ..core.desc import OpDesc

__all__ = ["DefUse", "writer_counts", "read_positions", "write_positions"]


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


def writer_counts(ops: Sequence[OpDesc]) -> Dict[str, int]:
    return DefUse(ops).writer_counts()


def read_positions(ops: Sequence[OpDesc]) -> Dict[str, List[int]]:
    return DefUse(ops).readers


def write_positions(ops: Sequence[OpDesc]) -> Dict[str, List[int]]:
    return DefUse(ops).writers
