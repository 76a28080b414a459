"""Iterative pruning strategies (reference contrib/slim/prune/
prune_strategy.py: PruneStrategy:38, SensitivePruneStrategy:24).

PruneStrategy applies the pruner's keep-masks to every selected
parameter each ``mini_batch_pruning_frequency`` batches within its epoch
window, so weights the optimizer revives between triggers are pruned
again. The masks are computed by a mask program on the device the
weights are on, and applied in place (``mul_``): the scope keeps its
tensors, so a captured train step keeps its graph. The values are the
JAX package's, whose arrays the scope rebinds."""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch

from ....executor import Executor, global_scope
from ....framework import Program, program_guard
from ....place import CPUPlace, CUDAPlace
from ....utils import unique_name
from ..core.strategy import Strategy

__all__ = ["PruneStrategy", "SensitivePruneStrategy"]


class PruneStrategy(Strategy):
    """Prune weights by the pruner's mask, iteratively during training.

    Args as prune_strategy.py:44: ``pruner``,
    ``mini_batch_pruning_frequency``, ``start_epoch``/``end_epoch``;
    ``params`` restricts pruning to the names matching any of its regexes
    (default: every trainable parameter). ``fixed_mask`` computes the
    masks once, at the first trigger, and applies that pattern at every
    trigger (prune, then retrain); otherwise each trigger derives them
    from the current values, as the reference's on_batch_end does."""

    def __init__(self, pruner, mini_batch_pruning_frequency=1,
                 start_epoch=0, end_epoch=10,
                 params: Optional[Sequence[str]] = None,
                 fixed_mask: bool = False):
        super().__init__(start_epoch, end_epoch)
        self.pruner = pruner
        self.mini_batch_pruning_frequency = mini_batch_pruning_frequency
        self.params = list(params) if params is not None else None
        self.fixed_mask = fixed_mask
        self._masks = None
        self._mask_prog = None

    # ------------------------------------------------------------------
    def _selected(self, graph):
        for p in graph.all_parameters():
            if not getattr(p, "trainable", True):
                continue
            if self.params is None or any(
                    re.fullmatch(pat, p.name) for pat in self.params):
                yield p

    def _trigger(self, context):
        return (context.batch_id % self.mini_batch_pruning_frequency == 0
                and self.start_epoch <= context.epoch_id < self.end_epoch)

    def compute_masks(self, context):
        """{param name: keep-mask tensor} from the pruner's mask program
        over the current weights, run by ``context.program_exe`` or by an
        executor on the weights' device. The program is built once: a new
        one each trigger would make a new plan each batch."""
        if self._mask_prog is None:
            prune_program = Program()
            mask_names = {}
            with program_guard(prune_program, Program()), \
                    unique_name.guard():
                blk = prune_program.global_block()
                for param in self._selected(context.graph):
                    p = blk.create_var(name=param.name,
                                       dtype=param.dtype,
                                       shape=param.shape,
                                       persistable=True)
                    mask_names[param.name] = self.pruner.prune(p)
            self._mask_prog = (prune_program, mask_names)
        prune_program, mask_names = self._mask_prog
        if not mask_names:
            return {}
        scope = context.scope or global_scope()
        exe = context.program_exe
        if exe is None:
            dev = scope.find_var(next(iter(mask_names))).device
            exe = Executor(CPUPlace() if dev.type == "cpu"
                           else CUDAPlace(dev.index or 0))
        vals = exe.run(prune_program, fetch_list=list(mask_names.values()),
                       scope=scope, return_numpy=False)
        return {n: v.device_value() for n, v in zip(mask_names, vals)}

    def apply_masks(self, context):
        """Multiply each selected parameter by its mask, in place in the
        scope (prune_strategy.py:57's on_batch_end body)."""
        if self.fixed_mask:
            if self._masks is None:
                self._masks = self.compute_masks(context)
            masks = self._masks
        else:
            masks = self.compute_masks(context)
        scope = context.scope or global_scope()
        for name, mask in masks.items():
            t = scope.find_var(name)
            t.mul_(mask.to(device=t.device, dtype=t.dtype))

    # callbacks ---------------------------------------------------------
    def on_batch_end(self, context):
        if self._trigger(context):
            self.apply_masks(context)

    def on_compress_end(self, context):
        # leave the model pruned even if the last batch missed a trigger
        if self.start_epoch <= context.epoch_id:
            self.apply_masks(context)

    # diagnostics -------------------------------------------------------
    def sparsity(self, context) -> float:
        """The fraction of zero weights over the selected parameters."""
        scope = context.scope or global_scope()
        zero = total = 0
        for p in self._selected(context.graph):
            t = scope.find_var(p.name)
            zero += int(torch.count_nonzero(t == 0))
            total += t.numel()
        return zero / max(total, 1)


class SensitivePruneStrategy(Strategy):
    """Pruning on a per-parameter schedule (prune_strategy.py:24): each
    ratio with a known sensitivity falls by ``delta_rate`` an epoch down
    to that cap, then the masks are applied. The sensitivity search
    (retrain and measure against ``acc_loss_threshold``, stored for that
    caller's loop) stays with the caller."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=10,
                 delta_rate=0.20, acc_loss_threshold=0.2,
                 sensitivities=None):
        super().__init__(start_epoch, end_epoch)
        self.pruner = pruner
        self.delta_rate = delta_rate
        self.acc_loss_threshold = acc_loss_threshold
        self.sensitivities = dict(sensitivities or {})

    def on_epoch_end(self, context):
        if not (self.start_epoch <= context.epoch_id < self.end_epoch):
            return
        from .pruner import RatioPruner

        if isinstance(self.pruner, RatioPruner):
            # only a ratio with a sensitivity ramps: decaying an uncapped
            # one ('*') would drive its parameters to zero
            for name, ratio in list(self.pruner.ratios.items()):
                if name not in self.sensitivities:
                    continue
                self.pruner.ratios[name] = max(
                    self.sensitivities[name],
                    ratio * (1.0 - self.delta_rate))
        inner = PruneStrategy(self.pruner,
                              start_epoch=self.start_epoch,
                              end_epoch=self.end_epoch)
        inner.apply_masks(context)
