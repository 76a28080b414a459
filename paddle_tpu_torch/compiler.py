"""CompiledProgram, BuildStrategy and ExecutionStrategy (counterpart of
``paddle_tpu/compiler.py``; reference python/paddle/fluid/compiler.py).

``CompiledProgram(program, build_strategy=bs)`` hands the executor the
program with the BuildStrategy whose flags select the pass groups of
ir/pipeline.py: ``fuse_attention_ops``, ``memory_optimize``,
``fuse_elewise_add_act_ops``, ``fuse_all_optimizer_ops`` and
``fuse_conv_ops``. The executor runs them on the live op list and
memoizes the result per program version, fetch names and flags.
``gradient_accumulation_steps`` M > 1 runs each step as M microbatches
with one optimizer update (executor.py, ``_Accumulation``); no pass runs
then, as in the JAX package.

Knobs whose machinery is not ported raise ``NotImplementedError`` naming
the ROADMAP item that ports it, when the program runs (or, for the
data-parallel entry points, when they are called); none is silently
ignored. The knobs the JAX package itself accepts and ignores (thread
counts, ``enable_inplace``, the graphviz path and the like) are accepted
here too.
"""

from __future__ import annotations

import enum


class ReduceStrategy(enum.IntEnum):
    AllReduce = 0
    Reduce = 1


class GradientScaleStrategy(enum.IntEnum):
    CoeffNumDevice = 0
    One = 1
    Customized = 2


_A12 = "ROADMAP A12 (multi-device)"


class BuildStrategy:
    """details/build_strategy.h:55-96 analog, with the JAX package's
    attributes and defaults. All pass flags default off."""

    ReduceStrategy = ReduceStrategy
    GradientScaleStrategy = GradientScaleStrategy

    def __init__(self):
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.gradient_scale_strategy = GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        self.enable_sequential_execution = False
        self.fuse_elewise_add_act_ops = False   # ir/pipeline.py
        self.fuse_broadcast_op = False
        self.fuse_all_optimizer_ops = False     # multi-tensor fused_adam
        self.memory_optimize = False            # fold + CSE + prune
        self.fuse_conv_ops = False              # conv + bn, conv epilogue
        self.fuse_attention_ops = False         # chain -> flash_attention
        self.verify_passes = False              # ir/verify.py: ROADMAP A14
        self.auto_parallel = False              # ROADMAP A12
        self.enable_inplace = True
        self.num_trainers = 1
        self.trainer_id = 0
        self.gradient_accumulation_steps = 1    # executor.py _Accumulation


class ExecutionStrategy:
    """details/execution_strategy.h analog. ``num_iteration_per_run`` K
    > 1 makes each ``Executor.run`` of the CompiledProgram K steps on
    [K, batch, ...] feeds, as ``run(iterations=K)`` does."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1


class CompiledProgram:
    """fluid.compiler.CompiledProgram (compiler.py:37): one program and
    the BuildStrategy the executor runs it under."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        raise NotImplementedError(
            f"CompiledProgram.with_data_parallel waits for {_A12}")

    def with_distributed(self, strategy, loss_name=None,
                         build_strategy=None):
        raise NotImplementedError(
            f"CompiledProgram.with_distributed waits for {_A12}")

    def with_inference_optimize(self, config=None):
        return self

    @property
    def program(self):
        return self._program

    def _check_ported(self):
        """Raise on a knob whose machinery the port does not have
        (``verify_passes`` is checked by the executor, with its flag)."""
        bs = self._build_strategy
        if getattr(bs, "auto_parallel", False):
            raise NotImplementedError(
                f"BuildStrategy.auto_parallel waits for {_A12}")
