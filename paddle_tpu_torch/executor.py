"""Scope + Executor: the block interpreted op by op, eagerly.

Counterpart of ``paddle_tpu/executor.py``. Where the JAX package traces a
whole block into one XLA executable, this executor walks the block's ops
in order and calls each op's emitter on tensors, with sequential name
rebinding (reference executor.cc:432 is the same loop). Grad op types
resolve through ``registry.resolve_grad_emitter``. Ops that neither feed
a fetch nor write a persistable variable are skipped, so a test clone
runs without its label feeds and a train step drops dead grad branches.

A ``CompiledProgram`` runs its BuildStrategy's pass groups
(ir/pipeline.py) over that live op list first. The rewritten list is
memoized per (program version, fetch names, effective flags), so pattern
matching runs once per program, not once per step; ``pipeline_stats``
counts the pipeline's runs, its time per stage and the memo hits. A plain
Program runs no pass.

State contract: persistable variables live in the Scope across runs as
tensors on the executor's device. ``Executor()`` with no place runs on
``CUDAPlace(0)`` and raises when there is no CUDA device; the host runs
only when the caller passes ``CPUPlace()``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import registry
from .compiler import CompiledProgram
from .core.desc import OpDesc
from .core.types import dtype_to_torch
from .framework import Block, Variable, default_main_program
from .ir import pipeline
from .place import CUDAPlace, Place
from .registry import EmitContext
from .utils.flags import FLAGS


class Scope:
    """Name -> tensor store for persistable state (reference scope.h)."""

    def __init__(self):
        self._vars: Dict[str, Any] = {}
        self._generators: Dict[str, torch.Generator] = {}

    def find_var(self, name: str):
        return self._vars.get(name)

    def set_var(self, name: str, value):
        self._vars[name] = value

    def var_names(self) -> List[str]:
        return [n for n, v in self._vars.items() if v is not None]

    def generator(self, device: torch.device, seed: int) -> torch.Generator:
        """The scope's random stream on ``device``, seeded at first use."""
        key = str(device)
        gen = self._generators.get(key)
        if gen is None:
            gen = self._generators[key] = torch.Generator(device=device)
            gen.manual_seed(seed)
        return gen


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """Swap the global scope for a ``with`` body."""
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = prev


def _is_persistable(block: Block, name: str) -> bool:
    v = block._var_recursive(name) if name else None
    return v is not None and v.persistable


def _live_ops(ops: List[OpDesc], fetch_names, block: Block) -> List[OpDesc]:
    """Backward slice: ops that reach a fetch, write a persistable
    variable, or touch the host."""
    needed = set(fetch_names)
    kept = []
    for op in reversed(ops):
        is_host = registry.has_op(op.type) and registry.lookup(op.type).is_host
        if is_host or any(n in needed or _is_persistable(block, n)
                          for n in op.output_arg_names()):
            kept.append(op)
            needed.update(n for n in op.input_arg_names() if n)
    kept.reverse()
    return kept


def _coerce_feed(value, name: str, block: Block, device: torch.device):
    """A feed as a tensor on ``device`` in the dtype the program declares
    (int64 ids stay int64; lengths keep their declared type)."""
    want = None
    if block.has_var(name) and block.vars[name].dtype is not None:
        want = dtype_to_torch(block.vars[name].dtype)
    if not isinstance(value, torch.Tensor):
        return torch.tensor(np.asarray(value), dtype=want, device=device)
    return value.to(device=device, dtype=want or value.dtype)


def _emitter(op_type: str):
    """The op's emitter; a ``<type>_grad`` without one of its own takes
    the generic vjp."""
    try:
        return registry.resolve_grad_emitter(op_type)
    except KeyError:
        raise NotImplementedError(f"operator {op_type!r} has no emitter in "
                                  "paddle_tpu_torch yet") from None


def run_ops(op_list: List[OpDesc], env: Dict[str, Any], ctx: EmitContext):
    """Run ``op_list`` in order; inputs come from ``env`` or the scope,
    outputs are bound into ``env``."""
    for op in op_list:
        emitter = _emitter(op.type)
        ins = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                if not n:
                    vals.append(None)
                    continue
                val = env.get(n)
                if val is None:
                    val = ctx.scope.find_var(n)
                if val is None:
                    raise KeyError(f"op {op.type!r} reads {n!r}, which is "
                                   "neither fed nor in the scope")
                vals.append(val)
            ins[slot] = vals
        outs = emitter(ctx, ins, op.attrs)
        for slot, names in op.outputs.items():
            for n, v in zip(names, (outs or {}).get(slot) or ()):
                if n and v is not None:
                    env[n] = v


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()  # numpy has no bfloat16
    return t.numpy()


def _fetch_names(fetch_list) -> List[str]:
    return [f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or [])]


class Executor:
    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device
        # the BuildStrategy pipeline on this executor: runs (memo
        # misses), memo hits, and per stage its ops removed and seconds
        self.pipeline_stats = {"runs": 0, "memo_hits": 0, "seconds": 0.0,
                               "stages": {}}

    def lowered_ops(self, program=None, fetch_list=None) -> List[OpDesc]:
        """The op list ``run`` executes for ``program`` and
        ``fetch_list``: the live ops of block 0, rewritten by the pass
        pipeline when ``program`` is a CompiledProgram."""
        return self._prepare(program, _fetch_names(fetch_list))[1]

    def _prepare(self, program, fetch_names):
        """(Program, op list) of a run."""
        program = program or default_main_program()
        build_strategy = None
        if isinstance(program, CompiledProgram):
            program._check_ported()
            build_strategy = program._build_strategy
            program = program._program
        if FLAGS.verify_passes or getattr(build_strategy, "verify_passes",
                                          False):
            raise NotImplementedError(
                "verify_passes (ir/verify.py, the pass verifier) waits for "
                "ROADMAP A14")
        block = program.global_block()
        ops = _live_ops([op for op in block.desc.ops
                         if op.type not in ("feed", "fetch")],
                        fetch_names, block)
        flags = pipeline.effective_flags(pipeline.fingerprint(build_strategy),
                                         self.device.type)
        if not flags:
            return program, ops
        memo = program.__dict__.setdefault("_pass_memo", {})
        key = (program._version, tuple(fetch_names), flags)
        optimized = memo.get(key)
        if optimized is not None:
            self.pipeline_stats["memo_hits"] += 1
            return program, optimized
        # needed by name: the fetches and the persistable state the
        # list writes
        needed = set(fetch_names) | {
            n for op in ops for n in op.output_arg_names()
            if _is_persistable(block, n)}
        t0 = time.perf_counter()
        optimized = pipeline.run_pipeline(ops, block, needed, flags,
                                          self.pipeline_stats["stages"])
        self.pipeline_stats["seconds"] += time.perf_counter() - t0
        self.pipeline_stats["runs"] += 1
        memo[key] = optimized
        return program, optimized

    def run(self, program=None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True):
        """Run block 0 of ``program`` (a Program or a CompiledProgram).
        Fetches come back as numpy arrays, or as tensors on the device
        with ``return_numpy=False``."""
        scope = scope or global_scope()
        fetch_names = _fetch_names(fetch_list)
        program, ops = self._prepare(program, fetch_names)
        block = program.global_block()
        env = {name: _coerce_feed(value, name, block, self.device)
               for name, value in (feed or {}).items()}
        generator = None
        if any(registry.has_op(op.type) and registry.lookup(op.type).needs_rng
               for op in ops):
            generator = scope.generator(self.device,
                                        program.random_seed or FLAGS.seed)
        ctx = EmitContext(self.device, generator=generator, amp=program._amp,
                          scope=scope)
        # grad ops differentiate with torch.func.vjp, which records its
        # forward under no_grad too
        with torch.no_grad():
            run_ops(ops, env, ctx)
        for name, val in env.items():
            if _is_persistable(block, name):
                scope.set_var(name, val)
        results = []
        for n in fetch_names:
            val = env[n] if n in env else scope.find_var(n)
            if val is None:
                raise KeyError(f"fetch {n!r} was not computed by this run")
            results.append(_to_numpy(val) if return_numpy else val)
        return results
