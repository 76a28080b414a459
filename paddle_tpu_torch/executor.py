"""Scope + Executor: a block split at its host ops into device segments,
each run as one plan: eagerly op by op, or on the card as a captured
CUDA graph replayed over static buffers.

Counterpart of ``paddle_tpu/executor.py``. Where the JAX package traces
each device segment into one XLA executable (``_compile_segment``), this
executor walks a segment's ops in order and calls each op's emitter on
tensors, with sequential name rebinding (reference executor.cc:432 is
the same loop); on a CUDA place it then captures that walk into a CUDA
graph. Grad op types resolve through ``registry.resolve_grad_emitter``.
Ops that neither feed a fetch nor write a persistable variable are
skipped, so a test clone runs without its label feeds and a train step
drops dead grad branches.

A ``CompiledProgram`` runs its BuildStrategy's pass groups
(ir/pipeline.py) over that live op list first. The rewritten list is
memoized per (program version, fetch names, effective flags), so pattern
matching runs once per program, not once per step; ``pipeline_stats``
counts the pipeline's runs, its time per stage and the runs a memoized
list served (from the pass memo or from a cached plan). A plain Program
runs no pass.

Plans. A run's plan is its op list split at host ops
(``_split_segments``), and for each device segment the names it reads
before writing (from the feed and earlier segments, or from the scope:
``state_in``), the persistables it writes (``state_out``) and the values
it hands on (fetches and reads of later segments). With
``FLAGS.jit_cache`` set (the default) plans are cached in
``program.__dict__["_exec_cache"]``, one per (program version, fetch
names, pass flags, feed signature, iterations, AMP, device, scope);
``close()`` drops the plans of every program this executor ran.

Capture (CUDA places with ``FLAGS.jit_cache``). A plan's first run is
eager: the warm-up, which makes the cuBLAS and cuDNN handles, loads the
kernels and fills the plan's constants. Its second run copies the feeds
into static buffers, releases the allocator's cached blocks and captures
each device segment with ``torch.cuda.graph`` on a side stream, into one
memory pool that every graph of the device shares (a graph's
temporaries are dead once its outputs are copied, and replays run one
after another on the caller's stream); then it replays. Later runs copy
the feeds into the static buffers and replay. Host segments run eagerly
between device segments, as in the JAX package. A capture that fails
raises; nothing falls back to an eager run. ``FLAGS.jit_cache = False``
keeps no plan, so every run is eager: the oracle the captured runs are
held against.

State contract: persistable variables live in the Scope across runs as
tensors on the executor's device, and a run updates them in place (the
JAX package donates their buffers): each ``state_out`` is copied into
the scope's tensor when the scope holds one of the same shape, dtype and
device, else bound. A graph reads and writes the tensors it captured;
before each replay the scope's tensors are checked by identity, and a
name rebound since the capture (``Scope.set_var``, a restore) drops the
plan's graphs, so that run is eager and the next captures anew. Random
ops draw from the scope's generator, registered with the graph, so K
replays advance it as K eager runs do. Fetches come back as numpy
arrays, or as ``FetchHandle``s on a device copy that later runs do not
touch.

Threads. ``run`` may be called from several threads at once, on one
plan too (a predictor's clones and the serving front share one
executor). Plan lookup and creation and each plan's run count are atomic
under the executor's lock. On the card one lock per device is held over
a capture, over an eager warm-up (which runs on the capture stream) and
over a replay from the copy of its inputs into the static buffers
through the copies of its outputs, so two callers of a plan each get
their own rows and no other graph of the shared pool replays in between.
The lock orders enqueueing only. A capture's error mode is the
capturing thread's own, so other threads may allocate while it runs.

``run(iterations=K)`` takes [K, batch, ...] super-batches and runs K
steps in one plan (one graph holds all K, step k reading slice k), with
fetches stacked [K, ...]; a block with host ops takes K single-step runs
instead, with a warning (``fuse_fallbacks`` counts them).

Gradient accumulation (``BuildStrategy.gradient_accumulation_steps`` or
``program._gradient_accumulation_steps`` M > 1; the JAX package's
BatchMergePass analog, reference ir/multi_batch_merge_pass.h): a device
segment holding optimizer ops splits at the optimizer boundary (ops of the
OPTIMIZE or LRSCHED role run once per step); its forward and backward run
M times, on the M microbatches of each feed's batch axis (a batch not
divisible by M raises); the first microbatch's gradients start the sums,
state written by the forward (batch_norm's statistics) threads from one
microbatch to the next, and the optimizer runs once on the mean
gradients. A fetch the forward makes is the mean over the microbatches
(the last one for an integer). The pass pipeline does not run on such a
program, as in the JAX package. On the card the M microbatches are
unrolled in the segment's one graph: the allocator reuses a microbatch's
temporaries for the next inside the graph's pool, so the peak holds one
microbatch's activations and the gradient sums, and a step is one replay
(an f+b graph replayed M times would add M launches and a host loop per
step for no smaller peak).

``Executor()`` with no place runs on ``CUDAPlace(0)`` and raises when
there is no CUDA device; the host runs only when the caller passes
``CPUPlace()``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import registry
from .compiler import CompiledProgram
from .core.desc import OpDesc
from .core.types import (OP_ROLE_ATTR_NAME, OP_ROLE_VAR_ATTR_NAME, OpRole,
                         dtype_to_torch)
from .framework import Block, Variable, default_main_program
from .ir import pipeline
from .place import CUDAPlace, Place
from .ops.kernels_control import trip_bound
from .registry import EmitContext
from .testing import faults as _faults
from .utils.flags import FLAGS

_scope_tokens = itertools.count(1)


class Scope:
    """Name -> tensor store for persistable state (reference scope.h)."""

    def __init__(self):
        self._vars: Dict[str, Any] = {}
        self._generators: Dict[str, torch.Generator] = {}
        # unique for the life of the process: a cached plan names the
        # scope whose tensors its graph reads by this token, never by id()
        self._token = next(_scope_tokens)

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


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()  # numpy has no bfloat16
    return t.numpy()


class FetchHandle:
    """A fetch of ``run(..., return_numpy=False)``: a device tensor of
    its own (a copy made on the stream after the run, so later runs do
    not touch it), read to the host only when asked: ``numpy()``,
    ``np.asarray(handle)`` or ``float(handle)``. ``shape``, ``dtype``,
    ``ndim`` and ``len`` need no transfer; ``dtype`` is that of the
    numpy array a read gives (float32 for a bfloat16 tensor, which numpy
    lacks). ``device_value()`` is the tensor; a handle fed back to
    ``run`` stays on the device."""

    __slots__ = ("_value", "_np")

    def __init__(self, value: torch.Tensor):
        self._value = value
        self._np = None

    def device_value(self) -> torch.Tensor:
        """The tensor, without a transfer."""
        return self._value

    def numpy(self) -> np.ndarray:
        """The value on the host (waits for the device once)."""
        if self._np is None:
            self._np = _to_numpy(self._value)
        return self._np

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        if dtype is not None and arr.dtype != np.dtype(dtype):
            arr = arr.astype(dtype)
        return arr

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._value.shape)

    @property
    def dtype(self) -> np.dtype:
        if self._value.dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return np.dtype(str(self._value.dtype).replace("torch.", ""))

    @property
    def ndim(self) -> int:
        return self._value.dim()

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        return self.numpy()[idx]

    def __float__(self):
        # numpy's rule: size 1 converts, size K raises, so a K-step
        # stacked fetch does not collapse to one step's value
        return float(self.numpy())

    def __repr__(self):
        return (f"FetchHandle(shape={self.shape}, dtype={self.dtype}, "
                f"device={self._value.device})")


def snapshot_value(value) -> FetchHandle:
    """A handle on a device copy of a scope value (or of a handle's
    tensor), which later runs, updating the scope in place, leave as
    it is."""
    if isinstance(value, FetchHandle):
        value = value.device_value()
    return FetchHandle(value.detach().clone())


def _unwrap_fetch_handle(value):
    """A fed FetchHandle stays on the device (its tensor, no read)."""
    return value.device_value() if isinstance(value, FetchHandle) else value


def _validate_super_batch(feed: Dict[str, Any], iterations: int):
    """Every feed of a K-step run must stack K per-step batches on a
    leading axis, checked here so that a per-step feed is not run over
    its batch dimension."""
    for n, v in feed.items():
        shp = tuple(np.shape(v))
        if not shp or shp[0] != iterations:
            raise ValueError(
                f"run(iterations={iterations}): feed {n!r} must stack "
                f"{iterations} per-step batches on a leading axis, got "
                f"shape {shp}")


def _is_persistable(block: Block, name: str) -> bool:
    v = block._var_recursive(name) if name else None
    return v is not None and v.persistable


def _is_host(op: OpDesc) -> bool:
    """Ops that run between device segments, outside any capture: host
    I/O, and a ``while`` with no static trip bound, whose condition is
    read on the host every trip (a graph would fix one trip count)."""
    if op.type == "while":
        return trip_bound(op.attrs) <= 0
    return registry.has_op(op.type) and registry.lookup(op.type).is_host


def _live_ops(ops: List[OpDesc], fetch_names, block: Block) -> List[OpDesc]:
    """Backward slice: ops that reach a fetch, write a persistable
    variable, or touch the host."""
    needed = set(fetch_names)
    kept = []
    for op in reversed(ops):
        if _is_host(op) or any(n in needed or _is_persistable(block, n)
                               for n in op.output_arg_names()):
            kept.append(op)
            needed.update(n for n in op.input_arg_names() if n)
    kept.reverse()
    return kept


def _split_segments(ops: List[OpDesc]) -> List[Tuple[str, List[OpDesc]]]:
    """Group ops into maximal device runs separated by host ops."""
    segments: List[Tuple[str, List[OpDesc]]] = []
    for op in ops:
        kind = "host" if _is_host(op) else "device"
        if not segments or segments[-1][0] != kind:
            segments.append((kind, []))
        segments[-1][1].append(op)
    return segments


def _fuse_fallback_reason(segments) -> Optional[str]:
    """Why a K-step run cannot be one plan step (None when it can): host
    ops split the block into segments run eagerly in between."""
    host = sorted({op.type for kind, ops in segments if kind == "host"
                   for op in ops})
    if host or len(segments) != 1:
        return f"host ops split the block: {host}"
    return None


def _feed_dtype(name: str, value, block: Block) -> torch.dtype:
    """The dtype a feed takes in the run: the program's declared one (int64
    ids stay int64; lengths keep their declared type), else its own."""
    if block.has_var(name) and block.vars[name].dtype is not None:
        return dtype_to_torch(block.vars[name].dtype)
    if isinstance(value, torch.Tensor):
        return value.dtype
    return torch.from_numpy(np.empty(0, np.asarray(value).dtype)).dtype


def _coerce_feed(value, name: str, block: Block, device: torch.device):
    """A feed as a tensor on ``device`` in the dtype the program declares."""
    value = _unwrap_fetch_handle(value)
    want = _feed_dtype(name, value, block)
    if not isinstance(value, torch.Tensor):
        return torch.tensor(np.asarray(value), dtype=want, device=device)
    return value.to(device=device, dtype=want)


# op types whose programs build (for byte-identical descs) but whose
# emitters wait for a ROADMAP item
_WAITING = {"recurrent": "A11 (StaticRNN and the sequence/RNN training "
                         "ops)",
            "while_grad": "A11 (backward through a while loop)"}


def _emitter(op_type: str):
    """The op's emitter; a ``<type>_grad`` without one of its own takes
    the generic vjp."""
    try:
        return registry.resolve_grad_emitter(op_type)
    except KeyError:
        waits = _WAITING.get(op_type)
        raise NotImplementedError(
            f"operator {op_type!r} has no emitter in paddle_tpu_torch yet"
            + (f": it waits for ROADMAP {waits}" if waits else "")) from None


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


def _storage(t) -> Optional[int]:
    return (t.untyped_storage().data_ptr() if isinstance(t, torch.Tensor)
            else None)


def _write_state(scope: Scope, names, env: Dict[str, Any],
                 capturing: bool = False):
    """Write each of ``names`` from ``env`` into the scope: copied into
    the scope's tensor when it has one of the same shape, dtype and
    device, else bound. A value that shares storage with a tensor being
    written is cloned first, so every copy reads the run's value. Under
    capture every name must already have its tensor (the warm-up bound
    it), since a bound graph-pool tensor would be overwritten by later
    replays."""
    names = [n for n in names if n in env]
    targets = {n: scope.find_var(n) for n in names}
    ptrs = {_storage(t) for t in targets.values() if t is not None}
    writes = []
    for n in names:
        val, dst = env[n], targets[n]
        if val is dst:
            continue
        if _storage(val) in ptrs:
            val = val.clone()
        writes.append((n, val, dst))
    for n, val, dst in writes:
        if (isinstance(dst, torch.Tensor) and isinstance(val, torch.Tensor)
                and dst.shape == val.shape and dst.dtype == val.dtype
                and dst.device == val.device):
            dst.copy_(val)
        elif capturing:
            raise RuntimeError(
                f"captured run: persistable {n!r} has no scope tensor of "
                f"its new shape and dtype {tuple(val.shape)} {val.dtype}")
        else:
            scope.set_var(n, val)


def _accum_steps(program, build_strategy) -> int:
    """The microbatches of a step: the BuildStrategy's
    ``gradient_accumulation_steps`` or the program's
    ``_gradient_accumulation_steps``, whichever is larger."""
    return max(1, int(getattr(build_strategy, "gradient_accumulation_steps",
                              1) or 1),
               int(getattr(program, "_gradient_accumulation_steps", 1) or 1))


def _fetch_names(fetch_list) -> List[str]:
    return [f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or [])]


# one capture stream, one graph memory pool and one lock per CUDA device
_capture_streams: Dict[int, Any] = {}
_graph_pools: Dict[int, Any] = {}
_device_locks: Dict[int, threading.RLock] = {}
_device_locks_guard = threading.Lock()


def _device_lock(device: torch.device):
    """The device's lock, held over a capture, over an eager warm-up (it
    runs on the capture stream) and over a replay from the copy of its
    inputs through the clones of its outputs: so no other thread's work
    lands in a capture, and no other graph of the shared pool replays
    between a replay and the copies of its outputs. It orders enqueueing
    only; nothing in it waits for the device but a capture's first
    replay. A CPU run needs none."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    idx = device.index or 0
    with _device_locks_guard:
        lock = _device_locks.get(idx)
        if lock is None:
            lock = _device_locks[idx] = threading.RLock()
    return lock


def _capture_stream(device: torch.device):
    """Called with the device's lock held."""
    idx = device.index or 0
    if idx not in _capture_streams:
        _capture_streams[idx] = torch.cuda.Stream(device)
    return _capture_streams[idx]


def _graph_pool(device: torch.device):
    """Called with the device's lock held."""
    idx = device.index or 0
    if idx not in _graph_pools:
        with torch.cuda.device(device):
            _graph_pools[idx] = torch.cuda.graph_pool_handle()
    return _graph_pools[idx]


class _Segment:
    """One device segment of a plan: its ops, the names it reads and
    writes, its constants and, on the card, its graph."""

    def __init__(self, ops: List[OpDesc], inputs: List[str],
                 state_in: List[str], state_out: List[str],
                 outputs: List[str], needs_rng: bool):
        self.ops = ops
        self.inputs = inputs        # read from the feed or earlier segments
        self.state_in = state_in    # read from the scope
        self.state_out = state_out  # persistables written, in op order
        self.outputs = outputs      # fetched or read by later segments
        self.needs_rng = needs_rng
        self.consts: Dict[int, torch.Tensor] = {}
        self.accum: Optional[_Accumulation] = None
        self.drop_graph()

    def drop_graph(self):
        self.graph = None
        self.static_in: Dict[str, torch.Tensor] = {}
        self.static_out: Dict[str, torch.Tensor] = {}
        self.state_refs: Dict[str, Any] = {}

    def state_rebound(self, scope: Scope) -> bool:
        """Does the scope hold another tensor under a name the graph
        reads or writes than the one it captured?"""
        for n, ref in self.state_refs.items():
            if scope.find_var(n) is not ref():
                return True
        return False


def _is_post_op(op: OpDesc) -> bool:
    """An op past the optimizer boundary: it runs once per accumulated
    step."""
    role = int(op.attrs.get(OP_ROLE_ATTR_NAME, 0) or 0)
    return bool(role & int(OpRole.OPTIMIZE) or role & int(OpRole.LRSCHED))


class _Accumulation:
    """How one device segment accumulates over ``steps`` microbatches:
    its forward+backward ops and the ops after the optimizer boundary,
    the inputs split on their batch axis, the gradients summed, the
    values carried from one microbatch to the next and the fetches the
    forward makes."""

    def __init__(self, steps: int, ops: List[OpDesc], inputs, block: Block,
                 state_out, outputs, fetch_names):
        self.steps = steps
        self.post_ops = [op for op in ops if _is_post_op(op)]
        self.fb_ops = [op for op in ops if not _is_post_op(op)]
        fb_written = {n for op in self.fb_ops
                      for n in op.output_arg_names() if n}
        # a feed whose declared leading dim is static is a loop constant
        self.split = []
        for n in inputs:
            d = block.vars[n].desc if block.has_var(n) else None
            if d is None or not d.shape or d.shape[0] is None \
                    or d.shape[0] < 0:
                self.split.append(n)
        self.grads = sorted({g for op in ops for g in
                             (op.attrs.get(OP_ROLE_VAR_ATTR_NAME)
                              or [])[1::2] if g in fb_written})
        post_reads = {n for op in self.post_ops
                      for n in op.input_arg_names() if n}
        self.fetches = [n for n in fetch_names if n in fb_written]
        self.carry = sorted(
            n for n in fb_written
            if (n in state_out or n in post_reads
                or (n in outputs and n not in self.fetches))
            and n not in self.grads)

    def run(self, step: Dict[str, Any], ctx: EmitContext) -> Dict[str, Any]:
        """One accumulated step on the inputs in ``step`` (the optimizer's
        results bound into it); returns the forward's fetches, each the
        mean over the microbatches (the last one for an integer)."""
        m = self.steps
        micro = {}
        for n in self.split:
            v = step[n]
            if v.dim() == 0:
                continue
            if v.shape[0] % m:
                raise ValueError(
                    f"gradient accumulation: feed {n!r} batch dim "
                    f"{tuple(v.shape)} not divisible by accum={m}")
            micro[n] = v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
        const = {n: v for n, v in step.items() if n not in micro}
        sums: Dict[str, Any] = {}
        carry: Dict[str, Any] = {}
        fetched: Dict[str, List[Any]] = {n: [] for n in self.fetches}
        for i in range(m):
            env = dict(const)
            env.update(carry)
            env.update((n, v[i]) for n, v in micro.items())
            run_ops(self.fb_ops, env, ctx)
            for n in self.grads:
                sums[n] = env[n] if i == 0 else sums[n] + env[n]
            carry = {n: env[n] for n in self.carry if n in env}
            for n in self.fetches:
                fetched[n].append(env[n])
            del env  # its temporaries go before the next microbatch's
        step.update(carry)
        for n in self.grads:
            step[n] = sums[n] / m
        means = {}
        for n, vals in fetched.items():
            means[n] = (torch.stack(vals).mean(dim=0)
                        if vals[0].is_floating_point() else vals[-1])
            if n not in self.carry:
                step[n] = means[n]
        run_ops(self.post_ops, step, ctx)
        return means


class _Plan:
    """A run's segments ("host", ops) and ("device", _Segment), and the
    count of its runs (the first is the warm-up; the second captures)."""

    def __init__(self, segments, scope: Scope):
        self.segments = segments
        self.scope_ref = weakref.ref(scope)
        self.runs = 0

    def drop_graphs(self):
        for kind, seg in self.segments:
            if kind == "device":
                seg.drop_graph()
        self.runs = 0


def _make_plan(ops: List[OpDesc], feed_names, fetch_names, block: Block,
               scope: Scope, accum: int = 1) -> _Plan:
    """Split ``ops`` at host ops and analyse each device segment: the
    names it reads before writing, from the run (feeds, earlier
    segments) or from the scope, the persistables it writes and the
    values later segments or the fetches take from it; with ``accum``
    > 1, how a segment holding optimizer ops accumulates."""
    split = _split_segments(ops)
    available = set(feed_names)
    segments = []
    for i, (kind, seg_ops) in enumerate(split):
        written: List[str] = []
        if kind == "host":
            segments.append(("host", seg_ops))
            for op in seg_ops:
                written.extend(n for n in op.output_arg_names() if n)
            available.update(written)
            continue
        later_reads = {n for _, later in split[i + 1:] for op in later
                       for n in op.input_arg_names()}
        # dicts keep first-seen order
        first_reads: Dict[str, None] = {}
        seg_written: Dict[str, None] = {}
        needs_rng = False
        for op in seg_ops:
            info = registry.lookup(op.type) if registry.has_op(op.type) \
                else None
            needs_rng = needs_rng or bool(info and info.needs_rng)
            for n in op.input_arg_names():
                if n and n not in seg_written:
                    first_reads.setdefault(n)
            for n in op.output_arg_names():
                if n:
                    seg_written.setdefault(n)
        written = list(seg_written)
        inputs = [n for n in first_reads if n in available]
        state_in = [n for n in first_reads if n not in available]
        state_out = [n for n in written if _is_persistable(block, n)]
        outputs = [n for n in written
                   if n in later_reads or n in fetch_names]
        seg = _Segment(seg_ops, inputs, state_in, state_out, outputs,
                       needs_rng)
        if accum > 1 and any(_is_post_op(op) for op in seg_ops) \
                and not all(_is_post_op(op) for op in seg_ops):
            seg.accum = _Accumulation(accum, seg_ops, inputs, block,
                                      state_out, outputs, fetch_names)
        segments.append(("device", seg))
        available.update(written)
    return _Plan(segments, scope)


class Executor:
    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device
        self._seen_programs = weakref.WeakSet()
        # the BuildStrategy pipeline on this executor: runs (memo
        # misses), runs a memoized list served (pass memo or cached
        # plan), and per stage its ops removed and seconds
        self.pipeline_stats = {"runs": 0, "memo_hits": 0, "seconds": 0.0,
                               "stages": {}}
        # graphs captured by this executor, their seconds from the start
        # of the capture to the end of the first replay (host clock,
        # synchronized), and replays
        self.capture_stats = {"captures": 0, "seconds": 0.0, "replays": 0}
        # run(iterations=K) calls that took K single-step runs
        self.fuse_fallbacks = 0
        # plan lookup and creation, the pipeline memo, the statistics and
        # each plan's run count, for callers on several threads (a
        # predictor and its clones share one executor)
        self._lock = threading.RLock()

    def lowered_ops(self, program=None, fetch_list=None) -> List[OpDesc]:
        """The op list ``run`` executes for ``program`` and
        ``fetch_list``: the live ops of block 0, rewritten by the pass
        pipeline when ``program`` is a CompiledProgram."""
        program, build_strategy = self._unwrap(program)
        with self._lock:
            return self._prepare(program, build_strategy,
                                 _fetch_names(fetch_list),
                                 _accum_steps(program, build_strategy))

    @staticmethod
    def _unwrap(program):
        """(Program, BuildStrategy or None) of a run's target."""
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
        return program, build_strategy

    def _flags(self, build_strategy, accum=1):
        """The pass groups a run takes: none under gradient accumulation
        (the JAX package's rule), whose split at the optimizer boundary
        the rewrites would have to respect."""
        if accum > 1:
            return ()
        return pipeline.effective_flags(pipeline.fingerprint(build_strategy),
                                        self.device.type)

    def _prepare(self, program, build_strategy, fetch_names, accum=1):
        """The op list of a run: block 0's live ops, rewritten by the
        pipeline (memoized) when the BuildStrategy selects passes."""
        block = program.global_block()
        ops = _live_ops([op for op in block.desc.ops
                         if op.type not in ("feed", "fetch")],
                        fetch_names, block)
        flags = self._flags(build_strategy, accum)
        if not flags:
            return ops
        memo = program.__dict__.setdefault("_pass_memo", {})
        key = (program._version, tuple(fetch_names), flags)
        optimized = memo.get(key)
        if optimized is not None:
            self.pipeline_stats["memo_hits"] += 1
            return optimized
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
        return optimized

    def _plan(self, program, build_strategy, feed, fetch_names, scope,
              iterations):
        """The cached plan of this run's key (made on a miss), or a plan
        for this run alone when ``FLAGS.jit_cache`` is off."""
        block = program.global_block()
        accum = _accum_steps(program, build_strategy)
        flags = self._flags(build_strategy, accum)
        signature = tuple(sorted(
            (n, tuple(np.shape(_unwrap_fetch_handle(v))),
             str(_feed_dtype(n, _unwrap_fetch_handle(v), block)))
            for n, v in feed.items()))
        key = (program._version, tuple(fetch_names), flags, signature,
               iterations, accum, program._amp, str(self.device),
               scope._token)
        cache = program.__dict__.setdefault("_exec_cache", {})
        plan = cache.get(key) if FLAGS.jit_cache else None
        if plan is not None:
            if flags:
                self.pipeline_stats["memo_hits"] += 1
            return plan
        ops = self._prepare(program, build_strategy, fetch_names, accum)
        plan = _make_plan(ops, list(feed), fetch_names, block, scope, accum)
        if FLAGS.jit_cache:
            # plans of scopes that are gone cannot run again: drop them
            for k in [k for k, p in cache.items() if p.scope_ref() is None]:
                del cache[k]
            cache[key] = plan
            self._seen_programs.add(program)
        return plan

    def run(self, program=None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            use_program_cache: bool = True,
            iterations: Optional[int] = None):
        """Run block 0 of ``program`` (a Program or a CompiledProgram).
        Fetches come back as numpy arrays, or as ``FetchHandle``s with
        ``return_numpy=False``. ``iterations=K`` (or a CompiledProgram's
        ``ExecutionStrategy.num_iteration_per_run``) runs K steps on
        [K, batch, ...] feeds and stacks the fetches [K, ...].
        ``use_program_cache`` is the reference's argument and is ignored:
        ``FLAGS.jit_cache`` decides whether plans are kept. Safe to call
        from several threads at once, on one plan too: each caller gets
        the results of its own feed."""
        _faults.fire("executor.run")
        scope = scope or global_scope()
        target = program or default_main_program()
        if iterations is None and isinstance(target, CompiledProgram):
            iterations = target._exec_strategy.num_iteration_per_run
        iterations = max(1, int(iterations or 1))
        feed = dict(feed or {})
        fetch_names = _fetch_names(fetch_list)
        program, build_strategy = self._unwrap(target)
        if iterations > 1:
            _validate_super_batch(feed, iterations)
        with self._lock:
            plan = self._plan(program, build_strategy, feed, fetch_names,
                              scope, iterations)
            captured = (self.device.type == "cuda" and FLAGS.jit_cache
                        and plan.runs > 0)
            if captured:
                with _device_lock(self.device):
                    if any(kind == "device" and seg.graph is not None
                           and seg.state_rebound(scope)
                           for kind, seg in plan.segments):
                        plan.drop_graphs()
                        captured = False
        if iterations > 1:
            reason = _fuse_fallback_reason(plan.segments)
            if reason is not None:
                self.fuse_fallbacks += 1
                warnings.warn(
                    f"run(iterations={iterations}): cannot fuse steps "
                    f"into one plan ({reason}); falling back to "
                    f"{iterations} sequential single-step runs",
                    stacklevel=2)
                return self._run_steps_sequential(
                    target, feed, fetch_list, scope, return_numpy,
                    iterations)
        block = program.global_block()
        generator = None
        if any(kind == "device" and seg.needs_rng
               for kind, seg in plan.segments):
            generator = scope.generator(self.device,
                                        program.random_seed or FLAGS.seed)
        env = {n: _coerce_feed(v, n, block, self.device)
               for n, v in feed.items()}
        results: Dict[str, Any] = {}
        # grad ops differentiate with torch.func.vjp, which records its
        # forward under no_grad too
        with torch.no_grad():
            for kind, seg in plan.segments:
                if kind == "host":
                    run_ops(seg, env, EmitContext(
                        self.device, amp=program._amp, scope=scope,
                        program=program))
                    written = [n for op in seg
                               for n in op.output_arg_names() if n]
                    _write_state(scope, [n for n in written
                                         if _is_persistable(block, n)], env)
                    # a host op (an unbounded while) may rebind a name an
                    # earlier segment computed: the fetch is the new value
                    results.update((n, env[n].clone()) for n in written
                                   if n in fetch_names)
                    continue
                ctx = EmitContext(self.device, generator=generator,
                                  amp=program._amp, scope=scope,
                                  consts=seg.consts, program=program)
                if not captured:
                    outs = self._run_eager(seg, env, scope, ctx, iterations,
                                           warm_up=self.device.type == "cuda"
                                           and FLAGS.jit_cache)
                else:
                    outs = self._run_captured(seg, env, scope, ctx,
                                              iterations)
                env.update(outs)
                results.update((n, outs[n]) for n in fetch_names
                               if n in outs)
        with self._lock:
            plan.runs += 1
        out = []
        for n in fetch_names:
            if n in results:
                val = results[n]
            elif n in env:
                # a fed value or a host op's output
                val = env[n].clone()
            else:
                val = scope.find_var(n)
                if val is None:
                    raise KeyError(f"fetch {n!r} was not computed by this "
                                   "run")
                val = val.clone()  # the scope's tensor changes in place
            out.append(_to_numpy(val) if return_numpy else FetchHandle(val))
        return out

    def _steps(self, seg: _Segment, env: Dict[str, Any], scope: Scope,
               ctx: EmitContext, iterations: int, capturing: bool = False):
        """The segment's ``iterations`` steps on the inputs in ``env``
        (step k reads slice k of each input when K > 1), each ending
        with its state written into the scope. Returns the outputs,
        stacked [K, ...] when K > 1; an output sharing storage with the
        scope's state is cloned, before the state is written (which may
        change that tensor in place) and after (which may bind it)."""
        state = seg.state_in + seg.state_out

        def detach(outs):
            ptrs = {_storage(scope.find_var(n)) for n in state}
            return {n: v.clone() if _storage(v) in ptrs else v
                    for n, v in outs.items()}

        per_step = []
        for k in range(iterations):
            step = {n: (env[n][k] if iterations > 1 else env[n])
                    for n in seg.inputs}
            fetched = {}
            if seg.accum is not None:
                fetched = seg.accum.run(step, ctx)
            else:
                run_ops(seg.ops, step, ctx)
            missing = [n for n in seg.outputs if n not in step]
            if missing:
                raise KeyError(f"{missing} not computed by this run")
            outs = detach({n: fetched.get(n, step[n]) for n in seg.outputs})
            _write_state(scope, seg.state_out, step, capturing)
            per_step.append(detach(outs))
        if iterations == 1:
            return per_step[0]
        return {n: torch.stack([s[n] for s in per_step])
                for n in seg.outputs}

    def _run_eager(self, seg, env, scope, ctx, iterations, warm_up):
        """An eager run; a plan's warm-up on the card runs on the capture
        stream, whose cuBLAS workspace the capture then finds made."""
        if not warm_up:
            return self._steps(seg, env, scope, ctx, iterations)
        with _device_lock(self.device):
            side = _capture_stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                outs = self._steps(seg, env, scope, ctx, iterations)
            torch.cuda.current_stream(self.device).wait_stream(side)
        return outs

    def _run_captured(self, seg, env, scope, ctx, iterations):
        """A run of a warm plan's segment: its capture if no thread has
        made the graph yet, else a replay; the choice is made under the
        device's lock, so two threads never capture one segment."""
        with _device_lock(self.device):
            if seg.graph is None:
                return self._capture(seg, env, scope, ctx, iterations)
            return self._replay(seg, env)

    def _capture(self, seg, env, scope, ctx, iterations):
        """Capture the segment's steps into a CUDA graph over static
        input buffers and the scope's state tensors, then replay it once.
        Called with the device's lock held; the capture's error mode is
        the thread's own, so other threads may allocate meanwhile."""
        dev = self.device
        t0 = time.perf_counter()
        seg.static_in = {n: env[n].clone() for n in seg.inputs}
        for n in seg.state_in + seg.state_out:
            if scope.find_var(n) is None:
                raise KeyError(f"captured run: {n!r} is not in the scope")
        seg.state_refs = {n: weakref.ref(scope.find_var(n))
                          for n in seg.state_in + seg.state_out}
        graph = torch.cuda.CUDAGraph()
        if seg.needs_rng:
            graph.register_generator_state(ctx.generator)
        # torch.cuda.graph synchronizes and empties the allocator's cache
        # first, so the graph's pool can take the warm-up's blocks
        with torch.cuda.graph(graph, pool=_graph_pool(dev),
                              stream=_capture_stream(dev),
                              capture_error_mode="thread_local"):
            seg.static_out = self._steps(seg, dict(seg.static_in), scope,
                                         ctx, iterations, capturing=True)
        seg.graph = graph
        outs = self._replay(seg, None)
        torch.cuda.synchronize(dev)
        self.capture_stats["captures"] += 1
        self.capture_stats["seconds"] += time.perf_counter() - t0
        return outs

    def _replay(self, seg, env):
        """Replay the segment's graph on this run's inputs (``env``; None
        when the static buffers hold them already). The outputs are
        copied out of the graph's pool, which other graphs reuse. Called
        with the device's lock held, from the copy of the inputs through
        the copies of the outputs."""
        if env is not None:
            for n, buf in seg.static_in.items():
                buf.copy_(env[n])
        seg.graph.replay()
        self.capture_stats["replays"] += 1
        return {n: t.clone() for n, t in seg.static_out.items()}

    def _run_steps_sequential(self, program, feed, fetch_list, scope,
                              return_numpy, iterations):
        """``run(iterations=K)`` as K single-step runs on slice k of each
        [K, ...] feed, the fetches stacked: the K-step contract without
        the fused plan."""
        per_step = [self.run(program,
                             feed={n: _unwrap_fetch_handle(v)[k]
                                   for n, v in feed.items()},
                             fetch_list=fetch_list, scope=scope,
                             return_numpy=False, iterations=1)
                    for k in range(iterations)]
        out = []
        for i in range(len(per_step[0]) if per_step else 0):
            val = torch.stack([s[i].device_value() for s in per_step])
            out.append(_to_numpy(val) if return_numpy else FetchHandle(val))
        return out

    def close(self):
        """Drop the plans, and with them the graphs, of every program
        this executor ran."""
        for prog in list(self._seen_programs):
            prog.__dict__.pop("_exec_cache", None)
