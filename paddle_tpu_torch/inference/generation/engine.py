"""Decode-mode engine: bucketed prefill and a captured decode loop over a
resident KV cache (counterpart of
``paddle_tpu/inference/generation/engine.py``).

- **Prefill** runs the prompt through the executor's plan of its prompt
  bucket (captured on the card from its second run); the logits and the
  per-layer K/V fetches stay on the device (``FetchHandle.device_value``)
  and are written into the slot's rows of the resident cache.

- **Decode** is one CUDA graph per (slot table, steps, top-k window):
  ``steps`` unrolled iterations of sample -> decode-step program -> carry
  update, captured once and replayed for every chunk of that key, so no
  host round trip falls between steps. Where the JAX package donates its
  carry through an AOT-compiled ``lax.scan``, the graph reads and writes
  the carry's tensors in place; the only device-to-host traffic of a
  chunk is its token and done-flag matrices (``stats["host_fetch_bytes"]``).

- **Slot tables** (:class:`SlotState`, :class:`PagedSlotState`) are the
  carry: KV caches (dense [slots, heads, cap, d_head], or page pools and a
  page table), next-token logits, positions, per-slot random streams, done
  flags and sampling knobs. A graph binds the tensors it captured, so each
  key of ``alloc_state`` has engine-owned carries: a state that is dropped
  (or passed to ``free_state``) hands its carry back, and the next
  ``alloc_state`` of the key zeroes it in place and reuses it with the
  graphs captured on it. Two live states never share a carry. Before each
  replay the graph's tensors are checked by identity; a parameter that
  ``Scope.set_var`` rebound drops the graph, which is captured anew.

- **Ingest** (a prompt seated in a slot) is a handful of slice copies and
  fills on the carry, run eagerly under the device lock: a graph would
  need the prefill's K/V copied into its static buffers first, the same
  copies the eager writes make. ``stats["ingest_builds"]`` counts the
  ingest keys first seen, the unit in which the JAX engine compiles.

On the CPU every chunk runs eagerly (there is no graph). ``FLAGS.jit_cache
= False`` runs the chunks eagerly on the card too: the oracle the captured
chunks are held against. A capture that fails raises; nothing falls back.

The engine keeps plain counts in ``stats`` (as the executor keeps
``capture_stats``) and, with the monitor on, mirrors them into the JAX
engine's ``generation_*`` counters, with ``generation_decode_seconds``
and the ``generation_step_seconds`` histogram per decode chunk.

``naive_generate`` is the baseline: re-prefill the whole sequence for
every token.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import monitor as _monitor
from ...executor import (Executor, Scope, _capture_stream, _device_lock,
                         _graph_pool, _split_segments, run_ops)
from ...ops.kernels_cache import (dense_write_, paged_gather_fn,
                                  paged_write_)
from ...place import CUDAPlace
from ...registry import EmitContext
from ...utils.flags import FLAGS
from ..serving import BucketLadder
from .paging import (PageAllocator, PagesExhausted, RadixPrefixCache,
                     pages_for)
from .sampling import SamplingParams, make_rng_row, sample_step, vocab_hash
from .spec import GenerationSpec

__all__ = ["DecodeEngine", "SlotState", "PagedSlotState", "naive_generate",
           "collect_tokens"]

# int32 positions, topks and limits as the decode program declares its
# position feed; the (key, counter) rows are int64 (sampling.py)
_CARRY_BYTES_PER_SLOT = 4 + 4 + 16 + 1 + 4 + 4 + 4  # + vocab * 4 logits

# engine stats mirrored into the JAX engine's monitor counters
_MONITOR_COUNTERS = {
    "decode_builds": "generation_decode_compiles_total",
    "ingest_builds": "generation_ingest_compiles_total",
    "prefill_tokens": "generation_prefill_tokens_total",
    "slot_joins": "generation_slot_joins_total",
    "prefix_hits": "generation_prefix_hit_total",
    "prefix_misses": "generation_prefix_miss_total",
    "page_evictions": "generation_page_evict_total",
    "decode_steps": "generation_decode_steps_total",
    "host_fetch_bytes": "generation_host_fetch_bytes_total",
}


class _TracedStep:
    """The decode-step Program as a function of its feeds: its ops run in
    order on the engine's scope (``run_ops``), with no plan and no scope
    writes, so a decode chunk can unroll it ``steps`` times inside one
    graph."""

    def __init__(self, program, io: Dict[str, Any]):
        self.program = program
        self.io = io
        ops = [op for op in program.global_block().desc.ops
               if op.type not in ("feed", "fetch")]
        segments = _split_segments(ops)
        if len(segments) != 1 or segments[0][0] != "device":
            host = sorted({op.type for kind, seg in segments
                           if kind == "host" for op in seg})
            raise ValueError(
                f"decode-step program must be one device segment; host ops "
                f"{host} cannot run inside the decode loop")
        self.ops = segments[0][1]
        feed_set = {io["token"], io["pos"], *io["cache_k"], *io["cache_v"]}
        written: set = set()
        rbw: List[str] = []
        for op in self.ops:
            for n in op.input_arg_names():
                if n and n not in written and n not in rbw:
                    rbw.append(n)
            written.update(n for n in op.output_arg_names() if n)
        self.param_names = [n for n in rbw if n not in feed_set]
        self.fetch_names = ([io["logits"]] + list(io["new_k"])
                            + list(io["new_v"]))

    def __call__(self, feed_env: Dict[str, Any], ctx: EmitContext):
        env = dict(feed_env)
        run_ops(self.ops, env, ctx)
        return [env[n] for n in self.fetch_names]


class _Carry:
    """The tensors of one slot table (in ``SlotState.pack`` order) and the
    decode graphs captured on them, by (steps, top-k window)."""

    __slots__ = ("key", "tensors", "graphs")

    def __init__(self, key, tensors):
        self.key = key
        self.tensors = tensors
        self.graphs: Dict[Tuple, "_Graph"] = {}


class _Graph:
    """A captured decode chunk: the graph, its outputs (tokens and done
    flags, in the shared graph pool) and what it bound: the carry's
    tensors and, by weak reference, the scope's parameters."""

    __slots__ = ("graph", "outs", "state_refs", "param_refs")

    def __init__(self, graph, outs, state_tensors, params):
        self.graph = graph
        self.outs = outs
        self.state_refs = list(state_tensors)
        self.param_refs = [(n, weakref.ref(t)) for n, t in params]

    def rebound(self, state, scope) -> bool:
        """Does the state or the scope hold another tensor than the one
        the graph captured?"""
        return (any(a is not b for a, b in zip(state.pack(),
                                               self.state_refs))
                or any(scope.find_var(n) is not r()
                       for n, r in self.param_refs))


class SlotState:
    """Continuous-batching state on the engine's device: slot-major KV
    caches plus the per-slot decode carry, updated in place by ingest and
    decode and never read to the host."""

    __slots__ = ("slots", "cap", "cache_k", "cache_v", "logits",
                 "positions", "rngs", "done", "temps", "topks", "limits",
                 "_carry", "_finalizer", "__weakref__")

    def __init__(self, slots: int, cap: int, cache_k, cache_v, logits,
                 positions, rngs, done, temps, topks, limits):
        self.slots = slots
        self.cap = cap
        self.cache_k = list(cache_k)
        self.cache_v = list(cache_v)
        self.logits = logits
        self.positions = positions
        self.rngs = rngs
        self.done = done
        self.temps = temps
        self.topks = topks
        self.limits = limits
        self._carry = None
        self._finalizer = None

    def pack(self) -> Tuple:
        return (*self.cache_k, *self.cache_v, self.logits, self.positions,
                self.rngs, self.done, self.temps, self.topks, self.limits)

    def cache_bytes(self) -> int:
        return sum(a.element_size() * a.numel()
                   for a in (*self.cache_k, *self.cache_v))

    def is_consumed(self) -> bool:
        """True once ``free_state`` handed the carry back. (The JAX
        package's state is consumed by a donated call that died; nothing
        is donated here.)"""
        return self._carry is None and self._finalizer is not None

    def _scratch(self) -> "SlotState":
        """A copy of the carry, for a warm-up that must not advance it."""
        st = SlotState.__new__(type(self))
        for name in type(self)._fields():
            val = getattr(self, name)
            if isinstance(val, list):
                val = [t.clone() for t in val]
            elif isinstance(val, torch.Tensor):
                val = val.clone()
            setattr(st, name, val)
        st._carry = st._finalizer = None
        return st

    @classmethod
    def _fields(cls):
        return ("slots", "cap", "cache_k", "cache_v", "logits", "positions",
                "rngs", "done", "temps", "topks", "limits")


class PagedSlotState(SlotState):
    """Paged slot table: ``cache_k``/``cache_v`` hold the per-layer page
    pools [num_pages + 1, H, page, D] (row 0 is the null page) and
    ``table`` [slots, max_pages] int32 maps each slot's positions to pool
    rows. The host-side :class:`~.paging.PageAllocator` (and the
    :class:`~.paging.RadixPrefixCache` when prefix reuse is on) decide the
    table; the device only sees the indices."""

    __slots__ = ("table", "num_pages", "page_size", "alloc", "prefix")

    def __init__(self, slots, cap, num_pages, page_size, pool_k, pool_v,
                 table, logits, positions, rngs, done, temps, topks, limits,
                 alloc: PageAllocator, prefix: Optional[RadixPrefixCache]):
        SlotState.__init__(self, slots, cap, pool_k, pool_v, logits,
                           positions, rngs, done, temps, topks, limits)
        self.table = table
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.alloc = alloc
        self.prefix = prefix

    @property
    def max_pages(self) -> int:
        return int(self.table.shape[1])

    def pack(self) -> Tuple:
        return (*self.cache_k, *self.cache_v, self.table, self.logits,
                self.positions, self.rngs, self.done, self.temps,
                self.topks, self.limits)

    def cache_bytes(self) -> int:
        return (SlotState.cache_bytes(self)
                + self.table.element_size() * self.table.numel())

    def page_nbytes(self) -> int:
        """Device bytes one page holds across every layer's K and V pool."""
        k = self.cache_k[0]
        return 2 * len(self.cache_k) * k[0].numel() * k.element_size()

    @classmethod
    def _fields(cls):
        return SlotState._fields() + ("table", "num_pages", "page_size",
                                      "alloc", "prefix")


class _DecodePlan:
    """What a decode key shares across the carries it runs on: the traced
    step, the constants its ops make once (``EmitContext.constant``) and
    the vocabulary half of the sampling hash, both made outside any
    graph."""

    __slots__ = ("step", "consts", "vh")

    def __init__(self, step: _TracedStep, vh):
        self.step = step
        self.consts: Dict[int, torch.Tensor] = {}
        self.vh = vh


class DecodeEngine:
    """Model-level generation engine over a :class:`GenerationSpec`.

    ``generate()`` is the one-shot API (prefill, then one decode chunk of
    the bucketed step count, bucketed on slots x prompt bucket x new-token
    bucket); ``alloc_state``/``admit``/``decode_chunk``/``release_slot``
    are the slot-granular primitives of continuous batching. Runs on
    ``CUDAPlace(0)`` unless given another place (``CPUPlace()`` for the
    host); without a card the default raises. After every key has run
    once (and, on the card, been captured), traffic over mixed prompt
    lengths builds and captures nothing."""

    def __init__(self, spec: GenerationSpec, place=None,
                 scope: Optional[Scope] = None,
                 prompt_buckets: Sequence[int] = (8, 16, 32),
                 new_token_buckets: Sequence[int] = (8, 16, 32),
                 slot_buckets: Sequence[int] = (1, 2, 4, 8),
                 top_k_max: int = 64):
        self.spec = spec
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device
        self.scope = scope or Scope()
        self._exe = Executor(self.place)
        self.prompt_ladder = BucketLadder(prompt_buckets)
        self.new_ladder = BucketLadder(new_token_buckets)
        self.slot_ladder = BucketLadder(slot_buckets)
        # the static top-k window of the sampling head; 0 is the
        # greedy-only head (argmax, the streams untouched)
        self.top_k_max = int(top_k_max)
        # read once, so a flag changed later cannot mix paged and dense
        # work on one slot table
        self.paged = bool(FLAGS.generation_paged)
        self.page_size = max(1, int(FLAGS.generation_page_size))
        self._prefix_flag = bool(FLAGS.generation_prefix_cache)
        self._initialized = False
        self._prefill_progs: Dict[int, Tuple[Any, Dict]] = {}
        self._prefix_progs: Dict[Tuple[int, int], Tuple[Any, Dict]] = {}
        self._decode_progs: Dict[int, Tuple[Any, Dict]] = {}
        self._steps: Dict[int, _TracedStep] = {}
        self._decode_plans: Dict[Tuple, _DecodePlan] = {}
        self._ingest_keys: set = set()
        self._free_carries: Dict[Tuple, List[_Carry]] = {}
        self._vh = None
        self.stats = {
            "decode_builds": 0, "decode_captures": 0, "decode_replays": 0,
            "capture_seconds": 0.0, "decode_steps": 0, "ingest_builds": 0,
            "carries": 0, "host_fetch_bytes": 0, "prefill_tokens": 0,
            "slot_joins": 0, "prefix_hits": 0, "prefix_misses": 0,
            "prefill_tokens_saved": 0, "page_evictions": 0}
        # build-once memo guard (programs, plans, carries, stats): a
        # dispatcher thread and a caller's warm-up may ask for the same
        # key at once. Never held while waiting for the device lock.
        self._memo_lock = threading.RLock()

    def _count(self, name, n=1):
        with self._memo_lock:
            self.stats[name] += n
        if _monitor._enabled and name in _MONITOR_COUNTERS:
            _monitor.counter(_MONITOR_COUNTERS[name]).inc(n)

    # -- setup ------------------------------------------------------------
    def initialize(self):
        """Run the spec's startup once into the engine scope."""
        with self._memo_lock:
            if not self._initialized:
                self._exe.run(self.spec.startup, scope=self.scope)
                self._initialized = True
        return self

    def _memo(self, table, key, build):
        with self._memo_lock:
            ent = table.get(key)
            if ent is None:
                ent = table[key] = build()
            return ent

    def _prefill_prog(self, tp: int):
        return self._memo(self._prefill_progs, tp,
                          lambda: self.spec.build_prefill(tp))

    def _decode_prog(self, cap: int):
        return self._memo(self._decode_progs, cap,
                          lambda: self.spec.build_decode(cap))

    def _prefix_prog(self, ts: int, pc: int):
        return self._memo(self._prefix_progs, (ts, pc),
                          lambda: self.spec.build_prefill_prefix(ts, pc))

    def _traced_step(self, cap: int) -> _TracedStep:
        return self._memo(self._steps, cap,
                          lambda: _TracedStep(*self._decode_prog(cap)))

    # -- prefix cache plumbing -------------------------------------------
    def prefix_enabled(self) -> bool:
        """Radix prefix reuse is live iff paged mode is on, the flag asks
        for it, the spec builds the prefix-prefill program and at least
        one full page fits under the top prompt bucket."""
        return (self.paged and self._prefix_flag
                and self.spec.build_prefill_prefix is not None
                and self.prefix_cap() > 0)

    def prefix_cap(self) -> int:
        """Padded prefix length of the one prefix-prefill program per
        suffix bucket: (top prompt bucket - 1) rounded down to pages, so
        at least one prompt token always runs through prefill."""
        return ((self.prompt_ladder.top - 1) // self.page_size) \
            * self.page_size

    def validate_sampling(self, sampling: SamplingParams):
        """A request's knobs must fit the sampling head: clamping would
        hand the caller tokens from another distribution."""
        if sampling.temperature > 0 and self.top_k_max <= 0:
            raise ValueError(
                f"temperature={sampling.temperature} sampling requested but "
                "the engine was built greedy-only (top_k_max=0); construct "
                "DecodeEngine(top_k_max>0) to sample")
        if int(sampling.top_k) > self.top_k_max > 0:
            raise ValueError(
                f"top_k={sampling.top_k} exceeds the engine's top-k window "
                f"top_k_max={self.top_k_max}; raise top_k_max (new decode "
                "graphs)")

    def _params(self, step: _TracedStep) -> List[Tuple[str, torch.Tensor]]:
        vals = []
        for n in step.param_names:
            v = self.scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"decode-step parameter {n!r} is not in the engine "
                    "scope; run initialize() (spec.startup) first")
            vals.append((n, v))
        return vals

    # -- state ------------------------------------------------------------
    def max_pages_for(self, cap: int) -> int:
        """Page-table width of a ``cap``-position slot row."""
        return pages_for(cap, self.page_size)

    def default_num_pages(self, slots: int, cap: int) -> int:
        """Capacity-equivalent pool: every slot can fill its whole cap."""
        return slots * self.max_pages_for(cap)

    def state_nbytes(self, slots: int, cap: int,
                     num_pages: Optional[int] = None) -> int:
        """Device bytes of a ``(slots, cap)`` slot table as ``alloc_state``
        makes it, without allocating: the KV caches (dense), or the page
        pools with their null page and the page table (paged), plus the
        carry."""
        spec = self.spec
        item = torch.empty((), dtype=_cache_dtype(spec)).element_size()
        carry = slots * (spec.vocab * 4 + _CARRY_BYTES_PER_SLOT)
        if self.paged:
            mp = self.max_pages_for(cap)
            n_pages = self.default_num_pages(slots, cap) \
                if num_pages is None else int(num_pages)
            pool = (2 * spec.n_layer * (n_pages + 1) * spec.n_head
                    * self.page_size * spec.d_head * item)
            return pool + slots * mp * 4 + carry
        return (2 * spec.n_layer * slots * spec.n_head * cap * spec.d_head
                * item) + carry

    def page_nbytes(self) -> int:
        """Device bytes one page costs across every layer's K and V pool."""
        spec = self.spec
        item = torch.empty((), dtype=_cache_dtype(spec)).element_size()
        return 2 * spec.n_layer * spec.n_head * self.page_size \
            * spec.d_head * item

    def max_fitting_config(self, slots: int,
                           budget: Optional[int] = None
                           ) -> Optional[Tuple[int, int]]:
        """Capacity helper: the largest ``(slots, cap)`` the budget fits,
        walking slots down the slot ladder and cap down the prompt ladder
        (cap = prompt bucket + top new-token bucket), sized by
        :meth:`state_nbytes`. ``budget=None`` reads the configured flags
        (profiling/memory.py); returns None when not even (1, smallest
        cap) fits, or when no budget is set."""
        from ...profiling import memory as _mem

        if budget is None:
            budget, _src = _mem.budget_bytes(self.device)
        if budget <= 0:
            return None
        caps = sorted({tp + self.new_ladder.top
                       for tp in self.prompt_ladder.buckets},
                      reverse=True)
        for s in sorted({min(slots, b) for b in
                         (*self.slot_ladder.buckets, slots)},
                        reverse=True):
            got, _b = _mem.fitting_config(
                caps, lambda c, s=s: self.state_nbytes(s, c), budget)
            if got is not None:
                return s, got
        return None

    def _new_carry(self, key) -> _Carry:
        spec, dev = self.spec, self.device
        dt = _cache_dtype(spec)
        slots = key[1]
        if key[0] == "paged":
            n_pages, mp = key[3], self.max_pages_for(key[2])
            shape = (n_pages + 1, spec.n_head, self.page_size, spec.d_head)
            extra = [torch.zeros((slots, mp), dtype=torch.int32, device=dev)]
        else:
            shape = (slots, spec.n_head, key[2], spec.d_head)
            extra = []
        caches = [torch.zeros(shape, dtype=dt, device=dev)
                  for _ in range(2 * spec.n_layer)]
        tensors = caches + extra + [
            torch.zeros((slots, spec.vocab), dtype=torch.float32,
                        device=dev),
            torch.zeros((slots,), dtype=torch.int32, device=dev),
            torch.zeros((slots, 2), dtype=torch.int64, device=dev),
            torch.ones((slots,), dtype=torch.bool, device=dev),
            torch.zeros((slots,), dtype=torch.float32, device=dev),
            torch.zeros((slots,), dtype=torch.int32, device=dev),
            torch.zeros((slots,), dtype=torch.int32, device=dev)]
        self._count("carries")
        return _Carry(key, tensors)

    def _return_carry(self, carry: _Carry):
        with self._memo_lock:
            self._free_carries.setdefault(carry.key, []).append(carry)

    def alloc_state(self, slots: int, cap: int,
                    num_pages: Optional[int] = None) -> SlotState:
        """A slot table with every slot empty (done, limit 0). Paged mode
        holds page pools (with the null page 0) and a zeroed page table,
        plus the host-side allocator (and prefix trie when enabled). The
        tensors are a free carry of the key, zeroed in place, or new
        ones."""
        if cap > self.spec.max_positions:
            raise ValueError(f"cache capacity {cap} exceeds the spec's "
                             f"max_positions {self.spec.max_positions}")
        n_layer = self.spec.n_layer
        if self.paged:
            mp = self.max_pages_for(cap)
            n_pages = self.default_num_pages(slots, cap) \
                if num_pages is None else int(num_pages)
            if n_pages < mp:
                raise ValueError(
                    f"pool of {n_pages} pages cannot seat even one slot at "
                    f"cap {cap} ({mp} pages)")
            key = ("paged", slots, cap, n_pages)
        else:
            key = ("dense", slots, cap)
        with self._memo_lock:
            free = self._free_carries.get(key)
            carry = free.pop() if free else None
        if carry is None:
            carry = self._new_carry(key)
        else:
            with _device_lock(self.device):
                for t in carry.tensors:
                    t.zero_()
                carry.tensors[-4].fill_(True)   # done
        vals = carry.tensors
        caches = (vals[:n_layer], vals[n_layer:2 * n_layer])
        if self.paged:
            allocator = PageAllocator(n_pages, self.page_size)
            prefix = RadixPrefixCache(allocator) \
                if self.prefix_enabled() else None
            st: SlotState = PagedSlotState(
                slots, cap, n_pages, self.page_size, *caches,
                *vals[2 * n_layer:], alloc=allocator, prefix=prefix)
        else:
            st = SlotState(slots, cap, *caches, *vals[2 * n_layer:])
        st._carry = carry
        st._finalizer = weakref.finalize(st, self._return_carry, carry)
        return st

    def free_state(self, state: SlotState):
        """Hand the state's carry back now (dropping the state does so
        too): the next ``alloc_state`` of its key reuses the tensors and
        the graphs captured on them. The state must not be used after."""
        if state._finalizer is not None:
            state._finalizer()
        state._carry = None
        for name in type(state)._fields():
            if isinstance(getattr(state, name), (list, torch.Tensor)):
                setattr(state, name, None)

    def _check_live(self, state: SlotState):
        if state._carry is None:
            raise ValueError("this slot table was freed (free_state); "
                             "alloc_state a new one")

    # -- prefill ----------------------------------------------------------
    def _run(self, prog, io, feed, length):
        fetches = [io["logits"]] + list(io["k"]) + list(io["v"])
        outs = self._exe.run(prog, feed=feed, fetch_list=fetches,
                             return_numpy=False, scope=self.scope)
        vals = [o.device_value() for o in outs]
        self._count("prefill_tokens", length)
        n_layer = self.spec.n_layer
        return vals[0], vals[1:1 + n_layer], vals[1 + n_layer:]

    def _run_prefill(self, tokens_row: np.ndarray, length: int, tp: int):
        """One prompt through its bucket's prefill plan; the logits and
        K/V stay on the device."""
        prog, io = self._prefill_prog(tp)
        row = np.full((1, tp, 1), self.spec.pad_id, np.int64)
        row[0, :length, 0] = tokens_row[:length]
        pos = np.arange(tp, dtype=np.int64).reshape(1, tp, 1)
        return self._run(prog, io, {
            io["tokens"]: row, io["pos"]: pos,
            io["length"]: np.array([length], np.int32)}, length)

    def _ingest_key(self, key):
        with self._memo_lock:
            if key not in self._ingest_keys:
                self._ingest_keys.add(key)
                self._count("ingest_builds")

    def _seat(self, state: SlotState, slot: int, last_logits, position: int,
              sampling: SamplingParams, limit: int):
        """The per-slot carry of a seated request (under the device lock)."""
        key = int(make_rng_row(sampling.seed)[0])
        state.logits[slot].copy_(last_logits)
        state.positions[slot] = position
        state.rngs[slot, 0] = key
        state.rngs[slot, 1] = 0
        state.done[slot] = False
        state.temps[slot] = float(sampling.temperature)
        state.topks[slot] = max(int(sampling.top_k), 0)
        state.limits[slot] = limit

    def _ingest_dense(self, state: SlotState, slot: int, tp: int, logits,
                      ks, vs, length: int, sampling, limit: int):
        self._ingest_key(("dense", tp, state.slots, state.cap))
        with _device_lock(self.device):
            for cache, new in zip(state.cache_k + state.cache_v, ks + vs):
                cache[slot, :, :tp].copy_(new[0])
                cache[slot, :, tp:].zero_()
            self._seat(state, slot, logits[0, length - 1], length, sampling,
                       limit)

    # -- paged prefill/ingest --------------------------------------------
    def _prefix_gather(self, state: "PagedSlotState", pages, pc: int):
        """Dense [1, H, pc, D] views of a prefix's pool pages, per layer,
        for the prefix-prefill program's K/V feeds (the row pads with the
        null page; shorter prefixes are masked by the prefix_len feed)."""
        row = np.zeros((1, pc // self.page_size), np.int32)
        row[0, :len(pages)] = pages
        row = torch.from_numpy(row).to(self.device)
        with _device_lock(self.device):
            ks = [paged_gather_fn(p, row) for p in state.cache_k]
            vs = [paged_gather_fn(p, row) for p in state.cache_v]
        return ks, vs

    def _run_prefill_prefix(self, state: "PagedSlotState",
                            tokens_row: np.ndarray, length: int,
                            suffix_start: int, ts: int, pc: int,
                            shared_pages):
        """Prefix-hit prefill: only the suffix [suffix_start, length) runs
        through the model; the shared prefix's K/V is gathered from the
        pool and fed."""
        prog, io = self._prefix_prog(ts, pc)
        ls = length - suffix_start
        row = np.full((1, ts, 1), self.spec.pad_id, np.int64)
        row[0, :ls, 0] = tokens_row[suffix_start:length]
        pos = (suffix_start + np.arange(ts, dtype=np.int64)).reshape(1, ts, 1)
        pk, pv = self._prefix_gather(state, shared_pages, pc)
        feed = {io["tokens"]: row, io["pos"]: pos,
                io["length"]: np.array([ls], np.int32),
                io["prefix_len"]: np.array([suffix_start], np.int32)}
        for li in range(self.spec.n_layer):
            feed[io["prefix_k"][li]] = pk[li]
            feed[io["prefix_v"][li]] = pv[li]
        return self._run(prog, io, feed, ls)

    def _ingest_paged(self, state: "PagedSlotState", slot: int, bucket: int,
                      logits, ks, vs, plen: int, sstart: int, trow,
                      sampling, limit: int):
        """Scatter the prefilled rows [sstart, sstart + plen) into their
        pages (padding rows and rows past the table go to the null page),
        then seat the slot."""
        self._ingest_key(("paged", bucket, state.slots, state.num_pages,
                          state.max_pages))
        page, mp = self.page_size, state.max_pages
        gpos = sstart + np.arange(bucket)
        pslot = np.clip(gpos // page, 0, mp - 1)
        off = np.clip(gpos - pslot * page, 0, page - 1)
        valid = (np.arange(bucket) < plen) & (gpos < mp * page)
        pidx = np.where(valid, trow[pslot], 0)
        idx = torch.from_numpy(np.stack([pidx, off]).astype(np.int64)).to(
            self.device)
        with _device_lock(self.device):
            for pool, new in zip(state.cache_k + state.cache_v, ks + vs):
                pool[idx[0], :, idx[1], :] = new[0].transpose(0, 1)
            state.table[slot].copy_(torch.from_numpy(trow).to(self.device))
            self._seat(state, slot, logits[0, plen - 1], sstart + plen,
                       sampling, limit)

    def _admit_paged(self, state: "PagedSlotState", slot: int,
                     tokens: np.ndarray, length: int, limit: int,
                     sampling: SamplingParams):
        """Match the prefix trie, take pages from the free list (evicting
        trie-only LRU leaves on shortage), prefill only the unshared
        suffix, scatter it into the pages, seat the slot and publish the
        prompt's full pages to the trie. Raises :class:`PagesExhausted`,
        nothing allocated and nothing seated, when even eviction cannot
        cover the request."""
        page = self.page_size
        alloc = state.alloc
        total_pages = pages_for(limit, page)
        shared: List[int] = []
        if state.prefix is not None:
            # >= 1 prompt token always prefills: decode needs the last
            # prompt token's logits
            shared = state.prefix.match(tokens, max_tokens=length - 1)
            if shared:
                ts = self.prompt_ladder.bucket_for(length - len(shared) * page)
                if ts is None \
                        or ts + self.prefix_cap() > self.spec.max_positions:
                    shared = []   # no prefix program for this geometry
        n_shared = len(shared)
        # hold the matched pages before an eviction can free them
        alloc.retain(shared)
        try:
            need = total_pages - n_shared
            try:
                fresh = alloc.alloc(need)
            except PagesExhausted:
                if state.prefix is None:
                    raise
                self._count("page_evictions",
                            state.prefix.evict(need - alloc.free_count))
                fresh = alloc.alloc(need)
        except PagesExhausted:
            alloc.release(shared)
            raise
        alloc.seat_slot(slot, shared + fresh)
        if state.prefix is not None:
            self._count("prefix_hits" if n_shared else "prefix_misses")
        try:
            trow = np.zeros((state.max_pages,), np.int32)
            trow[:total_pages] = shared + fresh
            suffix_start = n_shared * page
            if n_shared:
                bucket = self.prompt_ladder.bucket_for(length - suffix_start)
                logits, ks, vs = self._run_prefill_prefix(
                    state, tokens, length, suffix_start, bucket,
                    self.prefix_cap(), shared)
                self._count("prefill_tokens_saved", suffix_start)
            else:
                bucket = self.prompt_ladder.bucket_for(length)
                logits, ks, vs = self._run_prefill(tokens, length, bucket)
            self._ingest_paged(state, slot, bucket, logits, ks, vs,
                               length - suffix_start, suffix_start, trow,
                               sampling, limit)
        except Exception:
            # nothing seated: the allocator's view stays the device table's
            alloc.release_slot(slot)
            raise
        if state.prefix is not None:
            # the prompt's full pages: decode writes land at positions >=
            # length, so these never change again
            n_full = length // page
            state.prefix.insert(tokens[:n_full * page].tolist(),
                                (shared + fresh)[:n_full])

    def warm_prefix(self, state: SlotState):
        """Run each feasible suffix bucket's prefix-prefill plan, so a
        later prefix hit makes no new plan. The dummy runs read only the
        null page; their outputs are dropped. Call it twice to capture
        the plans on the card (a plan's first run is eager)."""
        if not isinstance(state, PagedSlotState) or state.prefix is None:
            return
        pc = self.prefix_cap()
        page = self.page_size
        for ts in self.prompt_ladder.buckets:
            if ts + pc > self.spec.max_positions:
                continue
            dummy = np.full((page + ts,), self.spec.pad_id, np.int64)
            self._run_prefill_prefix(state, dummy, page + ts, page, ts, pc,
                                     [])

    def release_slot(self, state: SlotState, slot: int):
        """Host-side slot leave. Paged mode returns the slot's page refs;
        the slot stays done, so its stale table row only routes writes to
        the null page until a re-admission overwrites it. Dense mode has
        nothing to release (the row is the slot's own)."""
        if isinstance(state, PagedSlotState):
            state.alloc.release_slot(slot)

    def admit(self, state: SlotState, slot: int, tokens: np.ndarray,
              max_new_tokens: int,
              sampling: Optional[SamplingParams] = None):
        """Prefill one request and seat it in ``slot``: its K/V in the
        slot's cache rows, its next-token logits, stream, sampling knobs
        and position limit in the carry. Joins happen between decode
        chunks; the caller keeps that order."""
        self._check_live(state)
        self.initialize()
        sampling = sampling or SamplingParams()
        self.validate_sampling(sampling)
        tokens = np.asarray(tokens).reshape(-1)
        length = int(tokens.shape[0])
        if length < 1:
            raise ValueError("empty prompt")
        tp = self.prompt_ladder.bucket_for(length)
        if tp is None:
            raise ValueError(
                f"prompt of {length} tokens exceeds the top prompt bucket "
                f"{self.prompt_ladder.top}")
        limit = length + int(max_new_tokens)
        if limit > state.cap:
            raise ValueError(
                f"prompt {length} + max_new_tokens {max_new_tokens} exceeds "
                f"the cache capacity {state.cap}")
        if isinstance(state, PagedSlotState):
            self._admit_paged(state, slot, tokens, length, limit, sampling)
        else:
            logits, ks, vs = self._run_prefill(tokens, length, tp)
            self._ingest_dense(state, slot, tp, logits, ks, vs, length,
                               sampling, limit)
        self._count("slot_joins")

    # -- decode -----------------------------------------------------------
    def _decode_plan(self, state: SlotState, steps: int) -> _DecodePlan:
        key = state._carry.key + (steps, self.top_k_max)

        def build():
            self._count("decode_builds")
            if self._vh is None and self.top_k_max > 0:
                self._vh = vocab_hash(self.spec.vocab, self.device)
            return _DecodePlan(self._traced_step(state.cap), self._vh)

        return self._memo(self._decode_plans, key, build)

    def _decode_steps(self, state: SlotState, steps: int,
                      plan: _DecodePlan):
        """``steps`` decode steps on the state's carry, in place: sample,
        run the step program, write each slot's new K/V column into the
        cache (through the page table when paged), advance positions and
        done flags. Returns the device [steps, slots] tokens (int32) and
        done-after flags."""
        spec, step = self.spec, plan.step
        io = step.io
        slots, cap = state.slots, state.cap
        paged = isinstance(state, PagedSlotState)
        ctx = EmitContext(self.device, scope=self.scope, consts=plan.consts)
        rows = torch.arange(slots, device=self.device)
        toks_out = torch.empty((steps, slots), dtype=torch.int32,
                               device=self.device)
        dones_out = torch.empty((steps, slots), dtype=torch.bool,
                                device=self.device)
        n_layer = spec.n_layer
        table = state.table.long() if paged else None
        for t in range(steps):
            toks, rngs = sample_step(state.logits, state.rngs, state.temps,
                                     state.topks, self.top_k_max, plan.vh)
            toks = torch.where(state.done, spec.pad_id, toks)
            feed = {io["token"]: toks.long().reshape(slots, 1, 1),
                    io["pos"]: state.positions}
            for li in range(n_layer):
                for name, cache in ((io["cache_k"][li], state.cache_k[li]),
                                    (io["cache_v"][li], state.cache_v[li])):
                    # the unchanged dense step runs on a gathered view of
                    # the pool; only the pool is resident
                    feed[name] = (paged_gather_fn(cache, table, cap)
                                  if paged else cache)
            outs = step(feed, ctx)
            # the step wrote one column per slot into its (copied) cache:
            # write that column into the resident one
            col = torch.clamp(state.positions.long(), 0, cap - 1)
            for li, new in enumerate(outs[1:]):
                cache = (state.cache_k + state.cache_v)[li]
                new_col = new[rows, :, col, :]
                if paged:
                    paged_write_(cache, table, state.positions, new_col,
                                 mask=state.done)
                else:
                    dense_write_(cache, state.positions, new_col)
            pos_n = torch.where(state.done, state.positions,
                                state.positions + 1)
            done_n = state.done | (toks == spec.eos_id) \
                | (pos_n >= state.limits)
            state.logits.copy_(outs[0].reshape(slots, spec.vocab))
            state.positions.copy_(pos_n)
            state.rngs.copy_(rngs)
            state.done.copy_(done_n)
            toks_out[t] = toks
            dones_out[t] = done_n
        return toks_out, dones_out

    def _capture(self, state: SlotState, steps: int, plan: _DecodePlan,
                 params, gkey):
        """Capture the chunk on the state's carry (one warm-up step on a
        copy of the carry first, on the capture stream), replay it once
        and keep the graph on the carry. Called with the device lock."""
        dev = self.device
        t0 = time.perf_counter()
        side = _capture_stream(dev)
        scratch = state._scratch()
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._decode_steps(scratch, 1, plan)
        torch.cuda.current_stream(dev).wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=_graph_pool(dev), stream=side,
                              capture_error_mode="thread_local"):
            outs = self._decode_steps(state, steps, plan)
        g = _Graph(graph, outs, state.pack(), params)
        state._carry.graphs[gkey] = g
        graph.replay()
        torch.cuda.synchronize(dev)
        with self._memo_lock:
            self.stats["decode_captures"] += 1
            self.stats["capture_seconds"] += time.perf_counter() - t0
        return outs

    def decode_chunk(self, state: SlotState, steps: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Advance every live slot ``steps`` decode steps: on the card one
        replay of the chunk's graph (captured at the key's first chunk on
        this carry). Returns host (tokens [steps, slots] int32, done-after
        [steps, slots] bool), the only values read to the host."""
        self._check_live(state)
        plan = self._decode_plan(state, steps)
        params = self._params(plan.step)
        t0 = time.perf_counter() if _monitor._enabled else 0.0
        if self.device.type != "cuda" or not FLAGS.jit_cache:
            toks, dones = self._decode_steps(state, steps, plan)
            toks, dones = toks.cpu(), dones.cpu()
        else:
            gkey = (steps, self.top_k_max)
            with _device_lock(self.device):
                g = state._carry.graphs.get(gkey)
                if g is not None and g.rebound(state, self.scope):
                    del state._carry.graphs[gkey]
                    g = None
                if g is None:
                    toks, dones = self._capture(state, steps, plan, params,
                                                gkey)
                else:
                    g.graph.replay()
                    toks, dones = g.outs
                    self._count("decode_replays")
                # read before another graph of the shared pool replays
                toks, dones = toks.cpu(), dones.cpu()
        toks, dones = toks.numpy(), dones.numpy()
        self._count("decode_steps", steps)
        self._count("host_fetch_bytes", toks.nbytes + dones.nbytes)
        if t0:
            dt = time.perf_counter() - t0
            _monitor.timer("generation_decode_seconds").observe(dt)
            _monitor.histogram("generation_step_seconds").observe(
                dt / max(1, steps))
        return toks, dones

    # -- one-shot API -----------------------------------------------------
    def generate(self, prompts: Sequence[np.ndarray], max_new_tokens: int,
                 sampling=None) -> List[np.ndarray]:
        """Continuations for a batch of prompts, bucketed on (slots,
        prompt bucket, new-token bucket): a prefill per prompt, then one
        decode chunk of the bucketed step count. ``sampling`` is one
        SamplingParams for all, a list per prompt, or None (greedy).
        Returns one int32 array per prompt (EOS included when hit)."""
        self.initialize()
        n = len(prompts)
        if n < 1:
            return []
        if isinstance(sampling, SamplingParams) or sampling is None:
            sampling = [sampling or SamplingParams()] * n
        out: List[np.ndarray] = []
        top = self.slot_ladder.top
        for off in range(0, n, top):
            out.extend(self._generate_chunk(prompts[off:off + top],
                                            max_new_tokens,
                                            sampling[off:off + top]))
        return out

    def _generate_chunk(self, prompts, max_new_tokens, sampling):
        n = len(prompts)
        slots = self.slot_ladder.bucket_for(n)
        nb_new = self.new_ladder.bucket_for(int(max_new_tokens))
        if nb_new is None:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds the top new-tokens "
                f"bucket {self.new_ladder.top}")
        max_len = max(int(np.asarray(p).reshape(-1).shape[0])
                      for p in prompts)
        tp_top = self.prompt_ladder.bucket_for(max_len)
        if tp_top is None:
            raise ValueError(
                f"prompt of {max_len} tokens exceeds the top prompt bucket "
                f"{self.prompt_ladder.top}")
        state = self.alloc_state(slots, tp_top + nb_new)
        try:
            for i, p in enumerate(prompts):
                self.admit(state, i, p, max_new_tokens, sampling[i])
            toks, dones = self.decode_chunk(state, nb_new)
        finally:
            self.free_state(state)
        return [collect_tokens(toks[:, i], dones[:, i], int(max_new_tokens))
                for i in range(n)]


def _cache_dtype(spec: GenerationSpec) -> torch.dtype:
    return getattr(torch, spec.cache_dtype)


def collect_tokens(tok_col: np.ndarray, done_col: np.ndarray,
                   max_new: int) -> np.ndarray:
    """One slot's emitted tokens from a chunk's [steps] columns: every step
    where the slot was live before the step emits (the EOS step
    included), capped at max_new."""
    out = []
    was_done = False
    for t in range(tok_col.shape[0]):
        if was_done or len(out) >= max_new:
            break
        out.append(int(tok_col[t]))
        was_done = bool(done_col[t])
    return np.asarray(out, np.int32)


def naive_generate(engine: DecodeEngine, tokens: np.ndarray,
                   max_new_tokens: int,
                   gaps: Optional[List[float]] = None) -> np.ndarray:
    """Greedy re-prefill-each-token reference: for every new token the
    whole sequence so far runs through the bucketed prefill and the last
    column's argmax is taken. O(T^2) device work per sequence: the
    baseline the engine's tokens are held against. ``gaps``, when given,
    gets each step's top-1 minus top-2 logit: where it is within rounding,
    a cached decode step may pick the other token."""
    engine.initialize()
    seq = list(np.asarray(tokens).reshape(-1).astype(np.int64))
    # the ladder extended past the prompt top, so the growing sequence
    # still buckets (prompt top + new-tokens top is the engine's cap)
    ladder = BucketLadder(sorted(
        set(engine.prompt_ladder.buckets)
        | {engine.prompt_ladder.top + engine.new_ladder.top}))
    out: List[int] = []
    for _ in range(int(max_new_tokens)):
        tp = ladder.bucket_for(len(seq))
        if tp is None:
            break
        logits, _ks, _vs = engine._run_prefill(np.asarray(seq, np.int64),
                                               len(seq), tp)
        row = logits[0, len(seq) - 1]
        if gaps is not None:
            top2 = torch.topk(row, 2).values
            gaps.append(float(top2[0] - top2[1]))
        tok = int(torch.argmax(row).item())
        out.append(tok)
        if tok == engine.spec.eos_id:
            break
        seq.append(tok)
    return np.asarray(out, np.int32)
