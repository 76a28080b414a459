"""GenerationPredictor: continuous batching over the decode engine
(counterpart of ``paddle_tpu/inference/generation/predictor.py``).

``BatchingPredictor`` coalesces one-shot forwards; generation needs the
same serving spine (bounded queue and shedding, per-request deadlines,
dispatch retry, circuit breaker, supervised dispatcher) around a loop
instead of a call. This subclass keeps all of it (admission goes through
``_submit_request``; the chaos sites ``serving.dispatch`` and
``serving.dispatcher`` fire on the decode path too) and replaces the
dispatcher body with a slot loop:

- a fixed slot table (``max_slots`` rows of one KV cache) decodes
  ``decode_chunk`` steps per device call, on the card one replay of the
  chunk's captured CUDA graph;
- a sequence that hits EOS, its token budget or its deadline leaves at
  the chunk boundary and resolves its future; the freed slot is
  re-admitted from the queue at once (prefill and cache insert), so one
  long sequence never holds the batch hostage;
- in paged mode a request whose pages the pool cannot give now is
  deferred at the queue head (``PagesExhausted``), never failed, until
  leaves free pages;
- per-slot random streams make sampling deterministic per request, in
  whichever slot it lands and whoever joins or leaves around it.

The dispatcher thread alone drives the engine; clients only enqueue. Its
slot table is allocated at the first admission, so a ``warmup()`` before
traffic hands it the carry (and the decode graphs captured on it) that
warm-up used: after ``warmup()`` traffic builds and captures nothing.

``health()`` adds the decode-side view (active slots, oldest in-flight
sequence age, time since the last decode step) and reads ``healthy:
false`` when the loop is wedged: live slots and no step inside
``FLAGS.generation_stall_budget_s``.

With the monitor on the predictor mirrors ``stats`` into the JAX
predictor's ``generation_*`` counters, observes the token latencies
(``generation_ttft_seconds``, ``generation_tpot_seconds``), seals each
request's trace (admission, enqueue-wait, admit, decode) when its future
resolves, and registers its ``generation_plane`` for ``GET /generation``.
With a memory budget set (``FLAGS.memory_budget_frac``/``_bytes``,
profiling/memory.py) the dense slot table's cap downshifts to the largest
that fits (``_fit_cap_to_budget``: a prompt whose bucket is over the new
cap is refused at submit), and the paged pool shrinks to fit
(``_fit_pages_to_budget``); with no budget both keep the cap and the pool.
"""

from __future__ import annotations

import time
import warnings
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Dict, List, Optional

import numpy as np

from ... import monitor as _monitor
from ...testing import faults as _faults
from ...utils.flags import FLAGS, memory_budget_set
from ..serving import (BatchingPredictor, DeadlineExceeded, _Request,
                       _safe_resolve)
from .engine import DecodeEngine, PagedSlotState
from .paging import PagesExhausted
from .sampling import SamplingParams

__all__ = ["GenerationPredictor", "trace_span_coverage"]

# predictor stats mirrored into the JAX predictor's monitor counters
_MONITOR_COUNTERS = {"tokens": "generation_tokens_total",
                     "eos": "generation_eos_total",
                     "leaves": "generation_slot_leaves_total",
                     "deferrals": "generation_page_starved_total"}


def trace_span_coverage(rec: dict) -> float:
    """Fraction of a sealed trace's wall time covered by the union of its
    span intervals (wall = first span start to last span end): a
    lifecycle trace whose spans cover little of the request's life has
    an unattributed latency hole."""
    spans = rec.get("spans") or []
    if not spans:
        return 0.0
    ivs = sorted((float(s["t0"]), float(s["t1"])) for s in spans)
    lo, hi = ivs[0][0], max(t1 for _, t1 in ivs)
    if hi <= lo:
        return 1.0
    covered, cur0, cur1 = 0.0, ivs[0][0], ivs[0][1]
    for t0, t1 in ivs[1:]:
        if t0 > cur1:
            covered += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    covered += cur1 - cur0
    return covered / (hi - lo)


class _GenRequest(_Request):
    __slots__ = ("tokens", "max_new", "sampling", "emitted", "slot",
                 "deferrals", "t_first", "t_seated")

    def __init__(self, tokens: np.ndarray, max_new: int,
                 sampling: SamplingParams,
                 deadline_s: Optional[float] = None):
        super().__init__({"token_ids": tokens[None]}, 1,
                         deadline_s=deadline_s)
        self.tokens = tokens
        self.max_new = int(max_new)
        self.sampling = sampling
        self.emitted: List[int] = []
        self.slot = -1
        self.deferrals = 0
        self.t_first = 0.0
        self.t_seated = 0.0


class GenerationPredictor(BatchingPredictor):
    """Continuous-batching generation front of a :class:`DecodeEngine`.

    ``submit(tokens, max_new_tokens=, sampling=, deadline_ms=)`` returns
    a Future resolving to the generated int32 token array (EOS included
    when hit); ``run()`` blocks on it. The resilience knobs are
    BatchingPredictor's."""

    def __init__(self, engine: DecodeEngine, max_slots: int = 4,
                 decode_chunk: int = 4,
                 default_max_new_tokens: int = 16,
                 stall_budget_s: Optional[float] = None,
                 **resilience):
        self._engine = engine
        self._max_slots = int(max_slots)
        self._chunk = max(1, int(decode_chunk))
        self._default_max_new = int(default_max_new_tokens)
        top_cap = engine.prompt_ladder.top + engine.new_ladder.top
        if engine.paged:
            # paged mode admits by pages: a budget would size the pool,
            # never the cap
            self._cap = top_cap
            self._num_pages = self._fit_pages_to_budget(engine, top_cap)
        else:
            self._cap = self._fit_cap_to_budget(engine, top_cap)
            self._num_pages = None
        self._stall_budget_s = (
            float(stall_budget_s) if stall_budget_s is not None
            else float(FLAGS.generation_stall_budget_s))
        self._slot_reqs: List[Optional[_GenRequest]] = \
            [None] * self._max_slots
        self._slot_used = [False] * self._max_slots
        self._state = None
        # the page-starved request at the queue head waits here (not
        # failed) until slot leaves free pages
        self._deferred: Optional[_GenRequest] = None
        self._page_starved_since: Optional[float] = None
        self._last_step_t = time.perf_counter()
        # joins (readmits: joins into a slot an earlier request left),
        # leaves, decode chunks and steps, slot-steps (live slots summed
        # over chunks: mean occupancy = slot_steps / (chunks * slots)),
        # tokens resolved to callers, EOS finishes, page deferrals
        self.stats = {"joins": 0, "readmits": 0, "leaves": 0,
                      "decode_chunks": 0, "decode_steps": 0,
                      "slot_steps": 0, "tokens": 0, "eos": 0,
                      "deferrals": 0}
        super().__init__(engine, max_batch_size=self._max_slots,
                         **resilience)
        _monitor.register_generation_provider(self._health_name,
                                              self.generation_plane)

    def _stat(self, name: str, n: int = 1):
        self.stats[name] += n
        if _monitor._enabled and name in _MONITOR_COUNTERS:
            _monitor.counter(_MONITOR_COUNTERS[name]).inc(n)

    def _resolve(self, req: _GenRequest, value=None, exc=None):
        """Seal the request's trace, then resolve its future."""
        if req.trace is not None:
            if exc is None:
                self._finish_trace(req, True)
            else:
                self._finish_trace(req, False, type(exc).__name__)
        _safe_resolve(req.future, value=value, exc=exc)

    def generation_plane(self) -> Dict[str, Any]:
        """This predictor's part of ``GET /generation``: the slot table
        (occupancy, cap, pages) and its counts."""
        st = self._state
        plane: Dict[str, Any] = {
            "slots": self._max_slots, "cap": self._cap,
            "active_slots": sum(r is not None for r in self._slot_reqs),
            "decode_chunk": self._chunk, "stats": dict(self.stats),
            "engine": dict(self._engine.stats)}
        if isinstance(st, PagedSlotState) and st.alloc is not None:
            plane["pages_free"] = st.alloc.free_count
            plane["pages_total"] = st.num_pages
        return plane

    # -- surface ----------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return ["token_ids"]

    def get_output_names(self) -> List[str]:
        return ["generated_ids"]

    @property
    def _program(self):  # no wrapped predictor program
        raise AttributeError("GenerationPredictor wraps a DecodeEngine, "
                             "not a Program predictor")

    def clone(self):
        return GenerationPredictor(
            self._engine, max_slots=self._max_slots,
            decode_chunk=self._chunk,
            default_max_new_tokens=self._default_max_new,
            stall_budget_s=self._stall_budget_s,
            max_queue_rows=self._max_queue_rows,
            shed_policy=self._shed_policy,
            default_deadline_ms=self._default_deadline_ms,
            dispatch_retries=self._retries,
            retry_backoff_ms=self._backoff_s * 1e3,
            breaker_threshold=self._breaker.threshold,
            breaker_reset_ms=self._breaker.reset_s * 1e3)

    def _fit_cap_to_budget(self, engine: DecodeEngine, cap: int) -> int:
        """Memory pre-flight for the dense slot table: with a budget set,
        a ``(max_slots, cap)`` table that cannot fit downshifts to the
        largest fitting cap on the engine's ladder (prompt bucket + top
        new-token bucket) instead of allocating a table the first decode
        runs out of memory on; prompts over the new cap are refused at
        submit. No budget: ``cap`` unchanged, at no cost."""
        if not memory_budget_set():
            return cap
        from ...profiling import memory as _mem

        budget, src = _mem.budget_bytes(engine.device)
        if budget <= 0 or engine.state_nbytes(self._max_slots,
                                              cap) <= budget:
            return cap
        caps = sorted({tp + engine.new_ladder.top
                       for tp in engine.prompt_ladder.buckets
                       if tp + engine.new_ladder.top < cap},
                      reverse=True)
        got, nbytes = _mem.fitting_config(
            caps, lambda c: engine.state_nbytes(self._max_slots, c),
            budget)
        if got is None:
            rep = _mem.FootprintReport()
            rep.peak_bytes = engine.state_nbytes(
                self._max_slots, min(caps) if caps else cap)
            rep.peak_op_type = "alloc_state"
            rep.top_vars = [{"name": "cache_k/cache_v",
                             "nbytes": rep.peak_bytes, "kind": "state",
                             "producer": "alloc_state", "callstack": None}]
            raise _mem.MemoryBudgetExceeded(
                f"generation slot table: even the smallest cap ladder "
                f"config (slots={self._max_slots}) needs "
                f"{rep.peak_bytes} bytes > budget {budget} ({src}); "
                f"reduce max_slots or raise the budget",
                rep, budget, budget_source=src,
                where="generation.slot_table")
        warnings.warn(
            f"generation memory budget: (slots={self._max_slots}, "
            f"cap={cap}) KV cache needs "
            f"{engine.state_nbytes(self._max_slots, cap)} bytes > "
            f"budget {budget} ({src}); downshifting to the largest "
            f"fitting cap {got} ({nbytes} bytes): prompts longer than "
            f"{got - engine.new_ladder.top} tokens cannot be admitted "
            f"under this budget")
        if _monitor._enabled:
            _monitor.counter("generation_cap_downshift_total").inc()
            _monitor.gauge("generation_cap_effective").set(got)
        return got

    def _fit_pages_to_budget(self, engine: DecodeEngine,
                             cap: int) -> Optional[int]:
        """Paged budget fit: size the page pool to the budget instead of
        downshifting the cap. Any prompt the ladder accepts stays
        admissible; a pool too small for the moment's mix defers
        requests at admission (PagesExhausted) rather than refusing
        them. Returns the pool's page count, or None (the engine's
        capacity-equivalent pool) without a budget."""
        if not memory_budget_set():
            return None
        from ...profiling import memory as _mem

        budget, src = _mem.budget_bytes(engine.device)
        if budget <= 0:
            return None
        default = engine.default_num_pages(self._max_slots, cap)
        if engine.state_nbytes(self._max_slots, cap, default) <= budget:
            return default
        # floor: one slot must be able to fill its whole cap, or the
        # top-bucket prompt the ladder promises could never decode
        floor = engine.max_pages_for(cap)
        got, nbytes = _mem.fitting_pages(
            lambda n: engine.state_nbytes(self._max_slots, cap, n),
            budget, hi=default, lo=floor)
        if got is None:
            rep = _mem.FootprintReport()
            rep.peak_bytes = engine.state_nbytes(self._max_slots, cap,
                                                 floor)
            rep.peak_op_type = "alloc_state"
            rep.top_vars = [{"name": "page_pool_k/page_pool_v",
                             "nbytes": rep.peak_bytes, "kind": "state",
                             "producer": "alloc_state", "callstack": None}]
            raise _mem.MemoryBudgetExceeded(
                f"generation page pool: even the one-slot floor of "
                f"{floor} pages (slots={self._max_slots}, cap={cap}) "
                f"needs {rep.peak_bytes} bytes > budget {budget} "
                f"({src}); reduce the ladder or raise the budget",
                rep, budget, budget_source=src,
                where="generation.page_pool")
        warnings.warn(
            f"generation memory budget: capacity-equivalent pool of "
            f"{default} pages needs "
            f"{engine.state_nbytes(self._max_slots, cap, default)} "
            f"bytes > budget {budget} ({src}); sizing the pool to "
            f"{got} pages ({nbytes} bytes): admission defers when the "
            f"free list runs dry")
        if _monitor._enabled:
            _monitor.counter("generation_pool_downsize_total").inc()
            _monitor.gauge("generation_pages_budget").set(got)
        return got

    def warmup(self) -> Dict[str, float]:
        """Build and capture the whole decode path up front: on a scratch
        slot table, admit a template prompt per prompt bucket (each
        bucket with its own token value, so a longer template cannot
        prefix-hit a shorter one's pages and skip the miss path), run
        ``warm_prefix`` and one decode chunk. Each is run twice (a plan's
        first run is its eager warm-up, its second the capture), with
        other token values the second time. The table is then freed, so
        the dispatcher's table takes its carry and decode graphs: live
        traffic over mixed lengths builds and captures nothing. Buckets
        over the cap are skipped. Returns {cell: seconds}."""
        eng = self._engine.initialize()
        took: Dict[str, float] = {}
        state = eng.alloc_state(self._max_slots, self._cap,
                                num_pages=self._num_pages)
        buckets = eng.prompt_ladder.buckets
        steps = min(self._chunk, eng.new_ladder.top)
        try:
            for bi, tp in enumerate(buckets):
                if tp + steps > self._cap:
                    continue
                t0 = time.perf_counter()
                for rnd in range(2):
                    prompt = np.full((tp,), (eng.spec.pad_id + 1 + bi
                                             + rnd * len(buckets))
                                     % eng.spec.vocab, np.int64)
                    # paged: the template slot re-seats; give its pages
                    # back first
                    eng.release_slot(state, 0)
                    eng.admit(state, 0, prompt, steps, SamplingParams())
                took[f"prefill_p{tp}"] = time.perf_counter() - t0
            if eng.prefix_enabled():
                t0 = time.perf_counter()
                for _ in range(2):
                    eng.warm_prefix(state)
                took["prefill_prefix"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(2):
                eng.decode_chunk(state, self._chunk)
            took[f"decode_s{self._max_slots}_c{self._cap}"
                 f"_t{self._chunk}"] = time.perf_counter() - t0
        finally:
            eng.free_state(state)
        return took

    # -- client side ------------------------------------------------------
    def submit(self, tokens, max_new_tokens: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               deadline_ms: Optional[float] = None):
        """Enqueue one generation request; the Future resolves to the
        generated int32 token array. Admission control, deadlines and the
        circuit breaker behave as the base predictor's submit
        (Overloaded / DeadlineExceeded / CircuitOpen)."""
        if self._stop.is_set():
            raise RuntimeError("GenerationPredictor is shut down")
        toks = np.asarray(tokens).reshape(-1).astype(np.int64)
        if toks.size < 1:
            raise ValueError("empty prompt")
        eng = self._engine
        if toks.size > eng.prompt_ladder.top:
            raise ValueError(
                f"prompt of {toks.size} tokens exceeds the top prompt "
                f"bucket {eng.prompt_ladder.top}")
        tb = eng.prompt_ladder.bucket_for(toks.size)
        if tb is not None and tb > self._cap:
            raise ValueError(
                f"prompt of {toks.size} tokens pads to prompt bucket "
                f"{tb}, above the cache capacity {self._cap} (the cap "
                f"was downshifted to fit the memory budget)"
                if self._cap < eng.prompt_ladder.top + eng.new_ladder.top
                else f"prompt of {toks.size} tokens pads to prompt "
                f"bucket {tb}, above the cache capacity {self._cap}")
        max_new = (self._default_max_new if max_new_tokens is None
                   else int(max_new_tokens))
        if eng.new_ladder.bucket_for(max_new) is None:
            raise ValueError(
                f"max_new_tokens {max_new} exceeds the top new-tokens "
                f"bucket {eng.new_ladder.top}")
        if toks.size + max_new > self._cap:
            raise ValueError(
                f"prompt {toks.size} + max_new_tokens {max_new} "
                f"exceeds the cache capacity {self._cap}")
        # checked in the caller's thread too: a bad top_k raises here
        eng.validate_sampling(sampling or SamplingParams())
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        req = _GenRequest(toks, max_new, sampling or SamplingParams(),
                          deadline_s=(deadline_ms * 1e-3
                                      if deadline_ms is not None
                                      else None))
        return self._submit_request(req)

    def run(self, tokens, max_new_tokens: Optional[int] = None,
            sampling: Optional[SamplingParams] = None,
            timeout: Optional[float] = None,
            deadline_ms: Optional[float] = None) -> np.ndarray:
        fut = self.submit(tokens, max_new_tokens=max_new_tokens,
                          sampling=sampling, deadline_ms=deadline_ms)
        try:
            return fut.result(timeout=timeout)
        except _FutureTimeout:
            fut.cancel()
            raise

    def shutdown(self, timeout: float = 30.0):
        """Stop admitting, drain the queue and the slots, join the
        dispatcher; then hand the slot table's carry back to the engine
        (the next predictor on it reuses the tensors and graphs)."""
        _monitor.unregister_generation_provider(self._health_name)
        super().shutdown(timeout)
        with self._thread_lock:
            alive = self._thread.is_alive()
        if not alive:
            self._drop_state()

    close = shutdown

    # -- health -----------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """Base resilience surface plus the decode view. ``healthy`` is
        false when a loop with live slots has not completed a step inside
        the stall budget (or pages starve waiters), even though the
        dispatcher thread is alive."""
        h = super().health()
        now = time.perf_counter()
        slot_ages = [now - r.t_enqueue for r in list(self._slot_reqs)
                     if r is not None]
        ages = list(slot_ages)
        d = self._deferred
        if d is not None:
            ages.append(now - d.t_enqueue)
        h.update({
            "active_slots": len(slot_ages),
            "slots": self._max_slots,
            "oldest_seq_age_s": round(max(ages), 3) if ages else 0.0,
            "decode_steps": self.stats["decode_steps"],
            "last_decode_step_age_s": round(now - self._last_step_t, 3),
            "decode_chunk": self._chunk,
        })
        starved = False
        if self._engine.paged:
            st = self._state
            h["paged"] = True
            if isinstance(st, PagedSlotState) and st.alloc is not None:
                h["pages_free"] = st.alloc.free_count
                h["pages_total"] = st.num_pages
                h["prefix_cached_pages"] = (
                    st.prefix.cached_pages if st.prefix is not None else 0)
            since = self._page_starved_since
            starved = since is not None and (
                self._deferred is not None or not self._queue.empty())
            h["page_starved"] = starved
            h["page_starved_s"] = (round(now - since, 3)
                                   if since is not None else 0.0)
        wedged = bool(slot_ages) and self._stall_budget_s > 0 and (
            now - self._last_step_t) > self._stall_budget_s
        h["healthy"] = (not wedged and not starved
                        and h["dispatcher_alive"]
                        and not h["shut_down"]
                        and h["breaker"] != "open")
        return h

    # -- dispatcher -------------------------------------------------------
    def _drop_state(self):
        """Free the slot table now (its carry goes back to the engine for
        the next ``alloc_state``); the next admission allocates anew."""
        st, self._state = self._state, None
        if st is not None:
            self._engine.free_state(st)

    def _fail_pending(self, make_exc, inflight: bool = True):
        if inflight:
            for i, r in enumerate(self._slot_reqs):
                if r is not None:
                    self._slot_reqs[i] = None
                    self._fail_one(r, make_exc)
            # a crash may have left the table mid-update: start afresh
            self._drop_state()
        # a deferred request is still queued: fail it with the queue
        if self._deferred is not None:
            r, self._deferred = self._deferred, None
            self._page_starved_since = None
            self._fail_one(r, make_exc)
        super()._fail_pending(make_exc, inflight)

    def _admit_with_retry(self, state, slot: int, req: _GenRequest):
        def once():
            _faults.fire("serving.dispatch")
            if state.is_consumed():
                raise RuntimeError("slot state freed under the dispatcher")
            return self._engine.admit(state, slot, req.tokens, req.max_new,
                                      req.sampling)

        # PagesExhausted is backpressure, not a fault: only this loop's
        # own leaves free pages, so a retry in place would wait on itself
        return self._retry_call(once, no_retry=(PagesExhausted,))

    def _decode_with_retry(self, state):
        def once():
            _faults.fire("serving.dispatch")
            return self._engine.decode_chunk(state, self._chunk)

        return self._retry_call(once)

    def _leave(self, slot: int):
        if self._state is not None:
            # paged: the slot's page refs go back (host side); the slot
            # is done, so its stale table row only routes writes to the
            # null page until a re-admission
            self._engine.release_slot(self._state, slot)
        self._slot_reqs[slot] = None
        self._stat("leaves")

    def _fail_seated(self, exc):
        """Fail every seated request with ``exc`` and free the table."""
        for i, r in enumerate(self._slot_reqs):
            if r is not None:
                self._leave(i)
                self._resolve(r, exc=exc)
        self._drop_state()

    def _dispatch_loop(self):
        eng = self._engine.initialize()
        while True:
            _faults.fire("serving.dispatcher")
            # a parked page-starved request can expire (or be cancelled)
            # while the table is full
            if self._deferred is not None:
                d = self._deferred
                if d.future.cancelled() or (
                        d.deadline is not None
                        and time.perf_counter() > d.deadline):
                    self._deferred = None
                    self._group.append(d)
                    if self._dispatchable(d):
                        self._deferred = d  # raced: still live, re-park
                    self._group.remove(d)
            # -- join: fill free slots from the queue (chunk boundary) --
            free = [i for i in range(self._max_slots)
                    if self._slot_reqs[i] is None]
            n_active = self._max_slots - len(free)
            admitted = 0
            while free:
                if self._deferred is not None:
                    # the page-starved head retries before the queue
                    # (FIFO: nothing overtakes it)
                    req, self._deferred = self._deferred, None
                else:
                    # an idle predictor waits briefly for work; a live
                    # table only drains what is already queued
                    wait = 0.05 if (n_active == 0 and admitted == 0) \
                        else 0.0
                    req = self._take(wait)
                if req is None:
                    break
                # popped requests sit in _group so a crash fails them
                # loudly (supervisor) instead of stranding callers
                self._group.append(req)
                if not self._dispatchable(req):
                    self._group.remove(req)
                    continue
                if self._state is None:
                    self._state = eng.alloc_state(
                        self._max_slots, self._cap,
                        num_pages=self._num_pages)
                state = self._state
                slot = free.pop(0)
                t_admit0 = time.perf_counter()
                try:
                    self._admit_with_retry(state, slot, req)
                except PagesExhausted:
                    # nothing was seated: park the request and stop
                    # joining (only leaves can free pages)
                    self._group.remove(req)
                    free.insert(0, slot)
                    self._deferred = req
                    req.deferrals += 1
                    self._stat("deferrals")
                    if self._page_starved_since is None:
                        self._page_starved_since = time.perf_counter()
                    break
                except Exception as e:  # noqa: BLE001 -- fan to caller
                    self._group.remove(req)
                    self._breaker.record(False)
                    self._resolve(req, exc=e)
                    continue
                req.t_seated = time.perf_counter()
                if req.trace is not None:
                    req.trace.add("admit", t_admit0, req.t_seated,
                                  slot=slot, prompt=int(req.tokens.size))
                self._breaker.record(True)
                self._page_starved_since = None
                req.slot = slot
                self._slot_reqs[slot] = req
                self._group.remove(req)
                admitted += 1
                self.stats["joins"] += 1
                if self._slot_used[slot]:
                    self.stats["readmits"] += 1
                self._slot_used[slot] = True
            live = [(i, r) for i, r in enumerate(self._slot_reqs)
                    if r is not None]
            if not live:
                if self._stop.is_set() and self._queue.empty() \
                        and self._deferred is None:
                    return
                continue
            # -- decode one chunk over the whole slot table --
            state = self._state
            try:
                toks, dones = self._decode_with_retry(state)
            except Exception as e:  # noqa: BLE001 -- fan to callers
                self._breaker.record(False)
                self._fail_seated(e)
                continue
            self._breaker.record(True)
            self._last_step_t = time.perf_counter()
            if _monitor._enabled:
                _monitor.counter("generation_decode_chunks_total").inc()
            self.stats["decode_chunks"] += 1
            self.stats["decode_steps"] += self._chunk
            self.stats["slot_steps"] += len(live)
            now = time.perf_counter()
            for slot, req in live:
                if not req.t_first:
                    req.t_first = now
                    if _monitor._enabled:
                        _monitor.histogram("generation_ttft_seconds"
                                           ).observe(now - req.t_enqueue)
                finished = False
                for t in range(toks.shape[0]):
                    if len(req.emitted) < req.max_new:
                        req.emitted.append(int(toks[t, slot]))
                    if bool(dones[t, slot]) \
                            or len(req.emitted) >= req.max_new:
                        finished = True
                        break
                if req.future.cancelled():
                    self._cancelled_total += 1
                    self._leave(slot)
                    self._finish_trace(req, False, "Cancelled")
                    continue
                # a request leaves its slot before its future resolves,
                # so a caller's health() after its result sees the slot
                # free
                if not finished and req.deadline is not None \
                        and now > req.deadline:
                    self._expired_total += 1
                    self._leave(slot)
                    self._resolve(req, exc=DeadlineExceeded(
                        f"deadline elapsed mid-decode after "
                        f"{len(req.emitted)} of {req.max_new} tokens"))
                    continue
                if finished:
                    if req.emitted and req.emitted[-1] == eng.spec.eos_id:
                        self._stat("eos")
                    self._stat("tokens", len(req.emitted))
                    self._leave(slot)
                    if req.trace is not None:
                        req.trace.add("decode", req.t_seated, now,
                                      tokens=len(req.emitted))
                    if _monitor._enabled and len(req.emitted) > 1:
                        _monitor.histogram("generation_tpot_seconds"
                                           ).observe(
                            (now - req.t_first) / (len(req.emitted) - 1))
                    self._resolve(req, value=np.asarray(
                        req.emitted, np.int32))
