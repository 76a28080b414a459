"""Bucketed serving: shape-bucket plans and request coalescing
(counterpart of ``paddle_tpu/inference/serving.py``).

Every ``AnalysisPredictor.run`` is one device call, and the executor keeps
one plan per feed signature: on the card a plan's first run is its eager
warm-up and its second captures a CUDA graph, which later runs replay. A
request of a new batch size is a new plan, so a cold size costs a warm-up
and a capture. This module caps that:

- **Shape bucketing** (``BucketedPredictor``): request batch dims (and
  optionally one declared dynamic trailing dim, e.g. seqlen) are padded
  UP to a bounded bucket ladder (powers of two by default), so the plan
  count is capped by the ladder and any request shape is a bucket *hit*.
  Oversize batches split into top-bucket chunks; results are sliced back
  to the caller's true row count. The model must be row-independent at
  inference (true of frozen inference programs: fc, conv, softmax per
  example, batch_norm on frozen statistics), so zero pad rows never leak
  into real rows. Whether a padded run's rows are bitwise the unpadded
  run's depends on the GEMM library's choice of tiles at each row count:
  at save_mlp's widths they are on the CPU (tests/test_torch_serving.py);
  against the wrapped predictor's run of the same padded feed they are
  always bitwise.

  On the card the padded feed is written straight into a pinned host
  staging buffer of its bucket (two per feed, used in turns, each with
  the event of its last copy, so a buffer is never rewritten while its
  copy is in flight), copied to the card with ``non_blocking=True`` on a
  copy stream, and the compute stream waits for that copy's event: a
  request's copy overlaps the previous replay. Outputs stay on the card:
  each request's rows are a device tensor in a lazy ``PaddleTensor``, so
  a caller's host copy happens when that caller reads. They are the
  executor's copies out of the graph pool, in the normal allocator.

- **Request coalescing** (``BatchingPredictor``): a thread-safe
  micro-batch queue. ``run()`` enqueues and blocks on a future;
  ``submit()`` returns the future. ONE dispatcher thread coalesces
  concurrent requests (up to ``max_batch_size`` rows, waiting at most
  ``batch_timeout_us`` for co-requests) into one padded device call and
  fans the rows back per request.

- **Warm-up** (``warmup()``): runs every ladder cell twice, the plan's
  eager warm-up and then its capture, so first requests replay. Cells
  warm concurrently (``warmup_workers``, default 4): the executor is
  thread-safe and its device lock serialises the captures. After
  ``warmup()`` live traffic in warm buckets makes no new plan and no new
  capture (``Executor.capture_stats``).

- **Resilience**: per-request deadlines (``submit(deadline_ms=)``; a
  request that expires while queued fails fast with
  :class:`DeadlineExceeded` before padding or dispatch, and
  ``run(timeout=)`` cancels its queued request), admission control
  (``max_queue_rows`` with ``shed_policy`` ``"reject-new"`` or
  ``"drop-oldest"``, :class:`Overloaded`), dispatch retries with capped
  exponential backoff, a consecutive-failure circuit breaker with a
  half-open probe (:class:`CircuitOpen`), degradation of a bucket whose
  first dispatch fails twice to the naive unbucketed path, error
  isolation per coalesced call, and a supervised dispatcher that fails
  pending futures loudly and restarts. ``health()`` reports all of it.
  The deterministic chaos harness behind the tests is
  ``paddle_tpu_torch/testing/faults.py`` (sites ``serving.dispatch``,
  ``serving.dispatcher``, ``serving.bucket_dispatch``).

Left out until the port has its monitor (ROADMAP A10): the JAX package's
monitor counters, gauges and timers; ``register_health`` and
``register_trace_provider``; request tracing (``_Trace``, ``trace``,
``trace_events``, ``trace_records``, ``pending_traces``; a future's
``trace_id`` is None, as in the JAX package with the monitor off); and
the memory-budget filter of the warm-up ladder (``_budget_filter``, which
needs ``profiling/memory.py``; with no budget configured the JAX filter
keeps every cell, as the port does).

Wire-up: ``NativeConfig.enable_shape_bucketing()`` /
``.enable_request_coalescing()`` make ``create_paddle_predictor`` return
the wrapped predictor; both wrappers keep the predictor surface (run,
get_input_names, get_output_names, clone).
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import executor as _executor
from ..core.types import dtype_to_numpy
from ..staging import PinnedStaging
from ..testing import faults as _faults

__all__ = ["DEFAULT_BATCH_BUCKETS", "BucketLadder", "BucketedPredictor",
           "BatchingPredictor", "ServingError", "DeadlineExceeded",
           "Overloaded", "CircuitOpen"]


class ServingError(RuntimeError):
    """Base of the serving layer's typed errors: every resilience-path
    failure a caller can see is one of these (or the original exception
    of a dispatch that failed)."""


class DeadlineExceeded(ServingError):
    """The request's ``deadline_ms`` elapsed before its dispatch; it was
    failed without touching the device."""


class Overloaded(ServingError):
    """Admission control shed this request: the queue is at
    ``max_queue_rows`` (reject-new sheds the newcomer, drop-oldest the
    oldest queued requests)."""


class CircuitOpen(ServingError):
    """The dispatch circuit breaker is open after consecutive dispatch
    failures; requests fail fast until a half-open probe succeeds."""


# bounded default ladder: powers of two. 7 plans serve ANY request batch
# <= 64 (bigger batches chunk at 64)
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class BucketLadder:
    """The bucket-selection math, separated so it is directly testable.

    A ladder is a sorted tuple of allowed sizes. ``bucket_for(n)`` is the
    smallest bucket >= n; sizes above the top bucket are served as
    ``chunks(n)``: as many top-bucket chunks as fit, plus one bucketed
    remainder, so the plan set stays capped by the ladder."""

    def __init__(self, buckets: Sequence[int]):
        bs = sorted({int(b) for b in buckets})
        if not bs or bs[0] < 1:
            raise ValueError(f"bucket ladder must be positive ints, "
                             f"got {buckets!r}")
        self.buckets: Tuple[int, ...] = tuple(bs)

    @property
    def top(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest bucket >= n, or None when n exceeds the top bucket
        (the caller chunks)."""
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def chunks(self, n: int) -> List[int]:
        """Split a request of n rows into chunk row-counts, each of which
        fits a bucket. n <= top yields [n]."""
        if n < 1:
            raise ValueError(f"cannot bucket a {n}-row request")
        out = []
        while n > self.top:
            out.append(self.top)
            n -= self.top
        if n:
            out.append(n)
        return out


def _host_array(v) -> np.ndarray:
    """A request input as a host array (a tensor is read to the host)."""
    if isinstance(v, torch.Tensor):
        return _executor._to_numpy(v)
    return np.asarray(v)


def _normalize_feed(inputs, feed_names) -> Dict[str, np.ndarray]:
    """dict or PaddleTensor sequence -> {name: ndarray}, the same
    contract as the predictors' run."""
    from .api import PaddleTensor  # local: api imports serving lazily

    if isinstance(inputs, dict):
        feed = {n: _host_array(v) for n, v in inputs.items()}
    else:
        feed = {}
        for i, t in enumerate(inputs):
            if isinstance(t, PaddleTensor):
                feed[t.name or feed_names[i]] = t.as_ndarray()
            else:
                feed[feed_names[i]] = _host_array(t)
    missing = [n for n in feed_names if n not in feed]
    if missing:
        raise ValueError(f"missing inputs: {missing}")
    return feed


def _request_rows(feed: Dict[str, np.ndarray]) -> int:
    """The request's batch size = dim 0, which every feed must agree on
    (serving treats dim 0 as the row dim, like the coalescer)."""
    rows = None
    for n, v in feed.items():
        if v.ndim == 0:
            raise ValueError(
                f"feed {n!r} is rank-0; serving needs a batch-major "
                f"dim 0 on every feed")
        if rows is None:
            rows = int(v.shape[0])
        elif int(v.shape[0]) != rows:
            raise ValueError(
                f"feed {n!r} has {v.shape[0]} rows where others have "
                f"{rows}; serving coalesces/pads dim 0 uniformly")
    if rows is None or rows < 1:
        raise ValueError("empty feed")
    return rows


def _pad_dim(arr: np.ndarray, dim: int, target: int) -> np.ndarray:
    """Zero-pad ``arr`` along ``dim`` up to ``target`` rows (no-op if
    equal)."""
    if arr.shape[dim] == target:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[dim] = (0, target - arr.shape[dim])
    return np.pad(arr, widths)


def _wait(tensors: Sequence[torch.Tensor]):
    """Wait until the current stream has computed ``tensors`` (no-op on
    the host)."""
    for t in tensors:
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
            return


class BucketedPredictor:
    """Shape-bucketing wrapper around a Native/Analysis predictor.

    Pads each request's batch dim up to the configured ladder (and
    optionally one declared dynamic dim, ``seq_dim``/``seq_buckets``,
    e.g. seqlen, on the feeds in ``seq_feeds``, default all feeds that
    have that dim). Oversize requests chunk at the top bucket. Outputs are
    sliced back to the true row count (the padded seq extent is visible in
    outputs that carry a seq dim: the caller declared it dynamic, so it
    owns masking and slicing there).
    """

    def __init__(self, base, batch_buckets: Optional[Sequence[int]] = None,
                 seq_dim: Optional[int] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 seq_feeds: Optional[Sequence[str]] = None,
                 warmup_workers: int = 4):
        self._base = base
        self._ladder = BucketLadder(batch_buckets or DEFAULT_BATCH_BUCKETS)
        # warmup() warms ladder cells concurrently on this many threads
        # (the executor is thread-safe); 1 = serial
        self._warmup_workers = max(1, int(warmup_workers))
        if (seq_dim is None) != (seq_buckets is None):
            raise ValueError("seq_dim and seq_buckets come together")
        if seq_dim is not None and seq_dim < 1:
            raise ValueError("seq_dim must be a trailing dim (>= 1); "
                             "dim 0 is the batch ladder")
        self._seq_dim = seq_dim
        self._seq_ladder = (BucketLadder(seq_buckets)
                            if seq_buckets is not None else None)
        self._seq_feeds = (None if seq_feeds is None
                           else frozenset(seq_feeds))
        # bucket keys already dispatched at least once (warmup or a live
        # miss); the executor's plans and capture_stats stay the ground
        # truth of what was built
        self._warm: set = set()
        # bucket keys whose FIRST dispatch failed twice: requests mapping
        # here serve through the naive unbucketed path instead of
        # re-failing (a broken bucket must not poison the predictor)
        self._degraded: set = set()
        # keys whose first dispatch is IN FLIGHT: exactly one thread
        # claims a cold key, so only the claimant's failure can degrade
        # it; a concurrent caller's transient fault must not condemn it
        self._compiling: set = set()
        self._lock = threading.Lock()
        self._staging = self._new_staging()

    def _new_staging(self) -> Optional[PinnedStaging]:
        device = getattr(self._base, "device", None)
        if device is not None and device.type == "cuda":
            return PinnedStaging(device, depth=2)
        return None

    # -- predictor surface ------------------------------------------------
    @property
    def _program(self):
        return self._base._program

    def get_input_names(self) -> List[str]:
        return self._base.get_input_names()

    def get_output_names(self) -> List[str]:
        return self._base.get_output_names()

    def clone(self):
        """A second front over a clone of the wrapped predictor (same
        scope, executor and program, so the warm plans are shared, as the
        bucket state is); its own staging buffers."""
        new = BucketedPredictor.__new__(BucketedPredictor)
        new.__dict__.update(self.__dict__)
        new._base = self._base.clone()
        new._lock = threading.Lock()
        new._staging = new._new_staging()
        return new

    @property
    def batch_buckets(self) -> Tuple[int, ...]:
        return self._ladder.buckets

    def health(self) -> Dict[str, Any]:
        """Bucket-layer health: which ladder cells are warm (by warmup or
        live traffic), which degraded to the naive path, and whether
        warmup covered the whole ladder grid."""
        grid = [self._bucket_key(b, s)
                for b in self._ladder.buckets
                for s in (self._seq_ladder.buckets
                          if self._seq_ladder is not None else (None,))]
        with self._lock:
            warm = sorted(self._warm)
            degraded = sorted(self._degraded)
        return {
            "warm_buckets": warm,
            "degraded_buckets": degraded,
            "warmup_complete": set(grid) <= set(warm) | set(degraded),
        }

    # -- serving ----------------------------------------------------------
    def _bucket_key(self, batch_bucket: int,
                    seq_bucket: Optional[int]) -> str:
        return (f"b{batch_bucket}" if seq_bucket is None
                else f"b{batch_bucket}s{seq_bucket}")

    def _is_seq_feed(self, name: str, ndim: int) -> bool:
        return (self._seq_ladder is not None and ndim > self._seq_dim
                and (self._seq_feeds is None or name in self._seq_feeds))

    def _seq_bucket_of(self, feed: Dict[str, np.ndarray]) -> Optional[int]:
        """One seq bucket per request: the max extent of the dynamic dim
        across the declared seq feeds, rounded up the seq ladder."""
        if self._seq_ladder is None:
            return None
        ext = 0
        for n, v in feed.items():
            if self._is_seq_feed(n, v.ndim):
                ext = max(ext, int(v.shape[self._seq_dim]))
        if ext == 0:
            return None
        b = self._seq_ladder.bucket_for(ext)
        if b is None:
            raise ValueError(
                f"dynamic dim extent {ext} exceeds the top seq bucket "
                f"{self._seq_ladder.top}; raise the ladder or truncate")
        return b

    def run(self, inputs: Union[Dict[str, Any], Sequence]):
        """Serve one request: bucket-pad (chunking oversize batches), run
        the padded call(s), slice rows back. Returns PaddleTensor outputs
        like the wrapped predictor, on its device."""
        from .api import PaddleTensor

        feed = _normalize_feed(inputs, self.get_input_names())
        rows = _request_rows(feed)
        seq_b = self._seq_bucket_of(feed)
        parts: List[List[torch.Tensor]] = []
        off = 0
        for c in self._ladder.chunks(rows):
            chunk = {n: v[off:off + c] for n, v in feed.items()}
            off += c
            parts.append(self._run_chunk(chunk, c, seq_b))
        fetch_names = self.get_output_names()
        if len(parts) == 1:
            outs = parts[0]
        else:
            outs = [torch.cat([p[i] for p in parts])
                    for i in range(len(fetch_names))]
        return [PaddleTensor(o, n) for n, o in zip(fetch_names, outs)]

    def _run_naive(self, feed: Dict[str, np.ndarray], key: str
                   ) -> List[torch.Tensor]:
        """Degraded path: serve the TRUE request shape unbucketed (each
        distinct size is a plan of its own, but serves): correctness over
        the plan-count cap for a signature whose bucket is broken."""
        return [t.as_tensor() for t in self._base.run(feed)]

    def _pad(self, feed: Dict[str, np.ndarray], key: str, bucket: int,
             seq_b: Optional[int]) -> Dict[str, Any]:
        """The request padded to its cell: on the card through the
        pinned staging buffers of the cell (device tensors), on the host
        with numpy."""
        block = self._program.global_block()
        padded, items = {}, []
        for n, v in feed.items():
            shape = list(v.shape)
            shape[0] = bucket
            if seq_b is not None and self._is_seq_feed(n, v.ndim):
                shape[self._seq_dim] = seq_b
            if self._staging is None:
                p = _pad_dim(v, 0, bucket)
                if seq_b is not None and self._is_seq_feed(n, p.ndim):
                    p = _pad_dim(p, self._seq_dim, seq_b)
                padded[n] = p
            else:
                items.append(((key, n), v, shape,
                              _executor._feed_dtype(n, v, block)))
        if items:
            tensors, done = self._staging.stage(items)
            self._staging.hand_off(tensors, done)
            padded.update(zip((i[0][1] for i in items), tensors))
        return padded

    def _run_chunk(self, feed: Dict[str, np.ndarray], rows: int,
                   seq_b: Optional[int]) -> List[torch.Tensor]:
        bucket = self._ladder.bucket_for(rows)
        key = self._bucket_key(bucket, seq_b)
        with self._lock:
            # a proven-warm bucket overrides a stale degradation mark
            # (possible only via a lost race; warm wins)
            if key in self._degraded and key not in self._warm:
                degraded = True
            else:
                degraded = False
                # claim the cold key: the FIRST dispatcher owns the first
                # dispatch (and the right to degrade on failure)
                first = (key not in self._warm
                         and key not in self._compiling)
                if first:
                    self._compiling.add(key)
        if degraded:
            return self._run_naive(feed, key)

        def attempt() -> List[torch.Tensor]:
            _faults.fire("serving.bucket_dispatch")
            outs = self._base.run(self._pad(feed, key, bucket, seq_b))
            # slice back to the true rows, on the device: a caller's host
            # copy happens when it reads (a device fault surfaces there)
            return [t.as_tensor()[:rows] for t in outs]

        try:
            try:
                sliced = attempt()
            except Exception as e:
                if not first:
                    # warm or concurrently-claimed bucket: a failure here
                    # is the retry/breaker layer's, never degradation
                    raise
                with self._lock:
                    if key in self._warm:
                        # a concurrent dispatch already PROVED the bucket
                        raise
                try:
                    # one retry before condemning the bucket: a transient
                    # blip on the first dispatch is not a broken bucket
                    sliced = attempt()
                except Exception:
                    with self._lock:
                        proven = key in self._warm
                    if proven:
                        raise
                    # failed twice, never proven: degrade this key to the
                    # naive path instead of re-failing every request
                    self._degrade(key, e)
                    return self._run_naive(feed, key)
            with self._lock:
                self._warm.add(key)
        finally:
            if first:
                with self._lock:
                    self._compiling.discard(key)
        return sliced

    def _degrade(self, key: str, exc: BaseException):
        with self._lock:
            if key in self._warm:
                return  # a concurrent success proved the bucket works
            self._degraded.add(key)
        warnings.warn(
            f"serving bucket {key!r} failed its first dispatch twice "
            f"({exc!r}); degrading this bucket to the naive unbucketed "
            f"path", stacklevel=3)

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               seq_buckets: Optional[Sequence[int]] = None,
               compile_workers: Optional[int] = None
               ) -> Dict[str, float]:
        """Warm the ladder (default: every batch bucket x every seq
        bucket) by running zero feeds shaped from the program's var descs
        through the normal path, twice per cell: the plan's eager warm-up,
        then its capture on the card, so first real requests replay.
        Returns {bucket_key: seconds}.

        Cells warm CONCURRENTLY on ``compile_workers`` threads (default:
        the predictor's ``warmup_workers``, 4): each cell is a plan of its
        own and the executor is thread-safe (its device lock serialises
        the captures). ``compile_workers=1`` is the serial order. Seconds
        are per cell, so concurrent cells' seconds can sum to more than
        the wall clock."""
        bs = list(buckets) if buckets is not None else \
            list(self._ladder.buckets)
        bad = [b for b in bs if b not in self._ladder.buckets]
        if bad:
            raise ValueError(f"warmup buckets {bad} not in the ladder "
                             f"{self._ladder.buckets}")
        if self._seq_ladder is not None:
            sqs = list(seq_buckets) if seq_buckets is not None else \
                list(self._seq_ladder.buckets)
        else:
            sqs = [None]
        took: Dict[str, float] = {}

        def dispatch(key, feed, b, s):
            _faults.fire("serving.bucket_dispatch")
            for _ in range(2):  # the eager warm-up, then the capture
                outs = self._base.run(self._pad(feed, key, b, s))
            _wait([t.as_tensor() for t in outs])

        def warm_one(cell) -> None:
            b, s = cell
            key = self._bucket_key(b, s)
            feed = self._template_feed(b, s)
            t0 = time.perf_counter()
            try:
                dispatch(key, feed, b, s)
            except Exception as e:
                try:
                    dispatch(key, feed, b, s)  # one retry: transient != broken
                except Exception:
                    # one broken bucket must not abort the whole ladder
                    # (or poison live traffic): degrade it, warm the rest
                    self._degrade(key, e)
                    return
            dt = time.perf_counter() - t0
            with self._lock:
                took[key] = dt
                self._warm.add(key)

        # the JAX package filters the cells by a memory budget here
        # (_budget_filter, profiling/memory.py): ROADMAP A10. With no
        # budget configured it keeps every cell, as this does
        cells = [(b, s) for b in bs for s in sqs]
        workers = (self._warmup_workers if compile_workers is None
                   else max(1, int(compile_workers)))
        workers = min(workers, len(cells)) or 1
        if workers == 1:
            for cell in cells:
                warm_one(cell)
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=workers) as pool:
                # materialize so a worker's unexpected exception surfaces
                # here, not silently in a dropped future
                list(pool.map(warm_one, cells))
        return took

    def _template_feed(self, batch: int,
                       seq_b: Optional[int]) -> Dict[str, np.ndarray]:
        """Zero feed with each input's declared desc shape and dtype, the
        batch dim set to the bucket and the declared dynamic dim (if any)
        to the seq bucket: the padded shape live requests produce."""
        block = self._program.global_block()
        feed = {}
        for name in self.get_input_names():
            var = block.vars[name]
            shape = list(var.shape or ())
            if not shape:
                raise ValueError(f"feed {name!r} declares no shape; "
                                 "cannot build a warmup template")
            shape[0] = batch
            for d in range(1, len(shape)):
                if shape[d] is None or shape[d] < 0:
                    if (self._seq_dim == d and seq_b is not None
                            and (self._seq_feeds is None
                                 or name in self._seq_feeds)):
                        shape[d] = seq_b
                    else:
                        raise ValueError(
                            f"feed {name!r} dim {d} is dynamic but not "
                            f"declared via seq_dim/seq_buckets; warmup "
                            f"cannot pick its extent")
            feed[name] = np.zeros(shape, dtype_to_numpy(var.dtype))
        return feed


def _safe_resolve(fut: Future, value=None, exc: Optional[BaseException]
                  = None):
    """Resolve a future exactly once, tolerating every race: already
    cancelled (tombstoned by run(timeout=)), or already resolved by a
    competing path (a shutdown drain racing an in-flight dispatch). A
    resolution race must never raise into (and kill) the dispatcher."""
    try:
        if not fut.set_running_or_notify_cancel():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except BaseException:  # noqa: BLE001 -- InvalidStateError races
        pass


class _Request:
    __slots__ = ("feed", "rows", "sig", "future", "t_enqueue", "deadline",
                 "probe")

    def __init__(self, feed: Dict[str, np.ndarray], rows: int,
                 deadline_s: Optional[float] = None):
        self.feed = feed
        self.rows = rows
        # only same-signature requests can share a device call: same
        # feed names, trailing dims, and dtypes
        self.sig = tuple(sorted(
            (n, v.shape[1:], str(v.dtype)) for n, v in feed.items()))
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        # absolute expiry (perf_counter clock); None = no deadline
        self.deadline = (self.t_enqueue + deadline_s
                         if deadline_s is not None else None)
        # True when this request is the breaker's half-open probe: if it
        # dies BEFORE dispatching (cancel, expiry, crash) the breaker must
        # be released (probe_aborted), or half_open wedges forever
        self.probe = False


class _CircuitBreaker:
    """Consecutive-dispatch-failure circuit breaker.

    Lifecycle::

        closed --(threshold consecutive dispatch failures)--> open
        open   --(reset_ms cooldown elapsed, next submit)--> half_open
        half_open: ONE probe request admitted; its dispatch outcome
                   closes (success) or re-opens (failure) the circuit;
                   other submits fail fast meanwhile.

    ``threshold <= 0`` disables the breaker. State reads on the closed
    fast path are lock-free (one attribute load); every transition
    happens under the lock."""

    def __init__(self, threshold: int, reset_ms: float):
        self.threshold = int(threshold)
        self.reset_s = float(reset_ms) / 1e3
        self.state = "closed"
        self.failures = 0      # consecutive dispatch failures
        self.opens_total = 0
        self._opened_at = 0.0
        self._probing = False
        self._lock = threading.Lock()

    def admit(self):
        """Gate one submit. Raises CircuitOpen unless admitted; returns
        True when the admitted request is the half-open probe."""
        if self.threshold <= 0 or self.state == "closed":
            return False  # lock-free fast path
        with self._lock:
            if self.state == "closed":
                return False
            now = time.perf_counter()
            if self.state == "open":
                if now - self._opened_at < self.reset_s:
                    raise CircuitOpen(
                        f"circuit open after {self.failures} consecutive "
                        f"dispatch failures; retry after "
                        f"{self.reset_s - (now - self._opened_at):.3f}s")
                self.state = "half_open"
                self._probing = True
                return True
            # half_open: one probe in flight at a time
            if self._probing:
                raise CircuitOpen("circuit half-open: probe in flight")
            self._probing = True
            return True

    def probe_aborted(self):
        """The half-open probe died BEFORE dispatching (cancelled,
        deadline-expired, or a dispatcher crash): release the probe slot
        and return to open with a fresh cooldown; without this, half_open
        wedges with a phantom probe and every submit fails CircuitOpen."""
        if self.threshold <= 0:
            return
        with self._lock:
            if self.state != "half_open" or not self._probing:
                return  # another dispatch already resolved the state
            self._probing = False
            self.state = "open"
            self._opened_at = time.perf_counter()

    def record(self, ok: bool):
        """One dispatch outcome (per coalesced device call, after
        retries: a retried-then-successful dispatch counts as ok)."""
        if self.threshold <= 0:
            return
        with self._lock:
            if ok:
                self.state = "closed"
                self.failures = 0
                self._probing = False
                return
            self.failures += 1
            if self.state == "half_open" or self.failures >= self.threshold:
                if self.state != "open":
                    self.opens_total += 1
                self.state = "open"
                self._opened_at = time.perf_counter()
                self._probing = False


class BatchingPredictor:
    """Request-coalescing micro-batch front of a (bucketed) predictor.

    ``run()`` enqueues the request and blocks on its future; ``submit()``
    returns the future. One dispatcher thread drains the queue: it starts
    a micro-batch at the first request, admits co-requests until
    ``max_batch_size`` rows are gathered or ``batch_timeout_us`` elapses,
    groups the gathered requests by feed signature, concatenates each
    group into ONE padded device call through the wrapped predictor, and
    fans the result rows back to each caller's future (device tensors in
    lazy PaddleTensors). ``shutdown()`` stops admission and drains
    everything already enqueued before returning.

    Resilience (module doc): per-request deadlines, ``max_queue_rows``
    admission control with ``shed_policy``, dispatch retry with capped
    exponential backoff, a consecutive-failure circuit breaker, and a
    supervised dispatcher that fails pending futures loudly and restarts
    if it ever crashes. ``health()`` is the live view of all of it.
    """

    def __init__(self, predictor, max_batch_size: int = 64,
                 batch_timeout_us: int = 2000,
                 max_queue_rows: Optional[int] = 4096,
                 shed_policy: str = "reject-new",
                 default_deadline_ms: Optional[float] = None,
                 dispatch_retries: int = 2,
                 retry_backoff_ms: float = 10.0,
                 breaker_threshold: int = 5,
                 breaker_reset_ms: float = 1000.0):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if shed_policy not in ("reject-new", "drop-oldest"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}; "
                             "use 'reject-new' or 'drop-oldest'")
        if default_deadline_ms is not None and default_deadline_ms <= 0:
            raise ValueError("default_deadline_ms must be positive")
        self._pred = predictor
        self._max_rows = int(max_batch_size)
        self._batch_timeout_us = int(batch_timeout_us)
        self._timeout_s = max(0, int(batch_timeout_us)) * 1e-6
        # None = unbounded; 0 is a VALID fully-closed bound (every submit
        # sheds): don't falsy-coerce it away
        self._max_queue_rows = (int(max_queue_rows)
                                if max_queue_rows is not None else None)
        self._shed_policy = shed_policy
        self._default_deadline_ms = default_deadline_ms
        self._retries = max(0, int(dispatch_retries))
        self._backoff_s = max(0.0, float(retry_backoff_ms)) * 1e-3
        self._backoff_cap_s = 0.1  # exponential backoff cap
        self._breaker = _CircuitBreaker(breaker_threshold,
                                        breaker_reset_ms)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # admission bookkeeping: depth and rows tracked UNDER this lock,
        # so max_queue_rows is enforced atomically and health() never
        # reads a depth racing the dispatcher's drain
        self._adm_lock = threading.Lock()
        self._depth = 0
        self._queued_rows = 0
        # resilience counters (health())
        self._shed_total = 0
        self._expired_total = 0
        self._cancelled_total = 0
        self._retries_total = 0
        self._crashes = 0
        self._stop = threading.Event()
        self._thread_lock = threading.Lock()
        # dispatcher-loop working set, held ON the instance so the crash
        # supervisor can fail requests already popped from the queue (a
        # local carry or group would be stranded: a silent hang)
        self._carry: Optional[_Request] = None
        self._group: List[_Request] = []
        self._start_dispatcher()

    # -- predictor surface ------------------------------------------------
    @property
    def _program(self):
        return self._pred._program

    def get_input_names(self) -> List[str]:
        return self._pred.get_input_names()

    def get_output_names(self) -> List[str]:
        return self._pred.get_output_names()

    def warmup(self, *a, **kw):
        if not hasattr(self._pred, "warmup"):
            raise AttributeError(
                "warmup needs shape bucketing "
                "(AnalysisConfig.enable_shape_bucketing)")
        return self._pred.warmup(*a, **kw)

    def clone(self):
        """New coalescing front (own queue, dispatcher and breaker) over a
        clone of the wrapped predictor: weights and warm plans stay
        shared, like every other predictor's clone()."""
        return BatchingPredictor(
            self._pred.clone(),
            max_batch_size=self._max_rows,
            batch_timeout_us=self._batch_timeout_us,
            max_queue_rows=self._max_queue_rows,
            shed_policy=self._shed_policy,
            default_deadline_ms=self._default_deadline_ms,
            dispatch_retries=self._retries,
            retry_backoff_ms=self._backoff_s * 1e3,
            breaker_threshold=self._breaker.threshold,
            breaker_reset_ms=self._breaker.reset_s * 1e3)

    # -- client side ------------------------------------------------------
    def _admit_locked(self, req: _Request, rows: int, probe: bool,
                      dropped: List[_Request]) -> bool:
        """Admission control under ``_adm_lock``: enqueue ``req`` or shed
        per the policy. Raises Overloaded to shed the newcomer
        (reject-new, or a request that can never fit); returns True when
        drop-oldest emptied the queue and still couldn't fit it (the
        caller raises after resolving ``dropped`` outside the lock)."""
        shed_new = False
        with self._adm_lock:
            if (self._max_queue_rows is not None and not probe
                    and self._queued_rows + rows > self._max_queue_rows):
                if (self._shed_policy == "reject-new"
                        or rows > self._max_queue_rows):
                    # reject-new always sheds the newcomer; drop-oldest
                    # does too when the newcomer can NEVER fit: evicting
                    # the queue for a request rejected anyway would be
                    # pure loss for every queued caller
                    self._shed_total += 1
                    raise Overloaded(
                        f"queue at {self._queued_rows} rows "
                        f"(max_queue_rows={self._max_queue_rows}); "
                        f"request of {rows} rows shed "
                        f"({self._shed_policy})")
                # drop-oldest: shed queued heads until the newcomer fits
                while (self._queued_rows + rows > self._max_queue_rows
                       and self._depth):
                    try:
                        old = self._queue.get_nowait()
                    except queue.Empty:
                        break  # the dispatcher drained it first
                    self._account_locked(-1, -old.rows)
                    self._shed_total += 1
                    dropped.append(old)
                if self._queued_rows + rows > self._max_queue_rows:
                    # even an EMPTY queue can't fit the newcomer (a bound
                    # of 0): the bound is an invariant, so shed it too
                    self._shed_total += 1
                    shed_new = True
            if not shed_new:
                self._account_locked(+1, rows)
                self._queue.put(req)
        return shed_new

    def submit(self, inputs,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; the Future resolves to this caller's
        List[PaddleTensor] (its own rows only). ``deadline_ms`` stamps an
        absolute expiry from NOW (default: the predictor's
        ``default_deadline_ms``): if the request is still queued when it
        expires, it fails with :class:`DeadlineExceeded` before ever
        touching the device. May raise :class:`Overloaded` (queue at
        ``max_queue_rows`` under reject-new) or :class:`CircuitOpen`
        (breaker open) immediately, in the caller. ``future.trace_id`` is
        None: request tracing waits for the port's monitor (ROADMAP
        A10)."""
        if self._stop.is_set():
            raise RuntimeError("BatchingPredictor is shut down")
        feed = _normalize_feed(inputs, self.get_input_names())
        rows = _request_rows(feed)
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        req = _Request(feed, rows,
                       deadline_s=(deadline_ms * 1e-3
                                   if deadline_ms is not None else None))
        return self._submit_request(req)

    def _submit_request(self, req: _Request) -> Future:
        """Admission machinery between a constructed _Request and its
        enqueued future: the circuit-breaker gate, bounded-queue
        shedding, and the shutdown race."""
        rows = req.rows
        req.future.trace_id = None
        req.probe = self._breaker.admit()  # may raise CircuitOpen
        dropped: List[_Request] = []
        shed_new = self._admit_locked(req, rows, req.probe, dropped)
        # futures resolve OUTSIDE the admission lock: set_exception runs
        # done-callbacks inline, and a callback that re-enters the
        # predictor (submit, health) would deadlock on _adm_lock
        for old in dropped:
            self._fail_one(old, lambda: Overloaded(
                "shed while queued (drop-oldest): a newer request "
                f"displaced this one at max_queue_rows="
                f"{self._max_queue_rows}"))
        if shed_new:
            raise Overloaded(
                f"request of {rows} rows cannot fit "
                f"max_queue_rows={self._max_queue_rows} even with the "
                f"queue emptied (drop-oldest)")
        if self._stop.is_set():
            # raced a shutdown: the put may have landed after the
            # dispatcher exited and the shutdown drain finished; fail
            # leftovers (this request included) rather than hang callers
            with self._thread_lock:
                thread = self._thread
            thread.join(timeout=30)
            self._fail_leftovers()
        return req.future

    def run(self, inputs, timeout: Optional[float] = None,
            deadline_ms: Optional[float] = None):
        """Blocking request, the drop-in ``predictor.run`` surface. On
        ``timeout`` the queued request is CANCELLED (tombstoned), so a
        later micro-batch neither computes rows nobody reads nor counts
        them against its coalescing budget."""
        fut = self.submit(inputs, deadline_ms=deadline_ms)
        try:
            return fut.result(timeout=timeout)
        except _FutureTimeout:
            # tombstone: if still queued, the dispatcher drops it at
            # group-build; if dispatch already started, the computed rows
            # are discarded at fan-out (set_running wins the race)
            fut.cancel()
            raise

    def health(self) -> Dict[str, Any]:
        """Live resilience surface: queue occupancy, breaker state,
        dispatcher liveness and restarts, shed/expired/cancelled/retry
        counters, plus the wrapped bucket layer's warmup and degradation
        view when shape bucketing is on."""
        with self._adm_lock:
            depth, rows = self._depth, self._queued_rows
        with self._thread_lock:
            alive = self._thread.is_alive()
        h: Dict[str, Any] = {
            "queue_depth": depth,
            "queued_rows": rows,
            "max_queue_rows": self._max_queue_rows,
            "shed_policy": self._shed_policy,
            "breaker": self._breaker.state,
            "consecutive_failures": self._breaker.failures,
            "breaker_opens": self._breaker.opens_total,
            "dispatcher_alive": alive,
            "dispatcher_restarts": self._crashes,
            "shed": self._shed_total,
            "expired": self._expired_total,
            "cancelled": self._cancelled_total,
            "retries": self._retries_total,
            "shut_down": self._stop.is_set(),
        }
        if hasattr(self._pred, "health"):
            h.update(self._pred.health())
        return h

    def _account_locked(self, ddepth: int, drows: int):
        """Adjust queue depth and rows together; the caller holds
        ``_adm_lock``."""
        self._depth += ddepth
        self._queued_rows += drows

    def _fail_one(self, req: _Request, make_exc):
        if req.probe:
            self._breaker.probe_aborted()
        _safe_resolve(req.future, exc=make_exc())

    def _fail_pending(self, make_exc, inflight: bool = True):
        """Fail every request still queued, plus, when ``inflight`` (the
        dispatcher is known dead: the crash supervisor, or shutdown after
        a completed join), its popped working set (carry and half-built
        group). A LIVE dispatcher owns that set: stealing it from a
        timed-out shutdown would fail work that is still completing. A
        hung caller is worse than an error."""
        if inflight:
            popped, self._carry = ([self._carry] if self._carry
                                   else []), None
            popped += self._group
            self._group = []
            for req in popped:
                self._fail_one(req, make_exc)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            with self._adm_lock:
                self._account_locked(-1, -req.rows)
            self._fail_one(req, make_exc)

    def _fail_leftovers(self):
        with self._thread_lock:
            alive = self._thread.is_alive()
        self._fail_pending(
            lambda: RuntimeError("BatchingPredictor is shut down"),
            inflight=not alive)

    def shutdown(self, timeout: float = 30.0):
        """Stop admitting requests, drain everything already queued, join
        the dispatcher. Idempotent."""
        self._stop.set()
        with self._thread_lock:
            thread = self._thread
        thread.join(timeout=timeout)
        # a submit() racing shutdown can slip a request in after the
        # dispatcher exited: fail it loudly rather than hang its caller
        self._fail_leftovers()

    close = shutdown

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- dispatcher -------------------------------------------------------
    def _start_dispatcher(self):
        with self._thread_lock:
            self._thread = threading.Thread(
                target=self._dispatcher_main, name="serving-dispatcher",
                daemon=True)
            self._thread.start()

    def _dispatcher_main(self):
        """Supervision shell: ``_run_group`` isolates per-batch errors, so
        nothing SHOULD escape ``_dispatch_loop``; but a dispatcher bug (or
        an injected ``serving.dispatcher`` fault) must never strand
        pending futures in a silent hang. Fail them all loudly, then
        restart the loop in a fresh thread."""
        try:
            self._dispatch_loop()
        except BaseException as e:  # noqa: BLE001 -- supervise, never hang
            self._crashes += 1
            warnings.warn(
                f"serving dispatcher crashed ({e!r}); failing pending "
                f"requests and restarting the dispatcher")

            def make_exc(exc=e):
                err = RuntimeError(
                    f"serving dispatcher crashed: {exc!r} (request "
                    f"failed, not lost: resubmit)")
                err.__cause__ = exc  # original traceback for callers
                return err

            self._fail_pending(make_exc)
            if not self._stop.is_set():
                self._start_dispatcher()

    def _take(self, wait: float) -> Optional[_Request]:
        """Pop one request (None on empty) and keep the admission
        bookkeeping consistent at DEQUEUE time too."""
        try:
            req = (self._queue.get(timeout=wait) if wait > 0
                   else self._queue.get_nowait())
        except queue.Empty:
            return None
        with self._adm_lock:
            self._account_locked(-1, -req.rows)
        return req

    def _dispatchable(self, req: _Request) -> bool:
        """Deadline and tombstone gate, applied BEFORE a request joins a
        micro-batch: an expired request fails fast with DeadlineExceeded
        (the device never runs for a caller that gave up), and a
        cancelled one (run(timeout=) fired) is dropped; neither counts
        rows against the coalescing budget."""
        now = time.perf_counter()
        if req.future.cancelled():
            self._cancelled_total += 1
            if req.probe:
                self._breaker.probe_aborted()
            return False
        if req.deadline is not None and now > req.deadline:
            self._expired_total += 1
            _safe_resolve(req.future, exc=DeadlineExceeded(
                f"deadline elapsed {now - req.deadline:.3f}s before "
                f"dispatch (queued {now - req.t_enqueue:.3f}s); the "
                f"request was never dispatched"))
            if req.probe:
                self._breaker.probe_aborted()
            return False
        return True

    def _dispatch_loop(self):
        while True:
            _faults.fire("serving.dispatcher")
            head = self._carry
            self._carry = None
            if head is None:
                head = self._take(0.05)
                if head is None:
                    if self._stop.is_set():
                        return
                    continue
            # popped requests live in self._group/_carry from the moment
            # they leave the queue: a crash anywhere in this loop leaves
            # them visible to the supervisor's _fail_pending
            self._group = [head]
            if not self._dispatchable(head):
                self._group = []
                continue
            rows = head.rows
            # batch_timeout_us bounds the QUEUE-ADDED latency of the head
            # request: the deadline runs from its enqueue, so a waiting
            # burst dispatches at once instead of lingering a full window
            deadline = head.t_enqueue + self._timeout_s
            while rows < self._max_rows:
                if self._stop.is_set():
                    wait = 0.0  # draining: take what's queued, no dawdle
                else:
                    # past the deadline the batch still DRAINS whatever
                    # is already queued; it only stops waiting for more
                    wait = max(0.0, deadline - time.perf_counter())
                nxt = self._take(wait)
                if nxt is None:
                    break
                self._group.append(nxt)
                if not self._dispatchable(nxt):
                    self._group.pop()
                    continue  # expired or cancelled: no coalescing rows
                if rows + nxt.rows > self._max_rows:
                    self._group.pop()
                    self._carry = nxt  # opens the NEXT micro-batch
                    break
                rows += nxt.rows
            self._run_group(self._group)
            self._group = []

    def _dispatch_once(self, feed: Dict[str, np.ndarray]
                       ) -> List[torch.Tensor]:
        """ONE device call attempt; its outputs stay on the device."""
        _faults.fire("serving.dispatch")
        return [t.as_tensor() for t in self._pred.run(feed)]

    def _retry_call(self, fn, no_retry: tuple = ()):
        """Capped-exponential-backoff retry around one dispatch callable.
        Only ``Exception`` retries (KeyboardInterrupt and friends
        propagate at once), as do ``no_retry`` types."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                if isinstance(e, no_retry) or attempt >= self._retries \
                        or self._stop.is_set():
                    raise
                backoff = min(self._backoff_cap_s,
                              self._backoff_s * (2 ** attempt))
                attempt += 1
                self._retries_total += 1
                if backoff:
                    time.sleep(backoff)

    def _dispatch_with_retry(self, feed: Dict[str, np.ndarray]
                             ) -> List[torch.Tensor]:
        return self._retry_call(lambda: self._dispatch_once(feed))

    def _run_group(self, group: List[_Request]):
        from .api import PaddleTensor
        by_sig: Dict[tuple, List[_Request]] = {}
        for r in group:
            by_sig.setdefault(r.sig, []).append(r)
        for rs in by_sig.values():
            try:
                if len(rs) == 1:
                    feed = rs[0].feed
                else:
                    feed = {n: np.concatenate([r.feed[n] for r in rs])
                            for n in rs[0].feed}
                outs = self._dispatch_with_retry(feed)
            except BaseException as e:  # noqa: BLE001 -- fan the error out
                # error isolation: ONLY this signature group's futures see
                # the failure (original traceback intact); co-batched
                # groups and the dispatcher itself keep going
                self._breaker.record(False)
                for r in rs:
                    _safe_resolve(r.future, exc=e)
                continue
            self._breaker.record(True)
            fetch_names = self.get_output_names()
            off = 0
            for r in rs:
                mine = [PaddleTensor(o[off:off + r.rows], n)
                        for n, o in zip(fetch_names, outs)]
                off += r.rows
                # _safe_resolve: a cancelled future (run-timeout tombstone)
                # or a competing shutdown-drain resolution discards these
                # rows without killing the dispatcher
                _safe_resolve(r.future, value=mine)
