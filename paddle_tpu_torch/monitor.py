"""Runtime observability: metrics registry and step telemetry
(counterpart of ``paddle_tpu/monitor.py``).

A process-wide stats registry that answers "why was step N slow?"
(a new plan, fetch blocking, a host op, feed starvation) and, with a
profile session (``profiling/``), attributes the card's time back to
ProgramDesc structure: with the monitor on, the executor runs each op of
an eager run inside ``torch.profiler.record_function("<type>.<out>")``,
the port's counterpart of the JAX package's ``named_scope`` label,
and keeps a labelled kernel table per captured plan for its replays.

Four instrument kinds, Prometheus-shaped:

- ``Counter``    monotonically increasing (plan hits, requests)
- ``Gauge``      last-write-wins (queue depth, device bytes in use)
- ``Timer``      count/sum/min/max of observed seconds, with ``.time()``
- ``Histogram``  a Timer with fixed power-of-two buckets and quantiles

plus per-run **step telemetry**: ``Executor.run`` appends a step record
(wall, capture/execute split, examples/sec, retrace cause) to a ring
buffer; a slow-step detector warns *with a reason* when a step exceeds
``FLAGS.slow_step_factor`` x the trailing median of like steps.

Overhead contract: everything is gated on one module-level bool.
Disabled (the default), every hook is a single attribute load and a
branch. Enable with ``monitor.enable()`` or ``FLAGS_monitor=1``.

Exporters: ``prometheus_text()`` (text exposition format),
``dump_jsonl(path)`` (structured event log), and
``chrome_counter_events(epoch)``, counter tracks that ``profiler``
merges into its chrome trace.

Device truth: ``update_memory_gauges`` and ``device_memory_snapshot``
read ``torch.cuda.memory_stats``; ``peak_flops``, ``peak_membw`` and
``peak_hbm`` give the card's data-sheet peaks (an H100 row only; the
CPU keeps the JAX package's nominal values; an unknown card gives 0 and
a tag naming it). The executor counts a plan's FLOPs once, on its
warm-up run, and gauges ``executor_mfu`` from them.

Live plane: ``serve_http(port)`` (or ``FLAGS.monitor_port``) starts a
stdlib ThreadingHTTPServer on 127.0.0.1 exposing ``/metrics``,
``/healthz`` (aggregated from ``register_health`` callbacks),
``/vars``, ``/trace/<id>`` (or ``/trace?id=``), ``/profile?steps=N``,
``/memory`` and ``/generation``.

Flight recorder: ``flight_record(reason, ...)`` dumps a timestamped
black-box JSONL (last step records, recent events, metric and health
snapshots, the failing request's trace) into ``FLAGS.flight_record_dir``
("" disables), rotated to ``flight_record_max_files`` /
``flight_record_max_mb``.

The JAX monitor's collective half (``record_collective``, the
collective trace windows, ``record_segment_execute``,
``collectives_by_module``, ``peak_ici``) and its cross-rank plane
(``cluster``) need ranks and collectives: ROADMAP A12.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
import warnings
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .utils.flags import FLAGS

__all__ = ["Counter", "Gauge", "Timer", "Histogram", "enable", "disable",
           "enabled", "counter", "gauge", "timer", "histogram", "reset",
           "snapshot", "prometheus_text", "dump_jsonl", "events",
           "record_step", "step_records", "note_compile",
           "update_memory_gauges",
           "chrome_counter_events", "chrome_trace_span_events",
           "bench_summary", "log_event", "percentile",
           "peak_flops", "peak_membw", "record_cost",
           "register_health", "unregister_health", "healthz",
           "register_trace_provider", "unregister_trace_provider",
           "lookup_trace", "profile_session", "last_profile",
           "serve_http", "stop_http", "maybe_serve_http",
           "flight_record", "peak_hbm",
           "device_memory_snapshot", "memory_plane",
           "register_generation_provider",
           "unregister_generation_provider", "generation_plane"]

_lock = threading.RLock()
_enabled = bool(getattr(FLAGS, "monitor", False))

# measured-profiling hook (paddle_tpu/profiling): None when no capture
# window is open, else (session, dispatch_fn). record_step pays ONE
# attribute load + branch when idle; FLAGS_profile_steps auto-arms a
# one-shot window lazily at the first monitored step (-1 = unchecked).
_profile_hook = None
_profile_auto = -1

# slow-step warning dedup: one warning per
# (step-class key, cause), later repeats tallied in
# slow_step_suppressed_total — a persistently slow class must not spam
# one warning per step
_slow_warned: Dict[Tuple[str, str], int] = {}

# (name, labels-items) -> instrument; name -> instrument class (one
# metric name = one type across ALL label sets, or the Prometheus
# exposition would mix sample types under a single # TYPE line)
_registry: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
_kinds: Dict[str, type] = {}

# structured event log (JSONL export) + step-telemetry ring buffer
_events: deque = deque(maxlen=4096)
_steps: deque = deque(maxlen=int(getattr(FLAGS, "monitor_ring", 1024)))

# totals as of the previous record_step call — the slow-step detector
# reasons from PER-STEP deltas, not process-lifetime accumulation (a
# host op hours ago must not blame "host-op fallback" forever)
_last_totals: Dict[str, float] = {"host": 0.0, "starv": 0.0}


def enable():
    """Turn instrumentation on (idempotent). Starts the HTTP plane
    when FLAGS.monitor_port is set."""
    global _enabled
    _enabled = True
    maybe_serve_http()


def disable():
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset():
    """Drop every instrument, event, and step record (fresh window —
    bench.py calls this per rung so each rung's snapshot is its own).
    Re-reads FLAGS_monitor_ring, so runtime flag changes take effect
    at the next window like the other slow-step knobs."""
    global _steps
    with _lock:
        _registry.clear()
        _kinds.clear()
        _events.clear()
        _steps = deque(maxlen=int(getattr(FLAGS, "monitor_ring", 1024)))
        _last_totals.update(host=0.0, starv=0.0)
        _slow_warned.clear()


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n=1):
        with _lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0

    def set(self, v):
        self.value = v  # single store: atomic under the GIL


class Timer:
    """Summary of observed durations (seconds)."""

    __slots__ = ("name", "labels", "count", "total", "min", "max")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, seconds: float):
        with _lock:
            self.count += 1
            self.total += seconds
            if seconds < self.min:
                self.min = seconds
            if seconds > self.max:
                self.max = seconds

    class _Span:
        __slots__ = ("timer", "_t0")

        def __init__(self, timer):
            self.timer = timer
            self._t0 = None

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer.observe(time.perf_counter() - self._t0)
            return False

    def time(self):
        return Timer._Span(self)


# fixed log2 bucket ladder shared by every Histogram: upper bounds
# 2^-20 s (~0.95 µs) .. 2^6 s (64 s), one bucket per power of two,
# plus +Inf. Fixed (not per-instance) so any two histograms — and any
# two PROCESSES — aggregate bucket-by-bucket, the Prometheus contract.
_HIST_MIN_EXP = -20
_HIST_MAX_EXP = 6
_HIST_BOUNDS: Tuple[float, ...] = tuple(
    2.0 ** e for e in range(_HIST_MIN_EXP, _HIST_MAX_EXP + 1))


class Histogram(Timer):
    """Fixed-log2-bucket histogram of observed seconds.

    Extends the Timer summary (count/sum/min/max keep working — every
    ``_value_of``/``_count_of`` consumer and the bench_summary path see
    the same totals) with cumulative power-of-two buckets, Prometheus
    ``_bucket{le=}`` exposition, and p50/p99 estimates in
    ``snapshot()``. Quantile estimates interpolate linearly inside the
    containing bucket and clamp to the observed [min, max], so they are
    never off by more than one power of two."""

    __slots__ = ("buckets",)

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        super().__init__(name, labels)
        self.buckets = [0] * (len(_HIST_BOUNDS) + 1)  # last = +Inf

    def observe(self, seconds: float):
        with _lock:
            Timer.observe(self, seconds)
            self.buckets[bisect.bisect_left(_HIST_BOUNDS, seconds)] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 < q < 1) from the bucket counts."""
        with _lock:
            if not self.count:
                return None
            rank = q * self.count
            cum = 0
            for i, c in enumerate(self.buckets):
                if not c:
                    continue
                prev = cum
                cum += c
                if cum >= rank:
                    lo = _HIST_BOUNDS[i - 1] if i > 0 else 0.0
                    hi = (_HIST_BOUNDS[i] if i < len(_HIST_BOUNDS)
                          else max(self.max, lo))
                    frac = min(1.0, max(0.0, (rank - prev) / c))
                    est = lo + (hi - lo) * frac
                    return min(max(est, self.min), self.max)
            return self.max


def _get(cls, name: str, labels: Optional[Dict[str, Any]] = None):
    key = (name, tuple(sorted((k, str(v))
                              for k, v in (labels or {}).items())))
    inst = _registry.get(key)
    if inst is None:
        with _lock:
            inst = _registry.get(key)
            if inst is None:
                prior = _kinds.get(name)
                if prior is not None and prior is not cls:
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{prior.__name__}, not {cls.__name__}")
                _kinds[name] = cls
                inst = cls(name, key[1])
                _registry[key] = inst
    if type(inst) is not cls:
        # exact type, not isinstance: Histogram subclasses Timer, and
        # timer("x") after histogram("x") must conflict, not alias
        raise TypeError(f"metric {name!r} already registered as "
                        f"{type(inst).__name__}, not {cls.__name__}")
    return inst


def counter(name: str, labels: Optional[Dict[str, Any]] = None) -> Counter:
    return _get(Counter, name, labels)


def gauge(name: str, labels: Optional[Dict[str, Any]] = None) -> Gauge:
    return _get(Gauge, name, labels)


def timer(name: str, labels: Optional[Dict[str, Any]] = None) -> Timer:
    return _get(Timer, name, labels)


def histogram(name: str,
              labels: Optional[Dict[str, Any]] = None) -> Histogram:
    return _get(Histogram, name, labels)


def percentile(values, q: float):
    """Nearest-rank percentile of RAW values (sorted or not) — the one
    quantile helper bench.py and the serving smoke share with the
    Histogram path, so ad-hoc percentile math can't drift."""
    n = len(values)
    if not n:
        return None
    vs = sorted(values)
    return vs[min(n - 1, int(q * n))]


def histogram_stats(name: str,
                    labels: Optional[Dict[str, Any]] = None
                    ) -> Optional[Dict[str, Any]]:
    """{count, p50, p99, min, max} (seconds) of one registered
    Histogram, or None when it does not exist / has no observations —
    the shared read path for the SLO check, the /generation plane, and
    the bench digest, so their quantile math cannot drift."""
    key = (name, tuple(sorted((k, str(v))
                              for k, v in (labels or {}).items())))
    with _lock:
        h = _registry.get(key)
        if not isinstance(h, Histogram) or not h.count:
            return None
        return {"count": h.count,
                "p50": h.quantile(0.5), "p99": h.quantile(0.99),
                "min": h.min, "max": h.max}


def _value_of(name: str) -> float:
    """Sum of a counter/timer-total across all label sets (0 if absent)."""
    out = 0.0
    with _lock:
        for (n, _), inst in _registry.items():
            if n != name:
                continue
            out += inst.total if isinstance(inst, Timer) else inst.value
    return out


def _count_of(name: str) -> int:
    out = 0
    with _lock:
        for (n, _), inst in _registry.items():
            if n == name and isinstance(inst, Timer):
                out += inst.count
    return out


def execute_counts_by_key() -> Dict[str, int]:
    """{seg_key -> segment-run count} from the per-key execute timers.
    The profiling session snapshots this at window open and close: the
    delta is the true number of times each plan segment ran inside a
    capture, which kernel counts cannot say (a segment launches many
    kernels, and a trace may drop some)."""
    out: Dict[str, int] = {}
    with _lock:
        for (n, labels), inst in _registry.items():
            if n == "executor_execute_seconds_by_key" \
                    and isinstance(inst, Timer):
                k = dict(labels).get("key")
                if k:
                    out[k] = out.get(k, 0) + inst.count
    return out


def _by_label(name: str, label_key: str) -> Dict[str, float]:
    """{label value -> counter value / timer total} for one metric,
    e.g. per-pass ops_removed keyed by the 'pass' label."""
    out: Dict[str, float] = {}
    with _lock:
        for (n, labels), inst in _registry.items():
            if n != name:
                continue
            lv = dict(labels).get(label_key)
            if lv is None:
                continue
            v = inst.total if isinstance(inst, Timer) else inst.value
            out[lv] = out.get(lv, 0) + v
    return out


# ---------------------------------------------------------------------------
# Structured events + step telemetry
# ---------------------------------------------------------------------------

def log_event(kind: str, **fields):
    """Append one structured event ({"ev": kind, "t": perf_counter,
    **fields}) to the JSONL log. No-op when disabled."""
    if not _enabled:
        return
    fields["ev"] = kind
    fields["t"] = time.perf_counter()
    _events.append(fields)


def events() -> List[dict]:
    return list(_events)


def note_compile(cause: str, seg_key: str, seconds: float = 0.0):
    """One plan-cache miss: ``cause`` classifies it (first compile /
    new batch size / new feature shape / new program version / new
    steps-per-call K; "new batch size" is the kind the serving layer's
    shape buckets remove), ``seg_key`` names the (program version,
    segment, K, signature) slot, ``seconds`` is the plan's warm-up and
    capture wall when known (the port's counterpart of a compile)."""
    counter("executor_compiles_total", {"cause": cause}).inc()
    if seconds:
        timer("executor_compile_seconds", {"key": seg_key}).observe(seconds)
    log_event("compile", cause=cause, key=seg_key, seconds=seconds)


def record_step(wall: float, compile_s: float = 0.0, execute_s: float = 0.0,
                examples: int = 0, iterations: int = 1,
                retrace: Optional[str] = None,
                fetch_block_s: float = 0.0, key: str = "",
                flops: float = 0.0, peak: float = 0.0):
    """Append one step record and run the slow-step detector.

    Called by Executor.run per call (a fused K-step call is ONE record
    with iterations=K). Warns with a *reason* when `wall` exceeds
    FLAGS_slow_step_factor x the trailing median of previous steps.
    ``key`` identifies the step class (program version + K + batch):
    the trailing-median window only compares LIKE steps, so a training
    loop interleaving a big train program with a small eval program —
    or a serving load mixing bucket shapes — doesn't flag every
    bigger step as slow. A RETRACE that births a brand-new step class
    has no like-step history yet; it is judged against the recent
    steady state across all classes, so the compile cost still
    surfaces with its cause named.

    ``flops`` is the run's FLOP count (counted on each plan's warm-up
    run; 0 = unknown) and ``peak`` the device's peak FLOP/s: when both
    are known the slow-step warning reports achieved-vs-peak, and the
    record carries the achieved MFU. ``cache_hits`` snapshots the
    running plan-cache hit total so the chrome-trace hit track
    has one sample per step, not one flat end-of-run point."""
    if not _enabled:
        return
    rec = {
        "t": time.perf_counter(), "wall": wall,
        "compile_s": compile_s, "execute_s": execute_s,
        "examples": examples, "iterations": iterations,
        "examples_per_sec": (examples / wall) if wall > 0 else 0.0,
        "retrace": retrace, "fetch_block_s": fetch_block_s,
        "key": key,
        # O(1) read of the unlabeled counter — _value_of would walk
        # the whole registry on every step
        "cache_hits": int(counter("executor_cache_hits_total").value),
    }
    if _last_mem_stats:
        # cached memory occupancy (update_memory_gauges fills it on
        # the card; the CPU reports nothing): one sample per step so
        # the chrome-trace memory counter lane has a real timeline
        rec["mem_bytes_in_use"] = sum(
            s.get("bytes_in_use", 0) for s in _last_mem_stats.values())
    if flops and wall > 0:
        rec["achieved_flops_per_sec"] = flops / wall
        if peak:
            rec["mfu"] = flops / wall / peak
    histogram("executor_step_seconds").observe(wall)
    with _lock:
        prev = [r["wall"] for r in _steps if r.get("key") == key]
        prev_any = [r["wall"] for r in _steps]
        _steps.append(rec)
    log_event("step", **{k: v for k, v in rec.items() if k != "t"})
    # measured-profiling window (paddle_tpu/profiling): idle cost is
    # this one branch; FLAGS_profile_steps lazily arms a one-shot
    # capture of the process's first monitored steps
    global _profile_auto
    hook = _profile_hook
    if hook is not None:
        hook[1](hook[0], rec)
    elif _profile_auto:
        if _profile_auto < 0:
            _profile_auto = int(getattr(FLAGS, "profile_steps", 0) or 0)
        if _profile_auto > 0:
            n, _profile_auto = _profile_auto, 0
            from . import profiling
            profiling.autoarm(n)
    # per-step deltas of the cross-thread totals: what happened SINCE
    # the previous step record is what can explain THIS step
    host_now = _value_of("executor_host_op_fallbacks_total")
    starv_now = _value_of("dataloader_starvation_seconds")
    host_delta = max(0.0, host_now - _last_totals["host"])
    starv_delta = max(0.0, starv_now - _last_totals["starv"])
    _last_totals.update(host=host_now, starv=starv_now)
    factor = float(getattr(FLAGS, "slow_step_factor", 3.0))
    window = int(getattr(FLAGS, "slow_step_window", 32))
    prev = prev[-window:]
    if len(prev) < 3 and retrace:
        # no like-step history (the retrace created this step class):
        # the cross-class steady state is the only available baseline
        prev = prev_any[-window:]
    if len(prev) < 3:
        return
    med = sorted(prev)[len(prev) // 2]
    if med > 0 and wall > factor * med:
        if retrace:
            reason = f"retrace: {retrace}"
        elif fetch_block_s > 0.5 * wall:
            reason = "fetch blocking dominated the step"
        elif host_delta:
            reason = "host-op fallback in the block"
        elif starv_delta > 0.5 * wall:
            reason = "feed starvation (prefetch queue ran dry)"
        else:
            reason = "unknown"
        # device truth, not just wall deviation: when the plan's
        # FLOPs are known, say how far from peak this
        # step actually ran. A retrace step's wall is mostly compile —
        # an achieved-FLOP/s over it would be noise, so skip it there
        vs_peak = ""
        if flops and peak and not retrace:
            ach = flops / wall
            vs_peak = (f"; achieved {ach / 1e12:.3f} TFLOP/s = "
                       f"{100 * ach / peak:.1f}% of device peak")
        # once per (step-class key, cause): a persistently slow class
        # warns on its FIRST detection; repeats only tally the
        # suppressed counter (reset() reopens the window)
        with _lock:
            seen = _slow_warned.get((key, reason))
            if seen is None:
                _slow_warned[(key, reason)] = 0
            else:
                _slow_warned[(key, reason)] = seen + 1
        if getattr(FLAGS, "profile_on_slow_step", False):
            # escalation: one rate-limited capture of the
            # NEXT few steps, attached as a slow_step_profile flight
            # record — the capture can't see the step that already
            # passed, but a persistently slow class is still running.
            # Fired on SUPPRESSED repeats too: capture_on_slow_step
            # has its own cooldown + active-session gate, and a first
            # trigger that collided with an open capture must not
            # permanently disable escalation for this step class
            from . import profiling
            profiling.capture_on_slow_step(key, reason)
        if seen is not None:
            counter("slow_step_suppressed_total",
                    {"key": key, "cause": reason}).inc()
            return
        warnings.warn(
            f"slow step: {wall * 1e3:.1f} ms > {factor:g}x trailing "
            f"median {med * 1e3:.1f} ms ({reason}){vs_peak}",
            stacklevel=3)


def step_records() -> List[dict]:
    with _lock:
        return list(_steps)


# ---------------------------------------------------------------------------
# Domain hooks (executor / reader / parallel / device)
# ---------------------------------------------------------------------------

_mem_sample_calls = 0
# last sampled memory stats per device ("cuda:0" -> dict): the cached
# view flight records, step records and /memory read without paying a
# fresh query on a failure path
_last_mem_stats: Dict[str, Dict[str, int]] = {}

# the exported keys (the JAX package's names) and the
# torch.cuda.memory_stats entries they read. largest_free_block_bytes
# has no allocator counterpart: reserved but unallocated bytes stand in
_MEM_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                  "num_allocs", "largest_free_block_bytes")


def _cuda_devices() -> List[int]:
    try:
        import torch
        if torch.cuda.is_available():
            return list(range(torch.cuda.device_count()))
    except Exception:  # noqa: BLE001 — observability must never raise
        pass
    return []


def _cuda_memory_stats(idx: int) -> Dict[str, int]:
    """One device's allocator statistics under the exported names."""
    import torch
    st = torch.cuda.memory_stats(idx)
    if not st:
        return {}
    in_use = int(st.get("allocated_bytes.all.current", 0))
    reserved = int(st.get("reserved_bytes.all.current", 0))
    return {
        "bytes_in_use": in_use,
        "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(idx)
                           .total_memory),
        "num_allocs": int(st.get("allocation.all.current", 0)),
        "largest_free_block_bytes": max(0, reserved - in_use),
    }


def update_memory_gauges(every: int = 16):
    """Sample ``torch.cuda.memory_stats`` into ``device_<key>{device=}``
    gauges (nothing on the CPU, which reports none). Throttled: the
    query runs on the first and every ``every``-th call. Caches the
    snapshot for flight records, step records and the /memory plane."""
    global _mem_sample_calls
    if not _enabled:
        return
    _mem_sample_calls += 1
    if every > 1 and (_mem_sample_calls - 1) % every:
        return
    try:
        for idx in _cuda_devices():
            snap = _cuda_memory_stats(idx)
            if not snap:
                continue
            dev = f"cuda:{idx}"
            for k, v in snap.items():
                gauge(f"device_{k}", {"device": dev}).set(v)
            _last_mem_stats[dev] = snap
    except Exception:  # noqa: BLE001 — observability must never raise
        pass


def device_memory_snapshot(refresh: bool = False) -> Dict[str, Dict[str, int]]:
    """{device -> memory stats} — the cached view from the last
    update_memory_gauges sample (a failure path pays no device query);
    ``refresh=True`` queries live (the /memory route, the oom record)."""
    if refresh:
        try:
            for idx in _cuda_devices():
                snap = _cuda_memory_stats(idx)
                if snap:
                    _last_mem_stats[f"cuda:{idx}"] = snap
        except Exception:  # noqa: BLE001 — cached view still answers
            pass
    return {k: dict(v) for k, v in _last_mem_stats.items()}


def memory_plane() -> Dict[str, Any]:
    """The ``GET /memory`` payload: per-device occupancy and capacity,
    the configured budget, and every plan segment's predicted and
    measured peak (profiling/memory.py's registry)."""
    from .profiling import memory as _mem
    return _mem.memory_plane()


# ---------------------------------------------------------------------------
# Device peaks and cost attribution
# ---------------------------------------------------------------------------

# The card's data-sheet peaks (NVIDIA H100 SXM5 80GB): dense bf16 on the
# tensor cores, TF32 on the tensor cores, fp32 on the CUDA cores, HBM3
# rate and capacity. Matched by substring of torch.cuda.get_device_name.
PEAK_FLOPS_BF16 = {"h100": 989e12}
PEAK_FLOPS_TF32 = {"h100": 495e12}
PEAK_FLOPS_FP32 = {"h100": 67e12}
PEAK_HBM_BYTES = {"h100": 3.35e12}
PEAK_HBM_CAPACITY = {"h100": 80e9}

# the JAX package's nominal CPU figures, so the two can be compared
_CPU_NOMINAL_FLOPS = 1e12
_CPU_NOMINAL_BW = 100e9


def _device_of(dev):
    """(type, name) of a torch device, a device string, a place, or
    None (the current card when there is one)."""
    import torch
    if dev is None:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.cuda.is_available() else torch.device("cpu"))
    dev = getattr(dev, "torch_device", dev)
    dev = torch.device(dev)
    if dev.type != "cuda":
        return dev.type, ""
    return "cuda", torch.cuda.get_device_name(dev.index or 0)


def _lookup(table, dev) -> Tuple[float, str]:
    kind, name = _device_of(dev)
    if kind == "cpu":
        return 0.0, "cpu"
    low = name.lower()
    for key, v in table.items():
        if key in low:
            return v, name
    return 0.0, f"unknown-device({name})"


def peak_flops(dev=None, dtype: str = "bfloat16") -> Tuple[float, str]:
    """(peak FLOP/s, source tag) of a device: the card's dense tensor-
    core bf16 rate by default (``dtype="tf32"`` or ``"float32"`` for the
    others); the CPU's nominal figure; 0 and a tag naming an unknown
    card."""
    if _device_of(dev)[0] == "cpu":
        return _CPU_NOMINAL_FLOPS, "cpu-nominal"
    table = {"tf32": PEAK_FLOPS_TF32, "float32": PEAK_FLOPS_FP32}.get(
        dtype, PEAK_FLOPS_BF16)
    return _lookup(table, dev)


def peak_membw(dev=None) -> Tuple[float, str]:
    """(peak memory bytes/s, source tag) of a device."""
    if _device_of(dev)[0] == "cpu":
        return _CPU_NOMINAL_BW, "cpu-nominal"
    return _lookup(PEAK_HBM_BYTES, dev)


def peak_hbm(dev=None) -> Tuple[float, str]:
    """(memory capacity bytes, source tag) of a device: the pre-flight
    budget's denominator. On the card the runtime's
    ``total_memory`` wins; the data sheet covers a card that cannot be
    asked; the CPU is host RAM (an OOM there is a host OOM)."""
    kind, _name = _device_of(dev)
    if kind == "cpu":
        from .profiling.memory import _host_ram_bytes
        return float(_host_ram_bytes()), "cpu-host-ram"
    try:
        import torch
        d = torch.device(getattr(dev, "torch_device", dev)
                         if dev is not None else "cuda")
        total = torch.cuda.get_device_properties(d.index or 0).total_memory
        if total:
            return float(total), "torch.cuda.get_device_properties"
    except Exception:  # noqa: BLE001 — table fallback below
        pass
    return _lookup(PEAK_HBM_CAPACITY, dev)


def record_cost(seg_key: str, flops: float = 0.0,
                bytes_accessed: float = 0.0,
                memory: Optional[Dict[str, int]] = None,
                peak: float = 0.0, peak_bw: float = 0.0):
    """One plan segment's cost, keyed by the same (program version,
    segment, K, signature) label as its capture and execute timers.
    FLOPs are per call of the segment (a K-step plan counts K steps),
    counted once on its warm-up run (torch.utils.flop_counter, plus the
    hand flash kernels by formula). Gauges:

    - ``executor_cost_flops{key=}`` / ``executor_cost_bytes_accessed``
    - ``executor_arithmetic_intensity{key=}`` (FLOPs/byte)
    - ``executor_roofline_ridge{key=}`` — the device's ridge point
      (peak FLOP/s over peak bytes/s)
    - ``executor_roofline_position{key=}`` — intensity/ridge; > 1 is
      compute-bound territory, < 1 memory-bound
    - ``executor_memory_{temp,argument,output,peak}_bytes{key=}``

    Execute-time MFU (``executor_mfu{key=}``) is set by the executor
    per run, from these FLOPs over the run's wall."""
    if not _enabled:
        return
    lab = {"key": seg_key}
    if flops:
        gauge("executor_cost_flops", lab).set(int(flops))
    if bytes_accessed:
        gauge("executor_cost_bytes_accessed", lab).set(int(bytes_accessed))
    if flops and bytes_accessed:
        ai = flops / bytes_accessed
        gauge("executor_arithmetic_intensity", lab).set(round(ai, 4))
        if peak and peak_bw:
            ridge = peak / peak_bw
            gauge("executor_roofline_ridge", lab).set(round(ridge, 4))
            gauge("executor_roofline_position", lab).set(
                round(ai / ridge, 4))
    for k, v in (memory or {}).items():
        gauge(f"executor_memory_{k}_bytes", lab).set(int(v))
    log_event("cost", key=seg_key, flops=flops,
              bytes_accessed=bytes_accessed, **(memory or {}))


# ---------------------------------------------------------------------------
# Measured profiling: capture windows + request-trace lookup
# ---------------------------------------------------------------------------

def profile_session(steps: Optional[int] = None,
                    trace_dir: Optional[str] = None):
    """Start a measured-profiling capture (profiling/).

    With ``steps=N`` the window auto-closes after N monitored executor
    steps (requires the monitor to be enabled — record_step is the
    step counter); with ``steps=None`` use the returned session as a
    context manager around the code to capture. Either way the close
    reads the torch.profiler trace, joins kernels to ProgramDesc
    structure through the executor's op labels and plan tables,
    publishes
    ``executor_devtime_seconds{op=}`` / ``executor_mfu_measured{key=}``
    / ``profile_attribution_coverage``, and leaves the report on
    ``session.result`` (also ``monitor.last_profile()``, and
    ``device_profile.json`` inside the capture dir)."""
    from . import profiling
    return profiling.start_session(steps=steps, trace_dir=trace_dir)


def last_profile():
    """Report dict of the most recent completed capture (or None)."""
    from . import profiling
    return profiling.last_profile()


def _set_profile_hook(sess):
    """Bind record_step's one-branch dispatch to an open session."""
    global _profile_hook
    from . import profiling
    _profile_hook = (sess, profiling.on_step)


def _clear_profile_hook(sess):
    global _profile_hook
    if _profile_hook is not None and _profile_hook[0] is sess:
        _profile_hook = None


# request-trace providers: the live plane's /trace/<id> route asks
# each registered provider (BatchingPredictor.trace, WeakMethod-held
# like the health callbacks) until one knows the id. Shares the
# health registry's weak-callback machinery (_WeakRegistry below).


def register_trace_provider(name: str, fn: Callable[[str], Any]):
    """Register ``fn(trace_id) -> dict | None`` for /trace lookups."""
    _trace_providers.register(name, fn)


def unregister_trace_provider(name: str):
    _trace_providers.unregister(name)


def lookup_trace(trace_id: str) -> Optional[dict]:
    """First provider's answer for ``trace_id`` (None = unknown or
    evicted everywhere). Dead providers are swept as in healthz."""
    for _name, fn in _trace_providers.live():
        try:
            rec = fn(trace_id)
        except Exception:  # noqa: BLE001 — lookup must not raise
            rec = None
        if rec is not None:
            return rec
    return None


# generation live plane: each GenerationPredictor registers
# its slot-table/page-pool/timeline provider; GET /generation merges
# them with the GLOBAL token-latency percentiles and the goodput ledger
# (one process can host several predictors but the histograms are
# process-wide).


def register_generation_provider(name: str, fn: Callable[[], dict]):
    """Register ``fn() -> dict`` (a predictor's generation_plane) for
    the /generation route."""
    _generation_providers.register(name, fn)


def unregister_generation_provider(name: str):
    _generation_providers.unregister(name)


def generation_plane() -> Dict[str, Any]:
    """The /generation payload: per-predictor slot tables + timelines,
    TTFT/TPOT/ITL percentiles, the goodput-vs-wasted token ledger, and
    the configured SLO budgets with the violations counted so far."""
    preds: Dict[str, Any] = {}
    for name, fn in _generation_providers.live():
        try:
            preds[name] = fn()
        except Exception as e:  # noqa: BLE001 — plane must not raise
            preds[name] = {"error": repr(e)}
    latency: Dict[str, Any] = {}
    for short, hname in (("ttft", "generation_ttft_seconds"),
                         ("tpot", "generation_tpot_seconds"),
                         ("itl", "generation_itl_seconds")):
        q = histogram_stats(hname)
        latency[short] = None if q is None else {
            "count": q["count"],
            "p50_ms": round(q["p50"] * 1e3, 3),
            "p99_ms": round(q["p99"] * 1e3, 3),
            "max_ms": round(q["max"] * 1e3, 3)}
    good = _value_of("generation_goodput_tokens_total")
    wasted = _value_of("generation_wasted_tokens_total")
    out: Dict[str, Any] = {
        "predictors": preds,
        "latency": latency,
        "goodput": {
            "tokens": int(good), "wasted_tokens": int(wasted),
            "fraction": (round(good / (good + wasted), 4)
                         if good + wasted else None),
            "wasted_by_reason": {
                k: int(v) for k, v in _by_label(
                    "generation_wasted_tokens_total", "reason").items()},
            "verdicts": {k: int(v) for k, v in _by_label(
                "generation_deadline_verdicts_total",
                "verdict").items()}},
        "slo": {
            "ttft_budget_ms": float(FLAGS.generation_slo_ttft_ms),
            "itl_budget_ms": float(FLAGS.generation_slo_itl_ms),
            "violations": {k: int(v) for k, v in _by_label(
                "generation_slo_violations_total", "metric").items()}},
    }
    return out


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, double quote,
    and newline must be escaped or a feed-signature/op-name label value
    corrupts the whole exposition."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in labels)
    return "{" + inner + "}"


def snapshot() -> Dict[str, Any]:
    """Plain-dict view of every instrument: {"name{labels}": value} for
    counters/gauges, {"name{labels}": {count,sum,min,max}} for timers."""
    out: Dict[str, Any] = {}
    with _lock:
        for (name, labels), inst in sorted(_registry.items()):
            key = name + _label_str(labels)
            if isinstance(inst, Timer):
                out[key] = {"count": inst.count, "sum": inst.total,
                            "min": (None if inst.count == 0 else inst.min),
                            "max": inst.max}
                if isinstance(inst, Histogram):
                    out[key]["p50"] = inst.quantile(0.50)
                    out[key]["p99"] = inst.quantile(0.99)
            else:
                out[key] = inst.value
    return out


def prometheus_text() -> str:
    """Prometheus text exposition format. Counters get _total names as
    registered; timers export as summaries (_count/_sum/_min/_max)."""
    lines: List[str] = []
    seen_type = set()
    with _lock:
        items = sorted(_registry.items())
    for (name, labels), inst in items:
        ls = _label_str(labels)
        if isinstance(inst, Counter):
            if name not in seen_type:
                lines.append(f"# TYPE {name} counter")
                seen_type.add(name)
            lines.append(f"{name}{ls} {inst.value}")
        elif isinstance(inst, Gauge):
            if name not in seen_type:
                lines.append(f"# TYPE {name} gauge")
                seen_type.add(name)
            lines.append(f"{name}{ls} {inst.value}")
        elif isinstance(inst, Histogram):
            if name not in seen_type:
                lines.append(f"# TYPE {name} histogram")
                seen_type.add(name)
            cum = 0
            for i, c in enumerate(inst.buckets):
                cum += c
                le = ("+Inf" if i == len(_HIST_BOUNDS)
                      else f"{_HIST_BOUNDS[i]:.9g}")
                lle = _label_str(labels + (("le", le),))
                lines.append(f"{name}_bucket{lle} {cum}")
            lines.append(f"{name}_sum{ls} {inst.total:.9g}")
            lines.append(f"{name}_count{ls} {inst.count}")
        else:
            if name not in seen_type:
                lines.append(f"# TYPE {name} summary")
                seen_type.add(name)
            lines.append(f"{name}_count{ls} {inst.count}")
            lines.append(f"{name}_sum{ls} {inst.total:.9g}")
            if inst.count:
                lines.append(f"{name}_min{ls} {inst.min:.9g}")
                lines.append(f"{name}_max{ls} {inst.max:.9g}")
    return "\n".join(lines) + ("\n" if lines else "")


def dump_jsonl(path: str) -> int:
    """Write the structured event log (+ one trailing snapshot line) as
    JSONL; returns the number of lines written. A leading meta line
    carries the profiler's epoch (when one ran), so scripts/timeline.py
    can rebase the telemetry onto the same time axis as the span
    trace."""
    evs = list(_events)
    meta: Dict[str, Any] = {"ev": "meta", "t": time.perf_counter()}
    try:
        from . import profiler as _prof
        if getattr(_prof, "_epoch", 0.0):
            meta["profiler_epoch"] = _prof._epoch
    except Exception:  # noqa: BLE001 — observability must never raise
        pass
    lines = [json.dumps(meta)] + [json.dumps(e) for e in evs]
    lines.append(json.dumps({"ev": "snapshot", "t": time.perf_counter(),
                             "metrics": snapshot()}))
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    except OSError:
        return 0
    return len(lines)


def chrome_counter_events(epoch: float) -> List[dict]:
    """"ph":"C" counter tracks for the chrome trace (profiler merges
    these into its span dump; scripts/timeline.py renders them as
    per-process counter rows). One sample per step record, timestamped
    on the profiler's epoch, plus cumulative cache-hit/miss samples —
    the hit track samples PER STEP (each record snapshots the running
    hit total), so hit growth is visible alongside the compile track
    instead of one flat end-of-run point."""
    out: List[dict] = []
    misses = 0
    last_hits = None
    for rec in step_records():
        ts = (rec["t"] - epoch) * 1e6
        if ts < 0:
            continue  # record predates this profiler epoch
        out.append({"name": "examples_per_sec", "ph": "C", "pid": 0,
                    "ts": ts,
                    "args": {"examples_per_sec":
                             round(rec["examples_per_sec"], 2)}})
        out.append({"name": "step_ms", "ph": "C", "pid": 0, "ts": ts,
                    "args": {"wall": round(rec["wall"] * 1e3, 3),
                             "compile": round(rec["compile_s"] * 1e3, 3),
                             "execute": round(rec["execute_s"] * 1e3, 3)}})
        hits = rec.get("cache_hits")
        if hits is not None:
            last_hits = hits
            out.append({"name": "executable_cache_hits", "ph": "C",
                        "pid": 0, "ts": ts, "args": {"hits": hits}})
        mem = rec.get("mem_bytes_in_use")
        if mem:
            # memory counter lane: HBM occupancy next to
            # the step/compile tracks in the same chrome trace
            out.append({"name": "device_bytes_in_use", "ph": "C",
                        "pid": 0, "ts": ts,
                        "args": {"bytes_in_use": mem}})
    for e in events():
        if e.get("ev") != "compile":
            continue
        ts = (e["t"] - epoch) * 1e6
        if ts < 0:
            continue
        misses += 1
        out.append({"name": "executable_cache", "ph": "C", "pid": 0,
                    "ts": ts, "args": {"compiles": misses}})
    hits_now = _value_of("executor_cache_hits_total")
    if hits_now and hits_now != last_hits:
        # hits that accrued after the last step record still close the
        # track at the true final value
        out.append({"name": "executable_cache_hits", "ph": "C", "pid": 0,
                    "ts": (time.perf_counter() - epoch) * 1e6,
                    "args": {"hits": hits_now}})
    return out


def _trace_records_to_chrome(records: List[dict],
                             epoch: float) -> List[dict]:
    """Serving request-trace records → chrome-trace events: one "ph":"X"
    span per trace span on its REAL recording thread's tid, plus a flow
    arrow ("ph":"s"/"f", id = trace id) stitching the caller-side
    enqueue spans to the dispatcher-side dispatch spans, so one request
    reads as one connected chain across threads in Perfetto."""
    out: List[dict] = []
    for rec in records:
        spans = sorted(rec.get("spans") or [],
                       key=lambda s: s.get("t0", 0.0))
        tid0 = None
        fid = abs(hash(rec.get("trace_id"))) % (1 << 31)
        flowed = False
        for s in spans:
            ts = (s.get("t0", 0.0) - epoch) * 1e6
            if ts < 0:
                continue
            tid = s.get("tid", 0)
            args = {k: v for k, v in s.items()
                    if k not in ("name", "t0", "t1", "tid", "thread")}
            args["trace_id"] = rec.get("trace_id")
            out.append({"name": f"req:{s['name']}", "cat": "serving",
                        "ph": "X", "pid": 0, "tid": tid, "ts": ts,
                        "dur": (s.get("t1", s["t0"]) - s["t0"]) * 1e6,
                        "args": args})
            if tid0 is None:
                tid0 = tid
            elif tid != tid0 and not flowed:
                # first thread hop (caller -> dispatcher): emit the
                # flow arrow pair
                flowed = True
                out.append({"name": "request", "cat": "serving",
                            "ph": "s", "id": fid, "pid": 0, "tid": tid0,
                            "ts": max(0.0, (spans[0].get("t1", 0.0)
                                            - epoch) * 1e6)})
                out.append({"name": "request", "cat": "serving",
                            "ph": "f", "bp": "e", "id": fid, "pid": 0,
                            "tid": tid, "ts": ts})
    return out


def chrome_trace_span_events(epoch: float) -> List[dict]:
    """Request-trace spans from the event log ("trace" events the
    serving layer emits per completed request) as chrome events — the
    profiler merges these into its chrome dump next to the counter
    tracks, and scripts/timeline.py renders the same shape from
    JSONL."""
    recs = [e for e in events() if e.get("ev") == "trace"]
    return _trace_records_to_chrome(recs, epoch)


# ---------------------------------------------------------------------------
# Live plane: health registry + /metrics HTTP server
# ---------------------------------------------------------------------------

class _WeakRegistry:
    """Name -> weakly-held callback. Bound methods ride a WeakMethod
    (a dropped predictor unregisters itself by dying — registration
    never keeps a serving stack alive); plain functions are held
    directly. One implementation for the health callbacks AND the
    /trace providers, so the dead-entry sweep can't drift between
    them."""

    __slots__ = ("_cbs",)

    def __init__(self):
        self._cbs: Dict[str, Any] = {}

    def register(self, name: str, fn):
        try:
            ref: Any = weakref.WeakMethod(fn)
        except TypeError:
            ref = (lambda f=fn: f)  # plain function: hold directly
        with _lock:
            self._cbs[name] = ref

    def unregister(self, name: str):
        with _lock:
            self._cbs.pop(name, None)

    def live(self) -> List[Tuple[str, Any]]:
        """[(name, callback)] for the live entries; entries whose
        referent died are swept (double-checked under the lock — a
        concurrent re-registration under the same name survives)."""
        with _lock:
            items = list(self._cbs.items())
        out: List[Tuple[str, Any]] = []
        dead = []
        for name, ref in items:
            fn = ref()
            if fn is None:
                dead.append(name)
            else:
                out.append((name, fn))
        if dead:
            with _lock:
                for name in dead:
                    if self._cbs.get(name) is not None \
                            and self._cbs[name]() is None:
                        self._cbs.pop(name, None)
        return out


_health_cbs = _WeakRegistry()
_trace_providers = _WeakRegistry()
_generation_providers = _WeakRegistry()


def register_health(name: str, fn: Callable[[], dict]):
    """Register a health() callback under `name` for the /healthz
    aggregate."""
    _health_cbs.register(name, fn)


def unregister_health(name: str):
    _health_cbs.unregister(name)


def _component_healthy(h: Any) -> bool:
    """Conservative health heuristic over a component's health() dict:
    an explicit "healthy" wins; else an open breaker, a dead
    dispatcher, or a shut-down predictor reads unhealthy."""
    if not isinstance(h, dict):
        return True
    if h.get("healthy") is not None:
        return bool(h["healthy"])
    if h.get("breaker") == "open":
        return False
    if h.get("dispatcher_alive") is False:
        return False
    if h.get("shut_down"):
        return False
    return True


def healthz() -> Dict[str, Any]:
    """Aggregated health: every registered callback's dict plus an
    overall status ("ok" iff every component reads healthy)."""
    comps: Dict[str, Any] = {}
    ok = True
    for name, fn in _health_cbs.live():
        try:
            h = fn()
        except Exception as e:  # noqa: BLE001 — health must not raise
            h = {"healthy": False, "error": repr(e)}
        comps[name] = h
        ok = ok and _component_healthy(h)
    return {"status": "ok" if ok else "degraded", "components": comps}


_http_server = None
_http_thread = None


def serve_http(port: Optional[int] = None, host: str = "127.0.0.1"):
    """Start the live observability plane: a stdlib ThreadingHTTPServer
    (daemon thread) exposing

    - ``/metrics``  Prometheus text exposition (prometheus_text())
    - ``/healthz``  aggregated register_health callbacks (HTTP 200
      when every component is healthy, 503 otherwise)
    - ``/vars``     the full snapshot() as JSON

    ``port`` defaults to ``FLAGS_monitor_port`` (0 picks an ephemeral
    port — tests). Binds loopback by default — the plane is
    unauthenticated, so exposing it beyond the host (``host="0.0.0.0"``
    for a scrape sidecar) is an explicit opt-in.
    Idempotent: a running server is returned as-is; the
    bound port rides in the ``monitor_http_port`` gauge. Returns the
    server (``.server_port``); ``stop_http()`` tears it down."""
    global _http_server, _http_thread
    if _http_server is not None:
        return _http_server
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: str, ctype: str):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            path, _, query = self.path.partition("?")
            try:
                if path == "/metrics":
                    self._send(200, prometheus_text(),
                               "text/plain; version=0.0.4")
                elif path == "/healthz":
                    h = healthz()
                    self._send(200 if h["status"] == "ok" else 503,
                               json.dumps(h), "application/json")
                elif path == "/vars":
                    self._send(200, json.dumps(snapshot()),
                               "application/json")
                elif path.startswith("/trace"):
                    # live request debugging without in-process access:
                    # predictor.trace(trace_id) over the plane, as
                    # /trace/<id> or /trace?id=<id>
                    from urllib.parse import parse_qs
                    tid = (path[len("/trace/"):]
                           if path.startswith("/trace/")
                           else parse_qs(query).get("id", [""])[0])
                    rec = lookup_trace(tid)
                    if rec is None:
                        self._send(404, json.dumps(
                            {"error": "unknown or evicted trace id"}),
                            "application/json")
                    else:
                        self._send(200, json.dumps(rec),
                                   "application/json")
                elif path == "/profile":
                    self._profile(query)
                elif path == "/memory":
                    # the memory plane: per-device
                    # occupancy + capacity + budget headroom, and
                    # every executable's predicted/measured peak
                    # (memory_plane refreshes the stats sample itself)
                    self._send(200, json.dumps(memory_plane()),
                               "application/json")
                elif path == "/generation":
                    # the generation live plane: slot
                    # occupancy + timeline per predictor, TTFT/TPOT/
                    # ITL percentiles, goodput ledger, SLO budgets
                    self._send(200, json.dumps(generation_plane()),
                               "application/json")
                else:
                    self._send(404, "not found: try /metrics /healthz "
                               "/vars /trace/<id> /profile?steps=N "
                               "/memory /generation\n",
                               "text/plain")
            except Exception as e:  # noqa: BLE001 — keep serving
                try:
                    self._send(500, repr(e), "text/plain")
                except OSError:
                    pass

        def _profile(self, query: str):
            """Capture-and-download: arm an N-step measured-profiling
            window on the running process, wait for the step loop to
            fill it (bounded by ``timeout_s``, default 30), and return
            the attributed report as JSON. 409 when a capture is
            already running; a window the step loop never fills is
            closed at the timeout and reports whatever was captured."""
            from urllib.parse import parse_qs

            from . import profiling

            q = parse_qs(query)
            try:
                steps = int(q.get("steps", ["3"])[0])
                timeout = float(q.get("timeout_s", ["30"])[0])
            except ValueError:
                self._send(400, json.dumps(
                    {"error": "steps/timeout_s must be numeric"}),
                    "application/json")
                return
            if not _enabled:
                self._send(503, json.dumps(
                    {"error": "monitor disabled — /profile counts "
                              "steps through record_step"}),
                    "application/json")
                return
            try:
                sess = profiling.start_session(steps=max(1, steps))
            except RuntimeError as e:
                self._send(409, json.dumps({"error": str(e)}),
                           "application/json")
                return
            sess.wait(timeout)
            rep = sess.finish()  # idempotent: no-op when step-closed
            self._send(200, json.dumps(rep), "application/json")

        def log_message(self, *a):  # silence per-request stderr lines
            pass

    if port is None:
        port = int(getattr(FLAGS, "monitor_port", 0))
    srv = ThreadingHTTPServer((host, int(port)), _Handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever,
                         name="monitor-http", daemon=True)
    t.start()
    _http_server, _http_thread = srv, t
    gauge("monitor_http_port").set(srv.server_port)
    log_event("monitor_http", port=srv.server_port)
    return srv


def stop_http():
    global _http_server, _http_thread
    srv = _http_server
    _http_server = _http_thread = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()


def maybe_serve_http():
    """Start the HTTP plane iff FLAGS_monitor_port is set and no server
    runs yet — the hook enable() and create_paddle_predictor call."""
    if _http_server is None and int(getattr(FLAGS, "monitor_port", 0)):
        try:
            serve_http()
        except OSError as e:
            warnings.warn(f"monitor: could not bind FLAGS_monitor_port="
                          f"{FLAGS.monitor_port}: {e!r}")


# ---------------------------------------------------------------------------
# Flight recorder: black-box dump on typed failures
# ---------------------------------------------------------------------------

_flight_last: Dict[str, float] = {}


def flight_record(reason: str, trace: Optional[dict] = None,
                  extra: Optional[Dict[str, Any]] = None,
                  directory: Optional[str] = None) -> Optional[str]:
    """Dump a timestamped black-box JSONL for a typed failure: a meta
    line (reason + extra — the NaN check passes the failing program
    version, serving passes the failing trace id), the last 64 step
    records, the last 256 events, the metric snapshot, the aggregated
    health view, and the failing request's trace when given.

    Target dir: ``directory`` or ``FLAGS_flight_record_dir`` ("" =
    disabled, the default — production opts in). Rate-limited to one
    dump per reason per second so a failure storm cannot grind the
    process into disk I/O. Returns the written path, or None.

    Every record is stamped with an ``incident_id`` (reused from
    ``extra`` when the caller propagates one)."""
    directory = directory or str(getattr(FLAGS, "flight_record_dir", ""))
    if not directory:
        return None
    now = time.time()
    with _lock:
        if now - _flight_last.get(reason, 0.0) < 1.0:
            return None
        _flight_last[reason] = now
    incident = (extra or {}).get("incident_id")
    if not incident:
        import uuid
        incident = (f"inc-{time.strftime('%Y%m%dT%H%M%S', time.gmtime(now))}"
                    f"-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    meta: Dict[str, Any] = {
        "ev": "flight_meta", "reason": reason, "ts": now,
        "iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now)),
        "pid": os.getpid(), "t": time.perf_counter(),
        "incident_id": incident,
    }
    if extra:
        meta.update(extra)  # extra's incident_id (if any) == incident
    if trace is not None and trace.get("trace_id"):
        meta.setdefault("trace_id", trace.get("trace_id"))
    mem_snap = device_memory_snapshot()
    if mem_snap:
        # every black box carries the per-device memory state: the
        # cached sample, no device query on a failure
        # path unless the caller already refreshed (the oom dump does)
        meta.setdefault("memory", mem_snap)
    lines = [json.dumps(meta)]
    for rec in step_records()[-64:]:
        lines.append(json.dumps({"ev": "step_record", **rec}))
    for e in list(_events)[-256:]:
        try:
            lines.append(json.dumps(e))
        except (TypeError, ValueError):
            continue  # a non-serializable custom event must not abort
    lines.append(json.dumps({"ev": "snapshot", "metrics": snapshot()}))
    try:
        lines.append(json.dumps({"ev": "health", **healthz()}))
    except Exception:  # noqa: BLE001 — the dump is best-effort
        pass
    if trace is not None:
        lines.append(json.dumps({"ev": "trace", **trace}))
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
    safe = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in reason)[:40]
    path = os.path.join(directory, f"flightrec-{stamp}-{safe}.jsonl")
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    except OSError:
        return None
    if _enabled:
        counter("flight_records_total", {"reason": reason}).inc()
    _rotate_flight_dir(directory, keep=path)
    warnings.warn(f"flight recorder: dumped {reason!r} black box to "
                  f"{path}")
    return path


def _rotate_flight_dir(directory: str, keep: str = ""):
    """Bound the flight-record directory: a
    long-lived process under a failure storm must not grow it without
    limit. Oldest-first eviction down to FLAGS_flight_record_max_files
    dumps / FLAGS_flight_record_max_mb total (0 disables either cap);
    the just-written record is never the victim. Evictions count in
    ``flight_records_evicted_total``."""
    max_files = int(getattr(FLAGS, "flight_record_max_files", 64))
    max_mb = float(getattr(FLAGS, "flight_record_max_mb", 256.0))
    if max_files <= 0 and max_mb <= 0:
        return
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("flightrec-") and n.endswith(".jsonl")]
        entries = []
        for n in names:
            p = os.path.join(directory, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, p, st.st_size))
        entries.sort()  # oldest first
        total = sum(e[2] for e in entries)
        evicted = 0
        keep_abs = os.path.abspath(keep) if keep else ""
        for mtime, p, size in entries:
            over_count = max_files > 0 and len(entries) - evicted > max_files
            over_bytes = max_mb > 0 and total > max_mb * 1e6
            if not (over_count or over_bytes):
                break
            if os.path.abspath(p) == keep_abs:
                continue
            try:
                os.remove(p)
            except OSError:
                continue
            evicted += 1
            total -= size
        if evicted and _enabled:
            counter("flight_records_evicted_total").inc(evicted)
    except OSError:
        pass


def bench_summary() -> Dict[str, Any]:
    """Compact registry digest for bench.py's BENCH JSON: why a rung
    got faster or slower, not just that it did."""
    hits = _value_of("executor_cache_hits_total")
    misses = _value_of("executor_cache_misses_total")
    lookups = hits + misses
    out = {
        "compiles": int(misses),
        "compile_seconds": round(_value_of("executor_compile_seconds"), 3),
        "execute_seconds": round(_value_of("executor_execute_seconds"), 3),
        "cache_hits": int(hits),
        "cache_hit_rate": (round(hits / lookups, 4) if lookups else None),
        "fetch_block_seconds": round(
            _value_of("executor_fetch_seconds"), 3),
        "host_op_fallbacks": int(
            _value_of("executor_host_op_fallbacks_total")),
    }
    # capture digest: the seconds a plan's first replay waited for
    # its capture (the port's counterpart of the compile breakdown)
    cap_s = _value_of("executor_capture_seconds")
    if cap_s:
        out["capture_seconds"] = round(cap_s, 3)
    # cost-attribution digest: the BIGGEST plan segment's cost
    # profile — its FLOPs and the live execute-wall MFU.
    # "Biggest by FLOPs" picks the train/serving main executable over
    # warmup/eval side programs without needing the caller to name it.
    flops_by_key = _by_label("executor_cost_flops", "key")
    if flops_by_key:
        k = max(flops_by_key, key=lambda kk: flops_by_key[kk])
        bytes_by = _by_label("executor_cost_bytes_accessed", "key")
        mfu_by = _by_label("executor_mfu", "key")
        ai_by = _by_label("executor_arithmetic_intensity", "key")
        cost: Dict[str, Any] = {
            "key": k,
            "flops": int(flops_by_key[k]),
        }
        if bytes_by.get(k):
            cost["bytes_accessed"] = int(bytes_by[k])
        if ai_by.get(k):
            cost["arithmetic_intensity"] = round(ai_by[k], 3)
        if mfu_by.get(k):
            cost["mfu_from_cost_analysis"] = round(mfu_by[k], 9)
        out["cost"] = cost
    # memory digest: the biggest executable's predicted
    # peak footprint vs the allocator's measured peak, their agreement,
    # and the budget headroom — the numbers bench.py journals as
    # ``extra.memory``
    pred_by = _by_label("executor_mem_predicted_peak_bytes", "key")
    if pred_by:
        k = max(pred_by, key=lambda kk: pred_by[kk])
        meas_by = _by_label("executor_mem_measured_peak_bytes", "key")
        ag_by = _by_label("executor_mem_agreement", "key")
        head_by = _by_label("executor_mem_headroom_frac", "key")
        mem_d: Dict[str, Any] = {
            "key": k, "predicted_peak_bytes": int(pred_by[k])}
        if meas_by.get(k):
            mem_d["measured_peak_bytes"] = int(meas_by[k])
        if ag_by.get(k):
            mem_d["agreement"] = round(ag_by[k], 4)
        if k in head_by:
            mem_d["headroom_frac"] = round(head_by[k], 6)
        import sys
        _pm = sys.modules.get(__package__ + ".profiling.memory")
        if _pm is not None:
            for d in _pm.footprints().values():
                if d["seg_key"] == k and d["top_vars"]:
                    mem_d["top_var"] = d["top_vars"][0]["name"]
                    mem_d["peak_op_type"] = d["peak_op_type"]
                    break
        out["memory"] = mem_d
    # step-wall histogram quantiles (the Histogram migration): the
    # p50/p99 a dashboards row wants without raw step records
    with _lock:
        step_h = _registry.get(("executor_step_seconds", ()))
    if isinstance(step_h, Histogram) and step_h.count:
        out["step_ms"] = {
            "p50": round((step_h.quantile(0.50) or 0) * 1e3, 3),
            "p99": round((step_h.quantile(0.99) or 0) * 1e3, 3),
        }
    removed = _value_of("ir_pass_ops_removed_total")
    pass_s = _value_of("ir_pass_seconds")
    if removed or pass_s:
        out["passes"] = {
            "ops_removed": int(removed),
            "pass_ms": round(pass_s * 1e3, 2),
            "ops_removed_by_pass": {
                k: int(v) for k, v in sorted(_by_label(
                    "ir_pass_ops_removed_total", "pass").items())},
        }
    starv = _value_of("dataloader_starvation_seconds")
    if starv:
        out["feed_starvation_seconds"] = round(starv, 3)
    # checkpoint digest: what elasticity cost this window —
    # save wall (sync vs async writer), the stall the STEP LOOP
    # actually paid, and bytes shipped; failure/unmarked counters only
    # when they moved
    saves = _value_of("checkpoint_saves_total")
    if saves:
        ck: Dict[str, Any] = {
            "saves": int(saves),
            "save_seconds": round(_value_of("checkpoint_save_seconds"), 3),
            "stall_seconds": round(
                _value_of("checkpoint_stall_seconds"), 3),
            "last_bytes": int(_value_of("checkpoint_bytes")),
        }
        by_path = _by_label("checkpoint_save_seconds", "path")
        if by_path:
            ck["save_seconds_by_path"] = {
                k: round(v, 3) for k, v in sorted(by_path.items())}
        for k, metric in (("failures", "checkpoint_failures_total"),
                          ("unmarked", "checkpoint_unmarked_total"),
                          ("preemptions", "elastic_preemptions_total"),
                          ("restores", "elastic_restores_total")):
            v = _value_of(metric)
            if v:
                ck[k] = int(v)
        out["checkpoint"] = ck
    reqs = _value_of("serving_requests_total")
    rows = _value_of("serving_request_rows_total")
    if reqs or rows:
        # serving digest (inference/serving.py): how well the bucket
        # ladder + coalescer amortized the round's request load. The
        # coalescer keys (requests/batches/queue) only appear when a
        # BatchingPredictor actually ran — a bucketing-only setup must
        # not read as "0 requests served"
        hits = _value_of("serving_bucket_hits_total")
        miss = _value_of("serving_bucket_misses_total")
        padded = _value_of("serving_padded_rows_total")
        srv: Dict[str, Any] = {
            "bucket_hits": int(hits),
            "bucket_misses": int(miss),
            "pad_waste_fraction": (
                round(padded / (rows + padded), 4)
                if (rows + padded) else None),
        }
        if reqs:
            batches = _value_of("serving_batches_total")
            srv["requests"] = int(reqs)
            srv["batches"] = int(batches)
            srv["queue_seconds"] = round(
                _value_of("serving_time_in_queue_seconds"), 3)
            with _lock:
                q_h = _registry.get(("serving_time_in_queue_seconds",
                                     ()))
            if isinstance(q_h, Histogram) and q_h.count:
                srv["queue_p50_ms"] = round(
                    (q_h.quantile(0.50) or 0) * 1e3, 3)
                srv["queue_p99_ms"] = round(
                    (q_h.quantile(0.99) or 0) * 1e3, 3)
            if batches:
                srv["mean_rows_per_batch"] = round(
                    _value_of("serving_coalesced_rows") / batches, 2)
        # resilience digest (serving.py): only the counters
        # that actually moved — a fault-free run keeps the digest clean
        for k, metric in (("shed", "serving_shed_total"),
                          ("expired", "serving_expired_total"),
                          ("cancelled", "serving_cancelled_total"),
                          ("retries", "serving_retries_total"),
                          ("breaker_opens", "serving_breaker_opens_total"),
                          ("dispatcher_restarts",
                           "serving_dispatcher_crashes_total"),
                          ("degraded_dispatches",
                           "serving_degraded_dispatches_total"),
                          ("fault_injections", "fault_injections_total")):
            v = _value_of(metric)
            if v:
                srv[k] = int(v)
        out["serving"] = srv
    gen_tokens = _value_of("generation_tokens_total")
    gen_steps = _value_of("generation_decode_steps_total")
    if gen_tokens or gen_steps:
        # generation digest (inference/generation): decode-side truth —
        # tokens emitted, the prefill-vs-decode device-time split, slot
        # churn, and the bytes that DID cross to the host (the cache
        # must never be among them; a test pins the ratio)
        gen: Dict[str, Any] = {
            "tokens": int(gen_tokens),
            "decode_steps": int(gen_steps),
            "prefill_seconds": round(
                _value_of("generation_prefill_seconds"), 3),
            "decode_seconds": round(
                _value_of("generation_decode_seconds"), 3),
            "slot_joins": int(_value_of("generation_slot_joins_total")),
            "slot_leaves": int(
                _value_of("generation_slot_leaves_total")),
            "decode_compiles": int(
                _value_of("generation_decode_compiles_total")),
            "ingest_compiles": int(
                _value_of("generation_ingest_compiles_total")),
            "cache_bytes_resident": int(
                _value_of("generation_cache_bytes_resident")),
            "host_fetch_bytes": int(
                _value_of("generation_host_fetch_bytes_total")),
        }
        with _lock:
            s_h = _registry.get(("generation_step_seconds", ()))
        if isinstance(s_h, Histogram) and s_h.count:
            gen["step_p50_ms"] = round(
                (s_h.quantile(0.50) or 0) * 1e3, 3)
            gen["step_p99_ms"] = round(
                (s_h.quantile(0.99) or 0) * 1e3, 3)
        eos = _value_of("generation_eos_total")
        if eos:
            gen["eos"] = int(eos)
        # paged KV cache + radix prefix reuse: page-pool
        # pressure and the headline prefix-hit rate — present only
        # when the paged engine has actually allocated/matched
        alloc = _value_of("generation_page_alloc_total")
        if alloc:
            gen["page_allocs"] = int(alloc)
            gen["page_frees"] = int(
                _value_of("generation_page_free_total"))
            gen["page_evictions"] = int(
                _value_of("generation_page_evict_total"))
            gen["pages_free"] = int(_value_of("generation_pages_free"))
            gen["pages_total"] = int(
                _value_of("generation_pages_total"))
            gen["prefix_cache_bytes"] = int(
                _value_of("generation_prefix_cache_bytes"))
            gen["page_starved_events"] = int(
                _value_of("generation_page_starved_total"))
        hits = _value_of("generation_prefix_hit_total")
        misses = _value_of("generation_prefix_miss_total")
        if hits or misses:
            gen["prefix_hits"] = int(hits)
            gen["prefix_misses"] = int(misses)
            gen["prefix_hit_rate"] = round(hits / (hits + misses), 4)
            gen["prefix_pages_reused"] = int(
                _value_of("generation_prefix_pages_reused_total"))
        # token-latency + goodput digest: the per-request
        # lifecycle histograms and the deadline-verdict ledger, in the
        # same place bench.py journals everything else generation
        for short, hname in (("ttft", "generation_ttft_seconds"),
                             ("tpot", "generation_tpot_seconds"),
                             ("itl", "generation_itl_seconds")):
            q = histogram_stats(hname)
            if q is not None:
                gen[f"{short}_p50_ms"] = round(q["p50"] * 1e3, 3)
                gen[f"{short}_p99_ms"] = round(q["p99"] * 1e3, 3)
        good = _value_of("generation_goodput_tokens_total")
        wasted = _value_of("generation_wasted_tokens_total")
        if good or wasted:
            gen["goodput_tokens"] = int(good)
            gen["wasted_tokens"] = int(wasted)
            gen["goodput_fraction"] = round(good / (good + wasted), 4)
        slo = _value_of("generation_slo_violations_total")
        if slo:
            gen["slo_violations"] = int(slo)
        out["generation"] = gen
    return out
