"""Profiler (python/paddle/fluid/profiler.py:221 + platform/profiler.h;
counterpart of ``paddle_tpu/profiler.py``).

Host spans via RecordEvent (RAII context, profiler.h:72 analog) and
device-side tracing via ``torch.profiler`` (CUPTI kernel records, the
reference DeviceTracer's source), exported as a chrome trace into
``trace_dir``. The aggregated report mirrors the reference's
Enable/DisableProfiler table: calls/total/min/max/avg per event,
sortable. ``cuda_profiler`` brackets its body with
``cudaProfilerStart``/``Stop`` (``torch.cuda.profiler``), so
``nsys --capture-range=cudaProfilerApi`` records just that range.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

__all__ = ["RecordEvent", "record_event", "start_profiler", "stop_profiler",
           "cuda_profiler",
           "profiler", "reset_profiler", "dump_profile_proto",
           "load_profile_proto"]

# name -> [(start_s, end_s, args, tid, thread_name)] relative to the
# profiler epoch — real timestamps, so the chrome trace and the
# profiler.proto export carry the actual concurrency structure, not
# synthetic back-to-back spans. `args` is an optional metadata dict
# (e.g. the executor's fused multi-step calls record {"iterations": K}
# on their ONE span); it rides into the chrome trace's "args" field.
# tid/thread_name are captured at span CLOSE, so DataLoader
# prefetch-thread spans land on their own chrome-trace row instead of
# stacking on the main thread's.
_events: Dict[str, List[tuple]] = defaultdict(list)
_enabled = False
_device_trace_dir: Optional[str] = None
_device_prof = None
_epoch: float = 0.0


class RecordEvent(contextlib.ContextDecorator):
    """platform/profiler.h:72 RecordEvent analog; also usable as a
    decorator (``@RecordEvent("name")`` — each decorated call gets a
    fresh instance via _recreate_cm, so concurrent calls from
    different threads record independent spans). ``args`` attaches a
    metadata dict to the span (chrome trace "args" — e.g.
    {"iterations": K} on a fused multi-step executor call)."""

    def __init__(self, name: str, args: Optional[Dict] = None):
        self.name = name
        self.args = args
        self._start = None
        self._epoch_at_start = None

    def _recreate_cm(self):
        # decorator protocol: a FRESH instance per decorated call, so
        # concurrent calls (e.g. main + prefetch thread) can't clobber
        # each other's _start
        return RecordEvent(self.name, self.args)

    def __enter__(self):
        if _enabled:
            self._start = time.perf_counter()
            self._epoch_at_start = _epoch
        return self

    def __exit__(self, *exc):
        if (_enabled and self._start is not None
                and self._epoch_at_start == _epoch):
            # a span straddling a profiler restart is dropped: its
            # start predates the current epoch and would serialize as
            # a negative (varint-mangled) timestamp
            import threading
            t = threading.current_thread()
            _events[self.name].append(
                (self._start - _epoch, time.perf_counter() - _epoch,
                 self.args, t.ident or 0, t.name))
        return False


record_event = RecordEvent


def reset_profiler():
    _events.clear()


def start_profiler(state="All", trace_dir=None):
    """state: CPU | GPU | All (GPU/All with a ``trace_dir`` additionally
    start a torch.profiler device trace, written to
    ``<trace_dir>/device_trace.json`` at stop)."""
    global _enabled, _device_trace_dir, _device_prof, _epoch
    _enabled = True
    # fresh epoch = fresh span set: mixing spans from an earlier epoch
    # would fabricate overlap in the trace/proto timelines
    _events.clear()
    _epoch = time.perf_counter()
    if state in ("GPU", "All") and trace_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        _device_prof, _device_trace_dir = prof, trace_dir


def stop_profiler(sorted_key=None, profile_path="/tmp/profile"):
    global _enabled, _device_trace_dir, _device_prof
    _enabled = False
    if _device_prof is not None:
        prof, d = _device_prof, _device_trace_dir
        _device_prof = _device_trace_dir = None
        prof.__exit__(None, None, None)
        os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(os.path.join(d, "device_trace.json"))
    _print_report(sorted_key)
    _dump_chrome_trace(profile_path)
    # profiler.proto-shaped binary next to the chrome trace — the
    # reference's serialized Profile format
    # (platform/profiler.proto:20,36), consumed by scripts/timeline.py
    dump_profile_proto(profile_path + ".pb")


def _print_report(sorted_key=None):
    rows = []
    for name, spans in _events.items():
        times = [e - s for s, e, *_ in spans]
        rows.append({
            "Event": name, "Calls": len(times), "Total": sum(times),
            "Min": min(times), "Max": max(times),
            "Ave": sum(times) / len(times)})
    keymap = {"calls": "Calls", "total": "Total", "max": "Max", "min": "Min",
              "ave": "Ave"}
    if sorted_key in keymap:
        rows.sort(key=lambda r: r[keymap[sorted_key]], reverse=True)
    if not rows:
        return
    print(f"{'Event':<40}{'Calls':>8}{'Total(s)':>12}{'Min(s)':>10}"
          f"{'Max(s)':>10}{'Ave(s)':>10}")
    for r in rows:
        print(f"{r['Event']:<40}{r['Calls']:>8}{r['Total']:>12.6f}"
              f"{r['Min']:>10.6f}{r['Max']:>10.6f}{r['Ave']:>10.6f}")


def _dump_chrome_trace(path: str):
    """chrome://tracing JSON (tools/timeline.py analog). Spans keep
    the REAL thread id recorded at close — one row per thread, with
    thread_name metadata events — and the monitor's step-telemetry
    counter tracks ("ph":"C") merge in when monitoring is enabled."""
    if not _events:
        return
    trace = {"traceEvents": []}
    threads: Dict[int, str] = {}
    for name, spans in _events.items():
        for start, end, args, tid, tname in spans:
            threads.setdefault(tid, tname)
            ev = {"name": name, "cat": "host", "ph": "X", "pid": 0,
                  "tid": tid, "ts": start * 1e6,
                  "dur": (end - start) * 1e6}
            if args:
                ev["args"] = args
            trace["traceEvents"].append(ev)
    for tid, tname in sorted(threads.items()):
        trace["traceEvents"].append(
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
             "args": {"name": tname}})
    from . import monitor as _monitor
    if _monitor.enabled():
        trace["traceEvents"].extend(
            _monitor.chrome_counter_events(_epoch))
        # serving request traces ("trace" events): per-request span
        # chains with flow arrows stitching caller -> dispatcher
        trace["traceEvents"].extend(
            _monitor.chrome_trace_span_events(_epoch))
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
    except OSError:
        pass


# ---- profiler.proto wire format -------------------------------------------
# Hand-encoded protobuf (proto2 wire format is stable and tiny — no
# protoc/runtime needed). Schema: platform/profiler.proto —
#   MemCopy { uint64 bytes = 1; }
#   Event   { EventType type = 8; string name = 1; uint64 start_ns = 2;
#             uint64 end_ns = 3; int64 device_id = 5;
#             int64 sub_device_id = 6; MemCopy memcopy = 7; }
#   Profile { repeated Event events = 1; uint64 start_ns = 2;
#             uint64 end_ns = 3; }

def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_event(name: str, start_ns: int, end_ns: int,
                  device_id: int = -1) -> bytes:
    body = (_field(1, 2) + _varint(len(name.encode())) + name.encode()
            + _field(2, 0) + _varint(start_ns)
            + _field(3, 0) + _varint(end_ns)
            + _field(5, 0) + _varint(device_id)
            + _field(8, 0) + _varint(0))  # EventType.CPU
    return body


def dump_profile_proto(path: str):
    """Serialize the recorded spans as a profiler.proto Profile."""
    if not _events:
        return
    evs = []
    for name, spans in _events.items():
        for start, end, *_rest in spans:
            evs.append((name, int(start * 1e9), int(end * 1e9)))
    evs.sort(key=lambda e: e[1])
    payload = bytearray()
    for name, s, e in evs:
        body = _encode_event(name, s, e)
        payload += _field(1, 2) + _varint(len(body)) + body
    payload += _field(2, 0) + _varint(evs[0][1] if evs else 0)
    payload += _field(3, 0) + _varint(max((e for _, _, e in evs),
                                          default=0))
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(bytes(payload))
    except OSError:
        pass


def _read_varint(buf: bytes, pos: int):
    shift, val = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def load_profile_proto(path: str):
    """Decode a profiler.proto Profile → {"events": [...], "start_ns",
    "end_ns"} (the reverse of dump_profile_proto; also reads files the
    reference wrote — same wire format)."""
    with open(path, "rb") as f:
        buf = f.read()
    profile = {"events": [], "start_ns": 0, "end_ns": 0}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            chunk = buf[pos:pos + ln]
            pos += ln
            if num == 1:
                ev = {"name": "", "start_ns": 0, "end_ns": 0,
                      "device_id": -1, "type": 0}
                p2 = 0
                while p2 < len(chunk):
                    k2, p2 = _read_varint(chunk, p2)
                    n2, w2 = k2 >> 3, k2 & 7
                    if w2 == 2:
                        l2, p2 = _read_varint(chunk, p2)
                        if n2 == 1:
                            ev["name"] = chunk[p2:p2 + l2].decode(
                                "utf-8", "replace")
                        p2 += l2
                    elif w2 == 0:
                        v2, p2 = _read_varint(chunk, p2)
                        if n2 == 2:
                            ev["start_ns"] = v2
                        elif n2 == 3:
                            ev["end_ns"] = v2
                        elif n2 == 5:
                            # int64 stored as two's-complement varint
                            ev["device_id"] = (v2 - (1 << 64)
                                               if v2 >> 63 else v2)
                        elif n2 == 8:
                            ev["type"] = v2
                profile["events"].append(ev)
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            if num == 2:
                profile["start_ns"] = v
            elif num == 3:
                profile["end_ns"] = v
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return profile


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path="/tmp/profile",
             trace_dir=None):
    """fluid.profiler.profiler context manager (profiler.py:221)."""
    start_profiler(state, trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """profiler.py cuda_profiler: ``cudaProfilerStart`` before the body
    and ``cudaProfilerStop`` after it, so an external CUDA profiler
    started with a capture range (``nsys --capture-range=
    cudaProfilerApi -o <output_file>``) records the body alone.
    ``output_mode`` and ``config`` were nvprof's and are accepted for
    compatibility; the output file is the external profiler's."""
    import torch.cuda.profiler as _cuda_prof

    _cuda_prof.start()
    try:
        yield
    finally:
        _cuda_prof.stop()
