"""Read the chrome trace that ``torch.profiler`` exports
(``profile.export_chrome_trace``) into a :class:`TraceData`.

Counterpart of ``paddle_tpu/profiling/trace_parse.py``, which reads a
``jax.profiler`` capture. The events the attribution needs:

- ``cat: "kernel"`` (and ``gpu_memcpy``/``gpu_memset``), ``ph: "X"``:
  device work, with ``args.correlation``, ``args.stream`` and
  ``args.device``;
- ``cat: "cuda_runtime"``/``"cuda_driver"``: the host call that issued
  the work (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
  ``cudaGraphLaunch``, ...) on its thread, with the same correlation id.
  Every kernel of a CUDA-graph replay carries the correlation id of its
  ``cudaGraphLaunch``;
- ``cat: "user_annotation"``: ``record_function`` ranges on the host
  thread, where the executor's labels live (``ptseg:<key>`` around an
  eager segment run, ``<type>.<out>`` around each op, ``ptreplay:<key>``
  around a graph replay);
- on a trace with no device activity (the CPU), the top-level
  ``cat: "cpu_op"`` events stand in for device work: each is launched by
  itself, on its own thread.

gzip and json from the standard library are the whole decoder.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["find_trace_file", "load_chrome_trace", "parse_trace",
           "parse_trace_dir", "TraceData", "LAUNCH_CALLS"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls that issue one kernel each: a correlation id among these
# with no device record is a record the trace lost
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx")
# the executor's own ranges (profiling/attribution.py)
_EXECUTOR_RANGES = ("ptseg:", "ptreplay:", "ptcapture:")


def find_trace_file(trace_dir: str) -> Optional[str]:
    """Newest ``*.json`` / ``*.json.gz`` / ``*.pt.trace.json`` under
    ``trace_dir`` (recursive), or ``trace_dir`` itself when it is a
    file."""
    if os.path.isfile(trace_dir):
        return trace_dir
    hits: List[str] = []
    for pat in ("**/*.json.gz", "**/*.json"):
        hits.extend(p for p in glob.glob(os.path.join(trace_dir, pat),
                                         recursive=True)
                    if os.path.basename(p) != "device_profile.json")
    if not hits:
        return None
    return max(hits, key=lambda p: (os.path.getmtime(p), p))


def load_chrome_trace(path: str) -> Dict[str, Any]:
    """Parse one chrome-trace JSON file, gzipped or plain."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
            return json.load(f)
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return json.load(f)


class TraceData:
    """Digest of one trace.

    ``device_events``: [{name, ts, dur, corr, stream, device, cat}] in
    time order; ``runtime``: {correlation -> {name, ts, dur, pid, tid}};
    ``annotations``: {(pid, tid) -> [(ts, end, name)] sorted by start};
    ``total_device_us``: the summed device time (the coverage
    denominator); ``platform``: "cuda" when the trace holds device
    records, else "cpu" (top-level cpu ops as the device events, each
    its own launch under the correlation id ``("cpu", i)``)."""

    __slots__ = ("path", "device_events", "runtime", "annotations",
                 "total_device_us", "n_events", "threads",
                 "platform")

    def __init__(self):
        self.path: Optional[str] = None
        self.device_events: List[Dict[str, Any]] = []
        self.runtime: Dict[Any, Dict[str, Any]] = {}
        self.annotations: Dict[Tuple[Any, Any], List[tuple]] = {}
        self.total_device_us = 0.0
        self.n_events = 0
        self.threads: Dict[Tuple[Any, Any], str] = {}
        self.platform = "cpu"

    def stacks(self, points: List[Tuple[Any, Any, float, Any]],
               borrow: bool = True) -> Dict[Any, List[str]]:
        """{key -> the annotation names enclosing host time ``ts`` on
        thread (pid, tid), outermost first} for each ``(pid, tid, ts,
        key)`` point: one sweep per thread over the annotations (which
        nest) and the points, in time order.

        A point on a thread with no annotation open at ``ts`` takes the
        stack of the one other thread of its process that has an
        executor range (``ptseg:``/``ptreplay:``/``ptcapture:``) open
        then: the autograd engine launches a backward's kernels from its
        device thread while the calling thread waits inside the op's
        range. With none, or several, such threads it stays empty.
        ``borrow=False`` keeps every point to its own thread."""
        out = self._sweep(points)
        orphans = [(pid, tid, ts, key) for pid, tid, ts, key in points
                   if not out.get(key)]
        if not orphans or not borrow:
            return out
        by_pid: Dict[Any, List[tuple]] = {}
        for p in orphans:
            by_pid.setdefault(p[0], []).append(p)
        for pid, pts in by_pid.items():
            found: Dict[Any, List[List[str]]] = {}
            for thread in self.annotations:
                if thread[0] != pid:
                    continue
                got = self._sweep([(pid, thread[1], ts, key)
                                   for _p, _t, ts, key in pts])
                for key, stack in got.items():
                    if any(n.startswith(_EXECUTOR_RANGES) for n in stack):
                        found.setdefault(key, []).append(stack)
            for key, stacks in found.items():
                if len(stacks) == 1:
                    out[key] = stacks[0]
        return out

    def _sweep(self, points) -> Dict[Any, List[str]]:
        out: Dict[Any, List[str]] = {}
        by_thread: Dict[tuple, List[tuple]] = {}
        for pid, tid, ts, key in points:
            by_thread.setdefault((pid, tid), []).append((ts, key))
        for thread, pts in by_thread.items():
            pts.sort(key=lambda p: p[0])
            spans = self.annotations.get(thread, [])
            open_: List[tuple] = []
            j = 0
            for ts, key in pts:
                while j < len(spans) and spans[j][0] <= ts:
                    open_.append(spans[j])
                    j += 1
                open_ = [sp for sp in open_ if sp[1] >= ts]
                out[key] = [sp[2] for sp in open_]
        return out

    def lost_launches(self, inside_ok: str = "ptcapture:") -> int:
        """Kernel launch calls whose kernel has no device record, less
        those made inside an annotation named ``inside_ok...`` (a launch
        during CUDA-graph capture is recorded into the graph and issues
        no kernel)."""
        seen = {e["corr"] for e in self.device_events}
        lost = [(r["pid"], r["tid"], r["ts"], c)
                for c, r in self.runtime.items()
                if r["name"] in LAUNCH_CALLS and c not in seen]
        stacks = self.stacks(lost)
        return sum(1 for *_p, c in lost
                   if not any(n.startswith(inside_ok)
                              for n in stacks.get(c, ())))


def parse_trace(trace: Dict[str, Any], path: Optional[str] = None
                ) -> TraceData:
    """Digest a loaded chrome-trace dict."""
    td = TraceData()
    td.path = path
    cpu_ops: List[Dict[str, Any]] = []
    for e in trace.get("traceEvents") or []:
        if not isinstance(e, dict):
            continue
        td.n_events += 1
        ph, cat = e.get("ph"), e.get("cat")
        if ph == "M" and e.get("name") == "thread_name":
            td.threads[(e.get("pid"), e.get("tid"))] = (
                e.get("args") or {}).get("name", "")
            continue
        if ph != "X":
            continue
        args = e.get("args") or {}
        ts = float(e.get("ts", 0.0) or 0.0)
        dur = float(e.get("dur", 0.0) or 0.0)
        if cat in _DEVICE_CATS:
            td.device_events.append({
                "name": str(e.get("name", "")), "ts": ts, "dur": dur,
                "corr": args.get("correlation"),
                "stream": args.get("stream"),
                "device": args.get("device"), "cat": cat})
        elif cat in ("cuda_runtime", "cuda_driver"):
            c = args.get("correlation")
            if c is not None:
                td.runtime[c] = {"name": str(e.get("name", "")),
                                 "ts": ts, "dur": dur,
                                 "pid": e.get("pid"), "tid": e.get("tid")}
        elif cat == "user_annotation":
            td.annotations.setdefault((e.get("pid"), e.get("tid")), []
                                      ).append((ts, ts + dur,
                                                str(e.get("name", ""))))
        elif cat == "cpu_op":
            cpu_ops.append({"name": str(e.get("name", "")), "ts": ts,
                            "dur": dur, "pid": e.get("pid"),
                            "tid": e.get("tid")})
    if td.device_events:
        td.platform = "cuda"
    else:
        # no device records: the top-level cpu ops are the work
        by_thread: Dict[tuple, List[Dict[str, Any]]] = {}
        for op in cpu_ops:
            by_thread.setdefault((op["pid"], op["tid"]), []).append(op)
        i = 0
        for ops in by_thread.values():
            ops.sort(key=lambda o: (o["ts"], -o["dur"]))
            end = -1.0
            for op in ops:
                if op["ts"] < end:
                    continue  # nested in an enclosing cpu op
                end = op["ts"] + op["dur"]
                corr = ("cpu", i)
                i += 1
                td.device_events.append({
                    "name": op["name"], "ts": op["ts"], "dur": op["dur"],
                    "corr": corr, "stream": None, "device": None,
                    "cat": "cpu_op"})
                td.runtime[corr] = {"name": op["name"], "ts": op["ts"],
                                    "dur": op["dur"], "pid": op["pid"],
                                    "tid": op["tid"]}
    td.device_events.sort(key=lambda d: d["ts"])
    td.total_device_us = sum(d["dur"] for d in td.device_events)
    for spans in td.annotations.values():
        spans.sort(key=lambda sp: (sp[0], -sp[1]))
    return td


def parse_trace_dir(trace_dir: str) -> TraceData:
    """Ingest the newest trace file under ``trace_dir`` (or the file
    itself). An empty TraceData, no raise, when there is none: a capture
    that saw no step is a report problem, not a crash."""
    path = find_trace_file(trace_dir)
    if path is None:
        return TraceData()
    try:
        trace = load_chrome_trace(path)
    except (OSError, ValueError):
        td = TraceData()
        td.path = path
        return td
    return parse_trace(trace, path)
