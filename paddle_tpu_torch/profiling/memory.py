"""Device memory observability: the liveness-attributed footprint.

Counterpart of ``paddle_tpu/profiling/memory.py``: a **static liveness
analysis** over a plan segment's OpDescs that predicts, before the
segment runs, how many bytes it holds live at its worst op:

- walk the segment's ops in program order with the shared def-use index
  (ir/analyze.DefUse), keeping a running live set in bytes;
- feed shapes resolve exactly (the caller passes the real feed
  signature), scope state exactly, and temporaries through the
  verifier's shadow types (ir/verify.infer_block_types), dynamic dims
  substituted by the observed batch; sizes come from the desc's dtype;
- buffers are tracked by NAME, so an in-place update (out name == in
  name: the optimizer writing a parameter) counts once;
- a K-step plan counts its [K, ...] feeds and fetches at K x while the
  persistable state counts once;
- fetched vars and written state stay live to the segment's end;
- a control-flow op folds its sub-block's local peak into its own row.

The result (:class:`FootprintReport`) carries the predicted peak, the op
at peak, the per-op timeline and the top vars with their creation
callstacks. Its consumers: the executor's **pre-flight** (:func:`preflight`
against the card's memory x ``FLAGS.memory_budget_frac``, or
``FLAGS.memory_budget_bytes``), which raises
:class:`MemoryBudgetExceeded` before any device work; the **OOM record**
(``torch.cuda.OutOfMemoryError`` dumps an ``oom`` flight record with the
timeline and the census); the serving and generation warm-ups' ladders;
and the **live plane** (the registry below feeds ``GET /memory``, the
``executor_mem_*`` gauges and the session report's ``memory`` section).

Closing the loop: :func:`note_measured` takes ``torch.cuda``'s measured
peak of a plan segment's first eager run and of its capture (the
allocator's peak over the run, less what was allocated before, plus the
segment's inputs) and gauges predicted over measured for each, so the
captured graph's excess over the eager run shows.

Cost contract: nothing here runs unless :func:`analysis_enabled` (the
monitor is on, or a budget is set), and the shadow type inference is
memoized per program version.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import monitor as _monitor
from ..core.types import dtype_to_torch
from ..ir import analyze as _analyze
from ..utils.flags import FLAGS, memory_budget_set

__all__ = [
    "MemoryBudgetExceeded", "FootprintReport", "analysis_enabled",
    "budget_configured", "budget_bytes", "segment_footprint",
    "program_footprint", "preflight", "register_footprint",
    "note_measured", "footprints", "session_section", "memory_plane",
    "fitting_config", "fitting_pages", "max_fitting_batch",
]

# top-contributor census depth (the forensics + /memory payload)
TOP_VARS = 10


class MemoryBudgetExceeded(RuntimeError):
    """Typed OOM pre-flight diagnostic: the statically predicted peak
    footprint exceeds the device budget. Raised BEFORE the segment runs,
    naming the op at peak and the top-contributing vars with their
    creation callstacks, which a bare out-of-memory error never has.
    ``report`` is the full :class:`FootprintReport`; ``budget`` the byte
    budget that lost."""

    def __init__(self, message: str, report: "FootprintReport",
                 budget: int, budget_source: str = "", where: str = ""):
        super().__init__(message)
        self.report = report
        self.budget = int(budget)
        self.budget_source = budget_source
        self.where = where


class FootprintReport:
    """One segment's liveness-attributed footprint prediction."""

    __slots__ = ("peak_bytes", "peak_op_idx", "peak_op_type",
                 "peak_op_out", "timeline", "top_vars", "args_bytes",
                 "ops", "iterations", "unknown_vars", "wall_ms",
                 "measured_peak_bytes", "measured_captured_peak_bytes")

    def __init__(self):
        self.peak_bytes = 0
        self.peak_op_idx: Optional[int] = None
        self.peak_op_type: Optional[str] = None
        self.peak_op_out: Optional[str] = None
        # [(op_idx, op_type, live_bytes_after_op)] — the footprint
        # timeline the oom flight record carries
        self.timeline: List[Tuple[int, str, int]] = []
        # live-var census at predicted peak, largest first:
        # {name, nbytes, kind, producer, callstack}
        self.top_vars: List[Dict[str, Any]] = []
        self.args_bytes = 0          # feeds + entry state (arguments)
        self.ops = 0
        self.iterations = 1
        self.unknown_vars = 0        # statically unsizable (counted 0)
        self.wall_ms = 0.0
        # the allocator's measured peak of the first eager run and of
        # the capture, filled by note_measured
        self.measured_peak_bytes: Optional[int] = None
        self.measured_captured_peak_bytes: Optional[int] = None

    @property
    def top_var(self) -> Optional[str]:
        return self.top_vars[0]["name"] if self.top_vars else None

    def agreement(self, captured: bool = False) -> Optional[float]:
        """predicted / measured peak of the eager run (or the capture);
        None until the measurement lands."""
        m = (self.measured_captured_peak_bytes if captured
             else self.measured_peak_bytes)
        if not m or not self.peak_bytes:
            return None
        return self.peak_bytes / m

    def format_peak(self, with_callstack: bool = True) -> str:
        """Human summary of the peak: op + top vars (+ callstacks)."""
        head = (f"predicted peak {_fmt_bytes(self.peak_bytes)} at op "
                f"#{self.peak_op_idx} [{self.peak_op_type}]")
        if self.peak_op_out:
            head += f" (writes '{self.peak_op_out}')"
        lines = [head]
        for v in self.top_vars[:5]:
            line = (f"  {v['name']}: {_fmt_bytes(v['nbytes'])} "
                    f"({v['kind']}, produced by {v['producer']})")
            lines.append(line)
            if with_callstack and v.get("callstack"):
                lines.extend(f"    created at {fr}"
                             for fr in v["callstack"][-2:])
        return "\n".join(lines)

    def to_dict(self, max_timeline: int = 256) -> Dict[str, Any]:
        tl = self.timeline
        if len(tl) > max_timeline:
            # keep shape for forensics without unbounded flight records:
            # uniform downsample but always keep the peak row
            stride = max(1, len(tl) // max_timeline)
            keep = {i for i in range(0, len(tl), stride)}
            if self.peak_op_idx is not None:
                keep.add(self.peak_op_idx)
            tl = [r for i, r in enumerate(tl) if i in keep]
        return {
            "peak_bytes": int(self.peak_bytes),
            "peak_op_idx": self.peak_op_idx,
            "peak_op_type": self.peak_op_type,
            "peak_op_out": self.peak_op_out,
            "args_bytes": int(self.args_bytes),
            "ops": self.ops,
            "iterations": self.iterations,
            "unknown_vars": self.unknown_vars,
            "wall_ms": round(self.wall_ms, 3),
            "measured_peak_bytes": self.measured_peak_bytes,
            "agreement": (round(self.agreement(), 4)
                          if self.agreement() else None),
            "measured_captured_peak_bytes":
                self.measured_captured_peak_bytes,
            "agreement_captured": (
                round(self.agreement(True), 4)
                if self.agreement(True) else None),
            "top_vars": self.top_vars[:TOP_VARS],
            "timeline": [(i, t, int(b)) for i, t, b in tl],
        }


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return (f"{n:.2f} {unit}" if unit != "B"
                    else f"{int(n)} {unit}")
        n /= 1024.0
    return f"{n} B"


# ---------------------------------------------------------------------------
# enablement + budget
# ---------------------------------------------------------------------------

def budget_configured() -> bool:
    """True when the operator set a memory budget (either flag)."""
    return memory_budget_set()


def analysis_enabled() -> bool:
    """The footprint analysis runs iff someone consumes it: the
    monitor is on (gauges / /memory / forensics) or a budget is
    configured (pre-flight). Off on both counts, the executor pays a
    single branch per cache miss and the test suite pays nothing."""
    return _monitor.enabled() or budget_configured()


def budget_bytes(device=None) -> Tuple[int, str]:
    """(byte budget, source tag) for ``device``.

    ``FLAGS.memory_budget_bytes`` (absolute, tests/CI) wins; otherwise
    the card's memory (``monitor.peak_hbm``:
    ``torch.cuda.get_device_properties().total_memory``) x
    ``FLAGS.memory_budget_frac``. A zero/unset frac yields (0, ...):
    the caller treats 0 as "no budget, pre-flight disabled"."""
    b = int(getattr(FLAGS, "memory_budget_bytes", 0))
    if b > 0:
        return b, "FLAGS_memory_budget_bytes"
    frac = float(getattr(FLAGS, "memory_budget_frac", 0.0))
    if frac <= 0.0:
        return 0, "disabled"
    cap, src = _monitor.peak_hbm(device)
    if not cap:
        return 0, src
    return int(cap * frac), f"{src} x FLAGS_memory_budget_frac={frac:g}"


def preflight(report: FootprintReport, device=None, key: str = "",
              where: str = "executor") -> Tuple[int, Optional[float]]:
    """OOM pre-flight: compare the predicted peak against the device
    budget BEFORE compiling. Returns (budget_bytes, headroom_frac);
    raises :class:`MemoryBudgetExceeded` — naming the op at peak, the
    top vars, and their creation callstacks — when the program cannot
    fit. budget 0 (unconfigured) returns (0, None) without checking."""
    budget, src = budget_bytes(device)
    if budget <= 0:
        return 0, None
    headroom = (budget - report.peak_bytes) / budget
    if _monitor.enabled():
        _monitor.gauge("executor_mem_headroom_frac",
                       {"key": key} if key else None).set(
            round(headroom, 6))
    if report.peak_bytes > budget:
        if _monitor.enabled():
            _monitor.counter("executor_mem_preflight_rejects_total",
                             {"where": where}).inc()
            _monitor.log_event("mem_preflight_reject", key=key,
                               where=where,
                               predicted=int(report.peak_bytes),
                               budget=int(budget))
        raise MemoryBudgetExceeded(
            f"OOM pre-flight ({where}): predicted peak footprint "
            f"{_fmt_bytes(report.peak_bytes)} exceeds the memory "
            f"budget {_fmt_bytes(budget)} ({src}), refusing to run "
            f"it.\n" + report.format_peak()
            + "\nRemedies: shrink the batch / sequence buckets, raise "
            "FLAGS_memory_budget_frac, or enable gradient accumulation.",
            report, budget, budget_source=src, where=where)
    return budget, headroom


# ---------------------------------------------------------------------------
# shape resolution
# ---------------------------------------------------------------------------

def _nbytes_of(shape, dtype, batch_hint: int,
               from_shadow: bool = False) -> Optional[int]:
    """Bytes of one buffer from a static shape. -1/None dims
    substitute the observed batch; with ``from_shadow=True`` (the
    shape came out of the verifier's shadow inference, where dynamic
    dims were substituted by the _WILDCARD sentinel before
    eval_shape) sentinel-derived dims ALSO substitute the batch — a
    REAL observed feed/state shape must never get that treatment, or
    a genuine dim that happens to divide the sentinel (seq 386, d
    772, ...) silently corrupts the byte count. A shape/dtype that
    cannot be resolved returns None (counted unknown)."""
    if shape is None or dtype is None:
        return None
    from ..ir.verify import _WILDCARD
    n = 1
    for d in shape:
        if d is None or (isinstance(d, int) and d < 0):
            d = batch_hint
        elif from_shadow and isinstance(d, int) and d > 0 \
                and d % _WILDCARD == 0:
            d = (d // _WILDCARD) * batch_hint
        n *= int(d)
    item = _itemsize(dtype)
    if item is None:
        return None
    return n * item


def _itemsize(dtype) -> Optional[int]:
    """Bytes of one element of a desc dtype, a torch dtype or a numpy
    dtype (None when unsizable)."""
    import torch
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    try:
        return torch.empty((), dtype=dtype_to_torch(dtype)).element_size()
    except Exception:  # noqa: BLE001 — raw numpy dtype fallback
        try:
            return np.dtype(dtype).itemsize
        except Exception:  # noqa: BLE001 — unsizable
            return None


def _shadow_for(program, desc, block_idx: int):
    """The verifier's shadow types for one block, memoized per program
    version when a frontend Program is on hand (the executor path) —
    the one potentially non-trivial cost of the analysis."""
    from ..ir import verify as _verify

    memo = None
    if program is not None and hasattr(program, "__dict__"):
        memo = program.__dict__.setdefault("_mem_shadow_memo", {})
        mkey = (getattr(program, "_version", 0), block_idx)
        hit = memo.get(mkey)
        if hit is not None:
            return hit
    shadow = _verify.infer_block_types(desc, block_idx,
                                       _verify.VerifyReport(),
                                       check_shapes=True)
    if memo is not None:
        memo[mkey] = shadow
    return shadow


# ---------------------------------------------------------------------------
# the liveness walk
# ---------------------------------------------------------------------------

def segment_footprint(ops: Sequence, program=None, desc=None,
                      block_idx: int = 0,
                      feed_shapes: Optional[Dict[str, tuple]] = None,
                      state_shapes: Optional[Dict[str, Tuple[tuple, Any]]]
                      = None,
                      fetch_names: Sequence[str] = (),
                      keep_names: Sequence[str] = (),
                      iterations: int = 1,
                      _count_filter=None) -> FootprintReport:
    """Liveness-attributed footprint of one lowered segment.

    ``ops`` is the post-DCE (post-pass) op list the executor will
    actually trace; ``feed_shapes`` maps feed names to their REAL
    shapes (the K-stacked super-batch under ``iterations=K``);
    ``state_shapes`` maps entry-state names to (shape, dtype) observed
    in the scope; ``fetch_names``/``keep_names`` (exported state) stay
    live to segment end. Temporaries resolve through the verifier's
    shadow types. Never raises: unsizable vars count 0 bytes and bump
    ``unknown_vars``. ``_count_filter`` (internal, sub-block folding)
    restricts which names contribute bytes — outer vars a while body
    reads are already live in the parent's walk."""
    t0 = time.perf_counter()
    feed_shapes = dict(feed_shapes or {})
    state_shapes = dict(state_shapes or {})
    if desc is None and program is not None:
        desc = getattr(program, "desc", program)
    shadow = None
    if desc is not None:
        try:
            shadow = _shadow_for(program, desc, block_idx)
        except Exception:  # noqa: BLE001 — observability must never raise
            shadow = None

    # observed batch for wildcard substitution: per-step leading dim of
    # the feeds (dim 1 of a K-stacked super-batch)
    batch_hint = 1
    for shp in feed_shapes.values():
        d0 = 1 if iterations > 1 else 0
        if len(shp) > d0:
            batch_hint = max(batch_hint, int(shp[d0]))

    rep = FootprintReport()
    rep.iterations = max(1, int(iterations))
    rep.ops = len(ops)

    du = _analyze.DefUse(ops)
    fetch_set = {n for n in fetch_names if n}
    keep = fetch_set | {n for n in keep_names if n}
    entry = du.external_reads()  # feeds + scope state: live at entry

    # resolve bytes per name, memoized for the walk
    sizes: Dict[str, int] = {}
    kinds: Dict[str, str] = {}

    def nbytes(name: str) -> int:
        got = sizes.get(name)
        if got is not None:
            return got
        n: Optional[int] = None
        if name in feed_shapes:
            shp = feed_shapes[name]
            dt = None
            if shadow is not None:
                d = shadow._find_var_desc_recursive(name)
                dt = d.dtype if d is not None else None
            n = _nbytes_of(tuple(shp), dt or "float32", batch_hint)
            kinds[name] = "feed"
        elif name in state_shapes:
            shp, dt = state_shapes[name]
            n = _nbytes_of(tuple(shp), dt, batch_hint)
            kinds[name] = "state"
        elif shadow is not None:
            d = shadow._find_var_desc_recursive(name)
            if d is not None:
                n = _nbytes_of(d.shape, d.dtype, batch_hint,
                               from_shadow=True)
            kinds[name] = ("state" if name in entry else
                           ("fetch" if name in fetch_set else "temp"))
        if n is None:
            rep.unknown_vars += 1
            n = 0
        if name in fetch_set and rep.iterations > 1:
            # fused K-step fetches stack [K, ...] on the output buffer
            n *= rep.iterations
        if _count_filter is not None and name not in _count_filter:
            n = 0  # counted by the enclosing block's walk
        sizes[name] = n
        return n

    # last position each name is needed (read OR written); keep-set
    # names are pinned to segment end (the segment returns them)
    n_ops = len(ops)
    last_use: Dict[str, int] = {}
    for name, reads in du.readers.items():
        last_use[name] = reads[-1]
    for name, writes in du.writers.items():
        last_use[name] = max(last_use.get(name, -1), writes[-1])
    for name in keep:
        last_use[name] = n_ops
    frees_at: Dict[int, List[str]] = {}
    for name, pos in last_use.items():
        if pos < n_ops:
            frees_at.setdefault(pos, []).append(name)

    # sub-block folding: a control op's transient extra is its
    # sub-block's LOCAL peak (outer vars are already counted here)
    def sub_local_peak(op) -> int:
        if desc is None:
            return 0
        sub = None
        for a in _analyze.CONTROL_ATTRS:
            v = op.attrs.get(a)
            if isinstance(v, int) and 0 <= v < len(desc.blocks) \
                    and v != block_idx:
                sub = v
                break
        if sub is None:
            return 0
        try:
            blk = desc.blocks[sub]
            # count only sub-LOCAL vars: outer vars the body reads are
            # already live in THIS walk — folding them again would
            # double-count every while-carried tensor
            sub_rep = segment_footprint(
                blk.ops, program=program, desc=desc, block_idx=sub,
                feed_shapes={}, state_shapes={},
                fetch_names=(), keep_names=(), iterations=1,
                _count_filter=set(blk.vars))
            rep.unknown_vars += sub_rep.unknown_vars
            return int(sub_rep.peak_bytes)
        except Exception:  # noqa: BLE001 — never raises
            return 0

    live: Dict[str, int] = {}
    cur = 0
    for name in sorted(entry):
        b = nbytes(name)
        live[name] = b
        cur += b
    rep.args_bytes = cur
    peak = cur
    peak_live: Dict[str, int] = dict(live)
    for i, op in enumerate(ops):
        for name in op.output_arg_names():
            if name and name not in live:
                b = nbytes(name)
                live[name] = b
                cur += b
        extra = sub_local_peak(op)
        here = cur + extra
        if here >= peak:
            peak = here
            rep.peak_op_idx = i
            rep.peak_op_type = op.type
            rep.peak_op_out = next(
                (n for ns in op.outputs.values() for n in ns if n), None)
            peak_live = dict(live)
            if extra:
                peak_live[f"<{op.type} sub-block transients>"] = extra
        rep.timeline.append((i, op.type, here))
        for name in frees_at.get(i, ()):
            b = live.pop(name, None)
            if b is not None:
                cur -= b
    rep.peak_bytes = int(peak)

    # census at peak: top contributors with producer + callstack
    producer: Dict[str, Any] = {}
    for op in ops:
        for ns in op.outputs.values():
            for n in ns:
                if n and n not in producer:
                    producer[n] = op
    rows = sorted(peak_live.items(), key=lambda kv: -kv[1])
    for name, b in rows[:TOP_VARS]:
        op = producer.get(name)
        rep.top_vars.append({
            "name": name,
            "nbytes": int(b),
            "kind": kinds.get(name,
                              "sub_block" if name.startswith("<")
                              else "temp"),
            "producer": (op.type if op is not None
                         else kinds.get(name, "feed/state")),
            "callstack": (list(getattr(op, "callstack", None) or [])
                          if op is not None else None),
        })
    rep.wall_ms = (time.perf_counter() - t0) * 1e3
    return rep


def program_footprint(program, feed_shapes: Optional[Dict[str, tuple]]
                      = None, fetch_names: Sequence[str] = (),
                      iterations: int = 1) -> FootprintReport:
    """Convenience: the footprint of a whole program's global block,
    segmented at host ops exactly like the executor, worst segment
    wins. ``feed_shapes`` substitutes real extents for the declared
    dynamic dims (a serving bucket's template shapes). Used by the
    serving/generation warmups and the offline/capacity helpers."""
    from .. import registry
    from ..executor import _split_segments

    desc = getattr(program, "desc", program)
    blk = desc.blocks[0]
    persist = {n for n, v in blk.vars.items() if v.persistable}
    best: Optional[FootprintReport] = None
    for kind, ops in _split_segments(blk.ops):
        if kind == "host":
            continue
        ops = [op for op in ops
               if op.type not in ("feed", "fetch")
               and (registry.has_op(op.type)
                    or op.type.endswith("_grad"))]
        if not ops:
            continue
        written = set()
        for op in ops:
            written.update(n for n in op.output_arg_names() if n)
        keep = persist & written
        rep = segment_footprint(
            ops, program=program, desc=desc, block_idx=0,
            feed_shapes=feed_shapes, fetch_names=fetch_names,
            keep_names=keep, iterations=iterations)
        if best is None or rep.peak_bytes > best.peak_bytes:
            best = rep
    return best if best is not None else FootprintReport()


# ---------------------------------------------------------------------------
# capacity helpers
# ---------------------------------------------------------------------------

def fitting_config(candidates: Sequence, nbytes_of, budget: int):
    """The largest (first, in the given order) candidate whose
    predicted bytes fit ``budget`` — callers pass candidates sorted
    best-first (a cap ladder descending, batch buckets descending).
    Returns (candidate, predicted_bytes) or (None, None)."""
    for cand in candidates:
        try:
            b = int(nbytes_of(cand))
        except Exception:  # noqa: BLE001 — unsizable candidate: skip
            continue
        if b <= budget:
            return cand, b
    return None, None


def fitting_pages(nbytes_of, budget: int, hi: int, lo: int = 1):
    """Page-granular capacity helper: the largest page
    count ``n`` in [lo, hi] whose predicted bytes (``nbytes_of(n)``,
    monotone in n — pool bytes are linear in pages) fit ``budget``.
    Binary search, so sizing a 100k-page pool costs ~17 probes.
    Returns (pages, predicted_bytes) or (None, None) when even ``lo``
    pages exceed the budget."""
    lo, hi = int(lo), int(hi)
    if hi < lo or int(nbytes_of(lo)) > budget:
        return None, None
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if int(nbytes_of(mid)) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo, int(nbytes_of(lo))


def max_fitting_batch(program, feed_template: Dict[str, tuple],
                      fetch_names: Sequence[str] = (),
                      budget: Optional[int] = None,
                      batches: Sequence[int] = (512, 256, 128, 64, 32,
                                                16, 8, 4, 2, 1)
                      ) -> Optional[int]:
    """Capacity helper: the max batch size whose predicted footprint
    fits the budget. ``feed_template`` maps feed names to per-example
    shapes WITH the batch dim (dim 0) present — it is rewritten per
    candidate. budget=None reads the configured budget."""
    if budget is None:
        budget, _src = budget_bytes()
        if budget <= 0:
            return None

    def bytes_at(b):
        shapes = {n: (b,) + tuple(s[1:])
                  for n, s in feed_template.items()}
        return program_footprint(program, feed_shapes=shapes,
                                 fetch_names=fetch_names).peak_bytes

    got, _b = fitting_config(sorted(batches, reverse=True), bytes_at,
                             budget)
    return got


# ---------------------------------------------------------------------------
# registry: the live plane's per-plan-segment view
# ---------------------------------------------------------------------------

_lock = threading.Lock()
# plan segment key -> {"seg_key", "report": FootprintReport, "device"}
_footprints: Dict[str, Dict[str, Any]] = {}


def register_footprint(mod_name: str, seg_key: str,
                       report: FootprintReport,
                       device: str = "") -> None:
    """Publish one plan segment's footprint under its key (the same key
    the measured profiler uses). Feeds ``GET /memory``, the session
    report's memory section, and the bench digest."""
    with _lock:
        _footprints[mod_name] = {"seg_key": seg_key, "report": report,
                                 "device": device}


def note_measured(mod_name: str, measured_peak: Optional[int],
                  key: str = "", captured: bool = False) -> None:
    """Close the loop: attach the allocator's measured peak of a plan
    segment's first eager run (or of its capture, ``captured=True``) to
    its registered prediction and gauge predicted over measured
    (``executor_mem_agreement{key=, run=eager|captured}``)."""
    if not measured_peak:
        return
    with _lock:
        ent = _footprints.get(mod_name)
    if ent is None:
        return
    rep: FootprintReport = ent["report"]
    if captured:
        rep.measured_captured_peak_bytes = int(measured_peak)
    else:
        rep.measured_peak_bytes = int(measured_peak)
    ag = rep.agreement(captured)
    if ag is not None and _monitor.enabled():
        lab = {"key": key or ent["seg_key"],
               "run": "captured" if captured else "eager"}
        _monitor.gauge("executor_mem_measured_peak_bytes", lab).set(
            int(measured_peak))
        _monitor.gauge("executor_mem_agreement", lab).set(round(ag, 4))


def footprints() -> Dict[str, Dict[str, Any]]:
    """{module -> {seg_key, device, **report dict}} snapshot."""
    with _lock:
        items = list(_footprints.items())
    out = {}
    for mod, ent in items:
        d = ent["report"].to_dict(max_timeline=64)
        d["seg_key"] = ent["seg_key"]
        d["device"] = ent["device"]
        out[mod] = d
    return out


def session_section(max_modules: int = 16) -> Dict[str, Any]:
    """The ``memory`` section of a measured-profiling report
    (device_profile.json): per-executable predicted/measured peaks and
    the worst module's census — what profile_report.py --memory
    renders offline."""
    fps = footprints()
    if not fps:
        return {}
    mods = dict(sorted(fps.items(),
                       key=lambda kv: -(kv[1]["peak_bytes"] or 0))
                [:max_modules])
    worst_mod = next(iter(mods), None)
    out: Dict[str, Any] = {"modules": {}}
    for mod, d in mods.items():
        out["modules"][mod] = {
            "seg_key": d["seg_key"],
            "predicted_peak_bytes": d["peak_bytes"],
            "measured_peak_bytes": d["measured_peak_bytes"],
            "agreement": d["agreement"],
            "measured_captured_peak_bytes":
                d["measured_captured_peak_bytes"],
            "agreement_captured": d["agreement_captured"],
            "peak_op_type": d["peak_op_type"],
            "peak_op_idx": d["peak_op_idx"],
            "top_vars": d["top_vars"][:TOP_VARS],
        }
    if worst_mod:
        out["worst_module"] = worst_mod
    return out


def memory_plane() -> Dict[str, Any]:
    """The ``GET /memory`` payload: per-device occupancy (live
    memory_stats + capacity + headroom), the configured budget, and
    the per-executable predicted/measured peaks."""
    devices: Dict[str, Any] = {}
    budget, src = budget_bytes()
    # one live sample through the monitor's shared machinery — the
    # same stat-key set the gauges and flight records export, no
    # second hard-coded copy to drift
    stats_by = _monitor.device_memory_snapshot(refresh=True)
    try:
        for dev, stats in stats_by.items():
            cap, cap_src = _monitor.peak_hbm(dev)
            row: Dict[str, Any] = {"capacity_bytes": int(cap),
                                   "capacity_source": cap_src}
            row.update(stats)
            denom = row.get("bytes_limit") or cap
            if denom:
                row["occupancy_frac"] = round(
                    row["bytes_in_use"] / denom, 6)
                row["headroom_frac"] = round(
                    1.0 - row["bytes_in_use"] / denom, 6)
            devices[dev] = row
    except Exception:  # noqa: BLE001 — the plane must answer regardless
        pass
    fps = footprints()
    worst = None
    if fps:
        worst = max(fps.values(), key=lambda d: d["peak_bytes"] or 0)
    out: Dict[str, Any] = {
        "devices": devices,
        "budget_bytes": int(budget),
        "budget_source": src,
        "executables": {
            mod: {k: d[k] for k in
                  ("seg_key", "device", "peak_bytes", "peak_op_type",
                   "measured_peak_bytes", "agreement",
                   "measured_captured_peak_bytes", "agreement_captured",
                   "args_bytes")}
            for mod, d in fps.items()},
    }
    if worst is not None:
        out["predicted_peak_bytes"] = worst["peak_bytes"]
        out["predicted_top_vars"] = worst["top_vars"][:TOP_VARS]
        if budget > 0 and worst["peak_bytes"]:
            out["predicted_headroom_frac"] = round(
                (budget - worst["peak_bytes"]) / budget, 6)
    return out


def is_resource_exhausted(exc: BaseException) -> bool:
    """Is this exception a device OOM (``torch.cuda.OutOfMemoryError``)?
    Delegates to the executor's matcher, which lives there so the
    dispatch failure path never imports this package."""
    from ..executor import _looks_like_oom
    return _looks_like_oom(exc)


def _host_ram_bytes() -> int:
    """Total host RAM — the CPU backend's device capacity stand-in."""
    try:
        return int(os.sysconf("SC_PHYS_PAGES")) * int(
            os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):
        return int(64e9)
