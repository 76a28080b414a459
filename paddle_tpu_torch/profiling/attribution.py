"""Join measured device kernels back to ProgramDesc ops.

Counterpart of ``paddle_tpu/profiling/attribution.py``. The JAX package
joins a device event to its op through the HLO ``op_name`` metadata,
which XLA carries from ``jax.named_scope``. The port has no compiler in
between, and two kinds of kernel reach the card:

- **eager runs** (a plan's warm-up, the CPU, ``FLAGS.jit_cache=False``):
  with the monitor on the executor runs each op inside
  ``torch.profiler.record_function("<type>.<first out>")`` and each
  segment run inside ``record_function("ptseg:<key>")``. A kernel's
  launch call (correlation id) sits on the host thread inside those
  ranges; the outermost op label is its op (a control-flow op's
  sub-block ops count to it, as a JAX ``while`` does). A launch from
  the autograd engine's device thread (a generic-vjp grad op's
  backward) takes the ranges open on the one executor thread waiting
  for it (``TraceData.stacks``);
- **replays of a captured graph**: every kernel of a replay carries the
  correlation id of its ``cudaGraphLaunch``, which the executor runs
  inside ``record_function("ptreplay:<key>")``; nothing of the ops
  recorded at capture is left. So each plan segment keeps a **labelled
  kernel table**: its kernels in stream order, each with its op label,
  built once from a trace of its eager warm-up run
  (:func:`table_from_trace`; :func:`register_plan` holds it). A replay's
  kernel names are aligned against the table (``difflib``'s longest
  matching blocks); an aligned kernel takes its entry's label.

Rules of :func:`attribute`:

- one label: a **direct** row ``<type>.<out>``;
- several labels on one launch (a composite ``a.x+b.y`` range, where one
  launch serves several ops): a **fusion row** ``fusion[a.x+b.y]``,
  attributed, since the ops are known and only the split is not;
- no label: an **unattributed** row ``unattributed:<kernel>``;
- a replay kernel that does not align with its table is unattributed
  and counted in ``misaligned``; a table entry no replay kernel aligned
  with, and a launch call whose kernel has no record, count in
  ``lost_records``. Nothing is guessed;
- ``coverage`` = attributed device time / total device time.
"""

from __future__ import annotations

import difflib
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["register_plan", "registered_plans", "plan_table",
           "table_from_trace", "trace_losses", "program_label",
           "attribute", "SEG_PREFIX", "REPLAY_PREFIX"]

SEG_PREFIX = "ptseg:"
REPLAY_PREFIX = "ptreplay:"

_lock = threading.Lock()
# seg_key -> {"segment": weakref, "flops": float, "table": list | None}
_plans: Dict[str, Dict[str, Any]] = {}


def register_plan(seg_key: str, segment=None, flops: float = 0.0,
                  table: Optional[List[Tuple[str, Tuple[str, ...]]]]
                  = None, table_trace: Optional[Dict[str, int]] = None
                  ) -> None:
    """Executor hook (monitor on): remember a plan segment under its key,
    with its FLOPs per run and, once known, its labelled kernel table
    [(kernel name, (label, ...))] and what the trace it came from lost
    (``table_trace``: its kernels, launches with no kernel record, and
    kernels with no launch record). The segment is held by weakref: the
    registry never keeps a plan alive."""
    try:
        ref = weakref.ref(segment) if segment is not None else None
    except TypeError:
        ref = None
    with _lock:
        ent = _plans.setdefault(seg_key, {"segment": None, "flops": 0.0,
                                          "table": None,
                                          "table_trace": None})
        if ref is not None:
            ent["segment"] = ref
        if flops:
            ent["flops"] = float(flops)
        if table is not None:
            ent["table"] = list(table)
        if table_trace is not None:
            ent["table_trace"] = dict(table_trace)


def registered_plans() -> List[str]:
    with _lock:
        return list(_plans)


def plan_table(seg_key: str) -> Optional[List[Tuple[str, Tuple[str, ...]]]]:
    with _lock:
        ent = _plans.get(seg_key)
        return None if ent is None else ent["table"]


def _plan_flops(seg_key: str) -> float:
    with _lock:
        ent = _plans.get(seg_key)
        return 0.0 if ent is None else ent["flops"]


def trace_losses(td) -> Dict[str, int]:
    """What a trace lost: its kernels, launch calls with no kernel
    record, and kernels with no launch record (nothing places those)."""
    return {"kernels": len(td.device_events),
            "lost_launches": td.lost_launches(),
            "orphan_kernels": sum(1 for e in td.device_events
                                  if e["corr"] not in td.runtime)}


def _is_program_op_type(t: str) -> bool:
    """A registered op type, or a grad type of one (the live registry,
    so the matcher tracks the framework)."""
    if not t:
        return False
    from .. import registry
    if registry.has_op(t):
        return True
    base = t
    while base.endswith("_grad"):
        base = base[:-5]
        if registry.has_op(base):
            return True
    return False


def program_label(name: str) -> Optional[List[str]]:
    """The op labels an annotation names: ``[<type>.<out>]`` for one op,
    several for a composite ``a.x+b.y``; None when it names none."""
    if not name or name.startswith((SEG_PREFIX, REPLAY_PREFIX)):
        return None
    parts = name.split("+")
    if all(_is_program_op_type(p.split(".", 1)[0]) for p in parts):
        return parts
    return None


def _labels_of(stack: Sequence[str]) -> Tuple[Tuple[str, ...], str]:
    """(op labels, segment key) of one launch's annotation stack: the
    outermost op label and the innermost segment or replay key."""
    labels: Tuple[str, ...] = ()
    key = ""
    for name in stack:
        if name.startswith(SEG_PREFIX):
            key = name[len(SEG_PREFIX):]
        elif name.startswith(REPLAY_PREFIX):
            key = name[len(REPLAY_PREFIX):]
        elif not labels:
            lab = program_label(name)
            if lab:
                labels = tuple(lab)
    return labels, key


def _launches(td) -> Dict[Any, Dict[str, Any]]:
    """{correlation -> {"labels", "key", "graph"}} for every device
    event's launch call."""
    points = []
    graph = {}
    for corr in {e["corr"] for e in td.device_events}:
        r = td.runtime.get(corr)
        if r is None:
            continue
        points.append((r["pid"], r["tid"], r["ts"], corr))
        graph[corr] = "GraphLaunch" in r["name"]
    # on the CPU the autograd engine runs on the calling thread: only a
    # device launch borrows another thread's ranges
    stacks = td.stacks(points, borrow=td.platform == "cuda")
    out = {}
    for corr, stack in stacks.items():
        labels, key = _labels_of(stack)
        out[corr] = {"labels": labels, "key": key, "graph": graph[corr]}
    return out


def table_from_trace(td, seg_key: str
                     ) -> Optional[List[Tuple[str, Tuple[str, ...]]]]:
    """The labelled kernel table of one plan segment from a trace of its
    eager run: the kernels launched inside the first ``ptseg:<key>``
    range, in device time order, each with its op labels. None when
    the trace holds no eager run of that segment."""
    launches = _launches(td)
    spans = sorted(s for ss in td.annotations.values() for s in ss
                   if s[2] == SEG_PREFIX + seg_key)
    if not spans:
        return None
    t0, t1 = spans[0][0], spans[0][1]
    table = []
    for e in td.device_events:
        ln = launches.get(e["corr"])
        if ln is None or ln["graph"] or ln["key"] != seg_key:
            continue
        if t0 <= td.runtime[e["corr"]]["ts"] <= t1:
            table.append((e["name"], ln["labels"]))
    return table


def _name_key(name: str) -> str:
    """A device event's name for alignment: a memset or memcpy without
    its memory kinds, which a graph node reports otherwise than the
    eager call ("Memset (Unknown)" against "Memset (Device)")."""
    if name.startswith(("Memset", "Memcpy")):
        return name.split(" (", 1)[0]
    return name


def _align(table: List[Tuple[str, Tuple[str, ...]]], names: List[str]
           ) -> Tuple[List[Optional[Tuple[str, ...]]], int, int, list]:
    """(labels per replay kernel or None, misaligned, lost, the first
    differing stretches): the replay's kernel names against the
    table's, matched in order."""
    want = [_name_key(n) for n, _l in table]
    names = [_name_key(n) for n in names]
    if want == names:
        return [lab for _n, lab in table], 0, 0, []
    out: List[Optional[Tuple[str, ...]]] = [None] * len(names)
    matched = 0
    sm = difflib.SequenceMatcher(None, want, names, autojunk=False)
    for a, b, size in sm.get_matching_blocks():
        for k in range(size):
            out[b + k] = table[a + k][1]
        matched += size
    diffs = [(tag, a1, b1, [n[:60] for n in want[a1:min(a2, a1 + 2)]],
              [n[:60] for n in names[b1:min(b2, b1 + 2)]], a2 - a1,
              b2 - b1)
             for tag, a1, a2, b1, b2 in sm.get_opcodes()
             if tag != "equal"][:4]
    return out, len(names) - matched, len(want) - matched, diffs


def attribute(td, peak: float = 0.0,
              calls_by_key: Optional[Dict[str, int]] = None
              ) -> Dict[str, Any]:
    """Per-op measured device-time table of one trace.

    Returns ``{"rows", "modules", "device_time_s", "attributed_s",
    "coverage", "lost_records", "misaligned", "replays",
    "replays_without_table"}``. Rows merge by label over eager kernels
    and aligned replay kernels; each carries seconds, kernel count,
    share, and its kernels by name. ``modules`` has per plan segment its
    device time, runs (``calls_by_key``, the executor's run counts in
    the window), FLOPs per run and, with ``peak``, the measured MFU."""
    launches = _launches(td)
    rows: Dict[str, Dict[str, Any]] = {}
    modules: Dict[str, Dict[str, Any]] = {}
    total_us = td.total_device_us
    attributed_us = 0.0
    lost = td.lost_launches()
    misaligned = 0
    replays = 0
    no_table = 0

    def add(labels: Tuple[str, ...], e: Dict[str, Any], key: str):
        nonlocal attributed_us
        if not labels:
            label, source = f"unattributed:{e['name'][:120]}", \
                "unattributed"
        elif len(labels) == 1:
            label, source = labels[0], "direct"
        else:
            shown = "+".join(sorted(labels)[:4])
            if len(labels) > 4:
                shown += f"+{len(labels) - 4}more"
            label, source = f"fusion[{shown}]", "fusion_multi"
        if source != "unattributed":
            attributed_us += e["dur"]
        row = rows.get(label)
        if row is None:
            row = rows[label] = {
                "op": label, "source": source,
                "op_type": (label.split(".", 1)[0] if source == "direct"
                            else ("fusion" if source == "fusion_multi"
                                  else "")),
                "device_s": 0.0, "calls": 0, "kernels": {},
                "modules": []}
        row["device_s"] += e["dur"] * 1e-6
        row["calls"] += 1
        row["kernels"][e["name"]] = row["kernels"].get(e["name"], 0) + 1
        if key and key not in row["modules"] and len(row["modules"]) < 8:
            row["modules"].append(key)
        if key:
            m = modules.setdefault(key, {"device_us": 0.0,
                                         "replays": 0, "kernels": 0})
            m["device_us"] += e["dur"]
            m["kernels"] += 1

    groups: Dict[Any, List[Dict[str, Any]]] = {}
    for e in td.device_events:
        ln = launches.get(e["corr"])
        if ln is None:
            add((), e, "")
        elif ln["graph"]:
            groups.setdefault(e["corr"], []).append(e)
        else:
            add(ln["labels"], e, ln["key"])
    for corr, evs in groups.items():
        key = launches[corr]["key"]
        replays += 1
        if key:
            modules.setdefault(key, {"device_us": 0.0, "replays": 0,
                                     "kernels": 0})["replays"] += 1
        table = plan_table(key) if key else None
        if not table:
            no_table += 1
            misaligned += len(evs)
            for e in evs:
                add((), e, key)
            continue
        labels, mis, gone, diffs = _align(table, [e["name"] for e in evs])
        misaligned += mis
        lost += gone
        if key:
            m = modules[key]
            m.setdefault("replay_kernels", []).append(len(evs))
            m["table_kernels"] = len(table)
            if diffs and "misaligned_sample" not in m:
                m["misaligned_sample"] = diffs
        for e, lab in zip(evs, labels):
            add(lab or (), e, key)

    total_s = total_us * 1e-6
    out_rows = sorted(rows.values(), key=lambda r: -r["device_s"])
    for r in out_rows:
        r["device_s"] = round(r["device_s"], 9)
        r["share"] = round(r["device_s"] / total_s, 4) if total_s else 0.0
        r["kernels"] = dict(sorted(r["kernels"].items(),
                                   key=lambda kv: -kv[1]))
    for key, m in modules.items():
        m["device_us"] = round(m["device_us"], 3)
        with _lock:
            ent = _plans.get(key)
        if ent is not None and ent["table_trace"]:
            m["table_trace"] = dict(ent["table_trace"])
        if "replay_kernels" in m:
            m["replay_kernels"] = m["replay_kernels"][:8]
        m["seg_key"] = key
        m["calls"] = int((calls_by_key or {}).get(key, 0))
        m["cost_flops"] = _plan_flops(key)
        if m["cost_flops"] and m["device_us"] and peak:
            m["mfu_measured"] = round(
                m["cost_flops"] * max(1, m["calls"])
                / (m["device_us"] * 1e-6) / peak, 9)
    return {
        "rows": out_rows,
        "modules": modules,
        "device_time_s": round(total_s, 9),
        "attributed_s": round(attributed_us * 1e-6, 9),
        "coverage": (round(attributed_us / total_us, 4)
                     if total_us else 0.0),
        "lost_records": int(lost),
        "misaligned": int(misaligned),
        "replays": replays,
        "replays_without_table": no_table,
    }
