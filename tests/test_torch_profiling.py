"""The port's profiler and measured profiling (``paddle_tpu_torch/
profiler.py``, ``profiling/``), on the CPU.

Against the JAX package: equal RecordEvent spans give the same sorted
report and the same chrome trace, and ``profiler.proto`` files cross-load
(the JAX package's written and the port's read, and back).

Attribution runs on a synthetic trace built here in the chrome-trace
shape ``torch.profiler`` exports (kernel, cuda_runtime and
user_annotation events with correlation ids): an eager segment run whose
launches sit inside op labels (direct rows), a launch under a composite
label (a fusion row), a launch under no label (an unattributed row), a
launch from another thread (the autograd engine's) while the executor's
thread is inside an op's range (that op's), a launch with no kernel
record (a lost record) and one made during a capture (not lost), a
replay that aligns with the plan's labelled kernel table, and a replay
that does not (counted misaligned and lost, never guessed). Then sessions on the CPU executor end to end (a step-counted
window armed and started on the executor's thread, the report, the
gauges), their exclusivity, the ``/profile`` route from the HTTP thread,
``FLAGS.profile_steps`` and the slow-step escalation. No test sleeps on
the wall clock.
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

from paddle_tpu import profiler as jprof

import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor as pmon
from paddle_tpu_torch import profiler as pprof
from paddle_tpu_torch.profiling import attribution, session, trace_parse
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS


@pytest.fixture(autouse=True)
def _clean():
    for p in (jprof, pprof):
        p.reset_profiler()
    old = (PFLAGS.profile_steps, PFLAGS.profile_on_slow_step,
           PFLAGS.flight_record_dir, PFLAGS.profile_slow_step_cooldown_s)
    pmon.reset()
    pmon.enable()
    yield
    for p in (jprof, pprof):
        p._enabled = False
        p._events.clear()
    (PFLAGS.profile_steps, PFLAGS.profile_on_slow_step,
     PFLAGS.flight_record_dir, PFLAGS.profile_slow_step_cooldown_s) = old
    sess = session.active_session()
    if sess is not None:
        sess.finish()
    pmon.disable()
    pmon.reset()
    pmon._profile_auto = -1
    pmon.stop_http()


# ---------------------------------------------------------------------------
# the host profiler against the JAX package's
# ---------------------------------------------------------------------------

SPANS = {"alpha": [(0.001, 0.004, None, 11, "MainThread"),
                   (0.005, 0.006, {"iterations": 4}, 11, "MainThread")],
         "beta": [(0.002, 0.0035, None, 12, "loader")]}


def _load_spans(p):
    p._events.clear()
    for name, spans in SPANS.items():
        p._events[name].extend(spans)


@pytest.mark.parametrize("key", [None, "calls", "total", "max", "min",
                                 "ave"])
def test_equal_spans_give_the_same_sorted_report(key):
    out = []
    for p in (jprof, pprof):
        _load_spans(p)
        buf = io.StringIO()
        with redirect_stdout(buf):
            p._print_report(key)
        out.append(buf.getvalue())
    assert out[1] == out[0] and "alpha" in out[0]


def test_equal_spans_give_the_same_chrome_trace_and_proto(tmp_path):
    for p, name in ((jprof, "j"), (pprof, "p")):
        _load_spans(p)
        p._dump_chrome_trace(str(tmp_path / f"{name}.json"))
        p.dump_profile_proto(str(tmp_path / f"{name}.pb"))
    assert json.load(open(tmp_path / "p.json")) == json.load(
        open(tmp_path / "j.json"))
    assert (tmp_path / "p.pb").read_bytes() == (tmp_path / "j.pb"
                                                ).read_bytes()


def test_profile_protos_cross_load(tmp_path):
    for p in (jprof, pprof):
        p.start_profiler("CPU")
        for n in ("alpha", "beta"):
            with p.RecordEvent(n):
                pass
        p.stop_profiler(profile_path=str(tmp_path / (
            "j" if p is jprof else "p")))
    for writer in ("j", "p"):
        path = str(tmp_path / f"{writer}.pb")
        assert pprof.load_profile_proto(path) == \
            jprof.load_profile_proto(path)
        names = sorted(e["name"] for e in
                       pprof.load_profile_proto(path)["events"])
        assert names == ["alpha", "beta"]
    body = pprof._encode_event("ev", 10, 20, device_id=-7)
    path = tmp_path / "neg.pb"
    path.write_bytes(pprof._field(1, 2) + pprof._varint(len(body)) + body)
    assert jprof.load_profile_proto(str(path))["events"][0][
        "device_id"] == pprof.load_profile_proto(str(path))["events"][0][
        "device_id"] == -7


def test_cuda_profiler_brackets_the_body(monkeypatch):
    import torch.cuda.profiler as cp
    calls = []
    monkeypatch.setattr(cp, "start", lambda: calls.append("start"))
    monkeypatch.setattr(cp, "stop", lambda: calls.append("stop"))
    with pprof.cuda_profiler("out.nsys-rep"):
        calls.append("body")
    assert calls == ["start", "body", "stop"]
    with pytest.raises(ValueError):
        with pprof.cuda_profiler("out"):
            raise ValueError("inside")
    assert calls[-1] == "stop"


# ---------------------------------------------------------------------------
# attribution on a synthetic torch.profiler trace
# ---------------------------------------------------------------------------

HOST, AUTOGRAD, GPU = (1, 10), (1, 11), (0, 7)
KEY = "v3.seg0.K1.sig000001"


def _x(ph, cat, name, ts, dur, pid_tid, **args):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid_tid[0], "tid": pid_tid[1], "args": args}


def _synthetic_trace():
    ev = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 10,
           "args": {"name": "python"}}]
    ann = lambda name, ts, dur: _x("X", "user_annotation", name, ts, dur,
                                   HOST)
    launch = lambda name, ts, corr, th=HOST: _x(
        "X", "cuda_runtime", name, ts, 2, th, correlation=corr)
    kern = lambda name, ts, dur, corr: _x("X", "kernel", name, ts, dur,
                                          GPU, correlation=corr, stream=7,
                                          device=0)
    # the eager (warm-up) run of the segment
    ev += [ann("ptseg:" + KEY, 0, 100), ann("mul.x", 10, 20),
           ann("relu.y", 30, 20), ann("elementwise_add.z+relu.w", 50, 20),
           ann("ptcapture:" + KEY, 84, 4)]
    ev += [launch("cudaLaunchKernel", 12, 1), kern("gemm", 110, 5.0, 1),
           launch("cudaLaunchKernel", 32, 2), kern("relu_k", 116, 2.0, 2),
           # the autograd engine's thread, inside relu.y's range
           launch("cudaLaunchKernel", 40, 7, AUTOGRAD),
           kern("relu_bwd_k", 118.2, 0.5, 7),
           launch("cudaLaunchKernelExC", 52, 3),
           kern("add_relu_k", 119, 3.0, 3),
           launch("cudaLaunchKernel", 80, 4), kern("copy_k", 123, 1.0, 4),
           # a launch whose kernel record is missing: lost
           launch("cudaLaunchKernel", 90, 5),
           # a launch during capture issues no kernel: not lost
           launch("cudaLaunchKernel", 85, 6)]
    # replay 1: the table's kernels in order
    ev += [ann("ptreplay:" + KEY, 200, 10),
           launch("cudaGraphLaunch", 201, 10)]
    ev += [kern(n, 220 + i * 6, d, 10) for i, (n, d) in enumerate(
        (("gemm", 5.0), ("relu_k", 2.0), ("relu_bwd_k", 0.5),
         ("add_relu_k", 3.0), ("copy_k", 1.0)))]
    # replay 2: relu_k, relu_bwd_k and copy_k lost, an unknown kernel in
    # between
    ev += [ann("ptreplay:" + KEY, 300, 10),
           launch("cudaGraphLaunch", 301, 11)]
    ev += [kern(n, 320 + i * 6, d, 11) for i, (n, d) in enumerate(
        (("gemm", 5.0), ("other_k", 4.0), ("add_relu_k", 3.0)))]
    return {"traceEvents": ev}


def _synthetic(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_synthetic_trace()))
    return trace_parse.parse_trace_dir(str(tmp_path))


def test_trace_parse_reads_the_torch_profiler_shape(tmp_path):
    td = _synthetic(tmp_path)
    assert td.platform == "cuda" and td.path.endswith("trace.json")
    assert len(td.device_events) == 13
    assert td.total_device_us == pytest.approx(
        11.5 + 11.5 + 12.0)
    assert td.lost_launches() == 1
    assert td.threads[(1, 10)] == "python"
    assert trace_parse.parse_trace_dir(str(tmp_path / "none")
                                       ).device_events == []


def test_plan_table_from_the_eager_run(tmp_path):
    td = _synthetic(tmp_path)
    table = attribution.table_from_trace(td, KEY)
    assert table == [("gemm", ("mul.x",)), ("relu_k", ("relu.y",)),
                     ("relu_bwd_k", ("relu.y",)),
                     ("add_relu_k", ("elementwise_add.z", "relu.w")),
                     ("copy_k", ())]
    assert attribution.table_from_trace(td, "v9.seg0") is None


def test_attribution_rows_coverage_lost_and_misaligned(tmp_path):
    td = _synthetic(tmp_path)
    attribution.register_plan(KEY, flops=1e6,
                              table=attribution.table_from_trace(td, KEY))
    rep = attribution.attribute(td, peak=1e12, calls_by_key={KEY: 3})
    rows = {r["op"]: r for r in rep["rows"]}
    assert rows["mul.x"]["source"] == "direct"
    assert rows["mul.x"]["calls"] == 3                  # eager + 2 replays
    assert rows["mul.x"]["kernels"] == {"gemm": 3}
    assert rows["relu.y"]["calls"] == 4                 # lost in replay 2
    assert rows["relu.y"]["kernels"] == {"relu_k": 2, "relu_bwd_k": 2}
    fused = rows["fusion[elementwise_add.z+relu.w]"]
    assert fused["source"] == "fusion_multi" and fused["calls"] == 3
    assert rows["unattributed:copy_k"]["calls"] == 2
    assert rows["unattributed:other_k"]["calls"] == 1
    assert rep["misaligned"] == 1
    assert rep["lost_records"] == 1 + 3  # a launch; 3 table entries
    assert rep["replays"] == 2 and rep["replays_without_table"] == 0
    attributed = 3 * 5.0 + 2 * 2.5 + 3 * 3.0
    assert rep["coverage"] == round(attributed / 35.0, 4)
    mod = rep["modules"][KEY]
    assert mod["replays"] == 2 and mod["calls"] == 3
    assert mod["replay_kernels"] == [5, 3] and mod["table_kernels"] == 5
    assert mod["mfu_measured"] == round(3e6 / 35e-6 / 1e12, 9)


def test_a_replay_without_a_table_is_unattributed_not_guessed(tmp_path):
    td = _synthetic(tmp_path)
    attribution._plans.pop(KEY, None)
    rep = attribution.attribute(td)
    assert rep["replays_without_table"] == 2
    assert rep["misaligned"] == 8
    assert not any(r["op"] == "mul.x" and r["calls"] > 1
                   for r in rep["rows"])


def test_program_label_reads_registered_types():
    assert attribution.program_label("mul.fc_0.tmp_0") == ["mul.fc_0.tmp_0"]
    assert attribution.program_label("mul_grad.x_GRAD") == [
        "mul_grad.x_GRAD"]
    assert attribution.program_label("a.x+relu.y") is None
    assert attribution.program_label("aten::mm") is None
    assert attribution.program_label("ptseg:v1") is None


# ---------------------------------------------------------------------------
# sessions on the CPU executor
# ---------------------------------------------------------------------------

def _train():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8], dtype="float32")
        h = pt.layers.fc(x, size=16, act="relu")
        loss = pt.layers.mean(pt.layers.fc(h, size=1))
        pt.optimizer.SGD(0.01).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    feed = {"x": np.ones((4, 8), np.float32)}
    exe.run(main, feed=feed, fetch_list=[loss])
    return exe, main, feed, loss


def test_step_window_session_end_to_end(tmp_path):
    exe, main, feed, loss = _train()
    sess = pmon.profile_session(steps=2, trace_dir=str(tmp_path))
    assert session.active_session() is sess and sess._prof is None
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss])
    assert sess.wait(0) and session.active_session() is None
    rep = sess.result
    assert rep is pmon.last_profile() and rep["steps"] == 2
    assert rep["platform"] == "cpu" and rep["coverage"] > 0.5
    ops = {r["op"].split(".", 1)[0] for r in rep["rows"]
           if r["source"] == "direct"}
    assert {"mul", "mul_grad", "sgd"} <= ops
    (mod,) = rep["modules"].values()
    assert mod["calls"] == 2 and mod["cost_flops"] > 0
    snap = pmon.snapshot()
    assert snap["profile_attribution_coverage"] == rep["coverage"]
    assert snap["profile_captures_total"] == 1
    assert any(k.startswith("executor_devtime_seconds{op=") for k in snap)
    assert any(k.startswith("executor_mfu_measured") for k in snap)
    on_disk = json.load(open(tmp_path / "device_profile.json"))
    assert on_disk["coverage"] == rep["coverage"]


def test_manual_session_and_exclusivity(tmp_path):
    import torch
    exe, main, feed, loss = _train()
    with pmon.profile_session() as sess:
        exe.run(main, feed=feed, fetch_list=[loss])
        with pytest.raises(RuntimeError, match="already active"):
            pmon.profile_session(steps=1)
        with pytest.raises(RuntimeError, match="already active"):
            session.start_session()
    assert sess.result["rows"] and session.active_session() is None
    armed = pmon.profile_session(steps=8)
    with pytest.raises(RuntimeError, match="already active"):
        pmon.profile_session(steps=1)
    assert not session.claim_private()
    assert armed.finish() is not None
    assert session.active_session() is None
    # a caller's own torch profiler excludes a session too
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="already active"):
            session.start_session()
    assert session.claim_private()
    session.release_private()


def test_step_windows_need_the_monitor():
    pmon.disable()
    with pytest.raises(RuntimeError, match="monitor"):
        pmon.profile_session(steps=2)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_profile_route_from_the_http_thread():
    """GET /profile arms a window from the HTTP thread; the executor's
    thread starts it at its next run and closes it after N steps."""
    exe, main, feed, loss = _train()
    port = pmon.serve_http(port=0).server_port
    got = {}
    t = threading.Thread(target=lambda: got.update(
        r=_get(port, "/profile?steps=2&timeout_s=120")))
    t.start()
    while session.active_session() is None and t.is_alive():
        t.join(0.001)
    for _ in range(4):
        exe.run(main, feed=feed, fetch_list=[loss])
    t.join(120)
    code, body = got["r"]
    assert code == 200
    rep = json.loads(body)
    assert rep["steps"] == 2 and rep["rows"]
    assert any(r["op"].startswith("mul.") for r in rep["rows"])
    pmon.disable()
    assert _get(port, "/profile?steps=1")[0] == 503


def test_flags_profile_steps_captures_the_first_steps():
    exe, main, feed, loss = _train()
    PFLAGS.profile_steps = 2
    pmon._profile_auto = -1
    for _ in range(5):
        exe.run(main, feed=feed, fetch_list=[loss])
    rep = pmon.last_profile()
    assert rep is not None and rep["steps"] == 2 and rep["rows"]
    assert rep.get("trace_dir_removed") is True


def test_slow_step_escalation_attaches_a_flight_record(tmp_path):
    exe, main, feed, loss = _train()
    PFLAGS.profile_on_slow_step = True
    PFLAGS.profile_slow_step_cooldown_s = 0.0
    PFLAGS.flight_record_dir = str(tmp_path)
    pmon._flight_last.clear()
    for _ in range(4):
        pmon.record_step(wall=0.01, key="k")
    with pytest.warns(UserWarning, match="slow step"):
        pmon.record_step(wall=1.0, key="k")
    sess = session.active_session()
    assert sess is not None and sess.steps == 3
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss])
    assert sess.wait(0)
    (name,) = [n for n in os.listdir(tmp_path) if "slow_step_profile" in n]
    meta = json.loads(open(tmp_path / name).readline())
    assert meta["trigger_reason"] == "unknown"
    assert meta["device_profile"]["steps"] == 3
    assert meta["device_profile"]["top"]
