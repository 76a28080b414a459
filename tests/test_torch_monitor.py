"""paddle_tpu_torch.monitor held against paddle_tpu.monitor in one process.

The same instrument calls go to both monitors: their Prometheus text,
snapshots, histogram quantiles and percentiles are identical, the
label-escaping golden holds in both, the same injected step walls make
the slow-step detector flag the same step with the same cause and text,
health aggregation and flight records (keys, rotation) match, and the
live plane's routes on 127.0.0.1 answer with JSON of the same shape.
The port's own contracts: the observability flags keep the JAX
defaults, the public names are the JAX monitor's less its collective
half (ROADMAP A12), the card's peak table is an H100 row only, and with
the monitor off nothing records, no ``record_function`` is entered and
``import paddle_tpu_torch`` never imports ``profiling``.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest

import paddle_tpu.monitor as jmon
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
import paddle_tpu_torch.monitor as pmon
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

MONS = (jmon, pmon)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OBS_FLAGS = ("monitor", "slow_step_factor", "slow_step_window",
             "monitor_ring", "monitor_port", "flight_record_dir",
             "flight_record_max_files", "flight_record_max_mb",
             "profile_steps", "profile_on_slow_step",
             "profile_slow_step_cooldown_s", "memory_budget_frac",
             "memory_budget_bytes", "profile_dir", "trace_ring",
             "generation_slo_ttft_ms", "generation_slo_itl_ms")

# the JAX monitor's collective half and cross-rank plane: ROADMAP A12
DEFERRED = {n: "A12" for n in (
    "record_collective", "clear_collective_registrations",
    "collective_registration_totals", "begin_collective_trace",
    "end_collective_trace", "record_segment_execute",
    "collectives_by_module", "peak_ici")}
# public names the port's monitor adds (the JAX module defines them but
# leaves them out of __all__)
PORT_EXTRAS = {"register_generation_provider",
               "unregister_generation_provider", "generation_plane"}


@pytest.fixture(autouse=True)
def _fresh():
    saved = {(f, id(F)): getattr(F, f) for F in (JFLAGS, PFLAGS)
             for f in OBS_FLAGS}
    for m in MONS:
        m.reset()
        m.enable()
    yield
    for m in MONS:
        m.disable()
        m.reset()
        m.stop_http()
        m._flight_last.clear()
    for F in (JFLAGS, PFLAGS):
        for f in OBS_FLAGS:
            setattr(F, f, saved[(f, id(F))])


def both(fn):
    """fn(monitor) on both monitors; the two results."""
    return fn(jmon), fn(pmon)


# ---------------------------------------------------------------------------
# flags and names
# ---------------------------------------------------------------------------

def test_observability_flags_keep_the_jax_defaults():
    from paddle_tpu.utils import flags as jflags
    from paddle_tpu_torch.utils import flags as pflags
    for f in OBS_FLAGS:
        assert pflags._DEFAULTS[f] == jflags._DEFAULTS[f], f


def test_public_names_are_the_jax_monitors_less_the_a12_half():
    jnames = set(jmon.__all__)
    assert set(DEFERRED) <= jnames
    assert set(pmon.__all__) == (jnames - set(DEFERRED)) | PORT_EXTRAS
    for n in pmon.__all__:
        assert hasattr(pmon, n), n
    for n in DEFERRED:
        assert not hasattr(pmon, n), n


# ---------------------------------------------------------------------------
# the registry and its exporters
# ---------------------------------------------------------------------------

def _drive(m):
    """A fixed sequence of instrument calls, label escaping included."""
    m.counter("req_total", {"code": "200"}).inc(3)
    m.counter("req_total", {"code": "500"}).inc()
    m.counter("esc_total", {"sig": 'a"b\\c\nd'}).inc()
    m.gauge("depth").set(5)
    m.gauge("ratio", {"k": "x"}).set(0.125)
    t = m.timer("lat_seconds", {"path": "p"})
    for v in (0.25, 0.5, 0.0625):
        t.observe(v)
    m.timer("empty_seconds")
    h = m.histogram("hist_seconds")
    rng = np.random.RandomState(0)
    for v in rng.uniform(0.0005, 0.5, 300):
        h.observe(float(v))
    for v in np.linspace(0.01, 1.0, 200):
        m.histogram("q_seconds", {"lane": "a"}).observe(float(v))
    m.counter("serving_requests_total").inc(7)
    m.counter("serving_batches_total").inc(3)
    m.counter("serving_request_rows_total").inc(9)
    m.counter("serving_padded_rows_total").inc(3)
    m.timer("serving_coalesced_rows").observe(9)
    m.histogram("serving_time_in_queue_seconds").observe(0.003)
    m.counter("executor_cache_hits_total").inc(4)
    m.counter("executor_cache_misses_total").inc(1)
    m.log_event("x", a=1)


def test_same_instrument_calls_give_identical_exports():
    for m in MONS:
        _drive(m)
    j, p = both(lambda m: m.prometheus_text())
    assert p == j
    j, p = both(lambda m: m.snapshot())
    assert p == j
    j, p = both(lambda m: (m.histogram("hist_seconds").quantile(0.5),
                           m.histogram("hist_seconds").quantile(0.99),
                           m.histogram_stats("q_seconds", {"lane": "a"}),
                           m.histogram("none_seconds").quantile(0.5),
                           m.percentile([3.0, 1.0, 2.0], 0.5),
                           m.percentile([], 0.5)))
    assert p == j
    j, p = both(lambda m: m.bench_summary())
    assert p == j
    j, p = both(lambda m: [{k: v for k, v in e.items() if k != "t"}
                           for e in m.events()])
    assert p == j


def test_label_escaping_golden_in_both():
    for m in MONS:
        m.counter("esc_total", {"sig": 'a"b\\c\nd'}).inc()
        text = m.prometheus_text()
        assert 'esc_total{sig="a\\"b\\\\c\\nd"} 1' in text
        assert 'a"b' not in text.replace('a\\"b', "")


@pytest.mark.parametrize("first,second", [
    ("gauge", "counter"), ("histogram", "timer"), ("timer", "histogram"),
    ("counter", "gauge")])
def test_type_conflict_rule_in_both(first, second):
    for m in MONS:
        getattr(m, first)(f"t_{first}_{second}", {"l": "1"})
        with pytest.raises(TypeError):
            getattr(m, second)(f"t_{first}_{second}", {"l": "2"})


def test_histogram_bucket_invariants_in_the_port():
    h = pmon.histogram("t_hist_seconds")
    vals = np.random.RandomState(0).uniform(0.0005, 0.5, 500)
    for v in vals:
        h.observe(float(v))
    lines = [ln for ln in pmon.prometheus_text().splitlines()
             if ln.startswith("t_hist_seconds_bucket")]
    cum = [float(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert cum == sorted(cum)
    assert 'le="+Inf"' in lines[-1] and cum[-1] == 500
    with pmon.timer("t_span_seconds").time():
        pass
    assert pmon.timer("t_span_seconds").count == 1


def test_jsonl_and_chrome_counter_events_same_shape(tmp_path):
    for m in MONS:
        for i, wall in enumerate((0.01, 0.012, 0.011)):
            m.record_step(wall=wall, examples=8, key="k",
                          retrace="first compile" if i == 0 else None)
        m.note_compile("first compile", "v0.seg0", 0.5)
    j = jmon.dump_jsonl(str(tmp_path / "j.jsonl"))
    p = pmon.dump_jsonl(str(tmp_path / "p.jsonl"))
    assert p == j

    def shape(path):
        out = []
        for ln in open(path):
            d = json.loads(ln)
            out.append((d["ev"], sorted(d)))
        return out

    assert shape(tmp_path / "p.jsonl") == shape(tmp_path / "j.jsonl")
    j, p = both(lambda m: [(e["name"], e["ph"], sorted(e["args"]))
                           for e in m.chrome_counter_events(0.0)])
    assert p == j


# ---------------------------------------------------------------------------
# step telemetry and the slow-step detector
# ---------------------------------------------------------------------------

def _slow_case(m, cause):
    """Five like steps at 10 ms, then one at 100 ms with ``cause``'s
    evidence injected; returns the warnings' texts."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(5):
            m.record_step(wall=0.010, examples=4, key="v1.K1.b4")
        kw = {}
        if cause == "retrace":
            kw["retrace"] = "new batch size"
        elif cause == "fetch":
            kw["fetch_block_s"] = 0.08
        elif cause == "host":
            m.counter("executor_host_op_fallbacks_total",
                      {"op": "print"}).inc()
        elif cause == "starvation":
            m.timer("dataloader_starvation_seconds").observe(0.09)
        elif cause == "peak":
            kw.update(flops=2e9, peak=1e12)
        m.record_step(wall=0.100, examples=4, key="v1.K1.b4", **kw)
        # a repeat of the same class and cause is suppressed and tallied
        m.record_step(wall=0.100, examples=4, key="v1.K1.b4", **kw)
    return [str(w.message) for w in rec
            if "slow step" in str(w.message)]


@pytest.mark.parametrize("cause", ["retrace", "fetch", "host",
                                   "starvation", "unknown", "peak"])
def test_slow_step_flags_the_same_step_with_the_same_cause(cause):
    j, p = both(lambda m: _slow_case(m, cause))
    # the first slow step warns; a repeat warns again only when its
    # cause differs (a host op or starvation delta is per step)
    assert j and len(j) == (2 if cause in ("host", "starvation") else 1)
    assert p == j
    j, p = both(lambda m: m.snapshot().get(
        'slow_step_suppressed_total{cause="' + p[0].split("(", 1)[1]
        .split(")", 1)[0] + '",key="v1.K1.b4"}'))
    assert p == j
    j, p = both(lambda m: [{k: v for k, v in r.items() if k != "t"}
                           for r in m.step_records()])
    assert p == j


# ---------------------------------------------------------------------------
# health, flight records and the live plane
# ---------------------------------------------------------------------------

class _Comp:
    def __init__(self, h):
        self.h = h

    def health(self):
        return self.h


def test_health_aggregation_matches():
    comps = [_Comp({"breaker": "closed", "dispatcher_alive": True}),
             _Comp({"breaker": "open"}), _Comp({"healthy": True})]

    def boom():
        raise RuntimeError("down")

    for m in MONS:
        for i, c in enumerate(comps):
            m.register_health(f"c{i}", c.health)
        m.register_health("boom", boom)
    j, p = both(lambda m: m.healthz())
    assert p == j and p["status"] == "degraded"
    for m in MONS:
        m.unregister_health("c1")
        m.unregister_health("boom")
    j, p = both(lambda m: m.healthz())
    assert p == j and p["status"] == "ok"
    for m in MONS:
        for i in range(3):
            m.unregister_health(f"c{i}")


def test_flight_record_keys_and_rotation_match(tmp_path):
    dirs = {}
    for m, F, name in ((jmon, JFLAGS, "j"), (pmon, PFLAGS, "p")):
        d = tmp_path / name
        dirs[name] = d
        F.flight_record_dir = str(d)
        F.flight_record_max_files = 2
        m.record_step(wall=0.01, examples=1, key="k")
        m.register_health("x", _Comp({"healthy": True}).health)
        for i, reason in enumerate(("oom", "circuit_open", "nan_check")):
            m._flight_last.clear()
            os.utime(d, None) if d.exists() else None
            path = m.flight_record(
                reason, trace={"trace_id": "t0", "spans": []},
                extra={"error": "e", "n": i})
            assert path is not None
            # distinct mtimes, oldest first (rotation evicts by mtime)
            os.utime(path, (1000 + i, 1000 + i))
        m.unregister_health("x")

    def lines(name):
        files = sorted(os.listdir(dirs[name]))
        out = []
        for f in files:
            rows = [json.loads(ln) for ln in open(dirs[name] / f)]
            out.append([(r["ev"], sorted(r)) for r in rows])
        return [f.split("-", 2)[2] for f in files], out

    jf, jl = lines("j")
    pf, pl = lines("p")
    assert pf == jf and len(pf) == 2  # rotated down to max_files
    assert pl == jl
    j, p = both(lambda m: (
        m.snapshot().get('flight_records_total{reason="oom"}'),
        m.snapshot().get("flight_records_evicted_total")))
    assert p == j


def test_flight_record_disabled_without_a_directory():
    for F in (JFLAGS, PFLAGS):
        F.flight_record_dir = ""
    j, p = both(lambda m: m.flight_record("oom"))
    assert j is None and p is None


def _get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _shape(v):
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in sorted(v.items())}
    if isinstance(v, list):
        return [_shape(x) for x in v[:1]]
    return type(v).__name__


@pytest.mark.parametrize("route", ["/metrics", "/healthz", "/vars",
                                   "/trace/t-unknown", "/generation",
                                   "/profile?steps=x", "/nowhere"])
def test_http_routes_answer_with_the_same_shape(route):
    ports = {}
    for m in MONS:
        _drive(m)
        m.register_health("c", _Comp({"healthy": True}).health)
        ports[m] = m.serve_http(port=0).server_port
    (jc, jb), (pc, pb) = _get(ports[jmon], route), _get(ports[pmon], route)
    assert pc == jc
    if route == "/metrics":
        # equal but for the bound port each plane gauges
        assert [ln for ln in pb.splitlines() if "http_port " not in ln] \
            == [ln for ln in jb.splitlines() if "http_port " not in ln]
    elif jb.startswith(("{", "[")):
        assert _shape(json.loads(pb)) == _shape(json.loads(jb))
    for m in MONS:
        m.unregister_health("c")


def test_trace_route_by_query_and_memory_route():
    port = pmon.serve_http(port=0).server_port
    pmon.register_trace_provider(
        "t", lambda tid: {"trace_id": tid} if tid == "t7" else None)
    assert json.loads(_get(port, "/trace?id=t7")[1]) == {"trace_id": "t7"}
    assert json.loads(_get(port, "/trace/t7")[1]) == {"trace_id": "t7"}
    assert _get(port, "/trace?id=t8")[0] == 404
    code, body = _get(port, "/memory")
    assert code == 200
    mem = json.loads(body)
    assert {"devices", "budget_bytes", "budget_source",
            "executables"} <= set(mem)
    pmon.unregister_trace_provider("t")


# ---------------------------------------------------------------------------
# device truth
# ---------------------------------------------------------------------------

def test_peak_tables_h100_row_cpu_nominal_and_unknown(monkeypatch):
    import jax
    jdev = jax.devices("cpu")[0]
    assert pmon.peak_flops("cpu") == jmon.peak_flops(jdev)
    assert pmon.peak_membw("cpu") == jmon.peak_membw(jdev)
    monkeypatch.setattr(pmon, "_device_of",
                        lambda dev: ("cuda", "NVIDIA H100 80GB HBM3"))
    assert pmon.peak_flops() == (989e12, "NVIDIA H100 80GB HBM3")
    assert pmon.peak_flops(dtype="tf32")[0] == 495e12
    assert pmon.peak_flops(dtype="float32")[0] == 67e12
    assert pmon.peak_membw()[0] == 3.35e12
    monkeypatch.setattr(pmon, "_device_of",
                        lambda dev: ("cuda", "Some Other GPU"))
    assert pmon.peak_flops() == (0.0, "unknown-device(Some Other GPU)")
    assert pmon.peak_membw() == (0.0, "unknown-device(Some Other GPU)")


def test_memory_gauges_read_nothing_on_the_cpu():
    pmon.update_memory_gauges(every=1)
    assert pmon.device_memory_snapshot(refresh=True) == {}
    assert not any(k.startswith("device_") for k in pmon.snapshot())


# ---------------------------------------------------------------------------
# the disabled path
# ---------------------------------------------------------------------------

def _tiny_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4], dtype="float32")
        y = pt.layers.fc(x, size=3, act="relu")
        loss = pt.layers.mean(y)
        pt.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_disabled_path_records_nothing_and_enters_no_record_function(
        monkeypatch):
    import torch
    pmon.disable()
    pmon.record_step(wall=1.0, examples=10)
    pmon.log_event("x")
    pmon.update_memory_gauges(every=1)
    assert pmon.step_records() == [] and pmon.events() == []
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    main, startup, loss = _tiny_program()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    feed = {"x": np.ones((2, 4), np.float32)}
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss])
    assert entered == []
    assert pmon.snapshot() == {}
    pmon.enable()
    exe.run(main, feed=feed, fetch_list=[loss])
    assert any(n.startswith("mul.") for n in entered)
    assert pmon.snapshot()["executor_cache_hits_total"] == 1


def test_import_never_imports_profiling_with_the_monitor_off():
    code = ("import sys, paddle_tpu_torch as pt, numpy as np\n"
            "m, s = pt.Program(), pt.Program()\n"
            "with pt.program_guard(m, s):\n"
            "    x = pt.layers.data(name='x', shape=[4], dtype='float32')\n"
            "    y = pt.layers.mean(pt.layers.fc(x, size=2))\n"
            "e = pt.Executor(pt.CPUPlace()); e.run(s)\n"
            "e.run(m, feed={'x': np.ones((2, 4), np.float32)},"
            " fetch_list=[y])\n"
            "print(sorted(n for n in sys.modules"
            " if n.startswith('paddle_tpu_torch.profiling')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("FLAGS_monitor", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
