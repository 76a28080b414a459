"""The port's serving front (``paddle_tpu_torch/inference/serving.py``)
against the JAX package's and against itself, on the CPU, over one
``save_mlp`` directory the JAX package wrote (6 -> 16 -> 5, softmax).

Against the JAX package: the bucket ladder's math over a grid of request
sizes and ladders (equal), ``save_mlp``'s ``__model__`` (byte-identical),
the config knobs' signatures and the wrapped types, the exported names,
and the same numpy requests through both packages' ``BucketedPredictor``
and ``BatchingPredictor``: outputs within 1e-6 relative (fp32; the two
differ only in the order of a few float32 sums).

Against the port itself: bucketed and coalesced results bitwise equal to
the port's own unbatched predictor (at these widths a product's rows do
not depend on the batch it is in, on this CPU), and always bitwise equal
to the wrapped predictor's run of the same zero-padded bucket feed. What
the JAX tests read from the monitor is read here from ``health()``, the
wrapped executor's plans (one per bucket) and ``Executor.capture_stats``.

The executor under threads (ROADMAP C3): several threads on one plan and
on a predictor's ``clone()`` each get their own request's rows, equal to
the serial run's.

With the monitor on (the last section): tests/test_serving.py's
``test_request_trace_complete_chain``,
``test_trace_records_deadline_expiry``,
``test_retrace_classifier_batch_vs_feature_shape``, the hit, miss, pad
and oversize counters of ``test_bucketed_parity_and_hit_miss_counters``
and ``test_oversize_batch_chunks_correctly``, the same requests through
both packages giving equal ``serving_*`` counters, and the front's health
on ``/healthz``. ``test_trace_disabled_when_monitor_off`` is carried over
as ``trace_id`` being None and nothing traced.
"""

import inspect
import sys
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import inference as jinference
from paddle_tpu.inference import serving as jserving
from paddle_tpu.testing.models import save_mlp as jax_save_mlp

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference as pinference
from paddle_tpu_torch.inference import serving as pserving
from paddle_tpu_torch.testing.models import save_mlp

RTOL = 1e-6


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return jax_save_mlp(str(tmp_path_factory.mktemp("serving") / "model"))


def _cfg(d):
    return pinference.AnalysisConfig(d, use_gpu=False)


def _x(rows, in_dim=6, seed=0):
    return np.random.RandomState(seed).rand(rows, in_dim).astype(np.float32)


def _out(pred, x):
    return pred.run({"x": x})[0].as_ndarray()


def _base(pred):
    """The Native/Analysis predictor under the serving wrappers."""
    while isinstance(pred, (pserving.BatchingPredictor,
                            pserving.BucketedPredictor)):
        pred = getattr(pred, "_pred", None) or pred._base
    return pred


def _plans(pred):
    """The wrapped executor's plans of the predictor's program: one per
    feed signature, so one per bucket."""
    return _base(pred)._program.__dict__.get("_exec_cache", {})


def _runs(pred):
    """Device calls of the wrapped predictor: the runs of its plans."""
    return sum(p.runs for p in _plans(pred).values())


# ---------------------------------------------------------------------------
# ladder math, the builder, the API surface: against the JAX package
# ---------------------------------------------------------------------------

def test_bucket_ladder_selection():
    lad = pserving.BucketLadder([4, 2, 8, 4])  # dedup + sort
    assert lad.buckets == (2, 4, 8)
    assert lad.bucket_for(1) == 2
    assert lad.bucket_for(2) == 2
    assert lad.bucket_for(3) == 4
    assert lad.bucket_for(8) == 8
    assert lad.bucket_for(9) is None  # oversize: caller chunks
    assert lad.chunks(5) == [5]
    assert lad.chunks(8) == [8]
    assert lad.chunks(9) == [8, 1]
    assert lad.chunks(24) == [8, 8, 8]
    assert lad.chunks(19) == [8, 8, 3]
    with pytest.raises(ValueError):
        lad.chunks(0)
    with pytest.raises(ValueError):
        pserving.BucketLadder([])
    with pytest.raises(ValueError):
        pserving.BucketLadder([0, 2])


@pytest.mark.parametrize("ladder", [(1,), (2, 4, 8), (3, 5, 7), (4, 8, 16, 32),
                                    pserving.DEFAULT_BATCH_BUCKETS])
def test_bucket_ladder_matches_jax(ladder):
    assert pserving.DEFAULT_BATCH_BUCKETS == jserving.DEFAULT_BATCH_BUCKETS
    p, j = pserving.BucketLadder(ladder), jserving.BucketLadder(ladder)
    assert p.buckets == j.buckets and p.top == j.top
    for n in range(1, 150):
        assert p.bucket_for(n) == j.bucket_for(n), n
        assert p.chunks(n) == j.chunks(n), n


def test_save_mlp_writes_the_jax_builders_model(tmp_path):
    for kw in ({}, {"in_dim": 4, "hidden": 8, "depth": 2, "classes": 3}):
        pdir = save_mlp(str(tmp_path / f"p{len(kw)}"), **kw)
        jdir = jax_save_mlp(str(tmp_path / f"j{len(kw)}"), **kw)
        with open(f"{pdir}/__model__", "rb") as f, \
                open(f"{jdir}/__model__", "rb") as g:
            assert f.read() == g.read()
        # the same parameter files; values differ (the packages' random
        # streams differ), shapes and names do not
        port = pinference.create_paddle_predictor(_cfg(pdir))
        jax = jinference.create_paddle_predictor(
            jinference.AnalysisConfig(jdir))
        want = sorted(f"fc_{i}.{p}_0" for i in range(kw.get("depth", 1) + 1)
                      for p in "wb")
        assert sorted(port._scope.var_names()) == want
        for n in want:
            assert tuple(port._scope.find_var(n).shape) == \
                np.shape(jax._scope.find_var(n))


@pytest.mark.parametrize("knob", ["enable_shape_bucketing",
                                  "enable_request_coalescing"])
def test_config_knobs_take_the_jax_signatures(knob):
    jsig = inspect.signature(getattr(jinference.NativeConfig, knob))
    psig = inspect.signature(getattr(pinference.NativeConfig, knob))
    assert [(p.name, p.default) for p in psig.parameters.values()] == \
        [(p.name, p.default) for p in jsig.parameters.values()]
    jcfg, pcfg = jinference.AnalysisConfig("d"), pinference.AnalysisConfig("d")
    assert getattr(pcfg, knob)() is pcfg
    getattr(jcfg, knob)()
    assert (pcfg.bucket_config, pcfg.coalesce_config) == \
        (jcfg.bucket_config, jcfg.coalesce_config)


def test_create_paddle_predictor_wraps_as_the_jax_package(model_dir):
    plain = pinference.create_paddle_predictor(_cfg(model_dir))
    assert type(plain) is pinference.AnalysisPredictor
    b = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing())
    assert type(b) is pinference.BucketedPredictor
    assert b.batch_buckets == pserving.DEFAULT_BATCH_BUCKETS
    c = pinference.create_paddle_predictor(
        pinference.NativeConfig(model_dir, use_gpu=False)
        .enable_shape_bucketing().enable_request_coalescing())
    try:
        assert type(c) is pinference.BatchingPredictor
        assert type(c._pred) is pinference.BucketedPredictor
        assert type(c._pred._base) is pinference.NativePredictor
        assert c.get_input_names() == ["x"]
    finally:
        c.shutdown()


def test_inference_exports_the_jax_names():
    waiting = {"CppPredictor"}  # ROADMAP A13
    assert sorted(pinference.__all__) == sorted(
        set(jinference.__all__) - waiting)
    assert sorted(pserving.__all__) == sorted(jserving.__all__)


# ---------------------------------------------------------------------------
# bucketed predictor
# ---------------------------------------------------------------------------

def test_bucketed_matches_jax(model_dir):
    jcfg = jinference.AnalysisConfig(model_dir).enable_shape_bucketing(
        batch_buckets=(2, 4))
    jpred = jinference.create_paddle_predictor(jcfg)
    ppred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(2, 4)))
    for rows in (1, 3, 4, 7, 10):
        x = _x(rows, seed=rows)
        got, want = _out(ppred, x), _out(jpred, x)
        assert got.shape == want.shape == (rows, 5)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_bucketed_parity_and_plans(model_dir):
    plain = pinference.create_paddle_predictor(_cfg(model_dir))
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(2, 4)))
    assert isinstance(pred, pinference.BucketedPredictor)
    x = _x(3)
    got = _out(pred, x)
    assert got.shape == (3, 5)  # sliced back to the TRUE 3 rows
    np.testing.assert_array_equal(got, _out(plain, x))
    # bitwise the wrapped predictor's run of the zero-padded bucket feed
    padded = np.concatenate([x, np.zeros((1, 6), np.float32)])
    np.testing.assert_array_equal(got, _out(pred._base, padded)[:3])
    assert pred.health()["warm_buckets"] == ["b4"]
    assert len(_plans(pred)) == 1
    # a second request of that bucket is a hit: no new plan
    _out(pred, _x(4, seed=1))
    assert len(_plans(pred)) == 1 and _runs(pred) == 3
    assert pred.health()["degraded_buckets"] == []


def test_exact_bucket_size_pads_zero_bytes(model_dir, monkeypatch):
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(2, 4)))
    fed = []
    run = pred._base.run
    monkeypatch.setattr(pred._base, "run",
                        lambda feed: fed.append(feed) or run(feed))
    x = _x(4)
    pred.run({"x": x})
    # the request itself reached the predictor: no pad row, no copy
    assert fed[0]["x"].shape == (4, 6) and np.shares_memory(fed[0]["x"], x)
    pred.run({"x": _x(3)})
    assert fed[1]["x"].shape == (4, 6) and not fed[1]["x"][3].any()


def test_oversize_batch_chunks_correctly(model_dir):
    plain = pinference.create_paddle_predictor(_cfg(model_dir))
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(2, 4)))
    x = _x(10)  # > top bucket 4: chunks 4+4+2
    got = _out(pred, x)
    assert got.shape[0] == 10
    np.testing.assert_array_equal(got, _out(plain, x))
    # chunk rows 4, 4, 2 land in buckets b4, b4, b2: the ladder caps the
    # plan set at 2 shapes for ANY request size
    assert len(_plans(pred)) == 2 and _runs(pred) == 3
    assert pred.health()["warm_buckets"] == ["b2", "b4"]


def test_single_warm_bucket_serves_mixed_sizes_no_new_plans(model_dir):
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(8,)))
    took = pred.warmup()
    assert set(took) == {"b8"} and took["b8"] > 0
    # warmup ran the cell twice: the plan's warm-up and its capture run
    assert len(_plans(pred)) == 1 and _runs(pred) == 2
    stats = dict(_base(pred)._exe.capture_stats)
    for rows in (1, 3, 5, 8, 2, 7):  # >= 3 distinct request sizes
        assert _out(pred, _x(rows, seed=rows)).shape[0] == rows
    # the whole mixed-size load was served by the ONE warm plan
    assert len(_plans(pred)) == 1 and _runs(pred) == 8
    assert _base(pred)._exe.capture_stats == stats
    assert pred.health() == {"warm_buckets": ["b8"], "degraded_buckets": [],
                             "warmup_complete": True}


def test_warmup_rejects_unknown_bucket_and_dynamic_dim(model_dir):
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(2, 4)))
    with pytest.raises(ValueError, match="not in the ladder"):
        pred.warmup(buckets=[3])
    with pytest.raises(ValueError, match="come together"):
        # seq_dim without seq_buckets refuses at predictor creation
        pinference.create_paddle_predictor(_cfg(model_dir)
                                           .enable_shape_bucketing(
                                               batch_buckets=(2,),
                                               seq_dim=1))


def test_seq_dim_bucketing_pads_and_warms(tmp_path):
    """One declared dynamic trailing dim (seqlen analog): requests bucket
    on (batch, seq) jointly, pads are sum-safe zeros, and warmup covers
    the full batch x seq grid."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        # [-1, -1, 4]: batch AND seq dynamic; the sum over (seq, feat) is
        # zero-pad-invariant
        x = pt.layers.data(name="x", shape=[-1, 4], dtype="float32")
        out = pt.layers.reduce_sum(x, dim=[1, 2])
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    path = str(tmp_path / "seqmodel")
    pt.io.save_inference_model(path, ["x"], [out], exe, main_program=main)

    pred = pinference.create_paddle_predictor(_cfg(path).enable_shape_bucketing(
        batch_buckets=(2, 4), seq_dim=1, seq_buckets=(4, 8)))
    took = pred.warmup()
    assert set(took) == {"b2s4", "b2s8", "b4s4", "b4s8"}
    assert len(_plans(pred)) == 4

    rng = np.random.RandomState(3)
    for rows, seq in ((1, 3), (3, 4), (4, 7), (2, 8)):
        xa = rng.rand(rows, seq, 4).astype(np.float32)
        got = pred.run({"x": xa})[0].as_ndarray()
        np.testing.assert_allclose(got, xa.sum(axis=(1, 2)), rtol=1e-6)
    # every (batch, seq) combination landed in a warm bucket
    assert len(_plans(pred)) == 4
    with pytest.raises(ValueError, match="top seq bucket"):
        pred.run({"x": np.ones((2, 9, 4), np.float32)})


# ---------------------------------------------------------------------------
# request-coalescing dispatcher
# ---------------------------------------------------------------------------

def _clients(fn, n):
    """``fn(i)`` on n threads released together; returns the errors."""
    errs = []
    barrier = threading.Barrier(n)

    def client(i):
        try:
            barrier.wait()
            fn(i)
        except BaseException as e:  # noqa: BLE001 -- reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a client hung"
    return errs


def test_concurrent_runs_bit_exact_vs_unbatched(model_dir):
    plain = pinference.create_paddle_predictor(_cfg(model_dir))
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(4, 8, 16))
        .enable_request_coalescing(max_batch_size=16, batch_timeout_us=4000))
    assert isinstance(pred, pinference.BatchingPredictor)
    try:
        pred.warmup()
        runs0 = _runs(pred)
        sizes = [1, 2, 3, 5, 4, 7, 2, 1]  # one request per client thread
        feeds = [_x(s, seed=100 + i) for i, s in enumerate(sizes)]
        want = [_out(plain, f) for f in feeds]
        got = [None] * len(sizes)

        def client(i):
            got[i] = _out(pred, feeds[i])

        assert not _clients(client, len(sizes))
        for i in range(len(sizes)):
            # each caller got its OWN rows, bit-exact vs its unbatched run
            assert got[i].shape[0] == sizes[i]
            np.testing.assert_array_equal(got[i], want[i])
        # coalescing happened: fewer device calls than requests, and no
        # new plan after warmup
        assert 0 < _runs(pred) - runs0 < len(sizes)
        assert len(_plans(pred)) == 3
        h = pred.health()
        assert h["queue_depth"] == 0 and h["warmup_complete"]
    finally:
        pred.shutdown()


def test_coalesced_matches_jax(model_dir):
    def front(mod, cfg):
        return mod.create_paddle_predictor(
            cfg.enable_shape_bucketing(batch_buckets=(4, 8))
            .enable_request_coalescing(max_batch_size=8,
                                       batch_timeout_us=200))

    jpred = front(jinference, jinference.AnalysisConfig(model_dir))
    ppred = front(pinference, _cfg(model_dir))
    try:
        for i, rows in enumerate((1, 3, 5, 8, 11)):
            x = _x(rows, seed=200 + i)
            got, want = _out(ppred, x), _out(jpred, x)
            assert got.shape == want.shape == (rows, 5)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    finally:
        jpred.shutdown()
        ppred.shutdown()


def test_dispatcher_shutdown_drains_queue(model_dir):
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(4,))
        .enable_request_coalescing(max_batch_size=4, batch_timeout_us=50000))
    pred.warmup()
    futures = [pred.submit({"x": _x(1, seed=i)}) for i in range(9)]
    pred.shutdown()
    # every enqueued request resolved BEFORE shutdown returned
    for f in futures:
        assert f.result(timeout=0)[0].as_ndarray().shape[0] == 1
    with pytest.raises(RuntimeError, match="shut down"):
        pred.run({"x": _x(1)})
    pred.shutdown()  # idempotent
    assert pred.health()["shut_down"]


def test_dispatcher_fans_errors_back(model_dir):
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_request_coalescing(max_batch_size=4,
                                                  batch_timeout_us=100))
    try:
        # bad feed NAME fails fast, in the caller, before enqueue
        with pytest.raises(ValueError, match="missing inputs"):
            pred.submit({"wrong_name": _x(2)})
        # bad feed WIDTH fails inside the dispatcher: the exception must
        # fan back through the future, not kill the dispatcher thread
        f = pred.submit({"x": np.ones((2, 9), np.float32)})
        with pytest.raises(Exception):
            f.result(timeout=30)
        # dispatcher survived: a good request still serves
        assert pred.run({"x": _x(2)}, timeout=30)[0].as_ndarray().shape[0] == 2
        assert pred.health()["dispatcher_alive"]
    finally:
        pred.shutdown()


def test_batching_predictor_clone(model_dir):
    a = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(4,))
        .enable_request_coalescing(max_batch_size=4, batch_timeout_us=100))
    b = a.clone()
    try:
        # one scope, one executor, one program: the warm plans are shared
        assert _base(b)._scope is _base(a)._scope
        assert _base(b)._exe is _base(a)._exe
        x = _x(2)
        np.testing.assert_array_equal(_out(a, x), _out(b, x))
        assert len(_plans(a)) == 1
        a.shutdown()
        # the clone's own dispatcher survives the original's shutdown
        assert _out(b, _x(1, seed=1)).shape[0] == 1
    finally:
        a.shutdown()
        b.shutdown()


def test_trace_id_is_none_without_the_monitor(model_dir):
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_request_coalescing(max_batch_size=4,
                                                  batch_timeout_us=500))
    try:
        fut = pred.submit({"x": _x(2)})
        fut.result(timeout=30)
        assert fut.trace_id is None
        # with the monitor off nothing is traced
        assert pred.trace_records() == [] and pred.pending_traces() == []
    finally:
        pred.shutdown()


def test_outputs_are_lazy_tensors_on_the_predictors_device(model_dir):
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(4,))
        .enable_request_coalescing(max_batch_size=4, batch_timeout_us=100))
    try:
        out = pred.run({"x": _x(3)})[0]
        assert isinstance(out, pinference.PaddleTensor)
        assert out._array is None  # nothing read to the host yet
        t = out.as_tensor()
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert out.shape == [3, 5]
        np.testing.assert_array_equal(out.as_ndarray(), t.numpy())
    finally:
        pred.shutdown()


# ---------------------------------------------------------------------------
# the executor under threads (ROADMAP C3)
# ---------------------------------------------------------------------------

@pytest.fixture
def fast_switching():
    """Thread switches every 10 us, so a lost update shows."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("how", ["one_predictor", "clones"])
def test_threads_on_one_plan_get_their_own_rows(model_dir, fast_switching,
                                                how):
    """8 threads, 6 requests each, all of one batch size, so one plan:
    every result equal to the same request run serially, and still one
    plan with every run counted."""
    pred = pinference.create_paddle_predictor(_cfg(model_dir))
    feeds = [[_x(3, seed=1000 + 10 * i + k) for k in range(6)]
             for i in range(8)]
    want = [[_out(pred, f) for f in fs] for fs in feeds]
    runs0 = _runs(pred)
    got = [[None] * 6 for _ in range(8)]
    preds = ([pred.clone() for _ in range(8)] if how == "clones"
             else [pred] * 8)

    def client(i):
        for k, f in enumerate(feeds[i]):
            got[i][k] = _out(preds[i], f)

    assert not _clients(client, 8)
    for i in range(8):
        for k in range(6):
            np.testing.assert_array_equal(got[i][k], want[i][k])
    assert len(_plans(pred)) == 1
    assert _runs(pred) - runs0 == 48  # plan.runs lost no update


def test_threads_on_one_executor_plan_and_fresh_plans(fast_switching):
    """Executor.run itself from 8 threads: the first runs make the plans
    concurrently (one per feed signature, none made twice), and each
    thread's fetch is its own feed's."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4], dtype="float32")
        y = pt.layers.scale(pt.layers.reduce_sum(x, dim=[1]), scale=2.0)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    feeds = [np.random.RandomState(i).rand(1 + i % 2, 4).astype(np.float32)
             for i in range(8)]
    got = [[] for _ in range(8)]

    def client(i):
        for _ in range(5):
            got[i].append(exe.run(main, feed={"x": feeds[i]},
                                  fetch_list=[y])[0])

    assert not _clients(client, 8)
    for i in range(8):
        for g in got[i]:
            np.testing.assert_array_equal(
                g, (feeds[i].sum(axis=1) * 2).astype(np.float32))
    plans = main.__dict__["_exec_cache"]
    assert len(plans) == 2 and sum(p.runs for p in plans.values()) == 40


def test_predictor_clone_shares_scope_executor_and_program(model_dir):
    pred = pinference.create_paddle_predictor(_cfg(model_dir))
    twin = pred.clone()
    assert type(twin) is type(pred) and twin is not pred
    assert twin._scope is pred._scope and twin._exe is pred._exe
    assert twin._program is pred._program
    np.testing.assert_array_equal(_out(twin, _x(2)), _out(pred, _x(2)))
    assert len(_plans(pred)) == 1


def test_executor_run_fires_its_fault_site(model_dir):
    from paddle_tpu_torch.testing import FaultInjected, FaultPlan
    pred = pinference.create_paddle_predictor(_cfg(model_dir))
    with FaultPlan().fail("executor.run", calls=[0]) as plan:
        with pytest.raises(FaultInjected):
            pred.run({"x": _x(1)})
        assert _out(pred, _x(1)).shape == (1, 5)
        assert plan.calls("executor.run") == 2
    assert _plans(pred) and _runs(pred) == 1  # the faulted run ran nothing


# ---------------------------------------------------------------------------
# the monitor: counters, request traces, health, the retrace classifier
# ---------------------------------------------------------------------------

@pytest.fixture
def monitors():
    from paddle_tpu import monitor as jmon
    from paddle_tpu_torch import monitor as pmon
    for m in (jmon, pmon):
        m.reset()
        m.enable()
    yield jmon, pmon
    for m in (jmon, pmon):
        m.disable()
        m.reset()


_SERVING_KEYS = (
    "serving_requests_total", "serving_batches_total",
    "serving_request_rows_total", "serving_padded_rows_total",
    "serving_oversize_chunks_total", 'serving_bucket_misses_total{bucket="b2"}',
    'serving_bucket_misses_total{bucket="b4"}',
    'serving_bucket_hits_total{bucket="b4"}',
    'serving_bucket_hits_total{bucket="b2"}')


def test_serving_counters_match_jax(model_dir, monitors):
    """The same requests, one at a time (so each is one device call),
    through both packages' bucketed and coalescing fronts: the serving
    counters and the pad-waste summary are equal."""
    jmon, pmon = monitors
    preds = [pkg.create_paddle_predictor(
        c.enable_shape_bucketing(batch_buckets=(2, 4))
        .enable_request_coalescing(max_batch_size=4, batch_timeout_us=100))
        for pkg, c in ((jinference, jinference.AnalysisConfig(model_dir)),
                       (pinference, _cfg(model_dir)))]
    try:
        for rows in (3, 4, 1, 10, 2):
            for pred in preds:
                pred.run({"x": _x(rows)}, timeout=60)
    finally:
        for pred in preds:
            pred.shutdown()
    js, ps = jmon.snapshot(), pmon.snapshot()
    for k in _SERVING_KEYS:
        assert ps.get(k) == js.get(k), k
    assert ps["serving_requests_total"] == 5
    assert ps["serving_oversize_chunks_total"] == 3
    for k in ("count", "sum", "max"):
        assert ps["serving_pad_waste_fraction"][k] == pytest.approx(
            js["serving_pad_waste_fraction"][k])
    assert ps["serving_time_in_queue_seconds"]["count"] == 5
    assert ps["serving_coalesced_rows"]["sum"] == js[
        "serving_coalesced_rows"]["sum"]


def test_request_trace_complete_chain(model_dir, monitors):
    """Every submitted request gets a trace id whose span chain covers
    admission -> enqueue_wait -> coalesce -> pad -> dispatch ->
    device_execute -> fanout, with pad waste bytes attributed, across
    the caller's and the dispatcher's threads."""
    _jmon, pmon = monitors
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(2, 4))
        .enable_request_coalescing(max_batch_size=4, batch_timeout_us=500))
    try:
        pred.warmup()
        fut = pred.submit({"x": _x(3)})
        fut.result(timeout=30)
        tid = fut.trace_id
        assert tid
        rec = pred.trace(tid)
        assert rec is not None and rec["ok"] is True, rec
        names = [s["name"] for s in rec["spans"]]
        for n in ("admission", "enqueue_wait", "coalesce", "pad",
                  "dispatch", "device_execute", "fanout"):
            assert n in names, (n, names)
        pad = next(s for s in rec["spans"] if s["name"] == "pad")
        # 3 rows pad up to bucket 4: one waste row of 6 float32s
        assert pad["bucket"] == "b4" and pad["waste_bytes"] == 1 * 6 * 4
        t0s = [s["t0"] for s in rec["spans"]]
        assert t0s == sorted(t0s)
        assert len({s["tid"] for s in rec["spans"]}) >= 2
        evs = pred.trace_events(0.0)
        assert any(e["ph"] == "s" for e in evs)
        assert any(e["ph"] == "f" for e in evs)
        assert pred.trace("t99999999") is None
        assert pmon.lookup_trace(tid) == rec
        assert pred.pending_traces() == []
        assert any(e.get("ev") == "trace" and e["trace_id"] == tid
                   for e in pmon.events())
    finally:
        pred.shutdown()


def test_trace_records_deadline_expiry(model_dir, monitors):
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_request_coalescing(max_batch_size=4,
                                                  batch_timeout_us=500))
    try:
        pred.run({"x": _x(2)})  # warm, so the dispatch itself is fast
        fut = pred.submit({"x": _x(2)}, deadline_ms=0.001)
        with pytest.raises(pserving.DeadlineExceeded):
            fut.result(timeout=30)
        rec = pred.trace(fut.trace_id)
        assert rec is not None and rec["ok"] is False
        assert rec["error"] == "DeadlineExceeded"
        dl = next(s for s in rec["spans"] if s["name"] == "deadline_check")
        assert dl["outcome"] == "expired"
        assert monitors[1].snapshot()["serving_expired_total"] == 1
    finally:
        pred.shutdown()


def test_front_health_registered_for_healthz(model_dir, monitors):
    _jmon, pmon = monitors
    pred = pinference.create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(2,))
        .enable_request_coalescing(max_batch_size=2, batch_timeout_us=100))
    try:
        pred.warmup()
        comps = pmon.healthz()["components"]
        mine = [h for n, h in comps.items()
                if n.startswith("batching_predictor:")
                and h.get("warm_buckets") == ["b2"]]
        assert mine and mine[-1]["breaker"] == "closed"
        assert pmon.healthz()["status"] == "ok"
    finally:
        pred.shutdown()
    names = set(pmon.healthz()["components"])
    assert not any(n == pred._health_name for n in names)


def test_retrace_classifier_batch_vs_feature_shape(monitors):
    _jmon, pmon = monitors
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4], dtype="float32")
        out = pt.layers.reduce_sum(x)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    pmon.reset()
    exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
            fetch_list=[out])
    # dim 0 moved, trailing dims intact: the bucketable kind
    exe.run(main, feed={"x": np.ones((5, 4), np.float32)},
            fetch_list=[out])
    # a non-batch dim moved: a new specialization
    exe.run(main, feed={"x": np.ones((2, 6), np.float32)},
            fetch_list=[out])
    snap = pmon.snapshot()
    assert snap['executor_compiles_total{cause="first compile"}'] == 1
    assert snap['executor_compiles_total{cause="new batch size"}'] == 1
    assert snap['executor_compiles_total{cause="new feature shape"}'] == 1

