"""GenerationPredictor in the port, on the CPU (after
tests/test_generation.py and tests/test_generation_paging.py).

A ``build_lm`` of 2 layers, d_model 64 and vocab 256 behind the port's
``GenerationPredictor``:

- continuous batching through 2 slots gives each request the JAX
  engine's greedy tokens (its ``naive_generate`` on the same weights),
  with re-admissions into slots other requests left mid-decode;
- the other contracts are held against the port's own
  ``naive_generate`` (equal to the JAX engine's in
  tests/test_torch_generation.py): EOS frees a slot after one token; no
  plan, capture, decode plan, ingest key or carry is made by traffic
  over mixed lengths after ``warmup()``, dense and paged; ``health()``
  reads unhealthy while the loop is wedged (chunks slower than the
  stall budget) and healthy after; requests sharing a system prompt hit
  the prefix cache and stay bit-exact; a pool too small for two requests
  defers the second and serves both; a deadline that passes mid-decode or
  in the queue, and a shed at admission, resolve as their typed errors;
  a sampled request gets the same tokens alone and among other requests;
  a chaos run of injected ``serving.dispatch`` faults resolves every
  future (tokens or ``FaultInjected``);
- with the monitor on, each request's trace seals with its spans, the
  ``generation_*`` counters follow the predictor's stats, and
  ``/generation`` carries the predictor's plane.

Every wait on a future has a timeout and every predictor is shut down in
a ``finally``.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.inference.generation import DecodeEngine as JEngine
from paddle_tpu.inference.generation import naive_generate as jnaive
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import (DeadlineExceeded,
                                        GenerationPredictor, Overloaded)
from paddle_tpu_torch.inference.generation import (DecodeEngine,
                                                   SamplingParams,
                                                   naive_generate)
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.testing.faults import FaultInjected, FaultPlan
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

VOCAB = 256
EOS = 1
LM = dict(vocab=VOCAB, n_layer=2, n_head=2, d_model=64, d_inner_hid=128,
          max_positions=64, eos_id=EOS)
ENGINE = dict(prompt_buckets=(8, 16), new_token_buckets=(8,),
              slot_buckets=(1, 2))
WAIT = 120  # seconds any future may take


@pytest.fixture(autouse=True)
def _flags():
    names = ("op_callstack", "generation_paged", "generation_prefix_cache")
    old = [(f, n, getattr(f, n)) for f in (JFLAGS, PFLAGS) for n in names]
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    for f, n, v in old:
        setattr(f, n, v)


def _engine(paged=True, prefix=True, eos_id=EOS):
    """A port engine, its weights from a seeded startup (the same in
    every engine made here, whatever its eos id)."""
    PFLAGS.generation_paged, PFLAGS.generation_prefix_cache = paged, prefix
    with punique.guard():
        spec = ptransformer.build_lm(**dict(LM, eos_id=eos_id))["spec"]
    spec.startup.random_seed = 3
    return DecodeEngine(spec, place=pt.CPUPlace(), scope=pt.Scope(),
                        **ENGINE).initialize()


@pytest.fixture(scope="module")
def engine():
    """The paged engine with prefix reuse, shared by the module."""
    old = PFLAGS.generation_paged, PFLAGS.generation_prefix_cache
    try:
        return _engine()
    finally:
        PFLAGS.generation_paged, PFLAGS.generation_prefix_cache = old


_REFS = {}


def _ref(eng, prompt, n):
    """The port's naive_generate of ``prompt`` (memoized per engine)."""
    key = (id(eng), tuple(prompt.tolist()), n)
    if key not in _REFS:
        _REFS[key] = naive_generate(eng, prompt, n).tolist()
    return _REFS[key]


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, VOCAB, (n,)).astype(np.int64) for n in lengths]


def _predictor(eng, **kw):
    kw = dict(dict(max_slots=2, decode_chunk=2, default_max_new_tokens=8),
              **kw)
    return GenerationPredictor(eng, **kw)


def _results(futs):
    return [f.result(timeout=WAIT).tolist() for f in futs]


def test_continuous_batching_equals_the_jax_engine():
    """5 requests through 2 slots: each request's tokens equal the JAX
    engine's naive_generate on the same weights; every request joins, and
    three of them re-admit a slot another left mid-decode."""
    JFLAGS.generation_paged = True
    with junique.guard():
        jspec = jtransformer.build_lm(**LM)["spec"]
    jspec.startup.random_seed = 7
    je = JEngine(jspec, place=fluid.CPUPlace(), scope=JScope(), **ENGINE)
    je.initialize()
    pe = _engine()
    names = [v.name for v in pe.spec.startup.list_vars() if v.persistable]
    pt.io.set_params_from_numpy(
        pe.scope, {n: np.asarray(je.scope.find_var(n)) for n in names},
        "cpu", program=pe.spec.startup)
    prompts = _prompts([5, 11, 7, 13, 4], seed=1)
    pred = _predictor(pe)
    try:
        pred.warmup()
        outs = _results([pred.submit(p, max_new_tokens=6) for p in prompts])
        h = pred.health()
    finally:
        pred.shutdown()
    for p, got in zip(prompts, outs):
        assert got == np.asarray(jnaive(je, p, 6)).tolist()
    assert pred.stats["joins"] == 5 and pred.stats["leaves"] == 5
    assert pred.stats["readmits"] == 3
    assert pred.stats["tokens"] == 30
    assert h["active_slots"] == 0 and h["slots"] == 2
    assert h["decode_steps"] > 0 and h["healthy"] is True


def test_eos_frees_the_slot_after_one_token(engine):
    """The model's first greedy token, made the spec's EOS, ends the
    request at once: one token, the slot free again."""
    prompt = _prompts([5])[0]
    first = _ref(engine, prompt, 4)[0]
    eng = _engine(eos_id=first)
    pred = _predictor(eng)
    try:
        out = pred.run(prompt, max_new_tokens=4, timeout=WAIT)
        h = pred.health()
    finally:
        pred.shutdown()
    assert out.tolist() == [first]
    assert pred.stats["eos"] == 1 and pred.stats["decode_chunks"] == 1
    assert h["active_slots"] == 0


def _counts(eng):
    """What warm traffic must not add to."""
    progs = (list(eng._prefill_progs.values())
             + list(eng._prefix_progs.values()))
    return {"plans": sum(len(p.__dict__.get("_exec_cache", {}))
                         for p, _ in progs),
            "captures": eng._exe.capture_stats["captures"],
            **{k: eng.stats[k] for k in ("decode_builds", "decode_captures",
                                         "ingest_builds", "carries")}}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_no_build_or_capture_after_warmup(paged):
    eng = _engine(paged=paged)
    pred = _predictor(eng)
    try:
        took = pred.warmup()
        before = _counts(eng)
        prompts = _prompts([3, 9, 15, 6, 12, 8], seed=4)
        outs = _results([pred.submit(p, max_new_tokens=5) for p in prompts])
        after = _counts(eng)
    finally:
        pred.shutdown()
    assert set(took) >= {"prefill_p8", "prefill_p16"}
    assert before["plans"] > 0 and before["carries"] == 1
    assert after == before
    for p, got in zip(prompts, outs):
        assert got == _ref(eng, p, 5)


def test_health_reads_the_wedge(engine):
    """Chunks slower than the stall budget read healthy=false while a slot
    is live; healthy again once the request resolved."""
    pred = _predictor(engine, max_slots=1, decode_chunk=1,
                      stall_budget_s=0.05, dispatch_retries=0)
    try:
        h = pred.health()
        for k in ("active_slots", "slots", "oldest_seq_age_s",
                  "last_decode_step_age_s", "decode_steps", "decode_chunk"):
            assert k in h
        assert h["healthy"] is True
        saw_wedge = False
        with FaultPlan(seed=0).delay("serving.dispatch", every=1,
                                     seconds=0.2):
            fut = pred.submit(_prompts([5], seed=12)[0], max_new_tokens=4)
            deadline = time.time() + 30
            while time.time() < deadline and not saw_wedge:
                h = pred.health()
                if h["active_slots"] >= 1 and not h["healthy"]:
                    saw_wedge = True
                    assert h["oldest_seq_age_s"] > 0
                time.sleep(0.01)
            fut.result(timeout=WAIT)
        h = pred.health()
    finally:
        pred.shutdown()
    assert saw_wedge, "the wedged loop never read unhealthy"
    assert h["active_slots"] == 0 and h["healthy"] is True


def test_prefix_hit_through_the_predictor(engine):
    """Requests opening with one system page decode bit-exact while the
    radix cache serves that page to every request after the first."""
    assert engine.prefix_enabled()
    rng = np.random.RandomState(9)
    sys_tokens = rng.randint(2, VOCAB, (engine.page_size,))
    shared = [np.concatenate([sys_tokens, rng.randint(2, VOCAB, (n,))])
              .astype(np.int64) for n in (2, 5, 3, 7)]
    pred = _predictor(engine, default_max_new_tokens=6)
    try:
        pred.warmup()
        h0 = engine.stats["prefix_hits"]
        outs = [pred.run(p, max_new_tokens=6, timeout=WAIT).tolist()
                for p in shared]
        hits = engine.stats["prefix_hits"] - h0
    finally:
        pred.shutdown()
    for got, p in zip(outs, shared):
        assert got == _ref(engine, p, 6)
    assert hits >= len(shared) - 1


def test_page_starved_pool_defers_and_serves(engine, monkeypatch):
    """A 4-page pool and 2 slots needing 3 pages each: the second
    concurrent admission defers (PagesExhausted at the queue head) and
    every request is still served bit-exact."""
    prompts = _prompts([6, 9, 12, 7], seed=3)
    refs = [_ref(engine, p, 6) for p in prompts]
    monkeypatch.setattr(GenerationPredictor, "_fit_pages_to_budget",
                        lambda self, eng, cap: 4)
    pred = _predictor(engine, default_max_new_tokens=6)
    results = {}
    lock = threading.Lock()

    def client(i):
        out = pred.run(prompts[i], max_new_tokens=6, timeout=WAIT)
        with lock:
            results[i] = out.tolist()

    try:
        pred.warmup()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        h = pred.health()
    finally:
        pred.shutdown()
    assert [results.get(i) for i in range(len(prompts))] == refs
    assert pred.stats["deferrals"] >= 1
    assert h["paged"] is True and h["pages_total"] == 4


@pytest.mark.parametrize("case", ["deadline_mid_decode", "deadline_queued",
                                  "shed_at_admission"])
def test_typed_resolution(engine, case):
    prompt = _prompts([6], seed=7)[0]
    if case == "shed_at_admission":
        # a bound of 0 queued rows sheds every request at submit
        pred = _predictor(engine, max_queue_rows=0)
        try:
            with pytest.raises(Overloaded):
                pred.submit(prompt, max_new_tokens=4)
            assert pred.health()["shed"] == 1
        finally:
            pred.shutdown()
        return
    pred = _predictor(engine, max_slots=1, decode_chunk=1,
                      dispatch_retries=0)
    try:
        with FaultPlan(seed=0).delay("serving.dispatch", every=1,
                                     seconds=0.05):
            if case == "deadline_mid_decode":
                fut = pred.submit(prompt, max_new_tokens=8,
                                  deadline_ms=150)
                with pytest.raises(DeadlineExceeded, match="mid-decode"):
                    fut.result(timeout=WAIT)
            else:
                busy = pred.submit(prompt, max_new_tokens=8)
                late = pred.submit(_prompts([4], seed=8)[0],
                                   max_new_tokens=4, deadline_ms=1.0)
                with pytest.raises(DeadlineExceeded, match="never"):
                    late.result(timeout=WAIT)
                assert busy.result(timeout=WAIT).tolist() == \
                    _ref(engine, prompt, 8)
        h = pred.health()
    finally:
        pred.shutdown()
    assert h["expired"] == 1 and h["active_slots"] == 0


def test_sampled_tokens_private_to_the_request(engine):
    """Same seed and prompt: the same sampled tokens alone and amid other
    requests joining and leaving the slot table."""
    sp = SamplingParams(temperature=1.0, top_k=8, seed=42)
    prompt = _prompts([7], seed=2)[0]
    pred = _predictor(engine)
    try:
        solo = pred.run(prompt, max_new_tokens=6, sampling=sp,
                        timeout=WAIT).tolist()
        crowd = _prompts([5, 9, 12, 4], seed=3)
        futs = [pred.submit(c, max_new_tokens=8) for c in crowd[:2]]
        mid = pred.submit(prompt, max_new_tokens=6, sampling=sp)
        futs += [pred.submit(c, max_new_tokens=8) for c in crowd[2:]]
        crowded = mid.result(timeout=WAIT).tolist()
        _results(futs)
    finally:
        pred.shutdown()
    assert solo == crowded and len(solo) == 6


def test_chaos_dispatch_faults_resolve_every_future(engine):
    """A seeded 30% of serving.dispatch calls fail (admissions and decode
    chunks alike, 2 retries each, breaker off): every future resolves,
    to the reference's tokens or to FaultInjected, and the dispatcher
    stays up."""
    prompts = _prompts([3, 9, 15, 6, 12, 8, 5, 10], seed=5)
    pred = _predictor(engine, dispatch_retries=2, retry_backoff_ms=0.0,
                      breaker_threshold=0)
    ok = failed = 0
    try:
        with FaultPlan(seed=1).fail("serving.dispatch", rate=0.3):
            futs = [pred.submit(p, max_new_tokens=6) for p in prompts]
            for p, f in zip(prompts, futs):
                try:
                    got = f.result(timeout=WAIT).tolist()
                except FaultInjected:
                    failed += 1
                    continue
                assert got == _ref(engine, p, 6)
                ok += 1
        h = pred.health()
        # the loop survived: a request after the chaos is served
        after = pred.run(prompts[0], max_new_tokens=6, timeout=WAIT)
    finally:
        pred.shutdown()
    assert ok + failed == len(prompts) and ok > 0
    assert h["dispatcher_alive"] and h["retries"] > 0
    assert after.tolist() == _ref(engine, prompts[0], 6)


def test_clone_and_shutdown_hand_the_carry_back(engine):
    """A shut-down predictor's slot table goes back to the engine: a
    clone's table reuses it, so no carry is made. Submitting after the
    shutdown raises; so do a bad top_k and an over-long prompt, in the
    caller's thread."""
    pred = _predictor(engine)
    try:
        pred.run(_prompts([5])[0], max_new_tokens=4, timeout=WAIT)
    finally:
        pred.shutdown()
    carries = engine.stats["carries"]
    twin = pred.clone()
    try:
        assert twin.run(_prompts([5])[0], max_new_tokens=4,
                        timeout=WAIT).tolist() == \
            _ref(engine, _prompts([5])[0], 4)
        with pytest.raises(ValueError, match="top-k window"):
            twin.submit(_prompts([5])[0],
                        sampling=SamplingParams(temperature=1.0, top_k=999))
        with pytest.raises(ValueError, match="top prompt bucket"):
            twin.submit(np.full((17,), 3, np.int64))
    finally:
        twin.shutdown()
    assert engine.stats["carries"] == carries
    with pytest.raises(RuntimeError, match="shut down"):
        pred.submit(_prompts([5])[0])


def test_monitor_traces_counts_and_the_generation_plane(engine):
    """With the monitor on: every request's trace seals (admission,
    enqueue wait, admit, decode) and covers its life, none is left
    pending, the generation counters equal the predictor's stats, the
    token latencies are observed, and ``/generation`` carries the
    predictor's plane until its shutdown."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference.generation import trace_span_coverage
    monitor.reset()
    monitor.enable()
    pred = _predictor(engine)
    try:
        pred.warmup()
        futs = [pred.submit(p) for p in _prompts([5, 12, 7], seed=9)]
        outs = _results(futs)
        recs = [pred.trace(f.trace_id) for f in futs]
        for rec in recs:
            names = {s["name"] for s in rec["spans"]}
            assert rec["ok"] is True
            assert {"admission", "enqueue_wait", "admit", "decode"} <= names
            assert trace_span_coverage(rec) > 0.9
        assert pred.pending_traces() == []
        snap = monitor.snapshot()
        assert snap["generation_tokens_total"] == sum(map(len, outs)) \
            == pred.stats["tokens"]
        assert snap["generation_slot_leaves_total"] == 3
        assert snap["generation_ttft_seconds"]["count"] == 3
        plane = monitor.generation_plane()
        mine = plane["predictors"][pred._health_name]
        assert mine["stats"]["tokens"] == pred.stats["tokens"]
        assert plane["latency"]["ttft"]["count"] == 3
        assert monitor.bench_summary()["generation"]["tokens"] == \
            pred.stats["tokens"]
    finally:
        pred.shutdown()
        name = pred._health_name
        monitor.disable()
        monitor.reset()
    assert name not in monitor.generation_plane()["predictors"]
