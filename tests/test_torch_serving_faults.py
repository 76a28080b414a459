"""The port's serving front under injected faults, on the CPU: the
scenarios of tests/test_serving_faults.py on a JAX-written ``save_mlp``
directory, driven by the port's deterministic chaos harness
(``paddle_tpu_torch/testing/faults.py``).

The harness against the JAX package's: the same seed and rules pick the
same faulting call indices. Then deadlines (fail-fast before dispatch),
``run(timeout=)`` cancelling its queued request, both shed policies and
``max_queue_rows=0``, retry on a transient fault, the breaker's open ->
half-open -> closed lifecycle with its probe's abort and expiry, the
dispatcher's crash supervision (pending and popped futures fail loudly,
the dispatcher restarts), a failing bucket's degradation to the naive
path and a transient fault that must not degrade, and the 200-request
chaos run held bitwise against the port's own unbatched predictor (the
JAX package's version of it fails on the JAX package, which is why the
oracle is the port's plain predictor: at these widths the rows of a
batched product are the unbatched rows, bit for bit, on this CPU).

What the JAX tests read from the monitor is read from ``health()`` and
from the wrapped predictor's plans: a device call is one run of a plan.
The monitor's own record is held in the last section: the breaker's
opening and a dispatcher crash write flight records (the failing
request's trace in the first), the ``serving_*`` resilience counters and
``bench_summary()``'s serving digest follow the story, and every fault
firing counts as ``fault_injections_total{site=,kind=}`` as in the JAX
harness. ``test_warmup_degrades_broken_bucket_and_continues``
warms with ``compile_workers=1``: with two cells on two threads the
faulting call indices 0 and 1 can land one on each cell, and then
neither cell fails twice.
"""

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import pytest

from paddle_tpu.testing import FaultInjected as JFaultInjected
from paddle_tpu.testing import FaultPlan as JFaultPlan
from paddle_tpu.testing.models import save_mlp as jax_save_mlp

from paddle_tpu_torch.inference import (AnalysisConfig, CircuitOpen,
                                        DeadlineExceeded, Overloaded,
                                        create_paddle_predictor)
from paddle_tpu_torch.inference.serving import _CircuitBreaker
from paddle_tpu_torch.testing import FaultInjected, FaultPlan, faults

IN_DIM = 6


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """One tiny frozen mlp for the whole module, written by the JAX
    package (row-independent, fast per bucket)."""
    return jax_save_mlp(str(tmp_path_factory.mktemp("faults_model")
                            / "model"), seed=11)


def _cfg(d):
    return AnalysisConfig(d, use_gpu=False)


def _x(rows, seed=0):
    return np.random.RandomState(seed).rand(rows, IN_DIM).astype(np.float32)


def _coalescing(model_dir, **kw):
    return create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(8,))
        .enable_request_coalescing(max_batch_size=8, batch_timeout_us=1000,
                                   **kw))


def _runs(pred):
    """Device calls of the predictor under the serving wrappers."""
    base = pred._pred._base
    return sum(p.runs for p in
               base._program.__dict__.get("_exec_cache", {}).values())


# ---------------------------------------------------------------------------
# harness determinism
# ---------------------------------------------------------------------------

def _injected_indices(plan, n=200, exc=FaultInjected):
    out = []
    for i in range(n):
        try:
            plan._fire("s")
        except exc:
            out.append(i)
    return out


def test_fault_plan_selectors_are_deterministic():
    a = _injected_indices(FaultPlan(seed=7).fail("s", rate=0.1))
    b = _injected_indices(FaultPlan(seed=7).fail("s", rate=0.1))
    assert a == b and 5 <= len(a) <= 40  # ~10% of 200, same every time
    c = _injected_indices(FaultPlan(seed=8).fail("s", rate=0.1))
    assert a != c  # a different seed is a different script
    assert _injected_indices(FaultPlan().fail("s", calls=[2, 5])) == [2, 5]
    assert _injected_indices(FaultPlan().fail("s", every=50)) == \
        [49, 99, 149, 199]
    assert _injected_indices(FaultPlan().fail("s", every=10, times=2)) == \
        [9, 19]
    with pytest.raises(ValueError, match="exactly one selector"):
        FaultPlan().fail("s", calls=[1], every=2)
    # overlapping fail rules: one raise per call, counted ONCE, and the
    # shadowed rule's times= budget is not consumed
    both = FaultPlan().fail("s", calls=[0, 1], times=2) \
                      .fail("s", calls=[0, 1, 2], times=1)
    assert _injected_indices(both, n=4) == [0, 1, 2]
    assert both.injected("s") == 3


SCRIPTS = {
    "rate": lambda P, s: P(seed=s).fail("s", rate=0.1),
    "rate_times": lambda P, s: P(seed=s).fail("s", rate=0.3, times=7),
    "rules_in_order": lambda P, s: P(seed=s).fail("s", calls=range(10, 18))
    .fail("s", rate=0.1).delay("s", rate=0.05, seconds=0.0),
    "every_and_rate": lambda P, s: P(seed=s).fail("s", every=7, times=5)
    .fail("s", rate=0.05),
}


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_fault_plan_selectors_match_jax(script, seed):
    """The determinism contract across the packages: the same seed and
    rule order fault the same call indices, and count the same."""
    make = SCRIPTS[script]
    pplan, jplan = make(FaultPlan, seed), make(JFaultPlan, seed)
    assert _injected_indices(pplan, 300) == \
        _injected_indices(jplan, 300, JFaultInjected)
    assert pplan.injected("s") == jplan.injected("s")
    assert pplan.calls("s") == jplan.calls("s") == 300


def test_fault_plan_install_is_exclusive_and_scoped():
    with FaultPlan().fail("s", calls=[0]) as plan:
        with pytest.raises(RuntimeError, match="already installed"):
            FaultPlan().install()
        with pytest.raises(FaultInjected):
            faults.fire("s")
        assert plan.injected("s") == 1
        assert faults.active_plan() is plan
    faults.fire("s")  # plan removed: a bare hook is a no-op
    assert faults.active_plan() is None


# ---------------------------------------------------------------------------
# deadlines + timeout cancellation
# ---------------------------------------------------------------------------

def test_deadline_expires_in_queue_fails_fast(model_dir):
    pred = _coalescing(model_dir)
    pred.warmup()
    runs0 = _runs(pred)
    try:
        with FaultPlan().delay("serving.dispatch", calls=[0],
                               seconds=0.4):
            fa = pred.submit({"x": _x(1)})          # stalls 0.4s
            time.sleep(0.05)                        # A is in dispatch
            fb = pred.submit({"x": _x(1, seed=1)}, deadline_ms=50)
            with pytest.raises(DeadlineExceeded, match="never dispatched"):
                fb.result(timeout=10)
            fa.result(timeout=10)                   # A unaffected
        assert pred.health()["expired"] == 1
        # the expired request never reached the device: only A's batch
        assert _runs(pred) - runs0 == 1
    finally:
        pred.shutdown()


def test_run_timeout_cancels_queued_request(model_dir):
    pred = _coalescing(model_dir)
    pred.warmup()
    runs0 = _runs(pred)
    try:
        with FaultPlan().delay("serving.dispatch", calls=[0],
                               seconds=0.4):
            fa = pred.submit({"x": _x(1)})          # stalls the loop
            time.sleep(0.05)
            with pytest.raises(FutureTimeout):
                pred.run({"x": _x(1, seed=1)}, timeout=0.05)
            fa.result(timeout=10)
        # the timed-out request was tombstoned: the dispatcher dropped it
        # without computing (1 batch for A + 1 for C below)
        out = pred.run({"x": _x(2, seed=2)}, timeout=10)
        assert out[0].as_ndarray().shape[0] == 2
        assert pred.health()["cancelled"] == 1
        assert _runs(pred) - runs0 == 2
    finally:
        pred.shutdown()


def test_submit_rejects_nonpositive_deadline(model_dir):
    pred = _coalescing(model_dir)
    try:
        with pytest.raises(ValueError, match="deadline_ms"):
            pred.submit({"x": _x(1)}, deadline_ms=0)
    finally:
        pred.shutdown()


# ---------------------------------------------------------------------------
# admission control / shed policies
# ---------------------------------------------------------------------------

def test_shed_reject_new_raises_overloaded(model_dir):
    pred = _coalescing(model_dir, max_queue_rows=3)
    pred.warmup()
    try:
        with FaultPlan().delay("serving.dispatch", calls=[0],
                               seconds=0.4):
            head = pred.submit({"x": _x(1)})        # dispatcher busy
            time.sleep(0.05)
            queued = [pred.submit({"x": _x(1, seed=i)})
                      for i in range(3)]            # fills the bound
            with pytest.raises(Overloaded, match="reject-new"):
                pred.submit({"x": _x(1, seed=9)})
            for f in [head] + queued:               # admitted ones serve
                assert f.result(timeout=10)[0].as_ndarray().shape[0] == 1
        h = pred.health()
        assert h["shed"] == 1 and h["shed_policy"] == "reject-new"
    finally:
        pred.shutdown()


def test_shed_drop_oldest_fails_oldest_future(model_dir):
    pred = _coalescing(model_dir, max_queue_rows=3,
                       shed_policy="drop-oldest")
    pred.warmup()
    try:
        with FaultPlan().delay("serving.dispatch", calls=[0],
                               seconds=0.4):
            head = pred.submit({"x": _x(1)})
            time.sleep(0.05)
            queued = [pred.submit({"x": _x(1, seed=i)})
                      for i in range(3)]
            newest = pred.submit({"x": _x(1, seed=9)})  # displaces oldest
            with pytest.raises(Overloaded, match="drop-oldest"):
                queued[0].result(timeout=10)
            for f in [head, queued[1], queued[2], newest]:
                assert f.result(timeout=10)[0].as_ndarray().shape[0] == 1
        assert pred.health()["shed"] == 1
    finally:
        pred.shutdown()


def test_unknown_shed_policy_rejected(model_dir):
    with pytest.raises(ValueError, match="shed_policy"):
        _coalescing(model_dir, shed_policy="lifo")


def test_queue_depth_sampled_under_admission_lock(model_dir):
    pred = _coalescing(model_dir)
    pred.warmup()
    try:
        with FaultPlan().delay("serving.dispatch", calls=[0],
                               seconds=0.4):
            head = pred.submit({"x": _x(1)})
            time.sleep(0.05)                        # head is IN dispatch
            pred.submit({"x": _x(2, seed=1)})
            pred.submit({"x": _x(3, seed=2)})
            # exactly the two still-queued requests (the in-flight head
            # left the queue when it was taken)
            h = pred.health()
            assert (h["queue_depth"], h["queued_rows"]) == (2, 5)
            head.result(timeout=10)
        pred.run({"x": _x(1, seed=3)}, timeout=10)  # forces full drain
        h = pred.health()
        assert (h["queue_depth"], h["queued_rows"]) == (0, 0)
    finally:
        pred.shutdown()


# ---------------------------------------------------------------------------
# retry + circuit breaker
# ---------------------------------------------------------------------------

def test_retry_recovers_transient_dispatch_fault(model_dir):
    plain = create_paddle_predictor(_cfg(model_dir))
    pred = _coalescing(model_dir, dispatch_retries=2, retry_backoff_ms=1)
    pred.warmup()
    try:
        x = _x(3, seed=5)
        want = plain.run({"x": x})[0].as_ndarray()
        with FaultPlan().fail("serving.dispatch", calls=[0]):
            got = pred.run({"x": x}, timeout=10)[0].as_ndarray()
        np.testing.assert_array_equal(got, want)    # caller never saw it
        h = pred.health()
        assert h["retries"] == 1 and h["breaker"] == "closed"
        assert h["consecutive_failures"] == 0       # retried-ok == ok
    finally:
        pred.shutdown()


def test_breaker_opens_half_opens_and_closes(model_dir):
    pred = _coalescing(model_dir, dispatch_retries=0,
                       breaker_threshold=2, breaker_reset_ms=100)
    pred.warmup()
    try:
        with FaultPlan().fail("serving.dispatch", calls=[0, 1]):
            for i in range(2):                      # two consecutive fails
                with pytest.raises(FaultInjected):
                    pred.run({"x": _x(1, seed=i)}, timeout=10)
            h = pred.health()
            assert h["breaker"] == "open" and h["breaker_opens"] == 1
            assert h["consecutive_failures"] == 2
            with pytest.raises(CircuitOpen, match="circuit open"):
                pred.submit({"x": _x(1)})           # fail-fast, no queue
            time.sleep(0.15)                        # past breaker_reset_ms
            # half-open probe: dispatch call 2 is unscripted -> success
            out = pred.run({"x": _x(2, seed=7)}, timeout=10)
            assert out[0].as_ndarray().shape[0] == 2
        h = pred.health()
        assert h["breaker"] == "closed" and h["consecutive_failures"] == 0
        assert h["breaker_opens"] == 1
    finally:
        pred.shutdown()


def test_half_open_probe_failure_reopens(model_dir):
    pred = _coalescing(model_dir, dispatch_retries=0,
                       breaker_threshold=1, breaker_reset_ms=60)
    pred.warmup()
    try:
        with FaultPlan().fail("serving.dispatch", calls=[0, 1]):
            with pytest.raises(FaultInjected):
                pred.run({"x": _x(1)}, timeout=10)
            assert pred.health()["breaker"] == "open"
            time.sleep(0.1)
            with pytest.raises(FaultInjected):      # probe fails too
                pred.run({"x": _x(1, seed=1)}, timeout=10)
            assert pred.health()["breaker"] == "open"
            assert pred.health()["breaker_opens"] == 2
            with pytest.raises(CircuitOpen):
                pred.submit({"x": _x(1)})
            time.sleep(0.1)
            pred.run({"x": _x(1, seed=2)}, timeout=10)  # probe succeeds
        assert pred.health()["breaker"] == "closed"
    finally:
        pred.shutdown()


def test_probe_abort_releases_half_open_instead_of_wedging():
    """A half-open probe that dies BEFORE dispatching must release the
    breaker (back to open, fresh cooldown): a phantom probe would lock
    every later submit out with CircuitOpen forever."""
    br = _CircuitBreaker(1, 40)
    br.record(False)
    assert br.state == "open"
    time.sleep(0.05)
    assert br.admit() is True           # the probe
    with pytest.raises(CircuitOpen, match="probe in flight"):
        br.admit()
    br.probe_aborted()                  # probe died pre-dispatch
    assert br.state == "open"
    time.sleep(0.05)
    assert br.admit() is True           # a FRESH probe can enter
    br.record(True)
    assert br.state == "closed"


def test_expired_probe_does_not_wedge_the_breaker(model_dir):
    """Open the breaker, let the probe be cancelled in the queue;
    whichever way the cancel race lands, the predictor must keep serving
    (never a permanent CircuitOpen)."""
    pred = _coalescing(model_dir, dispatch_retries=0,
                       breaker_threshold=1, breaker_reset_ms=40)
    pred.warmup()
    try:
        with FaultPlan().fail("serving.dispatch", calls=[0]):
            with pytest.raises(FaultInjected):
                pred.run({"x": _x(1)}, timeout=10)
            assert pred.health()["breaker"] == "open"
            time.sleep(0.06)
            fut = pred.submit({"x": _x(1, seed=1)})  # the probe
            fut.cancel()  # may win (queued) or lose (already dispatched)
            deadline = time.perf_counter() + 5
            while True:  # must converge to serving either way
                try:
                    out = pred.run({"x": _x(2, seed=2)}, timeout=10)
                    break
                except CircuitOpen:
                    assert time.perf_counter() < deadline, \
                        "breaker wedged half-open by a dead probe"
                    time.sleep(0.05)
            assert out[0].as_ndarray().shape[0] == 2
        assert pred.health()["breaker"] == "closed"
    finally:
        pred.shutdown()


def test_max_queue_rows_zero_is_fully_closed(model_dir):
    """max_queue_rows=0 admits NOTHING under EITHER policy: not coerced
    to 'unbounded', and drop-oldest sheds the newcomer when even an
    empty queue can't fit it."""
    for policy in ("reject-new", "drop-oldest"):
        pred = _coalescing(model_dir, max_queue_rows=0, shed_policy=policy)
        try:
            with pytest.raises(Overloaded):
                pred.submit({"x": _x(1)})
            assert pred.health()["shed"] == 1
        finally:
            pred.shutdown()


def test_drop_oldest_sheds_unsatisfiable_newcomer_not_the_queue(model_dir):
    """A request larger than max_queue_rows can NEVER fit: drop-oldest
    sheds IT at once instead of evicting queued callers."""
    pred = _coalescing(model_dir, max_queue_rows=4,
                       shed_policy="drop-oldest")
    pred.warmup()
    try:
        with FaultPlan().delay("serving.dispatch", calls=[0],
                               seconds=0.3):
            head = pred.submit({"x": _x(1)})
            time.sleep(0.05)
            queued = pred.submit({"x": _x(2, seed=1)})
            with pytest.raises(Overloaded, match="drop-oldest"):
                pred.submit({"x": _x(5, seed=2)})  # 5 > bound of 4
            # nobody was displaced for the unsatisfiable newcomer
            assert queued.result(timeout=10)[0].as_ndarray().shape[0] == 2
            head.result(timeout=10)
        assert pred.health()["shed"] == 1
    finally:
        pred.shutdown()


# ---------------------------------------------------------------------------
# dispatcher supervision
# ---------------------------------------------------------------------------

def test_dispatcher_crash_fails_pending_loudly_and_restarts(model_dir):
    pred = _coalescing(model_dir)
    pred.warmup()
    try:
        stall = FaultPlan().delay("serving.dispatch", calls=[0],
                                  seconds=0.4).install()
        fa = pred.submit({"x": _x(1)})              # loop inside dispatch
        time.sleep(0.05)
        fb = pred.submit({"x": _x(1, seed=1)})      # pending behind it
        stall.remove()
        # the next dispatcher-loop tick (after A's dispatch) crashes
        crash = FaultPlan().fail("serving.dispatcher", calls=[0]).install()
        try:
            with pytest.warns(UserWarning, match="dispatcher crashed"):
                fa.result(timeout=10)               # A's batch completed
                with pytest.raises(RuntimeError,
                                   match="dispatcher crashed") as ei:
                    fb.result(timeout=10)           # B failed LOUDLY
            assert isinstance(ei.value.__cause__, FaultInjected)
        finally:
            crash.remove()
        # supervised restart: a fresh dispatcher serves new traffic
        out = pred.run({"x": _x(2, seed=2)}, timeout=10)
        assert out[0].as_ndarray().shape[0] == 2
        h = pred.health()
        assert h["dispatcher_restarts"] == 1 and h["dispatcher_alive"]
    finally:
        pred.shutdown()


def test_dispatcher_crash_fails_popped_carry_not_just_queue(model_dir):
    """A crash must also fail requests the dispatcher already POPPED (the
    carry opening the next micro-batch): draining only the queue would
    strand their futures in a silent hang."""
    pred = create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(4,))
        .enable_request_coalescing(max_batch_size=4, batch_timeout_us=1000))
    pred.warmup()
    try:
        stall = FaultPlan().delay("serving.dispatch", calls=[0],
                                  seconds=0.4).install()
        fa = pred.submit({"x": _x(1)})              # in dispatch, stalled
        time.sleep(0.05)
        fb = pred.submit({"x": _x(3, seed=1)})      # next head
        fc = pred.submit({"x": _x(2, seed=2)})      # 3+2 > 4 -> carry
        stall.remove()
        # dispatcher ticks: [0] after A's dispatch (builds B's group,
        # pops C as carry, dispatches B), then [1] crashes with C popped
        # from the queue but undispatched
        crash = FaultPlan().fail("serving.dispatcher", calls=[1]).install()
        try:
            with pytest.warns(UserWarning, match="dispatcher crashed"):
                fa.result(timeout=10)
                assert fb.result(timeout=10)[0].as_ndarray().shape[0] == 3
                with pytest.raises(RuntimeError,
                                   match="dispatcher crashed"):
                    fc.result(timeout=10)           # carry failed LOUDLY
        finally:
            crash.remove()
        out = pred.run({"x": _x(1, seed=3)}, timeout=10)
        assert out[0].as_ndarray().shape[0] == 1    # restarted + serving
        assert pred.health()["dispatcher_restarts"] == 1
    finally:
        pred.shutdown()


# ---------------------------------------------------------------------------
# bucket degradation
# ---------------------------------------------------------------------------

def test_bucket_compile_failure_degrades_to_naive(model_dir, monkeypatch):
    plain = create_paddle_predictor(_cfg(model_dir))
    pred = create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(2, 4)))
    naive = []
    run = pred._base.run
    monkeypatch.setattr(pred._base, "run", lambda feed: (
        naive.append(len(feed["x"])) if len(feed["x"]) not in (2, 4)
        else None) or run(feed))
    x = _x(3, seed=3)
    want = plain.run({"x": x})[0].as_ndarray()
    # BOTH the first dispatch and its retry must fail to condemn a bucket
    # (a single transient blip does not degrade)
    with FaultPlan().fail("serving.bucket_dispatch", calls=[0, 1]):
        with pytest.warns(UserWarning, match="degrading"):
            got = pred.run({"x": x})[0].as_ndarray()  # b4 breaks -> naive
    np.testing.assert_array_equal(got, want)
    h = pred.health()
    assert h["degraded_buckets"] == ["b4"] and h["warm_buckets"] == []
    # a SINGLE transient failure does NOT degrade: b2's first dispatch
    # fails once, the built-in retry lands it
    with FaultPlan().fail("serving.bucket_dispatch", calls=[0]):
        out = pred.run({"x": _x(2, seed=6)})[0].as_ndarray()
    assert out.shape[0] == 2
    assert "b2" in pred.health()["warm_buckets"]
    assert pred.health()["degraded_buckets"] == ["b4"]
    # the degraded key STAYS naive (no re-fail, no padding)
    np.testing.assert_array_equal(pred.run({"x": x})[0].as_ndarray(), want)
    assert naive == [3, 3]
    # other buckets are unaffected: b2 pads and serves warm
    assert pred.run({"x": _x(2, seed=4)})[0].as_ndarray().shape[0] == 2
    assert "b2" in pred.health()["warm_buckets"]


def test_transient_fault_on_compiling_bucket_does_not_degrade(model_dir):
    """Only the thread that CLAIMED a cold bucket's first dispatch may
    degrade it: a concurrent caller's transient fault on a bucket still
    being claimed raises to that caller and leaves the bucket's fate to
    the claimant."""
    pred = create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(4,)))
    outcome = {}

    def claimant():
        outcome["a"] = pred.run({"x": _x(2, seed=1)})[0].as_ndarray()

    with FaultPlan().delay("serving.bucket_dispatch", calls=[0],
                           seconds=0.2) \
                    .fail("serving.bucket_dispatch", calls=[1]):
        ta = threading.Thread(target=claimant)
        ta.start()                      # claims b4, stalls in dispatch
        time.sleep(0.05)
        with pytest.raises(FaultInjected):
            pred.run({"x": _x(3, seed=2)})  # non-claimant: raises
        ta.join(timeout=10)
    assert not ta.is_alive()
    assert outcome["a"].shape[0] == 2   # the claimant's dispatch landed
    h = pred.health()
    assert h["degraded_buckets"] == []  # the transient fault didn't condemn
    assert h["warm_buckets"] == ["b4"]
    assert pred.run({"x": _x(1, seed=3)})[0].as_ndarray().shape[0] == 1


def test_warmup_degrades_broken_bucket_and_continues(model_dir):
    pred = create_paddle_predictor(
        _cfg(model_dir).enable_shape_bucketing(batch_buckets=(2, 4)))
    with FaultPlan().fail("serving.bucket_dispatch", calls=[0, 1]):
        with pytest.warns(UserWarning, match="degrading"):
            took = pred.warmup(compile_workers=1)   # b2 breaks, b4 warms
    assert set(took) == {"b4"}
    h = pred.health()
    assert h["degraded_buckets"] == ["b2"]
    assert h["warm_buckets"] == ["b4"]
    assert h["warmup_complete"]                     # degraded counts
    assert pred.run({"x": _x(1, seed=5)})[0].as_ndarray().shape[0] == 1


# ---------------------------------------------------------------------------
# the chaos load
# ---------------------------------------------------------------------------

def test_chaos_200_requests_resolve_typed_with_parity(model_dir):
    """200 concurrent requests, 10% injected dispatch faults, latency
    spikes and one scripted consecutive-failure window: every future
    resolves (a result or a TYPED error) with no hang, successful rows
    stay bitwise the port's unbatched predictor's, and the breaker opens
    and recovers."""
    n_requests, conc = 200, 8
    plain = create_paddle_predictor(_cfg(model_dir))
    pred = _coalescing(model_dir, dispatch_retries=1, retry_backoff_ms=1,
                       breaker_threshold=3, breaker_reset_ms=50,
                       default_deadline_ms=10000)
    pred.warmup()
    sizes = [1 + (i % 8) for i in range(n_requests)]
    feeds = [_x(sizes[i], seed=1000 + i) for i in range(n_requests)]
    want = [plain.run({"x": f})[0].as_ndarray() for f in feeds]

    plan = (FaultPlan(seed=0)
            .fail("serving.dispatch", rate=0.10)
            .fail("serving.dispatch", calls=range(10, 18))  # opens breaker
            .delay("serving.dispatch", rate=0.05, seconds=0.003))
    results: list = [None] * n_requests
    it = iter(range(n_requests))
    lock = threading.Lock()
    barrier = threading.Barrier(conc)

    def client():
        barrier.wait()
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            try:
                # the timeout bounds "no hangs": a stuck future fails the
                # typed-error assertion below as FutureTimeout
                results[i] = pred.run({"x": feeds[i]},
                                      timeout=30)[0].as_ndarray()
            except CircuitOpen as e:
                results[i] = e
                # a fail-fast client backs off instead of burning its
                # whole request list inside one breaker cooldown
                time.sleep(0.02)
            except BaseException as e:  # noqa: BLE001
                results[i] = e

    try:
        with plan:
            threads = [threading.Thread(target=client) for _ in range(conc)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads), "client hung"
            elapsed = time.perf_counter() - t0
        ok = err = 0
        for i, r in enumerate(results):
            assert r is not None, f"request {i} never resolved"
            if isinstance(r, np.ndarray):
                ok += 1
                np.testing.assert_array_equal(r, want[i])  # bit-exact
            else:
                err += 1
                assert isinstance(r, (FaultInjected, DeadlineExceeded,
                                      Overloaded, CircuitOpen)), (
                    f"request {i} got an UNTYPED error: {r!r}")
        assert ok + err == n_requests
        assert err > 0                   # the chaos actually bit...
        assert ok >= n_requests // 2     # ...and the load still served
        assert plan.injected("serving.dispatch") > 0
        h = pred.health()
        assert h["breaker_opens"] >= 1 and h["retries"] >= 1
        # ...and recovers: post-chaos traffic serves (the probe may need
        # the cooldown to lapse first)
        deadline = time.perf_counter() + 10
        while True:
            try:
                out = pred.run({"x": _x(3, seed=9999)}, timeout=10)
                break
            except CircuitOpen:
                assert time.perf_counter() < deadline, "breaker stuck open"
                time.sleep(0.05)
        assert out[0].as_ndarray().shape[0] == 3
        h = pred.health()
        assert h["breaker"] == "closed"
        assert h["queue_depth"] == 0 and h["dispatcher_alive"]
        assert h["dispatcher_restarts"] == 0  # isolation, not crashes
        # no plan beyond the warm bucket's
        assert len(pred._pred._base._program.__dict__["_exec_cache"]) == 1
        assert elapsed < 90, f"chaos load took {elapsed:.1f}s"
    finally:
        pred.shutdown()


# ---------------------------------------------------------------------------
# the monitor's record of the faults
# ---------------------------------------------------------------------------

@pytest.fixture
def monitored(tmp_path):
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.utils.flags import FLAGS
    old = FLAGS.flight_record_dir
    FLAGS.flight_record_dir = str(tmp_path / "flight")
    monitor.reset()
    monitor._flight_last.clear()
    monitor.enable()
    yield monitor, tmp_path / "flight"
    monitor.disable()
    monitor.reset()
    FLAGS.flight_record_dir = old


def _records(d, reason):
    import json
    import os
    out = []
    for name in sorted(os.listdir(d)) if d.exists() else ():
        if reason in name:
            out.append([json.loads(ln) for ln in open(d / name)])
    return out


def test_breaker_open_writes_a_flight_record_and_counts(model_dir,
                                                        monitored):
    monitor, d = monitored
    pred = _coalescing(model_dir, dispatch_retries=1, retry_backoff_ms=0,
                       breaker_threshold=2, breaker_reset_ms=60000)
    pred.warmup()
    try:
        with FaultPlan().fail("serving.dispatch", calls=[0, 1, 2, 3]):
            futs = []
            for i in range(2):
                fut = pred.submit({"x": _x(1, seed=i)})
                futs.append(fut)
                with pytest.raises(FaultInjected):
                    fut.result(timeout=30)
            with pytest.raises(CircuitOpen):
                pred.submit({"x": _x(1)})
        assert pred.health()["breaker"] == "open"
        snap = monitor.snapshot()
        assert snap["serving_breaker_opens_total"] == 1
        assert snap["serving_breaker_state"] == 2
        assert snap["serving_retries_total"] == 2
        assert snap['fault_injections_total{kind="fail",'
                    'site="serving.dispatch"}'] == 4
        assert snap['flight_records_total{reason="circuit_open"}'] == 1
        (rec,) = _records(d, "circuit_open")
        meta = rec[0]
        assert meta["ev"] == "flight_meta" and meta["reason"] == \
            "circuit_open"
        assert meta["consecutive_failures"] == 2
        # the record names the request whose failure opened the breaker
        assert meta["trace_id"] == futs[1].trace_id
        # the log's sealed traces come first, the failing request's last
        trace = [r for r in rec if r["ev"] == "trace"][-1]
        assert trace["trace_id"] == futs[1].trace_id
        assert trace["ok"] is False and trace["error"] == "FaultInjected"
        assert any(r["ev"] == "health" for r in rec)
        srv = monitor.bench_summary()["serving"]
        assert srv["breaker_opens"] == 1 and srv["retries"] == 2
        assert srv["fault_injections"] == 4
        assert pred.pending_traces() == []
    finally:
        pred.shutdown()


def test_dispatcher_crash_writes_a_flight_record(model_dir, monitored):
    monitor, d = monitored
    pred = _coalescing(model_dir)
    pred.warmup()
    try:
        old = pred._thread
        with FaultPlan().fail("serving.dispatcher", calls=[0]):
            # the supervisor starts a new dispatcher thread last
            old.join(timeout=30)
            assert pred._thread is not old and pred._thread.is_alive()
        out = pred.run({"x": _x(2, seed=2)}, timeout=30)
        assert out[0].as_ndarray().shape[0] == 2
        assert monitor.snapshot()["serving_dispatcher_crashes_total"] == 1
        (rec,) = _records(d, "dispatcher_crash")
        assert rec[0]["restarts"] == 1 and "FaultInjected" in \
            rec[0]["error"]
    finally:
        pred.shutdown()


def test_fault_injection_counts_match_the_jax_harness(monitored):
    """The same plan fired the same number of times through both
    harnesses: equal ``fault_injections_total`` per site and kind."""
    from paddle_tpu import monitor as jmon
    from paddle_tpu.testing import faults as jfaults
    pmon, _d = monitored
    jmon.reset()
    jmon.enable()
    try:
        for F, fire, FI, mod in ((JFaultPlan, jfaults.fire,
                                  JFaultInjected, jmon),
                                 (FaultPlan, faults.fire, FaultInjected,
                                  pmon)):
            plan = (F(seed=3).fail("serving.dispatch", calls=[1, 4])
                    .fail("ckpt_write", rate=0.5, times=3)
                    .delay("serving.dispatcher", calls=[2], seconds=0.0))
            with plan:
                for _ in range(8):
                    for site in ("serving.dispatch", "ckpt_write",
                                 "serving.dispatcher"):
                        try:
                            fire(site)
                        except FI:
                            pass
        keys = {k for m in (jmon, pmon) for k in m.snapshot()
                if k.startswith("fault_injections_total")}
        assert keys
        for k in keys:
            assert pmon.snapshot().get(k) == jmon.snapshot().get(k), k
    finally:
        jmon.disable()
        jmon.reset()

