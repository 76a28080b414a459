"""Measured-profiling sessions: capture, parse, attribute, report.

Counterpart of ``paddle_tpu/profiling/session.py``. A
:class:`ProfileSession` wraps a window of executor steps in a
``torch.profiler.profile`` (CPU and, on the card, CUDA activity) and, at
close, exports its chrome trace, reads it (trace_parse), joins kernels
to ProgramDesc ops (attribution), publishes the measured gauges
(``executor_devtime_seconds{op=}``, ``executor_mfu_measured{key=}``,
``profile_attribution_coverage``) and writes ``device_profile.json``
into a caller-given capture directory.

Entry points:

- ``monitor.profile_session(steps=N)``: an N-step window, closed by the
  executor's step telemetry (``monitor.record_step`` calls
  :func:`on_step` through a one-branch hook);
- ``FLAGS.profile_steps=N``: one capture of the first N monitored steps;
- ``FLAGS.profile_on_slow_step``: the slow-step detector arms a
  rate-limited capture and attaches its report as a
  ``slow_step_profile`` flight record;
- ``GET /profile?steps=N`` on the live plane.

Only one ``torch.profiler`` can run in a process: a session is
exclusive, and starting one raises while any profiler (another session,
a caller's own, the executor's plan-table recording) is active. The
executor's plan-table recording (:func:`claim_private`) never starts one
while a session is open or armed; a plan warmed up inside a session
takes its table from the session's trace.

Threads: ``torch.profiler`` records ``record_function`` ranges on the
thread that started it only (its callbacks are thread-local), while
CUDA activity is process-wide. So a step-counted window (``steps=N``) is
*armed* where it is asked for (the caller's thread, the HTTP thread) and
*started* by the next monitored ``Executor.run`` on the thread that runs
it, under the executor's lock, before the run's plan lookup; it stops
after the N-th step on that thread. A manual window (a ``with`` block)
starts on the calling thread.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import warnings
from typing import Any, Dict, Optional

from . import attribution, trace_parse

__all__ = ["ProfileSession", "start_session", "active_session",
           "last_profile", "on_step", "autoarm", "capture_on_slow_step",
           "profiler_active", "claim_private", "release_private",
           "begin_armed"]

_lock = threading.Lock()
_active: Optional["ProfileSession"] = None
_private = False
_last: Optional[Dict[str, Any]] = None
_slow_capture_last = 0.0


def profiler_active() -> bool:
    """Is a torch profiler (any, this package's or a caller's) running
    in this process?"""
    import torch
    return bool(torch._C._autograd._profiler_enabled())


def _activities():
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def claim_private() -> bool:
    """Claim the process's one profiler for a private recording (the
    executor's plan table): False while a session is open or armed,
    another private recording runs, or any profiler is active on this
    thread. A True claim is given back with :func:`release_private`."""
    global _private
    with _lock:
        if _active is not None or _private or profiler_active():
            return False
        _private = True
        return True


def release_private() -> None:
    global _private
    with _lock:
        _private = False


class ProfileSession:
    """One capture window. Use as a context manager (manual window) or
    with ``steps=N`` (auto-stops after N monitored executor steps).

    ``result`` holds the report dict after :meth:`finish`;
    :meth:`wait` blocks until the step-counted window closes."""

    def __init__(self, steps: Optional[int] = None,
                 trace_dir: Optional[str] = None,
                 on_finish=None):
        self.steps = int(steps) if steps else 0
        self._own_dir = trace_dir is None
        self.trace_dir = trace_dir
        self.result: Optional[Dict[str, Any]] = None
        self._seen = 0
        self._done = threading.Event()
        self._state_lock = threading.Lock()
        self._prof = None
        self._thread = None
        self._finished = False
        self._t0 = 0.0
        self._on_finish = on_finish
        self._calls0: Dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------
    def _claim(self) -> None:
        global _active
        with _lock:
            if _active is not None or _private or profiler_active():
                raise RuntimeError(
                    "a profile session is already active (one "
                    "torch.profiler per process)")
            _active = self

    def start(self) -> "ProfileSession":
        """Claim the profiler and start tracing on this thread."""
        if self._prof is not None:
            return self
        if _active is not self:
            self._claim()
        return self._begin()

    def _begin(self) -> "ProfileSession":
        global _active
        from torch.profiler import profile

        self._thread = threading.get_ident()
        if self.trace_dir is None:
            self.trace_dir = tempfile.mkdtemp(prefix="pt_profile_")
        self._t0 = time.perf_counter()
        try:
            prof = profile(activities=_activities())
            prof.__enter__()
        except BaseException:
            with _lock:
                _active = None
            if self._own_dir:
                shutil.rmtree(self.trace_dir, ignore_errors=True)
            raise
        self._prof = prof
        from .. import monitor
        # segment-run baseline: the close-time delta is the true number
        # of runs of each plan segment inside this window
        self._calls0 = monitor.execute_counts_by_key()
        monitor.log_event("profile_start", dir=self.trace_dir,
                          steps=self.steps)
        return self

    def _step(self, rec: dict) -> None:
        """One executor step landed while this session is open."""
        if self._prof is None or self._thread != threading.get_ident():
            return  # armed and not yet started, or another thread's step
        with self._state_lock:
            self._seen += 1
            hit = self.steps and self._seen >= self.steps
        if hit:
            self.finish()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def finish(self) -> Optional[Dict[str, Any]]:
        """Stop the trace, ingest, publish gauges, build the report.
        Idempotent and thread-safe: the step thread that completes the
        window and an impatient /profile HTTP thread can both call."""
        global _active, _last
        with self._state_lock:
            already = self._finished
            self._finished = True
        if already:
            self._done.wait(timeout=120)
            return self.result
        if (self._prof is not None
                and self._thread != threading.get_ident()):
            # the profiler's callbacks live on the thread that started
            # it: let that thread stop it at its next step
            with self._state_lock:
                self._finished = False
                self.steps = max(1, self._seen + 1)
            if self._done.wait(timeout=60):
                return self.result
            return {"error": "the window's thread ran no further step",
                    "steps": self._seen, "rows": []}
        wall = (time.perf_counter() - self._t0) if self._t0 else 0.0
        path = None
        if self._prof is not None:
            try:
                import torch
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self._prof.__exit__(None, None, None)
                path = os.path.join(self.trace_dir, "trace.json")
                self._prof.export_chrome_trace(path)
            except Exception as e:  # noqa: BLE001 — finish must not raise
                warnings.warn(f"profile session: stopping the trace "
                              f"failed: {e!r}")
            self._prof = None
        with _lock:
            if _active is self:
                _active = None
        from .. import monitor
        monitor._clear_profile_hook(self)
        try:
            self.result = self._ingest(wall, path)
        except Exception as e:  # noqa: BLE001 — profiling never raises
            self.result = {"error": repr(e), "trace_dir": self.trace_dir,
                           "steps": self._seen, "rows": []}
        _last = self.result
        if self._own_dir and self.trace_dir:
            # a session nobody gave a directory (GET /profile, the
            # slow-step escalation, FLAGS.profile_steps without
            # FLAGS.profile_dir) leaves no trace tree behind: the report
            # dict is the artifact
            shutil.rmtree(self.trace_dir, ignore_errors=True)
            if isinstance(self.result, dict):
                self.result["trace_dir_removed"] = True
        self._done.set()
        if self._on_finish is not None:
            try:
                self._on_finish(self.result)
            except Exception:  # noqa: BLE001 — callback is best-effort
                pass
        return self.result

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.finish()
        return False

    # -- ingest --------------------------------------------------------
    def _ingest(self, wall: float, path: Optional[str]) -> Dict[str, Any]:
        from .. import monitor

        peak, _src = monitor.peak_flops()
        calls1 = monitor.execute_counts_by_key()
        calls_by_key = {k: v - self._calls0.get(k, 0)
                        for k, v in calls1.items()
                        if v - self._calls0.get(k, 0) > 0}
        td = (trace_parse.parse_trace_dir(path) if path
              else trace_parse.TraceData())
        # a plan warmed up inside this window has its eager run in this
        # trace: its table comes from here (no second profiler ran)
        for key in attribution.registered_plans():
            if attribution.plan_table(key) is None:
                table = attribution.table_from_trace(td, key)
                if table:
                    attribution.register_plan(key, table=table)
        rep = attribution.attribute(td, peak=peak,
                                    calls_by_key=calls_by_key)
        rep.update({
            "trace_losses": attribution.trace_losses(td),
            "trace_dir": self.trace_dir,
            "trace_file": td.path,
            "platform": td.platform,
            "steps": self._seen,
            "window_wall_s": round(wall, 6),
            "peak_flops": peak,
            "host_t0_perf_counter": self._t0,
        })
        try:
            from .. import profiler as _hostprof
            if getattr(_hostprof, "_epoch", 0.0):
                rep["host_epoch_perf_counter"] = _hostprof._epoch
        except Exception:  # noqa: BLE001 — anchor is best-effort
            pass
        if monitor.enabled():
            monitor.counter("profile_captures_total").inc()
            monitor.gauge("profile_attribution_coverage").set(
                rep["coverage"])
            monitor.gauge("profile_lost_records").set(rep["lost_records"])
            monitor.gauge("profile_misaligned_kernels").set(
                rep["misaligned"])
            for r in rep["rows"][:32]:
                monitor.gauge("executor_devtime_seconds",
                              {"op": r["op"]}).set(r["device_s"])
            for key, mi in rep["modules"].items():
                if mi.get("mfu_measured"):
                    monitor.gauge("executor_mfu_measured",
                                  {"key": key}).set(mi["mfu_measured"])
            monitor.log_event(
                "device_profile", steps=self._seen,
                device_time_s=rep["device_time_s"],
                coverage=rep["coverage"],
                lost_records=rep["lost_records"],
                top=(rep["rows"][0]["op"] if rep["rows"] else None))
        try:
            from . import memory as _mem
            msec = _mem.session_section()
            if msec:
                rep["memory"] = msec
        except Exception:  # noqa: BLE001 — the section is best-effort
            pass
        try:
            gsec = monitor.generation_plane()
            if gsec.get("predictors") or any(gsec["latency"].values()):
                rep["generation"] = gsec
        except Exception:  # noqa: BLE001 — the section is best-effort
            pass
        if not self._own_dir:
            try:
                with open(os.path.join(self.trace_dir,
                                       "device_profile.json"), "w") as f:
                    json.dump(rep, f, indent=1, default=str)
            except OSError:
                pass
        return rep


def start_session(steps: Optional[int] = None,
                  trace_dir: Optional[str] = None,
                  on_finish=None) -> ProfileSession:
    """Create a session: a manual window (``steps`` None) starts here;
    a step-counted one is armed, started by the next monitored executor
    run on its own thread, and wired to the monitor's one-branch step
    hook."""
    from .. import monitor

    if steps and not monitor.enabled():
        raise RuntimeError(
            "profile_session(steps=N) counts executor steps through "
            "the monitor: call monitor.enable() (or FLAGS_monitor=1) "
            "first; a manual session (steps=None) used as a context "
            "manager works without it")
    sess = ProfileSession(steps=steps, trace_dir=trace_dir,
                          on_finish=on_finish)
    sess._claim()
    if not steps:
        sess._begin()
        return sess
    monitor._set_profile_hook(sess)
    return sess


def begin_armed() -> None:
    """Executor hook (monitor on, at the start of a run, under the
    executor's lock): start an armed step-counted session on this
    thread."""
    sess = _active
    if sess is not None and sess.steps and sess._prof is None \
            and not sess._finished:
        sess._begin()


def active_session() -> Optional[ProfileSession]:
    return _active


def last_profile() -> Optional[Dict[str, Any]]:
    """The most recent completed capture's report (any trigger)."""
    return _last


def on_step(sess: ProfileSession, rec: dict) -> None:
    """monitor.record_step's dispatch target."""
    sess._step(rec)


def autoarm(steps: int) -> None:
    """FLAGS.profile_steps: one capture of the next ``steps`` monitored
    steps, its report in last_profile() and, with FLAGS.profile_dir,
    written there."""
    from ..utils.flags import FLAGS

    d = str(getattr(FLAGS, "profile_dir", "")) or None
    try:
        start_session(steps=steps, trace_dir=d)
    except RuntimeError:
        pass  # a profiler is already running: nothing to arm


def capture_on_slow_step(key: str, reason: str) -> None:
    """Slow-step escalation (FLAGS.profile_on_slow_step): arm one
    capture of the next few steps and attach the report as a flight
    record. Rate-limited (FLAGS.profile_slow_step_cooldown_s) so a
    persistently slow class cannot turn the process into a profiler
    loop."""
    global _slow_capture_last
    from ..utils.flags import FLAGS

    cooldown = float(getattr(FLAGS, "profile_slow_step_cooldown_s",
                             600.0))
    now = time.time()
    with _lock:
        if _active is not None or now - _slow_capture_last < cooldown:
            return
        _slow_capture_last = now
    steps = int(getattr(FLAGS, "profile_steps", 0) or 0) or 3

    def _attach(rep: Dict[str, Any]) -> None:
        from .. import monitor

        top = rep.get("rows") or []
        monitor.flight_record(
            "slow_step_profile",
            extra={"trigger_key": key, "trigger_reason": reason,
                   "device_profile": {
                       "coverage": rep.get("coverage"),
                       "device_time_s": rep.get("device_time_s"),
                       "lost_records": rep.get("lost_records"),
                       "steps": rep.get("steps"),
                       "top": [{k: r.get(k) for k in
                                ("op", "device_s", "share", "source")}
                               for r in top[:8]],
                       "trace_dir": rep.get("trace_dir")}})

    try:
        start_session(steps=steps, on_finish=_attach)
    except RuntimeError:
        pass  # raced another trigger: the capture it armed covers us
