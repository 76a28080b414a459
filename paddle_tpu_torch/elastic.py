"""Elastic training: the preemption supervisor (counterpart of
``paddle_tpu/elastic.py``).

A scheduler preempts a trainer with SIGTERM and a grace window, then
SIGKILL; a resumed run must be bit for bit the run that was not
interrupted, or every preemption changes the model.
:class:`ElasticTrainer` is that contract as a run loop:

- **cadence checkpoints**: every ``save_every_steps`` steps and/or
  ``save_every_secs`` seconds, through ``io.AsyncCheckpointer`` (a device
  copy of the persistables, written on a thread), so the step loop pays
  only the copy. The cadence counts from the last save started; a writer
  slower than the cadence is joined by the next save. (The JAX trainer
  counts from the last save completed, so behind a writer slower than
  the cadence it saves at every step, each save joining the one before;
  tests/test_torch_elastic.py pins both.) ``health()``'s age counts from
  the last save completed;
- **train state**: each checkpoint carries train_state.json
  (``io.capture_train_state``): the scope's generators' states, the step
  and the DataLoader cursor;
- **preemption**: a SIGTERM handler sets a flag that the loop reads at
  step boundaries; the trainer then writes an emergency checkpoint
  (synchronously, since the process is about to end) and exits with
  :data:`RESUME_EXIT_CODE`, so a babysitter restarts it instead of
  reporting a failure. The ``preemption`` fault site
  (``testing/faults.py``, ``exc=Preempted``) scripts the same path;
- **restore**: the newest complete checkpoint's persistables (in place),
  generators, step and loader cursor (fast-forwarded on the loader's
  thread).

``main_program`` may be a CompiledProgram: the loop runs it, and the
checkpoints hold its program's persistables. With the monitor on the
trainer counts ``elastic_restores_total``,
``elastic_checkpoints_total{kind=}`` and ``elastic_preemptions_total``
and gauges ``elastic_step``, ``elastic_resume_step`` and
``checkpoint_age_seconds``, as the JAX package's does; ``health()`` is
registered for ``/healthz`` as ``elastic_trainer``, and a failed
emergency checkpoint writes a flight record.

A worker::

    trainer = pt.elastic.ElasticTrainer(exe, ckpt_dir, main_program=main,
                                        loader=loader, save_every_steps=50)
    start = trainer.restore()          # 0 on a fresh start
    trainer.run(loader, fetch_list=[loss], iterations=K)

and its babysitter: ``while run(): if exit_code != RESUME_EXIT_CODE:
break``.
"""

from __future__ import annotations

import signal
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Optional, Sequence

from . import io as _io
from . import monitor as _monitor
from .framework import default_main_program
from .testing import faults as _faults
from .utils.flags import FLAGS

__all__ = ["ElasticTrainer", "Preempted", "RESUME_EXIT_CODE"]

# the resume-me exit status: a babysitter restarts on exactly this code
# and treats any other as a failure
RESUME_EXIT_CODE = 42


class Preempted(RuntimeError):
    """The run loop is being preempted: checkpoint and exit with
    RESUME_EXIT_CODE. Raised by the loop after SIGTERM, or injected at
    the ``preemption`` fault site."""


class ElasticTrainer:
    """A run loop with checkpoints on a cadence and preemption recovery."""

    def __init__(self, executor, checkpoint_dir, main_program=None,
                 loader=None, trainer_id: int = 0, num_trainers: int = 1,
                 save_every_steps: int = 0, save_every_secs: float = 0.0,
                 max_num_checkpoints: int = 3,
                 age_budget_s: Optional[float] = None,
                 async_save: bool = True,
                 install_signal_handler: bool = True,
                 resume_exit_code: int = RESUME_EXIT_CODE,
                 scope=None):
        from .executor import global_scope

        self._exe = executor
        self._dir = checkpoint_dir
        self._main = main_program or default_main_program()
        self._loader = loader
        self._trainer_id = int(trainer_id)
        self._num_trainers = int(num_trainers)
        self.save_every_steps = int(save_every_steps)
        self.save_every_secs = float(save_every_secs)
        self._max_keep = int(max_num_checkpoints)
        self._age_budget = (float(FLAGS.ckpt_age_budget_s)
                            if age_budget_s is None else float(age_budget_s))
        self._scope = scope or global_scope()
        self._ckpt = _io.AsyncCheckpointer() if async_save else None
        self._resume_exit_code = int(resume_exit_code)
        self._step = 0
        self._cadence_step = 0    # the step of the last save started
        self._last_save_step = 0  # ... and of the last one completed
        self._last_save_t = time.monotonic()  # the age clock's anchor
        self._preempted = threading.Event()
        self._prev_sigterm = None
        if install_signal_handler and \
                threading.current_thread() is threading.main_thread():
            # the handler only sets a flag; the loop writes the emergency
            # checkpoint at the next step boundary, not in the signal frame
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, self._on_sigterm)
        _monitor.register_health("elastic_trainer", self.health)

    def _on_sigterm(self, signum, frame):
        self._preempted.set()

    @property
    def global_step(self) -> int:
        return self._step

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    def request_preemption(self):
        """What SIGTERM does, for tests and in-process babysitters: the
        loop checkpoints and exits at the next step boundary."""
        self._preempted.set()

    def restore(self) -> int:
        """Restore the newest complete checkpoint: the persistables and
        generators (``load_checkpoint``), then the step and the
        DataLoader cursor of its train state. Returns the step (0 on a
        fresh start)."""
        step = _io.load_checkpoint(self._exe, self._dir,
                                   main_program=self._main,
                                   trainer_id=self._trainer_id,
                                   scope=self._scope)
        if step is None:
            return 0
        state = _io.read_train_state(self._dir, step=step,
                                     trainer_id=self._trainer_id)
        self._step = int((state or {}).get("step", step))
        if self._loader is not None and state and state.get("data_cursor"):
            self._loader.load_state_dict(state["data_cursor"])
        self._cadence_step = self._last_save_step = self._step
        self._last_save_t = time.monotonic()
        if _monitor._enabled:
            _monitor.counter("elastic_restores_total").inc()
            _monitor.gauge("elastic_resume_step").set(self._step)
        _monitor.log_event("elastic_restore", step=self._step)
        return self._step

    def checkpoint(self, wait: bool = False, path_label: str = "cadence"):
        """A checkpoint of the current step (persistables, generators,
        loader cursor); asynchronous unless the trainer was made with
        ``async_save=False``. ``wait`` joins the writer (an emergency or
        final save must not ride a daemon thread into the process's
        end). ``path_label`` is the ``elastic_checkpoints_total`` kind."""
        state = _io.capture_train_state(self._step, scope=self._scope,
                                        loader=self._loader)
        step = self._cadence_step = self._step

        def anchor():
            # the age clock moves only when a checkpoint is published and
            # marked (on the writer thread): a failed or stuck writer
            # keeps the age growing, so health() turns unhealthy
            self._last_save_step = step
            self._last_save_t = time.monotonic()

        if self._ckpt is not None:
            self._ckpt.save(self._exe, self._dir, step,
                            main_program=self._main,
                            trainer_id=self._trainer_id,
                            num_trainers=self._num_trainers,
                            max_num_checkpoints=self._max_keep,
                            scope=self._scope, train_state=state,
                            on_success=anchor)
            if wait:
                self._ckpt.wait()
        else:
            _io.save_checkpoint(self._exe, self._dir, step,
                                main_program=self._main,
                                trainer_id=self._trainer_id,
                                num_trainers=self._num_trainers,
                                max_num_checkpoints=self._max_keep,
                                train_state=state, scope=self._scope)
            anchor()
        if _monitor._enabled:
            _monitor.counter("elastic_checkpoints_total",
                             {"kind": path_label}).inc()

    def _due(self) -> bool:
        if self.save_every_steps > 0 and (
                self._step - self._cadence_step >= self.save_every_steps):
            return True
        if self.save_every_secs > 0 and (
                time.monotonic() - self._last_save_t >= self.save_every_secs):
            return True
        return False

    def run(self, feed_iter: Iterable, fetch_list: Sequence = (),
            iterations: int = 1, max_steps: Optional[int] = None,
            on_step: Optional[Callable[[int, Any], None]] = None,
            return_numpy: bool = True, save_on_exit: bool = True):
        """Train over ``feed_iter`` (a DataLoader or any iterable of
        feeds), checkpointing on the cadence. With ``iterations=K`` each
        feed is a [K, ...] super-batch (``DataLoader(steps_per_batch=K)``)
        and the step advances by K per call. ``max_steps`` counts global
        steps: a resumed run passes the same budget and trains the rest.
        Preemption (SIGTERM, ``request_preemption()`` or an injected
        :class:`Preempted`) checkpoints synchronously and raises
        ``SystemExit(resume_exit_code)``. Returns the last fetches (None
        if no step ran)."""
        out = None
        iterations = max(1, int(iterations))
        it = iter(feed_iter)
        try:
            while True:
                # checked before the next feed is drawn: a DataLoader
                # advances its cursor when it yields, so a feed drawn and
                # then left would checkpoint a cursor one batch ahead of
                # the step, and the resumed run would skip that batch
                _faults.fire("preemption")
                if self._preempted.is_set():
                    raise Preempted("SIGTERM received")
                if max_steps is not None and self._step >= max_steps:
                    break
                try:
                    feed = next(it)
                except StopIteration:
                    break
                out = self._exe.run(self._main, feed=feed,
                                    fetch_list=list(fetch_list),
                                    iterations=iterations,
                                    scope=self._scope,
                                    return_numpy=return_numpy)
                self._step += iterations
                if _monitor._enabled:
                    _monitor.gauge("elastic_step").set(self._step)
                    _monitor.gauge("checkpoint_age_seconds").set(
                        round(time.monotonic() - self._last_save_t, 3))
                if on_step is not None:
                    on_step(self._step, out)
                if self._preempted.is_set():
                    # the step in flight when SIGTERM came has completed:
                    # checkpoint that one
                    raise Preempted("SIGTERM received")
                if self._due():
                    self.checkpoint()
        except Preempted as e:
            # the checkpoint first, out of the grace window; then a
            # DataLoader's iteration closes (its producer thread joined)
            # before the process exits
            try:
                self._emergency_exit(e)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
        if save_on_exit and self._step > self._last_save_step:
            # joined, so "run() returned" means "the run is restorable"
            self.checkpoint(wait=True, path_label="final")
        return out

    def _emergency_exit(self, cause: Preempted):
        warnings.warn(f"elastic: preempted at step {self._step} "
                      f"({cause}); writing an emergency checkpoint and "
                      f"exiting {self._resume_exit_code} (resume-me)")
        if _monitor._enabled:
            _monitor.counter("elastic_preemptions_total").inc()
        _monitor.log_event("elastic_preempted", step=self._step)
        try:
            self.checkpoint(wait=True, path_label="emergency")
        except BaseException as e:  # noqa: BLE001 — still exit resumable
            # the previous cadence checkpoint is still complete
            warnings.warn(f"elastic: emergency checkpoint failed ({e!r}); "
                          "resume will use the previous complete one")
            _monitor.flight_record(
                "emergency_ckpt_failure",
                extra={"step": self._step, "error": repr(e)})
        raise SystemExit(self._resume_exit_code)

    def health(self) -> dict:
        """Unhealthy when the newest complete checkpoint is older than the
        age budget (a stuck writer or a loop of failed saves shows here
        before a preemption turns it into lost work)."""
        age = time.monotonic() - self._last_save_t
        if _monitor._enabled:
            _monitor.gauge("checkpoint_age_seconds").set(round(age, 3))
        return {
            "healthy": self._age_budget <= 0 or age <= self._age_budget,
            "checkpoint_age_seconds": round(age, 3),
            "age_budget_s": self._age_budget,
            "step": self._step,
            "last_checkpoint_step": self._last_save_step,
            "preempted": self._preempted.is_set(),
        }

    def close(self):
        """Join any save in flight, unregister the health callback and
        restore the previous SIGTERM handler."""
        try:
            if self._ckpt is not None:
                self._ckpt.close()
        finally:
            _monitor.unregister_health("elastic_trainer")
            if self._prev_sigterm is not None:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
                self._prev_sigterm = None
