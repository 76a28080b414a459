"""Deterministic fault injection by fault-site name (counterpart of
``paddle_tpu/testing/faults.py``).

Serving failures are thread-level: a dispatch that throws mid-coalesce,
a latency spike that expires queued deadlines, a dispatcher thread that
dies. Tests script them exactly: "the 3rd dispatch fails", "10% of calls
fail under seed 0", "call 5 stalls 50 ms". This module is that script.

Runtime code calls ``faults.fire("<site>")`` at named fault sites. With
no plan installed that is one module-attribute load and a branch. With a
:class:`FaultPlan` installed, the site's rules run against the site's
call index:

- ``plan.fail(site, calls={2, 5})``      raise on the 3rd and 6th call
- ``plan.fail(site, every=10)``          raise on every 10th call
- ``plan.fail(site, rate=0.1, times=4)`` seeded-random 10%, at most 4 times
- ``plan.delay(site, rate=0.05, seconds=0.02)``  latency spikes

Determinism contract: per-site call indices are assigned under the plan
lock, and rate draws come from a per-rule ``RandomState(seed)`` stream in
index order, so *which call indices* fault is a function of (seed, rule
order) alone, the same as in the JAX package, whatever the thread
interleaving. (Which *thread* owns an index depends on scheduling; tests
assert on counts and typed outcomes, not thread identity.)

Sites in this package (grep ``faults.fire`` for ground truth):

- ``executor.run``            entry of every Executor.run call
- ``serving.dispatch``        BatchingPredictor device call (per try)
- ``serving.dispatcher``      dispatcher loop tick (crash the thread)
- ``serving.bucket_dispatch`` BucketedPredictor padded chunk call
- ``ckpt_write``              a checkpoint's staging directory written,
                              before it is published and marked (sync
                              save and the async writer)
- ``preemption``              ElasticTrainer step boundary (pass
                              ``exc=elastic.Preempted``)

The JAX package's ``cluster.rank_delay`` waits for the cross-rank plane
of ROADMAP A12.
``executor.compile`` has no counterpart: the port builds no executable
that could fail apart from the run that uses it.

Injected failures raise :class:`FaultInjected` by default (pass ``exc=``
for a custom type). With the monitor on every firing also counts as
``fault_injections_total{site=,kind=}`` (kind ``delay`` or ``fail``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from .. import monitor as _monitor

__all__ = ["FaultInjected", "FaultPlan", "fire", "active_plan"]


class FaultInjected(RuntimeError):
    """The error a scripted ``fail`` rule raises at its fault site."""


class _Rule:
    """One scripted behavior at one site. Matching is by the site's
    0-based call index; ``rate`` draws a seeded Bernoulli PER INDEX
    (stream position == call index, so the faulting index set is
    deterministic). ``times`` caps total firings of this rule."""

    __slots__ = ("kind", "calls", "every", "rate", "rng", "times",
                 "fired", "exc", "message", "seconds")

    def __init__(self, kind: str, calls: Optional[Sequence[int]] = None,
                 every: Optional[int] = None, rate: Optional[float] = None,
                 seed: int = 0, times: Optional[int] = None,
                 exc: type = FaultInjected, message: str = "",
                 seconds: float = 0.0):
        if (calls is None) + (every is None) + (rate is None) != 2:
            raise ValueError(
                "exactly one selector per rule: calls=, every=, or rate=")
        self.kind = kind
        self.calls: Optional[Set[int]] = (None if calls is None
                                          else {int(c) for c in calls})
        self.every = int(every) if every is not None else None
        self.rate = float(rate) if rate is not None else None
        self.rng = np.random.RandomState(seed) if rate is not None else None
        self.times = times
        self.fired = 0
        self.exc = exc
        self.message = message
        self.seconds = float(seconds)

    def matches(self, idx: int) -> bool:
        """Called under the plan lock, once per site call, in index
        order: the rate stream advances on every call, so index i always
        consumes draw i. It does not commit the firing: the plan commits
        (``fired``) only a rule whose effect applies, so a second fail
        rule matching the same index neither raises nor uses up its
        ``times`` budget."""
        hit = False
        if self.calls is not None:
            hit = idx in self.calls
        elif self.every is not None:
            hit = self.every > 0 and (idx + 1) % self.every == 0
        else:
            hit = bool(self.rng.rand() < self.rate)
        if hit and self.times is not None and self.fired >= self.times:
            return False
        return hit


class FaultPlan:
    """A scripted set of fault rules, installed process-wide.

    Use as a context manager so a failing test can never leak faults
    into the rest of the suite::

        with FaultPlan(seed=0).fail("serving.dispatch", rate=0.1) \\
                              .delay("serving.dispatch", calls=[3],
                                     seconds=0.05):
            ...drive the predictor...
    """

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._rules: Dict[str, List[_Rule]] = {}
        self._counts: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- scripting --------------------------------------------------------
    def fail(self, site: str, calls: Optional[Sequence[int]] = None,
             every: Optional[int] = None, rate: Optional[float] = None,
             times: Optional[int] = None, exc: type = FaultInjected,
             message: str = "") -> "FaultPlan":
        self._rules.setdefault(site, []).append(_Rule(
            "fail", calls=calls, every=every, rate=rate, seed=self._seed,
            times=times, exc=exc, message=message))
        return self

    def delay(self, site: str, calls: Optional[Sequence[int]] = None,
              every: Optional[int] = None, rate: Optional[float] = None,
              times: Optional[int] = None, seconds: float = 0.01
              ) -> "FaultPlan":
        self._rules.setdefault(site, []).append(_Rule(
            "delay", calls=calls, every=every, rate=rate,
            # decorrelate delay draws from fail draws at the same site
            seed=self._seed + 0x5EED, times=times, seconds=seconds))
        return self

    # -- install / inspect ------------------------------------------------
    def install(self) -> "FaultPlan":
        global _active
        with _install_lock:
            if _active is not None and _active is not self:
                raise RuntimeError("another FaultPlan is already installed")
            _active = self
        return self

    def remove(self):
        global _active
        with _install_lock:
            if _active is self:
                _active = None

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc):
        self.remove()
        return False

    def calls(self, site: str) -> int:
        """How many times the site fired (matched or not)."""
        with self._lock:
            return self._counts.get(site, 0)

    def injected(self, site: str) -> int:
        """How many faults (fail + delay) actually triggered there."""
        with self._lock:
            return self._injected.get(site, 0)

    # -- runtime ----------------------------------------------------------
    def _fire(self, site: str):
        sleep_s = 0.0
        raise_rule: Optional[_Rule] = None
        with self._lock:
            idx = self._counts.get(site, 0)
            self._counts[site] = idx + 1
            for rule in self._rules.get(site, ()):
                if not rule.matches(idx):
                    continue
                if rule.kind == "delay":
                    # every matched delay applies (sleeps accumulate)
                    rule.fired += 1
                    self._injected[site] = self._injected.get(site, 0) + 1
                    sleep_s += rule.seconds
                elif raise_rule is None:
                    # only the FIRST matching fail rule raises: later
                    # matches neither count as injected nor consume
                    # their times= budget
                    rule.fired += 1
                    self._injected[site] = self._injected.get(site, 0) + 1
                    raise_rule = rule
        if _monitor._enabled and (sleep_s or raise_rule is not None):
            if sleep_s:
                _monitor.counter("fault_injections_total",
                                 {"site": site, "kind": "delay"}).inc()
            if raise_rule is not None:
                _monitor.counter("fault_injections_total",
                                 {"site": site, "kind": "fail"}).inc()
        # act outside the lock: a sleeping or raising rule must not stall
        # other sites (or other threads hitting this site)
        if sleep_s:
            time.sleep(sleep_s)
        if raise_rule is not None:
            raise raise_rule.exc(
                raise_rule.message
                or f"injected fault at {site!r} (testing/faults.py)")


_install_lock = threading.Lock()
_active: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _active


def fire(site: str):
    """Fault-site hook. One load and a branch when no plan is installed."""
    plan = _active
    if plan is None:
        return
    plan._fire(site)
