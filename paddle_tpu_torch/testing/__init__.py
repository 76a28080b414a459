"""Deterministic test harnesses: fault injection and the tiny model the
serving tests serve (counterpart of ``paddle_tpu/testing``).

Nothing here runs in production paths: the hook the runtime calls
(``faults.fire``) is one attribute load and a branch when no plan is
installed.
"""

from . import faults, models
from .faults import FaultInjected, FaultPlan

__all__ = ["faults", "models", "FaultInjected", "FaultPlan"]
