"""Measured device-time profiling and the memory-footprint plane.

Counterpart of ``paddle_tpu/profiling``. It closes the loop from what the
host observed (the monitor's step telemetry) to what the card did: per-op
device time, joined back to ProgramDesc structure through the
``record_function("<type>.<out>")`` labels the executor plants with the
monitor on, and through each captured plan's labelled kernel table.

Layout:

- :mod:`trace_parse`: reads the chrome trace ``torch.profiler`` exports;
- :mod:`attribution`: the plan registry and tables, and the per-op table
  (direct, fusion and unattributed rows, coverage, lost records);
- :mod:`session`: capture windows (``profile_session``,
  ``FLAGS.profile_steps``, slow-step escalation), gauges and the
  ``device_profile.json`` report;
- :mod:`memory`: the static liveness footprint per plan segment, the
  memory pre-flight, the registry behind ``GET /memory``, and the
  predicted-against-measured agreement gauges.

Imported lazily: the monitor and the executor import it only when the
monitor is on or a memory budget is set, so ``import paddle_tpu_torch``
never does.
"""

from __future__ import annotations

from .attribution import (program_label, register_plan,  # noqa: F401
                          registered_plans, table_from_trace)
from .memory import (FootprintReport, MemoryBudgetExceeded,  # noqa: F401
                     program_footprint, segment_footprint)
from .session import (ProfileSession, active_session, autoarm,  # noqa: F401
                      capture_on_slow_step, last_profile, on_step,
                      start_session)
from .trace_parse import (TraceData, find_trace_file,  # noqa: F401
                          load_chrome_trace, parse_trace, parse_trace_dir)

__all__ = [
    "ProfileSession", "start_session", "active_session", "last_profile",
    "on_step", "autoarm", "capture_on_slow_step",
    "register_plan", "registered_plans", "table_from_trace",
    "program_label",
    "TraceData", "find_trace_file", "load_chrome_trace", "parse_trace",
    "parse_trace_dir",
    "FootprintReport", "MemoryBudgetExceeded", "segment_footprint",
    "program_footprint",
]
