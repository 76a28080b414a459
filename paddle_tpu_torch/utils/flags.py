"""Global flags, env-bootstrapped: an environment variable
``FLAGS_<name>`` read at import overrides the default. Only the flags this
package reads are declared."""

from __future__ import annotations

import os
from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    # seed of the startup program's random initializers when the
    # program's random_seed is 0
    "seed": 0,
    # capture each op's Python creation callstack (user frames) at
    # append_op time; 0 disables for build-time-critical loops
    "op_callstack": True,
    # run BuildStrategy.fuse_all_optimizer_ops on CPU places too (off by
    # default, as in the JAX package, so CPU runs compare per-parameter
    # updates with per-parameter updates)
    "fuse_optimizer_ops_on_cpu": False,
    # run the executor pipeline's NHWC layout stage (ir/pipeline.py
    # conv_layout_nhwc_ops) on every run. The JAX package defaults it on,
    # from a TPU measurement (its conv tilings prefer channels last,
    # paddle_tpu/ir/pipeline.py effective_flags); the port keeps NCHW
    # until the card's numbers (chip_smoke.py phase 9) decide
    "conv_layout_nhwc": False,
    # keep each run's plan on its program and, on a CUDA place, capture
    # it in a CUDA graph at its second run (paddle_tpu/utils/flags.py
    # jit_cache); False keeps none, so every run is eager (the oracle)
    "jit_cache": True,
    # verify a program before its first run and the pipeline's invariants
    # after every stage (ir/verify.py), memoized per program version
    "verify_passes": False,
    # generation (inference/generation), read once when a DecodeEngine is
    # made: the paged KV cache (pages behind a free-list allocator, the
    # default; 0 is the dense [slots, H, cap, D] cache), its tokens per
    # page, and radix prefix reuse over the page pool
    "generation_paged": True,
    "generation_page_size": 8,
    "generation_prefix_cache": True,
    # a GenerationPredictor with live slots that completes no decode step
    # for this many seconds reads healthy=false (0 disables)
    "generation_stall_budget_s": 120.0,
    # checkpoints (io.save_checkpoint, AsyncCheckpointer): how long rank 0
    # waits for every rank's directory before leaving a checkpoint
    # unmarked (load_checkpoint then takes the previous complete one)
    "ckpt_rank_wait_s": 120.0,
    # ElasticTrainer.health(): unhealthy when the newest complete
    # checkpoint is older than this many seconds (0 disables)
    "ckpt_age_budget_s": 0.0,
    # observability (monitor.py), the JAX package's defaults:
    # FLAGS_monitor=1 enables the stats registry and step telemetry at
    # import; the disabled path costs one branch per hook
    "monitor": False,
    # slow-step detector: warn when a step exceeds this factor x the
    # trailing median of the last slow_step_window like steps
    "slow_step_factor": 3.0,
    "slow_step_window": 32,
    # step-telemetry ring buffer capacity (monitor.step_records)
    "monitor_ring": 1024,
    # live plane (monitor.serve_http): a nonzero port starts /metrics,
    # /healthz, /vars, ... on 127.0.0.1 when the monitor is enabled or a
    # predictor is created
    "monitor_port": 0,
    # flight recorder: directory of black-box JSONL dumps on typed
    # failures ("" disables) and its rotation caps (0 disables a cap)
    "flight_record_dir": "",
    "flight_record_max_files": 64,
    "flight_record_max_mb": 256.0,
    # measured profiling (profiling/): a nonzero value profiles the
    # process's first N monitored executor steps; the report goes to
    # monitor.last_profile() and, with profile_dir, device_profile.json
    "profile_steps": 0,
    "profile_dir": "",
    # slow-step escalation: arm a rate-limited capture of the next steps
    # and attach its report as a slow_step_profile flight record
    "profile_on_slow_step": False,
    "profile_slow_step_cooldown_s": 600.0,
    # per-predictor completed-request trace ring (BatchingPredictor.trace)
    "trace_ring": 256,
    # memory pre-flight (profiling/memory.py): refuse a plan whose
    # predicted peak exceeds the card's memory x memory_budget_frac (0
    # disables), or memory_budget_bytes when that is > 0
    "memory_budget_frac": 0.0,
    "memory_budget_bytes": 0,
    # generation SLO budgets in ms read by the /generation plane (0: none)
    "generation_slo_ttft_ms": 0.0,
    "generation_slo_itl_ms": 0.0,
}


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


class _Flags:
    def __init__(self):
        self._values = dict(_DEFAULTS)
        for k, d in _DEFAULTS.items():
            env = os.environ.get("FLAGS_" + k)
            if env is not None:
                self._values[k] = _coerce(d, env)

    def __getattr__(self, name):
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if name == "_values":
            super().__setattr__(name, value)
        elif name not in self._values:
            raise AttributeError(f"unknown flag {name!r}")
        else:
            self._values[name] = value


FLAGS = _Flags()


def memory_budget_set() -> bool:
    """Is a memory budget set (``memory_budget_frac`` or
    ``memory_budget_bytes``)? The memory pre-flight's switch, read
    without importing ``profiling``."""
    return (float(FLAGS.memory_budget_frac) > 0
            or int(FLAGS.memory_budget_bytes) > 0)


def get_flags(names):
    """{name: value} of the flags in ``names`` (a name or a list; the
    ``FLAGS_`` prefix optional)."""
    if isinstance(names, str):
        names = [names]
    return {n: getattr(FLAGS, n.replace("FLAGS_", "")) for n in names}


def set_flags(flags: Dict[str, Any]):
    """Set each flag of ``flags`` ({name: value}, ``FLAGS_`` optional)."""
    for k, v in flags.items():
        setattr(FLAGS, k.replace("FLAGS_", ""), v)
