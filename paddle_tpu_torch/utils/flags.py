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
    # check the pipeline's invariants after every stage (ir/verify.py in
    # the JAX package); not ported, so a run that asks for it raises
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
