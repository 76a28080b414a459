"""Autoregressive generation (counterpart of
``paddle_tpu/inference/generation``): bucketed prefill through the
executor's plans into a resident KV cache (dense, or paged with radix
prefix reuse), one captured CUDA graph per decode chunk, and greedy and
temperature/top-k sampling with a per-slot counter-based stream, and
``GenerationPredictor``: continuous batching behind the serving front,
with request traces (``trace_span_coverage`` reads one)."""

from .engine import (DecodeEngine, PagedSlotState, SlotState,
                     collect_tokens, naive_generate)
from .predictor import GenerationPredictor, trace_span_coverage
from .sampling import SamplingParams
from .spec import GenerationSpec

__all__ = ["DecodeEngine", "SlotState", "PagedSlotState", "GenerationSpec",
           "GenerationPredictor", "SamplingParams", "naive_generate",
           "collect_tokens", "trace_span_coverage"]
