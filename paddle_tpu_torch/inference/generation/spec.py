"""Model contract of the generation engine (counterpart of
``paddle_tpu/inference/generation/spec.py``).

A :class:`GenerationSpec` is everything the decode engine needs to know
about a model family: how to build a prefill program for a prompt
bucket, how to build the single-token decode-step program for a cache
capacity, and the id conventions (eos/pad, vocab). Builders must name
every parameter EXPLICITLY so any bucket combination shares the one
parameter set ``startup`` initializes (models/transformer.build_lm is
the in-tree instance).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["GenerationSpec"]


@dataclass
class GenerationSpec:
    """Decode-mode model bundle.

    ``build_prefill(tp, startup=None) -> (Program, io)`` — full-sequence
    causal forward over a static prompt bucket ``tp``; ``io`` maps
    ``tokens``/``pos``/``length`` feed names and ``logits``/``k``/``v``
    fetch names (k/v: per-layer split-heads [B, H, tp, d_head]).

    ``build_decode(cap, startup=None) -> (Program, io)`` — one-token
    step against a fixed-capacity cache; ``io`` maps ``token``/``pos``
    feeds, per-layer ``cache_k``/``cache_v`` cache feeds, and
    ``logits``/``new_k``/``new_v`` fetches. The step must be pure
    device ops (no host ops, no RNG ops): the engine captures it.

    ``build_prefill_prefix(ts, pc, startup=None) -> (Program, io)`` —
    OPTIONAL (None disables the radix prefix cache for this model):
    prefill of a ``ts``-bucket prompt SUFFIX attending over a reused
    K/V prefix of padded length ``pc``. Extra ``io`` names:
    ``prefix_len`` feed (valid prefix tokens <= pc; the padding is
    masked, so ONE program per (ts, pc) serves every hit depth) and
    per-layer ``prefix_k``/``prefix_v`` feeds (split-heads
    [B, H, pc, d_head], gathered from the page pool). ``pos`` carries
    GLOBAL positions (prefix_len + suffix index) so the suffix embeds
    where the full prompt would; fetched ``k``/``v`` cover only the
    suffix rows.
    """

    vocab: int
    eos_id: int
    pad_id: int
    n_layer: int
    n_head: int
    d_head: int
    max_positions: int
    startup: Any  # Program
    build_prefill: Callable[..., Tuple[Any, Dict[str, Any]]]
    build_decode: Callable[..., Tuple[Any, Dict[str, Any]]]
    cache_dtype: str = "float32"
    build_prefill_prefix: Optional[
        Callable[..., Tuple[Any, Dict[str, Any]]]] = None
