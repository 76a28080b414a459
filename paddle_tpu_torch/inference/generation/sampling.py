"""Token sampling for the decode loop: greedy and temperature/top-k with a
per-slot random stream (counterpart of
``paddle_tpu/inference/generation/sampling.py``).

The JAX package carries a threefry key per slot and splits it once per
step. Threefry is not matched here (ROADMAP C "RNG": the streams differ
by design); the port's stream keeps the properties the engine relies on:

- counter-based: a slot's row is (key, counter), key = f(seed), and every
  step draws from a hash of (key, counter, vocabulary id) and advances the
  counter by one, greedy rows too. No ``torch.Generator`` state is read,
  so the draw runs inside a captured CUDA graph as it runs eagerly;
- private to the request: a request's draws depend on its seed and its
  step only, whatever its slot and its neighbours;
- a categorical draw by Gumbel-max: argmax(logits / T + g) with
  g = -log(-log(u)) over a hashed uniform u per vocabulary id; the top-k
  draw takes the same noise at the k largest ids, so it is the full draw
  restricted to the window.

Keys and counters are 32-bit values held in int64 tensors (torch's uint32
support is thin); the hash multiplies by constants below 2**31 and masks
to 32 bits after each product, so no intermediate leaves int64's range.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SamplingParams", "make_rng_row", "sample_step", "vocab_hash",
           "uniforms"]

_M32 = 0xFFFFFFFF
_C1 = 0x7FEB352D
_C2 = 0x2C1B3C6D
_C3 = 0x297A2D39
_GOLDEN = 0x9E3779B9


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. ``temperature <= 0`` is greedy (argmax;
    the stream never influences the tokens); ``top_k = 0`` samples the
    full vocabulary; ``seed`` roots the request's private stream."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


GREEDY = SamplingParams()


def _mix_int(x: int) -> int:
    """The 32-bit mixer of ``_mix`` on a Python int."""
    x &= _M32
    x ^= x >> 16
    x = (x * _C1) & _M32
    x ^= x >> 15
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer on int64 tensors holding values in
    [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def make_rng_row(seed: int) -> np.ndarray:
    """The (key, counter) row a request carries through the decode loop:
    the key mixes both halves of the 64-bit seed, the counter starts at
    0. Built on the host, so admission makes no device call for it."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = _mix_int((s & _M32) ^ _mix_int((s >> 32) + _GOLDEN))
    return np.array([key, 0], dtype=np.int64)


def vocab_hash(vocab: int, device) -> torch.Tensor:
    """The per-id half of the hash, [vocab] int64: made once per engine,
    outside any graph, and read by every draw."""
    ids = torch.arange(vocab, dtype=torch.int64, device=device)
    return _mix((ids * _C3 + _GOLDEN) & _M32)


def uniforms(rngs: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """[S, V] float32 uniforms in (0, 1) of rows (key, counter) [S, 2]
    over the vocabulary hash ``vh`` [V]: 24 bits of a hash of the three,
    centred in their interval, so neither 0 nor 1 occurs."""
    base = _mix(rngs[:, 0] ^ _mix((rngs[:, 1] * _C3 + 1) & _M32))
    h = _mix(base[:, None] ^ vh[None, :])
    return ((h >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def sample_step(logits, rngs, temps, topks, top_k_max: int, vh=None):
    """One sampling step over every slot.

    logits [S, V] float32; rngs [S, 2] int64 (key, counter); temps [S]
    float32; topks [S] int. Returns (tokens [S] int32, the next rngs).
    ``top_k_max`` is the static top-k window; per-slot ``topks`` mask
    inside it (0 = full vocabulary). ``top_k_max <= 0`` is the greedy-only
    step: argmax, and the rngs pass through untouched. ``vh`` is
    ``vocab_hash(V, device)``, made here when not given."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k_max <= 0:
        return greedy, rngs
    if vh is None:
        vh = vocab_hash(logits.shape[-1], logits.device)
    noise = -torch.log(-torch.log(uniforms(rngs, vh)))
    new_rngs = torch.stack([rngs[:, 0], (rngs[:, 1] + 1) & _M32], dim=1)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    full = torch.argmax(scaled + noise, dim=-1)
    k = min(int(top_k_max), logits.shape[-1])
    topv, topi = torch.topk(scaled, k, dim=-1)
    ranks = torch.arange(k, device=logits.device)[None, :]
    keep = ranks < torch.clamp(topks.long(), 1, k)[:, None]
    masked = (topv + noise.gather(1, topi)).masked_fill(~keep,
                                                         float("-inf"))
    choice = torch.argmax(masked, dim=-1)
    topk_tok = topi.gather(1, choice[:, None])[:, 0]
    sampled = torch.where(topks > 0, topk_tok, full)
    toks = torch.where(temps <= 0.0, greedy.long(), sampled)
    return toks.to(torch.int32), new_rngs
