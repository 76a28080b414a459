"""Flash attention: the hand-written CUDA kernel, its plain version, and
the ``flash_attention`` op.

Counterpart of ``paddle_tpu/ops/pallas_attention.py``. The forward kernel
is ``csrc/flash_attention_fwd.cu`` (blocked online softmax with both
products as TF32 ``mma.sync`` on the tensor cores, 3 split products for
fp32 inputs, fp32 accumulation, O and the logsumexp out).
``flash_attention_fwd`` launches it for tensors on the card and raises
on anything it does not take; for tensors on the CPU it computes
``plain_attention``, the torch transcription of ``_plain_attention``.
There is no fallback from the card to the plain version, and no
key-length gate. ``emulated_attention`` repeats the kernel's TF32
arithmetic on the CPU for the tests.

Causal masking is bottom-right aligned (key c visible to query r when
c <= r + Tk - Tq) in both versions, as ``_plain_attention`` computes it.
"""

from __future__ import annotations

import ctypes

import torch

from ..registry import register_op
from . import _build
from .common import amp_cast, opt, same_shape_infer

# kernel launches by flash_attention_fwd since the count was last reset
launches = 0

_MAX_D = 128
# the kernel's grid: (B*H, query tiles of _BM rows); CUDA caps gridDim.x at
# 2^31 - 1 and gridDim.y at 65535
_BM = 64
_MAX_GRID_X, _MAX_GRID_Y = 2 ** 31 - 1, 65535


def _mask(s, key_bias, causal):
    """Key bias [B, Tk] added to fp32 scores; causal positions -1e30."""
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=s.device).tril(tk - tq)
        s = s.masked_fill(~mask, -1e30)
    return s


def plain_attention(q, k, v, key_bias=None, causal=False, scale=1.0):
    """[B, H, Tq, D] x [B, H, Tk, D] -> (out [B, H, Tq, D] in v's dtype,
    lse [B, H, Tq] fp32). Scores in fp32, key_bias [B, Tk] added after
    the scale, causal positions set to -1e30."""
    s = _mask(torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale,
              key_bias, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v), lse


def tf32_round(x):
    """fp32 -> TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` rounds:
    to nearest, ties away from zero, on the int32 view."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, products):
    """einsum of a and b as the kernel's TF32 ``mma.sync`` computes it:
    1 product of the rounded operands, or 3 (big*big + big*small +
    small*big with big = tf32(x), small = tf32(x - big))."""
    ab, bb = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, ab, bb)
    if products == 3:
        out = (out + torch.einsum(eq, ab, tf32_round(b - bb))
               + torch.einsum(eq, tf32_round(a - ab), bb))
    return out


def emulated_attention(q, k, v, key_bias=None, causal=False, scale=1.0,
                       products=None):
    """The kernel's arithmetic on CPU tensors, for the tests: Q K^T and
    P V as TF32 products with fp32 sums, 3 products for fp32 inputs and 1
    for bf16 inputs (exact in TF32; P rounded to TF32 once). ``products``
    overrides the count. Same outputs as ``plain_attention``."""
    if products is None:
        products = 3 if q.dtype == torch.float32 else 1
    s = _mask(_tf32_product("bhqd,bhkd->bhqk", q.float(), k.float(),
                            products) * scale, key_bias, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = _tf32_product("bhqk,bhkd->bhqd", p, v.float(), products)
    return out.to(v.dtype), lse


def _bind():
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, key_bias):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_fwd: dtype {q.dtype} "
                        "(float32 or bfloat16 only)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_fwd: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention_fwd: q, k, v must be [B, H, T, D] "
                         f"with k and v alike; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B, H or D")
    if (not 1 <= d <= _MAX_D or tq < 1 or k.shape[2] < 1
            or b * h > _MAX_GRID_X or -(-tq // _BM) > _MAX_GRID_Y):
        raise ValueError(f"flash_attention_fwd: unsupported shape "
                         f"{tuple(q.shape)} x {tuple(k.shape)} (D <= "
                         f"{_MAX_D}, T >= 1, B*H <= {_MAX_GRID_X}, at most "
                         f"{_MAX_GRID_Y} query tiles of {_BM} rows)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    if key_bias is not None:
        if (key_bias.dtype != torch.float32 or key_bias.device != q.device
                or tuple(key_bias.shape) != (b, k.shape[2])
                or not key_bias.is_contiguous()):
            raise ValueError(
                "flash_attention_fwd: key_bias must be a contiguous float32 "
                f"[{b}, {k.shape[2]}] tensor on {q.device}; got "
                f"{key_bias.dtype} {tuple(key_bias.shape)} on "
                f"{key_bias.device}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: tensors on {q.device} are "
                         "neither on the CPU nor on a CUDA device")


def flash_attention_fwd(q, k, v, key_bias=None, causal=False, scale=1.0):
    """(out, lse) of attention over [B, H, T, D] heads. Tensors on a CUDA
    device run the hand kernel (or raise); tensors on the CPU run
    ``plain_attention``."""
    global launches
    if q.device.type == "cpu":
        return plain_attention(q, k, v, key_bias, causal, scale)
    _check(q, k, v, key_bias)
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _bind()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_bias.data_ptr() if key_bias is not None else None,
            out.data_ptr(), lse.data_ptr(), b, h, tq, k.shape[2], d,
            float(scale), int(bool(causal)), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_fwd: launch failed with CUDA "
                           f"error {rc} ({msg})")
    launches += 1
    return out, lse


@register_op("flash_attention", infer=same_shape_infer("Out", "Q"))
def flash_attention_op(ctx, ins, attrs):
    """Fused attention op: Q/K/V [B, H, T, D]; optional KeyBias [B, Tk]
    additive mask (0 keep / -1e9 drop)."""
    q, k, v = amp_cast(ctx, ins["Q"][0], ins["K"][0], ins["V"][0])
    kb = opt(ins, "KeyBias")
    if kb is not None:
        kb = kb.float().contiguous()
    out, _ = flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), kb,
        bool(attrs.get("causal", False)), float(attrs.get("scale", 1.0)))
    return {"Out": [out]}
