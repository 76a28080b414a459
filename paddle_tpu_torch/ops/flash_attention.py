"""Flash attention: the hand-written CUDA kernels, their plain versions,
the ``flash_attention`` op and its grad.

Counterpart of ``paddle_tpu/ops/pallas_attention.py``. The forward kernel
is ``csrc/flash_attention_fwd.cu`` (blocked online softmax with both
products as TF32 ``mma.sync`` on the tensor cores, 3 split products for
fp32 inputs, fp32 accumulation, O and the logsumexp out).
``flash_attention_fwd`` launches it for tensors on the card and raises
on anything it does not take; for tensors on the CPU it computes
``plain_attention``, the torch transcription of ``_plain_attention``.
``emulated_attention`` repeats the kernel's TF32 arithmetic on the CPU
for the tests.

The backward is ``csrc/flash_attention_bwd.cu`` (the counterpart of
``_fa_bwd``: P recomputed from the saved logsumexp, a dK/dV pass and a
dQ pass, no atomics), launched by ``flash_attention_bwd`` on the card;
on the CPU it computes ``plain_attention_bwd``. Its products run on the
tensor cores with fp32 accumulation: 3xTF32 ``mma.sync`` for fp32
inputs, bf16 ``mma.sync`` for bf16 inputs with P and dSoft rounded to
bf16 once; ``emulated_attention_bwd`` repeats that arithmetic on the CPU
for the tests. The
``flash_attention_grad`` op recomputes O and the logsumexp with the
forward kernel and then runs the backward, as the JAX package's generic
vjp recomputes the forward. ``flash_attention`` wraps the pair as a
``torch.autograd.Function``. There is no fallback from the card to a
plain version, and no key-length gate.

Causal masking is bottom-right aligned (key c visible to query r when
c <= r + Tk - Tq) in both versions, as ``_plain_attention`` computes it.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..core.types import GRAD_SUFFIX
from ..registry import register_op
from . import _build
from .common import amp_cast, opt, same_shape_infer

# kernel launches by flash_attention_fwd since the count was last reset,
# and the same launches by the dtype of their inputs ("float32",
# "bfloat16")
launches = 0
launch_dtypes: Dict[str, int] = {}
# kernel launches by flash_attention_bwd since the count was last reset;
# each call launches BWD_KERNELS kernels (delta, dK/dV, dQ)
bwd_launches = 0
BWD_KERNELS = 3
# A call under CUDA graph capture counts the launch it records in the
# graph; the graph's replays launch the kernels again without calling the
# wrappers, so they move no count here (a profiler trace counts them).

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


def tf32_trunc(x):
    """fp32 -> TF32 by dropping the low 13 mantissa bits, as the tensor
    core reads an fp32 operand of a TF32 ``mma.sync``."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def _tf32_product(eq, a, b, products, small=tf32_round):
    """einsum of a and b as a kernel's TF32 ``mma.sync`` computes it:
    1 product of the rounded operands, or 3 (big*big + big*small +
    small*big with big = tf32(x) and small = ``small(x - big)``: rounded
    in the forward kernel, truncated in the backward's)."""
    ab, bb = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, ab, bb)
    if products == 3:
        out = (out + torch.einsum(eq, ab, small(b - bb))
               + torch.einsum(eq, small(a - ab), bb))
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


def emulated_attention_bwd(q, k, v, key_bias, out, lse, do, causal=False,
                           scale=1.0, products=None):
    """The backward kernels' arithmetic on CPU tensors, for the tests.
    fp32 inputs: every product as ``products`` TF32 products (3 by
    default: 3xTF32 with the small terms truncated) with fp32 sums. bf16
    inputs: bf16 operands, whose products are exact, with fp32 sums, and
    P and dSoft rounded to bf16 once before dV = P^T dO, dK = dSoft^T Q
    and dQ = dSoft K (``products`` does not apply). Same outputs as
    ``plain_attention_bwd``."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    if q.dtype == torch.bfloat16:
        def mm(eq, a, b):
            return torch.einsum(eq, a, b)

        def low(x):
            return x.to(torch.bfloat16).float()
    else:
        n = 3 if products is None else products

        def mm(eq, a, b):
            return _tf32_product(eq, a, b, n, small=tf32_trunc)

        def low(x):
            return x
    s = _mask(mm("bhqd,bhkd->bhqk", qf, kf) * scale, key_bias, causal)
    p = torch.exp(s - lse[..., None])
    delta = (dof * out.float()).sum(dim=-1)
    dv = mm("bhqk,bhqd->bhkd", low(p), dof)
    dsoft = p * (mm("bhqd,bhkd->bhqk", dof, vf) - delta[..., None])
    dq = mm("bhqk,bhkd->bhqd", low(dsoft), kf) * scale
    dk = mm("bhqk,bhqd->bhkd", low(dsoft), qf) * scale
    dkb = dsoft.sum(dim=(1, 2)) if key_bias is not None else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dkb


def _bind(name):
    """The kernel library ``name`` with its C entry point typed: pointers
    first (``n_ptrs``), then the ints B, H, tq, tk, D, the float scale,
    the ints causal and is_bf16, and the stream."""
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptrs = 6 if name == "flash_attention_fwd" else 12
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = getattr(lib, _ERROR_STRING[name])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


_ERROR_STRING = {"flash_attention_fwd": "flash_attention_error_string",
                 "flash_attention_bwd": "flash_attention_bwd_error_string"}


def _check(q, k, v, key_bias, who="flash_attention_fwd"):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{who}: dtype {q.dtype} (float32 or bfloat16 only)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{who}: {name} is {t.dtype} on {t.device}, q "
                             f"is {q.dtype} on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{who}: q, k, v must be [B, H, T, D] with k and v "
                         f"alike; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, tq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"{who}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B, H or D")
    if (not 1 <= d <= _MAX_D or tq < 1 or k.shape[2] < 1
            or b * h > _MAX_GRID_X or -(-tq // _BM) > _MAX_GRID_Y):
        raise ValueError(f"{who}: unsupported shape {tuple(q.shape)} x "
                         f"{tuple(k.shape)} (D <= {_MAX_D}, T >= 1, B*H <= "
                         f"{_MAX_GRID_X}, at most {_MAX_GRID_Y} query tiles "
                         f"of {_BM} rows)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{who}: q, k, v must be contiguous")
    if key_bias is not None:
        if (key_bias.dtype != torch.float32 or key_bias.device != q.device
                or tuple(key_bias.shape) != (b, k.shape[2])
                or not key_bias.is_contiguous()):
            raise ValueError(
                f"{who}: key_bias must be a contiguous float32 "
                f"[{b}, {k.shape[2]}] tensor on {q.device}; got "
                f"{key_bias.dtype} {tuple(key_bias.shape)} on "
                f"{key_bias.device}")
    if q.device.type != "cuda":
        raise ValueError(f"{who}: tensors on {q.device} are neither on the "
                         "CPU nor on a CUDA device")


def _raise_on(rc, lib, name):
    if rc != 0:
        msg = getattr(lib, _ERROR_STRING[name])(rc).decode()
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc} "
                           f"({msg})")


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
    lib = _bind("flash_attention_fwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_bias.data_ptr() if key_bias is not None else None,
            out.data_ptr(), lse.data_ptr(), b, h, tq, k.shape[2], d,
            float(scale), int(bool(causal)), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "flash_attention_fwd")
    launches += 1
    dtype = str(q.dtype).replace("torch.", "")
    launch_dtypes[dtype] = launch_dtypes.get(dtype, 0) + 1
    return out, lse


def plain_attention_bwd(q, k, v, key_bias, out, lse, do, causal=False,
                        scale=1.0):
    """(dq, dk, dv, dkey_bias) of ``plain_attention``: ``_fa_bwd``'s
    formulas over the whole [Tq, Tk] in fp32, P recomputed from ``lse``.
    dq, dk, dv come back in the inputs' dtypes, dkey_bias [B, Tk] in fp32
    (None without a key bias)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.float()
    s = _mask(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale, key_bias,
              causal)
    p = torch.exp(s - lse[..., None])
    delta = (dof * out.float()).sum(dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    dsoft = p * (dp - delta[..., None])
    ds = dsoft * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dkb = dsoft.sum(dim=(1, 2)) if key_bias is not None else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dkb


def flash_attention_bwd(q, k, v, key_bias, out, lse, do, causal=False,
                        scale=1.0):
    """(dq, dk, dv, dkey_bias) of attention from the forward's ``out`` and
    ``lse`` and the output gradient ``do``. Tensors on a CUDA device run
    the hand kernels (or raise); tensors on the CPU run
    ``plain_attention_bwd``."""
    global bwd_launches
    if q.device.type == "cpu":
        return plain_attention_bwd(q, k, v, key_bias, out, lse, do, causal,
                                   scale)
    who = "flash_attention_bwd"
    _check(q, k, v, key_bias, who)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if -(-tk // _BM) > _MAX_GRID_Y:  # the dK/dV pass has a block per key tile
        raise ValueError(f"{who}: at most {_MAX_GRID_Y} key tiles of {_BM} "
                         f"rows; got Tk = {tk}")
    for name, t in (("out", out), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{who}: {name} must be a contiguous "
                             f"{q.dtype} {tuple(q.shape)} tensor on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, tq)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{who}: lse must be a contiguous float32 "
                         f"[{b}, {h}, {tq}] tensor on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    dkb_part = (torch.empty((b, h, tk), dtype=torch.float32, device=q.device)
                if key_bias is not None else None)
    lib = _bind(who)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_bias.data_ptr() if key_bias is not None else None,
            out.data_ptr(), lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dkb_part.data_ptr() if dkb_part is not None else None,
            b, h, tq, tk, d, float(scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, who)
    bwd_launches += BWD_KERNELS
    return dq, dk, dv, (dkb_part.sum(dim=1) if dkb_part is not None
                        else None)


class FlashAttention(torch.autograd.Function):
    """The forward and backward kernels as one differentiable function
    (``torch.func`` transforms it too). The logsumexp output carries no
    gradient."""

    @staticmethod
    def forward(q, k, v, key_bias, causal, scale):
        return flash_attention_fwd(q, k, v, key_bias, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_bias, causal, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dkb = flash_attention_bwd(
            q, k, v, key_bias, out, lse, dout.contiguous(), ctx.causal,
            ctx.scale)
        return dq, dk, dv, dkb, None, None


def flash_attention(q, k, v, key_bias=None, causal=False, scale=1.0):
    """Differentiable attention over contiguous [B, H, T, D] heads (the
    JAX package's ``flash_attention``); key_bias [B, Tk] additive."""
    return FlashAttention.apply(q, k, v, key_bias, causal, scale)[0]


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


@register_op("flash_attention_grad", no_grad=True)
def flash_attention_grad(ctx, ins, attrs):
    """The grad op the default maker writes for ``flash_attention``. Its
    inputs are Q, K, V, KeyBias and Out@GRAD, so O and the logsumexp are
    recomputed with the forward kernel before the backward kernels run.
    Under AMP the gradients go back to the dtypes of the op's inputs, as
    the JAX package's vjp through ``amp_cast`` returns them."""
    q0, k0, v0 = ins["Q"][0], ins["K"][0], ins["V"][0]
    q, k, v = (t.contiguous() for t in amp_cast(ctx, q0, k0, v0))
    kb0 = opt(ins, "KeyBias")
    kb = kb0.float().contiguous() if kb0 is not None else None
    causal = bool(attrs.get("causal", False))
    scale = float(attrs.get("scale", 1.0))
    out, lse = flash_attention_fwd(q, k, v, kb, causal, scale)
    do = ins["Out" + GRAD_SUFFIX][0].to(out.dtype).contiguous()
    dq, dk, dv, dkb = flash_attention_bwd(q, k, v, kb, out, lse, do, causal,
                                          scale)
    grads = {"Q@GRAD": [dq.to(q0.dtype)], "K@GRAD": [dk.to(k0.dtype)],
             "V@GRAD": [dv.to(v0.dtype)]}
    if kb0 is not None:
        grads["KeyBias@GRAD"] = [dkb.to(kb0.dtype)]
    return grads
