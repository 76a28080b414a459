"""Sequence ops (counterpart of ``paddle_tpu/ops/kernels_sequence.py``):
ragged batches are padded [B, T, ...] tensors plus [B] lengths;
``sequence_mask`` turns the lengths into the [B, maxlen] mask, and
``sequence_pool`` and ``sequence_softmax`` mask the padding out of their
reductions."""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..core.types import dtype_to_torch
from ..registry import register_op
from .common import in_dtype, in_shape, opt, same_shape_infer, set_out_var


def _seqmask_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is not None:
        maxlen = int(op.attrs.get("maxlen", -1))
        for n in op.output("Y"):
            set_out_var(block, n, [xs[0], maxlen],
                        op.attrs.get("out_dtype", "int64"))


@register_op("sequence_mask", no_grad=True, infer=_seqmask_infer)
def sequence_mask(ctx, ins, attrs):
    """lengths [B] -> [B, maxlen] 0/1 mask in ``out_dtype``."""
    xv = ins["X"][0].reshape(-1)
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen attr")
    m = torch.arange(maxlen, device=xv.device)[None, :] < xv[:, None]
    return {"Y": [m.to(dtype_to_torch(attrs.get("out_dtype", "int64")))]}


def _mask(xv, length):
    """[B, T] validity mask from Length [B]."""
    t = xv.shape[1]
    return torch.arange(t, device=xv.device)[None, :] < length.reshape(-1, 1)


def _seqpool_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if xs is not None:
        for n in op.output("Out"):
            set_out_var(block, n, [xs[0]] + xs[2:], dt)


@register_op("sequence_pool", intermediate_outputs=("MaxIndex",),
             infer=_seqpool_infer)
def sequence_pool(ctx, ins, attrs):
    """sequence_pool_op.cc over padded [B, T, ...]: SUM, AVERAGE, SQRT,
    MAX, LAST or FIRST over each row's first Length steps (all T without
    Length); AVERAGE and SQRT divide by max(Length, 1)."""
    xv = ins["X"][0]
    length = opt(ins, "Length")
    ptype = attrs.get("pooltype", "SUM").upper()
    b, t = xv.shape[0], xv.shape[1]
    if length is None:
        length = torch.full((b,), t, dtype=torch.int32, device=xv.device)
    tail = (1,) * (xv.dim() - 2)
    mexp = _mask(xv, length).reshape((b, t) + tail)
    n = torch.clamp(length.to(xv.dtype), min=1).reshape((-1,) + tail)
    if ptype in ("SUM", "AVERAGE", "SQRT"):
        out = torch.where(mexp, xv, 0).sum(dim=1)
        if ptype == "AVERAGE":
            out = out / n
        elif ptype == "SQRT":
            out = out / torch.sqrt(n)
    elif ptype == "MAX":
        neg = torch.finfo(xv.dtype).min
        out = torch.where(mexp, xv, neg).amax(dim=1)
    elif ptype == "LAST":
        idx = torch.clamp(length.long() - 1, min=0).reshape((-1, 1) + tail)
        out = torch.take_along_dim(xv, idx, dim=1).squeeze(1)
    elif ptype == "FIRST":
        out = xv[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": [out],
            "MaxIndex": [torch.zeros((b,), dtype=torch.int32,
                                     device=xv.device)]}


@register_op("sequence_softmax", infer=same_shape_infer())
def sequence_softmax(ctx, ins, attrs):
    """Softmax over dim 1 within each row's Length; zeros past it."""
    xv = ins["X"][0]
    length = opt(ins, "Length")
    if length is None:
        return {"Out": [torch.softmax(xv, dim=1)]}
    m = _mask(xv, length)
    out = torch.softmax(torch.where(m, xv, torch.finfo(xv.dtype).min), dim=1)
    return {"Out": [torch.where(m, out, 0)]}
