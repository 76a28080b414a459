"""Sequence ops (counterpart of ``paddle_tpu/ops/kernels_sequence.py``):
ragged batches are padded [B, T, ...] tensors plus [B] lengths (Fluid's
LoD mapped onto dense tensors). ``sequence_mask`` turns the lengths into
the [B, maxlen] mask, ``sequence_pool`` and ``sequence_softmax`` mask the
padding out of their reductions, and the rest of the family (expand,
reverse, concat, slice, conv, row_conv, pad, unpad, expand_as, reshape,
scatter, enumerate, erase, add_position_encoding, im2sequence, lod_reset,
lod_rank_table, reorder_lod_tensor_by_rank) keeps the JAX package's
arithmetic on the same convention.

Nothing here reads a length on the host: masks are tensor compares, and
compaction (``sequence_erase``) is a stable sort of a 0/1 key, so every op
can sit inside a captured CUDA graph. ``sequence_scatter`` adds its
updates through a one-hot product rather than a scatter-add, so its
forward is deterministic on the card. Integer outputs are int64 (the
port's policy; the JAX package narrows them to int32)."""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..core.types import dtype_to_torch
from ..registry import register_op
from .common import (in_dtype, in_shape, length_or_full, opt,
                     same_shape_infer, set_out_var)


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


def _rows(mask, v):
    """``mask`` [B, T] reshaped to broadcast over ``v`` [B, T, ...]."""
    return mask.reshape(mask.shape + (1,) * (v.dim() - 2))


def _over_time(xv, t):
    """X [B, ...] repeated over a time axis of t: [B, t, ...]."""
    return xv.unsqueeze(1).expand((xv.shape[0], t)
                                  + tuple(xv.shape[1:])).contiguous()


@register_op("sequence_expand")
def sequence_expand(ctx, ins, attrs):
    """X [B, ...] repeated over Y's time axis: [B, T_y, ...]."""
    return {"Out": [_over_time(ins["X"][0], ins["Y"][0].shape[1])]}


@register_op("sequence_reverse", infer=same_shape_infer())
def sequence_reverse(ctx, ins, attrs):
    """Reverse each row's first Length steps (the whole row without
    Length); the padding stays in place."""
    xv = ins["X"][0]
    length = opt(ins, "Length")
    if length is None:
        return {"Out": [torch.flip(xv, dims=[1])]}
    t = xv.shape[1]
    length = length.reshape(-1, 1).long()
    idx = torch.arange(t, device=xv.device)[None, :]
    src = torch.where(idx < length, length - 1 - idx, idx)
    return {"Out": [torch.take_along_dim(
        xv, src.reshape(src.shape + (1,) * (xv.dim() - 2)), dim=1)]}


@register_op("sequence_concat")
def sequence_concat(ctx, ins, attrs):
    """The inputs concatenated along the time axis."""
    return {"Out": [torch.cat(list(ins["X"]), dim=1)]}


@register_op("sequence_slice")
def sequence_slice(ctx, ins, attrs):
    """Steps [offset, offset + length) of every row (static attrs)."""
    xv = ins["X"][0]
    off = int(attrs.get("offset", 0))
    n = int(attrs.get("length", xv.shape[1]))
    return {"Out": [xv[:, off:off + n]]}


def _seqconv_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    fs = in_shape(block, op, "Filter")
    dt = in_dtype(block, op, "X")
    if xs is not None and fs is not None:
        for n in op.output("Out"):
            set_out_var(block, n, xs[:2] + [fs[1]], dt)


def sequence_conv_fn(xv, filt, length, clen=None, cstart=None):
    """sequence_conv_op over padded [B, T, D]: the contextLength window
    starting contextStart steps from each step (zeros outside the row's
    valid steps), concatenated to [B, T, clen * D] and projected by Filter
    [clen * D, F]; zeros past each row's length."""
    b, t, d = xv.shape
    clen = int(clen if clen is not None else filt.shape[0] // d)
    cstart = int(cstart if cstart is not None else -(clen // 2))
    valid = _mask(xv, length)
    xm = torch.where(valid[..., None], xv, 0)
    steps = torch.arange(t, device=xv.device)
    cols = []
    for k in range(clen):
        off = cstart + k
        src = steps + off
        inside = (src >= 0)[None, :] & (src[None, :] < length[:, None])
        cols.append(torch.roll(xm, -off, dims=1) * inside[..., None].to(
            xv.dtype))
    ctxmat = torch.cat(cols, dim=-1)
    out = torch.matmul(ctxmat, filt)
    return torch.where(valid[..., None], out, 0)


@register_op("sequence_conv", infer=_seqconv_infer)
def sequence_conv(ctx, ins, attrs):
    """The context-window projection (``sequence_conv_fn``)."""
    xv = ins["X"][0]
    length = length_or_full(ins, xv.shape[0], xv.shape[1], xv.device)
    return {"Out": [sequence_conv_fn(xv, ins["Filter"][0], length,
                                     attrs.get("contextLength"),
                                     attrs.get("contextStart"))]}


@register_op("row_conv", infer=same_shape_infer())
def row_conv(ctx, ins, attrs):
    """row_conv_op (the lookahead convolution of DeepSpeech2): X [B, T, D],
    Filter [future + 1, D]; out[b, t] = sum_i x[b, t + i] * w[i], the
    window stopping at the row's length."""
    xv = ins["X"][0]
    w = ins["Filter"][0]
    b, t = xv.shape[0], xv.shape[1]
    length = length_or_full(ins, b, t, xv.device)
    steps = torch.arange(t, device=xv.device)
    out = torch.zeros_like(xv)
    for i in range(w.shape[0]):
        in_row = (steps[None, :] + i) < length[:, None]
        out = out + torch.where(in_row[..., None],
                                torch.roll(xv, -i, dims=1), 0) * w[i]
    return {"Out": [out]}


def _seqpad_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if xs is not None:
        maxlen = int(op.attrs.get("maxlen", -1))
        out_shape = list(xs)
        if maxlen > 0 and len(out_shape) > 1:
            out_shape[1] = maxlen
        for n in op.output("Out"):
            set_out_var(block, n, out_shape, dt)
        for n in op.output("Length"):
            set_out_var(block, n, [xs[0]], "int64")


@register_op("sequence_pad", intermediate_outputs=("Length",),
             infer=_seqpad_infer)
def sequence_pad(ctx, ins, attrs):
    """PadValue written past each row's length, the time axis padded or
    cut to ``maxlen`` when it is set; emits the lengths (cut to the new
    time axis)."""
    xv = ins["X"][0]
    length = length_or_full(ins, xv.shape[0], xv.shape[1], xv.device)
    maxlen = int(attrs.get("maxlen", -1))
    if 0 < maxlen != xv.shape[1]:
        if maxlen > xv.shape[1]:
            pad = [0, 0] * (xv.dim() - 2) + [0, maxlen - xv.shape[1]]
            xv = torch.nn.functional.pad(xv, pad)
        else:
            xv = xv[:, :maxlen]
    t = xv.shape[1]
    length = torch.clamp(length, max=t)
    pv = opt(ins, "PadValue")
    pv = 0.0 if pv is None else pv.to(xv.dtype)
    out = torch.where(_rows(_mask(xv, length), xv), xv, pv)
    return {"Out": [out], "Length": [length.long()]}


@register_op("sequence_unpad", infer=same_shape_infer())
def sequence_unpad(ctx, ins, attrs):
    """The ragged result held densely: each row's valid prefix, zeros
    after it."""
    xv = ins["X"][0]
    length = length_or_full(ins, xv.shape[0], xv.shape[1], xv.device)
    return {"Out": [torch.where(_rows(_mask(xv, length), xv), xv, 0)]}


@register_op("sequence_expand_as", infer=same_shape_infer(in_slot="Y"))
def sequence_expand_as(ctx, ins, attrs):
    """Each batch row of X broadcast across Y's time axis (an X of time
    extent 1 drops that axis first)."""
    xv = ins["X"][0]
    if xv.dim() >= 2 and xv.shape[1] == 1:
        xv = xv[:, 0]
    return {"Out": [_over_time(xv, ins["Y"][0].shape[1])]}


def _seq_reshape_infer(op, block):
    xs = in_shape(block, op, "X")
    nd = int(op.attrs.get("new_dim", 0) or 0)
    if xs and len(xs) >= 2 and nd > 0:
        t, d = xs[-2], xs[-1]
        if t > 0 and d > 0 and (t * d) % nd == 0:
            set_out_var(block, op.output("Out")[0],
                        xs[:-2] + [t * d // nd, nd],
                        in_dtype(block, op, "X"))


@register_op("sequence_reshape", infer=_seq_reshape_infer)
def sequence_reshape(ctx, ins, attrs):
    """[B, T, D] -> [B, T * D / new_dim, new_dim]."""
    xv = ins["X"][0]
    new_dim = int(attrs["new_dim"])
    b, t, d = xv.shape
    return {"Out": [xv.reshape(b, t * d // new_dim, new_dim)]}


@register_op("sequence_scatter", infer=same_shape_infer())
def sequence_scatter(ctx, ins, attrs):
    """Updates [B, K, ...] added into X [B, T, ...] at the time indices
    Ids [B, K] of each row, as a product with the one-hot of Ids (an
    index outside [0, T) adds nothing, as the JAX scatter drops it)."""
    xv = ins["X"][0]
    ids = ins["Ids"][0]
    upd = ins["Updates"][0]
    if ids.dim() > 2:
        ids = ids.reshape(ids.shape[0], -1)
    t = xv.shape[1]
    hot = (ids.long()[..., None] == torch.arange(t, device=xv.device)
           ).to(upd.dtype)                                    # [B, K, T]
    flat = upd.reshape(upd.shape[0], upd.shape[1], -1)        # [B, K, R]
    add = torch.bmm(hot.transpose(1, 2), flat).reshape(xv.shape)
    return {"Out": [xv + add]}


def _seq_enumerate_infer(op, block):
    xs = in_shape(block, op, "X")
    win = int(op.attrs.get("win_size", 1) or 1)
    if xs:
        base = xs[:-1] if len(xs) >= 2 and xs[-1] == 1 else list(xs)
        set_out_var(block, op.output("Out")[0], base + [win],
                    in_dtype(block, op, "X"))


@register_op("sequence_enumerate", no_grad=True, infer=_seq_enumerate_infer)
def sequence_enumerate(ctx, ins, attrs):
    """ids [B, T] -> [B, T, win_size] sliding windows, pad_value past each
    row's length."""
    xv = ins["X"][0]
    win = int(attrs["win_size"])
    pad = int(attrs.get("pad_value", 0))
    b, t = xv.shape[0], xv.shape[1]
    length = length_or_full(ins, b, t, xv.device)
    idx = (torch.arange(t, device=xv.device)[:, None]
           + torch.arange(win, device=xv.device)[None, :])   # [T, win]
    valid = idx[None] < length[:, None, None]
    gathered = xv[:, torch.clamp(idx, 0, t - 1)]
    return {"Out": [torch.where(valid, gathered, pad)]}


@register_op("sequence_erase", no_grad=True)
def sequence_erase(ctx, ins, attrs):
    """The listed tokens dropped and each row compacted to the left in
    order (a stable sort of the 0/1 erase key), zeros after; NewLength the
    kept counts."""
    xv = ins["X"][0]
    b, t = xv.shape[0], xv.shape[1]
    length = length_or_full(ins, b, t, xv.device)
    erase = ~_mask(xv, length)
    for tok in attrs.get("tokens", []) or []:
        erase = erase | (xv == tok)
    order = torch.sort(erase.to(torch.uint8), dim=1, stable=True)[1]
    compacted = torch.take_along_dim(xv, order, dim=1)
    new_len = (~erase).sum(dim=1)
    keep = _mask(xv, new_len)
    return {"Out": [torch.where(keep, compacted, 0)],
            "NewLength": [new_len.long()]}


@register_op("add_position_encoding", infer=same_shape_infer())
def add_position_encoding(ctx, ins, attrs):
    """alpha * x + beta * sin(j / 10000^(k / (half - 1))) on the first half
    of the channels and the cosine on the second (add_position_encoding_op.h)."""
    xv = ins["X"][0]
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    b, t, d = xv.shape
    half = d // 2
    pos = torch.arange(t, device=xv.device, dtype=xv.dtype)[:, None]
    expo = (torch.arange(half, device=xv.device, dtype=xv.dtype)
            / (half - 1 if half > 1 else 1))
    ang = pos / torch.pow(torch.full((), 10000.0, dtype=xv.dtype,
                                     device=xv.device), expo)[None, :]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return {"Out": [alpha * xv + beta * enc[None]]}


def _im2sequence_infer(op, block):
    xs = in_shape(block, op, "X")
    if not xs or len(xs) != 4 or any(s is None or s < 0 for s in xs[1:]):
        return
    kh, kw = [int(k) for k in op.attrs.get("kernels", [1, 1])][:2]
    sh, sw = [int(s) for s in (op.attrs.get("strides") or [1, 1])][:2]
    pads = [int(p) for p in (op.attrs.get("paddings") or [0, 0, 0, 0])]
    if len(pads) == 2:
        pads = pads * 2
    n, c, h, w = xs
    oh = (h + pads[0] + pads[2] - kh) // sh + 1
    ow = (w + pads[1] + pads[3] - kw) // sw + 1
    set_out_var(block, op.output("Out")[0],
                [(n * oh * ow) if n > 0 else -1, c * kh * kw],
                in_dtype(block, op, "X"))


@register_op("im2sequence", infer=_im2sequence_infer)
def im2sequence(ctx, ins, attrs):
    """[B, C, H, W] -> [B, oh * ow, C * kh * kw] patch rows, features in
    (C, kh, kw) order. ``paddings`` are [up, left, down, right] and may be
    uneven, which ``F.unfold`` cannot take: the image is padded first."""
    xv = ins["X"][0]
    kh, kw = [int(k) for k in attrs["kernels"]]
    sh, sw = [int(s) for s in attrs.get("strides", [1, 1])]
    pads = [int(p) for p in attrs.get("paddings", [0, 0, 0, 0])]
    if len(pads) == 2:
        pads = pads * 2
    if any(pads):
        xv = torch.nn.functional.pad(xv, (pads[1], pads[3], pads[0], pads[2]))
    cols = torch.nn.functional.unfold(xv, (kh, kw), stride=(sh, sw))
    return {"Out": [cols.transpose(1, 2).contiguous()]}


@register_op("lod_reset", infer=same_shape_infer())
def lod_reset(ctx, ins, attrs):
    """The data passes through; the new partition comes out as lengths:
    the differences of an integer Y's offsets or of ``target_lod``, else
    every row full."""
    xv = ins["X"][0]
    y = opt(ins, "Y")
    if y is not None and not y.is_floating_point():
        lod = y.reshape(-1).long()
        length = lod[1:] - lod[:-1]
    elif attrs.get("target_lod"):
        lod = [int(v) for v in attrs["target_lod"]]
        diffs = [e - s for s, e in zip(lod, lod[1:])]
        length = ctx.constant(attrs, lambda: torch.tensor(
            diffs, dtype=torch.long, device=xv.device))
    else:
        b = xv.shape[0] if xv.dim() >= 1 else 1
        t = xv.shape[1] if xv.dim() >= 2 else 1
        length = torch.full((b,), t, dtype=torch.long, device=xv.device)
    return {"Out": [xv], "Length": [length]}


@register_op("lod_rank_table", no_grad=True)
def lod_rank_table(ctx, ins, attrs):
    """Rows ranked by descending length, ties in their original order (a
    stable sort); outputs the order and the sorted lengths."""
    length = ins["X"][0].reshape(-1).long()
    _, order = torch.sort(-length, stable=True)
    return {"Out": [order], "Length": [length[order]]}


@register_op("reorder_lod_tensor_by_rank", infer=same_shape_infer())
def reorder_lod_tensor_by_rank(ctx, ins, attrs):
    """Batch rows permuted into a lod_rank_table's order."""
    order = ins["RankTable"][0].reshape(-1).long()
    return {"Out": [torch.index_select(ins["X"][0], 0, order)]}
