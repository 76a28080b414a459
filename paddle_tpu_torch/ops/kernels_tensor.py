"""Tensor creation / manipulation ops (counterpart of
``paddle_tpu/ops/kernels_tensor.py``), with the grads of ``cast`` and
``lookup_table`` and the backward's bookkeeping ops ``sum`` and
``fill_zeros_like``. ``gather`` reads rows with ``index_select``, whose
vjp (the generic grad op's) is the scatter-add ``index_add_``, as
``lookup_table_grad`` is. Random ops draw from the run's ``torch.Generator``;
the JAX package's threefry stream gives other numbers from the same seed,
so cross-package tests move parameters over as arrays.

Integer policy: ids and lengths keep the dtype the program declares
(int64 ids stay ``torch.long`` for indexing); nothing is narrowed to
int32 as the JAX package does for the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.desc import OpDesc
from ..core.types import GRAD_SUFFIX, DataType, dtype_to_torch
from ..registry import register_op
from .common import (in_dtype, in_shape, same_shape_infer, set_out_var,
                     top_k_total_order, x)


def _attr_dtype(attrs, key="dtype"):
    return dtype_to_torch(attrs.get(key, DataType.FP32))


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def _shape_attr_infer(op: OpDesc, block):
    for n in op.output("Out"):
        set_out_var(block, n, op.attrs.get("shape"),
                    op.attrs.get("dtype", DataType.FP32))


@register_op("fill_constant", no_grad=True, infer=_shape_attr_infer)
def fill_constant(ctx, ins, attrs):
    return {"Out": [torch.full(tuple(attrs["shape"]), attrs.get("value", 0.0),
                               dtype=_attr_dtype(attrs), device=ctx.device)]}


def _fcbsl_infer(op: OpDesc, block):
    shp = list(op.attrs.get("shape", []))
    for n in op.output("Out"):
        set_out_var(block, n, shp, op.attrs.get("dtype", DataType.FP32))


@register_op("fill_constant_batch_size_like", no_grad=True,
             infer=_fcbsl_infer)
def fill_constant_batch_size_like(ctx, ins, attrs):
    """fill_constant with dim ``output_dim_idx`` of ``shape`` taken from
    dim ``input_dim_idx`` of Input (the batch of a dynamic-batch var)."""
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = ins["Input"][0].shape[
        attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(tuple(shape), attrs.get("value", 0.0),
                               dtype=_attr_dtype(attrs), device=ctx.device)]}


@register_op("fill_zeros_like", no_grad=True, infer=same_shape_infer())
def fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(x(ins))]}


@register_op("uniform_random", no_grad=True, needs_rng=True,
             infer=_shape_attr_infer)
def uniform_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]), dtype=_attr_dtype(attrs),
                      device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator)
    return {"Out": [out]}


@register_op("gaussian_random", no_grad=True, needs_rng=True,
             infer=_shape_attr_infer)
def gaussian_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]), dtype=_attr_dtype(attrs),
                      device=ctx.device)
    out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                generator=ctx.generator)
    return {"Out": [out]}


def _cast_infer(op: OpDesc, block):
    shp = in_shape(block, op, "X")
    for n in op.output("Out"):
        set_out_var(block, n, shp, op.attrs.get("out_dtype", DataType.FP32))


def _cast_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    """The grad casts back to the input's dtype (a ``cast`` op)."""
    xn = op.input("X")[0]
    if xn in no_grad_set:
        return [], {}
    g = OpDesc("cast", {"X": [op.output("Out")[0] + GRAD_SUFFIX]},
               {"Out": [xn + GRAD_SUFFIX]},
               {"out_dtype": op.attrs.get("in_dtype", DataType.FP32)})
    return [g], {xn + GRAD_SUFFIX: xn}


@register_op("cast", infer=_cast_infer, grad_maker=_cast_grad_maker)
def cast(ctx, ins, attrs):
    return {"Out": [x(ins).to(_attr_dtype(attrs, "out_dtype"))]}


def _sum_infer(op: OpDesc, block):
    shp = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    for n in op.output("Out"):
        set_out_var(block, n, shp, dt)


@register_op("sum", infer=_sum_infer)
def sum_op(ctx, ins, attrs):
    """Sum of the X list (the backward adds gradient contributions)."""
    vals = [v for v in ins["X"] if v is not None]
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------

def _resolve_reshape(shape, in_shp):
    """Resolve the 0 (copy the input dim) and -1 (infer) entries of a
    reshape target against ``in_shp``; -1 stays symbolic when the input
    extent is unknown at build time."""
    shape = list(shape)
    in_size = int(np.prod(in_shp)) if in_shp else None
    out = []
    neg = -1
    for i, s in enumerate(shape):
        if s == 0 and in_shp is not None and i < len(in_shp):
            out.append(in_shp[i])
        elif s == -1:
            neg = i
            out.append(-1)
        else:
            out.append(int(s))
    if neg >= 0 and in_size is not None and in_size >= 0:
        known = int(np.prod([s for s in out if s != -1])) or 1
        out[neg] = in_size // known
    elif neg >= 0 and in_shp is not None:
        # a dynamic dim: the -1 is still computable when every unknown
        # input dim is absorbed by a 0-copy ([0, -1, k] batch-preserving
        # reshape)
        unknown_idx = [i for i, d in enumerate(in_shp)
                       if d is None or d < 0]
        copied = [i for i in unknown_idx
                  if i < len(shape) and shape[i] == 0]
        if unknown_idx and copied == unknown_idx:
            known_in = int(np.prod(
                [d for d in in_shp if d is not None and d > 0]) or 1)
            known_out = int(np.prod(
                [s for s in out if s is not None and s > 0]) or 1)
            if known_out > 0 and known_in % known_out == 0:
                out[neg] = known_in // known_out
    return out


def _xshape(xv):
    """The XShape output: a 0-element tensor that carries the input's
    shape in its trailing dims (no storage)."""
    return xv.new_empty((0,) + tuple(xv.shape))


def _reshape_infer(op: OpDesc, block):
    in_shp = in_shape(block, op, "X")
    shp = _resolve_reshape(op.attrs.get("shape", []), in_shp)
    dt = in_dtype(block, op, "X")
    for n in op.output("Out"):
        set_out_var(block, n, shp, dt)
    for n in op.output("XShape"):
        set_out_var(block, n, [0] + (in_shp or []), dt)


@register_op("reshape2", intermediate_outputs=("XShape",),
             infer=_reshape_infer)
def reshape2(ctx, ins, attrs):
    xv = x(ins)
    shp = _resolve_reshape(attrs["shape"], list(xv.shape))
    return {"Out": [xv.reshape(shp)], "XShape": [_xshape(xv)]}


def _transpose_infer(op: OpDesc, block):
    in_shp = in_shape(block, op, "X")
    axis = op.attrs.get("axis", [])
    dt = in_dtype(block, op, "X")
    if in_shp is not None:
        for n in op.output("Out"):
            set_out_var(block, n, [in_shp[a] for a in axis], dt)
        for n in op.output("XShape"):
            set_out_var(block, n, [0] + in_shp, dt)


@register_op("transpose", infer=_transpose_infer)
def transpose(ctx, ins, attrs):
    """The v1 transpose the layout pass writes at an NHWC spine's ends:
    a dense copy, so the spine's tensors lie channels-last in memory
    (a view would hand the next conv its NCHW storage back)."""
    return {"Out": [x(ins).permute(*attrs["axis"]).contiguous()]}


@register_op("transpose2", intermediate_outputs=("XShape",),
             infer=_transpose_infer)
def transpose2(ctx, ins, attrs):
    """A strided view; the consumer that needs dense memory copies."""
    xv = x(ins)
    return {"Out": [xv.permute(*attrs["axis"])], "XShape": [_xshape(xv)]}


def _squeeze_axes(shape, axes):
    if axes:
        axes = [a % len(shape) for a in axes]
        return [s for i, s in enumerate(shape) if i not in axes]
    return [s for s in shape if s != 1]


def _squeeze_infer(op: OpDesc, block):
    in_shp = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if in_shp is None:
        return
    for n in op.output("Out"):
        set_out_var(block, n, _squeeze_axes(in_shp, op.attrs.get("axes", [])),
                    dt)
    for n in op.output("XShape"):
        set_out_var(block, n, [0] + in_shp, dt)


@register_op("squeeze2", intermediate_outputs=("XShape",),
             infer=_squeeze_infer)
def squeeze2(ctx, ins, attrs):
    xv = x(ins)
    shp = _squeeze_axes(list(xv.shape), attrs.get("axes", []))
    return {"Out": [xv.reshape(shp)], "XShape": [_xshape(xv)]}


def _unsqueeze_shape(shape, axes):
    out = list(shape)
    for a in sorted(axes):
        out.insert(a if a >= 0 else a + len(out) + 1, 1)
    return out


def _unsqueeze_infer(op: OpDesc, block):
    in_shp = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if in_shp is not None:
        shp = _unsqueeze_shape(in_shp, op.attrs.get("axes", []))
        for n in op.output("Out"):
            set_out_var(block, n, shp, dt)
        for n in op.output("XShape"):
            set_out_var(block, n, [0] + in_shp, dt)


@register_op("unsqueeze", infer=_unsqueeze_infer)
@register_op("unsqueeze2", intermediate_outputs=("XShape",),
             infer=_unsqueeze_infer)
def unsqueeze(ctx, ins, attrs):
    xv = x(ins)
    shp = _unsqueeze_shape(list(xv.shape), attrs.get("axes", []))
    return {"Out": [xv.reshape(shp)], "XShape": [_xshape(xv)]}


def _concat_infer(op: OpDesc, block):
    shps = [in_shape(block, op, "X", i) for i in range(len(op.input("X")))]
    dt = in_dtype(block, op, "X")
    if shps and all(s is not None for s in shps):
        shp = list(shps[0])
        axis = op.attrs.get("axis", 0) % len(shp)
        parts = [s[axis] for s in shps]
        # an unknown part makes the concatenated extent unknown
        shp[axis] = (sum(parts) if all(p is not None and p >= 0
                                       for p in parts) else -1)
        for n in op.output("Out"):
            set_out_var(block, n, shp, dt)


@register_op("concat", infer=_concat_infer)
def concat(ctx, ins, attrs):
    return {"Out": [torch.cat(list(ins["X"]), dim=attrs.get("axis", 0))]}


def _split_infer(op: OpDesc, block):
    in_shp = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    outs = op.output("Out")
    if in_shp is None:
        return
    axis = op.attrs.get("axis", 0) % len(in_shp)
    sections = op.attrs.get("sections", [])
    num = op.attrs.get("num", 0)
    if sections:
        sizes = sections
    else:
        num = num or len(outs)
        sizes = [in_shp[axis] // num] * num
    for n, s in zip(outs, sizes):
        shp = list(in_shp)
        shp[axis] = s
        set_out_var(block, n, shp, dt)


@register_op("split", infer=_split_infer)
def split(ctx, ins, attrs):
    """``num`` equal parts along ``axis``, or parts of ``sections`` (the
    last one takes the rest, as ``jnp.split`` at the sections' running
    sums does)."""
    xv = x(ins)
    axis = attrs.get("axis", 0) % xv.dim()
    sections = list(attrs.get("sections", []))
    if sections:
        sizes = sections[:-1] + [xv.shape[axis] - sum(sections[:-1])]
    else:
        num = attrs.get("num", 1)
        sizes = [xv.shape[axis] // num] * num
    return {"Out": list(torch.split(xv, sizes, dim=axis))}


def _expand_infer(op: OpDesc, block):
    in_shp = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    times = op.attrs.get("expand_times", [])
    if in_shp is not None:
        shp = [s * t for s, t in zip(in_shp, times)]
        for n in op.output("Out"):
            set_out_var(block, n, shp, dt)


@register_op("expand", infer=_expand_infer)
def expand(ctx, ins, attrs):
    """X tiled ``expand_times`` along each dim (``jnp.tile``)."""
    return {"Out": [torch.tile(x(ins), tuple(attrs["expand_times"]))]}


@register_op("assign", infer=same_shape_infer())
def assign(ctx, ins, attrs):
    return {"Out": [x(ins)]}


def _assign_value_infer(op: OpDesc, block):
    for n in op.output("Out"):
        set_out_var(block, n, op.attrs.get("shape"),
                    op.attrs.get("dtype", DataType.FP32))


@register_op("assign_value", no_grad=True, infer=_assign_value_infer)
def assign_value(ctx, ins, attrs):
    """The literal in the attrs (``values``, flat, and ``shape``) as a
    tensor on the run's device, copied there once per plan
    (``EmitContext.constant``)."""
    dt = dtype_to_torch(attrs.get("dtype", DataType.FP32))
    return {"Out": [ctx.constant(attrs, lambda: torch.tensor(
        attrs["values"], dtype=dt).reshape(tuple(attrs["shape"])).to(
            ctx.device))]}


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def _lookup_infer(op: OpDesc, block):
    ws = in_shape(block, op, "W")
    ids = in_shape(block, op, "Ids")
    dt = in_dtype(block, op, "W")
    if ws is not None and ids is not None:
        shp = list(ids)
        if shp and shp[-1] == 1:
            shp = shp[:-1]
        for n in op.output("Out"):
            set_out_var(block, n, shp + [ws[1]], dt)


def _lookup_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    wn = op.input("W")[0]
    if wn in no_grad_set:
        return [], {}
    g = OpDesc("lookup_table_grad",
               {"Ids": op.input("Ids"), "W": [wn],
                "Out@GRAD": [op.output("Out")[0] + GRAD_SUFFIX]},
               {"W@GRAD": [wn + GRAD_SUFFIX]}, dict(op.attrs))
    return [g], {wn + GRAD_SUFFIX: wn}


@register_op("lookup_table", infer=_lookup_infer,
             grad_maker=_lookup_grad_maker)
def lookup_table(ctx, ins, attrs):
    """Embedding lookup. Ids carry a trailing [,1] dim per the reference
    convention; padding_idx rows read 0."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = w.index_select(0, ids.reshape(-1).long()).reshape(
        tuple(ids.shape) + (w.shape[1],))
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = out.masked_fill((ids == pad).unsqueeze(-1), 0.0)
    return {"Out": [out]}


@register_op("lookup_table_grad", no_grad=True)
def lookup_table_grad(ctx, ins, attrs):
    """Dense scatter-add of the output gradient into W's rows
    (``index_add_``; on the card its atomics sum in no fixed order);
    padding_idx rows get none."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    og = ins["Out@GRAD"][0]
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    flat_ids = ids.reshape(-1).long()
    flat_g = og.reshape(-1, og.shape[-1]).to(w.dtype)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        flat_g = flat_g.masked_fill((flat_ids == pad).unsqueeze(-1), 0.0)
    return {"W@GRAD": [torch.zeros_like(w).index_add_(0, flat_ids, flat_g)]}


# ---------------------------------------------------------------------------
# slicing and gathering
# ---------------------------------------------------------------------------

def _slice_infer(op: OpDesc, block):
    in_shp = in_shape(block, op, "Input")
    if in_shp is None:
        return
    shp = list(in_shp)
    for ax, st, en in zip(op.attrs.get("axes", []),
                          op.attrs.get("starts", []),
                          op.attrs.get("ends", [])):
        n = in_shp[ax]
        st2 = max(st + n, 0) if st < 0 else min(st, n)
        en2 = max(en + n, 0) if en < 0 else min(en, n)
        shp[ax] = max(en2 - st2, 0)
    for nm in op.output("Out"):
        set_out_var(block, nm, shp, in_dtype(block, op, "Input"))


@register_op("slice", infer=_slice_infer)
def slice_op(ctx, ins, attrs):
    """Input[starts:ends] along each of ``axes`` (Python's clamping)."""
    xv = ins["Input"][0]
    idx = [slice(None)] * xv.dim()
    for ax, st, en in zip(attrs.get("axes", []), attrs.get("starts", []),
                          attrs.get("ends", [])):
        idx[ax] = slice(st, en)
    return {"Out": [xv[tuple(idx)]]}


def _gather_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    ids = in_shape(block, op, "Index")
    if xs is not None and ids is not None:
        for n in op.output("Out"):
            set_out_var(block, n, [ids[0]] + xs[1:], in_dtype(block, op, "X"))


@register_op("gather", infer=_gather_infer)
def gather(ctx, ins, attrs):
    """Rows of X at the flattened Index. Its gradient (the generic vjp of
    ``index_select``) scatter-adds the rows back with ``index_add_``,
    which takes a sorted, deterministic path under
    ``torch.use_deterministic_algorithms``."""
    idx = ins["Index"][0].reshape(-1).long()
    return {"Out": [torch.index_select(ins["X"][0], 0, idx)]}


def _topk_infer(op: OpDesc, block):
    shp = in_shape(block, op, "X")
    if shp is not None:
        out = shp[:-1] + [op.attrs.get("k", 1)]
        for n in op.output("Out"):
            set_out_var(block, n, out, in_dtype(block, op, "X"))
        for n in op.output("Indices"):
            set_out_var(block, n, out, DataType.INT64)


@register_op("top_k", no_grad=True, infer=_topk_infer)
def top_k(ctx, ins, attrs):
    """The k largest along the last dim in ``lax.top_k``'s order: IEEE
    total order (+0 above -0, a NaN ranked by its sign), equal values in
    index order (``common.top_k_total_order``; ``torch.topk`` promises
    neither)."""
    vals, idx = top_k_total_order(x(ins), attrs.get("k", 1))
    return {"Out": [vals], "Indices": [idx]}
