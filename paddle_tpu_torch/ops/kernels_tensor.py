"""Tensor creation / manipulation ops (counterpart of
``paddle_tpu/ops/kernels_tensor.py``), with the grads of ``cast`` and
``lookup_table`` and the backward's bookkeeping ops ``sum`` and
``fill_zeros_like``. ``gather`` reads rows with ``index_select``, whose
vjp (the generic grad op's) is the scatter-add ``index_add_``, as
``lookup_table_grad`` is. Random ops draw from the run's ``torch.Generator``;
the JAX package's threefry stream gives other numbers from the same seed,
so cross-package tests move parameters over as arrays.

The order ops (``arg_max``, ``arg_min``, ``argsort``) follow ``jnp``'s
rules exactly on every device: a tie goes to the first index, every NaN
ranks highest (and wins ``arg_min`` too), -0 ties +0. They compare
values or an integer key and take the first index themselves, rather
than rely on a library's tie and NaN rules for floats, which torch does
not promise alike on every device.

Integer policy: ids and lengths keep the dtype the program declares
(int64 ids stay ``torch.long`` for indexing); nothing is narrowed to
int32 as the JAX package does for the TPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.desc import OpDesc
from ..core.types import GRAD_SUFFIX, DataType, dtype_to_torch
from ..registry import register_op
from .common import (batch_size_like_shape, in_dtype, in_shape,
                     same_shape_infer, set_out_var, slots_like_infer,
                     top_k_total_order, total_order_key, x)


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
    return {"Out": [torch.full(batch_size_like_shape(ins, attrs),
                               attrs.get("value", 0.0),
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


# truncated_gaussian_random's bounds, in standard deviations (the JAX op's
# ``jax.random.truncated_normal(key, -2, 2, ...)``), and their normal CDFs
_TRUNC = 2.0
_TRUNC_CDF = (0.5 * (1.0 + math.erf(-_TRUNC / math.sqrt(2.0))),
              0.5 * (1.0 + math.erf(_TRUNC / math.sqrt(2.0))))


@register_op("truncated_gaussian_random", no_grad=True, needs_rng=True,
             infer=_shape_attr_infer)
def truncated_gaussian_random(ctx, ins, attrs):
    """mean + std * a standard normal truncated to [-2, 2], by the
    inverse CDF of a uniform draw between the bounds' CDFs (the JAX op's
    method), drawn from the run's generator."""
    u = torch.empty(tuple(attrs["shape"]), dtype=torch.float32,
                    device=ctx.device)
    u.uniform_(*_TRUNC_CDF, generator=ctx.generator)
    z = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp(-_TRUNC, _TRUNC)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return {"Out": [out.to(_attr_dtype(attrs))]}


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


@register_op("reshape", infer=_reshape_infer)
def reshape(ctx, ins, attrs):
    """The v1 reshape: Out alone (no XShape)."""
    xv = x(ins)
    return {"Out": [xv.reshape(_resolve_reshape(attrs["shape"],
                                                list(xv.shape)))]}


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


@register_op("squeeze", infer=_squeeze_infer)
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


# ---------------------------------------------------------------------------
# stacking, scatter, one-hot
# ---------------------------------------------------------------------------

def _stack_infer(op: OpDesc, block):
    shp = in_shape(block, op, "X")
    if shp is not None:
        axis = op.attrs.get("axis", 0)
        out = list(shp)
        out.insert(axis if axis >= 0 else axis + len(shp) + 1,
                   len(op.input("X")))
        for n in op.output("Y"):
            set_out_var(block, n, out, in_dtype(block, op, "X"))


@register_op("stack", infer=_stack_infer)
def stack(ctx, ins, attrs):
    return {"Y": [torch.stack(list(ins["X"]), dim=attrs.get("axis", 0))]}


def _unstack_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if not xs:
        return
    axis = int(op.attrs.get("axis", 0) or 0) % len(xs)
    rest = [s for i, s in enumerate(xs) if i != axis]
    for n in op.output("Y"):
        set_out_var(block, n, rest, in_dtype(block, op, "X"))


@register_op("unstack", infer=_unstack_infer)
def unstack(ctx, ins, attrs):
    """X split into ``num`` parts along ``axis`` (its extent by default),
    each without that dim."""
    xv = x(ins)
    axis = attrs.get("axis", 0)
    num = attrs.get("num", xv.shape[axis])
    return {"Y": [p.squeeze(axis)
                  for p in torch.tensor_split(xv, num, dim=axis)]}


@register_op("scatter", infer=slots_like_infer(("Out", "X")))
def scatter(ctx, ins, attrs):
    """X with the rows at the flattened Ids replaced by Updates'
    (``overwrite``; a repeated id keeps one of its rows, in no promised
    order, as XLA's scatter) or increased by them (``index_add``: under
    ``torch.use_deterministic_algorithms`` the card sums a repeated id's
    rows by a sorted, deterministic segment sum)."""
    xv = ins["X"][0]
    idx = ins["Ids"][0].reshape(-1).long()
    upd = ins["Updates"][0].to(xv.dtype)
    if attrs.get("overwrite", True):
        return {"Out": [xv.index_copy(0, idx, upd)]}
    return {"Out": [xv.index_add(0, idx, upd)]}


def _one_hot_infer(op: OpDesc, block):
    ids = in_shape(block, op, "X")
    if ids is not None:
        shp = list(ids)
        if shp and shp[-1] == 1:
            shp = shp[:-1]
        for n in op.output("Out"):
            set_out_var(block, n, shp + [op.attrs["depth"]], DataType.FP32)


@register_op("one_hot", no_grad=True, infer=_one_hot_infer)
def one_hot(ctx, ins, attrs):
    """float32 rows, 1 at each id (a trailing [,1] dim dropped). The ids
    are compared with ``arange(depth)``, so an id below 0 or at depth and
    above gives a row of zeros, as ``jax.nn.one_hot`` does
    (``F.one_hot`` raises, a device-side assert on the card)."""
    ids = x(ins)
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    depth = torch.arange(attrs["depth"], device=ids.device, dtype=ids.dtype)
    return {"Out": [(ids.unsqueeze(-1) == depth).to(torch.float32)]}


# ---------------------------------------------------------------------------
# order: arg_max, arg_min, argsort
# ---------------------------------------------------------------------------

def _argmax_infer(op: OpDesc, block):
    shp = in_shape(block, op, "X")
    if shp is not None:
        axis = op.attrs.get("axis", -1) % len(shp)
        for n in op.output("Out"):
            set_out_var(block, n, [s for i, s in enumerate(shp) if i != axis],
                        DataType.INT64)


def _arg_extreme(xv, axis, largest):
    """The first int64 index along ``axis`` of the largest (smallest)
    value, or of the first NaN where the slice holds one (``jnp.argmax``
    and ``jnp.argmin``): the winners compared equal to the extreme, the
    first taken by a min over their (int32) indices, with no tie rule of
    a library reduction."""
    axis = axis % xv.dim()
    ext = (torch.amax if largest else torch.amin)(xv, dim=axis, keepdim=True)
    win = xv == ext
    if xv.is_floating_point():
        nan = torch.isnan(xv)
        win = torch.where(nan.any(dim=axis, keepdim=True), nan, win)
    n = xv.shape[axis]
    shape = [1] * xv.dim()
    shape[axis] = n
    index = torch.arange(n, dtype=torch.int32, device=xv.device).reshape(shape)
    return torch.where(win, index, n).amin(dim=axis).long()


@register_op("arg_max", no_grad=True, infer=_argmax_infer)
def arg_max(ctx, ins, attrs):
    return {"Out": [_arg_extreme(x(ins), attrs.get("axis", -1), True)]}


@register_op("arg_min", no_grad=True, infer=_argmax_infer)
def arg_min(ctx, ins, attrs):
    return {"Out": [_arg_extreme(x(ins), attrs.get("axis", -1), False)]}


def _sort_key(xv):
    """An integer key whose order is ``jnp.sort``'s: -0 and +0 equal,
    every NaN above +inf and NaNs equal (so a stable sort keeps their
    input order); integers are their own key."""
    if not xv.is_floating_point():
        return xv
    key = total_order_key(xv.masked_fill(xv == 0, 0.0))
    return key.masked_fill(torch.isnan(xv), torch.iinfo(key.dtype).max)


def _argsort_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    for n in op.output("Out"):
        set_out_var(block, n, xs, in_dtype(block, op, "X"))
    for n in op.output("Indices"):
        set_out_var(block, n, xs, "int64")


@register_op("argsort", no_grad=True, infer=_argsort_infer)
def argsort(ctx, ins, attrs):
    """X sorted ascending along ``axis`` and the int64 indices that sort
    it: a stable sort of :func:`_sort_key` (``jnp.argsort`` and
    ``jnp.sort``)."""
    xv = x(ins)
    axis = attrs.get("axis", -1)
    _, idx = torch.sort(_sort_key(xv), dim=axis, stable=True)
    return {"Out": [torch.take_along_dim(xv, idx, dim=axis)],
            "Indices": [idx]}


@register_op("cumsum", infer=same_shape_infer())
def cumsum(ctx, ins, attrs):
    """The running sum along ``axis``; ``reverse`` flips, sums and flips
    back; ``exclusive`` is the inclusive sum less X (the JAX op's
    arithmetic, not a shifted scan, so the roundings are its)."""
    axis = attrs.get("axis", -1)
    xv = x(ins)
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(xv, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(xv, dim=axis)
    if attrs.get("exclusive", False):
        out = out - xv
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# shape, range, padding, flatten
# ---------------------------------------------------------------------------

def _shape_infer(op: OpDesc, block):
    shp = in_shape(block, op, "Input")
    if shp is not None:
        for n in op.output("Out"):
            set_out_var(block, n, [len(shp)], DataType.INT32)


@register_op("shape", no_grad=True, infer=_shape_infer)
def shape_op(ctx, ins, attrs):
    """Input's shape as int32, copied to the device once a plan
    (``EmitContext.constant``: a plan's shapes are fixed)."""
    dims = list(ins["Input"][0].shape)
    return {"Out": [ctx.constant(attrs, lambda: torch.tensor(
        dims, dtype=torch.int32).to(ctx.device))]}


@register_op("range", no_grad=True)
def range_op(ctx, ins, attrs):
    """start + step * arange(num): the extent must be the static ``num``
    attr, as in the JAX op (a graph holds fixed shapes too)."""
    start = ins["Start"][0].reshape(())
    step = ins["Step"][0].reshape(())
    if "num" in attrs:
        return {"Out": [start + step * torch.arange(
            attrs["num"], dtype=start.dtype, device=start.device)]}
    raise NotImplementedError(
        "dynamic range requires static 'num' attr under XLA")


def _pad_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    pads = [int(p) for p in op.attrs.get("paddings", [])]
    if not xs or len(pads) != 2 * len(xs):
        return
    out = [(-1 if s is None or s < 0
            else s + pads[2 * i] + pads[2 * i + 1])
           for i, s in enumerate(xs)]
    for n in op.output("Out"):
        set_out_var(block, n, out, in_dtype(block, op, "X"))


def _torch_pads(pairs):
    """[(before, after)] per dim, first dim first -> ``F.pad``'s flat
    list, last dim first."""
    return [p for pair in reversed(pairs) for p in pair]


@register_op("pad", infer=_pad_infer)
def pad(ctx, ins, attrs):
    """X padded by ``paddings`` (before, after for each dim) with
    ``pad_value``."""
    xv = x(ins)
    p = attrs["paddings"]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(xv.dim())]
    return {"Out": [F.pad(xv, _torch_pads(pairs),
                          value=attrs.get("pad_value", 0.0))]}


def _pad2d_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    pads = [int(p) for p in op.attrs.get("paddings", [0, 0, 0, 0])]
    if not xs or len(xs) != 4 or len(pads) != 4:
        return
    h, w = (2, 3) if op.attrs.get("data_format", "NCHW") == "NCHW" else (1, 2)
    out = list(xs)
    if out[h] >= 0:
        out[h] += pads[0] + pads[1]
    if out[w] >= 0:
        out[w] += pads[2] + pads[3]
    for n in op.output("Out"):
        set_out_var(block, n, out, in_dtype(block, op, "X"))


_PAD2D_MODES = {"reflect": "reflect", "edge": "replicate"}


@register_op("pad2d", infer=_pad2d_infer)
def pad2d(ctx, ins, attrs):
    """dims 2 and 3 of X padded by ``paddings`` [top, bottom, left,
    right]: ``pad_value`` (constant), mirrored without the edge
    (reflect) or the edge repeated (edge). The emitter pads dims 2 and 3
    whatever ``data_format`` says, as the JAX op's does."""
    xv = x(ins)
    top, bottom, left, right = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": [F.pad(xv, [left, right, top, bottom],
                              value=attrs.get("pad_value", 0.0))]}
    return {"Out": [F.pad(xv, [left, right, top, bottom],
                          mode=_PAD2D_MODES[mode])]}


def _flatten_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if xs is None:
        return
    ax = op.attrs.get("axis", 1)
    known = all(d is not None and d >= 0 for d in xs)
    lead = int(np.prod(xs[:ax])) if known else -1
    tail = int(np.prod(xs[ax:])) if known else -1
    for n in op.output("Out"):
        set_out_var(block, n, [lead, tail], dt)
    for n in op.output("XShape") or []:
        set_out_var(block, n, [0, *xs], dt)


@register_op("flatten", intermediate_outputs=("XShape",),
             infer=_flatten_infer)
@register_op("flatten2", intermediate_outputs=("XShape",),
             infer=_flatten_infer)
def flatten(ctx, ins, attrs):
    """flatten_op.cc: X as [prod(dims before axis), prod(the rest)], with
    the XShape of the reshape-style grad."""
    xv = x(ins)
    ax = attrs.get("axis", 1)
    lead = int(np.prod(xv.shape[:ax])) if ax > 0 else 1
    return {"Out": [xv.reshape(lead, -1)], "XShape": [_xshape(xv)]}
