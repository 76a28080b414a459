"""Math ops (counterpart of ``paddle_tpu/ops/kernels_math.py``): the
elementwise family with Fluid's axis broadcast, ``reduce_sum``, the fc
product ``mul``, ``matmul``, ``softmax``, ``scale``, ``relu``, ``pow`` and
``mean``. Large products go to
``torch.matmul``, as the JAX package left them to XLA.

Under AMP a bf16 activation meeting an fp32 operand (a bias, the residual
stream) promotes to fp32, as the JAX package computes it: its
``amp_harmonize`` compares dtypes against the ``jnp.bfloat16`` scalar type
in a set, which never matches, so it leaves both operands as they are."""

from __future__ import annotations

import numpy as np
import torch

from ..core.desc import OpDesc
from ..registry import register_op
from .common import (ZERO, amp_cast, fluid_broadcast, in_dtype, in_shape,
                     normalize_reduce_dims, same_shape_infer, set_out_var, x)


def _make_elementwise(name, fn):
    def emit(ctx, ins, attrs):
        xv, yv = fluid_broadcast(ins["X"][0], ins["Y"][0],
                                 attrs.get("axis", -1))
        return {"Out": [fn(xv, yv)]}

    emit.__name__ = name
    register_op(name, infer=same_shape_infer())(emit)


_make_elementwise("elementwise_add", torch.add)
_make_elementwise("elementwise_mul", torch.mul)
_make_elementwise("elementwise_div", torch.div)
_make_elementwise("elementwise_min", torch.minimum)


def _reduce_infer(op: OpDesc, block):
    shp = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if shp is None:
        return
    dims = normalize_reduce_dims(len(shp), op.attrs.get("dim"),
                                 op.attrs.get("reduce_all", False))
    if op.attrs.get("keep_dim", False):
        out = [1 if i in dims else s for i, s in enumerate(shp)]
    else:
        out = [s for i, s in enumerate(shp) if i not in dims] or [1]
    for n in op.output("Out"):
        set_out_var(block, n, out, dt)


@register_op("reduce_sum", infer=_reduce_infer)
def reduce_sum(ctx, ins, attrs):
    xv = x(ins)
    dims = normalize_reduce_dims(xv.dim(), attrs.get("dim"),
                                 attrs.get("reduce_all", False))
    out = xv.sum(dim=dims, keepdim=attrs.get("keep_dim", False))
    if out.dim() == 0:
        out = out.reshape(1)  # Fluid convention: a full reduce is [1]
    return {"Out": [out]}


def _mul_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    ys = in_shape(block, op, "Y")
    dt = in_dtype(block, op, "X")
    if xs is None or ys is None:
        return
    xn = op.attrs.get("x_num_col_dims", 1)
    yn = op.attrs.get("y_num_col_dims", 1)
    for n in op.output("Out"):
        set_out_var(block, n, xs[:xn] + ys[yn:], dt)


@register_op("mul", infer=_mul_infer)
def mul(ctx, ins, attrs):
    """The fc product: flatten X at x_num_col_dims and Y at
    y_num_col_dims, one 2-D GEMM, reshape back."""
    xv, yv = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    x2 = xv.reshape(int(np.prod(xv.shape[:xn])), -1)
    y2 = yv.reshape(int(np.prod(yv.shape[:yn])), -1)
    x2, y2 = amp_cast(ctx, x2, y2)
    out = torch.matmul(x2, y2)
    return {"Out": [out.reshape(tuple(xv.shape[:xn]) + tuple(yv.shape[yn:]))]}


def _matmul_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    ys = in_shape(block, op, "Y")
    dt = in_dtype(block, op, "X")
    if xs is None or ys is None:
        return
    tx, ty = op.attrs.get("transpose_X", False), op.attrs.get(
        "transpose_Y", False)
    xs2, ys2 = list(xs), list(ys)
    if len(xs2) == 1:
        xs2 = [1, xs2[0]]
    if len(ys2) == 1:
        ys2 = [ys2[0], 1]
    if tx:
        xs2[-1], xs2[-2] = xs2[-2], xs2[-1]
    if ty:
        ys2[-1], ys2[-2] = ys2[-2], ys2[-1]
    batch = xs2[:-2] if len(xs2) >= len(ys2) else ys2[:-2]
    out = list(batch) + [xs2[-2], ys2[-1]]
    if len(xs) == 1 and len(ys) == 1:
        out = [1]
    for n in op.output("Out"):
        set_out_var(block, n, out, dt)


@register_op("matmul", infer=_matmul_infer)
def matmul(ctx, ins, attrs):
    """Batched product with optional transposes of the last two dims,
    then ``alpha``; bf16 under AMP, as ``mul``."""
    xv, yv = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False):
        xv = xv.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        yv = yv.transpose(-1, -2)
    xv, yv = amp_cast(ctx, xv, yv)
    out = torch.matmul(xv, yv)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("softmax", infer=same_shape_infer())
def softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(x(ins), dim=attrs.get("axis", -1))]}


@register_op("scale", infer=same_shape_infer())
def scale(ctx, ins, attrs):
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    xv = x(ins)
    if attrs.get("bias_after_scale", True):
        return {"Out": [xv * s + b]}
    return {"Out": [(xv + b) * s]}


@register_op("relu", infer=same_shape_infer())
def relu(ctx, ins, attrs):
    """max(x, 0) as the JAX op computes it (``jnp.maximum``), so that its
    generic-vjp gradient splits a tie as that one does: half the
    cotangent where x is exactly 0 (``torch.relu`` passes none). Exact
    zeros are common in bf16, where a residual join's two operands
    cancel."""
    return {"Out": [torch.maximum(x(ins), ZERO)]}


@register_op("pow", infer=same_shape_infer())
def pow_op(ctx, ins, attrs):
    return {"Out": [x(ins) ** attrs.get("factor", 1.0)]}


def _mean_infer(op: OpDesc, block):
    for n in op.output("Out"):
        set_out_var(block, n, [1], in_dtype(block, op, "X"))


@register_op("mean", infer=_mean_infer)
def mean(ctx, ins, attrs):
    return {"Out": [x(ins).mean().reshape(1)]}
