"""Math ops (counterpart of ``paddle_tpu/ops/kernels_math.py``): the
elementwise family with Fluid's axis broadcast, the compare and logical
ops, the reductions, the fc product ``mul``, ``matmul``, ``softmax`` and
``log_softmax``, ``scale``, ``clip`` and ``clip_by_norm``, the activation
family (activation_op.cc) and the whole-tensor predicates (``isfinite``,
``has_inf``, ``has_nan``). Large products go to ``torch.matmul``, as the
JAX package left them to XLA.

Each op computes what its JAX emitter computes, in the same order of
operations, so that its generic-vjp gradient matches the JAX package's
too: clips are ``maximum`` then ``minimum`` (ties split the cotangent
in half, as ``jnp.clip`` does), and ``gelu`` is the erfc form
``jax.nn.gelu`` computes (the tanh form with ``approximate``).

Under AMP a bf16 activation meeting an fp32 operand (a bias, the residual
stream) promotes to fp32, as the JAX package computes it: its
``amp_harmonize`` compares dtypes against the ``jnp.bfloat16`` scalar type
in a set, which never matches, so it leaves both operands as they are."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.desc import OpDesc
from ..core.types import DataType
from ..registry import register_op
from .common import (ZERO, amp_cast, fluid_broadcast, in_dtype, in_shape,
                     jax_abs, normalize_reduce_dims, same_shape_infer,
                     scalar_infer, set_out_var, softplus, x)


def _make_elementwise(name, fn):
    def emit(ctx, ins, attrs):
        xv, yv = fluid_broadcast(ins["X"][0], ins["Y"][0],
                                 attrs.get("axis", -1))
        return {"Out": [fn(xv, yv)]}

    emit.__name__ = name
    register_op(name, infer=same_shape_infer())(emit)


_make_elementwise("elementwise_add", torch.add)
_make_elementwise("elementwise_sub", torch.sub)
_make_elementwise("elementwise_mul", torch.mul)
_make_elementwise("elementwise_div", torch.div)
_make_elementwise("elementwise_max", torch.maximum)
_make_elementwise("elementwise_min", torch.minimum)
_make_elementwise("elementwise_pow", torch.pow)


@register_op("elementwise_mod", no_grad=True, infer=same_shape_infer())
def elementwise_mod(ctx, ins, attrs):
    """The remainder with the divisor's sign (``jnp.mod``)."""
    xv, yv = fluid_broadcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
    return {"Out": [torch.remainder(xv, yv)]}


@register_op("elementwise_floordiv", no_grad=True, infer=same_shape_infer())
def elementwise_floordiv(ctx, ins, attrs):
    xv, yv = fluid_broadcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
    return {"Out": [torch.floor_divide(xv, yv)]}


# comparison / logical (controlflow/compare_op.cc, logical_op.cc): bool out
def _compare_infer(op: OpDesc, block):
    for n in op.output("Out"):
        set_out_var(block, n, in_shape(block, op, "X"), DataType.BOOL)


def _make_compare(name, fn):
    def emit(ctx, ins, attrs):
        xv, yv = fluid_broadcast(ins["X"][0], ins["Y"][0],
                                 attrs.get("axis", -1))
        return {"Out": [fn(xv, yv)]}

    emit.__name__ = name
    register_op(name, no_grad=True, infer=_compare_infer)(emit)


_make_compare("equal", torch.eq)
_make_compare("not_equal", torch.ne)
_make_compare("less_than", torch.lt)
_make_compare("less_equal", torch.le)
_make_compare("greater_than", torch.gt)
_make_compare("greater_equal", torch.ge)
_make_compare("logical_and", torch.logical_and)
_make_compare("logical_or", torch.logical_or)
_make_compare("logical_xor", torch.logical_xor)


@register_op("logical_not", no_grad=True, infer=_compare_infer)
def logical_not(ctx, ins, attrs):
    return {"Out": [torch.logical_not(x(ins))]}


# whole-tensor predicates (isfinite_op.cc): one bool [1]
_FLAG_INFER = scalar_infer(dtype="bool", shape=(1,))


@register_op("isfinite", no_grad=True, infer=_FLAG_INFER)
def isfinite(ctx, ins, attrs):
    """True when every element of every X is finite."""
    flags = [torch.isfinite(v).all() for v in ins["X"] if v is not None]
    out = flags[0]
    for f in flags[1:]:
        out = torch.logical_and(out, f)
    return {"Out": [out.reshape(1)]}


@register_op("has_inf", no_grad=True, infer=_FLAG_INFER)
def has_inf(ctx, ins, attrs):
    return {"Out": [torch.isinf(x(ins)).any().reshape(1)]}


@register_op("has_nan", no_grad=True, infer=_FLAG_INFER)
def has_nan(ctx, ins, attrs):
    return {"Out": [torch.isnan(x(ins)).any().reshape(1)]}


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


def _prod(xv, dim, keepdim):
    """``torch.prod`` takes one dim: reduce them one at a time, the
    highest first, so that the remaining dims keep their numbers."""
    for d in sorted(dim, reverse=True):
        xv = xv.prod(dim=d, keepdim=keepdim)
    return xv


def _make_reduce(name, fn):
    def emit(ctx, ins, attrs):
        xv = x(ins)
        dims = normalize_reduce_dims(xv.dim(), attrs.get("dim"),
                                     attrs.get("reduce_all", False))
        out = fn(xv, dim=dims, keepdim=attrs.get("keep_dim", False))
        if out.dim() == 0:
            out = out.reshape(1)  # Fluid convention: a full reduce is [1]
        return {"Out": [out]}

    emit.__name__ = name
    register_op(name, infer=_reduce_infer)(emit)


# amax/amin split the gradient evenly among tied maxima, as the JAX
# package's reduce_max/reduce_min vjp does
_make_reduce("reduce_sum", torch.sum)
_make_reduce("reduce_mean", torch.mean)
_make_reduce("reduce_max", torch.amax)
_make_reduce("reduce_min", torch.amin)
_make_reduce("reduce_prod", _prod)


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


@register_op("log_softmax", infer=same_shape_infer())
def log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(x(ins), dim=attrs.get("axis", -1))]}


def _clip(v, lo, hi):
    """``jnp.clip``: ``maximum(lo, v)`` then ``minimum(hi, .)``, bounds as
    0-d host tensors in v's dtype; ``torch.maximum``/``minimum`` give a
    tie half the cotangent, as ``jnp.maximum``/``minimum`` do
    (``torch.clamp`` would give it all)."""
    v = torch.maximum(v, torch.tensor(lo, dtype=v.dtype))
    return torch.minimum(v, torch.tensor(hi, dtype=v.dtype))


@register_op("clip", infer=same_shape_infer())
def clip(ctx, ins, attrs):
    return {"Out": [_clip(x(ins), attrs["min"], attrs["max"])]}


@register_op("clip_by_norm", infer=same_shape_infer())
def clip_by_norm(ctx, ins, attrs):
    """X scaled by max_norm / ||X|| where its L2 norm exceeds max_norm."""
    xv = x(ins)
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(xv * xv))
    return {"Out": [torch.where(norm > max_norm, xv * (max_norm / norm),
                                xv)]}


@register_op("sign", no_grad=True, infer=same_shape_infer())
def sign(ctx, ins, attrs):
    return {"Out": [torch.sign(x(ins))]}


@register_op("pow", infer=same_shape_infer())
def pow_op(ctx, ins, attrs):
    return {"Out": [x(ins) ** attrs.get("factor", 1.0)]}


# ---------------------------------------------------------------------------
# activations (activation_op.cc family), each as its JAX emitter computes
# it; ``a`` is the op's attrs
# ---------------------------------------------------------------------------

def _make_act(name, fn):
    def emit(ctx, ins, attrs):
        return {"Out": [fn(x(ins), attrs)]}

    emit.__name__ = name
    register_op(name, infer=same_shape_infer())(emit)


def _where0(cond, v):
    """v where cond, else 0 in v's dtype."""
    return torch.where(cond, v, 0.0)


def _softshrink(v, lam):
    return torch.where(v > lam, v - lam, _where0(v < -lam, v + lam))


def _elu(v, alpha):
    """``jax.nn.elu``: the expm1 branch sees 0 where v > 0, so that its
    gradient there is finite."""
    pos = v > 0
    return torch.where(pos, v, alpha * torch.expm1(_where0(~pos, v)))


def _gelu(v, approximate):
    """``jax.nn.gelu``: 0.5 v erfc(-v sqrt(1/2)), or with ``approximate``
    v 0.5 (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3)))."""
    if approximate:
        c = float(np.float32(math.sqrt(2 / math.pi)))
        return v * (0.5 * (1.0 + torch.tanh(c * (v + 0.044715 * v ** 3))))
    return 0.5 * v * torch.special.erfc(-v * float(np.float32(
        math.sqrt(0.5))))


# relu is max(v, 0) as the JAX op computes it (``jnp.maximum``), so that
# its generic-vjp gradient splits a tie as that one does: half the
# cotangent where v is exactly 0 (``torch.relu`` passes none). Exact
# zeros are common in bf16, where a residual join's two operands cancel
_make_act("relu", lambda v, a: torch.maximum(v, ZERO))
_make_act("sigmoid", lambda v, a: torch.sigmoid(v))
_make_act("tanh", lambda v, a: torch.tanh(v))
_make_act("exp", lambda v, a: torch.exp(v))
_make_act("log", lambda v, a: torch.log(v))
_make_act("sqrt", lambda v, a: torch.sqrt(v))
_make_act("rsqrt", lambda v, a: torch.rsqrt(v))
_make_act("abs", lambda v, a: jax_abs(v))
_make_act("square", lambda v, a: v * v)
_make_act("reciprocal", lambda v, a: 1.0 / v)
_make_act("ceil", lambda v, a: torch.ceil(v))
_make_act("floor", lambda v, a: torch.floor(v))
_make_act("round", lambda v, a: torch.round(v))
_make_act("cos", lambda v, a: torch.cos(v))
_make_act("sin", lambda v, a: torch.sin(v))
_make_act("softplus", lambda v, a: softplus(v))
_make_act("softsign", lambda v, a: v / (1 + torch.abs(v)))
_make_act("softshrink", lambda v, a: _softshrink(v, a.get("lambda", 0.5)))
_make_act("tanh_shrink", lambda v, a: v - torch.tanh(v))
_make_act("relu6", lambda v, a: _clip(v, 0.0, a.get("threshold", 6.0)))
_make_act("leaky_relu", lambda v, a: torch.where(
    v >= 0, v, v * a.get("alpha", 0.02)))
_make_act("elu", lambda v, a: _elu(v, a.get("alpha", 1.0)))
_make_act("gelu", lambda v, a: _gelu(v, a.get("approximate", False)))
_make_act("swish", lambda v, a: v * torch.sigmoid(a.get("beta", 1.0) * v))
_make_act("hard_sigmoid", lambda v, a: _clip(
    a.get("slope", 0.2) * v + a.get("offset", 0.5), 0.0, 1.0))
_make_act("brelu", lambda v, a: _clip(
    v, a.get("t_min", 0.0), a.get("t_max", 24.0)))
_make_act("soft_relu", lambda v, a: torch.log(1 + torch.exp(_clip(
    v, -a.get("threshold", 40.0), a.get("threshold", 40.0)))))
_make_act("thresholded_relu", lambda v, a: _where0(
    v > a.get("threshold", 1.0), v))
_make_act("stanh", lambda v, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * v))
_make_act("hard_swish", lambda v, a: v * _clip(
    v + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
    / a.get("scale", 6.0))
_make_act("logsigmoid", lambda v, a: torch.nn.functional.logsigmoid(v))


def _mean_infer(op: OpDesc, block):
    for n in op.output("Out"):
        set_out_var(block, n, [1], in_dtype(block, op, "X"))


@register_op("mean", infer=_mean_infer)
def mean(ctx, ins, attrs):
    return {"Out": [x(ins).mean().reshape(1)]}
