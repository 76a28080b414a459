"""Shared helpers for op emitters and shape inference."""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core.desc import OpDesc
from ..core.types import convert_dtype


def x(ins, slot="X"):
    return ins[slot][0]


def opt(ins, slot):
    """The optional input in ``slot``, or None."""
    vals = ins.get(slot)
    return vals[0] if vals and vals[0] is not None else None


def set_out_var(block, name: str, shape=None, dtype=None):
    """Fill shape/dtype on an existing output VarDesc (eager InferShape)."""
    if not name or not block.has_var_recursive(name):
        return
    desc = block._find_var_desc_recursive(name)
    if shape is not None:
        desc.shape = [int(s) for s in shape]
    if dtype is not None:
        desc.dtype = convert_dtype(dtype)


def in_shape(block, op: OpDesc, slot: str, idx: int = 0) -> Optional[List[int]]:
    names = op.input(slot)
    if idx >= len(names):
        return None
    d = block._find_var_desc_recursive(names[idx])
    return list(d.shape) if d is not None and d.shape is not None else None


def in_dtype(block, op: OpDesc, slot: str, idx: int = 0):
    names = op.input(slot)
    if idx >= len(names):
        return None
    d = block._find_var_desc_recursive(names[idx])
    return d.dtype if d is not None else None


def same_shape_infer(out_slot="Out", in_slot="X"):
    """infer rule: Out has X's shape/dtype (elementwise/activation)."""

    def infer(op: OpDesc, block):
        shp = in_shape(block, op, in_slot)
        dt = in_dtype(block, op, in_slot)
        for name in op.output(out_slot):
            set_out_var(block, name, shp, dt)

    return infer


def scalar_infer(out_slot="Out", dtype=None, shape=(1,), in_slot="X"):
    """infer rule: Out is a fixed-shape statistic (a norm, a flag);
    dtype=None inherits in_slot's dtype."""

    def infer(op: OpDesc, block):
        dt = dtype if dtype is not None else in_dtype(block, op, in_slot)
        for name in op.output(out_slot):
            set_out_var(block, name, list(shape), dt)

    return infer


def opaque_infer(reason: str = ""):
    """infer rule of an op whose outputs are statically opaque (host side
    effects, data-dependent extents, LoDTensorArray plumbing, control
    flow). Declaring it is the contract: the verifier (ir/verify.py)
    skips the op's shape check instead of evaluating an emitter that
    cannot run on meta tensors, and the coverage measure counts it."""

    def infer(op: OpDesc, block):
        return None

    infer._opaque = True
    infer._reason = reason
    return infer


def dtype_only_infer(out_slot="Out", in_slot="X"):
    """infer rule: Out carries X's dtype; its shape is known only at run
    time."""

    def infer(op: OpDesc, block):
        for name in op.output(out_slot):
            set_out_var(block, name, None, in_dtype(block, op, in_slot))

    return infer


def slots_like_infer(*pairs):
    """infer rule from (out_slot, in_slot) pairs: each output takes its
    input's shape and dtype, name for name (the first input's past the
    last one)."""

    def infer(op: OpDesc, block):
        for out_slot, in_slot in pairs:
            n_in = len(op.input(in_slot))
            for i, name in enumerate(op.output(out_slot)):
                idx = i if i < n_in else 0
                set_out_var(block, name, in_shape(block, op, in_slot, idx),
                            in_dtype(block, op, in_slot, idx))

    return infer


def fluid_broadcast(xv: torch.Tensor, yv: torch.Tensor, axis: int):
    """Fluid elementwise broadcast: align Y into X at ``axis``
    (reference elementwise_op_function.h semantics)."""
    if xv.dim() == yv.dim():
        return xv, yv
    if yv.dim() > xv.dim():
        xv2, yv2 = fluid_broadcast(yv, xv, axis)
        return yv2, xv2
    if axis == -1:
        axis = xv.dim() - yv.dim()
    new_shape = [1] * axis + list(yv.shape) + [1] * (
        xv.dim() - axis - yv.dim())
    return xv, yv.reshape(new_shape)


def normalize_reduce_dims(ndim: int, dim, reduce_all: bool):
    if reduce_all or dim is None or (isinstance(dim, (list, tuple))
                                     and len(dim) == 0):
        return tuple(range(ndim))
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d % ndim for d in dim)


_AMP_TYPES = (torch.float32, torch.bfloat16)

# a 0-d host zero: max(x, ZERO) broadcasts into a tensor on any device and
# keeps its dtype (the relu of the JAX package, ``jnp.maximum(x, 0)``)
ZERO = torch.zeros(())


def jax_abs(v: torch.Tensor) -> torch.Tensor:
    """|v| differentiated as ``jnp.abs``: g where v >= 0 and -g elsewhere,
    so +0 and -0 pass the whole cotangent (``torch.abs`` passes none
    there); v + 0.0 turns -0 into +0, so the values are torch.abs's bit
    for bit."""
    return torch.where(v >= 0, v + 0.0, torch.abs(v))


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(v, 0), whose gradient is
    sigmoid(v). The 0 is a 0-d tensor on v's device: ``logaddexp``, unlike
    ``maximum``, takes no host scalar tensor beside a CUDA one."""
    return torch.logaddexp(v, v.new_zeros(()))


def amp_cast(ctx, *tensors):
    """bf16 autocast for matrix-product ops, the cast points of the JAX
    package: float32 inputs cast to bfloat16 and the op output stays
    bf16. An identity when amp is off or the inputs are not floats."""
    if not getattr(ctx, "amp", False) or tensors[0].dtype not in _AMP_TYPES:
        return tensors
    return tuple(t.to(torch.bfloat16) if t.dtype == torch.float32 else t
                 for t in tensors)


def batch_size_like_shape(ins, attrs):
    """A ``*_batch_size_like`` op's shape: the attr ``shape`` with dim
    ``output_dim_idx`` taken from dim ``input_dim_idx`` of Input."""
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = ins["Input"][0].shape[
        attrs.get("input_dim_idx", 0)]
    return tuple(shape)


def batch_size_like_infer(op: OpDesc, block):
    """*_batch_size_like: the shape attr with dim output_dim_idx replaced
    by Input's dim input_dim_idx."""
    shape = [int(s) for s in op.attrs.get("shape", [])]
    ins = in_shape(block, op, "Input")
    if not shape:
        return
    odi = int(op.attrs.get("output_dim_idx", 0) or 0)
    idi = int(op.attrs.get("input_dim_idx", 0) or 0)
    if ins and idi < len(ins) and odi < len(shape):
        shape[odi] = ins[idi]
    for n in op.output("Out"):
        set_out_var(block, n, shape, op.attrs.get("dtype", "float32"))


def true_div(a: torch.Tensor, n) -> torch.Tensor:
    """``a / n`` for a Python number ``n``, a true division on every
    device: CUDA divides by a Python scalar through its reciprocal, which
    can move a quotient by an ulp, and a floor, ceil, round or threshold
    after it by a whole step."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def length_or_full(ins, batch: int, max_len: int, device,
                   slot: str = "Length") -> torch.Tensor:
    """The padded convention's [B] int32 valid lengths from ``slot``, or
    ``max_len`` for every row when the slot is absent (the JAX package's
    ``length_or_full``)."""
    length = opt(ins, slot)
    if length is not None:
        return length.reshape(-1).to(torch.int32)
    return torch.full((batch,), max_len, dtype=torch.int32, device=device)


_ORDER_INT = {torch.float64: torch.int64, torch.float32: torch.int32,
              torch.float16: torch.int16, torch.bfloat16: torch.int16}


def total_order_key(v: torch.Tensor) -> torch.Tensor:
    """An integer key of ``v`` whose order is IEEE 754's total order, the
    order ``lax.top_k`` ranks by: -NaN < -inf < ... < -0 < +0 < ... < +inf
    < +NaN. It is the float's bits as a signed integer with the magnitude
    bits flipped where the sign bit is set: a view and two bit
    operations, so sorting on it reads nothing on the host and can be
    captured. torch's float sort instead ties -0 with +0 and ranks every
    NaN highest."""
    it = _ORDER_INT[v.dtype]
    bits = v.contiguous().view(it)
    sign = bits >> (torch.iinfo(it).bits - 1)   # -1 where negative, else 0
    return bits ^ (sign & torch.iinfo(it).max)


def top_k_total_order(v: torch.Tensor, k: int):
    """The ``k`` largest of ``v`` along its last dim in ``lax.top_k``'s
    order: total order, equal keys in index order (a stable descending
    sort of :func:`total_order_key`). Returns (values, int64 indices)."""
    _, idx = torch.sort(total_order_key(v), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    return torch.take_along_dim(v, idx, dim=-1), idx
