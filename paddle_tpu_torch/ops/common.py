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


def amp_cast(ctx, *tensors):
    """bf16 autocast for matrix-product ops, the cast points of the JAX
    package: float32 inputs cast to bfloat16 and the op output stays
    bf16. An identity when amp is off or the inputs are not floats."""
    if not getattr(ctx, "amp", False) or tensors[0].dtype not in _AMP_TYPES:
        return tensors
    return tuple(t.to(torch.bfloat16) if t.dtype == torch.float32 else t
                 for t in tensors)
