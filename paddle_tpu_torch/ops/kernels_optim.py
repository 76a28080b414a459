"""Optimizer update ops (counterpart of ``paddle_tpu/ops/kernels_optim.py``):
``adam`` and its multi-tensor form ``fused_adam``, in plain torch ops (the
JAX package has no hand kernel for either). ParamOut rebinds the
parameter's name, so the executor writes the updated tensor back into the
scope; the update is not in place."""

from __future__ import annotations

import torch

from ..registry import register_op
from .common import same_shape_infer


@register_op("adam", no_grad=True,
             infer=same_shape_infer("ParamOut", "Param"))
def adam(ctx, ins, attrs):
    """Adam with the bias corrections folded into the step size, in the
    JAX package's order of operations."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = (ins["LearningRate"][0].reshape(())
          * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(())))
    g = g.to(p.dtype)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    p_out = p - lr * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}


def _flat_group(tensors, dtype=None):
    """Per-parameter tensors -> one flat vector, with the sizes and
    shapes that split it back."""
    sizes = [t.numel() for t in tensors]
    shapes = [tuple(t.shape) for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return (flat if dtype is None else flat.to(dtype)), sizes, shapes


def _split_group(flat, sizes, shapes):
    """The flat vector back in the parameters' shapes (views of it)."""
    return [part.view(shape)
            for part, shape in zip(torch.split(flat, sizes), shapes)]


def _scalar_list(vals):
    """Per-parameter [1]-shaped tensors -> one [N] vector."""
    return torch.cat([v.reshape(1) for v in vals])


@register_op("fused_adam", no_grad=True)
def fused_adam(ctx, ins, attrs):
    """The multi-tensor Adam update ``fuse_optimizer_update_ops`` writes
    for a group of per-parameter adam ops: the group's parameters,
    gradients and moments flattened into one vector each (``torch.cat``)
    and updated in one pass of elementwise ops, with the step size of
    each parameter stretched over its segment. Each element goes through
    the same float32 operations, in the same order, as ``adam``, so the
    results are bitwise equal to the per-parameter ops'."""
    p, sizes, shapes = _flat_group(ins["Param"])
    g, _, _ = _flat_group(ins["Grad"], dtype=p.dtype)
    m1, _, _ = _flat_group(ins["Moment1"])
    m2, _, _ = _flat_group(ins["Moment2"])
    b1p = _scalar_list(ins["Beta1Pow"])
    b2p = _scalar_list(ins["Beta2Pow"])
    lr = _scalar_list(ins["LearningRate"])
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    # adam's scalar step size per parameter, vectorized over [N], then
    # one value per element of the parameter's segment (a copy of
    # expanded views; repeat_interleave would first build an int64 index
    # of every element)
    lr_eff = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    lr_seg = torch.cat([lr_eff[i:i + 1].expand(n)
                        for i, n in enumerate(sizes)])
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    p_out = p - lr_seg * m1_out / (torch.sqrt(m2_out) + eps)
    b1p_out, b2p_out = b1p * b1, b2p * b2
    n = len(sizes)
    return {"ParamOut": _split_group(p_out, sizes, shapes),
            "Moment1Out": _split_group(m1_out, sizes, shapes),
            "Moment2Out": _split_group(m2_out, sizes, shapes),
            "Beta1PowOut": [b1p_out[i:i + 1] for i in range(n)],
            "Beta2PowOut": [b2p_out[i:i + 1] for i in range(n)]}
