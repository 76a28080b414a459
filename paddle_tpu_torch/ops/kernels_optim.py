"""Optimizer update ops (counterpart of ``paddle_tpu/ops/kernels_optim.py``):
``adam`` only, in plain torch ops (the JAX package has no hand kernel for
it). ParamOut rebinds the parameter's name, so the executor writes the
updated tensor back into the scope; the update is not in place."""

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
