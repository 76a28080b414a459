"""Loss and similarity ops (counterpart of ``paddle_tpu/ops/kernels_loss.py``;
reference cos_sim_op.h, log_loss_op.h): ``cos_sim`` and ``log_loss``.
Their grads run the generic vjp."""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import register_op
from .common import in_dtype, in_shape, same_shape_infer, set_out_var

# cos_sim's floor under |x||y|; a 0-d host tensor, so ``torch.maximum``
# (the tie rule of ``jnp.maximum``: half the gradient to each side)
# broadcasts it on any device
_COS_EPS = torch.tensor(1e-12)


def _rowcol_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if xs is not None:
        for n in op.output("Out"):
            set_out_var(block, n, [xs[0], 1], dt)


@register_op("cos_sim", intermediate_outputs=("XNorm", "YNorm"),
             infer=_rowcol_infer)
def cos_sim(ctx, ins, attrs):
    """cos_sim_op.h: the row-wise cosine of X [N, D] and Y [N, D] or
    [1, D] (broadcast over X's rows), with the norms XNorm and YNorm."""
    xv, yv = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(xv * xv, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(yv * yv, dim=-1, keepdim=True))
    num = torch.sum(xv * yv, dim=-1, keepdim=True)
    out = num / torch.maximum(xn * yn, _COS_EPS.to(xv.dtype))
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("log_loss", infer=same_shape_infer("Loss", "Predicted"))
def log_loss(ctx, ins, attrs):
    """log_loss_op.h: -y log(p + eps) - (1 - y) log(1 - p + eps)."""
    pred, label = ins["Predicted"][0], ins["Labels"][0]
    eps = float(attrs.get("epsilon", 1e-4))
    return {"Loss": [-label * torch.log(pred + eps)
                     - (1.0 - label) * torch.log(1.0 - pred + eps)]}
