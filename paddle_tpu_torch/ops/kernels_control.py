"""Control-flow ops (counterpart of ``paddle_tpu/ops/kernels_control.py``):
``increment`` only, the step counter of the learning-rate schedules."""

from __future__ import annotations

import torch

from ..registry import register_op
from .common import same_shape_infer, x


@register_op("increment", no_grad=True, infer=same_shape_infer())
def increment(ctx, ins, attrs):
    xv = x(ins)
    step = torch.as_tensor(attrs.get("step", 1.0), dtype=xv.dtype,
                           device=xv.device)
    return {"Out": [xv + step]}
