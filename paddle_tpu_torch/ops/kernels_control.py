"""Control-flow ops (counterpart of ``paddle_tpu/ops/kernels_control.py``):
``increment`` only, the step counter of the learning-rate schedules."""

from __future__ import annotations

import torch

from ..registry import register_op
from .common import same_shape_infer, x


@register_op("increment", no_grad=True, infer=same_shape_infer())
def increment(ctx, ins, attrs):
    """X + step, the step cast to X's dtype as the JAX op casts it (a CPU
    scalar read back as a Python number) and added as a number: no copy
    to the device, so the op can be captured in a CUDA graph."""
    xv = x(ins)
    step = torch.tensor(attrs.get("step", 1.0), dtype=xv.dtype).item()
    return {"Out": [xv + step]}
