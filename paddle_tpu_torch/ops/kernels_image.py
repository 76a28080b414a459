"""Image ops (counterpart of ``paddle_tpu/ops/kernels_image.py``):
``affine_channel``, the op conv_affine_channel_fuse_pass folds into a
conv, and ``is_empty``. The other image ops, ``random_crop`` among them,
wait for ROADMAP A11."""

from __future__ import annotations

import torch

from ..registry import register_op
from .common import same_shape_infer, scalar_infer


@register_op("affine_channel", infer=same_shape_infer())
def affine_channel(ctx, ins, attrs):
    """affine_channel_op.cc: x * Scale[C] + Bias[C] over NCHW."""
    xv = ins["X"][0]
    shape = (1, -1) + (1,) * (xv.dim() - 2)
    return {"Out": [xv * ins["Scale"][0].reshape(shape)
                    + ins["Bias"][0].reshape(shape)]}


@register_op("is_empty", no_grad=True,
             infer=scalar_infer(dtype="bool", shape=(1,)))
def is_empty(ctx, ins, attrs):
    """is_empty_op.cc: numel(X) == 0, a 0-d bool known from the shape
    (filled on the device, so the op can be captured)."""
    xv = ins["X"][0]
    return {"Out": [torch.full((), xv.numel() == 0, dtype=torch.bool,
                               device=xv.device)]}
