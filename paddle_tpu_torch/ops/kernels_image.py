"""Image ops (counterpart of ``paddle_tpu/ops/kernels_image.py``):
``affine_channel``, the op conv_affine_channel_fuse_pass folds into a
conv. The other image ops, ``random_crop`` among them, wait for ROADMAP
A11."""

from __future__ import annotations

from ..registry import register_op
from .common import same_shape_infer


@register_op("affine_channel", infer=same_shape_infer())
def affine_channel(ctx, ins, attrs):
    """affine_channel_op.cc: x * Scale[C] + Bias[C] over NCHW."""
    xv = ins["X"][0]
    shape = (1, -1) + (1,) * (xv.dim() - 2)
    return {"Out": [xv * ins["Scale"][0].reshape(shape)
                    + ins["Bias"][0].reshape(shape)]}
