"""Image ops (counterpart of ``paddle_tpu/ops/kernels_image.py``):
``affine_channel``, the op conv_affine_channel_fuse_pass folds into a
conv, ``is_empty``, and the resize ops ``interpolate``,
``bilinear_interp`` and ``nearest_interp`` (one emitter, three names).
The other image ops of the JAX package, ``random_crop`` first, are still
to port (ROADMAP A11)."""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import register_op
from .common import (in_dtype, in_shape, same_shape_infer, scalar_infer,
                     set_out_var, true_div)


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


def _interp_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is not None:
        for n in op.output("Out"):
            set_out_var(block, n, [xs[0], xs[1], op.attrs.get("out_h"),
                                   op.attrs.get("out_w")],
                        in_dtype(block, op, "X"))


def _src_index(out_size, in_size, align_corners, device):
    """Source coordinate of each output row (interpolate_op.cc): the
    corner-aligned ratio, or the half-pixel rule clamped at 0."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        if out_size == 1:
            return torch.zeros((1,), dtype=torch.float32, device=device)
        return true_div(i * (in_size - 1), out_size - 1)
    return torch.clamp((i + 0.5) * (in_size / out_size) - 0.5, min=0.0)


@register_op("interpolate", infer=_interp_infer)
def interpolate(ctx, ins, attrs):
    """interpolate_op.cc: bilinear or nearest resize of NCHW maps to the
    static ``out_h`` x ``out_w`` (nearest rounds half to even, as
    ``jnp.round`` does). Rows and columns are picked by ``index_select``,
    whose gradient is an index add."""
    xv = ins["X"][0]
    _, _, h, w = xv.shape
    if ins.get("OutSize") and ins["OutSize"][0] is not None:
        raise ValueError("interpolate requires static out_h/out_w attrs "
                         "(a dynamic OutSize tensor is unsupported)")
    oh, ow = int(attrs["out_h"]), int(attrs["out_w"])
    ac = bool(attrs.get("align_corners", True))
    fh = _src_index(oh, h, ac, xv.device)
    fw = _src_index(ow, w, ac, xv.device)
    if attrs.get("interp_method", "bilinear") == "nearest":
        ih = torch.clamp(torch.round(fh), 0, h - 1).long()
        iw = torch.clamp(torch.round(fw), 0, w - 1).long()
        return {"Out": [xv.index_select(2, ih).index_select(3, iw)]}
    h0 = torch.clamp(torch.floor(fh).long(), 0, h - 1)
    h1 = torch.clamp(h0 + 1, 0, h - 1)
    w0 = torch.clamp(torch.floor(fw).long(), 0, w - 1)
    w1 = torch.clamp(w0 + 1, 0, w - 1)
    lh = (fh - h0).to(xv.dtype)[None, None, :, None]
    lw = (fw - w0).to(xv.dtype)[None, None, None, :]
    r0, r1 = xv.index_select(2, h0), xv.index_select(2, h1)
    v00, v01 = r0.index_select(3, w0), r0.index_select(3, w1)
    v10, v11 = r1.index_select(3, w0), r1.index_select(3, w1)
    return {"Out": [v00 * (1 - lh) * (1 - lw) + v01 * (1 - lh) * lw
                    + v10 * lh * (1 - lw) + v11 * lh * lw]}


@register_op("bilinear_interp", infer=_interp_infer)
def bilinear_interp(ctx, ins, attrs):
    return interpolate(ctx, ins, dict(attrs, interp_method="bilinear"))


@register_op("nearest_interp", infer=_interp_infer)
def nearest_interp(ctx, ins, attrs):
    return interpolate(ctx, ins, dict(attrs, interp_method="nearest"))
