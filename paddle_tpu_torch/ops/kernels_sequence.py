"""Sequence ops (counterpart of ``paddle_tpu/ops/kernels_sequence.py``):
ragged batches are padded tensors plus lengths, and ``sequence_mask``
turns the lengths into the [B, maxlen] mask."""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..core.types import dtype_to_torch
from ..registry import register_op
from .common import in_shape, set_out_var


def _seqmask_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is not None:
        maxlen = int(op.attrs.get("maxlen", -1))
        for n in op.output("Y"):
            set_out_var(block, n, [xs[0], maxlen],
                        op.attrs.get("out_dtype", "int64"))


@register_op("sequence_mask", no_grad=True, infer=_seqmask_infer)
def sequence_mask(ctx, ins, attrs):
    """lengths [B] -> [B, maxlen] 0/1 mask in ``out_dtype``."""
    xv = ins["X"][0].reshape(-1)
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen attr")
    m = torch.arange(maxlen, device=xv.device)[None, :] < xv[:, None]
    return {"Y": [m.to(dtype_to_torch(attrs.get("out_dtype", "int64")))]}
