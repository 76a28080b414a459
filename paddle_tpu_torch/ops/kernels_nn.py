"""NN ops (counterpart of ``paddle_tpu/ops/kernels_nn.py``): layer_norm,
softmax_with_cross_entropy with its grad, and the ``fc`` op that
fc_fuse_pass writes."""

from __future__ import annotations

import numpy as np
import torch

from ..core.desc import OpDesc
from ..core.types import GRAD_SUFFIX, DataType
from ..registry import register_op
from .common import amp_cast, in_dtype, in_shape, opt, set_out_var


def _ln_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if xs is None:
        return
    left = int(np.prod(xs[:op.attrs.get("begin_norm_axis", 1)]))
    for n in op.output("Y"):
        set_out_var(block, n, xs, dt)
    for slot in ("Mean", "Variance"):
        for n in op.output(slot):
            set_out_var(block, n, [left], DataType.FP32)


@register_op("layer_norm", intermediate_outputs=("Mean", "Variance"),
             infer=_ln_infer)
def layer_norm(ctx, ins, attrs):
    """Normalize over dims >= begin_norm_axis, statistics in fp32."""
    xv = ins["X"][0]
    scale = opt(ins, "Scale")
    bias = opt(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, xv.dim()))
    xf = xv.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = (1,) * begin + tuple(xv.shape[begin:])
    if scale is not None:
        y = y * scale.float().reshape(norm_shape)
    if bias is not None:
        y = y + bias.float().reshape(norm_shape)
    return {"Y": [y.to(xv.dtype)],
            "Mean": [mean.reshape(-1)], "Variance": [var.reshape(-1)]}


def _swce_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Logits")
    dt = in_dtype(block, op, "Logits")
    if xs is not None:
        for n in op.output("Softmax"):
            set_out_var(block, n, xs, dt)
        for n in op.output("Loss"):
            set_out_var(block, n, xs[:-1] + [1], dt)


def _hard_label(label, logits):
    """The label ids without their trailing [, 1] dim."""
    if label.dim() == logits.dim() and label.shape[-1] == 1:
        label = label.reshape(label.shape[:-1])
    return label.long()


def _in_range(lab, logits):
    """Label ids clamped into the vocab, for gathers (an ignored label
    may lie outside it)."""
    return lab.clamp(0, logits.shape[-1] - 1)


def _swce_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    """The grad reads Logits and recomputes the softmax rather than
    reading the forward's Softmax output."""
    ln = op.input("Logits")[0]
    if ln in no_grad_set:
        return [], {}
    g = OpDesc("softmax_with_cross_entropy_grad",
               {"Logits": op.input("Logits"), "Label": op.input("Label"),
                "Loss@GRAD": [op.output("Loss")[0] + GRAD_SUFFIX]},
               {"Logits@GRAD": [ln + GRAD_SUFFIX]}, dict(op.attrs))
    return [g], {ln + GRAD_SUFFIX: ln}


@register_op("softmax_with_cross_entropy", intermediate_outputs=("Softmax",),
             infer=_swce_infer, grad_maker=_swce_grad_maker)
def softmax_with_cross_entropy(ctx, ins, attrs):
    """Softmax and cross entropy in fp32 (bf16 logits are upcast): the
    hard-label loss is lse - logit[label], 0 at ignore_index."""
    logits = ins["Logits"][0].float()
    label = ins["Label"][0]
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    softmax = torch.exp(logits - lse)
    if attrs.get("soft_label", False):
        loss = -(label * (logits - lse)).sum(dim=-1, keepdim=True)
    else:
        lab = _hard_label(label, logits)
        loss = lse - logits.gather(-1, _in_range(lab, logits).unsqueeze(-1))
        loss = loss.masked_fill(
            (lab == attrs.get("ignore_index", -100)).unsqueeze(-1), 0.0)
    return {"Softmax": [softmax], "Loss": [loss]}


@register_op("softmax_with_cross_entropy_grad", no_grad=True)
def softmax_with_cross_entropy_grad(ctx, ins, attrs):
    """(softmax - onehot(label)) * Loss@GRAD from the recomputed fp32
    softmax, returned in the logits' dtype."""
    logits = ins["Logits"][0]
    label = ins["Label"][0]
    lg = ins["Loss@GRAD"][0]
    softmax = torch.softmax(logits.float(), dim=-1)
    if attrs.get("soft_label", False):
        grad = (softmax - label) * lg
    else:
        # (softmax - onehot) * lg without the [.., V] one-hot: -lg added
        # at each label's column (none for a label outside the vocab)
        lab = _hard_label(label, softmax)
        grad = softmax * lg
        valid = (lab >= 0) & (lab < softmax.shape[-1])
        grad.scatter_add_(-1, _in_range(lab, softmax).unsqueeze(-1),
                          (-lg * valid.unsqueeze(-1)).to(grad.dtype))
        grad = grad.masked_fill(
            (lab == attrs.get("ignore_index", -100)).unsqueeze(-1), 0.0)
    return {"Logits@GRAD": [grad.to(logits.dtype)]}


def _fc_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Input")
    ws = in_shape(block, op, "W")
    if xs is None or ws is None:
        return
    ncol = int(op.attrs.get("in_num_col_dims", 1))
    for n in op.output("Out"):
        set_out_var(block, n, list(xs[:ncol]) + [ws[-1]],
                    in_dtype(block, op, "Input"))


@register_op("fc", infer=_fc_infer)
def fc(ctx, ins, attrs):
    """The fused fc of fc_fuse_pass (fc_op.cc analog): flatten Input at
    in_num_col_dims, one GEMM under the same AMP cast as ``mul``, plus the
    bias. Like the JAX package's op it reads no ``activation_type``: the
    pass never sets one, and the activation stays a separate op."""
    xv, wv = ins["Input"][0], ins["W"][0]
    ncol = int(attrs.get("in_num_col_dims", 1))
    x2 = xv.reshape(int(np.prod(xv.shape[:ncol])), -1)
    x2, w2 = amp_cast(ctx, x2, wv)
    out = torch.matmul(x2, w2)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": [out.reshape(tuple(xv.shape[:ncol]) + tuple(wv.shape[-1:]))]}
