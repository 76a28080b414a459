"""NN ops (counterpart of ``paddle_tpu/ops/kernels_nn.py``): conv2d and
depthwise_conv2d with their grads, conv2d_transpose and its depthwise
form, conv3d and conv3d_transpose, pool2d, pool3d and
max_pool3d_with_index, batch_norm, layer_norm, group_norm,
softmax_with_cross_entropy with its grad, cross_entropy,
square_error_cost, huber_loss, maxout, prelu, hash, accuracy,
precision_recall, the streaming ``auc``, dropout with its grad,
uniform_random_batch_size_like, and the ``fc`` op that fc_fuse_pass
writes.

Convolutions go to ``torch.nn.functional.conv2d`` and its transposed and
3-D forms (cuDNN on the card), as the JAX package left them to
``lax.conv_general_dilated``. A tensor the
program calls NHWC is handed to the library as ``x.permute(0, 3, 1, 2)``,
a channels-last view of the same memory, and the result comes back the
same way; the filter stays OIHW in either layout, so checkpoints do not
depend on it. Pooling and batch_norm are the JAX package's arithmetic in
torch ops, not the library's (see each emitter)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.desc import OpDesc
from ..core.types import GRAD_SUFFIX, DataType
from ..registry import register_grad_maker, register_op
from .common import (ZERO, amp_cast, batch_size_like_infer,
                     batch_size_like_shape, in_dtype, in_shape, opt,
                     same_shape_infer, set_out_var, slots_like_infer, x)


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

def _conv_out_dim(i, k, p, s, d):
    return (i + 2 * p - ((k - 1) * d + 1)) // s + 1


def _conv2d_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Input")
    ws = in_shape(block, op, "Filter")
    if xs is None or ws is None:
        return
    s = op.attrs.get("strides", [1, 1])
    p = op.attrs.get("paddings", [0, 0])
    d = op.attrs.get("dilations", [1, 1])
    nhwc = op.attrs.get("data_format", "NCHW") == "NHWC"
    ih, iw = (xs[1], xs[2]) if nhwc else (xs[2], xs[3])
    oh = _conv_out_dim(ih, ws[2], p[0], s[0], d[0])
    ow = _conv_out_dim(iw, ws[3], p[1], s[1], d[1])
    shape = [xs[0], oh, ow, ws[0]] if nhwc else [xs[0], ws[0], oh, ow]
    for n in op.output("Output"):
        set_out_var(block, n, shape, in_dtype(block, op, "Input"))


def _nchw(t, nhwc):
    """The NCHW view of a tensor the program holds as NHWC (no copy)."""
    return t.permute(0, 3, 1, 2) if nhwc else t


def _from_nchw(t, nhwc):
    return t.permute(0, 2, 3, 1) if nhwc else t


def _conv_geometry(attrs):
    return (list(attrs.get("strides", [1, 1])),
            list(attrs.get("paddings", [0, 0])),
            list(attrs.get("dilations", [1, 1])),
            attrs.get("groups", 1) or 1)


def _conv_operands(ctx, ins, attrs):
    """(input, filter) as the product sees them: the fused ReLU of
    fuse_relu_depthwise_conv_pass applied, bf16 under AMP, the input as
    an NCHW view."""
    xv, wv = ins["Input"][0], ins["Filter"][0]
    if attrs.get("fuse_relu_before_depthwise_conv"):
        xv = torch.maximum(xv, ZERO)  # the relu op's, ties included
    xv, wv = amp_cast(ctx, xv, wv)
    return _nchw(xv, attrs.get("data_format", "NCHW") == "NHWC"), wv


@register_op("conv2d", infer=_conv2d_infer)
@register_op("depthwise_conv2d", infer=_conv2d_infer)
def conv2d(ctx, ins, attrs):
    """conv_op.cc: strides, paddings, dilations and groups, NCHW or NHWC
    data with an OIHW filter; under AMP bf16 inputs and a bf16 output."""
    xv, wv = _conv_operands(ctx, ins, attrs)
    s, p, d, groups = _conv_geometry(attrs)
    out = F.conv2d(xv, wv, None, s, p, d, groups)
    return {"Output": [_from_nchw(out,
                                  attrs.get("data_format", "NCHW") == "NHWC")]}


def conv2d_grad(ctx, ins, attrs):
    """The grad op the JAX grad maker writes for conv2d (type, slots and
    attrs unchanged), on ``aten.convolution_backward``: the input and
    filter gradients from the saved operands, without running the
    forward convolution again as the generic vjp would. Both gradients
    are computed, as the vjp computes them; the executor binds those the
    op's outputs name. Each comes back in its input's dtype, as the vjp
    gives it."""
    xv, wv = ins["Input"][0], ins["Filter"][0]
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    xc, wc = _conv_operands(ctx, ins, attrs)
    s, p, d, groups = _conv_geometry(attrs)
    og = ins.get("Output@GRAD")
    og = og[0] if og and og[0] is not None else None
    if og is None:
        return {"Input@GRAD": [torch.zeros_like(xv)],
                "Filter@GRAD": [torch.zeros_like(wv)]}
    gx, gw, _ = torch.ops.aten.convolution_backward(
        _nchw(og.to(xc.dtype), nhwc), xc, wc, None, s, p, d, False,
        [0, 0], groups, [True, True, False])
    gx = _from_nchw(gx, nhwc)
    if attrs.get("fuse_relu_before_depthwise_conv"):
        # max(x, 0)'s gradient: 1 above 0, half at a tie
        gx = gx * ((xv > 0).to(gx.dtype) + 0.5 * (xv == 0).to(gx.dtype))
    return {"Input@GRAD": [gx.to(xv.dtype)], "Filter@GRAD": [gw.to(wv.dtype)]}


register_op("conv2d_grad", no_grad=True)(conv2d_grad)
register_op("depthwise_conv2d_grad", no_grad=True)(conv2d_grad)


def _conv2d_transpose_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Input")
    ws = in_shape(block, op, "Filter")
    if xs is None or ws is None:
        return
    s = op.attrs.get("strides", [1, 1])
    p = op.attrs.get("paddings", [0, 0])
    d = op.attrs.get("dilations", [1, 1])
    groups = op.attrs.get("groups", 1) or 1
    oh = (xs[2] - 1) * s[0] - 2 * p[0] + (ws[2] - 1) * d[0] + 1
    ow = (xs[3] - 1) * s[1] - 2 * p[1] + (ws[3] - 1) * d[1] + 1
    for n in op.output("Output"):
        set_out_var(block, n, [xs[0], ws[1] * groups, oh, ow],
                    in_dtype(block, op, "Input"))


def _transpose_operands(ins):
    """(input, filter) of a transposed convolution in their common dtype.
    The JAX op has no AMP cast point, so a bf16 activation meets a float32
    filter under AMP: ``lax.conv_general_dilated`` refuses operands of two
    dtypes, and the port promotes both to float32, so the product runs in
    float32 as the op's missing cast point implies."""
    xv, wv = ins["Input"][0], ins["Filter"][0]
    dt = torch.promote_types(xv.dtype, wv.dtype)
    return xv.to(dt), wv.to(dt)


@register_op("conv2d_transpose", infer=_conv2d_transpose_infer)
def conv2d_transpose(ctx, ins, attrs):
    """conv_transpose_op.cc: the gradient of a convolution as an op, NCHW
    with the IOHW filter [C_in, C_out / groups, kh, kw]; H_out = (H - 1) s
    - 2 p + (kh - 1) d + 1. The JAX op dilates the input by the stride and
    convolves it with the flipped, I/O-swapped filter padded by d (k - 1)
    - p; ``F.conv_transpose2d`` is the same product. Its gradient is the
    generic vjp, which runs the forward once more."""
    xv, wv = _transpose_operands(ins)
    s, p, d, groups = _conv_geometry(attrs)
    return {"Output": [F.conv_transpose2d(xv, wv, None, s, p, 0, groups, d)]}


@register_op("depthwise_conv2d_transpose", infer=_conv2d_transpose_infer)
def depthwise_conv2d_transpose(ctx, ins, attrs):
    """conv2d_transpose with one group per input channel."""
    return conv2d_transpose(ctx, ins,
                            dict(attrs, groups=ins["Input"][0].shape[1]))


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _pool2d_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if xs is None:
        return
    nhwc = op.attrs.get("data_format", "NCHW") == "NHWC"
    ih, iw, ch = ((xs[1], xs[2], xs[3]) if nhwc
                  else (xs[2], xs[3], xs[1]))

    def out_shape(oh, ow):
        return [xs[0], oh, ow, ch] if nhwc else [xs[0], ch, oh, ow]

    k = op.attrs.get("ksize", [1, 1])
    if op.attrs.get("global_pooling", False):
        shape = out_shape(1, 1)
    elif op.attrs.get("adaptive", False):
        shape = out_shape(k[0], k[1])
    else:
        s = op.attrs.get("strides", [1, 1])
        p = op.attrs.get("paddings", [0, 0])
        c = (s[0] - 1, s[1] - 1) if op.attrs.get("ceil_mode", False) \
            else (0, 0)
        shape = out_shape((ih + 2 * p[0] - k[0] + c[0]) // s[0] + 1,
                          (iw + 2 * p[1] - k[1] + c[1]) // s[1] + 1)
    for n in op.output("Out"):
        set_out_var(block, n, shape, dt)


def _adaptive_pool(xv, out_size, ptype):
    """Variable-size bins over the last len(out_size) dims: bin i of a dim
    of size D spans [floor(i*D/o), ceil((i+1)*D/o)). The max of a bin is
    ``amax``, which splits the gradient evenly among tied maxima, as
    ``jnp.max`` does."""
    cur = xv
    lead = xv.dim() - len(out_size)
    for axis, o in enumerate(out_size, lead):
        o = int(o)
        size = cur.shape[axis]
        slabs = []
        for i in range(o):
            sl = cur.narrow(axis, (i * size) // o,
                            -(-(i + 1) * size // o) - (i * size) // o)
            slabs.append(sl.amax(dim=axis, keepdim=True) if ptype == "max"
                         else sl.mean(dim=axis, keepdim=True))
        cur = torch.cat(slabs, dim=axis)
    return cur


def _window_pads(shape, k, s, p, ceil_mode):
    """(top, bottom, left, right) padding of the JAX op's reduce_window:
    ``paddings`` on both sides, and under ceil_mode the extra high-side
    rows and columns that make the floor formula give the ceil one."""
    pads = []
    for i, n in enumerate(shape):
        extra = 0
        if ceil_mode:
            o = (n + 2 * p[i] - k[i] + s[i] - 1) // s[i] + 1
            extra = max(0, (o - 1) * s[i] + k[i] - (n + 2 * p[i]))
        pads.append((p[i], p[i] + extra))
    return pads


@register_op("pool2d", infer=_pool2d_infer)
def pool2d(ctx, ins, attrs):
    """pool_op.cc with the JAX op's windows: max pooling pads with -inf;
    ``ceil_mode`` adds high-side padding and keeps every window (the
    library's ceil mode drops windows that start in the padding, and
    caps the padding at half the kernel); exclusive average pooling
    divides each window's sum by its count of unpadded elements, the
    other kind by the kernel's size. The padded cases pad explicitly and
    pool without padding; the others call the library's pooling."""
    xv = x(ins)
    ptype = attrs.get("pooling_type", "max")
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if attrs.get("global_pooling", False):
        sp = (1, 2) if nhwc else (2, 3)
        if ptype == "max":
            return {"Out": [xv.amax(dim=sp, keepdim=True)]}
        return {"Out": [xv.mean(dim=sp, keepdim=True)]}
    xn = _nchw(xv, nhwc)
    k = list(attrs.get("ksize", [1, 1]))
    if attrs.get("adaptive", False):
        return {"Out": [_from_nchw(_adaptive_pool(xn, k, ptype), nhwc)]}
    s = list(attrs.get("strides", [1, 1]))
    p = list(attrs.get("paddings", [0, 0]))
    (pt, pb), (pl, pr) = _window_pads(xn.shape[2:], k, s, p,
                                      attrs.get("ceil_mode", False))
    if ptype == "max":
        if pb == pt and pr == pl and 2 * pt <= k[0] and 2 * pl <= k[1]:
            # symmetric padding within the library's cap: its implicit
            # padding is -inf too
            out = F.max_pool2d(xn, k, s, [pt, pl])
        else:
            out = F.max_pool2d(F.pad(xn, (pl, pr, pt, pb),
                                     value=float("-inf")), k, s)
        return {"Out": [_from_nchw(out, nhwc)]}
    if (pt, pb, pl, pr) == (0, 0, 0, 0):
        return {"Out": [_from_nchw(F.avg_pool2d(xn, k, s), nhwc)]}
    ssum = F.avg_pool2d(F.pad(xn, (pl, pr, pt, pb)), k, s,
                        divisor_override=1)
    if attrs.get("exclusive", True):
        ones = F.pad(xn.new_ones((1, 1) + tuple(xn.shape[2:])),
                     (pl, pr, pt, pb))
        out = ssum / F.avg_pool2d(ones, k, s, divisor_override=1)
    else:
        out = ssum / (k[0] * k[1])
    return {"Out": [_from_nchw(out, nhwc)]}


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def _bn_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is None:
        return
    c = xs[1] if op.attrs.get("data_layout", "NCHW") == "NCHW" else xs[-1]
    for n in op.output("Y"):
        set_out_var(block, n, xs, in_dtype(block, op, "X"))
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        for n in op.output(slot):
            set_out_var(block, n, [c], DataType.FP32)


@register_op("batch_norm",
             intermediate_outputs=("MeanOut", "VarianceOut", "SavedMean",
                                   "SavedVariance"),
             infer=_bn_infer)
def batch_norm(ctx, ins, attrs):
    """batch_norm_op.cc with the JAX op's arithmetic, in fp32 whatever
    the input's dtype: in training the batch variance is E[x^2] - E[x]^2
    and the running variance takes it biased (the library's batch norm
    uses Welford and the unbiased estimate); under is_test or
    use_global_stats the running statistics normalize and pass through.
    MeanOut and VarianceOut rebind the running statistics' names (the
    executor's sequential binding is the in-place update); SavedVariance
    holds the inverse standard deviation. Y comes back in X's dtype
    (bf16 under AMP)."""
    xv = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    rmean, rvar = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    nchw = attrs.get("data_layout", "NCHW") == "NCHW" and xv.dim() == 4
    c_axis = 1 if nchw else xv.dim() - 1
    axes = tuple(i for i in range(xv.dim()) if i != c_axis)
    ch_shape = [1] * xv.dim()
    ch_shape[c_axis] = xv.shape[c_axis]
    xf = xv.float()
    if (attrs.get("is_test", False) or ctx.is_test
            or attrs.get("use_global_stats", False)):
        mean, var = rmean.float(), rvar.float()
        mean_out, var_out = rmean, rvar
    else:
        mean = xf.mean(dim=axes)
        var = (xf * xf).mean(dim=axes) - mean * mean
        mean_out = momentum * rmean + (1 - momentum) * mean
        var_out = momentum * rvar + (1 - momentum) * var
    inv_std = torch.rsqrt(var + eps)
    y = ((xf - mean.reshape(ch_shape))
         * (inv_std * scale.float()).reshape(ch_shape)
         + bias.float().reshape(ch_shape)).to(xv.dtype)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [mean], "SavedVariance": [inv_std]}


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


def _ce_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is not None:
        for n in op.output("Y"):
            set_out_var(block, n, xs[:-1] + [1], in_dtype(block, op, "X"))


@register_op("cross_entropy", infer=_ce_infer)
def cross_entropy(ctx, ins, attrs):
    """cross_entropy_op.cc on probabilities (a softmax's output): hard
    labels (int32 or int64, with or without the trailing [, 1]) give
    -log(X[label]), 0 at ignore_index; soft labels -sum(label * log X).
    X is clipped to [1e-12, 1] before the log."""
    xv = ins["X"][0]
    label = ins["Label"][0]
    logx = torch.log(torch.clamp(xv, 1e-12, 1.0))
    if attrs.get("soft_label", False):
        return {"Y": [-(label * logx).sum(dim=-1, keepdim=True)]}
    lab = _hard_label(label, xv)
    y = -logx.gather(-1, _in_range(lab, xv).unsqueeze(-1))
    y = y.masked_fill((lab == attrs.get("ignore_index", -100)).unsqueeze(-1),
                      0.0)
    return {"Y": [y]}


@register_op("square_error_cost", infer=same_shape_infer())
def square_error_cost(ctx, ins, attrs):
    d = ins["X"][0] - ins["Y"][0]
    return {"Out": [d * d]}


def _smooth_l1_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if xs:
        for n in op.output("Diff"):
            set_out_var(block, n, xs, dt)
        for n in op.output("Out"):
            set_out_var(block, n, [xs[0], 1], dt)


@register_op("smooth_l1_loss", intermediate_outputs=("Diff",),
             infer=_smooth_l1_infer)
def smooth_l1_loss(ctx, ins, attrs):
    """smooth_l1_loss_op.h: d = (X - Y) * InsideWeight, 0.5 (sigma d)^2
    where |d| < 1 / sigma^2, else |d| - 0.5 / sigma^2, times
    OutsideWeight, summed over each row: Out [N, 1]; Diff is d."""
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = ins["X"][0] - ins["Y"][0]
    inside = opt(ins, "InsideWeight")
    if inside is not None:
        d = d * inside
    a = torch.abs(d)
    loss = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    outside = opt(ins, "OutsideWeight")
    if outside is not None:
        loss = loss * outside
    return {"Out": [loss.reshape(loss.shape[0], -1).sum(dim=1, keepdim=True)],
            "Diff": [d]}


@register_op("sigmoid_cross_entropy_with_logits", infer=same_shape_infer())
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    """max(x, 0) - x * label + log(1 + exp(-|x|)) elementwise, zero where
    the label equals ``ignore_index``."""
    logits, label = ins["X"][0], ins["Label"][0]
    loss = (torch.maximum(logits, ZERO.to(logits.dtype)) - logits * label
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return {"Out": [torch.where(label == attrs.get("ignore_index", -100),
                                0.0, loss)]}


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def _dropout_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    for n in op.output("Out"):
        set_out_var(block, n, xs, dt)
    for n in op.output("Mask"):
        set_out_var(block, n, xs, DataType.UINT8)


def _dropout_apply(xv, mask, p, impl):
    """The kept values of ``xv`` under ``mask`` (X's dtype): scaled by
    1 / (1 - p) under upscale_in_train, zero at p = 1."""
    if impl == "upscale_in_train":
        return xv * mask / (1.0 - p) if p < 1.0 else torch.zeros_like(xv)
    return xv * mask


@register_op("dropout", intermediate_outputs=("Mask",), needs_rng=True,
             infer=_dropout_infer)
def dropout(ctx, ins, attrs):
    """dropout_op.cc with both implementations: downgrade_in_infer (the
    default) trains y = x * mask and infers y = x * (1 - p);
    upscale_in_train trains y = x * mask / (1 - p) and infers y = x. The
    keep mask is uniform < 1 - p over X's shape, drawn from the run's
    generator (the JAX package's ``bernoulli`` on its key stream; the
    streams differ, the rule does not). Mask is uint8; the grad reads it
    rather than drawing again."""
    xv = ins["X"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        y = xv if impl == "upscale_in_train" else xv * (1.0 - p)
        return {"Out": [y], "Mask": [torch.ones_like(xv, dtype=torch.uint8)]}
    keep = torch.rand(xv.shape, generator=ctx.generator, device=xv.device,
                      dtype=torch.float32) < (1.0 - p)
    return {"Out": [_dropout_apply(xv, keep.to(xv.dtype), p, impl)],
            "Mask": [keep.to(torch.uint8)]}


@register_grad_maker("dropout")
def _dropout_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    xn = op.input("X")[0]
    if xn in no_grad_set:
        return [], {}
    g = OpDesc("dropout_grad",
               {"Mask": op.output("Mask"),
                "Out" + GRAD_SUFFIX: [op.output("Out")[0] + GRAD_SUFFIX]},
               {"X" + GRAD_SUFFIX: [xn + GRAD_SUFFIX]}, dict(op.attrs))
    return [g], {xn + GRAD_SUFFIX: xn}


@register_op("dropout_grad", no_grad=True)
def dropout_grad(ctx, ins, attrs):
    og = ins["Out" + GRAD_SUFFIX][0]
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    return {"X" + GRAD_SUFFIX: [_dropout_apply(og, ins["Mask"][0].to(og.dtype),
                                               p, impl)]}


def _acc_infer(op: OpDesc, block):
    for slot, dt in (("Accuracy", DataType.FP32), ("Correct", DataType.INT32),
                     ("Total", DataType.INT32)):
        for n in op.output(slot):
            set_out_var(block, n, [1], dt)


@register_op("accuracy", no_grad=True, infer=_acc_infer)
def accuracy(ctx, ins, attrs):
    """metrics/accuracy_op.cc: the share of rows whose top-k Indices hold
    the label (int32 or int64)."""
    idx = ins["Indices"][0]
    label = ins["Label"][0]
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.reshape(-1)
    correct = (idx == label.unsqueeze(1)).any(dim=1).sum(dtype=torch.int32)
    acc = correct.float() / idx.shape[0]
    total = torch.full((1,), idx.shape[0], dtype=torch.int32,
                       device=idx.device)
    return {"Accuracy": [acc.reshape(1)], "Correct": [correct.reshape(1)],
            "Total": [total]}



def _auc_infer(op: OpDesc, block):
    for n in op.output("AUC"):
        set_out_var(block, n, [1], DataType.FP32)
    for out_slot, in_slot in (("StatPosOut", "StatPos"),
                              ("StatNegOut", "StatNeg")):
        for n in op.output(out_slot):
            set_out_var(block, n, in_shape(block, op, in_slot),
                        in_dtype(block, op, in_slot))


@register_op("auc", no_grad=True, infer=_auc_infer)
def auc(ctx, ins, attrs):
    """metrics/auc_op.cc: the streaming ROC AUC over stat buckets that
    persistable int64 vars hold (StatPosOut is StatPos, StatNegOut is
    StatNeg; the executor copies the new counts into them). A row's bucket
    is int32(p * num_thresholds), truncated toward zero and clipped to
    [0, num_thresholds]; the trapezoid integration runs in float64, as
    auc_op.h's does, and the AUC is cast to float32. The counts are exact
    integer index_adds, so any order of atomics gives the same bits."""
    preds = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_thresh = stat_pos.shape[0] - 1
    pos_score = (preds[:, 1] if preds.dim() == 2 and preds.shape[1] == 2
                 else preds.reshape(-1))
    bucket = torch.clamp((pos_score * num_thresh).to(torch.int32), 0,
                         num_thresh).long()
    is_pos = label > 0
    stat_pos = stat_pos.index_add(0, bucket, is_pos.to(stat_pos.dtype))
    stat_neg = stat_neg.index_add(0, bucket, (~is_pos).to(stat_neg.dtype))
    # integrate over descending thresholds
    tp = torch.cumsum(torch.flip(stat_pos, (0,)), 0)
    fp = torch.cumsum(torch.flip(stat_neg, (0,)), 0)
    zero = tp[:1] * 0
    tp0 = torch.cat([zero, tp[:-1]])
    fp0 = torch.cat([zero, fp[:-1]])
    area = torch.sum((fp - fp0).double() * (tp + tp0).double() / 2.0)
    denom = tp[-1].double() * fp[-1].double()
    auc_val = torch.where(denom > 0, area / (denom + 1e-12),
                          torch.zeros_like(area))
    return {"AUC": [auc_val.reshape(1).float()],
            "StatPosOut": [stat_pos], "StatNegOut": [stat_neg]}

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


# ---------------------------------------------------------------------------
# the losses, activations and norms of the image models
# ---------------------------------------------------------------------------

@register_op("huber_loss", intermediate_outputs=("Residual",),
             infer=slots_like_infer(("Out", "X"), ("Residual", "X")))
def huber_loss(ctx, ins, attrs):
    """huber_loss_op.h: r = Y - X, 0.5 r^2 where |r| <= delta, else
    delta (|r| - 0.5 delta); Residual is r."""
    delta = attrs.get("delta", 1.0)
    r = ins["Y"][0] - ins["X"][0]
    a = torch.abs(r)
    return {"Out": [torch.where(a <= delta, 0.5 * r * r,
                                delta * (a - 0.5 * delta))],
            "Residual": [r]}


def _maxout_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    g = int(op.attrs.get("groups", 1) or 1)
    if xs and len(xs) == 4 and g and xs[1] > 0 and xs[1] % g == 0:
        for n in op.output("Out"):
            set_out_var(block, n, [xs[0], xs[1] // g, xs[2], xs[3]],
                        in_dtype(block, op, "X"))


@register_op("maxout", infer=_maxout_infer)
def maxout(ctx, ins, attrs):
    """maxout_op.cc: NCHW, the channels split into C / groups runs of
    ``groups`` and the max of each run; ``amax`` splits the gradient
    evenly among tied maxima, as ``jnp.max`` does."""
    xv = x(ins)
    g = attrs["groups"]
    n, c, h, w = xv.shape
    return {"Out": [xv.reshape(n, c // g, g, h, w).amax(dim=2)]}


@register_op("prelu", infer=slots_like_infer(("Out", "X")))
def prelu(ctx, ins, attrs):
    """prelu_op.cc: x where x >= 0, else alpha x; alpha one scalar
    (``all``), one a channel (``channel``) or one an element
    (``element``)."""
    xv, alpha = ins["X"][0], ins["Alpha"][0]
    mode = attrs.get("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "element":
        a = alpha.reshape((1,) + tuple(xv.shape[1:]))
    else:
        a = alpha.reshape((1, -1) + (1,) * (xv.dim() - 2))
    return {"Out": [torch.where(xv >= 0, xv, a * xv)]}


_M32 = 0xFFFFFFFF
_HASH_MUL = 2654435761
_HASH_STEP = 0x9E3779B9


def _mul32(v, c):
    """(v * c) mod 2^32 for v in [0, 2^32) held in int64 and a constant
    c < 2^32: the product of v with c's two 16-bit halves, each below
    2^48, so nothing leaves int64's range."""
    lo = v * (c & 0xFFFF)
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


@register_op("hash", no_grad=True)
def hash_op(ctx, ins, attrs):
    """The JAX op's integer mix hash, in uint32 there: h = x * 2654435761
    + i * 0x9E3779B9, then h ^ (h >> 16), mod ``mod_by``, for i below
    ``num_hash`` (stacked on a new last dim when there are several). The
    32-bit arithmetic runs in int64 with masks, the shift on a value
    below 2^32 being a logical one."""
    xv = x(ins).long() & _M32
    mod = attrs.get("mod_by", 1)
    num_hash = attrs.get("num_hash", 1)
    outs = []
    for i in range(num_hash):
        h = (_mul32(xv, _HASH_MUL) + ((i * _HASH_STEP) & _M32)) & _M32
        h = h ^ (h >> 16)
        outs.append(h % mod)
    return {"Out": [torch.stack(outs, dim=-1) if num_hash > 1 else outs[0]]}


@register_op("uniform_random_batch_size_like", no_grad=True,
             needs_rng=True, infer=batch_size_like_infer)
def uniform_random_batch_size_like(ctx, ins, attrs):
    """float32 uniform in [min, max) of Input's batch, drawn from the run's
    generator (the JAX op ignores the dtype attr: float32 always)."""
    out = torch.empty(batch_size_like_shape(ins, attrs), dtype=torch.float32,
                      device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator)
    return {"Out": [out]}


def _group_norm_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    g = int(op.attrs.get("groups", 1) or 1)
    if not xs:
        return
    dt = in_dtype(block, op, "X")
    for n in op.output("Y"):
        set_out_var(block, n, xs, dt)
    for slot in ("Mean", "Variance"):
        for n in op.output(slot):
            set_out_var(block, n, [xs[0], g], dt)


@register_op("group_norm", intermediate_outputs=("Mean", "Variance"),
             infer=_group_norm_infer)
def group_norm(ctx, ins, attrs):
    """group_norm_op.cc: NCHW, each group of C / groups channels
    normalized by its own mean and biased variance (of the centred
    values, in X's dtype, as the JAX op computes them), then Scale and
    Bias per channel. Mean and Variance are [N, groups]."""
    xv = ins["X"][0]
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = xv.shape[0], xv.shape[1]
    xg = xv.reshape((n, g, c // g) + tuple(xv.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = (xg - mean).square().mean(dim=axes, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(xv.shape)
    ch = (1, c) + (1,) * (xv.dim() - 2)
    scale, bias = opt(ins, "Scale"), opt(ins, "Bias")
    if scale is not None:
        y = y * scale.reshape(ch)
    if bias is not None:
        y = y + bias.reshape(ch)
    return {"Y": [y], "Mean": [mean.reshape(n, g)],
            "Variance": [var.reshape(n, g)]}


@register_op("precision_recall", no_grad=True)
def precision_recall(ctx, ins, attrs):
    """metrics/precision_recall_op.cc: per class the TP, FP, TN and FN of
    the batch, each sample counted once at its weight, added to
    StatesInfo when given (AccumStatesInfo [C, 4]); macro precision,
    recall and F1, then micro ones, of the batch and of the accumulated
    states ([6] each). An id outside the classes counts for none."""
    cls = int(attrs["class_number"])
    idx = ins["Indices"][0].reshape(-1).long()
    lbl = ins["Labels"][0].reshape(-1).long()
    w = opt(ins, "Weights")
    w = (w.reshape(-1) if w is not None
         else torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    classes = torch.arange(cls, device=idx.device)
    pred_1h = (idx.unsqueeze(1) == classes).float()
    lab_1h = (lbl.unsqueeze(1) == classes).float()
    tp = (pred_1h * lab_1h * w.unsqueeze(1)).sum(dim=0)
    fp = (pred_1h * w.unsqueeze(1)).sum(dim=0) - tp
    fn = (lab_1h * w.unsqueeze(1)).sum(dim=0) - tp
    tn = w.sum() - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], dim=1)
    states = opt(ins, "StatesInfo")
    acc_states = (states.float() + batch_states if states is not None
                  else batch_states)

    def ratio(num, den, empty):
        return torch.where(den > 0, num / (den + 1e-12),
                           torch.full_like(num, empty))

    def metrics(st):
        tp_, fp_, fn_ = st[:, 0], st[:, 1], st[:, 3]
        p = ratio(tp_, tp_ + fp_, 1.0)
        r = ratio(tp_, tp_ + fn_, 1.0)
        f1 = ratio(2 * p * r, p + r, 0.0)
        stp, sfp, sfn = tp_.sum(), fp_.sum(), fn_.sum()
        mp = ratio(stp, stp + sfp, 1.0)
        mr = ratio(stp, stp + sfn, 1.0)
        mf = ratio(2 * mp * mr, mp + mr, 0.0)
        return torch.cat([torch.stack([p.mean(), r.mean(), f1.mean()]),
                          torch.stack([mp, mr, mf])])

    return {"BatchMetrics": [metrics(batch_states)],
            "AccumMetrics": [metrics(acc_states)],
            "AccumStatesInfo": [acc_states]}


# ---------------------------------------------------------------------------
# the 3-D convolution and pooling family (NCDHW)
# ---------------------------------------------------------------------------

def _conv3d_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Input")
    ws = in_shape(block, op, "Filter")
    if xs is None or ws is None:
        return
    s = op.attrs.get("strides", [1, 1, 1])
    p = op.attrs.get("paddings", [0, 0, 0])
    d = op.attrs.get("dilations", [1, 1, 1])
    dims = [_conv_out_dim(xs[2 + i], ws[2 + i], p[i], s[i], d[i])
            for i in range(3)]
    for n in op.output("Output"):
        set_out_var(block, n, [xs[0], ws[0], *dims],
                    in_dtype(block, op, "Input"))


def _geometry3d(attrs):
    return (list(attrs.get("strides", [1, 1, 1])),
            list(attrs.get("paddings", [0, 0, 0])),
            list(attrs.get("dilations", [1, 1, 1])),
            attrs.get("groups", 1) or 1)


@register_op("conv3d", infer=_conv3d_infer)
def conv3d(ctx, ins, attrs):
    """conv_op.cc Conv3D: NCDHW data, OIDHW filter; under AMP bf16 inputs
    and a bf16 output (the JAX op's cast point)."""
    xv, wv = amp_cast(ctx, ins["Input"][0], ins["Filter"][0])
    s, p, d, groups = _geometry3d(attrs)
    return {"Output": [F.conv3d(xv, wv, None, s, p, d, groups)]}


def _conv3d_transpose_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Input")
    ws = in_shape(block, op, "Filter")
    if xs is None or ws is None:
        return
    s = op.attrs.get("strides", [1, 1, 1])
    p = op.attrs.get("paddings", [0, 0, 0])
    d = op.attrs.get("dilations", [1, 1, 1])
    groups = op.attrs.get("groups", 1) or 1
    dims = [(xs[2 + i] - 1) * s[i] - 2 * p[i] + (ws[2 + i] - 1) * d[i] + 1
            for i in range(3)]
    for n in op.output("Output"):
        set_out_var(block, n, [xs[0], ws[1] * groups, *dims],
                    in_dtype(block, op, "Input"))


@register_op("conv3d_transpose", infer=_conv3d_transpose_infer)
def conv3d_transpose(ctx, ins, attrs):
    """conv_transpose_op.cc Conv3DTranspose: conv2d_transpose's product in
    three dims (IODHW filter); no AMP cast point, the operands promoted to
    their common dtype as in 2-D."""
    xv, wv = _transpose_operands(ins)
    s, p, d, groups = _geometry3d(attrs)
    return {"Output": [F.conv_transpose3d(xv, wv, None, s, p, 0, groups, d)]}


def _pool3d_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is None:
        return
    if op.attrs.get("global_pooling", False):
        dims = [1, 1, 1]
    elif op.attrs.get("adaptive", False):
        dims = list(op.attrs.get("ksize", [1, 1, 1]))
    else:
        k = op.attrs.get("ksize", [1, 1, 1])
        s = op.attrs.get("strides", [1, 1, 1])
        p = op.attrs.get("paddings", [0, 0, 0])
        ceil = op.attrs.get("ceil_mode", False)
        dims = [(xs[2 + i] + 2 * p[i] - k[i] + (s[i] - 1 if ceil else 0))
                // s[i] + 1 for i in range(3)]
    for n in op.output("Out"):
        set_out_var(block, n, [xs[0], xs[1], *dims], in_dtype(block, op, "X"))
    for n in op.output("Mask") or []:
        set_out_var(block, n, [xs[0], xs[1], *dims], "int32")


@register_op("pool3d", infer=_pool3d_infer)
def pool3d(ctx, ins, attrs):
    """pool_op.cc Pool3D with the JAX op's reduce_window: pool2d's rules
    in three dims (max pads with -inf and routes a window's gradient to
    its first maximum; ``ceil_mode`` adds the high-side padding that
    keeps every window; exclusive averaging divides by the unpadded
    count); global and adaptive pooling reduce with ``amax`` and
    ``mean``."""
    xv = x(ins)
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return {"Out": [xv.amax(dim=(2, 3, 4), keepdim=True)]}
        return {"Out": [xv.mean(dim=(2, 3, 4), keepdim=True)]}
    k = list(attrs.get("ksize", [1, 1, 1]))
    if attrs.get("adaptive", False):
        return {"Out": [_adaptive_pool(xv, k, ptype)]}
    s = list(attrs.get("strides", [1, 1, 1]))
    p = list(attrs.get("paddings", [0, 0, 0]))
    pads = _window_pads(xv.shape[2:], k, s, p, attrs.get("ceil_mode", False))
    # F.pad's order: the last dim first
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    if ptype == "max":
        return {"Out": [F.max_pool3d(F.pad(xv, flat, value=float("-inf")),
                                     k, s)]}
    ssum = F.avg_pool3d(F.pad(xv, flat), k, s, divisor_override=1)
    if attrs.get("exclusive", True):
        ones = F.pad(xv.new_ones((1, 1) + tuple(xv.shape[2:])), flat)
        return {"Out": [ssum / F.avg_pool3d(ones, k, s, divisor_override=1)]}
    return {"Out": [ssum / float(np.prod(k))]}


def window_max_with_index(xv, k, s, p):
    """Max pooling over the trailing len(k) dims with the flat index of
    each window's maximum in the unpadded input (the JAX ops' patches and
    argmax): the input padded with the dtype's lowest finite value, every
    window unfolded, ``amax`` over it (the gradient split evenly among
    tied maxima, as ``jnp.max`` splits it) and ``argmax`` (the first
    maximum in window order). Returns (max, int32 index)."""
    nd = len(k)
    sizes = xv.shape[-nd:]
    flat = [v for i in reversed(range(nd)) for v in (p[i], p[i])]
    xp = F.pad(xv, flat, value=float(torch.finfo(xv.dtype).min))
    lead = xv.dim() - nd
    for i in range(nd):
        xp = xp.unfold(lead + i, k[i], s[i])
    outs = xp.shape[lead:lead + nd]
    patches = xp.reshape(tuple(xv.shape[:lead]) + tuple(outs) + (-1,))
    out = patches.amax(dim=-1)
    arg = patches.argmax(dim=-1)
    index = torch.zeros_like(arg)
    rest = arg
    for i in range(nd):
        span = int(np.prod(k[i + 1:]))
        within = torch.div(rest, span, rounding_mode="floor")
        rest = rest - within * span
        start = torch.arange(outs[i], device=xv.device) * s[i] - p[i]
        pos = within + start.reshape((-1,) + (1,) * (nd - 1 - i))
        index = index * sizes[i] + pos
    return out, index.to(torch.int32)


@register_op("max_pool3d_with_index", intermediate_outputs=("Mask",),
             infer=_pool3d_infer)
def max_pool3d_with_index(ctx, ins, attrs):
    """pool_with_index_op.cc 3-D: max pooling and Mask, the int32 flat
    index (d * H + h) * W + w of each window's first maximum."""
    out, mask = window_max_with_index(
        x(ins), list(attrs.get("ksize", [1, 1, 1])),
        list(attrs.get("strides", [1, 1, 1])),
        list(attrs.get("paddings", [0, 0, 0])))
    return {"Out": [out], "Mask": [mask]}
