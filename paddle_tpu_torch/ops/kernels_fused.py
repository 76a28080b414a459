"""Fused ops the IR passes write (counterpart of
``paddle_tpu/ops/kernels_fused.py``; reference operators/fused/):
``fused_elemwise_activation`` (fuse_elewise_add_act),
``fusion_repeated_fc_relu`` (repeated_fc_relu_fuse_pass),
``fusion_squared_mat_sub`` (squared_mat_sub_fuse_pass),
``fusion_transpose_flatten_concat`` (transpose_flatten_concat_fuse_pass),
``conv2d_fusion``
(the inference conv passes) and ``fused_conv2d`` (the pipeline's conv
stages). Each composes the torch ops, or the registered emitters, of the
ops it replaces; the RNN and sequence fusions wait for ROADMAP A11.

``fused_elemwise_activation`` and ``fused_conv2d`` have no grad emitter of
their own: their grad ops run the generic vjp, which re-runs the forward
under ``torch.func.vjp`` as every generic grad op does (ROADMAP A1)."""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import lookup, register_op
from .common import fluid_broadcast, in_dtype, in_shape, set_out_var


def _fused_elemwise_infer(op: OpDesc, block):
    """Out is the full-rank X side; IntermediateOut depends on the functor
    order (see the emitter): BinaryCompound ([elementwise_*, act])
    computes it as act(Y), Y's shape, UnaryCompound ([act,
    elementwise_*]) as binary(X, Y), X's."""
    funcs = list(op.attrs.get("functor_list", ()) or ())
    mid_src = ("Y" if funcs and str(funcs[0]).startswith("elementwise")
               else "X")
    for out_slot, in_slot in (("Out", "X"), ("IntermediateOut", mid_src)):
        for name in op.output(out_slot):
            set_out_var(block, name, in_shape(block, op, in_slot),
                        in_dtype(block, op, in_slot))


_BINARY = {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
           "elementwise_mul": torch.mul}


@register_op("fused_elemwise_activation", infer=_fused_elemwise_infer)
def fused_elemwise_activation(ctx, ins, attrs):
    """fused_elemwise_activation_op.cc via math/compound_functors.h:
    functor_list [binary, unary] is the BinaryCompound out = binary(x,
    unary(y)), intermediate = unary(y); [unary, binary] is the
    UnaryCompound out = unary(binary(x, y)), intermediate = binary(x, y).
    Under AMP the operands promote as the unfused elementwise ops do (a
    bf16 activation meeting an fp32 operand computes in fp32)."""
    xv, yv = ins["X"][0], ins["Y"][0]
    funcs = list(attrs.get("functor_list", []))
    axis = attrs.get("axis", -1)
    scale = attrs.get("scale", 1.0)

    def apply_binary(name, a, b):
        a, b = fluid_broadcast(a, b, axis)
        return _BINARY[name](a, b)

    def apply_unary(name, a):
        if name == "scale":
            return a * scale
        return {"relu": torch.relu, "tanh": torch.tanh,
                "sigmoid": torch.sigmoid}[name](a)

    if funcs and funcs[0].startswith("elementwise"):
        mid = apply_unary(funcs[1], yv)
        out = apply_binary(funcs[0], xv, mid)
    else:
        mid = apply_binary(funcs[1], xv, yv)
        out = apply_unary(funcs[0], mid)
    return {"Out": [out], "IntermediateOut": [mid]}


def _dtype_only_infer(op: OpDesc, block):
    for name in op.output("Out"):
        set_out_var(block, name, None, in_dtype(block, op, "X"))


@register_op("fusion_repeated_fc_relu", no_grad=True, infer=_dtype_only_infer)
def fusion_repeated_fc_relu(ctx, ins, attrs):
    """fusion_repeated_fc_relu_op.cc: a chain of fc + relu in one op."""
    h = ins["X"][0]
    for w, b in zip(ins["W"], ins.get("Bias") or [None] * len(ins["W"])):
        h = torch.matmul(h, w)
        if b is not None:
            h = h + b
        h = torch.relu(h)
    return {"Out": [h]}


@register_op("fusion_squared_mat_sub", no_grad=True,
             infer=_dtype_only_infer)
def fusion_squared_mat_sub(ctx, ins, attrs):
    """fused/fusion_squared_mat_sub_op.cc: ((xy)^2 - x^2 y^2) * scalar,
    the FM second-order trick as one op, in the JAX op's order of
    operations."""
    xv, yv = ins["X"][0], ins["Y"][0]
    s = float(attrs.get("scalar", 1.0))
    xy = torch.matmul(xv, yv)
    x2y2 = torch.matmul(xv * xv, yv * yv)
    return {"Out": [(xy * xy - x2y2) * s],
            "SquaredX": [xv * xv], "SquaredY": [yv * yv],
            "SquaredXY": [xy * xy]}


@register_op("fusion_transpose_flatten_concat", no_grad=True)
def fusion_transpose_flatten_concat(ctx, ins, attrs):
    """N x (transpose -> flatten at ``flatten_axis``) + concat
    (fused/fusion_transpose_flatten_concat_op.cc)."""
    trans_axis = list(attrs["trans_axis"])
    flatten_axis = int(attrs.get("flatten_axis", 1))
    outs = []
    for xv in ins["X"]:
        t = xv.permute(*trans_axis)
        lead = 1
        for d in t.shape[:flatten_axis]:
            lead *= d
        outs.append(t.reshape(lead, -1))
    return {"Out": [torch.cat(outs, dim=int(attrs.get("concat_axis", 1)))]}


_CONV_ACTS = {
    "relu": torch.relu,
    "sigmoid": lambda v: 1.0 / (1.0 + torch.exp(-v)),
    "tanh": torch.tanh,
    "identity": lambda v: v,
    "": lambda v: v,
}


def _conv_like_infer(op: OpDesc, block):
    """Output as the conv the op wraps (``conv_type``, conv2d by
    default) would give it."""
    conv_type = op.attrs.get("conv_type", "conv2d")
    lookup(conv_type).infer_shape(
        OpDesc(conv_type, {"Input": op.input("Input"),
                           "Filter": op.input("Filter")},
               {"Output": op.output("Output")}, dict(op.attrs)), block)


@register_op("conv2d_fusion", no_grad=True, infer=_conv_like_infer)
def conv2d_fusion(ctx, ins, attrs):
    """fused/conv_fusion_op.cc, the product of the inference conv passes:
    the conv, a per-channel bias, an optional residual (ResidualData) and
    the activation (``activation``, relu by default), the bias and the
    residual cast to the conv output's dtype."""
    out = lookup("conv2d").emitter(
        ctx, {"Input": ins["Input"], "Filter": ins["Filter"]},
        attrs)["Output"][0]
    bias = ins.get("Bias", [None])[0]
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * (out.dim() - 2)).to(
            out.dtype)
    residual = ins.get("ResidualData", [None])[0]
    if residual is not None:
        out = out + residual.to(out.dtype)
    return {"Output": [_CONV_ACTS[attrs.get("activation", "relu")](out)]}


@register_op("fused_conv2d", infer=_conv_like_infer)
def fused_conv2d(ctx, ins, attrs):
    """The op of the pipeline's conv stages (fuse_conv_epilogue_ops,
    fuse_conv_bn_ops): the conv [+ per-channel bias] [+ inference
    batch_norm on live statistics] [+ activation], each step the
    registered emitter of the op it replaces, so values and generic-vjp
    gradients are the unfused program's."""
    fmt = attrs.get("data_format", "NCHW")
    out = lookup(attrs.get("conv_type", "conv2d")).emitter(
        ctx, {"Input": ins["Input"], "Filter": ins["Filter"]},
        attrs)["Output"][0]
    bias = ins.get("Bias", [None])[0]
    if bias is not None:
        # the standalone bias add's broadcast: the channel axis, 1 in
        # NCHW and the last in NHWC (as the layout pass remaps it)
        out = lookup("elementwise_add").emitter(
            ctx, {"X": [out], "Y": [bias]},
            {"axis": 1 if fmt == "NCHW" else -1})["Out"][0]
    if attrs.get("with_bn"):
        out = lookup("batch_norm").emitter(
            ctx, {"X": [out], "Scale": ins["Scale"], "Bias": ins["BNBias"],
                  "Mean": ins["Mean"], "Variance": ins["Variance"]},
            {"epsilon": attrs.get("epsilon", 1e-5), "data_layout": fmt,
             "is_test": True})["Y"][0]
    act = attrs.get("activation", "identity")
    if act not in ("", "identity"):
        out = lookup(act).emitter(ctx, {"X": [out]}, {})["Out"][0]
    return {"Output": [out]}
