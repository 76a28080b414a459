"""Fused ops the IR passes write (counterpart of
``paddle_tpu/ops/kernels_fused.py``; reference operators/fused/):
``fused_elemwise_activation`` (fuse_elewise_add_act) and
``fusion_repeated_fc_relu`` (repeated_fc_relu_fuse_pass). Each composes
the torch ops of the ops it replaces; the conv, RNN and sequence fusions
wait for ROADMAP A5 and A11.

``fused_elemwise_activation`` has no grad emitter of its own: its grad op
runs the generic vjp, which re-runs the forward under ``torch.func.vjp``
as every generic grad op does (ROADMAP A1)."""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import register_op
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
