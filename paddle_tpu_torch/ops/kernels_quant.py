"""Quantization ops (counterpart of ``paddle_tpu/ops/kernels_quant.py``;
reference operators/fake_quantize_op.cc, fake_dequantize_op.cc and the
mkldnn quantize_op.cc / dequantize_op.cc).

Each ``fake_quantize_*`` op emits the dequantized simulation of its input
(quantize, round, dequantize in one op), as the JAX package's does; the
int8 split happens only at freeze time (``contrib/quantize.py``). The
stateful two keep their scale in the persistable both ``InScale`` and
``OutScale`` name, so the executor writes it back in place and a captured
graph updates it on the device with no host read. Rounding is half to
even, as ``jnp.round``'s, and every division by a literal is a true
division (``true_div``). Gradients are straight-through: the grad maker
writes ``assign_grad_through``, which passes ``Out@GRAD`` to ``X@GRAD``.
"""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import register_grad_maker, register_op
from .common import in_dtype, in_shape, set_out_var, slots_like_infer, true_div


def _quant_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if xs is not None:
        set_out_var(block, op.output("Out")[0], xs, dt)
    if op.output("OutScale"):
        set_out_var(block, op.output("OutScale")[0], [1], dt)


def _sim_quant(xv, scale, bits):
    """round(clip(x / scale, -1, 1) * qmax) * scale / qmax, the scale
    floored at 1e-8."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(scale, min=1e-8)
    q = torch.round(torch.clamp(xv / scale, -1.0, 1.0) * qmax)
    return true_div(q * scale, qmax)


@register_op("fake_quantize_abs_max", infer=_quant_infer,
             intermediate_outputs=("OutScale",))
def fake_quantize_abs_max(ctx, ins, attrs):
    """The scale is the input's largest magnitude, this run's."""
    xv = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    scale = xv.abs().max()
    return {"Out": [_sim_quant(xv, scale, bits)],
            "OutScale": [scale.reshape(1)]}


@register_op("fake_quantize_range_abs_max", infer=_quant_infer,
             intermediate_outputs=("OutScale",))
@register_op("fake_quantize_moving_average_abs_max", infer=_quant_infer,
             intermediate_outputs=("OutScale",))
def fake_quantize_stateful(ctx, ins, attrs):
    """The scale is the state ``InScale``: in training it moves to
    ``rate * state + (1 - rate) * max|x|``, or takes ``max|x|`` while the
    state is 0 (the first step); in test mode it stays."""
    xv = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    state = ins["InScale"][0].reshape(())
    if attrs.get("is_test") or ctx.is_test:
        new_state = state
    else:
        rate = float(attrs.get("moving_rate", 0.9))
        cur = xv.abs().max()
        new_state = torch.where(state > 0, rate * state + (1 - rate) * cur,
                                cur)
    return {"Out": [_sim_quant(xv, new_state, bits)],
            "OutScale": [new_state.reshape(1)]}


@register_op("fake_dequantize_max_abs", infer=_quant_infer)
def fake_dequantize_max_abs(ctx, ins, attrs):
    xv = ins["X"][0]
    scale = ins["Scale"][0].reshape(())
    qmax = float(attrs.get("max_range", 127.0))
    return {"Out": [true_div(xv.to(scale.dtype) * scale, qmax)]}


def _dequant_w_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is not None:
        set_out_var(block, op.output("Out")[0], xs,
                    in_dtype(block, op, "Scale"))


@register_op("dequantize_weights", infer=_dequant_w_infer, no_grad=True)
def dequantize_weights(ctx, ins, attrs):
    """int8 weights to float at graph entry (what ``freeze_program``
    writes)."""
    w8 = ins["X"][0]
    scale = ins["Scale"][0].reshape(())
    qmax = float(attrs.get("max_range", 127.0))
    return {"Out": [true_div(w8.to(scale.dtype) * scale, qmax)]}


def _ste_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    """Straight-through estimator: d(out)/d(x) = 1."""
    xn = op.input("X")[0]
    if xn in no_grad_set:
        return [], {}
    g = OpDesc("assign_grad_through",
               {"Out@GRAD": [op.output("Out")[0] + "@GRAD"]},
               {"X@GRAD": [xn + "@GRAD"]}, {})
    return [g], {xn + "@GRAD": xn}


@register_op("assign_grad_through", no_grad=True,
             infer=slots_like_infer(("X@GRAD", "Out@GRAD")))
def assign_grad_through(ctx, ins, attrs):
    return {"X@GRAD": [ins["Out@GRAD"][0]]}


for _t in ("fake_quantize_abs_max", "fake_quantize_range_abs_max",
           "fake_quantize_moving_average_abs_max"):
    register_grad_maker(_t)(_ste_grad_maker)


def _quantize_infer(op, block):
    xs = in_shape(block, op, "Input")
    if xs is not None:
        for n in op.output("Output"):
            set_out_var(block, n, xs, "int8")


def _dequantize_infer(op, block):
    xs = in_shape(block, op, "Input")
    if xs is not None:
        for n in op.output("Output"):
            set_out_var(block, n, xs, "float32")


@register_op("quantize", no_grad=True, infer=_quantize_infer)
def quantize(ctx, ins, attrs):
    """float32 to int8 with a given scale: clip(round(x * Scale))."""
    xv = ins["Input"][0]
    scale = float(attrs.get("Scale", 1.0))
    out = torch.clamp(torch.round(xv * scale), -128, 127).to(torch.int8)
    return {"Output": [out]}


@register_op("dequantize", no_grad=True, infer=_dequantize_infer)
def dequantize(ctx, ins, attrs):
    """int8 to float32 by 1 / Scale."""
    xv = ins["Input"][0]
    scale = float(attrs.get("Scale", 1.0))
    return {"Output": [true_div(xv.to(torch.float32), scale)]}
