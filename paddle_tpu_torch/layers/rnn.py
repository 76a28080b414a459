"""Recurrent layers (reference layers/nn.py ``dynamic_gru``) over the
padded convention: [B, T, D] plus an optional ``length`` [B]."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["dynamic_gru"]


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32",
                name=None, length=None):
    """GRU over a pre-projected input [B, T, 3H]; returns the hidden
    states [B, T, H]. ``size`` is H."""
    helper = LayerHelper("gru", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr, shape=[3 * size],
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    z1 = helper.create_variable_for_type_inference(dtype, True)
    z2 = helper.create_variable_for_type_inference(dtype, True)
    z3 = helper.create_variable_for_type_inference(dtype, True)
    inputs = {"Input": input, "Weight": weight}
    if bias is not None:
        inputs["Bias"] = bias
    if h_0 is not None:
        inputs["H0"] = h_0
    if length is not None:
        inputs["Length"] = length
    helper.append_op(
        type="gru", inputs=inputs,
        outputs={"Hidden": hidden, "BatchGate": z1,
                 "BatchResetHiddenPrev": z2, "BatchHidden": z3},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden
