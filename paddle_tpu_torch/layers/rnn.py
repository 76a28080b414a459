"""Recurrent layers (reference layers/nn.py ``dynamic_lstm`` and
``dynamic_gru``) over the padded convention: [B, T, D] plus an optional
``length`` [B]."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_gru"]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 length=None):
    """LSTM over a pre-projected input [B, T, 4H]; returns (hidden, cell),
    each [B, T, H]. ``size`` is 4H, as in the reference; the bias is [7H]
    with peepholes, else [4H]."""
    helper = LayerHelper("lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hdim = size // 4
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[hdim, 4 * hdim], dtype=dtype)
    bias_size = [7 * hdim] if use_peepholes else [4 * hdim]
    bias = helper.create_parameter(helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    batch_gate = helper.create_variable_for_type_inference(dtype, True)
    batch_cell_pre = helper.create_variable_for_type_inference(dtype, True)
    inputs = {"Input": input, "Weight": weight}
    if bias is not None:
        inputs["Bias"] = bias
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    if length is not None:
        inputs["Length"] = length
    helper.append_op(
        type="lstm", inputs=inputs,
        outputs={"Hidden": hidden, "Cell": cell, "BatchGate": batch_gate,
                 "BatchCellPreAct": batch_cell_pre},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


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
