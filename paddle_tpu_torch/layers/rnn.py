"""Recurrent layers (reference layers/nn.py ``dynamic_lstm``,
``dynamic_gru``, ``lstm_unit``, ``gru_unit``, ``dynamic_lstmp`` and
``lstm``) over the padded convention: [B, T, D] plus an optional
``length`` [B]."""

from __future__ import annotations

from ..layer_helper import LayerHelper, ParamAttr

__all__ = ["dynamic_lstm", "dynamic_gru", "lstm_unit", "gru_unit",
           "dynamic_lstmp", "lstm"]


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


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM cell step: fc([x_t, h_prev]) to the 4D gates, then the
    ``lstm_unit`` op. Returns (hidden, cell)."""
    from . import nn
    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d = cell_t_prev.shape[-1]
    concat = nn.concat([x_t, hidden_t_prev], axis=1)
    gates = nn.fc(concat, size=4 * d, param_attr=param_attr,
                  bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": gates, "C_prev": cell_t_prev},
                     outputs={"C": c, "H": h},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU cell step over the x-projected ``input`` [B, 3D]; ``size``
    is 3D (the reference's contract). Returns (hidden,
    reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    d = size // 3
    w = helper.create_parameter(helper.param_attr, shape=[d, 3 * d],
                                dtype=input.dtype)
    bias = helper.create_parameter(helper.bias_attr, shape=[1, 3 * d],
                                   dtype=input.dtype, is_bias=True)
    hid = helper.create_variable_for_type_inference(input.dtype)
    gate = helper.create_variable_for_type_inference(input.dtype, True)
    rhp = helper.create_variable_for_type_inference(input.dtype, True)
    inputs = {"Input": input, "HiddenPrev": hidden, "Weight": w}
    if bias is not None:
        inputs["Bias"] = bias
    helper.append_op(type="gru_unit", inputs=inputs,
                     outputs={"Hidden": hid, "Gate": gate,
                              "ResetHiddenPrev": rhp},
                     attrs={"origin_mode": origin_mode})
    return hid, rhp, gate


def dynamic_lstmp(input, size, proj_size, param_attr=None,
                  bias_attr=None, use_peepholes=False, dtype="float32",
                  length=None, name=None):
    """An LSTM with a recurrent projection (``lstmp``) over the
    pre-projected ``input`` [B, T, size]: Weight [proj_size, size],
    ProjWeight ``<name>_proj_w`` [size / 4, proj_size], Bias [size].
    Returns (projection, cell)."""
    helper = LayerHelper("lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d = size // 4
    w = helper.create_parameter(helper.param_attr, shape=[proj_size, size],
                                dtype=dtype)
    wp = helper.create_parameter(
        ParamAttr(name=(name or helper.name) + "_proj_w"),
        shape=[d, proj_size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr, shape=[size],
                                   dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    bg = helper.create_variable_for_type_inference(dtype, True)
    bc = helper.create_variable_for_type_inference(dtype, True)
    bh = helper.create_variable_for_type_inference(dtype, True)
    inputs = {"Input": input, "Weight": w, "ProjWeight": wp}
    if bias is not None:
        inputs["Bias"] = bias
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="lstmp", inputs=inputs,
                     outputs={"Projection": proj, "Cell": cell,
                              "BatchGate": bg, "BatchCellPreAct": bc,
                              "BatchHidden": bh},
                     attrs={"use_peepholes": use_peepholes})
    return proj, cell


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """The reference's cudnn_lstm wrapper: a ``num_layers``-deep
    (bidirectional with ``is_bidirec``) LSTM over a time-major [T, B, D]
    input. Each layer and direction is an fc projection and a
    ``dynamic_lstm``, with dropout between layers. Returns (rnn_out
    [T, B, H * dirs], last_h and last_c [layers * dirs, B, H])."""
    from . import nn

    num_dir = 2 if is_bidirec else 1
    x = nn.transpose(input, [1, 0, 2])        # [B, T, D]
    last_hs, last_cs = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(num_dir):
            idx = layer * num_dir + d
            h0 = nn.reshape(nn.slice(init_h, axes=[0], starts=[idx],
                                     ends=[idx + 1]),
                            shape=[-1, hidden_size])
            c0 = nn.reshape(nn.slice(init_c, axes=[0], starts=[idx],
                                     ends=[idx + 1]),
                            shape=[-1, hidden_size])
            proj = nn.fc(x, size=4 * hidden_size, num_flatten_dims=2,
                         param_attr=default_initializer)
            h, c = dynamic_lstm(proj, size=4 * hidden_size, h_0=h0,
                                c_0=c0, use_peepholes=False,
                                is_reverse=(d == 1))
            outs.append(h)
            # the last valid step: T - 1 forward; a reverse run emits the
            # original time order, so its last step is t = 0
            start, end = (0, 1) if d == 1 else (-1, 2 ** 31)
            last_hs.append(nn.slice(h, axes=[1], starts=[start],
                                    ends=[end]))
            last_cs.append(nn.slice(c, axes=[1], starts=[start],
                                    ends=[end]))
        x = outs[0] if num_dir == 1 else nn.concat(outs, axis=-1)
        if dropout_prob > 0.0 and layer + 1 < num_layers:
            x = nn.dropout(x, dropout_prob=dropout_prob,
                           is_test=is_test, seed=seed if seed >= 0
                           else None)
    rnn_out = nn.transpose(x, [1, 0, 2])      # [T, B, H * dirs]
    last_h = nn.concat([nn.transpose(v, [1, 0, 2]) for v in last_hs],
                       axis=0)
    last_c = nn.concat([nn.transpose(v, [1, 0, 2]) for v in last_cs],
                       axis=0)
    return rnn_out, last_h, last_c
