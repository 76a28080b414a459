"""Recurrent ops (counterpart of ``paddle_tpu/ops/kernels_rnn.py``): the
``lstm``, ``gru`` and ``lstmp`` forwards over a padded [B, T, 4H] or
[B, T, 3H] batch, and the one-step cells ``lstm_unit`` and ``gru_unit``.

The input is pre-projected (x·Wx, plus the bias the op adds); the op runs
the recurrence h_{t-1}·Wh + gates. LSTM gates sit on the 4H axis in the
reference's order c, i, f, o (lstm_op.cc, math/detail/lstm_cpu_kernel.h),
with the peephole weights W_ic, W_fc, W_oc in Bias[4H:7H] when
``use_peepholes``. GRU follows gru_kernel.h, ``origin_mode=False``: Weight
[H, 3H] holds the update and reset gates' [H, 2H] and the candidate's
[H, H], and h = (1 - u) * h_prev + u * c. A row past its ``Length`` keeps
its state; ``is_reverse`` runs each row backwards within its length (the
padding stays where it is). The recurrence is a loop of T steps, T
static, so the op can be captured in a CUDA graph. Their grads run the
generic vjp, which re-runs the loop under ``torch.func.vjp``.

``lstm_unit`` takes its gates in the order i, f, o, g (lstm_unit_op.h),
``lstmp`` in the order i, f, c, o of the JAX op; neither reads peephole
weights (``lstmp``'s ``use_peepholes`` is ignored, as by the JAX op).
"""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import register_op
from .common import (amp_cast, in_dtype, in_shape, length_or_full, opt,
                     set_out_var)
from .common import slots_like_infer as _like

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "relu": torch.relu, "identity": lambda v: v}


def _seq_flip(xv, length):
    """Reverse each row's first ``length`` steps of [B, T, ...]."""
    if length is None:
        return torch.flip(xv, dims=(1,))
    t = xv.shape[1]
    idx = torch.arange(t, device=xv.device)[None, :]
    n = length.reshape(-1, 1).long()
    src = torch.where(idx < n, n - 1 - idx, idx)
    return torch.take_along_dim(
        xv, src.reshape(src.shape + (1,) * (xv.dim() - 2)), dim=1)


def _lstm_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Input")
    dt = in_dtype(block, op, "Input")
    if xs is None:
        return
    h = xs[-1] // 4
    for slot in ("Hidden", "Cell"):
        for n in op.output(slot):
            set_out_var(block, n, xs[:-1] + [h], dt)


@register_op("lstm", intermediate_outputs=("BatchGate", "BatchCellPreAct"),
             infer=_lstm_infer)
def lstm(ctx, ins, attrs):
    """lstm_op.cc over Input [B, T, 4H], Weight [H, 4H], optional Bias
    [4H] or [7H] (with peepholes), H0 and C0 [B, H] and Length [B]:
    Hidden and Cell [B, T, H]. Under AMP the recurrent product takes bf16
    operands, as the JAX op's does."""
    xv = ins["Input"][0]
    w = ins["Weight"][0]
    bias = opt(ins, "Bias")
    bsz, t = xv.shape[0], xv.shape[1]
    hdim = xv.shape[2] // 4
    h, c = opt(ins, "H0"), opt(ins, "C0")
    if h is None:
        h = torch.zeros((bsz, hdim), dtype=xv.dtype, device=xv.device)
    if c is None:
        c = torch.zeros((bsz, hdim), dtype=xv.dtype, device=xv.device)
    length = opt(ins, "Length")
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACT[attrs.get("cell_activation", "tanh")]
    cand_act = _ACT[attrs.get("candidate_activation", "tanh")]
    peep = (bool(attrs.get("use_peepholes", False)) and bias is not None
            and bias.shape[-1] == 7 * hdim)
    reverse = bool(attrs.get("is_reverse", False))

    gates_in = xv
    if bias is not None:
        gates_in = gates_in + bias[..., :4 * hdim].reshape(1, 1, 4 * hdim)
    if reverse:
        gates_in = _seq_flip(gates_in, length)
    if peep:
        w_ic = bias[..., 4 * hdim:5 * hdim]
        w_fc = bias[..., 5 * hdim:6 * hdim]
        w_oc = bias[..., 6 * hdim:7 * hdim]
    hs, cs = [], []
    for tt in range(t):
        hp, wc = amp_cast(ctx, h, w)
        g = gates_in[:, tt] + hp @ wc
        gc, gi, gf, go = torch.split(g, hdim, dim=-1)
        if peep:
            gi = gi + w_ic * c
            gf = gf + w_fc * c
        c_new = gate_act(gf) * c + gate_act(gi) * cand_act(gc)
        if peep:
            go = go + w_oc * c_new
        h_new = gate_act(go) * cell_act(c_new)
        if length is not None:
            valid = (tt < length).reshape(-1, 1)
            h_new = torch.where(valid, h_new, h)
            c_new = torch.where(valid, c_new, c)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    hidden = torch.stack(hs, dim=1)
    cell = torch.stack(cs, dim=1)
    if reverse:
        hidden = _seq_flip(hidden, length)
        cell = _seq_flip(cell, length)
    z = torch.zeros((0,), dtype=xv.dtype, device=xv.device)
    return {"Hidden": [hidden], "Cell": [cell], "BatchGate": [z],
            "BatchCellPreAct": [z]}

def _gru_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Input")
    dt = in_dtype(block, op, "Input")
    if xs is None:
        return
    h = xs[-1] // 3
    for n in op.output("Hidden"):
        set_out_var(block, n, xs[:-1] + [h], dt)


@register_op("gru", intermediate_outputs=("BatchGate", "BatchResetHiddenPrev",
                                          "BatchHidden"),
             infer=_gru_infer)
def gru(ctx, ins, attrs):
    """gru_op.cc over Input [B, T, 3H], Weight [H, 3H], optional Bias
    [3H], H0 [B, H] and Length [B]: Hidden [B, T, H]."""
    xv = ins["Input"][0]
    w = ins["Weight"][0]
    bias = opt(ins, "Bias")
    bsz, t = xv.shape[0], xv.shape[1]
    hdim = xv.shape[2] // 3
    h = opt(ins, "H0")
    if h is None:
        h = torch.zeros((bsz, hdim), dtype=xv.dtype, device=xv.device)
    length = opt(ins, "Length")
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    reverse = bool(attrs.get("is_reverse", False))

    gates_in = xv if bias is None else xv + bias.reshape(1, 1, 3 * hdim)
    if reverse:
        gates_in = _seq_flip(gates_in, length)
    w_ur, w_c = w[:, :2 * hdim], w[:, 2 * hdim:]
    steps = []
    for tt in range(t):
        g_x = gates_in[:, tt]
        hp, wur = amp_cast(ctx, h, w_ur)
        g_ur = g_x[:, :2 * hdim] + (hp @ wur).to(g_x.dtype)
        u = gate_act(g_ur[:, :hdim])
        r = gate_act(g_ur[:, hdim:])
        rh, wc = amp_cast(ctx, r * h, w_c)
        c = cand_act(g_x[:, 2 * hdim:] + (rh @ wc).to(g_x.dtype))
        h_new = (1 - u) * h + u * c
        if length is not None:
            h_new = torch.where((tt < length).reshape(-1, 1), h_new, h)
        h = h_new
        steps.append(h)
    hidden = torch.stack(steps, dim=1)
    if reverse:
        hidden = _seq_flip(hidden, length)
    z = torch.zeros((0,), dtype=xv.dtype, device=xv.device)
    return {"Hidden": [hidden], "BatchGate": [z],
            "BatchResetHiddenPrev": [z], "BatchHidden": [z]}


@register_op("lstm_unit", infer=_like(("H", "C_prev"), ("C", "C_prev")))
def lstm_unit(ctx, ins, attrs):
    """lstm_unit_op.h: X [B, 4D] pre-projected gates (i, f, o, g),
    C_prev [B, D]: C = sigmoid(f + forget_bias) C_prev + sigmoid(i)
    tanh(g), H = sigmoid(o) tanh(C)."""
    xv = ins["X"][0]
    c_prev = ins["C_prev"][0]
    d = c_prev.shape[-1]
    i = torch.sigmoid(xv[:, :d])
    f = torch.sigmoid(xv[:, d:2 * d] + float(attrs.get("forget_bias", 0.0)))
    o = torch.sigmoid(xv[:, 2 * d:3 * d])
    c = f * c_prev + i * torch.tanh(xv[:, 3 * d:])
    return {"C": [c], "H": [o * torch.tanh(c)]}


@register_op("gru_unit", intermediate_outputs=("Gate", "ResetHiddenPrev"),
             infer=_like(("Hidden", "HiddenPrev"),
                         ("ResetHiddenPrev", "HiddenPrev"),
                         ("Gate", "Input")))
def gru_unit(ctx, ins, attrs):
    """gru_unit_op.h: Input [B, 3D] x-projected gates, HiddenPrev [B, D],
    Weight [D, 3D] (u | r | c), optional Bias [1, 3D]. ``origin_mode``
    gives h = c + u (h_prev - c), else h = u c + (1 - u) h_prev. Gate
    holds (u, r, c) and ResetHiddenPrev r h_prev."""
    g = ins["Input"][0]
    h_prev = ins["HiddenPrev"][0]
    w = ins["Weight"][0]
    bias = opt(ins, "Bias")
    d = h_prev.shape[-1]
    if bias is not None:
        g = g + bias.reshape(1, 3 * d)
    g_ur = g[:, :2 * d] + h_prev @ w[:, :2 * d]
    u = torch.sigmoid(g_ur[:, :d])
    r = torch.sigmoid(g_ur[:, d:])
    rhp = r * h_prev
    c = torch.tanh(g[:, 2 * d:] + rhp @ w[:, 2 * d:])
    if attrs.get("origin_mode", False):
        h = c + u * (h_prev - c)
    else:
        h = u * c + (1.0 - u) * h_prev
    return {"Hidden": [h], "Gate": [torch.cat([u, r, c], dim=1)],
            "ResetHiddenPrev": [rhp]}


@register_op("lstmp", intermediate_outputs=("BatchGate", "BatchCellPreAct",
                                            "BatchHidden"))
def lstmp(ctx, ins, attrs):
    """lstmp_op.cc: an LSTM whose recurrent state is the projection
    r = h ProjWeight [B, P]. Input [B, T, 4D] pre-projected, Weight
    [P, 4D], ProjWeight [D, P], optional Bias (its first 4D entries) and
    Length [B]: Projection [B, T, P] and Cell [B, T, D], zero past a
    row's length, whose state is carried unchanged. A loop of T steps, T
    static."""
    xv = ins["Input"][0]
    w = ins["Weight"][0]
    wp = ins["ProjWeight"][0]
    bias = opt(ins, "Bias")
    b, t, d4 = xv.shape
    d = d4 // 4
    length = length_or_full(ins, b, t, xv.device)
    gate_bias = (bias.reshape(-1)[:4 * d] if bias is not None
                 else torch.zeros(4 * d, dtype=xv.dtype, device=xv.device))
    r = torch.zeros((b, wp.shape[1]), dtype=xv.dtype, device=xv.device)
    c = torch.zeros((b, d), dtype=xv.dtype, device=xv.device)
    rs, cs = [], []
    for tt in range(t):
        g = xv[:, tt] + r @ w + gate_bias
        i = torch.sigmoid(g[:, :d])
        f = torch.sigmoid(g[:, d:2 * d])
        c_new = f * c + i * torch.tanh(g[:, 2 * d:3 * d])
        r_new = (torch.sigmoid(g[:, 3 * d:]) * torch.tanh(c_new)) @ wp
        live = (tt < length).reshape(-1, 1)
        r = torch.where(live, r_new, r)
        c = torch.where(live, c_new, c)
        rs.append(torch.where(live, r, 0.0))
        cs.append(torch.where(live, c, 0.0))
    zeros = [torch.zeros((b, t, n), dtype=xv.dtype, device=xv.device)
             for n in (4 * d, d, d)]
    return {"Projection": [torch.stack(rs, dim=1)],
            "Cell": [torch.stack(cs, dim=1)], "BatchGate": [zeros[0]],
            "BatchCellPreAct": [zeros[1]], "BatchHidden": [zeros[2]]}
