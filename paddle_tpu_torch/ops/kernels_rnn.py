"""Recurrent ops (counterpart of ``paddle_tpu/ops/kernels_rnn.py``): the
``gru`` forward over a padded [B, T, 3H] batch.

Gate layout (the reference's gru_kernel.h, ``origin_mode=False``): the
input is pre-projected x·Wx + bias; Weight [H, 3H] holds the update and
reset gates' [H, 2H] and the candidate's [H, H], and
h = (1 - u) * h_prev + u * c. A row past its ``Length`` keeps its hidden
state; ``is_reverse`` runs each row backwards within its length (the
padding stays where it is). The recurrence is a loop of T steps, T
static, so the op can be captured in a CUDA graph. Its backward
(``gru_grad``) waits for ROADMAP A11.
"""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import register_op
from .common import amp_cast, in_dtype, in_shape, opt, set_out_var

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
