"""Fused ops the IR passes write (counterpart of
``paddle_tpu/ops/kernels_fused.py``; reference operators/fused/):
``fused_elemwise_activation`` (fuse_elewise_add_act),
``fusion_repeated_fc_relu`` (repeated_fc_relu_fuse_pass),
``fusion_squared_mat_sub`` (squared_mat_sub_fuse_pass),
``fusion_transpose_flatten_concat`` (transpose_flatten_concat_fuse_pass),
``fusion_gru`` and ``fusion_lstm`` (fc_gru_fuse_pass, fc_lstm_fuse_pass),
``fused_embedding_fc_lstm`` (embedding_fc_lstm_fuse_pass),
``fusion_seqpool_concat`` (seqpool_concat_fuse_pass),
``fusion_seqconv_eltadd_relu`` (seqconv_eltadd_relu_fuse_pass),
``conv2d_fusion`` (the inference conv passes) and ``fused_conv2d`` (the
pipeline's conv stages). Each composes the torch ops, or the registered emitters, of the
ops it replaces. No pass writes ``fused_embedding_seq_pool``,
``fusion_seqexpand_concat_fc`` or ``attention_lstm``: only loaded
programs hold them.

``fused_elemwise_activation`` and ``fused_conv2d`` have no grad emitter of
their own: their grad ops run the generic vjp, which re-runs the forward
under ``torch.func.vjp`` as every generic grad op does (ROADMAP A1)."""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import lookup, register_op
from .common import ZERO, fluid_broadcast, in_dtype, in_shape, opt, set_out_var


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



def _fusion_rnn(ctx, ins, attrs, rnn_type: str, proj=None):
    """The projected input (X @ WeightX, unless the embedding-folded op
    passes its lookup as ``proj``), then the registered gru or lstm
    emitter: the same loop, so the fused op's outputs are the unfused
    recurrence's."""
    if proj is None:
        xv = ins["X"][0]
        proj = xv @ ins["WeightX"][0].to(xv.dtype)
    sub_ins = {"Input": [proj], "Weight": ins["WeightH"],
               "Bias": ins.get("Bias", [None]),
               "H0": ins.get("H0", [None]),
               "Length": ins.get("Length", [None])}
    if rnn_type == "lstm":
        sub_ins["C0"] = ins.get("C0", [None])
    return lookup(rnn_type).emitter(ctx, sub_ins, attrs)


def _fusion_rnn_infer(n_gates: int, with_cell: bool):
    def infer(op: OpDesc, block):
        xs = in_shape(block, op, "X")
        ws = in_shape(block, op, "WeightX")
        if xs is None or ws is None:
            return
        h = ws[-1] // n_gates
        for slot in ("Hidden", "Cell") if with_cell else ("Hidden",):
            for n in op.output(slot):
                set_out_var(block, n, xs[:-1] + [h],
                            in_dtype(block, op, "X"))
    return infer


@register_op("fusion_gru", no_grad=True, infer=_fusion_rnn_infer(3, False))
def fusion_gru(ctx, ins, attrs):
    """fused/fusion_gru_op.cc, the product of fc_gru_fuse_pass."""
    return {"Hidden": _fusion_rnn(ctx, ins, attrs, "gru")["Hidden"]}


@register_op("fusion_lstm", no_grad=True, infer=_fusion_rnn_infer(4, True))
def fusion_lstm(ctx, ins, attrs):
    """fused/fusion_lstm_op.cc, the product of fc_lstm_fuse_pass."""
    out = _fusion_rnn(ctx, ins, attrs, "lstm")
    return {"Hidden": out["Hidden"], "Cell": out["Cell"]}


@register_op("fusion_seqpool_concat", no_grad=True, infer=_dtype_only_infer)
def fusion_seqpool_concat(ctx, ins, attrs):
    """fused/fusion_seqpool_concat_op.cc: N sequence_pools (each with its
    Length, if any) and one concat."""
    pool = lookup("sequence_pool").emitter
    lengths = ins.get("Length", [])
    pooled = []
    for i, xv in enumerate(ins["X"]):
        n = lengths[i] if i < len(lengths) else None
        pooled.append(pool(ctx, {"X": [xv], "Length": [n]},
                           {"pooltype": attrs.get("pooltype", "SUM")})
                      ["Out"][0])
    return {"Out": [torch.cat(pooled, dim=int(attrs.get("axis", 1)))]}


def _ids_bt(ids):
    """(B, T) of an id layout: [B, T, 1], [B, T], a flat [N, 1] (one
    sequence) or [N]."""
    if len(ids) == 3:
        return ids[0], ids[1]
    if len(ids) == 2:
        return (1, ids[0]) if ids[1] == 1 else (ids[0], ids[1])
    return 1, ids[0]


def _fused_emb_fc_lstm_infer(op: OpDesc, block):
    ids = in_shape(block, op, "Ids")
    wh = in_shape(block, op, "WeightH")
    if ids is None or wh is None:
        return
    d = wh[0]
    b, t = _ids_bt(ids)
    dt = in_dtype(block, op, "Embeddings")
    for slot, width in (("Hidden", d), ("Cell", d), ("XX", 4 * d)):
        for n in op.output(slot):
            set_out_var(block, n, [b, t, width], dt)


@register_op("fused_embedding_fc_lstm", no_grad=True,
             infer=_fused_emb_fc_lstm_infer)
def fused_embedding_fc_lstm(ctx, ins, attrs):
    """fused/fused_embedding_fc_lstm_op.cc: embedding_fc_lstm_fuse_pass
    folds the input fc into the table (each row of Embeddings is already
    the 4H gate pre-projection, in the lstm's c, i, f, o layout), so the
    op is a lookup and the lstm recurrence."""
    ids = ins["Ids"][0]
    b, t = _ids_bt(list(ids.shape))
    proj = ins["Embeddings"][0][ids.reshape(b, t).long()]   # [B, T, 4H]
    out = _fusion_rnn(ctx, ins, attrs, "lstm", proj=proj)
    return {"Hidden": out["Hidden"], "Cell": out["Cell"], "XX": [proj]}

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


@register_op("fusion_seqconv_eltadd_relu", no_grad=True,
             infer=_dtype_only_infer)
def fusion_seqconv_eltadd_relu(ctx, ins, attrs):
    """fusion_seqconv_eltadd_relu_op.cc: sequence_conv, + Bias, relu over
    padded [B, T, D], the window masked by Length as the unfused op masks
    it."""
    conv = lookup("sequence_conv").emitter(
        ctx, {"X": ins["X"], "Filter": ins["Filter"],
              "Length": ins.get("Length", [None])}, attrs)["Out"][0]
    return {"Out": [torch.maximum(conv + ins["Bias"][0], ZERO)]}


@register_op("fused_embedding_seq_pool", no_grad=True,
             infer=_dtype_only_infer)
def fused_embedding_seq_pool(ctx, ins, attrs):
    """fused/fused_embedding_seq_pool_op.cc: a lookup and a sum over the
    sequence dim of padded ids [B, T] (or [B, T, 1]); rows of
    ``padding_idx`` count as zeros."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    emb = w[ids.long()]                                   # [B, T, D]
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        emb = emb * (ids != pad).unsqueeze(-1).to(emb.dtype)
    return {"Out": [emb.sum(dim=1)]}


_SEQ_ACTS = {"relu": torch.relu, "tanh": torch.tanh}


@register_op("fusion_seqexpand_concat_fc", no_grad=True,
             infer=_dtype_only_infer)
def fusion_seqexpand_concat_fc(ctx, ins, attrs):
    """fused/fusion_seqexpand_concat_fc_op.cc: each input after the first
    (one row per batch entry) broadcast over the first's sequence dim,
    the features concatenated, one fc and its activation."""
    xs = ins["X"]
    ref = xs[0]                                           # [B, T, D0]
    t = ref.shape[1]
    feats = [ref] + [v.unsqueeze(1).expand(v.shape[0], t, v.shape[-1])
                     for v in xs[1:]]
    out = torch.matmul(torch.cat(feats, dim=-1), ins["FCWeight"][0])
    bias = opt(ins, "FCBias")
    if bias is not None:
        out = out + bias
    act = _SEQ_ACTS.get(attrs.get("fc_activation", "identity"))
    return {"Out": [act(out) if act is not None else out]}


# the attention LSTM's activations, as the JAX op writes them
_ATT_ACTS = {
    "relu": lambda v: torch.maximum(v, ZERO),
    "sigmoid": lambda v: 1.0 / (1.0 + torch.exp(-v)),
    "tanh": torch.tanh,
    "identity": lambda v: v,
    "": lambda v: v,
}


def _scalar_in(ins, slot, default):
    v = opt(ins, slot)
    return v.reshape(()) if v is not None else default


@register_op("attention_lstm", no_grad=True)
def attention_lstm(ctx, ins, attrs):
    """attention_lstm_op.cc over padded X [B, T, M] with an optional
    Length: each step an attention fc over the whole sequence,
    conditioned on the previous cell, weighs the steps into one context
    row that feeds one LSTM step. The gate layout is the reference's
    [forget, input, output, candidate] over LSTMWeight [(D + M), 4D],
    hidden rows first; the attention fc is relu'd, and rescaled by the
    optional AttentionScalar (attention_lstm_op.cc:215-224, :330-401).
    Rows past their length keep their state."""
    xv = ins["X"][0]                                      # [B, T, M]
    c = ins["C0"][0]                                      # [B, D]
    h0 = opt(ins, "H0")
    h = h0 if h0 is not None else torch.zeros_like(c)
    atten_w = ins["AttentionWeight"][0]                   # [M + D, 1]
    atten_b = _scalar_in(ins, "AttentionBias", 0.0)
    scalar = _scalar_in(ins, "AttentionScalar", None)
    scalar_b = _scalar_in(ins, "AttentionScalarBias", 0.0)
    lstm_w = ins["LSTMWeight"][0]                         # [D + M, 4D]
    lstm_b = ins["LSTMBias"][0].reshape(-1)
    b, t, m = xv.shape
    d = c.shape[-1]
    length = opt(ins, "Length")
    if length is None:
        length = torch.full((b,), t, dtype=torch.int32, device=xv.device)
    steps = torch.arange(t, device=xv.device)
    valid = steps.reshape(1, t) < length.reshape(b, 1)    # [B, T]
    act_gate = _ATT_ACTS[attrs.get("gate_activation", "sigmoid")]
    act_cell = _ATT_ACTS[attrs.get("cell_activation", "tanh")]
    act_cand = _ATT_ACTS[attrs.get("candidate_activation", "tanh")]

    atted_x = torch.matmul(xv, atten_w[:m]).squeeze(-1) + atten_b
    wh, wx = lstm_w[:d], lstm_w[d:]
    neg_inf = torch.full((), float("-inf"), dtype=xv.dtype, device=xv.device)
    hs, cs = [], []
    for i in range(t):
        score = torch.maximum(atted_x + torch.matmul(c, atten_w[m:]), ZERO)
        if scalar is not None:
            score = torch.maximum(score * scalar + scalar_b, ZERO)
        p = torch.softmax(torch.where(valid, score, neg_inf), dim=-1)
        lstm_x = torch.einsum("bt,btm->bm", p, xv)
        gates = (torch.matmul(lstm_x, wx) + torch.matmul(h, wh)) + lstm_b
        f = act_gate(gates[:, :d])
        ig = act_gate(gates[:, d:2 * d])
        o = act_gate(gates[:, 2 * d:3 * d])
        cand = act_cand(gates[:, 3 * d:])
        c_new = f * c + ig * cand
        h_new = o * act_cell(c_new)
        keep = (steps[i] < length.reshape(b)).reshape(b, 1)
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
        hs.append(h)
        cs.append(c)
    return {"Hidden": [torch.stack(hs, dim=1)], "Cell": [torch.stack(cs, dim=1)],
            "AttentionedX": [atted_x.unsqueeze(-1)],
            "AttentionFCOut": [xv.new_zeros((b, t, 1))],
            "LSTMX": [xv.new_zeros((b, m))],
            "LSTMOUT": [xv.new_zeros((b, 4 * d))]}
