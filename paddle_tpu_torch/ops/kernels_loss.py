"""Loss, similarity and ranking ops and the sampled-softmax heads
(counterpart of ``paddle_tpu/ops/kernels_loss.py``; reference cos_sim_op.h,
hinge_loss_op.h, rank_loss_op.h, margin_rank_loss_op.h, log_loss_op.h,
bpr_loss_op.h, modified_huber_loss_op.h, teacher_student_sigmoid_loss_op.cc,
squared_l2_distance_op.h, squared_l2_norm_op.h, l1_norm_op.h, minus_op.cc,
nce_op.h (the uniform sampler), hierarchical_sigmoid_op.h (the default
complete binary tree), positive_negative_pair_op.h (a host metric),
label_smooth_op.cc). Their grads run the generic vjp, but ``nce``'s:
``nce_grad`` recomputes the cost from the saved ``SampleLabels``, so the
backward never draws."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.desc import OpDesc
from ..registry import register_op
from .common import (ZERO, in_dtype, in_shape, jax_abs, opt,
                     same_shape_infer, scalar_infer, set_out_var, softplus, x)
from .common import slots_like_infer as _like

# cos_sim's floor under |x||y|; a 0-d host tensor, so ``torch.maximum``
# (the tie rule of ``jnp.maximum``: half the gradient to each side)
# broadcasts it on any device
_COS_EPS = torch.tensor(1e-12)


def _rowcol_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if xs is not None:
        for n in op.output("Out"):
            set_out_var(block, n, [xs[0], 1], dt)


@register_op("cos_sim", intermediate_outputs=("XNorm", "YNorm"),
             infer=_rowcol_infer)
def cos_sim(ctx, ins, attrs):
    """cos_sim_op.h: the row-wise cosine of X [N, D] and Y [N, D] or
    [1, D] (broadcast over X's rows), with the norms XNorm and YNorm."""
    xv, yv = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(xv * xv, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(yv * yv, dim=-1, keepdim=True))
    num = torch.sum(xv * yv, dim=-1, keepdim=True)
    out = num / torch.maximum(xn * yn, _COS_EPS.to(xv.dtype))
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("log_loss", infer=same_shape_infer("Loss", "Predicted"))
def log_loss(ctx, ins, attrs):
    """log_loss_op.h: -y log(p + eps) - (1 - y) log(1 - p + eps)."""
    pred, label = ins["Predicted"][0], ins["Labels"][0]
    eps = float(attrs.get("epsilon", 1e-4))
    return {"Loss": [-label * torch.log(pred + eps)
                     - (1.0 - label) * torch.log(1.0 - pred + eps)]}


def _relu0(v):
    """max(v, 0) with ``jnp.maximum``'s gradient (half each side at a
    tie)."""
    return torch.maximum(v, ZERO.to(v.dtype))


# the JAX op's infer rule reads Logits into an "Out" slot the op does not
# have, so Loss keeps the shape its layer declared; kept for equal programs
@register_op("hinge_loss", infer=same_shape_infer(in_slot="Logits"))
def hinge_loss(ctx, ins, attrs):
    """hinge_loss_op.h: max(0, 1 - x (2y - 1))."""
    pred, label = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": [_relu0(1.0 - pred * (2.0 * label - 1.0))]}


@register_op("rank_loss", infer=_like(("Out", "Left")))
def rank_loss(ctx, ins, attrs):
    """rank_loss_op.h: log(1 + e^o) - label o with o = left - right."""
    label = ins["Label"][0]
    o = ins["Left"][0] - ins["Right"][0]
    return {"Out": [softplus(o) - label * o]}


@register_op("margin_rank_loss", intermediate_outputs=("Activated",),
             infer=_like(("Out", "Label"), ("Activated", "Label")))
def margin_rank_loss(ctx, ins, attrs):
    """margin_rank_loss_op.h: max(0, -label (x1 - x2) + margin), and
    where it is positive."""
    label = ins["Label"][0]
    d = ins["X1"][0] - ins["X2"][0]
    out = _relu0(-label * d + float(attrs.get("margin", 0.0)))
    return {"Out": [out], "Activated": [(out > 0).to(d.dtype)]}


def _bpr_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is not None:
        for n in op.output("Y"):
            set_out_var(block, n, [xs[0], 1], in_dtype(block, op, "X"))


@register_op("bpr_loss", infer=_bpr_infer)
def bpr_loss(ctx, ins, attrs):
    """bpr_loss_op.h: -mean over the other classes j of
    log sigmoid(s_label - s_j)."""
    logits = ins["X"][0]
    label = ins["Label"][0].reshape(-1, 1).long()
    c = logits.shape[1]
    lls = F.logsigmoid(torch.take_along_dim(logits, label, dim=1) - logits)
    mask = torch.arange(c, device=logits.device)[None, :] != label
    return {"Y": [-torch.where(mask, lls, 0.0).sum(dim=1, keepdim=True)
                  / (c - 1)]}


@register_op("modified_huber_loss",
             intermediate_outputs=("IntermediateVal",),
             infer=_like(("Out", "X"), ("IntermediateVal", "X")))
def modified_huber_loss(ctx, ins, attrs):
    """modified_huber_loss_op.h on v = x (2y - 1): -4v below -1,
    (1 - v)^2 below 1, else 0."""
    v = ins["X"][0] * (2.0 * ins["Y"][0] - 1.0)
    out = torch.where(v < -1.0, -4.0 * v,
                      torch.where(v < 1.0, (1.0 - v) ** 2, 0.0))
    return {"Out": [out], "IntermediateVal": [v]}


@register_op("teacher_student_sigmoid_loss", infer=_like(("Y", "X")))
def teacher_student_sigmoid_loss(ctx, ins, attrs):
    """teacher_student_sigmoid_loss_op.h: the click's cross entropy plus,
    where the label carries a teacher value (label >= 0), the teacher's.
    The label encodes -2: click 0; -1: click 1; [0, 1): teacher q, click
    0; [1, 2]: teacher q - 1, click 1."""
    xv = ins["X"][0]
    label = ins["Label"][0]
    sp = _relu0(xv) + torch.log1p(torch.exp(-torch.abs(xv)))
    clk = torch.where(label < -1.0, 0.0,
                      torch.where(label < 0.0, 1.0,
                                  torch.where(label < 1.0, 0.0, 1.0)))
    teacher = torch.where(label < 0.0, 0.0,
                          torch.where(label < 1.0, label, label - 1.0))
    loss = (sp - xv * clk) + torch.where(label >= 0.0, sp - xv * teacher,
                                         0.0)
    return {"Y": [loss]}


@register_op("squared_l2_distance", intermediate_outputs=("sub_result",),
             infer=_rowcol_infer)
def squared_l2_distance(ctx, ins, attrs):
    """Row-wise sum of (X - Y)^2, Y [1, D] broadcast over X's rows."""
    sub = ins["X"][0] - ins["Y"][0]
    return {"Out": [torch.sum(sub * sub, dim=-1, keepdim=True)],
            "sub_result": [sub]}


@register_op("squared_l2_norm", infer=scalar_infer(shape=(1,)))
def squared_l2_norm(ctx, ins, attrs):
    xv = x(ins)
    return {"Out": [torch.sum(xv * xv).reshape(1)]}


@register_op("l1_norm", infer=scalar_infer(shape=(1,)))
def l1_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(jax_abs(x(ins))).reshape(1)]}


@register_op("minus", infer=same_shape_infer())
def minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


# ---------------------------------------------------------------------------
# sampled-softmax heads: nce and hierarchical_sigmoid
# ---------------------------------------------------------------------------

def _nce_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Input")
    if xs is not None:
        for n in op.output("Cost"):
            set_out_var(block, n, [xs[0], 1], in_dtype(block, op, "Input"))


def _nce_logits(xv, w, bias, ids):
    """The score of each (row, class in ``ids`` [B, K]): x_b . w_id +
    b_id."""
    flat = ids.reshape(-1)
    rows = w.index_select(0, flat).reshape(ids.shape + (w.shape[1],))
    sc = torch.matmul(rows, xv.unsqueeze(-1)).squeeze(-1)
    if bias is not None:
        sc = sc + bias.reshape(-1).index_select(0, flat).reshape(ids.shape)
    return sc


def _nce_cost(sc, log_b):
    """NCE's cost of the scores [B, 1 + S] (true class first):
    -log sigmoid(s_true - ln B) - sum log sigmoid(ln B - s_neg), with
    B = S / C (``log_b``)."""
    return (-F.logsigmoid(sc[:, :1] - log_b).sum(dim=1)
            - F.logsigmoid(log_b - sc[:, 1:]).sum(dim=1)).reshape(-1, 1)


@register_op("nce", needs_rng=True,
             intermediate_outputs=("SampleLogits", "SampleLabels"),
             infer=_nce_infer)
def nce(ctx, ins, attrs):
    """nce_op.h, the uniform sampler: each row draws ``num_neg_samples``
    classes uniformly (from the run's generator; the ``sampler``,
    ``custom_dist`` and ``seed`` attrs are ignored, as by the JAX op) and
    pays the NCE cost of its first true class against them. Under
    ``ctx.is_test`` the cost is the full softmax's cross entropy.
    SampleLabels [B, 1 + S] (true | negatives) is saved for
    ``nce_grad``."""
    xv = ins["Input"][0]
    label = ins["Label"][0].reshape(xv.shape[0], -1).long()
    w = ins["Weight"][0]
    bias = opt(ins, "Bias")
    s = int(attrs.get("num_neg_samples", 10))
    c = w.shape[0]
    if ctx.is_test:
        logits = xv @ w.t()
        if bias is not None:
            logits = logits + bias.reshape(1, -1)
        cost = -torch.take_along_dim(torch.log_softmax(logits, dim=-1),
                                     label[:, :1], dim=1)
        return {"Cost": [cost], "SampleLogits": [logits],
                "SampleLabels": [label]}
    neg = torch.randint(0, c, (xv.shape[0], s), generator=ctx.generator,
                        device=xv.device)
    samples = torch.cat([label[:, :1], neg], dim=1)
    sc = _nce_logits(xv, w, bias, samples)
    return {"Cost": [_nce_cost(sc, math.log(s / c))], "SampleLogits": [sc],
            "SampleLabels": [samples]}


@register_op("nce_grad", no_grad=True,
             infer=_like(("Input@GRAD", "Input"), ("Weight@GRAD", "Weight"),
                         ("Bias@GRAD", "Bias")))
def nce_grad(ctx, ins, attrs):
    """nce's backward: the cost recomputed from the saved SampleLabels
    (the negatives the forward drew; no draw here), differentiated with
    ``torch.func.vjp`` against Input, Weight and Bias."""
    xv = ins["Input"][0]
    w = ins["Weight"][0]
    bias = opt(ins, "Bias")
    samples = ins["SampleLabels"][0].long()
    gout = ins["Cost@GRAD"][0].to(xv.dtype)
    log_b = math.log(max(samples.shape[1] - 1, 1) / w.shape[0])

    def cost(*args):
        return _nce_cost(_nce_logits(args[0], args[1],
                                     args[2] if len(args) > 2 else None,
                                     samples), log_b)

    primals = (xv, w) if bias is None else (xv, w, bias)
    _, vjp_fn = torch.func.vjp(cost, *primals)
    grads = vjp_fn(gout)
    out = {"Input@GRAD": [grads[0]], "Weight@GRAD": [grads[1]]}
    if bias is not None:
        out["Bias@GRAD"] = [grads[2]]
    return out


@register_op("hierarchical_sigmoid", intermediate_outputs=("PreOut",),
             infer=_rowcol_infer)
def hierarchical_sigmoid(ctx, ins, attrs):
    """hierarchical_sigmoid_op.h over the default complete binary tree:
    leaf c is heap node c + C, internal node n (1 .. C - 1) owns row n - 1
    of W [C - 1, D] and of Bias; the loss is the sum of the binary cross
    entropies on the root-to-leaf path. A static loop of ceil(log2 C) + 1
    steps; a step above the root adds nothing. PreOut [B, steps] holds
    each step's logit."""
    xv = ins["X"][0]
    label = ins["Label"][0].reshape(-1).long()
    w = ins["W"][0]
    bias = opt(ins, "Bias")
    c = int(attrs["num_classes"])
    code = label + c
    losses = torch.zeros(xv.shape[0], dtype=xv.dtype, device=xv.device)
    pre = []
    for step in range(1, int(math.ceil(math.log2(c))) + 2):
        node = code >> step
        bit = (code >> (step - 1)) & 1
        idx = (node - 1).clamp(0, c - 2)
        logit = (xv * w.index_select(0, idx)).sum(dim=1)
        if bias is not None:
            logit = logit + bias.reshape(-1).index_select(0, idx)
        ce = softplus(logit) - bit.to(logit.dtype) * logit
        losses = losses + torch.where(node >= 1, ce, 0.0)
        pre.append(logit)
    return {"Out": [losses.reshape(-1, 1)], "PreOut": [torch.stack(pre, 1)]}


# ---------------------------------------------------------------------------
# host metric and label smoothing
# ---------------------------------------------------------------------------

_PAIR_SLOTS = ("PositivePair", "NegativePair", "NeutralPair")
_PAIR_ACCUMULATORS = ("AccumulatePositivePair", "AccumulateNegativePair",
                      "AccumulateNeutralPair")


def _pnpair_infer(op: OpDesc, block):
    for slot in _PAIR_SLOTS:
        for n in op.output(slot):
            set_out_var(block, n, [1], "float32")


def count_pairs(score, label, qid):
    """(agreeing, disagreeing, tied-score) counts over the pairs of rows
    of one query with different labels: a pair agrees when the score
    orders it as the label does."""
    counts = np.zeros(3, np.int64)
    for q in np.unique(qid):
        rows = np.flatnonzero(qid == q)
        i, j = np.triu_indices(len(rows), k=1)
        dl = label[rows[i]] - label[rows[j]]
        prod = (score[rows[i]] - score[rows[j]]) * dl
        ranked = dl != 0
        counts += [np.sum(ranked & (prod > 0)), np.sum(ranked & (prod < 0)),
                   np.sum(ranked & (prod == 0))]
    return counts


@register_op("positive_negative_pair", no_grad=True, is_host=True,
             infer=_pnpair_infer)
def positive_negative_pair(ctx, ins, attrs):
    """positive_negative_pair_op.h, a host op: the pair counts of
    :func:`count_pairs` over Score, Label and QueryID, added to the
    accumulators when given; 0-d float32 results, as the JAX op gives."""
    host = [ins[s][0].detach().cpu().numpy().reshape(-1)
            for s in ("Score", "Label", "QueryID")]
    counts = count_pairs(*host).astype(np.float64)
    if opt(ins, _PAIR_ACCUMULATORS[0]) is not None:
        counts += [float(ins[s][0].detach().cpu().reshape(-1)[0])
                   for s in _PAIR_ACCUMULATORS]
    dev = ins["Score"][0].device
    return {slot: [torch.tensor(np.float32(v)).to(dev)]
            for slot, v in zip(_PAIR_SLOTS, counts)}


@register_op("label_smooth", infer=same_shape_infer())
def label_smooth(ctx, ins, attrs):
    """label_smooth_op.cc: (1 - eps) label + eps prior, the prior uniform
    (1 / the last dim) without PriorDist."""
    xv = x(ins)
    eps = attrs.get("epsilon", 0.0)
    prior = opt(ins, "PriorDist")
    if prior is not None:
        return {"Out": [(1.0 - eps) * xv + eps * prior]}
    return {"Out": [(1.0 - eps) * xv + eps / xv.shape[-1]]}
