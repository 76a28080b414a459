"""Structured-prediction ops (counterpart of ``paddle_tpu/ops/kernels_crf.py``):
the linear-chain CRF's negative log-likelihood, its Viterbi decode and
chunk evaluation; CTC's loss (``warpctc``), its greedy decode's
post-processing (``ctc_align``) and the Levenshtein distance
(``edit_distance``).

The batch is padded [B, T, N] emissions with [B] lengths. The
``Transition`` parameter is [N + 2, N]: row 0 the start weights, row 1
the end weights, rows 2.. the tag-to-tag weights (reference
linear_chain_crf_op.h). The forward algorithm and Viterbi are Python
loops over the static T (the JAX package's ``lax.scan``s), a row frozen
from its length on by ``torch.where`` on a tensor compare, so both can be
captured in a CUDA graph. The gold path's weights are read with one-hot
products rather than gathers: the values are the same, and the backward
is a product, deterministic on the card (a gather's backward is a
scatter-add). ``linear_chain_crf``'s gradient is the generic vjp.
``chunk_eval`` is a host op in numpy, as the reference's CPU-only kernel.

``warpctc`` is the log-space alpha recursion over the blank-extended label
(2L + 1 states) with a -1e30 sentinel for impossible states, so that
neither the forward nor its vjp meets -inf; its gradient is the generic
vjp of the whole recursion. It reads the label's log-probabilities with a
one-hot product (exact, and its backward a product, not a scatter-add), so
the step stays deterministic on the card; ``F.ctc_loss``'s CUDA backward
is not. ``edit_distance`` runs the Levenshtein table by anti-diagonals:
T1 + T2 steps of vector minima instead of T1 x T2 scalar ones. Its
entries are small integers, exact in float32, so the distances are bitwise
those of the JAX package's row-by-row scan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.desc import OpDesc
from ..registry import register_op
from .common import in_dtype, in_shape, length_or_full, set_out_var


def _crf_unpack(trans):
    return trans[0], trans[1], trans[2:]   # start, end, pairwise [N, N]


def _crf_infer(op: OpDesc, block):
    es = in_shape(block, op, "Emission")
    dt = in_dtype(block, op, "Emission")
    if es is not None:
        for n in op.output("LogLikelihood"):
            set_out_var(block, n, [es[0], 1], dt)


def _one_hot(tags, n, dtype):
    """A comparison against the tag range: no scatter, no host read."""
    return (tags[..., None] == torch.arange(n, device=tags.device)).to(dtype)


@register_op("linear_chain_crf", intermediate_outputs=("Alpha",),
             infer=_crf_infer)
def linear_chain_crf(ctx, ins, attrs):
    """Per row, the negative log-likelihood of the gold path: logZ from
    the forward algorithm in log space less the gold path's score
    (linear_chain_crf_op.h:144-176). ``Alpha`` is the last forward
    vector [B, N]."""
    em = ins["Emission"][0]                    # [B, T, N]
    b, t, n = em.shape
    label = ins["Label"][0].reshape(b, t).long()
    length = length_or_full(ins, b, t, em.device)
    start, end, w = _crf_unpack(ins["Transition"][0])

    alpha = start[None, :] + em[:, 0]          # [B, N]
    for ti in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) + em[:, ti]
        alpha = torch.where((ti < length)[:, None], nxt, alpha)
    logz = torch.logsumexp(alpha + end[None, :], dim=1)

    hot = _one_hot(label, n, em.dtype)                      # [B, T, N]
    emit = (em * hot).sum(dim=2)                            # [B, T]
    # w[label[t-1], label[t]] for t >= 1: the row of the previous tag,
    # then the column of the current one
    rows = (hot[:, :-1, :, None] * w[None, None]).sum(dim=2)  # [B, T-1, N]
    pair = (rows * hot[:, 1:]).sum(dim=2)                   # [B, T-1]
    gold = (start[None, :] * hot[:, 0]).sum(dim=1) + emit[:, 0]
    for ti in range(1, t):
        gold = gold + torch.where(ti < length,
                                  pair[:, ti - 1] + emit[:, ti], 0.0)
    last = torch.clamp(length.long() - 1, 0, t - 1)
    last_tag = torch.take_along_dim(label, last[:, None], dim=1).reshape(-1)
    gold = gold + (end[None, :] * _one_hot(last_tag, n, em.dtype)).sum(dim=1)
    return {"LogLikelihood": [(logz - gold).reshape(b, 1)], "Alpha": [alpha]}


def _crf_decoding_infer(op: OpDesc, block):
    es = in_shape(block, op, "Emission")
    if es is not None and len(es) >= 2:
        for n in op.output("ViterbiPath"):
            set_out_var(block, n, es[:2], "int64")


@register_op("crf_decoding", no_grad=True, infer=_crf_decoding_infer)
def crf_decoding(ctx, ins, attrs):
    """Viterbi (crf_decoding_op.h): the best path [B, T] int64, 0 from
    each row's length on. A maximum shared by several tags takes the
    first (``jnp.argmax``'s and ``torch.max``'s rule). With a ``Label``
    input it gives the per-token 0/1 agreement with the label instead
    (the reference's evaluation mode)."""
    em = ins["Emission"][0]
    b, t, n = em.shape
    length = length_or_full(ins, b, t, em.device)
    start, end, w = _crf_unpack(ins["Transition"][0])

    alpha = start[None, :] + em[:, 0]
    bps = []
    for ti in range(1, t):
        best, bp = torch.max(alpha[:, :, None] + w[None], dim=1)   # [B, N]
        alpha = torch.where((ti < length)[:, None], best + em[:, ti], alpha)
        bps.append(bp)
    tag = torch.argmax(alpha + end[None, :], dim=1)                # [B]
    path = [None] * t
    for ti in range(t - 1, 0, -1):
        path[ti] = tag
        prev = torch.take_along_dim(bps[ti - 1], tag[:, None],
                                    dim=1).reshape(-1)
        # positions at and after a row's end keep its last tag
        tag = torch.where(ti < length, prev, tag)
    path[0] = tag
    mask = torch.arange(t, device=em.device)[None, :] < length[:, None]
    path = torch.where(mask, torch.stack(path, dim=1), 0).long()
    label = ins.get("Label")
    if label and label[0] is not None:
        correct = (path == label[0].reshape(b, t)) & mask
        return {"ViterbiPath": [correct.long()]}
    return {"ViterbiPath": [path]}


def _chunks(tags, scheme, num_types, excluded):
    """The (begin, end, type) chunks of one row's tag ids under ``scheme``
    (IOB, IOE, IOBES or plain), as the JAX package extracts them."""
    chunks = []
    cur_start, cur_type = None, None
    num_tag = {"plain": 1, "IOB": 2, "IOE": 2}.get(scheme, 4)
    other = num_types * num_tag   # the "O" tag id
    for i, tag in enumerate(tags):
        tag = int(tag)
        if tag >= other or tag < 0:
            ctype, pos = None, None
        else:
            ctype, pos = divmod(tag, num_tag)
        if scheme == "plain":
            is_begin = ctype is not None and ctype != cur_type
            is_inside = ctype is not None and ctype == cur_type
            ends_prev = ctype != cur_type
        elif scheme == "IOB":
            is_begin = ctype is not None and pos == 0
            is_inside = ctype is not None and pos == 1 and \
                ctype == cur_type
            ends_prev = not is_inside
        elif scheme == "IOE":
            is_begin = ctype is not None and cur_type != ctype
            is_inside = ctype is not None and cur_type == ctype
            ends_prev = ctype is None or (cur_type is not None and
                                          ctype != cur_type)
        else:  # IOBES: B=0, I=1, E=2, S=3
            is_begin = ctype is not None and pos in (0, 3)
            is_inside = ctype is not None and pos in (1, 2) and \
                ctype == cur_type
            ends_prev = not is_inside
        if cur_start is not None and ends_prev:
            chunks.append((cur_start, i - 1, cur_type))
            cur_start, cur_type = None, None
        if is_begin:
            cur_start, cur_type = i, ctype
            if scheme == "IOBES" and pos == 3:   # S-: a single token
                chunks.append((i, i, ctype))
                cur_start, cur_type = None, None
        elif not is_inside:
            cur_start, cur_type = None, None
        if scheme == "IOE" and ctype is not None and pos == 1:
            # an E- tag closes its chunk inclusively
            if cur_start is not None:
                chunks.append((cur_start, i, ctype))
                cur_start, cur_type = None, None
    if cur_start is not None:
        chunks.append((cur_start, len(tags) - 1, cur_type))
    return {c for c in chunks if c[2] not in excluded}


@register_op("chunk_eval", no_grad=True, is_host=True)
def chunk_eval(ctx, ins, attrs):
    """chunk_eval_op.cc: precision, recall and F1 of the chunks of
    ``Inference`` against ``Label`` over each row's first Length tags, and
    the three chunk counts. A host op: it reads its inputs on the host."""
    inference = ins["Inference"][0]
    device = inference.device
    inference = inference.detach().cpu().numpy()
    inference = inference.reshape(inference.shape[0], -1)
    label = ins["Label"][0].detach().cpu().numpy().reshape(inference.shape)
    b, t = inference.shape
    length = ins.get("Length")
    if length and length[0] is not None:
        length = length[0].detach().cpu().numpy().reshape(-1)
    else:
        length = np.full((b,), t, np.int64)
    scheme = attrs.get("chunk_scheme", "IOB")
    num_types = int(attrs.get("num_chunk_types", 1))
    excluded = set(attrs.get("excluded_chunk_types", []) or [])
    n_infer = n_label = n_correct = 0
    for row in range(b):
        li = int(length[row])
        ic = _chunks(inference[row, :li], scheme, num_types, excluded)
        lc = _chunks(label[row, :li], scheme, num_types, excluded)
        n_infer += len(ic)
        n_label += len(lc)
        n_correct += len(ic & lc)
    prec = n_correct / n_infer if n_infer else 0.0
    rec = n_correct / n_label if n_label else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    return {"Precision": [f32(prec)], "Recall": [f32(rec)],
            "F1-Score": [f32(f1)], "NumInferChunks": [i64(n_infer)],
            "NumLabelChunks": [i64(n_label)],
            "NumCorrectChunks": [i64(n_correct)]}



# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

NEG = -1e30   # the log of an impossible state


def _warpctc_infer(op: OpDesc, block):
    ls = in_shape(block, op, "Logits")
    if ls:
        for n in op.output("Loss"):
            set_out_var(block, n, [ls[0], 1], in_dtype(block, op, "Logits"))


def _shift(v, k):
    """``v`` [B, S] moved k places to the right along S, NEG shifted in."""
    return torch.cat([torch.full_like(v[:, :k], NEG), v[:, :-k]], dim=1)


@register_op("warpctc", infer=_warpctc_infer)
def warpctc(ctx, ins, attrs):
    """warpctc_op.cc: per row, -log p(label | logits) under CTC, from
    padded Logits [B, T, C] (``LogitsLength``) and Label [B, L]
    (``LabelLength``); divided by the logit length under
    ``norm_by_times``, as the JAX package does."""
    logits = ins["Logits"][0]
    label = ins["Label"][0]
    label = label.reshape(label.shape[0], -1).long()
    b, t, c = logits.shape
    n_lab = label.shape[1]
    blank = int(attrs.get("blank", 0))
    logit_len = length_or_full(ins, b, t, logits.device, "LogitsLength")
    label_len = length_or_full(ins, b, n_lab, logits.device, "LabelLength")

    logp = torch.log_softmax(logits, dim=-1)
    s_len = 2 * n_lab + 1
    # the extended label: blank, l1, blank, l2, ..., blank
    ext = torch.stack([torch.full_like(label, blank), label], dim=2)
    ext = torch.cat([ext.reshape(b, 2 * n_lab),
                     torch.full_like(label[:, :1], blank)], dim=1)
    hot = _one_hot(ext, c, logp.dtype)                      # [B, S, C]
    emit = torch.bmm(logp, hot.transpose(1, 2))             # [B, T, S]
    # a skip from s - 2 lands only on a label differing from the previous
    prev = torch.cat([torch.full_like(ext[:, :2], -1), ext[:, :-2]], dim=1)
    can_skip = ((torch.arange(s_len, device=logits.device) % 2 == 1)[None]
                & (ext != prev))

    first = torch.arange(s_len, device=logits.device) < 2
    alpha = torch.where(first[None], emit[:, 0], NEG)
    for ti in range(1, t):
        skip = torch.where(can_skip, _shift(alpha, 2), NEG)
        nxt = torch.logsumexp(torch.stack([alpha, _shift(alpha, 1), skip]),
                              dim=0) + emit[:, ti]
        alpha = torch.where((ti < logit_len)[:, None], nxt, alpha)
    # the paths end on the last label or the blank after it (read with a
    # compare and a sum, which hold the one value exactly)
    i_last = (2 * label_len).long()[:, None]
    states = torch.arange(s_len, device=logits.device)[None, :]
    a_end1 = torch.where(states == i_last, alpha, 0).sum(dim=1)
    a_end2 = torch.where(states == torch.clamp(i_last - 1, 0, s_len - 1),
                         alpha, 0).sum(dim=1)
    # an empty label has only the all-blank path
    a_end2 = torch.where(label_len > 0, a_end2, NEG)
    loss = -torch.logsumexp(torch.stack([a_end1, a_end2]), dim=0)
    loss = loss.reshape(b, 1)
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(logit_len, min=1).to(loss.dtype).reshape(
            b, 1)
    return {"Loss": [loss]}


def _ctc_align_infer(op: OpDesc, block):
    xs = in_shape(block, op, "Input")
    if xs is not None and len(xs) >= 2:
        for n in op.output("Output"):
            set_out_var(block, n, xs[:2], in_dtype(block, op, "Input"))
        for n in op.output("OutputLength"):
            set_out_var(block, n, [xs[0]], "int64")


@register_op("ctc_align", no_grad=True, infer=_ctc_align_infer)
def ctc_align(ctx, ins, attrs):
    """The greedy decode's post-processing: repeats merged, blanks
    dropped, each row compacted to the left in order (a stable sort of
    the 0/1 drop key) and filled with ``blank`` after its new length."""
    xv = ins["Input"][0]
    xv = xv.reshape(xv.shape[0], -1)
    b, t = xv.shape
    blank = int(attrs.get("blank", 0))
    length = length_or_full(ins, b, t, xv.device)
    valid = torch.arange(t, device=xv.device)[None, :] < length[:, None]
    prev = torch.cat([torch.full_like(xv[:, :1], -1), xv[:, :-1]], dim=1)
    keep = (xv != prev) & (xv != blank) & valid
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True)[1]
    compacted = torch.take_along_dim(xv, order, dim=1)
    new_len = keep.sum(dim=1)
    tail = torch.arange(t, device=xv.device)[None, :] >= new_len[:, None]
    return {"Output": [torch.where(tail, blank, compacted)],
            "OutputLength": [new_len.long()]}


def _edit_distance_infer(op: OpDesc, block):
    hs = in_shape(block, op, "Hyps")
    if hs:
        for n in op.output("Out"):
            set_out_var(block, n, [hs[0], 1], "float32")
    for n in op.output("SequenceNum"):
        set_out_var(block, n, [], "int64")


def edit_distance_fn(hyp, ref, hyp_len, ref_len):
    """Levenshtein distances [B] (float32) of hyp [B, T1] against ref
    [B, T2] over their first hyp_len and ref_len tokens. The table
    D[i, j] (the distance of hyp[:i] to ref[:j]) is walked by
    anti-diagonals k = i + j, each a vector over i: D on diagonal k needs
    only diagonals k - 1 and k - 2, so a step is seven kernels. The
    diagonals are stacked and each row's D[hyp_len, ref_len] read once at
    the end."""
    b, t1 = hyp.shape
    t2 = ref.shape[1]
    dev = hyp.device
    n_diag = t1 + t2 + 1
    inf = float("inf")
    i = torch.arange(t1 + 1, device=dev)[:, None]              # [T1 + 1, 1]
    k = torch.arange(n_diag, device=dev)[None, :]              # [1, K]
    j = k - i                                                   # the cell (i, j)
    # cost[b, i, k]: hyp[i - 1] != ref[j - 1], the diagonal move into (i, j)
    cost = (hyp[:, torch.clamp(i[:, 0] - 1, 0, max(t1 - 1, 0))][:, :, None]
            != ref[:, torch.clamp(j - 1, 0, max(t2 - 1, 0))]).to(torch.float32)
    # cells the recurrence does not set: the borders D[0, j] = j and
    # D[i, 0] = i (both k), +inf off the table
    on_table = (j >= 0) & (j <= t2)
    fixed = torch.where(((i == 0) | (j == 0)) & on_table,
                        k.to(torch.float32), inf)
    free = (i >= 1) & (j >= 1) & on_table

    def up(d):             # d[i - 1] at i, +inf at i = 0
        return torch.nn.functional.pad(d, (1, 0), value=inf)[:, :-1]

    diags = [fixed[:, 0].expand(b, -1)]
    d_prev2 = None
    for kk in range(1, n_diag):
        d_prev = diags[-1]
        cand = torch.minimum(up(d_prev), d_prev) + 1.0
        if d_prev2 is not None:
            cand = torch.minimum(cand, up(d_prev2) + cost[:, :, kk])
        diags.append(torch.where(free[:, kk], cand, fixed[:, kk]))
        d_prev2 = d_prev
    table = torch.stack(diags, dim=1)                           # [B, K, T1+1]
    hyp_len = hyp_len.long()
    return table[torch.arange(b, device=dev), hyp_len + ref_len.long(),
                 hyp_len]


@register_op("edit_distance", no_grad=True, infer=_edit_distance_infer)
def edit_distance(ctx, ins, attrs):
    """edit_distance_op.h: the Levenshtein distance of each hypothesis row
    to its reference row (``edit_distance_fn``), divided by max(ref
    length, 1) when ``normalized``; SequenceNum the batch size."""
    hyp = ins["Hyps"][0]
    ref = ins["Refs"][0]
    hyp = hyp.reshape(hyp.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    b, t1 = hyp.shape
    hyp_len = length_or_full(ins, b, t1, hyp.device, "HypsLength")
    ref_len = length_or_full(ins, b, ref.shape[1], hyp.device, "RefsLength")
    dist = edit_distance_fn(hyp, ref, hyp_len, ref_len)
    if attrs.get("normalized", True):
        dist = dist / torch.clamp(ref_len, min=1).to(dist.dtype)
    return {"Out": [dist.reshape(b, 1)],
            "SequenceNum": [torch.full((), b, dtype=torch.long,
                                       device=hyp.device)]}
