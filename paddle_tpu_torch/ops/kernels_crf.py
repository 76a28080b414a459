"""Structured-prediction ops (counterpart of ``paddle_tpu/ops/kernels_crf.py``):
the linear-chain CRF's negative log-likelihood, its Viterbi decode and
chunk evaluation.

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

