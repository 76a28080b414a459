"""Beam-search ops (counterpart of ``paddle_tpu/ops/kernels_search.py``:
beam_search_op.cc, beam_search_decode_op.cc).

The beam dimension is dense and static: hypotheses are [batch*beam]
rows, an ended hypothesis (its last id is ``end_id``) stays in the tensor
and extends only with ``end_id`` at its accumulated score, and the decode
op walks the parent pointers back over the [T, batch*beam] history.
"""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import register_op
from .common import in_shape, opt, set_out_var, top_k_total_order


def _beam_infer(op: OpDesc, block):
    ps = in_shape(block, op, "pre_ids")
    if ps is not None:
        for slot in ("selected_ids", "selected_scores", "parent_idx"):
            for n in op.output(slot):
                set_out_var(block, n, [ps[0]], None)


@register_op("beam_search", no_grad=True, infer=_beam_infer)
def beam_search(ctx, ins, attrs):
    """One beam step: from [batch*beam] hypotheses and their [batch*beam,
    K] candidates (ids, scores), the top ``beam_size`` continuations of
    each batch row over its beam*K candidates in ``lax.top_k``'s order
    (IEEE total order, equal scores in index order:
    ``common.top_k_total_order``). With
    ``is_accumulated`` false the scores are probabilities and accumulate
    as pre_score + log(score). An ended hypothesis offers one candidate,
    itself at its score; its other columns score ``finfo.min``."""
    pre_ids = ins["pre_ids"][0].reshape(-1)
    pre_scores = ins["pre_scores"][0].reshape(-1)
    cand_ids = ins["ids"][0]
    cand_scores = ins["scores"][0]
    beam = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    b = pre_ids.shape[0] // beam
    k = cand_ids.shape[-1]
    neg = torch.finfo(cand_scores.dtype).min

    ended = (pre_ids == end_id)[:, None]
    if attrs.get("is_accumulated", True):
        total = cand_scores
    else:
        total = pre_scores[:, None] + torch.log(cand_scores)
    first = torch.arange(k, device=total.device)[None, :] == 0
    total = torch.where(ended, torch.where(first, pre_scores[:, None], neg),
                        total)
    ids_eff = torch.where(ended, end_id, cand_ids)

    flat = total.reshape(b, beam * k)
    top_scores, top_idx = top_k_total_order(flat, beam)
    parent = (torch.arange(b, device=flat.device)[:, None] * beam
              + torch.div(top_idx, k, rounding_mode="floor"))
    sel_ids = torch.take_along_dim(ids_eff.reshape(b, beam * k), top_idx,
                                   dim=1)
    return {"selected_ids": [sel_ids.reshape(-1)],
            "selected_scores": [top_scores.reshape(-1)],
            "parent_idx": [parent.reshape(-1).to(torch.int32)]}


@register_op("beam_search_decode", no_grad=True)
def beam_search_decode(ctx, ins, attrs):
    """Backtrack the per-step (ids, parents) history [T, batch*beam] into
    sentences [batch*beam, T]: from each final row, step t's id is read
    at the pointer and the pointer moves to that row's parent. Past the
    second ``end_id`` of a sentence its positions read ``end_id`` (the
    JAX op's ``cumsum > 1`` rule). With Scores, SentenceScores is the
    last step's row."""
    ids = ins["Ids"][0]
    parents = ins["ParentIdx"][0].long()
    scores = opt(ins, "Scores")
    end_id = int(attrs.get("end_id", 0))
    t, rows = ids.shape
    ptr = torch.arange(rows, device=ids.device)
    toks = [None] * t
    for s in range(t - 1, -1, -1):
        toks[s] = ids[s].index_select(0, ptr)
        ptr = parents[s].index_select(0, ptr)
    sentences = torch.stack(toks, dim=1)
    seen_end = torch.cumsum((sentences == end_id).to(torch.int32), dim=1) > 1
    sentences = torch.where(seen_end, end_id, sentences)
    outs = {"SentenceIds": [sentences]}
    if scores is not None:
        outs["SentenceScores"] = [scores[-1].reshape(-1)]
    return outs
