"""The ops of ``paddle_tpu/ops/kernels_dist.py`` that need no mesh: the
SelectedRows and sparse-table compatibility ops, and the RNN memory
helper. Gradients are dense in both packages (no SelectedRows), so the
container ops are identities or row splits by ``height_sections``, and
``lookup_sparse_table`` is a lookup in a table of fixed size
(reference split_selected_rows_op.cc, merge_selected_rows_op.cc,
lookup_sparse_table_op.cc, distributed_ops/ref_by_trainer_id_op.cc,
rnn_memory_helper_op.cc).

The collectives, the parameter-server ops and the sequence-parallel
attentions wait for the multi-device slice (ROADMAP A12)."""

from __future__ import annotations

import torch

from ..core.desc import OpDesc
from ..registry import register_op
from .common import (in_dtype, in_shape, same_shape_infer, set_out_var,
                     slots_like_infer, x)


@register_op("merge_selected_rows", no_grad=True, infer=same_shape_infer())
def merge_selected_rows_op(ctx, ins, attrs):
    return {"Out": [x(ins)]}


@register_op("get_tensor_from_selected_rows", no_grad=True,
             infer=same_shape_infer())
def get_tensor_from_selected_rows_op(ctx, ins, attrs):
    return {"Out": [x(ins)]}


@register_op("split_selected_rows", no_grad=True)
def split_selected_rows_op(ctx, ins, attrs):
    """Row slices of X by ``height_sections``, which must cover it."""
    xv = x(ins)
    sections = [int(s) for s in attrs.get("height_sections", [])]
    if not sections or sum(sections) != int(xv.shape[0]):
        raise ValueError(
            f"split_selected_rows: height_sections {sections} must be "
            f"non-empty and sum to the input height {xv.shape[0]}")
    return {"Out": list(torch.split(xv, sections, dim=0))}


@register_op("split_byref", no_grad=True)
def split_byref_op(ctx, ins, attrs):
    return split_selected_rows_op(ctx, ins, attrs)


def _lookup_infer(op: OpDesc, block):
    ids = in_shape(block, op, "Ids")
    w = in_shape(block, op, "W")
    if ids is None or w is None or len(w) < 2:
        return
    shape = list(ids[:-1]) if ids and ids[-1] == 1 else list(ids)
    for n in op.output("Out"):
        set_out_var(block, n, shape + [w[1]], in_dtype(block, op, "W"))


@register_op("lookup_sparse_table", no_grad=True, infer=_lookup_infer)
def lookup_sparse_table_op(ctx, ins, attrs):
    """The rows of W at the flattened Ids, [N, D]."""
    ids = ins["Ids"][0].reshape(-1).long()
    return {"Out": [torch.index_select(ins["W"][0], 0, ids)]}


@register_op("ref_by_trainer_id", no_grad=True, is_host=True,
             infer=same_shape_infer())
def ref_by_trainer_id_op(ctx, ins, attrs):
    """This trainer's entry of the list X, picked by TrainerId (read on
    the host)."""
    tid = int(ins["TrainerId"][0].reshape(-1)[0])
    return {"Out": [ins["X"][tid]]}


@register_op("rnn_memory_helper", infer=same_shape_infer())
def rnn_memory_helper_op(ctx, ins, attrs):
    """The identity the reference's RNN programs thread state through."""
    return {"Out": [x(ins)]}


@register_op("rnn_memory_helper_grad", no_grad=True,
             infer=slots_like_infer(("X@GRAD", "X")))
def rnn_memory_helper_grad_op(ctx, ins, attrs):
    """Out@GRAD passes to X@GRAD unchanged."""
    g = (ins.get("Out@GRAD") or [None])[0]
    return {"X@GRAD": [g]}
