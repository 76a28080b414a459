"""The static rules of the ops whose emitters the verifier cannot evaluate
or whose outputs mirror their inputs (counterpart of the JAX package's
per-family ``_infer_of(...)`` blocks in ``paddle_tpu/ops``): opaque
declarations for host, control-flow, LoDTensorArray and data-dependent
ops, and the name-for-name rules of grad and fused-update ops. The
port's own grad ops (``conv2d_grad``, ``depthwise_conv2d_grad``,
``flash_attention_grad``) keep no rule, as the JAX package's generic
twins have none; the verifier's structural grad rule covers them.
"""

from ..core.types import GRAD_SUFFIX as G
from ..registry import register_infer_shape
from .common import dtype_only_infer, opaque_infer, slots_like_infer

_OPAQUE = {
    "host-side I/O or effect": (
        "save", "load", "save_combine", "load_combine", "print", "py_func",
        "feed", "get_places", "delete_var", "create_py_reader", "read",
        "chunk_eval", "precision_recall", "detection_map"),
    "control flow: the sub-block is checked on its own": (
        "while", "while_grad", "conditional_block", "recurrent"),
    "LoDTensorArray plumbing": (
        "array_write", "array_read", "write_to_array", "read_from_array",
        "tensor_array_to_tensor", "lod_tensor_to_array",
        "array_to_lod_tensor", "shrink_rnn_memory", "split_lod_tensor",
        "merge_lod_tensor", "lod_rank_table", "beam_search_decode"),
    "data-dependent extents": (
        "range", "hash", "sequence_expand", "sequence_concat",
        "sequence_slice", "sequence_erase", "attention_lstm", "lstmp",
        "target_assign", "mine_hard_examples", "multiclass_nms",
        "generate_proposals", "rpn_target_assign",
        "generate_proposal_labels", "generate_mask_labels",
        "distribute_fpn_proposals", "collect_fpn_proposals",
        "box_decoder_and_assign", "retinanet_target_assign",
        "retinanet_detection_output", "split_byref", "split_selected_rows"),
}

for _reason, _types in _OPAQUE.items():
    for _t in _types:
        register_infer_shape(_t)(opaque_infer(_reason))

register_infer_shape("dropout_grad")(slots_like_infer(("X" + G, "Out" + G)))
register_infer_shape("softmax_with_cross_entropy_grad")(
    slots_like_infer(("Logits" + G, "Logits")))
register_infer_shape("lookup_table_grad")(slots_like_infer(("W" + G, "W")))
register_infer_shape("fused_sgd")(slots_like_infer(("ParamOut", "Param")))
register_infer_shape("fused_momentum")(slots_like_infer(
    ("ParamOut", "Param"), ("VelocityOut", "Velocity")))
register_infer_shape("fused_adam")(slots_like_infer(
    ("ParamOut", "Param"), ("Moment1Out", "Moment1"),
    ("Moment2Out", "Moment2"), ("Beta1PowOut", "Beta1Pow"),
    ("Beta2PowOut", "Beta2Pow")))
register_infer_shape("fusion_transpose_flatten_concat")(dtype_only_infer())
