"""The detection ops of the port against the JAX package, on the CPU.

- **Ops.** Each of the 33 types this family adds (``smooth_l1_loss``,
  ``sigmoid_cross_entropy_with_logits``, the three resize types, the 26
  detection types, ``generate_mask_labels`` and
  ``distribute_fpn_proposals``) runs through both packages' emitters on the
  same numpy-seeded inputs. Integer outputs are equal and carry the dtype
  the JAX op gives (int32); float outputs agree within FWD_REL of each
  output's largest magnitude, except the rows of ``LOOSE``, whose bound
  and reason are stated there. The NMS types are held on inputs with tied
  scores (``lax.top_k``'s order) and with the eta-adaptive threshold;
  ``mine_hard_examples`` on tied losses (a stable sort);
  ``bipartite_match`` on a tied maximum (the first one); ``yolov3_loss``
  on two gts sharing a cell (the later one wins).
- **Gradients.** Each gradful type's generic vjp against the JAX
  package's on the same cotangents, within GRAD_REL of each gradient's
  largest magnitude (or the ``LOOSE`` bound).
- **The random ops.** ``rpn_target_assign`` and
  ``generate_proposal_labels`` draw priorities from different streams in
  the two packages; where the budget exceeds the candidates sampling keeps
  them all and the outputs are equal; elsewhere the counts stay within
  budget, the sampled rows are candidates and their targets are the JAX
  arithmetic's on those rows.
- **The host ops.** ``detection_map`` equal to the JAX op and to
  ``metrics.DetectionMAP``; ``generate_mask_labels`` and
  ``distribute_fpn_proposals`` equal to the JAX ops.
- **Layers.** A program of every detection layer and the resize layers,
  byte-identical to the JAX package's.
- **The JAX OpTests** of tests/test_ops_detection.py through the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.metrics import DetectionMAP
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

import test_ops_detection as jdet
from test_torch_sequence import _vjp_both, run_optest_on_port

FWD_REL = 1e-6
GRAD_REL = 1e-6

# The 33 types of this family, in the order of the JAX files.
NEW_DETECTION = (
    "smooth_l1_loss", "sigmoid_cross_entropy_with_logits",
    "interpolate", "bilinear_interp", "nearest_interp",
    "iou_similarity", "box_coder", "prior_box", "density_prior_box",
    "anchor_generator", "box_clip", "polygon_box_transform", "roi_pool",
    "roi_align", "psroi_pool", "bipartite_match", "target_assign",
    "mine_hard_examples", "multiclass_nms", "detection_map",
    "yolov3_loss", "generate_proposals", "rpn_target_assign",
    "roi_perspective_transform", "generate_proposal_labels", "yolo_box",
    "sigmoid_focal_loss", "box_decoder_and_assign",
    "collect_fpn_proposals", "retinanet_target_assign",
    "retinanet_detection_output", "generate_mask_labels",
    "distribute_fpn_proposals")

# case id -> (forward bound, gradient bound): sums in another order
LOOSE = {
    # the bilinear samples are two matrix products (sums over a row and a
    # column in the library's order) against the JAX package's four
    # products and a mean per bin
    "roi_align": (2e-6, 2e-6), "roi_align_ratio3": (2e-6, 2e-6),
    # the bin sums are a batched matrix product against an einsum
    "psroi_pool": (2e-6, 2e-6),
    # all gts' terms summed at once against a scan's running sum; the
    # class terms of a gt summed by another reduction order
    "yolov3_loss": (2e-6, 2e-6), "yolov3_loss_score": (2e-6, 2e-6),
    # log_sigmoid: torch's logsigmoid kernel against jax.nn.log_sigmoid
    "sigmoid_focal_loss": (2e-6, 2e-6),
}


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _rng(seed):
    return np.random.RandomState(seed)


def _jctx():
    import jax
    return jreg.EmitContext(rng=jax.random.PRNGKey(0))


def _pctx(seed=0):
    return preg.EmitContext(torch.device("cpu"),
                            generator=torch.Generator().manual_seed(seed))


def run_both(op_type, ins, attrs, seed=0):
    """One op through both packages' emitters on numpy inputs; returns
    ({slot: [numpy]}, {slot: [numpy]}) of JAX and the port."""
    jouts = jreg.lookup(op_type).emitter(
        _jctx(), {s: [None if a is None else jnp.asarray(a) for a in v]
                  for s, v in ins.items()}, attrs)
    pouts = preg.lookup(op_type).emitter(
        _pctx(seed), {s: [None if a is None else torch.from_numpy(
            np.array(a)) for a in v] for s, v in ins.items()}, attrs)
    return ({s: [np.asarray(v) for v in vs] for s, vs in jouts.items()},
            {s: [v.numpy() for v in vs] for s, vs in pouts.items()})


def assert_outputs_match(j, p, rel=FWD_REL, slots=None):
    for slot in slots or j:
        assert len(p[slot]) == len(j[slot]), slot
        for want, got in zip(j[slot], p[slot]):
            assert got.shape == want.shape, (slot, got.shape, want.shape)
            if want.dtype.kind in "iub":
                assert got.dtype == want.dtype, (slot, got.dtype, want.dtype)
                assert got.tolist() == want.tolist(), slot
            else:
                assert got.dtype == want.dtype, (slot, got.dtype)
                top = float(np.abs(want).max()) if want.size else 0.0
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=rel * max(top, 1e-30),
                                           err_msg=slot)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _boxes(rng, shape, span=1.0, min_side=0.05, max_side=0.4):
    """x1, y1, x2, y2 boxes inside [0, span]."""
    lo = rng.uniform(0, span * (1 - max_side), size=shape + (2,))
    side = rng.uniform(span * min_side, span * max_side, size=shape + (2,))
    return np.concatenate([lo, lo + side], -1).astype(np.float32)


def _f(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _match(rng, b, m, n):
    mi = rng.randint(-1, n, size=(b, m)).astype(np.int32)
    mi[rng.rand(b, m) < 0.4] = -1
    return mi


def _rois(rng, n, h, w, scale):
    """Image-space rois on an [h, w] map at ``spatial_scale``."""
    x1 = rng.uniform(0, w * 0.6, n)
    y1 = rng.uniform(0, h * 0.6, n)
    x2 = x1 + rng.uniform(1.0, w * 0.4, n)
    y2 = y1 + rng.uniform(1.0, h * 0.4, n)
    return (np.stack([x1, y1, x2, y2], 1) / scale).astype(np.float32)


def _quads(rng, n, h, w):
    """Convex quadrilaterals [n, 8] (clockwise from the top left)."""
    cx = rng.uniform(w * 0.3, w * 0.7, n)
    cy = rng.uniform(h * 0.3, h * 0.7, n)
    pts = []
    for ang in (225, 315, 45, 135):
        r = rng.uniform(2.0, 4.0, n)
        pts += [cx + r * np.cos(np.radians(ang)),
                cy + r * np.sin(np.radians(ang))]
    return np.stack(pts, 1).astype(np.float32)


def _anchors(fh, fw, sizes=(16.0, 32.0), ratios=(0.5, 1.0, 2.0),
             stride=(8.0, 8.0)):
    outs = preg.lookup("anchor_generator").emitter(
        _pctx(), {"Input": [torch.zeros(1, 1, fh, fw)]},
        {"anchor_sizes": list(sizes), "aspect_ratios": list(ratios),
         "stride": list(stride)})
    return outs["Anchors"][0].numpy(), outs["Variances"][0].numpy()


def _nms_scores(rng, b, c, m, ties=False):
    s = rng.rand(b, c, m).astype(np.float32)
    if ties:
        s[:, :, 1::3] = s[:, :, 0::3][:, :, :s[:, :, 1::3].shape[2]]
        s[:, :, 5] = 0.5
        s[:, :, 6] = 0.5
    return s


def _yolo_gt(rng, n, b, w=5, h=5):
    gt = np.zeros((n, b, 4), np.float32)
    gt[:, :4, :2] = rng.uniform(0.05, 0.95, (n, 4, 2))
    gt[:, :4, 2:] = rng.uniform(0.05, 0.6, (n, 4, 2))
    # gt 4 repeats gt 1's centre cell and shape: the later one wins
    gt[:, 4] = gt[:, 1] + np.array([0.01 / w, 0.01 / h, 0.0, 0.0])
    return gt


_R = _rng(2024)
_ANC, _VAR = _anchors(4, 5)

CASES = [
    ("smooth_l1", "smooth_l1_loss",
     {"X": [_f(_rng(1), 6, 4)], "Y": [_f(_rng(2), 6, 4)],
      "InsideWeight": [_rng(3).randint(0, 2, (6, 4)).astype(np.float32)],
      "OutsideWeight": [_rng(4).rand(6, 4).astype(np.float32)]},
     {"sigma": 3.0}, True),
    ("smooth_l1_plain", "smooth_l1_loss",
     {"X": [_f(_rng(5), 5, 2, 3)], "Y": [_f(_rng(6), 5, 2, 3)]}, {}, True),
    ("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
     {"X": [_f(_rng(7), 5, 7, scale=3.0)],
      "Label": [np.where(_rng(8).rand(5, 7) < 0.2, -100.0,
                         _rng(9).rand(5, 7)).astype(np.float32)]},
     {"ignore_index": -100}, True),
    ("bilinear_ac", "interpolate", {"X": [_f(_rng(10), 2, 3, 5, 7)]},
     {"out_h": 9, "out_w": 4, "interp_method": "bilinear",
      "align_corners": True}, True),
    ("bilinear_half_pixel", "interpolate", {"X": [_f(_rng(11), 2, 3, 5, 7)]},
     {"out_h": 8, "out_w": 12, "interp_method": "bilinear",
      "align_corners": False}, True),
    ("nearest_ac", "interpolate", {"X": [_f(_rng(12), 2, 3, 4, 6)]},
     {"out_h": 7, "out_w": 11, "interp_method": "nearest",
      "align_corners": True}, True),
    ("nearest_x2", "nearest_interp", {"X": [_f(_rng(13), 2, 3, 4, 5)]},
     {"out_h": 8, "out_w": 10, "align_corners": False}, True),
    ("bilinear_interp_to_1", "bilinear_interp",
     {"X": [_f(_rng(14), 1, 2, 5, 6)]},
     {"out_h": 1, "out_w": 3, "align_corners": True}, True),
    ("iou", "iou_similarity",
     {"X": [_boxes(_rng(15), (5,))], "Y": [_boxes(_rng(16), (7,))]}, {},
     False),
    ("encode_var_input", "box_coder",
     {"PriorBox": [_boxes(_rng(17), (6,))],
      "PriorBoxVar": [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (6, 1))],
      "TargetBox": [_boxes(_rng(18), (6,))]},
     {"code_type": "encode_center_size"}, False),
    ("encode_3d_var_attr", "box_coder",
     {"PriorBox": [_boxes(_rng(19), (6,))],
      "TargetBox": [_boxes(_rng(20), (2, 6))]},
     {"code_type": "encode_center_size", "variance": [0.1, 0.1, 0.2, 0.2]},
     False),
    ("decode_3d", "box_coder",
     {"PriorBox": [_boxes(_rng(21), (6,))],
      "PriorBoxVar": [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (6, 1))],
      "TargetBox": [_f(_rng(22), 2, 6, 4)]},
     {"code_type": "decode_center_size"}, False),
    ("prior_box", "prior_box",
     {"Input": [np.zeros((1, 2, 4, 5), np.float32)],
      "Image": [np.zeros((1, 3, 40, 50), np.float32)]},
     {"min_sizes": [8.0, 16.0], "max_sizes": [12.0, 24.0],
      "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True,
      "variances": [0.1, 0.1, 0.2, 0.2]}, False),
    ("prior_box_mmo_steps", "prior_box",
     {"Input": [np.zeros((1, 2, 3, 3), np.float32)],
      "Image": [np.zeros((1, 3, 30, 30), np.float32)]},
     {"min_sizes": [6.0], "max_sizes": [14.0], "aspect_ratios": [2.0],
      "flip": False, "step_w": 9.0, "step_h": 11.0, "offset": 0.25,
      "min_max_aspect_ratios_order": True}, False),
    ("density_prior_box", "density_prior_box",
     {"Input": [np.zeros((1, 2, 3, 4), np.float32)],
      "Image": [np.zeros((1, 3, 24, 32), np.float32)]},
     {"fixed_sizes": [8.0, 16.0], "fixed_ratios": [1.0, 2.0],
      "densities": [2, 1], "clip": True}, False),
    ("anchor_generator", "anchor_generator",
     {"Input": [np.zeros((1, 2, 3, 4), np.float32)]},
     {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
      "stride": [16.0, 16.0], "offset": 0.5}, False),
    ("box_clip", "box_clip",
     {"Input": [(_rng(23).rand(2, 5, 4) * 80 - 10).astype(np.float32)],
      "ImInfo": [np.float32([[40, 50, 1]])]}, {}, False),
    ("polygon_box_transform", "polygon_box_transform",
     {"Input": [_f(_rng(24), 2, 8, 3, 4)]}, {}, False),
    ("box_decoder_and_assign", "box_decoder_and_assign",
     {"PriorBox": [_boxes(_rng(25), (6,), span=60.0)],
      "PriorBoxVar": [np.float32([0.1, 0.1, 0.2, 0.2])],
      "TargetBox": [_f(_rng(26), 6, 12)],
      "BoxScore": [np.float32(_rng(27).randint(0, 3, (6, 3)))]},
     {"box_clip": 4.135}, False),
    ("bipartite", "bipartite_match",
     {"DistMat": [np.where(_rng(28).rand(2, 4, 9) < 0.3, 0.0,
                           _rng(29).rand(2, 4, 9)).astype(np.float32)]},
     {}, False),
    ("bipartite_per_prediction", "bipartite_match",
     {"DistMat": [_rng(30).rand(3, 5, 11).astype(np.float32)]},
     {"match_type": "per_prediction", "dist_threshold": 0.3}, False),
    ("bipartite_2d_tie", "bipartite_match",
     {"DistMat": [np.float32([[0.2, 0.9, 0.9, 0.1],
                              [0.9, 0.3, 0.0, 0.5],
                              [0.0, 0.0, 0.0, 0.0]])]},
     {"match_type": "per_prediction", "dist_threshold": 0.25}, False),
    ("target_assign_box", "target_assign",
     {"X": [_f(_rng(31), 2, 4, 4)], "MatchIndices": [_match(_rng(32), 2, 9, 4)]},
     {"mismatch_value": 0}, False),
    ("target_assign_label", "target_assign",
     {"X": [_rng(33).randint(1, 5, (2, 4, 1)).astype(np.int32)],
      "MatchIndices": [_match(_rng(34), 2, 9, 4)]},
     {"mismatch_value": 0}, False),
    ("mine", "mine_hard_examples",
     {"ClsLoss": [_rng(35).rand(2, 12).astype(np.float32)],
      "MatchIndices": [_match(_rng(36), 2, 12, 3)],
      "MatchDist": [_rng(37).rand(2, 12).astype(np.float32)]},
     {"neg_pos_ratio": 3.0, "neg_overlap": 0.5}, False),
    ("mine_ties_loc", "mine_hard_examples",
     {"ClsLoss": [np.round(_rng(38).rand(3, 16), 1).astype(np.float32)],
      "LocLoss": [np.zeros((3, 16), np.float32)],
      "MatchIndices": [_match(_rng(39), 3, 16, 2)]},
     {"neg_pos_ratio": 2.5, "neg_overlap": 0.5}, False),
    ("nms", "multiclass_nms",
     {"BBoxes": [_boxes(_rng(40), (2, 20))],
      "Scores": [_nms_scores(_rng(41), 2, 4, 20)]},
     {"background_label": 0, "score_threshold": 0.1, "nms_threshold": 0.3,
      "nms_top_k": 10, "keep_top_k": 40}, False),
    ("nms_ties_eta", "multiclass_nms",
     {"BBoxes": [_boxes(_rng(42), (2, 24), max_side=0.6)],
      "Scores": [_nms_scores(_rng(43), 2, 3, 24, ties=True)]},
     {"background_label": 0, "score_threshold": 0.05,
      "nms_threshold": 0.6, "nms_top_k": 20, "keep_top_k": 60,
      "nms_eta": 0.8}, False),
    ("nms_no_background", "multiclass_nms",
     {"BBoxes": [_boxes(_rng(44), (1, 16))],
      "Scores": [_nms_scores(_rng(45), 1, 3, 16)]},
     {"background_label": -1, "score_threshold": 0.0, "nms_threshold": 0.4,
      "nms_top_k": 30, "keep_top_k": 100}, False),
    ("generate_proposals", "generate_proposals",
     {"Scores": [_rng(46).rand(2, 6, 4, 5).astype(np.float32)],
      "BboxDeltas": [_f(_rng(47), 2, 24, 4, 5, scale=0.5)],
      "ImInfo": [np.float32([[32, 40, 1.0], [30, 36, 1.5]])],
      "Anchors": [_ANC], "Variances": [_VAR]},
     {"pre_nms_topN": 60, "post_nms_topN": 25, "nms_thresh": 0.5,
      "min_size": 2.0}, False),
    ("collect_fpn", "collect_fpn_proposals",
     {"MultiLevelRois": [_boxes(_rng(48), (5,), 50.0),
                         _boxes(_rng(49), (7,), 50.0)],
      "MultiLevelScores": [_rng(50).rand(5, 1).astype(np.float32),
                           _rng(51).rand(7, 1).astype(np.float32)]},
     {"post_nms_topN": 8}, False),
    ("collect_fpn_pad", "collect_fpn_proposals",
     {"MultiLevelRois": [_boxes(_rng(52), (3,), 50.0)],
      "MultiLevelScores": [_rng(53).rand(3, 1).astype(np.float32)]},
     {"post_nms_topN": 6}, False),
    ("retinanet_output", "retinanet_detection_output",
     {"BBoxes": [_f(_rng(54), 2, 12, 4, scale=0.2),
                 _f(_rng(55), 2, 6, 4, scale=0.2)],
      "Scores": [_f(_rng(56), 2, 12, 3), _f(_rng(57), 2, 6, 3)],
      "Anchors": [_boxes(_rng(58), (12,), 60.0),
                  _boxes(_rng(59), (6,), 60.0)],
      "ImInfo": [np.float32([[64, 64, 1], [48, 56, 1]])]},
     {"score_threshold": 0.3, "nms_top_k": 8, "keep_top_k": 10,
      "nms_threshold": 0.4}, False),
    ("roi_pool", "roi_pool",
     {"X": [_f(_rng(60), 2, 3, 12, 14)],
      "ROIs": [_rois(_rng(61), 5, 12, 14, 0.5)],
      "RoisBatch": [np.int32([0, 1, 1, 0, 1])]},
     {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5}, True),
    ("roi_align", "roi_align",
     {"X": [_f(_rng(62), 2, 3, 12, 14)],
      "ROIs": [_rois(_rng(63), 5, 12, 14, 0.5)],
      "RoisBatch": [np.int32([1, 0, 1, 1, 0])]},
     {"pooled_height": 3, "pooled_width": 4, "spatial_scale": 0.5,
      "sampling_ratio": -1}, True),
    ("roi_align_ratio3", "roi_align",
     {"X": [_f(_rng(64), 1, 2, 9, 11)],
      "ROIs": [np.concatenate([_rois(_rng(65), 3, 9, 11, 1.0),
                               np.float32([[-1.5, -1.0, 3.0, 2.0]])])]},
     {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0,
      "sampling_ratio": 3}, True),
    ("psroi_pool", "psroi_pool",
     {"X": [_f(_rng(66), 2, 12, 12, 14)],
      "ROIs": [_rois(_rng(67), 4, 12, 14, 0.5)],
      "RoisBatch": [np.int32([0, 1, 0, 1])]},
     {"output_channels": 2, "pooled_height": 2, "pooled_width": 3,
      "spatial_scale": 0.5}, True),
    ("roi_perspective", "roi_perspective_transform",
     {"X": [_f(_rng(68), 2, 3, 12, 14)], "ROIs": [_quads(_rng(69), 3, 12, 14)],
      "RoisBatch": [np.int32([1, 0, 1])]},
     {"transformed_height": 4, "transformed_width": 5,
      "spatial_scale": 1.0}, False),
    ("proposal_labels_ordered", "generate_proposal_labels",
     {"RpnRois": [_boxes(_rng(70), (20,), 60.0)],
      "GtClasses": [np.int32([[3], [1], [2]])],
      "IsCrowd": [np.int32([[0], [1], [0]])],
      "GtBoxes": [_boxes(_rng(71), (3,), 40.0)],
      "ImInfo": [np.float32([[64, 64, 1.5]])]},
     {"batch_size_per_im": 16, "fg_fraction": 0.25, "fg_thresh": 0.3,
      "bg_thresh_hi": 0.3, "bg_thresh_lo": 0.0, "class_nums": 4,
      "use_random": False}, False),
    ("proposal_labels_pad", "generate_proposal_labels",
     {"RpnRois": [_boxes(_rng(72), (4,), 60.0)],
      "GtClasses": [np.int32([[2], [1]])], "IsCrowd": [np.int32([[0], [0]])],
      "GtBoxes": [_boxes(_rng(73), (2,), 40.0)],
      "ImInfo": [np.float32([[64, 64, 1.0]])]},
     {"batch_size_per_im": 12, "fg_thresh": 0.5, "class_nums": 3,
      "use_random": False}, False),
    ("retinanet_assign", "retinanet_target_assign",
     {"Anchor": [_boxes(_rng(74), (30,), 50.0, max_side=0.5)],
      "GtBoxes": [_boxes(_rng(75), (3,), 50.0, max_side=0.5)],
      "GtLabels": [np.int32([[2], [1], [3]])],
      "IsCrowd": [np.int32([0, 0, 1])],
      "ImInfo": [np.float32([[50, 50, 1]])]},
     {"positive_overlap": 0.4, "negative_overlap": 0.2}, False),
    ("sigmoid_focal_loss", "sigmoid_focal_loss",
     {"X": [_f(_rng(76), 10, 4, scale=2.0)],
      "Label": [np.int32(_rng(77).randint(-1, 5, (10, 1)))],
      "FgNum": [np.int32([3])]},
     {"gamma": 2.0, "alpha": 0.25}, True),
    ("yolov3_loss", "yolov3_loss",
     {"X": [_f(_rng(78), 2, 3 * 9, 5, 5)], "GTBox": [_yolo_gt(_rng(79), 2, 6)],
      "GTLabel": [np.int32(_rng(80).randint(0, 4, (2, 6)))]},
     {"anchors": [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                  156, 198, 373, 326],
      "anchor_mask": [6, 7, 8], "class_num": 4, "ignore_thresh": 0.5,
      "downsample_ratio": 32}, True),
    ("yolov3_loss_score", "yolov3_loss",
     {"X": [_f(_rng(81), 2, 3 * 7, 5, 5)], "GTBox": [_yolo_gt(_rng(82), 2, 5)],
      "GTLabel": [np.int32(_rng(83).randint(0, 2, (2, 5)))],
      "GTScore": [_rng(84).rand(2, 5).astype(np.float32)]},
     {"anchors": [4, 6, 8, 10, 40, 20, 10, 30, 50, 60, 80, 90],
      "anchor_mask": [0, 1, 3], "class_num": 2, "ignore_thresh": 0.3,
      "downsample_ratio": 16, "use_label_smooth": True}, True),
    ("yolo_box", "yolo_box",
     {"X": [_f(_rng(85), 2, 3 * 9, 4, 4)],
      "ImgSize": [np.int32([[128, 128], [96, 112]])]},
     {"anchors": [10, 13, 16, 30, 33, 23], "class_num": 4,
      "conf_thresh": 0.5, "downsample_ratio": 32}, False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_detection_op_matches_jax(case):
    name, op_type, ins, attrs, _ = case
    j, p = run_both(op_type, ins, attrs)
    assert sorted(p) == sorted(j)
    assert_outputs_match(j, p, rel=LOOSE.get(name, (FWD_REL,))[0])


GRAD_CASES = [c for c in CASES if c[4]]


def test_every_gradful_type_has_a_vjp_case():
    gradful = {t for t in NEW_DETECTION if not preg.lookup(t).no_grad}
    assert gradful == {c[1] for c in GRAD_CASES}


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_detection_op_vjp_matches_jax(case):
    name, op_type, ins, attrs, _ = case
    jouts, pouts = _vjp_both(op_type, ins, attrs, seed=100)
    rel = LOOSE.get(name, (0, GRAD_REL))[1]
    checked = 0
    for slot, vals in ins.items():
        for i, v in enumerate(vals):
            g = slot + "@GRAD"
            if np.asarray(v).dtype.kind != "f":
                assert pouts[g][i] is None, g
                continue
            want = np.asarray(jouts[g][i])
            got = pouts[g][i].numpy()
            assert got.shape == want.shape, g
            top = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=rel * max(top, 1e-30),
                                       err_msg=g)
            checked += 1
    assert checked


def test_nms_cases_keep_and_suppress():
    """The NMS cases are not vacuous: each keeps rows and suppresses
    some, and the tie case ranks equal scores by index."""
    for name in ("nms", "nms_ties_eta", "nms_no_background"):
        case = next(c for c in CASES if c[0] == name)
        _, p = run_both(case[1], case[2], case[3])
        out = p["Out"][0]
        kept = (out[..., 0] >= 0).sum()
        assert 0 < kept < out.shape[0] * out.shape[1], name


def test_yolov3_loss_later_gt_wins_a_shared_cell():
    case = next(c for c in CASES if c[0] == "yolov3_loss_score")
    ins = dict(case[2])
    ins["GTBox"] = [ins["GTBox"][0].copy()]
    j, p = run_both("yolov3_loss", ins, case[3])
    assert_outputs_match(j, p, rel=2e-6)
    obj = p["ObjectnessMask"][0]
    score = ins["GTScore"][0]
    matched = p["GTMatchMask"][0] >= 0
    for n in range(2):
        if matched[n, 1] and matched[n, 4]:
            assert score[n, 4] in obj[n] and score[n, 1] not in obj[n]


# ---------------------------------------------------------------------------
# the random ops
# ---------------------------------------------------------------------------

def _rpn_ins(seed, n_anchor=40, n_gt=3):
    rng = _rng(seed)
    return {"Anchor": [_boxes(rng, (n_anchor,), 64.0, max_side=0.5)],
            "GtBoxes": [_boxes(rng, (n_gt,), 64.0, max_side=0.5)]}


def test_rpn_target_assign_exact_when_the_budget_keeps_all():
    ins = _rpn_ins(90)
    attrs = {"rpn_batch_size_per_im": 512, "rpn_fg_fraction": 0.5,
             "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.2}
    j, p = run_both("rpn_target_assign", ins, attrs)
    assert_outputs_match(j, p)
    assert (p["TargetLabel"][0] == 1).any() and (p["TargetLabel"][0] == 0).any()


def test_rpn_target_assign_samples_within_budget():
    ins = _rpn_ins(91, n_anchor=200)
    attrs = {"rpn_batch_size_per_im": 16, "rpn_fg_fraction": 0.25,
             "rpn_positive_overlap": 0.4, "rpn_negative_overlap": 0.3}
    big = dict(attrs, rpn_batch_size_per_im=10 ** 6, rpn_fg_fraction=0.5)
    j_all, p_all = run_both("rpn_target_assign", ins, big)
    assert_outputs_match(j_all, p_all)
    for seed in (0, 1, 2):
        _, p = run_both("rpn_target_assign", ins, attrs, seed=seed)
        lab = p["TargetLabel"][0]
        cand = p_all["TargetLabel"][0]
        assert (lab == 1).sum() <= 4 and (lab >= 0).sum() <= 16
        # sampled rows are candidates of their class
        assert np.all(cand[lab == 1] == 1) and np.all(cand[lab == 0] == 0)
        assert (lab == 0).sum() == min((cand == 0).sum(),
                                       16 - (lab == 1).sum())
        # targets on the sampled fg rows are the unsampled arithmetic's
        fg = lab == 1
        np.testing.assert_array_equal(p["TargetBBox"][0][fg],
                                      p_all["TargetBBox"][0][fg])
        assert not p["TargetBBox"][0][~fg].any()
        assert p["LocationIndex"][0].tolist() == fg.astype(np.int32).tolist()
        assert p["ScoreIndex"][0].tolist() == (lab >= 0).astype(
            np.int32).tolist()


def test_generate_proposal_labels_random_sampling():
    case = next(c for c in CASES if c[0] == "proposal_labels_ordered")
    ins, attrs = case[2], dict(case[3], use_random=True)
    for seed in (0, 1, 2):
        _, p = run_both("generate_proposal_labels", ins, attrs, seed=seed)
        labels = p["LabelsInt32"][0]
        rois = p["Rois"][0]
        assert labels.shape == (16,) and rois.shape == (16, 4)
        assert (labels > 0).sum() <= 4
        valid = labels >= 0
        # fg rows first, then bg rows, then padding
        order = np.where(labels > 0, 0, np.where(labels == 0, 1, 2))
        assert np.all(np.diff(order) >= 0)
        # each sampled row is a proposal (or gt) of the input
        boxes = np.concatenate([ins["GtBoxes"][0],
                                ins["RpnRois"][0] / 1.5]) * 1.5
        for r in rois[valid]:
            assert np.isclose(boxes, r, rtol=0, atol=1e-4).all(1).any()
        w = p["BboxInsideWeights"][0]
        assert w.sum() == 4 * (labels > 0).sum()


def _proposal_labels_program(fl, use_random):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        L = fl.layers
        rois = L.data(name="rois", shape=[6, 4], dtype="float32",
                      append_batch_size=False)
        gt_cls = L.data(name="gt_cls", shape=[2, 1], dtype="int32",
                        append_batch_size=False)
        crowd = L.data(name="crowd", shape=[2, 1], dtype="int32",
                       append_batch_size=False)
        gt = L.data(name="gt", shape=[2, 4], dtype="float32",
                    append_batch_size=False)
        im_info = L.data(name="im_info", shape=[3], dtype="float32",
                         append_batch_size=False)
        out = L.generate_proposal_labels(rois, gt_cls, crowd, gt, im_info,
                                         batch_size_per_im=8, class_nums=3,
                                         use_random=use_random)
    return main, out[1]


def test_attr_constants_copied_once_a_plan(monkeypatch):
    """``yolov3_loss`` puts its anchors on the device by
    ``EmitContext.constant`` in its forward and again in the generic vjp
    of its grad op: the plan's first run copies them, a second copies
    nothing from the host (as a captured replay may not)."""
    made = []
    constant = preg.EmitContext.constant
    monkeypatch.setattr(
        preg.EmitContext, "constant",
        lambda self, attrs, make: constant(
            self, attrs, lambda: made.append(1) or make()))
    main, startup = pt.Program(), pt.Program()
    with punique.guard(), pt.program_guard(main, startup):
        L = pt.layers
        feat = L.data(name="feat", shape=[4, 4, 4], dtype="float32")
        gt_box = L.data(name="gt_box", shape=[3, 4], dtype="float32")
        gt_label = L.data(name="gt_label", shape=[3], dtype="int32")
        head = L.conv2d(feat, num_filters=3 * 7, filter_size=1)
        loss = L.reduce_mean(L.yolov3_loss(
            head, gt_box, gt_label, anchors=[4, 6, 8, 10, 12, 14, 16, 18],
            anchor_mask=[1, 2, 3], class_num=2, ignore_thresh=0.5,
            downsample_ratio=4))
        pt.optimizer.SGD(0.1).minimize(loss)
    rng = _rng(43)
    feed = {"feat": _f(rng, 2, 4, 4, 4),
            "gt_box": np.tile(np.array([[0.3, 0.4, 0.2, 0.3]], np.float32),
                              (2, 3, 1)),
            "gt_label": np.ones((2, 3), np.int32)}
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    made.clear()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(made) == 2
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(made) == 2


@pytest.mark.parametrize("use_random", [True, False])
def test_generate_proposal_labels_program_needs_a_generator(use_random):
    """The op is not ``needs_rng`` in either package, so a program whose
    only random draw is its own runs without a key or generator: with
    ``use_random`` both refuse with JAX's message, without it both label
    the rows alike."""
    rng = _rng(41)
    gt = np.array([[2, 2, 20, 20], [30, 30, 60, 50]], np.float32)
    rois = np.concatenate([gt + rng.uniform(-3, 3, (2, 4)),
                           _boxes(rng, (4,)) * 60]).astype(np.float32)
    feed = {"rois": rois, "gt_cls": np.array([[1], [2]], np.int32),
            "crowd": np.zeros((2, 1), np.int32), "gt": gt,
            "im_info": np.array([64, 64, 1], np.float32)}
    results = []
    for fl, guard in ((fluid, junique.guard), (pt, punique.guard)):
        with guard():
            main, labels = _proposal_labels_program(fl, use_random)
        exe = fl.Executor(fl.CPUPlace())
        if use_random:
            with pytest.raises(RuntimeError,
                               match="op requested randomness but no PRNG "
                                     "key was provided to the executor"):
                exe.run(main, feed=feed, fetch_list=[labels],
                        scope=fl.Scope())
        else:
            results.append(np.asarray(exe.run(
                main, feed=feed, fetch_list=[labels],
                scope=fl.Scope())[0]))
    if not use_random:
        np.testing.assert_array_equal(results[0], results[1])
        assert (results[1] > 0).sum() >= 2


# ---------------------------------------------------------------------------
# host ops
# ---------------------------------------------------------------------------

def _map_inputs(seed, b=3, k=10, g=4, classes=4):
    rng = _rng(seed)
    gt = np.full((b, g, 5), -1.0, np.float32)
    det = np.zeros((b, k, 6), np.float32)
    det[..., 0] = -1
    for i in range(b):
        ng = rng.randint(1, g + 1)
        gt[i, :ng, 0] = rng.randint(1, classes, ng)
        gt[i, :ng, 1:] = _boxes(rng, (ng,))
        nd = rng.randint(1, k + 1)
        det[i, :nd, 0] = rng.randint(1, classes, nd)
        det[i, :nd, 1] = rng.rand(nd)
        src = gt[i, rng.randint(0, ng, nd), 1:]
        det[i, :nd, 2:] = src + rng.randn(nd, 4).astype(np.float32) * 0.03
    return det, gt


@pytest.mark.parametrize("ap", ["11point", "integral"])
def test_detection_map_matches_jax_and_the_metric(ap):
    det, gt = _map_inputs(95)
    attrs = {"overlap_threshold": 0.5, "ap_type": ap}
    j, p = run_both("detection_map", {"DetectRes": [det], "Label": [gt]},
                    attrs)
    assert_outputs_match(j, p, rel=0)
    metric = DetectionMAP(overlap_threshold=0.5, ap_version=ap)
    metric.update(det[:2], gt[:2])
    metric.update(det[2:], gt[2:])
    assert np.float32(metric.eval()) == p["MAP"][0]
    assert 0.0 < float(p["MAP"][0]) <= 1.0


def test_generate_mask_labels_matches_jax():
    rng = _rng(96)
    segms = np.zeros((3, 2, 6, 2), np.float32)
    seg_len = np.int32([[4, 0], [3, 5], [6, 0]])
    for g in range(3):
        for q in range(2):
            c = rng.uniform(10, 40, 2)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
            segms[g, q] = c + np.stack([np.cos(ang), np.sin(ang)], 1) * 8
    rois = _boxes(rng, (6,), 50.0, max_side=0.5) * 1.5
    ins = {"ImInfo": [np.float32([[60, 60, 1.5]])],
           "GtClasses": [np.int32([[1], [2], [3]])],
           "IsCrowd": [np.int32([[0], [0], [1]])],
           "GtSegms": [segms], "SegmsLength": [seg_len], "Rois": [rois],
           "LabelsInt32": [np.int32([[2], [0], [1], [3], [0], [2]])]}
    attrs = {"num_classes": 4, "resolution": 7}
    j, p = run_both("generate_mask_labels", ins, attrs)
    assert_outputs_match(j, p, rel=0)
    assert (p["MaskInt32"][0] == 1).any()
    ins["LabelsInt32"] = [np.zeros((6, 1), np.int32)]
    j, p = run_both("generate_mask_labels", ins, attrs)
    assert_outputs_match(j, p, rel=0)


def test_distribute_fpn_proposals_matches_jax():
    rois = np.concatenate([_boxes(_rng(97), (12,), 800.0, min_side=0.005,
                                  max_side=0.6),
                           np.zeros((1, 4), np.float32)])
    attrs = {"min_level": 2, "max_level": 5, "refer_level": 4,
             "refer_scale": 224}
    j, p = run_both("distribute_fpn_proposals", {"FpnRois": [rois]}, attrs)
    assert_outputs_match(j, p, rel=0)
    assert sum(len(r) for r in p["MultiFpnRois"]) == 13
    assert sum(len(r) > 0 for r in p["MultiFpnRois"]) >= 2


# ---------------------------------------------------------------------------
# registry, layers, the JAX OpTests
# ---------------------------------------------------------------------------

def test_detection_types_registered_like_jax():
    assert len(NEW_DETECTION) == 33 == len(set(NEW_DETECTION))
    for t in NEW_DETECTION:
        p, j = preg.lookup(t), jreg.lookup(t)
        assert p.emitter is not None, t
        for flag in ("no_grad", "needs_rng", "is_host",
                     "intermediate_outputs"):
            assert getattr(p, flag) == getattr(j, flag), (t, flag)


DETECTION_LAYERS = (
    "iou_similarity", "box_coder", "prior_box", "density_prior_box",
    "anchor_generator", "box_clip", "polygon_box_transform",
    "bipartite_match", "target_assign", "multiclass_nms", "roi_pool",
    "roi_align", "psroi_pool", "ssd_loss", "detection_output",
    "detection_map", "yolov3_loss", "generate_proposals",
    "rpn_target_assign", "mine_hard_examples",
    "roi_perspective_transform", "generate_proposal_labels",
    "generate_mask_labels", "yolo_box", "sigmoid_focal_loss",
    "box_decoder_and_assign", "collect_fpn_proposals",
    "distribute_fpn_proposals", "retinanet_target_assign",
    "retinanet_detection_output", "multi_box_head")


def test_layers_export_every_detection_name():
    from paddle_tpu.layers import detection as jdl
    assert sorted(DETECTION_LAYERS) == sorted(jdl.__all__)
    assert sorted(pt.layers.detection.__all__) == sorted(jdl.__all__)
    for n in DETECTION_LAYERS + ("smooth_l1",
                                 "sigmoid_cross_entropy_with_logits",
                                 "image_resize", "resize_bilinear",
                                 "resize_nearest", "image_resize_short"):
        assert callable(getattr(pt.layers, n)), n


def _layers_program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        L = fl.layers
        img = L.data(name="img", shape=[3, 32, 32], dtype="float32")
        feat = L.conv2d(img, num_filters=12, filter_size=3, stride=4,
                        padding=1)
        up = L.resize_bilinear(feat, scale=2)
        up2 = L.resize_nearest(up, out_shape=[10, 12], align_corners=False)
        short = L.image_resize_short(img, 16)
        gt_box = L.data(name="gt_box", shape=[4, 4], dtype="float32")
        gt_label = L.data(name="gt_label", shape=[4], dtype="int32")
        locs, confs, box, var = L.multi_box_head(
            [feat, up], img, base_size=32, num_classes=3,
            aspect_ratios=[[2.0], [2.0, 3.0]], min_sizes=[8.0, 16.0],
            max_sizes=[[], 24.0])
        loss = L.ssd_loss(locs, confs, gt_box, gt_label, box, var)
        dets = L.detection_output(locs, confs, box, var)
        label = L.concat([L.cast(L.unsqueeze(gt_label, axes=[2]),
                                 "float32"), gt_box], axis=2)
        L.detection_map(dets, label, ap_version="11point")
        L.density_prior_box(feat, img, densities=[2], fixed_sizes=[8.0],
                            fixed_ratios=[1.0])
        anchors, avar = L.anchor_generator(feat, anchor_sizes=[16.0],
                                           aspect_ratios=[1.0, 2.0],
                                           stride=[4.0, 4.0])
        im_info = L.data(name="im_info", shape=[3], dtype="float32")
        L.box_clip(L.reshape(anchors, [-1, 4]), im_info)
        L.polygon_box_transform(feat)
        scores = L.conv2d(feat, num_filters=2, filter_size=1)
        deltas = L.conv2d(feat, num_filters=8, filter_size=1)
        rois, probs = L.generate_proposals(scores, deltas, im_info, anchors,
                                           avar, pre_nms_top_n=20,
                                           post_nms_top_n=8)
        flat_rois = L.reshape(rois, [-1, 4])
        L.rpn_target_assign(deltas, scores, anchors, avar,
                            L.reshape(gt_box, [-1, 4]))
        gt_cls = L.data(name="gt_cls", shape=[1], dtype="int32")
        crowd = L.data(name="crowd", shape=[1], dtype="int32")
        out = L.generate_proposal_labels(flat_rois, gt_cls, crowd,
                                         L.reshape(gt_box, [-1, 4]),
                                         im_info, batch_size_per_im=8,
                                         class_nums=3)
        segms = L.data(name="segms", shape=[2, 6, 2], dtype="float32")
        seg_len = L.data(name="seg_len", shape=[2], dtype="int32")
        L.generate_mask_labels(im_info, gt_cls, crowd, segms, seg_len,
                               out[0], out[1], num_classes=3, resolution=7)
        L.roi_pool(feat, flat_rois, 2, 2, 0.25)
        L.roi_align(feat, flat_rois, 2, 2, 0.25, sampling_ratio=2)
        L.psroi_pool(feat, flat_rois, 3, 0.25, 2, 2)
        quads = L.data(name="quads", shape=[8], dtype="float32")
        L.roi_perspective_transform(feat, quads, 3, 4, 0.25)
        yolo = L.conv2d(feat, num_filters=3 * 7, filter_size=1)
        ybox = L.data(name="ybox", shape=[4, 4], dtype="float32")
        L.yolov3_loss(yolo, ybox, gt_label, anchors=[4, 6, 8, 10, 12, 14],
                      anchor_mask=[0, 1, 2], class_num=2, ignore_thresh=0.5,
                      downsample_ratio=4)
        img_size = L.data(name="img_size", shape=[2], dtype="int32")
        yb, ys = L.yolo_box(yolo, img_size, anchors=[4, 6, 8, 10, 12, 14],
                            class_num=2, conf_thresh=0.1, downsample_ratio=4)
        L.multiclass_nms(yb, L.transpose(ys, perm=[0, 2, 1]),
                         background_label=-1)
        logits = L.data(name="logits", shape=[3], dtype="float32")
        fg = L.data(name="fg", shape=[1], dtype="int32")
        L.sigmoid_focal_loss(logits, gt_cls, fg)
        L.sigmoid_cross_entropy_with_logits(logits, logits)
        L.smooth_l1(logits, logits, sigma=2.0)
        pvar = L.data(name="pvar", shape=[4], dtype="float32",
                      append_batch_size=False)
        L.box_decoder_and_assign(flat_rois, pvar, L.reshape(deltas, [-1, 8]),
                                 L.reshape(scores, [-1, 2]), 4.135)
        L.collect_fpn_proposals([flat_rois, flat_rois], [probs, probs], 2, 3,
                                10)
        L.distribute_fpn_proposals(flat_rois, 2, 5, 4, 224)
        L.retinanet_target_assign(deltas, scores, flat_rois, flat_rois,
                                  L.reshape(gt_box, [-1, 4]), gt_cls, crowd,
                                  im_info)
        L.retinanet_detection_output([locs], [confs], [box], im_info)
        iou = L.iou_similarity(flat_rois, box)
        L.bipartite_match(iou)
        enc = L.box_coder(box, [0.1, 0.1, 0.2, 0.2], flat_rois)
        L.target_assign(L.unsqueeze(enc, axes=[0]),
                        L.cast(L.reshape(flat_rois, [1, -1]), "int32"))
        L.mine_hard_examples(L.reshape(flat_rois, [1, -1]),
                             L.cast(L.reshape(flat_rois, [1, -1]), "int32"))
        L.prior_box(up2, img, min_sizes=[4.0], aspect_ratios=[2.0],
                    flip=True, clip=True)
        L.reduce_sum(loss)
    return main, startup


def test_detection_layers_build_jax_programs():
    with junique.guard():
        jmain, jstart = _layers_program(fluid)
    with punique.guard():
        pmain, pstart = _layers_program(pt)
    types = {o.type for o in pmain.global_block().ops}
    # the resize layers write ``interpolate``; ``bilinear_interp`` and
    # ``nearest_interp`` are the reference's names, which loaded programs
    # carry
    missing = set(NEW_DETECTION) - types
    assert missing == {"bilinear_interp", "nearest_interp"}, missing
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    assert pstart.desc.to_bytes() == jstart.desc.to_bytes()


OPTESTS = sorted(n for n in dir(jdet)
                 if n.startswith("Test") and getattr(
                     getattr(jdet, n), "outputs", None) is not False
                 and hasattr(getattr(jdet, n), "op_type"))


def _optest_with_outputs(name):
    case = getattr(jdet, name)()
    case.setup()
    return all(v is not None for v in case.outputs.values())


@pytest.mark.parametrize("name", [n for n in OPTESTS
                                  if _optest_with_outputs(n)])
def test_jax_optest_data_through_port(name):
    run_optest_on_port(getattr(jdet, name), 1e-5)
