"""Detection layers (counterpart of ``paddle_tpu/layers/detection.py``;
reference python/paddle/fluid/layers/detection.py): the SSD, RPN, R-CNN,
RetinaNet and YOLO building blocks over the dense padded convention, where
ragged LoD outputs (NMS results, proposals) become fixed-size tensors
padded with sentinel rows. Each builds the JAX package's descs."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from . import nn

__all__ = [
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
    "retinanet_detection_output", "multi_box_head",
]


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {"PriorBox": prior_box, "TargetBox": target_box}
    attrs = {"code_type": code_type, "box_normalized": box_normalized}
    if isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = [float(v) for v in prior_box_var]
    elif prior_box_var is not None:
        inputs["PriorBoxVar"] = prior_box_var
    helper.append_op(type="box_coder", inputs=inputs,
                     outputs={"OutputBox": out}, attrs=attrs)
    return out


def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              name=None, min_max_aspect_ratios_order=False):
    """layers/detection.py prior_box (prior_box_op.h)."""
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    variances = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="prior_box", inputs={"Input": input, "Image": image},
        outputs={"Boxes": boxes, "Variances": variances},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance), "flip": flip, "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset,
               "min_max_aspect_ratios_order": min_max_aspect_ratios_order})
    return boxes, variances


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    variances = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="density_prior_box",
        inputs={"Input": input, "Image": image},
        outputs={"Boxes": boxes, "Variances": variances},
        attrs={"densities": list(densities),
               "fixed_sizes": list(fixed_sizes),
               "fixed_ratios": list(fixed_ratios),
               "variances": list(variance), "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return boxes, variances


def anchor_generator(input, anchor_sizes, aspect_ratios, stride,
                     variance=(0.1, 0.1, 0.2, 0.2), offset=0.5,
                     name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors = helper.create_variable_for_type_inference(input.dtype)
    variances = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="anchor_generator", inputs={"Input": input},
        outputs={"Anchors": anchors, "Variances": variances},
        attrs={"anchor_sizes": list(anchor_sizes),
               "aspect_ratios": list(aspect_ratios),
               "stride": list(stride), "variances": list(variance),
               "offset": offset})
    return anchors, variances


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="box_clip",
                     inputs={"Input": input, "ImInfo": im_info},
                     outputs={"Output": out})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="polygon_box_transform",
                     inputs={"Input": input}, outputs={"Output": out})
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = helper.create_variable_for_type_inference("int32")
    match_dist = helper.create_variable_for_type_inference(
        dist_matrix.dtype)
    helper.append_op(
        type="bipartite_match", inputs={"DistMat": dist_matrix},
        outputs={"ColToRowMatchIndices": match_indices,
                 "ColToRowMatchDist": match_dist},
        attrs={"match_type": match_type or "",
               "dist_threshold": dist_threshold or 0.5})
    return match_indices, match_dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="target_assign",
        inputs={"X": input, "MatchIndices": matched_indices},
        outputs={"Out": out, "OutWeight": out_weight},
        attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=400,
                   keep_top_k=200, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    """multiclass_nms_op.cc; dense output [B, keep_top_k, 6]
    (class, score, x1, y1, x2, y2), class=-1 rows are padding."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    helper.append_op(
        type="multiclass_nms", inputs={"BBoxes": bboxes,
                                       "Scores": scores},
        outputs={"Out": out},
        attrs={"score_threshold": score_threshold,
               "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
               "nms_threshold": nms_threshold, "nms_eta": nms_eta,
               "background_label": background_label,
               "normalized": normalized})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch=None):
    helper = LayerHelper("roi_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    argmax = helper.create_variable_for_type_inference("int32", True)
    inputs = {"X": input, "ROIs": rois}
    if rois_batch is not None:
        inputs["RoisBatch"] = rois_batch
    helper.append_op(type="roi_pool", inputs=inputs,
                     outputs={"Out": out, "Argmax": argmax},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_batch=None,
              name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "ROIs": rois}
    if rois_batch is not None:
        inputs["RoisBatch"] = rois_batch
    helper.append_op(type="roi_align", inputs=inputs,
                     outputs={"Out": out},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale,
                            "sampling_ratio": sampling_ratio})
    return out


def psroi_pool(input, rois, output_channels, spatial_scale,
               pooled_height, pooled_width, rois_batch=None, name=None):
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "ROIs": rois}
    if rois_batch is not None:
        inputs["RoisBatch"] = rois_batch
    helper.append_op(type="psroi_pool", inputs=inputs,
                     outputs={"Out": out},
                     attrs={"output_channels": output_channels,
                            "spatial_scale": spatial_scale,
                            "pooled_height": pooled_height,
                            "pooled_width": pooled_width})
    return out


def mine_hard_examples(cls_loss, match_indices, loc_loss=None,
                       match_dist=None, neg_pos_ratio=3.0,
                       neg_overlap=0.5, mining_type="max_negative"):
    helper = LayerHelper("mine_hard_examples")
    neg = helper.create_variable_for_type_inference("int32")
    updated = helper.create_variable_for_type_inference("int32")
    inputs = {"ClsLoss": cls_loss, "MatchIndices": match_indices}
    if loc_loss is not None:
        inputs["LocLoss"] = loc_loss
    if match_dist is not None:
        inputs["MatchDist"] = match_dist
    helper.append_op(type="mine_hard_examples", inputs=inputs,
                     outputs={"NegIndices": neg,
                              "UpdatedMatchIndices": updated},
                     attrs={"neg_pos_ratio": neg_pos_ratio,
                            "neg_overlap": neg_overlap,
                            "mining_type": mining_type})
    return neg, updated


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0,
             overlap_threshold=0.5, neg_pos_ratio=3.0,
             loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type="per_prediction", mining_type="max_negative",
             normalize=True):
    """layers/detection.py ssd_loss — the SSD training pipeline:
    iou -> bipartite_match -> target_assign (boxes + labels) ->
    hard-negative mining -> smooth-L1 loc loss + softmax conf loss.
    Dense convention: gt_box [B, G, 4] (zero-area rows = padding),
    gt_label [B, G] int."""
    b, m = location.shape[0], location.shape[1]
    g = gt_box.shape[1]

    flat_gt = nn.reshape(gt_box, shape=[-1, 4])
    iou_flat = iou_similarity(flat_gt, prior_box)      # [B*G, M]
    dist = nn.reshape(iou_flat, shape=[b, g, m])
    matched, match_dist = bipartite_match(dist, match_type,
                                          overlap_threshold)

    # confidence loss per prior against assigned labels
    lbl_assigned, _ = target_assign(
        nn.unsqueeze(gt_label, axes=[2]), matched,
        mismatch_value=background_label)
    lbl_flat = nn.reshape(lbl_assigned, shape=[-1, 1])
    conf_flat = nn.reshape(confidence,
                           shape=[-1, confidence.shape[-1]])
    conf_loss = nn.softmax_with_cross_entropy(
        conf_flat, nn.cast(lbl_flat, "int64"))
    conf_loss = nn.reshape(conf_loss, shape=[b, m])

    neg_mask, _ = mine_hard_examples(conf_loss, matched,
                                     match_dist=match_dist,
                                     neg_pos_ratio=neg_pos_ratio,
                                     neg_overlap=overlap_threshold,
                                     mining_type=mining_type)

    # localization loss on matched priors only (InsideWeight masks)
    box_assigned, box_w = target_assign(gt_box, matched,
                                        mismatch_value=0)
    # [B, M, 4] targets encode row-wise against [M, 4] priors
    enc = box_coder(prior_box, prior_box_var, box_assigned,
                    code_type="encode_center_size")
    loc_flat = nn.reshape(location, shape=[-1, 4])
    enc_flat = nn.reshape(enc, shape=[-1, 4])
    w_flat = nn.reshape(
        nn.expand(box_w, expand_times=[1, 1, 4]), shape=[-1, 4])
    loc_l = nn.smooth_l1(loc_flat, enc_flat, inside_weight=w_flat)
    loc_l = nn.reshape(loc_l, shape=[-1, m])

    pos_mask = nn.reduce_max(box_w, dim=2)             # [B, M] 1=matched
    sel = nn.clip(nn.elementwise_add(
        pos_mask, nn.cast(neg_mask, "float32")), 0.0, 1.0)
    conf_l = nn.elementwise_mul(conf_loss, sel)

    total = nn.elementwise_add(
        nn.scale(loc_l, scale=float(loc_loss_weight)),
        nn.scale(conf_l, scale=float(conf_loss_weight)))
    if normalize:
        # lower-bound only: the batch dim is -1 at build time, so no
        # finite upper bound is known here
        denom = nn.clip(nn.reduce_sum(pos_mask), 1.0, 3.4e38)
        total = nn.elementwise_div(nn.reduce_sum(total), denom)
    return total


def detection_output(loc, scores, prior_box, prior_box_var=None,
                     background_label=0, nms_threshold=0.3,
                     nms_top_k=400, keep_top_k=200, score_threshold=0.01,
                     nms_eta=1.0):
    """layers/detection.py detection_output: decode + multiclass NMS.
    loc [B, M, 4], scores [B, M, C] (softmax applied here)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    probs = nn.softmax(scores)
    scores_t = nn.transpose(probs, perm=[0, 2, 1])     # [B, C, M]
    return multiclass_nms(decoded, scores_t,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, nms_eta=nms_eta,
                          background_label=background_label)


def detection_map(detect_res, label, class_num=None,
                  background_label=0, overlap_threshold=0.5,
                  evaluate_difficult=True, ap_version="integral"):
    helper = LayerHelper("detection_map")
    m_ap = helper.create_variable_for_type_inference("float32")
    pos_cnt = helper.create_variable_for_type_inference("int32", True)
    true_pos = helper.create_variable_for_type_inference("float32", True)
    false_pos = helper.create_variable_for_type_inference("float32",
                                                          True)
    helper.append_op(
        type="detection_map",
        inputs={"DetectRes": detect_res, "Label": label},
        outputs={"MAP": m_ap, "AccumPosCount": pos_cnt,
                 "AccumTruePos": true_pos, "AccumFalsePos": false_pos},
        attrs={"overlap_threshold": overlap_threshold,
               "ap_type": ap_version,
               "background_label": background_label})
    return m_ap


def yolov3_loss(x, gtbox, gtlabel, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gtscore=None,
                use_label_smooth=False, name=None):
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    obj_mask = helper.create_variable_for_type_inference(x.dtype, True)
    gt_match = helper.create_variable_for_type_inference("int32", True)
    inputs = {"X": x, "GTBox": gtbox, "GTLabel": gtlabel}
    if gtscore is not None:
        inputs["GTScore"] = gtscore
    helper.append_op(
        type="yolov3_loss", inputs=inputs,
        outputs={"Loss": loss, "ObjectnessMask": obj_mask,
                 "GTMatchMask": gt_match},
        attrs={"anchors": list(anchors),
               "anchor_mask": list(anchor_mask),
               "class_num": class_num, "ignore_thresh": ignore_thresh,
               "downsample_ratio": downsample_ratio,
               "use_label_smooth": use_label_smooth})
    return loss


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(scores.dtype)
    probs = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": scores, "BboxDeltas": bbox_deltas,
                "ImInfo": im_info, "Anchors": anchors,
                "Variances": variances},
        outputs={"RpnRois": rois, "RpnRoiProbs": probs},
        attrs={"pre_nms_topN": pre_nms_top_n,
               "post_nms_topN": post_nms_top_n,
               "nms_thresh": nms_thresh, "min_size": min_size,
               "eta": eta})
    return rois, probs


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """rpn_target_assign_op.cc, dense variant: returns per-anchor
    labels {1,0,-1}, regression targets, and fg/valid masks (instead of
    the reference's gathered index lists)."""
    helper = LayerHelper("rpn_target_assign")
    label = helper.create_variable_for_type_inference("int32")
    tgt_bbox = helper.create_variable_for_type_inference("float32")
    inside_w = helper.create_variable_for_type_inference("float32", True)
    loc_idx = helper.create_variable_for_type_inference("int32", True)
    score_idx = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(
        type="rpn_target_assign",
        inputs={"Anchor": anchor_box, "GtBoxes": gt_boxes},
        outputs={"TargetLabel": label, "TargetBBox": tgt_bbox,
                 "BBoxInsideWeight": inside_w, "LocationIndex": loc_idx,
                 "ScoreIndex": score_idx},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_fg_fraction": rpn_fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap})
    return label, tgt_bbox, inside_w, loc_idx, score_idx


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_batch=None, name=None):
    """layers/detection.py roi_perspective_transform: warp quad ROIs
    ([N, 8] corner points) into fixed-size patches."""
    helper = LayerHelper("roi_perspective_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "ROIs": rois}
    if rois_batch is not None:
        inputs["RoisBatch"] = rois_batch
    helper.append_op(type="roi_perspective_transform", inputs=inputs,
                     outputs={"Out": out},
                     attrs={"transformed_height": transformed_height,
                            "transformed_width": transformed_width,
                            "spatial_scale": spatial_scale})
    return out


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True):
    """layers/detection.py generate_proposal_labels (Fast R-CNN
    stage-2 sampling); dense fixed-size output rows."""
    helper = LayerHelper("generate_proposal_labels")
    dtype = rpn_rois.dtype
    rois = helper.create_variable_for_type_inference(dtype)
    labels = helper.create_variable_for_type_inference("int32")
    bbox_targets = helper.create_variable_for_type_inference(dtype)
    bbox_inside = helper.create_variable_for_type_inference(dtype)
    bbox_outside = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="generate_proposal_labels",
        inputs={"RpnRois": rpn_rois, "GtClasses": gt_classes,
                "IsCrowd": is_crowd, "GtBoxes": gt_boxes,
                "ImInfo": im_info},
        outputs={"Rois": rois, "LabelsInt32": labels,
                 "BboxTargets": bbox_targets,
                 "BboxInsideWeights": bbox_inside,
                 "BboxOutsideWeights": bbox_outside},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums or 81,
               "use_random": use_random})
    return rois, labels, bbox_targets, bbox_inside, bbox_outside


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms,
                         segms_length, rois, labels_int32, num_classes,
                         resolution):
    """layers/detection.py generate_mask_labels (Mask R-CNN mask-head
    targets); host op — see ops/kernels_host.py for the dense segm
    layout."""
    helper = LayerHelper("generate_mask_labels")
    mask_rois = helper.create_variable_for_type_inference("float32")
    roi_has_mask = helper.create_variable_for_type_inference("int32")
    mask_int32 = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="generate_mask_labels",
        inputs={"ImInfo": im_info, "GtClasses": gt_classes,
                "IsCrowd": is_crowd, "GtSegms": gt_segms,
                "SegmsLength": segms_length, "Rois": rois,
                "LabelsInt32": labels_int32},
        outputs={"MaskRois": mask_rois,
                 "RoiHasMaskInt32": roi_has_mask,
                 "MaskInt32": mask_int32},
        attrs={"num_classes": num_classes, "resolution": resolution})
    return mask_rois, roi_has_mask, mask_int32


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    """layers/detection.py:1023 yolo_box: decode one YOLOv3 head into
    (boxes [N, M, 4], scores [N, M, class_num])."""
    helper = LayerHelper("yolo_box", name=name)
    boxes = helper.create_variable_for_type_inference(x.dtype)
    scores = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="yolo_box",
                     inputs={"X": x, "ImgSize": img_size},
                     outputs={"Boxes": boxes, "Scores": scores},
                     attrs={"anchors": list(anchors),
                            "class_num": class_num,
                            "conf_thresh": conf_thresh,
                            "downsample_ratio": downsample_ratio})
    return boxes, scores


def sigmoid_focal_loss(x, label, fg_num, gamma=2, alpha=0.25):
    """layers/detection.py:434 sigmoid_focal_loss."""
    helper = LayerHelper("sigmoid_focal_loss")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_focal_loss",
                     inputs={"X": x, "Label": label, "FgNum": fg_num},
                     outputs={"Out": out},
                     attrs={"gamma": gamma, "alpha": alpha})
    return out


def box_decoder_and_assign(prior_box, prior_box_var, target_box,
                           box_score, box_clip, name=None):
    """layers/detection.py box_decoder_and_assign."""
    helper = LayerHelper("box_decoder_and_assign", name=name)
    decoded = helper.create_variable_for_type_inference(prior_box.dtype)
    assigned = helper.create_variable_for_type_inference(prior_box.dtype)
    helper.append_op(type="box_decoder_and_assign",
                     inputs={"PriorBox": prior_box,
                             "PriorBoxVar": prior_box_var,
                             "TargetBox": target_box,
                             "BoxScore": box_score},
                     outputs={"DecodeBox": decoded,
                              "OutputAssignBox": assigned},
                     attrs={"box_clip": box_clip})
    return decoded, assigned


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    """layers/detection.py:3304 collect_fpn_proposals (dense: exactly
    post_nms_top_n rows)."""
    helper = LayerHelper("collect_fpn_proposals", name=name)
    num = max_level - min_level + 1
    out = helper.create_variable_for_type_inference(
        multi_rois[0].dtype)
    helper.append_op(type="collect_fpn_proposals",
                     inputs={"MultiLevelRois": multi_rois[:num],
                             "MultiLevelScores": multi_scores[:num]},
                     outputs={"FpnRois": out},
                     attrs={"post_nms_topN": post_nms_top_n})
    return out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    """layers/detection.py distribute_fpn_proposals (host op: ragged
    per-level splits). Returns (multi_rois list, restore_ind)."""
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    num = max_level - min_level + 1
    outs = [helper.create_variable_for_type_inference(fpn_rois.dtype)
            for _ in range(num)]
    restore = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="distribute_fpn_proposals",
                     inputs={"FpnRois": fpn_rois},
                     outputs={"MultiFpnRois": outs,
                              "RestoreIndex": restore},
                     attrs={"min_level": min_level,
                            "max_level": max_level,
                            "refer_level": refer_level,
                            "refer_scale": refer_scale})
    return outs, restore


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box,
                            anchor_var, gt_boxes, gt_labels, is_crowd,
                            im_info, num_classes=1,
                            positive_overlap=0.5, negative_overlap=0.4):
    """layers/detection.py:63 retinanet_target_assign. Dense variant:
    all anchors come back (label -1 = ignore) with ScoreIndex/
    LocationIndex as masks and fg_num for focal-loss normalization."""
    helper = LayerHelper("retinanet_target_assign")
    target_label = helper.create_variable_for_type_inference("int32")
    target_bbox = helper.create_variable_for_type_inference(
        anchor_box.dtype)
    bbox_inside_weight = helper.create_variable_for_type_inference(
        anchor_box.dtype)
    fg_num = helper.create_variable_for_type_inference("int32")
    loc_index = helper.create_variable_for_type_inference("int32")
    score_index = helper.create_variable_for_type_inference("int32")
    pred_scores = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="retinanet_target_assign",
        inputs={"Anchor": anchor_box, "GtBoxes": gt_boxes,
                "GtLabels": gt_labels, "IsCrowd": is_crowd,
                "ImInfo": im_info},
        outputs={"PredictedScores": pred_scores,
                 "TargetLabel": target_label,
                 "TargetBBox": target_bbox,
                 "BBoxInsideWeight": bbox_inside_weight,
                 "LocationIndex": loc_index,
                 "ScoreIndex": score_index,
                 "ForegroundNumber": fg_num},
        attrs={"positive_overlap": positive_overlap,
               "negative_overlap": negative_overlap})
    return (cls_logits, bbox_pred, target_label, target_bbox,
            bbox_inside_weight, fg_num)


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """layers/detection.py:2876 retinanet_detection_output."""
    helper = LayerHelper("retinanet_detection_output")
    out = helper.create_variable_for_type_inference(bboxes[0].dtype)
    helper.append_op(
        type="retinanet_detection_output",
        inputs={"BBoxes": list(bboxes), "Scores": list(scores),
                "Anchors": list(anchors), "ImInfo": im_info},
        outputs={"Out": out},
        attrs={"score_threshold": score_threshold,
               "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
               "nms_threshold": nms_threshold, "nms_eta": nms_eta})
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1,
                   name=None, min_max_aspect_ratios_order=False):
    """layers/detection.py multi_box_head (the SSD prediction head):
    for every feature map, generate priors and convolve location /
    confidence predictions; concat across maps. Returns
    (mbox_locs, mbox_confs, boxes, variances) like the reference."""
    n_layer = len(inputs)
    if min_sizes is None:
        # the reference's ratio ladder (multi_box_head:min_ratio)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) // max(n_layer - 2, 1))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes

    # priors a cell: the prior_box emitter's own expansion rule
    from ..ops.kernels_detection import expand_aspect_ratios

    def _expanded_ar_count(ars):
        return len(expand_aspect_ratios(ars, flip))

    locs, confs, all_boxes, all_vars = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        mins = [mins] if not isinstance(mins, (list, tuple)) else list(mins)
        maxs = max_sizes[i] if max_sizes else None
        maxs = ([maxs] if maxs is not None and not isinstance(
            maxs, (list, tuple)) else (list(maxs) if maxs else []))
        ar = aspect_ratios[i] if isinstance(
            aspect_ratios[i], (list, tuple)) else [aspect_ratios[i]]
        if steps:
            step_wh = (steps[i], steps[i]) if not isinstance(
                steps[i], (list, tuple)) else tuple(steps[i])
        else:
            step_wh = (step_w[i] if step_w else 0.0,
                       step_h[i] if step_h else 0.0)
        boxes, var = prior_box(
            feat, image, min_sizes=mins, max_sizes=maxs or None,
            aspect_ratios=list(ar), variance=list(variance), flip=flip,
            clip=clip, steps=step_wh, offset=offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        # priors per cell (prior_box emitter's count, computed statically)
        num_boxes = len(mins) * _expanded_ar_count(ar) + len(maxs)
        loc = nn.conv2d(feat, num_filters=num_boxes * 4,
                        filter_size=kernel_size, padding=pad,
                        stride=stride)
        loc = nn.transpose(loc, [0, 2, 3, 1])
        loc = nn.reshape(loc, shape=[0, -1, 4])
        conf = nn.conv2d(feat, num_filters=num_boxes * num_classes,
                         filter_size=kernel_size, padding=pad,
                         stride=stride)
        conf = nn.transpose(conf, [0, 2, 3, 1])
        conf = nn.reshape(conf, shape=[0, -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        all_boxes.append(nn.reshape(boxes, shape=[-1, 4]))
        all_vars.append(nn.reshape(var, shape=[-1, 4]))

    mbox_locs = nn.concat(locs, axis=1)
    mbox_confs = nn.concat(confs, axis=1)
    boxes_cat = nn.concat(all_boxes, axis=0)
    vars_cat = nn.concat(all_vars, axis=0)
    return mbox_locs, mbox_confs, boxes_cat, vars_cat
