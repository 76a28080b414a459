"""Detection ops (counterpart of ``paddle_tpu/ops/kernels_detection.py``;
reference operators/detection/): box coding and IoU, the prior and anchor
grids, SSD matching (``bipartite_match``, ``target_assign``,
``mine_hard_examples``), the NMS family, the RoI ops, two-stage and
RetinaNet target assignment, YOLOv3, and the host metric
``detection_map``.

The JAX package's dense, padded convention holds throughout: ragged LoD
outputs become fixed-size tensors with sentinel rows (class -1, zero-area
boxes, label -1), and zero-area ground-truth rows are padding.

Nothing here reads a device tensor on the host, so every device op can sit
inside a captured CUDA graph:

- the prior and anchor grids are numpy constants of the static shapes,
  copied to the device once per plan (``EmitContext.constant``);
- so are the small attribute vectors (variances, anchors), one
  constant an op (``_attr_vector``);
- the sequential scans of the JAX package (greedy NMS, bipartite
  matching) are Python loops of a fixed trip count, each step batched over
  every leading dimension (images, classes).

Integer outputs carry the dtype the JAX layers declare (int32). Ties
follow the JAX package: ``top_k`` in ``lax.top_k``'s order
(``top_k_total_order``), stable argsorts, first-maximum argmax. The RoI
ops sample through separable weight matrices (products with one-hot rows,
matrix products), so their gradients are sums a matrix product forms, not
scatter-adds."""

from __future__ import annotations

import numpy as np
import torch

from ..core.desc import OpDesc
from ..registry import lookup, register_op
from .common import (ZERO, in_dtype, in_shape, opt, same_shape_infer,
                     set_out_var, top_k_total_order, true_div as _div)


# ---------------------------------------------------------------------------
# shape rules (the JAX package's, rule for rule)
# ---------------------------------------------------------------------------

def _box_coder_infer(op: OpDesc, block):
    """OutputBox takes TargetBox's dtype; its shape follows the code
    type."""
    dt = in_dtype(block, op, "TargetBox")
    for n in op.output("OutputBox"):
        set_out_var(block, n, None, dt)


def _iou_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    ys = in_shape(block, op, "Y")
    if xs and ys:
        for n in op.output("Out"):
            set_out_var(block, n, [xs[0], ys[0]], in_dtype(block, op, "X"))


def _roi_pool_like_infer(out_slots, channels_attr=None):
    def infer(op: OpDesc, block):
        xs = in_shape(block, op, "X")
        rs = in_shape(block, op, "ROIs")
        if not xs or len(xs) != 4 or not rs:
            return
        c = (int(op.attrs.get(channels_attr, xs[1]))
             if channels_attr else xs[1])
        ph = int(op.attrs.get("pooled_height", 1) or 1)
        pw = int(op.attrs.get("pooled_width", 1) or 1)
        for slot in out_slots:
            for n in op.output(slot):
                set_out_var(block, n, [rs[0], c, ph, pw],
                            in_dtype(block, op, "X")
                            if slot != "Argmax" else None)
    return infer


def _roi_perspective_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    rs = in_shape(block, op, "ROIs")
    th = int(op.attrs.get("transformed_height", 1) or 1)
    tw = int(op.attrs.get("transformed_width", 1) or 1)
    if xs and len(xs) == 4 and rs:
        for n in op.output("Out"):
            set_out_var(block, n, [rs[0], xs[1], th, tw],
                        in_dtype(block, op, "X"))


def _bipartite_infer(op: OpDesc, block):
    ds = in_shape(block, op, "DistMat")
    if ds and len(ds) == 2:
        for n in op.output("ColToRowMatchIndices"):
            set_out_var(block, n, ds, "int32")
        for n in op.output("ColToRowMatchDist"):
            set_out_var(block, n, ds, in_dtype(block, op, "DistMat"))


def _yolov3_loss_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs:
        for n in op.output("Loss"):
            set_out_var(block, n, [xs[0]], in_dtype(block, op, "X"))


def _grid_infer(*slots):
    """Anchor grids and score tables: the dtype rides the feature map."""
    def infer(op: OpDesc, block):
        dt = in_dtype(block, op, "Input") or in_dtype(block, op, "X")
        for slot in slots:
            for n in op.output(slot):
                set_out_var(block, n, None, dt)
    return infer


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _attr_vector(ctx, attrs, values, dtype, device):
    """The Python numbers ``values`` (taken from ``attrs``) as one 1-D
    device tensor, copied once per plan (``EmitContext.constant``), so a
    captured run copies nothing from the host."""
    return ctx.constant(attrs, lambda: torch.tensor(values,
                                                    dtype=dtype).to(device))


def _grid_constant(ctx, attrs, like, boxes, variances):
    """The numpy [fh, fw, P, 4] grid and its variances as one device
    tensor, copied once per plan; returns the two halves."""
    both = ctx.constant(attrs, lambda: torch.from_numpy(
        np.stack([boxes, variances])).to(like.device))
    return both[0], both[1]


def _pairwise_iou(bx):
    """IoU of every pair of ``bx`` [..., k, 4] (x1, y1, x2, y2):
    [..., k, k], the JAX package's NMS arithmetic."""
    x1, y1, x2, y2 = bx.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    return inter / torch.clamp(area[..., :, None] + area[..., None, :]
                               - inter, min=1e-10)


def greedy_nms(ious, valid, thresh, eta=1.0):
    """Greedy IoU suppression over boxes pre-sorted by descending score,
    batched over every leading dimension of ``valid`` [..., k]: box i is
    kept if valid and no kept box j < i overlaps it by more than the
    threshold. With ``eta`` < 1 the threshold of a row shrinks by ``eta``
    after each kept box while it is above 0.5 (multiclass_nms_op.cc).

    One step per box, k in all: the JAX package's ``lax.scan``. With a
    fixed threshold the overlap test is one boolean mask built before the
    loop, and a step is three kernels (and, any, compare)."""
    k = valid.shape[-1]
    lower = torch.ones(k, k, dtype=torch.bool,
                       device=valid.device).tril(-1)
    keep = torch.zeros_like(valid)
    hit = torch.empty(valid.shape, dtype=torch.bool, device=valid.device)
    sup = torch.empty(valid.shape[:-1], dtype=torch.bool,
                      device=valid.device)
    if eta >= 1.0:
        over = (ious > thresh) & lower
        for i in range(k):
            torch.logical_and(keep, over[..., i, :], out=hit)
            torch.any(hit, dim=-1, out=sup)
            torch.gt(valid[..., i], sup, out=keep[..., i])
        return keep
    thr = torch.full(valid.shape[:-1], thresh, dtype=torch.float32,
                     device=valid.device)
    for i in range(k):
        hit = keep & (ious[..., i, :] > thr[..., None]) & lower[i]
        kept = valid[..., i] & ~hit.any(-1)
        keep[..., i] = kept
        thr = torch.where(kept & (thr > 0.5), thr * eta, thr)
    return keep


def _roi_batch_idx(ins, n, device):
    rb = opt(ins, "RoisBatch")
    if rb is not None:
        return rb.reshape(-1).long()
    return torch.zeros((n,), dtype=torch.long, device=device)


def _sce(logit, label):
    """Sigmoid cross entropy with logits, the JAX package's form."""
    return (torch.maximum(logit, ZERO.to(logit.dtype)) - logit * label
            + torch.log1p(torch.exp(-torch.abs(logit))))


# ---------------------------------------------------------------------------
# box coding, IoU, grids
# ---------------------------------------------------------------------------

@register_op("iou_similarity", no_grad=True, infer=_iou_infer)
def iou_similarity(ctx, ins, attrs):
    """IoU of X [N, 4] against Y [M, 4] (x1, y1, x2, y2): [N, M]."""
    a, b = ins["X"][0], ins["Y"][0]
    ax1, ay1, ax2, ay2 = (a[:, i:i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (b[None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0)
    inter = iw * ih
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    return {"Out": [inter / (area_a + area_b - inter + 1e-10)]}


@register_op("box_coder", no_grad=True,
             infer=_box_coder_infer)
def box_coder(ctx, ins, attrs):
    """box_coder_op.h center-size coding, with variances from the
    PriorBoxVar input or the ``variance`` attr; [B, M, 4] targets pair
    row-wise with [M, 4] priors."""
    prior = ins["PriorBox"][0]
    target = ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    var = opt(ins, "PriorBoxVar")
    if var is None and attrs.get("variance"):
        var = _attr_vector(ctx, attrs, [float(v) for v in attrs["variance"]],
                           prior.dtype, prior.device)[None, :]
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    if target.dim() == 3:
        pw, ph, pcx, pcy = (v[None, :] for v in (pw, ph, pcx, pcy))
    if code_type.startswith("encode"):
        tw = torch.clamp(target[..., 2] - target[..., 0], min=1e-6)
        th = torch.clamp(target[..., 3] - target[..., 1], min=1e-6)
        tcx = target[..., 0] + 0.5 * tw
        tcy = target[..., 1] + 0.5 * th
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], dim=-1)
        if var is not None:
            out = out / var
    else:
        d = target if var is None else target * var
        cx = d[..., 0] * pw + pcx
        cy = d[..., 1] * ph + pcy
        w = torch.exp(d[..., 2]) * pw
        h = torch.exp(d[..., 3]) * ph
        out = torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                           cx + 0.5 * w, cy + 0.5 * h], dim=-1)
    return {"OutputBox": [out]}


def expand_aspect_ratios(aspect_ratios, flip):
    """prior_box_op.h:25 ExpandAspectRatios: 1 first, then each new ratio
    (and its inverse under ``flip``); ``multi_box_head`` counts priors a
    cell with it."""
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(ar)
        if flip:
            out.append(1.0 / ar)
    return out


@register_op("prior_box", no_grad=True,
             infer=_grid_infer("Boxes", "Variances"))
def prior_box(ctx, ins, attrs):
    """prior_box_op.h:96-160: SSD priors [fh, fw, P, 4] per feature-map
    cell and their variances, a numpy function of the static shapes and
    the attrs."""
    feat, image = ins["Input"][0], ins["Image"][0]
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", []) or []]
    ars = expand_aspect_ratios(attrs.get("aspect_ratios", [1.0]),
                               attrs.get("flip", False))
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    step_w = attrs.get("step_w", 0.0) or iw / fw
    step_h = attrs.get("step_h", 0.0) or ih / fh
    offset = attrs.get("offset", 0.5)
    mmo = attrs.get("min_max_aspect_ratios_order", False)
    boxes = []
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h
            cell = []
            for s, mn in enumerate(min_sizes):
                ar_boxes = [(mn * np.sqrt(ar) / 2.0, mn / np.sqrt(ar) / 2.0)
                            for ar in ars]
                sq = []
                if max_sizes:
                    m = np.sqrt(mn * max_sizes[s]) / 2.0
                    sq.append((m, m))
                order = ([ar_boxes[0]] + sq + ar_boxes[1:] if mmo
                         else ar_boxes + sq)
                for bw, bh in order:
                    cell.append([(cx - bw) / iw, (cy - bh) / ih,
                                 (cx + bw) / iw, (cy + bh) / ih])
            boxes.append(cell)
    num_priors = len(boxes[0])
    arr = np.asarray(boxes, np.float32).reshape(fh, fw, num_priors, 4)
    if attrs.get("clip", False):
        arr = np.clip(arr, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variances, np.float32), arr.shape)
    b, v = _grid_constant(ctx, attrs, feat, arr, var)
    return {"Boxes": [b], "Variances": [v]}


@register_op("density_prior_box", no_grad=True,
             infer=_grid_infer("Boxes", "Variances"))
def density_prior_box(ctx, ins, attrs):
    """density_prior_box_op.h: a dense grid of fixed-size priors a cell."""
    feat, image = ins["Input"][0], ins["Image"][0]
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    fixed_sizes = [float(s) for s in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(r) for r in attrs.get("fixed_ratios", [1.0])]
    densities = [int(d) for d in attrs.get("densities", [])]
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    step_w = attrs.get("step_w", 0.0) or iw / fw
    step_h = attrs.get("step_h", 0.0) or ih / fh
    offset = attrs.get("offset", 0.5)
    boxes = []
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h
            cell = []
            for size, density in zip(fixed_sizes, densities):
                for ratio in fixed_ratios:
                    bw = size * np.sqrt(ratio)
                    bh = size / np.sqrt(ratio)
                    shift = size / density
                    for di in range(density):
                        for dj in range(density):
                            c_x = cx - size / 2.0 + shift / 2.0 + dj * shift
                            c_y = cy - size / 2.0 + shift / 2.0 + di * shift
                            cell.append([(c_x - bw / 2.0) / iw,
                                         (c_y - bh / 2.0) / ih,
                                         (c_x + bw / 2.0) / iw,
                                         (c_y + bh / 2.0) / ih])
            boxes.append(cell)
    num_priors = len(boxes[0])
    arr = np.asarray(boxes, np.float32).reshape(fh, fw, num_priors, 4)
    if attrs.get("clip", False):
        arr = np.clip(arr, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variances, np.float32), arr.shape)
    b, v = _grid_constant(ctx, attrs, feat, arr, var)
    return {"Boxes": [b], "Variances": [v]}


@register_op("anchor_generator", no_grad=True,
             infer=_grid_infer("Anchors", "Variances"))
def anchor_generator(ctx, ins, attrs):
    """anchor_generator_op.h: RPN anchors [fh, fw, A, 4] on the stride
    grid, in image coordinates."""
    feat = ins["Input"][0]
    fh, fw = feat.shape[2], feat.shape[3]
    sizes = [float(s) for s in attrs["anchor_sizes"]]
    ratios = [float(r) for r in attrs["aspect_ratios"]]
    stride = [float(s) for s in attrs["stride"]]
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    offset = attrs.get("offset", 0.5)
    anchors = []
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * stride[0]
            cy = (h + offset) * stride[1]
            cell = []
            for r in ratios:
                for s in sizes:
                    area = stride[0] * stride[1]
                    base_w = np.round(np.sqrt(area / r))
                    base_h = np.round(base_w * r)
                    half_w = 0.5 * (s / stride[0]) * base_w
                    half_h = 0.5 * (s / stride[1]) * base_h
                    cell.append([cx - half_w, cy - half_h,
                                 cx + half_w, cy + half_h])
            anchors.append(cell)
    arr = np.asarray(anchors, np.float32).reshape(fh, fw, len(anchors[0]), 4)
    var = np.broadcast_to(np.asarray(variances, np.float32), arr.shape)
    a, v = _grid_constant(ctx, attrs, feat, arr, var)
    return {"Anchors": [a], "Variances": [v]}


@register_op("box_clip", no_grad=True,
             infer=same_shape_infer("Output", "Input"))
def box_clip(ctx, ins, attrs):
    """box_clip_op.h: clip [..., 4] boxes into ImInfo (h, w, scale)."""
    boxes = ins["Input"][0]
    im_info = ins["ImInfo"][0].reshape(-1)
    h, w = im_info[0] - 1.0, im_info[1] - 1.0
    lo = ZERO.to(boxes.dtype)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], lo), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], lo), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], lo), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], lo), h)
    return {"Output": [torch.stack([x1, y1, x2, y2], dim=-1)]}


@register_op("polygon_box_transform", no_grad=True,
             infer=same_shape_infer("Output", "Input"))
def polygon_box_transform(ctx, ins, attrs):
    """polygon_box_transform_op.cc: quad offset maps [B, 2G, H, W] to
    absolute coordinates, 4 * grid - offset (even channels x, odd y)."""
    xv = ins["Input"][0]
    _, c, h, w = xv.shape
    gy = torch.arange(h, dtype=xv.dtype, device=xv.device).reshape(1, 1, h, 1)
    gx = torch.arange(w, dtype=xv.dtype, device=xv.device).reshape(1, 1, 1, w)
    is_x = (torch.arange(c, device=xv.device) % 2 == 0).reshape(1, c, 1, 1)
    return {"Output": [4.0 * torch.where(is_x, gx, gy) - xv]}


@register_op("box_decoder_and_assign", no_grad=True)
def box_decoder_and_assign(ctx, ins, attrs):
    """Decode per-class deltas [N, C*4] against the priors [N, 4], then
    each roi's box for its argmax-score class (the first on a tie)."""
    prior = ins["PriorBox"][0]
    pvar = ins["PriorBoxVar"][0]
    deltas = ins["TargetBox"][0]
    scores = ins["BoxScore"][0]
    clip = float(attrs.get("box_clip", 4.135))
    n, c4 = deltas.shape
    c = c4 // 4
    pv = pvar.reshape(1, 1, 4) if pvar.dim() == 1 else pvar.reshape(n, 1, 4)
    d = deltas.reshape(n, c, 4) * pv
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    cx = d[..., 0] * pw[:, None] + pcx[:, None]
    cy = d[..., 1] * ph[:, None] + pcy[:, None]
    w = torch.exp(torch.clamp(d[..., 2], max=clip)) * pw[:, None]
    h = torch.exp(torch.clamp(d[..., 3], max=clip)) * ph[:, None]
    decoded = torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                           cx + 0.5 * w - 1, cy + 0.5 * h - 1], dim=-1)
    best = torch.argmax(scores, dim=1)
    assigned = torch.take_along_dim(
        decoded, best[:, None, None].expand(n, 1, 4), dim=1)[:, 0]
    return {"DecodeBox": [decoded.reshape(n, c4)],
            "OutputAssignBox": [assigned]}


# ---------------------------------------------------------------------------
# SSD matching
# ---------------------------------------------------------------------------

@register_op("bipartite_match", no_grad=True, infer=_bipartite_infer)
def bipartite_match(ctx, ins, attrs):
    """bipartite_match_op.cc over DistMat [B, N, M] (N gt rows, M priors):
    min(N, M) greedy steps, each matching the largest remaining entry (the
    first on a tie) if it is > 0 and blanking its row and column to -1,
    all images at once; then the ``per_prediction`` fill of unmatched
    columns whose best row reaches ``dist_threshold``."""
    dist = ins["DistMat"][0]
    if dist.dim() == 2:
        dist = dist[None]
    b, n, m = dist.shape
    dev = dist.device
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    d = dist
    col = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    for _ in range(min(n, m)):
        flat = torch.argmax(d.reshape(b, n * m), dim=1)
        i, j = flat // m, flat % m
        ok = torch.gather(d.reshape(b, n * m), 1, flat[:, None])[:, 0] > 0
        hit_col = (cols[None, :] == j[:, None]) & ok[:, None]
        hit_row = (rows[None, :] == i[:, None]) & ok[:, None]
        col = torch.where(hit_col, i[:, None].to(torch.int32), col)
        d = torch.where(hit_row[:, :, None] | hit_col[:, None, :],
                        -1.0, d)
    if attrs.get("match_type", "") == "per_prediction":
        thr = float(attrs.get("dist_threshold", 0.5))
        best_val, best_row = torch.max(dist, dim=1)
        fill = (col < 0) & (best_val >= thr)
        col = torch.where(fill, best_row.to(torch.int32), col)
    picked = torch.take_along_dim(dist, col.clamp(min=0).long()[:, None, :],
                                  dim=1)[:, 0]
    return {"ColToRowMatchIndices": [col],
            "ColToRowMatchDist": [torch.where(col >= 0, picked, 0.0)]}


@register_op("target_assign", no_grad=True)
def target_assign(ctx, ins, attrs):
    """target_assign_op.cc: Out[b, j] = X[b, match[b, j]] where matched,
    else ``mismatch_value``; OutWeight [B, M, 1] is 1 where matched."""
    xv = ins["X"][0]
    match = ins["MatchIndices"][0]
    if xv.dim() == 2:
        xv = xv[None]
    idx = match.clamp(min=0).long()[..., None]
    out = torch.take_along_dim(xv, idx, dim=1)
    matched = (match >= 0)[..., None]
    out = torch.where(matched, out,
                      out.new_full((), attrs.get("mismatch_value", 0)))
    return {"Out": [out], "OutWeight": [matched.to(torch.float32)]}


@register_op("mine_hard_examples", no_grad=True)
def mine_hard_examples(ctx, ins, attrs):
    """mine_hard_examples_op.cc, max_negative mining: per row keep the
    int(num_pos * neg_pos_ratio) highest-loss negatives (at most the
    negatives there are), ranked by a stable sort; priors whose match
    overlap reaches ``neg_overlap`` are no candidates. NegIndices is the
    dense 0/1 mask."""
    cls_loss = ins["ClsLoss"][0]
    match = ins["MatchIndices"][0]
    loc_loss = opt(ins, "LocLoss")
    match_dist = opt(ins, "MatchDist")
    ratio = float(attrs.get("neg_pos_ratio", 3.0))
    neg_overlap = float(attrs.get("neg_overlap", 0.5))
    loss = cls_loss if loc_loss is None else cls_loss + loc_loss
    m = loss.shape[1]
    is_pos = match >= 0
    num_pos = is_pos.to(torch.int32).sum(dim=1, dtype=torch.int32)
    num_neg = torch.minimum((num_pos * ratio).to(torch.int32), m - num_pos)
    neg_loss = torch.where(is_pos, float("-inf"), loss)
    if match_dist is not None:
        neg_loss = torch.where(match_dist >= neg_overlap, float("-inf"),
                               neg_loss)
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    neg_mask = (rank < num_neg[:, None]) & ~is_pos
    return {"NegIndices": [neg_mask.to(torch.int32)],
            "UpdatedMatchIndices": [match]}


# ---------------------------------------------------------------------------
# NMS family
# ---------------------------------------------------------------------------

@register_op("multiclass_nms", no_grad=True)
def multiclass_nms(ctx, ins, attrs):
    """multiclass_nms_op.cc under static shapes, every image and every
    non-background class at once: the top ``nms_top_k`` boxes of each
    class, greedy suppression (``greedy_nms``, eta-adaptive threshold),
    then the ``keep_top_k`` best kept rows of each image over all
    classes. Out [B, keep_top_k, 6] rows (class, score, x1, y1, x2, y2),
    padded with class -1 and score 0 (the reference emits a ragged LoD)."""
    boxes = ins["BBoxes"][0]
    scores = ins["Scores"][0]
    bg = int(attrs.get("background_label", 0))
    st = float(attrs.get("score_threshold", 0.0))
    nms_thr = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", 400))
    keep_top_k = int(attrs.get("keep_top_k", 200))
    eta = float(attrs.get("nms_eta", 1.0))
    b, c, m = scores.shape
    k = min(nms_top_k, m)
    cls_ids = torch.arange(c, dtype=torch.float32, device=scores.device)
    if 0 <= bg < c:
        scores = torch.cat([scores[:, :bg], scores[:, bg + 1:]], dim=1)
        cls_ids = torch.cat([cls_ids[:bg], cls_ids[bg + 1:]])
    nc = scores.shape[1]
    if nc == 0:
        out = torch.zeros((b, keep_top_k, 6), dtype=torch.float32,
                          device=boxes.device)
        out[..., 0] = -1.0
        return {"Out": [out]}
    top_sc, top_idx = top_k_total_order(scores, k)         # [B, C', k]
    bx_k = torch.take_along_dim(boxes[:, None], top_idx[..., None], dim=2)
    keep = greedy_nms(_pairwise_iou(bx_k), top_sc > st, nms_thr, eta)
    sc = torch.where(keep, top_sc, float("-inf")).reshape(b, nc * k)
    fin_sc, fin_idx = top_k_total_order(sc, min(keep_top_k, nc * k))
    fin_box = torch.take_along_dim(bx_k.reshape(b, nc * k, 4),
                                   fin_idx[..., None], dim=1)
    cls = cls_ids[:, None].expand(nc, k).reshape(-1)[fin_idx]
    live = torch.isfinite(fin_sc)
    return {"Out": [torch.cat(
        [torch.where(live, cls, -1.0)[..., None],
         torch.where(live, fin_sc, 0.0)[..., None], fin_box], dim=-1)]}


@register_op("generate_proposals", no_grad=True)
def generate_proposals(ctx, ins, attrs):
    """generate_proposals_op.cc under static shapes, all images at once:
    the top ``pre_nms_topN`` anchors by score, their deltas decoded
    (+1 box convention, log-space clamp at 10), clipped to the image,
    min-size filtered, greedy NMS, then the best ``post_nms_topN`` kept
    rows (zero boxes and scores pad, instead of the reference's LoD)."""
    scores = ins["Scores"][0]
    deltas = ins["BboxDeltas"][0]
    im_info = ins["ImInfo"][0]
    anchors = ins["Anchors"][0].reshape(-1, 4)
    variances = ins["Variances"][0].reshape(-1, 4)
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    thresh = float(attrs.get("nms_thresh", 0.7))
    min_size = float(attrs.get("min_size", 0.1))
    n, a, h, w = scores.shape
    total = a * h * w
    pre_n = min(pre_n, total)
    sc_flat = scores.permute(0, 2, 3, 1).reshape(n, total)
    dl_flat = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        n, total, 4)
    top_sc, idx = top_k_total_order(sc_flat, pre_n)        # [N, pre]
    anc = anchors[idx]
    var = variances[idx]
    d = torch.take_along_dim(dl_flat, idx[..., None], dim=1)
    aw = anc[..., 2] - anc[..., 0] + 1.0
    ah = anc[..., 3] - anc[..., 1] + 1.0
    acx = anc[..., 0] + aw / 2
    acy = anc[..., 1] + ah / 2
    cx = var[..., 0] * d[..., 0] * aw + acx
    cy = var[..., 1] * d[..., 1] * ah + acy
    bw = torch.exp(torch.clamp(var[..., 2] * d[..., 2], max=10.0)) * aw
    bh = torch.exp(torch.clamp(var[..., 3] * d[..., 3], max=10.0)) * ah
    ih = (im_info[:, 0] - 1)[:, None]
    iw = (im_info[:, 1] - 1)[:, None]
    lo = ZERO.to(scores.dtype)
    boxes = torch.stack(
        [torch.minimum(torch.maximum(cx - bw / 2, lo), iw),
         torch.minimum(torch.maximum(cy - bh / 2, lo), ih),
         torch.minimum(torch.maximum(cx + bw / 2 - 1, lo), iw),
         torch.minimum(torch.maximum(cy + bh / 2 - 1, lo), ih)], dim=-1)
    ms = (min_size * im_info[:, 2])[:, None]
    keep_size = ((boxes[..., 2] - boxes[..., 0] + 1 >= ms)
                 & (boxes[..., 3] - boxes[..., 1] + 1 >= ms))
    keep = greedy_nms(_pairwise_iou(boxes), keep_size, thresh)
    sc_m = torch.where(keep, top_sc, float("-inf"))
    fin_sc, fin_idx = top_k_total_order(sc_m, min(post_n, pre_n))
    fin_boxes = torch.take_along_dim(boxes, fin_idx[..., None], dim=1)
    ok = torch.isfinite(fin_sc)
    return {"RpnRois": [torch.where(ok[..., None], fin_boxes, 0.0)],
            "RpnRoiProbs": [torch.where(ok, fin_sc, 0.0)[..., None]]}


@register_op("collect_fpn_proposals", no_grad=True)
def collect_fpn_proposals(ctx, ins, attrs):
    """Concatenate the per-level rois and scores and keep the best
    ``post_nms_topN`` rows (zero rows pad to exactly that many)."""
    rois = torch.cat(list(ins["MultiLevelRois"]), dim=0)
    scores = torch.cat([s.reshape(-1) for s in ins["MultiLevelScores"]])
    top_n = int(attrs.get("post_nms_topN", 100))
    k = min(top_n, scores.shape[0])
    _, idx = top_k_total_order(scores, k)
    out = rois[idx]
    if k < top_n:
        out = torch.cat([out, out.new_zeros((top_n - k, 4))], dim=0)
    return {"FpnRois": [out]}


@register_op("retinanet_detection_output", no_grad=True)
def retinanet_detection_output(ctx, ins, attrs):
    """retinanet_detection_output: per FPN level the ``nms_top_k``
    anchors of best class probability, their deltas decoded and clipped;
    the levels concatenated into ``multiclass_nms`` with no background
    class. Out [B, keep_top_k, 6], class -1 pads."""
    st = float(attrs.get("score_threshold", 0.05))
    nms_top_k = int(attrs.get("nms_top_k", 1000))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    nms_thr = float(attrs.get("nms_threshold", 0.3))
    im_info = ins["ImInfo"][0]
    imh = im_info[:, 0].reshape(-1, 1)
    imw = im_info[:, 1].reshape(-1, 1)
    dec_boxes, dec_scores = [], []
    for delta, sc, anc in zip(ins["BBoxes"], ins["Scores"], ins["Anchors"]):
        ai = delta.shape[1]
        p = torch.sigmoid(sc)
        _, idx = top_k_total_order(p.amax(dim=-1), min(nms_top_k, ai))
        d = torch.take_along_dim(delta, idx[..., None], dim=1)
        pk = torch.take_along_dim(p, idx[..., None], dim=1)
        an = anc[idx]
        aw = an[..., 2] - an[..., 0] + 1.0
        ah = an[..., 3] - an[..., 1] + 1.0
        acx = an[..., 0] + 0.5 * aw
        acy = an[..., 1] + 0.5 * ah
        cx = d[..., 0] * aw + acx
        cy = d[..., 1] * ah + acy
        w = torch.exp(d[..., 2]) * aw
        h = torch.exp(d[..., 3]) * ah
        lo = ZERO.to(delta.dtype)
        dec_boxes.append(torch.stack(
            [torch.minimum(torch.maximum(cx - 0.5 * w, lo), imw - 1),
             torch.minimum(torch.maximum(cy - 0.5 * h, lo), imh - 1),
             torch.minimum(torch.maximum(cx + 0.5 * w, lo), imw - 1),
             torch.minimum(torch.maximum(cy + 0.5 * h, lo), imh - 1)],
            dim=-1))
        dec_scores.append(pk)
    return lookup("multiclass_nms").emitter(
        ctx, {"BBoxes": [torch.cat(dec_boxes, dim=1)],
              "Scores": [torch.cat(dec_scores, dim=1).transpose(1, 2)]},
        {"background_label": -1, "score_threshold": st,
         "nms_threshold": nms_thr, "nms_top_k": nms_top_k,
         "keep_top_k": keep_top_k})


@register_op("detection_map", no_grad=True, is_host=True)
def detection_map(ctx, ins, attrs):
    """detection_map_op.h, a host op: VOC mAP of dense detections
    [B, K, 6] against Label [B, G, 5] (class < 0 pads), by
    ``metrics._detection_map``, the arithmetic ``metrics.DetectionMAP``
    runs too. The accumulator outputs are zeros, as in the JAX package."""
    from ..metrics import _detection_map
    det = ins["DetectRes"][0]
    dev = det.device
    m_ap = _detection_map(det.detach().cpu().numpy(),
                          ins["Label"][0].detach().cpu().numpy(),
                          attrs.get("overlap_threshold", 0.5),
                          attrs.get("ap_type", "integral"))
    return {"MAP": [torch.tensor(m_ap, dtype=torch.float32, device=dev)],
            "AccumPosCount": [torch.zeros((), dtype=torch.int32, device=dev)],
            "AccumTruePos": [torch.zeros((), dtype=torch.float32,
                                         device=dev)],
            "AccumFalsePos": [torch.zeros((), dtype=torch.float32,
                                          device=dev)]}


# ---------------------------------------------------------------------------
# RoI ops
# ---------------------------------------------------------------------------

def _bin_masks(start, bin_size, n_bins, extent, dtype, at_least_one):
    """[N, n_bins, extent] membership of each pixel in each quantized bin
    (floor of the start, ceil of the end)."""
    dev = start.device
    i = torch.arange(n_bins, dtype=dtype, device=dev)
    lo = torch.floor(start[:, None] + i[None] * bin_size[:, None])
    hi = torch.ceil(start[:, None] + (i[None] + 1) * bin_size[:, None])
    if at_least_one:
        hi = torch.maximum(hi, lo + 1)
    px = torch.arange(extent, dtype=dtype, device=dev)
    return (px >= lo[..., None]) & (px < hi[..., None])


@register_op("roi_pool", intermediate_outputs=("Argmax",),
             infer=_roi_pool_like_infer(("Out", "Argmax")))
def roi_pool(ctx, ins, attrs):
    """roi_pool_op.cc: max over quantized RoI bins. ROIs [N, 4] in image
    coordinates, RoisBatch the optional image index of each. The bin max
    runs in two passes (over the bin's columns, then its rows), which is
    the same maximum as the JAX package's one pass over [H, W]."""
    xv = ins["X"][0]
    rois = ins["ROIs"][0]
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    _, _, h, w = xv.shape
    n = rois.shape[0]
    bidx = _roi_batch_idx(ins, n, xv.device)
    x1 = torch.round(rois[:, 0] * scale)
    y1 = torch.round(rois[:, 1] * scale)
    x2 = torch.round(rois[:, 2] * scale)
    y2 = torch.round(rois[:, 3] * scale)
    one = torch.ones((), dtype=xv.dtype)
    bin_w = _div(torch.maximum(x2 - x1 + 1, one), pw)
    bin_h = _div(torch.maximum(y2 - y1 + 1, one), ph)
    hm = _bin_masks(y1, bin_h, ph, h, xv.dtype, True)     # [N, ph, H]
    wm = _bin_masks(x1, bin_w, pw, w, xv.dtype, True)     # [N, pw, W]
    neg = torch.finfo(xv.dtype).min
    imgs = xv.index_select(0, bidx)                       # [N, C, H, W]
    cols = torch.where(wm[:, None, None], imgs[:, :, :, None, :],
                       neg).amax(dim=-1)                  # [N, C, H, pw]
    out = torch.where(hm[:, None, :, :, None], cols[:, :, None],
                      neg).amax(dim=3)                    # [N, C, ph, pw]
    return {"Out": [out],
            "Argmax": [torch.zeros(out.shape, dtype=torch.int32,
                                   device=out.device)]}


def _bilinear_weights(pos, extent, ratio):
    """[N, bins, r] sample coordinates -> [N, bins, extent]: each bin's
    mean over its r samples of the bilinear weights (1 - l at the floor,
    l at the next pixel, clamped into the map; zero outside [-1, extent])."""
    lo = torch.clamp(torch.floor(pos), 0, extent - 1)
    hi = torch.clamp(lo + 1, 0, extent - 1)
    frac = pos - lo
    px = torch.arange(extent, dtype=pos.dtype, device=pos.device)
    wts = ((px == lo[..., None]) * (1 - frac)[..., None]
           + (px == hi[..., None]) * frac[..., None])
    inb = (pos >= -1) & (pos <= extent)
    return _div(torch.where(inb[..., None], wts, 0.0).sum(dim=2), ratio)


def _pool_separable(xv, bidx, wy, wx):
    """out[n, c, i, j] = sum_{h, w} wy[n, i, h] wx[n, j, w] x[bidx[n], c,
    h, w], as two matrix products (the image picked by a one-hot row
    inside the first), so the gradient is a matrix product too."""
    b, c, h, w = xv.shape
    n, pw = wx.shape[0], wx.shape[1]
    ph = wy.shape[1]
    pick = (torch.arange(b, device=xv.device)[None] == bidx[:, None]).to(
        xv.dtype)                                         # [N, B]
    a = (pick[:, None, :, None] * wx[:, :, None, :]).reshape(n * pw, b * w)
    cols = a @ xv.permute(0, 3, 1, 2).reshape(b * w, c * h)
    cols = cols.reshape(n, pw, c, h).permute(0, 3, 1, 2)  # [N, H, pw, C]
    out = torch.bmm(wy, cols.reshape(n, h, pw * c))       # [N, ph, pw*C]
    return out.reshape(n, ph, pw, c).permute(0, 3, 1, 2)


@register_op("roi_align", infer=_roi_pool_like_infer(("Out",)))
def roi_align(ctx, ins, attrs):
    """roi_align_op.cc: the mean of bilinear samples a bin,
    ``sampling_ratio`` samples a side (2 where it is <= 0). The bilinear
    weights are separable, so the pooled map is ``_pool_separable``'s two
    matrix products; the ROIs' gradient flows through the weights."""
    xv = ins["X"][0]
    rois = ins["ROIs"][0]
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    ratio = int(attrs.get("sampling_ratio", -1))
    if ratio <= 0:
        ratio = 2
    _, _, h, w = xv.shape
    n = rois.shape[0]
    bidx = _roi_batch_idx(ins, n, xv.device)
    one = torch.ones((), dtype=xv.dtype)
    x1 = rois[:, 0] * scale
    y1 = rois[:, 1] * scale
    bw = _div(torch.maximum(rois[:, 2] * scale - x1, one), pw)
    bh = _div(torch.maximum(rois[:, 3] * scale - y1, one), ph)
    si = _div(torch.arange(ratio, dtype=xv.dtype, device=xv.device) + 0.5,
              ratio)

    def samples(start, size, bins):
        i = torch.arange(bins, dtype=xv.dtype, device=xv.device)
        return start[:, None, None] + (i[None, :, None] + si[None, None, :]
                                       ) * size[:, None, None]

    wy = _bilinear_weights(samples(y1, bh, ph), h, ratio)
    wx = _bilinear_weights(samples(x1, bw, pw), w, ratio)
    return {"Out": [_pool_separable(xv, bidx, wy, wx)]}


@register_op("psroi_pool",
             infer=_roi_pool_like_infer(("Out",), "output_channels"))
def psroi_pool(ctx, ins, attrs):
    """psroi_pool_op.cc: position-sensitive average pooling, channel
    k * (ph * pw) + i * pw + j feeding bin (i, j) of output channel k.
    Each bin's sum is a product with its row and column masks, contracted
    over the columns by one batched matrix product."""
    xv = ins["X"][0]
    rois = ins["ROIs"][0]
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    oc = int(attrs["output_channels"])
    scale = float(attrs.get("spatial_scale", 1.0))
    b, _, h, w = xv.shape
    n = rois.shape[0]
    bidx = _roi_batch_idx(ins, n, xv.device)
    x1 = torch.round(rois[:, 0] * scale)
    y1 = torch.round(rois[:, 1] * scale)
    x2 = torch.round(rois[:, 2] * scale) + 1.0
    y2 = torch.round(rois[:, 3] * scale) + 1.0
    floor = torch.full((), 0.1, dtype=xv.dtype)
    bh = _div(torch.maximum(y2 - y1, floor), ph)
    bw = _div(torch.maximum(x2 - x1, floor), pw)
    hm = _bin_masks(y1, bh, ph, h, xv.dtype, False).to(xv.dtype)  # [N,ph,H]
    wm = _bin_masks(x1, bw, pw, w, xv.dtype, False).to(xv.dtype)  # [N,pw,W]
    cnt = torch.clamp(hm.sum(-1)[:, :, None] * wm.sum(-1)[:, None, :], min=1)
    pick = (torch.arange(b, device=xv.device)[None] == bidx[:, None]).to(
        xv.dtype)                                          # [N, B]
    a = (pick[:, None, :, None] * wm[:, :, None, :])       # [N, pw, B, W]
    a = a.permute(1, 0, 2, 3).reshape(pw, n, b * w)
    xg = xv.reshape(b, oc, ph, pw, h, w).permute(3, 0, 5, 1, 2, 4).reshape(
        pw, b * w, oc * ph * h)
    cols = torch.bmm(a, xg).reshape(pw, n, oc, ph, h)      # sum over w
    summed = (cols.permute(1, 2, 3, 0, 4)
              * hm[:, None, :, None, :]).sum(-1)           # [N, oc, ph, pw]
    return {"Out": [summed / cnt[:, None]]}


@register_op("roi_perspective_transform", no_grad=True,
             infer=_roi_perspective_infer)
def roi_perspective_transform(ctx, ins, attrs):
    """roi_perspective_transform_op.cc: warp each quadrilateral ROI [N, 8]
    to a [transformed_height, transformed_width] patch by the induced
    perspective matrix, sampling bilinearly and zeroing points outside
    the quad (crossing number with the reference's edge epsilons)."""
    xv = ins["X"][0]
    rois = ins["ROIs"][0]
    th = int(attrs["transformed_height"])
    tw = int(attrs["transformed_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    _, _, h, w = xv.shape
    n = rois.shape[0]
    bidx = _roi_batch_idx(ins, n, xv.device)
    eps = 1e-4
    rx = rois[:, 0::2] * scale
    ry = rois[:, 1::2] * scale
    x0, x1, x2, x3 = (rx[:, k] for k in range(4))
    y0, y1, y2, y3 = (ry[:, k] for k in range(4))
    est_h = (torch.hypot(x1 - x2, y1 - y2) + torch.hypot(x3 - x0, y3 - y0)
             ) / 2.0
    est_w = (torch.hypot(x0 - x1, y0 - y1) + torch.hypot(x2 - x3, y2 - y3)
             ) / 2.0
    norm_w = torch.clamp(
        torch.round(est_w * (th - 1) / torch.clamp(est_h, min=eps)) + 1.0,
        max=float(tw))
    nw1 = torch.clamp(norm_w - 1.0, min=1.0)
    nh1 = float(max(th - 1, 1))
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < eps, eps, den)
    a31 = (dx3 * dy2 - dx2 * dy3) / den / nw1
    a32 = _div((dx1 * dy3 - dx3 * dy1) / den, nh1)
    a11 = (x1 - x0 + a31 * nw1 * x1) / nw1
    a12 = _div(x3 - x0 + a32 * nh1 * x3, nh1)
    a21 = (y1 - y0 + a31 * nw1 * y1) / nw1
    a22 = _div(y3 - y0 + a32 * nh1 * y3, nh1)
    ow = torch.arange(tw, dtype=xv.dtype, device=xv.device)[None, None, :]
    oh = torch.arange(th, dtype=xv.dtype, device=xv.device)[None, :, None]

    def coef(v):
        return v[:, None, None]

    u = coef(a11) * ow + coef(a12) * oh + coef(x0)
    v = coef(a21) * ow + coef(a22) * oh + coef(y0)
    ww = coef(a31) * ow + coef(a32) * oh + 1.0
    ww = torch.where(torch.abs(ww) < eps, eps, ww)
    px = u / ww
    py = v / ww

    def ge_e(a_, b_):
        return (a_ > b_) | (torch.abs(a_ - b_) < eps)

    def le_e(a_, b_):
        return (a_ < b_) | (torch.abs(a_ - b_) < eps)

    on_edge = torch.zeros(px.shape, dtype=torch.bool, device=xv.device)
    n_cross = torch.zeros(px.shape, dtype=torch.int32, device=xv.device)
    for i in range(4):
        xs, ys = coef(rx[:, i]), coef(ry[:, i])
        xe, ye = coef(rx[:, (i + 1) % 4]), coef(ry[:, (i + 1) % 4])
        horiz = torch.abs(ys - ye) < eps
        lo_y, hi_y = torch.minimum(ys, ye), torch.maximum(ys, ye)
        lo_x, hi_x = torch.minimum(xs, xe), torch.maximum(xs, xe)
        ix = (py - ys) * (xe - xs) / torch.where(horiz, 1.0, ye - ys) + xs
        on_edge = on_edge | (horiz & (torch.abs(py - ys) < eps)
                             & (torch.abs(py - ye) < eps)
                             & ge_e(px, lo_x) & le_e(px, hi_x))
        on_edge = on_edge | ((~horiz) & (torch.abs(ix - px) < eps)
                             & ge_e(py, lo_y) & le_e(py, hi_y))
        live = (~horiz) & ~le_e(py, lo_y) & ~((py - hi_y) > eps)
        n_cross = n_cross + (live & ((ix - px) > eps)).to(torch.int32)
    inside = on_edge | (n_cross % 2 == 1)
    inb = ((px > -0.5 - eps) & (px < w - 0.5 + eps)
           & (py > -0.5 - eps) & (py < h - 0.5 + eps))
    cx = torch.clamp(px, 0.0, w - 1)
    cy = torch.clamp(py, 0.0, h - 1)
    xf = torch.floor(cx)
    yf = torch.floor(cy)
    xc = torch.clamp(xf + 1, max=w - 1)
    yc = torch.clamp(yf + 1, max=h - 1)
    lx = cx - xf
    ly = cy - yf
    xl = xv.permute(0, 2, 3, 1)                            # [B, H, W, C]
    ni = bidx[:, None, None]

    def at(yy, xx):
        return xl[ni, yy.long(), xx.long()]                # [N, th, tw, C]

    val = (at(yf, xf) * ((1 - ly) * (1 - lx))[..., None]
           + at(yc, xf) * (ly * (1 - lx))[..., None]
           + at(yc, xc) * (ly * lx)[..., None]
           + at(yf, xc) * ((1 - ly) * lx)[..., None])
    out = torch.where((inside & inb)[..., None], val, 0.0)
    return {"Out": [out.permute(0, 3, 1, 2)]}


# ---------------------------------------------------------------------------
# two-stage and RetinaNet target assignment
# ---------------------------------------------------------------------------

def _plus_one_iou(boxes, gt):
    """IoU of [P, 4] against [G, 4] under the +1 box convention."""
    iw = torch.clamp(torch.minimum(boxes[:, None, 2], gt[None, :, 2])
                     - torch.maximum(boxes[:, None, 0], gt[None, :, 0]) + 1,
                     min=0)
    ih = torch.clamp(torch.minimum(boxes[:, None, 3], gt[None, :, 3])
                     - torch.maximum(boxes[:, None, 1], gt[None, :, 1]) + 1,
                     min=0)
    return iw * ih


def _box_deltas(src, gt):
    """(dx, dy, log dw, log dh) of ``gt`` against ``src`` rows, +1 box
    convention, unweighted: [P, 4] x4."""
    sw = src[:, 2] - src[:, 0] + 1.0
    sh = src[:, 3] - src[:, 1] + 1.0
    scx = src[:, 0] + sw / 2
    scy = src[:, 1] + sh / 2
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gcx = gt[:, 0] + gw / 2
    gcy = gt[:, 1] + gh / 2
    return ((gcx - scx) / sw, (gcy - scy) / sh, torch.log(gw / sw),
            torch.log(gh / sh))


def _rank(pri, cand):
    """Each row's place when candidates sort by priority (stable) and the
    rest (priority 2) after them."""
    key = torch.where(cand, pri, 2.0)
    return torch.argsort(torch.argsort(key, stable=True), stable=True)


@register_op("rpn_target_assign", no_grad=True, needs_rng=True)
def rpn_target_assign(ctx, ins, attrs):
    """rpn_target_assign_op.cc, dense: every anchor labelled 1 (IoU >=
    positive overlap, and each gt's best anchor), 0 (< negative overlap)
    or -1, then fg and bg subsampled to the batch budget by random
    priorities from the run's generator (the JAX package's threefry
    stream cannot be matched; the rule is the same); regression targets
    on fg rows and 0/1 index masks."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt_boxes = ins["GtBoxes"][0]
    pos_thr = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_thr = float(attrs.get("rpn_negative_overlap", 0.3))
    batch = int(attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    a = anchors.shape[0]
    dev = anchors.device
    ax1, ay1, ax2, ay2 = (anchors[:, i] for i in range(4))
    gx1, gy1, gx2, gy2 = (gt_boxes[:, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2[:, None], gx2[None])
                     - torch.maximum(ax1[:, None], gx1[None]), min=0)
    ih = torch.clamp(torch.minimum(ay2[:, None], gy2[None])
                     - torch.maximum(ay1[:, None], gy1[None]), min=0)
    inter = iw * ih
    aarea = torch.clamp(ax2 - ax1, min=0) * torch.clamp(ay2 - ay1, min=0)
    garea = torch.clamp(gx2 - gx1, min=0) * torch.clamp(gy2 - gy1, min=0)
    iou = inter / torch.clamp(aarea[:, None] + garea[None] - inter, min=1e-10)
    best_iou, best_gt = torch.max(iou, dim=1)
    label = torch.where(best_iou >= pos_thr, 1,
                        torch.where(best_iou < neg_thr, 0, -1))
    best_anchor = torch.argmax(iou, dim=0)
    is_best = (torch.arange(a, device=dev)[:, None]
               == best_anchor[None, :]).any(dim=1)
    label = torch.where(is_best, 1, label)
    pri = torch.rand((a,), generator=ctx.generator, device=dev,
                     dtype=torch.float32)
    fg_budget = int(batch * fg_frac)
    is_fg = label == 1
    label = torch.where(is_fg & (_rank(pri, is_fg) >= fg_budget), -1, label)
    n_fg = torch.clamp(is_fg.sum(), max=fg_budget)
    is_bg = label == 0
    label = torch.where(is_bg & (_rank(pri, is_bg) >= batch - n_fg), -1,
                        label)
    tgt = torch.stack(_box_deltas(anchors, gt_boxes[best_gt]), dim=1)
    fg = label == 1
    return {"TargetLabel": [label.to(torch.int32)],
            "TargetBBox": [torch.where(fg[:, None], tgt, 0.0)],
            "BBoxInsideWeight": [fg[:, None].to(torch.float32).expand(
                a, 4).contiguous()],
            "LocationIndex": [fg.to(torch.int32)],
            "ScoreIndex": [(label >= 0).to(torch.int32)]}


@register_op("generate_proposal_labels", no_grad=True)
def generate_proposal_labels(ctx, ins, attrs):
    """generate_proposal_labels_op.cc (Fast R-CNN stage-2 sampling) for
    one image: the gt boxes join the proposals, each row takes its best
    gt by +1 IoU (crowd gt rows excluded), fg (IoU > fg_thresh) up to
    fg_fraction of the batch and bg ([bg_lo, bg_hi)) for the rest,
    ordered fg, bg, padding; exactly ``batch_size_per_im`` rows (label -1
    and zero weights pad) with per-class regression targets. Priorities
    are random from the run's generator under ``use_random``, else the
    row order."""
    rois_in = ins["RpnRois"][0]
    gt_cls = ins["GtClasses"][0].reshape(-1)
    is_crowd = ins["IsCrowd"][0].reshape(-1)
    gt = ins["GtBoxes"][0]
    im_info = ins["ImInfo"][0].reshape(-1)
    batch = int(attrs.get("batch_size_per_im", 256))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_thresh = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    wts = [float(v) for v in attrs.get("bbox_reg_weights",
                                       [0.1, 0.1, 0.2, 0.2])]
    n_cls = int(attrs.get("class_nums", 81))
    dev = gt.device
    im_scale = im_info[2]
    boxes = torch.cat([gt, rois_in / im_scale], dim=0)
    p, g = boxes.shape[0], gt.shape[0]

    def area(bx):
        return (bx[:, 2] - bx[:, 0] + 1) * (bx[:, 3] - bx[:, 1] + 1)

    inter = _plus_one_iou(boxes, gt)
    iou = inter / (area(boxes)[:, None] + area(gt)[None, :] - inter)
    max_ov, best_gt = torch.max(iou, dim=1)
    row_crowd = torch.cat([is_crowd.to(torch.bool),
                           torch.zeros((p - g,), dtype=torch.bool,
                                       device=dev)])
    max_ov = torch.where(row_crowd, -1.0, max_ov)
    fg_cand = max_ov > fg_thresh
    bg_cand = (~fg_cand) & (max_ov >= bg_lo) & (max_ov < bg_hi)
    if attrs.get("use_random", True):
        # the op is not ``needs_rng`` (as in the JAX package), so a segment
        # without such an op runs with no generator: refuse, as JAX's
        # ``next_rng`` does, rather than draw from torch's global stream
        if ctx.generator is None:
            raise RuntimeError("op requested randomness but no PRNG key "
                               "was provided to the executor")
        pri = torch.rand((p,), generator=ctx.generator, device=dev,
                         dtype=torch.float32)
    else:
        pri = torch.arange(p, dtype=torch.float32, device=dev) / p
    fg_budget = int(np.floor(batch * fg_frac))
    fg_rank = _rank(pri, fg_cand)
    sel_fg = fg_cand & (fg_rank < fg_budget)
    bg_rank = _rank(pri, bg_cand)
    sel_bg = bg_cand & (bg_rank < batch - sel_fg.sum())
    pad = 2 * p + torch.arange(p, device=dev)
    key = torch.where(sel_fg, fg_rank, torch.where(sel_bg, p + bg_rank, pad))
    sorted_key, order = torch.sort(key, stable=True)
    if p < batch:
        order = torch.cat([order, order.new_zeros((batch - p,))])
        sorted_key = torch.cat([sorted_key,
                                sorted_key.new_full((batch - p,), 2 * p)])
    order = order[:batch]
    valid = sorted_key[:batch] < 2 * p
    sboxes = boxes[order]
    sfg = sel_fg[order] & valid
    labels = torch.where(sfg, gt_cls[best_gt[order]].to(torch.int32),
                         torch.where(valid, 0, -1).to(torch.int32))
    dx, dy, dw, dh = _box_deltas(sboxes, gt[best_gt[order]])
    delta = torch.stack([dx / wts[0], dy / wts[1], dw / wts[2],
                         dh / wts[3]], dim=1)
    cols = torch.arange(n_cls * 4, device=dev).reshape(1, n_cls * 4)
    own = (cols // 4) == labels[:, None]
    inw = sfg[:, None] & own
    tgt = torch.where(inw, delta.repeat(1, n_cls) * own, 0.0)
    inw = inw.to(torch.float32)
    return {"Rois": [sboxes * im_scale], "LabelsInt32": [labels],
            "BboxTargets": [tgt], "BboxInsideWeights": [inw],
            "BboxOutsideWeights": [inw]}


@register_op("retinanet_target_assign", no_grad=True)
def retinanet_target_assign(ctx, ins, attrs):
    """retinanet_target_assign, dense: every anchor's label (its best
    gt's class at IoU >= positive_overlap, 0 below negative_overlap, -1
    between; crowd gt ignored), fg regression targets, 0/1 index masks
    and the fg count (at least 1) for the focal loss."""
    anchors = ins["Anchor"][0]
    gt = ins["GtBoxes"][0]
    gt_labels = ins["GtLabels"][0].reshape(-1).to(torch.int32)
    is_crowd = ins["IsCrowd"][0].reshape(-1)
    pos_ov = float(attrs.get("positive_overlap", 0.5))
    neg_ov = float(attrs.get("negative_overlap", 0.4))
    inter = _plus_one_iou(anchors, gt)
    area_a = ((anchors[:, 2] - anchors[:, 0] + 1)
              * (anchors[:, 3] - anchors[:, 1] + 1))
    area_g = (gt[:, 2] - gt[:, 0] + 1) * (gt[:, 3] - gt[:, 1] + 1)
    iou = inter / torch.clamp(area_a[:, None] + area_g[None, :] - inter,
                              min=1e-10)
    iou = torch.where(is_crowd[None, :].to(torch.bool), 0.0, iou)
    max_ov, best = torch.max(iou, dim=1)
    label = torch.where(max_ov >= pos_ov, gt_labels[best],
                        torch.where(max_ov < neg_ov, 0, -1).to(torch.int32))
    fg = label > 0
    tgt = torch.stack(_box_deltas(anchors, gt[best]), dim=1)
    return {"PredictedScores": [label],
            "TargetLabel": [label[:, None]],
            "TargetBBox": [torch.where(fg[:, None], tgt, 0.0)],
            "BBoxInsideWeight": [fg[:, None].to(torch.float32).expand(
                -1, 4).contiguous()],
            "LocationIndex": [fg.to(torch.int32)],
            "ScoreIndex": [(label >= 0).to(torch.int32)],
            "ForegroundNumber": [torch.clamp(fg.sum(), min=1).reshape(1).to(
                torch.int32)]}


@register_op("sigmoid_focal_loss", infer=same_shape_infer())
def sigmoid_focal_loss(ctx, ins, attrs):
    """Focal loss (Lin et al., arXiv:1708.02002) of [N, C] logits against
    labels in 1..C (0 background), over FgNum (at least 1); rows labelled
    < 0 (ignored anchors) give zero."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).to(torch.int32)
    fg = ins["FgNum"][0].reshape(()).to(x.dtype)
    gamma = float(attrs.get("gamma", 2.0))
    alpha = float(attrs.get("alpha", 0.25))
    c = x.shape[1]
    pos = (torch.arange(1, c + 1, device=x.device)[None, :]
           == label[:, None])
    p = torch.sigmoid(x)
    loss_pos = -alpha * (1 - p) ** gamma * torch.nn.functional.logsigmoid(x)
    loss_neg = -(1 - alpha) * p ** gamma * torch.nn.functional.logsigmoid(-x)
    loss = torch.where(pos, loss_pos, loss_neg) / torch.clamp(fg, min=1.0)
    return {"Out": [torch.where((label >= 0)[:, None], loss, 0.0)]}


# ---------------------------------------------------------------------------
# YOLOv3
# ---------------------------------------------------------------------------

def _box_iou_xywh(x1, y1, w1, h1, x2, y2, w2, h2):
    """IoU of center-format boxes (broadcasting)."""
    l1, r1 = x1 - w1 / 2, x1 + w1 / 2
    t1, b1 = y1 - h1 / 2, y1 + h1 / 2
    l2, r2 = x2 - w2 / 2, x2 + w2 / 2
    t2, b2 = y2 - h2 / 2, y2 + h2 / 2
    iw = torch.clamp(torch.minimum(r1, r2) - torch.maximum(l1, l2), min=0)
    ih = torch.clamp(torch.minimum(b1, b2) - torch.maximum(t1, t2), min=0)
    inter = iw * ih
    return inter / torch.clamp(w1 * h1 + w2 * h2 - inter, min=1e-10)


@register_op("yolov3_loss", intermediate_outputs=("ObjectnessMask",
                                                  "GTMatchMask"),
             infer=_yolov3_loss_infer)
def yolov3_loss(ctx, ins, attrs):
    """yolov3_loss_op.h: per image, cells whose predicted box overlaps a
    gt above ``ignore_thresh`` are ignored by the objectness loss; each
    valid gt goes to its best anchor (by shape, over all anchors) if that
    anchor is in ``anchor_mask``, at its centre cell, with sigmoid-CE x/y
    and L1 w/h location loss scaled by (2 - w*h), per-class sigmoid CE,
    both weighted by GTScore; positives then take their objectness target
    from GTScore, a later gt winning a cell an earlier one shares (the
    JAX package's scan order).

    All gts at once: the per-gt terms are gathered at each gt's cell, and
    a gt writes its cell only if no later matched gt writes the same
    cell, so the writes have no duplicates. The gradient is the generic
    vjp."""
    xv = ins["X"][0]
    gt_box = ins["GTBox"][0]
    gt_label = ins["GTLabel"][0].to(torch.int64)
    gt_score = opt(ins, "GTScore")
    if gt_score is None:
        gt_score = torch.ones(gt_label.shape, dtype=torch.float32,
                              device=xv.device)
    anchors = [int(a) for a in attrs["anchors"]]
    anchor_mask = [int(a) for a in attrs["anchor_mask"]]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs["ignore_thresh"])
    downsample = int(attrs.get("downsample_ratio", 32))
    smooth = bool(attrs.get("use_label_smooth", False))
    n, _, h, w = xv.shape
    a = len(anchor_mask)
    an_num = len(anchors) // 2
    bnum = gt_box.shape[1]
    input_size = downsample * h
    dev = xv.device
    label_pos = 1.0 - min(1.0 / class_num, 1.0 / 40) if smooth else 1.0
    label_neg = min(1.0 / class_num, 1.0 / 40) if smooth else 0.0

    x5 = xv.reshape(n, a, 5 + class_num, h, w)
    tx, ty, tw, th = x5[:, :, 0], x5[:, :, 1], x5[:, :, 2], x5[:, :, 3]
    tobj = x5[:, :, 4]
    f32 = torch.float32
    # the masked anchors' widths and heights, every anchor's, and each
    # anchor's slot in the mask (-1 outside it), as one constant
    vec = _attr_vector(
        ctx, attrs,
        [anchors[2 * m] for m in anchor_mask]
        + [anchors[2 * m + 1] for m in anchor_mask]
        + anchors[0::2] + anchors[1::2]
        + [anchor_mask.index(i) if i in anchor_mask else -1
           for i in range(an_num)], f32, dev)
    aw, ah, all_aw_px, all_ah_px, mask_pos = vec.split(
        [a, a, an_num, an_num, an_num])
    aw, ah = aw.reshape(1, a, 1, 1), ah.reshape(1, a, 1, 1)
    mask_pos = mask_pos.to(torch.int32)

    # the ignore mask: no gradient flows through the comparison
    gx = _div(torch.arange(w, device=dev).reshape(1, 1, 1, w)
              + torch.sigmoid(tx.detach()), w)
    gy = _div(torch.arange(h, device=dev).reshape(1, 1, h, 1)
              + torch.sigmoid(ty.detach()), h)
    gw = _div(torch.exp(tw.detach()) * aw, input_size)
    gh = _div(torch.exp(th.detach()) * ah, input_size)
    gt_valid = (gt_box[..., 2] > 0) & (gt_box[..., 3] > 0)
    gtd = gt_box.detach()
    iou_all = _box_iou_xywh(
        gx[..., None], gy[..., None], gw[..., None], gh[..., None],
        gtd[:, None, None, None, :, 0], gtd[:, None, None, None, :, 1],
        gtd[:, None, None, None, :, 2], gtd[:, None, None, None, :, 3])
    iou_all = torch.where(gt_valid[:, None, None, None, :], iou_all, 0.0)
    obj_mask = torch.where(iou_all.amax(dim=-1) > ignore_thresh, -1.0, 0.0)

    # each gt's best anchor by shape, over all anchors
    zero = torch.zeros((), dtype=f32, device=dev)
    an_iou = _box_iou_xywh(zero, zero, gtd[..., 2:3], gtd[..., 3:4],
                           zero, zero, _div(all_aw_px, input_size)[None, None],
                           _div(all_ah_px, input_size)[None, None])
    best_n = torch.argmax(an_iou, dim=-1)                  # [N, B]
    mask_idx = mask_pos[best_n]
    gi = torch.clamp((gt_box[..., 0] * w).to(torch.int32), 0, w - 1)
    gj = torch.clamp((gt_box[..., 1] * h).to(torch.int32), 0, h - 1)
    matched = gt_valid & (mask_idx >= 0)

    cell = ((mask_idx.clamp(min=0).long() * h + gj.long()) * w
            + gi.long())                                   # [N, B]

    def at_cell(v):                                        # [N, A, H, W]
        return torch.gather(v.reshape(n, -1), 1, cell)

    gx_t = gt_box[..., 0] * w - gi
    gy_t = gt_box[..., 1] * h - gj
    gw_t = torch.log(torch.clamp(gt_box[..., 2] * input_size
                                 / all_aw_px[best_n], min=1e-9))
    gh_t = torch.log(torch.clamp(gt_box[..., 3] * input_size
                                 / all_ah_px[best_n], min=1e-9))
    scale = (2.0 - gt_box[..., 2] * gt_box[..., 3]) * gt_score
    ll = (_sce(at_cell(tx), gx_t) + _sce(at_cell(ty), gy_t)
          + torch.abs(at_cell(tw) - gw_t)
          + torch.abs(at_cell(th) - gh_t)) * scale
    tcls = x5[:, :, 5:].permute(0, 1, 3, 4, 2).reshape(n, a * h * w,
                                                       class_num)
    cls_at = torch.take_along_dim(tcls, cell[..., None], dim=1)  # [N, B, C]
    cls_target = torch.where(
        torch.arange(class_num, device=dev) == gt_label[..., None],
        label_pos, label_neg)
    lcls = _sce(cls_at, cls_target).sum(dim=-1) * gt_score
    loss = torch.where(matched, ll + lcls, 0.0).sum(dim=1)

    # positives' objectness targets: the last matched gt of a cell wins
    later = torch.ones(bnum, bnum, dtype=torch.bool, device=dev).triu(1)
    shared = ((cell[:, :, None] == cell[:, None, :]) & matched[:, None, :]
              & later)
    wins = matched & ~shared.any(dim=-1)
    hits = ((torch.arange(a * h * w, device=dev)[None, None, :]
             == cell[..., None]) & wins[..., None])        # [N, B, AHW]
    written = hits.any(dim=1)
    score_at = (hits.to(gt_score.dtype) * gt_score[..., None]).sum(dim=1)
    obj = torch.where(written, score_at, obj_mask.reshape(n, -1)).reshape(
        n, a, h, w)
    lobj = torch.where(obj > 1e-5, _sce(tobj, 1.0) * obj,
                       torch.where(obj > -0.5, _sce(tobj, 0.0), 0.0))
    return {"Loss": [loss + lobj.sum(dim=(1, 2, 3))],
            "ObjectnessMask": [obj], "GTMatchMask": [mask_idx]}


@register_op("yolo_box", no_grad=True, infer=_grid_infer("Boxes", "Scores"))
def yolo_box(ctx, ins, attrs):
    """Decode one YOLOv3 head [N, A*(5+C), H, W] into boxes [N, A*H*W, 4]
    (x1, y1, x2, y2 in image pixels, clipped) and scores [N, A*H*W, C] =
    sigmoid(obj) * sigmoid(cls), zero where the objectness is below
    ``conf_thresh``."""
    xv = ins["X"][0]
    img_size = ins["ImgSize"][0]
    anchors = [int(a) for a in attrs["anchors"]]
    class_num = int(attrs["class_num"])
    conf_thresh = float(attrs["conf_thresh"])
    downsample = int(attrs.get("downsample_ratio", 32))
    n, _, h, w = xv.shape
    a = len(anchors) // 2
    input_size = downsample * h
    dev = xv.device
    x5 = xv.reshape(n, a, 5 + class_num, h, w)
    grid_x = torch.arange(w, dtype=xv.dtype, device=dev)[None, None, None, :]
    grid_y = torch.arange(h, dtype=xv.dtype, device=dev)[None, None, :, None]
    bx = _div(torch.sigmoid(x5[:, :, 0]) + grid_x, w)
    by = _div(torch.sigmoid(x5[:, :, 1]) + grid_y, h)
    aw, ah = _attr_vector(ctx, attrs, anchors, xv.dtype,
                          dev).reshape(a, 2).t().reshape(2, 1, a, 1, 1)
    bw = _div(torch.exp(x5[:, :, 2]) * aw, input_size)
    bh = _div(torch.exp(x5[:, :, 3]) * ah, input_size)
    conf = torch.sigmoid(x5[:, :, 4])
    cls = torch.sigmoid(x5[:, :, 5:])
    img_h = img_size[:, 0].to(xv.dtype).reshape(n, 1, 1, 1)
    img_w = img_size[:, 1].to(xv.dtype).reshape(n, 1, 1, 1)
    lo = ZERO.to(xv.dtype)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, lo), hi - 1)

    boxes = torch.stack([clip((bx - bw / 2) * img_w, img_w),
                         clip((by - bh / 2) * img_h, img_h),
                         clip((bx + bw / 2) * img_w, img_w),
                         clip((by + bh / 2) * img_h, img_h)], dim=-1)
    live = (conf >= conf_thresh).to(xv.dtype)
    scores = cls * (conf * live)[:, :, None]
    m = a * h * w
    return {"Boxes": [boxes.reshape(n, m, 4)],
            "Scores": [torch.movedim(scores, 2, -1).reshape(n, m, class_num)]}
