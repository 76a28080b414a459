"""Host ops: save/load and save_combine/load_combine (checkpointing as
ops), print, and the two detection ops with data-dependent row counts,
``generate_mask_labels`` and ``distribute_fpn_proposals``.

Counterpart of ``paddle_tpu/ops/kernels_host.py`` with the same tensor
file format, so parameter files cross-load between the two packages: a
small JSON header (shape, dtype, version) + raw little-endian bytes.
bfloat16 payloads are raw uint16 words.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from ..registry import register_op

MAGIC = b"PTPU"
VERSION = 1


def _write_tensor(f, t):
    t = torch.as_tensor(t).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        dt_name = "bfloat16"
        raw = t.view(torch.int16).numpy().tobytes()
    else:
        arr = t.numpy()
        dt_name = arr.dtype.name
        raw = arr.tobytes()
    header = json.dumps({"shape": list(t.shape), "dtype": dt_name,
                         "version": VERSION}).encode()
    f.write(MAGIC)
    f.write(struct.pack("<I", len(header)))
    f.write(header)
    f.write(raw)


def _read_tensor(f) -> torch.Tensor:
    if f.read(4) != MAGIC:
        raise ValueError("bad tensor file magic")
    (hlen,) = struct.unpack("<I", f.read(4))
    header = json.loads(f.read(hlen).decode())
    shape = tuple(header["shape"])
    n = int(np.prod(shape)) if shape else 1
    if header["dtype"] == "bfloat16":
        raw = np.frombuffer(f.read(2 * n), dtype=np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16).reshape(shape)
    dt = np.dtype(header["dtype"])
    raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt).copy()
    return torch.from_numpy(raw).reshape(shape)


def save_tensor_to_file(path: str, t):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        _write_tensor(f, t)


def load_tensor_from_file(path: str) -> torch.Tensor:
    with open(path, "rb") as f:
        return _read_tensor(f)


@register_op("save", no_grad=True, is_host=True)
def save(ctx, ins, attrs):
    save_tensor_to_file(attrs["file_path"], ins["X"][0])
    return {}


@register_op("load", no_grad=True, is_host=True)
def load(ctx, ins, attrs):
    return {"Out": [load_tensor_from_file(attrs["file_path"]).to(ctx.device)]}


@register_op("save_combine", no_grad=True, is_host=True)
def save_combine(ctx, ins, attrs):
    """Many tensors into one container file."""
    path = attrs["file_path"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(ins["X"])))
        for val in ins["X"]:
            _write_tensor(f, val)
    return {}


@register_op("load_combine", no_grad=True, is_host=True)
def load_combine(ctx, ins, attrs):
    with open(attrs["file_path"], "rb") as f:
        (n,) = struct.unpack("<I", f.read(4))
        vals = [_read_tensor(f).to(ctx.device) for _ in range(n)]
    return {"Out": vals}


@register_op("print", no_grad=True, is_host=True)
def print_op(ctx, ins, attrs):
    """print_op.cc analog: the input's shape, dtype and values on the
    host's standard output (a host op: it waits for the device)."""
    msg = attrs.get("message", "")
    for v in ins["In"]:
        arr = torch.as_tensor(v).detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        arr = arr.numpy()
        parts = [msg or "Variable:"]
        if attrs.get("print_tensor_shape", True):
            parts.append(f"shape={list(arr.shape)}")
        if attrs.get("print_tensor_type", True):
            parts.append(f"dtype={arr.dtype}")
        if attrs.get("print_tensor_stats", False) and arr.size:
            parts.append(f"min={arr.min()} max={arr.max()} mean={arr.mean()}")
        print(" ".join(parts))
        if attrs.get("print_tensor_value", True):
            print(arr)
    return {"Out": list(ins["In"])}


def _host(t):
    return t.detach().cpu().numpy()


def _rasterize_polys(polys, resolution):
    """Even-odd fill of a polygon union on the pixel-centre grid (the
    stand-in for mask_util.cc Polys2MaskWrtBox's RLE rasterizer)."""
    yy, xx = np.mgrid[0:resolution, 0:resolution]
    px = xx + 0.5
    py = yy + 0.5
    mask = np.zeros((resolution, resolution), bool)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        inside = np.zeros_like(mask)
        x0s, y0s = pts[:, 0], pts[:, 1]
        x1s, y1s = np.roll(x0s, -1), np.roll(y0s, -1)
        for ex0, ey0, ex1, ey1 in zip(x0s, y0s, x1s, y1s):
            if ey0 == ey1:
                continue
            crosses = ((ey0 > py) != (ey1 > py)) & (
                px < (ex1 - ex0) * (py - ey0) / (ey1 - ey0) + ex0)
            inside ^= crosses
        mask |= inside
    return mask.astype(np.uint8)


@register_op("generate_mask_labels", no_grad=True, is_host=True)
def generate_mask_labels(ctx, ins, attrs):
    """generate_mask_labels_op.cc (Mask R-CNN mask-head targets), a host
    op: each foreground roi (label > 0) takes the gt whose polygon box
    overlaps it most (+1 IoU), whose polygons, cropped and scaled to the
    roi, rasterize to a resolution^2 mask in the roi's class slot (-1
    elsewhere). GtSegms [G, P, V, 2] with SegmsLength [G, P] vertex counts
    is the dense stand-in for the 3-level LoD input. Without a foreground
    roi or a polygon: one row with an all-ignore mask."""
    dev = ins["Rois"][0].device
    im_info = _host(ins["ImInfo"][0]).reshape(-1)
    gt_classes = _host(ins["GtClasses"][0]).reshape(-1)
    is_crowd = _host(ins["IsCrowd"][0]).reshape(-1)
    segms = _host(ins["GtSegms"][0])
    seg_len = _host(ins["SegmsLength"][0])
    rois = _host(ins["Rois"][0])
    labels = _host(ins["LabelsInt32"][0]).reshape(-1)
    num_classes = int(attrs["num_classes"])
    res = int(attrs["resolution"])
    im_scale = float(im_info[2])

    gt_polys, boxes = [], []
    for i in range(len(gt_classes)):
        if gt_classes[i] <= 0 or is_crowd[i]:
            continue
        polys = [segms[i, j, :seg_len[i, j]].reshape(-1, 2)
                 for j in range(segms.shape[1]) if seg_len[i, j] >= 3]
        if not polys:
            continue
        gt_polys.append(polys)
        allp = np.concatenate(polys, axis=0)
        boxes.append([allp[:, 0].min(), allp[:, 1].min(),
                      allp[:, 0].max(), allp[:, 1].max()])
    fg = np.flatnonzero(labels > 0)
    m2 = res * res

    def out(mask_rois, has_mask, masks):
        return {"MaskRois": [torch.from_numpy(mask_rois).to(dev)],
                "RoiHasMaskInt32": [torch.from_numpy(has_mask).to(dev)],
                "MaskInt32": [torch.from_numpy(masks).to(dev)]}

    if len(fg) == 0 or not gt_polys:
        return out(rois[:1].astype(np.float32), np.zeros((1, 1), np.int32),
                   -np.ones((1, m2 * num_classes), np.int32))
    boxes = np.asarray(boxes, np.float64)
    rois_fg = rois[fg].astype(np.float64) / im_scale
    ix1 = np.maximum(rois_fg[:, None, 0], boxes[None, :, 0])
    iy1 = np.maximum(rois_fg[:, None, 1], boxes[None, :, 1])
    ix2 = np.minimum(rois_fg[:, None, 2], boxes[None, :, 2])
    iy2 = np.minimum(rois_fg[:, None, 3], boxes[None, :, 3])
    inter = np.maximum(ix2 - ix1 + 1, 0) * np.maximum(iy2 - iy1 + 1, 0)

    def area(b):
        return (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)

    match = np.argmax(inter / (area(rois_fg)[:, None] + area(boxes)[None]
                               - inter), axis=1)
    expanded = -np.ones((len(fg), m2 * num_classes), np.int32)
    for k, ridx in enumerate(fg):
        x1, y1, x2, y2 = rois_fg[k]
        w = max(x2 - x1, 1.0)
        h = max(y2 - y1, 1.0)
        scaled = [np.stack([(p[:, 0] - x1) * res / w,
                            (p[:, 1] - y1) * res / h], axis=1)
                  for p in gt_polys[match[k]]]
        cls = int(labels[ridx])
        expanded[k, m2 * cls:m2 * (cls + 1)] = _rasterize_polys(
            scaled, res).reshape(-1)
    return out(rois[fg].astype(np.float32),
               fg.reshape(-1, 1).astype(np.int32), expanded)


@register_op("distribute_fpn_proposals", no_grad=True, is_host=True)
def distribute_fpn_proposals(ctx, ins, attrs):
    """A host op: each roi goes to FPN level floor(refer_level +
    log2(sqrt(area) / refer_scale)), clamped to [min_level, max_level];
    one rois tensor a level (their row counts depend on the data) and
    RestoreIndex, which maps the concatenated level order back to the
    input order."""
    dev = ins["FpnRois"][0].device
    rois = _host(ins["FpnRois"][0])
    min_level = int(attrs["min_level"])
    max_level = int(attrs["max_level"])
    refer_level = int(attrs["refer_level"])
    refer_scale = int(attrs["refer_scale"])
    w = np.maximum(rois[:, 2] - rois[:, 0], 0.0)
    h = np.maximum(rois[:, 3] - rois[:, 1], 0.0)
    lvl = np.floor(refer_level + np.log2(
        np.maximum(np.sqrt(w * h), 1e-6) / refer_scale))
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, order = [], []
    for level in range(min_level, max_level + 1):
        idx = np.flatnonzero(lvl == level)
        order.append(idx)
        outs.append(torch.from_numpy(np.ascontiguousarray(rois[idx])).to(dev))
    order = np.concatenate(order)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    return {"MultiFpnRois": outs,
            "RestoreIndex": [torch.from_numpy(
                restore.reshape(-1, 1).astype(np.int32)).to(dev)]}
