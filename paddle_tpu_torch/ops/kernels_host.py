"""Host ops: save/load and save_combine/load_combine (checkpointing as
ops), print, ``py_func`` (a call into user Python), the ``feed`` and
``fetch`` markers, ``get_places``, ``delete_var``, ``tree_conv`` (a
data-dependent walk of each tree), and the two detection ops with
data-dependent row counts, ``generate_mask_labels`` and
``distribute_fpn_proposals``.

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
from .common import in_dtype, in_shape, set_out_var, slots_like_infer

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
    """A tensor as numpy on the host (bfloat16 as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@register_op("py_func", no_grad=True, is_host=True)
def py_func(ctx, ins, attrs):
    """py_func_op.cc: call ``attrs["func"]`` on the inputs as numpy
    arrays; its results come back as tensors on the run's device."""
    fn = attrs["func"]
    args = [_host(v) if v is not None else None for v in ins.get("X", [])]
    out = fn(*args)
    if out is None:
        return {}
    if not isinstance(out, (list, tuple)):
        out = [out]
    return {"Out": [torch.from_numpy(np.array(o)).to(ctx.device)
                    for o in out]}


@register_op("feed", no_grad=True, is_host=True)
def feed_op(ctx, ins, attrs):
    """controlflow/feed_op.cc: the executor binds feeds itself (and drops
    these markers from the ops it runs); the op forwards a bound value."""
    val = ins.get("X", [None])[0]
    return {"Out": [val]} if val is not None else {}


@register_op("fetch", no_grad=True, is_host=True,
             infer=slots_like_infer(("Out", "X")))
def fetch_op(ctx, ins, attrs):
    """controlflow/fetch_op.cc: fetches are the executor's
    ``fetch_list``; the op forwards its input."""
    return {"Out": [ins["X"][0]]}


@register_op("get_places", no_grad=True, is_host=True)
def get_places(ctx, ins, attrs):
    """controlflow/get_places_op.cc: the device ids as data, [0, n): n is
    ``device_count``, else the executor's devices (one)."""
    n = attrs.get("device_count", 0) or 1
    return {"Out": [torch.arange(n, dtype=torch.int64, device=ctx.device)]}


@register_op("delete_var", no_grad=True, is_host=True)
def delete_var(ctx, ins, attrs):
    """controlflow/delete_var_op.cc: drop the persistables named by
    ``var_names`` from the scope. A captured graph that reads one no
    longer replays: the next run finds the name gone (the executor's
    ``state_rebound``) and runs eagerly, which raises on the missing
    name."""
    if ctx.scope is not None:
        ctx.scope.erase(list(attrs.get("var_names") or []))
    return {}


def _tree_conv_infer(op, block):
    ns = in_shape(block, op, "NodesVector")
    fs = in_shape(block, op, "Filter")
    if ns is None or fs is None:
        return
    for n in op.output("Out"):
        set_out_var(block, n, [ns[0], ns[1], fs[2], fs[3]],
                    in_dtype(block, op, "NodesVector"))


def _tree_patches(edges, n, max_depth, s):
    """The patches of one sample's tree (tree2col.cc:24-49): per root, a
    depth-first walk bounded by ``max_depth`` collecting (node, 1-based
    child index, siblings, depth). EdgeSet rows are 1-indexed
    (parent, child); a (0, 0) row ends them."""
    tr = [[] for _ in range(n + 1)]
    node_count = 0
    for u, v in edges:
        u, v = int(u), int(v)
        if u == 0 or v == 0:
            break
        if not (1 <= u <= n and 1 <= v <= n):
            raise ValueError(
                f"tree_conv: EdgeSet sample {s} references node ({u},{v}) "
                f"outside 1..{n} (NodesVector has {n} node slots)")
        tr[u].append(v)
        node_count += 1
    node_count += 1
    if node_count > n:
        raise ValueError(
            f"tree_conv: EdgeSet sample {s} implies {node_count} nodes but "
            f"NodesVector holds only {n}")
    patches = []
    for root in range(1, node_count + 1):
        patch = [(root, 1, 1, 0)]
        stack = [root]
        depth_of = {root: 0}
        while stack:
            u = stack[-1]
            advanced = False
            for i, v in enumerate(tr[u]):
                if v not in depth_of and depth_of[u] + 1 < max_depth:
                    depth_of[v] = depth_of[u] + 1
                    stack.append(v)
                    patch.append((v, i + 1, len(tr[u]), depth_of[v]))
                    advanced = True
            if not advanced:
                stack.pop()
        patches.append(patch)
    return patches


@register_op("tree_conv", no_grad=True, is_host=True, infer=_tree_conv_infer)
def tree_conv(ctx, ins, attrs):
    """tree_conv_op.cc / math/tree2col.cc, the tree-based convolution of
    TBCNN (arXiv:1409.5718). The patches follow each tree's edges, so the
    op runs on the host as the JAX one does, in its float32 numpy
    arithmetic: each node of a root's patch adds its eta_l, eta_r and
    eta_t weighted features into a [3F] row, and Out = rows @ Filter
    flattened to [3F, output_size * num_filters]. NodesVector [B, N, F],
    EdgeSet [B, E, 2], Filter [F, 3, O, M]; Out [B, N, O, M]."""
    dev = ins["NodesVector"][0].device
    feats = _host(ins["NodesVector"][0])
    edges = _host(ins["EdgeSet"][0])
    filt = _host(ins["Filter"][0])
    max_depth = int(attrs.get("max_depth", 2))
    b, n, fdim = feats.shape
    f2, three, osz, m = filt.shape
    w = filt.reshape(f2 * three, osz * m)
    out = np.zeros((b, n, osz, m), feats.dtype)
    for s in range(b):
        patches = _tree_patches(edges[s], n, max_depth, s)
        prow = np.zeros((len(patches), 3 * fdim), feats.dtype)
        for pi, patch in enumerate(patches):
            for node, idx, pclen, depth in patch:
                eta_t = (max_depth - depth) / max_depth
                temp = 0.5 if pclen == 1 else (idx - 1.0) / (pclen - 1.0)
                eta_l = (1.0 - eta_t) * temp
                eta_r = (1.0 - eta_t) * (1.0 - temp)
                fv = feats[s, node - 1]
                prow[pi, 0::3] += eta_l * fv
                prow[pi, 1::3] += eta_r * fv
                prow[pi, 2::3] += eta_t * fv
        out[s, :len(patches)] = (prow @ w).reshape(-1, osz, m)
    return {"Out": [torch.from_numpy(out).to(dev)]}


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
