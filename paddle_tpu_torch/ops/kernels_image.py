"""Image ops (counterpart of ``paddle_tpu/ops/kernels_image.py``):
``affine_channel``, the op conv_affine_channel_fuse_pass folds into a
conv, ``is_empty``, the resize ops ``interpolate``, ``bilinear_interp``
and ``nearest_interp`` (one emitter, three names), the per-example
``random_crop`` of a raw-image feed, and the rest of the JAX package's
image and vision ops: lrn, crop, pad_constant_like, shuffle_channel,
space_to_depth, max_pool2d_with_index and unpool, selu, multiplex,
sampling_id, norm, data_norm, bilinear_tensor_product, mean_iou,
conv_shift, fill, reverse, gaussian_random_batch_size_like,
grid_sampler, affine_grid, spp and similarity_focus.

Each is the JAX emitter's arithmetic in torch ops. Random ops draw on the
device from the run's generator, with no host read, so a program holding
them can be captured. Gathers are index arithmetic; the scatter-adds
(unpool's, and the gradient of grid_sampler's gathers) take the
library's deterministic implementation under
``torch.use_deterministic_algorithms``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.desc import OpDesc
from ..core.types import DataType, dtype_to_torch
from ..registry import register_op
from .common import (batch_size_like_infer, batch_size_like_shape,
                     in_dtype, in_shape, opt, same_shape_infer,
                     scalar_infer, set_out_var, slots_like_infer, true_div,
                     x)
from .kernels_nn import window_max_with_index


@register_op("affine_channel", infer=same_shape_infer())
def affine_channel(ctx, ins, attrs):
    """affine_channel_op.cc: x * Scale[C] + Bias[C] over NCHW."""
    xv = ins["X"][0]
    shape = (1, -1) + (1,) * (xv.dim() - 2)
    return {"Out": [xv * ins["Scale"][0].reshape(shape)
                    + ins["Bias"][0].reshape(shape)]}


@register_op("is_empty", no_grad=True,
             infer=scalar_infer(dtype="bool", shape=(1,)))
def is_empty(ctx, ins, attrs):
    """is_empty_op.cc: numel(X) == 0, a 0-d bool known from the shape
    (filled on the device, so the op can be captured)."""
    xv = ins["X"][0]
    return {"Out": [torch.full((), xv.numel() == 0, dtype=torch.bool,
                               device=xv.device)]}


def _interp_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is not None:
        for n in op.output("Out"):
            set_out_var(block, n, [xs[0], xs[1], op.attrs.get("out_h"),
                                   op.attrs.get("out_w")],
                        in_dtype(block, op, "X"))


def _src_index(out_size, in_size, align_corners, device):
    """Source coordinate of each output row (interpolate_op.cc): the
    corner-aligned ratio, or the half-pixel rule clamped at 0."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        if out_size == 1:
            return torch.zeros((1,), dtype=torch.float32, device=device)
        return true_div(i * (in_size - 1), out_size - 1)
    return torch.clamp((i + 0.5) * (in_size / out_size) - 0.5, min=0.0)


@register_op("interpolate", infer=_interp_infer)
def interpolate(ctx, ins, attrs):
    """interpolate_op.cc: bilinear or nearest resize of NCHW maps to the
    static ``out_h`` x ``out_w`` (nearest rounds half to even, as
    ``jnp.round`` does). Rows and columns are picked by ``index_select``,
    whose gradient is an index add."""
    xv = ins["X"][0]
    _, _, h, w = xv.shape
    if ins.get("OutSize") and ins["OutSize"][0] is not None:
        raise ValueError("interpolate requires static out_h/out_w attrs "
                         "(a dynamic OutSize tensor is unsupported)")
    oh, ow = int(attrs["out_h"]), int(attrs["out_w"])
    ac = bool(attrs.get("align_corners", True))
    fh = _src_index(oh, h, ac, xv.device)
    fw = _src_index(ow, w, ac, xv.device)
    if attrs.get("interp_method", "bilinear") == "nearest":
        ih = torch.clamp(torch.round(fh), 0, h - 1).long()
        iw = torch.clamp(torch.round(fw), 0, w - 1).long()
        return {"Out": [xv.index_select(2, ih).index_select(3, iw)]}
    h0 = torch.clamp(torch.floor(fh).long(), 0, h - 1)
    h1 = torch.clamp(h0 + 1, 0, h - 1)
    w0 = torch.clamp(torch.floor(fw).long(), 0, w - 1)
    w1 = torch.clamp(w0 + 1, 0, w - 1)
    lh = (fh - h0).to(xv.dtype)[None, None, :, None]
    lw = (fw - w0).to(xv.dtype)[None, None, None, :]
    r0, r1 = xv.index_select(2, h0), xv.index_select(2, h1)
    v00, v01 = r0.index_select(3, w0), r0.index_select(3, w1)
    v10, v11 = r1.index_select(3, w0), r1.index_select(3, w1)
    return {"Out": [v00 * (1 - lh) * (1 - lw) + v01 * (1 - lh) * lw
                    + v10 * lh * (1 - lw) + v11 * lh * lw]}


@register_op("bilinear_interp", infer=_interp_infer)
def bilinear_interp(ctx, ins, attrs):
    return interpolate(ctx, ins, dict(attrs, interp_method="bilinear"))


@register_op("nearest_interp", infer=_interp_infer)
def nearest_interp(ctx, ins, attrs):
    return interpolate(ctx, ins, dict(attrs, interp_method="nearest"))


# ---------------------------------------------------------------------------
# the raw-image crop
# ---------------------------------------------------------------------------

def _random_crop_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is None:
        return
    shape = list(op.attrs.get("shape", []))
    lead = len(xs) - len(shape)
    for n in op.output("Out"):
        set_out_var(block, n, list(xs[:lead]) + shape,
                    in_dtype(block, op, "X"))


@register_op("random_crop", needs_rng=True, no_grad=True,
             intermediate_outputs=("SeedOut",), infer=_random_crop_infer)
def random_crop(ctx, ins, attrs):
    """random_crop_op.h: a crop of the attr ``shape`` over X's trailing
    dims, each example (each index of the leading dims) at offsets of its
    own, uniform over [0, dim - size] in each cropped dim. The offsets
    are drawn on X's device from the run's generator (no host read, so
    the op can be captured; the JAX package's threefry draws give other
    offsets) and the crop is one gather by index arithmetic. With no
    leading dim the one crop's offsets are drawn alike. SeedOut is a
    zero, as in the JAX op."""
    xv = ins["X"][0]
    shape = [int(v) for v in attrs["shape"]]
    k = len(shape)
    lead_shape = tuple(xv.shape[:xv.dim() - k])
    flat = xv.reshape((-1,) + tuple(xv.shape[xv.dim() - k:]))
    n, dev = flat.shape[0], xv.device
    index = [torch.arange(n, device=dev).reshape((n,) + (1,) * k)]
    for i, size in enumerate(shape):
        start = torch.randint(0, flat.shape[1 + i] - size + 1, (n,),
                              generator=ctx.generator, device=dev)
        at = [1] * k
        at[i] = size
        index.append(start.reshape((n,) + (1,) * k)
                     + torch.arange(size, device=dev).reshape([1] + at))
    out = flat[tuple(index)].reshape(lead_shape + tuple(shape))
    return {"Out": [out],
            "SeedOut": [torch.zeros((1,), dtype=torch.int64, device=dev)]}


# ---------------------------------------------------------------------------
# normalization, cropping and padding
# ---------------------------------------------------------------------------

@register_op("lrn", intermediate_outputs=("MidOut",),
             infer=same_shape_infer())
def lrn(ctx, ins, attrs):
    """lrn_op.cc: cross-channel local response normalization, x / (k +
    alpha * the sum of x^2 over the n channels centred on each)^beta,
    the window summed in the JAX op's order (offsets -n/2 to n/2, the
    out-of-range channels zero); MidOut is k + alpha * the sum."""
    xv = ins["X"][0]
    n = int(attrs.get("n", 5))
    k = float(attrs.get("k", 2.0))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    half = n // 2
    sq = xv * xv
    c = xv.shape[1]
    acc = torch.zeros_like(xv)
    for off in range(-half, half + 1):
        idx = torch.arange(c, device=xv.device) - off
        valid = ((idx >= 0) & (idx < c)).reshape(1, c, 1, 1)
        acc = acc + torch.where(valid, torch.roll(sq, off, dims=1),
                                torch.zeros((), dtype=xv.dtype,
                                            device=xv.device))
    mid = k + alpha * acc
    return {"Out": [xv / mid ** beta], "MidOut": [mid]}


def _crop_infer(op: OpDesc, block):
    shape = [int(s) for s in op.attrs.get("shape", []) or []]
    if not shape:
        shape = in_shape(block, op, "Y") or []
    if shape:
        for n in op.output("Out"):
            set_out_var(block, n, shape, in_dtype(block, op, "X"))


@register_op("crop", infer=_crop_infer)
def crop(ctx, ins, attrs):
    """crop_op.cc: the slice of X at the static ``offsets`` of the attr
    ``shape`` (or of Y's shape, when Y is given)."""
    xv = ins["X"][0]
    y = opt(ins, "Y")
    shape = y.shape if y is not None else attrs.get("shape")
    offsets = attrs.get("offsets", [0] * xv.dim())
    return {"Out": [xv[tuple(slice(int(o), int(o) + int(s))
                             for o, s in zip(offsets, shape))]]}


@register_op("pad_constant_like", infer=slots_like_infer(("Out", "X")))
def pad_constant_like(ctx, ins, attrs):
    """pad_constant_like_op.cc: Y padded at the end of each dim with
    ``pad_value`` up to X's shape."""
    xv, yv = ins["X"][0], ins["Y"][0]
    widths = [v for xs, ys in zip(reversed(xv.shape), reversed(yv.shape))
              for v in (0, xs - ys)]
    return {"Out": [F.pad(yv, widths,
                          value=float(attrs.get("pad_value", 0.0)))]}


@register_op("shuffle_channel", infer=same_shape_infer())
def shuffle_channel(ctx, ins, attrs):
    """shuffle_channel_op.cc: [B, G * K, H, W] with its groups
    interleaved."""
    xv = ins["X"][0]
    g = int(attrs.get("group", 1))
    b, c, h, w = xv.shape
    return {"Out": [xv.reshape(b, g, c // g, h, w).transpose(1, 2)
                    .reshape(b, c, h, w)]}


def _space_to_depth_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    b = int(op.attrs.get("blocksize", 1) or 1)
    if xs and len(xs) == 4 and b > 0:
        n, c, h, w = xs
        out = [n, c * b * b if c > 0 else -1,
               h // b if h > 0 else -1, w // b if w > 0 else -1]
        for nm in op.output("Out"):
            set_out_var(block, nm, out, in_dtype(block, op, "X"))


@register_op("space_to_depth", infer=_space_to_depth_infer)
def space_to_depth(ctx, ins, attrs):
    """space_to_depth_op.cc: [B, C, H, W] -> [B, C s^2, H / s, W / s],
    the block's offsets outermost in the new channels."""
    xv = ins["X"][0]
    s = int(attrs["blocksize"])
    b, c, h, w = xv.shape
    return {"Out": [xv.reshape(b, c, h // s, s, w // s, s)
                    .permute(0, 3, 5, 1, 2, 4)
                    .reshape(b, c * s * s, h // s, w // s)]}


# ---------------------------------------------------------------------------
# max pooling with indices, and max unpooling
# ---------------------------------------------------------------------------

def _pool_with_index_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if not xs or len(xs) != 4:
        return
    ks = [int(k) for k in op.attrs.get("ksize", [1, 1])]
    st = [int(s) for s in (op.attrs.get("strides") or ks)]
    pd = [int(p) for p in (op.attrs.get("paddings") or [0, 0])]
    n, c, h, w = xs
    oh = -1 if h < 0 else (h + 2 * pd[0] - ks[0]) // st[0] + 1
    ow = -1 if w < 0 else (w + 2 * pd[1] - ks[1]) // st[1] + 1
    for nm in op.output("Out"):
        set_out_var(block, nm, [n, c, oh, ow], in_dtype(block, op, "X"))
    for nm in op.output("Mask"):
        set_out_var(block, nm, [n, c, oh, ow], None)


@register_op("max_pool2d_with_index", intermediate_outputs=("Mask",),
             infer=_pool_with_index_infer)
def max_pool2d_with_index(ctx, ins, attrs):
    """pool_with_index_op.cc: max pooling and Mask, the int32 flat index
    h * W + w of each window's first maximum in the unpadded plane (the
    padding is the dtype's lowest finite value, so a window of negatives
    keeps its own maximum); the gradient is split evenly among tied
    maxima."""
    out, mask = window_max_with_index(
        ins["X"][0], list(attrs["ksize"]), list(attrs.get("strides", [1, 1])),
        list(attrs.get("paddings", [0, 0])))
    return {"Out": [out], "Mask": [mask]}


def _unpool_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    uh = int(op.attrs.get("unpooled_height", 0) or 0)
    uw = int(op.attrs.get("unpooled_width", 0) or 0)
    if xs and len(xs) == 4 and uh and uw:
        for nm in op.output("Out"):
            set_out_var(block, nm, [xs[0], xs[1], uh, uw],
                        in_dtype(block, op, "X"))


@register_op("unpool", infer=_unpool_infer)
def unpool(ctx, ins, attrs):
    """unpool_op.cc max unpooling: each value of X added at its Indices
    (flat positions of the [unpooled_height, unpooled_width] plane); an
    index that repeats, where pooling windows overlapped, sums its
    values. The sum is ``scatter_add_``: atomics on the card, and the
    library's deterministic kernel under
    ``torch.use_deterministic_algorithms``."""
    xv = ins["X"][0]
    b, c = xv.shape[0], xv.shape[1]
    oh, ow = int(attrs["unpooled_height"]), int(attrs["unpooled_width"])
    idx = ins["Indices"][0].reshape(b, c, -1).long()
    out = torch.zeros((b, c, oh * ow), dtype=xv.dtype, device=xv.device)
    out = out.scatter_add(2, idx, xv.reshape(b, c, -1))
    return {"Out": [out.reshape(b, c, oh, ow)]}


# ---------------------------------------------------------------------------
# elementwise, selection and sampling
# ---------------------------------------------------------------------------

@register_op("selu", infer=same_shape_infer())
def selu(ctx, ins, attrs):
    """selu_op.cc: scale * (x where x > 0, else alpha (e^x - 1))."""
    xv = x(ins)
    scale = float(attrs.get("scale", 1.0507009873554805))
    alpha = float(attrs.get("alpha", 1.6732632423543772))
    return {"Out": [scale * torch.where(xv > 0, xv,
                                        alpha * (torch.exp(xv) - 1.0))]}


@register_op("multiplex", infer=slots_like_infer(("Out", "X")))
def multiplex(ctx, ins, attrs):
    """multiplex_op.cc: row i of Out is row i of X[Ids[i]]."""
    ids = ins["Ids"][0].reshape(-1).long()
    stacked = torch.stack(ins["X"], dim=0)
    return {"Out": [stacked[ids, torch.arange(stacked.shape[1],
                                              device=ids.device)]]}


def _sampling_id_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs:
        for nm in op.output("Out"):
            set_out_var(block, nm, [xs[0]], None)


@register_op("sampling_id", needs_rng=True, no_grad=True,
             infer=_sampling_id_infer)
def sampling_id(ctx, ins, attrs):
    """sampling_id_op.cc: one class id a row of the probabilities X,
    int64, by the Gumbel-max draw of ``jax.random.categorical``: the
    argmax of log(max(X, 1e-20)) plus Gumbel noise -log(-log(u)), u
    uniform in (0, 1) from the run's generator (other draws than the JAX
    package's threefry; the same law)."""
    xv = ins["X"][0]
    u = torch.rand(xv.shape, generator=ctx.generator, device=xv.device,
                   dtype=xv.dtype).clamp_min(torch.finfo(xv.dtype).tiny)
    gumbel = -torch.log(-torch.log(u))
    return {"Out": [(torch.log(torch.clamp_min(xv, 1e-20)) + gumbel)
                    .argmax(dim=-1)]}


@register_op("norm", intermediate_outputs=("Norm",),
             infer=same_shape_infer())
def norm(ctx, ins, attrs):
    """norm_op.cc: X over its L2 norm along ``axis``, sqrt(sum x^2 +
    epsilon); Norm is that norm."""
    xv = ins["X"][0]
    axis = int(attrs.get("axis", 1))
    eps = float(attrs.get("epsilon", 1e-10))
    nrm = torch.sqrt((xv * xv).sum(dim=axis, keepdim=True) + eps)
    return {"Out": [xv / nrm], "Norm": [nrm]}


def _data_norm_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    dt = in_dtype(block, op, "X")
    if not xs:
        return
    for nm in op.output("Y"):
        set_out_var(block, nm, xs, dt)
    for slot in ("Means", "Scales"):
        for nm in op.output(slot):
            set_out_var(block, nm, [xs[-1]], dt)


@register_op("data_norm", no_grad=True,
             intermediate_outputs=("Means", "Scales"), infer=_data_norm_infer)
def data_norm(ctx, ins, attrs):
    """data_norm_op.cc: X normalized by the accumulators, (x - BatchSum /
    BatchSize) * sqrt(BatchSize / BatchSquareSum). Like the JAX op it is
    ``no_grad``: X gets no gradient and the accumulators stay as the
    startup made them."""
    bsize = ins["BatchSize"][0]
    means = ins["BatchSum"][0] / bsize
    scales = torch.sqrt(bsize / ins["BatchSquareSum"][0])
    return {"Y": [(ins["X"][0] - means) * scales], "Means": [means],
            "Scales": [scales]}


def _bilinear_tp_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    ws = in_shape(block, op, "Weight")
    if xs and ws:
        for nm in op.output("Out"):
            set_out_var(block, nm, [xs[0], ws[0]], in_dtype(block, op, "X"))


@register_op("bilinear_tensor_product", infer=_bilinear_tp_infer)
def bilinear_tensor_product(ctx, ins, attrs):
    """bilinear_tensor_product_op.cc: Out[:, k] = x W_k y^T + Bias[k]."""
    out = torch.einsum("bi,kij,bj->bk", ins["X"][0], ins["Weight"][0],
                       ins["Y"][0])
    bias = opt(ins, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": [out]}


def _mean_iou_infer(op: OpDesc, block):
    c = int(op.attrs.get("num_classes", 0) or 0)
    for nm in op.output("OutMeanIou"):
        set_out_var(block, nm, [1], "float32")
    if c:
        for slot in ("OutWrong", "OutCorrect"):
            for nm in op.output(slot):
                set_out_var(block, nm, [c], "int32")


@register_op("mean_iou", no_grad=True, infer=_mean_iou_infer)
def mean_iou(ctx, ins, attrs):
    """mean_iou_op.h: the mean over the classes present in the
    predictions or the labels of intersection over union (a 0-d float32,
    as the JAX op gives it); OutWrong is the JAX op's count of
    predictions a class and OutCorrect its intersections, both int32."""
    pred = ins["Predictions"][0].reshape(-1).long()
    label = ins["Labels"][0].reshape(-1).long()
    classes = torch.arange(int(attrs["num_classes"]), device=pred.device)
    onehot_p = (pred.unsqueeze(1) == classes).float()
    onehot_l = (label.unsqueeze(1) == classes).float()
    inter = (onehot_p * onehot_l).sum(dim=0)
    predicted = onehot_p.sum(dim=0)
    union = predicted + onehot_l.sum(dim=0) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp_min(union, 1e-9),
                      torch.zeros_like(inter))
    miou = iou.sum() / torch.clamp_min(present.sum(), 1)
    return {"OutMeanIou": [miou], "OutWrong": [predicted.to(torch.int32)],
            "OutCorrect": [inter.to(torch.int32)]}


@register_op("conv_shift", infer=slots_like_infer(("Out", "X")))
def conv_shift(ctx, ins, attrs):
    """conv_shift_op.cc: circular correlation, Out[b, i] = sum_j
    X[b, (i + j - M / 2) mod N] * Y[b, j], summed in j's order."""
    xv, yv = ins["X"][0], ins["Y"][0]
    half = yv.shape[1] // 2
    out = 0
    for j in range(yv.shape[1]):
        out = out + torch.roll(xv, half - j, dims=1) * yv[:, j:j + 1]
    return {"Out": [out]}


def _fill_infer(op: OpDesc, block):
    shape = [int(s) for s in op.attrs.get("shape", []) or []]
    if shape:
        for nm in op.output("Out"):
            set_out_var(block, nm, shape, op.attrs.get("dtype", "float32"))


@register_op("fill", no_grad=True, infer=_fill_infer)
def fill(ctx, ins, attrs):
    """fill_op.cc: the attr ``value`` list as a tensor of ``shape`` and
    ``dtype``, copied to the device once a plan (``ctx.constant``)."""
    dt = dtype_to_torch(attrs.get("dtype", DataType.FP32))
    return {"Out": [ctx.constant(attrs, lambda: torch.tensor(
        np.asarray(attrs["value"], dtype=np.float64)).to(dt)
        .reshape(tuple(attrs["shape"])).to(ctx.device))]}


@register_op("reverse", infer=same_shape_infer())
def reverse(ctx, ins, attrs):
    """reverse_op.cc: X flipped along ``axis`` (an int or a list)."""
    axes = attrs.get("axis", [0])
    if isinstance(axes, int):
        axes = [axes]
    return {"Out": [torch.flip(x(ins), dims=tuple(axes))]}


@register_op("gaussian_random_batch_size_like", no_grad=True,
             needs_rng=True, infer=batch_size_like_infer)
def gaussian_random_batch_size_like(ctx, ins, attrs):
    """A normal of ``mean`` and ``std`` shaped like ``shape`` with Input's
    batch, drawn in float32 from the run's generator, then cast to the
    attr ``dtype``."""
    out = torch.empty(batch_size_like_shape(ins, attrs), dtype=torch.float32,
                      device=ctx.device)
    out.normal_(generator=ctx.generator)
    out = out * float(attrs.get("std", 1.0)) + float(attrs.get("mean", 0.0))
    return {"Out": [out.to(dtype_to_torch(attrs.get("dtype",
                                                    DataType.FP32)))]}


# ---------------------------------------------------------------------------
# spatial transformers
# ---------------------------------------------------------------------------

def _grid_sampler_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    gs = in_shape(block, op, "Grid")
    if xs and gs and len(xs) == 4 and len(gs) == 4:
        for nm in op.output("Output"):
            set_out_var(block, nm, [xs[0], xs[1], gs[1], gs[2]],
                        in_dtype(block, op, "X"))


@register_op("grid_sampler", infer=_grid_sampler_infer)
def grid_sampler(ctx, ins, attrs):
    """grid_sampler_op.cc: X [B, C, H, W] sampled bilinearly at Grid [B,
    Ho, Wo, 2] of (x, y) in [-1, 1] (corners aligned); a corner outside
    the map reads zero. Each corner is a gather by flat index, whose
    gradient is a scatter-add into X."""
    xv, grid = ins["X"][0], ins["Grid"][0]
    b, c, h, w = xv.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    lx, ly = (gx - x0).unsqueeze(1), (gy - y0).unsqueeze(1)
    flat = xv.reshape(b, c, h * w)
    zero = torch.zeros((), dtype=xv.dtype, device=xv.device)

    def gat(yy, xx):
        yc = torch.clamp(yy, 0, h - 1).long()
        xc = torch.clamp(xx, 0, w - 1).long()
        inb = ((yy >= 0) & (yy <= h - 1) & (xx >= 0)
               & (xx <= w - 1)).unsqueeze(1)
        idx = (yc * w + xc).reshape(b, 1, -1).expand(b, c, -1)
        v = flat.gather(2, idx).reshape((b, c) + tuple(yy.shape[1:]))
        return torch.where(inb, v, zero)

    out = (gat(y0, x0) * (1 - ly) * (1 - lx)
           + gat(y0, x0 + 1) * (1 - ly) * lx
           + gat(y0 + 1, x0) * ly * (1 - lx)
           + gat(y0 + 1, x0 + 1) * ly * lx)
    return {"Output": [out]}


def _affine_grid_infer(op: OpDesc, block):
    out_shape = [int(s) for s in op.attrs.get("output_shape", []) or []]
    ts = in_shape(block, op, "Theta")
    if len(out_shape) == 4 and ts:
        for nm in op.output("Output"):
            set_out_var(block, nm, [out_shape[0], out_shape[2],
                                    out_shape[3], 2],
                        in_dtype(block, op, "Theta"))


@register_op("affine_grid", infer=_affine_grid_infer)
def affine_grid(ctx, ins, attrs):
    """affine_grid_op.cc: Theta [B, 2, 3] applied to the (x, y, 1) of an
    H x W grid over [-1, 1]: the sampling grid [B, H, W, 2] of the static
    ``output_shape``."""
    theta = ins["Theta"][0]
    if opt(ins, "OutputShape") is not None:
        raise ValueError("affine_grid needs the static output_shape attr")
    _, _, h, w = attrs["output_shape"]
    dev = theta.device
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=dev),
                            torch.linspace(-1.0, 1.0, w, device=dev),
                            indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).to(theta.dtype)
    return {"Output": [torch.einsum("hwk,bjk->bhwj", base, theta)]}


def _spp_infer(op: OpDesc, block):
    xs = in_shape(block, op, "X")
    if xs is None:
        return
    bins = sum(4 ** l for l in range(int(op.attrs.get("pyramid_height", 1))))
    for nm in op.output("Out"):
        set_out_var(block, nm, [xs[0], xs[1] * bins], in_dtype(block, op, "X"))


@register_op("spp", infer=_spp_infer)
def spp(ctx, ins, attrs):
    """spp_op.cc: spatial pyramid pooling. Level l pools a 2^l x 2^l grid
    of bins, each ceil(dim / 2^l) wide (the map padded at its end to
    fill the grid), and the levels' [B, C * 4^l] rows are concatenated.
    Max pads with the dtype's lowest finite value and splits a bin's
    gradient among its tied maxima (``amax``); average divides by each
    bin's unpadded count (0 for a bin wholly in the padding)."""
    xv = ins["X"][0]
    b, c, h, w = xv.shape
    ptype = attrs.get("pooling_type", "max")
    outs = []
    for level in range(int(attrs.get("pyramid_height", 1))):
        n = 2 ** level
        kh, kw = -(-h // n), -(-w // n)
        pad = (float(torch.finfo(xv.dtype).min) if ptype == "max" else 0.0)
        cells = F.pad(xv, (0, n * kw - w, 0, n * kh - h), value=pad) \
            .reshape(b, c, n, kh, n, kw)
        if ptype == "max":
            grid = cells.amax(dim=(3, 5))
        else:
            starts = torch.arange(n, device=xv.device)
            hc = torch.clamp(torch.clamp(starts * kh + kh, max=h)
                             - starts * kh, min=0)
            wc = torch.clamp(torch.clamp(starts * kw + kw, max=w)
                             - starts * kw, min=0)
            cnt = (hc.unsqueeze(1) * wc.unsqueeze(0)).to(xv.dtype)
            grid = cells.sum(dim=(3, 5)) / torch.clamp_min(cnt, 1)
        outs.append(grid.reshape(b, -1))
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("similarity_focus", no_grad=True, infer=same_shape_infer())
def similarity_focus(ctx, ins, attrs):
    """similarity_focus_op.cc: for each channel of ``indexes`` along
    ``axis``, min(B, C) greedy steps over its [B, C] map, each taking the
    largest value whose row and column no earlier step took (the first
    in flat order on a tie, as ``jnp.argmax``) and marking it 1; the
    channels' masks OR-ed and broadcast along ``axis``. The steps are a
    fixed-trip loop over the whole batch, on the device."""
    xv = ins["X"][0]
    axis = int(attrs.get("axis", 1))
    xn = torch.movedim(xv, axis, 1) if axis != 1 else xv
    n, _, rows, cols = xn.shape
    low = torch.finfo(xn.dtype).min
    masks = torch.zeros((n, rows * cols), dtype=xn.dtype, device=xn.device)
    one = torch.ones((n, 1), dtype=xn.dtype, device=xn.device)
    for idx in attrs["indexes"]:
        t = xn[:, int(idx)].reshape(n, rows * cols)
        row_used = torch.zeros((n, rows), dtype=torch.bool, device=xn.device)
        col_used = torch.zeros((n, cols), dtype=torch.bool, device=xn.device)
        mask = torch.zeros_like(masks)
        for _ in range(min(rows, cols)):
            used = (row_used.unsqueeze(2) | col_used.unsqueeze(1))
            flat = t.masked_fill(used.reshape(n, -1), low).argmax(dim=1,
                                                                  keepdim=True)
            mask = mask.scatter(1, flat, one)
            row_used = row_used.scatter(
                1, torch.div(flat, cols, rounding_mode="floor"), True)
            col_used = col_used.scatter(1, flat % cols, True)
        masks = torch.maximum(masks, mask)
    out = masks.reshape(n, 1, rows, cols).expand(xn.shape)
    if axis != 1:
        out = torch.movedim(out, 1, axis)
    return {"Out": [out]}
