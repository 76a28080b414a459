"""NN layers (reference python/paddle/fluid/layers/nn.py): the ones the
Transformer, ResNet and BERT build and the training API (clips, schedules)
appends. Each builds descs via LayerHelper; no device
work happens here."""

from __future__ import annotations

import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "layer_norm", "softmax_with_cross_entropy",
    "reshape", "transpose", "squeeze", "reduce_sum", "reduce_mean",
    "reduce_max", "reduce_min", "reduce_prod", "scale", "clip",
    "clip_by_norm", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "logical_and", "logical_or", "logical_xor",
    "logical_not", "sequence_mask", "fused_attention", "matmul", "softmax",
    "unsqueeze", "slice", "gather", "cast", "conv2d", "pool2d",
    "batch_norm", "cross_entropy", "accuracy", "topk", "mean", "concat",
    "dropout", "square_error_cost",
    "kv_cache_write", "kv_cache_gather_paged", "kv_cache_write_paged",
    "split", "expand", "sequence_pool", "sequence_softmax", "beam_search",
    "beam_search_decode",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected over one input: mul + bias + act, the reference
    decomposition (a list of inputs, summed, is not ported yet)."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    param_shape = [int(np.prod(input.shape[num_flatten_dims:])), size]
    w = helper.create_parameter(helper.param_attr, param_shape, input.dtype)
    tmp = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="mul", inputs={"X": input, "Y": w}, outputs={"Out": tmp},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    pre_act = helper.append_bias_op(tmp, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32",
              name=None):
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(helper.param_attr, size, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table", inputs={"W": w, "Ids": input},
        outputs={"Out": out},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": pad})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            helper.param_attr, norm_shape, dtype,
            default_initializer=ConstantInitializer(1.0))
    if shift:
        b = helper.create_parameter(helper.bias_attr, norm_shape, dtype,
                                    is_bias=True)
        if b is not None:
            inputs["Bias"] = b
    mean = helper.create_variable_for_type_inference("float32",
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": out, "Mean": mean, "Variance": var},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": logits, "Label": label},
        outputs={"Softmax": softmax_out, "Loss": loss},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return loss


def reshape(x, shape, act=None, name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="reshape2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="transpose2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": list(perm)})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="squeeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": list(axes)})
    return out


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(
        type=op_type, inputs={"X": input}, outputs={"Out": out},
        attrs={"dim": dim if dim is not None else [],
               "keep_dim": keep_dim, "reduce_all": dim is None})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale", inputs={"X": x}, outputs={"Out": out},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip", inputs={"X": x}, outputs={"Out": out},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": x},
                     outputs={"Out": out},
                     attrs={"max_norm": float(max_norm)})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def _logical(op_type, x, y, out, name):
    helper = LayerHelper(op_type, name=name)
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    ins = {"X": x} if y is None else {"X": x, "Y": y}
    helper.append_op(type=op_type, inputs=ins, outputs={"Out": out})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical("logical_and", x, y, out, name)


def logical_or(x, y, out=None, name=None):
    return _logical("logical_or", x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _logical("logical_xor", x, y, out, name)


def logical_not(x, out=None, name=None):
    return _logical("logical_not", x, None, out, name)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths [B] -> [B, maxlen] 0/1 mask; ``maxlen`` must be static."""
    if maxlen is None:
        raise ValueError("sequence_mask requires a static maxlen")
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sequence_mask", inputs={"X": x},
                     outputs={"Y": out},
                     attrs={"maxlen": maxlen, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def kv_cache_write(cache, new, position, name=None):
    """Write one K/V column into a fixed-capacity slot-major cache: Cache
    [B, H, cap, D] gets New [B, H, 1, D] at Position [B] per slot
    (ops/kernels_cache.py). Inference only."""
    helper = LayerHelper("kv_cache_write", name=name)
    out = helper.create_variable_for_type_inference(cache.dtype)
    helper.append_op(type="kv_cache_write",
                     inputs={"Cache": cache, "New": new,
                             "Position": position},
                     outputs={"Out": out}, attrs={})
    return out


def kv_cache_gather_paged(pool, table, cap=0, name=None):
    """Dense slot-major view [B, H, max_pages * page, D] of a paged cache
    Pool [num_pages, H, page, D] through its page Table [B, max_pages]
    (``cap`` > 0 trims an overhanging last page). Inference only."""
    helper = LayerHelper("kv_cache_gather_paged", name=name)
    out = helper.create_variable_for_type_inference(pool.dtype)
    helper.append_op(type="kv_cache_gather_paged",
                     inputs={"Pool": pool, "Table": table},
                     outputs={"Out": out}, attrs={"cap": int(cap)})
    return out


def kv_cache_write_paged(pool, table, new, position, mask=None,
                         name=None):
    """Write one K/V column through the page table: slot b's New
    [B, H, 1, D] lands in page Table[b, Position[b] // page] at offset
    Position[b] % page; ``mask`` (bool [B], True = suppress) sends the
    write to the null page 0. Inference only."""
    helper = LayerHelper("kv_cache_write_paged", name=name)
    out = helper.create_variable_for_type_inference(pool.dtype)
    inputs = {"Pool": pool, "Table": table, "New": new,
              "Position": position}
    if mask is not None:
        inputs["Mask"] = mask
    helper.append_op(type="kv_cache_write_paged", inputs=inputs,
                     outputs={"Out": out}, attrs={})
    return out


def fused_attention(q, k, v, causal=False, scale=1.0, key_bias=None,
                    name=None):
    """Fused scaled-dot-product attention over [B, H, T, D] heads; lowers
    to the ``flash_attention`` op (ops/flash_attention.py). key_bias
    [B, Tk] is an additive key mask (0 keep / -1e9 drop)."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": q, "K": k, "V": v}
    if key_bias is not None:
        inputs["KeyBias"] = key_bias
    helper.append_op(type="flash_attention", inputs=inputs,
                     outputs={"Out": out},
                     attrs={"causal": causal, "scale": float(scale)})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", x=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    return out


def softmax(input, axis=-1, use_cudnn=False, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": input},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="unsqueeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": list(axes)})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": input},
                     outputs={"Out": out},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def cast(x, dtype):
    from . import tensor as tensor_layers
    return tensor_layers.cast(x, dtype)


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """conv2d over an NCHW input; the filter [num_filters, C/groups, kh,
    kw] starts from N(0, sqrt(2 / (kh * kw * C))). A conv with one group
    per input channel and as many filters is ``depthwise_conv2d``.
    ``use_cudnn`` is accepted and ignored."""
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, filter_shape, dtype,
        default_initializer=NormalInitializer(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    op_type = ("depthwise_conv2d"
               if groups == num_channels and num_filters == num_channels
               else "conv2d")
    helper.append_op(
        type=op_type, inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups})
    pre_act = pre_bias
    if helper.bias_attr is not False and helper.bias_attr is not None:
        b = helper.create_parameter(helper.bias_attr, [pre_bias.shape[1]],
                                    dtype, is_bias=True)
        if b is not None:
            pre_act = helper.create_variable_for_type_inference(dtype)
            helper.append_op(type="elementwise_add",
                             inputs={"X": pre_bias, "Y": b},
                             outputs={"Out": pre_act}, attrs={"axis": 1})
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Scale (1) and bias (0) parameters and persistable running mean (0)
    and variance (1); MeanOut and VarianceOut write the running
    statistics back under their own names."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        helper.param_attr, [c], dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, [c], dtype,
                                   is_bias=True)
    mean = helper.create_global_variable(
        name=moving_mean_name, persistable=True, dtype="float32", shape=[c])
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name, persistable=True, dtype="float32",
        shape=[c])
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": variance},
        outputs={"Y": out, "MeanOut": mean, "VarianceOut": variance,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Drop elements of ``x`` with probability ``dropout_prob``; the uint8
    keep mask is the op's ``Mask`` output, which its grad reads."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8",
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": x},
        outputs={"Out": out, "Mask": mask},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed or 0,
               "dropout_implementation": dropout_implementation})
    return out


def square_error_cost(input, label):
    """(input - label)^2, elementwise."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": input, "Y": label}, outputs={"Out": out})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy", inputs={"X": input, "Label": label},
        outputs={"Y": out},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """top_k, then the accuracy op on its indices."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": input},
                     outputs={"Out": topk_out, "Indices": topk_indices},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="accuracy",
        inputs={"Out": topk_out, "Indices": topk_indices, "Label": label},
        outputs={"Accuracy": acc_out, "Correct": correct, "Total": total})
    return acc_out


def topk(input, k=1, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices},
                     attrs={"k": k})
    return values, indices


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": x}, outputs={"Out": out})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    ndim = len(input.shape)
    dim = dim % ndim
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
    else:
        num = 0
        sections = list(num_or_sections)
    n_out = num or len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n_out)]
    helper.append_op(type="split", inputs={"X": input}, outputs={"Out": outs},
                     attrs={"axis": dim, "num": num, "sections": sections})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand", inputs={"X": x}, outputs={"Out": out},
                     attrs={"expand_times": list(expand_times)})
    return out


def sequence_pool(input, pool_type, length=None):
    """Pool [B, T, ...] over each row's first ``length`` steps:
    sum, average, sqrt, max, last or first."""
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    max_index = helper.create_variable_for_type_inference("int32", True)
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_pool", inputs=inputs,
                     outputs={"Out": out, "MaxIndex": max_index},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_softmax(input, length=None, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_softmax", inputs=inputs,
                     outputs={"Out": out})
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None):
    """One step of beam expansion over the dense [batch*beam] layout;
    returns (selected_ids, selected_scores, parent_idx)."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference(ids.dtype)
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent_idx = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": pre_ids, "pre_scores": pre_scores,
                "ids": ids, "scores": scores},
        outputs={"selected_ids": sel_ids, "selected_scores": sel_scores,
                 "parent_idx": parent_idx},
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level,
               "is_accumulated": is_accumulated})
    return sel_ids, sel_scores, parent_idx


def beam_search_decode(ids, parent_idx, scores=None, beam_size=None,
                       end_id=0, name=None):
    """Backtrack stacked per-step ids/parents [T, batch*beam] into
    sentences [batch*beam, T] (and the final scores when given)."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference(ids.dtype)
    inputs = {"Ids": ids, "ParentIdx": parent_idx}
    outputs = {"SentenceIds": sent_ids}
    ret = [sent_ids]
    if scores is not None:
        inputs["Scores"] = scores
        sent_scores = helper.create_variable_for_type_inference(
            scores.dtype)
        outputs["SentenceScores"] = sent_scores
        ret.append(sent_scores)
    helper.append_op(type="beam_search_decode", inputs=inputs,
                     outputs=outputs, attrs={"end_id": end_id})
    return ret[0] if len(ret) == 1 else tuple(ret)
