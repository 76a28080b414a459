"""NN layers (reference python/paddle/fluid/layers/nn.py): the ones the
Transformer, ResNet, BERT and the model zoo build, the training API
(clips, schedules) appends, the sequence and CTC layers over padded
[B, T, ...] batches with an optional ``length`` [B], and the image and
vision layers (the transposed and 3-D convolutions, 3-D and adaptive
pooling, the crops, normalizations and spatial transformers). Each builds descs via LayerHelper; no device
work happens here."""

from __future__ import annotations

import numpy as np

from ..framework import Variable
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper, ParamAttr

# the JAX package's nn.__all__, in its order, less the names not ported yet
# (tests/test_torch_api_surface.py DEFERRED)
__all__ = [
    "fc", "embedding", "lod_reset", "sum", "logical_and", "logical_or",
    "logical_xor", "logical_not", "similarity_focus",
    "tree_conv", "py_func", "autoincreased_step_counter", "dice_loss", "image_resize_short",
    "adaptive_pool2d", "adaptive_pool3d", "conv3d_transpose",
    "merge_selected_rows", "get_tensor_from_selected_rows", "conv2d",
    "conv2d_transpose", "conv3d", "pool3d", "pool2d", "batch_norm",
    "layer_norm", "dropout", "softmax", "cross_entropy",
    "softmax_with_cross_entropy", "accuracy", "auc", "topk", "matmul", "mul",
    "concat", "split", "reshape", "transpose", "squeeze", "unsqueeze",
    "stack", "unstack", "expand", "slice", "one_hot", "mean", "reduce_sum",
    "reduce_mean", "reduce_max", "reduce_min", "reduce_prod", "scale", "clip",
    "clip_by_norm", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "gather", "scatter", "pad", "pad2d", "lookup_table",
    "cast", "square_error_cost", "sigmoid_cross_entropy_with_logits",
    "smooth_l1", "huber_loss", "relu", "log_softmax", "sequence_pool",
    "nested_sequence_pool", "sequence_softmax", "sequence_reverse",
    "im2sequence", "flatten", "arg_max", "arg_min", "argsort", "cumsum",
    "shape", "l2_normalize", "label_smooth", "maxout", "group_norm", "prelu",
    "hash", "uniform_random_batch_size_like", "sequence_conv",
    "sequence_first_step", "sequence_last_step", "sequence_expand",
    "sequence_expand_as", "sequence_pad", "sequence_unpad",
    "sequence_reshape", "sequence_scatter", "sequence_enumerate",
    "sequence_mask", "sequence_erase", "row_conv", "kv_cache_write",
    "kv_cache_gather_paged", "kv_cache_write_paged", "add_position_encoding",
    "sequence_concat", "sequence_slice", "beam_search", "beam_search_decode",
    "linear_chain_crf", "crf_decoding", "chunk_eval", "warpctc",
    "ctc_greedy_decoder", "edit_distance", "cos_sim", "hinge_loss",
    "log_loss", "rank_loss", "margin_rank_loss", "bpr_loss",
    "teacher_student_sigmoid_loss", "nce", "hsigmoid", "squared_l2_distance",
    "squared_l2_norm", "l1_norm", "fused_attention", "image_resize",
    "resize_bilinear", "resize_nearest", "lrn", "crop", "pad_constant_like",
    "random_crop", "affine_channel", "shuffle_channel", "space_to_depth",
    "unpool", "selu", "multiplex", "sampling_id", "norm", "data_norm",
    "bilinear_tensor_product", "mean_iou", "grid_sampler", "affine_grid",
    "conv_shift", "gaussian_random_batch_size_like", "pool2d_with_index",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected: a mul per input (a list of inputs is summed), then
    bias and act, the reference decomposition."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        param_shape = [int(np.prod(inp.shape[num_flatten_dims:])), size]
        w = helper.create_parameter(helper.param_attr, param_shape,
                                    inp.dtype)
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op(
            type="mul", inputs={"X": inp, "Y": w}, outputs={"Out": tmp},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": pre_bias})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
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


def _conv_bias(helper, pre_bias):
    """pre_bias + a [C] bias parameter along dim 1, unless bias_attr is
    False."""
    bias_attr = helper.bias_attr
    if bias_attr is False or bias_attr is None:
        return pre_bias
    b = helper.create_parameter(bias_attr, [pre_bias.shape[1]],
                                pre_bias.dtype, is_bias=True)
    if b is None:
        return pre_bias
    out = helper.create_variable_for_type_inference(pre_bias.dtype)
    helper.append_op(type="elementwise_add", inputs={"X": pre_bias, "Y": b},
                     outputs={"Out": out}, attrs={"axis": 1})
    return out


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
    return helper.append_activation(_conv_bias(helper, pre_bias))


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



def cos_sim(X, Y, name=None):
    """Row-wise cosine similarity (cos_sim_op.h); Y may be [1, D]."""
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype, True)
    yn = helper.create_variable_for_type_inference(X.dtype, True)
    helper.append_op(type="cos_sim", inputs={"X": X, "Y": Y},
                     outputs={"Out": out, "XNorm": xn, "YNorm": yn})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    """Negative log likelihood of a probability (log_loss_op.h)."""
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="log_loss",
                     inputs={"Predicted": input, "Labels": label},
                     outputs={"Loss": out}, attrs={"epsilon": epsilon})
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



def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC: the stat buckets live in two persistable int64 vars
    (zeros from the startup program) that every run updates."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[num_thresholds + 1])
    stat_neg = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[num_thresholds + 1])
    for v in (stat_pos, stat_neg):
        helper.set_variable_initializer(v, ConstantInitializer(0))
    auc_out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="auc",
        inputs={"Predict": input, "Label": label, "StatPos": stat_pos,
                "StatNeg": stat_neg},
        outputs={"AUC": auc_out, "StatPosOut": stat_pos,
                 "StatNegOut": stat_neg},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out, [stat_pos, stat_neg]

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


def linear_chain_crf(input, label, param_attr=None, length=None,
                     name=None):
    """layers/nn.py linear_chain_crf (linear_chain_crf_op.h): makes the
    [size + 2, size] transition parameter (rows: start, end, pairwise)
    and returns the per-row negative log-likelihood to minimize."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr,
                         name=name)
    size = input.shape[-1]
    transition = helper.create_parameter(helper.param_attr,
                                         shape=[size + 2, size],
                                         dtype=input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype, True)
    inputs = {"Emission": input, "Transition": transition,
              "Label": label}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="linear_chain_crf", inputs=inputs,
                     outputs={"LogLikelihood": ll, "Alpha": alpha})
    return ll


def crf_decoding(input, param_attr, label=None, length=None, name=None):
    """layers/nn.py crf_decoding (crf_decoding_op.h Viterbi), on the
    transition parameter ``linear_chain_crf`` made under ``param_attr``'s
    name."""
    from ..framework import default_main_program
    helper = LayerHelper("crf_decoding", param_attr=param_attr, name=name)
    transition = default_main_program().global_block().vars[
        helper.param_attr.name]
    path = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": input, "Transition": transition}
    if label is not None:
        inputs["Label"] = label
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": path})
    return path


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, length=None):
    """layers/nn.py chunk_eval (chunk_eval_op.cc): precision, recall,
    F1 and the inferred, labelled and correct chunk counts."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_variable_for_type_inference("float32")
    recall = helper.create_variable_for_type_inference("float32")
    f1 = helper.create_variable_for_type_inference("float32")
    num_infer = helper.create_variable_for_type_inference("int64")
    num_label = helper.create_variable_for_type_inference("int64")
    num_correct = helper.create_variable_for_type_inference("int64")
    inputs = {"Inference": input, "Label": label}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(
        type="chunk_eval", inputs=inputs,
        outputs={"Precision": precision, "Recall": recall,
                 "F1-Score": f1, "NumInferChunks": num_infer,
                 "NumLabelChunks": num_label,
                 "NumCorrectChunks": num_correct},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, num_infer, num_label, num_correct


def sequence_reverse(x, length=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_reverse", inputs=inputs,
                     outputs={"Out": out})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """An image [B, C, H, W] as the sequence of its patches
    [B, oh * ow, C * kh * kw]; ``padding`` is one int, [h, w] or
    [up, left, down, right]."""
    helper = LayerHelper("im2sequence", name=name)
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding] * 4
    elif len(padding) == 2:
        padding = [padding[0], padding[1], padding[0], padding[1]]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="im2sequence", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"kernels": list(filter_size),
                            "strides": list(stride),
                            "paddings": list(padding)})
    return out


def _seq_op(op_type, inputs, dtype, attrs=None, name=None):
    """A sequence op with one output ``Out``."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": out},
                     attrs=attrs or {})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None, length=None):
    """The context-window projection along the time axis of [B, T, D]:
    a [filter_size * D, num_filters] filter over the window centred on each
    step, then a bias shared over time, then ``act``."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": input, "Filter": filter_param}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(
        type="sequence_conv", inputs=inputs, outputs={"Out": pre_bias},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size})
    # the bias is [num_filters], shared over time
    pre_act = helper.append_bias_op(pre_bias, dim_start=2)
    return helper.append_activation(pre_act)


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length=length)


def sequence_expand(x, y, ref_level=-1, name=None):
    """x's rows repeated over y's time axis."""
    return _seq_op("sequence_expand", {"X": x, "Y": y}, x.dtype, name=name)


def sequence_expand_as(x, y, name=None):
    return _seq_op("sequence_expand_as", {"X": x, "Y": y}, x.dtype,
                   name=name)


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """(Out, Length): ``pad_value`` past each row's length, the time axis
    padded or cut to ``maxlen`` when given."""
    inputs = {"X": x, "PadValue": pad_value}
    if length is not None:
        inputs["Length"] = length
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    len_out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="sequence_pad", inputs=inputs,
                     outputs={"Out": out, "Length": len_out},
                     attrs={"maxlen": -1 if maxlen is None else maxlen})
    return out, len_out


def sequence_unpad(x, length, name=None):
    return _seq_op("sequence_unpad", {"X": x, "Length": length}, x.dtype,
                   name=name)


def sequence_reshape(input, new_dim):
    return _seq_op("sequence_reshape", {"X": input}, input.dtype,
                   attrs={"new_dim": new_dim})


def sequence_scatter(input, index, updates, name=None):
    return _seq_op("sequence_scatter",
                   {"X": input, "Ids": index, "Updates": updates},
                   input.dtype, name=name)


def sequence_enumerate(input, win_size, pad_value=0, name=None,
                       length=None):
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    return _seq_op("sequence_enumerate", inputs, input.dtype,
                   attrs={"win_size": win_size, "pad_value": pad_value},
                   name=name)


def sequence_erase(input, tokens, length=None, name=None):
    """(Out, NewLength): the listed tokens dropped, each row compacted."""
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    new_len = helper.create_variable_for_type_inference("int64")
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_erase", inputs=inputs,
                     outputs={"Out": out, "NewLength": new_len},
                     attrs={"tokens": list(tokens)})
    return out, new_len


def sequence_concat(input, name=None):
    """The inputs concatenated along the time axis."""
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": input},
                     outputs={"Out": out})
    return out


def sequence_slice(input, offset, length, name=None):
    """Steps [offset, offset + length) of every row (static ints)."""
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_slice", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"offset": offset, "length": length})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None,
             length=None, name=None):
    """The lookahead convolution (row_conv_op.cc): a
    [future_context_size + 1, D] filter over each step and the ones after
    it."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act,
                         name=name)
    dtype = input.dtype
    filter_shape = [future_context_size + 1, input.shape[-1]]
    filter_param = helper.create_parameter(helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": input, "Filter": filter_param}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="row_conv", inputs=inputs, outputs={"Out": out})
    return helper.append_activation(out)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    helper = LayerHelper("add_position_encoding", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="add_position_encoding", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"alpha": float(alpha), "beta": float(beta)})
    return out


def lod_reset(x, y=None, target_lod=None, name=None):
    """The data unchanged, the new partition (an integer ``y`` or
    ``target_lod``, both offset vectors) surfacing as the op's Length
    output for the sequence ops after it."""
    helper = LayerHelper("lod_reset", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int32")
    inputs = {"X": x}
    if y is not None:
        inputs["Y"] = y
    attrs = {}
    if target_lod is not None:
        attrs["target_lod"] = [int(v) for v in target_lod]
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": out, "Length": length}, attrs=attrs)
    return out


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None, name=None):
    """The CTC loss [B, 1] of padded logits [B, T, C] against labels
    [B, L]."""
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Logits": input, "Label": label}
    if input_length is not None:
        inputs["LogitsLength"] = input_length
    if label_length is not None:
        inputs["LabelLength"] = label_length
    helper.append_op(type="warpctc", inputs=inputs, outputs={"Loss": loss},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """The best class of each step, then repeats merged and blanks dropped
    (``ctc_align``). Returns (decoded [B, T], decoded length [B])."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    _, idx = topk(input, k=1)
    idx = squeeze(idx, axes=[-1])
    out = helper.create_variable_for_type_inference("int64")
    out_len = helper.create_variable_for_type_inference("int64")
    inputs = {"Input": idx}
    if input_length is not None:
        inputs["Length"] = input_length
    helper.append_op(type="ctc_align", inputs=inputs,
                     outputs={"Output": out, "OutputLength": out_len},
                     attrs={"blank": blank, "merge_repeated": True})
    return out, out_len


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """(distances [B, 1], sequence count): the Levenshtein distance of each
    row of ``input`` to ``label``, over their lengths when given."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    inputs = {"Hyps": input, "Refs": label}
    if input_length is not None:
        inputs["HypsLength"] = input_length
    if label_length is not None:
        inputs["RefsLength"] = label_length
    helper.append_op(type="edit_distance", inputs=inputs,
                     outputs={"Out": out, "SequenceNum": seq_num},
                     attrs={"normalized": normalized})
    return out, seq_num


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": x, "Label": label}, outputs={"Out": out},
                     attrs={"ignore_index": ignore_index})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """The row sums [N, 1] of the smooth L1 loss of X - Y."""
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(x.dtype, True)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x, "Y": y}
    if inside_weight is not None:
        inputs["InsideWeight"] = inside_weight
    if outside_weight is not None:
        inputs["OutsideWeight"] = outside_weight
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Out": out, "Diff": diff},
                     attrs={"sigma": sigma or 1.0})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", align_corners=True):
    """Resize an NCHW map to ``out_shape`` (or its size times ``scale``),
    bilinear or nearest: the ``interpolate`` op."""
    helper = LayerHelper("interpolate", name=name)
    if out_shape is None:
        if scale is None:
            raise ValueError("out_shape or scale required")
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale)]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="interpolate", inputs={"X": input}, outputs={"Out": out},
        attrs={"out_h": int(out_shape[0]), "out_w": int(out_shape[1]),
               "interp_method": resample.lower(),
               "align_corners": align_corners})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    align_corners=True):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        align_corners)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        align_corners)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the short side is ``out_short_len``, keeping the aspect
    ratio (from the static shape)."""
    in_shape = list(input.shape)
    if len(in_shape) != 4:
        raise ValueError("image_resize_short expects NCHW input")
    h, w = in_shape[2], in_shape[3]
    short = min(h, w)
    return image_resize(input, out_shape=[int(h * out_short_len // short),
                                          int(w * out_short_len // short)],
                        resample=resample)


# ---------------------------------------------------------------------------
# the general tensor layers
# ---------------------------------------------------------------------------

lookup_table = embedding


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": x}, outputs={"Out": out})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="log_softmax", inputs={"X": input},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", x=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="mul", inputs={"X": x, "Y": y}, outputs={"Out": out},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims})
    return out


def sum(x, name=None):
    """The elementwise sum of a list of variables (one ``sum`` op)."""
    helper = LayerHelper("sum", name=name)
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(xs)},
                     outputs={"Out": out})
    return out


def flatten(x, axis=1, name=None):
    """[prod(shape[:axis]), prod(shape[axis:])] through ``reshape``; an
    unknown batch dim leaves the leading extent -1."""
    if axis == 0:
        return reshape(x, [1, -1], name=name)
    suffix = int(np.prod(x.shape[axis:]))
    return reshape(x, [-1, suffix], name=name)


def stack(x, axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": out},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num or x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": x}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="scatter",
        inputs={"X": input, "Ids": index, "Updates": updates},
        outputs={"Out": out}, attrs={"overwrite": overwrite})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": input},
                     outputs={"Out": out}, attrs={"depth": depth})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pad", inputs={"X": x}, outputs={"Out": out},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pad2d", inputs={"X": input}, outputs={"Out": out},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value)})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / sqrt(sum(x^2 along axis) + epsilon), composed of the
    elementwise, reduce, scale and sqrt ops."""
    from . import ops as act_ops
    ssum = reduce_sum(elementwise_mul(x, x), dim=axis, keep_dim=True)
    norm = act_ops.sqrt(scale(ssum, bias=epsilon, bias_after_scale=True))
    return elementwise_div(x, norm)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """(1 - epsilon) label + epsilon / the class count, one ``scale`` op,
    as the JAX layer emits it (``prior_dist`` is ignored there too; the
    ``label_smooth`` op type, which reads it, is reached by loaded
    programs)."""
    ncls = label.shape[-1]
    return scale(label, scale=1.0 - epsilon, bias=epsilon / ncls)


def arg_max(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_max", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def arg_min(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_min", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def argsort(input, axis=-1, name=None):
    """(sorted values, int64 indices) along ``axis``, stable."""
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="argsort", inputs={"X": input},
                     outputs={"Out": out, "Indices": ids},
                     attrs={"axis": axis})
    return out, ids


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="cumsum", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="shape", inputs={"Input": input},
                     outputs={"Out": out})
    return out


def nested_sequence_pool(input, outer_length, inner_length, pool_type):
    """A two-level sequence pool over the dense encoding: ``input``
    [B, S, W, D] (up to S inner sequences of up to W rows an item),
    ``outer_length`` [B] and ``inner_length`` [B, S]. Pools each inner
    sequence, giving [B, S, D] whose remaining length is
    ``outer_length`` (pool again with ``sequence_pool(out, ...,
    outer_length)`` for the item level)."""
    shape = input.shape
    if shape is None or len(shape) < 3:
        raise ValueError(
            f"nested_sequence_pool needs [B, S, W, ...] input, got "
            f"shape {shape}")
    s = int(shape[1])
    inner = [int(d) for d in shape[2:]]
    flat = reshape(input, shape=[-1] + inner)
    flat_len = reshape(inner_length, shape=[-1])
    pooled = sequence_pool(flat, pool_type, length=flat_len)
    return reshape(pooled, shape=[-1, s] + inner[1:])


def affine_channel(x, scale=None, bias=None, data_layout="NCHW",
                   name=None):
    helper = LayerHelper("affine_channel", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="affine_channel",
                     inputs={"X": x, "Scale": scale, "Bias": bias},
                     outputs={"Out": out})
    return out


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """The tree-based convolution of TBCNN (the ``tree_conv`` op): a
    Filter [F, 3, output_size, num_filters], then a bias from dim 3 and
    ``act``."""
    helper = LayerHelper("tree_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = nodes_vector.dtype
    feature_size = nodes_vector.shape[-1]
    w = helper.create_parameter(
        helper.param_attr, [feature_size, 3, output_size, num_filters],
        dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="tree_conv",
                     inputs={"NodesVector": nodes_vector,
                             "EdgeSet": edge_set, "Filter": w},
                     outputs={"Out": out},
                     attrs={"max_depth": max_depth})
    if bias_attr is not False:
        out = helper.append_bias_op(out, dim_start=3)
    return helper.append_activation(out)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """A host op calling ``func`` on numpy batches (the ``py_func`` op).
    The ``out`` variables are the caller's, made beforehand, as in the
    reference. ``backward_func`` is accepted for the reference's
    signature; the op has no gradient, as in the JAX package. ``func``
    is an attribute of the op, so its program cannot be serialized."""
    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    helper.append_op(type="py_func", inputs={"X": list(xs)},
                     outputs={"Out": list(outs)},
                     attrs={"func": func})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 [1] counter, ``begin`` at the first run and
    incremented by ``step`` each run."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    counter = helper.block.program.global_block().create_var(
        name=name, dtype="int64", shape=[1], persistable=True)
    helper.set_variable_initializer(
        counter, ConstantInitializer(float(begin - step)))
    helper.append_op(type="increment", inputs={"X": counter},
                     outputs={"Out": counter},
                     attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2 |X and Y| / (|X| + |Y|) over each sample's trailing dims,
    the mean over the batch (a composition, as in the reference)."""
    label = one_hot(label, depth=input.shape[-1])
    reduce_dims = list(range(1, len(input.shape)))
    inse = reduce_sum(elementwise_mul(input, label), dim=reduce_dims)
    dice_denominator = reduce_sum(input, dim=reduce_dims) + reduce_sum(
        label, dim=reduce_dims)
    dice_score = 1 - elementwise_div(
        scale(inse, scale=2.0), scale(dice_denominator, bias=epsilon))
    return reduce_mean(dice_score)


def merge_selected_rows(x, name=None):
    """Gradients are dense in both packages (no SelectedRows), so merging
    a gradient's duplicate rows is the identity (an ``assign``)."""
    helper = LayerHelper("merge_selected_rows", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="assign", inputs={"X": x}, outputs={"Out": out})
    return out


def get_tensor_from_selected_rows(x, name=None):
    """The identity on a dense gradient (see ``merge_selected_rows``)."""
    helper = LayerHelper("get_tensor_from_selected_rows", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="assign", inputs={"X": x}, outputs={"Out": out})
    return out


# ---------------------------------------------------------------------------
# losses, ranking and the sampled-softmax heads
# ---------------------------------------------------------------------------

def _two_in_loss(op_type, x_slot, y_slot, x, y, attrs=None, out_slot="Loss",
                 name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={x_slot: x, y_slot: y},
                     outputs={out_slot: out}, attrs=attrs or {})
    return out


def hinge_loss(input, label, name=None):
    return _two_in_loss("hinge_loss", "Logits", "Labels", input, label,
                        name=name)


def rank_loss(label, left, right, name=None):
    """RankNet's loss of the pair (left, right) under ``label``."""
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type="rank_loss",
                     inputs={"Label": label, "Left": left, "Right": right},
                     outputs={"Out": out})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype, True)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": label, "X1": left, "X2": right},
                     outputs={"Out": out, "Activated": act},
                     attrs={"margin": margin})
    return out


def bpr_loss(input, label, name=None):
    return _two_in_loss("bpr_loss", "X", "Label", input, label,
                        out_slot="Y", name=name)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _two_in_loss(
        "teacher_student_sigmoid_loss", "X", "Label", input, label,
        attrs={"soft_max_up_bound": soft_max_up_bound,
               "soft_max_lower_bound": soft_max_lower_bound},
        out_slot="Y")


def squared_l2_distance(x, y, name=None):
    helper = LayerHelper("squared_l2_distance", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    sub = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="squared_l2_distance",
                     inputs={"X": x, "Y": y},
                     outputs={"Out": out, "sub_result": sub})
    return out


def squared_l2_norm(x, name=None):
    helper = LayerHelper("squared_l2_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="squared_l2_norm", inputs={"X": x},
                     outputs={"Out": out})
    return out


def l1_norm(x, name=None):
    helper = LayerHelper("l1_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="l1_norm", inputs={"X": x},
                     outputs={"Out": out})
    return out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None,
        name=None, sampler="uniform", custom_dist=None, seed=0,
        is_sparse=False):
    """The NCE head (nce_op.h): Weight [C, D] and Bias [C, 1] and the
    per-row cost [B, 1] against ``num_neg_samples`` (10 by default)
    uniformly drawn classes. ``sampler`` and ``seed`` are written to the
    op and ignored by it; ``custom_dist``, ``sample_weight`` and
    ``is_sparse`` are ignored, as by the JAX layer."""
    helper = LayerHelper("nce", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    inputs = {"Input": input, "Label": label, "Weight": w}
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr,
                                    shape=[num_total_classes, 1],
                                    dtype=input.dtype, is_bias=True)
        inputs["Bias"] = b
    cost = helper.create_variable_for_type_inference(input.dtype)
    sl = helper.create_variable_for_type_inference(input.dtype, True)
    sll = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": cost, "SampleLogits": sl, "SampleLabels": sll},
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples or 10,
               "sampler": sampler, "seed": seed})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """The hierarchical sigmoid head over the default complete binary
    tree: W [C - 1, D], Bias [C - 1, 1], the cost [B, 1]."""
    helper = LayerHelper("hierarchical_sigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_classes - 1, dim],
                                dtype=input.dtype)
    inputs = {"X": input, "Label": label, "W": w}
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr,
                                    shape=[num_classes - 1, 1],
                                    dtype=input.dtype, is_bias=True)
        inputs["Bias"] = b
    out = helper.create_variable_for_type_inference(input.dtype)
    pre = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": out, "PreOut": pre},
                     attrs={"num_classes": num_classes})
    return out


# ---------------------------------------------------------------------------
# the image and vision layers
# ---------------------------------------------------------------------------

def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """The transposed convolution over an NCHW input with the IOHW filter
    [C, num_filters / groups, kh, kw] (Xavier by default); without
    ``filter_size`` the kernel is solved from ``output_size``. The op
    has no AMP cast point."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        output_size = _pair(output_size)
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1)
            // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1)
            // dilation[1] + 1]
    else:
        filter_size = _pair(filter_size)
    w = helper.create_parameter(
        helper.param_attr,
        [input.shape[1], num_filters // groups] + list(filter_size), dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose", inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups})
    return helper.append_activation(_conv_bias(helper, pre_bias))


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None):
    """conv2d in three dims (NCDHW); the filter [num_filters, C / groups,
    kd, kh, kw] starts from N(0, sqrt(2 / (kd * kh * kw * C)))."""
    helper = LayerHelper("conv3d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    ks = _triple(filter_size)
    cin = input.shape[1]
    std = (2.0 / (ks[0] * ks[1] * ks[2] * cin)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, [num_filters, cin // groups, *ks], input.dtype,
        default_initializer=NormalInitializer(0.0, std))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="conv3d", inputs={"Input": input, "Filter": w},
                     outputs={"Output": out},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding),
                            "dilations": _triple(dilation),
                            "groups": groups})
    return helper.append_activation(_conv_bias(helper, out))


def conv3d_transpose(input, num_filters, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=None, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None):
    """conv2d_transpose in three dims (NCDHW, IODHW filter)."""
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    stride, padding, dilation = _triple(stride), _triple(padding), \
        _triple(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        output_size = _triple(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1 for i in range(3)]
    else:
        filter_size = _triple(filter_size)
    w = helper.create_parameter(
        helper.param_attr,
        [input.shape[1], num_filters // groups] + list(filter_size),
        input.dtype)
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="conv3d_transpose", inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups})
    return helper.append_activation(_conv_bias(helper, pre_bias))


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pool3d", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"pooling_type": pool_type,
                            "ksize": _triple(pool_size),
                            "strides": _triple(pool_stride),
                            "paddings": _triple(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode,
                            "exclusive": exclusive})
    return out


def _adaptive_pool(input, pool_size, pool_type, require_index, nd, name):
    if require_index:
        raise ValueError("require_index=True (pool indices) is not "
                         "supported; the pooling returns values only")
    if isinstance(pool_size, int):
        pool_size = [pool_size] * nd
    op_type = "pool2d" if nd == 2 else "pool3d"
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type=op_type, inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"pooling_type": pool_type,
                            "ksize": list(pool_size), "adaptive": True})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """pool2d to an output of ``pool_size``, over variable-size bins."""
    return _adaptive_pool(input, pool_size, pool_type, require_index, 2,
                          name)


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    return _adaptive_pool(input, pool_size, pool_type, require_index, 3,
                          name)


def pool2d_with_index(input, pool_size, pool_stride=1, pool_padding=0,
                      name=None):
    """max_pool2d_with_index: returns (out, int32 mask)."""
    helper = LayerHelper("max_pool2d_with_index", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mask = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(type="max_pool2d_with_index", inputs={"X": input},
                     outputs={"Out": out, "Mask": mask},
                     attrs={"ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding)})
    return out, mask


def unpool(input, indices, unpool_size, name=None):
    helper = LayerHelper("unpool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="unpool", inputs={"X": input, "Indices": indices},
                     outputs={"Out": out},
                     attrs={"unpooled_height": unpool_size[0],
                            "unpooled_width": unpool_size[1]})
    return out


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    """Scale (1) and bias (0) parameters a channel; float32 Mean and
    Variance a group."""
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    c = input.shape[1]
    inputs = {"X": input}
    inputs["Scale"] = helper.create_parameter(
        helper.param_attr, [c], dtype,
        default_initializer=ConstantInitializer(1.0))
    b = helper.create_parameter(helper.bias_attr, [c], dtype, is_bias=True)
    if b is not None:
        inputs["Bias"] = b
    mean = helper.create_variable_for_type_inference("float32", True)
    var = helper.create_variable_for_type_inference("float32", True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"epsilon": epsilon, "groups": groups})
    return helper.append_activation(out)


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    residual = helper.create_variable_for_type_inference(input.dtype, True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="huber_loss", inputs={"X": input, "Y": label},
                     outputs={"Out": out, "Residual": residual},
                     attrs={"delta": delta})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="maxout", inputs={"X": x}, outputs={"Out": out},
                     attrs={"groups": groups})
    return out


def prelu(x, mode, param_attr=None, name=None):
    """alpha (0.25) of shape [1] (``all``), [1, C, 1, 1] (``channel``) or
    [1, *x.shape[1:]] (``element``)."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [1, x.shape[1], 1, 1]
    else:
        alpha_shape = [1] + list(x.shape[1:])
    alpha = helper.create_parameter(
        helper.param_attr, alpha_shape, x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu", inputs={"X": x, "Alpha": alpha},
                     outputs={"Out": out}, attrs={"mode": mode})
    return out


def hash(input, hash_size, num_hash=1, name=None):
    helper = LayerHelper("hash", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="hash", inputs={"X": input}, outputs={"Out": out},
                     attrs={"num_hash": num_hash, "mod_by": hash_size})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32", min=-1.0,
                                   max=1.0, name=None):
    helper = LayerHelper("uniform_random_batch_size_like", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="uniform_random_batch_size_like", inputs={"Input": input},
        outputs={"Out": out},
        attrs={"shape": list(shape), "min": float(min), "max": float(max),
               "dtype": dtype})
    return out


def gaussian_random_batch_size_like(input, shape, mean=0.0, std=1.0,
                                    dtype="float32", name=None):
    helper = LayerHelper("gaussian_random_batch_size_like", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gaussian_random_batch_size_like", inputs={"Input": input},
        outputs={"Out": out},
        attrs={"shape": list(shape), "mean": float(mean),
               "std": float(std), "dtype": dtype})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="lrn", inputs={"X": input},
                     outputs={"Out": out, "MidOut": mid},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def crop(x, shape=None, offsets=None, name=None):
    """A static slice of ``x``: ``shape`` a list, or a variable whose
    shape is taken (the op's Y)."""
    helper = LayerHelper("crop", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs, attrs = {"X": x}, {}
    if isinstance(shape, Variable):
        inputs["Y"] = shape
    else:
        attrs["shape"] = list(shape)
    attrs["offsets"] = list(offsets or [0] * len(x.shape))
    helper.append_op(type="crop", inputs=inputs, outputs={"Out": out},
                     attrs=attrs)
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper("pad_constant_like", name=name)
    out = helper.create_variable_for_type_inference(y.dtype)
    helper.append_op(type="pad_constant_like", inputs={"X": x, "Y": y},
                     outputs={"Out": out},
                     attrs={"pad_value": float(pad_value)})
    return out


def random_crop(x, shape=None, seed=None):
    """A crop of ``shape`` over x's trailing dims at offsets drawn anew for
    every example and run (the program's random stream; ``seed`` is
    accepted and not read, as in the JAX layer)."""
    helper = LayerHelper("random_crop")
    out = helper.create_variable_for_type_inference(x.dtype)
    seed_out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="random_crop", inputs={"X": x},
                     outputs={"Out": out, "SeedOut": seed_out},
                     attrs={"shape": list(shape)})
    return out


def shuffle_channel(x, group, name=None):
    helper = LayerHelper("shuffle_channel", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="shuffle_channel", inputs={"X": x},
                     outputs={"Out": out}, attrs={"group": group})
    return out


def space_to_depth(x, blocksize, name=None):
    helper = LayerHelper("space_to_depth", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="space_to_depth", inputs={"X": x},
                     outputs={"Out": out}, attrs={"blocksize": blocksize})
    return out


def selu(x, scale=None, alpha=None, name=None):
    helper = LayerHelper("selu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    attrs = {}
    if scale is not None:
        attrs["scale"] = float(scale)
    if alpha is not None:
        attrs["alpha"] = float(alpha)
    helper.append_op(type="selu", inputs={"X": x}, outputs={"Out": out},
                     attrs=attrs)
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type="multiplex", inputs={"X": inputs, "Ids": index},
                     outputs={"Out": out})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sampling_id", inputs={"X": x},
                     outputs={"Out": out}, attrs={"seed": seed})
    return out


def norm(x, axis=1, epsilon=1e-10, name=None):
    helper = LayerHelper("norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    nrm = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="norm", inputs={"X": x},
                     outputs={"Out": out, "Norm": nrm},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def data_norm(input, param_attr=None, name=None):
    """Normalize by the accumulated batch statistics of CTR models: the
    accumulators ``<name>.batch_size`` (1e4), ``.batch_sum`` (0) and
    ``.batch_square_sum`` (1e4) are persistable, not trained."""
    helper = LayerHelper("data_norm", param_attr=param_attr, name=name)
    d = input.shape[-1]
    prefix = name or helper.name

    def accumulator(suffix, value):
        return helper.create_parameter(
            ParamAttr(name=prefix + suffix,
                      initializer=ConstantInitializer(value),
                      trainable=False), [d], input.dtype)

    bsize = accumulator(".batch_size", 1e4)
    bsum = accumulator(".batch_sum", 0.0)
    bsq = accumulator(".batch_square_sum", 1e4)
    out = helper.create_variable_for_type_inference(input.dtype)
    means = helper.create_variable_for_type_inference(input.dtype, True)
    scales = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="data_norm",
                     inputs={"X": input, "BatchSize": bsize,
                             "BatchSum": bsum, "BatchSquareSum": bsq},
                     outputs={"Y": out, "Means": means, "Scales": scales})
    return out


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None,
                            act=None, name=None):
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(helper.param_attr,
                                [size, x.shape[-1], y.shape[-1]], x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x, "Y": y, "Weight": w}
    if helper.bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(
            helper.bias_attr, [1, size], x.dtype, is_bias=True)
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": out})
    return helper.append_activation(out)


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("int32")
    correct = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": input, "Labels": label},
                     outputs={"OutMeanIou": miou, "OutWrong": wrong,
                              "OutCorrect": correct},
                     attrs={"num_classes": num_classes})
    return miou, wrong, correct


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="grid_sampler", inputs={"X": x, "Grid": grid},
                     outputs={"Output": out})
    return out


def affine_grid(theta, out_shape, name=None):
    helper = LayerHelper("affine_grid", name=name)
    out = helper.create_variable_for_type_inference(theta.dtype)
    helper.append_op(type="affine_grid", inputs={"Theta": theta},
                     outputs={"Output": out},
                     attrs={"output_shape": list(out_shape)})
    return out


def conv_shift(x, y, name=None):
    helper = LayerHelper("conv_shift", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="conv_shift", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def similarity_focus(input, axis, indexes, name=None):
    helper = LayerHelper("similarity_focus", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="similarity_focus", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"axis": axis, "indexes": list(indexes)})
    return out
