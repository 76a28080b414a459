"""NN layers (reference python/paddle/fluid/layers/nn.py): the ones the
Transformer builds. Each builds descs via LayerHelper; no device work
happens here."""

from __future__ import annotations

import numpy as np

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "layer_norm", "softmax_with_cross_entropy",
    "reshape", "transpose", "squeeze", "reduce_sum", "scale",
    "elementwise_add", "elementwise_mul", "elementwise_div",
    "elementwise_min", "sequence_mask", "fused_attention", "matmul",
    "softmax", "unsqueeze",
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


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(
        type="reduce_sum", inputs={"X": input}, outputs={"Out": out},
        attrs={"dim": dim if dim is not None else [],
               "keep_dim": keep_dim, "reduce_all": dim is None})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale", inputs={"X": x}, outputs={"Out": out},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


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
