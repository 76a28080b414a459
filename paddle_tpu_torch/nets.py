"""Composite nets (counterpart of ``paddle_tpu/nets.py``; reference
python/paddle/fluid/nets.py): ``simple_img_conv_pool``, ``img_conv_group``,
``glu``, ``sequence_conv_pool`` and ``scaled_dot_product_attention``, each
built from the layers DSL with the JAX package's op sequence."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention", "sequence_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """conv2d then pool2d."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """A run of convolutions, each optionally followed by batch_norm (and
    then dropout at its rate), and one pool2d."""
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]
    n = len(conv_num_filter)

    def _expand(arg):
        return [arg] * n if not isinstance(arg, (list, tuple)) else list(arg)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(n):
        local_conv_act = conv_act if not conv_with_batchnorm[i] else None
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_stride=pool_stride, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: split in two along ``dim``, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.ops.sigmoid(b))


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", length=None):
    """The padded-batch form of nets.sequence_conv_pool: a 1-D convolution
    along T as conv2d on [B, 1, T, D], then sequence_pool over ``length``."""
    b_t_d = input
    x4 = layers.unsqueeze(b_t_d, [1])
    conv = layers.conv2d(x4, num_filters=num_filters,
                         filter_size=[filter_size, b_t_d.shape[-1]],
                         padding=[(filter_size - 1) // 2, 0],
                         param_attr=param_attr, act=act)
    conv = layers.squeeze(conv, [3])
    conv = layers.transpose(conv, [0, 2, 1])
    return layers.sequence_pool(conv, pool_type, length=length)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention (reference nets.py:340):
    the ``fused_attention`` op (the flash kernels on the card) without
    dropout, else matmul, softmax, dropout and matmul."""
    head_dim = queries.shape[-1] // num_heads

    def _split_heads(x):
        b, t, d = x.shape
        x = layers.reshape(x, [b, t, num_heads, d // num_heads])
        return layers.transpose(x, [0, 2, 1, 3])

    def _merge_heads(x):
        b, h, t, d = x.shape
        x = layers.transpose(x, [0, 2, 1, 3])
        return layers.reshape(x, [b, t, h * d])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    if not dropout_rate:
        return _merge_heads(layers.fused_attention(
            q, k, v, scale=head_dim ** -0.5))
    scaled_q = layers.scale(q, scale=head_dim ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx_multiheads = layers.matmul(weights, v)
    return _merge_heads(ctx_multiheads)
