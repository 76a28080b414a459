"""SE-ResNeXt (counterpart of ``paddle_tpu/models/se_resnext.py``; reference
benchmark/fluid/models/se_resnext.py): grouped-conv bottlenecks with
squeeze-excitation channel gating, the 50/101/152 variants, cardinality
32 or 64, reduction 16, momentum 0.9. The grouped 3x3 convolution is one
``conv2d`` with ``groups`` = cardinality (cuDNN on the card)."""
from __future__ import annotations

import math

from .. import layers, optimizer
from ..framework import Program, program_guard
from ..initializer import UniformInitializer
from ..layer_helper import ParamAttr


def conv_bn_layer(input, ch_out, filter_size, stride=1, groups=1,
                  act=None, is_train=True):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=not is_train)


def squeeze_excitation(input, num_channels, reduction_ratio,
                       is_train=True):
    """Global-pool channel gate: pool -> fc(C/r) relu -> fc(C) sigmoid
    -> per-channel scale of the block output."""
    pool = layers.pool2d(input=input, pool_type="avg",
                         global_pooling=True)
    stdv = 1.0 / math.sqrt(float(pool.shape[1]))
    squeeze = layers.fc(
        input=pool, size=num_channels // reduction_ratio, act="relu",
        param_attr=ParamAttr(
            initializer=UniformInitializer(-stdv, stdv)))
    stdv = 1.0 / math.sqrt(float(squeeze.shape[1]))
    excitation = layers.fc(
        input=squeeze, size=num_channels, act="sigmoid",
        param_attr=ParamAttr(
            initializer=UniformInitializer(-stdv, stdv)))
    return layers.elementwise_mul(x=input, y=excitation, axis=0)


def shortcut(input, ch_out, stride, is_train=True):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride,
                             is_train=is_train)
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio, is_train=True):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          is_train=is_train)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride,
                          groups=cardinality, act="relu",
                          is_train=is_train)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_train=is_train)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio,
                               is_train=is_train)
    short = shortcut(input, num_filters * 2, stride, is_train=is_train)
    return layers.elementwise_add(x=short, y=scale, act="relu")


def se_resnext_net(input, class_dim, depth=50, is_train=True,
                   dropout_prob=0.5):
    cfg = {  # depth -> (stages, cardinality)
        50: ([3, 4, 6, 3], 32),
        101: ([3, 4, 23, 3], 32),
        152: ([3, 8, 36, 3], 64),
    }
    stages, cardinality = cfg[depth]
    reduction_ratio = 16
    num_filters = [128, 256, 512, 1024]

    if depth == 152:
        conv = conv_bn_layer(input, 64, 3, stride=2, act="relu",
                             is_train=is_train)
        conv = conv_bn_layer(conv, 64, 3, act="relu", is_train=is_train)
        conv = conv_bn_layer(conv, 128, 3, act="relu", is_train=is_train)
    else:
        conv = conv_bn_layer(input, 64, 7, stride=2, act="relu",
                             is_train=is_train)
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type="max")

    for block, count in enumerate(stages):
        for i in range(count):
            conv = bottleneck_block(
                conv, num_filters[block],
                stride=2 if i == 0 and block != 0 else 1,
                cardinality=cardinality,
                reduction_ratio=reduction_ratio, is_train=is_train)

    pool = layers.pool2d(input=conv, pool_size=7, pool_type="avg",
                         global_pooling=True)
    drop = (layers.dropout(x=pool, dropout_prob=dropout_prob)
            if is_train and dropout_prob else pool)
    stdv = 1.0 / math.sqrt(float(drop.shape[1]))
    return layers.fc(
        input=drop, size=class_dim, act="softmax",
        param_attr=ParamAttr(
            initializer=UniformInitializer(-stdv, stdv)))


def build(depth=50, class_dim=102, image_shape=None, lr=0.01,
          is_train=True, dropout_prob=0.5):
    """benchmark/fluid/models/se_resnext.py get_model analog."""
    image_shape = image_shape or [3, 224, 224]
    main, startup = Program(), Program()
    with program_guard(main, startup):
        input = layers.data("data", shape=image_shape, dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        predict = se_resnext_net(input, class_dim, depth=depth,
                                 is_train=is_train,
                                 dropout_prob=dropout_prob)
        cost = layers.cross_entropy(input=predict, label=label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        test_program = main.clone(for_test=True)
        opt = optimizer.MomentumOptimizer(learning_rate=lr,
                                          momentum=0.9)
        opt.minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["data", "label"], "loss": avg_cost, "acc": acc,
            "predict": predict}
