"""ResNet (counterpart of ``paddle_tpu/models/resnet.py``; reference
benchmark/fluid/models/resnet.py): conv_bn_layer, shortcut, basicblock and
bottleneck, the cifar10 and flowers/ImageNet variants, with the same op
sequence and parameter names, so the programs the two packages build
serialize to the same bytes. ``build`` trains with momentum 0.9."""

from __future__ import annotations

from .. import layers, optimizer
from ..framework import Program, program_guard


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_train=True):
    conv1 = layers.conv2d(input=input, filter_size=filter_size,
                          num_filters=ch_out, stride=stride,
                          padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv1, act=act, is_test=not is_train)


def shortcut(input, ch_out, stride, is_train=True):
    if input.shape[1] != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             is_train=is_train)
    return input


def basicblock(input, ch_out, stride, is_train=True):
    short = shortcut(input, ch_out, stride, is_train=is_train)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_train=is_train)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None,
                          is_train=is_train)
    return layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_out, stride, is_train=True):
    short = shortcut(input, ch_out * 4, stride, is_train=is_train)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_train=is_train)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_train=is_train)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_train=is_train)
    return layers.elementwise_add(short, conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_train=True):
    res_out = block_func(input, ch_out, stride, is_train=is_train)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_train=is_train)
    return res_out


_IMAGENET = {18: ([2, 2, 2, 2], basicblock),
             34: ([3, 4, 6, 3], basicblock),
             50: ([3, 4, 6, 3], bottleneck),
             101: ([3, 4, 23, 3], bottleneck),
             152: ([3, 8, 36, 3], bottleneck)}


def resnet_imagenet(input, class_dim, depth=50, is_train=True):
    stages, block_func = _IMAGENET[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_train=is_train)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1)
    res = pool1
    for i, (count, ch_out) in enumerate(zip(stages, (64, 128, 256, 512))):
        res = layer_warp(block_func, res, ch_out, count, 1 if i == 0 else 2,
                         is_train=is_train)
    pool2 = layers.pool2d(input=res, pool_size=7, pool_type="avg",
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim, depth=32, is_train=True):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_train=is_train)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_train=is_train)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_train=is_train)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_train=is_train)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")


def build(dataset="flowers", depth=50, class_dim=102, image_shape=None,
          lr=0.01, is_train=True, layout="NCHW", preprocess=False,
          raw_shape=None):
    """benchmark/fluid/models/resnet.py get_model: the train program
    (momentum 0.9), its startup and the test clone.

    layout="NHWC" rewrites the conv/pool/batch_norm spine with
    conv_layout_nhwc_pass before the backward is appended (the feed
    stays NCHW: one transpose in, one out). preprocess=True (the raw
    uint8 feed with an in-graph random crop) is not ported."""
    if preprocess:
        raise NotImplementedError(
            "resnet.build(preprocess=True) needs the random_crop op, which "
            "waits for ROADMAP A11 (the image ops)")
    main, startup = Program(), Program()
    with program_guard(main, startup):
        if dataset == "cifar10":
            image_shape = image_shape or [3, 32, 32]
            class_dim = 10
            model, kwargs = resnet_cifar10, {"depth": 32}
        else:
            image_shape = image_shape or [3, 224, 224]
            model, kwargs = resnet_imagenet, {"depth": depth}
        input = layers.data("data", shape=image_shape, dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        predict = model(input, class_dim, is_train=is_train, **kwargs)
        cost = layers.cross_entropy(input=predict, label=label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        test_program = main.clone(for_test=True)
        if layout == "NHWC":
            from ..ir.passes import apply_passes
            apply_passes(main, ["conv_layout_nhwc_pass"],
                         protected=[avg_cost.name, acc.name, predict.name])
        opt = optimizer.MomentumOptimizer(learning_rate=lr, momentum=0.9)
        opt.minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["data", "label"], "loss": avg_cost, "acc": acc,
            "predict": predict}
