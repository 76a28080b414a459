"""VGG-16 with batch_norm and dropout (counterpart of
``paddle_tpu/models/vgg.py``; reference benchmark/fluid/models/vgg.py):
five ``img_conv_group`` blocks, two fc, Adam."""

from __future__ import annotations

from .. import layers, nets, optimizer
from ..framework import Program, program_guard


def vgg16_bn_drop(input, is_train=True):
    def conv_block(ipt, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=not is_train)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return fc2


def build(dataset="cifar10", lr=0.01):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        if dataset == "cifar10":
            image_shape, class_dim = [3, 32, 32], 10
        else:
            image_shape, class_dim = [3, 224, 224], 102
        images = layers.data("data", shape=image_shape, dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        net = vgg16_bn_drop(images)
        predict = layers.fc(input=net, size=class_dim, act="softmax")
        cost = layers.cross_entropy(input=predict, label=label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        test_program = main.clone(for_test=True)
        opt = optimizer.AdamOptimizer(learning_rate=lr)
        opt.minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["data", "label"], "loss": avg_cost, "acc": acc,
            "predict": predict}
