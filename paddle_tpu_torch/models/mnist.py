"""MNIST LeNet (counterpart of ``paddle_tpu/models/mnist.py``; reference
benchmark/fluid/mnist.py cnn_model and tests/book/test_recognize_digits.py):
two conv-pool stages, an fc softmax, cross entropy, Adam."""

from __future__ import annotations

import numpy as np

from .. import layers, nets, optimizer
from ..framework import Program, program_guard


def cnn_model(data):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    predict = layers.fc(conv_pool_2, size=10, act="softmax")
    return predict


def build(batch_size=None, lr=0.001):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        images = layers.data("pixel", shape=[1, 28, 28], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        predict = cnn_model(images)
        cost = layers.cross_entropy(predict, label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        test_program = main.clone(for_test=True)
        opt = optimizer.AdamOptimizer(learning_rate=lr)
        opt.minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["pixel", "label"], "loss": avg_cost, "acc": acc,
            "predict": predict}


def make_fake_batch(batch_size, seed=0):
    """Random 28x28 images in [0, 1) and labels in [0, 10)."""
    rng = np.random.RandomState(seed)
    return {"pixel": rng.rand(batch_size, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (batch_size, 1)).astype(np.int64)}
