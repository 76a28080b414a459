"""fit_a_line linear regression (counterpart of
``paddle_tpu/models/fit_a_line.py``; reference tests/book/test_fit_a_line.py):
13 uci_housing features -> fc(1) -> square_error_cost, SGD."""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..framework import Program, program_guard


def build(lr=0.01):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", shape=[13], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        y_predict = layers.fc(x, size=1, act=None)
        cost = layers.square_error_cost(input=y_predict, label=y)
        avg_loss = layers.mean(cost)
        test_program = main.clone(for_test=True)
        opt = optimizer.SGDOptimizer(learning_rate=lr)
        opt.minimize(avg_loss)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["x", "y"], "loss": avg_loss,
            "predict": y_predict}


def make_batch(samples):
    """uci_housing (features, price) rows -> feed dict."""
    xs = np.asarray([s[0] for s in samples], np.float32)
    ys = np.asarray([s[1] for s in samples], np.float32).reshape(-1, 1)
    return {"x": xs, "y": ys}


def make_fake_batch(batch_size, seed=0):
    """A batch of 13 random features and a price linear in them."""
    rng = np.random.RandomState(seed)
    xs = rng.rand(batch_size, 13).astype(np.float32)
    ys = (xs @ np.linspace(-1.0, 1.0, 13).astype(np.float32)).reshape(-1, 1)
    return {"x": xs, "y": ys.astype(np.float32)}
