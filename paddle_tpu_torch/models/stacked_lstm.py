"""Stacked LSTM sentiment model (counterpart of
``paddle_tpu/models/stacked_lstm.py``; reference
benchmark/fluid/models/stacked_dynamic_lstm.py): embedding -> N x [fc +
lstm] -> the last valid step's hidden -> fc, softmax cross entropy, Adam."""
from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..framework import Program, program_guard


def build(dict_size=5000, emb_dim=512, lstm_size=512, stacked_num=3,
          class_num=2, max_len=100, lr=0.001):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        data = layers.data("words", shape=[max_len, 1], dtype="int64")
        length = layers.data("length", shape=[], dtype="int32",
                             append_batch_size=True)
        label = layers.data("label", shape=[1], dtype="int64")

        emb = layers.embedding(data, size=[dict_size, emb_dim])

        hidden = emb
        for _ in range(stacked_num):
            proj = layers.fc(hidden, size=lstm_size * 4,
                             num_flatten_dims=2, act=None)
            hidden, _cell = layers.dynamic_lstm(
                proj, size=lstm_size * 4, use_peepholes=False,
                length=length)

        last = layers.sequence_pool(hidden, "last", length=length)
        logits = layers.fc(last, size=class_num, act=None)
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        test_program = main.clone(for_test=True)
        opt = optimizer.AdamOptimizer(learning_rate=lr)
        opt.minimize(loss)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["words", "length", "label"], "loss": loss,
            "acc": acc}


def make_fake_batch(batch_size, dict_size=5000, max_len=100, seed=0):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, dict_size, (batch_size, max_len, 1)).astype(
        np.int64)
    length = rng.randint(5, max_len, (batch_size,)).astype(np.int32)
    label = rng.randint(0, 2, (batch_size, 1)).astype(np.int64)
    return {"words": words, "length": length, "label": label}
