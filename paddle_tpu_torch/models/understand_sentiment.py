"""understand_sentiment book models (counterpart of
``paddle_tpu/models/understand_sentiment.py``; reference
tests/book/notest_understand_sentiment.py): IMDB binary sentiment with
either

- convolution_net: a shared embedding -> two sequence_conv_pool branches
  (filter 3 and 4, tanh, sqrt pooling) -> a two-input fc softmax;
- stacked_lstm_net: an embedding -> an fc + lstm ladder whose direction
  alternates by layer (is_reverse on even layers) -> max pools of the last
  fc and lstm -> a two-input fc softmax.

Padded [B, T] batches with an explicit length replace LoD batching.
"""
from __future__ import annotations

import numpy as np

from .. import layers, nets, optimizer
from ..framework import Program, program_guard


def _head(branches, label):
    prediction = layers.fc(branches, size=2, act="softmax")
    cost = layers.cross_entropy(prediction, label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(prediction, label)
    return prediction, avg_cost, acc


def build(net="conv", dict_size=5000, emb_dim=32, hid_dim=32,
          stacked_num=3, max_len=64, lr=0.002):
    assert net in ("conv", "stacked_lstm")
    main, startup = Program(), Program()
    with program_guard(main, startup):
        data = layers.data("words", shape=[max_len, 1], dtype="int64")
        length = layers.data("length", shape=[], dtype="int32",
                             append_batch_size=True)
        label = layers.data("label", shape=[1], dtype="int64")
        emb = layers.embedding(data, size=[dict_size, emb_dim])

        if net == "conv":
            conv_3 = nets.sequence_conv_pool(
                emb, num_filters=hid_dim, filter_size=3, act="tanh",
                pool_type="sqrt", length=length)
            conv_4 = nets.sequence_conv_pool(
                emb, num_filters=hid_dim, filter_size=4, act="tanh",
                pool_type="sqrt", length=length)
            branches = [conv_3, conv_4]
        else:
            assert stacked_num % 2 == 1
            fc1 = layers.fc(emb, size=hid_dim * 4, num_flatten_dims=2)
            lstm1, _ = layers.dynamic_lstm(
                fc1, size=hid_dim * 4, use_peepholes=False,
                length=length)
            inputs = [fc1, lstm1]
            for i in range(2, stacked_num + 1):
                fc = layers.fc(inputs, size=hid_dim * 4,
                               num_flatten_dims=2)
                lstm, _ = layers.dynamic_lstm(
                    fc, size=hid_dim * 4, use_peepholes=False,
                    is_reverse=(i % 2) == 0, length=length)
                inputs = [fc, lstm]
            fc_last = layers.sequence_pool(inputs[0], "max",
                                           length=length)
            lstm_last = layers.sequence_pool(inputs[1], "max",
                                             length=length)
            branches = [fc_last, lstm_last]

        prediction, avg_cost, acc = _head(branches, label)
        test_program = main.clone(for_test=True)
        opt = optimizer.AdamOptimizer(learning_rate=lr)
        opt.minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["words", "length", "label"], "loss": avg_cost,
            "acc": acc, "predict": prediction,
            "config": {"dict_size": dict_size, "max_len": max_len}}


def make_batch(samples, max_len=64):
    """imdb (ids, label) rows -> padded feed dict."""
    b = len(samples)
    words = np.zeros((b, max_len, 1), np.int64)
    length = np.zeros((b,), np.int32)
    label = np.zeros((b, 1), np.int64)
    for i, (ids, lb) in enumerate(samples):
        ids = list(ids)[:max_len]
        words[i, :len(ids), 0] = ids
        length[i] = len(ids)
        label[i, 0] = lb
    return {"words": words, "length": length, "label": label}


def make_fake_batch(batch_size, dict_size=5000, max_len=64, seed=0):
    """Random word ids, lengths in [5, max_len) and labels in {0, 1}."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, dict_size, (batch_size, max_len, 1)).astype(
        np.int64)
    length = rng.randint(5, max_len, (batch_size,)).astype(np.int32)
    label = rng.randint(0, 2, (batch_size, 1)).astype(np.int64)
    return {"words": words, "length": length, "label": label}
