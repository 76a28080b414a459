"""Label semantic roles, the book's db_lstm (counterpart of
``paddle_tpu/models/label_semantic_roles.py``; reference
tests/book/test_label_semantic_roles.py): 8 feature embeddings, their fc
projections summed, a stack of ``depth`` dynamic_lstm layers alternating
in direction with direct edges, then a linear-chain CRF loss and its
Viterbi decode.

Sequences are padded [B, max_len] with a [B] length. The word embedding
``emb`` is not trainable; the CRF's transition ``crfw`` trains at 0.1 of
the rate.
"""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..dataset import conll05
from ..framework import Program, program_guard
from ..layer_helper import ParamAttr

WORD_FEATS = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
              "ctx_p1_data", "ctx_p2_data")


def db_lstm(word_inputs, predicate, mark, length, word_dict_len,
            pred_dict_len, mark_dict_len=2, word_dim=32, mark_dim=5,
            hidden_dim=512, depth=8):
    pred_emb = layers.embedding(
        predicate, size=[pred_dict_len, word_dim], param_attr="vemb")
    mark_emb = layers.embedding(mark, size=[mark_dict_len, mark_dim])
    emb_layers = [
        layers.embedding(x, size=[word_dict_len, word_dim],
                         param_attr=ParamAttr(name="emb", trainable=False))
        for x in word_inputs
    ]
    # lookup_table drops the trailing [., 1] id dim: [B, T, 1] -> [B, T, D]
    emb_layers += [pred_emb, mark_emb]

    hidden_0 = layers.sums([
        layers.fc(emb, size=hidden_dim, num_flatten_dims=2)
        for emb in emb_layers])
    lstm_0, _ = layers.dynamic_lstm(
        hidden_0, size=hidden_dim, candidate_activation="relu",
        gate_activation="sigmoid", cell_activation="sigmoid",
        length=length)

    # the L-LSTM and R-LSTM stack with direct edges
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = layers.sums([
            layers.fc(input_tmp[0], size=hidden_dim, num_flatten_dims=2),
            layers.fc(input_tmp[1], size=hidden_dim, num_flatten_dims=2),
        ])
        lstm, _ = layers.dynamic_lstm(
            mix_hidden, size=hidden_dim, candidate_activation="relu",
            gate_activation="sigmoid", cell_activation="sigmoid",
            is_reverse=((i % 2) == 1), length=length)
        input_tmp = [mix_hidden, lstm]

    return layers.sums([
        layers.fc(input_tmp[0], size=conll05.LABEL_COUNT,
                  num_flatten_dims=2, act="tanh"),
        layers.fc(input_tmp[1], size=conll05.LABEL_COUNT,
                  num_flatten_dims=2, act="tanh"),
    ])


def build(max_len=40, word_dim=32, hidden_dim=512, depth=8, lr=0.01,
          word_dict_len=None, pred_dict_len=None):
    word_dict_len = word_dict_len or conll05.WORD_VOCAB
    pred_dict_len = pred_dict_len or conll05.PRED_VOCAB
    main, startup = Program(), Program()
    with program_guard(main, startup):
        word_inputs = [layers.data(n, shape=[max_len, 1], dtype="int64")
                       for n in WORD_FEATS]
        predicate = layers.data("verb_data", shape=[max_len, 1],
                                dtype="int64")
        mark = layers.data("mark_data", shape=[max_len, 1], dtype="int64")
        length = layers.data("length", shape=[], dtype="int32")
        target = layers.data("target", shape=[max_len], dtype="int64")

        feature_out = db_lstm(word_inputs, predicate, mark, length,
                              word_dict_len, pred_dict_len,
                              word_dim=word_dim, hidden_dim=hidden_dim,
                              depth=depth)
        crf_cost = layers.linear_chain_crf(
            feature_out, target,
            param_attr=ParamAttr(name="crfw", learning_rate=1e-1),
            length=length)
        avg_cost = layers.mean(crf_cost)
        crf_decode = layers.crf_decoding(
            feature_out, param_attr=ParamAttr(name="crfw"), length=length)
        test_program = main.clone(for_test=True)
        opt = optimizer.SGDOptimizer(learning_rate=lr)
        opt.minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": [*WORD_FEATS, "verb_data", "mark_data", "length",
                      "target"],
            "loss": avg_cost, "decode": crf_decode,
            "config": {"max_len": max_len}}


def make_batch(samples, max_len=40):
    """conll05 rows (9 sequences each) -> a padded feed dict."""
    n = len(samples)
    names = [*WORD_FEATS, "verb_data", "mark_data"]
    feed = {name: np.zeros((n, max_len, 1), np.int64) for name in names}
    feed["length"] = np.zeros((n,), np.int32)
    feed["target"] = np.zeros((n, max_len), np.int64)
    for i, row in enumerate(samples):
        seqs, labels = row[:8], row[8]
        ln = min(len(labels), max_len)
        for name, seq in zip(names, seqs):
            feed[name][i, :ln, 0] = np.asarray(seq[:ln], np.int64)
        feed["target"][i, :ln] = np.asarray(labels[:ln], np.int64)
        feed["length"][i] = ln
    return feed
