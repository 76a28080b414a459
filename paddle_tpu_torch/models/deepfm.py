"""DeepFM CTR model (counterpart of ``paddle_tpu/models/deepfm.py``; the
BASELINE ladder's sparse-embedding rung): F categorical field ids (one
slot each) and dense features, a first-order term, the FM second-order
sum-square trick over the field embeddings, a deep relu tower, a click
label, log loss and the streaming AUC, Adam (``lazy_mode``; the update is
dense, as in the JAX package).
"""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..framework import Program, program_guard
from ..layer_helper import ParamAttr

NUM_FIELDS = 26
DENSE_DIM = 13
SPARSE_VOCAB = 100003  # hashed id space per the CTR convention


def build(sparse_vocab=SPARSE_VOCAB, num_fields=NUM_FIELDS,
          dense_dim=DENSE_DIM, embed_dim=16, fc_sizes=(400, 400, 400),
          lr=1e-3, is_sparse=True):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        ids = layers.data("feat_ids", shape=[num_fields, 1],
                          dtype="int64")
        dense = layers.data("dense_input", shape=[dense_dim],
                            dtype="float32")
        label = layers.data("click", shape=[1], dtype="int64")

        # ---- first order: per-id scalar weights + dense linear ----
        w1 = layers.embedding(
            ids, size=[sparse_vocab, 1], is_sparse=is_sparse,
            param_attr=ParamAttr(name="fm_w1"))            # [B, F, 1]
        first = layers.reduce_sum(layers.reshape(w1, [-1, num_fields]),
                                  dim=1, keep_dim=True)
        first = layers.elementwise_add(
            first, layers.fc(dense, size=1, bias_attr=False,
                             param_attr=ParamAttr(name="dense_w1")))

        # ---- second order: FM sum-square trick over field embs ----
        emb = layers.embedding(
            ids, size=[sparse_vocab, embed_dim], is_sparse=is_sparse,
            param_attr=ParamAttr(name="fm_emb"))           # [B, F, K]
        sum_emb = layers.reduce_sum(emb, dim=1)            # [B, K]
        sum_sq = layers.square(sum_emb)
        sq_sum = layers.reduce_sum(layers.square(emb), dim=1)
        second = layers.scale(layers.reduce_sum(
            layers.elementwise_sub(sum_sq, sq_sum), dim=1, keep_dim=True),
            scale=0.5)

        # ---- deep tower over concatenated field embeddings ----
        deep = layers.reshape(emb, [-1, num_fields * embed_dim])
        deep = layers.concat([deep, dense], axis=1)
        for i, size in enumerate(fc_sizes):
            deep = layers.fc(deep, size=size, act="relu",
                             param_attr=ParamAttr(name=f"deep_{i}.w"))
        deep_out = layers.fc(deep, size=1, bias_attr=False,
                             param_attr=ParamAttr(name="deep_out.w"))

        logits = layers.elementwise_add(
            layers.elementwise_add(first, second), deep_out)
        prob = layers.sigmoid(logits)
        loss = layers.mean(layers.log_loss(
            prob, layers.cast(label, "float32")))
        predict_2d = layers.concat(
            [layers.elementwise_sub(
                layers.fill_constant_batch_size_like(prob, [-1, 1],
                                                     "float32", 1.0),
                prob), prob], axis=1)
        auc, _ = layers.auc(predict_2d, label)
        test_program = main.clone(for_test=True)
        opt = optimizer.AdamOptimizer(learning_rate=lr, lazy_mode=True)
        opt.minimize(loss)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["feat_ids", "dense_input", "click"],
            "loss": loss, "auc": auc, "predict": prob,
            "config": {"sparse_vocab": sparse_vocab,
                       "num_fields": num_fields,
                       "dense_dim": dense_dim}}


def make_fake_batch(batch_size, cfg=None, seed=0):
    """Synthetic CTR batch with learnable signal: the click probability
    depends on a fixed random projection of the sample's ids."""
    cfg = cfg or {"sparse_vocab": SPARSE_VOCAB, "num_fields": NUM_FIELDS,
                  "dense_dim": DENSE_DIM}
    rng = np.random.RandomState(seed)
    F, V, D = cfg["num_fields"], cfg["sparse_vocab"], cfg["dense_dim"]
    ids = rng.randint(0, V, (batch_size, F, 1)).astype(np.int64)
    dense = rng.rand(batch_size, D).astype(np.float32)
    score = (ids.reshape(batch_size, F).sum(axis=1) % 7) / 7.0 \
        + dense.mean(axis=1)
    click = (score > np.median(score)).astype(np.int64).reshape(-1, 1)
    return {"feat_ids": ids, "dense_input": dense, "click": click}
