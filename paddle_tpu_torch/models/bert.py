"""BERT-base pretraining (counterpart of ``paddle_tpu/models/bert.py``):
the masked-LM and next-sentence heads over a post-norm Transformer
encoder, with the same parameter names and op sequence, so the programs
the two packages build serialize to the same bytes.

Static [B, T] shapes with a length-derived key bias [B, T] shared by
every layer's ``flash_attention``; the masked-LM head gathers a fixed
budget of ``max_masked`` flat positions per sample (``gather`` over
[B*T, D]) and decodes against the tied word embedding (``matmul`` with
``transpose_y``), so ``word_embedding``'s gradient is the sum of its
``lookup_table_grad`` and that product's. ``build`` trains with Adam
(lr 1e-4, epsilon 1e-6), as bench.py's BERT rung does; with
``is_train=False`` the caller appends its own optimizer (LAMB, a clip, a
schedule) under ``program_guard``.
"""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..framework import Program, program_guard
from ..initializer import NormalInitializer
from ..layer_helper import ParamAttr
from .transformer import (_no_dropout, check_attention_impl,
                          multi_head_attention, positionwise_feed_forward)


def encoder_layer(x, n_head, d_key, d_value, d_model, d_inner_hid,
                  dropout_rate, name="", key_bias=None,
                  attention_impl="fused"):
    """Post-norm (original BERT) encoder block."""
    attn = multi_head_attention(x, None, None, None, d_key, d_value,
                                d_model, n_head, dropout_rate,
                                name=f"{name}_att", key_bias=key_bias,
                                attention_impl=attention_impl)
    x = layers.layer_norm(layers.elementwise_add(x, attn),
                          begin_norm_axis=len(x.shape) - 1)
    ffn = positionwise_feed_forward(x, d_inner_hid, d_model, dropout_rate,
                                    name=name)
    return layers.layer_norm(layers.elementwise_add(x, ffn),
                             begin_norm_axis=len(x.shape) - 1)


def build(vocab_size=30522, max_len=128, max_masked=20, n_layer=12,
          n_head=12, d_model=768, d_inner_hid=3072, type_vocab=2,
          dropout_rate=0.0, lr=1e-4, is_train=True,
          attention_impl="fused", length_masks=True):
    """BERT programs: ``main`` (forward, loss and, with ``is_train``, the
    backward and the Adam update), ``startup`` and ``test`` (the clone
    before the optimizer), with ``loss``, ``mlm_loss``, ``nsp_loss``,
    ``feeds`` and ``config``. Dropout is not ported (ROADMAP A1):
    ``dropout_rate`` must be 0. ``attention_impl`` is "fused" or
    "unfused"; the JAX package's sequence-parallel "ring", "ulysses" and
    "usp" are ROADMAP A12. ``length_masks=False`` drops the key bias
    (full-length batches)."""
    check_attention_impl(attention_impl)
    _no_dropout(dropout_rate, "build")
    d_key = d_value = d_model // n_head
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src_ids", shape=[max_len, 1], dtype="int64")
        pos = layers.data("pos_ids", shape=[max_len, 1], dtype="int64")
        sent = layers.data("sent_ids", shape=[max_len, 1], dtype="int64")
        seq_len = layers.data("seq_len", shape=[], dtype="int32")
        mask_pos = layers.data("mask_pos", shape=[max_masked],
                               dtype="int64")
        mask_label = layers.data("mask_label", shape=[max_masked, 1],
                                 dtype="int64")
        mask_weight = layers.data("mask_weight", shape=[max_masked],
                                  dtype="float32")
        nsp_label = layers.data("labels", shape=[1], dtype="int64")

        emb_init = NormalInitializer(0.0, 0.02)
        word_emb = layers.embedding(
            src, size=[vocab_size, d_model],
            param_attr=ParamAttr(name="word_embedding",
                                 initializer=emb_init))
        pos_emb = layers.embedding(
            pos, size=[max_len, d_model],
            param_attr=ParamAttr(name="pos_embedding",
                                 initializer=emb_init))
        sent_emb = layers.embedding(
            sent, size=[type_vocab, d_model],
            param_attr=ParamAttr(name="sent_embedding",
                                 initializer=emb_init))
        x = layers.elementwise_add(
            layers.elementwise_add(word_emb, pos_emb), sent_emb)
        x = layers.layer_norm(x, begin_norm_axis=len(x.shape) - 1)

        if length_masks:
            key_bias = layers.scale(layers.cast(layers.sequence_mask(
                seq_len, maxlen=max_len, dtype="int32"), "float32"),
                scale=1e9, bias=-1e9)        # [B, T] 0 keep / -1e9 pad
        else:
            key_bias = None
        for i in range(n_layer):
            x = encoder_layer(x, n_head, d_key, d_value, d_model,
                              d_inner_hid, dropout_rate,
                              name=f"layer{i}", key_bias=key_bias,
                              attention_impl=attention_impl)

        # masked-LM head: mask_pos holds flat positions i * T + t
        flat = layers.reshape(x, [-1, d_model])          # [B*T, D]
        picked = layers.gather(flat, layers.reshape(mask_pos, [-1]))
        mlm = layers.fc(picked, size=d_model, act="gelu",
                        param_attr=ParamAttr(name="mlm_trans.w"))
        mlm = layers.layer_norm(mlm, begin_norm_axis=1)
        # decode against the tied word embedding
        word_table = main.global_block().vars["word_embedding"]
        logits = layers.matmul(mlm, word_table, transpose_y=True)
        mlm_loss = layers.softmax_with_cross_entropy(
            logits, layers.reshape(mask_label, [-1, 1]))
        w = layers.reshape(mask_weight, [-1, 1])
        mlm_loss = layers.elementwise_div(
            layers.reduce_sum(layers.elementwise_mul(mlm_loss, w)),
            layers.reduce_sum(w))

        # next-sentence head on [CLS] (t = 0)
        cls = layers.slice(x, axes=[1], starts=[0], ends=[1])
        cls = layers.reshape(cls, [-1, d_model])
        pooled = layers.fc(cls, size=d_model, act="tanh",
                           param_attr=ParamAttr(name="pooled.w"))
        nsp_logits = layers.fc(pooled, size=2,
                               param_attr=ParamAttr(name="nsp.w"))
        nsp_loss = layers.mean(layers.softmax_with_cross_entropy(
            nsp_logits, nsp_label))

        loss = layers.elementwise_add(mlm_loss, nsp_loss)
        test_program = main.clone(for_test=True)
        if is_train:
            optimizer.AdamOptimizer(learning_rate=lr, beta1=0.9, beta2=0.999,
                                    epsilon=1e-6).minimize(loss)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["src_ids", "pos_ids", "sent_ids", "seq_len",
                      "mask_pos", "mask_label", "mask_weight", "labels"],
            "loss": loss, "mlm_loss": mlm_loss, "nsp_loss": nsp_loss,
            "config": {"vocab_size": vocab_size, "max_len": max_len,
                       "max_masked": max_masked, "n_layer": n_layer,
                       "n_head": n_head, "d_model": d_model}}


def make_fake_batch(batch_size, cfg, seed=0):
    """The JAX package's synthetic batch (the same ids from the same
    seed): full-length rows, M masked flat positions per row, their
    original ids as labels and the [MASK] id 3 in their place."""
    rng = np.random.RandomState(seed)
    T, M, V = cfg["max_len"], cfg["max_masked"], cfg["vocab_size"]
    src = rng.randint(4, V, (batch_size, T, 1)).astype(np.int64)
    pos = np.tile(np.arange(T, dtype=np.int64)[None, :, None],
                  (batch_size, 1, 1))
    sent = np.zeros((batch_size, T, 1), np.int64)
    sent[:, T // 2:] = 1
    seq_len = np.full((batch_size,), T, np.int32)
    mask_pos = np.stack([rng.choice(T, M, replace=False) + i * T
                         for i in range(batch_size)]).astype(np.int64)
    flat_src = src.reshape(-1)
    mask_label = flat_src[mask_pos.reshape(-1)].reshape(
        batch_size, M, 1).copy()
    src.reshape(-1)[mask_pos.reshape(-1)] = 3  # [MASK] id
    mask_weight = np.ones((batch_size, M), np.float32)
    labels = rng.randint(0, 2, (batch_size, 1)).astype(np.int64)
    return {"src_ids": src, "pos_ids": pos, "sent_ids": sent,
            "seq_len": seq_len, "mask_pos": mask_pos,
            "mask_label": mask_label, "mask_weight": mask_weight,
            "labels": labels}
