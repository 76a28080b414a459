"""Transformer-base NMT (counterpart of ``paddle_tpu/models/transformer.py``
:22-345): multi-head attention, position-wise FFN and the pre/post-process
wrappers, with the same parameter names and op sequence, so the programs
the two packages build serialize to the same bytes.

Static [batch, max_len] shapes with length-derived key masks. With
``attention_impl="fused"`` every attention (encoder self, decoder causal
self, cross) is one ``flash_attention`` op; with ``"unfused"`` it is the
matmul -> key-bias add -> [causal add] -> softmax -> matmul chain, which
``BuildStrategy.fuse_attention_ops`` rewrites into ``flash_attention``.
``build`` trains with the noam schedule and Adam (dropout 0).
"""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..framework import Program, program_guard
from ..initializer import NormalInitializer
from ..layer_helper import ParamAttr


_IMPLS = ("fused", "unfused")
# the JAX package's sequence-parallel kernels (ROADMAP A12)
_SP_IMPLS = ("ring", "ulysses", "usp")


def _no_dropout(dropout_rate, where):
    if dropout_rate:
        raise ValueError(f"{where}(dropout_rate={dropout_rate}): dropout is "
                         "not ported yet (ROADMAP A1); pass dropout_rate=0")


def check_attention_impl(attention_impl, where="build"):
    if attention_impl in _SP_IMPLS:
        raise NotImplementedError(
            f"{where}(attention_impl={attention_impl!r}): the port has "
            f"{_IMPLS}; the sequence-parallel kernels wait for ROADMAP A12 "
            "(multi-device)")
    if attention_impl not in _IMPLS:
        raise ValueError(f"unknown attention_impl {attention_impl!r}")


def multi_head_attention(queries, keys, values, attn_bias, d_key, d_value,
                         d_model, n_head=1, dropout_rate=0.0, cache=None,
                         name="", causal=False, key_bias=None,
                         attention_impl="fused"):
    """Multi-head attention, in the JAX package's signature: one
    ``flash_attention`` op ("fused", no dense ``attn_bias``) or the dense
    matmul -> [attn_bias add] -> [key-bias add] -> [causal add] ->
    softmax -> matmul chain ("unfused", or any dense ``attn_bias``
    [B, H, Tq, Tk]). ``key_bias`` [B, Tk] is the additive key-padding
    mask. Attention dropout (ROADMAP A1), the incremental decode
    ``cache`` (A7) and the sequence-parallel impls (A12) are not
    ported."""
    check_attention_impl(attention_impl, "multi_head_attention")
    _no_dropout(dropout_rate, "multi_head_attention")
    if cache is not None:
        raise NotImplementedError(
            "multi_head_attention(cache=...): the incremental decode cache "
            "is not ported yet (ROADMAP A7)")
    keys = queries if keys is None else keys
    values = keys if values is None else values
    q = layers.fc(queries, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=ParamAttr(name=f"{name}_q.w"))
    k = layers.fc(keys, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=ParamAttr(name=f"{name}_k.w"))
    v = layers.fc(values, size=d_value * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=ParamAttr(name=f"{name}_v.w"))

    def split_heads(x, d):
        b, t = x.shape[0], x.shape[1]
        return layers.transpose(layers.reshape(x, [b, t, n_head, d]),
                                [0, 2, 1, 3])

    q = split_heads(q, d_key)
    k = split_heads(k, d_key)
    v = split_heads(v, d_value)
    if attn_bias is None and attention_impl == "fused":
        out = layers.fused_attention(q, k, v, causal=causal,
                                     scale=d_key ** -0.5, key_bias=key_bias)
    else:
        product = layers.matmul(q, k, transpose_y=True, alpha=d_key ** -0.5)
        if attn_bias is not None:
            product = layers.elementwise_add(product, attn_bias)
        if key_bias is not None:
            kb = layers.unsqueeze(layers.unsqueeze(key_bias, axes=[1]),
                                  axes=[1])
            product = layers.elementwise_add(product, kb)
        if causal:
            product = _causal_add(product)
        out = layers.matmul(layers.softmax(product), v)
    b, t = queries.shape[0], queries.shape[1]
    out = layers.transpose(out, [0, 2, 1, 3])
    out = layers.reshape(out, [b, t, n_head * d_value])
    return layers.fc(out, size=d_model, num_flatten_dims=2, bias_attr=False,
                     param_attr=ParamAttr(name=f"{name}_o.w"))


def positionwise_feed_forward(x, d_inner_hid, d_hid, dropout_rate=0.0,
                              name=""):
    _no_dropout(dropout_rate, "positionwise_feed_forward")
    hidden = layers.fc(x, size=d_inner_hid, num_flatten_dims=2, act="relu",
                       param_attr=ParamAttr(name=f"{name}_ffn1.w"))
    return layers.fc(hidden, size=d_hid, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"{name}_ffn2.w"))


def pre_post_process_layer(prev_out, out, process_cmd):
    """'n' layer_norm / 'a' residual add ('d' dropout is a no-op at
    rate 0)."""
    for cmd in process_cmd:
        if cmd == "a" and prev_out is not None:
            out = layers.elementwise_add(out, prev_out)
        elif cmd == "n":
            out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
    return out


def encoder_layer(enc_input, n_head, d_key, d_value, d_model, d_inner_hid,
                  name="", key_bias=None, attention_impl="fused"):
    attn = multi_head_attention(
        pre_post_process_layer(None, enc_input, "n"), None, None, None,
        d_key, d_value, d_model, n_head, name=f"{name}_att",
        key_bias=key_bias, attention_impl=attention_impl)
    attn_out = pre_post_process_layer(enc_input, attn, "da")
    ffn = positionwise_feed_forward(
        pre_post_process_layer(None, attn_out, "n"), d_inner_hid, d_model,
        name=f"{name}")
    return pre_post_process_layer(attn_out, ffn, "da")


def decoder_layer(dec_input, enc_output, n_head, d_key, d_value, d_model,
                  d_inner_hid, name="", src_key_bias=None,
                  trg_key_bias=None, attention_impl="fused"):
    self_attn = multi_head_attention(
        pre_post_process_layer(None, dec_input, "n"), None, None, None,
        d_key, d_value, d_model, n_head, name=f"{name}_satt", causal=True,
        key_bias=trg_key_bias, attention_impl=attention_impl)
    x = pre_post_process_layer(dec_input, self_attn, "da")
    cross = multi_head_attention(
        pre_post_process_layer(None, x, "n"), enc_output, enc_output, None,
        d_key, d_value, d_model, n_head, name=f"{name}_catt",
        key_bias=src_key_bias, attention_impl=attention_impl)
    x = pre_post_process_layer(x, cross, "da")
    ffn = positionwise_feed_forward(
        pre_post_process_layer(None, x, "n"), d_inner_hid, d_model,
        name=f"{name}")
    return pre_post_process_layer(x, ffn, "da")


def _embed(ids, vocab_size, d_model, max_len, pos_ids, name=""):
    word = layers.embedding(
        ids, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=f"{name}_word_emb",
                             initializer=NormalInitializer(
                                 0.0, d_model ** -0.5)))
    word = layers.scale(word, scale=d_model ** 0.5)
    pos = layers.embedding(pos_ids, size=[max_len, d_model],
                           param_attr=ParamAttr(name=f"{name}_pos_emb"))
    pos.stop_gradient = True
    return layers.elementwise_add(word, pos)


def _length_key_bias(length, max_len):
    """[B] lengths -> [B, max_len] additive key bias, 0 keep / -1e9 drop."""
    return layers.scale(layers.cast(layers.sequence_mask(
        length, maxlen=max_len, dtype="int32"), "float32"),
        scale=1e9, bias=-1e9)


def build(batch_size=16, src_vocab=10000, tgt_vocab=10000, max_len=64,
          n_layer=6, n_head=8, d_model=512, d_inner_hid=2048,
          dropout_rate=0.0, lr=2.0, warmup_steps=8000,
          attention_impl="fused"):
    """Transformer-base programs: ``main`` (forward, loss, backward and the
    Adam update under the noam schedule of ``warmup_steps``), ``startup``
    (parameter and optimizer-state initializers) and ``test`` (the
    inference clone), with ``logits``, ``loss``, ``feeds`` and ``config``.
    ``lr`` is unused, as in the JAX package (noam sets the rate). Dropout
    is not ported: ``dropout_rate`` must be 0. ``attention_impl`` is
    "fused" or "unfused" (the JAX package's sequence-parallel kernels,
    "ring", "ulysses" and "usp", are ROADMAP A12)."""
    _no_dropout(dropout_rate, "build")
    check_attention_impl(attention_impl)
    d_key = d_value = d_model // n_head
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src_word", shape=[max_len, 1], dtype="int64")
        src_pos = layers.data("src_pos", shape=[max_len, 1], dtype="int64")
        trg = layers.data("trg_word", shape=[max_len, 1], dtype="int64")
        trg_pos = layers.data("trg_pos", shape=[max_len, 1], dtype="int64")
        lbl = layers.data("lbl_word", shape=[max_len, 1], dtype="int64")
        src_len = layers.data("src_len", shape=[], dtype="int32")
        trg_len = layers.data("trg_len", shape=[], dtype="int32")
        src_kb = _length_key_bias(src_len, max_len)
        trg_kb = _length_key_bias(trg_len, max_len)

        enc = _embed(src, src_vocab, d_model, max_len, src_pos, "src")
        for i in range(n_layer):
            enc = encoder_layer(enc, n_head, d_key, d_value, d_model,
                                d_inner_hid, name=f"enc{i}", key_bias=src_kb,
                                attention_impl=attention_impl)
        enc = pre_post_process_layer(None, enc, "n")

        dec = _embed(trg, tgt_vocab, d_model, max_len, trg_pos, "trg")
        for i in range(n_layer):
            dec = decoder_layer(dec, enc, n_head, d_key, d_value, d_model,
                                d_inner_hid, name=f"dec{i}",
                                src_key_bias=src_kb, trg_key_bias=trg_kb,
                                attention_impl=attention_impl)
        dec = pre_post_process_layer(None, dec, "n")

        logits = layers.fc(dec, size=tgt_vocab, num_flatten_dims=2,
                           bias_attr=False, param_attr=ParamAttr(name="proj.w"))
        loss = layers.softmax_with_cross_entropy(logits, lbl)
        tok_mask = layers.cast(layers.sequence_mask(
            trg_len, maxlen=max_len, dtype="int32"), "float32")
        loss = layers.elementwise_mul(layers.squeeze(loss, axes=[2]),
                                      tok_mask)
        avg_cost = layers.elementwise_div(layers.reduce_sum(loss),
                                          layers.reduce_sum(tok_mask))
        test_program = main.clone(for_test=True)
        sched = layers.learning_rate_scheduler.noam_decay(d_model,
                                                          warmup_steps)
        optimizer.AdamOptimizer(learning_rate=sched, beta1=0.9, beta2=0.98,
                                epsilon=1e-9).minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test_program,
            "feeds": ["src_word", "src_pos", "trg_word", "trg_pos",
                      "lbl_word", "src_len", "trg_len"],
            "loss": avg_cost, "logits": logits,
            "config": {"n_layer": n_layer, "n_head": n_head,
                       "d_model": d_model, "d_inner_hid": d_inner_hid,
                       "max_len": max_len, "src_vocab": src_vocab,
                       "tgt_vocab": tgt_vocab}}


def make_fake_batch(batch_size, cfg, seed=0):
    """Synthetic batch (the JAX package's generator, so both packages see
    the same ids); masks derive on the device from the lengths."""
    rng = np.random.RandomState(seed)
    ml = cfg["max_len"]
    src = rng.randint(1, cfg["src_vocab"], (batch_size, ml, 1)).astype(
        np.int64)
    trg = rng.randint(1, cfg["tgt_vocab"], (batch_size, ml, 1)).astype(
        np.int64)
    lbl = rng.randint(1, cfg["tgt_vocab"], (batch_size, ml, 1)).astype(
        np.int64)
    pos = np.tile(np.arange(ml, dtype=np.int64)[None, :, None],
                  (batch_size, 1, 1))
    length = np.full((batch_size,), ml, np.int32)
    return {"src_word": src, "src_pos": pos, "trg_word": trg,
            "trg_pos": pos, "lbl_word": lbl,
            "src_len": length, "trg_len": length}


def _causal_add(product):
    """Dense-path causal mask: upper-triangular -1e9 added to
    [B, H, T, T] scores."""
    t = product.shape[-1]
    tri = np.triu(np.full((t, t), -1e9, np.float32), k=1)
    bias = layers.assign(tri)
    return layers.elementwise_add(product, bias)
