"""Transformer-base NMT (counterpart of ``paddle_tpu/models/transformer.py``
:22-345): multi-head attention, position-wise FFN and the pre/post-process
wrappers, with the same parameter names and op sequence, so the programs
the two packages build serialize to the same bytes.

Static [batch, max_len] shapes with length-derived key masks. With
``attention_impl="fused"`` every attention (encoder self, decoder causal
self, cross) is one ``flash_attention`` op; with ``"unfused"`` it is the
matmul -> key-bias add -> [causal add] -> softmax -> matmul chain, which
``BuildStrategy.fuse_attention_ops`` rewrites into ``flash_attention``.
``build`` trains with the noam schedule and Adam. With ``dropout_rate``
> 0 the JAX package's dropout sites apply (upscale_in_train): the
embeddings, each residual branch, the FFN hidden layer and the attention
weights; attention then takes the dense chain, never the flash op.

``build_lm`` is the decoder-only LM of the generation engine
(inference/generation): a prefill program per prompt bucket, a
prefix-prefill program per (suffix bucket, prefix length) and a one-token
decode step per cache capacity, sharing one explicitly named parameter
set. Every attention there is the dense chain; none is a
``flash_attention``.
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
    mask. With ``cache`` ({"k", "v"}: split-heads [B, H, T, D]) the
    step's keys and values are concatenated to the cache's along time,
    the dict is rebound to the grown variables and the dense chain
    attends over them (the reference's incremental decode; shapes grow
    per step, so the generation engine's fixed-capacity
    ``kv_cache_write`` cache serves instead). With ``dropout_rate`` > 0
    the attention weights are dropped (upscale_in_train) on the dense
    chain, which then serves every impl, as in the JAX package. The
    sequence-parallel impls (A12) are not ported."""
    check_attention_impl(attention_impl, "multi_head_attention")
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
    if cache is not None:
        k = cache["k"] = layers.concat([cache["k"], k], axis=2)
        v = cache["v"] = layers.concat([cache["v"], v], axis=2)
    if (attn_bias is None and not dropout_rate and attention_impl == "fused"
            and cache is None):
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
        weights = layers.softmax(product)
        if dropout_rate:
            weights = layers.dropout(
                weights, dropout_prob=dropout_rate,
                dropout_implementation="upscale_in_train")
        out = layers.matmul(weights, v)
    b, t = queries.shape[0], queries.shape[1]
    out = layers.transpose(out, [0, 2, 1, 3])
    out = layers.reshape(out, [b, t, n_head * d_value])
    return layers.fc(out, size=d_model, num_flatten_dims=2, bias_attr=False,
                     param_attr=ParamAttr(name=f"{name}_o.w"))


def positionwise_feed_forward(x, d_inner_hid, d_hid, dropout_rate=0.0,
                              name=""):
    hidden = layers.fc(x, size=d_inner_hid, num_flatten_dims=2, act="relu",
                       param_attr=ParamAttr(name=f"{name}_ffn1.w"))
    if dropout_rate:
        hidden = layers.dropout(hidden, dropout_prob=dropout_rate,
                                dropout_implementation="upscale_in_train")
    return layers.fc(hidden, size=d_hid, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"{name}_ffn2.w"))


def pre_post_process_layer(prev_out, out, process_cmd, dropout_rate=0.0):
    """'n' layer_norm / 'a' residual add / 'd' dropout (none at rate 0)."""
    for cmd in process_cmd:
        if cmd == "a" and prev_out is not None:
            out = layers.elementwise_add(out, prev_out)
        elif cmd == "n":
            out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
        elif cmd == "d" and dropout_rate:
            out = layers.dropout(out, dropout_prob=dropout_rate,
                                 dropout_implementation="upscale_in_train")
    return out


def encoder_layer(enc_input, n_head, d_key, d_value, d_model, d_inner_hid,
                  dropout_rate=0.0, name="", key_bias=None,
                  attention_impl="fused"):
    attn = multi_head_attention(
        pre_post_process_layer(None, enc_input, "n"), None, None, None,
        d_key, d_value, d_model, n_head, dropout_rate, name=f"{name}_att",
        key_bias=key_bias, attention_impl=attention_impl)
    attn_out = pre_post_process_layer(enc_input, attn, "da", dropout_rate)
    ffn = positionwise_feed_forward(
        pre_post_process_layer(None, attn_out, "n"), d_inner_hid, d_model,
        dropout_rate, name=f"{name}")
    return pre_post_process_layer(attn_out, ffn, "da", dropout_rate)


def decoder_layer(dec_input, enc_output, n_head, d_key, d_value, d_model,
                  d_inner_hid, dropout_rate=0.0, name="", src_key_bias=None,
                  trg_key_bias=None, attention_impl="fused"):
    self_attn = multi_head_attention(
        pre_post_process_layer(None, dec_input, "n"), None, None, None,
        d_key, d_value, d_model, n_head, dropout_rate, name=f"{name}_satt",
        causal=True, key_bias=trg_key_bias, attention_impl=attention_impl)
    x = pre_post_process_layer(dec_input, self_attn, "da", dropout_rate)
    cross = multi_head_attention(
        pre_post_process_layer(None, x, "n"), enc_output, enc_output, None,
        d_key, d_value, d_model, n_head, dropout_rate, name=f"{name}_catt",
        key_bias=src_key_bias, attention_impl=attention_impl)
    x = pre_post_process_layer(x, cross, "da", dropout_rate)
    ffn = positionwise_feed_forward(
        pre_post_process_layer(None, x, "n"), d_inner_hid, d_model,
        dropout_rate, name=f"{name}")
    return pre_post_process_layer(x, ffn, "da", dropout_rate)


def _embed(ids, vocab_size, d_model, max_len, pos_ids, dropout_rate=0.0,
           name=""):
    word = layers.embedding(
        ids, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=f"{name}_word_emb",
                             initializer=NormalInitializer(
                                 0.0, d_model ** -0.5)))
    word = layers.scale(word, scale=d_model ** 0.5)
    pos = layers.embedding(pos_ids, size=[max_len, d_model],
                           param_attr=ParamAttr(name=f"{name}_pos_emb"))
    pos.stop_gradient = True
    out = layers.elementwise_add(word, pos)
    if dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate,
                             dropout_implementation="upscale_in_train")
    return out


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
    ``lr`` is unused, as in the JAX package (noam sets the rate).
    ``dropout_rate`` defaults to 0 here (the JAX package's ``build``
    defaults to 0.1; pass it to build the same program). With a rate > 0
    every attention is the dense chain. ``attention_impl`` is "fused" or
    "unfused" (the JAX package's sequence-parallel kernels, "ring",
    "ulysses" and "usp", are ROADMAP A12)."""
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

        enc = _embed(src, src_vocab, d_model, max_len, src_pos,
                     dropout_rate, "src")
        for i in range(n_layer):
            enc = encoder_layer(enc, n_head, d_key, d_value, d_model,
                                d_inner_hid, dropout_rate, name=f"enc{i}",
                                key_bias=src_kb,
                                attention_impl=attention_impl)
        enc = pre_post_process_layer(None, enc, "n")

        dec = _embed(trg, tgt_vocab, d_model, max_len, trg_pos,
                     dropout_rate, "trg")
        for i in range(n_layer):
            dec = decoder_layer(dec, enc, n_head, d_key, d_value, d_model,
                                d_inner_hid, dropout_rate, name=f"dec{i}",
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


# ---------------------------------------------------------------------------
# the decoder-only LM of the generation engine (inference/generation)
# ---------------------------------------------------------------------------


def _lm_split_heads(x, n_head, d):
    b, t = x.shape[0], x.shape[1]
    return layers.transpose(layers.reshape(x, [b, t, n_head, d]),
                            [0, 2, 1, 3])


def _lm_merge_heads(x, n_head, d):
    b = x.shape[0]
    t = x.shape[2]
    return layers.reshape(layers.transpose(x, [0, 2, 1, 3]),
                          [b, t, n_head * d])


def _lm_embed(tokens, pos_ids, vocab, d_model, max_positions):
    word = layers.embedding(
        tokens, size=[vocab, d_model],
        param_attr=ParamAttr(name="lm_word_emb",
                             initializer=NormalInitializer(
                                 0.0, d_model ** -0.5)))
    word = layers.scale(word, scale=d_model ** 0.5)
    pos = layers.embedding(pos_ids, size=[max_positions, d_model],
                           param_attr=ParamAttr(name="lm_pos_emb"))
    pos.stop_gradient = True
    return layers.elementwise_add(word, pos)


def _lm_proj_qkv(h, i, n_head, d_key):
    q = layers.fc(h, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=ParamAttr(name=f"lm{i}_q.w"))
    k = layers.fc(h, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=ParamAttr(name=f"lm{i}_k.w"))
    v = layers.fc(h, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=ParamAttr(name=f"lm{i}_v.w"))
    return (_lm_split_heads(q, n_head, d_key),
            _lm_split_heads(k, n_head, d_key),
            _lm_split_heads(v, n_head, d_key))


def _lm_attn_out(weights, v, i, n_head, d_key, d_model):
    out = _lm_merge_heads(layers.matmul(weights, v), n_head, d_key)
    return layers.fc(out, size=d_model, num_flatten_dims=2,
                     bias_attr=False,
                     param_attr=ParamAttr(name=f"lm{i}_o.w"))


def _lm_ln(x, name):
    return layers.layer_norm(x, begin_norm_axis=len(x.shape) - 1,
                             param_attr=ParamAttr(name=f"{name}.w"),
                             bias_attr=ParamAttr(name=f"{name}.b"))


def _lm_ffn(x, i, d_inner_hid, d_model):
    h = layers.fc(x, size=d_inner_hid, num_flatten_dims=2, act="relu",
                  param_attr=ParamAttr(name=f"lm{i}_ffn1.w"),
                  bias_attr=ParamAttr(name=f"lm{i}_ffn1.b"))
    return layers.fc(h, size=d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"lm{i}_ffn2.w"),
                     bias_attr=ParamAttr(name=f"lm{i}_ffn2.b"))


def _lm_block(x, i, n_head, d_key, d_model, d_inner_hid, attend):
    """One pre-norm block; ``attend(q, k, v)`` -> (weights, values)."""
    q, k, v = _lm_proj_qkv(_lm_ln(x, f"lm{i}_ln1"), i, n_head, d_key)
    weights, vals = attend(q, k, v)
    x = layers.elementwise_add(
        x, _lm_attn_out(weights, vals, i, n_head, d_key, d_model))
    ffn = _lm_ffn(_lm_ln(x, f"lm{i}_ln2"), i, d_inner_hid, d_model)
    return layers.elementwise_add(x, ffn), k, v


def _lm_logits(x, vocab):
    return layers.fc(_lm_ln(x, "lm_final_ln"), size=vocab,
                     num_flatten_dims=2, bias_attr=False,
                     param_attr=ParamAttr(name="lm_proj.w"))


def _lm_bias(length, maxlen):
    """[B] lengths -> [B, 1, 1, maxlen] additive bias, 0 keep / -1e9."""
    return layers.unsqueeze(layers.unsqueeze(
        _length_key_bias(length, maxlen), axes=[1]), axes=[1])


def build_lm(vocab=1000, n_layer=2, n_head=2, d_model=32, d_inner_hid=64,
             max_positions=128, eos_id=1, pad_id=0):
    """Decoder-only transformer LM as a ``GenerationSpec``: returns
    ``{"spec", "config"}``. ``spec.build_prefill(tp)`` is the causal
    forward over a prompt bucket ``tp`` fetching the logits and each
    layer's split-heads K/V; ``spec.build_prefill_prefix(ts, pc)`` the
    same over a suffix bucket ``ts`` attending over a fed K/V prefix of
    padded length ``pc``; ``spec.build_decode(cap)`` the one-token step
    against a fixed-capacity cache. Parameters are named explicitly, so
    every program shares the set ``spec.startup`` initializes."""
    from ..inference.generation.spec import GenerationSpec

    d_key = d_model // n_head
    alpha = d_key ** -0.5

    def build_prefill(tp, startup=None):
        if tp > max_positions:
            raise ValueError(f"prompt bucket {tp} exceeds max_positions "
                             f"{max_positions}")
        main = Program()
        with program_guard(main, startup if startup is not None
                           else Program()):
            tokens = layers.data("lm_tokens", shape=[tp, 1], dtype="int64")
            pos = layers.data("lm_pos", shape=[tp, 1], dtype="int64")
            length = layers.data("lm_len", shape=[], dtype="int32")
            # the key-padding bias, as the decode step builds it from its
            # positions
            kb = _length_key_bias(length, tp)
            x = _lm_embed(tokens, pos, vocab, d_model, max_positions)

            def attend(q, k, v):
                product = layers.matmul(q, k, transpose_y=True, alpha=alpha)
                kbu = layers.unsqueeze(layers.unsqueeze(kb, axes=[1]),
                                       axes=[1])
                product = _causal_add(layers.elementwise_add(product, kbu))
                return layers.softmax(product), v

            ks, vs = [], []
            for i in range(n_layer):
                x, k, v = _lm_block(x, i, n_head, d_key, d_model,
                                    d_inner_hid, attend)
                ks.append(k)
                vs.append(v)
            logits = _lm_logits(x, vocab)
        return main, {"tokens": "lm_tokens", "pos": "lm_pos",
                      "length": "lm_len", "logits": logits.name,
                      "k": [k.name for k in ks], "v": [v.name for v in vs]}

    def build_prefill_prefix(ts, pc, startup=None):
        """A ``ts``-bucket prompt suffix against a fed K/V prefix of padded
        length ``pc``: ``lm_prefix_len`` masks the padding (one program
        per (ts, pc) serves every hit depth) and ``lm_pos`` carries global
        positions, so the suffix attends over what the full prefill
        would."""
        if ts + pc > max_positions:
            raise ValueError(f"suffix bucket {ts} + prefix {pc} exceeds "
                             f"max_positions {max_positions}")
        main = Program()
        with program_guard(main, startup if startup is not None
                           else Program()):
            tokens = layers.data("lm_tokens", shape=[ts, 1], dtype="int64")
            pos = layers.data("lm_pos", shape=[ts, 1], dtype="int64")
            length = layers.data("lm_len", shape=[], dtype="int32")
            plen = layers.data("lm_prefix_len", shape=[], dtype="int32")
            pk = [layers.data(f"lm_prefix_k{i}", shape=[n_head, pc, d_key],
                              dtype="float32") for i in range(n_layer)]
            pv = [layers.data(f"lm_prefix_v{i}", shape=[n_head, pc, d_key],
                              dtype="float32") for i in range(n_layer)]
            kbu = _lm_bias(length, ts)
            pbu = _lm_bias(plen, pc)
            x = _lm_embed(tokens, pos, vocab, d_model, max_positions)
            ks, vs = [], []
            for i in range(n_layer):
                def attend(q, k, v, i=i):
                    # every valid prefix position precedes every suffix
                    # row: the prefix columns need only the length mask
                    prod_p = layers.elementwise_add(layers.matmul(
                        q, pk[i], transpose_y=True, alpha=alpha), pbu)
                    prod_s = _causal_add(layers.elementwise_add(
                        layers.matmul(q, k, transpose_y=True, alpha=alpha),
                        kbu))
                    return (layers.softmax(layers.concat([prod_p, prod_s],
                                                         axis=3)),
                            layers.concat([pv[i], v], axis=2))

                x, k, v = _lm_block(x, i, n_head, d_key, d_model,
                                    d_inner_hid, attend)
                ks.append(k)
                vs.append(v)
            logits = _lm_logits(x, vocab)
        return main, {"tokens": "lm_tokens", "pos": "lm_pos",
                      "length": "lm_len", "prefix_len": "lm_prefix_len",
                      "prefix_k": [f"lm_prefix_k{i}" for i in range(n_layer)],
                      "prefix_v": [f"lm_prefix_v{i}" for i in range(n_layer)],
                      "logits": logits.name,
                      "k": [k.name for k in ks], "v": [v.name for v in vs]}

    def build_decode(cap, startup=None):
        if cap > max_positions:
            raise ValueError(f"cache capacity {cap} exceeds max_positions "
                             f"{max_positions}")
        main = Program()
        with program_guard(main, startup if startup is not None
                           else Program()):
            tok = layers.data("gen_token", shape=[1, 1], dtype="int64")
            pos = layers.data("gen_pos", shape=[], dtype="int32")
            cache_k = [layers.data(f"gen_cache_k{i}",
                                   shape=[n_head, cap, d_key],
                                   dtype="float32") for i in range(n_layer)]
            cache_v = [layers.data(f"gen_cache_v{i}",
                                   shape=[n_head, cap, d_key],
                                   dtype="float32") for i in range(n_layer)]
            x = _lm_embed(tok, layers.reshape(pos, [-1, 1, 1]), vocab,
                          d_model, max_positions)
            # j <= pos attends: the prompt and every token generated so
            # far, the causal and padding set the prefill masks at pos
            vbu = _lm_bias(layers.scale(pos, scale=1.0, bias=1.0), cap)
            new_k, new_v = [], []
            for i in range(n_layer):
                def attend(q, k, v, i=i):
                    ck = layers.kv_cache_write(cache_k[i], k, pos)
                    cv = layers.kv_cache_write(cache_v[i], v, pos)
                    new_k.append(ck)
                    new_v.append(cv)
                    product = layers.elementwise_add(layers.matmul(
                        q, ck, transpose_y=True, alpha=alpha), vbu)
                    return layers.softmax(product), cv

                x, _k, _v = _lm_block(x, i, n_head, d_key, d_model,
                                      d_inner_hid, attend)
            logits = _lm_logits(x, vocab)
        return main, {"token": "gen_token", "pos": "gen_pos",
                      "logits": logits.name,
                      "cache_k": [f"gen_cache_k{i}" for i in range(n_layer)],
                      "cache_v": [f"gen_cache_v{i}" for i in range(n_layer)],
                      "new_k": [k.name for k in new_k],
                      "new_v": [v.name for v in new_v]}

    # the startup of one canonical prefill: the explicit names make the
    # parameter set the same for every bucket
    startup = Program()
    build_prefill(min(8, max_positions), startup=startup)
    spec = GenerationSpec(
        vocab=vocab, eos_id=eos_id, pad_id=pad_id, n_layer=n_layer,
        n_head=n_head, d_head=d_key, max_positions=max_positions,
        startup=startup, build_prefill=build_prefill,
        build_decode=build_decode,
        build_prefill_prefix=build_prefill_prefix)
    return {"spec": spec,
            "config": {"vocab": vocab, "n_layer": n_layer, "n_head": n_head,
                       "d_model": d_model, "d_inner_hid": d_inner_hid,
                       "max_positions": max_positions, "eos_id": eos_id,
                       "pad_id": pad_id}}
