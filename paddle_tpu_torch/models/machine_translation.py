"""Attention seq2seq NMT (counterpart of
``paddle_tpu/models/machine_translation.py``, after the Fluid benchmark's
models/machine_translation.py): a bi-GRU encoder, a Bahdanau-attention
GRU decoder on StaticRNN for training, and a beam-search decode program
(a ``While`` over ``beam_search``, ``array_write`` histories and a final
``beam_search_decode``) under the dense [batch*beam] convention.

The training and decode programs are built under separate
``unique_name.guard()``s with the same layer order, so their parameter
names match and both run against one scope: the decode program runs
against the scope the training program trained. The training program
(byte-identical to the JAX package's) runs its decoder as one
``recurrent`` op, a loop over the static target length whose backward is
the generic vjp of the whole loop. The decode program's ``While`` has a
static trip bound. So on the card a train step and a whole decode are
each one device segment, captured in a CUDA graph from its second
run."""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..framework import Program, program_guard
from ..layers.control_flow import StaticRNN, While
from ..utils import unique_name


def _encoder(src, src_len, dict_size, emb_dim, hid):
    emb = layers.embedding(src, size=[dict_size, emb_dim])
    fwd_proj = layers.fc(emb, size=hid * 3, num_flatten_dims=2)
    fwd = layers.dynamic_gru(fwd_proj, size=hid, length=src_len)
    bwd_proj = layers.fc(emb, size=hid * 3, num_flatten_dims=2)
    bwd = layers.dynamic_gru(bwd_proj, size=hid, is_reverse=True,
                             length=src_len)
    enc = layers.concat([fwd, bwd], axis=2)              # [B, Ts, 2H]
    enc_last = layers.sequence_pool(enc, "last", length=src_len)
    boot = layers.fc(enc_last, size=hid, act="tanh")     # decoder h0
    enc_proj = layers.fc(enc, size=hid, num_flatten_dims=2)
    return enc, enc_proj, boot


def _attention(h_prev, enc, enc_proj, src_len, hid):
    """score = v.tanh(enc_proj + W h_prev); masked softmax; context."""
    dec_proj = layers.fc(h_prev, size=hid)               # [B, H]
    dec_exp = layers.unsqueeze(dec_proj, axes=[1])       # [B, 1, H]
    mix = layers.elementwise_add(enc_proj, dec_exp)
    mix = layers.fc(layers.tanh(mix), size=1, num_flatten_dims=2)
    scores = layers.squeeze(mix, axes=[2])               # [B, Ts]
    att = layers.sequence_softmax(scores, length=src_len)
    att_exp = layers.unsqueeze(att, axes=[2])            # [B, Ts, 1]
    ctx = layers.reduce_sum(layers.elementwise_mul(enc, att_exp), dim=1)
    return ctx                                            # [B, 2H]


def _gru_step(x_t, ctx, h_prev, hid):
    """GRU cell composed from primitive ops (gru_unit_op.cc semantics)."""
    inp = layers.concat([x_t, ctx, h_prev], axis=1)
    gates = layers.fc(inp, size=hid * 2, act="sigmoid")
    u, r = layers.split(gates, num_or_sections=2, dim=1)
    rh = layers.elementwise_mul(r, h_prev)
    cand = layers.fc(layers.concat([x_t, ctx, rh], axis=1), size=hid,
                     act="tanh")
    one_minus_u = layers.scale(u, scale=-1.0, bias=1.0)
    return layers.elementwise_add(layers.elementwise_mul(u, h_prev),
                                  layers.elementwise_mul(one_minus_u, cand))


def build(src_dict_size=1000, tgt_dict_size=1000, emb_dim=64, hid=64,
          max_len=16, lr=1e-3, beam_size=4, decode_max_len=12,
          end_id=1):
    """Returns train dict + decode program sharing the parameter set."""
    cfg = dict(src_dict_size=src_dict_size, tgt_dict_size=tgt_dict_size,
               emb_dim=emb_dim, hid=hid, max_len=max_len,
               beam_size=beam_size, decode_max_len=decode_max_len,
               end_id=end_id)

    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        src = layers.data("src", shape=[max_len], dtype="int64")
        src_len = layers.data("src_len", shape=[], dtype="int32")
        tgt = layers.data("tgt", shape=[max_len], dtype="int64")
        tgt_next = layers.data("tgt_next", shape=[max_len], dtype="int64")
        tgt_len = layers.data("tgt_len", shape=[], dtype="int32")

        enc, enc_proj, boot = _encoder(src, src_len, src_dict_size,
                                       emb_dim, hid)
        tgt_emb = layers.embedding(tgt, size=[tgt_dict_size, emb_dim],
                                   param_attr="tgt_emb_w")

        rnn = StaticRNN(length=tgt_len)
        with rnn.step():
            x_t = rnn.step_input(tgt_emb)                # [B, E]
            h_prev = rnn.memory(init=boot)               # [B, H]
            ctx = _attention(h_prev, enc, enc_proj, src_len, hid)
            h = _gru_step(x_t, ctx, h_prev, hid)
            rnn.update_memory(h_prev, h)
            logits = layers.fc(h, size=tgt_dict_size,
                               param_attr="out_proj_w",
                               bias_attr="out_proj_b")
            rnn.step_output(logits)
        all_logits = rnn()                               # [B, Tt, V]

        flat = layers.reshape(all_logits, shape=[-1, tgt_dict_size])
        flat_label = layers.reshape(tgt_next, shape=[-1, 1])
        ce = layers.softmax_with_cross_entropy(flat, flat_label)
        ce = layers.reshape(ce, shape=[-1, max_len])
        mask = layers.cast(layers.sequence_mask(
            tgt_len, maxlen=max_len, dtype="int64"), "float32")
        loss = layers.reduce_sum(layers.elementwise_mul(ce, mask))
        denom = layers.reduce_sum(mask)
        loss = layers.elementwise_div(loss, denom)
        test_program = main.clone(for_test=True)
        opt = optimizer.AdamOptimizer(learning_rate=lr)
        opt.minimize(loss)

    decode = _build_decoder_program(cfg)
    return {"main": main, "startup": startup, "test": test_program,
            "loss": loss, "config": cfg, "decode": decode,
            "feeds": ["src", "src_len", "tgt", "tgt_next", "tgt_len"]}


def _build_decoder_program(cfg):
    """Beam-search decode program (book test_machine_translation.py
    `decode`): While loop over steps; each iteration embeds the previous
    tokens for all batch*beam hypotheses, runs the attention GRU step,
    expands with beam_search, and records (ids, parents) for the final
    backtrack."""
    hid, emb_dim = cfg["hid"], cfg["emb_dim"]
    beam, dmax, end_id = cfg["beam_size"], cfg["decode_max_len"], cfg["end_id"]
    prog, startup = Program(), Program()
    with unique_name.guard(), program_guard(prog, startup):
        src = layers.data("src", shape=[cfg["max_len"]], dtype="int64")
        src_len = layers.data("src_len", shape=[], dtype="int32")
        start_ids = layers.data("start_ids", shape=[], dtype="int64")
        init_scores = layers.data("init_scores", shape=[], dtype="float32")

        enc, enc_proj, boot = _encoder(src, src_len, cfg["src_dict_size"],
                                       emb_dim, hid)
        # tile encoder state over the beam dim: [B*W, ...]
        enc_t = _tile_beam(enc, beam)
        enc_proj_t = _tile_beam(enc_proj, beam)
        boot_t = _tile_beam(boot, beam)
        src_len_t = _tile_beam(src_len, beam)

        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = layers.fill_constant(shape=[1], dtype="int64", value=dmax)
        ids_hist = layers.fill_constant_batch_size_like(
            input=start_ids, shape=[dmax, 1], dtype="int64",
            value=end_id, input_dim_idx=0, output_dim_idx=1)
        par_hist = layers.fill_constant_batch_size_like(
            input=start_ids, shape=[dmax, 1], dtype="int32",
            value=0, input_dim_idx=0, output_dim_idx=1)
        pre_ids = start_ids
        pre_scores = init_scores
        h_state = boot_t

        cond = layers.less_than(x=i, y=limit)
        w = While(cond=cond)
        with w.block():
            emb = layers.embedding(pre_ids, size=[cfg["tgt_dict_size"],
                                                  emb_dim],
                                   param_attr="tgt_emb_w")
            ctx = _attention(h_state, enc_t, enc_proj_t, src_len_t, hid)
            h_new = _gru_step(emb, ctx, h_state, hid)
            logits = layers.fc(h_new, size=cfg["tgt_dict_size"],
                               param_attr="out_proj_w",
                               bias_attr="out_proj_b")
            probs = layers.softmax(logits)
            topk_scores, topk_ids = layers.topk(probs, k=beam)
            sel_ids, sel_scores, parent = layers.beam_search(
                pre_ids, pre_scores, topk_ids, topk_scores,
                beam_size=beam, end_id=end_id, is_accumulated=False)
            # reorder the recurrent state by parent pointer
            h_re = layers.gather(h_new, parent)
            layers.assign(h_re, h_state)
            layers.assign(sel_ids, pre_ids)
            layers.assign(sel_scores, pre_scores)
            layers.array_write(sel_ids, i, array=ids_hist)
            layers.array_write(parent, i, array=par_hist)
            layers.increment(i, value=1, in_place=True)
            layers.less_than(x=i, y=limit, cond=cond)

        sentences = layers.beam_search_decode(ids_hist, par_hist,
                                              end_id=end_id)
    # NOTE: no startup is exposed — the decode program runs against the
    # scope already holding the TRAINED parameters (same names by
    # unique_name.guard); running an init program here would overwrite
    # them with fresh random values.
    return {"program": prog, "fetch": [sentences],
            "sentences": sentences,
            "feeds": ["src", "src_len", "start_ids", "init_scores"]}


def _tile_beam(v, beam):
    """[B, ...] -> [B*beam, ...] repeating each row beam times."""
    exp = layers.unsqueeze(v, axes=[1])
    tiled = layers.expand(exp, expand_times=[1, beam] +
                          [1] * (len(v.shape) - 1))
    return layers.reshape(tiled, shape=[-1] + list(v.shape[1:]))


def make_fake_batch(batch_size, cfg, seed=0):
    rng = np.random.RandomState(seed)
    ml = cfg["max_len"]
    src = rng.randint(2, cfg["src_dict_size"], (batch_size, ml)).astype(
        np.int64)
    src_len = rng.randint(3, ml, (batch_size,)).astype(np.int32)
    tgt = rng.randint(2, cfg["tgt_dict_size"], (batch_size, ml)).astype(
        np.int64)
    tgt_next = np.roll(tgt, -1, axis=1)
    tgt_len = rng.randint(3, ml, (batch_size,)).astype(np.int32)
    return {"src": src, "src_len": src_len, "tgt": tgt,
            "tgt_next": tgt_next, "tgt_len": tgt_len}
