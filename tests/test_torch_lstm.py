"""The port's ``lstm`` op, the fused RNN and sequence ops and the four RNN
and sequence fusion passes, against the JAX package, on the CPU.

``lstm``: Hidden and Cell against the JAX op over every combination of
``Length``, ``is_reverse``, peepholes ([7H] bias) and H0/C0, in fp32
within 1e-5 of the output's largest magnitude (measured below 1e-6);
under AMP (fp32 input, the recurrent product on bf16 operands, as the
JAX op casts it) within one bf16 ulp of it, 2^-8. Its generic vjp
against ``jax.vjp`` of the JAX op, with cotangents on Hidden and Cell,
within 1e-5 of each gradient's largest magnitude. (The JAX op's
``lax.scan`` refuses a bf16 input under AMP, whose carry turns float32
at the bias; the port's loop takes it. ROADMAP C.)

The fused ops ``fusion_lstm``, ``fusion_gru``,
``fused_embedding_fc_lstm`` and ``fusion_seqpool_concat`` against the JAX
package's at 1e-5, and against the unfused ops they replace.

The passes: ``AnalysisConfig.DEFAULT_PASSES`` stage by stage (each pass's
op list equal to the JAX package's, and the tensors the passes fold into
the scope equal bit for bit) on the test programs of stacked_lstm,
understand_sentiment (both nets), recommender and deepfm and on the
machine-translation decode program; the same list without
``fc_fuse_pass``, where ``fc_lstm_fuse_pass`` and ``fc_gru_fuse_pass``
fire; and ``seqpool_concat_fuse_pass`` on a concat of sequence_pools.
``AnalysisPredictor`` serves JAX-written model directories of those
models with no pass raising, on the JAX predictor's op list, within 1e-5
of the JAX predictor's outputs.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import inference as jinference
from paddle_tpu import ir as jir
from paddle_tpu import registry as jreg
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference as pinference
from paddle_tpu_torch import ir as pir
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.models import machine_translation as pmt
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

from test_torch_ir import assert_same_ops, to_port
from test_torch_zoo import build_both

B, T, H = 3, 6, 4
TOL = 1e-5
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def _no_callstacks():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _lstm_ins(peep, length, h0c0, seed=0):
    rng = np.random.RandomState(seed)
    ins = {"Input": rng.randn(B, T, 4 * H).astype(np.float32),
           "Weight": (rng.randn(H, 4 * H) * 0.4).astype(np.float32),
           "Bias": (rng.randn(7 * H if peep else 4 * H) * 0.3).astype(
               np.float32)}
    if length:
        ins["Length"] = np.array([T, 2, 4], np.int32)
    if h0c0:
        ins["H0"] = (rng.randn(B, H) * 0.5).astype(np.float32)
        ins["C0"] = (rng.randn(B, H) * 0.5).astype(np.float32)
    return ins


def _attrs(peep, reverse):
    return {"use_peepholes": peep, "is_reverse": reverse,
            "gate_activation": "sigmoid", "cell_activation": "tanh",
            "candidate_activation": "tanh"}


def port_op(op_type, ins, attrs, amp=False):
    ctx = preg.EmitContext(torch.device("cpu"), amp=amp)
    outs = preg.lookup(op_type).emitter(
        ctx, {k: [torch.from_numpy(np.asarray(v)) if v is not None else None
                  for v in (vs if isinstance(vs, list) else [vs])]
              for k, vs in ins.items()}, attrs)
    return {k: v[0].float().numpy() for k, v in outs.items()}


def jax_op(op_type, ins, attrs, amp=False):
    ctx = jreg.EmitContext()
    ctx.amp = amp
    outs = jreg.lookup(op_type).emitter(
        ctx, {k: [jnp.asarray(v) if v is not None else None
                  for v in (vs if isinstance(vs, list) else [vs])]
              for k, vs in ins.items()}, attrs)
    return {k: np.asarray(v[0]).astype(np.float32) for k, v in outs.items()}


def _close(got, want, rel):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


LSTM_CASES = list(itertools.product([False, True], repeat=4))


@pytest.mark.parametrize("peep,reverse,length,h0c0", LSTM_CASES, ids=[
    "-".join(n for n, on in zip(("peep", "rev", "len", "h0c0"), c) if on)
    or "plain" for c in LSTM_CASES])
def test_lstm_matches_jax_fp32(peep, reverse, length, h0c0):
    ins, attrs = _lstm_ins(peep, length, h0c0), _attrs(peep, reverse)
    got, want = port_op("lstm", ins, attrs), jax_op("lstm", ins, attrs)
    for k in ("Hidden", "Cell"):
        _close(got[k], want[k], TOL)
    if length and not reverse:
        # row 1 (length 2) keeps its state past its length
        for k in ("Hidden", "Cell"):
            assert (got[k][1, 2:] == got[k][1, 1]).all()


@pytest.mark.parametrize("peep,reverse", list(itertools.product(
    [False, True], repeat=2)))
def test_lstm_matches_jax_amp(peep, reverse):
    ins, attrs = _lstm_ins(peep, True, True, seed=1), _attrs(peep, reverse)
    got = port_op("lstm", ins, attrs, amp=True)
    want = jax_op("lstm", ins, attrs, amp=True)
    fp32 = port_op("lstm", ins, attrs)
    for k in ("Hidden", "Cell"):
        _close(got[k], want[k], BF16_ULP)
        # the bf16 product moves the state off the fp32 run's
        assert not np.array_equal(got[k], fp32[k])


@pytest.mark.parametrize("peep,reverse", list(itertools.product(
    [False, True], repeat=2)))
def test_lstm_vjp_matches_jax(peep, reverse):
    ins, attrs = _lstm_ins(peep, True, True, seed=2), _attrs(peep, reverse)
    rng = np.random.RandomState(3)
    cot = {"Hidden": rng.randn(B, T, H).astype(np.float32),
           "Cell": rng.randn(B, T, H).astype(np.float32)}
    wrt = ["Input", "Weight", "Bias", "H0", "C0"]

    def f(*vals):
        full = {k: [jnp.asarray(v)] for k, v in ins.items()}
        for k, v in zip(wrt, vals):
            full[k] = [v]
        o = jreg.lookup("lstm").emitter(jreg.EmitContext(), full, attrs)
        return o["Hidden"][0], o["Cell"][0]

    _, vjp = jax.vjp(f, *(jnp.asarray(ins[k]) for k in wrt))
    want = dict(zip(wrt, vjp((jnp.asarray(cot["Hidden"]),
                              jnp.asarray(cot["Cell"])))))
    grad_ins = {k: [torch.from_numpy(v)] for k, v in ins.items()}
    for k, v in cot.items():
        grad_ins[k + "@GRAD"] = [torch.from_numpy(v)]
    grad_ins["BatchGate"] = grad_ins["BatchCellPreAct"] = [torch.zeros(0)]
    got = preg.generic_vjp_grad_emitter(
        preg.EmitContext(torch.device("cpu")), grad_ins,
        dict(attrs, __fwd_type__="lstm"))
    assert got["Length@GRAD"] == [None]
    for k in wrt:
        _close(got[k + "@GRAD"][0].numpy(), np.asarray(want[k]), TOL)


def test_lstm_registry_flags_match_jax():
    for t in ("lstm", "fusion_lstm", "fusion_gru", "fusion_seqpool_concat",
              "fused_embedding_fc_lstm", "auc", "log_loss", "cos_sim"):
        p, j = preg.lookup(t), jreg.lookup(t)
        assert (p.no_grad, p.intermediate_outputs) == \
            (j.no_grad, j.intermediate_outputs), t


# ---------------------------------------------------------------------------
# the fused ops
# ---------------------------------------------------------------------------

def _fused_case(op_type, seed=4):
    rng = np.random.RandomState(seed)
    m = 5
    length = np.array([T, 3, 1], np.int32)
    if op_type in ("fusion_lstm", "fusion_gru"):
        g = 4 if op_type == "fusion_lstm" else 3
        ins = {"X": rng.randn(B, T, m).astype(np.float32),
               "WeightX": (rng.randn(m, g * H) * 0.4).astype(np.float32),
               "WeightH": (rng.randn(H, g * H) * 0.4).astype(np.float32),
               "Bias": (rng.randn(g * H) * 0.2).astype(np.float32),
               "H0": (rng.randn(B, H) * 0.5).astype(np.float32),
               "Length": length}
        if op_type == "fusion_lstm":
            ins["C0"] = (rng.randn(B, H) * 0.5).astype(np.float32)
        attrs = {"is_reverse": True, "use_peepholes": False}
        return ins, attrs
    if op_type == "fused_embedding_fc_lstm":
        return ({"Ids": rng.randint(0, 7, (B, T, 1)).astype(np.int64),
                 "Embeddings": rng.randn(7, 4 * H).astype(np.float32),
                 "WeightH": (rng.randn(H, 4 * H) * 0.4).astype(np.float32),
                 "Bias": (rng.randn(7 * H) * 0.2).astype(np.float32),
                 "Length": length},
                {"use_peepholes": True, "is_reverse": False})
    return ({"X": [rng.randn(B, T, 3).astype(np.float32),
                   rng.randn(B, T, 2).astype(np.float32)],
             "Length": [length, np.array([2, 2, T], np.int32)]},
            {"pooltype": "SQRT", "axis": 1})


@pytest.mark.parametrize("op_type", ["fusion_lstm", "fusion_gru",
                                     "fused_embedding_fc_lstm",
                                     "fusion_seqpool_concat"])
def test_fused_op_matches_jax_and_the_unfused_ops(op_type):
    ins, attrs = _fused_case(op_type)
    got, want = port_op(op_type, ins, attrs), jax_op(op_type, ins, attrs)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], TOL)
    # the unfused ops the passes replace, in the port
    if op_type in ("fusion_lstm", "fusion_gru"):
        rnn = op_type.split("_")[1]
        proj = ins["X"] @ ins["WeightX"]
        sub = {"Input": proj, "Weight": ins["WeightH"], "Bias": ins["Bias"],
               "H0": ins["H0"], "Length": ins["Length"]}
        if rnn == "lstm":
            sub["C0"] = ins["C0"]
        ref = port_op(rnn, sub, attrs)
    elif op_type == "fused_embedding_fc_lstm":
        proj = ins["Embeddings"][ins["Ids"].reshape(B, T)]
        ref = port_op("lstm", {"Input": proj, "Weight": ins["WeightH"],
                               "Bias": ins["Bias"],
                               "Length": ins["Length"]}, attrs)
        ref["XX"] = proj
    else:
        pooled = [port_op("sequence_pool", {"X": x, "Length": n},
                          {"pooltype": "SQRT"})["Out"]
                  for x, n in zip(ins["X"], ins["Length"])]
        ref = {"Out": np.concatenate(pooled, axis=1)}
    for k in got:
        _close(got[k], ref[k], TOL)


# ---------------------------------------------------------------------------
# the passes, stage by stage
# ---------------------------------------------------------------------------

SMALL = {
    "stacked_lstm": dict(dict_size=100, emb_dim=8, lstm_size=8, max_len=10),
    "sentiment_lstm": dict(dict_size=100, emb_dim=8, hid_dim=8, max_len=10),
    "sentiment_conv": dict(dict_size=100, emb_dim=8, hid_dim=8, max_len=10),
    "recommender": {},
    "deepfm": dict(sparse_vocab=1000, num_fields=5, dense_dim=3,
                   embed_dim=4, fc_sizes=(16, 16)),
}
MT_TINY = dict(src_dict_size=40, tgt_dict_size=40, emb_dim=16, hid=16,
               max_len=8, beam_size=2, decode_max_len=5)
NO_FC_FUSE = [p for p in pinference.AnalysisConfig.DEFAULT_PASSES
              if p != "fc_fuse_pass"]


def _scopes(startup):
    """The JAX startup's values in a JAX scope and a port scope."""
    jscope = fluid.Scope()
    startup.random_seed = 7
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=jscope)
    pscope = pt.Scope()
    for n in jscope.var_names():
        pscope.set_var(n, torch.from_numpy(np.array(jscope.find_var(n))))
    return jscope, pscope


def _program(case):
    """(JAX program to rewrite, its fetches, JAX scope, port scope)."""
    if case == "mt_decode":
        with junique.guard():
            j = jmt.build(**MT_TINY)
        jscope, pscope = _scopes(j["startup"])
        return j["decode"]["program"], [j["decode"]["sentences"].name], \
            jscope, pscope
    j, _, _ = build_both(case, **SMALL[case])
    jscope, pscope = _scopes(j["startup"])
    return j["test"], [served_target(j).name], jscope, pscope


def _seqpool_concat_program():
    main, startup = fluid.Program(), fluid.Program()
    with junique.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6, 3], dtype="float32")
        y = fluid.layers.data("y", shape=[6, 2], dtype="float32")
        n = fluid.layers.data("n", shape=[], dtype="int32")
        pools = [fluid.layers.sequence_pool(v, "sum", length=n)
                 for v in (x, y)]
        out = fluid.layers.concat(pools, axis=1)
        z = fluid.layers.sequence_pool(x, "max", length=n)
        mixed = fluid.layers.concat([out, z], axis=1)
    return main, [mixed.name], fluid.Scope(), pt.Scope()


PASS_CASES = {
    **{f"{c}-default": (c, "default") for c in list(SMALL) + ["mt_decode"]},
    "stacked_lstm-no_fc_fuse": ("stacked_lstm", "no_fc_fuse"),
    "sentiment_lstm-no_fc_fuse": ("sentiment_lstm", "no_fc_fuse"),
    "mt_decode-no_fc_fuse": ("mt_decode", "no_fc_fuse"),
    "seqpool_concat": ("seqpool_concat", "default"),
}
FIRES = {
    "stacked_lstm-default": {"fused_embedding_fc_lstm"},
    "stacked_lstm-no_fc_fuse": {"fused_embedding_fc_lstm", "fusion_lstm"},
    "mt_decode-no_fc_fuse": {"fusion_gru"},
    "deepfm-default": {"fusion_repeated_fc_relu"},
    "seqpool_concat": {"fusion_seqpool_concat"},
}


@pytest.mark.parametrize("name", sorted(PASS_CASES))
def test_analysis_passes_stage_by_stage_match_jax(name):
    case, which = PASS_CASES[name]
    if case == "seqpool_concat":
        jprog, fetch, jscope, pscope = _seqpool_concat_program()
    else:
        jprog, fetch, jscope, pscope = _program(case)
    jprog = jprog.clone()
    pprog = to_port(jprog)
    passes = (list(pinference.AnalysisConfig.DEFAULT_PASSES)
              if which == "default" else NO_FC_FUSE)
    before = set(pscope.var_names())
    for p in passes:
        jir.apply_passes(jprog, [p], scope=jscope, protected=fetch)
        pir.apply_passes(pprog, [p], scope=pscope, protected=fetch)
        assert_same_ops(list(jprog.global_block().desc.ops),
                        list(pprog.global_block().desc.ops))
    assert sorted(pprog.global_block().desc.vars) == \
        sorted(jprog.global_block().desc.vars)
    types = {o.type for o in pprog.global_block().desc.ops}
    assert FIRES.get(name, set()) <= types
    # every value a pass folded into the scope (new or rewritten), bitwise
    for n in set(pscope.var_names()) | before:
        want = np.asarray(jscope.find_var(n))
        got = pscope.find_var(n).numpy()
        assert got.dtype == want.dtype or want.dtype == np.int32, n
        np.testing.assert_array_equal(got, want.astype(got.dtype), n)


# ---------------------------------------------------------------------------
# AnalysisPredictor on JAX-written model directories
# ---------------------------------------------------------------------------

def served_target(j):
    """The model's prediction: ``predict``, or for stacked_lstm (which
    returns none) the softmax its accuracy reads."""
    if "predict" in j:
        return j["predict"]
    sm = [o for o in j["test"].global_block().desc.ops if o.type == "softmax"]
    return j["test"].global_block().var(sm[-1].output("Out")[0])


def _feed(case, pm):
    if case == "deepfm":
        return pm.make_fake_batch(6, {"sparse_vocab": 1000, "num_fields": 5,
                                      "dense_dim": 3}, seed=2)
    if case == "recommender":
        return pm.make_fake_batch(5, seed=2)
    return pm.make_fake_batch(4, 100, 10, seed=2)


SERVE = [("stacked_lstm", "default"), ("stacked_lstm", "no_fc_fuse"),
         ("sentiment_lstm", "default"), ("sentiment_conv", "default"),
         ("recommender", "default"), ("deepfm", "default")]


@pytest.mark.parametrize("case,which", SERVE,
                         ids=[f"{c}-{w}" for c, w in SERVE])
def test_analysis_predictor_serves_the_jax_model(case, which, tmp_path):
    j, _, pm = build_both(case, **SMALL[case])
    predict = served_target(j)
    feeds = [f for f in j["feeds"] if f not in ("label", "click", "score")]
    d = str(tmp_path / case)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    j["startup"].random_seed = 7
    with fluid.scope_guard(scope):
        exe.run(j["startup"])
        fluid.io.save_inference_model(d, feeds, [predict], exe,
                                      main_program=j["test"],
                                      export_for_deployment=False)
    feed = {k: v for k, v in _feed(case, pm).items() if k in feeds}
    jcfg, pcfg = (jinference.AnalysisConfig(d),
                  pinference.AnalysisConfig(d, use_gpu=False))
    if which == "no_fc_fuse":
        jcfg.pass_builder_set(NO_FC_FUSE)
        pcfg.pass_builder_set(NO_FC_FUSE)
    jpred = jinference.create_paddle_predictor(jcfg)
    ppred = pinference.create_paddle_predictor(pcfg)
    assert isinstance(ppred, pinference.AnalysisPredictor)
    ops = list(ppred._program.global_block().desc.ops)
    assert_same_ops(list(jpred._program.global_block().desc.ops), ops)
    want = np.asarray(jpred.run(feed)[0].data)
    got = ppred.run(feed)[0].as_ndarray()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    native = pinference.create_paddle_predictor(
        pinference.NativeConfig(d, use_gpu=False)).run(feed)[0].as_ndarray()
    np.testing.assert_allclose(got, native, rtol=0, atol=1e-5)
