"""Structured prediction in the port against the JAX package, on the CPU.

- **Ops.** ``linear_chain_crf`` (with and without Length, a row of
  length 1 and one of length 0) within 1e-6 of the JAX op's values, its
  generic vjp within 1e-5 of each gradient's largest magnitude;
  ``crf_decoding`` paths and its Label mode equal; a Viterbi tie taking
  the first maximum in both packages; ``chunk_eval``'s counts equal under
  every scheme; ``length_or_full``.
- **The dataset.** ``dataset.conll05``'s rows equal the JAX package's
  for the same seeds.
- **label_semantic_roles.** ``build()``'s main, startup and test programs
  byte-identical at the book's widths and at max_len 12, word_dim 8,
  hidden 16, depth 2; at the small widths 6 SGD steps from the JAX
  startup's parameters (losses within 1e-5 relative, every parameter
  within 1e-4 of the largest magnitude) and the test program's Viterbi
  paths equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.dataset import conll05 as jconll05
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.models import label_semantic_roles as jsrl
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.dataset import conll05 as pconll05
from paddle_tpu_torch.models import label_semantic_roles as psrl
from paddle_tpu_torch.ops.common import length_or_full
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

FWD_TOL = 1e-6
GRAD_REL = 1e-5
LOSS_REL = 1e-5
PARAM_REL = 1e-4
SRL_SMALL = dict(max_len=12, word_dim=8, hidden_dim=16, depth=2)
B, T, N = 4, 7, 5


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _run_both(op_type, ins, attrs):
    jouts = jreg.lookup(op_type).emitter(
        jreg.EmitContext(), {s: [jnp.asarray(a) for a in v]
                             for s, v in ins.items()}, attrs)
    pouts = preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu")),
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}, attrs)
    return ({s: [np.asarray(v) for v in vs] for s, vs in jouts.items()},
            {s: [v.numpy() for v in vs] for s, vs in pouts.items()})


def _crf_ins(with_length, seed=0):
    rng = np.random.RandomState(seed)
    ins = {"Emission": [rng.randn(B, T, N).astype(np.float32) * 0.5],
           "Transition": [rng.randn(N + 2, N).astype(np.float32) * 0.3],
           "Label": [rng.randint(0, N, (B, T)).astype(np.int64)]}
    if with_length:
        ins["Length"] = [np.array([7, 3, 1, 0], np.int32)]
    return ins


@pytest.mark.parametrize("with_length", [False, True],
                         ids=["full", "length"])
def test_linear_chain_crf_matches_jax(with_length):
    ins = _crf_ins(with_length)
    j, p = _run_both("linear_chain_crf", ins, {})
    assert sorted(p) == sorted(j)
    for slot in j:
        assert p[slot][0].shape == j[slot][0].shape, slot
        np.testing.assert_allclose(p[slot][0], j[slot][0], rtol=0,
                                   atol=FWD_TOL, err_msg=slot)
    assert p["LogLikelihood"][0].shape == (B, 1)
    # logZ is at least any one path's score
    assert (p["LogLikelihood"][0] >= 0).all()


@pytest.mark.parametrize("with_length", [False, True],
                         ids=["full", "length"])
def test_linear_chain_crf_grad_matches_jax(with_length):
    """The generic vjp of both packages (Alpha is an intermediate output,
    handed to the grad op as the forward made it)."""
    ins = _crf_ins(with_length, seed=1)
    fwd, _ = _run_both("linear_chain_crf", ins, {})
    rng = np.random.RandomState(2)
    gins = dict(ins, Alpha=fwd["Alpha"])
    gins["LogLikelihood@GRAD"] = [rng.randn(B, 1).astype(np.float32)]
    attrs = {"__fwd_type__": "linear_chain_crf"}
    jouts = jreg.generic_vjp_grad_emitter(
        jreg.EmitContext(), {s: [jnp.asarray(a) for a in v]
                             for s, v in gins.items()}, attrs)
    pouts = preg.generic_vjp_grad_emitter(
        preg.EmitContext(torch.device("cpu")),
        {s: [torch.from_numpy(a) for a in v] for s, v in gins.items()},
        attrs)
    for slot in ("Emission@GRAD", "Transition@GRAD"):
        want = np.asarray(jouts[slot][0])
        np.testing.assert_allclose(pouts[slot][0].numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max(),
                                   err_msg=slot)
    assert pouts["Label@GRAD"][0] is None
    if with_length:
        # no gradient past a row's length; step 0 always counts (a row of
        # length 0 scores its first step, in both packages)
        g = pouts["Emission@GRAD"][0].numpy()
        assert not g[1, 3:].any() and not g[3, 1:].any()
        assert g[3, 0].any()


@pytest.mark.parametrize("mode", ["path", "path_length", "label"])
def test_crf_decoding_matches_jax(mode):
    ins = _crf_ins(mode != "path", seed=3)
    ins = {k: v for k, v in ins.items() if k != "Label" or mode == "label"}
    j, p = _run_both("crf_decoding", ins, {})
    got = p["ViterbiPath"][0]
    assert got.dtype == np.int64 and got.shape == (B, T)
    assert got.tolist() == j["ViterbiPath"][0].astype(np.int64).tolist()
    if mode != "path":
        assert not got[2, 1:].any() and not got[3].any()
    if mode == "label":
        assert set(np.unique(got)) <= {0, 1}


def _numpy_viterbi(em, trans, length):
    """A float64 Viterbi of one row, first maximum on a tie."""
    start, end, w = trans[0], trans[1], trans[2:]
    alpha = start + em[0]
    bps = []
    for t in range(1, length):
        scores = alpha[:, None] + w
        bps.append(scores.argmax(axis=0))
        alpha = scores.max(axis=0) + em[t]
    tag = int(np.argmax(alpha + end))
    path = [tag]
    for bp in reversed(bps):
        tag = int(bp[tag])
        path.append(tag)
    return path[::-1]


def test_viterbi_ties_take_the_first_maximum():
    """Integer-valued emissions and transitions, so several tags tie
    exactly at every step: both packages take the first maximum
    (``jnp.argmax``'s rule, ``torch.max``'s too), as a float64 numpy
    Viterbi does."""
    rng = np.random.RandomState(4)
    em = rng.randint(0, 2, (B, T, N)).astype(np.float32)
    trans = rng.randint(0, 2, (N + 2, N)).astype(np.float32)
    length = np.array([7, 5, 2, 1], np.int32)
    ins = {"Emission": [em], "Transition": [trans], "Length": [length]}
    j, p = _run_both("crf_decoding", ins, {})
    got = p["ViterbiPath"][0]
    assert got.tolist() == j["ViterbiPath"][0].astype(np.int64).tolist()
    for r in range(B):
        want = _numpy_viterbi(em[r].astype(np.float64),
                              trans.astype(np.float64), int(length[r]))
        assert got[r, :length[r]].tolist() == want
        assert not got[r, length[r]:].any()


@pytest.mark.parametrize("scheme,num_types", [("IOB", 3), ("IOE", 3),
                                              ("IOBES", 2), ("plain", 4)])
def test_chunk_eval_matches_jax(scheme, num_types):
    rng = np.random.RandomState(5)
    n_tags = num_types * {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[
        scheme] + 1
    label = rng.randint(0, n_tags, (6, 12)).astype(np.int64)
    inference = label.copy()
    flip = rng.rand(6, 12) < 0.3
    inference[flip] = rng.randint(0, n_tags, flip.sum())
    ins = {"Inference": [inference], "Label": [label],
           "Length": [np.array([12, 9, 5, 1, 0, 12], np.int64)]}
    attrs = {"chunk_scheme": scheme, "num_chunk_types": num_types,
             "excluded_chunk_types": [1]}
    j, p = _run_both("chunk_eval", ins, attrs)
    assert sorted(p) == sorted(j)
    for slot in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"):
        assert int(p[slot][0]) == int(j[slot][0]), slot
    assert int(p["NumLabelChunks"][0]) > 0
    for slot in ("Precision", "Recall", "F1-Score"):
        assert p[slot][0].dtype == np.float32
        assert float(p[slot][0]) == float(j[slot][0]), slot
    assert preg.lookup("chunk_eval").is_host


def test_length_or_full():
    full = length_or_full({}, 3, 7, torch.device("cpu"))
    assert full.dtype == torch.int32 and full.tolist() == [7, 7, 7]
    given = length_or_full({"Length": [torch.tensor([[2], [5]])]}, 2, 7,
                           torch.device("cpu"))
    assert given.dtype == torch.int32 and given.tolist() == [2, 5]


def test_conll05_rows_equal_jax():
    for split in ("train", "test"):
        want = list(getattr(jconll05, split)()())
        got = list(getattr(pconll05, split)()())
        assert len(got) == len(want) and got == want
    assert (pconll05.WORD_VOCAB, pconll05.PRED_VOCAB,
            pconll05.LABEL_COUNT) == (jconll05.WORD_VOCAB,
                                      jconll05.PRED_VOCAB,
                                      jconll05.LABEL_COUNT)
    assert pconll05.get_dict() == jconll05.get_dict()


# ---------------------------------------------------------------------------
# label_semantic_roles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["small", "book"])
def srl_builds(request):
    kw = SRL_SMALL if request.param == "small" else {}
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        with junique.guard():
            j = jsrl.build(**kw)
        with punique.guard():
            p = psrl.build(**kw)
        return j, p
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old


@pytest.mark.parametrize("which", ["main", "startup", "test"])
def test_srl_programs_byte_identical(srl_builds, which):
    j, p = srl_builds
    assert p[which].desc.to_bytes() == j[which].desc.to_bytes()
    types = {o.type for o in p[which].global_block().ops}
    if which == "main":
        assert {"linear_chain_crf", "linear_chain_crf_grad", "sum",
                "lstm", "sgd"} <= types
    if which == "test":
        assert "crf_decoding" in types


def test_srl_trains_and_decodes_against_jax():
    with junique.guard():
        j = jsrl.build(**SRL_SMALL)
    with punique.guard():
        p = psrl.build(**SRL_SMALL)
    rows = list(pconll05.train()())[:6]
    feed = psrl.make_batch(rows, SRL_SMALL["max_len"])
    jfeed = jsrl.make_batch(rows, SRL_SMALL["max_len"])
    assert all(np.array_equal(feed[k], jfeed[k]) for k in jfeed)
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    j["startup"].random_seed = 5
    jexe.run(j["startup"], scope=js)
    names = [v.name for v in p["startup"].list_vars() if v.persistable]
    ps = pt.Scope()
    pt.io.set_params_from_numpy(
        ps, {n: np.asarray(js.find_var(n)) for n in names}, "cpu",
        program=p["startup"])
    pexe = pt.Executor(pt.CPUPlace())
    emb0 = ps.find_var("emb").clone()
    losses = []
    for _ in range(6):
        (jl,) = jexe.run(j["main"], feed=feed, fetch_list=[j["loss"]],
                         scope=js)
        (pl,) = pexe.run(p["main"], feed=feed, fetch_list=[p["loss"]],
                         scope=ps)
        losses.append((float(np.asarray(jl).reshape(-1)[0]),
                       float(pl.reshape(-1)[0])))
    for jl, pl in losses:
        assert abs(pl - jl) <= LOSS_REL * abs(jl), losses
    assert losses[-1][1] < losses[0][1]
    diff = top = 0.0
    for n in names:
        a = np.asarray(js.find_var(n))
        if a.dtype.kind == "f":
            diff = max(diff, float(np.abs(ps.find_var(n).numpy() - a).max()))
            top = max(top, float(np.abs(a).max()))
    assert diff <= PARAM_REL * top, (diff, top)
    # the word embedding is not trainable
    assert torch.equal(ps.find_var("emb"), emb0)
    (jd,) = jexe.run(j["test"], feed=feed, fetch_list=[j["decode"]],
                     scope=js)
    (pd,) = pexe.run(p["test"], feed=feed, fetch_list=[p["decode"]],
                     scope=ps)
    assert pd.dtype == np.int64
    assert pd.tolist() == np.asarray(jd).astype(np.int64).tolist()
    mask = np.arange(SRL_SMALL["max_len"])[None] >= feed["length"][:, None]
    assert not pd[mask].any()
