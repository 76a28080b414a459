"""CTC in the port against the JAX package, on the CPU.

- **Ops.** ``warpctc`` (with and without ``norm_by_times``, an empty
  label, repeated labels, logit lengths shorter than T) within FWD_REL of
  the JAX op's losses and its generic vjp within GRAD_REL of each
  gradient's largest magnitude; ``ctc_align``'s outputs equal;
  ``edit_distance`` bitwise the JAX op's (the anti-diagonal walk against
  the JAX row scan), with a reference of length 0 and hypotheses longer
  than their references, normalised and not, and against a numpy
  Levenshtein.
- **The JAX OpTests.** The data tests/test_ops_crf_ctc.py's OpTest
  classes state, through the port's emitters at each class's tolerance.
- **CRNN-CTC.** ``testing.models.crnn_ctc``'s main, startup and test
  programs byte-identical at the full width (Fluid's ocr_recognition:
  [1, 48, 512] images, 16/32/64/128 filters, GRU 200, 96 classes) and at
  a small one; at the small width (a [1, 16, 64] image, filters 4/8, GRU
  8) 6 Momentum steps from the JAX startup's parameters (losses within
  LOSS_REL relative, parameters within PARAM_REL of the largest
  magnitude), then the test program's decoded rows, their lengths and
  the edit distances equal to the JAX package's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.ops.kernels_crf import edit_distance_fn
from paddle_tpu_torch.testing import models as tmodels
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

import test_ops_crf_ctc as jctc
from test_torch_sequence import (_vjp_both, assert_outputs_match,
                                 run_both, run_optest_on_port)

FWD_REL = 1e-5
GRAD_REL = 1e-5
LOSS_REL = 1e-5
PARAM_REL = 1e-4
CRNN_SMALL = dict(image=(1, 16, 64), filters=(4, 8), hidden=8, classes=10,
                  max_label=6)


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _ctc_ins(seed, b=4, t=9, c=6, n_lab=4, blank=0, label=None,
             label_len=None, logit_len=None):
    rng = np.random.RandomState(seed)
    ins = {"Logits": [rng.randn(b, t, c).astype(np.float32) * 2]}
    if label is None:
        ids = [i for i in range(c) if i != blank]
        label = rng.choice(ids, size=(b, n_lab)).astype(np.int64)
    ins["Label"] = [np.asarray(label, np.int64)]
    if label_len is not None:
        ins["LabelLength"] = [np.asarray(label_len, np.int64)]
    if logit_len is not None:
        ins["LogitsLength"] = [np.asarray(logit_len, np.int64)]
    return ins


WARPCTC_CASES = [
    ("plain", _ctc_ins(0), {"blank": 0}),
    ("norm_by_times", _ctc_ins(1, logit_len=[9, 7, 5, 2],
                               label_len=[4, 3, 1, 2]),
     {"blank": 0, "norm_by_times": True}),
    ("empty_label", _ctc_ins(2, label_len=[4, 0, 2, 0],
                             logit_len=[9, 3, 6, 1]), {"blank": 0}),
    ("repeats", _ctc_ins(3, label=[[1, 1, 2, 2], [3, 3, 3, 1],
                                   [2, 1, 2, 1], [4, 4, 1, 1]],
                         label_len=[4, 3, 4, 2]), {"blank": 0}),
    ("last_blank", _ctc_ins(4, blank=5, label_len=[4, 2, 1, 3]),
     {"blank": 5, "norm_by_times": True}),
]


@pytest.mark.parametrize("case", WARPCTC_CASES,
                         ids=[c[0] for c in WARPCTC_CASES])
def test_warpctc_matches_jax(case):
    _, ins, attrs = case
    j, p = run_both("warpctc", ins, attrs)
    assert p["Loss"][0].shape == (4, 1)
    assert np.isfinite(p["Loss"][0]).all()
    assert_outputs_match(j, p, rel=FWD_REL)


@pytest.mark.parametrize("case", WARPCTC_CASES,
                         ids=[c[0] for c in WARPCTC_CASES])
def test_warpctc_vjp_matches_jax(case):
    _, ins, attrs = case
    jouts, pouts = _vjp_both("warpctc", ins, attrs, seed=7)
    want = np.asarray(jouts["Logits@GRAD"][0])
    got = pouts["Logits@GRAD"][0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_REL * np.abs(want).max())
    assert pouts["Label@GRAD"][0] is None


def test_warpctc_without_norm_matches_torch_ctc_loss():
    """The loss is -log p(label): F.ctc_loss's value (a yardstick only)."""
    ins, attrs = WARPCTC_CASES[1][1], {"blank": 0}
    _, p = run_both("warpctc", ins, attrs)
    lp = torch.log_softmax(torch.from_numpy(ins["Logits"][0]), dim=-1)
    want = torch.nn.functional.ctc_loss(
        lp.transpose(0, 1), torch.from_numpy(ins["Label"][0]),
        torch.from_numpy(ins["LogitsLength"][0]),
        torch.from_numpy(ins["LabelLength"][0]), blank=0,
        reduction="none").numpy()
    np.testing.assert_allclose(p["Loss"][0].reshape(-1), want, rtol=1e-5)


ALIGN_CASES = [
    ("length", {"Input": [np.random.RandomState(5).randint(
        0, 4, (5, 12)).astype(np.int64)],
        "Length": [np.array([12, 7, 1, 0, 5], np.int64)]}, {"blank": 0}),
    ("full_blank3", {"Input": [np.random.RandomState(6).randint(
        0, 4, (3, 10)).astype(np.int64)]}, {"blank": 3}),
]


@pytest.mark.parametrize("case", ALIGN_CASES, ids=[c[0] for c in ALIGN_CASES])
def test_ctc_align_matches_jax(case):
    _, ins, attrs = case
    j, p = run_both("ctc_align", ins, attrs)
    assert_outputs_match(j, p)


def _levenshtein(a, b):
    d = np.arange(len(b) + 1)
    for i, ca in enumerate(a):
        new = np.empty_like(d)
        new[0] = i + 1
        for k, cb in enumerate(b):
            new[k + 1] = min(d[k + 1] + 1, new[k] + 1, d[k] + (ca != cb))
        d = new
    return d[-1]


EDIT_CASES = [
    ("lengths", 6, 5, [6, 3, 0, 2, 6], [5, 0, 4, 5, 1], True),
    ("lengths_raw", 6, 5, [6, 3, 0, 2, 6], [5, 0, 4, 5, 1], False),
    ("longer_hyp", 9, 3, None, None, False),
    ("longer_ref", 3, 8, [3, 1, 2, 0, 3], None, True),
]


@pytest.mark.parametrize("case", EDIT_CASES, ids=[c[0] for c in EDIT_CASES])
def test_edit_distance_bitwise_jax(case):
    _, t1, t2, hl, rl, normalized = case
    rng = np.random.RandomState(t1 * 10 + t2)
    ins = {"Hyps": [rng.randint(0, 4, (5, t1)).astype(np.int64)],
           "Refs": [rng.randint(0, 4, (5, t2)).astype(np.int64)]}
    if hl is not None:
        ins["HypsLength"] = [np.array(hl, np.int64)]
    if rl is not None:
        ins["RefsLength"] = [np.array(rl, np.int64)]
    attrs = {"normalized": normalized}
    j, p = run_both("edit_distance", ins, attrs)
    got = p["Out"][0]
    assert got.dtype == np.float32 and got.shape == (5, 1)
    assert got.tobytes() == j["Out"][0].tobytes()
    assert int(p["SequenceNum"][0]) == 5
    hl = hl if hl is not None else [t1] * 5
    rl = rl if rl is not None else [t2] * 5
    want = np.array([_levenshtein(ins["Hyps"][0][r, :hl[r]],
                                  ins["Refs"][0][r, :rl[r]])
                     for r in range(5)], np.float32)
    if normalized:
        want = want / np.maximum(np.array(rl, np.float32), 1)
    assert got.reshape(-1).tolist() == want.tolist()


def test_edit_distance_fn_larger_random():
    """The anti-diagonal walk against numpy over many random rows."""
    rng = np.random.RandomState(11)
    hyp = rng.randint(0, 3, (40, 13))
    ref = rng.randint(0, 3, (40, 17))
    hl = rng.randint(0, 14, 40)
    rl = rng.randint(0, 18, 40)
    got = edit_distance_fn(torch.from_numpy(hyp), torch.from_numpy(ref),
                           torch.from_numpy(hl), torch.from_numpy(rl))
    want = [_levenshtein(hyp[r, :hl[r]], ref[r, :rl[r]]) for r in range(40)]
    assert got.tolist() == [float(w) for w in want]


def test_ctc_types_registered_like_jax():
    for t in ("warpctc", "ctc_align", "edit_distance"):
        assert preg.lookup(t).no_grad == jreg.lookup(t).no_grad, t


OPTESTS = sorted(n for n in dir(jctc)
                 if n.startswith("Test") and hasattr(getattr(jctc, n),
                                                     "op_type"))
OPTEST_TOL = {"TestWarpCTCAgainstTorch": 1e-4}


@pytest.mark.parametrize("name", OPTESTS)
def test_jax_optest_data_through_port(name):
    run_optest_on_port(getattr(jctc, name), OPTEST_TOL.get(name, 1e-5))


# ---------------------------------------------------------------------------
# CRNN-CTC
# ---------------------------------------------------------------------------

def _builds(**kw):
    with junique.guard():
        j = tmodels.crnn_ctc(fluid, **kw)
    with punique.guard():
        p = tmodels.crnn_ctc(pt, **kw)
    return j, p


@pytest.mark.parametrize("width", ["full", "small"])
def test_crnn_programs_byte_identical(width):
    j, p = _builds(**({} if width == "full" else CRNN_SMALL))
    for which in ("main", "startup", "test"):
        assert p[which].desc.to_bytes() == j[which].desc.to_bytes(), which
    types = [o.type for o in p["main"].global_block().ops]
    assert {"im2sequence", "gru", "warpctc", "warpctc_grad", "momentum",
            "batch_norm"} <= set(types)
    test_types = {o.type for o in p["test"].global_block().ops}
    assert {"ctc_align", "edit_distance", "top_k"} <= test_types
    if width == "full":
        # T = 512 / 16 = 32 steps of 128 x 3 = 384 features
        seq = next(o for o in p["main"].global_block().ops
                   if o.type == "reshape2")
        assert list(p["main"].global_block().var(
            seq.output("Out")[0]).shape) == [-1, 32, 384]


def test_crnn_trains_against_jax():
    j, p = _builds(**CRNN_SMALL)
    cfg = p["config"]
    feed = tmodels.crnn_batch(4, cfg["image"], cfg["classes"],
                              cfg["max_label"], seed=3)
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(j["startup"], scope=js)
    names = [v.name for v in p["startup"].list_vars() if v.persistable]
    ps = pt.Scope()
    pt.io.set_params_from_numpy(
        ps, {n: np.asarray(js.find_var(n)) for n in names}, "cpu",
        program=p["startup"])
    pexe = pt.Executor(pt.CPUPlace())
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
    fetch = [p["decoded"].name, p["decoded_length"].name,
             p["distance"].name]
    jr = jexe.run(j["test"], feed=feed, fetch_list=fetch, scope=js)
    pr = pexe.run(p["test"], feed=feed, fetch_list=fetch, scope=ps)
    for name, a, b in zip(fetch, jr, pr):
        assert b.tolist() == np.asarray(a).tolist(), name
    dec, dec_len, dist = pr
    assert dec.dtype == np.int64 and dec_len.dtype == np.int64
    want = [_levenshtein(dec[r, :dec_len[r]],
                         feed["label"][r, :feed["label_length"][r]])
            for r in range(4)]
    assert dist.reshape(-1).tolist() == [float(w) for w in want]
