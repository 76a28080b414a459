"""The loss, ranking and sampled-softmax ops and the RNN cells of the port
against the JAX package, on the CPU.

- **Ops.** The 15 types of ``paddle_tpu/ops/kernels_loss.py`` and the 3
  of ``kernels_rnn.py`` this slice adds run through both packages'
  emitters on the same numpy-seeded inputs: float outputs within FWD_REL
  of each output's largest magnitude, integer ones equal. Each gradful
  type's generic vjp on the same cotangents within GRAD_REL of each
  gradient's largest magnitude.
- **nce.** The negatives come from different streams (ROADMAP C "RNG"),
  so the port's forward is held by its own SampleLabels: the first
  column the label, the rest in [0, C); the cost and SampleLogits equal a
  numpy NCE cost of those samples within FWD_REL. ``nce_grad`` of both
  packages on the port's SampleLabels agree within GRAD_REL (the backward
  never draws), and against a float64 finite difference. Under
  ``is_test`` both score the full softmax and agree.
- **positive_negative_pair**, a host op: equal to the JAX op's counts,
  with and without its accumulators, and to a pair-by-pair recount.
- **The JAX OpTests** of tests/test_ops_loss.py and
  tests/test_ops_rnn_units.py for these types, through the port.
"""

import numpy as np
import pytest
import torch

import test_ops_loss as jloss
import test_ops_rnn_units as jrnn
from paddle_tpu import registry as jreg

from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.ops.kernels_loss import count_pairs

from test_torch_sequence import run_optest_on_port
from test_torch_tensor_ops import (FWD_REL, GRAD_REL, NEW_LOSS, NEW_RNN,
                                   _f, _jins, _pins, _rng, assert_close,
                                   assert_outputs_match, assert_vjp_match,
                                   run_both)

B, D = 6, 5


def _labels01(seed, n=B):
    return _rng(seed).randint(0, 2, (n, 1)).astype(np.float32)


CASES = [
    ("hinge", "hinge_loss", {"Logits": [_f(1, B, 1)], "Labels":
                             [_labels01(2)]}, {}, True),
    ("rank", "rank_loss", {"Label": [_labels01(3)], "Left": [_f(4, B, 1)],
                           "Right": [_f(5, B, 1)]}, {}, True),
    ("margin_rank", "margin_rank_loss",
     {"Label": [np.sign(_f(6, B, 1))], "X1": [_f(7, B, 1)],
      "X2": [_f(8, B, 1)]}, {"margin": 0.3}, True),
    ("bpr", "bpr_loss", {"X": [_f(9, B, 7)], "Label": [
        _rng(10).randint(0, 7, (B, 1)).astype(np.int64)]}, {}, True),
    ("modified_huber", "modified_huber_loss",
     {"X": [np.linspace(-3, 3, 12, dtype=np.float32).reshape(12, 1)],
      "Y": [_labels01(11, 12)]}, {}, True),
    ("teacher_student", "teacher_student_sigmoid_loss",
     {"X": [_f(12, 8, 1)], "Label": [np.array(
         [[-2.0], [-1.0], [0.0], [0.3], [0.99], [1.0], [1.5], [2.0]],
         np.float32)]}, {}, True),
    ("squared_l2_distance", "squared_l2_distance",
     {"X": [_f(13, B, D)], "Y": [_f(14, B, D)]}, {}, True),
    ("squared_l2_distance_row", "squared_l2_distance",
     {"X": [_f(15, B, D)], "Y": [_f(16, 1, D)]}, {}, True),
    ("squared_l2_norm", "squared_l2_norm", {"X": [_f(17, B, D)]}, {}, True),
    ("l1_norm_zeros", "l1_norm",
     {"X": [np.array([[0.0, -0.0, 1.5], [-2.0, 0.0, 3.0]], np.float32)]},
     {}, True),
    ("minus", "minus", {"X": [_f(18, B, D)], "Y": [_f(19, B, D)]}, {},
     True),
    ("hsigmoid", "hierarchical_sigmoid",
     {"X": [_f(20, B, D)], "Label": [np.array([[0], [9], [3], [4], [8], [5]],
                                              np.int64)],
      "W": [_f(21, 9, D)], "Bias": [_f(22, 9, 1)]}, {"num_classes": 10},
     True),
    ("hsigmoid_nobias", "hierarchical_sigmoid",
     {"X": [_f(23, B, D)], "Label": [np.array([[0], [6], [2], [1], [5], [4]],
                                              np.int64)],
      "W": [_f(24, 6, D)]}, {"num_classes": 7}, True),
    ("hsigmoid_2073", "hierarchical_sigmoid",
     {"X": [_f(25, 16, 32)], "Label": [
         _rng(26).randint(0, 2073, (16, 1)).astype(np.int64)],
      "W": [_f(27, 2072, 32) * 0.1], "Bias": [_f(28, 2072, 1)]},
     {"num_classes": 2073}, True),
    ("label_smooth", "label_smooth", {"X": [np.eye(8, dtype=np.float32)[
        _rng(29).randint(0, 8, 5)]]}, {"epsilon": 0.1}, True),
    ("label_smooth_prior", "label_smooth",
     {"X": [_f(30, 5, 8)], "PriorDist": [np.full((1, 8), 0.125, np.float32)]},
     {"epsilon": 0.2}, True),
    ("lstm_unit", "lstm_unit", {"X": [_f(31, B, 4 * D)],
                                "C_prev": [_f(32, B, D)]},
     {"forget_bias": 1.0}, True),
    ("gru_unit", "gru_unit",
     {"Input": [_f(33, B, 3 * D)], "HiddenPrev": [_f(34, B, D)],
      "Weight": [_f(35, D, 3 * D) * 0.5], "Bias": [_f(36, 1, 3 * D)]},
     {"origin_mode": False}, True),
    ("gru_unit_origin", "gru_unit",
     {"Input": [_f(37, B, 3 * D)], "HiddenPrev": [_f(38, B, D)],
      "Weight": [_f(39, D, 3 * D) * 0.5]}, {"origin_mode": True}, True),
    ("lstmp", "lstmp",
     {"Input": [_f(40, 3, 6, 4 * D)], "Weight": [_f(41, 3, 4 * D) * 0.5],
      "ProjWeight": [_f(42, D, 3) * 0.5], "Bias": [_f(43, 4 * D)]},
     {"use_peepholes": False}, True),
    ("lstmp_lengths", "lstmp",
     {"Input": [_f(44, 4, 6, 4 * D)], "Weight": [_f(45, 3, 4 * D) * 0.5],
      "ProjWeight": [_f(46, D, 3) * 0.5], "Bias": [_f(47, 7 * D)],
      "Length": [np.array([6, 0, 3, 1], np.int64)]},
     {"use_peepholes": True}, True),
]

# nce, nce_grad and positive_negative_pair have tests of their own
COVERED_APART = {"nce", "nce_grad", "positive_negative_pair"}


def test_cases_cover_the_loss_and_rnn_types():
    assert {c[1] for c in CASES} | COVERED_APART == set(NEW_LOSS + NEW_RNN)
    for t in NEW_LOSS + NEW_RNN:
        info, jinfo = preg.lookup(t), jreg.lookup(t)
        assert info.emitter is not None, t
        for flag in ("no_grad", "intermediate_outputs", "needs_rng",
                     "is_host"):
            assert getattr(info, flag) == getattr(jinfo, flag), (t, flag)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_loss_op_matches_jax(case):
    _, op_type, ins, attrs, _ = case
    j, p = run_both(op_type, ins, attrs)
    assert sorted(p) == sorted(j)
    assert_outputs_match(j, p)


GRAD_CASES = [c for c in CASES if c[4]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_loss_op_vjp_matches_jax(case):
    _, op_type, ins, attrs, _ = case
    assert_vjp_match(op_type, ins, attrs)


def test_l1_norm_gradient_at_zero_is_jax_abs():
    """``jnp.abs`` passes the whole cotangent at ±0 (torch.abs none)."""
    xv = np.array([[0.0, -0.0, -1.0]], np.float32)
    from test_torch_tensor_ops import vjp_both
    _, p = vjp_both("l1_norm", {"X": [xv]}, {}, seed=1)
    g = np.asarray(p["X@GRAD"][0])
    assert (np.abs(g[0, :2]) > 0).all() and g[0, 2] == -g[0, 0]


def test_lstmp_rows_past_their_length_are_zero():
    _, op_type, ins, attrs, _ = [c for c in CASES
                                 if c[0] == "lstmp_lengths"][0]
    _, p = run_both(op_type, ins, attrs)
    proj = p["Projection"][0]
    assert not proj[1].any() and not proj[2, 3:].any()
    assert proj[2, :3].all() and proj[0].all()


# ---------------------------------------------------------------------------
# nce
# ---------------------------------------------------------------------------

NCE_B, NCE_D, NCE_C, NCE_S = 8, 6, 30, 5


def _nce_ins(seed, bias=True):
    ins = {"Input": [_f(seed, NCE_B, NCE_D)],
           "Label": [_rng(seed + 1).randint(0, NCE_C, (NCE_B, 1))
                     .astype(np.int64)],
           "Weight": [_f(seed + 2, NCE_C, NCE_D) * 0.3]}
    if bias:
        ins["Bias"] = [_f(seed + 3, NCE_C, 1) * 0.1]
    return ins


def _numpy_nce_cost(x, w, bias, samples, n_neg, n_cls):
    def log_sig(v):
        return -np.logaddexp(0.0, -v)
    x, w = x.astype(np.float64), w.astype(np.float64)
    sc = np.einsum("bd,bkd->bk", x, w[samples])
    if bias is not None:
        sc = sc + bias.astype(np.float64).reshape(-1)[samples]
    log_b = np.log(n_neg / n_cls)
    return (-log_sig(sc[:, :1] - log_b).sum(1)
            - log_sig(log_b - sc[:, 1:]).sum(1)).reshape(-1, 1), sc


def _port_nce(ins, attrs, seed=0):
    ctx = preg.EmitContext(torch.device("cpu"),
                           generator=torch.Generator().manual_seed(seed))
    return {s: [v.numpy() for v in vs] for s, vs in preg.lookup(
        "nce").emitter(ctx, _pins(ins), attrs).items()}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_nce_forward_against_its_samples(bias):
    ins = _nce_ins(50, bias)
    attrs = {"num_total_classes": NCE_C, "num_neg_samples": NCE_S}
    p = _port_nce(ins, attrs)
    samples = p["SampleLabels"][0]
    assert samples.shape == (NCE_B, 1 + NCE_S) and samples.dtype == np.int64
    assert (samples[:, 0] == ins["Label"][0][:, 0]).all()
    assert samples.min() >= 0 and samples.max() < NCE_C
    cost, sc = _numpy_nce_cost(ins["Input"][0], ins["Weight"][0],
                               ins["Bias"][0] if bias else None, samples,
                               NCE_S, NCE_C)
    assert_close(p["Cost"][0], cost.astype(np.float32), FWD_REL, "Cost")
    assert_close(p["SampleLogits"][0], sc.astype(np.float32), FWD_REL,
                 "SampleLogits")
    # another generator state draws other negatives
    assert not np.array_equal(_port_nce(ins, attrs, seed=1)["SampleLabels"][0],
                              samples)


def _nce_grad_both(ins, samples, gout):
    gins = dict(ins, SampleLabels=[samples], **{"Cost@GRAD": [gout]})
    attrs = {"num_total_classes": NCE_C, "num_neg_samples": NCE_S,
             "__fwd_type__": "nce"}
    j = jreg.lookup("nce_grad").emitter(jreg.EmitContext(), _jins(gins),
                                        attrs)
    p = preg.lookup("nce_grad").emitter(
        preg.EmitContext(torch.device("cpu")), _pins(gins), attrs)
    return j, p


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_nce_grad_matches_jax_on_the_ports_samples(bias):
    ins = _nce_ins(60, bias)
    attrs = {"num_total_classes": NCE_C, "num_neg_samples": NCE_S}
    samples = _port_nce(ins, attrs)["SampleLabels"][0]
    gout = _f(64, NCE_B, 1)
    j, p = _nce_grad_both(ins, samples, gout)
    slots = ["Input@GRAD", "Weight@GRAD"] + (["Bias@GRAD"] if bias else [])
    assert sorted(p) == sorted(slots)
    for slot in slots:
        assert_close(p[slot][0].numpy(), np.asarray(j[slot][0]), GRAD_REL,
                     slot)


def test_nce_grad_against_finite_differences():
    """The port's nce_grad on its samples against a central difference of
    the float64 numpy cost, for every Input and Bias element and a few
    Weight rows."""
    ins = _nce_ins(70)
    attrs = {"num_total_classes": NCE_C, "num_neg_samples": NCE_S}
    samples = _port_nce(ins, attrs)["SampleLabels"][0]
    gout = _f(74, NCE_B, 1)
    _, p = _nce_grad_both(ins, samples, gout)
    args = {s: ins[s][0].astype(np.float64)
            for s in ("Input", "Weight", "Bias")}

    def loss(vals):
        return float((_numpy_nce_cost(vals["Input"], vals["Weight"],
                                      vals["Bias"], samples, NCE_S,
                                      NCE_C)[0] * gout).sum())

    eps = 1e-6
    for name in ("Input", "Bias", "Weight"):
        got = p[name + "@GRAD"][0].numpy()
        idx = (list(np.ndindex(args[name].shape)) if name != "Weight"
               else [(r, c) for r in samples[0] for c in range(NCE_D)])
        for i in idx:
            hi, lo = dict(args), dict(args)
            hi[name], lo[name] = args[name].copy(), args[name].copy()
            hi[name][i] += eps
            lo[name][i] -= eps
            num = (loss(hi) - loss(lo)) / (2 * eps)
            assert abs(float(got[i]) - num) <= 1e-4 * max(1.0, abs(num)), (
                name, i)


def test_nce_is_test_scores_the_full_softmax():
    ins = _nce_ins(80)
    attrs = {"num_total_classes": NCE_C, "num_neg_samples": NCE_S}
    j, p = run_both("nce", ins, attrs, is_test=True)
    assert_outputs_match(j, p)
    logits = ins["Input"][0] @ ins["Weight"][0].T + ins["Bias"][0].T
    want = -(logits - np.log(np.exp(logits).sum(1, keepdims=True)))[
        np.arange(NCE_B), ins["Label"][0][:, 0]]
    np.testing.assert_allclose(p["Cost"][0][:, 0], want, rtol=1e-5)


# ---------------------------------------------------------------------------
# positive_negative_pair
# ---------------------------------------------------------------------------

def _pair_ins(seed, n=24, accumulate=False):
    rng = _rng(seed)
    ins = {"Score": [np.round(rng.rand(n, 1) * 4).astype(np.float32) / 4],
           "Label": [rng.randint(0, 3, (n, 1)).astype(np.float32)],
           "QueryID": [rng.randint(0, 4, (n, 1)).astype(np.int64)]}
    if accumulate:
        for i, s in enumerate(("AccumulatePositivePair",
                               "AccumulateNegativePair",
                               "AccumulateNeutralPair")):
            ins[s] = [np.array([10.0 + i], np.float32)]
    return ins


@pytest.mark.parametrize("accumulate", [False, True],
                         ids=["plain", "accumulated"])
def test_positive_negative_pair_matches_jax(accumulate):
    ins = _pair_ins(90, accumulate=accumulate)
    j, p = run_both("positive_negative_pair", ins, {})
    assert sorted(p) == sorted(j)
    for slot in j:
        assert p[slot][0].dtype == np.float32 and p[slot][0].shape == ()
        assert float(p[slot][0]) == float(j[slot][0]), slot


def test_pair_counts_against_a_recount():
    ins = _pair_ins(91, n=40)
    score, label, qid = (ins[s][0].reshape(-1)
                         for s in ("Score", "Label", "QueryID"))
    want = [0, 0, 0]
    for a in range(40):
        for b in range(a + 1, 40):
            if qid[a] != qid[b] or label[a] == label[b]:
                continue
            prod = (score[a] - score[b]) * (label[a] - label[b])
            want[0 if prod > 0 else 1 if prod < 0 else 2] += 1
    assert count_pairs(score, label, qid).tolist() == want
    assert min(want) > 0


# ---------------------------------------------------------------------------
# the JAX package's OpTests through the port
# ---------------------------------------------------------------------------

OPTESTS = [(jloss, n) for n in (
    "TestHingeLoss", "TestRankLoss", "TestMarginRankLoss", "TestBprLoss",
    "TestModifiedHuber", "TestTeacherStudentLoss", "TestSquaredL2Distance",
    "TestSquaredL2Norm", "TestL1Norm", "TestMinus")] + [
    (jrnn, n) for n in ("TestLstmUnit", "TestGruUnit")]


@pytest.mark.parametrize("mod,name", OPTESTS, ids=[n for _, n in OPTESTS])
def test_jax_optest_data_through_port(mod, name):
    run_optest_on_port(getattr(mod, name), 1e-5)
