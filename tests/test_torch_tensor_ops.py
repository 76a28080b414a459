"""The general tensor ops of the port against the JAX package, on the CPU.

- **Ops.** Each of the 17 types ``paddle_tpu/ops/kernels_tensor.py`` adds
  to the port (``NEW_TENSOR``) runs through both packages' emitters on the
  same numpy-seeded inputs. Integer outputs are equal (the JAX package
  narrows int64 to int32 on the CPU; the port keeps the dtype the program
  declares); float outputs agree within FWD_REL of each output's largest
  magnitude: the two sum in other orders (``cumsum``), else they agree
  bitwise.
- **Probes.** ``one_hot`` of an id past the depth and of a negative id
  (a row of zeros, where ``F.one_hot`` raises); ``arg_max``, ``arg_min``
  and ``argsort`` on NaNs and ±0 ties (``jnp``'s rules: the first index,
  NaN highest, -0 ties +0 in input order); ``cumsum`` exclusive and
  reverse; ``scatter`` with unique ids (overwrite) and repeated ids (add);
  ``range`` without ``num`` raises in both.
- **Gradients.** Each gradful type's generic vjp against the JAX
  package's on the same cotangents, within GRAD_REL of each gradient's
  largest magnitude.
- **The random op.** ``truncated_gaussian_random`` draws from different
  streams in the two packages (ROADMAP C "RNG"): both are held by their
  bounds (mean ± 2 std) and moments (the truncated normal's mean and
  standard deviation, within TRUNC_MOMENT_TOL on 200000 draws).
- **Descs.** One op of each of the 35 types this slice adds
  (``NEW_TENSOR_LOSS_RNN``), appended by hand to a block in both
  packages, gives the same program bytes (the same infer rules).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

FWD_REL = 1e-6
GRAD_REL = 1e-6
TRUNC_MOMENT_TOL = 0.01

NEW_TENSOR = (
    "truncated_gaussian_random", "reshape", "squeeze", "stack", "unstack",
    "scatter", "one_hot", "arg_max", "arg_min", "argsort", "cumsum",
    "shape", "range", "pad", "pad2d", "flatten", "flatten2")
NEW_LOSS = (
    "hinge_loss", "rank_loss", "margin_rank_loss", "bpr_loss",
    "modified_huber_loss", "teacher_student_sigmoid_loss",
    "squared_l2_distance", "squared_l2_norm", "l1_norm", "minus", "nce",
    "nce_grad", "hierarchical_sigmoid", "positive_negative_pair",
    "label_smooth")
NEW_RNN = ("lstm_unit", "gru_unit", "lstmp")


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _rng(seed):
    return np.random.RandomState(seed)


def _f(seed, *shape):
    return _rng(seed).randn(*shape).astype(np.float32)


def _jins(ins):
    return {s: [None if a is None else jnp.asarray(a) for a in v]
            for s, v in ins.items()}


def _pins(ins):
    return {s: [None if a is None else torch.from_numpy(np.array(a))
                for a in v] for s, v in ins.items()}


def run_both(op_type, ins, attrs, is_test=False):
    """One op through both packages' emitters on numpy inputs; returns
    ({slot: [numpy]} of JAX, the same of the port)."""
    jctx = jreg.EmitContext(rng=jax.random.PRNGKey(0), is_test=is_test)
    pctx = preg.EmitContext(torch.device("cpu"),
                            generator=torch.Generator().manual_seed(0),
                            is_test=is_test)
    jouts = jreg.lookup(op_type).emitter(jctx, _jins(ins), attrs)
    pouts = preg.lookup(op_type).emitter(pctx, _pins(ins), attrs)
    return ({s: [np.asarray(v) for v in vs] for s, vs in jouts.items()},
            {s: [np.asarray(v) for v in vs] for s, vs in pouts.items()})


def assert_close(got, want, rel, what):
    """Integers equal in value (the port's dtype may be wider), floats in
    the same dtype within ``rel`` of the largest magnitude."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        assert got.dtype.kind == want.dtype.kind, (what, got.dtype)
        assert got.tolist() == want.tolist(), what
        return
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    top = float(np.nanmax(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(top, 1e-30),
                               equal_nan=True, err_msg=what)


def assert_outputs_match(j, p, rel=FWD_REL, slots=None):
    for slot in slots or j:
        assert len(p[slot]) == len(j[slot]), slot
        for i, (want, got) in enumerate(zip(j[slot], p[slot])):
            assert_close(got, want, rel, f"{slot}[{i}]")


def vjp_both(op_type, ins, attrs, seed):
    """Both packages' generic vjp of ``op_type`` on the same cotangents of
    every float output its forward gives."""
    fwd, _ = run_both(op_type, ins, attrs)
    info = jreg.lookup(op_type)
    rng = _rng(seed)
    gins = dict(ins)
    for slot, vals in fwd.items():
        if slot in info.intermediate_outputs:
            gins[slot] = vals
        elif all(v.dtype.kind == "f" for v in vals):
            gins[slot + "@GRAD"] = [rng.randn(*v.shape).astype(v.dtype)
                                    for v in vals]
    gattrs = dict(attrs, __fwd_type__=op_type)
    jouts = jreg.generic_vjp_grad_emitter(jreg.EmitContext(), _jins(gins),
                                          gattrs)
    pouts = preg.generic_vjp_grad_emitter(
        preg.EmitContext(torch.device("cpu")), _pins(gins), gattrs)
    return jouts, pouts


def assert_vjp_match(op_type, ins, attrs, seed=100, rel=GRAD_REL):
    """Every float input's gradient within ``rel`` of the JAX package's;
    no gradient for an integer input."""
    jouts, pouts = vjp_both(op_type, ins, attrs, seed)
    checked = 0
    for slot, vals in ins.items():
        for i, v in enumerate(vals):
            g = slot + "@GRAD"
            if v is None:
                continue
            if np.asarray(v).dtype.kind != "f":
                assert pouts[g][i] is None, g
                continue
            assert_close(pouts[g][i].numpy(), np.asarray(jouts[g][i]), rel,
                         g)
            checked += 1
    assert checked, op_type


# ---------------------------------------------------------------------------
# cases: (id, type, inputs, attrs, gradful)
# ---------------------------------------------------------------------------

X3 = _f(1, 3, 4, 5)
CASES = [
    ("reshape", "reshape", {"X": [X3]}, {"shape": [0, -1]}, True),
    ("reshape_full", "reshape", {"X": [X3]}, {"shape": [5, 2, 6]}, True),
    ("squeeze", "squeeze", {"X": [_f(2, 3, 1, 4, 1)]}, {"axes": [1]}, True),
    ("squeeze_all", "squeeze", {"X": [_f(3, 3, 1, 4, 1)]}, {"axes": []},
     True),
    ("stack", "stack", {"X": [_f(4, 3, 4), _f(5, 3, 4), _f(6, 3, 4)]},
     {"axis": 1}, True),
    ("stack_last", "stack", {"X": [_f(7, 2, 3), _f(8, 2, 3)]},
     {"axis": -1}, True),
    ("unstack", "unstack", {"X": [X3]}, {"axis": 1, "num": 4}, True),
    ("unstack_default", "unstack", {"X": [X3]}, {"axis": 0}, True),
    ("scatter_overwrite", "scatter",
     {"X": [_f(9, 6, 3)], "Ids": [np.array([4, 0, 2], np.int64)],
      "Updates": [_f(10, 3, 3)]}, {"overwrite": True}, True),
    ("scatter_add_repeated", "scatter",
     {"X": [_f(11, 6, 3)], "Ids": [np.array([1, 4, 1, 1, 0], np.int64)],
      "Updates": [_f(12, 5, 3)]}, {"overwrite": False}, True),
    ("one_hot", "one_hot",
     {"X": [_rng(13).randint(0, 7, (5, 1)).astype(np.int64)]},
     {"depth": 7}, False),
    ("one_hot_out_of_range", "one_hot",
     {"X": [np.array([[0], [9], [-1], [3], [4]], np.int64)]},
     {"depth": 5}, False),
    ("arg_max", "arg_max", {"X": [X3]}, {"axis": 1}, False),
    ("arg_max_last", "arg_max", {"X": [X3]}, {"axis": -1}, False),
    ("arg_min", "arg_min", {"X": [X3]}, {"axis": 0}, False),
    ("argsort", "argsort", {"X": [X3]}, {"axis": -1}, False),
    ("argsort_ties", "argsort",
     {"X": [np.round(_f(14, 4, 9)).astype(np.float32)]}, {"axis": 1}, False),
    ("argsort_int", "argsort",
     {"X": [_rng(15).randint(0, 4, (3, 8)).astype(np.int64)]}, {"axis": 0},
     False),
    ("cumsum", "cumsum", {"X": [X3]}, {"axis": -1}, True),
    ("cumsum_exclusive", "cumsum", {"X": [X3]},
     {"axis": 1, "exclusive": True}, True),
    ("cumsum_reverse", "cumsum", {"X": [X3]},
     {"axis": 0, "reverse": True}, True),
    ("cumsum_exclusive_reverse", "cumsum", {"X": [X3]},
     {"axis": 2, "exclusive": True, "reverse": True}, True),
    ("shape", "shape", {"Input": [X3]}, {}, False),
    ("range", "range",
     {"Start": [np.array([1.5], np.float32)],
      "End": [np.array([9.0], np.float32)],
      "Step": [np.array([0.75], np.float32)]}, {"num": 10}, False),
    ("range_int", "range",
     {"Start": [np.array([3], np.int32)], "End": [np.array([20], np.int32)],
      "Step": [np.array([4], np.int32)]}, {"num": 5}, False),
    ("pad", "pad", {"X": [X3]}, {"paddings": [0, 1, 2, 0, 1, 3],
                                 "pad_value": -2.5}, True),
    ("pad2d_constant", "pad2d", {"X": [_f(16, 2, 3, 4, 5)]},
     {"paddings": [1, 0, 2, 1], "mode": "constant", "pad_value": 0.5}, True),
    ("pad2d_reflect", "pad2d", {"X": [_f(17, 2, 3, 4, 5)]},
     {"paddings": [2, 1, 1, 3], "mode": "reflect"}, True),
    ("pad2d_edge", "pad2d", {"X": [_f(18, 2, 3, 4, 5)]},
     {"paddings": [0, 2, 3, 1], "mode": "edge"}, True),
    ("flatten", "flatten", {"X": [X3]}, {"axis": 2}, True),
    ("flatten_axis0", "flatten", {"X": [X3]}, {"axis": 0}, True),
    ("flatten2", "flatten2", {"X": [X3]}, {"axis": 1}, True),
]

# the 16 deterministic types here; truncated_gaussian_random below
DETERMINISTIC_TENSOR = set(NEW_TENSOR) - {"truncated_gaussian_random"}


def test_cases_cover_the_tensor_types():
    assert {c[1] for c in CASES} == DETERMINISTIC_TENSOR
    for t in NEW_TENSOR:
        assert preg.lookup(t).emitter is not None, t
        # the same gradient bookkeeping as the JAX op
        for flag in ("no_grad", "intermediate_outputs", "needs_rng",
                     "is_host"):
            assert getattr(preg.lookup(t), flag) == getattr(
                jreg.lookup(t), flag), (t, flag)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tensor_op_matches_jax(case):
    _, op_type, ins, attrs, _ = case
    j, p = run_both(op_type, ins, attrs)
    assert sorted(p) == sorted(j)
    assert_outputs_match(j, p)


GRAD_CASES = [c for c in CASES if c[4]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_tensor_op_vjp_matches_jax(case):
    _, op_type, ins, attrs, _ = case
    assert_vjp_match(op_type, ins, attrs)


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

ORDER_PROBES = {
    "nan": [1.0, np.nan, -np.inf, 2.0],
    "signed_zero": [0.5, -0.0, 0.0, -1.0],
    "two_nans": [np.nan, 1.0, np.nan],
    "negative_nan": [-np.nan, 1.0, 2.0],
    "ties": [3.0, 3.0, 1.0, 1.0],
    "zeros": [-0.0, 0.0, -0.0],
}


@pytest.mark.parametrize("probe", sorted(ORDER_PROBES))
@pytest.mark.parametrize("op_type", ["arg_max", "arg_min", "argsort"])
def test_order_probe_matches_jax(op_type, probe):
    """jnp's rules on every probe: the first index of a tie, the first NaN
    for arg_max and arg_min, NaNs last in argsort (in input order), -0
    and +0 equal and kept in input order; argsort's values carry their
    signs."""
    xv = np.array([ORDER_PROBES[probe]], np.float32)
    j, p = run_both(op_type, {"X": [xv]}, {"axis": -1})
    assert_outputs_match(j, p)
    if op_type == "argsort":
        assert (np.signbit(p["Out"][0]).tolist()
                == np.signbit(j["Out"][0]).tolist())


def test_order_probes_pin_the_rules():
    _, p = run_both("arg_max", {"X": [np.array(
        [ORDER_PROBES["nan"], ORDER_PROBES["signed_zero"]], np.float32)]},
        {"axis": 1})
    assert p["Out"][0].tolist() == [1, 0]
    _, p = run_both("argsort", {"X": [np.array([ORDER_PROBES["signed_zero"]],
                                               np.float32)]}, {"axis": -1})
    assert p["Indices"][0].tolist() == [[3, 1, 2, 0]]
    assert p["Indices"][0].dtype == np.int64


def test_one_hot_ignores_out_of_range_ids():
    ids = np.array([[0], [9], [-1], [3]], np.int64)
    _, p = run_both("one_hot", {"X": [ids]}, {"depth": 5})
    out = p["Out"][0]
    assert out.dtype == np.float32 and out.shape == (4, 5)
    assert out.sum(axis=1).tolist() == [1.0, 0.0, 0.0, 1.0]
    assert out[0, 0] == 1.0 and out[3, 3] == 1.0


def test_cumsum_exclusive_is_inclusive_less_x():
    """The exclusive sum is the inclusive one less X (the JAX op's
    arithmetic), reversed by flips."""
    xv = np.array([[1.0, 2.0, 3.0, 4.0]], np.float32)
    for attrs, want in (({"exclusive": True}, [0, 1, 3, 6]),
                        ({"reverse": True}, [10, 9, 7, 4]),
                        ({"exclusive": True, "reverse": True}, [9, 7, 4, 0])):
        _, p = run_both("cumsum", {"X": [xv]}, dict(attrs, axis=-1))
        assert p["Out"][0].tolist() == [want], attrs


def test_scatter_add_sums_repeated_ids():
    xv = np.zeros((3, 2), np.float32)
    upd = np.arange(8, dtype=np.float32).reshape(4, 2)
    ins = {"X": [xv], "Ids": [np.array([2, 0, 2, 2], np.int64)],
           "Updates": [upd]}
    j, p = run_both("scatter", ins, {"overwrite": False})
    assert p["Out"][0].tolist() == [[2, 3], [0, 0], [10, 13]]
    assert_outputs_match(j, p)


def test_range_without_num_raises_in_both():
    ins = {"Start": [np.array([0.0], np.float32)],
           "End": [np.array([4.0], np.float32)],
           "Step": [np.array([1.0], np.float32)]}
    errors = []
    for reg, conv in ((jreg, _jins), (preg, _pins)):
        ctx = (jreg.EmitContext() if reg is jreg
               else preg.EmitContext(torch.device("cpu")))
        with pytest.raises(NotImplementedError) as err:
            reg.lookup("range").emitter(ctx, conv(ins), {})
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_truncated_gaussian_random_bounds_and_moments(dtype):
    """mean + std * a normal truncated at ±2 in both packages: every draw
    inside the bounds, the draws' mean and standard deviation those of
    the truncated normal (std * 0.8796) within TRUNC_MOMENT_TOL of std.
    The JAX package's float64 draws are float32 (x64 is off)."""
    attrs = {"shape": [400, 500], "mean": 1.5, "std": 2.0}
    jout = jreg.lookup("truncated_gaussian_random").emitter(
        jreg.EmitContext(rng=jax.random.PRNGKey(0)), {},
        dict(attrs, dtype=fluid.core.types.convert_dtype(dtype)))["Out"][0]
    pout = preg.lookup("truncated_gaussian_random").emitter(
        preg.EmitContext(torch.device("cpu"),
                         generator=torch.Generator().manual_seed(0)), {},
        dict(attrs, dtype=pt.core.types.convert_dtype(dtype)))["Out"][0]
    phi2 = math.exp(-2.0) / math.sqrt(2 * math.pi)
    mass = math.erf(2 / math.sqrt(2))
    want_std = 2.0 * math.sqrt(1 - 4 * phi2 / mass)
    for got in (np.asarray(jout), pout.numpy()):
        assert got.shape == (400, 500)
        assert got.min() >= 1.5 - 4.0 and got.max() <= 1.5 + 4.0
        assert abs(got.mean() - 1.5) <= TRUNC_MOMENT_TOL * 2.0
        assert abs(got.std() - want_std) <= TRUNC_MOMENT_TOL * 2.0
    assert pout.numpy().dtype == np.dtype(dtype)


# ---------------------------------------------------------------------------
# descs: one op of each new type, appended by hand, byte-identical
# ---------------------------------------------------------------------------

def _append(fl, op_type, ins, outs, attrs):
    """A program holding one ``op_type`` op over data vars ``ins`` ({slot:
    [(name, shape, dtype)]}) writing fresh vars ``outs`` ({slot: [name]})."""
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        block = main.global_block()
        inputs = {}
        for slot, vs in ins.items():
            inputs[slot] = [fl.layers.data(n, shape=s, dtype=d,
                                           append_batch_size=False)
                            for n, s, d in vs]
        outputs = {slot: [block.create_var(name=n) for n in names]
                   for slot, names in outs.items()}
        if "dtype" in attrs:
            attrs = dict(attrs, dtype=fl.core.types.convert_dtype(
                attrs["dtype"]))
        block.append_op(type=op_type, inputs=inputs, outputs=outputs,
                        attrs=attrs)
    return main


F32, I64 = "float32", "int64"
DESC_CASES = {
    "truncated_gaussian_random": ({}, {"Out": ["o"]},
                                  {"shape": [3, 4], "mean": 0.0, "std": 1.0,
                                   "dtype": "float32"}),
    "reshape": ({"X": [("x", [2, 3, 4], F32)]}, {"Out": ["o"]},
                {"shape": [0, -1]}),
    "squeeze": ({"X": [("x", [2, 1, 4], F32)]}, {"Out": ["o"]},
                {"axes": [1]}),
    "stack": ({"X": [("a", [2, 3], F32), ("b", [2, 3], F32)]},
              {"Y": ["o"]}, {"axis": 1}),
    "unstack": ({"X": [("x", [2, 3], F32)]}, {"Y": ["o0", "o1", "o2"]},
                {"axis": 1, "num": 3}),
    "scatter": ({"X": [("x", [5, 3], F32)], "Ids": [("i", [2], I64)],
                 "Updates": [("u", [2, 3], F32)]}, {"Out": ["o"]},
                {"overwrite": True}),
    "one_hot": ({"X": [("x", [4, 1], I64)]}, {"Out": ["o"]}, {"depth": 9}),
    "arg_max": ({"X": [("x", [2, 3, 4], F32)]}, {"Out": ["o"]},
                {"axis": 1}),
    "arg_min": ({"X": [("x", [2, 3, 4], F32)]}, {"Out": ["o"]},
                {"axis": -1}),
    "argsort": ({"X": [("x", [2, 3], F32)]},
                {"Out": ["o"], "Indices": ["i"]}, {"axis": -1}),
    "cumsum": ({"X": [("x", [2, 3], F32)]}, {"Out": ["o"]},
               {"axis": 1, "exclusive": True, "reverse": False}),
    "shape": ({"Input": [("x", [2, 3, 4], F32)]}, {"Out": ["o"]}, {}),
    "range": ({"Start": [("a", [1], F32)], "End": [("b", [1], F32)],
               "Step": [("c", [1], F32)]}, {"Out": ["o"]}, {"num": 4}),
    "pad": ({"X": [("x", [2, 3], F32)]}, {"Out": ["o"]},
            {"paddings": [1, 0, 0, 2], "pad_value": 0.0}),
    "pad2d": ({"X": [("x", [1, 2, 3, 4], F32)]}, {"Out": ["o"]},
              {"paddings": [1, 1, 2, 0], "mode": "edge", "pad_value": 0.0}),
    "flatten": ({"X": [("x", [2, 3, 4], F32)]}, {"Out": ["o"]},
                {"axis": 1}),
    "flatten2": ({"X": [("x", [2, 3, 4], F32)]},
                 {"Out": ["o"], "XShape": ["s"]}, {"axis": 2}),
    "hinge_loss": ({"Logits": [("x", [4, 1], F32)],
                    "Labels": [("y", [4, 1], F32)]}, {"Loss": ["o"]}, {}),
    "rank_loss": ({"Label": [("l", [4, 1], F32)], "Left": [("a", [4, 1], F32)],
                   "Right": [("b", [4, 1], F32)]}, {"Out": ["o"]}, {}),
    "margin_rank_loss": ({"Label": [("l", [4, 1], F32)],
                          "X1": [("a", [4, 1], F32)],
                          "X2": [("b", [4, 1], F32)]},
                         {"Out": ["o"], "Activated": ["act"]},
                         {"margin": 0.1}),
    "bpr_loss": ({"X": [("x", [4, 6], F32)], "Label": [("l", [4, 1], I64)]},
                 {"Y": ["o"]}, {}),
    "modified_huber_loss": ({"X": [("x", [4, 1], F32)],
                             "Y": [("y", [4, 1], F32)]},
                            {"Out": ["o"], "IntermediateVal": ["v"]}, {}),
    "teacher_student_sigmoid_loss": ({"X": [("x", [4, 1], F32)],
                                      "Label": [("l", [4, 1], F32)]},
                                     {"Y": ["o"]}, {}),
    "squared_l2_distance": ({"X": [("x", [4, 3], F32)],
                             "Y": [("y", [4, 3], F32)]},
                            {"Out": ["o"], "sub_result": ["s"]}, {}),
    "squared_l2_norm": ({"X": [("x", [4, 3], F32)]}, {"Out": ["o"]}, {}),
    "l1_norm": ({"X": [("x", [4, 3], F32)]}, {"Out": ["o"]}, {}),
    "minus": ({"X": [("x", [4, 3], F32)], "Y": [("y", [4, 3], F32)]},
              {"Out": ["o"]}, {}),
    "nce": ({"Input": [("x", [4, 8], F32)], "Label": [("l", [4, 1], I64)],
             "Weight": [("w", [20, 8], F32)], "Bias": [("b", [20, 1], F32)]},
            {"Cost": ["o"], "SampleLogits": ["sl"], "SampleLabels": ["sll"]},
            {"num_total_classes": 20, "num_neg_samples": 5}),
    "nce_grad": ({"Input": [("x", [4, 8], F32)], "Weight": [("w", [20, 8],
                                                              F32)],
                  "Bias": [("b", [20, 1], F32)],
                  "SampleLabels": [("sll", [4, 6], I64)],
                  "Cost@GRAD": [("g", [4, 1], F32)]},
                 {"Input@GRAD": ["gx"], "Weight@GRAD": ["gw"],
                  "Bias@GRAD": ["gb"]}, {}),
    "hierarchical_sigmoid": ({"X": [("x", [4, 8], F32)],
                              "Label": [("l", [4, 1], I64)],
                              "W": [("w", [9, 8], F32)]},
                             {"Out": ["o"], "PreOut": ["p"]},
                             {"num_classes": 10}),
    "positive_negative_pair": ({"Score": [("s", [6, 1], F32)],
                                "Label": [("l", [6, 1], F32)],
                                "QueryID": [("q", [6, 1], I64)]},
                               {"PositivePair": ["p"], "NegativePair": ["n"],
                                "NeutralPair": ["u"]}, {}),
    "label_smooth": ({"X": [("x", [4, 10], F32)]}, {"Out": ["o"]},
                     {"epsilon": 0.1}),
    "lstm_unit": ({"X": [("x", [4, 12], F32)], "C_prev": [("c", [4, 3], F32)]},
                  {"C": ["c2"], "H": ["h"]}, {"forget_bias": 1.0}),
    "gru_unit": ({"Input": [("x", [4, 9], F32)],
                  "HiddenPrev": [("h", [4, 3], F32)],
                  "Weight": [("w", [3, 9], F32)]},
                 {"Hidden": ["o"], "Gate": ["g"], "ResetHiddenPrev": ["r"]},
                 {"origin_mode": True}),
    "lstmp": ({"Input": [("x", [2, 5, 8], F32)], "Weight": [("w", [3, 8],
                                                              F32)],
               "ProjWeight": [("pw", [2, 3], F32)]},
              {"Projection": ["p"], "Cell": ["c"], "BatchGate": ["bg"],
               "BatchCellPreAct": ["bc"], "BatchHidden": ["bh"]},
              {"use_peepholes": False}),
}
NEW_TENSOR_LOSS_RNN = NEW_TENSOR + NEW_LOSS + NEW_RNN


def test_desc_cases_cover_the_35_types():
    assert len(NEW_TENSOR_LOSS_RNN) == 35
    assert set(DESC_CASES) == set(NEW_TENSOR_LOSS_RNN)


@pytest.mark.parametrize("op_type", sorted(DESC_CASES))
def test_op_desc_bytes_match_jax(op_type):
    """The op's desc and the shapes and dtypes its infer rule writes on
    its outputs, byte for byte."""
    ins, outs, attrs = DESC_CASES[op_type]
    with junique.guard():
        j = _append(fluid, op_type, ins, outs, dict(attrs))
    with punique.guard():
        p = _append(pt, op_type, ins, outs, dict(attrs))
    assert p.desc.to_bytes() == j.desc.to_bytes()
