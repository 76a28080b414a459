"""The sequence ops and layers of the port against the JAX package, on the
CPU.

- **Ops.** Each of the 18 sequence types of ``ops/kernels_sequence.py``
  ported here runs through both packages' emitters on the same
  numpy-seeded inputs; rows of length 0, 1 and T where an op takes a
  Length. Integer outputs equal (the port's are int64), float outputs
  within FWD_REL of each output's largest magnitude. ``im2sequence`` with
  uneven paddings, C > 1 and kh, kw > 1; ``lod_rank_table`` with tied
  lengths (a stable sort keeps their order).
- **Gradients.** Each gradful type's generic vjp against the JAX
  package's on the same cotangents, within GRAD_REL of each gradient's
  largest magnitude.
- **The JAX OpTests.** The inputs and expected outputs that
  tests/test_ops_sequence.py's OpTest classes state, through the port's
  emitters at the tolerance of each class's check.
- **Layers.** Programs of the sequence layers byte-identical to the JAX
  package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

import test_ops_sequence as jseq

FWD_REL = 1e-5
GRAD_REL = 1e-5
B, T, D = 4, 6, 5
LENGTHS = np.array([T, 3, 1, 0], np.int64)   # full, mid, 1 and 0


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def run_both(op_type, ins, attrs):
    """One op through both packages' emitters on numpy inputs; returns
    ({slot: [numpy]}, {slot: [numpy]}) of JAX and the port."""
    jouts = jreg.lookup(op_type).emitter(
        jreg.EmitContext(), {s: [None if a is None else jnp.asarray(a)
                                 for a in v] for s, v in ins.items()}, attrs)
    pouts = preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu")),
        {s: [None if a is None else torch.from_numpy(np.array(a))
             for a in v] for s, v in ins.items()}, attrs)
    return ({s: [np.asarray(v) for v in vs] for s, vs in jouts.items()},
            {s: [v.numpy() for v in vs] for s, vs in pouts.items()})


def assert_outputs_match(j, p, rel=FWD_REL, slots=None):
    for slot in slots or j:
        for want, got in zip(j[slot], p[slot]):
            assert got.shape == want.shape, (slot, got.shape, want.shape)
            if want.dtype.kind in "iub":
                if want.dtype.kind != "b":
                    assert got.dtype == np.int64, (slot, got.dtype)
                assert got.tolist() == want.tolist(), slot
            else:
                top = float(np.abs(want).max()) if want.size else 0.0
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=rel * max(top, 1e-30),
                                           err_msg=slot)


def _rng(seed):
    return np.random.RandomState(seed)


def _x3(seed=0, d=D):
    return _rng(seed).randn(B, T, d).astype(np.float32)


def _ids(seed=0, hi=7):
    return _rng(seed).randint(0, hi, (B, T)).astype(np.int64)


# (case id, op type, inputs, attrs, gradful)
CASES = [
    ("expand", "sequence_expand",
     {"X": [_rng(1).randn(B, D).astype(np.float32)], "Y": [_x3(2)]}, {},
     True),
    ("reverse_length", "sequence_reverse",
     {"X": [_x3(3)], "Length": [LENGTHS]}, {}, True),
    ("reverse_full", "sequence_reverse", {"X": [_x3(4)]}, {}, True),
    ("concat", "sequence_concat",
     {"X": [_x3(5), _rng(6).randn(B, 2, D).astype(np.float32)]}, {}, True),
    ("slice", "sequence_slice", {"X": [_x3(7)]},
     {"offset": 1, "length": 3}, True),
    ("conv_length", "sequence_conv",
     {"X": [_x3(8)], "Filter": [_rng(9).randn(3 * D, 4).astype(np.float32)],
      "Length": [LENGTHS]},
     {"contextLength": 3, "contextStart": -1, "contextStride": 1}, True),
    ("conv_wide_window", "sequence_conv",
     {"X": [_x3(10)],
      "Filter": [_rng(11).randn(4 * D, 3).astype(np.float32)]},
     {"contextLength": 4, "contextStart": -2}, True),
    ("conv_defaults", "sequence_conv",
     {"X": [_x3(12)], "Filter": [_rng(13).randn(5 * D, 2).astype(np.float32)],
      "Length": [LENGTHS]}, {}, True),
    ("row_conv_length", "row_conv",
     {"X": [_x3(14)], "Filter": [_rng(15).randn(3, D).astype(np.float32)],
      "Length": [LENGTHS]}, {}, True),
    ("row_conv_full", "row_conv",
     {"X": [_x3(16)], "Filter": [_rng(17).randn(2, D).astype(np.float32)]},
     {}, True),
    ("pad", "sequence_pad",
     {"X": [_x3(18)], "Length": [LENGTHS],
      "PadValue": [np.array([-1.5], np.float32)]}, {"maxlen": -1}, True),
    ("pad_longer", "sequence_pad",
     {"X": [_x3(19)], "Length": [LENGTHS],
      "PadValue": [np.array([0.25], np.float32)]}, {"maxlen": T + 3}, True),
    ("pad_shorter", "sequence_pad",
     {"X": [_x3(20)], "Length": [LENGTHS],
      "PadValue": [np.array([2.0], np.float32)]}, {"maxlen": 4}, True),
    ("unpad", "sequence_unpad", {"X": [_x3(21)], "Length": [LENGTHS]}, {},
     True),
    ("expand_as", "sequence_expand_as",
     {"X": [_rng(22).randn(B, D).astype(np.float32)], "Y": [_x3(23)]}, {},
     True),
    ("expand_as_t1", "sequence_expand_as",
     {"X": [_rng(24).randn(B, 1, D).astype(np.float32)], "Y": [_x3(25)]},
     {}, True),
    ("reshape", "sequence_reshape", {"X": [_x3(26, d=4)]}, {"new_dim": 8},
     True),
    ("scatter", "sequence_scatter",
     {"X": [_x3(27)],
      "Ids": [np.array([[0, 2, 2], [5, 1, 0], [3, 3, 3], [4, 0, 1]],
                       np.int64)],
      "Updates": [_rng(28).randn(B, 3, D).astype(np.float32)]}, {}, True),
    ("enumerate", "sequence_enumerate",
     {"X": [_ids(29)], "Length": [LENGTHS]}, {"win_size": 3, "pad_value": 0},
     False),
    ("enumerate_pad", "sequence_enumerate", {"X": [_ids(30)]},
     {"win_size": 2, "pad_value": -1}, False),
    ("erase", "sequence_erase",
     {"X": [_ids(31, hi=5)], "Length": [LENGTHS]}, {"tokens": [2, 4]},
     False),
    ("erase_full", "sequence_erase", {"X": [_ids(32, hi=4)]},
     {"tokens": [0]}, False),
    ("position", "add_position_encoding", {"X": [_x3(33, d=8)]},
     {"alpha": 0.5, "beta": 1.5}, True),
    ("position_half1", "add_position_encoding", {"X": [_x3(34, d=2)]},
     {"alpha": 1.0, "beta": 1.0}, True),
    ("im2sequence_uneven", "im2sequence",
     {"X": [_rng(35).randn(2, 3, 7, 9).astype(np.float32)]},
     {"kernels": [3, 2], "strides": [2, 1], "paddings": [1, 0, 2, 1]}, True),
    ("im2sequence_plain", "im2sequence",
     {"X": [_rng(36).randn(2, 2, 6, 8).astype(np.float32)]},
     {"kernels": [3, 1], "strides": [1, 1], "paddings": [0, 0, 0, 0]}, True),
    ("lod_reset_y", "lod_reset",
     {"X": [_x3(37)], "Y": [np.array([0, 2, 5, 6, 6], np.int64)]}, {}, True),
    ("lod_reset_target", "lod_reset", {"X": [_x3(38)]},
     {"target_lod": [0, 1, 4, 4, 6]}, True),
    ("lod_reset_none", "lod_reset", {"X": [_x3(39)]}, {}, True),
    ("rank_table_ties", "lod_rank_table",
     {"X": [np.array([3, 5, 3, 0, 5, 1], np.int64)]}, {}, False),
    ("reorder", "reorder_lod_tensor_by_rank",
     {"X": [_x3(40)], "RankTable": [np.array([2, 0, 3, 1], np.int64)]}, {},
     True),
]

SEQUENCE_TYPES = {"sequence_expand", "sequence_reverse", "sequence_concat",
                  "sequence_slice", "sequence_conv", "row_conv",
                  "sequence_pad", "sequence_unpad", "sequence_expand_as",
                  "sequence_reshape", "sequence_scatter",
                  "sequence_enumerate", "sequence_erase",
                  "add_position_encoding", "im2sequence", "lod_reset",
                  "lod_rank_table", "reorder_lod_tensor_by_rank"}


def test_cases_cover_the_18_types():
    assert {c[1] for c in CASES} == SEQUENCE_TYPES
    for t in SEQUENCE_TYPES:
        assert preg.lookup(t).emitter is not None, t
        # the same gradient bookkeeping as the JAX op
        assert preg.lookup(t).no_grad == jreg.lookup(t).no_grad, t
        assert (preg.lookup(t).intermediate_outputs
                == jreg.lookup(t).intermediate_outputs), t


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sequence_op_matches_jax(case):
    _, op_type, ins, attrs, _ = case
    j, p = run_both(op_type, ins, attrs)
    assert sorted(p) == sorted(j)
    assert_outputs_match(j, p)


def test_im2sequence_feature_order():
    """The patch features are (C, kh, kw), the padding [up, left, down,
    right] uneven: checked against a numpy loop too."""
    x = _rng(41).randn(2, 3, 5, 4).astype(np.float32)
    attrs = {"kernels": [2, 3], "strides": [1, 2], "paddings": [2, 1, 0, 3]}
    _, p = run_both("im2sequence", {"X": [x]}, attrs)
    xp = np.pad(x, ((0, 0), (0, 0), (2, 0), (1, 3)))
    oh = (xp.shape[2] - 2) // 1 + 1
    ow = (xp.shape[3] - 3) // 2 + 1
    want = np.stack([xp[:, :, i:i + 2, 2 * j:2 * j + 3].reshape(2, -1)
                     for i in range(oh) for j in range(ow)], axis=1)
    np.testing.assert_array_equal(p["Out"][0], want)


def test_lod_rank_table_ties_keep_order():
    length = np.array([2, 4, 2, 4, 0, 2], np.int64)
    j, p = run_both("lod_rank_table", {"X": [length]}, {})
    assert p["Out"][0].tolist() == [1, 3, 0, 2, 5, 4]
    assert p["Out"][0].tolist() == j["Out"][0].tolist()
    assert p["Length"][0].tolist() == [4, 4, 2, 2, 2, 0]


def _vjp_both(op_type, ins, attrs, seed):
    """Both packages' generic vjp on the same cotangents of every float
    output the forward gives."""
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
    jouts = jreg.generic_vjp_grad_emitter(
        jreg.EmitContext(), {s: [None if a is None else jnp.asarray(a)
                                 for a in v] for s, v in gins.items()},
        gattrs)
    pouts = preg.generic_vjp_grad_emitter(
        preg.EmitContext(torch.device("cpu")),
        {s: [None if a is None else torch.from_numpy(np.array(a))
             for a in v] for s, v in gins.items()}, gattrs)
    return jouts, pouts


GRAD_CASES = [c for c in CASES if c[4]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_sequence_op_vjp_matches_jax(case):
    _, op_type, ins, attrs, _ = case
    jouts, pouts = _vjp_both(op_type, ins, attrs, seed=100)
    checked = 0
    for slot, vals in ins.items():
        if slot in jreg.lookup(op_type).intermediate_outputs:
            # sequence_pad's Length is both an input and its saved output:
            # the grad op reads the saved one, in both packages
            continue
        for i, v in enumerate(vals):
            g = slot + "@GRAD"
            if np.asarray(v).dtype.kind != "f":
                assert pouts[g][i] is None, g
                continue
            want = np.asarray(jouts[g][i])
            got = pouts[g][i].numpy()
            assert got.shape == want.shape, g
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=GRAD_REL * max(float(np.abs(want).max()), 1e-30),
                err_msg=g)
            checked += 1
    assert checked


# ---------------------------------------------------------------------------
# the JAX package's OpTest data through the port
# ---------------------------------------------------------------------------

# each class's check_output tolerance (test_ops_sequence.py)
OPTEST_TOL = {"TestSequenceConv": 1e-4}
OPTESTS = sorted(n for n in dir(jseq)
                 if n.startswith("Test") and hasattr(getattr(jseq, n),
                                                     "op_type"))


def run_optest_on_port(cls, tol):
    """The inputs ``cls.setup()`` states through the port's emitter,
    against the outputs it expects, at ``tol`` (atol and rtol, as
    OpTest.check_output takes them)."""
    np.random.seed(0)
    case = cls()
    case.setup()
    attrs = getattr(case, "attrs", {})
    ins = {s: [torch.from_numpy(np.array(a)) for a in
               (v if isinstance(v, list) else [v])]
           for s, v in case.inputs.items()}
    outs = preg.lookup(case.op_type).emitter(
        preg.EmitContext(torch.device("cpu")), ins, attrs)
    for slot, want in case.outputs.items():
        wants = want if isinstance(want, list) else [want]
        for i, w in enumerate(wants):
            if w is None:
                continue
            np.testing.assert_allclose(
                outs[slot][i].numpy(), np.asarray(w), atol=tol, rtol=tol,
                err_msg=f"{case.op_type} {slot}[{i}]")


def test_optest_classes_found():
    assert "TestIm2Sequence" in OPTESTS and "TestSequenceConv" in OPTESTS


@pytest.mark.parametrize("name", OPTESTS)
def test_jax_optest_data_through_port(name):
    run_optest_on_port(getattr(jseq, name), OPTEST_TOL.get(name, 1e-5))


# ---------------------------------------------------------------------------
# layers: byte-identical programs
# ---------------------------------------------------------------------------

def _layers_program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        L = fl.layers
        x = L.data(name="x", shape=[T, 8], dtype="float32")
        length = L.data(name="len", shape=[], dtype="int64")
        ids = L.data(name="ids", shape=[T], dtype="int64")
        img = L.data(name="img", shape=[3, 12, 16], dtype="float32")
        c = L.sequence_conv(x, num_filters=4, filter_size=3, length=length,
                            act="relu")
        L.sequence_first_step(c, length=length)
        L.sequence_last_step(c, length=length)
        L.sequence_expand(L.reduce_sum(x, dim=1), x)
        L.sequence_expand_as(L.reduce_sum(x, dim=1), x)
        L.sequence_pad(x, L.fill_constant([1], "float32", 0.0), maxlen=T + 2,
                       length=length)
        L.sequence_unpad(x, length)
        L.sequence_concat([x, x])
        L.sequence_slice(x, 1, 3)
        L.sequence_reshape(x, 16)
        L.sequence_reverse(x, length=length)
        L.sequence_scatter(x, L.cast(ids, "int64"), x)
        L.sequence_enumerate(ids, 3, length=length)
        L.sequence_erase(ids, [1, 2], length=length)
        L.lod_reset(x, target_lod=[0, 2, 5])
        L.row_conv(x, 2, act="tanh", length=length)
        seq = L.im2sequence(img, filter_size=[3, 2], stride=[1, 2],
                            padding=[1, 0, 2, 1])
        L.add_position_encoding(x, alpha=0.5, beta=2.0)
        order = L.lod_rank_table(length)
        L.reorder_lod_tensor_by_rank(x, order)
    return main, startup, seq


def test_sequence_layers_programs_byte_identical():
    with junique.guard():
        jm, js, jseq_var = _layers_program(fluid)
    with punique.guard():
        pm, ps, pseq_var = _layers_program(pt)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    assert ps.desc.to_bytes() == js.desc.to_bytes()
    # im2sequence's declared shape: rows of every image, C * kh * kw wide
    assert list(pseq_var.shape) == list(jseq_var.shape) == [-1, 18]
