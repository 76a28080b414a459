"""Conditional control flow and the LoD-array ops of the port against the
JAX package, on the CPU.

- **Ops.** Each of the 13 control types ported here (``conditional_block``
  through a hand-built program, as a program loaded from elsewhere holds
  it; the rest through both packages' emitters, the host array ops
  through both executors too) and ``is_empty``: integer and bool outputs
  equal, float outputs within FWD_REL of each output's largest
  magnitude; the gradful types' generic vjps within GRAD_REL.
- **IfElse.** Forward and the gradient of its input, and its program
  byte-identical.
- **Switch.** The first true case wins, a true case that writes nothing
  still blocks the later ones, a variable created in a case raises when
  read (ValueError) or fetched (KeyError), and the case guards raise
  outside the switch.
- **The IfElse MNIST program** (``testing.models.if_else_mnist``: Fluid's
  test_mnist_if_else_op.py, driven by a Switch piecewise learning rate
  over three boundaries): byte-identical, then 6 steps from the JAX
  startup's parameters across two boundaries: losses within LOSS_REL
  relative, parameters within PARAM_REL of the largest magnitude, the
  learning rate equal to numpy's at every step, the merged rows equal to
  a numpy ``where`` of the two branches.
- **The JAX tests' data.** tests/test_control_flow.py's IfElse, Switch and
  LoD-compat cases through the port, against the values they assert.
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
from paddle_tpu_torch.testing import models as tmodels
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

from test_torch_sequence import _vjp_both, assert_outputs_match, run_both

FWD_REL = 1e-5
GRAD_REL = 1e-5
LOSS_REL = 1e-5
PARAM_REL = 1e-4
MNIST_SMALL = dict(hidden=16, in_dim=20, boundaries=(2, 4, 8))


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _f(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LENGTH = np.array([4, 2, 3, 0], np.int64)
MASK = np.array([True, False, True, False])

# (case id, op type, inputs, attrs, gradful)
CASES = [
    ("if_else", "if_else",
     {"Cond": [MASK.reshape(4, 1)], "TrueOut": [_f(1, 4, 3), _f(2, 4, 2, 2)],
      "FalseOut": [_f(3, 4, 3), _f(4, 4, 2, 2)]}, {}, True),
    ("switch_merge_scalar", "switch_merge",
     {"Conds": [np.array([False]), np.array([True]), np.array([True])],
      "X": [_f(5, 3), _f(6, 3), _f(7, 3)], "Default": [_f(8, 3)]}, {}, True),
    ("switch_merge_default", "switch_merge",
     {"Conds": [np.array([False]), np.array([False])],
      "X": [_f(9, 2, 2), _f(10, 2, 2)], "Default": [_f(11, 2, 2)]}, {},
     True),
    ("switch_merge_rows", "switch_merge",
     {"Conds": [np.array([[True], [False], [False]]),
                np.array([[False], [True], [False]])],
      "X": [_f(12, 3, 2), _f(13, 3, 2)], "Default": [_f(14, 3, 2)]}, {},
     True),
    ("max_sequence_len", "max_sequence_len", {"RankTable": [LENGTH]}, {},
     False),
    ("lod_tensor_to_array", "lod_tensor_to_array", {"X": [_f(15, 4, 5, 2)]},
     {}, True),
    ("array_to_lod_tensor", "array_to_lod_tensor", {"X": [_f(16, 5, 4, 2)]},
     {}, True),
    ("shrink_rnn_memory", "shrink_rnn_memory",
     {"X": [_f(17, 4, 3)], "RankTable": [LENGTH],
      "I": [np.array([2], np.int64)]}, {}, True),
    ("split_lod_tensor", "split_lod_tensor",
     {"X": [_f(18, 4, 3)], "Mask": [MASK.reshape(4, 1)]}, {}, False),
    ("merge_lod_tensor", "merge_lod_tensor",
     {"InTrue": [_f(19, 4, 3)], "InFalse": [_f(20, 4, 3)],
      "Mask": [MASK]}, {}, True),
    ("is_empty", "is_empty", {"X": [_f(21, 2, 3)]}, {}, False),
    ("is_empty_yes", "is_empty", {"X": [np.zeros((0, 3), np.float32)]}, {},
     False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_control_op_matches_jax(case):
    _, op_type, ins, attrs, _ = case
    j, p = run_both(op_type, ins, attrs)
    assert sorted(p) == sorted(j)
    assert_outputs_match(j, p)


GRAD_CASES = [c for c in CASES if c[4]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_control_op_vjp_matches_jax(case):
    _, op_type, ins, attrs, _ = case
    jouts, pouts = _vjp_both(op_type, ins, attrs, seed=5)
    checked = 0
    for slot, vals in ins.items():
        for i, v in enumerate(vals):
            if np.asarray(v).dtype.kind != "f":
                continue
            g = slot + "@GRAD"
            want = np.asarray(jouts[g][i])
            np.testing.assert_allclose(
                pouts[g][i].numpy(), want, rtol=0,
                atol=GRAD_REL * max(float(np.abs(want).max()), 1e-30),
                err_msg=g)
            checked += 1
    assert checked


def test_control_types_registered_like_jax():
    types = {c[1] for c in CASES} | {
        "conditional_block", "write_to_array", "read_from_array",
        "lod_array_length", "tensor_array_to_tensor"}
    assert len(types - {"is_empty"}) == 13
    for t in types:
        p, j = preg.lookup(t), jreg.lookup(t)
        assert (p.no_grad, p.is_host) == (j.no_grad, j.is_host), t


# ---------------------------------------------------------------------------
# the LoD tensor-array host ops through both executors
# ---------------------------------------------------------------------------

def _array_program(fl, use_stack):
    """write_to_array twice, lod_array_length, read_from_array and
    tensor_array_to_tensor, as ops of a loaded program."""
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        L = fl.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        y = L.data(name="y", shape=[3], dtype="float32")
        blk = main.global_block()
        i0 = L.fill_constant([1], "int64", 0)
        i1 = L.fill_constant([1], "int64", 1)
        for n in ("arr", "n", "r", "out", "idx"):
            blk.create_var(name=n, dtype="float32")
        blk.append_op(type="write_to_array", inputs={"X": [x], "I": [i0]},
                      outputs={"Out": ["arr"]})
        blk.append_op(type="write_to_array",
                      inputs={"X": [y], "I": [i1], "Array": ["arr"]},
                      outputs={"Out": ["arr"]})
        blk.append_op(type="lod_array_length", inputs={"X": ["arr"]},
                      outputs={"Out": ["n"]})
        blk.append_op(type="read_from_array", inputs={"X": ["arr"],
                                                      "I": [i1]},
                      outputs={"Out": ["r"]})
        blk.append_op(type="tensor_array_to_tensor", inputs={"X": ["arr"]},
                      outputs={"Out": ["out"], "OutIndex": ["idx"]},
                      attrs={"axis": 1, "use_stack": use_stack})
    return main


@pytest.mark.parametrize("use_stack", [False, True], ids=["concat", "stack"])
def test_lod_array_host_ops_through_executors(use_stack):
    feed = {"x": _f(30, 2, 3), "y": _f(31, 2, 3)}
    fetch = ["n", "r", "out", "idx"]
    with junique.guard():
        jm = _array_program(fluid, use_stack)
    with punique.guard():
        pm = _array_program(pt, use_stack)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    jr = fluid.Executor(fluid.CPUPlace()).run(jm, feed=feed,
                                              fetch_list=fetch,
                                              scope=JScope())
    pexe = pt.Executor(pt.CPUPlace())
    pr = pexe.run(pm, feed=feed, fetch_list=fetch, scope=pt.Scope())
    for name, a, b in zip(fetch, jr, pr):
        a = np.asarray(a)
        assert b.shape == a.shape and b.tolist() == a.tolist(), name
    want = (np.stack if use_stack else np.concatenate)(
        [feed["x"], feed["y"]], axis=1)
    np.testing.assert_array_equal(pr[2], want)
    assert pr[0].tolist() == [2] and pr[0].dtype == np.int64
    # the host ops split the plan's segments
    plan = next(iter(pm.__dict__["_exec_cache"].values()))
    assert [k for k, _ in plan.segments].count("host") >= 1


def _dense_array_program(fl):
    """create_array, array_write, array_length, tensor_array_to_tensor over
    the dense array, is_empty, lod_rank_table and
    reorder_lod_tensor_by_rank, equal."""
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        L = fl.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        length = L.data(name="len", shape=[], dtype="int64")
        arr = L.create_array("float32", shape=[2, 3], max_len=3)
        i = L.fill_constant([1], "int64", 1)
        L.array_write(x, i, array=arr)
        n = L.array_length(arr)
        out, idx = L.tensor_array_to_tensor(arr, axis=0)
        empty = L.is_empty(x)
        order = L.lod_rank_table(length)
        reordered = L.reorder_lod_tensor_by_rank(x, order)
        same = L.equal(length, L.fill_constant([1], "int64", 3))
    return main, [n, out, idx, empty, order, reordered, same]


def test_dense_array_and_lod_layers_against_jax():
    with junique.guard():
        jm, jf = _dense_array_program(fluid)
    with punique.guard():
        pm, pf = _dense_array_program(pt)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    feed = {"x": _f(32, 2, 3), "len": np.array([3, 5], np.int64)}
    jr = fluid.Executor(fluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=[v.name for v in jf], scope=JScope())
    pr = pt.Executor(pt.CPUPlace()).run(
        pm, feed=feed, fetch_list=[v.name for v in pf], scope=pt.Scope())
    for v, a, b in zip(pf, jr, pr):
        a = np.asarray(a)
        assert b.shape == a.shape, v.name
        np.testing.assert_allclose(b, a, rtol=0, atol=0, err_msg=v.name)
    assert pr[1].shape == (6, 3) and pr[4].tolist() == [1, 0]


# ---------------------------------------------------------------------------
# conditional_block, built by hand (testing.models.conditional_block_program)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xv", [[-1.0, -2.0, 0.5], [1.0, 2.0, -0.5]],
                         ids=["taken", "not_taken"])
def test_conditional_block_against_jax(xv):
    with junique.guard():
        jm, jo = tmodels.conditional_block_program(fluid)
    with punique.guard():
        pm, po = tmodels.conditional_block_program(pt)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    feed = {"x": np.array(xv, np.float32)}
    (jv,) = fluid.Executor(fluid.CPUPlace()).run(jm, feed=feed,
                                                 fetch_list=[jo.name],
                                                 scope=JScope())
    (pv,) = pt.Executor(pt.CPUPlace()).run(pm, feed=feed,
                                           fetch_list=[po.name],
                                           scope=pt.Scope())
    want = (3 * feed["x"] + 1 if sum(xv) < 0
            else np.full(3, 0.5, np.float32))
    np.testing.assert_array_equal(pv, want)
    np.testing.assert_array_equal(pv, np.asarray(jv))


# ---------------------------------------------------------------------------
# IfElse
# ---------------------------------------------------------------------------

def _if_else_program(fl, grad):
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        L = fl.layers
        x = L.data("x", shape=[4], dtype="float32")
        x.desc.stop_gradient = False
        zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(L.reduce_sum(x, dim=1, keep_dim=True), zero)
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(ie.input(x), scale=-1.0))
        with ie.false_block():
            ie.output(L.scale(ie.input(x), scale=2.0))
        (out,) = ie()
        fetch = [out.name]
        if grad:
            loss = L.reduce_sum(L.elementwise_mul(out, out))
            fl.backward.append_backward(loss, parameter_list=[x.name])
            fetch.append(x.name + "@GRAD")
    return main, fetch


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "grad"])
def test_if_else_against_jax(grad):
    with junique.guard():
        jm, fetch = _if_else_program(fluid, grad)
    with punique.guard():
        pm, pfetch = _if_else_program(pt, grad)
    assert pfetch == fetch
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    xb = np.array([[1, 1, 1, 1], [-1, -2, 0, 0], [0.5, -3, 1, 1]],
                  np.float32)
    jr = fluid.Executor(fluid.CPUPlace()).run(jm, feed={"x": xb},
                                              fetch_list=fetch,
                                              scope=JScope())
    pr = pt.Executor(pt.CPUPlace()).run(pm, feed={"x": xb},
                                        fetch_list=fetch, scope=pt.Scope())
    neg = xb.sum(1, keepdims=True) < 0
    out = np.where(neg, -xb, 2 * xb)
    np.testing.assert_array_equal(pr[0], out)
    if grad:
        # d(sum out^2)/dx: -2 * out on the true rows, 4 * out on the others
        np.testing.assert_array_equal(pr[1], np.where(neg, -2 * out,
                                                      4 * out))
    for a, b in zip(jr, pr):
        np.testing.assert_array_equal(b, np.asarray(a))


# ---------------------------------------------------------------------------
# Switch (the cases of tests/test_control_flow.py, in both packages)
# ---------------------------------------------------------------------------

def _switch_program(fl, partial):
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        L = fl.layers
        T = L.tensor
        step = L.data("step", shape=[1], dtype="float32",
                      append_batch_size=False)
        a = T.fill_constant([1], "float32", -1.0)
        b = T.fill_constant([1], "float32", -2.0)
        one = T.fill_constant([1], "float32", 1.0)
        five = T.fill_constant([1], "float32", 5.0)
        with L.Switch() as switch:
            with switch.case(L.less_than(step, one)):
                T.assign(T.fill_constant([1], "float32", 10.0 if partial
                                         else 0.1), a)
            with switch.case(L.less_than(step, five)):
                T.assign(T.fill_constant([1], "float32", 20.0 if partial
                                         else 0.01), b if partial else a)
            with switch.default():
                T.assign(T.fill_constant([1], "float32", 30.0 if partial
                                         else 0.001), b if partial else a)
        outs = [L.scale(a, scale=1.0), L.scale(b, scale=1.0)]
    return main, [o.name for o in outs]


# (step, a, b) per program: the JAX tests' expectations
SWITCH_WANT = {
    "first_true": [(0.0, 0.1, -2.0), (3.0, 0.01, -2.0), (9.0, 0.001, -2.0)],
    "partial": [(0.0, 10.0, -2.0), (3.0, -1.0, 20.0), (9.0, -1.0, 30.0)],
}


@pytest.mark.parametrize("name", sorted(SWITCH_WANT))
def test_switch_against_jax(name):
    partial = name == "partial"
    with junique.guard():
        jm, fetch = _switch_program(fluid, partial)
    with punique.guard():
        pm, pfetch = _switch_program(pt, partial)
    assert pfetch == fetch
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    assert sum(o.type == "switch_merge"
               for o in pm.global_block().ops) == (2 if partial else 1)
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    for sv, wa, wb in SWITCH_WANT[name]:
        feed = {"step": np.array([sv], np.float32)}
        jr = jexe.run(jm, feed=feed, fetch_list=fetch, scope=JScope())
        pr = pexe.run(pm, feed=feed, fetch_list=fetch, scope=pt.Scope())
        assert [float(v.reshape(-1)[0]) for v in pr] == [
            float(np.float32(wa)), float(np.float32(wb))]
        for a, b in zip(jr, pr):
            assert b.tolist() == np.asarray(a).tolist()


def test_switch_case_local_var_escape_raises():
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        T = pt.layers.tensor
        step = pt.layers.data("step", shape=[1], dtype="float32",
                              append_batch_size=False)
        one = T.fill_constant([1], "float32", 1.0)
        with pt.layers.Switch() as switch:
            with switch.case(pt.layers.less_than(step, one)):
                leaked = T.fill_constant([1], "float32", 42.0)
            with switch.default():
                T.fill_constant([1], "float32", 0.0)
        with pytest.raises(ValueError, match="Switch case"):
            pt.layers.scale(leaked, scale=1.0)
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(KeyError, match="Switch case"):
        exe.run(main, feed={"step": np.array([0.0], np.float32)},
                fetch_list=[leaked.name], scope=pt.Scope())


def test_switch_outside_context_raises():
    sw = pt.layers.Switch()
    with pytest.raises(RuntimeError):
        with sw.default():
            pass
    with pytest.raises(RuntimeError):
        with sw.case(None):
            pass


# ---------------------------------------------------------------------------
# the IfElse MNIST program with the Switch learning rate
# ---------------------------------------------------------------------------

def _mnist_builds(**kw):
    with junique.guard():
        j = tmodels.if_else_mnist(fluid, **kw)
    with punique.guard():
        p = tmodels.if_else_mnist(pt, **kw)
    return j, p


@pytest.mark.parametrize("width", ["full", "small"])
def test_if_else_mnist_programs_byte_identical(width):
    j, p = _mnist_builds(**({} if width == "full" else MNIST_SMALL))
    for which in ("main", "startup"):
        assert p[which].desc.to_bytes() == j[which].desc.to_bytes(), which
    types = [o.type for o in p["main"].global_block().ops]
    assert types.count("switch_merge") == 1
    assert {"if_else", "if_else_grad", "momentum"} <= set(types)


def numpy_piecewise(step, boundaries, values):
    for b, v in zip(boundaries, values):
        if step < b:
            return np.float32(v)
    return np.float32(values[-1])


def test_if_else_mnist_trains_against_jax():
    j, p = _mnist_builds(**MNIST_SMALL)
    rng = np.random.RandomState(4)
    feed = {"img": rng.rand(16, MNIST_SMALL["in_dim"]).astype(np.float32),
            "label": rng.randint(0, 10, (16, 1)).astype(np.int64)}
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(j["startup"], scope=js)
    names = [v.name for v in p["startup"].list_vars() if v.persistable]
    ps = pt.Scope()
    pt.io.set_params_from_numpy(
        ps, {n: np.asarray(js.find_var(n)) for n in names}, "cpu",
        program=p["startup"])
    pexe = pt.Executor(pt.CPUPlace())
    fetch = [p["loss"].name, p["lr"].name, p["step"].name,
             p["prob"].name, p["true_out"], p["false_out"]]
    losses, lrs = [], []
    for _ in range(6):
        jr = jexe.run(j["main"], feed=feed, fetch_list=fetch, scope=js)
        pr = pexe.run(p["main"], feed=feed, fetch_list=fetch, scope=ps)
        losses.append((float(np.asarray(jr[0]).reshape(-1)[0]),
                       float(pr[0].reshape(-1)[0])))
        step = float(pr[2].reshape(-1)[0])
        lrs.append(float(pr[1].reshape(-1)[0]))
        assert pr[1].reshape(-1)[0] == numpy_piecewise(
            step, p["boundaries"], p["values"]), (step, pr[1])
        assert np.asarray(jr[1]).tolist() == pr[1].tolist()
        routed = feed["label"] < 5
        np.testing.assert_array_equal(pr[3], np.where(routed, pr[4], pr[5]))
    for jl, pl in losses:
        assert abs(pl - jl) <= LOSS_REL * abs(jl), losses
    assert losses[-1][1] < losses[0][1]
    # the steps cross two of the three boundaries
    assert len(set(lrs)) == 3, lrs
    diff = top = 0.0
    for n in names:
        a = np.asarray(js.find_var(n))
        if a.dtype.kind == "f":
            diff = max(diff, float(np.abs(ps.find_var(n).numpy() - a).max()))
            top = max(top, float(np.abs(a).max()))
    assert diff <= PARAM_REL * top, (diff, top)


def test_lod_compat_data_of_the_jax_test():
    """tests/test_control_flow.py::test_lod_machinery_compat_ops's data
    and assertions through the port's emitters."""
    ctx = preg.EmitContext(torch.device("cpu"))

    def run(t, ins):
        return preg.lookup(t).emitter(
            ctx, {k: [None if a is None else torch.from_numpy(np.asarray(a))
                      for a in v] for k, v in ins.items()}, {})

    x = np.arange(24, dtype=np.float32).reshape(3, 4, 2)
    length = np.array([4, 2, 3], np.int32)
    assert int(run("max_sequence_len", {"RankTable": [length]})
               ["Out"][0][0]) == 4
    arr = run("lod_tensor_to_array", {"X": [x]})["Out"][0]
    assert tuple(arr.shape) == (4, 3, 2)
    back = run("array_to_lod_tensor", {"X": [arr.numpy()]})["Out"][0]
    np.testing.assert_array_equal(back.numpy(), x)
    shr = run("shrink_rnn_memory", {"X": [x[:, 0]], "RankTable": [length],
                                    "I": [np.array([2])]})["Out"][0].numpy()
    assert np.all(shr[1] == 0)
    np.testing.assert_array_equal(shr[0], x[0, 0])
    mask = np.array([1, 0, 1], np.bool_)
    sp = run("split_lod_tensor", {"X": [x[:, 0]], "Mask": [mask]})
    tr, fl = sp["OutTrue"][0].numpy(), sp["OutFalse"][0].numpy()
    assert np.all(tr[1] == 0) and np.all(fl[0] == 0)
    mg = run("merge_lod_tensor", {"InTrue": [tr], "InFalse": [fl],
                                  "Mask": [mask], "X": [None]})["Out"][0]
    np.testing.assert_array_equal(mg.numpy(), x[:, 0])
