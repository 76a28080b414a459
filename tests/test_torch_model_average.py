"""``ModelAverage`` and ``average_accumulates`` in the port against the JAX
package, on the CPU.

- **The EMA.** A two-layer regression net, SGD, then ``ModelAverage(0.15)``
  built after ``minimize``: the programs the JAX package's, byte for byte;
  EMA_STEPS steps from the JAX package's initial state (the zero
  accumulators included): the losses and every EMA within EMA_REL of the
  JAX package's, relative.
- **apply.** Inside ``with model_average.apply(exe)`` every parameter holds
  its EMA (bitwise) and the test program's output is within EMA_REL of the
  JAX package's inside its own ``apply``; after it each parameter is
  bitwise what it was, and the same tensor (copied in place, so a
  captured graph over it is kept). ``need_restore=False`` leaves the EMAs
  in.
- **average_accumulates.** The op's emitters in both packages with the
  counters set just before the kMaxNumAccumulates (16384) drain and just
  before a window roll, and tests/test_ops_coverage.py's sliding window
  over several steps: the sums within FWD_REL, the counters equal (int64
  in the port, int32 in the JAX package).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.utils import unique_name as junique

import paddle_tpu_torch as pt
from paddle_tpu_torch.utils import unique_name as punique

from test_torch_tensor_ops import (_append, _no_callstack,  # noqa: F401
                                   assert_outputs_match, run_both)

EMA_STEPS = 5
EMA_REL = 1e-6
FWD_REL = 1e-6


def _net(fl):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 17
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", shape=[5], dtype="float32")
        y = fl.layers.data("y", shape=[1], dtype="float32")
        h = fl.layers.fc(x, size=8, act="tanh")
        pred = fl.layers.fc(h, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        test = main.clone(for_test=True)
        fl.optimizer.SGD(learning_rate=0.2).minimize(loss)
        ma = fl.optimizer.ModelAverage(0.15, min_average_window=10000,
                                       max_average_window=12500)
    return dict(main=main, startup=startup, test=test, pred=pred, loss=loss,
                ma=ma)


def _feed(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(12, 5).astype(np.float32),
            "y": rng.randn(12, 1).astype(np.float32)}


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


@pytest.fixture
def trained():
    with junique.guard():
        j = _net(fluid)
    with punique.guard():
        p = _net(pt)
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jexe.run(j["startup"], scope=jscope)
    names = [v.name for v in p["main"].list_vars() if v.persistable]
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in names}, "cpu",
        program=p["main"])
    losses = []
    for step in range(EMA_STEPS):
        feed = _feed(step)
        (a,) = jexe.run(j["main"], feed=feed, fetch_list=[j["loss"].name],
                        scope=jscope)
        (b,) = pexe.run(p["main"], feed=feed, fetch_list=[p["loss"].name],
                        scope=pscope)
        losses.append((np.asarray(b), np.asarray(a)))
    return dict(j=j, p=p, jscope=jscope, pscope=pscope, jexe=jexe,
                pexe=pexe, losses=losses)


def test_programs_bytes_identical():
    with junique.guard():
        j = _net(fluid)
    with punique.guard():
        p = _net(pt)
    assert p["main"].desc.to_bytes() == j["main"].desc.to_bytes()
    assert p["startup"].desc.to_bytes() == j["startup"].desc.to_bytes()
    types = [o.type for o in p["main"].global_block().desc.ops]
    # one scale, scale, elementwise_add per parameter after the updates
    assert types[-12:] == ["scale", "scale", "elementwise_add"] * 4
    assert len(p["ma"]._ema) == 4


def test_ema_steps_match_jax(trained):
    for got, want in trained["losses"]:
        assert _rel(got, want) <= EMA_REL
    p, pscope, jscope = trained["p"], trained["pscope"], trained["jscope"]
    for pname, ema in p["ma"]._ema.items():
        got = pscope.find_var(ema.name).numpy()
        assert _rel(got, jscope.find_var(ema.name)) <= EMA_REL, pname
        assert np.abs(got).max() > 0, pname


def test_apply_swaps_in_place_and_restores(trained):
    j, p = trained["j"], trained["p"]
    pscope, jscope = trained["pscope"], trained["jscope"]
    feed = {"x": _feed(9)["x"]}
    params = list(p["ma"]._ema)
    tensors = {n: pscope.find_var(n) for n in params}
    before = {n: t.clone() for n, t in tensors.items()}
    with fluid.scope_guard(jscope), j["ma"].apply(trained["jexe"]):
        (want,) = trained["jexe"].run(j["test"], feed=feed,
                                      fetch_list=[j["pred"].name])
    with pt.scope_guard(pscope), p["ma"].apply(trained["pexe"]):
        for n, ema in p["ma"]._ema.items():
            assert pscope.find_var(n) is tensors[n]
            assert torch.equal(tensors[n], pscope.find_var(ema.name))
        (got,) = trained["pexe"].run(p["test"], feed=feed,
                                     fetch_list=[p["pred"].name])
    assert _rel(got, want) <= EMA_REL
    for n in params:
        assert pscope.find_var(n) is tensors[n]
        assert torch.equal(tensors[n], before[n]), n
    with pt.scope_guard(pscope), p["ma"].apply(trained["pexe"],
                                               need_restore=False):
        pass
    for n, ema in p["ma"]._ema.items():
        assert torch.equal(pscope.find_var(n), pscope.find_var(ema.name))


# ---------------------------------------------------------------------------
# average_accumulates
# ---------------------------------------------------------------------------

def _acc_ins(p, s1, s2, s3, na, no, nu):
    f = np.float32
    return {"Param": [np.asarray(p, f)], "in_sum_1": [np.asarray(s1, f)],
            "in_sum_2": [np.asarray(s2, f)], "in_sum_3": [np.asarray(s3, f)],
            "in_num_accumulates": [np.array([na], np.int64)],
            "in_old_num_accumulates": [np.array([no], np.int64)],
            "in_num_updates": [np.array([nu], np.int64)]}


_P = np.random.RandomState(3).randn(3, 4).astype(np.float32)
ACC_CASES = [
    # the update that reaches 16384 drains sum_1 into sum_2
    ("before_drain", _acc_ins(_P, _P * 5, _P * 7, _P, 40, 0, 16383),
     {"average_window": 0.15, "max_average_window": 12500,
      "min_average_window": 10000}),
    ("at_drain_and_roll", _acc_ins(_P, _P * 5, _P * 7, _P, 12499, 3, 16383),
     {"average_window": 0.15, "max_average_window": 12500,
      "min_average_window": 10000}),
    # num_accumulates reaches min(max window, num_updates * rate): a roll
    ("before_roll", _acc_ins(_P, _P * 2, _P * 3, _P * 4, 9999, 7, 60000),
     {"average_window": 0.15, "max_average_window": 12500,
      "min_average_window": 10000}),
    ("short_of_roll", _acc_ins(_P, _P * 2, _P * 3, _P * 4, 9998, 7, 60000),
     {"average_window": 0.15, "max_average_window": 12500,
      "min_average_window": 10000}),
    # the float32 window: 66666 * 0.15 = 9999.9, truncated to 9999
    ("window_truncated", _acc_ins(_P, _P, _P, _P, 9998, 0, 66665),
     {"average_window": 0.15, "max_average_window": 12500,
      "min_average_window": 100}),
]


@pytest.mark.parametrize("case", ACC_CASES, ids=[c[0] for c in ACC_CASES])
def test_average_accumulates_matches_jax(case):
    _, ins, attrs = case
    j, p = run_both("average_accumulates", ins, attrs)
    assert_outputs_match(j, p, rel=FWD_REL)
    for slot in ("out_num_accumulates", "out_old_num_accumulates",
                 "out_num_updates"):
        assert p[slot][0].dtype == np.int64, slot


def test_average_accumulates_boundaries_do_what_they_say():
    _, drain, attrs = ACC_CASES[0]
    _, p = run_both("average_accumulates", drain, attrs)
    assert not p["out_sum_1"][0].any()
    np.testing.assert_array_equal(p["out_sum_2"][0],
                                  drain["in_sum_2"][0] + (
                                      drain["in_sum_1"][0] + _P))
    _, roll, attrs = ACC_CASES[2]
    _, p = run_both("average_accumulates", roll, attrs)
    assert p["out_num_accumulates"][0].tolist() == [0]
    assert p["out_old_num_accumulates"][0].tolist() == [10000]
    np.testing.assert_array_equal(p["out_sum_3"][0],
                                  (roll["in_sum_1"][0] + _P)
                                  + roll["in_sum_2"][0])
    _, short, attrs = ACC_CASES[3]
    _, p = run_both("average_accumulates", short, attrs)
    assert p["out_num_accumulates"][0].tolist() == [9999]


def test_average_accumulates_window_slides_as_jax():
    """tests/test_ops_coverage.py's sliding window, stepped in both."""
    attrs = {"average_window": 1.0, "max_average_window": 2,
             "min_average_window": 1}
    state = (0.0, 0.0, 0.0, 0, 0, 0)
    for step, pv in enumerate((10.0, 20.0, 30.0, 40.0, 50.0)):
        ins = _acc_ins([pv], [state[0]], [state[1]], [state[2]], *state[3:])
        j, p = run_both("average_accumulates", ins, attrs)
        assert_outputs_match(j, p, rel=FWD_REL)
        state = tuple(float(p[s][0][0]) for s in (
            "out_sum_1", "out_sum_2", "out_sum_3")) + tuple(
            int(p[s][0][0]) for s in ("out_num_accumulates",
                                      "out_old_num_accumulates",
                                      "out_num_updates"))
    assert state[5] == 5


def test_average_accumulates_desc_bytes_match_jax():
    f, i = "float32", "int64"
    ins = {"Param": [("p", [3, 4], f)], "in_sum_1": [("s1", [3, 4], f)],
           "in_sum_2": [("s2", [3, 4], f)], "in_sum_3": [("s3", [3, 4], f)],
           "in_num_accumulates": [("na", [1], i)],
           "in_old_num_accumulates": [("no", [1], i)],
           "in_num_updates": [("nu", [1], i)]}
    outs = {"out_sum_1": ["o1"], "out_sum_2": ["o2"], "out_sum_3": ["o3"],
            "out_num_accumulates": ["ona"],
            "out_old_num_accumulates": ["ono"],
            "out_num_updates": ["onu"]}
    attrs = {"average_window": 0.15, "max_average_window": 12500,
             "min_average_window": 10000}
    with junique.guard():
        jp = _append(fluid, "average_accumulates", ins, outs, dict(attrs))
    with punique.guard():
        pp = _append(pt, "average_accumulates", ins, outs, dict(attrs))
    assert pp.desc.to_bytes() == jp.desc.to_bytes()
