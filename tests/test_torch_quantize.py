"""Quantization in the port against the JAX package, on the CPU.

- **Ops.** The 8 types of ``paddle_tpu/ops/kernels_quant.py`` through
  both packages' emitters on the same seeded inputs: float outputs within
  FWD_REL of each output's largest magnitude, integer outputs equal. The
  three ``fake_quantize_*`` types write the same straight-through grad
  desc (``assign_grad_through``), which passes the cotangent unchanged;
  ``fake_dequantize_max_abs``'s generic vjp matches the JAX package's.
  One op of each type, appended by hand, gives the same program bytes.
- **Transpile.** ``QuantizeTranspiler.training_transpile`` after
  ``minimize`` and before it, for each activation type: the programs the
  JAX package's, byte for byte. The transpile rewrites the block's desc
  alone, and ``append_backward`` walks the block's operators, which do
  not hold the quant ops: after ``minimize`` the grad ops read the
  unquantized names, and before it the backward stops at the first
  quantized name (only the last layer's bias trains). In neither order
  does ``assign_grad_through`` run, in both packages. A fake-quant op
  appended through the Block API is on the backward's path: its
  straight-through grad then runs, and a QAT step of such a program
  matches the JAX package's.
- **QAT.** A narrow net of ``conv2d`` + ``batch_norm``,
  ``depthwise_conv2d`` and an ``fc`` (``mul``), QAT_STEPS Momentum steps
  from the JAX package's initial state (its startup run, the zero scales
  the transpile put in its scope included): the losses, the parameters,
  the velocities and the moving scales within QAT_REL of the JAX
  package's, relative.
- **Freeze.** The test clone transpiled and frozen from the same trained
  state: the program bytes and the int8 weights the JAX package's, bit
  for bit (both quantize in float64 numpy). Saved by the JAX package and
  served by the port's ``AnalysisPredictor`` and ``NativePredictor``.
  A frozen conv's filter is a ``dequantize_weights`` output: the JAX
  ``conv_bn_fuse_pass`` looks it up in the scope and raises, the port's
  leaves that conv and its batch_norm as they are. So the port's
  rewritten op list (the fc fusion over a dequantized weight included)
  is the JAX ``AnalysisPredictor``'s without that pass, the outputs
  within SERVE_REL of its outputs, and the frozen output within
  FROZEN_REL of the float test program's (the JAX test's bound).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import inference as jinference
from paddle_tpu import registry as jreg
from paddle_tpu.contrib.quantize import QuantizeTranspiler as JQT
from paddle_tpu.utils import unique_name as junique

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference as pinference
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.contrib.quantize import QuantizeTranspiler as PQT
from paddle_tpu_torch.utils import unique_name as punique

from test_torch_ir import assert_same_ops
from test_torch_tensor_ops import (_append, _no_callstack,  # noqa: F401
                                   assert_outputs_match, assert_vjp_match,
                                   run_both)

FWD_REL = 1e-6
QAT_REL = 1e-5
SERVE_REL = 1e-5
FROZEN_REL = 0.1
QAT_STEPS = 3
ACT_TYPES = ("abs_max", "range_abs_max", "moving_average_abs_max")
NEW_QUANT = ("fake_quantize_abs_max", "fake_quantize_range_abs_max",
             "fake_quantize_moving_average_abs_max",
             "fake_dequantize_max_abs", "dequantize_weights",
             "assign_grad_through", "quantize", "dequantize")
STE_TYPES = NEW_QUANT[:3]

_R = np.random.RandomState(2121)


def _f(*shape, scale=1.0):
    return (_R.randn(*shape) * scale).astype(np.float32)


X = _f(4, 3, 5, 5)
CASES = [
    ("abs_max", "fake_quantize_abs_max", {"X": [X]}, {"bit_length": 8}),
    ("abs_max_4bit", "fake_quantize_abs_max", {"X": [X]}, {"bit_length": 4}),
    ("abs_max_zero", "fake_quantize_abs_max",
     {"X": [np.zeros((3, 4), np.float32)]}, {}),
    ("range_first", "fake_quantize_range_abs_max",
     {"X": [X], "InScale": [np.zeros(1, np.float32)]},
     {"bit_length": 8, "moving_rate": 0.9, "is_test": False}),
    ("range_moving", "fake_quantize_range_abs_max",
     {"X": [X], "InScale": [np.array([1.7], np.float32)]},
     {"bit_length": 8, "moving_rate": 0.9, "is_test": False}),
    ("moving_average", "fake_quantize_moving_average_abs_max",
     {"X": [X], "InScale": [np.array([2.3], np.float32)]},
     {"bit_length": 8, "moving_rate": 0.95, "is_test": False}),
    ("moving_average_test", "fake_quantize_moving_average_abs_max",
     {"X": [X], "InScale": [np.array([1.1], np.float32)]},
     {"bit_length": 8, "moving_rate": 0.9, "is_test": True}),
    ("dequant_max_abs", "fake_dequantize_max_abs",
     {"X": [np.round(_f(6, 7) * 40)], "Scale": [np.array([0.37],
                                                          np.float32)]},
     {"max_range": 127.0}),
    ("dequantize_weights", "dequantize_weights",
     {"X": [_R.randint(-127, 128, (5, 6)).astype(np.int8)],
      "Scale": [np.array([0.61], np.float32)]}, {"max_range": 127.0}),
    ("assign_grad_through", "assign_grad_through",
     {"Out@GRAD": [_f(3, 4)]}, {}),
    ("quantize", "quantize", {"Input": [_f(4, 9, scale=3.0)]},
     {"Scale": 41.5}),
    ("dequantize", "dequantize",
     {"Input": [_R.randint(-128, 128, (4, 9)).astype(np.int8)]},
     {"Scale": 41.5}),
]


def test_cases_cover_the_8_types():
    assert {c[1] for c in CASES} == set(NEW_QUANT)
    for t in NEW_QUANT:
        p, j = preg.lookup(t), jreg.lookup(t)
        assert p.emitter is not None and j.emitter is not None
        assert (p.no_grad, p.intermediate_outputs) == (
            j.no_grad, j.intermediate_outputs), t


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_quant_op_matches_jax(case):
    _, op_type, ins, attrs = case
    j, p = run_both(op_type, ins, attrs)
    assert sorted(p) == sorted(j)
    assert_outputs_match(j, p, rel=FWD_REL)


def test_quant_op_is_test_flag_from_the_context():
    """ctx.is_test freezes a stateful scale as the attr does."""
    ins = {"X": [X], "InScale": [np.array([0.9], np.float32)]}
    attrs = {"bit_length": 8, "moving_rate": 0.9, "is_test": False}
    j, p = run_both("fake_quantize_range_abs_max", ins, attrs, is_test=True)
    assert_outputs_match(j, p, rel=FWD_REL)
    assert p["OutScale"][0].tolist() == [np.float32(0.9)]


def test_rounding_is_half_to_even():
    """The values on a .5 boundary round as jnp.round and np.round do."""
    ins = {"Input": [np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                                127.5, -128.5]], np.float32)]}
    j, p = run_both("quantize", ins, {"Scale": 1.0})
    assert p["Output"][0].tolist() == j["Output"][0].tolist() == [
        [0, 2, 2, 0, -2, -2, 126, 127, -128]]


@pytest.mark.parametrize("op_type", STE_TYPES)
def test_ste_grad_desc_and_vjp_match_jax(op_type):
    """The straight-through estimator: the same grad desc, and its op
    passes Out@GRAD to X@GRAD unchanged in both packages."""
    from paddle_tpu.core.desc import OpDesc as JOpDesc
    from paddle_tpu_torch.core.desc import OpDesc as POpDesc
    ins = {"X": ["x"]}
    if op_type != "fake_quantize_abs_max":
        ins["InScale"] = ["s"]
    outs = {"Out": ["x.q"], "OutScale": ["s"]}
    jg, jmap = jreg.lookup(op_type).grad_maker(
        JOpDesc(op_type, ins, outs, {}), set())
    pg, pmap = preg.lookup(op_type).grad_maker(
        POpDesc(op_type, ins, outs, {}), set())
    assert [(g.type, g.inputs, g.outputs, g.attrs) for g in pg] == [
        (g.type, g.inputs, g.outputs, g.attrs) for g in jg]
    assert pmap == jmap == {"x@GRAD": "x"}
    assert preg.lookup(op_type).grad_maker(
        POpDesc(op_type, ins, outs, {}), {"x"}) == ([], {})
    g = _f(4, 3, 5, 5)
    j, p = run_both(pg[0].type, {"Out@GRAD": [g]}, {})
    assert p["X@GRAD"][0].tolist() == j["X@GRAD"][0].tolist() == g.tolist()


def test_fake_dequantize_vjp_matches_jax():
    assert_vjp_match("fake_dequantize_max_abs",
                     {"X": [_f(6, 7)], "Scale": [np.array([0.37],
                                                          np.float32)]},
                     {"max_range": 127.0})


F32, I8 = "float32", "int8"
DESC_CASES = {
    "fake_quantize_abs_max": ({"X": [("x", [4, 6], F32)]},
                              {"Out": ["o"], "OutScale": ["s"]},
                              {"bit_length": 8}),
    "fake_quantize_range_abs_max": (
        {"X": [("x", [4, 6], F32)], "InScale": [("s", [1], F32)]},
        {"Out": ["o"], "OutScale": ["s"]},
        {"bit_length": 8, "moving_rate": 0.9, "is_test": False}),
    "fake_quantize_moving_average_abs_max": (
        {"X": [("x", [2, 3, 4], F32)], "InScale": [("s", [1], F32)]},
        {"Out": ["o"], "OutScale": ["s"]},
        {"bit_length": 4, "moving_rate": 0.8, "is_test": True}),
    "fake_dequantize_max_abs": ({"X": [("x", [4, 6], F32)],
                                 "Scale": [("s", [1], F32)]},
                                {"Out": ["o"]}, {"max_range": 127.0}),
    "dequantize_weights": ({"X": [("x", [4, 6], I8)],
                            "Scale": [("s", [1], F32)]},
                           {"Out": ["o"]}, {"max_range": 127.0}),
    "assign_grad_through": ({"Out@GRAD": [("g", [3, 5], F32)]},
                            {"X@GRAD": ["xg"]}, {}),
    "quantize": ({"Input": [("x", [3, 5], F32)]}, {"Output": ["o"]},
                 {"Scale": 3.0}),
    "dequantize": ({"Input": [("x", [3, 5], I8)]}, {"Output": ["o"]},
                   {"Scale": 3.0}),
}


@pytest.mark.parametrize("op_type", sorted(DESC_CASES))
def test_quant_op_desc_bytes_match_jax(op_type):
    ins, outs, attrs = DESC_CASES[op_type]
    with junique.guard():
        j = _append(fluid, op_type, ins, outs, dict(attrs))
    with punique.guard():
        p = _append(pt, op_type, ins, outs, dict(attrs))
    assert p.desc.to_bytes() == j.desc.to_bytes()


# ---------------------------------------------------------------------------
# the transpiler, QAT and the freeze
# ---------------------------------------------------------------------------

def _net(fl):
    """conv2d + batch_norm, a depthwise conv (groups = channels) and an
    fc on [3, 8, 8] images, 5 classes."""
    L = fl.layers
    img = L.data("img", shape=[3, 8, 8], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    c = L.conv2d(img, num_filters=4, filter_size=3, padding=1,
                 bias_attr=False)
    c = L.batch_norm(c, act="relu")
    d = L.conv2d(c, num_filters=4, filter_size=3, padding=1, groups=4,
                 act="relu")
    p = L.pool2d(d, pool_size=2, pool_stride=2)
    pred = L.fc(p, size=5, act="softmax")
    return pred, L.mean(L.cross_entropy(pred, label))


def _build(fl, qt_cls, act, order, place):
    """(main, startup, test clone, pred, loss, transpiler): ``order``
    "after" transpiles after minimize, "before" between the forward and
    minimize (the grad ops then read the quantized names)."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 9
    t = qt_cls(activation_quantize_type=act)
    kw = {} if place is None else {"place": place}
    with fl.program_guard(main, startup):
        pred, loss = _net(fl)
        test = main.clone(for_test=True)
        if order == "before":
            t.training_transpile(main, **kw)
        fl.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(
            loss)
    if order == "after":
        t.training_transpile(main, **kw)
    return main, startup, test, pred, loss, t


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(6, 3, 8, 8).astype(np.float32),
            "label": rng.randint(0, 5, (6, 1)).astype(np.int64)}


def _persistables(program):
    return [v.name for v in program.list_vars() if v.persistable]


def _copy_jax_state(jscope, pscope, pmain):
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n))
                 for n in _persistables(pmain)}, "cpu", program=pmain)


def _rel(got, want):
    top = float(np.abs(want).max()) if want.size else 0.0
    return float(np.abs(got - want).max()) / max(top, 1e-30)


def _qat(act, order):
    """Both packages built, transpiled, their states equal; returns the
    pieces."""
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    with fluid.scope_guard(jscope), junique.guard():
        j = _build(fluid, JQT, act, "before" if order == "before" else None,
                   None)
        jexe.run(j[1])
        if order == "after":
            j[5].training_transpile(j[0])
    with pt.scope_guard(pscope), punique.guard():
        p = _build(pt, PQT, act, "before" if order == "before" else None,
                   pt.CPUPlace())
        if order == "after":
            p[5].training_transpile(p[0], place=pt.CPUPlace())
    _copy_jax_state(jscope, pscope, p[0])
    return j, p, jscope, pscope, jexe, pexe


@pytest.mark.parametrize("order", ["after", "before"])
@pytest.mark.parametrize("act", ACT_TYPES)
def test_transpiled_programs_bytes_identical(act, order):
    j, p, *_ = _qat(act, order)
    assert p[0].desc.to_bytes() == j[0].desc.to_bytes()
    assert p[1].desc.to_bytes() == j[1].desc.to_bytes()
    types = [o.type for o in p[0].global_block().desc.ops]
    quants = [t for t in types if t.startswith("fake_quantize_")]
    # the image, the two conv outputs' relu'd inputs and the pool output,
    # and the three weights
    assert len(quants) == 6
    # the backward walks the block's operators, which the desc rewrite
    # does not extend (the JAX package's behaviour)
    assert "assign_grad_through" not in types
    assert types.count("momentum") == (1 if order == "before" else 7)


@pytest.mark.parametrize("order", ["after", "before"])
@pytest.mark.parametrize("act", ACT_TYPES)
def test_qat_steps_match_jax(act, order):
    j, p, jscope, pscope, jexe, pexe = _qat(act, order)
    feed = _batch(3)
    names = _persistables(p[0])
    for step in range(QAT_STEPS):
        (jl,) = jexe.run(j[0], feed=feed, fetch_list=[j[4].name],
                         scope=jscope)
        (pl,) = pexe.run(p[0], feed=feed, fetch_list=[p[4].name],
                         scope=pscope)
        assert _rel(np.asarray(pl), np.asarray(jl)) <= QAT_REL, step
    scales = [n for n in names if n.endswith(".quant_scale")]
    assert len(scales) == (0 if act == "abs_max" else 3)
    for n in names:
        got = pscope.find_var(n).numpy()
        assert _rel(got, np.asarray(jscope.find_var(n))) <= QAT_REL, n
    for n in scales:
        assert pscope.find_var(n).numpy()[0] > 0, n


def _ste_program(fl):
    """An fc, a fake quant appended through the Block API (so the
    backward reaches it), an fc, a squared error; SGD."""
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 11
    with fl.program_guard(main, startup):
        x = L.data("x", shape=[6], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        h = L.fc(x, size=8, act="relu")
        blk = main.global_block()
        q = blk.create_var(name="h.q", dtype="float32", shape=h.shape)
        s = blk.create_var(name="h.s", dtype="float32", shape=[1],
                           persistable=True)
        blk.append_op(type="fake_quantize_moving_average_abs_max",
                      inputs={"X": h, "InScale": s},
                      outputs={"Out": q, "OutScale": s},
                      attrs={"bit_length": 8, "moving_rate": 0.9,
                             "is_test": False})
        loss = L.mean(L.square_error_cost(L.fc(q, size=1), y))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_block_api_quant_runs_the_ste_grad_as_jax():
    with junique.guard():
        jm, js, jl = _ste_program(fluid)
    with punique.guard():
        pm, ps, pl = _ste_program(pt)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    types = [o.type for o in pm.global_block().desc.ops]
    assert types.count("assign_grad_through") == 1
    assert types.count("sgd") == 4
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jexe.run(js, scope=jscope)
    jscope.set_var("h.s", np.zeros(1, np.float32))
    _copy_jax_state(jscope, pscope, pm)
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(16, 6).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}
    w0 = pscope.find_var("fc_0.w_0").clone()
    for step in range(QAT_STEPS):
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jl.name], scope=jscope)
        (b,) = pexe.run(pm, feed=feed, fetch_list=[pl.name], scope=pscope)
        assert _rel(np.asarray(b), np.asarray(a)) <= QAT_REL, step
    for n in _persistables(pm):
        assert _rel(pscope.find_var(n).numpy(),
                    np.asarray(jscope.find_var(n))) <= QAT_REL, n
    # the gradient reached the first fc through the quant op
    assert not torch.equal(pscope.find_var("fc_0.w_0"), w0)


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    """QAT (moving_average_abs_max, transpiled after minimize) trained in
    the JAX package, the port's state made equal to it, then both test
    clones transpiled and frozen; the JAX one saved as an inference
    model, and the JAX AnalysisPredictor's op list and output."""
    j, p, jscope, pscope, jexe, pexe = _qat("moving_average_abs_max",
                                            "after")
    feed = _batch(5)
    for _ in range(QAT_STEPS):
        jexe.run(j[0], feed=feed, fetch_list=[j[4].name], scope=jscope)
    _copy_jax_state(jscope, pscope, p[0])
    with fluid.scope_guard(jscope):
        (float_out,) = jexe.run(j[2], feed={"img": feed["img"]},
                                fetch_list=[j[3].name])
        j[5].training_transpile(j[2])
        j[5].freeze_program(j[2])
    with pt.scope_guard(pscope):
        p[5].training_transpile(p[2], place=pt.CPUPlace())
        p[5].freeze_program(p[2])
    d = str(tmp_path_factory.mktemp("jax_frozen"))
    with fluid.scope_guard(jscope):
        fluid.io.save_inference_model(d, ["img"], [j[3]], jexe,
                                      main_program=j[2])
    with pytest.raises(ValueError):
        # the JAX conv_bn_fuse_pass folds into a filter it looks up in the
        # scope; a frozen conv's filter is a dequantize_weights output
        jinference.create_paddle_predictor(jinference.AnalysisConfig(d))
    cfg = jinference.AnalysisConfig(d)
    cfg.pass_builder_set([n for n in cfg.passes if n != "conv_bn_fuse_pass"])
    jpred = jinference.create_paddle_predictor(cfg)
    served = np.asarray(jpred.run({"img": feed["img"]})[0].data)
    return {"j": j, "p": p, "jscope": jscope, "pscope": pscope, "dir": d,
            "feed": feed, "float": np.asarray(float_out), "served": served,
            "ops": list(jpred._program.global_block().desc.ops)}


def test_frozen_program_and_int8_weights_match_jax(frozen):
    j, p = frozen["j"], frozen["p"]
    assert p[2].desc.to_bytes() == j[2].desc.to_bytes()
    types = [o.type for o in p[2].global_block().desc.ops]
    assert types.count("dequantize_weights") == 3
    assert not any(o.type.startswith("fake_quantize_") and
                   not o.attrs.get("is_test")
                   for o in p[2].global_block().desc.ops
                   if "InScale" in o.inputs)
    int8 = [n for n in p[2].global_block().desc.vars if n.endswith(".int8")]
    assert len(int8) == 3
    for n in int8:
        got = frozen["pscope"].find_var(n)
        assert got.dtype == torch.int8
        want = np.asarray(frozen["jscope"].find_var(n))
        assert want.dtype == np.int8
        assert np.array_equal(got.numpy(), want), n
        scale = n[:-len(".int8")] + ".quant_scale"
        assert np.array_equal(frozen["pscope"].find_var(scale).numpy(),
                              np.asarray(frozen["jscope"].find_var(scale)))


def test_frozen_model_served_as_jax(frozen):
    pred = pinference.create_paddle_predictor(
        pinference.AnalysisConfig(frozen["dir"], use_gpu=False))
    ops = list(pred._program.global_block().desc.ops)
    assert_same_ops(frozen["ops"], ops)
    types = [o.type for o in ops]
    assert types.count("dequantize_weights") == 3 and "fc" in types
    assert "batch_norm" in types
    feed = {"img": frozen["feed"]["img"]}
    got = pred.run(feed)[0].as_ndarray()
    assert _rel(got, frozen["served"]) <= SERVE_REL
    native = pinference.create_paddle_predictor(
        pinference.NativeConfig(frozen["dir"], use_gpu=False))
    assert _rel(native.run(feed)[0].as_ndarray(), frozen["served"]) \
        <= SERVE_REL
    err = np.abs(got - frozen["float"]).max() / (
        np.abs(frozen["float"]).max() + 1e-6)
    assert err < FROZEN_REL, err
