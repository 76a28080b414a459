"""The rest of the training API in the port against the JAX package's, on
the CPU: the math, gather/slice and optimizer ops the BERT slice
registers, every optimizer, each gradient clip, each regularizer, the
per-parameter learning rate and every LR schedule.

Ops: each emitter on the same numpy inputs and attrs as the JAX package's
(floats within 1e-6 absolute plus 1e-5 relative: the two differ at most in
an ulp of a transcendental; bools and integers exact), and for every op
with a grad, the generic vjp of both packages on the same cotangent at the
same bound. Ties (a clip at its bound, a max over equal values) are in the
inputs on purpose: both packages split the cotangent of a tie in half.

Training: a small fc regression net (two fc layers, a square-error loss)
built in both packages, byte-identical programs, the JAX package's
startup carried over as numpy arrays, 3 steps of the same seeded batches.
Losses within 1e-5 relative and every persistable within 1e-5 absolute
plus 1e-4 relative after the 3 steps (summation order only; ftrl's and
adadelta's steps divide by small accumulators, the bound covers them).
``fused_sgd`` is held bitwise against one ``sgd`` op per parameter.
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

RNG = np.random.RandomState(10)
ATOL, RTOL = 1e-6, 1e-5


def f32(*shape):
    return RNG.randn(*shape).astype(np.float32)


def pos(*shape):
    return (np.abs(RNG.randn(*shape)) + 0.2).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_callstacks():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

X = f32(3, 5)
TIES = np.array([[1.0, 2.0, 2.0, -0.5], [3.0, 3.0, 0.0, 0.5]], np.float32)
ACTS = {
    "sigmoid": ({}, X), "logsigmoid": ({}, X), "exp": ({}, X),
    "log": ({}, pos(3, 5)), "tanh": ({}, X), "tanh_shrink": ({}, X),
    "softshrink": ({"lambda": 0.3}, X), "sqrt": ({}, pos(3, 5)),
    "rsqrt": ({}, pos(3, 5)),
    # +0 and -0 among the inputs: JAX's abs passes the whole cotangent
    # there (ROADMAP C2)
    "abs": ({}, np.concatenate([X, [[0.0, -0.0, 1.0, -1.0, 0.0]]])
            .astype(np.float32)),
    "ceil": ({}, X * 3),
    "floor": ({}, X * 3), "cos": ({}, X), "sin": ({}, X),
    "round": ({}, np.array([[0.5, 1.5, -2.5, 2.4, -0.6]], np.float32)),
    "reciprocal": ({}, pos(3, 5)), "square": ({}, X), "softplus": ({}, X * 4),
    "softsign": ({}, X), "brelu": ({"t_min": -0.5, "t_max": 0.5}, X),
    "leaky_relu": ({"alpha": 0.1}, X), "soft_relu": ({"threshold": 1.0}, X),
    "elu": ({"alpha": 0.5}, X), "relu6": ({"threshold": 1.0}, X * 2),
    "swish": ({"beta": 1.5}, X), "hard_sigmoid": ({}, X * 4),
    "hard_swish": ({}, X * 4), "thresholded_relu": ({"threshold": 0.3}, X),
    "stanh": ({}, X), "gelu": ({}, X * 2),
}
OPS = {f"act_{k}": (k, {"X": [x]}, a) for k, (a, x) in ACTS.items()}
OPS.update({
    "act_gelu_approximate": ("gelu", {"X": [X * 2]}, {"approximate": True}),
    "act_relu6_ties": ("relu6", {"X": [np.array([[0.0, 6.0, 3.0]],
                                                 np.float32)]}, {}),
    "elementwise_sub_axis": ("elementwise_sub",
                             {"X": [f32(2, 3, 4)], "Y": [f32(3)]},
                             {"axis": 1}),
    "elementwise_max_ties": ("elementwise_max",
                             {"X": [TIES], "Y": [TIES[::-1].copy()]},
                             {"axis": -1}),
    "elementwise_pow": ("elementwise_pow", {"X": [pos(3, 4)],
                                            "Y": [f32(3, 4)]}, {"axis": -1}),
    "elementwise_mod": ("elementwise_mod",
                        {"X": [f32(3, 4) * 5], "Y": [pos(3, 4) * 2]},
                        {"axis": -1}),
    "elementwise_mod_int": ("elementwise_mod",
                            {"X": [np.array([7, -7, 5, -5], np.int32)],
                             "Y": [np.array([3, 3, -2, -2], np.int32)]},
                            {"axis": -1}),
    "elementwise_floordiv": ("elementwise_floordiv",
                             {"X": [np.array([7, -7, 5, -5], np.int32)],
                              "Y": [np.array([3, 3, -2, -2], np.int32)]},
                             {"axis": -1}),
    "reduce_mean_dim": ("reduce_mean", {"X": [f32(2, 3, 4)]},
                        {"dim": [0, 2], "keep_dim": False,
                         "reduce_all": False}),
    "reduce_max_ties": ("reduce_max", {"X": [TIES]},
                        {"dim": [1], "keep_dim": True, "reduce_all": False}),
    "reduce_min_all": ("reduce_min", {"X": [TIES]},
                       {"dim": [], "keep_dim": False, "reduce_all": True}),
    "reduce_prod_dims": ("reduce_prod", {"X": [f32(2, 3, 4)]},
                         {"dim": [0, 2], "keep_dim": True,
                          "reduce_all": False}),
    "clip_ties": ("clip", {"X": [TIES]}, {"min": 0.0, "max": 2.0}),
    "clip_by_norm_clips": ("clip_by_norm", {"X": [f32(3, 4)]},
                           {"max_norm": 0.5}),
    "clip_by_norm_keeps": ("clip_by_norm", {"X": [f32(3, 4)]},
                           {"max_norm": 50.0}),
    "sign": ("sign", {"X": [TIES - 1.0]}, {}),
    "log_softmax": ("log_softmax", {"X": [f32(3, 6) * 3]}, {"axis": -1}),
    "log_softmax_axis0": ("log_softmax", {"X": [f32(3, 6)]}, {"axis": 0}),
    "isfinite": ("isfinite", {"X": [X, np.array([1.0, np.inf], np.float32)]},
                 {}),
    "isfinite_all": ("isfinite", {"X": [X]}, {}),
    "has_inf": ("has_inf", {"X": [np.array([1.0, -np.inf], np.float32)]},
                {}),
    "has_nan": ("has_nan", {"X": [np.array([1.0, np.nan], np.float32)]}, {}),
    "gather_repeats": ("gather", {"X": [f32(6, 4)],
                                  "Index": [np.array([5, 0, 2, 2, 5, 5],
                                                     np.int64)]}, {}),
    "slice": ("slice", {"Input": [f32(3, 5, 4)]},
              {"axes": [1, 2], "starts": [1, -3], "ends": [100, -1]}),
})
for _c in ("equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal"):
    OPS[_c] = (_c, {"X": [TIES], "Y": [np.float32(2.0) * np.ones(
        (1, 4), np.float32)]}, {"axis": -1})
_B = np.array([True, True, False, False])
_C = np.array([True, False, True, False])
for _c in ("logical_and", "logical_or", "logical_xor"):
    OPS[_c] = (_c, {"X": [_B], "Y": [_C]}, {})
OPS["logical_not"] = ("logical_not", {"X": [_B]}, {})

S = (4, 3)
LR = np.array([0.05], np.float32)
UPDATES = {
    "sgd": ("sgd", {"Param": [f32(*S)], "Grad": [f32(*S)],
                    "LearningRate": [LR]}, {}),
    "adagrad": ("adagrad", {"Param": [f32(*S)], "Grad": [f32(*S)],
                            "Moment": [pos(*S)], "LearningRate": [LR]},
                {"epsilon": 1e-6}),
    "decayed_adagrad": ("decayed_adagrad",
                        {"Param": [f32(*S)], "Grad": [f32(*S)],
                         "Moment": [pos(*S)], "LearningRate": [LR]},
                        {"decay": 0.9, "epsilon": 1e-6}),
    "rmsprop": ("rmsprop", {"Param": [f32(*S)], "Grad": [f32(*S)],
                            "Moment": [f32(*S)], "MeanSquare": [pos(*S)],
                            "MeanGrad": [f32(*S) * 0.1],
                            "LearningRate": [LR]},
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
                 "centered": False}),
    "rmsprop_centered": ("rmsprop",
                         {"Param": [f32(*S)], "Grad": [f32(*S)],
                          "Moment": [f32(*S)], "MeanSquare": [pos(*S) + 1],
                          "MeanGrad": [f32(*S) * 0.1], "LearningRate": [LR]},
                         {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
                          "centered": True}),
    "adadelta": ("adadelta", {"Param": [f32(*S)], "Grad": [f32(*S)],
                              "AvgSquaredGrad": [pos(*S)],
                              "AvgSquaredUpdate": [pos(*S)]},
                 {"rho": 0.9, "epsilon": 1e-6}),
    "adamax": ("adamax", {"Param": [f32(*S)], "Grad": [f32(*S)],
                          "Moment": [f32(*S)], "InfNorm": [pos(*S)],
                          "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
                          "LearningRate": [LR]},
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "ftrl": ("ftrl", {"Param": [f32(*S)], "Grad": [f32(*S)],
                      "SquaredAccumulator": [pos(*S)],
                      "LinearAccumulator": [f32(*S)], "LearningRate": [LR]},
             {"l1": 0.1, "l2": 0.2, "lr_power": -0.5}),
    "ftrl_power": ("ftrl", {"Param": [f32(*S)], "Grad": [f32(*S)],
                            "SquaredAccumulator": [pos(*S)],
                            "LinearAccumulator": [f32(*S)],
                            "LearningRate": [LR]},
                   {"l1": 0.0, "l2": 0.1, "lr_power": -0.3}),
    "lars_momentum": ("lars_momentum",
                      {"Param": [f32(*S)], "Grad": [f32(*S)],
                       "Velocity": [f32(*S)], "LearningRate": [LR]},
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    "lamb": ("lamb", {"Param": [f32(*S)], "Grad": [f32(*S)],
                      "Moment1": [f32(*S) * 0.1], "Moment2": [pos(*S) * 0.01],
                      "Beta1Pow": [np.array([0.9 ** 2], np.float32)],
                      "Beta2Pow": [np.array([0.999 ** 2], np.float32)],
                      "LearningRate": [LR]},
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    "lamb_zero_param": ("lamb", {"Param": [np.zeros(S, np.float32)],
                                 "Grad": [np.zeros(S, np.float32)],
                                 "Moment1": [np.zeros(S, np.float32)],
                                 "Moment2": [np.zeros(S, np.float32)],
                                 "Beta1Pow": [np.array([0.9], np.float32)],
                                 "Beta2Pow": [np.array([0.999], np.float32)],
                                 "LearningRate": [LR]},
                        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                         "weight_decay": 0.01}),
    "proximal_gd": ("proximal_gd", {"Param": [f32(*S)], "Grad": [f32(*S)],
                                    "LearningRate": [LR]},
                    {"l1": 0.5, "l2": 0.1}),
    "proximal_gd_l2": ("proximal_gd", {"Param": [f32(*S)], "Grad": [f32(*S)],
                                       "LearningRate": [LR]},
                       {"l1": 0.0, "l2": 0.1}),
    "proximal_adagrad": ("proximal_adagrad",
                         {"Param": [f32(*S)], "Grad": [f32(*S)],
                          "Moment": [pos(*S)], "LearningRate": [LR]},
                         {"l1": 0.3, "l2": 0.1}),
}
OPS.update({f"update_{k}": v for k, v in UPDATES.items()})


def _jax_outs(op_type, ins, attrs):
    outs = jreg.lookup(op_type).emitter(
        jreg.EmitContext(), {s: [jnp.asarray(a) for a in v]
                             for s, v in ins.items()}, attrs)
    return {s: [np.asarray(v) for v in vs] for s, vs in outs.items()}


def _port_outs(op_type, ins, attrs):
    outs = preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu")),
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in ins.items()}, attrs)
    return {s: [v.numpy() for v in vs] for s, vs in outs.items()}


def _assert_same(jouts, pouts, what):
    assert set(pouts) == set(jouts), what
    for slot in jouts:
        assert len(pouts[slot]) == len(jouts[slot]), (what, slot)
        for j, p in zip(jouts[slot], pouts[slot]):
            assert p.shape == j.shape, (what, slot)
            if j.dtype.kind == "f":
                assert p.dtype == j.dtype, (what, slot)
                np.testing.assert_allclose(p, j, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{what} {slot}")
            else:  # bools, and integers the JAX package narrows to int32
                assert p.dtype.kind == j.dtype.kind, (what, slot)
                np.testing.assert_array_equal(p, j, err_msg=f"{what} {slot}")


def test_every_new_op_has_a_case():
    """Each op type the slice registers is in OPS."""
    new = {"gather", "slice", "sign", "log_softmax", "clip", "clip_by_norm",
           "isfinite", "has_inf", "has_nan", "logical_not",
           "elementwise_sub", "elementwise_max", "elementwise_pow",
           "elementwise_mod", "elementwise_floordiv", "reduce_mean",
           "reduce_max", "reduce_min", "reduce_prod", "fused_sgd"}
    new |= set(ACTS) | set(op for op, _, _ in UPDATES.values())
    have = {op for op, _, _ in OPS.values()} | {"fused_sgd"}
    assert new <= have
    for op_type in new:
        assert preg.has_op(op_type) and preg.lookup(op_type).emitter


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    op_type, ins, attrs = OPS[name]
    _assert_same(_jax_outs(op_type, ins, attrs),
                 _port_outs(op_type, ins, attrs), name)


GRAD_OPS = sorted(n for n, (op, _, _) in OPS.items()
                  if not preg.lookup(op).no_grad)


@pytest.mark.parametrize("name", GRAD_OPS)
def test_op_vjp_matches_jax(name):
    """The generic vjp grad op of both packages, the cotangent of each
    output seeded from the op's name."""
    op_type, ins, attrs = OPS[name]
    assert preg.lookup(op_type).no_grad == jreg.lookup(op_type).no_grad
    fwd = _jax_outs(op_type, ins, attrs)
    rng = np.random.RandomState(len(name))
    gins = dict(ins)
    for slot, vals in fwd.items():
        gins[slot + "@GRAD"] = [rng.randn(*v.shape).astype(np.float32)
                                for v in vals]
    gattrs = dict(attrs, __fwd_type__=op_type)
    jouts = jreg.generic_vjp_grad_emitter(
        jreg.EmitContext(), {s: [jnp.asarray(a) for a in v]
                             for s, v in gins.items()}, gattrs)
    pouts = preg.generic_vjp_grad_emitter(
        preg.EmitContext(torch.device("cpu")),
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in gins.items()}, gattrs)
    checked = 0
    for slot, jvals in jouts.items():
        for j, p in zip(jvals, pouts[slot]):
            if j is None or not np.asarray(j).dtype.kind == "f":
                continue  # integer inputs (gather's Index) get no gradient
            np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{name} {slot}")
            checked += 1
    assert checked >= 1


def test_fused_sgd_is_bitwise_sgd():
    """fused_sgd over parameters of several shapes and rates against one
    sgd op per parameter."""
    rng = np.random.RandomState(4)
    shapes = [(7,), (3, 5), (2, 3, 4), (1,)]
    ins = {"Param": [], "Grad": [], "LearningRate": []}
    for i, shp in enumerate(shapes):
        ins["Param"].append(torch.from_numpy(rng.randn(*shp).astype("f4")))
        ins["Grad"].append(torch.from_numpy(rng.randn(*shp).astype("f4")))
        ins["LearningRate"].append(torch.tensor([1e-2 * (i + 1)]))
    ctx = preg.EmitContext(torch.device("cpu"))
    fused = preg.lookup("fused_sgd").emitter(ctx, ins, {})
    for i in range(len(shapes)):
        one = preg.lookup("sgd").emitter(
            ctx, {k: [v[i]] for k, v in ins.items()}, {})
        assert torch.equal(fused["ParamOut"][i], one["ParamOut"][0])


# ---------------------------------------------------------------------------
# optimizers, clips, regularizers on a small regression net
# ---------------------------------------------------------------------------

def _net(mod, make_opt, clip=None, regularizer=None, param_lr=None):
    """fc(8 -> 16, tanh) -> fc(16 -> 1) with a square-error loss."""
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod.layers.data("x", shape=[8], dtype="float32")
        y = mod.layers.data("y", shape=[1], dtype="float32")
        attr = mod.ParamAttr(name="w0", regularizer=regularizer,
                             learning_rate=param_lr or 1.0)
        h = mod.layers.fc(x, size=16, act="tanh", param_attr=attr)
        pred = mod.layers.fc(h, size=1, param_attr=mod.ParamAttr(name="w1"))
        diff = mod.layers.elementwise_sub(pred, y)
        loss = mod.layers.mean(mod.layers.elementwise_mul(diff, diff))
        if clip is not None:
            mod.clip.set_gradient_clip(clip(mod))
        make_opt(mod).minimize(loss)
    return main, startup, loss


def _reg(kind, coeff):
    return lambda mod: getattr(mod.regularizer, kind)(coeff)


TRAIN_CASES = {
    "sgd": (lambda m: m.optimizer.SGD(learning_rate=0.1), {}),
    "sgd_per_param_lr": (lambda m: m.optimizer.SGD(learning_rate=0.1),
                         {"param_lr": 0.5}),
    "momentum_nesterov": (lambda m: m.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9, use_nesterov=True), {}),
    "lars_momentum": (lambda m: m.optimizer.LarsMomentum(
        learning_rate=0.5, momentum=0.9), {}),
    "adagrad": (lambda m: m.optimizer.Adagrad(learning_rate=0.1), {}),
    "adam": (lambda m: m.optimizer.Adam(learning_rate=0.01), {}),
    "lamb": (lambda m: m.optimizer.LambOptimizer(learning_rate=0.01), {}),
    "adamax": (lambda m: m.optimizer.Adamax(learning_rate=0.01), {}),
    "decayed_adagrad": (lambda m: m.optimizer.DecayedAdagrad(
        learning_rate=0.1), {}),
    "adadelta": (lambda m: m.optimizer.AdadeltaOptimizer(
        learning_rate=1.0, rho=0.9), {}),
    "rmsprop": (lambda m: m.optimizer.RMSPropOptimizer(
        learning_rate=0.01, momentum=0.5), {}),
    "rmsprop_centered": (lambda m: m.optimizer.RMSPropOptimizer(
        learning_rate=0.01, centered=True), {}),
    "ftrl": (lambda m: m.optimizer.Ftrl(learning_rate=0.1, l1=0.01,
                                        l2=0.01), {}),
    "clip_by_value": (lambda m: m.optimizer.SGD(learning_rate=0.1),
                      {"clip": lambda m: m.clip.GradientClipByValue(0.05)}),
    "clip_by_norm": (lambda m: m.optimizer.SGD(learning_rate=0.1),
                     {"clip": lambda m: m.clip.GradientClipByNorm(0.1)}),
    "clip_by_global_norm": (lambda m: m.optimizer.Adam(learning_rate=0.01),
                            {"clip": lambda m:
                             m.clip.GradientClipByGlobalNorm(0.1)}),
    "l2_decay_param": (lambda m: m.optimizer.SGD(learning_rate=0.1),
                       {"regularizer": _reg("L2Decay", 0.1)}),
    "l1_decay_param": (lambda m: m.optimizer.SGD(learning_rate=0.1),
                       {"regularizer": _reg("L1Decay", 0.05)}),
    "l2_decay_optimizer": (lambda m: m.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9,
        regularization=m.regularizer.L2DecayRegularizer(0.01)), {}),
}


def _build_pair(name):
    make_opt, kw = TRAIN_CASES[name]

    def build(mod, uniq):
        opts = {}
        if "clip" in kw:
            opts["clip"] = kw["clip"]
        if "regularizer" in kw:
            opts["regularizer"] = kw["regularizer"](mod)
        if "param_lr" in kw:
            opts["param_lr"] = kw["param_lr"]
        with uniq.guard():
            return _net(mod, make_opt, **opts)
    return build(fluid, junique), build(pt, punique)


def _feed(step):
    rng = np.random.RandomState(100 + step)
    x = rng.randn(6, 8).astype(np.float32)
    return {"x": x, "y": np.tanh(x[:, :1] * 2).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_training_api_matches_jax(name):
    (jmain, jstart, jloss), (pmain, pstart, ploss) = _build_pair(name)
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    assert pstart.desc.to_bytes() == jstart.desc.to_bytes()
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jstart.random_seed = 5
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    names = [v.name for v in pmain.list_vars() if v.persistable]
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in names}, "cpu",
        program=pmain)
    jl, pl = [], []
    for s in range(3):
        with fluid.scope_guard(jscope):
            jl.append(float(np.asarray(jexe.run(
                jmain, feed=_feed(s), fetch_list=[jloss])[0]).ravel()[0]))
        pl.append(float(pexe.run(pmain, feed=_feed(s), fetch_list=[ploss],
                                 scope=pscope)[0].ravel()[0]))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] != pl[0]
    for n in names:
        np.testing.assert_allclose(pscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


def test_clip_and_regularizer_ops_carry_the_optimize_role():
    (_, _, _), (pmain, _, _) = _build_pair("clip_by_global_norm")
    from paddle_tpu_torch.core.types import OP_ROLE_ATTR_NAME, OpRole
    ops = pmain.global_block().desc.ops
    clip_ops = [o for o in ops if o.type in ("sqrt", "elementwise_max")]
    assert len(clip_ops) == 2
    assert all(o.attrs[OP_ROLE_ATTR_NAME] == int(OpRole.OPTIMIZE)
               for o in clip_ops)


def test_model_average_raises_naming_its_roadmap_item():
    """ModelAverage is ported: built after minimize, it writes the JAX
    package's programs, byte for byte (tests/test_torch_model_average.py
    holds its arithmetic). The name is older than the check: it held the
    NotImplementedError, naming ROADMAP A9, that the port raised until
    ModelAverage was ported."""
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[3], dtype="float32")
            loss = fl.layers.mean(fl.layers.fc(x, size=2))
            fl.optimizer.SGD(0.1).minimize(loss)
            fl.optimizer.ModelAverage(0.15, min_average_window=10,
                                      max_average_window=20)
        return main, startup
    with junique.guard():
        jm, js = build(fluid)
    with punique.guard():
        pm, ps = build(pt)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    assert ps.desc.to_bytes() == js.desc.to_bytes()


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "exponential": lambda s: s.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda s: s.exponential_decay(0.1, 3, 0.5,
                                                           staircase=True),
    "natural_exp": lambda s: s.natural_exp_decay(0.1, 3, 0.5),
    "inverse_time": lambda s: s.inverse_time_decay(0.1, 3, 0.5,
                                                   staircase=True),
    "polynomial": lambda s: s.polynomial_decay(0.1, 5, 0.001, power=2.0),
    "piecewise": lambda s: s.piecewise_decay([2, 5], [0.1, 0.05, 0.01]),
    "noam": lambda s: s.noam_decay(64, 4),
    "cosine": lambda s: s.cosine_decay(0.1, 2, 4),
    "linear_warmup": lambda s: s.linear_lr_warmup(0.1, 4, 0.0, 0.1),
    "warmup_of_polynomial": lambda s: s.linear_lr_warmup(
        s.polynomial_decay(0.1, 6, 0.001), 3, 0.01, 0.1),
}


def _schedule(mod, uniq, name):
    with uniq.guard():
        main, startup = mod.Program(), mod.Program()
        with mod.program_guard(main, startup):
            lr = SCHEDULES[name](mod.layers.learning_rate_scheduler)
    return main, startup, lr


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_over_8_steps(name):
    """The schedule's value over 8 runs (one counter increment each),
    within 1e-6 relative plus 1e-8 of the JAX package's. XLA on the CPU
    contracts ``scale``'s x * s + b into one fused multiply-add where
    torch rounds twice: at the end of a polynomial decay 1 - step /
    decay_steps is -2^-25 there and 0 here, which the rate (0.1) scales
    to 3e-9."""
    jmain, jstart, jlr = _schedule(fluid, junique, name)
    pmain, pstart, plr = _schedule(pt, punique, name)
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    assert pstart.desc.to_bytes() == jstart.desc.to_bytes()
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    pexe.run(pstart, scope=pscope)
    jv, pv = [], []
    for _ in range(8):
        with fluid.scope_guard(jscope):
            jv.append(float(np.asarray(jexe.run(
                jmain, fetch_list=[jlr])[0]).ravel()[0]))
        pv.append(float(pexe.run(pmain, fetch_list=[plr],
                                 scope=pscope)[0].ravel()[0]))
    np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-8)
    assert len(set(pv)) > 1


def test_append_lars_sets_a_per_parameter_rate():
    """append_LARS writes each parameter's rate as a Variable, which the
    optimizer's update op reads in place of the global rate: programs
    byte-identical and 3 SGD steps as in the JAX package."""
    def build(mod, uniq):
        with uniq.guard():
            main, startup = mod.Program(), mod.Program()
            with mod.program_guard(main, startup):
                x = mod.layers.data("x", shape=[8], dtype="float32")
                y = mod.layers.data("y", shape=[1], dtype="float32")
                pred = mod.layers.fc(x, size=1,
                                     param_attr=mod.ParamAttr(name="w"))
                diff = mod.layers.elementwise_sub(pred, y)
                loss = mod.layers.mean(mod.layers.elementwise_mul(diff,
                                                                  diff))
                opt = mod.optimizer.SGD(learning_rate=0.1)
                pg = opt.backward(loss)
                lr = mod.layers.tensor.fill_constant([1], "float32", 0.1)
                mod.layers.learning_rate_scheduler.append_LARS(pg, lr, 0.01)
                opt.apply_gradients(pg, loss)
        return main, startup, loss
    (jmain, jstart, jloss), (pmain, pstart, ploss) = (
        build(fluid, junique), build(pt, punique))
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    sgd = [o for o in pmain.global_block().desc.ops if o.type == "sgd"]
    assert len(sgd) == 2 and all(
        o.input("LearningRate")[0].startswith("elementwise_div") for o in sgd)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    names = [v.name for v in pmain.list_vars() if v.persistable]
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in names}, "cpu",
        program=pmain)
    for s in range(3):
        with fluid.scope_guard(jscope):
            jl = np.asarray(jexe.run(jmain, feed=_feed(s),
                                     fetch_list=[jloss])[0])
        pl = pexe.run(pmain, feed=_feed(s), fetch_list=[ploss],
                      scope=pscope)[0]
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pscope.find_var("w").numpy(),
                               np.asarray(jscope.find_var("w")), atol=1e-6)
