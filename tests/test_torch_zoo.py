"""The model zoo in the port against the JAX package, on the CPU.

Programs: every ``build`` of ``paddle_tpu_torch.models`` -- fit_a_line,
mnist (LeNet), deepfm, word2vec, vgg (VGG-16), se_resnext
(SE-ResNeXt-50), recommender, understand_sentiment (both nets) and
stacked_lstm -- gives the JAX package's main, startup and test programs,
byte for byte, at its defaults.

One training step from the same weights (the port's seeded startup,
carried into the JAX package's scope), at small widths: the models
without batch_norm or dropout agree in the loss within 1e-5 relative and
in every parameter after the step within 1e-5 relative L2 (measured
below 1e-6). VGG-16 (cifar10, batch 8) and SE-ResNeXt-50 (64x64, batch
4, 10 classes) hold their
forward through the test program (batch_norm in inference mode) within
1e-5 of the JAX package's softmax, and their training step op by op:
every op of the step, run by the port on the JAX package's own input
values, agrees with the JAX package's output within 1e-4 of that
output's largest magnitude (the bound of tests/test_torch_resnet.py,
whose docstring says why batch_norm's statistics need it); a dropout
op's output is the port's arithmetic on the JAX package's mask (the two
random streams differ, ROADMAP C "RNG"), and the grads read that mask.
The outputs that update the state (Adam's and momentum's parameters and
moments, batch_norm's running statistics) are held by their change over
the step, at the same bound plus one float32 ulp of the new value.

``nets.py``'s five functions each build the JAX package's ops.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import nets as jnets
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import nets as pnets
from paddle_tpu_torch.ops.kernels_nn import _dropout_apply
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

# (module, build kwargs) per case; the byte checks use the defaults
BUILDS = {
    "fit_a_line": ("fit_a_line", {}),
    "mnist": ("mnist", {}),
    "deepfm": ("deepfm", {}),
    "word2vec": ("word2vec", {}),
    "vgg": ("vgg", {}),
    "se_resnext": ("se_resnext", {}),
    "recommender": ("recommender", {}),
    "sentiment_conv": ("understand_sentiment", {"net": "conv"}),
    "sentiment_lstm": ("understand_sentiment", {"net": "stacked_lstm"}),
    "stacked_lstm": ("stacked_lstm", {}),
}

DEEPFM_SMALL = dict(sparse_vocab=1000, num_fields=5, dense_dim=3,
                    embed_dim=4, fc_sizes=(16, 16))
SEQ_SMALL = dict(dict_size=100, max_len=10)
# (build kwargs at small widths, fake batch)
STEPS = {
    "fit_a_line": ({}, lambda m: m.make_fake_batch(4)),
    "mnist": ({}, lambda m: m.make_fake_batch(4)),
    "deepfm": (DEEPFM_SMALL,
               lambda m: m.make_fake_batch(8, {"sparse_vocab": 1000,
                                               "num_fields": 5,
                                               "dense_dim": 3})),
    "word2vec": (dict(dict_size=100, embed_size=8, hidden_size=16),
                 lambda m: m.make_fake_batch(4, 100)),
    "recommender": ({}, lambda m: m.make_fake_batch(4)),
    "sentiment_conv": (dict(net="conv", emb_dim=8, hid_dim=8, **SEQ_SMALL),
                       lambda m: m.make_fake_batch(4, 100, 10)),
    "sentiment_lstm": (dict(net="stacked_lstm", emb_dim=8, hid_dim=8,
                            **SEQ_SMALL),
                       lambda m: m.make_fake_batch(4, 100, 10)),
    "stacked_lstm": (dict(emb_dim=8, lstm_size=8, **SEQ_SMALL),
                     lambda m: m.make_fake_batch(4, 100, 10)),
}
CNNS = {"vgg": {}, "se_resnext": dict(image_shape=[3, 64, 64], class_dim=10)}


@pytest.fixture(autouse=True)
def _flags():
    old = (JFLAGS.op_callstack, PFLAGS.op_callstack, JFLAGS.conv_layout_nhwc)
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    JFLAGS.conv_layout_nhwc = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack, JFLAGS.conv_layout_nhwc = old


def build_both(case, **over):
    """(JAX build, port build, port module) of BUILDS[case] with ``over``."""
    mod, kw = BUILDS[case]
    jm = importlib.import_module("paddle_tpu.models." + mod)
    pm = importlib.import_module("paddle_tpu_torch.models." + mod)
    with junique.guard():
        j = jm.build(**kw, **over)
    with punique.guard():
        p = pm.build(**kw, **over)
    return j, p, pm


def init_both(case, seed=3, **over):
    """Both builds from the same initial values: the port's seeded startup
    run, every persistable carried into a JAX scope as a numpy array."""
    j, p, pm = build_both(case, **over)
    pscope = pt.Scope()
    p["startup"].random_seed = seed
    pt.Executor(pt.CPUPlace()).run(p["startup"], scope=pscope)
    jscope = fluid.Scope()
    for n in pscope.var_names():
        jscope.set_var(n, pscope.find_var(n).numpy().copy())
    return j, p, pm, jscope, pscope


@pytest.mark.parametrize("program", ["main", "startup", "test"])
@pytest.mark.parametrize("case", sorted(BUILDS))
def test_programs_bytes_identical(case, program):
    j, p, _ = build_both(case)
    assert p[program].desc.to_bytes() == j[program].desc.to_bytes()


@pytest.mark.parametrize("case", sorted(STEPS))
def test_one_step_matches_jax(case):
    kw, make_feed = STEPS[case]
    j, p, pm, jscope, pscope = init_both(case, **{
        k: v for k, v in kw.items() if k != "net"})
    feed = make_feed(pm)
    with fluid.scope_guard(jscope):
        (jl,) = fluid.Executor(fluid.CPUPlace()).run(
            j["main"], feed=feed, fetch_list=[j["loss"].name])
    (pl,) = pt.Executor(pt.CPUPlace()).run(
        p["main"], feed=feed, fetch_list=[p["loss"].name], scope=pscope)
    jl, pl = float(np.asarray(jl).reshape(-1)[0]), float(pl.reshape(-1)[0])
    assert np.isfinite(pl)
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    params = [v.name for v in p["main"].all_parameters()]
    assert params
    for n in params:
        want = np.asarray(jscope.find_var(n))
        got = pscope.find_var(n).numpy()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), n


# ---------------------------------------------------------------------------
# VGG-16 and SE-ResNeXt-50: the forward, and the step op by op
# ---------------------------------------------------------------------------

def _cnn_feed(case, seed=0):
    """VGG-16 at 32x32, batch 8; SE-ResNeXt-50 at 64x64, batch 4: every
    batch_norm sees at least 8 values a channel (VGG's after its fc sees
    the batch; SE-ResNeXt's last stage 2x2 per image). With 2, y is +-1
    and the inverse deviation ill-conditioned."""
    rng = np.random.RandomState(seed)
    size, batch = (32, 8) if case == "vgg" else (64, 4)
    return {"data": rng.rand(batch, 3, size, size).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}


@pytest.mark.parametrize("case", sorted(CNNS))
def test_cnn_forward_through_the_test_program(case):
    j, p, _, jscope, pscope = init_both(case, **CNNS[case])
    feed = _cnn_feed(case)
    with fluid.scope_guard(jscope):
        (want,) = fluid.Executor(fluid.CPUPlace()).run(
            j["test"], feed=feed, fetch_list=[j["predict"].name])
    (got,) = pt.Executor(pt.CPUPlace()).run(
        p["test"], feed=feed, fetch_list=[p["predict"].name], scope=pscope)
    assert got.shape == (feed["label"].shape[0], 10)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def replay_step(case, **over):
    """One training step of ``case``: the JAX package runs it, fetching
    every name the step writes once; then the port runs every op on the
    JAX package's input values. Returns [(op type, var, JAX value, port
    value, absolute floor)] for every output written once, a persistable
    by its change over the step (floor: one float32 ulp of the new
    value's largest magnitude). A dropout op's row is the port's
    arithmetic on the JAX package's mask."""
    j, p, _, jscope, _ = init_both(case, **over)
    feed = _cnn_feed(case)
    ops = p["main"].global_block().desc.ops
    persistable = {v.name for v in p["main"].list_vars() if v.persistable}
    init = {n: np.array(jscope.find_var(n)) for n in persistable}
    writes = {}
    for op in ops:
        for n in op.output_arg_names():
            writes[n] = writes.get(n, 0) + 1
    names = sorted(n for n in writes
                   if n and n not in persistable and writes[n] == 1)
    with fluid.scope_guard(jscope):
        vals = fluid.Executor(fluid.CPUPlace()).run(
            j["main"], feed=feed, fetch_list=names)
    jvals = {n: np.array(v) for n, v in zip(names, vals)}
    post = {n: np.array(jscope.find_var(n)) for n in persistable}
    env = {n: torch.from_numpy(v) for n, v in init.items()}
    env.update({n: torch.from_numpy(v) for n, v in feed.items()})
    env.update({n: torch.from_numpy(v) for n, v in jvals.items()})
    ctx = pt.registry.EmitContext(torch.device("cpu"))
    rows = []
    for op in ops:
        ins = {s: [env[n] if n else None for n in ns]
               for s, ns in op.inputs.items()}
        if op.type == "dropout":
            out, mask = op.output("Out")[0], op.output("Mask")[0]
            xv = ins["X"][0]
            got = _dropout_apply(xv, env[mask].to(xv.dtype),
                                 float(op.attrs.get("dropout_prob", 0.5)),
                                 op.attrs.get("dropout_implementation",
                                              "downgrade_in_infer"))
            rows.append((op.type, out, jvals[out], got, 1e-6))
            continue
        outs = pt.executor._emitter(op.type)(ctx, ins, op.attrs)
        for slot, ns in op.outputs.items():
            for n, v in zip(ns, outs.get(slot) or ()):
                if n in init:
                    rows.append((op.type, n, post[n] - init[n],
                                 v - torch.from_numpy(init[n]),
                                 np.spacing(np.abs(post[n]).max())))
                    env[n] = v
                elif writes.get(n, 0) > 1:
                    env[n] = v
                elif n in jvals and v is not None:
                    rows.append((op.type, n, jvals[n], v, 1e-6))
    return rows


@pytest.mark.parametrize("case", sorted(CNNS))
def test_cnn_step_each_op_replayed_on_jax_values_agrees(case):
    rows = replay_step(case, **CNNS[case])
    types = {r[0] for r in rows}
    assert {"conv2d", "conv2d_grad", "batch_norm", "batch_norm_grad",
            "pool2d", "pool2d_grad", "dropout", "dropout_grad",
            "cross_entropy", "mean"} <= types
    opt_type = "adam" if case == "vgg" else "momentum"
    assert opt_type in types
    for op_type, name, want, got, floor in rows:
        if not want.size:
            continue
        want = want.astype(np.float32)
        tol = 1e-4 * np.abs(want).max() + floor
        err = np.abs(got.float().numpy() - want).max()
        assert err <= tol, (op_type, name, err, np.abs(want).max())


# ---------------------------------------------------------------------------
# nets.py
# ---------------------------------------------------------------------------

def _nets_case(name, nets, fluid_mod):
    layers = fluid_mod.layers
    if name == "simple_img_conv_pool":
        x = layers.data("x", shape=[1, 12, 12], dtype="float32")
        return nets.simple_img_conv_pool(x, num_filters=4, filter_size=3,
                                         pool_size=2, pool_stride=2,
                                         act="relu")
    if name == "img_conv_group":
        x = layers.data("x", shape=[3, 8, 8], dtype="float32")
        return nets.img_conv_group(x, conv_num_filter=[4, 4], pool_size=2,
                                   pool_stride=2, conv_act="relu",
                                   conv_with_batchnorm=True,
                                   conv_batchnorm_drop_rate=[0.3, 0])
    if name == "glu":
        x = layers.data("x", shape=[8], dtype="float32")
        return nets.glu(x, dim=-1)
    if name == "sequence_conv_pool":
        x = layers.data("x", shape=[6, 5], dtype="float32")
        n = layers.data("n", shape=[], dtype="int32")
        return nets.sequence_conv_pool(x, num_filters=3, filter_size=3,
                                       act="tanh", pool_type="sqrt",
                                       length=n)
    x = layers.data("q", shape=[4, 8], dtype="float32",
                    append_batch_size=False)
    q = layers.reshape(x, [1, 4, 8])
    rate = 0.1 if name == "scaled_dot_product_attention_dropout" else 0.0
    return nets.scaled_dot_product_attention(q, q, q, num_heads=2,
                                             dropout_rate=rate)


@pytest.mark.parametrize("name", [
    "simple_img_conv_pool", "img_conv_group", "glu", "sequence_conv_pool",
    "scaled_dot_product_attention", "scaled_dot_product_attention_dropout"])
def test_nets_build_the_jax_ops(name):
    progs = []
    for nets, mod, uniq in ((jnets, fluid, junique), (pnets, pt, punique)):
        main, startup = mod.Program(), mod.Program()
        with uniq.guard(), mod.program_guard(main, startup):
            _nets_case(name, nets, mod)
        progs.append((main, startup))
    (jm, js), (pm, ps) = progs
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    assert ps.desc.to_bytes() == js.desc.to_bytes()
    types = [o.type for o in pm.global_block().desc.ops]
    assert types
    if name == "scaled_dot_product_attention":
        assert "flash_attention" in types
