"""ResNet in the port against the JAX package, on the CPU.

Programs: ``resnet.build`` in the two packages gives the same main,
startup and test programs, byte for byte (cifar10, and flowers at depth
50; NCHW and the NHWC build).

ResNet-50 (flowers, depth 50, at 64x64, batch 4, class_dim 10), one step
from the same weights (the port's seeded startup, carried into the JAX
package's scope), the JAX executor in NCHW (``FLAGS.conv_layout_nhwc``
off there). Every op of the step, run by the port on the JAX package's
own input values, agrees with the JAX package's output: in fp32 within
1e-4 of the output's largest magnitude (XLA on the CPU sums a
batch_norm's channel statistics in another order than torch: measured
up to 3.5e-5 in batch_norm and its grad, 2e-6 elsewhere); under AMP
within 2^-6 of it, two bf16 ulps at that magnitude (an output in the
next binade up, or a statistic summed in another order, flips the last
bit; measured up to 1.0e-2 in batch_norm_grad). The outputs that
update the state (momentum's parameters and velocities, batch_norm's
running statistics) are held by their change over the step against the
JAX package's, at the same bounds plus one float32 ulp of the new value
(its rounding). End to end the two
packages differ by more: the softmax output within 1e-3 (measured
2.0e-4) and the loss within 1e-4 relative (6.9e-6), but 53 batch_norm
layers with 16 to 4096 values per channel amplify the statistics' last
bits into gradients that differ by percents (measured 4.1% in L2
together, 5.7% at most for one parameter; the JAX package's own NCHW
and NHWC runs, whose statistics are summed alike, agree to 5e-6). So
the step-1 gradients are held together within 0.1 relative in L2 and
each parameter's within 0.25; the op replay is the tight check.

resnet_cifar10 (32x32, batches of 2 from seeds 0-3, lr 0.01, momentum
0.9, as tests/test_layout_pass.py:70 but with a new batch per step)
trains 4 steps in the JAX package, and before each step the port takes
the JAX package's whole state and takes the same step. Run free, the two
trajectories part: each step multiplies a last-bit difference by
300-1000 (measured on one repeated batch: 14% apart at step 4), and so
does the port against itself, NCHW against NHWC, where the JAX
package's own layout pair agrees to 4e-6 (XLA sums both layouts'
statistics alike). From the same state each step agrees, each kind of
state held by its change over the step (a port that left it unchanged
would read 1.0) against the JAX package's change (measured over three
initial states): fp32 losses within 1e-5 relative (3.3e-6), the
parameters' and velocities' changes within 0.1 in relative L2 (3.4e-2:
the step's gradient, which batch_norm's backward moves by percents as
for ResNet-50 above) and the running statistics' within 2e-5 (6.7e-6).
Under AMP the losses within 2e-2 (8.2e-3), the parameters' and
velocities' changes within 0.75 (0.59: bf16 alone moves ResNet-50's
gradients by 130%) and the statistics' within 3e-2 (1.6e-2); every
change's norm within 5% of the JAX package's (2.2% at most). The same
holds for the NHWC build and through ``CompiledProgram`` under
bench.py's BuildStrategy, whose rewritten op list is the JAX package's;
``fused_momentum`` is bitwise ``momentum``. The op replay above holds
momentum's updates and the running statistics under AMP tightly: each
change within 2^-6 of its largest magnitude plus one float32 ulp of the
new value.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import mixed_precision as pmp
from paddle_tpu_torch.models import resnet as presnet
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

R50 = dict(dataset="flowers", depth=50, class_dim=10, image_shape=[3, 64, 64])
CIFAR = dict(dataset="cifar10")
STEPS = 4
# the cifar10 steps from the JAX package's state (see the docstring):
# the loss relative; each kind of state by its change over the step, in
# relative L2 distance from the JAX package's change, and the change's
# norm relative to the JAX package's ("norm")
STEP_TOL = {False: {"loss": 1e-5, "params": 0.1, "velocity": 0.1,
                    "bn_stats": 2e-5, "norm": 0.05},
            True: {"loss": 2e-2, "params": 0.75, "velocity": 0.75,
                   "bn_stats": 3e-2, "norm": 0.05}}


@pytest.fixture(autouse=True)
def _flags():
    old = (JFLAGS.op_callstack, PFLAGS.op_callstack, JFLAGS.conv_layout_nhwc,
           JFLAGS.fuse_optimizer_ops_on_cpu, PFLAGS.fuse_optimizer_ops_on_cpu)
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    JFLAGS.conv_layout_nhwc = False
    yield
    (JFLAGS.op_callstack, PFLAGS.op_callstack, JFLAGS.conv_layout_nhwc,
     JFLAGS.fuse_optimizer_ops_on_cpu,
     PFLAGS.fuse_optimizer_ops_on_cpu) = old


def _build_both(**kw):
    with junique.guard():
        j = jresnet.build(**kw)
    with punique.guard():
        p = presnet.build(**kw)
    return j, p


@pytest.mark.parametrize("program", ["main", "startup", "test"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("cfg", [CIFAR, dict(dataset="flowers", depth=50)],
                         ids=["cifar10", "flowers50"])
def test_programs_bytes_identical(cfg, layout, program):
    j, p = _build_both(layout=layout, **cfg)
    assert p[program].desc.to_bytes() == j[program].desc.to_bytes()


def test_preprocess_is_not_ported():
    """``preprocess=True`` no longer raises (the test's name dates from
    when the variant did): it builds the JAX package's three programs,
    byte for byte, at its default raw shape, and feeds the raw image."""
    j, p = _build_both(preprocess=True)
    for program in ("main", "startup", "test"):
        assert p[program].desc.to_bytes() == j[program].desc.to_bytes()
    assert p["feeds"] == j["feeds"] == ["raw_image", "label"]
    raw = p["main"].global_block().var("raw_image")
    assert raw.shape == (-1, 252, 252, 3)


PRE_CIFAR = dict(dataset="cifar10", preprocess=True)


@pytest.mark.parametrize("raw_shape", [None, [32, 32, 3]],
                         ids=["default_raw", "raw_equals_crop"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_preprocess_programs_bytes_identical(layout, raw_shape):
    j, p = _build_both(layout=layout, raw_shape=raw_shape, **PRE_CIFAR)
    for program in ("main", "startup", "test"):
        assert p[program].desc.to_bytes() == j[program].desc.to_bytes()
    types = [o.type for o in p["main"].global_block().ops[:8]]
    assert types[:4] == ["random_crop", "cast", "transpose2", "scale"]


def _normalized(raw):
    """The preprocessing in numpy: uint8 HWC -> CHW in [0, 1] ->
    (x - mean) / std a channel."""
    x = raw.astype(np.float32).transpose(0, 3, 1, 2) * np.float32(1 / 255.0)
    mean = np.array(presnet.IMAGE_MEAN, np.float32).reshape(3, 1, 1)
    std = np.array(presnet.IMAGE_STD, np.float32).reshape(3, 1, 1)
    return (x - mean) / std


def _input_name(p):
    return [o for o in p["main"].global_block().ops
            if o.type == "elementwise_div"][0].output("Out")[0]


def test_preprocess_step_matches_jax_when_the_crop_is_whole():
    """The raw shape equal to the crop: both packages' crops are the
    identity, so one step from the same state takes the same input (equal
    to the numpy preprocessing within 1e-6) and the same loss (within
    1e-5 relative, the cifar10 steps' bound)."""
    j, p, jscope, jexe, pscope = _init(PRE_CIFAR, raw_shape=[32, 32, 3])
    rng = np.random.RandomState(0)
    feed = {"raw_image": rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
            "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    name = _input_name(p)
    with fluid.scope_guard(jscope):
        jl, jx = jexe.run(j["main"], feed=feed,
                          fetch_list=[j["loss"], name])
    pl, px = pt.Executor(pt.CPUPlace()).run(
        p["main"], feed=feed, fetch_list=[p["loss"], name], scope=pscope)
    want = _normalized(feed["raw_image"])
    np.testing.assert_allclose(px, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jx), want, rtol=0, atol=1e-6)
    jl = float(np.asarray(jl).reshape(-1)[0])
    assert abs(float(pl.reshape(-1)[0]) - jl) <= 1e-5 * abs(jl)


def test_preprocess_crops_each_example_at_its_own_offset():
    """At the default raw shape (36x36 for 32x32) each example's network
    input is the preprocessing of a 32x32 slice of its own raw image at
    offsets inside [0, 4], drawn anew each run."""
    _, p = _build_both(**PRE_CIFAR)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(p["startup"], scope=scope)
    rng = np.random.RandomState(1)
    raw = rng.randint(0, 256, (6, 36, 36, 3)).astype(np.uint8)
    feed = {"raw_image": raw,
            "label": rng.randint(0, 10, (6, 1)).astype(np.int64)}
    runs = []
    for _ in range(2):
        (x,) = exe.run(p["test"], feed=feed, fetch_list=[_input_name(p)],
                       scope=scope)
        offsets = []
        for b in range(6):
            hits = [(r, c) for r in range(5) for c in range(5)
                    if np.allclose(x[b], _normalized(
                        raw[b:b + 1, r:r + 32, c:c + 32])[0], atol=1e-6)]
            assert len(hits) >= 1, b
            offsets.append(hits[0])
        runs.append(offsets)
    assert len(set(runs[0] + runs[1])) > 1


def _init(cfg, seed=3, amp=False, **kw):
    """Both packages' builds from the same initial values: the port's
    startup run (seeded; the JAX package's would give the same
    distributions from another stream, and costs an XLA compile), every
    persistable carried into a JAX scope as a numpy array."""
    j, p = _build_both(**cfg, **kw)
    if amp:
        jmp.decorate(j["main"])
        pmp.decorate(p["main"])
    pscope = pt.Scope()
    p["startup"].random_seed = seed
    pt.Executor(pt.CPUPlace()).run(p["startup"], scope=pscope)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    for n in pscope.var_names():
        jscope.set_var(n, pscope.find_var(n).numpy().copy())
    return j, p, jscope, jexe, pscope


def _feed(batch, shape, classes, seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.rand(batch, *shape).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


# ---------------------------------------------------------------------------
# ResNet-50, one step
# ---------------------------------------------------------------------------

_R50_RUNS = {}


def _r50(amp):
    """One ResNet-50 step in both packages from the same weights
    (memoized per amp): the params, the JAX package's value of every name
    the step writes once, the JAX package's initial persistables, and
    the port's [loss, softmax, *grads] of its own run."""
    if amp not in _R50_RUNS:
        j, p, jscope, jexe, pscope = _init(R50, amp=amp)
        feed = _feed(4, R50["image_shape"], 10)
        block = p["main"].global_block()
        persistable = {v.name for v in p["main"].list_vars()
                       if v.persistable}
        init = {n: np.array(jscope.find_var(n)) for n in persistable}
        writes = {}
        for op in block.desc.ops:
            for n in op.output_arg_names():
                writes[n] = writes.get(n, 0) + 1
        names = sorted(n for n in writes
                       if n and n not in persistable and writes[n] == 1)
        with fluid.scope_guard(jscope):
            vals = jexe.run(j["main"], feed=feed, fetch_list=names)
        post = {n: np.array(jscope.find_var(n)) for n in persistable}
        params = [v.name for v in p["main"].all_parameters()]
        fetch = ([p["loss"].name, p["predict"].name]
                 + [n + "@GRAD" for n in params])
        pr = pt.Executor(pt.CPUPlace()).run(p["main"], feed=feed,
                                            fetch_list=fetch, scope=pscope)
        _R50_RUNS[amp] = (p, feed, params, writes, init,
                          {n: np.asarray(v) for n, v in zip(names, vals)},
                          fetch, pr, post)
    return _R50_RUNS[amp]


def test_r50_forward_and_loss():
    _, _, _, _, _, jvals, fetch, pr, _ = _r50(False)
    loss, predict = jvals[fetch[0]], jvals[fetch[1]]
    assert abs(pr[0][0] - loss[0]) <= 1e-4 * abs(loss[0])
    np.testing.assert_allclose(pr[1], predict, rtol=0, atol=1e-3)


def test_r50_step1_gradients():
    _, _, params, _, _, jvals, fetch, pr, _ = _r50(False)
    assert len(params) == 161
    jr = [jvals[n] for n in fetch[2:]]
    want = np.concatenate([g.reshape(-1) for g in jr])
    got = np.concatenate([g.reshape(-1) for g in pr[2:]])
    assert np.linalg.norm(got - want) <= 0.1 * np.linalg.norm(want)
    for name, w, g in zip(params, jr, pr[2:]):
        assert np.linalg.norm(g - w) <= 0.25 * np.linalg.norm(w), name


def _replay(amp):
    """Every op of the step, run by the port on the JAX package's values:
    [(op type, var, jax value, port value, absolute floor)] for every
    output written once; a name written more than once (a gradient and its sum) takes
    the port's value, computed from the JAX package's inputs. An output
    that rebinds a persistable (momentum's parameter and velocity,
    batch_norm's running statistics) is held by its change over the step
    against the JAX package's change, so that the update itself is
    compared and not the larger value it is added to; its floor is one
    float32 ulp of the new value's largest magnitude, the rounding of
    the sum (measured: parameters half an ulp to one apart)."""
    p, feed, _, writes, init, jvals, _, _, post = _r50(amp)
    env = {n: torch.from_numpy(v) for n, v in init.items()}
    env.update({n: torch.from_numpy(v) for n, v in feed.items()})
    for n, v in jvals.items():
        env[n] = (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                  if v.dtype.name == "bfloat16" else torch.from_numpy(
                      np.array(v)))
    ctx = pt.registry.EmitContext(torch.device("cpu"), amp=amp)
    rows = []
    for op in p["main"].global_block().desc.ops:
        ins = {s: [env[n] if n else None for n in ns]
               for s, ns in op.inputs.items()}
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


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_r50_each_op_replayed_on_jax_values_agrees(amp):
    rows = _replay(amp)
    types = {r[0] for r in rows}
    assert {"conv2d", "conv2d_grad", "batch_norm", "batch_norm_grad",
            "pool2d", "pool2d_grad", "cross_entropy", "cross_entropy_grad",
            "mean", "top_k", "accuracy", "momentum"} <= types
    # every parameter's update and velocity, every running statistic
    assert sum(r[0] == "momentum" for r in rows) == 2 * 161
    assert sum(r[0] == "batch_norm" and ".global_" in r[1]
               for r in rows) == 2 * 53
    for op_type, name, want, got, floor in rows:
        if want.dtype.kind == "f" or want.dtype.name == "bfloat16":
            # integer outputs differ in width by design (the JAX package
            # narrows int64 to int32)
            assert str(got.dtype).replace("torch.", "") == want.dtype.name, \
                name
        if not want.size:
            continue
        want = want.astype(np.float32)
        scale = np.abs(want).max()
        tol = (2.0 ** -6 if amp else 1e-4) * scale + floor
        err = np.abs(got.float().numpy() - want).max()
        assert err <= tol, (op_type, name, err, scale)


# ---------------------------------------------------------------------------
# resnet_cifar10, several steps
# ---------------------------------------------------------------------------

def _change_l2(pscope, jscope, before, names):
    """(relative L2 distance of the port's change of `names` over a step
    from the JAX package's change, the port's change's norm over the JAX
    package's), all names together."""
    got = np.concatenate([(pscope.find_var(n).numpy() - before[n])
                          .reshape(-1) for n in names])
    want = np.concatenate([(np.asarray(jscope.find_var(n)) - before[n])
                           .reshape(-1) for n in names])
    norm = np.linalg.norm(want)
    return (float(np.linalg.norm(got - want) / norm),
            float(np.linalg.norm(got) / norm))


def _train(cfg, amp=False, target=None, steps=STEPS, layout="NCHW"):
    """``steps`` steps in the JAX package, each on its own batch; before
    each, the JAX package's whole state goes into the port, which takes
    the same step. Returns per step (JAX loss, port loss, {kind: relative
    L2 distance of the port's change of that state over the step from
    the JAX package's, and its norm over theirs}) with kinds "params" (weights and biases),
    "velocity" and "bn_stats" (running means and variances), and the
    build. A port that left a kind unchanged would read 1.0."""
    j, p, jscope, jexe, pscope = _init(cfg, amp=amp, layout=layout)
    names = sorted(v.name for v in p["main"].list_vars() if v.persistable)
    kinds = {"velocity": [n for n in names if "velocity" in n],
             "bn_stats": [n for n in names if ".global_" in n],
             "params": [v.name for v in p["main"].all_parameters()]}
    assert all(kinds.values())
    exe = pt.Executor(pt.CPUPlace())
    rows = []
    for step in range(steps):
        feed = _feed(2, [3, 32, 32], 10, seed=step)
        before = {n: np.array(jscope.find_var(n)) for n in names}
        pt.io.set_params_from_numpy(pscope, before, "cpu", program=p["main"])
        with fluid.scope_guard(jscope):
            (jl,) = jexe.run(j["main"] if target is None else target(j, fluid),
                             feed=feed, fetch_list=[j["loss"]])
        (pl,) = exe.run(p["main"] if target is None else target(p, pt),
                        feed=feed, fetch_list=[p["loss"]], scope=pscope)
        rows.append((float(np.asarray(jl).reshape(-1)[0]),
                     float(pl.reshape(-1)[0]),
                     {k: _change_l2(pscope, jscope, before, ns)
                      for k, ns in kinds.items()}))
    return rows, j, p, exe


def _assert_steps(rows, amp=False):
    tol = STEP_TOL[amp]
    assert rows[-1][0] < rows[0][0]  # the JAX package's loss falls
    for step, (want, got, dist) in enumerate(rows):
        assert abs(got - want) <= tol["loss"] * abs(want), (step, rows)
        for kind, (d, norm) in dist.items():
            assert d <= tol[kind], (step, kind, rows)
            assert abs(norm - 1) <= tol["norm"], (step, kind, rows)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_cifar10_steps_match_jax(amp):
    rows, _, _, _ = _train(CIFAR, amp=amp)
    _assert_steps(rows, amp)


def test_cifar10_nhwc_build_matches_jax_nchw():
    """The port's NHWC build (the build-time layout pass) trains as the
    JAX package's NHWC build, which tests/test_layout_pass.py:70 holds
    to its NCHW one."""
    rows, _, p, _ = _train(CIFAR, layout="NHWC")
    assert [o.type for o in p["main"].global_block().desc.ops].count(
        "transpose") == 2
    _assert_steps(rows)


def bench_strategy(mod):
    """bench.py:316-326's BuildStrategy, in either package."""
    bs = mod.BuildStrategy()
    bs.fuse_all_optimizer_ops = True
    bs.fuse_elewise_add_act_ops = True
    bs.memory_optimize = True
    bs.fuse_conv_ops = True
    bs.fuse_attention_ops = True
    return bs


@pytest.fixture(scope="module")
def compiled_runs():
    old = (JFLAGS.op_callstack, PFLAGS.op_callstack, JFLAGS.conv_layout_nhwc,
           JFLAGS.fuse_optimizer_ops_on_cpu, PFLAGS.fuse_optimizer_ops_on_cpu)
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    JFLAGS.conv_layout_nhwc = False
    JFLAGS.fuse_optimizer_ops_on_cpu = PFLAGS.fuse_optimizer_ops_on_cpu = True
    targets = {}

    def target(m, mod):
        key = id(m["main"])
        if key not in targets:
            targets[key] = mod.CompiledProgram(
                m["main"], build_strategy=bench_strategy(mod))
        return targets[key]

    try:
        rows, j, p, exe = _train(CIFAR, target=target)
        jops = list(j["main"].__dict__["_pass_memo"].values())[0]
        pops = exe.lowered_ops(target(p, pt), [p["loss"]])
        return rows, jops, pops, exe
    finally:
        (JFLAGS.op_callstack, PFLAGS.op_callstack, JFLAGS.conv_layout_nhwc,
         JFLAGS.fuse_optimizer_ops_on_cpu,
         PFLAGS.fuse_optimizer_ops_on_cpu) = old


def test_compiled_steps_match_jax(compiled_runs):
    _assert_steps(compiled_runs[0])


def test_compiled_op_list_is_the_jax_packages(compiled_runs):
    from test_torch_ir import assert_same_ops
    _, jops, pops, exe = compiled_runs
    assert_same_ops(jops, pops)
    types = [o.type for o in pops]
    assert "momentum" not in types and types.count("fused_momentum") >= 1
    assert "conv2d_grad" in types and "fused_conv2d" not in types
    assert exe.pipeline_stats["runs"] == 1


@pytest.mark.parametrize("nesterov", [False, True])
def test_fused_momentum_emitter_is_bitwise_momentum(nesterov):
    rng = np.random.RandomState(3)
    shapes = [(7,), (3, 5), (2, 3, 3, 3), (1,)]
    ins = {k: [] for k in ("Param", "Grad", "Velocity", "LearningRate")}
    for i, shp in enumerate(shapes):
        for k in ("Param", "Grad", "Velocity"):
            ins[k].append(torch.from_numpy(rng.randn(*shp).astype("f4")))
        ins["LearningRate"].append(torch.tensor([0.1 * (i + 1)]))
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    ctx = pt.registry.EmitContext(torch.device("cpu"))
    fused = pt.registry.lookup("fused_momentum").emitter(ctx, ins, attrs)
    for i in range(len(shapes)):
        one = pt.registry.lookup("momentum").emitter(
            ctx, {k: [v[i]] for k, v in ins.items()}, attrs)
        for slot, vals in one.items():
            assert torch.equal(fused[slot][i], vals[0]), (slot, i)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_fused_momentum_step_is_bitwise(amp):
    """One cifar10 step with fuse_all_optimizer_ops alone against the
    plain program from the same weights: every persistable bitwise
    equal."""
    PFLAGS.fuse_optimizer_ops_on_cpu = True
    sides = []
    for fused in (False, True):
        with punique.guard():
            p = presnet.build(**CIFAR)
        if amp:
            pmp.decorate(p["main"])
        scope = pt.Scope()
        p["startup"].random_seed = 3
        pt.Executor(pt.CPUPlace()).run(p["startup"], scope=scope)
        bs = pt.BuildStrategy()
        bs.fuse_all_optimizer_ops = fused
        exe = pt.Executor(pt.CPUPlace())
        target = pt.CompiledProgram(p["main"], build_strategy=bs)
        types = [o.type for o in exe.lowered_ops(target, [p["loss"]])]
        assert ("fused_momentum" in types) == fused
        assert ("momentum" in types) != fused
        exe.run(target, feed=_feed(2, [3, 32, 32], 10), fetch_list=[p["loss"]],
                scope=scope)
        sides.append({n: scope.find_var(n).clone()
                      for n in scope.var_names()})
    plain, fused = sides
    assert sorted(plain) == sorted(fused)
    for n in sorted(plain):
        assert torch.equal(plain[n], fused[n]), n


def test_resnet_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.Executor()
