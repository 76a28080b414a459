"""Training through ``CompiledProgram`` in the port against the JAX
package's, on the CPU.

The model is the tiny Transformer built with ``attention_impl="unfused"``
(the matmul/softmax chain), run under bench.py's BuildStrategy
(bench.py:316-326: fuse_all_optimizer_ops, fuse_elewise_add_act_ops,
memory_optimize, fuse_conv_ops, fuse_attention_ops) with
``FLAGS.fuse_optimizer_ops_on_cpu`` set in both packages, from the JAX
package's initial weights (``set_params_from_numpy``).

Tolerances are the JAX package's own for the attention rewrite
(tests/test_attention_fusion.py:99-102): losses rtol 2e-4, atol 1e-5;
parameters rtol 2e-3, atol 2e-5. The rewrite is bit-close, not
bit-exact (it reassociates the scale). ``fused_adam`` against the
per-parameter ``adam`` ops is held bitwise.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import mixed_precision as pmp
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

TINY = dict(src_vocab=50, tgt_vocab=50, max_len=8, n_layer=1, n_head=2,
            d_model=32, d_inner_hid=64, warmup_steps=4)
STEPS = 4
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture(autouse=True)
def _flags():
    old = (JFLAGS.op_callstack, PFLAGS.op_callstack,
           JFLAGS.fuse_optimizer_ops_on_cpu, PFLAGS.fuse_optimizer_ops_on_cpu)
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    JFLAGS.fuse_optimizer_ops_on_cpu = True
    PFLAGS.fuse_optimizer_ops_on_cpu = True
    yield
    (JFLAGS.op_callstack, PFLAGS.op_callstack,
     JFLAGS.fuse_optimizer_ops_on_cpu,
     PFLAGS.fuse_optimizer_ops_on_cpu) = old


def bench_strategy(mod):
    """bench.py:316-326's BuildStrategy, in either package."""
    bs = mod.BuildStrategy()
    bs.fuse_all_optimizer_ops = True
    bs.fuse_elewise_add_act_ops = True
    bs.memory_optimize = True
    bs.fuse_conv_ops = True
    bs.fuse_attention_ops = True
    return bs


def _batch(cfg, step):
    feed = ptransformer.make_fake_batch(2, cfg, seed=step)
    feed["src_len"] = np.array([cfg["max_len"], 5], np.int32)
    feed["trg_len"] = np.array([6, cfg["max_len"]], np.int32)
    return feed


def _jax_init(attention_impl="unfused"):
    with junique.guard():
        j = jtransformer.build(dropout_rate=0.0, attention_impl=attention_impl,
                               **TINY)
    scope = fluid.Scope()
    j["startup"].random_seed = 7
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(j["startup"])
    return j, scope


def _port(attention_impl, jscope):
    with punique.guard():
        p = ptransformer.build(attention_impl=attention_impl, **TINY)
    persistables = [v.name for v in p["main"].list_vars() if v.persistable]
    scope = pt.Scope()
    pt.io.set_params_from_numpy(
        scope, {n: np.asarray(jscope.find_var(n)) for n in persistables},
        "cpu", program=p["main"])
    return p, scope


def _params(p, scope):
    return {v.name: scope.find_var(v.name).numpy().copy()
            for v in p["main"].all_parameters()}


def _train_port(p, scope, target, steps=STEPS, exe=None):
    exe = exe or pt.Executor(pt.CPUPlace())
    losses = []
    for s in range(steps):
        out = exe.run(target, feed=_batch(p["config"], s),
                      fetch_list=[p["loss"]], scope=scope)
        losses.append(float(out[0].reshape(-1)[0]))
    return losses


@pytest.fixture(scope="module")
def runs():
    """4 steps through CompiledProgram(bench strategy) in both packages,
    and the port's fused build on a plain Executor from the same
    weights."""
    old = (JFLAGS.op_callstack, PFLAGS.op_callstack,
           JFLAGS.fuse_optimizer_ops_on_cpu, PFLAGS.fuse_optimizer_ops_on_cpu)
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    JFLAGS.fuse_optimizer_ops_on_cpu = PFLAGS.fuse_optimizer_ops_on_cpu = True
    try:
        j, jscope = _jax_init()
        p, pscope = _port("unfused", jscope)
        fused, fscope = _port("fused", jscope)
        jexe = fluid.Executor(fluid.CPUPlace())
        jtarget = fluid.CompiledProgram(j["main"],
                                        build_strategy=bench_strategy(fluid))
        jlosses = []
        with fluid.scope_guard(jscope):
            for s in range(STEPS):
                out = jexe.run(jtarget, feed=_batch(p["config"], s),
                               fetch_list=[j["loss"]])
                jlosses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        jparams = {v.name: np.asarray(jscope.find_var(v.name))
                   for v in j["main"].all_parameters()}
        jops = list(j["main"].__dict__["_pass_memo"].values())[0]
        exe = pt.Executor(pt.CPUPlace())
        target = pt.CompiledProgram(p["main"],
                                    build_strategy=bench_strategy(pt))
        ops = exe.lowered_ops(target, [p["loss"]])
        plosses = _train_port(p, pscope, target, exe=exe)
        flosses = _train_port(fused, fscope, fused["main"])
        return {"jax": (jlosses, jparams, jops),
                "port": (plosses, _params(p, pscope), ops, exe),
                "fused": (flosses, _params(fused, fscope))}
    finally:
        (JFLAGS.op_callstack, PFLAGS.op_callstack,
         JFLAGS.fuse_optimizer_ops_on_cpu,
         PFLAGS.fuse_optimizer_ops_on_cpu) = old


def test_rewritten_step_is_the_jax_packages(runs):
    from test_torch_ir import assert_same_ops
    jops = runs["jax"][2]
    ops = runs["port"][2]
    assert_same_ops(jops, ops)
    types = [o.type for o in ops]
    assert types.count("flash_attention") == 3
    assert types.count("flash_attention_grad") == 3
    assert "softmax" not in types and types.count("fused_adam") >= 1
    assert "adam" not in types


@pytest.mark.parametrize("ref", ["jax", "fused"])
def test_losses_match(runs, ref):
    np.testing.assert_allclose(runs["port"][0], runs[ref][0], **LOSS_TOL)


@pytest.mark.parametrize("ref", ["jax", "fused"])
def test_parameters_match(runs, ref):
    want, got = runs[ref][1], runs["port"][1]
    assert sorted(got) == sorted(want)
    for n in sorted(want):
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **PARAM_TOL)


def test_the_pipeline_runs_once_then_the_memo_serves(runs):
    exe = runs["port"][3]
    stats = exe.pipeline_stats
    assert stats["runs"] == 1 and stats["memo_hits"] == STEPS
    assert stats["stages"]["fuse_attention"]["ops_removed"] > 0
    assert stats["stages"]["fuse_optimizer_ops"]["ops_removed"] > 0


def test_a_program_change_misses_the_memo():
    j, jscope = _jax_init()
    p, scope = _port("unfused", jscope)
    exe = pt.Executor(pt.CPUPlace())
    target = pt.CompiledProgram(p["main"], build_strategy=bench_strategy(pt))
    exe.lowered_ops(target, [p["loss"]])
    exe.lowered_ops(target, [p["loss"]])
    assert (exe.pipeline_stats["runs"], exe.pipeline_stats["memo_hits"]) == (
        1, 1)
    p["main"]._bump()
    exe.lowered_ops(target, [p["loss"]])
    exe.lowered_ops(target, [p["loss"], p["logits"]])
    assert exe.pipeline_stats["runs"] == 3


def test_no_build_strategy_runs_no_pass():
    """A CompiledProgram with the default BuildStrategy (every flag off)
    runs exactly the plain program's ops."""
    j, jscope = _jax_init()
    p, scope = _port("fused", jscope)
    exe = pt.Executor(pt.CPUPlace())
    plain = exe.lowered_ops(p["main"], [p["loss"]])
    compiled = exe.lowered_ops(pt.CompiledProgram(p["main"]), [p["loss"]])
    assert [id(o) for o in compiled] == [id(o) for o in plain]
    assert exe.pipeline_stats["runs"] == 0


def test_optimizer_fusion_is_off_on_the_cpu_by_default():
    PFLAGS.fuse_optimizer_ops_on_cpu = False
    j, jscope = _jax_init()
    p, scope = _port("fused", jscope)
    ops = pt.Executor(pt.CPUPlace()).lowered_ops(
        pt.CompiledProgram(p["main"], build_strategy=bench_strategy(pt)),
        [p["loss"]])
    assert "fused_adam" not in {o.type for o in ops}


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_fused_adam_is_bitwise_adam(amp):
    """One step with fuse_all_optimizer_ops alone against the plain
    program from the same weights: parameters, both moments and the beta
    powers bitwise equal."""
    j, jscope = _jax_init("fused")
    sides = []
    for fused in (False, True):
        p, scope = _port("fused", jscope)
        if amp:
            pmp.decorate(p["main"])
        bs = pt.BuildStrategy()
        bs.fuse_all_optimizer_ops = fused
        exe = pt.Executor(pt.CPUPlace())
        target = pt.CompiledProgram(p["main"], build_strategy=bs)
        types = [o.type for o in exe.lowered_ops(target, [p["loss"]])]
        assert ("fused_adam" in types) == fused
        assert ("adam" in types) != fused
        exe.run(target, feed=_batch(p["config"], 0), fetch_list=[p["loss"]],
                scope=scope)
        sides.append({n: scope.find_var(n).clone()
                      for n in scope.var_names()})
    plain, fused = sides
    assert sorted(plain) == sorted(fused)
    moved = 0
    for n in sorted(plain):
        assert torch.equal(plain[n], fused[n]), n
        moved += not torch.equal(
            plain[n], torch.from_numpy(np.array(jscope.find_var(n))))
    assert moved > 4 * len(p["main"].all_parameters())


def test_fused_adam_emitter_is_bitwise_adam_on_odd_shapes():
    """The emitter alone, on parameters of several shapes and step
    counts, against one adam op per parameter."""
    rng = np.random.RandomState(3)
    shapes = [(7,), (3, 5), (2, 3, 4), (1,)]
    ins = {k: [] for k in ("Param", "Grad", "Moment1", "Moment2",
                           "Beta1Pow", "Beta2Pow", "LearningRate")}
    for i, shp in enumerate(shapes):
        ins["Param"].append(torch.from_numpy(rng.randn(*shp).astype("f4")))
        ins["Grad"].append(torch.from_numpy(rng.randn(*shp).astype("f4")))
        ins["Moment1"].append(torch.from_numpy(rng.randn(*shp).astype("f4")))
        ins["Moment2"].append(torch.from_numpy(
            rng.rand(*shp).astype("f4")))
        ins["Beta1Pow"].append(torch.tensor([0.9 ** (i + 1)]))
        ins["Beta2Pow"].append(torch.tensor([0.98 ** (i + 1)]))
        ins["LearningRate"].append(torch.tensor([1e-3 * (i + 1)]))
    attrs = {"beta1": 0.9, "beta2": 0.98, "epsilon": 1e-9}
    ctx = pt.registry.EmitContext(torch.device("cpu"))
    fused = pt.registry.lookup("fused_adam").emitter(ctx, ins, attrs)
    for i in range(len(shapes)):
        one = pt.registry.lookup("adam").emitter(
            ctx, {k: [v[i]] for k, v in ins.items()}, attrs)
        for slot, vals in one.items():
            assert torch.equal(fused[slot][i], vals[0]), (slot, i)


def test_attention_launches_go_through_the_wrappers(monkeypatch):
    """The rewritten step calls the flash wrappers as the fused build
    does: per attention, the forward twice (op and grad recompute) and
    the backward once."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    j, jscope = _jax_init()
    p, scope = _port("unfused", jscope)
    pt.Executor(pt.CPUPlace()).run(
        pt.CompiledProgram(p["main"], build_strategy=bench_strategy(pt)),
        feed=_batch(p["config"], 0), fetch_list=[p["loss"]], scope=scope)
    assert calls == {"fwd": 6, "bwd": 3}


# ---------------------------------------------------------------------------
# knobs that are not ported raise
# ---------------------------------------------------------------------------

def _tiny_compiled(**bs_attrs):
    with punique.guard():
        p = ptransformer.build(**TINY)
    bs = pt.BuildStrategy()
    for k, v in bs_attrs.items():
        setattr(bs, k, v)
    return p, pt.CompiledProgram(p["main"], build_strategy=bs)


@pytest.mark.parametrize("knob,value,item", [
    ("auto_parallel", True, "A12"),
    ("verify_passes", True, "A14"),
])
def test_unported_build_strategy_knobs_raise(knob, value, item):
    p, target = _tiny_compiled(**{knob: value})
    with pytest.raises(NotImplementedError, match=item):
        pt.Executor(pt.CPUPlace()).run(target, feed=_batch(p["config"], 0),
                                       fetch_list=[p["loss"]])


def test_unported_execution_and_flag_knobs_raise():
    """num_iteration_per_run is ported (tests/test_torch_multi_step.py
    runs it): K steps per run leave the rewritten op list as it is. The
    verify_passes flag still raises."""
    p, target = _tiny_compiled()
    exe = pt.Executor(pt.CPUPlace())
    one = [o.type for o in exe.lowered_ops(target, [p["loss"]])]
    target._exec_strategy.num_iteration_per_run = 2
    assert [o.type for o in exe.lowered_ops(target, [p["loss"]])] == one
    PFLAGS.verify_passes = True
    try:
        with pytest.raises(NotImplementedError, match="A14"):
            pt.Executor(pt.CPUPlace()).lowered_ops(p["main"], [p["loss"]])
    finally:
        PFLAGS.verify_passes = False


@pytest.mark.parametrize("method", ["with_data_parallel", "with_distributed"])
def test_data_parallel_entry_points_raise(method):
    p, target = _tiny_compiled()
    args = () if method == "with_data_parallel" else (object(),)
    with pytest.raises(NotImplementedError, match="A12"):
        getattr(target, method)(*args)
    assert target.with_inference_optimize() is target
    assert target.program is p["main"]


def test_other_attention_impls_raise():
    with pytest.raises(NotImplementedError, match="A12"):
        ptransformer.build(attention_impl="ring", **TINY)


def test_compiled_program_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.Executor()
