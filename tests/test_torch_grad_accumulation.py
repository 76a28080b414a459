"""Gradient accumulation in the port (``BuildStrategy.
gradient_accumulation_steps``, the executor's ``_Accumulation``) on the
CPU, against the JAX package's (its BatchMergePass analog,
paddle_tpu/executor.py).

The scenarios of tests/test_grad_accumulation.py: M microbatches with the
mean gradient against one big batch (the JAX test's 1e-5 relative, 1e-6
absolute: only the summation order differs), batch_norm's statistics
threading from one microbatch to the next, and a batch not divisible by
M raising. Each is also held against the JAX package's accumulation from
the same initial weights: losses within 1e-5 relative and every
persistable within 1e-6 absolute plus 1e-5 relative. A tiny Transformer
(AMP off) through CompiledProgram with M = 2 against the JAX package's,
and accumulation inside ``run(iterations=K)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_callstacks():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _mlp(mod):
    x = mod.layers.data("x", shape=[8], dtype="float32")
    y = mod.layers.data("y", shape=[1], dtype="float32")
    h = mod.layers.fc(x, size=16, act="relu")
    pred = mod.layers.fc(h, size=1)
    loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
    mod.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _bn_net(mod):
    x = mod.layers.data("x", shape=[4], dtype="float32")
    y = mod.layers.data("y", shape=[1], dtype="float32")
    h = mod.layers.fc(x, size=8)
    h = mod.layers.batch_norm(h, moving_mean_name="bn_mean",
                              moving_variance_name="bn_var")
    pred = mod.layers.fc(h, size=1)
    loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
    mod.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def _mlp_feeds(n, batch=16):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        xb = rng.rand(batch, 8).astype(np.float32)
        out.append({"x": xb, "y": xb.sum(axis=1, keepdims=True)})
    return out


def _bn_feeds(n, batch=8):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        xb = rng.rand(batch, 4).astype(np.float32)
        out.append({"x": xb, "y": xb.mean(1, keepdims=True)})
    return out


def _pair(net, seed=7):
    """(jax main, startup, loss), (port main, startup, loss)."""
    out = []
    for mod, uniq in ((fluid, junique), (pt, punique)):
        main, startup = mod.Program(), mod.Program()
        main.random_seed = startup.random_seed = seed
        with uniq.guard(), mod.program_guard(main, startup):
            loss = net(mod)
        out.append((main, startup, loss))
    return out


def _compiled(mod, main, accum):
    if accum <= 1:
        return main
    bs = mod.BuildStrategy()
    bs.gradient_accumulation_steps = accum
    return mod.CompiledProgram(main, build_strategy=bs)


def _train_both(net, feeds, accums, seed=7, iterations=None):
    """Both packages from the JAX startup's weights, each ``accums`` arm
    from its own scope; returns {(pkg, accum): (losses, state)}."""
    (jm, js, jl), (pm, ps, pl) = _pair(net, seed)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(js)
    names = [v.name for v in pm.list_vars() if v.persistable]
    init = {n: np.asarray(jscope.find_var(n)).copy() for n in names}
    out = {}
    for accum in accums:
        jscope = fluid.Scope()
        for n, v in init.items():
            jscope.set_var(n, jnp.asarray(v))
        pscope = pt.Scope()
        pt.io.set_params_from_numpy(pscope, init, "cpu", program=pm)
        pexe = pt.Executor(pt.CPUPlace())
        jt, pt_ = _compiled(fluid, jm, accum), _compiled(pt, pm, accum)
        jls, pls = [], []
        for f in feeds:
            with fluid.scope_guard(jscope):
                jls.append(np.asarray(jexe.run(
                    jt, feed=f, fetch_list=[jl],
                    iterations=iterations)[0]).ravel())
            pls.append(np.asarray(pexe.run(
                pt_, feed=f, fetch_list=[pl], scope=pscope,
                iterations=iterations)[0]).ravel())
        out["jax", accum] = (np.concatenate(jls), {
            n: np.asarray(jscope.find_var(n)) for n in names})
        out["port", accum] = (np.concatenate(pls), {
            n: pscope.find_var(n).numpy() for n in names})
    return out


def _close_states(a, b, tol):
    assert a.keys() == b.keys()
    for n in a:
        np.testing.assert_allclose(a[n], b[n], err_msg=n, **tol)


def test_accum_matches_big_batch_and_jax():
    out = _train_both(_mlp, _mlp_feeds(4), (1, 4))
    np.testing.assert_allclose(out["port", 4][0], out["port", 1][0],
                               **LOSS_TOL)
    _close_states(out["port", 4][1], out["port", 1][1], STATE_TOL)
    np.testing.assert_allclose(out["port", 4][0], out["jax", 4][0],
                               **LOSS_TOL)
    _close_states(out["port", 4][1], out["jax", 4][1], STATE_TOL)


def test_accum_with_batch_norm_threads_stats_as_jax():
    """The moving statistics after 3 steps of 2 microbatches: those of
    the JAX package's accumulation (each microbatch's batch statistics
    folded in turn), not the big batch's."""
    out = _train_both(_bn_net, _bn_feeds(3), (1, 2), seed=3)
    port, jax_ = out["port", 2][1], out["jax", 2][1]
    assert {"bn_mean", "bn_var"} <= set(port)
    _close_states(port, jax_, STATE_TOL)
    np.testing.assert_allclose(out["port", 2][0], out["jax", 2][0],
                               **LOSS_TOL)
    assert not np.allclose(port["bn_mean"], out["port", 1][1]["bn_mean"],
                           rtol=0, atol=1e-7)
    assert all(np.isfinite(v).all() for v in port.values())


def test_accum_inside_k_step_runs_as_jax():
    """run(iterations=2) with M = 2 (the JAX package's scan of scans): the
    stacked losses and the state."""
    sup = []
    feeds = _mlp_feeds(4)
    for i in range(0, 4, 2):
        sup.append({k: np.stack([feeds[i][k], feeds[i + 1][k]])
                    for k in feeds[i]})
    out = _train_both(_mlp, sup, (2,), iterations=2)
    np.testing.assert_allclose(out["port", 2][0], out["jax", 2][0],
                               **LOSS_TOL)
    assert out["port", 2][0].shape == (4,)
    _close_states(out["port", 2][1], out["jax", 2][1], STATE_TOL)


def test_accum_indivisible_batch_raises():
    (_, _, _), (main, startup, loss) = _pair(_mlp)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="divisible|accum"):
        exe.run(_compiled(pt, main, 3), feed={
            "x": np.ones((4, 8), np.float32),
            "y": np.ones((4, 1), np.float32)}, fetch_list=[loss],
            scope=scope)


def test_program_attribute_and_no_passes_under_accumulation():
    """``program._gradient_accumulation_steps`` accumulates as the
    BuildStrategy knob does; the pass pipeline runs on neither (the JAX
    package's rule)."""
    (_, _, _), (main, startup, loss) = _pair(_mlp)
    feeds = _mlp_feeds(2)
    losses = {}
    for how in ("strategy", "attribute"):
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        if how == "strategy":
            target = _compiled(pt, main, 4)
        else:
            main._gradient_accumulation_steps = 4
            target = main
        losses[how] = [exe.run(target, feed=f, fetch_list=[loss],
                               scope=scope)[0] for f in feeds]
        main.__dict__.pop("_gradient_accumulation_steps", None)
    np.testing.assert_array_equal(losses["strategy"], losses["attribute"])
    bs = pt.BuildStrategy()
    bs.fuse_all_optimizer_ops = bs.memory_optimize = True
    bs.gradient_accumulation_steps = 2
    PFLAGS.fuse_optimizer_ops_on_cpu = True
    try:
        ops = pt.Executor(pt.CPUPlace()).lowered_ops(
            pt.CompiledProgram(main, build_strategy=bs), [loss])
    finally:
        PFLAGS.fuse_optimizer_ops_on_cpu = False
    assert "sgd" in [o.type for o in ops]
    assert "fused_sgd" not in [o.type for o in ops]


TINY = dict(n_layer=1, n_head=2, d_model=16, d_inner_hid=32, src_vocab=60,
            tgt_vocab=60, max_len=8)


def test_transformer_accumulation_matches_jax():
    """The tiny Transformer through CompiledProgram with M = 2, 3 steps:
    losses and state against the JAX package's accumulation. Not against
    the big batch: the noam schedule's rate ops carry the forward role
    (in both packages' byte-identical programs), so under accumulation
    they run with the forward, before the counter's increment (an
    LRSCHED op, after the boundary): each step takes the previous step's
    rate, 0 at the first, in the JAX package and in the port alike."""
    with junique.guard():
        j = jtransformer.build(dropout_rate=0.0, warmup_steps=2, **TINY)
    with punique.guard():
        p = ptransformer.build(warmup_steps=2, **TINY)
    assert p["main"].desc.to_bytes() == j["main"].desc.to_bytes()
    j["startup"].random_seed = 4
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(j["startup"])
    names = [v.name for v in p["main"].list_vars() if v.persistable]
    init = {n: np.asarray(jscope.find_var(n)).copy() for n in names}
    feeds = [ptransformer.make_fake_batch(4, p["config"], seed=s)
             for s in range(3)]
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.set_params_from_numpy(pscope, init, "cpu", program=p["main"])
    target = _compiled(pt, p["main"], 2)
    got = [float(pexe.run(target, feed=f, fetch_list=[p["loss"]],
                          scope=pscope)[0].ravel()[0]) for f in feeds]
    jt = _compiled(fluid, j["main"], 2)
    with fluid.scope_guard(jscope):
        jl = [float(np.asarray(jexe.run(jt, feed=f,
                                        fetch_list=[j["loss"]])[0]).ravel()[0])
              for f in feeds]
    jstate = {n: np.asarray(jscope.find_var(n)) for n in names}
    np.testing.assert_allclose(got, jl, **LOSS_TOL)
    assert got[1] != got[0]
    for n in names:
        np.testing.assert_allclose(pscope.find_var(n).numpy(), jstate[n],
                                   err_msg=n, **STATE_TOL)
