"""BERT pretraining in the port against the JAX package's, on the CPU.

The programs: ``bert.build`` in the two packages gives the same main,
startup and test programs, byte for byte, at a tiny size (2 layers, d 32,
T 16) and at bench_bert's widths (bench.py:1069: 12 layers, d 768, T 128,
vocab 30522); so does the LAMB recipe (``is_train=False``, then
``LambOptimizer`` with ``GradientClipByGlobalNorm`` and a
``linear_lr_warmup`` of a ``polynomial_decay``).

The steps: the JAX package's startup runs, every persistable is carried
over as numpy arrays, and the same seeded batches (ragged ``seq_len``, so
the key bias masks keys) go through ``Executor(CPUPlace())`` in the port
and the JAX executor on ``JAX_PLATFORMS=cpu``.

Tolerances, as tests/test_torch_training.py holds the Transformer. fp32:
losses within 1e-5 relative; step-1 gradients within 1e-5 of each
parameter's largest gradient (the tied ``word_embedding`` among them: its
``lookup_table_grad`` and the masked-LM ``matmul`` grad summed by one
``sum`` op); every persistable within 2e-5 after 4 steps. bf16 AMP: losses
within 1e-2 relative, step-1 gradients within 0.1 relative in L2 together
and 0.5 each, persistables after 4 steps within twice bf16's own effect
(a package's fp32 run against its AMP run, the larger of the two
packages') plus 1e-6; op by op,
every op of a step run by the port on the JAX package's values within
2^-7 of each output's largest magnitude under AMP (one bf16 ulp) and 1e-5
in fp32. Through ``CompiledProgram`` under bench.py's BuildStrategy, the
JAX package's own bounds for the attention rewrite
(tests/test_attention_fusion.py:99-102): losses rtol 2e-4 atol 1e-5,
parameters rtol 2e-3 atol 2e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.models import bert as jbert
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import mixed_precision as pmp
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

TINY = dict(vocab_size=100, max_len=16, max_masked=4, n_layer=2, n_head=2,
            d_model=32, d_inner_hid=64)
BENCH = dict(vocab_size=30522, max_len=128, max_masked=20, n_layer=12,
             n_head=12, d_model=768, d_inner_hid=3072)
STEPS = 4
BATCH = 3


@pytest.fixture(autouse=True)
def _flags():
    old = (JFLAGS.op_callstack, PFLAGS.op_callstack,
           JFLAGS.fuse_optimizer_ops_on_cpu, PFLAGS.fuse_optimizer_ops_on_cpu)
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    JFLAGS.fuse_optimizer_ops_on_cpu = PFLAGS.fuse_optimizer_ops_on_cpu = True
    yield
    (JFLAGS.op_callstack, PFLAGS.op_callstack,
     JFLAGS.fuse_optimizer_ops_on_cpu,
     PFLAGS.fuse_optimizer_ops_on_cpu) = old


def recipe(mod, model, cfg):
    """Arm B of chip_smoke.py's phase 12 in either package: BERT's
    forward, then LAMB with a global-norm clip of 1.0 and a linear warmup
    (3 steps to 1e-3) of a polynomial decay (to 1e-5 over 10 steps).
    Returns the build's dict with the rate's Variable under "lr"."""
    m = model.build(is_train=False, **cfg)
    with mod.program_guard(m["main"], m["startup"]):
        sched = mod.layers.learning_rate_scheduler
        lr = sched.linear_lr_warmup(
            sched.polynomial_decay(1e-3, 10, 1e-5), 3, 0.0, 1e-3)
        mod.clip.set_gradient_clip(mod.clip.GradientClipByGlobalNorm(1.0))
        mod.optimizer.LambOptimizer(learning_rate=lr,
                                    weight_decay=0.01).minimize(m["loss"])
    m["lr"] = lr
    return m


def recipe_lr(step):
    """The recipe's rate at run ``step`` (the counter starts at 0), in
    float64."""
    if step < 3:
        return step / 3 * 1e-3
    return (1e-3 - 1e-5) * (1 - min(step, 10) / 10) + 1e-5


def _build_both(cfg, build="train"):
    with junique.guard():
        j = (jbert.build(**cfg) if build == "train"
             else recipe(fluid, jbert, cfg))
    with punique.guard():
        p = (pbert.build(**cfg) if build == "train"
             else recipe(pt, pbert, cfg))
    return j, p


@pytest.mark.parametrize("cfg", [TINY, BENCH], ids=["tiny", "bench_widths"])
@pytest.mark.parametrize("program", ["main", "startup", "test"])
def test_programs_bytes_identical(cfg, program):
    j, p = _build_both(cfg)
    assert p[program].desc.to_bytes() == j[program].desc.to_bytes()


@pytest.mark.parametrize("program", ["main", "startup"])
def test_lamb_recipe_programs_bytes_identical(program):
    j, p = _build_both(TINY, "recipe")
    assert p[program].desc.to_bytes() == j[program].desc.to_bytes()
    types = [o.type for o in p["main"].global_block().desc.ops]
    if program == "main":
        assert types.count("lamb") == len(p["main"].all_parameters())
        assert "sqrt" in types and "elementwise_max" in types


def _batch(cfg, step):
    feed = pbert.make_fake_batch(BATCH, cfg, seed=step)
    # ragged lengths (masked positions stay inside them), so the key bias
    # masks keys in two rows
    feed["seq_len"] = np.array([cfg["max_len"], 11, 6], np.int32)
    t = cfg["max_len"]
    for i, n in enumerate(feed["seq_len"]):
        feed["mask_pos"][i] = i * t + np.random.RandomState(step + i).choice(
            n, cfg["max_masked"], replace=False)
    return feed


def _start(j, p, amp=False):
    """The JAX startup's persistables in a port scope; both executors."""
    if amp:
        jmp.decorate(j["main"])
        pmp.decorate(p["main"])
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    j["startup"].random_seed = 7
    with fluid.scope_guard(jscope):
        jexe.run(j["startup"])
    persistables = [v.name for v in p["main"].list_vars() if v.persistable]
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in persistables},
        "cpu", program=p["main"])
    return jscope, jexe, pscope, pexe, persistables


def _train_both(amp, steps=STEPS):
    """``steps`` steps in both packages; per-step (jax, port) fetches of
    [loss, *param grads], the persistables and both scopes."""
    j, p = _build_both(TINY)
    jscope, jexe, pscope, pexe, persistables = _start(j, p, amp)
    block = p["main"].global_block()
    params = [v.name for v in p["main"].all_parameters()
              if block.has_var(v.name + "@GRAD")]
    fetch = [p["loss"].name] + [n + "@GRAD" for n in params]
    out = []
    for s in range(steps):
        feed = _batch(p["config"], s)
        with fluid.scope_guard(jscope):
            jr = jexe.run(j["main"], feed=feed, fetch_list=fetch)
        pr = pexe.run(p["main"], feed=feed, fetch_list=fetch, scope=pscope)
        out.append(([np.asarray(a, np.float32) for a in jr], pr))
    return params, persistables, out, jscope, pscope


def _loss(fetched):
    return float(np.asarray(fetched[0]).reshape(-1)[0])


@pytest.fixture(scope="module")
def fp32_run():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        return _train_both(amp=False)
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old


@pytest.fixture(scope="module")
def amp_run():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        return _train_both(amp=True)
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old


def test_fp32_losses_match_jax(fp32_run):
    _, _, steps, _, _ = fp32_run
    jl = [_loss(j) for j, _ in steps]
    pl = [_loss(p) for _, p in steps]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert all(np.isfinite(pl)) and len(set(pl)) == len(pl)


def test_fp32_step1_gradients_match_jax(fp32_run):
    params, _, steps, _, _ = fp32_run
    jr, pr = steps[0]
    assert "word_embedding" in params and len(params) > 30
    for name, jg, pg in zip(params, jr[1:], pr[1:]):
        assert pg.dtype == np.float32 and pg.shape == jg.shape, name
        np.testing.assert_allclose(pg, jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max(),
                                   err_msg=name)


def test_fp32_persistables_match_jax_after_4_steps(fp32_run):
    _, persistables, _, jscope, pscope = fp32_run
    for name in persistables:
        np.testing.assert_allclose(pscope.find_var(name).numpy(),
                                   np.asarray(jscope.find_var(name)),
                                   rtol=0, atol=2e-5, err_msg=name)


def test_amp_losses_match_jax(amp_run):
    _, _, steps, _, _ = amp_run
    np.testing.assert_allclose([_loss(p) for _, p in steps],
                               [_loss(j) for j, _ in steps], rtol=1e-2)


def test_amp_step1_gradients_match_jax(amp_run):
    params, _, steps, _, _ = amp_run
    jr, pr = steps[0]
    sq_diff = sq_ref = 0.0
    for name, jg, pg in zip(params, jr[1:], pr[1:]):
        assert pg.dtype == np.float32 and pg.shape == jg.shape, name
        diff, ref = np.linalg.norm(pg - jg), np.linalg.norm(jg)
        assert diff <= 0.5 * ref, name
        sq_diff, sq_ref = sq_diff + diff ** 2, sq_ref + ref ** 2
    assert np.sqrt(sq_diff) <= 0.1 * np.sqrt(sq_ref)


def test_amp_persistables_match_jax_after_4_steps(amp_run, fp32_run):
    """Each persistable's mean distance from the JAX AMP run within twice
    bf16's own effect (a package's fp32 run against its AMP run), the
    larger of the two packages' effects, plus 1e-6. The larger one: XLA
    on the CPU leaves some bf16 values unrounded, so the JAX package's
    own effect understates bf16's where Adam (epsilon 1e-6) moves every
    element by about the rate: the masked-LM head's layer_norm scale moves
    3.1e-6 from fp32 in the JAX package and 9.3e-6 in the port, whose
    every op agrees with the JAX one at one bf16 ulp on the same values
    (test_each_op_replayed_on_jax_values_agrees[amp])."""
    _, persistables, _, jscope, pscope = amp_run
    jscope_fp32, pscope_fp32 = fp32_run[3], fp32_run[4]
    for name in persistables:
        want = np.asarray(jscope.find_var(name))
        got = pscope.find_var(name).numpy()
        assert got.dtype == want.dtype == np.float32, name
        bf16_effect = max(
            np.abs(np.asarray(jscope_fp32.find_var(name)) - want).mean(),
            np.abs(pscope_fp32.find_var(name).numpy() - got).mean())
        assert np.abs(got - want).mean() <= 2 * bf16_effect + 1e-6, name


def _replay(amp):
    """Every op of one train step, run by the port on the JAX package's
    values: [(op type, var, jax value, port value)] for every output
    written once; names written more than once take the port's value."""
    j, p = _build_both(TINY)
    if amp:
        jmp.decorate(j["main"])
        pmp.decorate(p["main"])
    block = p["main"].global_block()
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(j["startup"])
    persistable = {v.name for v in p["main"].list_vars() if v.persistable}
    env = {n: torch.from_numpy(np.array(jscope.find_var(n)))
           for n in persistable}
    feed = _batch(p["config"], 0)
    env.update({n: torch.from_numpy(v) for n, v in feed.items()})
    ops = block.desc.ops
    writes = {}
    for op in ops:
        for n in op.output_arg_names():
            writes[n] = writes.get(n, 0) + 1
    names = sorted(n for n in writes
                   if n and n not in persistable and writes[n] == 1)
    with fluid.scope_guard(jscope):
        vals = jexe.run(j["main"], feed=feed, fetch_list=names)
    jvals = dict(zip(names, vals))
    for n, v in jvals.items():
        v = np.asarray(v)
        t = torch.from_numpy(v.astype(np.float32) if v.dtype.name ==
                             "bfloat16" else np.array(v))
        env[n] = t.to(torch.bfloat16) if v.dtype.name == "bfloat16" else t
    ctx = pt.registry.EmitContext(torch.device("cpu"), amp=amp)
    rows = []
    for op in ops:
        ins = {s: [env[n] if n else None for n in ns]
               for s, ns in op.inputs.items()}
        outs = pt.executor._emitter(op.type)(ctx, ins, op.attrs)
        for slot, ns in op.outputs.items():
            for n, v in zip(ns, outs.get(slot) or ()):
                if n in persistable or writes.get(n, 0) > 1:
                    env[n] = v
                elif n in jvals and slot != "XShape":
                    rows.append((op.type, n, jvals[n], v))
    return rows


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_each_op_replayed_on_jax_values_agrees(amp):
    rows = _replay(amp)
    types = {r[0] for r in rows}
    assert {"flash_attention_grad", "gather", "gather_grad", "slice",
            "gelu", "gelu_grad", "tanh", "tanh_grad", "matmul_grad",
            "lookup_table_grad", "layer_norm_grad",
            "softmax_with_cross_entropy_grad"} <= types
    for op_type, name, want, got in rows:
        want = np.asarray(want)
        assert str(got.dtype).replace("torch.", "") == want.dtype.name \
            or want.dtype.kind == got.numpy().dtype.kind == "i", name
        if not want.size:
            continue
        want = want.astype(np.float32)
        scale = np.abs(want).max()
        tol = (2.0 ** -7 if amp else 1e-5) * scale + 1e-6
        err = np.abs(got.float().numpy() - want).max()
        assert err <= tol, (op_type, name, err, scale)


def bench_strategy(mod):
    """bench.py:316-326's BuildStrategy, in either package."""
    bs = mod.BuildStrategy()
    bs.fuse_all_optimizer_ops = True
    bs.fuse_elewise_add_act_ops = True
    bs.memory_optimize = True
    bs.fuse_conv_ops = True
    bs.fuse_attention_ops = True
    return bs


@pytest.mark.parametrize("build,amp", [("train", False), ("train", True),
                                       ("recipe", False)],
                         ids=["adam_fp32", "adam_amp", "lamb_recipe_fp32"])
def test_compiled_steps_match_jax(build, amp):
    """4 steps (the recipe: 5, through its warmup) through
    CompiledProgram under the bench BuildStrategy in both packages, the
    rewritten op lists equal; the recipe's rate fetched each step against
    its closed form."""
    j, p = _build_both(TINY, build)
    jscope, jexe, pscope, pexe, persistables = _start(j, p, amp)
    jt = fluid.CompiledProgram(j["main"], build_strategy=bench_strategy(fluid))
    ptg = pt.CompiledProgram(p["main"], build_strategy=bench_strategy(pt))
    fetch = [p["loss"].name] + ([p["lr"].name] if build == "recipe" else [])
    pops = pexe.lowered_ops(ptg, fetch)
    types = [o.type for o in pops]
    assert types.count("flash_attention") == TINY["n_layer"]
    if build == "train":
        assert "fused_adam" in types and "adam" not in types
    jl, pl = [], []
    for s in range(STEPS + (build == "recipe")):
        feed = _batch(p["config"], s)
        with fluid.scope_guard(jscope):
            jr = jexe.run(jt, feed=feed, fetch_list=fetch)
        pr = pexe.run(ptg, feed=feed, fetch_list=fetch, scope=pscope)
        jl.append(_loss(jr))
        pl.append(_loss(pr))
        if build == "recipe":
            np.testing.assert_allclose(float(pr[1][0]), recipe_lr(s),
                                       rtol=1e-6, atol=1e-9)
    if amp:
        np.testing.assert_allclose(pl, jl, rtol=1e-2)
        return
    np.testing.assert_allclose(pl, jl, rtol=2e-4, atol=1e-5)
    for v in p["main"].all_parameters():
        np.testing.assert_allclose(pscope.find_var(v.name).numpy(),
                                   np.asarray(jscope.find_var(v.name)),
                                   rtol=2e-3, atol=2e-5, err_msg=v.name)


def test_lamb_recipe_matches_jax():
    """Arm B's recipe on a plain executor, 5 steps: losses, the rate and
    every persistable (LAMB's moments and powers, the step counter)."""
    j, p = _build_both(TINY, "recipe")
    jscope, jexe, pscope, pexe, persistables = _start(j, p)
    fetch = [p["loss"].name, p["lr"].name]
    for s in range(5):
        feed = _batch(p["config"], s)
        with fluid.scope_guard(jscope):
            jr = jexe.run(j["main"], feed=feed, fetch_list=fetch)
        pr = pexe.run(p["main"], feed=feed, fetch_list=fetch, scope=pscope)
        np.testing.assert_allclose(_loss(pr), _loss(jr), rtol=1e-5)
        np.testing.assert_allclose(float(pr[1][0]),
                                   float(np.asarray(jr[1]).ravel()[0]),
                                   rtol=1e-6, atol=1e-9)
    for name in persistables:
        np.testing.assert_allclose(pscope.find_var(name).numpy(),
                                   np.asarray(jscope.find_var(name)),
                                   rtol=0, atol=2e-5, err_msg=name)
    assert float(pscope.find_var("@LR_DECAY_COUNTER@").numpy()[0]) == 4.0


def test_attention_goes_through_the_flash_wrappers(monkeypatch):
    """A train step calls the forward twice per layer (the op and its
    grad's recompute) and the backward once, all with the key bias."""
    calls = {"fwd": 0, "bwd": 0, "kb": 0}
    real_fwd, real_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def fwd(q, k, v, kb=None, *a, **kw):
        calls["fwd"] += 1
        calls["kb"] += kb is not None
        return real_fwd(q, k, v, kb, *a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    with punique.guard():
        m = pbert.build(**TINY)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(m["startup"], scope=scope)
    (loss,) = exe.run(m["main"], feed=_batch(m["config"], 0),
                      fetch_list=[m["loss"]], scope=scope)
    assert np.isfinite(loss).all()
    assert calls == {"fwd": 4, "bwd": 2, "kb": 4}


@pytest.mark.parametrize("kwargs,error,item", [
    ({"dropout_rate": 0.1}, ValueError, "A1"),
    ({"attention_impl": "ring"}, NotImplementedError, "A12"),
    ({"attention_impl": "usp", "length_masks": False},
     NotImplementedError, "A12"),
])
def test_unported_options_raise_naming_their_item(kwargs, error, item):
    with pytest.raises(error, match=item):
        pbert.build(**dict(TINY, **kwargs))
