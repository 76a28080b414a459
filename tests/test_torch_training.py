"""The port's Transformer training step against the JAX package's.

The programs: ``transformer.build`` in the two packages gives the same
train and startup programs, byte for byte, at transformer-tiny and at the
bench_transformer widths.

The steps: the JAX package's startup runs (its random stream), every
persistable of the train program is carried over as numpy arrays, and
the same seeded batches go through ``Executor(CPUPlace())`` in the port
and the JAX executor on ``JAX_PLATFORMS=cpu``. transformer-tiny is the
JAX package's own (tests/test_models.py::test_transformer_tiny), with
warmup_steps=4 so that the noam rate moves the parameters within a few
steps (at the default 8000 the first rate is 6e-8).

Tolerances. fp32: losses within 1e-5 relative; step-1 gradients within
1e-5 of each parameter's largest gradient; parameters within 2e-5 after 5
steps. The two differ only in summation order (XLA's against torch's).

bf16 AMP, op by op: every op of the train program, run in the port on the
JAX package's own input values, gives the JAX dtype and values within
2^-7 of the output's largest magnitude (one bf16 ulp at that magnitude);
fp32 within 1e-5 of it. End to end the two drift apart by more than
that, for two reasons: XLA on the CPU leaves some values that pass
through bf16 unrounded (likely its excess-precision default) where torch
rounds, and a ReLU whose input
lies within a bf16 ulp of 0 passes its gradient in one package and not in
the other. So losses are held within 1e-2 relative; the step-1 gradients
of all parameters together within 0.1 relative (L2), each parameter's
within 0.5; and after 5 steps each persistable's mean difference from the
JAX AMP run is at most twice bf16's own effect there (the mean difference
between the JAX package's fp32 and AMP runs), plus 1e-6. The last also
covers Adam, which divides by sqrt(v) + 1e-9: an element whose gradient
is near 0 moves by the full rate, in a direction the other package may
not share. No loss or gradient check is loosened for it.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as jmp
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
            d_model=16, d_inner_hid=32, warmup_steps=4)
BENCH = dict(src_vocab=32000, tgt_vocab=32000, max_len=256, n_layer=6,
             n_head=8, d_model=512, d_inner_hid=2048)
STEPS = 5


def _build_both(cfg):
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        with junique.guard():
            j = jtransformer.build(dropout_rate=0.0, **cfg)
        with punique.guard():
            p = ptransformer.build(**cfg)
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old
    return j, p


@pytest.mark.parametrize("cfg", [TINY, BENCH], ids=["tiny", "bench_widths"])
@pytest.mark.parametrize("program", ["main", "startup"])
def test_train_programs_bytes_identical(cfg, program):
    j, p = _build_both(cfg)
    assert p[program].desc.to_bytes() == j[program].desc.to_bytes()


def _batch(cfg, step):
    feed = ptransformer.make_fake_batch(2, cfg, seed=step)
    # ragged lengths, so the key-bias masks and the token mask bite
    feed["src_len"] = np.array([cfg["max_len"], 5], np.int32)
    feed["trg_len"] = np.array([6, cfg["max_len"]], np.int32)
    return feed


def _train_both(amp, steps=STEPS, jax_first=0):
    """Run ``jax_first`` steps in the JAX package alone, carry every
    persistable across, then ``steps`` steps in both. Returns per-step
    (jax, port) fetches of [loss, *param grads], and both scopes."""
    j, p = _build_both(TINY)
    if amp:
        jmp.decorate(j["main"])
        pmp.decorate(p["main"])
    block = p["main"].global_block()
    params = [v.name for v in p["main"].all_parameters()
              if block.has_var(v.name + "@GRAD")]
    fetch = [p["loss"].name] + [n + "@GRAD" for n in params]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    j["startup"].random_seed = 7
    with fluid.scope_guard(jscope):
        jexe.run(j["startup"])
        for s in range(jax_first):
            jexe.run(j["main"], feed=_batch(p["config"], 100 + s))
    persistables = [v.name for v in p["main"].list_vars() if v.persistable]
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in persistables},
        "cpu", program=p["main"])
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
    return _train_both(amp=False)


@pytest.fixture(scope="module")
def amp_run():
    return _train_both(amp=True)


def test_fp32_losses_match_jax(fp32_run):
    _, _, steps, _, _ = fp32_run
    jl = [_loss(j) for j, _ in steps]
    pl = [_loss(p) for _, p in steps]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert all(np.isfinite(pl)) and pl[-1] != pl[0]


def test_fp32_step1_gradients_match_jax(fp32_run):
    params, _, steps, _, _ = fp32_run
    jr, pr = steps[0]
    assert len(params) > 10
    for name, jg, pg in zip(params, jr[1:], pr[1:]):
        assert pg.dtype == np.float32 and pg.shape == jg.shape, name
        np.testing.assert_allclose(pg, jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max(),
                                   err_msg=name)


def test_fp32_parameters_match_jax_after_5_steps(fp32_run):
    _, persistables, _, jscope, pscope = fp32_run
    for name in persistables:
        want = np.asarray(jscope.find_var(name))
        got = pscope.find_var(name).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5,
                                   err_msg=name)
    # the step counter and the Adam powers moved in step with JAX's
    assert float(pscope.find_var("@LR_DECAY_COUNTER@").numpy()[0]) == STEPS


def test_amp_losses_match_jax(amp_run):
    _, _, steps, _, _ = amp_run
    jl = [_loss(j) for j, _ in steps]
    pl = [_loss(p) for _, p in steps]
    np.testing.assert_allclose(pl, jl, rtol=1e-2)


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


def test_amp_parameters_match_jax_after_5_steps(amp_run, fp32_run):
    """Master weights and Adam state stay fp32 under AMP."""
    _, persistables, _, jscope, pscope = amp_run
    jscope_fp32 = fp32_run[3]
    for name in persistables:
        want = np.asarray(jscope.find_var(name))
        got = pscope.find_var(name).numpy()
        assert got.dtype == want.dtype == np.float32, name
        bf16_effect = np.abs(np.asarray(jscope_fp32.find_var(name))
                             - want).mean()
        assert np.abs(got - want).mean() <= 2 * bf16_effect + 1e-6, name


def _replay(amp):
    """Every op of one train step, run by the port on the JAX package's
    values. Returns [(op type, var, jax value, port value)] for every
    output written once in the program; a name written more than once
    (a gradient and its sum, the counter, a parameter) takes the port's
    value, computed from the JAX package's inputs."""
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
    assert len(rows) > 150
    types = {r[0] for r in rows}
    assert {"flash_attention_grad", "mul_grad", "layer_norm_grad",
            "softmax_with_cross_entropy_grad", "lookup_table_grad",
            "reshape2_grad", "relu_grad"} <= types
    for op_type, name, want, got in rows:
        want = np.asarray(want)
        assert str(got.dtype).replace("torch.", "") == want.dtype.name, name
        if not want.size:
            continue
        want = want.astype(np.float32)
        scale = np.abs(want).max()
        tol = (2.0 ** -7 if amp else 1e-5) * scale + 1e-6
        err = np.abs(got.float().numpy() - want).max()
        assert err <= tol, (op_type, name, err, scale)


def test_resume_from_a_jax_scope_mid_training():
    """Two steps in the JAX package alone, then the whole scope (Adam's
    moments and powers, the step counter) carried across: the next step
    agrees as from a fresh start."""
    params, _, steps, _, _ = _train_both(amp=False, steps=1, jax_first=2)
    jr, pr = steps[0]
    assert abs(_loss(pr) - _loss(jr)) <= 1e-5 * abs(_loss(jr))
    for name, jg, pg in zip(params, jr[1:], pr[1:]):
        np.testing.assert_allclose(pg, jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max(),
                                   err_msg=name)


def test_every_attention_backward_goes_through_the_flash_wrappers(
        monkeypatch):
    """A train step calls flash_attention_bwd once per attention and the
    forward twice (the op and its grad's recompute); nothing else builds
    the [Tq, Tk] scores for the backward."""
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
    with punique.guard():
        m = ptransformer.build(**dict(TINY, n_layer=2))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(m["startup"], scope=scope)
    (loss,) = exe.run(m["main"], feed=_batch(m["config"], 0),
                      fetch_list=[m["loss"]], scope=scope)
    assert np.isfinite(loss).all()
    assert calls == {"fwd": 12, "bwd": 6}  # 2 layers: 6 attentions


def test_torch_func_vjp_ignores_the_executors_no_grad():
    """The generic grad emitter relies on it: torch.func.vjp records its
    forward inside torch.no_grad(), where autograd would record nothing."""
    x = torch.tensor([1.0, -2.0, 3.0])
    with torch.no_grad():
        out, vjp = torch.func.vjp(lambda t: (t * t).sum(), x)
        (g,) = vjp(torch.tensor(1.0))
    assert out.item() == 14.0
    assert torch.equal(g, 2 * x)
