"""The slice's models in the port against the JAX package, on the CPU:
``testing.models.transformer_label_smooth`` (the Transformer trained with
PaddleNLP's label smoothing) and ``testing.models.word2vec_heads`` (the
zoo's word2vec with an nce or an hsigmoid head), built by either package.

- **Programs.** main, startup and test byte-identical, the Transformer at
  a tiny width and its main program at the Transformer-base widths too;
  the smoothing is one ``scale`` op after ``one_hot`` (the JAX layer's
  program), and the cross entropy reads it as a soft label.
- **Transformer steps.** 5 steps from the JAX package's startup, both
  packages on the same seeded batches, at the tolerances of
  tests/test_torch_training.py: fp32 losses within 1e-5 relative, step-1
  gradients within 1e-5 of each parameter's largest gradient, parameters
  within 2e-5 after 5 steps; bf16 AMP losses within 1e-2 relative, step-1
  gradients within 0.1 relative (L2) together and 0.5 each. The test
  program's token accuracy (``arg_max``) equal in both and to a numpy
  recount from its logits.
- **word2vec.** The hsigmoid head's 5 SGD steps within the same fp32
  bounds. The nce head draws its negatives from different streams
  (ROADMAP C "RNG"): its loss falls over 30 steps on one batch in each
  package; its grads are held op by op in tests/test_torch_loss_ops.py.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import mixed_precision as pmp
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.models import word2vec as pword2vec
from paddle_tpu_torch.testing import models as tmodels
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

TINY = dict(src_vocab=50, tgt_vocab=60, max_len=8, n_layer=1, n_head=2,
            d_model=16, d_inner_hid=32, warmup_steps=4)
BENCH = dict(src_vocab=32000, tgt_vocab=32000, max_len=256, n_layer=6,
             n_head=8, d_model=512, d_inner_hid=2048)
W2V_SMALL = dict(dict_size=100, embed_size=8, hidden_size=16)
STEPS = 5


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def build_both(builder, **kw):
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        with junique.guard():
            j = builder(fluid, **kw)
        with punique.guard():
            p = builder(pt, **kw)
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old
    return j, p


PROGRAMS = [(tmodels.transformer_label_smooth, TINY, prog)
            for prog in ("main", "startup", "test")] + [
    (tmodels.transformer_label_smooth, BENCH, "main")] + [
    (tmodels.word2vec_heads, dict(head=h), prog)
    for h in tmodels.WORD2VEC_HEADS for prog in ("main", "startup", "test")]


@pytest.mark.parametrize(
    "builder,kw,program", PROGRAMS,
    ids=[f"{b.__name__}-{kw.get('head', 'bench' if kw is BENCH else 'tiny')}"
         f"-{prog}" for b, kw, prog in PROGRAMS])
def test_programs_bytes_identical(builder, kw, program):
    j, p = build_both(builder, **kw)
    assert p[program].desc.to_bytes() == j[program].desc.to_bytes()


def test_label_smoothing_is_one_hot_then_scale():
    _, p = build_both(tmodels.transformer_label_smooth, **TINY)
    ops = p["main"].global_block().ops
    types = [op.type for op in ops]
    assert "label_smooth" not in types
    k = types.index("one_hot")
    smooth = ops[k + 1]
    assert smooth.type == "scale"
    assert smooth.attr("scale") == pytest.approx(0.9)
    assert smooth.attr("bias") == pytest.approx(0.1 / TINY["tgt_vocab"])
    ce = [op for op in ops if op.type == "softmax_with_cross_entropy"]
    assert len(ce) == 1 and ce[0].attr("soft_label") is True
    assert ce[0].input("Label") == smooth.output("Out")


def _batch(cfg, step):
    feed = ptransformer.make_fake_batch(2, cfg, seed=step)
    # ragged lengths, so the key-bias masks and the token mask bite
    feed["src_len"] = np.array([cfg["max_len"], 5], np.int32)
    feed["trg_len"] = np.array([6, cfg["max_len"]], np.int32)
    return feed


def _carry(j, p, jscope):
    """A port scope holding the JAX scope's persistables."""
    persistables = [v.name for v in p["main"].list_vars() if v.persistable]
    pscope = pt.Scope()
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in persistables},
        "cpu", program=p["main"])
    return persistables, pscope


def _train_both(j, p, batch, steps=STEPS, seed=7):
    """The JAX package's startup, its persistables carried into the port,
    then ``steps`` steps of both on ``batch(step)``. Returns the params,
    the persistables, per-step (jax, port) fetches of [loss, *param
    grads], and both scopes."""
    block = p["main"].global_block()
    params = [v.name for v in p["main"].all_parameters()
              if block.has_var(v.name + "@GRAD")]
    fetch = [p["loss"].name] + [n + "@GRAD" for n in params]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    j["startup"].random_seed = seed
    with fluid.scope_guard(jscope):
        jexe.run(j["startup"])
    persistables, pscope = _carry(j, p, jscope)
    pexe = pt.Executor(pt.CPUPlace())
    out = []
    for s in range(steps):
        feed = batch(s)
        with fluid.scope_guard(jscope):
            jr = jexe.run(j["main"], feed=feed, fetch_list=fetch)
        pr = pexe.run(p["main"], feed=feed, fetch_list=fetch, scope=pscope)
        out.append(([np.asarray(a, np.float32) for a in jr], pr))
    return params, persistables, out, jscope, pscope


def _loss(fetched):
    return float(np.asarray(fetched[0]).reshape(-1)[0])


@pytest.fixture(scope="module")
def fp32_run():
    j, p = build_both(tmodels.transformer_label_smooth, **TINY)
    return (j, p) + _train_both(j, p, lambda s: _batch(p["config"], s))


@pytest.fixture(scope="module")
def amp_run():
    j, p = build_both(tmodels.transformer_label_smooth, **TINY)
    jmp.decorate(j["main"])
    pmp.decorate(p["main"])
    return (j, p) + _train_both(j, p, lambda s: _batch(p["config"], s))


def test_fp32_losses_match_jax(fp32_run):
    steps = fp32_run[4]
    jl = [_loss(j) for j, _ in steps]
    pl = [_loss(p) for _, p in steps]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert all(np.isfinite(pl)) and pl[-1] != pl[0]


def test_fp32_step1_gradients_match_jax(fp32_run):
    params, steps = fp32_run[2], fp32_run[4]
    jr, pr = steps[0]
    assert len(params) > 10
    for name, jg, pg in zip(params, jr[1:], pr[1:]):
        assert pg.dtype == np.float32 and pg.shape == jg.shape, name
        np.testing.assert_allclose(pg, jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max(),
                                   err_msg=name)


def test_fp32_parameters_match_jax_after_5_steps(fp32_run):
    persistables, jscope, pscope = fp32_run[3], fp32_run[5], fp32_run[6]
    for name in persistables:
        np.testing.assert_allclose(pscope.find_var(name).numpy(),
                                   np.asarray(jscope.find_var(name)),
                                   rtol=0, atol=2e-5, err_msg=name)


def test_amp_losses_match_jax(amp_run):
    steps = amp_run[4]
    np.testing.assert_allclose([_loss(p) for _, p in steps],
                               [_loss(j) for j, _ in steps], rtol=1e-2)


def test_amp_step1_gradients_match_jax(amp_run):
    params, steps = amp_run[2], amp_run[4]
    jr, pr = steps[0]
    sq_diff = sq_ref = 0.0
    for name, jg, pg in zip(params, jr[1:], pr[1:]):
        assert pg.dtype == np.float32 and pg.shape == jg.shape, name
        diff, ref = np.linalg.norm(pg - jg), np.linalg.norm(jg)
        assert diff <= 0.5 * ref, name
        sq_diff, sq_ref = sq_diff + diff ** 2, sq_ref + ref ** 2
    assert np.sqrt(sq_diff) <= 0.1 * np.sqrt(sq_ref)


def test_token_accuracy_matches_jax_and_a_recount(fp32_run):
    """The test program on the trained state: the arg_max token accuracy
    over the trg_len mask, equal in both packages and to a numpy recount
    of the fetched logits."""
    j, p, jscope, pscope = fp32_run[0], fp32_run[1], fp32_run[5], \
        fp32_run[6]
    feed = _batch(p["config"], 11)
    fetch = [p["accuracy"].name, p["logits"].name]
    with fluid.scope_guard(jscope):
        jacc, _ = fluid.Executor(fluid.CPUPlace()).run(
            j["test"], feed=feed, fetch_list=fetch)
    pacc, logits = pt.Executor(pt.CPUPlace()).run(
        p["test"], feed=feed, fetch_list=fetch, scope=pscope)
    mask = (np.arange(TINY["max_len"])[None, :]
            < feed["trg_len"][:, None]).astype(np.float32)
    hits = (logits.argmax(-1) == feed["lbl_word"][..., 0]) * mask
    assert float(pacc) == pytest.approx(hits.sum() / mask.sum(), abs=1e-7)
    assert float(pacc) == pytest.approx(float(np.asarray(jacc)), abs=1e-7)


# ---------------------------------------------------------------------------
# word2vec with the nce and hsigmoid heads
# ---------------------------------------------------------------------------

def test_word2vec_hsigmoid_steps_match_jax():
    j, p = build_both(tmodels.word2vec_heads, head="hsigmoid", lr=0.5,
                      **W2V_SMALL)
    _, persistables, steps, jscope, pscope = _train_both(
        j, p, lambda s: pword2vec.make_fake_batch(8, 100, seed=s))
    jl = [_loss(a) for a, _ in steps]
    pl = [_loss(b) for _, b in steps]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jr, pr = steps[0]
    for jg, pg in zip(jr[1:], pr[1:]):
        np.testing.assert_allclose(pg, jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max())
    for name in persistables:
        np.testing.assert_allclose(pscope.find_var(name).numpy(),
                                   np.asarray(jscope.find_var(name)),
                                   rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("fl", [fluid, pt], ids=["jax", "port"])
def test_word2vec_nce_loss_falls(fl):
    """30 SGD steps on one batch of 64 from the seeded startup; the
    negatives are drawn anew each step."""
    guard = junique if fl is fluid else punique
    with guard.guard():
        m = tmodels.word2vec_heads(fl, head="nce", lr=0.5, **W2V_SMALL)
    feed = pword2vec.make_fake_batch(64, 100, seed=3)
    scope = fl.Scope()
    exe = fl.Executor(fl.CPUPlace())
    losses = []
    if fl is fluid:
        with fluid.scope_guard(scope):
            exe.run(m["startup"])
            for _ in range(30):
                losses.append(_loss(exe.run(m["main"], feed=feed,
                                            fetch_list=[m["loss"]])))
    else:
        exe.run(m["startup"], scope=scope)
        for _ in range(30):
            losses.append(_loss(exe.run(m["main"], feed=feed,
                                        fetch_list=[m["loss"]],
                                        scope=scope)))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5]), losses
