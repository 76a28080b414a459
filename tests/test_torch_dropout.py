"""The port's ``dropout`` op, its grad and the models' dropout sites, on
the CPU, against the JAX package's.

The two packages' random streams differ (a Threefry key against a
``torch.Generator``, ROADMAP C "RNG"), so masks are not compared; the
arithmetic is, given one mask: the port's output on the JAX op's mask
equals the JAX op's output, and the port's grad on a mask equals the JAX
grad's on it, both within 1e-6 relative (the two may divide by 1 - p or
multiply by its reciprocal: an ulp). ``is_test`` in both
implementations equal to the JAX op's. Programs with dropout, the
Transformer's at rates 0 and 0.1 with both attention impls and BERT's,
byte-identical to the JAX package's; at 0.1 no ``flash_attention`` op is
left (the dense chain), as in the JAX package. In the executor: the keep
rate within 5 binomial standard deviations, a fresh mask each run, the
grad on the forward's mask bitwise, and the generator's state carried in
a checkpoint (tests/test_torch_checkpoint.py and test_torch_elastic.py
hold the resume).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

RTOL = 1e-6
IMPLS = ["downgrade_in_infer", "upscale_in_train"]


@pytest.fixture(autouse=True)
def _no_callstacks():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _x(shape=(6, 40), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port_op(op_type, ins, attrs, gen=None):
    ctx = preg.EmitContext(torch.device("cpu"), generator=gen)
    outs = preg.lookup(op_type).emitter(
        ctx, {k: [torch.from_numpy(np.asarray(v))] for k, v in ins.items()},
        attrs)
    return {k: v[0].numpy() for k, v in outs.items()}


def _jax_ctx():
    class Ctx(jreg.EmitContext):
        def next_rng(self):
            return jax.random.PRNGKey(7)
    return Ctx()


def _jax_op(op_type, ins, attrs):
    outs = jreg.lookup(op_type).emitter(
        _jax_ctx(), {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs)
    return {k: np.asarray(v[0]) for k, v in outs.items()}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
def test_output_on_the_jax_mask_matches_jax(impl, p):
    from paddle_tpu_torch.ops.kernels_nn import _dropout_apply
    x = _x()
    attrs = {"dropout_prob": p, "dropout_implementation": impl}
    j = _jax_op("dropout", {"X": x}, attrs)
    assert j["Mask"].dtype == np.uint8
    got = _dropout_apply(torch.from_numpy(x),
                         torch.from_numpy(j["Mask"]).float(), p, impl)
    np.testing.assert_allclose(got.numpy(), j["Out"], rtol=RTOL, atol=0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("p", [0.1, 0.5, 1.0])
def test_grad_on_a_mask_matches_jax(impl, p):
    og = _x(seed=1)
    mask = (np.random.RandomState(2).rand(*og.shape) > p).astype(np.uint8)
    attrs = {"dropout_prob": p, "dropout_implementation": impl}
    ins = {"Mask": mask, "Out@GRAD": og}
    got = _port_op("dropout_grad", ins, attrs)["X@GRAD"]
    np.testing.assert_allclose(got, _jax_op("dropout_grad", ins,
                                            attrs)["X@GRAD"],
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_is_test_matches_jax(impl):
    x = _x()
    attrs = {"dropout_prob": 0.3, "dropout_implementation": impl,
             "is_test": True}
    got, want = _port_op("dropout", {"X": x}, attrs), _jax_op(
        "dropout", {"X": x}, attrs)
    np.testing.assert_allclose(got["Out"], want["Out"], rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got["Mask"], want["Mask"])


def test_port_op_draws_keep_masks_at_the_rate():
    """The port's own draw: Mask marks Out's kept elements, the keep
    share within 5 binomial sigmas of 1 - p, bf16 in and out."""
    x = np.ones((200, 500), np.float32)
    gen = torch.Generator().manual_seed(3)
    for p in (0.1, 0.5):
        out = _port_op("dropout", {"X": x},
                       {"dropout_prob": p,
                        "dropout_implementation": "upscale_in_train"}, gen)
        keep = out["Mask"].astype(bool)
        n = keep.size
        assert abs(keep.mean() - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)
        np.testing.assert_allclose(out["Out"][keep], 1 / (1 - p), rtol=RTOL)
        assert not out["Out"][~keep].any()
    ctx = preg.EmitContext(torch.device("cpu"), generator=gen)
    xb = torch.ones(8, 8, dtype=torch.bfloat16)
    out = preg.lookup("dropout").emitter(ctx, {"X": [xb]},
                                         {"dropout_prob": 0.5})
    assert out["Out"][0].dtype == torch.bfloat16


def test_registry_flags_match_jax():
    for t in ("dropout", "dropout_grad"):
        j, p = jreg.lookup(t), preg.lookup(t)
        assert p.no_grad == j.no_grad, t
        assert tuple(p.intermediate_outputs) == tuple(
            j.intermediate_outputs), t
    assert preg.lookup("dropout").needs_rng


def _dropout_net(mod, uniq, impl, is_test=False):
    main, startup = mod.Program(), mod.Program()
    main.random_seed = startup.random_seed = 9
    with uniq.guard(), mod.program_guard(main, startup):
        x = mod.layers.data("x", shape=[64])
        x.stop_gradient = False
        h = mod.layers.fc(x, size=64)
        d = mod.layers.dropout(h, dropout_prob=0.25, is_test=is_test,
                               dropout_implementation=impl)
        loss = mod.layers.mean(mod.layers.square_error_cost(
            d, mod.layers.data("y", shape=[64])))
        mod.backward.append_backward(loss)
    return main, startup, h, d, loss


@pytest.mark.parametrize("impl", IMPLS)
def test_dropout_programs_match_jax(impl):
    for is_test in (False, True):
        j = _dropout_net(fluid, junique, impl, is_test)
        p = _dropout_net(pt, punique, impl, is_test)
        assert p[0].desc.to_bytes() == j[0].desc.to_bytes()


@pytest.mark.parametrize("impl", IMPLS)
def test_executor_masks_fresh_and_grad_on_the_forward_mask(impl):
    main, startup, h, d, loss = _dropout_net(pt, punique, impl)
    blk = main.global_block()
    op = next(o for o in blk.desc.ops if o.type == "dropout")
    mask = op.output("Mask")[0]
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": _x((32, 64)), "y": _x((32, 64), seed=5)}
    fetch = [mask, d.name, h.name, d.name + "@GRAD", h.name + "@GRAD"]
    runs = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(3)]
    masks = [r[0] for r in runs]
    assert all(not np.array_equal(masks[i], masks[i + 1]) for i in range(2))
    for m, out, hv, og, hg in runs:
        keep = m.astype(np.float32)
        want = torch.from_numpy(hv) * torch.from_numpy(keep)
        want_g = torch.from_numpy(og) * torch.from_numpy(keep)
        if impl == "upscale_in_train":
            want, want_g = want / 0.75, want_g / 0.75
        np.testing.assert_array_equal(out, want.numpy())
        np.testing.assert_array_equal(hg, want_g.numpy())
        assert 0 < m.mean() < 1


TINY = dict(n_layer=1, n_head=2, d_model=16, d_inner_hid=32, src_vocab=50,
            tgt_vocab=50, max_len=8)
BERT_TINY = dict(vocab_size=60, max_len=16, max_masked=4, n_layer=1,
                 n_head=2, d_model=16, d_inner_hid=32)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("impl", ["fused", "unfused"])
def test_transformer_programs_match_jax(rate, impl):
    with junique.guard():
        j = jtransformer.build(dropout_rate=rate, attention_impl=impl, **TINY)
    with punique.guard():
        p = ptransformer.build(dropout_rate=rate, attention_impl=impl,
                               **TINY)
    for k in ("main", "startup", "test"):
        assert p[k].desc.to_bytes() == j[k].desc.to_bytes(), k
    types = [o.type for o in p["main"].global_block().desc.ops]
    assert ("dropout" in types) == bool(rate)
    assert ("flash_attention" in types) == (impl == "fused" and not rate)
    test_types = [o for o in p["test"].global_block().desc.ops
                  if o.type == "dropout"]
    assert all(o.attrs["is_test"] for o in test_types)


def test_bert_program_matches_jax():
    with junique.guard():
        j = jbert.build(dropout_rate=0.1, **BERT_TINY)
    with punique.guard():
        p = pbert.build(dropout_rate=0.1, **BERT_TINY)
    assert p["main"].desc.to_bytes() == j["main"].desc.to_bytes()
    with pytest.raises(ValueError, match="dropout_rate=0"):
        pbert.build(dropout_rate=0.1, attention_impl="unfused", **BERT_TINY)


def test_transformer_with_dropout_trains_on_the_cpu():
    with punique.guard():
        m = ptransformer.build(dropout_rate=0.1, warmup_steps=2, **TINY)
    m["startup"].random_seed = m["main"].random_seed = 1
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(m["startup"], scope=scope)
    feed = ptransformer.make_fake_batch(4, m["config"], seed=0)
    losses = [float(exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                            scope=scope)[0].ravel()[0]) for _ in range(4)]
    assert np.isfinite(losses).all() and len(set(losses)) == 4
    test_losses = [float(exe.run(m["test"], feed=feed,
                                 fetch_list=[m["loss"]],
                                 scope=scope)[0].ravel()[0])
                   for _ in range(2)]
    assert test_losses[0] == test_losses[1]  # is_test: no draw
