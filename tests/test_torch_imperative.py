"""The port's imperative (dygraph) mode on the CPU, against the JAX
package's (tests/test_imperative.py, each of its 12 tests on both).

The same numpy inputs, and the same ``np.random`` seed for the layers'
parameters, go through ``paddle_tpu.imperative`` (a tape of ``jax.vjp``
pullbacks) and ``paddle_tpu_torch.imperative`` (torch autograd). Forward
values, tape gradients and SGD/Adam parameters after 3 steps agree within
1e-5 relative (RTOL; of the largest magnitude for a whole tensor, where a
few entries are near zero). ``recompute``'s gradients are bitwise the plain
run's in the port; dropout draws from a ``torch.Generator`` in the port and
a Threefry key in JAX, so masks are compared within the port only (ROADMAP
C "RNG"). The ops with a grad emitter of their own are held by their tape
gradients against JAX's tape (``flash_attention`` through its plain
versions on the CPU; ``dropout`` and ``nce``, whose draws differ, against
the port's own grad emitter on the forward's mask and samples). A tiny
dygraph ResNet (chip_smoke.py's ``dygraph_resnet``: 2 bottlenecks, 32x32)
and a 1-layer encoder with ``flash_attention`` (``dygraph_encoder``) are
held against JAX's tape, and the ResNet's first step against the port's
``Executor`` on the declarative ``models/resnet.py`` program.
"""

import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import imperative as J
from paddle_tpu import registry as jreg

import paddle_tpu_torch as pt
from paddle_tpu_torch import imperative as P
from paddle_tpu_torch import registry as preg

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

RTOL = 1e-5
CPU = pt.CPUPlace()


def pguard(seed=0):
    return P.guard(CPU, seed=seed)


def jguard(seed=0):
    return J.guard(seed=seed)


def both(fn, seed=0, np_seed=None):
    """fn(I) under each package's guard, the parameters drawn after the
    same ``np.random.seed``: (JAX result, port result)."""
    out = []
    for I, guard in ((J, jguard), (P, pguard)):
        if np_seed is not None:
            np.random.seed(np_seed)
        with guard(seed):
            out.append(fn(I))
    return out


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"max error {err:.3g} of the largest magnitude"


def close_grads(got, want, rtol):
    """Each gradient within ``rtol`` of its largest magnitude, but those
    that are zero but for rounding (below ZERO_GRAD of the model's largest
    gradient: a conv bias before a batch norm, a key bias before the
    softmax) are held to that floor instead."""
    top = max(np.abs(w).max() for w in want if w is not None)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        if np.abs(w).max() < ZERO_GRAD * top:
            assert np.abs(g).max() < ZERO_GRAD * top
        else:
            close(g, w, rtol)


ZERO_GRAD = 1e-6


def rsum(I, x):
    return I.trace_op("reduce_sum", {"X": [x]}, {"reduce_all": True})["Out"][0]


def rmean(I, x):
    return I.trace_op("reduce_mean", {"X": [x]}, {"reduce_all": True})[
        "Out"][0]


# ---------------------------------------------------------------------------
# the 12 tests of tests/test_imperative.py, on both packages
# ---------------------------------------------------------------------------

def test_eager_math_and_backward():
    def run(I):
        x = I.to_variable(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
        w = I.to_variable(np.array([[1.0, 0.0], [0.0, 1.0]], np.float32))
        y = x @ w
        out = rsum(I, y * y)
        out.backward()
        return float(out.numpy().reshape(())), x.gradient(), y.gradient()

    (jv, jg, jyg), (pv, pg, pyg) = both(run)
    assert pv == pytest.approx(1 + 4 + 9 + 16) and pv == jv
    np.testing.assert_allclose(pg, 2 * np.array([[1, 2], [3, 4]]), rtol=1e-6)
    close(pg, jg)
    # gradient() is filled on a non-leaf VarBase on the path, as in JAX
    close(pyg, jyg)


def test_grad_matches_numeric():
    xv = np.random.RandomState(0).rand(3, 4).astype(np.float32)

    def run(I):
        x = I.to_variable(xv)
        y = I.trace_op("sigmoid", {"X": [x]}, {})["Out"][0]
        rsum(I, y).backward()
        return x.gradient()

    jg, pg = both(run)
    sig = 1 / (1 + np.exp(-xv))
    np.testing.assert_allclose(pg, sig * (1 - sig), rtol=1e-5)
    close(pg, jg)


def test_stop_gradient_blocks_flow():
    def run(I):
        x = I.to_variable(np.ones((2, 2), np.float32))
        frozen = x.detach()
        rsum(I, frozen * 3.0).backward()
        return x.gradient()

    assert both(run) == [None, None]


def test_stop_gradient_set_after_creation():
    """``stop_gradient`` set on a live VarBase after it was made (as
    ``Embedding`` sets it on its ids): later ops take no gradient through
    it, in both packages."""
    xv = np.random.RandomState(3).rand(3, 4).astype(np.float32)

    def run(I):
        x = I.to_variable(xv)
        h = x * 2.0
        h.stop_gradient = True
        w = I.to_variable(xv)
        rsum(I, h * w).backward()
        return x.gradient(), w.gradient()

    (jx, jw), (px, pw) = both(run)
    assert jx is None and px is None
    close(pw, jw)
    np.testing.assert_array_equal(pw, 2 * xv)


def test_backward_sets_grad_and_does_not_accumulate():
    """A second forward and backward SETS each ``_grad`` to its own
    gradient (torch's ``.grad`` would add them); a backward on a root
    whose tape was consumed changes nothing."""
    xv = np.random.RandomState(4).rand(3, 4).astype(np.float32)

    def run(I):
        x = I.to_variable(xv)
        grads = []
        for scale in (2.0, 5.0):
            loss = rsum(I, x * x * scale)
            loss.backward()
            grads.append(x.gradient().copy())
        loss.backward()  # the tape is empty: a no-op
        grads.append(x.gradient().copy())
        return grads

    jg, pg = both(run)
    for j, p_ in zip(jg, pg):
        close(p_, j)
    np.testing.assert_allclose(pg[1], 10 * xv, rtol=1e-6)
    np.testing.assert_array_equal(pg[2], pg[1])


def _fc_regression(I, steps, opt_cls, lr):
    rng = np.random.RandomState(0)
    xv = rng.rand(32, 8).astype(np.float32)
    yv = xv @ rng.rand(8, 1).astype(np.float32)
    model = I.FC(size=1)
    opt = opt_cls(I)(learning_rate=lr)
    losses = []
    for _ in range(steps):
        err = model(I.to_variable(xv)) - I.to_variable(yv)
        loss = rmean(I, err * err)
        losses.append(float(loss.numpy().reshape(())))
        opt.minimize(loss, parameter_list=model.parameters())
    return losses, [p.numpy() for p in model.parameters()]


@pytest.mark.parametrize("opt", ["SGDOptimizer", "AdamOptimizer"])
def test_optimizers_after_three_steps(opt):
    """SGD and Adam: the losses and the parameters after 3 steps agree
    within RTOL."""
    (jl, jp), (pl, pp) = both(
        lambda I: _fc_regression(I, 3, lambda I: getattr(I, opt), 0.2),
        seed=1, np_seed=10)
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    for a, b in zip(pp, jp):
        close(a, b)


def test_fc_layer_training_converges():
    np.random.seed(11)
    with pguard(seed=1):
        losses, _ = _fc_regression(P, 60, lambda I: I.SGDOptimizer, 0.2)
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])


def _conv_net(I):
    class Net(I.Layer):
        def __init__(self):
            super().__init__("net")
            self.conv = I.Conv2D(4, 3, padding=1)
            self.bn = I.BatchNorm(4, act="relu")
            self.pool = I.Pool2D(2, "max", 2)
            self.fc = I.FC(size=2)

        def forward(self, x):
            return self.fc(self.pool(self.bn(self.conv(x))))

    return Net()


def test_conv_bn_pool_network_runs_and_trains():
    xv = np.random.RandomState(0).rand(4, 3, 8, 8).astype(np.float32)

    def run(I, steps):
        net = _conv_net(I)
        opt = I.AdamOptimizer(learning_rate=1e-2)
        losses = []
        for _ in range(steps):
            out = net(I.to_variable(xv))
            loss = rmean(I, out * out)
            losses.append(float(loss.numpy().reshape(())))
            opt.minimize(loss, parameter_list=net.parameters())
        net.eval()
        o1 = net(I.to_variable(xv)).numpy()
        o2 = net(I.to_variable(xv)).numpy()
        return (losses, [p.numpy() for p in net.parameters()],
                net.bn._mean.numpy(), o1, o2)

    (jl, jp, jm, jo, _), (pl, pp, pm, po, po2) = both(
        lambda I: run(I, 3), seed=2, np_seed=12)
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    # parameters(): conv w, w, b, b, bn scale, scale, bias, bias, mean,
    # var, fc w, w, b, b (a parameter is listed under its name and under
    # its attribute, in both packages). conv.b feeds the batch norm, which
    # removes it: its gradient is zero but for rounding, which Adam scales
    # up to +-lr a step, and the running mean takes the batch mean of
    # conv + b; the rest agree
    assert len(pp) == len(jp) == 14
    for i, (a, b) in enumerate(zip(pp, jp)):
        if i not in (2, 3, 8):
            close(a, b)
    np.testing.assert_array_equal(po, po2)
    np.random.seed(12)
    with pguard(seed=2):
        losses, _, mean, _, _ = run(P, 10)
    assert losses[-1] < losses[0]
    assert not np.allclose(mean, 0.0)


def test_batch_norm_statistics_written_back_detached():
    xv = np.random.RandomState(1).rand(4, 3, 5, 5).astype(np.float32)
    with pguard():
        bn = P.BatchNorm(3)
        y = bn(P.to_variable(xv))
        assert not bn._mean.array.requires_grad
        assert bn._mean.array.grad_fn is None and bn._var.array.grad_fn is None
        assert y.array.grad_fn is not None
        np.testing.assert_allclose(bn._mean.numpy(),
                                   0.1 * xv.mean(axis=(0, 2, 3)), rtol=1e-5)


@pytest.mark.parametrize("engine", ["port", "jax"])
def test_dygraph_matches_declarative(engine):
    """Same weights: the port's dygraph forward equals the forward of the
    port's and of the JAX package's Executor."""
    rng = np.random.RandomState(0)
    xv = rng.rand(5, 6).astype(np.float32)
    wv = rng.rand(6, 3).astype(np.float32)
    bv = rng.rand(3).astype(np.float32)
    with pguard():
        model = P.FC(size=3, act="relu")
        model(P.to_variable(xv))  # builds the parameters
        model._w.array = wv
        model._b.array = bv
        dy = model(P.to_variable(xv)).numpy()
    fl = pt if engine == "port" else fluid
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[6], dtype="float32")
        h = fl.layers.fc(input=x, size=3, act="relu")
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope()
    with fl.scope_guard(scope):
        exe.run(startup)
        params = main.global_block().all_parameters()
        put = torch.from_numpy if engine == "port" else np.asarray
        scope.set_var([v.name for v in params if len(v.shape) == 2][0],
                      put(wv))
        scope.set_var([v.name for v in params if len(v.shape) == 1][0],
                      put(bv))
        st = np.asarray(exe.run(main, feed={"x": xv},
                                fetch_list=[h.name])[0])
    np.testing.assert_allclose(dy, st, rtol=RTOL)


def test_embedding_layer_grad():
    def run(I):
        emb = I.Embedding(size=[10, 4])
        out = emb(I.to_variable(np.array([[1], [3], [1]], np.int64)))
        rsum(I, out).backward()
        return out.numpy(), emb.weight.gradient()

    (jo, jg), (po, pg) = both(run, np_seed=13)
    close(po, jo)
    np.testing.assert_allclose(pg[1], 2 * np.ones(4), rtol=1e-6)
    np.testing.assert_allclose(pg[3], np.ones(4), rtol=1e-6)
    np.testing.assert_allclose(pg[0], np.zeros(4))
    close(pg, jg)


def _relu_sq_sum(I):
    def block(x):
        h = I.trace_op("relu", {"X": [x]}, {})["Out"][0]
        return I.trace_op("reduce_sum", {"X": [h * h]},
                          {"dim": [-1], "keep_dim": False,
                           "reduce_all": True})["Out"][0]
    return block


def test_recompute_matches_plain_grads():
    """recompute(fn, x): gradients bitwise fn(x)'s in the port (and
    within RTOL of JAX's), one tape node instead of one per op."""
    xv = np.random.RandomState(0).randn(4, 8).astype(np.float32)

    def run(I, ck):
        tr = I.tracer._active_tracer()
        x = I.to_variable(xv)
        y = I.recompute(_relu_sq_sum(I), x) if ck else _relu_sq_sum(I)(x)
        tape = len(tr._tape)
        y.backward()
        return x.gradient().copy(), tape

    with pguard():
        g_plain, plain_tape = run(P, False)
    with pguard():
        g_ck, ck_tape = run(P, True)
    with jguard():
        jg, _ = run(J, True)
    np.testing.assert_array_equal(g_ck, g_plain)
    assert ck_tape == 1 and plain_tape > 1
    close(g_ck, jg)


def test_recompute_layer_param_grads_flow():
    xv = np.random.RandomState(1).randn(4, 6).astype(np.float32)

    def run(I, ck):
        fc = I.FC(size=3)
        x = I.to_variable(xv)
        fc(x)  # builds the parameters
        for p in fc.parameters():
            p.clear_gradient()
        y = I.recompute(fc, x) if ck else fc(x)
        I.trace_op("reduce_sum", {"X": [y]},
                   {"dim": [-1], "keep_dim": False,
                    "reduce_all": True})["Out"][0].backward()
        return [p.gradient() for p in fc.parameters()]

    np.random.seed(3)
    with pguard(3):
        grads = run(P, True)
    np.random.seed(3)
    with pguard(3):
        plain = run(P, False)
    np.random.seed(3)
    with jguard(3):
        jgrads = run(J, True)
    assert all(g is not None for g in grads)
    assert any(np.abs(g).sum() > 0 for g in grads)
    for g, p_, j in zip(grads, plain, jgrads):
        np.testing.assert_array_equal(g, p_)
        close(g, j)


def _dropout_block(I):
    def block(x):
        return I.trace_op("dropout", {"X": [x]},
                          {"dropout_prob": 0.5,
                           "dropout_implementation": "upscale_in_train"})[
            "Out"][0]
    return block


def test_recompute_replays_dropout_stream():
    """The backward's replay draws the forward's mask again: the gradient
    is nonzero exactly where the forward kept values, and equals the
    gradient of a plain run from the same generator state bitwise."""
    xv = np.random.RandomState(2).randn(64, 64).astype(np.float32)

    def run(ck):
        with pguard(9):
            x = P.to_variable(xv)
            block = _dropout_block(P)
            y = P.recompute(block, x) if ck else block(x)
            mask = y.numpy() != 0
            rsum(P, y * y).backward()
            return mask, x.gradient()

    mask, g = run(True)
    mask_plain, g_plain = run(False)
    np.testing.assert_array_equal(g != 0, mask)
    np.testing.assert_array_equal(mask, mask_plain)
    np.testing.assert_array_equal(g, g_plain)


def test_recompute_backward_preserves_live_rng_stream():
    """After the replay the live stream is put back: the next step draws
    a new mask, the one a run without recompute draws (bitwise)."""
    xv = np.random.RandomState(4).randn(64, 64).astype(np.float32)

    def masks(ck):
        with pguard(11):
            out = []
            for _ in range(2):
                x = P.to_variable(xv)
                block = _dropout_block(P)
                y = P.recompute(block, x) if ck else block(x)
                out.append(y.numpy() != 0)
                rsum(P, y).backward()
            return out

    ck, plain = masks(True), masks(False)
    assert not np.array_equal(ck[0], ck[1])
    for a, b in zip(ck, plain):
        np.testing.assert_array_equal(a, b)


def test_recompute_nested_records_one_node():
    xv = np.random.RandomState(5).randn(4, 8).astype(np.float32)

    def run(I, nested):
        def inner(x):
            return I.trace_op("relu", {"X": [x]}, {})["Out"][0]

        def outer(x):
            return I.trace_op("reduce_sum", {"X": [I.recompute(inner, x)]},
                              {"dim": [-1], "keep_dim": False,
                               "reduce_all": True})["Out"][0]

        tr = I.tracer._active_tracer()
        x = I.to_variable(xv)
        y = I.recompute(outer, x) if nested else outer(x)
        tape = len(tr._tape)
        y.backward()
        return x.gradient().copy(), tape

    with pguard():
        g_nested, tape = run(P, True)
    with pguard():
        g_plain, _ = run(P, False)
    with jguard():
        jg, jtape = run(J, True)
    assert tape == jtape == 1
    np.testing.assert_array_equal(g_nested, g_plain)
    close(g_nested, jg)


# ---------------------------------------------------------------------------
# guard and the places
# ---------------------------------------------------------------------------

def test_guard_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        with P.guard():
            assert P.tracer._active_tracer().device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="CPUPlace"):
        with P.guard():
            pass
    assert not P.enabled()
    with pguard(7):
        tr = P.tracer._active_tracer()
        assert tr.device == torch.device("cpu") and P.enabled()
        v = P.to_variable(np.zeros(3, np.float64))
        assert v.dtype == torch.float32 and v.array.device.type == "cpu"
    with pytest.raises(RuntimeError, match="imperative mode is not active"):
        P.trace_op("relu", {"X": [v]}, {})


def test_int_first_argument_is_the_seed():
    xv = np.ones((32, 32), np.float32)
    draws = []
    for args in ((5,), (CPU, 5)):
        try:
            with P.guard(*args):
                draws.append(_dropout_block(P)(P.to_variable(xv)).numpy())
        except RuntimeError:  # guard(5): the card, absent here
            assert not torch.cuda.is_available()
    with pguard(5):
        ref = _dropout_block(P)(P.to_variable(xv)).numpy()
    np.testing.assert_array_equal(draws[-1], ref)


def test_eval_mode_and_no_grad_ops_record_nothing():
    xv = np.random.RandomState(6).rand(2, 3).astype(np.float32)
    with pguard():
        tr = P.tracer._active_tracer()
        fc = P.FC(2)
        x = P.to_variable(xv)
        fc(x)
        n = len(tr._tape)
        assert n == 2  # mul and elementwise_add
        fc.eval()
        out = fc(x)
        assert len(tr._tape) == n and out.stop_gradient
        fc.train()
        P.trace_op("shape", {"Input": [x]}, {})  # a no_grad op
        assert len(tr._tape) == n
        # an intermediate output is stop-gradient
        outs = P.trace_op("reshape2", {"X": [x]}, {"shape": [3, 2]})
        assert outs["XShape"][0].stop_gradient
        assert not outs["Out"][0].stop_gradient


# ---------------------------------------------------------------------------
# the ops with a grad emitter of their own, on the tape
# ---------------------------------------------------------------------------

def _tape_grads(I, op_type, ins, attrs, out_slot, wrt):
    """Forward ``op_type`` on VarBases of ``ins`` (numpy), sum(out *
    weights) backward; (output, {slot: gradient} for ``wrt``)."""
    vs = {s: [I.to_variable(v) for v in vals] for s, vals in ins.items()}
    for s, vals in vs.items():
        for v in vals:
            v.stop_gradient = s not in wrt or not np.issubdtype(
                v.numpy().dtype, np.floating)
    out = I.trace_op(op_type, vs, attrs)[out_slot][0]
    wts = np.random.RandomState(99).rand(*out.shape).astype(np.float32)
    rsum(I, out * I.to_variable(wts)).backward()
    return out.numpy(), {s: vs[s][0].gradient() for s in wrt}


def _rng(seed=0):
    return np.random.RandomState(seed)


TAPE_OPS = {
    "conv2d": ({"Input": [_rng(0).randn(2, 3, 7, 7).astype(np.float32)],
                "Filter": [_rng(1).randn(4, 3, 3, 3).astype(np.float32)]},
               {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
                "groups": 1}, "Output", ["Input", "Filter"]),
    "depthwise_conv2d": (
        {"Input": [_rng(2).randn(2, 4, 6, 6).astype(np.float32)],
         "Filter": [_rng(3).randn(4, 1, 3, 3).astype(np.float32)]},
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 4}, "Output", ["Input", "Filter"]),
    "lookup_table": ({"W": [_rng(4).randn(10, 5).astype(np.float32)],
                      "Ids": [np.array([[1], [7], [1], [0]], np.int64)]},
                     {"padding_idx": 7}, "Out", ["W"]),
    "softmax_with_cross_entropy": (
        {"Logits": [_rng(5).randn(6, 9).astype(np.float32)],
         "Label": [np.array([[0], [3], [8], [3], [2], [-100]], np.int64)]},
        {"ignore_index": -100}, "Loss", ["Logits"]),
    "flash_attention": (
        {"Q": [_rng(6).randn(2, 2, 5, 8).astype(np.float32)],
         "K": [_rng(7).randn(2, 2, 6, 8).astype(np.float32)],
         "V": [_rng(8).randn(2, 2, 6, 8).astype(np.float32)],
         "KeyBias": [np.where(_rng(9).rand(2, 6) < 0.3, -1e9, 0.0).astype(
             np.float32)]},
        {"causal": True, "scale": 0.35}, "Out", ["Q", "K", "V"]),
}


@pytest.mark.parametrize("op_type", sorted(TAPE_OPS))
def test_tape_gradient_of_ops_with_their_own_grad(op_type):
    """Autograd through the forward emitter (``flash_attention``: through
    ``FlashAttention``) gives the JAX tape's gradient, and the port's own
    grad emitter's."""
    ins, attrs, out_slot, wrt = TAPE_OPS[op_type]
    (jo, jg), (po, pg) = both(
        lambda I: _tape_grads(I, op_type, ins, attrs, out_slot, wrt))
    close(po, jo)
    for s in wrt:
        close(pg[s], jg[s])


@pytest.mark.parametrize("op_type", ["dropout", "nce"])
def test_tape_backward_of_random_ops_on_their_draws(op_type):
    """dropout and nce draw from the tracer's generator: their tape
    gradients equal the port's grad emitter's on the mask and the samples
    the forward drew (the executor's backward)."""
    rng = np.random.RandomState(7)
    if op_type == "dropout":
        ins = {"X": [rng.randn(8, 16).astype(np.float32)]}
        attrs = {"dropout_prob": 0.3,
                 "dropout_implementation": "downgrade_in_infer"}
        out_slot, wrt = "Out", ["X"]
    else:
        ins = {"Input": [rng.randn(6, 4).astype(np.float32)],
               "Label": [rng.randint(0, 12, (6, 1)).astype(np.int64)],
               "Weight": [rng.randn(12, 4).astype(np.float32)],
               "Bias": [rng.randn(12).astype(np.float32)]}
        attrs = {"num_total_classes": 12, "num_neg_samples": 5}
        out_slot, wrt = "Cost", ["Input", "Weight", "Bias"]
    with pguard(21):
        tr = P.tracer._active_tracer()
        state = tr.generator.get_state()
        vs = {s: [P.to_variable(v) for v in vals] for s, vals in ins.items()}
        for s, vals in vs.items():
            for v in vals:
                v.stop_gradient = s not in wrt
        outs = P.trace_op(op_type, vs, attrs)
        wts = np.random.RandomState(99).rand(*outs[out_slot][0].shape)
        wts = wts.astype(np.float32)
        rsum(P, outs[out_slot][0] * P.to_variable(wts)).backward()
        got = {s: vs[s][0].gradient() for s in wrt}
    # the same draws through the registry: forward, then the grad op
    gen = torch.Generator()
    gen.set_state(state)
    ctx = preg.EmitContext(torch.device("cpu"), generator=gen)
    tins = {s: [torch.from_numpy(v) for v in vals] for s, vals in ins.items()}
    fwd = preg.lookup(op_type).emitter(ctx, tins, attrs)
    gins = dict(tins)
    gins[out_slot + "@GRAD"] = [torch.from_numpy(wts)]
    for s in preg.lookup(op_type).intermediate_outputs:
        gins[s] = fwd[s]
    grad = preg.lookup(op_type + "_grad").emitter(ctx, gins, attrs)
    for s in wrt:
        close(got[s], grad[s + "@GRAD"][0].numpy())


# ---------------------------------------------------------------------------
# the models of chip_smoke.py's phase 24, tiny
# ---------------------------------------------------------------------------

TINY_RESNET = dict(stages=(2,), class_dim=10, base=8)
TINY_IMAGE = (3, 32, 32)


def _resnet_batch(batch=4, seed=0, classes=10):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, *TINY_IMAGE).astype(np.float32),
            rng.randint(0, classes, (batch, 1)).astype(np.int64))


def test_tiny_dygraph_resnet_against_the_jax_tape():
    """2 bottlenecks at 32x32: loss, every parameter's gradient and the
    batch-norm statistics after one SGD step, against JAX's tape."""
    image, label = _resnet_batch()

    def run(I):
        model = cs.dygraph_resnet(I, **TINY_RESNET)
        loss = model.loss(I.to_variable(image), I.to_variable(label))
        loss.backward()
        grads = [p.gradient() for p in model.parameters()]
        I.SGDOptimizer(0.1).minimize(loss, model.parameters())
        loss2 = model.loss(I.to_variable(image), I.to_variable(label))
        return (float(loss.numpy().reshape(())), grads,
                float(loss2.numpy().reshape(())),
                [l.bn._mean.numpy() for l in model.convbn])

    (jl, jg, jl2, jm), (pl, pg, pl2, pm) = both(run, np_seed=31)
    # 8 ConvBNLayers (conv w, w, b, b; bn scale, scale, bias, bias, mean,
    # var: both packages list a parameter under its name and its
    # attribute) and the FC (w, w, b, b)
    assert len(pg) == len(jg) == 8 * 10 + 4
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    close_grads(pg, jg, 1e-4)
    np.testing.assert_allclose(pl2, jl2, rtol=1e-4)
    for a, b in zip(pm, jm):
        close(a, b, 1e-4)


def _declarative_tiny_resnet(base):
    """``models/resnet.py``'s blocks, cut to the tiny model's stem and one
    stage of 2 bottlenecks, with the dygraph model's head and loss, plain
    SGD."""
    from paddle_tpu_torch.models import resnet
    with pt.unique_name.guard():
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            data = pt.layers.data("data", shape=list(TINY_IMAGE),
                                  dtype="float32")
            label = pt.layers.data("label", shape=[1], dtype="int64")
            x = resnet.conv_bn_layer(data, base, 7, 2, 3)
            x = pt.layers.pool2d(x, pool_type="max", pool_size=3,
                                 pool_stride=2, pool_padding=1)
            x = resnet.layer_warp(resnet.bottleneck, x, base, 2, 1)
            x = pt.layers.pool2d(x, pool_size=7, pool_type="avg",
                                 global_pooling=True)
            prob = pt.layers.fc(x, size=10, act="softmax")
            loss = pt.layers.mean(pt.layers.cross_entropy(prob, label))
            pt.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss


def test_tiny_dygraph_resnet_first_step_against_the_executor():
    """The mapping phase 24(A) uses: the declarative ``models/resnet.py``
    blocks run by the port's ``Executor``, their weights copied into the
    dygraph model (``dygraph_resnet_weights``); the first step's loss and
    every weight's gradient agree (1e-4 of the largest magnitude, PR 8's
    per-op bound)."""
    image, label = _resnet_batch()
    main, startup, loss_var = _declarative_tiny_resnet(8)
    ex = pt.Executor(CPU)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        ex.run(startup)
        init = {n: scope.find_var(n).clone() for n in scope.var_names()}
        names = [p.name for p in main.global_block().all_parameters()]
        want = ex.run(main, feed={"data": image, "label": label},
                      fetch_list=[loss_var] + [n + "@GRAD" for n in names])
    with pguard():
        model = cs.dygraph_resnet(P, **TINY_RESNET)
        model.eval()
        model(P.to_variable(image[:1]))  # makes the Conv2D parameters
        model.train()
        mapped = cs.dygraph_resnet_weights(model, main, init)
        assert set(names) <= set(mapped)
        loss = model.loss(P.to_variable(image), P.to_variable(label))
        loss.backward()
        close(loss.numpy().reshape(()), np.asarray(want[0]).reshape(()))
        for n, g in zip(names, want[1:]):
            close(mapped[n].gradient(), g, 1e-4)


TINY_ENC = dict(vocab=40, n_layer=1, n_head=2, d_model=16, d_ff=32, seq=8)


def test_tiny_dygraph_encoder_against_the_jax_tape():
    """One encoder layer with ``flash_attention`` (the plain versions on
    the CPU), no dropout: the loss and every parameter's gradient
    against JAX's tape, and recompute's gradients bitwise the plain
    run's."""
    ids, pos, label = cs.encoder_batch(TINY_ENC["vocab"], TINY_ENC["seq"], 3,
                                       seed=5)

    def run(I, ck=False):
        model = cs.dygraph_encoder(I, use_recompute=ck, **TINY_ENC)
        loss = model.loss(I.to_variable(ids), I.to_variable(pos),
                          I.to_variable(label))
        loss.backward()
        return (float(loss.numpy().reshape(())),
                [p.gradient() for p in model.parameters()])

    (jl, jg), (pl, pg) = both(run, np_seed=41)
    np.random.seed(41)
    with pguard():
        ckl, ckg = run(P, True)
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    # 2 embeddings and 7 FCs, each parameter listed twice (under its name
    # and its attribute), and the 4 layer-norm parameters
    assert len(pg) == len(jg) == 2 * 2 + 4 + 7 * 4
    close_grads(pg, jg, 1e-4)
    assert ckl == pl
    for a, b in zip(ckg, pg):
        np.testing.assert_array_equal(a, b)


def test_encoder_recompute_with_dropout_bitwise_over_steps():
    """24(B)'s gate at a tiny width: 3 Adam steps with dropout 0.1 from
    the tracer's generator, once plain and once with each layer under
    ``recompute``: every step's gradients bitwise equal."""
    ids, pos, label = cs.encoder_batch(TINY_ENC["vocab"], TINY_ENC["seq"], 3,
                                       seed=6)

    def run(ck):
        np.random.seed(42)
        with pguard(3):
            model = cs.dygraph_encoder(P, dropout=0.1, use_recompute=ck,
                                       **dict(TINY_ENC, n_layer=2))
            opt = P.AdamOptimizer(1e-3)
            steps = []
            for _ in range(3):
                loss = model.loss(P.to_variable(ids), P.to_variable(pos),
                                  P.to_variable(label))
                loss.backward()
                steps.append([p.gradient() for p in model.parameters()])
                opt.minimize(loss, model.parameters())
            return steps

    for a, b in zip(run(True), run(False)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
