"""Recurrent training in the port against the JAX package, on the CPU.

- **recurrent.** A StaticRNN (fc + tanh step, one state, a step output)
  forward and backward: plain, ``is_reverse``, with a Length, both; and a
  DynamicRNN with a ``static_input`` and a ``batch_ref`` memory. Programs
  (the backward's step-grad block included) byte-identical; from the JAX
  startup's parameters the outputs, final states and loss within 1e-6,
  and the gradients of the weights, the sequence input and the initial
  state within 1e-5 of each gradient's largest magnitude.
- **while_grad.** The cases of tests/test_control_flow.py through both
  packages: the gradient of w in y = x * w^n with a ``max_trip_count``,
  an inferred bound and two loops in a row (byte-identical programs, the
  JAX package's gradient within 1e-5 of its largest magnitude, the
  closed form within 1e-5 relative, and central differences); the pow
  loop trained 40 SGD steps (the first 5 losses within 1e-5 relative,
  w after 40 within 1e-4); a loop with no static bound, and one that
  compares before it increments, raise the JAX package's ValueError, word
  for word, at ``append_backward``.
- **TrainingDecoder.** 8 Adam steps of tests/test_contrib_decoder.py's
  builder: programs byte-identical, losses within 1e-5 relative,
  parameters within 1e-4 of the largest magnitude; and its misuse
  errors.
- **Grads on the MT path.** ``gru_grad``, ``sequence_pool_grad``,
  ``sequence_softmax_grad``, ``split_grad`` and ``expand_grad``, the
  generic vjp of both packages on the same numpy inputs and cotangents:
  within 1e-5 of each gradient's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.contrib import decoder as jdecoder
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.contrib import decoder as pdecoder
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

FWD_TOL = 1e-6
GRAD_REL = 1e-5    # of the gradient's largest magnitude
LOSS_REL = 1e-5
PARAM_REL = 1e-4   # of the largest parameter magnitude
B, T, D, H = 3, 5, 4, 6

PKGS = {"jax": (fluid, junique.guard), "port": (pt, punique.guard)}


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _build_both(build):
    """``build(pkg)`` in each package under a fresh unique-name guard:
    {"jax": result, "port": result}."""
    out = {}
    for name, (pkg, guard) in PKGS.items():
        with guard():
            out[name] = build(pkg)
    return out


def _scopes(jstart, pstart, seed=5, params=None):
    """The JAX startup run from ``seed``, its persistables (``params``
    overriding some) copied into a port scope: (jax exe, jax scope, port
    exe, port scope)."""
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jstart.random_seed = seed
    jexe.run(jstart, scope=js)
    for n, v in (params or {}).items():
        js.set_var(n, jnp.asarray(v))
    names = [v.name for v in pstart.list_vars() if v.persistable]
    ps = pt.Scope()
    pt.io.set_params_from_numpy(
        ps, {n: np.asarray(js.find_var(n)) for n in names}, "cpu",
        program=pstart)
    return jexe, js, pt.Executor(pt.CPUPlace()), ps


def _grad_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_REL * np.abs(want).max(),
                               err_msg=what)


def _params_close(js, ps, names):
    diff = top = 0.0
    for n in names:
        a = np.asarray(js.find_var(n))
        if a.dtype.kind != "f":
            continue
        diff = max(diff, float(np.abs(ps.find_var(n).numpy() - a).max()))
        top = max(top, float(np.abs(a).max()))
    assert diff <= PARAM_REL * top, (diff, top)


# ---------------------------------------------------------------------------
# recurrent: StaticRNN and DynamicRNN
# ---------------------------------------------------------------------------

RNN_CASES = {"plain": (False, False), "reverse": (True, False),
             "length": (False, True), "reverse_length": (True, True)}


def _rnn_program(pkg, reverse, with_length, dynamic=False):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data("x", shape=[T, D], dtype="float32")
        x.stop_gradient = False
        h0 = L.data("h0", shape=[H], dtype="float32")
        h0.stop_gradient = False
        length = (L.data("len", shape=[], dtype="int32")
                  if with_length else None)
        if dynamic:
            ctx_in = L.data("ctx", shape=[H], dtype="float32")
            rnn = L.DynamicRNN(length, is_reverse=reverse)
            with rnn.block():
                xt = rnn.step_input(x)
                ctx = rnn.static_input(ctx_in)
                h = rnn.memory(init=h0)
                c = rnn.memory(shape=[-1, H], batch_ref=h0, init_value=0.5)
                nh = L.fc(L.concat([xt, h, ctx], axis=1), size=H,
                          act="tanh", param_attr="rnn_w", bias_attr="rnn_b")
                nc = L.elementwise_add(L.elementwise_mul(c, nh), ctx)
                rnn.update_memory(h, nh)
                rnn.update_memory(c, nc)
                rnn.output(nh, nc)
            out, out_c = rnn()
            final = rnn.final_states()[1]
            total = L.elementwise_add(L.mean(out), L.mean(out_c))
        else:
            rnn = L.StaticRNN(length=length, is_reverse=reverse)
            with rnn.step():
                xt = rnn.step_input(x)
                h = rnn.memory(init=h0)
                nh = L.fc(L.concat([xt, h], axis=1), size=H, act="tanh",
                          param_attr="rnn_w", bias_attr="rnn_b")
                rnn.update_memory(h, nh)
                rnn.step_output(nh)
            out = rnn()
            final = rnn.final_states()
            total = L.mean(out)
        loss = L.elementwise_add(total, L.mean(L.square(final)))
        grads = pkg.backward.append_backward(loss)
    fetch = [loss.name, out.name, final.name, "x@GRAD", "h0@GRAD"]
    return main, startup, fetch + [g.name for _, g in grads]


def _rnn_feed(with_length, dynamic):
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(B, T, D).astype(np.float32),
            "h0": rng.randn(B, H).astype(np.float32)}
    if with_length:
        feed["len"] = np.array([5, 2, 0], np.int32)
    if dynamic:
        feed["ctx"] = rng.randn(B, H).astype(np.float32) * 0.5
    return feed


def _check_rnn(reverse, with_length, dynamic):
    progs = _build_both(lambda pkg: _rnn_program(pkg, reverse, with_length,
                                                 dynamic))
    (jmain, jstart, jfetch), (pmain, pstart, pfetch) = (progs["jax"],
                                                        progs["port"])
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    assert pstart.desc.to_bytes() == jstart.desc.to_bytes()
    assert pfetch == jfetch
    gop = next(o for o in pmain.global_block().ops
               if o.type == "recurrent_grad")
    assert "__grad_sub_block__" in gop.attrs
    jexe, js, pexe, ps = _scopes(jstart, pstart)
    feed = _rnn_feed(with_length, dynamic)
    want = jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=js)
    got = pexe.run(pmain, feed=feed, fetch_list=pfetch, scope=ps)
    for name, g, w in zip(pfetch, got, want):
        if name.endswith("@GRAD"):
            _grad_close(g, w, name)
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=FWD_TOL, err_msg=name)
    return dict(zip(pfetch, got))


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_static_rnn_forward_and_backward_match_jax(case):
    reverse, with_length = RNN_CASES[case]
    got = _check_rnn(reverse, with_length, dynamic=False)
    out = got[[n for n in got if n.endswith("@rnn_out")][0]]
    assert out.shape == (B, T, H)
    if with_length:
        # row 1 ends at step 2, row 2 has no step: zeros from there on
        assert not out[1, 2:].any() and not out[2].any()
        assert not got["x@GRAD"][2].any()


@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reverse"])
def test_dynamic_rnn_matches_jax(reverse):
    _check_rnn(reverse, with_length=True, dynamic=True)


def test_dynamic_rnn_is_exported_like_jax():
    for pkg in (fluid, pt):
        assert "DynamicRNN" in pkg.layers.control_flow.__all__
        assert pkg.layers.DynamicRNN is pkg.layers.control_flow.DynamicRNN
        assert issubclass(pkg.layers.DynamicRNN, pkg.layers.StaticRNN)


# ---------------------------------------------------------------------------
# while_grad
# ---------------------------------------------------------------------------

def _pow_loop(pkg, n_iters, max_trip_count=None, loops=1, train=False,
              order="increment_first", fed_limit=False):
    """tests/test_control_flow.py's y = x * w^n through ``loops`` While
    loops in a row; with ``train`` an SGD step on a square error to a
    fed target, else the gradients of mean(y). Returns (main, startup,
    fetch names)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data("x", shape=[3], dtype="float32")
        w = L.create_parameter([1, 3], "float32", name="w_loop")
        limit = (L.data("n", shape=[1], dtype="int32") if fed_limit
                 else None)
        y = L.elementwise_add(x, L.fill_constant(
            shape=[1], dtype="float32", value=0.0))
        for _ in range(loops):
            i = L.fill_constant(shape=[1], dtype="int32", value=0)
            if not fed_limit:
                limit = L.fill_constant(shape=[1], dtype="int32",
                                        value=n_iters)
            cond = L.less_than(i, limit)
            loop = L.While(cond, max_trip_count=max_trip_count)
            with loop.block():
                L.assign(L.elementwise_mul(y, w), output=y)
                if order == "increment_first":
                    L.increment(i, 1, in_place=True)
                    L.less_than(i, limit, cond=cond)
                else:
                    L.less_than(i, limit, cond=cond)
                    L.increment(i, 1, in_place=True)
        if train:
            target = L.data("t", shape=[3], dtype="float32")
            loss = L.mean(L.square_error_cost(y, target))
            pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
            return main, startup, [loss.name]
        loss = L.mean(y)
        grads = dict((p.name, g.name)
                     for p, g in pkg.backward.append_backward(loss))
    return main, startup, [y.name, loss.name, grads["w_loop"]]


# case: (n_iters, max_trip_count, loops, w, power of w in y)
WHILE_GRAD_CASES = {
    "analytic": (3, 5, 1, [[1.5, 0.5, 2.0]], 3),
    "numeric": (2, 4, 1, [[1.2, 0.8, 1.6]], 2),
    "inferred_bound": (3, None, 1, [[1.5, 0.5, 2.0]], 3),
    "two_loops": (2, 3, 2, [[1.1, 0.9, 1.3]], 4),
}


@pytest.mark.parametrize("case", sorted(WHILE_GRAD_CASES))
def test_while_grad_matches_jax(case):
    n, mtc, loops, wv, power = WHILE_GRAD_CASES[case]
    wv = np.array(wv, np.float32)
    progs = _build_both(lambda pkg: _pow_loop(pkg, n, mtc, loops))
    (jmain, jstart, jfetch), (pmain, pstart, pfetch) = (progs["jax"],
                                                        progs["port"])
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    assert pfetch == jfetch
    if mtc is None:
        op = next(o for o in pmain.global_block().ops if o.type == "while")
        assert int(op.attrs["__inferred_trip_bound__"]) == n
    jexe, js, pexe, ps = _scopes(jstart, pstart, params={"w_loop": wv})
    xb = np.linspace(0.5, 2.0, 6).astype(np.float32).reshape(2, 3)
    feed = {"x": xb}
    jy, _, jg = jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=js)
    py, ploss, pg = pexe.run(pmain, feed=feed, fetch_list=pfetch, scope=ps)
    np.testing.assert_allclose(py, np.asarray(jy), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(py, xb * wv ** power, rtol=1e-6)
    _grad_close(pg, jg, case)
    expect = power * wv ** (power - 1) * xb.mean(axis=0, keepdims=True) / 3
    np.testing.assert_allclose(pg, expect, rtol=1e-5)

    # central differences of the port's own forward
    eps = 1e-2
    for jj in range(3):
        losses = []
        for sign in (1, -1):
            w2 = wv.copy()
            w2[0, jj] += sign * eps
            ps.set_var("w_loop", torch.from_numpy(w2))
            losses.append(float(pexe.run(pmain, feed=feed,
                                         fetch_list=[pfetch[1]],
                                         scope=ps)[0].reshape(-1)[0]))
        num = (losses[0] - losses[1]) / (2 * eps)
        np.testing.assert_allclose(pg[0, jj], num, rtol=2e-2, atol=1e-3)


def test_while_trains_against_jax():
    """tests/test_control_flow.py::test_while_trains: w learns 2 from 0.5
    through the loop alone, in both packages alike."""
    progs = _build_both(lambda pkg: _pow_loop(pkg, 2, 4, train=True))
    (jmain, jstart, jfetch), (pmain, pstart, pfetch) = (progs["jax"],
                                                        progs["port"])
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    jexe, js, pexe, ps = _scopes(
        jstart, pstart, params={"w_loop": np.full((1, 3), 0.5, np.float32)})
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(40):
        xb = rng.rand(8, 3).astype(np.float32) + 0.5
        feed = {"x": xb, "t": xb * 4.0}
        (jl,) = jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=js)
        (pl,) = pexe.run(pmain, feed=feed, fetch_list=pfetch, scope=ps)
        losses.append((float(np.asarray(jl).reshape(-1)[0]),
                       float(pl.reshape(-1)[0])))
    for jl, pl in losses[:5]:
        assert abs(pl - jl) <= LOSS_REL * abs(jl), losses[:5]
    assert losses[-1][1] < losses[0][1] * 0.2
    _params_close(js, ps, ["w_loop"])
    np.testing.assert_allclose(ps.find_var("w_loop").numpy(), 2.0,
                               rtol=1e-3)


@pytest.mark.parametrize("case", ["fed_limit", "compare_first"])
def test_while_without_a_bound_raises_the_jax_error(case):
    """No static trip bound (a fed limit, or a body that compares before
    it increments): ``append_backward`` raises the JAX package's
    ValueError, word for word."""
    kw = {"fed_limit": dict(fed_limit=True),
          "compare_first": dict(order="compare_first")}[case]
    msgs = {}
    for name, (pkg, guard) in PKGS.items():
        with guard(), pytest.raises(ValueError,
                                    match="max_trip_count") as err:
            _pow_loop(pkg, 3, **kw)
        msgs[name] = str(err.value)
    assert msgs["port"] == msgs["jax"]


# ---------------------------------------------------------------------------
# TrainingDecoder
# ---------------------------------------------------------------------------

VOCAB, EMB, HID = 30, 8, 16


def _decoder_program(pkg, dec):
    """tests/test_contrib_decoder.py's builder: a StateCell (fc over
    [x, h], tanh) teacher-forced over 6 steps, softmax scores, cross
    entropy, Adam 0.05."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        tgt = L.data("tgt", shape=[6, 1], dtype="int64")
        tgt_next = L.data("tgt_next", shape=[6, 1], dtype="int64")
        length = L.data("length", shape=[], dtype="int32",
                        append_batch_size=True)
        boot = L.data("boot", shape=[HID], dtype="float32")
        emb = L.embedding(tgt, size=[VOCAB, EMB], param_attr="dec_emb_w")
        cell = dec.StateCell(inputs={"x": None},
                             states={"h": dec.InitState(init=boot)},
                             out_state="h")

        @cell.state_updater
        def updater(state_cell):
            x = state_cell.get_input("x")
            h = state_cell.get_state("h")
            state_cell.set_state("h", L.fc(
                L.concat([x, h], axis=1), size=HID, act="tanh",
                param_attr="cell_w", bias_attr="cell_b"))

        decoder = dec.TrainingDecoder(cell, length=length)
        with decoder.block():
            cur = decoder.step_input(emb)
            decoder.state_cell.compute_state(inputs={"x": cur})
            h = decoder.state_cell.get_state("h")
            score = L.fc(h, size=VOCAB, act="softmax", param_attr="out_w",
                         bias_attr="out_b")
            decoder.state_cell.update_states()
            decoder.output(score)
        loss = L.mean(L.cross_entropy(decoder(), tgt_next))
        pkg.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
    return main, startup, [loss.name]


def test_training_decoder_trains_against_jax():
    progs = {"jax": None, "port": None}
    with junique.guard():
        progs["jax"] = _decoder_program(fluid, jdecoder)
    with punique.guard():
        progs["port"] = _decoder_program(pt, pdecoder)
    (jmain, jstart, jfetch), (pmain, pstart, pfetch) = (progs["jax"],
                                                        progs["port"])
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    assert pstart.desc.to_bytes() == jstart.desc.to_bytes()
    jexe, js, pexe, ps = _scopes(jstart, pstart)
    rng = np.random.RandomState(0)
    feed = {"tgt": rng.randint(0, VOCAB, (4, 6, 1)).astype(np.int64),
            "tgt_next": rng.randint(0, VOCAB, (4, 6, 1)).astype(np.int64),
            "length": np.array([6, 4, 6, 3], np.int32),
            "boot": rng.rand(4, HID).astype(np.float32)}
    losses = []
    for _ in range(8):
        (jl,) = jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=js)
        (pl,) = pexe.run(pmain, feed=feed, fetch_list=pfetch, scope=ps)
        losses.append((float(np.asarray(jl).reshape(-1)[0]),
                       float(pl.reshape(-1)[0])))
    for jl, pl in losses:
        assert abs(pl - jl) <= LOSS_REL * abs(jl), losses
    assert losses[-1][1] < losses[0][1]
    _params_close(js, ps, [v.name for v in pstart.list_vars()
                           if v.persistable])


def _misuse(pkg, dec, what):
    L = pkg.layers
    with pkg.program_guard(pkg.Program(), pkg.Program()):
        boot = L.data("boot", shape=[HID], dtype="float32")
        cell = dec.StateCell(inputs={"x": None},
                             states={"h": dec.InitState(init=boot)},
                             out_state="h")
        decoder = dec.TrainingDecoder(cell)
        if what == "output_outside_block":
            decoder.output(boot)
        elif what == "read_inside_block":
            with decoder.block():
                decoder()
        elif what == "block_twice":
            with decoder.block():
                decoder.output(decoder.state_cell.get_state("h"))
            decoder.block()
        elif what == "cell_in_two_decoders":
            dec.TrainingDecoder(cell)


@pytest.mark.parametrize("what", ["output_outside_block",
                                  "read_inside_block", "block_twice",
                                  "cell_in_two_decoders"])
def test_training_decoder_misuse_raises_as_jax(what):
    msgs = {}
    for name, (pkg, guard) in PKGS.items():
        dec = jdecoder if name == "jax" else pdecoder
        with guard(), pytest.raises(ValueError) as err:
            _misuse(pkg, dec, what)
        msgs[name] = str(err.value)
    assert msgs["port"] == msgs["jax"]


# ---------------------------------------------------------------------------
# the grads on the machine-translation path
# ---------------------------------------------------------------------------

def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _grad_cases():
    rng = np.random.RandomState(11)
    lens = np.array([6, 2, 4], np.int32)
    return {
        "gru_grad": ("gru", {"Input": [_f32(rng, 3, 6, 15)],
                             "Weight": [_f32(rng, 5, 15) / 2],
                             "Bias": [_f32(rng, 15)],
                             "H0": [_f32(rng, 3, 5)], "Length": [lens]},
                     {"is_reverse": True, "gate_activation": "sigmoid",
                      "activation": "tanh"}),
        "sequence_pool_grad": ("sequence_pool",
                               {"X": [_f32(rng, 3, 6, 4)], "Length": [lens]},
                               {"pooltype": "LAST"}),
        "sequence_softmax_grad": ("sequence_softmax",
                                  {"X": [_f32(rng, 3, 6) * 3],
                                   "Length": [lens]}, {}),
        "split_grad": ("split", {"X": [_f32(rng, 2, 6, 3)]},
                       {"axis": 1, "num": 0, "sections": [2, 3, 1]}),
        "expand_grad": ("expand", {"X": [_f32(rng, 2, 1, 3)]},
                        {"expand_times": [1, 4, 2]}),
    }


@pytest.mark.parametrize("name", sorted(_grad_cases()))
def test_mt_path_grad_matches_jax(name):
    """The generic vjp grad op of both packages on the same inputs, each
    output's cotangent drawn from a seed (a saved intermediate output is
    handed over as the forward made it)."""
    op_type, ins, attrs = _grad_cases()[name]
    info = preg.lookup(op_type)
    assert tuple(info.intermediate_outputs) == tuple(
        jreg.lookup(op_type).intermediate_outputs)
    fwd = jreg.lookup(op_type).emitter(
        jreg.EmitContext(), {s: [jnp.asarray(a) for a in v]
                             for s, v in ins.items()}, attrs)
    rng = np.random.RandomState(7)
    gins = dict(ins)
    for slot, vals in fwd.items():
        if slot in info.intermediate_outputs:
            gins[slot] = [np.asarray(v) for v in vals]
        else:
            gins[slot + "@GRAD"] = [_f32(rng, *np.shape(v)) for v in vals]
    gattrs = dict(attrs, __fwd_type__=op_type)
    jouts = jreg.generic_vjp_grad_emitter(
        jreg.EmitContext(), {s: [jnp.asarray(a) for a in v]
                             for s, v in gins.items()}, gattrs)
    pouts = preg.resolve_grad_emitter(name)(
        preg.EmitContext(torch.device("cpu")),
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in gins.items()}, gattrs)
    checked = 0
    for slot, jvals in jouts.items():
        for j, p in zip(jvals, pouts[slot]):
            if j is None or np.asarray(j).dtype.kind != "f":
                continue   # Length gets no gradient
            _grad_close(p.numpy(), j, f"{name} {slot}")
            checked += 1
    assert checked == sum(np.asarray(v).dtype.kind == "f"
                          for vs in ins.values() for v in vs)
