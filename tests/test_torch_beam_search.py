"""Beam search and the While loop in the port against the JAX package, on
the CPU.

- **Ops.** ``beam_search`` (live, ended and tied rows; probabilities and
  accumulated scores), ``beam_search_decode`` (with the ``cumsum > 1``
  padding), ``gru`` (forward, reverse, lengths, H0), ``sequence_pool``
  (all six pool types, with and without Length), ``sequence_softmax``,
  ``expand``, ``split``, ``fill_constant_batch_size_like``, and
  ``array_write``/``array_read`` (an index in range, one past the end,
  clamped, and a negative one, counted from the end), from the same numpy
  inputs through both packages' emitters: ids, parents and masks exact,
  floats within 1e-6 (the GRU's fp32 products within 1e-5).
- **While.** The counter loop of tests/test_control_flow.py (an inferred
  trip bound), the same with ``max_trip_count`` above the true count, a
  loop whose body compares before it increments (no bound: it runs
  unbounded, on the host between device segments) and one with a fed
  limit: programs byte-identical to the JAX package's, results its
  results; a bounded loop lies in a device segment, an unbounded one in
  a host segment.
- **Programs.** ``machine_translation.build()``'s main (with its
  backward, a StaticRNN's step-grad block included), startup, test and
  decode programs, at a tiny width and at the Fluid benchmark's (30000
  words, 512 wide, 50 steps), and ``BeamSearchDecoder``'s decode
  program, byte-identical to the JAX package's.
- **End to end.** The machine-translation decode at 40-word dictionaries
  and width 16 from the JAX startup's parameters: sentences equal to the
  JAX package's (every one; no near-tie allowance is taken) and final
  scores within 1e-5 relative. ``BeamSearchDecoder`` decoding with the
  parameters the JAX package trained (tests/test_contrib_decoder.py).
  ``dynamic_decode`` equals ``DecodeEngine.generate``.
- **Training.** ``machine_translation.build()``'s train program, 5 Adam
  steps from the JAX startup's parameters (losses within 1e-5 relative,
  every parameter within 1e-4 of the largest parameter magnitude), then
  the decode program on each package's trained scope: sentences equal.
  The backward of a bounded While: the train program byte-identical and
  its gradient the JAX package's.
- **C4.** ``beam_search`` ranks its candidates in ``lax.top_k``'s total
  order (signed zeros, a negative NaN).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import layers as jlayers
from paddle_tpu import registry as jreg
from paddle_tpu.contrib import decoder as jdecoder
from paddle_tpu.core.types import DataType as JDataType
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pexecutor
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.contrib import decoder as pdecoder
from paddle_tpu_torch.core.types import DataType
from paddle_tpu_torch.inference.generation import DecodeEngine
from paddle_tpu_torch.models import machine_translation as pmt
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

RNG = np.random.RandomState(0)
TOL = 1e-6
GRU_TOL = 1e-5
SCORE_REL = 1e-5
MT_TINY = dict(src_dict_size=40, tgt_dict_size=40, emb_dim=16, hid=16)
# the Fluid benchmark's machine_translation.py widths, 50 decode steps
MT_FULL = dict(src_dict_size=30000, tgt_dict_size=30000, emb_dim=512,
               hid=512, max_len=50, beam_size=4, decode_max_len=50)


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def f32(*shape):
    return RNG.randn(*shape).astype(np.float32)


def _run_both(op_type, ins, attrs, jattrs=None):
    """Both packages' emitters on the same numpy inputs; outputs as numpy
    per slot."""
    jouts = jreg.lookup(op_type).emitter(
        jreg.EmitContext(), {s: [jnp.asarray(a) for a in v]
                             for s, v in ins.items()}, jattrs or attrs)
    pouts = preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu")),
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}, attrs)
    return ({s: [np.asarray(v) for v in vs] for s, vs in jouts.items()},
            {s: [v.numpy() for v in vs] for s, vs in pouts.items()})


def _same(j, p, tol=TOL, skip=()):
    assert sorted(j) == sorted(p)
    for slot in j:
        if slot in skip:
            continue
        for a, b in zip(j[slot], p[slot]):
            assert a.shape == b.shape, slot
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                           err_msg=slot)
            else:
                assert np.array_equal(a.astype(np.int64),
                                      b.astype(np.int64)), slot


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _beam_inputs(accumulated):
    """batch 3 x beam 4, K 5: row 1 ended (its pre_id is end_id), and in
    batch 2 two candidates tie across beams and one within a beam."""
    b, w, k, end = 3, 4, 5, 1
    pre_ids = RNG.randint(2, 30, (b * w,)).astype(np.int64)
    pre_ids[1] = end
    pre_scores = -np.abs(f32(b * w))
    ids = RNG.randint(0, 30, (b * w, k)).astype(np.int64)
    if accumulated:
        scores = pre_scores[:, None] - np.abs(f32(b * w, k))
    else:
        scores = np.abs(f32(b * w, k)) / 4 + 0.01
    scores[9, 1] = scores[10, 3] = scores[10, 4] = scores.max() + 0.5
    pre_scores[9] = pre_scores[10]
    return ({"pre_ids": [pre_ids], "pre_scores": [pre_scores],
             "ids": [ids], "scores": [scores]},
            {"beam_size": w, "end_id": end, "level": 0,
             "is_accumulated": accumulated})


@pytest.mark.parametrize("accumulated", [False, True],
                         ids=["probs", "accumulated"])
def test_beam_search(accumulated):
    ins, attrs = _beam_inputs(accumulated)
    j, p = _run_both("beam_search", ins, attrs)
    _same(j, p)
    assert p["parent_idx"][0].dtype == np.int32
    # the ended row keeps only itself: end_id at its own score
    assert 1 in p["parent_idx"][0].tolist()


@pytest.mark.parametrize("probe", ["signed_zeros", "negative_nan"])
def test_beam_search_follows_lax_total_order(probe):
    """ROADMAP C4: one batch row of 2 hypotheses x 2 accumulated
    candidates. lax.top_k ranks +0 above -0 and a negative NaN below
    -inf; torch's float sort would pick [-0 at 0] and [NaN at 1]."""
    flat = {"signed_zeros": [-0.0, 0.5, 0.0, -1.0],
            "negative_nan": [1.0, -np.nan, -np.inf, 2.0]}[probe]
    ins = {"pre_ids": [np.array([5, 6], np.int64)],
           "pre_scores": [np.zeros(2, np.float32)],
           "ids": [np.array([[10, 11], [12, 13]], np.int64)],
           "scores": [np.array(flat, np.float32).reshape(2, 2)]}
    attrs = {"beam_size": 2, "end_id": 1, "level": 0,
             "is_accumulated": True}
    j, p = _run_both("beam_search", ins, attrs)
    want = {"signed_zeros": [11, 12], "negative_nan": [13, 10]}[probe]
    assert j["selected_ids"][0].tolist() == want
    assert p["selected_ids"][0].tolist() == want
    assert (p["selected_scores"][0].tobytes()
            == j["selected_scores"][0].tobytes())
    _same(j, p)


def test_beam_search_decode():
    t, rows, end = 7, 8, 1
    ids = RNG.randint(0, 12, (t, rows)).astype(np.int64)
    ids[2, 3] = ids[4, 3] = end
    parents = np.stack([RNG.permutation(rows) for _ in range(t)]).astype(
        np.int32)
    scores = f32(t, rows)
    j, p = _run_both("beam_search_decode",
                     {"Ids": [ids], "ParentIdx": [parents],
                      "Scores": [scores]}, {"end_id": end})
    _same(j, p)


@pytest.mark.parametrize("case", ["forward", "reverse_lengths",
                                  "lengths_h0_relu"])
def test_gru(case):
    b, t, h = 3, 6, 5
    ins = {"Input": [f32(b, t, 3 * h)], "Weight": [f32(h, 3 * h) / 2],
           "Bias": [f32(3 * h)]}
    attrs = {"is_reverse": case == "reverse_lengths",
             "gate_activation": "sigmoid", "activation": "tanh"}
    if case != "forward":
        ins["Length"] = [np.array([6, 2, 4], np.int32)]
    if case == "lengths_h0_relu":
        ins["H0"] = [f32(b, h)]
        attrs["activation"] = "relu"
    j, p = _run_both("gru", ins, attrs)
    _same(j, p, GRU_TOL, skip=("BatchGate", "BatchResetHiddenPrev",
                               "BatchHidden"))


@pytest.mark.parametrize("pooltype", ["SUM", "AVERAGE", "SQRT", "MAX",
                                      "LAST", "FIRST"])
@pytest.mark.parametrize("length", [True, False], ids=["length", "full"])
def test_sequence_pool(pooltype, length):
    ins = {"X": [f32(4, 6, 3)]}
    if length:
        ins["Length"] = [np.array([6, 1, 3, 0], np.int32)]
    j, p = _run_both("sequence_pool", ins, {"pooltype": pooltype})
    _same(j, p)


@pytest.mark.parametrize("length", [True, False], ids=["length", "full"])
def test_sequence_softmax(length):
    ins = {"X": [f32(4, 6) * 3]}
    if length:
        ins["Length"] = [np.array([6, 1, 3, 0], np.int32)]
    j, p = _run_both("sequence_softmax", ins, {})
    _same(j, p)


@pytest.mark.parametrize("op_type,ins,attrs", [
    ("expand", {"X": [f32(2, 1, 3)]}, {"expand_times": [1, 4, 2]}),
    ("split", {"X": [f32(2, 6, 3)]}, {"axis": 1, "num": 3,
                                      "sections": []}),
    ("split", {"X": [f32(2, 7, 3)]}, {"axis": 1, "num": 0,
                                      "sections": [2, 4, 1]}),
], ids=["expand", "split_num", "split_sections"])
def test_shape_ops(op_type, ins, attrs):
    j, p = _run_both(op_type, ins, attrs)
    _same(j, p)


def test_fill_constant_batch_size_like():
    ins = {"Input": [np.zeros((6,), np.int64)]}
    attrs = {"shape": [5, 1], "value": 3.0, "input_dim_idx": 0,
             "output_dim_idx": 1}
    j, p = _run_both("fill_constant_batch_size_like", ins,
                     dict(attrs, dtype=DataType.INT32),
                     dict(attrs, dtype=JDataType.INT32))
    _same(j, p)
    assert p["Out"][0].shape == (5, 6) and p["Out"][0].dtype == np.int32


@pytest.mark.parametrize("i", [2, 5, -3], ids=["in_range", "past_end",
                                               "negative"])
def test_array_write_and_read_clamp(i):
    arr, xv = f32(4, 3), f32(3)
    idx = [np.array([i], np.int64)]
    j, p = _run_both("array_write", {"X": [xv], "I": idx, "Array": [arr]},
                     {})
    _same(j, p)
    j, p = _run_both("array_read", {"Array": [arr], "I": idx}, {})
    _same(j, p)


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

def _pow_loop(pkg, n_iters=3, max_trip_count=None, order="increment_first",
              fed_limit=False):
    """y = x * w^trips through a While loop (tests/test_control_flow.py
    _build_pow_loop); returns (main, startup, y)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data("x", shape=[3], dtype="float32")
        w = L.create_parameter([1, 3], "float32", name="w_loop")
        i = L.fill_constant(shape=[1], dtype="int32", value=0)
        limit = (L.data("n", shape=[1], dtype="int32",
                        append_batch_size=False) if fed_limit
                 else L.fill_constant(shape=[1], dtype="int32",
                                      value=n_iters))
        y = L.elementwise_add(x, L.fill_constant(
            shape=[1], dtype="float32", value=0.0))
        cond = L.less_than(i, limit)
        loop = L.While(cond, max_trip_count=max_trip_count)
        with loop.block():
            ny = L.elementwise_mul(y, w)
            L.assign(ny, output=y)
            if order == "increment_first":
                L.increment(i, 1, in_place=True)
                L.less_than(i, limit, cond=cond)
            else:
                L.less_than(i, limit, cond=cond)
                L.increment(i, 1, in_place=True)
    return main, startup, y


WHILE_CASES = {
    "inferred_bound": dict(),
    "max_trip_count": dict(max_trip_count=7),
    "compare_first": dict(order="compare_first"),
    "fed_limit": dict(fed_limit=True),
}


@pytest.mark.parametrize("case", sorted(WHILE_CASES))
def test_while_loop_against_jax(case):
    kw = WHILE_CASES[case]
    with junique.guard():
        jmain, jstart, jy = _pow_loop(fluid, **kw)
    with punique.guard():
        pmain, pstart, py = _pow_loop(pt, **kw)
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    assert pstart.desc.to_bytes() == jstart.desc.to_bytes()
    op = next(o for o in pmain.global_block().ops if o.type == "while")
    bound = pexecutor.trip_bound(op.attrs)
    assert bound == {"inferred_bound": 3, "max_trip_count": 7}.get(case, 0)

    wv = np.array([[1.5, 0.5, 2.0]], np.float32)
    xb = np.arange(6, dtype=np.float32).reshape(2, 3)
    feed = {"x": xb}
    if kw.get("fed_limit"):
        feed["n"] = np.array([3], np.int32)
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=js)
    js.set_var("w_loop", jnp.asarray(wv))
    (want,) = jexe.run(jmain, feed=feed, fetch_list=[jy], scope=js)
    ps = pt.Scope()
    pexe = pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=ps)
    ps.set_var("w_loop", torch.from_numpy(wv))
    (got,) = pexe.run(pmain, feed=feed, fetch_list=[py], scope=ps)
    trips = 4 if case == "compare_first" else 3
    np.testing.assert_allclose(got, xb * wv ** trips, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)

    # a bounded loop runs inside a device segment; an unbounded one is a
    # segment boundary, run between the device segments
    ops = pexe.lowered_ops(pmain, [py])
    kinds = {kind: [o.type for o in seg]
             for kind, seg in pexecutor._split_segments(ops)}
    assert ("while" in kinds.get("host", [])) == (bound == 0)
    assert ("while" in kinds.get("device", [])) == (bound > 0)


def test_while_backward_program_and_gradient_match_jax():
    """mean(x * w^3) through a While with max_trip_count 5: the train
    program (the SSA body and step-grad blocks the grad maker attaches
    included) byte-identical, and w's gradient the JAX package's and
    3 w^2 mean_b(x) / 3."""
    progs = {}
    for name, pkg, guard in (("jax", fluid, junique.guard),
                             ("port", pt, punique.guard)):
        with guard():
            main, startup, y = _pow_loop(pkg, max_trip_count=5)
            with pkg.program_guard(main, startup):
                loss = pkg.layers.mean(y)
                grads = pkg.backward.append_backward(loss)
        progs[name] = (main, startup, dict((p.name, g.name)
                                           for p, g in grads))
    (jmain, jstart, jg), (pmain, pstart, pg) = progs["jax"], progs["port"]
    assert pmain.desc.to_bytes() == jmain.desc.to_bytes()
    assert pg == jg and "w_loop" in pg
    op = next(o for o in pmain.global_block().ops if o.type == "while_grad")
    assert "__ssa_sub_block__" in op.attrs
    wv = np.array([[1.5, 0.5, 2.0]], np.float32)
    xb = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=js)
    js.set_var("w_loop", jnp.asarray(wv))
    (want,) = jexe.run(jmain, feed={"x": xb}, fetch_list=[jg["w_loop"]],
                       scope=js)
    ps = pt.Scope()
    pexe = pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=ps)
    ps.set_var("w_loop", torch.from_numpy(wv))
    (got,) = pexe.run(pmain, feed={"x": xb}, fetch_list=[pg["w_loop"]],
                      scope=ps)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, wv ** 2 * xb.mean(axis=0, keepdims=True),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["tiny", "full"])
def mt_builds(request):
    kw = MT_TINY if request.param == "tiny" else MT_FULL
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        return jmt.build(**kw), pmt.build(**kw)
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old


@pytest.mark.parametrize("which", ["main", "startup", "test", "decode"])
def test_machine_translation_programs_byte_identical(mt_builds, which):
    j, p = mt_builds
    jp = j["decode"]["program"] if which == "decode" else j[which]
    pp = p["decode"]["program"] if which == "decode" else p[which]
    assert pp.desc.to_bytes() == jp.desc.to_bytes()
    if which == "decode":
        # the decode loop matches the counter pattern: a static bound
        op = next(o for o in pp.global_block().ops if o.type == "while")
        assert pexecutor.trip_bound(op.attrs) == \
            j["config"]["decode_max_len"]
    if which == "main":
        assert any(o.type == "recurrent_grad"
                   for o in pp.global_block().ops)


VOCAB, EMB, HID = 30, 8, 16


def _make_cell(pkg, dec, boot):
    state = dec.InitState(init=boot)
    cell = dec.StateCell(inputs={"x": None}, states={"h": state},
                         out_state="h")

    @cell.state_updater
    def updater(state_cell):
        x = state_cell.get_input("x")
        h = state_cell.get_state("h")
        nh = pkg.layers.fc(pkg.layers.concat([x, h], axis=1), size=HID,
                           act="tanh", param_attr="cell_w",
                           bias_attr="cell_b")
        state_cell.set_state("h", nh)

    return cell


def _beam_decoder_program(pkg, dec, beam=3, dmax=5, end_id=1):
    L = pkg.layers
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        init_ids = L.data("init_ids", shape=[], dtype="int64",
                          append_batch_size=True)
        init_scores = L.data("init_scores", shape=[], dtype="float32",
                             append_batch_size=True)
        boot = L.data("boot", shape=[HID], dtype="float32")
        cell = _make_cell(pkg, dec, boot)
        decoder = dec.BeamSearchDecoder(
            cell, init_ids, init_scores, target_dict_dim=VOCAB,
            word_dim=EMB, topk_size=beam, max_len=dmax, beam_size=beam,
            end_id=end_id, emb_param_attr="dec_emb_w", param_attr="out_w",
            bias_attr="out_b")
        decoder.decode()
        ids, scores = decoder()
    return prog, startup, ids, scores


def test_beam_search_decoder_program_byte_identical():
    with junique.guard():
        jprog, jstart, _, _ = _beam_decoder_program(fluid, jdecoder)
    with punique.guard():
        pprog, pstart, _, _ = _beam_decoder_program(pt, pdecoder)
    assert pprog.desc.to_bytes() == jprog.desc.to_bytes()
    assert pstart.desc.to_bytes() == jstart.desc.to_bytes()


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_machine_translation_decode_against_jax():
    """Batch 4 x beam 4 through 12 steps from the JAX startup's weights:
    every sentence equal, final scores within SCORE_REL."""
    j, p = jmt.build(**MT_TINY), pmt.build(**MT_TINY)
    cfg = j["config"]
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    j["startup"].random_seed = 5
    jexe.run(j["startup"], scope=js)
    names = [v.name for v in p["startup"].list_vars() if v.persistable]
    ps = pt.Scope()
    pt.io.set_params_from_numpy(
        ps, {n: np.asarray(js.find_var(n)) for n in names}, "cpu",
        program=p["startup"])
    b, w = 4, cfg["beam_size"]
    batch = jmt.make_fake_batch(b, cfg, seed=1)
    assert {k: v.tolist() for k, v in pmt.make_fake_batch(
        b, cfg, seed=1).items()} == {k: v.tolist() for k, v in batch.items()}
    feed = {"src": batch["src"], "src_len": batch["src_len"],
            "start_ids": np.zeros((b * w,), np.int64),
            "init_scores": np.tile(np.array([0.0] + [-1e9] * (w - 1),
                                            np.float32), b)}
    jd, pd = j["decode"], p["decode"]
    jsent, jscore = jexe.run(jd["program"], feed=feed,
                             fetch_list=[jd["sentences"], "init_scores"],
                             scope=js)
    psent, pscore = pt.Executor(pt.CPUPlace()).run(
        pd["program"], feed=feed,
        fetch_list=[pd["sentences"], "init_scores"], scope=ps)
    assert psent.shape == (b * w, cfg["decode_max_len"])
    assert psent.tolist() == np.asarray(jsent).tolist()
    jscore = np.asarray(jscore)
    np.testing.assert_allclose(pscore, jscore, rtol=SCORE_REL, atol=0)


def test_beam_search_decoder_with_jax_trained_parameters():
    """tests/test_contrib_decoder.py: a StateCell trained 3 Adam steps by
    the JAX package's TrainingDecoder; both packages' BeamSearchDecoder
    programs decode from those weights to the same ids and scores."""
    L = jlayers
    main, startup = JProgram(), JProgram()
    with junique.guard(), jguard(main, startup):
        tgt = L.data("tgt", shape=[6, 1], dtype="int64")
        tgt_next = L.data("tgt_next", shape=[6, 1], dtype="int64")
        length = L.data("length", shape=[], dtype="int32",
                        append_batch_size=True)
        boot = L.data("boot", shape=[HID], dtype="float32")
        emb = L.embedding(tgt, size=[VOCAB, EMB], param_attr="dec_emb_w")
        cell = _make_cell(fluid, jdecoder, boot)
        decoder = jdecoder.TrainingDecoder(cell, length=length)
        with decoder.block():
            cur = decoder.step_input(emb)
            decoder.state_cell.compute_state(inputs={"x": cur})
            h = decoder.state_cell.get_state("h")
            score = L.fc(h, size=VOCAB, act="softmax", param_attr="out_w",
                         bias_attr="out_b")
            decoder.state_cell.update_states()
            decoder.output(score)
        loss = L.mean(L.cross_entropy(decoder(), tgt_next))
        fluid.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=js)
    rng = np.random.RandomState(1)
    feed = {"tgt": rng.randint(0, VOCAB, (4, 6, 1)).astype(np.int64),
            "tgt_next": rng.randint(0, VOCAB, (4, 6, 1)).astype(np.int64),
            "length": np.full((4,), 6, np.int32),
            "boot": rng.rand(4, HID).astype(np.float32)}
    for _ in range(3):
        jexe.run(main, feed=feed, fetch_list=[loss], scope=js)

    beam, b = 3, 2
    with junique.guard():
        jprog, _, jids, jsc = _beam_decoder_program(fluid, jdecoder, beam)
    with punique.guard():
        pprog, pstart, pids, psc = _beam_decoder_program(pt, pdecoder, beam)
    ps = pt.Scope()
    names = [v.name for v in pstart.list_vars() if v.persistable]
    pt.io.set_params_from_numpy(
        ps, {n: np.asarray(js.find_var(n)) for n in names}, "cpu",
        program=pstart)
    dfeed = {"init_ids": np.full((b * beam,), 2, np.int64),
             "init_scores": np.tile(np.array([0.0] + [-1e9] * (beam - 1),
                                             np.float32), b),
             "boot": np.repeat(rng.rand(b, HID).astype(np.float32), beam,
                               axis=0)}
    want_ids, want_sc = jexe.run(jprog, feed=dfeed, fetch_list=[jids, jsc],
                                 scope=js)
    got_ids, got_sc = pt.Executor(pt.CPUPlace()).run(
        pprog, feed=dfeed, fetch_list=[pids, psc], scope=ps)
    assert got_ids.shape == (b * beam, 5)
    assert got_ids.tolist() == np.asarray(want_ids).tolist()
    np.testing.assert_allclose(got_sc, np.asarray(want_sc), rtol=SCORE_REL,
                               atol=0)


def test_dynamic_decode_equals_the_engine():
    lm = dict(vocab=64, n_layer=2, n_head=2, d_model=16, d_inner_hid=32,
              max_positions=64, eos_id=1)
    with punique.guard():
        spec = ptransformer.build_lm(**lm)["spec"]
    spec.startup.random_seed = 3
    rng = np.random.RandomState(2)
    prompts = [rng.randint(2, 64, (n,)).astype(np.int64) for n in (5, 9)]
    got = pdecoder.dynamic_decode(spec, prompts, max_len=6,
                                  place=pt.CPUPlace(), scope=pt.Scope())
    eng = DecodeEngine(spec, place=pt.CPUPlace(), scope=pt.Scope())
    want = eng.generate(prompts, 6)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    with pytest.raises(ValueError, match="eos_id"):
        pdecoder.GenerationDecoder(spec, place=pt.CPUPlace(), end_id=7)


def _max_rel(js, ps, names):
    """The largest |port - JAX| over the float persistables ``names``,
    and the largest |JAX value| among them."""
    diff = top = 0.0
    for n in names:
        a = np.asarray(js.find_var(n))
        if a.dtype.kind != "f":
            continue
        diff = max(diff, float(np.abs(ps.find_var(n).numpy() - a).max()))
        top = max(top, float(np.abs(a).max()))
    return diff, top


def test_machine_translation_trains_and_decodes_against_jax():
    """MT_TINY: 5 Adam steps on one batch of 4 from the JAX startup's
    parameters through both packages' train programs (the decoder one
    ``recurrent`` op, its backward the generic vjp of the whole loop):
    losses within 5-step tolerance 1e-5 relative, and every parameter
    and Adam moment within 1e-4 of the largest magnitude among them.
    (An element-wise relative bound would not hold: the attention
    score's bias ``fc_5.b_0`` has a gradient that is 0 in exact
    arithmetic, since the softmax is shift-invariant, so Adam moves it
    by its rounding noise; ROADMAP C, "Adam near zero gradients".) Then
    each package's decode program on its trained scope: the same
    sentences, final scores within SCORE_REL."""
    j, p = jmt.build(**MT_TINY), pmt.build(**MT_TINY)
    assert p["main"].desc.to_bytes() == j["main"].desc.to_bytes()
    cfg = j["config"]
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    j["startup"].random_seed = 5
    jexe.run(j["startup"], scope=js)
    names = [v.name for v in p["startup"].list_vars() if v.persistable]
    ps = pt.Scope()
    pt.io.set_params_from_numpy(
        ps, {n: np.asarray(js.find_var(n)) for n in names}, "cpu",
        program=p["startup"])
    pexe = pt.Executor(pt.CPUPlace())
    batch = pmt.make_fake_batch(4, cfg, seed=1)
    losses = []
    for _ in range(5):
        (jl,) = jexe.run(j["main"], feed=batch, fetch_list=[j["loss"]],
                         scope=js)
        (pl,) = pexe.run(p["main"], feed=batch, fetch_list=[p["loss"]],
                         scope=ps)
        losses.append((float(np.asarray(jl).reshape(-1)[0]),
                       float(pl.reshape(-1)[0])))
    for jl, pl in losses:
        assert abs(pl - jl) <= 1e-5 * abs(jl), losses
    assert losses[-1][1] < losses[0][1]
    diff, top = _max_rel(js, ps, names)
    assert diff <= 1e-4 * top, (diff, top)

    b, w = 4, cfg["beam_size"]
    feed = {"src": batch["src"], "src_len": batch["src_len"],
            "start_ids": np.zeros((b * w,), np.int64),
            "init_scores": np.tile(np.array([0.0] + [-1e9] * (w - 1),
                                            np.float32), b)}
    jd, pd = j["decode"], p["decode"]
    jsent, jscore = jexe.run(jd["program"], feed=feed,
                             fetch_list=[jd["sentences"], "init_scores"],
                             scope=js)
    psent, pscore = pexe.run(pd["program"], feed=feed,
                             fetch_list=[pd["sentences"], "init_scores"],
                             scope=ps)
    assert psent.tolist() == np.asarray(jsent).tolist()
    np.testing.assert_allclose(pscore, np.asarray(jscore), rtol=SCORE_REL,
                               atol=0)
