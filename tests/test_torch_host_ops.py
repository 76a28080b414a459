"""The single-device rest of the registry in the port against the JAX
package, on the CPU: 6 types of ``kernels_host.py``, 3 of
``kernels_fused.py`` and the 8 of ``kernels_dist.py`` that need no mesh
(``average_accumulates``, the 18th, is tests/test_torch_model_average.py's),
and the layers ``py_func``, ``tree_conv``, ``random_data_generator`` and
``Preprocessor``.

- **Ops.** Each type through both packages' emitters on the same seeded
  inputs: integer outputs equal, float outputs within FWD_REL of each
  output's largest magnitude; ``tree_conv`` (the JAX op's float32 numpy
  arithmetic on the host, in both) equal, bit for bit;
  ``attention_lstm``'s loop of products and softmaxes within ATT_REL.
  ``rnn_memory_helper``'s vjp and its grad op pass the cotangent on.
- **Host ops in a program.** ``delete_var`` drops a persistable from the
  scope, and a later run of a plan that read it raises rather than read
  a freed tensor (``Scope.erase``, ``state_rebound``); ``get_places``
  counts the executor's one device (the JAX op counts ``jax.devices()``);
  ``py_func`` splits the block into device segments around it, and a
  program of it runs as the JAX package's.
- **Descs.** One op of each type but ``py_func`` (whose ``func`` attr is
  a Python callable, so its program cannot be serialized), appended by
  hand, gives the same program bytes in both packages. ``py_func``'s
  programs are held by their op lists: types, slots and every attribute
  but the callable, which is the same object.
- **Layers.** ``tree_conv`` (with its bias and activation),
  ``random_data_generator`` + ``read_file`` and a ``Preprocessor``'s
  program are the JAX package's, byte for byte; both readers' batches
  (numpy's RandomState(0)) and the preprocessed batches are equal, and a
  fc trained on them gives the JAX package's losses within FWD_REL.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.utils import unique_name as junique

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.core import types as pcore_types  # noqa: F401
from paddle_tpu_torch.utils import unique_name as punique

from test_torch_tensor_ops import (_append, _no_callstack,  # noqa: F401
                                   assert_outputs_match, assert_vjp_match,
                                   run_both)

FWD_REL = 1e-6
ATT_REL = 1e-5

NEW_HOST = ("py_func", "feed", "fetch", "get_places", "delete_var",
            "tree_conv")
NEW_FUSED = ("fused_embedding_seq_pool", "fusion_seqexpand_concat_fc",
             "attention_lstm")
NEW_DIST = ("merge_selected_rows", "get_tensor_from_selected_rows",
            "split_selected_rows", "split_byref", "lookup_sparse_table",
            "ref_by_trainer_id", "rnn_memory_helper",
            "rnn_memory_helper_grad")
NEW_REST = NEW_HOST + NEW_FUSED + NEW_DIST + ("average_accumulates",)

_R = np.random.RandomState(2111)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _py_add(a, b):
    return a + 2.0 * b, (a * b).sum(axis=1, keepdims=True)


def _tbcnn_edges():
    """Two trees of 6 and 4 nodes, 1-indexed (parent, child), each ended
    by a (0, 0) row."""
    e = np.zeros((2, 8, 2), np.int64)
    e[0, :5] = [(1, 2), (1, 3), (2, 4), (2, 5), (3, 6)]
    e[1, :3] = [(1, 2), (2, 3), (2, 4)]
    return e


LEN = np.array([5, 2, 0], np.int32)
CASES = [
    ("py_func", "py_func", {"X": [_f(3, 4), _f(3, 4)]}, {"func": _py_add}),
    ("feed", "feed", {"X": [_f(2, 3)]}, {"col": 0}),
    ("fetch", "fetch", {"X": [_f(2, 3)]}, {"col": 0}),
    ("get_places", "get_places", {}, {"device_count": 3}),
    ("tree_conv", "tree_conv",
     {"NodesVector": [_f(2, 7, 5)], "EdgeSet": [_tbcnn_edges()],
      "Filter": [_f(5, 3, 4, 2)]}, {"max_depth": 2}),
    ("tree_conv_deep", "tree_conv",
     {"NodesVector": [_f(2, 7, 5)], "EdgeSet": [_tbcnn_edges()],
      "Filter": [_f(5, 3, 4, 2)]}, {"max_depth": 3}),
    ("fused_embedding_seq_pool", "fused_embedding_seq_pool",
     {"W": [_f(11, 6)], "Ids": [_R.randint(0, 11, (4, 5, 1))]},
     {"padding_idx": -1}),
    ("fused_embedding_seq_pool_pad", "fused_embedding_seq_pool",
     {"W": [_f(11, 6)], "Ids": [_R.randint(0, 11, (4, 5))]},
     {"padding_idx": 3}),
    ("fusion_seqexpand_concat_fc", "fusion_seqexpand_concat_fc",
     {"X": [_f(3, 5, 4), _f(3, 2), _f(3, 3)], "FCWeight": [_f(9, 6)],
      "FCBias": [_f(6)]}, {"fc_activation": "tanh"}),
    ("fusion_seqexpand_concat_fc_relu", "fusion_seqexpand_concat_fc",
     {"X": [_f(3, 5, 4), _f(3, 2)], "FCWeight": [_f(6, 6)]},
     {"fc_activation": "relu"}),
    ("attention_lstm", "attention_lstm",
     {"X": [_f(3, 5, 4)], "C0": [_f(3, 3)], "H0": [_f(3, 3)],
      "AttentionWeight": [_f(7, 1)], "AttentionBias": [_f(1, 1)],
      "AttentionScalar": [np.array([[0.7]], np.float32)],
      "AttentionScalarBias": [np.array([[0.1]], np.float32)],
      "LSTMWeight": [_f(7, 12)], "LSTMBias": [_f(1, 12)],
      "Length": [LEN]}, {}),
    ("attention_lstm_plain", "attention_lstm",
     {"X": [_f(2, 4, 4)], "C0": [_f(2, 3)],
      "AttentionWeight": [_f(7, 1)],
      "LSTMWeight": [_f(7, 12)], "LSTMBias": [_f(1, 12)]},
     {"gate_activation": "sigmoid", "cell_activation": "relu",
      "candidate_activation": "identity"}),
    ("merge_selected_rows", "merge_selected_rows", {"X": [_f(4, 3)]}, {}),
    ("get_tensor_from_selected_rows", "get_tensor_from_selected_rows",
     {"X": [_f(4, 3)]}, {}),
    ("split_selected_rows", "split_selected_rows", {"X": [_f(7, 3)]},
     {"height_sections": [2, 4, 1]}),
    ("split_byref", "split_byref", {"X": [_f(6, 2)]},
     {"height_sections": [3, 3]}),
    ("lookup_sparse_table", "lookup_sparse_table",
     {"W": [_f(9, 4)], "Ids": [_R.randint(0, 9, (5, 1))]}, {}),
    ("ref_by_trainer_id", "ref_by_trainer_id",
     {"X": [_f(2, 3), _f(2, 3), _f(2, 3)],
      "TrainerId": [np.array([2], np.int64)]}, {}),
    ("rnn_memory_helper", "rnn_memory_helper", {"X": [_f(3, 4)]}, {}),
    ("rnn_memory_helper_grad", "rnn_memory_helper_grad",
     {"Out@GRAD": [_f(3, 4)], "X": [_f(3, 4)]}, {}),
]
OP_CASES = [c for c in CASES if c[1] not in ("delete_var",)]


def test_cases_cover_the_types():
    assert len(NEW_REST) == 18
    covered = {c[1] for c in CASES} | {"delete_var", "average_accumulates"}
    assert covered == set(NEW_REST)
    for t in NEW_REST:
        p, j = preg.lookup(t), jreg.lookup(t)
        assert p.emitter is not None, t
        for flag in ("no_grad", "needs_rng", "is_host",
                     "intermediate_outputs"):
            assert getattr(p, flag) == getattr(j, flag), (t, flag)


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_rest_op_matches_jax(case):
    _, op_type, ins, attrs = case
    j, p = run_both(op_type, ins, attrs)
    assert sorted(p) == sorted(j)
    rel = {"tree_conv": 0.0, "attention_lstm": ATT_REL}.get(op_type, FWD_REL)
    assert_outputs_match(j, p, rel=rel)
    if op_type == "tree_conv":
        for got, want in zip(p["Out"], j["Out"]):
            assert np.array_equal(got, want)


def test_rnn_memory_helper_vjp_matches_jax():
    assert_vjp_match("rnn_memory_helper", {"X": [_f(3, 4)]}, {})


def test_get_places_counts_the_executors_device():
    ctx = preg.EmitContext(torch.device("cpu"))
    out = preg.lookup("get_places").emitter(ctx, {}, {})["Out"][0]
    assert out.tolist() == [0] and out.dtype == torch.int64


def test_tree_conv_rejects_bad_edges_as_jax():
    bad = _tbcnn_edges()
    bad[0, 0] = (1, 9)
    ins = {"NodesVector": [_f(2, 7, 5)], "EdgeSet": [bad],
           "Filter": [_f(5, 3, 4, 2)]}
    for reg in (jreg, preg):
        with pytest.raises(ValueError, match="outside"):
            run = reg.lookup("tree_conv").emitter
            if reg is jreg:
                run(reg.EmitContext(), {k: [np.asarray(v) for v in vs]
                                        for k, vs in ins.items()}, {})
            else:
                run(reg.EmitContext(torch.device("cpu")),
                    {k: [torch.from_numpy(np.asarray(v)) for v in vs]
                     for k, vs in ins.items()}, {})


def _delete_program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", shape=[3], dtype="float32")
        w = fl.layers.create_parameter([3, 2], "float32", name="dw")
        out = fl.layers.mul(x, w)
        main.global_block().append_op(type="delete_var", inputs={},
                                      outputs={},
                                      attrs={"var_names": ["dw"]})
    return main, startup, out


def test_delete_var_erases_and_a_later_run_raises():
    with punique.guard():
        main, startup, out = _delete_program(pt)
    with junique.guard():
        jmain, _, _ = _delete_program(fluid)
    assert main.desc.to_bytes() == jmain.desc.to_bytes()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    x = _f(4, 3)
    want = x @ scope.find_var("dw").numpy()
    (got,) = exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert scope.find_var("dw") is None and "dw" not in scope.var_names()
    with pytest.raises(KeyError, match="dw"):
        exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)


def test_state_rebound_sees_an_erased_name():
    from paddle_tpu_torch.executor import _Segment
    import weakref
    scope = pt.Scope()
    t = torch.zeros(2)
    scope.set_var("w", t)
    seg = _Segment([], [], ["w"], [], [], False)
    seg.state_refs = {"w": weakref.ref(t)}
    assert not seg.state_rebound(scope)
    scope.erase(["w"])
    assert seg.state_rebound(scope)
    del t
    assert seg.state_rebound(scope)


def _py_func_program(fl):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", shape=[4], dtype="float32")
        y = fl.layers.data("y", shape=[4], dtype="float32")
        h = fl.layers.fc(x, size=4, act="tanh")
        blk = main.global_block()
        o1 = blk.create_var(name="pf_out1", dtype="float32", shape=[-1, 4])
        o2 = blk.create_var(name="pf_out2", dtype="float32", shape=[-1, 1])
        fl.layers.py_func(_py_add, [h, y], [o1, o2])
        out = fl.layers.fc(o1, size=2)
        total = fl.layers.elementwise_add(fl.layers.reduce_sum(out),
                                          fl.layers.reduce_sum(o2))
    return main, startup, total


def _same_op_lists(pm, jm):
    pops = pm.global_block().desc.ops
    jops = jm.global_block().desc.ops
    assert [o.type for o in pops] == [o.type for o in jops]
    for p, j in zip(pops, jops):
        assert (p.inputs, p.outputs) == (j.inputs, j.outputs), p.type
        assert sorted(p.attrs) == sorted(j.attrs), p.type
        for k in j.attrs:
            if k == "op_callstack":
                continue
            assert p.attrs[k] is j.attrs[k] or p.attrs[k] == j.attrs[k], k
    assert sorted(pm.global_block().desc.vars) == sorted(
        jm.global_block().desc.vars)


def test_py_func_program_runs_as_jax():
    """The op list is the JAX package's (the func attr the same object);
    the block runs as device segment, host py_func, device segment, and
    the fetch is the JAX package's."""
    with junique.guard():
        jm, js, jt = _py_func_program(fluid)
    with punique.guard():
        pm, ps, pt_ = _py_func_program(pt)
    _same_op_lists(pm, jm)
    assert ps.desc.to_bytes() == js.desc.to_bytes()
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jexe.run(js, scope=jscope)
    names = [v.name for v in pm.list_vars() if v.persistable]
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in names}, "cpu",
        program=pm)
    feed = {"x": _f(6, 4), "y": _f(6, 4)}
    (want,) = jexe.run(jm, feed=feed, fetch_list=[jt.name], scope=jscope)
    (got,) = pexe.run(pm, feed=feed, fetch_list=[pt_.name], scope=pscope)
    np.testing.assert_allclose(got, want, rtol=FWD_REL, atol=0)
    from paddle_tpu_torch.executor import _make_plan
    ops = pexe.lowered_ops(pm, [pt_.name])
    plan = _make_plan(ops, list(feed), [pt_.name], pm.global_block(),
                      pscope)
    assert [k for k, _ in plan.segments] == ["device", "host", "device"]


F32, I64 = "float32", "int64"
DESC_CASES = {
    "feed": ({"X": [("fx", [2, 3], F32)]}, {"Out": ["o"]}, {"col": 0}),
    "fetch": ({"X": [("fx", [2, 3], F32)]}, {"Out": ["o"]}, {"col": 0}),
    "get_places": ({}, {"Out": ["o"]}, {"device_count": 2}),
    "delete_var": ({}, {}, {"var_names": ["a", "b"]}),
    "tree_conv": ({"NodesVector": [("n", [2, 7, 5], F32)],
                   "EdgeSet": [("e", [2, 8, 2], I64)],
                   "Filter": [("w", [5, 3, 4, 2], F32)]},
                  {"Out": ["o"]}, {"max_depth": 2}),
    "fused_embedding_seq_pool": ({"W": [("w", [11, 6], F32)],
                                  "Ids": [("i", [4, 5, 1], I64)]},
                                 {"Out": ["o"]}, {"padding_idx": -1}),
    "fusion_seqexpand_concat_fc": (
        {"X": [("a", [3, 5, 4], F32), ("b", [3, 2], F32)],
         "FCWeight": [("w", [6, 6], F32)]}, {"Out": ["o"]},
        {"fc_activation": "relu"}),
    "attention_lstm": (
        {"X": [("x", [3, 5, 4], F32)], "C0": [("c", [3, 3], F32)],
         "AttentionWeight": [("aw", [7, 1], F32)],
         "LSTMWeight": [("lw", [7, 12], F32)],
         "LSTMBias": [("lb", [1, 12], F32)]},
        {"Hidden": ["h"], "Cell": ["c2"], "AttentionedX": ["ax"],
         "AttentionFCOut": ["af"], "LSTMX": ["lx"], "LSTMOUT": ["lo"]}, {}),
    "merge_selected_rows": ({"X": [("x", [4, 3], F32)]}, {"Out": ["o"]}, {}),
    "get_tensor_from_selected_rows": ({"X": [("x", [4, 3], F32)]},
                                      {"Out": ["o"]}, {}),
    "split_selected_rows": ({"X": [("x", [7, 3], F32)]},
                            {"Out": ["o1", "o2"]},
                            {"height_sections": [3, 4]}),
    "split_byref": ({"X": [("x", [6, 2], F32)]}, {"Out": ["o1", "o2"]},
                    {"height_sections": [3, 3]}),
    "lookup_sparse_table": ({"W": [("w", [9, 4], F32)],
                             "Ids": [("i", [5, 1], I64)]},
                            {"Out": ["o"]}, {}),
    "ref_by_trainer_id": ({"X": [("a", [2, 3], F32), ("b", [2, 3], F32)],
                           "TrainerId": [("t", [1], I64)]},
                          {"Out": ["o"]}, {}),
    "rnn_memory_helper": ({"X": [("x", [3, 4], F32)]}, {"Out": ["o"]}, {}),
    "rnn_memory_helper_grad": ({"X": [("x", [3, 4], F32)],
                                "Out@GRAD": [("g", [3, 4], F32)]},
                               {"X@GRAD": ["xg"]}, {}),
}


def test_desc_cases_cover_the_types():
    assert set(DESC_CASES) == set(NEW_REST) - {"py_func",
                                               "average_accumulates"}


@pytest.mark.parametrize("op_type", sorted(DESC_CASES))
def test_rest_op_desc_bytes_match_jax(op_type):
    ins, outs, attrs = DESC_CASES[op_type]
    with junique.guard():
        j = _append(fluid, op_type, ins, outs, dict(attrs))
    with punique.guard():
        p = _append(pt, op_type, ins, outs, dict(attrs))
    assert p.desc.to_bytes() == j.desc.to_bytes()


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _tree_conv_program(fl):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 8
    with fl.program_guard(main, startup):
        nodes = fl.layers.data("nodes", shape=[7, 5], dtype="float32")
        edges = fl.layers.data("edges", shape=[8, 2], dtype="int64")
        out = fl.layers.tree_conv(nodes, edges, output_size=4,
                                  num_filters=2, max_depth=2)
        loss = fl.layers.mean(out)
    return main, startup, out, loss


def test_tree_conv_layer_runs_as_jax():
    with junique.guard():
        jm, js, jo, _ = _tree_conv_program(fluid)
    with punique.guard():
        pm, ps, po, _ = _tree_conv_program(pt)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    assert ps.desc.to_bytes() == js.desc.to_bytes()
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jexe.run(js, scope=jscope)
    names = [v.name for v in pm.list_vars() if v.persistable]
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in names}, "cpu",
        program=pm)
    feed = {"nodes": _f(2, 7, 5), "edges": _tbcnn_edges()}
    (want,) = jexe.run(jm, feed=feed, fetch_list=[jo.name], scope=jscope)
    (got,) = pexe.run(pm, feed=feed, fetch_list=[po.name], scope=pscope)
    assert got.shape == (2, 7, 4, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_REL)


def _reader_program(fl):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 6
    with fl.program_guard(main, startup):
        reader = fl.layers.random_data_generator(
            low=-1.0, high=1.0, shapes=[[4, 3], [4, 1]])
        pre = fl.layers.Preprocessor(reader)
        with pre.block():
            img, lbl = pre.inputs()
            pre.outputs(fl.layers.scale(img, scale=2.0, bias=0.5), lbl)
        x, y = fl.layers.read_file(reader)
        pred = fl.layers.fc(x, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, reader, pre, x, loss


def test_random_data_generator_and_preprocessor_run_as_jax():
    with junique.guard():
        jm, js, jr, jp, jx, jl = _reader_program(fluid)
    with punique.guard():
        pm, ps, pr, pp, px, pl = _reader_program(pt)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    assert ps.desc.to_bytes() == js.desc.to_bytes()
    assert pp._program.desc.to_bytes() == jp._program.desc.to_bytes()
    assert (pr.shapes, pr.dtypes) == (jr.shapes, jr.dtypes)
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(js)
    names = [v.name for v in pm.list_vars() if v.persistable]
    with pt.scope_guard(pscope):
        pexe.run(ps)
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in names}, "cpu",
        program=pm)
    jr.start()
    pr.start()
    try:
        rng = np.random.RandomState(0)
        for step in range(3):
            with fluid.scope_guard(jscope):
                jxv, jlv = jexe.run(jm, fetch_list=[jx.name, jl.name])
            with pt.scope_guard(pscope):
                pxv, plv = pexe.run(pm, fetch_list=[px.name, pl.name])
            raw = rng.uniform(-1.0, 1.0, [4, 3]).astype(np.float32)
            rng.uniform(-1.0, 1.0, [4, 1])
            assert np.array_equal(pxv, jxv), step
            np.testing.assert_allclose(pxv, raw * 2.0 + 0.5, rtol=1e-6)
            np.testing.assert_allclose(plv, jlv, rtol=FWD_REL, atol=0)
    finally:
        jr.reset()
        pr.reset()
