"""The port's IR against the JAX package's: every ported pipeline stage and
registry pass rewrites the same program to the same op list.

Programs come from the JAX package's layers (the program shapes of
tests/test_ir_passes.py, tests/test_build_strategy.py and
tests/test_attention_fusion.py, restricted to ops the port has) and reach
the port through the byte codec, or are the Transformer programs both
packages build byte-identically. Op lists are compared op by op: type,
slot names, variable names and attrs (``pt_const`` values, which are
never serialized, with ``np.array_equal``).

The guarded passes (conv, RNN, sequence fusions, graph_viz) are checked
for their claim: the JAX package's own pass leaves the Transformer
inference program unchanged, the port's does too, and the port's raises
on a graph that holds the pass's anchor ops.
"""

import enum

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import ir as jir
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.types import DataType as JDataType
from paddle_tpu.ir import pipeline as jpipe
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import ir as pir
from paddle_tpu_torch.core.desc import OpDesc as POpDesc, ProgramDesc
from paddle_tpu_torch.core.types import DataType as PDataType
from paddle_tpu_torch.inference import AnalysisConfig
from paddle_tpu_torch.ir import pipeline as ppipe
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

TINY = dict(src_vocab=50, tgt_vocab=50, max_len=8, n_layer=1, n_head=2,
            d_model=32, d_inner_hid=64, warmup_steps=4)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def _canon(v):
    """An attr value in a form both packages' values compare in."""
    if isinstance(v, enum.Enum):
        return int(v.value)
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, v.tolist())
    if isinstance(v, np.generic):
        return v.item()
    return v


def assert_same_ops(jops, pops):
    jt, ptypes = [o.type for o in jops], [o.type for o in pops]
    assert ptypes == jt
    for i, (j, p) in enumerate(zip(jops, pops)):
        where = f"op {i} ({j.type})"
        assert p.inputs == j.inputs, where
        assert p.outputs == j.outputs, where
        assert sorted(p.attrs) == sorted(j.attrs), where
        for k in j.attrs:
            if isinstance(j.attrs[k], np.ndarray) or isinstance(
                    p.attrs[k], np.ndarray):
                # pt_const literals: values, not dtypes (the JAX package
                # narrows int64 to int32)
                assert np.array_equal(np.asarray(p.attrs[k]),
                                      np.asarray(j.attrs[k])), (where, k)
            else:
                assert _canon(p.attrs[k]) == _canon(j.attrs[k]), (where, k)


def to_port(jprog):
    """The JAX package's program through the byte codec into the port."""
    return pt.Program._from_desc(ProgramDesc.from_bytes(jprog.desc.to_bytes()))


def _ops(prog):
    return list(prog.global_block().desc.ops)


@pytest.fixture(autouse=True)
def _no_callstacks():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


# ---------------------------------------------------------------------------
# op-list stages on hand-written op lists (tests/test_ir_passes.py shapes,
# the JAX tests' sgd replaced by adam, the port's one optimizer)
# ---------------------------------------------------------------------------

def _adam(i, lr="lr", beta1=0.9, extra=None):
    ins = {"Param": [f"p{i}"], "Grad": [f"g{i}"], "Moment1": [f"m{i}"],
           "Moment2": [f"v{i}"], "Beta1Pow": [f"b1p{i}"],
           "Beta2Pow": [f"b2p{i}"], "LearningRate": [lr]}
    ins.update(extra or {})
    return ("adam", ins,
            {"ParamOut": [f"p{i}"], "Moment1Out": [f"m{i}"],
             "Moment2Out": [f"v{i}"], "Beta1PowOut": [f"b1p{i}"],
             "Beta2PowOut": [f"b2p{i}"]},
            {"beta1": beta1, "beta2": 0.999, "epsilon": 1e-8})


def _scale(x, out, s=2.0, bias=0.0):
    return ("scale", {"X": [x]}, {"Out": [out]},
            {"scale": s, "bias": bias, "bias_after_scale": True})


def _add(x, y, out):
    return ("elementwise_add", {"X": [x], "Y": [y]}, {"Out": [out]},
            {"axis": -1})


def _relu(x, out):
    return ("relu", {"X": [x]}, {"Out": [out]}, {})


FP32 = "<fp32>"  # each package's DataType.FP32 (see _descs)


def _fill(out, value, shape=(1,)):
    return ("fill_constant", {}, {"Out": [out]},
            {"shape": list(shape), "dtype": FP32, "value": value})


def _descs(spec, op_desc, data_type):
    """One package's OpDescs of a spec (fresh attrs, its own DataType)."""
    return [op_desc(t, i, o, {k: data_type.FP32 if v == FP32 else v
                              for k, v in a.items()})
            for t, i, o, a in spec]


LIST_CASES = {
    # cse
    "cse_dedupes": ("cse", [_scale("x", "a", 3.0), _scale("x", "b", 3.0),
                            _add("a", "b", "o")], {"o"}),
    "cse_distinct_attrs_and_needed": (
        "cse", [_scale("x", "a"), _scale("x", "b", 3.0), _scale("x", "c"),
                _add("a", "b", "o")], {"c"}),
    "cse_in_place_update": (
        "cse", [_scale("p0", "a"), _adam(0), _scale("p0", "b")], set()),
    "cse_same_version": (
        "cse", [_scale("p0", "a"), _scale("p0", "b"), _add("a", "b", "o")],
        {"o"}),
    # constant folding
    "fold_const_chain": (
        "constant_fold", [_fill("c", 3.0), _scale("c", "c2"),
                          ("elementwise_mul", {"X": ["x"], "Y": ["c2"]},
                           {"Out": ["o"]}, {"axis": 0})], {"o"}),
    "fold_chain_of_two": (
        "constant_fold", [_fill("c", 1.5, (2, 3)), _scale("c", "c2", 4.0),
                          _relu("c2", "c3"), _add("x", "c3", "o")], {"o"}),
    "fold_leaves_state_alone": (
        "constant_fold", [_scale("state_w", "s"),
                          ("elementwise_mul", {"X": ["x"], "Y": ["s"]},
                           {"Out": ["o"]}, {"axis": 0})], set()),
    # dead-op elimination
    "dce": ("dce", [_scale("x", "dead", 5.0), _scale("x", "o")], {"o"}),
    # elementwise + activation
    "elewise_add_act_backward_reader": (
        "elewise", [_add("x", "y", "add_out"), _relu("add_out", "r"),
                    _scale("add_out", "s")], {"r", "s"}),
    "elewise_reverse_blocked_by_update": (
        "elewise", [_relu("p0", "r"), _adam(0), _add("x", "r", "o")],
        {"o"}),
    "elewise_reverse_second_reader": (
        "elewise", [_relu("y", "r"), _scale("r", "s"), _add("x", "r", "o")],
        {"o", "s"}),
    "elewise_reverse": ("elewise", [_relu("y", "r"), _add("x", "r", "o")],
                        {"o"}),
    "elewise_scale_act": ("elewise", [_add("x", "y", "a"),
                                      _scale("a", "o", 0.5)], {"o"}),
    "elewise_scale_bias_stays": ("elewise", [_add("x", "y", "a"),
                                             _scale("a", "o", 0.5, 1.0)],
                                 {"o"}),
    # optimizer fusion
    "optfuse_groups_by_hyperparams": (
        "optfuse", [_adam(0), _adam(1), _adam(2, beta1=0.5),
                    _adam(3, beta1=0.5)], set()),
    "optfuse_per_param_lr": ("optfuse", [_adam(0, lr="lr0"),
                                         _adam(1, lr="lr1")], set()),
    "optfuse_skips_undeclared_slots": (
        "optfuse", [_adam(0, extra={"SkipUpdate": ["sk0"]}),
                    _adam(1, extra={"SkipUpdate": ["sk1"]})], set()),
    "optfuse_interference": (
        "optfuse", [_adam(0), _scale("p0", "x0"), _adam(1)], {"x0"}),
}

_LIST_FNS = {
    "cse": "cse_ops", "constant_fold": "constant_fold_ops",
    "dce": "dead_op_elimination", "elewise": "fuse_elewise_add_act_ops",
    "optfuse": "fuse_optimizer_ops",
}


@pytest.mark.parametrize("name", sorted(LIST_CASES))
def test_op_list_stage_matches_jax(name):
    stage, spec, needed = LIST_CASES[name]
    jops = _descs(spec, JOpDesc, JDataType)
    pops = _descs(spec, POpDesc, PDataType)
    fn = _LIST_FNS[stage]
    jout, jn = getattr(jpipe, fn)(list(jops), set(needed))
    pout, pn = getattr(ppipe, fn)(list(pops), set(needed))
    assert pn == jn
    assert_same_ops(jout, pout)
    # the caller's descs are never mutated
    assert [(o.type, o.inputs, o.outputs) for o in pops] == [
        (t, i, o) for t, i, o, _ in spec]


def test_fold_makes_a_literal():
    """The folded chain is one pt_const holding 6.0, run by the port's
    emitter on the run's device."""
    _, spec, needed = LIST_CASES["fold_const_chain"]
    ops, n = ppipe.constant_fold_ops(_descs(spec, POpDesc, PDataType),
                                     needed)
    assert n == 1
    const = [o for o in ops if o.type == "pt_const"][0]
    np.testing.assert_array_equal(const.attrs["value"], [6.0])
    ctx = pt.registry.EmitContext(__import__("torch").device("cpu"))
    out = pt.registry.lookup("pt_const").emitter(ctx, {}, const.attrs)
    assert out["Out"][0].tolist() == [6.0]


def test_optimizer_fusion_isolates_non_f32_params():
    spec = [_adam(i) for i in range(4)]
    f16 = lambda n: "float16" if n in ("p0", "g0", "p1", "g1") \
        else "float32"  # noqa: E731
    for var_dtype in (f16, lambda n: "float32"):
        jout, jn = jpipe.fuse_optimizer_ops(
            [JOpDesc(*s) for s in spec], set(), var_dtype=var_dtype)
        pout, pn = ppipe.fuse_optimizer_ops(
            [POpDesc(*s) for s in spec], set(), var_dtype=var_dtype)
        assert pn == jn
        assert_same_ops(jout, pout)


# ---------------------------------------------------------------------------
# the stages on the Transformer programs (both packages build them
# byte-identically)
# ---------------------------------------------------------------------------

def _build_both(attention_impl, **over):
    cfg = dict(TINY, **over)
    with junique.guard():
        j = jtransformer.build(dropout_rate=0.0, attention_impl=attention_impl,
                               **cfg)
    with punique.guard():
        p = ptransformer.build(attention_impl=attention_impl, **cfg)
    assert p["main"].desc.to_bytes() == j["main"].desc.to_bytes()
    return j, p


def _live(program, fetch):
    """The executor's live op list and the names its pipeline keeps."""
    block = program.global_block()
    ops = pt.executor._live_ops(
        [o for o in block.desc.ops if o.type not in ("feed", "fetch")],
        fetch, block)
    needed = set(fetch) | {n for o in ops for n in o.output_arg_names()
                           if pt.executor._is_persistable(block, n)}
    return ops, needed


@pytest.fixture(scope="module")
def transformers():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        return {impl: _build_both(impl, n_layer=2)
                for impl in ("fused", "unfused")}
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _stage(name):
    return {
        "fuse_attention": lambda mod, o, n, b: mod.fuse_attention_chain_ops(
            o, n, b),
        "constant_fold": lambda mod, o, n, b: mod.constant_fold_ops(o, n),
        "cse": lambda mod, o, n, b: mod.cse_ops(o, n),
        "fuse_elewise_add_act": lambda mod, o, n, b:
            mod.fuse_elewise_add_act_ops(o, n),
        "fuse_optimizer_ops": lambda mod, o, n, b: mod.fuse_optimizer_ops(
            o, n, mod.block_var_dtype(b)),
        "dead_op_elimination": lambda mod, o, n, b:
            mod.dead_op_elimination(o, n),
    }[name]


@pytest.mark.parametrize("impl", ["fused", "unfused"])
@pytest.mark.parametrize("stage", ["fuse_attention", "constant_fold", "cse",
                                   "fuse_elewise_add_act",
                                   "fuse_optimizer_ops",
                                   "dead_op_elimination"])
def test_stage_on_the_train_program_matches_jax(transformers, impl, stage):
    j, p = transformers[impl]
    jb, pb = j["main"].global_block(), p["main"].global_block()
    pops, needed = _live(p["main"], [p["loss"].name])
    names = [(o.type, o.inputs, o.outputs) for o in pops]
    jops = [jb.desc.ops[i] for i, o in enumerate(pb.desc.ops) if o in pops]
    assert [(o.type, o.inputs, o.outputs) for o in jops] == names
    fn = _stage(stage)
    jout, jn = fn(jpipe, list(jops), set(needed), jb)
    pout, pn = fn(ppipe, list(pops), set(needed), pb)
    assert pn == jn
    assert_same_ops(jout, pout)
    assert [(o.type, o.inputs, o.outputs) for o in pops] == names
    if stage == "fuse_attention" and impl == "unfused":
        types = [o.type for o in pout]
        # 2 layers: 2 encoder self, 2 decoder self, 2 cross
        assert types.count("flash_attention") == 6
        assert types.count("flash_attention_grad") == 6
        assert "softmax" not in types and pn > 0


FLAG_SETS = [("attnfuse",), ("slim",), ("elewise",), ("optfuse",),
             ("convfuse",),
             ("convfuse", "attnfuse", "slim", "elewise", "optfuse")]


@pytest.mark.parametrize("impl", ["fused", "unfused"])
@pytest.mark.parametrize("flags", FLAG_SETS, ids="+".join)
def test_run_pipeline_matches_jax(transformers, impl, flags):
    """run_pipeline in the JAX package's stage order (its nhwc stage,
    which the JAX executor always appends, changes nothing without conv
    ops and is left out on both sides)."""
    j, p = transformers[impl]
    jb, pb = j["main"].global_block(), p["main"].global_block()
    pops, needed = _live(p["main"], [p["loss"].name])
    jops = [jb.desc.ops[i] for i, o in enumerate(pb.desc.ops) if o in pops]
    stats = {}
    pout = ppipe.run_pipeline(pops, pb, set(needed), flags, stats)
    jout = jpipe.run_pipeline(jops, jb, set(needed), flags)
    assert_same_ops(jout, pout)
    assert "dead_op_elimination" in stats
    assert sum(r["ops_removed"] for r in stats.values()) == \
        len(pops) - len(pout)


def _mlp():
    """tests/test_build_strategy.py's MLP under Adam."""
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=16, act="relu")
    h2 = fluid.layers.fc(input=h, size=8, act="relu")
    pred = fluid.layers.fc(input=h2, size=1)
    loss = fluid.layers.reduce_mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return [loss.name]


def _raw_chain(causal=False, with_kb=False, pre_scale=False, dropout=None):
    """tests/test_attention_fusion.py's hand-built attention chain over
    data Q/K/V [B, 2, 8, 4], with its backward (SGD, whose update ops
    the pipeline's attention stage leaves alone)."""
    def build():
        t, d = 8, 4
        q = fluid.layers.data("q", shape=[2, t, d], dtype="float32")
        k = fluid.layers.data("k", shape=[2, t, d], dtype="float32")
        v = fluid.layers.data("v", shape=[2, t, d], dtype="float32")
        w = fluid.layers.create_parameter([d, d], "float32", name="qw")
        qh = fluid.layers.matmul(q, w)
        if pre_scale:
            qh = fluid.layers.scale(qh, scale=d ** -0.5)
            product = fluid.layers.matmul(qh, k, transpose_y=True)
        else:
            product = fluid.layers.matmul(qh, k, transpose_y=True,
                                          alpha=d ** -0.5)
        if with_kb:
            kb = fluid.layers.data("kb", shape=[t], dtype="float32")
            kb4 = fluid.layers.unsqueeze(fluid.layers.unsqueeze(
                kb, axes=[1]), axes=[1])
            product = fluid.layers.elementwise_add(product, kb4)
        if causal:
            tri = np.triu(np.full((t, t), -1e9, np.float32), k=1)
            product = fluid.layers.elementwise_add(
                product, fluid.layers.assign(tri))
        weights = fluid.layers.softmax(product)
        if dropout is not None:
            weights = fluid.layers.dropout(
                weights, dropout_prob=0.1, is_test=dropout == "is_test",
                dropout_implementation="upscale_in_train")
        loss = fluid.layers.reduce_mean(fluid.layers.matmul(weights, v))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss.name]
    return build


PROGRAM_CASES = {
    "mlp_adam": (_mlp, None),
    "chain": (_raw_chain(), 1),
    "chain_causal": (_raw_chain(causal=True), 1),
    "chain_key_bias": (_raw_chain(with_kb=True), 1),
    "chain_all_prescaled": (_raw_chain(True, True, True), 1),
    "chain_is_test_dropout": (_raw_chain(dropout="is_test"), 1),
    "chain_train_dropout": (_raw_chain(dropout="train"), 0),
}


@pytest.mark.parametrize("name", sorted(PROGRAM_CASES))
@pytest.mark.parametrize("flags", [("attnfuse",),
                                   ("attnfuse", "slim", "elewise",
                                    "optfuse")], ids="+".join)
def test_run_pipeline_on_small_programs_matches_jax(name, flags):
    build, n_flash = PROGRAM_CASES[name]
    jmain, fetch = _prog(build)
    pmain = to_port(jmain)
    pops, needed = _live(pmain, fetch)
    jops = [jmain.global_block().desc.ops[i]
            for i, o in enumerate(pmain.global_block().desc.ops) if o in pops]
    pout = ppipe.run_pipeline(pops, pmain.global_block(), set(needed), flags)
    jout = jpipe.run_pipeline(jops, jmain.global_block(), set(needed), flags)
    assert_same_ops(jout, pout)
    if n_flash is not None:
        types = [o.type for o in pout]
        assert types.count("flash_attention") == n_flash
        assert types.count("flash_attention_grad") == n_flash
        assert ("softmax" in types) == (n_flash == 0)


def test_effective_flags():
    full = ("convfuse", "attnfuse", "slim", "elewise", "optfuse")
    assert ppipe.effective_flags(full, "cuda") == full
    assert "optfuse" not in ppipe.effective_flags(full, "cpu")
    old = PFLAGS.fuse_optimizer_ops_on_cpu
    PFLAGS.fuse_optimizer_ops_on_cpu = True
    try:
        assert ppipe.effective_flags(full, "cpu") == full
    finally:
        PFLAGS.fuse_optimizer_ops_on_cpu = old
    bs = pt.BuildStrategy()
    assert ppipe.fingerprint(bs) == ()
    for k in ("fuse_conv_ops", "fuse_attention_ops", "memory_optimize",
              "fuse_elewise_add_act_ops", "fuse_all_optimizer_ops"):
        setattr(bs, k, True)
    assert ppipe.fingerprint(bs) == jpipe.fingerprint(bs) == full


def test_conv_stage_raises_on_a_conv_program():
    ops = [POpDesc("conv2d", {"Input": ["x"], "Filter": ["w"]},
                   {"Output": ["y"]}, {})]
    with pytest.raises(NotImplementedError, match="A5"):
        ppipe.run_pipeline(ops, pt.Program().global_block(), {"y"},
                           ("convfuse",))
    with pytest.raises(NotImplementedError, match="A5"):
        ppipe.run_pipeline([], pt.Program().global_block(), set(), ("nhwc",))


def test_registry_flags_the_passes_read_match_jax():
    """needs_rng, is_host and no_grad decide what CSE and DCE may merge
    or drop: every op the port registers carries the JAX package's
    values (flash_attention_grad, registered in the port for its custom
    emitter only, is opaque to the passes as in the JAX package)."""
    from paddle_tpu import registry as jreg
    for op_type in sorted(pt.registry._REGISTRY):
        p = pt.registry.lookup(op_type)
        if op_type in ppipe._OPAQUE_GRAD_TYPES:
            assert not jreg.has_op(op_type)
            assert not ppipe._deterministic(POpDesc(op_type))
            continue
        j = jreg.lookup(op_type)
        for flag in ("no_grad", "needs_rng", "is_host",
                     "intermediate_outputs"):
            assert getattr(p, flag) == getattr(j, flag), (op_type, flag)


# ---------------------------------------------------------------------------
# registry passes
# ---------------------------------------------------------------------------

def _prog(build):
    """A JAX-built main program (and its startup) from ``build(fluid)``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with junique.guard(), fluid.program_guard(main, startup):
        protected = build()
    return main, protected


def _fc_chain(n, act="relu"):
    def build():
        h = fluid.layers.data(name="x", shape=[6], dtype="float32")
        for _ in range(n):
            h = fluid.layers.fc(h, size=5, act=act)
        return [h.name]
    return build


def _identity_scale():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    s = fluid.layers.scale(x, scale=1.0, bias=0.0)
    return [fluid.layers.scale(s, scale=2.0).name]


def _add_relu():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[4], dtype="float32")
    return [fluid.layers.relu(fluid.layers.elementwise_add(x, y)).name]


def _relu_add():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[4], dtype="float32")
    return [fluid.layers.elementwise_add(x, fluid.layers.relu(y)).name]


def _dup_scales():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    a = fluid.layers.scale(x, scale=3.0)
    b = fluid.layers.scale(x, scale=3.0)
    return [fluid.layers.elementwise_add(a, b).name]


def _const_chain():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    c = fluid.layers.fill_constant([1], "float32", 3.0)
    c2 = fluid.layers.scale(c, scale=2.0)
    return [fluid.layers.elementwise_mul(x, c2, axis=0).name]


def _dead_scale():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    fluid.layers.scale(x, scale=5.0)
    return [fluid.layers.scale(x, scale=2.0).name]


def _dropout():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    d = fluid.layers.dropout(x, dropout_prob=0.5, is_test=False)
    return [fluid.layers.scale(d, scale=2.0).name]


def _with_feed_fetch():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    out = fluid.layers.scale(x, scale=2.0)
    blk = fluid.default_main_program().global_block().desc
    blk.ops.insert(0, JOpDesc("feed", {"X": ["feed"]}, {"Out": [x.name]},
                              {"col": 0}))
    blk.ops.append(JOpDesc("fetch", {"X": [out.name]}, {"Out": ["fetch"]},
                           {"col": 0}))
    from paddle_tpu.core.desc import VarDesc
    blk.vars["dangling"] = VarDesc("dangling", shape=[4])
    return [out.name]


PASS_CASES = {
    "fc_fuse": (_fc_chain(2), ["fc_fuse_pass"]),
    "repeated_fc_relu": (_fc_chain(3),
                         ["fc_fuse_pass", "repeated_fc_relu_fuse_pass"]),
    "repeated_fc_relu_one_pair": (_fc_chain(1),
                                  ["fc_fuse_pass",
                                   "repeated_fc_relu_fuse_pass"]),
    "identity_scale_clean": (_identity_scale,
                             ["identity_scale_op_clean_pass"]),
    "fuse_elewise_add_act": (_add_relu, ["fuse_elewise_add_act_pass"]),
    "fuse_elewise_act_add": (_relu_add, ["fuse_elewise_add_act_pass"]),
    "cse_pass": (_dup_scales, ["cse_pass"]),
    "constant_fold_and_dce": (_const_chain, ["constant_fold_pass",
                                             "dead_op_elimination_pass"]),
    "dead_op_elimination": (_dead_scale, ["dead_op_elimination_pass"]),
    "is_test": (_dropout, ["is_test_pass"]),
    "infer_clean_graph": (_with_feed_fetch, ["infer_clean_graph_pass"]),
}


@pytest.mark.parametrize("name", sorted(PASS_CASES))
def test_registry_pass_matches_jax(name):
    build, passes = PASS_CASES[name]
    jmain, protected = _prog(build)
    pmain = to_port(jmain)
    v0 = pmain._version
    jir.apply_passes(jmain, passes, protected=protected)
    pir.apply_passes(pmain, passes, protected=protected)
    assert_same_ops(_ops(jmain), _ops(pmain))
    assert sorted(pmain.global_block().desc.vars) == \
        sorted(jmain.global_block().desc.vars)
    assert [o.desc for o in pmain.global_block().ops] == _ops(pmain)
    assert pmain._version > v0


@pytest.mark.parametrize("impl", ["fused", "unfused"])
@pytest.mark.parametrize("passes", ["fuse_attention_pass",
                                    "fuse_optimizer_ops_pass"])
def test_op_list_registry_pass_on_the_train_program(transformers, impl,
                                                    passes):
    j, p = transformers[impl]
    jmain, pmain = j["main"].clone(), p["main"].clone()
    jir.apply_passes(jmain, [passes], protected=[j["loss"].name])
    pir.apply_passes(pmain, [passes], protected=[p["loss"].name])
    assert_same_ops(_ops(jmain), _ops(pmain))


@pytest.mark.parametrize("impl", ["fused", "unfused"])
def test_analysis_default_passes_on_the_inference_program(transformers,
                                                          impl):
    j, p = transformers[impl]
    jtest, ptest = j["test"].clone(), p["test"].clone()
    fetch = [p["logits"].name]
    jir.apply_passes(jtest, list(AnalysisConfig.DEFAULT_PASSES),
                     scope=fluid.Scope(), protected=fetch)
    pir.apply_passes(ptest, list(AnalysisConfig.DEFAULT_PASSES),
                     scope=pt.Scope(), protected=fetch)
    assert_same_ops(_ops(jtest), _ops(ptest))
    types = [o.type for o in _ops(ptest)]
    assert "mul" not in types or "fc" in types


# ---------------------------------------------------------------------------
# the guarded passes
# ---------------------------------------------------------------------------

GUARDED = sorted(n for n, cls in pir.PASS_REGISTRY.items()
                 if issubclass(cls, pir.passes._NotPortedPass))


def test_every_jax_pass_is_registered_in_the_port():
    assert sorted(pir.PASS_REGISTRY) == sorted(jir.PASS_REGISTRY)
    assert set(AnalysisConfig.DEFAULT_PASSES) <= set(pir.PASS_REGISTRY)
    assert len(GUARDED) == 16


@pytest.fixture(scope="module")
def inference_program():
    """The tiny Transformer's inference program (fused attention, as
    bench serving builds it), with its JAX scope."""
    old = JFLAGS.op_callstack
    JFLAGS.op_callstack = False
    try:
        with junique.guard():
            m = jtransformer.build(dropout_rate=0.0, **TINY)
    finally:
        JFLAGS.op_callstack = old
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(m["startup"])
    return m["test"], m["logits"].name, scope


@pytest.mark.parametrize("name", [n for n in GUARDED if n != "graph_viz_pass"])
def test_guarded_pass_leaves_the_transformer_unchanged(inference_program,
                                                       name):
    """The guard's claim, pinned against the JAX package: its own pass
    changes nothing in the Transformer inference program (the anchor ops
    are missing), and the port's guarded pass changes nothing either."""
    jprog, fetch, scope = inference_program
    jmain, pmain = jprog.clone(), to_port(jprog)
    before = [(o.type, o.inputs, o.outputs, dict(o.attrs))
              for o in _ops(jmain)]
    jir.apply_passes(jmain, [name], scope=scope, protected=[fetch])
    assert [(o.type, o.inputs, o.outputs, dict(o.attrs))
            for o in _ops(jmain)] == before
    pir.apply_passes(pmain, [name], scope=pt.Scope(), protected=[fetch])
    assert_same_ops(_ops(jmain), _ops(pmain))


@pytest.mark.parametrize("name", GUARDED)
def test_guarded_pass_raises_on_its_anchor_ops(name):
    """A graph holding one op type of each of the pattern's needs raises
    and names the ROADMAP item; the same graph short of one need is left
    alone."""
    cls = pir.PASS_REGISTRY[name]
    prog = pt.Program()
    blk = prog.global_block().desc
    blk.ops = [POpDesc(alts[0]) for alts in cls.needs]
    with pytest.raises(NotImplementedError, match=r"ROADMAP A(5|10|11)"):
        pir.apply_passes(prog, [name])
    if cls.needs:
        blk.ops = [POpDesc(alts[0]) for alts in cls.needs[1:]]
        pir.apply_passes(prog, [name])
        assert [o.type for o in prog.global_block().desc.ops] == [
            alts[0] for alts in cls.needs[1:]]
