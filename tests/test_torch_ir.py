"""The port's IR against the JAX package's: every ported pipeline stage and
registry pass rewrites the same program to the same op list.

Programs come from the JAX package's layers (the program shapes of
tests/test_ir_passes.py, tests/test_build_strategy.py and
tests/test_attention_fusion.py, restricted to ops the port has) and reach
the port through the byte codec, or are the Transformer programs both
packages build byte-identically. Op lists are compared op by op: type,
slot names, variable names and attrs (``pt_const`` values, which are
never serialized, with ``np.array_equal``).

The conv stages and passes run on the programs of tests/test_conv_fusion.py,
tests/test_ir_passes.py and tests/test_layout_pass.py and on resnet_cifar10;
the passes that fold values from the Scope (conv_bn_fuse,
conv_affine_channel_fuse) also leave the JAX package's folded tensors,
bit for bit.

The passes guarded once and ported since (seqconv_eltadd_relu, the RNN
and sequence fusions, and graph_viz) leave the Transformer inference
program unchanged, as the JAX package's do, and do with the guard's
anchor-op graph what the JAX package's do (graph_viz writes the same
.dot file, byte for byte).
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


def _act(kind, x, out):
    return (kind, {"X": [x]}, {"Out": [out]}, {})


def _sgd(i, lr="lr"):
    return ("sgd", {"Param": [f"p{i}"], "Grad": [f"g{i}"],
                    "LearningRate": [lr]}, {"ParamOut": [f"p{i}"]}, {})


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
    "fold_through_new_ops": (
        "constant_fold", [_fill("c", 4.0), _act("sqrt", "c", "c2"),
                          _act("tanh", "c2", "c3"), _fill("d", 0.5),
                          ("elementwise_max", {"X": ["c3"], "Y": ["d"]},
                           {"Out": ["c4"]}, {"axis": -1}),
                          _add("x", "c4", "o")], {"o"}),
    "cse_new_ops": ("cse", [_act("gelu", "x", "a"), _act("gelu", "x", "b"),
                            _act("sqrt", "a", "c"), _act("sqrt", "b", "d"),
                            _add("c", "d", "o")], {"o"}),
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
    "elewise_add_tanh": ("elewise", [_add("x", "y", "a"),
                                     _act("tanh", "a", "o")], {"o"}),
    "elewise_reverse_sigmoid": ("elewise", [_act("sigmoid", "y", "r"),
                                            _add("x", "r", "o")], {"o"}),
    "elewise_gelu_stays": ("elewise", [_add("x", "y", "a"),
                                       _act("gelu", "a", "o")], {"o"}),
    "elewise_scale_act": ("elewise", [_add("x", "y", "a"),
                                      _scale("a", "o", 0.5)], {"o"}),
    "elewise_scale_bias_stays": ("elewise", [_add("x", "y", "a"),
                                             _scale("a", "o", 0.5, 1.0)],
                                 {"o"}),
    # optimizer fusion
    "optfuse_groups_by_hyperparams": (
        "optfuse", [_adam(0), _adam(1), _adam(2, beta1=0.5),
                    _adam(3, beta1=0.5)], set()),
    "optfuse_sgd": ("optfuse", [_sgd(0), _sgd(1), _sgd(2, lr="lr2")],
                    set()),
    "optfuse_sgd_beside_adam": ("optfuse", [_sgd(0), _adam(1), _sgd(2),
                                            _adam(3)], set()),
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


BERT_TINY = dict(vocab_size=100, max_len=16, max_masked=4, n_layer=2,
                 n_head=2, d_model=32, d_inner_hid=64)


def _bert_recipe(mod, model):
    """tests/test_torch_bert.py's LAMB recipe: a global-norm clip and a
    warmup of a polynomial decay."""
    m = model.build(is_train=False, **BERT_TINY)
    with mod.program_guard(m["main"], m["startup"]):
        sched = mod.layers.learning_rate_scheduler
        lr = sched.linear_lr_warmup(
            sched.polynomial_decay(1e-3, 10, 1e-5), 3, 0.0, 1e-3)
        mod.clip.set_gradient_clip(mod.clip.GradientClipByGlobalNorm(1.0))
        mod.optimizer.LambOptimizer(learning_rate=lr).minimize(m["loss"])
    return m


@pytest.fixture(scope="module")
def berts():
    """BERT tiny, fused and unfused attention, and the LAMB recipe, built
    byte-identically by both packages."""
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as pbert
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        out = {}
        for name in ("fused", "unfused", "recipe"):
            with junique.guard():
                j = (_bert_recipe(fluid, jbert) if name == "recipe" else
                     jbert.build(attention_impl=name, **BERT_TINY))
            with punique.guard():
                p = (_bert_recipe(pt, pbert) if name == "recipe" else
                     pbert.build(attention_impl=name, **BERT_TINY))
            assert p["main"].desc.to_bytes() == j["main"].desc.to_bytes()
            out[name] = (j, p)
        return out
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old


@pytest.mark.parametrize("impl", ["fused", "unfused", "recipe"])
@pytest.mark.parametrize("stage", ["fuse_attention", "constant_fold", "cse",
                                   "fuse_elewise_add_act",
                                   "fuse_optimizer_ops",
                                   "dead_op_elimination"])
def test_stage_on_the_bert_program_matches_jax(berts, impl, stage):
    """Every stage on BERT's train program (gather, slice, gelu, tanh,
    the tied embedding's grad sum; LAMB, the clip's sqrt and max and the
    schedule's compares in the recipe) gives the JAX op list."""
    j, p = berts[impl]
    jb, pb = j["main"].global_block(), p["main"].global_block()
    pops, needed = _live(p["main"], [p["loss"].name])
    jops = [jb.desc.ops[i] for i, o in enumerate(pb.desc.ops) if o in pops]
    fn = _stage(stage)
    jout, jn = fn(jpipe, list(jops), set(needed), jb)
    pout, pn = fn(ppipe, list(pops), set(needed), pb)
    assert pn == jn
    assert_same_ops(jout, pout)
    if stage == "fuse_attention" and impl == "unfused":
        types = [o.type for o in pout]
        assert types.count("flash_attention") == BERT_TINY["n_layer"]
        assert "softmax" not in types


@pytest.mark.parametrize("impl", ["fused", "unfused", "recipe"])
@pytest.mark.parametrize("flags", FLAG_SETS, ids="+".join)
def test_run_pipeline_on_bert_matches_jax(berts, impl, flags):
    j, p = berts[impl]
    jb, pb = j["main"].global_block(), p["main"].global_block()
    pops, needed = _live(p["main"], [p["loss"].name])
    jops = [jb.desc.ops[i] for i, o in enumerate(pb.desc.ops) if o in pops]
    pout = ppipe.run_pipeline(pops, pb, set(needed), flags)
    jout = jpipe.run_pipeline(jops, jb, set(needed), flags)
    assert_same_ops(jout, pout)
    if "optfuse" in flags and impl != "recipe":
        assert "fused_adam" in [o.type for o in pout]


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


def test_effective_flags_nhwc_only_when_set():
    """The port leaves NCHW by default (the JAX package's default of
    NHWC rests on a TPU measurement); the flag appends the stage."""
    assert "nhwc" not in ppipe.effective_flags(("slim",), "cuda")
    old = PFLAGS.conv_layout_nhwc
    PFLAGS.conv_layout_nhwc = True
    try:
        assert ppipe.effective_flags(("slim",), "cuda") == ("slim", "nhwc")
        assert ppipe.effective_flags((), "cpu") == ("nhwc",)
    finally:
        PFLAGS.conv_layout_nhwc = old


def test_registry_flags_the_passes_read_match_jax():
    """needs_rng, is_host and no_grad decide what CSE and DCE may merge
    or drop: every op the port registers carries the JAX package's
    values. Exempt: flash_attention_grad, conv2d_grad and
    depthwise_conv2d_grad, which the port registers only for their
    custom emitters (the grad ops' descs are the JAX grad makers'); the
    JAX package does not register them, so its passes treat them as
    opaque, and the port's do too (``_OPAQUE_GRAD_TYPES``)."""
    assert set(ppipe._OPAQUE_GRAD_TYPES) == {
        "flash_attention_grad", "conv2d_grad", "depthwise_conv2d_grad"}
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


# conditional control flow, the sequence ops and CTC: 13 + 1 + 18 + 3 + 1
NEW_CONTROL_SEQUENCE_CTC = (
    "conditional_block", "if_else", "switch_merge", "write_to_array",
    "read_from_array", "lod_array_length", "tensor_array_to_tensor",
    "max_sequence_len", "lod_tensor_to_array", "array_to_lod_tensor",
    "shrink_rnn_memory", "split_lod_tensor", "merge_lod_tensor",
    "is_empty",
    "sequence_expand", "sequence_reverse", "sequence_concat",
    "sequence_slice", "sequence_conv", "row_conv", "sequence_pad",
    "sequence_unpad", "sequence_expand_as", "sequence_reshape",
    "sequence_scatter", "sequence_enumerate", "sequence_erase",
    "add_position_encoding", "im2sequence", "lod_reset", "lod_rank_table",
    "reorder_lod_tensor_by_rank",
    "warpctc", "ctc_align", "edit_distance",
    "fusion_seqconv_eltadd_relu")


def test_registry_counts():
    """The port's op types: 328 of the JAX package's, plus its 3 grad types
    of its own (``_OPAQUE_GRAD_TYPES``), and every one has an emitter.
    Recurrent training and structured prediction added ``recurrent``'s
    emitter and ``while_grad``, ``linear_chain_crf``, ``crf_decoding`` and
    ``chunk_eval``; the model zoo ``auc``, ``log_loss``, ``cos_sim``,
    ``lstm`` and the four fused ops of the RNN and sequence passes;
    conditional control flow, the sequence ops and CTC the 36 types of
    ``NEW_CONTROL_SEQUENCE_CTC``; object detection the 33 types of
    ``NEW_DETECTION``; the general tensor, loss and RNN-unit ops the 35
    types of ``NEW_TENSOR_LOSS_RNN``; the image and NN op families the 36
    types of ``NEW_IMAGE_NN``; quantization the 8 of ``NEW_QUANT`` and the
    single-device rest of the registry the 18 of ``NEW_REST``."""
    from paddle_tpu import registry as jreg
    from test_torch_detection import NEW_DETECTION
    from test_torch_host_ops import NEW_REST
    from test_torch_quantize import NEW_QUANT
    from test_torch_tensor_ops import NEW_TENSOR_LOSS_RNN
    from test_torch_vision_ops import NEW_IMAGE_NN
    reg = pt.registry._REGISTRY
    assert len(NEW_CONTROL_SEQUENCE_CTC) == 36
    assert len(NEW_DETECTION) == 33
    assert len(NEW_TENSOR_LOSS_RNN) == 35
    assert len(NEW_IMAGE_NN) == 36
    assert len(NEW_QUANT) == 8 and len(NEW_REST) == 18
    assert len(reg) == 331
    assert sum(jreg.has_op(t) for t in reg) == 328
    assert sorted(t for t, i in reg.items() if i.emitter is None) == []
    for op_type in ("while", "while_grad", "recurrent", "array_write",
                    "array_read", "beam_search",
                    "beam_search_decode", "gru", "sequence_pool",
                    "sequence_softmax", "expand", "split",
                    "fill_constant_batch_size_like", "dropout",
                    "dropout_grad", "square_error_cost", "create_py_reader",
                    "read", "auc", "log_loss", "cos_sim", "lstm",
                    "fusion_lstm", "fusion_gru", "fusion_seqpool_concat",
                    "fused_embedding_fc_lstm", "linear_chain_crf",
                    "crf_decoding", "chunk_eval") + NEW_CONTROL_SEQUENCE_CTC \
            + NEW_DETECTION + NEW_TENSOR_LOSS_RNN + NEW_IMAGE_NN + NEW_QUANT \
            + NEW_REST:
        assert reg[op_type].emitter is not None, op_type
        assert jreg.has_op(op_type), op_type


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


def _fm(scale=0.5, bias=0.0):
    """The FM second-order trick squared_mat_sub_fuse_pass matches
    (tests/test_ir_passes.py), with or without its trailing scale (a
    scale with a bias is not taken into the fused op)."""
    def build():
        x = fluid.layers.data(name="x", shape=[3, 4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[4, 5], dtype="float32")
        xy = fluid.layers.matmul(x, y)
        x2y2 = fluid.layers.matmul(fluid.layers.square(x),
                                   fluid.layers.square(y))
        out = fluid.layers.elementwise_sub(fluid.layers.square(xy), x2y2)
        if scale is not None:
            out = fluid.layers.scale(out, scale=scale, bias=bias)
        return [out.name]
    return build


def _squared_mat_sub_probe():
    """ROADMAP C1's probe: matmul, square and elementwise_sub that do not
    form the FM pattern; the pass must leave it as it is."""
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    w = fluid.layers.create_parameter([4, 4], "float32", name="probe_w")
    xw = fluid.layers.matmul(x, w)
    return [fluid.layers.elementwise_sub(fluid.layers.square(xw), xw).name]


def _transpose_flatten_concat(flat=True, same_axes=True):
    """The detection heads' pattern transpose_flatten_concat_fuse_pass
    matches: two transpose2 -> [-1, k] reshape2 chains into one concat;
    a reshape that is not a flatten, or transposes of different axes, are
    left alone."""
    def build():
        L = fluid.layers
        outs = []
        for i, shape in enumerate(([4, 3, 5], [2, 3, 5])):
            x = L.data(name=f"x{i}", shape=shape, dtype="float32")
            axis = [0, 2, 3, 1] if same_axes or i == 0 else [0, 3, 2, 1]
            t = L.transpose(x, axis)
            k = shape[0] * shape[1] * shape[2]
            outs.append(L.reshape(t, [-1, k] if flat else [-1, 15, shape[0]]))
        return [L.concat(outs, axis=1).name]
    return build


def _seqconv(act="relu", length=True, bias=True):
    """tests/test_ir_passes.py's shape for seqconv_eltadd_relu_fuse_pass:
    a sequence_conv layer (its bias an elementwise_add of a parameter),
    with or without Length; another activation, or no bias, is not the
    pattern."""
    def build():
        L = fluid.layers
        x = L.data(name="x", shape=[6, 4], dtype="float32")
        ln = L.data(name="len", shape=[], dtype="int64") if length else None
        c = L.sequence_conv(x, num_filters=3, filter_size=3, act=act,
                            length=ln, bias_attr=None if bias else False)
        return [c.name]
    return build


PASS_CASES = {
    "seqconv_eltadd_relu": (_seqconv(), ["seqconv_eltadd_relu_fuse_pass"]),
    "seqconv_eltadd_relu_no_length": (_seqconv(length=False),
                                      ["seqconv_eltadd_relu_fuse_pass"]),
    "seqconv_eltadd_tanh_stays": (_seqconv(act="tanh"),
                                  ["seqconv_eltadd_relu_fuse_pass"]),
    "seqconv_relu_no_bias_stays": (_seqconv(bias=False),
                                   ["seqconv_eltadd_relu_fuse_pass"]),
    "transpose_flatten_concat": (_transpose_flatten_concat(),
                                 ["transpose_flatten_concat_fuse_pass"]),
    "transpose_flatten_concat_not_flat": (
        _transpose_flatten_concat(flat=False),
        ["transpose_flatten_concat_fuse_pass"]),
    "transpose_flatten_concat_mixed_axes": (
        _transpose_flatten_concat(same_axes=False),
        ["transpose_flatten_concat_fuse_pass"]),
    "squared_mat_sub_fm_scaled": (_fm(), ["squared_mat_sub_fuse_pass"]),
    "squared_mat_sub_fm_unscaled": (_fm(None),
                                    ["squared_mat_sub_fuse_pass"]),
    "squared_mat_sub_fm_biased_scale": (_fm(0.5, 1.0),
                                        ["squared_mat_sub_fuse_pass"]),
    "squared_mat_sub_probe_stays": (_squared_mat_sub_probe,
                                    ["squared_mat_sub_fuse_pass"]),
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
    types = [o.type for o in _ops(pmain)]
    assert types == {
        "seqconv_eltadd_relu": ["fusion_seqconv_eltadd_relu"],
        "seqconv_eltadd_relu_no_length": ["fusion_seqconv_eltadd_relu"],
        "seqconv_eltadd_tanh_stays": ["sequence_conv", "elementwise_add",
                                      "tanh"],
        "seqconv_relu_no_bias_stays": ["sequence_conv", "relu"],
        "squared_mat_sub_fm_scaled": ["fusion_squared_mat_sub"],
        "squared_mat_sub_fm_unscaled": ["fusion_squared_mat_sub"],
        "squared_mat_sub_fm_biased_scale": ["fusion_squared_mat_sub",
                                            "scale"],
        "squared_mat_sub_probe_stays": ["matmul", "square",
                                        "elementwise_sub"],
        "transpose_flatten_concat": ["fusion_transpose_flatten_concat"],
        "transpose_flatten_concat_not_flat": [
            "transpose2", "reshape2", "transpose2", "reshape2", "concat"],
        "transpose_flatten_concat_mixed_axes": [
            "transpose2", "reshape2", "transpose2", "reshape2", "concat"],
    }.get(name, types)


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


# the text CNN's op types after AnalysisConfig's default passes (the
# literal chip_smoke.py's phase 19(E) holds the card's pipeline against)
TEXT_CNN_ANALYSIS_TYPES = [
    "lookup_table", "fusion_seqconv_eltadd_relu", "sequence_pool",
    "fusion_seqconv_eltadd_relu", "sequence_pool", "mul", "mul", "sum",
    "elementwise_add", "softmax"]


def test_analysis_default_passes_on_the_text_cnn():
    """testing.models.text_cnn's inference program through AnalysisConfig's
    default passes: both sequence_conv branches fused, the op list the JAX
    package's."""
    from paddle_tpu_torch.testing import models as tmodels
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        with junique.guard():
            j = tmodels.text_cnn(fluid)
        with punique.guard():
            p = tmodels.text_cnn(pt)
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old
    assert p["main"].desc.to_bytes() == j["main"].desc.to_bytes()
    jmain, pmain = j["main"].clone(), p["main"].clone()
    fetch = [p["predict"].name]
    jir.apply_passes(jmain, list(AnalysisConfig.DEFAULT_PASSES),
                     scope=fluid.Scope(), protected=fetch)
    pir.apply_passes(pmain, list(AnalysisConfig.DEFAULT_PASSES),
                     scope=pt.Scope(), protected=fetch)
    assert_same_ops(_ops(jmain), _ops(pmain))
    assert [o.type for o in _ops(pmain)] == TEXT_CNN_ANALYSIS_TYPES


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
# the guarded passes, and the RNN and sequence fusions ported since
# ---------------------------------------------------------------------------

# every pass of the JAX package is ported: none is guarded any more
GUARDED = sorted(n for n, cls in pir.PASS_REGISTRY.items()
                 if cls.__name__.startswith("NotPorted"))
# the passes guarded before the RNN and sequence fusions were ported;
# each keeps its checks: a guard raises on its anchor ops, a ported pass
# does what the JAX package's does on that graph
ONCE_GUARDED = {
    "embedding_fc_lstm_fuse_pass": (("lookup_table",), ("mul",), ("lstm",)),
    "fc_gru_fuse_pass": (("mul",), ("gru",)),
    "fc_lstm_fuse_pass": (("mul",), ("lstm",)),
    "graph_viz_pass": (),
    "seqconv_eltadd_relu_fuse_pass": (("sequence_conv",),
                                      ("elementwise_add",), ("relu",)),
    "seqpool_concat_fuse_pass": (("sequence_pool",), ("concat",)),
}


def test_every_jax_pass_is_registered_in_the_port():
    assert sorted(pir.PASS_REGISTRY) == sorted(jir.PASS_REGISTRY)
    assert set(AnalysisConfig.DEFAULT_PASSES) <= set(pir.PASS_REGISTRY)
    # squared_mat_sub_fuse_pass (ROADMAP C1),
    # transpose_flatten_concat_fuse_pass (with concat), the RNN and
    # sequence fusions, seqconv_eltadd_relu (with sequence_conv) and
    # graph_viz are ported
    assert len(pir.PASS_REGISTRY) == 27
    assert GUARDED == []
    assert set(GUARDED) <= set(ONCE_GUARDED)
    for name in ("squared_mat_sub_fuse_pass",
                 "transpose_flatten_concat_fuse_pass",
                 "embedding_fc_lstm_fuse_pass", "fc_gru_fuse_pass",
                 "fc_lstm_fuse_pass", "seqpool_concat_fuse_pass",
                 "seqconv_eltadd_relu_fuse_pass"):
        assert name not in GUARDED


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


@pytest.mark.parametrize("name", sorted(n for n in ONCE_GUARDED
                                        if n != "graph_viz_pass"))
def test_guarded_pass_leaves_the_transformer_unchanged(inference_program,
                                                       name):
    """The guard's claim, pinned against the JAX package: its own pass
    changes nothing in the Transformer inference program (the anchor ops
    are missing), and the port's pass, guarded or ported, changes nothing
    either."""
    jprog, fetch, scope = inference_program
    jmain, pmain = jprog.clone(), to_port(jprog)
    before = [(o.type, o.inputs, o.outputs, dict(o.attrs))
              for o in _ops(jmain)]
    jir.apply_passes(jmain, [name], scope=scope, protected=[fetch])
    assert [(o.type, o.inputs, o.outputs, dict(o.attrs))
            for o in _ops(jmain)] == before
    pir.apply_passes(pmain, [name], scope=pt.Scope(), protected=[fetch])
    assert_same_ops(_ops(jmain), _ops(pmain))


@pytest.mark.parametrize("name", sorted(ONCE_GUARDED))
def test_guarded_pass_raises_on_its_anchor_ops(name, tmp_path, monkeypatch):
    """A guarded pass: a graph holding one op type of each of the
    pattern's needs raises and names the ROADMAP item; the same graph
    short of one need is left alone. A pass ported since does with that
    graph what the JAX package's pass does (its anchor ops have no
    inputs, so neither matches)."""
    needs = ONCE_GUARDED[name]
    if name not in GUARDED:
        jprog = fluid.Program()
        jprog.global_block().desc.ops = [JOpDesc(alts[0]) for alts in needs]
        if name == "graph_viz_pass":
            # a graph with ops, so the dump has edges to compare
            jprog = fluid.Program()
            with fluid.program_guard(jprog, fluid.Program()):
                _conv_train()()
        pprog = to_port(jprog)
        # graph_viz writes program.dot into the working directory
        for side in ("j", "p"):
            (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / "j")
        jir.apply_passes(jprog, [name], scope=fluid.Scope())
        monkeypatch.chdir(tmp_path / "p")
        pir.apply_passes(pprog, [name], scope=pt.Scope())
        assert_same_ops(_ops(jprog), _ops(pprog))
        if name == "graph_viz_pass":
            dot = (tmp_path / "p" / "program.dot").read_bytes()
            assert dot == (tmp_path / "j" / "program.dot").read_bytes()
            assert dot.startswith(b"digraph program {") and b"->" in dot
            return
        assert [o.type for o in _ops(pprog)] == [alts[0] for alts in needs]
        return
    cls = pir.PASS_REGISTRY[name]
    assert cls.needs == needs
    prog = pt.Program()
    blk = prog.global_block().desc
    blk.ops = [POpDesc(alts[0]) for alts in cls.needs]
    with pytest.raises(NotImplementedError, match=r"ROADMAP A(10|11)"):
        pir.apply_passes(prog, [name])
    if cls.needs:
        blk.ops = [POpDesc(alts[0]) for alts in cls.needs[1:]]
        pir.apply_passes(prog, [name])
        assert [o.type for o in prog.global_block().desc.ops] == [
            alts[0] for alts in cls.needs[1:]]


# ---------------------------------------------------------------------------
# the conv stages and passes (programs of tests/test_conv_fusion.py,
# tests/test_ir_passes.py and tests/test_layout_pass.py, and ResNet)
# ---------------------------------------------------------------------------

def _conv_train(opt="momentum", bias=True):
    """tests/test_conv_fusion.py's conv net: conv + bias + relu twice,
    global pooling, fc, square error, with its backward."""
    def build():
        x = fluid.layers.data(name="x", shape=[3, 8, 8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = x
        for _ in range(2):
            h = fluid.layers.conv2d(h, num_filters=8, filter_size=3,
                                    padding=1, act="relu",
                                    bias_attr=None if bias else False)
        p = fluid.layers.pool2d(h, pool_size=8, pool_type="avg",
                                global_pooling=True)
        loss = fluid.layers.reduce_mean(fluid.layers.square_error_cost(
            fluid.layers.fc(p, size=1), y))
        if opt == "adam":
            fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        else:
            fluid.optimizer.Momentum(learning_rate=1e-2,
                                     momentum=0.9).minimize(loss)
        return [loss.name]
    return build


def _infer_conv_bn(with_bias, act):
    """tests/test_conv_fusion.py's inference conv [+ bias] + bn [+ relu]
    (and tests/test_ir_passes.py's conv_bn_fuse program)."""
    def build():
        x = fluid.layers.data(name="x", shape=[3, 8, 8], dtype="float32")
        c = fluid.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                                bias_attr=None if with_bias else False)
        b = fluid.layers.batch_norm(c, act=act, is_test=True)
        return [fluid.layers.reduce_mean(b).name]
    return build


def _small_conv_net(train=True):
    """tests/test_layout_pass.py's conv/bn/residual/pool net (its SGD
    replaced by momentum, which the port has)."""
    def build():
        from paddle_tpu import layers
        x = layers.data("img", shape=[8, 16, 16], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        b1 = layers.batch_norm(layers.conv2d(x, num_filters=12, filter_size=3,
                                             padding=1), act="relu")
        b2 = layers.batch_norm(layers.conv2d(b1, num_filters=12,
                                             filter_size=3, padding=1))
        res = layers.elementwise_add(b1, b2, act="relu")
        p = layers.pool2d(res, pool_size=2, pool_type="avg", pool_stride=2)
        loss = layers.reduce_mean(layers.square_error_cost(
            layers.fc(p, size=1), y))
        if train:
            fluid.optimizer.Momentum(learning_rate=0.005,
                                     momentum=0.9).minimize(loss)
        return [loss.name]
    return build


def _resnet_cifar(train=True):
    """resnet_cifar10's train or test program: (main, startup, fetch)."""
    def build():
        from paddle_tpu.models import resnet
        with junique.guard():
            m = resnet.build(dataset="cifar10")
        return (m["main"] if train else m["test"]), m["startup"], [
            m["loss"].name]
    build.whole_program = True
    return build


def _conv_prog(build):
    """(main, startup, fetch) of a program builder."""
    if getattr(build, "whole_program", False):
        return build()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with junique.guard(), fluid.program_guard(main, startup):
        fetch = build()
    return main, startup, fetch


def _conv_depthwise_relu():
    """tests/test_ir_passes.py's relu -> depthwise conv."""
    x = fluid.layers.data(name="img", shape=[4, 8, 8], dtype="float32")
    out = fluid.layers.conv2d(fluid.layers.relu(x), num_filters=4,
                              filter_size=3, padding=1, groups=4,
                              bias_attr=False)
    return [out.name]


def _conv_bias_act():
    x = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    c = fluid.layers.conv2d(x, num_filters=4, filter_size=3, padding=1)
    return [fluid.layers.relu(c).name]


def _conv_bias():
    x = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    return [fluid.layers.conv2d(x, num_filters=4, filter_size=3,
                                padding=1).name]


def _conv_bias_residual_act():
    x = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    res = fluid.layers.data(name="res", shape=[4, 8, 8], dtype="float32")
    c = fluid.layers.conv2d(x, num_filters=4, filter_size=3, padding=1)
    return [fluid.layers.relu(fluid.layers.elementwise_add(c, res)).name]


def _conv_affine_channel():
    x = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    c = fluid.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                            bias_attr=False)
    scale = fluid.layers.create_parameter([4], "float32", name="ac_scale")
    bias = fluid.layers.create_parameter([4], "float32", name="ac_bias",
                                         is_bias=True)
    return [fluid.layers.affine_channel(c, scale=scale, bias=bias).name]


CONV_PROGRAMS = {
    "train_momentum": _conv_train(),
    "train_adam": _conv_train("adam"),
    "train_no_bias": _conv_train(bias=False),
    "infer_bn_bias_relu": _infer_conv_bn(True, "relu"),
    "infer_bn_relu": _infer_conv_bn(False, "relu"),
    "infer_bn_bias": _infer_conv_bn(True, None),
    "layout_net_train": _small_conv_net(),
    "layout_net_infer": _small_conv_net(train=False),
    "resnet_cifar10_train": _resnet_cifar(),
    "resnet_cifar10_test": _resnet_cifar(train=False),
}


@pytest.fixture(scope="module")
def conv_programs():
    old = JFLAGS.op_callstack
    JFLAGS.op_callstack = False
    try:
        return {name: _conv_prog(build)[::2]
                for name, build in CONV_PROGRAMS.items()}
    finally:
        JFLAGS.op_callstack = old


def _conv_stage(name):
    return {
        "fuse_conv_bn": lambda mod, o, n, b: mod.fuse_conv_bn_ops(o, n, b),
        "fuse_conv_epilogue": lambda mod, o, n, b:
            mod.fuse_conv_epilogue_ops(o, n, b),
        "conv_layout_nhwc": lambda mod, o, n, b:
            mod.conv_layout_nhwc_ops(o, n, b),
    }[name]


def _both_live(jmain, fetch):
    pmain = to_port(jmain)
    pops, needed = _live(pmain, fetch)
    jops = [jmain.global_block().desc.ops[i]
            for i, o in enumerate(pmain.global_block().desc.ops)
            if o in pops]
    return jops, pops, needed, pmain


@pytest.mark.parametrize("stage", ["fuse_conv_bn", "fuse_conv_epilogue",
                                   "conv_layout_nhwc"])
@pytest.mark.parametrize("name", sorted(CONV_PROGRAMS))
def test_conv_stage_matches_jax(conv_programs, name, stage):
    jmain, fetch = conv_programs[name]
    jops, pops, needed, pmain = _both_live(jmain, fetch)
    fn = _conv_stage(stage)
    jout, jn = fn(jpipe, list(jops), set(needed), jmain.global_block())
    pout, pn = fn(ppipe, list(pops), set(needed), pmain.global_block())
    assert pn == jn
    assert_same_ops(jout, pout)
    types = [o.type for o in pout]
    if stage == "fuse_conv_epilogue" and name in ("train_momentum",
                                                  "train_adam"):
        assert types.count("fused_conv2d") == 2
        assert types.count("fused_conv2d_grad") == 2
    if stage == "fuse_conv_bn" and name.startswith("infer_bn"):
        assert "batch_norm" not in types
    if stage == "conv_layout_nhwc" and name == "resnet_cifar10_train":
        assert pn > 0 and "conv2d_grad" in types


@pytest.mark.parametrize("flags", [("convfuse",), ("nhwc",),
                                   ("convfuse", "slim", "elewise",
                                    "optfuse"),
                                   ("convfuse", "slim", "nhwc", "elewise",
                                    "optfuse")], ids="+".join)
@pytest.mark.parametrize("name", sorted(CONV_PROGRAMS))
def test_run_pipeline_on_conv_programs_matches_jax(conv_programs, name,
                                                   flags):
    jmain, fetch = conv_programs[name]
    jops, pops, needed, pmain = _both_live(jmain, fetch)
    stats = {}
    pout = ppipe.run_pipeline(pops, pmain.global_block(), set(needed), flags,
                              stats)
    jout = jpipe.run_pipeline(jops, jmain.global_block(), set(needed), flags)
    assert_same_ops(jout, pout)
    if "convfuse" in flags:
        assert {"fuse_conv_bn", "fuse_conv_epilogue"} <= set(stats)


def _scope_pair(jmain, startup_of):
    """The JAX startup run into a scope, and a port scope with the same
    values (random BN statistics so the fold bites)."""
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        fluid.Executor(fluid.CPUPlace()).run(startup_of)
    rng = np.random.RandomState(3)
    for op in jmain.global_block().desc.ops:
        if op.type == "batch_norm":
            for slot, shift in (("Mean", 0.0), ("Variance", 0.5)):
                n = op.input(slot)[0]
                jscope.set_var(n, (rng.rand(*np.shape(jscope.find_var(n)))
                                   + shift).astype("float32"))
    for n in ("ac_scale", "ac_bias"):
        if jscope.find_var(n) is not None:
            jscope.set_var(n, (rng.rand(4) + 0.5).astype("float32"))
    pscope = pt.Scope()
    for n in jscope.var_names():
        v = jscope.find_var(n)
        if v is not None:
            pscope.set_var(n, __import__("torch").from_numpy(
                np.array(v)))
    return jscope, pscope


CONV_PASS_CASES = {
    "conv_bn_fuse_bias": (_infer_conv_bn(True, "relu"),
                          ["conv_bn_fuse_pass"]),
    "conv_bn_fuse_no_bias": (_infer_conv_bn(False, None),
                             ["conv_bn_fuse_pass"]),
    "conv_bn_fuse_train_mode_stays": (_small_conv_net(train=False),
                                      ["conv_bn_fuse_pass"]),
    "conv_elementwise_add_act": (_conv_bias_act,
                                 ["conv_elementwise_add_act_fuse_pass"]),
    "conv_elementwise_add": (_conv_bias, ["conv_elementwise_add_fuse_pass"]),
    "conv_elementwise_add2_act": (_conv_bias_residual_act,
                                  ["conv_elementwise_add2_act_fuse_pass"]),
    "conv_affine_channel": (_conv_affine_channel,
                            ["conv_affine_channel_fuse_pass"]),
    "fuse_relu_depthwise_conv": (_conv_depthwise_relu,
                                 ["fuse_relu_depthwise_conv_pass"]),
    "fuse_conv_epilogue_train": (_conv_train(),
                                 ["fuse_conv_epilogue_pass"]),
    "fuse_conv_epilogue_infer": (_infer_conv_bn(True, "relu"),
                                 ["fuse_conv_epilogue_pass"]),
    "conv_layout_nhwc": (_small_conv_net(train=False),
                         ["conv_layout_nhwc_pass"]),
    "analysis_default_on_resnet": (
        _resnet_cifar(train=False), list(AnalysisConfig.DEFAULT_PASSES)),
}


@pytest.mark.parametrize("name", sorted(CONV_PASS_CASES))
def test_conv_registry_pass_matches_jax(name):
    """The op list, the var descs and, for the passes that fold values
    (conv_bn_fuse, conv_affine_channel_fuse), every scope tensor: the
    JAX package's, bit for bit (both fold in numpy from the same
    float32 values)."""
    build, passes = CONV_PASS_CASES[name]
    jmain, jstartup, protected = _conv_prog(build)
    pmain = to_port(jmain)
    jscope, pscope = _scope_pair(jmain, jstartup)
    jir.apply_passes(jmain, passes, scope=jscope, protected=protected)
    pir.apply_passes(pmain, passes, scope=pscope, protected=protected)
    assert_same_ops(_ops(jmain), _ops(pmain))
    assert sorted(pmain.global_block().desc.vars) == \
        sorted(jmain.global_block().desc.vars)
    assert sorted(pscope.var_names()) == sorted(jscope.var_names())
    for n in jscope.var_names():
        assert np.array_equal(pscope.find_var(n).numpy(),
                              np.asarray(jscope.find_var(n))), n
    types = [o.type for o in _ops(pmain)]
    if name.startswith(("conv_bn_fuse_bias", "conv_bn_fuse_no")):
        assert "batch_norm" not in types
    if name == "analysis_default_on_resnet":
        assert "batch_norm" not in types


CONV_PASSES = sorted(set(CONV_PASS_CASES[k][1][0] for k in CONV_PASS_CASES
                         if not k.startswith("analysis")))


@pytest.mark.parametrize("name", CONV_PASSES)
def test_conv_pass_leaves_the_transformer_unchanged(inference_program, name):
    jprog, fetch, scope = inference_program
    jmain, pmain = jprog.clone(), to_port(jprog)
    jir.apply_passes(jmain, [name], scope=scope, protected=[fetch])
    pir.apply_passes(pmain, [name], scope=pt.Scope(), protected=[fetch])
    assert_same_ops(_ops(jmain), _ops(pmain))
    assert [o.type for o in _ops(pmain)] == [o.type for o in _ops(jprog)]


# ---------------------------------------------------------------------------
# InferenceTranspiler
# ---------------------------------------------------------------------------

def _resnet_test(depth):
    """The imagenet ResNet's test program at ``depth`` on 32x32 images:
    (test program, startup, fetch)."""
    def build():
        from paddle_tpu.models import resnet
        with junique.guard():
            m = resnet.build(dataset="flowers", depth=depth,
                             image_shape=[3, 32, 32])
        return m["test"], m["startup"], [m["predict"].name]
    build.whole_program = True
    return build


@pytest.mark.parametrize("depth", [18, 50])
def test_inference_transpiler_on_resnet_matches_jax(depth):
    """The transpiled op list, var descs and folded tensors: the JAX
    package's, bit for bit (conv_bn_fuse folds in numpy in both)."""
    from paddle_tpu.inference import InferenceTranspiler as JTranspiler
    from paddle_tpu_torch.inference import InferenceTranspiler
    assert InferenceTranspiler.PASSES == JTranspiler.PASSES
    jmain, jstartup, fetch = _conv_prog(_resnet_test(depth))
    pmain = to_port(jmain)
    jscope, pscope = _scope_pair(jmain, jstartup)
    JTranspiler().transpile(jmain, scope=jscope, protected=fetch)
    assert InferenceTranspiler().transpile(pmain, scope=pscope,
                                           protected=fetch) is pmain
    assert_same_ops(_ops(jmain), _ops(pmain))
    assert sorted(pmain.global_block().desc.vars) == \
        sorted(jmain.global_block().desc.vars)
    for n in jscope.var_names():
        assert np.array_equal(pscope.find_var(n).numpy(),
                              np.asarray(jscope.find_var(n))), n
    assert "batch_norm" not in [o.type for o in _ops(pmain)]


def test_inference_transpiler_on_save_mlp_matches_jax(tmp_path):
    """save_mlp's directory loaded by each package and transpiled: the
    same op list (fc_fuse makes every biased mul one fc)."""
    from paddle_tpu.inference import InferenceTranspiler as JTranspiler
    from paddle_tpu.testing.models import save_mlp as jax_save_mlp
    from paddle_tpu_torch.inference import InferenceTranspiler
    d = jax_save_mlp(str(tmp_path / "mlp"), depth=2)
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        jprog, _, jfetch = fluid.io.load_inference_model(
            d, fluid.Executor(fluid.CPUPlace()))
    pscope = pt.Scope()
    with pt.scope_guard(pscope):
        pprog, _, pfetch = pt.io.load_inference_model(
            d, pt.Executor(pt.CPUPlace()))
    JTranspiler().transpile(jprog, scope=jscope,
                            protected=[v.name for v in jfetch])
    with pt.scope_guard(pscope):  # the global scope is the default
        InferenceTranspiler().transpile(pprog,
                                        protected=[v.name for v in pfetch])
    assert_same_ops(_ops(jprog), _ops(pprog))
    assert [o.type for o in _ops(pprog)].count("fc") == 3
