"""The port's layer DSL and ``transformer.build`` against the JAX
package's: at a tiny width the programs the two packages build (train
program with its backward, noam schedule and Adam ops; startup with the
optimizer state; test clone) serialize to the same bytes (op_callstack
off in both, though it is kept out of the serialized desc anyway).
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

FEEDS = ["src_word", "src_pos", "trg_word", "trg_pos", "src_len", "trg_len"]
TINY = dict(n_layer=2, n_head=2, d_model=32, d_inner_hid=64, src_vocab=100,
            tgt_vocab=100, max_len=16)


@pytest.fixture(scope="module")
def built():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    try:
        with junique.guard():
            j = jtransformer.build(dropout_rate=0.0, **TINY)
        with punique.guard():
            p = ptransformer.build(**TINY)
    finally:
        JFLAGS.op_callstack, PFLAGS.op_callstack = old
    return j, p


def test_test_program_bytes_identical(built):
    j, p = built
    assert p["test"].desc.to_bytes() == j["test"].desc.to_bytes()


def test_pruned_inference_program_bytes_identical(built):
    j, p = built
    jb = j["test"]._prune(FEEDS, [j["logits"].name]).desc.to_bytes()
    pb = p["test"]._prune(FEEDS, [p["logits"].name]).desc.to_bytes()
    assert pb == jb
    ops = p["test"]._prune(FEEDS, [p["logits"].name]).global_block().ops
    # 2 layers: 2 encoder self + 2 decoder self + 2 cross attentions
    assert sum(op.type == "flash_attention" for op in ops) == 6
    assert not {"softmax_with_cross_entropy", "reduce_sum"} & {
        op.type for op in ops}


def test_startup_program_is_the_jax_parameter_prefix(built):
    """The whole startup program: parameters, their initializers, then
    the learning-rate counter and Adam's state, in the same order."""
    j, p = built
    jblk, pblk = j["startup"].desc.blocks[0], p["startup"].desc.blocks[0]
    assert list(jblk.vars) == list(pblk.vars)
    for name in pblk.vars:
        assert pblk.vars[name].to_dict() == jblk.vars[name].to_dict()
    assert [o.to_dict() for o in jblk.ops] == [o.to_dict() for o in pblk.ops]
    assert p["startup"].desc.to_bytes() == j["startup"].desc.to_bytes()
    names = list(pblk.vars)
    assert "@LR_DECAY_COUNTER@" in names
    assert any(n.endswith("_moment1_0") for n in names)


def test_main_program_is_the_jax_forward(built):
    """The whole main program: the increment prepended by the noam
    schedule, the model forward and loss, the schedule's forward ops, the
    backward (grad ops, sums, op_role_var stamps) and one adam per
    parameter."""
    j, p = built
    jops = [o.to_dict() for o in j["main"].desc.blocks[0].ops]
    pops = [o.to_dict() for o in p["main"].desc.blocks[0].ops]
    assert pops == jops
    assert p["main"].desc.to_bytes() == j["main"].desc.to_bytes()
    assert pops[0]["type"] == "increment"
    types = {o["type"] for o in pops}
    assert {"flash_attention_grad", "lookup_table_grad", "adam", "sum",
            "softmax_with_cross_entropy_grad"} <= types


def test_saved_model_files_identical(built, tmp_path):
    """save_inference_model writes the same __model__ in both packages
    (feed order reversed by the prepended feed ops, in both)."""
    j, p = built
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(j["startup"])
        fluid.io.save_inference_model(str(tmp_path / "jax"), FEEDS,
                                      [j["logits"]], jexe,
                                      main_program=j["test"],
                                      export_for_deployment=False)
    pexe, pscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(pscope):
        pexe.run(p["startup"])
        pt.io.save_inference_model(str(tmp_path / "port"), FEEDS,
                                   [p["logits"]], pexe,
                                   main_program=p["test"])
    jm = (tmp_path / "jax" / "__model__").read_bytes()
    pm = (tmp_path / "port" / "__model__").read_bytes()
    assert pm == jm
    _, feeds, _ = pt.io.load_inference_model(str(tmp_path / "port"),
                                             pt.Executor(pt.CPUPlace()))
    assert feeds == list(reversed(FEEDS))
    saved = sorted(f.name for f in (tmp_path / "port").iterdir())
    assert saved == sorted(f.name for f in (tmp_path / "jax").iterdir()
                           if f.name == "__model__"
                           or not f.name.startswith("__"))


def test_var_shapes_and_dtypes_inferred(built):
    _, p = built
    blk = p["test"].global_block()
    assert blk.var(p["logits"].name).shape == (-1, 16, 100)
    assert blk.var("src_word").shape == (-1, 16, 1)
    attn = [op for op in blk.ops if op.type == "flash_attention"]
    q = blk.var(attn[0].input("Q")[0])
    assert q.shape == (-1, 2, 16, 16)
    assert blk.var(attn[0].output("Out")[0]).shape == q.shape
    kb = blk.var(attn[0].input("KeyBias")[0])
    assert kb.shape == (-1, 16) and kb.dtype.name == "FP32"


def test_clone_for_test_keeps_parameters(built):
    _, p = built
    params = {v.name for v in p["main"].all_parameters()}
    assert params and params == {v.name for v in p["test"].all_parameters()}
    assert all(isinstance(p["test"].global_block().var(n), pt.Parameter)
               for n in params)


def test_dropout_is_refused_until_ported():
    with pytest.raises(ValueError, match="dropout"):
        ptransformer.build(dropout_rate=0.1, **TINY)


def test_make_fake_batch_matches_jax():
    cfg = dict(TINY)
    a = ptransformer.make_fake_batch(3, cfg, seed=4)
    b = jtransformer.make_fake_batch(3, cfg, seed=4)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
