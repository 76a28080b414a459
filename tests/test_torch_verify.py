"""The port's program verifier (``paddle_tpu_torch.ir.verify``) against the
JAX package's (tests/test_verify.py, its tests on the port's programs).

Every program is built by the same code in both packages (``fl`` is
either), every mutation is applied to both descs, and the port's
diagnostics equal the JAX verifier's: the same (severity, code, block, op
index, op type, var) for every finding, in order. Each JAX test's own
assertions are then made on the port's report. Beyond tests/test_verify.py:
``check_pass`` is clean on every stage of the port's pipeline for the tiny
Transformer and ResNet (the bench BuildStrategy), ``verify_passes`` is
memoized per program version and leaves the op lists and the losses
unchanged, and the registry's infer coverage is at least 90%, and the
report reaches the monitor as the JAX package's does (``verify_seconds``,
``verify_findings{severity=}``, ``verify_ops_checked_total``).
tests/test_verify.py's ``test_draw_program_annotates_offenders`` is
carried over in tests/test_torch_debugger.py.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.types import DataType as JDataType
from paddle_tpu.ir import verify as jverify
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.core.desc import OpDesc as POpDesc
from paddle_tpu_torch.core.types import DataType as PDataType
from paddle_tpu_torch.ir import analyze, pipeline
from paddle_tpu_torch.ir import verify
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

PKGS = {"jax": (fluid, jverify, JOpDesc, JDataType),
        "port": (pt, verify, POpDesc, PDataType)}


def tiny_train(fl):
    with fl.unique_name.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[6], dtype="float32")
            y = fl.layers.data("y", shape=[1], dtype="float32")
            h = fl.layers.fc(x, size=8, act="relu")
            h = fl.layers.dropout(h, dropout_prob=0.1)
            p = fl.layers.fc(h, size=1)
            loss = fl.layers.reduce_mean(fl.layers.square_error_cost(p, y))
            fl.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss


def key(d):
    return (d.severity, d.code, d.block_idx, d.op_idx, d.op_type, d.var)


def both_reports(mutate=None, build=tiny_train, **kw):
    """{pkg: (program, report)} of ``build(fl)`` after ``mutate(fl,
    OpDesc, DataType, main)`` in each package; the findings must agree."""
    out = {}
    for name, (fl, ver, opdesc, dtypes) in PKGS.items():
        built = build(fl)
        main = built[0] if isinstance(built, tuple) else built
        if mutate is not None:
            mutate(fl, opdesc, dtypes, main)
        out[name] = (main, ver.verify_program(main, **kw))
    jk = [key(d) for d in out["jax"][1].diagnostics]
    pk = [key(d) for d in out["port"][1].diagnostics]
    assert pk == jk, f"port {pk}\njax  {jk}"
    return out


def _errs(rep, code=None):
    out = [d for d in rep.diagnostics if d.severity == verify.ERROR]
    return [d for d in out if d.code == code] if code else out


XY = dict(feed_names=["x", "y"])


# ---------------------------------------------------------------------------
# clean programs
# ---------------------------------------------------------------------------

def test_clean_train_program_verifies_with_zero_findings():
    rep = both_reports(**XY)["port"][1]
    assert not rep.errors and not rep.warnings, rep.format()
    assert rep.ops_checked > 10
    assert rep.unverified_ops == 0


def _tiny_transformer(fl):
    tr = (fl.models.transformer if fl is pt else
          __import__("paddle_tpu.models.transformer",
                     fromlist=["build"]))
    with fl.unique_name.guard():
        m = tr.build(batch_size=2, src_vocab=32, tgt_vocab=32, max_len=8,
                     n_layer=1, n_head=2, d_model=16, d_inner_hid=32,
                     dropout_rate=0.1)
    return m["main"], m


def test_clean_transformer_tiny_verifies_clean():
    out = {}
    for name, (fl, ver, _, _) in PKGS.items():
        main, m = _tiny_transformer(fl)
        out[name] = ver.verify_program(main, feed_names=m["feeds"])
    rep = out["port"]
    assert not rep.errors and not rep.warnings, rep.format()
    assert [key(d) for d in rep.diagnostics] == [
        key(d) for d in out["jax"].diagnostics]


def test_registry_infer_shape_coverage_at_least_90_percent():
    have, total, frac = preg.infer_shape_coverage()
    assert frac >= 0.9, f"{have}/{total} registry ops have infer rules"


# ---------------------------------------------------------------------------
# mutations: each checker's defect class
# ---------------------------------------------------------------------------

def _drop_writer(fl, opdesc, dtypes, main):
    blk = main.global_block()
    main._dropped = blk.desc.ops[0].output_arg_names()[0]
    del blk.desc.ops[0]
    blk.ops.pop(0)


def _fc0(main):
    return next(n for n in main.global_block().desc.vars
                if n.endswith("fc_0.tmp_0"))


def _swap_dtype(fl, opdesc, dtypes, main):
    main.global_block().desc.vars[_fc0(main)].dtype = dtypes.INT32


def _corrupt_shape(fl, opdesc, dtypes, main):
    main.global_block().desc.vars[_fc0(main)].shape = [3, 999]


def _reread_param(fl, opdesc, dtypes, main):
    pname = main.all_parameters()[0].name
    with fl.program_guard(main):
        blk = main.global_block()
        blk.create_var(name="post_read", shape=[6, 8], dtype="float32")
        blk.append_op(type="scale", inputs={"X": pname},
                      outputs={"Out": "post_read"}, attrs={"scale": 1.0})


def _dead_rng(fl, opdesc, dtypes, main):
    with fl.program_guard(main):
        blk = main.global_block()
        blk.create_var(name="deadrng", shape=[4], dtype="float32")
        blk.append_op(type="uniform_random", inputs={},
                      outputs={"Out": "deadrng"},
                      attrs={"shape": [4], "min": -1.0, "max": 1.0,
                             "dtype": "float32"})


def _double_writer(fl, opdesc, dtypes, main):
    with fl.program_guard(main):
        blk = main.global_block()
        blk.create_var(name="dw", shape=[-1, 6], dtype="float32")
        for _ in range(2):
            blk.append_op(type="scale", inputs={"X": "x"},
                          outputs={"Out": "dw"}, attrs={"scale": 2.0})


def _role_var_swap(fl, opdesc, dtypes, main):
    for op in main.global_block().ops:
        rv = op.attr("op_role_var")
        if rv:
            op.set_attr("op_role_var", [rv[0], "bogus@GRAD"])
            break


def _undefined_read(fl, opdesc, dtypes, main):
    main.global_block().desc.ops.append(opdesc(
        "scale", {"X": ["no_such_var"]}, {"Out": ["nsv_out"]},
        {"scale": 1.0}))


def _read_before_write(fl, opdesc, dtypes, main):
    ops = main.global_block().desc.ops
    ops.insert(0, ops.pop())


def _unregistered_twin(fl, opdesc, dtypes, main):
    for op in main.global_block().desc.ops:
        if "__fwd_type__" in op.attrs:
            op.attrs["__fwd_type__"] = "definitely_not_an_op"
            break


def _host_op(fl, opdesc, dtypes, main):
    with fl.program_guard(main):
        main.global_block().append_op(type="print", inputs={"In": "x"},
                                      outputs={}, attrs={"message": "dbg"})


def test_mutation_dropped_writer_names_op_and_var():
    main, rep = both_reports(_drop_writer, **XY)["port"]
    diags = _errs(rep, "never_written_input")
    assert diags and diags[0].var == main._dropped
    assert diags[0].op_type is not None
    # the diagnostic carries the reader op's Python creation callstack
    assert diags[0].callstack and any(
        "test_torch_verify" in fr for fr in diags[0].callstack)


def test_mutation_swapped_dtype_names_op_and_var():
    main, rep = both_reports(_swap_dtype, **XY)["port"]
    diags = _errs(rep, "dtype_mismatch")
    assert diags and diags[0].var == _fc0(main)
    assert diags[0].op_type == "mul" and diags[0].callstack


def test_mutation_corrupted_shape_names_op_and_var():
    main, rep = both_reports(_corrupt_shape, **XY)["port"]
    diags = _errs(rep, "shape_mismatch")
    assert diags and diags[0].var == _fc0(main)
    assert "999" in diags[0].message


def test_mutation_donated_param_reread_after_update():
    main, rep = both_reports(_reread_param, **XY)["port"]
    diags = _errs(rep, "donated_reread")
    assert diags and diags[0].var == main.all_parameters()[0].name
    assert diags[0].op_type == "scale"


def test_mutation_dead_rng_op_flagged():
    rep = both_reports(_dead_rng, **XY)["port"][1]
    warns = [d for d in rep.warnings if d.code == "dead_rng_op"]
    assert warns and warns[0].var == "deadrng"


def test_mutation_blind_double_writer_flagged():
    rep = both_reports(_double_writer, **XY)["port"][1]
    warns = [d for d in rep.warnings if d.code == "double_writer"]
    assert warns and warns[0].var == "dw"


def test_mutation_op_role_var_swap_flagged():
    rep = both_reports(_role_var_swap, **XY)["port"][1]
    diags = _errs(rep, "op_role_var_not_produced")
    assert diags and diags[0].var == "bogus@GRAD"


def test_mutation_undefined_var_read():
    rep = both_reports(_undefined_read, **XY)["port"][1]
    diags = _errs(rep, "undefined_var")
    assert diags and diags[0].var == "no_such_var"


def test_mutation_read_before_write():
    rep = both_reports(_read_before_write, **XY)["port"][1]
    assert _errs(rep, "read_before_write"), rep.format()


def test_mutation_grad_twin_unregistered_fwd():
    rep = both_reports(_unregistered_twin, **XY)["port"][1]
    assert _errs(rep, "grad_twin_unregistered")


def _concat_cache(fl):
    with fl.unique_name.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            k = fl.layers.data("k", shape=[4, 8], dtype="float32")
            blk = main.global_block()
            cache = blk.create_var(name="cache", shape=[-1, 0, 8],
                                   dtype="float32", persistable=True)
            grown = fl.layers.concat([cache, k], axis=1)
            blk.append_op(type="assign", inputs={"X": grown.name},
                          outputs={"Out": "cache"})
    return main


def test_lint_concat_grow_cache_suggests_kv_cache_write():
    rep = both_reports(build=_concat_cache)["port"][1]
    warns = [d for d in rep.warnings if d.code == "retrace_concat_grow"]
    assert warns and "kv_cache_write" in warns[0].message


def test_lint_host_op_breaks_scan_fusion():
    rep = both_reports(_host_op, **XY)["port"][1]
    infos = [d for d in rep.diagnostics if d.code == "host_op_splits_block"]
    assert infos and infos[0].op_type == "print"


# ---------------------------------------------------------------------------
# pass-boundary invariants
# ---------------------------------------------------------------------------

def _train_ops(fl=pt):
    main, _, loss = tiny_train(fl)
    return list(main.global_block().desc.ops), main.global_block(), loss


def test_check_pass_clean_pipeline_stages():
    ops, block, loss = _train_ops()
    needed = {loss.name} | {p.name for p in block.all_parameters()}
    stats = {}
    out = pipeline.run_pipeline(ops, block, needed, ("slim", "elewise"),
                                stats, verify=True)
    assert out
    assert {s: r["checks"] for s, r in stats.items()} == {
        "constant_fold": 1, "cse": 1, "fuse_elewise_add_act": 1,
        "dead_op_elimination": 1}


def _check_both(after_fn, pass_name, needed_fn, mutate=None):
    """check_pass of each package on its own op list and ``after_fn``
    of it; the diagnostics (code, var, op) must agree."""
    got = {}
    for name, (fl, ver, opdesc, _) in PKGS.items():
        main, _, loss = tiny_train(fl)
        if mutate is not None:
            mutate(fl, opdesc, None, main)
        block = main.global_block()
        ops = list(block.desc.ops)
        with pytest.raises(ver.PassVerifyError) as ei:
            ver.check_pass(ops, after_fn(ops, loss, opdesc), pass_name,
                           needed_fn(loss), block)
        assert ei.value.pass_name == pass_name
        got[name] = ei.value.diagnostics
    assert [key(d) for d in got["port"]] == [key(d) for d in got["jax"]]
    return got["port"]


def test_check_pass_dropped_needed_writer():
    loss_name = tiny_train(pt)[2].name
    diags = _check_both(
        lambda ops, loss, _: [o for o in ops
                              if loss.name not in o.output_arg_names()],
        "bad_dce", lambda loss: {loss.name})
    assert any(d.code == "pass_dropped_needed" and d.var == loss_name
               for d in diags)


def test_check_pass_removed_rng_op():
    diags = _check_both(lambda ops, loss, _: [o for o in ops
                                              if o.type != "dropout"],
                        "bad_cse", lambda loss: set())
    assert any(d.code == "pass_rng_stream_changed" for d in diags)


def test_check_pass_dropped_writer_keeps_readers():
    ops, _, _ = _train_ops()
    victim_out = next(o for o in ops if o.type == "relu").output_arg_names()[0]
    diags = _check_both(
        lambda ops, loss, _: [o for o in ops if o is not next(
            v for v in ops if v.type == "relu")],
        "bad_fold", lambda loss: set())
    assert any(d.code == "pass_new_undefined_read" and d.var == victim_out
               for d in diags)


def test_check_pass_new_double_writer():
    def dup(ops, loss, opdesc):
        d = next(o for o in ops if o.type == "relu")
        return list(ops) + [opdesc(d.type, dict(d.inputs), dict(d.outputs),
                                   dict(d.attrs))]

    diags = _check_both(dup, "bad_dup", lambda loss: set())
    assert any(d.code == "pass_new_double_writer" for d in diags)


def test_check_pass_host_ops_must_survive():
    diags = _check_both(lambda ops, loss, _: [o for o in ops
                                              if o.type != "print"],
                        "bad_prune", lambda loss: set(), mutate=_host_op)
    assert any(d.code == "pass_host_ops_changed" for d in diags)


BENCH_FLAGS = ("convfuse", "attnfuse", "slim", "elewise", "optfuse")


def _resnet_tiny(fl):
    from paddle_tpu_torch.models import resnet
    with fl.unique_name.guard():
        return resnet.build(dataset="cifar10")


@pytest.mark.parametrize("model", ["transformer", "resnet"])
def test_check_pass_clean_on_every_stage_of_the_ports_pipeline(model):
    """Every stage of the bench BuildStrategy's pipeline (all five pass
    groups) keeps the invariants on the tiny Transformer (unfused
    attention, so attnfuse rewrites it) and ResNet (cifar10, 32 layers)."""
    if model == "transformer":
        with pt.unique_name.guard():
            m = pt.models.transformer.build(
                batch_size=2, src_vocab=32, tgt_vocab=32, max_len=8,
                n_layer=1, n_head=2, d_model=16, d_inner_hid=32,
                attention_impl="unfused")
    else:
        m = _resnet_tiny(pt)
    block = m["main"].global_block()
    ops = [o for o in block.desc.ops if o.type not in ("feed", "fetch")]
    needed = {m["loss"].name} | {
        n for o in ops for n in o.output_arg_names()
        if block.has_var(n) and block.var(n).persistable}
    stats = {}
    out = pipeline.run_pipeline(ops, block, needed, BENCH_FLAGS, stats,
                                verify=True)
    assert len(out) < len(ops)
    assert stats and all(r["checks"] == 1 for r in stats.values()), stats
    rep = verify.verify_program(m["main"])
    assert not rep.errors, rep.format()


# ---------------------------------------------------------------------------
# executor integration and memoization
# ---------------------------------------------------------------------------

def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(4, 6).astype("float32"),
            "y": rng.rand(4, 1).astype("float32")}


def test_executor_verifies_before_lowering_and_memoizes():
    main, startup, loss = tiny_train(pt)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        PFLAGS.verify_passes = True
        try:
            exe.run(main, feed=_feed(), fetch_list=[loss])
            memo = main.__dict__.get("_verify_memo")
            assert memo and len(memo) == 1
            first = next(iter(memo.values()))
            assert verify.verify_before_run(main) is first
            exe.run(main, feed=_feed(), fetch_list=[loss])
            assert len(main.__dict__["_verify_memo"]) == 1
            # a new program version is verified anew
            main._version += 1
            exe.run(main, feed=_feed(), fetch_list=[loss])
            assert len(main.__dict__["_verify_memo"]) == 2
        finally:
            PFLAGS.verify_passes = False


def test_executor_raises_typed_error_on_malformed_program():
    main, startup, loss = tiny_train(pt)
    name = _fc0(main)
    main.global_block().desc.vars[name].dtype = PDataType.INT32
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        PFLAGS.verify_passes = True
        try:
            with pytest.raises(verify.ProgramVerifyError) as ei:
                exe.run(main, feed={"x": np.zeros((2, 6), "float32"),
                                    "y": np.zeros((2, 1), "float32")},
                        fetch_list=[loss])
            assert "dtype_mismatch" in str(ei.value) and name in str(ei.value)
        finally:
            PFLAGS.verify_passes = False


def test_executor_raises_on_a_dropped_writer_before_any_op_runs():
    """With the run's feed, a live op's input that no op writes and the
    feed lacks fails the check before any op runs (the parameters keep
    their values); a test clone run without its label passes, since no
    live op reads the label."""
    main, startup, loss = tiny_train(pt)
    test_prog = main.clone(for_test=True)
    pred = next(n for n in test_prog.global_block().desc.vars
                if n.startswith("fc_1.tmp_1"))
    _drop_writer(pt, POpDesc, PDataType, main)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        before = {n: scope.find_var(n).clone() for n in scope.var_names()}
        PFLAGS.verify_passes = True
        try:
            with pytest.raises(verify.ProgramVerifyError) as ei:
                exe.run(main, feed=_feed(), fetch_list=[loss])
            assert ("never_written_input" in str(ei.value)
                    and main._dropped in str(ei.value))
            for n, t in before.items():
                assert torch.equal(scope.find_var(n), t), n
            out = exe.run(test_prog, feed={"x": _feed()["x"]},
                          fetch_list=[pred])[0]
            assert np.isfinite(out).all()
            assert test_prog.__dict__["_verify_memo"]
        finally:
            PFLAGS.verify_passes = False


def test_build_strategy_verify_passes_knob():
    """verify_passes through CompiledProgram: losses bitwise and op lists
    equal to the run without it; every stage checked once, and the
    pipeline memo holds one list per (version, fetches, flags, verify)."""
    losses, lists = {}, {}
    for on in (False, True):
        main, startup, loss = tiny_train(pt)
        main.random_seed = startup.random_seed = 5
        bs = pt.BuildStrategy()
        bs.memory_optimize = bs.fuse_elewise_add_act_ops = True
        bs.verify_passes = on
        cp = pt.CompiledProgram(main, build_strategy=bs)
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            losses[on] = [np.asarray(exe.run(cp, feed=_feed(),
                                             fetch_list=[loss])[0])
                          for _ in range(2)]
            lists[on] = [(o.type, o.inputs, o.outputs)
                         for o in exe.lowered_ops(cp, [loss])]
        assert bool(main.__dict__.get("_verify_memo")) == on
        checks = [r.get("checks", 0)
                  for r in exe.pipeline_stats["stages"].values()]
        assert checks and all(c == (1 if on else 0) for c in checks)
    assert lists[True] == lists[False]
    for a, b in zip(losses[True], losses[False]):
        np.testing.assert_array_equal(a, b)
        assert np.isfinite(a).all()


# ---------------------------------------------------------------------------
# plumbing: callstacks, the registry alias, def-use
# ---------------------------------------------------------------------------

def test_op_creation_callstack_captured():
    main, _, _ = tiny_train(pt)
    op = main.global_block().desc.ops[0]
    assert op.callstack and any("test_torch_verify" in fr
                                for fr in op.callstack)
    clone = main.clone()
    assert clone.global_block().desc.ops[0].callstack == op.callstack


def test_register_op_infer_alias():
    def rule(op, block):
        pass

    @preg.register_op("__verify_test_op__", no_grad=True, infer=rule)
    def emit(ctx, ins, attrs):
        return {}

    try:
        assert preg.lookup("__verify_test_op__").infer_shape is rule
        with pytest.raises(ValueError):
            preg.register_op("__verify_test_op2__", infer=rule,
                             infer_shape=rule)
    finally:
        preg._REGISTRY.pop("__verify_test_op__", None)


def test_def_use_moved_reads_and_group_interference():
    ops = [POpDesc("scale", {"X": ["a"]}, {"Out": ["b"]}, {}),
           POpDesc("scale", {"X": ["b"]}, {"Out": ["a"]}, {}),
           POpDesc("scale", {"X": ["b"]}, {"Out": ["c"]}, {})]
    du = analyze.DefUse(ops)
    assert not du.moved_reads_safe(["a"], [0], 2)
    assert du.moved_reads_safe(["b"], [2], 2)
    assert du.group_interference([0, 2], {"a", "b"}, {"b", "c"}) == 1
    assert du.external_reads() == {"a"}
    assert du.readers_after("b", 1) == [2] and du.write_positions("a") == [1]


def test_program_def_use_and_rng_sequence_equal_the_jax_ones():
    from paddle_tpu.ir import analyze as janalyze
    mains = {n: tiny_train(fl)[0] for n, (fl, _, _, _) in PKGS.items()}
    jdu = janalyze.ProgramDefUse(mains["jax"]).def_use(0)
    pdu = analyze.ProgramDefUse(mains["port"]).def_use(0)
    assert pdu.writers == jdu.writers and pdu.readers == jdu.readers
    ops = {n: m.global_block().desc.ops for n, m in mains.items()}
    assert analyze.rng_sequence(ops["port"]) == janalyze.rng_sequence(
        ops["jax"]) == ["dropout"]


def test_meta_fallback_infers_an_op_without_a_rule():
    """An op with no rule is checked by its emitter on meta tensors: a
    wrong declared shape is found, a random op is unverifiable."""
    main, _, _ = tiny_train(pt)
    blk = main.global_block()
    op = next(o for o in blk.desc.ops if o.type == "relu")
    saved = preg.lookup("relu").infer_shape
    preg.lookup("relu").infer_shape = None
    try:
        out = op.output_arg_names()[0]
        rep = verify.verify_program(main)
        assert not rep.errors and rep.fallback_ops >= 1
        blk.desc.vars[out].shape = [-1, 7]
        rep = verify.verify_program(main)
        # the first finding names it (its readers, checked against the
        # declared type, follow)
        assert _errs(rep, "shape_mismatch")[0].var == out
    finally:
        preg.lookup("relu").infer_shape = saved
    shadow = verify._ShadowBlock(main.desc, 0)
    drop = next(o for o in blk.desc.ops if o.type == "dropout")
    assert verify._abstract_eval(drop, shadow) is None


def test_verify_reports_to_the_monitor():
    """verify_before_run's report lands in both monitors alike: the same
    findings gauges and ops-checked counter (seconds differ)."""
    from paddle_tpu import monitor as jmon
    from paddle_tpu_torch import monitor as pmon

    def mutate(fl, opdesc, dtypes, main):
        _swap_dtype(fl, opdesc, dtypes, main)

    snaps = {}
    for name, (fl, ver, opdesc, dtypes) in PKGS.items():
        mon = jmon if name == "jax" else pmon
        mon.reset()
        mon.enable()
        try:
            main = tiny_train(fl)[0]
            mutate(fl, opdesc, dtypes, main)
            with pytest.raises(ver.ProgramVerifyError):
                ver.verify_before_run(main, feed_names={"x", "y"})
            snaps[name] = {k: v for k, v in mon.snapshot().items()
                           if not k.startswith("verify_seconds")}
            assert mon.snapshot()["verify_seconds"]["count"] == 1
        finally:
            mon.disable()
            mon.reset()
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]['verify_findings{severity="error"}'] >= 1
    assert snaps["port"]["verify_ops_checked_total"] > 0

