"""Checkpoints of the port (``paddle_tpu_torch.io``: ``save_checkpoint``,
``load_checkpoint``, ``AsyncCheckpointer``, ``capture_train_state``) on
the CPU, against the JAX package's.

The scenarios of tests/test_checkpoint_resume.py run through the port:
resume after a crash, an unmarked checkpoint skipped, retention, ranks
that do not clobber each other, orphans swept, the async writer's
snapshot, a torn async save, a writer error raised at the next save, the
rank wait. Where the JAX test holds a resumed run within 1e-5 of the
uninterrupted one, the port is held bitwise: both runs are the same ops
on the same values on one CPU.

Cross-loads: a checkpoint written by either package is restored by the
other and trained 4 more steps; the losses agree with the writer's own
continuation within 1e-5 relative (the packages' sgd steps differ in
summation order only), and the tensor files of the two packages' saves
of the same state are byte-identical. The port's random state is its
generators' (``torch_generators``); a JAX ``rng_key`` is not applied.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS


@pytest.fixture(autouse=True)
def _no_callstacks():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _build(mod=pt, uniq=punique, lr=0.1, seed=7, dropout=0.0):
    """fc(4 -> 8, relu) [-> dropout] -> fc(8 -> 1), square-error loss,
    SGD: the JAX resume tests' model. The same names on every build."""
    main, startup = mod.Program(), mod.Program()
    startup.random_seed = seed
    main.random_seed = seed
    with uniq.guard():
        with mod.program_guard(main, startup):
            x = mod.layers.data("x", shape=[4])
            y = mod.layers.data("y", shape=[1])
            h = mod.layers.fc(x, size=8, act="relu")
            if dropout:
                h = mod.layers.dropout(h, dropout_prob=dropout)
            pred = mod.layers.fc(h, size=1)
            loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
            mod.optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 1).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.rand(8, 4).astype(np.float32)
        out.append({"x": x, "y": (x @ w).astype(np.float32)})
    return out


def _fresh(**kw):
    """A new global scope, program pair and CPU executor, startup run."""
    pt.executor._global_scope = pt.Scope()
    main, startup, loss = _build(**kw)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    return main, exe, loss


@pytest.fixture(autouse=True)
def _own_global_scope():
    old = pt.executor._global_scope
    yield
    pt.executor._global_scope = old


def _loss(exe, main, feed, loss):
    return float(exe.run(main, feed=feed, fetch_list=[loss])[0].ravel()[0])


def test_crash_resume_matches_uninterrupted(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    batches = _batches(10)
    main, exe, loss = _fresh()
    ref = [_loss(exe, main, b, loss) for b in batches]

    main, exe, loss = _fresh()
    for i, b in enumerate(batches[:6]):
        exe.run(main, feed=b, fetch_list=[loss])
        if (i + 1) % 2 == 0:
            pio.save_checkpoint(exe, ckpt, step=i + 1, main_program=main)
    main, exe, loss = _fresh()  # the crash: parameters lost
    step = pio.load_checkpoint(exe, ckpt, main_program=main)
    assert step == 6
    resumed = [_loss(exe, main, b, loss) for b in batches[step:]]
    np.testing.assert_array_equal(resumed, ref[6:])


def test_incomplete_checkpoint_skipped(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    exe.run(main, feed=_batches(1)[0], fetch_list=[loss])
    pio.save_checkpoint(exe, ckpt, step=1, main_program=main)
    os.makedirs(os.path.join(ckpt, "checkpoint_2", "0"))  # cut mid-save
    assert pio.load_checkpoint(exe, ckpt, main_program=main) == 1


def test_checkpoint_retention(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    for s in range(1, 6):
        pio.save_checkpoint(exe, ckpt, step=s, main_program=main,
                            max_num_checkpoints=2)
    kept = sorted(d for d in os.listdir(ckpt) if d.startswith("checkpoint_"))
    assert kept == ["checkpoint_4", "checkpoint_5"]
    pio.clean_checkpoint(ckpt)
    assert not [d for d in os.listdir(ckpt) if d.startswith("checkpoint_")]


def test_fresh_start_returns_none(tmp_path):
    main, exe, loss = _fresh()
    assert pio.load_checkpoint(exe, str(tmp_path / "nothing"),
                               main_program=main) is None


def test_multi_rank_checkpoint_no_clobber(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    pio.save_checkpoint(exe, ckpt, step=3, main_program=main, trainer_id=1,
                        num_trainers=2)
    assert not os.path.exists(os.path.join(ckpt, "checkpoint_3", "_SUCCESS"))
    pio.save_checkpoint(exe, ckpt, step=3, main_program=main, trainer_id=0,
                        num_trainers=2)
    d = os.path.join(ckpt, "checkpoint_3")
    assert os.path.isdir(os.path.join(d, "0"))
    assert os.path.isdir(os.path.join(d, "1"))
    assert os.path.exists(os.path.join(d, "_SUCCESS"))
    assert pio.load_checkpoint(exe, ckpt, main_program=main,
                               trainer_id=1) == 3


def test_orphaned_dirs_swept(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    os.makedirs(os.path.join(ckpt, "checkpoint_1", "0"))
    os.makedirs(os.path.join(ckpt, "checkpoint_2.tmp.0", "0"))
    pio.save_checkpoint(exe, ckpt, step=5, main_program=main)
    left = sorted(os.listdir(ckpt))
    assert "checkpoint_1" not in left
    assert "checkpoint_2.tmp.0" not in left
    assert "checkpoint_5" in left


def test_async_checkpointer_roundtrip(tmp_path):
    """The async snapshot holds the values of its step, not the updates
    that follow; overlapping saves join."""
    main, exe, loss = _fresh()
    feed = _batches(1)[0]
    ckpt = pio.AsyncCheckpointer()
    cdir = str(tmp_path / "ckpts")
    exe.run(main, feed=feed, fetch_list=[loss])
    pname = main.all_parameters()[0].name
    at_save = pt.global_scope().find_var(pname).clone()
    ckpt.save(exe, cdir, step=1, main_program=main)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss])
    ckpt.wait()
    assert ckpt.stats["saves"] == 1 and ckpt.stats["bytes"] > 0

    main2, exe2, _ = _fresh()
    assert pio.load_checkpoint(exe2, cdir, main_program=main2) == 1
    assert torch.equal(pt.global_scope().find_var(pname), at_save)
    ckpt.save(exe2, cdir, step=2, main_program=main2)
    ckpt.save(exe2, cdir, step=3, main_program=main2)
    ckpt.wait()
    assert os.path.exists(os.path.join(cdir, "checkpoint_3", "_SUCCESS"))
    ckpt.close()


def test_torn_async_save_falls_back_and_is_swept(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    exe.run(main, feed=_batches(1)[0], fetch_list=[loss])
    ac = pio.AsyncCheckpointer()
    ac.save(exe, ckpt, step=1, main_program=main)
    ac.wait()
    with faults.FaultPlan().fail("ckpt_write", calls=[0]):
        ac.save(exe, ckpt, step=2, main_program=main)
        with pytest.raises(RuntimeError, match="async checkpoint"):
            ac.wait()
    left = sorted(os.listdir(ckpt))
    assert "checkpoint_2.tmp.0" in left
    assert not os.path.exists(os.path.join(ckpt, "checkpoint_2", "_SUCCESS"))
    main2, exe2, _ = _fresh()
    assert pio.load_checkpoint(exe2, ckpt, main_program=main2) == 1
    ac.save(exe2, ckpt, step=3, main_program=main2)
    ac.close()
    left = sorted(os.listdir(ckpt))
    assert "checkpoint_2.tmp.0" not in left
    assert os.path.exists(os.path.join(ckpt, "checkpoint_3", "_SUCCESS"))


def test_async_save_error_reraises_at_next_save(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    ac = pio.AsyncCheckpointer()
    with faults.FaultPlan().fail("ckpt_write", calls=[0]):
        ac.save(exe, ckpt, step=1, main_program=main)
        ac._thread.join()  # the writer died; its error is pending
        with pytest.raises(RuntimeError, match="async checkpoint") as ei:
            ac.save(exe, ckpt, step=2, main_program=main)
        assert isinstance(ei.value.__cause__, faults.FaultInjected)
    ac.save(exe, ckpt, step=3, main_program=main)
    ac.close()
    assert os.path.exists(os.path.join(ckpt, "checkpoint_3", "_SUCCESS"))


def test_sync_save_fault_leaves_the_staging_dir(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    pio.save_checkpoint(exe, ckpt, step=1, main_program=main)
    with faults.FaultPlan().fail("ckpt_write", calls=[0]):
        with pytest.raises(faults.FaultInjected):
            pio.save_checkpoint(exe, ckpt, step=2, main_program=main)
    assert "checkpoint_2.tmp.0" in os.listdir(ckpt)
    assert pio.load_checkpoint(exe, ckpt, main_program=main) == 1


def test_rank_wait_configurable(tmp_path):
    """The all-ranks deadline is FLAGS.ckpt_rank_wait_s or rank_wait_s;
    past it the checkpoint stays unmarked."""
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    t0 = time.time()
    with pytest.raises(RuntimeError, match="UNMARKED"):
        pio.save_checkpoint(exe, ckpt, step=1, main_program=main,
                            num_trainers=2, rank_wait_s=0.2)
    assert time.time() - t0 < 30.0
    assert pio.load_checkpoint(exe, ckpt, main_program=main) is None
    assert PFLAGS.ckpt_rank_wait_s == JFLAGS.ckpt_rank_wait_s


def test_train_state_payload_roundtrip(tmp_path):
    """train_state.json carries the step, the loader cursor and the
    scope's generators: a restore into a fresh scope continues the
    generator's stream (the next dropout masks are the ones the saving
    run drew next); a checkpoint without the payload still loads."""
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh(dropout=0.5)
    b = _batches(3)
    exe.run(main, feed=b[0], fetch_list=[loss])

    class _FakeLoader:
        def state_dict(self):
            return {"epoch": 2, "offset": 7}

    state = pio.capture_train_state(5, loader=_FakeLoader())
    assert set(state["torch_generators"]) == {"cpu"}
    pio.save_checkpoint(exe, ckpt, step=5, main_program=main,
                        train_state=state)
    got = pio.read_train_state(ckpt)
    assert got["step"] == 5 and got["version"] == 1
    assert got["data_cursor"] == {"epoch": 2, "offset": 7}
    assert "rng_key" not in got
    after = [_loss(exe, main, f, loss) for f in b[1:]]

    main2, exe2, loss2 = _fresh(dropout=0.5)
    assert pio.load_checkpoint(exe2, ckpt, main_program=main2) == 5
    np.testing.assert_array_equal(
        [_loss(exe2, main2, f, loss2) for f in b[1:]], after)

    os.remove(os.path.join(ckpt, "checkpoint_5", "0", "train_state.json"))
    main3, exe3, _ = _fresh()
    assert pio.load_checkpoint(exe3, ckpt, main_program=main3) == 5
    assert pio.read_train_state(ckpt) is None


def test_restore_is_in_place(tmp_path):
    """load_checkpoint copies into the scope's tensors, so a cached plan
    (on the card, its captured graph) keeps them."""
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    feed = _batches(1)[0]
    exe.run(main, feed=feed, fetch_list=[loss])
    pio.save_checkpoint(exe, ckpt, step=1, main_program=main)
    saved = {n: pt.global_scope().find_var(n).clone()
             for n in pt.global_scope().var_names()}
    exe.run(main, feed=feed, fetch_list=[loss])
    before = {n: pt.global_scope().find_var(n)
              for n in pt.global_scope().var_names()}
    plans = dict(main.__dict__["_exec_cache"])
    assert pio.load_checkpoint(exe, ckpt, main_program=main) == 1
    for n, t in before.items():
        assert pt.global_scope().find_var(n) is t, n
        assert torch.equal(t, saved[n]), n
    assert main.__dict__["_exec_cache"] == plans


def test_load_checkpoint_casts_to_the_declared_dtype(tmp_path):
    """An int32 file (the JAX package narrows int64) of an int64
    persistable loads as int64, in place where the scope has it."""
    from paddle_tpu_torch.ops.kernels_host import save_tensor_to_file
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        blk = main.global_block()
        blk.create_var(name="counter", shape=[1], dtype="int64",
                       persistable=True)
    d = tmp_path / "ckpt" / "checkpoint_3"
    os.makedirs(d / "0")
    save_tensor_to_file(str(d / "0" / "counter"),
                        np.array([9], np.int32))
    (d / "_SUCCESS").write_text("3")
    for existing in (None, torch.zeros(1, dtype=torch.int64)):
        scope = pt.Scope()
        if existing is not None:
            scope.set_var("counter", existing)
        assert pio.load_checkpoint(pt.Executor(pt.CPUPlace()),
                                   str(tmp_path / "ckpt"), main_program=main,
                                   scope=scope) == 3
        got = scope.find_var("counter")
        assert got.dtype == torch.int64 and got.tolist() == [9]
        assert existing is None or got is existing


def test_compiled_program_checkpoints_its_program(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    target = pt.CompiledProgram(main)
    exe.run(target, feed=_batches(1)[0], fetch_list=[loss])
    pio.save_checkpoint(exe, ckpt, step=1, main_program=target)
    files = set(os.listdir(os.path.join(ckpt, "checkpoint_1", "0")))
    assert {v.name for v in main.list_vars() if v.persistable} <= files
    assert pio.load_checkpoint(exe, ckpt, main_program=target) == 1


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _jax_fresh():
    fluid.executor._global_scope = fluid.Scope()
    main, startup, loss = _build(fluid, junique)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    return main, exe, loss


def _jax_loss(exe, main, feed, loss):
    return float(np.asarray(exe.run(main, feed=feed,
                                    fetch_list=[loss])[0]).ravel()[0])


@pytest.fixture
def jax_global_scope():
    old = fluid.executor._global_scope
    yield
    fluid.executor._global_scope = old


def test_programs_match_jax():
    jm, js, _ = _build(fluid, junique, dropout=0.3)
    pm, ps, _ = _build(pt, punique, dropout=0.3)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    assert ps.desc.to_bytes() == js.desc.to_bytes()


def test_jax_checkpoint_continues_in_the_port(tmp_path, jax_global_scope):
    """JAX trains 3 steps and checkpoints; the port restores and trains 4
    more, within 1e-5 of the JAX package's own continuation."""
    ckpt = str(tmp_path / "ckpt")
    b = _batches(7)
    jmain, jexe, jloss = _jax_fresh()
    for f in b[:3]:
        jexe.run(jmain, feed=f, fetch_list=[jloss])
    fluid.io.save_checkpoint(jexe, ckpt, step=3, main_program=jmain)
    jref = [_jax_loss(jexe, jmain, f, jloss) for f in b[3:]]
    main, exe, loss = _fresh(seed=99)  # other initial weights: overwritten
    assert pio.load_checkpoint(exe, ckpt, main_program=main) == 3
    got = [_loss(exe, main, f, loss) for f in b[3:]]
    np.testing.assert_allclose(got, jref, rtol=1e-5)


def test_port_checkpoint_continues_in_jax(tmp_path, jax_global_scope):
    ckpt = str(tmp_path / "ckpt")
    b = _batches(7)
    main, exe, loss = _fresh()
    for f in b[:3]:
        exe.run(main, feed=f, fetch_list=[loss])
    pio.save_checkpoint(exe, ckpt, step=3, main_program=main)
    ref = [_loss(exe, main, f, loss) for f in b[3:]]
    jmain, jexe, jloss = _jax_fresh()
    assert fluid.io.load_checkpoint(jexe, ckpt, main_program=jmain) == 3
    got = [_jax_loss(jexe, jmain, f, jloss) for f in b[3:]]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert fluid.io.read_train_state(ckpt)["step"] == 3


def test_async_checkpoint_cross_loads(tmp_path, jax_global_scope):
    """An AsyncCheckpointer checkpoint of each package restores in the
    other: the same persistables, bitwise."""
    b = _batches(2)
    main, exe, loss = _fresh()
    exe.run(main, feed=b[0], fetch_list=[loss])
    ac = pio.AsyncCheckpointer()
    ac.save(exe, str(tmp_path / "p"), step=1, main_program=main)
    ac.close()
    jmain, jexe, jloss = _jax_fresh()
    jexe.run(jmain, feed=b[1], fetch_list=[jloss])
    jac = fluid.io.AsyncCheckpointer()
    jac.save(jexe, str(tmp_path / "j"), step=2, main_program=jmain)
    jac.close()
    names = [v.name for v in main.list_vars() if v.persistable]
    jscope = fluid.global_scope()
    jheld = {n: np.asarray(jscope.find_var(n)).copy() for n in names}
    pheld = {n: pt.global_scope().find_var(n).numpy().copy() for n in names}
    assert fluid.io.load_checkpoint(jexe, str(tmp_path / "p"),
                                    main_program=jmain) == 1
    main2, exe2, _ = _fresh(seed=3)
    assert pio.load_checkpoint(exe2, str(tmp_path / "j"),
                               main_program=main2) == 2
    for n in names:
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                      pheld[n], err_msg=n)
        np.testing.assert_array_equal(pt.global_scope().find_var(n).numpy(),
                                      jheld[n], err_msg=n)


def test_tensor_files_are_byte_identical_to_jax(tmp_path, jax_global_scope):
    """Both packages' saves of the same state write the same tensor files
    and the same layout (train_state.json differs in its random state,
    meta.json in its time)."""
    jmain, jexe, jloss = _jax_fresh()
    jexe.run(jmain, feed=_batches(1)[0], fetch_list=[jloss])
    names = [v.name for v in jmain.list_vars() if v.persistable]
    state = {n: np.asarray(fluid.global_scope().find_var(n)) for n in names}
    main, exe, loss = _fresh()
    pt.io.set_params_from_numpy(pt.global_scope(), state, "cpu",
                                program=main)
    fluid.io.save_checkpoint(jexe, str(tmp_path / "j"), step=4,
                             main_program=jmain)
    pio.save_checkpoint(exe, str(tmp_path / "p"), step=4, main_program=main)
    jd, pd = (str(tmp_path / k / "checkpoint_4") for k in ("j", "p"))
    assert sorted(os.listdir(jd)) == sorted(os.listdir(pd))
    jfiles = sorted(os.listdir(os.path.join(jd, "0")))
    assert jfiles == sorted(os.listdir(os.path.join(pd, "0")))
    for f in jfiles:
        if f.endswith(".json"):
            continue
        with open(os.path.join(jd, "0", f), "rb") as a, \
                open(os.path.join(pd, "0", f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(pd, "0", "meta.json")) as fh:
        assert set(json.load(fh)) == {"step", "time", "trainer_id"}


def test_jax_rng_key_is_not_applied_and_logged_once(tmp_path, caplog,
                                                    jax_global_scope):
    import jax
    ckpt = str(tmp_path / "ckpt")
    jmain, jexe, jloss = _jax_fresh()
    fluid.global_scope().rng_key = jax.random.PRNGKey(123)
    fluid.io.save_checkpoint(jexe, ckpt, step=2, main_program=jmain)
    assert "rng_key" in fluid.io.read_train_state(ckpt)
    pio._rng_key_noted.clear()
    main, exe, loss = _fresh(dropout=0.5)
    gen_state = pt.global_scope()._generators["cpu"].get_state().clone()
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.io"):
        for _ in range(2):
            assert pio.load_checkpoint(exe, ckpt, main_program=main) == 2
    assert torch.equal(pt.global_scope()._generators["cpu"].get_state(),
                       gen_state)
    notes = [r for r in caplog.records if "rng_key" in r.getMessage()]
    assert len(notes) == 1


def test_save_and_load_params_match_jax(tmp_path, jax_global_scope):
    """save_params writes the parameters only (no learning-rate
    variable), the same files as the JAX package's; load_params reads
    them back."""
    jmain, jexe, _ = _jax_fresh()
    fluid.io.save_params(jexe, str(tmp_path / "j"), jmain)
    main, exe, _ = _fresh(seed=11)
    pio.save_params(exe, str(tmp_path / "p"), main)
    assert sorted(os.listdir(tmp_path / "j")) == sorted(
        os.listdir(tmp_path / "p"))
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        p.name for p in main.all_parameters())
    pio.load_params(exe, str(tmp_path / "j"), main)
    for p in main.all_parameters():
        np.testing.assert_array_equal(
            pt.global_scope().find_var(p.name).numpy(),
            np.asarray(fluid.global_scope().find_var(p.name)))
