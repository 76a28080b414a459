"""The port's ElasticTrainer (``paddle_tpu_torch.elastic``) on the CPU.

The scenarios of tests/test_elastic.py run through the port: a
dropout run killed and resumed equals the uninterrupted one bitwise (the
checkpoint carries the scope's generator state), ``run(iterations=K)``
windows likewise, the DataLoader cursor resumes mid-epoch, an injected
preemption and a real SIGTERM write an emergency checkpoint and exit with
RESUME_EXIT_CODE, a failed async save keeps ``health()`` unhealthy, and
the age budget. The JAX tests compare exact float losses within one
package; so do these, within the port. Then a tiny Transformer (dropout
0.1, fed by a DataLoader, through CompiledProgram) under ElasticTrainer,
resumed bitwise, and a trainer process killed with SIGKILL and resumed by
a second process, bitwise: the card's phase 16 at a tiny size.

Held against the JAX package: the public surface (``RESUME_EXIT_CODE``,
the trainer's ``health()`` keys, the cursor and step a preemption
records), on the same reader.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import elastic as jelastic
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import elastic
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    scopes = pt.executor._global_scope, fluid.executor._global_scope
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old
    pt.executor._global_scope, fluid.executor._global_scope = scopes


def _build(mod=pt, uniq=punique, lr=0.1, seed=7, dropout=0.3):
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


def _batches(n, seed=0, batch=8):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 1).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.rand(batch, 4).astype(np.float32)
        out.append({"x": x, "y": (x @ w).astype(np.float32)})
    return out


def _fresh(mod=pt):
    mod.executor._global_scope = mod.Scope()
    main, startup, loss = _build(mod, punique if mod is pt else junique)
    exe = mod.Executor(mod.CPUPlace())
    exe.run(startup)
    return main, exe, loss


def _scalar(out):
    return float(np.asarray(out[0]).ravel()[0])


def _ref_losses(batches):
    main, exe, loss = _fresh()
    return [_scalar(exe.run(main, feed=b, fetch_list=[loss]))
            for b in batches]


def _loader(main, batches, mod=pt):
    blk = main.global_block()
    return mod.reader.DataLoader(
        [blk.var("x"), blk.var("y")],
        **({"device": mod.CPUPlace()} if mod is pt else {})
    ).set_batch_generator(lambda: iter(batches))


def test_resume_bit_exact_dropout(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    bs = _batches(8)
    ref = _ref_losses(bs)
    main, exe, loss = _fresh()
    tr = elastic.ElasticTrainer(exe, ckpt, main_program=main,
                                save_every_steps=2,
                                install_signal_handler=False)
    assert tr.restore() == 0
    tr.run(iter(bs), fetch_list=[loss], max_steps=5)
    assert tr.global_step == 5
    tr.close()

    main, exe, loss = _fresh()  # everything lost but the checkpoints
    tr2 = elastic.ElasticTrainer(exe, ckpt, main_program=main,
                                 install_signal_handler=False)
    start = tr2.restore()
    assert start == 5
    resumed = []
    tr2.run(iter(bs[start:]), fetch_list=[loss],
            on_step=lambda s, o: resumed.append(_scalar(o)))
    tr2.close()
    np.testing.assert_array_equal(resumed, ref[start:])


def test_resume_bit_exact_scan_k(tmp_path):
    K = 4
    ckpt = str(tmp_path / "ckpt")
    bs = _batches(4 * K)
    supers = [{k: np.stack([g[k] for g in bs[i:i + K]]) for k in bs[0]}
              for i in range(0, len(bs), K)]
    main, exe, loss = _fresh()
    ref = []
    for sb in supers:
        ref.extend(np.asarray(exe.run(main, feed=sb, fetch_list=[loss],
                                      iterations=K)[0]).ravel().tolist())

    main, exe, loss = _fresh()
    tr = elastic.ElasticTrainer(exe, ckpt, main_program=main,
                                save_every_steps=K,
                                install_signal_handler=False)
    tr.run(iter(supers[:2]), fetch_list=[loss], iterations=K)
    assert tr.global_step == 2 * K
    tr.close()

    main, exe, loss = _fresh()
    tr2 = elastic.ElasticTrainer(exe, ckpt, main_program=main,
                                 install_signal_handler=False)
    assert tr2.restore() == 2 * K
    resumed = []
    tr2.run(iter(supers[2:]), fetch_list=[loss], iterations=K,
            on_step=lambda s, o: resumed.extend(
                np.asarray(o[0]).ravel().tolist()))
    tr2.close()
    np.testing.assert_array_equal(resumed, ref[2 * K:])


def test_dataloader_cursor_resumes_mid_epoch(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    bs = _batches(9)
    ref = _ref_losses(bs)
    main, exe, loss = _fresh()
    loader = _loader(main, bs)
    tr = elastic.ElasticTrainer(exe, ckpt, main_program=main, loader=loader,
                                save_every_steps=1,
                                install_signal_handler=False)
    tr.run(loader, fetch_list=[loss], max_steps=4, save_on_exit=False)
    tr._ckpt.wait()
    tr.close()

    main, exe, loss = _fresh()
    loader2 = _loader(main, bs)
    tr2 = elastic.ElasticTrainer(exe, ckpt, main_program=main,
                                 loader=loader2,
                                 install_signal_handler=False)
    assert tr2.restore() == 4
    assert loader2.state_dict() == {"epoch": 0, "offset": 4}
    resumed = []
    tr2.run(loader2, fetch_list=[loss],
            on_step=lambda s, o: resumed.append(_scalar(o)))
    tr2.close()
    assert len(resumed) == 5
    np.testing.assert_array_equal(resumed, ref[4:])


def test_injected_preemption_checkpoints_and_exits_resume_me(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    bs = _batches(8)
    ref = _ref_losses(bs)
    main, exe, loss = _fresh()
    tr = elastic.ElasticTrainer(exe, ckpt, main_program=main,
                                install_signal_handler=False)
    with faults.FaultPlan().fail("preemption", calls=[3],
                                 exc=elastic.Preempted):
        with pytest.raises(SystemExit) as ei:
            tr.run(iter(bs), fetch_list=[loss])
    assert ei.value.code == elastic.RESUME_EXIT_CODE
    assert tr.global_step == 3
    tr.close()

    main, exe, loss = _fresh()
    tr2 = elastic.ElasticTrainer(exe, ckpt, main_program=main,
                                 install_signal_handler=False)
    assert tr2.restore() == 3
    resumed = []
    tr2.run(iter(bs[3:]), fetch_list=[loss],
            on_step=lambda s, o: resumed.append(_scalar(o)))
    tr2.close()
    np.testing.assert_array_equal(resumed, ref[3:])


def test_preemption_keeps_cursor_and_step_consistent_as_jax(tmp_path):
    """Preemption is read before the next feed is drawn, so the
    emergency checkpoint's cursor equals its step; the JAX trainer on
    the same reader records the same step and cursor, and the resumed
    port run trains batches 3..7 exactly."""
    bs = _batches(8)
    ref = _ref_losses(bs)
    states = {}
    for mod, el in ((pt, elastic), (fluid, jelastic)):
        ckpt = str(tmp_path / mod.__name__)
        main, exe, loss = _fresh(mod)
        loader = _loader(main, bs, mod)
        tr = el.ElasticTrainer(exe, ckpt, main_program=main, loader=loader,
                               install_signal_handler=False)
        with faults.FaultPlan().fail("preemption", calls=[3],
                                     exc=el.Preempted), \
                _jax_faults().FaultPlan().fail("preemption", calls=[3],
                                               exc=el.Preempted):
            with pytest.raises(SystemExit) as ei:
                tr.run(loader, fetch_list=[loss])
        assert ei.value.code == el.RESUME_EXIT_CODE == 42
        tr.close()
        states[mod] = mod.io.read_train_state(ckpt)
    assert {k: states[pt][k] for k in ("step", "data_cursor", "version")} == \
        {k: states[fluid][k] for k in ("step", "data_cursor", "version")}
    assert states[pt]["data_cursor"]["offset"] == states[pt]["step"] == 3

    main, exe, loss = _fresh()
    loader2 = _loader(main, bs)
    tr2 = elastic.ElasticTrainer(exe, str(tmp_path / pt.__name__),
                                 main_program=main, loader=loader2,
                                 install_signal_handler=False)
    assert tr2.restore() == 3
    resumed = []
    tr2.run(loader2, fetch_list=[loss],
            on_step=lambda s, o: resumed.append(_scalar(o)))
    tr2.close()
    np.testing.assert_array_equal(resumed, ref[3:])


def _jax_faults():
    from paddle_tpu.testing import faults as jfaults
    return jfaults


def test_async_save_failure_keeps_health_degraded(tmp_path):
    main, exe, loss = _fresh()
    exe.run(main, feed=_batches(1)[0], fetch_list=[loss])
    tr = elastic.ElasticTrainer(exe, str(tmp_path / "ckpt"),
                                main_program=main, age_budget_s=0.05,
                                install_signal_handler=False)
    try:
        with faults.FaultPlan().fail("ckpt_write", calls=[0]):
            tr.checkpoint()
            tr._ckpt._thread.join()
        time.sleep(0.06)
        assert not tr.health()["healthy"]
        with pytest.raises(RuntimeError, match="async checkpoint"):
            tr._ckpt.wait()
        tr.checkpoint(wait=True)
        assert tr.health()["healthy"]
    finally:
        tr.close()


def test_sigterm_triggers_emergency_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    main, exe, loss = _fresh()
    before = signal.getsignal(signal.SIGTERM)
    tr = elastic.ElasticTrainer(exe, ckpt, main_program=main)
    try:
        def kill_at_3(step, out):
            if step == 3:
                os.kill(os.getpid(), signal.SIGTERM)

        with pytest.raises(SystemExit) as ei:
            tr.run(iter(_batches(8)), fetch_list=[loss], on_step=kill_at_3)
        assert ei.value.code == elastic.RESUME_EXIT_CODE
        assert pt.io.read_train_state(ckpt)["step"] == 3
    finally:
        tr.close()
    assert tr.preempted
    assert signal.getsignal(signal.SIGTERM) is before


def test_health_age_budget_degrades_as_jax(tmp_path):
    jmain, jexe, _ = _fresh(fluid)
    jtr = jelastic.ElasticTrainer(jexe, str(tmp_path / "j"),
                                  main_program=jmain, age_budget_s=0.05,
                                  install_signal_handler=False)
    main, exe, loss = _fresh()
    tr = elastic.ElasticTrainer(exe, str(tmp_path / "ckpt"),
                                main_program=main, age_budget_s=0.05,
                                install_signal_handler=False)
    try:
        assert tr.health()["healthy"]  # the clock starts at construction
        assert set(tr.health()) == set(jtr.health())
        time.sleep(0.08)
        h = tr.health()
        assert not h["healthy"] and h["checkpoint_age_seconds"] > 0.05
        tr.checkpoint(wait=True)
        assert tr.health()["healthy"]
    finally:
        tr.close()
        jtr.close()


def _saved_steps(tr):
    """The steps ``tr`` hands its AsyncCheckpointer, in order."""
    steps, save = [], tr._ckpt.save

    def recording(exe, ckpt, step, **kw):
        steps.append(step)
        return save(exe, ckpt, step, **kw)

    tr._ckpt.save = recording
    return steps


def test_cadence_behind_a_slow_writer_differs_from_jax(tmp_path):
    """A writer slower than the cadence (0.2 s a checkpoint, a step in
    milliseconds, every 2 steps). The port's cadence counts from the last
    save started, so it saves every 2 steps and each save joins the
    writer before it once. The JAX trainer counts from the last save
    completed, so behind such a writer it saves again at every step (each
    one joining the writer before it) until a save completes in time."""
    bs = _batches(8)
    jmain, jexe, jloss = _fresh(fluid)
    jtr = jelastic.ElasticTrainer(jexe, str(tmp_path / "j"),
                                  main_program=jmain, save_every_steps=2,
                                  install_signal_handler=False)
    main, exe, loss = _fresh()
    tr = elastic.ElasticTrainer(exe, str(tmp_path / "p"), main_program=main,
                                save_every_steps=2,
                                install_signal_handler=False)
    got, jgot = _saved_steps(tr), _saved_steps(jtr)
    try:
        with faults.FaultPlan().delay("ckpt_write", every=1, seconds=0.2):
            tr.run(iter(bs), fetch_list=[loss], save_on_exit=False)
            tr._ckpt.wait()
        with _jax_faults().FaultPlan().delay("ckpt_write", every=1,
                                             seconds=0.2):
            jtr.run(iter(bs), fetch_list=[jloss], save_on_exit=False)
            jtr._ckpt.wait()
    finally:
        tr.close()
        jtr.close()
    assert got == [2, 4, 6, 8]
    assert jgot == [2, 3, 4, 5, 6, 7, 8]
    assert pt.io.read_train_state(str(tmp_path / "p"))["step"] == 8
    assert tr.health()["last_checkpoint_step"] == 8


# ---------------------------------------------------------------------------
# a tiny Transformer, and a SIGKILL across processes
# ---------------------------------------------------------------------------

TINY = dict(n_layer=1, n_head=2, d_model=16, d_inner_hid=32, src_vocab=50,
            tgt_vocab=50, max_len=8)


def _transformer_reader(cfg, epoch_batches=6, batch=4):
    """An epoch-seeded synthetic reader: the same batches each epoch."""
    def reader():
        for i in range(epoch_batches):
            f = ptransformer.make_fake_batch(batch, cfg, seed=100 + i)
            f["trg_len"] = np.array([8, 5, 7, 3][:batch], np.int32)
            yield f
    return reader


def _transformer_run(ckpt, steps, kill_after=None):
    """Train ``steps`` global steps of the tiny dropout Transformer under
    ElasticTrainer from ``ckpt``; returns (losses by step, persistables)."""
    pt.executor._global_scope = pt.Scope()
    with punique.guard():
        m = ptransformer.build(dropout_rate=0.1, warmup_steps=2, **TINY)
    m["startup"].random_seed = m["main"].random_seed = 5
    exe = pt.Executor(pt.CPUPlace())
    exe.run(m["startup"])
    blk = m["main"].global_block()
    loader = pt.reader.DataLoader(
        [blk.var(n) for n in m["feeds"]], device=pt.CPUPlace()
    ).set_batch_generator(_transformer_reader(m["config"]))
    target = pt.CompiledProgram(m["main"])
    tr = elastic.ElasticTrainer(exe, ckpt, main_program=target,
                                loader=loader, save_every_steps=3,
                                install_signal_handler=False)
    start = tr.restore()
    losses = {}

    def on_step(s, o):
        losses[s] = _scalar(o)
        if kill_after is not None and s == kill_after:
            raise KeyboardInterrupt  # the process dies here, no final save

    try:
        while tr.global_step < steps:
            tr.run(loader, fetch_list=[m["loss"]], max_steps=steps,
                   on_step=on_step, save_on_exit=False)
    except KeyboardInterrupt:
        tr._ckpt.wait()
    tr.close()
    state = {v.name: pt.global_scope().find_var(v.name).numpy().copy()
             for v in m["main"].list_vars() if v.persistable}
    return start, losses, state


def test_tiny_transformer_resumes_bitwise(tmp_path):
    """Dropout 0.1, a DataLoader over two epochs, CompiledProgram: cut at
    step 8 (checkpoints at 3 and 6, the cursor inside epoch 1), resumed
    from step 6 to 12, bitwise the uninterrupted run's losses and every
    persistable."""
    _, ref, ref_state = _transformer_run(str(tmp_path / "a"), 12)
    start0, first, _ = _transformer_run(str(tmp_path / "b"), 12,
                                        kill_after=8)
    assert start0 == 0 and sorted(first) == list(range(1, 9))
    state = pt.io.read_train_state(str(tmp_path / "b"))
    assert state["step"] == 6
    # taken after step 6, before the loader saw the end of epoch 0
    assert state["data_cursor"] == {"epoch": 0, "offset": 6}
    start, resumed, got = _transformer_run(str(tmp_path / "b"), 12)
    assert start == 6 and sorted(resumed) == list(range(7, 13))
    for s in range(1, 13):
        assert (resumed if s > 6 else first)[s] == ref[s], s
    for n, v in ref_state.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)


_CHILD = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, {repo!r})
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import elastic
    ckpt, steps, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = main.random_seed = 7
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4])
        y = pt.layers.data("y", shape=[1])
        h = pt.layers.dropout(pt.layers.fc(x, size=8, act="relu"), 0.3)
        loss = pt.layers.mean(pt.layers.square_error_cost(
            pt.layers.fc(h, size=1), y))
        pt.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(100000):
            xb = rng.rand(8, 4).astype(np.float32)
            yield xb, xb.sum(1, keepdims=True).astype(np.float32)

    loader = pt.reader.DataLoader([main.global_block().var("x"),
                                   main.global_block().var("y")],
                                  device=pt.CPUPlace())
    loader.set_batch_generator(reader)
    tr = elastic.ElasticTrainer(exe, ckpt, main_program=main, loader=loader,
                                save_every_steps=4)
    start = tr.restore()
    log = open(out, "a")

    def on_step(s, o):
        log.write(json.dumps([s, float(o[0].ravel()[0])]) + "\\n")
        log.flush()

    tr.run(loader, fetch_list=[loss], max_steps=steps, on_step=on_step)
    tr.close()
    params = {{v.name: pt.global_scope().find_var(v.name).numpy().tolist()
              for v in main.list_vars() if v.persistable}}
    json.dump({{"start": start, "params": params}}, open(out + ".end", "w"))
""")


def _spawn(script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, script, *map(str, args)],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


def _log(path):
    """{step: loss} of a child's log (a line cut by the kill is left)."""
    import json
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    s, v = json.loads(line)
                except ValueError:
                    continue
                out[s] = v
    return out


def test_sigkill_and_resume_across_processes(tmp_path):
    """A trainer process SIGKILLed once a checkpoint of step 8 or later
    is marked and it has gone past it; a second process resumes; a third
    runs uninterrupted: the resumed losses and final persistables
    bitwise."""
    import json
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=REPO))
    ckpt, log = tmp_path / "ckpt", str(tmp_path / "killed.log")
    steps = 100000  # the kill lands well before the end
    child = _spawn(script, ckpt, steps, log)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:  # the child's retention may remove a directory meanwhile
                marked = (pt.io.read_train_state(str(ckpt)) or {}).get(
                    "step", 0)
            except OSError:
                marked = 0
            if marked >= 8 and max(_log(log), default=0) > marked:
                break
            if child.poll() is not None:
                raise AssertionError(child.stderr.read().decode()[-2000:])
            time.sleep(0.01)
        child.send_signal(signal.SIGKILL)
    finally:
        child.wait(timeout=60)
    assert child.returncode == -signal.SIGKILL
    killed_at = max(_log(log))
    assert 8 < killed_at < steps
    end = 24 if killed_at < 20 else killed_at + 8
    resumed_log, ref_log = str(tmp_path / "resumed.log"), str(tmp_path /
                                                               "ref.log")
    for args in ((ckpt, end, resumed_log), (tmp_path / "ref", end, ref_log)):
        p = _spawn(script, *args)
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    resumed, ref = _log(resumed_log), _log(ref_log)
    res_end = json.load(open(resumed_log + ".end"))
    ref_end = json.load(open(ref_log + ".end"))
    start = res_end["start"]
    # the cadence: a checkpoint every 4 steps from the last one started
    assert 8 <= start < killed_at and start % 4 == 0
    assert sorted(resumed) == list(range(start + 1, end + 1))
    assert all(resumed[s] == ref[s] for s in resumed)
    assert res_end["params"] == ref_end["params"]
