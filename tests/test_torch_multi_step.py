"""The port's plans, ``run(iterations=K)``, ``FetchHandle`` and its state
updates in place, against the JAX package's executor on the CPU.

Mirrors tests/test_multi_step_run.py with Adam and momentum in place of
SGD, which the port does not have. A small regression model (fc, square
error, mean) trains from the JAX package's startup values, carried over
as numpy arrays. K steps in one run are held against the JAX package's
``run(iterations=K)`` at tests/test_torch_training.py's fp32 tolerances
(losses within 1e-5 relative, parameters within 2e-5: the two sum in
other orders), and against K single runs of the port bitwise (the same
ops on the same values). The Transformer cases run tests/
test_torch_compiled.py's tiny unfused build under bench.py's
BuildStrategy, at that file's tolerances (losses rtol 2e-4, atol 1e-5;
parameters rtol 2e-3, atol 2e-5). On the CPU every run is eager: the
plan and its in-place state binding are the ones a card captures, and
the capture itself runs only on the card (chip_smoke.py phase 11)."""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.executor import FetchHandle, snapshot_value
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

K = 4
BATCH = 8
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=0, atol=2e-5)
CPU = pt.CPUPlace()


@pytest.fixture(autouse=True)
def _flags():
    old = (JFLAGS.op_callstack, PFLAGS.op_callstack, PFLAGS.jit_cache)
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack, PFLAGS.jit_cache = old


def _optimizer(mod, kind):
    if kind == "adam":
        return mod.optimizer.AdamOptimizer(learning_rate=0.05)
    return mod.optimizer.MomentumOptimizer(learning_rate=0.05, momentum=0.9)


def _build(mod, kind, print_loss=False):
    main, startup = mod.Program(), mod.Program()
    startup.random_seed = main.random_seed = 7
    with mod.program_guard(main, startup):
        x = mod.layers.data("x", shape=[4])
        y = mod.layers.data("y", shape=[1])
        pred = mod.layers.fc(x, size=1)
        diff = mod.layers.elementwise_add(
            pred, mod.layers.scale(y, scale=-1.0))
        loss = mod.layers.mean(mod.layers.elementwise_mul(diff, diff))
        _optimizer(mod, kind).minimize(loss)
        if print_loss:
            mod.layers.Print(loss, message="fallback")
    return main, startup, loss


def _super_batch(seed=0, k=K):
    rng = np.random.RandomState(seed)
    xs = rng.randn(k, BATCH, 4).astype(np.float32)
    w = rng.randn(4, 1).astype(np.float32)
    return xs, np.einsum("kbi,ij->kbj", xs, w).astype(np.float32)


def _jax(kind, xs, ys, iterations):
    """The JAX package's run: its startup state and the stacked losses
    and final persistables of one run(iterations=K) (or K single runs)."""
    with junique.guard(), fluid.scope_guard(fluid.Scope()):
        main, startup, loss = _build(fluid, kind)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        scope = fluid.global_scope()
        names = [v.name for v in main.list_vars() if v.persistable]
        init = {n: np.array(scope.find_var(n)) for n in names}
        if iterations > 1:
            (losses,) = exe.run(main, feed={"x": xs, "y": ys},
                                fetch_list=[loss], iterations=iterations)
        else:
            losses = np.stack([np.asarray(exe.run(
                main, feed={"x": xs[k], "y": ys[k]}, fetch_list=[loss])[0])
                for k in range(len(xs))])
        return init, np.asarray(losses), {
            n: np.array(scope.find_var(n)) for n in names}


def _port(kind, init, print_loss=False):
    """The port's program, loss and a scope holding ``init``."""
    with punique.guard():
        main, startup, loss = _build(pt, kind, print_loss)
    scope = pt.Scope()
    pt.io.set_params_from_numpy(scope, init, "cpu", program=main)
    return main, loss, scope


def _state(main, scope):
    return {v.name: scope.find_var(v.name).numpy().copy()
            for v in main.list_vars() if v.persistable}


@pytest.mark.parametrize("kind", ["adam", "momentum"])
def test_k_steps_match_the_jax_packages_k_steps(kind):
    xs, ys = _super_batch()
    init, jlosses, jstate = _jax(kind, xs, ys, K)
    main, loss, scope = _port(kind, init)
    (losses,) = pt.Executor(CPU).run(main, feed={"x": xs, "y": ys},
                                     fetch_list=[loss], scope=scope,
                                     iterations=K)
    assert losses.shape == jlosses.shape == (K, 1)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    got = _state(main, scope)
    assert sorted(got) == sorted(jstate)
    for n in jstate:
        np.testing.assert_allclose(got[n], jstate[n], err_msg=n, **PARAM_TOL)


@pytest.mark.parametrize("kind", ["adam", "momentum"])
def test_k_steps_equal_k_single_runs_bitwise(kind):
    xs, ys = _super_batch(1)
    init, _, _ = _jax(kind, xs[:1], ys[:1], 1)
    exe = pt.Executor(CPU)
    main, loss, single = _port(kind, init)
    seq = np.stack([exe.run(main, feed={"x": xs[k], "y": ys[k]},
                            fetch_list=[loss], scope=single)[0]
                    for k in range(K)])
    main2, loss2, fused = _port(kind, init)
    (stacked,) = exe.run(main2, feed={"x": xs, "y": ys}, fetch_list=[loss2],
                         scope=fused, iterations=K)
    np.testing.assert_array_equal(stacked, seq)
    want, got = _state(main, single), _state(main2, fused)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_one_plan_per_version_k_and_signature():
    xs, ys = _super_batch(2)
    init, _, _ = _jax("adam", xs[:1], ys[:1], 1)
    main, loss, scope = _port("adam", init)
    exe = pt.Executor(CPU)
    cache = lambda: main.__dict__.get("_exec_cache", {})  # noqa: E731
    for _ in range(2):
        exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss],
                scope=scope, iterations=K)
    assert len(cache()) == 1
    (plan,) = cache().values()
    exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss], scope=scope,
            iterations=K)
    assert list(cache().values()) == [plan]
    # K is in the key; so is the feed signature (batch 4 against 8)
    exe.run(main, feed={"x": xs[:2], "y": ys[:2]}, fetch_list=[loss],
            scope=scope, iterations=2)
    exe.run(main, feed={"x": xs[:, :4], "y": ys[:, :4]}, fetch_list=[loss],
            scope=scope, iterations=K)
    assert sorted(key[4] for key in cache()) == [2, K, K]
    # a program change, and another scope, each give a plan of their own
    main._bump()
    exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss],
            scope=scope)
    exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss],
            scope=_port("adam", init)[2])
    assert len(cache()) == 5
    assert len({key[0] for key in cache()}) == 2
    exe.close()
    assert cache() == {}
    PFLAGS.jit_cache = False
    exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss],
            scope=scope)
    assert cache() == {}


def test_plans_of_a_scope_that_is_gone_are_dropped():
    xs, ys = _super_batch(3)
    init, _, _ = _jax("momentum", xs[:1], ys[:1], 1)
    main, loss, scope = _port("momentum", init)
    exe = pt.Executor(CPU)
    exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss],
            scope=scope)
    del scope
    exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss],
            scope=_port("momentum", init)[2])
    assert len(main.__dict__["_exec_cache"]) == 1


def test_fetch_handle_reads_on_demand_and_stays_on_the_device_when_fed():
    xs, ys = _super_batch(4)
    init, _, _ = _jax("adam", xs[:1], ys[:1], 1)
    main, loss, scope = _port("adam", init)
    exe = pt.Executor(CPU)
    (h,) = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss],
                   scope=scope, iterations=K, return_numpy=False)
    assert isinstance(h, FetchHandle) and isinstance(pt.FetchHandle, type)
    assert h.shape == (K, 1) and len(h) == K and h.ndim == 2
    assert h.dtype == np.float32
    assert h._np is None, "shape and dtype must not read the value"
    with pytest.raises(TypeError):
        float(h)  # a K-step fetch must not collapse to one step
    arr = np.asarray(h)
    np.testing.assert_array_equal(arr, h.numpy())
    np.testing.assert_array_equal(h[1], arr[1])
    # a handle fed back stays a tensor: no read to the host
    (x_handle,) = exe.run(main, feed={"x": xs[0], "y": ys[0]},
                          fetch_list=["x"], scope=scope, return_numpy=False)
    (again,) = exe.run(main, feed={"x": x_handle, "y": ys[0]},
                       fetch_list=["x"], scope=scope, return_numpy=False)
    assert x_handle._np is None
    assert isinstance(again.device_value(), torch.Tensor)
    np.testing.assert_array_equal(again.numpy(), xs[0])


def test_state_is_updated_in_place_and_fetches_do_not_alias_it():
    xs, ys = _super_batch(5)
    init, _, _ = _jax("adam", xs[:1], ys[:1], 1)
    main, loss, scope = _port("adam", init)
    exe = pt.Executor(CPU)
    w = main.all_parameters()[0].name
    tensor = scope.find_var(w)
    (before,) = exe.run(main, feed={"x": xs[0], "y": ys[0]},
                        fetch_list=[w], scope=scope, return_numpy=False)
    first = before.numpy().copy()
    snap = snapshot_value(tensor)
    kept = tensor.numpy().copy()
    exe.run(main, feed={"x": xs[1], "y": ys[1]}, fetch_list=[loss],
            scope=scope)
    assert scope.find_var(w) is tensor, "the update rebound the scope name"
    np.testing.assert_array_equal(before.numpy(), first)
    assert not np.array_equal(tensor.numpy(), first)
    assert not np.array_equal(tensor.numpy(), kept)
    np.testing.assert_array_equal(snap.numpy(), kept)


def test_set_var_between_runs_is_honoured():
    xs, ys = _super_batch(6)
    init, _, _ = _jax("momentum", xs[:1], ys[:1], 1)
    exe = pt.Executor(CPU)
    main, loss, scope = _port("momentum", init)
    for k in range(2):
        exe.run(main, feed={"x": xs[k], "y": ys[k]}, fetch_list=[loss],
                scope=scope)
    other = {n: v * 0.5 for n, v in init.items()}
    pt.io.set_params_from_numpy(scope, other, "cpu", program=main)
    got = exe.run(main, feed={"x": xs[2], "y": ys[2]}, fetch_list=[loss],
                  scope=scope)[0]
    main2, loss2, fresh = _port("momentum", other)
    want = exe.run(main2, feed={"x": xs[2], "y": ys[2]}, fetch_list=[loss2],
                   scope=fresh)[0]
    np.testing.assert_array_equal(got, want)
    for n in other:
        np.testing.assert_array_equal(scope.find_var(n).numpy(),
                                      fresh.find_var(n).numpy(), err_msg=n)


def test_host_op_block_falls_back_with_reason(capsys):
    xs, ys = _super_batch(7)
    init, _, _ = _jax("adam", xs[:1], ys[:1], 1)
    exe = pt.Executor(CPU)
    main, loss, single = _port("adam", init)
    seq = np.stack([exe.run(main, feed={"x": xs[k], "y": ys[k]},
                            fetch_list=[loss], scope=single)[0]
                    for k in range(K)])
    main2, loss2, scope = _port("adam", init, print_loss=True)
    assert "print" in [op.type for op in main2.global_block().desc.ops]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (stacked,) = exe.run(main2, feed={"x": xs, "y": ys},
                             fetch_list=[loss2], scope=scope, iterations=K)
    assert any("falling back" in str(w.message) for w in caught)
    assert exe.fuse_fallbacks == 1
    assert stacked.shape == (K, 1)
    np.testing.assert_array_equal(stacked, seq)
    for n, v in _state(main, single).items():
        np.testing.assert_array_equal(scope.find_var(n).numpy(), v,
                                      err_msg=n)
    assert capsys.readouterr().out.count("fallback") == K


def test_fed_handles_stay_on_the_device_in_the_fallback(monkeypatch):
    """A [K, ...] FetchHandle fed to a block with host ops is sliced as a
    tensor for each single step, never read to the host."""
    xs, ys = _super_batch(10)
    init, _, _ = _jax("adam", xs[:1], ys[:1], 1)
    exe = pt.Executor(CPU)
    main, loss, scope = _port("adam", init, print_loss=True)
    main2, loss2, plain = _port("adam", init, print_loss=True)
    want = [exe.run(main2, feed={"x": xs[k], "y": ys[k]},
                    fetch_list=[loss2], scope=plain)[0] for k in range(K)]
    feed = {"x": snapshot_value(torch.from_numpy(xs)),
            "y": snapshot_value(torch.from_numpy(ys))}

    def read(*args, **kwargs):
        raise AssertionError("a fed FetchHandle was read to the host")
    for name in ("numpy", "__array__", "__getitem__"):
        monkeypatch.setattr(FetchHandle, name, read)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (stacked,) = exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope, iterations=K, return_numpy=False)
    monkeypatch.undo()
    assert exe.fuse_fallbacks == 1
    assert all(h._np is None for h in feed.values())
    np.testing.assert_array_equal(stacked.numpy(), np.stack(want))


def test_print_runs_between_device_segments(capsys):
    xs, ys = _super_batch(8)
    init, _, _ = _jax("adam", xs[:1], ys[:1], 1)
    exe = pt.Executor(CPU)
    main, loss, scope = _port("adam", init, print_loss=True)
    main2, loss2, plain = _port("adam", init)
    got = exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss],
                  scope=scope)[0]
    want = exe.run(main2, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss2],
                   scope=plain)[0]
    np.testing.assert_array_equal(got, want)
    out = capsys.readouterr().out
    assert "fallback shape=[1] dtype=float32" in out
    (plan,) = main.__dict__["_exec_cache"].values()
    assert [kind for kind, _ in plan.segments] == ["device", "host"]


def test_super_batch_shape_validated():
    xs, ys = _super_batch(9)
    init, _, _ = _jax("adam", xs[:1], ys[:1], 1)
    main, loss, scope = _port("adam", init)
    with pytest.raises(ValueError, match="leading axis"):
        pt.Executor(CPU).run(main, feed={"x": xs[0], "y": ys[0]},
                             fetch_list=[loss], scope=scope, iterations=K)


def test_random_ops_advance_the_generator_as_single_runs_do():
    def build():
        main, startup = pt.Program(), pt.Program()
        main.random_seed = 11
        with pt.program_guard(main, startup):
            blk = main.global_block()
            noise = blk.create_var(name="noise", shape=[3, 5],
                                   dtype="float32")
            blk.append_op(type="uniform_random", outputs={"Out": [noise]},
                          attrs={"shape": [3, 5], "min": -1.0, "max": 1.0,
                                 "seed": 0})
            x = pt.layers.data("x", shape=[5])
            out = pt.layers.elementwise_add(x, noise)
        return main, out

    exe = pt.Executor(CPU)
    xs = np.random.RandomState(0).rand(K, 3, 5).astype(np.float32)
    main, out = build()
    scope = pt.Scope()
    seq = [exe.run(main, feed={"x": xs[k]}, fetch_list=[out, "noise"],
                   scope=scope) for k in range(K)]
    assert not np.array_equal(seq[0][1], seq[1][1])
    main2, out2 = build()
    got = exe.run(main2, feed={"x": xs}, fetch_list=[out2, "noise"],
                  scope=pt.Scope(), iterations=K)
    np.testing.assert_array_equal(got[0], np.stack([s[0] for s in seq]))
    np.testing.assert_array_equal(got[1], np.stack([s[1] for s in seq]))


# ---------------------------------------------------------------------------
# num_iteration_per_run through CompiledProgram, the bench BuildStrategy
# ---------------------------------------------------------------------------

TINY = dict(src_vocab=50, tgt_vocab=50, max_len=8, n_layer=1, n_head=2,
            d_model=32, d_inner_hid=64, warmup_steps=4)
T_LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
T_PARAM_TOL = dict(rtol=2e-3, atol=2e-5)


def _bench_strategy(mod):
    bs = mod.BuildStrategy()
    bs.fuse_all_optimizer_ops = True
    bs.fuse_elewise_add_act_ops = True
    bs.memory_optimize = True
    bs.fuse_conv_ops = True
    bs.fuse_attention_ops = True
    return bs


def _t_batches():
    feeds = []
    for s in range(K):
        f = ptransformer.make_fake_batch(2, {**TINY, "max_len": 8}, seed=s)
        f["src_len"] = np.array([8, 5], np.int32)
        f["trg_len"] = np.array([6, 8], np.int32)
        feeds.append(f)
    return {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}


def test_num_iteration_per_run_matches_the_jax_package():
    old = (JFLAGS.fuse_optimizer_ops_on_cpu, PFLAGS.fuse_optimizer_ops_on_cpu)
    JFLAGS.fuse_optimizer_ops_on_cpu = PFLAGS.fuse_optimizer_ops_on_cpu = True
    try:
        sup = _t_batches()
        with junique.guard():
            j = jtransformer.build(dropout_rate=0.0, attention_impl="unfused",
                                   **TINY)
        jscope = fluid.Scope()
        j["startup"].random_seed = 7
        jexe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(jscope):
            jexe.run(j["startup"])
        with punique.guard():
            p = ptransformer.build(attention_impl="unfused", **TINY)
        names = [v.name for v in p["main"].list_vars() if v.persistable]
        scope = pt.Scope()
        pt.io.set_params_from_numpy(
            scope, {n: np.asarray(jscope.find_var(n)) for n in names}, "cpu",
            program=p["main"])
        jcp = fluid.CompiledProgram(j["main"],
                                    build_strategy=_bench_strategy(fluid))
        jcp._exec_strategy.num_iteration_per_run = K
        with fluid.scope_guard(jscope):
            (jlosses,) = jexe.run(jcp, feed=sup, fetch_list=[j["loss"]])
        cp = pt.CompiledProgram(p["main"], build_strategy=_bench_strategy(pt))
        cp._exec_strategy.num_iteration_per_run = K
        exe = pt.Executor(CPU)
        (losses,) = exe.run(cp, feed=sup, fetch_list=[p["loss"]],
                            scope=scope)
        assert np.shape(losses)[0] == K
        np.testing.assert_allclose(losses.reshape(K, -1),
                                   np.asarray(jlosses).reshape(K, -1),
                                   **T_LOSS_TOL)
        for v in p["main"].all_parameters():
            np.testing.assert_allclose(
                scope.find_var(v.name).numpy(),
                np.asarray(jscope.find_var(v.name)), err_msg=v.name,
                **T_PARAM_TOL)
        ops = [o.type for o in exe.lowered_ops(cp, [p["loss"]])]
        assert "fused_adam" in ops and "flash_attention" in ops
    finally:
        JFLAGS.fuse_optimizer_ops_on_cpu, PFLAGS.fuse_optimizer_ops_on_cpu = old
