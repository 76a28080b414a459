"""The port's readers on the CPU, against the JAX package's: the
decorators of ``paddle_tpu_torch.reader`` (the same items in the same
order from the same reader; ``shuffle`` under the same ``random`` seed),
the DataLoader (its batches, super-batches and cursor equal to the JAX
DataLoader's on the same reader, its fast-forward after
``load_state_dict``, its producer's errors), and the program-level
reader: ``py_reader``/``read_file``/``double_buffer``/
``create_py_reader_by_data`` with the ``create_py_reader`` and ``read``
host ops, the scenarios of tests/test_py_reader.py run through the port
and a training run fed by the reader held against the same run fed by
feed dicts, bitwise (the JAX package's test keeps only its count and
trend). The ``read`` op is a host op: the plan splits there, and the
device segment after it is captured on the card (``cuda``-marked test).
"""

import random

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import core as pcore
from paddle_tpu_torch import reader as preader
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS


@pytest.fixture(autouse=True)
def _isolated():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    scope = pt.executor._global_scope
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old
    pt.executor._global_scope = scope


def _items(n=23):
    def reader():
        for i in range(n):
            yield (i, float(i) / 3)
    return reader


def _list(reader):
    return [tuple(np.asarray(v).tolist() for v in item)
            if isinstance(item, tuple) else item for item in reader()]


DECORATED = {
    "map_readers": lambda d: d.map_readers(lambda a, b: (a[0] + b[0], a[1]),
                                           _items(), _items(7)),
    "chain": lambda d: d.chain(_items(3), _items(5)),
    "compose": lambda d: d.compose(_items(6), _items(6)),
    "compose_unaligned": lambda d: d.compose(_items(3), _items(5),
                                             check_alignment=False),
    "buffered": lambda d: d.buffered(_items(), 4),
    "firstn": lambda d: d.firstn(_items(), 5),
    "cache": lambda d: d.cache(_items(9)),
    "batch": lambda d: d.batch(_items(), 5),
    "batch_drop_last": lambda d: d.batch(_items(), 5, drop_last=True),
    "xmap_ordered": lambda d: d.xmap_readers(lambda s: (s[0] * 2, s[1]),
                                             _items(), 3, 4, order=True),
}


@pytest.mark.parametrize("name", sorted(DECORATED))
def test_decorator_matches_jax(name):
    from paddle_tpu.reader import decorator as jdec
    from paddle_tpu_torch.reader import decorator as pdec
    got, want = (_list(DECORATED[name](d)) for d in (pdec, jdec))
    assert got == want and got


def test_shuffle_and_unordered_xmap_match_jax():
    from paddle_tpu.reader import decorator as jdec
    from paddle_tpu_torch.reader import decorator as pdec
    out = []
    for d in (pdec, jdec):
        random.seed(3)
        out.append(_list(d.shuffle(_items(), 6)))
    assert out[0] == out[1] and out[0] != _list(_items())
    got = sorted(_list(pdec.xmap_readers(lambda s: s, _items(), 3, 4)))
    assert got == sorted(_list(_items()))


def test_compose_raises_when_not_aligned():
    with pytest.raises(preader.ComposeNotAligned):
        _list(preader.compose(_items(3), _items(5)))


def test_fake_replays_the_first_item_as_jax():
    from paddle_tpu.reader import decorator as jdec
    outs = []
    for d in (preader, jdec):
        fake = d.Fake()
        r = fake(_items(), 4)
        outs.append([_list(r), _list(r)])
    assert outs[0] == outs[1] == [[(0, 0.0)] * 4] * 2


def test_multiprocess_reader_and_pipe_reader():
    got = sorted(preader.multiprocess_reader([_items(4), _items(3)])())
    assert got == sorted(list(_items(4)()) + list(_items(3)()))
    lines = list(preader.PipeReader("printf a\\nbb\\nccc").get_line())
    assert lines == ["a", "bb", "ccc"]


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------

def _feed_vars(mod):
    main = mod.Program()
    with mod.program_guard(main, mod.Program()):
        x = mod.layers.data("x", shape=[3], dtype="float32")
        y = mod.layers.data("y", shape=[1], dtype="int64")
    return [x, y]


def _batch_reader(n=7, seed=0):
    def reader():
        rng = np.random.RandomState(seed)
        for i in range(n):
            yield (rng.rand(4, 3).astype(np.float64),   # cast to float32
                   np.full((4, 1), i, np.int64))
    return reader


def _take(loader, limit=None):
    out = []
    for i, feed in enumerate(loader):
        out.append({k: np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                  else v) for k, v in feed.items()})
        if limit is not None and i + 1 == limit:
            break
    return out


def _loaders(**kw):
    p = preader.DataLoader(_feed_vars(pt), device=pt.CPUPlace(), **kw)
    j = fluid.reader.DataLoader(_feed_vars(fluid), **kw)
    return p, j


def _same_batches(a, b):
    assert len(a) == len(b) and a
    for fa, fb in zip(a, b):
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fa[k].dtype == fb[k].dtype or (
                fa[k].dtype == np.int64 and fb[k].dtype == np.int32), k
            np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("steps_per_batch", [1, 3])
def test_data_loader_matches_jax(steps_per_batch):
    """Batches (3-step super-batches with their 1-batch tail), dtypes and
    the cursor through two epochs, a break mid-epoch and a resume."""
    p, j = _loaders(steps_per_batch=steps_per_batch)
    for loader in (p, j):
        loader.set_batch_generator(_batch_reader())
    for _ in range(2):
        _same_batches(_take(p), _take(j))
        assert p.state_dict() == j.state_dict()
    _same_batches(_take(p, 2), _take(j, 2))
    assert p.state_dict() == j.state_dict() == {
        "epoch": 2, "offset": 2 * steps_per_batch}
    p2, j2 = _loaders(steps_per_batch=steps_per_batch)
    for loader in (p2, j2):
        loader.set_batch_generator(_batch_reader())
        loader.load_state_dict(p.state_dict())
    _same_batches(_take(p2), _take(j2))
    assert p2.state_dict() == j2.state_dict() == {"epoch": 3, "offset": 0}


def test_data_loader_sample_lists_and_dicts_match_jax():
    def samples():
        for i in range(6):
            yield [(np.full(3, i, np.float32), np.array([i], np.int64))
                   for _ in range(2)]

    def dicts():
        for i in range(3):
            yield {"x": np.full((2, 3), i, np.float32),
                   "y": np.full((2, 1), i, np.int64)}

    p, j = _loaders()
    p.set_sample_list_generator(samples)
    j.set_sample_list_generator(samples)
    _same_batches(_take(p), _take(j))
    p.set_batch_generator(dicts)
    j.set_batch_generator(dicts)
    _same_batches(_take(p), _take(j))


def test_data_loader_yields_tensors_on_its_device_and_raises_errors():
    loader = preader.DataLoader(_feed_vars(pt), device=pt.CPUPlace())

    def bad():
        yield np.zeros((2, 3), np.float32), np.zeros((2, 1), np.int64)
        raise ValueError("corrupt record")

    loader.set_batch_generator(bad)
    it = iter(loader)
    first = next(it)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in first.values())
    assert first["x"].dtype == torch.float32
    with pytest.raises(ValueError, match="corrupt"):
        next(it)
    with pytest.raises(NotImplementedError, match="A12"):
        preader.DataLoader(_feed_vars(pt), device=pt.CPUPlace(),
                           sharding={"x": None})


def test_data_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device is there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preader.DataLoader(_feed_vars(pt))


@pytest.mark.cuda
def test_data_loader_on_the_card_orders_its_copies():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the copy stream and pinned "
                    "buffers have no CPU mode")
    loader = preader.DataLoader(_feed_vars(pt), capacity=2)
    loader.set_batch_generator(_batch_reader(n=20))
    want = _take(preader.DataLoader(_feed_vars(pt), device=pt.CPUPlace())
                 .set_batch_generator(_batch_reader(n=20)))
    got = []
    for feed in loader:
        assert feed["x"].is_cuda
        got.append({k: (v * 1).cpu().numpy() for k, v in feed.items()})
    _same_batches(got, want)


# ---------------------------------------------------------------------------
# the program-level reader
# ---------------------------------------------------------------------------

def _dataset(n_batches, batch, seed=0):
    def source():
        rng = np.random.RandomState(seed)
        w = np.array([[2.0], [-1.0]], np.float32)
        for _ in range(n_batches):
            x = rng.rand(batch, 2).astype(np.float32)
            yield x, x @ w + 0.5
    return source


def _reader_program(mod=pt, uniq=punique, name="train_reader", feeds=False):
    main, startup = mod.Program(), mod.Program()
    main.random_seed = startup.random_seed = 3
    with uniq.guard(), mod.program_guard(main, startup):
        if feeds:
            x = mod.layers.data("x", shape=[2])
            y = mod.layers.data("y", shape=[1])
            reader = None
        else:
            reader = mod.layers.py_reader(
                capacity=4, shapes=[[-1, 2], [-1, 1]],
                dtypes=["float32", "float32"], name=name)
            x, y = mod.layers.read_file(reader)
        pred = mod.layers.fc(x, size=1)
        loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
        mod.optimizer.SGDOptimizer(learning_rate=0.5).minimize(loss)
    return main, startup, reader, loss


def _epoch(exe, main, reader, loss):
    losses = []
    reader.start()
    while True:
        try:
            (l,) = exe.run(main, fetch_list=[loss])
            losses.append(float(l.ravel()[0]))
        except pcore.EOFException:
            reader.reset()
            return losses


def test_reader_programs_match_jax():
    jm, js, _, _ = _reader_program(fluid, junique)
    pm, ps, _, _ = _reader_program(pt, punique)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    assert ps.desc.to_bytes() == js.desc.to_bytes()
    fm, fs, _, _ = _reader_program(fluid, junique, feeds=True)
    with junique.guard(), fluid.program_guard(fluid.Program(),
                                              fluid.Program()):
        jr = fluid.layers.create_py_reader_by_data(2, [
            fm.global_block().var("x"), fm.global_block().var("y")],
            name="by_data")
    pm2, _, _, _ = _reader_program(pt, punique, feeds=True)
    with punique.guard(), pt.program_guard(pt.Program(), pt.Program()) :
        pr = pt.layers.create_py_reader_by_data(2, [
            pm2.global_block().var("x"), pm2.global_block().var("y")],
            name="by_data")
    assert (pr.shapes, pr.dtypes) == (jr.shapes, jr.dtypes)
    assert pr._create_op.desc.attrs == jr._create_op.desc.attrs


def test_py_reader_trains_as_the_feed_dict_run():
    """12 batches read by the program, EOF at the end: bitwise the same
    12 steps fed as dicts (the JAX test holds only the count and the
    trend, both kept here)."""
    pt.executor._global_scope = pt.Scope()
    main, startup, reader, loss = _reader_program()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    reader.decorate_batch_generator(_dataset(12, 16))
    losses = _epoch(exe, main, reader, loss)
    assert len(losses) == 12 and losses[-1] < losses[0]
    pt.executor._global_scope = pt.Scope()
    fmain, fstart, _, floss = _reader_program(feeds=True)
    exe.run(fstart)
    want = [float(exe.run(fmain, feed={"x": x, "y": y},
                          fetch_list=[floss])[0].ravel()[0])
            for x, y in _dataset(12, 16)()]
    assert losses == want


def test_py_reader_multi_epoch_and_restart():
    pt.executor._global_scope = pt.Scope()
    main, startup, reader, loss = _reader_program()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    reader.decorate_batch_generator(_dataset(3, 8))
    for epoch in range(3):
        assert len(_epoch(exe, main, reader, loss)) == 3, epoch


def test_py_reader_paddle_reader_decorator():
    pt.executor._global_scope = pt.Scope()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        reader = pt.layers.py_reader(
            capacity=2, shapes=[[-1, 3], [-1, 1]],
            dtypes=["float32", "int64"], name="sample_reader")
        x, y = pt.layers.read_file(reader)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)

    def samples():
        rng = np.random.RandomState(1)
        for i in range(10):
            yield rng.rand(3).astype(np.float32), np.array([i % 2], np.int64)

    reader.decorate_paddle_reader(pt.batch(samples, batch_size=5))
    reader.start()
    xb, yb = exe.run(main, fetch_list=[x, y])
    assert xb.shape == (5, 3) and yb.shape == (5, 1)
    assert yb.dtype == np.int64
    reader.reset()


def test_double_buffer_sets_the_flag_in_the_startup_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        reader = pt.layers.py_reader(
            capacity=2, shapes=[[-1, 2]], dtypes=["float32"],
            name="db_reader", use_double_buffer=False)
        pt.layers.double_buffer(reader)
    assert reader.use_double_buffer
    assert startup.global_block().desc.ops[-1].attrs["use_double_buffer"]


def test_producer_error_propagates():
    pt.executor._global_scope = pt.Scope()
    main, startup, reader, loss = _reader_program()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)

    def bad_source():
        yield np.zeros((4, 2), np.float32), np.zeros((4, 1), np.float32)
        raise ValueError("corrupt record")

    reader.decorate_batch_generator(bad_source)
    reader.start()
    exe.run(main, fetch_list=[loss])
    with pytest.raises(RuntimeError, match="data source raised"):
        exe.run(main, fetch_list=[loss])
    reader.reset()


@pytest.mark.parametrize("decorate_first", [False, True])
def test_startup_rerun_or_decorate_first_keeps_source(decorate_first):
    pt.executor._global_scope = pt.Scope()
    main, startup, reader, loss = _reader_program()
    exe = pt.Executor(pt.CPUPlace())
    if decorate_first:
        reader.decorate_batch_generator(_dataset(2, 8))
        exe.run(startup)
    else:
        exe.run(startup)
        reader.decorate_batch_generator(_dataset(2, 8))
        exe.run(startup)  # resets the queue, keeps the source
    assert len(_epoch(exe, main, reader, loss)) == 2


def test_shuffle_transform_composes_over_the_source():
    pt.executor._global_scope = pt.Scope()
    main, startup, reader, loss = _reader_program()
    pt.layers.shuffle(reader, 4)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    reader.decorate_batch_generator(_dataset(4, 8))
    random.seed(0)
    assert len(_epoch(exe, main, reader, loss)) == 4


def test_read_is_a_host_segment_before_the_device_one():
    pt.executor._global_scope = pt.Scope()
    main, startup, reader, loss = _reader_program()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    reader.decorate_batch_generator(_dataset(2, 8))
    reader.start()
    exe.run(main, fetch_list=[loss])
    (plan,) = main.__dict__["_exec_cache"].values()
    kinds = [k for k, _ in plan.segments]
    assert kinds == ["host", "device"]
    assert [op.type for op in plan.segments[0][1]] == ["read"]
    assert sorted(plan.segments[1][1].inputs) == sorted(
        [f"train_reader_out{i}" for i in range(2)])
    reader.reset()


@pytest.mark.cuda
def test_reader_program_captures_after_read_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: capture has no CPU mode")
    pt.executor._global_scope = pt.Scope()
    main, startup, reader, loss = _reader_program()
    exe = pt.Executor()
    exe.run(startup)
    reader.decorate_batch_generator(_dataset(6, 8))
    losses = _epoch(exe, main, reader, loss)
    assert len(losses) == 6
    assert exe.capture_stats["captures"] == 1
    assert exe.capture_stats["replays"] >= 5
