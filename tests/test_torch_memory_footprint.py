"""paddle_tpu_torch/profiling/memory.py held against the JAX package's
footprint analysis, on the CPU.

The analysis walks OpDescs, so each program is built once by the JAX
package and carried into the port through the byte codec: the same
descs. Sized with the JAX package's element sizes, the two predictions
are equal (peak bytes, op at peak, its output, the top vars with their
bytes, kind and producer, the timeline) on a tiny Transformer training
program, a tiny ResNet, a bounded ``While`` and a ``run(iterations=K)``
program, and ``max_fitting_batch`` picks the same batch. The element
size is each package's own device policy: the JAX package sizes int64
at 4 bytes (its ids are int32 on the device, ``np_dtype_of``), the port
at 8 (int64 stays int64 on the card); ``test_port_sizes_int64_at_eight``
pins the port's. Then the port's executor: the pre-flight raises
``MemoryBudgetExceeded`` naming the op at peak before any device work,
the gauges and the ``/memory`` registry fill, an out-of-memory error
dumps an ``oom`` flight record, and the generation predictor's cap
downshift and page-pool fit follow the JAX predictor's arithmetic.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.profiling import memory as jmem
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor as pmon
from paddle_tpu_torch.core.desc import ProgramDesc
from paddle_tpu_torch.core.types import dtype_to_numpy as pdtype_to_numpy
from paddle_tpu_torch.profiling import memory as pmem
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

TINY = dict(src_vocab=50, tgt_vocab=50, max_len=8, n_layer=1, n_head=2,
            d_model=16, d_inner_hid=32, warmup_steps=4)


@pytest.fixture(autouse=True)
def _flags():
    old = (JFLAGS.op_callstack, PFLAGS.op_callstack,
           PFLAGS.memory_budget_bytes, PFLAGS.memory_budget_frac,
           PFLAGS.flight_record_dir)
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    (JFLAGS.op_callstack, PFLAGS.op_callstack, PFLAGS.memory_budget_bytes,
     PFLAGS.memory_budget_frac, PFLAGS.flight_record_dir) = old
    pmon.disable()
    pmon.reset()


@pytest.fixture
def jax_sizes(monkeypatch):
    """The port's analysis with the JAX package's element sizes."""
    def itemsize(dtype):
        if isinstance(dtype, torch.dtype):
            return torch.empty((), dtype=dtype).element_size()
        try:
            dt = np.dtype(pdtype_to_numpy(dtype))
        except Exception:  # noqa: BLE001 — a raw numpy dtype
            dt = np.dtype(dtype)
        # jcommon.np_dtype_of's rule: 64-bit types are 32-bit on a TPU
        return {8: 4}.get(dt.itemsize, dt.itemsize) \
            if dt.kind in "iuf" else dt.itemsize
    monkeypatch.setattr(pmem, "_itemsize", itemsize)


def to_port(jprog):
    return pt.Program._from_desc(
        ProgramDesc.from_bytes(jprog.desc.to_bytes()))


def _report(rep):
    return {"peak": rep.peak_bytes, "op_idx": rep.peak_op_idx,
            "op": rep.peak_op_type, "out": rep.peak_op_out,
            "args": rep.args_bytes, "unknown": rep.unknown_vars,
            "top": [(v["name"], v["nbytes"], v["kind"], v["producer"])
                    for v in rep.top_vars],
            "timeline": [tuple(r) for r in rep.timeline]}


def _both(jprog, **kw):
    j = jmem.program_footprint(jprog, **kw)
    p = pmem.program_footprint(to_port(jprog), **kw)
    return _report(j), _report(p)


# ---------------------------------------------------------------------------
# parity of the analysis
# ---------------------------------------------------------------------------

def _transformer():
    with junique.guard():
        m = jtransformer.build(dropout_rate=0.0, **TINY)
    feed = jtransformer.make_fake_batch(2, TINY)
    return m["main"], {n: v.shape for n, v in feed.items()}, \
        [m["loss"].name]


def _resnet():
    with junique.guard():
        m = jresnet.build(dataset="cifar10", depth=20, class_dim=10,
                          image_shape=[3, 16, 16])
    feeds = {"image": (4, 3, 16, 16), "label": (4, 1)}
    return m["main"], feeds, [m["loss"].name]


def _while():
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), junique.guard():
        x = L.data("x", shape=[64], dtype="float32")
        w = L.create_parameter([1, 64], "float32", name="w_loop")
        i = L.fill_constant(shape=[1], dtype="int32", value=0)
        limit = L.fill_constant(shape=[1], dtype="int32", value=3)
        y = L.elementwise_add(x, L.fill_constant(
            shape=[1], dtype="float32", value=0.0))
        cond = L.less_than(i, limit)
        loop = L.While(cond, max_trip_count=4)
        with loop.block():
            big = L.fc(y, size=256)
            ny = L.elementwise_mul(L.fc(big, size=64), w)
            L.assign(ny, output=y)
            L.increment(i, 1, in_place=True)
            L.less_than(i, limit, cond=cond)
        out = L.reduce_mean(y)
    return main, {"x": (8, 64)}, [out.name]


def _mlp_train():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), junique.guard():
        x = fluid.layers.data(name="x", shape=[32], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=64, act="relu")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(h, size=1), y))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, {"x": (16, 32), "y": (16, 1)}, [loss.name]


PROGRAMS = {"transformer": _transformer, "resnet": _resnet,
            "while": _while, "mlp": _mlp_train}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_footprint_equals_jax(name, jax_sizes):
    prog, feeds, fetch = PROGRAMS[name]()
    j, p = _both(prog, feed_shapes=feeds, fetch_names=fetch)
    assert j["peak"] > 0
    assert p == j


def test_footprint_of_a_k_step_program_equals_jax(jax_sizes):
    prog, feeds, fetch = _mlp_train()
    K = 4
    kfeeds = {n: (K,) + tuple(s) for n, s in feeds.items()}
    j, p = _both(prog, feed_shapes=kfeeds, fetch_names=fetch, iterations=K)
    assert p == j
    one = pmem.program_footprint(to_port(prog), feed_shapes=feeds,
                                 fetch_names=fetch)
    # K-stacked feeds and fetches grow the peak; the state does not
    assert p["peak"] > one.peak_bytes


def test_while_folds_its_sub_block_into_one_row(jax_sizes):
    prog, feeds, fetch = _while()
    _j, p = _both(prog, feed_shapes=feeds, fetch_names=fetch)
    rows = [r for r in p["timeline"] if r[1] == "while"]
    assert len(rows) == 1
    assert any(kind == "sub_block" for _n, _b, kind, _p in p["top"]) \
        or p["op"] != "while"


def test_max_fitting_batch_equals_jax(jax_sizes):
    prog, feeds, fetch = _mlp_train()
    template = {n: (1,) + tuple(s[1:]) for n, s in feeds.items()}
    at32 = jmem.program_footprint(
        prog, feed_shapes={n: (32,) + tuple(s[1:]) for n, s in
                           feeds.items()}, fetch_names=fetch).peak_bytes
    for budget in (at32 + 1, at32 - 1, 10 ** 9, 1):
        j = jmem.max_fitting_batch(prog, template, fetch, budget=budget)
        p = pmem.max_fitting_batch(to_port(prog), template, fetch,
                                   budget=budget)
        assert p == j
    assert pmem.max_fitting_batch(to_port(prog), template, fetch,
                                  budget=at32 + 1) == 32


def test_port_sizes_int64_at_eight():
    """The port's own policy: an int64 feed counts 8 bytes an element,
    twice the JAX package's (ids are int32 on a TPU)."""
    prog, feeds, fetch = _transformer()
    p = pmem.program_footprint(to_port(prog), feed_shapes=feeds,
                               fetch_names=fetch)
    j = jmem.program_footprint(prog, feed_shapes=feeds, fetch_names=fetch)
    n_ids = int(np.prod(feeds["src_word"]))
    pv = {v["name"]: v["nbytes"] for v in p.top_vars}
    assert p.peak_bytes > j.peak_bytes
    if "src_word" in pv:
        assert pv["src_word"] == 8 * n_ids
    assert pmem._nbytes_of((2, 3), "int64", 1) == 48
    assert jmem._nbytes_of((2, 3), "int64", 1) == 24


# ---------------------------------------------------------------------------
# the port's executor: pre-flight, gauges, registry, oom record
# ---------------------------------------------------------------------------

def _port_train():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        pred = pt.layers.fc(input=pt.layers.fc(input=x, size=4), size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, loss


FEED = {"x": np.zeros((4, 8), np.float32), "y": np.zeros((4, 1), np.float32)}


def test_preflight_raises_before_any_device_work(monkeypatch):
    PFLAGS.op_callstack = True
    main, startup, loss = _port_train()
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    w = {n: scope.find_var(n).clone() for n in scope.var_names()}
    PFLAGS.memory_budget_bytes = 64
    ran = []
    monkeypatch.setattr(pt.executor, "run_ops",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(pmem.MemoryBudgetExceeded) as ei:
        exe.run(main, feed=FEED, fetch_list=[loss], scope=scope)
    assert ran == []  # nothing ran
    err = ei.value
    assert err.budget == 64 and err.where == "executor"
    assert err.report.peak_op_type and err.report.peak_op_type in str(err)
    assert err.report.top_var in str(err)
    assert any(v.get("callstack") for v in err.report.top_vars)
    for n, v in w.items():
        assert torch.equal(scope.find_var(n), v)
    # a refused plan is not kept: under a larger budget the run goes on
    monkeypatch.undo()
    PFLAGS.memory_budget_bytes = 10 ** 9
    exe.run(main, feed=FEED, fetch_list=[loss], scope=scope)


def test_gauges_registry_and_memory_plane():
    pmon.enable()
    main, startup, loss = _port_train()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    exe.run(main, feed=FEED, fetch_list=[loss])
    snap = pmon.snapshot()
    assert any(k.startswith("executor_mem_predicted_peak_bytes")
               for k in snap)
    fps = pmem.footprints()
    train = max(fps.values(), key=lambda d: d["peak_bytes"])
    assert train["peak_bytes"] > 0 and train["top_vars"]
    plane = pmon.memory_plane()
    assert train["seg_key"] in plane["executables"]
    assert plane["budget_bytes"] == 0 and plane["devices"] == {}
    digest = pmon.bench_summary()["memory"]
    assert digest["predicted_peak_bytes"] == max(
        d["peak_bytes"] for d in fps.values())


def test_oom_dumps_a_flight_record(tmp_path, monkeypatch):
    pmon.enable()
    PFLAGS.flight_record_dir = str(tmp_path)
    pmon._flight_last.clear()
    main, startup, loss = _port_train()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")

    monkeypatch.setattr(pt.Executor, "_run_eager", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        exe.run(main, feed=FEED, fetch_list=[loss])
    (name,) = [n for n in os.listdir(tmp_path) if "oom" in n]
    rows = [json.loads(ln) for ln in open(tmp_path / name)]
    meta = rows[0]
    assert meta["reason"] == "oom" and "out of memory" in meta["error"]
    assert meta["predicted"]["peak_op_type"]
    assert meta["predicted"]["top_vars"] and meta["predicted"]["timeline"]
    assert pmon.snapshot()[
        f'executor_oom_total{{key="{meta["key"]}"}}'] == 1
    assert pmem.is_resource_exhausted(torch.cuda.OutOfMemoryError("x"))
    assert not pmem.is_resource_exhausted(ValueError("shape"))


# ---------------------------------------------------------------------------
# the generation predictor's budget fit
# ---------------------------------------------------------------------------

def _lm_engine(paged):
    from paddle_tpu_torch.inference.generation import DecodeEngine
    from paddle_tpu_torch.models import transformer as ptransformer
    from paddle_tpu_torch.utils import unique_name as punique
    PFLAGS.generation_paged = paged
    try:
        with punique.guard():
            lm = ptransformer.build_lm(vocab=64, n_layer=2, n_head=2,
                                       d_model=16, d_inner_hid=32,
                                       max_positions=64, eos_id=1)
        return DecodeEngine(lm["spec"], place=pt.CPUPlace(),
                            scope=pt.Scope(), prompt_buckets=(8, 16, 32),
                            new_token_buckets=(8,), slot_buckets=(1, 2))
    finally:
        PFLAGS.generation_paged = True


def test_cap_downshift_refuses_an_over_bucket_prompt():
    """tests/test_memory_footprint.py's downshift case on the port: a
    budget fitting (1, 24) but not (1, 40) downshifts the cap to 24,
    below the top prompt bucket 32; a prompt padding to bucket 32 is
    refused at submit, one padding to 16 admits."""
    from paddle_tpu_torch.inference.generation import GenerationPredictor
    eng = _lm_engine(paged=False)
    PFLAGS.memory_budget_bytes = eng.state_nbytes(1, 24) + 1
    pmon.enable()
    with pytest.warns(UserWarning, match="downshifting"):
        pred = GenerationPredictor(eng, max_slots=1, decode_chunk=2)
    try:
        assert pred._cap == 24
        assert eng.max_fitting_config(1) == (1, 24)
        assert pmon.snapshot()["generation_cap_effective"] == 24
        with pytest.raises(ValueError, match="pads to prompt bucket"):
            pred.submit(np.arange(2, 19, dtype=np.int64), max_new_tokens=7)
        req = pred.submit(np.arange(2, 13, dtype=np.int64),
                          max_new_tokens=8)
        req.cancel()
    finally:
        pred.shutdown(timeout=30)
    PFLAGS.memory_budget_bytes = 1
    with pytest.raises(pmem.MemoryBudgetExceeded, match="slot table"):
        GenerationPredictor(eng, max_slots=1, decode_chunk=2)


def test_page_pool_fits_the_budget():
    from paddle_tpu_torch.inference.generation import GenerationPredictor
    eng = _lm_engine(paged=True)
    cap = 40
    default = eng.default_num_pages(2, cap)
    PFLAGS.memory_budget_bytes = eng.state_nbytes(2, cap, default - 2)
    with pytest.warns(UserWarning, match="sizing the pool"):
        pred = GenerationPredictor(eng, max_slots=2, decode_chunk=2)
    try:
        assert pred._cap == cap
        assert pred._num_pages == default - 2
    finally:
        pred.shutdown(timeout=30)
    PFLAGS.memory_budget_bytes = 0
    pred = GenerationPredictor(eng, max_slots=2, decode_chunk=2)
    try:
        assert pred._num_pages is None
    finally:
        pred.shutdown(timeout=30)
