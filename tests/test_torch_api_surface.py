"""The public surface of the port against the JAX package's.

- **Names.** Every public name of ``paddle_tpu.layers`` and of
  ``paddle_tpu`` exists in the port, or stands in ``DEFERRED``, which
  maps it to the ROADMAP item that ports it. The missing names must equal
  the dict's keys, so a later slice that ports a name takes it out, and
  no name the port lacks goes unlisted. Each layers module's ``__all__``
  is the JAX module's, in its order, less the deferred names.
- **Programs.** A battery of the layers and top-level names this slice
  adds builds the JAX package's main and startup programs, byte for byte.
- **The top level.** The enums hold the JAX package's values; the flags,
  places and ``name_scope`` behave as the JAX package's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_A12 = "A12"        # multi-device
DEFERRED_LAYERS = {
    **{n: _A12 for n in ("ring_attention", "ulysses_attention",
                         "usp_attention")},
    "open_files": "A13",
}
DEFERRED_TOP = {
    **{n: _A12 for n in (
        "ParallelExecutor", "parallel_executor", "DistributeTranspiler",
        "DistributeTranspilerConfig", "transpiler", "memory_optimize",
        "release_memory", "pipeline_stage", "parallel", "distributed",
        "AsyncExecutor", "async_executor", "DataFeedDesc")},
    **{n: "A13" for n in ("native", "recordio_writer")},
    # the port runs on CUDA places: no TPU or XLA place, by design
    "TPUPlace": "by design", "XLAPlace": "by design",
}
DEFERRED = {**DEFERRED_LAYERS, **DEFERRED_TOP}
ROADMAP_ITEMS = {"A10", "A11", "A12", "A13", "by design"}

# names the port's layers modules export beyond the JAX package's
PORT_EXTRAS = {"io": ["PyReader"]}
MODULES = ("nn", "tensor", "ops", "io", "rnn", "control_flow", "detection",
           "learning_rate_scheduler")


_NAMES = """
import json, paddle_tpu, paddle_tpu_torch
def public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_"))
print(json.dumps({"layers": [public(paddle_tpu.layers),
                             public(paddle_tpu_torch.layers)],
                  "top_level": [public(paddle_tpu), public(paddle_tpu_torch)]}))
"""


@pytest.fixture(scope="module")
def public_names():
    """{"layers"|"top_level": (JAX names, port names)} as a fresh process
    that imports the two packages sees them: a submodule another test
    imports (``paddle_tpu.profiling``) becomes a package attribute, so the
    test process's own ``dir()`` depends on what ran before."""
    r = subprocess.run([sys.executable, "-c", _NAMES], capture_output=True,
                       text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    return {k: (set(j), set(p))
            for k, (j, p) in json.loads(r.stdout.splitlines()[-1]).items()}


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


@pytest.mark.parametrize("where,deferred", [
    ("layers", DEFERRED_LAYERS), ("top_level", DEFERRED_TOP)],
    ids=["layers", "top_level"])
def test_every_public_name_is_ported_or_deferred(public_names, where,
                                                 deferred):
    jax_names, port_names = public_names[where]
    missing = jax_names - port_names
    assert missing == set(deferred), (
        f"not deferred: {sorted(missing - set(deferred))}; deferred but "
        f"ported: {sorted(set(deferred) - missing)}")
    assert set(deferred.values()) <= ROADMAP_ITEMS


def test_no_layer_of_this_slice_is_deferred():
    from test_torch_tensor_ops import NEW_TENSOR_LOSS_RNN
    slice_layers = {"one_hot", "shape", "stack", "unstack", "scatter",
                    "pad", "pad2d", "flatten", "arg_max", "arg_min",
                    "cumsum", "argsort", "label_smooth", "hinge_loss",
                    "rank_loss", "margin_rank_loss", "bpr_loss",
                    "teacher_student_sigmoid_loss", "nce", "hsigmoid",
                    "squared_l2_distance", "squared_l2_norm", "l1_norm",
                    "lstm_unit", "gru_unit", "dynamic_lstmp", "lstm"}
    assert not slice_layers & set(DEFERRED)
    assert len(NEW_TENSOR_LOSS_RNN) == 35


@pytest.mark.parametrize("name", MODULES)
def test_layers_module_all_is_the_jax_modules(name):
    jall = getattr(fluid.layers, name).__all__
    pall = getattr(pt.layers, name).__all__
    want = [n for n in jall if n not in DEFERRED] + PORT_EXTRAS.get(name, [])
    assert sorted(pall) == sorted(want)
    assert [n for n in pall if n in jall] == [n for n in jall if n in pall]
    for n in pall:
        assert hasattr(pt.layers, n), n


@pytest.mark.parametrize("name", ["imperative", "dataset"])
def test_imperative_and_dataset_all_are_the_jax_ones(name):
    jmod, pmod = getattr(fluid, name), getattr(pt, name)
    assert pmod.__all__ == jmod.__all__
    for n in pmod.__all__:
        assert hasattr(pmod, n), n


def test_enums_hold_the_jax_values():
    for enum in ("DataType", "VarType", "OpRole"):
        jenum, penum = getattr(fluid, enum), getattr(pt, enum)
        assert ({m.name: int(m) for m in penum}
                == {m.name: int(m) for m in jenum}), enum


def test_flags_get_and_set():
    old = pt.get_flags("FLAGS_jit_cache")
    assert old == {"FLAGS_jit_cache": PFLAGS.jit_cache}
    try:
        pt.set_flags({"FLAGS_jit_cache": False})
        assert pt.FLAGS.jit_cache is False
        assert pt.get_flags(["jit_cache"]) == {"jit_cache": False}
    finally:
        pt.set_flags(old)
    with pytest.raises(AttributeError):
        pt.set_flags({"no_such_flag": 1})


def test_places():
    assert pt.cpu_places(3) == [pt.CPUPlace()] * 3
    assert pt.cpu_places() == [pt.CPUPlace()]
    assert pt.cuda_places([0, 1]) == [pt.CUDAPlace(0), pt.CUDAPlace(1)]
    assert len(pt.cuda_places()) == pt.core_device_count()
    assert pt.cuda_pinned_places(2) == [pt.CUDAPinnedPlace()] * 2
    assert pt.CUDAPinnedPlace().torch_device.type == "cpu"


def test_name_scope_changes_no_name():
    def build(fl):
        main = fl.Program()
        with fl.program_guard(main, fl.Program()):
            x = fl.layers.data("x", shape=[4], dtype="float32")
            with fl.name_scope("block"):
                fl.layers.fc(x, size=3)
        return main
    with junique.guard():
        j = build(fluid)
    with punique.guard():
        p = build(pt)
    assert p.desc.to_bytes() == j.desc.to_bytes()


# ---------------------------------------------------------------------------
# the battery: the new layers' programs, byte for byte
# ---------------------------------------------------------------------------

def _tensor_layers(fl):
    L = fl.layers
    x = L.data("x", shape=[6, 8], dtype="float32")
    ids = L.data("ids", shape=[1], dtype="int64")
    img = L.data("img", shape=[3, 5, 7], dtype="float32")
    parts = L.unstack(x, axis=1)
    s = L.stack(parts[:3], axis=2)
    out = [s, L.flatten(x, axis=2), L.flatten(x, axis=0),
           L.scatter(L.reshape(x, [-1, 8]), L.reshape(ids, [-1]),
                     L.reshape(x, [-1, 8]), overwrite=False),
           L.one_hot(ids, depth=11), fl.one_hot(ids, depth=5),
           L.pad(x, paddings=[0, 0, 1, 2, 0, 1], pad_value=1.0),
           L.pad2d(img, paddings=[1, 0, 0, 2], mode="reflect"),
           L.arg_max(x, axis=1), L.arg_min(x, axis=-1),
           L.argsort(x, axis=1)[1], L.cumsum(x, axis=1, exclusive=True,
                                             reverse=True),
           L.shape(img), L.argmax(x, axis=2), L.argmin(x),
           L.argsort(x)[0], L.relu(x), L.log_softmax(x),
           L.sum([x, x]), L.l2_normalize(x, axis=1),
           L.ones([2, 3], "float32"), L.zeros([4], "int64"),
           L.zeros_like(x), L.has_inf(x), L.has_nan(x), L.isfinite(x),
           L.uniform_random([3, 4], min=-0.5, max=0.5, seed=1),
           L.gaussian_random([2, 2], std=0.3),
           L.merge_selected_rows(x), L.get_tensor_from_selected_rows(x),
           L.create_tensor("float32", name="made")]
    out.append(L.mul(L.reshape(x, [-1, 8]),
                     L.create_parameter([8, 4], "float32", name="mw")))
    out.append(L.lookup_table(ids, size=[20, 4]))
    scale = L.create_parameter([3], "float32", name="ac_scale")
    bias = L.create_parameter([3], "float32", name="ac_bias")
    out.append(L.affine_channel(img, scale=scale, bias=bias))
    out.append(L.autoincreased_step_counter())
    nested = L.data("nested", shape=[3, 4, 5], dtype="float32")
    outer = L.data("outer", shape=[], dtype="int64")
    inner = L.data("inner", shape=[3], dtype="int64")
    out.append(L.nested_sequence_pool(nested, outer, inner, "sum"))
    probs = L.softmax(L.fc(L.reshape(x, [-1, 48]), size=4))
    out.append(L.dice_loss(probs, ids))
    L.load(out[0], "/nonexistent/path")
    return out


def _loss_layers(fl):
    L = fl.layers
    a = L.data("a", shape=[1], dtype="float32")
    b = L.data("b", shape=[1], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    ids = L.data("ids", shape=[1], dtype="int64")
    h = L.data("h", shape=[16], dtype="float32")
    logits = L.fc(h, size=7)
    out = [L.label_smooth(L.one_hot(ids, depth=7), epsilon=0.2),
           L.hinge_loss(a, y), L.rank_loss(y, a, b),
           L.margin_rank_loss(y, a, b, margin=0.2), L.bpr_loss(logits, ids),
           L.teacher_student_sigmoid_loss(a, y),
           L.squared_l2_distance(h, h), L.squared_l2_norm(h),
           L.l1_norm(h), L.nce(h, ids, num_total_classes=50,
                               num_neg_samples=4),
           L.nce(h, ids, num_total_classes=50, bias_attr=False,
                 sampler="log_uniform", seed=3),
           L.hsigmoid(h, ids, num_classes=50),
           L.hsigmoid(h, ids, num_classes=9, bias_attr=False)]
    loss = L.mean(L.sums([L.reduce_sum(v) for v in out]))
    return loss


def _rnn_layers(fl):
    L = fl.layers
    x = L.data("x", shape=[6], dtype="float32")
    h0 = L.data("h0", shape=[4], dtype="float32")
    c0 = L.data("c0", shape=[4], dtype="float32")
    seq = L.data("seq", shape=[5, 8], dtype="float32")
    length = L.data("len", shape=[], dtype="int64")
    tm_seq = L.data("tm", shape=[3, 2, 6], dtype="float32",
                    append_batch_size=False)
    init = L.data("init", shape=[4, 2, 5], dtype="float32",
                  append_batch_size=False)
    h, c = L.lstm_unit(x, h0, c0, forget_bias=1.0)
    g, _, _ = L.gru_unit(L.fc(x, size=12), h0, size=12, origin_mode=True)
    proj, cell = L.dynamic_lstmp(L.fc(seq, size=16, num_flatten_dims=2),
                                 size=16, proj_size=3, length=length)
    out, last_h, last_c = L.lstm(tm_seq, init, init, max_len=3,
                                 hidden_size=5, num_layers=2,
                                 is_bidirec=True, dropout_prob=0.2)
    return L.mean(L.sums([L.reduce_sum(v) for v in
                          (h, c, g, proj, cell, out, last_h, last_c)]))


def _training_names(fl):
    """append_backward, calc_gradient, the learning-rate schedules at the
    layers top level and WeightNormParamAttr, through an optimizer."""
    L = fl.layers
    x = L.data("x", shape=[5], dtype="float32")
    w_attr = fl.WeightNormParamAttr(dim=1, name="wn")
    hid = L.fc(x, size=4, param_attr=w_attr, act="tanh")
    loss = L.mean(L.fc(hid, size=1))
    grads = fl.calc_gradient(loss, [x])
    lrs = [L.exponential_decay(0.1, 10, 0.5), L.natural_exp_decay(0.1, 5, 0.3),
           L.inverse_time_decay(0.1, 5, 0.5),
           L.polynomial_decay(0.1, 20), L.piecewise_decay([3, 6],
                                                          [0.1, 0.05, 0.01]),
           L.noam_decay(16, 4), L.cosine_decay(0.1, 5, 3),
           L.linear_lr_warmup(0.1, 4, 0.0, 0.1)]
    return [loss] + [g for g in grads if g is not None] + lrs


def _backward_battery(fl):
    L = fl.layers
    x = L.data("x", shape=[5], dtype="float32")
    loss = L.mean(L.fc(x, size=3))
    params_grads = fl.append_backward(loss)
    return [g for _, g in params_grads]


# the layers of the image and NN op families (ROADMAP A11.9)
VISION_LAYERS = (
    "adaptive_pool2d", "adaptive_pool3d", "affine_grid",
    "bilinear_tensor_product", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "conv_shift", "crop", "data_norm",
    "gaussian_random_batch_size_like", "grid_sampler", "group_norm", "hash",
    "huber_loss", "lrn", "maxout", "mean_iou", "multiplex", "norm",
    "pad_constant_like", "pool2d_with_index", "pool3d", "prelu",
    "random_crop", "reverse", "sampling_id", "selu", "shuffle_channel",
    "similarity_focus", "space_to_depth", "uniform_random_batch_size_like",
    "unpool")


def test_no_vision_layer_is_deferred():
    assert len(VISION_LAYERS) == 33
    assert not set(VISION_LAYERS) & set(DEFERRED)
    for n in VISION_LAYERS:
        assert hasattr(pt.layers, n), n


def _vision_layers(fl):
    """Every layer of VISION_LAYERS once or more; the float outputs summed
    into a loss (the integer ones, the draws and the masks, feed no
    gradient)."""
    L = fl.layers
    img = L.data("img", shape=[4, 8, 8], dtype="float32")
    vol = L.data("vol", shape=[2, 4, 6, 6], dtype="float32")
    vec = L.data("vec", shape=[6], dtype="float32")
    kern = L.data("kern", shape=[3], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    ids = L.data("ids", shape=[1], dtype="int64")
    pick = L.data("pick", shape=[1], dtype="int32")
    pred = L.data("pred", shape=[1], dtype="int32")
    lab = L.data("lab", shape=[1], dtype="int32")
    raw = L.data("raw", shape=[10, 10, 3], dtype="uint8")
    theta = L.data("theta", shape=[2, 3], dtype="float32")
    c3 = L.conv3d(vol, num_filters=3, filter_size=3, padding=1, act="relu")
    pooled, mask = L.pool2d_with_index(img, pool_size=2, pool_stride=2)
    grid = L.affine_grid(theta, [2, 4, 5, 5])
    floats = [
        L.conv2d_transpose(img, num_filters=3, filter_size=4, stride=2,
                           padding=1, act="relu"),
        L.conv2d_transpose(img, num_filters=2, output_size=10,
                           bias_attr=False),
        c3, L.conv3d_transpose(vol, num_filters=2, filter_size=2, stride=2),
        L.conv3d_transpose(vol, num_filters=2, output_size=[5, 8, 8],
                           padding=1),
        L.pool3d(c3, pool_size=2, pool_stride=2, pool_type="avg",
                 ceil_mode=True),
        L.pool3d(vol, pool_size=3, pool_stride=1, pool_padding=1),
        L.adaptive_pool2d(img, 3, pool_type="avg"),
        L.adaptive_pool3d(vol, [1, 2, 2]),
        pooled, L.unpool(pooled, mask, [8, 8]),
        L.group_norm(img, groups=2), L.maxout(img, groups=2),
        L.prelu(img, mode="channel"), L.prelu(vec, mode="all"),
        L.prelu(img, mode="element"), L.lrn(img, n=3),
        L.crop(img, shape=pooled, offsets=[0, 0, 1, 1]),
        L.pad_constant_like(img, pooled, pad_value=0.5),
        L.shuffle_channel(img, group=2), L.space_to_depth(img, 2),
        L.selu(img), L.selu(vec, scale=1.1, alpha=1.5),
        L.multiplex([vec, L.scale(vec, scale=2.0)], pick),
        L.norm(img, axis=1), L.data_norm(vec),
        L.bilinear_tensor_product(vec, kern, size=3),
        L.grid_sampler(img, grid), grid,
        L.conv_shift(vec, kern), L.similarity_focus(img, axis=1,
                                                    indexes=[0, 2]),
        L.huber_loss(L.fc(vec, size=1), y, delta=1.0),
        L.reverse(img, axis=[2]), L.reverse(vec, axis=1),
        L.gaussian_random_batch_size_like(vec, shape=[-1, 5], std=0.5),
        L.uniform_random_batch_size_like(vec, shape=[-1, 5], min=0.0),
        L.cast(L.random_crop(raw, shape=[8, 8, 3]), "float32")]
    miou, wrong, correct = L.mean_iou(pred, lab, num_classes=4)
    ints = [L.sampling_id(L.softmax(vec)), L.hash(ids, hash_size=1000,
                                                  num_hash=2),
            wrong, correct, mask]
    loss = L.mean(L.sums([L.reduce_sum(v) for v in floats] + [miou]))
    return loss, ints


def _vision_loss(fl):
    return _vision_layers(fl)[0]


# the layers of the single-device rest (ROADMAP A11.11). py_func's program
# holds a Python callable as an attribute and cannot be serialized: it is
# held by its op list in tests/test_torch_host_ops.py
REST_LAYERS = ("py_func", "tree_conv", "random_data_generator",
               "Preprocessor")


def test_no_rest_layer_is_deferred():
    assert not set(REST_LAYERS) & set(DEFERRED)
    for n in REST_LAYERS:
        assert hasattr(pt.layers, n), n


def _rest_layers(fl):
    """tree_conv with and without a bias; a random_data_generator read by
    read_file through a Preprocessor (whose own program is built aside)."""
    L = fl.layers
    nodes = L.data("nodes", shape=[7, 5], dtype="float32")
    edges = L.data("edges", shape=[8, 2], dtype="int64")
    reader = L.random_data_generator(low=0.0, high=2.0,
                                     shapes=[[3, 5], [3, 1]])
    pre = L.Preprocessor(reader)
    with pre.block():
        a, b = pre.inputs()
        pre.outputs(L.scale(a, scale=0.5), b)
    x, y = L.read_file(reader)
    outs = [L.tree_conv(nodes, edges, output_size=4, num_filters=2),
            L.tree_conv(nodes, edges, output_size=3, max_depth=3,
                        act="relu", bias_attr=False),
            L.fc(x, size=2), y]
    return L.mean(L.sums([L.reduce_sum(v) for v in outs]))


BATTERY = {"tensor": _tensor_layers, "loss": _loss_layers,
           "rnn": _rnn_layers, "training": _training_names,
           "append_backward": _backward_battery, "vision": _vision_loss,
           "rest": _rest_layers}


def _build(fl, fn, with_backward):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    with fl.program_guard(main, startup):
        out = fn(fl)
        if with_backward:
            fl.optimizer.SGD(learning_rate=0.1).minimize(out)
    return main, startup


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_battery_programs_bytes_identical(name):
    with_backward = name in ("loss", "rnn", "vision", "rest")
    with junique.guard():
        jm, js = _build(fluid, BATTERY[name], with_backward)
    with punique.guard():
        pm, ps = _build(pt, BATTERY[name], with_backward)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    assert ps.desc.to_bytes() == js.desc.to_bytes()


def test_battery_runs_in_the_port():
    """The loss, RNN and vision batteries train a step on the CPU to
    finite values (every op of them has an emitter and a grad)."""
    rng = np.random.RandomState(0)
    for fn, feed in (
            (_vision_loss, {"img": rng.randn(2, 4, 8, 8),
                            "vol": rng.randn(2, 2, 4, 6, 6),
                            "vec": rng.rand(2, 6) + 0.1,
                            "kern": rng.randn(2, 3), "y": rng.randn(2, 1),
                            "ids": rng.randint(0, 50, (2, 1)),
                            "pick": np.array([[1], [0]], "int32"),
                            "pred": rng.randint(0, 4, (2, 1)),
                            "lab": rng.randint(0, 4, (2, 1)),
                            "raw": rng.randint(0, 256, (2, 10, 10, 3)),
                            "theta": rng.randn(2, 2, 3) * 0.5}),
            (_loss_layers, {"a": rng.randn(4, 1), "b": rng.randn(4, 1),
                            "y": rng.randint(0, 2, (4, 1)),
                            "ids": rng.randint(0, 7, (4, 1)),
                            "h": rng.randn(4, 16)}),
            (_rnn_layers, {"x": rng.randn(2, 6), "h0": rng.randn(2, 4),
                           "c0": rng.randn(2, 4), "seq": rng.randn(2, 5, 8),
                           "len": np.array([5, 2]), "tm": rng.randn(3, 2, 6),
                           "init": rng.randn(4, 2, 5)})):
        with punique.guard():
            main, startup = _build(pt, fn, True)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        block = main.global_block()
        feed = {k: np.asarray(v, dtype="int64" if "int" in str(
            block.var(k).dtype).lower() else "float32")
            for k, v in feed.items()}
        loss_name = [op for op in block.ops if op.type == "mean"][-1] \
            .output("Out")[0]
        for _ in range(2):
            loss, = exe.run(main, feed=feed, fetch_list=[loss_name],
                            scope=scope)
            assert np.isfinite(loss).all()
