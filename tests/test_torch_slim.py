"""``contrib.slim`` in the port against the JAX package, on the CPU
(tests/test_slim.py's recipes).

- **Masks.** ``RatioPruner`` and ``MagnitudePruner`` masks over a
  LeNet's weights, from the same values in both packages: equal, element
  for element (ties at the threshold included).
- **The loop.** ``CompressPass`` with ``PruneStrategy(RatioPruner({"*":
  0.5}), fixed_mask=True)`` over LOOP_EPOCHS epochs of LOOP_BATCHES
  batches (Adam) from the same state: every persistable within LOOP_REL
  of the JAX package's, relative; the sparsity the JAX package's, and
  ``sparsity()`` a count over the scope. The masks are applied in place:
  each parameter is the same tensor before and after the loop, so a
  captured step's graph is kept (``Executor``'s ``state_rebound``).
- **Config.** The yaml schema from a file and the same dict build the
  same wiring as the JAX ``ConfigFactory``; ``build_compressor`` attaches
  the runtime pieces.
- **Schedules.** ``SensitivePruneStrategy``'s ramp floors at the cap, as
  the JAX one's; ``MagnitudePruner`` keeps |w| > threshold exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import slim as jslim
from paddle_tpu.utils import unique_name as junique

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import slim as pslim
from paddle_tpu_torch.utils import unique_name as punique

from test_torch_tensor_ops import _no_callstack  # noqa: F401

LOOP_REL = 1e-5
LOOP_EPOCHS = 2
LOOP_BATCHES = 3
BATCH = 32


def _data(n=LOOP_BATCHES * BATCH, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 12, 12).astype("float32")
    pools = np.stack([x[:, 0, :6, :6].sum((1, 2)),
                      x[:, 0, :6, 6:].sum((1, 2)),
                      x[:, 0, 6:, :6].sum((1, 2)),
                      x[:, 0, 6:, 6:].sum((1, 2))], 1)
    return x, pools.argmax(1).astype("int64")[:, None]


def _lenet(fl):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 31
    with fl.program_guard(main, startup):
        img = fl.layers.data("img", shape=[1, 12, 12])
        label = fl.layers.data("label", shape=[1], dtype="int64")
        c = fl.nets.simple_img_conv_pool(img, 8, 3, 2, 2, act="relu")
        fc1 = fl.layers.fc(c, size=32, act="relu")
        pred = fl.layers.fc(fc1, size=4, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(pred, label))
        fl.optimizer.Adam(5e-3).minimize(loss)
    return main, startup, loss


@pytest.fixture
def both():
    """The LeNet in both packages, the port's scope holding the JAX
    package's initial state."""
    with junique.guard():
        jm, js, jl = _lenet(fluid)
    with punique.guard():
        pm, ps, pl = _lenet(pt)
    assert pm.desc.to_bytes() == jm.desc.to_bytes()
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jexe.run(js, scope=jscope)
    names = [v.name for v in pm.list_vars() if v.persistable]
    pt.io.set_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n)) for n in names}, "cpu",
        program=pm)
    return dict(jm=jm, jl=jl, pm=pm, pl=pl, jscope=jscope, pscope=pscope,
                jexe=jexe, pexe=pexe, names=names)


def _weights(program):
    """The conv and fc weights (not their biases)."""
    return [p.name for p in program.all_parameters()
            if ("conv" in p.name or "fc" in p.name) and ".w_" in p.name]


@pytest.mark.parametrize("pruner", ["ratio", "magnitude"])
def test_masks_equal_jax(both, pruner):
    params = _weights(both["pm"])

    def make(slim):
        if pruner == "ratio":
            return slim.RatioPruner(ratios={"*": 0.5,
                                            params[0]: 0.25})
        return slim.MagnitudePruner(0.05)

    jst = jslim.PruneStrategy(make(jslim), params=params)
    pst = pslim.PruneStrategy(make(pslim), params=params)
    jmasks = jst.compute_masks(jslim.Context(
        None, jslim.ImitationGraph(both["jm"]), both["jscope"],
        program_exe=both["jexe"]))
    pmasks = pst.compute_masks(pslim.Context(
        None, pslim.ImitationGraph(both["pm"]), both["pscope"],
        program_exe=both["pexe"]))
    assert sorted(pmasks) == sorted(jmasks) == sorted(params)
    for n in params:
        got = pmasks[n]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(jmasks[n])), n
    if pruner == "ratio":
        kept = pmasks[params[1]].numpy().mean()
        assert 0.5 <= kept < 0.52, kept


def test_mask_program_without_an_executor_runs_where_the_weights_are(both):
    """compute_masks with no program_exe runs on the weights' device."""
    params = _weights(both["pm"])
    pst = pslim.PruneStrategy(pslim.RatioPruner({"*": 0.5}), params=params)
    masks = pst.compute_masks(pslim.Context(
        None, pslim.ImitationGraph(both["pm"]), both["pscope"]))
    assert all(m.device.type == "cpu" for m in masks.values())
    empty = pslim.PruneStrategy(pslim.RatioPruner({"*": 0.5}))
    assert empty.compute_masks(pslim.Context(
        None, pslim.ImitationGraph(pt.Program()), both["pscope"])) == {}


def _loop(slim, fl, program, loss, scope, exe):
    x, y = _data()
    params = _weights(program)
    strategy = slim.PruneStrategy(
        slim.RatioPruner(ratios={"*": 0.5}), mini_batch_pruning_frequency=1,
        start_epoch=0, end_epoch=LOOP_EPOCHS, params=params, fixed_mask=True)

    def reader():
        for i in range(0, len(x), BATCH):
            yield {"img": x[i:i + BATCH], "label": y[i:i + BATCH]}

    seen = []
    comp = slim.CompressPass(place=fl.CPUPlace(), data_reader=reader,
                             scope=scope, metrics={"loss": loss},
                             program_exe=exe,
                             on_metrics=lambda ctx, m: seen.append(
                                 float(np.asarray(m["loss"]).ravel()[0])))
    comp.add_strategy(strategy)
    ctx = comp.apply(slim.ImitationGraph(program))
    return strategy, ctx, seen, params


def test_compress_pass_loop_matches_jax(both):
    pscope = both["pscope"]
    before = {n: pscope.find_var(n) for n in both["names"]}
    jst, jctx, jloss, params = _loop(jslim, fluid, both["jm"], both["jl"],
                                     both["jscope"], both["jexe"])
    pst, pctx, ploss, _ = _loop(pslim, pt, both["pm"], both["pl"], pscope,
                                both["pexe"])
    assert len(ploss) == len(jloss) == LOOP_EPOCHS * LOOP_BATCHES
    np.testing.assert_allclose(ploss, jloss, rtol=LOOP_REL, atol=0)
    for n in both["names"]:
        want = np.asarray(both["jscope"].find_var(n))
        got = pscope.find_var(n).numpy()
        top = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= LOOP_REL * top, n
        # in place: the scope's tensors are the ones the loop started with
        assert pscope.find_var(n) is before[n], n
    s = pst.sparsity(pctx)
    assert s == jst.sparsity(jctx)
    zero = sum(int((pscope.find_var(n) == 0).sum()) for n in params)
    total = sum(pscope.find_var(n).numel() for n in params)
    assert s == zero / total
    assert 0.49 <= s <= 0.5, s


CONFIG = {
    "version": 1.0,
    "pruners": {"pruner_1": {"class": "RatioPruner",
                             "ratios": {"*": 0.5}}},
    "strategies": {"prune_strategy": {
        "class": "PruneStrategy", "pruner": "pruner_1",
        "mini_batch_pruning_frequency": 2, "start_epoch": 0,
        "end_epoch": 4}},
    "compress_pass": {"class": "CompressPass", "epoch": 4,
                      "strategies": ["prune_strategy"]},
}

YAML = """
version: 1.0
pruners:
  pruner_1:
    class: RatioPruner
    ratios:
      '*': 0.5
strategies:
  prune_strategy:
    class: PruneStrategy
    pruner: pruner_1
    mini_batch_pruning_frequency: 2
    start_epoch: 0
    end_epoch: 4
compress_pass:
  class: CompressPass
  epoch: 4
  strategies:
    - prune_strategy
"""


def _wiring(comp):
    st = comp.strategies[0]
    return (type(comp).__name__, comp.epoch, len(comp.strategies),
            type(st).__name__, type(st.pruner).__name__, st.pruner.ratios,
            st.mini_batch_pruning_frequency, st.start_epoch, st.end_epoch)


@pytest.mark.parametrize("source", ["yaml", "dict"])
def test_config_factory_builds_the_jax_wiring(source, tmp_path):
    cfg = tmp_path / "compress.yaml"
    cfg.write_text(YAML)
    config = str(cfg) if source == "yaml" else CONFIG
    pcomp = pslim.ConfigFactory(config).get_compress_pass()
    jcomp = jslim.ConfigFactory(str(cfg)).get_compress_pass()
    assert isinstance(pcomp, pslim.CompressPass)
    assert _wiring(pcomp) == _wiring(jcomp)
    assert pcomp.place is None      # the card, unless the caller says
    comp2 = pslim.core.build_compressor(
        place=pt.CPUPlace(), data_reader=lambda: iter(()), config=config)
    assert comp2.data_reader is not None and comp2.place == pt.CPUPlace()
    with pytest.raises(ValueError, match="class"):
        pslim.ConfigFactory({"pruners": {"p": {"ratios": {}}}})


def test_sensitive_prune_strategy_ramps_as_jax():
    ratios = []
    for slim in (jslim, pslim):
        pruner = slim.RatioPruner(ratios={"w": 0.8, "*": 0.9})
        s = slim.SensitivePruneStrategy(pruner=pruner, delta_rate=0.25,
                                        sensitivities={"w": 0.3},
                                        start_epoch=0, end_epoch=10)

        class _Ctx:
            epoch_id = 0
            scope = None
            graph = type("G", (), {"all_parameters": staticmethod(
                lambda: [])})()
            program_exe = None
        seq = []
        for _ in range(8):
            s.on_epoch_end(_Ctx())
            seq.append(dict(pruner.ratios))
        ratios.append(seq)
    assert ratios[1] == ratios[0]
    assert ratios[1][-1] == {"w": 0.3, "*": 0.9}


def test_magnitude_pruner_threshold(both):
    pscope = both["pscope"]
    name = next(n for n in _weights(both["pm"]) if "fc" in n)
    before = pscope.find_var(name).clone().numpy()
    thr = float(np.quantile(np.abs(before), 0.5))
    st = pslim.PruneStrategy(pslim.MagnitudePruner(thr), params=[name])
    st.apply_masks(pslim.Context(None, pslim.ImitationGraph(both["pm"]),
                                 pscope, program_exe=both["pexe"]))
    after = pscope.find_var(name).numpy()
    keep = np.abs(before) > thr
    np.testing.assert_array_equal(after[keep], before[keep])
    assert (after[~keep] == 0).all()


def test_slim_all_is_the_jax_packages():
    assert pslim.__all__ == jslim.__all__
    for sub in ("core", "graph", "prune"):
        assert (getattr(pslim, sub).__all__
                == getattr(jslim, sub).__all__), sub
