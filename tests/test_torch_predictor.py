"""The slice as a whole on the CPU: the port's NativePredictor serving the
tiny Transformer against the JAX package's.

(a) a model directory written by the JAX package serves unchanged in the
    port, with the JAX predictor's logits;
(b) the port builds the model itself and takes the JAX parameters as
    numpy arrays (set_params_from_numpy): same logits;
(c) the port's own save -> load round trip: same logits;
(d) no entry point runs on the host unless asked.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import inference as jinference
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.utils import unique_name as junique

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference as pinference
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.utils import unique_name as punique

FEEDS = ["src_word", "src_pos", "trg_word", "trg_pos", "src_len", "trg_len"]
TINY = dict(n_layer=2, n_head=2, d_model=32, d_inner_hid=64, src_vocab=100,
            tgt_vocab=100, max_len=16)
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's model: initialized, saved, and its predictor's
    logits on a batch with ragged source and target lengths."""
    with junique.guard():
        m = jtransformer.build(dropout_rate=0.0, **TINY)
    d = str(tmp_path_factory.mktemp("jax_model"))
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(m["startup"])
        fluid.io.save_inference_model(d, FEEDS, [m["logits"]], exe,
                                      main_program=m["test"],
                                      export_for_deployment=False)
    batch = jtransformer.make_fake_batch(3, m["config"], seed=7)
    batch["src_len"] = np.array([16, 9, 4], np.int32)
    batch["trg_len"] = np.array([5, 16, 12], np.int32)
    feed = {k: batch[k] for k in FEEDS}
    pred = jinference.create_paddle_predictor(jinference.NativeConfig(d))
    logits = pred.run(feed)[0].data
    params = {v.name: np.asarray(scope.find_var(v.name))
              for v in m["test"].list_vars() if v.persistable}
    return {"dir": d, "feed": feed, "logits": np.asarray(logits),
            "params": params}


def _port_build():
    with punique.guard():
        return ptransformer.build(**TINY)


def test_a_port_predictor_serves_jax_model_dir(jax_side):
    pred = pinference.create_paddle_predictor(
        pinference.NativeConfig(jax_side["dir"], use_gpu=False))
    assert pred.device == torch.device("cpu")
    assert pred.get_input_names() == list(reversed(FEEDS))
    out = pred.run(jax_side["feed"])
    assert pred.get_output_names() == [out[0].name]
    logits = out[0].data
    assert logits.shape == jax_side["logits"].shape == (3, 16, 100)
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, jax_side["logits"], atol=ATOL)


def test_a_paddle_tensor_inputs(jax_side):
    pred = pinference.create_paddle_predictor(
        pinference.NativeConfig(jax_side["dir"], use_gpu=False))
    inputs = [pinference.PaddleTensor(jax_side["feed"][n], n)
              for n in pred.get_input_names()]
    out = pred.run(inputs)[0]
    assert out.shape == [3, 16, 100] and out.dtype == torch.float32
    np.testing.assert_allclose(out.as_ndarray(), jax_side["logits"],
                               atol=ATOL)
    with pytest.raises(ValueError, match="missing inputs"):
        pred.run({"src_word": jax_side["feed"]["src_word"]})


def test_b_port_build_with_jax_params(jax_side):
    m = _port_build()
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.set_params_from_numpy(scope, jax_side["params"], "cpu",
                                program=m["test"])
    logits, = exe.run(m["test"], feed=jax_side["feed"],
                      fetch_list=[m["logits"]], scope=scope)
    np.testing.assert_allclose(logits, jax_side["logits"], atol=ATOL)


def test_b_set_params_checks_names_shapes_dtypes(jax_side):
    m = _port_build()
    params = dict(jax_side["params"])
    name = "proj.w"
    scope = pt.Scope()
    with pytest.raises(KeyError, match="missing"):
        pt.io.set_params_from_numpy(
            scope, {k: v for k, v in params.items() if k != name}, "cpu",
            program=m["test"])
    with pytest.raises(ValueError, match="shape"):
        pt.io.set_params_from_numpy(scope, dict(params, **{
            name: params[name][:-1]}), "cpu", program=m["test"])
    with pytest.raises(TypeError, match="float64"):
        pt.io.set_params_from_numpy(scope, dict(params, **{
            name: params[name].astype(np.float64)}), "cpu",
            program=m["test"])


def test_c_port_save_load_round_trip(jax_side, tmp_path):
    m = _port_build()
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.set_params_from_numpy(scope, jax_side["params"], "cpu",
                                program=m["test"])
    with pt.scope_guard(scope):
        pt.io.save_inference_model(str(tmp_path), FEEDS, [m["logits"]], exe,
                                   main_program=m["test"])
    pred = pinference.create_paddle_predictor(
        pinference.NativeConfig(str(tmp_path), use_gpu=False))
    logits = pred.run(jax_side["feed"])[0].data
    np.testing.assert_allclose(logits, jax_side["logits"], atol=ATOL)
    # and the JAX predictor serves the port's directory
    jpred = jinference.create_paddle_predictor(
        jinference.NativeConfig(str(tmp_path), use_xla=False))
    np.testing.assert_allclose(jpred.run(jax_side["feed"])[0].data,
                               jax_side["logits"], atol=ATOL)


def test_c_combined_params_file_round_trip(jax_side, tmp_path):
    m = _port_build()
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.set_params_from_numpy(scope, jax_side["params"], "cpu",
                                program=m["test"])
    with pt.scope_guard(scope):
        pt.io.save_inference_model(str(tmp_path), FEEDS, [m["logits"]], exe,
                                   main_program=m["test"],
                                   params_filename="__params__")
    pred = pinference.create_paddle_predictor(pinference.NativeConfig(
        str(tmp_path), params_file="__params__", use_gpu=False))
    np.testing.assert_allclose(pred.run(jax_side["feed"])[0].data,
                               jax_side["logits"], atol=ATOL)


def test_c_port_startup_runs_and_serves(tmp_path):
    """The port's own startup (its random stream, not the JAX one)
    initializes every persistable of the train program (parameters and
    optimizer state); the served logits are finite and the run is
    reproducible from the program's seed."""
    m = _port_build()
    m["startup"].random_seed = 11
    outs = []
    for _ in range(2):
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(m["startup"], scope=scope)
        assert set(scope.var_names()) == {
            v.name for v in m["main"].list_vars() if v.persistable}
        feed = {k: v for k, v in ptransformer.make_fake_batch(
            2, m["config"]).items() if k in FEEDS}
        outs.append(exe.run(m["test"], feed=feed, fetch_list=[m["logits"]],
                            scope=scope)[0])
    assert np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_d_no_silent_cpu_fallback(jax_side, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pinference.create_paddle_predictor(
            pinference.NativeConfig(jax_side["dir"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Executor(pt.CUDAPlace(0))
    assert pt.Executor(pt.CPUPlace()).device == torch.device("cpu")


def test_d_missing_feed_is_named(jax_side):
    m = _port_build()
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.set_params_from_numpy(scope, jax_side["params"], "cpu",
                                program=m["test"])
    feed = dict(jax_side["feed"])
    feed.pop("trg_len")
    with pytest.raises(KeyError, match="trg_len"):
        exe.run(m["test"], feed=feed, fetch_list=[m["logits"]], scope=scope)
    # the loss reads the labels, which the logits do not
    with pytest.raises(KeyError, match="lbl_word"):
        exe.run(m["test"], feed=dict(jax_side["feed"]),
                fetch_list=[m["loss"]], scope=scope)
