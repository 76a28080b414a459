"""Serving through ``AnalysisPredictor`` in the port against the JAX
package's, on the CPU, on a model directory the JAX package wrote.

(a) the rewritten program: the port's ``AnalysisConfig.DEFAULT_PASSES``
    leave the op list the JAX package's AnalysisPredictor leaves (fc_fuse
    turns every biased mul + add into ``fc``);
(b) fp32 logits within 1e-4 of the JAX package's (the NativePredictor's
    tolerance, tests/test_torch_predictor.py);
(c) bf16 (``enable_bf16``): the logits come back in bf16, every attention
    runs the flash wrapper on bf16 inputs, and the logits lie within
    2^-6 of the largest |logit| of the JAX package's bf16 logits and of
    the port's own fp32 logits. 2^-6 is two bf16 ulps at the largest
    magnitude (bf16 keeps 8 significant bits, so one rounding moves a
    value by up to 2^-8 of it and one ulp is 2^-7 of the top of its
    binade); measured here: 1 ulp against the JAX package (XLA on the CPU
    keeps some bf16 round trips in fp32), 0.85 ulp against fp32. The
    card's check (chip_smoke.py phase 8) derives its bound from this one;
(d) the knobs: ``switch_ir_optim(False)`` runs no pass,
    ``pass_builder_set`` runs the given ones, the serving wrappers raise
    on a bad value as the JAX package's do, and the predictor runs on the
    card unless ``use_gpu=False``;
(e) ROADMAP C1: programs that hold ``matmul``, ``square`` and
    ``elementwise_sub`` (the probe, which is not the FM pattern, and the
    FM pattern, which squared_mat_sub_fuse_pass fuses), saved by the JAX
    package and served by both AnalysisPredictors: the same op list and
    outputs within 1e-6 relative (fp32, a few float32 sums apart).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import inference as jinference
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

from paddle_tpu_torch import inference as pinference
from paddle_tpu_torch.ops import flash_attention as fa

from test_torch_ir import assert_same_ops

FEEDS = ["src_word", "src_pos", "trg_word", "trg_pos", "src_len", "trg_len"]
TINY = dict(n_layer=2, n_head=2, d_model=32, d_inner_hid=64, src_vocab=100,
            tgt_vocab=100, max_len=16)
FP32_ATOL = 1e-4
BF16_REL = 2.0 ** -6


@pytest.fixture(scope="module", params=["fused", "unfused"])
def model(request, tmp_path_factory):
    """A JAX-written model directory, a ragged batch, and the JAX
    package's AnalysisPredictor logits and program, fp32 and bf16."""
    old = JFLAGS.op_callstack
    JFLAGS.op_callstack = False
    try:
        with junique.guard():
            m = jtransformer.build(dropout_rate=0.0,
                                   attention_impl=request.param, **TINY)
    finally:
        JFLAGS.op_callstack = old
    d = str(tmp_path_factory.mktemp(f"jax_model_{request.param}"))
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
    out = {"dir": d, "feed": feed, "impl": request.param}
    for bf16 in (False, True):
        cfg = jinference.AnalysisConfig(d)
        cfg.enable_bf16(bf16)
        pred = jinference.create_paddle_predictor(cfg)
        logits = pred.run(feed)[0].data
        out[bf16] = (np.asarray(logits).astype(np.float32),
                     list(pred._program.global_block().desc.ops),
                     np.asarray(logits).dtype.name)
    return out


def _port(model, bf16=False, **cfg_kw):
    cfg = pinference.AnalysisConfig(model["dir"], use_gpu=False, **cfg_kw)
    cfg.enable_bf16(bf16)
    pred = pinference.create_paddle_predictor(cfg)
    assert isinstance(pred, pinference.AnalysisPredictor)
    return pred


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_rewritten_program_is_the_jax_packages(model, bf16):
    pred = _port(model, bf16)
    ops = list(pred._program.global_block().desc.ops)
    assert_same_ops(model[bf16][1], ops)
    types = [o.type for o in ops]
    # the FFN's two biased fcs per layer, 2 encoder and 2 decoder layers
    assert types.count("fc") == 8
    assert pred._program._amp == bf16


def test_fp32_logits_match_jax(model):
    logits = _port(model).run(model["feed"])[0].as_ndarray()
    np.testing.assert_allclose(logits, model[False][0], rtol=0,
                               atol=FP32_ATOL)


def test_fp32_analysis_matches_native(model):
    native = pinference.create_paddle_predictor(
        pinference.NativeConfig(model["dir"], use_gpu=False))
    want = native.run(model["feed"])[0].as_ndarray()
    got = _port(model).run(model["feed"])[0].as_ndarray()
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


def test_bf16_logits_match_jax_and_fp32(model, monkeypatch):
    seen = []
    real = fa.flash_attention_fwd

    def fwd(q, *a, **k):
        seen.append(q.dtype)
        return real(q, *a, **k)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    out = _port(model, bf16=True).run(model["feed"])[0]
    # fused: 2 encoder self, 2 decoder self, 2 cross attentions, all on
    # bf16; the default pass list leaves an unfused chain dense, as in
    # the JAX package
    assert seen == ([torch.bfloat16] * 6 if model["impl"] == "fused" else [])
    assert out.dtype == torch.bfloat16 and model[True][2] == "bfloat16"
    got = out.as_ndarray()
    jax_bf16, fp32 = model[True][0], _port(model).run(
        model["feed"])[0].as_ndarray()
    for want in (jax_bf16, fp32):
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), err


def test_attention_pass_in_the_pass_list(model, monkeypatch):
    """With fuse_attention_pass added, the unfused chains serve through
    the flash wrapper too, on the op list the JAX package's pass gives."""
    passes = list(pinference.AnalysisConfig.DEFAULT_PASSES) + [
        "fuse_attention_pass"]
    jcfg = jinference.AnalysisConfig(model["dir"])
    jcfg.pass_builder_set(passes)
    jpred = jinference.create_paddle_predictor(jcfg)
    seen = []
    real = fa.flash_attention_fwd
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        lambda q, *a, **k: seen.append(q.dtype) or real(
                            q, *a, **k))
    cfg = pinference.AnalysisConfig(model["dir"], use_gpu=False)
    pred = pinference.create_paddle_predictor(cfg.pass_builder_set(passes))
    assert_same_ops(list(jpred._program.global_block().desc.ops),
                    list(pred._program.global_block().desc.ops))
    logits = pred.run(model["feed"])[0].as_ndarray()
    assert seen == [torch.float32] * 6
    np.testing.assert_allclose(logits, model[False][0], rtol=0,
                               atol=FP32_ATOL)


def test_ir_optim_off_and_pass_lists(model):
    native = pinference.create_paddle_predictor(
        pinference.NativeConfig(model["dir"], use_gpu=False))
    cfg = pinference.AnalysisConfig(model["dir"], use_gpu=False)
    pred = pinference.create_paddle_predictor(cfg.switch_ir_optim(False))
    assert [o.type for o in pred._program.global_block().desc.ops] == [
        o.type for o in native._program.global_block().desc.ops]
    cfg = pinference.AnalysisConfig(model["dir"], use_gpu=False)
    pred = pinference.create_paddle_predictor(
        cfg.pass_builder_set(["fc_fuse_pass"]))
    types = [o.type for o in pred._program.global_block().desc.ops]
    assert types.count("fc") == 8
    assert isinstance(pinference.create_paddle_predictor(
        pinference.NativeConfig(model["dir"], use_gpu=False)),
        pinference.NativePredictor)


@pytest.mark.parametrize("knob", ["enable_shape_bucketing",
                                  "enable_request_coalescing"])
def test_serving_wrappers_raise(knob, tmp_path):
    """The knobs return their config (the wrappers are ported:
    tests/test_torch_serving.py); the wrapper a bad value selects raises
    ValueError at creation in both packages."""
    from paddle_tpu.testing.models import save_mlp
    d = save_mlp(str(tmp_path / "mlp"))
    bad = {"enable_shape_bucketing": {"batch_buckets": (0, 2)},
           "enable_request_coalescing": {"shed_policy": "lifo"}}[knob]
    for mod, cfgs in (
            (pinference, (pinference.NativeConfig(d, use_gpu=False),
                          pinference.AnalysisConfig(d, use_gpu=False))),
            (jinference, (jinference.NativeConfig(d),
                          jinference.AnalysisConfig(d)))):
        for cfg in cfgs:
            assert getattr(cfg, knob)(**bad) is cfg
            with pytest.raises(ValueError):
                mod.create_paddle_predictor(cfg)


def test_analysis_predictor_runs_on_the_card_by_default(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pinference.create_paddle_predictor(
            pinference.AnalysisConfig(model["dir"]))


# ---------------------------------------------------------------------------
# ResNet (resnet_cifar10): the conv passes on a JAX-written model directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet_model(tmp_path_factory):
    """A JAX-written resnet_cifar10 inference directory (random running
    statistics, so the batch_norm fold bites), a batch of 3 images, and
    the JAX package's AnalysisPredictor: logits fp32 and bf16, its op
    list and its scope after the passes."""
    from paddle_tpu.models import resnet as jresnet
    old = JFLAGS.op_callstack, JFLAGS.conv_layout_nhwc
    JFLAGS.op_callstack, JFLAGS.conv_layout_nhwc = False, False
    try:
        with junique.guard():
            m = jresnet.build(dataset="cifar10")
        d = str(tmp_path_factory.mktemp("jax_resnet"))
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        rng = np.random.RandomState(4)
        with fluid.scope_guard(scope):
            exe.run(m["startup"])
            for op in m["test"].global_block().desc.ops:
                if op.type == "batch_norm":
                    for slot, shift in (("Mean", 0.0), ("Variance", 0.5)):
                        n = op.input(slot)[0]
                        scope.set_var(n, (rng.rand(*np.shape(
                            scope.find_var(n))) + shift).astype("float32"))
            fluid.io.save_inference_model(d, ["data"], [m["predict"]], exe,
                                          main_program=m["test"])
        feed = {"data": rng.rand(3, 3, 32, 32).astype(np.float32)}
        out = {"dir": d, "feed": feed}
        for bf16 in (False, True):
            cfg = jinference.AnalysisConfig(d)
            cfg.enable_bf16(bf16)
            pred = jinference.create_paddle_predictor(cfg)
            logits = np.asarray(pred.run(feed)[0].data)
            out[bf16] = (logits.astype(np.float32),
                         list(pred._program.global_block().desc.ops),
                         pred._scope)
        return out
    finally:
        JFLAGS.op_callstack, JFLAGS.conv_layout_nhwc = old


def test_resnet_passes_fold_as_the_jax_package(resnet_model):
    """conv_bn_fuse_pass folds every batch_norm into its conv from the
    loaded values, and the conv_elementwise_add passes fuse what
    follows: the op list and every folded tensor are the JAX package's,
    bit for bit."""
    pred = _port(resnet_model)
    ops = list(pred._program.global_block().desc.ops)
    assert_same_ops(resnet_model[False][1], ops)
    types = [o.type for o in ops]
    native = pinference.create_paddle_predictor(
        pinference.NativeConfig(resnet_model["dir"], use_gpu=False))
    raw = [o.type for o in native._program.global_block().desc.ops]
    # every conv folds its batch_norm, then takes its bias add (and
    # relu, or residual add and relu) into a conv2d_fusion
    assert "batch_norm" not in types and "conv2d" not in types
    assert types.count("conv2d_fusion") == raw.count("conv2d") == 33
    jscope = resnet_model[False][2]
    folded = [n for n in jscope.var_names() if "@bn_fused_bias" in n
              or n.startswith("conv2d_") and n.endswith(".w_0")]
    assert len(folded) == 66
    for n in folded:
        assert np.array_equal(pred._scope.find_var(n).numpy(),
                              np.asarray(jscope.find_var(n))), n


def test_resnet_fp32_logits_match_jax_and_native(resnet_model):
    got = _port(resnet_model).run(resnet_model["feed"])[0].as_ndarray()
    np.testing.assert_allclose(got, resnet_model[False][0], rtol=0,
                               atol=FP32_ATOL)
    native = pinference.create_paddle_predictor(
        pinference.NativeConfig(resnet_model["dir"], use_gpu=False))
    np.testing.assert_allclose(
        got, native.run(resnet_model["feed"])[0].as_ndarray(), rtol=0,
        atol=FP32_ATOL)


def test_resnet_bf16_logits_match_jax_and_fp32(resnet_model):
    """bf16 serving of the folded ResNet: the softmax output in fp32
    (the fc's bias add promotes it, as in the JAX package), within 2^-6
    of the largest probability of the JAX package's bf16 output and of
    the port's own fp32 output (the Transformer's bound above)."""
    out = _port(resnet_model, bf16=True).run(resnet_model["feed"])[0]
    got = out.as_ndarray().astype(np.float32)
    fp32 = _port(resnet_model).run(resnet_model["feed"])[0].as_ndarray()
    for want in (resnet_model[True][0], fp32):
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# ROADMAP C1: matmul, square and elementwise_sub served
# ---------------------------------------------------------------------------

def _c1_program(fm):
    """The C1 probe (x -> matmul(x, w) -> square -> elementwise_sub(., the
    product)), or the FM pattern over two fed matrices; JAX-built."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with junique.guard(), fluid.program_guard(main, startup):
        if fm:
            x = fluid.layers.data(name="x", shape=[3, 4], dtype="float32")
            y = fluid.layers.data(name="y", shape=[4, 5], dtype="float32")
            xy = fluid.layers.matmul(x, y)
            x2y2 = fluid.layers.matmul(fluid.layers.square(x),
                                       fluid.layers.square(y))
            out = fluid.layers.scale(fluid.layers.elementwise_sub(
                fluid.layers.square(xy), x2y2), scale=0.5)
            feeds = ["x", "y"]
        else:
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            w = fluid.layers.create_parameter([4, 4], "float32",
                                              name="probe_w")
            xw = fluid.layers.matmul(x, w)
            out = fluid.layers.elementwise_sub(fluid.layers.square(xw), xw)
            feeds = ["x"]
    return main, startup, feeds, out


@pytest.mark.parametrize("fm", [False, True], ids=["probe", "fm"])
def test_squared_mat_sub_programs_serve_as_jax(fm, tmp_path):
    main, startup, feeds, out = _c1_program(fm)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    d = str(tmp_path / "c1")
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, feeds, [out], exe,
                                      main_program=main,
                                      export_for_deployment=False)
    rng = np.random.RandomState(4)
    feed = ({"x": rng.rand(2, 3, 4).astype(np.float32),
             "y": rng.rand(2, 4, 5).astype(np.float32)} if fm
            else {"x": rng.randn(3, 4).astype(np.float32)})
    jpred = jinference.create_paddle_predictor(jinference.AnalysisConfig(d))
    ppred = pinference.create_paddle_predictor(
        pinference.AnalysisConfig(d, use_gpu=False))
    assert_same_ops(list(jpred._program.global_block().desc.ops),
                    list(ppred._program.global_block().desc.ops))
    types = [o.type for o in ppred._program.global_block().desc.ops]
    assert types.count("fusion_squared_mat_sub") == int(fm)
    want = np.asarray(jpred.run(feed)[0].data)
    got = ppred.run(feed)[0].as_ndarray()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
