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
    ``pass_builder_set`` runs the given ones, the serving wrappers raise,
    and the predictor runs on the card unless ``use_gpu=False``.
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
def test_serving_wrappers_raise(knob):
    for cfg in (pinference.NativeConfig("d"), pinference.AnalysisConfig("d")):
        with pytest.raises(NotImplementedError, match="A6"):
            getattr(cfg, knob)()


def test_analysis_predictor_runs_on_the_card_by_default(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pinference.create_paddle_predictor(
            pinference.AnalysisConfig(model["dir"]))
