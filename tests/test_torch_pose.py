"""The SimpleBaseline pose network in the port against the JAX package, on
the CPU.

- **Programs.** ``testing.models.pose_resnet``'s train, startup and test
  programs byte-identical at MPII's widths (ResNet-50, 256x256, 16
  joints, three 256-filter deconvolutions) and at SMALL.
- **Training.** At SMALL (a 64x64 image, one bottleneck a stage at
  widths 8-64, 32-filter deconvolutions, 16 joints, batch 8) from the
  JAX startup's parameters: each of 3 Adam steps of the port within
  LOSS_REL of the JAX package's loss (the trajectories run free), and
  each of the JAX package's 3 steps replayed op by op: every op run by
  the port on the JAX package's input values agrees within REPLAY_REL of
  its output's largest magnitude, Adam's parameters and moments held by
  their change over the step. Free-running parameters are not compared
  tightly: 16 batch_norms part last bits into gradients a few percent
  apart where a gradient is near zero, and Adam's first update is near
  lr * sign(g) (measured: 4.4e-4 apart in relative L2 after 3 steps, one
  parameter 24% of its largest magnitude).
- **AMP.** The JAX package cannot run the AMP step: the backbone's bf16
  output meets the float32 filter of ``conv2d_transpose``, which has no
  AMP cast point, and ``lax`` refuses the pair. The port promotes the
  pair, so the deconvolution head runs in float32 (its outputs are
  float32) while the backbone runs in bf16 (its convolutions' outputs
  are bfloat16, read on the device); its 3 AMP steps from the
  same start stay within AMP_LOSS_REL of the JAX package's float32
  losses.
- **Serving.** The port's trained scope saved as an inference model of
  the test program (image -> heatmaps) and served by ``AnalysisPredictor``
  (its default passes) and ``NativePredictor``: both within SERVE_REL of
  the test program run by the executor, and of the JAX package's
  predictor on the same model directory.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import inference as jinference
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference as pinference
from paddle_tpu_torch.contrib import mixed_precision as pmp
from paddle_tpu_torch.testing import models as tmodels
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

from test_torch_ssd import _init_both, assert_rows_agree, replay_step

LOSS_REL = 1e-4
REPLAY_REL = 1e-4
# the port's AMP losses against the JAX package's float32 ones (measured
# 6.2e-6, 7.7e-4 and 1.5e-3 at steps 1-3: the heatmaps start near 0, so
# the first loss is the targets'; bf16 rounds the backbone's activations to
# 2^-8 and the steps after follow its gradients)
AMP_LOSS_REL = 1e-2
SERVE_REL = 1e-5
SMALL = dict(image=(3, 64, 64), stages=(1, 1, 1, 1), widths=(8, 16, 32, 64),
             deconv=32)
BATCH = 8
STEPS = 3


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _builds(**kw):
    with junique.guard():
        j = tmodels.pose_resnet(fluid, **kw)
    with punique.guard():
        p = tmodels.pose_resnet(pt, **kw)
    return j, p


@pytest.mark.parametrize("width", ["mpii", "small"])
def test_pose_programs_byte_identical(width):
    j, p = _builds(**({} if width == "mpii" else SMALL))
    for which in ("main", "startup", "test"):
        assert p[which].desc.to_bytes() == j[which].desc.to_bytes(), which
    block = p["main"].global_block()
    deconvs = [op for op in block.ops if op.type == "conv2d_transpose"]
    assert len(deconvs) == 3
    assert sum(op.type == "conv2d_transpose_grad" for op in block.ops) == 3
    if width == "mpii":
        assert p["heatmaps"].shape == (-1, 16, 64, 64)
        assert [block.var(op.input("Filter")[0]).shape for op in deconvs] \
            == [(2048, 256, 4, 4), (256, 256, 4, 4), (256, 256, 4, 4)]
        assert sum(op.type == "batch_norm" for op in block.ops) == 56


def _feed(cfg, seed):
    return tmodels.pose_batch(BATCH, cfg["image"], cfg["joints"], seed)


@pytest.fixture(scope="module")
def trained():
    """SMALL from the JAX startup: the port's 3 fp32 steps and 3 AMP steps
    (each from the same start), the JAX package's 3 steps, each replayed
    op by op by the port."""
    j, p, js, ps, jexe, pexe, names = _init_both(tmodels.pose_resnet,
                                                 **SMALL)
    feed = _feed(p["config"], seed=3)
    start = {n: np.array(ps.find_var(n).numpy()) for n in names}
    amp_main = pmp.decorate(p["main"].clone())
    ops = amp_main.global_block().ops
    heads = [op.output("Output")[0] for op in ops
             if op.type == "conv2d_transpose"]
    first_head = next(i for i, op in enumerate(ops)
                      if op.type == "conv2d_transpose")
    backbone = [op.output("Output")[0] for op in ops[:first_head]
                if op.type == "conv2d"]
    amp_scope = pt.Scope()
    pt.io.set_params_from_numpy(amp_scope, start, "cpu",
                                program=p["startup"])
    amp_losses, head_dtypes, backbone_dtypes = [], None, None
    for _ in range(STEPS):
        out = pexe.run(amp_main, feed=feed,
                       fetch_list=[p["loss"]] + heads + backbone,
                       scope=amp_scope, return_numpy=False)
        amp_losses.append(float(out[0].numpy().reshape(-1)[0]))
        dtypes = [o.device_value().dtype for o in out[1:]]
        head_dtypes = set(dtypes[:len(heads)])
        backbone_dtypes = set(dtypes[len(heads):])
    port_losses = [float(pexe.run(p["main"], feed=feed,
                                  fetch_list=[p["loss"]],
                                  scope=ps)[0].reshape(-1)[0])
                   for _ in range(STEPS)]
    jax_losses, replays = [], []
    for _ in range(STEPS):
        rows = replay_step(j, p, js, jexe, feed)
        jax_losses.append(float(next(r[2] for r in rows
                                     if r[1] == j["loss"].name
                                     ).reshape(-1)[0]))
        replays.append(rows)
    return dict(j=j, p=p, js=js, ps=ps, jexe=jexe, pexe=pexe, feed=feed,
                port_losses=port_losses, jax_losses=jax_losses,
                replays=replays, amp_losses=amp_losses,
                head_dtypes=head_dtypes, backbone_dtypes=backbone_dtypes,
                start=start)


def test_pose_losses_match_jax(trained):
    for jl, pl in zip(trained["jax_losses"], trained["port_losses"]):
        assert abs(pl - jl) <= LOSS_REL * abs(jl), (jl, pl)
    for losses in (trained["jax_losses"], trained["port_losses"]):
        assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("step", range(STEPS))
def test_pose_step_each_op_replayed_on_jax_values_agrees(trained, step):
    rows = trained["replays"][step]
    types = {r[0] for r in rows}
    assert {"conv2d_transpose", "conv2d_transpose_grad", "conv2d",
            "conv2d_grad", "batch_norm", "batch_norm_grad",
            "square_error_cost", "square_error_cost_grad",
            "elementwise_mul", "adam"} <= types
    # every parameter's update, both moments, and the running statistics
    n_params = len(trained["p"]["main"].all_parameters())
    assert sum(r[0] == "adam" for r in rows) >= 3 * n_params
    assert_rows_agree(rows)


def test_pose_amp_runs_the_head_in_float32(trained):
    """The JAX package's AMP step raises at the first deconvolution; the
    port's runs the backbone's convolutions in bfloat16 and the head in
    float32, and its losses stay near the float32 ones."""
    assert trained["backbone_dtypes"] == {torch.bfloat16}
    assert trained["head_dtypes"] == {torch.float32}
    for jl, al in zip(trained["jax_losses"], trained["amp_losses"]):
        assert abs(al - jl) <= AMP_LOSS_REL * abs(jl), (jl, al)
    assert trained["amp_losses"][-1] < trained["amp_losses"][0]
    j = trained["j"]
    amp = jmp.decorate(j["main"].clone())
    scope = fluid.Scope()
    for n, v in trained["start"].items():
        scope.set_var(n, v.copy())
    with pytest.raises(TypeError, match="same dtypes"):
        trained["jexe"].run(amp, feed=trained["feed"],
                            fetch_list=[j["loss"]], scope=scope)


def test_pose_served_heatmaps(trained, tmp_path):
    """The trained scope served: AnalysisPredictor (default passes) and
    NativePredictor against the test program on the executor and against
    the JAX package's predictor on the same model directory."""
    p, ps, pexe = trained["p"], trained["ps"], trained["pexe"]
    d = str(tmp_path / "pose")
    with pt.scope_guard(ps):
        pt.io.save_inference_model(d, ["image"], [p["heatmaps"]], pexe,
                                   main_program=p["test"])
    req = {"image": trained["feed"]["image"]}
    (want,) = pexe.run(p["test"], feed=trained["feed"],
                       fetch_list=[p["heatmaps"]], scope=ps)
    analysis = pinference.create_paddle_predictor(
        pinference.AnalysisConfig(d, use_gpu=False))
    native = pinference.create_paddle_predictor(
        pinference.NativeConfig(d, use_gpu=False))
    jpred = jinference.create_paddle_predictor(jinference.AnalysisConfig(d))
    top = np.abs(want).max()
    assert want.shape == (BATCH, 16, 16, 16) and top > 0
    for got in (analysis.run(req)[0].as_ndarray(),
                native.run(req)[0].as_ndarray(),
                np.asarray(jpred.run(req)[0].data)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=SERVE_REL * top)
