"""MobileNet-SSD and the YOLOv3 head in the port against the JAX package,
on the CPU.

- **Programs.** ``testing.models.mobilenet_ssd``'s train, startup and test
  programs byte-identical at PaddleCV's VOC widths (300x300, 21 classes,
  scale 1.0: 1917 priors) and at SMALL; ``yolov3_head``'s at 608 with 80
  classes and at YOLO_SMALL.
- **Training.** At SMALL (a 128x128 image, scale 0.25, 5 classes, batch
  8, 4 gt rows) from the JAX startup's parameters: the first loss within
  LOSS_REL relative, and each of 3 RMSProp steps of the JAX package
  replayed op by op: every op run by the port on the JAX package's input
  values agrees within REPLAY_REL of its output's largest magnitude
  (integer outputs, the matches and the mined negatives among them,
  exactly; RMSProp's state by its change over the step). Free-running
  trajectories are not comparable: MobileNet's 27 batch_norms amplify
  last-bit differences (activations part by 1e-4 relative by the 25th
  layer, step-1 gradients at the stem by 2%), and RMSProp's first update,
  lr * g / sqrt(0.05 g^2 + eps), is near lr * sign(g). Both packages'
  losses fall over their own 3 steps.
- **Evaluation.** The test program on the JAX package's trained state: the port's
  detections against the JAX package's (classes exact, scores and boxes
  within DET_TOL), and ``detection_map`` equal to the JAX op's and to
  ``metrics.DetectionMAP`` over the fetched detections. The detections
  pass a score threshold and two rankings (``nms_top_k``, then
  ``keep_top_k``) that a last-bit difference of the scores could flip,
  so ``multiclass_nms`` is also held on the JAX package's own decoded
  boxes and scores, where it must be exact.
- **Serving.** The ``detection_output`` model saved by the JAX package,
  served by the port's ``AnalysisPredictor`` against the JAX package's
  and the port's ``NativePredictor``.
- **The YOLOv3 head.** At YOLO_SMALL (batch 8) the first loss, the first
  Momentum step replayed op by op (the gradient through ``yolov3_loss``,
  the resize and the concats), then the decode's rows.
- **Detections** compare in rank order, class exact and score and box
  within DET_TOL, a run of scores within DET_TOL as a set, and at least
  SHARE of the live rows compared (``assert_most_detections_match``);
  YOLOv3's boxes are scaled from pixels to 0-1, its scores are not.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import inference as jinference
from paddle_tpu import registry as jreg
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference as pinference
from paddle_tpu_torch.metrics import DetectionMAP
from paddle_tpu_torch.testing import models as tmodels
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

from test_torch_detection import run_both

LOSS_REL = 1e-5
PARAM_REL = 1e-4
REPLAY_REL = 1e-4
DET_TOL = 1e-5
# the share of live detection rows a comparison must reach (all of them
# are compared at these seeds)
SHARE = 0.9
# batch 8: the last maps are 1x1, and a batch_norm needs at least 8 values
# a channel to be well conditioned
SMALL = dict(image=(3, 128, 128), classes=5, scale=0.25, gt_pad=4)
BATCH = 8
YOLO_SMALL = dict(image=64, classes=4, channels=(16, 8, 8), gt_pad=4,
                  nms_top_k=40, keep_top_k=30)


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def _builds(build, **kw):
    with junique.guard():
        j = build(fluid, **kw)
    with punique.guard():
        p = build(pt, **kw)
    return j, p


@pytest.mark.parametrize("width", ["voc", "small"])
def test_ssd_programs_byte_identical(width):
    j, p = _builds(tmodels.mobilenet_ssd, **({} if width == "voc" else SMALL))
    for which in ("main", "startup", "test"):
        assert p[which].desc.to_bytes() == j[which].desc.to_bytes(), which
    types = {o.type for o in p["main"].global_block().ops}
    assert {"prior_box", "iou_similarity", "bipartite_match",
            "target_assign", "mine_hard_examples", "box_coder",
            "smooth_l1_loss", "smooth_l1_loss_grad", "depthwise_conv2d",
            "rmsprop"} <= types
    test_types = {o.type for o in p["test"].global_block().ops}
    assert {"multiclass_nms", "detection_map"} <= test_types
    if width == "voc":
        # six maps of 19, 10, 5, 3, 2, 1 cells: 3 priors a cell on the
        # first, 6 on the others
        from paddle_tpu_torch.ops.kernels_detection import (
            expand_aspect_ratios)
        block = p["main"].global_block()
        cells, priors = [], 0
        for op in block.ops:
            if op.type == "prior_box":
                fh, fw = block.var(op.input("Input")[0]).shape[2:]
                per = (len(expand_aspect_ratios(op.attr("aspect_ratios"),
                                                op.attr("flip")))
                       + len(op.attr("max_sizes")))
                cells.append((fh, per))
                priors += fh * fw * per
        assert cells == [(19, 3), (10, 6), (5, 6), (3, 6), (2, 6), (1, 6)]
        assert priors == 1917


def _init_both(build, **kw):
    """Both builds and the JAX startup's parameters in a scope of each."""
    j, p = _builds(build, **kw)
    js = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(j["startup"], scope=js)
    names = [v.name for v in p["startup"].list_vars() if v.persistable]
    ps = pt.Scope()
    pt.io.set_params_from_numpy(
        ps, {n: np.asarray(js.find_var(n)) for n in names}, "cpu",
        program=p["startup"])
    return j, p, js, ps, jexe, pt.Executor(pt.CPUPlace()), names


def replay_step(j, p, js, jexe, feed):
    """One training step run by the JAX package, fetching every name the
    step writes once; then every op of the port's program run by the port
    on the JAX package's input values. Returns [(op type, var, JAX value,
    port value, absolute floor)] for every output written once, a
    persistable by its change over the step (floor: four float32 ulps of
    the new value's largest magnitude: RMSProp's moment is a quotient by
    a square root, which two compilers may round 2 ulps apart)."""
    ops = p["main"].global_block().desc.ops
    persistable = {v.name for v in p["main"].list_vars() if v.persistable}
    init = {n: np.array(js.find_var(n)) for n in persistable}
    writes = {}
    for op in ops:
        for n in op.output_arg_names():
            writes[n] = writes.get(n, 0) + 1
    names = sorted(n for n in writes
                   if n and n not in persistable and writes[n] == 1)
    vals = jexe.run(j["main"], feed=feed, fetch_list=names, scope=js)
    jvals = {n: np.array(v) for n, v in zip(names, vals)}
    post = {n: np.array(js.find_var(n)) for n in persistable}
    env = {n: torch.from_numpy(v) for n, v in init.items()}
    env.update({n: torch.from_numpy(v) for n, v in feed.items()})
    env.update({n: torch.from_numpy(v) for n, v in jvals.items()})
    ctx = pt.registry.EmitContext(torch.device("cpu"))
    rows = []
    for op in ops:
        ins = {s: [env[n] if n else None for n in ns]
               for s, ns in op.inputs.items()}
        outs = pt.executor._emitter(op.type)(ctx, ins, op.attrs)
        for slot, ns in op.outputs.items():
            floor = 1e-6
            if op.type == "batch_norm_grad" and slot == "Scale@GRAD":
                floor = _scale_grad_floor(ins)
            for n, v in zip(ns, outs.get(slot) or ()):
                if n in init:
                    rows.append((op.type, n, post[n] - init[n],
                                 v - torch.from_numpy(init[n]),
                                 4 * np.spacing(np.abs(post[n]).max())))
                    env[n] = v
                elif writes.get(n, 0) > 1:
                    env[n] = v
                elif n in jvals and v is not None:
                    rows.append((op.type, n, jvals[n], v, floor))
    return rows


def _scale_grad_floor(ins):
    """batch_norm's scale gradient is sum(dy * x_hat) over N, H, W: where
    it cancels to near zero, 1e-6 of the summands' magnitudes is the
    rounding of either summation order (relative to the sum itself it is
    not)."""
    dy, x = ins["Y@GRAD"][0].float(), ins["X"][0].float()
    mean = ins["SavedMean"][0].reshape(1, -1, 1, 1)
    inv = ins["SavedVariance"][0].reshape(1, -1, 1, 1)
    return 1e-6 * float((dy * (x - mean) * inv).abs().sum(
        dim=(0, 2, 3)).max())


def assert_rows_agree(rows):
    for op_type, name, want, got, floor in rows:
        if not want.size:
            continue
        if want.dtype.kind in "iub":
            assert got.numpy().tolist() == want.tolist(), (op_type, name)
            continue
        want = want.astype(np.float32)
        tol = REPLAY_REL * np.abs(want).max() + floor
        err = np.abs(got.float().numpy() - want).max()
        assert err <= tol, (op_type, name, err, np.abs(want).max())


@pytest.fixture(scope="module")
def trained():
    """SMALL trained 3 steps by the JAX package, each step replayed op by
    op by the port; the port's own 3 steps from the same start."""
    j, p, js, ps, jexe, pexe, names = _init_both(tmodels.mobilenet_ssd,
                                                 **SMALL)
    cfg = p["config"]
    feed = tmodels.detection_batch(BATCH, cfg["image"], cfg["classes"],
                                   cfg["gt_pad"], seed=3, max_boxes=3)
    port_losses = [float(pexe.run(p["main"], feed=feed,
                                  fetch_list=[p["loss"]],
                                  scope=ps)[0].reshape(-1)[0])
                   for _ in range(3)]
    jax_losses, replays = [], []
    for _ in range(3):
        rows = replay_step(j, p, js, jexe, feed)
        jax_losses.append(float(next(r[2] for r in rows
                                     if r[1] == j["loss"].name
                                     ).reshape(-1)[0]))
        replays.append(rows)
    return dict(j=j, p=p, js=js, ps=ps, jexe=jexe, pexe=pexe, feed=feed,
                names=names, port_losses=port_losses,
                jax_losses=jax_losses, replays=replays)


def test_ssd_first_loss_matches_jax(trained):
    jl, pl = trained["jax_losses"][0], trained["port_losses"][0]
    assert abs(pl - jl) <= LOSS_REL * abs(jl), (jl, pl)


def test_ssd_trains_in_both_packages(trained):
    for losses in (trained["jax_losses"], trained["port_losses"]):
        assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("step", [0, 1, 2])
def test_ssd_step_each_op_replayed_on_jax_values_agrees(trained, step):
    rows = trained["replays"][step]
    types = {r[0] for r in rows}
    assert {"prior_box", "iou_similarity", "bipartite_match",
            "target_assign", "mine_hard_examples", "box_coder",
            "smooth_l1_loss", "smooth_l1_loss_grad",
            "softmax_with_cross_entropy", "depthwise_conv2d",
            "depthwise_conv2d_grad", "batch_norm", "batch_norm_grad",
            "rmsprop"} <= types
    assert_rows_agree(rows)


def assert_detections_match(got, want, tol=DET_TOL):
    """Dense detections [B, K, 6] of two runs: row by row in rank order,
    class exact and score and box within ``tol``; where neighbouring
    scores lie within ``tol`` a last-bit difference may swap their ranks,
    so such a run of rows is compared as a set, and a run that reaches
    the last row (where ``keep_top_k`` cuts it) is not compared. Returns
    the number of rows compared."""
    assert got.shape == want.shape
    compared = 0
    for g, w in zip(got, want):
        i, n = 0, len(w)
        while i < n:
            e = i + 1
            while e < n and max(w[e - 1, 1] - w[e, 1],
                                g[e - 1, 1] - g[e, 1]) <= tol:
                e += 1
            if e == n and e - i > 1:
                break
            free = list(range(i, e))
            for row in w[i:e]:
                hit = next((k for k in free if g[k, 0] == row[0] and
                            np.abs(g[k, 1:] - row[1:]).max() <= tol), None)
                assert hit is not None, (row, g[i:e])
                free.remove(hit)
            compared += e - i
            i = e
    return compared


def assert_most_detections_match(got, want, share, tol=DET_TOL):
    """``assert_detections_match``, and at least ``share`` of ``want``'s
    live rows (class >= 0) compared, so that tie runs cut at the last row
    cannot leave the check empty."""
    compared = assert_detections_match(got, want, tol)
    live = int((want[..., 0] >= 0).sum())
    assert live > 0 and compared >= share * live, (compared, live)


def _label(feed):
    return np.concatenate([feed["gt_label"][..., None].astype(np.float32),
                           feed["gt_box"]], axis=2)


@pytest.fixture(scope="module")
def evaluated(trained):
    """The JAX package's trained state copied into a port scope, and the
    test program's detections and mAP from both packages on it."""
    t = trained
    j, p, js = t["j"], t["p"], t["js"]
    state = pt.Scope()
    pt.io.set_params_from_numpy(
        state, {n: np.asarray(js.find_var(n)) for n in t["names"]}, "cpu",
        program=p["startup"])
    fetch = [p["detections"].name, p["map"].name]
    jd, jm = t["jexe"].run(j["test"], feed=t["feed"], fetch_list=fetch,
                           scope=js)
    pd, pm = t["pexe"].run(p["test"], feed=t["feed"], fetch_list=fetch,
                           scope=state)
    return dict(t, state=state, jd=np.asarray(jd), jm=np.asarray(jm),
                pd=pd, pm=pm)


def test_ssd_evaluates_against_jax(evaluated):
    e = evaluated
    jd, pd = e["jd"], e["pd"]
    assert pd.shape == jd.shape == (BATCH, 200, 6)
    assert (pd[..., 0] >= 0).sum() > 0
    assert_most_detections_match(pd, jd, SHARE)
    # the mAP op on the JAX package's detections equals the JAX op's
    op = next(o for o in e["p"]["test"].global_block().ops
              if o.type == "detection_map")
    jo, po = run_both("detection_map", {"DetectRes": [jd],
                                        "Label": [_label(e["feed"])]},
                      dict(op.attrs))
    assert po["MAP"][0] == jo["MAP"][0] == e["jm"].reshape(-1)[0]
    metric = DetectionMAP(overlap_threshold=0.5, ap_version="11point")
    metric.update(pd, _label(e["feed"]))
    assert np.float32(metric.eval()) == e["pm"].reshape(-1)[0]


def test_ssd_nms_exact_on_jax_inputs(evaluated):
    """multiclass_nms of the port on the JAX package's decoded boxes and
    softmax scores: the rows equal exactly."""
    e = evaluated
    op = next(o for o in e["j"]["test"].global_block().ops
              if o.type == "multiclass_nms")
    boxes, scores = e["jexe"].run(e["j"]["test"], feed=e["feed"],
                                  fetch_list=[op.input("BBoxes")[0],
                                              op.input("Scores")[0]],
                                  scope=e["js"])
    jo, po = run_both("multiclass_nms", {"BBoxes": [np.asarray(boxes)],
                                         "Scores": [np.asarray(scores)]},
                      dict(op.attrs))
    assert po["Out"][0].tolist() == jo["Out"][0].tolist()
    assert (po["Out"][0][..., 0] >= 0).sum() > 0


def test_ssd_served_by_analysis_predictor(evaluated, tmp_path):
    e = evaluated
    d = str(tmp_path / "ssd")
    with fluid.scope_guard(e["js"]):
        fluid.io.save_inference_model(d, ["image"], [e["j"]["detections"]],
                                      e["jexe"], main_program=e["j"]["test"],
                                      export_for_deployment=False)
    req = {"image": e["feed"]["image"]}
    jpred = jinference.create_paddle_predictor(jinference.AnalysisConfig(d))
    ppred = pinference.create_paddle_predictor(
        pinference.AnalysisConfig(d, use_gpu=False))
    assert isinstance(ppred, pinference.AnalysisPredictor)
    want = np.asarray(jpred.run(req)[0].data)
    got = ppred.run(req)[0].as_ndarray()
    native = pinference.create_paddle_predictor(
        pinference.NativeConfig(d, use_gpu=False)).run(req)[0].as_ndarray()
    assert (got[..., 0] >= 0).sum() > 0
    for other in (want, native, e["pd"]):
        assert got.shape == other.shape == (BATCH, 200, 6)
        assert_most_detections_match(got, other, SHARE)


@pytest.mark.parametrize("width", ["coco608", "small"])
def test_yolov3_programs_byte_identical(width):
    j, p = _builds(tmodels.yolov3_head,
                   **({} if width == "coco608" else YOLO_SMALL))
    for which in ("main", "startup", "test"):
        assert p[which].desc.to_bytes() == j[which].desc.to_bytes(), which
    types = [o.type for o in p["main"].global_block().ops]
    assert types.count("yolov3_loss") == 3 and types.count("interpolate") == 2
    assert "yolov3_loss_grad" in types and "interpolate_grad" in types


def test_yolov3_head_trains_and_decodes_against_jax():
    """The head has 17 batch_norms, which amplify rounding as MobileNet's
    do: the first loss within LOSS_REL, the first Momentum step replayed
    op by op on the JAX package's values (``yolov3_loss_grad`` and
    ``interpolate_grad`` among them), then the decode of the JAX
    package's trained state."""
    j, p, js, ps, jexe, pexe, names = _init_both(tmodels.yolov3_head,
                                                 **YOLO_SMALL)
    cfg = p["config"]
    feed = tmodels.yolov3_batch(8, cfg["image"], cfg["channels"],
                                cfg["classes"], cfg["gt_pad"], seed=5,
                                max_boxes=3)
    train = {k: feed[k] for k in p["feeds"]}
    (pl,) = pexe.run(p["main"], feed=train, fetch_list=[p["loss"]], scope=ps)
    rows = replay_step(j, p, js, jexe, train)
    jl = float(next(r[2] for r in rows if r[1] == j["loss"].name
                    ).reshape(-1)[0])
    assert abs(float(pl.reshape(-1)[0]) - jl) <= LOSS_REL * abs(jl)
    assert {"yolov3_loss", "yolov3_loss_grad", "interpolate_grad",
            "momentum"} <= {r[0] for r in rows}
    assert_rows_agree(rows)
    state = pt.Scope()
    pt.io.set_params_from_numpy(
        state, {n: np.asarray(js.find_var(n)) for n in names}, "cpu",
        program=p["startup"])
    test_feed = {k: feed[k] for k in ("c5", "c4", "c3", "img_size")}
    (jd,) = jexe.run(j["test"], feed=test_feed,
                     fetch_list=[j["detections"]], scope=js)
    (pd,) = pexe.run(p["test"], feed=test_feed,
                     fetch_list=[p["detections"]], scope=state)
    jd = np.asarray(jd)
    assert (pd[..., 0] >= 0).any()
    # boxes in pixels of the 64-pixel image, to 0-1 as the SSD's are;
    # classes and scores as they are
    scale = np.array([1, 1, 64, 64, 64, 64], np.float32)
    assert_most_detections_match(pd / scale, jd / scale, SHARE)


def test_yolov3_loss_registered_with_its_intermediates():
    assert (jreg.lookup("yolov3_loss").intermediate_outputs
            == pt.registry.lookup("yolov3_loss").intermediate_outputs
            == ("ObjectnessMask", "GTMatchMask"))
