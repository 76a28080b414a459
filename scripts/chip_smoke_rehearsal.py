#!/usr/bin/env python3
"""Rehearse chip_smoke.py's end-to-end phases (5-22) on the CPU at a tiny
Transformer, a small ResNet-50 (64x64 images, batch 4), a narrow BERT
at phase 12's depth (d_model 24, T 16, batch 4), phase 13's serving
front with fewer requests a window, phase 14's generation and phase 15's
predictor at a narrow LM (d_model 16, vocab 256) and phase 15's machine
translation at 40-word dictionaries and width 16, and phase 16 at the
tiny Transformer (its three trainer processes run this script with
``--elastic-child``, which sets up the same CPU patches) and the small
ResNet-50, phase 17 at small widths (ZOO_TINY) and phase 18 at small
widths (machine translation at MT_TINY, label_semantic_roles at
SRL_TINY), phase 19 at small widths (PHASE19_TINY), phase 20 at small
widths (PHASE20_TINY), phase 22 at small widths (PHASE22_TINY) and phase
23 at small widths (PHASE23_TINY) and phase 25 (``--phase25``) at the
tiny Transformer and the narrow LM, to find faults in the script's Python
before a run on the card.

    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py
    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py --zoo  # 17 only
    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py --recurrent
                                                                  # 18 only
    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py --phase19
                                                                  # 19 only
    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py --phase20
                                                                  # 20 only
    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py --phase21
                                                                  # 21 only
    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py --phase22
                                                                  # 22 only
    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py --phase23
                                                                  # 23 only
    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py --phase25
                                                                  # 25 only

The executor and predictor defaults are pointed at the CPU, the CUDA
synchronise and memory-statistics calls are stubbed, and the flash
wrappers count their calls as launches (on the CPU they compute the
plain versions and count nothing themselves), which stand for the
profiler's traces of the card. FLAGS.fuse_optimizer_ops_on_cpu
is set, so phase 7's rewrite holds its fused_adam as on the card.
Times printed here are the CPU's; they say nothing about the card.
"""

import contextlib
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import executor as pexecutor  # noqa: E402
from paddle_tpu_torch.inference import api as papi  # noqa: E402
from paddle_tpu_torch.inference.generation import engine as pengine  # noqa: E402,E501
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.utils.flags import FLAGS  # noqa: E402

# 6 + 6 layers keep the phases' names (dec5_catt_v.w) and launch counts;
# T 64 is the smallest the request lengths [64, T] allow, and the vocab
# exceeds 16 * 64 for phase 7's batch of ids that do not repeat
TINY = dict(src_vocab=2000, tgt_vocab=2000, max_len=64, n_layer=6,
            n_head=2, d_model=16, d_inner_hid=32, dropout_rate=0.0)
# BERT's layer count keeps phase 12's launch counts
BERT_TINY = dict(vocab_size=100, max_len=16, max_masked=4,
                 n_layer=cs.BERT["n_layer"],
                 n_head=12, d_model=24, d_inner_hid=48)


# phase 14's buckets and traffic need max_positions 256
GEN_TINY = dict(vocab=256, n_layer=2, n_head=2, d_model=16, d_inner_hid=32,
                max_positions=256, eos_id=1)
# phase 15's machine translation at 40-word dictionaries, width 16, with
# the phase's beam, batch and 50 steps
MT_TINY = dict(src_dict_size=40, tgt_dict_size=40, emb_dim=16, hid=16,
               max_len=50, beam_size=4, decode_max_len=50)


# phase 17 at small widths: DeepFM at vocab 1000 (its 2^31-pair gate
# needs the card's 131072 rows), SE-ResNeXt-50 at 64x64, the stacked LSTM
# at width 16 and T 10; the rest of the zoo at its defaults
ZOO_TINY = dict(
    DEEPFM=dict(sparse_vocab=1000, num_fields=5, dense_dim=3, embed_dim=4,
                fc_sizes=(16, 16, 16)),
    DEEPFM_BATCH=256, DEEPFM_RUNS=4, DEEPFM_STEPS=8, DEEPFM_MIN_PAIRS=0,
    SE_RESNEXT=dict(image_shape=[3, 64, 64], class_dim=10),
    SE_RESNEXT_BATCH=4, VGG_BATCH=8,
    STACKED_LSTM=dict(dict_size=100, emb_dim=16, lstm_size=16, max_len=10),
    STACKED_LSTM_BATCH=4)


# phase 18 at small widths: MT_TINY's machine translation and
# label_semantic_roles at max_len 12, word_dim 8, hidden 16, depth 2; the
# While at its batch of 4096
SRL_TINY = dict(max_len=12, word_dim=8, hidden_dim=16, depth=2)


# phase 19 at small widths: the CRNN at a [1, 16, 64] image, filters 4/8,
# GRU 8, 10 classes, labels of up to 6 ids; the IfElse program at width 20
# and hidden 16 with the phase's boundaries and steps; the op bank at
# batch 8, T 16, width 16; the text CNN at its widths
PHASE19_TINY = dict(
    CRNN=dict(image=(1, 16, 64), filters=(4, 8), hidden=8, classes=10,
              max_label=6),
    CRNN_BATCH=4, CRNN_STEPS=10, IFELSE=dict(hidden=16, in_dim=20),
    IFELSE_BATCH=16, COND_WIDTH=64, BANK_B=8, BANK_T=16, BANK_D=16)


# phase 20 at small widths: MobileNet-SSD at a 128x128 image, scale 0.25,
# 5 classes, 4 gt rows, batch 8; the YOLOv3 head at a 64 input, 4
# classes, channels 16/8/8, batch 2; the op bank at a [1, 32, 8, 12] C4
# map with the phase's attrs and fewer rows
PHASE20_TINY = dict(
    SSD=dict(image=(3, 128, 128), classes=5, scale=0.25, gt_pad=4),
    SSD_BATCH=8, SSD_STEPS=6,
    YOLO=dict(image=64, classes=4, channels=(16, 8, 8), gt_pad=4,
              nms_top_k=40, keep_top_k=30),
    YOLO_BATCH=2,
    DET_BANK=dict(c4=(32, 8, 12), rois=16, pool_rois=8, ps_rois=8, quads=8,
                  ssd_batch=4, priors=64, pre_nms=200, post_nms=50,
                  fpn_rois=64, yolo_batch=2, yolo_cells=16,
                  retina=(300, 120, 40)))


def _phase20():
    for k, v in PHASE20_TINY.items():
        setattr(cs, k, v)
    cs.time_ms = lambda fn, iters=30, warmup=5, graph=True: (fn(), 0.0)[1]
    t20 = time.perf_counter()
    out, _ = cs.detection_paths("CPU rehearsal")
    print(f"phase 20 rehearsed in {time.perf_counter() - t20:.1f} s")
    return out


# phase 22 at small widths: the pose net at SMALL of tests/test_torch_pose.py
# (a 64x64 image, one bottleneck a stage, 32-filter deconvolutions), batch
# 4; ResNet-50 with preprocessing at a 64x64 crop of 72x72, 10 classes,
# batch 8; the op bank's 3-D family at a [2, 3, 4, 16, 16] clip
PHASE22_TINY = dict(
    POSE=dict(image=(3, 64, 64), stages=(1, 1, 1, 1), widths=(8, 16, 32, 64),
              deconv=32),
    POSE_BATCH=4, RESNET_IMAGE=(3, 64, 64),
    PRE_RESNET=dict(dataset="flowers", depth=50, class_dim=10,
                    image_shape=[3, 64, 64], preprocess=True),
    PRE_RESNET_BATCH=8, C3D_CLIP=(2, 3, 4, 16, 16))


def _phase22():
    for k, v in PHASE22_TINY.items():
        setattr(cs, k, v)
    cs.time_ms = lambda fn, iters=30, warmup=5, graph=True: (fn(), 0.0)[1]
    t22 = time.perf_counter()
    out, _ = cs.vision_paths("CPU rehearsal")
    print(f"phase 22 rehearsed in {time.perf_counter() - t22:.1f} s")
    return out


# phase 23 at small widths: ResNet-50 at 64x64 images, 10 classes, batch
# 4 (QAT and pruning); phase 19's tiny CRNN; TBCNN's trees, the attention
# LSTM and the reader's step narrower
PHASE23_TINY = dict(
    RESNET_IMAGE=(3, 64, 64), RESNET_CLASSES=10, RESNET_BATCH=4,
    CRNN=PHASE19_TINY["CRNN"], CRNN_BATCH=4,
    TBCNN=dict(batch=2, nodes=48, feature=6, filters=8, depth=2),
    DAM=dict(batch=4, steps=6, width=16, hidden=8), READER_BATCH=16)


def _phase23():
    for k, v in PHASE23_TINY.items():
        setattr(cs, k, v)
    cs.time_ms = lambda fn, iters=30, warmup=5, graph=True: (fn(), 0.0)[1]
    t23 = time.perf_counter()
    out, _ = cs.quant_rest_paths("CPU rehearsal")
    print(f"phase 23 rehearsed in {time.perf_counter() - t23:.1f} s")
    return out


def _phase21():
    # the card's CUDA-graph timing has no CPU counterpart
    cs.time_ms = lambda fn, iters=30, warmup=5, graph=True: (fn(), 0.0)[1]
    t21 = time.perf_counter()
    out, _ = cs.tensor_loss_rnn_paths("CPU rehearsal")
    print(f"phase 21 rehearsed in {time.perf_counter() - t21:.1f} s")
    return out


def _phase19():
    for k, v in PHASE19_TINY.items():
        setattr(cs, k, v)
    # the card's CUDA-graph timing has no CPU counterpart
    cs.time_ms = lambda fn, iters=30, warmup=5, graph=True: (fn(), 0.0)[1]
    t19 = time.perf_counter()
    out, _ = cs.control_sequence_ctc_paths("CPU rehearsal")
    print(f"phase 19 rehearsed in {time.perf_counter() - t19:.1f} s")
    return out


def _recurrent():
    cs.MT, cs.SRL = MT_TINY, SRL_TINY
    t18 = time.perf_counter()
    rec, _ = cs.recurrent_paths("CPU rehearsal")
    print(f"phase 18 rehearsed in {time.perf_counter() - t18:.1f} s")
    return rec


def _zoo():
    for k, v in ZOO_TINY.items():
        setattr(cs, k, v)
    t17 = time.perf_counter()
    zoo, _ = cs.zoo_paths("CPU rehearsal")
    print(f"phase 17 rehearsed in {time.perf_counter() - t17:.1f} s")
    return zoo


def _phase25():
    """Phase 25 at the tiny Transformer and the narrow LM. On the CPU
    every run is eager and no graph is kept: the graphs' flash nodes are
    the phase's wants, and a session's flash kernels are the wrappers'
    calls in its window (the CPU trace holds aten ops, not kernels)."""
    from paddle_tpu_torch.profiling import session

    @contextlib.contextmanager
    def kept():
        yield [None]

    cs.graphs_kept = kept
    cs.graph_flash_nodes = lambda g: ((cs.FWD_PER_STEP, cs.BWD_PER_STEP),
                                      0)
    begin, ingest = session.ProfileSession._begin, \
        session.ProfileSession._ingest

    def _begin(self):
        self._fa0 = (fa.launches, fa.bwd_launches)
        return begin(self)

    def _ingest(self, wall, path):
        rep = ingest(self, wall, path)
        rep["_flash"] = (fa.launches - self._fa0[0],
                         fa.bwd_launches - self._fa0[1])
        return rep

    session.ProfileSession._begin = _begin
    session.ProfileSession._ingest = _ingest
    cs.flash_rows = lambda rep: (rep["_flash"], rep["_flash"])
    cs.GEN_LM = GEN_TINY
    # a traced CPU step of the tiny model takes some 0.4 s: the delay
    # must pass 3x the trailing median
    cs.OBS_DELAY_S = 4.0
    return cs.observability_paths("CPU rehearsal")[0]


def _d2h_copies(fn):
    """chip_smoke.d2h_copies without a trace: the host arrays fn returns
    (a decode chunk's tokens and done flags, a decode call's fetches)."""
    outs = fn()
    return len(outs), sum(o.nbytes for o in outs)


def _count_launches():
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def counted_fwd(q, *args, **kwargs):
        fa.launches += 1
        dtype = str(q.dtype).replace("torch.", "")
        fa.launch_dtypes[dtype] = fa.launch_dtypes.get(dtype, 0) + 1
        return fwd(q, *args, **kwargs)

    def counted_bwd(*args, **kwargs):
        fa.bwd_launches += fa.BWD_KERNELS
        return bwd(*args, **kwargs)

    fa.flash_attention_fwd, fa.flash_attention_bwd = counted_fwd, counted_bwd


def _device_rows(fn):
    """The profiler's rows as the card would give them: the flash kernels
    this call launched, by the counters the wrappers move."""
    fwd, bwd = fa.launches, fa.bwd_launches
    fn()
    return ([("flash_fwd_kernel", 1.0, fa.launches - fwd),
             ("flash_bwd_", 1.0, fa.bwd_launches - bwd)], 1.0)


@contextlib.contextmanager
def _traced_launches():
    """chip_smoke.traced_launches with the trace's counts taken from the
    wrappers' counters: on the CPU every run is eager, so each launch
    passes through its wrapper."""
    fa.launches = fa.bwd_launches = 0
    fa.launch_dtypes.clear()
    got = {}
    yield got
    got["traced"] = got["calls"] = (fa.launches, fa.bwd_launches)
    got["traced_bf16"] = fa.launch_dtypes.get("bfloat16", 0)
    got["calls_by_dtype"] = dict(fa.launch_dtypes)


def _on_the_cpu():
    """The patches every rehearsal process takes: the CPU for the card,
    the tiny widths, the stubbed CUDA calls and counted launches."""
    cs.MODEL = TINY
    cs.DROPOUT_MODEL = dict(TINY, n_layer=2, dropout_rate=0.1)
    # phase 16(B)'s loss bound is 5x what the card reads at Transformer-
    # base's widths; the tiny model's losses sit about 1e-5 apart on the
    # CPU, so the rehearsal holds them to 1e-4 (the gradient bound stays)
    cs.ACCUM_LOSS_REL = 1e-4
    cs.ELASTIC_CHILD = [sys.executable, os.path.abspath(__file__)]
    pexecutor.CUDAPlace = papi.CUDAPlace = pengine.CUDAPlace = \
        lambda device=0: pt.CPUPlace()
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.memory_allocated = lambda *a: 0
    FLAGS.fuse_optimizer_ops_on_cpu = True
    cs.device_rows = _device_rows
    cs.traced_launches = _traced_launches
    _count_launches()


def main():
    if "--elastic-child" in sys.argv:
        _on_the_cpu()
        i = sys.argv.index("--elastic-child")
        cs.elastic_child(*sys.argv[i + 1:i + 4])
        return
    _on_the_cpu()
    if "--zoo" in sys.argv:
        print(f"rehearsal passed: phase 17 {_zoo()}")
        return
    if "--recurrent" in sys.argv:
        print(f"rehearsal passed: phase 18 {_recurrent()}")
        return
    if "--phase19" in sys.argv:
        print(f"rehearsal passed: phase 19 {_phase19()}")
        return
    if "--phase20" in sys.argv:
        print(f"rehearsal passed: phase 20 {_phase20()}")
        return
    if "--phase21" in sys.argv:
        print(f"rehearsal passed: phase 21 {_phase21()}")
        return
    if "--phase22" in sys.argv:
        print(f"rehearsal passed: phase 22 {_phase22()}")
        return
    if "--phase23" in sys.argv:
        print(f"rehearsal passed: phase 23 {_phase23()}")
        return
    if "--phase25" in sys.argv:
        print(f"rehearsal passed: phase 25 {_phase25()}")
        return
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rehearsal_") as d, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_rehearsal_") as r:
        served = cs.main_path(d, False)
        trained = cs.training_path(False)
        compiled = cs.compiled_training_path(trained, False)
        analysis = cs.analysis_serving_path(d, served, False)
        cs.RESNET_IMAGE, cs.RESNET_BATCH = (3, 64, 64), 4
        resnet = cs.resnet_paths(r, "CPU rehearsal", False)
        capture = cs.capture_paths(d, r, "CPU rehearsal", False)
        cs.BERT, cs.BERT_BATCH = BERT_TINY, 4
        bert = cs.bert_paths("CPU rehearsal", False)
        # phase 13: fewer requests a window; ResNet-50's batch of 4 is an
        # exact bucket of its own ladder
        cs.FRONT_CHECK, cs.FRONT_REQUESTS = 16, 24
        cs.RESNET_FRONT_BUCKETS = (2, 4)
        front = cs.front_paths(d, r, served["cfg"], "CPU rehearsal")
    # phase 14 at a narrow LM with the phase's buckets, positions and
    # traffic; the trace of a chunk's host copies is the engine's own count
    cs.GEN_LM = GEN_TINY
    cs.d2h_copies = _d2h_copies
    gen, _ = cs.generation_paths("CPU rehearsal")
    # phase 15: the predictor at the same narrow LM with 16 of its 48
    # requests (naive_generate from 8 threads is slow on the CPU); the
    # machine translation at MT_TINY
    cs.MT = MT_TINY
    cs.PRED_REQUESTS = 16
    t15 = time.perf_counter()
    pred, _ = cs.predictor_and_beam_paths("CPU rehearsal")
    print(f"phase 15 rehearsed in {time.perf_counter() - t15:.1f} s")
    # phase 16 at the tiny Transformer and the 64x64 batch-4 ResNet-50
    t16 = time.perf_counter()
    cs.RESNET_IMAGE, cs.RESNET_BATCH = (3, 64, 64), 4
    runtime = cs.runtime_paths("CPU rehearsal")
    print(f"phase 16 rehearsed in {time.perf_counter() - t16:.1f} s")
    zoo = _zoo()
    rec = _recurrent()
    p19 = _phase19()
    p20 = _phase20()
    p21 = _phase21()
    p22 = _phase22()
    p23 = _phase23()
    print(f"rehearsal passed in {time.perf_counter() - t0:.1f} s: launches "
          f"serving {served['launches']}, training {trained['launches']}, "
          f"compiled training {compiled}, analysis serving {analysis}, "
          f"ResNet-50 {resnet}, phase 11 {capture}, phase 12 {bert}, "
          f"phase 13 {front}, phase 14 {gen}, phase 15 {pred}, phase 16 "
          f"{runtime}, phase 17 {zoo}, phase 18 {rec}, phase 19 {p19}, "
          f"phase 20 {p20}, phase 21 {p21}, phase 22 {p22}, phase 23 "
          f"{p23}")


if __name__ == "__main__":
    main()
