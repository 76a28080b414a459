#!/usr/bin/env python3
"""Rehearse chip_smoke.py's end-to-end phases (5-16) on the CPU at a tiny
Transformer, a small ResNet-50 (64x64 images, batch 4), a narrow
12-layer BERT (d_model 24, T 16, batch 4), phase 13's serving front
with fewer requests a window, phase 14's generation and phase 15's
predictor at a narrow LM (d_model 16, vocab 256) and phase 15's machine
translation at 40-word dictionaries and width 16, and phase 16 at the
tiny Transformer (its three trainer processes run this script with
``--elastic-child``, which sets up the same CPU patches) and the small
ResNet-50, to find faults in the script's Python before a run on the
card.

    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py

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
# 12 layers keep phase 12's launch counts
BERT_TINY = dict(vocab_size=100, max_len=16, max_masked=4, n_layer=12,
                 n_head=12, d_model=24, d_inner_hid=48)


# phase 14's buckets and traffic need max_positions 256
GEN_TINY = dict(vocab=256, n_layer=2, n_head=2, d_model=16, d_inner_hid=32,
                max_positions=256, eos_id=1)
# phase 15's machine translation at 40-word dictionaries, width 16, with
# the phase's beam, batch and 50 steps
MT_TINY = dict(src_dict_size=40, tgt_dict_size=40, emb_dim=16, hid=16,
               max_len=50, beam_size=4, decode_max_len=50)


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
    print(f"rehearsal passed in {time.perf_counter() - t0:.1f} s: launches "
          f"serving {served['launches']}, training {trained['launches']}, "
          f"compiled training {compiled}, analysis serving {analysis}, "
          f"ResNet-50 {resnet}, phase 11 {capture}, phase 12 {bert}, "
          f"phase 13 {front}, phase 14 {gen}, phase 15 {pred}, phase 16 "
          f"{runtime}")


if __name__ == "__main__":
    main()
