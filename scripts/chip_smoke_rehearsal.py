#!/usr/bin/env python3
"""Rehearse chip_smoke.py's end-to-end phases (5-10) on the CPU at a tiny
Transformer and a small ResNet-50 (64x64 images, batch 4), to find faults
in the script's Python before a run on the card.

    JAX_PLATFORMS=cpu python scripts/chip_smoke_rehearsal.py

The executor and predictor defaults are pointed at the CPU, the CUDA
synchronise and memory-statistics calls are stubbed, and the flash
wrappers count their calls as launches (on the CPU they compute the
plain versions and count nothing themselves). FLAGS.fuse_optimizer_ops_on_cpu
is set, so phase 7's rewrite holds its fused_adam as on the card.
Times printed here are the CPU's; they say nothing about the card.
"""

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
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.utils.flags import FLAGS  # noqa: E402

# 6 + 6 layers keep the phases' names (dec5_catt_v.w) and launch counts;
# T 64 is the smallest the request lengths [64, T] allow, and the vocab
# exceeds 16 * 64 for phase 7's batch of ids that do not repeat
TINY = dict(src_vocab=2000, tgt_vocab=2000, max_len=64, n_layer=6,
            n_head=2, d_model=16, d_inner_hid=32, dropout_rate=0.0)


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


def main():
    cs.MODEL = TINY
    pexecutor.CUDAPlace = papi.CUDAPlace = lambda device=0: pt.CPUPlace()
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    FLAGS.fuse_optimizer_ops_on_cpu = True
    _count_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rehearsal_") as d:
        served = cs.main_path(d, False)
        trained = cs.training_path(False)
        compiled = cs.compiled_training_path(trained, False)
        analysis = cs.analysis_serving_path(d, served, False)
    cs.RESNET_IMAGE, cs.RESNET_BATCH = (3, 64, 64), 4
    resnet_train = cs.resnet_training_path("CPU rehearsal", False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rehearsal_") as d:
        resnet_serve = cs.resnet_serving_path(d, "CPU rehearsal", False)
    print(f"rehearsal passed in {time.perf_counter() - t0:.1f} s: launches "
          f"serving {served['launches']}, training {trained['launches']}, "
          f"compiled training {compiled}, analysis serving {analysis}, "
          f"ResNet-50 training {resnet_train}, serving {resnet_serve}")


if __name__ == "__main__":
    main()
