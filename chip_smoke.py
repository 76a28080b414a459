#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # the contract run
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of one
                                     # backward call, one request and one
                                     # fp32 and one AMP train step by
                                     # device kernel
    python3 chip_smoke.py --kernels  # phases 1-4 only: the short loop for
                                     # work on a kernel

Phases, in order; any failure exits non-zero and no phase is skipped:

1. device: a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them. TF32 is switched off, so float32
   products are full float32 on both sides of every comparison.
2. build: compiles every kernel from ``paddle_tpu_torch/csrc`` (one nvcc
   per source, all at once) and prints each kernel's registers, stack
   frame (where spills go), tensor-core (``HMMA``) instructions and SASS
   mix, all read from the built library; fails on a kernel with no
   ``HMMA`` or, at the model path's head width, with a stack frame: the
   forward and the backward's dK/dV and dQ kernels, each in float32 and
   bfloat16. The backward's delta kernel (one reduction per row) is
   exempt.
3. kernels against their plain versions on the card: the forward at the
   model path's shape [8, 8, 256, 64] in float32 and bfloat16 and at
   shapes that reach every head-dim tier, ragged KV stages and unaligned
   rows; the backward (dQ, dK, dV, dKeyBias against
   ``plain_attention_bwd``) the same way, causal and not, with key-bias
   tails and ragged Tq != Tk, and at the train step's [16, 8, 256, 64],
   the grid that the training path launches.
4. kernel timing at [8, 8, 256, 64] (the shape of a request), the
   backward also at [16, 8, 256, 64] (the shape of a train step), each
   the card's time per call from a CUDA-graph replay of 30 calls (the
   eager back-to-back time, host cost included, beside it): kernel,
   plain version, one library call (``scaled_dot_product_attention``,
   forward; its backward as graph replays of forward + backward less
   forward; timed as a yardstick and never called by the port) and the
   bound from the card's data-sheet rates. Forward: float32 takes three
   TF32 tensor-core products per product (3 * flops at 495 TFLOP/s; the
   CUDA-core bound at 67 TFLOP/s beside it), bfloat16 one (flops at 495
   TFLOP/s; 989 beside it). Backward: 5 products of 2*B*H*Tq*Tk*D;
   float32 as 3xTF32 at 495 TFLOP/s (67 TFLOP/s beside it), bfloat16 at
   989 TFLOP/s, each against the bytes read and written once at 3.35
   TB/s.
5. serving: Transformer-base (the bench_transformer widths, random
   weights from a seed) built with the port's layers, initialized on the
   card, saved as an inference model and served by
   ``create_paddle_predictor(NativeConfig(dir))``: 4 requests of batch 8
   with mixed source and target lengths (18 forward launches each, no
   backward), then a batch-1 request replayed through a CPU predictor on
   the same directory.
6. training: the same model's train program (noam schedule with warmup
   8000, Adam) on ``Executor()``: 5 fp32 steps and 5 bf16-AMP steps
   (``mixed_precision.decorate``) at batch 16, T 256, from the same
   initial weights, each step 36 forward and 18 * 3 backward kernel
   launches, losses finite and the AMP losses within 1e-2 relative of the
   fp32 ones; then one batch-2 step replayed through
   ``Executor(CPUPlace())`` from the same weights: loss, the gradients of
   proj.w, enc0_att_q.w, dec5_catt_v.w and src_word_emb, and their
   updated parameters against the card's and against the Adam formula;
   and one batch-2 AMP step replayed the same way on the AMP program, at
   the CPU AMP tests' tolerances.
7. training through ``CompiledProgram``: the same model built with
   ``attention_impl="unfused"`` (the matmul/softmax chain) under
   bench.py's BuildStrategy (fuse_all_optimizer_ops,
   fuse_elewise_add_act_ops, memory_optimize, fuse_conv_ops,
   fuse_attention_ops). The rewritten op list must hold 18
   ``flash_attention``, 18 ``flash_attention_grad``, no ``softmax`` and
   a ``fused_adam`` before any step runs (the dense chain never runs);
   the pipeline's time, its ops removed per stage and the memo hits are
   printed. 3 fp32 and 3 AMP steps from phase 6's weights, 36 forward
   and 54 backward launches each; the fp32 steps against phase 6's fused
   build on a plain ``Executor()`` at the JAX package's fused-vs-unfused
   tolerances; a batch-2 AMP step replayed on the CPU; and one step of
   phase 6's program with and without ``fuse_all_optimizer_ops`` alone,
   on a batch whose ids do not repeat (so no atomics reorder the
   embedding gradient), bitwise equal in every persistable. Then the
   fused build and the compiled program, fp32 and AMP, timed in turns.
8. serving through ``AnalysisPredictor``: phase 5's model directory and
   its 4 batch-8 requests through
   ``create_paddle_predictor(AnalysisConfig(dir).enable_bf16())``: 18
   forward launches per request, every one on bf16 inputs; the logits
   against phase 5's fp32 ``NativePredictor`` logits within 2^-5 of the
   largest |logit| (arg-max agreement printed); with ``enable_bf16(False)``
   within phase 5's 1e-3 of it; and a batch-1 bf16 request replayed
   through a CPU ``AnalysisPredictor``.

The line before the last lists every ported kernel with its launches on
each path (null under ``--kernels``); the last line is the device record.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.desc import ProgramDesc
from paddle_tpu_torch.contrib import mixed_precision
from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                        create_paddle_predictor)
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.utils import unique_name

SEED = 2024
FEEDS = ["src_word", "src_pos", "trg_word", "trg_pos", "src_len", "trg_len"]
TRAIN_FEEDS = FEEDS + ["lbl_word"]
# bench_transformer widths: 6 + 6 layers, d_model 512, 8 heads, seq 256
MODEL = dict(src_vocab=32000, tgt_vocab=32000, max_len=256, n_layer=6,
             n_head=8, d_model=512, d_inner_hid=2048, dropout_rate=0.0)
MAIN_SHAPE = (8, 8, 256, 64)     # [B, H, T, D] of every attention per request
TRAIN_SHAPE = (16, 8, 256, 64)   # ... and per train step
LAUNCHES_PER_REQUEST = 18        # 6 encoder self + 6 decoder self + 6 cross
TRAIN_BATCH = 16                 # the JAX build's default batch
TRAIN_STEPS = 5
# per train step: each attention's forward, and its recompute inside the
# grad op, then the backward's delta, dK/dV and dQ kernels
FWD_PER_STEP = 2 * LAUNCHES_PER_REQUEST
BWD_PER_STEP = LAUNCHES_PER_REQUEST * fa.BWD_KERNELS
REPLAY_GRADS = ["proj.w", "enc0_att_q.w", "dec5_catt_v.w", "src_word_emb"]
# AMP replay tolerances, those the CPU AMP tests hold the port's AMP step
# to against the JAX package's (tests/test_torch_training.py): the loss
# within 1e-2 relative, the checked gradients together within 0.1
# relative in L2 and each within 0.5. The card and the CPU round to bf16
# at the same points (one program, the same amp_cast); they differ in the
# fp32 accumulation order inside each product (cuBLAS and the flash
# kernels against the CPU's GEMMs and the plain attention), which flips
# the last bf16 bit of some outputs, and a ReLU whose input lies within a
# bf16 ulp of 0 passes its gradient on one side only: the two sources of
# drift those tests bound.
AMP_REPLAY_TOL = {"loss": 1e-2, "grads_l2": 0.1, "grad_l2": 0.5}
# phase 7: steps per arm, and the JAX package's tolerances for its own
# fused-vs-unfused attention parity (tests/test_attention_fusion.py:99-102;
# the rewrite reassociates the scale), as (rtol, atol)
COMPILED_STEPS = 3
FUSION_LOSS_TOL = (2e-4, 1e-5)
FUSION_PARAM_TOL = (2e-3, 2e-5)
# phase 8: bf16 logits against fp32 within this fraction of the largest
# |logit|. tests/test_torch_analysis.py holds the tiny model (2 + 2
# layers) at 2^-6 and measures 0.85 bf16 ulp there; rounding drift grows
# about as the square root of depth, 1.7x for 6 + 6 layers, so twice the
# CPU bound (4 bf16 ulps at the largest magnitude)
BF16_SERVE_REL = 2.0 ** -5

# H100 SXM data-sheet rates (dense), the denominators of bound_ms
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# tensor-core products per product the kernel runs: 3xTF32 for float32
TF32_PRODUCTS = {torch.float32: 3, torch.bfloat16: 1}

# fp32: the kernel and the plain version differ only in summation order
# (online softmax with rescaling against one softmax), TF32 off.
# bf16: the kernel reads bf16, accumulates in fp32 and rounds O to bf16
# once; it is held against the plain version on the same values in fp32,
# so the bound is bf16's half-ulp of |O| < 4 (2^-7 = 7.8e-3) with margin.
TOL = {torch.float32: {"out": 1e-4, "lse": 1e-4},
       torch.bfloat16: {"out": 2e-2, "lse": 1e-3}}
# backward, relative to each gradient's largest magnitude. fp32: every
# product is 3xTF32 with the small term truncated, about 2^-21 relative
# per product (6.3e-6 measured at most); one TF32 product would give
# 8.4e-4 to 1.3e-3 (CPU emulation), which 1e-4 rejects. bf16: P and
# dSoft are rounded to bf16 as operands and dQ, dK, dV once on output
# (half an ulp, 2^-8 of the largest), held against the plain version on
# the same values in fp32; dKeyBias is summed in fp32.
BWD_TOL = {torch.float32: {"grad": 1e-4, "dkb": 1e-4},
           torch.bfloat16: {"grad": 1e-2, "dkb": 1e-4}}


def log(msg=""):
    print(msg, flush=True)


def phase(name):
    log(f"== {name}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of each kernel
# ---------------------------------------------------------------------------

def _kernel_name(mangled):
    """flash_fwd_kernel<float, 64> (or flash_bwd_delta_kernel<bf16>) from
    its mangled name."""
    m = re.search(r"(\w+_kernel)I(f|13__nv_bfloat16)(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled[:60]
    name = re.sub(r"^.*\d(?=[a-z])", "", m.group(1))  # drop the namespace
    dtype = "float" if m.group(2) == "f" else "bf16"
    return f"{name}<{dtype}, {m.group(3)}>" if m.group(3) else f"{name}<{dtype}>"


def kernel_report(name):
    """{kernel: {registers, stack_bytes, hmma, opcodes}} of one library,
    read from the library itself (so also from one an earlier run built):
    registers and stack frame, where spilled registers go, from
    ``cuobjdump -res-usage``; opcodes (static SASS instruction count by
    opcode) from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")

    def dump(flag):
        return subprocess.run([cuobjdump, flag, _build.library_path(name)],
                              check=True, capture_output=True, text=True,
                              timeout=300).stdout

    rows, cur = {}, None
    new = lambda: {"registers": None, "stack_bytes": None, "hmma": 0,
                   "opcodes": {}}
    for line in dump("-res-usage").splitlines():
        m = re.match(r"\s*Function (\w+):", line)
        if m:
            cur = rows.setdefault(_kernel_name(m.group(1)), new())
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)
        if cur is not None and m:
            cur["registers"] = int(m.group(1))
            cur["stack_bytes"] = int(m.group(2)) + int(m.group(3))
    cur = None
    for line in dump("-sass").splitlines():
        m = re.match(r"\s*Function : (\w+)", line)
        if m:
            cur = rows.setdefault(_kernel_name(m.group(1)), new())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if cur is not None and m:
            op = m.group(1)
            cur["opcodes"][op] = cur["opcodes"].get(op, 0) + 1
            cur["hmma"] += op == "HMMA"
    return rows


# ---------------------------------------------------------------------------
# phase 3 / 4: the kernel against its plain version
# ---------------------------------------------------------------------------

def make_case(b, h, tq, tk, d, dtype, key_lens=None, seed=0):
    """q, k, v from a seeded generator on the card; a key bias of 0 / -1e9
    that keeps the first key_lens[i] keys of batch row i."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
    kb = None
    if key_lens is not None:
        kb = torch.zeros(b, tk, device="cuda")
        for i, n in enumerate(key_lens):
            kb[i, n:] = -1e9
    return q, k, v, kb


def check_case(name, q, k, v, kb, causal):
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, kb, causal, scale)
    torch.cuda.synchronize()
    ref, ref_lse = fa.plain_attention(q.float(), k.float(), v.float(), kb,
                                      causal, scale)
    tol = TOL[q.dtype]
    err = (out.float() - ref).abs().max().item()
    # relative slack for rows whose lse sits at -1e9 / -1e30 (fully masked)
    lse_err = ((lse - ref_lse).abs() - 1e-6 * ref_lse.abs()).max().item()
    msg = (f"{name:<28} {str(q.dtype)[6:]:<8} q{list(q.shape)} "
           f"k{list(k.shape)} causal={int(causal)} max|dO|={err:.3e} "
           f"max|dlse|={max(lse_err, 0.0):.3e}")
    if q.dtype == torch.bfloat16:
        same, _ = fa.plain_attention(q, k, v, kb, causal, scale)
        msg += (f" (vs plain in bf16: "
                f"{(out.float() - same.float()).abs().max().item():.3e})")
    log(msg)
    if not (torch.isfinite(out).all() and err <= tol["out"]
            and lse_err <= tol["lse"]):
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version (tolerance {tol})")
    return err


def kernel_cases(dtype):
    b, h, t, d = MAIN_SHAPE
    rng = np.random.RandomState(SEED)
    lens = lambda n, hi: [int(x) for x in rng.randint(hi // 4, hi + 1, n)]
    yield "enc self (key bias)", make_case(b, h, t, t, d, dtype, lens(b, t), 1), False
    yield "dec self (causal, bias)", make_case(b, h, t, t, d, dtype, lens(b, t), 2), True
    yield "cross (key bias)", make_case(b, h, t, t, d, dtype, lens(b, t), 3), False
    yield "ragged T=77 D=48", make_case(2, 3, 77, 77, 48, dtype, [77, 50], 4), True
    yield "Tq=100 Tk=300", make_case(2, 3, 100, 300, 64, dtype, [300, 123], 5), False
    yield "Tq=100 Tk=300 causal", make_case(2, 3, 100, 300, 64, dtype, [300, 250], 6), True
    yield "Tq=300 Tk=100 causal", make_case(2, 3, 300, 100, 64, dtype, None, 7), True
    yield "fully masked row", make_case(2, 2, 128, 128, 64, dtype, [0, 128], 8), False
    yield "D=128", make_case(2, 4, 200, 200, 128, dtype, [200, 99], 9), False
    yield "Tk=1", make_case(2, 3, 70, 1, 64, dtype, [1, 1], 21), False
    yield "Tk=65 (ragged 2nd stage)", make_case(2, 3, 100, 65, 64, dtype, [65, 40], 22), False
    yield "Tk=129 (ragged 3rd stage)", make_case(2, 3, 129, 129, 64, dtype, [129, 100], 23), True
    yield "Tq=70 Tk=129", make_case(2, 3, 70, 129, 64, dtype, [129, 66], 24), False
    yield "D=32", make_case(2, 4, 150, 150, 32, dtype, [150, 77], 25), True
    yield "D=80", make_case(2, 4, 150, 150, 80, dtype, [150, 77], 26), False
    yield "D=96", make_case(2, 4, 150, 150, 96, dtype, [150, 77], 27), True
    yield "causal T=300 (5 q tiles)", make_case(2, 3, 300, 300, 64, dtype, [300, 211], 28), True
    yield "B*H=512", make_case(32, 16, 64, 64, 64, dtype, lens(32, 64), 29), False
    yield "D=33 (unaligned rows)", make_case(2, 3, 90, 90, 33, dtype, [90, 45], 30), True


def time_ms(fn, iters=30, warmup=5, graph=True):
    """Milliseconds per call of ``fn``. graph=True: ``iters`` calls
    captured in a CUDA graph and replayed, so the time is the card's and
    the host's per-call cost (Python, allocation, launch) is not in it;
    graph=False: eager calls back to back, host cost included where it
    exceeds the card's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run, reps = g.replay, 5
        run()
    else:
        def run():
            for _ in range(iters):
                fn()
        reps = 1
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * reps)


def bound(q, k, v, kb, causal):
    """(bound_ms, bound_by, other_ms): the kernel's bound on the TF32
    tensor cores, and beside it the bound at float32's CUDA-core rate
    (float32) or at the bf16 tensor-core rate (bfloat16)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + b * h * tq * 4 + (kb.numel() * 4 if kb is not None else 0)
    flops = 4 * b * h * tq * tk * d / (2 if causal else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = TF32_PRODUCTS[q.dtype] * flops / TF32_FLOPS * 1e3
    other = flops / (CUDA_CORE_FP32_FLOPS if q.dtype == torch.float32
                     else BF16_FLOPS) * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, other))


def time_kernel(dtype, causal):
    b, h, t, d = MAIN_SHAPE
    q, k, v, kb = make_case(b, h, t, t, d, dtype, [t] * (b // 2) + [t // 2] * (b // 2), 11)
    scale = d ** -0.5
    mask = kb[:, None, None, :].to(dtype)
    if causal:
        tri = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        mask = mask.masked_fill(~tri, -1e30)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel = lambda: fa.flash_attention_fwd(q, k, v, kb, causal, scale)
    row = {
        "plain_ms": time_ms(lambda: fa.plain_attention(q, k, v, kb, causal, scale)),
        "library_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale)),
        "eager_ms": time_ms(kernel, graph=False),
        "ms": time_ms(kernel),
    }
    row["bound_ms"], row["bound_by"], row["bound_other_ms"] = bound(
        q, k, v, kb, causal)
    return row


def check_bwd_case(name, q, k, v, kb, causal):
    """The backward kernels against plain_attention_bwd on the same
    inputs (the kernel's own forward output and lse, a seeded dO); the
    largest absolute error over dQ, dK, dV and dKeyBias."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, kb, causal, scale)
    gen = torch.Generator(device="cuda").manual_seed(q.shape[2] + k.shape[2])
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    got = fa.flash_attention_bwd(q, k, v, kb, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    want = fa.plain_attention_bwd(q.float(), k.float(), v.float(), kb,
                                  out.float(), lse, do.float(), causal, scale)
    tol = BWD_TOL[q.dtype]
    errs, worst = [], 0.0
    for gname, g, w in zip(("dQ", "dK", "dV", "dKB"), got, want):
        if w is None:
            continue
        err = (g.float() - w).abs().max().item()
        top = w.abs().max().item()
        worst = max(worst, err)
        errs.append(f"{gname} {err:.2e}/{top:.2e}")
        limit = tol["dkb" if gname == "dKB" else "grad"] * top + 1e-6
        if not (torch.isfinite(g).all() and err <= limit):
            raise AssertionError(f"{name}: backward {gname} disagrees with "
                                 f"the plain version ({err:.3e} > {limit:.3e})")
    log(f"{name:<28} {str(q.dtype)[6:]:<8} q{list(q.shape)} "
        f"k{list(k.shape)} causal={int(causal)} max|err|/max|grad|: "
        + ", ".join(errs))
    return worst


def bwd_cases(dtype):
    """Every head-dim tier, causal and not, key-bias tails, ragged Tq !=
    Tk, and the train step's shape, whose grid takes several waves per
    pass (so dQ, launched dependent on dK/dV, starts behind them); no row
    sees no key (the backward of such a row is undefined, the _fa_bwd
    docstring)."""
    b, h, t, d = MAIN_SHAPE
    rng = np.random.RandomState(SEED + 1)
    lens = lambda n, hi: [int(x) for x in rng.randint(hi // 4, hi + 1, n)]
    yield "enc self (key bias)", make_case(b, h, t, t, d, dtype, lens(b, t), 31), False
    yield "dec self (causal, bias)", make_case(b, h, t, t, d, dtype, lens(b, t), 32), True
    yield "cross (key bias)", make_case(b, h, t, t, d, dtype, lens(b, t), 33), False
    yield "ragged T=77 D=48", make_case(2, 3, 77, 77, 48, dtype, [77, 50], 34), True
    yield "Tq=100 Tk=300", make_case(2, 3, 100, 300, 64, dtype, [300, 123], 35), False
    yield "Tq=100 Tk=300 causal", make_case(2, 3, 100, 300, 64, dtype, [300, 250], 36), True
    yield "Tq=300 Tk=100", make_case(2, 3, 300, 100, 64, dtype, [100, 61], 37), False
    yield "Tk=65 no bias", make_case(2, 3, 100, 65, 64, dtype, None, 38), False
    yield "D=32", make_case(2, 4, 150, 150, 32, dtype, [150, 77], 39), True
    yield "D=80", make_case(2, 4, 150, 150, 80, dtype, [150, 77], 40), False
    yield "D=128", make_case(2, 4, 200, 200, 128, dtype, [200, 99], 41), True
    yield "D=33 (unaligned rows)", make_case(2, 3, 90, 90, 33, dtype, [90, 45], 42), True
    b, h, t, d = TRAIN_SHAPE
    yield "train (key bias)", make_case(b, h, t, t, d, dtype, lens(b, t), 43), False
    yield "train (causal, bias)", make_case(b, h, t, t, d, dtype, lens(b, t), 44), True


def bwd_bound(q, k, v, kb, causal):
    """(bound_ms, bound_by, cuda_core_ms) of the backward: 5 products of
    2*B*H*Tq*Tk*D (half that causal), fp32 as three TF32 products each at
    495 TFLOP/s (at 67 TFLOP/s on the CUDA cores beside it), bf16 at 989
    TFLOP/s; against Q, K, V, O, dO read and dQ, dK, dV written once,
    plus lse, the key bias and its gradient."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    es = q.element_size()
    nbytes = (3 * q.numel() + 2 * k.numel()) * es \
        + (q.numel() + 2 * k.numel()) * es + b * h * tq * 4 \
        + (2 * kb.numel() * 4 if kb is not None else 0)
    flops = 5 * 2 * b * h * tq * tk * d / (2 if causal else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if q.dtype == torch.float32:
        t_ops = TF32_PRODUCTS[q.dtype] * flops / TF32_FLOPS * 1e3
    else:
        t_ops = flops / BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, flops / CUDA_CORE_FP32_FLOPS * 1e3))


def time_bwd(dtype, causal, shape=MAIN_SHAPE):
    b, h, t, d = shape
    q, k, v, kb = make_case(b, h, t, t, d, dtype, [t] * (b // 2) + [t // 2] * (b // 2), 11)
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, kb, causal, scale)
    do = torch.randn(q.shape, device="cuda").to(dtype)
    mask = kb[:, None, None, :].to(dtype)
    if causal:
        tri = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        mask = mask.masked_fill(~tri, -1e30)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_fwd = lambda: sdpa(qr, kr, vr, attn_mask=mask, scale=scale)
    sdpa_fwd_bwd = lambda: torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), do)
    kernel = lambda: fa.flash_attention_bwd(q, k, v, kb, out, lse, do, causal, scale)
    row = {
        "plain_ms": time_ms(lambda: fa.plain_attention_bwd(
            q, k, v, kb, out, lse, do, causal, scale)),
        "library_ms": time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd),
        "eager_ms": time_ms(kernel, graph=False),
        "ms": time_ms(kernel),
    }
    row["bound_ms"], row["bound_by"], row["bound_other_ms"] = bwd_bound(
        q, k, v, kb, causal)
    return row


def profile_bwd(dtype, shape, calls=10):
    """Device time per backward call by kernel (delta, dK/dV, dQ) under
    torch.profiler, key bias, non-causal. The dQ kernel starts while the
    dK/dV kernel runs (a programmatic dependent launch) and ends after it,
    so the kernels' times overlap and sum to more than the call's."""
    b, h, t, d = shape
    q, k, v, kb = make_case(b, h, t, t, d, dtype, [t] * (b // 2) + [t // 2] * (b // 2), 11)
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, kb, False, scale)
    do = torch.randn(q.shape, device="cuda").to(dtype)

    def run():
        for _ in range(calls):
            fa.flash_attention_bwd(q, k, v, kb, out, lse, do, False, scale)
    run()
    rows, busy = device_rows(run)
    log(f"bwd {list(shape)} {str(dtype)[6:]}: kernel times per call (they "
        f"overlap), {busy / calls:.4f} ms in all: " + ", ".join(
            f"{_kernel_label(key)} {us / 1e3 / calls:.4f} ms"
            for key, us, _ in sorted(rows, key=lambda r: -r[1])))


def _kernel_label(key):
    m = re.search(r"flash_bwd_\w+_kernel", key)
    return m.group(0) if m else key[:40]


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def make_request(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    feed = transformer.make_fake_batch(batch, cfg, seed=seed)
    feed["src_len"] = rng.randint(64, cfg["max_len"] + 1, batch).astype(np.int32)
    feed["trg_len"] = rng.randint(64, cfg["max_len"] + 1, batch).astype(np.int32)
    return {k: feed[k] for k in FEEDS}


def serve(pred, feed, cfg, dtype="float32"):
    """One request: the logits, checked finite and of the right shape,
    after LAUNCHES_PER_REQUEST forward launches all on ``dtype`` inputs;
    and its milliseconds."""
    before, before_dtype = fa.launches, fa.launch_dtypes.get(dtype, 0)
    t0 = time.perf_counter()
    logits = pred.run(feed)[0].as_tensor()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = fa.launches - before
    if fa.launch_dtypes.get(dtype, 0) - before_dtype != launched:
        raise AssertionError(f"forward launches of the request not all on "
                             f"{dtype} inputs: {fa.launch_dtypes}")
    want = [len(feed["src_word"]), cfg["max_len"], cfg["tgt_vocab"]]
    if list(logits.shape) != want or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {list(logits.shape)} (want {want}) "
                             "or not finite")
    if launched != LAUNCHES_PER_REQUEST:
        raise AssertionError(f"{launched} flash_attention_fwd launches in "
                             f"one request, want {LAUNCHES_PER_REQUEST}")
    return logits, ms


def main_path(model_dir, profile):
    """Phase 5. Returns the path's forward launches, its requests, their
    logits and the steady request times, for phase 8."""
    fa.launches = fa.bwd_launches = 0
    fa.launch_dtypes.clear()
    m = transformer.build(**MODEL)
    cfg = m["config"]
    m["startup"].random_seed = SEED
    scope = pt.Scope()
    exe = pt.Executor()  # CUDAPlace(0)
    t0 = time.perf_counter()
    with pt.scope_guard(scope):
        exe.run(m["startup"])
        pt.io.save_inference_model(model_dir, FEEDS, [m["logits"]], exe,
                                   main_program=m["test"])
    n_params = sum(scope.find_var(p.name).numel()
                   for p in m["test"].all_parameters())
    log(f"startup on {exe.device} + save: {time.perf_counter() - t0:.2f} s, "
        f"{n_params} parameter elements")

    pred = create_paddle_predictor(NativeConfig(model_dir))
    steady_ms, requests, request_logits = [], [], []
    for i in range(4):
        feed = make_request(cfg, 8, SEED + i)
        logits, ms = serve(pred, feed, cfg)
        requests.append(feed)
        request_logits.append(logits)
        if i:
            steady_ms.append(ms)
        tokens = int(feed["trg_len"].sum())
        log(f"request {i}: batch 8, {ms:.2f} ms, {tokens} target tokens, "
            f"{tokens / ms * 1e3:.1f} target tokens/s"
            f"{' (first request)' if i == 0 else ''}")
    one = {k: v[:1] for k, v in make_request(cfg, 8, SEED + 10).items()}
    gpu_logits, _ = serve(pred, one, cfg)
    launches = fa.launches
    if launches != 5 * LAUNCHES_PER_REQUEST or fa.bwd_launches:
        raise AssertionError(f"{launches} forward and {fa.bwd_launches} "
                             "backward launches on the serving path")

    t0 = time.perf_counter()
    cpu_pred = create_paddle_predictor(NativeConfig(model_dir, use_gpu=False))
    cpu_logits = cpu_pred.run(one)[0].as_tensor()
    diff = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    scale = cpu_logits.abs().max().item()
    log(f"batch-1 replay on the CPU ({time.perf_counter() - t0:.1f} s): "
        f"max|dlogits| = {diff:.3e}, max|logits| = {scale:.3e}")
    if not diff <= 1e-3 * scale:
        raise AssertionError("GPU and CPU predictors disagree")
    if profile:
        profile_request(pred, make_request(cfg, 8, SEED + 1), model_dir,
                        float(np.median(steady_ms)))
    return {"launches": launches, "cfg": cfg, "requests": requests,
            "logits": request_logits, "steady_ms": steady_ms, "one": one}


def request_flops(blk, batch):
    """Operations of one request of ``batch`` rows through the saved
    block ``blk``: the matrix products (mul) and the attentions, from the
    declared shapes."""
    def shape(name):
        return [batch if d < 0 else d for d in blk.vars[name].shape]

    flops = 0.0
    for op in blk.ops:
        if op.type == "mul":
            # [M, K] x [K, N]: X flattens to M*K elements, Y is [K, N]
            xs, ys = shape(op.input("X")[0]), shape(op.input("Y")[0])
            flops += 2.0 * np.prod(xs) * np.prod(ys[1:])
        elif op.type == "flash_attention":
            b, h, tq, d = shape(op.input("Q")[0])
            tk = shape(op.input("K")[0])[2]
            flops += 4.0 * b * h * tq * tk * d / (2 if op.attrs.get("causal") else 1)
    return flops


def profile_request(pred, feed, model_dir, steady_ms, label="fp32"):
    """Device time of one request by kernel, against the request's
    unprofiled wall time and its operations bound (from the saved
    program, the same function whatever the passes made of it)."""
    rows, busy = device_rows(lambda: pred.run(feed))
    with open(os.path.join(model_dir, "__model__"), "rb") as f:
        blk = ProgramDesc.from_bytes(f.read()).blocks[0]
    n_ops = len(pred._program.global_block().desc.ops)
    flops = request_flops(blk, len(feed["src_word"]))
    log(f"profile of one {label} batch-8 request through the predictor's "
        f"{n_ops} ops: {busy:.3f} ms of device time by "
        f"kernel; median steady request {steady_ms:.3f} ms wall, so the "
        f"card is idle {max(0.0, 1 - busy / steady_ms):.1%} of it")
    log(f"request operations {flops / 1e9:.1f} GFLOP: fp32 bound "
        f"{flops / CUDA_CORE_FP32_FLOPS * 1e3:.3f} ms at the data-sheet "
        f"67 TFLOP/s")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% "
            f"x{count:<4} {key[:90]}")


# ---------------------------------------------------------------------------
# phase 6: the training path
# ---------------------------------------------------------------------------

def train_batch(cfg, batch, seed):
    """A seeded batch with source and target lengths in [64, T]."""
    rng = np.random.RandomState(seed)
    feed = transformer.make_fake_batch(batch, cfg, seed=seed)
    feed["src_len"] = rng.randint(64, cfg["max_len"] + 1, batch).astype(np.int32)
    feed["trg_len"] = rng.randint(64, cfg["max_len"] + 1, batch).astype(np.int32)
    return {k: feed[k] for k in TRAIN_FEEDS}


def copy_state(state, device):
    scope = pt.Scope()
    for name, t in state.items():
        scope.set_var(name, t.to(device, copy=True))
    return scope


def train_steps(exe, program, scope, loss_name, cfg, label,
                steps=TRAIN_STEPS):
    """``steps`` steps at TRAIN_BATCH; checks each step's launches and
    loss. Returns (losses, step ms)."""
    losses, step_ms = [], []
    for i in range(steps):
        feed = train_batch(cfg, TRAIN_BATCH, SEED + 100 + i)
        fwd0, bwd0 = fa.launches, fa.bwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss,) = exe.run(program, feed=feed, fetch_list=[loss_name],
                          scope=scope, return_numpy=False)
        loss = float(loss.reshape(-1)[0].item())
        ms = (time.perf_counter() - t0) * 1e3
        fwd, bwd = fa.launches - fwd0, fa.bwd_launches - bwd0
        tokens = int(feed["trg_len"].sum())
        log(f"{label} step {i}: loss {loss:.6f}, {ms:.1f} ms, {tokens} target "
            f"tokens, {tokens / ms * 1e3:.0f} target tokens/s, launches "
            f"{fwd} forward + {bwd} backward")
        if not np.isfinite(loss):
            raise AssertionError(f"{label} step {i}: loss {loss}")
        if (fwd, bwd) != (FWD_PER_STEP, BWD_PER_STEP):
            raise AssertionError(f"{label} step {i}: {fwd} forward and {bwd} "
                                 f"backward launches, want {FWD_PER_STEP} "
                                 f"and {BWD_PER_STEP}")
        losses.append(loss)
        step_ms.append(ms)
    return losses, step_ms


def adam_first_update(grad, lr):
    """The first Adam step of the model's optimizer (beta1 0.9, beta2 0.98,
    epsilon 1e-9; the power accumulators start at the betas), in float64
    on the host: lr * sqrt(1 - 0.98) / (1 - 0.9) * m1 / (sqrt(m2) + 1e-9)."""
    g = grad.double()
    m1, m2 = 0.1 * g, 0.02 * g * g
    return lr * 0.02 ** 0.5 / 0.1 * m1 / (m2.sqrt() + 1e-9)


def replay_on_cpu(m, program, state, lr, label, amp=False):
    """One batch-2 step of ``program`` from the same weights on the card
    and through Executor(CPUPlace()): loss, the REPLAY_GRADS gradients and
    their updated parameters.

    fp32 (TF32 off on both sides): the loss within 1e-4 relative; each
    gradient within 1e-3 relative in L2 and within 1e-2 of its largest
    magnitude elementwise: the backward recomputes P from the forward
    kernel's lse and takes delta from its O, which its 3 TF32 products
    leave about 1e-6 off fp32, and dSoft = P (dP - delta) cancels where
    attention is near uniform (at initialization), so the gradients
    through Q and K, and the word embeddings below them, lose about three
    digits (the CPU, with the kernel's TF32 forward emulated, loses two:
    1.5e-4 of the largest magnitude). AMP: AMP_REPLAY_TOL.

    Adam's first step is about +-lr wherever |g| >> 1e-8, so where the
    two gradients differ near 0 the two parameters may move apart by up
    to 2 lr. So each side's new parameters are held against the Adam
    formula on its own gradient (within 1e-3 lr plus an fp32 spacing of
    the parameter), and the two sides against each other within 2 lr
    plus that spacing."""
    feed = train_batch(m["config"], 2, SEED + 50)
    fetch = [m["loss"].name] + [n + "@GRAD" for n in REPLAY_GRADS]
    results = {}
    t0 = time.perf_counter()
    for where, exe in (("card", pt.Executor()),
                       ("cpu", pt.Executor(pt.CPUPlace()))):
        scope = copy_state(state, exe.device)
        out = exe.run(program, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        params = [scope.find_var(n).cpu() for n in REPLAY_GRADS]
        results[where] = ([t.cpu().float() for t in out], params)
    (gpu, gpu_p), (cpu, cpu_p) = results["card"], results["cpu"]
    loss_gpu, loss_cpu = gpu[0].item(), cpu[0].item()
    log(f"{label}: batch-2 step replayed on the CPU "
        f"({time.perf_counter() - t0:.1f} s for both): loss {loss_gpu:.7f} "
        f"on the card, {loss_cpu:.7f} on the CPU, lr {lr:.4e}")
    loss_tol = AMP_REPLAY_TOL["loss"] if amp else 1e-4
    if not abs(loss_gpu - loss_cpu) <= loss_tol * abs(loss_cpu):
        raise AssertionError(f"{label}: card and CPU losses disagree")
    if amp:
        all_l2 = (torch.linalg.norm(torch.cat([(g - c).reshape(-1)
                                               for g, c in zip(gpu[1:], cpu[1:])]))
                  / torch.linalg.norm(torch.cat([c.reshape(-1)
                                                 for c in cpu[1:]]))).item()
        log(f"  the gradients together: {all_l2:.3e} relative in L2 "
            f"(bound {AMP_REPLAY_TOL['grads_l2']})")
        if not all_l2 <= AMP_REPLAY_TOL["grads_l2"]:
            raise AssertionError(f"{label}: AMP gradients disagree")
    for name, g, c, pg, pc in zip(REPLAY_GRADS, gpu[1:], cpu[1:], gpu_p,
                                  cpu_p):
        err, top = (g - c).abs().max().item(), c.abs().max().item()
        rel_l2 = (torch.linalg.norm(g - c) / torch.linalg.norm(c)).item()
        p0 = state[name].cpu().double()
        spacing = torch.finfo(torch.float32).eps * p0.abs()
        formula = [((p1.double() - (p0 - adam_first_update(grad, lr))).abs()
                    - spacing).max().item() / lr
                   for p1, grad in ((pg, g), (pc, c))]
        apart = (pg.double() - pc.double()).abs()
        log(f"  {name}: max|dgrad| {err:.3e} of max|grad| {top:.3e} "
            f"(L2 {rel_l2:.3e} relative); new "
            f"parameters past the Adam formula by {formula[0]:.2e} lr (card) "
            f"and {formula[1]:.2e} lr (CPU); card and CPU apart by up to "
            f"{apart.max().item() / lr:.3f} lr, by more than 1e-3 lr in "
            f"{(apart > 1e-3 * lr).double().mean().item():.4%} of elements")
        ok = (rel_l2 <= AMP_REPLAY_TOL["grad_l2"] if amp
              else err <= 1e-2 * top and rel_l2 <= 1e-3)
        if not (torch.isfinite(g).all() and ok):
            raise AssertionError(f"{label}: {name} gradients disagree")
        if not (max(formula) <= 1e-3
                and bool(((apart - spacing) <= 2 * lr).all())):
            raise AssertionError(f"{label}: {name} updates disagree")


def training_path(profile):
    """Transformer-base training on the card: fp32 and AMP steps from the
    same initial weights, then the CPU replays. Returns the path's (fwd,
    bwd) kernel launches, the model, its initial state, the noam rate of
    the first step and the step times."""
    with unique_name.guard():  # names phase 7's build repeats
        m = transformer.build(**MODEL)
    m["startup"].random_seed = SEED
    exe = pt.Executor()
    init = pt.Scope()
    t0 = time.perf_counter()
    exe.run(m["startup"], scope=init)
    state = {n: init.find_var(n) for n in init.var_names()}
    n_params = sum(state[p.name].numel() for p in m["main"].all_parameters())
    log(f"train startup on {exe.device}: {time.perf_counter() - t0:.2f} s, "
        f"{len(state)} persistables, {n_params} parameter elements")
    loss_name = m["loss"].name
    amp_main = mixed_precision.decorate(m["main"].clone())

    fa.launches = fa.bwd_launches = 0
    fa.launch_dtypes.clear()
    torch.cuda.reset_peak_memory_stats()
    fp32_scope = copy_state(state, exe.device)
    fp32_losses, fp32_ms = train_steps(exe, m["main"], fp32_scope, loss_name,
                                       m["config"], "fp32")
    peak = torch.cuda.max_memory_allocated()
    amp_scope = copy_state(state, exe.device)
    amp_losses, amp_ms = train_steps(exe, amp_main, amp_scope, loss_name,
                                     m["config"], "bf16 AMP")
    launches = (fa.launches, fa.bwd_launches)
    if launches != (2 * TRAIN_STEPS * FWD_PER_STEP,
                    2 * TRAIN_STEPS * BWD_PER_STEP):
        raise AssertionError(f"{launches} launches on the training path")
    rel = max(abs(a - f) / abs(f) for a, f in zip(amp_losses, fp32_losses))
    log(f"fp32 median step {np.median(fp32_ms[1:]):.1f} ms, AMP "
        f"{np.median(amp_ms[1:]):.1f} ms (steps 1-{TRAIN_STEPS - 1}); peak "
        f"memory {peak / 2 ** 30:.2f} GiB over the fp32 steps; AMP losses "
        f"within {rel:.3e} relative of fp32")
    if not rel <= 1e-2:
        raise AssertionError("AMP losses disagree with fp32 beyond 1e-2")
    # the noam rate of the first step: d_model^-0.5 * min(1, warmup^-1.5)
    lr = MODEL["d_model"] ** -0.5 * min(1.0, 8000 ** -1.5)
    replay_on_cpu(m, m["main"], state, lr, "fp32")
    replay_on_cpu(m, amp_main, state, lr, "bf16 AMP", amp=True)
    if profile:
        profile_step(exe, m, m["main"], fp32_scope,
                     float(np.median(fp32_ms[1:])), "fp32")
        profile_step(exe, m, amp_main, amp_scope,
                     float(np.median(amp_ms[1:])), "bf16 AMP")
    return {"launches": launches, "m": m, "amp_main": amp_main,
            "state": state, "lr": lr, "fp32_ms": fp32_ms, "amp_ms": amp_ms}


# ---------------------------------------------------------------------------
# phase 7: training through CompiledProgram
# ---------------------------------------------------------------------------

def bench_build_strategy():
    """bench.py:316-326's BuildStrategy (the bench's fusion arm)."""
    bs = pt.BuildStrategy()
    bs.fuse_all_optimizer_ops = True
    bs.fuse_elewise_add_act_ops = True
    bs.memory_optimize = True
    bs.fuse_conv_ops = True
    bs.fuse_attention_ops = True
    return bs


def _close(got, want, tol):
    rtol, atol = tol
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def unique_id_batch(cfg, batch, seed):
    """A train batch whose source and target ids do not repeat, so the
    embedding gradients' index_add_ has no two atomics on one element and
    the step is deterministic on the card."""
    feed = train_batch(cfg, batch, seed)
    rng = np.random.RandomState(seed)
    n = batch * cfg["max_len"]
    for key, vocab in (("src_word", cfg["src_vocab"]),
                       ("trg_word", cfg["tgt_vocab"])):
        feed[key] = (rng.permutation(vocab - 1)[:n] + 1).reshape(
            batch, cfg["max_len"], 1).astype(np.int64)
    return feed


def fused_adam_bitwise(exe, m, state):
    """One step of ``m["main"]`` with and without fuse_all_optimizer_ops
    alone, from the same weights on a deterministic batch: the gradients
    bitwise equal (the batch is deterministic), then every persistable
    (parameters, moments, beta powers) bitwise equal."""
    bs = pt.BuildStrategy()
    bs.fuse_all_optimizer_ops = True
    feed = unique_id_batch(m["config"], TRAIN_BATCH, SEED + 300)
    block = m["main"].global_block()
    params = [p.name for p in m["main"].all_parameters()
              if block.has_var(p.name + "@GRAD")]
    fetch = [m["loss"].name] + [n + "@GRAD" for n in params]
    sides = []
    for target in (m["main"], pt.CompiledProgram(m["main"],
                                                 build_strategy=bs)):
        types = [o.type for o in exe.lowered_ops(target, fetch)]
        scope = copy_state(state, exe.device)
        out = exe.run(target, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        sides.append((types, out, {n: scope.find_var(n)
                                   for n in scope.var_names()}))
    (types0, out0, vars0), (types1, out1, vars1) = sides
    log(f"fused Adam: {types0.count('adam')} adam ops against "
        f"{types1.count('fused_adam')} fused_adam ops "
        f"({types1.count('adam')} adam left) over {len(params)} parameters")
    if types1.count("fused_adam") < 1 or types1.count("adam"):
        raise AssertionError("fuse_all_optimizer_ops did not fuse the adam ops")
    if not all(torch.equal(a, b) for a, b in zip(out0, out1)):
        raise AssertionError("the unique-id step is not deterministic")
    differ = [n for n in sorted(vars0) if not torch.equal(vars0[n], vars1[n])]
    moved = sum(not torch.equal(vars0[n], state[n].to(vars0[n].device))
                for n in vars0)
    log(f"  {len(vars0)} persistables after the step, {moved} moved, "
        f"{len(differ)} differ bitwise")
    if differ or sorted(vars0) != sorted(vars1):
        raise AssertionError(f"fused_adam differs from adam in {differ[:5]}")


def steps_in_turns(exe, state, cfg, arms, rounds=4):
    """Step times of ``arms`` [(label, program, loss name)] taken in
    turns, each arm from its own copy of ``state``: round r runs the arms
    in order when r is even and in reverse when it is odd, so drift on
    the host (the steps of one phase can run 1.5x slower than those of an
    earlier one) reaches every arm alike. Prints each arm's median over
    rounds 1 onward."""
    scopes = [copy_state(state, exe.device) for _ in arms]
    ms = [[] for _ in arms]
    for r in range(rounds):
        feed = train_batch(cfg, TRAIN_BATCH, SEED + 400 + r)
        order = range(len(arms)) if r % 2 == 0 else reversed(range(len(arms)))
        for i in order:
            _, program, loss_name = arms[i]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (loss,) = exe.run(program, feed=feed, fetch_list=[loss_name],
                              scope=scopes[i], return_numpy=False)
            if not bool(torch.isfinite(loss).all()):
                raise AssertionError(f"{arms[i][0]}: loss {loss}")
            ms[i].append((time.perf_counter() - t0) * 1e3)
    log(f"steps in turns ({rounds} rounds, medians of rounds 1-"
        f"{rounds - 1}): " + ", ".join(
            f"{label} {np.median(t[1:]):.1f} ms"
            for (label, _, _), t in zip(arms, ms)))


def compiled_training_path(trained, profile):
    """Phase 7. Returns the path's (fwd, bwd) launches and its times."""
    fused_m, state, lr = trained["m"], trained["state"], trained["lr"]
    with unique_name.guard():  # the names of phase 6's build
        m = transformer.build(attention_impl="unfused", **MODEL)
    cfg, loss_name = m["config"], m["loss"].name
    names = sorted(v.name for v in m["main"].list_vars() if v.persistable)
    if names != sorted(state):
        raise AssertionError("the unfused build's persistables are not the "
                             "fused build's")
    exe = pt.Executor()
    target = pt.CompiledProgram(m["main"],
                                build_strategy=bench_build_strategy())
    n_raw = len(m["main"].global_block().desc.ops)
    t0 = time.perf_counter()
    ops = exe.lowered_ops(target, [loss_name])
    pipeline_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    exe.lowered_ops(target, [loss_name])
    memo_ms = (time.perf_counter() - t0) * 1e3
    types = [o.type for o in ops]
    counts = {t: types.count(t) for t in (
        "flash_attention", "flash_attention_grad", "softmax", "fused_adam",
        "adam", "fused_elemwise_activation", "pt_const", "matmul")}
    log(f"unfused program {n_raw} ops; rewritten live list {len(ops)} ops "
        f"in {pipeline_ms:.1f} ms (first run, live-op slice included; a "
        f"memo hit takes {memo_ms:.3f} ms): {counts}")
    for name, row in exe.pipeline_stats["stages"].items():
        log(f"  stage {name}: {row['ops_removed']} ops removed, "
            f"{row['seconds'] * 1e3:.1f} ms")
    want = {"flash_attention": LAUNCHES_PER_REQUEST,
            "flash_attention_grad": LAUNCHES_PER_REQUEST, "softmax": 0}
    if any(counts[k] != v for k, v in want.items()) \
            or counts["fused_adam"] < 1:
        raise AssertionError(f"the pipeline left {counts}, want {want} and "
                             "a fused_adam")

    amp_main = mixed_precision.decorate(m["main"].clone())
    amp_target = pt.CompiledProgram(amp_main,
                                    build_strategy=bench_build_strategy())
    fa.launches = fa.bwd_launches = 0
    fa.launch_dtypes.clear()
    scope = copy_state(state, exe.device)
    losses, step_ms = train_steps(exe, target, scope, loss_name, cfg,
                                  "compiled fp32", COMPILED_STEPS)
    amp_scope = copy_state(state, exe.device)
    amp_losses, amp_ms = train_steps(exe, amp_target, amp_scope, loss_name,
                                     cfg, "compiled bf16 AMP", COMPILED_STEPS)
    launches = (fa.launches, fa.bwd_launches)
    stats = exe.pipeline_stats
    log(f"pipeline runs {stats['runs']} (fp32 and AMP programs), memo hits "
        f"{stats['memo_hits']}, {stats['seconds'] * 1e3:.1f} ms in all")
    if launches != (2 * COMPILED_STEPS * FWD_PER_STEP,
                    2 * COMPILED_STEPS * BWD_PER_STEP):
        raise AssertionError(f"{launches} launches on the compiled path")
    if stats["runs"] != 2:
        raise AssertionError("the pipeline ran again on a memoized program")

    # the reference: phase 6's fused build on a plain Executor()
    ref_scope = copy_state(state, exe.device)
    ref_losses, ref_ms = train_steps(exe, fused_m["main"], ref_scope,
                                     fused_m["loss"].name, cfg,
                                     "fused build, plain Executor",
                                     COMPILED_STEPS)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    params = [p.name for p in fused_m["main"].all_parameters()]
    worst = max(((scope.find_var(n) - ref_scope.find_var(n)).abs()
                 / (FUSION_PARAM_TOL[1] + FUSION_PARAM_TOL[0]
                    * ref_scope.find_var(n).abs())).max().item()
                for n in params)
    log(f"compiled fp32 against the fused build: losses within "
        f"{loss_err:.3e} relative; parameters at {worst:.3f} of the "
        f"tolerance (rtol {FUSION_PARAM_TOL[0]}, atol {FUSION_PARAM_TOL[1]})")
    if not all(abs(a - b) <= FUSION_LOSS_TOL[1] + FUSION_LOSS_TOL[0] * abs(b)
               for a, b in zip(losses, ref_losses)):
        raise AssertionError("compiled losses disagree with the fused build")
    if not all(_close(scope.find_var(n), ref_scope.find_var(n),
                      FUSION_PARAM_TOL) for n in params):
        raise AssertionError("compiled parameters disagree with the fused "
                             "build")
    rel = max(abs(a - f) / abs(f) for a, f in zip(amp_losses, losses))
    log(f"compiled AMP losses within {rel:.3e} relative of compiled fp32")
    replay_on_cpu(m, amp_target, state, lr, "compiled bf16 AMP", amp=True)
    fused_adam_bitwise(exe, fused_m, state)
    steps_in_turns(exe, state, cfg, [
        ("fused build fp32", fused_m["main"], fused_m["loss"].name),
        ("compiled fp32", target, loss_name),
        ("fused build AMP", trained["amp_main"], fused_m["loss"].name),
        ("compiled AMP", amp_target, loss_name)])
    log(f"median steps on this host: phase 6 fp32 "
        f"{np.median(trained['fp32_ms'][1:]):.1f} ms, AMP "
        f"{np.median(trained['amp_ms'][1:]):.1f} ms (steps 1-"
        f"{TRAIN_STEPS - 1}); compiled fp32 {np.median(step_ms[1:]):.1f} "
        f"ms, AMP {np.median(amp_ms[1:]):.1f} ms, fused build on plain "
        f"Executor {np.median(ref_ms[1:]):.1f} ms (steps 1-"
        f"{COMPILED_STEPS - 1})")
    if profile:
        profile_step(exe, m, target, scope, float(np.median(step_ms[1:])),
                     "compiled fp32")
    return launches


# ---------------------------------------------------------------------------
# phase 8: serving through AnalysisPredictor
# ---------------------------------------------------------------------------

def analysis_serving_path(model_dir, served, profile):
    """Phase 8. Returns the path's forward launches."""
    cfg = served["cfg"]
    t0 = time.perf_counter()
    pred = create_paddle_predictor(AnalysisConfig(model_dir).enable_bf16())
    types = [o.type for o in pred._program.global_block().desc.ops]
    log(f"AnalysisPredictor (bf16) in {time.perf_counter() - t0:.2f} s: "
        f"{len(types)} ops after the passes, {types.count('fc')} fc, "
        f"{types.count('mul')} mul, {types.count('flash_attention')} "
        f"flash_attention")
    fa.launches = fa.bwd_launches = 0
    fa.launch_dtypes.clear()
    steady_ms = []
    for i, (feed, ref) in enumerate(zip(served["requests"],
                                        served["logits"])):
        logits, ms = serve(pred, feed, cfg, dtype="bfloat16")
        if logits.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 serving returned {logits.dtype}")
        err = (logits.float() - ref).abs().max().item()
        top = ref.abs().max().item()
        agree = (logits.float().argmax(-1) == ref.argmax(-1)).double().mean()
        log(f"bf16 request {i}: {ms:.2f} ms; against the fp32 "
            f"NativePredictor max|dlogits| {err:.3e} of max|logits| "
            f"{top:.3e} ({err / top:.3e}, bound {BF16_SERVE_REL:.3e}), "
            f"arg-max agreement {agree.item():.4f}")
        if not err <= BF16_SERVE_REL * top:
            raise AssertionError("bf16 logits disagree with fp32")
        if i:
            steady_ms.append(ms)
    launches = fa.launches
    if (launches != 4 * LAUNCHES_PER_REQUEST or fa.bwd_launches
            or fa.launch_dtypes != {"bfloat16": launches}):
        raise AssertionError(f"{launches} forward ({fa.launch_dtypes}) and "
                             f"{fa.bwd_launches} backward launches on the "
                             "analysis serving path")
    pred32 = create_paddle_predictor(
        AnalysisConfig(model_dir).enable_bf16(False))
    for i, (feed, ref) in enumerate(zip(served["requests"],
                                        served["logits"])):
        logits, _ = serve(pred32, feed, cfg)
        err = (logits - ref).abs().max().item()
        if not err <= 1e-3 * ref.abs().max().item():
            raise AssertionError(f"fp32 AnalysisPredictor request {i} "
                                 f"disagrees with NativePredictor ({err:.3e})")
    log(f"fp32 AnalysisPredictor: 4 requests within 1e-3 of max|logits| of "
        "the NativePredictor's")
    one = served["one"]
    gpu_logits, _ = serve(pred, one, cfg, dtype="bfloat16")
    t0 = time.perf_counter()
    cpu_pred = create_paddle_predictor(
        AnalysisConfig(model_dir, use_gpu=False).enable_bf16())
    cpu_logits = cpu_pred.run(one)[0].as_tensor().float()
    diff = (gpu_logits.float().cpu() - cpu_logits).abs().max().item()
    top = cpu_logits.abs().max().item()
    log(f"batch-1 bf16 replay on the CPU ({time.perf_counter() - t0:.1f} s): "
        f"max|dlogits| = {diff:.3e}, max|logits| = {top:.3e}")
    if not diff <= BF16_SERVE_REL * top:
        raise AssertionError("bf16 card and CPU predictors disagree")
    log(f"median steady request (1-3): NativePredictor fp32 "
        f"{np.median(served['steady_ms']):.2f} ms, AnalysisPredictor bf16 "
        f"{np.median(steady_ms):.2f} ms")
    if profile:
        profile_request(pred, served["requests"][1], model_dir,
                        float(np.median(steady_ms)), "bf16 AnalysisPredictor")
    return launches


def device_rows(fn):
    """(rows [(kernel, device us, count)], busy ms) of one call of fn under
    torch.profiler: device-side rows only (the aten op that launched a
    kernel carries the same time again as its own device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e3
    if not busy:
        raise RuntimeError("the profiler recorded no device time")
    return rows, busy


def profile_step(exe, m, program, scope, steady_ms, label):
    """Device time of one train step of ``program`` by kernel against its
    unprofiled wall time, and the flash kernels' share of it; for fp32
    the forward alone (the test clone's loss) beside it, which is what
    the generic vjp grad ops run again, and the step's operations (3x the
    forward's products) against the fp32 bound."""
    feed = train_batch(m["config"], TRAIN_BATCH, SEED + 200)
    rows, busy = device_rows(lambda: exe.run(
        program, feed=feed, fetch_list=[m["loss"].name], scope=scope,
        return_numpy=False))
    log(f"profile of one {label} train step (batch {TRAIN_BATCH}): "
        f"{busy:.3f} ms of device time by kernel; median steady step "
        f"{steady_ms:.3f} ms wall, so the card is idle "
        f"{max(0.0, 1 - busy / steady_ms):.1%} of it")
    for kind, tag in (("forward", "flash_fwd_kernel"),
                      ("backward", "flash_bwd_")):
        mine = [r for r in rows if tag in r[0]]
        ms = sum(r[1] for r in mine) / 1e3
        log(f"  flash {kind} kernels: {ms:.3f} ms ({ms / busy:.1%}) over "
            f"{sum(r[2] for r in mine)} launches"
            + (" (dQ overlaps dK/dV: summed kernel times)"
               if kind == "backward" else ""))
    if program is m["main"]:
        _, fwd_busy = device_rows(lambda: exe.run(
            m["test"], feed=feed, fetch_list=[m["loss"].name], scope=scope,
            return_numpy=False))
        fwd_flops = request_flops(m["main"].desc.blocks[0], TRAIN_BATCH)
        log(f"  the forward alone: {fwd_busy:.3f} ms of device time; step "
            f"operations {3 * fwd_flops / 1e9:.1f} GFLOP (3 x the forward's "
            f"{fwd_flops / 1e9:.1f}): fp32 bound "
            f"{3 * fwd_flops / CUDA_CORE_FP32_FLOPS * 1e3:.3f} ms at the "
            f"data-sheet 67 TFLOP/s")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:16]:
        log(f"  {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% "
            f"x{count:<5} {key[:90]}")


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--profile", action="store_true")
    args.add_argument("--kernels", action="store_true",
                      help="phases 1-4 only, then the closing lines")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("device")
    smi = nvidia_smi_line()
    log(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    phase("build")
    t0 = time.perf_counter()
    info = _build.build()
    log(f"built {sorted(info)} in {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"({n}: {i['seconds']:.1f} s)" for n, i in sorted(info.items())))
    for name in _build.SOURCES:
        report = kernel_report(name)
        for kname, row in sorted(report.items()):
            log(f"  {name}: {kname}: {row['registers']} registers, "
                f"{row['stack_bytes']} bytes of stack frame, {row['hmma']} "
                f"HMMA of {sum(row['opcodes'].values())} SASS instructions")
            if f", {MAIN_SHAPE[3]}>" in kname or "delta" in kname:
                top = sorted(row["opcodes"].items(), key=lambda x: -x[1])[:10]
                log("    most frequent: " + ", ".join(f"{o} {n}" for o, n in top))
        if any(r["registers"] is None for r in report.values()):
            raise AssertionError(f"{name}: cuobjdump -res-usage gave no "
                                 "registers for a kernel")
        # every kernel but the backward's delta (one reduction per row)
        # runs its products on the tensor cores
        products = {k: r for k, r in report.items() if "delta" not in k}
        if not products or any(r["hmma"] == 0 for r in products.values()):
            raise AssertionError(f"{name}: a kernel runs no tensor-core "
                                 "instruction (HMMA count 0 in its SASS)")
        if any(r["stack_bytes"] for k, r in products.items()
               if f", {MAIN_SHAPE[3]}>" in k):
            raise AssertionError(f"{name}: a stack frame (spills) at "
                                 f"D = {MAIN_SHAPE[3]}")

    phase("kernels against their plain versions")
    errs, bwd_errs, bwd_train_errs = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (q, k, v, kb), causal) in enumerate(kernel_cases(dtype)):
            err = check_case(name, q, k, v, kb, causal)
            if i < 3:
                errs[dtype] = max(errs.get(dtype, 0.0), err)
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (q, k, v, kb), causal) in enumerate(bwd_cases(dtype)):
            err = check_bwd_case(f"bwd {name}", q, k, v, kb, causal)
            if i < 3:
                bwd_errs[dtype] = max(bwd_errs.get(dtype, 0.0), err)
            if name.startswith("train"):
                bwd_train_errs[dtype] = max(bwd_train_errs.get(dtype, 0.0),
                                            err)

    phase(f"kernel timing at {list(MAIN_SHAPE)} (the backward also at "
          f"{list(TRAIN_SHAPE)})")
    timing, bwd_timing, bwd_train = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            row = timing[dtype, causal] = time_kernel(dtype, causal)
            other = ("fp32 CUDA cores 67" if dtype == torch.float32
                     else "bf16 tensor cores 989")
            log(f"fwd {str(dtype)[6:]:<8} causal={int(causal)} kernel "
                f"{row['ms']:.4f} ms (eager calls {row['eager_ms']:.4f} ms), "
                f"plain {row['plain_ms']:.4f} ms, "
                f"sdpa {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}, TF32 495 "
                f"TFLOP/s), {row['bound_other_ms']:.4f} ms at the {other} "
                f"TFLOP/s")
    for shape, rows in ((MAIN_SHAPE, bwd_timing), (TRAIN_SHAPE, bwd_train)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                row = rows[dtype, causal] = time_bwd(dtype, causal, shape)
                rate = ("3xTF32 495" if dtype == torch.float32
                        else "bf16 989")
                log(f"bwd {list(shape)} {str(dtype)[6:]:<8} "
                    f"causal={int(causal)} kernels {row['ms']:.4f} ms (eager "
                    f"calls {row['eager_ms']:.4f} ms), plain "
                    f"{row['plain_ms']:.4f} ms, sdpa backward "
                    f"{row['library_ms']:.4f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {rate} "
                    f"TFLOP/s), {row['bound_other_ms']:.4f} ms at the fp32 "
                    f"CUDA cores 67 TFLOP/s")

    if args.profile:
        for shape in (MAIN_SHAPE, TRAIN_SHAPE):
            for dtype in (torch.float32, torch.bfloat16):
                profile_bwd(dtype, shape)

    paths = {}  # path -> (forward, backward) launches
    if not args.kernels:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_model_",
                                         dir=_build.BUILD_DIR) as model_dir:
            phase("serving: Transformer-base through NativePredictor")
            served = main_path(model_dir, args.profile)
            paths["serving"] = (served["launches"], 0)
            phase("training: Transformer-base train steps on Executor()")
            trained = training_path(args.profile)
            paths["training"] = trained["launches"]
            phase("training through CompiledProgram (bench BuildStrategy, "
                  "unfused attention)")
            paths["compiled_training"] = compiled_training_path(
                trained, args.profile)
            phase("serving through AnalysisPredictor (IR passes, bf16)")
            paths["analysis_serving_bf16"] = (
                analysis_serving_path(model_dir, served, args.profile), 0)

    def entry(name, source, replaces, rows, errors, which, per):
        fp32 = dict(rows[torch.float32, False])
        bf16 = dict(rows[torch.bfloat16, False])
        cuda_cores = fp32.pop("bound_other_ms")
        bf16["bound_ms_other"] = bf16.pop("bound_other_ms")
        bf16["causal_ms"] = rows[torch.bfloat16, True]["ms"]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": paths["training"][which] if paths else None,
            "launches_by_path": {k: v[which] for k, v in paths.items()}
            if paths else None,
            "max_abs_err": errors[torch.float32],
            "ms": fp32["ms"], "plain_ms": fp32["plain_ms"],
            "bound_ms": fp32["bound_ms"], "bound_by": fp32["bound_by"],
            "library_ms": fp32["library_ms"],
            "bound_ms_cuda_cores": cuda_cores, "eager_ms": fp32["eager_ms"],
            "causal_ms": rows[torch.float32, True]["ms"],
            "dtype": "float32", "shape": list(MAIN_SHAPE), **per,
            "bf16": dict(bf16, max_abs_err=errors[torch.bfloat16]),
        }

    kernels = [
        entry("flash_attention_fwd",
              "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
              "paddle_tpu/ops/pallas_attention.py:43", timing, errs, 0,
              {"launches_per_request": LAUNCHES_PER_REQUEST,
               "launches_per_step": FWD_PER_STEP}),
        entry("flash_attention_bwd",
              "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
              "paddle_tpu/ops/pallas_attention.py:213", bwd_timing, bwd_errs,
              1,
              {"launches_per_request": 0,
               "launches_per_step": BWD_PER_STEP,
               "train_shape": dict(
                   shape=list(TRAIN_SHAPE),
                   max_abs_err={str(dt)[6:]: e
                                for dt, e in bwd_train_errs.items()},
                   **{f"{str(dt)[6:]}{'_causal' if c else ''}": row
                      for (dt, c), row in bwd_train.items()})}),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
