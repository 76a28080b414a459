#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # the contract run
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of one
                                     # backward call, one request and one
                                     # fp32 and one AMP train step by
                                     # device kernel
    python3 chip_smoke.py --kernels  # phases 1-4 only, the short loop for
                                     # work on a kernel: prints the kernels
                                     # line (launches null) and no contract
                                     # line

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
   the grid that the training path launches; both at BERT's [16, 12,
   128, 64] (key lengths in [T/4, T], one row at length 1).
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
   TB/s. Both also at BERT's [16, 12, 128, 64], key bias, non-causal.
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
   printed. 4 fp32 and 4 AMP steps from phase 6's weights, 36 forward
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

9. ResNet-50 training through ``CompiledProgram``: ``resnet.build`` at
   bench.py's widths (flowers, depth 50, 1000 classes, 224x224, lr 0.1,
   momentum), batch 128 of seeded images with int32 labels, under
   bench.py's BuildStrategy. The rewritten op list must hold no
   ``momentum`` and a ``fused_momentum``, and the conv stages find
   nothing (training batch norms, convs without bias); their counts are
   printed. 4 fp32 and 5 AMP steps from the same weights, losses finite,
   step medians, images per second, peak memory and the step's 3 x 7.767
   GFLOP per image against 989 TFLOP/s; ``fused_momentum`` bitwise
   against one ``momentum`` per parameter on one backward's gradients;
   step 1 at batch 2 replayed op by op: the rewritten list run on the
   CPU, and each op run again on the card on the CPU's input values, fp32
   and AMP, every output within tests/test_torch_resnet.py's per-op
   bounds of the CPU's (momentum's and batch_norm's state updates held
   by their change); the same step through ``Executor(CPUPlace())`` end
   to end, fp32 at that file's end-to-end bounds (AMP's end-to-end
   distance, chaotic through 53 batch_norms, printed only); the
   ``layout="NHWC"`` build (2 transposes) against NCHW, its fp32 step-1
   loss within 1e-4 and both AMP steps timed in turns. No flash kernel
   launches.
10. ResNet-50 serving: the test program at 102 classes (the
   resnet50_infer row), its batch_norm statistics calibrated on one
   seeded batch, saved and served at batch 128 by ``NativePredictor``,
   ``AnalysisPredictor`` fp32 (within 1e-3 of the native one) and
   ``AnalysisPredictor`` bf16: no ``batch_norm`` left after the passes;
   the folded weights within 1e-6 of a CPU ``AnalysisPredictor``'s; a
   batch-1 request, bf16 and fp32, replayed op by op on the CPU
   predictor's program, scope and values at the per-op bounds (bf16's
   distance from fp32 over the 4 requests and their arg-max agreement
   printed). No flash kernel launches.

11. whole-step capture. Phases 5-10 run through the executor's plans, so
   on the card each path's second run captures a CUDA graph and later
   runs replay it; this phase holds the capture against the eager oracle
   (``FLAGS.jit_cache = False``) on Transformer-base through
   ``CompiledProgram`` (bench BuildStrategy, batch 16, T 256, fp32 and
   AMP), ResNet-50 AMP through ``CompiledProgram`` (batch 128), and
   ``AnalysisPredictor`` bf16 serving of Transformer-base (batch 8) and
   ResNet-50 (batch 128), under ``torch.use_deterministic_algorithms``
   (warnings name any op without a deterministic implementation) with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``. On each path: 5 captured runs
   against 5 eager runs from the same state, losses or outputs and every
   persistable, bitwise wherever two eager arms agree bitwise (the two
   distances printed); step 1's ``FetchHandle`` read after the last step;
   a ``load_persistables`` (in place: the graph stays) and a ``set_var``
   of every persistable (a rebinding: the graph is dropped and captured
   anew) between runs, the next steps bitwise against eager ones (serving:
   a ``set_var`` of a weight and its restore); ``run(iterations=4)``
   (eager, then captured) against single runs, bitwise (training); one
   replay traced by torch.profiler, its flash kernels counted by name
   against 36 forward + 54 backward per train step and 18 per request,
   and every flash launch of the phase's runs counted the same way; no
   K-step run falling back to single steps. Then both arms in turns
   (outside the deterministic mode): medians, tokens or images per
   second, the card's idle share of a captured step (device time from
   the trace), seconds of the warm-up and of the capture with its first
   replay, and peak memory both ways; ``--profile`` adds an eager
   step's idle share. A main program with a ``uniform_random`` op: 5
   captured runs against 5 eager ones and ``run(iterations=2)`` against
   single runs, bitwise.

12. BERT-base pretraining: ``bert.build`` at bench_bert's widths (vocab
   30522, T 128, 20 masked slots, 12 layers, 12 heads, d_model 768,
   d_inner 3072), batch 16 with row lengths in [64, 128], through
   ``CompiledProgram`` under bench.py's BuildStrategy. Arm A, bench_bert's
   Adam (lr 1e-4, epsilon 1e-6), fp32 and AMP: 5 steps each on one
   batch, the masked-LM loss falling at every step (fp32). Arm B, the
   LAMB recipe with API both packages have: ``bert.build(is_train=False)``
   then ``LambOptimizer(weight_decay=0.01)`` with
   ``set_gradient_clip(GradientClipByGlobalNorm(1.0))`` and a rate from
   ``linear_lr_warmup(polynomial_decay(...))``, AMP, 5 steps, the rate
   fetched each step against its closed form. Per step: ms, tokens/s,
   the loss and its two parts; per arm: warm-up and capture seconds and
   peak memory; 24 forward + 36 backward flash launches a step counted
   by kernel name in a trace. Arm A AMP and arm B captured against eager
   over 3 runs under ``torch.use_deterministic_algorithms``: bitwise
   (losses and every persistable, two eager arms too), no op warning of
   a missing deterministic implementation. A batch-2 step of each arm
   replayed on the CPU: fp32 end to end (BERT_FP32_REPLAY_TOL), AMP op by
   op (BERT_AMP_OP_REL). Then the three arms captured in turns, untraced,
   with one traced replay's device time (idle share).

13. the serving front (ROADMAP A6), after phase 12: (a) phase 5's
   directory at the bench widths through
   ``AnalysisConfig(dir).enable_bf16()`` with
   ``enable_shape_bucketing(batch_buckets=(4, 8, 16, 32))`` and
   ``enable_request_coalescing(max_batch_size=32, batch_timeout_us=1000)``
   (bench_infer_serving's defaults): ``warmup()`` on 4 threads (each
   bucket's warm-up and capture), then 64 coalesced requests from 8
   client threads, both traced (18 bf16 flash forward launches per device
   call); then 3 windows of 256 requests of sizes 1, 3, 5, 8 from 8
   threads, each followed by the same requests through a plain bf16
   ``AnalysisPredictor`` called by 8 threads (the naive path): requests/s
   and p50/p99 latency both ways, device calls and rows per call. Gates:
   every bucket warm, none degraded, no plan and no capture after the
   warm-up; every coalesced request's logits finite, of their shape, and
   within FRONT_REL of the plain predictor's run of it alone; a
   sequential ``BucketedPredictor.run`` at each request size bitwise the
   plain predictor's run of the zero-padded bucket feed (deterministic
   mode); 8 threads on one ``clone()`` of the plain predictor each
   bitwise the serial run (ROADMAP C3). (b) phase 10's ResNet-50
   directory, bf16, through ``BucketedPredictor`` with buckets (32, 64,
   128): batch-128 requests bitwise the plain predictor's, then the
   pinned, double-buffered feed against the plain predictor's pageable
   one in turns (measured, not gated). (c) ROADMAP C1's probe (matmul,
   square, elementwise_sub) served by ``AnalysisPredictor`` on the card
   against a CPU one.

14. generation (ROADMAP A7.1-A7.2), after phase 13: ``build_lm`` at the
   bench_transformer widths (6 layers, d_model 512, 8 heads, d_inner
   2048, vocab 32000, 256 positions; random weights from seed 2024)
   through three ``DecodeEngine``s on the card (dense, paged, paged with
   radix prefix reuse; prompt buckets 32, 64, 128, new-token buckets 32,
   64, 128, slot buckets 1-16, top-k window 64), on 32 prompts of 24-120
   tokens (every other opening with one 64-token system prompt), 64 new
   tokens each, each decode chunk one captured CUDA graph. Gates: (a)
   each engine's greedy ``generate`` tokens equal ``naive_generate``'s
   (the re-prefill reference) up to a step where the reference's top-2
   logit gap is under GEN_TIE; (b) dense and paged (no prefix reuse)
   bitwise, tokens and carry logits, under the deterministic mode; (c)
   after the warm-up no prefill plan, capture, decode plan or capture,
   ingest key or carry is made by the traffic; (d) a 64-step chunk at 16
   slots copies exactly its tokens and done flags to the host (counted
   in a profiler trace, bytes too); (e) a sampled request's tokens (T
   0.8, top-k 40) the same alone in slot 0, in slot 5 among 15
   neighbours and re-admitted to slot 5 mid-decode; (f) one request on a
   CPU ``DecodeEngine`` from the card's weights: greedy tokens under the
   same near-tie rule, first decode logits within GEN_CPU_REL; (g) no
   flash launch. Measured: tokens/s of ``generate`` against
   ``naive_generate``, decode ms per step at 1, 8 and 16 slots captured
   against ``FLAGS.jit_cache = False`` in turns, one traced replay's
   device time, kernels per step and idle share against the step's byte
   bound, capture seconds, KV bytes resident dense against paged, prefix
   hits and prefill tokens saved, peak memory.

15. generation behind the serving front (ROADMAP A7.3) and beam search,
   after phase 14. (A) phase 14's LM behind ``GenerationPredictor``
   (8 slots, 8-step chunks, 64 new tokens; bench_infer_generate's
   predictor): the paged engine with prefix reuse and a dense engine as
   the B side, 48 prompts of phase 14's lengths (every other opening
   with its system prompt) from 8 client threads, against
   ``naive_generate`` from 8 threads. Gates: (a) each request's greedy
   tokens equal the re-prefill reference's under GEN_TIE, in every
   pass alike (two of the 48, two traced of 16); (b) on the dense predictor each request's tokens
   bitwise its tokens alone in slot 0 of the same table (the carry and
   chunk graph the predictor used); (c) no plan, capture, decode plan,
   ingest key or carry made after ``warmup()``; (d) slots re-admitted;
   (e) a sampled request's tokens the same through the predictor and
   alone in slot 0; (f) ``health()`` healthy with no active slot; (g) no
   flash launch. Measured: tokens/s of both predictors and of naive,
   per-token and request p50/p99, mean slot occupancy, joins, prefix
   hits, warm-up seconds, a traced pass's device time and idle share,
   peak memory. (B) ``machine_translation.build`` at the Fluid
   benchmark's widths (30000-word dictionaries, 512 wide, max_len 50,
   beam 4, 50 decode steps; weights from the startup program run on the
   CPU from a seed, set on the card with ``io.set_params_from_numpy``),
   its decode program at batch 16 (64 hypotheses) through
   ``Executor.run``: the bounded While inside one captured device
   segment; 5 captured runs against 2 eager ones bitwise (deterministic
   mode); the card's sentences against a CPU run's, equal but where a
   batch row's hypotheses part at a near-tie (its selected scores at the
   first differing step within MT_TIE of the CPU's, from both runs cut
   to that step), final scores within MT_SCORE_REL; a cut decode agrees
   with the whole; one captured call copies only its fetches to the
   host; no flash launch. Measured: ms per call captured and eager in
   turns, sentences/s, kernels of a traced call (the graph's nodes),
   idle share, capture seconds, peak memory. Then a While with an
   inferred bound runs inside a captured segment and one with a fed
   limit between captured segments, both x * w^3.

Flash launches (phases 5-8, 11, 12 and 13) are counted by kernel name in a
torch.profiler trace of each path's runs, with the wrappers' counts zeroed
just before: a replay of a captured graph launches the kernels without
calling the wrappers, whose counts then cover the eager runs and the
captures, and must not be 0 where the path runs a kernel. The step and
request times of phases 5-8 are taken under that trace; the turns of
phases 7, 9 and 11 are not. ResNet-50 (phases 9-10) and generation
(phases 14-15) hold the wrappers' counts at 0: no call, so no flash
kernel in any graph either.

TF32 stays off for matrix products and convolutions throughout (both
default settings are the caller's; cuDNN's benchmark and deterministic
modes are left at their defaults). The line before the last lists every
ported kernel with its launches on each path (null under ``--kernels``);
the last line is the device record (not printed under ``--kernels``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.desc import ProgramDesc
from paddle_tpu_torch.contrib import mixed_precision
from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                        create_paddle_predictor)
from paddle_tpu_torch.inference.generation import (DecodeEngine,
                                                   GenerationPredictor,
                                                   SamplingParams,
                                                   collect_tokens,
                                                   naive_generate)
from paddle_tpu_torch.models import (bert, machine_translation, resnet,
                                     transformer)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.utils import unique_name
from paddle_tpu_torch.utils.flags import FLAGS

SEED = 2024
FEEDS = ["src_word", "src_pos", "trg_word", "trg_pos", "src_len", "trg_len"]
TRAIN_FEEDS = FEEDS + ["lbl_word"]
# bench_transformer widths: 6 + 6 layers, d_model 512, 8 heads, seq 256
MODEL = dict(src_vocab=32000, tgt_vocab=32000, max_len=256, n_layer=6,
             n_head=8, d_model=512, d_inner_hid=2048, dropout_rate=0.0)
MAIN_SHAPE = (8, 8, 256, 64)     # [B, H, T, D] of every attention per request
TRAIN_SHAPE = (16, 8, 256, 64)   # ... and per train step
BERT_SHAPE = (16, 12, 128, 64)   # ... and per BERT-base train step
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
COMPILED_STEPS = 4
# a path's runs from this one on are replays of its captured graph: the
# first run of a plan is the eager warm-up and the second captures it, so
# medians of steady steps and requests start here
STEADY = 2
FUSION_LOSS_TOL = (2e-4, 1e-5)
FUSION_PARAM_TOL = (2e-3, 2e-5)
# phase 8: bf16 logits against fp32 within this fraction of the largest
# |logit|. tests/test_torch_analysis.py holds the tiny model (2 + 2
# layers) at 2^-6 and measures 0.85 bf16 ulp there; rounding drift grows
# about as the square root of depth, 1.7x for 6 + 6 layers, so twice the
# CPU bound (4 bf16 ulps at the largest magnitude)
BF16_SERVE_REL = 2.0 ** -5

# phases 9-10: ResNet-50 at bench.py's widths (bench_resnet, bench.py:
# 914 and 953-960: 224x224, the batch ladder's first rung, 1000 classes
# for training; the resnet50_infer row's 102 classes, bench.py:750-753)
RESNET_IMAGE = (3, 224, 224)
RESNET_BATCH = 128
RESNET_CLASSES = 1000
RESNET_SERVE_CLASSES = 102
RESNET_FWD_FLOPS = 7.767e9  # per image, 2 x MACs (bench.py:924-931)
# the card's fp32 step against the CPU's: tests/test_torch_resnet.py's
# bounds for the port against the JAX package, where the two sum the
# batch statistics in another order, as cuDNN and the CPU do: the loss
# within 1e-4 relative, the gradients within 0.1 relative in L2
# together and 0.25 each (53 batch_norm layers amplify the statistics'
# last bits; measured 4.1-5.2% together, 5.7-6.8% at most each, on the
# CPU from two initial states)
RESNET_FP32_REPLAY_TOL = {"loss": 1e-4, "grads_l2": 0.1, "grad_l2": 0.25}
# NHWC against NCHW, the step-1 loss (tests/test_layout_pass.py:116)
RESNET_LAYOUT_RTOL = 1e-4
# phases 9-10, every op replayed on the card on the CPU run's values: the
# per-op bounds tests/test_torch_resnet.py holds the port to against the
# JAX package (test_r50_each_op_replayed_on_jax_values_agrees), relative
# to each output's largest magnitude, plus 1e-6. fp32 1e-4: the two sum a
# batch_norm's channel statistics in other orders (3.5e-5 measured there),
# as cuDNN and the CPU order a convolution's sums. bf16 2^-6, two bf16
# ulps at that magnitude: an fp32 sum in another order flips the last
# bit of a rounded output. An output that rebinds a persistable (momentum's
# parameter and velocity, batch_norm's running statistics) is held by its
# change over the step, plus one fp32 ulp of the new value (its rounding).
# Integer outputs are equal. End to end, bf16's rounding moves ResNet-50's
# step-1 gradients by about 130% in L2 in either place, so AMP and bf16
# serving are held op by op and their end-to-end distances are printed
OP_REPLAY_REL = {False: 1e-4, True: 2.0 ** -6}
# the folded serving weights (W * gamma / sigma, (b - mu) * gamma / sigma
# + beta, elementwise in fp32), card against CPU, relative to each
# tensor's largest magnitude: a few fp32 ulps
FOLD_REL = 1e-6

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
    b, h, t, d = BERT_SHAPE
    yield "bert (key bias, a row of 1)", make_case(b, h, t, t, d, dtype, lens(b - 1, t) + [1], 45), False


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


def time_kernel(dtype, causal, shape=MAIN_SHAPE):
    b, h, t, d = shape
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
    b, h, t, d = BERT_SHAPE
    yield "bert (key bias, a row of 1)", make_case(b, h, t, t, d, dtype, lens(b - 1, t) + [1], 46), False


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


def serve(pred, feed, cfg):
    """One request: the logits, checked finite and of the right shape, and
    its milliseconds."""
    t0 = time.perf_counter()
    logits = pred.run(feed)[0].as_tensor()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = [len(feed["src_word"]), cfg["max_len"], cfg["tgt_vocab"]]
    if list(logits.shape) != want or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {list(logits.shape)} (want {want}) "
                             "or not finite")
    return logits, ms


@contextlib.contextmanager
def traced_launches():
    """The flash kernels the card runs in the body, counted by kernel name
    in a torch.profiler trace (CUDA activity), with the wrappers' counts
    zeroed just before: a replay of a captured graph launches its kernels
    without calling the wrappers, whose counts cover the eager runs and
    the captures only. Yields a dict that gets, when the body ends,
    "traced" (forward kernels, backward kernels: BWD_KERNELS per backward
    call), "traced_bf16" (forward kernels on bf16 inputs) and the
    wrappers' "calls" (forward, backward) and "calls_by_dtype"."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fa.launches = fa.bwd_launches = 0
    fa.launch_dtypes.clear()
    got = {}
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        yield got
        torch.cuda.synchronize()
    rows = [(e.key, e.count) for e in prof.key_averages()]
    fwd = [(k, n) for k, n in rows if "flash_fwd_kernel" in k]
    got["traced"] = (sum(n for _, n in fwd),
                     sum(n for k, n in rows if "flash_bwd_" in k))
    got["traced_bf16"] = sum(n for k, n in fwd if "bfloat16" in k)
    got["calls"] = (fa.launches, fa.bwd_launches)
    got["calls_by_dtype"] = dict(fa.launch_dtypes)


def check_launches(label, counted, want, dtype=None):
    """A path's flash launches from ``traced_launches`` against ``want``
    (forward, backward), every forward one on ``dtype`` inputs when given;
    the wrappers must have launched (or captured) each kernel the path
    runs at least once. Returns the traced (forward, backward)."""
    traced, calls = counted["traced"], counted["calls"]
    log(f"{label}: flash launches {traced[0]} forward + {traced[1]} "
        f"backward kernels by name in a trace of the path (want {want[0]} + "
        f"{want[1]}); wrapper calls (eager runs and captures) {calls[0]} "
        f"forward + {calls[1]} backward, by dtype "
        f"{counted['calls_by_dtype']}")
    if traced != tuple(want):
        raise AssertionError(f"{label}: flash launches {traced}, want {want}")
    if any(bool(w) != bool(c) for w, c in zip(want, calls)):
        raise AssertionError(f"{label}: wrapper calls {calls}: a kernel of "
                             "the path was never launched through its "
                             "wrapper")
    if dtype is not None and (
            counted["traced_bf16"] != (traced[0] if dtype == "bfloat16"
                                       else 0)
            or set(counted["calls_by_dtype"]) != {dtype}):
        raise AssertionError(f"{label}: forward launches not all on {dtype} "
                             f"inputs ({counted['traced_bf16']} traced on "
                             f"bf16; calls {counted['calls_by_dtype']})")
    return traced


def main_path(model_dir, profile):
    """Phase 5. Returns the path's forward launches, its requests, their
    logits and the steady request times, for phase 8."""
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
    one = {k: v[:1] for k, v in make_request(cfg, 8, SEED + 10).items()}
    with traced_launches() as counted:
        for i in range(4):
            feed = make_request(cfg, 8, SEED + i)
            logits, ms = serve(pred, feed, cfg)
            requests.append(feed)
            request_logits.append(logits)
            if i >= STEADY:
                steady_ms.append(ms)
            tokens = int(feed["trg_len"].sum())
            what = {0: " (warm-up)", 1: " (capture)"}.get(i, "")
            log(f"request {i}: batch 8, {ms:.2f} ms (traced), {tokens} "
                f"target tokens, {tokens / ms * 1e3:.1f} target tokens/s"
                f"{what}")
        gpu_logits, _ = serve(pred, one, cfg)
    launches = check_launches("serving", counted,
                              (5 * LAUNCHES_PER_REQUEST, 0), "float32")[0]

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
    """``steps`` steps at TRAIN_BATCH; checks each step's loss. Returns
    (losses, step ms)."""
    losses, step_ms = [], []
    for i in range(steps):
        feed = train_batch(cfg, TRAIN_BATCH, SEED + 100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss,) = run_tensors(exe, program, feed=feed,
                              fetch_list=[loss_name], scope=scope)
        loss = float(loss.reshape(-1)[0].item())
        ms = (time.perf_counter() - t0) * 1e3
        tokens = int(feed["trg_len"].sum())
        log(f"{label} step {i}: loss {loss:.6f}, {ms:.1f} ms, {tokens} target "
            f"tokens, {tokens / ms * 1e3:.0f} target tokens/s")
        if not np.isfinite(loss):
            raise AssertionError(f"{label} step {i}: loss {loss}")
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
        out = run_tensors(exe, program, feed=feed, fetch_list=fetch,
                          scope=scope)
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

    torch.cuda.reset_peak_memory_stats()
    fp32_scope = copy_state(state, exe.device)
    amp_scope = copy_state(state, exe.device)
    with traced_launches() as counted:
        fp32_losses, fp32_ms = train_steps(exe, m["main"], fp32_scope,
                                           loss_name, m["config"],
                                           "fp32 (traced)")
        peak = torch.cuda.max_memory_allocated()
        amp_losses, amp_ms = train_steps(exe, amp_main, amp_scope, loss_name,
                                         m["config"], "bf16 AMP (traced)")
    launches = check_launches("training", counted,
                              (2 * TRAIN_STEPS * FWD_PER_STEP,
                               2 * TRAIN_STEPS * BWD_PER_STEP))
    rel = max(abs(a - f) / abs(f) for a, f in zip(amp_losses, fp32_losses))
    log(f"fp32 median step {np.median(fp32_ms[STEADY:]):.1f} ms, AMP "
        f"{np.median(amp_ms[STEADY:]):.1f} ms (steps {STEADY}-"
        f"{TRAIN_STEPS - 1}); peak "
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
                     float(np.median(fp32_ms[STEADY:])), "fp32")
        profile_step(exe, m, amp_main, amp_scope,
                     float(np.median(amp_ms[STEADY:])), "bf16 AMP")
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
        out = run_tensors(exe, target, feed=feed, fetch_list=fetch,
                          scope=scope)
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


def in_turns(arms, feeds, start=STEADY):
    """Wall times of ``arms`` [(name, fn(feed))], one round per feed:
    round r runs the arms in order when r is even and in reverse when it
    is odd, so drift on the host (the steps of one phase can run 1.5x
    slower than those of an earlier one) reaches every arm alike. Returns
    each arm's median ms over rounds ``start`` onward (by default after
    the warm-up and the capture)."""
    ms = [[] for _ in arms]
    for r, feed in enumerate(feeds):
        order = range(len(arms)) if r % 2 == 0 else reversed(range(len(arms)))
        for i in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arms[i][1](feed)
            torch.cuda.synchronize()
            ms[i].append((time.perf_counter() - t0) * 1e3)
    return [float(np.median(t[start:])) for t in ms]


def train_arms(exe, state, arms):
    """``arms`` [(label, target, loss name)] as in_turns arms, each a
    step from its own copy of ``state`` that checks its loss finite."""
    def arm(label, target, loss_name):
        scope = copy_state(state, exe.device)

        def step(feed):
            (loss,) = run_tensors(exe, target, feed=feed,
                                  fetch_list=[loss_name], scope=scope)
            if not bool(torch.isfinite(loss).all()):
                raise AssertionError(f"{label}: loss {loss}")
        return label, step
    return [arm(*a) for a in arms]


def steps_in_turns(exe, state, cfg, arms, rounds=5):
    """Step times of ``arms`` [(label, program, loss name)] taken in
    turns (``in_turns``), each arm from its own copy of ``state``; prints
    each arm's median."""
    medians = in_turns(train_arms(exe, state, arms), [
        train_batch(cfg, TRAIN_BATCH, SEED + 400 + r) for r in range(rounds)])
    log(f"steps in turns ({rounds} rounds, medians of rounds {STEADY}-"
        f"{rounds - 1}): " + ", ".join(
            f"{label} {med:.1f} ms"
            for (label, _, _), med in zip(arms, medians)))


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
    scope = copy_state(state, exe.device)
    amp_scope = copy_state(state, exe.device)
    with traced_launches() as counted:
        losses, step_ms = train_steps(exe, target, scope, loss_name, cfg,
                                      "compiled fp32 (traced)",
                                      COMPILED_STEPS)
        amp_losses, amp_ms = train_steps(exe, amp_target, amp_scope,
                                         loss_name, cfg,
                                         "compiled bf16 AMP (traced)",
                                         COMPILED_STEPS)
    launches = check_launches("compiled_training", counted,
                              (2 * COMPILED_STEPS * FWD_PER_STEP,
                               2 * COMPILED_STEPS * BWD_PER_STEP))
    stats = exe.pipeline_stats
    log(f"pipeline runs {stats['runs']} (fp32 and AMP programs), memo hits "
        f"{stats['memo_hits']}, {stats['seconds'] * 1e3:.1f} ms in all")
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
        f"{np.median(trained['fp32_ms'][STEADY:]):.1f} ms, AMP "
        f"{np.median(trained['amp_ms'][STEADY:]):.1f} ms (steps {STEADY}-"
        f"{TRAIN_STEPS - 1}); compiled fp32 "
        f"{np.median(step_ms[STEADY:]):.1f} ms, AMP "
        f"{np.median(amp_ms[STEADY:]):.1f} ms, fused build on plain "
        f"Executor {np.median(ref_ms[STEADY:]):.1f} ms (steps {STEADY}-"
        f"{COMPILED_STEPS - 1})")
    if profile:
        profile_step(exe, m, target, scope,
                     float(np.median(step_ms[STEADY:])),
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
    steady_ms = []
    with traced_launches() as counted:
        answers = [serve(pred, feed, cfg) for feed in served["requests"]]
    launches = check_launches("analysis_serving_bf16", counted,
                              (4 * LAUNCHES_PER_REQUEST, 0), "bfloat16")[0]
    for i, ((logits, ms), ref) in enumerate(zip(answers, served["logits"])):
        if logits.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 serving returned {logits.dtype}")
        err = (logits.float() - ref).abs().max().item()
        top = ref.abs().max().item()
        agree = (logits.float().argmax(-1) == ref.argmax(-1)).double().mean()
        log(f"bf16 request {i}: {ms:.2f} ms (traced); against the fp32 "
            f"NativePredictor max|dlogits| {err:.3e} of max|logits| "
            f"{top:.3e} ({err / top:.3e}, bound {BF16_SERVE_REL:.3e}), "
            f"arg-max agreement {agree.item():.4f}")
        if not err <= BF16_SERVE_REL * top:
            raise AssertionError("bf16 logits disagree with fp32")
        if i >= STEADY:
            steady_ms.append(ms)
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
    gpu_logits, _ = serve(pred, one, cfg)
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
    log(f"median steady request ({STEADY}-3): NativePredictor fp32 "
        f"{np.median(served['steady_ms']):.2f} ms, AnalysisPredictor bf16 "
        f"{np.median(steady_ms):.2f} ms")
    if profile:
        profile_request(pred, served["requests"][1], model_dir,
                        float(np.median(steady_ms)), "bf16 AnalysisPredictor")
    return launches


# ---------------------------------------------------------------------------
# phase 9: ResNet-50 training through CompiledProgram
# ---------------------------------------------------------------------------

def resnet_batch(batch, seed, classes=RESNET_CLASSES):
    """Seeded images in [0, 1) and int32 labels, as bench.py feeds them."""
    rng = np.random.RandomState(seed)
    return {"data": rng.rand(batch, *RESNET_IMAGE).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int32)}


def resnet_steps(exe, target, scope, loss_name, label, steps, seed0):
    """``steps`` steps at RESNET_BATCH, losses checked finite; returns
    (losses, step ms)."""
    losses, step_ms = [], []
    for i in range(steps):
        feed = resnet_batch(RESNET_BATCH, seed0 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss,) = run_tensors(exe, target, feed=feed,
                              fetch_list=[loss_name], scope=scope)
        loss = float(loss.reshape(-1)[0].item())
        ms = (time.perf_counter() - t0) * 1e3
        log(f"{label} step {i}: loss {loss:.6f}, {ms:.1f} ms, "
            f"{RESNET_BATCH / ms * 1e3:.1f} images/s")
        if not np.isfinite(loss):
            raise AssertionError(f"{label} step {i}: loss {loss}")
        losses.append(loss)
        step_ms.append(ms)
    return losses, step_ms


def _rel_l2(got, want):
    g = torch.cat([t.reshape(-1).double() for t in got])
    w = torch.cat([t.reshape(-1).double() for t in want])
    return (torch.linalg.norm(g - w) / torch.linalg.norm(w)).item()


def _op_error(want, got, before, rel, top=None):
    """(error, bound) of one op's output on the card against the CPU's,
    the bound ``rel`` of ``top``, by default the output's largest
    magnitude; ``before`` is the persistable input the output rebinds, or
    None."""
    if got is None or got.dtype != want.dtype or got.shape != want.shape:
        return float("inf"), 0.0
    got = got.cpu()
    if not want.is_floating_point():
        return (0.0 if torch.equal(got, want) else float("inf")), 0.0
    if not want.numel():
        return 0.0, 0.0
    want, got = want.double(), got.double()
    floor = 1e-6
    if before is not None:
        floor = float(np.spacing(np.float32(want.abs().max().item())))
        want = want - before.double()  # the change; got - want is unmoved
        got = got - before.double()
    err = (got - want).abs().max().item()
    if top is None:
        top = want.abs().max().item()
    return err, rel * top + floor


def replay_each_op(ops, block, scope, feed, device, amp, label, rel=None,
                   tops=None):
    """Run ``ops`` in order on the CPU from ``feed`` and ``scope`` (CPU
    tensors), and each op once more on ``device`` on the CPU's input
    values: every output within ``rel[op type]`` (by default
    ``rel["*"]``, by default OP_REPLAY_REL) of its largest magnitude on
    the CPU, or of the magnitude ``tops[op type](ins, attrs)`` gives by
    output slot. Returns the CPU run's values by name."""
    rel = rel or {"*": OP_REPLAY_REL[amp]}
    tops = tops or {}
    cpu = torch.device("cpu")
    ctx_cpu = pt.registry.EmitContext(cpu, amp=amp)
    ctx_card = pt.registry.EmitContext(device, amp=amp)
    env = {n: pt.executor._coerce_feed(v, n, block, cpu)
           for n, v in feed.items()}
    worst, n_out, t0 = {}, 0, time.perf_counter()
    with torch.no_grad():
        for op in ops:
            if pt.registry.has_op(op.type) and \
                    pt.registry.lookup(op.type).needs_rng:
                raise AssertionError(f"{op.type} draws random numbers")
            emit = pt.executor._emitter(op.type)
            ins = {slot: [None if not n else env[n] if n in env
                          else scope.find_var(n) for n in names]
                   for slot, names in op.inputs.items()}
            got = emit(ctx_card, {slot: [None if v is None else v.to(device)
                                         for v in vals]
                                  for slot, vals in ins.items()}, op.attrs)
            want = emit(ctx_cpu, ins, op.attrs)
            read = {n: v for slot, names in op.inputs.items()
                    for n, v in zip(names, ins[slot]) if n}
            top = tops[op.type](ins, op.attrs) if op.type in tops else {}
            for slot, names in op.outputs.items():
                outs = (got or {}).get(slot) or [None] * len(names)
                for n, w, g in zip(names, (want or {}).get(slot) or (), outs):
                    if not n or w is None:
                        continue
                    before = read.get(n) if pt.executor._is_persistable(
                        block, n) else None
                    err, bound = _op_error(
                        w, g, before, rel.get(op.type, rel["*"]),
                        top.get(slot))
                    n_out += 1
                    key = op.type + (" (state)" if before is not None else "")
                    worst[key] = max(worst.get(key, (0.0, 0.0)),
                                     (err / max(bound, 1e-30), err))
                    if not err <= bound:
                        raise AssertionError(
                            f"{label}: {op.type} output {n} on the card "
                            f"{err:.3e} from the CPU's, bound {bound:.3e}")
                    env[n] = w
    log(f"{label}: {len(ops)} ops replayed on the card on the CPU run's "
        f"values ({time.perf_counter() - t0:.1f} s), {n_out} outputs within "
        f"{rel} of their largest magnitudes (of {sorted(tops)}'s sums of "
        f"absolute products); largest "
        f"share of the bound by op: " + ", ".join(
            f"{k} {v[0]:.2f}" for k, v in sorted(
                worst.items(), key=lambda kv: -kv[1][0])[:16]))
    return env


def resnet_replay(exe, m, program, amp_program, state):
    """Step 1 at batch 2 from the same weights. Op by op: the rewritten
    list the card runs for a step, fp32 and AMP, replayed by
    ``replay_each_op`` (the gate for AMP). End to end, on the card and
    through Executor(CPUPlace()): the loss and every parameter's
    gradient; fp32 at tests/test_torch_resnet.py's end-to-end bounds for
    the port against the JAX package (RESNET_FP32_REPLAY_TOL); AMP's
    distance printed beside bf16's own effect on the CPU (the CPU's AMP
    step against its fp32 step), since bf16's rounding alone moves
    ResNet-50's step-1 gradients by about 130% in L2 and no end-to-end
    bound short of that holds (tests/test_torch_resnet.py)."""
    feed = resnet_batch(2, SEED + 50)
    block = m["main"].global_block()
    for label, prog in (("fp32", program), ("amp", amp_program)):
        replay_each_op(exe.lowered_ops(prog, [m["loss"].name]), block,
                       copy_state(state, torch.device("cpu")), feed,
                       exe.device, prog._program._amp,
                       f"ResNet-50 {label} step at batch 2")
    params = [p.name for p in m["main"].all_parameters()]
    fetch = [m["loss"].name] + [n + "@GRAD" for n in params]
    out = {}
    t0 = time.perf_counter()
    for where, exe in (("card", pt.Executor()),
                       ("cpu", pt.Executor(pt.CPUPlace()))):
        for label, prog in (("fp32", program), ("amp", amp_program)):
            scope = copy_state(state, exe.device)
            res = run_tensors(exe, prog, feed=feed, fetch_list=fetch,
                              scope=scope)
            out[where, label] = [t.cpu().float() for t in res]
    log(f"ResNet-50 batch-2 step replayed on the CPU "
        f"({time.perf_counter() - t0:.1f} s for the four steps)")
    for label in ("fp32", "amp"):
        card, cpu = out["card", label], out["cpu", label]
        loss_err = abs(card[0].item() - cpu[0].item()) / abs(cpu[0].item())
        all_l2 = _rel_l2(card[1:], cpu[1:])
        each = max(_rel_l2([g], [c]) for g, c in zip(card[1:], cpu[1:]))
        log(f"  {label}: loss {card[0].item():.7f} on the card, "
            f"{cpu[0].item():.7f} on the CPU ({loss_err:.3e} relative); the "
            f"{len(params)} gradients {all_l2:.3e} relative in L2 "
            f"together, {each:.3e} at most each")
        if not all(bool(torch.isfinite(t).all()) for t in card):
            raise AssertionError(f"ResNet-50 {label} replay: not finite")
        if label == "fp32":
            tol = RESNET_FP32_REPLAY_TOL
            if not (loss_err <= tol["loss"] and all_l2 <= tol["grads_l2"]
                    and each <= tol["grad_l2"]):
                raise AssertionError("ResNet-50 fp32 card and CPU steps "
                                     "disagree")
        else:
            cpu32 = out["cpu", "fp32"]
            log(f"  bf16's own effect on the CPU: loss "
                f"{abs(cpu[0].item() - cpu32[0].item()):.3e}, gradients "
                f"{_rel_l2(cpu[1:], cpu32[1:]):.3e} relative in L2")


def fused_momentum_bitwise(state, grads):
    """fused_momentum against one momentum op per parameter, on the card,
    on the same gradient tensors (one backward's; cuDNN's weight
    gradients need not repeat bitwise, so no second backward is run):
    parameters and velocities bitwise equal."""
    names = sorted(grads)
    device = grads[names[0]].device
    ctx = pt.registry.EmitContext(device)
    lr = torch.full((1,), 0.1, device=device)
    ins = {"Param": [state[n] for n in names],
           "Grad": [grads[n] for n in names],
           "Velocity": [torch.randn_like(state[n]) * 1e-2 for n in names],
           "LearningRate": [lr] * len(names)}
    worst = 0
    for nesterov in (False, True):
        attrs = {"mu": 0.9, "use_nesterov": nesterov}
        fused = pt.registry.lookup("fused_momentum").emitter(ctx, ins, attrs)
        for i in range(len(names)):
            one = pt.registry.lookup("momentum").emitter(
                ctx, {k: [v[i]] for k, v in ins.items()}, attrs)
            for slot, vals in one.items():
                if not torch.equal(fused[slot][i], vals[0]):
                    raise AssertionError(f"fused_momentum differs from "
                                         f"momentum: {names[i]} {slot}")
                worst = max(worst, (vals[0] - ins["Param"][i]).abs().max()
                            .item() if slot == "ParamOut" else 0)
    log(f"fused_momentum bitwise equal to momentum over {len(names)} "
        f"parameters, plain and Nesterov (largest update {worst:.3e})")


def resnet_turns(exe, arms, state, rounds=5):
    """AMP step times of ``arms`` [(label, target, loss name)] in turns
    (``in_turns``), each from its own copy of ``state``; returns each
    arm's median."""
    medians = in_turns(train_arms(exe, state, arms), [
        resnet_batch(RESNET_BATCH, SEED + 400 + r) for r in range(rounds)])
    log(f"ResNet-50 AMP steps in turns ({rounds} rounds, medians of rounds "
        f"{STEADY}-{rounds - 1}): " + ", ".join(
            f"{label} {med:.1f} ms ({RESNET_BATCH / med * 1e3:.1f} images/s)"
            for (label, _, _), med in zip(arms, medians)))
    return medians


def resnet_training_path(smi, profile):
    """Phase 9. Returns the flash kernels' (fwd, bwd) launches on it."""
    builds = {}
    for layout in ("NCHW", "NHWC"):
        with unique_name.guard():
            builds[layout] = resnet.build(
                dataset="flowers", depth=50, class_dim=RESNET_CLASSES,
                image_shape=list(RESNET_IMAGE), lr=0.1, layout=layout)
    m = builds["NCHW"]
    loss_name = m["loss"].name
    m["startup"].random_seed = SEED
    exe = pt.Executor()
    init = pt.Scope()
    t0 = time.perf_counter()
    exe.run(m["startup"], scope=init)
    state = {n: init.find_var(n) for n in init.var_names()}
    n_params = sum(state[p.name].numel() for p in m["main"].all_parameters())
    log(f"ResNet-50 startup on {exe.device}: {time.perf_counter() - t0:.2f} "
        f"s, {len(state)} persistables, {n_params} parameter elements")

    target = pt.CompiledProgram(m["main"],
                                build_strategy=bench_build_strategy())
    t0 = time.perf_counter()
    ops = exe.lowered_ops(target, [loss_name])
    pipeline_ms = (time.perf_counter() - t0) * 1e3
    types = [o.type for o in ops]
    counts = {t: types.count(t) for t in (
        "conv2d", "conv2d_grad", "batch_norm", "fused_conv2d", "momentum",
        "fused_momentum", "fused_elemwise_activation", "transpose")}
    log(f"train program {len(m['main'].global_block().desc.ops)} ops; "
        f"rewritten live list {len(ops)} ops in {pipeline_ms:.1f} ms: "
        f"{counts}")
    stages = exe.pipeline_stats["stages"]
    for name, row in stages.items():
        log(f"  stage {name}: {row['ops_removed']} ops removed, "
            f"{row['seconds'] * 1e3:.1f} ms")
    if counts["momentum"] or counts["fused_momentum"] < 1:
        raise AssertionError(f"the pipeline left {counts}: want no momentum "
                             "and a fused_momentum")
    # a training list: fuse_conv_bn folds inference batch norms only, and
    # ResNet's convs carry no bias for fuse_conv_epilogue to take
    for name in ("fuse_conv_bn", "fuse_conv_epilogue"):
        if stages[name]["ops_removed"]:
            raise AssertionError(f"{name} rewrote the ResNet-50 train "
                                 "program, which has no pattern for it")

    amp_main = mixed_precision.decorate(m["main"].clone())
    amp_target = pt.CompiledProgram(amp_main,
                                    build_strategy=bench_build_strategy())
    fa.launches = fa.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    scope = copy_state(state, exe.device)
    losses, fp32_ms = resnet_steps(exe, target, scope, loss_name,
                                   "ResNet-50 compiled fp32", 4, SEED + 100)
    fp32_peak = torch.cuda.max_memory_allocated()
    # the fp32 graph's pool, about an eager fp32 step's peak, would
    # otherwise stay beside the eager fp32 batch-128 runs below
    exe.close()
    release()
    torch.cuda.reset_peak_memory_stats()
    amp_scope = copy_state(state, exe.device)
    amp_losses, amp_ms = resnet_steps(exe, amp_target, amp_scope, loss_name,
                                      "ResNet-50 compiled bf16 AMP", 5,
                                      SEED + 100)
    amp_peak = torch.cuda.max_memory_allocated()
    launches = (fa.launches, fa.bwd_launches)
    if launches != (0, 0):
        raise AssertionError(f"flash launches {launches} on ResNet-50")
    flops = 3 * RESNET_FWD_FLOPS * RESNET_BATCH
    for label, ms, peak in (("fp32", fp32_ms, fp32_peak),
                            ("AMP", amp_ms, amp_peak)):
        med = float(np.median(ms[STEADY:]))
        log(f"ResNet-50 {label}: median step {med:.1f} ms (steps {STEADY}-"
            f"{len(ms) - 1}), {RESNET_BATCH / med * 1e3:.1f} images/s, peak "
            f"memory {peak / 2 ** 30:.2f} GiB; {flops / 1e12:.2f} TFLOP per "
            f"step (3 x 7.767 GFLOP per image) bound it at "
            f"{flops / BF16_FLOPS * 1e3:.3f} ms at 989 TFLOP/s bf16 dense "
            f"({flops / (med * 1e-3) / BF16_FLOPS:.2%} of it) [{smi}]")

    # fused momentum on one backward's gradients
    grads_scope = copy_state(state, exe.device)
    params = [p.name for p in m["main"].all_parameters()]
    res = run_tensors(exe, m["main"],
                      feed=resnet_batch(RESNET_BATCH, SEED + 300),
                  fetch_list=[n + "@GRAD" for n in params],
                  scope=grads_scope)
    fused_momentum_bitwise(state, dict(zip(params, res)))

    resnet_replay(exe, m, target, amp_target, state)

    nhwc = builds["NHWC"]
    n_t = [o.type for o in nhwc["main"].global_block().desc.ops].count(
        "transpose")
    if n_t != 2:
        raise AssertionError(f"the NHWC build holds {n_t} transposes, want 2")
    nhwc_target = pt.CompiledProgram(nhwc["main"],
                                     build_strategy=bench_build_strategy())
    nhwc_losses, _ = resnet_steps(exe, nhwc_target,
                                  copy_state(state, exe.device), loss_name,
                                  "ResNet-50 NHWC compiled fp32", 1,
                                  SEED + 100)
    rel = abs(nhwc_losses[0] - losses[0]) / abs(losses[0])
    log(f"NHWC step-1 loss within {rel:.3e} relative of NCHW's (bound "
        f"{RESNET_LAYOUT_RTOL}, tests/test_layout_pass.py:116)")
    if not rel <= RESNET_LAYOUT_RTOL:
        raise AssertionError("the NHWC and NCHW step-1 losses disagree")
    nhwc_amp = pt.CompiledProgram(
        mixed_precision.decorate(nhwc["main"].clone()),
        build_strategy=bench_build_strategy())
    medians = resnet_turns(exe, [("NCHW", amp_target, loss_name),
                                 ("NHWC", nhwc_amp, loss_name)], state)
    log(f"NHWC AMP step at {medians[1] / medians[0]:.3f}x NCHW's [{smi}]")
    if profile:
        profile_resnet_step(exe, amp_target, state, loss_name,
                            float(np.median(amp_ms[STEADY:])), "NCHW AMP")
        profile_resnet_step(exe, nhwc_amp, state, loss_name, medians[1],
                            "NHWC AMP")
        stem_input_grad(m, state, smi)
    return launches


def _top_rows(rows, busy, n=16):
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:n]:
        log(f"  {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% "
            f"x{count:<5} {key[:100]}")
    convs = [r for r in rows if any(t in r[0].lower() for t in (
        "conv", "implicit", "dgrad", "wgrad", "fprop", "cudnn"))]
    ms = sum(r[1] for r in convs) / 1e3
    log(f"  convolution kernels (cuDNN's choice): {ms:.3f} ms "
        f"({ms / busy:.1%}) over {sum(r[2] for r in convs)} launches; "
        + "; ".join(f"{r[0][:70]} x{r[2]}"
                    for r in sorted(convs, key=lambda r: -r[1])[:6]))


def profile_resnet_step(exe, target, state, loss_name, steady_ms, label):
    scope = copy_state(state, exe.device)
    feed = resnet_batch(RESNET_BATCH, SEED + 200)
    rows, busy = device_rows(lambda: run_tensors(exe, 
        target, feed=feed, fetch_list=[loss_name], scope=scope))
    log(f"profile of one ResNet-50 {label} step (batch {RESNET_BATCH}): "
        f"{busy:.3f} ms of device time by kernel; median steady step "
        f"{steady_ms:.3f} ms wall, so the card is idle "
        f"{max(0.0, 1 - busy / steady_ms):.1%} of it")
    _top_rows(rows, busy)


def stem_input_grad(m, state, smi):
    """Card time of the first convolution's backward at RESNET_BATCH with
    and without its input's gradient: the image's, which no op reads, and
    which conv2d_grad computes and the executor drops, as the generic vjp
    would. Eager calls, fp32 and bf16."""
    op = next(o for o in m["main"].global_block().desc.ops
              if o.type == "conv2d")
    a = op.attrs
    geom = (a["strides"], a["paddings"], a["dilations"])
    groups = a.get("groups") or 1
    for dtype in (torch.float32, torch.bfloat16):
        w = state[op.input("Filter")[0]].to(dtype)
        x = torch.rand(RESNET_BATCH, *RESNET_IMAGE, device=w.device,
                       dtype=dtype)
        og = torch.nn.functional.conv2d(x, w, None, *geom, groups)
        ms = [time_ms(lambda mask=mask: torch.ops.aten.convolution_backward(
            og, x, w, None, *geom, False, [0, 0], groups, mask),
            iters=10, graph=False)
            for mask in ([True, True, False], [False, True, False])]
        log(f"stem convolution {list(x.shape)} * {list(w.shape)} "
            f"{str(dtype)[6:]}: backward {ms[0]:.3f} ms with the image's "
            f"gradient, {ms[1]:.3f} ms without [{smi}]")


# ---------------------------------------------------------------------------
# phase 10: ResNet-50 serving
# ---------------------------------------------------------------------------

def calibrate_batch_norm(exe, test_program, scope, feed):
    """Give the inference model a trained model's batch_norm statistics:
    one forward of the test program with batch statistics (is_test off
    in a copy) on a seeded batch, and each layer's running mean and
    variance set to that batch's. With the initial (0, 1) the random
    network's activations grow about twofold per residual block and the
    softmax saturates."""
    prog = test_program.clone()
    bns = [op for op in prog.global_block().desc.ops
           if op.type == "batch_norm"]
    for op in bns:
        op.attrs["is_test"] = False
    fetch = [n for op in bns for n in (op.output("SavedMean")[0],
                                       op.output("SavedVariance")[0])]
    vals = run_tensors(exe, prog, feed=feed, fetch_list=fetch, scope=scope)
    for i, op in enumerate(bns):
        mean, inv_std = vals[2 * i], vals[2 * i + 1]
        eps = op.attrs.get("epsilon", 1e-5)
        scope.set_var(op.input("Mean")[0], mean.clone())
        scope.set_var(op.input("Variance")[0], inv_std.pow(-2) - eps)
    return len(bns)


def resnet_serve(pred, feed, dtype=None):
    t0 = time.perf_counter()
    probs = pred.run(feed)[0].as_tensor()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = [len(feed["data"]), RESNET_SERVE_CLASSES]
    if list(probs.shape) != want or not torch.isfinite(probs).all():
        raise AssertionError(f"probabilities {list(probs.shape)} (want "
                             f"{want}) or not finite")
    if dtype is not None and probs.dtype != dtype:
        raise AssertionError(f"served {probs.dtype}, want {dtype}")
    return probs, ms


def resnet_serving_path(model_dir, smi, profile):
    """Phase 10. Returns the flash kernels' forward launches on it."""
    with unique_name.guard():
        m = resnet.build(dataset="flowers", depth=50,
                         class_dim=RESNET_SERVE_CLASSES,
                         image_shape=list(RESNET_IMAGE))
    m["startup"].random_seed = SEED + 1
    exe, scope = pt.Executor(), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(m["startup"])
        n_bn = calibrate_batch_norm(exe, m["test"], scope,
                                    {"data": resnet_batch(
                                        RESNET_BATCH, SEED + 60)["data"]})
        pt.io.save_inference_model(model_dir, ["data"], [m["predict"]], exe,
                                   main_program=m["test"])
    log(f"ResNet-50 inference model saved ({n_bn} batch_norm layers "
        "calibrated on one batch)")
    requests = [{"data": resnet_batch(RESNET_BATCH, SEED + 70 + i)["data"]}
                for i in range(4)]
    fa.launches = fa.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    native = create_paddle_predictor(NativeConfig(model_dir))
    pred = create_paddle_predictor(AnalysisConfig(model_dir).enable_bf16())
    pred32 = create_paddle_predictor(
        AnalysisConfig(model_dir).enable_bf16(False))
    types = [o.type for o in pred._program.global_block().desc.ops]
    log(f"AnalysisPredictor: {len(types)} ops after the passes (the saved "
        f"program {len(native._program.global_block().desc.ops)}): "
        f"{types.count('conv2d_fusion')} conv2d_fusion, "
        f"{types.count('batch_norm')} batch_norm, {types.count('conv2d')} "
        f"conv2d")
    if types.count("batch_norm"):
        raise AssertionError("batch_norm left after the analysis passes")
    times = {"native fp32": [], "analysis fp32": [], "analysis bf16": []}
    worst32, worst16, agree = 0.0, 0.0, []
    for i, feed in enumerate(requests):
        ref, ms = resnet_serve(native, feed, torch.float32)
        times["native fp32"].append(ms)
        got32, ms = resnet_serve(pred32, feed, torch.float32)
        times["analysis fp32"].append(ms)
        got16, ms = resnet_serve(pred, feed)
        times["analysis bf16"].append(ms)
        top = ref.abs().max().item()
        e32 = (got32 - ref).abs().max().item() / top
        e16 = (got16.float() - ref).abs().max().item() / top
        agree.append((got16.float().argmax(-1) == ref.argmax(-1))
                     .double().mean().item())
        log(f"request {i}: fp32 analysis {e32:.3e}, bf16 {e16:.3e} of "
            f"max|p| {top:.3e}; arg-max agreement {agree[-1]:.4f}")
        worst32, worst16 = max(worst32, e32), max(worst16, e16)
    if not worst32 <= 1e-3:
        raise AssertionError("the fp32 AnalysisPredictor disagrees with the "
                             "NativePredictor")
    for label, ts in times.items():
        med = float(np.median(ts[STEADY:]))
        log(f"{label}: median request {med:.2f} ms (requests {STEADY}-3), "
            f"{RESNET_BATCH / med * 1e3:.1f} images/s [{smi}]")
    log(f"peak memory over the three predictors' requests "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    launches = fa.launches
    if launches or fa.bwd_launches:
        raise AssertionError(f"flash launches {launches} on ResNet-50 "
                             "serving")
    log(f"bf16 against fp32 over the 4 requests: at most {worst16:.3e} of "
        f"max|p|, arg-max agreement {min(agree):.4f}-{max(agree):.4f} "
        "(printed only: held op by op below)")
    # each card predictor against a CPU one on the same directory: the
    # folded weights, then a batch-1 request op by op on the CPU's program,
    # scope and values
    one = {"data": requests[0]["data"][:1]}
    for card_pred, bf16 in ((pred, True), (pred32, False)):
        label = f"ResNet-50 {'bf16' if bf16 else 'fp32'} request at batch 1"
        cpu_pred = create_paddle_predictor(
            AnalysisConfig(model_dir, use_gpu=False).enable_bf16(bf16))
        ops = cpu_pred._exe.lowered_ops(cpu_pred._program,
                                        cpu_pred._fetch_names)
        card_ops = card_pred._exe.lowered_ops(card_pred._program,
                                              card_pred._fetch_names)
        if [o.type for o in ops] != [o.type for o in card_ops]:
            raise AssertionError(f"{label}: the card's and the CPU's "
                                 "predictors run different op lists")
        fold = 0.0
        for n in cpu_pred._scope.var_names():
            c = cpu_pred._scope.find_var(n)
            if c.is_floating_point() and c.numel():
                g = card_pred._scope.find_var(n).cpu()
                fold = max(fold, (g.double() - c.double()).abs().max().item()
                           / max(c.abs().max().item(), 1e-30))
        log(f"{label}: the card's scope within {fold:.3e} of the CPU "
            f"predictor's (bound {FOLD_REL})")
        if not fold <= FOLD_REL:
            raise AssertionError(f"{label}: folded weights differ")
        env = replay_each_op(ops, cpu_pred._program.global_block(),
                             cpu_pred._scope, one, card_pred.device,
                             cpu_pred._program._amp, label)
        cpu = env[cpu_pred._fetch_names[0]].float()
        gpu = resnet_serve(card_pred, one)[0].float().cpu()
        log(f"  end to end: the card's probabilities "
            f"{(gpu - cpu).abs().max().item():.3e} from the CPU "
            f"predictor's, max|p| {cpu.abs().max().item():.3e}")
    if profile:
        feed = requests[1]
        med = float(np.median(times["analysis bf16"][STEADY:]))
        rows, busy = device_rows(lambda: pred.run(feed))
        log(f"profile of one bf16 batch-{RESNET_BATCH} request: "
            f"{busy:.3f} ms of device time; median request {med:.3f} ms "
            f"wall, so the card is idle {max(0.0, 1 - busy / med):.1%} of it")
        _top_rows(rows, busy)
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
    rows, busy = device_rows(lambda: run_tensors(exe, 
        program, feed=feed, fetch_list=[m["loss"].name], scope=scope))
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
        _, fwd_busy = device_rows(lambda: run_tensors(exe, 
            m["test"], feed=feed, fetch_list=[m["loss"].name], scope=scope))
        fwd_flops = request_flops(m["main"].desc.blocks[0], TRAIN_BATCH)
        log(f"  the forward alone: {fwd_busy:.3f} ms of device time; step "
            f"operations {3 * fwd_flops / 1e9:.1f} GFLOP (3 x the forward's "
            f"{fwd_flops / 1e9:.1f}): fp32 bound "
            f"{3 * fwd_flops / CUDA_CORE_FP32_FLOPS * 1e3:.3f} ms at the "
            f"data-sheet 67 TFLOP/s")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:16]:
        log(f"  {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% "
            f"x{count:<5} {key[:90]}")



# ---------------------------------------------------------------------------
# phase 11: whole-step capture
# ---------------------------------------------------------------------------

CAPTURE_RUNS = 5   # captured runs against eager runs, per path
CAPTURE_K = 4      # run(iterations=K) against K single runs


def run_tensors(exe, *args, **kwargs):
    """``exe.run(..., return_numpy=False)`` with each fetch's tensor."""
    return [h.device_value()
            for h in exe.run(*args, return_numpy=False, **kwargs)]


@contextlib.contextmanager
def jit_cache(on):
    """FLAGS.jit_cache in the body: off, every run is eager (the oracle
    the captured runs are held against)."""
    old = FLAGS.jit_cache
    FLAGS.jit_cache = on
    try:
        yield
    finally:
        FLAGS.jit_cache = old


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` in the body, warning
    (not raising) on an op that has no deterministic implementation; the
    list it yields gets those warnings' messages when the body ends. The
    mode's fill of uninitialized memory is off: every kernel of these
    paths writes all of its output, and a fill would hide one that does
    not."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    found = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            yield found
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
            found.extend(sorted({str(w.message)[:200] for w in caught
                                 if "determinis" in str(w.message)}))


def distance(a, b):
    """0.0 when two tensors are bitwise equal, else their largest
    elementwise distance (inf where NaNs differ)."""
    if a.shape == b.shape and torch.equal(a, b):
        return 0.0
    d = (a.double() - b.double()).abs().max().item()
    return d if d == d else float("inf")


def scope_distance(a, b):
    """(largest distance, names that differ) over two scopes' tensors."""
    names = sorted(a.var_names())
    if names != sorted(b.var_names()):
        raise AssertionError("the two scopes hold different names")
    d = {n: distance(a.find_var(n), b.find_var(n)) for n in names}
    return max(d.values(), default=0.0), [n for n in names if d[n]]


def hold(label, what, got, bound):
    """A distance against its bound: two eager arms' distance from each
    other (the captured arm is bitwise equal to the eager one wherever the
    eager arms agree bitwise), or 0.0 (bitwise)."""
    log(f"  {label}: {what}: {got:.3e} (bound {bound:.3e}"
        f"{', bitwise' if not bound else ', eager against eager'})")
    if not got <= bound:
        raise AssertionError(f"{label}: {what}: {got:.3e} beyond the bound "
                             f"{bound:.3e}")


def check_trace(label, fn, want):
    """One replay traced by torch.profiler: its flash kernels counted by
    name against ``want`` (forward, backward). Returns the call's device
    ms."""
    rows, busy = device_rows(fn)
    traced = (sum(r[2] for r in rows if "flash_fwd_kernel" in r[0]),
              sum(r[2] for r in rows if "flash_bwd_" in r[0]))
    log(f"  {label}: one replay traced: {busy:.3f} ms of device time, "
        f"flash launches {traced[0]} forward + {traced[1]} backward by "
        f"kernel name; want {want[0]} + {want[1]}")
    if traced != tuple(want):
        raise AssertionError(f"{label}: flash launches per replay {traced}, "
                             f"want {want}")
    return busy


def turns_logged(label, arms, feeds, unit, start=1):
    """``in_turns`` over ``feeds`` with each arm's median and its ``unit``
    (name, count(feed)) per second printed; returns the medians in ms.
    Both arms are warm here (captured and replayed before), so the
    medians start at round 1."""
    med = in_turns(arms, feeds, start)
    per_call = np.median([unit[1](f) for f in feeds])
    log(f"  {label} in turns ({len(feeds)} rounds, medians of rounds "
        f"{start}-{len(feeds) - 1}): " + ", ".join(
            f"{name} {m:.2f} ms ({per_call / m * 1e3:.1f} {unit[0]}/s)"
            for (name, _), m in zip(arms, med)))
    return med


def capture_training(label, target, program, state, loss_name, feeds, unit,
                     want, io_dir, smi, profile):
    """Phase 11 on one training path: 5 captured steps against 5 eager
    steps (and eager against eager) from the same state, losses and every
    persistable; step 1's FetchHandle read after the last step; a
    load_persistables and then a set_var of every persistable between
    runs; run(iterations=K) against K single runs; one replay traced;
    then the two arms in turns. ``want``: flash launches per step."""
    exe = pt.Executor()
    steps = 0
    stats0 = dict(exe.capture_stats)
    with traced_launches() as counted, deterministic() as nondeterministic:
        arms = {}
        for arm in ("eager", "eager again", "captured"):
            scope = copy_state(state, exe.device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            handles, secs = [], []
            with jit_cache(arm == "captured"):
                for feed in feeds[:CAPTURE_RUNS]:
                    t0 = time.perf_counter()
                    handles += exe.run(target, feed=feed,
                                       fetch_list=[loss_name], scope=scope,
                                       return_numpy=False)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    steps += 1
            arms[arm] = dict(scope=scope, losses=handles, secs=secs,
                             peak=torch.cuda.max_memory_allocated())
        eager, again = arms["eager"], arms["eager again"]
        cap = arms["captured"]
        if (exe.device.type == "cuda"
                and exe.capture_stats["captures"] - stats0["captures"] != 1):
            raise AssertionError(f"{label}: {exe.capture_stats} after the "
                                 "captured arm: want one capture")
        log(f"  {label}: captured arm: warm-up step {cap['secs'][0]:.3f} s, "
            f"capture + first replay {cap['secs'][1]:.3f} s; peak memory "
            f"eager {eager['peak'] / 2 ** 30:.2f} GiB, captured "
            f"{cap['peak'] / 2 ** 30:.2f} GiB [{smi}]")
        # the handles are read now, after the last step: a handle that
        # aliased the graph's output buffer would show the last step's loss
        def losses(arm):
            return [h.device_value() for h in arm["losses"]]

        ref = max(map(distance, losses(again), losses(eager)))
        hold(label, "captured step-1 loss, read after step 4, against eager",
             distance(losses(cap)[1], losses(eager)[1]), ref)
        hold(label, f"captured losses of {CAPTURE_RUNS} steps against eager",
             max(map(distance, losses(cap), losses(eager))), ref)
        log(f"  {label}: losses " + ", ".join(
            f"{float(h):.6f}" for h in eager["losses"]))
        ce, differ = scope_distance(cap["scope"], eager["scope"])
        ee, _ = scope_distance(again["scope"], eager["scope"])
        hold(label, f"captured against eager, {len(state)} persistables "
             f"after {CAPTURE_RUNS} steps ({len(differ)} differ)", ce, ee)

        # a load between runs (in place: the graph stays) and a set_var
        # (a rebinding: the plan drops its graph and captures anew); each
        # restores the initial state, so the next steps repeat steps 0-1
        with pt.scope_guard(copy_state(state, exe.device)):
            pt.io.save_persistables(exe, io_dir, program)
        for how in ("load_persistables", "set_var"):
            after = {}
            for arm in ("eager", "captured"):
                scope = arms[arm]["scope"]
                if how == "set_var":
                    for n, t in state.items():
                        scope.set_var(n, t.clone())
                else:
                    with pt.scope_guard(scope):
                        pt.io.load_persistables(exe, io_dir, program)
                with jit_cache(arm == "captured"):
                    after[arm] = [exe.run(target, feed=f,
                                          fetch_list=[loss_name],
                                          scope=scope, return_numpy=False)[0]
                                  for f in feeds[:2]]
                steps += 2
            got = max(distance(c.device_value(), e.device_value())
                      for c, e in zip(after["captured"], eager["losses"]))
            ref = max(distance(c.device_value(), e.device_value())
                      for c, e in zip(after["eager"], eager["losses"]))
            hold(label, f"captured steps 0-1 again after {how}, against "
                 "eager steps 0-1", got, ref)
            ce, _ = scope_distance(cap["scope"], eager["scope"])
            hold(label, f"captured against eager, persistables after {how} "
                 "and 2 steps", ce, ee)

        # K steps in one run against K single runs
        singles_scope = copy_state(state, exe.device)
        k_scope = copy_state(state, exe.device)
        singles = [exe.run(target, feed=f, fetch_list=[loss_name],
                           scope=singles_scope, return_numpy=False)[0]
                   for f in feeds[:2 * CAPTURE_K]]
        stacked = []
        for j in range(2):
            part = feeds[j * CAPTURE_K:(j + 1) * CAPTURE_K]
            sup = {n: np.stack([f[n] for f in part]) for n in part[0]}
            (h,) = exe.run(target, feed=sup, fetch_list=[loss_name],
                           scope=k_scope, return_numpy=False,
                           iterations=CAPTURE_K)
            if h.shape[0] != CAPTURE_K:
                raise AssertionError(f"{label}: a K-step fetch of shape "
                                     f"{h.shape}")
            stacked += list(h.device_value())
        steps += 4 * CAPTURE_K
        got = max(distance(a, b.device_value().reshape(a.shape))
                  for a, b in zip(stacked, singles))
        hold(label, f"run(iterations={CAPTURE_K}) twice (eager, then "
             f"captured) against {2 * CAPTURE_K} single runs, losses", got,
             0.0)
        kd, _ = scope_distance(k_scope, singles_scope)
        hold(label, f"run(iterations={CAPTURE_K}) against single runs, "
             "persistables", kd, 0.0)
    log(f"  {label}: ops that warned of no deterministic implementation: "
        f"{nondeterministic or 'none'}; K-step runs that fell back to "
        f"single steps: {exe.fuse_fallbacks}")
    if exe.fuse_fallbacks:
        raise AssertionError(f"{label}: {exe.fuse_fallbacks} K-step runs "
                             "fell back to single steps")
    launches = check_launches(f"  {label}, {steps} steps", counted,
                              (steps * want[0], steps * want[1]))

    busy = check_trace(label, lambda: exe.run(
        target, feed=feeds[0], fetch_list=[loss_name], scope=cap["scope"],
        return_numpy=False), want)
    turns = [("eager", lambda f: _eager_step(exe, target, f, loss_name,
                                             eager["scope"])),
             ("captured", lambda f: exe.run(target, feed=f,
                                            fetch_list=[loss_name],
                                            scope=cap["scope"]))]
    med = turns_logged(label, turns, feeds[:4], unit)
    log(f"  {label}: captured step {med[1]:.2f} ms against {busy:.3f} ms of "
        f"device time: the card idle {max(0.0, 1 - busy / med[1]):.1%} of "
        f"it; eager {med[0]:.2f} ms, {med[0] / med[1]:.2f}x [{smi}]")
    if profile:
        _, ebusy = device_rows(lambda: _eager_step(
            exe, target, feeds[0], loss_name, eager["scope"]))
        log(f"  {label}: one eager step {ebusy:.3f} ms of device time: the "
            f"card idle {max(0.0, 1 - ebusy / med[0]):.1%} of it")
    log(f"  {label}: {exe.capture_stats['captures']} captures in "
        f"{exe.capture_stats['seconds']:.2f} s, "
        f"{exe.capture_stats['replays']} replays")
    return launches


def _eager_step(exe, target, feed, loss_name, scope):
    with jit_cache(False):
        return exe.run(target, feed=feed, fetch_list=[loss_name],
                       scope=scope)


def capture_serving(label, pred, requests, unit, want, weight, smi, profile):
    """Phase 11 on one serving path: 5 captured requests against 5 eager
    ones (and eager against eager) through one predictor, every output
    read after the last request; a set_var of ``weight`` between
    requests, and its restore; one replay traced; then both in turns.
    ``want``: flash forward launches per request."""
    exe = pred._exe
    stats0 = dict(exe.capture_stats)
    n = 0

    def serve_all(captured, feeds):
        nonlocal n
        out, secs = [], []
        with jit_cache(captured):
            for feed in feeds:
                t0 = time.perf_counter()
                out.append(pred.run(feed)[0].as_tensor())
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                n += 1
        return out, secs

    with traced_launches() as counted, deterministic() as nondeterministic:
        torch.cuda.reset_peak_memory_stats()
        eager, _ = serve_all(False, requests[:CAPTURE_RUNS])
        eager_peak = torch.cuda.max_memory_allocated()
        again, _ = serve_all(False, requests[:CAPTURE_RUNS])
        torch.cuda.reset_peak_memory_stats()
        cap, secs = serve_all(True, requests[:CAPTURE_RUNS])
        cap_peak = torch.cuda.max_memory_allocated()
        if (exe.device.type == "cuda"
                and exe.capture_stats["captures"] - stats0["captures"] != 1):
            raise AssertionError(f"{label}: {exe.capture_stats}: want one "
                                 "capture")
        log(f"  {label}: captured arm: warm-up request {secs[0]:.3f} s, "
            f"capture + first replay {secs[1]:.3f} s; peak memory eager "
            f"{eager_peak / 2 ** 30:.2f} GiB, captured "
            f"{cap_peak / 2 ** 30:.2f} GiB [{smi}]")
        hold(label, f"captured against eager, {CAPTURE_RUNS} outputs read "
             "after the last request",
             max(distance(c, e) for c, e in zip(cap, eager)),
             max(distance(a, e) for a, e in zip(again, eager)))
        old = pred._scope.find_var(weight)
        pred._scope.set_var(weight, old * 2)
        changed = {arm: serve_all(arm, requests[:2])[0]
                   for arm in (False, True)}
        pred._scope.set_var(weight, old)
        restored = {arm: serve_all(arm, requests[:2])[0]
                    for arm in (False, True)}
        if not all(distance(c, e) for c, e in zip(changed[False], eager[:2])):
            raise AssertionError(f"{label}: the set_var of {weight} did not "
                                 "change the output")
        hold(label, f"captured against eager, 2 requests after a set_var "
             f"of {weight}",
             max(distance(c, e) for c, e in zip(changed[True],
                                                 changed[False])), 0.0)
        hold(label, f"captured 2 requests after {weight} is restored, "
             "against the first eager ones",
             max(distance(c, e) for c, e in zip(restored[True], eager[:2])),
             max(distance(c, e) for c, e in zip(restored[False], eager[:2])))
    log(f"  {label}: ops that warned of no deterministic implementation: "
        f"{nondeterministic or 'none'}")
    launches = check_launches(f"  {label}, {n} requests", counted,
                              (n * want, 0))[0]
    busy = check_trace(label, lambda: pred.run(requests[0]), (want, 0))

    def eager_request(feed):
        with jit_cache(False):
            return pred.run(feed)

    med = turns_logged(label, [("eager", eager_request),
                               ("captured", pred.run)], requests[:4], unit)
    log(f"  {label}: captured request {med[1]:.2f} ms against {busy:.3f} ms "
        f"of device time: the card idle {max(0.0, 1 - busy / med[1]):.1%} "
        f"of it; eager {med[0]:.2f} ms, {med[0] / med[1]:.2f}x [{smi}]")
    if profile:
        _, ebusy = device_rows(lambda: eager_request(requests[0]))
        log(f"  {label}: one eager request {ebusy:.3f} ms of device time: "
            f"the card idle {max(0.0, 1 - ebusy / med[0]):.1%} of it")
    return launches


def capture_rng():
    """A main program with a uniform_random op: 5 captured runs against 5
    eager runs, each arm from a fresh scope with the program's seed, and
    run(iterations=2) twice against 4 single runs: the draws bitwise
    equal, and no two runs' draws alike (the generator advances)."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = SEED
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[1024])
        blk = main.global_block()
        noise = blk.create_var(name="noise", shape=[16, 1024],
                               dtype="float32")
        blk.append_op(type="uniform_random", outputs={"Out": [noise]},
                      attrs={"shape": [16, 1024], "min": -1.0, "max": 1.0,
                             "seed": 0})
        out = pt.layers.elementwise_add(x, noise)
    exe = pt.Executor()
    feeds = [{"x": np.random.RandomState(SEED + i).rand(16, 1024).astype(
        np.float32)} for i in range(CAPTURE_RUNS)]
    draws = {}
    for captured in (False, True):
        scope = pt.Scope()
        with jit_cache(captured):
            draws[captured] = [run_tensors(exe, main, feed=f,
                                           fetch_list=[out, noise],
                                           scope=scope) for f in feeds]
    eager = [d[1] for d in draws[False]]
    if any(torch.equal(eager[i], eager[i + 1])
           for i in range(len(eager) - 1)):
        raise AssertionError("uniform_random drew the same values twice")
    hold("uniform_random program", f"captured against eager, {CAPTURE_RUNS} "
         "runs, output and draws",
         max(distance(c, e) for dc, de in zip(draws[True], draws[False])
             for c, e in zip(dc, de)), 0.0)
    scope = pt.Scope()
    sup = {"x": np.stack([f["x"] for f in feeds[:2]])}
    stacked = []
    for _ in range(2):  # the warm-up, then the captured K-step graph
        stacked += list(run_tensors(exe, main, feed=sup, fetch_list=[noise],
                                    scope=scope, iterations=2)[0])
    hold("uniform_random program", "run(iterations=2) twice (eager, then "
         "captured) against 4 single runs, draws",
         max(distance(a, b) for a, b in zip(stacked, eager[:4])), 0.0)


def last_weight(pred):
    """The last floating-point persistable the predictor's program reads."""
    for op in reversed(pred._program.global_block().desc.ops):
        for n in op.input_arg_names():
            t = pred._scope.find_var(n)
            if t is not None and t.is_floating_point() and t.dim() >= 2:
                return n
    raise AssertionError("the predictor reads no weight")


def release():
    """Free what the last phase held: its plans and graphs (reference
    cycles of programs included) and the allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def capture_paths(model_dir, resnet_dir, smi, profile):
    """Phase 11; returns the flash launches of its paths."""
    paths = {}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_",
                                     dir=_build.BUILD_DIR) as io_dir:
        with unique_name.guard():
            m = transformer.build(attention_impl="unfused", **MODEL)
        m["startup"].random_seed = SEED
        init = pt.Scope()
        pt.Executor().run(m["startup"], scope=init)
        state = {n: init.find_var(n) for n in init.var_names()}
        cfg = m["config"]
        feeds = [train_batch(cfg, TRAIN_BATCH, SEED + 500 + i)
                 for i in range(2 * CAPTURE_K)]
        tokens = ("target tokens", lambda f: int(f["trg_len"].sum()))
        amp_main = mixed_precision.decorate(m["main"].clone())
        for label, program in (("Transformer compiled fp32", m["main"]),
                               ("Transformer compiled AMP", amp_main)):
            target = pt.CompiledProgram(program,
                                        build_strategy=bench_build_strategy())
            paths[label] = capture_training(
                label, target, program, state, m["loss"].name, feeds, tokens,
                (FWD_PER_STEP, BWD_PER_STEP), io_dir, smi, profile)
            del target
            release()
        del m, amp_main, state, init
        release()

        pred = create_paddle_predictor(AnalysisConfig(model_dir).enable_bf16())
        requests = [make_request(cfg, 8, SEED + 600 + i)
                    for i in range(CAPTURE_RUNS)]
        paths["Transformer AnalysisPredictor bf16"] = (capture_serving(
            "Transformer AnalysisPredictor bf16", pred, requests, tokens,
            LAUNCHES_PER_REQUEST, last_weight(pred), smi, profile), 0)
        del pred
        release()

        with unique_name.guard():
            r = resnet.build(dataset="flowers", depth=50,
                             class_dim=RESNET_CLASSES,
                             image_shape=list(RESNET_IMAGE), lr=0.1)
        r["startup"].random_seed = SEED
        init = pt.Scope()
        pt.Executor().run(r["startup"], scope=init)
        state = {n: init.find_var(n) for n in init.var_names()}
        amp_main = mixed_precision.decorate(r["main"].clone())
        label = "ResNet-50 compiled AMP"
        paths[label] = capture_training(
            label, pt.CompiledProgram(amp_main,
                                      build_strategy=bench_build_strategy()),
            amp_main, state, r["loss"].name,
            [resnet_batch(RESNET_BATCH, SEED + 500 + i)
             for i in range(2 * CAPTURE_K)],
            ("images", lambda f: len(f["data"])), (0, 0), io_dir, smi,
            profile)
        del r, amp_main, state, init
        release()

    pred = create_paddle_predictor(AnalysisConfig(resnet_dir).enable_bf16())
    label = "ResNet-50 AnalysisPredictor bf16"
    paths[label] = (capture_serving(
        label, pred, [{"data": resnet_batch(RESNET_BATCH, SEED + 700 + i)[
            "data"]} for i in range(CAPTURE_RUNS)],
        ("images", lambda f: len(f["data"])), 0, last_weight(pred), smi,
        profile), 0)
    del pred
    release()
    capture_rng()
    return paths


# ---------------------------------------------------------------------------
# phase 12: BERT-base pretraining
# ---------------------------------------------------------------------------

# bench_bert's widths (bench.py:1069-1084): vocab 30522, T 128, 20 masked
# slots, 12 layers of 12 heads at d_model 768, d_inner 3072, batch 16
BERT = dict(vocab_size=30522, max_len=128, max_masked=20, n_layer=12,
            n_head=12, d_model=768, d_inner_hid=3072)
BERT_BATCH = 16
BERT_STEPS = 5
BERT_CAPTURE_RUNS = 3
# per train step: each layer's attention and its recompute inside the grad
# op, then the backward's delta, dK/dV and dQ kernels
BERT_FWD_PER_STEP = 2 * BERT["n_layer"]
BERT_BWD_PER_STEP = BERT["n_layer"] * fa.BWD_KERNELS
# arm B's rate: a linear warmup from 1e-5 to 1e-4 over 3 steps, then a
# polynomial decay (power 1) from 1e-4 to 1e-6 over 10 steps
LAMB_LR = dict(start=1e-5, peak=1e-4, end=1e-6, warmup=3, decay_steps=10)
# the fp32 step, card against CPU: the loss within the CPU tests' 1e-5
# relative (tests/test_torch_bert.py); the gradients within phase 6's card
# bounds, 1e-3 relative in L2 (all 157 together) and 1e-2 of each one's
# largest magnitude elementwise and in L2. The CPU tests hold two plain
# attentions against each other; the card runs the 3xTF32 kernels, whose
# backward takes delta from the forward kernel's O, and dSoft = P (dP -
# delta) cancels where a row's dP is near delta (replay_on_cpu's
# docstring), so the small gradients of the upper layers' query and key
# weights move by about 1e-3 in L2 (on an H100: layer11_att_q.w 2.0e-3,
# layer10_att_q.w 1.2e-3). How many gradients also meet the CPU tests'
# 1e-5 of their largest magnitude is printed
BERT_FP32_REPLAY_TOL = {"loss": 1e-5, "grads_l2": 1e-3, "grad_l2": 1e-2,
                        "grad_max": 1e-2}
# the AMP step op by op: tests/test_torch_bert.py's per-op bound (one bf16
# ulp at each output's largest magnitude), but the flash ops at the bf16
# kernels' own bound against their plain version (BWD_TOL), since the
# kernels round P and dSoft to bf16 as operands, and O once, where the
# CPU's plain version rounds O at other points. The backward's outputs are
# held against that share of the sums of the absolute values of the
# products behind them (flash_grad_tops), the forward-error bound of
# their dot products: dSoft = P (dO V^T - rowsum(dO O)) cancels where the
# values share a component, and dQ = scale * dSoft K (dSoft sums to 0 along
# a row) where the keys do, as in the upper layers of a BERT at
# initialisation. On an H100 the last layer's dQ, at most 4.7e-5, was
# 5.2e-5 off (beyond 1e-2 of its largest value, and of scale * |dSoft|
# |K|, 7.1e-4, with dSoft's own cancellation); bf16 operands do that on
# the CPU too (emulated_attention_bwd on emulated_attention's O against
# plain_attention_bwd, keys and values with a shared component: 1.8x the
# largest dQ, 6e-4 of the largest sum of absolute products)
BERT_AMP_OP_REL = {"*": 2.0 ** -7,
                   "flash_attention": BWD_TOL[torch.bfloat16]["grad"],
                   "flash_attention_grad": BWD_TOL[torch.bfloat16]["grad"]}


def flash_grad_tops(ins, attrs):
    """The largest sum of the absolute values of the products behind each
    output of a ``flash_attention_grad`` op, from its CPU inputs in fp32:
    with |dSoft| taken as P (|dO| |V|^T + rowsum(|dO| |O|)), scale *
    |dSoft| |K| (dQ), scale * |dSoft|^T |Q| (dK), P^T |dO| (dV) and
    |dSoft| summed over heads and queries (dKeyBias)."""
    q, k, v, do = (ins[n][0].float() for n in ("Q", "K", "V", "Out@GRAD"))
    kb = ins["KeyBias"][0] if ins.get("KeyBias") else None
    causal, scale = bool(attrs.get("causal", False)), attrs.get("scale", 1.0)
    out, lse = fa.plain_attention(q, k, v, kb, causal, scale)
    s = fa._mask(torch.einsum("bhqd,bhkd->bhqk", q, k) * scale, kb, causal)
    p = torch.exp(s - lse[..., None])
    dsoft = p * (torch.einsum("bhqd,bhkd->bhqk", do.abs(), v.abs())
                 + (do.abs() * out.abs()).sum(-1)[..., None])
    return {"Q@GRAD": scale * torch.einsum(
                "bhqk,bhkd->bhqd", dsoft, k.abs()).max().item(),
            "K@GRAD": scale * torch.einsum(
                "bhqk,bhqd->bhkd", dsoft, q.abs()).max().item(),
            "V@GRAD": torch.einsum("bhqk,bhqd->bhkd", p,
                                   do.abs()).max().item(),
            "KeyBias@GRAD": dsoft.sum(dim=(1, 2)).max().item()}


def bert_batch(cfg, batch, seed):
    """bert.make_fake_batch with each row's length drawn in [T/2, T], so
    the key bias masks keys, and its masked positions inside its length."""
    rng = np.random.RandomState(seed)
    feed = bert.make_fake_batch(batch, cfg, seed=seed)
    t, m = cfg["max_len"], cfg["max_masked"]
    lens = rng.randint(t // 2, t + 1, batch).astype(np.int32)
    feed["seq_len"] = lens
    feed["mask_pos"] = np.stack([
        i * t + rng.choice(n, m, replace=False)
        for i, n in enumerate(lens)]).astype(np.int64)
    return feed


def bert_recipe():
    """Arm B: BERT's forward (``is_train=False``), then LAMB (weight
    decay 0.01) with a global-norm clip of 1.0 and LAMB_LR's rate, with
    API both packages have. Returns the build with the rate's Variable
    under "lr"."""
    m = bert.build(is_train=False, **BERT)
    with pt.program_guard(m["main"], m["startup"]):
        sched = pt.layers.learning_rate_scheduler
        lr = sched.linear_lr_warmup(
            sched.polynomial_decay(LAMB_LR["peak"], LAMB_LR["decay_steps"],
                                   LAMB_LR["end"]),
            LAMB_LR["warmup"], LAMB_LR["start"], LAMB_LR["peak"])
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
        pt.optimizer.LambOptimizer(learning_rate=lr,
                                   weight_decay=0.01).minimize(m["loss"])
    m["lr"] = lr
    return m


def lamb_lr(step):
    """LAMB_LR's rate at run ``step`` (the counter reads 0 at the first
    run), in float64."""
    c = LAMB_LR
    if step < c["warmup"]:
        return c["start"] + (c["peak"] - c["start"]) * step / c["warmup"]
    frac = min(step, c["decay_steps"]) / c["decay_steps"]
    return (c["peak"] - c["end"]) * (1 - frac) + c["end"]


def bert_state(m):
    """The startup's persistables from SEED, on the card."""
    m["startup"].random_seed = SEED
    init = pt.Scope()
    t0 = time.perf_counter()
    pt.Executor().run(m["startup"], scope=init)
    state = {n: init.find_var(n) for n in init.var_names()}
    n_params = sum(state[p.name].numel() for p in m["main"].all_parameters())
    log(f"BERT startup on the card: {time.perf_counter() - t0:.2f} s, "
        f"{len(state)} persistables, {n_params} parameter elements")
    return state


def bert_steps(label, target, state, m, feeds, smi, lr_name=None):
    """BERT_STEPS steps through ``target`` from ``state`` under a trace
    that counts the flash launches (BERT_FWD_PER_STEP + BERT_BWD_PER_STEP
    a step): per step its ms, tokens per second, the loss and its
    masked-LM and next-sentence parts (and the rate, against
    ``lamb_lr``); per arm the warm-up and capture seconds and the peak
    memory. Returns (losses, masked-LM losses, step ms, launches)."""
    exe = pt.Executor()
    scope = copy_state(state, exe.device)
    fetch = [m["loss"].name, m["mlm_loss"].name, m["nsp_loss"].name] + (
        [lr_name] if lr_name else [])
    losses, mlm_losses, step_ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with traced_launches() as counted:
        for i in range(BERT_STEPS):
            feed = feeds[i]
            t0 = time.perf_counter()
            out = run_tensors(exe, target, feed=feed, fetch_list=fetch,
                              scope=scope)
            loss, mlm, nsp = (float(t.reshape(-1)[0].item())
                              for t in out[:3])
            ms = (time.perf_counter() - t0) * 1e3
            tokens = len(feed["src_ids"]) * feed["src_ids"].shape[1]
            what = {0: " (warm-up)", 1: " (capture)"}.get(i, "")
            msg = (f"{label} step {i}: loss {loss:.6f} (masked LM "
                   f"{mlm:.6f}, next sentence {nsp:.6f}), {ms:.1f} ms "
                   f"(traced), {tokens / ms * 1e3:.0f} tokens/s{what}")
            if lr_name:
                lr, want = float(out[3].reshape(-1)[0].item()), lamb_lr(i)
                msg += f", lr {lr:.6e} (closed form {want:.6e})"
                if not abs(lr - want) <= 2e-6 * want:
                    raise AssertionError(f"{label} step {i}: rate {lr} "
                                         f"against the schedule's {want}")
            log(msg)
            if not np.isfinite(loss):
                raise AssertionError(f"{label} step {i}: loss {loss}")
            losses.append(loss)
            mlm_losses.append(mlm)
            step_ms.append(ms)
    peak = torch.cuda.max_memory_allocated()
    launches = check_launches(label, counted,
                              (BERT_STEPS * BERT_FWD_PER_STEP,
                               BERT_STEPS * BERT_BWD_PER_STEP))
    med = float(np.median(step_ms[STEADY:]))
    log(f"{label}: warm-up step {step_ms[0] / 1e3:.3f} s, capture + first "
        f"replay {step_ms[1] / 1e3:.3f} s, median of steps {STEADY}-"
        f"{BERT_STEPS - 1} {med:.2f} ms (traced), peak memory "
        f"{peak / 2 ** 30:.2f} GiB [{smi}]")
    return losses, mlm_losses, step_ms, launches


def bert_capture_bitwise(label, target, state, loss_name, feeds):
    """Captured against eager, BERT_CAPTURE_RUNS runs each from the same
    state under ``torch.use_deterministic_algorithms``: two eager arms
    bitwise equal to each other, and the captured arm (warm-up, capture,
    replay) bitwise equal to them, losses and every persistable; no op
    warned of a missing deterministic implementation."""
    exe = pt.Executor()
    stats0 = dict(exe.capture_stats)
    arms = {}
    with deterministic() as nondeterministic:
        for arm in ("eager", "eager again", "captured"):
            scope = copy_state(state, exe.device)
            with jit_cache(arm == "captured"):
                losses = [run_tensors(exe, target, feed=f,
                                      fetch_list=[loss_name],
                                      scope=scope)[0]
                          for f in feeds[:BERT_CAPTURE_RUNS]]
            arms[arm] = (scope, losses)
    if (exe.device.type == "cuda"
            and exe.capture_stats["captures"] - stats0["captures"] != 1):
        raise AssertionError(f"{label}: {exe.capture_stats}: want one "
                             "capture")
    (es, el), (gs, gl), (cs_, cl) = (arms["eager"], arms["eager again"],
                                     arms["captured"])
    hold(label, "eager again against eager, losses",
         max(map(distance, gl, el)), 0.0)
    hold(label, f"captured against eager, losses of {BERT_CAPTURE_RUNS} "
         "runs", max(map(distance, cl, el)), 0.0)
    ee, _ = scope_distance(gs, es)
    hold(label, f"eager again against eager, {len(state)} persistables",
         ee, 0.0)
    ce, differ = scope_distance(cs_, es)
    hold(label, f"captured against eager, {len(state)} persistables "
         f"({len(differ)} differ)", ce, 0.0)
    log(f"  {label}: losses " + ", ".join(f"{float(t):.6f}" for t in el)
        + f"; ops that warned of no deterministic implementation: "
        f"{nondeterministic or 'none'}")
    if nondeterministic:
        raise AssertionError(f"{label}: ops without a deterministic "
                             f"implementation: {nondeterministic}")


def bert_replay(label, m, target, state, amp):
    """A batch-2 step of ``target`` from ``state`` replayed on the CPU.
    fp32, end to end on the card and through Executor(CPUPlace()): the
    loss and every parameter's gradient at BERT_FP32_REPLAY_TOL. AMP, op
    by op on the card's rewritten list (``replay_each_op`` at
    BERT_AMP_OP_REL)."""
    feed = bert_batch(m["config"], 2, SEED + 50)
    exe = pt.Executor()
    if amp:
        replay_each_op(exe.lowered_ops(target, [m["loss"].name]),
                       m["main"].global_block(),
                       copy_state(state, torch.device("cpu")), feed,
                       exe.device, True, f"{label}: AMP step at batch 2",
                       rel=BERT_AMP_OP_REL,
                       tops={"flash_attention_grad": flash_grad_tops})
        return
    params = [p.name for p in m["main"].all_parameters()]
    fetch = [m["loss"].name] + [n + "@GRAD" for n in params]
    out = {}
    t0 = time.perf_counter()
    for where, ex in (("card", exe), ("cpu", pt.Executor(pt.CPUPlace()))):
        res = run_tensors(ex, target, feed=feed, fetch_list=fetch,
                          scope=copy_state(state, ex.device))
        out[where] = [t.cpu().float() for t in res]
    card, cpu = out["card"], out["cpu"]
    loss_err = abs(card[0].item() - cpu[0].item()) / abs(cpu[0].item())
    tol = BERT_FP32_REPLAY_TOL
    rows = []  # (L2, largest error / largest magnitude, name)
    for name, g, c in zip(params, card[1:], cpu[1:]):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: {name} gradient not finite")
        rows.append((_rel_l2([g], [c]),
                     (g - c).abs().max().item() / c.abs().max().item(), name))
    together = _rel_l2(card[1:], cpu[1:])
    tight = sum(r[1] <= 1e-5 for r in rows)
    log(f"{label}: fp32 step at batch 2 replayed on the CPU "
        f"({time.perf_counter() - t0:.1f} s for both): loss "
        f"{card[0].item():.7f} on the card, {cpu[0].item():.7f} on the CPU "
        f"({loss_err:.3e} relative, bound {tol['loss']}); the "
        f"{len(params)} gradients together {together:.3e} relative in L2 "
        f"(bound {tol['grads_l2']}), each at most "
        f"{max(r[0] for r in rows):.3e} in L2 (bound {tol['grad_l2']}) and "
        f"{max(r[1] for r in rows):.3e} of its largest magnitude (bound "
        f"{tol['grad_max']}); {tight} of {len(params)} within the CPU "
        f"tests' 1e-5 of their largest magnitude; largest L2: " + ", ".join(
            f"{n} {l2:.2e}" for l2, _, n in sorted(rows, reverse=True)[:5]))
    if not (loss_err <= tol["loss"] and together <= tol["grads_l2"]
            and all(l2 <= tol["grad_l2"] and mx <= tol["grad_max"]
                    for l2, mx, _ in rows)):
        raise AssertionError(f"{label}: the card's fp32 step disagrees with "
                             "the CPU's")


def bert_paths(smi, profile):
    """Phase 12. Arm A (bench_bert: Adam lr 1e-4, epsilon 1e-6) fp32 and
    AMP and arm B (the LAMB recipe, AMP), each through CompiledProgram
    under bench.py's BuildStrategy. Returns their flash launches by
    path."""
    paths = {}
    with unique_name.guard():
        a = bert.build(**BERT)
    cfg, loss_name = a["config"], a["loss"].name
    state = bert_state(a)
    amp_main = mixed_precision.decorate(a["main"].clone())
    targets = {label: pt.CompiledProgram(
        program, build_strategy=bench_build_strategy())
        for label, program in (("fp32", a["main"]), ("AMP", amp_main))}
    ops = pt.Executor().lowered_ops(targets["AMP"], [loss_name])
    types = [o.type for o in ops]
    log(f"arm A's rewritten AMP step: {len(ops)} ops, "
        f"{types.count('flash_attention')} flash_attention, "
        f"{types.count('flash_attention_grad')} flash_attention_grad, "
        f"{types.count('fused_adam')} fused_adam, {types.count('gather')} "
        f"gather, {types.count('gelu')} gelu")
    if (types.count("flash_attention") != BERT["n_layer"]
            or types.count("flash_attention_grad") != BERT["n_layer"]
            or "fused_adam" not in types or "adam" in types):
        raise AssertionError("arm A's rewritten step is not the expected one")
    # one batch for every step of arm A, so the fall of the loss is the
    # optimizer's, not the data's. The gate is the masked-LM loss falling
    # at every step: the next-sentence head, on random labels, overshoots
    # at Adam's first step (about 0.8 -> 5.2 at batch 16, the same on the
    # card and through Executor(CPUPlace()) from the same state), so the
    # total rises once before it falls
    fixed = [bert_batch(cfg, BERT_BATCH, SEED + 800)] * BERT_STEPS
    fp32_losses, fp32_mlm, _, paths["bert_train_fp32"] = bert_steps(
        "BERT arm A fp32", targets["fp32"], state, a, fixed, smi)
    if not all(b < a_ for a_, b in zip(fp32_mlm, fp32_mlm[1:])):
        raise AssertionError(f"arm A fp32 masked-LM losses do not fall: "
                             f"{fp32_mlm}")
    amp_losses, _, _, paths["bert_train_amp"] = bert_steps(
        "BERT arm A AMP", targets["AMP"], state, a, fixed, smi)
    rel = max(abs(x - y) / abs(y) for x, y in zip(amp_losses, fp32_losses))
    log(f"arm A: the AMP losses within {rel:.3e} relative of fp32's")
    release()

    with unique_name.guard():
        b = bert_recipe()
    b_state = bert_state(b)
    b_amp = mixed_precision.decorate(b["main"].clone())
    b_target = pt.CompiledProgram(b_amp, build_strategy=bench_build_strategy())
    b_fp32 = pt.CompiledProgram(b["main"],
                                build_strategy=bench_build_strategy())
    b_feeds = [bert_batch(cfg, BERT_BATCH, SEED + 850 + i)
               for i in range(BERT_STEPS)]
    _, _, _, paths["bert_lamb_amp"] = bert_steps(
        "BERT arm B (LAMB, clip, schedule) AMP", b_target, b_state, b,
        b_feeds, smi, lr_name=b["lr"].name)
    release()

    phase("BERT: captured against eager (FLAGS.jit_cache = False), bitwise")
    feeds = [bert_batch(cfg, BERT_BATCH, SEED + 900 + i)
             for i in range(BERT_CAPTURE_RUNS)]
    bert_capture_bitwise("BERT arm A AMP", targets["AMP"], state, loss_name,
                         feeds)
    release()
    bert_capture_bitwise("BERT arm B AMP", b_target, b_state,
                         b["loss"].name, feeds)
    release()

    phase("BERT: batch-2 steps replayed on the CPU")
    bert_replay("BERT arm A", a, targets["fp32"], state, amp=False)
    bert_replay("BERT arm A", a, targets["AMP"], state, amp=True)
    bert_replay("BERT arm B", b, b_fp32, b_state, amp=False)
    bert_replay("BERT arm B", b, b_target, b_state, amp=True)
    release()

    phase("BERT: captured and eager steps in turns (untraced), device time")
    exe = pt.Executor()
    arms = [("arm A fp32", targets["fp32"], loss_name, state),
            ("arm A AMP", targets["AMP"], loss_name, state),
            ("arm B AMP", b_target, b["loss"].name, b_state)]
    scopes = {(label, how): copy_state(st, exe.device)
              for label, _, _, st in arms for how in ("captured", "eager")}

    def arm(label, how, target, name):
        def step(feed):
            with jit_cache(how == "captured"):
                (loss,) = run_tensors(exe, target, feed=feed,
                                      fetch_list=[name],
                                      scope=scopes[label, how])
            if not bool(torch.isfinite(loss).all()):
                raise AssertionError(f"{label} {how}: loss {loss}")
        return f"{label} {how}", step
    turn_feeds = [bert_batch(cfg, BERT_BATCH, SEED + 950 + r)
                  for r in range(6)]
    med = in_turns([arm(lb, how, t, n) for lb, t, n, _ in arms
                    for how in ("captured", "eager")], turn_feeds)
    tokens = BERT_BATCH * BERT["max_len"]
    for i, (label, target, name, _) in enumerate(arms):
        ms, eager_ms = med[2 * i], med[2 * i + 1]
        run = lambda: exe.run(target, feed=turn_feeds[0], fetch_list=[name],
                              scope=scopes[label, "captured"])
        busy = check_trace(f"BERT {label}", run,
                           (BERT_FWD_PER_STEP, BERT_BWD_PER_STEP))
        log(f"BERT {label}: captured step {ms:.2f} ms, eager {eager_ms:.2f} "
            f"ms (medians of rounds {STEADY}-5 in turns), {tokens / ms * 1e3:.0f}"
            f" and {tokens / eager_ms * 1e3:.0f} tokens/s; {busy:.3f} ms of "
            f"device time: the card idle {max(0.0, 1 - busy / ms):.1%} of a "
            f"captured step [{smi}]")
        if profile:
            rows, _ = device_rows(run)
            for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
                log(f"  {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% "
                    f"x{count:<5} {key[:90]}")
    return paths


# ---------------------------------------------------------------------------
# phase 13: the serving front
# ---------------------------------------------------------------------------

# bench_infer_serving's defaults (bench.py:1354-1370): the bucket ladder,
# the coalescer's batch and window, 8 clients of request sizes 1, 3, 5, 8
FRONT_BUCKETS = (4, 8, 16, 32)
FRONT_MAX_BATCH = 32
FRONT_TIMEOUT_US = 1000
FRONT_CLIENTS = 8
FRONT_SIZES = (1, 3, 5, 8)
FRONT_REQUESTS = 256   # per window
FRONT_WINDOWS = 3
FRONT_CHECK = 64       # requests of the traced pass after the warm-up
# a coalesced request against the plain predictor's run of it alone: each
# bf16 run lies within BF16_SERVE_REL of the request's largest |logit| from
# the fp32 logits (phase 8's gate), so two bf16 runs of one request lie
# within twice that of each other, whatever tiles cuBLAS picks at each M
FRONT_REL = 2 * BF16_SERVE_REL
RESNET_FRONT_BUCKETS = (32, 64, 128)
RESNET_PAGEABLE_MS = 23.69  # phase 11's captured bf16 request (PR 9, call 5)


def plan_runs(pred):
    """(plans, runs) of the executor under a predictor and its serving
    wrappers: one plan per feed signature, one run per device call."""
    base = pred
    while not hasattr(base, "_exe"):
        base = getattr(base, "_pred", None) or base._base
    plans = base._program.__dict__.get("_exec_cache", {})
    return len(plans), sum(p.runs for p in plans.values()), base._exe


def run_clients(call, requests, check=None):
    """``requests`` through ``call(feed)`` from FRONT_CLIENTS threads, each
    taking the next request in turn. Returns (outputs, latencies in ms,
    wall seconds). A latency runs from the call to the output computed on
    the card (the client waits for its stream); ``check(i, out)`` runs
    after, off the clock, and its result is kept in place of the output.
    Every client waits for the whole card (the front's copy stream too),
    so a latency may hold other clients' work: both paths alike."""
    outs, lat, errs = [None] * len(requests), [None] * len(requests), []
    it, lock = iter(range(len(requests))), threading.Lock()
    barrier = threading.Barrier(FRONT_CLIENTS)

    def client():
        barrier.wait()
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            try:
                t0 = time.perf_counter()
                out = call(requests[i])[0].as_tensor()
                torch.cuda.synchronize()
                lat[i] = (time.perf_counter() - t0) * 1e3
                outs[i] = check(i, out) if check else out
            except BaseException as e:  # noqa: BLE001 -- raised below
                errs.append(e)
                return

    threads = [threading.Thread(target=client, name=f"client{c}")
               for c in range(FRONT_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a serving client hung")
    if errs:
        raise errs[0]
    return outs, lat, wall


def check_logits(label, feed, out, cfg):
    want = [len(feed["src_word"]), cfg["max_len"], cfg["tgt_vocab"]]
    if list(out.shape) != want or out.dtype != torch.bfloat16:
        raise AssertionError(f"{label}: logits {list(out.shape)} "
                             f"{out.dtype}, want {want} bfloat16")
    return torch.isfinite(out).all()


def agree_alone(label, front, plain, requests, outs, cfg):
    """Each coalesced request's logits against the plain predictor's run
    of that request alone, within FRONT_REL of its largest |logit|;
    returns the largest relative distance."""
    worst = 0.0
    for feed, got in zip(requests, outs):
        if not bool(check_logits(label, feed, got, cfg)):
            raise AssertionError(f"{label}: logits not finite")
        want = plain.run(feed)[0].as_tensor()
        d = (got.float() - want.float()).abs().max().item()
        rel = d / want.float().abs().max().item()
        worst = max(worst, rel)
        if not rel <= FRONT_REL:
            raise AssertionError(f"{label}: a coalesced request of "
                                 f"{len(feed['src_word'])} rows is {rel:.3e} "
                                 f"of its largest |logit| from its run "
                                 f"alone (bound {FRONT_REL:.3e})")
    return worst


def pad_rows(feed, rows):
    """The zero-padded bucket feed the front builds for ``feed``."""
    return {n: np.concatenate([v, np.zeros((rows - len(v),) + v.shape[1:],
                                           v.dtype)])
            for n, v in feed.items()}


def transformer_front(model_dir, cfg, smi):
    """Phase 13 (a). Returns the path's traced flash forward launches."""
    base = AnalysisConfig(model_dir).enable_bf16()
    front = create_paddle_predictor(
        base.enable_shape_bucketing(batch_buckets=FRONT_BUCKETS)
        .enable_request_coalescing(max_batch_size=FRONT_MAX_BATCH,
                                   batch_timeout_us=FRONT_TIMEOUT_US))
    plain = create_paddle_predictor(AnalysisConfig(model_dir).enable_bf16())
    try:
        requests = [make_request(cfg, FRONT_SIZES[i % len(FRONT_SIZES)],
                                 SEED + 1300 + i)
                    for i in range(FRONT_CHECK + FRONT_WINDOWS
                                   * FRONT_REQUESTS)]
        check = requests[:FRONT_CHECK]
        with traced_launches() as counted:
            t0 = time.perf_counter()
            took = front.warmup()
            warm_s = time.perf_counter() - t0
            plans0, runs0, exe = plan_runs(front)
            stats0 = dict(exe.capture_stats)
            outs, _, _ = run_clients(front.run, check)
            plans1, runs1, _ = plan_runs(front)
        health = front.health()
        log(f"warm-up of {len(took)} buckets on 4 threads: {warm_s:.2f} s "
            f"wall, per bucket " + ", ".join(
                f"{k} {v:.3f} s" for k, v in sorted(took.items())))
        log(f"after warm-up: {plans0} plans, {stats0['captures']} captures")
        # one plan per bucket, captured by the warm-up (the CPU
        # rehearsal captures nothing)
        want_caps = len(FRONT_BUCKETS) if exe.device.type == "cuda" else 0
        if (health["degraded_buckets"] or not health["warmup_complete"]
                or sorted(health["warm_buckets"]) != sorted(
                    f"b{b}" for b in FRONT_BUCKETS)
                or plans0 != len(FRONT_BUCKETS)
                or stats0["captures"] != want_caps):
            raise AssertionError(f"warm-up incomplete: {health}, {plans0} "
                                 f"plans, {stats0}")
        calls = runs1 - runs0
        launches = check_launches(
            f"serving front, warm-up + {FRONT_CHECK} coalesced requests "
            f"({calls} device calls after the warm-up's {runs0} runs)",
            counted, (LAUNCHES_PER_REQUEST * runs1, 0), "bfloat16")[0]
        worst = agree_alone("traced pass", front, plain, check, outs, cfg)
        del outs

        # the naive path: the plain predictor's plans warm (and captured)
        for feed in requests[:2 * len(FRONT_SIZES)]:
            plain.run(feed)
        stats_plain = dict(plain._exe.capture_stats)
        rows = {"front": [], "naive": []}
        for w in range(FRONT_WINDOWS):
            window = requests[FRONT_CHECK + w * FRONT_REQUESTS:
                              FRONT_CHECK + (w + 1) * FRONT_REQUESTS]
            n_rows = sum(len(f["src_word"]) for f in window)
            _, r0, _ = plan_runs(front)
            outs, lat, wall = run_clients(front.run, window)
            _, r1, _ = plan_runs(front)
            rows["front"].append((wall, lat, r1 - r0))
            log(f"window {w} coalesced: {FRONT_REQUESTS} requests "
                f"({n_rows} rows) in {wall:.3f} s, "
                f"{FRONT_REQUESTS / wall:.1f} requests/s, p50 "
                f"{np.percentile(lat, 50):.2f} ms, p99 "
                f"{np.percentile(lat, 99):.2f} ms; {r1 - r0} device calls, "
                f"{n_rows / (r1 - r0):.2f} rows per call [{smi}]")
            worst = max(worst, agree_alone(f"window {w}", front, plain,
                                           window, outs, cfg))
            del outs
            flags, lat, wall = run_clients(
                plain.run, window,
                check=lambda i, out: check_logits("naive", window[i], out,
                                                  cfg))
            if not all(bool(f) for f in flags):
                raise AssertionError("naive path: logits not finite")
            rows["naive"].append((wall, lat, FRONT_REQUESTS))
            log(f"window {w} naive (plain predictor, {FRONT_CLIENTS} "
                f"threads): {wall:.3f} s, {FRONT_REQUESTS / wall:.1f} "
                f"requests/s, p50 {np.percentile(lat, 50):.2f} ms, p99 "
                f"{np.percentile(lat, 99):.2f} ms [{smi}]")
        for path, runs in rows.items():
            lat = np.concatenate([r[1] for r in runs])
            n = FRONT_WINDOWS * FRONT_REQUESTS
            wall = sum(r[0] for r in runs)
            log(f"{path}: {n} requests over {FRONT_WINDOWS} windows, "
                f"{n / wall:.1f} requests/s, p50 "
                f"{np.percentile(lat, 50):.2f} ms, p99 "
                f"{np.percentile(lat, 99):.2f} ms, "
                f"{sum(r[2] for r in runs)} device calls [{smi}]")
        log(f"every coalesced request ({FRONT_CHECK} + {FRONT_WINDOWS} x "
            f"{FRONT_REQUESTS}) finite, of its shape, and at most "
            f"{worst:.3e} of its largest |logit| from its run alone (bound "
            f"{FRONT_REL:.3e})")
        plans2, _, _ = plan_runs(front)
        new_caps = exe.capture_stats["captures"] - stats0["captures"]
        log(f"after all traffic: {plans2} plans, {new_caps} captures after "
            f"the warm-up; the plain predictor's captures in its windows "
            f"{plain._exe.capture_stats['captures'] - stats_plain['captures']}")
        health = front.health()
        log(f"health(): {json.dumps(health, sort_keys=True)}")
        if new_caps or plans2 != plans0 or health["degraded_buckets"]:
            raise AssertionError("the front made a plan or a capture after "
                                 "its warm-up, or degraded a bucket")

        # sequential, under the deterministic mode: bitwise the plain
        # predictor's run of the same zero-padded bucket feed
        with deterministic() as nondeterministic:
            for n in FRONT_SIZES + (FRONT_BUCKETS[-1],):
                feed = make_request(cfg, n, SEED + 1900 + n)
                got = front._pred.run(feed)[0].as_tensor()
                b = next(b for b in FRONT_BUCKETS if b >= n)
                for k in range(2):  # eager and captured, if new
                    want = plain.run(pad_rows(feed, b))[0].as_tensor()[:n]
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"sequential BucketedPredictor.run at {n} rows "
                            f"is {distance(got, want):.3e} from the plain "
                            f"predictor's run of its bucket-{b} feed")
        log(f"sequential BucketedPredictor.run at {FRONT_SIZES + (32,)} "
            f"rows: bitwise the plain predictor's run of each zero-padded "
            f"bucket feed (deterministic mode; ops that warned: "
            f"{nondeterministic or 'none'})")

        # C3: 8 threads on one clone of the plain predictor
        twin = plain.clone()
        c3 = requests[:4 * FRONT_CLIENTS]
        serial = [plain.run(f)[0].as_tensor() for f in c3]
        outs, _, _ = run_clients(twin.run, c3)
        bad = [i for i, (a, b) in enumerate(zip(outs, serial))
               if not torch.equal(a, b)]
        log(f"C3: {len(c3)} requests on {FRONT_CLIENTS} threads through one "
            f"clone of the plain predictor: {len(c3) - len(bad)} bitwise "
            f"their serial runs")
        if bad:
            raise AssertionError(f"C3: requests {bad} differ from their "
                                 "serial runs")
    finally:
        front.shutdown()
    return launches


def resnet_front(resnet_dir, smi):
    """Phase 13 (b): ResNet-50 bf16 through BucketedPredictor at batch
    128, its pinned, double-buffered feed against the plain predictor's
    pageable one, in turns; under the deterministic mode, so both arms run
    the same convolution algorithms."""
    with deterministic():
        front = create_paddle_predictor(
            AnalysisConfig(resnet_dir).enable_bf16()
            .enable_shape_bucketing(batch_buckets=RESNET_FRONT_BUCKETS))
        plain = create_paddle_predictor(
            AnalysisConfig(resnet_dir).enable_bf16())
        fa.launches = fa.bwd_launches = 0
        took = front.warmup()
        plans0, _, exe = plan_runs(front)
        caps0 = exe.capture_stats["captures"]
        feeds = [{"data": resnet_batch(RESNET_BATCH, SEED + 1400 + i)["data"]}
                 for i in range(6)]
        for feed in feeds[:2]:  # the plain plan's warm-up and capture
            plain.run(feed)
        for i, feed in enumerate(feeds):
            got = resnet_serve(front, feed)[0]
            want = resnet_serve(plain, feed)[0]
            if not torch.equal(got, want):
                raise AssertionError(
                    f"ResNet-50 front at batch {RESNET_BATCH} (an exact "
                    f"bucket): request {i} {distance(got, want):.3e} from "
                    "the plain bf16 AnalysisPredictor")
        med = in_turns([("pinned", front.run), ("pageable", plain.run)],
                       feeds, start=1)
        plans1, _, _ = plan_runs(front)
    if fa.launches or fa.bwd_launches:
        raise AssertionError("flash launches on ResNet-50 serving")
    if (plans1 != plans0 or exe.capture_stats["captures"] != caps0
            or front.health()["degraded_buckets"]):
        raise AssertionError(f"ResNet-50 front: {front.health()}, plans "
                             f"{plans0} -> {plans1}")
    log(f"ResNet-50 front: warm-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in sorted(took.items()))
        + f"; {len(feeds)} batch-{RESNET_BATCH} requests bitwise the plain "
        "bf16 AnalysisPredictor's (no pad rows at an exact bucket)")
    log(f"ResNet-50 bf16 request at batch {RESNET_BATCH}, captured, in turns "
        f"(medians of rounds 1-5): pinned double-buffered feed {med[0]:.2f} "
        f"ms ({RESNET_BATCH / med[0] * 1e3:.1f} images/s), pageable feed "
        f"{med[1]:.2f} ms ({RESNET_BATCH / med[1] * 1e3:.1f} images/s); "
        f"phase 11 measured the pageable one at {RESNET_PAGEABLE_MS} ms "
        f"(PR 9, call 5) [{smi}]")


def c1_on_the_card():
    """Phase 13 (c), C1: ROADMAP C1's probe (matmul, square and
    elementwise_sub that do not form the FM pattern) served through
    AnalysisPredictor on the card, against a CPU AnalysisPredictor."""
    from paddle_tpu_torch.layer_helper import LayerHelper, ParamAttr
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[512], dtype="float32")
        w = LayerHelper("probe").create_parameter(
            ParamAttr(name="probe_w"), [512, 512], "float32")
        xw = pt.layers.matmul(x, w)
        out = pt.layers.elementwise_sub(pt.layers.square(xw), xw)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_c1_",
                                     dir=_build.BUILD_DIR) as d:
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            pt.io.save_inference_model(d, ["x"], [out], exe,
                                       main_program=main)
        feed = {"x": np.random.RandomState(SEED).randn(64, 512).astype(
            np.float32)}
        card = create_paddle_predictor(AnalysisConfig(d))
        cpu = create_paddle_predictor(AnalysisConfig(d, use_gpu=False))
        got = card.run(feed)[0].as_tensor().cpu()
        want = cpu.run(feed)[0].as_tensor()
    types = [o.type for o in card._program.global_block().desc.ops]
    rel = (got - want).abs().max().item() / want.abs().max().item()
    log(f"C1: the probe {types} served by AnalysisPredictor on the card, "
        f"{rel:.3e} of its largest value from a CPU AnalysisPredictor")
    if not rel <= 1e-5:
        raise AssertionError("C1: the card's probe disagrees with the CPU's")


def front_paths(model_dir, resnet_dir, cfg, smi):
    """Phase 13; returns its paths' flash launches."""
    paths = {"Transformer serving front bf16": (
        transformer_front(model_dir, cfg, smi), 0)}
    release()
    resnet_front(resnet_dir, smi)
    paths["ResNet-50 serving front bf16"] = (0, 0)
    release()
    c1_on_the_card()
    return paths


def resnet_paths(model_dir, smi, profile):
    """Phases 9-10; returns their flash launches by path."""
    phase("ResNet-50 training through CompiledProgram (bench "
          "BuildStrategy, batch 128, 224x224)")
    paths = {"resnet50_compiled_training": resnet_training_path(smi,
                                                                profile)}
    release()
    phase("ResNet-50 serving: NativePredictor and AnalysisPredictor "
          "(bf16), batch 128")
    paths["resnet50_serving"] = (
        resnet_serving_path(model_dir, smi, profile), 0)
    release()
    return paths


# ---------------------------------------------------------------------------
# phase 14: generation
# ---------------------------------------------------------------------------

# build_lm at bench_transformer's widths (the model phases 5-13 train and
# serve) with the vocabulary and positions of its bench config
GEN_LM = dict(vocab=32000, n_layer=6, n_head=8, d_model=512,
              d_inner_hid=2048, max_positions=256, eos_id=1)
GEN_ENGINE = dict(prompt_buckets=(32, 64, 128),
                  new_token_buckets=(32, 64, 128),
                  slot_buckets=(1, 2, 4, 8, 16), top_k_max=64)
GEN_LENS = (24, 56, 88, 120, 40, 104, 32, 72)
GEN_REQUESTS = 32
GEN_SHARED = 64      # the system prompt every other request opens with
GEN_NEW = 64
GEN_CAP = 128 + 64   # the top prompt bucket + GEN_NEW's bucket
GEN_CHUNK = 32       # steps per decode_chunk in the slot-level checks
# a cached decode step and the re-prefill run products of other shapes
# (M = slots against M = the prompt bucket), so their fp32 logits differ
# in the last bits: a greedy token may flip only where the reference's
# top-1 minus top-2 logit is under this
GEN_TIE = 1e-3
# the card's first decode logits against a CPU engine's, as a share of
# the largest |logit| (fp32 products of other blockings on both sides)
GEN_CPU_REL = 1e-4
GEN_SAMPLING = dict(temperature=0.8, top_k=40)


def gen_prompts(vocab, seed, n=GEN_REQUESTS):
    """The phase's traffic: ``n`` prompts of lengths cycling GEN_LENS;
    every other prompt opens with the same GEN_SHARED-token system prompt
    (at most length - 1 of it), as bench_infer_generate shares its
    prefix."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(2, vocab, (GEN_LENS[i % len(GEN_LENS)],)).astype(
        np.int64) for i in range(n)]
    sys_tokens = rng.randint(2, vocab, (GEN_SHARED,)).astype(np.int64)
    for p in prompts[::2]:
        k = min(GEN_SHARED, len(p) - 1)
        p[:k] = sys_tokens[:k]
    return prompts


def gen_engine(spec, paged, prefix, place=None):
    """A DecodeEngine of phase 14 on its own scope (the startup's fixed
    seed makes every engine's weights the same)."""
    old = FLAGS.generation_paged, FLAGS.generation_prefix_cache
    FLAGS.generation_paged, FLAGS.generation_prefix_cache = paged, prefix
    try:
        return DecodeEngine(spec, place=place, scope=pt.Scope(),
                            **GEN_ENGINE).initialize()
    finally:
        FLAGS.generation_paged, FLAGS.generation_prefix_cache = old


def gen_counts(e):
    """What warm traffic must not add to: prefill plans and their captures,
    decode plans and captures, ingest keys, carries."""
    progs = list(e._prefill_progs.values()) + list(e._prefix_progs.values())
    return {"plans": sum(len(p.__dict__.get("_exec_cache", {}))
                         for p, _ in progs),
            "prefill_captures": e._exe.capture_stats["captures"],
            **{k: e.stats[k] for k in ("decode_builds", "decode_captures",
                                       "ingest_builds", "carries")}}


def near_ties(label, outs, ref, gaps):
    """Each request's tokens against the reference's up to the first step
    where they differ, which must be a near-tie of the reference
    (GEN_TIE). Returns the requests that diverged."""
    diverged = 0
    for i, (got, want) in enumerate(zip(outs, ref)):
        got, want = list(got), list(want)
        t = next((t for t in range(min(len(got), len(want)))
                  if got[t] != want[t]), None)
        if t is None:
            if len(got) != len(want):
                raise AssertionError(f"{label}: request {i}: {len(got)} "
                                     f"tokens, the reference {len(want)}")
            continue
        if not gaps[i][t] < GEN_TIE:
            raise AssertionError(
                f"{label}: request {i} step {t}: token {got[t]} against the "
                f"reference's {want[t]}, whose top-2 gap {gaps[i][t]:.3e} is "
                f"not under {GEN_TIE}")
        diverged += 1
    log(f"  {label}: {len(outs)} requests' greedy tokens equal the "
        f"re-prefill reference's; {diverged} diverged at a near-tie (top-2 "
        f"gap under {GEN_TIE})")
    return diverged


def timed_generate(e, prompts):
    """(outputs, seconds) of one ``generate`` of the traffic."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = e.generate(prompts, GEN_NEW)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def seat(e, prompts, sampling=None, slots=16, at=None):
    """A (slots, GEN_CAP) table with ``prompts`` admitted (in slots ``at``,
    by default 0..n-1)."""
    st = e.alloc_state(slots, GEN_CAP)
    for j, p in enumerate(prompts):
        e.admit(st, j if at is None else at[j], p, GEN_NEW,
                (sampling or [SamplingParams()] * len(prompts))[j])
    return st


def chunks(e, st, n):
    """``n`` decode chunks of GEN_CHUNK steps: tokens and done flags."""
    got = [e.decode_chunk(st, GEN_CHUNK) for _ in range(n)]
    return (np.concatenate([t for t, _ in got]),
            np.concatenate([d for _, d in got]))


def d2h_copies(fn):
    """(count, bytes) of the device-to-host copies in a profiler trace of
    one call of fn."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json", dir=_build.BUILD_DIR) \
            as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name)).get("traceEvents", [])
    copies = [ev for ev in events if "Memcpy DtoH" in str(ev.get("name"))]
    return len(copies), sum(int(ev.get("args", {}).get("bytes", 0))
                            for ev in copies)


def gen_sampling(e, prompts):
    """Gate (e): a sampled request's tokens in slot 0 alone, in slot 5
    among 15 neighbours (sampled with other seeds, and greedy), and in
    slot 5 re-admitted after another request left it mid-decode: all the
    same."""
    req = prompts[3]
    sp = SamplingParams(seed=SEED, **GEN_SAMPLING)

    def tokens_of(st, slot):
        toks, dones = chunks(e, st, 2)
        e.free_state(st)
        return collect_tokens(toks[:, slot], dones[:, slot], GEN_NEW).tolist()

    solo = tokens_of(seat(e, [req], [sp]), 0)
    others = [p for i, p in enumerate(prompts) if i != 3][:15]
    samp = [SamplingParams(seed=SEED + 1 + i, **GEN_SAMPLING) if i % 2
            else SamplingParams() for i in range(15)]
    at = [i for i in range(16) if i != 5]
    st = seat(e, others + [req], samp + [sp], at=at + [5])
    crowd = tokens_of(st, 5)
    st = seat(e, others + [prompts[5]], samp + [SamplingParams(
        seed=SEED + 99, **GEN_SAMPLING)], at=at + [5])
    e.decode_chunk(st, GEN_CHUNK)
    e.release_slot(st, 5)
    e.admit(st, 5, req, GEN_NEW, sp)
    rejoined = tokens_of(st, 5)
    greedy = e.generate([req], GEN_NEW)[0].tolist()
    differ = sum(a != b for a, b in zip(solo, greedy))
    log(f"  (e) sampled (T {GEN_SAMPLING['temperature']}, top-k "
        f"{GEN_SAMPLING['top_k']}, seed {SEED}): {len(solo)} tokens alone in "
        f"slot 0, {len(crowd)} in slot 5 among 15 neighbours, {len(rejoined)} "
        f"re-admitted to slot 5 mid-decode; {differ} "
        f"of {min(len(solo), len(greedy))} differ from the greedy tokens")
    if not solo == crowd == rejoined:
        raise AssertionError(f"(e) sampled tokens depend on the slot or the "
                             f"neighbours: {solo[:8]} / {crowd[:8]} / "
                             f"{rejoined[:8]}")


def gen_cpu_replay(spec_cpu, e, prompt, ref, gap):
    """Gate (f): one batch-1 request on a CPU DecodeEngine from the card
    engine's weights: greedy tokens under the near-tie rule, and the
    first decode step's logits within GEN_CPU_REL of the card's."""
    cpu = gen_engine(spec_cpu, paged=True, prefix=True,
                     place=pt.CPUPlace())
    names = [v.name for v in spec_cpu.startup.list_vars() if v.persistable]
    pt.io.set_params_from_numpy(
        cpu.scope, {n: e.scope.find_var(n).cpu().numpy() for n in names},
        "cpu", program=spec_cpu.startup)
    got = cpu.generate([prompt], GEN_NEW)[0].tolist()
    near_ties("(f) CPU DecodeEngine, batch 1", [got], [ref], [gap])
    logits = []
    for eng in (e, cpu):
        st = seat(eng, [prompt], slots=1)
        eng.decode_chunk(st, 1)
        logits.append(st.logits.detach().cpu().double())
        eng.free_state(st)
    rel = ((logits[0] - logits[1]).abs().max()
           / logits[1].abs().max()).item()
    log(f"  (f) first decode logits, card against CPU: {rel:.3e} of the "
        f"largest |logit| (bound {GEN_CPU_REL})")
    if not rel <= GEN_CPU_REL:
        raise AssertionError(f"(f) first decode logits {rel:.3e} from the "
                             "CPU's")


def decode_step_ms(e, prompts, smi):
    """Decode ms per step at 1, 8 and 16 slots, captured against
    FLAGS.jit_cache = False in turns; device time of one traced replay at
    16 slots and the card's idle share; the step's byte bound."""
    rows = {}
    for slots in (1, 8, 16):
        st = seat(e, prompts[:slots], slots=slots)
        e.decode_chunk(st, GEN_CHUNK)   # capture

        def eager(_):
            with jit_cache(False):
                e.decode_chunk(st, GEN_CHUNK)
        med = in_turns([("captured", lambda _: e.decode_chunk(st, GEN_CHUNK)),
                        ("eager", eager)], range(4), start=1)
        rows[slots] = [m / GEN_CHUNK for m in med]
        if slots == 16:
            trace, busy = device_rows(lambda: e.decode_chunk(st, GEN_CHUNK))
            spec = e.spec
            # every weight read once, but only one row of each embedding
            # per slot; the cache read whole (the dense view's bytes)
            tables = ("lm_word_emb", "lm_pos_emb")
            weights = sum(e.scope.find_var(n).numel() * 4
                          for n in e._traced_step(GEN_CAP).param_names
                          if n not in tables) \
                + 2 * slots * GEN_LM["d_model"] * 4
            cache = (2 * spec.n_layer * slots * spec.n_head * GEN_CAP
                     * spec.d_head * 4)
            bound = (weights + cache) / HBM_BYTES_PER_S * 1e3
            log(f"  decode at 16 slots: one traced replay "
                f"{busy / GEN_CHUNK:.4f} ms of device time per step against "
                f"{rows[16][0]:.4f} ms "
                f"wall: idle {max(0.0, 1 - busy / med[0]):.1%}; "
                f"{sum(r[2] for r in trace) / GEN_CHUNK:.0f} kernels per "
                f"step; "
                f"bytes bound {bound:.4f} ms per step ({weights / 1e6:.1f} MB "
                f"of weights + {cache / 1e6:.1f} MB of cache at 3.35 TB/s) "
                f"[{smi}]")
            for key, us, count in sorted(trace, key=lambda r: -r[1])[:12]:
                log(f"    {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% "
                    f"x{count:<6} {key[:90]}")
        e.free_state(st)
    log("  decode ms per step, captured against eager (jit_cache=False), "
        "medians of 3 rounds in turns: " + ", ".join(
            f"{s} slots {c:.4f} / {g:.4f} ({g / c:.1f}x)"
            for s, (c, g) in rows.items()) + f" [{smi}]")
    return rows


def generation_paths(smi):
    """Phase 14. Returns its flash launches, which must be (0, 0)."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    with unique_name.guard():
        lm = transformer.build_lm(**GEN_LM)
    spec = lm["spec"]
    spec.startup.random_seed = SEED
    prompts = gen_prompts(GEN_LM["vocab"], SEED)
    dense = gen_engine(spec, paged=False, prefix=False)
    paged = gen_engine(spec, paged=True, prefix=False)
    prefix = gen_engine(spec, paged=True, prefix=True)
    names = [v.name for v in spec.startup.list_vars() if v.persistable]
    for e in (paged, prefix):
        if not all(torch.equal(e.scope.find_var(n), dense.scope.find_var(n))
                   for n in names):
            raise AssertionError("phase 14's engines hold other weights")
    log(f"  build_lm {GEN_LM}: {len(names)} parameters, "
        f"{sum(dense.scope.find_var(n).numel() for n in names) / 1e6:.1f} M "
        f"weights; {GEN_REQUESTS} prompts of {sorted(set(GEN_LENS))} tokens, "
        f"every other opening with a {GEN_SHARED}-token system prompt, "
        f"{GEN_NEW} new tokens each")

    # the re-prefill reference, once (the three engines share weights);
    # its first pass captures each prefill bucket's plan
    t0 = time.perf_counter()
    ref, gaps = [], []
    for p in prompts:
        g = []
        ref.append(naive_generate(dense, p, GEN_NEW, gaps=g).tolist())
        gaps.append(g)
    ref_s = time.perf_counter() - t0
    flat = [x for g in gaps for x in g]
    log(f"  reference (naive re-prefill, first pass): {sum(map(len, ref))} "
        f"tokens in {ref_s:.2f} s; {sum(x < GEN_TIE for x in flat)} of "
        f"{len(flat)} steps are near-ties (top-2 gap under {GEN_TIE})")

    # (b) under the deterministic mode: the dense and the paged engine
    # warm (each chunk key captured) and agree bitwise
    with deterministic() as found:
        outs = {}
        for label, e in (("dense", dense), ("paged", paged)):
            e.generate(prompts, GEN_NEW)
            outs[label], _ = timed_generate(e, prompts)
        if [o.tolist() for o in outs["dense"]] != [o.tolist()
                                                   for o in outs["paged"]]:
            raise AssertionError("(b) dense and paged tokens differ")
        carries = []
        for e in (dense, paged):
            st = seat(e, prompts[:16])
            e.decode_chunk(st, GEN_NEW)
            carries.append(st.logits.clone())
            e.free_state(st)
        hold("(b)", "dense against paged carry logits after a 64-step chunk",
             distance(*carries), 0.0)
    if found:
        log(f"  (b) ops without a deterministic implementation: {found}")
    log(f"  (b) dense and paged (no prefix reuse): {GEN_REQUESTS} requests' "
        "tokens equal under torch.use_deterministic_algorithms")

    # warm the prefix engine: its prefix-prefill plans (twice: the plan's
    # first run is eager) and one generate (the chunk's capture)
    st = prefix.alloc_state(16, GEN_CAP)
    prefix.warm_prefix(st)
    prefix.warm_prefix(st)
    prefix.free_state(st)
    prefix.generate(prompts, GEN_NEW)
    for _ in range(2):   # the naive ladder's top bucket, timed below
        naive_generate(prefix, prompts[3], GEN_NEW)

    # (a), (c), (g): generate on each engine, warm, traced for flash
    # launches; nothing is built or captured
    before = {label: gen_counts(e) for label, e in
              (("dense", dense), ("paged", paged), ("prefix", prefix))}
    engines = (("dense", dense), ("paged", paged), ("paged+prefix", prefix))
    with traced_launches() as counted:
        for label, e in engines:
            outs = e.generate(prompts, GEN_NEW)
            near_ties(f"(a) {label}", [o.tolist() for o in outs], ref, gaps)
    check_launches("(g) generation", counted, (0, 0))
    hits0 = dict(prefix.stats)
    rates = {}
    for label, e in engines:
        outs, secs = timed_generate(e, prompts)
        rates[label] = sum(map(len, outs)) / secs
    saved = (prefix.stats["prefill_tokens_saved"]
             - hits0["prefill_tokens_saved"])
    hits = prefix.stats["prefix_hits"] - hits0["prefix_hits"]
    t0 = time.perf_counter()
    naive_tokens = sum(len(naive_generate(prefix, p, GEN_NEW))
                       for p in prompts[:8])
    naive_rate = naive_tokens / (time.perf_counter() - t0)
    log(f"  tokens/s, generate (32 requests, 2 chunks of 16 slots) against "
        f"naive_generate (8 requests one by one): " + ", ".join(
            f"{k} {v:.1f}" for k, v in rates.items())
        + f"; naive {naive_rate:.1f} [{smi}]")
    log(f"  prefix reuse: {hits} hits of {GEN_REQUESTS} admissions, "
        f"{saved} prefill tokens saved")

    # (d): a chunk reads only its tokens and done flags to the host
    st = seat(prefix, prompts[:16])
    fetched0 = prefix.stats["host_fetch_bytes"]
    n, nbytes = d2h_copies(lambda: prefix.decode_chunk(st, GEN_NEW))
    want = GEN_NEW * 16 * (4 + 1)
    counted_bytes = prefix.stats["host_fetch_bytes"] - fetched0
    log(f"  (d) one {GEN_NEW}-step chunk at 16 slots: {n} device-to-host "
        f"copies, {nbytes} bytes in the trace, {counted_bytes} counted "
        f"(want {want}: steps x slots x (int32 token + bool flag)); cache "
        f"resident {st.cache_bytes()} bytes")
    if n != 2 or nbytes != want or counted_bytes != want:
        raise AssertionError("(d) a decode chunk read more than its tokens "
                             "and done flags")
    prefix.free_state(st)
    after = {label: gen_counts(e) for label, e in
             (("dense", dense), ("paged", paged), ("prefix", prefix))}
    log(f"  (c) after the warm-up: {after}")
    if after != before:
        raise AssertionError(f"(c) warm traffic built or captured: before "
                             f"{before}, after {after}")

    gen_sampling(paged, prompts)
    with unique_name.guard():
        spec_cpu = transformer.build_lm(**GEN_LM)["spec"]
    gen_cpu_replay(spec_cpu, prefix, prompts[3], ref[3], gaps[3])

    steps = decode_step_ms(prefix, prompts, smi)
    dense_st, paged_st = dense.alloc_state(16, GEN_CAP), \
        paged.alloc_state(16, GEN_CAP)
    log(f"  KV bytes resident at 16 slots x cap {GEN_CAP}: dense "
        f"{dense_st.cache_bytes()}, paged {paged_st.cache_bytes()} "
        f"({paged_st.num_pages} pages of {paged_st.page_size} + the null "
        "page, and the table)")
    for e in (dense, paged, prefix):
        log(f"  engine stats: {e.stats}; prefill captures "
            f"{e._exe.capture_stats}")
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    return {"generation": (0, 0)}, steps


# ---------------------------------------------------------------------------
# phase 15: generation behind the serving front, and beam search
# ---------------------------------------------------------------------------

# the GenerationPredictor of bench_infer_generate: 8 slots, 8-step chunks
PRED = dict(max_slots=8, decode_chunk=8, default_max_new_tokens=GEN_NEW)
PRED_CAP = 128 + 128     # its cap: the top prompt + top new-token bucket
PRED_CLIENTS = 8
PRED_REQUESTS = 48
PRED_TRACED = 16   # requests of each traced pass
# machine_translation.build at the Fluid benchmark's widths (30000-word
# dictionaries, 512 wide), max_len 50, beam 4, 50 decode steps; batch 16,
# so the loop carries 64 hypotheses
MT = dict(src_dict_size=30000, tgt_dict_size=30000, emb_dim=512, hid=512,
          max_len=50, beam_size=4, decode_max_len=50)
MT_BATCH = 16
MT_RUNS = 5        # captured runs held against eager ones, bitwise
# the card's final scores against the CPU's (fp32, TF32 off; other GEMM
# blockings), relative, where a batch row's sentences agree
MT_SCORE_REL = 1e-5
# where a batch row's hypotheses part from the CPU's, the first step they
# differ must be a near-tie: the row's selected scores at that step
# (chosen and rejected swapped) within this of the CPU's, relative
MT_TIE = 1e-5
MT_CHECK_STEP = 3  # a decode cut to this many steps agrees with the whole


def pred_clients(call, items):
    """``items`` through ``call(item)`` from PRED_CLIENTS threads, each
    taking the next item in turn. Returns (outputs, seconds each, wall
    seconds)."""
    outs, lat, errs = [None] * len(items), [None] * len(items), []
    it, lock = iter(range(len(items))), threading.Lock()
    barrier = threading.Barrier(PRED_CLIENTS)

    def client():
        barrier.wait()
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            try:
                t0 = time.perf_counter()
                outs[i] = call(items[i])
                lat[i] = time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 -- raised below
                errs.append(e)
                return

    threads = [threading.Thread(target=client, name=f"gen-client{c}")
               for c in range(PRED_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a generation client hung")
    if errs:
        raise errs[0]
    return outs, lat, wall


def alone_in_table(e, prompt, sampling=None):
    """``prompt`` alone in slot 0 of a table of the predictor's geometry
    (PRED's slots, PRED_CAP), decoded in its chunks: the carry and the
    chunk graph the predictor used (handed back at its shutdown)."""
    st = e.alloc_state(PRED["max_slots"], PRED_CAP)
    try:
        e.admit(st, 0, prompt, GEN_NEW, sampling or SamplingParams())
        chunk = PRED["decode_chunk"]
        got = [e.decode_chunk(st, chunk) for _ in range(GEN_NEW // chunk)]
    finally:
        e.free_state(st)
    toks = np.concatenate([t for t, _ in got])
    dones = np.concatenate([d for _, d in got])
    return collect_tokens(toks[:, 0], dones[:, 0], GEN_NEW).tolist()


def predictor_run(label, e, prompts, ref, gaps, smi):
    """One GenerationPredictor over engine ``e``: warm-up, the traffic from
    PRED_CLIENTS threads twice (the gates' pass, then the timed one), two
    passes of PRED_TRACED requests traced (flash launches, device time),
    the gates of ``predictor_paths``. Returns (its row of numbers, the
    traffic's tokens)."""
    torch.cuda.reset_peak_memory_stats()
    pred = GenerationPredictor(e, **PRED)
    hits0 = e.stats["prefix_hits"]

    def call(p):
        return pred.run(p, max_new_tokens=GEN_NEW, timeout=600).tolist()

    try:
        t0 = time.perf_counter()
        took = pred.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        before = gen_counts(e)
        outs, _, _ = pred_clients(call, prompts)
        timed, lat, wall = pred_clients(call, prompts)
        # two short passes traced: flash launches by kernel name, then
        # device time (a trace of the whole traffic costs minutes)
        walls, short = [], prompts[:PRED_TRACED]

        def traced():
            t = time.perf_counter()
            again = pred_clients(call, short)[0]
            walls.append(time.perf_counter() - t)
            if again != outs[:PRED_TRACED]:
                raise AssertionError(f"(a) {label}: a traced pass's tokens "
                                     "differ from the first pass's")
        with traced_launches() as counted:
            traced()
        check_launches(f"(g) {label} predictor", counted, (0, 0))
        rows, busy = device_rows(traced)
        after = gen_counts(e)
        h = pred.health()
        stats = dict(pred.stats)
        sampled = None
        if label == "paged+prefix":
            # (e) a sampled request amid greedy traffic
            sp = SamplingParams(seed=SEED, **GEN_SAMPLING)
            crowd = [pred.submit(p, max_new_tokens=GEN_NEW)
                     for p in prompts[:12]]
            mid = pred.submit(prompts[3], max_new_tokens=GEN_NEW,
                              sampling=sp)
            crowd += [pred.submit(p, max_new_tokens=GEN_NEW)
                      for p in prompts[12:20]]
            sampled = mid.result(timeout=600).tolist()
            for f in crowd:
                f.result(timeout=600)
    finally:
        pred.shutdown()
    log(f"  {label}: warm-up {warm_s:.2f} s ({', '.join(f'{k} {v:.2f}' for k, v in took.items())})")
    if after != before:
        raise AssertionError(f"(c) {label}: traffic after warmup() built or "
                             f"captured: before {before}, after {after}")
    log(f"  (c) {label}: after warmup() the traffic made no plan, capture, "
        f"decode plan, ingest key or carry: {after}")
    near_ties(f"(a) {label} predictor", outs, ref, gaps)
    if timed != outs:
        raise AssertionError(f"(a) {label}: the timed pass's tokens differ "
                             "from the first pass's")
    if not h["healthy"] or h["active_slots"]:
        raise AssertionError(f"(f) {label}: health after the traffic {h}")
    if stats["readmits"] <= 0:
        raise AssertionError(f"(d) {label}: no slot was re-admitted")
    tokens = sum(map(len, timed))
    per_tok = [s / len(o) * 1e3 for s, o in zip(lat, timed)]
    occupancy = stats["slot_steps"] / max(
        1, stats["decode_chunks"] * PRED["max_slots"])
    idle = max(0.0, 1 - busy / (walls[1] * 1e3))
    row = {"tokens_per_s": tokens / wall,
           "per_token_ms_p50": float(np.percentile(per_tok, 50)),
           "per_token_ms_p99": float(np.percentile(per_tok, 99)),
           "request_s_p50": float(np.percentile(lat, 50)),
           "request_s_p99": float(np.percentile(lat, 99)),
           "occupancy": occupancy, "joins": stats["joins"],
           "readmits": stats["readmits"], "deferrals": stats["deferrals"],
           "prefix_hits": e.stats["prefix_hits"] - hits0,
           "warmup_s": warm_s, "idle": idle,
           "kernels": sum(r[2] for r in rows),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  {label} predictor: {PRED_REQUESTS} requests x {GEN_NEW} tokens "
        f"from {PRED_CLIENTS} threads: {row['tokens_per_s']:.1f} tokens/s; "
        f"per token p50 {row['per_token_ms_p50']:.3f} ms, p99 "
        f"{row['per_token_ms_p99']:.3f} ms (a request's seconds over its "
        f"tokens); request p50 {row['request_s_p50']:.3f} s, p99 "
        f"{row['request_s_p99']:.3f} s; mean slot occupancy "
        f"{occupancy:.1%}; {stats['joins']} joins ({stats['readmits']} "
        f"re-admissions), {stats['deferrals']} deferrals, "
        f"{row['prefix_hits']} prefix hits over the four passes "
        f"and the sampled check; a traced pass of {PRED_TRACED} requests: "
        f"{busy:.1f} ms of device time in {walls[1] * 1e3:.1f} ms wall, "
        f"idle {idle:.1%}, {row['kernels']} kernels; peak memory "
        f"{row['peak_gib']:.2f} GiB; health {h} [{smi}]")
    if sampled is not None:
        alone = alone_in_table(e, prompts[3], SamplingParams(
            seed=SEED, **GEN_SAMPLING))
        log(f"  (e) sampled (T {GEN_SAMPLING['temperature']}, top-k "
            f"{GEN_SAMPLING['top_k']}): {len(sampled)} tokens through the "
            f"predictor amid 20 greedy requests, {len(alone)} alone in "
            f"slot 0; equal: {sampled == alone}")
        if sampled != alone:
            raise AssertionError(f"(e) sampled tokens through the predictor "
                                 f"{sampled[:8]} against slot 0 alone "
                                 f"{alone[:8]}")
    return row, outs


def predictor_paths(smi):
    """Phase 15, path A: build_lm at phase 14's widths behind
    GenerationPredictor (8 slots, 8-step chunks, 64 new tokens), the paged
    engine with prefix reuse and a dense engine as the B side, against
    naive_generate from 8 threads. Gates: (a) each request's greedy tokens
    equal the re-prefill reference's under GEN_TIE, every pass alike; (b)
    on the dense predictor each request's tokens bitwise its tokens alone
    in slot 0 of the same table (the same carry and chunk graph); (c) no
    plan, capture, decode plan, ingest key or carry made after warmup();
    (d) slots re-admitted; (e) a sampled request's tokens the same through
    the predictor and alone in slot 0; (f) health() healthy with no active
    slot; (g) no flash launch."""
    t_phase = time.perf_counter()
    with unique_name.guard():
        spec = transformer.build_lm(**GEN_LM)["spec"]
    spec.startup.random_seed = SEED
    prompts = gen_prompts(GEN_LM["vocab"], SEED + 15, PRED_REQUESTS)
    prefix = gen_engine(spec, paged=True, prefix=True)
    dense = gen_engine(spec, paged=False, prefix=False)
    t0 = time.perf_counter()
    ref, gaps = [], []
    for p in prompts:
        g = []
        ref.append(naive_generate(dense, p, GEN_NEW, gaps=g).tolist())
        gaps.append(g)
    log(f"  reference: naive_generate of {PRED_REQUESTS} prompts of "
        f"{sorted(set(GEN_LENS))} tokens (every other opening with a "
        f"{GEN_SHARED}-token system prompt), {GEN_NEW} tokens each, in "
        f"{time.perf_counter() - t0:.2f} s (its plans' warm-up and "
        "capture included)")
    rows = {}
    rows["paged+prefix"], _ = predictor_run("paged+prefix", prefix, prompts,
                                            ref, gaps, smi)
    rows["dense"], outs = predictor_run("dense", dense, prompts, ref, gaps,
                                        smi)
    alone = [alone_in_table(dense, p) for p in prompts]
    same = sum(a == o for a, o in zip(alone, outs))
    log(f"  (b) dense: {same} of {PRED_REQUESTS} requests' tokens through "
        "the predictor bitwise their tokens alone in slot 0 of the same "
        "table")
    if same != PRED_REQUESTS:
        raise AssertionError("(b) a request's tokens depend on its "
                             "neighbours in the slot table")
    naive, lat, wall = pred_clients(
        lambda p: naive_generate(dense, p, GEN_NEW).tolist(), prompts)
    if naive != ref:
        raise AssertionError("naive_generate from 8 threads differs from "
                             "its serial run")
    rows["naive"] = {"tokens_per_s": sum(map(len, naive)) / wall}
    log(f"  tokens/s, {PRED_REQUESTS} requests from {PRED_CLIENTS} threads: "
        + ", ".join(f"{k} {v['tokens_per_s']:.1f}" for k, v in rows.items())
        + f" [{smi}]")
    log(f"  phase 15 path A: {time.perf_counter() - t_phase:.1f} s")
    return rows


def mt_feed(cfg, seed):
    """The decode program's feed: a fake batch's sources, every
    hypothesis starting at id 0, one live hypothesis per sentence."""
    batch = machine_translation.make_fake_batch(MT_BATCH, cfg, seed=seed)
    w = cfg["beam_size"]
    return {"src": batch["src"], "src_len": batch["src_len"],
            "start_ids": np.zeros((MT_BATCH * w,), np.int64),
            "init_scores": np.tile(np.array([0.0] + [-1e9] * (w - 1),
                                            np.float32), MT_BATCH)}


def mt_cut(program, steps):
    """A copy of the decode program whose loop stops after ``steps``
    trips (its limit and its trip bound set to ``steps``)."""
    prog = program.clone()
    blk = prog.global_block()
    loop = next(o for o in blk.ops if o.type == "while")
    cond = loop.attrs["__cond_name__"]
    cmp_op = next(o for o in blk.ops if o.type == "less_than"
                  and cond in o.output_arg_names)
    limit = cmp_op.input("Y")[0]
    fill = next(o for o in blk.ops if o.type == "fill_constant"
                and limit in o.output_arg_names)
    fill.desc.attrs["value"] = float(steps)
    loop.desc.attrs["__inferred_trip_bound__"] = int(steps)
    prog._bump()
    return prog


def mt_run(exe, program, feed, scope, fetch):
    return [np.asarray(a) for a in exe.run(program, feed=feed,
                                           fetch_list=fetch, scope=scope)]


def beam_search_path(smi):
    """Phase 15, path B: the machine-translation decode program (a While of
    50 trips over the attention GRU step, softmax, top_k and beam_search,
    array_write histories, beam_search_decode) at the Fluid benchmark's
    widths through Executor.run on the card, its loop bounded and so
    captured whole. Gates: captured against eager bitwise (deterministic
    mode); the card's sentences against a CPU run's, equal but where a
    batch row's hypotheses part at a near-tie (MT_TIE at the first step
    they differ); final scores within MT_SCORE_REL where sentences agree;
    a decode cut to MT_CHECK_STEP steps agrees with the whole; one
    captured call copies only its fetches to the host; no flash launch.
    Then an unbounded While (a fed limit) runs between captured segments,
    a bounded one inside one."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    m = machine_translation.build(**MT)
    cfg, prog = m["config"], m["decode"]["program"]
    exe = pt.Executor()
    # the startup program's weights from a seed on the CPU, as numpy,
    # into a card scope and a CPU scope
    cpu_exe = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    m["startup"].random_seed = SEED
    cpu_exe.run(m["startup"], scope=cpu_scope)
    names = [v.name for v in prog.list_vars() if v.persistable]
    arrays = {n: cpu_scope.find_var(n).numpy() for n in names}
    scope = pt.Scope()
    pt.io.set_params_from_numpy(scope, arrays, exe.device, program=prog)
    n_weights = sum(a.size for a in arrays.values())
    dec = next(o for o in prog.global_block().ops
               if o.type == "beam_search_decode")
    fetch = [m["decode"]["sentences"].name, "init_scores",
             dec.input("Ids")[0], dec.input("ParentIdx")[0]]
    feed = mt_feed(cfg, SEED)
    log(f"  machine_translation.build {MT}: {len(names)} parameters of the "
        f"decode program, {n_weights / 1e6:.1f} M weights; batch "
        f"{MT_BATCH} x beam {cfg['beam_size']}")

    with traced_launches() as counted, deterministic() as found:
        with jit_cache(False):
            eager = [mt_run(exe, prog, feed, scope, fetch) for _ in range(2)]
        cap0 = dict(exe.capture_stats)
        captured = [mt_run(exe, prog, feed, scope, fetch)
                    for _ in range(MT_RUNS)]
    check_launches("(g) beam search", counted, (0, 0))
    if found:
        log(f"  ops without a deterministic implementation: {found}")
    captures = exe.capture_stats["captures"] - cap0["captures"]
    capture_s = exe.capture_stats["seconds"] - cap0["seconds"]
    for i, name in enumerate(("sentences", "final scores", "id history",
                              "parent history")):
        hold("captured", f"{name}, eager against eager",
             distance(torch.from_numpy(eager[0][i]),
                      torch.from_numpy(eager[1][i])), 0.0)
        hold("captured", f"{name}, {MT_RUNS} captured runs against eager",
             max(distance(torch.from_numpy(c[i]),
                          torch.from_numpy(eager[0][i])) for c in captured),
             0.0)
    if captures != (exe.device.type == "cuda"):
        raise AssertionError(f"the decode program made {captures} captures; "
                             "want one graph for its one device segment")
    plan = next(iter(prog.__dict__["_exec_cache"].values()))
    kinds = [k for k, _ in plan.segments]
    log(f"  plan segments {kinds}: the bounded While inside the one "
        f"captured device segment; capture and first replay "
        f"{capture_s:.2f} s")
    if kinds != ["device"]:
        raise AssertionError(f"the decode plan's segments {kinds}")

    sent, scores, ids_h, par_h = captured[0]
    cpu = mt_run(cpu_exe, prog, feed, cpu_scope, fetch)
    w = cfg["beam_size"]
    parted = []
    for b in range(MT_BATCH):
        rows = slice(b * w, (b + 1) * w)
        if np.array_equal(ids_h[:, rows], cpu[2][:, rows]) and \
                np.array_equal(par_h[:, rows], cpu[3][:, rows]):
            continue
        t = int(np.argmax(np.any((ids_h[:, rows] != cpu[2][:, rows])
                                 | (par_h[:, rows] != cpu[3][:, rows]),
                                 axis=1)))
        parted.append((b, t))
    for b, t in parted:
        cut = mt_cut(prog, t + 1)
        with jit_cache(False):
            card_t = mt_run(exe, cut, feed, scope, fetch)[1]
        cpu_t = mt_run(cpu_exe, cut, feed, cpu_scope, fetch)[1]
        rows = slice(b * w, (b + 1) * w)
        a, c = np.sort(card_t[rows]), np.sort(cpu_t[rows])
        rel = float(np.max(np.abs(a - c) / np.abs(c)))
        log(f"  batch row {b}: hypotheses part from the CPU's at step {t}; "
            f"its selected scores there {a.tolist()} (card) against "
            f"{c.tolist()} (CPU): {rel:.3e} relative (near-tie bound "
            f"{MT_TIE})")
        if not rel <= MT_TIE:
            raise AssertionError(f"batch row {b} parts from the CPU's at "
                                 f"step {t}, not at a near-tie")
    agree = [r for r in range(MT_BATCH * w)
             if r // w not in {b for b, _ in parted}]
    if not np.array_equal(sent[agree], cpu[0][agree]):
        raise AssertionError("sentences differ where the histories agree")
    rel = float(np.max(np.abs(scores[agree] - cpu[1][agree])
                       / np.abs(cpu[1][agree]))) if agree else 0.0
    log(f"  card against CPU (fp32, TF32 off): {MT_BATCH - len(parted)} of "
        f"{MT_BATCH} sentences' beams equal, {len(parted)} parted at a "
        f"near-tie; final scores {rel:.3e} relative (bound {MT_SCORE_REL}); "
        f"best hypothesis of sentence 0: {sent[0][:12].tolist()}")
    if not rel <= MT_SCORE_REL:
        raise AssertionError(f"final scores {rel:.3e} from the CPU's")
    with jit_cache(False):
        short = mt_run(exe, mt_cut(prog, MT_CHECK_STEP), feed, scope, fetch)
    if not (np.array_equal(short[2][:MT_CHECK_STEP],
                           ids_h[:MT_CHECK_STEP])
            and np.array_equal(short[3][:MT_CHECK_STEP],
                               par_h[:MT_CHECK_STEP])):
        raise AssertionError("a decode cut to MT_CHECK_STEP steps parts from "
                             "the whole decode")

    n, nbytes = d2h_copies(lambda: mt_run(exe, prog, feed, scope, fetch))
    want = sum(a.nbytes for a in captured[0])
    log(f"  one captured call: {n} device-to-host copies, {nbytes} bytes "
        f"(its {len(fetch)} fetches: {want} bytes)")
    if n != len(fetch) or nbytes != want:
        raise AssertionError("a captured decode call read more than its "
                             "fetches to the host")

    def eager_call(_):
        with jit_cache(False):
            mt_run(exe, prog, feed, scope, fetch)
    med = in_turns([("captured", lambda _: mt_run(exe, prog, feed, scope,
                                                  fetch)),
                    ("eager", eager_call)], range(5), start=1)
    rows, busy = device_rows(lambda: mt_run(exe, prog, feed, scope, fetch))
    kernels = sum(r[2] for r in rows)
    row = {"captured_ms": med[0], "eager_ms": med[1],
           "sentences_per_s": MT_BATCH / med[0] * 1e3,
           "kernels": kernels, "device_ms": busy,
           "idle": max(0.0, 1 - busy / med[0]), "capture_s": capture_s,
           "parted": len(parted),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  decode call (batch {MT_BATCH}, 50 steps), medians of 4 rounds "
        f"in turns: captured {med[0]:.2f} ms ({row['sentences_per_s']:.1f} "
        f"sentences/s), eager {med[1]:.2f} ms ({med[1] / med[0]:.1f}x); "
        f"a traced captured call: {busy:.2f} ms of device time, {kernels} "
        f"kernels (the graph's nodes), idle {row['idle']:.1%}; peak memory "
        f"{row['peak_gib']:.2f} GiB [{smi}]")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"    {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% x{count:<6} "
            f"{key[:90]}")
    while_loops(exe)
    log(f"  phase 15 path B: {time.perf_counter() - t_phase:.1f} s")
    return row


def while_loops(exe):
    """A bounded While (an inferred bound of 3) runs inside a captured
    segment; one with a fed limit (no bound) runs between captured device
    segments, its condition read on the host each trip. Both give
    x * w^3 over 3 runs (warm-up, capture, replay)."""
    for fed in (False, True):
        prog, startup = pt.Program(), pt.Program()
        with unique_name.guard(), pt.program_guard(prog, startup):
            L = pt.layers
            x = L.data("x", shape=[3], dtype="float32")
            w = L.create_parameter([1, 3], "float32", name="w_loop")
            i = L.fill_constant(shape=[1], dtype="int32", value=0)
            n = (L.data("n", shape=[1], dtype="int32",
                        append_batch_size=False) if fed
                 else L.fill_constant(shape=[1], dtype="int32", value=3))
            y = L.scale(x, scale=1.0)
            cond = L.less_than(i, n)
            loop = L.While(cond)
            with loop.block():
                L.assign(L.elementwise_mul(y, w), output=y)
                L.increment(i, 1, in_place=True)
                L.less_than(i, n, cond=cond)
            z = L.scale(y, scale=2.0)
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        wv = np.array([[1.5, 0.5, 2.0]], np.float32)
        scope.set_var("w_loop", torch.from_numpy(wv).to(exe.device))
        xb = np.arange(6, dtype=np.float32).reshape(2, 3)
        feed = {"x": xb, **({"n": np.array([3], np.int32)} if fed else {})}
        got = [exe.run(prog, feed=feed, fetch_list=[z], scope=scope)[0]
               for _ in range(3)]
        kinds = [k for k, _ in next(iter(
            prog.__dict__["_exec_cache"].values())).segments]
        want = 2 * xb * wv ** 3
        ok = all(np.allclose(g, want, rtol=1e-6) for g in got)
        log(f"  While with {'a fed limit (unbounded)' if fed else 'an inferred bound of 3'}: "
            f"segments {kinds}; 3 runs give x * w^3 * 2: {ok}")
        if not ok or ("host" in kinds) != fed:
            raise AssertionError(f"While (fed limit {fed}): {got[-1]} "
                                 f"against {want}, segments {kinds}")


def predictor_and_beam_paths(smi):
    """Phase 15. Returns its flash launches, which must be (0, 0)."""
    rows = predictor_paths(smi)
    release()
    rows["beam_search"] = beam_search_path(smi)
    return {"generation_predictor": (0, 0), "beam_search": (0, 0)}, rows


# ---------------------------------------------------------------------------
# phase 16: the runtime around the training step
# ---------------------------------------------------------------------------

ELASTIC_EVERY = 8      # async cadence checkpoints, in steps
ELASTIC_KILL_AT = 16   # SIGKILL once a checkpoint of this step or later is
                       # marked and the child has trained past it
ELASTIC_END = 40       # the resumed and the uninterrupted runs end here
ELASTIC_EPOCH = 64     # batches in an epoch of the synthetic reader
ELASTIC_KEEP = 2       # checkpoints kept (each about 1.1 GB of files)
ELASTIC_TIMED = 24     # steps in each arm of the cadence timing
ELASTIC_WAIT_S = 300   # the longest one child's part may take
# the command of a phase-16(A) child (chip_smoke.py itself)
ELASTIC_CHILD = [sys.executable, os.path.abspath(__file__)]
ACCUM = (1, 2, 4)      # microbatches of batch 16
ACCUM_RUNS = 3
# accumulation against the unaccumulated batch, both bf16 AMP: the
# microbatches' products run on other GEMM shapes, so a bf16 output may
# round the other way (2^-8 relative). The mean gradient of step 1, as a
# relative L2 distance over every parameter: 2^-5, eight such roundings;
# a half batch's gradient (the control), a zeroed, negated or summed one
# are 0.5 or more away. The losses: about 5x the 7.3e-7 relative that
# the card reads at these widths in deterministic mode (the first loss is
# ln(32000) to within 1e-3 at any gradient, so the loss alone shows little)
ACCUM_GRAD_REL = 2.0 ** -5
ACCUM_LOSS_REL = 4e-6
# phase 16(C): Transformer-base widths, depth cut to 2 + 2 layers (the
# dense attention of a dropout build is about 3x the flash one's memory
# and time; the dropout sites and the generator are the same at any depth)
DROPOUT_MODEL = dict(MODEL, n_layer=2, dropout_rate=0.1)
DROPOUT_SIGMAS = 6     # the keep rate against its binomial deviation
DROPOUT_STEPS = 8      # the uninterrupted run; the cut one stops after 6
DROPOUT_EVERY = 4      # ... with its checkpoint at step 4
LOADER_BATCHES = 4     # distinct ResNet-50 batches, cycled
LOADER_ROUNDS = 8


def elastic_epoch(cfg, epoch):
    """The synthetic reader of phase 16(A): batch i of an epoch is seeded
    by (epoch, i), so every pass over an epoch gives the same batches."""
    for i in range(ELASTIC_EPOCH):
        yield train_batch(cfg, TRAIN_BATCH, SEED + 100000 * (epoch + 1) + i)


def elastic_setup():
    """Phase 16(A)'s trainer in this process: Transformer-base (the
    unfused build under bench.py's BuildStrategy, AMP) from the seeded
    startup, and a DataLoader over the epoch-seeded reader."""
    with unique_name.guard():
        m = transformer.build(attention_impl="unfused", **MODEL)
    m["startup"].random_seed = SEED
    exe = pt.Executor()
    exe.run(m["startup"])
    amp_main = mixed_precision.decorate(m["main"].clone())
    target = pt.CompiledProgram(amp_main,
                                build_strategy=bench_build_strategy())
    blk = amp_main.global_block()
    loader = pt.reader.DataLoader([blk.var(n) for n in TRAIN_FEEDS],
                                  device=exe.device)
    loader.set_batch_generator(lambda: elastic_epoch(
        m["config"], loader.state_dict()["epoch"]))
    return m, exe, target, loader


def state_digest(scope, program):
    """sha256 of every persistable's bytes."""
    import hashlib
    out = {}
    for v in program.list_vars():
        if v.persistable:
            t = scope.find_var(v.name).detach().reshape(-1).contiguous()
            out[v.name] = hashlib.sha256(
                t.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
    return out


def _dump(obj, path):
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def elastic_child(role, ckpt, out):
    """One process of phase 16(A) (``--elastic-child ROLE CKPT OUT``):
    ``killed`` trains until the parent kills it; ``resumed`` restores
    from ``ckpt``, trains to ELASTIC_END, writes its results and trains on
    until SIGTERM, when the trainer writes its emergency checkpoint and
    exits with RESUME_EXIT_CODE; ``reference`` trains to ELASTIC_END
    without interruption (beside the killed child), then waits for the
    file ``OUT.go`` (the parent makes it when the card is its alone),
    times steps with and without cadence checkpoints, a synchronous and
    an asynchronous save, traces two steps and writes its results. Each
    step's loss goes to ``OUT.steps``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.launches = fa.bwd_launches = 0
    m, exe, target, loader = elastic_setup()
    loss_name = m["loss"].name
    program = target.program
    res = {"role": role}
    steps_log = open(out + ".steps", "a")
    with deterministic() as warned:
        tr = pt.elastic.ElasticTrainer(
            exe, ckpt, main_program=target, loader=loader,
            save_every_steps=ELASTIC_EVERY, max_num_checkpoints=ELASTIC_KEEP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["start"] = tr.restore()
        torch.cuda.synchronize()
        res["restore_s"] = time.perf_counter() - t0
        losses, walls = {}, []
        last = [time.perf_counter()]

        def on_step(step, fetched):
            loss = float(np.asarray(fetched[0]).reshape(-1)[0])
            now = time.perf_counter()
            walls.append(now - last[0])
            last[0] = now
            losses[step] = loss.hex()
            steps_log.write(json.dumps([step, loss.hex()]) + "\n")
            steps_log.flush()
            if step == ELASTIC_END and role != "killed":
                res.update(losses=dict(losses), walls=walls[:2],
                           digest=state_digest(pt.global_scope(), program),
                           peak_bytes=torch.cuda.max_memory_allocated())
                if role == "resumed":
                    # its deterministic-mode warnings are read when the
                    # mode ends, which SIGTERM's exit skips; the
                    # uninterrupted child runs the same ops and reports
                    res["calls"] = (fa.launches, fa.bwd_launches)
                    _dump(res, out)

        end = ELASTIC_END if role == "reference" else 10 ** 9
        while tr.global_step < end:
            tr.run(loader, fetch_list=[loss_name], max_steps=end,
                   on_step=on_step, save_on_exit=False)
        tr.close()
        if role != "reference":
            raise AssertionError(f"{role}: the run ended by itself")
        while not os.path.exists(out + ".go"):
            time.sleep(0.05)

        def forever():
            while True:
                yield from loader

        feeds = forever()

        def plain(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                exe.run(target, feed=next(feeds), fetch_list=[loss_name])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        def cadence(n, d):
            tr2 = pt.elastic.ElasticTrainer(
                exe, d, main_program=target, save_every_steps=ELASTIC_EVERY,
                max_num_checkpoints=ELASTIC_KEEP,
                install_signal_handler=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr2.run(feeds, fetch_list=[loss_name], max_steps=n,
                    save_on_exit=False)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / n
            stats = dict(tr2._ckpt.stats)
            t0 = time.perf_counter()
            tr2.close()
            stats["drain_s"] = time.perf_counter() - t0
            return ms, stats

        timing = {"plain_ms": [], "cadence_ms": [], "cadence_stats": []}
        for r, arm in enumerate(("plain", "cadence", "cadence", "plain")):
            if arm == "plain":
                timing["plain_ms"].append(plain(ELASTIC_TIMED))
            else:
                ms, stats = cadence(ELASTIC_TIMED,
                                    os.path.join(ckpt, f"timed{r}"))
                timing["cadence_ms"].append(ms)
                timing["cadence_stats"].append(stats)
        d_sync = os.path.join(ckpt, "sync")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.io.save_checkpoint(exe, d_sync, 1, main_program=target)
        timing["sync_save_s"] = time.perf_counter() - t0
        timing["bytes"] = _dir_bytes(d_sync)
        ac = pt.io.AsyncCheckpointer()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        ac.save(exe, os.path.join(ckpt, "async"), 1, main_program=target)
        timing["snapshot_bytes"] = torch.cuda.memory_allocated() - before
        t0 = time.perf_counter()
        ac.close()
        timing["async"] = dict(ac.stats, drain_s=time.perf_counter() - t0)
        res["timing"] = timing
        # the wrappers' calls of this process's path (eager runs and
        # captures), read before the trace zeroes them
        res["calls"] = (fa.launches, fa.bwd_launches)
        with traced_launches() as counted:
            for _ in range(2):
                exe.run(target, feed=next(feeds), fetch_list=[loss_name])
        res["traced"] = counted["traced"]
    res["warned"] = list(warned)
    _dump(res, out)


def _child_steps(path):
    """{step: loss hex} of a child's step log (a line cut by a kill is
    left out)."""
    got = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    step, loss = json.loads(line)
                except ValueError:
                    continue
                got[step] = loss
    return got


def _tail(path, n=3000):
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def elastic_path(smi):
    """Phase 16(A): three child processes (the trainer killed with
    SIGKILL and the uninterrupted run side by side, then the killed
    one's resume); the resumed losses and the persistables at
    ELASTIC_END bitwise the uninterrupted run's; the SIGTERM arm; the
    checkpoint costs, taken by the uninterrupted child alone on the
    card. Returns the path's flash launches (the wrappers' calls in the
    uninterrupted child)."""
    import shutil
    import signal
    base = tempfile.mkdtemp(prefix="chip_smoke_elastic_",
                            dir=_build.BUILD_DIR)
    procs = []

    def spawn(role, ckpt):
        out = os.path.join(base, f"{role}.json")
        logf = open(os.path.join(base, f"{role}.log"), "w")
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        p = subprocess.Popen(ELASTIC_CHILD + ["--elastic-child", role, ckpt,
                                              out],
                             stdout=logf, stderr=subprocess.STDOUT, env=env)
        procs.append(p)
        return p, out

    def wait_for(p, role, ready, what):
        deadline = time.time() + ELASTIC_WAIT_S
        while not ready():
            if p.poll() is not None:
                raise AssertionError(
                    f"{role} child exited {p.returncode} before {what}:\n"
                    + _tail(os.path.join(base, f"{role}.log")))
            if time.time() > deadline:
                raise AssertionError(f"{role} child: no {what} in "
                                     f"{ELASTIC_WAIT_S} s")
            time.sleep(0.005)

    try:
        ckpt = os.path.join(base, "ckpt")
        t0 = time.perf_counter()
        # the uninterrupted run trains beside the killed one; it times
        # its checkpoints only once the card is its alone
        ref_p, ref_out = spawn("reference", os.path.join(base, "ref"))
        p, out = spawn("killed", ckpt)
        marked = [0]

        def past_a_checkpoint():
            try:  # the child's retention may remove a directory meanwhile
                marked[0] = (pt.io.read_train_state(ckpt) or {}).get(
                    "step", 0)
            except OSError:
                return False
            steps = _child_steps(out + ".steps")
            return (marked[0] >= ELASTIC_KILL_AT and bool(steps)
                    and max(steps) > marked[0])

        wait_for(p, "killed", past_a_checkpoint,
                 f"a marked checkpoint of step >= {ELASTIC_KILL_AT}")
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=60)
        if p.returncode != -signal.SIGKILL:
            raise AssertionError(f"killed child: exit {p.returncode}")
        killed = _child_steps(out + ".steps")
        killed_at = max(killed)
        left = sorted(os.listdir(ckpt))
        log(f"16(A) killed child: SIGKILL after step {killed_at} (checkpoint "
            f"of step {marked[0]} marked), {time.perf_counter() - t0:.1f} s; "
            f"left in the checkpoint dir: {left}")

        t0 = time.perf_counter()
        p, out = spawn("resumed", ckpt)
        wait_for(p, "resumed", lambda: os.path.exists(out),
                 f"its results at step {ELASTIC_END}")
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=ELASTIC_WAIT_S)
        with open(out) as f:
            resumed = json.load(f)
        # the trainer checkpoints the last step it completed
        said = max(_child_steps(out + ".steps"))
        emergency = (pt.io.read_train_state(ckpt) or {}).get("step")
        log(f"16(A) resumed child: restored step {resumed['start']} in "
            f"{resumed['restore_s']:.2f} s; the first step after it "
            f"{resumed['walls'][0]:.2f} s (the warm-up), the second "
            f"{resumed['walls'][1]:.2f} s (the capture); SIGTERM after step "
            f"{ELASTIC_END}: exit {rc} after step {said}, the newest "
            f"complete checkpoint of step {emergency}; "
            f"{time.perf_counter() - t0:.1f} s")
        if rc != pt.elastic.RESUME_EXIT_CODE or emergency != said or \
                emergency < ELASTIC_END:
            raise AssertionError(
                f"SIGTERM arm: exit {rc}, preempted at {said}, newest "
                f"complete checkpoint {emergency}:\n"
                + _tail(os.path.join(base, "resumed.log")))

        t0 = time.perf_counter()
        open(ref_out + ".go", "w").close()
        rc = ref_p.wait(timeout=ELASTIC_WAIT_S)
        if rc != 0:
            raise AssertionError(f"reference child exited {rc}:\n"
                                 + _tail(os.path.join(base,
                                                      "reference.log")))
        with open(ref_out) as f:
            ref = json.load(f)
        log(f"16(A) uninterrupted child: its timing part "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(base, ignore_errors=True)

    start = resumed["start"]
    if not ELASTIC_KILL_AT <= start < min(killed_at, ELASTIC_END):
        raise AssertionError(f"resumed from step {start}")
    steps = range(start + 1, ELASTIC_END + 1)
    if sorted(map(int, resumed["losses"])) != list(steps):
        raise AssertionError(f"the resumed run logged steps "
                             f"{sorted(resumed['losses'])}")
    differ = [s for s in steps if resumed["losses"][str(s)]
              != ref["losses"][str(s)]]
    before = [s for s in killed if s <= ELASTIC_END
              and killed[s] != ref["losses"][str(s)]]
    state = [n for n in ref["digest"]
             if resumed["digest"].get(n) != ref["digest"][n]]
    log(f"16(A) resumed steps {start + 1}-{ELASTIC_END} against the "
        f"uninterrupted run: {len(differ)} losses differ; the killed run's "
        f"steps 1-{min(killed_at, ELASTIC_END)}: {len(before)} differ; "
        f"{len(state)} of {len(ref['digest'])} persistables differ at step "
        f"{ELASTIC_END} (sha256 of their bytes); losses at steps "
        f"{start + 1} and {ELASTIC_END}: "
        f"{float.fromhex(ref['losses'][str(start + 1)]):.6f}, "
        f"{float.fromhex(ref['losses'][str(ELASTIC_END)]):.6f}")
    warned = ref["warned"]
    if differ or before or state or len(ref["digest"]) != len(
            resumed["digest"]):
        raise AssertionError("16(A): the resumed run is not bitwise the "
                             f"uninterrupted one ({differ}, {before}, "
                             f"{state[:5]})")
    if warned:
        raise AssertionError(f"16(A): ops without a deterministic "
                             f"implementation: {warned}")

    t = ref["timing"]
    plain_ms, cad_ms = np.mean(t["plain_ms"]), np.mean(t["cadence_ms"])
    stall = max(s["stall_s"] for s in t["cadence_stats"])
    join = max(s["join_s"] for s in t["cadence_stats"])
    write = max(s["write_s"] for s in t["cadence_stats"])
    log(f"16(A) checkpoint of {t['bytes'] / 2 ** 30:.3f} GiB "
        f"({t['bytes']} bytes of files): synchronous save "
        f"{t['sync_save_s'] * 1e3:.1f} ms; async: the step loop's stall "
        f"{t['async']['stall_s'] * 1e3:.2f} ms (a device copy of "
        f"{t['snapshot_bytes'] / 2 ** 30:.3f} GiB), the writer "
        f"{t['async']['write_s'] * 1e3:.1f} ms, drain (close) "
        f"{t['async']['drain_s'] * 1e3:.1f} ms [{smi}]")
    log(f"16(A) steps with cadence checkpoints every {ELASTIC_EVERY} steps "
        f"{cad_ms:.2f} ms a step (means of {t['cadence_ms']}) against "
        f"{plain_ms:.2f} ms without ({t['plain_ms']}), "
        f"{cad_ms / plain_ms:.3f}x; in the cadence arms the largest stall "
        f"{stall * 1e3:.2f} ms, join of the previous writer "
        f"{join * 1e3:.1f} ms, writer {write * 1e3:.1f} ms; peak memory "
        f"at step {ELASTIC_END} {ref['peak_bytes'] / 2 ** 30:.2f} GiB")
    traced = tuple(ref["traced"])
    # on the card a child's plan passes through the wrappers twice (the
    # warm-up and the capture); every later step is a replay
    want = (2 * FWD_PER_STEP, 2 * BWD_PER_STEP)
    calls = [tuple(ref["calls"]), tuple(resumed["calls"])]
    log(f"16(A) flash wrapper calls in the uninterrupted child {calls[0]}, "
        f"in the resumed one {calls[1]} (want {want} each on the card); "
        f"two traced replays: {traced[0]} forward + {traced[1]} backward "
        f"flash kernels by name (two steps' {want})")
    on_card = pt.Executor().device.type == "cuda"
    if (on_card and calls != [want, want]) or not all(traced) \
            or not all(calls[0]) or not all(calls[1]):
        raise AssertionError(f"16(A) flash wrapper calls {calls}, traced "
                             f"{traced}")
    return calls[0]


def noam_lr(step, d_model=512, warmup=8000):
    return d_model ** -0.5 * min(step ** -0.5 if step else float("inf"),
                                 step * warmup ** -1.5)


def grad_distance(a, b):
    """Relative L2 distance of two sets of tensors {name: tensor}, over
    all their elements: |a - b| / |b|."""
    num = sum(float((a[n].double() - b[n].double()).pow(2).sum()) for n in b)
    den = sum(float(b[n].double().pow(2).sum()) for n in b)
    return (num / den) ** 0.5


@contextlib.contextmanager
def graphs_kept():
    """The CUDA graphs the executor captures in the body keep their
    cudaGraph_t (``keep_graph``: instantiated at the first replay, which
    the capture makes), for ``graph_flash_nodes``. Yields the list they
    are appended to."""
    real, kept = torch.cuda.CUDAGraph, []

    def make(*args, **kwargs):
        graph = real(*args, keep_graph=True, **kwargs)
        graph.enable_debug_mode()
        kept.append(graph)
        return graph

    torch.cuda.CUDAGraph = make
    try:
        yield kept
    finally:
        torch.cuda.CUDAGraph = real


def graph_flash_nodes(graph):
    """(forward, backward) flash kernel nodes of a graph kept by
    ``graphs_kept``, and its kernel nodes, from its DOT dump
    (cudaGraphDebugDotPrint): a replay launches each kernel node once."""
    path = os.path.join(_build.BUILD_DIR, f"graph_{os.getpid()}.dot")
    graph.debug_dump(path)
    with open(path) as f:
        text = f.read()
    os.remove(path)
    # a node's definition starts a line; an edge names two nodes
    nodes = re.split(r'^"graph_\d+_node_\d+"\[', text, flags=re.M)[1:]
    kernels = [n for n in nodes if 'label="{KERNEL' in n]
    return (sum("flash_fwd_kernel" in n for n in kernels),
            sum("flash_bwd_" in n for n in kernels)), len(kernels)


def accumulation_path(smi):
    """Phase 16(B): Transformer-base AMP (the fused build: no pass runs
    under accumulation, as in the JAX package) through CompiledProgram
    with gradient_accumulation_steps K = 1, 2 and 4 over batch 16 of full
    length (equal token counts in every microbatch, so the mean of the
    microbatch losses is the batch loss and the mean of their gradients
    the batch gradient), 3 steps each: captured against eager bitwise
    (deterministic mode); the accumulated mean gradient of step 1 (Adam's
    moment1 after it, (1 - beta1) x the gradient) against K = 1's within
    ACCUM_GRAD_REL, which a half batch's gradient must exceed; losses
    within ACCUM_LOSS_REL; the flash wrappers' calls K times a step's
    and a traced replay's kernels by name exact; a traced replay's device
    time; peak memory. Returns the wrappers' calls."""
    with unique_name.guard():
        m = transformer.build(**MODEL)
    m["startup"].random_seed = SEED
    exe = pt.Executor()
    init = pt.Scope()
    exe.run(m["startup"], scope=init)
    state = {n: init.find_var(n) for n in init.var_names()}
    amp_main = mixed_precision.decorate(m["main"].clone())
    cfg, loss_name = m["config"], m["loss"].name
    feeds = []
    for i in range(ACCUM_RUNS):
        f = transformer.make_fake_batch(TRAIN_BATCH, cfg, seed=SEED + 700 + i)
        feeds.append({k: f[k] for k in TRAIN_FEEDS})
    params = [p.name for p in m["main"].all_parameters()]
    moments = [v.name for v in amp_main.list_vars()
               if v.persistable and "_moment1" in v.name]
    if not moments:
        raise AssertionError("16(B): no moment1 accumulator")
    runs = {}
    launches = [0, 0]
    for k in ACCUM:
        fa.launches = fa.bwd_launches = 0
        bs = pt.BuildStrategy()
        bs.gradient_accumulation_steps = k
        target = pt.CompiledProgram(amp_main, build_strategy=bs)
        arms = {}
        with deterministic() as warned, graphs_kept() as graphs:
            for arm in ("eager", "captured"):
                scope = copy_state(state, exe.device)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                secs = []
                with jit_cache(arm == "captured"):
                    losses = []
                    for f in feeds:
                        t0 = time.perf_counter()
                        losses += run_tensors(exe, target, feed=f,
                                              fetch_list=[loss_name],
                                              scope=scope)
                        torch.cuda.synchronize()
                        secs.append(time.perf_counter() - t0)
                        if len(losses) == 1:
                            first = {n: scope.find_var(n).clone()
                                     for n in moments}
                arms[arm] = dict(scope=scope, losses=losses, secs=secs,
                                 moment1=first,
                                 peak=torch.cuda.max_memory_allocated())
        cap, eag = arms["captured"], arms["eager"]
        label = f"16(B) K={k}"
        hold(label, f"captured against eager, losses of {ACCUM_RUNS} steps",
             max(map(distance, cap["losses"], eag["losses"])), 0.0)
        hold(label, "captured against eager, persistables",
             scope_distance(cap["scope"], eag["scope"])[0], 0.0)
        if warned:
            raise AssertionError(f"{label}: {warned}")
        # the wrappers' calls of this K's eager arm and its capture
        calls = (fa.launches, fa.bwd_launches)
        # every microbatch of the eager arm's steps, and of the captured
        # arm's warm-up and capture (on the card; every run elsewhere),
        # passes through the wrappers: K times a step's launches
        runs_in = ACCUM_RUNS + (2 if exe.device.type == "cuda"
                                else ACCUM_RUNS)
        want = (runs_in * k * FWD_PER_STEP, runs_in * k * BWD_PER_STEP)
        launches = [a + b for a, b in zip(launches, calls)]

        def replay():
            exe.run(target, feed=feeds[0], fetch_list=[loss_name],
                    scope=cap["scope"])

        # the flash kernel nodes of the step's graph, exact: a trace of a
        # replay has read one forward kernel short now and then (a trace
        # shows that they run); the device time from a trace with the
        # host's activity too (device_rows)
        step = (k * FWD_PER_STEP, k * BWD_PER_STEP)
        if exe.device.type == "cuda":
            if len(graphs) != 1:
                raise AssertionError(f"{label}: {len(graphs)} graphs "
                                     "captured, want 1")
            nodes, n_nodes = graph_flash_nodes(graphs[0])
        else:  # no graph on the CPU: the rehearsal's eager step
            nodes, n_nodes = step, None
        with traced_launches() as counted:
            replay()
        traced = counted["traced"]
        rows, busy = device_rows(replay)
        also = (sum(r[2] for r in rows if "flash_fwd_kernel" in r[0]),
                sum(r[2] for r in rows if "flash_bwd_" in r[0]))
        log(f"{label}: losses " + ", ".join(
            f"{float(x):.6f}" for x in cap["losses"]) + f"; eager steps "
            + ", ".join(f"{s:.2f}" for s in eag["secs"]) + " s; captured: "
            f"warm-up {cap['secs'][0]:.2f} s, capture {cap['secs'][1]:.2f} "
            f"s, replay {cap['secs'][2] * 1e3:.1f} ms; flash wrapper calls "
            f"{calls} (want {want}); the step's graph: flash kernel nodes "
            f"{nodes} of {n_nodes} kernel nodes (want {step}); a traced "
            f"replay: flash kernels {traced} by name, and in a trace with the "
            f"host's activity {also}, {busy:.2f} ms of device time; peak "
            f"memory captured {cap['peak'] / 2 ** 30:.2f} GiB, eager "
            f"{eag['peak'] / 2 ** 30:.2f} GiB [{smi}]")
        if calls != want or tuple(nodes) != step or not all(traced):
            raise AssertionError(f"{label}: wrapper calls {calls}, want "
                                 f"{want}; graph nodes {nodes}, want "
                                 f"{step}; traced {traced}")
        runs[k] = cap
        del arms, eag
        exe.close()
        release()

    # the control: K = 1 on the first half of step 1's batch (the first
    # microbatch of K = 2), whose gradient the gate must tell apart
    target = pt.CompiledProgram(amp_main, build_strategy=pt.BuildStrategy())
    half = copy_state(state, exe.device)
    with deterministic():
        exe.run(target, feed={n: v[:TRAIN_BATCH // 2]
                              for n, v in feeds[0].items()},
                fetch_list=[loss_name], scope=half)
    control = grad_distance({n: half.find_var(n) for n in moments},
                            runs[1]["moment1"])
    del half
    exe.close()
    # Adam moves an element by at most about lr_t a step (|m^/sqrt(v^)|
    # <= 1.0 for betas 0.9 and 0.98 in the first steps), so two runs from
    # one state part by at most the sum of both runs' rates, over the
    # ACCUM_RUNS steps and the two traced replays; under accumulation the
    # noam rate ops, of the forward role, run before the counter's
    # increment and take the previous step's rate (0 at step 1), as in
    # the JAX package; doubled for margin
    bound = 2 * sum(noam_lr(t, MODEL["d_model"])
                    + noam_lr(t - 1, MODEL["d_model"])
                    for t in range(1, ACCUM_RUNS + 3))
    log(f"16(B) control: K=1 on the first half of step 1's batch, its "
        f"gradient (moment1) {control:.3e} from the whole batch's, "
        f"relative L2 (bound {ACCUM_GRAD_REL:.3e} must fail it)")
    if not control > ACCUM_GRAD_REL:
        raise AssertionError(f"16(B): the half batch's gradient is "
                             f"{control} from the batch's, within the "
                             f"bound {ACCUM_GRAD_REL}")
    for k in ACCUM[1:]:
        rel = max(abs(float(a) - float(b)) / abs(float(b))
                  for a, b in zip(runs[k]["losses"], runs[1]["losses"]))
        grad = grad_distance(runs[k]["moment1"], runs[1]["moment1"])
        worst = max(distance(runs[k]["scope"].find_var(n),
                             runs[1]["scope"].find_var(n)) for n in params)
        log(f"16(B) K={k} against K=1: the mean gradient of step 1 "
            f"(moment1) within {grad:.3e} relative L2 (bound "
            f"{ACCUM_GRAD_REL:.3e}); losses of {ACCUM_RUNS} steps within "
            f"{rel:.3e} relative (bound {ACCUM_LOSS_REL:.1e}); parameters "
            f"after {ACCUM_RUNS + 2} steps within {worst:.3e} (bound "
            f"{bound:.3e}, twice the rates of both runs)")
        if not (grad <= ACCUM_GRAD_REL and rel <= ACCUM_LOSS_REL
                and worst <= bound):
            raise AssertionError(f"16(B) K={k}: gradient {grad}, loss "
                                 f"{rel}, parameters {worst}")
    del runs
    release()
    return tuple(launches)


def dropout_path(smi):
    """Phase 16(C): Transformer-base widths at 2 + 2 layers with dropout
    0.1 (every attention the dense chain), bf16 AMP, on a plain
    Executor under the deterministic mode. Returns the flash wrappers'
    calls over the path's runs, (0, 0), and checks a traced replay's
    flash kernels, none."""
    fa.launches = fa.bwd_launches = 0
    with unique_name.guard():
        m = transformer.build(**DROPOUT_MODEL)
    m["startup"].random_seed = m["main"].random_seed = SEED
    types = [o.type for o in m["main"].global_block().desc.ops]
    if "flash_attention" in types or "dropout" not in types:
        raise AssertionError("16(C): the dropout build has a flash op or "
                             "no dropout")
    exe = pt.Executor()
    init = pt.Scope()
    exe.run(m["startup"], scope=init)
    state = {n: init.find_var(n) for n in init.var_names()}
    main = mixed_precision.decorate(m["main"].clone())
    cfg, loss_name = m["config"], m["loss"].name
    p = DROPOUT_MODEL["dropout_rate"]
    op = next(o for o in main.global_block().desc.ops if o.type == "dropout")
    mask_name = op.output("Mask")[0]
    x_grad = op.input("X")[0] + "@GRAD"
    out_grad = op.output("Out")[0] + "@GRAD"
    feeds = [train_batch(cfg, TRAIN_BATCH, SEED + 800 + i)
             for i in range(DROPOUT_STEPS)]
    fetch = [loss_name, mask_name, x_grad, out_grad]
    label = "16(C)"
    with deterministic() as warned:
        scope = copy_state(state, exe.device)
        stats0 = dict(exe.capture_stats)
        got = [run_tensors(exe, main, feed=f, fetch_list=fetch, scope=scope)
               for f in feeds[:4]]
        if (exe.device.type == "cuda"
                and exe.capture_stats["captures"] - stats0["captures"] != 1):
            raise AssertionError(f"{label}: {exe.capture_stats}")
        n = got[0][1].numel()
        sigma = (p * (1 - p) / n) ** 0.5
        rates = [float(g[1].float().mean()) for g in got]
        log(f"{label}: {types.count('dropout')} dropout ops; the embedding "
            f"dropout's keep rate over {n} elements in 4 runs (warm-up, "
            f"capture, 2 replays): " + ", ".join(f"{r:.6f}" for r in rates)
            + f" (want {1 - p} within {DROPOUT_SIGMAS} sigma = "
            f"{DROPOUT_SIGMAS * sigma:.2e})")
        if any(abs(r - (1 - p)) > DROPOUT_SIGMAS * sigma for r in rates):
            raise AssertionError(f"{label}: keep rates {rates}")
        same = [i for i in range(1, 4) for j in range(i)
                if torch.equal(got[i][1], got[j][1])]
        hold(label, "runs whose mask repeats an earlier run's (each replay "
             "draws a fresh one)", float(len(same)), 0.0)
        gd = max(distance(g[2], (g[3] * g[1].to(g[3].dtype)) / (1.0 - p))
                 for g in got)
        hold(label, "X@GRAD against Out@GRAD * Mask / (1 - p) of the same "
             "run (the grad reads the forward's mask)", gd, 0.0)

        # a restored generator state continues the stream through the
        # graph already captured (every run below replays it: one plan,
        # one fetch list)
        gen = scope._generators[str(exe.device)]
        saved = gen.get_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = [run_tensors(exe, main, feed=f, fetch_list=fetch,
                             scope=scope)[1] for f in feeds[4:6]]
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3 / 2
        gen.set_state(saved)
        again = [run_tensors(exe, main, feed=f, fetch_list=fetch,
                             scope=scope)[1] for f in feeds[4:6]]
        hold(label, "masks of 2 replays after set_state(saved state) "
             "against the 2 replays after get_state", max(
                 map(distance, first, again)), 0.0)

        # a checkpoint restored in place into the captured scope: the
        # graph stays, and the next steps repeat the steps after the save
        d = tempfile.mkdtemp(prefix="chip_smoke_dropout_",
                             dir=_build.BUILD_DIR)
        try:
            caps = exe.capture_stats["captures"]
            pt.io.save_checkpoint(exe, os.path.join(d, "inplace"), 1,
                                  main_program=main, scope=scope)
            after = [run_tensors(exe, main, feed=f, fetch_list=fetch,
                                 scope=scope)[0] for f in feeds[6:8]]
            pt.io.load_checkpoint(exe, os.path.join(d, "inplace"),
                                  main_program=main, scope=scope)
            redo = [run_tensors(exe, main, feed=f, fetch_list=fetch,
                                scope=scope)[0] for f in feeds[6:8]]
            hold(label, "2 steps after load_checkpoint (in place) against "
                 "the 2 steps after the save", max(map(distance, after,
                                                       redo)), 0.0)
            if exe.capture_stats["captures"] != caps:
                raise AssertionError(f"{label}: {exe.capture_stats}: a "
                                     "capture after the first (the in-place "
                                     "restore dropped the graph)")

            # ElasticTrainer: uninterrupted; cut after step 6 (its
            # checkpoint at 4); resumed with a fresh scope and executor
            def trainer(e, ckpt, sc):
                return pt.elastic.ElasticTrainer(
                    e, ckpt, main_program=main, scope=sc,
                    save_every_steps=DROPOUT_EVERY,
                    install_signal_handler=False)

            ref, cut, resumed = {}, {}, {}

            def record(into, stop=None):
                def on_step(s, o):
                    into[s] = float(np.asarray(o[0]).reshape(-1)[0]).hex()
                    if s == stop:
                        raise KeyboardInterrupt  # the process dies here
                return on_step

            ref_scope = copy_state(state, exe.device)
            tr = trainer(exe, os.path.join(d, "ref"), ref_scope)
            tr.run(iter(feeds), fetch_list=[loss_name], on_step=record(ref))
            tr.close()
            tr = trainer(exe, os.path.join(d, "cut"),
                         copy_state(state, exe.device))
            try:
                tr.run(iter(feeds), fetch_list=[loss_name],
                       on_step=record(cut, DROPOUT_STEPS - 2))
            except KeyboardInterrupt:
                tr._ckpt.wait()
            tr.close()
            exe2, scope2 = pt.Executor(), copy_state(state, exe.device)
            tr = trainer(exe2, os.path.join(d, "cut"), scope2)
            start = tr.restore()
            tr.run(iter(feeds[start:]), fetch_list=[loss_name],
                   on_step=record(resumed))
            tr.close()
        finally:
            import shutil
            shutil.rmtree(d, ignore_errors=True)
        differ = [s for s in resumed if resumed[s] != ref[s]]
        sd = scope_distance(scope2, ref_scope)[0]
        log(f"{label}: ElasticTrainer cut after step {DROPOUT_STEPS - 2}, "
            f"resumed from step {start} in a fresh scope and executor: "
            f"steps {sorted(resumed)} against the uninterrupted run, "
            f"{len(differ)} losses differ; persistables {sd:.3e} apart")
        if start != DROPOUT_EVERY or differ or sd or \
                sorted(resumed) != list(range(start + 1, DROPOUT_STEPS + 1)):
            raise AssertionError(f"{label}: resume from {start}: {differ}, "
                                 f"{sd}")
    if warned:
        raise AssertionError(f"{label}: {warned}")
    log(f"{label}: a captured step {replay_ms:.2f} ms (mean of 2); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
        f"[{smi}]")
    calls = no_flash(label, lambda: run_tensors(
        exe, main, feed=feeds[0], fetch_list=fetch, scope=scope))
    exe.close()
    exe2.close()
    return calls


def no_flash(label, replay):
    """The flash wrappers' calls since they were last zeroed, which must
    be (0, 0), and a traced ``replay`` with no flash kernel. Returns the
    calls."""
    calls = (fa.launches, fa.bwd_launches)
    log(f"  {label}: flash wrapper calls over the path's runs {calls}")
    if calls != (0, 0):
        raise AssertionError(f"{label}: flash wrapper calls {calls}, want "
                             "(0, 0)")
    with traced_launches() as counted:
        replay()
    check_launches(f"{label}, a traced replay", counted, (0, 0))
    return calls


def loader_path(smi):
    """Phase 16(D): ResNet-50 AMP at batch 128 through CompiledProgram
    (bench BuildStrategy), fed by numpy feed dicts against a DataLoader
    over the same batches: bitwise the same losses (deterministic mode),
    then both in turns, with each arm's device time and idle share.
    Returns the flash wrappers' calls over the path's runs, (0, 0), and
    checks a traced replay's flash kernels, none."""
    fa.launches = fa.bwd_launches = 0
    with unique_name.guard():
        m = resnet.build(dataset="flowers", depth=50,
                         class_dim=RESNET_CLASSES,
                         image_shape=list(RESNET_IMAGE), lr=0.1)
    m["startup"].random_seed = SEED
    exe = pt.Executor()
    init = pt.Scope()
    exe.run(m["startup"], scope=init)
    state = {n: init.find_var(n) for n in init.var_names()}
    amp_main = mixed_precision.decorate(m["main"].clone())
    target = pt.CompiledProgram(amp_main,
                                build_strategy=bench_build_strategy())
    loss_name = m["loss"].name
    batches = [resnet_batch(RESNET_BATCH, SEED + 900 + i)
               for i in range(LOADER_BATCHES)]
    blk = amp_main.global_block()
    label = "16(D)"

    def arms():
        loader = pt.reader.DataLoader([blk.var("data"), blk.var("label")],
                                      capacity=2, device=exe.device)
        loader.set_batch_generator(lambda: iter(batches))

        def forever():
            while True:
                yield from loader

        it = forever()
        s1 = copy_state(state, exe.device)
        s2 = copy_state(state, exe.device)
        return [("feed dict", lambda i: run_tensors(
                    exe, target, feed=batches[i % LOADER_BATCHES],
                    fetch_list=[loss_name], scope=s1)[0]),
                ("DataLoader", lambda i: run_tensors(
                    exe, target, feed=next(it), fetch_list=[loss_name],
                    scope=s2)[0])]

    with deterministic() as warned:
        check = arms()
        losses = [[fn(i) for i in range(3)] for _, fn in check]
    hold(label, "3 steps fed by the DataLoader against feed dicts, losses "
         "(warm-up, capture, replay)", max(map(distance, *losses)), 0.0)
    if warned:
        raise AssertionError(f"{label}: {warned}")
    del check
    turns = arms()
    for _, fn in turns:
        for i in range(2):  # warm-up and capture
            fn(i)
    med = in_turns([(n, lambda i, fn=fn: float(fn(i))) for n, fn in turns],
                   list(range(LOADER_ROUNDS)), start=1)
    busy = [device_rows(lambda fn=fn: float(fn(0)))[1] for _, fn in turns]
    log(f"{label}: ResNet-50 AMP at batch {RESNET_BATCH} "
        f"({RESNET_BATCH * int(np.prod(RESNET_IMAGE)) * 4 / 1e6:.1f} MB "
        f"fp32 images a step), {LOADER_ROUNDS} rounds in turns, medians of "
        f"rounds 1-{LOADER_ROUNDS - 1}: " + ", ".join(
            f"{n} {ms:.2f} ms ({RESNET_BATCH / ms * 1e3:.1f} images/s; one "
            f"traced step {b:.2f} ms of device time, the card idle "
            f"{max(0.0, 1 - b / ms):.1%})"
            for (n, _), ms, b in zip(turns, med, busy))
        + f"; the DataLoader {med[0] / med[1]:.3f}x [{smi}]")
    calls = no_flash(label, lambda: float(turns[1][1](0)))
    exe.close()
    return calls


def py_reader_path():
    """Phase 16(D), the program-level reader: a regression trained through
    ``py_reader``/``read_file`` (the ``read`` host op splits the plan;
    the device segment after it captures and replays) against the same
    steps fed as dicts, bitwise; EOF after the last batch. Returns the
    flash wrappers' calls over its runs, (0, 0), and checks a traced
    replay's flash kernels, none."""
    fa.launches = fa.bwd_launches = 0
    def build(feeds):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = SEED
        with unique_name.guard(), pt.program_guard(main, startup):
            if feeds:
                reader = None
                x = pt.layers.data("x", shape=[256])
                y = pt.layers.data("y", shape=[1])
            else:
                reader = pt.layers.py_reader(
                    capacity=4, shapes=[[-1, 256], [-1, 1]],
                    dtypes=["float32", "float32"], name="chip_reader")
                x, y = pt.layers.read_file(reader)
            h = pt.layers.fc(x, size=512, act="relu")
            loss = pt.layers.mean(pt.layers.square_error_cost(
                pt.layers.fc(h, size=1), y))
            pt.optimizer.SGD(learning_rate=0.01).minimize(loss)
        return main, startup, reader, loss

    rng = np.random.RandomState(SEED)
    data = [(rng.rand(64, 256).astype(np.float32),
             rng.rand(64, 1).astype(np.float32)) for _ in range(6)]
    exe = pt.Executor()
    main, startup, reader, loss = build(False)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    reader.decorate_batch_generator(lambda: iter(data))
    caps = dict(exe.capture_stats)
    got = []
    with deterministic() as warned, pt.scope_guard(scope):
        reader.start()
        while True:
            try:
                got += run_tensors(exe, main, fetch_list=[loss])
            except pt.core.EOFException:
                reader.reset()
                break
        fmain, fstart, _, floss = build(True)
        fscope = pt.Scope()
        exe.run(fstart, scope=fscope)
        want = [run_tensors(exe, fmain, feed={"x": x, "y": y},
                            fetch_list=[floss], scope=fscope)[0]
                for x, y in data]
    kinds = [k for k, _ in next(iter(main.__dict__["_exec_cache"].values()))
             .segments]
    made = exe.capture_stats["captures"] - caps["captures"]
    log(f"  16(D) py_reader: {len(got)} steps then EOF; segments {kinds}; "
        f"{made} captures for both programs")
    hold("16(D) py_reader", "losses against the same steps fed as dicts",
         max(map(distance, got, want)) if len(got) == len(want) else
         float("inf"), 0.0)
    if kinds != ["host", "device"] or warned or (
            exe.device.type == "cuda" and made != 2):
        raise AssertionError(f"16(D) py_reader: segments {kinds}, "
                             f"{made} captures, {warned}")

    def replay():
        with pt.scope_guard(scope):
            reader.start()
            run_tensors(exe, main, fetch_list=[loss])
            reader.reset()

    calls = no_flash("16(D) py_reader", replay)
    exe.close()
    return calls


def runtime_paths(smi):
    """Phase 16; returns the flash launches of its paths."""
    t0 = time.perf_counter()
    out = {"elastic_training": elastic_path(smi)}
    release()
    t1 = time.perf_counter()
    out["grad_accumulation"] = accumulation_path(smi)
    release()
    t2 = time.perf_counter()
    out["dropout"] = dropout_path(smi)
    release()
    t3 = time.perf_counter()
    out["data_loader"] = tuple(a + b for a, b in zip(loader_path(smi),
                                                     py_reader_path()))
    release()
    log(f"16: (A) {t1 - t0:.1f} s, (B) {t2 - t1:.1f} s, (C) {t3 - t2:.1f} "
        f"s, (D) {time.perf_counter() - t3:.1f} s")
    return out


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--profile", action="store_true")
    args.add_argument("--kernels", action="store_true",
                      help="phases 1-4 only, then the kernels line and no "
                      "contract line")
    # one process of phase 16(A), started by the phase itself
    args.add_argument("--elastic-child", nargs=3, help=argparse.SUPPRESS,
                      metavar=("ROLE", "CKPT", "OUT"))
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.elastic_child:
        elastic_child(*args.elastic_child)
        return 0
    # cuBLAS's deterministic workspace, for phase 11's bitwise gates; read
    # when the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    bert_errs, bwd_bert_errs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (q, k, v, kb), causal) in enumerate(kernel_cases(dtype)):
            err = check_case(name, q, k, v, kb, causal)
            if i < 3:
                errs[dtype] = max(errs.get(dtype, 0.0), err)
            if name.startswith("bert"):
                bert_errs[dtype] = err
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (q, k, v, kb), causal) in enumerate(bwd_cases(dtype)):
            err = check_bwd_case(f"bwd {name}", q, k, v, kb, causal)
            if i < 3:
                bwd_errs[dtype] = max(bwd_errs.get(dtype, 0.0), err)
            if name.startswith("train"):
                bwd_train_errs[dtype] = max(bwd_train_errs.get(dtype, 0.0),
                                            err)
            if name.startswith("bert"):
                bwd_bert_errs[dtype] = err

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

    bert_fwd, bert_bwd = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for rows, fn, what in ((bert_fwd, time_kernel, "fwd"),
                               (bert_bwd, time_bwd, "bwd")):
            row = rows[dtype] = fn(dtype, False, BERT_SHAPE)
            log(f"{what} {list(BERT_SHAPE)} (BERT) {str(dtype)[6:]:<8} "
                f"kernel {row['ms']:.4f} ms (eager calls "
                f"{row['eager_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
                f"sdpa {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")

    if args.profile:
        for shape in (MAIN_SHAPE, TRAIN_SHAPE):
            for dtype in (torch.float32, torch.bfloat16):
                profile_bwd(dtype, shape)

    paths = {}  # path -> (forward, backward) launches
    if not args.kernels:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_model_",
                                         dir=_build.BUILD_DIR) as model_dir, \
                tempfile.TemporaryDirectory(prefix="chip_smoke_resnet_",
                                            dir=_build.BUILD_DIR) as rdir:
            phase("serving: Transformer-base through NativePredictor")
            served = main_path(model_dir, args.profile)
            paths["serving"] = (served["launches"], 0)
            cfg = served["cfg"]
            release()
            phase("training: Transformer-base train steps on Executor()")
            trained = training_path(args.profile)
            paths["training"] = trained["launches"]
            release()
            phase("training through CompiledProgram (bench BuildStrategy, "
                  "unfused attention)")
            paths["compiled_training"] = compiled_training_path(
                trained, args.profile)
            del trained
            release()
            phase("serving through AnalysisPredictor (IR passes, bf16)")
            paths["analysis_serving_bf16"] = (
                analysis_serving_path(model_dir, served, args.profile), 0)
            del served
            release()
            paths.update(resnet_paths(rdir, smi, args.profile))
            phase("whole-step capture: captured against eager "
                  "(FLAGS.jit_cache = False) on every path")
            paths.update(capture_paths(model_dir, rdir, smi, args.profile))
            phase("BERT-base pretraining through CompiledProgram (bench "
                  "BuildStrategy, batch 16, T 128): Adam fp32 and AMP, LAMB "
                  "AMP")
            paths.update(bert_paths(smi, args.profile))
            release()
            phase("the serving front: BucketedPredictor and "
                  "BatchingPredictor over bf16 Transformer-base and "
                  "ResNet-50, the executor under threads")
            paths.update(front_paths(model_dir, rdir, cfg, smi))
            release()
            phase("generation: build_lm at the Transformer-base widths "
                  "through DecodeEngine, dense, paged and paged with prefix "
                  "reuse, each decode chunk a captured CUDA graph")
            paths.update(generation_paths(smi)[0])
            release()
            phase("generation behind the serving front (GenerationPredictor, "
                  "paged with prefix reuse and dense) and beam search (the "
                  "machine-translation decode, its While captured)")
            paths.update(predictor_and_beam_paths(smi)[0])
            release()
            phase("the runtime around the training step: ElasticTrainer "
                  "with async cadence checkpoints, SIGKILL and resume, "
                  "SIGTERM; gradient accumulation; dropout; the DataLoader")
            paths.update(runtime_paths(smi))
            release()

    def bert_shape(rows, errors, per_step):
        return {"shape": list(BERT_SHAPE), "launches_per_step": per_step,
                "max_abs_err": {str(dt)[6:]: e for dt, e in errors.items()},
                **{str(dt)[6:]: row for dt, row in rows.items()}}

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
               "launches_per_step": FWD_PER_STEP,
               "bert_shape": bert_shape(bert_fwd, bert_errs,
                                        BERT_FWD_PER_STEP)}),
        entry("flash_attention_bwd",
              "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
              "paddle_tpu/ops/pallas_attention.py:213", bwd_timing, bwd_errs,
              1,
              {"launches_per_request": 0,
               "launches_per_step": BWD_PER_STEP,
               "bert_shape": bert_shape(bert_bwd, bwd_bert_errs,
                                        BERT_BWD_PER_STEP),
               "train_shape": dict(
                   shape=list(TRAIN_SHAPE),
                   max_abs_err={str(dt)[6:]: e
                                for dt, e in bwd_train_errs.items()},
                   **{f"{str(dt)[6:]}{'_causal' if c else ''}": row
                      for (dt, c), row in bwd_train.items()})}),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.kernels:
        log("--kernels: phases 1-4 only; no contract line")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
