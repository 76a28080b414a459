#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # the contract run
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown of
                                     # one request by device kernel
    python3 chip_smoke.py --kernels  # phases 1-4 only: the short loop for
                                     # work on a kernel

Phases, in order; any failure exits non-zero and no phase is skipped:

1. device: a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them. TF32 is switched off, so float32
   products are full float32 on both sides of every comparison.
2. build: compiles every kernel of the path from ``paddle_tpu_torch/csrc``
   and prints each kernel's registers, stack frame (where spills go) and
   tensor-core (``HMMA``) instructions, all read from the built library;
   fails on a kernel with no ``HMMA`` or, at the model path's head width,
   with a stack frame.
3. kernels against their plain versions on the card, at the model path's
   shape [8, 8, 256, 64] in float32 and bfloat16 and at shapes that reach
   every head-dim tier, ragged KV stages and unaligned rows.
4. kernel timing at [8, 8, 256, 64], each the card's time per call from
   a CUDA-graph replay of 30 calls (the kernel's eager back-to-back time,
   host cost included, beside it): kernel, plain version, one library
   call (``scaled_dot_product_attention``, timed as a yardstick and never
   called by the port) and the bound from the card's data-sheet rates:
   float32 takes three TF32 tensor-core products per product
   (3 * flops at 495 TFLOP/s; the CUDA-core bound at 67 TFLOP/s is kept
   beside it), bfloat16 one (flops at 495 TFLOP/s; 989 TFLOP/s beside it).
5. the main path: Transformer-base (the bench_transformer widths, random
   weights from a seed) built with the port's layers, initialized on the
   card, saved as an inference model and served by
   ``create_paddle_predictor(NativeConfig(dir))``: 4 requests of batch 8
   with mixed source and target lengths, then a batch-1 request replayed
   through a CPU predictor on the same directory.

The line before the last lists every ported kernel with its launches on
the main path (null under ``--kernels``); the last line is the device
record.
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
from paddle_tpu_torch.inference import NativeConfig, create_paddle_predictor
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa

SEED = 2024
FEEDS = ["src_word", "src_pos", "trg_word", "trg_pos", "src_len", "trg_len"]
# bench_transformer widths: 6 + 6 layers, d_model 512, 8 heads, seq 256
MODEL = dict(src_vocab=32000, tgt_vocab=32000, max_len=256, n_layer=6,
             n_head=8, d_model=512, d_inner_hid=2048, dropout_rate=0.0)
MAIN_SHAPE = (8, 8, 256, 64)     # [B, H, T, D] of every attention per request
LAUNCHES_PER_REQUEST = 18        # 6 encoder self + 6 decoder self + 6 cross

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
    """flash_fwd_kernel<float, 64> from its mangled name."""
    m = re.search(r"(\w+_kernel)I(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if not m:
        return mangled[:60]
    name = re.sub(r"^.*\d(?=[a-z])", "", m.group(1))  # drop the namespace
    return f"{name}<{'float' if m.group(2) == 'f' else 'bf16'}, {m.group(3)}>"


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
    before = fa.launches
    t0 = time.perf_counter()
    logits = pred.run(feed)[0].as_tensor()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = fa.launches - before
    want = [len(feed["src_word"]), cfg["max_len"], cfg["tgt_vocab"]]
    if list(logits.shape) != want or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {list(logits.shape)} (want {want}) "
                             "or not finite")
    if launched != LAUNCHES_PER_REQUEST:
        raise AssertionError(f"{launched} flash_attention_fwd launches in "
                             f"one request, want {LAUNCHES_PER_REQUEST}")
    return logits, ms


def main_path(model_dir, profile):
    fa.launches = 0
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
    n_params = sum(t.numel() for t in scope._vars.values())
    log(f"startup on {exe.device} + save: {time.perf_counter() - t0:.2f} s, "
        f"{n_params} parameters")

    pred = create_paddle_predictor(NativeConfig(model_dir))
    steady_ms = []
    for i in range(4):
        feed = make_request(cfg, 8, SEED + i)
        _, ms = serve(pred, feed, cfg)
        if i:
            steady_ms.append(ms)
        tokens = int(feed["trg_len"].sum())
        log(f"request {i}: batch 8, {ms:.2f} ms, {tokens} target tokens, "
            f"{tokens / ms * 1e3:.1f} target tokens/s"
            f"{' (first request)' if i == 0 else ''}")
    one = {k: v[:1] for k, v in make_request(cfg, 8, SEED + 10).items()}
    gpu_logits, _ = serve(pred, one, cfg)
    launches = fa.launches
    if launches != 5 * LAUNCHES_PER_REQUEST:
        raise AssertionError(f"{launches} launches on the main path")

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
    return launches


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


def profile_request(pred, feed, model_dir, steady_ms):
    """Device time of one request by kernel, against the request's
    unprofiled wall time and its operations bound. Only the device-side
    rows are summed: the aten op that launched a kernel carries the same
    time again as its own self device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        pred.run(feed)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e3
    if not busy:
        raise RuntimeError("the profiler recorded no device time")
    with open(os.path.join(model_dir, "__model__"), "rb") as f:
        blk = ProgramDesc.from_bytes(f.read()).blocks[0]
    n_ops = sum(op.type not in ("feed", "fetch") for op in blk.ops)
    flops = request_flops(blk, len(feed["src_word"]))
    log(f"profile of one batch-8 request through the {n_ops} ops of the "
        f"saved program: {busy:.3f} ms of device time by "
        f"kernel; median steady request {steady_ms:.3f} ms wall, so the "
        f"card is idle {max(0.0, 1 - busy / steady_ms):.1%} of it")
    log(f"request operations {flops / 1e9:.1f} GFLOP: fp32 bound "
        f"{flops / CUDA_CORE_FP32_FLOPS * 1e3:.3f} ms at the data-sheet "
        f"67 TFLOP/s")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% "
            f"x{count:<4} {key[:90]}")


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
    log(f"built {sorted(info)} in {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        report = kernel_report(name)
        for kname, row in sorted(report.items()):
            log(f"  {name}: {kname}: {row['registers']} registers, "
                f"{row['stack_bytes']} bytes of stack frame, {row['hmma']} "
                f"HMMA of {sum(row['opcodes'].values())} SASS instructions")
            if f", {MAIN_SHAPE[3]}>" in kname:
                top = sorted(row["opcodes"].items(), key=lambda x: -x[1])[:10]
                log("    most frequent: " + ", ".join(f"{o} {n}" for o, n in top))
        if not report or any(r["hmma"] == 0 for r in report.values()):
            raise AssertionError(f"{name}: a kernel runs no tensor-core "
                                 "instruction (HMMA count 0 in its SASS)")
        if any(r["registers"] is None for r in report.values()):
            raise AssertionError(f"{name}: cuobjdump -res-usage gave no "
                                 "registers for a kernel")
        if any(r["stack_bytes"] for k, r in report.items()
               if f", {MAIN_SHAPE[3]}>" in k):
            raise AssertionError(f"{name}: a stack frame (spills) at "
                                 f"D = {MAIN_SHAPE[3]}")

    phase("kernels against their plain versions")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (q, k, v, kb), causal) in enumerate(kernel_cases(dtype)):
            err = check_case(name, q, k, v, kb, causal)
            if i < 3:
                errs[dtype] = max(errs.get(dtype, 0.0), err)

    phase("kernel timing at [8, 8, 256, 64]")
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            row = timing[dtype, causal] = time_kernel(dtype, causal)
            other = ("fp32 CUDA cores 67" if dtype == torch.float32
                     else "bf16 tensor cores 989")
            log(f"{str(dtype)[6:]:<8} causal={int(causal)} kernel "
                f"{row['ms']:.4f} ms (eager calls {row['eager_ms']:.4f} ms), "
                f"plain {row['plain_ms']:.4f} ms, "
                f"sdpa {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}, TF32 495 "
                f"TFLOP/s), {row['bound_other_ms']:.4f} ms at the {other} "
                f"TFLOP/s")

    launches = None
    if not args.kernels:
        phase("main path: Transformer-base through NativePredictor")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_model_",
                                         dir=_build.BUILD_DIR) as model_dir:
            launches = main_path(model_dir, args.profile)

    fp32 = dict(timing[torch.float32, False])
    bf16 = dict(timing[torch.bfloat16, False])
    fp32_cuda_cores = fp32.pop("bound_other_ms")
    bf16["bound_ms_bf16_rate"] = bf16.pop("bound_other_ms")
    bf16["causal_ms"] = timing[torch.bfloat16, True]["ms"]
    kernel = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_attention.py:43",
        "launches": launches, "max_abs_err": errs[torch.float32],
        "ms": fp32["ms"], "kernel_ms": fp32["ms"],
        "plain_ms": fp32["plain_ms"], "bound_ms": fp32["bound_ms"],
        "bound_by": fp32["bound_by"], "library_ms": fp32["library_ms"],
        "bound_ms_cuda_cores": fp32_cuda_cores, "eager_ms": fp32["eager_ms"],
        "causal_ms": timing[torch.float32, True]["ms"],
        "dtype": "float32", "shape": list(MAIN_SHAPE),
        "bf16": dict(bf16, max_abs_err=errs[torch.bfloat16]),
    }
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
