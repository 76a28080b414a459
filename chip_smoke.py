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
    python3 chip_smoke.py --phase 25 # phases 1-2, then phase 25 alone
                                     # (any of 12 and 14-25), its seconds
                                     # and launches; no contract line

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
   (``FLAGS.jit_cache = False``) on Transformer-base's widths at 2 + 2
   layers (CUT_LAYERS) through
   ``CompiledProgram`` (bench BuildStrategy, batch 16, T 256, fp32 and
   AMP), ResNet-50 AMP through ``CompiledProgram`` (batch 128), and
   ``AnalysisPredictor`` bf16 serving of Transformer-base (batch 8) and
   ResNet-50 (batch 128), under ``torch.use_deterministic_algorithms``
   (warnings name any op without a deterministic implementation) with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``. On each path: 3 captured runs
   against 3 eager runs from the same state, losses or outputs and every
   persistable bitwise; step 1's ``FetchHandle`` read after the last step;
   a ``load_persistables`` (in place: the graph stays) and a ``set_var``
   of every persistable (a rebinding: the graph is dropped and captured
   anew) between runs, the next steps bitwise against eager ones (serving:
   a ``set_var`` of a weight and its restore); ``run(iterations=2)``
   (eager, then captured) against single runs, bitwise (training); one
   replay traced by torch.profiler, its flash kernels counted by name
   against 12 forward + 18 backward per train step and 18 per request,
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
   30522, T 128, 20 masked slots, 12 heads, d_model 768, its 12 layers
   cut to 4,
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
   peak memory; 8 forward + 12 backward flash launches a step counted
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

16. the runtime around the training step, after phase 15: (A)
   Transformer-base's widths at 2 + 2 layers, AMP, under
   ``ElasticTrainer`` in three child processes (one SIGKILLed and
   resumed bitwise; the resumed one started beside it, restoring once
   it is killed), (B) gradient accumulation K = 1, 2, 4 at 2 + 2
   layers, (C) dropout at 2 + 2 layers, (D) the
   ``DataLoader`` and a ``py_reader`` program on ResNet-50 AMP.

17. the model zoo, after phase 16, each model at its JAX build's
   defaults through ``CompiledProgram`` under bench.py's BuildStrategy,
   ZOO_RUNS steps (DeepFM DEEPFM_RUNS) captured against eager from the
   same state and generator, bitwise (fetches and every persistable,
   deterministic mode), ZOO_TRACED replays traced (device time, idle
   share, no flash kernel), peak memory, rows, images or tokens per second: (A)
   DeepFM, fp32, batch 2048: 64 steps, the ``auc`` op's int64 stat
   buckets equal to a numpy recount of the fed labels in the buckets of
   the fetched probabilities, past 2^31 positive x negative pairs, the
   fetched AUC within 1e-6 of a float64 numpy AUC of them, and the test
   program's ``predict`` served by ``AnalysisPredictor`` (its
   ``fusion_repeated_fc_relu``) within 1e-5 of the executor's; (B) MNIST
   LeNet, batch 64, the loss halving over 50 steps on one batch; (C)
   SE-ResNeXt-50 (224x224, 102 classes, dropout 0.5) at batch 32 and
   VGG-16 at cifar10 at batch 128, AMP, and a batch-2 SE-ResNeXt-50 AMP
   step replayed op by op on the CPU at phase 9's per-op bounds (the
   CPU's dropout mask under the card's arithmetic); (D) the stacked LSTM
   (dict 5000, width 512, 3 layers, T 100), fp32, batch 32, its ``lstm``
   op on the card against the CPU within 1e-5 relative, its softmax
   served by ``AnalysisPredictor`` with the default passes
   (``fused_embedding_fc_lstm``) and without ``fc_fuse_pass``
   (``fusion_lstm`` as well), each within 1e-5 of the executor's; then
   fit_a_line, word2vec, recommender and both understand_sentiment nets.

18. recurrent training and structured prediction, after phase 17, each
   path through ``CompiledProgram`` under bench.py's BuildStrategy,
   REC_RUNS steps on one batch (the While WHILE_STEPS on a new batch
   each) captured against eager from the same state, bitwise (fetches and
   every persistable, deterministic mode), the loss falling, ZOO_TRACED
   replays traced (device time, kernels, idle share, no flash kernel),
   peak memory, tokens or rows per second: (A) ``machine_translation``
   at the Fluid benchmark's widths (MT: 30000-word dictionaries, 512
   wide, max_len 50), fp32, Adam, batch 32 (the decoder one
   ``recurrent`` op of 50 steps, its backward the generic vjp of the
   whole loop); then phase 15's decode program on the trained scope, 3
   captured runs against 2 eager bitwise, and ROADMAP C4's probes through
   ``top_k`` and ``beam_search`` on the card against the JAX package's
   results (literals here); (B) ``label_semantic_roles`` at the book's
   widths (SRL: hidden 512, eight lstm layers, T 40, 59 labels), batch
   10 of conll05 rows, SGD, and the test program's ``crf_decoding``
   paths equal to a numpy Viterbi of the card's emissions; (C)
   tests/test_control_flow.py's bounded While (y = x * w^2,
   max_trip_count 4) at batch 4096, 40 SGD steps, the last loss below
   0.2 of the first, and the float64 build's ``while_grad`` within
   WHILE_FD_REL of central differences of its loss on the card.

19. conditional control flow, the sequence ops and CTC, after phase 18:
   (A) Fluid's ocr_recognition CRNN-CTC (``testing.models.crnn_ctc``:
   [1, 48, 512] images, conv groups of 16/32/64/128 filters,
   ``im2sequence`` to 32 steps of 384, GRU 200 each way, 96 classes,
   ``warpctc`` normalised by time, Momentum with L2), batch 32, through
   ``CompiledProgram``: REC_RUNS steps captured against eager bitwise, the
   loss falling over CRNN_STEPS steps on one batch, the test program
   (``ctc_greedy_decoder``, ``edit_distance``) captured against eager
   bitwise with its distances a numpy Levenshtein's, and ``warpctc`` within
   CTC_YARDSTICK_REL of ``F.ctc_loss`` (a yardstick the port never calls);
   (B) test_mnist_if_else_op.py's ``IfElse`` program, batch 128, captured
   against eager, one device segment in one graph, the merged rows the
   branches' where; (C) its ``Switch`` piecewise learning rate equal to
   numpy's at every captured step across three boundaries, and a
   hand-built ``conditional_block`` captured on one branch and replayed
   on the other; (D) the op bank: each of the slice's 36 types on the card
   against the CPU (batch 64, T 128, width 256, rows of length 0, 1 and T),
   the gradful ones' vjps too; (E) a text CNN of ``sequence_conv(relu)``
   served by ``AnalysisPredictor``, rewritten to the JAX pipeline's op
   list (``fusion_seqconv_eltadd_relu``) and within SERVE_TOL of
   ``NativePredictor``.

20. object detection, after phase 19: (A) PaddleCV's MobileNet-SSD on
   Pascal VOC (``testing.models.mobilenet_ssd``: 300x300, 21 classes,
   MobileNet v1 at scale 1.0, six prior maps and 1917 priors,
   ``ssd_loss`` summed, RMSProp with L2Decay on train.py's piecewise
   rate), batch 32 with 1-8 gt boxes an image, through ``CompiledProgram``:
   REC_RUNS steps captured against eager bitwise, the loss falling over
   SSD_STEPS steps on one batch; (B) its test program on the trained
   scope (``detection_output``, ``detection_map`` 11point) captured
   against eager bitwise, the program's mAP equal to
   ``metrics.DetectionMAP`` over the fetched detections, and the
   inference model served by ``AnalysisPredictor`` fp32 against
   ``NativePredictor`` (the NMS inputs within DET_SERVE_TOL, each
   predictor's rows bitwise ``multiclass_nms`` on its own inputs, the
   rows equal class by class up to a tie at a cut, at least
   DET_SERVE_SHARE of them compared), on the trained scope and on the
   initial weights; (C)
   the three YOLOv3 scales for a 608 input on seeded backbone features,
   batch 8, captured against eager bitwise, then the ``yolo_box`` +
   ``multiclass_nms`` decode; (D) the op bank: the 33 detection types on
   the card against the CPU at realistic shapes (a Faster R-CNN C4 map
   of [1, 1024, 50, 84] with 15 anchors a cell, ``generate_proposals`` at
   6000/1000, ``roi_align`` 14x14 over 512 rois, ``multiclass_nms`` at
   [32, 21, 1917]), the gradful ones' vjps, the random ops' samples at
   their budgets, and kernels and ms a call of the two NMS ops.
21. the general tensor, loss and RNN-unit ops, after phase 20: (A) the
   Transformer of PaddlePaddle/models' PaddleNLP neural_machine_translation
   (``testing.models.transformer_label_smooth``: its loss smooths
   ``one_hot(label)`` with epsilon 0.1 and takes a soft-label
   ``softmax_with_cross_entropy``) at Transformer-base's widths, batch
   16, fp32 and AMP through ``CompiledProgram`` under bench.py's
   BuildStrategy: REC_RUNS steps captured against eager bitwise, the
   loss falling on one batch, the step's graph holding exactly 36
   forward and 54 backward flash kernel nodes (its DOT dump); step ms,
   kernels, idle share, peak memory, and the one-hot, smoothing and
   soft-label cross entropy kernels traced alone; (B) the zoo's word2vec
   with the ``nce`` and the ``hsigmoid`` head (batch 256), captured
   against eager bitwise with the nce draws among the fetches, the loss
   falling; (C) the op bank: the 35 types of ``kernels_tensor``,
   ``kernels_loss`` and ``kernels_rnn`` on the card against the CPU at
   the paths' shapes (``one_hot`` of 16 x 256 ids to 32000,
   ``hierarchical_sigmoid`` at 2073 classes, ``nce`` at word2vec's dict
   given the same samples, ``lstmp`` at hidden 1024 and projection 512),
   the gradful ones' vjps, ``scatter``'s add over repeated ids twice
   under the deterministic mode (bitwise equal), and
   ``truncated_gaussian_random``'s bounds and moments.
22. the image and NN op families, after phase 21: (A) SimpleBaseline
   human pose (Xiao et al. 2018; PaddleCV's human_pose_estimation,
   ``testing.models.pose_resnet``: ResNet-50 without its fc, three 4x4
   stride-2 ``conv2d_transpose`` layers of 256 filters with batch_norm
   and relu, a 1x1 conv to 16 MPII joints; 256x256 images, 64x64
   heatmaps, the target-weighted MSE, Adam at 1e-3), batch 32, fp32 and
   AMP (the head in float32: the op has no AMP cast point) through
   ``CompiledProgram`` under bench.py's BuildStrategy: REC_RUNS steps
   captured against eager bitwise, the loss falling below the first over
   POSE_STEPS steps on one batch, the three deconvolutions' share of each
   step, and the trained scope
   served by ``AnalysisPredictor`` and ``NativePredictor`` against the
   executor; (B) ResNet-50 with ``preprocess=True`` (a raw 252x252x3
   uint8 feed, ``random_crop`` to 224 per example on the device, cast,
   transpose, scale, normalize), AMP, batch 128, captured against eager
   bitwise, then the test program's pipeline on a coded raw batch
   (every crop an exact slice, the network's input its normalization);
   (C) the op bank: the 36 types of ``kernels_image`` and
   ``kernels_nn`` on the card against the CPU at the paths' shapes and
   C3D's [8, 3, 16, 112, 112] clip for the 3-D family, the gradful
   ones' vjps, ``unpool``'s and ``grid_sampler``'s scatter-adds twice
   under the deterministic mode (bitwise equal), and the random types'
   draws (``random_crop``'s offsets exact, in bounds and uniform;
   ``sampling_id``'s counts; the ``*_batch_size_like`` moments).
23. quantization, model compression, ModelAverage and the single-device
   rest of the registry, after phase 22: (A) phase 9's ResNet-50
   (bench_resnet: 224x224, 1000 classes, Momentum, batch 128) in fp32,
   ``QuantizeTranspiler`` (8 bits, moving-average activation scales)
   after minimize, so 54 quantized ops (53 convolutions and the fc's mul)
   behind about 100 fake-quant ops, through ``CompiledProgram`` under
   bench.py's BuildStrategy: REC_RUNS steps captured against eager
   bitwise (the moving scales among the persistables), the fake-quant
   ops' share of the step by graph replay; then its test clone
   (batch_norm statistics calibrated on the batch) frozen to int8
   weights behind ``dequantize_weights`` (each the fake quant's value but
   at rounding ties), saved and served by ``AnalysisPredictor`` and
   ``NativePredictor``, each within QAT_SERVED_REL of the executor's run of
   the frozen program, its distance from the float test program measured;
   (B) the same ResNet-50, AMP,
   pruned and retrained under ``CompressPass`` (``PruneStrategy`` with a
   fixed ``RatioPruner`` mask keeping half of every conv and fc weight,
   built by ``ConfigFactory`` from PRUNE_CONFIG), 2 epochs of 3 batches:
   the loop captured once and bitwise its eager run, the sparsity within
   PRUNE_SPARSITY_TOL of 0.5 and the strategy's count the scope's; (C)
   phase 19's CRNN-CTC with ``ModelAverage(0.15)`` (ocr_recognition's
   windows): CRNN_MA_RUNS steps captured against eager bitwise, the EMAs
   among the persistables, then apply, evaluate and restore twice with a
   train step between, the parameters bitwise their EMAs inside and
   themselves after, the second cycle capturing nothing; (D) the op bank:
   the 26 types on the card against the CPU at the paths' shapes (a
   ResNet-50 activation, TBCNN's trees, a DAM-like attention LSTM over
   [32, 50, 256], ``average_accumulates`` just before its drain and a
   window roll), the fake-quant types' straight-through grads, ``py_func``
   and ``delete_var`` in captured programs, and ``random_data_generator``
   through a ``Preprocessor`` feeding a captured step.
24. imperative (dygraph) mode and the pass verifier, after phase 23: (A)
   ResNet-50 built from ``paddle_tpu_torch.imperative`` layers in the
   shape of Fluid's dygraph ResNet example (``ConvBNLayer``,
   bottlenecks, ``Pool2D``, an ``FC`` to flowers' 102 classes), fed
   batches of 32 from ``dataset.flowers.train()`` through
   ``reader.batch``, 5 fp32 steps of the imperative SGD; its weights are
   a declarative ``models/resnet.py`` build's (each Conv2D bias 0), and
   step 1's loss and every weight's gradient are held against the
   port's eager ``Executor`` on that program (DY_RESNET_REL of each
   gradient's largest magnitude); step ms, a traced step's device ms and
   idle share, peak memory and the ops the tape records a step; (B) a
   Transformer-base encoder at bench_transformer's widths (6 layers,
   d_model 512, 8 heads, d_ff 2048, vocab 32000, T 256, batch 16) from
   ``Embedding``, ``FC`` and ``trace_op`` of ``layer_norm``,
   ``reshape2``, ``transpose2``, ``flash_attention`` and
   ``softmax_with_cross_entropy``, dropout 0.1 from the tracer's
   generator, 5 steps of the imperative Adam, once plain and once with
   every layer under ``recompute``, under the deterministic mode: every
   step's gradients bitwise equal between the two, recompute's peak
   memory below the plain run's, the flash kernels counted by name in a
   trace (6 forward a step plain, 12 under recompute, 18 backward
   kernels), and one attention at [16, 8, 256, 64] through the tape
   against ``plain_attention`` and ``plain_attention_bwd`` within TOL and
   BWD_TOL; (C) phase 11's Transformer (CUT_LAYERS + CUT_LAYERS layers,
   AMP) and phase 9's ResNet-50 AMP through ``CompiledProgram`` under
   bench.py's BuildStrategy with and without ``verify_passes``, VERIFY_RUNS
   runs each from one state: no error, ``check_pass`` once after every
   stage, the rewritten op lists byte-identical and the losses bitwise
   equal; the verification's seconds and the memo's lookup; then the
   program without the writer of its first temporary raises
   ``ProgramVerifyError`` with no device work in the run's trace. The
   whole script runs phase 24 in a process of its own
   (``--imperative-child``), as ``--phase 24`` does: after phases 5-23
   the script's own process lost one flash-forward record in every
   trace of 24(B).
25. observability, after phase 24, in a process of its own
   (``--observability-child``), as ``--phase 25`` runs it: (A) bf16
   Transformer-base (bench_transformer's widths) through
   ``BucketedPredictor`` and ``BatchingPredictor`` over buckets (4, 8),
   the monitor off and then on (a second front, so its plans warm up
   under the monitor and build their kernel tables): each bucket's
   graph the same kernel nodes either way, OBS_REQUESTS requests from 8
   threads a pass (requests/s, p50, p99 of the second pass),
   ``serving_requests_total`` equal to the requests sent, a
   ``profile_session(steps=OBS_WINDOW)`` over that many requests with
   18 flash-forward kernels a device call in the ``flash_attention.*``
   rows, its coverage, lost records and misaligned kernels, and the live
   plane on an ephemeral port (``/metrics``, ``/healthz``, ``/vars``,
   ``/trace?id=``, ``/memory``); (B) Transformer-base AMP training, batch
   16, through ``CompiledProgram`` under bench.py's BuildStrategy,
   captured (36 + 54 flash nodes in the step's graph), a
   ``profile_session(steps=OBS_TRAIN_STEPS)`` over replays: the top
   rows, coverage, lost records, 36 + 54 flash kernels a step in the
   flash rows, measured MFU against the H100 row; the footprint's
   predicted peak against the allocator's eager and captured peaks; the
   pre-flight at half the prediction raising ``MemoryBudgetExceeded``
   naming the op at peak with no device work; a fault delay of
   OBS_DELAY_S at two steps warning once (the repeat counted) and the
   escalation's capture writing one ``slow_step_profile`` flight
   record; (C) ``GenerationPredictor`` over phase 14's ``build_lm`` with
   ``FLAGS.memory_budget_bytes`` set at construction so that the dense
   table's cap downshifts, the (slots, cap) ``max_fitting_config``
   picks, and every request resolved.

Flash launches (phases 5-8, 11, 12, 13, 24(B) and 24(C)) are counted by kernel name in a
torch.profiler trace of each path's runs, with the wrappers' counts zeroed
just before: a replay of a captured graph launches the kernels without
calling the wrappers, whose counts then cover the eager runs and the
captures, and must not be 0 where the path runs a kernel. The step and
request times of phases 5-8 are taken under that trace; the turns of
phases 7, 9 and 11 are not. ResNet-50 (phases 9-10) and generation
(phases 14-15), the model zoo (17), recurrent training (18), phases
19, 20, 21(B-C), 22, 23 and 24(A) hold the wrappers' counts at 0: no call, so no
flash kernel in any graph either. 21(A) counts the kernels of its step's
graph from the graph's DOT dump, as 16(B) does.

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
import math
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
from paddle_tpu_torch.dataset import conll05, flowers
from paddle_tpu_torch.ir import verify as pverify
from paddle_tpu_torch.models import (bert, deepfm, fit_a_line,
                                     label_semantic_roles,
                                     machine_translation, mnist, recommender,
                                     resnet, se_resnext, stacked_lstm,
                                     transformer, understand_sentiment, vgg,
                                     word2vec)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.kernels_nn import _dropout_apply
from paddle_tpu_torch.testing import models as tmodels
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
# the depth of the paths that hold the runtime around a train step, not
# the model (phase 11's training paths, 16(A) and 16(B)): MODEL's widths
# at 2 + 2 layers, cut from 6 + 6 to keep the script well within its
# time limit (phases 5-7 and 21(A) train all 6 + 6)
CUT_LAYERS = 2


def cut_model():
    """MODEL at CUT_LAYERS + CUT_LAYERS layers."""
    return dict(MODEL, n_layer=CUT_LAYERS)


def flash_per_step(n_layer):
    """(forward, backward) flash launches of a train step of an n_layer +
    n_layer Transformer, as FWD_PER_STEP and BWD_PER_STEP count them."""
    per_request = 3 * n_layer  # encoder self, decoder self, cross
    return 2 * per_request, per_request * fa.BWD_KERNELS


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


_START = time.perf_counter()


def phase(name):
    """A phase's header, with the seconds since the script started."""
    log(f"== {name} [{time.perf_counter() - _START:.1f} s]")


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


def kernel_rows(prof):
    """The device-side rows of a torch.profiler trace, {name: [device us,
    count]}, as ``key_averages()`` gives them (an async record counted
    but timed 0), read from the trace's kineto events. key_averages
    builds a FunctionEvent and its tree for every record first, some 75
    us of host time each: seconds for one traced eager step, tens of
    seconds for a traced training path of 150k kernels."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name
    raw = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CPU
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        row = raw.setdefault(e.name(), [0.0, 0])
        if not e.is_async() and e.start_thread_id() == e.end_thread_id():
            row[0] += (e.end_ns() - e.start_ns()) / 1e3
        row[1] += 1
    rows = {}
    for name, (us, n) in raw.items():
        row = rows.setdefault(_rewrite_name(name, with_wildcard=True),
                              [0.0, 0])
        row[0] += us
        row[1] += n
    return rows


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
    rows = [(k, n) for k, (_, n) in kernel_rows(prof).items()]
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
    values (a ``dropout`` op: the CPU's mask, drawn from a seeded CPU
    generator, under the card's arithmetic; no other random op): every output within ``rel[op type]`` (by default
    ``rel["*"]``, by default OP_REPLAY_REL) of its largest magnitude on
    the CPU, or of the magnitude ``tops[op type](ins, attrs)`` gives by
    output slot. Returns the CPU run's values by name."""
    rel = rel or {"*": OP_REPLAY_REL[amp]}
    tops = tops or {}
    cpu = torch.device("cpu")
    ctx_cpu = pt.registry.EmitContext(
        cpu, generator=torch.Generator().manual_seed(SEED), amp=amp)
    ctx_card = pt.registry.EmitContext(device, amp=amp)
    env = {n: pt.executor._coerce_feed(v, n, block, cpu)
           for n, v in feed.items()}
    worst, n_out, t0 = {}, 0, time.perf_counter()
    with torch.no_grad():
        for op in ops:
            if op.type != "dropout" and pt.registry.has_op(op.type) and \
                    pt.registry.lookup(op.type).needs_rng:
                raise AssertionError(f"{op.type} draws random numbers")
            emit = pt.executor._emitter(op.type)
            ins = {slot: [None if not n else env[n] if n in env
                          else scope.find_var(n) for n in names]
                   for slot, names in op.inputs.items()}
            want = emit(ctx_cpu, ins, op.attrs)
            if op.type == "dropout":
                # the CPU's mask under the card's arithmetic
                xv = ins["X"][0].to(device)
                mask = want["Mask"][0].to(device)
                got = {"Out": [_dropout_apply(
                    xv, mask.to(xv.dtype),
                    float(op.attrs.get("dropout_prob", 0.5)),
                    op.attrs.get("dropout_implementation",
                                 "downgrade_in_infer"))], "Mask": [mask]}
            else:
                got = emit(ctx_card, {
                    slot: [None if v is None else v.to(device) for v in vals]
                    for slot, vals in ins.items()}, op.attrs)
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
    torch.profiler: device-side rows only, from ``kernel_rows``."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(k, us, n) for k, (us, n) in kernel_rows(prof).items() if us > 0]
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

# captured runs against eager runs, per path, and run(iterations=K)
# against K single runs: 5 and 4 before phase 21 came, cut to give back
# its time (a warm-up, a capture and two replays in each arm, and one
# eager and one captured K-step run, are what the gates read); the
# captured arm is held bitwise against one eager arm (a second eager arm,
# whose distance from the first was the bound, went with the cut: the
# deterministic mode made it 0 in every run)
CAPTURE_RUNS = 4
CAPTURE_K = 2
RNG_RUNS = 5       # the uniform_random program's runs (cheap: not cut)
TURN_ROUNDS = 3    # rounds of the arms in turns, per path (4 before)


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


TRACE_TRIES = 3        # traces of one replay before a short count fails


def check_trace(label, fn, want):
    """One replay traced by torch.profiler: its flash kernels counted by
    name against ``want`` (forward, backward). A replay of a captured
    graph launches the same kernels every time, but the profiler drops
    records in some processes (PERF.md §7), so a reading below ``want``
    is traced again, up to TRACE_TRIES times; a reading above it, or
    every reading below it, fails. Returns the call's device ms."""
    for attempt in range(1, TRACE_TRIES + 1):
        rows, busy = device_rows(fn)
        traced = (sum(r[2] for r in rows if "flash_fwd_kernel" in r[0]),
                  sum(r[2] for r in rows if "flash_bwd_" in r[0]))
        log(f"  {label}: one replay traced: {busy:.3f} ms of device time, "
            f"flash launches {traced[0]} forward + {traced[1]} backward by "
            f"kernel name; want {want[0]} + {want[1]}"
            + (f" (trace {attempt})" if attempt > 1 else ""))
        if traced == tuple(want):
            return busy
        if attempt == TRACE_TRIES or any(
                t > w for t, w in zip(traced, want)):
            raise AssertionError(f"{label}: flash launches per replay "
                                 f"{traced}, want {want}")


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
    """Phase 11 on one training path: CAPTURE_RUNS captured steps
    against as many eager steps from the same state, losses and every
    persistable bitwise; step 1's FetchHandle read after the last step; a
    load_persistables and then a set_var of every persistable between
    runs; run(iterations=K) against K single runs; one replay traced;
    then the two arms in turns. ``want``: flash launches per step."""
    exe = pt.Executor()
    steps = 0
    stats0 = dict(exe.capture_stats)
    with traced_launches() as counted, deterministic() as nondeterministic:
        arms = {}
        for arm in ("eager", "captured"):
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
        eager, cap = arms["eager"], arms["captured"]
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

        hold(label, "captured step-1 loss, read after the last step, against "
             "eager",
             distance(losses(cap)[1], losses(eager)[1]), 0.0)
        hold(label, f"captured losses of {CAPTURE_RUNS} steps against eager",
             max(map(distance, losses(cap), losses(eager))), 0.0)
        log(f"  {label}: losses " + ", ".join(
            f"{float(h):.6f}" for h in eager["losses"]))
        ce, differ = scope_distance(cap["scope"], eager["scope"])
        hold(label, f"captured against eager, {len(state)} persistables "
             f"after {CAPTURE_RUNS} steps ({len(differ)} differ)", ce, 0.0)

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
                 "and 2 steps", ce, 0.0)

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
    med = turns_logged(label, turns, feeds[:TURN_ROUNDS], unit)
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
    """Phase 11 on one serving path: CAPTURE_RUNS captured requests
    against as many eager ones through one predictor, bitwise, every
    output
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
             max(distance(c, e) for c, e in zip(cap, eager)), 0.0)
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
                               ("captured", pred.run)],
                       requests[:TURN_ROUNDS], unit)
    log(f"  {label}: captured request {med[1]:.2f} ms against {busy:.3f} ms "
        f"of device time: the card idle {max(0.0, 1 - busy / med[1]):.1%} "
        f"of it; eager {med[0]:.2f} ms, {med[0] / med[1]:.2f}x [{smi}]")
    if profile:
        _, ebusy = device_rows(lambda: eager_request(requests[0]))
        log(f"  {label}: one eager request {ebusy:.3f} ms of device time: "
            f"the card idle {max(0.0, 1 - ebusy / med[0]):.1%} of it")
    return launches


def capture_rng():
    """A main program with a uniform_random op: RNG_RUNS captured runs
    against as many eager runs, each arm from a fresh scope with the
    program's seed, and
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
        np.float32)} for i in range(RNG_RUNS)]
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
    hold("uniform_random program", f"captured against eager, {RNG_RUNS} "
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
    """Phase 11; returns the flash launches of its paths. Its training
    paths build the Transformer at CUT_LAYERS + CUT_LAYERS layers."""
    paths = {}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_",
                                     dir=_build.BUILD_DIR) as io_dir:
        with unique_name.guard():
            m = transformer.build(attention_impl="unfused", **cut_model())
        m["startup"].random_seed = SEED
        init = pt.Scope()
        pt.Executor().run(m["startup"], scope=init)
        state = {n: init.find_var(n) for n in init.var_names()}
        cfg = m["config"]
        feeds = [train_batch(cfg, TRAIN_BATCH, SEED + 500 + i)
                 for i in range(max(2 * CAPTURE_K, TURN_ROUNDS))]
        tokens = ("target tokens", lambda f: int(f["trg_len"].sum()))
        amp_main = mixed_precision.decorate(m["main"].clone())
        for label, program in (("Transformer compiled fp32", m["main"]),
                               ("Transformer compiled AMP", amp_main)):
            target = pt.CompiledProgram(program,
                                        build_strategy=bench_build_strategy())
            paths[label] = capture_training(
                label, target, program, state, m["loss"].name, feeds, tokens,
                flash_per_step(CUT_LAYERS), io_dir, smi, profile)
            del target
            release()
        del m, amp_main, state, init
        release()

        pred = create_paddle_predictor(AnalysisConfig(model_dir).enable_bf16())
        requests = [make_request(cfg, 8, SEED + 600 + i)
                    for i in range(max(CAPTURE_RUNS, TURN_ROUNDS))]
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
             for i in range(max(2 * CAPTURE_K, TURN_ROUNDS))],
            ("images", lambda f: len(f["data"])), (0, 0), io_dir, smi,
            profile)
        del r, amp_main, state, init
        release()

    pred = create_paddle_predictor(AnalysisConfig(resnet_dir).enable_bf16())
    label = "ResNet-50 AnalysisPredictor bf16"
    paths[label] = (capture_serving(
        label, pred, [{"data": resnet_batch(RESNET_BATCH, SEED + 700 + i)[
            "data"]} for i in range(max(CAPTURE_RUNS, TURN_ROUNDS))],
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
# slots, 12 heads at d_model 768, d_inner 3072, batch 16; its 12 layers
# cut to 4 to keep the script well within its time limit
BERT = dict(vocab_size=30522, max_len=128, max_masked=20, n_layer=4,
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
# bounds, 1e-3 relative in L2 (all together) and 1e-2 of each one's
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
# 16 and 32 before phase 21 came, cut by 8 steps of the killed and the
# uninterrupted child (the resumed one still trains 16 steps)
ELASTIC_KILL_AT = 8    # SIGKILL once a checkpoint of this step or later is
                       # marked and the child has trained past it
ELASTIC_END = 24       # the resumed and the uninterrupted runs end here
ELASTIC_EPOCH = 64     # batches in an epoch of the synthetic reader
ELASTIC_KEEP = 2       # checkpoints kept (each about 1.1 GB of files)
ELASTIC_TIMED = 16     # steps in each arm of the cadence timing
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
    """Phase 16(A)'s trainer in this process: Transformer-base's widths at
    CUT_LAYERS + CUT_LAYERS layers (the unfused build under bench.py's
    BuildStrategy, AMP) from the seeded startup, and a DataLoader over the
    epoch-seeded reader."""
    with unique_name.guard():
        m = transformer.build(attention_impl="unfused", **cut_model())
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
    ``killed`` trains until the parent kills it; ``resumed``, started
    beside it, sets up, waits for the file ``OUT.go`` (the parent makes it
    once the killed child is dead), restores from ``ckpt``, trains to
    ELASTIC_END, writes its results and trains on
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
    while role == "resumed" and not os.path.exists(out + ".go"):
        time.sleep(0.05)
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
        # its checkpoints only once the card is its alone. The resumed one
        # starts now too and restores once the killed one is dead
        ref_p, ref_out = spawn("reference", os.path.join(base, "ref"))
        p, out = spawn("killed", ckpt)
        res_p, res_out = spawn("resumed", ckpt)
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
        p, out = res_p, res_out
        open(out + ".go", "w").close()
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
    want = tuple(2 * n for n in flash_per_step(CUT_LAYERS))
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
    """Phase 16(B): Transformer-base's widths at CUT_LAYERS + CUT_LAYERS
    layers, AMP (the fused build: no pass runs under accumulation, as in
    the JAX package) through CompiledProgram
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
        m = transformer.build(**cut_model())
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
        fwd, bwd = flash_per_step(CUT_LAYERS)
        want = (runs_in * k * fwd, runs_in * k * bwd)
        launches = [a + b for a, b in zip(launches, calls)]

        def replay():
            exe.run(target, feed=feeds[0], fetch_list=[loss_name],
                    scope=cap["scope"])

        # the flash kernel nodes of the step's graph, exact: a trace of a
        # replay has read one forward kernel short now and then (a trace
        # shows that they run); the device time from a trace with the
        # host's activity too (device_rows)
        step = (k * fwd, k * bwd)
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


# ---------------------------------------------------------------------------
# phase 17: the model zoo
# ---------------------------------------------------------------------------

ZOO_RUNS = 4           # captured steps against eager steps, per path
ZOO_TRACED = 5         # replays in a path's traced window
DEEPFM = {}            # deepfm.build()'s defaults: 26 fields, 13 dense,
                       # vocab 100003, embed 16, tower 400-400-400
DEEPFM_BATCH = 2048
DEEPFM_RUNS = 8        # captured against eager, bitwise
DEEPFM_STEPS = 64      # stat buckets past 2^31 positive x negative pairs
DEEPFM_AUC_TOL = 1e-6
DEEPFM_MIN_PAIRS = 2 ** 31  # positive x negative pairs the stats must pass
SERVE_TOL = 1e-5       # AnalysisPredictor against the executor, fp32
MNIST_BATCH = 64
MNIST_FALL = 50        # steps on one batch; the loss falls
SE_RESNEXT = {}        # se_resnext.build()'s defaults: 224x224, 102
                       # classes, cardinality 32, dropout 0.5
SE_RESNEXT_BATCH = 32
VGG = dict(dataset="cifar10")
VGG_BATCH = 128
STACKED_LSTM = {}      # stacked_lstm.build()'s defaults: dict 5000, emb
                       # 512, lstm 512, 3 layers, T 100
STACKED_LSTM_BATCH = 32
LSTM_REL = 1e-5        # the lstm op on the card against the CPU, fp32
# the rest of the zoo at its defaults: (module, build kwargs, batch)
ZOO_SMALL = {"fit_a_line": ("fit_a_line", {}, 64),
             "word2vec": ("word2vec", {}, 256),
             "recommender": ("recommender", {}, 256),
             "sentiment_conv": ("understand_sentiment", {"net": "conv"}, 128),
             "sentiment_lstm": ("understand_sentiment",
                                {"net": "stacked_lstm"}, 128)}


def zoo_build(mod, **kw):
    """A zoo model built, its startup run on the card from SEED; returns
    (build, initial state on the card, executor)."""
    return built_on_card(lambda: mod.build(**kw))


def built_on_card(build):
    """(build, initial state on the card, executor): ``build()`` under a
    fresh name guard, its startup run on the card from SEED."""
    with unique_name.guard():
        m = build()
    m["startup"].random_seed = m["main"].random_seed = SEED
    exe = pt.Executor()
    init = pt.Scope()
    exe.run(m["startup"], scope=init)
    return m, {n: init.find_var(n) for n in init.var_names()}, exe


def traced_window(label, fn, n=ZOO_TRACED):
    """``n`` calls of ``fn`` traced: (rows of the window, device ms a
    call). A trace of a few small kernels (fit_a_line's 30 a replay, a
    2-kernel one_hot) has come back without its device records (PERF.md
    §7); such a window is traced once more."""
    def window():
        for _ in range(n):
            fn()

    try:
        rows, busy = device_rows(window)
    except RuntimeError as e:
        log(f"  {label}: {e}; tracing the window once more")
        rows, busy = device_rows(window)
    return rows, busy / n


def zoo_train(label, exe, target, state, fetch, feeds, unit, smi,
              runs=ZOO_RUNS, flash_per_step=(0, 0)):
    """``runs`` steps of ``target`` (a CompiledProgram) eager
    (``FLAGS.jit_cache = False``) and then captured (warm-up, capture,
    replays), each arm from a copy of ``state`` and a fresh generator
    from the program's seed, under the deterministic mode: every fetch of
    every step and every persistable bitwise. Then ZOO_TRACED replays
    traced (device time a replay against the median replay: the idle
    share), whose flash kernels by name must be there where
    ``flash_per_step`` (forward, backward) has them and never more than
    it says (a trace may drop a flash record, PERF.md §7: the exact count
    is the graph's). Returns the captured arm's scope, its steps [(feed,
    fetches)] in order (the traced replays last) and the path's
    numbers."""
    arms = {}
    with deterministic() as warned:
        for arm in ("eager", "captured"):
            scope = copy_state(state, exe.device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            caps = exe.capture_stats["captures"]
            outs, secs = [], []
            with jit_cache(arm == "captured"):
                for feed in feeds[:runs]:
                    t0 = time.perf_counter()
                    outs.append(run_tensors(exe, target, feed=feed,
                                            fetch_list=fetch, scope=scope))
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
            arms[arm] = dict(scope=scope, outs=outs, secs=secs,
                             peak=torch.cuda.max_memory_allocated(),
                             captures=exe.capture_stats["captures"] - caps)
    eager, cap = arms["eager"], arms["captured"]
    if warned:
        raise AssertionError(f"{label}: {warned}")
    if exe.device.type == "cuda" and cap["captures"] < 1:
        raise AssertionError(f"{label}: the captured arm captured nothing")
    hold(label, f"captured against eager, {len(fetch)} fetches of {runs} "
         "steps", max(distance(c, e) for co, eo in zip(cap["outs"],
                                                        eager["outs"])
                      for c, e in zip(co, eo)), 0.0)
    sd, differ = scope_distance(cap["scope"], eager["scope"])
    hold(label, f"captured against eager, {len(state)} persistables after "
         f"{runs} steps ({len(differ)} differ)", sd, 0.0)
    losses = [float(o[0].float().reshape(-1)[0]) for o in eager["outs"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    traced = []
    rows, busy = traced_window(label, lambda: traced.append(run_tensors(
        exe, target, feed=feeds[0], fetch_list=fetch, scope=cap["scope"])))
    flash = (sum(r[2] for r in rows if "flash_fwd_kernel" in r[0]),
             sum(r[2] for r in rows if "flash_bwd_" in r[0]))
    if any(got > ZOO_TRACED * want or bool(got) != bool(want)
           for got, want in zip(flash, flash_per_step)):
        raise AssertionError(f"{label}: flash kernels {flash} in a traced "
                             f"window of {ZOO_TRACED} replays, "
                             f"{flash_per_step} a step")
    eager_ms = float(np.median(eager["secs"][1:])) * 1e3
    cap_ms = float(np.median(cap["secs"][2:])) * 1e3
    per = unit[1] / cap_ms * 1e3
    res = {"eager_ms": eager_ms, "captured_ms": cap_ms, "device_ms": busy,
           "idle": max(0.0, 1 - busy / cap_ms), "per_s": per,
           "peak_gib": max(eager["peak"], cap["peak"]) / 2 ** 30,
           "warmup_s": cap["secs"][0], "capture_s": cap["secs"][1],
           "kernels": sum(r[2] for r in rows) / ZOO_TRACED}
    log(f"  {label}: losses " + ", ".join(f"{v:.6f}" for v in losses))
    log(f"  {label}: captured step {cap_ms:.3f} ms ({per:.1f} {unit[0]}/s), "
        f"eager {eager_ms:.3f} ms ({eager_ms / cap_ms:.2f}x); a traced replay "
        f"{busy:.3f} ms of device time over "
        f"{sum(r[2] for r in rows) / ZOO_TRACED:.0f} kernels (a window of "
        f"{ZOO_TRACED}): the card idle {res['idle']:.1%}; warm-up "
        f"{res['warmup_s']:.2f} s, capture + first replay "
        f"{res['capture_s']:.2f} s; peak eager {eager['peak'] / 2 ** 30:.2f} "
        f"GiB, captured {cap['peak'] / 2 ** 30:.2f} GiB [{smi}]")
    steps = list(zip(feeds[:runs], cap["outs"])) + [(feeds[0], t)
                                                     for t in traced]
    return cap["scope"], steps, res


def zoo_serve(label, exe, m, scope, feed, served, target, passes=None,
              want_types=()):
    """The test program's ``target`` saved from ``scope`` and served by
    ``AnalysisPredictor`` on the card (``passes``, else the default
    list): the rewritten program holds ``want_types``, and its output is
    within SERVE_TOL of the executor's test-program run on ``feed``
    (every feed the test program reads)."""
    d = tempfile.mkdtemp(prefix="chip_smoke_zoo_", dir=_build.BUILD_DIR)
    try:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, served, [target], exe,
                                       main_program=m["test"])
        cfg = AnalysisConfig(d)
        if passes is not None:
            cfg.pass_builder_set(passes)
        pred = create_paddle_predictor(cfg)
        types = [o.type for o in pred._program.global_block().desc.ops]
        missing = [t for t in want_types if t not in types]
        if missing:
            raise AssertionError(f"{label}: {missing} not in the rewritten "
                                 f"program {types}")
        req = {k: feed[k] for k in served}
        got = [pred.run(req)[0].as_tensor() for _ in range(3)][-1]
        pred.close()
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
    (want,) = run_tensors(exe, m["test"], feed=feed, fetch_list=[target],
                          scope=scope)
    err = distance(got.float(), want.float())
    top = want.abs().max().item()
    log(f"  {label}: AnalysisPredictor ({len(types)} ops: "
        + ", ".join(sorted(set(want_types))) + f") against the executor's "
        f"test program: {err:.3e} of |out| {top:.3e} (bound {SERVE_TOL})")
    if not (got.shape == want.shape and err <= SERVE_TOL * max(top, 1.0)):
        raise AssertionError(f"{label}: served output {err:.3e} from the "
                             "executor's")


def numpy_auc(stat_pos, stat_neg):
    """A float64 trapezoid AUC of the stat buckets (auc_op.h)."""
    tp = np.cumsum(stat_pos[::-1].astype(np.float64))
    fp = np.cumsum(stat_neg[::-1].astype(np.float64))
    tp0 = np.concatenate([[0.0], tp[:-1]])
    fp0 = np.concatenate([[0.0], fp[:-1]])
    denom = tp[-1] * fp[-1]
    return float(np.sum((fp - fp0) * (tp + tp0) / 2.0) / denom) \
        if denom > 0 else 0.0


def deepfm_path(smi):
    """17(A): DeepFM at its defaults, fp32, batch 2048, through
    CompiledProgram: DEEPFM_RUNS steps captured against eager, bitwise;
    DEEPFM_STEPS steps in all, the auc stat buckets equal to a numpy
    recount of the fed labels in the buckets of the fetched probabilities
    (exact integers, int64 past 2^31 positive x negative pairs) and the
    fetched AUC within DEEPFM_AUC_TOL of a float64 numpy AUC of them;
    the test program's ``predict`` served by AnalysisPredictor within
    SERVE_TOL of the executor's."""
    label = "17(A) DeepFM"
    m, state, exe = zoo_build(deepfm, **DEEPFM)
    cfg = m["config"]
    target = pt.CompiledProgram(m["main"], build_strategy=bench_build_strategy())
    auc_op = next(o for o in m["main"].global_block().desc.ops
                  if o.type == "auc")
    stats = [auc_op.input("StatPos")[0], auc_op.input("StatNeg")[0]]
    nthr = int(auc_op.attrs["num_thresholds"])
    feeds = [deepfm.make_fake_batch(DEEPFM_BATCH, cfg, seed=SEED + 1700 + i)
             for i in range(DEEPFM_STEPS)]
    fetch = [m["loss"].name, m["auc"].name, m["predict"].name]
    types = [o.type for o in exe.lowered_ops(target, fetch)]
    log(f"{label}: vocab {cfg['sparse_vocab']}, {cfg['num_fields']} fields, "
        f"batch {DEEPFM_BATCH}; the rewritten step holds "
        f"{types.count('auc')} auc, {types.count('fused_adam')} fused_adam, "
        f"{types.count('adam')} adam ({len(types)} ops)")
    if types.count("auc") != 1:
        raise AssertionError(f"{label}: the pipeline dropped or merged auc")
    scope, steps, res = zoo_train(label, exe, target, state, fetch, feeds,
                                  ("rows", DEEPFM_BATCH), smi,
                                  runs=DEEPFM_RUNS)
    for feed in feeds[DEEPFM_RUNS + 1:]:
        steps.append((feed, run_tensors(exe, target, feed=feed,
                                        fetch_list=fetch, scope=scope)))
    recount = [np.zeros(nthr + 1, np.int64) for _ in range(2)]
    for feed, out in steps:
        prob = out[2].cpu().numpy().reshape(-1)
        bucket = np.clip((prob * nthr).astype(np.int32), 0, nthr)
        pos = feed["click"].reshape(-1) > 0
        np.add.at(recount[0], bucket[pos], 1)
        np.add.at(recount[1], bucket[~pos], 1)
    got = [scope.find_var(n) for n in stats]
    if any(g.dtype != torch.int64 for g in got):
        raise AssertionError(f"{label}: stat buckets {[g.dtype for g in got]}")
    wrong = sum(int((g.cpu().numpy() != r).sum()) for g, r in zip(got,
                                                                   recount))
    pairs = int(recount[0].sum()) * int(recount[1].sum())
    want_auc = numpy_auc(*recount)
    fetched = float(steps[-1][1][1].reshape(-1)[0])
    log(f"  {label}: after {len(steps)} steps ({len(steps) * DEEPFM_BATCH} "
        f"rows, {recount[0].sum()} positive, {pairs:.4e} positive x "
        f"negative pairs, {pairs / 2 ** 31:.2f}x 2^31): {wrong} buckets "
        f"differ from the numpy recount; AUC {fetched:.7f} fetched, "
        f"{want_auc:.7f} from the stats in float64 "
        f"({abs(fetched - want_auc):.2e}, bound {DEEPFM_AUC_TOL})")
    if wrong or pairs <= DEEPFM_MIN_PAIRS or not abs(fetched - want_auc) <= \
            DEEPFM_AUC_TOL:
        raise AssertionError(f"{label}: stats or AUC wrong")
    zoo_serve(label, exe, m, scope, feeds[0], ["feat_ids", "dense_input"],
              m["predict"], want_types=("fusion_repeated_fc_relu",))
    exe.close()
    return res


def mnist_path(smi):
    """17(B): MNIST LeNet, fp32, batch 64, through CompiledProgram:
    ZOO_RUNS steps captured against eager, bitwise; the loss falls over
    MNIST_FALL steps on one batch."""
    label = "17(B) MNIST LeNet"
    m, state, exe = zoo_build(mnist)
    target = pt.CompiledProgram(m["main"], build_strategy=bench_build_strategy())
    feeds = [mnist.make_fake_batch(MNIST_BATCH, seed=SEED + 1750 + i)
             for i in range(ZOO_RUNS)]
    scope, _, res = zoo_train(label, exe, target, state,
                              [m["loss"].name, m["acc"].name], feeds,
                              ("images", MNIST_BATCH), smi)
    scope = copy_state(state, exe.device)
    losses = [float(run_tensors(exe, target, feed=feeds[0],
                                fetch_list=[m["loss"].name],
                                scope=scope)[0].reshape(-1)[0])
              for _ in range(MNIST_FALL)]
    log(f"  {label}: {MNIST_FALL} steps on one batch: loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"{label}: the loss does not fall: {losses}")
    exe.close()
    return res


def image_batch(shape, classes, batch, seed):
    rng = np.random.RandomState(seed)
    return {"data": rng.rand(batch, *shape).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


def cnn_path(smi, name):
    """17(C): SE-ResNeXt-50 at its defaults (224x224, 102 classes,
    dropout 0.5) at batch 32, or VGG-16 at cifar10 at batch 128, AMP,
    through CompiledProgram: ZOO_RUNS steps captured against eager from
    the same generator state, bitwise (the dropout masks included).
    SE-ResNeXt-50 also replays a batch-2 AMP step op by op on the card
    against the CPU (phase 9's per-op bounds; the CPU's dropout mask
    under the card's arithmetic)."""
    mod, kw, batch = ((se_resnext, SE_RESNEXT, SE_RESNEXT_BATCH)
                      if name == "se_resnext" else (vgg, VGG, VGG_BATCH))
    label = f"17(C) {'SE-ResNeXt-50' if name == 'se_resnext' else 'VGG-16'}"
    m, state, exe = zoo_build(mod, **kw)
    main = mixed_precision.decorate(m["main"].clone())
    target = pt.CompiledProgram(main, build_strategy=bench_build_strategy())
    shape = list(m["main"].global_block().var("data").shape[1:])
    classes = int(m["predict"].shape[-1])
    feeds = [image_batch(shape, classes, batch, SEED + 1800 + i)
             for i in range(ZOO_RUNS)]
    _, _, res = zoo_train(label, exe, target, state,
                          [m["loss"].name, m["acc"].name], feeds,
                          ("images", batch), smi)
    if name == "se_resnext":
        replay_each_op(exe.lowered_ops(target, [m["loss"].name]),
                       m["main"].global_block(),
                       copy_state(state, torch.device("cpu")),
                       image_batch(shape, classes, 2, SEED + 1850),
                       exe.device, True, f"{label} AMP step at batch 2")
    exe.close()
    return res


def lstm_op_on_the_card(label, device, hdim, t, batch):
    """The lstm op at the path's shape on the card against the CPU on the
    same inputs, fp32: Hidden and Cell within LSTM_REL of their largest
    magnitude."""
    g = torch.Generator().manual_seed(SEED)
    ins = {"Input": [torch.randn(batch, t, 4 * hdim, generator=g)],
           "Weight": [torch.randn(hdim, 4 * hdim, generator=g) * 0.05],
           "Bias": [torch.randn(4 * hdim, generator=g) * 0.1],
           "Length": [torch.randint(t // 2, t + 1, (batch,), generator=g,
                                    dtype=torch.int32)]}
    attrs = {"use_peepholes": False, "is_reverse": False}
    emit = pt.registry.lookup("lstm").emitter
    want = emit(pt.registry.EmitContext(torch.device("cpu")), ins, attrs)
    got = emit(pt.registry.EmitContext(device),
               {k: [v[0].to(device)] for k, v in ins.items()}, attrs)
    for slot in ("Hidden", "Cell"):
        w, c = want[slot][0], got[slot][0].cpu()
        err, top = distance(c, w), w.abs().max().item()
        log(f"  {label}: the lstm op's {slot} [{batch}, {t}, {hdim}] on the "
            f"card against the CPU: {err:.3e} of {top:.3e} (bound "
            f"{LSTM_REL} relative)")
        if not err <= LSTM_REL * top:
            raise AssertionError(f"{label}: lstm {slot} {err:.3e}")


def softmax_out(m):
    """stacked_lstm's prediction: the softmax its accuracy reads."""
    op = [o for o in m["test"].global_block().desc.ops
          if o.type == "softmax"][-1]
    return m["test"].global_block().var(op.output("Out")[0])


def stacked_lstm_path(smi):
    """17(D): stacked_lstm at its defaults, fp32, batch 32, through
    CompiledProgram: ZOO_RUNS steps captured against eager, bitwise; the
    lstm op on the card against the CPU; the test program's softmax
    served by AnalysisPredictor with the default passes
    (fused_embedding_fc_lstm) and without fc_fuse_pass (fusion_lstm),
    each within SERVE_TOL of the executor's."""
    label = "17(D) stacked LSTM"
    m, state, exe = zoo_build(stacked_lstm, **STACKED_LSTM)
    target = pt.CompiledProgram(m["main"], build_strategy=bench_build_strategy())
    max_len = int(m["main"].global_block().var("words").shape[1])
    dict_size = STACKED_LSTM.get("dict_size", 5000)
    feeds = [stacked_lstm.make_fake_batch(STACKED_LSTM_BATCH, dict_size,
                                          max_len, seed=SEED + 1900 + i)
             for i in range(ZOO_RUNS)]
    tokens = int(np.median([f["length"].sum() for f in feeds]))
    scope, _, res = zoo_train(label, exe, target, state,
                              [m["loss"].name, m["acc"].name], feeds,
                              ("tokens", tokens), smi)
    op = next(o for o in m["main"].global_block().desc.ops
              if o.type == "lstm")
    hdim = int(m["main"].global_block().var(op.input("Weight")[0]).shape[0])
    lstm_op_on_the_card(label, exe.device, hdim, max_len, STACKED_LSTM_BATCH)
    target_var = softmax_out(m)
    no_fc_fuse = [p for p in AnalysisConfig.DEFAULT_PASSES
                  if p != "fc_fuse_pass"]
    for passes, want in ((None, ("fused_embedding_fc_lstm",)),
                         (no_fc_fuse, ("fused_embedding_fc_lstm",
                                       "fusion_lstm"))):
        zoo_serve(label, exe, m, scope, feeds[0], ["words", "length"],
                  target_var, passes, want)
    exe.close()
    return res


def zoo_small_path(smi, name):
    """17(D): the rest of the zoo at its defaults: ZOO_RUNS steps
    captured against eager, bitwise, finite losses."""
    modname, kw, batch = ZOO_SMALL[name]
    mod = {"fit_a_line": fit_a_line, "word2vec": word2vec,
           "recommender": recommender,
           "understand_sentiment": understand_sentiment}[modname]
    label = f"17(D) {name}"
    m, state, exe = zoo_build(mod, **kw)
    target = pt.CompiledProgram(m["main"], build_strategy=bench_build_strategy())
    feeds = [mod.make_fake_batch(batch, seed=SEED + 1950 + i)
             for i in range(ZOO_RUNS)]
    _, _, res = zoo_train(label, exe, target, state, [m["loss"].name],
                          feeds, ("rows", batch), smi)
    exe.close()
    return res


def zoo_paths(smi):
    """Phase 17; returns the flash launches of its paths (the wrappers'
    calls over each path's runs, (0, 0); each path's traced replay holds
    no flash kernel) and each path's numbers."""
    out, numbers, secs = {}, {}, {}
    runs = [("deepfm", deepfm_path), ("mnist", mnist_path),
            ("se_resnext", lambda s: cnn_path(s, "se_resnext")),
            ("vgg", lambda s: cnn_path(s, "vgg")),
            ("stacked_lstm", stacked_lstm_path)] + [
        (n, lambda s, n=n: zoo_small_path(s, n)) for n in ZOO_SMALL]
    for name, fn in runs:
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        numbers[name] = fn(smi)
        calls = (fa.launches, fa.bwd_launches)
        if calls != (0, 0):
            raise AssertionError(f"17 {name}: flash wrapper calls {calls}")
        out[f"zoo_{name}"] = calls
        secs[name] = time.perf_counter() - t0
        release()
    log("17: " + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    log("17: " + json.dumps({n: {k: round(v, 4) for k, v in r.items()}
                             for n, r in numbers.items()}))
    return out, numbers


# ---------------------------------------------------------------------------
# phase 18: recurrent training and structured prediction
# ---------------------------------------------------------------------------

REC_RUNS = 3           # captured steps against eager steps on one batch
MT_TRAIN_BATCH = 32    # the Fluid benchmark's machine_translation batch
# label_semantic_roles at the book's widths: word_dim 32, mark_dim 5 (the
# db_lstm default), hidden 512, depth 8 (eight lstm layers), max_len 40,
# 59 labels (conll05.LABEL_COUNT); batch 10, SGD
SRL = dict(max_len=40, word_dim=32, hidden_dim=512, depth=8)
SRL_BATCH = 10
# tests/test_control_flow.py::test_while_trains's pow loop (y = x * w^2
# through a While with max_trip_count 4, a square error to 4x): its
# feature width is 3, so batch 4096; 40 SGD steps at 0.05
WHILE_BATCH = 4096
WHILE_STEPS = 40
WHILE_FALL = 0.2       # the last loss below this of the first
WHILE_FD_EPS = 1e-6    # central differences in float64
WHILE_FD_REL = 1e-6    # of the gradient's largest magnitude
# ROADMAP C4's probes and the JAX package's results for them (lax.top_k
# on the CPU, tests/test_torch_conv_ops.py and test_torch_beam_search.py):
# (X, k, indices, values)
C4_TOP_K = [([[0.5, -0.0, 0.0, -1.0]], 2, [[0, 2]], [[0.5, 0.0]]),
            ([[1.0, -float("nan"), -float("inf"), 2.0]], 4, [[3, 0, 2, 1]],
             [[2.0, 1.0, -float("inf"), -float("nan")]])]
# beam_search over 2 hypotheses x 2 accumulated candidates (ids 10-13):
# (scores, selected ids)
C4_BEAM = [([[-0.0, 0.5], [0.0, -1.0]], [11, 12]),
           ([[1.0, -float("nan")], [-float("inf"), 2.0]], [13, 10])]


def c4_on_the_card(device):
    """ROADMAP C4's probes through the port's ``top_k`` and ``beam_search``
    emitters on the card, against the JAX package's results: indices and
    values bitwise (+0 above -0, a negative NaN below -inf)."""
    ctx = pt.registry.EmitContext(device)
    for x, k, idx, vals in C4_TOP_K:
        out = pt.registry.lookup("top_k").emitter(
            ctx, {"X": [torch.tensor(x, device=device)]}, {"k": k})
        got_idx = out["Indices"][0].cpu().tolist()
        got = out["Out"][0].cpu().numpy()
        want = np.array(vals, np.float32)
        same = (got_idx == idx and got.tobytes() == want.tobytes())
        log(f"  C4 top_k {x} k={k}: indices {got_idx} (JAX {idx}), values "
            f"{got.tolist()} bitwise the JAX values: {same}")
        if not same:
            raise AssertionError(f"C4: top_k on the card gives {got_idx} "
                                 f"{got.tolist()}, JAX {idx} {vals}")
    for scores, ids in C4_BEAM:
        out = pt.registry.lookup("beam_search").emitter(ctx, {
            "pre_ids": [torch.tensor([5, 6], device=device)],
            "pre_scores": [torch.zeros(2, device=device)],
            "ids": [torch.tensor([[10, 11], [12, 13]], device=device)],
            "scores": [torch.tensor(scores, device=device)]},
            {"beam_size": 2, "end_id": 1, "is_accumulated": True})
        got = out["selected_ids"][0].cpu().tolist()
        log(f"  C4 beam_search over {scores}: selected {got} (JAX {ids})")
        if got != ids:
            raise AssertionError(f"C4: beam_search on the card selects "
                                 f"{got}, JAX {ids}")


def falls(label, steps):
    """The losses of a path's captured steps (zoo_train's ``steps``, on
    one batch) must fall: the last below the first."""
    losses = [float(o[0].float().reshape(-1)[0]) for _, o in steps]
    log(f"  {label}: losses on one batch " + ", ".join(
        f"{v:.6f}" for v in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss does not fall: {losses}")
    return losses


def top_kernels(label, exe, target, feed, fetch, scope, n=8):
    """One more captured step of ``target`` traced: its ``n`` kernels of
    most device time printed (the candidates for fusion)."""
    rows, busy = device_rows(lambda: run_tensors(
        exe, target, feed=feed, fetch_list=fetch, scope=scope))
    log(f"  {label}: one traced step, {busy:.3f} ms of device time over "
        f"{sum(r[2] for r in rows)} kernels; the top {n}:")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:n]:
        log(f"    {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% x{count:<6} "
            f"{key[:90]}")


def mt_train_path(smi):
    """18(A): machine_translation.build at the Fluid benchmark's widths
    (MT: 30000-word dictionaries, 512 wide, max_len 50), fp32, Adam,
    batch 32, through CompiledProgram: REC_RUNS steps captured against
    eager bitwise (the decoder one ``recurrent`` op of 50 steps, its
    backward the generic vjp of the whole loop), the loss falling on one
    batch; then phase 15's decode program (beam 4, 50 steps, batch 16) on
    the trained scope, 2 eager runs against 3 captured bitwise, scores
    finite, ids inside the dictionary; then C4's probes on the card."""
    label = "18(A) MT training"
    m, state, exe = zoo_build(machine_translation, **MT)
    cfg = m["config"]
    target = pt.CompiledProgram(m["main"],
                                build_strategy=bench_build_strategy())
    feed = machine_translation.make_fake_batch(MT_TRAIN_BATCH, cfg,
                                               seed=SEED + 2000)
    tokens = int(feed["tgt_len"].sum())
    log(f"  machine_translation.build {MT}: {len(state)} persistables, "
        f"{sum(t.numel() for t in state.values()) / 1e6:.1f} M values; "
        f"batch {MT_TRAIN_BATCH}, {tokens} target tokens")
    scope, steps, res = zoo_train(label, exe, target, state,
                                  [m["loss"].name], [feed] * REC_RUNS,
                                  ("tokens", tokens), smi, runs=REC_RUNS)
    res["losses"] = falls(label, steps)
    top_kernels(label, exe, target, feed, [m["loss"].name], scope)

    prog = m["decode"]["program"]
    fetch = [m["decode"]["sentences"].name, "init_scores"]
    dfeed = mt_feed(cfg, SEED + 2001)
    with deterministic() as found:
        with jit_cache(False):
            eager = [mt_run(exe, prog, dfeed, scope, fetch)
                     for _ in range(2)]
        captured = [mt_run(exe, prog, dfeed, scope, fetch)
                    for _ in range(3)]
    if found:
        raise AssertionError(f"{label}: decode: {found}")
    for i, name in enumerate(("sentences", "final scores")):
        hold(label, f"decode on the trained scope, {name}: 3 captured runs "
             "against eager", max(distance(torch.from_numpy(c[i]),
                                           torch.from_numpy(e[i]))
                                  for c in captured for e in eager), 0.0)
    sent, scores = captured[0]
    ok = (sent.shape == (MT_BATCH * cfg["beam_size"], cfg["decode_max_len"])
          and np.isfinite(scores).all() and (scores <= 0).all()
          and sent.min() >= 0 and sent.max() < cfg["tgt_dict_size"])
    log(f"  {label}: decode on the trained scope: sentences {sent.shape}, "
        f"best hypothesis of sentence 0 {sent[0][:12].tolist()}, final "
        f"scores in [{scores.min():.4f}, {scores.max():.4f}]")
    if not ok:
        raise AssertionError(f"{label}: the decode's sentences or scores")
    c4_on_the_card(exe.device)
    exe.close()
    return res


def numpy_viterbi(em, trans, length):
    """crf_decoding's Viterbi in numpy float32, one row of emissions
    [T, N] over its first ``length`` steps (the same float32 additions as
    the op; the first maximum on a tie), the path padded with 0."""
    start, end, w = trans[0], trans[1], trans[2:]
    alpha = start + em[0]
    bps = []
    for t in range(1, length):
        scores = alpha[:, None] + w
        bps.append(scores.argmax(axis=0))
        alpha = scores.max(axis=0) + em[t]
    tag = int(np.argmax(alpha + end))
    path = [tag]
    for bp in reversed(bps):
        tag = int(bp[tag])
        path.append(tag)
    return path[::-1] + [0] * (em.shape[0] - length)


def srl_path(smi):
    """18(B): label_semantic_roles at the book's widths (SRL), batch 10 of
    the synthetic conll05 rows, SGD, through CompiledProgram: REC_RUNS
    steps captured against eager bitwise, the loss falling on one batch;
    the test program's crf_decoding paths against a numpy Viterbi of the
    same emissions, fetched from the card, exactly."""
    label = "18(B) label_semantic_roles"
    m, state, exe = zoo_build(label_semantic_roles, **SRL)
    target = pt.CompiledProgram(m["main"],
                                build_strategy=bench_build_strategy())
    feed = label_semantic_roles.make_batch(
        list(conll05.train()())[:SRL_BATCH], SRL["max_len"])
    tokens = int(feed["length"].sum())
    scope, steps, res = zoo_train(label, exe, target, state,
                                  [m["loss"].name], [feed] * REC_RUNS,
                                  ("tokens", tokens), smi, runs=REC_RUNS)
    res["losses"] = falls(label, steps)
    top_kernels(label, exe, target, feed, [m["loss"].name], scope)
    dec = next(o for o in m["test"].global_block().ops
               if o.type == "crf_decoding")
    em, path = run_tensors(exe, m["test"], feed=feed,
                           fetch_list=[dec.input("Emission")[0],
                                       m["decode"].name], scope=scope)
    em = em.cpu().numpy()
    trans = scope.find_var(dec.input("Transition")[0]).cpu().numpy()
    path = path.cpu().numpy()
    want = np.array([numpy_viterbi(em[r], trans, int(feed["length"][r]))
                     for r in range(SRL_BATCH)])
    log(f"  {label}: crf_decoding's paths ({path.dtype}, {path.shape}) "
        f"against a numpy Viterbi of the card's emissions: "
        f"{int((path != want).sum())} of {want.size} tags differ; row 0 "
        f"{path[0][:int(feed['length'][0])].tolist()}")
    if path.dtype != np.int64 or not np.array_equal(path, want):
        raise AssertionError(f"{label}: Viterbi paths differ from numpy's")
    exe.close()
    return res


def pow_loop(dtype, train):
    """test_while_trains's program in ``dtype``: y = x * w^2 through a
    While with max_trip_count 4, loss mean((y - t)^2); SGD 0.05 with
    ``train``, else the gradient of w appended. Returns (main, startup,
    loss, fetch names)."""
    main, startup = pt.Program(), pt.Program()
    with unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        x = L.data("x", shape=[3], dtype=dtype)
        w = L.create_parameter([1, 3], dtype, name="w_loop")
        i = L.fill_constant(shape=[1], dtype="int32", value=0)
        limit = L.fill_constant(shape=[1], dtype="int32", value=2)
        y = L.elementwise_add(x, L.fill_constant(shape=[1], dtype=dtype,
                                                 value=0.0))
        cond = L.less_than(i, limit)
        loop = L.While(cond, max_trip_count=4)
        with loop.block():
            L.assign(L.elementwise_mul(y, w), output=y)
            L.increment(i, 1, in_place=True)
            L.less_than(i, limit, cond=cond)
        t = L.data("t", shape=[3], dtype=dtype)
        loss = L.mean(L.square_error_cost(y, t))
        if train:
            pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
            return main, startup, loss, [loss.name]
        grads = dict((p.name, g.name)
                     for p, g in pt.backward.append_backward(loss))
    return main, startup, loss, [loss.name, grads[w.name]]


def while_batch(rng, dtype=np.float32):
    xb = (rng.rand(WHILE_BATCH, 3) + 0.5).astype(dtype)
    return {"x": xb, "t": xb * 4.0}


def while_train_path(smi):
    """18(C): test_while_trains's bounded While (pow_loop) at batch 4096
    through CompiledProgram: WHILE_STEPS SGD steps on a new batch each,
    captured against eager bitwise, the last loss below WHILE_FALL of the
    first, w near 2; then the float64 build's while_grad against central
    differences of its own loss on the card."""
    label = "18(C) While trained"
    main, startup, loss, fetch = pow_loop("float32", train=True)
    main.random_seed = startup.random_seed = SEED
    exe = pt.Executor()
    init = pt.Scope()
    exe.run(startup, scope=init)
    init.set_var("w_loop", torch.full((1, 3), 0.5, device=exe.device))
    state = {n: init.find_var(n) for n in init.var_names()}
    rng = np.random.RandomState(SEED + 2100)
    feeds = [while_batch(rng) for _ in range(WHILE_STEPS)]
    target = pt.CompiledProgram(main, build_strategy=bench_build_strategy())
    scope, steps, res = zoo_train(label, exe, target, state, fetch, feeds,
                                  ("rows", WHILE_BATCH), smi,
                                  runs=WHILE_STEPS)
    losses = [float(o[0].reshape(-1)[0]) for _, o in steps[:WHILE_STEPS]]
    w_end = scope.find_var("w_loop").cpu().numpy()
    log(f"  {label}: losses {losses[0]:.6f} -> {losses[-1]:.6e} over "
        f"{WHILE_STEPS} steps; w {w_end.tolist()}")
    if not (losses[-1] < WHILE_FALL * losses[0]
            and np.allclose(w_end, 2.0, rtol=1e-3)):
        raise AssertionError(f"{label}: the loop did not train: "
                             f"{losses[::8]}, w {w_end}")
    res["losses"] = [losses[0], losses[-1]]

    main64, start64, _, fetch64 = pow_loop("float64", train=False)
    s64 = pt.Scope()
    exe.run(start64, scope=s64)
    w0 = np.array([[1.2, 0.8, 1.6]])
    feed = while_batch(np.random.RandomState(SEED + 2101), np.float64)

    def run(wv):
        s64.set_var("w_loop", torch.from_numpy(wv).to(exe.device))
        with jit_cache(False):
            lv, gv = run_tensors(exe, main64, feed=feed, fetch_list=fetch64,
                                 scope=s64)
        return float(lv.reshape(-1)[0]), gv.cpu().numpy()

    _, grad = run(w0)
    num = np.zeros_like(w0)
    for j in range(3):
        wp, wm = w0.copy(), w0.copy()
        wp[0, j] += WHILE_FD_EPS
        wm[0, j] -= WHILE_FD_EPS
        num[0, j] = (run(wp)[0] - run(wm)[0]) / (2 * WHILE_FD_EPS)
    err = float(np.abs(grad - num).max() / np.abs(num).max())
    log(f"  {label}: float64 while_grad {grad.tolist()} against central "
        f"differences {num.tolist()}: {err:.3e} of the largest (bound "
        f"{WHILE_FD_REL})")
    if not err <= WHILE_FD_REL:
        raise AssertionError(f"{label}: while_grad {err:.3e} from the "
                             "finite differences")
    res["fd_rel"] = err
    exe.close()
    return res


def recurrent_paths(smi):
    """Phase 18; returns the flash launches of its paths (the wrappers'
    calls over each path's runs, which must be (0, 0): no path holds an
    attention op) and each path's numbers."""
    out, numbers, secs = {}, {}, {}
    for name, fn in (("mt_train", mt_train_path), ("srl", srl_path),
                     ("while_train", while_train_path)):
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        numbers[name] = fn(smi)
        calls = (fa.launches, fa.bwd_launches)
        if calls != (0, 0):
            raise AssertionError(f"18 {name}: flash wrapper calls {calls}")
        out[name] = calls
        secs[name] = time.perf_counter() - t0
        release()
    log("18: " + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    log("18: " + json.dumps({n: {k: (round(v, 4) if isinstance(v, float)
                                     else v) for k, v in r.items()
                                 if k != "losses"}
                             for n, r in numbers.items()}))
    return out, numbers


# ---------------------------------------------------------------------------
# phase 19: conditional control flow, the sequence ops and CTC
# ---------------------------------------------------------------------------

# 19(A): Fluid's ocr_recognition CRNN-CTC (crnn_ctc_model.py) at its
# widths, testing.models.crnn_ctc's defaults: gray [1, 48, 512] images,
# conv groups of 16/32/64/128 filters, T 32 steps of 384, GRU 200 each
# way, 95 classes and the blank, Momentum 1e-3 / 0.9, L2 4e-4; batch 32 of
# seeded images and labels of 1-16 ids
CRNN = {}
CRNN_BATCH = 32
CRNN_STEPS = 20        # steps on one batch (REC_RUNS captured against
                       # eager, the traced window, then more); the loss falls
CTC_YARDSTICK_REL = 1e-4   # warpctc against F.ctc_loss, relative
# 19(B-C): test_mnist_if_else_op.py's shape (testing.models.if_else_mnist's
# defaults): image 784, rows routed by label < 5, each branch fc 100 tanh
# and fc 10 softmax, Momentum 0.9 on a Switch piecewise rate (boundaries 3,
# 6, 9); batch 128 of seeded MNIST-shaped rows
IFELSE = {}
IFELSE_BATCH = 128
IFELSE_RUNS = 12       # captured against eager; with the traced window the
                       # steps cross all three boundaries
COND_WIDTH = 4096      # the hand-built conditional_block's x
# 19(D): the op bank, every type of the slice on the card and on the CPU
# on the same seeded inputs: batch 64, T 128, width 256, rows of length
# 0, 1 and T among them
BANK_B, BANK_T, BANK_D = 64, 128, 256
BANK_REL = 1e-5        # float outputs, of each output's largest magnitude
BANK_REL_CTC = 1e-4    # warpctc and edit_distance
BANK_VJP_REL = 1e-4    # the gradful types' vjps, of each gradient's largest
# 19(E): testing.models.text_cnn at phase 17's understand_sentiment conv
# widths (dict 5000, emb 32, 32 filters of widths 3 and 4, max_len 64),
# batch 128, served by AnalysisPredictor against NativePredictor
TEXT_CNN = {}
TEXT_CNN_BATCH = 128
# its op types after AnalysisConfig's default passes, the JAX package's
# pipeline's (tests/test_torch_ir.py TEXT_CNN_ANALYSIS_TYPES)
TEXT_CNN_TYPES = ["lookup_table", "fusion_seqconv_eltadd_relu",
                  "sequence_pool", "fusion_seqconv_eltadd_relu",
                  "sequence_pool", "mul", "mul", "sum", "elementwise_add",
                  "softmax"]


def levenshtein(a, b):
    """The edit distance of two id lists (a row-by-row table)."""
    d = list(range(len(b) + 1))
    for i, ca in enumerate(a):
        new = [i + 1]
        for k, cb in enumerate(b):
            new.append(min(d[k + 1] + 1, new[k] + 1, d[k] + (ca != cb)))
        d = new
    return d[-1]


def crnn_path(smi):
    """19(A): the CRNN-CTC through CompiledProgram under bench.py's
    BuildStrategy, fp32: REC_RUNS steps captured against eager bitwise,
    then captured steps to CRNN_STEPS on the same batch, the loss falling;
    the test program (ctc_greedy_decoder, edit_distance) 3 captured runs
    against 2 eager bitwise, its distances those of a numpy Levenshtein of
    the decoded rows; warpctc on the card against F.ctc_loss on the same
    log-softmax (a yardstick, within CTC_YARDSTICK_REL); edit_distance's
    kernels a call."""
    label = "19(A) CRNN-CTC"
    m, state, exe = built_on_card(lambda: tmodels.crnn_ctc(pt, **CRNN))
    cfg = m["config"]
    dev = exe.device
    target = pt.CompiledProgram(m["main"],
                                build_strategy=bench_build_strategy())
    feed = tmodels.crnn_batch(CRNN_BATCH, cfg["image"], cfg["classes"],
                              cfg["max_label"], seed=SEED + 1900)
    log(f"  crnn_ctc {cfg}: {len(state)} persistables, "
        f"{sum(t.numel() for t in state.values()) / 1e6:.2f} M values; batch "
        f"{CRNN_BATCH}, label lengths {int(feed['label_length'].min())}-"
        f"{int(feed['label_length'].max())}")
    scope, steps, res = zoo_train(label, exe, target, state,
                                  [m["loss"].name], [feed] * REC_RUNS,
                                  ("images", CRNN_BATCH), smi, runs=REC_RUNS)
    losses = [float(o[0].float().reshape(-1)[0]) for _, o in steps]
    while len(losses) < CRNN_STEPS:
        (loss,) = run_tensors(exe, target, feed=feed,
                              fetch_list=[m["loss"].name], scope=scope)
        losses.append(float(loss.float().reshape(-1)[0]))
    log(f"  {label}: losses over {len(losses)} steps on one batch "
        + ", ".join(f"{v:.5f}" for v in losses))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: the loss does not fall: {losses}")
    res["losses"] = losses
    top_kernels(label, exe, target, feed, [m["loss"].name], scope, n=12)

    fetch = [m["decoded"].name, m["decoded_length"].name,
             m["distance"].name, m["logits"].name]
    with deterministic() as found:
        with jit_cache(False):
            eager = [run_tensors(exe, m["test"], feed=feed, fetch_list=fetch,
                                 scope=scope) for _ in range(2)]
        captured = [run_tensors(exe, m["test"], feed=feed, fetch_list=fetch,
                                scope=scope) for _ in range(3)]
    if found:
        raise AssertionError(f"{label}: test program: {found}")
    for i, name in enumerate(("decoded rows", "decoded lengths",
                              "edit distances", "logits")):
        hold(label, f"test program {name}: 3 captured runs against 2 eager",
             max(distance(c[i], e[i]) for c in captured for e in eager), 0.0)
    dec, dec_len, dist, logits = captured[-1]
    dec_n, len_n = dec.cpu().numpy(), dec_len.cpu().numpy()
    want = [float(levenshtein(dec_n[r, :len_n[r]].tolist(),
                              feed["label"][r, :feed["label_length"][r]]
                              .tolist())) for r in range(CRNN_BATCH)]
    got = dist.cpu().reshape(-1).tolist()
    log(f"  {label}: decoded ({dec_n.dtype}) row 0 {dec_n[0, :len_n[0]]}"
        f"; edit distances {got[:8]}... against a numpy Levenshtein of the "
        f"decoded rows: {sum(g != w for g, w in zip(got, want))} of "
        f"{len(got)} differ")
    if dec_n.dtype != np.int64 or got != want:
        raise AssertionError(f"{label}: edit distances {got} against "
                             f"numpy's {want}")
    rows, busy = device_rows(lambda: run_tensors(
        exe, m["test"], feed=feed, fetch_list=fetch, scope=scope))
    res["test_kernels"] = sum(r[2] for r in rows)
    res["test_device_ms"] = busy

    ctx = pt.registry.EmitContext(dev)
    ed_ins = {"Hyps": [dec], "Refs": [torch.from_numpy(feed["label"]).to(dev)],
              "HypsLength": [dec_len],
              "RefsLength": [torch.from_numpy(feed["label_length"]).to(dev)]}
    ed = pt.registry.lookup("edit_distance").emitter
    rows, busy = device_rows(lambda: ed(ctx, ed_ins, {"normalized": False}))
    res["edit_distance_kernels"] = sum(r[2] for r in rows)
    res["edit_distance_ms"] = time_ms(
        lambda: ed(ctx, ed_ins, {"normalized": False}))

    wc = pt.registry.lookup("warpctc").emitter
    lab = torch.from_numpy(feed["label"]).to(dev)
    lab_len = torch.from_numpy(feed["label_length"]).to(dev)
    wc_ins = {"Logits": [logits], "Label": [lab], "LabelLength": [lab_len]}
    wc_attrs = {"blank": cfg["classes"]}
    port = wc(ctx, wc_ins, wc_attrs)["Loss"][0].reshape(-1).double()
    steps_t = torch.full((CRNN_BATCH,), logits.shape[1], dtype=torch.long,
                         device=dev)

    def library():
        return torch.nn.functional.ctc_loss(
            torch.log_softmax(logits, dim=-1).transpose(0, 1), lab, steps_t,
            lab_len, blank=cfg["classes"], reduction="none")

    ref = library().double()
    rel = float(((port - ref).abs() / ref.abs()).max())
    res["warpctc_ms"] = time_ms(lambda: wc(ctx, wc_ins, wc_attrs))
    res["ctc_loss_ms"] = time_ms(library, graph=False)
    log(f"  {label}: warpctc on the card against F.ctc_loss on the same "
        f"log-softmax: {rel:.3e} relative at most (bound "
        f"{CTC_YARDSTICK_REL}); losses {port[:3].tolist()}; warpctc "
        f"forward {res['warpctc_ms']:.4f} ms a call (graph replay), "
        f"F.ctc_loss {res['ctc_loss_ms']:.4f} ms (eager); the test program "
        f"{res['test_kernels']} kernels, {res['test_device_ms']:.3f} ms of "
        f"device time a call; edit_distance alone "
        f"{res['edit_distance_kernels']} kernels, "
        f"{res['edit_distance_ms']:.4f} ms a call [{smi}]")
    if not rel <= CTC_YARDSTICK_REL:
        raise AssertionError(f"{label}: warpctc {rel:.3e} from F.ctc_loss")
    res["ctc_rel"] = rel
    exe.close()
    return res


def numpy_piecewise(step, boundaries, values):
    for b, v in zip(boundaries, values):
        if step < b:
            return np.float32(v)
    return np.float32(values[-1])


def if_else_path(smi):
    """19(B-C): the IfElse MNIST program with its Switch learning rate,
    fp32, batch 128: IFELSE_RUNS steps captured against eager bitwise, each
    plan one device segment held in one CUDA graph (no host read); at
    every step the merged rows equal a where of the two branches' outputs
    and the learning rate numpy's piecewise value of the fetched global
    step, across all three boundaries."""
    label = "19(B) IfElse + Switch"
    m, state, exe = built_on_card(lambda: tmodels.if_else_mnist(pt,
                                                                **IFELSE))
    rng = np.random.RandomState(SEED + 1901)
    in_dim = m["main"].global_block().var("img").shape[-1]
    feed = {"img": rng.rand(IFELSE_BATCH, in_dim).astype(np.float32),
            "label": rng.randint(0, 10, (IFELSE_BATCH, 1)).astype(np.int64)}
    fetch = [m["loss"].name, m["lr"].name, m["step"].name, m["prob"].name,
             m["true_out"], m["false_out"]]
    scope, steps, res = zoo_train(label, exe, m["main"], state, fetch,
                                  [feed] * IFELSE_RUNS,
                                  ("rows", IFELSE_BATCH), smi,
                                  runs=IFELSE_RUNS)
    res["losses"] = falls(label, steps)
    plans = list(m["main"].__dict__["_exec_cache"].values())
    kinds = [[k for k, _ in p.segments] for p in plans]
    graphs = [seg.graph is not None for p in plans for k, seg in p.segments]
    log(f"  {label}: {len(plans)} plan(s), segments {kinds}, captured "
        f"{graphs}")
    if (not plans or any(k != ["device"] for k in kinds)
            or (exe.device.type == "cuda" and not all(graphs))):
        raise AssertionError(f"{label}: the step is not one captured graph")
    routed = torch.from_numpy(feed["label"] < 5).to(exe.device)
    lrs = []
    for i, (_, o) in enumerate(steps):
        if not torch.equal(o[3], torch.where(routed, o[4], o[5])):
            raise AssertionError(f"{label}: step {i}: the merged rows are "
                                 "not the branches' where")
        step = float(o[2].reshape(-1)[0])
        lr = np.float32(o[1].reshape(-1)[0].item())
        want = numpy_piecewise(step, m["boundaries"], m["values"])
        if lr != want:
            raise AssertionError(f"{label}: step {step}: learning rate "
                                 f"{lr} against numpy's {want}")
        lrs.append((step, float(lr)))
    log(f"  {label}: merged rows the where of the branches at all "
        f"{len(steps)} captured steps; (global step, learning rate) "
        + ", ".join(f"({s:g}, {v:g})" for s, v in lrs)
        + " equal to numpy's")
    if len({v for _, v in lrs}) != len(m["values"]):
        raise AssertionError(f"{label}: the steps do not cross every "
                             f"boundary: {lrs}")
    exe.close()
    return res


def conditional_block_path(smi):
    """19(C): the hand-built conditional_block (testing.models), x of
    COND_WIDTH, run eager and captured in turns with x whose sum is
    negative (the sub-block's value) and positive (the prior value): the
    capture made on one branch replays the other; bitwise against eager
    and equal to numpy's."""
    label = "19(C) conditional_block"
    with unique_name.guard():
        prog, out = tmodels.conditional_block_program(pt, COND_WIDTH)
    exe = pt.Executor()
    scope = pt.Scope()
    rng = np.random.RandomState(SEED + 1902)
    xs = [(rng.rand(COND_WIDTH).astype(np.float32) + 0.1) * sign
          for sign in (-1, 1, -1, 1, -1)]
    with jit_cache(False):
        eager = [run_tensors(exe, prog, feed={"x": x}, fetch_list=[out.name],
                             scope=scope)[0] for x in xs]
    captured = [run_tensors(exe, prog, feed={"x": x}, fetch_list=[out.name],
                            scope=scope)[0] for x in xs]
    for x, e, c in zip(xs, eager, captured):
        want = (3 * x + 1 if x.sum() < 0
                else np.full(COND_WIDTH, 0.5, np.float32))
        if not (torch.equal(c, e) and np.array_equal(c.cpu().numpy(),
                                                     want)):
            raise AssertionError(f"{label}: sum(x) {x.sum():.2f}: captured "
                                 "or eager differs from numpy")
    plans = list(prog.__dict__["_exec_cache"].values())
    graphs = [seg.graph is not None for p in plans for k, seg in p.segments]
    log(f"  {label}: {len(xs)} runs alternating the branch, captured "
        f"({graphs}) bitwise eager and numpy's [{smi}]")
    if exe.device.type == "cuda" and not all(graphs):
        raise AssertionError(f"{label}: not captured")
    exe.close()
    return {"runs": len(xs)}


def bank_cases():
    """(name, op type, numpy inputs, attrs, tolerance) of the op bank; an
    array input is a list of arrays."""
    b, t, d = BANK_B, BANK_T, BANK_D
    rng = np.random.RandomState(SEED + 1950)

    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    length = rng.randint(0, t + 1, b).astype(np.int64)
    length[:3] = [0, 1, t]
    ids = rng.randint(0, 50, (b, t)).astype(np.int64)
    x = f(b, t, d)
    n_cls, n_lab, t2 = 96, min(32, t // 4), min(64, t)
    label_len = rng.randint(1, n_lab + 1, b).astype(np.int64)
    logit_len = rng.randint(2 * n_lab + 1, t + 1, b).astype(np.int64)
    label_len[:3], logit_len[:3] = [0, 0, n_lab], [0, 1, t]
    ref_len = rng.randint(0, t2 + 1, b).astype(np.int64)
    ref_len[:3] = [0, 1, t2]
    array = [f(b, t, d) for _ in range(3)]
    row_mask = rng.rand(b) < 0.5
    rows = [
        ("if_else", {"Cond": [row_mask.reshape(b, 1)], "TrueOut": [x],
                     "FalseOut": [f(b, t, d)]}, {}),
        ("switch_merge", {"Conds": [np.array([False]), np.array([True]),
                                    np.array([True])],
                          "X": [f(b, d), f(b, d), f(b, d)],
                          "Default": [f(b, d)]}, {}),
        ("write_to_array", {"X": [x], "I": [np.array([2])]}, {}),
        ("read_from_array", {"X": [array], "I": [np.array([1])]}, {}),
        ("lod_array_length", {"X": [array]}, {}),
        ("tensor_array_to_tensor", {"X": [array]}, {"axis": 1}),
        ("max_sequence_len", {"RankTable": [length]}, {}),
        ("lod_tensor_to_array", {"X": [x]}, {}),
        ("array_to_lod_tensor", {"X": [f(t, b, d)]}, {}),
        ("shrink_rnn_memory", {"X": [f(b, d)], "RankTable": [length],
                               "I": [np.array([5])]}, {}),
        ("split_lod_tensor", {"X": [x], "Mask": [row_mask]}, {}),
        ("merge_lod_tensor", {"InTrue": [x], "InFalse": [f(b, t, d)],
                              "Mask": [row_mask]}, {}),
        ("is_empty", {"X": [x]}, {}),
        ("sequence_expand", {"X": [f(b, d)], "Y": [x]}, {}),
        ("sequence_reverse", {"X": [x], "Length": [length]}, {}),
        ("sequence_concat", {"X": [x, f(b, t // 4, d)]}, {}),
        ("sequence_slice", {"X": [x]}, {"offset": 5,
                                        "length": min(64, t - 5)}),
        ("sequence_conv", {"X": [x], "Filter": [f(3 * d, 128) * 0.05],
                           "Length": [length]},
         {"contextLength": 3, "contextStart": -1}),
        ("row_conv", {"X": [x], "Filter": [f(3, d)], "Length": [length]}, {}),
        ("sequence_pad", {"X": [x], "Length": [length],
                          "PadValue": [np.array([-1.0], np.float32)]},
         {"maxlen": t + 16}),
        ("sequence_unpad", {"X": [x], "Length": [length]}, {}),
        ("sequence_expand_as", {"X": [f(b, d)], "Y": [x]}, {}),
        ("sequence_reshape", {"X": [x]}, {"new_dim": 2 * d}),
        ("sequence_scatter", {"X": [x], "Ids": [rng.randint(
            0, t, (b, 16)).astype(np.int64)], "Updates": [f(b, 16, d)]}, {}),
        ("sequence_enumerate", {"X": [ids], "Length": [length]},
         {"win_size": 4, "pad_value": 0}),
        ("sequence_erase", {"X": [ids], "Length": [length]},
         {"tokens": [1, 2, 3]}),
        ("add_position_encoding", {"X": [x]}, {"alpha": 0.5, "beta": 1.5}),
        ("im2sequence", {"X": [f(b, 16, 12, 64)]},
         {"kernels": [3, 3], "strides": [1, 2], "paddings": [1, 0, 2, 1]}),
        ("lod_reset", {"X": [x], "Y": [np.concatenate(
            [[0], np.cumsum(length)]).astype(np.int64)]}, {}),
        ("lod_rank_table", {"X": [length]}, {}),
        ("reorder_lod_tensor_by_rank", {"X": [x], "RankTable": [
            rng.permutation(b).astype(np.int64)]}, {}),
        ("warpctc", {"Logits": [f(b, t, n_cls)],
                     "Label": [rng.randint(0, n_cls - 1, (b, n_lab))
                               .astype(np.int64)],
                     "LogitsLength": [logit_len],
                     "LabelLength": [label_len]},
         {"blank": n_cls - 1, "norm_by_times": True}),
        ("ctc_align", {"Input": [rng.randint(0, 8, (b, t)).astype(np.int64)],
                       "Length": [length]}, {"blank": 0}),
        ("edit_distance", {"Hyps": [ids % 6], "Refs": [rng.randint(
            0, 6, (b, t2)).astype(np.int64)], "HypsLength": [length],
            "RefsLength": [ref_len]}, {"normalized": True}),
        ("fusion_seqconv_eltadd_relu", {"X": [x],
                                        "Filter": [f(3 * d, 128) * 0.05],
                                        "Bias": [f(128)],
                                        "Length": [length]},
         {"contextLength": 3, "contextStart": -1}),
    ]
    ctc = ("warpctc", "edit_distance")
    return [(n, ins, attrs, BANK_REL_CTC if n in ctc else BANK_REL)
            for n, ins, attrs in rows]


def _bank_in(v, device):
    if isinstance(v, list):
        return [_bank_in(a, device) for a in v]
    return torch.from_numpy(np.array(v)).to(device)


def _bank_flat(outs):
    """{slot: [tensor or list of tensors]} -> [(slot name, tensor on the
    CPU)], a list array's slots in order."""
    flat = []
    for slot in sorted(outs):
        for j, v in enumerate(outs[slot]):
            for k, a in enumerate(v if isinstance(v, list) else [v]):
                if a is not None:
                    flat.append((f"{slot}[{j}]{'' if k == 0 else f'[{k}]'}",
                                 a.detach().cpu()))
    return flat


def bank_error(got, want):
    """0 for equal integer or bool tensors (raises on unequal ones), else
    the largest distance over the largest magnitude."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape or dtype {tuple(got.shape)} {got.dtype}"
                             f" against {tuple(want.shape)} {want.dtype}")
    if not want.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError("integer outputs differ")
        return 0.0
    top = want.abs().max().item() if want.numel() else 0.0
    return distance(got, want) / max(top, 1e-30)


def run_bank(label, cases, vjp_rel, dev, extra=None):
    """Every (type, numpy inputs, attrs, bound) of ``cases`` through its
    emitter on the card and on the CPU: integer outputs equal, float
    outputs within ``bound`` of the largest magnitude (0.0: equal); each
    gradful type's generic vjp on the same cotangents within ``vjp_rel``.
    ``extra(name, info, card inputs, attrs)`` may add to a type's line.
    Returns {type: (error, vjp error or None)}."""
    cpu = torch.device("cpu")
    worst = {}
    for name, ins, attrs, tol in cases:
        t0 = time.perf_counter()
        info = pt.registry.lookup(name)
        args = {where: {s: _bank_in(v, where) for s, v in ins.items()}
                for where in (cpu, dev)}
        outs = {where: info.emitter(pt.registry.EmitContext(where),
                                    args[where], attrs)
                for where in (cpu, dev)}
        want, got = _bank_flat(outs[cpu]), _bank_flat(outs[dev])
        if len(got) != len(want):
            raise AssertionError(f"{label}: {name}: outputs differ in number")
        errs = [bank_error(g, w) for (_, g), (_, w) in zip(got, want)]
        err = max(errs, default=0.0)
        line = (f"  {label}: {name}: {len(errs)} outputs, {err:.3e} of the "
                f"largest (bound {tol}{', equal' if tol == 0 else ''})")
        if err > tol:
            raise AssertionError(line)
        vjp_err = None
        if not info.no_grad:
            vjp_err = bank_vjp(label, name, ins, attrs, info, dev, outs[cpu])
            line += f"; vjp {vjp_err:.3e} (bound {vjp_rel})"
            if vjp_err > vjp_rel:
                raise AssertionError(line)
        if extra is not None:
            line += extra(name, info, args[dev], attrs)
        worst[name] = (err, vjp_err)
        log(line + f" [{time.perf_counter() - t0:.1f} s]")
    return worst


def op_bank_path(smi):
    """19(D): every type of the slice on the card and on the CPU on the
    same seeded inputs (bank_cases through run_bank; conditional_block
    through testing.models' program at COND_WIDTH): integer outputs
    equal, float outputs within each case's bound of the largest
    magnitude; each gradful type's generic vjp on the same cotangents
    within BANK_VJP_REL."""
    label = "19(D) op bank"
    card = pt.Executor()
    worst = run_bank(label, bank_cases(), BANK_VJP_REL, card.device)
    with unique_name.guard():
        prog, out = tmodels.conditional_block_program(pt, COND_WIDTH)
    rng = np.random.RandomState(SEED + 1951)
    for sign in (-1, 1):
        x = (rng.rand(COND_WIDTH).astype(np.float32) + 0.1) * sign
        got = [exe.run(prog, feed={"x": x}, fetch_list=[out.name],
                       scope=pt.Scope())[0]
               for exe in (card, pt.Executor(pt.CPUPlace()))]
        if not np.array_equal(got[0], got[1]):
            raise AssertionError(f"{label}: conditional_block differs")
    worst["conditional_block"] = (0.0, None)
    log(f"  {label}: conditional_block at {COND_WIDTH}: both branches equal "
        f"on the card and the CPU; {len(worst)} types [{smi}]")
    if len(worst) != 36:
        raise AssertionError(f"{label}: {len(worst)} types, not 36")
    return {"types": len(worst),
            "max_rel": max(e for e, _ in worst.values()),
            "max_vjp_rel": max(v for _, v in worst.values() if v is not None)}


def bank_vjp(label, name, ins, attrs, info, dev, fwd):
    """The generic vjp of ``name`` on the card and on the CPU on the same
    seeded cotangents (the intermediate outputs ``fwd``, the CPU's
    forward, made): the largest distance of a gradient over its largest
    magnitude."""
    cpu = torch.device("cpu")
    rng = np.random.RandomState(SEED + 1952)
    gins = {s: v for s, v in ins.items()}
    for slot, vals in fwd.items():
        if slot in info.intermediate_outputs:
            gins[slot] = [v.numpy() for v in vals]
        elif all(v.is_floating_point() for v in vals):
            gins[slot + "@GRAD"] = [rng.randn(*v.shape).astype(np.float32)
                                    for v in vals]
    gattrs = dict(attrs, __fwd_type__=name)
    want, got = [_bank_flat(pt.registry.generic_vjp_grad_emitter(
        pt.registry.EmitContext(where),
        {s: _bank_in(v, where) for s, v in gins.items()}, gattrs))
        for where in (cpu, dev)]
    if len(got) != len(want) or not got:
        raise AssertionError(f"{label}: {name}: gradients differ in number")
    return max(bank_error(g, w) for (_, g), (_, w) in zip(got, want))


def text_cnn_path(smi):
    """19(E): testing.models.text_cnn (sequence_conv with relu, sqrt
    pooling) saved and served by AnalysisPredictor on the card: the
    default passes rewrite it to TEXT_CNN_TYPES (both branches
    fusion_seqconv_eltadd_relu), and its output is within SERVE_TOL of
    NativePredictor's on the same batch."""
    label = "19(E) text CNN served"
    with unique_name.guard():
        m = tmodels.text_cnn(pt, **TEXT_CNN)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(m["startup"], scope=scope)
    rng = np.random.RandomState(SEED + 1903)
    max_len = m["main"].global_block().var("words").shape[1]
    vocab = scope.find_var(next(
        o.input("W")[0] for o in m["main"].global_block().ops
        if o.type == "lookup_table")).shape[0]
    length = rng.randint(1, max_len + 1, TEXT_CNN_BATCH).astype(np.int32)
    length[:2] = [1, max_len]
    feed = {"words": rng.randint(0, vocab, (TEXT_CNN_BATCH, max_len, 1))
            .astype(np.int64), "length": length}
    d = tempfile.mkdtemp(prefix="chip_smoke_textcnn_", dir=_build.BUILD_DIR)
    try:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, m["feeds"], [m["predict"]], exe,
                                       main_program=m["main"])
        apred = create_paddle_predictor(AnalysisConfig(d))
        npred = create_paddle_predictor(NativeConfig(d))
        types = [o.type for o in apred._program.global_block().desc.ops
                 if o.type not in ("feed", "fetch")]
        if types != TEXT_CNN_TYPES:
            raise AssertionError(f"{label}: the rewritten program {types}, "
                                 f"the JAX pipeline's {TEXT_CNN_TYPES}")
        got = [apred.run(feed)[0].as_tensor() for _ in range(4)]
        want = [npred.run(feed)[0].as_tensor() for _ in range(2)]
        secs = []
        for _ in range(20):
            t0 = time.perf_counter()
            apred.run(feed)[0].as_tensor()
            secs.append(time.perf_counter() - t0)
        apred.close()
        npred.close()
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
    err = max(distance(g.float(), want[-1].float()) for g in got)
    top = want[-1].abs().max().item()
    ms = float(np.median(secs)) * 1e3
    log(f"  {label}: AnalysisPredictor's {len(types)} ops ({types.count('fusion_seqconv_eltadd_relu')} "
        f"fusion_seqconv_eltadd_relu) against NativePredictor: {err:.3e} of "
        f"|out| {top:.3e} (bound {SERVE_TOL}); {ms:.3f} ms a request of "
        f"{TEXT_CNN_BATCH} rows [{smi}]")
    if not err <= SERVE_TOL * max(top, 1.0):
        raise AssertionError(f"{label}: served output {err:.3e} from "
                             "NativePredictor's")
    exe.close()
    return {"request_ms": ms, "err": err}


def control_sequence_ctc_paths(smi):
    """Phase 19; returns the flash launches of its paths (the wrappers'
    calls over each path's runs, which must be (0, 0): no path holds an
    attention op) and each path's numbers."""
    out, numbers, secs = {}, {}, {}
    for name, fn in (("crnn_ctc", crnn_path), ("if_else_switch", if_else_path),
                     ("conditional_block", conditional_block_path),
                     ("op_bank", op_bank_path),
                     ("text_cnn", text_cnn_path)):
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        numbers[name] = fn(smi)
        calls = (fa.launches, fa.bwd_launches)
        if calls != (0, 0):
            raise AssertionError(f"19 {name}: flash wrapper calls {calls}")
        out[name] = calls
        secs[name] = time.perf_counter() - t0
        release()
    log("19: " + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    log("19: " + json.dumps({n: {k: (float(f"{v:.5g}")
                                     if isinstance(v, float) else v)
                                 for k, v in r.items()
                                 if k != "losses"}
                             for n, r in numbers.items()}))
    return out, numbers


# ---------------------------------------------------------------------------
# phase 20: object detection
# ---------------------------------------------------------------------------

# 20(A-B): PaddleCV's MobileNet-SSD on Pascal VOC
# (object_detection/mobilenet_ssd.py, train.py, eval.py),
# testing.models.mobilenet_ssd's defaults: 300x300 images, 21 classes,
# MobileNet v1 at scale 1.0, six prior maps (1917 priors), ssd_loss summed,
# RMSProp with L2Decay 5e-5 on train.py's piecewise rate; batch 32 of
# seeded images with 1-8 gt boxes each (padded to 50 rows), labels 1-20;
# the test program's detection_output (nms_threshold 0.45, nms_top_k 400,
# keep_top_k 200) and detection_map (11point)
SSD = {}
SSD_BATCH = 32
SSD_STEPS = 20         # steps on one batch (REC_RUNS captured against
                       # eager, the traced window, then more); the loss falls
DET_SERVE_TOL = 1e-4   # served NMS inputs (decoded boxes, scores) against
                       # NativePredictor: AnalysisPredictor folds the 27
                       # batch_norms into their convolutions
IOU_EPS = 8.0          # an IoU moves at most 8 x a coordinate's change
                       # over the box's shortest side
DET_SERVE_SHARE = 0.9  # the share of NativePredictor's served rows that
                       # must be compared (served_rows_check)
# 20(C): the three YOLOv3 scales on seeded backbone features for a 608
# input (testing.models.yolov3_head's defaults: 19/38/76 cells, the 9 COCO
# anchors, 80 classes, 50 gt rows), batch 8
YOLO = {}
YOLO_BATCH = 8
# 20(D): the op bank at realistic shapes, on the card against the CPU:
# a Faster R-CNN C4 map (1333x800 at stride 16: [1, 1024, 50, 84]) with
# 15 anchors a cell, the SSD shapes at batch 32, YOLOv3's 76x76 head
DET_BANK = dict(
    c4=(1024, 50, 84),     # channels, cells of the C4 map (15 anchors a cell)
    rois=512,              # roi_align 14x14
    pool_rois=16,          # roi_pool 7x7 on 256 channels
    ps_rois=300,           # psroi_pool 7x7, 21 classes (R-FCN)
    quads=128,             # roi_perspective_transform; mask-label rois
    ssd_batch=32, priors=1917,
    pre_nms=6000, post_nms=1000,
    fpn_rois=2000,         # per level; generate_proposal_labels at 512
    yolo_batch=8, yolo_cells=76,
    retina=(37800, 9450, 2394))  # anchors of three RetinaNet levels
DET_BANK_REL = 1e-5    # float outputs, of each output's largest magnitude
DET_BANK_VJP_REL = 1e-4


def ssd_train_path(smi):
    """20(A): MobileNet-SSD through CompiledProgram under bench.py's
    BuildStrategy, fp32: REC_RUNS steps captured against eager bitwise,
    then captured steps to SSD_STEPS on the same batch, the loss falling;
    returns the trained scope and the initial state for 20(B)."""
    label = "20(A) MobileNet-SSD"
    m, state, exe = built_on_card(lambda: tmodels.mobilenet_ssd(pt, **SSD))
    cfg = m["config"]
    target = pt.CompiledProgram(m["main"],
                                build_strategy=bench_build_strategy())
    feed = tmodels.detection_batch(SSD_BATCH, cfg["image"], cfg["classes"],
                                   cfg["gt_pad"], seed=SEED + 2000)
    n_gt = (feed["gt_label"] >= 0).sum(1)
    log(f"  mobilenet_ssd {cfg}: {len(state)} persistables, "
        f"{sum(t.numel() for t in state.values()) / 1e6:.2f} M values; batch "
        f"{SSD_BATCH}, {int(n_gt.min())}-{int(n_gt.max())} gt boxes an image")
    scope, steps, res = zoo_train(label, exe, target, state,
                                  [m["loss"].name], [feed] * REC_RUNS,
                                  ("images", SSD_BATCH), smi, runs=REC_RUNS)
    losses = [float(o[0].float().reshape(-1)[0]) for _, o in steps]
    while len(losses) < SSD_STEPS:
        (loss,) = run_tensors(exe, target, feed=feed,
                              fetch_list=[m["loss"].name], scope=scope)
        losses.append(float(loss.float().reshape(-1)[0]))
    log(f"  {label}: losses over {len(losses)} steps on one batch "
        + ", ".join(f"{v:.4f}" for v in losses))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: the loss does not fall: {losses}")
    res["losses"] = losses
    top_kernels(label, exe, target, feed, [m["loss"].name], scope, n=12)
    return m, scope, state, exe, feed, res


def _row_iou(box, rows, normalized):
    """IoU of one detection box (x1, y1, x2, y2) with each of ``rows``'
    boxes, as multiclass_nms measures it (+1 sides unless normalized)."""
    one = 0.0 if normalized else 1.0
    iw = np.clip(np.minimum(box[2], rows[:, 2])
                 - np.maximum(box[0], rows[:, 0]) + one, 0, None)
    ih = np.clip(np.minimum(box[3], rows[:, 3])
                 - np.maximum(box[1], rows[:, 1]) + one, 0, None)
    area = ((box[2] - box[0] + one) * (box[3] - box[1] + one))
    areas = (rows[:, 2] - rows[:, 0] + one) * (rows[:, 3] - rows[:, 1] + one)
    return iw * ih / np.maximum(area + areas - iw * ih, 1e-30)


def served_rows_check(label, want, got, scores, attrs, tol):
    """Two predictors' detections [B, K, 6] (``want`` the reference's,
    ``scores`` [B, C, M] its NMS input scores) held class by class: in
    rank order, class exact, score and box within ``tol``, a run of
    scores within ``tol`` compared as a set. A class's rows are compared
    up to its first difference; that difference must be one a change of
    ``tol`` in the NMS inputs can make: the two rows' scores within
    2 tol (an order or nms_top_k flip), or the higher row within 2 tol of
    a cut (score_threshold, the class's nms_top_k-th input score, the
    other side's last row when keep_top_k fills it) or overlapping a row
    kept above it at an IoU within IOU_EPS x tol / the pair's shortest
    side of nms_threshold (a suppression flip). After it, the class's rows follow
    other boxes and are not compared. Raises on an unexplained
    difference; returns (rows compared, live rows of ``want``)."""
    thr = float(attrs.get("nms_threshold", 0.3))
    s_thr = float(attrs.get("score_threshold", 0.0))
    top_k = int(attrs.get("nms_top_k", -1))
    keep = int(attrs.get("keep_top_k", -1))
    norm = bool(attrs.get("normalized", True))
    compared = live = 0
    for b in range(want.shape[0]):
        sides = [r[r[:, 0] >= 0] for r in (want[b], got[b])]
        live += len(sides[0])
        last = [r[-1, 1] if keep > 0 and len(r) == keep else -np.inf
                for r in sides]
        for c in np.unique(np.concatenate([r[:, 0] for r in sides])):
            w, g = (r[r[:, 0] == c] for r in sides)
            i, n = 0, min(len(w), len(g))
            while i < n:
                e = i + 1
                while e < n and max(w[e - 1, 1] - w[e, 1],
                                    g[e - 1, 1] - g[e, 1]) <= tol:
                    e += 1
                free = list(range(i, e))
                for row in w[i:e]:
                    hit = next((k for k in free if np.abs(
                        g[k, 1:] - row[1:]).max() <= tol), None)
                    if hit is None:
                        break
                    free.remove(hit)
                if free:
                    break
                i = e
            compared += i
            if i == max(len(w), len(g)):
                continue
            pair = [r[i] if i < len(r) else None for r in (w, g)]
            both = pair[0] is not None and pair[1] is not None
            if both and abs(pair[0][1] - pair[1][1]) <= 2 * tol:
                continue
            side = 0 if pair[1] is None or (
                pair[0] is not None and pair[0][1] >= pair[1][1]) else 1
            h = pair[side]
            cls = np.sort(scores[b, int(c)])[::-1]
            cuts = [s_thr, last[1 - side]]
            if 0 < top_k < len(cls):
                cuts += [cls[top_k - 1], cls[top_k]]
            near_cut = any(abs(h[1] - v) <= 2 * tol for v in cuts) or (
                h[1] <= last[1 - side] + 2 * tol)
            above = (w, g)[side][:i, 2:]
            sides_ = np.minimum(np.minimum(above[:, 2] - above[:, 0],
                                           above[:, 3] - above[:, 1]),
                                min(h[4] - h[2], h[5] - h[3]))
            near_iou = bool(np.any(np.abs(_row_iou(h[2:], above, norm) - thr)
                                   <= IOU_EPS * tol
                                   / np.maximum(sides_, 1e-6)))
            if not (near_cut or near_iou):
                raise AssertionError(
                    f"{label}: image {b} class {int(c)}: rows differ at "
                    f"rank {i} ({pair[0]} against {pair[1]}) with no "
                    f"score or IoU within the tolerance of a cut")
    return compared, live


def ssd_eval_path(m, scope, initial, exe, feed, smi):
    """20(B): the test program on 20(A)'s trained scope: 3 captured runs
    against 2 eager bitwise (its device segment captured, detection_map a
    host op after it); the mAP the program's detection_map gives equals
    metrics.DetectionMAP over the fetched detections; the inference model
    (detection_output, with the NMS inputs as two more targets) served by
    AnalysisPredictor fp32 against NativePredictor: NativePredictor's
    detections bitwise the executor's, the NMS inputs within
    DET_SERVE_TOL, and each predictor's detections bitwise multiclass_nms
    on its own NMS inputs, and the detections by served_rows_check (a
    score or IoU within the tolerance of a cut can change which box is
    kept, and every row after it in its class), at least DET_SERVE_SHARE
    of the rows compared. The trained scores crowd together, so the model
    of the initial weights, whose scores spread, is served too."""
    label = "20(B) SSD evaluation"
    fetch = [m["detections"].name, m["map"].name]
    with deterministic() as found:
        with jit_cache(False):
            eager = [run_tensors(exe, m["test"], feed=feed, fetch_list=fetch,
                                 scope=scope) for _ in range(2)]
        captured = [run_tensors(exe, m["test"], feed=feed, fetch_list=fetch,
                                scope=scope) for _ in range(3)]
    if found:
        raise AssertionError(f"{label}: {found}")
    for i, name in enumerate(("detections", "mAP")):
        hold(label, f"{name}: 3 captured runs against 2 eager",
             max(distance(c[i], e[i]) for c in captured for e in eager), 0.0)
    dets, m_ap = captured[-1]
    rows = (dets[..., 0] >= 0).sum(dim=1).cpu().tolist()
    label5 = np.concatenate([feed["gt_label"][..., None].astype(np.float32),
                             feed["gt_box"]], axis=2)
    metric = pt.metrics.DetectionMAP(overlap_threshold=0.5,
                                     ap_version="11point")
    metric.update(dets.cpu().numpy(), label5)
    want = np.float32(metric.eval())
    got = float(m_ap.reshape(-1)[0])
    log(f"  {label}: {sum(rows)} detections over {SSD_BATCH} images "
        f"({min(rows)}-{max(rows)} an image); detection_map {got:.6f}, "
        f"DetectionMAP over the fetched detections {float(want):.6f}")
    if got != float(want):
        raise AssertionError(f"{label}: detection_map {got} against "
                             f"DetectionMAP {want}")
    rows_t, busy = device_rows(lambda: run_tensors(
        exe, m["test"], feed=feed, fetch_list=fetch, scope=scope))
    res = {"map": got, "detections": sum(rows),
           "test_kernels": sum(r[2] for r in rows_t),
           "test_device_ms": busy}
    t0 = time.perf_counter()
    for _ in range(5):
        run_tensors(exe, m["test"], feed=feed, fetch_list=fetch, scope=scope)
    torch.cuda.synchronize()
    res["test_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    log(f"  {label}: the test program {res['test_ms']:.3f} ms a batch, "
        f"{res['test_kernels']} kernels, {busy:.3f} ms of device time "
        f"[{smi}]")

    res["served"] = serve_ssd(label, m, scope, exe, feed, dets, smi)
    # the trained scores crowd together (20 steps on synthetic images);
    # the initial weights' spread with the untrained features
    res["served_initial"] = serve_ssd(
        label + ", initial weights", m, copy_state(initial, exe.device),
        exe, feed, None, smi)
    exe.close()
    return res


def serve_ssd(label, m, scope, exe, feed, dets, smi):
    """The inference model of ``scope`` (detection_output, with the NMS
    inputs as two more targets) served by AnalysisPredictor fp32 against
    NativePredictor: NativePredictor's detections bitwise ``dets`` (the
    executor's, where given), the NMS inputs within DET_SERVE_TOL, each
    predictor's detections bitwise multiclass_nms on its own NMS inputs,
    and the detections held against each other by served_rows_check, at
    least DET_SERVE_SHARE of NativePredictor's rows compared."""
    nms = next(o for o in m["test"].global_block().ops
               if o.type == "multiclass_nms")
    pre = [m["test"].global_block().var(nms.input(slot)[0])
           for slot in ("BBoxes", "Scores")]
    d = tempfile.mkdtemp(prefix="chip_smoke_ssd_", dir=_build.BUILD_DIR)
    try:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, ["image"], [m["detections"]] + pre,
                                       exe, main_program=m["test"])
        apred = create_paddle_predictor(AnalysisConfig(d))
        npred = create_paddle_predictor(NativeConfig(d))
        req = {"image": feed["image"]}
        served = [[t.as_tensor() for t in apred.run(req)] for _ in range(3)]
        native = [[t.as_tensor() for t in npred.run(req)] for _ in range(2)]
        secs = []
        for _ in range(10):
            t0 = time.perf_counter()
            apred.run(req)[0].as_tensor()
            secs.append(time.perf_counter() - t0)
        types = [o.type for o in apred._program.global_block().desc.ops]
        apred.close()
        npred.close()
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
    hold(label, "AnalysisPredictor's 3 requests against each other",
         max(distance(a[i], served[0][i]) for a in served for i in range(3)),
         0.0)
    if dets is not None:
        hold(label, "NativePredictor's detections against the executor's "
             "test program", distance(native[-1][0], dets), 0.0)
    err = max(distance(a, n) for a, n in zip(served[-1][1:], native[-1][1:]))
    log(f"  {label}: AnalysisPredictor fp32 ({len(types)} ops, "
        f"{types.count('batch_norm')} batch_norm left) against "
        f"NativePredictor: the NMS inputs (decoded boxes, class scores) "
        f"{err:.3e} at most (bound {DET_SERVE_TOL})")
    if not err <= DET_SERVE_TOL:
        raise AssertionError(f"{label}: served NMS inputs {err:.3e} from "
                             "NativePredictor's")
    ctx = pt.registry.EmitContext(exe.device)
    nms_emit = pt.registry.lookup("multiclass_nms").emitter
    for name, outs in (("AnalysisPredictor", served[-1]),
                       ("NativePredictor", native[-1])):
        again = nms_emit(ctx, {"BBoxes": [outs[1]], "Scores": [outs[2]]},
                         dict(nms.attrs))["Out"][0]
        hold(label, f"{name}'s detections against multiclass_nms on its "
             "own NMS inputs", distance(again, outs[0]), 0.0)
    compared, live = served_rows_check(
        label, native[-1][0].cpu().numpy(), served[-1][0].cpu().numpy(),
        native[-1][2].cpu().numpy(), nms.attrs, DET_SERVE_TOL)
    res = {"ms": float(np.median(secs)) * 1e3, "err": err,
           "compared": compared, "rows": live}
    if not compared >= DET_SERVE_SHARE * live:
        raise AssertionError(f"{label}: {compared} of {live} rows compared, "
                             f"fewer than {DET_SERVE_SHARE} of them")
    log(f"  {label}: served detections against NativePredictor's: "
        f"{compared} of {live} rows compared and equal (within "
        f"{DET_SERVE_TOL}), every difference after a score or IoU within "
        f"the tolerance of a cut; {res['ms']:.3f} ms a request of "
        f"{len(feed['image'])} images [{smi}]")
    return res


def yolo_path(smi):
    """20(C): the YOLOv3 head at batch 8 through CompiledProgram:
    REC_RUNS steps captured against eager bitwise, the loss falling; then
    the test program's yolo_box + multiclass_nms decode (on the initial
    weights), 3 captured runs against 2 eager bitwise, rows of class -1
    or 0-79, some kept."""
    label = "20(C) YOLOv3 head"
    m, state, exe = built_on_card(lambda: tmodels.yolov3_head(pt, **YOLO))
    cfg = m["config"]
    target = pt.CompiledProgram(m["main"],
                                build_strategy=bench_build_strategy())
    feed = tmodels.yolov3_batch(YOLO_BATCH, cfg["image"], cfg["channels"],
                                cfg["classes"], cfg["gt_pad"],
                                seed=SEED + 2001)
    train = {k: feed[k] for k in m["feeds"]}
    scope, steps, res = zoo_train(label, exe, target, state,
                                  [m["loss"].name], [train] * REC_RUNS,
                                  ("images", YOLO_BATCH), smi, runs=REC_RUNS)
    res["losses"] = falls(label, steps)
    test_feed = {k: feed[k] for k in ("c5", "c4", "c3", "img_size")}
    fetch = [m["detections"].name]
    # a few steps from random weights drive every objectness below
    # conf_thresh, so the decode runs on the initial weights, where every
    # cell passes it and the NMS has work
    scope = copy_state(state, exe.device)
    with deterministic() as found:
        with jit_cache(False):
            eager = [run_tensors(exe, m["test"], feed=test_feed,
                                 fetch_list=fetch, scope=scope)
                     for _ in range(2)]
        captured = [run_tensors(exe, m["test"], feed=test_feed,
                                fetch_list=fetch, scope=scope)
                    for _ in range(3)]
    if found:
        raise AssertionError(f"{label}: decode: {found}")
    hold(label, "decode: 3 captured runs against 2 eager",
         max(distance(c[0], e[0]) for c in captured for e in eager), 0.0)
    dets = captured[-1][0]
    cls = dets[..., 0]
    if not (torch.isfinite(dets).all() and bool((cls >= 0).any()) and (
            (cls == -1) | ((cls >= 0) & (cls < cfg["classes"]))).all()):
        raise AssertionError(f"{label}: decode rows out of range")
    rows_t, busy = device_rows(lambda: run_tensors(
        exe, m["test"], feed=test_feed, fetch_list=fetch, scope=scope))
    res.update(decode_kernels=sum(r[2] for r in rows_t),
               decode_device_ms=busy,
               detections=int((cls >= 0).sum()))
    log(f"  {label}: decode {tuple(dets.shape)}, {res['detections']} rows "
        f"kept; {res['decode_kernels']} kernels, {busy:.3f} ms of device "
        f"time a batch [{smi}]")
    exe.close()
    return res


def det_bank_cases():
    """(op type, numpy inputs, attrs, exact) of the detection op bank at
    realistic shapes; ``exact``: every output must equal the CPU's (the
    ops whose floats are selections, constants or host arithmetic). Where
    a float passes through exp or log the card's and the CPU's may part
    by an ulp: those cases hold integer outputs equal and floats within
    DET_BANK_REL. The random ops run here with budgets that keep every
    candidate (or fixed priorities); det_rng_invariants samples them."""
    rng = np.random.RandomState(SEED + 2050)
    z = DET_BANK
    nb, npr, ns = z["ssd_batch"], z["priors"], z["yolo_cells"]

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def boxes(n, span, lo=0.02, hi=0.4):
        xy = rng.uniform(0, span * (1 - hi), (n, 2))
        wh = rng.uniform(span * lo, span * hi, (n, 2))
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    def rois(n, h, w):
        x1 = rng.uniform(0, w * 0.8, n)
        y1 = rng.uniform(0, h * 0.8, n)
        return np.stack([x1, y1, x1 + rng.uniform(16, w * 0.4, n),
                         y1 + rng.uniform(16, h * 0.4, n)], 1).astype(
                             np.float32)

    # Faster R-CNN C4: 1333x800 at stride 16, 15 anchors a cell
    ch, fh, fw = z["c4"]
    anc_attrs = {"anchor_sizes": [32.0, 64.0, 128.0, 256.0, 512.0],
                 "aspect_ratios": [0.5, 1.0, 2.0], "stride": [16.0, 16.0]}
    anc = pt.registry.lookup("anchor_generator").emitter(
        pt.registry.EmitContext(torch.device("cpu")),
        {"Input": [torch.zeros(1, 1, fh, fw)]}, anc_attrs)
    anchors, avar = (anc[k][0].numpy() for k in ("Anchors", "Variances"))
    im_info = np.float32([[800, 1333, 1.0]])
    c4 = f(1, ch, fh, fw)
    gt = boxes(20, 800)
    # SSD at batch 32: 1917 priors, 21 classes, 50 gt rows
    prior = boxes(npr, 1.0)
    pvar = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (npr, 1))
    dist = rng.rand(nb, 50, npr).astype(np.float32)
    dist[:, 8:] = 0.0
    match = rng.randint(-1, 50, (nb, npr)).astype(np.int32)
    match[rng.rand(nb, npr) < 0.9] = -1
    logits = f(nb, npr, 21)
    sm = np.exp(logits - logits.max(-1, keepdims=True))
    sm = (sm / sm.sum(-1, keepdims=True)).transpose(0, 2, 1).astype(
        np.float32)
    dec = pt.registry.lookup("box_coder").emitter(
        pt.registry.EmitContext(torch.device("cpu")),
        {"PriorBox": [torch.from_numpy(prior)],
         "PriorBoxVar": [torch.from_numpy(pvar)],
         "TargetBox": [torch.from_numpy(f(nb, npr, 4, scale=0.5))]},
        {"code_type": "decode_center_size"})["OutputBox"][0].numpy()
    yolo_anchors = tmodels.YOLOV3_ANCHORS
    yb = z["yolo_batch"]
    ygt = np.zeros((yb, 50, 4), np.float32)
    ygt[:, :12, :2] = rng.uniform(0.05, 0.95, (yb, 12, 2))
    ygt[:, :12, 2:] = rng.uniform(0.02, 0.5, (yb, 12, 2))
    quads = []
    for _ in range(z["quads"]):
        cx, cy = rng.uniform(fw * 0.2, fw * 0.8), rng.uniform(fh * 0.2,
                                                              fh * 0.8)
        r = rng.uniform(3, 8, 4)
        ang = np.radians([225, 315, 45, 135])
        quads.append(np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                              1).reshape(-1))
    det_res = np.zeros((nb, 200, 6), np.float32)
    det_res[..., 0] = rng.randint(-1, 21, (nb, 200))
    det_res[..., 1] = rng.rand(nb, 200)
    det_res[..., 2:] = boxes(nb * 200, 1.0).reshape(nb, 200, 4)
    gt5 = np.full((nb, 50, 5), -1.0, np.float32)
    gt5[:, :8, 0] = rng.randint(1, 21, (nb, 8))
    gt5[:, :8, 1:] = boxes(nb * 8, 1.0).reshape(nb, 8, 4)
    det_res[:, :8, 2:] = gt5[:, :8, 1:] + f(nb, 8, 4, scale=0.02)
    det_res[:, :8, 0] = gt5[:, :8, 0]
    segms = np.zeros((4, 2, 8, 2), np.float32)
    for g in range(4):
        for q in range(2):
            a = np.sort(rng.uniform(0, 2 * np.pi, 8))
            segms[g, q] = rng.uniform(200, 600, 2) + np.stack(
                [np.cos(a), np.sin(a)], 1) * 60
    retina_anc = [boxes(n, 800, 0.02, 0.3) for n in z["retina"]]
    nr = z["rois"]
    rows = [
        ("smooth_l1_loss", {"X": [f(nb * npr, 4)], "Y": [f(nb * npr, 4)],
                            "InsideWeight": [(rng.rand(nb * npr, 4) < 0.1)
                                             .astype(np.float32)]}, {}, False),
        ("sigmoid_cross_entropy_with_logits",
         {"X": [f(nb, 80, npr)], "Label": [rng.rand(nb, 80, npr).astype(
             np.float32)]}, {}, False),
        ("interpolate", {"X": [f(yb, 256, fh, fw)]},
         {"out_h": 2 * fh, "out_w": 2 * fw, "interp_method": "bilinear",
          "align_corners": False}, False),
        ("bilinear_interp", {"X": [f(yb, 256, ns // 2, ns // 2)]},
         {"out_h": ns, "out_w": ns, "align_corners": True}, False),
        ("nearest_interp", {"X": [f(yb, 256, ns // 2, ns // 2)]},
         {"out_h": ns, "out_w": ns, "align_corners": False}, False),
        ("iou_similarity", {"X": [boxes(nb * 50, 1.0)], "Y": [prior]}, {},
         False),
        ("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                       "TargetBox": [np.tile(boxes(npr, 1.0), (nb, 1, 1))]},
         {"code_type": "encode_center_size"}, False),
        ("prior_box", {"Input": [np.zeros((1, 1, 19, 19), np.float32)],
                       "Image": [np.zeros((1, 3, 300, 300), np.float32)]},
         {"min_sizes": [60.0], "aspect_ratios": [2.0], "flip": True,
          "variances": [0.1, 0.1, 0.2, 0.2]}, True),
        ("density_prior_box",
         {"Input": [np.zeros((1, 1, 50, 84), np.float32)],
          "Image": [np.zeros((1, 3, 800, 1333), np.float32)]},
         {"fixed_sizes": [32.0, 64.0], "fixed_ratios": [1.0],
          "densities": [4, 2], "clip": True}, True),
        ("anchor_generator", {"Input": [np.zeros((1, 1, fh, fw),
                                                 np.float32)]},
         anc_attrs, True),
        ("box_clip", {"Input": [(rng.rand(1, fh * fw * 15, 4) * 1500 - 100)
                                .astype(np.float32)], "ImInfo": [im_info]},
         {}, True),
        ("polygon_box_transform", {"Input": [f(yb, 8, 2 * ns, 2 * ns)]}, {},
         False),
        ("roi_pool", {"X": [f(1, 256, fh, fw)],
                      "ROIs": [rois(z["pool_rois"], 800, 1333)]},
         {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 1 / 16},
         False),
        ("roi_align", {"X": [c4], "ROIs": [rois(nr, 800, 1333)]},
         {"pooled_height": 14, "pooled_width": 14, "spatial_scale": 1 / 16,
          "sampling_ratio": 0}, False),
        ("psroi_pool", {"X": [f(1, 21 * 49, fh, fw)],
                        "ROIs": [rois(z["ps_rois"], 800, 1333)]},
         {"output_channels": 21, "pooled_height": 7, "pooled_width": 7,
          "spatial_scale": 1 / 16}, False),
        ("bipartite_match", {"DistMat": [dist]},
         {"match_type": "per_prediction", "dist_threshold": 0.5}, True),
        ("target_assign", {"X": [np.tile(boxes(50, 1.0), (nb, 1, 1))],
                           "MatchIndices": [match]}, {}, True),
        ("mine_hard_examples", {"ClsLoss": [rng.rand(nb, npr).astype(
            np.float32)], "MatchIndices": [match],
            "MatchDist": [rng.rand(nb, npr).astype(np.float32)]},
         {"neg_pos_ratio": 3.0, "neg_overlap": 0.5}, True),
        ("multiclass_nms", {"BBoxes": [dec], "Scores": [sm]},
         {"background_label": 0, "score_threshold": 0.01,
          "nms_threshold": 0.45, "nms_top_k": 400, "keep_top_k": 200}, True),
        ("detection_map", {"DetectRes": [det_res], "Label": [gt5]},
         {"overlap_threshold": 0.5, "ap_type": "11point"}, True),
        ("yolov3_loss", {"X": [f(yb, 3 * 85, ns, ns)], "GTBox": [ygt],
                         "GTLabel": [rng.randint(0, 80, (yb, 50)).astype(
                             np.int32)]},
         {"anchors": yolo_anchors, "anchor_mask": [0, 1, 2],
          "class_num": 80, "ignore_thresh": 0.7, "downsample_ratio": 8},
         False),
        ("generate_proposals",
         {"Scores": [rng.rand(1, 15, fh, fw).astype(np.float32)],
          "BboxDeltas": [f(1, 60, fh, fw, scale=0.3)], "ImInfo": [im_info],
          "Anchors": [anchors], "Variances": [avar]},
         {"pre_nms_topN": z["pre_nms"], "post_nms_topN": z["post_nms"],
          "nms_thresh": 0.7,
          "min_size": 0.0}, False),
        ("rpn_target_assign", {"Anchor": [anchors], "GtBoxes": [gt]},
         {"rpn_batch_size_per_im": 10 ** 7, "rpn_fg_fraction": 0.5}, False),
        ("roi_perspective_transform",
         {"X": [f(1, 256, fh, fw)], "ROIs": [np.float32(quads)]},
         {"transformed_height": 8, "transformed_width": 32}, False),
        ("generate_proposal_labels",
         {"RpnRois": [rois(z["fpn_rois"], 800, 1333)],
          "GtClasses": [rng.randint(1, 81, (20, 1)).astype(np.int32)],
          "IsCrowd": [np.zeros((20, 1), np.int32)], "GtBoxes": [gt],
          "ImInfo": [im_info]},
         {"batch_size_per_im": 512, "class_nums": 81, "use_random": False},
         False),
        ("yolo_box", {"X": [f(yb, 255, ns // 4, ns // 4)],
                      "ImgSize": [np.full((yb, 2), 608, np.int32)]},
         {"anchors": yolo_anchors[12:], "class_num": 80,
          "conf_thresh": 0.005, "downsample_ratio": 32}, False),
        ("sigmoid_focal_loss", {"X": [f(sum(z["retina"]), 80)],
                                "Label": [rng.randint(-1, 81,
                                                      (sum(z["retina"]), 1))
                                          .astype(np.int32)],
                                "FgNum": [np.int32([600])]}, {}, False),
        ("box_decoder_and_assign",
         {"PriorBox": [rois(z["post_nms"], 800, 1333)],
          "PriorBoxVar": [np.float32([0.1, 0.1, 0.2, 0.2])],
          "TargetBox": [f(z["post_nms"], 81 * 4, scale=0.3)],
          "BoxScore": [rng.rand(z["post_nms"], 81).astype(np.float32)]},
         {"box_clip": 4.135}, False),
        ("collect_fpn_proposals",
         {"MultiLevelRois": [rois(z["fpn_rois"], 800, 1333)
                             for _ in range(5)],
          "MultiLevelScores": [rng.rand(z["fpn_rois"], 1).astype(np.float32)
                               for _ in range(5)]},
         {"post_nms_topN": z["fpn_rois"]}, True),
        ("retinanet_target_assign",
         {"Anchor": [np.concatenate(retina_anc)], "GtBoxes": [gt],
          "GtLabels": [rng.randint(1, 81, (20, 1)).astype(np.int32)],
          "IsCrowd": [np.zeros(20, np.int32)], "ImInfo": [im_info]},
         {}, False),
        ("retinanet_detection_output",
         {"BBoxes": [f(1, len(a), 4, scale=0.2) for a in retina_anc],
          "Scores": [f(1, len(a), 80, scale=2.0) - 3.0 for a in retina_anc],
          "Anchors": retina_anc, "ImInfo": [im_info]},
         {"score_threshold": 0.05, "nms_top_k": z["post_nms"],
          "keep_top_k": 100,
          "nms_threshold": 0.5}, False),
        ("generate_mask_labels",
         {"ImInfo": [im_info], "GtClasses": [np.int32([[3], [7], [1], [5]])],
          "IsCrowd": [np.zeros((4, 1), np.int32)], "GtSegms": [segms],
          "SegmsLength": [np.full((4, 2), 8, np.int32)],
          "Rois": [rois(z["quads"], 800, 1333)],
          "LabelsInt32": [rng.randint(0, 81, (z["quads"], 1)).astype(
              np.int32)]},
         {"num_classes": 81, "resolution": 28}, True),
        ("distribute_fpn_proposals",
         {"FpnRois": [rois(z["fpn_rois"], 800, 1333)]},
         {"min_level": 2, "max_level": 5, "refer_level": 4,
          "refer_scale": 224}, True),
    ]
    return rows


def det_rng_invariants(label, dev, bank):
    """The two random ops at their budgets on the card: rpn_target_assign
    at 256 over the C4 anchors, generate_proposal_labels at 512 with
    random priorities; counts within budget, every sampled row a
    candidate the budget-free run (on the CPU) marks, its targets that
    run's within DET_BANK_REL."""
    cpu = torch.device("cpu")
    cases = {n: (ins, attrs) for n, ins, attrs, _ in bank
             if n in ("rpn_target_assign", "generate_proposal_labels")}
    ins, attrs = cases["rpn_target_assign"]
    op = pt.registry.lookup("rpn_target_assign").emitter
    full = op(pt.registry.EmitContext(cpu), {s: _bank_in(v, cpu)
                                            for s, v in ins.items()}, attrs)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = op(pt.registry.EmitContext(dev, generator=gen),
             {s: _bank_in(v, dev) for s, v in ins.items()},
             dict(attrs, rpn_batch_size_per_im=256))
    lab, cand = out["TargetLabel"][0].cpu(), full["TargetLabel"][0]
    fg = lab == 1
    ok = (int(fg.sum()) <= 128 and int((lab >= 0).sum()) <= 256
          and bool((cand[fg] == 1).all()) and bool((cand[lab == 0] == 0).all())
          and bank_error(out["TargetBBox"][0].cpu()[fg],
                         full["TargetBBox"][0][fg]) <= DET_BANK_REL)
    log(f"  {label}: rpn_target_assign at 256 on the card: {int(fg.sum())} "
        f"fg + {int((lab == 0).sum())} bg of {int((cand == 1).sum())} + "
        f"{int((cand == 0).sum())} candidates")
    if not ok:
        raise AssertionError(f"{label}: rpn_target_assign's sample")
    ins, attrs = cases["generate_proposal_labels"]
    op = pt.registry.lookup("generate_proposal_labels").emitter
    out = op(pt.registry.EmitContext(dev, generator=gen),
             {s: _bank_in(v, dev) for s, v in ins.items()},
             dict(attrs, use_random=True))
    labels = out["LabelsInt32"][0].cpu()
    kind = torch.where(labels > 0, 0, torch.where(labels == 0, 1, 2))
    ok = (labels.shape == (512,) and int((labels > 0).sum()) <= 128
          and bool((kind[1:] >= kind[:-1]).all()))
    log(f"  {label}: generate_proposal_labels at 512 on the card: "
        f"{int((labels > 0).sum())} fg, {int((labels == 0).sum())} bg rows")
    if not ok:
        raise AssertionError(f"{label}: generate_proposal_labels' sample")


def det_bank_path(smi):
    """20(D): every one of the 33 types on the card against the port's
    own CPU run on the same seeded inputs (det_bank_cases): selection and
    integer outputs equal, float outputs within DET_BANK_REL of the
    largest magnitude, the gradful types' generic vjps within
    DET_BANK_VJP_REL; the two random ops' samples at their budgets
    (det_rng_invariants); kernels and ms a call of the NMS ops."""
    label = "20(D) detection op bank"
    dev = pt.Executor().device
    timing = {}

    def nms_timing(name, info, args, attrs):
        if name not in ("multiclass_nms", "generate_proposals"):
            return ""
        ctx = pt.registry.EmitContext(dev)
        call = (lambda: info.emitter(ctx, args, attrs))
        rows_t, busy = device_rows(call)
        t = timing[name] = {
            "kernels": sum(r[2] for r in rows_t), "device_ms": busy,
            "ms": time_ms(call, iters=2, warmup=1),
            "eager_ms": time_ms(call, iters=2, warmup=1, graph=False)}
        return (f"; {t['kernels']} kernels a call, {t['ms']:.3f} ms "
                f"(graph replay), {t['eager_ms']:.3f} ms eager, "
                f"{t['device_ms']:.3f} ms of device time")

    bank = det_bank_cases()
    worst = run_bank(label, [(n, ins, attrs, 0.0 if exact else DET_BANK_REL)
                             for n, ins, attrs, exact in bank],
                     DET_BANK_VJP_REL, dev, extra=nms_timing)
    det_rng_invariants(label, dev, bank)
    log(f"  {label}: {len(worst)} types [{smi}]")
    if len(worst) != 33:
        raise AssertionError(f"{label}: {len(worst)} types, not 33")
    return {"types": len(worst), "timing": timing,
            "max_rel": max(e for e, _ in worst.values()),
            "max_vjp_rel": max(v for _, v in worst.values() if v is not None)}


def detection_paths(smi):
    """Phase 20; returns the flash launches of its paths (the wrappers'
    calls over each path's runs, which must be (0, 0): no path holds an
    attention op) and each path's numbers."""
    out, numbers, secs = {}, {}, {}

    def run(name, fn):
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        r = fn()
        calls = (fa.launches, fa.bwd_launches)
        if calls != (0, 0):
            raise AssertionError(f"20 {name}: flash wrapper calls {calls}")
        out[name] = calls
        secs[name] = time.perf_counter() - t0
        return r

    m, scope, initial, exe, feed, numbers["ssd_train"] = run(
        "ssd_train", lambda: ssd_train_path(smi))
    numbers["ssd_eval"] = run(
        "ssd_eval", lambda: ssd_eval_path(m, scope, initial, exe, feed, smi))
    del m, scope, initial, exe
    release()
    numbers["yolov3"] = run("yolov3", lambda: yolo_path(smi))
    release()
    numbers["op_bank"] = run("op_bank", lambda: det_bank_path(smi))
    release()
    log("20: " + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    log("20: " + json.dumps({n: {k: (float(f"{v:.5g}")
                                     if isinstance(v, float) else v)
                                 for k, v in r.items()
                                 if k != "losses"}
                             for n, r in numbers.items()}))
    return out, numbers

# ---------------------------------------------------------------------------
# phase 21: the general tensor, loss and RNN-unit ops
# ---------------------------------------------------------------------------

# 21(A): the Transformer of PaddlePaddle/models' fluid/PaddleNLP
# neural_machine_translation/transformer with its loss (model.py: the
# label smoothed by label_smooth(one_hot(label)), a soft-label
# softmax_with_cross_entropy; config.py label_smooth_eps 0.1) at MODEL's
# widths, batch TRAIN_BATCH, fp32 and bf16 AMP
LS_EPS = tmodels.LABEL_SMOOTH_EPS
# 21(B): the zoo's word2vec (phase 17's widths and batch) with the nce and
# the hsigmoid head
W2V_HEAD_BATCH = 256
W2V_HEAD_STEPS = 12    # steps on one batch, the loss falling
# SGD's rate: the zoo's 0.001 moves the nce loss (about 53 at the start,
# its 10 negatives drawn anew each step) by less than its sampling noise
# in W2V_HEAD_STEPS steps; at 0.1 both heads' losses fall every few steps
W2V_HEAD_LR = 0.1
# 21(C): the op bank, the 35 types on the card against the CPU on the
# same seeded inputs, at the path's shapes: Transformer-base's tokens
# (16 x 256, vocab 32000, width 512), word2vec's (batch 256, dict 2073,
# hidden 256) and DeepASR's stacked_lstmp_model (PaddlePaddle/models
# fluid/DeepASR, hidden 1024, projection 512), batch 16 of 32 frames
TLR_BANK_REL = 1e-5    # float outputs, of each output's largest magnitude
TLR_TRUNC_TOL = 0.01   # truncated_gaussian_random's mean and deviation,
                       # of std, over 2^20 draws


def label_smooth_path(smi):
    """21(A): testing.models.transformer_label_smooth at MODEL's widths
    through CompiledProgram under bench.py's BuildStrategy, fp32 and AMP:
    REC_RUNS steps captured against eager bitwise on one batch
    (zoo_train), the loss falling over the captured steps; the flash
    kernel nodes of the step's graph exactly FWD_PER_STEP and
    BWD_PER_STEP (its DOT dump) and the wrappers' calls those of the
    eager runs, the warm-up and the capture; then the one-hot, smoothing
    and soft-label cross entropy kernels alone on the path's tensors,
    timed by graph replay and traced (a window of ZOO_TRACED calls). Returns the wrappers' calls and the path's numbers."""
    label = "21(A) Transformer label smoothing"
    m, state, exe = built_on_card(
        lambda: tmodels.transformer_label_smooth(pt, **MODEL))
    cfg = m["config"]
    feed = train_batch(cfg, TRAIN_BATCH, SEED + 2100)
    tokens = int(feed["trg_len"].sum())
    log(f"  transformer_label_smooth {MODEL}, label_smooth_eps {LS_EPS}: "
        f"{len(state)} persistables; batch {TRAIN_BATCH}, {tokens} target "
        "tokens")
    step = (FWD_PER_STEP, BWD_PER_STEP)
    calls, numbers = [0, 0], {}
    for arm, program in (("fp32", m["main"]),
                         ("AMP", mixed_precision.decorate(m["main"].clone()))):
        lab = f"{label} {arm}"
        target = pt.CompiledProgram(program,
                                    build_strategy=bench_build_strategy())
        fa.launches = fa.bwd_launches = 0
        with graphs_kept() as graphs:
            scope, steps, res = zoo_train(
                lab, exe, target, state, [m["loss"].name],
                [feed] * REC_RUNS, ("target tokens", tokens), smi,
                runs=REC_RUNS, flash_per_step=step)
        got = (fa.launches, fa.bwd_launches)
        # the eager arm's steps, the captured arm's warm-up and capture
        # (on the CPU, every run of both arms and of the traced window)
        runs_in = REC_RUNS + (2 if exe.device.type == "cuda"
                              else REC_RUNS + ZOO_TRACED)
        want = (runs_in * step[0], runs_in * step[1])
        if exe.device.type == "cuda":
            if len(graphs) != 1:
                raise AssertionError(f"{lab}: {len(graphs)} graphs captured, "
                                     "want 1")
            nodes, n_nodes = graph_flash_nodes(graphs[0])
        else:  # no graph on the CPU: the rehearsal's eager steps
            nodes, n_nodes = step, None
        log(f"  {lab}: flash wrapper calls {got} (want {want}); the step's "
            f"graph: flash kernel nodes {nodes} of {n_nodes} kernel nodes "
            f"(want {step})")
        if got != want or tuple(nodes) != step:
            raise AssertionError(f"{lab}: wrapper calls {got}, want {want}; "
                                 f"graph nodes {nodes}, want {step}")
        calls = [a + b for a, b in zip(calls, got)]
        res["losses"] = falls(lab, steps)
        res["graph_kernels"] = n_nodes
        numbers[arm] = res
        del graphs, scope, steps, target
        exe.close()
        release()

    # the loss's own kernels, each traced alone on the path's tensors
    dev = exe.device
    ctx = pt.registry.EmitContext(dev)
    rng = np.random.RandomState(SEED + 2101)
    emit = {t: pt.registry.lookup(t).emitter for t in (
        "one_hot", "scale", "softmax_with_cross_entropy",
        "softmax_with_cross_entropy_grad")}
    smooth = [op for op in m["main"].global_block().ops
              if op.type == "scale"
              and op.output("Out")[0] == m["smoothed"].name][0].attrs
    lbl = [torch.from_numpy(feed["lbl_word"]).to(dev)]
    onehot = emit["one_hot"](ctx, {"X": lbl}, {"depth": cfg["tgt_vocab"]})
    soft = emit["scale"](ctx, {"X": onehot["Out"]}, smooth)["Out"]
    logits = [torch.from_numpy(rng.randn(
        TRAIN_BATCH, cfg["max_len"], cfg["tgt_vocab"]).astype(np.float32))
        .to(dev)]
    ce_attrs = {"soft_label": True, "ignore_index": -100}
    ce_ins = {"Logits": logits, "Label": soft}
    loss = emit["softmax_with_cross_entropy"](ctx, ce_ins, ce_attrs)["Loss"]
    grad_ins = dict(ce_ins, **{"Loss@GRAD": [torch.ones_like(loss[0])]})
    want = (torch.from_numpy(feed["lbl_word"][..., 0]).to(dev)
            .unsqueeze(-1) == torch.arange(cfg["tgt_vocab"], device=dev))
    if not torch.equal(onehot["Out"][0], want.float()):
        raise AssertionError(f"{label}: one_hot of the labels")
    alone = {}
    for name, fn in (
            ("one_hot", lambda: emit["one_hot"](
                ctx, {"X": lbl}, {"depth": cfg["tgt_vocab"]})),
            ("smoothing (scale)", lambda: emit["scale"](
                ctx, {"X": onehot["Out"]}, smooth)),
            ("soft-label cross entropy", lambda: emit[
                "softmax_with_cross_entropy"](ctx, ce_ins, ce_attrs)),
            ("its grad", lambda: emit["softmax_with_cross_entropy_grad"](
                ctx, grad_ins, ce_attrs))):
        # graph replay times the call (4 replayed calls: each writes
        # [16, 256, 32000] floats); a trace counts its kernels, and may
        # give nothing back in some processes (PERF.md §7)
        ms = time_ms(fn, iters=4, warmup=1)
        try:
            rows, busy = traced_window(f"{label} {name}", fn)
            kernels = sum(r[2] for r in rows) / ZOO_TRACED
        except RuntimeError as e:
            log(f"  {label} {name}: {e} twice; no trace")
            busy = kernels = None
        alone[name] = {"ms": ms, "device_ms": busy, "kernels": kernels}
    dev_ms = numbers["fp32"]["device_ms"]
    log(f"  {label}: alone on [{TRAIN_BATCH}, {cfg['max_len']}, "
        f"{cfg['tgt_vocab']}], ms a call by graph replay (a traced window's "
        "device ms and kernels a call): " + "; ".join(
            f"{n} {a['ms']:.3f} ms ({a['ms'] / dev_ms:.1%} of the fp32 "
            "step's device time; traced " + (
                f"{a['device_ms']:.3f} ms, {a['kernels']:.0f} kernels)"
                if a["kernels"] is not None else "none)")
            for n, a in alone.items())
        + f" [{smi}]")
    numbers["loss_kernels"] = alone
    del logits, soft, onehot, loss, grad_ins, ce_ins
    return tuple(calls), numbers


def word2vec_heads_path(smi):
    """21(B): testing.models.word2vec_heads with each head at the zoo's
    word2vec widths, batch W2V_HEAD_BATCH, SGD at W2V_HEAD_LR, through
    CompiledProgram:
    ZOO_RUNS steps captured against eager bitwise (the nce head's drawn
    SampleLabels among the fetches: the graph draws the eager arm's
    negatives, step by step), the negatives drawn anew each captured step,
    the loss falling over W2V_HEAD_STEPS steps on one batch."""
    out = {}
    feed = word2vec.make_fake_batch(W2V_HEAD_BATCH, seed=SEED + 2110)
    for head in tmodels.WORD2VEC_HEADS:
        label = f"21(B) word2vec {head}"
        m, state, exe = built_on_card(
            lambda: tmodels.word2vec_heads(pt, head=head, lr=W2V_HEAD_LR))
        target = pt.CompiledProgram(m["main"],
                                    build_strategy=bench_build_strategy())
        fetch = [m["loss"].name] + [
            op.output("SampleLabels")[0]
            for op in m["main"].global_block().ops if op.type == "nce"]
        scope, steps, res = zoo_train(label, exe, target, state, fetch,
                                      [feed] * ZOO_RUNS,
                                      ("rows", W2V_HEAD_BATCH), smi)
        if head == "nce":
            draws = [o[1] for _, o in steps[2:]]
            same = sum(torch.equal(a, b) for a, b in zip(draws, draws[1:]))
            log(f"  {label}: {len(draws)} replays' negatives, "
                f"{same} equal to the previous replay's")
            if same or draws[0].shape != (W2V_HEAD_BATCH, 11):
                raise AssertionError(f"{label}: the replays do not draw "
                                     "anew")
        while len(steps) < W2V_HEAD_STEPS:
            steps.append((feed, run_tensors(exe, target, feed=feed,
                                            fetch_list=fetch, scope=scope)))
        res["losses"] = falls(label, steps)
        out[head] = res
        exe.close()
        release()
    return out


def tlr_bank_cases():
    """(op type, numpy inputs, attrs, bound) of 21(C)'s bank: the 32
    deterministic types (truncated_gaussian_random, nce and nce_grad have
    checks of their own, tlr_rng_cases)."""
    rng = np.random.RandomState(SEED + 2120)
    b, t, d, v = TRAIN_BATCH, MODEL["max_len"], MODEL["d_model"], \
        MODEL["tgt_vocab"]
    n = b * t

    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    def labels01(rows):
        return rng.randint(0, 2, (rows, 1)).astype(np.float32)

    x = f(b, t, d)
    ids = rng.randint(0, v, (n, 1)).astype(np.int64)
    rows_up = min(4096, v)   # scatter's unique rows
    scores = f(64, 4096)
    lens = rng.randint(1, 33, 16).astype(np.int64)
    lens[0] = 32
    rows = [
        ("reshape", {"X": [x]}, {"shape": [0, -1]}),
        ("squeeze", {"X": [f(b, t, 1)]}, {"axes": [2]}),
        ("stack", {"X": [x, f(b, t, d), f(b, t, d)]}, {"axis": 1}),
        ("unstack", {"X": [f(b, 6, d)]}, {"axis": 1, "num": 6}),
        ("scatter", {"X": [f(v, d)], "Ids": [rng.permutation(v)[:rows_up]
                                             .astype(np.int64)],
                     "Updates": [f(rows_up, d)]}, {"overwrite": True}),
        ("one_hot", {"X": [ids]}, {"depth": v}),
        ("arg_max", {"X": [f(n, v)]}, {"axis": -1}),
        ("arg_min", {"X": [np.round(scores)]}, {"axis": 1}),
        ("argsort", {"X": [np.round(scores * 4)]}, {"axis": -1}),
        ("cumsum", {"X": [scores]}, {"axis": 1, "exclusive": True,
                                     "reverse": True}),
        ("shape", {"Input": [x]}, {}),
        ("range", {"Start": [np.array([0], np.int64)],
                   "End": [np.array([n], np.int64)],
                   "Step": [np.array([1], np.int64)]}, {"num": n}),
        ("pad", {"X": [x]}, {"paddings": [0, 0, 0, 16, 0, 0],
                             "pad_value": 0.0}),
        ("pad2d", {"X": [f(b, 64, 56, 56)]},
         {"paddings": [1, 1, 1, 1], "mode": "reflect"}),
        ("flatten", {"X": [x]}, {"axis": 2}),
        ("flatten2", {"X": [x]}, {"axis": 1}),
        ("hinge_loss", {"Logits": [f(n, 1)], "Labels": [labels01(n)]}, {}),
        ("rank_loss", {"Label": [labels01(n)], "Left": [f(n, 1)],
                       "Right": [f(n, 1)]}, {}),
        ("margin_rank_loss", {"Label": [np.sign(f(n, 1))], "X1": [f(n, 1)],
                              "X2": [f(n, 1)]}, {"margin": 0.1}),
        ("bpr_loss", {"X": [f(W2V_HEAD_BATCH, word2vec.VOCAB_SIZE)],
                      "Label": [rng.randint(0, word2vec.VOCAB_SIZE,
                                            (W2V_HEAD_BATCH, 1))
                                .astype(np.int64)]}, {}),
        ("modified_huber_loss", {"X": [f(n, 1) * 2], "Y": [labels01(n)]}, {}),
        ("teacher_student_sigmoid_loss",
         {"X": [f(n, 1)], "Label": [rng.choice(
             [-2.0, -1.0, 0.25, 0.75, 1.25, 1.75], (n, 1))
             .astype(np.float32)]}, {}),
        ("squared_l2_distance", {"X": [f(n, d)], "Y": [f(n, d)]}, {}),
        ("squared_l2_norm", {"X": [f(n, d)]}, {}),
        ("l1_norm", {"X": [f(n, d)]}, {}),
        ("minus", {"X": [f(n, d)], "Y": [f(n, d)]}, {}),
        ("hierarchical_sigmoid",
         {"X": [f(W2V_HEAD_BATCH, 256)],
          "Label": [rng.randint(0, word2vec.VOCAB_SIZE, (W2V_HEAD_BATCH, 1))
                    .astype(np.int64)],
          "W": [f(word2vec.VOCAB_SIZE - 1, 256) * 0.05],
          "Bias": [f(word2vec.VOCAB_SIZE - 1, 1)]},
         {"num_classes": word2vec.VOCAB_SIZE}),
        ("positive_negative_pair",
         {"Score": [np.round(f(n, 1) * 4)], "Label": [
             rng.randint(0, 5, (n, 1)).astype(np.float32)],
          "QueryID": [rng.randint(0, 64, (n, 1)).astype(np.int64)]}, {}),
        ("label_smooth", {"X": [np.eye(v, dtype=np.float32)[
            rng.randint(0, v, t)]]}, {"epsilon": LS_EPS}),
        ("lstm_unit", {"X": [f(16, 4 * 1024)], "C_prev": [f(16, 1024)]},
         {"forget_bias": 1.0}),
        ("gru_unit", {"Input": [f(16, 3 * 512)], "HiddenPrev": [f(16, 512)],
                      "Weight": [f(512, 3 * 512) * 0.05],
                      "Bias": [f(1, 3 * 512)]}, {"origin_mode": False}),
        ("lstmp", {"Input": [f(16, 32, 4 * 1024)],
                   "Weight": [f(512, 4 * 1024) * 0.03],
                   "ProjWeight": [f(1024, 512) * 0.03],
                   "Bias": [f(4 * 1024)], "Length": [lens]},
         {"use_peepholes": False}),
    ]
    return [(name, ins, attrs, TLR_BANK_REL) for name, ins, attrs in rows]


def tlr_rng_cases(label, dev):
    """The random type and nce on the card: truncated_gaussian_random's
    2^20 draws inside mean +- 2 std with the truncated normal's mean and
    deviation (std * 0.8796) within TLR_TRUNC_TOL of std; nce at the zoo
    word2vec's dict (2073 classes, 10 negatives) drawn on the card, its
    SampleLabels the labels then classes in range, its Cost and
    SampleLogits against the same samples' cost on the CPU within
    TLR_BANK_REL, and nce_grad on those samples card against CPU within
    BANK_VJP_REL. Returns {type: (error, vjp error or None)}."""
    from paddle_tpu_torch.ops.kernels_loss import _nce_cost, _nce_logits
    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {}
    draw = pt.registry.lookup("truncated_gaussian_random").emitter(
        pt.registry.EmitContext(dev, generator=gen), {},
        {"shape": [1024, 1024], "mean": 0.5, "std": 2.0,
         "dtype": pt.DataType.FP32})["Out"][0].double()
    phi2 = math.exp(-2.0) / math.sqrt(2 * math.pi)
    sd = 2.0 * math.sqrt(1 - 4 * phi2 / math.erf(math.sqrt(2.0)))
    err = max(abs(float(draw.mean()) - 0.5), abs(float(draw.std()) - sd)) / 2
    inside = bool((draw >= 0.5 - 4.0).all() and (draw <= 0.5 + 4.0).all())
    log(f"  {label}: truncated_gaussian_random 2^20 draws on the card: mean "
        f"{float(draw.mean()):.5f} (want 0.5), deviation "
        f"{float(draw.std()):.5f} (want {sd:.5f}), {err:.3e} of std (bound "
        f"{TLR_TRUNC_TOL}); all inside the bounds: {inside}")
    if not (inside and err <= TLR_TRUNC_TOL):
        raise AssertionError(f"{label}: truncated_gaussian_random")
    worst["truncated_gaussian_random"] = (err, None)

    rng = np.random.RandomState(SEED + 2121)
    c, s = word2vec.VOCAB_SIZE, 10
    ins = {"Input": [rng.randn(W2V_HEAD_BATCH, 256).astype(np.float32)],
           "Label": [rng.randint(0, c, (W2V_HEAD_BATCH, 1)).astype(np.int64)],
           "Weight": [rng.randn(c, 256).astype(np.float32) * 0.05],
           "Bias": [rng.randn(c, 1).astype(np.float32) * 0.1]}
    attrs = {"num_total_classes": c, "num_neg_samples": s}
    card = {k: _bank_in(v, dev) for k, v in ins.items()}
    out = pt.registry.lookup("nce").emitter(
        pt.registry.EmitContext(dev, generator=gen), card, attrs)
    samples = out["SampleLabels"][0]
    host = {k: _bank_in(v, cpu) for k, v in ins.items()}
    sc = _nce_logits(host["Input"][0], host["Weight"][0], host["Bias"][0],
                     samples.cpu())
    err = max(bank_error(out["SampleLogits"][0].cpu(), sc),
              bank_error(out["Cost"][0].cpu(), _nce_cost(sc, math.log(s / c))))
    ok = (samples.shape == (W2V_HEAD_BATCH, 1 + s)
          and torch.equal(samples[:, 0].cpu(), host["Label"][0][:, 0])
          and int(samples.min()) >= 0 and int(samples.max()) < c)
    gout = rng.randn(W2V_HEAD_BATCH, 1).astype(np.float32)
    grads = [_bank_flat(pt.registry.lookup("nce_grad").emitter(
        pt.registry.EmitContext(where),
        dict({k: _bank_in(v, where) for k, v in ins.items()},
             SampleLabels=[samples.to(where)],
             **{"Cost@GRAD": [_bank_in(gout, where)]}), attrs))
        for where in (dev, cpu)]
    vjp = max(bank_error(g, w) for (_, g), (_, w) in zip(*grads))
    log(f"  {label}: nce at {c} classes, {s} negatives, batch "
        f"{W2V_HEAD_BATCH} on the card: SampleLabels the labels then "
        f"classes in range: {ok}; Cost and SampleLogits against the CPU's "
        f"cost of the same samples {err:.3e} of the largest (bound "
        f"{TLR_BANK_REL}); nce_grad on them card against CPU {vjp:.3e} "
        f"(bound {BANK_VJP_REL}), {len(grads[0])} gradients")
    if not (ok and err <= TLR_BANK_REL and vjp <= BANK_VJP_REL
            and len(grads[0]) == 3):
        raise AssertionError(f"{label}: nce")
    worst["nce"] = (err, None)
    worst["nce_grad"] = (vjp, vjp)
    return worst


def tlr_scatter_add(label, dev):
    """scatter with overwrite=False over repeated ids (a Transformer-base
    batch's 16 x 256 ids into the 32000 x 512 rows, drawn from the first
    1000 rows, so most repeat) on the card twice under deterministic():
    the two results bitwise equal, no op warned, and within TLR_BANK_REL
    of the CPU's; its vjp within BANK_VJP_REL. Returns (error, vjp
    error)."""
    cpu = torch.device("cpu")
    rng = np.random.RandomState(SEED + 2122)
    v, d, n = MODEL["tgt_vocab"], MODEL["d_model"], \
        TRAIN_BATCH * MODEL["max_len"]
    ins = {"X": [rng.randn(v, d).astype(np.float32)],
           "Ids": [rng.randint(0, 1000, n).astype(np.int64)],
           "Updates": [rng.randn(n, d).astype(np.float32)]}
    attrs = {"overwrite": False}
    info = pt.registry.lookup("scatter")

    def out(where):
        return info.emitter(pt.registry.EmitContext(where),
                            {s: _bank_in(a, where) for s, a in ins.items()},
                            attrs)

    with deterministic() as warned:
        got = [out(dev)["Out"][0] for _ in range(2)]
        torch.cuda.synchronize()
    want = out(cpu)
    same = torch.equal(got[0], got[1])
    err = bank_error(got[0].cpu(), want["Out"][0])
    vjp = bank_vjp(label, "scatter", ins, attrs, info, dev, want)
    log(f"  {label}: scatter add ({n - len(np.unique(ins['Ids'][0]))} of "
        f"{n} ids repeated) twice on the card under the deterministic "
        f"mode: bitwise equal {same}, warnings {warned or 'none'}; "
        f"{err:.3e} of the largest from the CPU (bound {TLR_BANK_REL}); "
        f"vjp {vjp:.3e} (bound {BANK_VJP_REL})")
    if not (same and not warned and err <= TLR_BANK_REL
            and vjp <= BANK_VJP_REL):
        raise AssertionError(f"{label}: scatter add")
    return err, vjp


def tlr_bank_path(smi):
    """21(C): the 35 types on the card against the port's own CPU run on
    the same seeded inputs (tlr_bank_cases through run_bank: integer
    outputs equal, float outputs within TLR_BANK_REL of the largest
    magnitude, the gradful types' generic vjps within BANK_VJP_REL),
    scatter's add over repeated ids (tlr_scatter_add) and the random ones
    (tlr_rng_cases)."""
    label = "21(C) tensor, loss and RNN-unit op bank"
    dev = pt.Executor().device
    worst = run_bank(label, tlr_bank_cases(), BANK_VJP_REL, dev)
    add = tlr_scatter_add(label, dev)
    worst["scatter"] = tuple(map(max, worst["scatter"], add))
    worst.update(tlr_rng_cases(label, dev))
    log(f"  {label}: {len(worst)} types [{smi}]")
    if len(worst) != 35:
        raise AssertionError(f"{label}: {len(worst)} types, not 35")
    return {"types": len(worst),
            "max_rel": max(e for e, _ in worst.values()),
            "max_vjp_rel": max(v for _, v in worst.values() if v is not None)}


def tensor_loss_rnn_paths(smi):
    """Phase 21; returns the flash launches of its paths (the wrappers'
    calls over each path's runs: 21(A)'s eager runs, warm-ups and
    captures; (0, 0) for the others, which hold no attention op) and
    each path's numbers."""
    out, numbers, secs = {}, {}, {}

    def run(name, fn, flash):
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        r = fn()
        calls = (fa.launches, fa.bwd_launches)
        if flash:
            calls, r = r
        elif calls != (0, 0):
            raise AssertionError(f"21 {name}: flash wrapper calls {calls}")
        out[name] = calls
        secs[name] = time.perf_counter() - t0
        return r

    numbers["label_smooth"] = run(
        "transformer_label_smooth", lambda: label_smooth_path(smi), True)
    release()
    numbers["word2vec_heads"] = run(
        "word2vec_heads", lambda: word2vec_heads_path(smi), False)
    release()
    numbers["op_bank"] = run("tlr_op_bank", lambda: tlr_bank_path(smi),
                             False)
    release()
    log("21: " + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    log("21: " + json.dumps(numbers, default=lambda v: str(v),
                            sort_keys=True)[:4000])
    return out, numbers


# ---------------------------------------------------------------------------
# phase 22: the image and NN op families
# ---------------------------------------------------------------------------

# 22(A): SimpleBaseline human pose (Xiao et al. 2018) as PaddleCV's
# human_pose_estimation builds it (testing.models.pose_resnet's defaults:
# ResNet-50, three 256-filter 4x4 stride-2 deconvolutions, 16 MPII joints
# at 256x256, heatmaps 64x64, Adam at 1e-3), at the paper's 32 images a
# card, fp32 and AMP
POSE = {}
POSE_BATCH = tmodels.POSE_BATCH
# steps on one batch (REC_RUNS captured against eager, the traced window,
# then more): Adam's first step moves every weight by about its rate, as
# large as the head's N(0, 0.001) init, so the loss jumps at step 2
# (0.0027 -> 0.0121 at MPII widths) and falls below the first over the
# steps after
POSE_STEPS = 20
POSE_SERVE_TOL = 1e-5  # served heatmaps against the executor's, of the
                       # largest magnitude
# 22(B): ResNet-50 with resnet_with_preprocess.py's in-graph pipeline at the
# JAX build's default raw shape (252x252x3 uint8, cropped to 224), batch
# 128, AMP
PRE_RESNET = dict(dataset="flowers", depth=50, class_dim=RESNET_CLASSES,
                  image_shape=list(RESNET_IMAGE), preprocess=True)
PRE_RESNET_BATCH = RESNET_BATCH
CROP_CALLS = 16        # random_crop calls at the path's shape, for the
                       # offsets' frequencies (16 x 128 draws a dim)
CROP_SIGMAS = 5.0      # an offset's count against its binomial deviation
# 22(C): the op bank, the 36 types on the card against the CPU, at the
# paths' shapes and C3D's video clip (Tran et al. 2015: 16 frames of
# 112x112, batch 8)
C3D_CLIP = (8, 3, 16, 112, 112)
VISION_BANK_REL = 1e-5   # float outputs, of each output's largest magnitude
VISION_MOMENT_TOL = 0.01  # the random types' means and deviations, of the
                          # scale, over 2^20 draws
VISION_RAND_SIGMAS = 5.0  # sampling_id's counts against their deviations


def pose_deconv_ms(m, state, batch, first_dtype):
    """The three deconvolutions of the pose head alone at a step's
    shapes, forward and the generic vjp (conv2d_transpose_grad, which
    runs the forward again): ms by graph replay, summed."""
    dev = next(iter(state.values())).device
    ctx = pt.registry.EmitContext(dev)
    emit = pt.registry.lookup("conv2d_transpose").emitter
    block = m["main"].global_block()
    total, rng = 0.0, np.random.RandomState(SEED + 2201)
    for i, op in enumerate(op for op in block.ops
                           if op.type == "conv2d_transpose"):
        shape = [batch] + list(block.var(op.input("Input")[0]).shape[1:])
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
        if i == 0:
            x = x.to(first_dtype)
        ins = {"Input": [x], "Filter": [state[op.input("Filter")[0]]]}
        out = emit(ctx, ins, op.attrs)["Output"][0]
        gins = dict(ins, **{"Output@GRAD": [torch.ones_like(out)]})
        gattrs = dict(op.attrs, __fwd_type__="conv2d_transpose")
        total += time_ms(lambda: emit(ctx, ins, op.attrs), iters=4, warmup=1)
        total += time_ms(lambda: pt.registry.generic_vjp_grad_emitter(
            ctx, gins, gattrs), iters=4, warmup=1)
    return total


def pose_serve(label, exe, m, scope, feed):
    """The trained scope's test program (image -> heatmaps) saved and
    served by AnalysisPredictor (its default passes) and NativePredictor
    on the card: each within POSE_SERVE_TOL of the executor's test-program
    run, of its largest magnitude."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    d = tempfile.mkdtemp(prefix="chip_smoke_pose_", dir=_build.BUILD_DIR)
    try:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, ["image"], [m["heatmaps"]], exe,
                                       main_program=m["test"])
        req = {"image": feed["image"]}
        got = {}
        for name, cfg in (("AnalysisPredictor", AnalysisConfig(d)),
                          ("NativePredictor", NativeConfig(d))):
            pred = create_paddle_predictor(cfg)
            got[name] = [pred.run(req)[0].as_tensor() for _ in range(2)][-1]
            pred.close()
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
    (want,) = run_tensors(exe, m["test"], feed=feed,
                          fetch_list=[m["heatmaps"]], scope=scope)
    top = want.abs().max().item()
    errs = {n: distance(g.float(), want.float()) / max(top, 1e-30)
            for n, g in got.items()}
    log(f"  {label}: served heatmaps {tuple(want.shape)} against the "
        "executor's test program: " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items())
        + f" of the largest {top:.3e} (bound {POSE_SERVE_TOL})")
    if not (top > 0 and all(g.shape == want.shape for g in got.values())
            and max(errs.values()) <= POSE_SERVE_TOL):
        raise AssertionError(f"{label}: served heatmaps {errs}")
    return errs


def pose_path(smi):
    """22(A): testing.models.pose_resnet at POSE (MPII widths) through
    CompiledProgram under bench.py's BuildStrategy, fp32 and AMP: REC_RUNS
    steps captured against eager bitwise on one batch (zoo_train), the
    loss falling below the first over POSE_STEPS steps; the
    deconvolutions' share of each step (pose_deconv_ms); the fp32-trained
    scope served (pose_serve)."""
    label = "22(A) SimpleBaseline pose"
    m, state, exe = built_on_card(lambda: tmodels.pose_resnet(pt, **POSE))
    cfg = m["config"]
    feed = tmodels.pose_batch(POSE_BATCH, cfg["image"], cfg["joints"],
                              SEED + 2200)
    log(f"  pose_resnet {cfg}: {len(state)} persistables, "
        f"{sum(t.numel() for t in state.values()) / 1e6:.2f} M values; batch "
        f"{POSE_BATCH}")
    numbers, trained = {}, None
    for arm, program in (("fp32", m["main"]),
                         ("AMP", mixed_precision.decorate(m["main"].clone()))):
        lab = f"{label} {arm}"
        target = pt.CompiledProgram(program,
                                    build_strategy=bench_build_strategy())
        scope, steps, res = zoo_train(lab, exe, target, state,
                                      [m["loss"].name], [feed] * REC_RUNS,
                                      ("images", POSE_BATCH), smi,
                                      runs=REC_RUNS)
        while len(steps) < POSE_STEPS:
            steps.append((feed, run_tensors(exe, target, feed=feed,
                                            fetch_list=[m["loss"].name],
                                            scope=scope)))
        res["losses"] = falls(lab, steps)
        head = pose_deconv_ms(m, state, POSE_BATCH, torch.float32
                              if arm == "fp32" else torch.bfloat16)
        res["deconv_ms"], res["deconv_share"] = head, head / res["captured_ms"]
        log(f"  {lab}: the three deconvolutions alone (forward and generic "
            f"vjp, float32) {head:.3f} ms, {res['deconv_share']:.1%} of the "
            f"captured step [{smi}]")
        numbers[arm] = res
        if arm == "fp32":
            trained = scope
        else:
            del scope
        del steps, target
    numbers["serve"] = pose_serve(label, exe, m, trained, feed)
    exe.close()
    return numbers


def coded_raw(b, h, w):
    """A raw uint8 batch [b, h, w, 3] whose channels code (row, column,
    example), so a crop tells its own offsets."""
    raw = np.zeros((b, h, w, 3), np.uint8)
    raw[..., 0] = np.arange(h).reshape(1, h, 1)
    raw[..., 1] = np.arange(w).reshape(1, 1, w)
    raw[..., 2] = np.arange(b).reshape(b, 1, 1)
    return raw


def crop_offsets(crop, h, w):
    """(row offsets, column offsets) of a batch of crops of a coded_raw
    batch [b, h, w, 3], or None unless every crop is the exact slice of
    its own example inside the bounds."""
    b, ch, cw, _ = crop.shape
    dev = crop.device
    oy, ox = crop[:, 0, 0, 0].long(), crop[:, 0, 0, 1].long()
    rows = oy.reshape(b, 1, 1) + torch.arange(ch, device=dev).reshape(1, -1, 1)
    cols = ox.reshape(b, 1, 1) + torch.arange(cw, device=dev).reshape(1, 1, -1)
    exact = bool((crop[..., 0].long() == rows).all()
                 and (crop[..., 1].long() == cols).all()
                 and (crop[..., 2].long()
                      == torch.arange(b, device=dev).reshape(b, 1, 1)).all())
    inside = int(oy.max()) <= h - ch and int(ox.max()) <= w - cw
    return (oy, ox) if exact and inside else None


def crop_check(label, dev, raw_shape, crop_shape):
    """random_crop on the card at the path's shape, CROP_CALLS calls on a
    coded_raw batch from one generator: every crop the exact slice of
    its own example inside the bounds (crop_offsets), each offset's count
    within CROP_SIGMAS binomial deviations of uniform, and the examples
    of a call at differing offsets. Returns the largest deviation."""
    b = PRE_RESNET_BATCH
    h, w, _ = raw_shape
    raw = torch.from_numpy(coded_raw(b, h, w)).to(dev)
    ctx = pt.registry.EmitContext(
        dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    emit = pt.registry.lookup("random_crop").emitter
    span = (h - crop_shape[0] + 1, w - crop_shape[1] + 1)
    counts = [np.zeros(s, np.int64) for s in span]
    exact, spread = True, True
    for _ in range(CROP_CALLS):
        offsets = crop_offsets(emit(ctx, {"X": [raw]},
                                    {"shape": list(crop_shape)})["Out"][0],
                               h, w)
        if offsets is None:
            exact = False
            break
        spread &= len(set(zip(*(o.tolist() for o in offsets)))) > 1
        for c, o in zip(counts, offsets):
            c += np.bincount(o.cpu().numpy(), minlength=len(c))
    n = CROP_CALLS * b
    worst = max(float(np.max(np.abs(c - n / len(c))
                             / np.sqrt(n * (1 / len(c)) * (1 - 1 / len(c)))))
                for c in counts)
    log(f"  {label}: random_crop [{b}, {h}, {w}, 3] -> {list(crop_shape)} on "
        f"the card, {CROP_CALLS} calls: every crop the exact slice of its "
        f"own example inside [0, {span[0] - 1}] x [0, {span[1] - 1}] "
        f"{exact}, examples at differing offsets {spread}; the offsets' "
        f"counts at most {worst:.2f} deviations from uniform (bound "
        f"{CROP_SIGMAS})")
    if not (exact and spread and worst <= CROP_SIGMAS):
        raise AssertionError(f"{label}: random_crop's draws")
    return worst


def resnet_preprocess_path(smi):
    """22(B): resnet.build(preprocess=True) (raw_image [252, 252, 3] uint8,
    the in-graph random_crop -> cast -> transpose -> scale -> normalize)
    AMP through CompiledProgram under bench.py's BuildStrategy: REC_RUNS
    steps captured against eager bitwise on one raw batch (each arm draws
    the same crops from its fresh generator), every loss finite (ResNet-50
    on one batch at momentum's 0.01 is not held to fall, as in phase 9);
    then the test program's pipeline (preprocess_check). The crop op's
    draws are 22(C)'s (crop_check)."""
    label = "22(B) ResNet-50 with preprocessing"
    m, state, exe = built_on_card(lambda: resnet.build(**PRE_RESNET))
    raw_shape = tuple(m["main"].global_block().var("raw_image").shape[1:])
    rng = np.random.RandomState(SEED + 2210)
    feed = {"raw_image": rng.randint(0, 256, (PRE_RESNET_BATCH,) + raw_shape)
            .astype(np.uint8),
            "label": rng.randint(0, PRE_RESNET["class_dim"],
                                 (PRE_RESNET_BATCH, 1)).astype(np.int64)}
    log(f"  resnet.build({PRE_RESNET}): raw {list(raw_shape)} uint8, batch "
        f"{PRE_RESNET_BATCH}")
    target = pt.CompiledProgram(mixed_precision.decorate(m["main"].clone()),
                                build_strategy=bench_build_strategy())
    scope, steps, res = zoo_train(f"{label} AMP", exe, target, state,
                                  [m["loss"].name], [feed] * REC_RUNS,
                                  ("images", PRE_RESNET_BATCH), smi,
                                  runs=REC_RUNS)
    res["losses"] = [float(o[0].float().reshape(-1)[0]) for _, o in steps]
    res["pipeline_err"] = preprocess_check(label, exe, m, scope, raw_shape)
    del scope, steps, target
    exe.close()
    return res


def preprocess_check(label, exe, m, scope, raw_shape):
    """The test program's pipeline on the card, eager, on a coded_raw
    batch: every crop the exact slice of its own example inside the
    bounds (crop_offsets), and the network's input the crop / 255
    normalized by IMAGE_MEAN and IMAGE_STD (computed here in float32 on
    the card) within 1e-6. Returns the input's largest distance."""
    b = PRE_RESNET_BATCH
    h, w, _ = raw_shape
    ops = m["test"].global_block().ops
    crop = next(o for o in ops if o.type == "random_crop").output("Out")[0]
    net_in = next(o for o in ops
                  if o.type == "elementwise_div").output("Out")[0]
    with jit_cache(False):
        got_crop, got_in = run_tensors(
            exe, m["test"], feed={"raw_image": coded_raw(b, h, w),
                                  "label": np.zeros((b, 1), np.int64)},
            fetch_list=[crop, net_in], scope=scope)
    exact = crop_offsets(got_crop, h, w) is not None
    dev = got_crop.device
    mean = torch.tensor(resnet.IMAGE_MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(resnet.IMAGE_STD, device=dev).reshape(1, 3, 1, 1)
    want = (got_crop.permute(0, 3, 1, 2).float() * (1.0 / 255.0) - mean) / std
    err = distance(got_in, want)
    log(f"  {label}: the test program's pipeline on the card: crops "
        f"{tuple(got_crop.shape)} the exact slices of their examples inside "
        f"the bounds {exact}; the network's input from them {err:.3e} "
        "(bound 1e-6)")
    if not (exact and err <= 1e-6):
        raise AssertionError(f"{label}: the preprocessing pipeline")
    return err


def vision_bank_cases():
    """(op type, numpy inputs, attrs) of 22(C)'s bank: the 30 types
    run_bank holds (the random ones, unpool and grid_sampler have checks
    of their own), at the paths' shapes: the pose head's deconvolution
    and normalizations at batch 2 (the CPU's share of the bank), SegNet's
    pooling with indices on ResNet's 112x112 stem maps, ShuffleNet's
    channel shuffle, the 3-D family on C3D_CLIP."""
    rng = np.random.RandomState(SEED + 2220)

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def relu(*shape):
        return np.maximum(f(*shape), 0.0)

    clip = f(*C3D_CLIP)
    heat = [2, 256, 16, 16]
    rows = [
        ("conv2d_transpose", {"Input": [relu(2, 2048, 8, 8)],
                              "Filter": [f(2048, 256, 4, 4, scale=0.01)]},
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 1}),
        ("depthwise_conv2d_transpose", {"Input": [f(*heat)],
                                        "Filter": [f(256, 1, 4, 4)]},
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}),
        ("conv3d", {"Input": [clip], "Filter": [f(64, 3, 3, 3, 3, scale=0.1)]},
         {"strides": [1, 1, 1], "paddings": [1, 1, 1],
          "dilations": [1, 1, 1], "groups": 1}),
        ("conv3d_transpose", {"Input": [f(8, 64, 4, 14, 14)],
                              "Filter": [f(64, 32, 2, 2, 2, scale=0.1)]},
         {"strides": [2, 2, 2], "paddings": [0, 0, 0],
          "dilations": [1, 1, 1], "groups": 1}),
        ("pool3d", {"X": [clip]}, {"pooling_type": "max",
                                   "ksize": [2, 2, 2], "strides": [2, 2, 2],
                                   "paddings": [1, 1, 1], "ceil_mode": True}),
        ("max_pool3d_with_index", {"X": [np.maximum(clip, 0.0)]},
         {"ksize": [1, 2, 2], "strides": [1, 2, 2], "paddings": [0, 0, 0]}),
        ("group_norm", {"X": [f(*heat)], "Scale": [f(256)],
                        "Bias": [f(256)]}, {"groups": 32, "epsilon": 1e-5}),
        ("prelu", {"X": [f(*heat)], "Alpha": [f(1, 256, 1, 1)]},
         {"mode": "channel"}),
        ("maxout", {"X": [relu(*heat)]}, {"groups": 2}),
        ("huber_loss", {"X": [f(POSE_BATCH, 16 * 64 * 64)],
                        "Y": [f(POSE_BATCH, 16 * 64 * 64)]}, {"delta": 1.0}),
        ("hash", {"X": [rng.randint(0, 2 ** 31, (4096, 1)).astype(np.int64)]},
         {"num_hash": 2, "mod_by": 100003}),
        ("precision_recall",
         {"Indices": [rng.randint(0, 1000, (PRE_RESNET_BATCH, 1))
                      .astype(np.int32)],
          "Labels": [rng.randint(0, 1000, (PRE_RESNET_BATCH, 1))
                     .astype(np.int32)],
          "StatesInfo": [np.abs(f(1000, 4)) * 10]}, {"class_number": 1000}),
        ("lrn", {"X": [f(8, 96, 55, 55)]},
         {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}),
        ("crop", {"X": [f(8, 16, 64, 64)]},
         {"shape": [8, 16, 56, 56], "offsets": [0, 0, 4, 3]}),
        ("pad_constant_like", {"X": [f(8, 16, 64, 64)],
                               "Y": [f(8, 16, 56, 56)]}, {"pad_value": 0.5}),
        ("shuffle_channel", {"X": [f(8, 240, 28, 28)]}, {"group": 3}),
        ("space_to_depth", {"X": [f(8, 64, 56, 56)]}, {"blocksize": 2}),
        ("max_pool2d_with_index", {"X": [relu(8, 64, 112, 112)]},
         {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}),
        ("selu", {"X": [f(PRE_RESNET_BATCH, 4096)]}, {}),
        ("multiplex", {"X": [f(1024, 512), f(1024, 512), f(1024, 512)],
                       "Ids": [rng.randint(0, 3, (1024, 1))
                               .astype(np.int32)]}, {}),
        ("norm", {"X": [f(8, 512, 38, 38)]}, {"axis": 1, "epsilon": 1e-10}),
        ("data_norm", {"X": [f(2048, 512)],
                       "BatchSize": [np.abs(f(512)) * 1e4 + 1],
                       "BatchSum": [f(512) * 100],
                       "BatchSquareSum": [np.abs(f(512)) * 1e4 + 1]}, {}),
        ("bilinear_tensor_product", {"X": [f(1024, 128)], "Y": [f(1024, 128)],
                                     "Weight": [f(64, 128, 128, scale=0.1)],
                                     "Bias": [f(1, 64)]}, {}),
        ("mean_iou", {"Predictions": [rng.randint(0, 21, 8 * 512 * 512)
                                      .astype(np.int32)],
                      "Labels": [rng.randint(0, 21, 8 * 512 * 512)
                                 .astype(np.int32)]}, {"num_classes": 21}),
        ("conv_shift", {"X": [f(PRE_RESNET_BATCH, 1024)],
                        "Y": [f(PRE_RESNET_BATCH, 5)]}, {}),
        ("fill", {}, {"shape": [1000], "value": list(f(1000).astype(float)),
                      "dtype": pt.DataType.FP32}),
        ("reverse", {"X": [f(8, 16, 64, 64)]}, {"axis": [3]}),
        ("affine_grid", {"Theta": [f(32, 2, 3)]},
         {"output_shape": [32, 3, 224, 224]}),
        ("spp", {"X": [f(8, 256, 13, 13)]},
         {"pyramid_height": 3, "pooling_type": "max"}),
        ("similarity_focus", {"X": [f(8, 4, 32, 32)]},
         {"axis": 1, "indexes": [0, 3]}),
    ]
    return rows


def vision_scatter_adds(label, dev):
    """unpool over a max pooling's indices whose windows overlap (3x3
    stride 2 on ResNet's 112x112 stem maps: repeated indices) and
    grid_sampler's vjp (STN's 224x224 images sampled at a 224x224 grid:
    the X-gradient a scatter-add), each twice on the card under
    deterministic(): bitwise equal, no op warned, within VISION_BANK_REL
    (BANK_VJP_REL for the gradients) of the CPU. Returns {type: (error,
    vjp error)}."""
    cpu = torch.device("cpu")
    rng = np.random.RandomState(SEED + 2221)
    src = np.maximum(rng.randn(8, 64, 112, 112).astype(np.float32), 0)
    pooled = pt.registry.lookup("max_pool2d_with_index").emitter(
        pt.registry.EmitContext(cpu), {"X": [torch.from_numpy(src)]},
        {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]})
    cases = {
        "unpool": ({"X": [pooled["Out"][0].numpy()],
                    "Indices": [pooled["Mask"][0].numpy()]},
                   {"unpooled_height": 112, "unpooled_width": 112}),
        "grid_sampler": ({"X": [rng.randn(8, 3, 224, 224).astype(np.float32)],
                          "Grid": [rng.uniform(-1.05, 1.05, (8, 224, 224, 2))
                                   .astype(np.float32)]}, {}),
    }
    worst = {}
    for name, (ins, attrs) in cases.items():
        info = pt.registry.lookup(name)
        with deterministic() as warned:
            got = [_bank_flat(info.emitter(pt.registry.EmitContext(dev),
                                           {s: _bank_in(v, dev)
                                            for s, v in ins.items()}, attrs))
                   for _ in range(2)]
            fwd = info.emitter(pt.registry.EmitContext(cpu),
                               {s: _bank_in(v, cpu) for s, v in ins.items()},
                               attrs)
            vjps = [bank_vjp(label, name, ins, attrs, info, dev, fwd)
                    for _ in range(2)]
            torch.cuda.synchronize()
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(*got))
        err = max(bank_error(g, w) for (_, g), (_, w)
                  in zip(got[0], _bank_flat(fwd)))
        log(f"  {label}: {name} twice on the card under the deterministic "
            f"mode: bitwise equal {same}, warnings {warned or 'none'}; "
            f"{err:.3e} of the largest from the CPU (bound {VISION_BANK_REL});"
            f" vjp {vjps[0]:.3e}, {vjps[1]:.3e} (bound {BANK_VJP_REL})")
        if not (same and not warned and err <= VISION_BANK_REL
                and max(vjps) <= BANK_VJP_REL and vjps[0] == vjps[1]):
            raise AssertionError(f"{label}: {name}'s scatter-add")
        worst[name] = (err, max(vjps))
    return worst


def vision_rng_cases(label, dev):
    """The random types on the card: sampling_id's 2^16 draws from one
    probability row per class counts within VISION_RAND_SIGMAS deviations
    and none on a zero probability; uniform_random_batch_size_like's and
    gaussian_random_batch_size_like's 2^20 draws of Input's batch with
    their bounds, means and deviations within VISION_MOMENT_TOL of the
    scale; random_crop at 22(B)'s shape (crop_check). Returns {type:
    (0.0, None)}: each is held by its own bounds, logged here."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ctx = pt.registry.EmitContext(dev, generator=gen)
    worst = {}
    probs = np.array([0.05, 0.0, 0.3, 0.15, 0.2, 0.1, 0.05, 0.15], np.float32)
    n = 2 ** 16
    out = pt.registry.lookup("sampling_id").emitter(
        ctx, {"X": [torch.from_numpy(np.tile(probs, (n, 1))).to(dev)]},
        {})["Out"][0]
    counts = np.bincount(out.cpu().numpy(), minlength=len(probs))
    sd = np.sqrt(n * probs * (1 - probs))
    dev_sig = float(np.max(np.abs(counts - n * probs)[probs > 0]
                           / sd[probs > 0]))
    ok = (out.dtype == torch.int64 and counts[1] == 0
          and dev_sig <= VISION_RAND_SIGMAS)
    log(f"  {label}: sampling_id {n} draws on the card: counts {counts.tolist()}"
        f" (want {(n * probs).round().astype(int).tolist()}), at most "
        f"{dev_sig:.2f} deviations (bound {VISION_RAND_SIGMAS})")
    if not ok:
        raise AssertionError(f"{label}: sampling_id's draws")
    worst["sampling_id"] = (0.0, None)
    ref = torch.zeros((PRE_RESNET_BATCH, 2048), device=dev)
    for name, attrs, mean, sd, lo, hi in (
            ("uniform_random_batch_size_like",
             {"shape": [-1, 8192], "min": -2.0, "max": 4.0}, 1.0,
             6.0 / math.sqrt(12.0), -2.0, 4.0),
            ("gaussian_random_batch_size_like",
             {"shape": [-1, 8192], "mean": 1.5, "std": 2.0,
              "dtype": pt.DataType.FP32}, 1.5, 2.0, None, None)):
        draw = pt.registry.lookup(name).emitter(
            ctx, {"Input": [ref]}, attrs)["Out"][0].double()
        scale = (hi - lo) if lo is not None else sd
        err = max(abs(float(draw.mean()) - mean),
                  abs(float(draw.std()) - sd)) / scale
        inside = lo is None or bool((draw >= lo).all() and (draw < hi).all())
        log(f"  {label}: {name} {tuple(draw.shape)} on the card: mean "
            f"{float(draw.mean()):.5f} (want {mean}), deviation "
            f"{float(draw.std()):.5f} (want {sd:.5f}), {err:.3e} of the scale "
            f"(bound {VISION_MOMENT_TOL}); inside the bounds {inside}")
        if not (draw.shape == (PRE_RESNET_BATCH, 8192) and inside
                and err <= VISION_MOMENT_TOL):
            raise AssertionError(f"{label}: {name}")
        worst[name] = (0.0, None)
    crop_check(label, dev, (RESNET_IMAGE[1] * 9 // 8,
                            RESNET_IMAGE[2] * 9 // 8, 3),
               RESNET_IMAGE[1:] + (3,))
    worst["random_crop"] = (0.0, None)
    return worst


def vision_bank_path(smi):
    """22(C): the 36 types on the card against the port's own CPU run on
    the same seeded inputs (vision_bank_cases through run_bank: integer
    outputs equal, float outputs within VISION_BANK_REL of the largest
    magnitude, the gradful types' generic vjps within BANK_VJP_REL), the
    scatter-adds held under the deterministic mode (vision_scatter_adds)
    and the random types (vision_rng_cases)."""
    label = "22(C) image and NN op bank"
    dev = pt.Executor().device
    worst = run_bank(label, [(n, ins, attrs, VISION_BANK_REL)
                             for n, ins, attrs in vision_bank_cases()],
                     BANK_VJP_REL, dev)
    worst.update(vision_scatter_adds(label, dev))
    worst.update(vision_rng_cases(label, dev))
    log(f"  {label}: {len(worst)} types [{smi}]")
    if len(worst) != 36:
        raise AssertionError(f"{label}: {len(worst)} types, not 36")
    return {"types": len(worst),
            "max_rel": max(e for e, _ in worst.values()),
            "max_vjp_rel": max(v for _, v in worst.values() if v is not None)}


def vision_paths(smi):
    """Phase 22; returns the flash launches of its paths (the wrappers'
    calls over each path's runs, which must be (0, 0): no path holds an
    attention op) and each path's numbers."""
    out, numbers, secs = {}, {}, {}

    def run(name, fn):
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        r = fn()
        calls = (fa.launches, fa.bwd_launches)
        if calls != (0, 0):
            raise AssertionError(f"22 {name}: flash wrapper calls {calls}")
        out[name] = calls
        secs[name] = time.perf_counter() - t0
        return r

    numbers["pose"] = run("pose", lambda: pose_path(smi))
    release()
    numbers["resnet_preprocess"] = run(
        "resnet_preprocess", lambda: resnet_preprocess_path(smi))
    release()
    numbers["op_bank"] = run("vision_op_bank", lambda: vision_bank_path(smi))
    release()
    log("22: " + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    log("22: " + json.dumps(numbers, default=lambda v: str(v),
                            sort_keys=True)[:4000])
    return out, numbers


# ---------------------------------------------------------------------------
# phase 23: quantization, model compression, ModelAverage and the
# single-device rest of the registry
# ---------------------------------------------------------------------------

# 23(A): bench_resnet's ResNet-50 (phase 9's build: 224x224, 1000 classes,
# Momentum at lr 0.1, batch 128) in fp32, transpiled for quantization-aware
# training after minimize at 8 bits with moving-average activation scales
# (the JAX fake-quant ops have no AMP cast point, and Fluid 1.2 trained QAT
# in fp32), then its test clone frozen to int8 weights and served
QAT_ACT = "moving_average_abs_max"
QAT_QUANTIZED = 54     # 53 convolutions and the fc's mul
# the frozen model is held to the QAT model it came from: its int8 weights
# to the fake quant's (QAT_WEIGHT_FLIPS), the served outputs to the
# executor's run of the frozen program (QAT_SERVED_REL). Against the float
# test program it is measured, not gated: a few steps from random weights
# the quantized ResNet-50 is chaotic (a rounding flipped anywhere flips
# more downstream; 23 of 23.7 M weights a quantum apart moved a 64x64
# build's probabilities by 27% on the CPU, and even fit to a fifth of its
# first loss on its batch the frozen model stayed 0.13-0.33 from float),
# where tests/test_quantize.py's 0.1 holds for a trained two-layer net
QAT_WEIGHT_FLIPS = 1e-5  # int8 weights one quantum from the fake quant's
                         # (float64 against float32 at a rounding tie), of
                         # all weights
QAT_SERVED_REL = 1e-5  # served against the executor's frozen program
QAT_SERVE_RUNS = 4     # requests a predictor (warm-up, capture, replays)
# 23(B): the same ResNet-50, AMP, batch 128, pruned to half of every conv
# and fc weight by magnitude under CompressPass and retrained (the recipe
# of tests/test_slim.py with a fixed mask), 2 epochs of 3 batches, its
# strategy built from a dict through ConfigFactory (no yaml needed)
PRUNE_BATCHES = 3
PRUNE_EPOCHS = 2
PRUNE_SPARSITY = 0.5
PRUNE_SPARSITY_TOL = 0.01
PRUNE_CONFIG = {
    "version": 1.0,
    "pruners": {"pruner_1": {"class": "RatioPruner",
                             "ratios": {"*": PRUNE_SPARSITY}}},
    "strategies": {"prune_strategy": {
        "class": "PruneStrategy", "pruner": "pruner_1",
        "mini_batch_pruning_frequency": 1, "start_epoch": 0,
        "end_epoch": PRUNE_EPOCHS, "fixed_mask": True,
        "params": [r"conv2d_\d+\.w_0", r"fc_\d+\.w_0"]}},
    "compress_pass": {"class": "CompressPass", "epoch": PRUNE_EPOCHS,
                      "strategies": ["prune_strategy"]},
}
# 23(C): phase 19's CRNN-CTC with the ModelAverage of PaddleCV
# ocr_recognition's train.py (average_window 0.15, windows 10000-12500)
CRNN_MA_WINDOW = 0.15
CRNN_MA_RUNS = 6       # captured steps held against eager, EMAs included
# 23(D): the op bank at the paths' shapes: ResNet-50's layer-1 activation
# at batch 16 (the CPU's share), TBCNN's trees (Mou et al. 2016: 30-wide
# node vectors, 600 filters, depth 2), a DAM-like attention LSTM over
# [32, 50, 256]
QUANT_BANK_REL = 1e-5
TBCNN = dict(batch=8, nodes=96, feature=30, filters=600, depth=2)
DAM = dict(batch=32, steps=50, width=256, hidden=128)
READER_BATCH = 256     # the random_data_generator step's batch
READER_RUNS = 4        # steps of each arm (warm-up, capture, replays)


def fake_quant_ms(ops, block, scope, batch, dev):
    """The step's fake-quant ops alone, forward, on seeded inputs of their
    shapes (activations at ``batch``, the weights the scope's): ms a step
    by graph replay, and the bytes they move (each input read twice, for
    its largest magnitude and for its rounding, and written once)."""
    inputs, cache, nbytes = [], {}, 0
    for op in ops:
        name = op.input("X")[0]
        t = scope.find_var(name)
        if t is None:
            shape = tuple(batch if d < 0 else d for d in block.var(name).shape)
            t = cache.get(shape)
            if t is None:
                t = cache[shape] = torch.randn(shape, device=dev)
        ins = {"X": [t]}
        if op.input("InScale"):
            ins["InScale"] = [scope.find_var(op.input("InScale")[0]).clone()]
        inputs.append((pt.registry.lookup(op.type).emitter, ins, op.attrs))
        nbytes += 3 * t.numel() * t.element_size()
    ctx = pt.registry.EmitContext(dev)

    def run():
        for emit, ins, attrs in inputs:
            emit(ctx, ins, attrs)

    return time_ms(run, iters=5, warmup=1), nbytes


def qat_serve(label, exe, m, t, scope, feed, smi):
    """The trained scope's test clone (its batch_norm statistics
    calibrated on the batch) transpiled and frozen: every conv and fc
    weight int8 behind a dequantize_weights, each the fake quant's value
    but at rounding ties (QAT_WEIGHT_FLIPS); saved and served by
    AnalysisPredictor and NativePredictor on the card, each within
    QAT_SERVED_REL of the executor's run of the frozen program, its rows
    probabilities; the distance from the float test program's output
    and the arg-max agreement measured."""
    req = {"data": feed["data"]}
    calibrate_batch_norm(exe, m["test"], scope, feed)
    (ref,) = run_tensors(exe, m["test"], feed=req,
                         fetch_list=[m["predict"].name], scope=scope)
    frozen = m["test"].clone()
    with pt.scope_guard(scope):
        t.training_transpile(frozen, place=exe.place)
        t.freeze_program(frozen, scope=scope)
    ops = frozen.global_block().desc.ops
    deq = [o for o in ops if o.type == "dequantize_weights"]
    int8 = [o.input("X")[0] for o in deq]
    int8_mb = sum(scope.find_var(n).numel() for n in int8) / 1e6
    fp32_mb = 4 * sum(scope.find_var(n[:-len(".int8")]).numel()
                      for n in int8) / 1e6
    if not (len(deq) == QAT_QUANTIZED and all(
            scope.find_var(n).dtype == torch.int8 for n in int8)):
        raise AssertionError(f"{label}: {len(deq)} int8 weights")
    ctx = pt.registry.EmitContext(exe.device)
    flips, quantum = 0, 0.0
    for o in deq:
        w = scope.find_var(o.input("X")[0][:-len(".int8")])
        fq = pt.registry.lookup("fake_quantize_abs_max").emitter(
            ctx, {"X": [w]}, {"bit_length": t.weight_bits})["Out"][0]
        dq = pt.registry.lookup("dequantize_weights").emitter(
            ctx, {"X": [scope.find_var(o.input("X")[0])],
                  "Scale": [scope.find_var(o.input("Scale")[0])]},
            o.attrs)["Out"][0]
        flips += int(torch.count_nonzero(fq != dq))
        step = scope.find_var(o.input("Scale")[0]).item() / o.attrs[
            "max_range"]
        quantum = max(quantum, (fq - dq).abs().max().item() / step)
    (got,) = run_tensors(exe, frozen, feed=req,
                         fetch_list=[m["predict"].name], scope=scope)
    top = ref.abs().max().item()
    errs = {"executor": distance(got, ref) / top}
    d = tempfile.mkdtemp(prefix="chip_smoke_qat_", dir=_build.BUILD_DIR)
    try:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, ["data"], [m["predict"]], exe,
                                       main_program=frozen)
        saved_mb = _dir_bytes(d) / 1e6
        served_ms, served = {}, {}
        for name, cfg in (("AnalysisPredictor", AnalysisConfig(d)),
                          ("NativePredictor", NativeConfig(d))):
            pred = create_paddle_predictor(cfg)
            secs = []
            for _ in range(QAT_SERVE_RUNS):
                t0 = time.perf_counter()
                out = pred.run(req)[0].as_tensor()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            served_ms[name] = float(np.median(secs[2:])) * 1e3
            errs[name] = distance(out.float(), ref) / top
            served[name] = distance(out.float(), got) / got.abs().max().item()
            if name == "AnalysisPredictor":
                types = [o.type for o in pred._program.global_block().desc.ops]
            pred.close()
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
    total = sum(scope.find_var(n).numel() for n in int8)
    agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
    sums = (got.sum(1) - 1).abs().max().item()
    log(f"  {label}: frozen test program: {len(deq)} weights int8 behind "
        f"dequantize_weights, {int8_mb:.2f} MB against {fp32_mb:.2f} MB of "
        f"fp32 (the model directory {saved_mb:.2f} MB); {flips} of {total} "
        f"dequantized weights differ from the fake quant's, by at most "
        f"{quantum:.3f} quanta (bound {QAT_WEIGHT_FLIPS} of them, one "
        f"quantum); served against the executor's frozen program "
        + ", ".join(f"{n} {e:.3e}" for n, e in served.items())
        + f" (bound {QAT_SERVED_REL}); the AnalysisPredictor "
        f"keeps {types.count('batch_norm')} batch_norms (a dequantized "
        f"filter has no value to fold into) and fuses "
        f"{types.count('fc')} fc; served against the float test program "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" of the largest probability {top:.3e}, the arg-max the same on "
        f"{agree:.1%} of the rows (measured, not gated), rows summing to 1 "
        f"within {sums:.1e}; a request of "
        f"{len(feed['data'])} images " + ", ".join(
            f"{n} {v:.3f} ms" for n, v in served_ms.items()) + f" [{smi}]")
    if not (max(served.values()) <= QAT_SERVED_REL and sums <= 1e-5
            and flips <= QAT_WEIGHT_FLIPS * total and quantum <= 1.001
            and torch.isfinite(got).all()):
        raise AssertionError(f"{label}: served {served}, flips {flips} "
                             f"({quantum} quanta), row sums {sums}")
    return {"int8_mb": int8_mb, "fp32_mb": fp32_mb, "saved_mb": saved_mb,
            "served_ms": served_ms, "float_rel": errs, "served_rel": served,
            "weight_flips": flips, "argmax_agree": agree}


def qat_path(smi):
    """23(A): ResNet-50 at bench_resnet's widths, fp32, QuantizeTranspiler
    (8 bits, moving-average activation scales) after minimize: QAT_QUANTIZED
    quantized ops, REC_RUNS steps captured against eager bitwise (every
    persistable, the moving scales included) through CompiledProgram under
    bench.py's BuildStrategy (zoo_train), the fake-quant ops' share of a
    step by graph replay (fake_quant_ms); then the test clone frozen and
    served (qat_serve)."""
    label = "23(A) ResNet-50 QAT"
    from paddle_tpu_torch.contrib.quantize import QuantizeTranspiler
    m, state, exe = built_on_card(lambda: resnet.build(
        dataset="flowers", depth=50, class_dim=RESNET_CLASSES,
        image_shape=list(RESNET_IMAGE), lr=0.1))
    t = QuantizeTranspiler(activation_quantize_type=QAT_ACT)
    scales = pt.Scope()
    with pt.scope_guard(scales):
        # the moving scales start at 0 on the card, beside the state
        t.training_transpile(m["main"], place=exe.place)
    state.update({n: scales.find_var(n) for n in scales.var_names()})
    block = m["main"].global_block()
    ops = block.desc.ops
    quants = [o for o in ops if o.type.startswith("fake_quantize_")]
    quantized = [o for o in ops if o.type in ("conv2d", "depthwise_conv2d",
                                              "mul")
                 and o.input_arg_names()
                 and all(n.endswith(".quantized")
                         for n in o.input_arg_names())]
    scales = [n for n in state if n.endswith(".quant_scale")]
    log(f"  {label}: {len(quants)} fake-quant ops ({len(scales)} moving "
        f"scales) in front of {len(quantized)} quantized ops")
    if len(quantized) != QAT_QUANTIZED or not scales:
        raise AssertionError(f"{label}: {len(quantized)} quantized ops")
    feed = resnet_batch(RESNET_BATCH, SEED + 2300)
    target = pt.CompiledProgram(m["main"],
                                build_strategy=bench_build_strategy())
    scope, steps, res = zoo_train(label, exe, target, state,
                                  [m["loss"].name], [feed] * REC_RUNS,
                                  ("images", RESNET_BATCH), smi,
                                  runs=REC_RUNS)
    moved = sum(bool((scope.find_var(n) > 0).all()) for n in scales)
    if moved != len(scales):
        raise AssertionError(f"{label}: {len(scales) - moved} scales at 0")
    fq_ms, fq_bytes = fake_quant_ms(quants, block, scope, RESNET_BATCH,
                                    exe.device)
    res.update(quant_ops=len(quants), fake_quant_ms=fq_ms,
               fake_quant_gb=fq_bytes / 1e9,
               fake_quant_share=fq_ms / res["device_ms"])
    log(f"  {label}: the {len(quants)} fake-quant ops alone {fq_ms:.3f} ms "
        f"by graph replay ({fq_bytes / 1e9:.2f} GB read twice and written "
        f"once: {fq_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at the data-sheet "
        f"rate), {res['fake_quant_share']:.1%} of the step's "
        f"{res['device_ms']:.3f} ms of device time [{smi}]")
    res["serve"] = qat_serve(label, exe, m, t, scope, feed, smi)
    del scope, steps, target
    exe.close()
    return res


def prune_arm(label, exe, target, state, feeds, loss, jit):
    """The CompressPass loop over ``feeds`` (PRUNE_EPOCHS epochs) from a
    copy of ``state`` under the deterministic mode, captured (``jit``) or
    eager: (scope, strategy, context, losses, seconds)."""
    from paddle_tpu_torch.contrib import slim
    scope = copy_state(state, exe.device)
    losses = []
    comp = slim.core.build_compressor(
        data_reader=lambda: iter(feeds), scope=scope, metrics={"loss": loss},
        config=PRUNE_CONFIG, program_exe=exe)
    comp.on_metrics = lambda ctx, named: losses.append(
        torch.as_tensor(np.asarray(named["loss"])))
    with deterministic() as warned, jit_cache(jit):
        t0 = time.perf_counter()
        ctx = comp.apply(slim.ImitationGraph(target))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if warned:
        raise AssertionError(f"{label}: {warned}")
    return scope, comp.strategies[0], ctx, losses, secs


def prune_path(smi):
    """23(B): ResNet-50 AMP through CompiledProgram under bench.py's
    BuildStrategy, pruned and retrained by CompressPass with
    PRUNE_CONFIG's PruneStrategy (built by ConfigFactory from the dict):
    the loop captured (one capture of the train plan over the whole loop:
    the masks multiply the weights in place) against the same loop eager,
    every persistable bitwise; the sparsity of the pruned weights within
    PRUNE_SPARSITY_TOL of PRUNE_SPARSITY and the strategy's own count the
    scope's; then the pruned step's replays traced."""
    label = "23(B) ResNet-50 pruned"
    m, state, exe = built_on_card(lambda: resnet.build(
        dataset="flowers", depth=50, class_dim=RESNET_CLASSES,
        image_shape=list(RESNET_IMAGE), lr=0.1))
    target = pt.CompiledProgram(mixed_precision.decorate(m["main"].clone()),
                                build_strategy=bench_build_strategy())
    feeds = [resnet_batch(RESNET_BATCH, SEED + 2310 + i)
             for i in range(PRUNE_BATCHES)]
    arms = {}
    for arm in ("eager", "captured"):
        arms[arm] = prune_arm(label, exe, target, state, feeds, m["loss"],
                              arm == "captured")
    scope, strategy, ctx, losses, secs = arms["captured"]
    captures = ctx.exe.exe.capture_stats["captures"]
    hold(label, f"captured against eager, every persistable after "
         f"{PRUNE_EPOCHS} x {PRUNE_BATCHES} batches",
         scope_distance(scope, arms["eager"][0])[0], 0.0)
    hold(label, "losses captured against eager",
         max(distance(a, b) for a, b in zip(losses, arms["eager"][3])), 0.0)
    sparsity = strategy.sparsity(ctx)
    pruned = list(strategy._selected(ctx.graph))
    zero = sum(int(torch.count_nonzero(scope.find_var(p.name) == 0))
               for p in pruned)
    total = sum(scope.find_var(p.name).numel() for p in pruned)
    log(f"  {label}: {len(pruned)} conv and fc weights, {total} values: "
        f"sparsity {sparsity:.6f} (the scope's count {zero / total:.6f}; "
        f"want {PRUNE_SPARSITY} within {PRUNE_SPARSITY_TOL}); the train plan "
        f"captured {captures} time(s) over the loop; losses "
        + ", ".join(f"{float(v):.5f}" for v in losses)
        + f"; the loop {secs:.2f} s captured, {arms['eager'][4]:.2f} s eager")
    if not (abs(sparsity - PRUNE_SPARSITY) <= PRUNE_SPARSITY_TOL
            and sparsity == zero / total and len(pruned) == QAT_QUANTIZED
            and (captures == 1 or exe.device.type != "cuda")):
        raise AssertionError(f"{label}: sparsity {sparsity}, captures "
                             f"{captures}, {len(pruned)} weights")
    run_exe = ctx.exe.exe
    rows, busy = traced_window(label, lambda: run_tensors(
        run_exe, target, feed=feeds[0], fetch_list=[m["loss"].name],
        scope=scope))
    secs = []
    for _ in range(ZOO_TRACED):
        t0 = time.perf_counter()
        run_tensors(run_exe, target, feed=feeds[0],
                    fetch_list=[m["loss"].name], scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    step_ms = float(np.median(secs)) * 1e3
    log(f"  {label}: a pruned AMP step {step_ms:.3f} ms captured "
        f"({RESNET_BATCH / step_ms * 1e3:.1f} images/s), a traced replay "
        f"{busy:.3f} ms of device time over "
        f"{sum(r[2] for r in rows) / ZOO_TRACED:.0f} kernels: the card idle "
        f"{max(0.0, 1 - busy / step_ms):.1%} [{smi}]")
    res = {"sparsity": sparsity, "captures": captures, "step_ms": step_ms,
           "device_ms": busy, "idle": max(0.0, 1 - busy / step_ms),
           "kernels": sum(r[2] for r in rows) / ZOO_TRACED,
           "losses": [float(v) for v in losses]}
    del arms, scope, ctx
    exe.close()
    return res


def model_average_path(smi):
    """23(C): the CRNN-CTC with ModelAverage(CRNN_MA_WINDOW) built after
    minimize: CRNN_MA_RUNS steps captured against eager bitwise, the EMAs
    among the persistables (zoo_train); then twice, with a train step
    between: ``with model_average.apply(exe)``, every parameter bitwise its
    EMA and the test program's edit distances evaluated (warm-up and
    capture in the first cycle), and after it every parameter bitwise what
    it was; the second cycle captures nothing, in the train plan or the
    test plan."""
    label = "23(C) CRNN-CTC with ModelAverage"
    m, state, exe = built_on_card(lambda: tmodels.crnn_ctc(
        pt, average_window=CRNN_MA_WINDOW, **CRNN))
    cfg, ma = m["config"], m["model_average"]
    feed = tmodels.crnn_batch(CRNN_BATCH, cfg["image"], cfg["classes"],
                              cfg["max_label"], seed=SEED + 2320)
    target = pt.CompiledProgram(m["main"],
                                build_strategy=bench_build_strategy())
    scope, steps, res = zoo_train(label, exe, target, state,
                                  [m["loss"].name], [feed] * CRNN_MA_RUNS,
                                  ("images", CRNN_BATCH), smi,
                                  runs=CRNN_MA_RUNS)
    params = sorted(ma._ema)
    dists, caps = [], []
    for cycle in (1, 2):
        before = {n: scope.find_var(n).clone() for n in params}
        tensors = {n: scope.find_var(n) for n in params}
        with pt.scope_guard(scope), ma.apply(exe):
            swapped = all(scope.find_var(n) is tensors[n] and torch.equal(
                tensors[n], scope.find_var(ma._ema[n].name)) for n in params)
            outs = [run_tensors(exe, m["test"], feed=feed,
                                fetch_list=[m["distance"].name],
                                scope=scope)[0] for _ in range(2)]
        restored = max(distance(scope.find_var(n), before[n])
                       for n in params)
        if not (swapped and restored == 0.0 and all(
                scope.find_var(n) is tensors[n] for n in params)):
            raise AssertionError(f"{label}: cycle {cycle}: applied "
                                 f"{swapped}, restored {restored}")
        dists.append(float(outs[-1].float().mean()))
        caps.append(exe.capture_stats["captures"])
        if cycle == 1:
            run_tensors(exe, target, feed=feed, fetch_list=[m["loss"].name],
                        scope=scope)
    (plain,) = run_tensors(exe, m["test"], feed=feed,
                           fetch_list=[m["distance"].name], scope=scope)
    log(f"  {label}: {len(params)} parameters averaged; under apply the "
        f"mean edit distance {dists[0]:.4f} then {dists[1]:.4f} (the "
        f"parameters themselves {float(plain.float().mean()):.4f}); restored "
        f"bitwise and in place both times; captures after the cycles "
        f"{caps} (the second captures nothing) [{smi}]")
    if caps[1] != caps[0]:
        raise AssertionError(f"{label}: the second cycle captured "
                             f"{caps[1] - caps[0]} graph(s)")
    res.update(distances=dists, ema_params=len(params))
    del scope, steps, target
    exe.close()
    return res


def _tbcnn_batch(rng):
    """TBCNN's trees: each sample a random tree over 40-96 of the node
    slots (parent ids before children), its edges 1-indexed and ended by a
    (0, 0) row."""
    b, n = TBCNN["batch"], TBCNN["nodes"]
    edges = np.zeros((b, n, 2), np.int64)
    for s in range(b):
        count = rng.randint(40, n + 1)
        for c in range(2, count + 1):
            edges[s, c - 2] = (rng.randint(1, c), c)
    return edges


def quant_rest_bank_cases():
    """(op type, numpy inputs, attrs, bound) of 23(D)'s bank: the types
    run_bank holds (delete_var and py_func in a program, and the
    reader's layers, have checks of their own in quant_rest_bank_path)."""
    rng = np.random.RandomState(SEED + 2330)

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    act = f(16, 64, 56, 56)
    wq = f(2048, 512)
    q8 = rng.randint(-127, 128, (512, 512, 3, 3)).astype(np.int8)
    fc = f(2048, 1000)

    def acc(na, no, nu):
        return {"Param": [fc], "in_sum_1": [fc * 3], "in_sum_2": [fc * 5],
                "in_sum_3": [fc], "in_num_accumulates": [np.array([na])],
                "in_old_num_accumulates": [np.array([no])],
                "in_num_updates": [np.array([nu])]}

    window = {"average_window": 0.15, "max_average_window": 12500,
              "min_average_window": 10000}
    bits = {"bit_length": 8, "moving_rate": 0.9, "is_test": False}
    d, w, t, h = DAM["batch"], DAM["width"], DAM["steps"], DAM["hidden"]
    rows = [
        ("fake_quantize_abs_max", {"X": [act]}, {"bit_length": 8}),
        ("fake_quantize_range_abs_max",
         {"X": [act], "InScale": [np.array([3.5], np.float32)]}, bits),
        ("fake_quantize_moving_average_abs_max",
         {"X": [wq], "InScale": [np.array([0.0], np.float32)]}, bits),
        ("fake_dequantize_max_abs", {"X": [np.round(wq * 40)],
                                     "Scale": [np.array([0.37], np.float32)]},
         {"max_range": 127.0}),
        ("dequantize_weights", {"X": [q8], "Scale": [np.array(
            [0.61], np.float32)]}, {"max_range": 127.0}),
        ("assign_grad_through", {"Out@GRAD": [act]}, {}),
        ("quantize", {"Input": [act]}, {"Scale": 31.5}),
        ("dequantize", {"Input": [q8]}, {"Scale": 31.5}),
        ("average_accumulates", acc(40, 0, 16383), window),
        ("average_accumulates", acc(9999, 7, 60000), window),
        ("feed", {"X": [f(READER_BATCH, 784)]}, {"col": 0}),
        ("fetch", {"X": [f(READER_BATCH, 10)]}, {"col": 0}),
        ("get_places", {}, {}),
        ("tree_conv", {"NodesVector": [f(TBCNN["batch"], TBCNN["nodes"],
                                         TBCNN["feature"])],
                       "EdgeSet": [_tbcnn_batch(rng)],
                       "Filter": [f(TBCNN["feature"], 3, TBCNN["filters"],
                                    1)]}, {"max_depth": TBCNN["depth"]}),
        ("py_func", {"X": [f(64, 512), f(64, 512)]},
         {"func": lambda a, b: (a * b + 1.0, a.sum(axis=1))}),
        ("fused_embedding_seq_pool", {"W": [f(10000, 128)], "Ids": [
            rng.randint(0, 10000, (32, 50, 1))]}, {"padding_idx": 0}),
        ("fusion_seqexpand_concat_fc",
         {"X": [f(32, 50, 128), f(32, 64)], "FCWeight": [f(192, 256)],
          "FCBias": [f(256)]}, {"fc_activation": "tanh"}),
        ("attention_lstm",
         {"X": [f(d, t, w)], "C0": [f(d, h)], "H0": [f(d, h)],
          "AttentionWeight": [f(w + h, 1, scale=0.1)],
          "AttentionBias": [f(1, 1)], "LSTMWeight": [f(h + w, 4 * h,
                                                        scale=0.1)],
          "LSTMBias": [f(1, 4 * h)],
          "Length": [rng.randint(1, t + 1, d).astype(np.int32)]}, {}),
        ("merge_selected_rows", {"X": [fc]}, {}),
        ("get_tensor_from_selected_rows", {"X": [fc]}, {}),
        ("split_selected_rows", {"X": [fc]},
         {"height_sections": [1024, 512, 512]}),
        ("split_byref", {"X": [fc]}, {"height_sections": [1000, 1048]}),
        ("lookup_sparse_table", {"W": [f(100000, 64)], "Ids": [
            rng.randint(0, 100000, (4096, 1))]}, {}),
        ("ref_by_trainer_id", {"X": [fc, fc * 2, fc * 3],
                               "TrainerId": [np.array([1])]}, {}),
        ("rnn_memory_helper", {"X": [f(32, 512)]}, {}),
        ("rnn_memory_helper_grad", {"X": [f(32, 512)],
                                    "Out@GRAD": [f(32, 512)]}, {}),
    ]
    return [(n, ins, attrs, QUANT_BANK_REL) for n, ins, attrs in rows]


def ste_program(fl, width):
    """fc -> fake quant (each of the three types, appended through the
    Block API so the backward reaches it) -> ... -> fc -> squared error,
    SGD; returns (main, startup, loss, [(quant input, quant output)])."""
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = SEED
    pairs = []
    with fl.program_guard(main, startup):
        h = L.data("x", shape=[width], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        blk = main.global_block()
        for i, qtype in enumerate(("abs_max", "range_abs_max",
                                   "moving_average_abs_max")):
            h = L.fc(h, size=width, act="relu")
            q = blk.create_var(name=f"ste_q{i}", dtype="float32",
                               shape=h.shape)
            ins, outs = {"X": h}, {"Out": q}
            attrs = {"bit_length": 8}
            if qtype != "abs_max":
                s = blk.create_var(name=f"ste_s{i}", dtype="float32",
                                   shape=[1], persistable=True)
                ins["InScale"] = s
                attrs.update(moving_rate=0.9, is_test=False)
            else:
                s = blk.create_var(name=f"ste_s{i}", dtype="float32",
                                   shape=[1])
            outs["OutScale"] = s
            blk.append_op(type=f"fake_quantize_{qtype}", inputs=ins,
                          outputs=outs, attrs=attrs)
            pairs.append((h.name, q.name))
            h = q
        loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
        fl.optimizer.SGD(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, pairs


def ste_check(label, dev):
    """The three fake-quant types' straight-through gradients on the card,
    in a captured program: each quant op's input gradient bitwise its
    output gradient (assign_grad_through) over READER_RUNS steps, the
    first fc's weights moved by them, the losses finite. A CPU run of the
    same steps is measured beside it, not held: the quantizer is
    discontinuous, so a GEMM's last-bit difference that flips a rounding
    moves the loss by a quantum's share (the ops themselves are held on
    identical inputs in the bank)."""
    with unique_name.guard():
        main, startup, loss, pairs = ste_program(pt, 1024)
    types = [o.type for o in main.global_block().desc.ops]
    if types.count("assign_grad_through") != 3:
        raise AssertionError(f"{label}: {types.count('assign_grad_through')}"
                             " straight-through grad ops")
    rng = np.random.RandomState(SEED + 2331)
    feed = {"x": rng.randn(READER_BATCH, 1024).astype(np.float32),
            "y": rng.randn(READER_BATCH, 1).astype(np.float32)}
    fetch = [loss.name] + [n + "@GRAD" for pair in pairs for n in pair]
    losses, worst, state, moved = {}, 0.0, None, None
    for where in ("card", "cpu"):
        exe = pt.Executor(pt.CPUPlace()) if where == "cpu" else pt.Executor()
        if state is None:
            init = pt.Scope()
            exe.run(startup, scope=init)
            for i in (1, 2):
                init.set_var(f"ste_s{i}", torch.zeros(1, device=exe.device))
            state = {n: init.find_var(n) for n in init.var_names()}
        scope = copy_state(state, exe.device)
        losses[where] = []
        caps = exe.capture_stats["captures"]
        for _ in range(READER_RUNS):
            outs = run_tensors(exe, main, feed=feed, fetch_list=fetch,
                               scope=scope)
            losses[where].append(float(outs[0].reshape(-1)[0]))
            for k in range(len(pairs)):
                worst = max(worst, distance(outs[1 + 2 * k],
                                            outs[2 + 2 * k]))
        if where == "card":
            if (dev.type == "cuda"
                    and exe.capture_stats["captures"] - caps != 1):
                raise AssertionError(
                    f"{label}: the STE program captured "
                    f"{exe.capture_stats['captures'] - caps}")
            moved = distance(scope.find_var("fc_0.w_0"), state["fc_0.w_0"])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                               losses["cpu"])]
    log(f"  {label}: the three fake-quant types' straight-through grads in "
        f"a captured program ({READER_BATCH} x 1024): input gradient against "
        f"output gradient {worst:.3e} (bitwise), the first fc's weights "
        f"moved {moved:.3e}; losses " + ", ".join(
            f"{v:.6f}" for v in losses["card"]) + ", against a CPU run's "
        + ", ".join(f"{v:.2e}" for v in rel) + " (measured)")
    if not (worst == 0.0 and moved > 0
            and np.isfinite(losses["card"]).all()):
        raise AssertionError(f"{label}: STE {worst}, moved {moved}")


def py_func_check(label, dev):
    """py_func in a program on the card: the block splits into device,
    host, device segments, the device segments captured (READER_RUNS runs),
    the fetch within QUANT_BANK_REL of the CPU's run."""
    def build():
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = SEED
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", shape=[512], dtype="float32")
            h = pt.layers.fc(x, size=512, act="tanh")
            o = main.global_block().create_var(name="pf_o", dtype="float32",
                                               shape=[-1, 512])
            pt.layers.py_func(lambda a: np.tanh(a) * 2.0, h, o)
            out = pt.layers.reduce_sum(pt.layers.fc(o, size=8))
        return main, startup, out
    with unique_name.guard():
        main, startup, out = build()
    feed = {"x": np.random.RandomState(SEED + 2332).randn(64, 512).astype(
        np.float32)}
    got = {}
    for where in ("card", "cpu"):
        exe = pt.Executor(pt.CPUPlace()) if where == "cpu" else pt.Executor()
        if where == "card":
            scope = pt.Scope()
            exe.run(startup, scope=scope)
        else:
            scope = copy_state(got["state"], exe.device)
        caps = exe.capture_stats["captures"]
        got[where] = [run_tensors(exe, main, feed=feed, fetch_list=[out.name],
                                  scope=scope)[0] for _ in range(READER_RUNS)]
        if where == "card":
            got["state"] = {n: scope.find_var(n) for n in scope.var_names()}
            got["caps"] = exe.capture_stats["captures"] - caps
            plan = next(iter(main._exec_cache.values()))
            got["segments"] = [k for k, _ in plan.segments]
    top = got["cpu"][0].abs().item()
    err = max(abs(float(a) - float(got["cpu"][0])) for a in got["card"]) / top
    log(f"  {label}: py_func in a program: segments {got['segments']}, "
        f"{got['caps']} graphs captured over {READER_RUNS} runs, the fetch "
        f"against the CPU's {err:.3e} (bound {QUANT_BANK_REL})")
    if not (got["segments"] == ["device", "host", "device"]
            and (got["caps"] == 2 or dev.type != "cuda")
            and err <= QUANT_BANK_REL):
        raise AssertionError(f"{label}: py_func program {got['segments']} "
                             f"{got['caps']} {err}")


def delete_var_check(label, dev):
    """delete_var of a persistable a captured graph reads: the graph's
    program raises on its next run instead of replaying on a freed
    tensor."""
    main, startup = pt.Program(), pt.Program()
    with unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[256], dtype="float32")
        w = pt.layers.create_parameter([256, 256], "float32", name="dv_w")
        out = pt.layers.mul(x, w)
    drop = pt.Program()
    drop.global_block().append_op(type="delete_var", inputs={}, outputs={},
                                  attrs={"var_names": ["dv_w"]})
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((32, 256), np.float32)}
    for _ in range(3):
        run_tensors(exe, main, feed=feed, fetch_list=[out.name], scope=scope)
    caps = exe.capture_stats["captures"]
    exe.run(drop, scope=scope)
    try:
        run_tensors(exe, main, feed=feed, fetch_list=[out.name], scope=scope)
        raised = False
    except KeyError:
        raised = True
    log(f"  {label}: delete_var of a persistable a captured graph reads "
        f"({caps} captured): erased {scope.find_var('dv_w') is None}, the "
        f"next run raised {raised}")
    if not ((caps == 1 or dev.type != "cuda") and raised
            and scope.find_var("dv_w") is None):
        raise AssertionError(f"{label}: delete_var")


def reader_check(label, dev):
    """random_data_generator through a Preprocessor (on the reader's
    device) feeding a captured SGD step, READER_RUNS steps captured against
    eager from the same state, losses bitwise; the read batch equal to
    numpy's RandomState(0) draw, preprocessed, within 1e-6."""
    def build():
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = SEED
        with pt.program_guard(main, startup):
            reader = pt.layers.random_data_generator(
                low=0.0, high=255.0, shapes=[[READER_BATCH, 784],
                                             [READER_BATCH, 1]])
            pre = pt.layers.Preprocessor(reader)
            with pre.block():
                img, lbl = pre.inputs()
                pre.outputs(pt.layers.scale(img, scale=1.0 / 255.0), lbl)
            x, y = pt.layers.read_file(reader)
            loss = pt.layers.mean(pt.layers.square_error_cost(
                pt.layers.fc(pt.layers.fc(x, size=256, act="relu"), size=1),
                y))
            pt.optimizer.SGD(learning_rate=1e-3).minimize(loss)
        return main, startup, reader, x, loss
    with unique_name.guard():
        main, startup, reader, x, loss = build()
    exe, init = pt.Executor(), pt.Scope()
    exe.run(startup, scope=init)
    state = {n: init.find_var(n) for n in init.var_names()
             if isinstance(init.find_var(n), torch.Tensor)}
    runs, first = {}, None
    with deterministic() as warned:
        for arm in ("eager", "captured"):
            scope = copy_state(state, exe.device)
            for n in init.var_names():
                if n not in state:
                    scope.set_var(n, init.find_var(n))
            caps = exe.capture_stats["captures"]
            reader.start()
            try:
                with jit_cache(arm == "captured"):
                    outs = [run_tensors(exe, main, fetch_list=[x.name,
                                                               loss.name],
                                        scope=scope)
                            for _ in range(READER_RUNS)]
            finally:
                reader.reset()
            runs[arm] = (outs, exe.capture_stats["captures"] - caps)
            first = outs[0][0] if first is None else first
    raw = np.random.RandomState(0).uniform(0.0, 255.0, [READER_BATCH, 784])
    err = float(np.abs(first.cpu().numpy()
                       - raw.astype(np.float32) * np.float32(1 / 255.0)).max())
    diff = max(distance(a[1], b[1]) for a, b in zip(runs["eager"][0],
                                                    runs["captured"][0]))
    log(f"  {label}: random_data_generator through a Preprocessor on the "
        f"card feeding an SGD step: {READER_RUNS} captured steps against "
        f"eager {diff:.3e} (bitwise), {runs['captured'][1]} graph(s) "
        f"captured; the first batch against numpy's {err:.3e} (bound 1e-6)")
    if (warned or diff != 0.0 or err > 1e-6
            or (dev.type == "cuda" and runs["captured"][1] < 1)):
        raise AssertionError(f"{label}: reader {warned} {diff} {err}")


def quant_rest_bank_path(smi):
    """23(D): the 26 types on the card against the CPU on the same seeded
    inputs (quant_rest_bank_cases through run_bank: integer outputs equal,
    float outputs within QUANT_BANK_REL of the largest magnitude, the
    gradful types' generic vjps within BANK_VJP_REL; average_accumulates
    just before its 16384 drain and just before a window roll); the
    fake-quant types' straight-through grads (ste_check), py_func
    (py_func_check) and delete_var (delete_var_check) in captured
    programs, and random_data_generator with a Preprocessor feeding a
    captured step (reader_check)."""
    label = "23(D) quantization and rest-of-registry op bank"
    dev = pt.Executor().device
    worst = run_bank(label, quant_rest_bank_cases(), BANK_VJP_REL, dev)
    ste_check(label, dev)
    py_func_check(label, dev)
    delete_var_check(label, dev)
    worst["delete_var"] = (0.0, None)
    reader_check(label, dev)
    log(f"  {label}: {len(worst)} types [{smi}]")
    if len(worst) != 26:
        raise AssertionError(f"{label}: {len(worst)} types, not 26")
    return {"types": len(worst),
            "max_rel": max(e for e, _ in worst.values()),
            "max_vjp_rel": max(v for _, v in worst.values() if v is not None)}


def quant_rest_paths(smi):
    """Phase 23; returns the flash launches of its paths (the wrappers'
    calls over each path's runs, which must be (0, 0): no path holds an
    attention op) and each path's numbers."""
    out, numbers, secs = {}, {}, {}

    def run(name, fn):
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        r = fn()
        calls = (fa.launches, fa.bwd_launches)
        if calls != (0, 0):
            raise AssertionError(f"23 {name}: flash wrapper calls {calls}")
        out[name] = calls
        secs[name] = time.perf_counter() - t0
        return r

    numbers["qat"] = run("resnet_qat", lambda: qat_path(smi))
    release()
    numbers["prune"] = run("resnet_prune", lambda: prune_path(smi))
    release()
    numbers["model_average"] = run("crnn_model_average",
                                   lambda: model_average_path(smi))
    release()
    numbers["op_bank"] = run("quant_rest_op_bank",
                             lambda: quant_rest_bank_path(smi))
    release()
    log("23: " + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    log("23: " + json.dumps(numbers, default=lambda v: str(v),
                            sort_keys=True)[:4000])
    return out, numbers


# --- phase 24: imperative (dygraph) mode, the dataset zoo, the verifier ---

DY_RESNET_BATCH = 32
DY_RESNET_STEPS = 5
DY_RESNET_LR = 0.01
DY_RESNET_REL = 1e-4     # PR 8's per-op bound, fp32: of the largest magnitude
DY_ENC = dict(vocab=32000, n_layer=6, n_head=8, d_model=512, d_ff=2048,
              seq=256, dropout=0.1)
DY_ENC_BATCH = 16
DY_ENC_STEPS = 5
DY_ENC_LR = 1e-4
DY_ENC_TIMED = 3         # 24(B): untraced steps timed after the gated ones
VERIFY_RUNS = 3          # 24(C): eager, the capture, a replay


def dygraph_resnet(I, stages=(3, 4, 6, 3), class_dim=102, base=64):
    """ResNet in the shape of Fluid's dygraph ResNet example, on an
    imperative module ``I``: ``ConvBNLayer`` stem, 3x3/2 max pool,
    ``BottleneckBlock`` stages in the order and with the strides of
    ``models/resnet.py`` (the stride on the first 1x1, a projection
    shortcut where the channels change), global average pool and an
    ``FC`` softmax. ``convbn`` lists the ConvBNLayers in the order
    their declarative twins' conv2d ops run; ``loss(image, label)`` is
    the mean cross entropy."""

    class ConvBNLayer(I.Layer):
        """A ``Conv2D`` (its bias held at 0 where a declarative build's
        weights are mapped in) and a ``BatchNorm`` with the activation."""

        def __init__(self, num_filters, filter_size, stride=1, act="relu"):
            super().__init__("ConvBNLayer")
            self.conv = I.Conv2D(num_filters, filter_size, stride,
                                 (filter_size - 1) // 2)
            self.bn = I.BatchNorm(num_filters, act=act)

        def forward(self, x):
            return self.bn(self.conv(x))

    class ResNet(I.Layer):
        def __init__(self):
            super().__init__("ResNet")
            self.convbn = []
            self._cb(base, 7, 2)   # the stem, convbn[0]
            self.pool = I.Pool2D(3, "max", 2, 1)
            self.blocks = []
            ch_in = base
            for i, count in enumerate(stages):
                ch = base * 2 ** i
                for j in range(count):
                    stride = 2 if i and not j else 1
                    short = (self._cb(ch * 4, 1, stride, None)
                             if ch_in != ch * 4 else None)
                    convs = [self._cb(ch, 1, stride), self._cb(ch, 3),
                             self._cb(ch * 4, 1, 1, None)]
                    self.blocks.append((short, convs))
                    ch_in = ch * 4
            self.gap = I.Pool2D(7, "avg", global_pooling=True)
            self.fc = I.FC(class_dim, act="softmax")

        def _cb(self, nf, fs, stride=1, act="relu"):
            layer = ConvBNLayer(nf, fs, stride, act)
            setattr(self, f"convbn{len(self.convbn)}", layer)
            self.convbn.append(layer)
            return layer

        def forward(self, x):
            x = self.pool(self.convbn[0](x))
            for short, convs in self.blocks:
                s = short(x) if short is not None else x
                y = x
                for c in convs:
                    y = c(y)
                x = I.trace_op("elementwise_add", {"X": [s], "Y": [y]},
                               {"axis": -1})["Out"][0]
                x = I.trace_op("relu", {"X": [x]}, {})["Out"][0]
            return self.fc(self.gap(x))

        def loss(self, image, label):
            prob = self(image)
            ce = I.trace_op("cross_entropy", {"X": [prob], "Label": [label]},
                            {})["Y"][0]
            return I.trace_op("mean", {"X": [ce]}, {})["Out"][0]

    return ResNet()


def dygraph_resnet_weights(model, program, scope_values):
    """Copy a declarative ``models/resnet.py`` build's parameters and
    batch-norm statistics (``scope_values``: name -> numpy or tensor)
    into ``model`` after its parameters exist: the i-th ConvBNLayer takes
    the i-th conv2d op's filter and the batch_norm op after it, the FC
    the mul and its bias; every Conv2D bias is set to 0."""
    ops = program.global_block().ops
    convs = [o for o in ops if o.type == "conv2d"]
    bns = [o for o in ops if o.type == "batch_norm"]
    if len(convs) != len(model.convbn) or len(bns) != len(model.convbn):
        raise AssertionError(f"{len(model.convbn)} ConvBNLayers against "
                             f"{len(convs)} conv2d / {len(bns)} batch_norm")
    names = {}
    for layer, conv, bn in zip(model.convbn, convs, bns):
        names[id(layer.conv._w)] = conv.input("Filter")[0]
        for attr, slot in (("_scale", "Scale"), ("_bias", "Bias"),
                           ("_mean", "Mean"), ("_var", "Variance")):
            names[id(getattr(layer.bn, attr))] = bn.input(slot)[0]
        layer.conv._b.array = np.zeros(layer.conv._b.shape, np.float32)
    mul = next(o for o in ops if o.type == "mul")
    add = next(o for o in ops[ops.index(mul):]
               if o.type == "elementwise_add")
    names[id(model.fc._w)] = mul.input("Y")[0]
    names[id(model.fc._b)] = add.input("Y")[0]
    vars_ = [v for layer in model.convbn
             for v in (layer.conv._w, layer.bn._scale, layer.bn._bias,
                       layer.bn._mean, layer.bn._var)] + [model.fc._w,
                                                           model.fc._b]
    for v in vars_:
        v.array = scope_values[names[id(v)]]
    return {names[id(v)]: v for v in vars_}


def dygraph_encoder(I, vocab, n_layer, n_head, d_model, d_ff, seq,
                    dropout=0.0, use_recompute=False):
    """A Transformer encoder on an imperative module ``I``: word and
    position ``Embedding``s, ``n_layer`` post-norm layers (``FC`` q, k,
    v and output projections, heads split by ``reshape2`` and
    ``transpose2``, the ``flash_attention`` op, ``layer_norm``,
    upscale_in_train ``dropout`` drawn from the tracer's generator, a
    ReLU feed-forward) and an ``FC`` over the vocabulary into
    ``softmax_with_cross_entropy``. ``use_recompute`` puts each layer
    under ``recompute``. The parameters are made (drawn from numpy's
    global ``np.random`` in a fixed order) before the model is returned."""
    dh = d_model // n_head

    def op(type_, ins, attrs=None, slot="Out"):
        return I.trace_op(type_, ins, attrs or {})[slot][0]

    class EncoderLayer(I.Layer):
        def __init__(self, i):
            super().__init__(f"enc{i}")
            for n in ("q", "k", "v", "o"):
                setattr(self, n, I.FC(d_model, num_flatten_dims=2))
            self.ff1 = I.FC(d_ff, num_flatten_dims=2, act="relu")
            self.ff2 = I.FC(d_model, num_flatten_dims=2)
            for j in (1, 2):
                self.create_parameter(f"ln{j}_scale", [d_model],
                                      initializer=lambda s: np.ones(
                                          s, np.float32))
                self.create_parameter(f"ln{j}_bias", [d_model],
                                      is_bias=True)

        def _heads(self, x, b):
            x = op("reshape2", {"X": [x]}, {"shape": [b, seq, n_head, dh]})
            return op("transpose2", {"X": [x]}, {"axis": [0, 2, 1, 3]})

        def _drop(self, x):
            if not dropout:
                return x
            return op("dropout", {"X": [x]},
                      {"dropout_prob": dropout,
                       "dropout_implementation": "upscale_in_train"})

        def _norm(self, x, j):
            return op("layer_norm",
                      {"X": [x], "Scale": [self._parameters[f"ln{j}_scale"]],
                       "Bias": [self._parameters[f"ln{j}_bias"]]},
                      {"begin_norm_axis": 2, "epsilon": 1e-5}, "Y")

        def forward(self, x):
            b = x.shape[0]
            q, k, v = (self._heads(getattr(self, n)(x), b)
                       for n in ("q", "k", "v"))
            a = op("flash_attention", {"Q": [q], "K": [k], "V": [v]},
                   {"causal": False, "scale": dh ** -0.5})
            a = op("transpose2", {"X": [a]}, {"axis": [0, 2, 1, 3]})
            a = op("reshape2", {"X": [a]}, {"shape": [b, seq, d_model]})
            x = self._norm(x + self._drop(self.o(a)), 1)
            f = self._drop(self.ff2(self.ff1(x)))
            return self._norm(x + f, 2)

    class Encoder(I.Layer):
        def __init__(self):
            super().__init__("Encoder")
            self.word = I.Embedding([vocab, d_model])
            self.pos = I.Embedding([seq, d_model])
            self.layers = []
            for i in range(n_layer):
                layer = EncoderLayer(i)
                setattr(self, f"layer{i}", layer)
                self.layers.append(layer)
            self.out = I.FC(vocab, num_flatten_dims=2)

        def loss(self, ids, pos, label):
            x = self.word(ids) + self.pos(pos)
            for layer in self.layers:
                x = I.recompute(layer, x) if use_recompute else layer(x)
            ce = op("softmax_with_cross_entropy",
                    {"Logits": [self.out(x)], "Label": [label]}, {}, "Loss")
            return op("mean", {"X": [ce]})

    model = Encoder()
    # make every FC's parameters with one row in eval mode (no dropout
    # draw), so that recompute finds them when the first step runs
    zeros = np.zeros((1, seq, 1), np.int64)
    model.eval()
    model.loss(*(I.to_variable(zeros) for _ in range(3)))
    model.train()
    return model


def encoder_batch(vocab, seq, batch, seed):
    """Token ids, positions and next-token labels, [batch, seq, 1] int64."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq, 1)).astype(np.int64)
    pos = np.tile(np.arange(seq, dtype=np.int64).reshape(1, seq, 1),
                  (batch, 1, 1))
    return ids, pos, np.roll(ids, -1, axis=1)


def flowers_batches(batch, steps):
    """``steps`` batches of ``dataset.flowers.train()`` through the
    port's batch reader: images [batch, 3, 224, 224], int64 labels."""
    out = []
    for rows in pt.reader.batch(flowers.train(), batch)():
        out.append((np.stack([r[0] for r in rows]).reshape(
            batch, *RESNET_IMAGE), np.array([[r[1]] for r in rows],
                                            np.int64)))
        if len(out) == steps:
            return out
    raise AssertionError(f"flowers.train() gave {len(out)} batches")


def rel_err(got, want):
    """max |got - want| over the largest |want| (host arrays)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def dygraph_resnet_path(smi):
    """24(A): dygraph ResNet-50 at 102 classes, fed from
    dataset.flowers, trained DY_RESNET_STEPS steps with the imperative
    SGD; step 1's loss and every weight's gradient against the port's
    eager Executor on the declarative models/resnet.py program whose
    weights it took."""
    I = pt.imperative
    label = "24(A) dygraph ResNet-50"
    batches = flowers_batches(DY_RESNET_BATCH, DY_RESNET_STEPS)
    with unique_name.guard():
        r = resnet.build(dataset="flowers", depth=50,
                         class_dim=flowers.CLASS_COUNT,
                         image_shape=list(RESNET_IMAGE), lr=DY_RESNET_LR)
    r["startup"].random_seed = SEED
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(r["startup"], scope=scope)
    init = {n: scope.find_var(n).clone() for n in scope.var_names()}
    names = [p.name for p in r["main"].global_block().all_parameters()]
    image, lbl = batches[0]
    with jit_cache(False):
        want = exe.run(r["main"], feed={"data": image, "label": lbl},
                       fetch_list=[r["loss"]] + [n + "@GRAD" for n in names],
                       scope=scope)
    del scope, exe
    release()

    np.random.seed(SEED)
    with I.guard(seed=SEED):
        tracer = I.tracer._active_tracer()
        model = dygraph_resnet(I, class_dim=flowers.CLASS_COUNT)
        model.eval()
        model(I.to_variable(image[:1]))  # makes the Conv2D parameters
        model.train()
        mapped = dygraph_resnet_weights(model, r["main"], init)
        del init
        params = model.parameters()
        sgd = I.SGDOptimizer(DY_RESNET_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, recorded = [], [], []
        for i, (image, lbl) in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = model.loss(I.to_variable(image), I.to_variable(lbl))
            recorded.append(len(tracer._tape))
            loss.backward()
            if i == 0:
                errs = {n: rel_err(mapped[n].gradient(), g)
                        for n, g in zip(names, want[1:])}
            sgd.minimize(loss, params)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss.numpy().reshape(())))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = float(np.median(secs[1:])) * 1e3
        _, busy = device_rows(lambda: sgd.minimize(
            model.loss(I.to_variable(image), I.to_variable(lbl)), params))
    loss_err = rel_err(losses[0], np.asarray(want[0]).reshape(()))
    worst = max(errs, key=errs.get)
    log(f"  {label}: {len(names)} weights mapped from the declarative "
        f"build; step 1 against the eager Executor: loss {losses[0]:.6f} "
        f"(rel. error {loss_err:.2e}), gradients' largest rel. error "
        f"{errs[worst]:.2e} ({worst}) (bound {DY_RESNET_REL:.0e} of each "
        f"gradient's largest magnitude)")
    if not (loss_err <= DY_RESNET_REL and errs[worst] <= DY_RESNET_REL):
        raise AssertionError(f"{label}: step 1 beyond {DY_RESNET_REL} of the "
                             "executor's")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    idle = max(0.0, 1 - busy / step_ms)
    log(f"  {label}: batch {DY_RESNET_BATCH}, losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; steady step {step_ms:.1f} ms ({secs[0] * 1e3:.1f} ms the "
        f"first), a traced step {busy:.1f} ms of device time (the card idle "
        f"{idle:.1%} of a steady step); peak {peak:.2f} GiB; "
        f"{recorded[0]} ops recorded a step [{smi}]")
    return {"step_ms": step_ms, "device_ms": busy, "idle": idle,
            "peak_gib": peak, "ops_per_step": recorded[0],
            "grad_rel_err": errs[worst], "loss_rel_err": loss_err}


def dygraph_encoder_arm(I, batches, use_recompute, label, per_step):
    """One 24(B) arm: DY_ENC_STEPS Adam steps from the same weights and
    generator seed, their flash kernels counted by name in a trace
    against ``per_step`` (forward, backward) a step; DY_ENC_TIMED steps
    timed; one more step traced on the device and one on the host.
    Returns (each step's gradients on the host, losses, the median timed
    step ms, peak GiB, the traced launches, the traced step's device rows
    and ms, its host rows)."""
    np.random.seed(SEED)
    with I.guard(seed=SEED):
        model = dygraph_encoder(I, use_recompute=use_recompute, **DY_ENC)
        params = list({id(p): p for p in model.parameters()}.values())
        adam = I.AdamOptimizer(DY_ENC_LR)

        def step(ids, pos, lbl):
            loss = model.loss(I.to_variable(ids), I.to_variable(pos),
                              I.to_variable(lbl))
            loss.backward()
            return loss

        release()
        torch.cuda.reset_peak_memory_stats()
        grads, losses = [], []
        with traced_launches() as counted:
            for batch in batches:
                loss = step(*batch)
                grads.append([p._grad.cpu() for p in params])
                adam.minimize(loss, params)
                losses.append(float(loss.numpy().reshape(())))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        traced = check_launches(label, counted,
                                tuple(n * len(batches) for n in per_step))
        steady = []
        for batch in batches[:DY_ENC_TIMED]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            adam.minimize(step(*batch), params)
            torch.cuda.synchronize()
            steady.append(time.perf_counter() - t0)
        rows, busy = device_rows(lambda: adam.minimize(step(*batches[0]),
                                                       params))
        host = host_rows(lambda: adam.minimize(step(*batches[0]), params))
    return (grads, losses, float(np.median(steady)) * 1e3, peak, traced,
            rows, busy, host)


def host_rows(fn, n=6):
    """The host's side of one call of fn under torch.profiler (CPU
    activity): the top ``n`` operators by self CPU ms, and the number of
    operator calls."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    top = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:n]
    return {"calls": sum(e.count for e in avg if e.key.startswith("aten::")),
            "top": [(e.key, e.self_cpu_time_total / 1e3, e.count)
                    for e in top]}


def tape_attention_check(I, label, device="cuda"):
    """One attention at the train step's shape through the tape
    (``trace_op`` of flash_attention, a weighted sum backward): its
    output and Q, K, V gradients against plain_attention and
    plain_attention_bwd on the same values, within TOL and BWD_TOL."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v, do = (torch.randn(TRAIN_SHAPE, generator=gen, device=device)
                   for _ in range(4))
    scale = TRAIN_SHAPE[3] ** -0.5
    with I.guard(seed=SEED):
        qv, kv, vv = (I.to_variable(t) for t in (q, k, v))
        out = I.trace_op("flash_attention", {"Q": [qv], "K": [kv], "V": [vv]},
                         {"causal": False, "scale": scale})["Out"][0]
        dov = I.to_variable(do)
        dov.stop_gradient = True
        s = I.trace_op("reduce_sum", {"X": [out * dov]},
                       {"reduce_all": True})["Out"][0]
        s.backward()
        got = [out.array.detach()] + [x._grad for x in (qv, kv, vv)]
    ref_out, lse = fa.plain_attention(q, k, v, None, False, scale)
    ref = [ref_out] + list(fa.plain_attention_bwd(
        q, k, v, None, ref_out, lse, do, False, scale)[:3])
    errs = {}
    for name, g, w in zip(("out", "dQ", "dK", "dV"), got, ref):
        top = w.abs().max().item()
        errs[name] = (g - w).abs().max().item() / top
        tol = (TOL[torch.float32]["out"] if name == "out"
               else BWD_TOL[torch.float32]["grad"])
        if not (torch.isfinite(g).all() and errs[name] <= tol):
            raise AssertionError(f"{label}: the tape's {name} "
                                 f"{errs[name]:.2e} of its largest, beyond "
                                 f"{tol:.0e}")
    log(f"  {label}: one attention {list(TRAIN_SHAPE)} through the tape "
        "against the plain versions, max|err|/max|ref|: "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    return errs


def dygraph_encoder_path(smi):
    """24(B): the dygraph Transformer-base encoder, DY_ENC_STEPS Adam steps
    plain and with each layer under ``recompute``, dropout from the
    tracer's generator: gradients bitwise equal, recompute's peak below
    the plain run's, the flash kernels counted by name in a trace.
    Returns ({path: traced launches}, numbers)."""
    I = pt.imperative
    label = "24(B) dygraph Transformer encoder"
    batches = [encoder_batch(DY_ENC["vocab"], DY_ENC["seq"], DY_ENC_BATCH,
                             SEED + 800 + i) for i in range(DY_ENC_STEPS)]
    n = DY_ENC["n_layer"]
    arms, out, numbers = {}, {}, {}
    with deterministic() as nondeterministic:
        for path, ck in (("imperative_transformer", False),
                         ("imperative_recompute", True)):
            grads, losses, step_ms, peak, out[path], rows, busy, host = \
                dygraph_encoder_arm(I, batches, ck, f"  {label} {path}",
                                    ((2 if ck else 1) * n,
                                     n * fa.BWD_KERNELS))
            arms[path] = grads
            kernels = sum(r[2] for r in rows)
            numbers[path] = {"losses": losses, "peak_gib": peak,
                             "step_ms": step_ms, "device_ms": busy,
                             "idle": max(0.0, 1 - busy / step_ms),
                             "kernels": kernels,
                             "aten_calls": host["calls"]}
            log(f"  {label} {path}: losses "
                + ", ".join(f"{x:.4f}" for x in losses)
                + f"; steady step {step_ms:.1f} ms (median of "
                f"{DY_ENC_TIMED} untraced), a traced step {busy:.1f} ms of "
                f"device time in {kernels} kernels (the card idle "
                f"{numbers[path]['idle']:.1%}), {host['calls']} aten calls "
                f"on the host; peak {peak:.2f} GiB [{smi}]")
            for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
                log(f"    device {us / 1e3:9.3f} ms {us / 10 / busy:5.1f}% "
                    f"x{count:<5} {key[:90]}")
            for key, ms, count in host["top"]:
                log(f"    host self {ms:9.3f} ms x{count:<5} {key[:90]}")
            del grads
            release()
    if nondeterministic:
        log(f"  {label}: ops without a deterministic implementation: "
            f"{nondeterministic}")
    plain, ck = arms["imperative_transformer"], arms["imperative_recompute"]
    differ = [(s, j) for s, (a, b) in enumerate(zip(plain, ck))
              for j, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    log(f"  {label}: recompute's gradients against the plain run's over "
        f"{DY_ENC_STEPS} steps x {len(plain[0])} parameters: "
        f"{len(differ)} differ (bitwise)")
    if differ or len(plain) != len(ck):
        raise AssertionError(f"{label}: recompute's gradients differ "
                             f"(step, parameter) {differ[:5]}")
    peaks = (numbers["imperative_transformer"]["peak_gib"],
             numbers["imperative_recompute"]["peak_gib"])
    log(f"  {label}: peak memory plain {peaks[0]:.2f} GiB, recompute "
        f"{peaks[1]:.2f} GiB")
    if not peaks[1] < peaks[0]:
        raise AssertionError(f"{label}: recompute's peak {peaks[1]:.2f} GiB "
                             f"is not below the plain run's {peaks[0]:.2f}")
    numbers["attention_errs"] = tape_attention_check(I, label)
    return out, numbers


def verify_arm(target, state, loss_name, feeds):
    """VERIFY_RUNS runs of ``target`` from ``state`` (eager, the capture,
    replays) on a fresh executor: (losses, the rewritten op list as bytes,
    the executor)."""
    exe = pt.Executor()
    scope = copy_state(state, exe.device)
    losses = [exe.run(target, feed=f, fetch_list=[loss_name], scope=scope,
                      return_numpy=False)[0].device_value()
              for f in feeds[:VERIFY_RUNS]]
    ops = exe.lowered_ops(target, [loss_name])
    return losses, repr([(o.type, o.inputs, o.outputs, sorted(
        o.attrs.items())) for o in ops]).encode(), exe


def traced_call(fn):
    """fn() under torch.profiler: (the device rows of the trace, the
    exception fn raised or None)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    raised = None
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        try:
            fn()
        except Exception as e:  # the caller holds it
            raised = e
        torch.cuda.synchronize()
    return sorted(kernel_rows(prof).items()), raised


def verify_program_path(label, program, startup, loss_name, feeds,
                        per_run):
    """24(C) on one program: VERIFY_RUNS runs with and without
    ``verify_passes`` under the bench BuildStrategy from one state (the
    flash kernels of both arms counted by name, ``per_run`` a run); then
    the program with the writer of its first temporary dropped. Returns (the traced
    launches, numbers)."""
    startup.random_seed = SEED
    init = pt.Scope()
    pt.Executor().run(startup, scope=init)
    state = {n: init.find_var(n) for n in init.var_names()}
    got = {}
    with deterministic(), traced_launches() as counted:
        for on in (False, True):
            bs = bench_build_strategy()
            bs.verify_passes = on
            got[on] = verify_arm(pt.CompiledProgram(program,
                                                    build_strategy=bs),
                                 state, loss_name, feeds)
    traced = check_launches(f"  {label}", counted,
                            tuple(2 * VERIFY_RUNS * n for n in per_run))
    memo = program.__dict__.get("_verify_memo", {})
    report = memo.get(program._version)
    checks = {k: r.get("checks", 0)
              for k, r in got[True][2].pipeline_stats["stages"].items()}
    plain_checks = [r.get("checks", 0)
                    for r in got[False][2].pipeline_stats["stages"].values()]
    if report is None or len(memo) != 1:
        raise AssertionError(f"{label}: verification memo {memo}")
    t0 = time.perf_counter()
    hit = pverify.verify_before_run(program) is report
    hit_us = (time.perf_counter() - t0) * 1e6
    log(f"  {label}: verified before the first run in "
        f"{report.wall_ms / 1e3:.4f} s ({report.summary()}); the "
        f"{VERIFY_RUNS - 1} runs after it hit the memo ({len(memo)} entry; "
        f"a lookup {hit_us:.1f} us); check_pass after every stage {checks}")
    if report.errors or not hit:
        raise AssertionError(f"{label}: {report.format()}")
    if not checks or any(c != 1 for c in checks.values()) or any(
            plain_checks):
        raise AssertionError(f"{label}: stage checks {checks} (without "
                             f"verification {plain_checks})")
    if got[True][1] != got[False][1]:
        raise AssertionError(f"{label}: the rewritten op lists differ")
    hold(label, f"{VERIFY_RUNS} losses with verification against without "
         f"(op lists byte-identical, {len(got[True][1])} bytes)",
         max(map(distance, got[True][0], got[False][0])), 0.0)

    bad = program.clone()
    blk = bad.global_block()
    ops = blk.desc.ops
    # the first op writing a temporary that a later op reads
    i, dropped = next(
        (i, n) for i, op in enumerate(ops) for n in op.output_arg_names()
        if not blk.desc.vars[n].persistable
        and any(n in later.input_arg_names() for later in ops[i + 1:]))
    del ops[i]
    blk.ops.pop(i)
    bs = bench_build_strategy()
    bs.verify_passes = True
    exe = pt.Executor()
    scope = copy_state(state, exe.device)
    rows, raised = traced_call(lambda: exe.run(
        pt.CompiledProgram(bad, build_strategy=bs), feed=feeds[0],
        fetch_list=[loss_name], scope=scope))
    if not isinstance(raised, pverify.ProgramVerifyError) or rows:
        raise AssertionError(f"{label}: the writer of {dropped} dropped: "
                             f"raised {raised!r}, device work {rows[:5]}")
    first = raised.diagnostics[0]
    log(f"  {label}: the writer of {dropped} dropped: ProgramVerifyError "
        f"({first.code}, {first.op_type} reads {first.var}), no device work "
        "in the run's trace")
    return traced, {"verify_s": report.wall_ms / 1e3,
                    "memo_lookup_us": hit_us, "stage_checks": checks,
                    "summary": report.summary()}


def verify_paths(smi):
    """24(C): phase 11's compiled Transformer-base (CUT_LAYERS + CUT_LAYERS
    layers, AMP) and phase 9's ResNet-50 AMP under verify_passes.
    Returns (the Transformer's traced flash launches, numbers)."""
    numbers = {}
    with unique_name.guard():
        m = transformer.build(attention_impl="unfused", **cut_model())
    traced, numbers["transformer"] = verify_program_path(
        "24(C) Transformer compiled AMP",
        mixed_precision.decorate(m["main"].clone()), m["startup"],
        m["loss"].name, [train_batch(m["config"], TRAIN_BATCH, SEED + 900 + i)
                         for i in range(VERIFY_RUNS)],
        flash_per_step(CUT_LAYERS))
    del m
    release()
    with unique_name.guard():
        r = resnet.build(dataset="flowers", depth=50, class_dim=RESNET_CLASSES,
                         image_shape=list(RESNET_IMAGE), lr=0.1)
    _, numbers["resnet"] = verify_program_path(
        "24(C) ResNet-50 compiled AMP",
        mixed_precision.decorate(r["main"].clone()), r["startup"],
        r["loss"].name, [resnet_batch(RESNET_BATCH, SEED + 900 + i)
                         for i in range(VERIFY_RUNS)], (0, 0))
    del r
    release()
    log(f"  24(C): [{smi}]")
    return traced, numbers


def imperative_paths(smi):
    """Phase 24; returns the flash launches of its paths (traced by kernel
    name: 24(A) none, 24(B) DY_ENC_STEPS steps of each arm, 24(C) those of
    both programs' runs under verification) and each part's numbers."""
    out, numbers, secs = {}, {}, {}
    t0 = time.perf_counter()
    fa.launches = fa.bwd_launches = 0
    numbers["resnet"] = dygraph_resnet_path(smi)
    out["imperative_resnet"] = (fa.launches, fa.bwd_launches)
    if out["imperative_resnet"] != (0, 0):
        raise AssertionError(f"24(A): flash wrapper calls "
                             f"{out['imperative_resnet']}")
    secs["A"] = time.perf_counter() - t0
    release()
    t0 = time.perf_counter()
    launches, numbers["encoder"] = dygraph_encoder_path(smi)
    out.update(launches)
    secs["B"] = time.perf_counter() - t0
    release()
    t0 = time.perf_counter()
    out["verify_paths"], numbers["verify"] = verify_paths(smi)
    secs["C"] = time.perf_counter() - t0
    log("24: " + ", ".join(f"({k}) {s:.1f} s" for k, s in secs.items()))
    return out, numbers


IMPERATIVE_CHILD_S = 600


def imperative_paths_child(smi):
    """Phase 24 in a process of its own (``--imperative-child OUT``), as
    ``--phase 24`` runs it. In the whole script's process, after phases
    5-23, every torch.profiler trace of the dygraph encoder lost one
    flash-forward record that the wrappers counted (29 of 30 over a
    window, 5 of 6 in a one-step trace, with or without a warm-up cycle
    of the profiler: PERF.md §7), while a fresh process's traces count
    them all. Prints the child's output; returns its launches by path
    (its wrappers' counts and its traces) and its numbers."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_24_",
                                     dir=_build.BUILD_DIR) as d:
        path = os.path.join(d, "phase24.json")
        r = subprocess.run(ELASTIC_CHILD + ["--imperative-child", path],
                           capture_output=True, text=True,
                           timeout=IMPERATIVE_CHILD_S)
        log(r.stdout.rstrip())
        if r.returncode != 0:
            log(r.stderr[-6000:])
            raise AssertionError(f"phase 24's process exited {r.returncode}")
        with open(path) as f:
            got = json.load(f)
    log(f"  24: [{smi}]")
    return {k: tuple(v) for k, v in got["launches"].items()}, got["numbers"]


# ---------------------------------------------------------------------------
# phase 25: observability (the monitor, profile sessions, the footprint)
# ---------------------------------------------------------------------------

OBS_BUCKETS = (4, 8)        # a two-bucket ladder keeps the warm-up short
OBS_SIZES = (3, 8, 5, 1)    # request rows, cycling: both buckets
OBS_REQUESTS = 32           # per arm, from FRONT_CLIENTS threads
OBS_WINDOW = 8              # requests (device calls) in the profile session
OBS_TRAIN_STEPS = 5         # steps of the training profile session
OBS_DELAY_S = 0.5           # the injected fault delay of 25(B)
OBS_SLOTS = 8               # 25(C): the predictor's slots
OBS_CHILD_S = 600


def obs_get(port, route):
    """(status, body) of a GET on the monitor's live plane."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def flash_rows(rep):
    """(forward, backward) flash kernels the report attributes to the
    flash ops' rows, and (forward, backward) anywhere in its rows."""
    fwd = bwd = all_fwd = all_bwd = 0
    for r in rep["rows"]:
        mine = r["op"].split(".", 1)[0] in ("flash_attention",
                                             "flash_attention_grad")
        for k, n in r["kernels"].items():
            f, b = "flash_fwd_kernel" in k, "flash_bwd_" in k
            all_fwd, all_bwd = all_fwd + f * n, all_bwd + b * n
            if mine:
                fwd, bwd = fwd + f * n, bwd + b * n
    return (fwd, bwd), (all_fwd, all_bwd)


def log_report(label, rep, smi, top=10):
    """The session report's summary and its top rows."""
    log(f"  {label}: {rep['steps']} steps, device {rep['device_time_s'] * 1e3:.3f}"
        f" ms, attributed {rep['attributed_s'] * 1e3:.3f} ms, coverage "
        f"{rep['coverage']:.4f}, replays {rep['replays']} (without a "
        f"table {rep['replays_without_table']}), misaligned "
        f"{rep['misaligned']}, lost_records {rep['lost_records']}, window "
        f"{rep['window_wall_s'] * 1e3:.1f} ms [{smi}]")
    log(f"    the session's trace: {rep['trace_losses']}")
    for key, mi in rep["modules"].items():
        log(f"    plan segment {key}: {mi.get('replays', 0)} replays of "
            f"{mi.get('replay_kernels')} kernels against a table of "
            f"{mi.get('table_kernels')} (its trace: "
            f"{mi.get('table_trace')}); first differences "
            f"{mi.get('misaligned_sample')}")
    for r in rep["rows"][:top]:
        log(f"    {r['op'][:72]:<72} {r['device_s'] * 1e3:9.3f} ms "
            f"{r['share'] * 100:5.1f}% {r['calls']:6d} kernels ({r['source']})")
    if rep.get("error"):
        raise AssertionError(f"{label}: the session failed: {rep['error']}")


def obs_front(model_dir, arm):
    return create_paddle_predictor(
        AnalysisConfig(model_dir).enable_bf16()
        .enable_shape_bucketing(batch_buckets=OBS_BUCKETS)
        .enable_request_coalescing(max_batch_size=OBS_BUCKETS[-1],
                                   batch_timeout_us=FRONT_TIMEOUT_US))


def obs_serving(model_dir, cfg, smi):
    """25(A): the serving front, the monitor off and then on. Returns the
    session window's flash (forward, backward) launches and the numbers."""
    from paddle_tpu_torch import monitor
    requests = [make_request(cfg, OBS_SIZES[i % len(OBS_SIZES)],
                             SEED + 2500 + i) for i in range(OBS_REQUESTS)]
    nodes, numbers, launches = {}, {}, None
    for arm in ("off", "on"):
        if arm == "on":
            monitor.reset()
            monitor.enable()
            port = monitor.serve_http(port=0).server_port
        fa.launches = fa.bwd_launches = 0
        front = obs_front(model_dir, arm)
        try:
            t0 = time.perf_counter()
            with graphs_kept() as kept:
                # one cell at a time: each cell's first run builds its
                # plan's kernel table from a trace of its own
                front.warmup(compile_workers=1)
            warm_s = time.perf_counter() - t0
            nodes[arm] = sorted(graph_flash_nodes(g) for g in kept)
            # a first pass warms the clients' paths; the second is timed
            for _ in range(2):
                outs, lat, wall = run_clients(
                    front.run, requests,
                    check=lambda i, out: check_logits(
                        f"25(A) {arm}", requests[i], out, cfg))
            if not all(bool(f) for f in outs):
                raise AssertionError(f"25(A) {arm}: logits not finite")
            numbers[arm] = {"warmup_s": warm_s,
                            "requests_per_s": OBS_REQUESTS / wall,
                            "p50_ms": float(np.percentile(lat, 50)),
                            "p99_ms": float(np.percentile(lat, 99))}
            log(f"  25(A) monitor {arm}: warm-up of {len(OBS_BUCKETS)} "
                f"buckets {warm_s:.2f} s, graphs' (flash fwd, bwd) and "
                f"kernel nodes {nodes[arm]}; {OBS_REQUESTS} requests from "
                f"{FRONT_CLIENTS} threads (a second pass) "
                f"{OBS_REQUESTS / wall:.1f} "
                f"requests/s, p50 {numbers[arm]['p50_ms']:.2f} ms, p99 "
                f"{numbers[arm]['p99_ms']:.2f} ms [{smi}]")
            if fa.launches == 0:
                raise AssertionError(f"25(A) {arm}: the flash forward's "
                                     "wrapper never launched")
            if arm == "off":
                continue
            snap = monitor.snapshot()
            if snap.get("serving_requests_total") != 2 * OBS_REQUESTS:
                raise AssertionError(
                    f"25(A): serving_requests_total "
                    f"{snap.get('serving_requests_total')}, sent "
                    f"{2 * OBS_REQUESTS}")
            b0 = snap["serving_batches_total"]
            sess = monitor.profile_session(steps=OBS_WINDOW)
            fut = None
            for i in range(OBS_WINDOW):
                fut = front.submit(requests[i])
                fut.result(timeout=60)
            if not sess.wait(120):
                raise AssertionError("25(A): the session's window never "
                                     "closed")
            rep = sess.result
            calls = monitor.snapshot()["serving_batches_total"] - b0
            log_report(f"25(A) session over {OBS_WINDOW} requests "
                       f"({calls} device calls)", rep, smi)
            (fwd, bwd), anywhere = flash_rows(rep)
            log(f"  25(A) flash_attention rows: {fwd} forward kernels "
                f"({anywhere[0]} anywhere in the trace), want "
                f"{LAUNCHES_PER_REQUEST} x {calls} device calls")
            if calls != OBS_WINDOW or fwd != LAUNCHES_PER_REQUEST * calls \
                    or bwd:
                raise AssertionError(f"25(A): {fwd} flash forward kernels "
                                     f"in the flash rows over {calls} calls")
            launches = (fwd, bwd)
            numbers["session"] = {k: rep[k] for k in (
                "coverage", "lost_records", "misaligned", "replays",
                "device_time_s")}
            # the live plane
            for route in ("/metrics", "/healthz", "/vars",
                          f"/trace?id={fut.trace_id}", "/memory"):
                code, body = obs_get(port, route)
                if code != 200:
                    raise AssertionError(f"25(A): GET {route} -> {code}")
                if route != "/metrics":
                    json.loads(body)
            if f"serving_requests_total {2 * OBS_REQUESTS + OBS_WINDOW}" \
                    not in obs_get(port, "/metrics")[1]:
                raise AssertionError("25(A): /metrics lacks the requests")
            health = json.loads(obs_get(port, "/healthz")[1])
            trace = json.loads(obs_get(port, f"/trace?id={fut.trace_id}")[1])
            mem = json.loads(obs_get(port, "/memory")[1])
            log(f"  25(A) live plane on port {port}: /healthz "
                f"{health['status']}, {len(health['components'])} "
                f"components; /trace {fut.trace_id}: "
                f"{[s['name'] for s in trace['spans']]}; /memory "
                f"{len(mem['executables'])} plan segments, devices "
                f"{list(mem['devices'])}")
            if health["status"] != "ok" or not trace["ok"]:
                raise AssertionError("25(A): unhealthy or a failed trace")
        finally:
            front.shutdown()
    if nodes["on"] != nodes["off"]:
        raise AssertionError(f"25(A): kernels per replay differ with the "
                             f"monitor on {nodes['on']} and off "
                             f"{nodes['off']}")
    numbers["graph_nodes"] = nodes["on"]
    return launches, numbers


def obs_training(smi):
    """25(B): Transformer-base AMP training through CompiledProgram,
    captured, with a profile session, the footprint and the pre-flight,
    and an injected fault delay. Returns the window's flash (forward,
    backward) launches and the numbers."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.profiling import memory as pmem
    from paddle_tpu_torch.testing import FaultPlan
    with unique_name.guard():
        m = transformer.build(**MODEL)
    m["startup"].random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(m["startup"], scope=scope)
    amp = mixed_precision.decorate(m["main"].clone())
    target = pt.CompiledProgram(amp, build_strategy=bench_build_strategy())
    loss = m["loss"].name
    feeds = [train_batch(m["config"], TRAIN_BATCH, SEED + 2600 + i)
             for i in range(4)]
    fa.launches = fa.bwd_launches = 0
    t0 = time.perf_counter()
    with graphs_kept() as kept:
        for i in range(2):  # the warm-up, then the capture
            exe.run(target, feed=feeds[i], fetch_list=[loss], scope=scope)
    warm_s = time.perf_counter() - t0
    want = (FWD_PER_STEP, BWD_PER_STEP)
    graph_nodes = graph_flash_nodes(kept[-1])
    log(f"  25(B) warm-up and capture {warm_s:.2f} s; the step's graph: "
        f"{graph_nodes[0]} flash nodes (want {want}) of {graph_nodes[1]} "
        f"kernel nodes")
    if graph_nodes[0] != want or not fa.launches or not fa.bwd_launches:
        raise AssertionError(f"25(B): graph flash nodes {graph_nodes}, "
                             f"wrapper calls {fa.launches}, "
                             f"{fa.bwd_launches}")
    sess = monitor.profile_session(steps=OBS_TRAIN_STEPS)
    losses = [float(exe.run(target, feed=feeds[i % len(feeds)],
                            fetch_list=[loss], scope=scope)[0].item())
              for i in range(OBS_TRAIN_STEPS)]
    if not sess.wait(120) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"25(B): window open or losses {losses}")
    rep = sess.result
    log_report(f"25(B) session over {OBS_TRAIN_STEPS} captured steps", rep,
               smi)
    (fwd, bwd), anywhere = flash_rows(rep)
    log(f"  25(B) flash rows: {fwd} forward + {bwd} backward kernels "
        f"({anywhere} anywhere), want {OBS_TRAIN_STEPS} x {want}")
    if (fwd, bwd) != (OBS_TRAIN_STEPS * want[0], OBS_TRAIN_STEPS * want[1]):
        raise AssertionError(f"25(B): flash rows {fwd}, {bwd}")
    (key, mod), = [(k, v) for k, v in rep["modules"].items()
                   if v.get("cost_flops")]
    peak, src = monitor.peak_flops()
    host_mfu = monitor.snapshot().get('executor_mfu{key="%s"}' % key)
    log(f"  25(B) plan segment {key}: {mod['cost_flops'] / 1e12:.3f} TFLOP "
        f"a step (FlopCounterMode + the flash kernels by formula), "
        f"{mod['calls']} runs, device {mod['device_us'] / 1e3:.3f} ms, "
        f"measured MFU {mod.get('mfu_measured', 0):.4f} of {src}'s "
        f"{peak / 1e12:.0f} TFLOP/s bf16; executor_mfu (host wall) "
        f"{host_mfu}")
    fp = pmem.footprints()[key]
    gib = 2.0 ** 30
    log(f"  25(B) footprint: predicted peak {fp['peak_bytes'] / gib:.3f} GiB "
        f"at op #{fp['peak_op_idx']} [{fp['peak_op_type']}], top var "
        f"{fp['top_vars'][0]['name']}; measured (allocator peak over the "
        f"run, plus its inputs) eager {(fp['measured_peak_bytes'] or 0) / gib:.3f}"
        f" GiB (agreement {fp['agreement']}), captured "
        f"{(fp['measured_captured_peak_bytes'] or 0) / gib:.3f} GiB "
        f"(agreement {fp['agreement_captured']}) [{smi}]")
    numbers = {"session": {k: rep[k] for k in (
        "coverage", "lost_records", "misaligned", "replays",
        "device_time_s")}, "mfu": mod.get("mfu_measured"),
        "flops": mod["cost_flops"], "footprint": {k: fp[k] for k in (
            "peak_bytes", "peak_op_type", "measured_peak_bytes",
            "measured_captured_peak_bytes", "agreement",
            "agreement_captured")}, "warm_s": warm_s}

    # the pre-flight: half the prediction refuses a new plan before any
    # device work
    old = FLAGS.memory_budget_bytes
    FLAGS.memory_budget_bytes = fp["peak_bytes"] // 2
    other = pt.CompiledProgram(mixed_precision.decorate(amp.clone()),
                               build_strategy=bench_build_strategy())
    torch.cuda.synchronize()
    mem0, calls0 = torch.cuda.memory_allocated(), fa.launches
    try:
        exe.run(other, feed=feeds[0], fetch_list=[loss], scope=scope)
        raise AssertionError("25(B): the pre-flight let the plan run")
    except pmem.MemoryBudgetExceeded as e:
        refused = e
    finally:
        FLAGS.memory_budget_bytes = old
    torch.cuda.synchronize()
    if (torch.cuda.memory_allocated() != mem0 or fa.launches != calls0
            or refused.report.peak_op_type not in str(refused)):
        raise AssertionError("25(B): the refused plan did device work or "
                             "its error names no op at peak")
    log(f"  25(B) pre-flight at a budget of {refused.budget} bytes: "
        f"MemoryBudgetExceeded naming op #{refused.report.peak_op_idx} "
        f"[{refused.report.peak_op_type}] and {refused.report.top_var}, "
        f"no device work (allocated bytes and flash calls unchanged)")

    # the slow-step detector: an injected delay warns once with its cause
    # (a repeat of the same step class and cause is counted, not warned)
    # and the escalation's capture of the next 3 steps writes a flight
    # record; its cooldown (FLAGS.profile_slow_step_cooldown_s, 600 s)
    # keeps the repeat from arming a second one
    def suppressed_total():
        return sum(v for k, v in monitor.snapshot().items()
                   if k.startswith("slow_step_suppressed_total"))

    suppressed0 = suppressed_total()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_25_",
                                     dir=_build.BUILD_DIR) as d:
        saved = (FLAGS.flight_record_dir, FLAGS.profile_on_slow_step)
        FLAGS.flight_record_dir, FLAGS.profile_on_slow_step = d, True
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    FaultPlan().delay("executor.run", calls=[0, 4],
                                      seconds=OBS_DELAY_S):
                warnings.simplefilter("always")
                for i in range(5):
                    exe.run(target, feed=feeds[i % len(feeds)],
                            fetch_list=[loss], scope=scope)
        finally:
            FLAGS.flight_record_dir, FLAGS.profile_on_slow_step = saved
        slow = [str(w.message) for w in caught
                if "slow step" in str(w.message)]
        records = [n for n in os.listdir(d) if "slow_step_profile" in n]
        suppressed = suppressed_total() - suppressed0
        log(f"  25(B) fault delay of {OBS_DELAY_S} s at two steps: "
            f"warnings {slow}; the repeat suppressed: {suppressed}; flight "
            f"records {records}")
        if len(slow) != 1 or len(records) != 1 or suppressed != 1:
            raise AssertionError("25(B): the slow step did not warn once "
                                 "with one flight record")
    numbers["slow_step"] = slow[0]
    return (fwd, bwd), numbers


def obs_generation(smi):
    """25(C): GenerationPredictor over build_lm at phase 14's widths, its
    dense slot table's cap downshifted by a memory budget."""
    from paddle_tpu_torch.profiling import memory as pmem
    with unique_name.guard():
        spec = transformer.build_lm(**GEN_LM)["spec"]
    spec.startup.random_seed = SEED
    eng = gen_engine(spec, paged=False, prefix=False)
    top = eng.prompt_ladder.top + eng.new_ladder.top
    budget = eng.state_nbytes(OBS_SLOTS, top - eng.new_ladder.top + 64) + 1
    old = FLAGS.memory_budget_bytes
    FLAGS.memory_budget_bytes = budget
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pred = GenerationPredictor(eng, max_slots=OBS_SLOTS,
                                       decode_chunk=8)
        picked = eng.max_fitting_config(OBS_SLOTS)
    finally:
        # the executor's pre-flight holds every plan to the same budget,
        # which the LM's weights alone exceed: the cap is read once, here
        FLAGS.memory_budget_bytes = old
    try:
        log(f"  25(C) budget {budget} bytes: (slots, cap) "
            f"({OBS_SLOTS}, {pred._cap}) from ({OBS_SLOTS}, {top}); "
            f"max_fitting_config {picked}; "
            f"{[str(w.message)[:90] for w in caught]}")
        if picked != (OBS_SLOTS, pred._cap) or pred._cap >= top:
            raise AssertionError(f"25(C): cap {pred._cap}, "
                                 f"max_fitting_config {picked}")
        t0 = time.perf_counter()
        pred.warmup()
        prompts = gen_prompts(GEN_LM["vocab"], SEED + 25, n=OBS_SLOTS)
        futs = [pred.submit(p, max_new_tokens=32) for p in prompts]
        outs = [f.result(timeout=120) for f in futs]
        took = time.perf_counter() - t0
        tokens = sum(len(o) for o in outs)
        log(f"  25(C) warm-up and {len(prompts)} requests: {took:.2f} s, "
            f"{tokens} tokens, every request resolved; health "
            f"{pred.health()['healthy']} [{smi}]")
        if len(outs) != len(prompts) or not all(len(o) for o in outs):
            raise AssertionError("25(C): a request did not resolve")
    finally:
        pred.shutdown()
    return {"slots": OBS_SLOTS, "cap": pred._cap, "top_cap": top,
            "budget": budget, "tokens": tokens}


def observability_paths(smi):
    """Phase 25; returns its flash launches by path (the session windows'
    kernels by name: 25(A) OBS_WINDOW requests, 25(B) OBS_TRAIN_STEPS
    steps) and each part's numbers."""
    from paddle_tpu_torch import monitor
    out, numbers, secs = {}, {}, {}
    try:
        t0 = time.perf_counter()
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_25_model_",
                                         dir=_build.BUILD_DIR) as d:
            m = transformer.build(**MODEL)
            m["startup"].random_seed = SEED
            exe, scope = pt.Executor(), pt.Scope()
            with pt.scope_guard(scope):
                exe.run(m["startup"])
                pt.io.save_inference_model(d, FEEDS, [m["logits"]], exe,
                                           main_program=m["test"])
            del exe, scope
            launches, numbers["serving"] = obs_serving(d, m["config"], smi)
        out["observability_serving"] = launches
        secs["A"] = time.perf_counter() - t0
        release()
        t0 = time.perf_counter()
        out["observability_training"], numbers["training"] = \
            obs_training(smi)
        secs["B"] = time.perf_counter() - t0
        release()
        t0 = time.perf_counter()
        numbers["generation"] = obs_generation(smi)
        out["observability_generation"] = (0, 0)
        secs["C"] = time.perf_counter() - t0
    finally:
        monitor.stop_http()
        monitor.disable()
    numbers["seconds"] = secs
    log("25: " + ", ".join(f"({k}) {s:.1f} s" for k, s in secs.items()))
    return out, numbers


def observability_paths_child(smi):
    """Phase 25 in a process of its own (``--observability-child OUT``),
    as ``--phase 25`` runs it, away from the record drops of a process
    that ran phases 5-24 (PERF.md §7). Prints the child's output; returns
    its launches by path and its numbers."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_25_",
                                     dir=_build.BUILD_DIR) as d:
        path = os.path.join(d, "phase25.json")
        t0 = time.perf_counter()
        r = subprocess.run(ELASTIC_CHILD + ["--observability-child", path],
                           capture_output=True, text=True,
                           timeout=OBS_CHILD_S)
        log(r.stdout.rstrip())
        if r.returncode != 0:
            log(r.stderr[-6000:])
            raise AssertionError(f"phase 25's process exited {r.returncode}")
        with open(path) as f:
            got = json.load(f)
    log(f"  25: {time.perf_counter() - t0:.1f} s with its process's start "
        f"[{smi}]")
    return {k: tuple(v) for k, v in got["launches"].items()}, got["numbers"]


# the phases that need nothing of an earlier one, each run alone by
# ``--phase N``: N -> its flash launches by path
ALONE = {
    12: lambda smi: bert_paths(smi, False),
    14: lambda smi: generation_paths(smi)[0],
    15: lambda smi: predictor_and_beam_paths(smi)[0],
    16: runtime_paths,
    17: lambda smi: zoo_paths(smi)[0],
    18: lambda smi: recurrent_paths(smi)[0],
    19: lambda smi: control_sequence_ctc_paths(smi)[0],
    20: lambda smi: detection_paths(smi)[0],
    21: lambda smi: tensor_loss_rnn_paths(smi)[0],
    22: lambda smi: vision_paths(smi)[0],
    23: lambda smi: quant_rest_paths(smi)[0],
    24: lambda smi: imperative_paths(smi)[0],
    25: lambda smi: observability_paths(smi)[0],
}


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--profile", action="store_true")
    args.add_argument("--kernels", action="store_true",
                      help="phases 1-4 only, then the kernels line and no "
                      "contract line")
    args.add_argument("--phase", type=int, choices=sorted(ALONE),
                      help="phases 1-2, then this phase alone, its "
                      "seconds and its launches; no kernels line and no "
                      "contract line")
    # one process of phase 16(A), started by the phase itself
    args.add_argument("--elastic-child", nargs=3, help=argparse.SUPPRESS,
                      metavar=("ROLE", "CKPT", "OUT"))
    # the processes of phases 24 and 25, started by the whole script
    args.add_argument("--imperative-child", help=argparse.SUPPRESS,
                      metavar="OUT")
    args.add_argument("--observability-child", help=argparse.SUPPRESS,
                      metavar="OUT")
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
    if args.imperative_child:
        _build.build()  # the parent's libraries, found by their hash
        launches, numbers = imperative_paths(nvidia_smi_line())
        with open(args.imperative_child, "w") as f:
            json.dump({"launches": launches, "numbers": numbers}, f,
                      default=str)
        return 0
    if args.observability_child:
        _build.build()
        launches, numbers = observability_paths(nvidia_smi_line())
        with open(args.observability_child, "w") as f:
            json.dump({"launches": launches, "numbers": numbers}, f,
                      default=str)
        return 0

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

    if args.phase:
        phase(f"phase {args.phase} alone")
        t0 = time.perf_counter()
        launches = ALONE[args.phase](smi)
        log(f"phase {args.phase} took {time.perf_counter() - t0:.1f} s; "
            f"flash launches {launches}")
        print(smi, flush=True)
        return 0

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
            phase("the model zoo: DeepFM, MNIST LeNet, SE-ResNeXt-50, "
                  "VGG-16, stacked LSTM and the rest of the zoo through "
                  "CompiledProgram, captured against eager; DeepFM and the "
                  "LSTM served through AnalysisPredictor")
            paths.update(zoo_paths(smi)[0])
            release()
            phase("recurrent training and structured prediction: machine "
                  "translation training at the Fluid benchmark's widths and "
                  "its beam decode on the trained scope, label_semantic_roles "
                  "at the book's widths with its Viterbi, a bounded While "
                  "trained, through CompiledProgram, captured against eager")
            paths.update(recurrent_paths(smi)[0])
            release()
            phase("conditional control flow, the sequence ops and CTC: "
                  "CRNN-CTC training at ocr_recognition's widths, IfElse "
                  "with a Switch learning rate, conditional_block, the op "
                  "bank on the card against the CPU, the seqconv fusion "
                  "served")
            paths.update(control_sequence_ctc_paths(smi)[0])
            release()
            phase("object detection: MobileNet-SSD training at PaddleCV's "
                  "VOC widths, its evaluation and detection_map, the "
                  "detection model served, the YOLOv3 head trained and "
                  "decoded, the 33 detection types on the card against the "
                  "CPU")
            paths.update(detection_paths(smi)[0])
            release()
            phase("the general tensor, loss and RNN-unit ops: "
                  "Transformer-base trained with PaddleNLP's label "
                  "smoothing, word2vec with the nce and hsigmoid heads, the "
                  "35 types on the card against the CPU")
            paths.update(tensor_loss_rnn_paths(smi)[0])
            release()
            phase("the image and NN op families: SimpleBaseline pose "
                  "(ResNet-50 + conv2d_transpose head) at MPII widths, "
                  "ResNet-50 with its in-graph random_crop, the 36 types on "
                  "the card against the CPU")
            paths.update(vision_paths(smi)[0])
            release()
            phase("quantization, model compression and ModelAverage: "
                  "ResNet-50 trained quantization-aware and served frozen to "
                  "int8, ResNet-50 pruned and retrained under CompressPass, "
                  "CRNN-CTC with ModelAverage, the 26 types on the card "
                  "against the CPU")
            paths.update(quant_rest_paths(smi)[0])
            release()
            phase("imperative (dygraph) mode and the pass verifier: "
                  "ResNet-50 fed from dataset.flowers, the Transformer-base "
                  "encoder through the tape with and without recompute, "
                  "verify_passes on the compiled Transformer and ResNet-50")
            paths.update(imperative_paths_child(smi)[0])
            release()
            phase("observability: the monitor, profile sessions over "
                  "captured plans, the memory footprint and budget, on the "
                  "serving front, a compiled AMP training step and "
                  "generation")
            paths.update(observability_paths_child(smi)[0])
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
    log(f"the script's phases took {time.perf_counter() - _START:.1f} s")
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
