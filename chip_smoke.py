#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (nvcc, at
first use), holds each kernel against its plain PyTorch version on the card,
serves GPT-3 1.3B (``gpt3_1p3b``: 24 layers, hidden 2048, 16 heads, vocab
50304; random weights from a seed) through ``ServingEngine``, trains it
through ``TrainStep``, trains BERT-base (12 layers, hidden 768, 12 heads of
64, vocab 30522) the same way, trains ResNet-50 at bench.py's config 2 on
its conv-kernel route, and trains ERNIE-base (12 layers, hidden 768, 12
heads of 64, vocab 40000) at bench.py's config 5 and at its own 2048-token
context, trains and decodes nn.Transformer at Transformer-base width,
trains GPT-3 Medium under activation recompute, samples from GPT-3 1.3B,
serves bench.py's overload trace through the resilience tier, and trains
ResNeXt-50 32x4d and Wide ResNet-50-2:

1. env     torch, CUDA, nvcc and the card as nvidia-smi names it;
2. build   the kernels, timed, with ptxas's register and spill report;
3. kernel  K1 (flash_fwd: bf16 on its tensor-core body flash_fwd_tc,
           flash_fwd_tc.cu, float32 on its CUDA-core body, flash_fwd.cu,
           each counted apart) against flash_fwd_reference at the serving
           path's shapes and the edge cases, the tensor-core body's masked,
           ragged, GQA and dropout forms at D = 64, 128 and 256, and timed
           at S=2048 (bf16 at B=1 and at the training shape B=4, float32
           at B=1);
4. kernel_bwd  K2 and K3 (flash_bwd: bf16 at head dims 64 and 128 on their
           tensor-core bodies, flash_bwd_dq_tc and flash_bwd_dkv_tc,
           flash_bwd_tc.cu, float32 and bf16 at 256 on their CUDA-core
           bodies, flash_bwd.cu, each counted apart) against
           flash_bwd_reference in the same cases and in the tensor-core
           bodies' edge cases (ragged stages, rows with no key, GQA, pad
           sentinels, dropout, several waves), the tensor-core bodies
           against the plain version that sums dp as mma.sync does
           (mma_dot, first held bit for bit against the card's own sums),
           and timed at the training shape (B=4, S=2048; the CUDA-core
           bodies there in float32, and in bf16 at head dim 256);
   kernel_masked  K1, K2 and K3 with segment ids and the key bias at GPT-3
           1.3B's attention shape (B=4, S=2048, H=16, D=128, bf16; 16 and 4
           KV heads): a key-padding mask as bool segments and as the f32
           key bias, and causal packed documents, each against the plain
           versions, then timed with and without the masks; then
           nn.MultiHeadAttention(2048, 16) with a key-padding mask, forward
           and backward (K1, K2, K3 once each), against the dense path;
   dense_route  ops.flash_attention at head dim 32 in float32 and float16:
           the dense route (reference_attention, with the kernels' dropout
           mask as its keep) with no kernel launch, against the CPU; float16
           at head dims 64 and 128 the kernel route, computed there by K1's
           tensor-core body and held against its plain version; no model
           path below takes the dense route (dense_route_paths);
5. kernel_packed  K4a-direct (flash_packed_fwd: its bf16 tensor-core body
           flash_packed_fwd_tc, flash_packed_tc.cu, and its float32 body,
           flash_packed.cu) and K4b-fused (flash_packed_bwd: its bf16
           tensor-core body flash_packed_bwd_tc, one thread-block cluster a
           head in flash_bwd_tc.cu, held against the plain version that sums
           dp as mma.sync does; its float32 body in flash_packed.cu) against
           their plain versions with and without masks, and at BERT-base's
           shape (B=64, S=512, H=12) with bench.py's padding bias, where
           they are timed (the float32 bodies on the same inputs in
           float32), the tensor-core K4b run twice for bit-equal gradients
           and timed beside SDPA's backward and two yardsticks no path
           runs: the CUDA-core body in bf16 and the streamed dq + dk/dv
           bodies on the same inputs;
6. kernel_packed_stream  K4's streamed forms (the forward: bf16 on K1's
           tensor-core body, flash_packed_fwd_stream_tc, float32 on
           flash_packed_stream.cu; dq and dk/dv: bf16 on K2's and K3's
           tensor-core bodies, flash_bwd_tc.cu, counted as
           flash_packed_bwd_dq_tc and flash_packed_bwd_dkv_tc, float32 on
           flash_packed_stream.cu; dk/dv-direct: bf16 on K3's tensor-core
           body, counted as flash_packed_bwd_dkv_direct_tc, float32 on
           flash_packed_stream.cu) against their plain versions in 24
           cases (f32 and bf16, masks, causal with Sq != Sk, Sq and Sk
           past whole tiles, rows with no key, pad sentinels, a
           batch of several waves), each checked to run the bodies of its
           dtype (the tensor-core dq and dk/dv against plain versions that
           sum dp as mma.sync does, hfp.mma_dot, itself first held against
           the card's own sums bit for bit), then compared and timed at
           ERNIE's long shape (B=16, S=2048, H=12, bf16, with and without
           bench.py's padding bias; the float32 forward, dq and dk/dv
           bodies on the same inputs in f32) and dq and dk/dv-direct at
           512 queries over 2048 keys (dk/dv-direct beside its CUDA-core
           body in bf16, a yardstick no path runs, and in float32);
7. kernel_conv  K5-K8 (conv.cu: mm, mm_wgrad, c3, c3_wgrad) against their
           plain versions, forward with stats, input gradient and weight
           gradient, in 16 cases (stride 1 and 2, prologue with ReLU or
           none or off, stats on and off, ragged M, odd H, C and K not whole
           8-value pieces, f32, the three B=256 shapes JAX's TPU rule
           keeps off its kernels, and layer1's 1x1 64->64 at B=256, whose
           dw split takes two reduction passes),
           then compared again and timed at the JAX package's
           RESNET50_TOP3_SHAPES at B=256 (stats over two reduction passes)
           against their bounds, their plain versions and cuDNN; K8 (in 16
           bits one block holds all nine taps, conv3x3_wgrad_tc_kernel) also
           at each of ResNet-50's seven 3x3 weight-gradient shapes (B=256;
           RESNET50_K8_SHAPES, 16 launches a step), held against its plain
           version, repeated bit for bit and timed beside the one-block-a-tap
           body it had before (a yardstick no path runs), its bound and
           cuDNN, with the step's K8 time in both bodies; K7, K6 and K5
           likewise at ResNet-50's 3x3 and 1x1 shapes (k7_stages,
           k6_stages, k5_stages: K5's forwards with the prologue and the
           stats and its 1x1 input gradients, bf16 and float16, beside
           the 128 x 64 body it had before, mm_tiles64);
8. serve_f32   3 requests x 16 tokens, token-exact against the model's
           dense-cache ``generate``; every prefill runs K1's float32
           body once per layer;
   serve_tiers (part "f32")  the engine's three throughput tiers on the
           same f32 model, each output held to generate by serve_f32's
           rule: radix prefix sharing (4 prompts of 256 tokens on a
           208-token shared prefix), chunked prefill at 64 tokens (a
           480-token prompt arriving among 3 short residents), speculative
           decoding with the n-gram drafter at gamma 4 and a ModelDrafter
           (2 layers at full width, the target's embeddings, first blocks
           and final LayerNorm) at gamma 2 under pool pressure, and all
           three composed; K1's f32 body exactly once a layer for each cold
           one-shot prefill, no other kernel, the pool holding only the
           tree's blocks after each drain;
9. serve_bf16  8 requests of 64..1536 prompt tokens x 32 tokens through a
           pool of about half the trace's blocks, shrunk until a CPU dry
           run of the trace preempts (spill to pinned host memory and
           restore); every prefill runs K1's tensor-core body once per
           layer;
   serve_tiers (part "bf16")  bench.py's three tier legs on the bf16
           model: prefix sharing at share ratios 0/0.5/0.8 (8 users of
           1024 tokens, two distinct-token warm passes, then one timed:
           tokens/s, hit rate and peak live blocks on and off, the blocks
           cut at least 2x at 0.8), chunked prefill at budgets 256 and 0
           (a 1536-token prompt arriving at iteration 5 among 3 residents:
           max and p99 step wall after it), and speculative decoding (8
           short prompts x 64 tokens: gamma 0/2/4/6 with the n-gram
           drafter and the ModelDrafter at 2; the best gamma stored in a
           temporary autotune cache and read back by speculative=-1);
10. train_grad_f32  one forward and backward of a 2-layer cut of the model
           at full width in f32, through K1-K3 on the card and through the
           plain versions on the CPU, every gradient compared;
11. train_bf16  the GPT training slice: 24 layers, AMP-O2, AdamW with
           float32 masters, B=4 x S=2048 batches as bench.py makes them, 2
           warm-up and 8 timed steps; every step runs K1's tensor-core
           body, K2 and K3 once per layer;
12. train_grad_f32_bert  as 10, for a 2-layer cut of BERT-base with a
           padded batch, through K4a and K4b;
13. train_bert_bf16  the BERT slice: 12 layers, AMP-O2 AdamW, B=64 x
           S=512 in bench.py's dense, padded and packed forms; every step
           runs K4a-direct's tensor-core body and K4b once per layer, and no
           K1-K3 and no float32 K4a body;
14. train_grad_f32_resnet  one forward and backward of ResNet-50 in f32 at
           B=2 x 224² with both conv flags on, through K5-K8 on the card and
           their plain versions on the CPU: loss, logits, BN buffers and
           every gradient compared;
15. train_resnet_bf16  the ResNet slice: ResNet-50 (NHWC, space-to-depth
           stem) cast to bf16, Momentum(0.1, 0.9) with f32 masters, B=256 x
           224², 2 warm-up and 8 timed steps; every step launches K5/K6/K7/K8
           72/36/32/16 times and no K1-K4;
16. train_grad_f32_ernie  as 10, for a 2-layer cut of ERNIE-base at B=1 x
           S=2048 with a padding mask, through the float32 bodies of the
           streamed forward, dq and dk/dv (compared in the 2-norm);
17. train_ernie_bf16  the ERNIE slice: 12 layers, bf16 with AdamW f32
           masters, in three forms: bench.py's config 5 (PipelineLayer and
           make_pipeline_train_step, 512 positions, B=64 x 512, 2+8 steps;
           K4a and K4b 12 a step), the same at 2048 positions (B=16 x 2048,
           2+8 steps; the tensor-core bodies of the streamed forward, dq and
           dk/dv 12 a step, their float32 bodies none), and
           ErnieForPretraining at B=16 x 2048 with bench.py's padding mask
           (2+4 steps); every earlier path launches no streamed kernel;
18. cross_attention  nn.MultiHeadAttention(768, 12), 512 queries over 2048
           keys, B=16, bf16: the tensor-core bodies of the streamed forward,
           dq and dk/dv-direct (K3's body), once each, held against the
           plain dense path; then the same in float32 (cross_attention_f32:
           the three float32 bodies of flash_packed_stream.cu);
19. hapi_lenet  BASELINE config 1: LeNet(10) f32 under Model.fit (Adam,
           CrossEntropyLoss, Accuracy) on the synthetic MNIST at MNIST's
           sizes, B=64, one epoch (938 steps), with no workers, two thread
           workers, and two shared-memory process workers with device
           prefetch; the first 20 losses against the CPU, the three runs'
           batches equal, evaluate, save and load, predict; step p50/p99,
           images/s and, over a profiled 200-step window, the device's busy
           share (cuDNN's convolutions: no TPU kernel on this path);
20. lbfgs  LBFGS on the card against the CPU, 20 steps of a quadratic and
           of LeNet's fc head;
21. flash_varlen_lse  ops.flash_attn_unpadded on a causal packing of
           documents of 64-2048 tokens (8192 in all) and a non-causal cross
           packing, and flash_attention_with_lse with two key halves merged
           by logaddexp and a loss on o and lse, at GPT-3 1.3B's attention
           width (16 heads of 128, bf16): K1's tensor-core body, K2's and
           K3's once a call, the outputs equal to direct K1-K3 calls and
           held against the plain versions, timed beside the documents
           padded to rows of 2048.

22. train_transformer_bf16  nn.Transformer at Transformer-base width
           (Vaswani et al. 2017, Table 3: 6 + 6 layers, d_model 512, 8 heads
           of 64, FFN 2048, dropout 0.1, label smoothing 0.1, a shared
           vocabulary of 37,000) in the smoke's seq2seq wrapper (tied
           embedding, sinusoid positions, a -1e9 key-padding bias), B=64 x
           256 a side, AMP-O2, AdamW(beta2=0.98, epsilon=1e-9) on
           NoamDecay(512, 4000), 2+8 steps at dropout 0.1 and at 0: the
           encoder self-attention and cross-attention on K4a-direct and
           K4b-fused (12 each a step), the decoder's causal self-attention
           dense (6 a step); step p50/p99, target tokens/s, MFU (its FLOP
           formula in the line), peak memory;
23. train_grad_f32_transformer  a 2 + 2-layer cut at full width, B=2,
           source 256, target 128, f32 on the card against the CPU's plain
           versions (every gradient); K4a-direct and K4b-fused at these
           attention shapes against their plain versions in bf16 and f32;
24. decode_transformer  Transformer-base in f32: greedy decoding of 64
           tokens with TransformerDecoder.gen_cache token-exact against
           full causal recompute (serve_f32's near-tie rule), beam 4 over
           64 steps through dynamic_decode with caches and without (the
           same tokens and scores); bf16's agreement printed; ms a decode
           step with and without caches;
25. train_recompute_k4_bf16  GPT-3 Medium (24 layers, d_model 1024, 16
           heads of 64), B=4 x 2048, AMP-O2, 2+4 steps without recompute,
           under the default policy and under None: K4's streamed forward
           24 launches a step under the policy (its (o, lse) kept), 48
           under None; step p50 and peak memory of each; a 2-layer f32 cut
           bit-equal with and without the policy.

The ResNet family, sampling and the resilience tier (in this order, each
after the phase named):
- kernel_conv, part "wide" (after 7)  K5-K8 against their plain versions
  at Wide ResNet-50-2's 19 new shapes (B=256: 3x3 at 128 @ 56², 256 @
  28², 512 @ 14², 1024 @ 7² and the three stride-2 entries, the 1x1s into
  and out of those widths), then K7's forward and K8 at the seven 3x3
  shapes timed beside cuDNN and their bounds;
- pool_ties  max_pool2d_with_index on the card equal to the CPU's bit for
  bit on ReLU outputs (ties), an all-zero block and padding past half the
  kernel;
- serve_resilience_f32 (after serve_tiers f32) and serve_resilience_bf16
  (after generate_sample_bf16)  bench.py's overload trace on GPT-3 1.3B:
  the pool hog and 16 requests (every third with a deadline already
  past) through 16 blocks of 8 tokens, max_batch 4, max_waiting 8, the
  degrade-mode shed policy, validate_capacity=False and a SpillError at
  the first spill, the journal armed: every request ends as a CPU dry run
  of the same lengths ends it, the hog and one spill victim FAILED and
  nobody else, no block leaks, the survivors held to generate (serve_f32's
  near-tie rule; in bf16 a near tie is a top-2 gap under 8 units in the
  last place of the top logit), the journal exactly-once; SLO attainment
  and the shed rate from the returned records, K1 once a layer a prefill;
  every earlier serving phase holds engine.diagnostics empty;
- generate_sample_bf16 (after serve_tiers bf16)  GPT-3 1.3B, B=4, a
  128-token prompt, 64 new tokens, top_k 50, top_p 0.9, temperature 0.8:
  seeded, greedy unchanged, every sampled token inside its step's top-k
  and top-p set; ms a token;
- train_grad_f32_resnext, train_resnext_bf16, train_wide_resnet_bf16
  (after 15)  ResNeXt-50 32x4d and Wide ResNet-50-2: each as 14, then as
  15 for 2 warm-up and 3 timed steps (step p50, images/s, MFU from the
  model's own FLOPs, peak memory, losses), K5/K6/K7/K8 launches a step as
  each structure implies them (Wide 72/36/32/16; ResNeXt 72/36/0/0, its
  grouped 3x3s on cuDNN).
- telemetry (part serve after serve_resilience_bf16; part train and the
  overhead line inside 11, on its trained step)  the runtime telemetry
  layer on GPT-3 1.3B: serve_bf16's trace under FLAGS_telemetry=off and
  metrics on one engine (equal tokens and launches, compile_report within
  budget with O001 silent, one request-timeline record per request with
  ttft <= total, the serving.* counters equal to the endings, nothing
  reported under off); the overhead A/Bs of the decode step, of the
  train step (3 windows of 3 steps from one saved state, bit-equal
  losses and parameters, K1-K3 24 a step in both arms) and of bench.py's
  MLP (B = 64, hidden 2048, 30 steps x 5 windows; again with the flight
  recorder off and on), one object for both arms, interleaved window by
  window, each arm's figure the least over windows; the step record's
  hbm_peak_gb against torch.cuda.max_memory_allocated(); one step under
  trace in a torch.profiler capture, K1-K3's kernels launched inside the
  step and step/device ranges; a flight recorder replayed with the
  trainer's indices. The overhead line carries the card's name and power
  limit; every kernel entry gains telemetry_launches (off and metrics).
- tune_conv (after 15)  ``tune_conv_shapes()`` in bf16 at
  RESNET50_TOP3_SHAPES into a temporary autotune cache: each K5 tile and
  K7 band candidate held to the plain version and timed, the winner
  beside the plan's own choice, the plans' cache reads (a valid entry
  taken, an invalid one ignored); then ResNet-50 with and without the
  cache in turns (2+3 steps each), step times and losses (held within
  TUNE_LOSS_REL); the kernels line's mm and c3 entries gain ``tuned``.
- surface (before the kernels line)  a Paddle-style script through the
  port's root on the card (creation, math, manipulation, linalg, search,
  stat, grad, jacobian, no_grad, a PyLayer at [4, 2048, 2048]) against the
  same calls on the CPU path, the draws' determinism and moments, then
  FLAGS_use_pallas_kernels on (K1 and K4 launch) and off (no attention
  launch, one dense route each, outputs within 2e-2 of the kernels') at
  GPT-3 1.3B's attention shape.
- train_resnet_folder_bf16 (after 15)  ResNet-50 at config 2 fed from
  files: 1,280 ``.npy`` images of ImageNet's shapes in 100 class folders
  through ``vision.datasets.DatasetFolder``, RandomResizedCrop(224),
  RandomHorizontalFlip, ToTensor and Normalize (HWC), the DataLoader's
  process workers and prefetch_to_device; two epochs (2+8 steps) with no
  profiler, then a third under torch.profiler: K5-K8 72/36/32/16 a step
  and no other kernel, every batch's first image and the whole first
  batch equal to the host's rebuild from the worker's seeds, no two
  batches with one flip pattern; step p50/p99, images/s over the steps'
  events and over the window's wall beside train_resnet_bf16's (both
  ways), each step's wait on the loader (epoch 2's first apart), peak
  memory, the third epoch's device busy share, each host stage alone (the
  ring crossed by a forked producer); the kernels line's entries gain
  folder_launches.
- vision_ops, audio_text (after train_mobilenet_v3_bf16)  every function
  of vision/ops.py (nms, RoI ops forward and backward, DCNv2, the YOLOv3
  heads, matrix NMS, RPN proposals, FPN levels, SSD priors, box coding)
  and the fft, signal, audio-feature and text ops on the card against the
  CPU path at their users' sizes, each timed.

Attention-prob dropout and K9 (after phase 7, in this order):
- kernel / kernel_packed / kernel_packed_stream, part "dropout": the nine
  attention kernels at rate 0.1 against their plain versions with the same
  seed (f32 and bf16, with and without masks), the mask itself (an
  identity V, K or dO makes the dropped scores show as exact zeros, equal
  to dropout_keep_dense's), each phase's timed shape (compared, then timed
  beside rate 0 in turns) and a batch whose flat score index passes 2^32
  (compared on its last batch);
- kernel_fused_matmul_bn  K9 (fused_matmul_bn_act on K5's bodies in conv.cu:
  conv1x1_tc_kernel in 16 bits, conv1x1_kernel in float32): its path
  (the entry at ResNet-50's bottleneck 1x1s, M = 256·56·56, 256->64 and
  64->256, bf16, forward and backward), then the
  three prologues, stats on and off, f32 and bf16, M = 600 and ragged M,
  forward against the plain version and the torch-op backward against the
  CPU, and the full shapes timed against the bound, the plain version and
  cuBLAS;
- kernel_float16  every kernel in float16, as JAX's kernels take it: a
  probe holds mma_dot to the card's float16 sums bit for bit at head dims
  64 and 128, then K1, K2/K3 (tensor cores at 64 and 128, CUDA cores at
  256), K4a-direct and K4b-fused, the streamed forward, dq, dk/dv and
  dk/dv-direct, K5-K8 and K9 against their plain versions in the cases
  their phases run in bf16 (a subset: masks, causal, rows with no key,
  GQA, dropout, ragged tiles, stride 2, the prologue), within bf16's
  tolerance scaled to float16's ulp, each checked to run the bodies of its
  dtype; then each float16 tensor-core body timed at its model's shape
  beside bf16;
and the dropout paths, each after its model's rate-0 path:
- train_gpt_dropout_bf16  GPT-3 1.3B at hidden and attention dropout 0.1,
  B=4 x 2048, AMP-O2, 2+4 steps (K1/K2/K3 24 a step); then GPT's
  training options:
  - train_recompute_bf16  GPT-3 1.3B as bench.py's config 4 trains it,
    ``recompute=True`` under the default policy (dots_and_flash_saveable,
    2+8 steps: K1 saved, 24 launches a step) and under
    ``recompute_policy=None`` (2+3 steps: K1 48 a step), K2/K3 24 each,
    beside train_bf16's step times and peak memory (the policy's peak no
    higher, full recompute's at least 8 GB lower);
  - train_grad_recompute  a 2-layer cut at B=2 x 320 with and without
    recompute, in f32 and in bf16 at dropout 0.1 under one key stream:
    the bit-equal share and the largest difference, within
    train_grad_f32's tolerance;
  - gpt_sdpa_route  B=1 x 2048 in bf16 with ``use_flash_attention``
    True and False on the same weights: bit-equal, K1-K3 24 each;
  - train_o1_f16  float32 parameters under AMP O1 in float16, the
    imperative loop (``auto_cast``, ``GradScaler``, ``AdamW(parameters=
    model.parameters())``), B=4 x 2048, 2+6 steps: K1-K3's float16
    tensor-core bodies 24 a step each, the scale a step;
- train_grad_f32_bert_dropout  as 12 at attention dropout 0.1;
- train_bert_dropout_bf16  BERT-base as published (dropout 0.1), the dense
  form, 2+4 steps, twice from one seed (equal losses) and once at rate 0
  (other losses);
- train_ernie_dropout_bf16  ERNIE-base at 2048 positions, dropout 0.1,
  B=16 x 2048, 2+4 steps (the tensor-core streamed forward, dq, dk/dv 12 a
  step).

``--profile`` adds phases that serve the bf16
trace again and run a few GPT, BERT, ResNet and long-form ERNIE train
steps under torch.profiler, and print the device busy share and the
kernels that take the device's time. Each phase prints one
JSON line. Then come the ``{"kernels": [...]}`` line,
the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script exits
non-zero without that last line, as it does when CUDA is absent or the
package is not beside it.
"""

from __future__ import annotations

import copy
import importlib.metadata
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_peaks(name: str) -> dict:
    """Dense peak rates from NVIDIA's data sheet of the card nvidia-smi
    names: bf16 (and float16, the same) tensor-core FLOP/s, f32 (CUDA-core)
    FLOP/s, memory B/s."""
    peaks = sheet_peaks(name)
    peaks["f16"] = peaks["bf16"]
    return peaks


def sheet_peaks(name: str) -> dict:
    n = name.lower()
    if "h200" in n:
        return {"bf16": 989e12, "f32": 67e12, "bytes": 4.8e12,
                "sheet": "H200 SXM"}
    if "h100" in n and "pcie" in n:
        return {"bf16": 756e12, "f32": 51e12, "bytes": 2.0e12,
                "sheet": "H100 PCIe"}
    if "h100" in n and "nvl" in n:
        return {"bf16": 835e12, "f32": 60e12, "bytes": 3.9e12,
                "sheet": "H100 NVL"}
    return {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12,
            "sheet": "H100 SXM"}


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the inputs need: bottom-right causal keeps key j
    for query i when j <= i + sk - sq."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


def median_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 1) -> float:
    """The median over ``iters`` samples of one call's time between CUDA
    events. With ``reps`` > 1 a sample is ``reps`` calls back to back after
    one untimed call, over ``reps``: the queue stays ahead of the card, so a
    kernel shorter than its wrapper's host time is timed on the card, not
    on the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if reps > 1:
            fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


#: the kernels' types by the names the rows use: float32 on the CUDA cores,
#: bf16 and float16 on the tensor cores (one template over the two)
DTYPE_NAMES = {"f32": "float32", "bf16": "bfloat16", "f16": "float16"}
#: the relative tolerance of a 16-bit comparison, as bf16's scaled to
#: float16's ulp (2^-7 against 2^-10 of the value: an eighth)
REL16 = {"bf16": 1e-2, "f16": 1e-2 / 8}


def torch_dtype(torch, dt):
    return getattr(torch, DTYPE_NAMES[dt])


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


# -- phase 1 -----------------------------------------------------------------

def phase_env(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    check(nvcc.returncode == 0, f"nvcc --version failed: {nvcc.stderr}")
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = None
    try:      # decode_jpeg and image files other than .npy need PIL
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1], "triton": triton,
          "pil": pil, "cpu_count": os.cpu_count(),
          "cutlass_headers": os.path.isdir("/usr/local/cutlass/include"),
          "nvidia_smi": smi_line,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})
    return smi_line


def card_clocks():
    """The card's SM and memory clocks (MHz), temperature (C), power draw
    (W) and active clock-event (throttle) reasons as nvidia-smi reads them
    now, for beside a training phase's step times; None where it cannot
    read them."""
    fields = ("clocks.sm", "clocks.mem", "temperature.gpu", "power.draw",
              "clocks_throttle_reasons.active")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + ",".join(fields),
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        return None
    return dict(zip(fields, (x.strip() for x in
                             smi.stdout.strip().splitlines()[0].split(","))))


# -- phase 2 -----------------------------------------------------------------

def phase_build(build):
    t0 = time.perf_counter()
    paths = build.build_all()
    for stem in paths:
        build.library(stem)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for stem in paths:
        log = build.BUILD_DIR / f"{stem}.log"
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[stem] = [ln.replace("ptxas info    : ", "").strip()
                       for ln in lines if "Compiling entry" in ln
                       or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds,
          "libraries": {k: os.path.relpath(v, REPO)
                        for k, v in paths.items()},
          "ptxas": ptxas})


# -- phase 3 -----------------------------------------------------------------

# name, B, Sq, Sk, H, HK, D, causal, dtype
K1_CASES = [
    ("1p3b_s512", 1, 512, 512, 16, 16, 128, True, "bf16"),
    ("1p3b_s1024", 1, 1024, 1024, 16, 16, 128, True, "bf16"),
    ("1p3b_s2048", 1, 2048, 2048, 16, 16, 128, True, "bf16"),
    ("ragged_s300", 1, 300, 300, 16, 16, 128, True, "bf16"),
    ("gqa_hk4", 1, 1024, 1024, 16, 4, 128, True, "bf16"),
    ("sq128_sk384", 1, 128, 384, 16, 16, 128, True, "bf16"),
    ("masked_rows_sq300_sk200", 1, 300, 200, 16, 16, 128, True, "bf16"),
    ("noncausal_s1024", 1, 1024, 1024, 16, 16, 128, False, "bf16"),
    ("f32_s1024", 1, 1024, 1024, 16, 16, 128, True, "f32"),
    ("f32_ragged_s200_noncausal", 2, 200, 200, 16, 16, 128, False, "f32"),
    ("d64_s512", 2, 512, 512, 16, 16, 64, True, "bf16"),
    ("d64_f32_s333", 1, 333, 333, 8, 2, 64, True, "f32"),
    ("d256_s512", 1, 512, 512, 8, 8, 256, True, "bf16"),
    ("d256_f32_s256_noncausal", 1, 256, 256, 4, 4, 256, False, "f32"),
]


def k1_inputs(torch, b, sq, sk, h, hk, d, dtype, seed):
    """q, k, v as the serving path hands them over: strided views of one
    fused projection when sq == sk (q/k/v from qkv, or q plus kv under
    GQA), separate tensors otherwise."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)

    if sq == sk and h == hk:
        qkv = randn(b, sq, 3, h, d)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if sq == sk:
        kv = randn(b, sk, 2, hk, d)
        return randn(b, sq, h, d), kv[:, :, 0], kv[:, :, 1]
    return randn(b, sq, h, d), randn(b, sk, hk, d), randn(b, sk, hk, d)


# name, B, Sq, Sk, H, HK, D, causal, masks, dropout: the tensor-core body's
# forms beside K1_CASES (bf16)
K1_TC_CASES = [
    ("d64_sq384_sk640_causal_segments_bias", 1, 384, 640, 8, 8, 64, True,
     "seg_bias", False),
    ("d256_gqa_s333_key_bias", 1, 333, 333, 8, 2, 256, False, "bias",
     False),
    ("d128_sq256_sk640_segment_ids_k", 2, 256, 640, 8, 8, 128, False, "segk",
     False),
    ("d128_sq640_sk384_causal_masked_rows_bias", 1, 640, 384, 8, 4, 128,
     True, "bias", False),
    ("d128_causal_segments_bias_dropout", 2, 256, 256, 8, 8, 128, True,
     "seg_bias", True),
    ("d256_gqa_s300_causal_dropout", 1, 300, 300, 8, 4, 256, True, None,
     True),
]


def k1_body(dt):
    """The K1 body a dtype runs: bf16 and float16 the tensor-core body,
    float32 the CUDA-core body."""
    return "flash_fwd_tc" if dt != "f32" else "flash_fwd"


def phase_kernel(torch, hfa, peaks):
    """Every case through the kernel and the plain version on the same
    inputs (bf16 on the tensor-core body, float32 on the CUDA-core body,
    each counted apart), the tensor-core body's masked and dropout forms at
    D = 64, 128 and 256, then the kernel, the plain version and the
    library call timed at the main path's largest prefill shape (bf16, B=1)
    and at the GPT training shape (B=4), and the float32 body at B=1."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops._hopper.build import library
    # the plain version rounds at the body's stages only if they agree
    stage = library("flash_fwd_tc").paddle_flash_fwd_tc_stage
    stages = {d: stage(d) for d in hfa.TC_KEY_TILE}
    check(stages == hfa.TC_KEY_TILE,
          f"flash_fwd_tc.cu's stages {stages} are not TC_KEY_TILE "
          f"{hfa.TC_KEY_TILE}")
    results = []
    worst = {"flash_fwd": 0.0, "flash_fwd_tc": 0.0}
    for i, (name, b, sq, sk, h, hk, d, causal, dt) in enumerate(K1_CASES):
        dtype = torch_dtype(torch, dt)
        q, k, v = k1_inputs(torch, b, sq, sk, h, hk, d, dtype, seed=100 + i)
        before = {n: getattr(hfa, n).launches for n in worst}
        o, lse = hfa.flash_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ran = [n for n in worst if getattr(hfa, n).launches != before[n]]
        check(ran == [k1_body(dt)], f"{name}: {dt} ran the bodies {ran}")
        ro, rlse = hfa.flash_fwd_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(o.shape == (b, sq, h, d) and o.dtype == dtype,
              f"{name}: o {tuple(o.shape)} {o.dtype}")
        check(lse.shape == (b, h, sq) and lse.dtype == torch.float32,
              f"{name}: lse {tuple(lse.shape)} {lse.dtype}")
        check(bool(torch.isfinite(o).all()) and
              bool(torch.isfinite(lse).all()), f"{name}: non-finite output")
        err_o = (o.float() - ro.float()).abs()
        err_lse = (lse - rlse).abs()
        if dt != "f32":
            # 16-bit rounding of o, and sums over up to 2048 keys in another
            # order than the plain version's
            r = 2 * REL16[dt]
            ok = bool((err_o <= r + r * ro.float().abs()).all()) and \
                float(err_lse.max()) <= REL16[dt]
        else:
            # f32 sums over up to 1024 keys in another order
            ok = float(err_o.max()) <= 1e-4 and float(err_lse.max()) <= 1e-4
        row = {"case": name, "shape": [b, sq, sk, h, hk, d], "causal": causal,
               "dtype": dt, "body": k1_body(dt),
               "max_abs_err_o": float(err_o.max()),
               "max_abs_err_lse": float(err_lse.max()), "ok": ok}
        results.append(row)
        check(ok, f"K1 disagrees with its plain version: {row}")
        worst[k1_body(dt)] = max(worst[k1_body(dt)], float(err_o.max()))
    for i, (name, b, sq, sk, h, hk, d, causal, mask, drop) in enumerate(
            K1_TC_CASES):
        g = torch.Generator(device="cuda")
        g.manual_seed(150 + i)
        q, k, v = k1_inputs(torch, b, sq, sk, h, hk, d, torch.bfloat16,
                            seed=160 + i)
        masks = mask_inputs(torch, g, b, sq, sk, torch.bfloat16, mask)
        dr = hfa.AttnDropout(DROP_RATE, 170 + i) if drop else None
        before = hfa.flash_fwd_tc.launches
        o, lse = hfa.flash_fwd(q, k, v, causal, dropout=dr, masks=masks)
        torch.cuda.synchronize()
        check(hfa.flash_fwd_tc.launches == before + 1,
              f"{name}: the tensor-core body did not run")
        ro, rlse = hfa.flash_fwd_reference(q, k, v, causal, dropout=dr,
                                           masks=masks)
        row = {"case": name, "shape": [b, sq, sk, h, hk, d], "causal": causal,
               "dtype": "bf16", "body": "flash_fwd_tc",
               "masks": [t is not None for t in masks],
               "dropout": None if dr is None else list(dr)}
        worst["flash_fwd_tc"] = max(worst["flash_fwd_tc"], compare(
            torch, "o", o, ro, "bf16", row, nonzero=True))
        err_lse = (lse - rlse).abs()
        row["max_abs_err_lse"] = float(err_lse.max())
        row["ok"] &= bool((err_lse <= 1e-2 * (1 + rlse.abs())).all())
        # rows with no valid key: o = 0, exactly
        empty = rlse <= hfa.NEG_INF / 2                    # [B, H, Sq]
        row["empty_rows"] = int(empty.sum())
        row["ok"] &= bool((o.transpose(1, 2)[empty] == 0).all())
        check(row["ok"], f"K1's tensor-core body disagrees: {row}")
        results.append(row)

    timing = {}
    s, h, d = 2048, 16, 128
    for kname, b, dt in (("flash_fwd_tc", 1, "bf16"), ("flash_fwd_tc", 4,
                                                       "bf16"),
                         ("flash_fwd", 1, "f32")):
        dtype = torch_dtype(torch, dt)
        q, k, v = k1_inputs(torch, b, s, s, h, h, d, dtype, seed=7)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # the kernels and SDPA 10 calls a sample: K1 at B=1 is shorter than
        # its wrapper's host time
        kernel_ms = median_ms(lambda: hfa.flash_fwd(q, k, v, causal=True),
                              reps=10)
        plain_ms = median_ms(
            lambda: hfa.flash_fwd_reference(q, k, v, causal=True),
            iters=20 if b == 1 else 5, warmup=3 if b == 1 else 1)
        library_ms = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=10)
        flops = 4 * b * h * d * attention_pairs(s, s, True)
        esize = 2 if dt != "f32" else 4
        nbytes = 4 * b * s * h * d * esize + b * h * s * 4  # q, k, v, o, lse
        # float32 products run on the CUDA cores: the f32 peak bounds them
        t_ops = flops / peaks[dt] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        row = {"shape": [b, s, s, h, h, d], "dtype": dt, "causal": True,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "peak_sheet": peaks["sheet"],
               "tflops": flops / kernel_ms / 1e9}
        if kname in timing:
            timing[kname]["train_shape"] = row
        else:
            timing[kname] = row
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernels": ["flash_fwd_tc", "flash_fwd"],
          "tc_key_stages": stages, "cases": results, "timing": timing})
    return worst, timing


# -- phase 4 -----------------------------------------------------------------

#: K2's and K3's bodies, each counted apart: bf16 at head dims 64 and 128 on
#: the tensor cores (flash_bwd_tc.cu, ``_tc``), float32 and bf16 at 256 on
#: the CUDA cores (flash_bwd.cu)
K2_K3_KERNELS = ("flash_bwd_dq", "flash_bwd_dq_tc", "flash_bwd_dkv",
                 "flash_bwd_dkv_tc")


def k2_k3_bodies(dt, d):
    """The K2 and K3 bodies that dtype ``dt`` at head dim ``d`` reaches."""
    tc = "_tc" if dt != "f32" and d in (64, 128) else ""
    return "flash_bwd_dq" + tc, "flash_bwd_dkv" + tc


def compare_bwd(torch, hfa, case, q, k, v, do, causal, worst, dropout=None,
                masks=(None, None, None)):
    """K1 then K2/K3 (``flash_bwd``) against the plain version on the same
    inputs and the same o and lse (with ``dropout``, the same rate and
    seed; with ``masks``, the same segment ids and key bias): one row of
    errors, beside the largest and the median |value| of each plain
    gradient. The K2/K3 bodies of the case's dtype and head dim must run,
    once each, and no other; the tensor-core bodies are held to the plain
    version with ``mma_sums`` (dp summed as mma.sync sums it). Rows with no
    valid key must give dq = 0 exactly. Raises on a mismatch."""
    name, b, sq, sk, h, hk, d, dt = case
    dq_body, dkv_body = k2_k3_bodies(dt, d)
    o, lse = hfa.flash_fwd(q, k, v, causal=causal, dropout=dropout,
                           masks=masks)
    before = {n: getattr(hfa, n).launches for n in K2_K3_KERNELS}
    grads = hfa.flash_bwd(q, k, v, o, lse, do, causal=causal,
                          dropout=dropout, masks=masks)
    torch.cuda.synchronize()
    ran = {n: getattr(hfa, n).launches - before[n] for n in K2_K3_KERNELS}
    check(ran == {n: int(n in (dq_body, dkv_body)) for n in K2_K3_KERNELS},
          f"{name}: {dt} at head dim {d} ran the K2/K3 bodies {ran}")
    tc = dq_body.endswith("_tc")
    refs = hfa.flash_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                   dropout=dropout, masks=masks,
                                   mma_sums=tc)
    torch.cuda.synchronize()
    row = {"case": name, "shape": [b, sq, sk, h, hk, d], "causal": causal,
           "dtype": dt, "bodies": [dq_body, dkv_body],
           "masks": [t is not None for t in masks],
           "dropout": None if dropout is None else list(dropout)}
    ok = True
    for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{name}: {gname} {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite {gname}")
        ref32 = ref.float()
        err = (got.float() - ref32).abs()
        # with masks, over the elements whose plain value is not 0, as
        # compare(nonzero=True) takes them: the keys no query reaches have
        # dk = dv = 0 on both sides and can be most of the tensor
        live = ref32 != 0 if any(t is not None for t in masks) else \
            torch.ones_like(ref32, dtype=torch.bool)
        med = float(ref32.abs()[live].median()) if bool(live.any()) else 0.0
        if dt != "f32":
            # both round ds and p to bf16 at the same points, from f32
            # sums taken in another order, so a rounding may flip; then
            # the bf16 output (one ulp is at most 2^-7 relative). The
            # worst error seen on an H100 is 3.9e-3, and typical values
            # are 0.03-0.05, so 1e-2 absolute still catches a dropped tile
            # (float16: an eighth, its ulp's share)
            r = REL16[dt]
            ok &= bool((err <= r + r * ref32.abs()).all())
        else:
            # f32 sums over up to 2048 terms in another order
            ok &= bool((err <= 1e-4 + 1e-4 * ref32.abs()).all())
        # a flipped rounding is rare: the mean error seen on an H100 is
        # below 1e-5 of the median |value|; a dropped or doubled tile moves
        # the mean far past 1e-3 of it
        mean = float(err[live].mean()) if bool(live.any()) else 0.0
        ok &= mean <= 1e-3 * med
        row[f"max_abs_err_{gname}"] = float(err.max())
        row[f"mean_abs_err_{gname}"] = mean
        row[f"equal_{gname}"] = float((err == 0).float().mean())
        row[f"max_abs_{gname}"] = float(ref32.abs().max())
        row[f"median_abs_{gname}"] = med
        kname = dq_body if gname == "dq" else dkv_body
        worst[kname] = max(worst.get(kname, 0.0), float(err.max()))
    # rows with no valid key (lse = NEG_INF + log 1e-30) get dq = 0
    empty = lse <= hfa.NEG_INF / 2                        # [B, H, Sq]
    row["empty_rows"] = int(empty.sum())
    ok &= bool((grads[0].transpose(1, 2)[empty] == 0).all())
    row["ok"] = ok
    check(ok, f"K2/K3 disagree with their plain version: {row}")
    return row, o, lse


def mma_probe(torch, dq_fn, mma_dot, d, n=8192, dtype=None):
    """The tensor-core dq body's f32 sums of 16-bit products (bf16, or
    ``dtype``) against the plain versions' model of them (``mma_dot``), bit
    for bit, at head dim ``d``, through the wrapper ``dq_fn`` (K2's or
    K4b-dq's, which reach the same body): with q = 0, K the identity (``d``
    keys), lse = 0 and scale 1 the body gives dq[i, j] = round(dp[i, j] -
    delta[i]), so with delta[i] the model's dp[i, i % d] it gives 0 exactly
    where the card summed as the model does (dO of mixed magnitudes, V
    columns scaled by 2^-6 .. 2^6). Returns the share of the n sums that
    agree."""
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    do = torch.randn(1, n, 1, d, generator=g, device="cuda").to(dtype)
    v = (torch.randn(1, d, 1, d, generator=g, device="cuda") * torch.exp2(
        torch.randint(-6, 7, (1, 1, 1, d), generator=g,
                      device="cuda").float())).to(dtype)
    q = torch.zeros(1, n, 1, d, device="cuda").to(dtype)
    k = torch.eye(d, device="cuda").reshape(1, d, 1, d).to(dtype)
    rows = torch.arange(n, device="cuda")
    j = rows % d
    delta = mma_dot(do, v)[0, 0, rows, j].reshape(1, 1, n).contiguous()
    dq = dq_fn(q, k, v, do, torch.zeros(1, 1, n, device="cuda"), delta,
               False, 1.0)
    return float((dq[0, rows, 0, j] == 0).float().mean())


# name, B, Sq, Sk, H, HK, D, causal, masks, dropout: the tensor-core K2/K3
# bodies' edges beside K1_CASES (bf16): Sq and Sk past whole stages, causal
# with Sq > Sk (rows with no key) and Sq < Sk, GQA at both head dims, pad
# sentinels, segments with the key bias, dropout, and a batch of several
# waves of blocks
K2_K3_TC_CASES = [
    ("d128_sq600_sk328_causal_masked_rows", 1, 600, 328, 8, 8, 128, True,
     None, False),
    ("d128_sq328_sk600_causal_key_bias", 1, 328, 600, 8, 8, 128, True,
     "bias", False),
    ("d64_sq600_sk328_causal_dropout", 1, 600, 328, 8, 4, 64, True, None,
     True),
    ("d64_gqa_h8_hk2_s512_causal", 2, 512, 512, 8, 2, 64, True, None,
     False),
    ("d128_gqa_h16_hk4_s1024_key_bias", 1, 1024, 1024, 16, 4, 128, False,
     "bias", False),
    ("d128_s384_segments_pad_sentinel", 2, 384, 384, 8, 8, 128, False,
     "seg_pad", False),
    ("d128_gqa_sq384_sk640_causal_segments_bias_dropout", 1, 384, 640, 8, 2,
     128, True, "seg_bias", True),
    ("d64_b16_s1024_h16_waves", 16, 1024, 1024, 16, 16, 64, False, None,
     False),
]


def phase_kernel_bwd(torch, hfa, peaks):
    """K2 and K3 against their plain version in every K1 case (the same
    o and lse from K1, the same do) and in the tensor-core bodies' edge
    cases, then K1, K2 and K3 against the plain versions on the training
    shape's inputs, and K2, K3, the plain version and the library's
    attention backward timed on them (bf16: the tensor-core bodies); the
    CUDA-core bodies timed on the same shape in float32, and in bf16 at head
    dim 256. First the tensor-core bodies' stages and ``mma_dot`` against
    the card's sums at D = 64 and 128."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops._hopper.build import library
    stage = library("flash_bwd_tc").paddle_flash_bwd_tc_stage
    stages = {d: {"dq": stage(d, 0), "dkv": stage(d, 1)}
              for d in hfa.TC_BWD_HEAD_DIMS}
    probe = {d: mma_probe(torch, hfa.flash_bwd_dq_tc, hfa.mma_dot, d)
             for d in hfa.TC_BWD_HEAD_DIMS}
    check(all(x == 1.0 for x in probe.values()),
          f"mma_dot models {probe} of K2's tensor-core sums, not all")
    results = []
    worst = {n: 0.0 for n in K2_K3_KERNELS}
    for i, (name, b, sq, sk, h, hk, d, causal, dt) in enumerate(K1_CASES):
        dtype = torch_dtype(torch, dt)
        q, k, v = k1_inputs(torch, b, sq, sk, h, hk, d, dtype, seed=300 + i)
        g = torch.Generator(device="cuda")
        g.manual_seed(400 + i)
        do = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
        row, _, _ = compare_bwd(torch, hfa, (name, b, sq, sk, h, hk, d, dt),
                                q, k, v, do, causal, worst)
        results.append(row)
    for i, (name, b, sq, sk, h, hk, d, causal, mask, drop) in enumerate(
            K2_K3_TC_CASES):
        g = torch.Generator(device="cuda")
        g.manual_seed(450 + i)
        q, k, v = k1_inputs(torch, b, sq, sk, h, hk, d, torch.bfloat16,
                            seed=460 + i)
        masks = mask_inputs(torch, g, b, sq, sk, torch.bfloat16, mask)
        do = torch.randn(b, sq, h, d, generator=g, device="cuda").to(
            torch.bfloat16)
        dr = hfa.AttnDropout(DROP_RATE, 470 + i) if drop else None
        row, _, _ = compare_bwd(torch, hfa, (name, b, sq, sk, h, hk, d,
                                             "bf16"), q, k, v, do, causal,
                                worst, dr, masks)
        results.append(row)
        del q, k, v, do
    torch.cuda.empty_cache()

    b, s, h, d = 4, 2048, 16, 128
    q, k, v = k1_inputs(torch, b, s, s, h, h, d, torch.bfloat16, seed=8)
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    do = torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
    row, o, lse = compare_bwd(torch, hfa, ("train_b4_s2048", b, s, s, h, h,
                                           d, "bf16"), q, k, v, do, True,
                              worst)
    # K1 at the training shape, with its own tolerance (phase_kernel)
    ro, rlse = hfa.flash_fwd_reference(q, k, v, causal=True)
    err_o = (o.float() - ro.float()).abs()
    row["k1_max_abs_err_o"] = float(err_o.max())
    row["k1_max_abs_err_lse"] = float((lse - rlse).abs().max())
    check(bool((err_o <= 2e-2 + 2e-2 * ro.float().abs()).all()) and
          row["k1_max_abs_err_lse"] <= 1e-2,
          f"K1 disagrees with its plain version at the training shape: {row}")
    worst["flash_fwd_tc"] = row["k1_max_abs_err_o"]
    del ro, rlse, err_o
    results.append(row)
    scale = 1.0 / math.sqrt(d)
    pairs = attention_pairs(s, s, True)
    timing = {}

    def timed(names, dt, q, k, v, do, o, lse, heads, hd, iters=20):
        """K2 and K3 (the bodies ``names`` of ``dt``), the plain version
        and SDPA's backward at [B, S, heads, hd], causal."""
        delta = hfa._delta(o, do)
        dq_ms = median_ms(lambda: hfa.flash_bwd_dq(
            q, k, v, do, lse, delta, True, 1.0 / math.sqrt(hd)), iters=iters)
        dkv_ms = median_ms(lambda: hfa.flash_bwd_dkv(
            q, k, v, do, lse, delta, True, 1.0 / math.sqrt(hd)), iters=iters)
        plain_ms = median_ms(lambda: hfa.flash_bwd_reference(
            q, k, v, o, lse, do, causal=True), iters=5, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        library_ms = median_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), iters=iters)
        esize = 2 if dt == "bf16" else 4
        elems = b * s * heads * hd               # one [B, S, H, D] tensor
        stats = 2 * b * heads * s * 4            # lse and delta, f32
        out = {}
        for kname, ms, flops, outs in (
                (names[0], dq_ms, 6 * hd * pairs * b * heads, 1),
                (names[1], dkv_ms, 8 * hd * pairs * b * heads, 2)):
            nbytes = (4 + outs) * elems * esize + stats  # q, k, v, do; outs
            # float32 products run on the CUDA cores: the f32 peak bounds
            # them
            t_ops = flops / peaks[dt] * 1e3
            t_bytes = nbytes / peaks["bytes"] * 1e3
            out[kname] = {
                "shape": [b, s, s, heads, heads, hd], "dtype": dt,
                "causal": True, "kernel_ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "flops": flops, "bytes": nbytes,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "peak_sheet": peaks["sheet"], "tflops": flops / ms / 1e9}
        return out

    timing.update(timed(("flash_bwd_dq_tc", "flash_bwd_dkv_tc"), "bf16", q,
                        k, v, do, o, lse, h, d))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    # the CUDA-core bodies: the training shape in float32, and bf16 at head
    # dim 256 (8 heads, the same bytes a token)
    q, k, v = k1_inputs(torch, b, s, s, h, h, d, torch.float32, seed=8)
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    do = torch.randn(b, s, h, d, generator=g, device="cuda")
    row32, o, lse = compare_bwd(torch, hfa, ("train_b4_s2048_f32", b, s, s,
                                             h, h, d, "f32"), q, k, v, do,
                                True, worst)
    results.append(row32)
    timing.update(timed(("flash_bwd_dq", "flash_bwd_dkv"), "f32", q, k, v,
                        do, o, lse, h, d, iters=10))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    h2, d2 = 8, 256
    q, k, v = k1_inputs(torch, b, s, s, h2, h2, d2, torch.bfloat16, seed=18)
    g = torch.Generator(device="cuda")
    g.manual_seed(19)
    do = torch.randn(b, s, h2, d2, generator=g, device="cuda").to(
        torch.bfloat16)
    o, lse = hfa.flash_fwd(q, k, v, causal=True)
    d256 = timed(("flash_bwd_dq", "flash_bwd_dkv"), "bf16", q, k, v, do, o,
                 lse, h2, d2, iters=10)
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        timing[kname]["d256_bf16"] = d256[kname]
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    emit({"phase": "kernel_bwd", "kernels": list(K2_K3_KERNELS),
          "tc_stages": stages, "mma_dot_probe_equal": probe,
          "cases": results, "timing": timing,
          "library": "scaled_dot_product_attention backward (dq, dk, dv in "
                     "one call; the time of the pair)"})
    return worst, timing


# -- kernel_masked: K1-K3 with segment ids and the key bias ------------------

def masked_sets(torch, np, b, s):
    """The three mask sets of the masked phase, at B x S: a key-padding
    mask (lengths from seed 0 in [S/2, S]) as bool segments (seg_q = 1,
    seg_k = valid, as SDPA turns a bool key mask into them) and as the f32
    key bias ((1 - valid) * -1e9), and causal packed documents (64 to 2048
    tokens from seed 0, filling each row; the last one cut at S)."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(s // 2, s + 1, b)
    valid = np.arange(s)[None, :] < lengths[:, None]
    ones = torch.ones(b, s, dtype=torch.int32, device="cuda")
    seg_k = torch.as_tensor(valid.astype(np.int32), device="cuda")
    bias = torch.as_tensor((1.0 - valid) * -1e9, dtype=torch.float32,
                           device="cuda")
    docs = np.zeros((b, s), np.int32)
    for row in range(b):
        pos, doc = 0, 0
        while pos < s:
            n = int(rng.integers(64, 2049))
            docs[row, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    docs = torch.as_tensor(docs, device="cuda")
    return {"key_padding_segments": (False, (ones, seg_k, None)),
            "key_padding_bias": (False, (None, None, bias)),
            "causal_packed_segments": (True, (docs, docs, None))}, \
        [int(x) for x in lengths]


def phase_kernel_masked(torch, np, hfa, hfp, MultiHeadAttention, PF):
    """K1, K2 and K3 with segment ids and the key bias at GPT-3 1.3B's
    attention shape (B=4, S=2048, H=16, D=128, bf16), with 16 and with 4 KV
    heads, in the three mask sets of :func:`masked_sets`: each kernel
    against its plain version (o within 1e-2 + 1e-2·|ref|, lse within 1e-2
    of 1 + |lse|, the gradients as the unmasked phase holds them); then the
    three kernels timed with and without the masks; then
    ``nn.MultiHeadAttention(2048, 16)`` in bf16 with a key-padding mask,
    forward and backward, which must launch K1, K2 and K3 once each (the
    tensor-core bodies of all three) and agree with the dense path through
    the same projections."""
    b, s, h, d = 4, 2048, 16, 128
    sets, lengths = masked_sets(torch, np, b, s)
    worst = {"flash_fwd_tc": 0.0, "flash_bwd_dq_tc": 0.0,
             "flash_bwd_dkv_tc": 0.0}
    rows = []
    for hk in (16, 4):
        q, k, v = k1_inputs(torch, b, s, s, h, hk, d, torch.bfloat16,
                            seed=1300 + hk)
        g = torch.Generator(device="cuda")
        g.manual_seed(1400 + hk)
        do = torch.randn(b, s, h, d, generator=g, device="cuda").to(
            torch.bfloat16)
        for mname, (causal, masks) in sets.items():
            row, o, lse = compare_bwd(
                torch, hfa, (f"{mname}_hk{hk}", b, s, s, h, hk, d, "bf16"),
                q, k, v, do, causal, worst, masks=masks)
            ro, rlse = hfa.flash_fwd_reference(q, k, v, causal, masks=masks)
            worst["flash_fwd_tc"] = max(worst["flash_fwd_tc"], compare(
                torch, "o", o, ro, "bf16", row))
            err_lse = (lse - rlse).abs()
            row["max_abs_err_lse"] = float(err_lse.max())
            row["ok"] &= bool((err_lse <= 1e-2 * (1 + rlse.abs())).all())
            row["masks"] = [t is not None for t in masks]
            check(row["ok"], f"K1-K3 with masks disagree: {row}")
            rows.append(row)
            del o, lse, ro, rlse, err_lse
        del q, k, v, do
        torch.cuda.empty_cache()

    # timed with and without the masks, on one set of inputs (HK = 16)
    q, k, v = k1_inputs(torch, b, s, s, h, h, d, torch.bfloat16, seed=1316)
    g = torch.Generator(device="cuda")
    g.manual_seed(1416)
    do = torch.randn(b, s, h, d, generator=g, device="cuda").to(
        torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    none = (None, None, None)
    timing = {}
    for mname, (causal, masks) in (("none", (False, none)),
                                   *sets.items(),
                                   ("causal_none", (True, none))):
        o, lse = hfa.flash_fwd(q, k, v, causal, masks=masks)
        delta = hfa._delta(o, do)
        timing[mname] = {
            "causal": causal,
            "flash_fwd_tc": median_ms(lambda: hfa.flash_fwd(
                q, k, v, causal, masks=masks), iters=5),
            "flash_bwd_dq_tc": median_ms(lambda: hfa.flash_bwd_dq_tc(
                q, k, v, do, lse, delta, causal, scale, masks=masks),
                iters=5),
            "flash_bwd_dkv_tc": median_ms(lambda: hfa.flash_bwd_dkv_tc(
                q, k, v, do, lse, delta, causal, scale, masks=masks),
                iters=5)}
        del o, lse, delta
    del q, k, v, do
    torch.cuda.empty_cache()

    # the layer with a key-padding mask: the SDPA route to K1-K3
    e = h * d
    torch.manual_seed(0)
    mha = MultiHeadAttention(e, h, device="cuda").to(torch.bfloat16)
    g = torch.Generator(device="cuda")
    g.manual_seed(22)
    x = torch.randn(b, s, e, generator=g, device="cuda").to(torch.bfloat16)
    dout = torch.randn(b, s, e, generator=g, device="cuda").to(torch.bfloat16)
    valid = sets["key_padding_segments"][1][1].bool()
    att = valid[:, None, None, :]
    x.requires_grad_()
    params = list(mha.parameters())
    names = ["x"] + [n for n, _ in mha.named_parameters()]
    zero_counts(hfa, hfp)
    out = mha(x, x, x, attn_mask=att)
    got = dict(zip(names, torch.autograd.grad(out, [x] + params, dout)))
    torch.cuda.synchronize()
    launches = k4_counts(hfa, hfp)
    check(launches == {**{n: 0 for n in ATTENTION_KERNELS},
                       "flash_fwd_tc": 1, "flash_bwd_dq_tc": 1,
                       "flash_bwd_dkv_tc": 1},
          f"kernel_masked: the layer's launches {launches}")
    qp = mha.q_proj(x).view(b, s, h, d)
    kp = mha.k_proj(x).view(b, s, h, d)
    vp = mha.v_proj(x).view(b, s, h, d)
    attn = PF._dense_attention(qp, kp, vp, att, False, scale)
    ref_out = mha.out_proj(attn.reshape(b, s, e))
    ref = dict(zip(names, torch.autograd.grad(ref_out, [x] + params, dout)))
    errs = {"out": float((out - ref_out).detach().float().norm() /
                         ref_out.detach().float().norm())}
    for name, gt in got.items():
        check(bool(torch.isfinite(gt).all()), f"kernel_masked: {name}")
        r = ref["k_proj.weight" if name == "k_proj.bias" else name].float()
        errs[name] = float((gt.float() - ref[name].float()).norm() /
                           max(float(r.norm()), 1e-30))
    layer = {"layer": f"MultiHeadAttention({e}, {h})", "dtype": "bf16",
             "batch": [b, s], "key_lengths": lengths,
             "rel_err_2norm": errs, "launches": launches}
    emit({"phase": "kernel_masked", "shape": [b, s, s, h, d],
          "kv_heads": [16, 4], "key_lengths": lengths, "cases": rows,
          "timing_ms": timing, "layer": layer,
          "kernels": ["flash_fwd_tc", "flash_bwd_dq_tc",
                      "flash_bwd_dkv_tc"]})
    # bf16 on both sides; the kernels round p against a running max, the
    # dense path rounds the normalised softmax
    check(max(errs.values()) <= 2e-2, f"kernel_masked layer disagrees: "
          f"{layer}")
    del mha, x, dout, out, got, qp, kp, vp, attn, ref_out, ref
    torch.cuda.empty_cache()
    return worst, timing, launches


# -- dense_route: ops.flash_attention on inputs the kernels do not take -----

def phase_dense_route(torch, hfa, hfp, tfa):
    """``ops.flash_attention`` on the card at head dim 32 (``gpt_tiny``'s)
    in float32 and float16 (4 query heads on 2 KV heads, 2 x 256), causal
    and not, with and without dropout in training: each call takes the
    dense route (counted once), launches no attention kernel, gives exactly
    the dense function's result on the same inputs
    (``reference_attention``, with dropout the kernels' mask as its
    ``keep``) and agrees with the same call on the CPU (float32 within 1e-4
    + 1e-4·|ref|, as compare_bwd holds f32 sums: both sides are library
    products, and cuBLAS was seen 3.3e-5 from the CPU in one run of five;
    float16 within two ulps, 2^-9 + 2^-9·|ref|). Float16 at head dims 64
    and 128 goes the kernel route, as JAX sends it to its kernels: K1's
    tensor-core body runs once (4 query heads on 2 KV heads do not take
    K4), with no dense route, and equals its plain version on the card
    within K1's bf16 tolerance scaled to float16 (2.5e-3 + 2.5e-3·|ref|).
    Returns the calls made."""
    rows = []

    def inputs(d, dtype):
        g = torch.Generator(device="cuda")
        g.manual_seed(d)
        q = torch.randn(2, 256, 4, d, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(2, 256, 2, d, generator=g, device="cuda").to(
            dtype) for _ in range(2))
        return q, k, v

    for name, d, dtype in (("d32_f32", 32, torch.float32),
                           ("d32_f16", 32, torch.float16)):
        q, k, v = inputs(d, dtype)
        for causal in (False, True):
            for rate in (0.0, DROP_RATE):
                zero_counts(hfa, hfp)
                tfa.flash_attention.dense_routes = 0
                kw = dict(dropout=rate, causal=causal, training=True,
                          fixed_seed_offset=5)
                out = tfa.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                launches = k4_counts(hfa, hfp)
                n_dense = tfa.flash_attention.dense_routes
                keep = hfa.dropout_keep_dense(8, 256, 256, 5, rate,
                                              q.device).reshape(
                    2, 4, 256, 256) if rate else None
                want = tfa.reference_attention(q, k, v, causal, keep=keep)
                cpu = tfa.flash_attention(q.cpu(), k.cpu(), v.cpu(),
                                          **kw).float()
                err = (out.float().cpu() - cpu).abs()
                tol = 1e-4 if dtype == torch.float32 else 2.0 ** -9
                row = {"case": name, "causal": causal, "dropout": rate,
                       "dtype": str(dtype).replace("torch.", ""),
                       "dense_routes": n_dense,
                       "kernel_launches": sum(launches.values()),
                       "equal_to_dense": bool(torch.equal(out, want)),
                       "max_abs_err_vs_cpu": float(err.max())}
                rows.append(row)
                check(tfa.attention_route(q) == "dense" and
                      row["dense_routes"] == 1 and
                      row["kernel_launches"] == 0 and
                      row["equal_to_dense"] and
                      bool((err <= tol + tol * cpu.abs()).all()),
                      f"dense route: {row}")
    for d in (64, 128):
        q, k, v = inputs(d, torch.float16)
        zero_counts(hfa, hfp)
        tfa.flash_attention.dense_routes = 0
        out = tfa.flash_attention(q, k, v, causal=True, training=False)
        torch.cuda.synchronize()
        launches = k4_counts(hfa, hfp)
        ref, _ = hfa.flash_fwd_reference(q, k, v, causal=True)
        err = (out.float() - ref.float()).abs()
        tol = 2 * REL16["f16"]
        row = {"case": f"d{d}_f16", "route": tfa.attention_route(q),
               "dense_routes": tfa.flash_attention.dense_routes,
               "launches": {n: c for n, c in launches.items() if c},
               "dtype": str(out.dtype).replace("torch.", ""),
               "max_abs_err": float(err.max()),
               "equal": float((err == 0).float().mean())}
        rows.append(row)
        check(row["route"] == "kernels" and row["dense_routes"] == 0 and
              row["launches"] == {"flash_fwd_tc": 1} and
              out.dtype == torch.float16 and
              bool(torch.isfinite(out).all()) and
              bool((err <= tol + tol * ref.float().abs()).all()),
              f"float16 at a kernel head dim: {row}")
    emit({"phase": "dense_route", "cases": rows})
    return len(rows)


# -- phase 5 -----------------------------------------------------------------

#: K4a-direct's and K4b-fused's bodies, each counted apart: bf16 and
#: float16 on the tensor cores (``_tc``), float32 on the CUDA cores
K4_DIRECT_KERNELS = ("flash_packed_fwd", "flash_packed_fwd_tc",
                     "flash_packed_bwd", "flash_packed_bwd_tc")

# name, B, Sq, Sk, H, causal, dtype, mask
K4_CASES = [
    ("s128_nomask", 2, 128, 128, 12, False, "bf16", None),
    ("s384_key_bias", 2, 384, 384, 12, False, "bf16", "bias"),
    ("s512_segments", 2, 512, 512, 12, False, "bf16", "seg"),
    ("s512_causal", 2, 512, 512, 12, True, "bf16", None),
    ("sq256_sk512_segment_ids_k", 2, 256, 512, 12, False, "bf16", "segk"),
    ("ragged_s200_key_bias", 2, 200, 200, 12, False, "bf16", "bias"),
    ("sq384_sk256_causal_masked_rows", 1, 384, 256, 12, True, "bf16", None),
    ("f32_s512_key_bias", 2, 512, 512, 12, False, "f32", "bias"),
    ("f32_s384_causal_segments_bias", 1, 384, 384, 12, True, "f32",
     "seg_bias"),
    ("f32_sq128_sk384_segment_ids_k", 2, 128, 384, 12, False, "f32", "segk"),
]


def padding_bias(torch, att, dtype):
    """BERT's additive mask as the model makes it under AMP (``(1 - mask)
    * -1e9`` in the activation dtype), as the f32 key bias it becomes at
    the kernel entry."""
    return ((1.0 - att.to(dtype)) * -1e9).float().contiguous()


def k4_inputs(torch, b, sq, sk, h, dtype, mask, seed):
    """q, k, v (strided views of one fused tensor when Sq == Sk), do and
    the masks ``(seg_q, seg_k, bias)`` of a K4 case."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    if sq == sk:
        qkv = randn(b, sq, 3, h, 64)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = randn(b, sq, h, 64), randn(b, sk, h, 64), randn(b, sk, h, 64)
    do = randn(b, sq, h, 64)
    return q, k, v, do, mask_inputs(torch, g, b, sq, sk, dtype, mask)


def mask_inputs(torch, g, b, sq, sk, dtype, mask):
    """The masks ``(seg_q, seg_k, bias)`` of a case, drawn from ``g``:
    sorted segment ids 1..3 (``segk``: query ids 1..3 against key ids 0..2,
    so some queries find no key; ``seg_pad``: ids 1..3 with a random tail
    of each row padded by the sentinels -1 for queries and -2 for keys, so
    the pad queries find no key), and bench.py's padding bias on a random
    length per row plus noise."""
    seg_q = seg_k = bias = None

    def ids(n, lo, hi):
        return torch.sort(torch.randint(lo, hi, (b, n), generator=g,
                                        device="cuda"), dim=1).values.to(
            torch.int32).contiguous()

    if mask in ("seg", "seg_bias"):
        seg_q = ids(sq, 1, 4)
        seg_k = seg_q if sq == sk else ids(sk, 1, 4)
    if mask == "segk":    # query ids 1..3 against key ids 0..2
        seg_q, seg_k = ids(sq, 1, 4), ids(sk, 0, 3)
    if mask == "seg_pad":
        seg_q, seg_k = ids(sq, 1, 4), ids(sk, 1, 4)
        for t, pad in ((seg_q, -1), (seg_k, -2)):
            n = t.shape[1]
            lengths = torch.randint(n // 2, n, (b,), generator=g,
                                    device="cuda")
            t[torch.arange(n, device="cuda")[None, :] >=
              lengths[:, None]] = pad
    if mask in ("bias", "seg_bias"):
        lengths = torch.randint(sk // 4, sk + 1, (b,), generator=g,
                                device="cuda")
        att = torch.arange(sk, device="cuda")[None, :] < lengths[:, None]
        bias = padding_bias(torch, att, dtype) + torch.randn(
            b, sk, generator=g, device="cuda")
    return seg_q, seg_k, bias


def compare(torch, name, got, ref, dt, row, nonzero=False):
    """One output against its plain version, logged in ``row``: bf16 within
    1e-2 + 1e-2·|ref| per element and a mean error at most 1e-3 of the
    median |ref|; f32 within 1e-5 + 1e-5·|ref|. With ``nonzero`` the mean
    error and the median are taken over the elements whose plain value is
    not 0 (the keys of padding that no query reaches have dk = dv = 0 on
    both sides, and can be more than half of them). Returns the max
    error."""
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} against "
          f"{tuple(ref.shape)} {ref.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    ref32 = ref.float()
    err = (got.float() - ref32).abs()
    live = ref32 != 0 if nonzero else \
        torch.ones_like(ref32, dtype=torch.bool)
    med = float(ref32.abs()[live].median()) if bool(live.any()) else 0.0
    if dt != "f32":
        # both round p and ds to bf16 at the same points, from f32 sums
        # taken in another order, so a rounding may flip (one ulp is 2^-7
        # of the value; float16's 2^-10, an eighth of the tolerance); a
        # dropped or doubled tile moves the mean error far past 1e-3 of
        # the median |value|
        r = REL16[dt]
        ok = bool((err <= r + r * ref32.abs()).all()) and \
            float(err[live].mean() if bool(live.any()) else 0.0) \
            <= 1e-3 * med
    else:
        # f32 sums over at most 512 keys or queries in another order
        ok = bool((err <= 1e-5 + 1e-5 * ref32.abs()).all())
    row.update({f"max_abs_err_{name}": float(err.max()),
                f"mean_abs_err_{name}": float(err.mean()),
                f"equal_{name}": float((err == 0).float().mean()),
                f"max_abs_{name}": float(ref32.abs().max()),
                f"median_abs_{name}": med})
    row["ok"] = row.get("ok", True) and ok
    return float(err.max())


def k4_bodies(dt):
    """The K4a-direct and K4b-fused bodies a dtype runs: bf16 and float16
    the tensor-core bodies, float32 the CUDA-core bodies."""
    tc = "_tc" if dt != "f32" else ""
    return "flash_packed_fwd" + tc, "flash_packed_bwd" + tc


def k4_case(torch, hfp, case, q, k, v, do, masks, worst, dropout=None):
    """K4a then K4b against their plain versions on the same inputs (the
    backward from the kernel's own o and lse; with ``dropout``, the same
    rate and seed; the tensor-core K4b against the plain version that sums
    dp as mma.sync does); one row of errors. The bodies of the case's
    dtype must run, once each, and no other."""
    name, b, sq, sk, h, causal, dt = case
    fwd, bwd = k4_bodies(dt)
    before = {n: getattr(hfp, n).launches for n in K4_DIRECT_KERNELS}
    o, lse = hfp.flash_packed_fwd(q, k, v, causal, None, masks, dropout)
    dq, dk, dv = hfp.flash_packed_bwd(q, k, v, o, lse, do, causal, None,
                                      masks, dropout)
    torch.cuda.synchronize()
    ran = {n: getattr(hfp, n).launches - before[n] for n in K4_DIRECT_KERNELS}
    check(ran == {n: int(n in (fwd, bwd)) for n in K4_DIRECT_KERNELS},
          f"{name}: {dt} ran the K4a/K4b bodies {ran}")
    ro, rlse = hfp.flash_packed_fwd_reference(q, k, v, causal, None, masks,
                                              dropout)
    rdq, rdk, rdv = hfp.flash_packed_bwd_reference(
        q, k, v, o, lse, do, causal, None, masks, dropout,
        mma_sums=dt != "f32")
    torch.cuda.synchronize()
    row = {"case": name, "shape": [b, sq, sk, h, 64], "causal": causal,
           "dtype": dt, "masks": [t is not None for t in masks],
           "bodies": [fwd, bwd],
           "dropout": None if dropout is None else list(dropout)}
    worst[fwd] = max(worst.get(fwd, 0.0), compare(torch, "o", o, ro, dt,
                                                  row))
    err_lse = (lse - rlse).abs()
    row["max_abs_err_lse"] = float(err_lse.max())
    row["ok"] &= bool((err_lse <= REL16.get(dt, 1e-5) *
                       (1 + rlse.abs())).all())
    # the mean error over the elements whose plain value is not 0: the keys
    # of padding that no query reaches have dk = dv = 0 on both sides and
    # can be most of them (the tensor-core body's f32 sums differ from the
    # plain version's in the last bits elsewhere, the CUDA-core body's did
    # not in these cases)
    for gname, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
        worst[bwd] = max(worst.get(bwd, 0.0), compare(
            torch, gname, got, ref, dt, row, nonzero=True))
    # rows with no valid key: o = 0 and dq = 0, exactly
    s = hfp._scores(q, k, causal, 1.0, masks)
    empty = (s <= hfp.NEG_INF / 2).all(dim=-1).transpose(1, 2)  # [B, Sq, H]
    row["empty_rows"] = int(empty.sum())
    row["ok"] &= bool((o[empty] == 0).all()) and bool((dq[empty] == 0).all())
    check(row["ok"], f"K4 disagrees with its plain version: {row}")
    return row, o, lse


def bert_padded(np, batch, seq):
    """bench.py's padded batch (``:603-609``): lengths from
    ``default_rng(1)`` in [seq/4, seq], the attention mask they give."""
    lengths = np.random.default_rng(1).integers(seq // 4, seq + 1, batch)
    return lengths, np.arange(seq)[None, :] < lengths[:, None]


def phase_kernel_packed(torch, np, hfp, peaks):
    """K4a (flash_packed_fwd: its bf16 tensor-core body and its float32
    CUDA-core body) and K4b (flash_packed_bwd: its bf16 tensor-core body,
    one cluster a head, and its float32 CUDA-core body) against their plain
    versions in every case and at BERT-base's shape with bench.py's padded
    key bias, then the kernels, the plain versions and the library call
    timed at that shape (the float32 bodies on the same inputs in float32).
    The tensor-core K4b must give bit-equal gradients in two runs; it is
    timed beside two yardsticks on its inputs that no path runs: the
    CUDA-core body in bf16 (the body bf16 ran before) and the two-body
    route (the streamed dq and dk/dv, each recomputing s and p)."""
    import torch.nn.functional as F
    results = []
    worst = {name: 0.0 for name in K4_DIRECT_KERNELS}
    for i, (name, b, sq, sk, h, causal, dt, mask) in enumerate(K4_CASES):
        dtype = torch_dtype(torch, dt)
        q, k, v, do, masks = k4_inputs(torch, b, sq, sk, h, dtype, mask,
                                       seed=500 + i)
        row, _, _ = k4_case(torch, hfp, (name, b, sq, sk, h, causal, dt),
                            q, k, v, do, masks, worst)
        results.append(row)

    b, s, h, d = 64, 512, 12, 64
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    _, att = bert_padded(np, b, s)
    att = torch.as_tensor(att, device="cuda")
    masks = (None, None, padding_bias(torch, att, torch.bfloat16))
    row, o, lse = k4_case(torch, hfp, ("bert_b64_s512_padded", b, s, s, h,
                                       False, "bf16"), q, k, v, do, masks,
                          worst)
    results.append(row)
    scale = 1.0 / math.sqrt(d)
    delta = hfp._delta(o, do)
    fwd_ms = median_ms(lambda: hfp.flash_packed_fwd(q, k, v, False, None,
                                                    masks))
    bwd_ms = median_ms(lambda: hfp._launch_bwd(q, k, v, do, lse, delta,
                                               False, scale, masks))
    runs = [hfp._launch_bwd(q, k, v, do, lse, delta, False, scale, masks)
            for _ in range(2)]
    torch.cuda.synchronize()
    repeat_equal = all(bool(torch.equal(a, b)) for a, b in zip(*runs))
    check(repeat_equal, "K4b's tensor-core body: two runs differ")
    del runs
    cuda_core_ms = median_ms(lambda: hfp._launch_bwd(
        q, k, v, do, lse, delta, False, scale, masks, tc=False), iters=10)
    two_body_ms = median_ms(lambda: (
        hfp._launch_bwd_split("dq", q, k, v, do, lse, delta, False, scale,
                              masks),
        hfp._launch_bwd_split("dkv", q, k, v, do, lse, delta, False, scale,
                              masks)))
    plain_fwd_ms = median_ms(lambda: hfp.flash_packed_fwd_reference(
        q, k, v, False, None, masks), iters=5, warmup=1)
    plain_bwd_ms = median_ms(lambda: hfp.flash_packed_bwd_reference(
        q, k, v, o, lse, do, False, None, masks), iters=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    amask = masks[2][:, None, None, :].to(torch.bfloat16)
    lib_fwd_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=amask))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)
    dot = do.transpose(1, 2)
    lib_bwd_ms = median_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    del ot, qt, kt, vt
    # K4a-direct's and K4b-fused's float32 bodies, on the same inputs in
    # float32
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    row32, o32, lse32 = k4_case(torch, hfp, (
        "bert_b64_s512_padded_f32", b, s, s, h, False, "f32"), q32, k32, v32,
        do32, masks, worst)
    results.append(row32)
    delta32 = hfp._delta(o32, do32)
    fwd32_ms = median_ms(lambda: hfp.flash_packed_fwd(q32, k32, v32, False,
                                                      None, masks), iters=5)
    plain32_ms = median_ms(lambda: hfp.flash_packed_fwd_reference(
        q32, k32, v32, False, None, masks), iters=5, warmup=1)
    bwd32_ms = median_ms(lambda: hfp._launch_bwd(
        q32, k32, v32, do32, lse32, delta32, False, scale, masks), iters=5)
    plain_bwd32_ms = median_ms(lambda: hfp.flash_packed_bwd_reference(
        q32, k32, v32, o32, lse32, do32, False, None, masks), iters=5,
        warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q32, k32, v32))
    lib32_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=masks[2][:, None, None, :]))
    ot = F.scaled_dot_product_attention(qt, kt, vt,
                                        attn_mask=masks[2][:, None, None, :])
    dot = do32.transpose(1, 2)
    lib_bwd32_ms = median_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), iters=5)
    del q32, k32, v32, do32, o32, lse32, delta32, qt, kt, vt, ot, dot
    pairs = s * s
    elems = b * s * h * d                        # one [B, S, H, D] tensor
    stat = b * h * s * 4                         # one [B, H, S] f32 tensor
    timing = {}
    for kname, ms, plain, lib, flops, nbytes, dt in (
            ("flash_packed_fwd_tc", fwd_ms, plain_fwd_ms, lib_fwd_ms,
             4 * d * pairs * b * h, 4 * elems * 2 + stat, "bf16"),
            ("flash_packed_fwd", fwd32_ms, plain32_ms, lib32_ms,
             4 * d * pairs * b * h, 4 * elems * 4 + stat, "f32"),
            ("flash_packed_bwd_tc", bwd_ms, plain_bwd_ms, lib_bwd_ms,
             10 * d * pairs * b * h, 7 * elems * 2 + 2 * stat, "bf16"),
            ("flash_packed_bwd", bwd32_ms, plain_bwd32_ms, lib_bwd32_ms,
             10 * d * pairs * b * h, 7 * elems * 4 + 2 * stat, "f32")):
        # float32 products run on the CUDA cores: the f32 peak bounds them
        t_ops = flops / peaks[dt] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        timing[kname] = {
            "shape": [b, s, s, h, d], "dtype": dt, "causal": False,
            "mask": "key bias (bench.py's padded batch)",
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "peak_sheet": peaks["sheet"], "tflops": flops / ms / 1e9}
    timing["flash_packed_bwd_tc"].update({
        "cluster_blocks": hfp.fused_cluster_size(s),
        "repeat_bit_equal": repeat_equal,
        "cuda_core_bf16_ms": cuda_core_ms, "two_body_ms": two_body_ms,
        "yardsticks": "the CUDA-core body in bf16 (flash_packed.cu, the "
                      "body before) and the streamed dq + dk/dv tensor-core "
                      "bodies on the same inputs; neither runs on a path"})
    emit({"phase": "kernel_packed",
          "kernels": list(K4_DIRECT_KERNELS),
          "cases": results, "timing": timing,
          "library": "scaled_dot_product_attention in [B, H, S, D] with "
                     "attn_mask = bias[:, None, None, :] (bf16); backward "
                     "by autograd.grad after one forward"})
    return worst, timing


# -- phase 6 -----------------------------------------------------------------

# name, B, Sq, Sk, H, causal, dtype, mask
STREAM_CASES = [
    ("f32_s256_nomask", 2, 256, 256, 12, False, "f32", None),
    ("f32_s256_key_bias", 2, 256, 256, 12, False, "f32", "bias"),
    ("f32_s256_segments", 2, 256, 256, 12, False, "f32", "seg"),
    ("f32_sq128_sk256_segment_ids_k", 2, 128, 256, 12, False, "f32", "segk"),
    ("f32_s256_causal", 2, 256, 256, 12, True, "f32", None),
    ("f32_s128_causal_segments_bias", 2, 128, 128, 12, True, "f32",
     "seg_bias"),
    ("f32_sq128_sk384_causal", 2, 128, 384, 12, True, "f32", None),
    ("f32_s640_ragged_tiles", 1, 640, 640, 12, False, "f32", "bias"),
    ("f32_sq384_sk640_causal_segments_bias", 1, 384, 640, 12, True, "f32",
     "seg_bias"),
    ("f32_sq640_sk384_causal_masked_rows", 1, 640, 384, 12, True, "f32",
     None),
    ("bf16_s256_nomask", 2, 256, 256, 12, False, "bf16", None),
    ("bf16_s256_key_bias", 2, 256, 256, 12, False, "bf16", "bias"),
    ("bf16_s128_segments", 2, 128, 128, 12, False, "bf16", "seg"),
    ("bf16_s256_causal", 2, 256, 256, 12, True, "bf16", None),
    ("bf16_sq256_sk640_key_bias", 2, 256, 640, 12, False, "bf16", "bias"),
    ("bf16_sq512_sk1024_segment_ids_k", 2, 512, 1024, 12, False, "bf16",
     "segk"),
    ("bf16_s1024_causal", 1, 1024, 1024, 12, True, "bf16", None),
    # the tensor-core forward's forms: ragged Sk = 640, masked rows,
    # segments with the key bias
    ("bf16_s640_ragged_tiles", 1, 640, 640, 12, False, "bf16", "bias"),
    ("bf16_sq384_sk640_causal_segments_bias", 1, 384, 640, 12, True, "bf16",
     "seg_bias"),
    ("bf16_sq640_sk384_causal_masked_rows", 1, 640, 384, 12, True, "bf16",
     None),
    # the tensor-core dq and dk/dv's edges: Sq and Sk past whole 64-wide
    # stages, causal with Sq > Sk and Sq < Sk, pad sentinels (queries that
    # find no key), and a batch of several waves of blocks
    ("bf16_sq600_sk328_causal_masked_rows", 1, 600, 328, 12, True, "bf16",
     None),
    ("bf16_sq328_sk600_causal_key_bias", 1, 328, 600, 12, True, "bf16",
     "bias"),
    ("bf16_s384_segments_pad_sentinel", 2, 384, 384, 12, False, "bf16",
     "seg_pad"),
    ("bf16_b8_s1024_key_bias", 8, 1024, 1024, 12, False, "bf16", "bias"),
]

#: the streamed kernels, each body apart: the forward, dq, dk/dv and
#: dk/dv-direct in bf16 on the tensor cores (``_tc``; dk/dv-direct on
#: dk/dv's body) and in float32 on flash_packed_stream.cu
STREAM_KERNELS = ("flash_packed_fwd_stream", "flash_packed_fwd_stream_tc",
                  "flash_packed_bwd_dq", "flash_packed_bwd_dq_tc",
                  "flash_packed_bwd_dkv", "flash_packed_bwd_dkv_tc",
                  "flash_packed_bwd_dkv_direct",
                  "flash_packed_bwd_dkv_direct_tc")


def stream_bodies(dt):
    """The names (and counts) of the streamed forward, dq, dk/dv and
    dk/dv-direct bodies that ``dt`` reaches."""
    tc = "_tc" if dt != "f32" else ""
    return ("flash_packed_fwd_stream" + tc, "flash_packed_bwd_dq" + tc,
            "flash_packed_bwd_dkv" + tc, "flash_packed_bwd_dkv_direct" + tc)


def stream_case(torch, hfp, case, q, k, v, do, masks, worst, dropout=None):
    """The streamed forward, then dq, dk/dv and (Sq <= 512) dk/dv-direct
    from its o and lse, each against its plain version on the same inputs
    (with ``dropout``, the same rate and seed); one row of errors."""
    name, b, sq, sk, h, causal, dt = case
    drop = dict(dropout=dropout)
    fwd, dq_body, dkv_body, direct_body = stream_bodies(dt)
    before = {n: getattr(hfp, n).launches for n in STREAM_KERNELS}
    o, lse = hfp.flash_packed_fwd_stream(q, k, v, causal, None, masks,
                                         **drop)
    delta = hfp._delta(o, do)
    got = {"dq": hfp.flash_packed_bwd_dq(q, k, v, do, lse, delta, causal,
                                         None, masks, **drop)}
    got["dk"], got["dv"] = hfp.flash_packed_bwd_dkv(q, k, v, do, lse, delta,
                                                    causal, None, masks,
                                                    **drop)
    direct = sq <= hfp.MAX_SEQ_Q_DIRECT
    if direct:
        got["dk_direct"], got["dv_direct"] = hfp.flash_packed_bwd_dkv_direct(
            q, k, v, do, lse, delta, causal, None, masks, **drop)
    torch.cuda.synchronize()
    ran = {n: getattr(hfp, n).launches - before[n] for n in STREAM_KERNELS}
    check(ran == {n: int(n in (fwd, dq_body, dkv_body) or
                         (direct and n == direct_body))
                  for n in STREAM_KERNELS},
          f"{name}: the streamed bodies that ran: {ran}")
    ro, rlse = hfp.flash_packed_fwd_stream_reference(q, k, v, causal, None,
                                                     masks, **drop)
    # the tensor-core bodies' yardstick sums dp as they do (mma_dot); the
    # CUDA-core bodies' f32 FMA sums are a float32 einsum's
    tc = dict(mma_sums=dt != "f32")
    ref = {"dq": hfp.flash_packed_bwd_dq_reference(
        q, k, v, do, lse, delta, causal, None, masks, **drop, **tc)}
    ref["dk"], ref["dv"] = hfp.flash_packed_bwd_dkv_reference(
        q, k, v, do, lse, delta, causal, None, masks, **drop, **tc)
    if direct:
        ref["dk_direct"], ref["dv_direct"] = \
            hfp.flash_packed_bwd_dkv_direct_reference(
                q, k, v, do, lse, delta, causal, None, masks, **drop, **tc)
    torch.cuda.synchronize()
    row = {"case": name, "shape": [b, sq, sk, h, 64], "causal": causal,
           "dtype": dt, "masks": [t is not None for t in masks],
           "dropout": None if dropout is None else list(dropout)}
    worst[fwd] = max(worst.get(fwd, 0.0), compare(torch, "o", o, ro, dt,
                                                  row, nonzero=True))
    err_lse = (lse - rlse).abs()
    row["max_abs_err_lse"] = float(err_lse.max())
    row["ok"] &= bool((err_lse <= REL16.get(dt, 1e-5) *
                       (1 + rlse.abs())).all())
    for gname, kname in (("dq", dq_body), ("dk", dkv_body),
                         ("dv", dkv_body),
                         ("dk_direct", direct_body),
                         ("dv_direct", direct_body)):
        if gname in got:
            worst[kname] = max(worst.get(kname, 0.0), compare(
                torch, gname, got[gname], ref[gname], dt, row, nonzero=True))
    if direct:
        # dk/dv-direct sums as dk/dv does: in float32 the two bodies of
        # flash_packed_stream.cu, in 16 bits one tensor-core body
        row["ok"] &= bool(torch.equal(got["dk"], got["dk_direct"])) and \
            bool(torch.equal(got["dv"], got["dv_direct"]))
    # rows with no valid key: o = 0 and dq = 0, exactly
    s = hfp._scores(q, k, causal, 1.0, masks)
    empty = (s <= hfp.NEG_INF / 2).all(dim=-1).transpose(1, 2)  # [B, Sq, H]
    row["empty_rows"] = int(empty.sum())
    row["ok"] &= bool((o[empty] == 0).all()) and \
        bool((got["dq"][empty] == 0).all())
    check(row["ok"], f"streamed K4 disagrees with its plain version: {row}")
    return row, o, lse


def stream_bound(peaks, flops, nbytes, dt="bf16"):
    # float32 products run on the CUDA cores: the f32 peak bounds them
    t_ops = flops / peaks[dt] * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_kernel_packed_stream(torch, np, hfp, peaks):
    """The four streamed K4 kernels (the forward, dq and dk/dv in both of
    their bodies) against their plain versions in every case, then at
    ERNIE's long shape (B=16, S=2048, H=12, bf16, with and without bench.py's
    padding bias: forward, dq, dk/dv on the tensor cores) and at the
    cross-attention shape (Sq=512 over Sk=2048: dq and dk/dv-direct),
    where each is compared and timed beside its bound, its plain version and
    SDPA; the float32 forward, dq and dk/dv bodies at the long shape on the
    same inputs in float32. First the tensor-core backward's stage against
    the plain versions' tile, and ``mma_dot`` against the card's sums."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops._hopper import build
    stage_of = build.library("flash_bwd_tc").paddle_flash_bwd_tc_stage
    stage = {"dq": stage_of(64, 0), "dkv": stage_of(64, 1)}
    check(stage == {"dq": hfp.KERNEL_TILE, "dkv": hfp.KERNEL_TILE},
          f"the tensor-core backward's stages at D = 64 are {stage}; the "
          f"plain versions sum over tiles of {hfp.KERNEL_TILE}")
    mma_sums = mma_probe(torch, hfp.flash_packed_bwd_dq, hfp.mma_dot, 64)
    check(mma_sums == 1.0, f"mma_dot models {mma_sums:.5f} of the card's "
                           f"sums, not all")
    results = []
    worst = {name: 0.0 for name in STREAM_KERNELS}
    for i, (name, b, sq, sk, h, causal, dt, mask) in enumerate(STREAM_CASES):
        dtype = torch_dtype(torch, dt)
        q, k, v, do, masks = k4_inputs(torch, b, sq, sk, h, dtype, mask,
                                       seed=700 + i)
        row, _, _ = stream_case(torch, hfp, (name, b, sq, sk, h, causal, dt),
                                q, k, v, do, masks, worst)
        results.append(row)

    h, d = 12, 64
    timing = {}
    for shape_name, b, sq, sk, padded in (
            ("ernie_b16_s2048", 16, 2048, 2048, False),
            ("ernie_b16_s2048_padded", 16, 2048, 2048, True),
            ("cross_b16_sq512_sk2048", 16, 512, 2048, False)):
        g = torch.Generator(device="cuda")
        g.manual_seed(13)
        q, do = (torch.randn(b, sq, h, d, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, sk, h, d, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        bias = None
        if padded:
            _, att = bert_padded(np, b, sk)
            bias = padding_bias(torch, torch.as_tensor(att, device="cuda"),
                                torch.bfloat16)
        masks = (None, None, bias)
        row, o, lse = stream_case(torch, hfp, (shape_name, b, sq, sk, h,
                                               False, "bf16"),
                                  q, k, v, do, masks, worst)
        results.append(row)
        delta = hfp._delta(o, do)
        scale = 1.0 / math.sqrt(d)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        amask = None if bias is None else \
            bias[:, None, None, :].to(torch.bfloat16)
        lib_fwd_ms = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask))
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)
        dot = do.transpose(1, 2)
        lib_bwd_ms = median_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True))
        del ot
        pairs = b * h * sq * sk
        eq, ek = b * sq * h * d * 2, b * sk * h * d * 2   # bytes of a tensor
        stat = b * h * sq * 4
        mbytes = 0 if bias is None else b * sk * 4
        if sq == sk:
            kernels = [
                ("flash_packed_fwd_stream_tc",
                 lambda: hfp.flash_packed_fwd_stream(q, k, v, False, scale,
                                                     masks),
                 lambda: hfp.flash_packed_fwd_stream_reference(
                     q, k, v, False, scale, masks),
                 4 * d * pairs, 2 * eq + 2 * ek + stat + mbytes, lib_fwd_ms),
                ("flash_packed_bwd_dq_tc",
                 lambda: hfp.flash_packed_bwd_dq(q, k, v, do, lse, delta,
                                                 False, scale, masks),
                 lambda: hfp.flash_packed_bwd_dq_reference(
                     q, k, v, do, lse, delta, False, scale, masks),
                 6 * d * pairs, 3 * eq + 2 * ek + 2 * stat + mbytes,
                 lib_bwd_ms),
                ("flash_packed_bwd_dkv_tc",
                 lambda: hfp.flash_packed_bwd_dkv(q, k, v, do, lse, delta,
                                                  False, scale, masks),
                 lambda: hfp.flash_packed_bwd_dkv_reference(
                     q, k, v, do, lse, delta, False, scale, masks),
                 8 * d * pairs, 2 * eq + 4 * ek + 2 * stat + mbytes,
                 lib_bwd_ms)]
        else:
            kernels = [
                ("flash_packed_bwd_dq_tc",
                 lambda: hfp.flash_packed_bwd_dq(q, k, v, do, lse, delta,
                                                 False, scale, masks),
                 lambda: hfp.flash_packed_bwd_dq_reference(
                     q, k, v, do, lse, delta, False, scale, masks),
                 6 * d * pairs, 3 * eq + 2 * ek + 2 * stat + mbytes,
                 lib_bwd_ms),
                ("flash_packed_bwd_dkv_direct_tc",
                 lambda: hfp.flash_packed_bwd_dkv_direct(
                     q, k, v, do, lse, delta, False, scale, masks),
                 lambda: hfp.flash_packed_bwd_dkv_direct_reference(
                     q, k, v, do, lse, delta, False, scale, masks,
                     mma_sums=True),
                 8 * d * pairs, 2 * eq + 4 * ek + 2 * stat + mbytes,
                 lib_bwd_ms)]
        for kname, run, plain, flops, nbytes, lib in kernels:
            ms = median_ms(run)
            plain_ms = median_ms(plain, iters=5, warmup=1)
            bound, by = stream_bound(peaks, flops, nbytes)
            timing.setdefault(kname, {})[shape_name] = {
                "shape": [b, sq, sk, h, d], "dtype": "bf16", "causal": False,
                "mask": "key bias (bench.py's padding)" if padded else None,
                "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                "library": "SDPA forward" if "fwd_stream" in kname
                           else "SDPA backward (dq, dk, dv together)",
                "flops": flops, "bytes": nbytes, "bound_ms": bound,
                "bound_by": by, "peak_sheet": peaks["sheet"],
                "tflops": flops / ms / 1e9}
        if sq != sk:
            # dk/dv-direct's CUDA-core body in bf16, the route the parent
            # ran: a yardstick no path takes
            timing["flash_packed_bwd_dkv_direct_tc"][shape_name][
                "cuda_core_bf16_ms"] = median_ms(
                lambda: hfp._launch_bwd_split(
                    "dkv_direct", q, k, v, do, lse, delta, False, scale,
                    masks, tc=False), iters=5)
        del q, k, v, do, o, lse, delta, qt, kt, vt
        torch.cuda.empty_cache()
    # dk/dv-direct's float32 body at the cross-attention shape
    b, sq, sk = 16, 512, 2048
    g = torch.Generator(device="cuda")
    g.manual_seed(15)
    q, do = (torch.randn(b, sq, h, d, generator=g, device="cuda")
             for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=g, device="cuda")
            for _ in range(2))
    none = (None, None, None)
    row, o, lse = stream_case(torch, hfp, ("cross_b16_sq512_sk2048_f32", b,
                                           sq, sk, h, False, "f32"),
                              q, k, v, do, none, worst)
    results.append(row)
    args = (q, k, v, do, lse, hfp._delta(o, do), False, None, none)
    pairs = b * h * sq * sk
    nbytes = (2 * b * sq + 4 * b * sk) * h * d * 4 + 2 * b * h * sq * 4
    ms = median_ms(lambda: hfp.flash_packed_bwd_dkv_direct(*args), iters=5)
    bound, by = stream_bound(peaks, 8 * d * pairs, nbytes, "f32")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    timing["flash_packed_bwd_dkv_direct"] = {"cross_b16_sq512_sk2048": {
        "shape": [b, sq, sk, h, d], "dtype": "f32", "causal": False,
        "mask": None, "kernel_ms": ms,
        "plain_ms": median_ms(
            lambda: hfp.flash_packed_bwd_dkv_direct_reference(*args),
            iters=5, warmup=1),
        "library_ms": median_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), iters=5),
        "library": "SDPA backward, float32 (dq, dk, dv together)",
        "flops": 8 * d * pairs, "bytes": nbytes, "bound_ms": bound,
        "bound_by": by, "peak_sheet": peaks["sheet"],
        "tflops": 8 * d * pairs / ms / 1e9}}
    del q, k, v, do, o, lse, args, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    # the float32 forward, dq and dk/dv bodies at the long shape, on the
    # same inputs in f32
    b, s = 16, 2048
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    q, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
             for _ in range(2))
    k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
            for _ in range(2))
    none = (None, None, None)
    o, lse = hfp.flash_packed_fwd_stream(q, k, v, False, None, none)
    delta = hfp._delta(o, do)
    args = (q, k, v, do, lse, delta, False, None, none)
    got = {"o": o, "dq": hfp.flash_packed_bwd_dq(*args)}
    got["dk"], got["dv"] = hfp.flash_packed_bwd_dkv(*args)
    ref = {"o": hfp.flash_packed_fwd_stream_reference(q, k, v, False, None,
                                                      none)[0],
           "dq": hfp.flash_packed_bwd_dq_reference(*args)}
    ref["dk"], ref["dv"] = hfp.flash_packed_bwd_dkv_reference(*args)
    row32 = {"case": "ernie_b16_s2048_f32"}
    for gname, kname in (("o", "flash_packed_fwd_stream"),
                         ("dq", "flash_packed_bwd_dq"),
                         ("dk", "flash_packed_bwd_dkv"),
                         ("dv", "flash_packed_bwd_dkv")):
        worst[kname] = max(worst[kname], compare(
            torch, gname, got[gname], ref[gname], "f32", row32))
    check(row32["ok"], f"the streamed float32 bodies disagree: {row32}")
    results.append(row32)
    del got, ref
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt), iters=5)
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    lib_bwd_ms = median_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), iters=5)
    del ot
    pairs = b * h * s * s
    e4 = b * s * h * d * 4                 # bytes of one f32 [B, S, H, D]
    stat = b * h * s * 4
    for kname, run, plain, flops, nbytes, lib, what in (
            ("flash_packed_fwd_stream",
             lambda: hfp.flash_packed_fwd_stream(q, k, v, False, None, none),
             lambda: hfp.flash_packed_fwd_stream_reference(q, k, v, False,
                                                           None, none),
             4 * d * pairs, 4 * e4 + stat, lib_fwd_ms,
             "SDPA forward, float32"),
            ("flash_packed_bwd_dq", lambda: hfp.flash_packed_bwd_dq(*args),
             lambda: hfp.flash_packed_bwd_dq_reference(*args),
             6 * d * pairs, 5 * e4 + 2 * stat, lib_bwd_ms,
             "SDPA backward, float32 (dq, dk, dv together)"),
            ("flash_packed_bwd_dkv", lambda: hfp.flash_packed_bwd_dkv(*args),
             lambda: hfp.flash_packed_bwd_dkv_reference(*args),
             8 * d * pairs, 6 * e4 + 2 * stat, lib_bwd_ms,
             "SDPA backward, float32 (dq, dk, dv together)")):
        ms = median_ms(run, iters=5)
        bound, by = stream_bound(peaks, flops, nbytes, "f32")
        timing[kname] = {"ernie_b16_s2048": {
            "shape": [b, s, s, h, d], "dtype": "f32", "causal": False,
            "mask": None, "kernel_ms": ms,
            "plain_ms": median_ms(plain, iters=5, warmup=1),
            "library_ms": lib, "library": what, "flops": flops,
            "bytes": nbytes, "bound_ms": bound, "bound_by": by,
            "peak_sheet": peaks["sheet"], "tflops": flops / ms / 1e9}}
    del q, k, v, do, o, lse, delta, args, qt, kt, vt, dot
    torch.cuda.empty_cache()
    emit({"phase": "kernel_packed_stream", "kernels": list(STREAM_KERNELS),
          "mma_dot_probe_equal": mma_sums, "cases": results, "timing": timing,
          "library": "scaled_dot_product_attention in [B, H, S, D] bf16, "
                     "attn_mask = bias[:, None, None, :] where padded; "
                     "backward by autograd.grad after one forward"})
    # the line's timed shape: the unpadded long shape, and the
    # cross-attention shape for dk/dv-direct
    main = {kname: t.get("ernie_b16_s2048", t.get("cross_b16_sq512_sk2048"))
            for kname, t in timing.items()}
    return worst, main


# -- dropout in the attention kernels (phases 3-6) ---------------------------

DROP_RATE = 0.1    # BERT-base's and ERNIE-base's published attention dropout


def eye_like(torch, b, s, h, d):
    """``[B, S, H, D]`` f32 with every head the identity ``[S, D]``."""
    return torch.eye(s, d, device="cuda").reshape(1, s, 1, d).expand(
        b, s, h, d).contiguous()


def mask_probe(torch, hfa, hfp, family, seed):
    """The mask itself, in f32 at 64 queries over 64 keys (MHA): with V the
    identity the forward kernel's o·exp(lse) is exp(s)·keep; with K and dO
    the identity and delta = 0 the backward kernels give dq[q, j] = ds[q, j]
    = p·dp·keep·scale and dv[k, q] = (p·keep)[q, k]. Each kernel's zeros
    must be exactly the zeros of ``dropout_keep_dense`` (p > 0 and dp != 0
    at every score). The bf16 tensor-core bodies (K1's, which K4a-stream
    shares, K4a-direct's, K2's and K3's, and the streamed dq and dk/dv)
    take the same probe
    in bf16: their o is (p·keep rounded to bf16) / l, their dq ds rounded
    and their dv p·keep rounded, 0 exactly where keep is. Every probe must
    run the body it names and no other. Returns {kernel: dropped scores
    seen}."""
    b, s, h = 1, 64, 4
    d = 128 if family == "k1" else 64
    dr = hfa.AttnDropout(DROP_RATE, seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = 0.1 * torch.randn(b, s, h, d, generator=g, device="cuda")
    v = torch.randn(b, s, h, d, generator=g, device="cuda")
    eye = eye_like(torch, b, s, h, d)
    zeros = torch.zeros(b, h, s, device="cuda")
    keep0 = hfa.dropout_keep_dense(b * h, s, s, seed, DROP_RATE,
                                   "cuda").reshape(b, h, s, s) == 0
    scale = 1.0 / math.sqrt(d)
    qb, eyeb = q.bfloat16(), eye.bfloat16()
    if family == "k1":
        fwd = {"flash_fwd": lambda: hfa.flash_fwd(q, q, eye, dropout=dr),
               "flash_fwd_tc": lambda: hfa.flash_fwd(qb, qb, eyeb,
                                                     dropout=dr)}
        argsb = (qb, eyeb, v.bfloat16(), eyeb, zeros, zeros, False, scale,
                 dr)
        bwd = {"flash_bwd_dq": lambda: (hfa.flash_bwd_dq(
            q, eye, v, eye, zeros, zeros, False, scale, dr), None),
               "flash_bwd_dq_tc": lambda: (hfa.flash_bwd_dq(*argsb), None),
               "flash_bwd_dkv": lambda: (None, hfa.flash_bwd_dkv(
                   q, eye, v, eye, zeros, zeros, False, scale, dr)[1]),
               "flash_bwd_dkv_tc": lambda: (
                   None, hfa.flash_bwd_dkv(*argsb)[1])}
    elif family == "k4":
        fwd = {"flash_packed_fwd": lambda: hfp.flash_packed_fwd(
            q, q, eye, dropout=dr),
               "flash_packed_fwd_tc": lambda: hfp.flash_packed_fwd(
                   qb, qb, eyeb, dropout=dr)}
        bwd = {"flash_packed_bwd": lambda: hfp._launch_bwd(
            q, eye, v, eye, zeros, zeros, False, scale, (None,) * 3,
            dr)[0::2],
               "flash_packed_bwd_tc": lambda: hfp._launch_bwd(
            qb, eyeb, v.bfloat16(), eyeb, zeros, zeros, False, scale,
            (None,) * 3, dr)[0::2]}
    else:
        args = (q, eye, v, eye, zeros, zeros, False, scale, (None,) * 3, dr)
        argsb = (qb, eyeb, v.bfloat16(), eyeb, zeros, zeros, False, scale,
                 (None,) * 3, dr)
        fwd = {"flash_packed_fwd_stream": lambda: hfp.flash_packed_fwd_stream(
            q, q, eye, dropout=dr),
               "flash_packed_fwd_stream_tc": lambda: (
                   hfp.flash_packed_fwd_stream(qb, qb, eyeb, dropout=dr))}
        bwd = {"flash_packed_bwd_dq": lambda: (
                   hfp.flash_packed_bwd_dq(*args), None),
               "flash_packed_bwd_dq_tc": lambda: (
                   hfp.flash_packed_bwd_dq(*argsb), None),
               "flash_packed_bwd_dkv": lambda: (
                   None, hfp.flash_packed_bwd_dkv(*args)[1]),
               "flash_packed_bwd_dkv_tc": lambda: (
                   None, hfp.flash_packed_bwd_dkv(*argsb)[1]),
               "flash_packed_bwd_dkv_direct": lambda: (
                   None, hfp.flash_packed_bwd_dkv_direct(*args)[1]),
               "flash_packed_bwd_dkv_direct_tc": lambda: (
                   None, hfp.flash_packed_bwd_dkv_direct(*argsb)[1])}
    seen = {}
    for name, run in fwd.items():
        before = k4_counts(hfa, hfp)
        o, lse = run()
        ran = [n for n, c in k4_counts(hfa, hfp).items() if c != before[n]]
        check(ran == [name], f"{name}: the probe ran {ran}")
        ol = o.float().permute(0, 2, 1, 3)[..., :s] * \
            torch.exp(lse)[..., None]
        check(bool(torch.equal(ol == 0, keep0)),
              f"{name}: the dropped probabilities are not the mask's")
        seen[name] = int(keep0.sum())
    for name, run in bwd.items():
        before = k4_counts(hfa, hfp)
        dq, dv = run()
        ran = [n for n, c in k4_counts(hfa, hfp).items() if c != before[n]]
        check(ran == [name], f"{name}: the probe ran {ran}")
        if dq is not None:    # dq[q, j] = ds[q, j] for j < 64
            pat = dq.permute(0, 2, 1, 3)[..., :s] == 0
            check(bool(torch.equal(pat, keep0)),
                  f"{name}: dq's dropped scores are not the mask's")
        if dv is not None:    # dv[k, q] = (p keep)[q, k]
            pat = dv.permute(0, 2, 1, 3)[..., :s] == 0
            check(bool(torch.equal(pat.transpose(-1, -2), keep0)),
                  f"{name}: dv's dropped scores are not the mask's")
        seen[name] = int(keep0.sum())
    return seen


def rate_times(run_rate0, run_drop, reps=1):
    """A kernel timed at rate 0 and at the dropout rate, in turns (rate 0,
    dropout, dropout, rate 0), each the median of 20 samples of ``reps``
    launches."""
    a = median_ms(run_rate0, reps=reps)
    b = median_ms(run_drop, reps=reps)
    c = median_ms(run_drop, reps=reps)
    d = median_ms(run_rate0, reps=reps)
    return {"ms_rate0": min(a, d), "ms_dropout": min(b, c),
            "ms_rate0_runs": [a, d], "ms_dropout_runs": [b, c]}


def wrap_heads(b_last, h, sq, sk):
    """The flat index of the last batch's first score: past 2^32 when the
    batch is large enough for the uint32 index to wrap."""
    return (b_last * h * sq) * sk


# name, B, Sq, Sk, H, HK, D, causal, dtype
K1_DROP_CASES = [
    ("gqa_causal_s300", 1, 300, 300, 16, 4, 128, True, "bf16"),
    ("d64_noncausal_s256", 2, 256, 256, 8, 8, 64, False, "bf16"),
    ("f32_gqa_causal_s333", 1, 333, 333, 8, 2, 64, True, "f32"),
    ("f32_d128_sq128_sk384_causal", 1, 128, 384, 4, 4, 128, True, "f32"),
]


def dropout_k1_k3(torch, hfa, hfp, peaks, timing, timing_bwd):
    """K1, K2 and K3 at rate 0.1 against their plain versions with the same
    seed: the cases (f32 and bf16, GQA, causal bands), the mask probe, the
    timed shapes (K1 at B=1 and K2/K3 at B=4, S=2048, H=16, D=128, causal,
    bf16: compared, then timed beside rate 0), and a batch of 66 x 16 heads
    at S=2048 whose flat score index passes 2^32, compared on its last
    batch (heads 1040-1055)."""
    worst = {"flash_fwd": 0.0, "flash_fwd_tc": 0.0,
             **{n: 0.0 for n in K2_K3_KERNELS}}
    rows = []
    for i, (name, b, sq, sk, h, hk, d, causal, dt) in enumerate(
            K1_DROP_CASES):
        dtype = torch_dtype(torch, dt)
        q, k, v = k1_inputs(torch, b, sq, sk, h, hk, d, dtype, seed=900 + i)
        g = torch.Generator(device="cuda")
        g.manual_seed(950 + i)
        do = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
        dr = hfa.AttnDropout(DROP_RATE, 1000 + i)
        row, o, _ = compare_bwd(torch, hfa, (name, b, sq, sk, h, hk, d, dt),
                                q, k, v, do, causal, worst, dr)
        ro, _ = hfa.flash_fwd_reference(q, k, v, causal, dropout=dr)
        worst[k1_body(dt)] = max(worst[k1_body(dt)],
                                 compare(torch, "o", o, ro, dt, row))
        check(row["ok"], f"K1 with dropout disagrees: {row}")
        rows.append(row)
    probe = mask_probe(torch, hfa, hfp, "k1", seed=77)

    timed = {}
    b, s, h, d = 4, 2048, 16, 128
    q, k, v = k1_inputs(torch, b, s, s, h, h, d, torch.bfloat16, seed=8)
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    do = torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
    dr = hfa.AttnDropout(DROP_RATE, 2024)
    row, o, lse = compare_bwd(torch, hfa, ("train_b4_s2048", b, s, s, h, h,
                                           d, "bf16"), q, k, v, do, True,
                              worst, dr)
    rows.append(row)
    q1, k1, v1 = (x[:1] for x in (q, k, v))
    o1, _ = hfa.flash_fwd(q1, k1, v1, True, dropout=dr)
    ro1, _ = hfa.flash_fwd_reference(q1, k1, v1, True, dropout=dr)
    row1 = {"case": "serve_b1_s2048"}
    worst["flash_fwd_tc"] = max(worst["flash_fwd_tc"],
                                compare(torch, "o", o1, ro1, "bf16", row1))
    check(row1["ok"], f"K1 with dropout disagrees at S=2048: {row1}")
    rows.append(row1)
    timed["flash_fwd_tc"] = rate_times(
        lambda: hfa.flash_fwd(q1, k1, v1, True),
        lambda: hfa.flash_fwd(q1, k1, v1, True, dropout=dr), reps=10)
    delta = hfa._delta(o, do)
    scale = 1.0 / math.sqrt(d)
    timed["flash_bwd_dq_tc"] = rate_times(
        lambda: hfa.flash_bwd_dq_tc(q, k, v, do, lse, delta, True, scale),
        lambda: hfa.flash_bwd_dq_tc(q, k, v, do, lse, delta, True, scale,
                                    dr))
    timed["flash_bwd_dkv_tc"] = rate_times(
        lambda: hfa.flash_bwd_dkv_tc(q, k, v, do, lse, delta, True, scale),
        lambda: hfa.flash_bwd_dkv_tc(q, k, v, do, lse, delta, True, scale,
                                     dr))
    for kname, t in timed.items():
        t["rate0_phase_ms"] = (timing if kname == "flash_fwd_tc" else
                               timing_bwd)[kname]["kernel_ms"]
    del q, k, v, do, o, lse, delta

    # the flat index wraps: B = 66 at H = 16, S = 2048
    b, s, h, d = 66, 2048, 16, 128
    q, k, v = k1_inputs(torch, b, s, s, h, h, d, torch.bfloat16, seed=10)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    do = torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
    dr = hfa.AttnDropout(DROP_RATE, 31337)
    o, lse = hfa.flash_fwd(q, k, v, True, dropout=dr)
    dq, dk, dv = hfa.flash_bwd(q, k, v, o, lse, do, True, dropout=dr)
    last = b - 1
    sl = slice(last, b)
    ro, _ = hfa.flash_fwd_reference(q[sl], k[sl], v[sl], True, dropout=dr,
                                    first_head=last * h)
    refs = hfa.flash_bwd_reference(q[sl], k[sl], v[sl], o[sl], lse[sl],
                                   do[sl], True, dropout=dr,
                                   first_head=last * h, mma_sums=True)
    wrap = {"case": "wrap_b66_s2048", "shape": [b, s, s, h, h, d],
            "first_compared_head": last * h,
            "first_flat_index": wrap_heads(last, h, s, s)}
    check(wrap["first_flat_index"] > 2 ** 32, f"no wrap: {wrap}")
    for gname, got, ref in (("o", o[sl], ro), ("dq", dq[sl], refs[0]),
                            ("dk", dk[sl], refs[1]), ("dv", dv[sl], refs[2])):
        compare(torch, gname, got, ref, "bf16", wrap)
    check(wrap["ok"], f"K1-K3 disagree past the index wrap: {wrap}")
    rows.append(wrap)
    del q, k, v, do, o, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return {"cases": rows, "mask_probe": probe, "timing": timed}, worst


K4_DROP_CASES = [
    ("s384_key_bias", 2, 384, 384, 12, False, "bf16", "bias"),
    ("s512_causal_segments", 2, 512, 512, 12, True, "bf16", "seg"),
    ("s256_nomask", 2, 256, 256, 12, False, "bf16", None),
    ("f32_s512_nomask", 2, 512, 512, 12, False, "f32", None),
    ("f32_sq128_sk384_segment_ids_k", 2, 128, 384, 12, False, "f32",
     "segk"),
    ("f32_s256_causal_segments_bias", 1, 256, 256, 12, True, "f32",
     "seg_bias"),
]


def dropout_k4(torch, np, hfa, hfp, timing):
    """K4a-direct and K4b-fused at rate 0.1 against their plain versions
    with the same seed: the cases (f32 and bf16, with and without masks),
    the mask probe, BERT-base's shape (B=64, S=512, H=12, bench.py's
    padding bias: compared, then timed beside rate 0), and B = 1368 x 12
    heads at S=512, whose flat score index passes 2^32, compared on its
    last batch."""
    worst = {name: 0.0 for name in K4_DIRECT_KERNELS}
    rows = []
    for i, (name, b, sq, sk, h, causal, dt, mask) in enumerate(
            K4_DROP_CASES):
        dtype = torch_dtype(torch, dt)
        q, k, v, do, masks = k4_inputs(torch, b, sq, sk, h, dtype, mask,
                                       seed=1100 + i)
        row, _, _ = k4_case(torch, hfp, (name, b, sq, sk, h, causal, dt),
                            q, k, v, do, masks, worst,
                            hfa.AttnDropout(DROP_RATE, 1200 + i))
        rows.append(row)
    probe = mask_probe(torch, hfa, hfp, "k4", seed=78)

    b, s, h, d = 64, 512, 12, 64
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    _, att = bert_padded(np, b, s)
    masks = (None, None, padding_bias(torch, torch.as_tensor(
        att, device="cuda"), torch.bfloat16))
    dr = hfa.AttnDropout(DROP_RATE, 4242)
    row, o, lse = k4_case(torch, hfp, ("bert_b64_s512_padded", b, s, s, h,
                                       False, "bf16"), q, k, v, do, masks,
                          worst, dr)
    rows.append(row)
    delta = hfp._delta(o, do)
    scale = 1.0 / math.sqrt(d)
    timed = {
        "flash_packed_fwd_tc": rate_times(
            lambda: hfp.flash_packed_fwd(q, k, v, False, None, masks),
            lambda: hfp.flash_packed_fwd(q, k, v, False, None, masks, dr)),
        "flash_packed_bwd_tc": rate_times(
            lambda: hfp._launch_bwd(q, k, v, do, lse, delta, False, scale,
                                    masks),
            lambda: hfp._launch_bwd(q, k, v, do, lse, delta, False, scale,
                                    masks, dr))}
    for kname, t in timed.items():
        t["rate0_phase_ms"] = timing[kname]["kernel_ms"]
    del q, k, v, do, o, lse, delta

    b = 1368
    g.manual_seed(12)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    dr = hfa.AttnDropout(DROP_RATE, 5151)
    none = (None, None, None)
    o, lse = hfp.flash_packed_fwd(q, k, v, False, None, none, dr)
    dq, dk, dv = hfp.flash_packed_bwd(q, k, v, o, lse, do, False, None, none,
                                      dr)
    last = b - 1
    sl = slice(last, b)
    ro, _ = hfp.flash_packed_fwd_reference(q[sl], k[sl], v[sl], False, None,
                                           none, dr, first_head=last * h)
    refs = hfp.flash_packed_bwd_reference(q[sl], k[sl], v[sl], o[sl],
                                          lse[sl], do[sl], False, None, none,
                                          dr, first_head=last * h,
                                          mma_sums=True)
    wrap = {"case": f"wrap_b{b}_s512", "shape": [b, s, s, h, d],
            "first_compared_head": last * h,
            "first_flat_index": wrap_heads(last, h, s, s)}
    check(wrap["first_flat_index"] > 2 ** 32, f"no wrap: {wrap}")
    for gname, got, ref in (("o", o[sl], ro), ("dq", dq[sl], refs[0]),
                            ("dk", dk[sl], refs[1]), ("dv", dv[sl], refs[2])):
        compare(torch, gname, got, ref, "bf16", wrap)
    check(wrap["ok"], f"K4a/K4b disagree past the index wrap: {wrap}")
    rows.append(wrap)
    del q, k, v, do, o, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return {"cases": rows, "mask_probe": probe, "timing": timed}, worst


STREAM_DROP_CASES = [
    ("f32_s640_key_bias", 1, 640, 640, 12, False, "f32", "bias"),
    ("f32_sq384_sk640_causal_segments_bias", 1, 384, 640, 12, True, "f32",
     "seg_bias"),
    ("f32_s256_nomask", 2, 256, 256, 12, False, "f32", None),
    ("bf16_s1024_causal", 1, 1024, 1024, 12, True, "bf16", None),
    ("bf16_sq512_sk1024_segment_ids_k", 2, 512, 1024, 12, False, "bf16",
     "segk"),
    ("bf16_s640_key_bias", 2, 640, 640, 12, False, "bf16", "bias"),
]


def dropout_stream(torch, np, hfa, hfp, timing):
    """The four streamed kernels at rate 0.1 against their plain versions
    with the same seed: the cases, the mask probe, ERNIE's long shape
    (B=16, S=2048, H=12: forward, dq, dk/dv) and the cross-attention shape
    (512 over 2048: dk/dv-direct), compared and timed beside rate 0, and
    batches whose flat score index passes 2^32 (B = 92 x 12 heads at
    S=2048; B = 344 at 512 x 2048 for dk/dv-direct), compared on their
    last batch."""
    worst = {name: 0.0 for name in STREAM_KERNELS}
    rows = []
    for i, (name, b, sq, sk, h, causal, dt, mask) in enumerate(
            STREAM_DROP_CASES):
        dtype = torch_dtype(torch, dt)
        q, k, v, do, masks = k4_inputs(torch, b, sq, sk, h, dtype, mask,
                                       seed=1300 + i)
        row, _, _ = stream_case(torch, hfp, (name, b, sq, sk, h, causal, dt),
                                q, k, v, do, masks, worst,
                                hfa.AttnDropout(DROP_RATE, 1400 + i))
        rows.append(row)
    probe = mask_probe(torch, hfa, hfp, "stream", seed=79)

    timed = {}
    h, d = 12, 64
    scale = 1.0 / math.sqrt(d)
    none = (None, None, None)
    for shape_name, b, sq, sk, wrap_b in (
            ("ernie_b16_s2048", 16, 2048, 2048, 92),
            ("cross_b16_sq512_sk2048", 16, 512, 2048, 344)):
        g = torch.Generator(device="cuda")
        g.manual_seed(13)
        q, do = (torch.randn(b, sq, h, d, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, sk, h, d, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        dr = hfa.AttnDropout(DROP_RATE, 6060)
        row, o, lse = stream_case(torch, hfp, (shape_name, b, sq, sk, h,
                                               False, "bf16"),
                                  q, k, v, do, none, worst, dr)
        rows.append(row)
        delta = hfp._delta(o, do)
        args = (q, k, v, do, lse, delta, False, scale, none)
        if sq == sk:
            runs = {"flash_packed_fwd_stream_tc": lambda *a: (
                        hfp.flash_packed_fwd_stream(q, k, v, False, scale,
                                                    none, *a)),
                    "flash_packed_bwd_dq_tc": lambda *a: (
                        hfp.flash_packed_bwd_dq(*args, *a)),
                    "flash_packed_bwd_dkv_tc": lambda *a: (
                        hfp.flash_packed_bwd_dkv(*args, *a))}
        else:
            runs = {"flash_packed_bwd_dkv_direct_tc": lambda *a: (
                hfp.flash_packed_bwd_dkv_direct(*args, *a))}
        for kname, run in runs.items():
            timed[kname] = rate_times(lambda: run(), lambda: run(dr))
            timed[kname]["shape"] = shape_name
            timed[kname]["rate0_phase_ms"] = timing[kname]["kernel_ms"]
        del q, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()

        # the flat index wraps
        b = wrap_b
        g.manual_seed(14)
        q, do = (torch.randn(b, sq, h, d, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, sk, h, d, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        dr = hfa.AttnDropout(DROP_RATE, 7070)
        o, lse = hfp.flash_packed_fwd_stream(q, k, v, False, None, none, dr)
        delta = hfp._delta(o, do)
        args = (q, k, v, do, lse, delta, False, None, none, dr)
        got = {"o": o, "dq": hfp.flash_packed_bwd_dq(*args)}
        dkv, dkv_body = (hfp.flash_packed_bwd_dkv, "flash_packed_bwd_dkv_tc") \
            if sq == sk else (hfp.flash_packed_bwd_dkv_direct,
                              "flash_packed_bwd_dkv_direct_tc")
        got["dk"], got["dv"] = dkv(*args)
        last = b - 1
        sl = slice(last, b)
        largs = (q[sl], k[sl], v[sl], do[sl], lse[sl], delta[sl], False,
                 None, none, dr)
        fh = {"first_head": last * h}
        ref = {"o": hfp.flash_packed_fwd_stream_reference(
            q[sl], k[sl], v[sl], False, None, none, dr, **fh)[0],
               "dq": hfp.flash_packed_bwd_dq_reference(*largs, **fh,
                                                       mma_sums=True)}
        ref["dk"], ref["dv"] = hfp.flash_packed_bwd_dkv_reference(
            *largs, **fh, mma_sums=True)
        wrap = {"case": f"wrap_b{b}_{shape_name}", "shape": [b, sq, sk, h, d],
                "kernels": ["flash_packed_fwd_stream_tc",
                            "flash_packed_bwd_dq_tc", dkv_body],
                "first_compared_head": last * h,
                "first_flat_index": wrap_heads(last, h, sq, sk)}
        check(wrap["first_flat_index"] > 2 ** 32, f"no wrap: {wrap}")
        for gname in ("o", "dq", "dk", "dv"):
            compare(torch, gname, got[gname][sl], ref[gname], "bf16", wrap)
        check(wrap["ok"], f"streamed K4 disagrees past the index wrap: "
                          f"{wrap}")
        rows.append(wrap)
        del q, k, v, do, o, lse, delta, args, got, largs, ref
        torch.cuda.empty_cache()
    return {"cases": rows, "mask_probe": probe, "timing": timed}, worst


# -- float16 through every kernel --------------------------------------------

#: the cases each kernel family runs in float16 (its bf16 cases' masks,
#: causal forms, rows with no key and dropout), by index into the bf16
#: lists: K1_TC_CASES, K2_K3_TC_CASES, K4_CASES, STREAM_CASES, CONV_CASES
F16_PICKS = {"k1": (0, 1, 3, 4, 5), "k2_k3": (0, 2, 3, 5, 6),
             "k4": (0, 1, 2, 3, 5, 6), "stream": (11, 12, 17, 20, 22),
             "conv": (0, 3, 4, 5, 6, 7, 16, 18)}


def f16_of(case, at, dt="f16"):
    """A bf16 case as the float16 case of the same shape and masks."""
    return case[:at] + (dt,) + case[at + 1:]


def phase_kernel_float16(torch, np, hfa, hfp, hc, fmb, peaks):
    """Float16 through every kernel, as JAX's kernels take it, against the
    plain versions on the card, in the cases each phase above runs in bf16
    (``F16_PICKS``: masks, causal, rows with no key, GQA, dropout, ragged
    tiles, stride 2, the prologue): K1 (its tensor-core body), K2/K3 (the
    tensor-core bodies at head dims 64 and 128, after a probe holds
    ``mma_dot`` to their float16 sums bit for bit, and the CUDA-core bodies
    at 256), K4a-direct and K4b-fused (tensor cores), the streamed forward,
    dq and dk/dv (tensor cores) and dk/dv-direct (CUDA cores), K5-K8 and
    K9, each checked to run the bodies of its dtype; then every float16
    tensor-core body timed once at its model's shape beside bf16 on the
    same values. Returns ``({kernel: max error}, {kernel: timing})``."""
    worst = {}
    rows = []
    probe = {d: mma_probe(torch, hfa.flash_bwd_dq_tc, hfa.mma_dot, d,
                          dtype=torch.float16) for d in (64, 128)}
    check(all(v == 1.0 for v in probe.values()),
          f"mma_dot models {probe} of the card's float16 sums, not all")
    for i in F16_PICKS["k1"]:
        name, b, sq, sk, h, hk, d, causal, mask, drop = K1_TC_CASES[i]
        g = torch.Generator(device="cuda")
        g.manual_seed(2150 + i)
        q, k, v = k1_inputs(torch, b, sq, sk, h, hk, d, torch.float16,
                            seed=2160 + i)
        masks = mask_inputs(torch, g, b, sq, sk, torch.float16, mask)
        dr = hfa.AttnDropout(DROP_RATE, 2170 + i) if drop else None
        before = hfa.flash_fwd_tc.launches
        o, lse = hfa.flash_fwd(q, k, v, causal, dropout=dr, masks=masks)
        torch.cuda.synchronize()
        ro, rlse = hfa.flash_fwd_reference(q, k, v, causal, dropout=dr,
                                           masks=masks)
        row = {"case": "f16_" + name, "shape": [b, sq, sk, h, hk, d],
               "dtype": "f16", "body": "flash_fwd_tc",
               "ran": hfa.flash_fwd_tc.launches - before}
        worst["flash_fwd_tc"] = max(worst.get("flash_fwd_tc", 0.0), compare(
            torch, "o", o, ro, "f16", row, nonzero=True))
        err_lse = (lse - rlse).abs()
        row["max_abs_err_lse"] = float(err_lse.max())
        row["ok"] &= row["ran"] == 1 and bool(
            (err_lse <= REL16["f16"] * (1 + rlse.abs())).all())
        check(row["ok"], f"K1 in float16 disagrees: {row}")
        rows.append(row)
    k2_cases = [K2_K3_TC_CASES[i] for i in F16_PICKS["k2_k3"]] + [
        ("d256_s300_causal_cuda_core", 1, 300, 300, 8, 4, 256, True, None,
         False)]
    for i, (name, b, sq, sk, h, hk, d, causal, mask, drop) in enumerate(
            k2_cases):
        g = torch.Generator(device="cuda")
        g.manual_seed(2250 + i)
        q, k, v = k1_inputs(torch, b, sq, sk, h, hk, d, torch.float16,
                            seed=2260 + i)
        do = torch.randn(b, sq, h, d, generator=g, device="cuda").to(
            torch.float16)
        masks = mask_inputs(torch, g, b, sq, sk, torch.float16, mask)
        dr = hfa.AttnDropout(DROP_RATE, 2270 + i) if drop else None
        row, _, _ = compare_bwd(torch, hfa, ("f16_" + name, b, sq, sk, h, hk,
                                             d, "f16"), q, k, v, do, causal,
                                worst, dr, masks)
        rows.append(row)
    for j, i in enumerate(F16_PICKS["k4"]):
        name, b, sq, sk, h, causal, _, mask = K4_CASES[i]
        q, k, v, do, masks = k4_inputs(torch, b, sq, sk, h, torch.float16,
                                       mask, seed=2300 + j)
        row, _, _ = k4_case(torch, hfp, ("f16_" + name, b, sq, sk, h, causal,
                                         "f16"), q, k, v, do, masks, worst)
        rows.append(row)
    name, b, sq, sk, h, causal, _, mask = K4_DROP_CASES[0]
    q, k, v, do, masks = k4_inputs(torch, b, sq, sk, h, torch.float16, mask,
                                   seed=2350)
    row, _, _ = k4_case(torch, hfp, ("f16_" + name, b, sq, sk, h, causal,
                                     "f16"), q, k, v, do, masks, worst,
                        hfa.AttnDropout(DROP_RATE, 2351))
    rows.append(row)
    for j, i in enumerate(F16_PICKS["stream"]):
        name, b, sq, sk, h, causal, _, mask = STREAM_CASES[i]
        q, k, v, do, masks = k4_inputs(torch, b, sq, sk, h, torch.float16,
                                       mask, seed=2400 + j)
        row, _, _ = stream_case(torch, hfp, ("f16_" + name, b, sq, sk, h,
                                             causal, "f16"), q, k, v, do,
                                masks, worst)
        rows.append(row)
    g = torch.Generator(device="cuda")
    g.manual_seed(2500)
    for i in F16_PICKS["conv"]:
        case = f16_of(CONV_CASES[i], 10)
        before = conv_counts(hc)
        row, errs = conv_case(torch, hc, ("f16_" + case[0],) + case[1:], g)
        ran = {n: c - before[n] for n, c in conv_counts(hc).items()}
        k = "mm" if case[1] == "conv1x1" else "c3"
        check(ran == {**{n: 0 for n in CONV_KERNELS}, k: 2, k + "_wgrad": 1},
              f"{case[0]} in float16 ran {ran}")
        rows.append(row)
        for kname, (err, _) in errs.items():
            worst[kname] = max(worst.get(kname, 0.0), err)
    for i, (name, m, cin, cout) in enumerate((("m77_96to80_ragged", 77, 96,
                                                80),
                                               ("m600_64to256", 600, 64,
                                                256))):
        inp = k9_inputs(torch, m, cin, cout, torch.float16, seed=2600 + i)
        got = k9_grads(torch, fmb, "cuda", *inp, "scale_shift_relu", True)
        ref = k9_grads(torch, fmb, "cpu", *inp, "scale_shift_relu", True)
        row = {"case": "f16_" + name, "shape": [m, cin, cout],
               "dtype": "f16", "prologue": "scale_shift_relu",
               "stats": True}
        worst["fused_matmul_bn_fwd"] = max(
            worst.get("fused_matmul_bn_fwd", 0.0),
            k9_hold(torch, got, ref, "f16", "scale_shift_relu", True, row))
        check(row["ok"], f"K9 in float16 disagrees: {row}")
        rows.append(row)
    timing = f16_times(torch, np, hfa, hfp, hc, fmb)
    emit({"phase": "kernel_float16", "mma_probe_f16": probe, "cases": rows,
          "timing": timing})
    return worst, timing


def f16_times(torch, np, hfa, hfp, hc, fmb):
    """Each float16 tensor-core body once at its model's shape, beside bf16
    on the same values (the median of 20 calls each, bf16 first): K1, K2
    and K3 at GPT-3 1.3B's (B=4, S=2048, 16 heads of 128, causal),
    K4a-direct and K4b-fused at BERT-base's (B=64, S=512, 12 heads,
    bench.py's padding bias), the streamed forward, dq and dk/dv at
    ERNIE's long one (B=16, S=2048, 12 heads), dk/dv-direct at the
    cross-attention shape (B=16, 512 queries over 2048 keys), K5-K8 at
    ResNet-50's 56² shapes (B=256), K9 at its 256->64 one (M = 256·56²)."""
    out = {}

    def pair(name, make, run):
        ms = {}
        for dt in ("bf16", "f16"):
            args = make(torch_dtype(torch, dt))
            ms[dt] = median_ms(lambda: run(*args))
            del args
        torch.cuda.empty_cache()
        out[name] = {"bf16_ms": ms["bf16"], "f16_ms": ms["f16"]}

    g = torch.Generator(device="cuda")

    def attn(b, s, h, d, dtype, bias=False):
        g.manual_seed(31)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        masks = (None, None, None)
        if bias:
            _, att = bert_padded(np, b, s)
            masks = (None, None, padding_bias(torch, torch.as_tensor(
                att, device="cuda"), torch.float32))
        return q, k, v, do, masks

    def gpt(dtype):
        q, k, v, do, _ = attn(4, 2048, 16, 128, dtype)
        o, lse = hfa.flash_fwd(q, k, v, causal=True)
        return q, k, v, do, o, lse, hfa._delta(o, do)

    pair("flash_fwd_tc", gpt, lambda q, k, v, *_: hfa.flash_fwd(
        q, k, v, causal=True))
    scale = 1 / math.sqrt(128)
    pair("flash_bwd_dq_tc", gpt, lambda q, k, v, do, o, lse, delta:
         hfa.flash_bwd_dq_tc(q, k, v, do, lse, delta, True, scale))
    pair("flash_bwd_dkv_tc", gpt, lambda q, k, v, do, o, lse, delta:
         hfa.flash_bwd_dkv_tc(q, k, v, do, lse, delta, True, scale))

    def bert(dtype):
        q, k, v, do, masks = attn(64, 512, 12, 64, dtype, bias=True)
        o, lse = hfp.flash_packed_fwd(q, k, v, False, None, masks)
        return q, k, v, do, masks, lse, hfp._delta(o, do)

    scale = 1 / 8
    pair("flash_packed_fwd_tc", bert, lambda q, k, v, do, masks, *_:
         hfp.flash_packed_fwd(q, k, v, False, None, masks))
    pair("flash_packed_bwd_tc", bert, lambda q, k, v, do, masks, lse, delta:
         hfp._launch_bwd(q, k, v, do, lse, delta, False, scale, masks))

    def ernie(dtype):
        q, k, v, do, masks = attn(16, 2048, 12, 64, dtype)
        o, lse = hfp.flash_packed_fwd_stream(q, k, v, False, None, masks)
        return q, k, v, do, masks, lse, hfp._delta(o, do)

    pair("flash_packed_fwd_stream_tc", ernie, lambda q, k, v, do, masks, *_:
         hfp.flash_packed_fwd_stream(q, k, v, False, None, masks))
    for which in ("dq", "dkv"):
        pair(f"flash_packed_bwd_{which}_tc", ernie,
             lambda q, k, v, do, masks, lse, delta, w=which:
             hfp._launch_bwd_split(w, q, k, v, do, lse, delta, False, scale,
                                   masks))

    def cross(dtype):
        g.manual_seed(33)
        q, do = (torch.randn(16, 512, 12, 64, generator=g,
                             device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(16, 2048, 12, 64, generator=g,
                            device="cuda").to(dtype) for _ in range(2))
        o, lse = hfp.flash_packed_fwd_stream(q, k, v)
        return q, k, v, do, lse, hfp._delta(o, do)

    pair("flash_packed_bwd_dkv_direct_tc", cross, lambda *a:
         hfp.flash_packed_bwd_dkv_direct(*a))

    def resnet(cin, cout, k):
        def make(dtype):
            g.manual_seed(32)
            x = torch.randn(256, 56, 56, cin, generator=g,
                            device="cuda").to(dtype)
            w = (torch.randn(cout, cin, k, k, generator=g, device="cuda") *
                 (cin * k * k) ** -0.5).to(dtype)
            sc = torch.randn(cin, generator=g, device="cuda")
            sh = torch.randn(cin, generator=g, device="cuda")
            dy = torch.randn(256, 56, 56, cout, generator=g,
                             device="cuda").to(dtype)
            return x, hc.fwd_weight(w, dtype), sc, sh, dy
        return make

    pair("mm", resnet(256, 64, 1), lambda x, wt, sc, sh, dy: hc.mm(
        x, wt[0], sc, sh, "relu", True, 1))
    pair("mm_wgrad", resnet(256, 64, 1), lambda x, wt, sc, sh, dy:
         hc.mm_wgrad(x, dy, sc, sh, "relu", 1))
    pair("c3", resnet(64, 64, 3), lambda x, wt, sc, sh, dy: hc.c3(
        x, wt, sc, sh, "relu", True, 1))
    pair("c3_wgrad", resnet(64, 64, 3), lambda x, wt, sc, sh, dy:
         hc.c3_wgrad(x, dy, sc, sh, "relu", 1))
    pair("fused_matmul_bn_fwd", resnet(256, 64, 1), lambda x, wt, sc, sh, dy:
         fmb.fused_matmul_bn_fwd(x.view(-1, 256), wt[0], sc, sh))
    return out


# -- K9: fused_matmul_bn_act -------------------------------------------------

# name, M, Cin, Cout, dtype: the three prologues, stats on and off, at each
K9_CASES = [
    ("m600_64to256", 600, 64, 256, "bf16"),
    ("f32_m600_48to40", 600, 48, 40, "f32"),
    ("m77_96to80_ragged", 77, 96, 80, "bf16"),
    ("f32_m1031_32to24_ragged", 1031, 32, 24, "f32"),
]
# ResNet-50's bottleneck 1x1s at B=256, 56x56, as matrices
K9_FULL = (("b256_56_256to64", 256 * 56 * 56, 256, 64),
           ("b256_56_64to256", 256 * 56 * 56, 64, 256))


def k9_inputs(torch, m, cin, cout, dtype, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn(m, cin, generator=g, device="cuda").to(dtype)
    w = (torch.randn(cin, cout, generator=g, device="cuda") /
         math.sqrt(cin)).to(dtype)
    scale = torch.rand(cin, generator=g, device="cuda") + 0.5
    shift = torch.rand(cin, generator=g, device="cuda") - 0.5
    dy = torch.randn(m, cout, generator=g, device="cuda").to(dtype)
    ds = torch.randn(cout, generator=g, device="cuda")
    dss = 1e-3 * torch.randn(cout, generator=g, device="cuda")
    return x, w, scale, shift, dy, ds, dss


def k9_grads(torch, fmb, device, x, w, scale, shift, dy, ds, dss, prologue,
             stats):
    """y, s, ss and the gradients of ``fused_matmul_bn_act`` on ``device``
    at cotangents (dy, ds, dss): the kernel's forward and the torch-op
    backward on the card, the plain version and the same backward on the
    CPU."""
    xs = [t.detach().to(device).requires_grad_() for t in (x, w, scale,
                                                           shift)]
    y, s, ss = fmb.fused_matmul_bn_act(*xs, prologue=prologue, stats=stats)
    loss = (y.float() * dy.to(device).float()).sum()
    if stats:
        loss = loss + (s * ds.to(device)).sum() + (ss * dss.to(device)).sum()
    loss.backward()
    return [y.detach(), s.detach(), ss.detach()] + [t.grad for t in xs]


def k9_hold(torch, got, ref, dt, prologue, stats, row):
    """K9 (forward on the card) and its backward against the plain version
    and the CPU: y element by element (f32 1e-5 + 1e-5·|ref|, bf16 1e-2 +
    1e-2·|ref|: one rounding of the output may flip), dx too but in bf16
    within 2e-2 + 2e-2·|ref| (two roundings, of dy @ wᵀ summed in another
    order by cuBLAS and by the CPU, then of the product with scale, may
    each flip); the sums over M (the stats, dw, dscale, dshift) within
    1e-5 (f32) or 1e-2 (bf16) of their largest value. Returns y's max
    error."""
    names = ("y", "sum", "sumsq", "dx", "dw", "dscale", "dshift")
    row["ok"] = row.get("ok", True)
    for name, g, r in zip(names, got, ref):
        if name in ("sum", "sumsq") and not stats:
            row["ok"] &= bool((g == 0).all())
            continue
        if name in ("dscale", "dshift") and prologue == "none":
            row["ok"] &= g is None and r is None
            continue
        g, r = g.float().cpu(), r.float().cpu()
        check(bool(torch.isfinite(g).all()), f"K9 {name}: non-finite")
        err = (g - r).abs()
        if name in ("y", "dx"):
            t = 1e-5 if dt == "f32" else REL16[dt] * (1 if name == "y"
                                                       else 2)
            ok = bool((err <= t + t * r.abs()).all())
        else:
            ok = float(err.max()) <= REL16.get(dt, 1e-5) * \
                max(float(r.abs().max()), 1e-30)
        row[f"max_abs_err_{name}"] = float(err.max())
        row[f"max_abs_{name}"] = float(r.abs().max())
        row[f"ok_{name}"] = ok
        row["ok"] &= ok
    return row["max_abs_err_y"]


def phase_kernel_fused_matmul_bn(torch, fmb, peaks):
    """K9 (``fused_matmul_bn_act``): its path first, the entry driven as a
    user calls it at ResNet-50's bottleneck 1x1 shapes (M = 256·56·56,
    256 -> 64 and 64 -> 256, bf16, ``scale_shift_relu``, stats, forward and
    backward), with the launch count set to 0 just before and read after;
    then the kernel and its torch-op backward against the plain version
    and the CPU in every case (three prologues, stats on and off, f32 and
    bf16, M = 600 and ragged M: every row computed) and at the full shapes,
    where the kernel is timed beside its bound, its plain version, cuBLAS
    and the body K5 and K9 had before (``conv.mm_tiles64`` on the ``[1, 1,
    M, Cin]`` image, a yardstick no path runs)."""
    import itertools
    from paddle_tpu_torch.ops._hopper import conv as hc
    full = {}
    for name, m, cin, cout in K9_FULL:
        full[name] = k9_inputs(torch, m, cin, cout, torch.bfloat16, seed=21)
    torch.cuda.synchronize()
    fmb.fused_matmul_bn_fwd.launches = 0
    got_full = {name: k9_grads(torch, fmb, "cuda", *inp, "scale_shift_relu",
                               True) for name, inp in full.items()}
    torch.cuda.synchronize()
    launches = fmb.fused_matmul_bn_fwd.launches
    check(launches == len(K9_FULL), f"K9 path: {launches} launches")

    rows, worst = [], 0.0
    for i, ((name, m, cin, cout, dt), prologue, stats) in enumerate(
            itertools.product(K9_CASES, fmb.PROLOGUES, (True, False))):
        dtype = torch_dtype(torch, dt)
        inp = k9_inputs(torch, m, cin, cout, dtype, seed=1500 + i)
        got = k9_grads(torch, fmb, "cuda", *inp, prologue, stats)
        ref = k9_grads(torch, fmb, "cpu", *inp, prologue, stats)
        row = {"case": name, "shape": [m, cin, cout], "dtype": dt,
               "prologue": prologue, "stats": stats}
        worst = max(worst, k9_hold(torch, got, ref, dt, prologue, stats,
                                   row))
        check(row["ok"], f"K9 disagrees with its plain version: {row}")
        rows.append(row)

    timing = {}
    for name, m, cin, cout in K9_FULL:
        x, w, scale, shift, *cts = full[name]
        ref = k9_grads(torch, fmb, "cpu", x, w, scale, shift, *cts,
                       "scale_shift_relu", True)
        row = {"case": name, "shape": [m, cin, cout], "dtype": "bf16",
               "prologue": "scale_shift_relu", "stats": True,
               "backward_against": "cpu"}
        worst = max(worst, k9_hold(torch, got_full[name], ref, "bf16",
                                   "scale_shift_relu", True, row))
        # the kernel's forward against the plain version on the card too
        y, s, ss = fmb.fused_matmul_bn_fwd(x, w, scale, shift)
        ry, rs, rss = fmb.fused_matmul_bn_act_reference(x, w, scale, shift)
        row["max_abs_err_y_card"] = float((y.float() - ry.float()).abs().max())
        row["ok"] &= bool(((y.float() - ry.float()).abs() <=
                           1e-2 + 1e-2 * ry.float().abs()).all())
        for sn, a, r in (("sum", s, rs), ("sumsq", ss, rss)):
            rel = float((a - r).abs().max()) / float(r.abs().max())
            row[f"{sn}_rel_err_card"] = rel
            row["ok"] &= rel <= 1e-5
        check(row["ok"], f"K9 disagrees at the full shape: {row}")
        rows.append(row)
        xb = fmb._prologue(x, scale, shift, "scale_shift_relu")
        # five calls a sample, as k5_stages times K5
        ms = median_ms(lambda: fmb.fused_matmul_bn_fwd(x, w, scale, shift),
                       reps=5)
        plain_ms = median_ms(lambda: fmb.fused_matmul_bn_act_reference(
            x, w, scale, shift), iters=5, warmup=1)
        library_ms = median_ms(lambda: torch.matmul(xb, w), reps=5)
        parent_ms = median_ms(lambda: hc.mm_tiles64(
            x.view(1, 1, m, cin), w, scale, shift, "relu", True), reps=5)
        flops = 2 * m * cin * cout
        nbytes = (m * cin + m * cout + cin * cout) * 2
        t_ops = flops / peaks["bf16"] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        timing[name] = {
            "shape": [m, cin, cout], "dtype": "bf16",
            "prologue": "scale_shift_relu", "stats": True,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "parent_ms": parent_ms, "reps": 5,
            "plan": hc.k5_plan(m, cin, cout)._asdict(),
            "library": "torch.matmul(prologued x, w): cuBLAS without the "
                       "prologue and the stats",
            "flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "peak_sheet": peaks["sheet"], "tflops": flops / ms / 1e9,
            "gb_per_s": nbytes / ms / 1e6}
        del xb, y, s, ss, ry, rs, rss
    del full, got_full
    torch.cuda.empty_cache()
    emit({"phase": "kernel_fused_matmul_bn", "kernel": "fused_matmul_bn_fwd",
          "path_launches": launches, "cases": rows, "timing": timing})
    return worst, launches, {**timing[K9_FULL[0][0]], "shapes": timing}


# -- phases 8 and 9 ----------------------------------------------------------

def top2_gap(torch, model, prefix):
    """generate's top-2 logit gap after ``prefix`` (dense decode, as
    generate computes it)."""
    with torch.no_grad():
        ids = torch.as_tensor(prefix, device=model.device)[None].long()
        caches = model.gpt.init_cache(1, ids.shape[1])
        hidden, _ = model.gpt.decode(ids, caches, 0)
        top = torch.topk(model.logits(hidden[:, -1])[0].float(), 2).values
    return float(top[0] - top[1])


def hold_to_generate(torch, np, model, reqs, res, refs):
    """serve_f32's rule for each request: the engine's output equals the
    model's dense-cache ``generate``, or first differs where generate's
    top-2 logit gap is under 1e-3 (a near-tie). ``refs`` keeps generate's
    outputs by prompt and length across arms. Returns one row a request."""
    rows = []
    for r in reqs:
        seq = res[r.rid]
        check(seq.status.value == "finished", f"{r.rid}: {seq.status}")
        key = (r.prompt_ids.tobytes(), r.max_new_tokens)
        if key not in refs:
            refs[key] = model.generate(
                torch.as_tensor(r.prompt_ids, device="cuda")[None].long(),
                max_new_tokens=r.max_new_tokens)[0].cpu().numpy()
        want, got = refs[key], seq.output
        check(got.shape == want.shape, f"{r.rid}: shape {got.shape}")
        diff = np.nonzero(got != want)[0]
        row = {"rid": r.rid, "prompt": int(r.prompt_ids.size),
               "exact": diff.size == 0}
        if diff.size:
            pos = int(diff[0])
            gap = top2_gap(torch, model, want[:pos])
            row.update(first_mismatch=pos - int(r.prompt_ids.size),
                       engine_token=int(got[pos]),
                       generate_token=int(want[pos]), top2_gap=gap)
            check(gap < 1e-3, f"f32 serve differs from generate beyond a "
                              f"near-tie: {row}")
        rows.append(row)
    return rows


def phase_serve_f32(torch, np, hfa, model, Request, ServingEngine):
    rng = np.random.default_rng(1)
    vocab, n_layers = model.cfg.vocab_size, model.cfg.num_layers
    lens = [int(n) for n in rng.integers(64, 480, 3)]
    reqs = [Request(rid=f"f{i}", prompt_ids=rng.integers(0, vocab, n),
                    max_new_tokens=16) for i, n in enumerate(lens)]
    engine = ServingEngine(model, block_size=16, num_blocks=160, max_batch=4,
                           max_seq_len=512, device="cuda")
    hfa.flash_fwd.launches = hfa.flash_fwd_tc.launches = 0
    res = engine.serve(reqs)
    torch.cuda.synchronize()
    launches = hfa.flash_fwd.launches
    check(launches == engine.n_prefills * n_layers and
          hfa.flash_fwd_tc.launches == 0,
          f"f32 serve: {launches} launches of K1's f32 body (and "
          f"{hfa.flash_fwd_tc.launches} of its bf16 body) for "
          f"{engine.n_prefills} prefills")
    rows = hold_to_generate(torch, np, model, reqs, res, {})
    emit({"phase": "serve_f32", "model": "gpt3_1p3b", "layers": n_layers,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "prefills": engine.n_prefills, "k1_launches": launches,
          "requests": rows})
    return {"flash_fwd": launches, "flash_fwd_tc": 0}


def pick_pool(np, Request, ServingEngine, GPTForCausalLM, gpt_tiny, reqs,
              bs, max_seq, start):
    """The largest pool at or below ``start`` blocks under which the trace
    preempts. With no eos, scheduling depends only on the lengths, so a dry
    run of the same trace through the engine with a one-layer CPU model
    decides it; the GPU run then preempts the same way."""
    tiny = GPTForCausalLM(gpt_tiny(vocab_size=64, hidden_size=16,
                                   num_layers=1, num_heads=2,
                                   max_position_embeddings=max_seq),
                          device="cpu")
    dry = [Request(rid=r.rid, prompt_ids=np.zeros(r.prompt_ids.size),
                   max_new_tokens=r.max_new_tokens) for r in reqs]
    min_blocks = -(-max_seq // bs) + 1
    for num_blocks in range(start, min_blocks - 1, -1):
        engine = ServingEngine(tiny, block_size=bs, num_blocks=num_blocks,
                               max_batch=8, max_seq_len=max_seq,
                               device="cpu")
        engine.serve(dry)
        if engine.n_preemptions:
            return num_blocks
    raise SmokeFailure(f"no pool of {min_blocks}..{start} blocks preempts")


def bf16_trace(np, Request, vocab, new=32):
    """8 requests, prompt lengths drawn from 64..1536 (seed 2)."""
    rng = np.random.default_rng(2)
    sizes = [int(n) for n in rng.integers(64, 1537, 8)]
    return [Request(rid=f"b{i}", prompt_ids=rng.integers(0, vocab, n),
                    max_new_tokens=new) for i, n in enumerate(sizes)]


def phase_serve_bf16(torch, np, hfa, model, Request, ServingEngine,
                     GPTForCausalLM, gpt_tiny):
    n_layers = model.cfg.num_layers
    bs, new = 16, 32
    reqs = bf16_trace(np, Request, model.cfg.vocab_size, new)
    lens = [int(r.prompt_ids.size) for r in reqs]
    max_seq = max(lens) + new
    need = [-(-(n + new) // bs) for n in lens]
    num_blocks = pick_pool(np, Request, ServingEngine, GPTForCausalLM,
                           gpt_tiny, reqs, bs, max_seq, sum(need) // 2)
    engine = ServingEngine(model, block_size=bs, num_blocks=num_blocks,
                           max_batch=8, max_seq_len=max_seq, device="cuda")
    # the main path: counts are set to 0 just before it and read after
    for name in K1_K3_KERNELS:
        getattr(hfa, name).launches = 0
    t0 = time.perf_counter()
    res = engine.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hfa.flash_fwd_tc.launches
    others = {n: getattr(hfa, n).launches for n in K1_K3_KERNELS
              if n != "flash_fwd_tc"}
    check(not any(others.values()),
          f"bf16 serve launched K1's f32 body or K2/K3: {others}")
    for r in reqs:
        seq = res[r.rid]
        check(seq.status.value == "finished", f"{r.rid}: {seq.status}")
        check(seq.n_generated == new, f"{r.rid}: {seq.n_generated} tokens")
        out = seq.output[r.prompt_ids.size:]
        check(bool(((out >= 0) & (out < model.cfg.vocab_size)).all()),
              f"{r.rid}: token ids out of range")
    check(engine.n_preemptions >= 1, "no preemption")
    check(launches == engine.n_prefills * n_layers,
          f"bf16 serve: {launches} launches of K1's tensor-core body for "
          f"{engine.n_prefills} prefills")
    decode_s = sum(engine.decode_ms) / 1e3
    emit({"phase": "serve_bf16", "model": "gpt3_1p3b", "layers": n_layers,
          "prompt_lens": lens, "new_tokens": new, "block_size": bs,
          "pool_blocks": num_blocks, "trace_blocks": sum(need),
          "prefills": engine.n_prefills,
          "preemptions": engine.n_preemptions, "k1_launches": launches,
          "wall_s": wall,
          "prefill_tokens_per_s": engine.prefill_tokens / engine.prefill_s,
          "decode_tokens_per_s": engine.decode_tokens / decode_s,
          "decode_iterations": len(engine.decode_ms),
          "decode_step_p50_ms": percentile(engine.decode_ms, 50),
          "decode_step_p99_ms": percentile(engine.decode_ms, 99)})
    return {"flash_fwd_tc": launches, **others}, num_blocks


# -- serve_tiers -------------------------------------------------------------

def path_counts(hfa, hfp, hc, fmb):
    """Every kernel's launch count: K1-K4's bodies, K5-K8, K9."""
    return {**k4_counts(hfa, hfp), **conv_counts(hc),
            "fused_matmul_bn_fwd": fmb.fused_matmul_bn_fwd.launches}


def count_delta(before, after, allowed, what):
    """The launches between two ``path_counts``; only ``allowed`` may
    have launched."""
    delta = {n: after[n] - before[n] for n in after}
    stray = {n: d for n, d in delta.items() if d and n != allowed}
    check(not stray, f"{what} launched other kernels: {stray}")
    return delta


def tree_only(engine):
    """After a drain the allocator holds only the prefix tree's blocks,
    each by the tree's own ref; returns their count."""
    alloc = engine.cache.allocator
    held = (engine.prefix.device_block_ids() if engine.prefix is not None
            else frozenset())
    check(alloc.n_used == len(held) and
          all(alloc.refcount(i) == 1 for i in held),
          f"after the drain the pool holds {alloc.n_used} blocks, the "
          f"tree {len(held)}")
    return len(held)


def draft_model(GPTForCausalLM, gpt3_1p3b, model):
    """A 2-layer GPT at the target's width whose embeddings, first two
    blocks and final LayerNorm are the target's."""
    dm = GPTForCausalLM(gpt3_1p3b(num_layers=2), device="cuda",
                        dtype=model.gpt.wte.weight.dtype, seed=1)
    dm.load_state_dict({k: v for k, v in model.state_dict().items()
                        if not k.startswith("gpt.h.")
                        or int(k.split(".")[2]) < 2})
    return dm


def shared_trace(np, Request, vocab, n, plen, shared_len, new, seed,
                 shift=0, rid="p"):
    """``n`` prompts of ``plen`` tokens opening on one shared prefix of
    ``shared_len`` tokens; ``shift`` rotates every token id (distinct
    tokens for warm passes, as bench.py's prefix leg warms)."""
    rng = np.random.default_rng(seed)
    shared = (rng.integers(0, vocab, shared_len) + shift) % vocab
    return [Request(rid=f"{rid}{i}s{shift}", prompt_ids=np.concatenate(
        [shared, (rng.integers(0, vocab, max(1, plen - shared_len)) + shift)
         % vocab]), max_new_tokens=new) for i in range(n)]


def drive(engine, reqs, late=None, at=0):
    """Serve ``reqs``, submitting ``late`` before iteration ``at``; returns
    the results and each iteration's ``step()`` wall in ms."""
    for r in reqs:
        engine.submit(r)
    res, steps_ms, it = {}, [], 0
    while engine.sched.n_pending or late is not None:
        if late is not None and it == at:
            engine.submit(late)
            late = None
        t0 = time.perf_counter()
        for seq in engine.step():
            res[seq.rid] = seq
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        it += 1
    return res, steps_ms


def phase_serve_tiers_f32(torch, np, hfa, hfp, hc, fmb, model, Request,
                          ServingEngine, ModelDrafter, GPTForCausalLM,
                          gpt3_1p3b):
    """The three tiers, alone and composed, on the f32 model (all its
    layers), each output held to generate by serve_f32's rule. K1's f32
    body runs exactly once a layer for each cold one-shot prefill (the
    drafter's prompt KV goes through its extend step, as JAX's does)."""
    n_layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    bs, refs, arms = 16, {}, []
    before = path_counts(hfa, hfp, hc, fmb)
    rng = np.random.default_rng(3)

    def arm(name, engine, reqs, late=None, at=0, first=()):
        res = engine.serve(list(first))
        res.update(drive(engine, reqs, late, at)[0])
        torch.cuda.synchronize()
        rows = hold_to_generate(torch, np, model, list(first) + reqs +
                                ([late] if late else []), res, refs)
        row = {"arm": name, "k1_prefills": engine.n_prefills,
               "extend_prefills": engine.n_extend_prefills,
               "preemptions": engine.n_preemptions,
               "tree_blocks_after_drain": tree_only(engine),
               "exact": sum(r["exact"] for r in rows), "requests": rows}
        if engine.prefix is not None:
            row["prefix"] = engine.prefix_report()
        if engine.spec_gamma:
            row["spec"] = engine.spec_report()
        arms.append(row)
        return row

    def engine(**kw):
        return ServingEngine(model, block_size=bs, max_batch=4,
                             device="cuda", **{"num_blocks": 160,
                                               "max_seq_len": 512, **kw})

    # prefix: 4 prompts of 256 tokens on a 208-token (13-block, 81%) prefix
    prefix = shared_trace(np, Request, vocab, 4, 256, 208, 8, seed=4)
    row = arm("prefix", engine(prefix_cache=True), prefix)
    check(row["k1_prefills"] == 1 and row["prefix"]["hit_tokens"] == 3 * 208,
          f"prefix arm: {row['k1_prefills']} cold prefills, "
          f"{row['prefix']['hit_tokens']} hit tokens")
    # chunked at 64: a 480-token prompt arrives among 3 short residents
    short = [Request(rid=f"c{i}", prompt_ids=rng.integers(0, vocab, n),
                     max_new_tokens=24) for i, n in enumerate((40, 56, 72))]
    long_req = Request(rid="c_long", prompt_ids=rng.integers(0, vocab, 480),
                       max_new_tokens=8)
    row = arm("chunked", engine(chunked_prefill=64), short, long_req, 3)
    n_chunks = sum(-(-r.prompt_ids.size // 64) for r in short + [long_req])
    check(row["k1_prefills"] == 0 and row["extend_prefills"] == n_chunks,
          f"chunked arm: {row['k1_prefills']} one-shot prefills, "
          f"{row['extend_prefills']} chunks")
    # the n-gram drafter at gamma 4
    spec = [Request(rid=f"n{i}", prompt_ids=rng.integers(0, vocab, n),
                    max_new_tokens=16) for i, n in enumerate((96, 160, 200))]
    row = arm("ngram_g4", engine(speculative=4), spec)
    check(row["spec"]["iterations"] > 0, "n-gram arm never verified")
    # a ModelDrafter at gamma 2 under pool pressure: 3 of 4 prompts of 200
    # tokens fit 40 blocks, and each needs a 14th before it finishes
    dm = draft_model(GPTForCausalLM, gpt3_1p3b, model)
    pressed = [Request(rid=f"m{i}", prompt_ids=rng.integers(0, vocab, 200),
                       max_new_tokens=16) for i in range(4)]
    row = arm("model_drafter_g2", engine(
        num_blocks=41, max_seq_len=256, speculative=2,
        drafter=ModelDrafter(dm)), pressed)
    check(row["preemptions"] >= 1, "the drafter arm never preempted")
    del dm
    # all three composed on a shared-prefix trace; the first request is
    # served alone, so that its chunks fill the tree the others attach to
    comp = shared_trace(np, Request, vocab, 4, 256, 208, 8, seed=5, rid="x")
    row = arm("composed", engine(prefix_cache=True, chunked_prefill=64,
                                 speculative=4), comp[1:], first=comp[:1])
    check(row["prefix"]["hit_tokens"] > 0 and row["spec"]["iterations"] > 0,
          "the composed arm hit no prefix or never verified")
    torch.cuda.empty_cache()
    delta = count_delta(before, path_counts(hfa, hfp, hc, fmb),
                        "flash_fwd", "serve_tiers (f32)")
    cold = sum(a["k1_prefills"] for a in arms)
    check(delta["flash_fwd"] == cold * n_layers,
          f"serve_tiers f32: {delta['flash_fwd']} launches of K1's f32 body "
          f"for {cold} cold one-shot prefills")
    emit({"phase": "serve_tiers", "part": "f32", "model": "gpt3_1p3b",
          "layers": n_layers, "block_size": bs,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "k1_launches": delta["flash_fwd"], "cold_prefills": cold,
          "arms": arms})
    return delta


def equal_outputs(np, res, base):
    """How many requests of ``res`` equal the flag-off arm's ``base``."""
    return sum(int(np.array_equal(res[rid].output, base[rid].output))
               for rid in base) if base else None


def bf16_checked(res, reqs, vocab):
    """Every request finished with its length and in-range token ids."""
    for r in reqs:
        seq = res[r.rid]
        check(seq.status.value == "finished", f"{r.rid}: {seq.status}")
        check(seq.n_generated == r.max_new_tokens,
              f"{r.rid}: {seq.n_generated} tokens")
        out = seq.output[r.prompt_ids.size:]
        check(bool(((out >= 0) & (out < vocab)).all()),
              f"{r.rid}: token ids out of range")
    return res


def phase_serve_tiers_bf16(torch, np, hfa, hfp, hc, fmb, model, Request,
                           ServingEngine, ModelDrafter, GPTForCausalLM,
                           gpt3_1p3b, smi_line):
    """bench.py's three tier legs (``bench_serve_throughput_tiers``)
    scaled to the bf16 model, timed on the host clock around ``serve`` and
    each ``step()`` (each returns tokens to the host)."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops._hopper import autotune
    from paddle_tpu_torch.serving import engine as serving_engine
    from paddle_tpu_torch.serving import store_gamma
    vocab, n_layers = model.cfg.vocab_size, model.cfg.num_layers
    bs = 16
    before = path_counts(hfa, hfp, hc, fmb)
    cold = 0

    # -- prefix: 8 users, 1024-token prompts, 8 new tokens -------------------
    plen, new, users = 1024, 8, 8
    curve = []
    for ratio in (0.0, 0.5, 0.8):
        sl = int(round(ratio * plen / bs)) * bs
        arms, base = {}, None
        for on in (False, True):
            eng = ServingEngine(model, block_size=bs, num_blocks=400,
                                max_batch=4, max_seq_len=plen + 16,
                                prefix_cache=on, device="cuda")
            for shift in (7, 29):       # distinct-token warm passes
                eng.serve(shared_trace(np, Request, vocab, users, plen, sl,
                                       new, 17, shift, rid="u"))
            eng.reset_peaks()
            n0, p0, d0 = eng.n_prefills, eng.prefill_s, len(eng.decode_ms)
            ev0 = eng.prefix.evictions if on else 0
            trace = shared_trace(np, Request, vocab, users, plen, sl, new,
                                 17, rid="u")
            t0 = time.perf_counter()
            res = eng.serve(trace)
            wall = time.perf_counter() - t0
            bf16_checked(res, trace, vocab)
            cold += eng.n_prefills
            # the timed pass's wall: prefill steps (K1 or extend), decode
            # steps, and the rest (admission, the tree's walks, evictions)
            prefill_s = eng.prefill_s - p0
            decode_s = sum(eng.decode_ms[d0:]) / 1e3
            arms[on] = {"tokens_per_s": users * new / wall, "wall_s": wall,
                        "prefill_s": prefill_s, "decode_s": decode_s,
                        "other_s": wall - prefill_s - decode_s,
                        "peak_live_blocks": eng.peak_live_blocks,
                        "peak_blocks_used": eng.peak_blocks_used,
                        "timed_k1_prefills": eng.n_prefills - n0,
                        "equal_to_off": equal_outputs(np, res, base)}
            if on:
                rep = eng.prefix_report()
                arms[on].update(hit_rate=rep["hit_rate"],
                                tree_nodes=rep["tree_nodes"],
                                timed_evictions=eng.prefix.evictions - ev0)
            base = res
            del eng
        curve.append({
            "share_ratio": ratio, "shared_tokens": sl,
            "off": arms[False], "on": arms[True],
            "speedup": arms[True]["tokens_per_s"] /
            arms[False]["tokens_per_s"],
            "blocks_reduction": arms[False]["peak_live_blocks"] /
            max(arms[True]["peak_live_blocks"], 1)})
    check(curve[-1]["blocks_reduction"] >= 2.0,
          f"prefix cache cut peak live blocks only "
          f"{curve[-1]['blocks_reduction']:.3f}x at 80% share")
    torch.cuda.empty_cache()

    # -- chunked: a 1536-token prompt arrives at iteration 5 -----------------
    rng = np.random.default_rng(5)
    residents = [Request(rid=f"d{i}", prompt_ids=rng.integers(0, vocab, 64),
                         max_new_tokens=64) for i in range(3)]
    long_req = Request(rid="long", prompt_ids=rng.integers(0, vocab, 1536),
                       max_new_tokens=2)
    chunked, base = {}, None
    for budget in (0, 256):
        eng = ServingEngine(model, block_size=bs, num_blocks=200,
                            max_batch=4, max_seq_len=1552,
                            chunked_prefill=budget, device="cuda")
        drive(eng, residents, long_req, 5)          # warm: the same shapes
        res, steps = drive(eng, residents, long_req, 5)
        bf16_checked(res, residents + [long_req], vocab)
        cold += eng.n_prefills
        tail = steps[5:]
        chunked[budget] = {"max_step_ms": max(tail),
                           "p99_step_ms": percentile(tail, 99),
                           "p50_step_ms": percentile(tail, 50),
                           "iterations": len(steps),
                           "equal_to_off": equal_outputs(np, res, base)}
        base = res
        del eng
    torch.cuda.empty_cache()

    # -- speculative: 8 requests of 8-16 tokens x 64 new ---------------------
    r9 = np.random.default_rng(9)
    spec_reqs = [Request(rid=f"s{i}", prompt_ids=r9.integers(
        0, vocab, int(r9.integers(8, 17))), max_new_tokens=64)
        for i in range(8)]
    dm = draft_model(GPTForCausalLM, gpt3_1p3b, model)
    spec, base = [], None
    for name, gamma, drafter in (("off", 0, None), ("ngram", 2, None),
                                 ("ngram", 4, None), ("ngram", 6, None),
                                 ("model", 2, ModelDrafter(dm))):
        eng = ServingEngine(model, block_size=bs, num_blocks=64,
                            max_batch=8, max_seq_len=96, speculative=gamma,
                            drafter=drafter, device="cuda")
        eng.serve(spec_reqs)                        # warm: the same trace
        d0 = len(eng.decode_ms)
        t0 = time.perf_counter()
        res = eng.serve(spec_reqs)
        wall = time.perf_counter() - t0
        bf16_checked(res, spec_reqs, vocab)
        cold += eng.n_prefills
        steps = eng.decode_ms[d0:]
        row = {"drafter": name, "gamma": gamma,
               "tokens_per_s": 8 * 64 / wall, "wall_s": wall,
               "timed_steps": len(steps),
               "step_p50_ms": percentile(steps, 50),
               "equal_to_off": equal_outputs(np, res, base)}
        if gamma:
            rep = eng.spec_report()
            row.update({k: rep[k] for k in (
                "accept_rate", "mean_accept_len", "tokens_per_verify",
                "iterations")})
            row["speedup"] = row["tokens_per_s"] / spec[0]["tokens_per_s"]
        spec.append(row)
        if not gamma:
            base = res
        del eng
    del dm
    best = max((r for r in spec if r["drafter"] == "ngram"),
               key=lambda r: r["tokens_per_s"])
    # the best gamma round trip through a temporary autotune cache
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    old = autotune._cache
    flags.set_flags({"kernel_autotune_cache_path":
                     os.path.join(tmp, "autotune.json")})
    autotune._cache = None
    try:
        store_gamma(serving_engine._model_desc(model.cfg), "ngram",
                    best["gamma"],
                    measured_ms=1e3 / best["tokens_per_s"])
        read = ServingEngine(model, block_size=bs, num_blocks=64,
                             max_batch=8, max_seq_len=96, speculative=-1,
                             device="cuda").spec_gamma
    finally:
        flags.set_flags({"kernel_autotune_cache_path": ""})
        autotune._cache = old
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)
    check(read == best["gamma"],
          f"speculative=-1 read gamma {read}, stored {best['gamma']}")
    torch.cuda.empty_cache()

    delta = count_delta(before, path_counts(hfa, hfp, hc, fmb),
                        "flash_fwd_tc", "serve_tiers (bf16)")
    check(delta["flash_fwd_tc"] == cold * n_layers,
          f"serve_tiers bf16: {delta['flash_fwd_tc']} launches of K1's "
          f"tensor-core body for {cold} cold one-shot prefills")
    emit({"phase": "serve_tiers", "part": "bf16", "model": "gpt3_1p3b",
          "layers": n_layers, "block_size": bs, "card": smi_line,
          "k1_launches": delta["flash_fwd_tc"], "cold_prefills": cold,
          "prefix": {"prompt": plen, "new_tokens": new, "users": users,
                     "max_batch": 4, "curve": curve},
          "chunked": {"residents": "3 x 64 tokens x 64 new",
                      "long_prompt": 1536, "arrives_at_iteration": 5,
                      "budget_0": chunked[0], "budget_256": chunked[256]},
          "speculative": {"requests": "8 x 8-16 tokens x 64 new",
                          "arms": spec, "best_ngram_gamma": best["gamma"],
                          "autotune_read_back": read}})
    return delta


def device_profile(prof, wall_ms):
    """Device busy time (the union of the GPU events' intervals) over the
    host wall clock of the window, and the kernels that took it."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_events": len(spans),
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            "top_device_ms": [[name[:90], ms] for name, ms in top]}


def phase_profile(torch, np, model, Request, ServingEngine, num_blocks):
    """``--profile``: the bf16 trace once more under torch.profiler; the
    window is the host wall clock around ``serve``."""
    from torch.profiler import ProfilerActivity, profile
    reqs = bf16_trace(np, Request, model.cfg.vocab_size)
    max_seq = max(r.prompt_ids.size for r in reqs) + 32
    engine = ServingEngine(model, block_size=16, num_blocks=num_blocks,
                           max_batch=8, max_seq_len=max_seq, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "profile", **device_profile(prof, wall_ms),
          "prefill_s": engine.prefill_s,
          "decode_s": sum(engine.decode_ms) / 1e3})


# -- phases 10 and 11 --------------------------------------------------------

def gpt_loss(model, batch):
    ids, labels = batch
    return model(ids, labels)


def phase_train_grad_f32(torch, np, hfa, GPTForCausalLM, gpt3_1p3b):
    """A 2-layer cut of GPT-3 1.3B at full width, f32 (TF32 off): the same
    weights and batch through one forward and backward on the card (K1, K2,
    K3) and on the CPU (their plain versions), every gradient compared."""
    cfg = gpt3_1p3b(num_layers=2)
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=0)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(5)
    b, s = 2, 320
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    labels = np.roll(ids, -1, axis=1)
    labels[0, :7] = -100
    labels[1, -5:] = -100
    # f32 reaches K1's, K2's and K3's CUDA-core bodies (flash_fwd.cu,
    # flash_bwd.cu) and none of their tensor-core bodies
    for name in K1_K3_KERNELS:
        getattr(hfa, name).launches = 0
    losses = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        loss = model(torch.as_tensor(ids, device=model.device),
                     torch.as_tensor(labels, device=model.device))
        loss.backward()
        losses[name] = (float(loss.detach()), time.perf_counter() - t0)
    counts = {n: getattr(hfa, n).launches for n in K1_K3_KERNELS}
    launches = [counts[n] for n in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")]
    check(counts == {n: 2 * int(not n.endswith("_tc"))
                     for n in K1_K3_KERNELS},
          f"train_grad_f32: K1/K2/K3 launches {counts}, expected 2 each "
          f"of the CUDA-core bodies")
    worst_name, worst_ratio, rows = None, 0.0, 0
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        g_gpu = p.grad.float().cpu()
        g_cpu = cpu_params[name].grad.float()
        check(bool(torch.isfinite(g_gpu).all()), f"{name}: non-finite grad")
        scale = float(g_cpu.abs().max())
        ratio = float((g_gpu - g_cpu).abs().max()) / max(scale, 1e-30)
        rows += 1
        if ratio >= worst_ratio:
            worst_name, worst_ratio = name, ratio
    loss_err = abs(losses["gpu"][0] - losses["cpu"][0])
    row = {"phase": "train_grad_f32", "model": "gpt3_1p3b", "layers": 2,
           "batch": [b, s], "ignored_labels": int((labels == -100).sum()),
           "loss_gpu": losses["gpu"][0], "loss_cpu": losses["cpu"][0],
           "loss_abs_err": loss_err, "gpu_s": losses["gpu"][1],
           "cpu_s": losses["cpu"][1], "grad_tensors": rows,
           "worst_tensor": worst_name, "worst_rel_err": worst_ratio,
           "launches_k1_k2_k3": launches,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(row)
    # f32 on both sides, sums in other orders (cuBLAS, the kernels' tiles)
    check(loss_err <= 1e-4, f"train_grad_f32: loss differs: {row}")
    check(worst_ratio <= 1e-3, f"train_grad_f32: gradients differ: {row}")
    del gpu, cpu
    return counts


def bench_batches(np, n, batch, seq, vocab):
    """bench.py's ``_gpt_batches`` (``:1419-1431``): distinct random ids,
    labels the ids shifted by one (seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (batch, seq))
        out.append((ids.astype(np.int32),
                    np.roll(ids, -1, axis=1).astype(np.int32)))
    return out


def phase_train_bf16(torch, np, hfa, peaks, GPTForCausalLM, gpt3_1p3b,
                     amp, AdamW, make_sharded_train_step, profile=False,
                     rate0_p50=None, recompute=False,
                     policy="dots_and_flash_saveable", warmup=2, timed=8,
                     after=None):
    """The training slice: GPT-3 1.3B at full depth, AMP-O2, AdamW with
    f32 masters, B=4 x S=2048, ``warmup`` warm-up and ``timed`` timed
    steps; with ``recompute`` under ``policy``, the phase
    train_recompute_bf16, beside train_bf16's row from ``rate0_p50``.
    ``after(step, batches)`` runs on the trained step before it is freed.
    Returns the row and the K1-K3 launches."""
    batch, seq = 4, 2048
    cfg = gpt3_1p3b(recompute=recompute, recompute_policy=policy)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01, multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2")
    step = make_sharded_train_step(model, opt, gpt_loss)
    n_params = sum(p.numel() for p in model.parameters())
    batches = bench_batches(np, warmup + timed, batch, seq, cfg.vocab_size)
    it = iter(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts are set to 0 just before it and read after
    for name in K1_K3_KERNELS:
        getattr(hfa, name).launches = 0
    losses, times = timed_steps(torch, lambda: step.step(next(it)), warmup,
                                timed)
    launches = {n: getattr(hfa, n).launches for n in K1_K3_KERNELS}
    extra = {"amp": "O2", "optimizer": "AdamW(1e-4, weight_decay=0.01, "
             "multi_precision=True)", "warmup_steps": warmup,
             "timed_steps": timed}
    base = (rate0_p50 or {}).get("gpt_row")
    if recompute:
        extra["recompute_policy"] = policy
        extra.update({f"train_bf16_{k}": base[k] for k in (
            "step_p50_ms", "tokens_per_s", "mfu",
            "max_memory_allocated_gb")})
        # the same seed and batches as train_bf16: its losses again, if
        # the products round as they did there
        extra["losses_equal_train_bf16"] = \
            losses == base["losses"][:len(losses)]
    row = gpt_step_row(torch, "train_recompute_bf16" if recompute else
                       "train_bf16", cfg, n_params, peaks, batch, seq,
                       losses, times, launches, extra)
    emit(row)
    if rate0_p50 is not None and not recompute:
        rate0_p50["gpt"] = row["step_p50_ms"]
        rate0_p50["gpt_row"] = row
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {row}")
    # tied logits at init have sigma = sqrt(2048) * 0.02 ~ 0.9: the first
    # loss is about ln(50304) + sigma^2 / 2 ~ 11.2
    check(abs(losses[0] - 11.2) < 0.5, f"step-0 loss {losses[0]}")
    check(losses[-1] < losses[0], f"the loss did not decrease: {losses}")
    if not recompute:
        for name, n in launches.items():
            # bf16 at head dim 128 reaches only the tensor-core bodies
            want = cfg.num_layers * len(losses) if name.endswith("_tc") \
                else 0
            check(n == want, f"{name}: {n} launches in {len(losses)} steps "
                             f"of {cfg.num_layers} layers; expected {want}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for bt in batches[:3]:
                step.step(bt)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        emit({"phase": "profile_train", "steps": 3,
              **device_profile(prof, wall_ms)})
    if after is not None:
        after(step, batches)
    del model, opt, step
    torch.cuda.empty_cache()
    return row, launches


# -- phases 12 and 13 --------------------------------------------------------

#: K1's two bodies (flash_fwd: float32, flash_fwd_tc: bf16), K2's and K3's
#: two each (the CUDA-core ones, and ``_tc``: bf16 at head dims 64 and 128)
K1_K3_KERNELS = ("flash_fwd", "flash_fwd_tc") + K2_K3_KERNELS
#: the K4 forms, each of their bodies
K4_KERNELS = K4_DIRECT_KERNELS + STREAM_KERNELS
ATTENTION_KERNELS = K1_K3_KERNELS + K4_KERNELS


def k4_counts(hfa, hfp):
    """Every attention kernel's launch count (K1's two bodies, K2, K3 and
    all six K4 forms, the two bodies of K4a-direct and K4a-stream
    apart)."""
    return {name: getattr(hfa if hasattr(hfa, name) else hfp, name).launches
            for name in ATTENTION_KERNELS}


def zero_counts(hfa, hfp):
    for name in ATTENTION_KERNELS:
        getattr(hfa if hasattr(hfa, name) else hfp, name).launches = 0


def grad_rel_errs(torch, gpu, cpu):
    """Every gradient of ``gpu``'s parameters against ``cpu``'s, each as its
    largest difference over its largest |value|: ``(worst tensor, its
    ratio, the key biases' worst ratio, tensors compared)``. Softmax
    ignores a constant added to all of a row's scores, so the key bias's
    true gradient is 0 and both sides hold rounding noise: it is measured
    on the scale of the key weight's gradient."""
    worst_name, worst_ratio, key_bias_ratio, rows = None, 0.0, 0.0, 0
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        g_gpu = p.grad.float().cpu()
        g_cpu = cpu_params[name].grad.float()
        check(bool(torch.isfinite(g_gpu).all()), f"{name}: non-finite grad")
        key_bias = name.endswith("k_proj.bias")
        scale = float((cpu_params[name[:-4] + "weight"].grad if key_bias
                       else g_cpu).abs().max())
        ratio = float((g_gpu - g_cpu).abs().max()) / max(scale, 1e-30)
        rows += 1
        if key_bias:
            key_bias_ratio = max(key_bias_ratio, ratio)
        if ratio >= worst_ratio:
            worst_name, worst_ratio = name, ratio
    return worst_name, worst_ratio, key_bias_ratio, rows


def phase_train_grad_f32_bert(torch, np, hfa, hfp, BertForPretraining,
                              bert_base, attention_dropout=0.0,
                              phase="train_grad_f32_bert"):
    """A 2-layer cut of BERT-base at full width (hidden 768, 12 heads,
    vocab 30522), f32, B=2 x S=512 with bench.py's padding: the same weights
    and batch through one forward and backward on the card (K4a, K4b) and
    on the CPU (their plain versions), every gradient compared. With
    ``attention_dropout`` both runs draw their seeds in one ``rng_scope``:
    the hash does not depend on the device (hidden dropout's generators
    do, so it stays 0)."""
    from paddle_tpu_torch.core.random import make_key, rng_scope
    cfg = bert_base(num_layers=2, hidden_dropout=0.0,
                    attention_dropout=attention_dropout)
    gpu = BertForPretraining(cfg, device="cuda", seed=0)
    cpu = BertForPretraining(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    b, s = 2, 512
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    lengths = np.array([s, 300])
    att = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    labels = np.where(att == 1, rng.integers(0, cfg.vocab_size, (b, s)),
                      -100)
    sop = rng.integers(0, 2, (b, 1))
    before = k4_counts(hfa, hfp)
    losses = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        args = [torch.as_tensor(x, device=model.device)
                for x in (ids, att, labels, sop)]
        with rng_scope(make_key(2024)):
            loss = model(args[0], None, args[1], args[2], args[3])
        loss.backward()
        losses[name] = (float(loss.detach()), time.perf_counter() - t0)
    launches = {n: c - before[n] for n, c in k4_counts(hfa, hfp).items()}
    check(launches == {**{n: 0 for n in ATTENTION_KERNELS},
                       "flash_packed_fwd": 2, "flash_packed_bwd": 2},
          f"{phase}: launches {launches}")
    worst_name, worst_ratio, key_bias_ratio, rows = grad_rel_errs(
        torch, gpu, cpu)
    loss_err = abs(losses["gpu"][0] - losses["cpu"][0])
    row = {"phase": phase, "model": "bert_base", "layers": 2,
           "attention_dropout": attention_dropout, "hidden_dropout": 0.0,
           "batch": [b, s], "real_tokens": int(att.sum()),
           "loss_gpu": losses["gpu"][0], "loss_cpu": losses["cpu"][0],
           "loss_abs_err": loss_err, "gpu_s": losses["gpu"][1],
           "cpu_s": losses["cpu"][1], "grad_tensors": rows,
           "worst_tensor": worst_name, "worst_rel_err": worst_ratio,
           "key_bias_rel_err": key_bias_ratio, "launches": launches,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(row)
    # f32 on both sides, sums in other orders (cuBLAS, the kernels' tiles)
    check(loss_err <= 1e-4, f"{phase}: loss differs: {row}")
    check(worst_ratio <= 1e-3, f"{phase}: gradients differ: {row}")
    del gpu, cpu
    return launches


def bert_batches(np, batch, seq, vocab):
    """bench.py's three BERT batches (``:579-583``, ``:603-609``,
    ``:626-650``): dense ids, labels and sop from ``default_rng(0)``; the
    padded form's attention mask, with labels -100 at the pads; the packed
    form, the same real tokens packed greedily first-fit into fewer rows
    (bench.py fills every segment from row 0's tokens), with segment ids
    (0 at the pads, which attend to each other and carry label -100)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    sop = rng.integers(0, 2, (batch, 1)).astype(np.int32)
    lengths, att = bert_padded(np, batch, seq)
    pl_labels = np.where(att, labels, -100).astype(np.int32)
    rows, row, used, srow, snext = [], [], 0, [], 1
    for ln in lengths:
        if used + ln > seq:
            rows.append((row, srow))
            row, srow, used, snext = [], [], 0, 1
        row.append(int(ln))
        srow.append(snext)
        used += int(ln)
        snext += 1
    if row:
        rows.append((row, srow))
    pk_ids = np.zeros((len(rows), seq), np.int32)
    pk_seg = np.zeros((len(rows), seq), np.int32)
    pk_lab = np.full((len(rows), seq), -100, np.int32)
    for r, (lens, segs) in enumerate(rows):
        off = 0
        for ln, sg in zip(lens, segs):
            pk_ids[r, off:off + ln] = ids[0, :ln]
            pk_seg[r, off:off + ln] = sg
            pk_lab[r, off:off + ln] = labels[0, :ln]
            off += ln
    return {"dense": (ids, labels, sop),
            "padded": (ids, att.astype(np.int32), pl_labels),
            "packed": (pk_ids, pk_seg, pk_lab)}, int(att.sum())


def bert_loss(form):
    """The loss bench.py takes in each form (``functional_call`` of the
    model with these arguments)."""
    if form == "dense":
        return lambda m, bt: m(bt[0], None, None, bt[1], bt[2])
    if form == "padded":
        return lambda m, bt: m(bt[0], None, bt[1], bt[2], None)
    return lambda m, bt: m(bt[0], None, None, bt[2], None,
                           packed_segment_ids=bt[1])


def phase_train_bert_bf16(torch, np, hfa, hfp, peaks, BertForPretraining,
                          bert_base, amp, AdamW, make_sharded_train_step,
                          profile=False, rate0_p50=None):
    """The BERT slice: BERT-base at 12 layers, AMP-O2, AdamW with f32
    masters, B=64 x S=512 in bench.py's dense (2 warm-up and 8 timed
    steps), padded and packed (2 + 4 each) forms, in that order, training
    one model on as bench.py does; every step runs K4a and K4b once per
    layer and no K1-K3."""
    batch, seq = 64, 512
    cfg = bert_base(max_position_embeddings=512, hidden_dropout=0.0,
                    attention_dropout=0.0)
    model = BertForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01, multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2")
    batches, real = bert_batches(np, batch, seq, cfg.vocab_size)
    h, L = cfg.hidden_size, cfg.num_layers
    # the products 6·(L(4h² + 2h·ffn) + h² + h·V) (encoder, pooler or MLM
    # transform, tied MLM head) and non-causal attention 12·L·S·h, per token
    flops_per_token = 6 * (L * (4 * h * h + 2 * h * cfg.intermediate_size)
                           + h * h + h * cfg.vocab_size) + 12 * L * seq * h
    # one step, and so one optimizer state, through the three forms
    step = make_sharded_train_step(model, opt, bert_loss("dense"))
    out, launches_all = {}, {}
    for form, warmup, timed in (("dense", 2, 8), ("padded", 2, 4),
                                ("packed", 2, 4)):
        step.loss_fn = bert_loss(form)
        bt = batches[form]
        rows_, n_real = bt[0].shape[0], (batch * seq if form == "dense"
                                         else real)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path of this form: counts set to 0 just before, read after
        zero_counts(hfa, hfp)
        losses, times = [], []
        for i in range(warmup + timed):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step.step(bt)
            end.record()
            end.synchronize()
            losses.append(float(loss))
            if i >= warmup:
                times.append(start.elapsed_time(end))
        launches = k4_counts(hfa, hfp)
        n_steps = warmup + timed
        secs = sum(times) / 1e3
        tokens_per_s = timed * rows_ * seq / secs
        clocks = card_clocks()   # right after the timed steps
        row = {"phase": "train_bert_bf16", "clocks": clocks,
               "form": form, "model": "bert_base",
               "layers": L, "batch": [rows_, seq], "amp": "O2",
               "optimizer": "AdamW(1e-4, weight_decay=0.01, "
                            "multi_precision=True)",
               "losses": losses, "warmup_steps": warmup,
               "timed_steps": timed, "step_ms": times,
               "step_p50_ms": percentile(times, 50),
               "step_p99_ms": percentile(times, 99),
               "tokens_per_s": tokens_per_s,
               "real_tokens_per_step": n_real,
               "real_tokens_per_s": timed * n_real / secs,
               "flops_per_token": flops_per_token,
               "mfu": flops_per_token * tokens_per_s / peaks["bf16"],
               "peak_sheet": peaks["sheet"],
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches}
        emit(row)
        check(all(math.isfinite(x) for x in losses), f"non-finite: {row}")
        check(losses[-1] < losses[0], f"the loss did not decrease: {row}")
        for name in ("flash_packed_fwd_tc", "flash_packed_bwd_tc"):
            check(launches[name] == L * n_steps,
                  f"{form}: {name} launched {launches[name]} times in "
                  f"{n_steps} steps of {L} layers")
        # bf16 never reaches K4a-direct's or K4b-fused's float32 body
        for name in K1_K3_KERNELS + ("flash_packed_fwd",
                                     "flash_packed_bwd") + STREAM_KERNELS:
            check(launches[name] == 0,
                  f"{form}: {name} launched {launches[name]} times")
        out[form] = row
        if form == "dense" and rate0_p50 is not None:
            rate0_p50["bert"] = row["step_p50_ms"]
        for name, n in launches.items():
            launches_all[name] = launches_all.get(name, 0) + n
    # ln(30522) + ln 2 at init; the logits' spread adds about sigma^2 / 2
    first = out["dense"]["losses"][0]
    check(10.5 <= first <= 11.8, f"BERT step-0 dense loss {first}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        step.loss_fn = bert_loss("dense")
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                step.step(batches["dense"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        emit({"phase": "profile_train_bert", "form": "dense", "steps": 3,
              **device_profile(prof, wall_ms)})
    return launches_all


# -- phases 7, 14 and 15 -----------------------------------------------------

# name, kind, N, H, W, Cin, Cout, stride, act (None: no prologue), stats, dtype
CONV_CASES = [
    ("1x1_56_256to64_relu", "conv1x1", 8, 56, 56, 256, 64, 1, "relu", True,
     "bf16"),
    ("1x1_56_64to256_none", "conv1x1", 8, 56, 56, 64, 256, 1, "none", True,
     "bf16"),
    ("1x1_28_no_prologue_no_stats", "conv1x1", 4, 28, 28, 128, 512, 1, None,
     False, "bf16"),
    ("1x1_s2_56to28_downsample", "conv1x1", 8, 56, 56, 256, 512, 2, None,
     True, "bf16"),
    ("3x3_56_64to64_relu", "conv3x3", 8, 56, 56, 64, 64, 1, "relu", True,
     "bf16"),
    ("3x3_s2_56to28_relu", "conv3x3", 8, 56, 56, 128, 128, 2, "relu", True,
     "bf16"),
    ("3x3_7x7_m147_ragged", "conv3x3", 3, 7, 7, 512, 512, 1, "relu", True,
     "bf16"),
    ("3x3_s2_14to7_no_stats", "conv3x3", 5, 14, 14, 256, 256, 2, "none",
     False, "bf16"),
    # 16 bits with C and K not whole 8-value pieces (K8's element-by-element
    # copies and prologue) on a 9x7 image at stride 2
    ("3x3_s2_9x7_c20_k36_ragged", "conv3x3", 3, 9, 7, 20, 36, 2, "relu",
     True, "bf16"),
    ("f32_1x1_s2_9to5_ragged", "conv1x1", 3, 9, 9, 40, 72, 2, "relu", True,
     "f32"),
    ("f32_3x3_s2_9to5_ragged", "conv3x3", 3, 9, 9, 40, 72, 2, "none", True,
     "f32"),
    ("f32_3x3_14_no_prologue", "conv3x3", 2, 14, 14, 64, 64, 1, None, True,
     "f32"),
    # ResNet-50 at B=256: the convs that JAX's 16 MB VMEM rule sends to lax
    ("b256_3x3_s2_14to7_512", "conv3x3", 256, 14, 14, 512, 512, 2, "relu",
     True, "bf16"),
    ("b256_1x1_s2_14to7_1024to2048", "conv1x1", 256, 14, 14, 1024, 2048, 2,
     None, True, "bf16"),
    ("b256_3x3_7_512", "conv3x3", 256, 7, 7, 512, 512, 1, "relu", True,
     "bf16"),
    # layer1's 64->64 1x1 at B=256: K6 splits M 1,004 ways, two passes of
    # the fixed-order reduction
    ("b256_1x1_56_64to64_relu", "conv1x1", 256, 56, 56, 64, 64, 1, "relu",
     True, "bf16"),
    # K7's stride-2 input gradient by phases on odd sizes: a 7-row input
    # (dy 4 rows, the odd phase 3), a 1-row one (its odd phase empty), and
    # channels that are not whole 16-byte pieces
    ("3x3_s2_7x7_odd_phases", "conv3x3", 4, 7, 7, 64, 72, 2, "relu", True,
     "bf16"),
    ("3x3_s2_1x5_empty_phase", "conv3x3", 3, 1, 5, 16, 24, 2, None, True,
     "bf16"),
    ("3x3_s2_15x11_c20_k36_ragged", "conv3x3", 2, 15, 11, 20, 36, 2, "none",
     False, "bf16"),
]

CONV_KERNELS = ("mm", "mm_wgrad", "c3", "c3_wgrad")
# the conv.cu bodies behind each wrapper, by dtype, and the yardsticks that
# keep the bodies they had before
CONV_BODIES = {
    "mm": "conv1x1_tc_kernel (bf16, float16: the forward and the 1x1 input "
          "gradient); conv1x1_kernel (float32, and the 16-bit yardstick "
          "mm_tiles64)",
    "mm_wgrad": "conv1x1_wgrad_tc_kernel (bf16, float16); "
                "conv1x1_wgrad_kernel (float32, and the 16-bit yardstick "
                "mm_wgrad_tiles64)",
    "c3": "conv3x3_tc_kernel (bf16, float16: the forward, the stride-1 "
          "input gradient, and the stride-2 one by phases); conv3x3_kernel "
          "(float32, and the 16-bit yardstick c3_tap_gather)",
    "c3_wgrad": "conv3x3_wgrad_tc_kernel (bf16, float16); "
                "conv3x3_wgrad_kernel (float32, and the 16-bit yardstick "
                "c3_wgrad_tap_blocks)"}


def conv_counts(hc):
    return {name: getattr(hc, name).launches for name in CONV_KERNELS}


def zero_conv_counts(hc):
    for name in CONV_KERNELS:
        getattr(hc, name).launches = 0


def compare_sum(torch, name, got, ref, scale, row):
    """An f32 sum against its plain version, within 1e-4 of ``scale``: the
    sums run over up to 802,816 rows (stats, weight gradients) in other
    orders, and each is at most ``scale`` in size (the largest |value| for
    sums of squares and gradients; sqrt(M·sumsq) for a sum that cancels).
    Returns the max error."""
    check(got.shape == ref.shape and got.dtype == ref.dtype == torch.float32,
          f"{name}: {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = float((got - ref).abs().max())
    row.update({f"max_abs_err_{name}": err, f"scale_{name}": scale})
    row["ok"] = row.get("ok", True) and err <= 1e-4 * scale
    return err


def hold_conv(torch, part, got, ref, dt, row, stats=False):
    """One K5-K8 call's outputs against its plain version's, logged in
    ``row``: ``part`` "fwd" (y and, with ``stats``, the f32 (sum, sumsq)
    from K5/K7's multi-pass reduction; zeros without), "dgrad" (dx) or
    "wgrad" (K6/K8's split-K dw, f32). Returns ``(the output elements' max
    abs error, the stats' max error over their scale or None)``."""
    if part == "wgrad":
        return compare_sum(torch, "dw", got, ref, float(ref.abs().max()),
                           row), None
    if part == "dgrad":
        return compare(torch, "dx", got[0], ref[0], dt, row), None
    (y, st, sst), (ry, rs, rss) = got, ref
    err = compare(torch, "y", y, ry, dt, row)
    if not stats:
        row["ok"] &= float(st.abs().max()) == float(sst.abs().max()) == 0.0
        return err, None
    m = y.numel() // y.shape[-1]
    rel = max(compare_sum(torch, "s", st, rs,
                          float((m * rss).sqrt().max()), row) / row["scale_s"],
              compare_sum(torch, "ss", sst, rss, float(rss.max()), row) /
              row["scale_ss"])
    row["stats_rel_err"] = rel
    return err, rel


def conv_plan(hc, n, ho, wo, cin, cout, k, dt="bf16", stride=1):
    """How the kernels cut a conv with ``n·ho·wo`` output pixels: K5/K7's
    row blocks (in 16 bits K5's row tiles, ``k5_plan``, and K7's bands,
    ``c3_bands``), whose stats partials the reduction sums in 256-row
    passes, and K6/K8's split of M (``_wgrad_launch``; in 16 bits K6's tile
    and split, ``k6_plan``, and K8's bands, ``wgrad_bands``)."""
    m = n * ho * wo
    tiles = k * k * -(-cin // 64) * -(-cout // 64)
    plan = {"fwd_blocks": -(-m // hc._FWD_ROWS),
            "wgrad_splits": hc.wgrad_splits(m, tiles)[0]}
    if k == 3 and dt != "f32":
        bands = hc.wgrad_bands(n, ho, wo, cin, cout, stride)
        fwd = hc.c3_bands(n, ho, wo, stride)
        plan.update({"fwd_blocks": fwd.bands, "k7_bands": fwd._asdict(),
                     "wgrad_splits": bands.splits,
                     "wgrad_bands": bands._asdict()})
    if k == 1 and dt != "f32":
        pl = hc.k6_plan(m, cin, cout)
        fwd = hc.k5_plan(m, cin, cout)
        plan.update({"fwd_blocks": fwd.tiles_m, "k5_plan": fwd._asdict(),
                     "k5_dgrad_plan": hc.k5_plan(m, cout, cin)._asdict(),
                     "wgrad_splits": pl.splits, "k6_plan": pl._asdict()})
    return plan


def dgrad_parts(hc, dy, wgt, x_shape, s, dt):
    """K7's input gradient as the path runs it, and its plain version:
    ``(kernel, plain, args)`` with 1-tuples out. At stride 2 in 16 bits the
    four phases of one launch (``c3_dgrad_phases``; plain
    ``c3_dgrad_phases_reference``), else the stride-1 conv of the (dilated
    in float32) operand (``c3``; plain ``c3_reference``)."""
    n, h, w, _ = x_shape
    if s == 2 and dt != "f32":
        return (lambda *a: (hc.c3_dgrad_phases(*a),),
                lambda *a: (hc.c3_dgrad_phases_reference(*a),),
                (dy, hc.dgrad_taps(wgt, dy.dtype), (h, w)))
    op, wm = hc.dgrad_operands(dy, wgt, s)
    return hc.c3, hc.c3_reference, (op, wm, None, None, "none", False, 1,
                                    (h, w))


def hold_dilated(torch, hc, got, dy, wgt, x_shape, dt, row):
    """A stride-2 input gradient by phases against ``c3_reference`` on
    ``dgrad_operands``' dilated dy (the parent's operand), within the same
    tolerance."""
    op, wm = hc.dgrad_operands(dy, wgt, 2)
    ref = hc.c3_reference(op, wm, None, None, "none", False, 1,
                          tuple(x_shape[1:3]))[0]
    sub = {}
    compare(torch, "dx", got, ref, dt, sub)
    row["max_abs_err_dx_dilated"] = sub["max_abs_err_dx"]
    row["ok"] &= sub["ok"]


def conv_case(torch, hc, case, g):
    """One case through K5/K7 (forward with its stats, and the input
    gradient) and K6/K8 (the weight gradient with the prologue), each
    against its plain version on the same inputs; one row of errors."""
    name, kind, n, h, w, cin, cout, s, act, stats, dt = case
    dtype = torch_dtype(torch, dt)
    k = 1 if kind == "conv1x1" else 3
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") *
                scale).to(dtype)

    x = randn(n, h, w, cin)
    wgt = randn(cout, cin, k, k, scale=(cin * k * k) ** -0.5)
    sc = None if act is None else randn(cin).float()
    sh = None if act is None else randn(cin).float()
    a = act or "none"
    dy = randn(n, ho, wo, cout)
    wt = hc.fwd_weight(wgt, dtype)
    op, wm = hc.dgrad_operands(dy, wgt, s)
    if k == 1:
        fwd = (hc.mm, hc.mm_reference, (x, wt[0], sc, sh, a, stats, s))
        dgrad = (hc.mm, hc.mm_reference, (op, wm[0], None, None, "none",
                                           False, 1))
        wgrad = (hc.mm_wgrad, hc.mm_wgrad_reference, (x, dy, sc, sh, a, s))
    else:
        fwd = (hc.c3, hc.c3_reference, (x, wt, sc, sh, a, stats, s))
        dgrad = dgrad_parts(hc, dy, wgt, x.shape, s, dt)
        wgrad = (hc.c3_wgrad, hc.c3_wgrad_reference, (x, dy, sc, sh, a, s))
    row = {"case": name, "shape": [n, h, w, cin, cout, k, s], "act": act,
           "stats": stats, "dtype": dt,
           **conv_plan(hc, n, ho, wo, cin, cout, k, dt, s)}
    errs = {}
    for part, (kern, plain, args) in (("fwd", fwd), ("dgrad", dgrad),
                                      ("wgrad", wgrad)):
        got = kern(*args)
        torch.cuda.synchronize()
        errs[part] = hold_conv(torch, part, got, plain(*args), dt, row,
                               stats)
        torch.cuda.synchronize()
        if part == "dgrad":
            # K7's dgrad gives the input's size; K5's the strided pixels,
            # which conv2d_dgrad scatters into zeros
            check(tuple(got[0].shape[1:3]) == ((h, w) if k == 3 else
                                               (ho, wo)),
                  f"{name}: dgrad shape {tuple(got[0].shape)}")
            if k == 3 and s == 2 and dt != "f32":
                hold_dilated(torch, hc, got[0], dy, wgt, x.shape, dt, row)
    check(row["ok"], f"K5-K8 disagree with their plain versions: {row}")
    fwd_name = "mm" if k == 1 else "c3"
    return row, {fwd_name: (max(errs["fwd"][0], errs["dgrad"][0]),
                            errs["fwd"][1]),
                 fwd_name + "_wgrad": errs["wgrad"]}


def conv_bound(peaks, flops, nbytes):
    t_ops = flops / peaks["bf16"] * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_kernel_conv(torch, hc, peaks):
    """K5-K8 against their plain versions in every case, then each kernel,
    its plain version and the library call timed at the JAX package's
    per-shape A/B shapes (``RESNET50_TOP3_SHAPES``, B=256, bf16, the
    prologue on with ReLU), where each kernel's outputs are held against
    the plain version's too. Returns, per kernel, the output elements' max
    abs error; for K5 and K7, the stats' max error over their scale; and
    the timings."""
    import torch.nn.functional as TF
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    results = []
    worst = {name: 0.0 for name in CONV_KERNELS}
    stats_rel = {"mm": 0.0, "c3": 0.0}

    def note(kname, err, rel):
        worst[kname] = max(worst[kname], err)
        if rel is not None:
            stats_rel[kname] = max(stats_rel[kname], rel)

    for case in CONV_CASES:
        row, errs = conv_case(torch, hc, case, g)
        results.append(row)
        for kname, (err, rel) in errs.items():
            note(kname, err, rel)

    timing = {}
    for kind, n, h, w, cin, cout, s in hc.RESNET50_TOP3_SHAPES:
        k = 1 if kind == "conv1x1" else 3
        pad = (k - 1) // 2
        bf = torch.bfloat16
        x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(bf)
        wgt = (torch.randn(cout, cin, k, k, generator=g, device="cuda") *
               (cin * k * k) ** -0.5).to(bf)
        sc = torch.randn(cin, generator=g, device="cuda")
        sh = torch.randn(cin, generator=g, device="cuda")
        dy = torch.randn(n, h, w, cout, generator=g, device="cuda").to(bf)
        wt = hc.fwd_weight(wgt, bf)
        op, wm = hc.dgrad_operands(dy, wgt, 1)
        # the library: cuDNN in channels-last on the prologued input,
        # without the prologue and the stats
        a_t = hc._prologue(x, sc, sh, "relu").permute(0, 3, 1, 2)
        dy_t = dy.permute(0, 3, 1, 2)
        w_cl = wgt.contiguous(memory_format=torch.channels_last)
        if k == 1:
            ops = {"mm": (hc.mm, hc.mm_reference,
                          (x, wt[0], sc, sh, "relu", True, 1),
                          lambda: TF.conv2d(a_t, w_cl)),
                   "mm_dgrad": (hc.mm, hc.mm_reference,
                                (op, wm[0], None, None, "none", False, 1),
                                lambda: torch.nn.grad.conv2d_input(
                                    a_t.shape, w_cl, dy_t)),
                   "mm_wgrad": (hc.mm_wgrad, hc.mm_wgrad_reference,
                                (x, dy, sc, sh, "relu", 1),
                                lambda: torch.nn.grad.conv2d_weight(
                                    a_t, wgt.shape, dy_t))}
        else:
            ops = {"c3": (hc.c3, hc.c3_reference,
                          (x, wt, sc, sh, "relu", True, 1),
                          lambda: TF.conv2d(a_t, w_cl, padding=pad)),
                   "c3_dgrad": (hc.c3, hc.c3_reference,
                                (op, wm, None, None, "none", False, 1,
                                 (h, w)),
                                lambda: torch.nn.grad.conv2d_input(
                                    a_t.shape, w_cl, dy_t, padding=pad)),
                   "c3_wgrad": (hc.c3_wgrad, hc.c3_wgrad_reference,
                                (x, dy, sc, sh, "relu", 1),
                                lambda: torch.nn.grad.conv2d_weight(
                                    a_t, wgt.shape, dy_t, padding=pad))}
        m = n * h * w
        act_bytes = {"in": m * cin * 2, "out": m * cout * 2}
        w_bytes, st_bytes = cin * cout * k * k * 2, 2 * cin * 4
        flops = 2 * m * cin * cout * k * k
        shape_key = f"{kind} {n}x{h}x{w} {cin}->{cout} s{s}"
        timing[shape_key] = {}
        plan = conv_plan(hc, n, h, w, cin, cout, k)
        for oname, (kern, plain, args, lib) in ops.items():
            part = oname.partition("_")[2] or "fwd"
            row = {"case": f"top3 {shape_key} {part}", "dtype": "bf16",
                   **plan}
            got = kern(*args)
            torch.cuda.synchronize()
            err, rel = hold_conv(torch, part, got, plain(*args), "bf16",
                                 row, stats=part == "fwd")
            del got
            check(row["ok"], f"K5-K8 disagree with their plain versions: "
                             f"{row}")
            results.append(row)
            note(oname.replace("_dgrad", ""), err, rel)
            if oname.endswith("dgrad"):     # dy and w in, dx out
                nbytes = act_bytes["out"] + w_bytes + act_bytes["in"]
            elif oname.endswith("wgrad"):   # x, dy, scale, shift in; dw f32
                nbytes = act_bytes["in"] + act_bytes["out"] + st_bytes + \
                    cin * cout * k * k * 4
            else:                           # x, w, scale, shift in; y, stats
                nbytes = act_bytes["in"] + w_bytes + st_bytes + \
                    act_bytes["out"] + 2 * cout * 4
            ms = median_ms(lambda: kern(*args))
            bound, by = conv_bound(peaks, flops, nbytes)
            timing[shape_key][oname] = {
                "kernel_ms": ms,
                "plain_ms": median_ms(lambda: plain(*args), iters=5,
                                      warmup=1),
                "library_ms": median_ms(lib), "flops": flops,
                "bytes": nbytes, "bound_ms": bound, "bound_by": by,
                "peak_sheet": peaks["sheet"],
                "tflops": flops / ms / 1e9}
    timing["k8_stages"] = k8_stages(torch, hc, peaks, g, results)
    timing["k7_stages"] = k7_stages(torch, hc, peaks, g, results)
    timing["k6_stages"] = k6_stages(torch, hc, peaks, g, results)
    timing["k5_stages"] = k5_stages(torch, hc, peaks, g, results)
    # the main path's reductions at B=256 (K5/K7's stats over 6,272 blocks
    # at 56², K6's dw over 1,004 splits for the 64->64 1x1) take more than
    # one 256-row pass: some compared case must too
    check(max(r["fwd_blocks"] for r in results if r.get("stats_rel_err")
              is not None) > 256 and
          max(r["wgrad_splits"] for r in results if "max_abs_err_dw" in r)
          > 256, "no compared case reaches the multi-pass reductions")
    emit({"phase": "kernel_conv", "kernels": list(CONV_KERNELS),
          "cases": results, "timing": timing,
          "library": "cuDNN through torch in channels-last bf16 on the "
                     "prologued input: F.conv2d, torch.nn.grad.conv2d_input, "
                     "torch.nn.grad.conv2d_weight; the library time has no "
                     "prologue and no stats"})
    for row in results:
        if row["case"].startswith(("k7 ", "k6 ", "k5 ")):
            kname = {"k7": "c3", "k6": "mm_wgrad", "k5": "mm"}[
                row["case"][:2]]
            note(kname, max(v for k_, v in row.items()
                            if k_.startswith("max_abs_err_d") or
                            k_ == "max_abs_err_y"), row.get("stats_rel_err"))
    top = list(timing.values())
    # K5's line: the 256->64 forward at 56² from k5_stages (five calls a
    # sample; the top-3 timing above takes one)
    k5_main = timing["k5_stages"]["shapes"]["1x1 256x56x56 256->64 s1"]
    return worst, stats_rel, {
        "mm": {**k5_main["fwd"], "dgrad": k5_main["dgrad"],
               "stages": timing["k5_stages"]},
        "mm_wgrad": {**top[0]["mm_wgrad"], "stages": timing["k6_stages"]},
        "c3": {**top[2]["c3"], "stages": timing["k7_stages"]},
        "c3_wgrad": {**top[2]["c3_wgrad"], "stages": timing["k8_stages"]}}


def k8_stages(torch, hc, peaks, g, results):
    """K8 at each of ResNet-50's 3x3 weight-gradient shapes (B=256, bf16,
    the ReLU prologue; ``RESNET50_K8_SHAPES``: the four stages at stride 1
    and the three stride-2 convs), held against its plain version and
    repeated bit for bit, then timed beside the body it had before (one
    block a tap, ``c3_wgrad_tap_blocks``, a yardstick no path runs), its
    bound, the plain version and cuDNN's weight gradient on the prologued
    input; with the launches a step each shape has, the step's K8 time in
    both bodies."""
    bf = torch.bfloat16
    stages = {}
    step = {"kernel_ms": 0.0, "parent_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0}
    for n, h, w, cin, cout, s, per_step in hc.RESNET50_K8_SHAPES:
        ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
        x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(bf)
        sc = torch.randn(cin, generator=g, device="cuda")
        sh = torch.randn(cin, generator=g, device="cuda")
        dy = torch.randn(n, ho, wo, cout, generator=g, device="cuda").to(bf)
        args = (x, dy, sc, sh, "relu", s)
        key = f"3x3 {n}x{h}x{w} {cin}->{cout} s{s}"
        row = {"case": f"k8 {key}", "dtype": "bf16",
               **conv_plan(hc, n, ho, wo, cin, cout, 3, "bf16", s)}
        bd = hc.wgrad_bands(n, ho, wo, cin, cout, s)
        smem = hc._library().paddle_conv3x3_wgrad_tc_smem(
            bd.band_n, bd.band_h, bd.band_w, s)
        check(smem == hc.k8_smem_bytes(bd.band_n, bd.band_h, bd.band_w, s),
              f"K8's shared memory {smem} is not conv.py's k8_smem_bytes")
        got = hc.c3_wgrad(*args)
        again = hc.c3_wgrad(*args)
        parent = hc.c3_wgrad_tap_blocks(*args)
        ref = hc.c3_wgrad_reference(*args)
        torch.cuda.synchronize()
        hold_conv(torch, "wgrad", got, ref, "bf16", row)
        row["repeat_bit_equal"] = bool(torch.equal(got, again))
        row["ok"] &= row["repeat_bit_equal"]
        row["max_abs_err_parent_body"] = float((parent - ref).abs().max())
        check(row["ok"], f"K8 disagrees with its plain version: {row}")
        results.append(row)
        del got, again, parent, ref
        a_t = hc._prologue(x, sc, sh, "relu").permute(0, 3, 1, 2)
        dy_t = dy.permute(0, 3, 1, 2)
        ms = median_ms(lambda: hc.c3_wgrad(*args))
        parent_ms = median_ms(lambda: hc.c3_wgrad_tap_blocks(*args))
        lib_ms = median_ms(lambda: torch.nn.grad.conv2d_weight(
            a_t, (cout, cin, 3, 3), dy_t, stride=s, padding=1))
        plain_ms = median_ms(lambda: hc.c3_wgrad_reference(*args), iters=5,
                             warmup=1)
        flops = 2 * 9 * n * ho * wo * cin * cout
        nbytes = (n * h * w * cin + n * ho * wo * cout) * 2 + 2 * cin * 4 + \
            9 * cin * cout * 4
        bound, by = conv_bound(peaks, flops, nbytes)
        stages[key] = {
            "shape": [n, h, w, cin, cout, 3, s], "launches_per_step": per_step,
            "kernel_ms": ms, "parent_body_ms": parent_ms,
            "library_ms": lib_ms, "plain_ms": plain_ms, "flops": flops,
            "bytes": nbytes, "bound_ms": bound, "bound_by": by,
            "tflops": flops / ms / 1e9, "bands": row["wgrad_bands"]}
        for k_, v_ in (("kernel_ms", ms), ("parent_ms", parent_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound)):
            step[k_] += per_step * v_
        del x, dy, a_t, dy_t, args
        torch.cuda.empty_cache()
    return {"shapes": stages, "per_step": step,
            "library": "torch.nn.grad.conv2d_weight (cuDNN, channels-last "
                       "bf16) on the prologued input"}


def add_step(step, per_step, times):
    for key, ms in times.items():
        step[key] = step.get(key, 0.0) + per_step * ms


def k7_stages(torch, hc, peaks, g, results):
    """K7 at each of ResNet-50's 3x3 shapes (B=256, the ReLU prologue and
    the stats; ``RESNET50_K7_SHAPES``): the forward and the input gradient
    (at stride 2 the four phases of one launch, also held against
    ``c3_reference`` on the dilated dy) against their plain versions in
    bf16 and float16, each repeated bit for bit; then, in bf16, each timed
    beside the body K7 had before (``c3_tap_gather``, a yardstick no path
    runs; its input gradient on ``dgrad_operands``' dilated dy, the
    parent's path), cuDNN (no prologue, no stats), its bound and the plain
    version; with the launches a step each shape has (16 forwards, 16
    input gradients), the step's sums."""
    import torch.nn.functional as TF
    stages = {}
    step = {}
    for n, h, w, cin, cout, s, per_step in hc.RESNET50_K7_SHAPES:
        ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
        key = f"3x3 {n}x{h}x{w} {cin}->{cout} s{s}"
        ent = {"shape": [n, h, w, cin, cout, 3, s],
               "launches_per_step": per_step}
        for dt in ("bf16", "f16"):
            dtype = torch_dtype(torch, dt)
            x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(
                dtype)
            wgt = (torch.randn(cout, cin, 3, 3, generator=g, device="cuda") *
                   (cin * 9) ** -0.5).to(dtype)
            sc = torch.randn(cin, generator=g, device="cuda")
            sh = torch.randn(cin, generator=g, device="cuda")
            dy = torch.randn(n, ho, wo, cout, generator=g,
                             device="cuda").to(dtype)
            wt = hc.fwd_weight(wgt, dtype)
            fargs = (x, wt, sc, sh, "relu", True, s)
            dk, dplain, dargs = dgrad_parts(hc, dy, wgt, x.shape, s, dt)
            for part, kern, plain, args in (("fwd", hc.c3, hc.c3_reference,
                                             fargs),
                                            ("dgrad", dk, dplain, dargs)):
                row = {"case": f"k7 {key} {part}", "dtype": dt,
                       **conv_plan(hc, n, ho, wo, cin, cout, 3, dt, s)}
                got = kern(*args)
                again = kern(*args)
                ref = plain(*args)
                torch.cuda.synchronize()
                err, rel = hold_conv(torch, part, got, ref, dt, row,
                                     stats=part == "fwd")
                if part == "dgrad" and s == 2:
                    hold_dilated(torch, hc, got[0], dy, wgt, x.shape, dt, row)
                row["repeat_bit_equal"] = all(
                    torch.equal(a, b) for a, b in zip(got, again))
                row["ok"] &= row["repeat_bit_equal"]
                check(row["ok"], f"K7 disagrees with its plain version: "
                                 f"{row}")
                results.append(row)
                ent[f"{part}_{dt}_max_abs_err"] = err
                if rel is not None:
                    ent[f"{part}_{dt}_stats_rel_err"] = rel
                del got, again, ref
            if dt == "f16":
                break
            a_t = hc._prologue(x, sc, sh, "relu").permute(0, 3, 1, 2)
            dy_t = dy.permute(0, 3, 1, 2)
            w_cl = wgt.contiguous(memory_format=torch.channels_last)
            flops = 2 * 9 * n * ho * wo * cin * cout
            io = {"fwd": (n * h * w * cin + n * ho * wo * cout) * 2 +
                  9 * cin * cout * 2 + 2 * cin * 4 + 2 * cout * 4,
                  "dgrad": (n * h * w * cin + n * ho * wo * cout) * 2 +
                  9 * cin * cout * 2}
            times = {
                "fwd": (lambda: hc.c3(*fargs),
                        lambda: hc.c3_tap_gather(*fargs),
                        lambda: TF.conv2d(a_t, w_cl, stride=s, padding=1),
                        lambda: hc.c3_reference(*fargs)),
                "dgrad": (lambda: hc.conv2d_dgrad(dy, wgt, x.shape, (s, s),
                                                  (1, 1)),
                          lambda: hc.c3_tap_gather(
                              *hc.dgrad_operands(dy, wgt, s), None, None,
                              "none", False, 1, (h, w)),
                          lambda: torch.nn.grad.conv2d_input(
                              a_t.shape, w_cl, dy_t, stride=s, padding=1),
                          lambda: dplain(*dargs))}
            for part, (new, parent, lib, plain) in times.items():
                ms = median_ms(new)
                bound, by = conv_bound(peaks, flops, io[part])
                t = {"kernel_ms": ms, "parent_ms": median_ms(parent),
                     "library_ms": median_ms(lib),
                     "plain_ms": median_ms(plain, iters=5, warmup=1),
                     "bound_ms": bound, "bound_by": by, "flops": flops,
                     "bytes": io[part], "tflops": flops / ms / 1e9}
                ent[part] = t
                add_step(step.setdefault(part, {}), per_step, {
                    k_: t[k_] for k_ in ("kernel_ms", "parent_ms",
                                         "library_ms", "bound_ms")})
            del a_t, dy_t, w_cl
        for kind, phases, bd in (("bands", 1, hc.c3_bands(n, ho, wo, s)),
                                 ("dgrad_bands", 4, hc.c3_bands(n, ho, wo,
                                                                2, 4))):
            if phases == 4 and s == 1:
                continue
            smem = hc._library().paddle_conv3x3_tc_smem(
                bd.band_n, bd.band_h, bd.band_w, s, phases)
            check(smem == hc.k7_smem_bytes(bd.band_n, bd.band_h, bd.band_w,
                                           s, phases),
                  f"K7's shared memory {smem} is not conv.py's "
                  f"k7_smem_bytes")
            ent[kind] = {**bd._asdict(), "smem_bytes": smem}
        stages[key] = ent
        del x, wgt, dy, wt, fargs, dargs
        torch.cuda.empty_cache()
    return {"shapes": stages, "per_step": step,
            "library": "cuDNN (channels-last bf16) on the prologued input: "
                       "F.conv2d and torch.nn.grad.conv2d_input"}


def k6_stages(torch, hc, peaks, g, results):
    """K6 at each of ResNet-50's 1x1 weight-gradient shapes (B=256, the
    ReLU prologue; ``RESNET50_K6_SHAPES``, 15 shapes, 36 launches a step)
    against its plain version in bf16 and float16, repeated bit for bit;
    then, in bf16, timed beside the body it had before
    (``mm_wgrad_tiles64``, a yardstick no path runs), cuDNN's weight
    gradient on the prologued input, its bound and the plain version, with
    the step's sums."""
    stages = {}
    step = {}
    for n, h, w, cin, cout, s, per_step in hc.RESNET50_K6_SHAPES:
        ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
        key = f"1x1 {n}x{h}x{w} {cin}->{cout} s{s}"
        ent = {"shape": [n, h, w, cin, cout, 1, s],
               "launches_per_step": per_step,
               "plan": hc.k6_plan(n * ho * wo, cin, cout)._asdict()}
        for dt in ("bf16", "f16"):
            dtype = torch_dtype(torch, dt)
            x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(
                dtype)
            sc = torch.randn(cin, generator=g, device="cuda")
            sh = torch.randn(cin, generator=g, device="cuda")
            dy = torch.randn(n, ho, wo, cout, generator=g,
                             device="cuda").to(dtype)
            args = (x, dy, sc, sh, "relu", s)
            row = {"case": f"k6 {key}", "dtype": dt,
                   **conv_plan(hc, n, ho, wo, cin, cout, 1, dt, s)}
            got = hc.mm_wgrad(*args)
            again = hc.mm_wgrad(*args)
            ref = hc.mm_wgrad_reference(*args)
            torch.cuda.synchronize()
            err, _ = hold_conv(torch, "wgrad", got, ref, dt, row)
            row["repeat_bit_equal"] = bool(torch.equal(got, again))
            row["ok"] &= row["repeat_bit_equal"]
            check(row["ok"], f"K6 disagrees with its plain version: {row}")
            results.append(row)
            ent[f"{dt}_max_abs_err"] = err
            del got, again, ref
            if dt == "f16":
                break
            a_t = hc._prologue(x, sc, sh, "relu").permute(0, 3, 1, 2)
            dy_t = dy.permute(0, 3, 1, 2)
            ms = median_ms(lambda: hc.mm_wgrad(*args))
            flops = 2 * n * ho * wo * cin * cout
            nbytes = (n * ho * wo * cin + n * ho * wo * cout) * 2 + \
                2 * cin * 4 + cin * cout * 4
            bound, by = conv_bound(peaks, flops, nbytes)
            t = {"kernel_ms": ms,
                 "parent_ms": median_ms(lambda: hc.mm_wgrad_tiles64(*args)),
                 "library_ms": median_ms(lambda: torch.nn.grad.conv2d_weight(
                     a_t, (cout, cin, 1, 1), dy_t, stride=s)),
                 "plain_ms": median_ms(lambda: hc.mm_wgrad_reference(*args),
                                       iters=5, warmup=1),
                 "bound_ms": bound, "bound_by": by, "flops": flops,
                 "bytes": nbytes, "tflops": flops / ms / 1e9,
                 "gbytes_per_s": nbytes / ms / 1e6}
            ent.update(t)
            add_step(step, per_step, {k_: t[k_] for k_ in (
                "kernel_ms", "parent_ms", "library_ms", "bound_ms")})
            del a_t, dy_t
        stages[key] = ent
        del x, dy, args
        torch.cuda.empty_cache()
    return {"shapes": stages, "per_step": step,
            "library": "torch.nn.grad.conv2d_weight (cuDNN, channels-last "
                       "bf16) on the prologued input"}


def k5_stages(torch, hc, peaks, g, results):
    """K5 at each of ResNet-50's 1x1 shapes (B=256; ``RESNET50_K5_SHAPES``,
    15 shapes, 36 forwards and 36 input gradients a step): the forward with
    the ReLU prologue and the stats at its stride, and ``conv2d_dgrad``'s
    1x1 call (``dy @ wᵀ`` over dy's pixels, no prologue, no stats), against
    ``mm_reference`` in bf16 and float16, each repeated bit for bit; then,
    in bf16, each timed beside the body K5 had before (``mm_tiles64``, a
    yardstick no path runs), cuDNN (channels-last, on the prologued input;
    no prologue, no stats), its bound and the plain version, with the
    step's sums for the forwards and the input gradients apart. A sample is
    five calls back to back (``reps``), for the kernel, the parent's body
    and cuDNN alike: one call's sample would add the wrapper's host time,
    40-110 µs, to kernels of 0.1-0.4 ms."""
    import torch.nn.functional as TF
    stages = {}
    step = {}
    lib = hc._library()
    for n, h, w, cin, cout, s, per_step in hc.RESNET50_K5_SHAPES:
        ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
        m = n * ho * wo
        key = f"1x1 {n}x{h}x{w} {cin}->{cout} s{s}"
        ent = {"shape": [n, h, w, cin, cout, 1, s],
               "launches_per_step": per_step}
        for part, c, k in (("fwd", cin, cout), ("dgrad", cout, cin)):
            pl = hc.k5_plan(m, c, k)
            pro = part == "fwd"
            smem = lib.paddle_conv1x1_tc_smem(pl.warps_m, pl.warps_n,
                                              pl.stages, c, int(pro))
            check(smem == hc.k5_smem_bytes(pl.warps_m, pl.warps_n, c, pro,
                                           pl.stages),
                  f"K5's shared memory {smem} is not conv.py's "
                  f"k5_smem_bytes")
            ent[f"{part}_plan"] = {**pl._asdict(), "smem_bytes": smem}
        for dt in ("bf16", "f16"):
            dtype = torch_dtype(torch, dt)
            x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(
                dtype)
            wgt = (torch.randn(cout, cin, 1, 1, generator=g, device="cuda") *
                   cin ** -0.5).to(dtype)
            sc = torch.randn(cin, generator=g, device="cuda")
            sh = torch.randn(cin, generator=g, device="cuda")
            dy = torch.randn(n, ho, wo, cout, generator=g,
                             device="cuda").to(dtype)
            op, wm = hc.dgrad_operands(dy, wgt, s)
            args = {"fwd": (x, hc.fwd_weight(wgt, dtype)[0], sc, sh, "relu",
                            True, s),
                    "dgrad": (op, wm[0], None, None, "none", False, 1)}
            for part, a in args.items():
                row = {"case": f"k5 {key} {part}", "dtype": dt,
                       **conv_plan(hc, n, ho, wo, cin, cout, 1, dt, s)}
                got = hc.mm(*a)
                again = hc.mm(*a)
                ref = hc.mm_reference(*a)
                torch.cuda.synchronize()
                err, rel = hold_conv(torch, "fwd", got, ref, dt, row,
                                     stats=part == "fwd")
                row["repeat_bit_equal"] = all(
                    torch.equal(a_, b_) for a_, b_ in zip(got, again))
                row["ok"] &= row["repeat_bit_equal"]
                check(row["ok"], f"K5 disagrees with its plain version: "
                                 f"{row}")
                results.append(row)
                ent[f"{part}_{dt}_max_abs_err"] = err
                if rel is not None:
                    ent[f"{part}_{dt}_stats_rel_err"] = rel
                del got, again, ref
            if dt == "f16":
                break
            a_t = hc._prologue(x, sc, sh, "relu").permute(0, 3, 1, 2)
            dy_t = dy.permute(0, 3, 1, 2)
            w_cl = wgt.contiguous(memory_format=torch.channels_last)
            flops = 2 * m * cin * cout
            io = {"fwd": (m * cin + m * cout + cin * cout) * 2 +
                  2 * cin * 4 + 2 * cout * 4,
                  "dgrad": (m * cout + m * cin + cin * cout) * 2}
            times = {
                "fwd": (lambda: hc.mm(*args["fwd"]),
                        lambda: hc.mm_tiles64(*args["fwd"]),
                        lambda: TF.conv2d(a_t, w_cl, stride=s),
                        lambda: hc.mm_reference(*args["fwd"])),
                "dgrad": (lambda: hc.mm(*args["dgrad"]),
                          lambda: hc.mm_tiles64(*args["dgrad"]),
                          lambda: torch.nn.grad.conv2d_input(
                              a_t.shape, w_cl, dy_t, stride=s),
                          lambda: hc.mm_reference(*args["dgrad"]))}
            for part, (new, parent, libcall, plain) in times.items():
                ms = median_ms(new, reps=5)
                bound, by = conv_bound(peaks, flops, io[part])
                t = {"kernel_ms": ms, "parent_ms": median_ms(parent, reps=5),
                     "library_ms": median_ms(libcall, reps=5), "reps": 5,
                     "kernel_ms_one_call": median_ms(new),
                     "plain_ms": median_ms(plain, iters=5, warmup=1),
                     "bound_ms": bound, "bound_by": by, "flops": flops,
                     "bytes": io[part], "tflops": flops / ms / 1e9,
                     "gbytes_per_s": io[part] / ms / 1e6}
                ent[part] = t
                add_step(step.setdefault(part, {}), per_step, {
                    k_: t[k_] for k_ in ("kernel_ms", "parent_ms",
                                         "library_ms", "bound_ms")})
            del a_t, dy_t, w_cl
        stages[key] = ent
        del x, wgt, dy, op, wm, args
        torch.cuda.empty_cache()
    return {"shapes": stages, "per_step": step,
            "library": "cuDNN (channels-last bf16) on the prologued input: "
                       "F.conv2d and torch.nn.grad.conv2d_input (the whole "
                       "strided dx)"}


RESNET_LAUNCHES = {"mm": 72, "mm_wgrad": 36, "c3": 32, "c3_wgrad": 16}
#: each model's K5/K6/K7/K8 launches a training step, as its structure
#: implies them: Wide ResNet-50-2 has ResNet-50's convs at twice the
#: width; ResNeXt-50's grouped 3x3s take the library conv
FAMILY_LAUNCHES = {"resnet50": RESNET_LAUNCHES,
                   "wide_resnet50_2": RESNET_LAUNCHES,
                   "resnext50_32x4d": {"mm": 72, "mm_wgrad": 36, "c3": 0,
                                       "c3_wgrad": 0}}


def resnet_flops_per_image(model, img: int) -> int:
    """The forward's conv and fc FLOPs of one image (2 per multiply-add):
    the 7x7/s2 stem counted as itself (its space-to-depth 4x4 form adds
    zero taps), each block's convs at their output sizes, the fc."""
    hw = img // 2                            # the stem's output side
    flops = 2 * hw * hw * 64 * 3 * 7 * 7
    hw = (hw - 1) // 2 + 1                   # the max-pool
    for layer in (model.layer1, model.layer2, model.layer3, model.layer4):
        for blk in layer:
            s = blk.conv2.stride if isinstance(blk.conv2.stride, int) \
                else blk.conv2.stride[0]
            out = (hw - 1) // s + 1
            for conv, side in ((blk.conv1, hw), (blk.conv2, out),
                               (blk.conv3, out)):
                o, i, kh, kw = conv.weight.shape
                flops += 2 * side * side * o * i * kh * kw
            if blk.downsample is not None:
                o, i = blk.downsample[0].weight.shape[:2]
                flops += 2 * out * out * o * i
            hw = out
    return flops + 2 * model.fc.in_features * model.fc.out_features


def resnet_loss(model, batch):
    """bench.py's loss (``:425-429``): the mean cross-entropy of the f32
    logits."""
    from paddle_tpu_torch.nn.functional import cross_entropy
    x, y = batch
    return cross_entropy(model(x).float(), y, reduction="mean")


def phase_train_grad_f32_resnet(torch, np, hc, resnet50, cross_entropy,
                                model_name="resnet50",
                                phase="train_grad_f32_resnet"):
    """ResNet-50 (1000 classes, NHWC, space-to-depth stem) in f32 at B=2 x
    224², both flags on: the same weights and batch through one forward
    and backward on the card (K5-K8, TF32 off for the stem's cuDNN conv)
    and on the CPU (their plain versions). Every gradient, the logits, the
    loss and the updated BN buffers compared; all 52 convs at their real
    shapes, the four that JAX's TPU rule sends to lax included. The same
    for ``resnet50`` another factory of the family (ResNeXt-50 and Wide
    ResNet-50-2: ``model_name`` and ``phase`` name the row), its launches
    those its structure implies (``structure_launches``)."""
    gpu = resnet50(data_format="NHWC", stem_mode="space_to_depth",
                   device="cuda", seed=0)
    cpu = resnet50(data_format="NHWC", stem_mode="space_to_depth",
                   device="cpu")
    want = structure_launches(gpu)
    check(want == FAMILY_LAUNCHES[model_name],
          f"{model_name}'s structure implies {want}")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    y = rng.integers(0, 1000, (2,))
    before = conv_counts(hc)
    out = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        model.train()
        t0 = time.perf_counter()
        logits = model(torch.as_tensor(x, device=model.device))
        loss = cross_entropy(logits.float(),
                             torch.as_tensor(y, device=model.device))
        loss.backward()
        out[name] = (float(loss.detach()), logits.detach().cpu(),
                     time.perf_counter() - t0)
    launches = {k: v - before[k] for k, v in conv_counts(hc).items()}
    check(launches == want, f"{phase}: launches {launches}, expected {want}")
    worst_norm, worst_name, worst_max = 0.0, None, 0.0
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        g_gpu = p.grad.cpu()
        g_cpu = cpu_params[name].grad
        check(bool(torch.isfinite(g_gpu).all()), f"{name}: non-finite grad")
        rel = float((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30))
        worst_max = max(worst_max, float((g_gpu - g_cpu).abs().max() /
                                         g_cpu.abs().max().clamp_min(1e-30)))
        if rel >= worst_norm:
            worst_norm, worst_name = rel, name
    cpu_bufs = dict(cpu.named_buffers())
    buf_err = max(float((b.cpu() - cpu_bufs[n]).abs().max() /
                        (1 + cpu_bufs[n].abs().max()))
                  for n, b in gpu.named_buffers())
    loss_err = abs(out["gpu"][0] - out["cpu"][0])
    logit_err = float((out["gpu"][1] - out["cpu"][1]).abs().max())
    row = {"phase": phase, "model": model_name,
           "batch": [2, 224, 224, 3], "loss_gpu": out["gpu"][0],
           "loss_cpu": out["cpu"][0], "loss_abs_err": loss_err,
           "logits_max_abs_err": logit_err, "buffers_rel_err": buf_err,
           "grad_tensors": len(cpu_params), "worst_tensor": worst_name,
           "worst_norm_rel_err": worst_norm,
           "worst_max_rel_err": worst_max, "gpu_s": out["gpu"][2],
           "cpu_s": out["cpu"][2], "launches": launches,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(row)
    # f32 on both sides, sums in other orders. This random-init net at
    # B=2 amplifies rounding: on the CPU alone a 1e-7 relative change of
    # the input moves the loss by 1.2e-5, the logits by 6.5e-5, the
    # buffers by 1.2e-6 and the gradients by up to 3.4% of a tensor's
    # 2-norm (27% of its largest; tools/resnet_grad_sensitivity.py), so
    # the gradients are held in the norm, at 1e-1
    check(loss_err <= 1e-4, f"{phase}: loss differs: {row}")
    check(logit_err <= 1e-3, f"{phase}: logits differ: {row}")
    check(buf_err <= 1e-4, f"{phase}: buffers differ: {row}")
    check(worst_norm <= 1e-1, f"{phase}: gradients differ: {row}")
    del gpu, cpu


def phase_train_resnet_bf16(torch, np, hc, hfa, hfp, peaks, resnet50,
                            Momentum, make_sharded_train_step,
                            profile=False, name="resnet50",
                            phase="train_resnet_bf16", warmup=2, timed=8):
    """The ResNet slice at bench.py's config 2 on its conv-kernel route
    (``bench_pallas_conv_ab``): ResNet-50, NHWC, space-to-depth stem, cast
    to bf16 (BN buffers too), Momentum(0.1, 0.9) with f32 masters, B=256 x
    224² from ``default_rng(0)``, the same batch every step, both flags on;
    2 warm-up and 8 timed steps, each synced: images/s over their CUDA
    event times and over their wall. Every step runs K5/K6/K7/K8
    72/36/32/16 times and no K1-K4. The same for another factory of the family
    (``name``, ``phase``; ``warmup`` and ``timed`` steps), at the launches
    its structure implies (``structure_launches``: ResNeXt's grouped 3x3s
    on the library conv, none of K7/K8)."""
    batch, img = 256, 224
    model = resnet50(data_format="NHWC", stem_mode="space_to_depth",
                     device="cuda", seed=0)
    per_step_want = structure_launches(model)
    check(per_step_want == FAMILY_LAUNCHES[name],
          f"{name}'s structure implies {per_step_want}")
    model.train()
    model.to(torch.bfloat16)
    opt = Momentum(learning_rate=0.1, momentum=0.9, multi_precision=True)
    step = make_sharded_train_step(model, opt, resnet_loss)
    rng = np.random.default_rng(0)
    # float64 normals rounded once to bf16, as jnp.asarray(..., bfloat16)
    x = torch.from_numpy(rng.standard_normal((batch, img, img, 3))).to(
        "cuda").to(torch.bfloat16)
    y = torch.as_tensor(rng.integers(0, 1000, (batch,)), device="cuda")
    flops_per_image = 3 * resnet_flops_per_image(model, img)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts are set to 0 just before it and read after
    zero_conv_counts(hc)
    zero_counts(hfa, hfp)
    losses, times = [], []
    for i in range(warmup + timed):
        if i == warmup:
            t_window = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step.step((x, y))
        end.record()
        end.synchronize()
        losses.append(float(loss))
        if i >= warmup:
            times.append(start.elapsed_time(end))
    wall_s = time.perf_counter() - t_window
    launches = {**conv_counts(hc), **k4_counts(hfa, hfp)}
    n_steps = warmup + timed
    images_per_s = timed * batch / (sum(times) / 1e3)
    buf_dtypes = sorted({str(b.dtype) for b in model.buffers()})
    clocks = card_clocks()   # right after the timed steps
    row = {"phase": phase, "clocks": clocks, "model": name,
           "batch": [batch, img, img, 3], "dtype": "bf16 (model.to)",
           "optimizer": "Momentum(0.1, momentum=0.9, multi_precision=True)",
           "flags": {"fused_conv_bn": 1, "pallas_conv": 1},
           "losses": losses, "warmup_steps": warmup, "timed_steps": timed,
           "step_ms": times, "step_p50_ms": percentile(times, 50),
           "step_p99_ms": percentile(times, 99),
           "images_per_s": images_per_s,
           "images_per_s_wall": timed * batch / wall_s,
           "flops_per_image": flops_per_image,
           "mfu": flops_per_image * images_per_s / peaks["bf16"],
           "peak_sheet": peaks["sheet"],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bn_buffer_dtypes": buf_dtypes, "launches": launches,
           "launches_per_step": {k: launches[k] / n_steps
                                 for k in CONV_KERNELS}}
    emit(row)
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {row}")
    # ln 1000 = 6.91 at init, plus about sigma^2 / 2 for the spread sigma
    # of the random logits (7.61 for this model in f32 at B=2 on the CPU)
    check(math.log(1000) - 0.5 <= losses[0] <= math.log(1000) + 1.5,
          f"step-0 loss {losses[0]}")
    for kname, per_step in per_step_want.items():
        check(launches[kname] == per_step * n_steps,
              f"{phase} {kname}: {launches[kname]} launches in {n_steps} "
              f"steps, expected {per_step} a step")
    for kname in ATTENTION_KERNELS:
        check(launches[kname] == 0,
              f"{name} training launched {kname} {launches[kname]} times")
    check(buf_dtypes == ["torch.float32"],
          f"BN buffers are {buf_dtypes} after a step, not float32")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                step.step((x, y))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        emit({"phase": "profile_train_resnet", "steps": 3,
              **device_profile(prof, wall_ms)})
    return launches, row


# -- phases 16 to 18 (ERNIE) -------------------------------------------------

def ernie_pipe_loss(cross_entropy):
    """bench.py's loss (``:779-781``): the per-token cross-entropy of the
    f32 logits, averaged."""
    def loss_fn(logits, labels):
        return cross_entropy(logits.float(), labels, reduction="none").mean()
    return loss_fn


def phase_train_grad_f32_ernie(torch, np, hfa, hfp, ErnieForPretraining,
                               ernie_base):
    """A 2-layer cut of ERNIE-base at full width (hidden 768, 12 heads of
    64, vocab 40000), f32, B=1 x S=2048 with a padding mask: the same
    weights and batch through one forward and backward on the card (the
    streamed forward, dq and dk/dv) and on the CPU (their plain versions),
    every gradient compared in the 2-norm."""
    cfg = ernie_base(num_layers=2, hidden_dropout=0.0,
                     attention_dropout=0.0)
    gpu = ErnieForPretraining(cfg, device="cuda", seed=0)
    cpu = ErnieForPretraining(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    b, s = 1, 2048
    rng = np.random.default_rng(8)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    att = (np.arange(s)[None, :] < 1500).astype(np.int32)
    labels = np.where(att == 1, rng.integers(0, cfg.vocab_size, (b, s)),
                      -100)
    sop = rng.integers(0, 2, (b, 1))
    zero_counts(hfa, hfp)
    losses = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        args = [torch.as_tensor(x, device=model.device)
                for x in (ids, att, labels, sop)]
        loss = model(args[0], None, args[1], args[2], args[3])
        loss.backward()
        losses[name] = (float(loss.detach()), time.perf_counter() - t0)
    launches = k4_counts(hfa, hfp)
    check(launches == {**{n: 0 for n in ATTENTION_KERNELS},
                       "flash_packed_fwd_stream": 2,
                       "flash_packed_bwd_dq": 2, "flash_packed_bwd_dkv": 2},
          f"train_grad_f32_ernie: launches {launches}")
    worst_name, worst_ratio, rows = None, 0.0, 0
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        g_gpu = p.grad.float().cpu()
        g_cpu = cpu_params[name].grad.float()
        check(bool(torch.isfinite(g_gpu).all()), f"{name}: non-finite grad")
        ref = g_cpu
        if name.endswith("k_proj.bias"):
            # softmax ignores a constant added to all of a row's scores, so
            # the key bias's true gradient is 0 and both sides hold rounding
            # noise: it is measured against the key weight's gradient
            ref = cpu_params[name[:-4] + "weight"].grad.float()
        ratio = float((g_gpu - g_cpu).norm()) / max(float(ref.norm()), 1e-30)
        rows += 1
        if ratio >= worst_ratio:
            worst_name, worst_ratio = name, ratio
    loss_err = abs(losses["gpu"][0] - losses["cpu"][0])
    row = {"phase": "train_grad_f32_ernie", "model": "ernie_base",
           "layers": 2, "batch": [b, s], "real_tokens": int(att.sum()),
           "loss_gpu": losses["gpu"][0], "loss_cpu": losses["cpu"][0],
           "loss_abs_err": loss_err, "gpu_s": losses["gpu"][1],
           "cpu_s": losses["cpu"][1], "grad_tensors": rows,
           "worst_tensor": worst_name, "worst_rel_err_2norm": worst_ratio,
           "launches": launches,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(row)
    # f32 on both sides, sums in other orders (cuBLAS, the kernels' tiles)
    check(loss_err <= 1e-4, f"train_grad_f32_ernie: loss differs: {row}")
    check(worst_ratio <= 1e-4,
          f"train_grad_f32_ernie: gradients differ: {row}")
    del gpu, cpu
    return launches


def ernie_flops(cfg, n_params, seq):
    """FLOPs a token: bench.py's ``6 N`` (``:834``), and that plus
    non-causal attention's ``12 L S h`` (QK^T and PV, forward and
    backward)."""
    six_n = 6 * n_params
    return six_n, six_n + 12 * cfg.num_layers * seq * cfg.hidden_size


def timed_steps(torch, run, warmup, timed):
    losses, times = [], []
    for i in range(warmup + timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = run()
        end.record()
        end.synchronize()
        losses.append(float(loss))
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return losses, times


ERNIE_FORMS = (
    # form, max positions, batch, seq, warm-up, timed, attention forms
    ("bench_s512", 512, 64, 512, 2, 8, ("flash_packed_fwd_tc",
                                        "flash_packed_bwd_tc")),
    ("long_s2048", 2048, 16, 2048, 2, 8, ("flash_packed_fwd_stream_tc",
                                          "flash_packed_bwd_dq_tc",
                                          "flash_packed_bwd_dkv_tc")),
    ("padded_s2048", 2048, 16, 2048, 2, 4, ("flash_packed_fwd_stream_tc",
                                            "flash_packed_bwd_dq_tc",
                                            "flash_packed_bwd_dkv_tc")),
)


def phase_train_ernie_bf16(torch, np, hfa, hfp, hc, peaks, ernie, AdamW,
                           make_sharded_train_step, cross_entropy,
                           profile=False, rate0_p50=None):
    """The ERNIE slice at 12 layers, hidden 768, 12 heads of 64, vocab
    40000, dropout 0, random weights from seed 0, bf16 with AdamW(1e-4)
    f32 masters, in three forms: bench.py's config 5 (``bench_ernie``:
    ``PipelineLayer(ernie_pipeline_descs(cfg), num_stages=1)`` and
    ``make_pipeline_train_step(n_microbatch=4)``, 512 positions, B=64 x
    512, 2 + 8 steps; K4a-direct and K4b-fused), the same at ERNIE's own
    2048 positions (B=16 x 2048, the same 32,768 tokens a step, 2 + 8
    steps; the streamed forward, dq and dk/dv), and ``ErnieForPretraining``
    at B=16 x 2048 with bench.py's padding mask as a key bias (2 + 4
    steps). Each form: 12 launches a step of each of its attention kernels
    and none of the others."""
    from paddle_tpu_torch.distributed import make_pipeline_train_step
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    out, launches_all = {}, {n: 0 for n in ATTENTION_KERNELS}
    for form, positions, batch, seq, warmup, timed, kernels in ERNIE_FORMS:
        cfg = ernie.ernie_base(max_position_embeddings=positions,
                               hidden_dropout=0.0, attention_dropout=0.0)
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                              device="cuda")
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (batch, seq)), device="cuda")
        opt = AdamW(learning_rate=1e-4, multi_precision=True)
        n_real = batch * seq
        if form.startswith("padded"):
            model = ernie.ErnieForPretraining(cfg, device="cuda", seed=0)
            model.to(torch.bfloat16)
            _, att = bert_padded(np, batch, seq)
            att = torch.as_tensor(att, device="cuda")
            labels = torch.where(att, labels, -100)
            n_real = int(att.sum())
            step = make_sharded_train_step(
                model, opt, lambda m, bt: m(bt[0], None, bt[1], bt[2], None))

            def run():
                return step.step((ids, att.to(torch.int32), labels))
        else:
            model = PipelineLayer(ernie.ernie_pipeline_descs(
                cfg, device="cuda", seed=0), num_stages=1,
                loss_fn=ernie_pipe_loss(cross_entropy))
            model.to(torch.bfloat16)
            pstep = make_pipeline_train_step(model, opt, n_microbatch=4)
            state = {"params": dict(model.named_parameters())}
            state["opt"] = opt.init(state["params"])

            def run():
                state["params"], state["opt"], loss = pstep(
                    state["params"], state["opt"], ids, labels, 1e-4)
                return loss
        n_params = sum(p.numel() for p in model.parameters())
        bench_flops, attn_flops = ernie_flops(cfg, n_params, seq)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path of this form: counts set to 0 just before, read after
        zero_counts(hfa, hfp)
        zero_conv_counts(hc)
        losses, times = timed_steps(torch, run, warmup, timed)
        launches = {**k4_counts(hfa, hfp), **conv_counts(hc)}
        n_steps = warmup + timed
        secs = sum(times) / 1e3
        tokens_per_s = timed * batch * seq / secs
        clocks = card_clocks()   # right after the timed steps
        row = {"phase": "train_ernie_bf16", "clocks": clocks,
               "form": form,
               "model": "ernie_base", "max_position_embeddings": positions,
               "layers": cfg.num_layers, "batch": [batch, seq],
               "entry": "ErnieForPretraining + TrainStep" if
                        form.startswith("padded") else
                        "PipelineLayer + make_pipeline_train_step",
               "dtype": "bf16 (model.to), AdamW f32 masters",
               "optimizer": "AdamW(1e-4, multi_precision=True)",
               "n_params": n_params, "losses": losses,
               "warmup_steps": warmup, "timed_steps": timed,
               "step_ms": times, "step_p50_ms": percentile(times, 50),
               "step_p99_ms": percentile(times, 99),
               "tokens_per_s": tokens_per_s,
               "real_tokens_per_step": n_real,
               "real_tokens_per_s": timed * n_real / secs,
               "flops_per_token_6n": bench_flops,
               "mfu_6n": bench_flops * tokens_per_s / peaks["bf16"],
               "flops_per_token_with_attention": attn_flops,
               "mfu_with_attention": attn_flops * tokens_per_s /
               peaks["bf16"],
               "peak_sheet": peaks["sheet"],
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches}
        emit(row)
        check(all(math.isfinite(x) for x in losses), f"non-finite: {row}")
        check(losses[-1] < losses[0], f"the loss did not decrease: {row}")
        # ln(40000) = 10.60 at init; the random logits' spread adds about
        # sigma^2 / 2
        check(math.log(cfg.vocab_size) - 0.5 <= losses[0] <=
              math.log(cfg.vocab_size) + 1.2,
              f"ERNIE {form} step-0 loss {losses[0]}")
        for name in ATTENTION_KERNELS:
            want = cfg.num_layers * n_steps if name in kernels else 0
            check(launches[name] == want,
                  f"{form}: {name} launched {launches[name]} times in "
                  f"{n_steps} steps of {cfg.num_layers} layers; expected "
                  f"{want}")
        check(all(launches[n] == 0 for n in CONV_KERNELS),
              f"{form}: conv kernels launched: {launches}")
        for name in ATTENTION_KERNELS:
            launches_all[name] += launches[name]
        out[form] = row
        if form == "long_s2048" and rate0_p50 is not None:
            rate0_p50["ernie"] = row["step_p50_ms"]
        if profile and form == "long_s2048":
            from torch.profiler import ProfilerActivity, profile as prof_ctx
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(2):
                    run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            emit({"phase": "profile_train_ernie", "form": form, "steps": 2,
                  **device_profile(prof, wall_ms)})
        del model, opt, run
        torch.cuda.empty_cache()
    return launches_all


# -- training at the published dropout ---------------------------------------

def dropout_row(torch, phase, model, losses, times, rate0_p50, launches,
                extra):
    return {"phase": phase, "model": model, "dropout": DROP_RATE,
            "losses": losses, "step_ms": times,
            "step_p50_ms": percentile(times, 50),
            "step_p99_ms": percentile(times, 99),
            "rate0_step_p50_ms": rate0_p50,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, **extra}


def check_launches(launches, want, what):
    for name, n in launches.items():
        check(n == want.get(name, 0),
              f"{what}: {name} launched {n} times; expected "
              f"{want.get(name, 0)}")


def phase_train_gpt_dropout_bf16(torch, np, hfa, hfp, peaks, GPTForCausalLM,
                                 gpt3_1p3b, amp, AdamW,
                                 make_sharded_train_step, rate0_p50):
    """GPT-3 1.3B at hidden and attention dropout 0.1: 24 layers, B=4 x
    S=2048, AMP-O2 AdamW with f32 masters, 2 warm-up and 4 timed steps;
    every step runs K1, K2 and K3 once per layer with the mask in the
    kernels, and no K4 form."""
    batch, seq, warmup, timed = 4, 2048, 2, 4
    cfg = gpt3_1p3b(hidden_dropout=DROP_RATE, attention_dropout=DROP_RATE)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01, multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2")
    step = make_sharded_train_step(model, opt, gpt_loss)
    batches = bench_batches(np, warmup + timed, batch, seq, cfg.vocab_size)
    it = iter(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(hfa, hfp)   # the main path: counts 0 before, read after
    losses, times = timed_steps(torch, lambda: step.step(next(it)), warmup,
                                timed)
    launches = k4_counts(hfa, hfp)
    n = cfg.num_layers * (warmup + timed)
    row = dropout_row(torch, "train_gpt_dropout_bf16", "gpt3_1p3b", losses,
                      times, rate0_p50.get("gpt"), launches,
                      {"hidden_dropout": DROP_RATE, "batch": [batch, seq],
                       "tokens_per_s": timed * batch * seq /
                       (sum(times) / 1e3)})
    emit(row)
    check(all(math.isfinite(x) for x in losses), f"non-finite: {row}")
    check(abs(losses[0] - 11.2) < 0.6, f"GPT dropout step-0 loss {losses[0]}")
    check_launches(launches, {"flash_fwd_tc": n, "flash_bwd_dq_tc": n,
                              "flash_bwd_dkv_tc": n}, "GPT with dropout")
    del model, opt, step
    torch.cuda.empty_cache()
    return launches, row


def phase_train_bert_dropout_bf16(torch, np, hfa, hfp, peaks,
                                  BertForPretraining, bert_base, amp, AdamW,
                                  make_sharded_train_step, rate0_p50):
    """BERT-base as published: 12 layers, hidden and attention dropout 0.1,
    bench.py's dense form, B=64 x S=512, AMP-O2 AdamW, 2 warm-up and 4
    timed steps; every step runs K4a-direct and K4b-fused once per layer.
    Run twice from one seed (equal losses: the masks follow from (seed,
    step_count)), then once at rate 0 (other losses), each from seed 0."""
    batch, seq, warmup, timed = 64, 512, 2, 4
    batches, _ = bert_batches(np, batch, seq, 30522)

    def train(rate):
        cfg = bert_base(max_position_embeddings=512, hidden_dropout=rate,
                        attention_dropout=rate)
        model = BertForPretraining(cfg, device="cuda", seed=0)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    multi_precision=True)
        model, opt = amp.decorate(model, opt, level="O2")
        step = make_sharded_train_step(model, opt, bert_loss("dense"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(hfa, hfp)   # the main path: counts 0 before, read after
        losses, times = timed_steps(
            torch, lambda: step.step(batches["dense"]), warmup, timed)
        launches = k4_counts(hfa, hfp)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, opt, step
        torch.cuda.empty_cache()
        return losses, times, launches, peak

    losses, times, launches, peak = train(DROP_RATE)
    again, times2, _, _ = train(DROP_RATE)
    rate0, times0, _, _ = train(0.0)
    n = 12 * (warmup + timed)
    row = dropout_row(torch, "train_bert_dropout_bf16", "bert_base", losses,
                      times, percentile(times0, 50), launches,
                      {"hidden_dropout": DROP_RATE, "batch": [batch, seq],
                       "form": "dense", "repeat_losses": again,
                       "repeat_step_p50_ms": percentile(times2, 50),
                       "rate0_losses": rate0,
                       "rate0_phase_step_p50_ms": rate0_p50.get("bert"),
                       "tokens_per_s": timed * batch * seq /
                       (sum(times) / 1e3)})
    row["max_memory_allocated_gb"] = peak
    emit(row)
    check(all(math.isfinite(x) for x in losses), f"non-finite: {row}")
    # ln(30522) + ln 2 at init, plus about sigma^2 / 2 of the logits
    check(10.5 <= losses[0] <= 11.8, f"BERT dropout step-0 loss {losses[0]}")
    check(again == losses, f"two runs from one seed differ: {row}")
    check(all(a != b for a, b in zip(losses, rate0)),
          f"dropout left the losses as at rate 0: {row}")
    check_launches(launches, {"flash_packed_fwd_tc": n,
                              "flash_packed_bwd_tc": n},
                   "BERT with dropout")
    return launches, row


def phase_train_ernie_dropout_bf16(torch, np, hfa, hfp, peaks, ernie, AdamW,
                                   cross_entropy, rate0_p50):
    """ERNIE-base at its own 2048 positions with hidden and attention
    dropout 0.1: the pipeline form of the long ERNIE phase
    (``PipelineLayer``, ``make_pipeline_train_step``), B=16 x 2048, bf16
    with AdamW f32 masters, 2 warm-up and 4 timed steps; every step runs the
    streamed forward, dq and dk/dv once per layer."""
    from paddle_tpu_torch.distributed import make_pipeline_train_step
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    batch, seq, warmup, timed = 16, 2048, 2, 4
    cfg = ernie.ernie_base(max_position_embeddings=seq,
                           hidden_dropout=DROP_RATE,
                           attention_dropout=DROP_RATE)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                          device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                             device="cuda")
    model = PipelineLayer(ernie.ernie_pipeline_descs(cfg, device="cuda",
                                                     seed=0),
                          num_stages=1, loss_fn=ernie_pipe_loss(cross_entropy))
    model.to(torch.bfloat16)
    opt = AdamW(learning_rate=1e-4, multi_precision=True)
    pstep = make_pipeline_train_step(model, opt, n_microbatch=4)
    state = {"params": dict(model.named_parameters())}
    state["opt"] = opt.init(state["params"])

    def run():
        state["params"], state["opt"], loss = pstep(
            state["params"], state["opt"], ids, labels, 1e-4)
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(hfa, hfp)   # the main path: counts 0 before, read after
    losses, times = timed_steps(torch, run, warmup, timed)
    launches = k4_counts(hfa, hfp)
    n = cfg.num_layers * (warmup + timed)
    row = dropout_row(torch, "train_ernie_dropout_bf16", "ernie_base", losses,
                      times, rate0_p50.get("ernie"), launches,
                      {"hidden_dropout": DROP_RATE, "batch": [batch, seq],
                       "entry": "PipelineLayer + make_pipeline_train_step",
                       "tokens_per_s": timed * batch * seq /
                       (sum(times) / 1e3)})
    emit(row)
    check(all(math.isfinite(x) for x in losses), f"non-finite: {row}")
    check(math.log(cfg.vocab_size) - 0.5 <= losses[0] <=
          math.log(cfg.vocab_size) + 1.2, f"ERNIE dropout step-0 loss "
                                           f"{losses[0]}")
    check_launches(launches, {"flash_packed_fwd_stream_tc": n,
                              "flash_packed_bwd_dq_tc": n,
                              "flash_packed_bwd_dkv_tc": n},
                   "ERNIE with dropout")
    del model, opt, pstep, state, run
    torch.cuda.empty_cache()
    return launches, row


# -- activation recompute, the SDPA route, AMP O1 ---------------------------

def gpt_step_row(torch, phase, cfg, n_params, peaks, batch, seq, losses,
                 times, launches, extra):
    """A GPT training phase's line: step p50/p99, tokens/s over the timed
    steps, MFU, peak memory; read right after the timed steps."""
    tokens_per_s = len(times) * batch * seq / (sum(times) / 1e3)
    # bench.py:1434: 6N (the products, forward and backward) plus causal
    # attention 6 * L * S * hidden per token
    flops_per_token = 6 * n_params + 6 * cfg.num_layers * seq * \
        cfg.hidden_size
    return {"phase": phase, "clocks": card_clocks(), "model": "gpt3_1p3b",
            "layers": cfg.num_layers, "params": n_params,
            "batch": [batch, seq], "losses": losses, "step_ms": times,
            "step_p50_ms": percentile(times, 50),
            "step_p99_ms": percentile(times, 99),
            "tokens_per_s": tokens_per_s,
            "flops_per_token": flops_per_token,
            "mfu": flops_per_token * tokens_per_s / peaks["bf16"],
            "peak_sheet": peaks["sheet"],
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, **extra}


def phase_train_recompute_bf16(torch, np, hfa, hfp, peaks, GPTForCausalLM,
                               gpt3_1p3b, amp, AdamW, make_sharded_train_step,
                               rate0_p50):
    """GPT-3 1.3B as bench.py's config 4 trains it (``:1474-1478``,
    ``remat=True`` at ``:2257``): train_bf16 with ``recompute=True`` under
    the default policy (dots_and_flash_saveable), 2 warm-up and 8 timed
    steps; then under ``recompute_policy=None`` (full recompute), 2 + 3
    steps. K1 saved by the policy: 24 launches a step, 48 under full
    recompute; K2/K3 24 each. Beside train_bf16's figures from this
    run."""
    rows, launches_all = {}, {}
    for policy, timed in (("dots_and_flash_saveable", 8), (None, 3)):
        # no K4 form either: the counts of every attention kernel
        zero_counts(hfa, hfp)
        row, _ = phase_train_bf16(
            torch, np, hfa, peaks, GPTForCausalLM, gpt3_1p3b, amp, AdamW,
            make_sharded_train_step, rate0_p50=rate0_p50, recompute=True,
            policy=policy, timed=timed)
        launches = k4_counts(hfa, hfp)
        rows[policy] = row
        for name, count in launches.items():
            launches_all[name] = launches_all.get(name, 0) + count
        n = row["layers"] * len(row["losses"])
        check_launches(launches, {
            "flash_fwd_tc": n * (1 if policy else 2),
            "flash_bwd_dq_tc": n, "flash_bwd_dkv_tc": n},
            f"GPT recompute under {policy}")
    peak0 = rate0_p50["gpt_row"]["max_memory_allocated_gb"]
    policy_peak = rows["dots_and_flash_saveable"]["max_memory_allocated_gb"]
    check(policy_peak <= peak0, f"the policy's peak {policy_peak} GB is "
                                f"above train_bf16's {peak0}")
    full_peak = rows[None]["max_memory_allocated_gb"]
    check(full_peak <= peak0 - 8.0, f"full recompute's peak {full_peak} GB "
                                    f"is not 8 GB below train_bf16's {peak0}")
    return launches_all


def grad_pair(torch, model_of, cfg_of, ids, labels, key, forward_ctx):
    """Loss and gradients (float32 copies on the card) of the model with
    and without recompute, from one state of weights, under one key
    stream, the forward inside ``forward_ctx()``; the backward runs on
    autograd's device thread, outside it."""
    from paddle_tpu_torch.core.random import rng_scope
    out = {}
    state = None
    for recompute in (False, True):
        model = model_of(cfg_of(recompute))
        if state is None:
            state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        model.train()
        with rng_scope(key):
            with forward_ctx():
                loss = model(ids, labels)
            loss.backward()
        out[recompute] = (float(loss.detach()),
                          {n: p.grad.float() for n, p in
                           model.named_parameters()})
        del model
    return out


def phase_train_grad_recompute(torch, np, hfa, hfp, GPTForCausalLM,
                               gpt3_1p3b, amp):
    """A 2-layer cut of GPT-3 1.3B at full width on the inputs of
    train_grad_f32 (B=2 x 320), with and without recompute under the
    default policy: in f32 (the CUDA-core K1-K3), then in bf16 at hidden
    and attention dropout 0.1 under one key stream (the tensor-core
    bodies; the recompute replays the forward's masks), then with f32
    parameters under AMP O1 in float16 at dropout 0.1 (the float16
    tensor-core bodies; the recompute, on autograd's device thread, runs
    under the forward's AMP state). The share of gradient elements that
    are bit-equal, the largest difference; held within train_grad_f32's
    tolerance (loss 1e-4, each gradient within 1e-3 of its largest
    element)."""
    import contextlib
    from paddle_tpu_torch.core.random import make_key
    rng = np.random.default_rng(5)
    b, s = 2, 320
    ids = torch.as_tensor(rng.integers(0, 50304, (b, s)), device="cuda")
    labels = torch.roll(ids, -1, dims=1)
    out = []
    for dt, drop, o1 in (("f32", 0.0, False), ("bf16", DROP_RATE, False),
                         ("f32", DROP_RATE, True)):
        dtype = torch_dtype(torch, dt)

        def cfg_of(recompute):
            return gpt3_1p3b(num_layers=2, recompute=recompute,
                             hidden_dropout=drop, attention_dropout=drop)

        def forward_ctx():
            if o1:
                return amp.auto_cast(level="O1", dtype="float16")
            return contextlib.nullcontext()

        zero_counts(hfa, hfp)
        res = grad_pair(torch, lambda c: GPTForCausalLM(
            c, device="cuda", dtype=dtype, seed=0), cfg_of, ids, labels,
            make_key(3), forward_ctx)
        launches = k4_counts(hfa, hfp)
        equal = total = 0
        worst_ratio, worst_abs = 0.0, 0.0
        for name, g in res[True][1].items():
            ref = res[False][1][name]
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite grad")
            equal += int((g == ref).sum())
            total += g.numel()
            diff = float((g - ref).abs().max())
            worst_abs = max(worst_abs, diff)
            worst_ratio = max(worst_ratio, diff / max(
                float(ref.abs().max()), 1e-30))
        body = "_tc" if dt == "bf16" or o1 else ""
        row = {"phase": "train_grad_recompute", "dtype": dt,
               "amp": "O1 float16" if o1 else None,
               "dropout": drop, "layers": 2, "batch": [b, s],
               "recompute_policy": "dots_and_flash_saveable",
               "loss": res[False][0], "loss_recompute": res[True][0],
               "bit_equal_share": equal / total, "grad_elements": total,
               "max_abs_diff": worst_abs, "worst_rel_err": worst_ratio,
               "launches": launches}
        emit(row)
        out.append(row)
        check(abs(res[True][0] - res[False][0]) <= 1e-4,
              f"train_grad_recompute: the loss differs: {row}")
        check(worst_ratio <= 1e-3,
              f"train_grad_recompute: the gradients differ: {row}")
        # the policy keeps K1's outputs: one forward launch a layer and
        # run, as without recompute
        check_launches(launches, {"flash_fwd" + body: 4,
                                  "flash_bwd_dq" + body: 4,
                                  "flash_bwd_dkv" + body: 4},
                       f"train_grad_recompute {dt} {row['amp']}")
        torch.cuda.empty_cache()
    return out


def phase_train_o1_f16(torch, np, hfa, hfp, peaks, GPTForCausalLM,
                       gpt3_1p3b, amp, AdamW):
    """GPT-3 1.3B with float32 parameters under AMP O1 in float16, B=4 x
    2048, 2 warm-up and 6 timed steps, as a Paddle user writes the dygraph
    loop: ``with auto_cast(level="O1", dtype="float16"): loss =
    model(ids, labels)``, then ``scaler.scale(loss).backward();
    scaler.step(opt); scaler.update(); opt.clear_grad()`` with
    ``GradScaler()`` and ``AdamW(parameters=model.parameters())``. The
    projections run in float16, so K1-K3 run their float16 tensor-core
    bodies, 24 launches each a step."""
    batch, seq, warmup, timed = 4, 2048, 2, 6
    cfg = gpt3_1p3b()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    scaler = amp.GradScaler()
    n_params = sum(p.numel() for p in model.parameters())
    batches = [tuple(torch.as_tensor(x, device="cuda", dtype=torch.long)
                     for x in bt)
               for bt in bench_batches(np, warmup + timed, batch, seq,
                                       cfg.vocab_size)]
    it = iter(batches)
    scales = []

    def one_step():
        ids, labels = next(it)
        with amp.auto_cast(level="O1", dtype="float16"):
            loss = model(ids, labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(float(scaler.get_loss_scaling()))
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(hfa, hfp)   # the main path: counts 0 before, read after
    losses, times = timed_steps(torch, one_step, warmup, timed)
    launches = k4_counts(hfa, hfp)
    n = cfg.num_layers * (warmup + timed)
    row = gpt_step_row(torch, "train_o1_f16", cfg, n_params, peaks, batch,
                       seq, losses, times, launches,
                       {"amp": "O1 float16", "param_dtype": "float32",
                        "optimizer": "AdamW(1e-4, weight_decay=0.01, "
                        "parameters=model.parameters())",
                        "scales": scales,
                        "found_inf_steps": sum(
                            1 for a, b_ in zip([2.0 ** 15] + scales, scales)
                            if b_ < a)})
    emit(row)
    check(all(math.isfinite(x) for x in losses), f"non-finite: {row}")
    check(abs(losses[0] - 11.2) < 0.5, f"O1 step-0 loss {losses[0]}")
    check(losses[-1] < losses[0], f"the O1 loss did not decrease: {row}")
    check_launches(launches, {"flash_fwd_tc": n, "flash_bwd_dq_tc": n,
                              "flash_bwd_dkv_tc": n}, "GPT O1 float16")
    del model, opt, scaler
    torch.cuda.empty_cache()
    return launches


def phase_gpt_sdpa_route(torch, np, hfa, hfp, GPTForCausalLM, gpt3_1p3b):
    """One forward and backward of GPT-3 1.3B in bf16 at B=1 x 2048 with
    ``use_flash_attention=True`` and ``False`` on the same weights: SDPA
    over the (identity) KV repeat routes to the same kernels, so the loss
    and every gradient are bit-equal; K1-K3 run once a layer on both."""
    cfg = gpt3_1p3b()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=0)
    model = model.to(torch.bfloat16).train()
    rng = np.random.default_rng(9)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 2048)),
                          device="cuda")
    labels = torch.roll(ids, -1, dims=1)
    res = {}
    for flash in (True, False):
        cfg.use_flash_attention = flash
        model.zero_grad(set_to_none=True)
        zero_counts(hfa, hfp)
        loss = model(ids, labels)
        loss.backward()
        res[flash] = (float(loss.detach()), {
            n: p.grad.clone() for n, p in model.named_parameters()},
            k4_counts(hfa, hfp))
    cfg.use_flash_attention = True
    unequal = [n for n, g in res[True][1].items()
               if not torch.equal(g, res[False][1][n])]
    row = {"phase": "gpt_sdpa_route", "batch": [1, 2048], "dtype": "bf16",
           "loss_flash": res[True][0], "loss_sdpa": res[False][0],
           "grad_tensors": len(res[True][1]), "unequal_grads": unequal,
           "launches_flash": res[True][2], "launches_sdpa": res[False][2]}
    emit(row)
    check(res[True][0] == res[False][0] and not unequal,
          f"gpt_sdpa_route: the routes differ: {row}")
    for flash in (True, False):
        check_launches(res[flash][2], {
            "flash_fwd_tc": cfg.num_layers, "flash_bwd_dq_tc": cfg.num_layers,
            "flash_bwd_dkv_tc": cfg.num_layers},
            f"gpt_sdpa_route use_flash_attention={flash}")
    del model, res
    torch.cuda.empty_cache()
    return row


def phase_cross_attention(torch, np, hfa, hfp, MultiHeadAttention,
                          PF, rng, rate=0.0, dt="bf16"):
    """``nn.MultiHeadAttention(768, 12, dropout=rate)`` in bf16 (or, at rate
    0, ``dt`` "f32"), training: a 512-token query over 2048 keys, B=16,
    forward and backward. The JAX package runs the streamed forward, the
    streamed dq and dk/dv-direct here (all queries in one tile, the keys in
    four); each launches once (in bf16 on their tensor-core bodies,
    dk/dv-direct on dk/dv's; in float32 on flash_packed_stream.cu).
    Output and gradients are held against the port's plain dense path
    (``_dense_attention``; at a rate above 0 the dense softmax times
    ``dropout_keep_dense`` of the seed the layer drew inside an
    ``rng_scope``) through the same projections, in the 2-norm."""
    b, sq, sk, e, h = 16, 512, 2048, 768, 12
    phase = "cross_attention" + ("_dropout" if rate else "") + \
        ("_f32" if dt == "f32" else "")
    dtype = torch_dtype(torch, dt)
    torch.manual_seed(0)
    mha = MultiHeadAttention(e, h, dropout=rate, device="cuda").to(dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    xq = torch.randn(b, sq, e, generator=g, device="cuda").to(dtype)
    xkv = torch.randn(b, sk, e, generator=g, device="cuda").to(dtype)
    dout = torch.randn(b, sq, e, generator=g, device="cuda").to(dtype)

    def grads(out):
        params = list(mha.parameters())
        got = torch.autograd.grad(out, [xq, xkv] + params, dout)
        return dict(zip(["x_query", "x_kv"] + [n for n, _ in
                                               mha.named_parameters()], got))

    xq.requires_grad_()
    xkv.requires_grad_()
    key = rng.make_key(4321)
    zero_counts(hfa, hfp)
    t0 = time.perf_counter()
    with rng.rng_scope(key):
        out = mha(xq, xkv, xkv)
    got = grads(out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = k4_counts(hfa, hfp)
    tc = "" if dt == "f32" else "_tc"
    check(launches == {**{n: 0 for n in ATTENTION_KERNELS},
                       "flash_packed_fwd_stream" + tc: 1,
                       "flash_packed_bwd_dq" + tc: 1,
                       "flash_packed_bwd_dkv_direct" + tc: 1},
          f"{phase}: launches {launches}")
    # the plain path: the same projections, the dense attention
    q = mha.q_proj(xq).view(b, sq, h, e // h)
    k = mha.k_proj(xkv).view(b, sk, h, e // h)
    v = mha.v_proj(xkv).view(b, sk, h, e // h)
    scale = 1.0 / math.sqrt(e // h)
    if rate == 0.0:
        attn = PF._dense_attention(q, k, v, None, False, scale)
    else:
        # the layer's one draw in the scope is the key's first fold
        seed = rng.draw_seed(rng.fold_in(key, 1))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        keep = hfa.dropout_keep_dense(b * h, sq, sk, seed, rate,
                                      "cuda").reshape(b, h, sq, sk)
        p = (torch.softmax(s, dim=-1) * keep).to(q.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", p.float(),
                            v.float()).to(q.dtype)
        del s, keep, p
    ref_out = mha.out_proj(attn.reshape(b, sq, e))
    ref = grads(ref_out)
    errs = {"out": float((out - ref_out).detach().float().norm() /
                         ref_out.detach().float().norm())}
    for name, gt in got.items():
        check(bool(torch.isfinite(gt).all()), f"{phase}: {name}")
        r = ref[name].float()
        if name == "k_proj.bias":   # its true gradient is 0 (see above)
            r = ref["k_proj.weight"].float()
        errs[name] = float((gt.float() - ref[name].float()).norm() /
                           max(float(r.norm()), 1e-30))
    row = {"phase": phase, "layer": f"MultiHeadAttention(768, 12, "
                                    f"dropout={rate})",
           "dtype": dt, "query": [b, sq, e], "key_value": [b, sk, e],
           "seconds_first_call": seconds, "rel_err_2norm": errs,
           "launches": launches}
    emit(row)
    # bf16 on both sides; the kernels round p before the normalisation,
    # the dense path after it. float32: sums in other orders only
    check(max(errs.values()) <= (1e-4 if dt == "f32" else 2e-2),
          f"{phase} disagrees: {row}")
    del mha, xq, xkv, dout, out, got, q, k, v, attn, ref_out, ref
    torch.cuda.empty_cache()
    return launches


# -- hapi_lenet: BASELINE config 1 under Model.fit --------------------------

#: the first losses held against the CPU, and their tolerance: float32 on
#: both sides (TF32 off), cuDNN's and the CPU's convolutions summing in their
#: own orders, carried through 20 Adam steps
LENET_CPU_STEPS, LENET_CPU_RTOL = 20, 1e-4
#: evaluate's accuracy after one epoch must reach this: the CPU run of the
#: same epoch (seed 0, 60,000 synthetic images) reaches 1.0
LENET_MIN_ACC = 0.99


def lenet_run(torch, np, P, LeNet, init, device, train, loader=None,
              num_iters=None, num_workers=0):
    """One epoch (or ``num_iters`` steps) of ``Model.fit`` from ``init``
    with ``np.random`` at seed 0: LeNet(10), Adam(1e-3), CrossEntropyLoss,
    Accuracy, B=64. Returns the model, the recorder (losses, step times,
    each batch's labels and image sums as the network saw them) and the
    fit's wall seconds."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Recorder(Callback):
        def __init__(self):
            self.losses, self.step_ms, self.labels, self.sums = [], [], [], []

        def on_train_batch_begin(self, step, logs=None):
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.step_ms.append((time.perf_counter() - self.t0) * 1e3)
            self.losses.append(float(logs["loss"]))

    rec = Recorder()
    net = LeNet(10, device=device, seed=1)
    net.load_state_dict(init)

    def keep_batch(module, args):   # a reference only: no work in the step
        if rec.fitting and module.training:
            rec.sums.append(args[0])

    net.register_forward_pre_hook(keep_batch)
    ce = P.nn.CrossEntropyLoss()

    def loss(out, label):
        if rec.fitting:
            rec.labels.append(label)
        return ce(out, label)

    model = P.Model(net)
    model.prepare(P.optimizer.Adam(1e-3), loss,
                  metrics=[P.metric.Accuracy()])
    P.seed(0)
    rec.fitting = True
    t0 = time.perf_counter()
    model.fit(loader if loader is not None else train, batch_size=64,
              epochs=1, verbose=0, num_workers=num_workers,
              num_iters=num_iters, callbacks=[rec])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec.fitting = False
    rec.labels = torch.cat([t.cpu() for t in rec.labels]).numpy()
    rec.sums = torch.stack([x.double().sum() for x in rec.sums]).cpu().numpy()
    return model, rec, wall


def phase_hapi_lenet(torch, np, P, hfa, hfp):
    """BASELINE config 1 on the card: LeNet(10) in float32 under
    ``Model.fit`` with Adam(1e-3), CrossEntropyLoss and Accuracy on the
    synthetic MNIST at MNIST's sizes (60,000 training and 10,000 test
    images), B=64, one epoch (938 steps), three times from the same weights
    and ``np.random`` seed: no workers; two thread workers; two
    shared-memory process workers with device prefetch (a DataLoader built
    here, since ``fit``'s own takes neither option). Holds the first 20
    losses against the CPU path, the three runs' batches against each
    other (each batch's labels and image sum as the network saw them), the
    loss falling, evaluate's accuracy, a save and load into a fresh Model
    (the same evaluate) and predict's shape; then a profiled window of 200
    steps for the device's busy share. No TPU kernel is on this path (the
    convolutions are cuDNN's); the attention kernels' counts stay 0."""
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    train = MNIST(mode="train", synthetic_size=60000)
    test = MNIST(mode="test", synthetic_size=10000)
    data_s = time.perf_counter() - t0
    init = {k: v.detach().cpu().clone() for k, v in
            LeNet(10, device="cuda", seed=0).state_dict().items()}

    _, cpu, _ = lenet_run(torch, np, P, LeNet, init, "cpu", train,
                          num_iters=LENET_CPU_STEPS)
    zero_counts(hfa, hfp)
    runs, rows = {}, []
    for mode in ("sync", "threads", "shm_prefetch"):
        loader = None
        if mode == "shm_prefetch":
            loader = P.io.DataLoader(train, batch_size=64, shuffle=True,
                                     num_workers=2, use_shared_memory=True,
                                     prefetch_to_device=True, places="cuda")
        model, rec, wall = lenet_run(
            torch, np, P, LeNet, init, "cuda", train, loader=loader,
            num_workers=2 if mode == "threads" else 0)
        steps = len(rec.losses)
        check(steps == 938, f"hapi_lenet {mode}: {steps} steps")
        check(all(math.isfinite(x) for x in rec.losses),
              f"hapi_lenet {mode}: a loss is not finite")
        first = np.mean(rec.losses[:20])
        last = np.mean(rec.losses[-50:])
        check(last < 0.25 * first, f"hapi_lenet {mode}: the loss fell from "
              f"{first} to {last} only")
        step_sum = sum(rec.step_ms)
        row = {"mode": mode, "steps": steps, "fit_s": wall,
               "images_per_s": 60000 / wall,
               "step_p50_ms": percentile(rec.step_ms, 50),
               "step_p99_ms": percentile(rec.step_ms, 99),
               "step_sum_s": step_sum / 1e3,
               "outside_steps_s": wall - step_sum / 1e3,
               "loss_first20_mean": float(first),
               "loss_last50_mean": float(last)}
        runs[mode] = (model, rec)
        rows.append(row)
    sync = runs["sync"][1]
    for mode in ("threads", "shm_prefetch"):
        rec = runs[mode][1]
        check(np.array_equal(rec.labels, sync.labels) and
              np.array_equal(rec.sums, sync.sums),
              f"hapi_lenet: the {mode} run's batches differ from the sync "
              f"run's")
    cpu_err = float(np.max(np.abs(np.asarray(sync.losses[:LENET_CPU_STEPS])
                                  / np.asarray(cpu.losses) - 1)))
    check(cpu_err <= LENET_CPU_RTOL, f"hapi_lenet: the first "
          f"{LENET_CPU_STEPS} losses differ from the CPU's by {cpu_err}")

    attention = k4_counts(hfa, hfp)
    check(not any(attention.values()),
          f"hapi_lenet launched attention kernels: {attention}")

    model = runs["sync"][0]
    logs = model.evaluate(test, batch_size=64, verbose=0)
    check(logs["acc"] >= LENET_MIN_ACC, f"hapi_lenet: evaluate {logs}")
    fresh = P.Model(LeNet(10, device="cuda", seed=7))
    fresh.prepare(P.optimizer.Adam(1e-3), P.nn.CrossEntropyLoss(),
                  metrics=[P.metric.Accuracy()])
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "lenet"))
        fresh.load(os.path.join(tmp, "lenet"))
    reloaded = fresh.evaluate(test, batch_size=64, verbose=0)
    check(reloaded["acc"] == logs["acc"] and
          abs(reloaded["loss"] - logs["loss"]) <= 1e-6 * abs(logs["loss"]),
          f"hapi_lenet: evaluate after load {reloaded} against {logs}")
    pred = model.predict(P.io.TensorDataset([test.images[:, None]]),
                         batch_size=64, stack_outputs=True)
    check(pred.shape == (10000, 10) and bool(np.isfinite(pred).all()),
          f"hapi_lenet: predict gave {pred.shape}")

    # the device's share of a 200-step window of the no-worker mode
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, rec, _ = lenet_run(torch, np, P, LeNet, init, "cuda", train,
                              num_iters=200)
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_row = device_profile(prof, wall_ms)
    prof_row["step_p50_ms_profiled"] = percentile(rec.step_ms, 50)
    check(prof_row["device_events"] > 0, "hapi_lenet: the profiled window "
          "shows no device work")
    emit({"phase": "hapi_lenet", "config": "BASELINE config 1: LeNet(10) "
          "f32, Adam(1e-3), CrossEntropyLoss, Accuracy, synthetic MNIST "
          "60,000 + 10,000, B=64, one epoch", "data_s": data_s,
          "runs": rows, "cpu_steps": LENET_CPU_STEPS,
          "cpu_max_rel_err": cpu_err, "cpu_rtol": LENET_CPU_RTOL,
          "evaluate": logs, "evaluate_after_load": reloaded,
          "min_acc": LENET_MIN_ACC, "predict_shape": list(pred.shape),
          "profile_200_steps": prof_row})


# -- lbfgs: LBFGS on the card against the CPU --------------------------------

def lbfgs_steps(torch, LBFGS, params, loss_fn, steps, lr, history):
    """``steps`` LBFGS updates of ``params`` (a dict of leaf tensors) on
    ``loss_fn(params)``; the losses and the final state."""
    opt = LBFGS(learning_rate=lr, history_size=history)
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            opt.apply_gradients(params, dict(zip(params, grads)), state)
    return losses, state


def phase_lbfgs(torch, np, P):
    """LBFGS (history 10) on the card against the CPU from the same values,
    20 steps each: a least-squares quadratic over two parameters (a 32 x 32
    weight and a 32-bias through a fixed, well-conditioned 1056 x 1056 map,
    lr 1) and the fc head of LeNet(10) on fixed features of 512 synthetic
    MNIST images (cross-entropy, lr 0.5). Float32 on both sides: each loss
    within 1e-3 of itself plus 1e-6 of the first (the head's last losses
    are near 1e-3, where a few ulps of the CPU's and cuBLAS's sums are 1e-5
    of them; the quadratic's fall to 1e-10 of the first, where only the
    second term holds), the parameters within 1e-4 of their norm, the
    history counts equal, the loss down tenfold."""
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import LBFGS
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    g = np.random.default_rng(0)
    n = 32 * 32 + 32
    a = (np.eye(n) + 0.25 * g.standard_normal((n, n)) / math.sqrt(n)
         ).astype(np.float32)
    y = g.standard_normal(n).astype(np.float32)
    p0 = {"w": g.standard_normal((32, 32)).astype(np.float32),
          "b": g.standard_normal(32).astype(np.float32)}
    net = LeNet(10, device="cpu", seed=0)
    ds = MNIST(mode="train", synthetic_size=512)
    with torch.no_grad():
        feats = net.features(torch.from_numpy(ds.images[:, None])).reshape(
            512, -1)
    labels = torch.from_numpy(ds.labels)
    head = {k: p.detach().clone() for k, p in net.fc.named_parameters()}

    def quadratic(dev):
        am, ym = torch.from_numpy(a).to(dev), torch.from_numpy(y).to(dev)

        def loss(ps):
            r = am @ torch.cat([ps["w"].reshape(-1), ps["b"]]) - ym
            return 0.5 * (r * r).sum()
        return {k: torch.tensor(v, device=dev, requires_grad=True)
                for k, v in p0.items()}, loss, 1.0

    def lenet_head(dev):
        f, lab = feats.to(dev), labels.to(dev)

        def loss(ps):
            h = f
            for j in range(3):
                h = torch.nn.functional.linear(h, ps[f"{j}.weight"],
                                               ps[f"{j}.bias"])
            return cross_entropy(h, lab)
        return {k: v.clone().to(dev).requires_grad_()
                for k, v in head.items()}, loss, 0.5

    rows = []
    for name, make in (("quadratic", quadratic), ("lenet_fc", lenet_head)):
        out = {}
        for dev in ("cpu", "cuda"):
            params, loss, lr = make(dev)
            losses, state = lbfgs_steps(torch, LBFGS, params, loss, 20, lr,
                                        10)
            out[dev] = (params, losses, state)
        (pc, lc, sc), (pg, lg, sg) = out["cpu"], out["cuda"]
        lg_, lc_ = np.asarray(lg), np.asarray(lc)
        loss_err = float(np.max(np.abs(lg_ - lc_) /
                                (np.abs(lc_) + 1e-3 * lc_[0])))
        param_err = max(float((pg[k].detach().cpu() - pc[k].detach()).norm()
                              / pc[k].detach().norm()) for k in pc)
        n_hist = {k: (int(sg["param_states"][k]["n_hist"]),
                      int(sc["param_states"][k]["n_hist"])) for k in pc}
        row = {"case": name, "steps": 20, "loss_cpu": [lc[0], lc[-1]],
               "loss_cuda": [lg[0], lg[-1]], "max_err_loss": loss_err,
               "max_rel_err_params_2norm": param_err, "n_hist": n_hist}
        rows.append(row)
        check(loss_err <= 1e-3 and param_err <= 1e-4 and
              all(x == y_ for x, y_ in n_hist.values()) and
              lg[-1] < 0.1 * lg[0], f"lbfgs on the card against the CPU: "
              f"{row}")
    emit({"phase": "lbfgs", "cases": rows})


# -- flash_varlen_lse: the two attention entry points on K1-K3 ---------------

def varlen_docs(np, total, lo, hi, seed):
    """Document lengths in [lo, hi] from ``seed`` filling ``total`` tokens
    (the last one cut), as cu_seqlens."""
    rng = np.random.default_rng(seed)
    lens, pos = [], 0
    while pos < total:
        n = min(int(rng.integers(lo, hi + 1)), total - pos)
        lens.append(n)
        pos += n
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32), lens


def padded_masks(torch, lens, s):
    """The documents padded to rows of ``s``: seg_q all 1, seg_k 1 on a
    row's tokens (the key-padding form the masked phase times)."""
    valid = torch.arange(s, device="cuda")[None, :] < torch.tensor(
        lens, device="cuda")[:, None]
    return (torch.ones(len(lens), s, dtype=torch.int32, device="cuda"),
            valid.to(torch.int32).contiguous(), None)


def hold_path(torch, hfa, name, q4, k4, v4, do4, causal, masks, got, worst,
              plain=True):
    """The path's ``(o, dq, dk, dv)`` (``got``, packed ``[1, T, H, D]``)
    against direct K1-K3 calls on the same inputs and masks, bit for bit,
    and those against the plain versions in head slices of 4 (the plain
    versions hold ``[1, 4, T, T]`` float32 scores). Returns the row."""
    o, lse = hfa.flash_fwd(q4, k4, v4, causal, masks=masks)
    grads = hfa.flash_bwd(q4, k4, v4, o, lse, do4, causal, masks=masks)
    for gname, a, b in zip(("o", "dq", "dk", "dv"), got, (o, *grads)):
        check(torch.equal(a, b), f"{name}: the path's {gname} is not the "
              f"kernels' own")
    row = {"case": name, "shape": [list(q4.shape), list(k4.shape)],
           "causal": causal, "ok": True}
    if not plain:
        return row
    errs = {}
    for h0 in range(0, q4.shape[2], 4):
        hs = slice(h0, h0 + 4)
        ro, rlse = hfa.flash_fwd_reference(q4[:, :, hs], k4[:, :, hs],
                                           v4[:, :, hs], causal, masks=masks)
        refs = hfa.flash_bwd_reference(
            q4[:, :, hs], k4[:, :, hs], v4[:, :, hs], o[:, :, hs],
            lse[:, hs], do4[:, :, hs], causal, masks=masks, mma_sums=True)
        sub = {}
        for gname, a, r in zip(("o", "dq", "dk", "dv"),
                               (o[:, :, hs], *(t[:, :, hs] for t in grads)),
                               (ro, *refs)):
            errs[gname] = max(errs.get(gname, 0.0), compare(
                torch, gname, a, r, "bf16", sub, nonzero=gname != "o"))
        row["ok"] &= sub["ok"]
        del ro, rlse, refs
    row.update({f"max_abs_err_{k}": v for k, v in errs.items()})
    for kname, gname in (("flash_fwd_tc", "o"), ("flash_bwd_dq_tc", "dq"),
                         ("flash_bwd_dkv_tc", "dk"),
                         ("flash_bwd_dkv_tc", "dv")):
        worst[kname] = max(worst.get(kname, 0.0), errs[gname])
    check(row["ok"], f"{name}: K1-K3 disagree with their plain versions: "
          f"{row}")
    return row


def attention_flops(pairs, h, d):
    """Forward FLOPs of attention over ``pairs`` (query, key) pairs: QK^T
    and PV, 2 each a multiply-add; the backward 2.5 times that."""
    return 4 * pairs * h * d


def phase_flash_varlen_lse(torch, np, hfa, hfp, tfa, peaks):
    """``ops.flash_attn_unpadded`` and ``flash_attention_with_lse`` at GPT-3
    1.3B's attention width (16 heads of 128, bf16):

    - a causal packing of documents of 64-2048 tokens, 8192 in all (8
      documents), and a non-causal cross packing (6 documents: 1024
      queries in splits of 64-300 plus a padded tail of 64 tokens, over
      7077 keys in splits of 64-2048): each call must
      launch K1's tensor-core body, K2's and K3's once each and nothing
      else; its o and gradients equal direct K1-K3 calls on the packed row
      bit for bit, and those hold against the plain versions; then each is
      timed, forward and forward + backward, beside the same documents
      padded to rows of 2048 with a key-padding mask;
    - ``flash_attention_with_lse`` on B=2 x 2048: two key halves merged by
      logaddexp against one call over all keys (o and lse), and the
      gradients of a loss on both o and lse (so dlse is not 0) through the
      merge, against K1-K3's plain versions fed the cotangents the merge
      hands each half; two calls launch K1, K2 and K3 twice each."""
    h, d = 16, 128
    bf16 = torch.bfloat16
    scale = 1.0 / math.sqrt(d)
    worst, rows, timing = {}, [], {}
    launches = {"varlen": {}, "lse": {}}
    g = torch.Generator(device="cuda")
    g.manual_seed(1600)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(bf16)

    cu_c, lens_c = varlen_docs(np, 8192, 64, 2048, seed=16)
    cu_qx, lens_qx = varlen_docs(np, 1024, 64, 300, seed=17)
    cu_kx, lens_kx = varlen_docs(np, 8192, 64, 2048, seed=18)
    n = min(len(lens_qx), len(lens_kx))
    cu_qx, lens_qx = cu_qx[:n + 1], lens_qx[:n]
    cu_kx, lens_kx = cu_kx[:n + 1], lens_kx[:n]
    cases = {
        "causal_docs": (cu_c, cu_c, 8192, 8192, lens_c, lens_c, True),
        "cross_splits": (cu_qx, cu_kx, int(cu_qx[-1]) + 64,
                         int(cu_kx[-1]), lens_qx, lens_kx, False),
    }
    for name, (cq, ck, tq, tk, lq, lk, causal) in cases.items():
        q, do = rnd(tq, h, d), rnd(tq, h, d)
        k, v = rnd(tk, h, d), rnd(tk, h, d)
        tcu_q = torch.as_tensor(cq, device="cuda")
        tcu_k = tcu_q if cq is ck else torch.as_tensor(ck, device="cuda")
        mq, mk = max(lq), max(lk)

        def path(q=q, k=k, v=v, causal=causal, tcu_q=tcu_q, tcu_k=tcu_k,
                 mq=mq, mk=mk):
            return tfa.flash_attn_unpadded(q, k, v, tcu_q, tcu_k, mq, mk,
                                           causal=causal)

        # the main path, counted
        qg, kg, vg = (t.detach().clone().requires_grad_()
                      for t in (q, k, v))
        zero_counts(hfa, hfp)
        o = tfa.flash_attn_unpadded(qg, kg, vg, tcu_q, tcu_k, mq, mk,
                                    causal=causal)
        o.backward(do)
        torch.cuda.synchronize()
        ran = k4_counts(hfa, hfp)
        check(ran == {**{x: 0 for x in ATTENTION_KERNELS},
                      "flash_fwd_tc": 1, "flash_bwd_dq_tc": 1,
                      "flash_bwd_dkv_tc": 1},
              f"flash_varlen_lse {name}: launches {ran}")
        for kname, n_ in ran.items():
            launches["varlen"][kname] = launches["varlen"].get(kname, 0) + n_
        seg_q = torch.where(torch.arange(tq, device="cuda") < int(cq[-1]),
                            torch.searchsorted(tcu_q, torch.arange(
                                tq, device="cuda"), right=True) - 1,
                            -1).to(torch.int32)[None]
        seg_k = (torch.searchsorted(tcu_k, torch.arange(tk, device="cuda"),
                                    right=True) - 1).to(torch.int32)[None]
        row = hold_path(torch, hfa, name, q[None], k[None], v[None],
                        do[None], causal, (seg_q, seg_k, None),
                        (o[None].detach(), qg.grad[None], kg.grad[None],
                         vg.grad[None]), worst)
        if tq > int(cq[-1]):
            check(bool((o[int(cq[-1]):] == 0).all()),
                  f"{name}: the padded tail's o is not 0")
        del qg, kg, vg, o

        # timed beside the same documents padded to rows of 2048
        s = 2048
        qp, kp, vp, dop = (torch.zeros(len(lq), s, h, d, dtype=bf16,
                                       device="cuda") for _ in range(4))
        for i, (a, b_) in enumerate(zip(cq[:-1], cq[1:])):
            qp[i, :b_ - a], dop[i, :b_ - a] = q[a:b_], do[a:b_]
        for i, (a, b_) in enumerate(zip(ck[:-1], ck[1:])):
            kp[i, :b_ - a], vp[i, :b_ - a] = k[a:b_], v[a:b_]
        pmasks = padded_masks(torch, lk, s)
        pairs = sum(attention_pairs(a, b_, causal) for a, b_ in zip(lq, lk))
        qv, kv, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        qpv, kpv, vpv = (t.detach().clone().requires_grad_()
                         for t in (qp, kp, vp))

        def packed_fb():
            out = tfa.flash_attn_unpadded(qv, kv, vv, tcu_q, tcu_k, mq, mk,
                                          causal=causal)
            torch.autograd.grad(out, (qv, kv, vv), do)

        def padded_fb():
            out = hfa.flash_fwd(qpv, kpv, vpv, causal, masks=pmasks)[0]
            torch.autograd.grad(out, (qpv, kpv, vpv), dop)

        fwd_flops = attention_flops(pairs, h, d)
        # bf16 bytes: the forward reads q, k, v and writes o; the backward
        # reads q, k, v, o, dO and writes dq, dk, dv
        fwd_bytes = 2 * (2 * tq + 2 * tk) * h * d
        fb_bytes = fwd_bytes + 2 * (4 * tq + 4 * tk) * h * d
        timing[name] = {
            "tokens": [int(cq[-1]), int(ck[-1])], "docs": len(lq),
            "pairs": pairs, "padded_rows": [len(lq), s],
            "packed_fwd_ms": median_ms(path, iters=10),
            "padded_fwd_ms": median_ms(lambda: hfa.flash_fwd(
                qp, kp, vp, causal, masks=pmasks), iters=10),
            "packed_fwd_bwd_ms": median_ms(packed_fb, iters=10),
            "padded_fwd_bwd_ms": median_ms(padded_fb, iters=10),
            "bound_fwd_ms": max(fwd_flops / peaks["bf16"],
                                fwd_bytes / peaks["bytes"]) * 1e3,
            "bound_fwd_bwd_ms": max(3.5 * fwd_flops / peaks["bf16"],
                                    fb_bytes / peaks["bytes"]) * 1e3}
        rows.append(row)
        del q, k, v, do, qp, kp, vp, dop, qv, kv, vv, qpv, kpv, vpv
        torch.cuda.empty_cache()

    # flash_attention_with_lse: the merge of two key halves
    b, s = 2, 2048
    q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    co = rnd(b, s, h, d).float()
    cl = torch.randn(b, s, h, generator=g, device="cuda")
    half = s // 2

    def merge(o1, l1, o2, l2):
        lse = torch.logaddexp(l1, l2)
        o = o1.float() * torch.exp(l1 - lse)[..., None] + \
            o2.float() * torch.exp(l2 - lse)[..., None]
        return o, lse

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    zero_counts(hfa, hfp)
    parts = [hfa.flash_attention_with_lse(qg, kg[:, sl], vg[:, sl])
             for sl in (slice(0, half), slice(half, s))]
    o, lse = merge(*parts[0], *parts[1])
    ((o * co).sum() + (lse * cl).sum()).backward()
    torch.cuda.synchronize()
    ran = k4_counts(hfa, hfp)
    check(ran == {**{x: 0 for x in ATTENTION_KERNELS}, "flash_fwd_tc": 2,
                  "flash_bwd_dq_tc": 2, "flash_bwd_dkv_tc": 2},
          f"flash_varlen_lse with_lse: launches {ran}")
    launches["lse"] = ran
    full_o, full_lse = hfa.flash_attention_with_lse(q, k, v)
    lrow = {"case": "with_lse_merge", "shape": [b, s, h, d], "ok": True}
    # the merge blends two bf16 outputs in f32: against one call over all
    # keys within two bf16 roundings, the lse within f32's sums
    o_err = (o.detach() - full_o.float()).abs()
    lse_err = (lse.detach() - full_lse).abs()
    lrow["max_abs_err_o_merged"] = float(o_err.max())
    lrow["max_abs_err_lse_merged"] = float(lse_err.max())
    lrow["ok"] &= bool((o_err <= 1e-2 + 1e-2 * full_o.float().abs()).all())
    lrow["ok"] &= bool((lse_err <= 1e-4 * (1 + full_lse.abs())).all())
    # the cotangents the merge hands each half, then K2/K3's plain versions
    leaves = [t.detach().requires_grad_() for p in parts for t in p]
    mo, ml = merge(*leaves)
    cots = torch.autograd.grad((mo * co).sum() + (ml * cl).sum(), leaves)
    refs = []
    for i, sl in enumerate((slice(0, half), slice(half, s))):
        oi, li = parts[i][0].detach(), parts[i][1].detach()
        refs.append(hfa.flash_bwd_reference(
            q, k[:, sl].contiguous(), v[:, sl].contiguous(), oi,
            li.transpose(1, 2).contiguous(), cots[2 * i], False,
            dlse=cots[2 * i + 1].transpose(1, 2), mma_sums=True))
    lrow["dlse_abs_max"] = float(max(cots[1].abs().max(),
                                     cots[3].abs().max()))
    check(lrow["dlse_abs_max"] > 0, "with_lse: the lse cotangent is 0")
    # autograd sums q's two bf16 halves in bf16, and so does the reference
    compare(torch, "dq", qg.grad, refs[0][0] + refs[1][0], "bf16", lrow)
    compare(torch, "dk", kg.grad, torch.cat([r[1] for r in refs], 1),
            "bf16", lrow)
    compare(torch, "dv", vg.grad, torch.cat([r[2] for r in refs], 1),
            "bf16", lrow)
    check(lrow["ok"], f"flash_attention_with_lse disagrees: {lrow}")
    rows.append(lrow)

    def lse_fb():
        ps = [hfa.flash_attention_with_lse(qg, kg[:, sl], vg[:, sl])
              for sl in (slice(0, half), slice(half, s))]
        mo, ml = merge(*ps[0], *ps[1])
        torch.autograd.grad((mo * co).sum() + (ml * cl).sum(), (qg, kg, vg))

    timing["with_lse_merge"] = {
        "shape": [b, s, h, d], "fwd_bwd_ms": median_ms(lse_fb, iters=10),
        "one_call_fwd_bwd_ms": median_ms(lambda: torch.autograd.grad(
            hfa.flash_fwd(qg, kg, vg)[0], (qg, kg, vg), co.to(bf16)),
            iters=10)}
    emit({"phase": "flash_varlen_lse", "heads": h, "head_dim": d,
          "dtype": "bf16", "cases": rows, "timing_ms": timing,
          "launches": launches})
    del q, k, v, qg, kg, vg, parts, leaves
    torch.cuda.empty_cache()
    return worst, launches



# -- the Transformer (encoder-decoder) and K4 under recompute's policy -------

#: Transformer-base (Vaswani et al. 2017, Table 3 "base"): 6 + 6 layers,
#: d_model 512, 8 heads of 64, FFN 2048, dropout 0.1, label smoothing 0.1,
#: the shared WMT14 en-de vocabulary of about 37,000 tokens
T_BASE = dict(d_model=512, nhead=8, num_encoder_layers=6,
              num_decoder_layers=6, dim_feedforward=2048, dropout=0.1)
T_VOCAB, T_PAD, T_BOS, T_EOS, T_SMOOTH, T_LEN = 37000, 0, 1, 2, 0.1, 256


def seq2seq(torch, P, device, seed, **over):
    """The smoke's seq2seq wrapper around ``nn.Transformer`` (smoke code,
    on the package's public layers only): a shared Embedding of 37,000 x
    512 drawn from N(0, 512^-0.5) (the pad row zero), scaled by sqrt(512),
    sinusoid positions, the output projection tied to the embedding, and
    label-smoothed cross-entropy with the pads ignored. Weights from
    ``seed`` through the port's key stream."""
    nn = P.nn
    cfg = {**T_BASE, **over}
    d = cfg["d_model"]

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(
                T_VOCAB, d, padding_idx=T_PAD, weight_attr=nn.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, d ** -0.5)),
                device=device)
            self.transformer = nn.Transformer(**cfg, device=device)
            pos = torch.arange(1024, dtype=torch.float32)[:, None]
            rate = torch.pow(10000.0, -torch.arange(
                0, d, 2, dtype=torch.float32) / d)
            pe = torch.zeros(1024, d)
            pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * rate), \
                torch.cos(pos * rate)
            self.register_buffer("pe", pe.to(device), persistent=False)

        def embed(self, ids, start=0):
            return self.emb(ids) * math.sqrt(d) + \
                self.pe[start:start + ids.shape[1]]

        def logits(self, out):
            return torch.matmul(out, self.emb.weight.T)

        def forward(self, src, tgt, labels, bias):
            mask = nn.Transformer.generate_square_subsequent_mask(
                tgt.shape[1], device=src.device)
            out = self.transformer(self.embed(src), self.embed(tgt),
                                   src_mask=bias, tgt_mask=mask,
                                   memory_mask=bias)
            return nn.functional.cross_entropy(
                self.logits(out), labels, ignore_index=T_PAD,
                label_smoothing=T_SMOOTH)

    P.seed(seed)
    return Seq2Seq()


def t_batch(torch, np, rng, b, ls, lt, device):
    """``(src, tgt, labels, bias)``: each row's true source and target
    lengths drawn in [24, length] (no row all padding), ids in [3,
    vocab), the target ending in EOS, its input shifted right after BOS,
    pads 0; the source's key padding as a ``[B, 1, 1, S]`` bias of -1e9
    (``padding_bias``)."""
    n_src = rng.integers(24, ls + 1, b)
    n_tgt = rng.integers(24, lt + 1, b)
    src = rng.integers(3, T_VOCAB, (b, ls))
    src[np.arange(ls)[None, :] >= n_src[:, None]] = T_PAD
    labels = rng.integers(3, T_VOCAB, (b, lt))
    pos = np.arange(lt)[None, :]
    labels[pos == n_tgt[:, None] - 1] = T_EOS
    labels[pos >= n_tgt[:, None]] = T_PAD
    tgt = np.concatenate([np.full((b, 1), T_BOS), labels[:, :-1]], axis=1)
    tgt[pos >= n_tgt[:, None]] = T_PAD
    att = torch.as_tensor(np.arange(ls)[None, :] < n_src[:, None],
                          device=device)
    bias = padding_bias(torch, att, torch.float32).reshape(b, 1, 1, ls)
    return tuple(torch.as_tensor(x, device=device) for x in
                 (src, tgt, labels)) + (bias,)


def t_flops(model, b, ls, lt):
    """FLOPs of one training step: 6 N a position for the products (the
    encoder's parameters over the source positions, the decoder's and the
    tied output projection's, V x d, over the target positions, pads
    included, as the device computes them), plus attention's QK^T and PV
    forward and backward: 12 L S_s^2 d (encoder), 6 L S_t^2 d (causal
    decoder), 12 L S_t S_s d (cross), each times B."""
    t = model.transformer
    n_enc = sum(p.numel() for p in t.encoder.parameters())
    n_dec = sum(p.numel() for p in t.decoder.parameters())
    d, le, ld = t.d_model, len(t.encoder.layers), len(t.decoder.layers)
    return b * (6 * (ls * n_enc + lt * (n_dec + T_VOCAB * d)) +
                12 * le * ls * ls * d + 6 * ld * lt * lt * d +
                12 * ld * lt * ls * d)


def phase_train_transformer_bf16(torch, np, P, hfa, hfp, peaks, amp, AdamW,
                                 make_sharded_train_step):
    """Transformer-base at its published width through ``TrainStep``:
    B=64 x 256 a side, AMP-O2 bf16, ``AdamW(beta2=0.98, epsilon=1e-9)``
    with f32 masters on ``NoamDecay(512, 4000)``, label smoothing 0.1, 2
    warm-up and 8 timed steps, at dropout 0.1 and beside it at 0. By
    ``plan(256, 256, 8)`` the encoder's self-attention and the
    cross-attention (the key bias) run K4a-direct and K4b-fused: 12 of each
    a step; the decoder's causal self-attention (a per-query mask) the
    dense path, 6 a step (``scaled_dot_product_attention.dense_routes``)."""
    from paddle_tpu_torch.optimizer.lr import NoamDecay
    sdpa = P.nn.functional.scaled_dot_product_attention
    check(tuple(hfp.plan(T_LEN, T_LEN, 8)) == ("direct", "fused", None),
          f"plan(256, 256, 8) = {hfp.plan(T_LEN, T_LEN, 8)}")
    b, s, warmup, timed = 64, T_LEN, 2, 8
    rows, launches_all = {}, {}
    for drop in (T_BASE["dropout"], 0.0):
        model = seq2seq(torch, P, "cuda", 0, dropout=drop)
        n_params = sum(p.numel() for p in model.parameters())
        flops = t_flops(model, b, s, s)
        opt = AdamW(learning_rate=NoamDecay(512, 4000), beta2=0.98,
                    epsilon=1e-9, multi_precision=True)
        model, opt = amp.decorate(model, opt, level="O2")
        step = make_sharded_train_step(model, opt, lambda m, bt: m(*bt))
        rng = np.random.default_rng(0)
        batches = [t_batch(torch, np, rng, b, s, s, "cuda")
                   for _ in range(warmup + timed)]
        it = iter(batches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: the counts are set to 0 just before it
        zero_counts(hfa, hfp)
        sdpa.dense_routes = 0
        losses, times = timed_steps(torch, lambda: step.step(next(it)),
                                    warmup, timed)
        launches, dense = k4_counts(hfa, hfp), sdpa.dense_routes
        n = len(losses)
        for name, count in launches.items():
            launches_all[name] = launches_all.get(name, 0) + count
        tgt_tokens = sum(int((bt[2] != T_PAD).sum())
                         for bt in batches[warmup:])
        secs = sum(times) / 1e3
        row = {"phase": "train_transformer_bf16", "clocks": card_clocks(),
               "model": "transformer_base", "dropout": drop,
               "label_smoothing": T_SMOOTH, "vocab": T_VOCAB,
               "params": n_params, "batch": [b, s, s],
               "optimizer": "AdamW(beta2=0.98, epsilon=1e-9) on "
                            "NoamDecay(512, 4000), f32 masters",
               "amp": "O2", "losses": losses, "step_ms": times,
               "step_p50_ms": percentile(times, 50),
               "step_p99_ms": percentile(times, 99),
               "target_tokens_per_s": tgt_tokens / secs,
               "flops_per_step": flops,
               "flops_formula": "B*(6*(S_s*N_enc + S_t*(N_dec + V*d)) + "
                                "12*L_e*S_s^2*d + 6*L_d*S_t^2*d + "
                                "12*L_d*S_t*S_s*d)",
               "mfu": flops * timed / secs / peaks["bf16"],
               "peak_sheet": peaks["sheet"],
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "launches_per_step": {k: v / n for k, v in launches.items()
                                     if v},
               "dense_routes_per_step": dense / n}
        emit(row)
        rows[drop] = row
        check(all(math.isfinite(x) for x in losses),
              f"non-finite Transformer loss: {row}")
        # tied logits at init are N(0, 1): the first loss is about
        # ln(37000) + 1/2 = 11.0, smoothing or not
        check(abs(losses[0] - math.log(T_VOCAB)) < 1.0,
              f"Transformer step-0 loss {losses[0]}")
        check_launches(launches, {"flash_packed_fwd_tc": 12 * n,
                                  "flash_packed_bwd_tc": 12 * n},
                       f"train_transformer_bf16 at dropout {drop}")
        check(dense == 6 * n, f"Transformer dense routes {dense} in {n} "
                              f"steps; expected the decoder's 6 a step")
        del model, opt, step, batches
        torch.cuda.empty_cache()
    return launches_all


def phase_train_grad_f32_transformer(torch, np, P, hfa, hfp):
    """A 2 + 2-layer cut of Transformer-base at full width (vocab 37,000),
    f32, B=2, source 256 and target 128 (cross-attention at Sq != Sk), at
    dropout 0: one forward and backward on the card (K4a-direct's and
    K4b-fused's float32 bodies, 4 each) and through the plain versions on
    the CPU, every gradient compared (train_grad_f32's tolerance); then
    K4a-direct and K4b-fused at these attention shapes (8 heads of 64, the
    key bias; Sq 256 and 128 over Sk 256) against their plain versions in
    bf16 and f32."""
    cut = dict(num_encoder_layers=2, num_decoder_layers=2, dropout=0.0)
    gpu = seq2seq(torch, P, "cuda", 0, **cut)
    cpu = seq2seq(torch, P, "cpu", 0, **cut)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    b, ls, lt = 2, T_LEN, 128
    rng = np.random.default_rng(7)
    batch = t_batch(torch, np, rng, b, ls, lt, "cpu")
    zero_counts(hfa, hfp)
    losses = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        dev = next(iter(model.parameters())).device
        t0 = time.perf_counter()
        loss = model(*(x.to(dev) for x in batch))
        loss.backward()
        losses[name] = (float(loss.detach()), time.perf_counter() - t0)
    launches = k4_counts(hfa, hfp)
    check_launches(launches, {"flash_packed_fwd": 4, "flash_packed_bwd": 4},
                   "train_grad_f32_transformer")
    worst_name, worst_ratio, key_bias_ratio, _ = grad_rel_errs(torch, gpu,
                                                               cpu)
    loss_err = abs(losses["gpu"][0] - losses["cpu"][0])
    worst, cases = {}, []
    for dt in ("bf16", "f32"):
        dtype = torch_dtype(torch, dt)
        for sq in (T_LEN, lt):
            q, k, v, do, masks = k4_inputs(torch, 2, sq, T_LEN, 8, dtype,
                                           "bias", seed=sq)
            row, _, _ = k4_case(torch, hfp, (f"transformer_{sq}x{T_LEN}", 2,
                                             sq, T_LEN, 8, False, dt),
                                q, k, v, do, masks, worst)
            cases.append(row)
    row = {"phase": "train_grad_f32_transformer", "layers": [2, 2],
           "batch": [b, ls, lt], "loss_gpu": losses["gpu"][0],
           "loss_cpu": losses["cpu"][0], "loss_abs_err": loss_err,
           "gpu_s": losses["gpu"][1], "cpu_s": losses["cpu"][1],
           "worst_tensor": worst_name, "worst_rel_err": worst_ratio,
           "key_bias_rel_err": key_bias_ratio, "launches": launches,
           "k4_cases": cases,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(row)
    check(loss_err <= 1e-4, f"train_grad_f32_transformer: loss: {row}")
    check(worst_ratio <= 1e-3,
          f"train_grad_f32_transformer: gradients differ: {row}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches, worst


def t_greedy(torch, P, model, src, bias, steps, cached):
    """Greedy decoding of ``steps`` tokens after BOS: with ``cached``
    through ``TransformerDecoder.gen_cache`` and one-token steps, else by
    full causal recompute of the prefix each step. Returns the tokens, the
    top-2 logit gap of each step and the ms a step (CUDA events)."""
    nn = P.nn
    dec = model.transformer.decoder
    with torch.no_grad():
        memory = model.transformer.encoder(model.embed(src), src_mask=bias)
        prefix = torch.full((src.shape[0], 1), T_BOS, dtype=torch.long,
                            device=src.device)
        cache = dec.gen_cache(memory) if cached else None
        gaps = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for t in range(steps):
            if cached:
                h, cache = dec(model.embed(prefix[:, -1:], t), memory,
                               memory_mask=bias, cache=cache)
            else:
                h = dec(model.embed(prefix), memory,
                        tgt_mask=nn.Transformer.
                        generate_square_subsequent_mask(
                            t + 1, device=src.device),
                        memory_mask=bias)
            top = torch.topk(model.logits(h[:, -1]).float(), 2)
            gaps.append(top.values[:, 0] - top.values[:, 1])
            prefix = torch.cat([prefix, top.indices[:, :1]], dim=1)
        end.record()
        end.synchronize()
    return (prefix[:, 1:].cpu().numpy(), torch.stack(gaps, 1).cpu().numpy(),
            start.elapsed_time(end) / steps)


def t_beam(torch, P, model, src, bias, beam, steps, cached):
    """``dynamic_decode`` with ``BeamSearchDecoder`` (beam ``beam``) over
    one source: the cell keeps the memory and its bias tiled to the beam
    and, with ``cached``, one cache a layer (its position the cache's
    length), else the tokens so far, recomputing the prefix each step."""
    nn = P.nn
    dec = model.transformer.decoder
    with torch.no_grad():
        memory = model.transformer.encoder(model.embed(src), src_mask=bias)
    mem = memory.expand(beam, -1, -1).contiguous()
    mbias = bias.expand(beam, -1, -1, -1).contiguous()

    @torch.no_grad()
    def cell(ids, states):
        if cached:
            pos = states["caches"][0].k.shape[1]
            h, caches = dec(model.embed(ids[:, None], pos), states["memory"],
                            memory_mask=states["bias"],
                            cache=states["caches"])
            return model.logits(h[:, -1]), dict(states, caches=caches)
        prefix = torch.cat([states["prefix"], ids[:, None]], dim=1)
        h = dec(model.embed(prefix), states["memory"],
                tgt_mask=nn.Transformer.generate_square_subsequent_mask(
                    prefix.shape[1], device=src.device),
                memory_mask=states["bias"])
        return model.logits(h[:, -1]), dict(states, prefix=prefix)

    init = {"memory": mem, "bias": mbias}
    if cached:
        init["caches"] = dec.gen_cache(mem)
    else:
        init["prefix"] = torch.zeros((beam, 0), dtype=torch.long,
                                     device=src.device)
    ids, scores = nn.dynamic_decode(
        nn.BeamSearchDecoder(cell, T_BOS, T_EOS, beam), init,
        max_step_num=steps)
    return ids.cpu().numpy(), scores.cpu().numpy()


def phase_decode_transformer(torch, np, P, hfa, hfp):
    """Transformer-base at full width, f32, eval: greedy decoding of 64
    tokens for 8 sources of up to 256 tokens with
    ``TransformerDecoder.gen_cache`` against decoding by full causal
    recompute, token-exact but where the recompute's top-2 gap at the
    first difference is under 1e-3 (serve_f32's near-tie rule);
    ``dynamic_decode`` with beam 4 over 64 steps, with caches and without,
    the same tokens and scores within 1e-3 + 1e-5·|score|; each encoder
    pass runs K4a-direct (its float32 body, 6 launches), the one-token
    steps and the prefix recompute the dense path. Then the same in bf16,
    its agreement printed, not asserted; ms a decode step with and without
    caches in both."""
    model = seq2seq(torch, P, "cuda", 1).eval()
    b, steps, beam = 8, 64, 4
    rng = np.random.default_rng(11)
    src, _, _, bias = t_batch(torch, np, rng, b, T_LEN, T_LEN, "cuda")
    out = {"phase": "decode_transformer", "model": "transformer_base",
           "batch": b, "steps": steps, "beam": beam}
    launches_all = {}
    for dt in ("f32", "bf16"):
        model = model.to(torch_dtype(torch, dt))
        res = {}
        for cached in (True, False):
            zero_counts(hfa, hfp)
            res[cached] = t_greedy(torch, P, model, src, bias, steps,
                                   cached)
            launches = k4_counts(hfa, hfp)
            body = "flash_packed_fwd" + ("_tc" if dt == "bf16" else "")
            check_launches(launches, {body: 6},
                           f"decode_transformer {dt} cached={cached}")
            for name, n in launches.items():
                launches_all[name] = launches_all.get(name, 0) + n
        (got, _, ms_c), (want, gaps, ms_r) = res[True], res[False]
        rows, exact = [], 0
        for i in range(b):
            diff = np.nonzero(got[i] != want[i])[0]
            row = {"exact": diff.size == 0}
            if diff.size:
                pos = int(diff[0])
                row.update(first_mismatch=pos,
                           top2_gap=float(gaps[i, pos]))
            exact += int(diff.size == 0)
            rows.append(row)
        part = {"greedy_rows_exact": exact,
                "greedy_tokens_equal_share": float((got == want).mean()),
                "greedy_rows": rows, "ms_per_step_cached": ms_c,
                "ms_per_step_recompute": ms_r}
        if dt == "f32":
            for row in rows:
                check(row["exact"] or row["top2_gap"] < 1e-3,
                      f"cached greedy decoding differs from full recompute "
                      f"beyond a near-tie: {row}")
            bsrc, bbias = src[:1], bias[:1]
            ids_c, sc_c = t_beam(torch, P, model, bsrc, bbias, beam, steps,
                                 True)
            ids_r, sc_r = t_beam(torch, P, model, bsrc, bbias, beam, steps,
                                 False)
            part.update(beam_ids_equal=bool(np.array_equal(ids_c, ids_r)),
                        beam_scores_cached=sc_c.tolist(),
                        beam_scores_recompute=sc_r.tolist(),
                        beam_steps=int(ids_c.shape[1]))
            check(part["beam_ids_equal"],
                  f"beam search differs with caches: {ids_c} {ids_r}")
            check(bool((np.abs(sc_c - sc_r) <= 1e-3 + 1e-5 *
                        np.abs(sc_r)).all()),
                  f"beam scores differ with caches: {sc_c} {sc_r}")
        out[dt] = part
    emit(out)
    del model
    torch.cuda.empty_cache()
    return launches_all


def gpt3_medium(GPTConfig, **over):
    """GPT-3 Medium (Brown et al. 2020, Table 2.1: 24 layers, d_model 1024,
    16 heads of 64) from ``GPTConfig``'s fields, vocab 50304 as the port's
    GPT-3 1.3B."""
    return GPTConfig(**{**dict(hidden_size=1024, num_layers=24,
                               num_heads=16), **over})


STREAM_TC = ("flash_packed_fwd_stream_tc", "flash_packed_bwd_dq_tc",
             "flash_packed_bwd_dkv_tc")


def phase_train_recompute_k4_bf16(torch, np, hfa, hfp, peaks,
                                  GPTForCausalLM, GPTConfig, amp, AdamW,
                                  make_sharded_train_step):
    """GPT-3 Medium at its published width, B=4 x 2048, AMP-O2 AdamW, 2
    warm-up and 4 timed steps without recompute, with ``recompute=True``
    under the default policy, and under ``None``: by ``plan(2048, 2048,
    16)`` attention runs K4's streamed forward, dq and dk/dv (their
    tensor-core bodies). The policy keeps K4's ``(o, lse)`` (the operator
    ``paddle_tpu_torch::flash_packed_fwd``): the forward 24 launches a step,
    48 under ``None``; dq and dk/dv 24 each. Step p50 and peak memory of
    each. Then a 2-layer cut in f32 (B=1 x 2048, the float32 bodies): loss
    and gradients bit-equal with and without the policy."""
    import contextlib
    from paddle_tpu_torch.core.random import make_key
    check(tuple(hfp.plan(2048, 2048, 16)) == ("stream", "dq", "stream"),
          f"plan(2048, 2048, 16) = {hfp.plan(2048, 2048, 16)}")
    b, s, warmup, timed = 4, 2048, 2, 4
    rows, launches_all = {}, {}
    for mode in ("off", "dots_and_flash_saveable", None):
        cfg = gpt3_medium(GPTConfig, recompute=mode != "off",
                          recompute_policy=None if mode == "off" else mode)
        model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                               seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    multi_precision=True)
        model, opt = amp.decorate(model, opt, level="O2")
        step = make_sharded_train_step(model, opt, gpt_loss)
        it = iter(bench_batches(np, warmup + timed, b, s, cfg.vocab_size))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(hfa, hfp)
        losses, times = timed_steps(torch, lambda: step.step(next(it)),
                                    warmup, timed)
        launches = k4_counts(hfa, hfp)
        n = cfg.num_layers * len(losses)
        check_launches(launches, {
            "flash_packed_fwd_stream_tc": n * (2 if mode is None else 1),
            "flash_packed_bwd_dq_tc": n, "flash_packed_bwd_dkv_tc": n},
            f"GPT-3 Medium recompute {mode}")
        for name, count in launches.items():
            launches_all[name] = launches_all.get(name, 0) + count
        tokens_per_s = timed * b * s / (sum(times) / 1e3)
        flops_per_token = 6 * n_params + 6 * cfg.num_layers * s * \
            cfg.hidden_size
        row = {"phase": "train_recompute_k4_bf16", "clocks": card_clocks(),
               "model": "gpt3_medium", "layers": cfg.num_layers,
               "params": n_params, "batch": [b, s],
               "recompute": mode != "off",
               "recompute_policy": None if mode == "off" else mode,
               "losses": losses, "step_ms": times,
               "step_p50_ms": percentile(times, 50),
               "step_p99_ms": percentile(times, 99),
               "tokens_per_s": tokens_per_s,
               "mfu": flops_per_token * tokens_per_s / peaks["bf16"],
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "launches_per_step": {k: v / len(losses) for k, v in
                                     launches.items() if v}}
        emit(row)
        rows[mode] = row
        check(all(math.isfinite(x) for x in losses),
              f"non-finite GPT-3 Medium loss: {row}")
        del model, opt, step
        torch.cuda.empty_cache()
    peak = {m: rows[m]["max_memory_allocated_gb"] for m in rows}
    check(peak["dots_and_flash_saveable"] <= peak["off"] and
          peak[None] < peak["dots_and_flash_saveable"],
          f"GPT-3 Medium peaks off / policy / None: {peak}")
    # the f32 cut: bit-equal with and without the policy
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, 50304, (1, s)), device="cuda")
    labels = torch.roll(ids, -1, dims=1)
    zero_counts(hfa, hfp)
    res = grad_pair(torch, lambda c: GPTForCausalLM(
        c, device="cuda", dtype=torch.float32, seed=0),
        lambda r: gpt3_medium(GPTConfig, num_layers=2, recompute=r), ids,
        labels, make_key(3), contextlib.nullcontext)
    launches = k4_counts(hfa, hfp)
    check_launches(launches, {"flash_packed_fwd_stream": 4,
                              "flash_packed_bwd_dq": 4,
                              "flash_packed_bwd_dkv": 4},
                   "train_recompute_k4 f32 cut")
    equal = total = 0
    for name, g in res[True][1].items():
        equal += int((g == res[False][1][name]).sum())
        total += g.numel()
    cut = {"phase": "train_recompute_k4_f32_cut", "layers": 2,
           "batch": [1, s], "loss": res[False][0],
           "loss_recompute": res[True][0], "bit_equal_share": equal / total,
           "grad_elements": total, "launches": launches}
    emit(cut)
    check(res[True][0] == res[False][0] and equal == total,
          f"the policy's gradients are not bit-equal: {cut}")
    torch.cuda.empty_cache()
    return launches_all


# -- the ResNet family, sampling and resilience ------------------------------

#: Wide ResNet-50-2's convs that ResNet-50 does not run (B=256, 224² input,
#: bf16, the prologue with ReLU and the stats on, as the training step runs
#: them): its 3x3s at 128, 256, 512 and 1024 channels and their stride-2
#: entries, and its 1x1s into and out of those widths
WIDE_CONV_CASES = [
    (f"wide_{k}x{k}_s{s}_{h}_{cin}to{cout}",
     "conv3x3" if k == 3 else "conv1x1", 256, h, h, cin, cout, s, "relu",
     True, "bf16")
    for k, h, cin, cout, s in (
        (3, 56, 128, 128, 1), (3, 28, 256, 256, 1), (3, 14, 512, 512, 1),
        (3, 7, 1024, 1024, 1), (3, 56, 256, 256, 2), (3, 28, 512, 512, 2),
        (3, 14, 1024, 1024, 2),
        (1, 56, 64, 128, 1), (1, 56, 256, 128, 1), (1, 56, 128, 256, 1),
        (1, 56, 256, 256, 1), (1, 28, 512, 256, 1), (1, 28, 256, 512, 1),
        (1, 28, 512, 512, 1), (1, 14, 1024, 512, 1), (1, 14, 512, 1024, 1),
        (1, 14, 1024, 1024, 1), (1, 7, 2048, 1024, 1),
        (1, 7, 1024, 2048, 1))]


def phase_kernel_conv_wide(torch, hc, peaks):
    """K5-K8 against their plain versions at Wide ResNet-50-2's new shapes
    (``WIDE_CONV_CASES``: the forward with the prologue and stats, the
    input gradient, K7's stride-2 one by phases, and the weight gradient),
    then K7's forward and K8 at each of its seven 3x3 shapes timed beside
    cuDNN (channels-last bf16 on the prologued input, no stats) and their
    bounds. Returns each kernel's largest error and the 3x3 timings."""
    import torch.nn.functional as TF
    g = torch.Generator(device="cuda")
    g.manual_seed(19)
    rows, worst = [], {name: 0.0 for name in CONV_KERNELS}
    for case in WIDE_CONV_CASES:
        row, errs = conv_case(torch, hc, case, g)
        rows.append(row)
        for kname, (err, _) in errs.items():
            worst[kname] = max(worst[kname], err)
        torch.cuda.empty_cache()
    timing = {}
    bf = torch.bfloat16
    for name, kind, n, h, w, cin, cout, s, *_ in WIDE_CONV_CASES:
        if kind != "conv3x3":
            continue
        ho = (h - 1) // s + 1
        x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(bf)
        wgt = (torch.randn(cout, cin, 3, 3, generator=g, device="cuda") *
               (cin * 9) ** -0.5).to(bf)
        sc = torch.randn(cin, generator=g, device="cuda")
        sh = torch.randn(cin, generator=g, device="cuda")
        dy = torch.randn(n, ho, ho, cout, generator=g, device="cuda").to(bf)
        wt = hc.fwd_weight(wgt, bf)
        a_t = hc._prologue(x, sc, sh, "relu").permute(0, 3, 1, 2)
        dy_t = dy.permute(0, 3, 1, 2)
        w_cl = wgt.contiguous(memory_format=torch.channels_last)
        m_out, m_in = n * ho * ho, n * h * w
        flops = 2 * m_out * cin * cout * 9
        row = {}
        for part, kern, lib, nbytes in (
                ("c3", lambda: hc.c3(x, wt, sc, sh, "relu", True, s),
                 lambda: TF.conv2d(a_t, w_cl, stride=s, padding=1),
                 m_in * cin * 2 + wgt.numel() * 2 + m_out * cout * 2),
                ("c3_wgrad", lambda: hc.c3_wgrad(x, dy, sc, sh, "relu", s),
                 lambda: torch.nn.grad.conv2d_weight(
                     a_t, wgt.shape, dy_t, stride=s, padding=1),
                 m_in * cin * 2 + m_out * cout * 2 + wgt.numel() * 4)):
            ms = median_ms(kern)
            bound, by = conv_bound(peaks, flops, nbytes)
            row[part] = {"kernel_ms": ms, "library_ms": median_ms(lib),
                         "bound_ms": bound, "bound_by": by, "flops": flops,
                         "bytes": nbytes, "tflops": flops / ms / 1e9}
        timing[f"3x3 {n}x{h}x{w} {cin}->{cout} s{s}"] = row
        del x, dy, a_t, dy_t
        torch.cuda.empty_cache()
    emit({"phase": "kernel_conv", "part": "wide", "cases": rows,
          "timing": timing, "peak_sheet": peaks["sheet"],
          "library": "cuDNN through torch in channels-last bf16 on the "
                     "prologued input: F.conv2d and "
                     "torch.nn.grad.conv2d_weight (no prologue, no stats)"})
    return worst, timing


def phase_pool_ties(torch, PF):
    """``max_pool2d_with_index`` on the card against the CPU, bit for bit:
    ReLU outputs (about half zeros, so many windows tie) at ResNet's
    max-pool (3x3, stride 2, padding 1) on 64 channels at 112², a 2x2
    stride-2 pool over an all-zero block, and padding past half the
    kernel (kernel 3, padding 2 and 3: windows of padding only give
    ``-inf`` and their top-left index). Ties take the first position of
    the window in row-major order, as ``jnp.argmax`` does."""
    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    x = torch.relu(torch.randn(8, 64, 112, 112, generator=g,
                               device="cuda"))
    rows = []
    for k, s, p, xin in ((3, 2, 1, x), (2, 2, 0, torch.zeros_like(x)),
                         (3, 1, 2, x[:, :, :9, :9]),
                         (3, 2, 3, x[:, :, :9, :9])):
        pooled, mask = PF.max_pool2d_with_index(xin, k, s, p)
        cp, cm = PF.max_pool2d_with_index(xin.cpu(), k, s, p)
        win = PF.max_pool2d(xin, k, s, p)
        # a window whose largest value is a ReLU zero ties at every real
        # position
        ties = int((pooled == 0).sum())
        rows.append({"kernel": k, "stride": s, "padding": p,
                     "shape": list(xin.shape),
                     "pooled_equal": bool(torch.equal(pooled.cpu(), cp)),
                     "mask_equal": bool(torch.equal(mask.cpu(), cm)),
                     "max_pool2d_equal": bool(torch.equal(win, pooled)),
                     "tied_windows": ties})
    emit({"phase": "pool_ties", "cases": rows})
    check(all(r["pooled_equal"] and r["mask_equal"] and
              r["max_pool2d_equal"] for r in rows) and rows[0]["tied_windows"],
          f"max_pool2d_with_index differs on the card: {rows}")
    check(bool(torch.equal(PF.max_pool2d_with_index(
        torch.zeros(1, 1, 4, 4, device="cuda"), 2, 2, 0)[1].cpu(),
        torch.tensor([[[[0, 2], [8, 10]]]]))),
        "a window of equal values does not take its first position")


def block_convs(model):
    """The bottleneck convs a training step runs on K5-K8: ``(1x1 convs,
    ungrouped 3x3 convs)``. Each 1x1 is a K5 forward, a K5 input gradient
    and a K6; each ungrouped 3x3 a K7 forward, a K7 input gradient and a
    K8. A grouped 3x3 takes the library conv (``supports`` refuses
    groups), as do the stem and the fc."""
    n1 = n3 = 0
    for layer in (model.layer1, model.layer2, model.layer3, model.layer4):
        for blk in layer:
            n1 += 2 + (blk.downsample is not None)
            n3 += blk.conv2.groups == 1
    return n1, n3


def structure_launches(model):
    n1, n3 = block_convs(model)
    return {"mm": 2 * n1, "mm_wgrad": n1, "c3": 2 * n3, "c3_wgrad": n3}


def checked_engine(base):
    """``base`` (a ``ServingEngine`` class) for the earlier serving phases:
    after every ``step()`` (``serve`` steps too) no request may have
    failed, ``engine.diagnostics`` stays empty."""
    class Engine(base):
        def step(self):
            out = super().step()
            check(not self.diagnostics,
                  f"a request failed on a serving path: "
                  f"{[d.message for d in self.diagnostics]}")
            return out
    return Engine


def phase_generate_sample_bf16(torch, np, hfa, hfp, model):
    """``generate`` sampling on GPT-3 1.3B in bf16: B=4, a 128-token prompt,
    64 new tokens, ``do_sample`` with ``top_k=50``, ``top_p=0.9``,
    ``temperature=0.8``. The same seed gives the same tokens and another
    seed others; ``do_sample=False`` equals the argmax loop of the raw
    logits (greedy as it was before sampling); every sampled token
    survived its step's filters (inside the top 50 and the top-p set),
    read inside the run from ``filter_logits``' output. ms a token (the
    whole batch of 4 a step)."""
    from paddle_tpu_torch.text.models import gpt as tgpt
    b, plen, new = 4, 128, 64
    rng = np.random.default_rng(21)
    ids = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, (b, plen)),
                          device="cuda")
    kw = dict(max_new_tokens=new, do_sample=True, top_k=50, top_p=0.9,
              temperature=0.8)
    zero_counts(hfa, hfp)
    model.generate(ids, seed=1, **kw)          # warm-up
    times = []
    outs = {}
    for seed in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[seed] = model.generate(ids, seed=seed, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / new)
    kept, real = [], tgpt.filter_logits

    def recording(logits, top_k, top_p):
        out = real(logits, top_k, top_p)
        kept.append(torch.isfinite(out))
        return out

    tgpt.filter_logits = recording
    try:
        again = model.generate(ids, seed=1, **kw)
    finally:
        tgpt.filter_logits = real
    # each sampled token survived its step's filters: inside the top 50
    # (ties at the 50th kept) and the top-p set
    inside = len(kept) == new and all(
        bool(mask.gather(1, again[:, plen + i:plen + i + 1])[:, 0].all())
        for i, mask in enumerate(kept))
    greedy = model.generate(ids, max_new_tokens=new)
    out, cache = [ids], model.gpt.init_cache(b, plen + new)
    with torch.no_grad():
        hidden, cache = model.gpt.decode(ids, cache, 0)
        tok = torch.argmax(model.logits(hidden[:, -1:])[:, 0], -1)
        for off in range(plen, plen + new):
            out.append(tok[:, None])
            if off == plen + new - 1:
                break
            hidden, cache = model.gpt.decode(tok[:, None], cache, off)
            tok = torch.argmax(model.logits(hidden)[:, 0], -1)
    launches = k4_counts(hfa, hfp)
    row = {"phase": "generate_sample_bf16", "model": "gpt3_1p3b",
           "batch": b, "prompt": plen, "new_tokens": new,
           "sampling": {k: v for k, v in kw.items() if k != "max_new_tokens"},
           "same_seed_equal": bool(torch.equal(outs[1], again)),
           "other_seed_differs": not bool(torch.equal(outs[1], outs[2])),
           "greedy_equal": bool(torch.equal(greedy, torch.cat(out, 1))),
           "inside_top_k": inside, "steps_recorded": len(kept),
           "ms_per_token": times,
           "distinct_tokens": int(torch.unique(outs[1][:, plen:]).numel()),
           "launches": {k: v for k, v in launches.items() if v}}
    emit(row)
    check(row["same_seed_equal"] and row["other_seed_differs"] and
          row["greedy_equal"] and inside,
          f"generate_sample_bf16: {row}")
    check(not any(launches.values()),
          f"generate launched attention kernels: {row}")


def overload_trace(np, Request, vocab):
    """bench.py's overload trace (``bench_serve_resilience``, seed 11): the
    pool hog first, then 16 requests, every third with a deadline already
    past (1 ns) at priority 0, the rest 120 s at priority 1."""
    rng = np.random.default_rng(11)
    trace = [Request(rid="hog", prompt_ids=rng.integers(0, vocab, 120),
                     max_new_tokens=8, deadline_s=120.0, priority=2)]
    for i in range(16):
        plen = int(rng.integers(16, 33))
        tight = i % 3 == 2
        trace.append(Request(
            rid=f"ov{i}", prompt_ids=rng.integers(0, vocab, plen),
            max_new_tokens=16, deadline_s=1e-9 if tight else 120.0,
            priority=0 if tight else 1))
    return trace


def overload_run(np, model, device, trace, Request, ServingEngine,
                 ShedPolicy, SpillError, register_fire_point):
    """The trace through a starved engine (16 blocks of 8 tokens,
    ``max_batch=4``, ``max_waiting=8``, the degrade-mode policy,
    ``validate_capacity=False``) with a ``SpillError`` at the first
    spill. Returns the engine, its results and the fire point's calls."""
    eng = ServingEngine(
        model, block_size=8, num_blocks=16, max_batch=4,
        max_seq_len=model.cfg.max_position_embeddings, max_waiting=8,
        shed_policy=ShedPolicy(min_free_block_frac=0.2,
                               max_p99_decode_ms=5e3, degrade=True),
        validate_capacity=False, device=device)
    spills = [0]

    def bomb():
        spills[0] += 1
        if spills[0] == 1:
            raise SpillError("injected host allocation failure (overload "
                             "trace)")

    register_fire_point("serve.mid_spill", bomb)
    try:
        res = eng.serve(trace)
    finally:
        register_fire_point("serve.mid_spill", None)
    return eng, res, spills[0]


def bf16_near_tie(torch, model, prefix):
    """The top-2 logit gap after ``prefix`` (as ``top2_gap``) and the rule's
    bound in bf16: 8 units in the last place of the top logit (the paged
    decode and generate's dense decode round each layer's activations in
    other orders)."""
    gap = top2_gap(torch, model, prefix)
    with torch.no_grad():
        ids = torch.as_tensor(prefix, device=model.device)[None].long()
        caches = model.gpt.init_cache(1, ids.shape[1])
        hidden, _ = model.gpt.decode(ids, caches, 0)
        top = float(model.logits(hidden[:, -1])[0].float().abs().max())
    return gap, 8 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def phase_serve_resilience(torch, np, hfa, model, Request, ServingEngine,
                           ShedPolicy, SpillError, register_fire_point,
                           RequestJournal, part):
    """bench.py's overload leg (``bench_serve_resilience``, ``:1893-1925``)
    on GPT-3 1.3B, K1's prefill (``part`` "f32": its float32 body;
    "bf16": its tensor-core body): the hog and 16 requests through the
    starved engine with the journal armed in a temporary directory. A CPU
    dry run of the same lengths on a one-layer model decides every
    request's ending (no eos: the lengths, the 1 ns deadlines and the free
    blocks decide); the card must end each the same way. The hog and one
    spill victim end FAILED and nobody else; no block leaks, the scheduler
    is idle; the FINISHED survivors are held to ``generate`` by serve_f32's
    near-tie rule (in bf16 a near tie is a top-2 gap under 8 units in the
    last place of the top logit); the journal is exactly-once. SLO
    attainment (deadline-carrying requests FINISHED within their deadline,
    of all) and the shed rate ((shed + rejected) / all) come from the
    returned records."""
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny
    vocab, n_layers = model.cfg.vocab_size, model.cfg.num_layers
    max_pos = model.cfg.max_position_embeddings
    trace = overload_trace(np, Request, vocab)
    tiny = GPTForCausalLM(gpt_tiny(vocab_size=64, hidden_size=16,
                                   num_layers=1, num_heads=2,
                                   max_position_embeddings=max_pos),
                          device="cpu")
    dry = [Request(rid=r.rid, prompt_ids=np.zeros(r.prompt_ids.size),
                   max_new_tokens=r.max_new_tokens, deadline_s=r.deadline_s,
                   priority=r.priority) for r in trace]
    _, dres, _ = overload_run(np, tiny, "cpu", dry, Request, ServingEngine,
                              ShedPolicy, SpillError, register_fire_point)

    def ending(r):
        return "rejected:" + r.reason if not r else r.status.value

    want = {rid: ending(r) for rid, r in dres.items()}
    body = "flash_fwd" if part == "f32" else "flash_fwd_tc"
    with tempfile.TemporaryDirectory() as tmp:
        journal = RequestJournal(os.path.join(tmp, "journal.jsonl"))
        hfa.flash_fwd.launches = hfa.flash_fwd_tc.launches = 0
        t0 = time.perf_counter()
        eng, res, spills = overload_run(
            np, model, "cuda", trace, Request,
            lambda *a, **k: ServingEngine(*a, journal=journal, **k),
            ShedPolicy, SpillError, register_fire_point)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": hfa.flash_fwd.launches,
                    "flash_fwd_tc": hfa.flash_fwd_tc.launches}
        journal.close()
        report = RequestJournal(journal.path).exactly_once_report(
            [r.rid for r in trace])
    got = {rid: ending(r) for rid, r in res.items()}
    failed = sorted(rid for rid, e in got.items() if e == "failed")
    finished = [r for r in trace if got[r.rid] == "finished"]
    rows, refs = [], {}
    for r in finished:
        seq = res[r.rid]
        key = (r.prompt_ids.tobytes(), r.max_new_tokens)
        refs[key] = model.generate(
            torch.as_tensor(r.prompt_ids, device="cuda")[None].long(),
            max_new_tokens=r.max_new_tokens)[0].cpu().numpy()
        diff = np.nonzero(seq.output != refs[key])[0]
        row = {"rid": r.rid, "exact": diff.size == 0}
        if diff.size:
            pos = int(diff[0])
            if part == "f32":
                gap, bound = top2_gap(torch, model, refs[key][:pos]), 1e-3
            else:
                gap, bound = bf16_near_tie(torch, model, refs[key][:pos])
            row.update(first_mismatch=pos - int(r.prompt_ids.size),
                       top2_gap=gap, near_tie_bound=bound)
            check(gap < bound, f"serve_resilience {part}: a survivor "
                               f"differs from generate beyond a near-tie: "
                               f"{row}")
        rows.append(row)
    with_deadline = [r for r in trace if r.deadline_s is not None]
    met = sum(1 for r in with_deadline if got[r.rid] == "finished" and
              res[r.rid].t_done - res[r.rid].t_submit <= r.deadline_s)
    outcomes = {}
    for e in got.values():
        outcomes[e.split(":")[0]] = outcomes.get(e.split(":")[0], 0) + 1
    shed = outcomes.get("shed", 0) + outcomes.get("rejected", 0)
    row = {"phase": "serve_resilience_" + part, "model": "gpt3_1p3b",
           "layers": n_layers, "requests": len(trace), "outcomes": outcomes,
           "endings": got, "cpu_dry_run_equal": got == want,
           "failed": failed, "spill_fire_calls": spills,
           "diagnostics": [d.message for d in eng.diagnostics],
           "mode_final": eng.mode, "preemptions": eng.n_preemptions,
           "prefills": eng.n_prefills, "k1_launches": launches,
           "slo_attainment_pct": 100.0 * met / len(with_deadline),
           "shed_rate": shed / len(trace), "wall_s": wall,
           "decode_step_p50_ms": percentile(eng.decode_ms, 50),
           "survivors": rows, "journal": report,
           "blocks_in_use": eng.cache.allocator.n_used}
    emit(row)
    check(got == want, f"serve_resilience {part}: the card ended requests "
                       f"otherwise than the CPU dry run: {row}")
    check(len(failed) == 2 and "hog" in failed and spills >= 1 and
          len(eng.diagnostics) == 2,
          f"serve_resilience {part}: expected the hog and one spill victim "
          f"FAILED: {row}")
    check(eng.cache.allocator.n_used == 0, f"KV blocks leaked: {row}")
    eng.sched.assert_idle()
    check(report["exactly_once"] and not report["lost"] and
          not report["duplicated"], f"journal: {report}")
    check(launches[body] == eng.n_prefills * n_layers and
          sum(launches.values()) == launches[body],
          f"serve_resilience {part}: K1 launches {launches} for "
          f"{eng.n_prefills} prefills")
    return {body: launches[body]}


# -- telemetry ---------------------------------------------------------------

#: the CUDA kernels of K1-K3's tensor-core bodies, as a profiler names them
TELEMETRY_KERNELS = {"flash_fwd_tc": "flash_fwd_tc_kernel",
                     "flash_bwd_dq_tc": "flash_bwd_dq_tc_kernel",
                     "flash_bwd_dkv_tc": "flash_bwd_dkv_tc_kernel"}


def ab_order(window, arms):
    """The arms' order in a window: as given in even windows, reversed in
    odd ones, so a drift across the windows weighs on both arms alike."""
    return arms if window % 2 == 0 else arms[::-1]


def launch_delta(before, after):
    return {n: after[n] - before[n] for n in after}


def add_counts(total, delta):
    for n, d in delta.items():
        total[n] = total.get(n, 0) + d


def serving_series(snap):
    """``{family[labels]: value}`` of the non-zero ``serving.*`` series,
    histograms by count."""
    out = {}
    for name, fam in snap.items():
        if not name.startswith("serving."):
            continue
        for s in fam["series"]:
            v = s["value"]["count"] if fam["type"] == "histogram" \
                else s["value"]
            if v:
                lab = ",".join(f"{k}={v}" for k, v in
                               sorted(s["labels"].items()))
                out[name + (f"{{{lab}}}" if lab else "")] = v
    return out


def phase_telemetry_serve(torch, np, hfa, hfp, hc, fmb, model, Request,
                          ServingEngine, flags, obs, num_blocks):
    """Phase telemetry, part serve: serve_bf16's trace (8 requests of
    64..1536 prompt tokens x 32, the pool that preempts) on one engine under
    ``FLAGS_telemetry=off`` and then ``metrics``: equal tokens and kernel
    launches (K1's tensor-core body once a layer a prefill); under metrics
    the compile budget kept with O001 silent, one timeline record per
    request with ttft <= total, the counters equal to the endings and the
    engine's own tallies; under off no series and no record. Then the
    decode-step A/B: 8 requests of 64 prompt tokens x 32 on one engine,
    off and metrics interleaved window by window (4 each, the order
    alternating), each arm's figure the least over windows of the
    window's median decode-iteration wall; tokens equal in every
    window."""
    metrics, timeline = obs.metrics, obs.request_timeline
    n_layers = model.cfg.num_layers
    bs, new = 16, 32
    reqs = bf16_trace(np, Request, model.cfg.vocab_size, new)
    max_seq = max(int(r.prompt_ids.size) for r in reqs) + new
    engine = ServingEngine(model, block_size=bs, num_blocks=num_blocks,
                           max_batch=8, max_seq_len=max_seq, device="cuda")
    runs = {}
    for mode in ("off", "metrics"):
        flags.set_flags({"telemetry": mode})
        metrics.reset_all()
        timeline.reset_default()
        n_pre, n_prem, n_dec = (engine.n_prefills, engine.n_preemptions,
                                len(engine.decode_ms))
        before = path_counts(hfa, hfp, hc, fmb)
        t0 = time.perf_counter()
        res = engine.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[mode] = dict(
            wall_s=wall,
            launches=launch_delta(before, path_counts(hfa, hfp, hc, fmb)),
            tokens={r.rid: res[r.rid].output.tolist() for r in reqs},
            status={r.rid: res[r.rid].status.value for r in reqs},
            prefills=engine.n_prefills - n_pre,
            preemptions=engine.n_preemptions - n_prem,
            decode_iterations=len(engine.decode_ms) - n_dec,
            decode_step_p50_ms=percentile(engine.decode_ms[n_dec:], 50),
            series=serving_series(metrics.snapshot()),
            records=timeline.current().records(),
            summary=timeline.current().summary())
    flags.set_flags({"telemetry": "metrics"})
    off, on = runs["off"], runs["metrics"]
    check(on["tokens"] == off["tokens"],
          "telemetry: the bf16 trace's tokens differ between off and metrics")
    check(on["launches"] == off["launches"],
          f"telemetry: serving launches differ: {off['launches']} vs "
          f"{on['launches']}")
    check(on["launches"]["flash_fwd_tc"] == on["prefills"] * n_layers and
          sum(on["launches"].values()) == on["launches"]["flash_fwd_tc"],
          f"telemetry: serving launched {on['launches']} for "
          f"{on['prefills']} prefills")
    check(set(on["status"].values()) == {"finished"},
          f"telemetry: endings {on['status']}")
    check(on["preemptions"] >= 1, "telemetry: the trace did not preempt")
    report = engine.compile_report()
    check(report["within_budget"] and not report["o001_fired"],
          f"telemetry: compile report {report}")
    recs = on["records"]
    check(sorted(r["rid"] for r in recs) == sorted(r.rid for r in reqs),
          f"telemetry: timeline records {[r['rid'] for r in recs]}")
    for r in recs:
        check(r["outcome"] == "ok" and 0 < r["ttft_ms"] <= r["total_ms"],
              f"telemetry: record {r}")
    s = on["series"]
    want = {"serving.requests": len(reqs),
            "serving.requests_completed": len(reqs),
            "serving.tokens_generated": len(reqs) * new,
            "serving.preemptions": on["preemptions"],
            "serving.kv_spills": on["preemptions"],
            "serving.kv_restores": on["preemptions"],
            "serving.decode_step_ms": on["decode_iterations"],
            "serving.prefill_ms": on["prefills"],
            "serving.request_latency_ms": len(reqs),
            "serving.ttft_ms": len(reqs)}
    got = {k: s.get(k, 0) for k in want}
    check(got == want, f"telemetry: counters {got}, expected {want}")
    check(not off["series"] and not off["records"],
          f"telemetry: under off the engine reported {off['series']}")
    emit({"phase": "telemetry", "part": "serve", "model": "gpt3_1p3b",
          "layers": n_layers, "pool_blocks": num_blocks,
          "prefills": on["prefills"], "preemptions": on["preemptions"],
          "wall_s": {"off": off["wall_s"], "metrics": on["wall_s"]},
          "decode_step_p50_ms": {"off": off["decode_step_p50_ms"],
                                 "metrics": on["decode_step_p50_ms"]},
          "compile_report": report, "counters": got,
          "series": s, "timeline": on["summary"],
          "tokens_equal_off": True, "launches": on["launches"]})

    # the decode-step A/B
    rng = np.random.default_rng(5)
    dreqs = [Request(rid=f"d{i}", prompt_ids=rng.integers(
        0, model.cfg.vocab_size, 64), max_new_tokens=32) for i in range(8)]
    deng = ServingEngine(model, block_size=bs, num_blocks=8 * 6 + 1,
                         max_batch=8, max_seq_len=96, device="cuda")
    deng.serve(dreqs)           # warm: every bucket seen once
    best, tokens, windows = {}, None, []
    ab_launches = {"off": {}, "metrics": {}}
    for w in range(4):
        for mode in ab_order(w, ("off", "metrics")):
            flags.set_flags({"telemetry": mode})
            n0 = len(deng.decode_ms)
            before = path_counts(hfa, hfp, hc, fmb)
            res = deng.serve(dreqs)
            add_counts(ab_launches[mode],
                       launch_delta(before, path_counts(hfa, hfp, hc, fmb)))
            ms = deng.decode_ms[n0:]
            med = percentile(ms, 50)
            windows.append({"mode": mode, "iterations": len(ms),
                            "median_ms": med, "mean_ms": sum(ms) / len(ms)})
            best[mode] = min(best.get(mode, med), med)
            out = {r.rid: res[r.rid].output.tolist() for r in dreqs}
            check(tokens is None or out == tokens,
                  f"telemetry: decode A/B tokens differ under {mode}")
            tokens = out
    flags.set_flags({"telemetry": "metrics"})
    check(ab_launches["off"] == ab_launches["metrics"],
          f"telemetry: decode A/B launches {ab_launches}")
    launches = {m: {n: runs[m]["launches"][n] + ab_launches[m].get(n, 0)
                    for n in runs[m]["launches"]}
                for m in ("off", "metrics")}
    return launches, {
        "decode_step_ms_off": best["off"],
        "decode_step_ms_metrics": best["metrics"],
        "overhead_pct": 100.0 * (best["metrics"] / best["off"] - 1.0),
        "windows": windows, "batch": 8, "prompt_tokens": 64,
        "new_tokens": 32, "tokens_equal": True}


def kernel_enclosure(path, names):
    """Read a torch.profiler chrome trace: for each kernel whose name holds
    one of ``names``, whether its launch (the runtime call of the same
    correlation id) lies inside the host ranges ``step`` and
    ``step/device``, and whether the kernel lies inside their device-side
    spans (``gpu_user_annotation``) where the trace has them. The profiler
    gives a range's device span the kernels launched in the range itself,
    not in the ranges inside it, so ``step``'s holds none of these."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def spans(cat, name):
        return [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                if e.get("cat") == cat and e.get("name") == name]

    def inside(t0, t1, ranges):
        return any(a <= t0 and t1 <= b for a, b in ranges)

    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in
               e.get("args", {})}
    host = {n: spans("user_annotation", n) for n in ("step", "step/device")}
    dev = {n: spans("gpu_user_annotation", n)
           for n in ("step", "step/device")}
    out = {}
    for key, kname in names.items():
        ks = [e for e in events if e.get("cat") == "kernel" and
              kname in e.get("name", "")]
        row = {"kernels": len(ks), "launch_in_step": 0,
               "launch_in_step_device": 0, "device_span_in_step": None,
               "device_span_in_step_device": None}
        if dev["step/device"]:
            row["device_span_in_step"] = row[
                "device_span_in_step_device"] = 0
        for k in ks:
            t0, t1 = k["ts"], k["ts"] + k.get("dur", 0)
            launch = runtime.get(k.get("args", {}).get("correlation"))
            if launch is not None:
                l0, l1 = launch["ts"], launch["ts"] + launch.get("dur", 0)
                row["launch_in_step"] += inside(l0, l1, host["step"])
                row["launch_in_step_device"] += inside(
                    l0, l1, host["step/device"])
            if dev["step/device"]:
                row["device_span_in_step"] += inside(t0, t1, dev["step"])
                row["device_span_in_step_device"] += inside(
                    t0, t1, dev["step/device"])
        out[key] = row
    return out, {n: len(v) for n, v in host.items()}, \
        {n: len(v) for n, v in dev.items()}


def mlp_ab(torch, P, step_of, flags, obs, arm_key, arms, steps=30,
           windows=5):
    """bench.py's overhead A/B (``bench_telemetry_overhead``,
    ``bench_flight_recorder_overhead``): bench.py's MLP (B = 64, hidden
    2048, three Linears, Tanh, AdamW 1e-3) through one TrainStep, the two
    arms interleaved window by window (the order alternating), each window
    ``steps`` steps from one saved state on one batch; each arm's figure
    the least over windows of the wall a step (synchronised at the
    window's end). Every window's losses and parameters must be
    bit-equal."""
    batch, hidden = 64, 2048
    P.seed(0)
    net = torch.nn.Sequential(
        P.nn.Linear(hidden, hidden, device="cuda"), torch.nn.Tanh(),
        P.nn.Linear(hidden, hidden, device="cuda"), torch.nn.Tanh(),
        P.nn.Linear(hidden, 10, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, hidden, device="cuda", generator=g)
    y = torch.randint(0, 10, (batch,), device="cuda", generator=g)
    step = step_of(net, P.optimizer.AdamW(1e-3),
                   lambda m, b: P.nn.functional.cross_entropy(m(b[0]), b[1]))
    step.step((x, y))
    step.step((x, y))
    state = step.state_dict()
    best, ref, per_window = {}, None, []
    for w in range(windows):
        for mode in ab_order(w, arms):
            flags.set_flags({arm_key: mode})
            step.load_state_dict(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step.step((x, y), index=3 + i) for i in range(steps)]
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / steps * 1e3
            best[mode] = min(best.get(mode, dt), dt)
            per_window.append((mode, dt))
            got = (torch.stack(losses),
                   [p.detach().clone() for p in step.params.values()])
            if ref is None:
                ref = got
            check(torch.equal(got[0], ref[0]) and all(
                torch.equal(a, b) for a, b in zip(got[1], ref[1])),
                f"telemetry: MLP A/B ({arm_key}={mode}) not bit-equal")
    a, b = arms
    return {f"step_ms_{a}": best[a], f"step_ms_{b}": best[b],
            "overhead_pct": 100.0 * (best[b] / best[a] - 1.0),
            "steps_per_window": steps, "windows": windows,
            "window_ms": per_window, "batch": batch, "hidden": hidden,
            "bit_equal": True}


def phase_telemetry_train(torch, np, hfa, hfp, hc, fmb, step, batches,
                          flags, obs, P, make_sharded_train_step, smi_line,
                          serve_launches, decode_ab):
    """Phase telemetry, part train, on train_bf16's GPT-3 1.3B TrainStep
    (B=4 x 2048, AMP-O2 AdamW) right after its timed steps: the overhead
    A/B of the step (off and metrics interleaved, 3 windows of 3 steps
    each from one saved state, bit-equal losses and parameters, K1-K3's
    launches equal); the step record's ``hbm_peak_gb`` against
    ``torch.cuda.max_memory_allocated()``; one step under
    ``FLAGS_telemetry=trace`` in a torch.profiler capture, where the
    ``step`` and ``step/device`` ranges hold K1's, K2's and K3's kernels;
    the flight recorder armed on a temporary directory over two steps and
    replayed; then bench.py's MLP A/Bs of the metrics layer and of the
    flight recorder. Prints the overhead line with the card's name and
    power limit."""
    sm, fr = obs.step_monitor, obs.flight_recorder
    feed = batches[:3]
    n_layers = step.model.cfg.num_layers
    tl = sm.reset_default()
    state = step.state_dict()
    base = step.step_count
    best, ref, launches = {}, None, {"off": {}, "metrics": {}}
    per_window = []
    for w in range(3):
        for mode in ab_order(w, ("off", "metrics")):
            flags.set_flags({"telemetry": mode})
            step.load_state_dict(state)
            torch.cuda.synchronize()
            before = path_counts(hfa, hfp, hc, fmb)
            t0 = time.perf_counter()
            losses = [step.step(b, index=base + 1 + i)
                      for i, b in enumerate(feed)]
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / len(feed) * 1e3
            per_window.append((mode, dt))
            add_counts(launches[mode],
                       launch_delta(before, path_counts(hfa, hfp, hc, fmb)))
            best[mode] = min(best.get(mode, dt), dt)
            got = ([float(x) for x in losses],
                   [p.detach().clone() for p in step.params.values()])
            if ref is None:
                ref = got
            else:
                check(got[0] == ref[0] and all(
                    torch.equal(a, b) for a, b in zip(got[1], ref[1])),
                    f"telemetry: GPT A/B under {mode} not bit-equal: "
                    f"{got[0]} vs {ref[0]}")
            del got
    del ref, state
    torch.cuda.empty_cache()
    flags.set_flags({"telemetry": "metrics"})
    check(launches["off"] == launches["metrics"],
          f"telemetry: train launches {launches}")
    for name in TELEMETRY_KERNELS:
        check(launches["metrics"][name] == n_layers * 9,
              f"telemetry: {name} launched {launches['metrics'][name]} "
              f"times in 9 steps")
    # the fresh timeline's sentinel first sees the signature in the first
    # metrics window: that dispatch is "compile", the rest "device"
    recs = tl.steps()
    check(len(recs) == 9 and [sorted(r["phases"]) for r in recs] ==
          [["compile", "h2d"]] + [["device", "h2d"]] * 8 and
          all(r["index"] == base + 1 + i % 3 for i, r in enumerate(recs)),
          f"telemetry: step records {[sorted(r['phases']) for r in recs]}")
    peak_gb = recs[-1]["hbm_peak_gb"]
    torch_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(abs(peak_gb - torch_gb) <= 1e-3,
          f"telemetry: hbm_peak_gb {peak_gb} vs allocator {torch_gb}")
    # the host cost of one HBM sample (a step's end pays one)
    t0 = time.perf_counter()
    for _ in range(200):
        tl.sample_hbm()
    hbm = {"hbm_peak_gb": peak_gb, "hbm_live_gb": recs[-1]["hbm_live_gb"],
           "max_memory_allocated_gib": torch_gb,
           "sample_hbm_us": (time.perf_counter() - t0) / 200 * 1e6}

    # one step under trace in a profiler capture
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    flags.set_flags({"telemetry": "trace"})
    obs.trace.clear()
    try:
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            step.step(feed[0], index=base + 10)
            torch.cuda.synchronize()
    finally:
        flags.set_flags({"telemetry": "metrics"})
    spans = [s["name"] for s in obs.trace.spans()]
    obs.trace.clear()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "train_step.json")
        prof.export_chrome_trace(path)
        enclosure, host_ranges, dev_ranges = kernel_enclosure(
            path, TELEMETRY_KERNELS)
    check(host_ranges["step"] == 1 and host_ranges["step/device"] == 1,
          f"telemetry: the capture's host ranges {host_ranges}")
    for name, row in enclosure.items():
        check(row["kernels"] == n_layers and
              row["launch_in_step"] == row["launch_in_step_device"] ==
              n_layers,
              f"telemetry: {name} in the capture: {row}")
        # a device span covers the kernels launched in its own range,
        # not its children's: "step/device"'s holds the step's kernels
        if row["device_span_in_step_device"] is not None:
            check(row["device_span_in_step_device"] == n_layers,
                  f"telemetry: {name} outside step/device's device span: "
                  f"{row}")
    check(set(spans) >= {"step", "step/h2d", "step/device"},
          f"telemetry: spans {spans}")

    # the flight recorder over two steps
    flags.set_flags({"flight_recorder": "on"})
    try:
        with tempfile.TemporaryDirectory() as d:
            box = fr.arm(d, "trainer", run_id="chip_smoke")
            for i, b in enumerate(feed[:2]):
                step.step(b, index=base + 20 + i)
            fr.disarm()
            meta, frecs, rep = fr.replay(box.path)
    finally:
        fr.disarm()
        flags.set_flags({"flight_recorder": "off"})
    fsteps = [(r["step"], r["index"]) for r in frecs if r["k"] == "step"]
    check([i for _, i in fsteps] == [base + 20, base + 21] and
          rep["frames_torn"] == 0 and rep["contiguous"],
          f"telemetry: flight recorder replay {fsteps}, {rep}")
    emit({"phase": "telemetry", "part": "train", "model": "gpt3_1p3b",
          "layers": n_layers, "batch": [4, 2048], "hbm": hbm,
          "step_records": len(recs), "profile": {
              "kernels": enclosure, "host_ranges": host_ranges,
              "device_ranges": dev_ranges},
          "flight_recorder": {"steps": fsteps, "report": rep,
                              "meta_role": meta["role"]},
          "launches": launches["metrics"]})
    gpt = {"step_ms_off": best["off"], "step_ms_metrics": best["metrics"],
           "overhead_pct": 100.0 * (best["metrics"] / best["off"] - 1.0),
           "steps_per_window": 3, "windows": 3, "window_ms": per_window,
           "bit_equal": True}

    # bench.py's MLP: the metrics layer, then the flight recorder
    mlp = mlp_ab(torch, P, make_sharded_train_step, flags, obs, "telemetry",
                 ("off", "metrics"))
    with tempfile.TemporaryDirectory() as d:
        fr.arm(d, "bench", run_id="chip_smoke_flight_recorder")
        try:
            mlp_fr = mlp_ab(torch, P, make_sharded_train_step, flags, obs,
                            "flight_recorder", ("off", "on"))
        finally:
            fr.disarm()
            flags.set_flags({"flight_recorder": "off"})
    emit({"phase": "telemetry", "part": "overhead", "card": smi_line,
          "mlp": mlp, "mlp_flight_recorder": mlp_fr, "gpt_train": gpt,
          "decode": decode_ab,
          "method": "one object for both arms, interleaved window by "
                    "window, each arm's figure the least over windows"})
    total = {}
    for m in ("off", "metrics"):
        total[m] = {n: serve_launches[m].get(n, 0) + launches[m].get(n, 0)
                    for n in launches[m]}
    return total


# -- tune_conv and surface -------------------------------------------------

#: the tolerance between the ResNet-50 losses with and without the autotune
#: cache, each step: a cached choice changes only the order in which the
#: stats' f32 partials are summed, so BN's statistics move in their last
#: bits and bf16 roundings downstream flip; 2% of the loss, set before the
#: first run
TUNE_LOSS_REL = 2e-2


def phase_tune_conv(torch, np, hc, flags, resnet50, Momentum,
                    make_sharded_train_step, warmup=2, timed=3):
    """Phase tune_conv: ``tune_conv_shapes()`` in bf16 at
    ``RESNET50_TOP3_SHAPES`` (B=256, full width) into a temporary cache
    file (``FLAGS_kernel_autotune_cache_path``); then, at each shape, every
    candidate's median time (the forward with the ReLU prologue and the
    stats), y and the stats held to the plain version at the
    tolerance the plan's own choice is held to (``hold_conv``), the winner
    and the plan's own choice with their times; ``k5_plan``/``c3_bands``
    under the conv's key return the cached winner, ignore an entry that is
    not a candidate, and return the winner again once it is back (a sample
    is five calls back to back, as ``k5_stages`` times K5). Then
    ResNet-50 (bench.py's config 2 setting, two models from one seed) with
    the cache (``FLAGS_kernel_autotune=1``) and without (0), step by step
    in turns (``warmup`` + ``timed`` steps each), both step times and
    losses, the losses held to each other within ``TUNE_LOSS_REL``.
    Returns the phase's row."""
    from paddle_tpu_torch.ops._hopper import autotune as at
    tmp = tempfile.mkdtemp(prefix="tune_conv_")
    path = os.path.join(tmp, "autotune.json")
    prev = flags.get_flags(["kernel_autotune_cache_path", "kernel_autotune"])
    flags.set_flags({"kernel_autotune_cache_path": path,
                     "kernel_autotune": 1})
    at._cache = None
    try:
        t0 = time.perf_counter()
        won = hc.tune_conv_shapes()
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        check(os.path.exists(path) and len(won) == 3,
              f"tune_conv_shapes stored {won} in {path}")
        g = torch.Generator(device="cuda")
        g.manual_seed(21)
        bf = torch.bfloat16
        lib = hc._library()
        shapes = []
        for kind, n, h, w, cin, cout, s in hc.RESNET50_TOP3_SHAPES:
            k = 1 if kind == "conv1x1" else 3
            x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(bf)
            wt = (torch.randn(k * k, cin, cout, generator=g, device="cuda") *
                  (cin * k * k) ** -0.5).to(bf)
            sc = torch.randn(cin, generator=g, device="cuda")
            sh = torch.randn(cin, generator=g, device="cuda")
            if k == 1:
                ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
                m = n * ho * wo
                kernel, key = "pallas_conv1x1", hc._mm_key(m, cin, cout, bf)
                cands = hc.k5_candidates(cin)
                pl = hc.k5_plan(m, cin, cout)
                own = (pl.warps_m, pl.warps_n, pl.stages)

                def launch(c, x=x, wt=wt, sc=sc, sh=sh, s=s):
                    return hc._mm_tc_launch(lib, "tune_conv (K5)", x, wt[0],
                                            sc, sh, "relu", True, s, c)

                ref = hc.mm_reference(x, wt[0], sc, sh, "relu", True, s)

                def plan_of(c, m=m, cout=cout):
                    return hc._k5_plan_of(m, cout, *c)

                def planned(m=m, cin=cin, cout=cout, key=key):
                    return hc.k5_plan(m, cin, cout, key)
            else:
                ho, wo = (h + 2 - 3) // s + 1, (w + 2 - 3) // s + 1
                kernel, key = "pallas_conv3x3", hc._c3_key(n, h, w, cin, cout,
                                                           s, bf)
                cands = hc.c3_candidates(n, ho, wo, s)
                bd = hc.c3_bands(n, ho, wo, s)
                own = (bd.band_n, bd.band_h, bd.band_w)

                def launch(c, x=x, wt=wt, sc=sc, sh=sh, s=s, hw=(ho, wo)):
                    return hc._c3_tc_launch(lib, "tune_conv (K7)", x, wt, sc,
                                            sh, "relu", True, s, hw, 1, c)

                ref = hc.c3_reference(x, wt, sc, sh, "relu", True, s,
                                      (ho, wo))

                def plan_of(c, n=n, ho=ho, wo=wo):
                    return hc._c3_bands_of(n, ho, wo, *c)

                def planned(n=n, ho=ho, wo=wo, s=s, key=key):
                    return hc.c3_bands(n, ho, wo, s, 1, key)
            winner = won[(kernel, key)]
            check(winner in cands and own in cands,
                  f"{kernel} {key}: winner {winner}, plan {own}, "
                  f"candidates {cands}")
            cand_rows = []
            for c in cands:
                row = {"choice": list(c)}
                got = launch(c)
                torch.cuda.synchronize()
                hold_conv(torch, "fwd", got, ref, "bf16", row, stats=True)
                del got
                check(row["ok"], f"{kernel} {key} choice {c} disagrees with "
                                 f"the plain version: {row}")
                row["ms"] = median_ms(lambda: launch(c), reps=5)
                cand_rows.append(row)
            del ref, x
            ent = at.get_cache().stats()[f"{kernel}|{at.chip_kind()}|{key}"]
            reads = {"cached": planned() == plan_of(winner)}
            at.get_cache().put(kernel, key, [99, 99, 99], 0.0)
            reads["invalid_ignored"] = planned() == plan_of(own)
            at.get_cache().put(kernel, key, list(winner),
                               ent["measured_ms"])
            reads["restored"] = planned() == plan_of(winner)
            check(all(reads.values()), f"{kernel} {key}: the plan's cache "
                                       f"reads {reads}")
            ms = {tuple(r["choice"]): r["ms"] for r in cand_rows}
            shapes.append({
                "shape": [kind, n, h, w, cin, cout, s], "kernel": kernel,
                "key": key, "candidates": cand_rows, "winner": list(winner),
                "winner_ms": ms[winner], "sweep_ms": ent["measured_ms"],
                "plan": list(own), "plan_ms": ms[own],
                "plan_over_winner": ms[own] / ms[winner],
                "best_by_median": list(min(ms, key=ms.get)),
                "plan_reads": reads})
        # ResNet-50 with and without the cache, step by step in turns
        batch, img = 256, 224
        rng = np.random.default_rng(0)
        xb = torch.from_numpy(rng.standard_normal((batch, img, img, 3))).to(
            "cuda").to(bf)
        yb = torch.as_tensor(rng.integers(0, 1000, (batch,)), device="cuda")
        arms = {}
        for arm in ("cache", "no_cache"):
            model = resnet50(data_format="NHWC", stem_mode="space_to_depth",
                             device="cuda", seed=0)
            model.train()
            model.to(bf)
            opt = Momentum(learning_rate=0.1, momentum=0.9,
                           multi_precision=True)
            arms[arm] = {"step": make_sharded_train_step(model, opt,
                                                         resnet_loss),
                         "losses": [], "ms": []}
        zero_conv_counts(hc)
        for i in range(warmup + timed):
            for arm in (("cache", "no_cache") if i % 2 == 0 else
                        ("no_cache", "cache")):
                flags.set_flags({"kernel_autotune": int(arm == "cache")})
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss = arms[arm]["step"].step((xb, yb))
                end.record()
                end.synchronize()
                arms[arm]["losses"].append(float(loss))
                if i >= warmup:
                    arms[arm]["ms"].append(start.elapsed_time(end))
        launches = conv_counts(hc)
        la, lb = arms["cache"]["losses"], arms["no_cache"]["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(la, lb)]
        train = {arm: {"losses": a["losses"], "step_ms": a["ms"],
                       "step_p50_ms": percentile(a["ms"], 50)}
                 for arm, a in arms.items()}
        del arms
        out = {"phase": "tune_conv", "dtype": "bf16",
               "cache_file": "temporary (FLAGS_kernel_autotune_cache_path)",
               "sweep_s": sweep_s, "shapes": shapes,
               "changed": [r["key"] for r in shapes
                           if r["winner"] != r["plan"]],
               "resnet50": {"batch": [batch, img, img, 3],
                            "warmup_steps": warmup, "timed_steps": timed,
                            "order": "cache first at even steps, no_cache "
                                     "first at odd ones",
                            **train, "loss_rel_diff": rel,
                            "loss_rel_tol": TUNE_LOSS_REL,
                            "conv_launches": launches},
               "clocks": card_clocks()}
        emit(out)
        check(all(math.isfinite(v) for v in la + lb),
              f"tune_conv: non-finite loss {la} {lb}")
        for arm_losses in (la, lb):
            check(math.log(1000) - 0.5 <= arm_losses[0] <=
                  math.log(1000) + 1.5, f"tune_conv step-0 loss {arm_losses}")
        check(max(rel) <= TUNE_LOSS_REL,
              f"tune_conv: the losses with and without the cache part: "
              f"{la} {lb}")
        check(all(launches[kn] > 0 for kn in CONV_KERNELS),
              f"tune_conv: ResNet-50 launched {launches}")
        return out
    finally:
        flags.set_flags(prev)
        at._cache = None


def surface_ops(P):
    """The Paddle-style calls of phase surface, by name: ``fn(x, a, b, idx,
    w, v)`` on tensors made by ``P.to_tensor`` on this thread's device,
    with the absolute and relative tolerance of the card against the CPU
    (0 for calls that only move or pick elements)."""
    return [
        ("to_tensor", lambda x, a, b, idx, w, v: x, 0, 0),
        ("zeros", lambda x, a, b, idx, w, v: P.zeros([4, 2048, 2048]), 0, 0),
        ("arange", lambda x, a, b, idx, w, v: P.arange(0, 8192, 2), 0, 0),
        ("linspace", lambda x, a, b, idx, w, v: P.linspace(0, 1, 2049),
         1e-6, 0),
        ("full_like", lambda x, a, b, idx, w, v: P.full_like(x, 3.0), 0, 0),
        ("add_multiply", lambda x, a, b, idx, w, v:
         P.add(P.multiply(x, 2.0), x), 1e-6, 1e-6),
        ("exp_log_tanh", lambda x, a, b, idx, w, v:
         P.log(P.exp(P.tanh(x)) + 1), 1e-5, 1e-5),
        ("sum", lambda x, a, b, idx, w, v: P.sum(x, axis=-1), 1e-3, 1e-4),
        ("mean_keepdim", lambda x, a, b, idx, w, v:
         P.mean(x, axis=[1, 2], keepdim=True), 1e-5, 1e-4),
        ("max", lambda x, a, b, idx, w, v: P.max(x, axis=1), 0, 0),
        ("logsumexp", lambda x, a, b, idx, w, v: P.logsumexp(x, axis=-1),
         1e-4, 1e-5),
        ("cumsum", lambda x, a, b, idx, w, v: P.cumsum(x[0], axis=-1),
         1e-3, 1e-4),
        ("reshape_transpose", lambda x, a, b, idx, w, v: P.transpose(
            P.reshape(x, [4, 2048, 32, 64]), [0, 2, 1, 3]), 0, 0),
        ("split_concat", lambda x, a, b, idx, w, v: P.concat(
            P.split(x, [1024, -1], axis=1)[::-1], axis=1), 0, 0),
        ("gather", lambda x, a, b, idx, w, v: P.gather(x[0], idx, axis=0),
         0, 0),
        ("flip_roll", lambda x, a, b, idx, w, v:
         P.roll(P.flip(x, [1]), 5, axis=2), 0, 0),
        ("where", lambda x, a, b, idx, w, v:
         P.where(x > 0, x, P.zeros_like(x)), 0, 0),
        ("matmul", lambda x, a, b, idx, w, v:
         P.matmul(x[0], x[1], transpose_y=True), 1e-3, 1e-4),
        ("norm", lambda x, a, b, idx, w, v: P.norm(x, p=2, axis=-1),
         1e-4, 1e-5),
        ("solve", lambda x, a, b, idx, w, v: P.solve(a, b), 1e-4, 1e-3),
        # float32 eigen- and singular values: each side within its
        # backward error of A's, c·n·eps·||A||₂ (Weyl), so the two within
        # 4 · 512 · 2^-23 · 5 = 1.2e-3 (||A||₂ <= 5 here)
        ("svd_values", lambda x, a, b, idx, w, v: P.svd(a)[1], 1.2e-3, 0),
        ("eigh_values", lambda x, a, b, idx, w, v: P.eigh(a)[0], 1.2e-3,
         0),
        ("cholesky", lambda x, a, b, idx, w, v: P.cholesky(a), 1e-4, 1e-4),
        ("argmax", lambda x, a, b, idx, w, v: P.argmax(x, axis=-1), 0, 0),
        ("topk", lambda x, a, b, idx, w, v: P.topk(x[0], 8, axis=-1), 0, 0),
        ("sort", lambda x, a, b, idx, w, v: P.sort(x[0], axis=-1), 0, 0),
        ("argsort", lambda x, a, b, idx, w, v: P.argsort(x[0], axis=-1),
         0, 0),
        ("std", lambda x, a, b, idx, w, v: P.std(x, axis=-1), 1e-5, 1e-4),
        ("median", lambda x, a, b, idx, w, v: P.median(x[0], axis=-1),
         1e-6, 1e-6),
        ("quantile", lambda x, a, b, idx, w, v:
         P.quantile(x[0], [0.1, 0.9], axis=-1), 1e-6, 1e-5),
        ("grad", lambda x, a, b, idx, w, v: P.grad(
            P.sum(P.tanh(P.matmul(x[0], w))), w), 1e-4, 1e-4),
        ("jacobian", lambda x, a, b, idx, w, v: P.autograd.jacobian(
            lambda t: P.tanh(t) * t, v), 1e-6, 1e-5),
    ]


def phase_surface(torch, np, P, hfa, hfp, tfa, PF, flags):
    """Phase surface: a Paddle-style script through the port's root on the
    card. ``set_device("gpu")``, ``seed`` and ``to_tensor``, then creation,
    math, manipulation, linalg, search and stat calls on ``[4, 2048,
    2048]`` float32 (and a 512 x 512 SPD matrix), ``grad``, ``jacobian``,
    ``no_grad`` and a ``PyLayer``: every output on ``cuda``, each held to
    the same call on the port's CPU path (``set_device("cpu")``) within its
    stated tolerance; random draws on the card are repeatable under
    ``seed`` and have the first two moments of their law. Then
    ``FLAGS_use_pallas_kernels`` at GPT-3 1.3B's attention shape (B=4, S =
    2048, 16 heads of 128, bf16, causal; 32 heads of 64 for K4):
    ``ops.flash_attention``, ``scaled_dot_product_attention`` and
    ``flash_attn_unpadded`` with the flag on launch K1 and K4 and take no
    dense route; with it off they launch no attention kernel, each takes
    its dense route once, and each output matches the kernel route's
    within phase dense_route's 16-bit tolerance (2·1e-2 + 2·1e-2·|ref|).
    Returns the phase's row."""
    from paddle_tpu_torch.core import device as pdev
    rng = np.random.default_rng(31)
    x_np = rng.standard_normal((4, 2048, 2048), dtype=np.float32)
    m_np = rng.standard_normal((512, 512)).astype(np.float32)
    a_np = m_np @ m_np.T / 512 + np.eye(512, dtype=np.float32)
    b_np = rng.standard_normal((512, 8)).astype(np.float32)
    idx_np = rng.integers(0, 2048, (300,))
    w_np = (rng.standard_normal((2048, 256)) / 45).astype(np.float32)
    v_np = rng.standard_normal((256,)).astype(np.float32)

    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, t):
            ctx.save_for_backward(t)
            return t * t * t

        @staticmethod
        def backward(ctx, dy):
            (t,) = ctx.saved_tensor()
            return 3 * t * t * dy

    def run(dev):
        P.set_device(dev)
        x = P.to_tensor(x_np)
        a, b = P.to_tensor(a_np), P.to_tensor(b_np)
        idx = P.to_tensor(idx_np)
        w = P.to_tensor(w_np, stop_gradient=False)
        v = P.to_tensor(v_np)
        out = {}
        for name, fn, _, _ in surface_ops(P):
            r = fn(x, a, b, idx, w, v)
            out[name] = [t.detach() for t in (r if isinstance(r, (list, tuple))
                                              else [r])]
        loss = P.sum(P.tanh(P.matmul(x[0], w)))
        loss.backward()
        out["backward"] = [w.grad.detach()]
        with P.no_grad():
            y = P.matmul(x[0], w)
            inside = P.is_grad_enabled()
        out["no_grad"] = [y]
        no_grad_ok = (not y.requires_grad) and not inside and \
            P.is_grad_enabled()
        t = P.to_tensor(v_np, stop_gradient=False)
        c = Cube.apply(t)
        (gc,) = P.grad(P.sum(c), t)
        out["pylayer"] = [c.detach(), gc]
        out["pylayer_analytic_err"] = float(
            (gc - 3 * t.detach() ** 2).abs().max())
        out["no_grad_ok"] = no_grad_ok
        return out

    t0 = time.perf_counter()
    gpu = run("gpu")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    P.set_device("gpu")
    # the float32 eigen- and singular values beside float64's, each side
    a64 = a_np.astype(np.float64)
    truth = {"eigh_values": np.linalg.eigvalsh(a64),
             "svd_values": np.linalg.svd(a64, compute_uv=False)}
    f64_err = {name: {side: float(np.abs(out[name][0].cpu().double().numpy()
                                         - ref).max())
                      for side, out in (("gpu", gpu), ("cpu", cpu))}
               for name, ref in truth.items()}
    tols = {name: (atol, rtol) for name, _, atol, rtol in surface_ops(P)}
    tols.update({"backward": (1e-4, 1e-4), "no_grad": (1e-3, 1e-4),
                 "pylayer": (1e-5, 1e-6)})
    rows = []
    for name, (atol, rtol) in tols.items():
        on_cuda = all(t.device.type == "cuda" for t in gpu[name])
        errs = []
        ok = on_cuda and len(gpu[name]) == len(cpu[name])
        for g_, c_ in zip(gpu[name], cpu[name]):
            ok = ok and g_.shape == c_.shape and g_.dtype == c_.dtype
            if g_.shape != c_.shape:
                continue
            gf, cf = g_.cpu().double(), c_.double()
            err = (gf - cf).abs()
            errs.append(float(err.max()) if err.numel() else 0.0)
            ok = ok and bool((err <= atol + rtol * cf.abs()).all())
        rows.append({"call": name, "on_cuda": on_cuda,
                     "dtype": str(gpu[name][0].dtype).replace("torch.", ""),
                     "shape": list(gpu[name][0].shape), "atol": atol,
                     "rtol": rtol, "max_abs_err": max(errs) if errs else None,
                     "ok": ok})
    # random draws on the card: repeatable under seed, and their moments
    draws = {}
    for name, fn, law in (
            ("randn", lambda: P.randn([1024, 1024]), (0.0, 1.0)),
            ("rand", lambda: P.rand([1024, 1024]), (0.5, 1 / 12)),
            ("uniform", lambda: P.uniform([1024, 1024], min=-2.0, max=2.0),
             (0.0, 16 / 12)),
            ("randint", lambda: P.randint(0, 10, [1024, 1024]),
             (4.5, 99 / 12))):
        P.seed(7)
        d1 = fn()
        P.seed(7)
        d2 = fn()
        f = d1.double()
        n = f.numel()
        mean, var = float(f.mean()), float(f.var())
        draws[name] = {"repeatable": bool(torch.equal(d1, d2)),
                       "on_cuda": d1.device.type == "cuda",
                       "dtype": str(d1.dtype).replace("torch.", ""),
                       "mean": mean, "var": var, "law": list(law),
                       # five standard errors of the mean and of the var
                       "ok": abs(mean - law[0]) <= 5 * (law[1] / n) ** 0.5
                       and abs(var - law[1]) <= 5 * law[1] * (2 / n) ** 0.5}
    # FLAGS_use_pallas_kernels at GPT-3 1.3B's attention shape
    g = torch.Generator(device="cuda")
    g.manual_seed(33)
    bf = torch.bfloat16
    q, k, v = (torch.randn(4, 2048, 16, 128, generator=g, device="cuda").to(
        bf) for _ in range(3))
    q4, k4, v4 = (torch.randn(4, 2048, 32, 64, generator=g,
                              device="cuda").to(bf) for _ in range(3))
    cu = torch.tensor([0, 1536, 4096, 6656, 8192], dtype=torch.int32,
                      device="cuda")
    routes = {}
    outs = {}
    for on in (1, 0):
        flags.set_flags({"use_pallas_kernels": on})
        zero_counts(hfa, hfp)
        tfa.flash_attention.dense_routes = 0
        tfa.flash_attn_unpadded.dense_routes = 0
        PF.scaled_dot_product_attention.dense_routes = 0
        outs[on] = {
            "flash_attention": tfa.flash_attention(q, k, v, causal=True),
            "scaled_dot_product_attention":
                PF.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
            "flash_attn_unpadded": tfa.flash_attn_unpadded(
                q.reshape(-1, 16, 128), k.reshape(-1, 16, 128),
                v.reshape(-1, 16, 128), cu, cu, 2560, 2560, causal=True)}
        torch.cuda.synchronize()
        counts = k4_counts(hfa, hfp)
        routes[on] = {
            "k1_launches": counts["flash_fwd_tc"],
            "k4_launches": sum(counts[n] for n in K4_KERNELS),
            "attention_launches": sum(counts.values()),
            "dense_routes": {
                "flash_attention": tfa.flash_attention.dense_routes,
                "scaled_dot_product_attention":
                    PF.scaled_dot_product_attention.dense_routes,
                "flash_attn_unpadded": tfa.flash_attn_unpadded.dense_routes}}
    flags.set_flags({"use_pallas_kernels": 1})
    tol = 2 * REL16["bf16"]
    agree = {}
    for name in outs[1]:
        ref = outs[1][name].float()
        err = (outs[0][name].float() - ref).abs()
        agree[name] = {"max_abs_err": float(err.max()),
                       "ok": bool((err <= tol + tol * ref.abs()).all())}
    del outs
    row = {"phase": "surface", "calls": rows, "draws": draws,
           "pylayer_analytic_err": gpu["pylayer_analytic_err"],
           "no_grad_ok": gpu["no_grad_ok"] and cpu["no_grad_ok"],
           "f32_values_vs_f64": f64_err,
           "gpu_s": gpu_s, "cpu_s": cpu_s, "device": P.get_device(),
           "use_pallas_kernels": {"on": routes[1], "off": routes[0],
                                  "off_vs_on": agree, "tol": tol}}
    emit(row)
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"surface: calls disagree with the CPU path: {bad}")
    check(all(d["ok"] and d["repeatable"] and d["on_cuda"]
              for d in draws.values()), f"surface: draws {draws}")
    check(row["no_grad_ok"] and gpu["pylayer_analytic_err"] <= 1e-4,
          f"surface: no_grad or PyLayer: {row}")
    on, off = routes[1], routes[0]
    check(on["k1_launches"] > 0 and on["k4_launches"] > 0 and
          not any(on["dense_routes"].values()),
          f"use_pallas_kernels on: {on}")
    check(off["attention_launches"] == 0 and
          all(n == 1 for n in off["dense_routes"].values()),
          f"use_pallas_kernels off: {off}")
    check(all(a["ok"] for a in agree.values()),
          f"use_pallas_kernels off against on: {agree}")
    return row


# -- the Layer API, the rest of nn/ and the vision zoo (phases layer_api,
# -- nn_surface, vision_zoo, train_mobilenet_v3_bf16) ------------------------

def all_counts(hfa, hfp, hc, fmb):
    """Every hand-written kernel's launch count."""
    return {**k4_counts(hfa, hfp), **conv_counts(hc),
            "fused_matmul_bn_fwd": fmb.fused_matmul_bn_fwd.launches}


def zero_all(hfa, hfp, hc, fmb):
    zero_counts(hfa, hfp)
    zero_conv_counts(hc)
    fmb.fused_matmul_bn_fwd.launches = 0


def t_logits(torch, P, model, src, tgt, bias):
    """The seq2seq model's logits in eval mode, no gradient."""
    with torch.no_grad():
        mask = P.nn.Transformer.generate_square_subsequent_mask(
            tgt.shape[1], device=src.device)
        out = model.transformer(model.embed(src), model.embed(tgt),
                                src_mask=bias, tgt_mask=mask,
                                memory_mask=bias)
        return model.logits(out)


def phase_layer_api(torch, np, P, hfa, hfp, hc, fmb, AdamW, dev="cuda",
                    batch=64):
    """Transformer-base at full width (``seq2seq``: d_model 512, 8 heads,
    6 + 6 layers, dropout 0.1, vocab 37,000) through the ``Layer`` API:
    ``sublayers()`` and ``full_name()``; a forward pre-hook halving the
    encoder's input and a post-hook recording layer 0's output, each
    removed by its helper (the logits bit-equal to the hookless ones
    after); ``state_dict`` -> ``set_state_dict`` into a model drawn from
    another seed (bit-equal logits); ``astype("bfloat16")``; then two
    training steps at B = 64 x 256 a side under AdamW with float32
    masters (``multi_precision``), ``clear_gradients()`` after each. The
    counts are set to 0 before the two steps and read after: K4a-direct
    and K4b-fused 12 + 12 a step, as ``train_transformer_bf16`` launches
    them, the decoder's causal self-attention 6 dense routes a step."""
    sdpa = P.nn.functional.scaled_dot_product_attention
    s = T_LEN
    model = seq2seq(torch, P, dev, 0)
    t = model.transformer
    names = [n for n, _ in t.named_sublayers()]
    # 6 encoder layers of 13 sublayers (self_attn, its 4 projections,
    # linear1/2, norm1/2, dropout1/2/_act, itself), 6 decoder layers of
    # 20, the two stacks, their LayerLists and final norms
    check(len(names) == len(t.encoder.layers) * 13 +
          len(t.decoder.layers) * 20 + 6 and
          len(t.sublayers()) == len(names) and
          all(isinstance(m, P.nn.Layer) for m in t.sublayers()),
          f"Transformer sublayers: {len(names)}")
    check(names[:3] == ["encoder", "encoder.layers", "encoder.layers.0"],
          f"sublayer order {names[:3]}")
    check(t.full_name() == "transformer" and
          t.encoder.layers[0].full_name() == "transformerencoderlayer",
          f"full_name {t.full_name()}")
    model.eval()
    src, tgt, _, bias = t_batch(torch, np, np.random.default_rng(3), 8, s, s,
                                dev)
    base = t_logits(torch, P, model, src, tgt, bias)
    seen = {}
    pre = t.encoder.register_forward_pre_hook(lambda m, a: (a[0] * 0.5,))
    post = t.encoder.layers[0].register_forward_post_hook(
        lambda m, a, out: seen.update(out=out, inp=a[0]))
    hooked = t_logits(torch, P, model, src, tgt, bias)
    pre.remove()
    post.remove()
    with torch.no_grad():
        half = model.embed(src) * 0.5
        layer0 = t.encoder.layers[0](half, src_mask=bias)
    after = t_logits(torch, P, model, src, tgt, bias)
    hooks = {"pre_scaled_input": bool(torch.equal(seen["inp"], half)),
             "post_recorded_layer0": bool(torch.equal(seen["out"], layer0)),
             "hooked_logits_differ": not bool(torch.equal(hooked, base)),
             "removed_bit_equal": bool(torch.equal(after, base))}
    check(all(hooks.values()), f"layer_api hooks: {hooks}")
    fresh = seq2seq(torch, P, dev, 1)
    fresh.eval()
    differ = not bool(torch.equal(t_logits(torch, P, fresh, src, tgt, bias),
                                  base))
    loaded = fresh.set_state_dict(model.state_dict())
    copied = bool(torch.equal(t_logits(torch, P, fresh, src, tgt, bias),
                              base))
    check(differ and loaded == ([], []) and copied,
          f"set_state_dict: differ before {differ}, (missing, unexpected) "
          f"{loaded}, bit-equal after {copied}")
    del fresh, base, hooked, after
    model.astype("bfloat16")
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    check(dtypes == ["torch.bfloat16"], f"astype: parameters {dtypes}")
    model.train()
    opt = AdamW(learning_rate=1e-4, beta2=0.98, epsilon=1e-9,
                parameters=model.parameters(), multi_precision=True)
    rng = np.random.default_rng(0)
    batches = [t_batch(torch, np, rng, batch, s, s, dev) for _ in range(2)]
    torch.cuda.synchronize()
    # the main path: the counts are set to 0 just before it
    zero_all(hfa, hfp, hc, fmb)
    sdpa.dense_routes = 0
    losses, times, cleared = [], [], []
    for bt in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = model(*bt)
        loss.backward()
        opt.step()
        end.record()
        end.synchronize()
        had = all(p.grad is not None for p in model.parameters()
                  if p.requires_grad)
        model.clear_gradients()
        cleared.append(had and all(p.grad is None
                                   for p in model.parameters()))
        losses.append(float(loss.detach()))
        times.append(start.elapsed_time(end))
    launches, dense = all_counts(hfa, hfp, hc, fmb), sdpa.dense_routes
    row = {"phase": "layer_api", "model": "transformer_base",
           "sublayers": len(names), "hooks": hooks,
           "set_state_dict": list(map(list, loaded)),
           "param_dtypes": dtypes, "batch": [batch, s, s],
           "optimizer": "AdamW(1e-4, beta2=0.98, epsilon=1e-9, "
                        "multi_precision=True), imperative",
           "losses": losses, "step_ms": times, "grads_cleared": cleared,
           "launches": {k: v for k, v in launches.items() if v},
           "dense_routes": dense}
    emit(row)
    check(all(cleared), f"clear_gradients left gradients: {row}")
    check(all(math.isfinite(x) for x in losses), f"layer_api loss: {row}")
    check(abs(losses[0] - math.log(T_VOCAB)) < 1.0,
          f"layer_api step-0 loss {losses[0]}")
    check_launches(launches, {"flash_packed_fwd_tc": 24,
                              "flash_packed_bwd_tc": 24}, "layer_api")
    check(dense == 12, f"layer_api dense routes {dense}; expected 6 a step")
    del model, opt, batches
    torch.cuda.empty_cache()
    return launches


# -- nn_surface: every new name of nn/ on the card against the CPU ---------

def rs(np, shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def surface_functional(np):
    """``(name, fn(F, *tensors), arrays, tol)``: every new name of
    ``nn.functional`` and ``nn.functional_wave4`` at the widths of the
    models that use it (activations on MobileNetV3-Large's 672 x 14²
    maps, losses over 1000 classes, ...)."""
    act = rs(np, (32, 672, 14, 14), 1, 3.0)
    logits = rs(np, (256, 1000), 2, 2.0)
    probs = 1 / (1 + np.exp(-rs(np, (256, 1000), 3)))
    lab = np.random.default_rng(4).integers(0, 1000, 256).astype(np.int64)
    sgn = np.where(rs(np, (256, 1000), 5) > 0, 1.0, -1.0).astype(np.float32)
    emb = rs(np, (256, 512), 6)
    img = rs(np, (8, 256, 28, 28), 7, 2.0)
    vol = rs(np, (4, 64, 16, 28, 28), 8)
    seq = rs(np, (16, 256, 1024), 9)
    cases = []
    for name in ("relu6", "gelu", "silu", "swish", "sigmoid", "tanh",
                 "softmax", "log_softmax", "leaky_relu", "elu", "selu",
                 "hardswish", "hardsigmoid", "mish", "softplus", "glu",
                 "celu", "hardshrink", "hardtanh", "softshrink", "softsign",
                 "tanhshrink", "thresholded_relu", "log_sigmoid", "elu_",
                 "hardtanh_", "leaky_relu_", "relu_", "softmax_", "tanh_",
                 "thresholded_relu_"):
        cases.append((name, lambda F, x, n=name: getattr(F, n)(x), [act],
                      1e-4))
    cases += [
        ("gelu_tanh", lambda F, x: F.gelu(x, approximate=True), [act], 1e-5),
        ("maxout", lambda F, x: F.maxout(x, 4), [act], 0),
        ("prelu", lambda F, x, w: F.prelu(x, w),
         [act, rs(np, (672,), 10)], 1e-6),
        ("rrelu_eval", lambda F, x: F.rrelu(x, training=False), [act], 1e-6),
        ("one_hot", lambda F, y: F.one_hot(y, 1000), [lab], 0),
        ("label_smooth", lambda F, p: F.label_smooth(p), [probs], 1e-6),
        ("softmax_with_cross_entropy",
         lambda F, x, y: F.softmax_with_cross_entropy(x, y[:, None],
                                                      return_softmax=True),
         [logits, lab], 1e-5),
        ("nll_loss", lambda F, x, y: F.nll_loss(F.log_softmax(x), y),
         [logits, lab], 1e-5),
        ("binary_cross_entropy_with_logits",
         lambda F, x, p: F.binary_cross_entropy_with_logits(x, p),
         [logits, probs], 1e-5),
        ("binary_cross_entropy", F_pair("binary_cross_entropy"),
         [probs, probs[::-1].copy()], 1e-5),
        ("mse_loss", F_pair("mse_loss"), [logits, probs], 1e-5),
        ("l1_loss", F_pair("l1_loss"), [logits, probs], 1e-5),
        ("smooth_l1_loss", lambda F, a, b: F.smooth_l1_loss(a, b, delta=0.5),
         [logits, probs], 1e-5),
        ("kl_div", lambda F, a, b: F.kl_div(F.log_softmax(a), b,
                                            "batchmean"),
         [logits, probs], 1e-5),
        ("log_loss", F_pair("log_loss"), [probs, probs[::-1].copy()], 1e-5),
        ("margin_ranking_loss",
         lambda F, a, b, y: F.margin_ranking_loss(a, b, y, 0.1),
         [logits, probs, sgn], 1e-5),
        ("soft_margin_loss", F_pair("soft_margin_loss"), [logits, sgn],
         1e-5),
        ("triplet_margin_loss", lambda F, a, b, c: F.triplet_margin_loss(
            a, b, c, swap=True), [emb, emb[::-1].copy(), emb * 0.5], 1e-5),
        ("cosine_embedding_loss", lambda F, a, b, y: F.cosine_embedding_loss(
            a, b, y[:, 0]), [emb, emb[::-1].copy(), sgn], 1e-5),
        ("hinge_embedding_loss", F_pair("hinge_embedding_loss"),
         [logits, sgn], 1e-5),
        ("poisson_nll_loss", lambda F, a, b: F.poisson_nll_loss(
            a * 0.1, b, full=True), [logits, probs * 4], 1e-5),
        ("multi_label_soft_margin_loss", lambda F, a, b:
         F.multi_label_soft_margin_loss(a, (b > 0.5).float()),
         [logits, probs], 1e-5),
        ("square_error_cost", F_pair("square_error_cost"), [logits, probs],
         1e-5),
        ("dice_loss", lambda F, p, y: F.dice_loss(F.softmax(p), y[:, None]),
         [logits, lab], 1e-5),
        ("npair_loss", lambda F, a, b, y: F.npair_loss(a, b, y % 64),
         [emb, emb[::-1].copy(), lab], 1e-5),
        ("margin_cross_entropy", lambda F, x, y: F.margin_cross_entropy(
            F.tanh(x), y, return_softmax=True), [logits, lab], 1e-4),
        ("class_center_sample", lambda F, y: F.class_center_sample(
            y, 1000, 400, seed=5), [lab], 0),
        ("rms_norm", lambda F, x, w: F.rms_norm(x, w), [emb, emb[0]], 1e-5),
        ("group_norm", lambda F, x, w, b: F.group_norm(x, 32, w, b),
         [img, rs(np, (256,), 11), rs(np, (256,), 12)], 1e-4),
        ("instance_norm", lambda F, x: F.instance_norm(x), [img], 1e-4),
        ("local_response_norm", lambda F, x: F.local_response_norm(x, 5),
         [img], 1e-5),
        ("normalize", lambda F, x: F.normalize(x, axis=1), [img], 1e-5),
        ("cosine_similarity", lambda F, a, b: F.cosine_similarity(a, b),
         [img, img[::-1].copy()], 1e-5),
        ("conv1d", lambda F, x, w, b: F.conv1d(x, w, b, stride=2,
                                               padding=1),
         [seq, rs(np, (256, 256, 3), 13, 0.05), rs(np, (256,), 14)], 1e-4),
        ("conv1d_transpose", lambda F, x, w: F.conv1d_transpose(
            x, w, stride=2, padding=1), [seq, rs(np, (256, 128, 4), 15,
                                                 0.05)], 1e-4),
        ("conv3d", lambda F, x, w: F.conv3d(x, w, padding=1),
         [vol, rs(np, (64, 64, 3, 3, 3), 16, 0.05)], 1e-4),
        ("conv3d_transpose", lambda F, x, w: F.conv3d_transpose(
            x, w, stride=2, padding=1, output_padding=1),
         [vol[:1], rs(np, (64, 32, 3, 3, 3), 17, 0.05)], 1e-4),
        ("conv2d_transpose", lambda F, x, w: F.conv2d_transpose(
            x, w, stride=2, padding=1, output_padding=1, groups=4),
         [img, rs(np, (256, 32, 3, 3), 18, 0.05)], 1e-4),
        ("max_pool1d", lambda F, x: F.max_pool1d(x, 3, 2, 1), [seq], 0),
        ("avg_pool1d", lambda F, x: F.avg_pool1d(x, 3, 2, 1), [seq], 1e-5),
        ("adaptive_avg_pool1d", lambda F, x: F.adaptive_avg_pool1d(x, 100),
         [seq], 1e-5),
        ("max_pool3d", lambda F, x: F.max_pool3d(x, 3, 2, 1), [vol], 0),
        ("avg_pool3d", lambda F, x: F.avg_pool3d(x, 3, 2, 1), [vol], 1e-5),
        ("max_unpool2d", lambda F, x: F.max_unpool2d(
            *F.max_pool2d(x, 2, 2, return_mask=True), 2, 2), [img], 0),
        ("grid_sample", lambda F, x, g: F.grid_sample(x, F.tanh(g)),
         [img, rs(np, (8, 28, 28, 2), 19)], 1e-4),
        ("grid_sample_nearest_reflect", lambda F, x, g: F.grid_sample(
            x, g, mode="nearest", padding_mode="reflection",
            align_corners=False), [img, rs(np, (8, 28, 28, 2), 20) * 0.9],
         1e-5),
        ("affine_grid", lambda F, t: F.affine_grid(t, [8, 3, 224, 224]),
         [rs(np, (8, 2, 3), 21)], 1e-5),
        ("pixel_shuffle", lambda F, x: F.pixel_shuffle(x, 2), [img], 0),
        ("pixel_unshuffle", lambda F, x: F.pixel_unshuffle(x, 2), [img], 0),
        ("channel_shuffle", lambda F, x: F.channel_shuffle(x, 4), [img], 0),
        ("unfold", lambda F, x: F.unfold(x[:, :16], 3, 1, 1), [img], 0),
        ("fold", lambda F, x: F.fold(F.unfold(x[:, :16], 3, 1, 1), 28, 3,
                                     1, 1), [img], 1e-5),
        ("sequence_mask", lambda F, y: F.sequence_mask(y % 97, 100), [lab],
         0),
        ("temporal_shift", lambda F, x: F.temporal_shift(x, 4), [img], 0),
        ("pairwise_distance", lambda F, a, b: F.pairwise_distance(a, b),
         [emb, emb[::-1].copy()], 1e-5),
        ("diag_embed", lambda F, x: F.diag_embed(x[:, :64], 1), [emb], 0),
        ("zeropad2d", lambda F, x: F.zeropad2d(x, [1, 2, 3, 4]), [img], 0),
        ("bilinear", lambda F, a, b, w: F.bilinear(a, b, w),
         [emb, emb[::-1].copy(), rs(np, (16, 512, 512), 22, 0.05)], 1e-4),
        ("max_unpool1d", lambda F, x: F.max_unpool1d(*(
            t[:, :, 0] for t in F.max_pool2d(x[:, :, None], (1, 2), (1, 2),
                                             return_mask=True)), 2),
         [seq], 0),
        ("max_unpool3d", lambda F, x: F.max_unpool3d(
            x, (x.flatten(2).argsort(-1)[..., :x[0, 0].numel()]
                .reshape(x.shape)), 2), [vol[:, :, :4, :4, :4]], 0),
        ("adaptive_avg_pool3d", lambda F, x: F.adaptive_avg_pool3d(
            x, (4, 7, 7)), [vol], 1e-5),
        ("adaptive_max_pool1d", lambda F, x: F.adaptive_max_pool1d(
            x, 100, return_mask=True), [seq[:2]], 0),
        ("adaptive_max_pool2d", lambda F, x: F.adaptive_max_pool2d(
            x, 7, return_mask=True), [img], 0),
        ("adaptive_max_pool3d", lambda F, x: F.adaptive_max_pool3d(
            x, 2, return_mask=True), [vol], 0),
        ("hsigmoid_loss", lambda F, x, y, w: F.hsigmoid_loss(x, y, 1000, w),
         [emb, lab, rs(np, (999, 512), 23, 0.05)], 1e-5),
        ("sigmoid_focal_loss", F_pair("sigmoid_focal_loss"),
         [logits, (probs > 0.5).astype(np.float32)], 1e-5),
        ("rnnt_loss", lambda F, a, y: F.rnnt_loss(
            a, y % 28 + 1, torch_int([16, 14]), torch_int([8, 6])),
         [rs(np, (2, 16, 9, 29), 24), lab[:16].reshape(2, 8)], 1e-4),
        ("gather_tree", lambda F, i, p: F.gather_tree(i, p % 4),
         [lab[:240].reshape(20, 3, 4), lab[16:256].reshape(20, 3, 4)], 0),
        ("sparse_attention", sparse_case,
         [rs(np, (2, 8, 256, 64), 25) for _ in range(3)], 1e-5),
        ("triplet_margin_with_distance_loss", lambda F, a, b, c:
         F.triplet_margin_with_distance_loss(a, b, c),
         [emb, emb[::-1].copy(), emb * 0.5], 1e-5),
        ("multi_margin_loss", lambda F, x, y: F.multi_margin_loss(x, y),
         [logits, lab], 1e-5),
        ("gaussian_nll_loss", lambda F, a, b, v: F.gaussian_nll_loss(
            a, b, v.abs(), full=True), [logits, probs, probs], 1e-5),
    ]
    return cases


def F_pair(name):
    return lambda F, a, b: getattr(F, name)(a, b)


def torch_int(values):
    import torch
    return torch.tensor(values)


def sparse_case(F, q, k, v):
    """``sparse_attention`` over a banded pattern of 32 keys a row."""
    import torch
    b, h, s, _ = q.shape
    cols = (torch.arange(s)[:, None] + torch.arange(-16, 16)) % s
    off = torch.arange(0, s * 32 + 1, 32)
    return F.sparse_attention(
        q, k, v, off.expand(b, h, s + 1).to(q.device),
        cols.reshape(-1).expand(b, h, s * 32).to(q.device))


def surface_outputs(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in surface_outputs(o)]
    return [out]


def surface_compare(torch, name, fn, arrays, tol, dev, worst):
    """``fn`` on the card and on the CPU from the same arrays; each output's
    largest difference over ``1 + max|cpu|`` held to ``tol``."""
    def run(d):
        ts = [torch.as_tensor(a, device=d) for a in arrays]
        return surface_outputs(fn(ts))
    got, ref = run(dev), run("cpu")
    check(len(got) == len(ref), f"nn_surface {name}: outputs differ")
    err = 0.0
    for g, r in zip(got, ref):
        check(g.device.type == torch.device(dev).type,
              f"nn_surface {name}: output on {g.device}")
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"nn_surface {name}: {g.shape}/{g.dtype} vs {r.shape}/"
              f"{r.dtype}")
        g, r = g.detach().cpu().double(), r.detach().double()
        scale = 1.0 + float(r.abs().max()) if r.numel() else 1.0
        err = max(err, float((g - r).abs().max()) / scale
                  if r.numel() else 0.0)
    worst[name] = err
    check(err <= tol, f"nn_surface {name}: error {err} > {tol}")


def surface_layers(np):
    """``(class, args, kwargs, input arrays, tol)`` for every new layer
    class of ``nn/layers.py``."""
    img = rs(np, (8, 64, 28, 28), 30, 2.0)
    vec = rs(np, (256, 512), 31)
    lab = np.random.default_rng(32).integers(0, 1000, 256).astype(np.int64)
    seq = rs(np, (16, 64, 256), 33)
    vol = rs(np, (2, 64, 8, 14, 14), 34)
    acts = [("ReLU6", ()), ("GELU", ()), ("Silu", ()), ("Sigmoid", ()),
            ("Tanh", ()), ("Softmax", ()), ("LeakyReLU", (0.2,)),
            ("Hardswish", ()), ("Hardsigmoid", ()), ("ELU", ()),
            ("SELU", ()), ("CELU", ()), ("Hardshrink", ()),
            ("Hardtanh", ()), ("Softshrink", ()), ("Softsign", ()),
            ("Tanhshrink", ()), ("ThresholdedReLU", ()), ("LogSigmoid", ()),
            ("Maxout", (2,)), ("Mish", ()), ("Softplus", ()), ("GLU", ()),
            ("LogSoftmax", ()), ("Swish", ()), ("Softmax2D", ()),
            ("PReLU", (64,)), ("RReLU", ())]
    cases = [(n, a, {}, [img], 1e-5) for n, a in acts]
    cases += [
        ("RMSNorm", (28,), {}, [img], 1e-5),
        ("GroupNorm", (8, 64), {}, [img], 1e-4),
        ("InstanceNorm1D", (64,), {}, [seq], 1e-4),
        ("InstanceNorm2D", (64,), {}, [img], 1e-4),
        ("InstanceNorm3D", (64,), {}, [vol], 1e-4),
        ("LocalResponseNorm", (5,), {}, [img], 1e-5),
        ("SyncBatchNorm", (64,), {}, [img], 1e-4),
        ("SpectralNorm", ((64, 64, 3, 3),), {}, [rs(np, (64, 64, 3, 3), 35)],
         1e-4),
        ("Conv1D", (64, 128, 3), {"padding": 1}, [seq], 1e-4),
        ("Conv3D", (64, 32, 3), {"padding": 1}, [vol], 1e-4),
        ("Conv1DTranspose", (64, 32, 4), {"stride": 2}, [seq], 1e-4),
        ("Conv2DTranspose", (64, 32, 4), {"stride": 2, "padding": 1},
         [img], 1e-4),
        ("Conv3DTranspose", (64, 16, 2), {"stride": 2}, [vol], 1e-4),
        ("MaxPool1D", (3, 2, 1), {}, [seq], 0),
        ("AvgPool1D", (3, 2, 1), {}, [seq], 1e-5),
        ("MaxPool3D", (2,), {}, [vol], 0),
        ("AvgPool3D", (3, 2, 1), {}, [vol], 1e-5),
        ("AdaptiveAvgPool1D", (10,), {}, [seq], 1e-5),
        ("AdaptiveAvgPool3D", ((2, 7, 7),), {}, [vol], 1e-5),
        ("AdaptiveMaxPool1D", (10,), {}, [seq], 0),
        ("AdaptiveMaxPool2D", (7,), {}, [img], 0),
        ("AdaptiveMaxPool3D", (2,), {}, [vol], 0),
        ("Upsample", (), {"scale_factor": 2, "mode": "bilinear"}, [img],
         1e-5),
        ("UpsamplingNearest2D", (), {"size": (56, 56)}, [img], 0),
        ("UpsamplingBilinear2D", (), {"size": (14, 14)}, [img], 1e-5),
        ("Pad1D", ([2, 1],), {"mode": "reflect"}, [seq], 0),
        ("Pad3D", (1,), {"mode": "replicate"}, [vol], 0),
        ("ZeroPad2D", ([1, 0, 2, 1],), {}, [img], 0),
        ("Unfold", (3,), {"paddings": 1}, [img[:, :8]], 0),
        ("Fold", ((28, 28), 2, 2), {}, [rs(np, (8, 256, 196), 36)], 0),
        ("PixelShuffle", (2,), {}, [img], 0),
        ("PixelUnshuffle", (2,), {}, [img], 0),
        ("ChannelShuffle", (4,), {}, [img], 0),
        ("Unflatten", (1, [8, 8]), {}, [img], 0),
        ("Bilinear", (512, 512, 16), {}, [vec, vec[::-1].copy()], 1e-4),
        ("CosineSimilarity", (), {}, [img, img[::-1].copy()], 1e-5),
        ("PairwiseDistance", (), {}, [vec, vec[::-1].copy()], 1e-5),
        ("Dropout2D", (0.5,), {}, [img], 0),
        ("Dropout3D", (0.5,), {}, [vol], 0),
        ("AlphaDropout", (0.5,), {}, [img], 0),
        ("MSELoss", (), {}, [vec, vec * 0.5], 1e-5),
        ("L1Loss", (), {}, [vec, vec * 0.5], 1e-5),
        ("NLLLoss", (), {}, [vec, lab % 512], 1e-5),
        ("BCEWithLogitsLoss", (), {}, [vec, (vec > 0).astype(np.float32)],
         1e-5),
        ("SmoothL1Loss", (), {}, [vec, vec * 0.5], 1e-5),
        ("KLDivLoss", (), {}, [vec, np.abs(vec)], 1e-5),
        ("BCELoss", (), {}, [1 / (1 + np.exp(-vec)),
                             (vec > 0).astype(np.float32)], 1e-5),
        ("MarginRankingLoss", (), {}, [vec, vec[::-1].copy(),
                                       np.sign(vec)], 1e-5),
        ("SoftMarginLoss", (), {}, [vec, np.sign(vec)], 1e-5),
        ("TripletMarginLoss", (), {}, [vec, vec[::-1].copy(), vec * 0.5],
         1e-5),
        ("CosineEmbeddingLoss", (), {}, [vec, vec[::-1].copy(),
                                         np.sign(vec[:, 0])], 1e-5),
        ("HingeEmbeddingLoss", (), {}, [vec, np.sign(vec)], 1e-5),
        ("PoissonNLLLoss", (), {}, [vec * 0.1, np.abs(vec)], 1e-5),
        ("MultiLabelSoftMarginLoss", (), {}, [vec, (vec > 0).astype(
            np.float32)], 1e-5),
        ("CTCLoss", (), {}, [rs(np, (64, 8, 29), 37),
                             lab[:80].reshape(8, 10) % 28 + 1,
                             np.full(8, 64), np.full(8, 10)], 1e-5),
        ("MultiMarginLoss", (), {}, [vec, lab % 512], 1e-5),
        ("TripletMarginWithDistanceLoss", (), {}, [vec, vec[::-1].copy(),
                                                   vec * 0.5], 1e-5),
        ("GaussianNLLLoss", (), {}, [vec, vec * 0.5, np.abs(vec) + 0.1],
         1e-5),
        ("HSigmoidLoss", (512, 1000), {}, [vec, lab], 1e-5),
        ("RNNTLoss", (), {}, [rs(np, (2, 12, 6, 29), 38),
                              lab[:10].reshape(2, 5) % 28 + 1], 1e-4),
        ("MaxUnPool2D", (2,), {}, None, 0),
        ("MaxUnPool1D", (2,), {}, None, 0),
        ("MaxUnPool3D", (2,), {}, None, 0),
        ("ParameterList", (), {}, None, 0),
        ("LayerDict", (), {}, None, 0),
        ("RNNCellBase", (), {}, None, 0),
    ]
    return cases


def surface_layer(torch, P, name, args, kw, arrays, dev):
    """The layer built on the card from seed 0 and its CPU twin holding
    the same state, each called in eval mode on the same arrays."""
    from paddle_tpu_torch.core.device import device_guard
    cls = getattr(P.nn, name)
    P.seed(0)
    with device_guard(dev):
        card = cls(*args, **kw)
    with device_guard("cpu"):
        cpu = cls(*args, **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    for m in (card, cpu):
        m.eval()
    return lambda ts: (card if ts[0].is_cuda else cpu)(*ts)


def surface_special_layers(torch, np, P, dev, worst):
    """The unpool layers after their pools' masks, the containers, the
    cells' base, and the stacked recurrences at published sizes: LSTM and
    GRU with 2 layers of hidden 1024, bidirectional, 128 steps, batch 64,
    f32, forward and the gradients of the input."""
    x = rs(np, (8, 64, 28, 28), 40)

    def unpool2d(ts):
        v, i = P.nn.functional.max_pool2d(ts[0], 2, 2, return_mask=True)
        return P.nn.MaxUnPool2D(2)(v, i)

    def unpool1d(ts):
        v, i = P.nn.functional.max_pool2d(ts[0][:, :, :1], (1, 2), (1, 2),
                                          return_mask=True)
        return P.nn.MaxUnPool1D(2)(v[:, :, 0], i[:, :, 0])

    def unpool3d(ts):
        v = ts[0][:, :, :4, :4, :4]
        i = v.flatten(2).argsort(-1)[..., :64].reshape(v.shape)
        return P.nn.MaxUnPool3D(2)(v, i)

    surface_compare(torch, "MaxUnPool2D", unpool2d, [x], 0, dev, worst)
    surface_compare(torch, "MaxUnPool1D", unpool1d, [x], 0, dev, worst)
    surface_compare(torch, "MaxUnPool3D", unpool3d,
                    [rs(np, (2, 16, 8, 8, 8), 41)], 0, dev, worst)
    pl = P.nn.ParameterList([P.nn.Parameter(torch.ones(3, device=dev))])
    pl.append(P.nn.Parameter(torch.zeros(2, device=dev)))
    ld = P.nn.LayerDict({"a": P.nn.Linear(4, 4, device=dev)})
    check(len(pl) == 2 and list(pl.state_dict()) == ["0", "1"] and
          list(ld.keys()) == ["a"] and ld["a"].weight.is_cuda and
          issubclass(P.nn.LSTMCell, P.nn.RNNCellBase),
          "ParameterList/LayerDict/RNNCellBase")
    for name in ("ParameterList", "LayerDict", "RNNCellBase"):
        worst[name] = 0.0
    rnn_rows = {}
    for name in ("LSTM", "GRU"):
        from paddle_tpu_torch.core.device import device_guard
        P.seed(0)
        with device_guard(dev):
            card = getattr(P.nn, name)(1024, 1024, num_layers=2,
                                       direction="bidirect")
        with device_guard("cpu"):
            cpu = getattr(P.nn, name)(1024, 1024, num_layers=2,
                                      direction="bidirect")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        xs = rs(np, (64, 128, 1024), 42)
        outs = {}
        for tag, m, d in (("card", card, dev), ("cpu", cpu, "cpu")):
            t = torch.as_tensor(xs, device=d).requires_grad_()
            t0 = time.perf_counter()
            out, fin = m(t)
            (out.float() * 0.01).sum().backward()
            if d != "cpu":
                torch.cuda.synchronize()
            outs[tag] = (out.detach().cpu(), fin, t.grad.cpu(),
                         time.perf_counter() - t0)
        err_out = float((outs["card"][0] - outs["cpu"][0]).abs().max())
        err_dx = float((outs["card"][2] - outs["cpu"][2]).abs().max() /
                       outs["cpu"][2].abs().max())
        fins = (outs["card"][1], outs["cpu"][1])
        if name == "LSTM":
            err_fin = max(float((a.detach().cpu() - b.detach()).abs().max())
                          for a, b in zip(*fins))
        else:
            err_fin = float((fins[0].detach().cpu() -
                             fins[1].detach()).abs().max())
        rnn_rows[name] = {"out_max_abs_err": err_out,
                          "final_max_abs_err": err_fin,
                          "dx_max_rel_err": err_dx,
                          "card_s": outs["card"][3],
                          "cpu_s": outs["cpu"][3]}
        worst[name] = max(err_out, err_fin, err_dx)
        check(err_out <= 2e-4 and err_fin <= 2e-4 and err_dx <= 1e-3,
              f"nn_surface {name}: {rnn_rows[name]}")
        del card, cpu
    return rnn_rows


def phase_nn_surface(torch, np, P, hfa, hfp, hc, fmb, dev="cuda"):
    """Every name ported in this slice, on the card against the CPU path
    from the same arrays and (for a layer) the same state: the new
    functional names and in-place aliases, every new layer class, the
    cells, ``RNN``, ``BiRNN``, ``SimpleRNN``, LSTM and GRU at 2 x 1024
    bidirectional over 128 steps of batch 64, ``nn.utils``,
    ``interpolate`` in each mode up and down on a 224² image and
    ``ctc_loss`` at T = 256, B = 32, 29 classes; each held to its stated
    tolerance as the largest difference over 1 + max|cpu|. The random
    draws are held on the card to their range, rate and determinism under
    the seed. No hand-written kernel is on these paths: every count stays
    0."""
    import paddle_tpu_torch.nn.functional as F
    worst = {}
    t0 = time.perf_counter()
    zero_all(hfa, hfp, hc, fmb)
    for name, fn, arrays, tol in surface_functional(np):
        surface_compare(torch, name, lambda ts, fn=fn: fn(F, *ts), arrays,
                        tol, dev, worst)
    img = rs(np, (2, 3, 224, 224), 50)
    for mode in ("nearest", "bilinear", "bicubic"):
        for size in ((448, 448), (112, 112), (300, 150)):
            surface_compare(torch, f"interpolate_{mode}_{size[0]}x{size[1]}",
                            lambda ts, m=mode, s=size: F.interpolate(
                                ts[0], size=s, mode=m), [img], 1e-5, dev,
                            worst)
        surface_compare(torch, f"upsample_{mode}", lambda ts, m=mode:
                        F.upsample(ts[0], scale_factor=0.5, mode=m,
                                   align_corners=True), [img], 1e-5, dev,
                        worst)
    logits = rs(np, (256, 32, 29), 51, 2.0)
    rng = np.random.default_rng(52)
    labels = rng.integers(1, 29, (32, 64))
    lens = [rng.integers(200, 257, 32), rng.integers(20, 65, 32)]
    for red in ("mean", "none"):
        surface_compare(torch, f"ctc_loss_{red}", lambda ts, r=red:
                        F.ctc_loss(*ts, reduction=r),
                        [logits, labels, *lens], 1e-5, dev, worst)

    def ctc_grad(ts):
        x = ts[0].requires_grad_()
        F.ctc_loss(x, *ts[1:]).backward()
        return x.grad
    surface_compare(torch, "ctc_loss_grad", ctc_grad,
                    [logits, labels, *lens], 1e-5, dev, worst)
    for name, args, kw, arrays, tol in surface_layers(np):
        if arrays is None:
            continue
        surface_compare(torch, name, surface_layer(torch, P, name, args, kw,
                                                   arrays, dev),
                        arrays, tol, dev, worst)
    rnn_rows = surface_special_layers(torch, np, P, dev, worst)
    surface_rnn_cells_utils(torch, np, P, dev, worst)
    draws = surface_draws(torch, P, dev)
    launches = all_counts(hfa, hfp, hc, fmb)
    row = {"phase": "nn_surface", "names": len(worst),
           "worst": sorted(worst.items(), key=lambda kv: -kv[1])[:8],
           "rnn": rnn_rows, "draws": draws,
           "launches": {k: v for k, v in launches.items() if v},
           "seconds": time.perf_counter() - t0}
    emit(row)
    check(not any(launches.values()),
          f"nn_surface launched hand-written kernels: {launches}")
    return worst


def surface_rnn_cells_utils(torch, np, P, dev, worst):
    """The three cells one step, ``RNN`` and ``BiRNN`` over 32 steps,
    ``SimpleRNN``, and ``nn.utils``: weight and spectral norm on a Linear,
    the vector round trip, the two clips."""
    from paddle_tpu_torch.core.device import device_guard
    import paddle_tpu_torch.nn.utils as U
    x = rs(np, (64, 32, 256), 60)

    def build(make):
        P.seed(0)
        with device_guard(dev):
            card = make()
        with device_guard("cpu"):
            cpu = make()
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        card.eval()
        cpu.eval()
        return lambda ts: (card if ts[0].is_cuda else cpu)(*ts)

    for name in ("SimpleRNNCell", "LSTMCell", "GRUCell"):
        cell = getattr(P.nn, name)
        surface_compare(torch, name, build(lambda c=cell: c(256, 512)),
                        [x[:, 0]], 1e-5, dev, worst)
        surface_compare(torch, "RNN_" + name, build(
            lambda c=cell: P.nn.RNN(c(256, 512), is_reverse=True)), [x],
            1e-4, dev, worst)
        surface_compare(torch, "BiRNN_" + name, build(
            lambda c=cell: P.nn.BiRNN(c(256, 128), c(256, 128))), [x],
            1e-4, dev, worst)
    surface_compare(torch, "SimpleRNN", build(lambda: P.nn.SimpleRNN(
        256, 512, num_layers=2, direction="bidirect")), [x], 1e-4, dev,
        worst)

    def normed(kind):
        def make():
            lin = P.nn.Linear(512, 256)
            return U.weight_norm(lin) if kind == "weight" else \
                U.spectral_norm(lin, n_power_iterations=2)
        return make
    for kind in ("weight", "spectral"):
        surface_compare(torch, f"{kind}_norm", build(normed(kind)),
                        [rs(np, (256, 512), 63)], 1e-5, dev, worst)
    gs = [rs(np, (512, 256), 61), rs(np, (256,), 62)]
    surface_compare(torch, "parameters_to_vector", lambda ts:
                    U.vector_to_parameters(U.parameters_to_vector(ts) * 2,
                                           ts), gs, 0, dev, worst)
    surface_compare(torch, "clip_grad_norm_", lambda ts:
                    U.clip_grad_norm_(ts, 1.0), gs, 1e-5, dev, worst)
    surface_compare(torch, "clip_grad_value_", lambda ts:
                    U.clip_grad_value_(ts, 0.5), gs, 0, dev, worst)
    m = P.nn.Linear(512, 8, device=dev)
    w = m.weight.detach().clone()
    U.weight_norm(m, dim=1)
    U.remove_weight_norm(m)
    worst["remove_weight_norm"] = float((m.weight - w).abs().max())
    check(worst["remove_weight_norm"] <= 1e-6,
          f"remove_weight_norm: {worst['remove_weight_norm']}")


def surface_draws(torch, P, dev):
    """The random draws on the card: each the same twice under one seed,
    another under another; ``rrelu``'s slopes in [lower, upper) about
    their mean, ``gumbel_softmax`` rows summing to 1, the channel dropouts
    whole channels at the rate, alpha dropout's mean and spread kept,
    ``class_center_sample`` without a seed keeping the positives."""
    F = P.nn.functional
    x = torch.randn(256, 256, device=dev)
    neg = -x.abs() - 0.1
    maps = torch.rand(64, 256, 7, 7, device=dev) + 1.0
    lab = torch.randint(0, 1000, (256,), device=dev)
    draws = {
        "rrelu": lambda: F.rrelu(neg, 0.1, 0.3, training=True),
        "gumbel_softmax": lambda: F.gumbel_softmax(x, 0.5),
        "dropout2d": lambda: F.dropout2d(maps, 0.3),
        "dropout3d": lambda: F.dropout3d(maps[:, :, None], 0.3),
        "alpha_dropout": lambda: F.alpha_dropout(x, 0.2),
        "class_center_sample": lambda: F.class_center_sample(lab, 1000,
                                                             400)[1],
    }
    out = {}
    for name, draw in draws.items():
        P.seed(1)
        a = draw()
        P.seed(1)
        b = draw()
        P.seed(2)
        c = draw()
        check(torch.equal(a, b) and not torch.equal(a, c) and
              a.device.type == torch.device(dev).type,
              f"nn_surface draw {name}: not keyed by the seed")
        if name == "rrelu":
            s = a / neg
            stat = [float(s.min()), float(s.max()), float(s.mean())]
            ok = stat[0] >= 0.1 - 1e-6 and stat[1] <= 0.3 + 1e-6 and \
                abs(stat[2] - 0.2) < 1e-3
        elif name == "gumbel_softmax":
            stat = float((a.sum(-1) - 1).abs().max())
            ok = stat < 1e-5
        elif name.startswith("dropout"):
            zero = (a == 0).flatten(2)
            stat = float(zero.all(-1).float().mean())
            ok = bool((zero.all(-1) | ~zero.any(-1)).all()) and \
                abs(stat - 0.3) < 0.02
        elif name == "alpha_dropout":
            stat = [float(a.mean()), float(a.std())]
            ok = abs(stat[0]) < 0.02 and abs(stat[1] - 1.0) < 0.02
        else:
            stat = len(a)
            ok = stat == 400 and bool(torch.isin(lab, a).all())
        out[name] = stat
        check(ok, f"nn_surface draw {name}: {stat}")
    return out


# -- vision_zoo: one factory of each new file, card against CPU ------------

ZOO = (("alexnet", 224), ("vgg16", 224), ("mobilenet_v1", 224),
       ("mobilenet_v2", 224), ("mobilenet_v3_small", 224),
       ("squeezenet1_1", 224), ("shufflenet_v2_x1_0", 224),
       ("densenet121", 224), ("googlenet", 224), ("inception_v3", 299))


def calibrate_bn(torch, P, model, x):
    """Running statistics from the batch's (one training pass at momentum
    0, dropout off), the variance plus 1: in eval mode every BatchNorm then
    normalises without the vanishing activations of its initial
    statistics or the unbounded gain of a channel with no spread."""
    from paddle_tpu_torch.nn.layers import _BatchNormBase
    bns = [m for m in model.sublayers() if isinstance(m, _BatchNormBase)]
    for m in bns:
        m.momentum = 0.0
    model.train()
    for m in model.sublayers():
        if isinstance(m, P.nn.Dropout):
            m.eval()
    with torch.no_grad():
        model(x)
    for m in bns:
        m.momentum = 0.9
        m._variance = m._variance + 1.0


def phase_vision_zoo(torch, np, P, hfa, hfp, hc, fmb, dev="cuda", scale=1):
    """One factory of each new model file at its published input (224²,
    Inception v3 299²), batch 2, f32, 1000 classes: built on the card from
    seed 0, its BatchNorm statistics set from the batch
    (``calibrate_bn``), copied to CPU twins in float32 and float64, then
    forward and backward in eval mode on all three (dropout off;
    BatchNorm the running-statistics affine, which rounding does not
    amplify as the batch statistics of a random-init net at batch 2 do).
    The card's logits and loss are held to the CPU's float32 ones; its
    gradients to float64's, as closely as the CPU's own float32 ones are
    (a first conv's gradient sums 10^5 products that nearly cancel at
    init: float32 keeps a percent of it on either device). GoogLeNet's
    loss sums its three heads'. Library convolutions (cuDNN, depthwise and
    grouped ones too): no hand-written kernel launches."""
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.vision import models as M
    zero_all(hfa, hfp, hc, fmb)
    rows = {}
    for name, side in ZOO:
        side //= scale
        P.seed(0)
        card = getattr(M, name)(device=dev)
        cpu = getattr(M, name)(device="cpu")
        rng = np.random.default_rng(7)
        x = rng.standard_normal((2, 3, side, side)).astype(np.float32)
        y = rng.integers(0, 1000, (2,))
        calibrate_bn(torch, P, card, torch.as_tensor(x, device=dev))
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        cpu64 = copy.deepcopy(cpu).to(torch.float64)
        out = {}
        for tag, m, d in (("card", card, dev), ("cpu", cpu, "cpu"),
                          ("cpu64", cpu64, "cpu")):
            m.eval()
            t0 = time.perf_counter()
            logits = m(torch.as_tensor(x, device=d).to(
                next(iter(m.parameters())).dtype))
            heads = logits if isinstance(logits, tuple) else (logits,)
            loss = sum(cross_entropy(h, torch.as_tensor(y, device=d))
                       for h in heads)
            loss.backward()
            if d != "cpu":
                torch.cuda.synchronize()
            out[tag] = (float(loss.detach()), heads[0].detach().cpu(),
                        time.perf_counter() - t0,
                        {k: p.grad.detach().cpu().double()
                         for k, p in m.named_parameters()})
        logit_err = float((out["card"][1] - out["cpu"][1]).abs().max() /
                          (1 + out["cpu"][1].abs().max()))
        grad = {"card": 0.0, "cpu": 0.0}
        worst_name, worst_ratio = None, 0.0
        for pname, ref in out["cpu64"][3].items():
            norm = float(ref.norm()) or 1e-30
            errs = {t: float((out[t][3][pname] - ref).norm()) / norm
                    for t in ("card", "cpu")}
            check(math.isfinite(errs["card"]), f"{name}.{pname} grad")
            ratio = errs["card"] / max(errs["cpu"], 1e-7)
            if errs["card"] > 1e-3 and ratio > worst_ratio:
                worst_name, worst_ratio = pname, ratio
            for t in grad:
                grad[t] = max(grad[t], errs[t])
        rows[name] = {"input": [2, 3, side, side],
                      "params": sum(p.numel() for p in card.parameters()),
                      "loss_card": out["card"][0], "loss_cpu": out["cpu"][0],
                      "logits_rel_err": logit_err,
                      "grad_norm_rel_err_vs_f64": grad,
                      "grad_worst_ratio_over_1e-3": [worst_name,
                                                     worst_ratio],
                      "card_s": out["card"][2], "cpu_s": out["cpu"][2]}
        # a gradient more than 1e-3 (2-norm) from float64 may be at most
        # 10 times as far as the CPU's float32 one
        check(abs(out["card"][0] - out["cpu"][0]) <=
              1e-4 * (1 + abs(out["cpu"][0])) and logit_err <= 1e-4 and
              worst_ratio <= 10.0, f"vision_zoo {name}: {rows[name]}")
        del card, cpu, cpu64
    launches = all_counts(hfa, hfp, hc, fmb)
    emit({"phase": "vision_zoo", "models": rows,
          "launches": {k: v for k, v in launches.items() if v}})
    check(not any(launches.values()),
          f"vision_zoo launched hand-written kernels: {launches}")
    return rows


# -- train_mobilenet_v3_bf16 -------------------------------------------------

#: MobileNetV3-Large's multiply-adds an image at 224², as published (Howard
#: et al., 2019, "Searching for MobileNetV3", Table 3)
MBV3_LARGE_MADDS = 219e6


def conv_linear_flops(torch, P, model, x):
    """The forward's FLOPs (2 a multiply-add) of every Conv2D and Linear,
    from the shapes one forward gives: ``2·out_elements·(in/groups)·kh·kw``
    a convolution, ``2·rows·in·out`` a Linear."""
    total = [0]

    def conv(m, a, out):
        total[0] += 2 * out.numel() * m.weight.shape[1] * \
            m.weight.shape[2] * m.weight.shape[3]

    def linear(m, a, out):
        total[0] += 2 * out.numel() * m.in_features

    handles = [m.register_forward_post_hook(conv if isinstance(
        m, P.nn.Conv2D) else linear) for m in model.sublayers()
        if isinstance(m, (P.nn.Conv2D, P.nn.Linear))]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    return total[0] // x.shape[0]


def phase_train_mobilenet_v3_bf16(torch, np, P, hfa, hfp, hc, fmb, peaks,
                                  Momentum, make_sharded_train_step,
                                  dev="cuda", batch=128, warmup=2, timed=10):
    """MobileNetV3-Large, 1000 classes, 224², batch 128, set up as
    ``train_resnet_bf16``: ``.train().to(bfloat16)`` (the BatchNorm
    buffers come back float32 after a step), ``Momentum(0.1, 0.9)`` with
    float32 masters, ``TrainStep`` on the mean cross-entropy of the f32
    logits, one batch from ``default_rng(0)``; 2 warm-up and 10 timed
    steps between CUDA events. FLOPs from the model's conv and Linear
    shapes (``conv_linear_flops``, x3 for a training step) beside the
    published 219M multiply-adds; MFU over the bf16 dense peak. Depthwise
    and 1x1 convolutions run on cuDNN, as JAX's run on lax.conv: no
    hand-written kernel launches."""
    from paddle_tpu_torch.vision.models import mobilenet_v3_large
    img = 224
    P.seed(0)
    model = mobilenet_v3_large(device=dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, 3, img, img))).to(
        dev).to(torch.float32)
    y = torch.as_tensor(rng.integers(0, 1000, (batch,)), device=dev)
    fwd_flops = conv_linear_flops(torch, P, model, x[:1])
    model.train()
    model.to(torch.bfloat16)
    x = x.to(torch.bfloat16)
    opt = Momentum(learning_rate=0.1, momentum=0.9, multi_precision=True)
    step = make_sharded_train_step(model, opt, resnet_loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before it and read after
    zero_all(hfa, hfp, hc, fmb)
    losses, times = timed_steps(torch, lambda: step.step((x, y)), warmup,
                                timed)
    launches = all_counts(hfa, hfp, hc, fmb)
    clocks = card_clocks()
    images_per_s = timed * batch / (sum(times) / 1e3)
    flops_per_image = 3 * fwd_flops
    buf_dtypes = sorted({str(b.dtype) for b in model.buffers()})
    row = {"phase": "train_mobilenet_v3_bf16", "clocks": clocks,
           "model": "mobilenet_v3_large", "batch": [batch, 3, img, img],
           "dtype": "bf16 (model.to)",
           "optimizer": "Momentum(0.1, momentum=0.9, multi_precision=True)",
           "losses": losses, "warmup_steps": warmup, "timed_steps": timed,
           "step_ms": times, "step_p50_ms": percentile(times, 50),
           "step_p99_ms": percentile(times, 99),
           "images_per_s": images_per_s,
           "fwd_flops_per_image": fwd_flops,
           "published_fwd_flops_per_image": 2 * MBV3_LARGE_MADDS,
           "flops_per_image": flops_per_image,
           "flops_formula": "3 x sum over Conv2D and Linear of "
                            "2*out_elements*(in/groups)*kh*kw",
           "mfu": flops_per_image * images_per_s / peaks["bf16"],
           "peak_sheet": peaks["sheet"],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bn_buffer_dtypes": buf_dtypes,
           "launches": {k: v for k, v in launches.items() if v}}
    emit(row)
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {row}")
    check(abs(losses[0] - math.log(1000)) < 0.5,
          f"MobileNetV3 step-0 loss {losses[0]}, not near ln 1000")
    check(abs(fwd_flops / (2 * MBV3_LARGE_MADDS) - 1) < 0.1,
          f"counted {fwd_flops} FLOPs an image; published "
          f"{2 * MBV3_LARGE_MADDS}")
    check(buf_dtypes == ["torch.float32"],
          f"BN buffers {buf_dtypes} after a step, not float32")
    check(not any(launches.values()),
          f"MobileNetV3 launched hand-written kernels: {launches}")
    del model, opt, step
    torch.cuda.empty_cache()
    return row


# -- the rest of vision/, text/ ops, fft, signal and audio (phases
# -- train_resnet_folder_bf16, vision_ops, audio_text) -----------------------

#: ImageNet's normalisation, as a Paddle classification script sets it
IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]
#: the global numpy seed the folder phase's loader draws its shuffle and
#: its workers' base seed from
FOLDER_SEED = 23
#: the tolerance against the CPU path, of the largest value, of what is
#: sampled bilinearly (the RoI ops and DCNv2, forward and gradients): the
#: card divides by a bin count as a product with its reciprocal, an ulp
#: from the CPU's quotient, and at 300 px a float32 coordinate's ulp is
#: 3e-5 px, which the sample's slope turns into up to 1e-4 of a value
#: (roi_align came 2.79e-5 off in a first run); a gradient's sums also
#: run in no fixed order on the card (atomic adds)
GRAD_TOL = 1e-4
#: roi_pool's gradient in the 2-norm: a bin whose two largest samples are
#: within the rounding above gives its gradient to another sample on the
#: card (in a first run 0.21 of the largest value apart elementwise)
POOL_GRAD_NORM_TOL = 5e-2


class Placed:
    """Each numpy input copied to a device once: the timed calls read it
    there, so no host-to-device copy is in their time. ``grad`` gives a
    fresh leaf on the same storage that requires its gradient."""

    def __init__(self, torch):
        self.torch, self.cache = torch, {}

    def __call__(self, a, dev, grad=False):
        key = (id(a), str(dev))
        if key not in self.cache:   # the array is kept so its id is not reused
            self.cache[key] = (a, self.torch.as_tensor(a, device=dev))
        x = self.cache[key][1]
        return x.detach().requires_grad_(True) if grad else x


def write_image_folder(np, root, n, classes, seed=0):
    """``n`` uint8 HWC images as ``.npy`` files in ``classes`` folders,
    from ``default_rng(seed)``, shaped as ImageNet's are: the short side
    256-400, the long side up to 500, either way up. Returns the bytes."""
    rng = np.random.default_rng(seed)
    total = 0
    for c in range(classes):
        os.makedirs(os.path.join(root, f"c{c:03d}"))
    for i in range(n):
        short = int(rng.integers(256, 401))
        long = int(rng.integers(short, 501))
        h, w = (short, long) if rng.random() < 0.5 else (long, short)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.save(os.path.join(root, f"c{i % classes:03d}", f"{i:05d}.npy"),
                img)
        total += img.nbytes
    return total


def folder_pipeline(T):
    """The classification script's transforms, HWC (config 2's layout)."""
    return T.Compose([T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
                      T.ToTensor(data_format="HWC"),
                      T.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                  data_format="HWC")])


def worker_rebuild(np, T, ds, indices, seed):
    """The images ``indices`` of ``ds`` as a worker whose seed is ``seed``
    makes them, on the host with no workers: the crop draws from
    ``default_rng([seed, 0])`` and the flips from ``default_rng([seed,
    1])``, the order the transforms begin drawing in a worker."""
    pipe = folder_pipeline(T)
    pipe.transforms[0]._rng = np.random.default_rng([seed, 0])
    pipe.transforms[1]._rng = np.random.default_rng([seed, 1])
    return np.stack([pipe(ds.loader(ds.samples[j][0])) for j in indices])


def ring_crossing(np, batch, capacity, timeout=30.0):
    """``batch`` through a shared-memory ring of ``capacity`` bytes as a
    process worker sends it to the trainer: a forked process puts it (the
    pickle and the pushes, in pieces past a quarter of the ring, timed in
    that process) while this one gets it (timed from the first record in
    the ring: the pops, the gather of the pieces and the unpickle). Each
    side holds its own GIL, as a worker and the trainer do."""
    from paddle_tpu_torch.native import ShmQueue
    q = ShmQueue(capacity=capacity)
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:               # the producer: numpy and the ring, no CUDA
        code = 1
        try:
            os.close(r)
            child = ShmQueue(name=q.name, capacity=capacity, owner=False)
            t0 = time.perf_counter()
            child.put(batch, timeout)
            os.write(w, json.dumps(time.perf_counter() - t0).encode())
            child.close()
            code = 0
        finally:
            os._exit(code)
    os.close(w)
    try:
        deadline = time.perf_counter() + timeout
        while q.qsize() == 0 and time.perf_counter() < deadline:
            time.sleep(1e-4)
        t0 = time.perf_counter()
        got = q.get(timeout=timeout)
        get_s = time.perf_counter() - t0
        with os.fdopen(r, "rb") as f:
            put_s = json.loads(f.read())
    finally:
        _, status = os.waitpid(pid, 0)
        q.close()
    check(status == 0, f"the ring's producer exited with {status}")
    check(all(np.array_equal(a, b) for a, b in zip(got, batch)),
          "the ring changed a batch")
    return put_s, get_s


def pipeline_breakdown(torch, np, P, ds, dev, batch, capacity, n=32):
    """Where a batch's host time goes, each stage alone: the transforms of
    one image (load included, over ``n`` images), the collate of ``batch``
    of them, that batch's pickle and unpickle in this process, its
    crossing of the loader's ring of ``capacity`` bytes (``ring_crossing``:
    the worker's put and the trainer's get, in two processes), and the
    pinned copy to ``dev`` (to its end)."""
    t0 = time.perf_counter()
    items = [ds[j] for j in range(n)]
    per_image = (time.perf_counter() - t0) / n
    samples = [items[j % n] for j in range(batch)]
    t0 = time.perf_counter()
    x, y = P.io.default_collate_fn(samples)
    collate = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = pickle.dumps((x, y), protocol=pickle.HIGHEST_PROTOCOL)
    dumps = time.perf_counter() - t0
    t0 = time.perf_counter()
    pickle.loads(raw)
    loads = time.perf_counter() - t0
    del raw
    put_s, get_s = ring_crossing(np, (x, y), capacity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src = torch.from_numpy(x)
    if torch.device(dev).type == "cuda":   # as prefetch_to_device copies
        src = src.pin_memory()
    src.to(dev, non_blocking=True)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0
    return {"transform_per_image": per_image * 1e3,
            "transforms_per_batch": per_image * batch * 1e3,
            "collate": collate * 1e3, "pickle": dumps * 1e3,
            "unpickle": loads * 1e3, "ring_bytes": capacity,
            "ring_worker_put": put_s * 1e3, "ring_trainer_get": get_s * 1e3,
            "pin_and_copy": h2d * 1e3, "batch_bytes": int(x.nbytes)}


def phase_train_resnet_folder_bf16(torch, np, P, hc, hfa, hfp, fmb, peaks,
                                   resnet50, Momentum,
                                   make_sharded_train_step, resnet_row,
                                   dev="cuda", n_images=1280, classes=100,
                                   batch=256, epochs=2, warmup=2, timed=8):
    """The slice's main path: ResNet-50 at BASELINE config 2 fed from image
    files. 1,280 ``.npy`` images in 100 class folders (``default_rng(0)``,
    ImageNet's shapes) read by ``vision.datasets.DatasetFolder`` through
    ``RandomResizedCrop(224)``, ``RandomHorizontalFlip()``,
    ``ToTensor("HWC")`` and ImageNet's ``Normalize``, loaded by
    ``io.DataLoader(batch_size=256, shuffle=True, drop_last=True,
    use_shared_memory=True, num_workers=min(8, cpus - 1),
    prefetch_to_device=True)``; the model and step as
    ``train_resnet_bf16``. Two epochs with no profiler (2 warm-up and 8
    timed steps): step times between CUDA events with no host sync inside
    the window, images/s over the steps' times and over the window's wall
    (beside ``train_resnet_bf16``'s, measured the same two ways), each
    step's wait on the loader, epoch 2's first wait (the workers' fork
    and first batch) apart from the others, peak memory. Then a third
    epoch under torch.profiler (CUDA activity only) for the device's busy
    share of its wall. Checks: K5/K6/K7/K8 72/36/32/16 a step and no other
    kernel; each batch's first image, and the whole first batch, equal to
    the host's rebuild from the worker's seeds (so every batch's flips are
    its worker's own stream), no two batches with one flip pattern; the
    step-0 loss near ln 1000."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.io.dataloader import ring_capacity
    T = P.vision.transforms
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        nbytes = write_image_folder(np, root, n_images, classes)
        write_s = time.perf_counter() - t0
        ds = P.vision.datasets.DatasetFolder(root,
                                             transform=folder_pipeline(T))
        check(len(ds) == n_images and len(ds.classes) == classes,
              f"DatasetFolder found {len(ds)} files, {len(ds.classes)} "
              f"classes")
        workers = min(8, os.cpu_count() - 1)
        loader = P.io.DataLoader(ds, batch_size=batch, shuffle=True,
                                 drop_last=True, use_shared_memory=True,
                                 num_workers=workers, prefetch_to_device=True,
                                 places=dev)
        per_epoch = len(loader)
        n_timed_steps = epochs * per_epoch
        check(n_timed_steps == warmup + timed,
              f"{n_timed_steps} steps, expected {warmup + timed}")
        check(warmup < per_epoch, "epoch 2's first batch is a warm-up step")
        n_steps = (epochs + 1) * per_epoch     # with the profiled epoch
        model = resnet50(data_format="NHWC", stem_mode="space_to_depth",
                         device=dev, seed=0)
        model.train()
        model.to(torch.bfloat16)
        opt = Momentum(learning_rate=0.1, momentum=0.9, multi_precision=True)
        step = make_sharded_train_step(model, opt, resnet_loss)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        np.random.seed(FOLDER_SEED)
        # the main path: counts set to 0 just before it and read after
        zero_all(hfa, hfp, hc, fmb)
        losses, events, waits, firsts = [], [], [], []
        prof, t_window, i = None, None, 0
        for epoch in range(epochs + 1):
            if epoch == epochs:       # the timed window ends; the profiled
                torch.cuda.synchronize()     # epoch begins
                wall_s = time.perf_counter() - t_window
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                t_prof = time.perf_counter()
            it = iter(loader)
            while True:
                if i == warmup:
                    torch.cuda.synchronize()
                    t_window = time.perf_counter()
                t0 = time.perf_counter()
                got = next(it, None)
                if got is None:
                    break
                waits.append(time.perf_counter() - t0)
                x, y = got
                if i == 0:
                    first = x.clone()     # read after the window: no sync
                firsts.append(x[0].clone())
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(step.step((x.to(torch.bfloat16), y)))
                end.record()
                events.append((start, end))
                i += 1
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t_prof
        prof.__exit__(None, None, None)
        launches = all_counts(hfa, hfp, hc, fmb)
        clocks = card_clocks()
        losses = [float(v) for v in losses]
        times = [a.elapsed_time(b) for a, b in events]
        timed_ms = times[warmup:n_timed_steps]
        first = first.cpu().numpy()
        firsts = [f.cpu().numpy() for f in firsts]
        busy = device_profile(prof, prof_wall_s * 1e3)
        # the host's rebuild: the sampler's orders and the workers' base
        # seeds as the loader drew them from np.random, then each batch's
        # first image (its worker's first draws) and the whole first batch
        np.random.seed(FOLDER_SEED)
        orders, bases = [], []
        for _ in range(epochs + 1):
            orders.append(list(loader.batch_sampler))
            bases.append(int(np.random.randint(0, 2**31 - 1)))
        n_workers = min(workers, per_epoch)
        check(per_epoch <= n_workers, "a worker made two batches an epoch")
        patterns, first_ok = [], []
        t0 = time.perf_counter()
        for e in range(epochs + 1):
            for b in range(per_epoch):
                seed = bases[e] + b            # batch b is worker b's first
                idx = orders[e][b] if (e, b) == (0, 0) else orders[e][b][:1]
                imgs = worker_rebuild(np, T, ds, idx, seed)
                patterns.append(tuple(np.random.default_rng([seed, 1]).random(
                    batch) < 0.5))
                k = e * per_epoch + b
                first_ok.append(bool(np.array_equal(imgs[0], firsts[k])))
                if (e, b) == (0, 0):
                    batch0_equal = bool(np.array_equal(imgs, first))
        rebuild_s = time.perf_counter() - t0
        breakdown = pipeline_breakdown(
            torch, np, P, ds, dev, batch,
            ring_capacity(n_workers, loader.prefetch_factor))
        del model, opt, step, loader
    timed_waits = waits[warmup:n_timed_steps]
    edge = per_epoch - warmup              # epoch 2's first, in the window
    steady_waits = timed_waits[:edge] + timed_waits[edge + 1:]
    prof_first_wait = waits[n_timed_steps]
    row = {"phase": "train_resnet_folder_bf16", "clocks": clocks,
           "model": "resnet50", "images": n_images, "classes": classes,
           "image_bytes": nbytes, "write_s": write_s,
           "batch": [batch, 224, 224, 3], "dtype": "bf16 (model.to)",
           "pipeline": "DatasetFolder(.npy) -> RandomResizedCrop(224), "
                       "RandomHorizontalFlip(), ToTensor(HWC), "
                       "Normalize(ImageNet, HWC) -> DataLoader(shuffle, "
                       "drop_last, use_shared_memory, prefetch_to_device)",
           "cpu_count": os.cpu_count(), "num_workers": workers,
           "workers_an_epoch": n_workers, "epochs": epochs,
           "losses": losses, "warmup_steps": warmup, "timed_steps": timed,
           "step_ms": times, "step_p50_ms": percentile(timed_ms, 50),
           "step_p99_ms": percentile(timed_ms, 99),
           "train_resnet_bf16_step_p50_ms": resnet_row["step_p50_ms"],
           "loader_wait_ms": [w * 1e3 for w in waits],
           "timed_loader_wait_ms": sum(timed_waits) * 1e3,
           "epoch_start_wait_ms": timed_waits[edge] * 1e3,
           "steady_wait_p50_ms": percentile(steady_waits, 50) * 1e3,
           "steady_wait_max_ms": max(steady_waits) * 1e3,
           "window_wall_ms": wall_s * 1e3,
           "images_per_s_steps": timed * batch / (sum(timed_ms) / 1e3),
           "images_per_s_wall": timed * batch / wall_s,
           "images_per_s_wall_past_epoch_start":
               timed * batch / (wall_s - timed_waits[edge]),
           "train_resnet_bf16_images_per_s": resnet_row["images_per_s"],
           "train_resnet_bf16_images_per_s_wall":
               resnet_row["images_per_s_wall"],
           "profiled_epoch_wall_ms": prof_wall_s * 1e3,
           "profiled_epoch_first_wait_ms": prof_first_wait * 1e3,
           "device_busy_share": busy["device_busy_share"],
           "device_busy_share_past_epoch_start":
               busy["device_busy_ms"] / ((prof_wall_s - prof_first_wait)
                                         * 1e3),
           "device_busy_ms": busy["device_busy_ms"],
           "top_device_ms": busy["top_device_ms"][:6],
           "max_memory_allocated_gb": peak_gb,
           "host_ms": breakdown,
           "rebuild_s": rebuild_s, "first_batch_equal": batch0_equal,
           "first_images_equal": first_ok,
           "distinct_flip_patterns": len(set(patterns)),
           "launches": launches,
           "launches_per_step": {k: launches[k] / n_steps
                                 for k in CONV_KERNELS}}
    emit(row)
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {row}")
    check(math.log(1000) - 0.5 <= losses[0] <= math.log(1000) + 1.5,
          f"step-0 loss {losses[0]}")
    for kname, per_step in RESNET_LAUNCHES.items():
        check(launches[kname] == per_step * n_steps,
              f"train_resnet_folder_bf16 {kname}: {launches[kname]} "
              f"launches in {n_steps} steps, expected {per_step} a step")
    for kname in (*ATTENTION_KERNELS, "fused_matmul_bn_fwd"):
        check(launches[kname] == 0, f"folder training launched {kname}")
    check(batch0_equal, "the first batch differs from its host rebuild")
    check(all(first_ok), f"a batch's first image differs from its "
                         f"worker's rebuild: {first_ok}")
    check(len(set(patterns)) == len(patterns),
          "two batches drew one flip pattern")
    torch.cuda.empty_cache()
    return launches


def held(torch, name, got, ref, tol, exact=False):
    """The largest error of ``got`` (the card's outputs) against ``ref``
    (the CPU path's) over the largest |ref| (at least 1); bit-equal where
    ``exact``. Fails past ``tol`` (a number, or one an output)."""
    worst = 0.0
    tols = tol if isinstance(tol, (list, tuple)) else [tol] * len(ref)
    for g, r, tl in zip(got, ref, tols):
        g = g.detach().cpu()
        r = r.detach().cpu()
        check(tuple(g.shape) == tuple(r.shape) and g.dtype == r.dtype,
              f"{name}: {tuple(g.shape)} {g.dtype} against "
              f"{tuple(r.shape)} {r.dtype}")
        if exact:
            check(torch.equal(g, r), f"{name}: differs from the CPU path")
            continue
        if g.numel():
            wide = torch.complex128 if g.is_complex() else torch.float64
            g, r = g.to(wide), r.to(wide)
            if isinstance(tl, dict):     # in the 2-norm
                err = float((g - r).norm() / r.norm().clamp_min(1e-30))
                tl = tl["norm"]
            else:
                err = float((g - r).abs().max()
                            / r.abs().max().clamp_min(1.0))
            check(err <= tl, f"{name}: {err} from the CPU path (tol {tl})")
            worst = max(worst, err)
    return worst


def card_and_cpu(torch, name, fn, tol, rows, dev, exact=False, iters=5,
                 cpu_fn=None, cpu_ref=None):
    """``fn(dev)`` (its outputs, a list of tensors) on the card, timed
    (the median of ``iters`` calls between CUDA events), and on the CPU
    path (``cpu_fn``, by default ``fn``; ``cpu_ref`` picks the card's
    outputs it covers); held within ``tol``."""
    got = fn(dev)
    ms = median_ms(lambda: fn(dev), iters=iters, warmup=1)
    t0 = time.perf_counter()
    ref = (cpu_fn or fn)("cpu")
    cpu_s = time.perf_counter() - t0
    if cpu_ref is not None:
        got = cpu_ref(got)
    err = held(torch, name, got, ref, tol, exact)
    rows[name] = {"ms": ms, "cpu_s": cpu_s, "max_rel_err": err,
                  "tol": tol, "exact": exact}


def with_grads(torch, out, leaves, seed, proj):
    """``out`` and the gradients of a fixed random projection of it with
    respect to ``leaves``. The projection is drawn on the host from
    ``seed`` once a shape and kept on each device in ``proj`` (the card
    and the CPU path take the same one; no timed call draws it)."""
    key = (seed, tuple(out.shape), str(out.device))
    if key not in proj:
        g = torch.Generator(device="cpu").manual_seed(seed)
        proj[key] = torch.randn(out.shape, generator=g).to(out.device)
    grads = torch.autograd.grad((out * proj[key]).sum(), leaves)
    return [out.detach(), *grads]


def yolo_heads(np, rng, batch, classes, img=608):
    """YOLOv3's three heads at ``img``²: ``[batch, 3·(5+classes), s, s]``
    at strides 32, 16 and 8 with their anchor masks."""
    return [((0.5 * rng.standard_normal(
        (batch, 3 * (5 + classes), img // ds, img // ds))).astype(np.float32),
        mask, ds) for ds, mask in ((32, [6, 7, 8]), (16, [3, 4, 5]),
                                   (8, [0, 1, 2]))]


YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]


def phase_vision_ops(torch, np, P, hfa, hfp, hc, fmb, dev="cuda", scale=1):
    """Each function of ``vision/ops.py`` on the card against the CPU path
    at the sizes detectors run (``scale`` > 1 divides them, for a dry run
    on the CPU): ``nms`` on 6,000 RPN boxes at IoU 0.7 and category-wise
    on 80 x 100 boxes at 0.5 (indices bit-equal); ``roi_align`` and
    ``roi_pool`` forward and backward on 2 x 256 x 200 x 336 features,
    1,000 rois an image, 7 x 7, scale 1/4, S = 2; ``psroi_pool`` (21
    classes x 7 x 7, 300 rois); ``deform_conv2d`` with a mask forward and
    backward (x 2 x 512 x 25 x 42, weight 512 x 512 x 3 x 3); ``yolo_box``
    and ``yolo_loss`` (forward and backward) on YOLOv3's three heads at
    608², 80 classes, batch 8, 50 boxes an image; ``matrix_nms`` at
    PP-YOLO's settings (22,743 boxes, 80 classes, nms_top_k 1000,
    keep_top_k 100, batch 8; the CPU path on the first 2 images);
    ``generate_proposals`` (pre 6,000, post 1,000, 15 anchors on 50 x 84,
    2 images), ``distribute_fpn_proposals`` (levels 2-5), ``box_coder``
    and ``prior_box`` on SSD300's 19 x 19 map. Outputs within 1e-5 of
    their largest value (the sampled ones and gradients ``GRAD_TOL``),
    indices bit-equal. Each
    function's card time (median of 5 calls, the inputs already on the
    card); no hand-written kernel launches."""
    O = P.vision.ops
    rng = np.random.default_rng(0)
    rows = {}
    zero_all(hfa, hfp, hc, fmb)

    t = Placed(torch)
    proj = {}     # with_grads' projections

    # nms: RPN proposals clustered round 300 objects of an 800 x 1344 image
    n = 6000 // scale
    centers = rng.uniform((0, 0), (1344, 800), (300, 2))[
        rng.integers(0, 300, n)] + rng.normal(0, 12, (n, 2))
    wh = np.exp(rng.uniform(np.log(16), np.log(400), (n, 2)))
    rpn = np.concatenate([centers - wh / 2, centers + wh / 2], 1) \
        .astype(np.float32)
    rpn_scores = rng.random(n).astype(np.float32)
    card_and_cpu(torch, "nms", lambda d: [O.nms(
        t(rpn, d), 0.7, t(rpn_scores, d))], 0, rows, dev, exact=True)
    nc, per = 80, 100 // scale
    det = rpn[rng.integers(0, n, nc * per)]
    cats = np.repeat(np.arange(nc), per)
    det_scores = rng.random(nc * per).astype(np.float32)
    card_and_cpu(torch, "nms_categories", lambda d: [O.nms(
        t(det, d), 0.5, t(det_scores, d), t(cats, d), list(range(nc)))], 0,
        rows, dev, exact=True)

    # roi_align / roi_pool on an FPN level-2 map (stride 4)
    c, h, w = 256 // scale, 200, 336
    feat = rng.standard_normal((2, c, h, w)).astype(np.float32)
    r = 1000 // scale
    cxy = rng.uniform((0, 0), (1344, 800), (2 * r, 2))
    rwh = np.exp(rng.uniform(np.log(8), np.log(600), (2 * r, 2)))
    rois = np.concatenate([cxy - rwh / 2, cxy + rwh / 2], 1) \
        .astype(np.float32)
    num = np.array([r, r])
    # roi_pool's gradient goes to each bin's largest sample: where two
    # samples are within the card's rounding of each other, the card and
    # the CPU pick apart, so its gradient is held in the 2-norm
    for name, fn, tol in (
            ("roi_align", lambda x, b, k: O.roi_align(x, b, k, 7, 0.25, 2),
             GRAD_TOL),
            ("roi_pool", lambda x, b, k: O.roi_pool(x, b, k, 7, 0.25),
             [GRAD_TOL, {"norm": POOL_GRAD_NORM_TOL}])):
        def run(d, fn=fn):
            x = t(feat, d, grad=True)
            return with_grads(torch, fn(x, t(rois, d), t(num, d)), [x], 1,
                              proj)
        card_and_cpu(torch, name, run, tol, rows, dev)
    ps = rng.standard_normal((1, 21 * 49, 50, 84)).astype(np.float32)
    card_and_cpu(torch, "psroi_pool", lambda d: [O.psroi_pool(
        t(ps, d), t(rois[:300 // scale], d), None, 7, 1 / 16)], GRAD_TOL,
        rows, dev)

    # DCNv2 at a ResNet stage-5 width
    ci = 512 // scale
    dx = rng.standard_normal((2, ci, 25, 42)).astype(np.float32)
    dw = (rng.standard_normal((ci, ci, 3, 3)) / np.sqrt(9 * ci)) \
        .astype(np.float32)
    doff = (2 * rng.standard_normal((2, 18, 25, 42))).astype(np.float32)
    dmask = rng.random((2, 9, 25, 42)).astype(np.float32)

    def deform(d):
        x, off, m, wt = (t(a, d, grad=True) for a in (dx, doff, dmask, dw))
        out = O.deform_conv2d(x, off, wt, None, padding=1, mask=m)
        return with_grads(torch, out, [x, off, m, wt], 2, proj)
    card_and_cpu(torch, "deform_conv2d", deform, GRAD_TOL, rows, dev)

    # YOLOv3's three heads at 608², 80 classes, batch 8, 50 boxes an image
    b = 8 // scale if scale > 1 else 8
    heads = yolo_heads(np, rng, b, 80)
    size = np.full((b, 2), 608)
    gt = np.concatenate([rng.uniform(0.05, 0.95, (b, 50, 2)),
                         rng.uniform(0.02, 0.5, (b, 50, 2))], -1) \
        .astype(np.float32)
    label = rng.integers(0, 80, (b, 50))

    def yolo_box(d):
        out = []
        for x, mask, ds in heads:
            anchors = [v for i in mask for v in YOLO_ANCHORS[2 * i:2 * i + 2]]
            out += list(O.yolo_box(t(x, d), t(size, d), anchors, 80, 0.01,
                                   ds))
        return out
    card_and_cpu(torch, "yolo_box", yolo_box, 1e-5, rows, dev)

    def yolo_loss(d):
        xs = [t(x, d, grad=True) for x, _, _ in heads]
        loss = sum(O.yolo_loss(x, t(gt, d), t(label, d), YOLO_ANCHORS, mask,
                               80, 0.7, ds).sum()
                   for x, (_, mask, ds) in zip(xs, heads))
        return [loss.detach(), *torch.autograd.grad(loss, xs)]
    card_and_cpu(torch, "yolo_loss", yolo_loss, [1e-5] + [GRAD_TOL] * 3,
                 rows, dev)

    # PP-YOLO's matrix NMS: 22,743 boxes (608²'s three heads x 3 anchors)
    m = 22743 // scale
    mb = np.concatenate([rng.uniform(0, 560, (b, m, 2)),
                         np.zeros((b, m, 2))], -1)
    mb[..., 2:] = mb[..., :2] + rng.uniform(8, 300, (b, m, 2))
    mb = mb.astype(np.float32)
    msc = rng.random((b, 80, m)).astype(np.float32)
    sub = min(2, b)

    def matrix_nms(d, n_img=b):
        return list(O.matrix_nms(
            t(mb[:n_img], d), t(msc[:n_img], d), 0.01, 0.01, 1000, 100,
            background_label=-1, normalized=False, return_index=True))
    # the first `sub` images' rows, indices and counts
    card_and_cpu(torch, "matrix_nms", matrix_nms, 1e-6, rows, dev,
                 cpu_fn=lambda d: matrix_nms(d, sub),
                 cpu_ref=lambda o: [o[0][:int(o[2][:sub].sum())],
                                    o[1][:int(o[2][:sub].sum())],
                                    o[2][:sub]])
    got = matrix_nms(dev)
    check(int(got[2].sum()) == got[0].shape[0] and
          int(got[2].max()) <= 100, f"matrix_nms counts {got[2].tolist()}")

    # RPN proposals: 15 anchors (5 sizes x 3 ratios) at stride 16 on 50 x 84
    gh, gw = 50, 84
    sizes = np.array([32, 64, 128, 256, 512], np.float32)
    ratios = np.array([0.5, 1.0, 2.0], np.float32)
    aw = (sizes[:, None] / np.sqrt(ratios)).reshape(-1)
    ah = (sizes[:, None] * np.sqrt(ratios)).reshape(-1)
    gy, gx = np.meshgrid((np.arange(gh) + 0.5) * 16, (np.arange(gw) + 0.5)
                         * 16, indexing="ij")
    anchors = np.stack([gx[..., None] - aw / 2, gy[..., None] - ah / 2,
                        gx[..., None] + aw / 2, gy[..., None] + ah / 2],
                       -1).reshape(-1, 4).astype(np.float32)
    sc = rng.random((2, 15, gh, gw)).astype(np.float32)
    dl = (0.2 * rng.standard_normal((2, 60, gh, gw))).astype(np.float32)
    var = np.ones_like(anchors)
    im = np.array([[800, 1344], [800, 1344]])

    def proposals(d):
        return list(O.generate_proposals(
            t(sc, d), t(dl, d), im, t(anchors, d), t(var, d),
            pre_nms_top_n=6000 // scale, post_nms_top_n=1000 // scale,
            nms_thresh=0.7, min_size=0.1, return_rois_num=True))
    card_and_cpu(torch, "generate_proposals", proposals, 1e-5, rows, dev)
    props = proposals(dev)[0]
    card_and_cpu(torch, "distribute_fpn_proposals", lambda d: [
        *O.distribute_fpn_proposals(props.to(d), 2, 5, 4, 224)[0],
        O.distribute_fpn_proposals(props.to(d), 2, 5, 4, 224)[1]], 0, rows,
        dev, exact=True)

    # SSD300's 19 x 19 map (min 60, max 111, ratios 2 and 3, step 16)
    def priors(d):
        return list(O.prior_box(
            torch.zeros((1, 1024, 19, 19), device=d),
            torch.zeros((1, 3, 300, 300), device=d), [60.0], [111.0],
            [2.0, 3.0], flip=True, clip=True, steps=(16, 16)))
    card_and_cpu(torch, "prior_box", priors, 1e-6, rows, dev)
    pri = priors("cpu")[0].reshape(-1, 4).numpy()
    tgt = (pri + 0.02 * rng.standard_normal(pri.shape)).astype(np.float32)
    deltas = (0.5 * rng.standard_normal(pri.shape)).astype(np.float32)
    pvar = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    card_and_cpu(torch, "box_coder", lambda d: [
        O.box_coder(t(pri, d), t(pvar, d), t(tgt, d)),
        O.box_coder(t(pri, d), t(pvar, d), t(deltas, d),
                    "decode_center_size")], 1e-5, rows, dev)
    launches = all_counts(hfa, hfp, hc, fmb)
    emit({"phase": "vision_ops", "functions": rows,
          "launches": {k: v for k, v in launches.items() if v}})
    check(not any(launches.values()),
          f"vision ops launched hand-written kernels: {launches}")
    return rows


def plain_levenshtein(a, b):
    """The edit distance cell by cell, the plain DP edit_distance's row
    form is held to."""
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


FFT_1D = ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft")
FFT_ND = ("fft2", "ifft2", "rfft2", "irfft2", "fftn", "ifftn", "rfftn",
          "irfftn", "hfft2", "ihfft2", "hfftn", "ihfftn")


def phase_audio_text(torch, np, P, hfa, hfp, hc, fmb, dev="cuda", scale=1):
    """The 22 ``fft`` names on the card against the CPU path (1-D at 2^20
    points, 2-D at 1024², real input where the function is real-to-
    complex, complex otherwise; within 1e-5 of the largest magnitude);
    ``stft`` then ``istft`` on 32 clips of 10 s at 16 kHz (n_fft 512, hop
    160, Hann), the round trip's error; ``LogMelSpectrogram`` and ``MFCC``
    (64 mels, 40 coefficients) on those clips against the CPU path;
    ``viterbi_decode`` at B = 64 x T = 256 x 50 tags (paths bit-equal to
    the CPU's); ``edit_distance`` on 256 pairs of 50-200 tokens (16 held
    to the plain cell-by-cell DP); ``shard_index``. ``scale`` > 1 divides
    the sizes for a dry run on the CPU. No hand-written kernel
    launches."""
    from paddle_tpu_torch.core.device import device_guard
    F = P.fft
    rng = np.random.default_rng(0)
    rows = {}
    t = Placed(torch)
    zero_all(hfa, hfp, hc, fmb)
    n1 = 2 ** 20 // scale
    side = 1024 // scale
    real1 = rng.standard_normal(n1).astype(np.float32)
    cplx1 = (rng.standard_normal(n1)
             + 1j * rng.standard_normal(n1)).astype(np.complex64)
    real2 = rng.standard_normal((side, side)).astype(np.float32)
    cplx2 = (rng.standard_normal((side, side))
             + 1j * rng.standard_normal((side, side))).astype(np.complex64)
    for name in FFT_1D + FFT_ND:
        fn = getattr(F, name)
        # real-to-complex transforms take a real signal, the others complex
        real = name in ("rfft", "ihfft", "rfft2", "ihfft2", "rfftn",
                        "ihfftn")
        x = (real1 if real else cplx1) if name in FFT_1D else \
            (real2 if real else cplx2)
        card_and_cpu(torch, name, lambda d, fn=fn, x=x: [
            fn(t(x, d))], 1e-5, rows, dev)
    with device_guard(dev):
        card_freq = [F.fftfreq(n1, 0.5), F.rfftfreq(n1, 0.5)]
    with device_guard("cpu"):
        cpu_freq = [F.fftfreq(n1, 0.5), F.rfftfreq(n1, 0.5)]
    rows["fftfreq"] = {"max_rel_err": held(torch, "fftfreq", card_freq,
                                           cpu_freq, 0, exact=True)}
    for name in ("fftshift", "ifftshift"):
        card_and_cpu(torch, name, lambda d, name=name: [getattr(F, name)(
            t(real2, d))], 0, rows, dev, exact=True)

    # 32 clips of 10 s at 16 kHz
    clips, sr = 32 // scale, 16000
    wav = (0.1 * rng.standard_normal((clips, 10 * sr))).astype(np.float32)
    hann = np.hanning(513)[:-1].astype(np.float32)   # periodic

    def stft(d):
        return [P.signal.stft(t(wav, d), 512, 160, window=t(hann, d))]
    card_and_cpu(torch, "stft", stft, 1e-5, rows, dev)
    spec = stft(dev)[0]
    back = P.signal.istft(spec, 512, 160, window=t(hann, dev),
                          length=wav.shape[1])
    ms = median_ms(lambda: P.signal.istft(spec, 512, 160, window=t(
        hann, dev), length=wav.shape[1]), iters=5, warmup=1)
    trip = float((back.cpu() - torch.from_numpy(wav)).abs().max())
    rows["istft"] = {"ms": ms, "round_trip_max_abs_err": trip}
    check(trip <= 1e-5, f"stft -> istft round trip off by {trip}")
    for name, cls, kw in (
            ("log_mel_spectrogram", "LogMelSpectrogram", {}),
            ("mfcc", "MFCC", {"n_mfcc": 40})):
        layers = {}
        for d in (dev, "cpu"):
            layers[d] = getattr(P.audio.features, cls)(
                sr=sr, n_fft=512, hop_length=160, n_mels=64, f_min=50.0,
                device=d, **kw)
        # decibels: 4.3 dB a unit of a band's relative error, and cuFFT and
        # the CPU's FFT round a band's small bins apart (8.5e-6 of the
        # largest in a first run)
        card_and_cpu(torch, name, lambda d, layers=layers: [
            layers[d](t(wav, d))], 1e-4, rows, dev)

    # a CRF's Viterbi decode: B = 64, T = 256, 50 tags
    pot = rng.standard_normal((64 // scale, 256, 50)).astype(np.float32)
    trans = rng.standard_normal((50, 50)).astype(np.float32)
    lengths = rng.integers(1, 257, 64 // scale)
    card_and_cpu(torch, "viterbi_decode", lambda d: [
        P.text.viterbi_decode(t(pot, d), t(trans, d), t(lengths, d))[1]],
        0, rows, dev, exact=True)
    card_and_cpu(torch, "viterbi_scores", lambda d: [
        P.text.viterbi_decode(t(pot, d), t(trans, d), t(lengths, d))[0]],
        1e-6, rows, dev)

    # edit distance, a host DP: 256 pairs of 50-200 tokens
    hyps = [rng.integers(0, 40, rng.integers(50, 201)) for _ in range(256)]
    refs = [rng.integers(0, 40, rng.integers(50, 201)) for _ in range(256)]
    t0 = time.perf_counter()
    dist, count = P.text.edit_distance(hyps, refs, normalized=False)
    ed_s = time.perf_counter() - t0
    plain = [plain_levenshtein(list(h), list(r))
             for h, r in zip(hyps[:16], refs[:16])]
    check(dist[:16, 0].tolist() == plain and int(count) == 256,
          "edit_distance differs from the plain DP")
    rows["edit_distance"] = {"host_s": ed_s, "pairs": 256,
                             "held_to_plain": 16}
    ids = rng.integers(0, 1000, (4096, 128))
    card_and_cpu(torch, "shard_index", lambda d: [P.text.shard_index(
        t(ids, d), 1000, 8, 3)], 0, rows, dev, exact=True)
    launches = all_counts(hfa, hfp, hc, fmb)
    emit({"phase": "audio_text", "functions": rows,
          "launches": {k: v for k, v in launches.items() if v}})
    check(not any(launches.values()),
          f"fft, signal, audio or text launched hand-written kernels: "
          f"{launches}")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import numpy as np
        from paddle_tpu_torch import amp
        from paddle_tpu_torch.framework import make_sharded_train_step
        from paddle_tpu_torch.ops._hopper import build
        from paddle_tpu_torch.ops._hopper import flash_attention as hfa
        from paddle_tpu_torch.ops._hopper import flash_attention_packed as hfp
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch.fault.injection import register_fire_point
        from paddle_tpu_torch.serving import (ModelDrafter, Request,
                                              RequestJournal, ServingEngine,
                                              ShedPolicy, SpillError)
        from paddle_tpu_torch.text.models.bert import (BertForPretraining,
                                                       bert_base)
        from paddle_tpu_torch.text.models.gpt import (GPTConfig,
                                                      GPTForCausalLM,
                                                      gpt3_1p3b, gpt_tiny)
        from paddle_tpu_torch.core import flags
        from paddle_tpu_torch.nn.functional import cross_entropy
        from paddle_tpu_torch.ops._hopper import conv as hc
        from paddle_tpu_torch.optimizer import Momentum
        from paddle_tpu_torch.vision.models import (resnet50,
                                                    resnext50_32x4d,
                                                    wide_resnet50_2)
        from paddle_tpu_torch.text.models import ernie
        from paddle_tpu_torch.nn import MultiHeadAttention
        from paddle_tpu_torch.nn import functional as PF
        from paddle_tpu_torch.ops._hopper import fused_matmul_bn as fmb
        from paddle_tpu_torch.core import random as rng
        import paddle_tpu_torch as P
        from paddle_tpu_torch import observability as obs
        tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package must sit beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    # full f32 products for the f32 reference comparisons (TF32 keeps about
    # three decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = "--profile" in sys.argv[1:]

    smi_line = phase_env(torch, build)
    phase_build(build)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    worst, timing = phase_kernel(torch, hfa, peaks)
    worst_bwd, timing_bwd = phase_kernel_bwd(torch, hfa, peaks)
    worst_masked, timing_masked, masked_launches = phase_kernel_masked(
        torch, np, hfa, hfp, MultiHeadAttention, PF)
    phase_dense_route(torch, hfa, hfp, tfa)
    worst_packed, timing_packed = phase_kernel_packed(torch, np, hfp, peaks)
    worst_stream, timing_stream = phase_kernel_packed_stream(torch, np, hfp,
                                                             peaks)
    worst_conv, stats_conv, timing_conv = phase_kernel_conv(torch, hc,
                                                            peaks)
    worst_wide, timing_wide = phase_kernel_conv_wide(torch, hc, peaks)
    phase_pool_ties(torch, PF)
    # attention-prob dropout in the nine attention kernels (rate 0.1), as
    # parts of phases 3-6
    drop_k1, worst_d1 = dropout_k1_k3(torch, hfa, hfp, peaks, timing,
                                      timing_bwd)
    emit({"phase": "kernel", "part": "dropout", "rate": DROP_RATE,
          **drop_k1})
    drop_k4, worst_d4 = dropout_k4(torch, np, hfa, hfp, timing_packed)
    emit({"phase": "kernel_packed", "part": "dropout", "rate": DROP_RATE,
          **drop_k4})
    drop_st, worst_ds = dropout_stream(torch, np, hfa, hfp, timing_stream)
    emit({"phase": "kernel_packed_stream", "part": "dropout",
          "rate": DROP_RATE, **drop_st})
    drop_timing = {**drop_k1["timing"], **drop_k4["timing"],
                   **drop_st["timing"]}
    worst_drop = {**worst_d1, **worst_d4, **worst_ds}
    worst_k9, k9_launches, timing_k9 = phase_kernel_fused_matmul_bn(
        torch, fmb, peaks)
    worst_f16, timing_f16 = phase_kernel_float16(torch, np, hfa, hfp, hc,
                                                 fmb, peaks)
    # no model path calls K9: from here on its count must stay 0
    fmb.fused_matmul_bn_fwd.launches = 0
    # the GPT and BERT paths launch no conv kernel: the counts run from here
    # to the end of BERT training
    zero_conv_counts(hc)

    # the GPT paths launch no K4 form: their counts run from here to the
    # end of GPT training
    k4_forms = K4_KERNELS
    for name in k4_forms:
        getattr(hfp, name).launches = 0
    model = GPTForCausalLM(gpt3_1p3b(), device="cuda", dtype=torch.float32,
                           seed=0)
    # the serving paths fail no request: engine.diagnostics stays empty
    checked = checked_engine(ServingEngine)
    f32_serve_launches = phase_serve_f32(torch, np, hfa, model, Request,
                                         checked)
    tiers_f32 = phase_serve_tiers_f32(torch, np, hfa, hfp, hc, fmb, model,
                                      Request, checked, ModelDrafter,
                                      GPTForCausalLM, gpt3_1p3b)
    # the resilience tier on bench.py's overload trace, K1's f32 body
    resilience = phase_serve_resilience(
        torch, np, hfa, model, Request, ServingEngine, ShedPolicy,
        SpillError, register_fire_point, RequestJournal, "f32")
    model = model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    serve_launches, num_blocks = phase_serve_bf16(
        torch, np, hfa, model, Request, checked, GPTForCausalLM,
        gpt_tiny)
    tiers_bf16 = phase_serve_tiers_bf16(
        torch, np, hfa, hfp, hc, fmb, model, Request, checked,
        ModelDrafter, GPTForCausalLM, gpt3_1p3b, smi_line)
    # sampling in generate, then the overload trace in bf16
    phase_generate_sample_bf16(torch, np, hfa, hfp, model)
    resilience.update(phase_serve_resilience(
        torch, np, hfa, model, Request, ServingEngine, ShedPolicy,
        SpillError, register_fire_point, RequestJournal, "bf16"))
    # phase telemetry: the bf16 trace under FLAGS_telemetry off and metrics
    # on this model, then the decode-step A/B
    tel_serve_launches, decode_ab = phase_telemetry_serve(
        torch, np, hfa, hfp, hc, fmb, model, Request, checked, flags, obs,
        num_blocks)
    if profile:
        phase_profile(torch, np, model, Request, checked, num_blocks)
    del model   # the serving engines and their pools are gone with it
    torch.cuda.empty_cache()

    # no training path takes ops.flash_attention's dense route: its count
    # runs from here over each model's paths (serving's CPU dry run of
    # gpt_tiny above takes it, at head dim 32, as it should)
    dense_routes = {}
    tfa.flash_attention.dense_routes = 0
    f32_gpt_launches = phase_train_grad_f32(torch, np, hfa, GPTForCausalLM,
                                            gpt3_1p3b)
    torch.cuda.empty_cache()
    rate0_p50 = {}   # each rate-0 training path's step p50, for beside
    telemetry_launches = {}

    def telemetry_train(step, batches):
        # phase telemetry, on train_bf16's trained step
        telemetry_launches.update(phase_telemetry_train(
            torch, np, hfa, hfp, hc, fmb, step, batches, flags, obs, P,
            make_sharded_train_step, smi_line, tel_serve_launches,
            decode_ab))

    _, train_launches = phase_train_bf16(
        torch, np, hfa, peaks, GPTForCausalLM, gpt3_1p3b, amp, AdamW,
        make_sharded_train_step, profile=profile, rate0_p50=rate0_p50,
        after=telemetry_train)
    gpt_k4 = {name: getattr(hfp, name).launches for name in k4_forms}
    check(all(n == 0 for n in gpt_k4.values()),
          f"the GPT paths launched K4: {gpt_k4}")
    serve_launches.update(gpt_k4)
    train_launches.update(gpt_k4)
    torch.cuda.empty_cache()
    gpt_drop_launches, gpt_drop = phase_train_gpt_dropout_bf16(
        torch, np, hfa, hfp, peaks, GPTForCausalLM, gpt3_1p3b, amp, AdamW,
        make_sharded_train_step, rate0_p50)
    # activation recompute as bench.py's config 4 trains (the default
    # policy, then full recompute), its gradients against no recompute,
    # the SDPA route and AMP O1 in float16 with the imperative loop
    recompute_launches = phase_train_recompute_bf16(
        torch, np, hfa, hfp, peaks, GPTForCausalLM, gpt3_1p3b, amp, AdamW,
        make_sharded_train_step, rate0_p50)
    phase_train_grad_recompute(torch, np, hfa, hfp, GPTForCausalLM,
                               gpt3_1p3b, amp)
    phase_gpt_sdpa_route(torch, np, hfa, hfp, GPTForCausalLM, gpt3_1p3b)
    o1_launches = phase_train_o1_f16(torch, np, hfa, hfp, peaks,
                                     GPTForCausalLM, gpt3_1p3b, amp, AdamW)
    dense_routes["gpt"] = tfa.flash_attention.dense_routes
    tfa.flash_attention.dense_routes = 0
    # K4a-direct's float32 body runs on this path (the bf16 paths take the
    # tensor-core body)
    f32_bert_launches = phase_train_grad_f32_bert(
        torch, np, hfa, hfp, BertForPretraining, bert_base)
    torch.cuda.empty_cache()
    bert_launches = phase_train_bert_bf16(
        torch, np, hfa, hfp, peaks, BertForPretraining, bert_base, amp,
        AdamW, make_sharded_train_step, profile=profile,
        rate0_p50=rate0_p50)
    torch.cuda.empty_cache()
    phase_train_grad_f32_bert(torch, np, hfa, hfp, BertForPretraining,
                              bert_base, attention_dropout=DROP_RATE,
                              phase="train_grad_f32_bert_dropout")
    torch.cuda.empty_cache()
    bert_drop_launches, bert_drop = phase_train_bert_dropout_bf16(
        torch, np, hfa, hfp, peaks, BertForPretraining, bert_base, amp,
        AdamW, make_sharded_train_step, rate0_p50)
    dense_routes["bert"] = tfa.flash_attention.dense_routes
    tfa.flash_attention.dense_routes = 0
    text_conv = conv_counts(hc)
    check(all(n == 0 for n in text_conv.values()),
          f"the GPT and BERT paths launched conv kernels: {text_conv}")
    for launches in (serve_launches, train_launches, bert_launches):
        launches.update(text_conv)
    torch.cuda.empty_cache()

    # bench.py's route for the ResNet A/B (:531-534): both flags on
    flags.set_flags({"fused_conv_bn": 1, "pallas_conv": 1})
    phase_train_grad_f32_resnet(torch, np, hc, resnet50, cross_entropy)
    torch.cuda.empty_cache()
    resnet_launches, resnet_row = phase_train_resnet_bf16(
        torch, np, hc, hfa, hfp, peaks, resnet50, Momentum,
        make_sharded_train_step, profile=profile)
    torch.cuda.empty_cache()
    # the slice's main path: ResNet-50 at config 2 fed from image files
    # through the transforms, DatasetFolder and process workers
    folder_launches = phase_train_resnet_folder_bf16(
        torch, np, P, hc, hfa, hfp, fmb, peaks, resnet50, Momentum,
        make_sharded_train_step, resnet_row)
    torch.cuda.empty_cache()
    # K5's tiles and K7's bands swept into a temporary autotune cache, every
    # candidate held to the plain version, then ResNet-50 with and without
    # the cache in turns
    tuned = phase_tune_conv(torch, np, hc, flags, resnet50, Momentum,
                            make_sharded_train_step)
    torch.cuda.empty_cache()
    # ResNeXt-50 32x4d and Wide ResNet-50-2: the f32 gradients card
    # against CPU, then bench.py's config 2 setting for a few steps
    family = {}
    for fname, factory, phase in (
            ("resnext50_32x4d", resnext50_32x4d, "train_resnext_bf16"),
            ("wide_resnet50_2", wide_resnet50_2, "train_wide_resnet_bf16")):
        phase_train_grad_f32_resnet(torch, np, hc, factory, cross_entropy,
                                    model_name=fname,
                                    phase="train_grad_f32_resnext")
        torch.cuda.empty_cache()
        family[fname], _ = phase_train_resnet_bf16(
            torch, np, hc, hfa, hfp, peaks, factory, Momentum,
            make_sharded_train_step, name=fname, phase=phase, warmup=2,
            timed=3)
        torch.cuda.empty_cache()

    # ERNIE: every earlier path launched none of the streamed K4 kernels
    # (each path's counts are checked above); ERNIE launches no conv kernel
    zero_conv_counts(hc)
    f32_ernie_launches = phase_train_grad_f32_ernie(
        torch, np, hfa, hfp, ernie.ErnieForPretraining, ernie.ernie_base)
    torch.cuda.empty_cache()
    ernie_launches = phase_train_ernie_bf16(
        torch, np, hfa, hfp, hc, peaks, ernie, AdamW,
        make_sharded_train_step, cross_entropy, profile=profile,
        rate0_p50=rate0_p50)
    torch.cuda.empty_cache()
    ernie_drop_launches, ernie_drop = phase_train_ernie_dropout_bf16(
        torch, np, hfa, hfp, peaks, ernie, AdamW, cross_entropy, rate0_p50)
    cross_launches = phase_cross_attention(torch, np, hfa, hfp,
                                           MultiHeadAttention, PF, rng)
    # the float32 bodies of the cross-attention path (dk/dv-direct's is
    # flash_packed_stream.cu's)
    f32_cross_launches = phase_cross_attention(
        torch, np, hfa, hfp, MultiHeadAttention, PF, rng, dt="f32")
    cross_drop_launches = phase_cross_attention(
        torch, np, hfa, hfp, MultiHeadAttention, PF, rng, rate=DROP_RATE)
    dense_routes["resnet_ernie_cross"] = tfa.flash_attention.dense_routes
    emit({"phase": "dense_route_paths", "dense_routes": dense_routes})
    check(not any(dense_routes.values()),
          f"a model path took the dense route: {dense_routes}")
    late_conv = conv_counts(hc)
    check(all(n == 0 for n in late_conv.values()),
          f"the ERNIE paths launched conv kernels: {late_conv}")
    check(fmb.fused_matmul_bn_fwd.launches == 0,
          f"K9 launched outside its path: "
          f"{fmb.fused_matmul_bn_fwd.launches}")
    dropout_launches = {}
    for launches in (gpt_drop_launches, bert_drop_launches,
                     ernie_drop_launches, cross_drop_launches):
        for name, n in launches.items():
            dropout_launches[name] = dropout_launches.get(name, 0) + n
    emit({"phase": "dropout_paths", "rate": DROP_RATE,
          "step_p50_ms": {p["model"]: {"dropout": p["step_p50_ms"],
                                       "rate0": p["rate0_step_p50_ms"]}
                          for p in (gpt_drop, bert_drop, ernie_drop)},
          "bert_rate0_phase_p50_ms": bert_drop["rate0_phase_step_p50_ms"],
          "launches": dropout_launches})
    ernie_launches.update(late_conv)
    cross_launches.update(late_conv)

    # BASELINE config 1 under Model.fit (no TPU kernel on its path), LBFGS,
    # and the two attention entry points that run K1-K3 as no model path
    # does: packed varlen with per-side segment ids, and a differentiable
    # lse
    phase_hapi_lenet(torch, np, P, hfa, hfp)
    torch.cuda.empty_cache()
    phase_lbfgs(torch, np, P)
    worst_varlen, varlen_launches = phase_flash_varlen_lse(
        torch, np, hfa, hfp, tfa, peaks)
    torch.cuda.empty_cache()

    # nn.Transformer at Transformer-base width (K4a-direct and K4b-fused on
    # its training path, the encoder pass of each decode), its decoding
    # with caches and by beam search, and K4 kept by recompute's policy on
    # GPT-3 Medium (the streamed forms)
    t_launches = phase_train_transformer_bf16(
        torch, np, P, hfa, hfp, peaks, amp, AdamW, make_sharded_train_step)
    t_f32_launches, worst_t = phase_train_grad_f32_transformer(
        torch, np, P, hfa, hfp)
    decode_launches = phase_decode_transformer(torch, np, P, hfa, hfp)
    rk4_launches = phase_train_recompute_k4_bf16(
        torch, np, hfa, hfp, peaks, GPTForCausalLM, GPTConfig, amp, AdamW,
        make_sharded_train_step)

    # a Paddle-style script through the port's root, then
    # FLAGS_use_pallas_kernels on and off at GPT-3 1.3B's attention shape
    phase_surface(torch, np, P, hfa, hfp, tfa, PF, flags)
    torch.cuda.empty_cache()

    # Transformer-base through the Layer API (K4a-direct and K4b-fused on
    # its two training steps), every new name of nn/ on the card against
    # the CPU, one model of each new vision file likewise, and
    # MobileNetV3-Large trained in bf16
    layer_api_launches = phase_layer_api(torch, np, P, hfa, hfp, hc, fmb,
                                         AdamW)
    phase_nn_surface(torch, np, P, hfa, hfp, hc, fmb)
    torch.cuda.empty_cache()
    phase_vision_zoo(torch, np, P, hfa, hfp, hc, fmb)
    torch.cuda.empty_cache()
    phase_train_mobilenet_v3_bf16(torch, np, P, hfa, hfp, hc, fmb, peaks,
                                  Momentum, make_sharded_train_step)
    torch.cuda.empty_cache()

    # the detection ops, then fft, signal, audio features and text ops, on
    # the card against the CPU path
    phase_vision_ops(torch, np, P, hfa, hfp, hc, fmb)
    torch.cuda.empty_cache()
    phase_audio_text(torch, np, P, hfa, hfp, hc, fmb)

    # `launches` is the count on each kernel's first main path: serving
    # for K1's bf16 tensor-core body (as the line has counted K1 from the
    # start) and the f32 serving check for its float32 body
    # (`f32_serve_launches`), GPT training for K2/K3's bf16 tensor-core
    # bodies and the f32 GPT gradient check for their CUDA-core bodies
    # (`f32_gpt_launches`), BERT training (all
    # three forms) for K4a-direct's bf16 tensor-core body and K4b, the f32
    # BERT gradient check for K4a-direct's float32 body (`f32_bert_launches`),
    # ResNet training for K5-K8, ERNIE training (all three forms) for the
    # bf16 tensor-core bodies of the streamed forward, dq and dk/dv, the f32
    # ERNIE gradient check for their float32 bodies (`f32_ernie_launches`),
    # cross-attention for dk/dv-direct; every entry
    # also has every path's count (`varlen_launches` and `lse_launches`
    # the flash_varlen_lse phase's two entry points'; K1-K3's tensor-core
    # bodies also `varlen_max_abs_err`, their error there). `max_abs_err` is
    # the largest error of an output element (y, dx, dw, o, dq, ...) against
    # the plain version; `stats_rel_err` that of K5/K7's f32 (sum, sumsq)
    # over their scale (null for the other kernels). `max_err` and
    # `kernel_ms` repeat `max_abs_err` and `ms` under the names the line
    # first used.
    fa = "paddle_tpu/ops/_pallas/flash_attention.py:"
    fp = "paddle_tpu/ops/_pallas/flash_attention_packed.py:"
    fc = "paddle_tpu/ops/_pallas/conv.py:"
    worst["flash_fwd_tc"] = max(worst["flash_fwd_tc"],
                                worst_bwd["flash_fwd_tc"])
    kernels = []
    for name, source, line, t, err, launches in (
            ("flash_fwd_tc", "flash_fwd_tc.cu", fa + "224 (_fwd_kernel, "
             "launched by _fwd at :404; bf16 and float16)",
             timing["flash_fwd_tc"],
             worst["flash_fwd_tc"], serve_launches["flash_fwd_tc"]),
            ("flash_fwd", "flash_fwd.cu", fa + "224 (_fwd_kernel, launched "
             "by _fwd at :404; float32)", timing["flash_fwd"],
             worst["flash_fwd"], f32_serve_launches["flash_fwd"]),
            ("flash_bwd_dq_tc", "flash_bwd_tc.cu", fa + "431 "
             "(_bwd_dq_kernel, launched by _bwd at :628; bf16 and float16 "
             "at D = 64 and 128)", timing_bwd["flash_bwd_dq_tc"],
             worst_bwd["flash_bwd_dq_tc"], train_launches["flash_bwd_dq_tc"]),
            ("flash_bwd_dq", "flash_bwd.cu", fa + "431 (_bwd_dq_kernel, "
             "launched by _bwd at :628; float32, and bf16 and float16 at "
             "D = 256)",
             timing_bwd["flash_bwd_dq"], worst_bwd["flash_bwd_dq"],
             f32_gpt_launches["flash_bwd_dq"]),
            ("flash_bwd_dkv_tc", "flash_bwd_tc.cu", fa + "502 "
             "(_bwd_dkv_kernel, launched by _bwd at :736; bf16 and float16 "
             "at D = 64 and 128)", timing_bwd["flash_bwd_dkv_tc"],
             worst_bwd["flash_bwd_dkv_tc"],
             train_launches["flash_bwd_dkv_tc"]),
            ("flash_bwd_dkv", "flash_bwd.cu", fa + "502 (_bwd_dkv_kernel, "
             "launched by _bwd at :736; float32, and bf16 and float16 at "
             "D = 256)",
             timing_bwd["flash_bwd_dkv"], worst_bwd["flash_bwd_dkv"],
             f32_gpt_launches["flash_bwd_dkv"]),
            ("flash_packed_fwd_tc", "flash_packed_tc.cu", fp + "165 "
             "(_fwd_kernel_direct, launched by _fwd at :238; bf16 and "
             "float16)",
             timing_packed["flash_packed_fwd_tc"],
             worst_packed["flash_packed_fwd_tc"],
             bert_launches["flash_packed_fwd_tc"]),
            ("flash_packed_fwd", "flash_packed.cu", fp + "165 "
             "(_fwd_kernel_direct, launched by _fwd at :238; float32)",
             timing_packed["flash_packed_fwd"],
             worst_packed["flash_packed_fwd"],
             f32_bert_launches["flash_packed_fwd"]),
            ("flash_packed_bwd_tc", "flash_bwd_tc.cu", fp + "448 "
             "(_bwd_fused_kernel, launched by _bwd at :544; bf16 and "
             "float16)", timing_packed["flash_packed_bwd_tc"],
             worst_packed["flash_packed_bwd_tc"],
             bert_launches["flash_packed_bwd_tc"]),
            ("flash_packed_bwd", "flash_packed.cu", fp + "448 "
             "(_bwd_fused_kernel, launched by _bwd at :544; float32)",
             timing_packed["flash_packed_bwd"],
             worst_packed["flash_packed_bwd"],
             f32_bert_launches["flash_packed_bwd"]),
            ("mm", "conv.cu", fc + "142 (_mm_kernel, launched by _mm at "
             ":186; also the 1x1 dgrad at :531)", timing_conv["mm"],
             worst_conv["mm"], resnet_launches["mm"]),
            ("mm_wgrad", "conv.cu", fc + "221 (_mm_wgrad_kernel, launched "
             "by _mm_wgrad at :254)", timing_conv["mm_wgrad"],
             worst_conv["mm_wgrad"], resnet_launches["mm_wgrad"]),
            ("c3", "conv.cu", fc + "311 (_c3_kernel, launched by _c3 at "
             ":364; also the 3x3 dgrad at :554)", timing_conv["c3"],
             worst_conv["c3"], resnet_launches["c3"]),
            ("c3_wgrad", "conv.cu", fc + "401 (_c3_wgrad_kernel, launched "
             "by _c3_wgrad at :441)", timing_conv["c3_wgrad"],
             worst_conv["c3_wgrad"], resnet_launches["c3_wgrad"]),
            ("flash_packed_fwd_stream_tc", "flash_fwd_tc.cu", fp + "102 "
             "(_fwd_kernel, launched by _fwd at :267; bf16 and float16, "
             "K1's body at D = 64)",
             timing_stream["flash_packed_fwd_stream_tc"],
             worst_stream["flash_packed_fwd_stream_tc"],
             ernie_launches["flash_packed_fwd_stream_tc"]),
            ("flash_packed_fwd_stream", "flash_packed_stream.cu", fp + "102 "
             "(_fwd_kernel, launched by _fwd at :267; float32)",
             timing_stream["flash_packed_fwd_stream"],
             worst_stream["flash_packed_fwd_stream"],
             f32_ernie_launches["flash_packed_fwd_stream"]),
            ("flash_packed_bwd_dq_tc", "flash_bwd_tc.cu", fp + "297 "
             "(_bwd_dq_kernel, launched by _bwd at :582; bf16 and "
             "float16)",
             timing_stream["flash_packed_bwd_dq_tc"],
             worst_stream["flash_packed_bwd_dq_tc"],
             ernie_launches["flash_packed_bwd_dq_tc"]),
            ("flash_packed_bwd_dq", "flash_packed_stream.cu", fp + "297 "
             "(_bwd_dq_kernel, launched by _bwd at :582; float32)",
             timing_stream["flash_packed_bwd_dq"],
             worst_stream["flash_packed_bwd_dq"],
             f32_ernie_launches["flash_packed_bwd_dq"]),
            ("flash_packed_bwd_dkv_tc", "flash_bwd_tc.cu", fp + "348 "
             "(_bwd_dkv_kernel, launched by _bwd at :652; bf16 and "
             "float16)",
             timing_stream["flash_packed_bwd_dkv_tc"],
             worst_stream["flash_packed_bwd_dkv_tc"],
             ernie_launches["flash_packed_bwd_dkv_tc"]),
            ("flash_packed_bwd_dkv", "flash_packed_stream.cu", fp + "348 "
             "(_bwd_dkv_kernel, launched by _bwd at :652; float32)",
             timing_stream["flash_packed_bwd_dkv"],
             worst_stream["flash_packed_bwd_dkv"],
             f32_ernie_launches["flash_packed_bwd_dkv"]),
            ("flash_packed_bwd_dkv_direct_tc", "flash_bwd_tc.cu", fp + "407 "
             "(_bwd_dkv_kernel_direct, launched by _bwd at :626; bf16 and "
             "float16, K3's body)",
             timing_stream["flash_packed_bwd_dkv_direct_tc"],
             worst_stream["flash_packed_bwd_dkv_direct_tc"],
             cross_launches["flash_packed_bwd_dkv_direct_tc"]),
            ("flash_packed_bwd_dkv_direct", "flash_packed_stream.cu",
             fp + "407 (_bwd_dkv_kernel_direct, launched by _bwd at :626; "
             "float32)",
             timing_stream["flash_packed_bwd_dkv_direct"],
             worst_stream["flash_packed_bwd_dkv_direct"],
             f32_cross_launches["flash_packed_bwd_dkv_direct"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/_hopper/csrc/" + source,
            "replaces": line, "launches": launches,
            "serve_launches": serve_launches[name],
            "train_launches": train_launches[name],
            "bert_launches": bert_launches[name],
            "resnet_launches": resnet_launches[name],
            "folder_launches": folder_launches[name],
            "ernie_launches": ernie_launches[name],
            "cross_launches": cross_launches[name],
            "f32_bert_launches": f32_bert_launches.get(name, 0),
            "f32_serve_launches": f32_serve_launches.get(name, 0),
            "f32_ernie_launches": f32_ernie_launches.get(name, 0),
            "f32_gpt_launches": f32_gpt_launches.get(name, 0),
            "f32_cross_launches": f32_cross_launches.get(name, 0),
            "recompute_launches": recompute_launches.get(name, 0),
            "o1_f16_launches": o1_launches.get(name, 0),
            "varlen_launches": varlen_launches["varlen"].get(name, 0),
            "lse_launches": varlen_launches["lse"].get(name, 0),
            "tiers_f32_launches": tiers_f32.get(name, 0),
            "tiers_bf16_launches": tiers_bf16.get(name, 0),
            "transformer_launches": t_launches.get(name, 0),
            "layer_api_launches": layer_api_launches.get(name, 0),
            "transformer_f32_launches": t_f32_launches.get(name, 0),
            "decode_launches": decode_launches.get(name, 0),
            "recompute_k4_launches": rk4_launches.get(name, 0),
            "resnext_launches": family["resnext50_32x4d"].get(name, 0),
            "wide_launches": family["wide_resnet50_2"].get(name, 0),
            "resilience_launches": resilience.get(name, 0),
            "telemetry_launches": {
                m: telemetry_launches[m].get(name, 0)
                for m in ("off", "metrics")},
            "max_abs_err": err, "max_err": err,
            "stats_rel_err": stats_conv.get(name),
            "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if "d256_bf16" in t:
            # K2/K3's CUDA-core bodies also in bf16 at head dim 256
            kernels[-1]["d256_bf16"] = {
                k: t["d256_bf16"][k] for k in (
                    "shape", "kernel_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "tflops")}
        if name in timing_f16 or name in worst_f16:
            # float16 (kernel_float16): the largest error against the plain
            # version, and the tensor-core body's time beside bf16's
            kernels[-1]["float16"] = {"max_abs_err": worst_f16.get(name),
                                      **timing_f16.get(name, {})}
        if "stages" in t:
            # K6, K7 and K8 at each of ResNet-50's shapes, beside the body
            # each had before, with the step's sums
            kernels[-1]["stages"] = t["stages"]
        if name in CONV_BODIES:
            kernels[-1]["body"] = CONV_BODIES[name]
            # Wide ResNet-50-2's new shapes (kernel_conv part "wide"): the
            # largest error against the plain version, and K7's forward
            # and K8 at each 3x3 shape beside cuDNN
            kernels[-1]["wide"] = {
                "max_abs_err": worst_wide[name],
                "ms": {shape: row[name] for shape, row in
                       timing_wide.items() if name in row}}
        if name in ("mm", "c3"):
            # tune_conv: each candidate's time at its RESNET50_TOP3_SHAPES
            # shape, the sweep's winner and the plan's own choice
            kernels[-1]["tuned"] = [
                {k_: r[k_] for k_ in ("key", "winner", "winner_ms", "plan",
                                      "plan_ms")} |
                {"candidates_ms": {str(c["choice"]): c["ms"]
                                   for c in r["candidates"]}}
                for r in tuned["shapes"]
                if r["kernel"] == {"mm": "pallas_conv1x1",
                                   "c3": "pallas_conv3x3"}[name]]
        if name == "flash_packed_bwd_dkv_direct_tc":
            # the CUDA-core body in bf16 on the same inputs, the parent's
            # route and now a yardstick
            kernels[-1]["cuda_core_bf16_ms"] = t["cuda_core_bf16_ms"]
        if name == "flash_packed_bwd_tc":
            kernels[-1].update({k: t[k] for k in (
                "cuda_core_bf16_ms", "two_body_ms", "repeat_bit_equal",
                "cluster_blocks")})
        if "train_shape" in t:
            # K1's tensor-core body at the GPT training shape (B=4) too
            kernels[-1]["train_shape"] = {
                k: t["train_shape"][k] for k in (
                    "shape", "kernel_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "tflops")}
        if name in worst_t:
            # K4a-direct and K4b-fused at the Transformer's attention
            # shapes (train_grad_f32_transformer)
            kernels[-1]["transformer_max_abs_err"] = worst_t[name]
        if name in worst_varlen:
            # the packed varlen path against the plain versions
            # (flash_varlen_lse), apart from max_abs_err
            kernels[-1]["varlen_max_abs_err"] = worst_varlen[name]
        if name in worst_masked:
            # segment ids and the key bias (kernel_masked): the largest
            # error against the plain version, the times at B=4 x 2048 with
            # and without each mask set, the masked layer's launches
            kernels[-1].update({
                "masked_max_abs_err": worst_masked[name],
                "masked_ms": {m: t[name] for m, t in timing_masked.items()},
                "masked_launches": masked_launches[name]})
        if name in drop_timing:
            # attention-prob dropout 0.1: the kernel at the timed shape
            # beside rate 0 in turns, its launches on the dropout paths
            # (GPT: K1-K3; BERT: K4a/K4b; ERNIE and cross-attention: the
            # streamed forms, cross-attention dk/dv-direct), and
            # its largest error against the plain version with the mask
            d = drop_timing[name]
            kernels[-1].update({
                "dropout_ms": d["ms_dropout"], "dropout_rate0_ms":
                d["ms_rate0"], "dropout_launches": dropout_launches[name],
                "dropout_max_abs_err": worst_drop[name]})
    kernels.append({
        "name": "fused_matmul_bn_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/_hopper/csrc/conv.cu",
        "replaces": "paddle_tpu/ops/_pallas/fused_matmul_bn.py:36 "
                    "(_fwd_kernel, launched by _fwd at :76); runs K5's "
                    "conv1x1_tc_kernel (bf16, float16; conv1x1_kernel in "
                    "float32) through paddle_fused_matmul_bn_fwd",
        "launches": k9_launches, "k9_path_launches": k9_launches,
        "tiers_f32_launches": tiers_f32["fused_matmul_bn_fwd"],
        "resnext_launches": family["resnext50_32x4d"].get(
            "fused_matmul_bn_fwd", 0),
        "wide_launches": family["wide_resnet50_2"].get(
            "fused_matmul_bn_fwd", 0),
        "resilience_launches": 0,
        "folder_launches": folder_launches["fused_matmul_bn_fwd"],
        "layer_api_launches": layer_api_launches["fused_matmul_bn_fwd"],
        "telemetry_launches": {
            m: telemetry_launches[m].get("fused_matmul_bn_fwd", 0)
            for m in ("off", "metrics")},
        "tiers_bf16_launches": tiers_bf16["fused_matmul_bn_fwd"],
        "max_abs_err": worst_k9, "max_err": worst_k9,
        "stats_rel_err": None,
        "ms": timing_k9["kernel_ms"], "kernel_ms": timing_k9["kernel_ms"],
        "plain_ms": timing_k9["plain_ms"], "bound_ms": timing_k9["bound_ms"],
        "bound_by": timing_k9["bound_by"],
        "library_ms": timing_k9["library_ms"],
        "parent_ms": timing_k9["parent_ms"], "shapes": timing_k9["shapes"],
        "float16": {"max_abs_err": worst_f16.get("fused_matmul_bn_fwd"),
                    **timing_f16.get("fused_matmul_bn_fwd", {})}})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
