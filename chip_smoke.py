#!/usr/bin/env python3
"""Start the PyTorch port (gnn_rag_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every source under gnn_rag_tpu_torch/csrc/ at once
     (gate_scatter.cu and flash_attention.cu with nvcc, graphpath.cpp with
     g++), with ptxas registers and spills, and the wgmma (HGMMA) and TMA
     (UTMALDG) instructions each flash kernel on wgmma must hold
     (SM90_KERNELS), without spills or stack frames, and how many clusters
     of each float32 flash kernel at head dims 128 to 2304 and of each
     bf16 and float16 one at 384 to 4096 the card holds at once
     (cudaOccupancyMaxActiveClusters, none may be 0; past eight blocks
     Hopper's non-portable cluster sizes, also by cluster size 9 to 16),
     with the float32 instance <0>'s at head dims 640-2048, the float32
     192-column-share instances' (<192>, at 2176 and 2304, with each
     block's columns) and the 16-bit cluster kernels' registers, spill and
     stack bytes;
  3. kernel: the CUDA kernel against its plain PyTorch version on the card at
     the serving shapes (fp32 and bf16) and at a skewed layout (SKEWED), two
     launches bit-identical, with the kernel's time ``ms`` (CUDA-event
     medians of back-to-back calls, ``median_ms``: the wrapper's host time
     where that is longer),
     its device time ``device_ms`` (CUDA-graph replays, ``graph_ms``) and
     the plain version's, and the share of its bound that each reaches;
  3b. kernel, backward: the backward kernel against its plain version at
     the same shapes with a random cotangent (dvals, dprior, dins), two
     launches bit-identical, timed and bounded as in 3;
  4. slice: a SynthQSP split (WebQSP-scale subgraphs) served at the headline
     WebQSP ReaRev width (entity_dim 50, num_iter 3, num_ins 2, num_gnn 3,
     MiniLM-width frozen LM, random weights from a seed) through the HTTP
     retrieval server and the Evaluator's `.info` export; the launch count
     proves the forward ran the kernel, and the same batch through the plain
     path must give the same answer distribution; then the request latency
     over a window of LATENCY_PASSES passes through the split: every
     question alone, and every 16-question batch of it; then where a
     retrieve request's time goes (the service's record_function spans
     under torch.profiler) and the B16 forward's device time, kernel count
     and busy share;
  5. train: a 64-question SynthQSP train split trained for 2 epochs (B8,
     8 steps an epoch) at the headline configuration through the port's CLI
     (`python -m gnn_rag_tpu_torch ReaRev ... --device cuda`, run in this
     process), with dev/test evaluation every epoch and the checkpoints; the
     launch counts prove every step ran both kernels; the final checkpoint,
     reloaded by `--is_eval --load_experiment`, reproduces the trained
     model's test answer distribution and writes the `.info`;
  6. grad: every parameter gradient of one B8 batch, the backward kernels
     against the plain backward on one forward of the kernels (1e-4 of the
     largest entry + 1e-7; the two softmax biases, whose gradient is 0, to
     |g| <= 1e-5), and one bf16 training step;
  7. step time: a training step's time over TRAIN_STEPS steps (CUDA events),
     kernel path against plain path, and one step under torch.profiler.
The in-kernel-projection message passing (GNN_RAG_GATE_SCATTER=v2, the
fused-projection kernels K6a-c and scatter_mm K6d):
  3d. kernel-fused: the fused-projection forward and backward (dfact_rel,
     dprior, dins, dW, db) and scatter_mm at C = J*D against their plain
     versions at FUSED_SHAPES and SKEWED (one direction), two forward and
     two backward launches bit-identical, timed as in 3, with
     ``scatter_add_``'s time for the scatter, and each kernel's share of
     its bound;
  7b. v2: the headline configuration with GNN_RAG_GATE_SCATTER=v2 set in
     this process (restored after): one epoch of 8 steps with evaluation
     through the port's CLI, exact launch counts of the fused kernels (2 x
     num_iter x num_gnn a forward and a step) beside TypeLayer's one
     gate-scatter launch; every gradient of a B8 batch kernel vs plain and a
     bf16 step; POST /retrieve served by the trained model, launch counts,
     pred_dist kernel vs plain; a train step's time and device time on the
     v2 and v4 paths.
The other retrievers (NSM, GraftNet) and ReaRev's options:
  7c. kernel-1dir: the gate-scatter forward and backward at one direction
     and J = 1 (NSM's launch: K4f, K4b) against their plain versions at
     NSM_SHAPES (WebQSP serving shape and a skewed layout), two launches
     bit-identical, timed and bounded (ndir 1) as in 3 and 3b;
  7d. retrievers: NSM (entity_dim 50, num_step 3, the backward teacher)
     and GraftNet (num_layer 3, pagerank 0.8, BCE) with the LSTM question
     encoder over a 300-d word table from the seed, on phase 5's split:
     one epoch of 8 B8 steps through the CLI with exact launch counts (NSM
     7 forward a forward: TypeLayer's two-direction launch, 3 steps and 3
     teacher steps of one direction; 6 backward a step, the teacher's last
     step reaching no loss term; GraftNet 1 and 1), the
     reload by `--is_eval`, 16 questions through POST /retrieve from the
     checkpoint (built by the trainer's build_model) against the plain
     path, every gradient, the step time kernel vs plain; then ReaRev's
     options (`--lm lstm --normalized_gnn True --norm_rel`, `--pos_emb`:
     TypeLayer's launch only, `--lm_frozen 0`: the MiniLM-width in-model
     encoder seeded from the frozen one), 4 steps each with launch counts
     and step time, every gradient of the seeded model.
  7e. wide: the widths whose gate-scatter kernels run in column windows
     (a block cannot hold the whole [128, J*D] tile): K1, K2 and K6a-c at
     CWQ's bucket with J 3 and D 128, K4f/K4b at J 1 and D 256 (NSM) and
     TypeLayer's two-direction launch there, against their plain versions
     as in 3, 3b and 3d, two launches bit-identical, K1 also against
     half-width windows bit for bit, timed and bounded; then ReaRev at CWQ's
     command with entity dim 128 (v4 and v2, float32 and bf16) and NSM at
     256 (float32), through the CLI: 3 B8 steps and an evaluation each, exact
     launch counts and no call of a plain version, one batch's loss kernel
     vs plain, every float32 gradient kernel vs plain, ms a step beside each
     kernel's windows.
  The gradient checks (6, 7b, 7d, 7e) hold the backward kernels against
  their plain versions through one forward of the forward kernels, so both
  see the same ReLU masks.
The LLM reader (the flash-attention kernels K5a-c):
  3c. kernel-attn: the flash forward, dq and dk/dv kernels against their
     plain versions at the SFT step's shape (B8 L2047 H32 D128: the loss
     feeds tokens[:, :-1] of 2048, a ragged last tile; bf16 and fp32) and
     at B2 L1000 and B1 L129 (both types), the plain backward fed the
     plain forward's lse; two backward launches bit-identical; CUDA-event
     medians of kernel, plain and SDPA at the SFT shape (bf16: 10 runs of 5
     launches, fp32 5 of 2), each kernel's share of its bound (float32: six
     bf16 tensor-core passes, beside the float-core bound) and its TFLOP/s;
     the same for the bf16 kernels at head dim 256 (Gemma-2B's 8 heads):
     B2 L2047 (the step-time-llm-d256 step's shape) and B8 L2047, timed,
     and B2 L1000, B1 L129; for the float32 kernels at head dim 256
     (clusters of two blocks, one a column half): B2 L2047, timed, B2
     L1000, B1 L129 and B1 L65; and for the float16 kernels (f16_tol) at
     B8 L2047 H32 D128 and B2 L2047 H8 D256, timed with SDPA's float16
     forward and backward, B2 L1000 and B1 L129 at both head dims, the
     backward against the plain backward fed the kernels' own lse and
     delta (the plain forward's: reported), at B2 L1000 also with the
     cotangent x 2^-16 and x 2^4 (F16_G_SCALES); and the bf16 and float16
     kernels at head dims 512 and 384 (the pair kernels: clusters of two
     blocks, each on half of the columns) at B8 L2047 H8, timed, B2 L1000
     (float16 also with the scaled cotangents) and B1 L129; and the
     float32 kernels at head dims 512 and 384 (clusters of four and three
     blocks, each on 128 columns, whose partial scores are added in rank
     order) at B2 L2047 H8, timed, B2 L1000, B1 L129 and B1 L65; and the
     float32 kernels at head dims 1024, 896, 768 and 640 (clusters of eight
     to five blocks) at B2 L2047 H4, timed, B2 L1000, B1 L129 and B1 L65;
     and the bf16 and float16 kernels at head dims 1024, 896, 768 and 640
     (the cluster kernels: four, four, three and three blocks of 192 or
     256 columns) at B8 L2047 H4 (timed, as the float32 rows: the kernels
     take milliseconds), B2 L1000 (float16 at 1024 and 640 also with the
     scaled cotangents), B1 L129 and B1 L65, at 2048 (eight blocks of 256)
     at B8 L2047 H2 (timed), B2 L1000 (float16 also with the scaled
     cotangents), B1 L129 and B1 L65, and at 1152 to 1920 (five to eight
     blocks) at B2 L1000 H2 (timed; float16 at 1408 also with the scaled
     cotangents), held to their plain versions in float64
     (``exact_yardstick``); and the clusters of nine to sixteen blocks: the
     float32 kernels at head dim 2048 (sixteen 128-column blocks) at B2
     L2047 H2 (timed), B1 L129 and B1 L65, at 1664 and 1152 at B2 L1000 H2
     (timed) and 1152 at B1 L129; the bf16 and float16 kernels at 4096
     (sixteen 256-column blocks) at B8 L2047 H1 (timed), B2 L1000 (float16
     also with the scaled cotangents), B1 L129 and B1 L65, at 3968, 3072
     (bf16) and 2176 at B2 L1000 H2 (timed) and 2176 at B1 L129; and the
     float32 kernels on 192-column shares (twelve blocks) at head dim 2304
     at B2 L2047 H1 (timed), B1 L129 and B1 L65, at 2176 at B2 L1000 H1
     (timed) and B1 L129, and on ragged rows of three heads; every
     timed row with its products issued over those the function needs and
     the SDPA backend that served the yardstick;
  8. sft: the RoG joint-finetune SFT (scripts/train_sft.sh) through the
     port's entry (`python -m gnn_rag_tpu_torch.llm.sft`, run in this
     process) at LLaMA2-7B width cut to 4 of 32 layers, random weights from
     the seed: SynthQSP questions in the RoG schema -> preprocess_qa texts
     -> byte tokens packed at 2048 -> 8 steps at B8; the launch counts prove
     every step ran n_layers of each kernel; losses finite and falling; the
     checkpoint reloads to the same parameters and the run resumes from it;
  9. grad (LLM): every parameter gradient of a B2 fp32 batch, kernels vs
     plain attention; at bf16 too, each gradient's kernel-vs-plain distance
     held to the plain bf16 gradient's own distance from the fp32 one;
  10. decode: the trained reader decodes 8 test prompts greedily (kv cache,
     plain attention); at fp32 the cache-free forward (flash kernel) and the
     Decoder's prefill agree on one prompt's last logits;
  10b. qa: the RAG half over the trained retriever and the SFT'd reader (the
     reader saved as a bundle and loaded through the registry,
     ``get_registed_model("llama_tpu")``; depth 4 of 32, byte tokens, 64
     new tokens): POST /answer through ``python -m gnn_rag_tpu_torch.
     serve_qa`` (16 one-question and 4 sixteen-question requests, closed
     loop, p10/p50/p90; the gate-scatter kernel launched there, the flash
     kernels not; prompts within the reader's budget; generate_sentence as
     Decoder.greedy) and one request's stages (retrieve, prompt, prefill,
     decode); the `.info` with ``--info_attention`` (attention rows sum to
     1); ``predict_answers`` over it with the mock reader and with the
     reader in batches of 8, and the "+RA" prompts over ``gen_rule_path``'s
     beam-searched relation paths (16 questions, 3 beams, 32 new tokens);
     one prompt's beams rescored at float32 by a cache-free forward (the
     flash forward kernel): each score x length is the sequence's summed
     log-probs, and the scores come back sorted;
  11. step time (LLM): ms per SFT step, positions/s and non-pad tokens/s,
     kernel path at B8 and plain attention at the largest batch that fits;
     peak memory; one step under torch.profiler (busy share, the flash
     kernels' share);
  11b. step-time-llm-fp32: the SFT step computing in float32 (every
     attention on the float32 flash kernels) at LLaMA2-7B width cut to 4
     layers, B2 x 2048: ms a step over 3 steps after one warm-up, the
     flash launches (4 of each a step), no call of a plain flash version,
     and each flash kernel's device ms in one profiled step;
  11c. step-time-llm-d256: the SFT at Gemma-2B's widths (D256_FLAGS: 8
     heads of 256, one kv head, cut to 6 of 18 layers, vocab 256000, tied,
     bf16) on the repo's LLaMA block through the port's entry (run in this
     process), 3 steps at B2 x 2048: flash launches exact (6 of each a
     step, at head dim 256) and no plain flash call; ms a step, positions/s, peak GB,
     each flash kernel's device ms in a profiled step; a no-cache scoring
     forward of the trained model (K5a) and the first step's loss, each
     against plain attention;
  11d. step-time-llm-d256-fp32: the same SFT computing in float32
     (D256_FP32_FLAGS, cut to 6 of 18 layers) through the port's entry, 3
     steps at B2 x 2048: flash launches exact (6 of each a step: the
     float32 kernels at head dim 256) and no plain flash call, losses
     finite; ms a step, positions/s, peak GB, each float32 <256> kernel's
     device ms and launches in a profiled step; a no-cache scoring
     forward's token log-probs and the first step's loss against plain
     attention (1e-4 of max|plain|; 1e-5 relative), and every parameter
     gradient of a 2-layer model at these widths (1e-4 of the largest
     entry + 1e-7);
  11e. step-time-llm-f16: the SFT computing in float16 (F16_FLAGS:
     LLaMA2-7B width cut to 4 layers, B8 x 2048) through the port's entry,
     F16_STEPS steps: flash launches exact (4 of each a step: the float16
     kernels at head dim 128), no plain flash call, the largest |dO| the
     flash backward received; ms a step, positions/s, peak GB, each float16
     kernel's device ms in a profiled step; the first step's loss and token
     log-probs kernel vs plain attention, and every parameter gradient of a
     B2 batch on a 2-layer model, kernels vs plain (within twice the plain
     float16 path's own distance from float32);
  11f. step-time-llm-d256-f16: the same at Gemma-2B's attention widths
     (D256_F16_FLAGS, cut to 6 of 18 layers, B2 x 2048): the float16
     kernels at head dim 256;
  11g. step-time-llm-d512 and step-time-llm-d512-f16: the same at
     DeepSeek-V4-Flash's attention head shape (D512_FLAGS: LLaMA2-7B's SFT
     cut to 2 layers with 8 heads of 512 and one kv head), in bf16 and in
     float16: the pair kernels at head dim 512, 2 launches of each a step;
     the gradient check also on a 2-layer model at head dim 384 (dim 3072,
     8 heads, one kv head);
  11h. step-time-llm-d512-fp32: the same head shape computing in float32
     (D512_FP32_FLAGS: 2 layers, B2) through the port's entry, as 11d: the
     float32 kernels at head dim 512 (clusters of four blocks), 2 launches
     of each a step, the scoring forward and first loss against plain
     attention, and every gradient of a 2-layer model at head dims 512 and
     384 (clusters of three blocks), kernels vs plain attention;
  11i. step-time-llm-d1024-fp32: the same SFT with 4 heads of 1024 and one
     kv head (D1024_FP32_FLAGS: LLaMA2-7B's 4,096 query columns regrouped,
     cut to 2 layers, B2, float32) through the port's entry, as 11h: the
     float32 kernels at head dim 1024 (clusters of eight blocks), 2
     launches of each a step, and every gradient of a 2-layer model at
     head dims 1024, 896, 768 and 640 (4 heads each), kernels vs plain
     attention;
  11j. step-time-llm-d1024 and step-time-llm-d1024-f16: the same 4 heads
     of 1024 and one kv head in bf16 and in float16 at B8 (D1024_FLAGS,
     D1024_F16_FLAGS: LLaMA2-7B's SFT cut to 2 layers, F16_STEPS steps), as
     11g: the 16-bit kernels at head dim 1024 (clusters of four blocks of
     256 columns), 2 launches of each a step, no plain flash call, the first
     loss and token log-probs kernel vs plain, and every gradient of a
     2-layer model at head dims 1024, 896, 768 and 640 (clusters of four,
     four, three and three blocks), kernels vs plain attention; the float16
     phase also at 2048, 1408 and 1152 (D2048_GRADS: 2 heads, clusters of
     eight, six and five blocks) and at 4096, 3968 and 2176 (D4096_GRADS:
     one head, sixteen, sixteen and nine blocks);
  11k. step-time-llm-d2048: the same query columns as 2 heads of 2048 and
     one kv head in bf16 at B8 (D2048_FLAGS, cut to 2 layers, F16_STEPS
     steps), as 11j: the 16-bit cluster kernels in clusters of eight
     256-column blocks, 2 launches of each a step, no plain flash call, the first loss
     and token log-probs kernel vs plain, every gradient of a 2-layer model
     at head dims 2048, 1408 and 1152;
  11l. step-time-llm-d2048-fp32: the same query columns as 2 heads of 2048
     and one kv head in float32 at B2 (D2048_FP32_FLAGS, 4 layers,
     F16_STEPS steps), as 11i: the float32 kernels (the <0> instance) in
     clusters of sixteen 128-column blocks, 4 launches of each a step, no
     plain flash call, the scoring forward and first loss against plain
     attention, every gradient of a 2-layer model at head dims 2048, 1664
     and 1152 (sixteen, thirteen and nine blocks);
  11m. step-time-llm-d4096: the same query columns as one head of 4096 in
     bf16 at B8 (D4096_FLAGS, 4 layers, F16_STEPS steps), as 11k: the
     16-bit cluster kernels in clusters of sixteen 256-column blocks, 4
     launches of each a step, every gradient of a 2-layer model at head dims
     4096, 3968 and 2176 (the float16 phase 11j runs the same three);
  11n. step-time-llm-d2304-fp32: the SFT at Gemma-2-2B's width (dim 2304,
     intermediate 9216, vocab 256000, tied) with its 2,304 query columns as
     one float32 head of 2304 and one kv head, B2, 2 layers, F16_STEPS
     steps (D2304_FP32_FLAGS), as 11l: the float32 kernels on 192-column
     shares (twelve blocks), 2 launches of each a step, no plain flash
     call, the scoring forward and first loss against plain attention,
     every gradient of a 2-layer model at head dims 2304 and 2176 (one
     head: twelve blocks of 192, ten of 192 and two of 128).
Every phase's wall seconds and the script's total are logged (phase
walls) before the kernels' summary.
The reader at LLaMA2-7B widths and the full 32 layers (after the SFT
trainer is freed):
  12. lora: LoRA finetuning (``llm.lora.LoRATrainer``: r 8, alpha 16 on
     q_proj/v_proj, Adam) with remat, bf16 compute over the float32 base
     from the seed, 4 steps over the SFT phase's B8 x 2048 batches: step ms
     (CUDA events), positions/s, non-pad tokens/s, peak GB; the merge at
     init and the base after the steps bit for bit, the adapters moved,
     the flash launches exact (K5a twice a layer a step, K5b and K5c
     once); at 2 layers, the adapter gradients with remat against without
     (bit for bit) and with the kernels against plain attention;
  13. serve-7b: the same 32-layer reader quantized to int8
     (``llm.quant.quantize_state_dict``): one prompt's logits against full
     precision; 32 greedy tokens at B1 and B8 each way, ms a token beside
     the bytes a token the casts move and their floor, device ms a step;
     ``SpeculativeDecoder`` (gamma 4) with the int8 target and the SFT'd
     4-layer reader as draft, and with the target as its own draft: the
     greedy tokens in float32, in bf16 a flip only at a near tie;
  14. reader-serving: the qa bundle through the registry with ``--quant
     int8 --draft_path`` (a 1-layer draft bundle) against ``--quant int8``
     alone, the OpenAI-protocol server and ``LLMProxy`` over it, and
     ``generate_explanations`` with it as the teacher (16 questions).
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# passes of POST /retrieve through the served split (two took ~50 s on an
# H100 host, four ~70 s: a share of the script's time limit it needs
# elsewhere; one pass is 128 one-question and 8 sixteen-question requests)
LATENCY_PASSES = 1
TRAIN_STEPS = 20
PALLAS = "gnn_rag_tpu/ops/pallas_mp.py"
# the float32 flash kernels' head dims (clusters of D / 128 blocks, 1 to
# 16), the 16-bit ones' in clusters (ceil(D / 256) blocks, 2 to 16, of up
# to 256 columns), the float32 head dims from 640 to 1024 (five to eight
# blocks) and past 1024 (nine to sixteen), the 16-bit cluster kernels' to
# 2048 (640-2048: three to eight blocks of 192 or 256 columns) and past it
# (2176-4096: nine to sixteen); past eight blocks Hopper's non-portable
# cluster sizes
FP32_HEAD_DIMS = tuple(range(128, 2305, 128))
CLUSTER16_HEAD_DIMS = tuple(range(384, 4097, 128))
WIDE_HEAD_DIMS = (640, 768, 896, 1024)
WIDE32_HEAD_DIMS = tuple(range(1152, 2049, 128))
WIDE16_HEAD_DIMS = tuple(range(640, 2049, 128))
CLUSTERS16_HEAD_DIMS = tuple(range(2176, 4097, 128))
# head dims past eight blocks beside the new phases' own: the float32 ones
# its gradient check runs (thirteen and nine blocks), the 16-bit ones the
# gradient checks run (sixteen blocks with shares of 256 and 192 at 3968,
# nine at 2176), and the bf16 ones timed at B2 L1000 H2 (3072, twelve
# blocks of 256, on no path)
D2048_FP32_OTHER = (1664, 1152)
D4096_GRAD_DIMS = (4096, 3968, 2176)
D4096_OTHER = (3968, 3072, 2176)
# the float32 flash kernels' instances: templates on the head dim, <128> to
# <512>, and <0> (SPLIT3_ANY in the source), whose cluster size is a launch
# attribute, for every head dim from 640 to 2048
SPLIT3_INSTANCES = (128, 256, 384, 512, 0)
# the 16-bit cluster kernels' instances: templates on the element type and
# the widest share, 256 columns, each taking every head dim from 640 to 2048
CLUSTER16_CMAX = 256
# the float32 kernels past sixteen 128-column blocks: one instance each, a
# template on the widest share, 192 columns, taking 2176 and 2304 (twelve
# blocks of shares of whole 64-column boxes)
SHARES3_CMAX = 192
SHARES3_HEAD_DIMS = (2176, 2304)
# the flash kernels on wgmma, each with the SASS opcodes it must hold: the
# bf16 and float16 ones load by TMA, the float32 ones (three bf16 terms a
# float, converted by a warpgroup from plain loads) do not (the 16-bit ones
# are templates on the element type and the head dim, the float32 ones on
# the head dim: their instances by mangled name, SPLIT3_INSTANCES; the
# 16-bit ones at 384 and 512 are the pair kernels, clusters of two blocks,
# and from 640 to 4096 the cluster kernels, <T, 256>)
SM90_KERNELS = {**{f"flash_{k}_{kind}_kernelI{t}Li{d}E": ("HGMMA", "UTMALDG")
                   for k in ("fwd", "dq", "dkv")
                   for kind, dims in (("sm90", (128, 256)),
                                      ("pair", (384, 512)),
                                      ("cluster", (CLUSTER16_CMAX,)))
                   for d in dims for t in ("13__nv_bfloat16", "6__half")},
                **{f"flash_{k}_split3_kernelILi{d}E": ("HGMMA",)
                   for k in ("fwd", "dq", "dkv") for d in SPLIT3_INSTANCES},
                **{f"flash_{k}_shares3_kernelILi{SHARES3_CMAX}E": ("HGMMA",)
                   for k in ("fwd", "dq", "dkv")}}
FLASH = "gnn_rag_tpu/llm_tpu/flash_attention.py"
# the card's published peaks (H100 SXM data sheet, dense): float32 outside
# the tensor cores, bf16 and float16 tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# float32 work at float32 accuracy on the tensor cores: six bf16 products a
# product (three bf16 terms a float; the TPU's Precision.HIGHEST, bf16_6x)
FP32_PASSES = 6
HBM_BYTES_PER_S = 3.35e12
# the RoG joint-finetune SFT of scripts/train_sft.sh (batch 8, 2048 tokens)
# at LLaMA2-7B width (LlamaConfig defaults: dim 4096, 32 heads of 128,
# intermediate 11008, vocab 32000, bf16 compute, f32 params), cut to 4 of 32
# layers: f32 params, grads and AdamW states of 32 layers (~108 GB) exceed
# the card; lr 3e-4 as scripts/train_reader.py
SFT_STEPS = 8
SFT_SEQ = 2048
# the float32 SFT step (step-time-llm-fp32): steps timed after one warm-up
FP32_STEPS = 3
SFT_FLAGS = ["--n_layers", "4", "--batch_size", "8",
             "--max_seq_len", str(SFT_SEQ), "--total_steps", str(SFT_STEPS),
             "--learning_rate", "3e-4", "--warmup_steps", "100", "--save_every", str(SFT_STEPS),
             "--seed", str(SEED), "--device", "cuda"]
# LoRA finetuning of the reader at LLaMA2-7B widths and the full 32 layers
# (the reference's peft LoraConfig, joint_finetuning.py:97-106: r 8, alpha
# 16 on q_proj/v_proj), with remat, over the SFT phase's B8 x 2048 batches
LORA_STEPS = 4
LORA_R = 8
LORA_ALPHA = 16.0
# serving the 32-layer reader: new tokens a greedy decode (32, for the
# script's time limit: a token takes ~80 ms of host time there), draft
# tokens a speculative round
SERVE_NEW = 32
# one-question POST /answer requests of the qa phase (then 4 of 16), and
# the questions whose stages it times one by one (the script's time limit)
QA_SINGLE_REQUESTS = 16
QA_STAGE_QUESTIONS = 4
SPEC_GAMMA = 4
# (name, B, L, H, D, dtype) of the flash-kernel checks: the shape the SFT
# step gives the kernels (H32 D128; its loss runs the model on tokens[:, :-1],
# so L is SFT_SEQ - 1 with a ragged last tile) in both types, another L, and
# one row past a 128-row tile (TMA's out-of-bounds rows); then head dim 256
# in bf16 at Gemma-2B's 8 heads: the step-time-llm-d256 step's B2 (and B8)
# L2047, B2 L1000, B1 L129; and in float32 (clusters of two blocks, one a
# column half): the step-time-llm-d256-fp32 step's B2 L2047, B2 L1000, B1
# L129 and B1 L65 (one row past dq's 64-row block); and float16 at both
# head dims, at the shapes of its bf16 rows (the float16 SFT steps' B8
# L2047 H32 D128 and B2 L2047 H8 D256); then the 16-bit kernels at head
# dims 512 and 384 (the pair kernels), at the step-time-llm-d512 step's
# B8 L2047 H8 (DeepSeek-V4-Flash's head shape: heads of 512, one kv head
# repeated to 8) and the same at 384, B2 L1000 and B1 L129, in bf16 and
# float16; and the float32 kernels at head dims 512 and 384 (clusters of
# four and three blocks, one a 128-column slice) at the
# step-time-llm-d512-fp32 step's B2 L2047 H8, B2 L1000, B1 L129 and B1 L65
# (one row past dq's 64-row block); and the float32 kernels at head dims
# 1024, 896, 768 and 640 (clusters of eight to five blocks) at the
# step-time-llm-d1024-fp32 step's B2 L2047 H4 (4 heads of 1024: the same
# operations as H8 D512) and the same ragged rows; and the bf16 and float16
# kernels at head dims 1024, 896, 768 and 640 (clusters of four, four,
# three and three blocks) at the step-time-llm-d1024 steps' B8 L2047 H4 and
# the same ragged rows; at 2048 (eight blocks) at the step-time-llm-d2048
# step's B8 L2047 H2 (the same operations as H4 D1024) and the same ragged
# rows; at 1152 to 1920 (five to eight blocks) at B2 L1000 H2; then the
# clusters of nine to sixteen blocks: float32 at 2048 (sixteen 128-column
# blocks) at the step-time-llm-d2048-fp32 step's B2 L2047 H2 and ragged
# rows, at 1664 and 1152 (thirteen and nine) at B2 L1000 H2 and at 1152 at
# B1 L129; bf16 and float16 at 4096 (sixteen 256-column blocks) at the
# step-time-llm-d4096 step's B8 L2047 H1, B2 L1000 H1 and ragged rows, at
# 3968, 3072 (bf16) and 2176 (shares of 256 and 192, 256 alone, 256 and
# 192: sixteen, twelve and nine blocks) at B2 L1000 H2 and at 2176 at B1
# L129; then float32 at 2304 and 2176 on twelve blocks of 192-column
# shares: 2304 at the step-time-llm-d2304-fp32 step's B2 L2047 H1, on
# ragged rows of three heads (B3 L77 H3: past the forward's 32-key and the
# backward's 16-row tiles), B1 L129 and B1 L65, 2176 at B2 L1000 H1 and B1
# L129. Rows at L 2047 are timed, and TIMED_RAGGED
ATTN_SHAPES = (("sft_b8_l2047_bf16", 8, SFT_SEQ - 1, 32, 128, "bfloat16"),
               ("sft_b8_l2047_fp32", 8, SFT_SEQ - 1, 32, 128, "float32"),
               ("ragged_b2_l1000_bf16", 2, 1000, 32, 128, "bfloat16"),
               ("ragged_b2_l1000_fp32", 2, 1000, 32, 128, "float32"),
               ("ragged_b1_l129_bf16", 1, 129, 32, 128, "bfloat16"),
               ("ragged_b1_l129_fp32", 1, 129, 32, 128, "float32"),
               ("gemma_b2_l2047_d256_bf16", 2, SFT_SEQ - 1, 8, 256, "bfloat16"),
               ("gemma_b8_l2047_d256_bf16", 8, SFT_SEQ - 1, 8, 256, "bfloat16"),
               ("ragged_b2_l1000_d256_bf16", 2, 1000, 8, 256, "bfloat16"),
               ("ragged_b1_l129_d256_bf16", 1, 129, 8, 256, "bfloat16"),
               ("gemma_b2_l2047_d256_fp32", 2, SFT_SEQ - 1, 8, 256, "float32"),
               ("ragged_b2_l1000_d256_fp32", 2, 1000, 8, 256, "float32"),
               ("ragged_b1_l129_d256_fp32", 1, 129, 8, 256, "float32"),
               ("ragged_b1_l65_d256_fp32", 1, 65, 8, 256, "float32"),
               ("sft_b8_l2047_f16", 8, SFT_SEQ - 1, 32, 128, "float16"),
               ("ragged_b2_l1000_f16", 2, 1000, 32, 128, "float16"),
               ("ragged_b1_l129_f16", 1, 129, 32, 128, "float16"),
               ("gemma_b2_l2047_d256_f16", 2, SFT_SEQ - 1, 8, 256, "float16"),
               ("ragged_b2_l1000_d256_f16", 2, 1000, 8, 256, "float16"),
               ("ragged_b1_l129_d256_f16", 1, 129, 8, 256, "float16"),
               *((f"{name}_d{d}_{tag}", B, L, 8, d, dtype)
                 for dtype, tag in (("bfloat16", "bf16"), ("float16", "f16"))
                 for d in (512, 384)
                 for name, B, L in (("dsv4_b8_l2047", 8, SFT_SEQ - 1),
                                    ("ragged_b2_l1000", 2, 1000),
                                    ("ragged_b1_l129", 1, 129))),
               *((f"{name}_d{d}_fp32", B, L, 8, d, "float32")
                 for d in (512, 384)
                 for name, B, L in (("dsv4_b2_l2047", 2, SFT_SEQ - 1),
                                    ("ragged_b2_l1000", 2, 1000),
                                    ("ragged_b1_l129", 1, 129),
                                    ("ragged_b1_l65", 1, 65))),
               *((f"{name}_d{d}_fp32", B, L, 4, d, "float32")
                 for d in WIDE_HEAD_DIMS[::-1]
                 for name, B, L in (("h4_b2_l2047", 2, SFT_SEQ - 1),
                                    ("ragged_b2_l1000", 2, 1000),
                                    ("ragged_b1_l129", 1, 129),
                                    ("ragged_b1_l65", 1, 65))),
               *((f"{name}_d{d}_{tag}", B, L, 4, d, dtype)
                 for dtype, tag in (("bfloat16", "bf16"), ("float16", "f16"))
                 for d in WIDE_HEAD_DIMS[::-1]
                 for name, B, L in (("h4_b8_l2047", 8, SFT_SEQ - 1),
                                    ("ragged_b2_l1000", 2, 1000),
                                    ("ragged_b1_l129", 1, 129),
                                    ("ragged_b1_l65", 1, 65))),
               *((f"{name}_d2048_{tag}", B, L, 2, 2048, dtype)
                 for dtype, tag in (("bfloat16", "bf16"), ("float16", "f16"))
                 for name, B, L in (("h2_b8_l2047", 8, SFT_SEQ - 1),
                                    ("ragged_b2_l1000", 2, 1000),
                                    ("ragged_b1_l129", 1, 129),
                                    ("ragged_b1_l65", 1, 65))),
               *((f"ragged_b2_l1000_d{d}_{tag}", 2, 1000, 2, d, dtype)
                 for dtype, tag in (("bfloat16", "bf16"), ("float16", "f16"))
                 for d in WIDE16_HEAD_DIMS[4:-1]),
               *((f"{name}_d2048_fp32", B, L, 2, 2048, "float32")
                 for name, B, L in (("h2_b2_l2047", 2, SFT_SEQ - 1),
                                    ("ragged_b1_l129", 1, 129),
                                    ("ragged_b1_l65", 1, 65))),
               *((f"ragged_b2_l1000_d{d}_fp32", 2, 1000, 2, d, "float32")
                 for d in D2048_FP32_OTHER),
               ("ragged_b1_l129_d1152_fp32", 1, 129, 2, 1152, "float32"),
               *((f"{name}_d4096_{tag}", B, L, 1, 4096, dtype)
                 for dtype, tag in (("bfloat16", "bf16"), ("float16", "f16"))
                 for name, B, L in (("h1_b8_l2047", 8, SFT_SEQ - 1),
                                    ("ragged_b2_l1000", 2, 1000),
                                    ("ragged_b1_l129", 1, 129),
                                    ("ragged_b1_l65", 1, 65))),
               *((f"ragged_b2_l1000_d{d}_{tag}", 2, 1000, 2, d, dtype)
                 for dtype, tag, dims in (
                     ("bfloat16", "bf16", D4096_OTHER),
                     ("float16", "f16", D4096_GRAD_DIMS[1:]))
                 for d in dims),
               *((f"ragged_b1_l129_d2176_{tag}", 1, 129, 2, 2176, dtype)
                 for dtype, tag in (("bfloat16", "bf16"),
                                    ("float16", "f16"))),
               *((f"{name}_d2304_fp32", B, L, H, 2304, "float32")
                 for name, B, L, H in (("gemma2_b2_l2047", 2, SFT_SEQ - 1, 1),
                                       ("ragged_b3_l77_h3", 3, 77, 3),
                                       ("ragged_b1_l129", 1, 129, 1),
                                       ("ragged_b1_l65", 1, 65, 1))),
               *((f"{name}_d2176_fp32", B, L, 1, 2176, "float32")
                 for name, B, L in (("ragged_b2_l1000", 2, 1000),
                                    ("ragged_b1_l129", 1, 129))))
# median_ms of the plain flash versions in check_attn_kernels (the timed
# rows' plain calls take 1-55 ms each; three runs for the script's time
# limit)
PLAIN_TIMING = dict(runs=3, reps=2, warmup=1)
# the rows timed besides those at L 2047: the 16-bit head dims 1152 to
# 1920 and 2176 to 3968, float32's 1152 and 1664, each at its ragged B2
# L1000 H2 row only, and float32's 2176 at B2 L1000 H1
TIMED_RAGGED = {*(f"ragged_b2_l1000_d{d}_{tag}" for d in WIDE16_HEAD_DIMS[4:-1]
                  for tag in ("bf16", "f16")),
                *(f"ragged_b2_l1000_d{d}_fp32" for d in D2048_FP32_OTHER),
                *(f"ragged_b2_l1000_d{d}_bf16" for d in D4096_OTHER),
                *(f"ragged_b2_l1000_d{d}_f16" for d in D4096_GRAD_DIMS[1:]),
                "ragged_b2_l1000_d2176_fp32"}
# the float16 rows whose backward also runs with the cotangent scaled: far
# under float16's normal range (an unscaled split of ds would round it to
# 0) and large
F16_G_SCALES = {name: (2.0 ** -16, 2.0 ** 4) for name in (
    "ragged_b2_l1000_f16", "ragged_b2_l1000_d256_f16",
    "ragged_b2_l1000_d512_f16", "ragged_b2_l1000_d384_f16",
    "ragged_b2_l1000_d1024_f16", "ragged_b2_l1000_d640_f16",
    "ragged_b2_l1000_d2048_f16", "ragged_b2_l1000_d1408_f16",
    "ragged_b2_l1000_d4096_f16")}
# the SFT step at Gemma-2B's widths (google/gemma-2b config.json: hidden
# 2048, 8 heads of 256, one kv head, intermediate 16384, 18 layers, vocab
# 256000, tied embeddings) on the repo's LLaMA block (SwiGLU, RMSNorm,
# rotate-half RoPE; Gemma's GeGLU, 1 + w norm and embedding scale are in
# neither package), bf16 compute over f32 params, grads and AdamW, B2 x
# 2048, cut to 6 of 18 layers to spare the run's time limit (at 18, ~2.5 B
# parameters, ~40 GB, a peak of ~58 GB): the flash kernels at head dim 256
# (the kv head repeated to H8)
D256_STEPS = 3          # steps through the entry point
D256_TIMED = 2          # then steps timed on the first step's batch
D256_LAYERS = 6
D256_FLAGS = ["--dim", "2048", "--n_heads", "8", "--n_kv_heads", "1",
              "--intermediate", "16384", "--n_layers", str(D256_LAYERS),
              "--vocab_size", "256000", "--tie_embeddings", "true",
              "--dtype", "bfloat16", "--batch_size", "2", "--max_seq_len", str(SFT_SEQ),
              "--total_steps", str(D256_STEPS), "--learning_rate", "3e-4",
              "--warmup_steps", "100", "--save_every", str(D256_STEPS),
              "--seed", str(SEED), "--device", "cuda"]
# the same SFT computing in float32 (every attention on the float32 flash
# kernels at head dim 256), 6 of 18 layers: at 18, the float32
# params, grads and AdamW moments of 2.51 B parameters take 40 GB and the
# float32 activations of B2 x 2048 double the bf16 run's (its peak is 58
# GB); at 6, 1.18 B parameters take 19 GB of state
D256_FP32_LAYERS = 6
D256_FP32_FLAGS = [{"--n_layers": str(D256_FP32_LAYERS),
                    "--dtype": "float32"}.get(flag, x)
                   for flag, x in zip([None, *D256_FLAGS], D256_FLAGS)]
# the SFT computing in float16 (LLaMA-2-7B's published weights are float16;
# the reference's HF readers default to --dtype fp16), every attention on
# the float16 flash kernels: at LLaMA2-7B width cut to 4 of 32 layers as the
# bf16 SFT phase is (B8 x 2048), and at Gemma-2B's attention widths cut to
# 6 of 18 layers (B2 x 2048) to spare the run's time limit; F16_STEPS steps
# through the entry point each, then D256_TIMED timed and one profiled
F16_STEPS = 3
F16_FLAGS = [{"--total_steps": str(F16_STEPS),
              "--save_every": str(F16_STEPS)}.get(flag, x)
             for flag, x in zip([None, *SFT_FLAGS], SFT_FLAGS)
             ] + ["--dtype", "float16"]
D256_F16_LAYERS = 6
D256_F16_FLAGS = [{"--n_layers": str(D256_F16_LAYERS),
                   "--dtype": "float16"}.get(flag, x)
                  for flag, x in zip([None, *D256_FLAGS], D256_FLAGS)]
# layers of the float16 phases' gradient check (B2, kernels vs plain)
F16_GRAD_LAYERS = 2
# the SFT at DeepSeek-V4-Flash's attention head shape (deepseek-ai/
# DeepSeek-V4-Flash config.json: head_dim 512, num_key_value_heads 1) on
# LLaMA2-7B's SFT (SFT_FLAGS: dim 4096, intermediate 11008, vocab 32000, B8
# x 2048, cut to 4 of 32 layers) with 8 heads: the repo's block ties the
# head dim to dim / heads, so DeepSeek's 64 query heads become 8 (its MoE,
# sparse attention and sliding window are in neither package); F16_STEPS
# steps in bf16, then in float16, cut to 2 layers for the script's time
# limit. Its gradient check also runs a model at head dim 384 (dim 3072, 8
# heads, one kv head)
D512_FLAGS = [{"--n_layers": "2"}.get(flag, x)
              for flag, x in zip([None, *F16_FLAGS[:-2]], F16_FLAGS[:-2])
              ] + ["--n_heads", "8", "--n_kv_heads", "1", "--dtype",
                   "bfloat16"]
D512_F16_FLAGS = D512_FLAGS[:-2] + ["--dtype", "float16"]
D384_GRAD = dict(dim=3072, n_heads=8, n_kv_heads=1)
# the same head shape computing in float32 (the float32 kernels at head dim
# 512, clusters of four blocks), at B2 as the float32 LLaMA2-7B-width step
# runs, 2 layers as D512_FLAGS (at 4, ~0.95 B parameters take ~15 GB of
# float32 state)
D512_FP32_FLAGS = [{"--dtype": "float32", "--batch_size": "2"}.get(flag, x)
                   for flag, x in zip([None, *D512_FLAGS], D512_FLAGS)]
# LLaMA2-7B's SFT at its widths (dim 4096, intermediate 11008, vocab 32000,
# B2 x 2048, float32, as D512_FP32_FLAGS) with its 4,096
# query columns regrouped as 4 heads of 1024 and one kv head: no published
# configuration has heads of 640-1024, and the JAX reader sends them to its
# Pallas kernels; the float32 kernels at head dim 1024, clusters of eight
# blocks; cut to 2 layers for the script's time limit (the
# step-time-llm-d2048-fp32 phase keeps 4). Its gradient check also runs
# 2-layer models at head dims 896, 768 and 640 (4 heads, one kv head each)
D1024_FP32_FLAGS = [{"--n_heads": "4", "--n_layers": "2"}.get(flag, x)
                    for flag, x in zip([None, *D512_FP32_FLAGS],
                                       D512_FP32_FLAGS)]
WIDE_GRADS = tuple(dict(dim=4 * d, n_heads=4, n_kv_heads=1)
                   for d in (896, 768, 640))
# the same 4 heads of 1024 and one kv head in bf16 (LlamaConfig's type, in
# which scripts/train_sft.sh trains) and in float16 (LLaMA-2-7B's published
# type) at B8, F16_STEPS steps each, cut to 2 layers for the script's time
# limit (the step-time-llm-d2048 phase keeps 4):
# the 16-bit kernels at head dim 1024 (clusters of four 256-column
# blocks); the gradient checks also at 896, 768 and 640 (WIDE_GRADS:
# clusters of four, three and three blocks)
D1024_FLAGS = [{"--n_heads": "4", "--n_layers": "2"}.get(flag, x)
               for flag, x in zip([None, *D512_FLAGS], D512_FLAGS)]
D1024_F16_FLAGS = D1024_FLAGS[:-2] + ["--dtype", "float16"]
# the same query columns as 2 heads of 2048 and one kv head, bf16, B8,
# F16_STEPS steps, cut to 2 layers for the script's time limit (the
# step-time-llm-d4096 phase keeps 4): the 16-bit cluster kernels in
# clusters of eight 256-column blocks; its gradient check also at 1408 and
# 1152 (2 heads: clusters of six and five blocks, shares of 256 and 192
# columns). Float16 runs the three gradient checks in the
# step-time-llm-d1024-f16 phase (D2048_GRADS), not a step phase of its own:
# the script's time limit
D2048_FLAGS = [{"--n_heads": "2", "--n_layers": "2"}.get(flag, x)
               for flag, x in zip([None, *D512_FLAGS], D512_FLAGS)]
D2048_GRADS = tuple(dict(dim=2 * d, n_heads=2, n_kv_heads=1)
                    for d in (2048, 1408, 1152))
# the clusters of nine to sixteen blocks, on LLaMA2-7B's SFT at its widths:
# its 4,096 query columns as 2 heads of 2048 and one kv head in float32
# (D512_FP32_FLAGS' run, B2, 4 layers, F16_STEPS steps: the float32 kernels
# in clusters of sixteen 128-column blocks), the gradient check also at
# 1664 and 1152 (2 heads: thirteen and nine blocks); and as one head of
# 4096 in bf16 (D512_FLAGS' run, B8, 4 layers, F16_STEPS steps: the 16-bit
# cluster kernels in clusters of sixteen 256-column blocks), the gradient
# check also at 3968 and 2176 (one head: sixteen and nine blocks, shares of
# 256 and 192). Float16 runs the three gradient checks at 4096, 3968 and
# 2176 in the step-time-llm-d1024-f16 phase (D4096_GRADS), not a step phase
# of its own: the script's time limit
D2048_FP32_FLAGS = [{"--n_heads": "2", "--n_layers": "4"}.get(flag, x)
                    for flag, x in zip([None, *D512_FP32_FLAGS],
                                       D512_FP32_FLAGS)]
D2048_FP32_GRADS = tuple(dict(dim=2 * d, n_heads=2, n_kv_heads=1)
                         for d in D2048_FP32_OTHER)
# float32 past sixteen 128-column blocks, at Gemma-2-2B's width
# (google/gemma-2-2b config.json: hidden 2304, intermediate 9216, vocab
# 256000, tied embeddings; 8 heads of 256 and 4 kv heads there) with its
# 2,304 query columns as one head of 2304 and one kv head (no published
# configuration has heads of 2176 or 2304; the JAX reader sends them to its
# Pallas kernels, as the 1024-4096 heads of the phases above), on the
# repo's LLaMA block, float32, B2, F16_STEPS steps, cut to 2 of 26 layers
# (the float32 state of 2 layers and the 590 M-parameter tied embedding is
# ~12 GB): the float32 kernels on twelve blocks of 192-column shares; the
# gradient check also at 2176 (one head: ten blocks of 192, two of 128)
D2304_FP32_FLAGS = [{"--dim": "2304", "--n_heads": "1", "--n_kv_heads": "1",
                     "--intermediate": "9216", "--n_layers": "2",
                     "--dtype": "float32"}.get(flag, x)
                    for flag, x in zip([None, *D256_FLAGS], D256_FLAGS)]
D2304_FP32_GRADS = (dict(dim=2176, n_heads=1, n_kv_heads=1),)
D4096_FLAGS = [{"--n_heads": "1", "--n_layers": "4"}.get(flag, x)
               for flag, x in zip([None, *D512_FLAGS], D512_FLAGS)]
D4096_GRADS = tuple(dict(dim=d, n_heads=1, n_kv_heads=1)
                    for d in D4096_GRAD_DIMS)
# scripts/rearev_webqsp.sh with the reference's training defaults
HEADLINE_FLAGS = ["ReaRev", "--entity_dim", "50", "--num_iter", "3",
                  "--num_ins", "2", "--num_gnn", "3", "--lm", "sbert",
                  "--relation_word_emb", "True", "--batch_size", "8",
                  "--test_batch_size", "16", "--linear_dropout", "0.2",
                  "--lr", "5e-4", "--gradient_clip", "1.0",
                  "--seed", str(SEED), "--device", "cuda"]
# biases that feed only a softmax over entities or question tokens: the
# softmax is shift invariant, so their gradient is 0 up to rounding, and the
# noise (1e-7 to 3e-7; it varies run to run, as other gradients sum with
# atomics) is compared with nothing; the gradient check holds them to
# |g| <= 1e-5 on both paths
SOFTMAX_BIASES = ("reasoning.score_func.bias",
                  "instruction_decoder.ca_linear.bias")
# (name, B, E, F bucket, J, D, dtype, apply_relu): the shapes the serving
# path gives the kernel — WebQSP and CWQ serving buckets, the huge-E bucket
# the TPU needed a per-instruction tier for, and TypeLayer's J=1 call
KERNEL_SHAPES = (
    ("webqsp_fp32", 16, 2048, 8192, 2, 50, "float32", True),
    ("webqsp_bf16", 16, 2048, 8192, 2, 50, "bfloat16", True),
    ("cwq_fp32", 8, 4096, 16384, 3, 50, "float32", True),
    ("huge_e_fp32", 4, 8192, 32768, 3, 50, "float32", True),
    ("type_layer_fp32", 16, 2048, 8192, 1, 50, "float32", False),
)
# the KERNEL_SHAPES rows the fused-projection kernels and scatter_mm are
# checked and timed at (one direction of each)
FUSED_SHAPES = ("webqsp_fp32", "webqsp_bf16", "cwq_fp32")
# and a skewed layout at WebQSP widths, where every gate-scatter kernel is
# also checked and timed: a few tiles hold most chunks, as the hub entities
# of SynthQSP's (and WebQSP's) subgraphs make them
SKEWED = ("webqsp_skewed_fp32", 16, 2048, 8192, 2, 50, "float32", True)
# NSM's one-direction J = 1 launch (K4f / K4b) at the WebQSP serving shape,
# and at a skewed layout
NSM_SHAPES = (("nsm_fp32", 16, 2048, 8192, 1, 50, "float32", True),
              ("nsm_skewed_fp32", 16, 2048, 8192, 1, 50, "float32", True))
# the JAX CLI's other retrievers at their own defaults
# (gnn_rag_tpu/cli.py:44-46, 100-121): NSM with the backward teacher on,
# GraftNet with BCE; the LSTM question encoder over a 300-d frozen word
# table (word_emb.npy, random from the seed: no GloVe file on the machine)
TRAIN_FLAGS = ["--batch_size", "8", "--test_batch_size", "16",
               "--linear_dropout", "0.2", "--lr", "5e-4", "--gradient_clip",
               "1.0", "--seed", str(SEED), "--device", "cuda"]
RETRIEVERS = {
    "nsm": ["NSM", "--entity_dim", "50", "--num_step", "3", "--lm", "lstm",
            "--word_dim", "300", "--lambda_back", "0.1",
            "--lambda_constrain", "0.1", "--eval_every", "1"] + TRAIN_FLAGS,
    "graftnet": ["GraftNet", "--entity_dim", "50", "--num_layer", "3",
                 "--pagerank_lambda", "0.8", "--loss_type", "bce", "--lm",
                 "lstm", "--word_dim", "300", "--eval_every", "1"] + TRAIN_FLAGS,
}
# the widths whose gate-scatter kernels take column windows (a block cannot
# hold the [128, J*D] tile of every kernel): CWQ's ReaRev command
# (scripts/rearev_cwq.sh: num_iter 2, num_ins 3, num_gnn 3, batch 8) at
# entity dim 128 (K2, K6a/b and K6c in two 64-column windows), and NSM at
# 256 (K4b and TypeLayer's K2 in two 128-column windows in float32); each
# WIDE_TRAIN questions (3 B8 steps) and one evaluation, then ms a step
WIDE_REAREV = ["ReaRev", "--entity_dim", "128", "--num_iter", "2",
               "--num_ins", "3", "--num_gnn", "3", "--lm", "sbert",
               "--relation_word_emb", "True"] + TRAIN_FLAGS
WIDE_NSM = ["NSM", "--entity_dim", "256", "--num_step", "3", "--lm", "lstm",
            "--word_dim", "300", "--lambda_back", "0.1",
            "--lambda_constrain", "0.1"] + TRAIN_FLAGS
WIDE_TRAIN = 24
# (name, B, E, F bucket, J, D, dtype, apply_relu, directions) of the
# windowed kernel checks: the CWQ bucket at J 3, D 128 (both directions,
# and one direction of the fused kernels), NSM's one-direction J 1 launch
# and TypeLayer's two-direction one at D 256
WIDE_SHAPES = (
    ("cwq_d128_fp32", 8, 4096, 16384, 3, 128, "float32", True, 2),
    ("cwq_d128_bf16", 8, 4096, 16384, 3, 128, "bfloat16", True, 2),
    ("nsm_d256_fp32", 8, 4096, 16384, 1, 256, "float32", True, 1),
    ("type_layer_d256_fp32", 8, 4096, 16384, 1, 256, "float32", False, 2),
)
# ReaRev's options at the headline width, 4 steps each (32 questions)
REAREV_OPTIONS = {
    "lstm_normalized_norm_rel": ["--lm", "lstm", "--word_dim", "300",
                                 "--normalized_gnn", "True", "--norm_rel"],
    "pos_emb": ["--pos_emb"],
    "lm_frozen0": ["--lm_frozen", "0"],
}
# the kernels of csrc/gate_scatter.cu, as the profiler names them
GATE_KERNEL_NAMES = ("gate_fwd_kernel", "tile_sum_kernel",
                     "gate_scatter_bwd_kernel", "fused_fwd_kernel",
                     "fused_bwd_kernel", "part_reduce_kernel")
# the gate-scatter launch counters of ops.gate_scatter
GATE_COUNTERS = ("launches", "bwd_launches", "fused_launches",
                 "fused_bwd_launches", "scatter_launches")


def log(phase, msg):
    print(f"chip_smoke [{phase}] {msg}", flush=True)


def median_ms(fn, runs=20, reps=10, warmup=3, out=None):
    """Median over ``runs`` of the device time per call, each run timing
    ``reps`` back-to-back calls between two CUDA events (each run's time a
    call appended to the list ``out``, where one is given)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    if out is not None:
        out.extend(times)
    return sorted(times)[len(times) // 2]


def graph_ms(fn, runs=20, reps=10, warmup=3):
    """Median over ``runs`` of the device time per call, each run replaying
    a CUDA graph of ``reps`` captured calls between two CUDA events: the
    kernels' time without the host's, which ``median_ms`` also measures
    when a call's Python wrapper takes longer than its kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[len(times) // 2]


def kernel_inputs(B, E, F, J, D, dtype, apply_relu, device, rng, skew=False):
    """Random subgraphs of ~0.75E entities and ~0.8F facts per sample, laid
    out by the port's loader code, and gate inputs on the device. ``skew``:
    each fact's target drawn as ne * u^4 (u uniform), so the first tile
    takes about half of the facts and a few tiles most of them."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.data.kernel_layout import (TILE_E, TILE_F,
                                                      build_sample_direction,
                                                      pack_samples)
    fwd, inv = [], []
    for _ in range(B):
        ne, nf = int(0.75 * E), int(0.8 * F)
        h = rng.integers(0, ne, nf).astype(np.int32)
        t = rng.integers(0, ne, nf).astype(np.int32)
        if skew:
            t = (ne * rng.random(nf) ** 4).astype(np.int32)
        r = rng.integers(0, 200, nf).astype(np.int32)
        w = np.ones(nf, np.float32)
        fwd.append(build_sample_direction(t, h, r, w, E, 200))
        inv.append(build_sample_direction(h, t, r, w, E, 200))
    nc = -(-(F // TILE_F + E // TILE_E) // 8) * 8
    kl = pack_samples(fwd, inv, E, 200, num_chunks=nc)
    Fp = nc * TILE_F
    dt = getattr(torch, dtype)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    scatter = dev(np.stack([kl.fwd.scatter, kl.inv.scatter]))
    valid = (scatter >= 0).float()
    gen = torch.Generator(device=device).manual_seed(SEED)
    vals = torch.randn((2, B, Fp, D), generator=gen, device=device).to(dt)
    ins = (torch.ones((B, J, D), device=device) if not apply_relu else
           torch.randn((B, J, D), generator=gen, device=device)).to(dt)
    prior = torch.rand((2, B, Fp), generator=gen, device=device) * valid
    starts = dev(np.stack([kl.fwd.chunk_starts, kl.inv.chunk_starts]))
    # one tensor per direction, as the model passes them
    return (vals.unbind(0), ins, prior.unbind(0), scatter.unbind(0),
            starts.unbind(0), apply_relu)


def with_share(row, backward, **kw):
    """``row`` with the bound of its launch (``gate_bound``) and the share
    of it that the kernel's time and its device time reach."""
    row["bound_ms"], row["bound_by"] = gate_bound(row, backward, **kw)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
    return row


def check_kernels(device):
    """Phase 3: kernel vs plain at every serving shape and at SKEWED, two
    launches bit-identical; returns rows."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    rng = np.random.default_rng(SEED)
    rows = []
    for name, B, E, F, J, D, dtype, relu in KERNEL_SHAPES + (SKEWED,):
        args = kernel_inputs(B, E, F, J, D, dtype, relu, device, rng,
                             skew=name == SKEWED[0])
        got = gs.gate_scatter_fwd(*args)
        repeat = torch.equal(got, gs.gate_scatter_fwd(*args))
        torch.cuda.synchronize()
        want = gs.gate_scatter_fwd_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        rel_tol = 1e-5 if dtype == "float32" else 2e-2
        ok = (bool(torch.isfinite(got).all()) and err <= rel_tol * ref
              and repeat)
        ms = median_ms(lambda: gs.gate_scatter_fwd(*args))
        device_ms = graph_ms(lambda: gs.gate_scatter_fwd(*args))
        plain_ms = median_ms(lambda: gs.gate_scatter_fwd_plain(*args))
        row = with_share(dict(
            shape=name, B=B, E=E, Fp=args[0][0].shape[1], J=J, D=D,
            dtype=dtype, relu=relu, max_abs_err=err, max_abs_ref=ref,
            tol=rel_tol * ref, bit_identical_repeat=repeat, ms=ms,
            device_ms=device_ms, plain_ms=plain_ms), False)
        log("kernel", json.dumps(row))
        if not ok:
            raise AssertionError(f"kernel disagrees with plain at {name}: "
                                 f"max|d|={err} > {rel_tol}*{ref}, or a "
                                 f"repeat differs ({repeat})")
        rows.append(row)
        del args, got, want
    return rows


def check_bwd_kernels(device):
    """Phase 3b: backward kernel vs plain at every shape and at SKEWED;
    returns rows."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = []
    for name, B, E, F, J, D, dtype, relu in KERNEL_SHAPES + (SKEWED,):
        vals, ins, prior, scatter, starts, _ = kernel_inputs(
            B, E, F, J, D, dtype, relu, device, rng, skew=name == SKEWED[0])
        g = torch.randn((2, B, E, J * D), generator=gen, device=device)
        args = (vals, ins, prior, scatter, starts, g, relu)
        got = gs.gate_scatter_bwd(*args)
        again = gs.gate_scatter_bwd(*args)
        torch.cuda.synchronize()
        want = gs.gate_scatter_bwd_plain(*args)
        torch.cuda.synchronize()
        rel_tol = 1e-5 if dtype == "float32" else 2e-2
        parts = {}
        for part, a, b in zip(("dvals_f", "dvals_i", "dprior_f", "dprior_i",
                               "dins"), (*got[0], *got[1], got[2]),
                              (*want[0], *want[1], want[2])):
            err = (a.float() - b.float()).abs().max().item()
            ref = b.float().abs().max().item()
            if not (a.dtype == b.dtype and torch.isfinite(a).all()
                    and err <= rel_tol * ref):
                raise AssertionError(f"bwd kernel disagrees with plain at "
                                     f"{name} {part}: max|d|={err} > "
                                     f"{rel_tol}*{ref}")
            parts[part] = [err, ref]
        repeat = all(torch.equal(a, b) for a, b in zip(
            (*got[0], *got[1], got[2]), (*again[0], *again[1], again[2])))
        if not repeat:
            raise AssertionError(f"bwd kernel not deterministic at {name}")
        ms = median_ms(lambda: gs.gate_scatter_bwd(*args))
        device_ms = graph_ms(lambda: gs.gate_scatter_bwd(*args))
        plain_ms = median_ms(lambda: gs.gate_scatter_bwd_plain(*args))
        row = with_share(dict(
            shape=name, B=B, E=E, Fp=vals[0].shape[1], J=J, D=D,
            dtype=dtype, relu=relu,
            max_abs_err=max(e for e, _ in parts.values()),
            err_ref_by_output=parts, bit_identical_repeat=repeat,
            ms=ms, device_ms=device_ms, plain_ms=plain_ms), True)
        log("kernel-bwd", json.dumps(row))
        rows.append(row)
        del args, got, again, want
    return rows


def chunk_tiles_of(starts, nc):
    """A layout's chunk_tiles [B, nc] from its chunk_starts [B, n_tiles+1]:
    chunk c's tile is the number of tile ranges that end at or before c,
    the padding chunks past the last range repeating the last tile."""
    import torch
    B, n_tiles = starts.shape[0], starts.shape[1] - 1
    c = torch.arange(nc, device=starts.device, dtype=torch.int32)
    tiles = torch.searchsorted(starts[:, 1:].contiguous(),
                               c.expand(B, nc).contiguous(), right=True)
    return tiles.clamp_max(n_tiles - 1).to(torch.int32)


def fused_rules(dtype):
    """check_fused_kernels' tolerance of each fused-projection output: a
    share of max|ref|, or (bf16 steps,) per element (``bf16_tol``)."""
    rules = dict(fwd=1e-5, dfact_rel=1e-4, dw=1e-4, db=1e-4, dins=1e-4,
                 dprior=1e-4)
    if dtype == "bfloat16":
        rules.update(fwd=(2,), dfact_rel=(1,), dw=(1,), db=(1,), dins=(1,))
    return rules


def fused_errors(rules, got, want, name, bad):
    """{output: [max|d|, max|ref|, max|d| over its tolerance]} of ``got``
    against ``want``, in the order of ``rules`` (``fused_rules``); each
    output off its tolerance, its type, or not finite goes into ``bad``."""
    import torch
    errs = {}
    for (part, rule), a, r in zip(rules.items(), got, want):
        d = (a.float() - r.float()).abs()
        ref = r.float().abs().max()
        tol = bf16_tol(r, *rule) if isinstance(rule, tuple) else rule * ref
        over = d.div(tol).nan_to_num(nan=0.0).max().item()
        errs[part] = [d.max().item(), ref.item(), over]
        if not (a.dtype == r.dtype and torch.isfinite(a).all() and over <= 1.0):
            bad.append(f"{name} {part}: max|d| {d.max().item()} is {over} of "
                       f"its tolerance")
    return errs


def check_fused_kernels(device):
    """Phase 3d: the fused-projection forward and backward kernels and
    scatter_mm against their plain versions at FUSED_SHAPES, one direction
    of each row: fp32 forward 1e-5 of max|ref|, backward 1e-4 of max|ref|
    on dfact_rel, dw, db, dins and dprior (dW and db sum every fact of the
    batch in another order), scatter_mm 1e-5 (float sums of the same
    values). bf16 inputs, per element (``bf16_tol``): the forward two bf16
    steps (rl is rounded from a float sum formed in another order, then
    rl * ins is rounded, so one step of rl can move the product by two),
    the bf16 outputs dfact_rel, dw, db and dins one step (float sums
    rounded once); dprior (float from the same widened values) 1e-4 and
    scatter_mm 1e-5 of max|ref|. Two forward and two backward launches
    bit-identical; CUDA-event medians of kernel, plain and, for the
    scatter, ``scatter_add_``, and the kernels' device time (``graph_ms``);
    the same at SKEWED. Returns rows."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rows, bad = [], []
    shapes = [r for r in KERNEL_SHAPES if r[0] in FUSED_SHAPES] + [SKEWED]
    for name, B, E, F, J, D, dtype, relu in shapes:
        vals, ins, prior, scatter, starts, _ = kernel_inputs(
            B, E, F, J, D, dtype, relu, device, rng,
            skew=name == SKEWED[0])
        w = (torch.randn((D, D), generator=gen, device=device)
             / math.sqrt(D)).to(ins.dtype)
        b = (0.1 * torch.randn((D,), generator=gen, device=device)).to(ins.dtype)
        args = (vals[0], w, b, ins, prior[0], scatter[0], starts[0])
        fwd = gs.fused_gate_scatter_fwd(*args, relu)
        fwd_again = gs.fused_gate_scatter_fwd(*args, relu)
        g = torch.randn(fwd.shape, generator=gen, device=device)
        bwd = gs.fused_gate_scatter_bwd(*args, g, relu)
        again = gs.fused_gate_scatter_bwd(*args, g, relu)
        Fp = vals[0].shape[1]
        tiles = chunk_tiles_of(starts[0], Fp // 128)
        sv = torch.randn((B, Fp, J * D), generator=gen, device=device).to(ins.dtype)
        sc = gs.scatter_mm_fwd(sv, scatter[0], tiles, E)
        torch.cuda.synchronize()
        want = (gs.fused_gate_scatter_fwd_plain(*args, relu),
                *gs.fused_gate_scatter_bwd_plain(*args, g, relu),
                gs.scatter_mm_fwd_plain(sv, scatter[0], tiles, E))
        torch.cuda.synchronize()
        errs = fused_errors(dict(fused_rules(dtype), scatter=1e-5),
                            (fwd, *bwd, sc), want, name, bad)
        repeat = all(torch.equal(x, y) for x, y in zip(bwd, again))
        fwd_repeat = torch.equal(fwd, fwd_again)
        if not (repeat and fwd_repeat):
            bad.append(f"{name}: fused forward or backward not "
                       f"bit-repeatable")
        # the one PyTorch call that computes scatter_mm: scatter_add_ into
        # zeros (pad slots pointed at row 0 with zero values)
        idx = scatter[0].clamp_min(0).long()[..., None].expand(sv.shape).contiguous()
        src = torch.where((scatter[0] >= 0)[..., None], sv.float(), 0.0)

        def library():
            return torch.zeros((B, E, J * D), device=device).scatter_add_(
                1, idx, src)

        lib_err = (library() - want[-1]).abs().max().item()
        tile_chunks = (starts[0][:, 1:] - starts[0][:, :-1]).float()
        row = dict(
            shape=name, B=B, E=E, Fp=Fp, J=J, D=D, dtype=dtype, relu=relu,
            chunks_per_tile_mean_max=[tile_chunks.mean().item(),
                                      tile_chunks.max().item()],
            err_ref_by_output=errs, bit_identical_repeat=repeat,
            fwd_bit_identical_repeat=fwd_repeat, scatter_C=J * D,
            scatter_add_vs_plain=lib_err,
            ms=median_ms(lambda: gs.fused_gate_scatter_fwd(*args, relu)),
            device_ms=graph_ms(lambda: gs.fused_gate_scatter_fwd(*args, relu)),
            plain_ms=median_ms(lambda: gs.fused_gate_scatter_fwd_plain(*args, relu)),
            bwd_ms=median_ms(lambda: gs.fused_gate_scatter_bwd(*args, g, relu)),
            bwd_device_ms=graph_ms(
                lambda: gs.fused_gate_scatter_bwd(*args, g, relu)),
            bwd_plain_ms=median_ms(
                lambda: gs.fused_gate_scatter_bwd_plain(*args, g, relu)),
            scatter_ms=median_ms(lambda: gs.scatter_mm_fwd(sv, scatter[0], tiles, E)),
            scatter_device_ms=graph_ms(
                lambda: gs.scatter_mm_fwd(sv, scatter[0], tiles, E)),
            scatter_plain_ms=median_ms(
                lambda: gs.scatter_mm_fwd_plain(sv, scatter[0], tiles, E)),
            scatter_add_ms=median_ms(library))
        row["bound_ms_by"] = dict(
            fwd=gate_bound(row, False, ndir=1, project=True),
            bwd=gate_bound(row, True, ndir=1, project=True),
            scatter=scatter_bound(row))
        for share, unit in (("bound_share", "ms"),
                            ("device_bound_share", "device_ms")):
            row[share] = {
                part: row["bound_ms_by"][part][0] / row[f"{key}{unit}"]
                for part, key in (("fwd", ""), ("bwd", "bwd_"),
                                  ("scatter", "scatter_"))}
        log("kernel-fused", json.dumps(row))
        rows.append(row)
        del vals, args, fwd, fwd_again, g, bwd, again, sv, sc, want, idx, src
    if bad:
        raise AssertionError("fused kernels vs plain: " + "; ".join(bad))
    return rows


def refbench(root, n_train, n_dev, n_test):
    """A SynthQSP split at the default (WebQSP-like) subgraph scale, from
    the port's generator run as its own command."""
    subprocess.run([sys.executable, "-m", "gnn_rag_tpu_torch.utils.refbench",
                    "--out", root, "--seed", str(SEED), "--n_train",
                    str(n_train), "--n_dev", str(n_dev), "--n_test",
                    str(n_test)], cwd=REPO, check=True, capture_output=True,
                   text=True)


def headline_config(root, compute_dtype="float32"):
    """scripts/rearev_webqsp.sh: entity_dim 50, num_iter 3, num_ins 2,
    num_gnn 3, --lm sbert (frozen), relation_word_emb True."""
    from gnn_rag_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                          TrainConfig)
    return Config(
        data=DataConfig(name="webqsp", data_folder=root + "/", lm="sbert",
                        relation_word_emb=True),
        model=ModelConfig(entity_dim=50, num_iter=3, num_ins=2, num_gnn=3,
                          lm="sbert", compute_dtype=compute_dtype),
        train=TrainConfig(is_eval=False, test_batch_size=16, seed=SEED))


def post(url, questions):
    req = urllib.request.Request(url, data=json.dumps(
        {"questions": questions}).encode(), headers={"Content-Type":
                                                     "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())["results"]


def request_latency(url, questions):
    """Closed-loop latency of POST /retrieve, one client: each pass sends
    every question alone, then every 16-question batch of the split. Returns
    per request size the request count, p10/p50/p90 over all requests and
    each pass's p50 (their spread shows whether the p50 has settled)."""
    import numpy as np
    lat = {1: [], 16: []}
    pass_p50 = {1: [], 16: []}
    for _ in range(LATENCY_PASSES):
        for n in lat:
            this = []
            for i in range(0, len(questions) - n + 1, n):
                t = time.perf_counter()
                post(url, questions[i:i + n])
                this.append(1e3 * (time.perf_counter() - t))
            lat[n] += this
            pass_p50[n].append(float(np.median(this)))
    return {f"retrieve_b{n}": dict(
        requests=len(ms), p50_ms=float(np.median(ms)),
        p10_ms=float(np.percentile(ms, 10)),
        p90_ms=float(np.percentile(ms, 90)), pass_p50_ms=pass_p50[n])
        for n, ms in lat.items()}


def profile_slice(svc, questions, batch):
    """The retrieve stages (record_function spans of
    serve.py) per request at 1 and 16 questions, and the B16 forward under
    torch.profiler: device time, kernels, busy share, largest device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for n in (1, 16):
        reqs = [questions[i:i + n] for i in range(0, len(questions), n)]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t = time.perf_counter()
            for q in reqs:
                svc.retrieve(q)
            wall = 1e3 * (time.perf_counter() - t) / len(reqs)
        stages = {e.key.split("/", 1)[1]: e.cpu_time_total / 1e3 / len(reqs)
                  for e in prof.key_averages() if e.key.startswith("retrieve/")}
        log("profile", json.dumps(dict(
            questions_per_request=n, requests=len(reqs),
            wall_ms_per_request_under_profiler=wall,
            stage_ms_per_request=stages)))
    reps = 5
    b = batch.to(svc.device)
    with torch.inference_mode():
        for _ in range(3):
            svc.model(b, *svc.rel_args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(reps):
                svc.model(b, *svc.rel_args)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t) / reps
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    log("profile", json.dumps(dict(
        forward_b16_wall_ms_under_profiler=wall, device_ms=dev_ms,
        busy_share=dev_ms / wall if dev_ms else "not measured",
        device_kernels=sum(e.count for e in dev) / reps,
        top_device_ops=[[e.key[:60], e.self_device_time_total / 1e3 / reps,
                         e.count / reps] for e in top])))


def run_slice(device, root):
    """Phase 4: the serving slice at full width; returns (summary, launches)."""
    import dataclasses

    import numpy as np
    import torch
    from gnn_rag_tpu_torch.data.loader import load_dataset_dir
    from gnn_rag_tpu_torch.models.frozen_lm import (encode_questions,
                                                    encode_relations,
                                                    maybe_frozen_lm)
    from gnn_rag_tpu_torch.train.trainer import build_model
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    from gnn_rag_tpu_torch.serve import RetrieverService
    from gnn_rag_tpu_torch.train.evaluate import Evaluator

    t0 = time.perf_counter()
    refbench(root, n_train=8, n_dev=8, n_test=64)
    cfg = headline_config(root)
    bundle = load_dataset_dir(cfg)
    test, vocab, tok = bundle["test"], bundle["vocab"], bundle["tokenizer"]
    # the headline's --lm sbert: the checkpoint when the machine has it
    # (utils.hf_import: a local directory or the HF hub cache), else the
    # random MiniLM-width encoder, logged as such
    lm = maybe_frozen_lm(cfg.model.lm, cfg.model.word_dim_effective,
                         seed=SEED, device=device)
    if lm.weight_source.startswith("hf:"):
        log("frozen-lm", f"pretrained weights: {lm.weight_source}")
    else:
        log("frozen-lm", f"no {cfg.model.lm} checkpoint on this machine: "
            f"the frozen LM is a random MiniLM-width encoder "
            f"(weight_source {lm.weight_source})")
    rel = encode_relations(lm, bundle["rel_tokens"], bundle["rel_tokens_inv"],
                           tok.pad_id)
    encode_questions(lm, test, tok.pad_id)
    model = build_model(cfg, vocab.num_entity, bundle["num_kb_relation"],
                        word_dim=lm.hidden, seed=SEED, device=device)
    svc = RetrieverService(
        cfg, vocab, model, rel_hidden=rel[0], rel_hidden_inv=rel[1],
        rel_text_mask=rel[2], tokenizer=tok,
        question_encoder=lambda ids: lm.encode(ids[None], pad_id=tok.pad_id)[0])
    with open(os.path.join(root, "test.json")) as f:
        questions = [json.loads(line) for line in f]
    n_ent = [len(q["subgraph"]["entities"]) for q in questions]
    log("slice", f"setup {time.perf_counter() - t0:.1f} s: {len(questions)} "
        f"questions, entities mean {np.mean(n_ent):.0f} max {max(n_ent)}, "
        f"{bundle['num_kb_relation']} relations, path backend "
        f"{svc.path_backend}, frozen LM {lm.weight_source}")

    # ---- the main path, counted: two HTTP requests + the .info export ----
    httpd = svc.serve_http(port=0)
    url = f"http://localhost:{httpd.server_port}/retrieve"
    info_path = os.path.join(root, "test.info")
    evaluator = Evaluator(eps=cfg.model.eps, num_entity=vocab.num_entity,
                          id2entity=vocab.id2entity, num_iter=cfg.model.num_iter)
    try:
        reset_gate_counts()
        res1 = post(url, questions[:1])
        res16 = post(url, questions[:16])
        f1, hit, em, loss = evaluator.evaluate(
            test, svc.forward, test_batch_size=16, write_info=True,
            info_path=info_path)
        torch.cuda.synchronize()
        launches = gs.launches
        forwards = 2 + math.ceil(len(test) / 16)
        per_forward = 1 + cfg.model.num_iter * cfg.model.num_gnn
        if (launches != forwards * per_forward or gs.bwd_launches
                or gs.fused_launches or gs.fused_bwd_launches):
            raise AssertionError(f"kernel launches {launches} != {forwards} "
                                 f"forwards x {per_forward}, or backward "
                                 f"launches {gs.bwd_launches} while serving")
        latency = request_latency(url, questions)
    finally:
        httpd.shutdown()
        httpd.server_close()

    for res in [*res1, *res16]:
        probs = [p for _, p in res["cand"]]
        if not res["cand"] or probs != sorted(probs, reverse=True):
            raise AssertionError("retrieve returned no or unsorted candidates")
        if not all(" -> " in p for p in res["paths"]):
            raise AssertionError("malformed verbalized path")
    with open(info_path) as f:
        info = [json.loads(line) for line in f]
    keys = (["question"] + [str(j) for j in range(cfg.model.num_iter)]
            + ["answers", "precison", "recall", "f1", "hit", "em", "cand"])
    if len(info) != len(test) or any(list(x) != keys for x in info):
        raise AssertionError(".info lines or keys wrong")
    if not (np.isfinite(loss) and 0.0 <= f1 <= 1.0):
        raise AssertionError(f"eval loss {loss} / f1 {f1}")

    # ---- the same batch through the plain path on the card ----
    batch = test.make_batch(range(16))

    def forward_ms(fn):
        with torch.inference_mode():
            out = fn(batch)
            return out, median_ms(lambda: fn(batch), runs=10, reps=1, warmup=2)

    (_, _, dist_k), fwd_ms = forward_ms(svc.forward)
    (_, _, dist_p), fwd_plain_ms = swapped_to_plain(
        lambda: forward_ms(svc.forward))
    diff = (dist_k - dist_p).abs().max().item()
    sums = dist_k.sum(1)
    # atol 1e-5, and 1e-4 of the largest probability: only the f32 sum order
    # differs between the two paths
    if not (torch.isfinite(dist_k).all()
            and diff <= min(1e-5, 1e-4 * dist_p.abs().max().item())
            and torch.allclose(sums, torch.ones_like(sums), atol=1e-4)):
        raise AssertionError(f"pred_dist kernel vs plain max|d|={diff}")

    # ---- bfloat16 gate values through the kernel, same weights ----
    bf_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    bf_model = build_model(bf_cfg, vocab.num_entity, bundle["num_kb_relation"],
                           word_dim=lm.hidden, seed=SEED, device=device)
    with torch.inference_mode():
        _, _, dist_bf = bf_model(batch.to(device), *svc.rel_args)
    bf_diff = (dist_bf - dist_k).abs().max().item()
    if not (torch.isfinite(dist_bf).all()
            and torch.allclose(dist_bf.sum(1), torch.ones_like(sums), atol=1e-3)):
        raise AssertionError("bf16 pred_dist not a distribution")

    summary = dict(
        launches=launches, forwards=forwards, info_lines=len(info),
        eval_f1=f1, eval_hit=hit, eval_loss=loss,
        cand_per_question_b16=float(np.mean([len(r["cand"]) for r in res16])),
        paths_per_question_b16=float(np.mean([len(r["paths"]) for r in res16])),
        **latency,
        forward_b16_ms=fwd_ms, forward_b16_plain_ms=fwd_plain_ms,
        pred_dist_kernel_vs_plain=diff, pred_dist_bf16_vs_fp32=bf_diff,
        batch_E=int(batch.seed_dist.shape[1]),
        batch_Fp=int(batch.layout.fwd.scatter.shape[1]))
    log("slice", json.dumps(summary))
    profile_slice(svc, questions, batch)
    run_bfs(svc, questions)
    return summary, launches


def run_train(device, root):
    """Phase 5: train the headline configuration for 2 epochs through the
    port's CLI, then reload its final checkpoint; returns (summary,
    trainer, forward launches, backward launches)."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch import cli
    from gnn_rag_tpu_torch.train.trainer import build_model
    from gnn_rag_tpu_torch.ops import gate_scatter as gs

    t0 = time.perf_counter()
    refbench(root, n_train=64, n_dev=16, n_test=16)
    flags = HEADLINE_FLAGS + ["--data_folder", root + "/", "--checkpoint_dir",
                              os.path.join(root, "ckpt"),
                              "--experiment_name", "smoke"]
    # ---- the main path, counted: 2 epochs of training with evaluation ----
    reset_gate_counts()
    ctx = cli.run(flags + ["--num_epoch", "2", "--eval_every", "1",
                           "--decay_rate", "0.98"])
    torch.cuda.synchronize()
    fwd, bwd = gs.launches, gs.bwd_launches
    tr, cfg = ctx["trainer"], ctx["cfg"]
    wall = time.perf_counter() - t0

    def n_batches(ds):
        return math.ceil(len(ds) / cfg.train.test_batch_size)

    written = [r for r in ("h1", "f1", "final")
               if os.path.exists(tr._ckpt_path(r))]
    steps = 2 * math.ceil(len(tr.train_data) / cfg.train.batch_size)
    evals = (2 * (n_batches(tr.valid_data) + n_batches(tr.test_data))
             + len(written) * n_batches(tr.test_data))
    per = 1 + cfg.model.num_iter * cfg.model.num_gnn
    if (tr.step_count != steps or fwd != per * (steps + evals)
            or bwd != per * steps or gs.fused_launches or gs.fused_bwd_launches):
        raise AssertionError(f"train launches fwd {fwd} bwd {bwd}, expected "
                             f"{per} x ({steps} steps + {evals} eval forwards) "
                             f"and {per} x {steps}")
    history = ctx["history"]
    if not (len(history) == 2 and np.isfinite(history).all()):
        raise AssertionError(f"epoch (loss, h1, f1): {history}")
    if "final" not in written or not all(
            os.path.exists(tr._ckpt_path(r) + ".meta.json") for r in written):
        raise AssertionError(f"checkpoints written: {written}")
    init = build_model(cfg, tr.num_entity, ctx["bundle"]["num_kb_relation"],
                       word_dim=ctx["lm"].hidden,
                       seed=cfg.train.seed, device=device).state_dict()
    trained = tr.model.state_dict()      # the final checkpoint's weights
    changed = sum(not torch.equal(init[k], v) for k, v in trained.items())
    if changed < len(trained) - 1:
        raise AssertionError(f"only {changed} of {len(trained)} parameters "
                             "changed in training")

    # ---- the final checkpoint, reloaded by the eval-only entry ----
    test_batch = tr.test_data.make_batch(range(16))
    with torch.inference_mode():
        dist = tr.forward(test_batch)[2]
    ctx2 = cli.run(flags + ["--is_eval", "--load_experiment", "smoke-final.ckpt"])
    with torch.inference_mode():
        dist2 = ctx2["trainer"].forward(test_batch)[2]
    reload_diff = (dist - dist2).abs().max().item()
    if not (torch.isfinite(dist2).all() and reload_diff <= 1e-6):
        raise AssertionError(f"reloaded pred_dist differs by {reload_diff}")
    info_path = os.path.join(root, "ckpt", "smoke_test.info")
    with open(info_path) as f:
        info = [json.loads(line) for line in f]
    keys = (["question"] + [str(j) for j in range(cfg.model.num_iter)]
            + ["answers", "precison", "recall", "f1", "hit", "em", "cand"])
    if len(info) != len(tr.test_data) or any(list(x) != keys for x in info):
        raise AssertionError(".info lines or keys wrong after reload")
    summary = dict(
        wall_s=wall, steps=steps, eval_forwards=evals, launches=fwd,
        bwd_launches=bwd, epochs_loss_h1_f1=history,
        checkpoints=written, params_changed=changed, params=len(trained),
        reload_pred_dist_max_diff=reload_diff, info_lines=len(info),
        test_E=int(test_batch.seed_dist.shape[1]))
    log("train", json.dumps(summary))
    return summary, tr, fwd, bwd


GATE_KERNELS = ("gate_scatter_fwd", "gate_scatter_bwd",
                "fused_gate_scatter_fwd", "fused_gate_scatter_bwd",
                "scatter_mm_fwd")


def swapped_to_plain(fn):
    """Run ``fn`` with every gate-scatter kernel (the v4 forward and
    backward, the fused-projection forward and backward, scatter_mm)
    swapped for its plain version (restored afterwards)."""
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    real = {name: getattr(gs, name) for name in GATE_KERNELS}
    for name in GATE_KERNELS:
        setattr(gs, name, getattr(gs, name + "_plain"))
    try:
        return fn()
    finally:
        for name, f in real.items():
            setattr(gs, name, f)


def swapped_bwd_to_plain(fn):
    """Run ``fn`` with the gate-scatter backward kernels (v4/v3 and the
    fused projection's; scatter_mm's gradient is a gather, no kernel)
    swapped for their plain versions, the forward kernels kept."""
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    names = ("gate_scatter_bwd", "fused_gate_scatter_bwd")
    real = {name: getattr(gs, name) for name in names}
    for name in names:
        setattr(gs, name, getattr(gs, name + "_plain"))
    try:
        return fn()
    finally:
        for name, f in real.items():
            setattr(gs, name, f)


def gate_counts():
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    return {name: getattr(gs, name) for name in GATE_COUNTERS}


def reset_gate_counts():
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    for name in GATE_COUNTERS + ("launches_1dir", "bwd_launches_1dir"):
        setattr(gs, name, 0)


def check_grads(tr, device, phase="grad", softmax_biases=SOFTMAX_BIASES,
                bf16=True):
    """Phase 6: every parameter gradient of one B8 batch (dropout off): the
    backward kernels against their plain versions, both backward passes
    through one forward of the kernels (so both see the same ReLU masks;
    the forward kernels are held to theirs in phases kernel, slice and
    kernel-1dir). 1e-4 of the largest entry + 1e-7; ``softmax_biases``,
    whose gradient is 0 up to rounding, to |g| <= 1e-5 on both sides. A
    parameter the loss does not reach (NSM's last teacher step) has no
    gradient on either side. With ``bf16``, one bf16 training step."""
    import dataclasses

    import torch
    from gnn_rag_tpu_torch.train.trainer import build_model
    batch = tr.train_data.make_batch(range(8)).to(device)
    model = tr.model
    model.zero_grad(set_to_none=True)
    loss = model(batch, *tr.rel_args)[0]
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]

    def grads(retain):
        gs = torch.autograd.grad(loss, [p for _, p in named],
                                 retain_graph=retain, allow_unused=True)
        return {k: g for (k, _), g in zip(named, gs)}

    got = grads(True)
    want = swapped_bwd_to_plain(lambda: grads(False))
    worst = (0.0, "", 0.0)
    zero, smallest, unused = {}, float("inf"), []
    for name, w in want.items():
        if w is None or got[name] is None:
            if (w is None) != (got[name] is None):
                raise AssertionError(f"grad {name}: a gradient on one side only")
            unused.append(name)
            continue
        if name in softmax_biases:
            # its gradient is 0 but for rounding noise on both paths
            zero[name] = max(got[name].abs().max().item(), w.abs().max().item())
            if not zero[name] <= 1e-5:
                raise AssertionError(f"grad {name}: {zero[name]} is not ~0")
            continue
        err = (got[name] - w).abs().max().item()
        tol = 1e-4 * w.abs().max().item() + 1e-7
        if not err <= tol:
            raise AssertionError(f"grad {name}: kernel vs plain {err} > {tol}")
        worst = max(worst, (err / tol, name, err))
        smallest = min(smallest, w.abs().max().item())
    summary = dict(params=len(want), worst_err_over_tol=worst[0],
                   worst_param=worst[1], worst_err=worst[2],
                   softmax_bias_max_abs_grad=zero, unused_params=unused,
                   smallest_max_abs_grad_of_the_others=smallest,
                   batch_E=int(batch.seed_dist.shape[1]),
                   batch_Fp=int(batch.layout.fwd.scatter.shape[1]))
    if bf16:
        cfg = tr.cfg
        bf_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16"))
        bf = build_model(bf_cfg, tr.num_entity, model.num_relation,
                         word_dim=tr.rel_args[0].shape[-1], device=device)
        bf.load_state_dict(model.state_dict())
        bf(batch, *tr.rel_args, training=True, generator=tr.generator)[0].backward()
        bf_finite = all(torch.isfinite(p.grad).all() for p in bf.parameters())
        if not bf_finite:
            raise AssertionError("bf16 training step: non-finite gradients")
        summary["bf16_grads_finite"] = bf_finite
    log(phase, json.dumps(summary))
    return summary


def ms_per_step(tr, batch, valid_w):
    """ms per training step: CUDA events around TRAIN_STEPS steps after 5
    of warm-up."""
    import torch
    acc = torch.zeros(4, device=batch.seed_dist.device)
    for _ in range(5):
        acc = tr.train_step(batch, valid_w, acc)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS):
        acc = tr.train_step(batch, valid_w, acc)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TRAIN_STEPS


def train_step_time(tr, device, phase="step-time"):
    """Phase 7: ms per training step (CUDA events over TRAIN_STEPS steps
    after warm-up, kernel path and plain path in turns), and one kernel-path
    step's device time, kernel count and busy share under torch.profiler."""
    import torch
    batch = tr.train_data.make_batch(range(8)).to(device)
    valid_w = torch.ones(8, device=device)
    kernel, plain = [], []
    for path in ("kernel", "plain", "plain", "kernel"):
        if path == "kernel":
            kernel.append(ms_per_step(tr, batch, valid_w))
        else:
            plain.append(swapped_to_plain(
                lambda: ms_per_step(tr, batch, valid_w)))
    summary = dict(
        batch=8, steps_timed=TRAIN_STEPS, ms_per_step_kernel=kernel,
        ms_per_step_plain=plain,
        subgraphs_per_s_kernel=[8e3 / x for x in kernel],
        subgraphs_per_s_plain=[8e3 / x for x in plain],
        batch_E=int(batch.seed_dist.shape[1]),
        batch_Fp=int(batch.layout.fwd.scatter.shape[1]),
        **profile_step(tr, batch, valid_w))
    log(phase, json.dumps(summary))
    return summary


def profile_step(tr, batch, valid_w, reps=3, names=None):
    """``reps`` training steps under torch.profiler: wall and device ms a
    step, busy share, kernels a step, the largest device ops and the device
    ms and launches a step of each kernel named in ``names`` (default: the
    gate-scatter kernels, GATE_KERNEL_NAMES)."""
    names = GATE_KERNEL_NAMES if names is None else names
    import torch
    from torch.profiler import ProfilerActivity, profile
    acc = torch.zeros(4, device=valid_w.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            acc = tr.train_step(batch, valid_w, acc)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t) / reps
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    return dict(
        profiled_step_wall_ms=wall, device_ms=dev_ms,
        busy_share=dev_ms / wall if dev_ms else "not measured",
        device_kernels_per_step=sum(e.count for e in dev) / reps,
        top_device_ops=[[e.key[:60], e.self_device_time_total / 1e3 / reps,
                         e.count / reps] for e in top],
        gate_scatter_ms_launches=[
            [e.key[:60], e.self_device_time_total / 1e3 / reps, e.count / reps]
            for e in dev if any(k in e.key for k in names)])


def run_v2_path(device, root):
    """Phase 7b: ReaRev with GNN_RAG_GATE_SCATTER=v2 (set in this process,
    restored after) on run_train's data in ``root``: one epoch of 8 steps
    with evaluation through the port's CLI, the fused kernels' launch
    counts (2 x num_iter x num_gnn per forward and per step; TypeLayer's
    one gate-scatter launch per forward and step); every gradient kernel
    vs plain (check_grads) and a bf16 step; two POST /retrieve requests
    served by the trained model with their launch counts, pred_dist kernel
    vs plain; ms per train step on the v2 and the v4 path in eight turns,
    and each path's steps under torch.profiler (device ms: the step's wall
    is host bound). Returns (summary, train counts)."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch import cli
    from gnn_rag_tpu_torch.serve import RetrieverService

    before = os.environ.get("GNN_RAG_GATE_SCATTER")
    os.environ["GNN_RAG_GATE_SCATTER"] = "v2"
    try:
        t0 = time.perf_counter()
        flags = HEADLINE_FLAGS + [
            "--data_folder", root + "/", "--checkpoint_dir",
            os.path.join(root, "ckpt_v2"), "--experiment_name", "smoke_v2",
            "--num_epoch", "1", "--eval_every", "1"]
        # ---- the main path, counted: 1 epoch of training with evaluation ----
        reset_gate_counts()
        ctx = cli.run(flags)
        torch.cuda.synchronize()
        train_counts = gate_counts()
        tr, cfg = ctx["trainer"], ctx["cfg"]
        wall = time.perf_counter() - t0

        def n_batches(ds):
            return math.ceil(len(ds) / cfg.train.test_batch_size)

        written = [r for r in ("h1", "f1", "final")
                   if os.path.exists(tr._ckpt_path(r))]
        steps = math.ceil(len(tr.train_data) / cfg.train.batch_size)
        forwards = (steps + n_batches(tr.valid_data) + n_batches(tr.test_data)
                    + len(written) * n_batches(tr.test_data))
        fused = 2 * cfg.model.num_iter * cfg.model.num_gnn
        want = dict(launches=forwards, bwd_launches=steps,
                    fused_launches=fused * forwards,
                    fused_bwd_launches=fused * steps, scatter_launches=0)
        history = ctx["history"]
        if (steps != 8 or tr.step_count != steps or train_counts != want
                or not np.isfinite(history).all()):
            raise AssertionError(f"v2 training: {tr.step_count} steps, "
                                 f"launches {train_counts}, expected {want}; "
                                 f"history {history}")
        grads = check_grads(tr, device, phase="grad-v2")

        # ---- two requests served by the trained v2 model, counted ----
        bundle, lm, tok = ctx["bundle"], ctx["lm"], ctx["bundle"]["tokenizer"]
        svc = RetrieverService(
            cfg, bundle["vocab"], tr.model,
            **dict(zip(("rel_hidden", "rel_hidden_inv", "rel_text_mask"),
                       (a.cpu().numpy() for a in tr.rel_args))),
            tokenizer=tok,
            question_encoder=lambda ids: lm.encode(ids[None],
                                                   pad_id=tok.pad_id)[0])
        with open(os.path.join(root, "test.json")) as f:
            questions = [json.loads(line) for line in f]
        httpd = svc.serve_http(port=0)
        url = f"http://localhost:{httpd.server_port}/retrieve"
        try:
            reset_gate_counts()
            res = post(url, questions[:1]) + post(url, questions[1:5])
            torch.cuda.synchronize()
            serve_counts = gate_counts()
        finally:
            httpd.shutdown()
            httpd.server_close()
        want = dict(launches=2, bwd_launches=0, fused_launches=2 * fused,
                    fused_bwd_launches=0, scatter_launches=0)
        if serve_counts != want or len(res) != 5 or not all(
                r["cand"] for r in res):
            raise AssertionError(f"v2 serving launches {serve_counts}, "
                                 f"expected {want}; {len(res)} results")
        batch = tr.test_data.make_batch(range(16))
        with torch.inference_mode():
            dist_k = svc.forward(batch)[2]
            dist_p = swapped_to_plain(lambda: svc.forward(batch)[2])
        diff = (dist_k - dist_p).abs().max().item()
        if not (torch.isfinite(dist_k).all()
                and diff <= min(1e-5, 1e-4 * dist_p.abs().max().item())):
            raise AssertionError(f"v2 pred_dist kernel vs plain max|d|={diff}")

        # ---- a train step on the v2 and the v4 path, in turns, and each
        # path's device time under the profiler ----
        step_batch = tr.train_data.make_batch(range(8)).to(device)
        valid_w = torch.ones(8, device=device)
        step_ms = {"v2": [], "v4": []}
        for variant in ("v2", "v4", "v4", "v2") * 2:
            os.environ["GNN_RAG_GATE_SCATTER"] = variant
            step_ms[variant].append(ms_per_step(tr, step_batch, valid_w))
        profiled = {}
        for variant in ("v4", "v2"):
            os.environ["GNN_RAG_GATE_SCATTER"] = variant
            profiled.update({f"{variant}_{k}": v for k, v in
                             profile_step(tr, step_batch, valid_w).items()})
        summary = dict(
            wall_s=wall, steps=steps, forwards=forwards,
            train_launches=train_counts, serve_launches=serve_counts,
            epoch_loss_h1_f1=history, checkpoints=written,
            grad_worst_err_over_tol=grads["worst_err_over_tol"],
            pred_dist_kernel_vs_plain=diff,
            ms_per_step_v2=step_ms["v2"], ms_per_step_v4=step_ms["v4"],
            batch_E=int(step_batch.seed_dist.shape[1]),
            batch_Fp=int(step_batch.layout.fwd.scatter.shape[1]),
            **profiled)
        log("v2", json.dumps(summary))
        return summary, train_counts
    finally:
        if before is None:
            os.environ.pop("GNN_RAG_GATE_SCATTER", None)
        else:
            os.environ["GNN_RAG_GATE_SCATTER"] = before


# ------------------------------------------- the retrievers (NSM, GraftNet)
def check_1dir_kernels(device):
    """Phase kernel-1dir: the forward and backward kernels at one direction
    and J = 1 (NSM's launch, K4f / K4b) against their plain versions at
    NSM_SHAPES, two launches of each bit-identical, timed and bounded as in
    phases 3 and 3b (``gate_bound`` with ndir=1). Returns (fwd rows, bwd
    rows)."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    rng = np.random.default_rng(SEED + 5)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    fwd_rows, bwd_rows = [], []
    for name, B, E, F, J, D, dtype, relu in NSM_SHAPES:
        vals, ins, prior, scatter, starts, _ = kernel_inputs(
            B, E, F, J, D, dtype, relu, device, rng, skew="skewed" in name)
        args = (vals[:1], ins, prior[:1], scatter[:1], starts[:1], relu)
        got = gs.gate_scatter_fwd(*args)
        repeat = torch.equal(got, gs.gate_scatter_fwd(*args))
        g = torch.randn(got.shape, generator=gen, device=device)
        bargs = args[:5] + (g, relu)
        bwd = gs.gate_scatter_bwd(*bargs)
        bwd_again = gs.gate_scatter_bwd(*bargs)
        torch.cuda.synchronize()
        want = gs.gate_scatter_fwd_plain(*args)
        bwant = gs.gate_scatter_bwd_plain(*bargs)
        torch.cuda.synchronize()
        err, ref = (got - want).abs().max().item(), want.abs().max().item()
        parts = {}
        for part, a, b in zip(("dvals", "dprior", "dins"),
                              (bwd[0][0], bwd[1][0], bwd[2]),
                              (bwant[0][0], bwant[1][0], bwant[2])):
            parts[part] = [(a - b).abs().max().item(), b.abs().max().item()]
            if not (torch.isfinite(a).all() and parts[part][0] <= 1e-5 * parts[part][1]):
                raise AssertionError(f"1-dir bwd kernel disagrees with plain at "
                                     f"{name} {part}: {parts[part]}")
        brepeat = all(torch.equal(a, b) for a, b in zip(
            (bwd[0][0], bwd[1][0], bwd[2]), (bwd_again[0][0], bwd_again[1][0],
                                              bwd_again[2])))
        if not (torch.isfinite(got).all() and err <= 1e-5 * ref and repeat
                and brepeat):
            raise AssertionError(f"1-dir kernels at {name}: fwd max|d|={err} "
                                 f"vs 1e-5*{ref}, repeats {repeat} {brepeat}")
        common = dict(shape=name, B=B, E=E, Fp=vals[0].shape[1], J=J, D=D,
                      dtype=dtype, relu=relu, ndir=1)
        fwd_rows.append(with_share(dict(
            common, max_abs_err=err, max_abs_ref=ref, bit_identical_repeat=repeat,
            ms=median_ms(lambda: gs.gate_scatter_fwd(*args)),
            device_ms=graph_ms(lambda: gs.gate_scatter_fwd(*args)),
            plain_ms=median_ms(lambda: gs.gate_scatter_fwd_plain(*args))),
            False, ndir=1))
        bwd_rows.append(with_share(dict(
            common, max_abs_err=max(e for e, _ in parts.values()),
            err_ref_by_output=parts, bit_identical_repeat=brepeat,
            ms=median_ms(lambda: gs.gate_scatter_bwd(*bargs)),
            device_ms=graph_ms(lambda: gs.gate_scatter_bwd(*bargs)),
            plain_ms=median_ms(lambda: gs.gate_scatter_bwd_plain(*bargs))),
            True, ndir=1))
        log("kernel-1dir", json.dumps(dict(forward=fwd_rows[-1],
                                           backward=bwd_rows[-1])))
        del vals, args, got, g, bargs, bwd, bwd_again, want, bwant
    return fwd_rows, bwd_rows


def train_and_reload(flags, root, name, per_fwd, per_fwd_1dir, per_bwd=None,
                     per_bwd_1dir=None, epochs=1):
    """Train ``flags`` through the port's CLI for ``epochs`` with evaluation
    (checkpoints under ``root``/ckpt_<name>), checking each counter's
    exact launches: ``per_fwd`` gate-scatter launches a forward (of them
    ``per_fwd_1dir`` of one direction) and ``per_bwd`` backward launches a
    step (``per_bwd_1dir`` of one direction; by default as many as
    forward: a launch whose output reaches no loss has no backward); then
    reload the final checkpoint by ``--is_eval``: the same weights bit for
    bit, the test answer distribution reproduced, the `.info` written.
    Returns (summary, ctx, counts)."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch import cli
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    flags = flags + ["--data_folder", root + "/", "--checkpoint_dir",
                     os.path.join(root, f"ckpt_{name}"), "--experiment_name",
                     name]
    t0 = time.perf_counter()
    reset_gate_counts()
    ctx = cli.run(flags + ["--num_epoch", str(epochs)])
    torch.cuda.synchronize()
    counts = dict(gate_counts(), launches_1dir=gs.launches_1dir,
                  bwd_launches_1dir=gs.bwd_launches_1dir)
    wall = time.perf_counter() - t0
    tr, cfg = ctx["trainer"], ctx["cfg"]

    def n_batches(ds):
        return math.ceil(len(ds) / cfg.train.test_batch_size)

    written = [r for r in ("h1", "f1", "final")
               if os.path.exists(tr._ckpt_path(r))]
    steps = epochs * math.ceil(len(tr.train_data) / cfg.train.batch_size)
    evals = (epochs // cfg.train.eval_every
             * (n_batches(tr.valid_data) + n_batches(tr.test_data))
             + len(written) * n_batches(tr.test_data))
    forwards = steps + evals
    per_bwd = per_fwd if per_bwd is None else per_bwd
    per_bwd_1dir = per_fwd_1dir if per_bwd_1dir is None else per_bwd_1dir
    want = dict(launches=per_fwd * forwards, bwd_launches=per_bwd * steps,
                fused_launches=0, fused_bwd_launches=0, scatter_launches=0,
                launches_1dir=per_fwd_1dir * forwards,
                bwd_launches_1dir=per_bwd_1dir * steps)
    history = ctx["history"]
    if (tr.step_count != steps or counts != want
            or not np.isfinite(history).all() or "final" not in written):
        raise AssertionError(f"{name}: {tr.step_count} steps, launches "
                             f"{counts}, expected {want} ({per_fwd} a forward "
                             f"and a step); history {history}; {written}")
    test_batch = tr.test_data.make_batch(range(16))
    with torch.inference_mode():
        dist = tr.forward(test_batch)[2]
    ctx2 = cli.run(flags + ["--is_eval", "--load_experiment", f"{name}-final.ckpt"])
    with torch.inference_mode():
        dist2 = ctx2["trainer"].forward(test_batch)[2]
    ctx2["trainer"].close()
    reloaded = ctx2["trainer"].model.state_dict()
    if not all(torch.equal(reloaded[k], v) for k, v in tr.model.state_dict().items()):
        raise AssertionError(f"{name}: the reloaded weights differ")
    # the same weights; the forward's index-adds (GraftNet's layers, the COO
    # steps) sum with float atomics, so the distribution is held as the
    # served one is, to min(1e-5, 1e-4 of its largest entry)
    reload_diff = (dist - dist2).abs().max().item()
    reload_tol = min(1e-5, 1e-4 * dist.abs().max().item())
    with open(os.path.join(root, f"ckpt_{name}", f"{name}_test.info")) as f:
        info = [json.loads(line) for line in f]
    keys = (["question"] + [str(j) for j in range(tr.evaluator.num_iter)]
            + ["answers", "precison", "recall", "f1", "hit", "em", "cand"])
    if not (torch.isfinite(dist2).all() and reload_diff <= reload_tol
            and len(info) == len(tr.test_data)
            and all(list(x) == keys for x in info)):
        raise AssertionError(f"{name}: reload differs by {reload_diff}, or "
                             f"the .info is wrong")
    return dict(wall_s=wall, steps=steps, forwards=forwards, launches=counts,
                epoch_loss_h1_f1=history, checkpoints=written,
                reload_pred_dist_max_diff=reload_diff, info_lines=len(info),
                test_E=int(test_batch.seed_dist.shape[1])), ctx, counts


def serve_checkpoint(ctx, root, device, per_fwd):
    """POST /retrieve of 16 questions from the trained model's state_dict
    (``RetrieverService`` builds the retriever through the trainer's
    build_model): ``per_fwd`` forward launches and no backward; its answer
    distribution against the plain path's (atol 1e-5)."""
    import torch
    from gnn_rag_tpu_torch.serve import RetrieverService
    tr, bundle = ctx["trainer"], ctx["bundle"]
    frozen = dict(zip(("rel_hidden", "rel_hidden_inv", "rel_text_mask",
                       "entity_emb", "word_emb", "relation_emb"),
                      (None if a is None else a.cpu().numpy()
                       for a in tr.rel_args)))
    svc = RetrieverService(ctx["cfg"], bundle["vocab"], tr.model.state_dict(),
                           tokenizer=bundle["tokenizer"], device=device, **frozen)
    with open(os.path.join(root, "test.json")) as f:
        questions = [json.loads(line) for line in f][:16]
    httpd = svc.serve_http(port=0)
    try:
        reset_gate_counts()
        res = post(f"http://localhost:{httpd.server_port}/retrieve", questions)
        torch.cuda.synchronize()
        counts = gate_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
    if (counts["launches"] != per_fwd or counts["bwd_launches"]
            or len(res) != 16 or not all(r["cand"] for r in res)):
        raise AssertionError(f"serving launches {counts}, expected {per_fwd}; "
                             f"{len(res)} results")
    batch = tr.test_data.make_batch(range(16))
    with torch.inference_mode():
        dist_k = svc.forward(batch)[2]
        dist_p = swapped_to_plain(lambda: svc.forward(batch)[2])
    diff = (dist_k - dist_p).abs().max().item()
    if not (torch.isfinite(dist_k).all()
            and diff <= min(1e-5, 1e-4 * dist_p.abs().max().item())):
        raise AssertionError(f"served pred_dist kernel vs plain max|d|={diff}")
    return dict(serve_launches=counts["launches"],
                serve_pred_dist_kernel_vs_plain=diff,
                cand_per_question=sum(len(r["cand"]) for r in res) / len(res))


def run_retrievers(device, root):
    """Phase retrievers: NSM and GraftNet at the JAX CLI's widths on
    run_train's split in ``root`` (64 train questions, B8: 8 steps, with a
    300-d word table written from the seed): one epoch through the CLI with
    exact launch counts (NSM: TypeLayer's two-direction launch and
    2 x num_step one-direction ones a forward, one fewer backward a step;
    GraftNet: TypeLayer's one), evaluation, reload, POST /retrieve from the
    checkpoint, every gradient kernel vs plain backward, the step time
    (kernel path and plain path, CUDA events); then ReaRev's options
    (REAREV_OPTIONS), 4 steps each on 32 of the questions with their
    launch counts and step time, the gradient check on the seeded model.
    Returns (summary, NSM's train counts)."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch import cli
    from gnn_rag_tpu_torch.data.vocab import Vocab
    t0 = time.perf_counter()
    words = Vocab.from_dir(root + "/", "entities.txt", "relations.txt",
                           "vocab.txt").word2id
    np.save(os.path.join(root, "word_emb.npy"),
            np.random.default_rng(SEED).standard_normal(
                (len(words), 300)).astype(np.float32))
    summary, nsm_counts = {}, None
    for name, flags in RETRIEVERS.items():
        # NSM: TypeLayer, 3 steps, 3 teacher steps a forward; the teacher's
        # last step reaches no loss term (nsm.py:151-170 compares its
        # history up to num_step - 1), so it has no backward launch
        per, per_bwd = (1 + 2 * 3, 1 + 3 + 2) if name == "nsm" else (1, 1)
        row, ctx, counts = train_and_reload(flags, root, name, per, per - 1,
                                            per_bwd, per_bwd - 1)
        if name == "nsm":
            nsm_counts = counts
        tr = ctx["trainer"]
        row.update(serve_checkpoint(ctx, root, device, per))
        biases = ({"nsm": ("reasoning.score_func.bias",
                           "reasoning_back.score_func.bias",
                           "instruction_decoder.ca_linear.bias")}.get(name, ()))
        row["grad"] = check_grads(tr, device, phase=f"grad-{name}",
                                  softmax_biases=biases, bf16=False)
        row["step"] = train_step_time(tr, device, phase=f"step-time-{name}")
        tr.close()
        log(name, json.dumps({k: v for k, v in row.items()
                              if k not in ("grad", "step")}))
        summary[name] = row
        del ctx, tr
    for name, extra in REAREV_OPTIONS.items():
        flags = HEADLINE_FLAGS + extra + ["--max_train", "32", "--eval_every", "2"]
        # the gradients of the seeded model, before its steps: the steps of
        # --lm_frozen 0 move every weight of the in-model encoder by ~lr,
        # and its token states grow alike (cosine near 1), which leaves the
        # instruction attention's gradient at rounding level
        init = cli.assemble(flags + ["--data_folder", root + "/",
                                     "--checkpoint_dir",
                                     os.path.join(root, f"ckpt_init_{name}")])
        grad = check_grads(init["trainer"], device, phase=f"grad-{name}",
                           bf16=False)
        init["trainer"].close()
        del init
        per = 1 if name == "pos_emb" else 1 + 3 * 3
        row, ctx, _ = train_and_reload(flags, root, f"rearev_{name}", per, 0)
        tr = ctx["trainer"]
        row["grad"] = grad
        step_batch = tr.train_data.make_batch(range(8)).to(device)
        valid_w = torch.ones(8, device=device)
        row["ms_per_step"] = [ms_per_step(tr, step_batch, valid_w)
                              for _ in range(2)]
        tr.close()
        log(f"rearev-{name}", json.dumps({k: v for k, v in row.items()
                                          if k != "grad"}))
        summary[f"rearev_{name}"] = row
        del ctx, tr
    summary["wall_s"] = time.perf_counter() - t0
    log("retrievers", json.dumps(dict(
        wall_s=summary["wall_s"],
        ms_per_step_kernel={k: v["step"]["ms_per_step_kernel"]
                            for k, v in summary.items() if k in RETRIEVERS},
        ms_per_step_plain={k: v["step"]["ms_per_step_plain"]
                           for k, v in summary.items() if k in RETRIEVERS},
        ms_per_step_rearev_options={k: v["ms_per_step"] for k, v in summary.items()
                                    if k.startswith("rearev_")})))
    return summary, nsm_counts


# ------------------------------ the gate-scatter kernels' column windows
def check_wide_kernels(device):
    """Phase wide, kernels: the gate-scatter kernels at WIDE_SHAPES, where
    a block cannot hold the whole [128, J*D] tile of K2, K6a/b or K6c and
    the launch runs D's columns in windows (``gs.kernel_window``), against
    their plain versions with the tolerances of phases 3, 3b and 3d (the
    v4 forward 1e-5 / 2e-2 of max|ref|, the backward's outputs the same,
    the fused kernels per output as check_fused_kernels), two launches bit
    for bit; where one window fits (K1 at J 3, D 128), the forward at half
    the width's windows bit for bit against it (each column's sum does not
    depend on the window). Timed (``ms``, ``device_ms``, ``plain_ms``) and
    bounded as phases 3 and 3b (``gate_bound``: inputs read once, so the
    windows do not change it). Returns rows."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    rng = np.random.default_rng(SEED + 7)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows, bad = [], []
    for name, B, E, F, J, D, dtype, relu, ndir in WIDE_SHAPES:
        vals, ins, prior, scatter, starts, _ = kernel_inputs(
            B, E, F, J, D, dtype, relu, device, rng)
        fargs = (vals[:ndir], ins, prior[:ndir], scatter[:ndir], starts[:ndir],
                 relu)
        rel = 1e-5 if dtype == "float32" else 2e-2
        win = {k: gs.kernel_window(k, D, J, ins.dtype)
               for k in ("gate_scatter_fwd", "gate_scatter_bwd")}
        fwd = gs.gate_scatter_fwd(*fargs)
        g = torch.randn(fwd.shape, generator=gen, device=device)
        bargs = fargs[:5] + (g, relu)
        bwd = gs.gate_scatter_bwd(*bargs)
        repeat = (torch.equal(fwd, gs.gate_scatter_fwd(*fargs)) and all(
            torch.equal(a, b) for a, b in zip(
                (*bwd[0], *bwd[1], bwd[2]),
                (lambda r: (*r[0], *r[1], r[2]))(gs.gate_scatter_bwd(*bargs)))))
        half = None
        if win["gate_scatter_fwd"][1] == 1:
            W = -(-D // 2 // 8) * 8
            half = [W, torch.equal(fwd, gs.gate_scatter_fwd(*fargs, window=W))]
        torch.cuda.synchronize()
        want = gs.gate_scatter_fwd_plain(*fargs)
        bwant = gs.gate_scatter_bwd_plain(*bargs)
        torch.cuda.synchronize()
        errs = {"fwd": [(fwd - want).abs().max().item(), want.abs().max().item()]}
        for part, a, b in zip(
                [f"dvals_{d}" for d in range(ndir)] + [f"dprior_{d}" for d in
                                                     range(ndir)] + ["dins"],
                (*bwd[0], *bwd[1], bwd[2]), (*bwant[0], *bwant[1], bwant[2])):
            errs[part] = [(a.float() - b.float()).abs().max().item(),
                          b.float().abs().max().item()]
            if not (a.dtype == b.dtype and torch.isfinite(a).all()):
                bad.append(f"{name} {part}: dtype or a non-finite value")
        for part, (err, ref) in errs.items():
            if not err <= rel * ref:
                bad.append(f"{name} {part}: max|d| {err} > {rel} * {ref}")
        if not (repeat and torch.isfinite(fwd).all()
                and (half is None or half[1])):
            bad.append(f"{name}: repeat {repeat}, half-width windows {half}")
        common = dict(shape=name, B=B, E=E, Fp=vals[0].shape[1], J=J, D=D,
                      dtype=dtype, relu=relu, ndir=ndir)
        row = dict(common, windows={k: list(v) for k, v in win.items()},
                   err_ref_by_output=errs, bit_identical_repeat=repeat,
                   fwd_half_width_windows_bit_identical=half)
        row["fwd"] = with_share(dict(
            common, max_abs_err=errs["fwd"][0],
            ms=median_ms(lambda: gs.gate_scatter_fwd(*fargs)),
            device_ms=graph_ms(lambda: gs.gate_scatter_fwd(*fargs)),
            plain_ms=median_ms(lambda: gs.gate_scatter_fwd_plain(*fargs),
                               runs=5, reps=2, warmup=1)), False, ndir=ndir)
        row["bwd"] = with_share(dict(
            common, max_abs_err=max(e for k, (e, _) in errs.items()
                                    if k != "fwd"),
            ms=median_ms(lambda: gs.gate_scatter_bwd(*bargs)),
            device_ms=graph_ms(lambda: gs.gate_scatter_bwd(*bargs)),
            plain_ms=median_ms(lambda: gs.gate_scatter_bwd_plain(*bargs),
                               runs=5, reps=2, warmup=1)), True, ndir=ndir)
        if J > 1:   # ReaRev's v2 op at this width (one direction)
            row["fused"] = fused_row(device, gen, vals[0], ins, prior[0],
                                     scatter[0], starts[0], relu, common, bad)
        log("wide-kernel", json.dumps(row))
        rows.append(row)
        del vals, ins, prior, scatter, starts, fargs, bargs, fwd, g, bwd
        del want, bwant
    if bad:
        raise AssertionError("windowed kernels vs plain: " + "; ".join(bad))
    return rows


def fused_row(device, gen, fr, ins, prior, scatter, starts, relu, common, bad):
    """The fused-projection forward and backward (K6a/b, K6c) on one
    direction of a WIDE_SHAPES row, as check_fused_kernels holds them
    (``bad`` collects failures): their windows, errors, repeats, and times
    and bounds (``gate_bound`` with ``project``)."""
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    D, J = common["D"], common["J"]
    w = (torch.randn((D, D), generator=gen, device=device)
         / math.sqrt(D)).to(ins.dtype)
    b = (0.1 * torch.randn((D,), generator=gen, device=device)).to(ins.dtype)
    args = (fr, w, b, ins, prior, scatter, starts)
    fwd = gs.fused_gate_scatter_fwd(*args, relu)
    g = torch.randn(fwd.shape, generator=gen, device=device)
    bwd = gs.fused_gate_scatter_bwd(*args, g, relu)
    repeat = (torch.equal(fwd, gs.fused_gate_scatter_fwd(*args, relu))
              and all(torch.equal(x, y) for x, y in zip(
                  bwd, gs.fused_gate_scatter_bwd(*args, g, relu))))
    torch.cuda.synchronize()
    want = (gs.fused_gate_scatter_fwd_plain(*args, relu),
            *gs.fused_gate_scatter_bwd_plain(*args, g, relu))
    torch.cuda.synchronize()
    rules = fused_rules(common["dtype"])
    errs = fused_errors(rules, (fwd, *bwd), want, f"{common['shape']} fused",
                        bad)
    if not repeat:
        bad.append(f"{common['shape']}: fused kernels not bit-repeatable")
    row = dict(common, ndir=1, windows={
        k: list(gs.kernel_window(k, D, J, ins.dtype))
        for k in ("fused_gate_scatter_fwd", "fused_gate_scatter_bwd")},
        err_ref_by_output=errs, bit_identical_repeat=repeat)
    for key, backward, fn, plain in (
            ("fwd", False, lambda: gs.fused_gate_scatter_fwd(*args, relu),
             lambda: gs.fused_gate_scatter_fwd_plain(*args, relu)),
            ("bwd", True, lambda: gs.fused_gate_scatter_bwd(*args, g, relu),
             lambda: gs.fused_gate_scatter_bwd_plain(*args, g, relu))):
        parts = ("fwd",) if key == "fwd" else tuple(rules)[1:]
        row[key] = dict(
            max_abs_err=max(errs[p][0] for p in parts), ms=median_ms(fn),
            device_ms=graph_ms(fn),
            plain_ms=median_ms(plain, runs=5, reps=2, warmup=1))
        bound_ms, bound_by = gate_bound(row, backward, ndir=1, project=True)
        row[key].update(bound_ms=bound_ms, bound_by=bound_by,
                        device_bound_share=bound_ms / row[key]["device_ms"])
    return row


@contextlib.contextmanager
def plain_gate_calls():
    """Counts, in the dict it yields, the calls of each plain gate-scatter
    version (``*_plain`` of GATE_KERNELS, which the wrappers take only for
    CPU tensors) made inside the block."""
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    real = {n + "_plain": getattr(gs, n + "_plain") for n in GATE_KERNELS}
    calls = dict.fromkeys(real, 0)

    def counted(name, f):
        def call(*args, **kw):
            calls[name] += 1
            return f(*args, **kw)
        return call

    for n, f in real.items():
        setattr(gs, n, counted(n, f))
    try:
        yield calls
    finally:
        for n, f in real.items():
            setattr(gs, n, f)


def run_wide(device, root):
    """Phase wide: the retrievers at the widths whose gate-scatter kernels
    take column windows, through the port's CLI and Trainer on run_train's
    split in ``root`` (and run_retrievers' word table): ReaRev at CWQ's
    command with entity dim 128 (WIDE_REAREV) under v4 and v2, NSM at 256
    (WIDE_NSM; TypeLayer's two-direction J 1 launch and NSM's one-direction
    ones), ReaRev in float32 and bf16 and NSM in float32 (neither package's
    NSM has a compute dtype): WIDE_TRAIN questions (3 B8 steps) and
    one evaluation, the exact launch counts of each gate-scatter kernel and
    no call of a plain version; the first loss with the kernels against
    plain message passing (float32 1e-4 of its size, as the grad phase's
    gradients; bf16 2e-2), every gradient of the float32 runs against the
    plain backward (check_grads); ms a step (``ms_per_step``) beside each
    kernel's windows. Returns (summary, counts by run)."""
    import torch
    from gnn_rag_tpu_torch import cli
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    t0 = time.perf_counter()
    summary, counts_by_run = {}, {}
    runs = [("rearev", v, dt) for v in ("v4", "v2")
            for dt in ("float32", "bfloat16")]
    runs.append(("nsm", "v4", "float32"))   # NSM computes in float32 only
    before = os.environ.get("GNN_RAG_GATE_SCATTER")
    try:
        for model, variant, dtype in runs:
            os.environ["GNN_RAG_GATE_SCATTER"] = variant
            name = f"wide_{model}_{variant}_{dtype}"
            flags = (WIDE_REAREV if model == "rearev" else WIDE_NSM) + [
                "--compute_dtype", dtype, "--max_train", str(WIDE_TRAIN),
                "--num_epoch", "1", "--eval_every", "1", "--data_folder",
                root + "/", "--checkpoint_dir",
                os.path.join(root, f"ckpt_{name}"), "--experiment_name", name]
            reset_gate_counts()
            with plain_gate_calls() as plain_calls:
                ctx = cli.run(flags)
                torch.cuda.synchronize()
            counts = dict(gate_counts(), launches_1dir=gs.launches_1dir,
                          bwd_launches_1dir=gs.bwd_launches_1dir)
            tr, cfg = ctx["trainer"], ctx["cfg"]

            def n_batches(ds):
                return math.ceil(len(ds) / cfg.train.test_batch_size)

            written = [r for r in ("h1", "f1", "final")
                       if os.path.exists(tr._ckpt_path(r))]
            steps = math.ceil(len(tr.train_data) / cfg.train.batch_size)
            forwards = (steps + n_batches(tr.valid_data)
                        + (1 + len(written)) * n_batches(tr.test_data))
            m = cfg.model
            if model == "rearev" and variant == "v2":
                per = dict(fwd=1, bwd=1, fused=2 * m.num_iter * m.num_gnn,
                           fwd_1dir=0, bwd_1dir=0)
            elif model == "rearev":
                per = dict(fwd=1 + m.num_iter * m.num_gnn,
                           bwd=1 + m.num_iter * m.num_gnn, fused=0,
                           fwd_1dir=0, bwd_1dir=0)
            else:   # TypeLayer, num_step steps and teacher steps; the
                # teacher's last step has no backward (run_retrievers)
                per = dict(fwd=1 + 2 * m.num_step, bwd=m.num_step * 2,
                           fused=0, fwd_1dir=2 * m.num_step,
                           bwd_1dir=2 * m.num_step - 1)
            want = dict(launches=per["fwd"] * forwards,
                        bwd_launches=per["bwd"] * steps,
                        fused_launches=per["fused"] * forwards,
                        fused_bwd_launches=per["fused"] * steps,
                        scatter_launches=0,
                        launches_1dir=per["fwd_1dir"] * forwards,
                        bwd_launches_1dir=per["bwd_1dir"] * steps)
            history = ctx["history"]
            if (steps != WIDE_TRAIN // 8 or tr.step_count != steps
                    or counts != want or any(plain_calls.values())
                    or not all(math.isfinite(x) for r in history for x in r)):
                raise AssertionError(
                    f"{name}: {tr.step_count} steps, launches {counts}, "
                    f"expected {want}; plain calls {plain_calls}; history "
                    f"{history}")
            batch = tr.train_data.make_batch(range(8)).to(device)
            with torch.no_grad():
                loss_k = tr.model(batch, *tr.rel_args)[0].item()
                loss_p = swapped_to_plain(
                    lambda: tr.model(batch, *tr.rel_args)[0].item())
            rel = 1e-4 if dtype == "float32" else 2e-2
            if not (math.isfinite(loss_k) and abs(loss_k - loss_p)
                    <= rel * abs(loss_p) + 1e-7):
                raise AssertionError(f"{name}: first loss kernel {loss_k} vs "
                                     f"plain {loss_p}")
            row = dict(steps=steps, forwards=forwards, launches=counts,
                       plain_calls=plain_calls, epoch_loss_h1_f1=history,
                       loss_kernel=loss_k, loss_plain=loss_p,
                       batch_E=int(batch.seed_dist.shape[1]),
                       batch_Fp=int(batch.layout.fwd.scatter.shape[1]))
            D, J = m.entity_dim, (m.num_ins if model == "rearev" else 1)
            kinds = (("fused_gate_scatter_fwd", "fused_gate_scatter_bwd")
                     if variant == "v2" else ())
            row["windows"] = {
                f"{k}_J{j}": list(gs.kernel_window(k, D, j, getattr(torch, dtype)))
                for k, j in [("gate_scatter_fwd", 1), ("gate_scatter_bwd", 1)]
                + [(k, J) for k in ("gate_scatter_fwd", "gate_scatter_bwd")
                   if J > 1 and variant == "v4"] + [(k, J) for k in kinds]}
            if dtype == "float32":
                biases = (("reasoning.score_func.bias",
                           "reasoning_back.score_func.bias",
                           "instruction_decoder.ca_linear.bias")
                          if model == "nsm" else SOFTMAX_BIASES)
                row["grad"] = check_grads(tr, device, phase=f"grad-{name}",
                                          softmax_biases=biases, bf16=False)
            row["ms_per_step"] = ms_per_step(tr, batch,
                                             torch.ones(8, device=device))
            tr.close()
            log("wide", json.dumps(dict(run=name, **{
                k: v for k, v in row.items() if k != "grad"})))
            summary[name], counts_by_run[name] = row, counts
            del ctx, tr, batch
    finally:
        if before is None:
            os.environ.pop("GNN_RAG_GATE_SCATTER", None)
        else:
            os.environ["GNN_RAG_GATE_SCATTER"] = before
    summary["wall_s"] = time.perf_counter() - t0
    log("wide", json.dumps(dict(wall_s=summary["wall_s"], ms_per_step={
        k: v["ms_per_step"] for k, v in summary.items() if k != "wall_s"})))
    return summary, counts_by_run


# ------------------------------------------- bounds, then the LLM reader
def bound(flops, nbytes, dtype):
    """(least card time in ms, what bounds it): the larger of the operations
    over the card's peak for the type and the bytes over its memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gate_bound(row, backward, ndir=2, project=False):
    """Bound of a gate-scatter launch at a kernel row's shapes, ``ndir``
    directions: every input read once, every output written once; a
    multiply, a scale and an add per (fact, column) forward, twice that
    backward. ``project`` (the fused-projection kernels): w and b read
    (and dW, db written backward), 2*D*D flops per fact slot for the
    projection forward, 6*D*D backward (rl again, dfact_rel, dW). Only the
    function's inputs and outputs count: the backward kernel's dW
    workspace is its design's traffic, not the function's."""
    B, E, Fp, J, D = row["B"], row["E"], row["Fp"], row["J"], row["D"]
    it = 4 if row["dtype"] == "float32" else 2
    vals, ins = ndir * B * Fp * D * it, B * J * D * it
    per_fact = ndir * B * Fp * 4              # prior or scatter, f32 / i32
    starts = ndir * B * (E // 128 + 1) * 4
    out = ndir * B * E * J * D * 4
    nbytes = vals + ins + 2 * per_fact + starts + out
    flops = (6 if backward else 3) * ndir * B * Fp * J * D
    if backward:                              # + dvals, dprior, dins out
        nbytes += vals + per_fact + ins
    if project:
        nbytes += (D * D + D) * it * (2 if backward else 1)
        flops += (6 if backward else 2) * D * D * ndir * B * Fp
    return bound(flops, nbytes, row["dtype"])


def scatter_bound(row):
    """Bound of scatter_mm at a fused row's shapes (C = J*D): the values,
    scatter and chunk_tiles read once, the float output written once, one
    float add per (fact slot, column)."""
    B, E, Fp, C = row["B"], row["E"], row["Fp"], row["scatter_C"]
    it = 4 if row["dtype"] == "float32" else 2
    nbytes = B * Fp * C * it + B * Fp * 4 + B * (Fp // 128) * 4 + B * E * C * 4
    return bound(B * Fp * C, nbytes, "float32")


def attn_flops(B, L, H, D):
    """Operations of each flash kernel: the causal (query, key) pairs this
    input has, 2*D per pair and product (forward: s and PV; dq: s, dp, dq;
    dk/dv: s, dp, dv, dk)."""
    pairs = B * H * L * (L + 1) // 2
    return {"fwd": 4 * pairs * D, "dq": 6 * pairs * D, "dkv": 8 * pairs * D}


def attn_bounds(B, L, H, D, dtype, float_cores=False):
    """Bound of each flash kernel: its operations (``attn_flops``) on the
    tensor cores (bf16 and float16 at their one rate), float32 as
    FP32_PASSES bf16 passes (the least work that keeps float32 accuracy
    there), each [B, L, H, D] tensor and [B*H, L] statistic read or written
    once. ``float_cores``: float32 at the float cores' peak instead (the
    bound of a kernel on the CUDA cores)."""
    flops = attn_flops(B, L, H, D)
    x = B * L * H * D * (4 if dtype == "float32" else 2)
    st = B * H * L * 4
    nbytes = {"fwd": 4 * x + st, "dq": 5 * x + 2 * st, "dkv": 6 * x + 2 * st}
    if dtype != "float32" or float_cores:
        return {k: bound(flops[k], nbytes[k], dtype) for k in flops}
    out = {}
    for k in flops:
        ms, by = bound(FP32_PASSES * flops[k], nbytes[k], "bfloat16")
        out[k] = (ms, by + (", six bf16 passes" if by == "operations" else ""))
    return out


def swapped_to_plain_attn(fn):
    """Run ``fn`` with the three flash kernels swapped for their plain
    versions (restored afterwards)."""
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    real = fa.flash_fwd, fa.flash_dq, fa.flash_dkv
    fa.flash_fwd, fa.flash_dq, fa.flash_dkv = (
        fa.flash_fwd_plain, fa.flash_dq_plain, fa.flash_dkv_plain)
    try:
        return fn()
    finally:
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv = real


@contextlib.contextmanager
def plain_attn_calls():
    """Counts, in the list it yields, the calls of the plain flash versions
    (``flash_fwd_plain``, ``flash_dq_plain``, ``flash_dkv_plain``, which
    the wrappers take only for CPU tensors) made inside the block."""
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    names = ("flash_fwd_plain", "flash_dq_plain", "flash_dkv_plain")
    real = {n: getattr(fa, n) for n in names}
    calls = [0]

    def counted(f):
        def call(*args):
            calls[0] += 1
            return f(*args)
        return call

    for n, f in real.items():
        setattr(fa, n, counted(f))
    try:
        yield calls
    finally:
        for n, f in real.items():
            setattr(fa, n, f)


def attn_counts():
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    return fa.fwd_launches, fa.dq_launches, fa.dkv_launches


def reset_attn_counts():
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0


def attn_err(a, b):
    """(max|a - b|, max|b|, the largest ratio of |a - b| to its tolerance)
    of one flash output against its plain version. Float32 outputs (every
    fp32 one, and lse in every type) to 1e-4 of max|b|: the online softmax
    rescales in another order than the two-pass softmax. bf16 outputs
    ``[B, L, H, D]`` per element to 2^-7 |b| + 1e-2 rms_row(b) +
    1e-3 rms(b): the float results differ by a few float roundings, so
    their bf16 roundings are one bf16 step apart (2^-7 |b|) plus that
    difference; the largest difference is p's rounding to bf16 before PV
    at another point of the online softmax, a few thousandths of the
    row's rms (rms_row over D; a query's output row is ~30x larger when it
    averages one key than 2047 keys), carried into the backward by lse
    and delta; the last term covers rows whose exact value is 0 (the first
    query's dq) and hold float noise. float16 outputs to ``f16_tol``, the
    same form at float16's step."""
    import torch
    d = (a.float() - b.float()).abs()
    bf = b.float().abs()
    tol = (1e-4 * bf.max() if a.dtype == torch.float32 else
           f16_tol(b) if a.dtype == torch.float16 else bf16_tol(b))
    return d.max().item(), bf.max().item(), (d / tol).max().item()


def bf16_tol(b, steps=1):
    """Per-element tolerance of a result ``b`` whose float value is rounded
    to bf16 ``steps`` times on the way, when the other side forms those
    float values in another order: ``steps`` bf16 steps (2^-7 |b| each),
    plus 1e-2 of the rms over the last axis (a float difference where the
    row's terms cancel), plus 1e-3 of the tensor's rms (rows whose exact
    value is 0)."""
    sq = b.float().square()
    return (steps * 2 ** -7 * sq.sqrt() + 1e-2 * sq.mean(-1, keepdim=True).sqrt()
            + 1e-3 * sq.mean().sqrt())


def f16_tol(b):
    """Per-element tolerance of a float16 flash output ``b``: bf16_tol's
    form at float16's step, whose p rounds 8x finer: one float16 step
    (2^-10 |b|) + 1.25e-3 rms over the last axis + 1.25e-4 rms(b), plus
    one subnormal step (2^-24: the small cotangent's gradients lie there)."""
    sq = b.float().square()
    return (2 ** -10 * sq.sqrt() + 1.25e-3 * sq.mean(-1, keepdim=True).sqrt()
            + 1.25e-4 * sq.mean().sqrt() + 2 ** -24)


def flash_kernel_name(kind, dtype, hd):
    """The profiler's (demangled) name of a flash kernel instance, as a
    substring: the bf16 and float16 kernels are templates on the element
    type and the head dim (the pair kernels at 384 and 512), or, from 640,
    on the element type and the widest share (the cluster kernels, one
    instance for every head dim to 4096); the float32 ones on the head dim
    to 512, from 640 the instance <0> (SPLIT3_INSTANCES), one for every
    head dim to 2048, and past it the instance on 192-column shares."""
    if dtype == "float32" and hd > 2048:
        return f"flash_{kind}_shares3_kernel<{SHARES3_CMAX}>"
    if dtype == "float32":
        return f"flash_{kind}_split3_kernel<{hd if hd <= 512 else 0}>"
    elem = {"bfloat16": "__nv_bfloat16", "float16": "__half"}[dtype]
    if hd > 512:
        return f"flash_{kind}_cluster_kernel<{elem}, {CLUSTER16_CMAX}>"
    return f"flash_{kind}_{'pair' if hd > 256 else 'sm90'}_kernel<{elem}, {hd}>"


def attn_products(dtype, hd):
    """{kernel: [products it issues, products the function needs]}, each a
    product over the (query, key) pairs and the head dim: the forward needs
    s and PV, dq s, dp and dq, dk/dv s, dp, dv and dk. The 16-bit backward
    issues its float p and ds as two terms (dq 4, dk/dv 6), and dk/dv's two
    consumers each form s^T and dp^T at head dim 256 and up (8); float32
    issues every product as six bf16 products."""
    if dtype == "float32":
        return {"fwd": [12, 2], "dq": [18, 3], "dkv": [24, 4]}
    return {"fwd": [2, 2], "dq": [4, 3], "dkv": [6 if hd == 128 else 8, 4]}


def exact_yardstick(q):
    """Whether the flash kernels on ``q`` are held to their plain versions
    evaluated in float64 (the exact function, p unrounded; outputs rounded
    to q's type) rather than in float32: bf16 and float16 at head dims past
    512. There the float32 plain versions' own error reaches the
    tolerance: their sums' noise at rows whose exact dq and dk are 0 (the
    first query row, where dp - delta cancels; on an H100 at B8 L2047 H4
    D1024 in float16 the float32 plain dq 1.07 x ``f16_tol`` off the
    float64 one, the kernel's 0.37), and o's p rounded at another point of
    the softmax than the kernels' online one (float16 at a B2 L1000 H4 D768
    draw: kernel vs plain 1.003 x tolerance, the kernel's arithmetic
    emulated in PyTorch the same, each 0.73 and 0.69 off the float64
    function; bf16's o 0.92 at B8 L2047 H4 D1024)."""
    import torch
    return q.dtype in (torch.bfloat16, torch.float16) and q.shape[-1] > 512


def plain_fwd(q, k, v):
    """(o, lse) of the plain forward, the forward kernel's yardstick: in
    float32, or in float64 where ``exact_yardstick``."""
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    if not exact_yardstick(q):
        return fa.flash_fwd_plain(q, k, v)
    o, lse = fa.flash_fwd_plain(q.double(), k.double(), v.double())
    return o.to(q.dtype), lse.float()


def plain_bwd(q, k, v, g, lse, delta):
    """(dq, dk, dv) of the plain backward on these inputs, the backward
    kernels' yardstick: in float32, or in float64 where
    ``exact_yardstick``."""
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    if not exact_yardstick(q):
        return (fa.flash_dq_plain(q, k, v, g, lse, delta),
                *fa.flash_dkv_plain(q, k, v, g, lse, delta))
    wide = [x.double() for x in (q, k, v, g, lse, delta)]
    return tuple(x.to(q.dtype) for x in (fa.flash_dq_plain(*wide),
                                         *fa.flash_dkv_plain(*wide)))


def sdpa_backend(q, k, v):
    """The backend of PyTorch's causal SDPA on q, k, v ([B, H, L, D]): the
    one its dispatcher picks for these inputs (PyTorch's flash backend
    stops at head dim 256)."""
    import torch
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name


def check_attn_kernels(device):
    """Phase kernel-attn: forward, dq and dk/dv kernels against their plain
    versions at ATTN_SHAPES (the plain backward fed the plain forward's lse
    and delta, so a wrong lse shows in the gradients too; float16: fed the
    kernels' own, the plain forward's errors reported, and so is bf16 past
    head dim 512; both 16-bit types past head dim 512 forward and backward
    in float64, ``exact_yardstick``), two backward
    launches bit-identical; at the F16_G_SCALES rows the backward again with
    the cotangent scaled, against the plain versions fed the same (the
    small one's gradients nonzero); CUDA-event medians of kernel, plain and
    SDPA at the SFT shapes (L 2047)."""
    import torch
    import torch.nn.functional as F
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rows, bad = [], []
    for name, B, L, H, D, dtype in ATTN_SHAPES:
        t_row = time.perf_counter()
        q, k, v, g = (torch.randn((B, L, H, D), generator=gen, device=device)
                      .to(getattr(torch, dtype)) for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v)
        delta = fa.bwd_delta(o, g)
        got = (o, lse, fa.flash_dq(q, k, v, g, lse, delta),
               *fa.flash_dkv(q, k, v, g, lse, delta))
        again = (fa.flash_dq(q, k, v, g, lse, delta),
                 *fa.flash_dkv(q, k, v, g, lse, delta))
        torch.cuda.synchronize()
        po, plse = fa.flash_fwd_plain(q, k, v)
        pdelta = fa.bwd_delta(po, g)
        want = (po, plse, fa.flash_dq_plain(q, k, v, g, plse, pdelta),
                *fa.flash_dkv_plain(q, k, v, g, plse, pdelta))
        del pdelta
        row = dict(shape=name, B=B, L=L, H=H, D=D, dtype=dtype)
        if dtype == "float16" or exact_yardstick(q):
            # float16: the backward kernels are held to the plain backward on
            # their own inputs (the kernels' lse and delta); the gradients
            # from the plain forward's are reported, not held: p rounds to
            # float16 at 8x bf16's density of rounding points, so exp2f and
            # exp flip some p's last bit, and delta carries o's difference
            # into dq and dk of rows of few keys whose own values are small
            # (PERF.md §6, the float16 kernels). bf16 past head dim 512 too:
            # delta sums D products of o's difference, and at B8 L2047 H4
            # D1024 the plain forward's carried dq to 1.22 x tolerance (on
            # an H100)
            row["err_from_plain_forward_over_tol"] = {
                part: attn_err(a, b)[2]
                for part, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:])}
            want = (*plain_fwd(q, k, v), *plain_bwd(q, k, v, g, lse, delta))
        torch.cuda.synchronize()
        errs = {}
        for part, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
            errs[part] = attn_err(a, b)
            if not (a.dtype == b.dtype and torch.isfinite(a).all()
                    and errs[part][2] <= 1):
                bad.append(f"{name} {part}: max|d| {errs[part][0]}, max|ref| "
                           f"{errs[part][1]}, {errs[part][2]} x tolerance")
        if not all(torch.equal(a, b) for a, b in zip(got[2:], again)):
            bad.append(f"{name}: flash backward not bit-repeatable")
        row["err_ref_over_tol_by_output"] = errs
        for scale in F16_G_SCALES.get(name, ()):
            gs = (g.float() * scale).to(g.dtype)
            delta_s = fa.bwd_delta(o, gs)
            gots = (fa.flash_dq(q, k, v, gs, lse, delta_s),
                    *fa.flash_dkv(q, k, v, gs, lse, delta_s))
            wants = plain_bwd(q, k, v, gs, lse, delta_s)
            torch.cuda.synchronize()
            errs_s = {}
            for part, a, b in zip(("dq", "dk", "dv"), gots, wants):
                errs_s[part] = attn_err(a, b)
                if not (torch.isfinite(a).all() and errs_s[part][2] <= 1
                        and (scale > 1 or a.float().abs().max() > 0)):
                    bad.append(f"{name} dO x {scale} {part}: max|d| "
                               f"{errs_s[part][0]}, max|ref| {errs_s[part][1]}, "
                               f"{errs_s[part][2]} x tolerance")
            row.setdefault("g_scaled_err_ref_over_tol_by_output", {})[
                f"{scale:g}"] = errs_s
            del gs, wants, delta_s, gots
        if L == SFT_SEQ - 1 or name in TIMED_RAGGED:
            # sub-millisecond 16-bit kernels (head dims to 512) get more
            # launches per median
            timing = (dict(runs=10, reps=5, warmup=2)
                      if dtype != "float32" and D <= 512
                      else dict(runs=5, reps=2, warmup=1))
            bounds = attn_bounds(B, L, H, D, dtype)
            row["bound_ms"] = {k_: b_[0] for k_, b_ in bounds.items()}
            row["bound_by"] = {k_: b_[1] for k_, b_ in bounds.items()}
            if dtype == "float32":
                row["float_core_bound_ms"] = {
                    k_: b_[0] for k_, b_ in
                    attn_bounds(B, L, H, D, dtype, float_cores=True).items()}
            row["ms"] = {
                "fwd": median_ms(lambda: fa.flash_fwd(q, k, v), **timing),
                "dq": median_ms(lambda: fa.flash_dq(q, k, v, g, lse, delta),
                                **timing),
                "dkv": median_ms(lambda: fa.flash_dkv(q, k, v, g, lse, delta),
                                 **timing)}
            flops = attn_flops(B, L, H, D)
            row["bound_share"] = {k_: row["bound_ms"][k_] / ms
                                  for k_, ms in row["ms"].items()}
            row["tflops"] = {k_: flops[k_] / ms / 1e9
                             for k_, ms in row["ms"].items()}
            row["products_issued_needed"] = attn_products(dtype, D)
            # the plain versions take 3-55 ms a call: five medians of two
            row["plain_ms"] = {
                "fwd": median_ms(lambda: fa.flash_fwd_plain(q, k, v),
                                 **PLAIN_TIMING),
                "dq": median_ms(lambda: fa.flash_dq_plain(q, k, v, g, lse,
                                                          delta),
                                **PLAIN_TIMING),
                "dkv": median_ms(lambda: fa.flash_dkv_plain(q, k, v, g, lse,
                                                            delta),
                                 **PLAIN_TIMING)}
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            with torch.no_grad():
                row["sdpa_fwd_ms"] = median_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True),
                    **timing)
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            gt = g.transpose(1, 2)
            row["sdpa_bwd_ms"] = median_ms(
                lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                            retain_graph=True), **timing)
            row["sdpa_backend"] = sdpa_backend(qt, kt, vt)
            del qt, kt, vt, out
        row["wall_s"] = time.perf_counter() - t_row
        log("kernel-attn", json.dumps(row))
        rows.append(row)
        del q, k, v, g, o, lse, delta, got, again, want, po, plse
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError("flash kernels vs plain: " + "; ".join(bad))
    return rows


def other_head_dim(attn_rows, dtype, hd, key, parts):
    """A 16-bit cluster kernel's figures at a head dim that no path of this
    script runs (its B2 L1000 H2 row of ``check_attn_kernels``): ms, plain
    ms, bound, SDPA's time, the largest error over its tolerance."""
    row = next(r for r in attn_rows if r["D"] == hd and r["dtype"] == dtype
               and r["shape"].startswith("ragged_b2_l1000"))
    return dict(shape=row["shape"], ms=row["ms"][key],
                plain_ms=row["plain_ms"][key], bound_ms=row["bound_ms"][key],
                bound_share=row["bound_share"][key],
                library_ms=row["sdpa_fwd_ms"] if key == "fwd" else None,
                **({} if key == "fwd" else
                   {"sdpa_bwd_ms_dq_dk_dv_together": row["sdpa_bwd_ms"]}),
                max_err_over_tol=max(row["err_ref_over_tol_by_output"][p][2]
                                     for p in parts))


def sft_data(root):
    """The RoG recipe's data: a SynthQSP split from the port's generator,
    its questions in the RoG schema, ``preprocess_qa`` texts (ground-truth
    paths in the llama2 prompt, 2048 - 200 byte tokens of budget) as JSONL;
    returns (train JSONL path, 8 test prompts as byte-token ids)."""
    import random

    from gnn_rag_tpu_torch.finetune.data_prep import preprocess_qa, rog_example
    from gnn_rag_tpu_torch.llm.sft import RESPONSE_TEMPLATE
    from gnn_rag_tpu_torch.llm.tokenizers import ByteTokenizer
    refbench(root, n_train=64, n_dev=1, n_test=8)
    tok = ByteTokenizer()
    paths = {}
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}.json")) as f:
            rog = [rog_example(json.loads(line)) for line in f]
        random.seed(SEED)           # the prompt budget's shuffle-truncation
        paths[split] = os.path.join(root, f"{split}_qa.jsonl")
        preprocess_qa(rog, paths[split],
                      prompt_path=os.path.join(REPO, "prompts",
                                               "llama2_predict.txt"),
                      tokenize=lambda text: len(tok.encode(text)))
    with open(paths["test"]) as f:
        texts = [json.loads(line)["text"] for line in f]
    prompts = [tok.encode(t[:t.rindex(RESPONSE_TEMPLATE)
                            + len(RESPONSE_TEMPLATE)]) for t in texts]
    return paths["train"], prompts


def run_sft(device, root):
    """Phase sft: the RoG joint-finetune SFT through the port's entry
    (``python -m gnn_rag_tpu_torch.llm.sft``, run in this process) at
    LLaMA2-7B width cut to 4 layers, 8 steps at B8 x 2048 tokens; then the
    saved checkpoint reloaded and the run resumed from it."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.llm import sft
    from gnn_rag_tpu_torch.llm.tokenizers import ByteTokenizer

    t0 = time.perf_counter()
    train_path, prompts = sft_data(root)
    out_dir = os.path.join(root, "sft")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted: 8 SFT steps ----
    reset_attn_counts()
    t1 = time.perf_counter()
    trainer, losses = sft.main(["--data", train_path, "--output_dir", out_dir,
                                *SFT_FLAGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = attn_counts()
    steps = len(losses)
    per_step = trainer.model.cfg.n_layers
    if steps != SFT_STEPS or launches != (per_step * steps,) * 3:
        raise AssertionError(f"SFT: {steps} steps, flash launches {launches}; "
                             f"expected {per_step} per step each")
    if not (np.isfinite(losses).all()
            and np.mean(losses[-2:]) < losses[0]):
        raise AssertionError(f"SFT losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # ---- save, reload, resume ----
    trained = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    again = sft.SFTTrainer(trainer.model.cfg, trainer.cfg, device=device)
    if not (again.maybe_resume() and again.step == steps):
        raise AssertionError("SFT: no checkpoint to resume from")
    same = all(torch.equal(v.cpu(), trained[k])
               for k, v in again.model.state_dict().items())
    tok = ByteTokenizer()
    with open(train_path) as f:
        texts = [json.loads(line)["text"] for line in f]
    tokens, mask = sft.pack_examples(
        texts, tok.encode, tok.encode(sft.RESPONSE_TEMPLATE, add_bos=False),
        trainer.cfg.max_seq_len, tok.pad_id)
    more = again.train(tokens, mask, steps=steps + 1, resume=False,
                       log_every=10**9)
    if not (same and again.step == steps + 1 and np.isfinite(more).all()):
        raise AssertionError(f"SFT reload same={same}, resumed losses {more}")
    del again, trained
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    summary = dict(
        layers=per_step, dim=trainer.model.cfg.dim, params=n_params,
        examples=len(texts), steps=steps, losses=losses,
        flash_launches_fwd_dq_dkv=launches, wall_s=wall,
        setup_s=t1 - t0, peak_gb=peak_gb,
        mask_tokens_per_example=float(mask[:, 1:].sum(1).mean()),
        tokens_per_example=float((tokens != tok.pad_id).sum(1).mean()),
        reload_equal=same, resumed_loss=more)
    log("sft", json.dumps(summary))
    return summary, trainer, tokens, mask, prompts


def as_dtype(model, dtype):
    """A view of ``model`` computing in ``dtype``: the same parameter
    storage under another LlamaConfig.dtype."""
    import dataclasses

    import torch
    from gnn_rag_tpu_torch.llm.model import LlamaLM
    with torch.device("meta"):
        view = LlamaLM(dataclasses.replace(model.cfg, dtype=dtype))
    view.load_state_dict(model.state_dict(), assign=True)
    return view


def check_llm_grads(trainer, tokens, mask, device):
    """Phase grad (LLM): every parameter gradient of one B2 float32 batch
    through the flash kernels against the plain attention (1e-4 of the
    largest entry + 1e-7), and one bf16 step's gradients finite."""
    import torch
    from gnn_rag_tpu_torch.llm.sft import completion_loss
    tok = torch.from_numpy(tokens[:2]).to(device)
    msk = torch.from_numpy(mask[:2]).to(device)
    m32 = as_dtype(trainer.model, "float32")

    def grads(model):
        for p in model.parameters():
            p.grad = None
        completion_loss(model, tok, msk).backward()
        return {n: p.grad for n, p in model.named_parameters()}

    reset_attn_counts()
    got = grads(m32)
    torch.cuda.synchronize()
    launches = attn_counts()
    want = swapped_to_plain_attn(lambda: grads(m32))
    worst = (0.0, "", 0.0)
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        tol = 1e-4 * w.abs().max().item() + 1e-7
        if not err <= tol:
            raise AssertionError(f"LLM grad {name}: kernel vs plain {err} > {tol}")
        worst = max(worst, (err / tol, name, err))
    n = trainer.model.cfg.n_layers
    if launches != (n, n, n):
        raise AssertionError(f"grad: flash launches {launches}")
    del want, m32
    # bf16: the two paths round at different points, so their gradients
    # differ by bf16 noise; each parameter's kernel-vs-plain distance is held
    # to twice the plain path's own distance from the float32 gradient (two
    # paths of equal accuracy are sqrt(2) of it apart at most, when their
    # errors are independent); a wrong kernel is O(1) of the gradient away
    reset_attn_counts()
    bf = grads(trainer.model)
    torch.cuda.synchronize()
    bf_launches = attn_counts()
    bf_plain = swapped_to_plain_attn(lambda: grads(trainer.model))
    finite = all(torch.isfinite(g).all() for g in bf.values())
    ratios = {}
    for name, w in bf_plain.items():
        own = (w - got[name]).norm().item()
        ratios[name] = (bf[name] - w).norm().item() / max(own, 1e-30)
    for p in trainer.model.parameters():
        p.grad = None
    bf_worst = max(ratios, key=ratios.get)
    summary = dict(batch=2, params=len(bf), flash_launches=launches,
                   worst_err_over_tol=worst[0], worst_param=worst[1],
                   worst_err=worst[2], bf16_grads_finite=finite,
                   bf16_flash_launches=bf_launches,
                   bf16_worst_param=bf_worst,
                   bf16_worst_kernel_vs_plain_over_plain_vs_fp32=ratios[bf_worst],
                   bf16_median_ratio=sorted(ratios.values())[len(ratios) // 2])
    log("grad-llm", json.dumps(summary))
    del got, bf, bf_plain
    torch.cuda.empty_cache()
    if not (finite and bf_launches == (n, n, n) and ratios[bf_worst] <= 2):
        raise AssertionError(f"bf16 SFT gradients: finite {finite}, launches "
                             f"{bf_launches}, {bf_worst} kernel vs plain "
                             f"{ratios[bf_worst]} x plain vs fp32")
    return summary


def run_decode(trainer, prompts, device):
    """Phase decode: the trained reader decodes 8 test prompts greedily (32
    new tokens, eos 2) through the kv-cache Decoder; at float32, one
    prompt's last-position logits from the cache-free forward (the flash
    kernel, ragged L) and from the Decoder's prefill (plain attention over
    the cache) agree to 1e-4 of the largest logit."""
    import torch
    from gnn_rag_tpu_torch.llm.generate import Decoder
    from gnn_rag_tpu_torch.llm.tokenizers import ByteTokenizer
    model = trainer.model.eval()
    tok = ByteTokenizer()
    reset_attn_counts()
    t0 = time.perf_counter()
    outs = Decoder(model, max_len=2048).greedy_batch(prompts, 32, eos_id=2)
    wall = time.perf_counter() - t0
    if attn_counts() != (0, 0, 0) or len(outs) != len(prompts) or not all(
            1 <= len(o) <= 32 and all(0 <= i < model.cfg.vocab_size for i in o)
            for o in outs):
        raise AssertionError(f"greedy_batch: {outs}, launches {attn_counts()}")
    m32 = as_dtype(model, "float32").eval()
    ids = torch.tensor([prompts[0]], device=device)
    with torch.no_grad():
        reset_attn_counts()
        full = m32(ids)[0][0, -1]
        torch.cuda.synchronize()
        launches = attn_counts()
        pre = Decoder(m32, max_len=ids.shape[1]).prefill(
            ids, torch.ones(ids.shape, device=device))[0][0, -1]
    diff = (full - pre).abs().max().item()
    scale = full.abs().max().item()
    n = model.cfg.n_layers
    if not (launches == (n, 0, 0) and diff <= 1e-4 * scale):
        raise AssertionError(f"decode cross-check: launches {launches}, "
                             f"max|d| {diff} vs {scale}")
    model.train()
    summary = dict(prompts=len(prompts),
                   prompt_tokens=[len(p) for p in prompts],
                   new_tokens=[len(o) for o in outs], wall_s=wall,
                   first_answers=[tok.decode(o) for o in outs[:2]],
                   crosscheck_len=ids.shape[1], crosscheck_launches=launches,
                   crosscheck_max_abs_diff=diff, crosscheck_max_abs_logit=scale)
    log("decode", json.dumps(summary))
    return summary


def pct(ms):
    """p10 / p50 / p90 of a list of milliseconds."""
    import numpy as np
    return {f"p{q}_ms": float(np.percentile(ms, q)) for q in (10, 50, 90)}


def attention_sum_err(info):
    """The largest |sum - 1| of the `.info` attention rows, each over its
    tolerance: 1e-5 plus the 6-decimal rounding of each entry (5e-7)."""
    worst, rows = 0.0, 0
    for line in info:
        for j in range(len(line)):
            slot = line.get(str(j))
            if not slot:
                continue
            att = slot["attention"]
            worst = max(worst, abs(sum(att) - 1.0) / (1e-5 + 5e-7 * len(att)))
            rows += 1
    return worst, rows


def run_qa(device, train_root, sft_trainer, root):
    """Phase qa: the RAG half end to end over the retriever of run_train
    (its final checkpoint and SynthQSP test split in ``train_root``) and
    the reader of run_sft, saved as a bundle in ``root``. Returns (summary,
    K1 launches during /answer, flash forward launches of the beam
    rescoring)."""
    import argparse
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from gnn_rag_tpu_torch import cli, serve_qa
    from gnn_rag_tpu_torch.finetune.data_prep import rog_example
    from gnn_rag_tpu_torch.llm.generate import Decoder, _left_pad
    from gnn_rag_tpu_torch.llm.tokenizers import ByteTokenizer
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    from gnn_rag_tpu_torch.rag import gen_rule_path, predict
    from gnn_rag_tpu_torch.rag.llms import get_registed_model
    from gnn_rag_tpu_torch.utils.checkpoint import save_state

    t0 = time.perf_counter()
    # ---- the reader as a bundle, loaded through the registry ----
    bundle = os.path.join(root, "reader")
    save_state(os.path.join(bundle, "checkpoint.pt"),
               sft_trainer.model.state_dict())
    with open(os.path.join(bundle, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(sft_trainer.model.cfg), f)
    flags = HEADLINE_FLAGS + ["--data_folder", train_root + "/",
                              "--checkpoint_dir",
                              os.path.join(train_root, "ckpt"),
                              "--experiment_name", "smoke",
                              "--load_experiment", "smoke-final.ckpt"]
    with open(os.path.join(train_root, "test.json")) as f:
        questions = [json.loads(line) for line in f]
    httpd = serve_qa.main(flags + ["--port", "0", "--reader", "llama_tpu",
                                   "--reader_path", bundle], block=False)
    qa, reader = httpd.service, httpd.service.reader
    budget = reader.maximun_token
    if get_registed_model("llama_tpu") is not type(reader):
        raise AssertionError(f"reader {type(reader)}")
    setup = time.perf_counter() - t0
    url = f"http://localhost:{httpd.server_port}/answer"

    # ---- the main path, counted: POST /answer ----
    lat = {1: [], 16: []}
    results = []
    try:
        torch.cuda.synchronize()
        reset_gate_counts()
        reset_attn_counts()
        for n, reps in ((1, QA_SINGLE_REQUESTS), (16, 4)):
            for i in range(reps):
                batch = [questions[(i * n + k) % len(questions)]
                         for k in range(n)]
                t = time.perf_counter()
                results += post(url, batch)
                lat[n].append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        launches, flash = gs.launches, attn_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
    if not (launches > 0 and flash == (0, 0, 0)):
        raise AssertionError(f"/answer: gate-scatter launches {launches}, "
                             f"flash launches {flash}")
    over = [r for r in results if not isinstance(r["prediction"], str)
            or "Reasoning Paths:" not in r["prompt"]
            or reader.tokenize(r["prompt"]) > reader.maximun_token]
    if len(results) != QA_SINGLE_REQUESTS + 64 or over:
        raise AssertionError(f"/answer: {len(results)} results, "
                             f"{len(over)} malformed or over budget")

    # ---- one request's stages, and generate_sentence vs Decoder.greedy ----
    def synced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    stages = {k: [] for k in ("retrieve", "prompt", "prefill", "decode",
                              "answer")}
    for q in questions[:QA_STAGE_QUESTIONS]:
        got, ms = synced(lambda: qa.retriever.retrieve([q], with_paths=False))
        stages["retrieve"].append(ms)
        (prompt,), ms = synced(lambda: qa.prompts([q], got))
        stages["prompt"].append(ms)
        ids = reader.tok.encode(prompt)[-reader.maximun_token:]
        toks, mask = _left_pad([ids], budget=reader.decoder.max_len
                               - reader.max_new)
        with torch.no_grad():
            _, ms = synced(lambda: reader.decoder.prefill(
                torch.from_numpy(toks).long().to(device),
                torch.from_numpy(mask).to(device)))
        stages["prefill"].append(ms)
        text, ms = synced(lambda: reader.generate_sentence(prompt))
        stages["decode"].append(ms - stages["prefill"][-1])
        _, ms = synced(lambda: qa.answer([q]))
        stages["answer"].append(ms)
    greedy = reader.tok.decode(reader.decoder.greedy(
        ids, reader.max_new, reader.tok.eos_id)).strip()
    if text != greedy:
        raise AssertionError("generate_sentence differs from Decoder.greedy")

    # ---- the .info with --info_attention, then predict_answers ----
    cli.run(flags + ["--is_eval", "--info_attention"])
    info_path = os.path.join(train_root, "smoke_test.info")
    shutil.copy(os.path.join(train_root, "ckpt", "smoke_test.info"), info_path)
    with open(info_path) as f:
        info = [json.loads(line) for line in f]
    att_err, att_rows = attention_sum_err(info)
    if len(info) != len(questions) or not att_rows or att_err > 1:
        raise AssertionError(f".info attention: {att_rows} rows, worst "
                             f"|sum - 1| {att_err} x its tolerance")
    qa_path = os.path.join(train_root, "test_rog.jsonl")
    with open(qa_path, "w") as f:
        for q in questions:
            f.write(json.dumps(rog_example(q)) + "\n")
    prompt_path = os.path.join(REPO, "prompts", "llama2_predict.txt")

    def predict_with(**kw):
        cfg = predict.PredictConfig(
            data_path=qa_path, predict_path=os.path.join(root, "pred"),
            prompt_path=prompt_path, rule_path_g1=info_path,
            entities_names_path=None, max_new_tokens=64, **kw)
        t = time.perf_counter()
        out = predict.predict_answers(cfg)
        secs = time.perf_counter() - t
        with open(out) as f:
            rows = [json.loads(line) for line in f]
        with open(out.replace("predictions.jsonl", "eval_result.txt")) as f:
            words = f.read().split()
        scores = dict(zip(words[::2], map(float, words[1::2])))
        if len(rows) != len(questions) or not all(
                isinstance(r["prediction"], str) for r in rows):
            raise AssertionError(f"predict_answers {kw}: {len(rows)} rows")
        return dict(hit=scores["Hit:"], f1=scores["F1:"],
                    questions_per_s=len(rows) / secs)

    del qa, reader, httpd
    torch.cuda.empty_cache()
    scored = {"mock": predict_with(model_name="mock")}
    scored["llama_tpu_b8"] = predict_with(model_name="llama_tpu",
                                          model_path=bundle, batch_size=8,
                                          device=device.type)

    # ---- beams: gen_rule_path, the "+RA" prompts, and a rescoring ----
    model = sft_trainer.model.eval()
    t = time.perf_counter()
    rules = gen_rule_path.gen_prediction(
        gen_rule_path.GenRulePathConfig(
            data_path=qa_path, output_path=os.path.join(root, "rules"),
            prompt_path=os.path.join(REPO, "prompts", "llama2.txt"),
            n_beam=3, max_new_tokens=32),
        gen_rule_path.TorchSeqGenerator(model, ByteTokenizer(),
                                        device=device.type))
    beam_secs = time.perf_counter() - t
    with open(rules) as f:
        rule_rows = [json.loads(line) for line in f]
    if len(rule_rows) != len(questions) or any(
            len(r["raw_output"]["paths"]) != 3
            or r["raw_output"]["scores"] != sorted(r["raw_output"]["scores"],
                                                   reverse=True)
            for r in rule_rows):
        raise AssertionError("gen_rule_path: rows or unsorted beams")
    scored["mock_plus_ra"] = predict_with(model_name="mock", add_rule=True,
                                          rule_path=rules)
    m32 = as_dtype(model, "float32").eval()
    tok = ByteTokenizer()
    ids = tok.encode(rule_rows[0]["input"])
    seqs, scores, _ = Decoder(m32, max_len=1024).beam_search(
        ids, num_beams=3, max_new_tokens=32, eos_id=tok.eos_id)
    rescore = []
    reset_attn_counts()
    with torch.no_grad():
        for seq, score in zip(seqs, scores):
            full = torch.tensor([ids + seq], device=device)
            lp = torch.log_softmax(m32(full)[0][0, len(ids) - 1:-1], dim=-1)
            total = lp.gather(1, full[0, len(ids):, None]).sum().item()
            rescore.append((total, float(score) * len(seq)))
    torch.cuda.synchronize()
    rescore_flash = attn_counts()
    model.train()
    bad = [(a, b) for a, b in rescore if not abs(a - b) <= 1e-4 * abs(a)]
    if (bad or list(scores) != sorted(scores, reverse=True)
            or rescore_flash[0] != len(seqs) * model.cfg.n_layers):
        raise AssertionError(f"beam rescoring {rescore}, flash launches "
                             f"{rescore_flash}")
    del m32
    torch.cuda.empty_cache()

    summary = dict(
        wall_s=time.perf_counter() - t0, setup_s=setup,
        requests={n: len(v) for n, v in lat.items()},
        **{f"answer_b{n}": pct(v) for n, v in lat.items()},
        stage_ms_one_question={k: pct(v)["p50_ms"] for k, v in stages.items()},
        gate_launches_answer=launches, flash_launches_answer=flash,
        reader_budget_tokens=budget,
        prompt_tokens_p50=float(np.median([len(tok.encode(r["prompt"]))
                                           for r in results])),
        info_attention_rows=att_rows, info_attention_worst_over_tol=att_err,
        scores=scored, beam_questions_per_s=len(rule_rows) / beam_secs,
        beam_rescore_sum_logprob_vs_score_x_len=rescore,
        beam_rescore_flash_launches=rescore_flash,
        note="random weights: Hit and F1 show that the chain runs, not the "
             "quality of the answers")
    log("qa", json.dumps(summary))
    return summary, launches, rescore_flash[0]


def sft_step_time(trainer, tokens, mask, device):
    """Phase step-time (LLM): ms per SFT step (CUDA events over 2 steps
    after one warm-up; kernel, plain, plain, kernel) at B8 on the kernel
    path and at the largest batch that fits on the plain path; positions/s
    (every one of the b x 2047 predicted positions, padding included) and
    non-pad tokens/s (the batch's tokens that are not padding); peak
    memory; one kernel-path step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnn_rag_tpu_torch.llm.tokenizers import ByteTokenizer
    tok = torch.from_numpy(tokens[:8]).to(device)
    msk = torch.from_numpy(mask[:8]).to(device)
    pad_id = ByteTokenizer().pad_id

    def ms_per_step(b, n=2):
        trainer.train_step(tok[:b], msk[:b])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            trainer.train_step(tok[:b], msk[:b])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    def plain_ms():
        for b in (8, 4, 2, 1):
            try:
                return b, swapped_to_plain_attn(lambda: ms_per_step(b))
            except torch.cuda.OutOfMemoryError:
                for p in trainer.params:
                    p.grad = None
                torch.cuda.empty_cache()
        raise AssertionError("plain path: no batch fits")

    kernel, plain = [], []
    torch.cuda.reset_peak_memory_stats()
    kernel.append(ms_per_step(8))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for _ in range(2):
        plain.append(plain_ms())
    kernel.append(ms_per_step(8))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_step(tok, msk)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    flash_ms = sum(e.self_device_time_total for e in dev
                   if "flash_" in e.key) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    def rates(b, ms):
        """(positions/s, non-pad tokens/s) of a b-example step of ms."""
        nonpad = (tok[:b] != pad_id).sum().item()
        return 1e3 * b * (tok.shape[1] - 1) / ms, 1e3 * nonpad / ms

    summary = dict(
        batch=8, seq=int(tok.shape[1]), ms_per_step_kernel=kernel,
        positions_and_nonpad_tokens_per_s_kernel=[rates(8, x) for x in kernel],
        nonpad_tokens_per_example=(tok != pad_id).sum().item() / 8,
        peak_gb_kernel=peak_gb,
        plain_batch_ms=plain,
        positions_and_nonpad_tokens_per_s_plain=[rates(b, x) for b, x in plain],
        profiled_step_wall_ms=wall, device_ms=dev_ms,
        busy_share=dev_ms / wall if dev_ms else "not measured",
        flash_device_ms=flash_ms,
        flash_share=flash_ms / dev_ms if dev_ms else "not measured",
        device_kernels_per_step=sum(e.count for e in dev),
        top_device_ops=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                        for e in top])
    log("step-time-llm", json.dumps(summary))
    return summary


def sft_fp32_step_time(tokens, mask, device):
    """Phase step-time-llm-fp32: the SFT step computing in float32 (``--dtype
    float32``: every attention on the float32 flash kernels) at LLaMA2-7B
    width cut to 4 layers, B2 x 2048 (f32 params, grads and AdamW states
    ~17 GB): ms a step (CUDA events over FP32_STEPS steps after one
    warm-up), the flash launches of those steps and of one profiled step
    (n_layers of each kernel a step), and each flash kernel's device ms and
    the largest device ops in the profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnn_rag_tpu_torch.llm import sft
    from gnn_rag_tpu_torch.llm.model import LlamaConfig
    t0 = time.perf_counter()
    trainer = sft.SFTTrainer(
        LlamaConfig(n_layers=4, max_seq_len=SFT_SEQ, dtype="float32"),
        sft.SFTConfig(batch_size=2, max_seq_len=SFT_SEQ, learning_rate=3e-4,
                      warmup_steps=100, total_steps=FP32_STEPS + 2,
                      seed=SEED), device=device)
    tok = torch.from_numpy(tokens[:2]).to(device)
    msk = torch.from_numpy(mask[:2]).to(device)
    setup = time.perf_counter() - t0
    # ---- the main path, counted: the float32 SFT steps ----
    reset_attn_counts()
    with plain_attn_calls() as plain:
        losses = [trainer.train_step(tok, msk)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FP32_STEPS):
            losses.append(trainer.train_step(tok, msk))
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / FP32_STEPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            losses.append(trainer.train_step(tok, msk))
            torch.cuda.synchronize()
    launches = attn_counts()
    plain_calls = plain[0]
    n = trainer.model.cfg.n_layers
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    flash = {name: [sum(e.self_device_time_total for e in dev
                        if kernel in e.key) / 1e3,
                    sum(e.count for e in dev if kernel in e.key)]
             for name, kernel in (("fwd", "flash_fwd_split3_kernel<128>"),
                                  ("dq", "flash_dq_split3_kernel<128>"),
                                  ("dkv", "flash_dkv_split3_kernel<128>"))}
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    losses = [x.item() for x in losses]
    summary = dict(layers=n, batch=2, seq=SFT_SEQ, ms_per_step=ms,
                   steps_timed=FP32_STEPS, setup_s=setup, losses=losses,
                   flash_launches_fwd_dq_dkv=launches,
                   plain_attention_calls=plain_calls,
                   profiled_step_device_ms=dev_ms,
                   flash_device_ms_launches=flash,
                   top_device_ops=[[e.key[:60], e.self_device_time_total / 1e3,
                                    e.count] for e in top],
                   wall_s=time.perf_counter() - t0)
    log("step-time-llm-fp32", json.dumps(summary))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if launches != (n * (FP32_STEPS + 2),) * 3 or plain_calls or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"fp32 SFT: flash launches {launches}, plain "
                             f"attention calls {plain_calls}, losses {losses}")
    return summary


def token_logprobs(model, tokens):
    """Per-position log-probabilities [B, L-1] float32 of ``tokens``' next
    tokens under ``model``'s cache-free forward (no autograd)."""
    import torch
    with torch.no_grad():
        logits, _ = model(tokens[:, :-1])
        return torch.log_softmax(logits, dim=-1).gather(
            -1, tokens[:, 1:, None])[..., 0]


def kernel_vs_plain(model, fn):
    """(kernel path, plain-attention path, float32 path) of ``fn(model)``
    and the kernel-vs-plain distance over the plain path's own distance
    from float32 (the float32 path through the plain versions, so that the
    yardstick stays off the float32 kernels): two paths of equal accuracy
    are within sqrt(2) of it when their roundings are independent, a wrong
    kernel O(1) of the result away."""
    kernel = fn(model)
    plain = swapped_to_plain_attn(lambda: fn(model))
    fp32 = swapped_to_plain_attn(lambda: fn(as_dtype(model, "float32")))
    own = (plain - fp32).norm().item()
    return kernel, plain, fp32, (kernel - plain).norm().item() / max(own, 1e-30)


def sft_entry_step_time(device, root, flags, phase):
    """The SFT through the port's entry (``python -m gnn_rag_tpu_torch.llm.
    sft``, run in this process) over the SFT phase's data with ``flags``,
    counted: its steps' flash launches (one forward, one dq and one dk/dv a
    layer and step, or it raises), no plain flash call, finite losses, the
    largest |dO| each flash backward received (``flash_dout_max``); then ms
    a step over D256_TIMED steps on the first step's batch (CUDA events),
    positions/s, peak GB and one profiled step (each flash kernel's device
    ms and launches: n_layers of each, at the run's type and head dim).
    Returns (trainer, summary, the first step's tokens and mask)."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnn_rag_tpu_torch.finetune.data_prep import load_multiple_datasets
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    from gnn_rag_tpu_torch.llm import sft
    from gnn_rag_tpu_torch.llm.tokenizers import ByteTokenizer
    t0 = time.perf_counter()
    train_path = os.path.join(root, "train_qa.jsonl")
    out_dir = os.path.join(root, phase)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted: the SFT entry point ----
    reset_attn_counts()
    with plain_attn_calls() as plain, flash_dout_max() as dout_max:
        trainer, losses = sft.main(["--data", train_path, "--output_dir",
                                    out_dir, *flags])
        torch.cuda.synchronize()
    launches, plain_calls = attn_counts(), plain[0]
    dout_max = torch.stack(dout_max) if dout_max else torch.zeros(1)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    wall = time.perf_counter() - t0
    shutil.rmtree(out_dir)                 # the checkpoint
    cfg, steps = trainer.model.cfg, trainer.cfg.total_steps
    n, batch = cfg.n_layers, trainer.cfg.batch_size
    want = (n * steps,) * 3
    if (cfg.head_dim not in fa.HEAD_DIMS[getattr(torch, cfg.dtype)]
            or len(losses) != steps
            or launches != want or plain_calls
            or not np.isfinite(losses).all()):
        raise AssertionError(f"{phase}: head dim {cfg.head_dim} {cfg.dtype}, "
                             f"losses {losses}, flash launches {launches} "
                             f"(want {want}), plain attention calls "
                             f"{plain_calls}")
    # the first step's batch, as the entry point packed and drew it
    tok = ByteTokenizer()
    data = load_multiple_datasets([train_path], shuffle=True, seed=SEED)
    tokens, mask = sft.pack_examples(
        [d["text"] for d in data], tok.encode,
        tok.encode(sft.RESPONSE_TEMPLATE, add_bos=False), SFT_SEQ, tok.pad_id)
    idx = trainer._batch_indices(len(tokens), 0)
    btok = torch.from_numpy(tokens[idx]).to(device)
    bmsk = torch.from_numpy(mask[idx]).to(device)

    # ---- step time, and one profiled step ----
    reset_attn_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(D256_TIMED):
        trainer.train_step(btok, bmsk)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / D256_TIMED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(btok, bmsk)
        torch.cuda.synchronize()
    timed_launches = attn_counts()
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    flash = {name: [sum(e.self_device_time_total for e in dev
                        if kernel in e.key) / 1e3,
                    sum(e.count for e in dev if kernel in e.key)]
             for name, kernel in (
                 (k, flash_kernel_name(k, cfg.dtype, cfg.head_dim))
                 for k in ("fwd", "dq", "dkv"))}
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    if (timed_launches != (n * (D256_TIMED + 1),) * 3
            or [flash[k][1] for k in ("fwd", "dq", "dkv")] != [n] * 3):
        raise AssertionError(f"{phase} timed steps: flash launches "
                             f"{timed_launches}, profiled {flash}")
    for p in trainer.params:
        p.grad = None
    summary = dict(
        layers=n, dim=cfg.dim, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, intermediate=cfg.intermediate,
        vocab=cfg.vocab_size, dtype=cfg.dtype, batch=batch, seq=SFT_SEQ,
        params=sum(p.numel() for p in trainer.model.parameters()),
        losses=losses, flash_launches_fwd_dq_dkv=launches,
        plain_attention_calls=plain_calls,
        flash_bwd_dout_absmax_max_min_calls=[
            dout_max.max().item(), dout_max.min().item(), len(dout_max)],
        entry_wall_s=wall, peak_gb=peak_gb, ms_per_step=ms,
        steps_timed=D256_TIMED,
        positions_per_s=1e3 * batch * (SFT_SEQ - 1) / ms,
        profiled_step_device_ms=dev_ms, flash_device_ms_launches=flash,
        flash_share=sum(v[0] for v in flash.values()) / dev_ms
        if dev_ms else "not measured",
        timed_flash_launches=timed_launches,
        top_device_ops=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                        for e in top])
    return trainer, summary, btok, bmsk


def first_loss_vs_plain(cfg, device, btok, bmsk):
    """(first loss with the kernels, with plain attention) of the model
    rebuilt from the seed on the first step's batch."""
    import torch

    from gnn_rag_tpu_torch.llm import sft
    from gnn_rag_tpu_torch.llm.model import build_llama
    init = build_llama(cfg, seed=SEED, device=device)
    with torch.no_grad():
        kernel = sft.completion_loss(init, btok, bmsk).item()
        plain = swapped_to_plain_attn(
            lambda: sft.completion_loss(init, btok, bmsk)).item()
    return init, kernel, plain


def sft_d256_step_time(device, root, prompts):
    """Phase step-time-llm-d256: the SFT at Gemma-2B's attention widths
    (D256_FLAGS, bf16) through the port's entry (``sft_entry_step_time``:
    D256_STEPS steps at B2 x 2048, the flash launches at head dim 256, ms a
    step, one profiled step); one no-cache scoring forward of the trained
    model (a test prompt's token log-probabilities: K5a, a launch a layer)
    against plain attention; and, with the trainer freed, the first step's
    loss against the same step's with the kernels swapped for their plain
    versions (the model rebuilt from the seed on the first step's batch)."""
    import torch
    t0 = time.perf_counter()
    trainer, summary, btok, bmsk = sft_entry_step_time(
        device, root, D256_FLAGS, "sft_d256")
    losses, cfg, n = summary["losses"], trainer.model.cfg, summary["layers"]
    if cfg.head_dim != 256:
        raise AssertionError(f"d256 SFT: head dim {cfg.head_dim}")

    # ---- a no-cache scoring forward of the trained model ----
    model = trainer.model.eval()
    prompt = torch.tensor([prompts[0]], device=device)
    reset_attn_counts()
    score, score_plain, score_fp32, score_ratio = kernel_vs_plain(
        model, lambda m: token_logprobs(m, prompt))
    score_launches = attn_counts()
    model.train()
    if not (score_launches == (n, 0, 0) and torch.isfinite(score).all()
            and score_ratio <= 2):
        raise AssertionError(f"d256 scoring forward: launches "
                             f"{score_launches}, kernel vs plain "
                             f"{score_ratio} x plain vs fp32")
    del trainer, model, score, score_plain, score_fp32
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the first step's loss, kernels against plain attention ----
    init, first_kernel, first_plain = first_loss_vs_plain(cfg, device, btok,
                                                          bmsk)
    nll_ratio = kernel_vs_plain(init, lambda m: token_logprobs(m, btok))[3]
    del init
    gc.collect()
    torch.cuda.empty_cache()
    summary.update(
        scoring_tokens=int(prompt.shape[1]),
        scoring_flash_launches=score_launches,
        scoring_kernel_vs_plain_over_plain_vs_fp32=score_ratio,
        first_loss_entry_kernel_plain=[losses[0], first_kernel, first_plain],
        first_nll_kernel_vs_plain_over_plain_vs_fp32=nll_ratio,
        wall_s=time.perf_counter() - t0)
    log("step-time-llm-d256", json.dumps(summary))
    # the entry point's first loss is this forward's (same weights, batch
    # and kernels); the plain path's within 1e-3 of it: the two round
    # attention to bf16 at other points, and the loss averages that noise
    # over the batch's masked positions
    if not (abs(first_kernel - losses[0]) <= 1e-5 * abs(losses[0])
            and abs(first_plain - losses[0]) <= 1e-3 * abs(losses[0])
            and nll_ratio <= 2):
        raise AssertionError(f"d256 first loss: entry {losses[0]}, kernel "
                             f"{first_kernel}, plain {first_plain}; per-token "
                             f"kernel vs plain {nll_ratio} x plain vs fp32")
    return summary


def sft_fp32_entry_step_time(device, root, prompts, flags, phase,
                             more_grads=()):
    """Phases step-time-llm-d256-fp32 (D256_FP32_FLAGS: Gemma-2B's attention
    widths cut to D256_FP32_LAYERS layers, the float32 kernels at head dim
    256), step-time-llm-d512-fp32 (D512_FP32_FLAGS: DeepSeek-V4-Flash's
    head shape, 2 layers, B2, the float32 kernels at head dim 512) and the
    head-dim-1024, 2048 and 2304 float32 phases (D1024_FP32_FLAGS,
    D2048_FP32_FLAGS, D2304_FP32_FLAGS): the SFT
    computing in float32 through the port's entry (``sft_entry_step_time``:
    D256_STEPS steps at 2048 tokens, the kernels' launches exact, ms a step,
    one profiled step); a no-cache scoring forward's token log-probabilities
    (K5a, a launch a layer) against plain attention within 1e-4 of
    max|plain|; with the trainer freed, the first step's loss, kernels and
    plain attention, each within 1e-5 of the entry's; and every parameter
    gradient of that batch on a 2-layer model at the run's widths (and at
    each of ``more_grads``' changes of them), kernels against plain
    attention (1e-4 of the largest entry + 1e-7, as check_llm_grads)."""
    import dataclasses

    import torch

    from gnn_rag_tpu_torch.llm import sft
    from gnn_rag_tpu_torch.llm.model import build_llama
    t0 = time.perf_counter()
    trainer, summary, btok, bmsk = sft_entry_step_time(
        device, root, flags, phase.replace("step-time-llm-", "sft_"))
    losses, cfg, n = summary["losses"], trainer.model.cfg, summary["layers"]
    if cfg.dtype != "float32":
        raise AssertionError(f"{phase}: {cfg.dtype}")

    # ---- a no-cache scoring forward of the trained model ----
    model = trainer.model.eval()
    prompt = torch.tensor([prompts[0]], device=device)
    reset_attn_counts()
    score = token_logprobs(model, prompt)
    score_launches = attn_counts()
    score_plain = swapped_to_plain_attn(lambda: token_logprobs(model, prompt))
    score_err = ((score - score_plain).abs().max().item(),
                 score_plain.abs().max().item())
    del trainer, model, score, score_plain
    gc.collect()
    torch.cuda.empty_cache()
    if not (score_launches == (n, 0, 0)
            and score_err[0] <= 1e-4 * score_err[1]):
        raise AssertionError(f"{phase} scoring forward: launches "
                             f"{score_launches}, max|kernel - plain|, "
                             f"max|plain| {score_err}")

    # ---- the first step's loss, kernels against plain attention ----
    init, first_kernel, first_plain = first_loss_vs_plain(cfg, device, btok,
                                                          bmsk)
    del init
    gc.collect()
    torch.cuda.empty_cache()

    # ---- every gradient of a 2-layer model, kernels against plain ----
    def grad_check(few):
        two = build_llama(few, seed=SEED, device=device)

        def grads():
            for p in two.parameters():
                p.grad = None
            sft.completion_loss(two, btok, bmsk).backward()
            return {name: p.grad for name, p in two.named_parameters()}

        reset_attn_counts()
        got = grads()
        torch.cuda.synchronize()
        launches = attn_counts()
        plain_grads = swapped_to_plain_attn(grads)
        worst, bad = (0.0, "", 0.0), []
        for name, w in plain_grads.items():
            err = (got[name] - w).abs().max().item()
            tol = 1e-4 * w.abs().max().item() + 1e-7
            if not (err <= tol and torch.isfinite(got[name]).all()):
                bad.append(f"d{few.head_dim} {name}: kernel vs plain {err} "
                           f"> {tol}")
            worst = max(worst, (err / tol, name, err))
        del two, got, plain_grads
        gc.collect()
        torch.cuda.empty_cache()
        return dict(flash_launches=launches, worst_err_over_tol=worst[0],
                    worst_param=worst[1], worst_err=worst[2]), bad

    checks, bad = {}, []
    for change in ({}, *more_grads):
        few = dataclasses.replace(cfg, n_layers=2, **change)
        checks[f"d{few.head_dim}"], more_bad = grad_check(few)
        bad += more_bad
    own = checks[f"d{cfg.head_dim}"]
    summary.update(
        scoring_tokens=int(prompt.shape[1]),
        scoring_flash_launches=score_launches,
        scoring_max_err_and_max_plain=score_err,
        first_loss_entry_kernel_plain=[losses[0], first_kernel, first_plain],
        grad_layers=2, grad_flash_launches=own["flash_launches"],
        grad_worst_err_over_tol=own["worst_err_over_tol"],
        grad_worst_param=own["worst_param"], grad_worst_err=own["worst_err"],
        **({"grads_by_head_dim": checks} if more_grads else {}),
        wall_s=time.perf_counter() - t0)
    log(phase, json.dumps(summary))
    grad_launches = {hd: c["flash_launches"] for hd, c in checks.items()}
    if not (abs(first_kernel - losses[0]) <= 1e-5 * abs(losses[0])
            and abs(first_plain - losses[0]) <= 1e-5 * abs(losses[0])
            and all(n == (2, 2, 2) for n in grad_launches.values())
            and not bad):
        raise AssertionError(f"{phase}: first loss entry {losses[0]}, "
                             f"kernel {first_kernel}, plain {first_plain}; "
                             f"gradient launches {grad_launches}; "
                             + "; ".join(bad))
    return summary


@contextlib.contextmanager
def flash_dout_max():
    """Records, in the list it yields, the largest |dO| of every call of
    ``flash_dq`` inside the block (a device scalar each: no sync), so that a
    step shows how small the cotangent that reaches the flash backward is."""
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    real, seen = fa.flash_dq, []

    def recorded(q, k, v, dout, lse, delta):
        seen.append(dout.detach().abs().amax().float())
        return real(q, k, v, dout, lse, delta)

    fa.flash_dq = recorded
    try:
        yield seen
    finally:
        fa.flash_dq = real


def grads_kernel_vs_plain(cfg, device, btok, bmsk):
    """Every parameter gradient of one B2 batch on a model of ``cfg`` built
    from the seed, kernels against plain attention: (flash launches, all
    finite, worst parameter, its kernel-vs-plain distance over the plain
    path's own distance from float32, the median of that ratio)."""
    import torch

    from gnn_rag_tpu_torch.llm import sft
    from gnn_rag_tpu_torch.llm.model import build_llama
    few = build_llama(cfg, seed=SEED, device=device)

    def grads(model):
        for p in model.parameters():
            p.grad = None
        sft.completion_loss(model, btok[:2], bmsk[:2]).backward()
        return {name: p.grad for name, p in model.named_parameters()}

    reset_attn_counts()
    got = grads(few)
    torch.cuda.synchronize()
    launches = attn_counts()
    plain_grads = swapped_to_plain_attn(lambda: grads(few))
    # the yardstick runs the plain versions, off the float32 kernels
    fp32 = swapped_to_plain_attn(lambda: grads(as_dtype(few, "float32")))
    ratios = {name: (got[name] - w).norm().item()
              / max((w - fp32[name]).norm().item(), 1e-30)
              for name, w in plain_grads.items()}
    finite = all(torch.isfinite(g).all() for g in got.values())
    worst = max(ratios, key=ratios.get)
    del few, got, plain_grads, fp32
    gc.collect()
    torch.cuda.empty_cache()
    return (launches, finite, worst, ratios[worst],
            sorted(ratios.values())[len(ratios) // 2])


def sft_16bit_step_time(device, root, flags, phase, more_grads=()):
    """Phases step-time-llm-f16 (F16_FLAGS: LLaMA2-7B width, 4 layers, B8),
    step-time-llm-d256-f16 (D256_F16_FLAGS: Gemma-2B's attention widths, 6
    layers, B2), step-time-llm-d512 and step-time-llm-d512-f16 (D512_FLAGS,
    D512_F16_FLAGS: DeepSeek-V4-Flash's head shape, bf16 and float16): the
    SFT computing in a 16-bit type through the port's entry
    (``sft_entry_step_time``: F16_STEPS steps, the kernels' launches exact,
    the largest |dO| each flash backward received, ms a step, one profiled
    step); with the trainer freed, the first step's loss, kernels and plain
    attention, against the entry's (kernels 1e-5 relative: the same
    forward; plain 1e-3: 16-bit attention rounded at other points, averaged
    over the batch's masked positions) and the token log-probs kernel vs
    plain within twice plain's own distance from float32
    (``kernel_vs_plain``); and every parameter gradient of one B2 batch on
    an F16_GRAD_LAYERS-layer model at the run's widths (and at each of
    ``more_grads``' changes of them), kernels vs plain attention, each
    within twice the plain 16-bit gradient's own distance from the float32
    one (as the bf16 gradient check)."""
    import dataclasses

    import torch
    t0 = time.perf_counter()
    trainer, summary, btok, bmsk = sft_entry_step_time(device, root, flags,
                                                       phase)
    losses, cfg = summary["losses"], trainer.model.cfg
    if cfg.dtype not in ("bfloat16", "float16"):
        raise AssertionError(f"{phase}: {cfg.dtype}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the first step's loss, kernels against plain attention ----
    init, first_kernel, first_plain = first_loss_vs_plain(cfg, device, btok,
                                                          bmsk)
    nll_ratio = kernel_vs_plain(init, lambda m: token_logprobs(m, btok))[3]
    del init
    gc.collect()
    torch.cuda.empty_cache()

    # ---- every gradient of one B2 batch, kernels against plain ----
    checks = {}
    for change in ({}, *more_grads):
        few = dataclasses.replace(cfg, n_layers=F16_GRAD_LAYERS, **change)
        checks[f"d{few.head_dim}"] = grads_kernel_vs_plain(few, device, btok,
                                                           bmsk)
    grad_launches, finite, worst, worst_ratio, median = checks[
        f"d{cfg.head_dim}"]
    summary.update(
        first_loss_entry_kernel_plain=[losses[0], first_kernel, first_plain],
        first_nll_kernel_vs_plain_over_plain_vs_fp32=nll_ratio,
        grad_layers=F16_GRAD_LAYERS, grad_batch=2,
        grad_flash_launches=grad_launches, grads_finite=finite,
        grad_worst_param=worst,
        grad_worst_kernel_vs_plain_over_plain_vs_fp32=worst_ratio,
        grad_median_ratio=median,
        **({"grads_by_head_dim": {
            hd: dict(flash_launches=c[0], finite=c[1], worst_param=c[2],
                     worst_kernel_vs_plain_over_plain_vs_fp32=c[3],
                     median_ratio=c[4]) for hd, c in checks.items()}}
           if more_grads else {}),
        wall_s=time.perf_counter() - t0)
    log(phase, json.dumps(summary))
    k = F16_GRAD_LAYERS
    bad_grads = {hd: c for hd, c in checks.items()
                 if not (c[0] == (k, k, k) and c[1] and c[3] <= 2)}
    if not (abs(first_kernel - losses[0]) <= 1e-5 * abs(losses[0])
            and abs(first_plain - losses[0]) <= 1e-3 * abs(losses[0])
            and nll_ratio <= 2 and not bad_grads):
        raise AssertionError(f"{phase}: first loss entry {losses[0]}, kernel "
                             f"{first_kernel}, plain {first_plain}; per-token "
                             f"kernel vs plain {nll_ratio} x plain vs fp32; "
                             f"gradients (launches, finite, worst parameter, "
                             f"its kernel vs plain over plain vs fp32, "
                             f"median) failing: {bad_grads}")
    return summary


# ------------------------------------- the reader at LLaMA2-7B, full depth
def lora_grads(model, lora, tokens, mask):
    """(loss, adapter gradients) of one LoRA loss and backward."""
    from gnn_rag_tpu_torch.llm.lora import LoRATrainer
    tr = LoRATrainer(model, lora, lr=0.0, alpha=LORA_ALPHA, r=LORA_R)
    loss = tr.loss(tokens, mask)
    loss.backward()
    return [loss.detach()] + [p.grad for p in tr.params]


def check_lora_depth2(device, tokens, mask):
    """At LLaMA2-7B width cut to 2 layers, B2 x 2,047, adapters with B
    drawn too (at init B = 0 and A's gradient is exactly 0): the adapter
    gradients with remat against without it (bf16, kernels; bit for bit,
    K5a 2 x 2 launches against 2), and with the kernels against plain
    attention by check_llm_grads' rule (float32: 1e-4 of the largest entry
    + 1e-7; bf16: within twice the plain bf16 gradient's distance from the
    float32 one)."""
    import dataclasses

    import torch
    from gnn_rag_tpu_torch.llm.lora import init_lora
    from gnn_rag_tpu_torch.llm.model import LlamaConfig, build_llama
    base = LlamaConfig(n_layers=2, remat=True)
    tok = torch.from_numpy(tokens[:2]).to(device)
    msk = torch.from_numpy(mask[:2]).to(device)

    def grads(dtype, remat=True, plain=False):
        model = build_llama(dataclasses.replace(base, dtype=dtype, remat=remat),
                            seed=SEED, device=device)
        gen = torch.Generator(device=device).manual_seed(SEED + 5)
        lora = init_lora(model, gen, r=LORA_R)
        for ab in lora.values():
            ab["b"].normal_(0.0, 0.02, generator=gen)
        reset_attn_counts()
        run = lambda: lora_grads(model, lora, tok, msk)
        out = swapped_to_plain_attn(run) if plain else run()
        torch.cuda.synchronize()
        return out, attn_counts()

    bf, bf_counts = grads("bfloat16")
    bf_no_remat, plain_counts = grads("bfloat16", remat=False)
    remat_equal = all(torch.equal(a, b) for a, b in zip(bf, bf_no_remat))
    f32, f32_counts = grads("float32")
    f32_plain, _ = grads("float32", plain=True)
    worst = max(((a - b).abs().max().item()
                 / (1e-4 * b.abs().max().item() + 1e-7))
                for a, b in zip(f32[1:], f32_plain[1:]))
    bf_plain, _ = grads("bfloat16", plain=True)
    ratios = [(a.float() - b.float()).norm().item()
              / max((b.float() - r).norm().item(), 1e-30)
              for a, b, r in zip(bf[1:], bf_plain[1:], f32_plain[1:])]
    out = dict(layers=2, batch=2, adapters=len(bf) - 1,
               remat_vs_no_remat_bit_equal=remat_equal,
               flash_launches_remat=bf_counts, flash_launches_no_remat=plain_counts,
               fp32_kernel_vs_plain_worst_over_tol=worst,
               fp32_loss_kernel_plain=[f32[0].item(), f32_plain[0].item()],
               bf16_worst_kernel_vs_plain_over_plain_vs_fp32=max(ratios),
               bf16_median_ratio=sorted(ratios)[len(ratios) // 2])
    if not (remat_equal and bf_counts == (4, 2, 2) and plain_counts == (2, 2, 2)
            and f32_counts == (4, 2, 2) and worst <= 1 and max(ratios) <= 2):
        raise AssertionError(f"LoRA at depth 2: {out}")
    return out


def run_lora(device, tokens, mask):
    """Phase lora: LoRA finetuning of the reader at LLaMA2-7B widths and the
    full 32 layers (``LlamaConfig()``: bf16 compute, float32 base from the
    seed, remat), r 8, alpha 16 on q_proj/v_proj, Adam 1e-4, 4 steps over
    B8 x 2,048 batches of the SFT phase's byte tokens. Checks: the merge at
    init leaves every weight bit for bit, the base is bit for bit the same
    after the steps, the adapters moved, the losses are finite, and the
    flash launch counts are exact (K5a twice a layer under remat, K5b and
    K5c once). Then the depth-2 gradient checks (``check_lora_depth2``).
    Returns (summary, the 32-layer model, launches (fwd, dq, dkv))."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.llm.lora import LoRATrainer, init_lora, merge_lora
    from gnn_rag_tpu_torch.llm.model import LlamaConfig, build_llama
    from gnn_rag_tpu_torch.llm.tokenizers import ByteTokenizer

    t0 = time.perf_counter()
    cfg = LlamaConfig(remat=True)
    model = build_llama(cfg, seed=SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    lora = init_lora(model, gen, r=LORA_R)
    base = model.state_dict()
    merged = merge_lora(base, lora, LORA_ALPHA, LORA_R)
    merge_equal = all(torch.equal(merged[k], base[k]) for k in lora)
    del merged
    kept = {k: v.cpu() for k, v in base.items()}
    init = {k: {n: t.clone() for n, t in ab.items()} for k, ab in lora.items()}
    tr = LoRATrainer(model, lora, lr=1e-4, alpha=LORA_ALPHA, r=LORA_R)
    batches = [(torch.from_numpy(tokens[8 * i:8 * i + 8]).to(device),
                torch.from_numpy(mask[8 * i:8 * i + 8]).to(device))
               for i in range(LORA_STEPS)]
    setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted: 4 LoRA steps ----
    reset_attn_counts()
    losses, step_ms = [], []
    for tok, msk in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = tr.train_step(tok, msk)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(loss.item())
    launches = attn_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n = cfg.n_layers
    want = (2 * n * LORA_STEPS, n * LORA_STEPS, n * LORA_STEPS)
    base_equal = all(torch.equal(v.cpu(), kept[k])
                     for k, v in model.state_dict().items())
    moved = {x: sum(not torch.equal(ab[x], init[k][x]) for k, ab in lora.items())
             for x in ("a", "b")}
    del kept, init, tr, lora
    torch.cuda.empty_cache()
    pad_id = ByteTokenizer().pad_id
    ms = float(np.median(step_ms[1:]))
    nonpad = float(np.mean([(t != pad_id).sum().item() for t, _ in batches]))
    depth2 = check_lora_depth2(device, tokens, mask)
    summary = dict(
        layers=n, dim=cfg.dim, dtype=cfg.dtype, remat=cfg.remat, r=LORA_R,
        alpha=LORA_ALPHA, adapters=2 * n, batch=8, seq=int(tokens.shape[1]),
        steps=LORA_STEPS, losses=losses, step_ms=step_ms, ms_per_step=ms,
        positions_per_s=1e3 * 8 * (tokens.shape[1] - 1) / ms,
        nonpad_tokens_per_s=1e3 * nonpad / ms, peak_gb=peak_gb,
        flash_launches_fwd_dq_dkv=launches, expected_launches=want,
        merge_at_init_bit_equal=merge_equal, base_bit_equal_after=base_equal,
        adapters_moved=moved, setup_s=setup, depth2=depth2,
        wall_s=time.perf_counter() - t0)
    log("lora", json.dumps(summary))
    if not (merge_equal and base_equal and launches == want
            and np.isfinite(losses).all() and moved == {"a": 2 * n, "b": 2 * n}):
        raise AssertionError(f"LoRA at 32 layers: {summary}")
    return summary, model.eval(), launches


def decode_bytes_per_token(state, dtype_bytes):
    """Bytes a greedy step at B1 moves for the projection weights of a
    state_dict, by the port's casts: ``TLinear`` reads a float32 weight and
    writes and reads its bf16 copy (4 + 2 + 2 bytes), ``QuantLinear`` reads
    the int8 weight and writes and reads the copy in its compute type (1 +
    c + c); the float32 head is not copied when float32 (4), the int8 head
    is copied to float32 (1 + 4 + 4). ``dtype_bytes``: 2 (bf16 compute).
    Returns (reckoned bytes, the fused ideal: each weight byte read once)."""
    reckoned = ideal = 0
    for name, t in state.items():
        module, _, leaf = name.rpartition(".")
        if leaf not in ("weight", "weight_q") or module == "tok_emb":
            continue
        n = t.numel()
        head = module == "lm_head"
        if leaf == "weight":
            reckoned += n * (4 if head else 4 + 2 * dtype_bytes)
            ideal += 4 * n
        else:
            c = 4 if head else dtype_bytes
            reckoned += n * (1 + 2 * c)
            ideal += n
    return reckoned, ideal


def greedy_ms(model, prompts, device, new=SERVE_NEW):
    """(ms a token of a greedy decode of ``new`` tokens after the prefill,
    prefill ms, tokens): the host clock around synchronised work, the
    prefill timed alone and taken off."""
    import torch
    from gnn_rag_tpu_torch.llm.generate import Decoder, _left_pad
    L = max(len(p) for p in prompts)
    dec = Decoder(model, max_len=L + 32 + new)
    toks, mask = _left_pad(prompts, budget=dec.max_len - new)
    with torch.no_grad():
        dec.prefill(torch.from_numpy(toks).long().to(device),
                    torch.from_numpy(mask).to(device))
        torch.cuda.synchronize()
        t = time.perf_counter()
        dec.prefill(torch.from_numpy(toks).long().to(device),
                    torch.from_numpy(mask).to(device))
        torch.cuda.synchronize()
        prefill = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    out = dec.greedy_batch(prompts, new)
    torch.cuda.synchronize()
    total = 1e3 * (time.perf_counter() - t)
    if not all(len(o) == new for o in out):
        raise AssertionError(f"greedy: {[len(o) for o in out]} tokens")
    return (total - prefill) / (new - 1), prefill, out


def decode_device_ms(model, prompt, device, new=9):
    """(device ms a greedy step at B1, the 4 largest device ops' ms a step)
    under torch.profiler: the CUDA time of a prefill and ``new`` tokens
    less that of the prefill alone, over ``new - 1`` steps ("not measured"
    where the profiler shows no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gnn_rag_tpu_torch.llm.generate import Decoder

    def device_ms(n):
        dec = Decoder(model, max_len=len(prompt) + 32 + new)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            dec.greedy(prompt, n)
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                if e.device_type.name == "CUDA" and e.self_device_time_total > 0}

    one, many = device_ms(1), device_ms(new)
    if not many:
        return "not measured", []
    steps = {k: (v - one.get(k, 0.0)) / (new - 1) for k, v in many.items()}
    top = sorted(steps.items(), key=lambda kv: -kv[1])[:4]
    return sum(steps.values()), [[k[:60], v] for k, v in top]


def run_serve_7b(device, model, draft_bundle, prompts):
    """Phase serve-7b: the 32-layer reader from the seed (the lora phase's
    base) quantized by ``quantize_state_dict``; one prompt's int8 logits
    against full precision (cosine, max relative error; float32 compute
    held to the JAX test's cos > 0.999, bf16 printed); 32 greedy tokens at
    B1 and B8, full precision and int8: ms a token (host clock; at B1 also
    the device ms a step under torch.profiler) beside the bytes a token
    reckoned from the casts and their floor at 3.35 TB/s, ``param_bytes``,
    peak GB; ``SpeculativeDecoder`` (gamma 4) with the int8 target and the
    sft phase's 4-layer reader as draft, and with the target as its own
    draft: its tokens equal the target's ``Decoder.greedy`` in float32
    compute; in bf16 the first index where they differ (if any) and the
    plain logits' top-2 gap there; ``last_stats`` and ms a token."""
    import dataclasses

    import torch
    from gnn_rag_tpu_torch.llm.generate import Decoder, SpeculativeDecoder
    from gnn_rag_tpu_torch.llm.model import LlamaLM
    from gnn_rag_tpu_torch.llm.quant import param_bytes, quantize_state_dict
    from gnn_rag_tpu_torch.rag.llms.llama_torch import bundle_checkpoint
    from gnn_rag_tpu_torch.utils.checkpoint import load_state

    t0 = time.perf_counter()
    cfg = model.cfg
    with torch.device("meta"):
        model_q = LlamaLM(dataclasses.replace(cfg, quant="int8"))
    torch.cuda.synchronize()
    t = time.perf_counter()
    model_q.load_state_dict(quantize_state_dict(model.state_dict()), assign=True)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t
    model_q.eval()
    bytes_f, bytes_q = (param_bytes(m.state_dict()) for m in (model, model_q))

    # ---- one prompt's logits, int8 against full precision ----
    ids = torch.tensor([prompts[0]], device=device)
    agree = {}
    for dtype in ("float32", "bfloat16"):
        with torch.no_grad():
            a = as_dtype(model, dtype)(ids)[0][0].double()
            b = as_dtype(model_q, dtype)(ids)[0][0].double()
        agree[dtype] = dict(
            cos=((a * b).sum() / (a.norm() * b.norm())).item(),
            max_rel_err=((a - b).abs().max() / a.abs().max()).item(),
            argmax_agree=(a.argmax(-1) == b.argmax(-1)).float().mean().item())
        del a, b
    # ---- greedy tokens at B1 and B8, full precision and int8 ----
    torch.cuda.reset_peak_memory_stats()
    decode = {}
    for name, m in (("full", model), ("int8", model_q)):
        reckoned, ideal = decode_bytes_per_token(m.state_dict(), 2)
        row = dict(param_bytes=bytes_f if name == "full" else bytes_q,
                   bytes_per_token_reckoned=reckoned,
                   floor_ms_reckoned=1e3 * reckoned / HBM_BYTES_PER_S,
                   bytes_per_token_fused_ideal=ideal,
                   floor_ms_fused_ideal=1e3 * ideal / HBM_BYTES_PER_S)
        for b in (1, 8):
            ms, prefill, _ = greedy_ms(m, prompts[:b], device)
            row[f"b{b}"] = dict(ms_per_token=ms, prefill_ms=prefill)
        row["b1"]["device_ms_per_token"], row["b1"]["top_device_ops_ms"] = (
            decode_device_ms(m, prompts[0], device))
        decode[name] = row
    decode_peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # ---- speculative decoding, gamma 4 ----
    with open(os.path.join(draft_bundle, "config.json")) as f:
        dcfg = type(cfg)(**json.load(f))
    with torch.device("meta"):
        draft = LlamaLM(dcfg)
    draft.load_state_dict(load_state(bundle_checkpoint(draft_bundle),
                                     draft.state_dict(), partial=False),
                          assign=True)
    draft = draft.to(device).eval()
    prompt = prompts[1]
    max_len = len(prompt) + SERVE_NEW + SPEC_GAMMA + 1
    spec = {}
    for dtype in ("float32", "bfloat16"):
        target = as_dtype(model_q, dtype).eval()
        t = time.perf_counter()
        want = Decoder(target, max_len=max_len).greedy(prompt, SERVE_NEW)
        torch.cuda.synchronize()
        greedy_ms_tok = 1e3 * (time.perf_counter() - t) / SERVE_NEW
        for name, d in (("sft_draft", as_dtype(draft, dtype)),
                        ("self_draft", target)):
            dec = SpeculativeDecoder(target, d, max_len=max_len, gamma=SPEC_GAMMA)
            t = time.perf_counter()
            got = dec.greedy(prompt, SERVE_NEW)
            torch.cuda.synchronize()
            row = dict(ms_per_token=1e3 * (time.perf_counter() - t) / len(got),
                       greedy_ms_per_token=greedy_ms_tok,
                       last_stats=dec.last_stats, equal_to_greedy=got == want)
            if got != want:
                # the first index where they differ, the plain logits' top-2
                # gap there, and the noise of a reordered sum at that
                # position: the cache-free forward against the kv-cache
                # prefill over the same tokens
                i = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                         min(len(got), len(want)))
                ctx = torch.tensor([prompt + want[:i]], device=device)
                with torch.no_grad():
                    logits = target(ctx)[0][0, -1]
                    cached = Decoder(target, max_len=ctx.shape[1]).prefill(
                        ctx, torch.ones(ctx.shape, device=device))[0][0, -1]
                top = logits.float().topk(2).values
                row.update(first_diff=i, top2_gap=(top[0] - top[1]).item(),
                           max_abs_logit=logits.abs().max().item(),
                           reordered_sum_noise=(logits - cached).abs().max().item())
            spec[f"{dtype}_{name}"] = row
    summary = dict(
        layers=cfg.n_layers, quantize_s=quantize_s, logits_int8_vs_full=agree,
        decode=decode, decode_peak_gb=decode_peak_gb, prompt_tokens=len(prompt),
        new_tokens=SERVE_NEW, gamma=SPEC_GAMMA, speculative=spec,
        note="random weights: acceptance says nothing of a trained draft",
        wall_s=time.perf_counter() - t0)
    log("serve-7b", json.dumps(summary))
    exact = all(spec[f"float32_{n}"]["equal_to_greedy"]
                for n in ("sft_draft", "self_draft"))
    # in bf16 a flip at a near tie is allowed; a gap of more than 8 times the
    # larger of the measured noise and a bf16 step of the largest logit is
    # not a near tie
    ties = all(row["equal_to_greedy"] or row["top2_gap"] <= 8 * max(
        row["reordered_sum_noise"], 2 ** -8 * row["max_abs_logit"])
        for row in spec.values())
    if not (exact and ties and agree["float32"]["cos"] > 0.999
            and agree["bfloat16"]["cos"] > 0.99 and bytes_q < 0.3 * bytes_f):
        raise AssertionError(f"serve-7b: {summary}")
    return summary


def run_reader_serving(device, llm_root, train_root):
    """Phase reader-serving: through the registry on bundles: the qa phase's
    4-layer reader bundle as target (its weights, with a config that
    computes in float32: speculative decoding gives greedy's tokens up to
    near ties that a reordered sum flips, so the equality is held in
    float32, as the JAX test holds it; serve-7b measures bf16) and a
    1-layer draft bundle from the seed. ``LlamaTorch --quant int8
    --draft_path`` generate_sentence equals ``LlamaTorch --quant int8``;
    the OpenAI-protocol server over the speculative backend, queried by
    ``LLMProxy``, returns the same text; ``generate_explanations`` with it
    as the teacher writes one line for each of the 16 SynthQSP test
    questions."""
    import argparse
    import dataclasses

    import torch
    from gnn_rag_tpu_torch.finetune.data_prep import (generate_explanations,
                                                      rog_example)
    from gnn_rag_tpu_torch.llm.model import LlamaConfig, build_llama
    from gnn_rag_tpu_torch.rag.llms import get_registed_model
    from gnn_rag_tpu_torch.rag.llms.serving import LLMProxy, OpenAIProtocolServer
    from gnn_rag_tpu_torch.utils.checkpoint import save_state

    t0 = time.perf_counter()
    src = os.path.join(llm_root, "reader")
    bundle, draft_dir = (os.path.join(llm_root, x) for x in ("reader_f32", "draft"))
    with open(os.path.join(src, "config.json")) as f:
        cfg = dataclasses.replace(LlamaConfig(**json.load(f)), dtype="float32")
    os.makedirs(bundle)
    os.link(os.path.join(src, "checkpoint.pt"),
            os.path.join(bundle, "checkpoint.pt"))
    with open(os.path.join(bundle, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    save_state(os.path.join(draft_dir, "checkpoint.pt"),
               build_llama(dcfg, seed=SEED + 4, device=device).state_dict())
    with open(os.path.join(draft_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(dcfg), f)

    def reader(**kw):
        r = get_registed_model("llama_tpu")(argparse.Namespace(
            model_path=bundle, max_new_tokens=SERVE_NEW, device=device.type,
            quant="int8", spec_gamma=SPEC_GAMMA, **kw))
        r.prepare_for_inference()
        return r

    fast, plain = reader(draft_path=draft_dir), reader(draft_path=None)
    with open(os.path.join(train_root, "test.json")) as f:
        rog = [rog_example(json.loads(line)) for line in f]
    texts, ms = {}, {}
    for name, r in (("spec", fast), ("plain", plain)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        texts[name] = [r.generate_sentence(q["question"]) for q in rog[:4]]
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t) / 4
    stats = fast.spec.last_stats
    server = OpenAIProtocolServer(fast, model_name="reader", port=0).start()
    try:
        proxy = LLMProxy(port=server.port, model_name="reader")
        served = [proxy.query(q["question"], max_retry=1) for q in rog[:2]]
    finally:
        server.stop()
    t = time.perf_counter()
    out = os.path.join(llm_root, "explanations.jsonl")
    n = generate_explanations(rog, out, fast, prompt_path=os.path.join(
        REPO, "prompts", "general_prompt.txt"))
    explain_s = time.perf_counter() - t
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    summary = dict(target_layers=cfg.n_layers, draft_layers=1,
                   gamma=SPEC_GAMMA, budget_tokens=[fast.maximun_token,
                                                    plain.maximun_token],
                   ms_per_sentence=ms, last_stats=stats,
                   spec_equal_plain=texts["spec"] == texts["plain"],
                   served_equal=served == texts["spec"][:2],
                   explanations=n, explanation_lines=len(rows),
                   explain_s=explain_s, wall_s=time.perf_counter() - t0)
    log("reader-serving", json.dumps(summary))
    if not (summary["spec_equal_plain"] and summary["served_equal"]
            and n == len(rows) == len(rog) == 16
            and fast.maximun_token == plain.maximun_token - SPEC_GAMMA - 1):
        raise AssertionError(f"reader-serving: {summary}")
    return summary


def run_bfs(svc, questions):
    """Phase bfs: the serving questions' shortest paths through the three
    backends (``device``: the BFS levels of a 16-question request on the
    card, ``rag.path_extract``; ``native``: the C++ enumerator; ``python``:
    the oracle), from one set of candidates, in 16-question requests: the
    same path set for every question and q/s of each, to the top 10
    candidates (``QAService``'s prompt load: the oracle takes ~2 s a
    question to the thousands of candidates of a random model); then
    ``device`` and ``native`` to every candidate (``POST /retrieve``'s
    load), and the device BFS's hops (one host sync each)."""
    import torch
    from gnn_rag_tpu_torch.rag.graph_utils import (build_graph,
                                                   get_truth_paths,
                                                   get_truth_paths_fast)
    from gnn_rag_tpu_torch.rag.path_extract import BatchedPathExtractor
    from gnn_rag_tpu_torch.rag.text_utils import path_to_string

    t0 = time.perf_counter()
    cands = svc.retrieve(questions, with_paths=False)
    ex = BatchedPathExtractor(device=svc.device)
    hops = {}

    def device(chunk, load):
        out = ex.extract(chunk)
        hops.setdefault(load, []).append(ex.last_hops)
        return out

    backends = {
        "device": device,
        "native": lambda chunk, _: [get_truth_paths_fast(
            q["graph"], q["q_entity"], q["cand"]) for q in chunk],
        "python": lambda chunk, _: [get_truth_paths(
            q["q_entity"], q["cand"], build_graph(q["graph"])) for q in chunk]}
    out = {}
    for load, top in (("top10", 10), ("all_candidates", None)):
        qs = [{"graph": q["subgraph"]["tuples"],
               "q_entity": q.get("entities", []),
               "cand": [c for c, _ in r["cand"]][:top]}
              for q, r in zip(questions, cands)]
        paths, qps = {}, {}
        for name, fn in backends.items():
            if name == "python" and top is None:
                continue
            fn(qs[:16], "warm")
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = [p for i in range(0, len(qs), 16)
                   for p in fn(qs[i:i + 16], load)]
            qps[name] = len(qs) / (time.perf_counter() - t)
            paths[name] = [sorted({path_to_string(p) for p in ps})
                           for ps in got]
        for name in paths:
            bad = [i for i, (a, b) in enumerate(zip(paths[name],
                                                    paths["native"])) if a != b]
            if bad:
                raise AssertionError(f"bfs ({load}): {name} paths differ from "
                                     f"native at questions {bad[:8]}")
        out[load] = dict(questions_per_s=qps, paths_per_question=sum(
            map(len, paths["native"])) / len(qs), device_bfs_hops=hops[load])
    # the service end to end with the device backend, one 16-question
    # request, against the same request through the phase's service
    dev_svc = type(svc)(svc.cfg, svc.vocab, svc.model,
                        question_encoder=svc.question_encoder,
                        tokenizer=svc.tokenizer, path_backend="device",
                        **dict(zip(("rel_hidden", "rel_hidden_inv",
                                    "rel_text_mask"),
                                   (a.cpu().numpy() for a in svc.rel_args[:3]))))
    served = dev_svc.retrieve(questions[:16])
    want = svc.retrieve(questions[:16])
    if [sorted(r["paths"]) for r in served] != [sorted(r["paths"])
                                                for r in want]:
        raise AssertionError(f"bfs: RetrieverService(path_backend='device') "
                             f"paths differ from {svc.path_backend}'s")
    summary = dict(questions=len(questions), request_questions=16, **out,
                   syncs="one a hop", wall_s=time.perf_counter() - t0)
    log("bfs", json.dumps(summary))
    return summary


def run_profile(device, root):
    """Phase profile: one epoch of the headline configuration through the
    CLI with ``--profile_dir``: the trace file exists and holds the
    gate-scatter forward and backward kernels."""
    import glob

    import torch
    from gnn_rag_tpu_torch import cli
    prof = os.path.join(root, "profile")
    t = time.perf_counter()
    ctx = cli.run(HEADLINE_FLAGS + [
        "--data_folder", os.path.join(root, "train") + "/", "--checkpoint_dir",
        os.path.join(root, "profile_ckpt"), "--experiment_name", "prof",
        "--num_epoch", "1", "--eval_every", "2", "--profile_dir", prof])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    files = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"profile: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {k: sum(1 for e in events if e.get("cat") == "kernel"
                      and k in e.get("name", ""))
               for k in ("gate_fwd_kernel", "gate_scatter_bwd_kernel")}
    if not all(kernels.values()):
        raise AssertionError(f"profile: kernel events {kernels}")
    summary = dict(wall_s=wall, epoch_loss=ctx["history"][0][0],
                   trace_mb=os.path.getsize(files[0]) / 2**20,
                   events=len(events), kernel_events=kernels)
    log("profile-dir", json.dumps(summary))
    return summary


# the mesh phase: ReaRev at the headline width on synthetic WebQSP-scale
# subgraphs (B8, E bucket 4096; MiniLM-width frozen-LM states from the
# seed), and the SFT at LLaMA2-7B width cut to 2 layers, B2 x 2048
MESH_REAREV = dict(entity_dim=50, num_iter=3, num_ins=2, num_gnn=3,
                   linear_dropout=0.2)
MESH_QUESTIONS, MESH_REL, MESH_WORD = 32, 512, 384
MESH_SFT = dict(n_layers=2, batch=2, seq=2048, steps=2)
# the mesh phase's processes: cuBLAS's deterministic workspace setting,
# which torch.use_deterministic_algorithms needs before a process's first
# GEMM
MESH_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def mesh_rearev(mesh, root):
    """Two epochs (4 B8 steps each) of ReaRev on the mesh's ranks, or in
    one process (``mesh`` None), with PyTorch's deterministic algorithms
    (the process must have CUBLAS_WORKSPACE_CONFIG set: MESH_ENV): (the
    epochs' losses, every step's gradient norm before the clip, ms a step
    of the second, whole state, launches, sharded names, the batch's E
    bucket)."""
    import logging

    import numpy as np
    import torch
    from gnn_rag_tpu_torch.config import Config, ModelConfig, TrainConfig
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    from gnn_rag_tpu_torch.train.trainer import Trainer
    from gnn_rag_tpu_torch.utils.synthetic import (random_records,
                                                   random_rel_hidden)
    rng = np.random.default_rng(SEED)
    ds = random_records(rng, n_questions=MESH_QUESTIONS,
                        n_entities_max=4000, n_facts_max=12000,
                        num_relation=MESH_REL, num_entity_global=100_000)
    ds.q_hidden = [rng.standard_normal((len(r.q_token_ids), MESH_WORD))
                   .astype(np.float32) * 0.5 for r in ds.records]
    rel = random_rel_hidden(rng, MESH_REL + 1, 8, MESH_WORD)
    orig = ds.reset_batches
    ds.reset_batches = lambda **kw: orig(is_sequential=True)
    cfg = Config(model=ModelConfig(**MESH_REAREV),
                 train=TrainConfig(batch_size=8, lr=5e-4, gradient_clip=1.0,
                                   seed=SEED, checkpoint_dir=root))
    tr = Trainer(cfg, train_data=ds, valid_data=ds, test_data=ds,
                 num_entity=100_000, num_kb_relation=MESH_REL,
                 rel_hidden=rel[0], rel_hidden_inv=rel[1], rel_text_mask=rel[2],
                 word_dim=MESH_WORD, device="cuda", mesh=mesh,
                 logger=logging.getLogger("mesh"))
    norms, step = [], tr.train_step

    def kept(*args):                        # the norm stays on the card
        out = step(*args)
        norms.append(tr.grad_norm)
        return out

    tr.train_step = kept
    reset_gate_counts()
    # PyTorch's deterministic kernels: the backward of a gather adds its
    # rows in a fixed order instead of with atomics (run_mesh)
    torch.use_deterministic_algorithms(True)
    try:
        losses = [tr.train_epoch()[0]]      # the first epoch warms up
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(tr.train_epoch()[0])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    ms = 1e3 * (time.perf_counter() - t) / tr.steps_per_epoch
    norms = [float(n) for n in norms]
    launches = (gs.launches, gs.bwd_launches)
    state = {k: v.float().cpu().numpy() for k, v in tr.full_state().items()}
    E = ds.make_batch(list(range(8))).seed_dist.shape[1]
    tr.close()
    return losses, norms, ms, state, launches, sorted(tr.sharded), int(E)


def mesh_sft(mesh, root):
    """``MESH_SFT`` steps of the SFT at LLaMA2-7B width on the mesh's tp
    ranks, or in one process: (losses, grad norms, ms a step, launches,
    this rank's heads)."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.llm.model import LlamaConfig
    from gnn_rag_tpu_torch.llm.sft import SFTConfig, SFTTrainer
    rng = np.random.default_rng(SEED)
    B, L = MESH_SFT["batch"], MESH_SFT["seq"]
    tokens = rng.integers(3, 32000, (2 * B, L)).astype(np.int32)
    mask = np.zeros((2 * B, L), np.float32)
    mask[:, L // 2:] = 1.0                 # the completion: the second half
    tr = SFTTrainer(LlamaConfig(n_layers=MESH_SFT["n_layers"], dtype="bfloat16"),
                    SFTConfig(output_dir=root, batch_size=B,
                              total_steps=MESH_SFT["steps"], warmup_steps=1,
                              learning_rate=3e-4, save_every=10**9, seed=SEED),
                    device="cuda", mesh=mesh)
    norms = []
    step = tr.train_step

    def counted(t, m):
        out = step(t, m)
        norms.append(float(tr.grad_norm))
        return out

    tr.train_step = counted
    reset_attn_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = tr.train(tokens, mask, steps=MESH_SFT["steps"], resume=False,
                      log_every=10**9)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / MESH_SFT["steps"]
    launches = attn_counts()
    heads = tr.model.layer_0.attn.n_heads
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return losses, norms, ms, launches, heads


def mesh_rank_main(rank, port, out):
    """One rank of the mesh phase (``chip_smoke.py --mesh-rank R --port P
    --out DIR``): ReaRev at dp 2, then dp 1 x tp 2, then the SFT at tp 2;
    its results into DIR/rank{R}.json and, from rank 0, the ReaRev states
    into DIR/rearev_{dp2,tp2}.npz."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from gnn_rag_tpu_torch.parallel.mesh import make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    res = {}
    for name, dp, tp in (("dp2", 2, 1), ("tp2", 1, 2)):
        mesh = make_mesh(dp, tp, backend="gloo", device="cuda:0")
        losses, norms, ms, state, launches, sharded, E = mesh_rearev(mesh, out)
        res[name] = dict(losses=losses, grad_norms=norms, ms_per_step=ms,
                         launches_fwd_bwd=launches, sharded=sharded, E=E)
        if rank == 0:
            np.savez(os.path.join(out, f"rearev_{name}.npz"), **state)
    mesh = make_mesh(1, 2, backend="gloo", device="cuda:0")
    losses, norms, ms, launches, heads = mesh_sft(mesh, os.path.join(out, "sft"))
    res["sft_tp2"] = dict(losses=losses, grad_norms=norms, ms_per_step=ms,
                          flash_launches_fwd_dq_dkv=launches,
                          local_heads=heads)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def mesh_reference_main(out):
    """The one-process ReaRev run the mesh ranks are held to
    (``chip_smoke.py --mesh-reference --out DIR``), in a process of its own
    as theirs are: DIR/reference.json and DIR/rearev_one.npz."""
    import numpy as np
    sys.path.insert(0, REPO)
    losses, norms, ms, state, launches, _, _ = mesh_rearev(None, out)
    np.savez(os.path.join(out, "rearev_one.npz"), **state)
    with open(os.path.join(out, "reference.json"), "w") as f:
        json.dump(dict(losses=losses, grad_norms=norms, ms_per_step=ms,
                       launches_fwd_bwd=launches), f)


def mesh_children(args_list, out, timeout=420):
    """Run this script's mesh processes (one argument list each) at once,
    with MESH_ENV, each with a timeout; a process that fails fails the
    phase."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                              + args + ["--out", out], cwd=REPO,
                              env={**os.environ, **MESH_ENV},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for args in args_list]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for args, p, text in zip(args_list, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"mesh: {' '.join(args)} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")


def run_mesh(device, root, card):
    """Phase mesh: two ranks on the one card over gloo (NCCL refuses two
    ranks on one device), each a process of this script started with a
    timeout; a rank that fails fails the phase. ReaRev (dp 2, then dp 1 x
    tp 2; 8 steps) against one process, run after them in a process of its
    own, each with PyTorch's deterministic algorithms: with the atomic adds
    of a gather's backward, the rounding differs from run to run and Adam's
    normalised steps carry it into the parameters, by enough that the
    check passed or failed by the run; without them each side gives the
    same bits every run. Epoch losses rtol 1e-5, every parameter
    rtol 1e-4 / atol 1e-6 (Adam's normalised steps of the softmax biases,
    gradient 0 up to rounding, within 2 lr a step), K1/K2 launched on both
    ranks, each step's gradient norm before the clip rtol 1e-3 (Adam's step
    hardly moves when every gradient is scaled by one constant, so a dp sum
    where a mean belongs shows in the norm, not in the parameters); the SFT
    at tp 2 (H/tp heads through K5a-c) against one process:
    losses rtol 1e-4 / atol 1e-5 (the JAX mesh tests' tolerance), grad
    norms rtol 1e-3."""
    import socket

    import numpy as np
    out = os.path.join(root, "mesh")
    os.makedirs(os.path.join(out, "sft"), exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t = time.perf_counter()
    mesh_children([["--mesh-rank", str(r), "--port", str(port)]
                   for r in range(2)], out)
    wall = time.perf_counter() - t
    mesh_children([["--mesh-reference"]], out)
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(out, "reference.json")) as f:
        one = json.load(f)
    loss1, rnorms1, ms1, launches1 = (
        one["losses"], one["grad_norms"], one["ms_per_step"],
        one["launches_fwd_bwd"])
    state1 = np.load(os.path.join(out, "rearev_one.npz"))
    per_step = 1 + MESH_REAREV["num_iter"] * MESH_REAREV["num_gnn"]
    steps = 2 * MESH_QUESTIONS // 8
    for name in ("dp2", "tp2"):
        got = np.load(os.path.join(out, f"rearev_{name}.npz"))
        for r, res in enumerate(ranks):
            if not np.allclose(res[name]["losses"], loss1, rtol=1e-5, atol=0):
                raise AssertionError(f"mesh {name} rank {r}: losses "
                                     f"{res[name]['losses']} vs one process "
                                     f"{loss1}")
            if not np.allclose(res[name]["grad_norms"], rnorms1, rtol=1e-3,
                               atol=0):
                raise AssertionError(f"mesh {name} rank {r}: grad norms "
                                     f"{res[name]['grad_norms']} vs one "
                                     f"process {rnorms1}")
            if tuple(res[name]["launches_fwd_bwd"]) != (per_step * steps,) * 2:
                raise AssertionError(f"mesh {name} rank {r}: K1/K2 launches "
                                     f"{res[name]['launches_fwd_bwd']}")
        worst = 0.0
        for k in state1.files:
            w = state1[k]
            d = np.abs(got[k] - w)
            if k in SOFTMAX_BIASES:
                if d.max() > 2 * 5e-4 * steps:
                    raise AssertionError(f"mesh {name}: {k} moved {d.max()}")
                continue
            over = (d / (1e-4 * np.abs(w) + 1e-6)).max()
            worst = max(worst, float(over))
            if over > 1:
                raise AssertionError(f"mesh {name}: {k} differs by {d.max()}")
        ranks[0][name]["param_err_over_tol"] = worst
    losses1, norms1, sft_ms1, sft_launches1, heads1 = mesh_sft(
        None, os.path.join(out, "sft1"))
    for r, res in enumerate(ranks):
        s = res["sft_tp2"]
        if not np.allclose(s["losses"], losses1, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"mesh sft rank {r}: losses {s['losses']} vs "
                                 f"one process {losses1}")
        if not np.allclose(s["grad_norms"], norms1, rtol=1e-3):
            raise AssertionError(f"mesh sft rank {r}: grad norms "
                                 f"{s['grad_norms']} vs {norms1}")
        want = (MESH_SFT["n_layers"] * MESH_SFT["steps"],) * 3
        if tuple(s["flash_launches_fwd_dq_dkv"]) != want or s["local_heads"] != 16:
            raise AssertionError(f"mesh sft rank {r}: flash launches "
                                 f"{s['flash_launches_fwd_dq_dkv']}, heads "
                                 f"{s['local_heads']}")
    summary = dict(card=card, ranks_wall_s=wall,
                   wall_s=time.perf_counter() - t, ranks=ranks,
                   one_process=dict(rearev_losses=loss1,
                                    rearev_grad_norms=rnorms1,
                                    rearev_ms_per_step=ms1,
                                    rearev_launches_fwd_bwd=launches1,
                                    sft_losses=losses1, sft_grad_norms=norms1,
                                    sft_ms_per_step=sft_ms1,
                                    sft_flash_launches=sft_launches1,
                                    sft_heads=heads1))
    log("mesh", json.dumps(summary))
    return summary


def sass_counts(lib, opcodes=("HGMMA", "UTMALDG")):
    """{kernel: {opcode: count}} of ``cuobjdump -sass`` on a built
    library: the instructions each kernel really issues."""
    from gnn_rag_tpu_torch.utils import build
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            counts[kernel] = dict.fromkeys(opcodes, 0)
        elif kernel is not None:
            for op in opcodes:
                counts[kernel][op] += op in line
    return counts


def ptxas_props(log_text):
    """{kernel: {"registers", "spill_bytes", "stack_bytes"}} from ``ptxas
    -v`` output: a "Function properties for <kernel>" line, then its stack
    frame and spill line, then its "Used N registers" line."""
    import re
    props, kernel = {}, None
    for line in log_text.splitlines():
        if "Function properties for" in line:
            kernel = line.split("Function properties for")[1].strip()
            props[kernel] = {}
        elif kernel is None:
            continue
        elif "spill stores" in line:
            props[kernel]["spill_bytes"] = sum(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
            props[kernel]["stack_bytes"] = int(re.search(
                r"(\d+) bytes stack frame", line).group(1))
        elif "Used" in line and "registers" in line:
            props[kernel]["registers"] = int(re.search(
                r"Used (\d+) registers", line).group(1))
    return props


def build_all():
    """Build every native library of the port at once (one compiler
    process per source, all started together); log each one's time and
    ptxas register / spill lines, and the wgmma (HGMMA) and TMA-load
    (UTMALDG) instructions of each flash kernel, which the Hopper kernels
    must hold as SM90_KERNELS lists, without spills; returns how many
    clusters of each float32 and each 16-bit cluster instance the card
    holds at once, by kernel and head dim ("fwd<2048>") and by kernel, type
    and head dim ("fwd<bfloat16, 4096>")."""
    from concurrent.futures import ThreadPoolExecutor

    from gnn_rag_tpu_torch.utils import build

    def timed(src):
        t = time.perf_counter()
        path = build.library(src)
        return path, time.perf_counter() - t

    sources = ("gate_scatter.cu", "flash_attention.cu", "graphpath.cpp")
    with ThreadPoolExecutor(len(sources)) as pool:
        done = {src: pool.submit(timed, src) for src in sources}
        for src, fut in done.items():
            path, secs = fut.result()
            stem = os.path.splitext(src)[0]
            ptxas = [" ".join(ln.split()) for ln in
                     build.logs.get(stem, "").splitlines()
                     if "Compiling entry" in ln or "registers" in ln
                     or "spill" in ln]
            log("build", f"{os.path.relpath(path, REPO)} in {secs:.1f} s; "
                f"{' | '.join(ptxas)}")
            if src == "flash_attention.cu":
                counts = {k: v for k, v in sass_counts(path).items()
                          if "flash_" in k}
                log("build", f"sass HGMMA / UTMALDG per kernel: "
                    f"{json.dumps(counts)}")
                props = ptxas_props(build.logs.get(stem, ""))
                for name, ops in SM90_KERNELS.items():
                    if not any(name in k and all(v[op] for op in ops)
                               for k, v in counts.items()):
                        raise AssertionError(f"{name}: not each of {ops} "
                                             f"in its SASS")
                    mine = [v for k, v in props.items() if name in k]
                    if not mine or any(v.get("spill_bytes", 1)
                                       or v.get("stack_bytes", 1)
                                       for v in mine):
                        raise AssertionError(f"{name} spills or keeps a "
                                             f"stack frame: {mine}")
                # the float32 kernels' clusters (HD / 128 blocks of 210-230
                # KB, one an SM) and the 16-bit ones' (2 to 16 blocks of up
                # to 230 KB): how many the card holds at once, 0 if it
                # cannot launch one
                import torch

                from gnn_rag_tpu_torch.llm import flash_attention as fa
                kinds = ("fwd", "dq", "dkv")
                clusters = {f"{k}<{d}>": fa.max_active_clusters(k, d)
                            for d in FP32_HEAD_DIMS for k in kinds}
                log("build", f"float32 flash clusters the card holds at "
                    f"once (cudaOccupancyMaxActiveClusters): "
                    f"{json.dumps(clusters)}")
                elems = {"bfloat16": "13__nv_bfloat16", "float16": "6__half"}
                clusters16 = {f"{k}<{t}, {d}>": fa.max_active_clusters(
                    k, d, getattr(torch, t))
                    for t in elems for d in CLUSTER16_HEAD_DIMS for k in kinds}
                log("build", f"bf16 and float16 flash clusters the card "
                    f"holds at once (cudaOccupancyMaxActiveClusters): "
                    f"{json.dumps(clusters16)}")
                wide = {f"{k}<0>": dict(
                    clusters={d: clusters[f"{k}<{d}>"]
                              for d in WIDE_HEAD_DIMS + WIDE32_HEAD_DIMS},
                    **next(v for n, v in props.items()
                           if f"flash_{k}_split3_kernelILi0E" in n))
                    for k in kinds}
                log("build", f"float32 flash instances <0> at head dims "
                    f"640-2048, clusters of five to sixteen blocks "
                    f"(clusters at once by head dim, ptxas registers, spill "
                    f"and stack bytes): {json.dumps(wide)}")
                shares3 = {f"{k}<{SHARES3_CMAX}>": dict(
                    clusters={d: clusters[f"{k}<{d}>"]
                              for d in SHARES3_HEAD_DIMS},
                    **next(v for n, v in props.items()
                           if f"flash_{k}_shares3_kernelILi{SHARES3_CMAX}E"
                           in n))
                    for k in kinds}
                log("build", f"float32 flash instances <{SHARES3_CMAX}> at "
                    f"head dims 2176 and 2304, clusters of ceil(D / 192) "
                    f"blocks (columns of each block by head dim: "
                    f"{json.dumps({d: fa.split3_shares(d) for d in SHARES3_HEAD_DIMS})}"
                    f"; clusters at once by head dim, ptxas registers, "
                    f"spill and stack bytes): {json.dumps(shares3)}")
                dims16 = WIDE16_HEAD_DIMS + CLUSTERS16_HEAD_DIMS
                shares = {d: fa.cluster16_shares(d) for d in dims16}
                wide16 = {f"{k}<{t}, {CLUSTER16_CMAX}>": dict(
                    clusters={d: clusters16[f"{k}<{t}, {d}>"]
                              for d in dims16},
                    **next(v for n, v in props.items()
                           if f"flash_{k}_cluster_kernelI{m}Li"
                              f"{CLUSTER16_CMAX}E" in n))
                    for t, m in elems.items() for k in kinds}
                log("build", f"bf16 and float16 flash cluster kernels at "
                    f"head dims 640-4096, clusters of ceil(D / 256) blocks "
                    f"(columns of each block by head dim: "
                    f"{json.dumps(shares)}; clusters at once by head dim, "
                    f"ptxas registers, spill and stack bytes): "
                    f"{json.dumps(wide16)}")
                # the kernels whose cluster exchange is a reduce-scatter
                # (reduce_scatter_partials)
                rs = {f"{k}<{t}>": next(
                    v for n, v in props.items() if f"{k}I{m}" in n)
                    for k, t, m in (
                        ("flash_fwd_cluster_kernel", "bfloat16, 256",
                         "13__nv_bfloat16Li256E"),
                        ("flash_fwd_cluster_kernel", "float16, 256",
                         "6__halfLi256E"),
                        ("flash_fwd_split3_kernel", "0", "Li0E"),
                        ("flash_dq_split3_kernel", "0", "Li0E"),
                        ("flash_dkv_split3_kernel", "0", "Li0E"))}
                log("build", f"reduce-scatter exchange kernels (ptxas "
                    f"registers, spill and stack bytes): {json.dumps(rs)}")
                # Hopper's non-portable cluster sizes, 9 to 16 blocks: each
                # kernel's clusters at once at the first head dim of each
                # size (float32 D = 128 NB; 16 bits the first D of
                # ceil(D / 256) = NB)
                by_size = {nb: {
                    **{f"{k}<float32>": clusters[f"{k}<{128 * nb}>"]
                       for k in kinds},
                    **{f"{k}<{t}>": clusters16[
                        f"{k}<{t}, {256 * nb - 128}>"]
                       for t in elems for k in kinds}}
                    for nb in range(9, 17)}
                log("build", f"flash clusters at once by cluster size 9-16 "
                    f"(non-portable; float32 at D = 128 NB, bf16 and "
                    f"float16 at D = 256 NB - 128): {json.dumps(by_size)}")
                if not (all(clusters.values()) and all(clusters16.values())):
                    raise AssertionError(f"a flash cluster cannot launch: "
                                         f"{clusters} {clusters16}")
    return clusters, clusters16


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)
    t_main = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    print(card, flush=True)

    walls = {}

    def timed(phase, fn, *args):
        """fn(*args), its wall seconds logged under ``phase``."""
        t = time.perf_counter()
        out = fn(*args)
        walls[phase] = round(time.perf_counter() - t, 1)
        return out

    clusters32, clusters16 = timed("build", build_all)
    rows = timed("kernel", check_kernels, device)
    bwd_rows = timed("kernel-bwd", check_bwd_kernels, device)
    fused_rows = timed("kernel-fused", check_fused_kernels, device)
    attn_rows = timed("kernel-attn", check_attn_kernels, device)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        train_root = os.path.join(root, "train")
        llm_root = os.path.join(root, "llm")
        _, serve_launches = timed("slice", run_slice, device, root)
        os.makedirs(train_root)
        _, tr, train_fwd, train_bwd = timed("train", run_train, device,
                                            train_root)
        timed("profile", run_profile, device, root)
        timed("grad", check_grads, tr, device)
        timed("step-time", train_step_time, tr, device)
        del tr
        _, v2_counts = timed("v2", run_v2_path, device, train_root)
        one_dir = timed("kernel-1dir", check_1dir_kernels, device)
        _, nsm_counts = timed("retrievers", run_retrievers, device,
                              train_root)
        wide_rows = timed("wide-kernel", check_wide_kernels, device)
        _, wide_counts = timed("wide", run_wide, device, train_root)
        gc.collect()
        torch.cuda.empty_cache()
        os.makedirs(llm_root)
        sft, trainer, tokens, mask, prompts = timed("sft", run_sft, device,
                                                    llm_root)
        grad_llm = timed("grad-llm", check_llm_grads, trainer, tokens, mask,
                         device)
        timed("decode", run_decode, trainer, prompts, device)
        _, qa_launches, qa_flash = timed("qa", run_qa, device, train_root,
                                         trainer, llm_root)
        timed("step-time-llm", sft_step_time, trainer, tokens, mask, device)
        # the 32-layer phases need the card: the SFT trainer's float32
        # params, grads and AdamW states go (its reader is the qa bundle)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        fp32_step = timed("step-time-llm-fp32", sft_fp32_step_time, tokens,
                          mask, device)
        d256 = timed("step-time-llm-d256", sft_d256_step_time, device,
                     llm_root, prompts)
        d256_fp32 = timed(
            "step-time-llm-d256-fp32", sft_fp32_entry_step_time, device,
            llm_root, prompts, D256_FP32_FLAGS, "step-time-llm-d256-fp32")
        f16 = {f"d{hd}": timed(phase, sft_16bit_step_time, device, llm_root,
                               flags, phase)
               for hd, flags, phase in (
                   (128, F16_FLAGS, "step-time-llm-f16"),
                   (256, D256_F16_FLAGS, "step-time-llm-d256-f16"))}
        d512 = {dtype: timed(phase, sft_16bit_step_time, device, llm_root,
                             flags, phase, (D384_GRAD,))
                for dtype, flags, phase in (
                    ("bfloat16", D512_FLAGS, "step-time-llm-d512"),
                    ("float16", D512_F16_FLAGS, "step-time-llm-d512-f16"))}
        d512_fp32 = timed(
            "step-time-llm-d512-fp32", sft_fp32_entry_step_time, device,
            llm_root, prompts, D512_FP32_FLAGS, "step-time-llm-d512-fp32",
            (D384_GRAD,))
        d1024_fp32 = timed(
            "step-time-llm-d1024-fp32", sft_fp32_entry_step_time, device,
            llm_root, prompts, D1024_FP32_FLAGS, "step-time-llm-d1024-fp32",
            WIDE_GRADS)
        d1024 = {dtype: timed(phase, sft_16bit_step_time, device, llm_root,
                              flags, phase, grads)
                 for dtype, flags, phase, grads in (
                     ("bfloat16", D1024_FLAGS, "step-time-llm-d1024",
                      WIDE_GRADS),
                     ("float16", D1024_F16_FLAGS, "step-time-llm-d1024-f16",
                      WIDE_GRADS + D2048_GRADS + D4096_GRADS))}
        d2048 = timed("step-time-llm-d2048", sft_16bit_step_time, device,
                      llm_root, D2048_FLAGS, "step-time-llm-d2048",
                      D2048_GRADS[1:])
        d2048_fp32 = timed(
            "step-time-llm-d2048-fp32", sft_fp32_entry_step_time, device,
            llm_root, prompts, D2048_FP32_FLAGS, "step-time-llm-d2048-fp32",
            D2048_FP32_GRADS)
        d4096 = timed("step-time-llm-d4096", sft_16bit_step_time, device,
                      llm_root, D4096_FLAGS, "step-time-llm-d4096",
                      D4096_GRADS[1:])
        d2304_fp32 = timed(
            "step-time-llm-d2304-fp32", sft_fp32_entry_step_time, device,
            llm_root, prompts, D2304_FP32_FLAGS, "step-time-llm-d2304-fp32",
            D2304_FP32_GRADS)
        _, reader_7b, lora_launches = timed("lora", run_lora, device, tokens,
                                            mask)
        timed("serve-7b", run_serve_7b, device, reader_7b,
              os.path.join(llm_root, "reader"), prompts)
        del reader_7b
        gc.collect()
        torch.cuda.empty_cache()
        timed("reader-serving", run_reader_serving, device, llm_root,
              train_root)
        gc.collect()
        torch.cuda.empty_cache()
        mesh = timed("mesh", run_mesh, device, root, card)

    gate = "gnn_rag_tpu_torch/csrc/gate_scatter.cu"
    kernels = []
    for name, row, launches, replaces, also, backward in (
            ("gate_scatter_fwd", rows[0], train_fwd, 844, (1231, 565), False),
            ("gate_scatter_bwd", bwd_rows[0], train_bwd, 988, (1267, 639),
             True)):
        bound_ms, bound_by = gate_bound(row, backward)
        kernels.append({
            "name": name, "route": "cuda", "source": gate,
            "replaces": f"{PALLAS}:{replaces}",
            "also_replaces": [f"{PALLAS}:{x}" for x in also],
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": row["shape"], "launches_by_path": {
                **({"serve": serve_launches, "train": train_fwd,
                    "qa": qa_launches} if not backward
                   else {"train": train_bwd}),
                **{f"mesh_{name}_rank{r}": res[name]["launches_fwd_bwd"][backward]
                   for r, res in enumerate(mesh["ranks"])
                   for name in ("dp2", "tp2")}}})
    for name, rows_1dir, key, replaces in (
            ("gate_scatter_fwd_1dir", one_dir[0], "launches_1dir", 565),
            ("gate_scatter_bwd_1dir", one_dir[1], "bwd_launches_1dir", 639)):
        row = rows_1dir[0]
        kernels.append({
            "name": name, "route": "cuda", "source": gate,
            "replaces": f"{PALLAS}:{replaces}",
            "launches": nsm_counts[key], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"] + " (one direction, J=1)",
            "launches_by_path": {"nsm": nsm_counts[key]}})
    frow = fused_rows[0]
    for name, key, replaces, also, backward in (
            ("fused_gate_scatter_fwd", "", 126, (210,), False),
            ("fused_gate_scatter_bwd", "bwd_", 316, (), True)):
        bound_ms, bound_by = gate_bound(frow, backward, ndir=1, project=True)
        parts = (("dfact_rel", "dw", "db", "dins", "dprior") if backward
                 else ("fwd",))
        kernels.append({
            "name": name, "route": "cuda", "source": gate,
            "replaces": f"{PALLAS}:{replaces}",
            "also_replaces": [f"{PALLAS}:{x}" for x in also],
            "launches": v2_counts[f"fused_{key}launches"],
            "max_abs_err": max(frow["err_ref_by_output"][p][0] for p in parts),
            "ms": frow[f"{key}ms"], "device_ms": frow[f"{key}device_ms"],
            "plain_ms": frow[f"{key}plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": frow["shape"] + " (one direction)",
            "launches_by_path": {"train_v2": v2_counts[f"fused_{key}launches"]}})
    bound_ms, bound_by = scatter_bound(frow)
    kernels.append({
        "name": "scatter_mm", "route": "cuda", "source": gate,
        "replaces": f"{PALLAS}:32", "launches": v2_counts["scatter_launches"],
        "max_abs_err": frow["err_ref_by_output"]["scatter"][0],
        "ms": frow["scatter_ms"], "device_ms": frow["scatter_device_ms"],
        "plain_ms": frow["scatter_plain_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": frow["scatter_add_ms"],
        "shape": f"{frow['shape']} C={frow['scatter_C']}",
        "main_path": "none: no model calls scatter_mm (nor the JAX op)"})
    # the windowed shapes, on the wide path: K1 and K2 at J 3, D 128 (CWQ's
    # bucket), K4f and K4b at J 1, D 256 (NSM's launch), K6a/b and K6c at
    # J 3, D 128
    by_shape = {r["shape"]: r for r in wide_rows}
    cwq, nsm = by_shape["cwq_d128_fp32"], by_shape["nsm_d256_fp32"]
    for name, row, windows, key, replaces, runs in (
            ("gate_scatter_fwd_wide", cwq["fwd"], cwq["windows"]["gate_scatter_fwd"],
             "launches", 844, "all"),
            ("gate_scatter_bwd_wide", cwq["bwd"], cwq["windows"]["gate_scatter_bwd"],
             "bwd_launches", 988, "all"),
            ("gate_scatter_fwd_1dir_wide", nsm["fwd"],
             nsm["windows"]["gate_scatter_fwd"], "launches_1dir", 565, "nsm"),
            ("gate_scatter_bwd_1dir_wide", nsm["bwd"],
             nsm["windows"]["gate_scatter_bwd"], "bwd_launches_1dir", 639, "nsm"),
            ("fused_gate_scatter_fwd_wide", cwq["fused"]["fwd"],
             cwq["fused"]["windows"]["fused_gate_scatter_fwd"],
             "fused_launches", 126, "v2"),
            ("fused_gate_scatter_bwd_wide", cwq["fused"]["bwd"],
             cwq["fused"]["windows"]["fused_gate_scatter_bwd"],
             "fused_bwd_launches", 316, "v2")):
        by_run = {run: c[key] for run, c in wide_counts.items()
                  if runs == "all" or runs in run}
        kernels.append({
            "name": name, "route": "cuda", "source": gate,
            "replaces": f"{PALLAS}:{replaces}",
            "launches": sum(by_run.values()), "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": (cwq if "1dir" not in name else nsm)["shape"],
            "windows_W_n": windows, "launches_by_path": by_run})
    main_row = attn_rows[0]
    for i, (name, key, line) in enumerate((
            ("flash_attention_fwd", "fwd", 47), ("flash_attention_dq", "dq", 132),
            ("flash_attention_dkv", "dkv", 170))):
        parts = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gnn_rag_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"{FLASH}:{line}",
            "launches": sft["flash_launches_fwd_dq_dkv"][i],
            "max_abs_err": max(main_row["err_ref_over_tol_by_output"][p][0]
                               for p in parts),
            "ms": main_row["ms"][key], "plain_ms": main_row["plain_ms"][key],
            "bound_ms": main_row["bound_ms"][key],
            "bound_by": main_row["bound_by"][key],
            "library_ms": main_row["sdpa_fwd_ms"] if key == "fwd" else None,
            "bound_share": main_row["bound_share"][key],
            "tflops": main_row["tflops"][key],
            "shape": main_row["shape"],
            "launches_by_path": {
                "sft": sft["flash_launches_fwd_dq_dkv"][i],
                "lora": lora_launches[i],
                **{f"mesh_sft_tp2_rank{r}":
                   res["sft_tp2"]["flash_launches_fwd_dq_dkv"][i]
                   for r, res in enumerate(mesh["ranks"])}},
            **({} if key == "fwd" else
               {"sdpa_bwd_ms_dq_dk_dv_together": main_row["sdpa_bwd_ms"]})})
    # the float32 kernels (three bf16 terms a float on wgmma), on the
    # float32 paths: the float32 SFT step, the float32 gradient check and
    # the qa phase's beam rescoring
    f32_row = next(r for r in attn_rows if r["shape"] == "sft_b8_l2047_fp32")
    for i, (name, key, line, kernel) in enumerate((
            ("flash_attention_fwd_fp32", "fwd", 47,
             "flash_fwd_split3_kernel<128>"),
            ("flash_attention_dq_fp32", "dq", 132,
             "flash_dq_split3_kernel<128>"),
            ("flash_attention_dkv_fp32", "dkv", 170,
             "flash_dkv_split3_kernel<128>"))):
        parts = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}[key]
        kernels.append({
            "name": name, "route": "cuda", "kernel": kernel,
            "source": "gnn_rag_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"{FLASH}:{line}",
            "launches": fp32_step["flash_launches_fwd_dq_dkv"][i],
            "max_abs_err": max(f32_row["err_ref_over_tol_by_output"][p][0]
                               for p in parts),
            "ms": f32_row["ms"][key], "plain_ms": f32_row["plain_ms"][key],
            "bound_ms": f32_row["bound_ms"][key],
            "bound_by": f32_row["bound_by"][key],
            "float_core_bound_ms": f32_row["float_core_bound_ms"][key],
            "library_ms": f32_row["sdpa_fwd_ms"] if key == "fwd" else None,
            "bound_share": f32_row["bound_share"][key],
            "tflops": f32_row["tflops"][key],
            "shape": f32_row["shape"],
            "launches_by_path": {
                "step_time_llm_fp32": fp32_step["flash_launches_fwd_dq_dkv"][i],
                "grad_llm_fp32": grad_llm["flash_launches"][i],
                **({"qa_beam_rescoring": qa_flash} if key == "fwd" else {})},
            **({} if key == "fwd" else
               {"sdpa_bwd_ms_dq_dk_dv_together": f32_row["sdpa_bwd_ms"]})})
    # the bf16 kernels at head dim 256 (the <256> instances), on the
    # step-time-llm-d256 path: timed at its own shape, B2 L2047 H8, and at B8
    rows_d256 = {r["shape"]: r for r in attn_rows
                 if r["D"] == 256 and r["dtype"] == "bfloat16"}
    d_row, d8_row = (rows_d256["gemma_b2_l2047_d256_bf16"],
                     rows_d256["gemma_b8_l2047_d256_bf16"])
    for i, (name, key, line) in enumerate((
            ("flash_attention_fwd_d256", "fwd", 47),
            ("flash_attention_dq_d256", "dq", 132),
            ("flash_attention_dkv_d256", "dkv", 170))):
        parts = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}[key]
        kernels.append({
            "name": name, "route": "cuda",
            "kernel": flash_kernel_name(key, "bfloat16", 256),
            "source": "gnn_rag_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"{FLASH}:{line}",
            "launches": d256["flash_launches_fwd_dq_dkv"][i],
            "max_abs_err": max(d_row["err_ref_over_tol_by_output"][p][0]
                               for p in parts),
            "ms": d_row["ms"][key], "plain_ms": d_row["plain_ms"][key],
            "bound_ms": d_row["bound_ms"][key],
            "bound_by": d_row["bound_by"][key],
            "library_ms": d_row["sdpa_fwd_ms"] if key == "fwd" else None,
            "bound_share": d_row["bound_share"][key],
            "tflops": d_row["tflops"][key], "shape": d_row["shape"],
            "b8": {"shape": d8_row["shape"], "ms": d8_row["ms"][key],
                   "plain_ms": d8_row["plain_ms"][key],
                   "bound_ms": d8_row["bound_ms"][key],
                   "bound_share": d8_row["bound_share"][key],
                   **({"library_ms": d8_row["sdpa_fwd_ms"]} if key == "fwd"
                      else {"sdpa_bwd_ms_dq_dk_dv_together":
                            d8_row["sdpa_bwd_ms"]})},
            "max_err_over_tol_by_shape": {
                shape: max(r["err_ref_over_tol_by_output"][p][2]
                           for p in parts) for shape, r in rows_d256.items()},
            "launches_by_path": {
                "step_time_llm_d256": d256["flash_launches_fwd_dq_dkv"][i],
                "d256_timed_steps": d256["timed_flash_launches"][i],
                **({"d256_scoring": d256["scoring_flash_launches"][0]}
                   if key == "fwd" else {})},
            **({} if key == "fwd" else
               {"sdpa_bwd_ms_dq_dk_dv_together": d_row["sdpa_bwd_ms"]})})
    # the float32 kernels at head dim 256 (the <256> instances, clusters of
    # two blocks), on the step-time-llm-d256-fp32 path, timed at its shape
    rows_f256 = {r["shape"]: r for r in attn_rows
                 if r["D"] == 256 and r["dtype"] == "float32"}
    f_row = rows_f256["gemma_b2_l2047_d256_fp32"]
    for i, (name, key, line) in enumerate((
            ("flash_attention_fwd_d256_fp32", "fwd", 47),
            ("flash_attention_dq_d256_fp32", "dq", 132),
            ("flash_attention_dkv_d256_fp32", "dkv", 170))):
        parts = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}[key]
        kernels.append({
            "name": name, "route": "cuda",
            "kernel": f"flash_{key}_split3_kernel<256>",
            "source": "gnn_rag_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"{FLASH}:{line}",
            "launches": d256_fp32["flash_launches_fwd_dq_dkv"][i],
            "max_abs_err": max(f_row["err_ref_over_tol_by_output"][p][0]
                               for p in parts),
            "ms": f_row["ms"][key], "plain_ms": f_row["plain_ms"][key],
            "bound_ms": f_row["bound_ms"][key],
            "bound_by": f_row["bound_by"][key],
            "float_core_bound_ms": f_row["float_core_bound_ms"][key],
            "library_ms": f_row["sdpa_fwd_ms" if key == "fwd"
                                else "sdpa_bwd_ms"],
            "library_call": ("SDPA forward" if key == "fwd" else
                             "SDPA backward, dq, dk and dv together"),
            "bound_share": f_row["bound_share"][key],
            "tflops": f_row["tflops"][key], "shape": f_row["shape"],
            "max_err_over_tol_by_shape": {
                shape: max(r["err_ref_over_tol_by_output"][p][2]
                           for p in parts) for shape, r in rows_f256.items()},
            "launches_by_path": {
                "step_time_llm_d256_fp32":
                    d256_fp32["flash_launches_fwd_dq_dkv"][i],
                "d256_fp32_timed_steps": d256_fp32["timed_flash_launches"][i],
                "d256_fp32_grads": d256_fp32["grad_flash_launches"][i],
                **({"d256_fp32_scoring":
                    d256_fp32["scoring_flash_launches"][0]}
                   if key == "fwd" else {})}})
    # the float16 kernels (the <__half, 128> and <__half, 256> instances) on
    # the float16 SFT paths, timed at their steps' shapes; the bf16 and
    # float16 kernels at head dims 512 and 384 (the pair kernels) on the
    # step-time-llm-d512 paths: 512 in their SFT steps, 384 in their
    # gradient checks, both timed at the step's shape, B8 L2047 H8
    groups = [("float16", hd, suffix, shape_name, f16[f"d{hd}"], {
        f"step_time_llm{suffix}": "flash_launches_fwd_dq_dkv",
        f"{suffix[1:]}_timed_steps": "timed_flash_launches",
        f"{suffix[1:]}_grads": "grad_flash_launches"})
        for hd, suffix, shape_name in (
            (128, "_f16", "sft_b8_l2047_f16"),
            (256, "_d256_f16", "gemma_b2_l2047_d256_f16"))]
    for dtype, tag, phase in (("bfloat16", "bf16", "step_time_llm_d512"),
                              ("float16", "f16", "step_time_llm_d512_f16")):
        run = d512[dtype]
        groups.append((dtype, 512, f"_d512_{tag}", f"dsv4_b8_l2047_d512_{tag}",
                       run, {phase: "flash_launches_fwd_dq_dkv",
                             f"{phase}_timed_steps": "timed_flash_launches",
                             f"{phase}_grads_d512": "grad_flash_launches"}))
        run_384 = {"d384_grads": run["grads_by_head_dim"]["d384"][
            "flash_launches"]}
        groups.append((dtype, 384, f"_d384_{tag}", f"dsv4_b8_l2047_d384_{tag}",
                       run_384, {f"{phase}_grads_d384": "d384_grads"}))
    # the float32 kernels at head dims 512 and 384 (clusters of four and
    # three blocks) on the step-time-llm-d512-fp32 path: 512 in its SFT
    # steps and scoring forward, 384 in its gradient check, both timed at
    # the step's shape, B2 L2047 H8
    phase = "step_time_llm_d512_fp32"
    groups.append(("float32", 512, "_d512_fp32", "dsv4_b2_l2047_d512_fp32",
                   d512_fp32, {phase: "flash_launches_fwd_dq_dkv",
                               f"{phase}_timed_steps": "timed_flash_launches",
                               f"{phase}_scoring": "scoring_flash_launches",
                               f"{phase}_grads_d512": "grad_flash_launches"}))
    groups.append(("float32", 384, "_d384_fp32", "dsv4_b2_l2047_d384_fp32",
                   {"d384_grads": d512_fp32["grads_by_head_dim"]["d384"][
                       "flash_launches"]},
                   {f"{phase}_grads_d384": "d384_grads"}))
    # the float32 kernels at head dims 1024 to 640 (clusters of eight to
    # five blocks) on the step-time-llm-d1024-fp32 path: 1024 in its SFT
    # steps and scoring forward, 896, 768 and 640 in its gradient check, each
    # timed at the step's shape, B2 L2047 H4
    phase = "step_time_llm_d1024_fp32"
    groups.append(("float32", 1024, "_d1024_fp32", "h4_b2_l2047_d1024_fp32",
                   d1024_fp32, {
                       phase: "flash_launches_fwd_dq_dkv",
                       f"{phase}_timed_steps": "timed_flash_launches",
                       f"{phase}_scoring": "scoring_flash_launches",
                       f"{phase}_grads_d1024": "grad_flash_launches"}))
    for hd in (896, 768, 640):
        groups.append((
            "float32", hd, f"_d{hd}_fp32", f"h4_b2_l2047_d{hd}_fp32",
            {"grads": d1024_fp32["grads_by_head_dim"][f"d{hd}"][
                "flash_launches"]},
            {f"{phase}_grads_d{hd}": "grads"}))
    # the bf16 and float16 kernels at head dims 1024 to 640 (clusters of
    # four, four, three and three blocks) on the step-time-llm-d1024 paths:
    # 1024 in their SFT steps, 896, 768 and 640 in their gradient checks,
    # each timed at the steps' shape, B8 L2047 H4
    for dtype, tag, phase in (("bfloat16", "bf16", "step_time_llm_d1024"),
                              ("float16", "f16", "step_time_llm_d1024_f16")):
        run = d1024[dtype]
        groups.append((dtype, 1024, f"_d1024_{tag}", f"h4_b8_l2047_d1024_{tag}",
                       run, {phase: "flash_launches_fwd_dq_dkv",
                             f"{phase}_timed_steps": "timed_flash_launches",
                             f"{phase}_grads_d1024": "grad_flash_launches"}))
        for hd in (896, 768, 640):
            groups.append((
                dtype, hd, f"_d{hd}_{tag}", f"h4_b8_l2047_d{hd}_{tag}",
                {"grads": run["grads_by_head_dim"][f"d{hd}"][
                    "flash_launches"]},
                {f"{phase}_grads_d{hd}": "grads"}))
    # the bf16 and float16 kernels at head dims 2048, 1408 and 1152
    # (clusters of eight, six and five blocks): bf16 2048 in the
    # step-time-llm-d2048 SFT steps and gradient check, 1408 and 1152 in its
    # gradient check, float16's three in step-time-llm-d1024-f16's gradient
    # check; 2048 timed at the step's B8 L2047 H2, 1408 and 1152 at B2 L1000
    # H2, as every other head dim from 1152 to 1920 (those on no path, in
    # the 2048 entries' other_head_dims)
    phase = "step_time_llm_d2048"
    groups.append(("bfloat16", 2048, "_d2048_bf16", "h2_b8_l2047_d2048_bf16",
                   d2048, {phase: "flash_launches_fwd_dq_dkv",
                           f"{phase}_timed_steps": "timed_flash_launches",
                           f"{phase}_grads_d2048": "grad_flash_launches"}))
    grads16 = {"bfloat16": (d2048, phase),
               "float16": (d1024["float16"], "step_time_llm_d1024_f16")}
    for dtype, tag in (("bfloat16", "bf16"), ("float16", "f16")):
        run, path = grads16[dtype]
        for hd in ((1408, 1152) if dtype == "bfloat16"
                   else (2048, 1408, 1152)):
            groups.append((
                dtype, hd, f"_d{hd}_{tag}",
                (f"h2_b8_l2047_d{hd}_{tag}" if hd == 2048
                 else f"ragged_b2_l1000_d{hd}_{tag}"),
                {"grads": run["grads_by_head_dim"][f"d{hd}"][
                    "flash_launches"]},
                {f"{path}_grads_d{hd}": "grads"}))
    # the float32 kernels at head dims 2048, 1664 and 1152 (the <0>
    # instance in clusters of sixteen, thirteen and nine blocks) on the
    # step-time-llm-d2048-fp32 path: 2048 in its SFT steps and scoring
    # forward, 1664 and 1152 in its gradient check; 2048 timed at the step's
    # B2 L2047 H2, 1664 and 1152 at B2 L1000 H2
    phase = "step_time_llm_d2048_fp32"
    groups.append(("float32", 2048, "_d2048_fp32", "h2_b2_l2047_d2048_fp32",
                   d2048_fp32, {
                       phase: "flash_launches_fwd_dq_dkv",
                       f"{phase}_timed_steps": "timed_flash_launches",
                       f"{phase}_scoring": "scoring_flash_launches",
                       f"{phase}_grads_d2048": "grad_flash_launches"}))
    for hd in D2048_FP32_OTHER:
        groups.append((
            "float32", hd, f"_d{hd}_fp32", f"ragged_b2_l1000_d{hd}_fp32",
            {"grads": d2048_fp32["grads_by_head_dim"][f"d{hd}"][
                "flash_launches"]},
            {f"{phase}_grads_d{hd}": "grads"}))
    # the bf16 and float16 kernels at head dims 4096, 3968 and 2176
    # (clusters of sixteen, sixteen and nine blocks): bf16 4096 in the
    # step-time-llm-d4096 SFT steps and gradient check, 3968 and 2176 in its
    # gradient check, float16's three in step-time-llm-d1024-f16's gradient
    # check; 4096 timed at the step's B8 L2047 H1, 3968 and 2176 at B2 L1000
    # H2, as bf16's 3072 (on no path, in the bf16 4096 entries'
    # other_head_dims)
    phase = "step_time_llm_d4096"
    groups.append(("bfloat16", 4096, "_d4096_bf16", "h1_b8_l2047_d4096_bf16",
                   d4096, {phase: "flash_launches_fwd_dq_dkv",
                           f"{phase}_timed_steps": "timed_flash_launches",
                           f"{phase}_grads_d4096": "grad_flash_launches"}))
    grads16 = {"bfloat16": (d4096, phase),
               "float16": (d1024["float16"], "step_time_llm_d1024_f16")}
    for dtype, tag in (("bfloat16", "bf16"), ("float16", "f16")):
        run, path = grads16[dtype]
        for hd in (D4096_GRAD_DIMS[1:] if dtype == "bfloat16"
                   else D4096_GRAD_DIMS):
            groups.append((
                dtype, hd, f"_d{hd}_{tag}",
                (f"h1_b8_l2047_d{hd}_{tag}" if hd == 4096
                 else f"ragged_b2_l1000_d{hd}_{tag}"),
                {"grads": run["grads_by_head_dim"][f"d{hd}"][
                    "flash_launches"]},
                {f"{path}_grads_d{hd}": "grads"}))
    # the float32 kernels on 192-column shares (twelve blocks) on the
    # step-time-llm-d2304-fp32 path: 2304 in its SFT steps and scoring
    # forward, 2176 in its gradient check; 2304 timed at the step's B2
    # L2047 H1, 2176 at B2 L1000 H1
    phase = "step_time_llm_d2304_fp32"
    groups.append(("float32", 2304, "_d2304_fp32", "gemma2_b2_l2047_d2304_fp32",
                   d2304_fp32, {
                       phase: "flash_launches_fwd_dq_dkv",
                       f"{phase}_timed_steps": "timed_flash_launches",
                       f"{phase}_scoring": "scoring_flash_launches",
                       f"{phase}_grads_d2304": "grad_flash_launches"}))
    groups.append(("float32", 2176, "_d2176_fp32", "ragged_b2_l1000_d2176_fp32",
                   {"grads": d2304_fp32["grads_by_head_dim"]["d2176"][
                       "flash_launches"]},
                   {f"{phase}_grads_d2176": "grads"}))
    for dtype, hd, suffix, shape_name, run, paths in groups:
        rows_t = {r["shape"]: r for r in attn_rows
                  if r["D"] == hd and r["dtype"] == dtype}
        h_row = rows_t[shape_name]
        for i, (key, line) in enumerate((("fwd", 47), ("dq", 132),
                                         ("dkv", 170))):
            parts = {"fwd": ("o", "lse"), "dq": ("dq",),
                     "dkv": ("dk", "dv")}[key]
            by_shape = {}
            for shape, r in rows_t.items():
                by_shape[shape] = max(r["err_ref_over_tol_by_output"][p][2]
                                      for p in parts)
                for scale, errs in r.get(
                        "g_scaled_err_ref_over_tol_by_output", {}).items():
                    if key != "fwd":
                        by_shape[f"{shape} dO x {scale}"] = max(
                            errs[p][2] for p in parts)
            by_path = {name: run[field][i] for name, field in paths.items()}
            kernels.append({
                "name": f"flash_attention_{key}{suffix}", "route": "cuda",
                "kernel": flash_kernel_name(key, dtype, hd),
                "source": "gnn_rag_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"{FLASH}:{line}",
                "launches": next(iter(by_path.values())),
                "max_abs_err": max(h_row["err_ref_over_tol_by_output"][p][0]
                                   for p in parts),
                "ms": h_row["ms"][key], "plain_ms": h_row["plain_ms"][key],
                "bound_ms": h_row["bound_ms"][key],
                "bound_by": h_row["bound_by"][key],
                **({"float_core_bound_ms": h_row["float_core_bound_ms"][key]}
                   if dtype == "float32" else {}),
                "library_ms": h_row["sdpa_fwd_ms"] if key == "fwd" else None,
                "library_backend": h_row["sdpa_backend"],
                "bound_share": h_row["bound_share"][key],
                "tflops": h_row["tflops"][key], "shape": h_row["shape"],
                "products_issued_needed": h_row["products_issued_needed"][key],
                **({"clusters_at_once":
                    clusters16[f"{key}<{dtype}, {hd}>"]}
                   if dtype != "float32" and hd > 256 else
                   {"clusters_at_once": clusters32[f"{key}<{hd}>"]}
                   if dtype == "float32" and hd > 128 else {}),
                **({"other_head_dims": {
                    d: other_head_dim(attn_rows, dtype, d, key, parts)
                    for d in WIDE16_HEAD_DIMS[4:-1]
                    if d not in (1408, 1152)}}
                   if hd == 2048 and dtype != "float32" else
                   {"other_head_dims": {
                       d: other_head_dim(attn_rows, dtype, d, key, parts)
                       for d in D4096_OTHER if d not in D4096_GRAD_DIMS}}
                   if hd == 4096 and dtype == "bfloat16" else {}),
                "max_err_over_tol_by_shape": by_shape,
                "launches_by_path": by_path,
                **({} if key == "fwd" else
                   {"sdpa_bwd_ms_dq_dk_dv_together": h_row["sdpa_bwd_ms"]})})
    log("phase-walls", json.dumps(walls))
    log("total", f"wall {time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(int(sys.argv[2]), int(sys.argv[4]), sys.argv[6])
    elif sys.argv[1:2] == ["--mesh-reference"]:
        mesh_reference_main(sys.argv[3])
    else:
        main()
