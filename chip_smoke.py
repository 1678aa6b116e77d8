#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dmx_compressor_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: the card's name and power limit (nvidia-smi), and the build of
   every kernel of ``dmx_compressor_tpu_torch/csrc`` (one nvcc per source,
   started together).
2. The seven kernels against their plain PyTorch versions on the card, at
   the paths' shapes (OPT-125m's; and each Llama-topology family's:
   TinyLlama-1.1B, Qwen3-0.6B and Gemma-2B: B1 and T1 at its five linears,
   B2 and B4 at (8, 32, 4, 256, 64), (8, 16, 8, 256, 128) and (8, 8, 1,
   256, 256), B3 at BH 256 (D 64), 128 (D 128) and 64 (D 256), L = S = 128,
   the K/V heads repeated; B1 and T1 also at GPT-2's five linears, its
   tied head N 50257 (odd) at M 8, 1024 and 3, and at Mistral-1b's, its
   merged q/k/v N 3072; B5 (SBFP12_16) at every family's sbfp path shapes,
   q/k/v and gate/up unmerged: the GQA k/v widths 256 and 512, K 5632 and
   16384, the heads N 32000, 50257, 151936 and 256000, M 8 and 1024 and a
   ragged M 130 over each family's longest K) and at ragged ones: max abs error against the stated
   tolerance (T2: bit for bit), the kernel's time, its plain version's, one
   library call's where there is one (a yardstick the port never calls) and
   the bound (bytes, or operations over the H100 SXM's published f32 or
   bf16 tensor-core peak).  B1 bfp_linear, B5 sbfp_linear and T1
   bfp_linear_bf16 share the kernels of csrc/bfp_wgmma.cuh, B1 and B5 on
   three exact bf16 planes of x, T1 on one: a tensor-core GEMV on mma.sync
   with K split over a cluster (decode) and a wgmma mainloop (prefill).  B1
   and B5 at their tile edges, a K split, x near +-FLT_MAX and subnormal x,
   their bound the tensor-core figure (3 x 2MNK at the bf16 peak) with the
   f32 SIMT figure beside it; T1 with B1 timed beside on the same payloads,
   its epilogues and a row of subnormal weights.  B2 flash_decode_int8, B3
   flash_attention (its two products as six bf16 plane products each on
   mma.sync: its bound at the bf16 peak, the f32 figure beside), B4
   flash_decode, T2 bfp_cast (the BFP, FLOAT16 and composed FLOAT16-then-BFP
   modes at the BASIC path's cast sites, the composed one beside its two
   launches; special blocks along the last axis and, through the tile
   kernel, an inner one; the eight probes).  B2 and B4 also at bench.py's
   long shape (S 2048, lengths 2016) and with GQA, each with the same bits
   on a second call; B5 also on its f32 route, at the SBFP formats beyond
   SBFP12_16 that the JAX package serves (a 5-bit scale: two exact bf16
   planes of the weight; a 13-bit scale: three; blocks of 8 and 24), M = 8
   (the f32 GEMV) and 1024 (the weight planes on tensor cores, or the SIMT
   GEMM for the blocks off 16), each case with its route.
3. Five serving paths of OPT-125m at full width from seeded random weights
   (seed 0), each a prefill of batch 8 x prompt 128 then 63 greedy decode
   steps, with the launch counters set to 0 just before and read just after
   (L = 12 layers):
   - weights mode (BFP16_64 packed weights, int8 KV cache): prefill
     4L+1 = 49 B1 + 12 B3, each decode step 49 B1 + 12 B2;
   - SBFP mode (SBFP12_16 packed weights, int8 KV cache): prefill
     6L+1 = 73 B5 + 12 B3, each decode step 73 B5 + 12 B2, every B5 launch
     on its tensor-core route;
   - SBFP mode at another format (sbfp_wide: SBFP with a 5-bit scale, not
     exact in bf16, as a user configures it on every Linear): the same
     counts, every B5 launch on its f32 route (the weight planes at
     prefill, the f32 GEMV at decode);
   - fp32 baseline (BASELINE rules, plain Linears, f32 KV cache): prefill
     12 B3, each decode step 12 B4;
   - fp8 (the JAX package's FP8 rules, ``DmxModel.to_fp8_mode``: AFLOAT8
     Linear and ActActMatMul inputs and weights through float_quantize,
     plain torch as in the JAX package; FLOAT16 boundaries; f32 KV cache),
     at ``FP8_LAYERS`` (1) layer: prefill and each decode step 28L+5 = 33
     T2 (FLOAT16 casts), no attention kernel (the SDPA is not transparent:
     the modular path); its CPU check at the same depth, T2 held at every
     recorded site;
   - BASIC mode (BFP16_64 casts on Linear and ActActMatMul inputs, FLOAT16
     module boundaries, the SOFTMAX and LAYER_NORM surrogates, packed
     BFP16_64 weights, a float16 split cache of 128 + 64 slots): prefill
     4L+1 = 49 T1 + 34L+6 = 414 T2, prepare_split_decode 2L = 24 T2, each
     decode step 49 T1 + 16L+3 = 195 T2 (19L+4 casts: 3L+1 launches are a
     FLOAT16 cast and the BFP cast of its output in one).
   Each path's prefill logits and the logits of its first 7 decode steps are
   held against the same model moved to the CPU (``.to("cpu")``), the CPU
   fed the card's tokens (teacher-forced), and each of the 8 greedy tokens
   against the CPU's choice on the same inputs where the CPU's top-1/top-2
   margin exceeds the path's tolerance; each prints its decode
   tokens/s, the device time of one warm prefill (a second prefill call
   under torch.profiler, split into its packed linears' kernel, B3 and the
   rest), the device busy/idle split of a profiled decode step and a host
   cProfile of the same steps.  The JAX bench's ratios (weights, SBFP,
   sbfp_wide and basic over baseline tokens/s) follow.
   Then three paths of each of bench.py's Llama-topology families at full
   width, cut to ``FAMILY_PATH_LAYERS`` (1) layer, from seed 0, at the same
   batch, prompt and steps:
   ``llama-1.1b`` (TinyLlama-1.1B: 22 layers of 2048, MLP 5632, GQA 32
   query heads over 4 KV heads, vocab 32000, an untied head), ``qwen3-0.6b``
   (Qwen3-0.6B: 28 layers of 1024, 16 query heads over 8 KV heads of 128,
   per-head q / k norms, MLP 3072, vocab 151936, tied) and ``gemma-2b``
   (Gemma-2B: 18 layers of 2048, 8 query heads over one KV head of 256,
   (1 + w) norms, a GeGLU MLP of 16384, vocab 256000, tied).  Llama's at L
   = 1 (Qwen3's and Gemma's the same counts, Qwen3's q / k norms adding 4L
   T2 a prefill and 2L a step):
   - llama_weights (BFP16_64 packed weights, int8 KV cache): prefill
     4L+1 = 5 B1 and no B3 (an int8 prefill attends over the dequantized
     cache through quantized_sdpa, as in the JAX package), each decode step
     5 B1 + 1 B2 (8 query heads a KV head);
   - llama_baseline (BASELINE rules, f32 KV cache): prefill 1 B3 (BH 256,
     the KV heads repeated to the query heads), each decode step 1 B4;
   - llama_basic (BASIC rules, packed BFP16_64 weights, a float16 split
     cache of 128 + 64): prefill 5 T1 + 40L+5 = 45 T2, prepare 2L = 2 T2,
     each decode step 5 T1 + 21L+2 = 23 T2 (24L+3 casts: 3L+1 launches
     are a FLOAT16 cast and the BFP cast of its output in one), every layer
     through the fused step.
   - llama_sbfp (bench.py's sbfp leg: SBFP12_16, scale bias 16, on every
     Linear, the tied heads included; int8 KV): prefill 7L+1 = 8 B5 (q, k,
     v and gate, up unmerged) and no B3, each step 8 B5 + 1 B2, every B5
     launch on its tensor-core route.
   Their CPU check runs the same build at ``FAMILY_CPU_LAYERS`` layers (the
   path's own depth: the card's run moved to the CPU; the basic path's
   rebuilt on the card, where its T2 sites are recorded), prefill and 7
   steps.
   Each BASIC path's card run of that check records every T2 launch's
   shape and axis: T2 is then held bit for bit at each distinct site (the
   BFP, FLOAT16 and composed modes) and timed per launch over one recorded
   decode step.  B3's family cases time flash_prefill's K/V head repeat
   apart; each baseline prefill split shows it beside B3.
   Then three paths each of bench.py's ``gpt2`` (GPT-2 124M: 12 blocks of
   768, 12 heads of 64, a head tied to the 50257-wide vocabulary, cut to
   ``GPT2_LAYERS`` (4), L = 4 in its counts below; its CPU checks at that
   depth, the basic path's at ``FAMILY_CPU_LAYERS``) and ``mistral-1b`` (2048 wide, 32 query heads
   over 8 KV heads of 64, MLP 5632, vocab 32000, untied, a sliding window
   of 128; cut to ``FAMILY_PATH_LAYERS`` (1) of its 16 layers, L = 1 below;
   its CPU check at ``FAMILY_CPU_LAYERS``):
   - gpt2_weights: prefill 4L+1 = 17 B1 and no B3 (an int8 prefill attends
     through quantized_sdpa, as for the families), each step 17 B1 + 4 B2;
   - gpt2_sbfp: prefill 4L+1 = 17 B5 (c_attn born merged, the odd tied
     head), each step 17 B5 + 4 B2;
   - gpt2_baseline: prefill 4 B3, each step 4 B4;
   - gpt2_basic: prefill 17 T1 + 34L+6 = 142 T2, prepare 2L = 8 T2, each
     step 17 T1 + 17L+3 = 71 T2 (OPT's 16L+3 and the tanh-GELU's FLOAT16
     output cast a block), every block through the fused GPT-2 step;
   - mistral_weights: prefill and each step 4L+1 = 5 B1, no B2 or B3 (the
     band keeps the flash kernels away: quantized_sdpa);
   - mistral_sbfp: prefill and each step 7L+1 = 8 B5, no B2 or B3;
   - mistral_baseline: no kernel of the port (cuBLAS f32 and the masked
     sdpa, as the JAX package routes a banded model);
   - mistral_basic: prefill 5 T1 + 40L+5 = 45 T2, prepare 2 T2, each
     step 5 T1 + 21L+2 = 23 T2, every layer through the fused step under
     the banded mask; no B2, B3 or B4 on any Mistral path.
4. Three paths of the continuous-batching engine (serving/engine.py) at
   examples/serving_bench.py's defaults: OPT-125m at full width from seed
   0, 8 slots, bursts of 16, 32 requests of a 96-token prompt and 64 new
   tokens, one bucket of 96, max_len 176, cut to ``ENGINE_CUT_LAYERS`` (2)
   layers:
   - engine_weights: weights mode (BFP16_64, an int8 row cache);
   - engine_weights_chunked: the same with chunked prefill (chunks of 32);
   - engine_raw: the raw model, with an f32 row cache.
   Then engine_llama_weights: the same traffic over TinyLlama-1.1B (full
   width, seed 0, cut to ``ENGINE_LLAMA_LAYERS`` (2) layers) in weights
   mode with int8 row caches of its 4 KV heads: each admission 4L+1 = 9 B1
   (M 96) and no B3 (an int8 prefill attends through quantized_sdpa), each
   decode forward 9 B1 + 2 B2 over the GQA row caches.  Its tokens are held against isolated generation on
   the card for every fourth request, and its CPU check runs those
   requests through the same build cut to ``FAMILY_CPU_LAYERS`` layers in
   an engine on the card and one on the CPU.
   Each runs warmup(), then the closed loop with the launch counters set to
   0 just before and read just after; the counts are derived from the
   engine's admissions and chunks and its decode dispatches: each
   monolithic admission 4L+1 B1 + L B3 (raw: L B3), each decode forward
   4L+1 B1 + L B2 (raw: L B4), each chunk 4L+1 B1 and the chunk at offset 0
   L B3 besides.  Its first steady dispatch (no admission, no chunk) runs
   under torch.cuda.set_sync_debug_mode("error").  Every request's tokens
   are held against isolated generation on the card (greedy_prefill and
   greedy_decode on a static cache outside the engine, the requests of one
   prompt length side by side, up to 8 a batch), and those of the requests
   ENGINE_HELD against the same engine run over them with the model on the
   CPU, by the margin rule of phase 3.  Each path prints
   tokens/s, slot utilization, p50/p99 step times and the device's share
   of a steady step.
5. The encoder-decoder families at full width, from seed 0: t5-small (6 +
   6 layers of 512, 8 heads of 64, ReLU feed-forward 2048, vocab 32128, the
   head tied to the shared table; its attention unscaled, with a bucketed
   relative-position bias, through the modular SDPA) cut to ``T5_LAYERS``
   (2) layers a stack and
   whisper-small (12 + 12 layers of 768, 12 heads of 64, vocab 51865 tied,
   the encoder's Conv1dUnfold front end over [80, 3000] features) cut to
   ``WHISPER_LAYERS`` (2) layers a stack on its paths and engine path, the
   depth of its CPU checks (L = 2 in its counts below).  B1 and
   T1 at their packed linears' shapes (the encoder's and the cross K/V's M
   8 x 128 and 8 x 1500 = 12000, the decoder's 8 and 8 x start, the heads N
   32128 and 51865); B2, B3 and B4 at Whisper's (in phase 2).  Three paths
   each, batch 8, the start tokens (T5 one; Whisper four: its
   <|startoftranscript|><|en|><|transcribe|><|notimestamps|>) prefilled
   over the encoder output into caches of start + 64 slots, 63 steps
   (seq2seq_path_specs: weights 16L+1 B1 / 10L+1 B1, Whisper + L B2, no
   B3; baseline T5 nothing, Whisper L B3 / L B4; basic 16L+1 / 10L+1 T1
   and T5 90L+9 / 52L+5, Whisper 83L+11 / 50L+5 T2), every cross-attention
   K/V recomputed at every step as in the JAX package; their CPU checks at
   T5's path depth and full batch, Whisper's FAMILY_CPU_LAYERS and first row;
   the basic paths' T2 sites held bit for bit.  Then engine_t5_weights and
   engine_whisper_weights: the seq2seq engine at serving_bench's traffic
   (T5 ragged inputs of 32-128 tokens padded to 128 and masked; Whisper a
   [80, 3000] row and 4 start tokens a request), int8 row caches: each
   admission 16L+1 B1, each forward 10L+1 B1 (+ L B2), no host sync in a
   steady dispatch; tokens held against isolated generation and a CPU
   engine run.
6. The vision families and the op zoo: CLIP ViT-B/32 at full width and
   depth (vision 12 layers of 768, 12 heads of 64, 32 x 32 patches through
   the Conv2dUnfold patch embedding; text 12 layers of 512, 8 heads of 64,
   77 positions; projections to 512), seed 0, over
   examples/benchmarking/benchmark_clip.py's inputs (8 standard-normal
   images [3, 224, 224] and 8 prompts of 77 token ids from numpy seed 0):
   B1 and T1 at its eight linear shapes (M 400, 616 and 8), then three
   paths, each ``zero_shot_classify`` and ``__call__`` with the counters
   set to 0 just before and read just after (clip_launches a forward):
   clip_weights 146 B1, clip_baseline none (cuBLAS f32, the modular SDPA),
   clip_basic 146 T1 + (33L+5) + (36L+4) + 2 = 839 T2; each its warm
   forward's device time and peak memory, and its embeddings, logits and
   probabilities held against the model moved to the CPU (LOGIT_TOL;
   clip_basic CLIP_BASIC_TOL), each image's class by the margin rule;
   clip_basic's T2 sites bit for bit.  LeNet-5 over 256 images:
   lenet_baseline no launch, lenet_basic 17 T2 (FLOAT16 casts), its logits
   against the CPU.  The zoo phase: Conv2d, BatchNorm2d, GroupNorm, the
   pools, ReLU6 at a ResNet-50 stage, Conv1d at Whisper's [ZOO_BATCH, 80, 3000],
   ConvTranspose2d 64 -> 64 at stride 2, Exp, BAddBMM and the experimental
   convs, each under BASELINE and BASIC on the card (cuDNN's TF32 flag on)
   against the CPU, its T2 launches held (43 over the BASIC forwards).
7. The PTQ recipes on OPT-125m (full width, seed 0): the recipes phase
   (each piece at one layer's shapes, card vs CPU: the observers' qparams,
   Quantize / DeQuantize, the N:M and TopK masks, FLOP totals and the
   plugins' call log bit for bit; SmoothQuant scales, GPTQ at (64, 128) and
   (128, 128), SLaNC norms and AFT at stated tolerances); ptq_weights (the
   weights-mode rules, SmoothQuant fused, GPTQ, then compressed and served
   as the weights path: the recipes 73 + 1308 T2, then 49 B1 + 12 B3 a
   prefill and 49 B1 + 12 B2 a step; every payload the GPTQ weight bit for
   bit; the recipe run on the card against the CPU at ``FAMILY_CPU_LAYERS``);
   calib_basic (examples/model_calibration.py at CALIB_LAYERS (2): 2860 T2; perplexities and
   INT8 scales card vs CPU at ``FAMILY_CPU_LAYERS``); int8kv_example
   (examples/opt_int8_smoothquant_kv.py: 12 B3 + 84 B2; tokens against the
   CPU).  The SBFP legs of T5, Whisper and CLIP (t5_sbfp, whisper_sbfp,
   clip_sbfp: the weights paths' counts with B5 for B1) run with their
   families' paths, and B5 with B1 and T1 at their shapes.
8. QAT, the model API and the benchmarking examples (qat_basic,
   model_api, benchmarking_examples); then Hugging Face checkpoints in and
   training checkpoints out: hf_pipeline (OPT-125m's seed-0 tensors in HF
   names written as ``model.safetensors`` by :func:`write_safetensors` and
   as ``pytorch_model.bin`` by ``torch.save``, each loaded through
   ``modeling.hf.pipeline`` onto the card, every parameter bit for bit; 64
   greedy tokens from batch 8 x prompt 128 raw (L B3, L B4 a step), over an
   int8 cache (L B3, L B2 a step), under the BASIC rules (44L+7 T2 a
   forward) and in weights mode (4L+1 B1 + L B3, 4L+1 B1 + L B2 a step),
   each the directly built model's tokens bit for bit; card vs CPU at 2
   layers; top-5 sampling twice with one seed), hf_head_dim80 (OPT at
   OPT-2.7b's attention shape, 32 heads of 80, 2 layers: B3, B4 and B2 at
   D 80 card vs CPU, also loaded with dtype bf16 (an f32 model over a bf16
   cache: B4's bf16 route), and timed beside D 64 and 128; the routes of
   fp16 / bf16 caches and operands, B2's query-head groups and head dims
   100 and 512, each against its plain version) and checkpoint_resume
   (QAT at 2 layers: 4 Adam steps, ``CheckpointManager.save``, a fresh
   model restored, 4 more, bit for bit the uninterrupted 8).
9. The export path and functional interception: export (OPT-125m at full
   width and depth, seed 0, ``DmxModel.from_raw(m).to_basic_mode()``: its
   208 compiler graphs, none skipped; each module's graph evaluated on the
   inputs its module saw in one modular BASIC prefill of 8 x 128 (44L+7 =
   535 T2), bit for bit against the module where the graph computes with
   its ops, at SURROGATE_GRAPH_TOL where it is the exact op of a BASIC
   surrogate (LayerNorm, Softmax, the SDPA), every evaluation with its
   module call's T2 launches (535 over the top-level graphs, 703 with the
   SDPA's children); ``export_onnx`` of the card model byte for byte its CPU
   copy's, parsed back, 24L+2 = 290 QuantizeBFP; the ``torch.export``
   program of one decoder layer holding 44 T2 operators, its module's
   output eager's bit for bit with 44 launches; the bucketed programs of its
   fc1 over T 32 / 64 / 128, T 100 dispatched to 128) and intercept
   (``DmxModel.from_function`` over the raw OPT-125m's prefill at 8 x 128
   under ``InterceptRules.basic()``: 8L+1 dots and 11L+2 adds, three T2 a
   site = 693; card vs CPU at FAMILY_CPU_LAYERS layers at BASIC_LOGIT_TOL;
   examples/family_tour.py on the card).  The OPT engine paths' CPU runs
   take the requests ENGINE_HELD since this phase joined.
   Then parallelism (``parallel_phase``): two ranks sharing the card over
   gloo, OPT-125m at full width and PAR_OPT_LAYERS (2) over tp 2 (prefill,
   engine, sharded checkpoint, BASIC), ``pipeline_forward`` at pp 2 over its 12 layers,
   ``ring_attention`` at sp 2 and scaling_bench; TinyLlama-1.1B at full width
   and depth over tp 2 (its shard shapes, 4L+1 = 89 B1 + 22 B3 a prefill,
   the engine's 89 B1 + 22 B2 a forward, the sharded checkpoint, BASIC's T1
   and T2 as unsharded), gemma-2b, qwen3-0.6b and mistral-1b prefills at
   full width, whisper-small at 2 + 2, t5-small and LeNet-5, each against
   its unsharded card run; one NCCL rank through the tp path; and the
   native C++ oracle.  B1, B2 and B3 are also held at the shard shapes.
10. A ``kernels`` JSON line (launches by path, the engine paths included),
   then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--only word,word`` runs only the phases whose name (spaces as underscores)
holds a word, and prints no kernels line.  The script imports nothing of JAX
and nothing of the JAX package.  Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import json
import logging
import math
import os
import subprocess
import sys
import threading
import time
import traceback

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32
# non-tensor-core FLOP/s; a card set below 700 W runs below them
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12  # dense bf16 on the tensor cores
L2_BYTES = 50 * 2**20

BATCH, PROMPT, GEN = 8, 128, 64  # prefill + GEN - 1 decode steps
# the cache capacity of the JAX bench's weights mode: the written slots,
# rounded up to a multiple of 128
CAPACITY = -(-(PROMPT + GEN - 1) // 128) * 128
LOGIT_TOL = 1e-3  # f32 logits, GPU vs CPU: the same math summed in another order
# the BASIC path's logits, GPU vs CPU, fixed before its first run on the
# card: its FLOAT16 and BFP casts round values that the card sums in
# another order (LayerNorm moments, softmax sums), and a rounding that lands
# one step apart propagates.  dmx_compressor_tpu_torch/tools/
# order_sensitivity.py measures that on the CPU at 12 layers of OPT-125m
# width (vocab cut to 2048, seeds 0 and 1): the same model with its matmuls
# and reductions summed in float64 moves a prefill logit by up to 0.0574;
# 0.15 leaves room for the full vocabulary's 25x more logits.
BASIC_LOGIT_TOL = 0.15
# the Llama-topology paths' CPU check (Llama, Qwen3, Gemma): the same build
# cut to this many layers (full width, seed 0), run on the card and on the
# CPU
FAMILY_CPU_LAYERS = 1  # 4 before the PTQ phases joined, 2 before QAT's
# ... and the card's first rows that it holds (the CPU's head over a 151936
# / 256000 vocabulary takes seconds a path at all BATCH rows)
FAMILY_CPU_BATCH = 2
# each family's BASIC path's logits, GPU vs CPU at that depth, fixed before
# the family's first run on the card from tools/order_sensitivity.py
# --family <family> at the family's width, 4 layers, vocab cut to 2048,
# seeds 0 and 1 (the largest move of a prefill logit when the sums run in
# float64): llama 0.1533 (0.1376) -> 0.4, which keeps OPT's ratio of bound
# to measurement (0.15 / 0.0574) for the full vocabulary's 16x more
# logits; qwen3 0.0796 (0.0756) -> 0.25 and gemma 0.1475 (0.0940) -> 0.5,
# about 3.1 and 3.4 times, for their 74x and 125x more logits; gpt2 (its
# check at full depth: 12 layers) 0.0768 (0.0635) -> 0.25 and mistral
# 0.1675 (0.1248) -> 0.5, about 3.3 and 3.0 times, for 25x and 16x more
# logits (a tanh-GELU on the card may land a FLOAT16 step from the CPU's);
# t5 and whisper twice the largest reading of --family t5 / whisper (the
# prefill's and 7 teacher-forced steps' logits, vocab 2048 and the full
# vocabulary, seeds 0 and 1; t5 at its check's full depth and batch: 0.0957
# / 0.0820, 0.1016 / 0.1030 -> 0.21; whisper at its check's 4 layers and
# batch 2: 0.0538 / 0.0606, 0.0686 / 0.0640 -> 0.14)
BASIC_FAMILY_TOL = {"llama": 0.4, "qwen3": 0.25, "gemma": 0.5, "gpt2": 0.25, "mistral": 0.5,
                    "t5": 0.21, "whisper": 0.14}
# the fp8 path's logits, GPU vs CPU at FAMILY_CPU_LAYERS layers, from
# tools/order_sensitivity.py --mode fp8 --layers 4 at OPT-125m's width,
# seeds 0 and 1 (the whole model in float64 against f32 moves a prefill
# logit by up to 0 / 0.1262 at vocab 2048 and 0.0667 / 0 at the full
# vocabulary: lumpy, as where a cast lands a step apart or none does):
# twice the largest reading; no factor for more logits, the full
# vocabulary was measured.  Each AFLOAT8 cast itself is held bit
# for bit, card against CPU (check_fp8_casts)
FP8_LOGIT_TOL = 0.25
B1_TOL = dict(rtol=1e-5, atol=1e-4)  # f32 sums of up to 3072 terms, another order
B2_TOL = dict(rtol=1e-5, atol=2e-5)
B3_TOL = dict(rtol=1e-5, atol=2e-5)
B4_TOL = dict(rtol=1e-5, atol=2e-5)
B5_TOL = dict(rtol=1e-5, atol=1e-4)  # as B1: exact weights, sums in another order
# the sbfp_wide path's weight storage: SBFP with a 5-bit scale, whose
# dequantized weight is not exact in bf16 (two exact bf16 planes)
SBFP_WIDE = "SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}"
# (format, K, N) of SBFP weights beyond SBFP12_16 that the JAX package packs
# and serves, which B5 takes on its f32 route: the 5-bit scale and a 13-bit
# one (three weight planes) at OPT-125m's out_proj, blocks of 8 and 24
SBFP_OTHER_FORMATS = [(SBFP_WIDE, 768, 768),
                      ("SBFP<XP[4,0](CSN)><FP[0|4|13,16](FN)>{16}", 768, 768),
                      ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{8}", 40, 48),
                      ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{24}", 72, 200)]
# the bf16 plane products per K step of B5's planes route (three planes of
# x, two or three of the weight: all six, or the six largest of nine)
B5_PLANE_PRODUCTS = 6
# B3's bf16 plane products per f32 product (csrc/flash_attention.cu)
B3_PLANE_PRODUCTS = 6
LINEAR_KERNELS = ("bfp_linear", "sbfp_linear", "bfp_linear_bf16")

# the engine paths' traffic: examples/serving_bench.py's defaults (8 slots,
# bursts of 16 tokens, 32 requests of a 96-token prompt and 64 new tokens,
# one prompt bucket, max_len 96 + 64 + 16 = 176, pipeline depth 1); the
# chunked path prefills 32 tokens a chunk
ENGINE = dict(slots=8, burst=16, requests=32, prompt=96, gen=64)
ENGINE_CHUNK = 32
ENGINE_LEN = ENGINE["prompt"] + ENGINE["gen"] + ENGINE["burst"]  # the row cache's max_len
# the requests of engine_llama_weights held against isolated generation and
# the CPU, and of the OPT engine paths against the CPU: every fourth, two of
# each wave of eight admissions (the first wave's, and readmissions into
# freed slots)
ENGINE_HELD = list(range(0, ENGINE["requests"], 4))
# per-slot lengths of a steady decode step on the engine's row cache: slots
# spread over their requests' decode, and an idle slot past max_len (its
# kernel reads max_len keys)
ENGINE_ROWS = [ENGINE["prompt"] + 1 + (ENGINE["gen"] * i) // ENGINE["slots"]
               for i in range(ENGINE["slots"] - 1)] + [ENGINE_LEN + 24]
# the int8 engine paths' tokens, card vs CPU and against isolated
# generation: an int8 K/V payload that rounds one step apart on the card
# (f32 sums in another order) moves later logits by more than the f32
# paths' 1e-3
KV8_TOL = 1e-2
# each family's sbfp path's logits, GPU vs CPU (at FAMILY_CPU_LAYERS layers,
# GPT-2 at full depth), from tools/order_sensitivity.py --mode sbfp at the
# family's width, vocab cut to 2048, seeds 0 and 1 (every packed linear
# summed in float64 against f32 moves a prefill logit by up to: llama
# 0.0123, qwen3 0.0139, gemma 0.0014, mistral 0.0159, gpt2 0.0127 at 12
# layers): about 3 times that, as BASIC_FAMILY_TOL, and never below the
# int8 paths' KV8_TOL.  llama_sbfp held at KV8_TOL read 0.0134 at prefill on
# an H100 (B5 held its plain version at every family shape within B5_TOL);
# where a family's tolerance exceeds KV8_TOL, serve_path prints the witness
# of where the gap comes from (kv_witness): the prompt's int8 K/V entries
# apart, card against CPU, and the same prefill's gap over an f32 cache
SBFP_FAMILY_TOL = {"llama": 0.04, "qwen3": 0.05, "gemma": KV8_TOL, "mistral": 0.05,
                   "gpt2": 0.04,
                   # t5_sbfp read 0.0138 at prefill on an H100 (its int8 self-
                   # attention cache is read at prefill): twice that; --family
                   # t5 --mode weights --layers 6 --batch 8 read 0.0060 (a K/V
                   # entry one int8 step apart), --mode sbfp 1.7e-6 (none)
                   "t5": 0.03, "whisper": KV8_TOL}
# the encoder-decoder paths: T5's encoder inputs (128 token ids; the engine's
# ragged 32-128, padded to this capacity), each family's decoder start tokens
# (T5's decoder_start_token_id; Whisper's <|startoftranscript|><|en|>
# <|transcribe|><|notimestamps|> in whisper-small's vocabulary), and the
# rows of the card's batch that Whisper's CPU references run (its encoder
# over 1500 positions and the cross-attention K/V of every step, at M 1500 a
# row, make the CPU slow)
S2S_ENC = 128
# the depth cuts that buy back the time of the encoder-decoder paths: the
# fp8 path and its CPU check (the AFLOAT8 casts are host-bound torch ops,
# ~57 ms of host time a step at 12 layers), engine_weights_chunked and
# engine_raw (the OPT engine's chunked and f32 legs; engine_weights stays at
# full depth) and engine_llama_weights at these depths; widths, traffic and
# every check stay
FP8_LAYERS = 1  # 2 before the QAT, model API and benchmarking phases
# t5-small's paths and engine path (T5_LAYERS a stack), GPT-2's paths
# (GPT2_LAYERS) and examples/model_calibration.py's model (CALIB_LAYERS) cut
# so (full width, every check and count kept; full depth before those
# phases): the time of the new phases
T5_LAYERS = 2
GPT2_LAYERS = 4
CALIB_LAYERS = 2  # 4 before the HF checkpoint phases (12 before QAT's)
# benchmark_clip's synthetic corpus in the benchmarking phase: its first 8
# pairs of the example's N_PAIRS (64), one batch of 8 an evaluation (16
# before the export phases, 64 before the HF checkpoint phases; every mode's
# launches still held)
CLIP_BENCH_PAIRS = 8
# every OPT engine path (engine_weights included) and engine_llama_weights
# at 2 layers (4 before the QAT, model API and benchmarking phases): the
# time of the new phases
ENGINE_CUT_LAYERS = 2
ENGINE_LLAMA_LAYERS = 2
# the paths of bench.py's Llama-topology families (llama, qwen3, gemma,
# mistral) at this depth (full width), that of their CPU checks; GPT-2's
# BASIC CPU check at FAMILY_CPU_LAYERS
FAMILY_PATH_LAYERS = 1  # 4 before the PTQ phases joined, 2 before QAT's
# the depth cut that buys back the vision families' and the op zoo's time:
# whisper-small's paths (weights, baseline, basic) and its engine path at
# this many layers a stack (full width; 4 before QAT's phases joined), that
# of their CPU checks; its kernel phases' shapes stay whisper-small's
WHISPER_LAYERS = 2
S2S_START = {"t5": [0], "whisper": [50258, 50259, 50359, 50363]}
S2S_CPU_BATCH = 1
# the least calls of each timing in the families' kernel phases (B1, T1
# and B5 at the bench.py families' shapes since the vision paths, whose
# heads take up to ~40 ms a call on their plain versions; B1 and T1 at the
# encoder-decoder and CLIP shapes, whose M 12000 cases take ~0.3-1.7 ms):
# every other phase takes time_ms's 10
S2S_TIMED = 5
# clip_basic's T2 sites are timed over this many recorded forwards (839
# launches each; the plain versions' ~30 torch ops a cast are host-bound)
CLIP_T2_TIMED = 2
# the vision families: CLIP ViT-B/32's batch of images and prompts
# (examples/benchmarking/benchmark_clip.py's BATCH) and LeNet-5's
CLIP_BATCH = 8
LENET_BATCH = 256
# the zoo phase's batch (a ResNet-50 stage's, Whisper's 8 feature rows)
ZOO_BATCH = 4
# the clip_basic path's embeddings, logits and probabilities, GPU vs CPU:
# twice the largest reading of tools/order_sensitivity.py --family clip
# --layers 12 --batch 8 --seeds 0 1 on an H100 (the same build with its T1
# matmuls, its modules' activation matmuls and its means and sums in
# float64 moves an image / text embedding by up to 0.0388 / 0.0400, a logit
# by 0.0273, a probability by 0.0028)
CLIP_BASIC_TOL = 0.08
# lenet_basic's logits, GPU vs CPU: tools/order_sensitivity.py --family
# lenet reads 0 (its BFP-cast products and their sums are exact in f32,
# whatever the order), so the f32 paths' tolerance
LENET_BASIC_TOL = LOGIT_TOL
# LeNet-5's launches a forward: none in the baseline; BASIC's FLOAT16 casts
# only, 17 (each conv, pool, ReLU and linear's FLOAT16 output, the pools'
# and ReLUs' FLOAT16 inputs; the BFP casts of the 1 and 6 conv channels and
# of fc1's 400 inputs are off the block, plain torch, and no linear packs)
LENET_LAUNCHES = {"baseline": {}, "basic": {"bfp_cast": 17}}
# the zoo phase's BASIC outputs, GPU vs CPU: a FLOAT16 output whose f32 sum
# ran in another order may land one fp16 step (2^-10 relative) apart;
# twice that
ZOO_BASIC_TOL = dict(rtol=2e-3, atol=1e-4)
# the chunked path against isolated generation: the chunks after the first
# attend over the int8 cache (up to 1/254 of a row's largest value per
# element) where a monolithic prefill attends over the f32 K/V; the run
# measures that gap in a prompt's last logits and fails if it exceeds this
CHUNK_TOL = 5e-2


def log(*args):
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, peak_flop_s: float = PEAK_F32_FLOP_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flop_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_trace(torch, run):
    """(name, device microseconds, launches) of every device kernel of
    ``run()``, from torch.profiler, the one timing source of this script.
    The profiler now and then hands back an empty trace (taken again, up to
    five times in all; empty if all five were) or one that lost some of its
    kernels' records (see :func:`time_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        taken = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0]
        if taken:
            return taken
    return []


def device_events(torch, run):
    """(name, device microseconds) of every device kernel of ``run()``."""
    return [(key, us) for key, us, _ in device_trace(torch, run)]


# the plain versions' timings take this many calls over their first input
# sets (a kernel's at least time_ms's default 10, cycling through every
# set): a plain version is a yardstick, tens of times the kernel's time,
# whose device time moves little from call to call and whose own
# intermediates leave no input warm in L2
PLAIN_ITERS = 3
# a decode step's (or a recorded forward's) timings: the kernel's and the
# library's over this many steps, the plain versions' over one; each step is
# tens to hundreds of launches
STEP_ITERS = 3


def time_by_kernel(torch, fn, arg_sets, min_iters: int = 10) -> dict:
    """Device ms per call of ``fn`` by kernel name: the device time of all
    the work the calls launched (torch.profiler), cycling through
    ``arg_sets`` whose inputs together exceed L2, so each call finds its
    inputs cold as on the main path.  Each kernel counts its mean time a
    launch times its launches a call (its launches over the calls, rounded),
    so a trace that lost a few of a kernel's records is not taken again.
    Raises if the profiler saw no device time."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    iters = max(min_iters, len(arg_sets))

    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    trace = device_trace(torch, run)
    if not trace:
        raise RuntimeError(f"torch.profiler recorded no trace of {fn}")
    return {name: (t / n * round(n / iters) if round(n / iters) else t / iters) / 1e3
            for name, t, n in trace}


def time_ms(torch, fn, arg_sets, min_iters: int = 10) -> float:
    """Device ms per call of ``fn``, all its kernels (:func:`time_by_kernel`)."""
    return sum(time_by_kernel(torch, fn, arg_sets, min_iters).values())


def time_plain(torch, fn, arg_sets, iters: int = PLAIN_ITERS) -> float:
    """A plain version's device ms per call: ``iters`` calls over the first
    ``iters`` input sets (see PLAIN_ITERS)."""
    return time_ms(torch, fn, arg_sets[:iters], iters)


def copies_for(nbytes: int) -> int:
    return max(2, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def same_bits(torch, got, want) -> bool:
    """Equal bit for bit, a NaN meeting a NaN whatever its payload."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def max_err(torch, got, want, tol, what):
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or not torch.allclose(got, want, **tol):
        raise AssertionError(f"{what}: kernel disagrees with its plain version, max_abs_err "
                             f"{err} (tolerance {tol})")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def linear_shapes(cfg):
    """(K, N, launches per forward) of the weights path's packed linears:
    merged qkv, out_proj, fc1 and fc2 per layer, then the LM head."""
    d, f, L = cfg.hidden_size, cfg.ffn_dim, cfg.num_hidden_layers
    return [(d, 3 * d, L), (d, d, L), (d, f, L), (f, d, L), (d, cfg.vocab_size, 1)]


def sbfp_linear_shapes(cfg):
    """(K, N, launches per forward) of the SBFP path's packed linears: q, k,
    v (never merged) and out_proj, fc1 and fc2 per layer, then the LM head."""
    d, f, L = cfg.hidden_size, cfg.ffn_dim, cfg.num_hidden_layers
    return [(d, d, 4 * L), (d, f, L), (f, d, L), (d, cfg.vocab_size, 1)]


def family_linear_shapes(cfg):
    """(K, N, launches per forward) of a Llama-topology family's packed
    linears (Llama, Qwen3, Gemma): merged q/k/v (GQA widths), o_proj, merged
    gate/up and down_proj per layer, then the LM head."""
    d, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, Hkv, D = family_heads(cfg)
    return [(d, (H + 2 * Hkv) * D, L), (H * D, d, L), (d, 2 * m, L), (m, d, L),
            (d, cfg.vocab_size, 1)]


def family_sbfp_linear_shapes(cfg):
    """(K, N, launches per forward) of a Llama-topology family's SBFP
    linears: q, k, v (never merged: the GQA widths), o_proj, gate and up
    (never merged) and down_proj per layer, then the LM head; shapes that
    coincide are counted together."""
    d, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, Hkv, D = family_heads(cfg)
    shapes = {}
    for K, N, n in [(d, H * D, L), (d, Hkv * D, 2 * L), (H * D, d, L), (d, m, 2 * L),
                    (m, d, L), (d, cfg.vocab_size, 1)]:
        shapes[K, N] = shapes.get((K, N), 0) + n
    return [(K, N, n) for (K, N), n in shapes.items()]


def family_heads(cfg):
    """(query heads, KV heads, head_dim) of a Llama-topology config."""
    from dmx_compressor_tpu_torch.models.llama import head_dim_of

    return cfg.num_attention_heads, cfg.num_key_value_heads, head_dim_of(cfg)


def check_linear(torch, dev, label, kern, plain, pack, unpack, nbytes, step_shapes, ragged,
                 tol, seed, peak_flop_s=PEAK_F32_FLOP_S, lib_dtype=None, ab=None, planes=None,
                 route_of=None, step_launches=None, min_iters=10):
    """A dequant-matmul kernel against its plain version at the decode (M =
    batch) and prefill (M = batch x prompt) shapes of ``step_shapes`` and at
    ``ragged`` (M, K, N) shapes; then its time per launch over one decode
    step's launches as the path makes them (each linear of each layer, then
    the head, each launch on its own cold weight).  The library yardstick is
    torch.matmul on the dequantized weight, in ``lib_dtype`` (default f32);
    ``ab`` = (name, kernel) is timed beside on the same payloads.  With
    ``planes`` (B1: 3; its kernels run that many bf16 tensor-core products
    at every shape here, where K and the block are multiples of 16) a shape
    is bounded by them at the bf16 peak (``bound_ms``), the ``peak_flop_s``
    figure kept as ``bound_f32_ms``.  ``route_of(M, K, w)`` -> (route, plane
    products or None), where the kernel picks its route per shape, records
    each case's route and bounds it by its own products (None: f32 SIMT).
    The per-step bound counts each launch's operations in the same way.
    ``step_launches`` ((M, K, N, launches) each, shapes among the cases)
    replaces the decode step's launches at M = batch where a step's linears
    take other rows (an encoder-decoder step's cross-attention K/V).  Each
    timing takes at least ``min_iters`` calls.  Returns (the per-step
    numbers, the cases)."""
    time = functools.partial(time_ms, min_iters=min_iters)
    g = torch.Generator(device=dev).manual_seed(seed)
    cases, sets_of, deq_of = [], {}, {}
    shapes = [(M, K, N) for M in (BATCH, BATCH * PROMPT) for K, N, _ in step_shapes]
    lib_dtype = lib_dtype or torch.float32
    lib_size = torch.tensor([], dtype=lib_dtype).element_size()
    for M, K, N in shapes + ragged:
        per_set = nbytes(M, K, N)
        sets = []
        for _ in range(copies_for(per_set)):
            w = pack(torch.randn(N, K, generator=g, device=dev) * 0.05)
            sets.append((torch.randn(M, K, generator=g, device=dev), w,
                         torch.randn(N, generator=g, device=dev) * 0.1))
        x, w, b = sets[0]
        err = max_err(torch, kern(x, w, b), plain(x, w, b), tol, f"{label} {M}x{K}x{N}")
        ms = time(torch, kern, sets)
        plain_ms = time_plain(torch, plain, sets, min(min_iters, PLAIN_ITERS))
        deq = [(s[0].to(lib_dtype), unpack(s[1]).T.contiguous().to(lib_dtype))
               for s in sets[:copies_for((M * K + N * K + M * N) * lib_size)]]
        lib_ms = time(torch, torch.matmul, deq)
        sets_of[M, K, N], deq_of[M, K, N] = sets, deq
        bound_ms, by = bound(per_set, 2 * M * N * K, peak_flop_s)
        case = dict(shape=[M, K, N], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound_ms, bound_by=by)
        extra, products = "", planes
        if route_of is not None:
            case["route"], products = route_of(M, K, w)
            extra = f" route={case['route']}"
        if products is not None:
            case["bound_f32_ms"] = bound_ms
            case["bound_ms"], case["bound_by"] = bound(per_set, products * 2 * M * N * K,
                                                       PEAK_BF16_FLOP_S)
            bound_ms, by = case["bound_ms"], case["bound_by"]
            extra += (f" bound_f32_ms={case['bound_f32_ms']:.4f} (f32 SIMT; bound_ms is "
                      f"{products} bf16 tensor-core products)")
        if ab is not None:
            case[f"{ab[0]}_ms"] = time(torch, ab[1], sets)
            extra += f" {ab[0]}_ms(same payload)={case[f'{ab[0]}_ms']:.4f}"
        cases.append(case)
        log(f"{label} M={M} K={K} N={N}: max_abs_err={err:.3g} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(torch.matmul, dequantized W, {lib_dtype})="
            f"{lib_ms:.4f}{extra} bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{peak_flop_s/1e12} TFLOP/s)")

    step = [(M, K, N, i) for M, K, N, n in (step_launches or [(BATCH, K, N, n) for K, N, n
                                                                in step_shapes])
            for i in range(n)]
    runs = {}
    timed = [("ms", kern, sets_of), ("plain_ms", plain, sets_of),
             ("library_ms", torch.matmul, deq_of)]
    if ab is not None:
        timed.append((f"{ab[0]}_ms", ab[1], sets_of))
    for what, fn, arg_of in timed:
        args = [arg_of[M, K, N][i % len(arg_of[M, K, N])] for M, K, N, i in step]
        iters = 1 if what == "plain_ms" else min(min_iters, STEP_ITERS)
        runs[what] = time_ms(torch, lambda: [fn(*a) for a in args], [()], iters) / len(step)
    per_launch_bytes = sum(nbytes(M, K, N) for M, K, N, _ in step) / len(step)
    flops = sum(2 * M * N * K for M, K, N, _ in step) / len(step)
    runs["bound_ms"], runs["bound_by"] = bound(per_launch_bytes, flops, peak_flop_s)
    # each launch's operations at the rate of the type it computes in: its
    # route's bf16 plane products on the tensor cores, or f32
    products = [route_of(M, K, sets_of[M, K, N][0][1])[1] if route_of else planes
                for M, K, N, _ in step]
    if any(p is not None for p in products):
        op_s = sum(2 * M * N * K * (p / PEAK_BF16_FLOP_S if p else 1 / peak_flop_s)
                   for (M, K, N, _), p in zip(step, products)) / len(step)
        runs["bound_f32_ms"] = runs["bound_ms"]
        runs["bound_ms"], runs["bound_by"] = bound(per_launch_bytes, op_s * PEAK_BF16_FLOP_S,
                                                   PEAK_BF16_FLOP_S)
    log(f"{label}, one decode step's {len(step)} launches, per launch: "
        + " ".join(f"{k}={v:.4f}" for k, v in runs.items() if k != "bound_by")
        + f" ({runs['bound_by']})")
    return runs, cases


def extreme_x(torch, x):
    """x with the three-plane split's edges: a value near +-FLT_MAX in each
    row (one per row, so no sum overflows), f32 subnormals and -0.0."""
    M, K = x.shape
    rows = torch.arange(M, device=x.device)
    fmax = torch.finfo(torch.float32).max
    x[rows, (7 * rows) % K] = torch.where(rows % 2 == 0, fmax, -fmax)
    x[:, 1::5] *= 1e-39
    x[:, 2::7] = -0.0
    return x


def check_b1(torch, dev, cfg):
    from dmx_compressor_tpu_torch.ops.bfp_linear import bfp_linear, bfp_linear_ref
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, bfp_unpack

    step, cases = check_linear(
        torch, dev, "B1 bfp_linear", bfp_linear, bfp_linear_ref, lambda w: bfp_pack(w, 8, 64),
        bfp_unpack, b1_bytes, linear_shapes(cfg),
        [(5, 192, 200), (12, 192, 129), (17, 768, 127), (65, 192, 129), (129, 256, 300)]
        # the engine's admission prefill (batch 1 at the bucket) and chunks
        + [(m, K, N) for m in (ENGINE["prompt"], ENGINE_CHUNK) for K, N, _ in linear_shapes(cfg)],
        B1_TOL, seed=11,
        planes=3)
    # the three-plane split at its edges: x near +-FLT_MAX (one per row, so
    # no sum overflows), f32 subnormals and -0.0, at the prefill's shape
    g = torch.Generator(device=dev).manual_seed(20)
    M, K, N = BATCH * PROMPT, cfg.hidden_size, cfg.hidden_size
    w = bfp_pack(torch.randn(N, K, generator=g, device=dev) * 0.05, 8, 64)
    x = extreme_x(torch, torch.randn(M, K, generator=g, device=dev))
    err = max_err(torch, bfp_linear(x, w), bfp_linear_ref(x, w), B1_TOL,
                  f"B1 {M}x{K}x{N} with x near +-FLT_MAX, subnormal and -0.0")
    log(f"B1 bfp_linear {M}x{K}x{N}, x near +-FLT_MAX, subnormal and -0.0: max_abs_err={err:.3g} "
        f"(|y| up to {bfp_linear_ref(x, w).abs().max().item():.3g})")
    return step, cases


def check_b5(torch, dev, cfg):
    from dmx_compressor_tpu_torch.numerics.format import Format
    from dmx_compressor_tpu_torch.ops.bfp_linear import (
        sbfp_linear,
        sbfp_linear_ref,
        sbfp_route,
        sbfp_tensor_cores,
    )
    from dmx_compressor_tpu_torch.ops.bfp_pack import sbfp_pack, sbfp_unpack
    from dmx_compressor_tpu_torch.ops.compress import SBFP12_16

    fmt = Format.from_shorthand(SBFP12_16)
    step, cases = check_linear(
        torch, dev, "B5 sbfp_linear", sbfp_linear, sbfp_linear_ref, lambda w: sbfp_pack(w, fmt),
        sbfp_unpack, b5_bytes, sbfp_linear_shapes(cfg),
        [(3, 48, 33), (130, 160, 256), (5, 80, 48), (17, 768, 127), (65, 192, 129)],
        B5_TOL, seed=15, planes=3)
    # the three-plane split at its edges, as for B1, at the prefill's shape
    g = torch.Generator(device=dev).manual_seed(21)
    M, K, N = BATCH * PROMPT, cfg.hidden_size, cfg.hidden_size
    w = sbfp_pack(torch.randn(N, K, generator=g, device=dev) * 0.05, fmt)
    x = extreme_x(torch, torch.randn(M, K, generator=g, device=dev))
    err = max_err(torch, sbfp_linear(x, w), sbfp_linear_ref(x, w), B5_TOL,
                  f"B5 {M}x{K}x{N} with x near +-FLT_MAX, subnormal and -0.0")
    log(f"B5 sbfp_linear {M}x{K}x{N}, x near +-FLT_MAX, subnormal and -0.0: max_abs_err={err:.3g} "
        f"(|y| up to {sbfp_linear_ref(x, w).abs().max().item():.3g})")
    # the sbfp_wide path's format on B5's f32 route at every shape of that
    # path (the GEMV at M = 8 and over a decode step's 73 launches, the
    # weight planes at M = 1024, the head included) and at ragged shapes
    # that reach each of its kernels (the SIMT GEMM at K 208)
    wide = Format.from_shorthand(SBFP_WIDE)

    def wide_route(M, K, w):
        route = sbfp_route(w, M, K)
        return route, (B5_PLANE_PRODUCTS if route == "planes" else None)

    wide_step, wide_cases = check_linear(
        torch, dev, f"B5 sbfp_linear f32 route {SBFP_WIDE}", sbfp_linear, sbfp_linear_ref,
        lambda w: sbfp_pack(w, wide), sbfp_unpack, b5_bytes, sbfp_linear_shapes(cfg),
        [(3, 48, 33), (130, 160, 256), (5, 80, 48), (17, 768, 127), (65, 208, 129)],
        B5_TOL, seed=16, route_of=wide_route)
    for case in wide_cases:
        case["format"] = SBFP_WIDE
    cases += wide_cases
    # the SBFP formats beyond SBFP12_16 that the JAX package packs and
    # serves, on B5's f32 route: the f32 GEMV at M = 8, the weight planes on
    # tensor cores at M = 1024 (the SIMT GEMM for blocks off 16); the library
    # yardstick is torch.matmul on the dequantized weight, as at every B5 case
    for shorthand, K, N in SBFP_OTHER_FORMATS:
        ofmt = Format.from_shorthand(shorthand)
        for M in (BATCH, BATCH * PROMPT):
            sets = [(torch.randn(M, K, generator=g, device=dev),
                     sbfp_pack(torch.randn(N, K, generator=g, device=dev) * 0.05, ofmt),
                     torch.randn(N, generator=g, device=dev)) for _ in range(copies_for(
                         b5_bytes(M, K, N)))]
            if sbfp_tensor_cores(sets[0][1], K):
                raise AssertionError(f"{shorthand} would take B5's tensor cores")
            route = sbfp_route(sets[0][1], M, K)
            err = max_err(torch, sbfp_linear(*sets[0]), sbfp_linear_ref(*sets[0]), B5_TOL,
                          f"B5 f32 route ({route}) {shorthand} {M}x{K}x{N}")
            if not torch.equal(sbfp_linear(*sets[0]), sbfp_linear(*sets[0])):
                raise AssertionError(f"B5 f32 route ({route}) gave other bits on the same inputs")
            ms = time_ms(torch, sbfp_linear, sets)
            plain_ms = time_plain(torch, sbfp_linear_ref, sets)
            deq = [(x, sbfp_unpack(w).T.contiguous()) for x, w, _ in sets]
            lib_ms = time_ms(torch, torch.matmul, deq)
            bound_ms, by = bound(b5_bytes(M, K, N), 2 * M * N * K)
            case = dict(shape=[M, K, N], format=shorthand, planes=sets[0][1].planes, route=route,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=by)
            extra = "f32"
            if route == "planes":
                case["bound_f32_ms"] = bound_ms
                bound_ms, by = case["bound_ms"], case["bound_by"] = bound(
                    b5_bytes(M, K, N), B5_PLANE_PRODUCTS * 2 * M * N * K, PEAK_BF16_FLOP_S)
                extra = (f"{B5_PLANE_PRODUCTS} bf16 tensor-core products; "
                         f"bound_f32_ms={case['bound_f32_ms']:.4f}")
            cases.append(case)
            log(f"B5 sbfp_linear f32 route ({route}) {shorthand} M={M} K={K} N={N}: "
                f"max_abs_err={err:.3g} (tolerance {B5_TOL}; the same bits on a second call) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms(torch.matmul, dequantized W, f32)={lib_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({by}; {extra})")
    return step, cases, wide_step


def gpt2_linear_shapes(cfg):
    """(K, N, launches per forward) of GPT-2's packed linears: c_attn (born
    merged), attn.c_proj, c_fc and mlp.c_proj per block, then the tied head
    (N 50257 at gpt2: odd)."""
    d, L = cfg.n_embd, cfg.n_layer
    return [(d, 3 * d, L), (d, d, L), (d, 4 * d, L), (4 * d, d, L), (d, cfg.vocab_size, 1)]


def check_family_linears(torch, dev, shapes, sbfp_shapes, family, seed, ragged=(),
                         sbfp_ragged=()):
    """B1 and T1 at a family's five linear shapes ``shapes`` (M = batch and
    batch x prompt) and at ``ragged`` (M, K, N) ones, and per launch over
    one of its decode steps' 4L+1 launches; T1's library yardstick a bf16
    torch.matmul.  Then B5 at the SBFP12_16 path's shapes ``sbfp_shapes``
    (q/k/v and gate/up unmerged) and at ``sbfp_ragged`` ones, each case
    with its route, and per launch over one of that path's decode steps;
    its library yardstick torch.matmul on the dequantized weight.  Each
    timing takes at least S2S_TIMED calls.  Returns ((B1's per-step
    numbers, cases), (T1's ...), (B5's ...)), each case marked
    ``path=family``."""
    from dmx_compressor_tpu_torch.numerics.format import Format
    from dmx_compressor_tpu_torch.ops.bfp_linear import (
        bfp_linear,
        bfp_linear_bf16,
        bfp_linear_bf16_ref,
        bfp_linear_ref,
        sbfp_linear,
        sbfp_linear_ref,
    )
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, bfp_unpack, sbfp_pack, sbfp_unpack
    from dmx_compressor_tpu_torch.ops.compress import SBFP12_16

    b1 = check_linear(torch, dev, f"B1 bfp_linear ({family})", bfp_linear, bfp_linear_ref,
                      lambda w: bfp_pack(w, 8, 64), bfp_unpack, b1_bytes, shapes, list(ragged),
                      B1_TOL, seed=seed, planes=3, min_iters=S2S_TIMED)
    t1 = check_linear(torch, dev, f"T1 bfp_linear_bf16 ({family})", bfp_linear_bf16,
                      bfp_linear_bf16_ref, lambda w: bfp_pack(w, 8, 64), bfp_unpack, b1_bytes,
                      shapes, list(ragged), B1_TOL, seed=seed + 1, peak_flop_s=PEAK_BF16_FLOP_S,
                      lib_dtype=torch.bfloat16, min_iters=S2S_TIMED)
    fmt = Format.from_shorthand(SBFP12_16)
    b5 = check_linear(torch, dev, f"B5 sbfp_linear ({family})", sbfp_linear, sbfp_linear_ref,
                      lambda w: sbfp_pack(w, fmt), sbfp_unpack, b5_bytes, sbfp_shapes,
                      list(sbfp_ragged), B5_TOL, seed=seed + 100,
                      route_of=b5_tensor_core_route(family), min_iters=S2S_TIMED)
    for case in b1[1] + t1[1] + b5[1]:
        case["path"] = family
    return b1, t1, b5


# T1's own shapes: diag_bfpkernel_ab.py:177-183, OPT-1.3B decode at M = 8
T1_TPU_SHAPES = [(8, 2048, 6144), (8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048),
                 (8, 2048, 50272)]


def check_t1(torch, dev, cfg):
    """T1 at the BASIC path's linear shapes (M = batch and batch x prompt)
    and at its own TPU shapes, B1 timed beside on the same payloads and a
    bf16 torch.matmul on the dequantized weight as the yardstick; then the
    scalar-load path (K and block no multiple of 16, a ragged M > 16 tile)
    and a weight row of f32 subnormals, to see whether the tensor cores
    flush them.  Returns (the per-step numbers, the cases, the flush
    report)."""
    from dmx_compressor_tpu_torch.ops.bfp_linear import (
        bfp_linear,
        bfp_linear_bf16,
        bfp_linear_bf16_ref,
    )
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, bfp_unpack

    step, cases = check_linear(
        torch, dev, "T1 bfp_linear_bf16", bfp_linear_bf16, bfp_linear_bf16_ref,
        lambda w: bfp_pack(w, 8, 64), bfp_unpack, b1_bytes, linear_shapes(cfg),
        T1_TPU_SHAPES + [(5, 192, 200), (130, 192, 200), (17, 768, 127), (12, 192, 129)],
        B1_TOL, seed=16,
        peak_flop_s=PEAK_BF16_FLOP_S, lib_dtype=torch.bfloat16, ab=("bfp_linear", bfp_linear))
    g = torch.Generator(device=dev).manual_seed(17)
    # the scalar-load path, and both epilogues
    for M, K, N, block in [(3, 72, 40, 8), (37, 72, 130, 8)]:
        w = bfp_pack(torch.randn(N, K, generator=g, device=dev) * 0.05, 8, block)
        x = torch.randn(M, K, generator=g, device=dev)
        b = torch.randn(N, generator=g, device=dev)
        res = torch.randn(M, N, generator=g, device=dev).half().float()
        # a FLOAT16 output may land one fp16 step of itself apart where the
        # sums round differently; the ResAdd output one step of the largest
        # product output
        y16 = bfp_linear_bf16_ref(x, w, b, out_fp16=True)
        ulp = 2.0 ** (torch.floor(torch.log2(y16.abs().max())).item() - 10)
        for kw, tol in (({}, B1_TOL), ({"out_fp16": True}, dict(rtol=2.0**-10, atol=2.0**-14)),
                        ({"out_fp16": True, "residual": res}, dict(rtol=0, atol=ulp))):
            got, want = bfp_linear_bf16(x, w, b, **kw), bfp_linear_bf16_ref(x, w, b, **kw)
            max_err(torch, got, want, tol, f"T1 {M}x{K}x{N} block {block} {sorted(kw)}")
    # one weight row of f32 subnormals (bf16 subnormals too, man * 2^-133 and
    # up); x large enough that the row's outputs are normal f32
    M, K, N = 8, 256, 64
    wf = torch.randn(N, K, generator=g, device=dev) * 0.05
    wf[5] *= 2e-38
    w = bfp_pack(wf, 8, 64)
    x = torch.randn(M, K, generator=g, device=dev) * 1e3
    got, want = bfp_linear_bf16(x, w), bfp_linear_bf16_ref(x, w)
    col = (got[:, 5] - want[:, 5]).abs().max().item() / want[:, 5].abs().max().item()
    flushed = bool((got[:, 5] == 0).all().item())
    log(f"T1 with a row of subnormal weights (exponent {int(w.exponent[5].min())}, "
        f"plain |y| up to {want[:, 5].abs().max().item():.3g}): "
        f"{'flushed to zero' if flushed else 'kept'} by the tensor cores, the row's "
        f"relative error {col:.3g}")
    if flushed or not col <= 1e-5:
        raise AssertionError("T1 flushed or mangled a row of subnormal weights")
    return step, cases, dict(flushed=flushed, rel_err=col)


def t2_step_launches(cfg):
    """(mode, shape, axis) of each T2 launch of one BASIC decode step, in
    launch order: the two embedding output casts; per layer the LN1 input
    cast, LN1's output cast with qkv's input cast (one composed "fp16bfp"
    launch), the decode attention's q, tail-k, scores, mask, resadd, scale,
    softmax output with weights (composed), tail-v and output casts,
    out_proj's input cast, the resadd's residual and output casts, LN2's
    output cast with fc1's input cast (composed), fc2's input cast; the
    head's LN output cast with its input cast (composed)."""
    d, f, H, L = cfg.hidden_size, cfg.ffn_dim, cfg.num_attention_heads, cfg.num_hidden_layers
    D, S, B = d // H, PROMPT + GEN, BATCH
    x, sc = ("fp16", (B, 1, d), -1), ("fp16", (B, H, 1, S), -1)
    layer = [x, ("fp16bfp", (B, 1, d), -1), ("bfp", (B, H, 1, D), -1),
             ("bfp", (B, H, GEN, D), -1), sc, ("fp16", (S,), -1), sc, sc,
             ("fp16bfp", (B, H, 1, S), -1), ("bfp", (B, H, GEN, D), -2),
             ("fp16", (B, H, 1, D), -1), ("bfp", (B, 1, d), -1), x, x,
             ("fp16bfp", (B, 1, d), -1), ("bfp", (B, 1, f), -1)]
    return [x, x] + layer * L + [("fp16bfp", (B, 1, d), -1)]


def special_blocks(torch, n: int = 10):
    """[n * 64] f32: blocks of random values at four scales, a zero block, a
    block of +-0.0, one of f32 subnormals, one whose max rounds up to
    2^(e+1) and clamps, one at the clamp edge, one whose max is 2^126 (where
    the rebase constant overflows)."""
    g = torch.Generator().manual_seed(18)
    blocks = [torch.randn(64, generator=g) * s for s in (1.0, 1e-3, 3e4, 1e-30)]
    blocks += [torch.zeros(64), torch.zeros(64).index_fill_(0, torch.arange(0, 64, 2), -0.0),
               torch.randn(64, generator=g) * 1e-39]
    for i, v in ((5, 1.9999), (9, -(2 - 2.0**-7)), (0, 2.0**126)):
        b = torch.rand(64, generator=g) * 2 - 1
        b[i] = v
        blocks.append(b)
    return torch.cat(blocks[:n])


def t2_run(mode, x, axis, plain=False, wl=8, block=64):
    """One T2 cast of ``x`` in ``mode`` ("bfp", "fp16" or the composed
    "fp16bfp"), by the kernel's wrapper or its plain version."""
    from dmx_compressor_tpu_torch.ops import bfp_cast as T2

    if mode == "fp16":
        return (T2.fp16_cast_ref if plain else T2.fp16_cast)(x)
    if mode == "fp16bfp":
        if plain:
            return T2.bfp_cast_ref(T2.fp16_cast_ref(x), wl, block, axis)
        return T2.bfp_cast(x, wl, block, axis, fp16_first=True)
    return (T2.bfp_cast_ref if plain else T2.bfp_cast)(x, wl, block, axis)


def t2_check(torch, label, mode, x, axis, wl=8, block=64):
    """T2 against its plain version on ``x``, bit for bit."""
    got = t2_run(mode, x, axis, wl=wl, block=block)
    want = t2_run(mode, x, axis, plain=True, wl=wl, block=block)
    if not same_bits(torch, got, want):
        bad = (got.view(torch.int32) != want.view(torch.int32)).sum().item()
        raise AssertionError(f"T2 {label}: {bad} elements differ from the plain version")


def heavy_tailed(torch, shape, g, dev):
    """randn scaled by exp(3 randn): values from f32 subnormals to past the
    FLOAT16 range, for the casts' rounding, flush and clamp."""
    return (torch.randn(shape, generator=g, device=dev)
            * torch.exp(3 * torch.randn(shape, generator=g, device=dev)))


def t2_per_launch(torch, dev, g, step, steps=STEP_ITERS):
    """T2's time per launch over one decode step's launches ``step``
    ((mode, shape, axis[, wl, block]) each; BFP16_64 where wl and block are
    left out), the kernel's and the plain version's, on random inputs of
    those shapes, over ``steps`` steps, and the bytes bound."""
    inputs = [torch.randn(shape, generator=g, device=dev) for _, shape, *_ in step]
    runs = {}
    for what, plain in (("ms", False), ("plain_ms", True)):
        runs[what] = time_ms(torch, lambda: [t2_run(m, x, a, plain, *wb) for (m, _, a, *wb), x
                                             in zip(step, inputs)], [()],
                             min_iters=1 if plain else steps) / len(step)
    runs["launches_per_step"] = len(step)
    runs["library_ms"] = None
    runs["bound_ms"], runs["bound_by"] = bound(
        sum(8 * math.prod(shape) for _, shape, *_ in step) / len(step), 0)
    return runs


@contextlib.contextmanager
def record_t2(into: list):
    """Appends (mode, shape, axis, wl, block) of every T2 call made inside
    the block to ``into``: each is one launch on the card.  The model's
    modules call the casts through the module (``T2.bfp_cast``), so the
    wrappers are swapped there for the block's length."""
    from dmx_compressor_tpu_torch.ops import bfp_cast as T2

    bfp, fp16 = T2.bfp_cast, T2.fp16_cast

    def rec_bfp(x, wl, block, axis=-1, fp16_first=False):
        into.append(("fp16bfp" if fp16_first else "bfp", tuple(x.shape),
                     axis % x.ndim - x.ndim, wl, block))
        return bfp(x, wl, block, axis, fp16_first)

    def rec_fp16(x):
        into.append(("fp16", tuple(x.shape), -1, 8, 64))
        return fp16(x)

    T2.bfp_cast, T2.fp16_cast = rec_bfp, rec_fp16
    try:
        yield
    finally:
        T2.bfp_cast, T2.fp16_cast = bfp, fp16


def check_t2_sites(torch, dev, sites, step, what, steps=STEP_ITERS, unit="decode step"):
    """T2 against its plain version, bit for bit, at every cast site that a
    path's run recorded (``sites``: (mode, shape, axis, wl, block) from
    :func:`record_t2`): each distinct shape and axis in the BFP, FLOAT16 and
    composed modes (the FLOAT16 mode alone where the axis takes no block),
    on heavy-tailed inputs; then the time per launch over the recorded
    decode step ``step`` (over ``steps`` steps; ``unit`` names what ``step``
    is).  Returns (the per-step numbers, the cases)."""
    g = torch.Generator(device=dev).manual_seed(20)
    counts = {}
    for _, shape, axis, wl, block in sites:
        counts[shape, axis, wl, block] = counts.get((shape, axis, wl, block), 0) + 1
    cases = []
    for (shape, axis, wl, block), n in sorted(counts.items()):
        x = heavy_tailed(torch, shape, g, dev)
        modes = ("bfp", "fp16", "fp16bfp") if shape[axis] % block == 0 else ("fp16",)
        for mode in modes:
            t2_check(torch, f"{what} {mode} {list(shape)} axis {axis}", mode, x, axis, wl, block)
        cases.append(dict(site=what, shape=list(shape), axis=axis, wl=wl, block=block,
                          modes=list(modes), recorded_calls=n, max_abs_err=0.0))
        log(f"T2 bfp_cast at a {what} site {list(shape)} axis {axis} (BFP wl {wl} block "
            f"{block}; {n} of the recorded launches), modes {', '.join(modes)}: bit-exact")
    runs = t2_per_launch(torch, dev, g, step, steps)
    log(f"T2 bfp_cast, a {what} {unit}'s {len(step)} launches, per launch: "
        f"kernel_ms={runs['ms']:.4f} plain_ms={runs['plain_ms']:.4f} "
        f"bound_ms={runs['bound_ms']:.6f} (bytes)")
    return runs, cases


def check_t2(torch, dev, cfg):
    """T2 against its plain version, bit for bit, at the BASIC path's cast
    sites (the BFP, FLOAT16 and composed FLOAT16-then-BFP modes at each;
    timed in the modes the path casts in there, the composed one beside its
    two launches), on special blocks along the
    last axis and along an inner axis (the tile kernel; 5 columns, no
    multiple of 4), and through the eight probes; then its time per launch
    over one decode step's launches.  Returns (the per-step numbers, the
    cases)."""
    from dmx_compressor_tpu_torch.ops import bfp_cast as T2

    run, check = t2_run, functools.partial(t2_check, torch)
    g = torch.Generator(device=dev).manual_seed(19)
    d, f, H = cfg.hidden_size, cfg.ffn_dim, cfg.num_attention_heads
    D, B = d // H, BATCH
    sites = [("x", (B, d), -1), ("x", (B, f), -1), ("q", (B, H, 1, D), -1),
             ("tail k", (B, H, GEN, D), -1), ("scores", (B, H, 1, PROMPT + GEN), -1),
             ("tail v", (B, H, GEN, D), -2), ("prefill x", (B * PROMPT, d), -1),
             ("prefill x", (B * PROMPT, f), -1), ("prefill scores", (B, H, PROMPT, PROMPT), -1)]
    # the modes the BASIC path casts in at each site (t2_step_launches; a
    # prefill's modular casts are never composed): only these are timed, every
    # mode is held bit for bit at every site
    on_path = {("x", f): ("bfp",), ("q", D): ("bfp",), ("tail k", D): ("bfp",),
               ("tail v", D): ("bfp",), ("scores", PROMPT + GEN): ("fp16", "fp16bfp"),
               ("x", d): ("bfp", "fp16", "fp16bfp")}
    cases = []
    for label, shape, axis in sites:
        n = math.prod(shape)
        sets = [(heavy_tailed(torch, shape, g, dev),) for _ in range(copies_for(8 * n))]
        timed = on_path.get((label, shape[-1]), ("bfp", "fp16"))
        for mode in ("bfp", "fp16", "fp16bfp"):
            check(f"{mode} {label} {list(shape)} axis {axis}", mode, sets[0][0], axis)
            if mode not in timed:
                log(f"T2 bfp_cast {mode} {label} {list(shape)} axis {axis}: bit-exact (a mode "
                    f"the path does not cast in there: not timed)")
                continue
            ms = time_ms(torch, lambda x: run(mode, x, axis), sets)
            plain_ms = time_plain(torch, lambda x: run(mode, x, axis, plain=True), sets)
            bound_ms, by = bound(8 * n, 0)
            case = dict(mode=mode, site=label, shape=list(shape), axis=axis, max_abs_err=0.0,
                        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                        bound_by=by)
            extra = ""
            if mode == "fp16bfp":  # the two launches it replaces, on the same inputs
                case["two_launches_ms"] = time_ms(
                    torch, lambda x: T2.bfp_cast(T2.fp16_cast(x), 8, 64, axis), sets)
                extra = f" two_launches_ms(fp16_cast, then bfp_cast)={case['two_launches_ms']:.4f}"
            cases.append(case)
            log(f"T2 bfp_cast {mode} {label} {list(shape)} axis {axis}: bit-exact, "
                f"kernel_ms={ms:.4f}{extra} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
                f"({by}; 8 B per element at {PEAK_BYTES_S/1e12} TB/s)")
    sp = special_blocks(torch).to(dev)
    for mode in ("bfp", "fp16", "fp16bfp"):
        check(f"{mode} special blocks along the last axis", mode, sp.reshape(5, 128) * 3e4, -1)
        check(f"{mode} special blocks along the last axis", mode, sp.reshape(5, 128), -1)
    # the same ten blocks along an inner axis (the tile kernel): [2, 64, 5]
    # with blocks on dim 1, five columns (no multiple of 4: one float a lane)
    # and, tiled 4 times, twenty (a float4 a lane)
    inner = sp.reshape(2, 5, 64).transpose(1, 2).contiguous()
    for mode in ("bfp", "fp16bfp"):
        check(f"{mode} special blocks along an inner axis", mode, inner, -2)
        check(f"{mode} special blocks along an inner axis of 20", mode,
              inner.repeat(1, 1, 4).contiguous() * 3e4, -2)
    log("T2 bfp_cast on zero, -0.0, subnormal, clamp-edge, 2^126 and fp16-saturating blocks, "
        "the BFP, FLOAT16 and composed modes, last and inner axis: bit-exact")
    for probe in T2.PROBES:
        x = torch.randn(B, d, generator=g, device=dev) * (8.0 if probe == "d" else 3.0)
        if probe == "h":
            x = x[:, :d // 64].contiguous()
        if not same_bits(torch, T2.probe(probe, x), T2.probe_ref(probe, x)):
            raise AssertionError(f"T2 probe ({probe}) disagrees with its plain version")
    log(f"T2 probes ({', '.join(T2.PROBES)}) at [{B}, {d}]: bit-exact")

    step = t2_step_launches(cfg)
    runs = t2_per_launch(torch, dev, g, step)
    runs["step_ms"] = runs["ms"] * len(step)
    log(f"T2 bfp_cast, one decode step's {len(step)} launches, per launch: "
        f"kernel_ms={runs['ms']:.4f} plain_ms={runs['plain_ms']:.4f} "
        f"bound_ms={runs['bound_ms']:.6f} (bytes); the step's T2 device time "
        f"{runs['step_ms']:.4f} ms")
    return runs, cases


def b1_bytes(M, K, N):
    """x, int8 mantissas, int8 exponents, bias in; y out."""
    return M * K * 4 + N * K + N * K // 64 + N * 4 + M * N * 4


def b5_bytes(M, K, N):
    """x, int4 nibbles (0.5 B/weight), f32 scales per 16-block (0.25
    B/weight), bias in; y out."""
    return M * K * 4 + N * K // 2 + N * K // 16 * 4 + N * 4 + M * N * 4


def b2_bytes_flops(B, H, Hkv, D, lengths):
    keys = sum(lengths)
    nbytes = 2 * B * H * D * 4 + keys * Hkv * (2 * D + 8) + B * 4
    return nbytes, 4 * keys * (H // Hkv) * Hkv * D


def b4_bytes_flops(B, H, Hkv, D, lengths, kv_bytes=4):
    """q in and out written; the K/V rows below each row's length
    (``kv_bytes`` an element: 4 in f32, 2 over a 16-bit cache); the
    lengths.  Two dot products of D per key and query head."""
    keys = sum(lengths)
    return 2 * B * H * D * 4 + keys * Hkv * 2 * D * kv_bytes + B * 4, 4 * keys * H * D


def whisper_decode_shape(wcfg):
    """(H, Hkv, S, D, lengths) of whisper-small's decode steps over the
    weights path's int8 cache (its mean fill over the 63 steps), and the
    engine's row cache (max_len and per-slot lengths as ENGINE_ROWS, an idle
    slot past max_len)."""
    H = wcfg.decoder_attention_heads
    D, T0 = wcfg.d_model // H, len(S2S_START["whisper"])
    S, eng_len = T0 + GEN, T0 + ENGINE["gen"] + ENGINE["burst"]
    rows = [T0 + 1 + (ENGINE["gen"] * i) // ENGINE["slots"]
            for i in range(ENGINE["slots"] - 1)] + [eng_len + 24]
    return (H, H, S, D, [T0 + GEN // 2] * BATCH), (H, H, eng_len, D, rows)


def check_b2(torch, dev, cfg, fams, wcfg):
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops.flash_decode import flash_decode_int8, flash_decode_int8_ref
    from dmx_compressor_tpu_torch.ops.kv_cache import QuantizedKVCache, QuantKV

    g = torch.Generator(device=dev).manual_seed(12)
    cases = []
    # (H, Hkv, S, D, lengths): the main path's shape (its cache capacity at
    # the mean fill of its decode steps), ragged per-row lengths over an S that
    # is no multiple of a chunk, bench.py's long leg (prompt 1984 in a
    # 2048-slot cache, lengths 2016 half way through its 64 steps), GQA
    # (12 query heads on 4 KV heads, ragged) and the engine's row cache
    # (ENGINE_ROWS); and each Llama-topology family's weights path (llama:
    # 8 query heads a KV head; qwen3: 2 at head_dim 128; gemma: 8 over its
    # one KV head at head_dim 256), engine_llama_weights' GQA row cache;
    # then a ragged Gemma case, S no multiple of a chunk
    B, H = BATCH, cfg.num_attention_heads
    D = cfg.hidden_size // H
    mean_fill = PROMPT + GEN // 2
    shapes = [(H, H, CAPACITY, D, [mean_fill] * B, None),
              (H, H, 200, D, [1 + (199 * i) // (B - 1) for i in range(B)], None),
              (H, H, 2048, D, [2016] * B, None),
              (H, max(1, H // 3), 300, D, [1 + (299 * i) // (B - 1) for i in range(B)], None),
              (H, H, ENGINE_LEN, D, ENGINE_ROWS, None)]
    shapes += [(*family_heads(f)[:2], CAPACITY, family_heads(f)[2], [mean_fill] * B, name)
               for name, f in fams.items()]
    Hl, Hkv_l, D_l = family_heads(fams["llama"])
    shapes.append((Hl, Hkv_l, ENGINE_LEN, D_l, ENGINE_ROWS, "engine_llama_weights"))
    Hg, Hkv_g, D_g = family_heads(fams["gemma"])
    shapes.append((Hg, Hkv_g, 600, D_g, [1 + (599 * i) // (B - 1) for i in range(B)], None))
    # whisper-small's decode step (whisper_weights) and its engine's row cache
    path_shape, engine_shape = whisper_decode_shape(wcfg)
    shapes += [(*path_shape, "whisper_weights"), (*engine_shape, "engine_whisper_weights")]
    # a tp-2 rank's decode step (parallel phase): half the heads; TinyLlama's
    # (16 query heads over 2 KV heads) and gemma-2b's (4 over its one KV
    # head, replicated); whisper-small's (6 heads)
    shapes.append((H // PAR_TP, H // PAR_TP, CAPACITY, D, [mean_fill] * B, "parallel_tp2"))
    for f in ("llama", "gemma"):
        Hf, Hkv_f, D_f = family_heads(fams[f])
        shapes.append((Hf // PAR_TP, tp_kv_heads(Hkv_f), CAPACITY, D_f, [mean_fill] * B,
                       f"parallel_{f}_tp2"))
    Hw, _, Sw, Dw, lw = path_shape
    shapes.append((Hw // PAR_TP, Hw // PAR_TP, Sw, Dw, lw, "parallel_whisper_tp2"))
    for H, Hkv, S, D, lengths, path in shapes:
        per_set = B * Hkv * S * (2 * D + 8) + 2 * B * H * D * 4
        sets = []
        for _ in range(copies_for(per_set)):
            kq, ks = QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g, device=dev))
            vq, vs = QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g, device=dev))
            sets.append((torch.randn(B, H, 1, D, generator=g, device=dev),
                         QuantKV(kq, vq, ks, vs),
                         torch.tensor(lengths, dtype=torch.int32, device=dev)))
        q, kv, le = sets[0]
        got = flash_decode_int8(q, kv, le)
        err = max_err(torch, got, flash_decode_int8_ref(q, kv, le),
                      B2_TOL, f"B2 Hkv={Hkv} S={S} lengths={lengths}")
        if not torch.equal(flash_decode_int8(q, kv, le), got):
            raise AssertionError("B2 gave other bits on the same inputs")
        ms = time_ms(torch, flash_decode_int8, sets)
        plain_ms = time_plain(torch, flash_decode_int8_ref, sets)
        lib_sets = []
        for q_, kv_, le_ in sets[:copies_for(B * Hkv * S * D * 8 + 2 * B * H * D * 4)]:
            k = kv_.k_q.float() * kv_.k_scale[..., None]
            v = kv_.v_q.float() * kv_.v_scale[..., None]
            mask = (torch.arange(S, device=dev)[None, :] < le_[:, None])[:, None, None, :]
            lib_sets.append((q_, k, v, mask))
        lib_ms = time_ms(torch, lambda q_, k, v, m: F.scaled_dot_product_attention(
            q_, k, v, attn_mask=m, enable_gqa=Hkv != H), lib_sets)
        bound_ms, by = bound(*b2_bytes_flops(B, H, Hkv, D, [min(n, S) for n in lengths]))
        cases.append(dict(shape=[B, H, Hkv, S, D], lengths=lengths, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        if path is not None:
            cases[-1]["path"] = path
        log(f"B2 flash_decode_int8 B={B} H={H} Hkv={Hkv} S={S} D={D} lengths={lengths}: "
            f"max_abs_err={err:.3g} (the same bits on a second call) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} "
            f"library_ms(F.scaled_dot_product_attention, dequantized K/V)={lib_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{PEAK_F32_FLOP_S/1e12} f32 TFLOP/s)")
    return cases


def check_b3(torch, dev, cfg, fams, wcfg):
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops.flash_attention import (
        attention_route, flash_attention, flash_attention_ref)

    g = torch.Generator(device=dev).manual_seed(13)
    cases = []
    # the main path's prefill (L = S = prompt, causal), L < S with the
    # diagonal at S - L, an additive bias, and the engine's batch-1 prefill
    # at its bucket and its first chunk; and each Llama-topology family's
    # baseline prefill (llama: 32 query heads over 4 KV heads at head_dim
    # 64; qwen3: 16 over 8 at 128; gemma: 8 over 1 at 256; flash_prefill
    # repeats the K/V heads to the query heads before the kernel, a copy
    # timed here apart; the bound counts the K/V of the KV heads, as the
    # function flash_prefill computes reads them); then the wide kernel
    # (head_dim 128 and 256) at L < S with a bias.  A shape that takes the
    # wgmma route (attention_route; qwen3's) gets the KV heads as they are,
    # as flash_prefill hands them; the others the repeated K/V their kernels
    # take, the repeat timed apart
    H = cfg.num_attention_heads
    D = cfg.hidden_size // H
    shapes = [(BATCH, H, H, PROMPT, PROMPT, D, False, None),
              (BATCH, H, H, 64, 192, D, False, None),
              (BATCH, H, H, 100, 160, D, True, None),
              (1, H, H, ENGINE["prompt"], ENGINE["prompt"], D, False, None),
              (1, H, H, ENGINE_CHUNK, ENGINE_CHUNK, D, False, None)]
    shapes += [(BATCH, *family_heads(f)[:2], PROMPT, PROMPT, family_heads(f)[2], False, name)
               for name, f in fams.items()]
    shapes += [(2, 3, 3, 100, 160, d, True, None) for d in (128, 256)]
    # whisper_baseline's decoder prefill: its 4 start tokens over the f32 cache
    Hw, T0 = wcfg.decoder_attention_heads, len(S2S_START["whisper"])
    shapes.append((BATCH, Hw, Hw, T0, T0, wcfg.d_model // Hw, False, "whisper_baseline"))
    # a tp-2 rank's prefill (parallel phase): half the heads, BH 48; and
    # TinyLlama's, gemma-2b's and qwen3-0.6b's local heads (16 over 2, 4
    # over 1, 8 over 4)
    shapes.append((BATCH, H // PAR_TP, H // PAR_TP, PROMPT, PROMPT, D, False, "parallel_tp2"))
    for f in ("llama", "gemma", "qwen3"):
        Hf, Hkv_f, D_f = family_heads(fams[f])
        shapes.append((BATCH, Hf // PAR_TP, tp_kv_heads(Hkv_f), PROMPT, PROMPT, D_f, False,
                       f"parallel_{f}_tp2"))
    for B, H, Hkv, L, S, D, with_bias, path in shapes:
        per_set = 4 * B * D * (2 * H * L + 2 * Hkv * S) + (4 * B * H * L * S if with_bias else 0)
        route = attention_route("flash_attention", H, Hkv, D,
                                (torch.float32,) * (4 if with_bias else 3), S=S)
        sets, kv_sets = [], []
        for _ in range(copies_for(per_set)):
            q = torch.randn(B, H, L, D, generator=g, device=dev)
            k = torch.randn(B, Hkv, S, D, generator=g, device=dev)
            v = torch.randn(B, Hkv, S, D, generator=g, device=dev)
            bias = torch.randn(B, H, L, S, generator=g, device=dev) if with_bias else None
            kv_sets.append((k, v))
            if route == "wgmma":
                sets.append((q, k, v, bias))
            else:
                sets.append((q, torch.repeat_interleave(k, H // Hkv, dim=1),
                             torch.repeat_interleave(v, H // Hkv, dim=1), bias))

        def kern(q, k, v, bias):
            return flash_attention(q, k, v, bias, causal=True)

        def plain(q, k, v, bias):
            return flash_attention_ref(q, k, v, bias, causal=True)

        err = max_err(torch, kern(*sets[0]), plain(*sets[0]), B3_TOL,
                      f"B3 L={L} S={S} bias={with_bias}")
        ms = time_ms(torch, kern, sets)
        plain_ms = time_plain(torch, plain, sets)
        # the library yardstick: one SDPA call with a float mask, built
        # beforehand, that carries the bias and the causal diagonal at S - L
        allowed = torch.ones(L, S, dtype=torch.bool, device=dev).tril(S - L)
        lib_sets = []
        for (q, _, _, bias), (k, v) in list(zip(sets, kv_sets))[:copies_for(
                per_set + 4 * B * H * L * S)]:
            mask = torch.zeros(L, S, device=dev) if bias is None else bias
            lib_sets.append((q, k, v, mask.masked_fill(~allowed, -math.inf)))

        def library(q, k, v, mask, _gqa=H != Hkv):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=_gqa)

        lib_err = (library(*lib_sets[0]) - plain(*sets[0])).abs().max().item()
        lib_ms = time_ms(torch, library, lib_sets)
        pairs = sum(min(S, i + (S - L) + 1) for i in range(L))
        # the kernel takes each of its two products as B3_PLANE_PRODUCTS
        # bf16 tensor-core products; the f32 SIMT figure is kept beside
        bound_f32_ms, _ = bound(per_set, 4 * B * H * D * pairs)
        bound_ms, by = bound(per_set, B3_PLANE_PRODUCTS * 4 * B * H * D * pairs, PEAK_BF16_FLOP_S)
        cases.append(dict(shape=[B * H, L, S, D], bias=with_bias, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                          bound_f32_ms=bound_f32_ms, route=route or "main"))
        if path is not None:
            cases[-1]["path"] = path
        gqa = ""
        if Hkv != H and route == "wgmma":
            cases[-1]["kv_heads"] = Hkv
            gqa = (f" ({Hkv} KV heads, read as they are on the wgmma route: kernel_ms holds its "
                   f"pre-pass; library_ms is SDPA with enable_gqa on the {Hkv} heads)")
        elif Hkv != H:
            # flash_prefill's head repeat of K and V, one layer's
            cases[-1]["kv_heads"] = Hkv
            cases[-1]["repeat_ms"] = time_ms(
                torch, lambda k, v: (torch.repeat_interleave(k, H // Hkv, dim=-3),
                                     torch.repeat_interleave(v, H // Hkv, dim=-3)), kv_sets)
            gqa = (f" ({Hkv} KV heads; the bound reads their K/V once; flash_prefill's "
                   f"repeat of K and V to {H} heads before the kernel: "
                   f"repeat_ms={cases[-1]['repeat_ms']:.4f} a layer, library_ms is SDPA "
                   f"with enable_gqa on the {Hkv} heads)")
        log(f"B3 flash_attention BH={B * H} L={L} S={S} D={D} causal bias={with_bias} "
            f"route={route or 'main'}{gqa}: "
            f"max_abs_err={err:.3g} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(F.scaled_dot_product_attention, float mask)={lib_ms:.4f} "
            f"(its max_abs_err against the plain version {lib_err:.3g}) "
            f"bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{B3_PLANE_PRODUCTS} bf16 tensor-core products per f32 product at "
            f"{PEAK_BF16_FLOP_S/1e12} TFLOP/s) bound_f32_ms={bound_f32_ms:.4f} "
            f"({PEAK_F32_FLOP_S/1e12} f32 TFLOP/s)")
    return cases


# B3's wgmma route at Qwen3-0.6B's scoring shape (portbench's
# qwen3-0.6b.weights-score: 4 rows of 4096 tokens, 16 query heads over 8 KV
# heads of 128, causal), beside the wide kernel over the K/V repeated to the
# query heads; then the shapes the route's thresholds (WGMMA_MIN_KEYS over as
# many KV heads as query heads, WGMMA_MIN_KEYS_GQA over fewer) were set from,
# (B, H, Hkv, L = S), both routes timed
B3_WGMMA_SCORE = (4, 16, 8, 4096)
B3_CROSSOVER = [(8, 16, 16, 128), (8, 16, 16, 144), (8, 16, 16, 160), (8, 16, 16, 176),
                (8, 16, 16, 192), (8, 16, 16, 256), (1, 8, 8, 256), (8, 16, 8, 64),
                (8, 16, 8, 96), (8, 16, 8, 128), (1, 16, 8, 1024)]


@contextlib.contextmanager
def b3_route(tfa, route):
    """B3 launches take ``route`` ("wgmma" or "main") whatever their keys:
    the thresholds moved to 1 or past any S while the block runs."""
    keep = tfa.WGMMA_MIN_KEYS, tfa.WGMMA_MIN_KEYS_GQA
    tfa.WGMMA_MIN_KEYS = tfa.WGMMA_MIN_KEYS_GQA = 1 if route == "wgmma" else 1 << 62
    try:
        yield
    finally:
        tfa.WGMMA_MIN_KEYS, tfa.WGMMA_MIN_KEYS_GQA = keep


def check_b3_wgmma(torch, dev, kernels):
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops import flash_attention as tfa

    g = torch.Generator(device=dev).manual_seed(19)
    D, f32 = 128, (torch.float32,) * 3

    def make_sets(B, H, Hkv, T):
        per_set = 4 * B * D * (2 * H * T + 2 * Hkv * T)
        return per_set, [tuple(torch.randn(B, h, T, D, generator=g, device=dev)
                               for h in (H, Hkv, Hkv)) for _ in range(copies_for(per_set))]

    def kern(q, k, v):
        return tfa.flash_attention(q, k, v, causal=True)

    def split(times, needle):
        return sum(ms for name, ms in times.items() if needle in name)

    B, H, Hkv, T = B3_WGMMA_SCORE
    per_set, sets = make_sets(B, H, Hkv, T)
    want = tfa.flash_attention_ref(*sets[0], causal=True)
    r0 = kernels.ROUTE_LAUNCHES.get("flash_attention/wgmma", 0)
    err = max_err(torch, kern(*sets[0]), want, B3_TOL, "B3 wgmma at the qwen3 scoring shape")
    if kernels.ROUTE_LAUNCHES.get("flash_attention/wgmma", 0) != r0 + 1:
        raise AssertionError("B3 at the qwen3 scoring shape did not take the wgmma route")
    with b3_route(tfa, "main"):
        wide_err = max_err(torch, kern(*sets[0]), want, B3_TOL,
                           "B3 wide at the qwen3 scoring shape")
    del want
    new = time_by_kernel(torch, kern, sets)
    with b3_route(tfa, "main"):
        old = time_by_kernel(torch, kern, sets)
    plain_ms = time_plain(torch, lambda q, k, v: tfa.flash_attention_ref(q, k, v, causal=True),
                          sets)

    def library(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    lib_ms = time_ms(torch, library, sets)
    pairs = T * (T + 1) // 2
    bound_ms, by = bound(per_set, B3_PLANE_PRODUCTS * 4 * B * H * D * pairs, PEAK_BF16_FLOP_S)
    score = dict(shape=[B, H, Hkv, T, T, D], route="wgmma", max_abs_err=err,
                 wide_max_abs_err=wide_err, ms=sum(new.values()),
                 main_ms=split(new, "kernel_wgmma"), split_kv_ms=split(new, "split_kv"),
                 wide_ms=split(old, "wide_kernel"),
                 repeat_ms=sum(old.values()) - split(old, "wide_kernel"), plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=bound_ms, bound_by=by)
    log(f"B3 wgmma at the qwen3 scoring shape B={B} H={H} Hkv={Hkv} L=S={T} D={D} causal: "
        f"max_abs_err={err:.3g} (the wide kernel's {wide_err:.3g} on the same inputs) "
        f"kernel_ms={score['ms']:.4f} (flash_attention_kernel_wgmma {score['main_ms']:.4f} + "
        f"its pre-pass flash_attention_kernel_split_kv {score['split_kv_ms']:.4f}); the wide "
        f"kernel {score['wide_ms']:.4f} + the K/V repeat before it {score['repeat_ms']:.4f}; "
        f"plain_ms={plain_ms:.4f} library_ms(F.scaled_dot_product_attention, is_causal, "
        f"enable_gqa)={lib_ms:.4f} bound_ms={bound_ms:.4f} ({by}; {B3_PLANE_PRODUCTS} bf16 "
        f"products per f32 product at {PEAK_BF16_FLOP_S/1e12} TFLOP/s)")
    del sets
    cases = [score]
    for B, H, Hkv, T in B3_CROSSOVER:
        _, sets = make_sets(B, H, Hkv, T)
        route = tfa.attention_route("flash_attention", H, Hkv, D, f32, S=T) or "main"
        ms = {}
        for r in ("wgmma", "main"):
            with b3_route(tfa, r):
                ms[r] = time_ms(torch, kern, sets)
        cases.append(dict(shape=[B, H, Hkv, T, T, D], route=route, wgmma_ms=ms["wgmma"],
                          main_ms=ms["main"]))
        log(f"B3 crossover B={B} H={H} Hkv={Hkv} L=S={T} D={D} causal: the wgmma route "
            f"{ms['wgmma']:.4f} ms (its pre-pass included), the wide kernel {ms['main']:.4f} ms "
            f"(the K/V repeat included where Hkv < H); the rule takes {route}")
    return cases


def check_b4(torch, dev, cfg, fams, wcfg):
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

    g = torch.Generator(device=dev).manual_seed(14)
    cases = []
    # (B, H, Hkv, S, D, lengths): the baseline path's shape (its cache
    # capacity at the mean fill of its decode steps), bench.py's long leg
    # (prompt 1984 in a 2048-slot cache, lengths 2016 half way through its
    # 64 steps) at the path's batch and at batch 1 with 8000 keys, GQA with
    # rep 4 and ragged lengths, a scalar length at D 32, and D 128 over an S
    # that is no multiple of a tile, the engine's row cache (ENGINE_ROWS),
    # and each Llama-topology family's baseline path (llama: 8 query heads a
    # KV head; qwen3: 2 at head_dim 128; gemma: 8 over its one KV head at
    # 256), then Gemma's head_dim over ragged rows in two chunks
    H = cfg.num_attention_heads
    D = cfg.hidden_size // H
    paths = {}
    for name, f in fams.items():
        paths[BATCH, *family_heads(f)[:2], CAPACITY, family_heads(f)[2]] = name
    Hg, Hkv_g, D_g = family_heads(fams["gemma"])
    # whisper_baseline's decode step over its f32 cache
    Hw, _, Sw, Dw, lw = whisper_decode_shape(wcfg)[0]
    family_keys = list(paths)
    paths[BATCH, Hw, Hw, Sw, Dw] = "whisper_baseline"
    for B, H_, Hkv, S, D_, lengths in [
        (BATCH, Hw, Hw, Sw, Dw, lw),
        (BATCH, H, H, CAPACITY, D, [PROMPT + GEN // 2] * BATCH),
        (ENGINE["slots"], H, H, ENGINE_LEN, D, ENGINE_ROWS),
        (BATCH, H, H, 2048, D, [2016] * BATCH),
        (1, H, H, 8192, D, [8000]),
        (3, 8, 2, 256, 64, [17, 256, 130]),
        (2, 4, 4, 192, 32, 100),
        (2, 8, 8, 200, 128, [57, 200]),
        *[(*key, [PROMPT + GEN // 2] * BATCH) for key in family_keys],
        (3, Hg, Hkv_g, 1500, D_g, [1500, 1025, 7]),
    ]:
        rows = lengths if isinstance(lengths, list) else [lengths] * B
        per_set = 2 * B * Hkv * S * D_ * 4 + 2 * B * H_ * D_ * 4
        sets = []
        for _ in range(copies_for(per_set)):
            le = (torch.tensor(lengths, dtype=torch.int32, device=dev)
                  if isinstance(lengths, list) else lengths)
            sets.append((torch.randn(B, H_, 1, D_, generator=g, device=dev),
                         torch.randn(B, Hkv, S, D_, generator=g, device=dev),
                         torch.randn(B, Hkv, S, D_, generator=g, device=dev), le))
        got = flash_decode(*sets[0])
        err = max_err(torch, got, flash_decode_ref(*sets[0]), B4_TOL,
                      f"B4 B={B} H={H_} Hkv={Hkv} S={S} D={D_} lengths={lengths}")
        if not torch.equal(flash_decode(*sets[0]), got):
            raise AssertionError("B4 gave other bits on the same inputs")
        ms = time_ms(torch, flash_decode, sets)
        plain_ms = time_plain(torch, flash_decode_ref, sets)
        # the library yardstick: one SDPA call on the same f32 K/V with a
        # boolean length mask built beforehand
        mask = (torch.arange(S, device=dev)[None, :]
                < torch.tensor(rows, device=dev)[:, None])[:, None, None, :]
        lib_sets = [(q, k, v, mask) for q, k, v, _ in sets]

        def library(q, k, v, m, _gqa=H_ != Hkv):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=_gqa)

        lib_err = (library(*lib_sets[0]) - flash_decode_ref(*sets[0])).abs().max().item()
        lib_ms = time_ms(torch, library, lib_sets)
        bound_ms, by = bound(*b4_bytes_flops(B, H_, Hkv, D_, [min(n, S) for n in rows]))
        cases.append(dict(shape=[B, H_, Hkv, S, D_], lengths=lengths, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        if (B, H_, Hkv, S, D_) in paths:
            cases[-1]["path"] = paths[B, H_, Hkv, S, D_]
        log(f"B4 flash_decode B={B} H={H_} Hkv={Hkv} S={S} D={D_} lengths={lengths}: "
            f"max_abs_err={err:.3g} (the same bits on a second call) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} "
            f"library_ms(F.scaled_dot_product_attention, boolean length mask)={lib_ms:.4f} "
            f"(its max_abs_err against the plain version {lib_err:.3g}) "
            f"bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{PEAK_F32_FLOP_S/1e12} f32 TFLOP/s)")
    return cases


# ---------------------------------------------------------------------------
# phase 3: the serving paths
# ---------------------------------------------------------------------------


# the profiler's name marks of the kernels a decode step launches
T1_MARKS = ("bfp_decode_kernel", "bfp_wgmma_kernel", "split_planes_kernel",
            "bfp_bf16_ragged_kernel")
T2_MARKS = ("bfp_rows_kernel", "bfp_rows_vec_kernel", "bfp_tile_kernel", "fp16_kernel",
            "fp16_vec_kernel")
B1_MARKS = ("bfp_decode_kernel", "bfp_gemm_kernel", "bfp_wgmma_kernel", "split_planes_kernel")
B2_MARKS = ("flash_decode_int8_kernel",)
B3_MARKS = ("flash_attention_kernel", "flash_attention_wide_kernel")
B5_MARKS = ("bfp_decode_kernel", "sbfp_gemm_kernel", "bfp_wgmma_kernel", "split_planes_kernel")


def sbfp_spec(name, n_linear, attention_layers, model=None, **extra):
    """bench.py's sbfp leg of a family (``build_sbfp_mode``: SBFP12_16,
    scale bias 16, on every Linear, the tied head included; int8 KV): prefill
    ``n_linear`` B5 and no B3 (an int8 prefill attends through
    quantized_sdpa), each step ``n_linear`` B5 + ``attention_layers`` B2,
    every B5 launch on its tensor-core route; its logits held against the CPU
    at the family's SBFP_FAMILY_TOL, and where that exceeds KV8_TOL the
    witness of where the gap comes from (``kv_witness``: serve_path)."""
    from dmx_compressor_tpu_torch.ops.compress import build_sbfp_mode

    step = {"sbfp_linear": n_linear}
    family = name.split("_")[0]
    if attention_layers:
        step["flash_decode_int8"] = attention_layers
    spec = dict(name=name, build=build_sbfp_mode, cache=dict(max_len=CAPACITY, quantized=True),
                prefill={"sbfp_linear": n_linear}, prepare=None, step=step,
                routes=({"tensor_cores": n_linear}, {"tensor_cores": n_linear}),
                marks={k: {"sbfp_linear": B5_MARKS, "flash_decode_int8": B2_MARKS}[k]
                       for k in step}, logit_tol=SBFP_FAMILY_TOL[family],
                kv_witness=SBFP_FAMILY_TOL[family] > KV8_TOL, **extra)
    if model is not None:
        spec["model"] = model
    return spec


def build_fp8_mode(model):
    """The JAX package's FP8 configuration: ``DmxModel.from_raw(model)
    .to_fp8_mode()`` (AFLOAT8 Linear and ActActMatMul inputs and weights,
    FLOAT32 biases, FLOAT16 boundaries, no surrogate); the Linears stay
    plain (no packing: AFLOAT8 is no block format)."""
    from dmx_compressor_tpu_torch.modeling.model import DmxModel

    return DmxModel.from_raw(model).to_fp8_mode()


def check_fp8_casts(model):
    """The fp8 path's AFLOAT8 casts (plain torch: float_quantize) on the card
    against the same casts on the CPU, bit for bit: each weight cast of the
    built model on its weight, and each distinct format of its casts but
    FLOAT16 (T2's, held at its sites by check_t2_sites) on a seeded
    activation tensor whose values span 2^-30 to 2^20 (past AFLOAT8's range
    both ways), with zeros, -0.0, f32 subnormals, +-inf and NaN among
    them."""
    import torch

    from dmx_compressor_tpu_torch import format as formats
    from dmx_compressor_tpu_torch.numerics.cast import CastTo
    from dmx_compressor_tpu_torch.numerics.format import Same

    n_weights = 0
    for name, m in model.named_modules():
        cast = getattr(m, "weight_cast", None)
        if cast is None or isinstance(cast.format, Same):
            continue
        w = m.weight.detach()
        if not same_bits(torch, cast.format.cast(w).cpu(), cast.format.cast(w.cpu())):
            raise AssertionError(f"fp8 path: {name}'s weight cast {cast.format} differs on the "
                                 f"card from the CPU")
        n_weights += 1
    fmts = {repr(c.format): c.format for c in model.modules()
            if isinstance(c, CastTo) and not isinstance(c.format, Same)
            and repr(c.format) != repr(formats.FLOAT16)}
    g = torch.Generator().manual_seed(23)
    x = torch.randn(BATCH, PROMPT, 3072, generator=g) * torch.exp2(
        torch.randint(-30, 21, (BATCH, PROMPT, 3072), generator=g).float())
    x.view(-1)[:8] = torch.tensor([0.0, -0.0, 1e-40, -1e-42, float("inf"), -float("inf"),
                                   float("nan"), 2.0**-126])
    dev = next(model.parameters()).device
    for shorthand, fmt in sorted(fmts.items()):
        if not same_bits(torch, fmt.cast(x.to(dev)).cpu(), fmt.cast(x)):
            raise AssertionError(f"fp8 path: the cast {shorthand} differs on the card from the CPU")
    log(f"fp8 path: {n_weights} weight casts and {len(fmts)} cast formats "
        f"({', '.join(sorted(fmts))}) on {x.numel()} activations, card against CPU: bit for bit")


def path_specs(cfg):
    """The five serving paths: name, build function, init_cache arguments,
    the launches at prefill, in prepare_split_decode (None: not called) and
    per decode step (``routes``: B5's by route at prefill and per step), the
    profiler's name marks of each kernel launched per step, and the logits'
    tolerance GPU vs CPU."""
    import dataclasses

    from dmx_compressor_tpu_torch.ops.compress import (
        build_baseline_mode,
        build_basic_mode,
        build_sbfp_mode,
        build_weights_mode,
    )

    L = cfg.num_hidden_layers
    return [
        dict(name="weights", build=build_weights_mode,
             cache=dict(max_len=CAPACITY, quantized=True),
             prefill={"bfp_linear": 4 * L + 1, "flash_attention": L}, prepare=None,
             step={"bfp_linear": 4 * L + 1, "flash_decode_int8": L},
             marks={"bfp_linear": B1_MARKS, "flash_decode_int8": B2_MARKS},
             logit_tol=LOGIT_TOL),
        dict(name="sbfp", build=build_sbfp_mode, cache=dict(max_len=CAPACITY, quantized=True),
             prefill={"sbfp_linear": 6 * L + 1, "flash_attention": L}, prepare=None,
             step={"sbfp_linear": 6 * L + 1, "flash_decode_int8": L},
             routes=({"tensor_cores": 6 * L + 1}, {"tensor_cores": 6 * L + 1}),
             marks={"sbfp_linear": ("bfp_decode_kernel", "sbfp_gemm_kernel", "bfp_wgmma_kernel",
                                    "split_planes_kernel"),
                    "flash_decode_int8": B2_MARKS},
             logit_tol=LOGIT_TOL),
        # a user's SBFP format off bf16 on every Linear: B5's f32 route, the
        # weight planes at prefill (K 768 and 3072, blocks of 16) and the
        # f32 GEMV at decode
        dict(name="sbfp_wide", build=lambda m: build_sbfp_mode(m, SBFP_WIDE),
             cache=dict(max_len=CAPACITY, quantized=True),
             prefill={"sbfp_linear": 6 * L + 1, "flash_attention": L}, prepare=None,
             step={"sbfp_linear": 6 * L + 1, "flash_decode_int8": L},
             routes=({"planes": 6 * L + 1}, {"gemv": 6 * L + 1}),
             marks={"sbfp_linear": ("sbfp_gemv_kernel", "bfp_wgmma_kernel",
                                    "split_planes_kernel"),
                    "flash_decode_int8": B2_MARKS},
             logit_tol=LOGIT_TOL),
        dict(name="baseline", build=build_baseline_mode, cache=dict(max_len=CAPACITY),
             prefill={"flash_attention": L}, prepare=None, step={"flash_decode": L},
             marks={"flash_decode": ("flash_decode_kernel",)}, logit_tol=LOGIT_TOL),
        # the JAX package's FP8 mode: every FLOAT16 cast of f32 is one T2
        # launch, 28 a layer (each Linear's output, LayerNorm's and ReLU's
        # input and output, each ResAdd's two inputs and output, the
        # attention's two products' outputs, its mask add, softmax's input
        # and output) + 5 (the two embeddings', the final LayerNorm's two and
        # the head's output), at prefill and at every step alike; the
        # AFLOAT8 casts are plain torch (float_quantize, jnp in the JAX
        # package too); the attention is not transparent (AFLOAT8 inputs):
        # the modular SDPA over the f32 cache, no B3 or B4.  Its CPU check
        # runs the same build cut to FAMILY_CPU_LAYERS layers (the AFLOAT8
        # casts are slow on the CPU: ~37 s at full depth), on the card,
        # where its T2 sites are recorded, and on the CPU.  The path and its
        # check run at FP8_LAYERS (2: 61 T2 a forward); its host-bound steps
        # at 12 layers took 72 s of the script
        dict(name="fp8", build=build_fp8_mode, cache=dict(max_len=CAPACITY),
             prefill={"bfp_cast": 28 * FP8_LAYERS + 5}, prepare=None,
             step={"bfp_cast": 28 * FP8_LAYERS + 5}, marks={"bfp_cast": T2_MARKS},
             run_cfg=dataclasses.replace(cfg, num_hidden_layers=FP8_LAYERS),
             cpu_cfg=dataclasses.replace(cfg, num_hidden_layers=FP8_LAYERS),
             check_built=check_fp8_casts, cpu_fold=True, logit_tol=FP8_LOGIT_TOL,
             record_t2=True),
        # bench.py's basic mode: a float16 split cache, base = prompt, tail =
        # the 64 decode slots (PROMPT + GEN = 192 slots; the tail is a
        # multiple of the BFP block, so not CAPACITY).  The prefill runs the
        # modular pipeline: per layer 34 FLOAT16 / BFP casts (LN 2, qkv 2,
        # SDPA 14, out_proj 2, resadd 3, LN 2, fc1 2, ReLU 2, fc2 2, resadd 3),
        # + 2 embedding casts + the final LN's 2 and the head's 2; each of the
        # 4L+1 linears one T1.  prepare_split_decode casts each layer's base k
        # and v.  A decode step runs the fused step and head: 19 casts per
        # layer + 4 in 16 launches per layer + 3 (t2_step_launches: 3 per
        # layer and the head's are a FLOAT16 cast and a BFP cast in one), 4L+1 T1.
        dict(name="basic", build=build_basic_mode,
             cache=dict(max_len=PROMPT + GEN, dtype="float16", split_base_len=PROMPT),
             prefill={"bfp_linear_bf16": 4 * L + 1, "bfp_cast": 34 * L + 6},
             prepare={"bfp_cast": 2 * L},
             step={"bfp_linear_bf16": 4 * L + 1, "bfp_cast": 16 * L + 3},
             marks={"bfp_linear_bf16": T1_MARKS, "bfp_cast": T2_MARKS},
             # the CPU reference over the card's first 3 rows (384 prefill
             # rows: the modular path, as the card's 1024)
             logit_tol=BASIC_LOGIT_TOL, cpu_batch=3),
    ]


def family_path_specs(fcfg, family):
    """The three paths of a Llama-topology family (bench.py's llama-1.1b,
    qwen3-0.6b and gemma-2b legs), as :func:`path_specs`: the launches at
    prefill, in prepare_split_decode and per decode step (L layers), the
    CPU check at ``FAMILY_CPU_LAYERS`` layers, the logits' tolerance (f32
    1e-3, int8 KV8_TOL, BASIC the family's from BASIC_FAMILY_TOL), and for
    the BASIC path the check that every layer and the head take the fused
    decode step."""
    import dataclasses

    from dmx_compressor_tpu_torch.models.gemma import GemmaForCausalLM
    from dmx_compressor_tpu_torch.models.llama import LlamaForCausalLM
    from dmx_compressor_tpu_torch.models.mistral import MistralForCausalLM
    from dmx_compressor_tpu_torch.models.qwen3 import Qwen3ForCausalLM
    from dmx_compressor_tpu_torch.ops.basic_layer import (
        basic_gemma_layer_plan,
        basic_llama_layer_plan,
        basic_qwen3_layer_plan,
        basic_rms_head_plan,
    )
    from dmx_compressor_tpu_torch.ops.compress import (
        build_baseline_mode,
        build_basic_mode,
        build_weights_mode,
    )

    # the model, the fused step's plan, and the T2 casts a layer adds to
    # Llama's at prefill and a decode step: Qwen3's q / k norms take 2
    # FLOAT16 casts each at prefill (the modular RMSNorm) and one each in a
    # fused step (the output cast; q and k arrive on the grid)
    model, plan, extra_prefill, extra_step = {
        "llama": (LlamaForCausalLM, basic_llama_layer_plan, 0, 0),
        "qwen3": (Qwen3ForCausalLM, basic_qwen3_layer_plan, 4, 2),
        "gemma": (GemmaForCausalLM, basic_gemma_layer_plan, 0, 0),
        "mistral": (MistralForCausalLM, basic_llama_layer_plan, 0, 0),
    }[family]
    # a banded model (Mistral's sliding window) never reaches B2, B3 or B4:
    # its attention runs quantized_sdpa or the masked sdpa, as in the JAX
    # package, and its BASIC decode the fused split decode under the band
    banded = getattr(fcfg, "sliding_window", None) is not None
    L = fcfg.num_hidden_layers
    # the CPU check's build at FAMILY_CPU_LAYERS; a path already at that
    # depth is moved to the CPU as it is (the basic path rebuilds it on the
    # card, where its T2 sites are recorded)
    check_cfg = dataclasses.replace(fcfg, num_hidden_layers=FAMILY_CPU_LAYERS)
    common = dict(model=model, cpu_cfg=None if fcfg == check_cfg else check_cfg,
                  cpu_batch=FAMILY_CPU_BATCH)

    def fused_everywhere(m):
        if any(plan(layer) is None for layer in m.model.layers) or basic_rms_head_plan(
                m.model.norm, m.lm_head, gemma_norm=m.gemma_norm) is None:
            raise AssertionError(f"{family}_basic: a layer or the head would not take the fused "
                                 f"decode step")
        log(f"{family}_basic path: {plan.__name__} holds for all {L} layers and "
            f"basic_rms_head_plan for the head: every decode step takes the fused step")

    weights_step = {"bfp_linear": 4 * L + 1, "flash_decode_int8": L}
    baseline = dict(prefill={"flash_attention": L}, step={"flash_decode": L},
                    marks={"flash_decode": ("flash_decode_kernel",)})
    # bench.py's sbfp leg: q, k, v, o_proj, gate, up and down_proj each
    # their own B5 launch (7L+1 with the head); no B2 under the band
    sbfp = sbfp_spec(f"{family}_sbfp", 7 * L + 1, 0 if banded else L, **common)
    if banded:
        weights_step = {"bfp_linear": 4 * L + 1}
        baseline = dict(prefill={}, step={}, marks={})  # cuBLAS f32 and the masked sdpa
    return [
        # an int8 prefill attends over the dequantized cache (quantized_sdpa,
        # plain torch): no B3
        dict(common, name=f"{family}_weights", build=build_weights_mode,
             cache=dict(max_len=CAPACITY, quantized=True),
             prefill={"bfp_linear": 4 * L + 1}, prepare=None, step=weights_step,
             marks={k: {"bfp_linear": B1_MARKS, "flash_decode_int8": B2_MARKS}[k]
                    for k in weights_step}, logit_tol=KV8_TOL),
        sbfp,
        dict(common, name=f"{family}_baseline", build=build_baseline_mode,
             cache=dict(max_len=CAPACITY), prepare=None, logit_tol=LOGIT_TOL, **baseline),
        # the modular prefill: per layer 40 FLOAT16 / BFP casts (RMSNorm 2,
        # qkv 2, RoPE 6, SDPA 14, o_proj 2, resadd 3, RMSNorm 2, gate-up 2,
        # SiLU or GELU 2, down 2, resadd 3; Mul SAME; Qwen3's q / k norms 4
        # more), + the embedding's 1, the final norm's 2 and the head's 2; a
        # decode step's fused layer 21 launches (RMS input 1, RMS output with
        # qkv input 1, RoPE cos / sin / q / k 4, the decode attention 9,
        # o_proj 1, resadd 2, RMS output with gate-up input 1, SiLU or GELU
        # 1, down 1; Qwen3's q / k norms 2 more), + the embedding's 1 and the
        # head's composed 1
        dict(common, name=f"{family}_basic", build=build_basic_mode,
             cache=dict(max_len=PROMPT + GEN, dtype="float16", split_base_len=PROMPT),
             prefill={"bfp_linear_bf16": 4 * L + 1, "bfp_cast": (40 + extra_prefill) * L + 5},
             prepare={"bfp_cast": 2 * L},
             step={"bfp_linear_bf16": 4 * L + 1, "bfp_cast": (21 + extra_step) * L + 2},
             marks={"bfp_linear_bf16": T1_MARKS, "bfp_cast": T2_MARKS},
             check_built=fused_everywhere, logit_tol=BASIC_FAMILY_TOL[family], record_t2=True,
             cpu_cfg=check_cfg),
    ]


def gpt2_path_specs(gcfg):
    """The three paths of GPT-2 (bench.py's gpt2 legs), as
    :func:`family_path_specs`, at full width and ``gcfg``'s depth, its CPU
    checks at that depth but the basic path's, which rebuilds it at FAMILY_CPU_LAYERS
    on the card to record its T2 sites.  Its attention routes as the families' (an int8 prefill
    through quantized_sdpa: no B3); a block is OPT's with NewGELU for ReLU,
    whose FLOAT16 pair takes ReLU's two casts at prefill and adds its output
    cast to a fused decode step."""
    import dataclasses

    from dmx_compressor_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from dmx_compressor_tpu_torch.ops.basic_layer import basic_gpt2_block_plan, basic_head_plan
    from dmx_compressor_tpu_torch.ops.compress import (
        build_baseline_mode,
        build_basic_mode,
        build_weights_mode,
    )

    L = gcfg.n_layer

    def fused_everywhere(m):
        if any(basic_gpt2_block_plan(b) is None for b in m.transformer.h) or basic_head_plan(
                m.transformer.ln_f, m.lm_head) is None:
            raise AssertionError("gpt2_basic: a block or the head would not take the fused "
                                 "decode step")
        log(f"gpt2_basic path: basic_gpt2_block_plan holds for all {L} blocks and "
            f"basic_head_plan for the head: every decode step takes the fused step")

    return [
        dict(name="gpt2_weights", model=GPT2LMHeadModel, build=build_weights_mode,
             cache=dict(max_len=CAPACITY, quantized=True),
             prefill={"bfp_linear": 4 * L + 1}, prepare=None,
             step={"bfp_linear": 4 * L + 1, "flash_decode_int8": L},
             marks={"bfp_linear": B1_MARKS, "flash_decode_int8": B2_MARKS}, logit_tol=KV8_TOL),
        # bench.py's sbfp leg: c_attn (born merged), attn.c_proj, c_fc and
        # mlp.c_proj a block and the tied head N 50257 (odd), 4L+1 B5
        sbfp_spec("gpt2_sbfp", 4 * L + 1, L, model=GPT2LMHeadModel),
        dict(name="gpt2_baseline", model=GPT2LMHeadModel, build=build_baseline_mode,
             cache=dict(max_len=CAPACITY), prefill={"flash_attention": L}, prepare=None,
             step={"flash_decode": L}, marks={"flash_decode": ("flash_decode_kernel",)},
             logit_tol=LOGIT_TOL),
        # the modular prefill: OPT's 34 casts a layer (GELU's pair for
        # ReLU's), + the two embeddings', the final LN's 2 and the head's 2;
        # a fused decode step 17 launches a block (OPT's 16 and the GELU's
        # output cast; its input is c_fc's FLOAT16 output) + 3
        dict(name="gpt2_basic", model=GPT2LMHeadModel, build=build_basic_mode,
             cache=dict(max_len=PROMPT + GEN, dtype="float16", split_base_len=PROMPT),
             prefill={"bfp_linear_bf16": 4 * L + 1, "bfp_cast": 34 * L + 6},
             prepare={"bfp_cast": 2 * L},
             step={"bfp_linear_bf16": 4 * L + 1, "bfp_cast": 17 * L + 3},
             marks={"bfp_linear_bf16": T1_MARKS, "bfp_cast": T2_MARKS},
             cpu_cfg=dataclasses.replace(gcfg, n_layer=FAMILY_CPU_LAYERS),
             check_built=fused_everywhere, logit_tol=BASIC_FAMILY_TOL["gpt2"], record_t2=True),
    ]


def host_profile(torch, name, run, steps):
    """Where the host's time goes in ``run()`` (``steps`` decode steps):
    cProfile's Python calls and its top functions by own time, per step
    (cProfile's own overhead included, so the total exceeds the unprofiled
    step)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    log(f"{name} host profile: {st.total_calls / steps:.0f} Python calls, "
        f"{st.total_tt * 1e3 / steps:.3f} ms per decode step under cProfile")
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:6]
    for (file, line, fn), (_, calls, own, _, _) in top:
        log(f"  host per step: {own * 1e3 / steps:.3f} ms own time, {calls / steps:.0f} calls  "
            f"{fn} ({file.rsplit('/', 1)[-1]}:{line})")


def serve_path(torch, dev, kernels, cfg, spec):
    """One serving path: the model (``spec["model"]``, OPT by default) at
    full width from seed 0, built by ``spec["build"]``, prefill,
    [prepare_split_decode,] then GEN - 1 greedy decode steps with the launch
    counters set to 0 just before and read after each part; its profile;
    the CPU check (with ``spec["cpu_cfg"]``, of the same build at that
    config's depth, run on the card and on the CPU).  Returns (the launch
    counts, decode tokens/s)."""
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.models.shared import greedy_decode, greedy_prefill, greedy_token
    from dmx_compressor_tpu_torch.ops.split_decode import prepare_split_decode

    name = spec["name"]
    cfg = spec.get("run_cfg", cfg)  # a path cut in depth
    make = spec.get("model", OPTForCausalLM)
    # the decoder's prompt (an encoder-decoder path's start tokens) and the
    # CPU reference's batch (the first rows of the card's)
    prompt, nb = spec.get("prompt", PROMPT), spec.get("cpu_batch", BATCH)
    cache_kw = dict(spec["cache"])
    if "dtype" in cache_kw:
        cache_kw["dtype"] = getattr(torch, cache_kw["dtype"])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = make(cfg, device=dev, seed=0)
    spec["build"](model)
    torch.cuda.synchronize()
    log(f"{name} path: {type(model).__name__} {cfg.hidden_size}x{cfg.num_hidden_layers} built "
        f"in {time.perf_counter() - t0:.2f} s; peak device memory while building "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held after")
    if "check_built" in spec:
        spec["check_built"](model)
    ids = (spec["ids"]() if "ids" in spec else
           torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(1)))

    def prefill(caches, ids_):
        """Prefill [and prepare]; (logits, first token, launches after the
        prefill)."""
        logits, tok = greedy_prefill(model, caches, ids_)
        after = dict(kernels.LAUNCHES)
        routes["prefill"] = dict(kernels.ROUTE_LAUNCHES)
        if spec["prepare"] is not None:
            prepare_split_decode(model, caches)
        return logits, tok, after

    caches = model.init_cache(BATCH, device=dev, **cache_kw)
    routes = {}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits, tok, after_prefill = prefill(caches, ids.to(dev))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prepare = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    toks, rows = greedy_decode(model, caches, tok, prompt, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"{name} path: peak device memory over the prefill and decode "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    want_prefill = {**zero, **spec["prefill"]}
    want_prepare = {k: v + (spec["prepare"] or {}).get(k, 0) for k, v in want_prefill.items()}
    want_total = {k: v + spec["step"].get(k, 0) * (GEN - 1) for k, v in want_prepare.items()}
    log(f"{name} path: launches after prefill {after_prefill} (expected {want_prefill}); "
        + (f"after prepare_split_decode {after_prepare} (expected {want_prepare}); "
           if spec["prepare"] is not None else "")
        + f"after {GEN - 1} decode steps {launches} (expected {want_total})")
    if after_prefill != want_prefill or after_prepare != want_prepare or launches != want_total:
        raise AssertionError(f"the {name} path did not launch the kernels the expected "
                             f"number of times")
    if "routes" in spec:
        pre, step = ({f"sbfp_linear/{r}": n for r, n in d.items()} for d in spec["routes"])
        want_routes = {k: pre.get(k, 0) + step.get(k, 0) * (GEN - 1) for k in {*pre, *step}}
        log(f"{name} path: B5 launches by route after prefill {routes['prefill']} (expected "
            f"{pre}); after {GEN - 1} decode steps {kernels.ROUTE_LAUNCHES} (expected "
            f"{want_routes})")
        if routes["prefill"] != pre or kernels.ROUTE_LAUNCHES != want_routes:
            raise AssertionError(f"the {name} path's B5 launches took other routes")
    tokens = torch.cat([tok[:, None], toks], dim=1)
    if logits.shape != (BATCH, prompt, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite or misshapen")
    if tokens.shape != (BATCH, GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError("greedy tokens out of range")
    tok_s = BATCH * (GEN - 1) / t_decode
    log(f"{name} path: prefill {t_prefill * 1e3:.1f} ms (first call, includes warm-up"
        + (" and prepare_split_decode" if spec["prepare"] is not None else "")
        + f"); decode {tok_s:.1f} tokens/s over {GEN - 1} steps at batch {BATCH} "
        f"(host clock, synchronized)")

    # one warm prefill's device time (torch.profiler over a second prefill
    # call; a retaken trace starts again from an empty cache), split into
    # the packed linears' kernel and the rest
    prof_caches = model.init_cache(BATCH, device=dev, **cache_kw)
    ids_dev, warm = ids.to(dev), {}

    def warm_prefill():
        for c in prof_caches:
            c.length = 0
        warm["out"] = greedy_prefill(model, prof_caches, ids_dev)

    pre_events = device_events(torch, warm_prefill)
    pre_ms = sum(us for _, us in pre_events) / 1e3
    b3 = ""
    if "flash_attention" in spec["prefill"]:
        b3_ms = sum(us for n, us in pre_events if any(m in n for m in B3_MARKS)) / 1e3
        nb3 = spec["prefill"]["flash_attention"]
        b3 = f", flash_attention {b3_ms:.4f} ms over {nb3} launches"
        if "kv_repeat_ms" in spec:
            b3 += (f", flash_prefill's K/V head repeat before them {nb3} x "
                   f"{spec['kv_repeat_ms']:.4f} = {nb3 * spec['kv_repeat_ms']:.4f} ms (its "
                   f"time a layer from the B3 phase, at this path's shapes)")
    linear = next((k for k in spec["prefill"] if k in LINEAR_KERNELS), None)
    if linear is None:
        log(f"{name} prefill, warm: device time {pre_ms:.4f} ms (its linears run cuBLAS){b3}")
    else:
        lin_ms = sum(us for n, us in pre_events
                     if any(m in n for m in spec["marks"][linear])) / 1e3
        log(f"{name} prefill, warm: device time {pre_ms:.4f} ms, of which {linear} "
            f"{lin_ms:.4f} ms over {spec['prefill'][linear]} launches{b3}; all but "
            f"{linear} {pre_ms - lin_ms:.4f} ms")
    for ev, us in sorted(pre_events, key=lambda e: -e[1])[:6]:
        log(f"  device, warm prefill: {us / 1e3:.4f} ms  {ev[:110]}")
    _, ptok = warm["out"]
    if spec["prepare"] is not None:
        prepare_split_decode(model, prof_caches)
    torch.cuda.synchronize()

    # where a decode step's time goes: 8 more steps from that prefill,
    # device time from torch.profiler against the unprofiled step time above
    events = sorted(device_events(torch, lambda: greedy_decode(model, prof_caches, ptok,
                                                               prompt, 8)),
                    key=lambda e: -e[1])
    busy_ms = sum(us for _, us in events) / 1e3 / 8
    step_ms = t_decode * 1e3 / (GEN - 1)
    if events:
        log(f"{name} decode step: {step_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
            f"(idle share {1 - busy_ms / step_ms:.3f})")
        for kern, names in spec["marks"].items():
            us = sum(t for n, t in events if any(m in n for m in names))
            per_step = spec["step"][kern]
            log(f"  {kern} on the {name} path: {us / 1e3 / (8 * per_step):.4f} ms per launch "
                f"(its kernel's device time over {8 * per_step} launches)")
    else:
        log(f"{name} decode step: {step_ms:.3f} ms wall; device busy not measured "
            f"(empty profile)")
    for ev, us in events[:8]:
        log(f"  device per step: {us / 1e3 / 8:.4f} ms  {ev[:110]}")
    host_profile(torch, name, lambda: greedy_decode(model, prof_caches, ptok, prompt, 8), 8)
    del prof_caches

    # the same model on the CPU: the plain PyTorch versions of the kernels,
    # teacher-forced: each decode step takes the card's token, so that every
    # step's logits are held (and a token only where the CPU's top-1/top-2
    # margin exceeds the tolerance)
    n = min(8, GEN)  # the prefill and n - 1 decode steps are held
    gpu_logits, gpu_tokens = logits.float().cpu(), tokens[:, :n].cpu()
    gpu_rows = rows[:n - 1].float().cpu()
    witness = spec.get("kv_witness", False)
    card_kv = kv_prefix(caches, prompt) if witness else None
    del logits, rows, caches
    if spec.get("cpu_cfg") is not None:
        # the full-depth model stays on the card: the same build at the CPU
        # check's depth runs on the card (its T2 launches recorded where the
        # spec asks), then on the CPU
        del model
        torch.cuda.empty_cache()
        model = make(spec["cpu_cfg"], device=dev, seed=0)
        spec["build"](model)
        gcaches = model.init_cache(BATCH, device=dev, **cache_kw)
        pre_sites, step_sites = [], []
        recording = spec.get("record_t2", False)
        kernels.reset_launches()
        with record_t2(pre_sites) if recording else contextlib.nullcontext():
            glogits, gtok, _ = prefill(gcaches, ids.to(dev))
        n_pre = kernels.LAUNCHES["bfp_cast"]
        with record_t2(step_sites) if recording else contextlib.nullcontext():
            gtoks, grows = greedy_decode(model, gcaches, gtok, prompt, n - 1)
        if recording and torch.device(dev).type == "cuda" and (
                len(pre_sites), len(step_sites)) != (n_pre, kernels.LAUNCHES["bfp_cast"] - n_pre):
            raise AssertionError(f"{name} path: the T2 calls recorded are not the T2 launches")
        gpu_logits = glogits.float().cpu()
        gpu_tokens = torch.cat([gtok[:, None], gtoks], dim=1).cpu()
        gpu_rows = grows.float().cpu()
        card_kv = kv_prefix(gcaches, prompt) if witness else None
        del glogits, grows, gcaches
        if recording:
            spec["t2_sites"] = pre_sites + step_sites
            spec["t2_step"] = step_sites[:len(step_sites) // (n - 1)]
            log(f"{name} path: recorded {len(pre_sites)} T2 launches at prefill and prepare, "
                f"{len(step_sites) // (n - 1)} a decode step, at "
                f"{spec['cpu_cfg'].num_hidden_layers} layers")
        log(f"{name} path: the CPU check runs the same build at "
            f"{spec['cpu_cfg'].num_hidden_layers} layers (full width), on the card and the CPU")
    if witness:
        # the same model's prefill over an f32 cache, on the card
        f32_caches = model.init_cache(BATCH, max_len=CAPACITY, device=dev)
        card_f32 = greedy_prefill(model, f32_caches, ids.to(dev))[0].float().cpu()
        del f32_caches
    model.to("cpu")
    torch.cuda.empty_cache()
    if spec.get("cpu_fold"):
        # the CPU reference casts each weight once, not at every forward
        fold_untied(torch, model)
    if nb < BATCH:
        # the CPU reference runs the card's first nb rows (every row is
        # computed on its own)
        gpu_logits, gpu_tokens, gpu_rows = gpu_logits[:nb], gpu_tokens[:nb], gpu_rows[:, :nb]
        if witness:
            card_kv = [tuple(t[:nb] for t in layer) for layer in card_kv]
            card_f32 = card_f32[:nb]
    cpu_caches = model.init_cache(nb, device="cpu", **cache_kw)
    t0 = time.perf_counter()
    with memo_unpack(), torch.no_grad():
        cpu_logits, ctok, _ = prefill(cpu_caches, ids[:nb])
        cpu_rows = torch.stack([model(gpu_tokens[:, s:s + 1], caches=cpu_caches,
                                      position_offset=prompt + s)[:, -1]
                                for s in range(n - 1)])
    log(f"{name} path: CPU reference run {time.perf_counter() - t0:.1f} s"
        + (f" (the card's first {nb} rows)" if nb < BATCH else ""))
    tol = spec["logit_tol"]
    err = (gpu_logits - cpu_logits).abs().max().item()
    log(f"{name} path: prefill logits GPU vs CPU: max_abs_err={err:.3g} (tolerance {tol})")
    if not err <= tol:
        raise AssertionError(f"{name} path: prefill logits disagree with the CPU run")
    errs = (gpu_rows - cpu_rows).abs().amax(dim=(1, 2)).tolist()
    log(f"{name} path: decode logits GPU vs CPU, the CPU fed the card's tokens, per step: "
        f"max_abs_err {', '.join(f'{e:.3g}' for e in errs)} (tolerance {tol})")
    if not max(errs) <= tol:
        raise AssertionError(f"{name} path: decode logits disagree with the CPU run")
    step_rows = torch.cat([cpu_logits[:, -1][None], cpu_rows])  # [n, B, V]
    top2 = step_rows.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > tol).T  # [B, n]
    cpu_choice = torch.stack([greedy_token(r) for r in step_rows], dim=1)  # [B, n]
    if (clear & (cpu_choice != gpu_tokens)).any():
        b, s = (clear & (cpu_choice != gpu_tokens)).nonzero()[0].tolist()
        raise AssertionError(f"{name} path: greedy token {s} of row {b} differs from the "
                             f"CPU's choice on the same inputs")
    log(f"{name} path: greedy tokens GPU vs CPU on the same inputs: {int(clear.sum())} of "
        f"{nb * n} held (top-1/top-2 margin > {tol}), all equal")
    if witness:
        # where the prefill's gap comes from: the int8 K/V the prefill
        # wrote, card against CPU, and the same prefill over an f32 cache
        with memo_unpack(), torch.no_grad():
            cpu_f32 = greedy_prefill(model, model.init_cache(nb, max_len=CAPACITY,
                                                             device="cpu"), ids[:nb])[0]
        f32_err = (card_f32 - cpu_f32).abs().max().item()
        apart, total, steps, s_apart, s_total, rel = kv_gap(torch, card_kv,
                                                            kv_prefix(cpu_caches, prompt))
        log(f"{name} path: witness of the int8 cache: the prompt's int8 K/V, card vs CPU, "
            f"{apart} of {total} entries apart, by at most {steps} step(s); {s_apart} of "
            f"{s_total} row scales apart (largest relative {rel:.3g}); the same prefill over "
            f"an f32 cache: logits GPU vs CPU max_abs_err={f32_err:.3g} (int8 cache {err:.3g})")
    del model, cpu_caches
    return launches, tok_s


# ---------------------------------------------------------------------------
# phase 4: the continuous-batching engine
# ---------------------------------------------------------------------------

def engine_specs(cfg):
    """The three engine paths: name, serving_bench mode, chunk, the kernels
    of a monolithic admission, of a decode forward, of every chunk and of
    the chunk at offset 0 besides, the profiler's marks per kernel of a
    decode forward, and the token tolerances (against isolated generation
    on the card; card vs CPU)."""
    L = cfg.num_hidden_layers
    weights = dict(mode="weights", admission={"bfp_linear": 4 * L + 1, "flash_attention": L},
                   step={"bfp_linear": 4 * L + 1, "flash_decode_int8": L},
                   chunk_each={"bfp_linear": 4 * L + 1}, chunk_first={"flash_attention": L},
                   marks={"bfp_linear": ("bfp_decode_kernel",),
                          "flash_decode_int8": ("flash_decode_int8_kernel",)},
                   iso_tol=KV8_TOL, cpu_tol=KV8_TOL)
    return [
        dict(weights, name="engine_weights", chunk=None),
        dict(weights, name="engine_weights_chunked", chunk=ENGINE_CHUNK, iso_tol=CHUNK_TOL),
        dict(name="engine_raw", mode="raw", chunk=None, admission={"flash_attention": L},
             step={"flash_decode": L}, chunk_each={}, chunk_first={},
             marks={"flash_decode": ("flash_decode_kernel",)}, iso_tol=LOGIT_TOL,
             cpu_tol=LOGIT_TOL),
    ]


def hold_tokens(name, what, got, want, margins, tol):
    """``got`` against ``want`` (request id -> tokens) where the reference's
    top-1/top-2 margin exceeds ``tol``; a request's tokens after its first
    near-tie are not held.  Returns the number held."""
    held = 0
    for rid, ref in want.items():
        if len(got[rid]) != len(ref):
            raise AssertionError(f"{name}: request {rid} has {len(got[rid])} tokens, "
                                 f"{what} {len(ref)}")
        for s, (a, b) in enumerate(zip(got[rid], ref)):
            if margins[rid][s] <= tol:
                break
            if a != b:
                raise AssertionError(f"{name}: token {s} of request {rid} differs from {what}")
            held += 1
    total = sum(len(t) for t in want.values())
    log(f"{name}: tokens against {what}: {held} of {total} held (top-1/top-2 margin > {tol}), "
        f"all equal")
    return held


def isolated_generation(torch, model, requests, capacity, quantized, dev):
    """Each request outside the engine: greedy_prefill and greedy_decode on
    a static cache at the prompt's true length, the requests of one prompt
    length in batches of up to ``ENGINE["slots"]`` rows (every row is
    computed on its own: a batch is the batch-1 runs side by side).
    Returns (tokens, the top-1/top-2 margin of each token's logits), by
    request id."""
    import numpy as np

    from dmx_compressor_tpu_torch.models.opt import greedy_decode, greedy_prefill

    toks, margins = {}, {}
    by_len = {}
    for rid, (prompt, gen) in enumerate(requests):
        by_len.setdefault(int(prompt.size), []).append(rid)
    for n, rids in by_len.items():
        for i in range(0, len(rids), ENGINE["slots"]):
            group = rids[i:i + ENGINE["slots"]]
            gen = max(requests[r][1] for r in group)
            ids = torch.from_numpy(np.stack([requests[r][0] for r in group])).to(dev)
            caches = model.init_cache(len(group), capacity, quantized=quantized, device=dev)
            logits, tok = greedy_prefill(model, caches, ids)
            seq, rows = tok[:, None], logits[:, -1][None]
            if gen > 1:
                more, steps = greedy_decode(model, caches, tok, n, gen - 1)
                seq, rows = torch.cat([seq, more], dim=1), torch.cat([rows, steps])
            top2 = rows.topk(2, dim=-1).values  # [gen, rows, 2]
            for j, r in enumerate(group):
                g = requests[r][1]
                toks[r] = seq[j, :g].tolist()
                margins[r] = (top2[:g, j, 0] - top2[:g, j, 1]).tolist()
    return toks, margins


def fold_untied(torch, model):
    """``DmxModel.fold_weights_and_biases`` on ``model``, a weight shared by
    two modules (OPT's head, tied to the token embedding) first given its
    own copy in each, so that folding the head's weight cast leaves the
    embedding's table as it was: the same function, bit for bit."""
    from dmx_compressor_tpu_torch.modeling.model import DmxModel

    seen = set()
    for m in model.modules():
        w = m._parameters.get("weight")
        if w is not None and id(w) in seen:
            m.weight = torch.nn.Parameter(w.detach().clone())
        elif w is not None:
            seen.add(id(w))
    DmxModel(model).fold_weights_and_biases()


def kv_prefix(caches, n):
    """Each layer's int8 K and V payloads and row scales at the ``n``
    prompt positions (a QuantizedKVCache each), on the CPU."""
    return [tuple(getattr(c, a)[:, :, :n].cpu() for a in ("k_q", "v_q", "k_scale", "v_scale"))
            for c in caches]


def kv_gap(torch, a, b):
    """Two runs' :func:`kv_prefix`: (int8 entries apart, entries, the
    largest difference in int8 steps, row scales apart, row scales, their
    largest relative difference)."""
    apart = total = steps = s_apart = s_total = 0
    rel = 0.0
    for x, y in zip(a, b):
        for p, q in zip(x[:2], y[:2]):
            d = (p.int() - q.int()).abs()
            apart, total = apart + int((d > 0).sum()), total + d.numel()
            steps = max(steps, int(d.max()))
        for p, q in zip(x[2:], y[2:]):
            s_apart, s_total = s_apart + int((p != q).sum()), s_total + p.numel()
            rel = max(rel, ((p - q).abs() / q.abs().clamp_min(1e-30)).max().item())
    return apart, total, steps, s_apart, s_total, rel


@contextlib.contextmanager
def memo_unpack():
    """Within this context the plain B1 and B5 versions unpack each payload
    once (keyed by its storage), so the CPU reference runs do not unpack the
    whole model at every forward: the same values, bit for bit."""
    from dmx_compressor_tpu_torch.ops import bfp_linear

    real_b1, real_b5, memo = bfp_linear.bfp_unpack, bfp_linear.sbfp_unpack, {}

    def unpack_b1(p):
        key = ("b1", p.mantissa.data_ptr(), p.exponent.data_ptr(), tuple(p.mantissa.shape),
               p.precision, p.block_size)
        if key not in memo:
            memo[key] = real_b1(p)
        return memo[key]

    def unpack_b5(p):
        key = ("b5", p.nibbles.data_ptr(), p.scale.data_ptr(), tuple(p.nibbles.shape),
               p.block_size)
        if key not in memo:
            memo[key] = real_b5(p)
        return memo[key]

    bfp_linear.bfp_unpack, bfp_linear.sbfp_unpack = unpack_b1, unpack_b5
    try:
        yield
    finally:
        bfp_linear.bfp_unpack, bfp_linear.sbfp_unpack = real_b1, real_b5


def chunk_gap(torch, model, prompt, quantized, dev):
    """Max abs difference of a prompt's last-position logits between a
    chunked prefill (ENGINE_CHUNK tokens a call) and a monolithic one."""
    ids = torch.from_numpy(prompt[None]).to(dev)
    caches = model.init_cache(1, prompt.size, quantized=quantized, device=dev)
    mono = model(ids, caches=caches, position_offset=0)[0, -1]
    caches = model.init_cache(1, prompt.size, quantized=quantized, device=dev)
    for off in range(0, prompt.size, ENGINE_CHUNK):
        last = model(ids[:, off:off + ENGINE_CHUNK], caches=caches, position_offset=off)
    return (last[0, -1] - mono).abs().max().item()


def engine_closed_loop(torch, kernels, eng, sp, requests, vocab, card):
    """One engine path's run on the card: warmup, then the closed loop with
    the launch counters set to 0 just before and read just after (the
    counts derived from the engine's admission and chunk counters and its
    decode dispatches; its first steady dispatch under
    torch.cuda.set_sync_debug_mode("error")), then one steady dispatch
    under torch.profiler.  Returns (the launch counts, the tokens by
    request index)."""
    from dmx_compressor_tpu_torch.examples import serving_bench as sb

    name, chunk, burst = sp["name"], sp["chunk"], ENGINE["burst"]
    t0 = time.perf_counter()
    eng.warmup(burst, **sp.get("warmup", {}))
    torch.cuda.synchronize()
    log(f"{name}: warmup {time.perf_counter() - t0:.2f} s")
    dispatches, synced = [0], []
    real_dispatch = eng._dispatch

    def dispatch(b, sampling, eng=eng, real=real_dispatch):
        dispatches[0] += 1
        if synced or eng.last_step_admissions or eng.last_step_chunks:
            return real(b, sampling)
        # a steady-state dispatch: no host sync allowed
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(b, sampling)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        synced.append(True)
        return out

    eng._dispatch = dispatch
    kernels.reset_launches()
    stats = sb.closed_loop(eng, requests, burst)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    eng._dispatch = real_dispatch
    if not synced:
        raise AssertionError(f"{name}: no steady-state dispatch ran")
    log(f"{name}: one steady-state dispatch ({burst} decode forwards) ran under "
        f"torch.cuda.set_sync_debug_mode('error'): no host sync")
    adm = sum(st["admissions"] for st in stats["steps"])
    chunks = sum(st["chunks"] for st in stats["steps"])
    first = adm if chunk and ENGINE["prompt"] > chunk else 0
    forwards = dispatches[0] * burst
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for counts, n in ((sp["admission"], adm - first), (sp["step"], forwards),
                      (sp["chunk_each"], chunks), (sp["chunk_first"], first)):
        for k, v in counts.items():
            want[k] += v * n
    log(f"{name}: {adm} admissions ({first} chunked), {chunks} chunks, "
        f"{dispatches[0]} decode dispatches of {burst} forwards; launches {launches} "
        f"(expected {want})")
    if launches != want:
        raise AssertionError(f"the {name} path did not launch the kernels the expected "
                             f"number of times")
    fin = {r.request_id: r for r in eng.finished}
    if sorted(fin) != stats["rids"] or any(
            r.finish_reason != "length" or len(r.tokens) != g
            for r, (_, g) in zip((fin[i] for i in stats["rids"]), requests)):
        raise AssertionError(f"{name}: a request did not finish with its tokens")
    got = {i: fin[rid].tokens for i, rid in enumerate(stats["rids"])}
    flat = [t for v in got.values() for t in v]
    if min(flat) < 0 or max(flat) >= vocab:
        raise AssertionError(f"{name}: tokens out of range")
    sm = sb.summary(stats)

    # the device's share of a steady step: one steady dispatch (all slots
    # decoding) under torch.profiler, against the closed loop's steady step
    # on the host clock
    for prompt, _ in requests[:ENGINE["slots"]]:
        sb.submit(eng, prompt, ENGINE["gen"])
    eng.step(burst)
    torch.cuda.synchronize()
    with torch.no_grad():
        events = device_events(torch, lambda: eng._dispatch(burst, False))
    busy_ms = sum(us for _, us in events) / 1e3
    steady_ms = sm["steady_p50_step_ms"]
    log(f"{name} on {card}: {sm['tokens_per_s']:.1f} tokens/s, slot utilization "
        f"{sm['slot_utilization']:.3f}, step p50 {sm['p50_step_ms']:.3f} ms / p99 "
        f"{sm['p99_step_ms']:.3f} ms, steady step p50 {steady_ms:.3f} ms / p99 "
        f"{sm['steady_p99_step_ms']:.3f} ms over {sm['steady_steps']} steady steps of "
        f"{len(stats['steps'])}; a steady dispatch's device busy {busy_ms:.3f} ms "
        f"(idle share {1 - busy_ms / steady_ms:.3f} of the steady p50 step)")
    for kern, names in sp["marks"].items():
        us = sum(t for n, t in events if any(m in n for m in names))
        n = burst * sp["step"][kern]
        log(f"  {kern} on the {name} path: {us / 1e3 / n:.4f} ms per launch "
            f"(its kernel's device time over {n} launches)")
    for ev, us in sorted(events, key=lambda e: -e[1])[:6]:
        log(f"  device per steady dispatch: {us / 1e3:.4f} ms  {ev[:110]}")
    return launches, got


def engine_run(torch, sb, model, quantized, requests, chunk=None):
    """The tokens of an engine run of ``requests`` (closed loop, serving_bench's
    engine at ``ENGINE``'s slots and burst) wherever ``model`` lives, by
    request index."""
    burst = ENGINE["burst"]
    with memo_unpack(), torch.no_grad():
        eng = sb.make_engine(model, quantized, requests, ENGINE["prompt"], ENGINE["slots"],
                             burst, chunk, max(1, burst // chunk) if chunk else 1, depth=1)
        eng.warmup(burst)
        stats = sb.closed_loop(eng, requests, burst)
    fin = {r.request_id: r.tokens for r in eng.finished}
    return {i: fin[rid] for i, rid in enumerate(stats["rids"])}


def engine_paths(torch, dev, kernels, cfg, card):
    """The OPT engine paths, one model after another (OPT at full width,
    seed 0, cut to ``ENGINE_CUT_LAYERS``): per path an engine on the card
    and :func:`engine_closed_loop`; isolated generation on the card; the
    model moved to the CPU and the path's engine run there over the requests
    ``ENGINE_HELD``, held against the card's tokens of those requests.
    Returns the launch counts by path."""
    import dataclasses

    from dmx_compressor_tpu_torch.examples import serving_bench as sb
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode

    by_path = {}
    cut = dataclasses.replace(cfg, num_hidden_layers=ENGINE_CUT_LAYERS)
    for name, cfg in (("engine_weights", cut), ("engine_weights_chunked", cut),
                      ("engine_raw", cut)):
        group = [sp for sp in engine_specs(cfg) if sp["name"] == name]
        mode = group[0]["mode"]
        t0 = time.perf_counter()
        with torch.no_grad():
            model, quantized = OPTForCausalLM(cfg, device=dev, seed=0), mode == "weights"
            if quantized:
                build_weights_mode(model)
        torch.cuda.synchronize()
        log(f"{name}: OPT {cfg.hidden_size}x{cfg.num_hidden_layers} ({mode}) built in "
            f"{time.perf_counter() - t0:.2f} s")
        requests = sb.make_requests(cfg.vocab_size, ENGINE["requests"], ENGINE["prompt"],
                                    ENGINE["gen"], spread=False)
        got, capacity = {}, None
        for sp in group:
            chunk, burst = sp["chunk"], ENGINE["burst"]
            eng = sb.make_engine(model, quantized, requests, ENGINE["prompt"], ENGINE["slots"],
                                 burst, chunk, max(1, burst // chunk) if chunk else 1, depth=1)
            capacity = eng.max_len
            by_path[sp["name"]], got[sp["name"]] = engine_closed_loop(
                torch, kernels, eng, sp, requests, cfg.vocab_size, card)
            del eng
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        iso, margins = isolated_generation(torch, model, requests, capacity, quantized, dev)
        log(f"{name}: isolated generation of {len(requests)} requests on the card "
            f"{time.perf_counter() - t0:.1f} s")
        for sp in group:
            hold_tokens(sp["name"], "isolated generation on the card", got[sp["name"]], iso,
                        margins, sp["iso_tol"])
            if sp["chunk"]:
                gap = chunk_gap(torch, model, requests[0][0], quantized, dev)
                log(f"{sp['name']}: chunked vs monolithic prefill, last-position logits "
                    f"max_abs_diff={gap:.3g} (tolerance {CHUNK_TOL})")
                if not gap <= CHUNK_TOL:
                    raise AssertionError(f"{sp['name']}: the chunked prefill moved the logits "
                                         f"beyond the tolerance its tokens are held to")

        # the same engine over the requests ENGINE_HELD with the model on
        # the CPU, against the card's tokens of those requests
        model.to("cpu")
        torch.cuda.empty_cache()
        held = [requests[i] for i in ENGINE_HELD]
        held_margins = {j: margins[i] for j, i in enumerate(ENGINE_HELD)}
        for sp in group:
            t0 = time.perf_counter()
            cpu = engine_run(torch, sb, model, quantized, held, sp["chunk"])
            log(f"{sp['name']}: CPU engine run of requests {ENGINE_HELD} "
                f"{time.perf_counter() - t0:.1f} s")
            hold_tokens(sp["name"], f"the CPU engine run (requests {ENGINE_HELD})",
                        {j: got[sp["name"]][i] for j, i in enumerate(ENGINE_HELD)}, cpu,
                        held_margins, sp["cpu_tol"])
        del model
    return by_path


def engine_family_path(torch, dev, kernels, fcfg, card):
    """engine_llama_weights: the engine over TinyLlama-1.1B (bench.py's
    llama-1.1b at full width, seed 0, cut to ENGINE_LLAMA_LAYERS) in weights mode with int8
    row caches of its 4 KV heads, serving_bench's traffic (``ENGINE``) as
    the OPT engine paths; :func:`engine_closed_loop` on the card.  Its
    tokens are held against isolated generation on the card for the
    requests ``ENGINE_HELD``.  The CPU check runs the same build cut to
    ``FAMILY_CPU_LAYERS`` layers: the ``ENGINE_HELD`` requests through an
    engine on the card and one on the CPU, held by the margins of isolated
    generation on the card at that depth.  Returns the launch counts."""
    import dataclasses

    from dmx_compressor_tpu_torch.examples import serving_bench as sb
    from dmx_compressor_tpu_torch.models.llama import LlamaForCausalLM
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode

    fcfg = dataclasses.replace(fcfg, num_hidden_layers=ENGINE_LLAMA_LAYERS)
    L = fcfg.num_hidden_layers
    sp = dict(name="engine_llama_weights", chunk=None,
              admission={"bfp_linear": 4 * L + 1},
              step={"bfp_linear": 4 * L + 1, "flash_decode_int8": L},
              chunk_each={}, chunk_first={},
              marks={"bfp_linear": ("bfp_decode_kernel",),
                     "flash_decode_int8": ("flash_decode_int8_kernel",)})
    requests = sb.make_requests(fcfg.vocab_size, ENGINE["requests"], ENGINE["prompt"],
                                ENGINE["gen"], spread=False)
    held = [requests[i] for i in ENGINE_HELD]

    def build(cfg_):
        t0 = time.perf_counter()
        with torch.no_grad():
            model = LlamaForCausalLM(cfg_, device=dev, seed=0)
            build_weights_mode(model)
        torch.cuda.synchronize()
        log(f"engine_llama_weights: Llama {cfg_.hidden_size}x{cfg_.num_hidden_layers} built in "
            f"{time.perf_counter() - t0:.2f} s")
        return model

    model = build(fcfg)
    eng = sb.make_engine(model, True, requests, ENGINE["prompt"], ENGINE["slots"],
                         ENGINE["burst"], None, 1, depth=1)
    capacity = eng.max_len
    launches, got = engine_closed_loop(torch, kernels, eng, sp, requests, fcfg.vocab_size, card)
    del eng
    t0 = time.perf_counter()
    iso, margins = isolated_generation(torch, model, held, capacity, True, dev)
    log(f"engine_llama_weights: isolated generation of requests {ENGINE_HELD} on the card "
        f"{time.perf_counter() - t0:.1f} s")
    hold_tokens(sp["name"], f"isolated generation on the card (requests {ENGINE_HELD})",
                {j: got[i] for j, i in enumerate(ENGINE_HELD)}, iso, margins, KV8_TOL)
    del model
    torch.cuda.empty_cache()

    # the CPU check at FAMILY_CPU_LAYERS layers: the held requests through
    # an engine on the card and one on the CPU
    model = build(dataclasses.replace(fcfg, num_hidden_layers=FAMILY_CPU_LAYERS))
    card_toks = engine_run(torch, sb, model, True, held)
    _, margins = isolated_generation(torch, model, held, capacity, True, dev)
    model.to("cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = engine_run(torch, sb, model, True, held)
    log(f"engine_llama_weights: CPU engine run of requests {ENGINE_HELD} at "
        f"{FAMILY_CPU_LAYERS} layers {time.perf_counter() - t0:.1f} s")
    hold_tokens(sp["name"], f"the CPU engine run at {FAMILY_CPU_LAYERS} layers (requests "
                f"{ENGINE_HELD}, the card's engine at that depth)", card_toks, cpu, margins,
                KV8_TOL)
    del model
    return launches


# ---------------------------------------------------------------------------
# phase 5: the encoder-decoder families
# ---------------------------------------------------------------------------


class Seq2SeqLM:
    """An encoder-decoder model served as a causal LM over its decoder, so
    that serve_path and greedy_prefill / greedy_decode drive it: a call at
    position 0 (the prefill) encodes the first B rows of ``inputs`` (B the
    start ids' batch, on the model's device) and keeps the encoder output
    for the decode steps after it."""

    def __init__(self, model, inputs):
        self.model, self.inputs, self.enc = model, inputs, None

    def __call__(self, ids, caches=None, position_offset=0):
        import torch

        if isinstance(position_offset, int) and position_offset == 0:
            x = torch.from_numpy(self.inputs[:ids.shape[0]]).to(ids.device)
            self.enc = self.model.encode(x)
        return self.model.decode(ids, self.enc, caches=caches, position_offset=position_offset)

    def __getattr__(self, name):  # init_cache, to, cfg
        return getattr(self.model, name)


def on_model(build):
    """``build`` applied to a :class:`Seq2SeqLM`'s model (its module tree)."""
    return lambda lm: build(lm.model)


def seq2seq_configs():
    """t5-small and whisper-small at full width and depth (the kernel
    phases' shapes; whisper-small's paths run at WHISPER_LAYERS)."""
    from dmx_compressor_tpu_torch.models.t5 import T5Config
    from dmx_compressor_tpu_torch.models.whisper import WhisperConfig

    return {"t5": T5Config.t5_small(), "whisper": WhisperConfig.small()}


def seq2seq_inputs(family, cfg, n=BATCH, seed=0):
    """The encoder inputs of the seq2seq paths, from ``seed`` with numpy: T5
    ``S2S_ENC`` token ids uniform in [1, vocab); Whisper standard-normal
    features [n, 80, 3000] (examples/benchmarking/benchmark_whisper.py's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if family == "t5":
        return rng.integers(1, cfg.vocab_size, (n, S2S_ENC)).astype(np.int32)
    return rng.standard_normal((n, cfg.num_mel_bins, 2 * cfg.max_source_positions),
                               np.float32)


def seq2seq_layers(cfg, family, L):
    """``cfg`` cut to ``L`` layers in each stack."""
    import dataclasses

    if family == "t5":
        return dataclasses.replace(cfg, num_layers=L, num_decoder_layers=L)
    return dataclasses.replace(cfg, encoder_layers=L, decoder_layers=L)


def seq2seq_path_specs(cfg, family):
    """The three paths of an encoder-decoder family (t5-small, whisper-small)
    at full width and depth, as :func:`path_specs`: batch 8, the start
    tokens (T5 one, Whisper four) prefilled over the encoder output into
    caches of start + GEN slots (JAX ``generate``'s size), 63 decode steps.
    The launches, L layers a stack (derived from the code: the encoder's 6
    packed linears a layer, the decoder's 10 (self and cross q, k, v, o, the
    feed-forward's 2), the tied head; every cross-attention K/V recomputed
    at every step, as in the JAX package):

    - weights: a prefill 16L+1 B1 (the encoder's at M 8 x its length, the
      cross K/V at the same M), a step 10L+1 B1; T5 no attention kernel (its
      attention is the modular SDPA over ``cache.update``), Whisper L B2 a
      step and no B3 (an int8 prefill attends through quantized_sdpa);
    - sbfp (bench.py's sbfp leg, ``build_sbfp_mode``: SBFP12_16 on every
      Linear, int8 caches): the weights path's counts with B5 for B1, every
      B5 launch on its tensor-core route;
    - baseline: T5 none (cuBLAS f32, the modular SDPA); Whisper L B3 at the
      4-token prefill over the f32 cache, L B4 a step;
    - basic (f32 cache, as JAX's ``generate``): 16L+1 T1 a prefill and 10L+1
      a step, and the T2 casts of the modular pipeline: T5 the encoder's
      38L+4 and the decoder's 52L+5 a prefill, 52L+5 a step; Whisper 33L+6
      and 50L+5, 50L+5 (casts along an axis no multiple of the block, as the
      cross-attention's 1500 keys, are plain torch: the JAX package's jnp
      path).

    CPU checks: T5 at the path's depth and full batch; Whisper at FAMILY_CPU_LAYERS and
    the card's first S2S_CPU_BATCH rows (the path at that depth, WHISPER_LAYERS,
    moves its model to the CPU but the basic one's)."""
    import numpy as np
    import torch

    from dmx_compressor_tpu_torch.models.t5 import T5ForConditionalGeneration
    from dmx_compressor_tpu_torch.models.whisper import WhisperForConditionalGeneration
    from dmx_compressor_tpu_torch.ops.compress import (
        build_baseline_mode,
        build_basic_mode,
        build_sbfp_mode,
        build_weights_mode,
    )

    L = cfg.num_hidden_layers
    start = S2S_START[family]
    inputs = seq2seq_inputs(family, cfg)
    model_cls = T5ForConditionalGeneration if family == "t5" else WhisperForConditionalGeneration

    def make(cfg_, device=None, seed=0):
        return Seq2SeqLM(model_cls(cfg_, device=device, seed=seed), inputs)

    whisper = family == "whisper"
    # Whisper's CPU checks at FAMILY_CPU_LAYERS (a path at that depth moves
    # its model to the CPU; the basic path rebuilds it on the card, where its
    # T2 sites are recorded)
    check_cfg = seq2seq_layers(cfg, family, FAMILY_CPU_LAYERS) if whisper else cfg
    common = dict(model=make, prompt=len(start),
                  ids=lambda: torch.from_numpy(np.tile(np.asarray(start, np.int32), (BATCH, 1))),
                  cpu_cfg=None if check_cfg == cfg else check_cfg,
                  cpu_batch=S2S_CPU_BATCH if whisper else BATCH)
    cache = dict(max_len=len(start) + GEN)
    t2_pre, t2_step = ((33 * L + 6) + (50 * L + 5), 50 * L + 5) if whisper else (
        (38 * L + 4) + (52 * L + 5), 52 * L + 5)
    weights_step = {"bfp_linear": 10 * L + 1}
    sbfp_step = {"sbfp_linear": 10 * L + 1}
    if whisper:
        weights_step["flash_decode_int8"] = L
        sbfp_step["flash_decode_int8"] = L
        baseline = dict(prefill={"flash_attention": L}, step={"flash_decode": L},
                        marks={"flash_decode": ("flash_decode_kernel",)})
    else:
        baseline = dict(prefill={}, step={}, marks={})
    return [
        dict(common, name=f"{family}_weights", build=on_model(build_weights_mode),
             cache=dict(cache, quantized=True), prefill={"bfp_linear": 16 * L + 1},
             prepare=None, step=weights_step,
             marks={k: {"bfp_linear": B1_MARKS, "flash_decode_int8": B2_MARKS}[k]
                    for k in weights_step}, logit_tol=KV8_TOL),
        dict(common, name=f"{family}_sbfp", build=on_model(build_sbfp_mode),
             cache=dict(cache, quantized=True), prefill={"sbfp_linear": 16 * L + 1},
             prepare=None, step=sbfp_step,
             routes=({"tensor_cores": 16 * L + 1}, {"tensor_cores": 10 * L + 1}),
             marks={k: {"sbfp_linear": B5_MARKS, "flash_decode_int8": B2_MARKS}[k]
                    for k in sbfp_step}, logit_tol=SBFP_FAMILY_TOL[family],
             kv_witness=SBFP_FAMILY_TOL[family] > KV8_TOL),
        dict(common, name=f"{family}_baseline", build=on_model(build_baseline_mode), cache=cache,
             prepare=None, logit_tol=LOGIT_TOL, **baseline),
        dict(common, name=f"{family}_basic", build=on_model(build_basic_mode), cache=cache,
             prefill={"bfp_linear_bf16": 16 * L + 1, "bfp_cast": t2_pre}, prepare=None,
             step={"bfp_linear_bf16": 10 * L + 1, "bfp_cast": t2_step},
             marks={"bfp_linear_bf16": T1_MARKS, "bfp_cast": T2_MARKS},
             logit_tol=BASIC_FAMILY_TOL[family], record_t2=True, cpu_cfg=check_cfg),
    ]


def seq2seq_linear_shapes(cfg, family):
    """(M, K, N, launches) of an encoder-decoder family's packed linears at a
    prefill and a decode step, M the rows each launch takes: the encoder's
    q/k/v/o and feed-forward at M = 8 x its length, the decoder's at 8 x
    the start tokens (prefill) or 8 (a step), the cross-attention's K/V at
    the encoder's M at every step, the tied head."""
    L = cfg.num_hidden_layers
    if family == "t5":
        d, f, V, S = cfg.d_model, cfg.d_ff, cfg.vocab_size, S2S_ENC
    else:
        d, f, V, S = cfg.d_model, cfg.decoder_ffn_dim, cfg.vocab_size, cfg.max_source_positions
    Me = BATCH * S
    T0 = len(S2S_START[family])
    prefill = [(Me, d, d, 4 * L), (Me, d, f, L), (Me, f, d, L), (Me, d, d, 2 * L)]
    step = [(Me, d, d, 2 * L), (BATCH, d, d, 6 * L), (BATCH, d, f, L), (BATCH, f, d, L),
            (BATCH, d, V, 1)]
    prefill += [(BATCH * T0, K, N, n) for _, K, N, n in step[1:]]
    return prefill, step


def b5_tensor_core_route(path):
    """``route_of`` for SBFP12_16 payloads: every shape of ``path`` on B5's
    tensor-core route (3 bf16 plane products), or the run fails."""
    from dmx_compressor_tpu_torch.ops.bfp_linear import sbfp_route

    def route_of(M, K, w):
        route = sbfp_route(w, M, K)
        if route != "tensor_cores":
            raise AssertionError(f"B5 ({path}) {M}x{K}: SBFP12_16 took the {route} route")
        return route, 3

    return route_of


def check_path_linears(torch, dev, path, shapes, step, seed):
    """B1, T1 and B5 (SBFP12_16) at a path's packed linear shapes ``shapes``
    ((M, K, N), each M the rows its launch takes) against their plain
    versions, each case's time, plain time, library time (torch.matmul on
    the dequantized weight, bf16 for T1) and bound; then per launch over
    ``step`` ((M, K, N, launches): a decode step's launches, or a forward's,
    as the path makes them; the sbfp path's are the weights path's).  Each
    timing takes at least S2S_TIMED calls.  Returns ((B1's per-step
    numbers, cases), (T1's ...), (B5's ...)), each case marked ``path``."""
    from dmx_compressor_tpu_torch.numerics.format import Format
    from dmx_compressor_tpu_torch.ops.bfp_linear import (
        bfp_linear,
        bfp_linear_bf16,
        bfp_linear_bf16_ref,
        bfp_linear_ref,
        sbfp_linear,
        sbfp_linear_ref,
    )
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, bfp_unpack, sbfp_pack, sbfp_unpack
    from dmx_compressor_tpu_torch.ops.compress import SBFP12_16

    fmt = Format.from_shorthand(SBFP12_16)
    out = []
    for label, kern, plain, s, peak, lib, pack, unpack, nbytes, tol, extra in (
            ("B1 bfp_linear", bfp_linear, bfp_linear_ref, seed, PEAK_F32_FLOP_S, None,
             lambda w: bfp_pack(w, 8, 64), bfp_unpack, b1_bytes, B1_TOL, dict(planes=3)),
            ("T1 bfp_linear_bf16", bfp_linear_bf16, bfp_linear_bf16_ref, seed + 1,
             PEAK_BF16_FLOP_S, torch.bfloat16, lambda w: bfp_pack(w, 8, 64), bfp_unpack,
             b1_bytes, B1_TOL, {}),
            ("B5 sbfp_linear", sbfp_linear, sbfp_linear_ref, seed + 100, PEAK_F32_FLOP_S, None,
             lambda w: sbfp_pack(w, fmt), sbfp_unpack, b5_bytes, B5_TOL,
             dict(route_of=b5_tensor_core_route(path)))):
        out.append(check_linear(
            torch, dev, f"{label} ({path})", kern, plain, pack, unpack, nbytes, [], shapes, tol,
            seed=s, peak_flop_s=peak, lib_dtype=lib, step_launches=step, min_iters=S2S_TIMED,
            **extra))
        for case in out[-1][1]:
            case["path"] = path
    return out


def check_seq2seq_linears(torch, dev, cfg, family, seed):
    """B1, T1 and B5 at an encoder-decoder family's packed linear shapes
    (:func:`seq2seq_linear_shapes`: the encoder's and the cross K/V's M,
    whisper-small's 12000 x 768 x 768 among them; the decoder's M 8 and 8 x
    start; the tied head, whisper-small's N 51865 odd), per launch over one
    decode step's launches (:func:`check_path_linears`)."""
    prefill, step = seq2seq_linear_shapes(cfg, family)
    shapes = sorted({(M, K, N) for M, K, N, _ in prefill + step})
    return check_path_linears(torch, dev, family, shapes, step, seed)


def engine_seq2seq_path(torch, dev, kernels, cfg, family, card):
    """engine_<family>_weights: the seq2seq engine (serving/engine.py
    Seq2SeqBatchingEngine) over t5-small or whisper-small at full width and
    depth (seed 0) in weights mode with int8 row caches, serving_bench's
    traffic (``ENGINE``: 8 slots, bursts of 16, 32 requests of 64 new
    tokens, warmup first): T5 ragged encoder inputs of 32-128 token ids
    padded to ``enc_capacity`` 128 and masked, one start token; Whisper one
    [80, 3000] feature row a request and its 4 start tokens.  Each
    admission encodes its request (batch 1) and prefills: 16L+1 B1 (no B3:
    an int8 prefill); each decode forward 10L+1 B1 (+ L B2 over the row
    caches' per-row lengths for Whisper), the encoder mask built on the
    device from the slots' encoder lengths.  Tokens are held against
    isolated generation on the card (``ENGINE_HELD``) and, through engines
    on the card and on the CPU, at T5's path depth (the held requests, 8
    slots) or Whisper's FAMILY_CPU_LAYERS (its first S2S_CPU_BATCH held
    requests, as many slots).  Returns the launch counts."""
    import numpy as np

    from dmx_compressor_tpu_torch.examples import serving_bench as sb
    from dmx_compressor_tpu_torch.models.shared import seq2seq_greedy
    from dmx_compressor_tpu_torch.models.t5 import T5ForConditionalGeneration
    from dmx_compressor_tpu_torch.models.whisper import WhisperForConditionalGeneration
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode

    name = f"engine_{family}_weights"
    L = cfg.num_hidden_layers
    whisper = family == "whisper"
    step = {"bfp_linear": 10 * L + 1}
    marks = {"bfp_linear": ("bfp_decode_kernel",)}
    if whisper:
        step["flash_decode_int8"] = L
        marks["flash_decode_int8"] = ("flash_decode_int8_kernel",)
    sp = dict(name=name, chunk=None, admission={"bfp_linear": 16 * L + 1}, step=step,
              chunk_each={}, chunk_first={}, marks=marks)
    rng = np.random.default_rng(0)
    start = np.asarray(S2S_START[family], np.int32)
    if whisper:
        feats = seq2seq_inputs(family, cfg, ENGINE["requests"])
        requests = [(dict(encoder_input=f, decoder_start_ids=start), ENGINE["gen"])
                    for f in feats]
        sp["warmup"] = dict(encoder_input=feats[0])
    else:
        lens = rng.integers(S2S_ENC // 4, S2S_ENC + 1, ENGINE["requests"])
        requests = [(dict(encoder_input=rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32),
                          decoder_start_ids=start), ENGINE["gen"]) for n in lens]
    enc_cap = None if whisper else S2S_ENC
    model_cls = WhisperForConditionalGeneration if whisper else T5ForConditionalGeneration

    def build(cfg_):
        t0 = time.perf_counter()
        with torch.no_grad():
            model = model_cls(cfg_, device=dev, seed=0)
            build_weights_mode(model)
        torch.cuda.synchronize()
        log(f"{name}: {model_cls.__name__} {cfg_.hidden_size}x{cfg_.num_hidden_layers} built in "
            f"{time.perf_counter() - t0:.2f} s")
        return model

    def isolated(model, reqs, capacity):
        """The requests outside the engine, side by side in one batch on a
        static int8 cache (every row computed on its own; T5's inputs padded
        to S2S_ENC and masked as the engine pads them): the model's greedy
        loop.  Returns (tokens, each token's top-1/top-2 margin) by index."""
        d = next(model.parameters()).device
        gen = max(g for _, g in reqs)
        ids = torch.from_numpy(np.stack([r["decoder_start_ids"] for r, _ in reqs])).to(d)
        caches = model.init_cache(len(reqs), ids.shape[1] + gen, quantized=True, device=d)
        with torch.no_grad():
            if whisper:
                x = torch.from_numpy(np.stack([r["encoder_input"] for r, _ in reqs])).to(d)
                t, rows = seq2seq_greedy(model, caches, model.encode(x), ids, gen)
            else:
                x = np.zeros((len(reqs), S2S_ENC), np.int32)
                lens = torch.tensor([r["encoder_input"].size for r, _ in reqs], device=d)
                for i, (r, _) in enumerate(reqs):
                    x[i, :r["encoder_input"].size] = r["encoder_input"]
                keep = torch.arange(S2S_ENC, device=d)[None, :] < lens[:, None]
                emask = torch.where(keep, 0.0, -1e4)[:, None, None, :]
                enc = model.encode(torch.from_numpy(x).to(d), attn_mask=emask)
                t, rows = seq2seq_greedy(model, caches, enc, ids, gen, enc_mask=emask)
        top2 = rows.topk(2, dim=-1).values  # [gen, rows, 2]
        toks = {i: t[i, :g].tolist() for i, (_, g) in enumerate(reqs)}
        margins = {i: (top2[:g, i, 0] - top2[:g, i, 1]).tolist() for i, (_, g) in enumerate(reqs)}
        return toks, margins

    def run(model, reqs, slots):
        with memo_unpack(), torch.no_grad():
            eng = sb.make_seq2seq_engine(model, True, reqs, slots, ENGINE["burst"],
                                         enc_capacity=enc_cap)
            eng.warmup(ENGINE["burst"], **sp.get("warmup", {}))
            stats = sb.closed_loop(eng, reqs, ENGINE["burst"])
        fin = {r.request_id: r.tokens for r in eng.finished}
        return {i: fin[rid] for i, rid in enumerate(stats["rids"])}

    model = build(cfg)
    eng = sb.make_seq2seq_engine(model, True, requests, ENGINE["slots"], ENGINE["burst"],
                                 enc_capacity=enc_cap)
    capacity = eng.max_len
    launches, got = engine_closed_loop(torch, kernels, eng, sp, requests, cfg.vocab_size, card)
    del eng
    held = [requests[i] for i in ENGINE_HELD]
    t0 = time.perf_counter()
    iso, margins = isolated(model, held, capacity)
    log(f"{name}: isolated generation of requests {ENGINE_HELD} on the card "
        f"{time.perf_counter() - t0:.1f} s")
    hold_tokens(name, f"isolated generation on the card (requests {ENGINE_HELD})",
                {j: got[i] for j, i in enumerate(ENGINE_HELD)}, iso, margins, KV8_TOL)
    if whisper:
        # the CPU check at FAMILY_CPU_LAYERS: the first held requests through
        # an engine of as many slots on the card and one on the CPU (the
        # path's model where it runs at that depth)
        held = held[:S2S_CPU_BATCH]
        if L != FAMILY_CPU_LAYERS:
            del model
            torch.cuda.empty_cache()
            model = build(seq2seq_layers(cfg, family, FAMILY_CPU_LAYERS))
        _, margins = isolated(model, held, capacity)
    slots = len(held) if whisper else ENGINE["slots"]
    card_toks = run(model, held, slots)
    model.to("cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = run(model, held, slots)
    depth = model.cfg.num_hidden_layers
    log(f"{name}: CPU engine run of {len(held)} held requests in {slots} slots at {depth} "
        f"layers {time.perf_counter() - t0:.1f} s")
    hold_tokens(name, f"the CPU engine run at {depth} layers ({len(held)} held requests, the "
                f"card's engine at that depth)", card_toks, cpu, margins, KV8_TOL)
    del model
    return launches


# ---------------------------------------------------------------------------
# phase 6: the vision families (CLIP ViT-B/32, LeNet-5) and the op zoo
# ---------------------------------------------------------------------------

def clip_launches(cfg):
    """The kernel launches of one CLIP forward (a ``zero_shot_classify`` or
    a ``__call__``: both towers, both projections) per build, derived from
    the code: 6 packed linears a layer in each tower (q, k, v, out_proj,
    fc1, fc2: CLIPAttention has no merged q/k/v) and the two projections,
    B1 in weights mode, T1 in BASIC; no attention kernel (the modular SDPA,
    as in the JAX package); the patch embedding (Conv2dUnfold) no rule
    names, so its casts stay SAME.  BASIC's T2 launches: a vision layer 33
    (LayerNorm in and out 2 + 2; q, k, v, out_proj, fc1, fc2 their BFP input
    and FLOAT16 output cast, 12 (above 256 rows no linear fuses); QuickGELU
    2; the two residual adds 3 + 3; the SDPA's scores matmul 3 (q along its
    64 head dims, k^T along them too), its bias add 3, softmax 2, the
    probabilities' matmul 1 (its FLOAT16 output: the BFP casts along the 50
    keys are off the block, plain torch)), a text layer 36 (its additive
    mask through one more add, 3), the vision tower's position embedding
    and pre- / post-LayerNorm 5, the text tower's two embeddings and final
    LayerNorm 4, each projection 1 (at 8 rows its linear fuses: the input
    cast in T2, the FLOAT16 output in T1's epilogue).  The sbfp build (SBFP12_16
    on every Linear) launches B5 where weights launches B1."""
    Lv, Lt = cfg.vision.num_hidden_layers, cfg.text.num_hidden_layers
    n = 6 * Lv + 6 * Lt + 2
    return {"weights": {"bfp_linear": n}, "sbfp": {"sbfp_linear": n}, "baseline": {},
            "basic": {"bfp_linear_bf16": n, "bfp_cast": (33 * Lv + 5) + (36 * Lt + 4) + 2}}


def clip_inputs(cfg, n=CLIP_BATCH, seed=0):
    """``n`` images [n, 3, 224, 224] (standard normal) and ``n`` prompts of
    77 token ids (uniform in [0, vocab)), numpy from ``seed`` in
    examples/benchmarking/benchmark_clip.py's order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text
    images = rng.standard_normal((n, 3, v.image_size, v.image_size), np.float32)
    texts = rng.integers(0, t.vocab_size, (n, t.max_position_embeddings)).astype(np.int32)
    return images, texts


def clip_linear_shapes(cfg):
    """(M, K, N, launches) of a CLIP forward's packed linears: the vision
    tower's at M = batch x 50 tokens, the text tower's at batch x 77, the
    projections at the batch."""
    v, t, P = cfg.vision, cfg.text, cfg.projection_dim
    Mv = CLIP_BATCH * ((v.image_size // v.patch_size) ** 2 + 1)
    Mt = CLIP_BATCH * t.max_position_embeddings
    dv, fv, Lv = v.hidden_size, v.intermediate_size, v.num_hidden_layers
    dt, ft, Lt = t.hidden_size, t.intermediate_size, t.num_hidden_layers
    return [(Mv, dv, dv, 4 * Lv), (Mv, dv, fv, Lv), (Mv, fv, dv, Lv),
            (Mt, dt, dt, 4 * Lt), (Mt, dt, ft, Lt), (Mt, ft, dt, Lt),
            (CLIP_BATCH, dv, P, 1), (CLIP_BATCH, dt, P, 1)]


def clip_path_specs():
    """The four CLIP paths: bench.py's weights, sbfp, baseline and basic
    builds."""
    from dmx_compressor_tpu_torch.ops.compress import (
        build_baseline_mode,
        build_basic_mode,
        build_sbfp_mode,
        build_weights_mode,
    )

    return [dict(name="clip_weights", mode="weights", build=build_weights_mode, tol=LOGIT_TOL),
            dict(name="clip_sbfp", mode="sbfp", build=build_sbfp_mode, tol=LOGIT_TOL),
            dict(name="clip_baseline", mode="baseline", build=build_baseline_mode,
                 tol=LOGIT_TOL),
            dict(name="clip_basic", mode="basic", build=build_basic_mode, tol=CLIP_BASIC_TOL,
                 record_t2=True)]


def clip_entry_points(torch, model, px, ids):
    """``zero_shot_classify`` then ``__call__``: {image and text embeddings
    (the call's projections' outputs, taken by forward hooks), logits per
    image, probabilities} and the logits per text."""
    feats = {}
    hooks = [proj.register_forward_hook(lambda m, i, o, k=k: feats.__setitem__(k, o))
             for k, proj in (("image", model.visual_projection),
                             ("text", model.text_projection))]
    try:
        with torch.no_grad():
            probs = model.zero_shot_classify(px, ids)
            per_image, per_text = model(ids, px)
    finally:
        for h in hooks:
            h.remove()
    return dict(image=feats["image"], text=feats["text"], logits=per_image,
                probs=probs), per_text


def hold_classes(name, got, want, tol, what):
    """Each image's class (the argmax of its logits) against ``want``'s,
    where ``want``'s top-1 / top-2 margin exceeds ``tol`` (the margin rule
    of the serving paths' tokens)."""
    top2 = want.topk(2, dim=-1).values
    clear = top2[:, 0] - top2[:, 1] > tol
    differ = clear & (got.argmax(-1) != want.argmax(-1))
    if differ.any():
        raise AssertionError(f"{name}: image {int(differ.nonzero()[0])}'s class differs from "
                             f"{what}'s")
    log(f"{name}: each image's class against {what}: {int(clear.sum())} of {len(clear)} held "
        f"(top-1/top-2 margin > {tol}), all equal")


def clip_path(torch, dev, kernels, cfg, spec):
    """One CLIP path: CLIP ViT-B/32 at full width and depth from seed 0,
    built by ``spec["build"]``; ``zero_shot_classify`` and ``__call__`` over
    clip_inputs' 8 images and 8 prompts with the launch counters set to 0
    just before and read just after (twice :func:`clip_launches` a
    forward); one warm forward's device time (torch.profiler) and the peak
    device memory; the outputs' shapes, finiteness and agreement (the call's
    two logits transposed, its probabilities the softmax of its logits);
    then the model moved to the CPU (the kernels' plain versions) and the
    embeddings, logits and probabilities held against it at
    ``spec["tol"]``, each image's class by :func:`hold_classes`.  The basic
    path records its T2 sites over one more forward.  Returns (the launch
    counts, the path's numbers)."""
    from dmx_compressor_tpu_torch.models.clip import CLIPModel

    name = spec["name"]
    images, texts = clip_inputs(cfg)
    px, ids = torch.from_numpy(images), torch.from_numpy(texts)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = CLIPModel(cfg, device=dev, seed=0)
    spec["build"](model)
    torch.cuda.synchronize()
    log(f"{name} path: CLIPModel vision {cfg.vision.hidden_size}x"
        f"{cfg.vision.num_hidden_layers}, text {cfg.text.hidden_size}x"
        f"{cfg.text.num_hidden_layers} built in {time.perf_counter() - t0:.2f} s; peak device "
        f"memory while building {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    px_d, ids_d = px.to(dev), ids.to(dev)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, per_text = clip_entry_points(torch, model, px_d, ids_d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    forward = clip_launches(cfg)[spec["mode"]]
    want = {**dict.fromkeys(launches, 0), **{k: 2 * n for k, n in forward.items()}}
    log(f"{name} path: launches over zero_shot_classify and __call__ {launches} (expected "
        f"{want}: {forward} a forward); {wall * 1e3:.1f} ms on the host clock (first calls); "
        f"peak device memory {peak:.2f} GiB")
    if launches != want:
        raise AssertionError(f"the {name} path did not launch the kernels the expected number "
                             f"of times")
    n, P = CLIP_BATCH, cfg.projection_dim
    shapes = dict(image=(n, P), text=(n, P), logits=(n, n), probs=(n, n))
    for k, t in out.items():
        if tuple(t.shape) != shapes[k] or not torch.isfinite(t).all():
            raise AssertionError(f"{name} path: {k} {tuple(t.shape)} not finite or misshapen")
    if not torch.equal(per_text, out["logits"].T):
        raise AssertionError(f"{name} path: the logits per text are not the transposed "
                             f"logits per image")
    soft = torch.softmax(out["logits"], dim=-1)
    if not torch.allclose(out["probs"], soft, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"{name} path: zero_shot_classify's probabilities are not the "
                             f"softmax of __call__'s logits")

    events = device_events(torch, lambda: clip_entry_points(torch, model, px_d, ids_d))
    ms = sum(us for _, us in events) / 1e3 / 2
    linear = next((k for k in forward if k in LINEAR_KERNELS), None)
    if linear is None:
        split = "(its linears run cuBLAS)"
    else:
        marks = {"bfp_linear": B1_MARKS, "sbfp_linear": B5_MARKS,
                 "bfp_linear_bf16": T1_MARKS}[linear]
        lin_ms = sum(us for k, us in events if any(m in k for m in marks)) / 1e3 / 2
        split = f"of which {linear} {lin_ms:.4f} ms over {forward[linear]} launches"
    if "bfp_cast" in forward:
        t2_ms = sum(us for k, us in events if any(m in k for m in T2_MARKS)) / 1e3 / 2
        split += f", bfp_cast {t2_ms:.4f} ms over {forward['bfp_cast']} launches"
    log(f"{name} forward, warm: device time {ms:.4f} ms {split} (the mean of a "
        f"zero_shot_classify and a __call__)")
    for ev, us in sorted(events, key=lambda e: -e[1])[:6]:
        log(f"  device, warm forward: {us / 2e3:.4f} ms  {ev[:110]}")
    if spec.get("record_t2"):
        sites = []
        with record_t2(sites), torch.no_grad():
            model(ids_d, px_d)
        spec["t2_sites"] = sites
        log(f"{name} path: recorded {len(sites)} T2 launches over a __call__")

    card = {k: t.float().cpu() for k, t in out.items()}
    del out, per_text, px_d, ids_d
    model.to("cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with memo_unpack():
        cpu, _ = clip_entry_points(torch, model, px, ids)
    log(f"{name} path: CPU reference run {time.perf_counter() - t0:.1f} s")
    tol = spec["tol"]
    for k in ("image", "text", "logits", "probs"):
        err = (card[k] - cpu[k]).abs().max().item()
        log(f"{name} path: {k} GPU vs CPU: max_abs_err={err:.3g} (tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"{name} path: {k} disagree with the CPU run")
    hold_classes(name, card["logits"], cpu["logits"], tol, "the CPU run")
    del model
    return launches, dict(forward_ms=ms, peak_gib=peak)


def check_clip_linears(torch, dev, cfg, seed):
    """B1, T1 and B5 at CLIP ViT-B/32's eight packed linear shapes
    (:func:`clip_linear_shapes`), per launch over a forward's 146."""
    step = clip_linear_shapes(cfg)
    return check_path_linears(torch, dev, "clip", sorted({s[:3] for s in step}), step, seed)


def lenet_path(torch, dev, kernels, spec):
    """One LeNet-5 path: the model from seed 0 built by ``spec["build"]``,
    one forward over LENET_BATCH standard-normal [1, 28, 28] images (numpy,
    seed 0) with the launch counters set to 0 just before and read just
    after (LENET_LAUNCHES), its warm device time and peak device memory,
    then the logits held against the model moved to the CPU at
    ``spec["tol"]``, each image's class by :func:`hold_classes`.  Returns
    (the launch counts, the path's numbers)."""
    import numpy as np

    from dmx_compressor_tpu_torch.models.lenet import LeNet5

    name = spec["name"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LENET_BATCH, 1, 28, 28), np.float32))
    model = LeNet5(device=dev, seed=0)
    spec["build"](model)
    x_d = x.to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with torch.no_grad():
        logits = model(x_d)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {**dict.fromkeys(launches, 0), **LENET_LAUNCHES[spec["mode"]]}
    log(f"{name} path: launches over a forward of {LENET_BATCH} images {launches} (expected "
        f"{want}); peak device memory {peak:.3f} GiB")
    if launches != want:
        raise AssertionError(f"the {name} path did not launch the kernels the expected number "
                             f"of times")
    if tuple(logits.shape) != (LENET_BATCH, 10) or not torch.isfinite(logits).all():
        raise AssertionError(f"{name} path: logits {tuple(logits.shape)} not finite or "
                             f"misshapen")
    with torch.no_grad():
        events = device_events(torch, lambda: model(x_d))
    ms = sum(us for _, us in events) / 1e3
    log(f"{name} forward, warm: device time {ms:.4f} ms")
    for ev, us in sorted(events, key=lambda e: -e[1])[:4]:
        log(f"  device, warm forward: {us / 1e3:.4f} ms  {ev[:110]}")
    card = logits.float().cpu()
    model.to("cpu")
    with torch.no_grad():
        cpu = model(x)
    err = (card - cpu).abs().max().item()
    log(f"{name} path: logits GPU vs CPU: max_abs_err={err:.3g} (tolerance {spec['tol']})")
    if not err <= spec["tol"]:
        raise AssertionError(f"{name} path: logits disagree with the CPU run")
    hold_classes(name, card, cpu, spec["tol"], "the CPU run")
    return launches, dict(forward_ms=ms, peak_gib=peak)


def lenet_path_specs():
    from dmx_compressor_tpu_torch.ops.compress import build_baseline_mode, build_basic_mode

    return [dict(name="lenet_baseline", mode="baseline", build=build_baseline_mode,
                 tol=LOGIT_TOL),
            dict(name="lenet_basic", mode="basic", build=build_basic_mode, tol=LENET_BASIC_TOL)]


def zoo_cases(torch):
    """The op zoo's modules at shapes a user runs, on the CPU, each (label,
    module, inputs, BASIC config or None for the type's BASIC rule, the T2
    launches of its BASIC forward), ``ZOO_BATCH`` = n the batch (Exp's and
    BAddBMM's 12 times it): a ResNet-50 stage (Conv2d 3 x 3, 256 -> 256, no bias, on [n, 256, 56,
    56]) and on its output BatchNorm2d, GroupNorm(32), the pools and
    ReLU6; Conv1d 80 -> 768 (k 3) on Whisper's [n, 80, 3000] (80 channels
    off the BFP block: its BFP casts plain torch); ConvTranspose2d 64 ->
    64, stride 2; Exp on [12n, 128, 128] and BAddBMM on [12n, 128, 64] x
    [12n, 64, 128] (no rule names BAddBMM: a BASIC-like set, FLOAT16 input
    and output, BFP16_64 batches); the experimental convs at CLIP's patch
    embedding (3 -> 768, k 32, stride 32 on [n, 3, 224, 224]) and Whisper's
    conv2 (768 -> 768, k 3, stride 2 on [n, 768, 3000]) under a BASIC-like
    set (BFP16_64 patches and weight, FLOAT16 output), beside the Dmx convs
    they re-lower.  T2 a BASIC forward: a conv 3 (its input, weight and
    output casts; 1 where its input channels, 80 or 3, are off the block),
    a norm, pool, ReLU6 or Exp 2 (FLOAT16 in and out), BAddBMM 4, an
    experimental conv 3."""
    from dmx_compressor_tpu_torch.nn import experimental as ex
    from dmx_compressor_tpu_torch.nn import modules as m

    n = ZOO_BATCH
    fp16, bfp = "FP[1|5|10,15](FN)", "BFP[8|8]{64}(SN)"
    gemm = dict(input_formats=[bfp], weight_format=bfp, output_formats=[fp16])
    g = torch.Generator().manual_seed(40)

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    stage = randn(n, 256, 56, 56)
    stage_conv = m.Conv2d(256, 256, 3, padding=1, bias=False, device="cpu", generator=g)
    with torch.no_grad():
        stage_out = stage_conv(stage)  # the norms', pools' and ReLU6's input
    bn = m.BatchNorm2d(256, device="cpu")
    with torch.no_grad():
        bn.running_mean.copy_(stage_out.mean(dim=(0, 2, 3)) + 0.01 * randn(256))
        bn.running_var.copy_(stage_out.var(dim=(0, 2, 3)) * (1 + 0.1 * torch.rand(256,
                                                                                generator=g)))
        bn.weight.copy_(1 + 0.1 * randn(256))
        bn.bias.copy_(0.1 * randn(256))
    patches = randn(n, 3, 224, 224)
    mel, frames = randn(n, 80, 3000), randn(n, 768, 3000)
    patch_conv = m.Conv2d(3, 768, 32, stride=32, bias=False, device="cpu", generator=g)
    frame_conv = m.Conv1d(768, 768, 3, stride=2, padding=1, device="cpu", generator=g)
    cases = [
        ("Conv2d 3x3 256->256 (ResNet-50 stage)", stage_conv, (stage,), None, 3),
        ("BatchNorm2d(256), running statistics", bn, (stage_out,), None, 2),
        ("GroupNorm(32, 256)", m.GroupNorm(32, 256, device="cpu"), (stage_out,), None, 2),
        ("MaxPool2d(3, 2, 1)", m.MaxPool2d(3, 2, 1), (stage_out,), None, 2),
        ("AvgPool2d(3, 2, 1)", m.AvgPool2d(3, 2, 1), (stage_out,), None, 2),
        ("AdaptiveAvgPool2d(1)", m.AdaptiveAvgPool2d(1), (stage_out,), None, 2),
        ("AdaptiveAvgPool2d((5, 3)), adaptive windows", m.AdaptiveAvgPool2d((5, 3)),
         (stage_out,), None, 2),
        ("ReLU6", m.ReLU6(), (stage_out,), None, 2),
        ("Conv1d 80->768 k3 (Whisper's conv1)",
         m.Conv1d(80, 768, 3, padding=1, device="cpu", generator=g), (mel,), None, 1),
        ("ConvTranspose2d 64->64 k3 stride 2",
         m.ConvTranspose2d(64, 64, 3, stride=2, padding=1, output_padding=1, device="cpu",
                           generator=g), (randn(n, 64, 56, 56),), None, 3),
        ("Exp", m.Exp(), (randn(12 * n, 128, 128),), None, 2),
        ("BAddBMM", m.BAddBMM(), (randn(12 * n, 128, 128), randn(12 * n, 128, 64),
                                  randn(12 * n, 64, 128)),
         dict(input_formats=[fp16, bfp, bfp], output_formats=[fp16]), 4),
        ("Conv2d 3->768 k32 stride 32 (CLIP's patch conv)", patch_conv, (patches,), None, 1),
        ("Conv1d 768->768 k3 stride 2 (Whisper's conv2)", frame_conv, (frames,), None, 3),
        ("Conv2dUnfold (CLIP's patch embedding)", ex.Conv2dUnfold.from_conv(patch_conv),
         (patches,), gemm, 3),
        ("Conv2dGather (CLIP's patch embedding)", ex.Conv2dGather.from_conv(patch_conv),
         (patches,), gemm, 3),
        ("Conv1dUnfold (Whisper's conv2)", ex.Conv1dUnfold.from_conv(frame_conv), (frames,),
         gemm, 3),
        ("Conv1dScatter (Whisper's conv2)", ex.Conv1dScatter.from_conv(frame_conv), (frames,),
         gemm, 3),
    ]
    return cases


def zoo_phase(torch, dev, kernels):
    """Each op-zoo module of :func:`zoo_cases` under BASELINE and BASIC (the
    type's rules, or its BASIC-like set), on the card and on the CPU, the
    same weights and inputs: the card's output against the CPU's (BASELINE
    at B1_TOL's f32 tolerance; BASIC at ZOO_BASIC_TOL: a FLOAT16 output may
    land one step apart), with ``torch.backends.cudnn.allow_tf32`` on, as a
    library user has it (the Dmx convs run f32 whatever it says).  The
    experimental convs also against each other and the Dmx conv they
    re-lower, on the card.  The BASIC forwards' T2 launches are counted
    (counters set to 0 before, read after each) and held to the cases'
    counts.  Returns the launch counts over the BASIC forwards."""
    import copy

    import dmx_compressor_tpu_torch as tdmx

    def rule(mod):
        for r in tdmx.config_rules.BASIC:
            if isinstance(mod, r.module_types):
                return dict(r.module_config)
        raise KeyError(type(mod).__name__)

    total = dict.fromkeys(kernels.LAUNCHES, 0)
    card_out = {}
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for label, mod, xs, basic, t2 in zoo_cases(torch):
            for mode in ("baseline", "basic"):
                cpu_mod = copy.deepcopy(mod)
                if mode == "basic":
                    cpu_mod.configure(basic or rule(cpu_mod))
                card_mod = copy.deepcopy(cpu_mod).to(dev)
                xs_d = [x.to(dev) for x in xs]
                torch.cuda.synchronize()
                kernels.reset_launches()
                with torch.no_grad():
                    got = card_mod(*xs_d)
                torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)
                want_t2 = t2 if mode == "basic" else 0
                if launches != {**dict.fromkeys(launches, 0), "bfp_cast": want_t2}:
                    raise AssertionError(f"zoo {label} {mode}: launches {launches}, expected "
                                         f"{want_t2} bfp_cast")
                if mode == "basic":
                    for k, v in launches.items():
                        total[k] += v
                with torch.no_grad():
                    want = cpu_mod(*xs)
                tol = B1_TOL if mode == "baseline" else ZOO_BASIC_TOL
                got = got.float().cpu()
                err = (got - want).abs().max().item()
                ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
                      and torch.allclose(got, want, **tol))
                log(f"zoo {label} {mode} {[tuple(x.shape) for x in xs]} -> {tuple(got.shape)}: "
                    f"card vs CPU max_abs_err={err:.3g} (tolerance {tol}); {want_t2} T2 launches")
                if not ok:
                    raise AssertionError(f"zoo {label} {mode}: the card disagrees with the CPU")
                card_out[label, mode] = got
        pairs = [(a, b, mode) for a, b in (("Conv2dGather", "Conv2dUnfold"),
                                           ("Conv1dScatter", "Conv1dUnfold"))
                 for mode in ("baseline", "basic")]
        pairs += [("Conv2dUnfold", "Conv2d 3->768", "baseline"),
                  ("Conv1dUnfold", "Conv1d 768->768", "baseline")]
        for a, b, mode in pairs:
            x, y = (next(v for (lab, md), v in card_out.items()
                         if lab.startswith(c) and md == mode) for c in (a, b))
            err = (x - y).abs().max().item()
            tol = B1_TOL if mode == "baseline" else ZOO_BASIC_TOL
            log(f"zoo {a} against {b} on the card, {mode}: max_abs_err={err:.3g} "
                f"(tolerance {tol}; bit for bit: {torch.equal(x, y)})")
            if not torch.allclose(x, y, **tol):
                raise AssertionError(f"zoo {a} disagrees with {b} on the card")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    return total


# ---------------------------------------------------------------------------
# phase 7: the PTQ recipes (calibration, SmoothQuant, GPTQ and the rest)
# ---------------------------------------------------------------------------

# the recipes' calibration batch: 4 x 128 token ids from numpy seed 1
PTQ_CALIB = (4, 128)
PTQ_GPTQ = dict(microblock_size=64, block_size=128, percdamp=0.01)
# SmoothQuant scales, card vs CPU: the maxabs of f32 matmul outputs summed in
# another order, and powf on CUDA against the CPU's (an ulp apart at ~1 % of
# the channels, as XLA's against torch's)
PTQ_SQ_RTOL = 1e-5
# ... and over a whole model (ptq_recipe_parity, 4 layers): each deeper
# Linear's input maxabs comes from activations summed in another order, and a
# channel whose maxabs is small moves most relatively: an H100 read 1.75e-4,
# twice that
PTQ_MODEL_SQ_RTOL = 3.5e-4
# ptq_weights' prefill logits, the recipe run on the card against the same
# recipe run on the CPU (the same raw weights): the GPTQ weights that a last
# bit of the Hessian's sums or of the float64 factorizations moves one BFP16
# step apart (353 of 66.9M at 4 layers) shift them, and each step weighs
# with an undivided input (the SmoothQuant-folded payloads, as in JAX): an
# H100 read 0.1 at 4 layers, 0.0441 at 2, above LOGIT_TOL, so twice the larger
PTQ_LOGIT_TOL = 0.2
# ptq_weights' logits card vs CPU (the same build): its decode steps read the
# int8 cache, whose entries card and CPU may round one step apart (the
# weights path's case, KV8_TOL), and the SmoothQuant-folded payloads meet
# undivided inputs (as in the JAX package), which widens the K/V rows; an
# H100 read 0.0308 at a decode step at 4 layers and 0.105 at 2 (logits up to
# ~18): twice the larger, the int8 cache's witness printed
PTQ_PATH_TOL = 0.21
# the calibration example, card vs CPU: an activation an ulp apart rounds to
# the next INT8 step and the steps compound over the layers (the port
# against the JAX package on the CPU: 0.3 %, tests/test_torch_recipes.py);
# an H100 read 0.80 % at 4 layers, 0.63 % at 2: twice the larger
CALIB_PPL_RTOL = 0.016
CALIB_SCALE_RTOL = 1e-2
# SLaNC's norms card vs CPU: f32 matmuls and cuSOLVER's f32 SVD against
# LAPACK's (an H100 read 9.5e-5 apart, the card's 9.3e-5 off the float64
# reference, printed beside)
SLANC_RTOL = 1e-3
# the calibration example's CPU check: its perplexities over 32 ids (one
# window; 64 before the export phases), not 512: at 4 layers the CPU takes
# ~2 minutes over 512 (the BASIC head's weight cast of 50272 x 768 at every
# forward)
CALIB_CPU_IDS = 32
# the recipes phase: each piece at one OPT-125m layer's shapes
RECIPE_X = (8, 128)  # activations [8, 128, K]


def ptq_recipe_launches(cfg):
    """The launches of the ptq_weights recipes over one calibration batch,
    derived from the code (weights_mode_rules: SAME activations, BFP16_64
    weight casts; no cache: no attention kernel): the SmoothQuant forward
    casts each of the 6L+1 Linears' weights once (T2); GPTQ's forward casts
    nothing (its weight casts are off while the Hessian accumulates), and
    its update casts each microblock of 64 input columns once: L(4d + d +
    f) / 64 + d / 64 T2 (1308 at OPT-125m)."""
    L, d, f = cfg.num_hidden_layers, cfg.hidden_size, cfg.ffn_dim
    return {"SmoothQuant": {"bfp_cast": 6 * L + 1},
            "GPTQ": {"bfp_cast": L * (5 * d + f) // PTQ_GPTQ["microblock_size"]
                     + d // PTQ_GPTQ["microblock_size"]}}


def ptq_recipes(torch, kernels, model, stats=None):
    """The ptq_weights build before compression, in place: the weights-mode
    rules, then SmoothQuant (migration 0.5, fused into the weights), then
    GPTQ (microblock 64, block 128, damping 0.01), each over the PTQ_CALIB
    batch.  With ``stats`` each recipe's wall seconds, peak device memory and
    launches are recorded there.  Returns the DmxModel."""
    import numpy as np

    from dmx_compressor_tpu_torch.advanced_recipe import (
        DmxGPTQRecipe,
        DmxSmoothQuantRecipe,
        gptq_for_all_linears,
        smoothquant_for_all_linears,
    )
    from dmx_compressor_tpu_torch.ops.compress import weights_mode_rules

    dev = next(model.parameters()).device
    on_card = dev.type == "cuda"
    dm = weights_mode_rules(model)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, PTQ_CALIB)).to(dev)
    for what, recipe in (
            ("SmoothQuant", DmxSmoothQuantRecipe(smoothquant_for_all_linears(0.5, True))),
            ("GPTQ", DmxGPTQRecipe(gptq_for_all_linears(**PTQ_GPTQ)))):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with recipe.applied_to(dm), torch.no_grad():
            dm(ids)
        if on_card:
            torch.cuda.synchronize()
        if stats is not None:
            stats[what] = dict(
                seconds=round(time.perf_counter() - t0, 3),
                peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3) if on_card else None,
                launches={k: v for k, v in kernels.LAUNCHES.items() if v})
    return dm


def linear_weights(torch, model):
    """{path: a copy of the weight} of every Dmx Linear of ``model``."""
    from dmx_compressor_tpu_torch import nn as dmxnn

    return {n: m.weight.detach().clone() for n, m in model.named_modules()
            if isinstance(m, dmxnn.Linear)}


def check_ptq_payloads(torch, model, weights):
    """Every packed payload of ``model`` unpacks to the GPTQ weight it was
    packed from, bit for bit (GPTQ leaves each weight on BFP16_64's grid; a
    merged q/k/v payload the three concatenated).  Returns the number held."""
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_unpack
    from dmx_compressor_tpu_torch.ops.compress import PackedBFPLinear

    held = 0
    for name, m in model.named_modules():
        if not isinstance(m, PackedBFPLinear) or m.weight_mantissa is None:
            continue
        if name.endswith("qkv_merged"):
            prefix = name[:-len("qkv_merged")]
            w = torch.cat([weights[prefix + p] for p in ("q_proj", "k_proj", "v_proj")])
        else:
            w = weights[name]
        if not torch.equal(bfp_unpack(m.packed), w.to(m.weight_mantissa.device)):
            raise AssertionError(f"ptq_weights: {name}'s payload does not unpack to its GPTQ "
                                 f"weight")
        held += 1
    return held


def bfp_steps(torch, w, precision=8, block=64):
    """Each weight's BFP16_64 step, 2^(exponent + 2 - precision)."""
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack

    e = bfp_pack(w, precision, block).exponent.to(torch.float32)
    return torch.exp2(e.repeat_interleave(block, dim=-1) + 2 - precision)


def gptq_apart(torch, card_w, cpu_w):
    """(weights apart, weights, most steps apart) of two GPTQ results."""
    a, b = card_w.cpu(), cpu_w.cpu()
    steps = ((a - b).abs() / bfp_steps(torch, b)).max().item()
    return int((a != b).sum()), a.numel(), steps


def ptq_spec(cfg, stats, weights):
    """The ptq_weights path: OPT-125m at full width and depth from the
    weights path's raw weights (seed 0), :func:`ptq_recipes`, then
    ``compress_for_inference`` and bench.py's decode through the int8 KV
    cache.  After compression the launches are the weights path's: a
    prefill 4L+1 B1 + L B3, a step 4L+1 B1 + L B2 (q/k/v merge: the packed
    linears carry SmoothQuants of their own, idle, as in the JAX package).
    Its CPU check runs the same build at FAMILY_CPU_LAYERS on the card and
    the CPU; :func:`ptq_recipe_parity` holds the recipe itself."""
    from dmx_compressor_tpu_torch.ops.compress import compress_for_inference, set_inference_mode

    L = cfg.num_hidden_layers

    def build(model):
        import torch

        from dmx_compressor_tpu_torch import kernels

        deep = model.cfg.num_hidden_layers == L
        dm = ptq_recipes(torch, kernels, model, stats if deep else None)
        if deep:
            weights.update(linear_weights(torch, model))
        compress_for_inference(dm)
        set_inference_mode(True)
        if deep:
            stats["payloads_held"] = check_ptq_payloads(torch, model, weights)
        return dm

    import dataclasses

    return dict(name="ptq_weights", build=build, cache=dict(max_len=CAPACITY, quantized=True),
                prefill={"bfp_linear": 4 * L + 1, "flash_attention": L}, prepare=None,
                step={"bfp_linear": 4 * L + 1, "flash_decode_int8": L},
                marks={"bfp_linear": B1_MARKS, "flash_decode_int8": B2_MARKS},
                cpu_cfg=dataclasses.replace(cfg, num_hidden_layers=FAMILY_CPU_LAYERS),
                logit_tol=PTQ_PATH_TOL, kv_witness=True)


def ptq_recipe_parity(torch, dev, kernels, cfg):
    """The ptq_weights recipe at ``cfg`` (FAMILY_CPU_LAYERS layers, full
    width) run on the card and on the CPU from the same raw weights: every
    Linear's SmoothQuant scale (PTQ_MODEL_SQ_RTOL), the share of GPTQ weights
    equal and none more than one BFP16_64 step apart (the float64 Cholesky
    of cuSOLVER and of LAPACK differ in last bits), then each compressed,
    the card's prefill logits against the CPU's (PTQ_LOGIT_TOL).  Returns
    its numbers."""
    import numpy as np

    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.models.shared import greedy_prefill
    from dmx_compressor_tpu_torch.ops.compress import compress_for_inference, set_inference_mode

    card = OPTForCausalLM(cfg, device=dev, seed=0)
    cpu = OPTForCausalLM(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    times, dms = {}, {}
    for where, model in (("card", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        dms[where] = ptq_recipes(torch, kernels, model)
        times[where] = round(time.perf_counter() - t0, 2)
    sq_err, apart, total, steps = 0.0, 0, 0, 0.0
    cpu_mods = dict(cpu.named_modules())
    for name, w in linear_weights(torch, card).items():
        sq, csq = dict(card.named_modules())[name].smoothquant, cpu_mods[name].smoothquant
        rel = ((sq.scale.cpu() - csq.scale).abs() / csq.scale.abs()).max().item()
        sq_err = max(sq_err, rel)
        a, n, s = gptq_apart(torch, w, cpu_mods[name].weight.detach())
        apart, total, steps = apart + a, total + n, max(steps, s)
    log(f"ptq recipes at {cfg.num_hidden_layers} layers: card {times['card']} s, CPU "
        f"{times['cpu']} s; SmoothQuant scales card vs CPU largest relative difference "
        f"{sq_err:.3g} (tolerance {PTQ_MODEL_SQ_RTOL}); GPTQ weights card vs CPU: {apart} of "
        f"{total} apart ({apart / total:.3g}), at most {steps:.3g} BFP16_64 step(s)")
    if not sq_err <= PTQ_MODEL_SQ_RTOL:
        raise AssertionError("ptq recipes: SmoothQuant scales disagree with the CPU run")
    if not steps <= 1.0:
        raise AssertionError("ptq recipes: a GPTQ weight lands more than one step from the CPU's")
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                        generator=torch.Generator().manual_seed(1))
    logits = {}
    for where, model in (("card", card), ("cpu", cpu)):
        compress_for_inference(dms[where])
        set_inference_mode(True)
        d = next(model.parameters()).device
        with memo_unpack():
            logits[where] = greedy_prefill(
                model, model.init_cache(BATCH, CAPACITY, quantized=True, device=d),
                ids.to(d))[0].float().cpu()
    set_inference_mode(False)
    err = (logits["card"] - logits["cpu"]).abs().max().item()
    log(f"ptq recipes: prefill logits, the card's recipe on the card against the CPU's on the "
        f"CPU: max_abs_err={err:.3g} (tolerance {PTQ_LOGIT_TOL}; largest |logit| "
        f"{logits['cpu'].abs().max().item():.4g}, share of logits apart by more than "
        f"{LOGIT_TOL}: {((logits['card'] - logits['cpu']).abs() > LOGIT_TOL).float().mean():.3g})")
    if not (err <= PTQ_LOGIT_TOL and np.isfinite(err)):
        raise AssertionError("ptq recipes: the card's calibrated model disagrees with the CPU's")
    del card, cpu, dms
    torch.cuda.empty_cache()
    return dict(sq_rel=sq_err, gptq_apart=apart, gptq_weights=total, gptq_steps=steps,
                logit_err=err, seconds=times)


def calib_launches(cfg, windows):
    """The calibration example's launches at ``cfg``, derived from the code
    (no cache anywhere, so no attention kernel; the Linears unpacked, each
    weight cast at every forward): the f32 perplexity none; a BASIC forward
    42L+7 T2 (each layer's LayerNorms 2 + 2, q, k, v, out_proj, fc1 and fc2
    their BFP input, BFP weight and FLOAT16 output casts 18, the SDPA's 14,
    ReLU 2, the residual adds 3 + 3; the embeddings' 2, the final LayerNorm's
    2, the head's 3), ``windows`` of them for the BASIC perplexity; a forward
    with INT8 Linear inputs 36L+6 (their input casts plain torch), once
    under the MinMax calibration, once under SmoothQuant's and ``windows``
    times for the calibrated perplexity."""
    L = cfg.num_hidden_layers
    return {"bfp_cast": windows * (42 * L + 7) + (windows + 2) * (36 * L + 6)}


def calib_basic_path(torch, dev, kernels, cfg, cpu_cfg):
    """The port's examples/model_calibration.py flow (``calibrate``) at
    ``cfg`` on the card from seed 0: its three perplexities over 512 ids in
    windows of 32, its launches (:func:`calib_launches`, counters set to 0
    just before and read just after) and wall time; then at ``cpu_cfg``
    (FAMILY_CPU_LAYERS) on the card and on the CPU from the same raw weights,
    over CALIB_CPU_IDS ids: the perplexities (CALIB_PPL_RTOL) and every
    Linear's INT8 input scale
    (CALIB_SCALE_RTOL) and zero point.  Returns the launch counts."""
    import numpy as np

    from dmx_compressor_tpu_torch.examples.model_calibration import calibrate
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.ops.compress import set_inference_mode

    set_inference_mode(False)  # as the example runs in a process of its own
    windows = 512 // 32
    model = OPTForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = calibrate(model, np.random.default_rng(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {**dict.fromkeys(launches, 0), **calib_launches(cfg, windows)}
    log(f"calib_basic path: {cfg.num_hidden_layers} layers, {wall:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; perplexity f32 {out['fp32']:.4f}, "
        f"BASIC {out['basic']:.4f}, BASIC + INT8 inputs calibrated + SmoothQuant "
        f"{out['calibrated']:.4f}; launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError("the calib_basic path did not launch the kernels the expected "
                             "number of times")
    if not all(np.isfinite(out[k]) and out[k] > 1 for k in ("fp32", "basic", "calibrated")):
        raise AssertionError("calib_basic path: a perplexity is not finite")
    del model, out
    torch.cuda.empty_cache()

    card = OPTForCausalLM(cpu_cfg, device=dev, seed=0)
    cpu = OPTForCausalLM(cpu_cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    res = {}
    for where, m in (("card", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        res[where] = calibrate(m, np.random.default_rng(0), eval_len=CALIB_CPU_IDS)
        res[where]["seconds"] = round(time.perf_counter() - t0, 2)
    for k in ("fp32", "basic", "calibrated"):
        a, b = res["card"][k], res["cpu"][k]
        log(f"calib_basic at {cpu_cfg.num_hidden_layers} layers: perplexity {k} card {a:.6f}, "
            f"CPU {b:.6f} (relative {abs(a - b) / b:.3g}, tolerance {CALIB_PPL_RTOL})")
        if not abs(a - b) <= CALIB_PPL_RTOL * b:
            raise AssertionError(f"calib_basic: the {k} perplexity disagrees with the CPU run")
    worst, zp_apart, n = 0.0, 0, 0
    cpu_mods = dict(res["cpu"]["dm"].named_dmx_modules())
    for name, m in res["card"]["dm"].named_dmx_modules():
        if name in cpu_mods and hasattr(m, "weight") and m.has_weight and m.ch_axis == -1:
            a, b = m.input_casts["input_cast"], cpu_mods[name].input_casts["input_cast"]
            worst = max(worst, ((a.scale.cpu() - b.scale).abs() / b.scale).max().item())
            zp_apart += int((a.zero_point.cpu() != b.zero_point).sum())
            n += 1
    log(f"calib_basic at {cpu_cfg.num_hidden_layers} layers: the {n} Linears' MinMax INT8 input "
        f"scales card vs CPU: largest relative difference {worst:.3g} (tolerance "
        f"{CALIB_SCALE_RTOL}), {zp_apart} zero point(s) apart; card {res['card']['seconds']} s, "
        f"CPU {res['cpu']['seconds']} s")
    if not worst <= CALIB_SCALE_RTOL:
        raise AssertionError("calib_basic: the observers' scales disagree with the CPU run")
    del card, cpu, res
    torch.cuda.empty_cache()
    return launches


def int8kv_path(torch, dev, kernels, cfg):
    """The port's examples/opt_int8_smoothquant_kv.py at ``cfg`` on the
    card from seed 0: INT8 per-group weights (group 64, MinMax, symmetric),
    SmoothQuant fused, the perplexities, then greedy decode of batch 2 x 8
    prompt ids through the int8 KV cache, 8 tokens, with the counters set
    to 0 just before and read just after (the build launches nothing: INT8
    weight casts are plain torch; a prefill L B3, each of the 7 steps L B2).
    The built model is then moved to the CPU and fed the card's tokens: each
    step's logits within KV8_TOL, each token the CPU's where its top-1/top-2
    margin exceeds it.  Returns the launch counts."""
    import numpy as np

    from dmx_compressor_tpu_torch.examples.opt_int8_smoothquant_kv import build, generate
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.ops.compress import set_inference_mode

    set_inference_mode(False)  # as the example runs in a process of its own
    L, G, nb, T = cfg.num_hidden_layers, 8, 2, 8
    model = OPTForCausalLM(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = build(model, rng)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    built = dict(kernels.LAUNCHES)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (nb, T)))
    kernels.reset_launches()
    t0 = time.perf_counter()
    toks = generate(model, ids.to(dev), G)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    zero = dict.fromkeys(launches, 0)
    want = {**zero, "flash_attention": L, "flash_decode_int8": (G - 1) * L}
    log(f"int8kv_example path: build {t_build:.2f} s (launches {built}, expected {zero}), "
        f"perplexity f32 {out['fp32']:.4f}, INT8-group + SmoothQuant {out['quantized']:.4f}; "
        f"greedy decode {t_gen:.2f} s, launches {launches} (expected {want}); tokens "
        f"{toks.tolist()}")
    if built != zero or launches != want:
        raise AssertionError("the int8kv_example path did not launch the kernels the expected "
                             "number of times")
    # the card's logits over its own tokens, teacher-forced (not counted),
    # then the same on the CPU
    rows = {}
    card_toks = toks.cpu()
    for where in ("card", "cpu"):
        if where == "cpu":
            model.to("cpu")
            torch.cuda.empty_cache()
        d = next(model.parameters()).device
        caches = model.init_cache(nb, T + G, quantized=True, device=d)
        with torch.no_grad():
            r = [model(ids.to(d), caches=caches, position_offset=0)[:, -1]]
            for i in range(G - 1):
                r.append(model(card_toks[:, i:i + 1].to(d), caches=caches,
                               position_offset=T + i)[:, -1])
        rows[where] = torch.stack(r).float().cpu()  # [G, nb, V]
    errs = (rows["card"] - rows["cpu"]).abs().amax(dim=(1, 2)).tolist()
    log(f"int8kv_example: logits card vs CPU (the CPU fed the card's tokens), per step: "
        f"max_abs_err {', '.join(f'{e:.3g}' for e in errs)} (tolerance {KV8_TOL})")
    if not max(errs) <= KV8_TOL:
        raise AssertionError("int8kv_example: the logits disagree with the CPU run")
    top2 = rows["cpu"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > KV8_TOL).T
    if (clear & (rows["cpu"].argmax(-1).T != card_toks)).any():
        raise AssertionError("int8kv_example: a greedy token differs from the CPU's choice")
    log(f"int8kv_example: greedy tokens card vs CPU on the same inputs: {int(clear.sum())} of "
        f"{nb * G} held (top-1/top-2 margin > {KV8_TOL}), all equal")
    del model
    return launches


def both_devices(torch, dev, fn):
    """``fn(device)`` on the card and on the CPU: (card result on the CPU,
    CPU result); tensors, or tuples / lists / dicts of them."""
    def to_cpu(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu()
        if isinstance(v, (tuple, list)):
            return type(v)(to_cpu(a) for a in v)
        if isinstance(v, dict):
            return {k: to_cpu(a) for k, a in v.items()}
        return v

    return to_cpu(fn(dev)), to_cpu(fn(torch.device("cpu")))


def slanc_f64(torch, d, f):
    """:func:`recipes_phase`'s three SLaNC norms computed in float64 on the
    CPU from the same weights (the reference both f32 runs are read
    against)."""
    import numpy as np

    def w(shape, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape) * 0.05)

    ln, v, o, fc1, fc2, gate, up, down = (
        w(s, i) for i, s in enumerate(((d,), (d, d), (d, d), (f, d), (d, f), (f, d), (f, d),
                                       (d, f)), start=1))
    spec = lambda m: torch.linalg.matrix_norm(m, ord=2)  # noqa: E731
    return torch.tensor([
        torch.linalg.matrix_norm((o @ v + torch.eye(d, dtype=torch.float64)) * ln).item(),
        (ln.abs().sum() * spec(fc1) * spec(fc2) / d).item(),
        (torch.linalg.matrix_norm(down @ (up * ln)) * spec(gate * ln)).item()],
        dtype=torch.float64)


def recipes_phase(torch, dev, kernels, cfg):
    """Each ported PTQ piece on the card against the CPU, at one OPT-125m
    layer's shapes (weights 768 x 768 and 768 x 3072, activations [8, 128,
    768] and [8, 128, 3072], numpy seed 7, a few outlier channels); the
    launches of the card's runs counted.  Bit for bit: the MinMax (per
    tensor, per channel, per group of 64), Histogram and Percentile qparams,
    Quantize / DeQuantize, the four BTK8_* masks and TopK, the FLOP totals,
    the plugins' call log.  SmoothQuant scales (static and dynamic) at
    PTQ_SQ_RTOL; GPTQ at (microblock, block) (64, 128) and (128, 128): the
    share of weights apart, none beyond one step; SLaNC norms at SLANC_RTOL,
    each side also read against float64; AFT's tuned ``max_adjust`` on a
    vsimd softmax of [8, 12, 128, 128] scores within 0.05 and its error
    within 5 % (an MSE of ~1e-12: the surrogate's last bits move the
    search).  Returns (the launch counts, its numbers)."""
    import numpy as np

    import dmx_compressor_tpu_torch as tdmx
    from dmx_compressor_tpu_torch import layer_reconstruction as lr
    from dmx_compressor_tpu_torch import nn as dmxnn
    from dmx_compressor_tpu_torch.advanced_recipe import (
        DmxModuleApproximationFunctionTuningHyperparams,
        DmxModuleGPTQHyperparams,
        DmxModuleSLaNCHyperparams,
        DmxModuleSmoothQuantHyperparams,
    )
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.numerics import cast as tcast
    from dmx_compressor_tpu_torch.numerics import observer as obs
    from dmx_compressor_tpu_torch.numerics.format import Format
    from dmx_compressor_tpu_torch.ops.compress import set_inference_mode
    from dmx_compressor_tpu_torch.plugins import ActivatePlugins, PluginBase
    from dmx_compressor_tpu_torch.sparse import TopK

    set_inference_mode(False)  # the approximation error needs the exact op
    rng = np.random.default_rng(7)
    d, f = cfg.hidden_size, cfg.ffn_dim
    x_np = rng.standard_normal((*RECIPE_X, d)).astype(np.float32)
    x_np[..., :4] *= 40.0  # outlier channels
    xf_np = rng.standard_normal((*RECIPE_X, f)).astype(np.float32)
    w_np = (rng.standard_normal((d, d)) * 0.05).astype(np.float32)
    wf_np = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    int8 = Format.from_shorthand("XP[8,0](CSN)")
    out, bad = {}, []
    kernels.reset_launches()

    def exact(what, pair):
        a, b = pair
        flat = lambda v: v if isinstance(v, (tuple, list)) else [v]  # noqa: E731
        same = all(torch.equal(p, q) for p, q in zip(flat(a), flat(b)))
        out[what] = "bit for bit" if same else "differ"
        if not same:
            bad.append(what)

    def observe(make, batches):
        def run(device):
            o = make()
            for xb in batches:
                o(torch.from_numpy(xb).to(device))
            return o.calculate_qparams()
        return run

    for what, make in (
            ("MinMax per tensor", lambda: obs.MinMaxObserver(int8, "per_tensor_affine")),
            ("MinMax per channel", lambda: obs.MinMaxObserver(int8, "per_channel_symmetric",
                                                                -1)),
            ("Histogram", lambda: obs.HistogramObserver(int8)),
            ("Percentile", lambda: obs.PercentileObserver(int8))):
        exact(what, both_devices(torch, dev, observe(make, [x_np, x_np * 1.5])))

    def group_calibration(device):
        c = tcast.CastTo(format=int8)
        c.enable_calibration(True, observer_cls=obs.MinMaxObserver,
                             qscheme_to_overload="per_tensor_symmetric", group_size=64,
                             ch_axis=-1)
        c(torch.from_numpy(w_np).to(device))
        c.enable_calibration(False)
        return c.scale, c.zero_point, c(torch.from_numpy(wf_np[:, :d]).to(device))

    exact("MinMax per group of 64 and its cast", both_devices(torch, dev, group_calibration))

    def quantize(device):
        q = tcast.Quantize(0.05, 3, int8).to(device)(torch.from_numpy(x_np).to(device))
        return q, tcast.DeQuantize(0.05, 3).to(device)(q)

    exact("Quantize / DeQuantize", both_devices(torch, dev, quantize))

    def masks(device):
        score = torch.from_numpy(wf_np).to(device)
        return [getattr(tdmx.sparseness, n).get_mask(score) for n in
                ("BTK8_4_LD", "BTK8_4_FD", "BTK8_2_LD", "BTK8_2_FD")] + [
            TopK(density=0.5).get_mask(score)]

    exact("BTK8_4_LD, BTK8_4_FD, BTK8_2_LD, BTK8_2_FD and TopK masks",
          both_devices(torch, dev, masks))

    def linear(device, w, fmt=None):
        n_out, n_in = w.shape
        m = dmxnn.Linear(n_in, n_out, device=device)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w).to(device))
            m.bias.zero_()
        if fmt:
            m.configure(dict(weight_format=fmt))
        return m

    def smoothquant(dynamic):
        def run(device):
            m = linear(device, w_np)
            xs = [torch.from_numpy(x_np * s).to(device) for s in (1.0, 2.0)]
            if dynamic:
                m.init_smoothquant(dynamic=True)
                m.smoothquant.enable()
                scales = []
                for xb in xs:
                    with torch.no_grad():
                        m(xb)
                    scales.append(m.smoothquant.scale.clone())
                return scales
            with m.calibrating_smoothquant(DmxModuleSmoothQuantHyperparams()), torch.no_grad():
                for xb in xs:
                    m(xb)
            return [m.smoothquant.scale]
        return run

    for what, dynamic in (("SmoothQuant static", False), ("SmoothQuant dynamic", True)):
        card, cpu = both_devices(torch, dev, smoothquant(dynamic))
        rel = max(((a - b).abs() / b).max().item() for a, b in zip(card, cpu))
        out[what] = f"scales largest relative difference {rel:.3g}"
        if not rel <= PTQ_SQ_RTOL:
            bad.append(what)

    gptq_t2 = {}
    for w, x, pairs in ((w_np, x_np, ((64, 128), (128, 128))), (wf_np, xf_np, ((64, 128),))):
        for mb, blk in pairs:
            def gptq(device, w=w, x=x, mb=mb, blk=blk):
                m = linear(device, w, "BFP[8|8]{64}(SN)")
                before = kernels.LAUNCHES["bfp_cast"]
                with m.optimal_brain_compressing(DmxModuleGPTQHyperparams(mb, blk)), \
                        torch.no_grad():
                    m(torch.from_numpy(x).to(device))
                if device.type == "cuda":
                    gptq_t2[f"{w.shape[1]}x{w.shape[0]} ({mb}, {blk})"] = (
                        kernels.LAUNCHES["bfp_cast"] - before)
                return m.weight

            card, cpu = both_devices(torch, dev, gptq)
            apart, n, steps = gptq_apart(torch, card, cpu)
            what = f"GPTQ {w.shape[1]} -> {w.shape[0]} at ({mb}, {blk})"
            out[what] = f"{apart} of {n} weights apart, at most {steps:.3g} step(s)"
            if not steps <= 1.0:
                bad.append(what)
    want_t2 = {k: int(k.split("x")[0]) // int(k.split("(")[1].split(",")[0]) for k in gptq_t2}
    out["GPTQ T2 launches"] = f"{gptq_t2} (expected {want_t2}: one a microblock)"
    if gptq_t2 != want_t2:
        bad.append("GPTQ T2 launches")

    def slanc(device):
        def mod(shape, seed):
            m = torch.nn.Module()
            m.weight = torch.nn.Parameter(torch.from_numpy(
                (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
            ).to(device))
            return m

        ln = mod((d,), 1)
        kw = dict(prev_ln_weight=ln, v_proj=mod((d, d), 2), o_proj=mod((d, d), 3),
                  fc1=mod((f, d), 4), fc2=mod((d, f), 5), gate_proj=mod((f, d), 6),
                  up_proj=mod((f, d), 7), down_proj=mod((d, f), 8))
        return torch.tensor([lr.compute_slanc_norm(DmxModuleSLaNCHyperparams(p, t, **kw))
                             for p, t in (("post_attn", "standard"), ("post_mlp", "standard"),
                                          ("post_mlp", "llama"))], dtype=torch.float64)

    card, cpu = both_devices(torch, dev, slanc)
    f64 = slanc_f64(torch, d, f)
    rel = ((card - cpu).abs() / cpu).max().item()
    out["SLaNC norms"] = (f"{card.tolist()} vs {cpu.tolist()} (relative {rel:.3g}; against "
                          f"float64 on the CPU: card {((card - f64).abs() / f64).max().item():.3g},"
                          f" CPU {((cpu - f64).abs() / f64).max().item():.3g})")
    if not rel <= SLANC_RTOL:
        bad.append("SLaNC norms")

    scores_np = (rng.standard_normal((*RECIPE_X[:1], 12, RECIPE_X[1], RECIPE_X[1])) * 3.0
                 ).astype(np.float32)

    def aft(device):
        m = dmxnn.Softmax(dim=-1)
        m.configure(dict(approximation_function="SOFTMAX[vsimd]{input_clamp=-100}"
                                                 "(max_adjust=0.5)"))
        xs = torch.from_numpy(scores_np).to(device)
        with m.tuning_approximation_function(DmxModuleApproximationFunctionTuningHyperparams(
                [("max_adjust", 0.0, 1.0)])), torch.no_grad():
            m(xs)
        with torch.no_grad():
            m(xs)
        return (torch.tensor(m.approximator.function.extra_params["max_adjust"]),
                torch.mean(m.approximation_error.double() ** 2))

    card, cpu = both_devices(torch, dev, aft)
    out["AFT"] = (f"max_adjust {card[0].item():.6f} vs {cpu[0].item():.6f}, error "
                  f"{card[1].item():.4g} vs {cpu[1].item():.4g}")
    if not (abs(card[0] - cpu[0]) < 0.05 and abs(card[1] / cpu[1] - 1) < 0.05):
        bad.append("AFT")

    one = type(cfg)(**{**vars(cfg), "num_hidden_layers": 1})
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, RECIPE_X))

    def flops_and_plugins(device):
        model = OPTForCausalLM(one, device=device, seed=0)
        dm = DmxModel.from_raw(model)

        class Log(PluginBase):
            calls = []

            def process_layer(self, data):
                self.calls.append(type(data.mod).__name__)

        plug = Log()
        with dm.counting_flops(), ActivatePlugins(plug).applied_to(dm), torch.no_grad():
            dm(ids.to(device))
        return torch.tensor([dm.flops]), plug.calls

    (cf, clog), (pf, plog) = both_devices(torch, dev, flops_and_plugins)
    toks = RECIPE_X[0] * RECIPE_X[1]
    want = toks * (4 * d * d + 2 * d * f + d * cfg.vocab_size)
    out["counting_flops"] = f"card {int(cf)}, CPU {int(pf)} (expected {want})"
    if not int(cf) == int(pf) == want:
        bad.append("counting_flops")
    out["ActivatePlugins"] = f"{len(clog)} calls on the card, {len(plog)} on the CPU"
    if clog != plog or not clog:
        bad.append("ActivatePlugins")

    launches = dict(kernels.LAUNCHES)
    for what, v in out.items():
        log(f"recipes, card vs CPU: {what}: {v}")
    if bad:
        raise AssertionError(f"recipes: card and CPU disagree on {bad}")
    return launches, out


# ---------------------------------------------------------------------------
# phase 8: QAT, the model API and the benchmarking examples
# ---------------------------------------------------------------------------

QAT_BATCH = (8, 128)  # ids from numpy's default_rng(0)
QAT_STEPS = 8
QAT_LR = 1e-3  # Adam at optax's defaults (eps 1e-8), as tests/test_qat.py
QAT_CPU_LAYERS, QAT_CPU_STEPS = 2, 2
QAT_CPU_ROWS = 2  # the CPU check's first rows of QAT_BATCH
# card vs CPU at QAT_CPU_LAYERS over QAT_CPU_STEPS (TF32 off): each step's
# loss within QAT_CURVE_TOL (twice the port-vs-JAX spread of the CPU tests'
# 12-step curve, tests/test_torch_qat.py; the card's spread 7.5e-4); the
# first step's q_proj gradients within QAT_GRAD_RTOL of their largest
# |entry|: twice the card's spread, 8.9e-3 (a BFP cast that lands one step
# apart moves the gradients behind it)
QAT_CURVE_TOL = 0.02
QAT_GRAD_RTOL = 0.02
MODEL_API_BATCH = 16  # LeNet-5's images
MONITOR_IDS = (2, 128)  # OPT-125m BASIC at QAT_CPU_LAYERS under Monitoring
# LeNet-5's T2 launches a forward: thawed from the example yaml, FLOAT16 on
# the convs', the linears' and the pools' outputs, every BFP cast off the
# block (plain torch); under the BASIC rules unpacked, 17 (lenet_basic's)
LENET_THAW_T2, LENET_BASIC_T2 = 7, 17


def qat_t2_launches(cfg, seq: int = 128):
    """T2 launches of one forward of OPT through the modular BASIC path
    (unpacked Linears, ``DmxModule.inference_mode`` false: QAT's forward and
    an ``EVALUATION_MODE.BASIC`` one): 44L+7 with every axis on the BFP
    block (each Linear's input, weight and output casts among them), 42L+7
    where the sequence is off the block (the attention's two BFP casts
    along the keys plain torch); counted by spies on the CPU.  A backward
    launches none."""
    return (44 if seq % 64 == 0 else 42) * cfg.num_hidden_layers + 7


def bench_launches(family, cfg):
    """The kernel launches of one runner call of a benchmarking example in
    each EVALUATION_MODE, by spies on the CPU: OPT ids [4, 32] (FP8 the fp8
    path's 28L+5); CLIP a ``__call__`` over 8 pairs, 81L+15 T2 in BASIC at
    L layers a tower; Whisper a forward of 4 decoder ids over the encoder,
    107L+13 T2 in BASIC, L B3 otherwise (the decoder's transparent SDPA)."""
    if family == "opt":
        L = cfg.num_hidden_layers
        basic = {"bfp_cast": qat_t2_launches(cfg, 32)}
        return {"Vanilla": {}, "Baseline": {}, "FP8": {"bfp_cast": 28 * L + 5},
                "Basic": basic, "Basic_NoVSIMD": basic}
    if family == "clip":
        basic = {"bfp_cast": 81 * cfg.vision.num_hidden_layers + 15}
        return {"Vanilla": {}, "Baseline": {}, "Basic": basic, "Basic_NoVSIMD": basic}
    L = cfg.decoder_layers
    basic = {"bfp_cast": 107 * L + 13}
    return {"Vanilla": {"flash_attention": L}, "Baseline": {"flash_attention": L},
            "Basic": basic, "Basic_NoVSIMD": basic}


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def qat_train(torch, kernels, model, ids, steps, card, record_grads=False):
    """``steps`` Adam steps of QAT through the modular BASIC forward of
    ``model`` (a raw OPT, substituted in place); an eager forward first, as
    tests/test_qat.py.  Returns (the DmxModel, the optimizer, each step's
    (loss, forward launches, backward launches, wall ms), the first step's
    q_proj gradients when ``record_grads``)."""
    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.models import loss_fn

    dm = DmxModel.from_raw(model).to_basic_mode()
    with torch.no_grad():
        dm(ids)
    opt = torch.optim.Adam(model.parameters(), lr=QAT_LR, eps=1e-8)
    sync = torch.cuda.synchronize if card else (lambda: None)
    steps_out, grads = [], {}
    for s in range(steps):
        sync()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        kernels.reset_launches()
        loss = loss_fn(dm(ids), ids)
        fwd = nonzero(kernels.LAUNCHES)
        kernels.reset_launches()
        loss.backward()
        sync()
        bwd = nonzero(kernels.LAUNCHES)
        if record_grads and s == 0:
            grads = {n: p.grad.detach().float().cpu().clone()
                     for n, p in model.named_parameters() if "q_proj" in n}
        opt.step()
        value = loss.item()
        sync()
        steps_out.append((value, fwd, bwd, (time.perf_counter() - t0) * 1e3))
    return dm, opt, steps_out, grads


def qat_basic_path(torch, dev, kernels, cfg):
    """QAT of OPT-125m at full width and depth: QAT_STEPS Adam steps over
    ids QAT_BATCH through the modular BASIC forward on the card, every
    step's forward launching exactly qat_t2_launches(cfg) T2 (each BFP16_64
    and FLOAT16 cast under the STE; the matmuls torch.matmul) and its
    backward none; the loss must fall.  Prints each step's loss and wall ms,
    a profiled step's device ms and idle share, the peak memory.  Then the
    same at QAT_CPU_LAYERS layers on the card and on the CPU from the same
    weights, QAT_CPU_STEPS steps, TF32 off: the first step's loss, its
    q_proj gradients and the loss curve held.  Returns (the launches of the
    QAT_STEPS steps, the path's numbers)."""
    import copy
    import dataclasses

    import numpy as np

    from dmx_compressor_tpu_torch.models import loss_fn
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.nn.core import DmxModule

    ids_np = np.random.default_rng(0).integers(0, cfg.vocab_size, QAT_BATCH)
    ids = torch.as_tensor(ids_np, dtype=torch.long)
    want_fwd = {"bfp_cast": qat_t2_launches(cfg)}
    prev_mode, DmxModule.inference_mode = DmxModule.inference_mode, False
    try:
        model = OPTForCausalLM(cfg, device=dev, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dm, opt, steps, _ = qat_train(torch, kernels, model, ids.to(dev), QAT_STEPS, True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        total = {}
        for i, (loss, fwd, bwd, ms) in enumerate(steps):
            log(f"qat_basic step {i}: loss {loss:.6f}, wall {ms:.3f} ms, launches forward {fwd} "
                f"(expected {want_fwd}), backward {bwd} (expected none)")
            if fwd != want_fwd or bwd:
                raise AssertionError("qat_basic: a step did not launch the kernels the expected "
                                     "number of times")
            for k, v in fwd.items():
                total[k] = total.get(k, 0) + v
        losses = [st[0] for st in steps]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"qat_basic: the loss did not fall: {losses}")

        def one_step():
            opt.zero_grad(set_to_none=True)
            loss_fn(dm(ids.to(dev)), ids.to(dev)).backward()
            opt.step()

        events = device_events(torch, one_step)
        busy = sum(us for _, us in events) / 1e3
        wall = float(np.median([st[3] for st in steps[1:]]))
        log(f"qat_basic: {QAT_STEPS} steps at batch {QAT_BATCH}, L = {cfg.num_hidden_layers}: wall "
            f"{wall:.3f} ms a step (median of steps 1-{QAT_STEPS - 1}), device {busy:.3f} ms a "
            f"step (a profiled step), idle share {1 - busy / wall:.3f}, peak device memory "
            f"{peak:.2f} GiB")
        for ev, us in sorted(events, key=lambda e: -e[1])[:5]:
            log(f"  device, a QAT step: {us / 1e3:.4f} ms  {ev[:110]}")
        del dm, opt, model

        cut = dataclasses.replace(cfg, num_hidden_layers=QAT_CPU_LAYERS)
        card_model = OPTForCausalLM(cut, device=dev, seed=0)
        cpu_model = copy.deepcopy(card_model).to("cpu")
        log(f"qat_basic card vs CPU at {QAT_CPU_LAYERS} layers: TF32 matmul "
            f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 {torch.backends.cudnn.allow_tf32}")
        rows = ids[:QAT_CPU_ROWS]
        _, _, card_steps, card_g = qat_train(torch, kernels, card_model, rows.to(dev),
                                             QAT_CPU_STEPS, True, record_grads=True)
        _, _, cpu_steps, cpu_g = qat_train(torch, kernels, cpu_model, rows, QAT_CPU_STEPS,
                                           False, record_grads=True)
        want_cut = {"bfp_cast": qat_t2_launches(cut)}
        if any(st[1] != want_cut or st[2] for st in card_steps):
            raise AssertionError("qat_basic's card run at the CPU check's depth did not launch "
                                 "the kernels the expected number of times")
        curve = [abs(a[0] - b[0]) for a, b in zip(card_steps, cpu_steps)]
        grad_abs = max(float((card_g[n] - cpu_g[n]).abs().max()) for n in cpu_g)
        grad_err = max(float((card_g[n] - cpu_g[n]).abs().max() / cpu_g[n].abs().max())
                       for n in cpu_g)
        log(f"qat_basic card vs CPU at {QAT_CPU_LAYERS} layers: first loss {card_steps[0][0]:.7f} "
            f"/ {cpu_steps[0][0]:.7f}; the loss curve {[round(st[0], 6) for st in card_steps]} / "
            f"{[round(st[0], 6) for st in cpu_steps]}, max |diff| {max(curve):.3g} (tolerance "
            f"{QAT_CURVE_TOL}); q_proj gradients max |diff| {grad_abs:.3g}, over max |g| "
            f"{grad_err:.3g} (tolerance {QAT_GRAD_RTOL})")
        if not (max(curve) <= QAT_CURVE_TOL and grad_err <= QAT_GRAD_RTOL):
            raise AssertionError("qat_basic: the card's training disagrees with the CPU's")
    finally:
        DmxModule.inference_mode = prev_mode
    return total, dict(losses=losses, wall_ms=wall, device_ms=busy, idle=1 - busy / wall,
                       peak_gib=peak, t2_per_step=want_fwd["bfp_cast"],
                       cpu_curve_err=max(curve), cpu_grad_abs_err=grad_abs,
                       cpu_grad_rel_err=grad_err)


def compiled_check(_, dev_type, out_path):
    """model_api's ``compiled()`` check: LeNet-5 in BASIC from seed 0 over
    MODEL_API_BATCH images, its eager forward, then two calls of
    ``compiled()`` (torch.compile: Inductor), each call's T2 launches, the
    outputs, the first call's seconds and the cast's mark after the
    compiled forward, saved to ``out_path``.  The script runs it in a
    process of its own (:func:`start_compiled_check`), beside the serving
    paths: Inductor's compile takes 35-70 s of host time."""
    import numpy as np
    import torch

    from dmx_compressor_tpu_torch import kernels
    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.models.lenet import LeNet5
    from dmx_compressor_tpu_torch.nn.core import DmxModule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_type)
    prev_mode, DmxModule.inference_mode = DmxModule.inference_mode, False
    try:
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (MODEL_API_BATCH, 1, 28, 28), np.float32)).to(dev)
        dmb = DmxModel.from_raw(LeNet5(device=dev, seed=0)).to_basic_mode()
        res = {}

        def counted(fn, what):
            kernels.reset_launches()
            with torch.no_grad():
                y = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            res[what] = (y.cpu(), nonzero(kernels.LAUNCHES))

        counted(lambda: dmb(x), "eager")
        cast = dmb.get_submodule("fc1").input_casts["input_cast"]
        cast.physical_dtype = torch.float16  # a mark no compiled forward may overwrite
        fn = dmb.compiled()
        t0 = time.perf_counter()
        counted(lambda: fn(x), "first")
        res["compile_s"] = time.perf_counter() - t0
        counted(lambda: fn(x), "again")
        res["mark"] = cast.physical_dtype
        torch.save(res, out_path)
    finally:
        DmxModule.inference_mode = prev_mode


def start_compiled_check(dev):
    """Spawns :func:`compiled_check` on ``dev``; returns (its context, the
    results' path, their directory)."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "compiled.pt")
    ctx = mp.start_processes(compiled_check, args=(dev.type, path), nprocs=1, join=False,
                             start_method="spawn")
    atexit.register(kill_world, ctx)  # a run that fails before model_api ends it
    return ctx, path, tmp


COMPILED_TIMEOUT = 600  # seconds model_api waits for the compiled() process


def model_api_phase(torch, dev, kernels, cfg, compiled):
    """The model-level API on the card: configs/dmx_example_config_lenet5.yaml
    thawed onto LeNet-5 (logits against the model moved to the CPU), freeze
    and thaw round trips (the same bytes, the same outputs bit for bit),
    ``compiled()`` of LeNet-5 in BASIC (:func:`compiled_check` in the
    process ``compiled`` from :func:`start_compiled_check`; T2 launches
    inside the compiled forward as in eager, the output eager's, no
    diagnostic state written), then ``monitoring`` and
    ``measure_runtimes`` over OPT-125m in BASIC at QAT_CPU_LAYERS layers.
    Returns the launches of the counted runs."""
    import copy
    import dataclasses
    from pathlib import Path

    import numpy as np

    from dmx_compressor_tpu_torch.modeling.model import DmxConfig, DmxModel
    from dmx_compressor_tpu_torch.models.lenet import LeNet5
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.nn.core import DmxModule

    root = Path(__file__).resolve().parent
    out = root / "build" / "model_api"
    out.mkdir(parents=True, exist_ok=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (MODEL_API_BATCH, 1, 28, 28), np.float32))
    x_d = x.to(dev)
    total = {}

    def counted(fn, want, what):
        kernels.reset_launches()
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        got = nonzero(kernels.LAUNCHES)
        log(f"model_api: {what}: launches {got} (expected {want})")
        if got != want:
            raise AssertionError(f"model_api: {what} did not launch the kernels the expected "
                                 f"number of times")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return y

    prev_mode, DmxModule.inference_mode = DmxModule.inference_mode, False
    try:
        dm = DmxModel.from_raw(LeNet5(device=dev, seed=0))
        dm.thaw(str(root / "configs" / "dmx_example_config_lenet5.yaml"))
        got = counted(lambda: dm(x_d), {"bfp_cast": LENET_THAW_T2}, "the thawed LeNet-5").cpu()
        cpu_model = copy.deepcopy(dm.module).to("cpu")
        with torch.no_grad():
            want = cpu_model(x)
        err = (got - want).abs().max().item()
        log(f"model_api: the thawed LeNet-5's logits GPU vs CPU: max_abs_err={err:.3g} "
            f"(tolerance {LENET_BASIC_TOL})")
        if not err <= LENET_BASIC_TOL:
            raise AssertionError("model_api: the thawed LeNet-5 disagrees with the CPU run")

        for what, build in (("thawed", None), ("BASIC", "basic")):
            src = dm if build is None else DmxModel.from_raw(LeNet5(device=dev, seed=0))
            if build:
                src.to_basic_mode()
            f1, f2 = out / f"{build or 'thawed'}_1.yaml", out / f"{build or 'thawed'}_2.yaml"
            src.freeze(str(f1))
            dst = DmxModel.from_raw(LeNet5(device=dev, seed=0)).thaw(str(f1))
            dst.freeze(str(f2))
            with torch.no_grad():
                same = torch.equal(dst(x_d), src(x_d))
            log(f"model_api: freeze and thaw of the {what} LeNet-5: {len(DmxConfig.from_yaml(str(f1)))} "
                f"module configs, the refrozen file the same bytes {f1.read_bytes() == f2.read_bytes()}, "
                f"outputs equal bit for bit {same}")
            if not (same and f1.read_bytes() == f2.read_bytes()):
                raise AssertionError(f"model_api: the {what} LeNet-5's freeze / thaw round trip "
                                     f"changed it")

        ctx, path, _ = compiled
        join_world(ctx, time.monotonic() + COMPILED_TIMEOUT, "model_api's compiled() process")
        res = torch.load(path, weights_only=False)
        want_t2 = {"bfp_cast": LENET_BASIC_T2}
        for what, label in (("eager", "eager"), ("first", "compiled (first call)"),
                            ("again", "compiled (second call)")):
            got = res[what][1]
            log(f"model_api: LeNet-5 in BASIC, {label}: launches {got} (expected {want_t2})")
            if got != want_t2:
                raise AssertionError(f"model_api: LeNet-5 in BASIC, {label} did not launch the "
                                     f"kernels the expected number of times")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        (eager, _), (first, _), (again, _) = res["eager"], res["first"], res["again"]
        err = max((first - eager).abs().max().item(), (again - eager).abs().max().item())
        log(f"model_api: compiled() of LeNet-5 in BASIC: first call {res['compile_s']:.1f} s with "
            f"the compile; output vs eager max_abs_err={err:.3g} (expected 0); physical_dtype "
            f"after the compiled forward {res['mark']} (its mark float16)")
        if not (torch.equal(first, eager) and torch.equal(again, eager)):
            raise AssertionError("model_api: the compiled forward is not eager's")
        if res["mark"] != torch.float16:
            raise AssertionError("model_api: the compiled forward wrote diagnostic state")

        cut = dataclasses.replace(cfg, num_hidden_layers=QAT_CPU_LAYERS)
        dmo = DmxModel.from_raw(OPTForCausalLM(cut, device=dev, seed=0)).to_basic_mode()
        ids = torch.as_tensor(np.random.default_rng(1).integers(0, cut.vocab_size, MONITOR_IDS),
                              dtype=torch.long, device=dev)
        names = list(dmo.dmx_module_dict)
        want_opt = {"bfp_cast": qat_t2_launches(cut)}
        with dmo.monitoring() as mon:
            counted(lambda: dmo(ids), want_opt, "OPT-125m in BASIC under monitoring")
        with dmo.measure_runtimes() as rt:
            counted(lambda: dmo(ids), want_opt, "OPT-125m in BASIC under measure_runtimes")
        runtimes = rt.get_records()
        calls = {n: len(r.inputs) for n, r in mon.records.items()}
        # a call a module; each SDPA calls its resadd and its actmatmul twice
        want_calls = {n: 2 if n.endswith(("sdpa.resadd", "sdpa.actmatmul")) else 1
                      for n in names}
        ok = (calls == want_calls and {n: len(t) for n, t in runtimes.items()} == want_calls
              and all(len(r.outputs) == calls[n] for n, r in mon.records.items())
              and all(t > 0 for ts in runtimes.values() for t in ts))
        top = sorted(((sum(t), n) for n, t in runtimes.items()), reverse=True)[:5]
        log(f"model_api: monitoring / measure_runtimes over {len(names)} modules of OPT-125m in "
            f"BASIC at {QAT_CPU_LAYERS} layers, ids {MONITOR_IDS}: {sum(calls.values())} calls "
            f"recorded, each module's as expected {ok}; module time (CUDA events, nested modules "
            f"counted in their parents too) " + ", ".join(f"{n} {s * 1e3:.4f} ms" for s, n in top))
        if not ok:
            raise AssertionError("model_api: monitoring did not record each module's calls")
    finally:
        DmxModule.inference_mode = prev_mode
    return total


def benchmarking_phase(torch, dev, kernels, cfg):
    """The three benchmarking examples on the card, each as a user runs it
    (its tables printed), the launches over its whole run; then one runner
    call a mode, each mode's launches held against ``bench_launches``:
    benchmark_opt at OPT-125m (the five modes, ids [4, 32]), benchmark_clip
    at CLIP ViT-B/32 over CLIP_BENCH_PAIRS of its corpus, benchmark_whisper at
    whisper-small cut to WHISPER_LAYERS a stack.  Returns the launches by
    example and the per-mode launches."""
    from dmx_compressor_tpu_torch.examples.benchmarking import (
        benchmark_clip,
        benchmark_opt,
        benchmark_whisper,
    )
    from dmx_compressor_tpu_torch.models.clip import CLIPConfig
    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.nn.core import DmxModule
    from dmx_compressor_tpu_torch.utils.benchmark import (
        EVALUATION_MODE,
        configure_mode,
        prepare_model,
    )

    wcfg = benchmark_whisper.config(True, WHISPER_LAYERS)
    runs = {
        "opt": (["--full"], cfg),
        "clip": (["--full"], CLIPConfig.vit_b_32()),
        "whisper": (["--full", "--layers", str(WHISPER_LAYERS)], wcfg),
    }
    mains = {"opt": benchmark_opt, "clip": benchmark_clip, "whisper": benchmark_whisper}
    by_path, per_mode = {}, {}
    prev_mode, DmxModule.inference_mode = DmxModule.inference_mode, False
    prev_pairs, benchmark_clip.N_PAIRS = benchmark_clip.N_PAIRS, CLIP_BENCH_PAIRS
    try:
        for family, (argv, fcfg) in runs.items():
            name = f"benchmark_{family}"
            kernels.reset_launches()
            t0 = time.perf_counter()
            mains[family].main(argv + ["--device", str(dev)])
            torch.cuda.synchronize()
            by_path[name] = nonzero(kernels.LAUNCHES)
            log(f"{name}: the example's run took {time.perf_counter() - t0:.1f} s, launches "
                f"{by_path[name]}")
            got = {}
            if family == "opt":
                model, x = benchmark_opt.build(True, dev)
                dm = None
                for mode in EVALUATION_MODE:
                    if mode != EVALUATION_MODE.VANILLA:
                        dm = dm or DmxModel.from_raw(model)  # in place, after Vanilla's run
                        configure_mode(dm, mode)
                    kernels.reset_launches()
                    with torch.no_grad():
                        (dm or model)(x)
                    torch.cuda.synchronize()
                    got[mode.value] = nonzero(kernels.LAUNCHES)
            else:
                maker = (benchmark_clip.make_model_maker(True, dev) if family == "clip"
                         else benchmark_whisper.make_model_maker(wcfg, dev))
                for mode in mains[family].MODES:
                    model, runner, _ = maker()
                    model, _ = prepare_model(model, mode, runner)
                    kernels.reset_launches()
                    runner(model)
                    torch.cuda.synchronize()
                    got[mode.value] = nonzero(kernels.LAUNCHES)
                    del model
            want = bench_launches(family, fcfg)
            log(f"{name}: launches of one runner call by mode {got} (expected {want})")
            if got != want:
                raise AssertionError(f"{name}: a mode did not launch the kernels the expected "
                                     f"number of times")
            per_mode[name] = got
            if family == "opt":
                # each mode: its output forward, 2 warm-up and 3 timed runs
                want_run = {}
                for counts in got.values():
                    for k, v in counts.items():
                        want_run[k] = want_run.get(k, 0) + 6 * v
                if by_path[name] != want_run:
                    raise AssertionError(f"{name}: the example's run launched {by_path[name]}, "
                                         f"expected {want_run}")
    finally:
        DmxModule.inference_mode = prev_mode
        benchmark_clip.N_PAIRS = prev_pairs
    return by_path, per_mode


# ---------------------------------------------------------------------------
# phase 9: Hugging Face checkpoints, the pipeline and training checkpoints
# ---------------------------------------------------------------------------

# the hf_head_dim80 path: OPT-2.7b's attention shape (hidden 2560 over 32
# heads: head_dim 80; ffn 10240, its vocabulary) cut to 2 layers, HD80_BATCH prompts
HD80 = dict(hidden_size=2560, ffn_dim=10240, num_attention_heads=32, num_hidden_layers=2,
            vocab_size=50272, max_position_embeddings=2048)
HD80_BATCH, HD80_STEPS = 1, 7
HF_CPU_LAYERS = 2  # the hf_pipeline's card-vs-CPU check: OPT-125m's width at 2 layers
HF_CPU_BATCH = 2  # ... over the first 2 prompts
HF_CPU_STEPS = 7  # the prefill's logits and 7 teacher-forced steps' held
# ... but 1 step for the BASIC build (on the CPU it BFP-casts every weight,
# the head's 50272 x 768 among them, at every forward)
HF_BASIC_CPU_STEPS = 1
# the BASIC build generates 8 tokens (its host-bound step is ~10x raw's),
# held against the directly built BASIC model's over the same 136-slot cache
HF_BASIC_HELD = 8
HF_SAMPLED = 16  # the sampled generations' new tokens
CKPT_STEPS = 4  # checkpoint_resume: 4 Adam steps, save, restore, 4 more
# numpy dtype -> the safetensors code
_ST_CODES = {"float64": "F64", "float32": "F32", "float16": "F16", "int64": "I64",
             "int32": "I32", "int16": "I16", "int8": "I8", "uint8": "U8", "bool": "BOOL"}


def write_safetensors(tensors, fname):
    """A ``.safetensors`` file of numpy arrays, as the ``safetensors``
    package writes it (the card's machine has no such package): the
    tensors laid out by descending element size, then name; an 8-byte
    little-endian header length; the compact JSON header (dtype, shape,
    data_offsets) padded with spaces to a multiple of 8; the raw
    little-endian buffer."""
    import numpy as np

    order = sorted(tensors, key=lambda k: (-np.asarray(tensors[k]).dtype.itemsize, k))
    header, blobs, off = {}, [], 0
    for k in order:
        a = np.asarray(tensors[k])
        raw = a.astype(a.dtype.newbyteorder("<")).tobytes(order="C")
        header[k] = {"dtype": _ST_CODES[a.dtype.name], "shape": list(a.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(fname, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def opt_hf_config(**fields):
    """An OPT ``config.json`` (OPT-125m's fields unless given)."""
    cfg = dict(model_type="opt", vocab_size=50272, hidden_size=768, ffn_dim=3072,
               num_hidden_layers=12, num_attention_heads=12, max_position_embeddings=2048,
               do_layer_norm_before=True)
    cfg.update(fields)
    return cfg


def opt_hf_tensors(cfg, seed=0):
    """OPT's tensors in HF names (``model.decoder.*``; the head tied to the
    token table), from numpy's ``default_rng(seed)``: weights normal(0,
    0.02), biases normal(0, 0.02), LayerNorm scales 1 + normal(0, 0.02)."""
    import numpy as np

    rs = np.random.default_rng(seed)
    d, f, V = cfg["hidden_size"], cfg["ffn_dim"], cfg["vocab_size"]

    def w(*shape):
        return (rs.standard_normal(shape, dtype=np.float32) * np.float32(0.02))

    t = {"model.decoder.embed_tokens.weight": w(V, d),
         "model.decoder.embed_positions.weight": w(cfg["max_position_embeddings"] + 2, d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.decoder.layers.{i}"
        for name, (n, k) in {"self_attn.q_proj": (d, d), "self_attn.k_proj": (d, d),
                             "self_attn.v_proj": (d, d), "self_attn.out_proj": (d, d),
                             "fc1": (f, d), "fc2": (d, f)}.items():
            t[f"{p}.{name}.weight"], t[f"{p}.{name}.bias"] = w(n, k), w(n)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            t[f"{p}.{name}.weight"], t[f"{p}.{name}.bias"] = 1 + w(d), w(d)
    t["model.decoder.final_layer_norm.weight"] = 1 + w(d)
    t["model.decoder.final_layer_norm.bias"] = w(d)
    return t


def write_opt_checkpoint(torch, root, cfg, tensors, kinds=("safetensors", "bin")):
    """``root/safetensors`` (``model.safetensors`` by :func:`write_safetensors`)
    and ``root/bin`` (``pytorch_model.bin`` by ``torch.save``), each with the
    ``config.json`` (of ``kinds``); returns the directories by kind."""
    import os

    dirs = {}
    for kind in kinds:
        d = dirs[kind] = os.path.join(root, kind)
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f)
    if "safetensors" in dirs:
        write_safetensors(tensors, os.path.join(dirs["safetensors"], "model.safetensors"))
    if "bin" in dirs:
        torch.save({k: torch.from_numpy(v) for k, v in tensors.items()},
                   os.path.join(dirs["bin"], "pytorch_model.bin"))
    return dirs


def direct_opt(torch, cfg_json, tensors, dev):
    """The same OPT built directly (``OPTForCausalLM``) on ``dev`` with the
    checkpoint's tensors copied into its parameters by name."""
    from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM

    fields = {k: v for k, v in cfg_json.items() if k != "model_type"}
    model = OPTForCausalLM(OPTConfig(**fields), device=dev, seed=0)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in tensors.items():
            own[k].copy_(torch.from_numpy(v))
    if set(own) - set(tensors):
        raise AssertionError(f"parameters not in the checkpoint: {set(own) - set(tensors)}")
    return model


def hf_builds():
    """The hf_pipeline's four builds: (name, the pipeline's dmx_config, the
    direct model's build, generate's quantized_cache, or None for the
    weights build, served by greedy_prefill / greedy_decode)."""
    from dmx_compressor_tpu_torch import config_rules
    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode

    return [("raw", None, lambda m: DmxModel.from_raw(m), False),
            ("int8_cache", None, lambda m: DmxModel.from_raw(m), True),
            ("basic", "BASIC", lambda m: DmxModel.from_raw(m).configure(None, *config_rules.BASIC),
             False),
            ("weights", None, build_weights_mode, None)]


def hf_basic_t2(cfg, prompt, new_tokens):
    """T2 launches of the pipeline's BASIC generation (``DmxModel.configure``
    with the BASIC rules: the modular forward, the Linears unpacked, an f32
    static cache of prompt + new_tokens slots): each of its ``new_tokens``
    forwards (the prefill and the steps) 42L+7, 2L more where the cache's
    slots, which every forward attends over (masked), are a multiple of the
    BFP block (the attention's two BFP casts along the keys)."""
    L, slots = cfg["num_hidden_layers"], prompt + new_tokens
    return new_tokens * (42 * L + 7 + (2 * L if slots % 64 == 0 else 0))


def hf_launches(name, cfg, prompt, new_tokens):
    """The exact launches of one generation of each hf_pipeline build,
    written from the code before the first chip run: raw prefill L B3,
    each step L B4; int8_cache L B3 and L B2; basic hf_basic_t2; weights
    4L+1 B1 a prefill and a step, L B3, L B2 a step."""
    L, steps = cfg["num_hidden_layers"], new_tokens - 1
    if name == "raw":
        return {"flash_attention": L, "flash_decode": L * steps}
    if name == "int8_cache":
        return {"flash_attention": L, "flash_decode_int8": L * steps}
    if name == "basic":
        return {"bfp_cast": hf_basic_t2(cfg, prompt, new_tokens)}
    return {"bfp_linear": (4 * L + 1) * new_tokens, "flash_attention": L,
            "flash_decode_int8": L * steps}


def hf_generate(torch, kernels, build, target, ids, new_tokens, card):
    """Greedy generation of ``new_tokens`` tokens by ``target``: a Pipeline
    (``generate``), or a model (the weights build: greedy_prefill /
    greedy_decode over an int8 cache); counted and timed.  Returns (the
    tokens [B, new_tokens] on the CPU, the launches, wall ms a step)."""
    from dmx_compressor_tpu_torch.models.shared import greedy_decode, greedy_prefill

    _, _, _, quantized = build
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    if quantized is None:
        dev = next(target.parameters()).device
        caches = target.init_cache(ids.shape[0], ids.shape[1] + new_tokens, quantized=True,
                                   device=dev)
        _, tok = greedy_prefill(target, caches, ids)
        toks, _ = greedy_decode(target, caches, tok, ids.shape[1], new_tokens - 1)
        out = torch.cat([tok[:, None], toks], dim=1)
    else:
        out = target.generate(ids, max_new_tokens=new_tokens, quantized_cache=quantized)
        out = out[:, ids.shape[1]:]
    sync()
    wall = (time.perf_counter() - t0) * 1e3 / new_tokens
    return out.cpu(), nonzero(kernels.LAUNCHES), wall


def held_greedy(torch, model, ids, slots, n):
    """The first ``n`` greedy tokens of ``model`` over ``ids`` in an f32 cache
    of ``slots`` slots (``Pipeline.generate``'s loop: greedy_prefill, then
    greedy_decode), [B, n] on the CPU."""
    from dmx_compressor_tpu_torch.models.shared import greedy_decode, greedy_prefill

    caches = model.init_cache(ids.shape[0], slots, device=ids.device)
    _, tok = greedy_prefill(model, caches, ids)
    toks, _ = greedy_decode(model, caches, tok, ids.shape[1], n - 1)
    return torch.cat([tok[:, None], toks], dim=1).cpu()


def teacher_forced(torch, model, ids, tokens, quantized, steps):
    """The prefill's last logits and ``steps`` decode steps' logits of
    ``model`` over ``ids`` then ``tokens`` (the card's), [steps + 1, B, V]
    on the CPU."""
    dev = next(model.parameters()).device
    T = ids.shape[1]
    caches = model.init_cache(ids.shape[0], T + steps + 1, quantized=quantized, device=dev)
    rows = []
    with torch.no_grad():
        rows.append(model(ids.to(dev), caches=caches, position_offset=0)[:, -1].float().cpu())
        for i in range(steps):
            tok = tokens[:, i:i + 1].to(device=dev, dtype=torch.int32)
            rows.append(model(tok, caches=caches, position_offset=T + i)[:, -1].float().cpu())
    return torch.stack(rows)


def hf_pipeline_path(torch, dev, kernels):
    """The slice's path at full width: OPT-125m's seed-0 tensors in HF names
    written as ``model.safetensors`` (this script's writer) and as
    ``pytorch_model.bin`` (``torch.save``), each loaded through
    ``pipeline("text-generation", dir)`` on the card: every parameter its
    tensor bit for bit, no key unmatched.  Four builds generate GEN tokens
    from a batch of BATCH prompts of PROMPT ids, counted, their tokens
    equal bit for bit to the same build of the model built directly with the
    same weights (``direct_opt``); then at HF_CPU_LAYERS layers each build's
    logits card against CPU, teacher-forced (raw LOGIT_TOL, int8 KV8_TOL,
    weights KV8_TOL, basic BASIC_LOGIT_TOL); then top-5 sampling twice with
    one seed.  Returns (the counted launches, the path's numbers)."""
    import tempfile

    import numpy as np

    from dmx_compressor_tpu_torch.modeling.hf import model_from_checkpoint, pipeline
    from dmx_compressor_tpu_torch.nn.core import DmxModule

    cfg = opt_hf_config()
    tensors = opt_hf_tensors(cfg, seed=0)
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, cfg["vocab_size"],
                                                            (BATCH, PROMPT)), dtype=torch.int32)
    total, numbers = {}, {}
    prev_mode = DmxModule.inference_mode
    try:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            dirs = write_opt_checkpoint(torch, root, cfg, tensors)
            log(f"hf_pipeline: OPT-125m's {len(tensors)} tensors written as safetensors and bin "
                f"in {time.perf_counter() - t0:.2f} s")
            pipes = {}
            for kind, d in dirs.items():
                t0 = time.perf_counter()
                pipe = pipeline("text-generation", d)
                where = next(pipe.raw_model.parameters()).device
                sd = pipe.model.module.state_dict()
                same = sum(torch.equal(sd[k].cpu(), torch.from_numpy(v))
                           for k, v in tensors.items())
                log(f"hf_pipeline: {kind} loaded in {time.perf_counter() - t0:.2f} s on "
                    f"{where}: {same} of {len(tensors)} tensors bit for bit, unmatched "
                    f"keys {pipe.missed_keys}")
                if where.type != torch.device(dev).type or pipe.missed_keys or same != len(
                        tensors):
                    raise AssertionError(f"hf_pipeline: the {kind} checkpoint did not load "
                                         f"whole onto the card")
                pipes[kind] = pipe
            gen = {}
            for build in hf_builds():
                name, dmx_config, direct_build, _ = build
                if name == "weights":
                    target, _ = model_from_checkpoint(dirs["safetensors"])
                    direct_build(target)
                elif name == "basic":
                    DmxModule.inference_mode = False
                    target = pipeline("text-generation", dirs["safetensors"],
                                      dmx_config=dmx_config)
                else:
                    target = pipes["safetensors"]
                # the BASIC build (~0.23 s a step) generates the tokens it holds
                new = HF_BASIC_HELD if name == "basic" else GEN
                got, launched, wall = hf_generate(torch, kernels, build, target, ids.to(dev),
                                                  new, True)
                want = hf_launches(name, cfg, PROMPT, new)
                log(f"hf_pipeline {name}: {new} tokens, {wall:.3f} ms a step wall (host clock, "
                    f"the prefill's share included), launches {launched} (expected {want})")
                if launched != want:
                    raise AssertionError(f"hf_pipeline {name}: the generation did not launch "
                                         f"the kernels the expected number of times")
                for k, v in launched.items():
                    total[k] = total.get(k, 0) + v
                if name == "raw":
                    other, _, _ = hf_generate(torch, kernels, build, pipes["bin"], ids.to(dev),
                                              GEN, True)
                    if not torch.equal(other, got):
                        raise AssertionError("hf_pipeline: the bin and safetensors "
                                             "checkpoints generate different tokens")
                direct = direct_opt(torch, cfg, tensors, dev)
                built = direct_build(direct)
                if name == "basic":
                    held = new
                    ref = held_greedy(torch, built.module, ids.to(dev), PROMPT + new, held)
                else:
                    held = GEN
                    dtarget = direct if name == "weights" else _DirectPipe(built.module)
                    ref, _, _ = hf_generate(torch, kernels, build, dtarget, ids.to(dev), GEN, True)
                if not torch.equal(got[:, :held], ref):
                    raise AssertionError(f"hf_pipeline {name}: the loaded model's tokens differ "
                                         f"from the directly built model's")
                gen[name] = dict(wall_ms_per_step=wall, launches=launched)
                log(f"hf_pipeline {name}: the first {held} tokens equal the directly built "
                    f"model's bit for bit")
                del target, direct, built
                DmxModule.inference_mode = prev_mode
                torch.cuda.empty_cache()
            numbers["generate"] = gen

            # sampling: top-5 at temperature 1, twice with one seed
            pipe = pipes["safetensors"]
            s1 = pipe.generate(ids.to(dev), max_new_tokens=HF_SAMPLED, temperature=1.0,
                               top_k=5, seed=7)
            s2 = pipe.generate(ids.to(dev), max_new_tokens=HF_SAMPLED, temperature=1.0,
                               top_k=5, seed=7)
            with torch.no_grad():
                logits = pipe.raw_model(s1.long())[:, PROMPT - 1:-1]
            top5 = torch.topk(logits, 5, dim=-1).indices
            inside = bool((top5 == s1[:, PROMPT:, None].long()).any(-1).all())
            log(f"hf_pipeline sampling: top_k 5, seed 7, {HF_SAMPLED} tokens: the same tokens "
                f"on a second call {torch.equal(s1, s2)}, every token among its step's 5 "
                f"largest logits {inside}")
            if not (torch.equal(s1, s2) and inside):
                raise AssertionError("hf_pipeline: top-k sampling did not reproduce or left "
                                     "the top k")
            del pipes, pipe
            torch.cuda.empty_cache()

        # card against CPU at HF_CPU_LAYERS layers, teacher-forced
        cut = opt_hf_config(num_hidden_layers=HF_CPU_LAYERS)
        cut_t = {k: v for k, v in tensors.items()
                 if not k.startswith("model.decoder.layers.")
                 or int(k.split(".")[3]) < HF_CPU_LAYERS}
        tol = {"raw": LOGIT_TOL, "int8_cache": KV8_TOL, "basic": BASIC_LOGIT_TOL,
               "weights": KV8_TOL}
        cpu_ids = ids[:HF_CPU_BATCH]
        errs = {}
        with tempfile.TemporaryDirectory() as root:
            d = write_opt_checkpoint(torch, root, cut, cut_t, ("safetensors",))["safetensors"]
            for build in hf_builds():
                name, dmx_config, direct_build, quantized = build
                steps = HF_BASIC_CPU_STEPS if name == "basic" else HF_CPU_STEPS
                rows = []
                for where in (dev, torch.device("cpu")):  # the card's tokens first
                    DmxModule.inference_mode = False
                    if name == "weights":
                        m, _ = model_from_checkpoint(d, device=where)
                        direct_build(m)
                    else:
                        m = pipeline("text-generation", d, dmx_config=dmx_config,
                                     device=where).raw_model
                    if not rows:
                        toks, _, _ = hf_generate(torch, kernels, build, m if name == "weights"
                                                 else _DirectPipe(m), cpu_ids.to(dev),
                                                 steps + 1, True)
                    rows.append(teacher_forced(torch, m, cpu_ids, toks, quantized is not False,
                                               steps))
                    del m
                errs[name] = float((rows[0] - rows[1]).abs().max())
                log(f"hf_pipeline {name} card vs CPU at {HF_CPU_LAYERS} layers, {HF_CPU_BATCH} "
                    f"rows: the prefill's and {steps} teacher-forced steps' logits max "
                    f"|diff| {errs[name]:.3g} (tolerance {tol[name]})")
                if not errs[name] <= tol[name]:
                    raise AssertionError(f"hf_pipeline {name}: the card disagrees with the CPU")
        numbers["cpu_max_abs_err"] = errs
    finally:
        DmxModule.inference_mode = prev_mode
    return total, numbers


class _DirectPipe:
    """``Pipeline.generate``'s loop over a model built directly (the same
    code, so the two differ only in how the weights arrived)."""

    def __init__(self, model):
        self.raw_model = model

    def generate(self, ids, **kw):
        from dmx_compressor_tpu_torch.modeling.hf import Pipeline

        return Pipeline.generate(self, ids, **kw)


def head_dim80_kernels(torch, dev):
    """B3, B2 and B4 at head_dim 80 beside 64 (and 128, the width the kernel
    runs 80 at) at the same B, H and S: OPT-2.7b's 32 heads, batch BATCH, a
    prefill of PROMPT, a decode step over CAPACITY slots at its mean fill;
    each against its plain version (the tolerances of phase 2), its time,
    its plain version's, SDPA's and its bound (bytes at the true D).  B3 at
    80 runs over q, k, v zero-padded to 128: the pad is timed apart; the
    decode kernels take D at run time, where padding the cache would copy it
    at every step (that copy timed too)."""
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from dmx_compressor_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_int8, flash_decode_int8_ref, flash_decode_ref)
    from dmx_compressor_tpu_torch.ops.kv_cache import QuantizedKVCache, QuantKV

    g = torch.Generator(device=dev).manual_seed(80)
    H, B, L = HD80["num_attention_heads"], BATCH, PROMPT
    S, fill = CAPACITY, PROMPT + GEN // 2
    le = torch.full((B,), fill, dtype=torch.int32, device=dev)
    cases = []
    for D in (80, 64, 128):
        # B3: the causal prefill
        per = 4 * B * H * D * 4 * L
        sets = [tuple(torch.randn(B, H, L, D, generator=g, device=dev) for _ in range(3))
                for _ in range(copies_for(per))]
        err = max_err(torch, flash_attention(*sets[0], causal=True),
                      flash_attention_ref(*sets[0], causal=True), B3_TOL, f"B3 D={D}")
        pairs = L * (L + 1) // 2
        bound_ms, by = bound(per, B3_PLANE_PRODUCTS * 4 * B * H * D * pairs, PEAK_BF16_FLOP_S)
        case = dict(kernel="flash_attention", shape=[B * H, L, L, D], max_abs_err=err,
                    ms=time_ms(torch, lambda q, k, v: flash_attention(q, k, v, causal=True),
                               sets),
                    plain_ms=time_plain(torch, lambda q, k, v: flash_attention_ref(q, k, v,
                                                                                   causal=True),
                                        sets),
                    library_ms=time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True), sets),
                    bound_ms=bound_ms, bound_by=by)
        if D == 80:
            case["pad_ms"] = time_ms(torch, lambda q, k, v: [F.pad(t, (0, 48)) for t in (q, k, v)],
                                     sets)
        cases.append(case)
        # B4 and B2: a decode step
        per = 2 * B * H * S * D * 4
        f_sets = [(torch.randn(B, H, 1, D, generator=g, device=dev),
                   torch.randn(B, H, S, D, generator=g, device=dev),
                   torch.randn(B, H, S, D, generator=g, device=dev), le)
                  for _ in range(copies_for(per))]
        err = max_err(torch, flash_decode(*f_sets[0]), flash_decode_ref(*f_sets[0]), B4_TOL,
                      f"B4 D={D}")
        mask = (torch.arange(S, device=dev)[None, :] < le[:, None])[:, None, None, :]
        bound_ms, by = bound(*b4_bytes_flops(B, H, H, D, [fill] * B))
        case = dict(kernel="flash_decode", shape=[B, H, H, S, D], lengths=fill, max_abs_err=err,
                    ms=time_ms(torch, flash_decode, f_sets),
                    plain_ms=time_plain(torch, flash_decode_ref, f_sets),
                    library_ms=time_ms(torch, lambda q, k, v, _: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask), f_sets),
                    bound_ms=bound_ms, bound_by=by)
        if D == 80:
            case["pad_cache_ms"] = time_ms(
                torch, lambda q, k, v, _: [F.pad(t, (0, 48)) for t in (k, v)], f_sets)
        cases.append(case)
        q_sets = []
        for _ in range(copies_for(B * H * S * (2 * D + 8))):
            kq, ks = QuantizedKVCache._quantize(torch.randn(B, H, S, D, generator=g, device=dev))
            vq, vs = QuantizedKVCache._quantize(torch.randn(B, H, S, D, generator=g, device=dev))
            q_sets.append((torch.randn(B, H, 1, D, generator=g, device=dev),
                           QuantKV(kq, vq, ks, vs), le))
        err = max_err(torch, flash_decode_int8(*q_sets[0]), flash_decode_int8_ref(*q_sets[0]),
                      B2_TOL, f"B2 D={D}")
        deq = [(q, kv.k_q.float() * kv.k_scale[..., None], kv.v_q.float() * kv.v_scale[..., None])
               for q, kv, _ in q_sets[:copies_for(per)]]
        bound_ms, by = bound(*b2_bytes_flops(B, H, H, D, [fill] * B))
        cases.append(dict(kernel="flash_decode_int8", shape=[B, H, H, S, D], lengths=fill,
                          max_abs_err=err, ms=time_ms(torch, flash_decode_int8, q_sets),
                          plain_ms=time_plain(torch, flash_decode_int8_ref, q_sets),
                          library_ms=time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                              q, k, v, attn_mask=mask), deq),
                          bound_ms=bound_ms, bound_by=by))
    for c in cases:
        log(f"hf_head_dim80 {c['kernel']} shape {c['shape']}: max_abs_err={c['max_abs_err']:.3g} "
            f"kernel_ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
            f"library_ms(F.scaled_dot_product_attention)={c['library_ms']:.4f} "
            f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']})"
            + (f" pad of q, k, v to 128: {c['pad_ms']:.4f} ms" if "pad_ms" in c else "")
            + (f" padding the cache's K/V to 128 instead: {c['pad_cache_ms']:.4f} ms a step"
               if "pad_cache_ms" in c else ""))
    return cases


# a 16-bit output of B3 is the f32 result rounded once: two f32 results
# within B3_TOL may round one step of the dtype apart (rtol its eps)
B3_BF16_TOL = dict(rtol=2**-7, atol=2e-5)
# the wider inputs of the attention kernels: B4 over fp16 / bf16
# caches at the OPT path's decode shape (B 8, 12 heads) and the Llama
# path's GQA (32 over 4); B2 over StarCoder's 48 query heads a KV head (D
# 128) and 64 over 1 (D 64); all three at head dims 100 and 512 at
# hf_head_dim80's shapes (B 8, 32 heads)
HALF_B4_CASES = ((8, 12, 12), (8, 32, 4))
GROUPED_B2_CASES = ((8, 48, 1, 128), (8, 64, 1, 64))
ROUTE_HEAD_DIMS = (100, 512)


def route_kernels(torch, dev):
    """B4, B3 and B2 on their routes off the main kernels, each against its
    plain version on the same inputs (B2_TOL / B3_TOL / B4_TOL on f32
    outputs, B3_BF16_TOL on a bf16 one), timed with its plain version, SDPA
    and its bound: B4 over bf16 and fp16 caches (read as stored; the bound counts
    the 16-bit bytes); B3 with bf16 q/k/v and with an f32 q over bf16 K/V
    (the wrapper's f32 copies timed apart as upcast_ms) at the OPT path's
    prefill (BH 96, L = S = 128, D 64, causal); B2 on its grouped route; B2,
    B3 and B4 at D 100 and 512 (B3's 100 padded to 128, its 512 the generic
    kernel; B2's and B4's both the generic route).  Each case names its
    route (``attention_route``)."""
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops.flash_attention import (
        attention_route, flash_attention, flash_attention_ref)
    from dmx_compressor_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_int8, flash_decode_int8_ref, flash_decode_ref)
    from dmx_compressor_tpu_torch.ops.kv_cache import QuantizedKVCache, QuantKV

    g = torch.Generator(device=dev).manual_seed(21)
    S, fill = CAPACITY, PROMPT + GEN // 2
    cases = []

    def causal_mask(B):
        le = torch.full((B,), fill, dtype=torch.int32, device=dev)
        return le, (torch.arange(S, device=dev)[None, :] < le[:, None])[:, None, None, :]

    def b4_case(B, H, Hkv, D, kv_dtype):
        le, mask = causal_mask(B)
        nbytes = torch.finfo(kv_dtype).bits // 8
        sets = [(torch.randn(B, H, 1, D, generator=g, device=dev),
                 torch.randn(B, Hkv, S, D, generator=g, device=dev).to(kv_dtype),
                 torch.randn(B, Hkv, S, D, generator=g, device=dev).to(kv_dtype), le)
                for _ in range(copies_for(2 * B * Hkv * S * D * nbytes))]
        route = attention_route("flash_decode", H, Hkv, D, (torch.float32, kv_dtype, kv_dtype))
        err = max_err(torch, flash_decode(*sets[0]), flash_decode_ref(*sets[0]), B4_TOL,
                      f"B4 {kv_dtype} {B, H, Hkv, S, D}")
        bound_ms, by = bound(*b4_bytes_flops(B, H, Hkv, D, [fill] * B, nbytes))
        cases.append(dict(
            kernel="flash_decode", route=route, dtype=str(kv_dtype), shape=[B, H, Hkv, S, D],
            lengths=fill, max_abs_err=err, ms=time_ms(torch, flash_decode, sets),
            plain_ms=time_plain(torch, flash_decode_ref, sets),
            library_ms=time_ms(torch, lambda q, k, v, _: F.scaled_dot_product_attention(
                q.to(k.dtype), k, v, attn_mask=mask, enable_gqa=H != Hkv), sets),
            bound_ms=bound_ms, bound_by=by))

    def b3_case(B, H, D, q_dtype, kv_dtype):
        L = PROMPT
        per = B * H * L * D * (torch.finfo(q_dtype).bits + 2 * torch.finfo(kv_dtype).bits) // 8
        sets = [(torch.randn(B, H, L, D, generator=g, device=dev).to(q_dtype),
                 torch.randn(B, H, L, D, generator=g, device=dev).to(kv_dtype),
                 torch.randn(B, H, L, D, generator=g, device=dev).to(kv_dtype))
                for _ in range(copies_for(per))]
        route = attention_route("flash_attention", 1, 1, D, (q_dtype, kv_dtype, kv_dtype))
        tol = B3_TOL if q_dtype == torch.float32 else B3_BF16_TOL
        err = max_err(torch, flash_attention(*sets[0], causal=True).float(),
                      flash_attention_ref(*sets[0], causal=True).float(), tol,
                      f"B3 {q_dtype} over {kv_dtype} D={D}")
        pairs = L * (L + 1) // 2
        nbytes = per + B * H * L * D * torch.finfo(q_dtype).bits // 8
        if route == "generic":  # f32 on the CUDA cores
            bound_ms, by = bound(nbytes, 4 * B * H * D * pairs)
        else:  # the six bf16 plane products
            bound_ms, by = bound(nbytes, B3_PLANE_PRODUCTS * 4 * B * H * D * pairs,
                                 PEAK_BF16_FLOP_S)
        case = dict(
            kernel="flash_attention", route=route, dtype=f"q {q_dtype}, k/v {kv_dtype}",
            shape=[B * H, L, L, D], max_abs_err=err,
            ms=time_ms(torch, lambda q, k, v: flash_attention(q, k, v, causal=True), sets),
            plain_ms=time_plain(torch, lambda q, k, v: flash_attention_ref(q, k, v, causal=True),
                                sets),
            library_ms=time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q.to(k.dtype), k, v, is_causal=True), sets),
            bound_ms=bound_ms, bound_by=by)
        if route == "upcast":
            case["upcast_ms"] = time_ms(
                torch, lambda q, k, v: [t.float().contiguous() for t in (q, k, v)], sets)
        cases.append(case)

    def b2_case(B, H, Hkv, D):
        le, mask = causal_mask(B)
        sets = []
        for _ in range(copies_for(B * Hkv * S * (2 * D + 8))):
            kq, ks = QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g,
                                                            device=dev))
            vq, vs = QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g,
                                                            device=dev))
            sets.append((torch.randn(B, H, 1, D, generator=g, device=dev),
                         QuantKV(kq, vq, ks, vs), le))
        route = attention_route("flash_decode_int8", H, Hkv, D)
        err = max_err(torch, flash_decode_int8(*sets[0]), flash_decode_int8_ref(*sets[0]),
                      B2_TOL, f"B2 {B, H, Hkv, S, D}")
        deq = [(q, kv.k_q.float() * kv.k_scale[..., None], kv.v_q.float() * kv.v_scale[..., None])
               for q, kv, _ in sets[:copies_for(2 * B * Hkv * S * D * 4)]]
        bound_ms, by = bound(*b2_bytes_flops(B, H, Hkv, D, [fill] * B))
        cases.append(dict(
            kernel="flash_decode_int8", route=route, shape=[B, H, Hkv, S, D], lengths=fill,
            max_abs_err=err, ms=time_ms(torch, flash_decode_int8, sets),
            plain_ms=time_plain(torch, flash_decode_int8_ref, sets),
            library_ms=time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=H != Hkv), deq),
            bound_ms=bound_ms, bound_by=by))

    for kv_dtype in (torch.bfloat16, torch.float16):
        for B, H, Hkv in HALF_B4_CASES:
            b4_case(B, H, Hkv, 64, kv_dtype)
    b3_case(BATCH, 12, 64, torch.bfloat16, torch.bfloat16)
    b3_case(BATCH, 12, 64, torch.float32, torch.bfloat16)
    for B, H, Hkv, D in GROUPED_B2_CASES:
        b2_case(B, H, Hkv, D)
    H = HD80["num_attention_heads"]
    for D in ROUTE_HEAD_DIMS:
        b3_case(BATCH, H, D, torch.float32, torch.float32)
        b4_case(BATCH, H, H, D, torch.float32)
        b2_case(BATCH, H, H, D)
    for c in cases:
        log(f"route {c['kernel']}/{c['route'] or 'main'} {c.get('dtype', '')} shape {c['shape']}: "
            f"max_abs_err={c['max_abs_err']:.3g} kernel_ms={c['ms']:.4f} "
            f"plain_ms={c['plain_ms']:.4f} library_ms(F.scaled_dot_product_attention)="
            f"{c['library_ms']:.4f} bound_ms={c['bound_ms']:.4f} ({c['bound_by']})"
            + (f" the wrapper's f32 copies {c['upcast_ms']:.4f} ms of it" if "upcast_ms" in c
               else ""))
    return cases


def hf_head_dim80_path(torch, dev, kernels):
    """A written OPT checkpoint at OPT-2.7b's attention shape (HD80: 32 heads
    of 80) at 2 layers, loaded on the card and on the CPU: the raw model's
    prefill through B3 and decode through B4, the int8 cache's through B3
    and B2, and the checkpoint loaded with dtype bf16 (an f32 model over a
    bf16 float cache) through B3 and B4's bf16 route (HD80_BATCH prompts of
    PROMPT ids, HD80_STEPS steps), counted by kernel and by route; the card's logits against the CPU's, teacher-forced (LOGIT_TOL,
    KV8_TOL, LOGIT_TOL); then the kernels at D 80 beside 64, B3's SDPA at D
    80 timed twice more, and the routes of :func:`route_kernels`.  Returns
    (the counted launches, the numbers)."""
    import tempfile

    import numpy as np

    from dmx_compressor_tpu_torch.modeling.hf import pipeline

    cfg = opt_hf_config(**HD80)
    L = cfg["num_hidden_layers"]
    t0 = time.perf_counter()
    tensors = opt_hf_tensors(cfg, seed=0)
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, cfg["vocab_size"],
                                                            (HD80_BATCH, PROMPT)),
                          dtype=torch.int32)
    total, errs = {}, {}
    with tempfile.TemporaryDirectory() as root:
        d = write_opt_checkpoint(torch, root, cfg, tensors, ("safetensors",))["safetensors"]
        log(f"hf_head_dim80: {cfg['hidden_size']} wide, {cfg['num_attention_heads']} heads of "
            f"{cfg['hidden_size'] // cfg['num_attention_heads']}, {L} layers written in "
            f"{time.perf_counter() - t0:.2f} s")
        del tensors
        for name, quantized, tol, decode, dtype in (
                ("raw", False, LOGIT_TOL, "flash_decode", torch.float32),
                ("int8_cache", True, KV8_TOL, "flash_decode_int8", torch.float32),
                ("bf16_cache", False, LOGIT_TOL, "flash_decode", torch.bfloat16)):
            rows = []
            for where in (dev, torch.device("cpu")):  # the card's tokens first
                pipe = pipeline("text-generation", d, device=where, dtype=dtype)
                if pipe.missed_keys:
                    raise AssertionError(f"hf_head_dim80: unmatched keys {pipe.missed_keys}")
                if not rows:
                    build = (name, None, None, quantized)
                    toks, launched, wall = hf_generate(torch, kernels, build, pipe, ids.to(dev),
                                                       HD80_STEPS + 1, True)
                    routes = dict(kernels.ROUTE_LAUNCHES)
                    want = {"flash_attention": L, decode: L * HD80_STEPS}
                    want_routes = ({"flash_decode/bf16": L * HD80_STEPS}
                                   if dtype == torch.bfloat16 else {})
                    log(f"hf_head_dim80 {name}: {HD80_STEPS + 1} tokens, {wall:.3f} ms a step "
                        f"wall, launches {launched} (expected {want}), by route {routes} "
                        f"(expected {want_routes})")
                    if launched != want or routes != want_routes:
                        raise AssertionError(f"hf_head_dim80 {name}: the generation did not "
                                             f"launch the kernels the expected number of times")
                    for k, v in launched.items():
                        total[k] = total.get(k, 0) + v
                rows.append(teacher_forced(torch, pipe.raw_model, ids, toks, quantized,
                                           HD80_STEPS))
                del pipe
                torch.cuda.empty_cache()
            errs[name] = float((rows[0] - rows[1]).abs().max())
            log(f"hf_head_dim80 {name} card vs CPU: the prefill's and {HD80_STEPS} teacher-forced "
                f"steps' logits max |diff| {errs[name]:.3g} (tolerance {tol})")
            if not errs[name] <= tol:
                raise AssertionError(f"hf_head_dim80 {name}: the card disagrees with the CPU")
    cases = head_dim80_kernels(torch, dev)
    return total, dict(cpu_max_abs_err=errs, cases=cases + route_kernels(torch, dev),
                       sdpa_d80_retimed=sdpa_d80_retimed(torch, dev))


def sdpa_d80_retimed(torch, dev):
    """SDPA at B3's D 80 case (B 8, 32 heads, L = S = 128, causal), timed
    twice more beside B3 at D 80 over fresh inputs, in turns (SDPA, B3, B3,
    SDPA): its earlier runs read 0.0253 and 0.0533 ms."""
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device=dev).manual_seed(81)
    H, B, L, D = HD80["num_attention_heads"], BATCH, PROMPT, 80
    sets = [tuple(torch.randn(B, H, L, D, generator=g, device=dev) for _ in range(3))
            for _ in range(copies_for(4 * B * H * D * 4 * L))]
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
    b3 = lambda q, k, v: flash_attention(q, k, v, causal=True)  # noqa: E731
    times = dict(sdpa_ms=[time_ms(torch, sdpa, sets)], b3_ms=[time_ms(torch, b3, sets)])
    times["b3_ms"].append(time_ms(torch, b3, sets))
    times["sdpa_ms"].append(time_ms(torch, sdpa, sets))
    names = [n for n, _, _ in device_trace(torch, lambda: sdpa(*sets[0]))]
    log(f"hf_head_dim80 SDPA at D 80 (B 8, 32 heads, L = S = 128, causal) in turns with B3: "
        f"{times}; SDPA's device kernels {names}")
    return dict(times, sdpa_kernels=names)


def qat_steps(torch, kernels, dm, opt, ids, n):
    """``n`` Adam steps of QAT through ``dm``; (each loss, the forwards' and
    backwards' launches summed)."""
    from dmx_compressor_tpu_torch.models import loss_fn

    losses, fwd, bwd = [], {}, {}
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        kernels.reset_launches()
        loss = loss_fn(dm(ids), ids)
        for k, v in nonzero(kernels.LAUNCHES).items():
            fwd[k] = fwd.get(k, 0) + v
        kernels.reset_launches()
        loss.backward()
        for k, v in nonzero(kernels.LAUNCHES).items():
            bwd[k] = bwd.get(k, 0) + v
        opt.step()
        losses.append(loss.item())
    return losses, fwd, bwd


def checkpoint_resume_path(torch, dev, kernels, cfg):
    """QAT at OPT-125m's width and QAT_CPU_LAYERS layers (qat_basic's build:
    BASIC, the modular forward, Adam): 2 x CKPT_STEPS uninterrupted steps;
    then from the same seed CKPT_STEPS steps, ``CheckpointManager.save``, a
    fresh model (another seed) and optimizer, ``restore_latest`` and
    CKPT_STEPS more.  The losses and every parameter must equal the
    uninterrupted run's bit for bit, ``restored_config`` the model's frozen
    yaml byte for byte; each forward 44L+7 T2, no backward a launch.
    Returns (the launches, the numbers)."""
    import dataclasses
    import tempfile

    import numpy as np

    from dmx_compressor_tpu_torch.modeling.model import DmxConfig, DmxModel
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.nn.core import DmxModule
    from dmx_compressor_tpu_torch.utils.checkpoint import CheckpointManager, restored_config
    from dmx_compressor_tpu_torch.utils.io import dump_config_str

    cut = dataclasses.replace(cfg, num_hidden_layers=QAT_CPU_LAYERS)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, cut.vocab_size, QAT_BATCH),
                          dtype=torch.long, device=dev)

    def fresh(seed):
        dm = DmxModel.from_raw(OPTForCausalLM(cut, device=dev, seed=seed)).to_basic_mode()
        return dm, torch.optim.Adam(dm.module.parameters(), lr=QAT_LR, eps=1e-8)

    prev_mode, DmxModule.inference_mode = DmxModule.inference_mode, False
    fwd_total = {}
    try:
        dm_a, opt_a = fresh(0)
        losses_a, fwd, bwd_a = qat_steps(torch, kernels, dm_a, opt_a, ids, 2 * CKPT_STEPS)
        fwd_total.update(fwd)
        dm_b, opt_b = fresh(0)
        losses_b, fwd_b, bwd_b = qat_steps(torch, kernels, dm_b, opt_b, ids, CKPT_STEPS)
        want_yaml = dump_config_str({k: dict(v) for k, v in
                                     DmxConfig.from_model(dm_b, freeze=False).items()})
        with tempfile.TemporaryDirectory() as root:
            mgr = CheckpointManager(root, max_to_keep=3)
            t0 = time.perf_counter()
            mgr.save(CKPT_STEPS, dm_b, optimizer_state=opt_b)
            save_s = time.perf_counter() - t0
            dm_c, opt_c = fresh(1)
            t0 = time.perf_counter()
            step, _ = mgr.restore_latest(dm_c, optimizer_state=opt_c)
            restore_s = time.perf_counter() - t0
            got_yaml = dump_config_str({k: dict(v) for k, v in restored_config(
                mgr._step_dir(CKPT_STEPS)).items()})
        losses_c, fwd_c, bwd_c = qat_steps(torch, kernels, dm_c, opt_c, ids, CKPT_STEPS)
        for part in (fwd_b, fwd_c):
            for k, v in part.items():
                fwd_total[k] = fwd_total.get(k, 0) + v
        want = {"bfp_cast": qat_t2_launches(cut) * 4 * CKPT_STEPS}
        same_params = all(torch.equal(a, c) for a, c in zip(dm_a.module.parameters(),
                                                           dm_c.module.parameters()))
        same_losses = losses_a == losses_b + losses_c
        log(f"checkpoint_resume at {QAT_CPU_LAYERS} layers: losses uninterrupted "
            f"{[round(x, 6) for x in losses_a]}, resumed {[round(x, 6) for x in losses_b]} + "
            f"{[round(x, 6) for x in losses_c]}: equal bit for bit {same_losses}; every parameter "
            f"equal bit for bit {same_params}; restored step {step}; the restored config's yaml "
            f"the model's byte for byte {got_yaml == want_yaml} ({len(want_yaml)} bytes); save "
            f"{save_s:.2f} s, restore {restore_s:.2f} s; launches forward {fwd_total} (expected "
            f"{want}), backward {nonzero({**bwd_a, **bwd_b, **bwd_c})} (expected none)")
        if not (same_losses and same_params and step == CKPT_STEPS and got_yaml == want_yaml):
            raise AssertionError("checkpoint_resume: the resumed run differs from the "
                                 "uninterrupted one")
        if fwd_total != want or bwd_a or bwd_b or bwd_c:
            raise AssertionError("checkpoint_resume: the steps did not launch the kernels the "
                                 "expected number of times")
    finally:
        DmxModule.inference_mode = prev_mode
    return fwd_total, dict(losses=losses_a, save_s=save_s, restore_s=restore_s)


# ---------------------------------------------------------------------------
# phase 10: the export path and functional interception
# ---------------------------------------------------------------------------

# the export phase's bucketed programs: a decoder layer's fc1 (BASIC) over x
# [BATCH, T, 768] for T in these buckets; a T of EXPORT_DISPATCH_T
# dispatches to the smallest that fits
EXPORT_BUCKETS = (32, 64, 128)
EXPORT_DISPATCH_T = 100
# a module graph against its module where the graph's op is not the
# module's: the exact softmax / LayerNorm of the graph (the JAX package's
# functional targets) against the BASIC surrogates (SOFTMAX, LAYER_NORM
# vsimd), each side then through the same FLOAT16 output cast; twice the
# gap measured on the CPU at OPT-125m's width (tests/test_torch_export.py's
# OPT case holds it at 2e-2 at tiny width)
SURROGATE_GRAPH_TOL = 2e-2


def bfp_sites(m) -> int:
    """The BFP casts (QuantizeBFP / DequantizeBFP pairs) a module's compiler
    graph carries, counted from the module's casts: its input and output
    casts, its weight's storage and weight casts and its bias cast; the
    compound SDPA's own input casts and its children's casts as its graph
    uses them (actmatmul and resadd twice each), without its own output
    cast."""
    from dmx_compressor_tpu_torch.nn import modules as tnn
    from dmx_compressor_tpu_torch.numerics.format import BlockFloatingPoint

    def bfp(casts):
        return sum(isinstance(c.format, BlockFloatingPoint) for c in casts if c is not None)

    def own(mod, outputs=True):
        casts = [c for _, c in mod.input_casts.items()]
        if outputs:
            casts += [c for _, c in mod.output_casts.items()]
        if getattr(mod, "weight", None) is not None:
            casts += [mod.weight_storage_cast, mod.weight_cast]
        if getattr(mod, "bias", None) is not None:
            casts.append(mod.bias_cast)
        return bfp(casts)

    if isinstance(m, tnn.ScaledDotProductAttention):
        return (own(m, outputs=False) + 2 * own(m.actmatmul) + 2 * own(m.resadd) + own(m.mul)
                + own(m.softmax) + own(m.dropout))
    return own(m)


def layer_with_mask(torch, layer):
    """One decoder layer over x [B, T, D] with its causal mask built inside:
    a module of one argument, for torch.export and its buckets."""
    from dmx_compressor_tpu_torch.models.positions import causal_mask

    class LayerWithMask(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer = layer

        def forward(self, x):
            T = x.shape[1]
            return self.layer(x, attn_mask=causal_mask(T, T, 0, x.dtype, x.device))

    return LayerWithMask()


def export_phase(torch, dev, kernels, cfg):
    """The export path over OPT-125m at full width and depth (seed 0,
    ``DmxModel.from_raw(m).to_basic_mode()`` on the card): the compiler
    graphs (none skipped, the SDPA's among them); each module's graph
    evaluated on the inputs its module saw in one BASIC prefill (BATCH x
    PROMPT, the modular path) against the module's output, bit for bit
    where the graph computes with the module's ops, else at
    SURROGATE_GRAPH_TOL, the T2 launches of each evaluation its module
    call's; the ONNX bytes of the card model against its CPU copy's, parsed
    back, their QuantizeBFP count the modules' BFP casts; the exported
    program of one decoder layer holding T2 as an operator, its module's
    output eager's bit for bit with eager's T2 launches; the bucketed
    export of its fc1.  Returns (the launches of the counted runs, the
    numbers)."""
    import copy

    import numpy as np

    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.nn import modules as tnn
    from dmx_compressor_tpu_torch.nn.core import DmxModule
    from dmx_compressor_tpu_torch.transform import onnx_export, qdq

    L = cfg.num_hidden_layers
    numbers, total = {}, {}

    def add(launched):
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v

    prev_mode, DmxModule.inference_mode = DmxModule.inference_mode, False
    try:
        dm = DmxModel.from_raw(OPTForCausalLM(cfg, device=dev, seed=0)).to_basic_mode()
        t0 = time.perf_counter()
        graphs = dm.make_compiler_graphs()
        numbers["graphs_s"] = round(time.perf_counter() - t0, 3)
        mods = dict(dm.named_dmx_modules())
        sdpas = [n for n in graphs if isinstance(mods[n], tnn.ScaledDotProductAttention)]
        log(f"export: {len(graphs)} compiler graphs in {numbers['graphs_s']} s "
            f"({len(sdpas)} SDPA graphs), skipped {graphs.skipped}")
        if graphs.skipped or len(graphs) != len(mods) or len(sdpas) != L:
            raise AssertionError("export: the compiler graphs do not cover every module")

        # one BASIC prefill, every module's inputs, output and T2 launches
        ids = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                (BATCH, PROMPT)), device=dev)
        calls = {n: [] for n in graphs}
        opened = {}

        def pre(m, args, kwargs, n):
            opened.setdefault(n, []).append(kernels.LAUNCHES["bfp_cast"])

        def post(m, args, kwargs, out, n):
            began = opened[n].pop()
            calls[n].append((args, kwargs, out, kernels.LAUNCHES["bfp_cast"] - began))

        hooks = []
        for n in graphs:
            hooks.append(mods[n].register_forward_pre_hook(
                functools.partial(pre, n=n), with_kwargs=True))
            hooks.append(mods[n].register_forward_hook(
                functools.partial(post, n=n), with_kwargs=True))
        children = {f"{n}.{c}" for n in sdpas for c in ("resadd", "actmatmul", "softmax",
                                                         "dropout", "mul")}
        DmxModule.monitors += 1  # the modular path: every module is called
        kernels.reset_launches()
        try:
            with torch.no_grad():
                logits = dm(ids)
            torch.cuda.synchronize()
        finally:
            DmxModule.monitors -= 1
            for h in hooks:
                h.remove()
        eager = nonzero(kernels.LAUNCHES)
        want = {"bfp_cast": 44 * L + 7}
        log(f"export: the BASIC prefill ({BATCH} x {PROMPT}, modular) launches {eager} "
            f"(expected {want})")
        if eager != want or not torch.isfinite(logits).all():
            raise AssertionError("export: the BASIC prefill did not launch the kernels the "
                                 "expected number of times, or its logits are not finite")
        add(eager)
        del logits

        # every module's graph on its module's inputs
        exact = held = 0
        gaps = {}
        graph_t2 = top_t2 = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            for n, g in graphs.items():
                m = mods[n]
                surrogate = isinstance(m, (tnn.LayerNorm, tnn.Softmax)) or n in sdpas
                for args, kwargs, out, launched in calls[n]:
                    if n in sdpas:
                        args = (*args, kwargs["attn_mask"], kwargs["scale"])
                    before = kernels.LAUNCHES["bfp_cast"]
                    got = qdq.evaluate_graph(g, m, *args)
                    t2 = kernels.LAUNCHES["bfp_cast"] - before
                    if t2 != launched:
                        raise AssertionError(f"export: {n}'s graph launched T2 {t2} times, "
                                             f"its module {launched}")
                    graph_t2 += t2
                    if n not in children:
                        top_t2 += t2
                    if surrogate:
                        kind = "sdpa" if n in sdpas else type(m).__name__
                        err = (got - out).abs().max().item()
                        gaps[kind] = max(gaps.get(kind, 0.0), err)
                        if not err <= SURROGATE_GRAPH_TOL:
                            raise AssertionError(f"export: {n}'s graph is {err} from its "
                                                 f"module (tolerance {SURROGATE_GRAPH_TOL})")
                        held += 1
                    else:
                        if not same_bits(torch, got, out):
                            raise AssertionError(f"export: {n}'s graph differs from its "
                                                 f"module's output")
                        exact += 1
            torch.cuda.synchronize()
        numbers["graph_eval_s"] = round(time.perf_counter() - t0, 3)
        numbers.update(exact=exact, held=held, surrogate_gaps=gaps)
        log(f"export: graphs against their modules on the card: {exact} calls bit for bit, "
            f"{held} at the surrogates' tolerance {SURROGATE_GRAPH_TOL} (max gap {gaps}); T2 "
            f"launches: every evaluation its module call's, the top-level graphs' {top_t2} "
            f"(the prefill's {eager['bfp_cast']}), with the SDPA's children {graph_t2}; "
            f"{numbers['graph_eval_s']} s")
        if top_t2 != eager["bfp_cast"]:
            raise AssertionError("export: the graphs' T2 launches are not the prefill's")
        add({"bfp_cast": graph_t2})
        del calls

        # ONNX: the card model's bytes are its CPU copy's
        t0 = time.perf_counter()
        card_onnx = onnx_export.export_onnx(dm.module)
        numbers["onnx_s"] = round(time.perf_counter() - t0, 3)
        cpu_onnx = onnx_export.export_onnx(copy.deepcopy(dm.module).to("cpu"))
        if list(card_onnx) != list(cpu_onnx) or any(card_onnx[k] != cpu_onnx[k]
                                                    for k in card_onnx):
            raise AssertionError("export: the card model's ONNX bytes are not its CPU copy's")
        n_q = n_init = 0
        for k, data in card_onnx.items():
            parsed = onnx_export.parse_onnx(data)
            want_init = [x.name for x in graphs[k].nodes if x.op == "get_attr"]
            if parsed["initializers"] != want_init or not parsed["outputs"]:
                raise AssertionError(f"export: {k}'s ONNX does not parse back to its graph")
            n_q += sum(x["op_type"] == "QuantizeBFP" for x in parsed["nodes"])
            n_init += len(parsed["initializers"])
        n_bfp = sum(bfp_sites(mods[k]) for k in card_onnx)
        numbers.update(onnx_models=len(card_onnx), onnx_bytes=sum(map(len, card_onnx.values())),
                       quantize_bfp=n_q)
        log(f"export: export_onnx of the card model: {len(card_onnx)} models, "
            f"{numbers['onnx_bytes']} bytes in {numbers['onnx_s']} s, byte for byte its CPU "
            f"copy's; parsed back: {n_init} initializers, {n_q} QuantizeBFP (the modules' BFP "
            f"casts: {n_bfp})")
        if n_q != n_bfp:
            raise AssertionError("export: the QuantizeBFP count is not the modules' BFP casts")
        del card_onnx, cpu_onnx

        # the program of one decoder layer
        lw = layer_with_mask(torch, dm.module.model.decoder.layers[0])
        x = torch.randn(BATCH, PROMPT, cfg.hidden_size, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        t0 = time.perf_counter()
        ep = qdq.exported_program(lw, x)
        text = str(ep)
        numbers["program_s"] = round(time.perf_counter() - t0, 3)
        ops = text.count("torch.ops.dmx_compressor_tpu_torch.bfp_cast")
        kernels.reset_launches()
        with torch.no_grad():
            want_y = lw(x)
        torch.cuda.synchronize()
        eager_l = nonzero(kernels.LAUNCHES)
        kernels.reset_launches()
        with torch.no_grad():
            got_y = ep.module()(x)
        torch.cuda.synchronize()
        prog_l = nonzero(kernels.LAUNCHES)
        numbers.update(program_chars=len(text), program_t2_ops=ops)
        log(f"export: the program of one decoder layer ({BATCH} x {PROMPT} x "
            f"{cfg.hidden_size}): {len(text)} characters in {numbers['program_s']} s, {ops} "
            f"T2 operators; run: launches {prog_l}, eager {eager_l}; bit for bit "
            f"{same_bits(torch, got_y, want_y)}")
        if (ops == 0 or ops != eager_l.get("bfp_cast") or prog_l != eager_l
                or not same_bits(torch, got_y, want_y)):
            raise AssertionError("export: the exported program does not hold T2 as an "
                                 "operator, or does not run as eager")
        add(eager_l)
        add(prog_l)

        # the bucketed programs, of the layer's fc1 (a BASIC Linear)
        t0 = time.perf_counter()
        programs, dispatch = qdq.export_program_bucketed(
            lw.layer.fc1, (x,), axis_buckets={0: (1, list(EXPORT_BUCKETS))})
        numbers["buckets_s"] = round(time.perf_counter() - t0, 3)
        picked = dispatch((x[:, :EXPORT_DISPATCH_T],))
        want_keys = [f"a0x1={t}" for t in EXPORT_BUCKETS]
        log(f"export: bucketed programs {list(programs)} in {numbers['buckets_s']} s, each "
            f"holding T2 {[p.count('dmx_compressor_tpu_torch.bfp_cast') for p in programs.values()]}"
            f" times; T {EXPORT_DISPATCH_T} dispatches to {picked}")
        if (list(programs) != want_keys or picked != f"a0x1={EXPORT_BUCKETS[-1]}"
                or not all("dmx_compressor_tpu_torch.bfp_cast" in p for p in programs.values())):
            raise AssertionError("export: the bucketed programs or their dispatch are wrong")
    finally:
        DmxModule.inference_mode = prev_mode
    return total, numbers


def intercept_phase(torch, dev, kernels, cfg):
    """``DmxModel.from_function`` over the raw, un-substituted OPT-125m's
    prefill at full width (seed 0, BATCH x PROMPT) under
    ``InterceptRules.basic()``: the sites by kind, the T2 launches of one
    quantized forward (three casts a site, every blocked axis on the BFP
    block), its gap to the unquantized logits; the same at FAMILY_CPU_LAYERS
    layers on the card and its CPU copy (the card's first FAMILY_CPU_BATCH
    rows) held at BASIC_LOGIT_TOL; then examples/family_tour.py on the card.
    Returns (the launches of the counted runs, the numbers)."""
    import copy
    import dataclasses
    from collections import Counter

    import numpy as np

    from dmx_compressor_tpu_torch.examples.family_tour import tour
    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM

    ids = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT)))
    numbers = {}
    m = OPTForCausalLM(cfg, device=dev, seed=0)
    t0 = time.perf_counter()
    with torch.no_grad():
        qf = DmxModel.from_function(m, (ids.to(dev),))
    numbers["enumerate_s"] = round(time.perf_counter() - t0, 3)
    kinds = Counter(s.rsplit("/", 1)[-1].rsplit("_", 1)[0] for s in qf.sites)
    L = cfg.num_hidden_layers
    want_kinds = {"dot": 8 * L + 1, "add": 11 * L + 2}
    numbers["sites"] = dict(kinds)
    log(f"intercept: {len(qf.sites)} sites by kind {dict(kinds)} (expected {want_kinds}), "
        f"enumerated in {numbers['enumerate_s']} s; e.g. {qf.sites[:3]} ... {qf.sites[-2:]}")
    if dict(kinds) != want_kinds:
        raise AssertionError("intercept: the site list is not the expected one")
    kernels.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        got = qf(ids.to(dev))
    torch.cuda.synchronize()
    numbers["forward_s"] = round(time.perf_counter() - t0, 3)
    launched = nonzero(kernels.LAUNCHES)
    want = {"bfp_cast": 3 * len(qf.sites)}
    with torch.no_grad():
        exact = m(ids.to(dev))
    gap = (got - exact).abs().max().item()
    numbers["gap_to_unquantized"] = gap
    log(f"intercept: the quantized prefill launches {launched} (expected {want}: three casts "
        f"a site), {numbers['forward_s']} s; its logits max |quantized - unquantized| {gap:.4g}")
    if launched != want or not torch.isfinite(got).all():
        raise AssertionError("intercept: the quantized prefill did not launch the kernels the "
                             "expected number of times, or its logits are not finite")
    del got, exact, qf, m
    torch.cuda.empty_cache()

    # card against CPU at FAMILY_CPU_LAYERS layers
    cut = dataclasses.replace(cfg, num_hidden_layers=FAMILY_CPU_LAYERS)
    mc = OPTForCausalLM(cut, device=dev, seed=0)
    rows = ids[:FAMILY_CPU_BATCH]
    outs, site_lists = [], []
    for model, where in ((mc, dev), (copy.deepcopy(mc).to("cpu"), torch.device("cpu"))):
        with torch.no_grad():
            q = DmxModel.from_function(model, (rows.to(where),))
            outs.append(q(rows.to(where)).cpu())
        site_lists.append(q.sites)
    err = (outs[0] - outs[1]).abs().max().item()
    numbers["cpu_max_abs_err"] = err
    log(f"intercept: card vs CPU at {FAMILY_CPU_LAYERS} layer(s), {FAMILY_CPU_BATCH} rows: the "
        f"same {len(site_lists[0])} sites {site_lists[0] == site_lists[1]}, logits max |diff| "
        f"{err:.4g} (tolerance {BASIC_LOGIT_TOL})")
    if site_lists[0] != site_lists[1] or not err <= BASIC_LOGIT_TOL:
        raise AssertionError("intercept: the card disagrees with the CPU")

    t0 = time.perf_counter()
    toured = tour(dev.type)
    numbers["family_tour_s"] = round(time.perf_counter() - t0, 3)
    log(f"intercept: examples/family_tour.py on the card in {numbers['family_tour_s']} s")
    if (toured["intercept"]["sites"] != ["dot_0", "dot_1", "add_0"]
            or not all(math.isfinite(v["delta"]) for v in toured["families"].values())):
        raise AssertionError("intercept: family_tour.py did not run as expected")
    return launched, numbers


# ---------------------------------------------------------------------------
# phase 11: parallelism (ranks sharing the one card over gloo) and the native
# oracle
# ---------------------------------------------------------------------------

PAR_TP = 2  # OPT-125m over tp 2: heads 6 a rank; B1 at N 1152 / K 384 / N 1536 / K 1536 / N 25136
# OPT-125m's tp paths (prefill, engine, checkpoint, BASIC, the NCCL rank,
# scaling_bench) at full width and this many layers (TinyLlama-1.1B runs
# the tp path at full depth); the pipeline keeps all 12 BASIC layers
PAR_OPT_LAYERS = 2
PAR_RANKS = 2
PAR_TIMEOUT = 900  # seconds the world may take before its ranks are killed and the run fails
PAR_BURST = 16  # the engine's decode forwards a dispatch
PAR_GEN = 32  # the OPT engine's new tokens a request
PAR_CKPT_STEPS = 8  # the restored model's greedy tokens: the prefill's and 7 steps'
PIPE_MICRO = 4  # pipeline_forward: 4 microbatches of 2 x PROMPT over pp 2
# the pipeline against the sequential BASIC layers on the card: the same
# casts, cuBLAS products at 256 rows against 1024 (another summation order),
# where a FLOAT16 output cast may land one fp16 step apart: JAX's bar for
# its quantized pipeline (tests/test_parallel.py)
PIPE_TOL = 2e-3
RING = dict(B=1, H=12, S=8192, D=64)  # ring_attention at sp 2, causal
# ring attention against the plain SDPA of the whole sequence on the card:
# f32 logits and an online softmax summed in chunks of 4096 keys against
# one softmax over 8192 (the CPU test holds 2e-6 at S 32)
RING_TOL = 1e-4
SCALING_SHAPES = [(1, 1), (1, 2), (2, 1)]


def tp2_linear_shapes(cfg):
    """(K, N, launches per forward) of a tp-2 rank's packed linears on the
    weights path: merged q/k/v by heads, out_proj's and fc2's halves of K,
    fc1's half of N, the head's half of the vocabulary."""
    d, f, L = cfg.hidden_size, cfg.ffn_dim, cfg.num_hidden_layers
    return [(d, 3 * d // PAR_TP, L), (d // PAR_TP, d, L), (d, f // PAR_TP, L),
            (f // PAR_TP, d, L), (d, cfg.vocab_size // PAR_TP, 1)]


def check_b1_tp2(torch, dev, cfg):
    """B1 at a tp-2 rank's shard shapes (decode M = BATCH and prefill M =
    BATCH x PROMPT), and one decode step's launches of a rank as the
    parallel phase makes them: OPT-125m's (at PAR_OPT_LAYERS), then
    TinyLlama's (22 layers), gemma-2b's and qwen3-0.6b's (at
    PAR_FAMILY_LAYERS).  Returns ({model: its step}, the cases)."""
    import dataclasses

    from dmx_compressor_tpu_torch.ops.bfp_linear import bfp_linear, bfp_linear_ref
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, bfp_unpack

    cfg = dataclasses.replace(cfg, num_hidden_layers=PAR_OPT_LAYERS)
    fc = par_family_configs()
    steps, cases = {}, []
    for seed, (name, shapes) in zip((40, 42, 44, 46), (
            ("opt", tp2_linear_shapes(cfg)),
            *((f, family_tp2_linear_shapes(fc[f])) for f in ("llama", "gemma", "qwen3")))):
        steps[name], got = check_linear(
            torch, dev, f"B1 bfp_linear (tp 2 shard, {name})", bfp_linear, bfp_linear_ref,
            lambda w: bfp_pack(w, 8, 64), bfp_unpack, b1_bytes, shapes, [], B1_TOL, seed=seed,
            planes=3)
        for c in got:
            c["path"] = "parallel_tp2" if name == "opt" else f"parallel_{name}_tp2"
        cases += got
    return steps, cases


def parallel_requests(cfg):
    from dmx_compressor_tpu_torch.examples import serving_bench as sb

    return sb.make_requests(cfg.vocab_size, BATCH, PROMPT, PAR_GEN, spread=False)


def parallel_prompt_ids(torch, cfg, dev):
    import numpy as np

    return torch.from_numpy(np.stack([p for p, _ in parallel_requests(cfg)])).to(dev)


def parallel_references(torch, dev, kernels, cfg, capacity):
    """The unsharded runs on the card the ranks are held against: the
    weights path's isolated generation (tokens and top-1/top-2 margins) and
    its prefill's last logits, and the BASIC forward's last logits and
    launches."""
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.ops.compress import build_basic_mode, build_weights_mode

    ids = parallel_prompt_ids(torch, cfg, dev)
    ref = {}
    with torch.no_grad():
        model = OPTForCausalLM(cfg, device=dev, seed=0)
        build_weights_mode(model)
        ref["iso"], ref["margins"] = isolated_generation(
            torch, model, parallel_requests(cfg), capacity, True, dev)
        caches = model.init_cache(BATCH, CAPACITY, quantized=True, device=dev)
        kernels.reset_launches()
        ref["weights_logits"] = model(ids, caches=caches, position_offset=0)[:, -1].cpu()
        ref["weights_launches"] = nonzero(kernels.LAUNCHES)
        del model, caches
        model = OPTForCausalLM(cfg, device=dev, seed=0)
        build_basic_mode(model)
        kernels.reset_launches()
        ref["basic_logits"] = model(ids)[:, -1].cpu()
        torch.cuda.synchronize()
        ref["basic_launches"] = nonzero(kernels.LAUNCHES)
        del model
    torch.cuda.empty_cache()
    return ref


def _rank_engine(torch, kernels, dist, model, cfg, ref, rank, card, requests, name="engine",
                 b3_per_admission=True, burst=PAR_BURST, profile=True):
    """The engine over this rank's shard: the closed loop of ``requests``,
    its launches counted (an admission's int8 prefill launches B3 where
    ``b3_per_admission``: OPT's routing; the Llama topology's attends
    through ``quantized_sdpa``), its tokens held against the unsharded
    isolated generation (``ref["iso"]``, ``ref["margins"]``) and equal on
    both ranks, its step time, the collectives' times and, where
    ``profile``, the device time of one more dispatch of ``burst`` forwards
    over the requests submitted again."""
    from dmx_compressor_tpu_torch.examples import serving_bench as sb

    L = cfg.num_hidden_layers
    eng = sb.make_engine(model, True, requests, PROMPT, BATCH, burst, None, 1, depth=1)
    eng.warmup(burst)
    torch.cuda.synchronize()
    dispatches = [0]
    real = eng._dispatch

    def dispatch(b, sampling):
        dispatches[0] += 1
        return real(b, sampling)

    eng._dispatch = dispatch
    kernels.reset_launches()
    stats = sb.closed_loop(eng, requests, burst)
    torch.cuda.synchronize()
    launches = nonzero(kernels.LAUNCHES)
    eng._dispatch = real
    adm = sum(st["admissions"] for st in stats["steps"])
    forwards = dispatches[0] * burst
    want = {"bfp_linear": (4 * L + 1) * (adm + forwards), "flash_decode_int8": L * forwards}
    if b3_per_admission:
        want["flash_attention"] = L * adm
    log(f"parallel rank {rank}: {name} {adm} admissions, {dispatches[0]} dispatches of "
        f"{burst} forwards; launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"rank {rank}: the sharded {name} did not launch the kernels the "
                             "expected number of times")
    fin = {r.request_id: r for r in eng.finished}
    got = {i: fin[rid].tokens for i, rid in enumerate(stats["rids"])}
    held = hold_tokens(f"parallel rank {rank} {name}", "the unsharded isolated generation",
                       got, ref["iso"], ref["margins"], KV8_TOL)
    both = [None] * dist.get_world_size()
    dist.all_gather_object(both, got)
    if any(b != got for b in both):
        raise AssertionError("the ranks' engines emitted other tokens")
    sm = sb.summary(stats)
    busy_ms = None
    if profile:
        for prompt, gen in requests:
            sb.submit(eng, prompt, gen)
        eng.step(burst)
        torch.cuda.synchronize()
        with torch.no_grad():
            events = device_events(torch, lambda: eng._dispatch(burst, False))
        busy_ms = sum(us for _, us in events) / 1e3
    coll = _rank_collectives(torch, dist, model, cfg)
    per_forward = 2 * L + 1  # out_proj's and fc2's all-reduce a layer, the embedding's
    step_coll_ms = (per_forward * coll["all_reduce_ms"] + coll["all_gather_ms"]) * burst
    # a loop of a dispatch or two has no steady state: its step is overhead, not a rate
    rate = (f"{sm['tokens_per_s']:.1f} tokens/s, steady step p50" if dispatches[0] > 2 else
            f"{dispatches[0]} dispatch(es), no steady state (overhead, not a rate): step")
    busy = ("device busy not measured" if busy_ms is None else
            f"a dispatch's device busy {busy_ms:.3f} ms (idle share "
            f"{1 - busy_ms / sm['steady_p50_step_ms']:.3f})")
    log(f"parallel rank {rank} {name} on {card}: {rate} {sm['steady_p50_step_ms']:.3f} ms "
        f"({burst} forwards, {sm['steady_p50_step_ms'] / burst:.3f} ms a forward), {busy}; gloo "
        f"over the shared card: an all-reduce of [{BATCH}, 1, {cfg.hidden_size}] "
        f"{coll['all_reduce_ms']:.3f} ms, an all-gather of the head's [{BATCH}, 1, "
        f"{cfg.vocab_size // PAR_TP}] {coll['all_gather_ms']:.3f} ms (host clock): "
        f"{per_forward} + 1 a forward, ~{step_coll_ms:.1f} ms of the step")
    return launches, dict(tokens_per_s=sm["tokens_per_s"], held=held,
                          steady_p50_step_ms=sm["steady_p50_step_ms"],
                          dispatch_device_ms=busy_ms, collectives_ms_per_step=step_coll_ms, **coll)


def _rank_collectives(torch, dist, model, cfg, reps=20):
    """The host-clock ms of one decode forward's collectives on this rank's
    tp group: an all-reduce of a row-parallel output [BATCH, 1, d] and the
    head's all-gather of [BATCH, 1, V / tp] (gloo: CUDA tensors through host
    memory for the gather)."""
    from dmx_compressor_tpu_torch.parallel import comm

    group = model.lm_head.tp_shard.group
    dev = next(model.parameters()).device
    x = torch.randn(BATCH, 1, cfg.hidden_size, device=dev)
    y = torch.randn(BATCH, 1, cfg.vocab_size // PAR_TP, device=dev)
    out = {}
    for name, fn in (("all_reduce_ms", lambda: comm.all_reduce(x, group)),
                     ("all_gather_ms", lambda: comm.all_gather(y, group, dim=-1))):
        fn()
        torch.cuda.synchronize()
        dist.barrier(group)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def _greedy(torch, model, ids, steps):
    from dmx_compressor_tpu_torch.models.opt import greedy_decode, greedy_prefill

    caches = model.init_cache(ids.shape[0], CAPACITY, quantized=True, device=ids.device)
    with torch.no_grad():
        _, tok = greedy_prefill(model, caches, ids)
        more, _ = greedy_decode(model, caches, tok, ids.shape[1], steps - 1)
    return torch.cat([tok[:, None], more], dim=1)


def _rank_pipeline(torch, kernels, dev, cfg, rank):
    """pipeline_forward over OPT-125m's 12 BASIC decoder layers at pp 2
    against the sequential layers on this rank."""
    from torch.func import functional_call

    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.models.opt import OPTDecoderLayer
    from dmx_compressor_tpu_torch.ops.compress import set_inference_mode
    from dmx_compressor_tpu_torch.parallel import make_mesh, pipeline_forward, stack_layer_states

    set_inference_mode(False)
    torch.manual_seed(0)
    layers = []
    for _ in range(cfg.num_hidden_layers):
        layer = OPTDecoderLayer(cfg, dev)
        DmxModel.from_raw(layer).to_basic_mode()
        layers.append(layer)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(BATCH, PROMPT, cfg.hidden_size, generator=g, device=dev)
    mesh = make_mesh((PAR_RANKS,), ("pp",), device_type=dev.type)
    with torch.no_grad():
        kernels.reset_launches()
        layers[0](x[:BATCH // PIPE_MICRO])
        per_layer = nonzero(kernels.LAUNCHES)
        seq = x
        for layer in layers:
            seq = layer(seq)
        stacked = stack_layer_states([dict(layer.state_dict()) for layer in layers])
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        y = pipeline_forward(stacked, x, lambda p, h: functional_call(layers[0], p, (h,)), mesh,
                             num_microbatches=PIPE_MICRO)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = nonzero(kernels.LAUNCHES)
    ticks = PIPE_MICRO + PAR_RANKS - 1
    want = {k: v * ticks * cfg.num_hidden_layers // PAR_RANKS for k, v in per_layer.items()}
    err = (y - seq).abs().max().item()
    log(f"parallel rank {rank} pipeline pp {PAR_RANKS}, {PIPE_MICRO} microbatches of "
        f"{BATCH // PIPE_MICRO} x {PROMPT}: max_abs_err={err:.3g} against the sequential layers "
        f"(tolerance {PIPE_TOL}), {seconds:.3f} s on the host clock; launches {launches} "
        f"(expected {want}: {ticks} ticks x {cfg.num_hidden_layers // PAR_RANKS} layers)")
    if not err <= PIPE_TOL or not torch.isfinite(y).all():
        raise AssertionError(f"rank {rank}: the pipeline disagrees with the sequential layers")
    if launches != want:
        raise AssertionError(f"rank {rank}: the pipeline did not launch T2 the expected number "
                             "of times")
    return launches, dict(max_abs_err=err, seconds=seconds)


def _rank_ring(torch, dev, rank):
    """ring_attention at sp 2 against the port's plain SDPA of the whole
    sequence (rawnn.ScaledDotProductAttention), causal."""
    from dmx_compressor_tpu_torch import rawnn
    from dmx_compressor_tpu_torch.parallel import make_mesh, ring_attention

    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(RING["B"], RING["H"], RING["S"], RING["D"], generator=g, device=dev)
               for _ in range(3))
    mesh = make_mesh((PAR_RANKS,), ("sp",), device_type=dev.type)
    with torch.no_grad():
        ring_attention(q, k, v, mesh, causal=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring_attention(q, k, v, mesh, causal=True)
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = rawnn.ScaledDotProductAttention()(q, k, v, is_causal=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    err = (out - ref).abs().max().item()
    log(f"parallel rank {rank} ring_attention sp {PAR_RANKS} B={RING['B']} H={RING['H']} "
        f"S={RING['S']} D={RING['D']} causal: max_abs_err={err:.3g} against the plain SDPA "
        f"(tolerance {RING_TOL}); {ring_s:.3f} s against {plain_s:.3f} s on the host clock")
    if not err <= RING_TOL:
        raise AssertionError(f"rank {rank}: ring attention disagrees with the plain SDPA")
    return dict(max_abs_err=err, seconds=ring_s, plain_seconds=plain_s)


# the other families over tp 2 beside OPT-125m: TinyLlama-1.1B (bench.py's
# llama-1.1b) at full width and depth, its engine's requests PAR_LLAMA_GEN
# tokens long in bursts of PAR_LLAMA_BURST (no steady dispatch profiled:
# its closed loop is one dispatch), its checkpoint's greedy run
# PAR_LLAMA_CKPT_STEPS tokens (each forward makes 2L + 1 = 45 gloo
# all-reduces: ~0.4 s a forward with the ranks sharing the card);
# gemma-2b, qwen3-0.6b and mistral-1b at full width and PAR_FAMILY_LAYERS;
# whisper-small at WHISPER_LAYERS + WHISPER_LAYERS, PAR_WHISPER_STEPS greedy
# tokens; t5-small and LeNet-5 whole, one forward
PAR_LLAMA_GEN = PAR_LLAMA_BURST = 8
PAR_LLAMA_CKPT_STEPS = 2
PAR_FAMILY_LAYERS = 2
PAR_WHISPER_STEPS = 4
PAR_FAMILIES = ("gemma", "qwen3", "mistral")


def par_family_configs():
    import dataclasses

    from dmx_compressor_tpu_torch.models.gemma import GemmaConfig
    from dmx_compressor_tpu_torch.models.llama import LlamaConfig
    from dmx_compressor_tpu_torch.models.mistral import MistralConfig
    from dmx_compressor_tpu_torch.models.qwen3 import Qwen3Config

    cfgs = {f: dataclasses.replace(c, num_hidden_layers=PAR_FAMILY_LAYERS) for f, c in (
        ("gemma", GemmaConfig.gemma_2b()), ("qwen3", Qwen3Config.qwen3_0_6b()),
        ("mistral", MistralConfig.mistral_1b()))}
    s2s = seq2seq_configs()
    return {"llama": LlamaConfig.llama_1_1b(), **cfgs, "t5": s2s["t5"],
            "whisper": seq2seq_layers(s2s["whisper"], "whisper", WHISPER_LAYERS)}


def family_model(family, cfg, dev, seed=0):
    """The raw model of ``family`` at ``cfg`` on ``dev``, weights from ``seed``."""
    from dmx_compressor_tpu_torch.models import gemma, lenet, llama, mistral, qwen3, t5, whisper

    if family == "lenet":
        return lenet.LeNet5(device=dev, seed=seed)
    cls = {"llama": llama.LlamaForCausalLM, "gemma": gemma.GemmaForCausalLM,
           "qwen3": qwen3.Qwen3ForCausalLM, "mistral": mistral.MistralForCausalLM,
           "whisper": whisper.WhisperForConditionalGeneration,
           "t5": t5.T5ForConditionalGeneration}[family]
    return cls(cfg, device=dev, seed=seed)


def tp_kv_heads(Hkv):
    """A tp-2 rank's KV heads: its share where they divide over tp, else the
    one its query heads read (replicated over the ranks that share it)."""
    return Hkv // PAR_TP if Hkv % PAR_TP == 0 else 1


def family_tp2_shapes(cfg):
    """A tp-2 rank's shards of a Llama-topology family in weights mode: each
    packed payload's (rows, K) and the attention's (query, KV) heads."""
    d, m = cfg.hidden_size, cfg.intermediate_size
    H, Hkv, D = family_heads(cfg)
    q = H * D // PAR_TP
    return {"qkv_merged": (q + 2 * tp_kv_heads(Hkv) * D, d), "o_proj": (d, q),
            "gateup_merged": (2 * m // PAR_TP, d), "down_proj": (d, m // PAR_TP),
            "lm_head": (cfg.vocab_size // PAR_TP, d), "heads": (H // PAR_TP, tp_kv_heads(Hkv))}


def family_tp2_linear_shapes(cfg):
    """(K, N, launches per forward) of a tp-2 rank's packed linears."""
    s, L = family_tp2_shapes(cfg), cfg.num_hidden_layers
    return ([(s[k][1], s[k][0], L) for k in ("qkv_merged", "o_proj", "gateup_merged", "down_proj")]
            + [(s["lm_head"][1], s["lm_head"][0], 1)])


def shard_shapes(model):
    """A sharded Llama-topology model's shards, as family_tp2_shapes gives them."""
    attn, mlp = model.model.layers[0].self_attn, model.model.layers[0].mlp
    shapes = {k: tuple(m.weight_mantissa.shape) for k, m in (
        ("qkv_merged", attn.qkv_merged), ("o_proj", attn.o_proj),
        ("gateup_merged", mlp.gateup_merged), ("down_proj", mlp.down_proj),
        ("lm_head", model.lm_head))}
    return {**shapes, "heads": (attn.num_heads, attn.num_kv_heads)}


def family_prompt_ids(torch, cfg, dev):
    """BATCH prompts of PROMPT ids in ``cfg``'s vocabulary (serving_bench's)."""
    from dmx_compressor_tpu_torch.examples import serving_bench as sb

    import numpy as np

    return torch.from_numpy(np.stack([p for p, _ in sb.make_requests(
        cfg.vocab_size, BATCH, PROMPT, 1, spread=False)])).to(dev)


def llama_requests(cfg):
    from dmx_compressor_tpu_torch.examples import serving_bench as sb

    return sb.make_requests(cfg.vocab_size, BATCH, PROMPT, PAR_LLAMA_GEN, spread=False)


def whisper_run(torch, model, cfg, dev):
    """whisper-small's greedy loop over BATCH rows of features: the start
    tokens prefilled into an int8 cache, PAR_WHISPER_STEPS tokens.  Returns
    (tokens [B, n], each step's logits [n, B, V])."""
    from dmx_compressor_tpu_torch.models.shared import seq2seq_greedy

    start = S2S_START["whisper"]
    x = torch.from_numpy(seq2seq_inputs("whisper", cfg)).to(dev)
    ids = torch.tensor([start] * BATCH, dtype=torch.int32, device=dev)
    caches = model.init_cache(BATCH, len(start) + PAR_WHISPER_STEPS, quantized=True, device=dev)
    with torch.no_grad():
        return seq2seq_greedy(model, caches, model.encode(x), ids, PAR_WHISPER_STEPS)


def replicated_inputs(torch, family, cfg, dev):
    """The forward's inputs of the families that stay replicated as JAX
    places them: t5-small's encoder ids and start id, LeNet-5's images."""
    import numpy as np

    if family == "t5":
        return (torch.from_numpy(seq2seq_inputs("t5", cfg)).to(dev),
                torch.tensor([S2S_START["t5"]] * BATCH, dtype=torch.int32, device=dev))
    return (torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LENET_BATCH, 1, 28, 28), np.float32)).to(dev),)


def build_family(family, cfg, dev, mode, seed=0):
    from dmx_compressor_tpu_torch.ops.compress import build_basic_mode, build_weights_mode

    model = family_model(family, cfg, dev, seed)
    (build_basic_mode if mode == "basic" else build_weights_mode)(model)
    return model


def family_references(torch, dev, kernels, capacity):
    """The unsharded card runs the ranks' families are held against:
    TinyLlama's weights prefill (no cache: B1 and B3), its isolated
    generation (int8 caches) and its BASIC forward; gemma-2b's, qwen3-0.6b's
    and mistral-1b's weights prefill; whisper-small's greedy loop; t5-small's
    weights forward and LeNet-5's BASIC forward; the last position's logits
    and the launches of each."""
    fc = par_family_configs()
    ref = {}

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, nonzero(kernels.LAUNCHES)

    with torch.no_grad():
        for family, mode in (("llama", "weights"), ("llama", "basic"),
                             *((f, "weights") for f in PAR_FAMILIES)):
            cfg = fc[family]
            model = build_family(family, cfg, dev, mode)
            ids = family_prompt_ids(torch, cfg, dev)
            logits, launches = counted(lambda: model(ids)[:, -1])
            ref[family, mode] = dict(logits=logits.cpu(), launches=launches)
            if (family, mode) == ("llama", "weights"):
                ref[family, mode]["iso"], ref[family, mode]["margins"] = isolated_generation(
                    torch, model, llama_requests(cfg), capacity, True, dev)
            del model
            torch.cuda.empty_cache()
        model = build_family("whisper", fc["whisper"], dev, "weights")
        (toks, rows), launches = counted(lambda: whisper_run(torch, model, fc["whisper"], dev))
        top2 = rows.topk(2, dim=-1).values
        ref["whisper", "weights"] = dict(tokens=toks.cpu(), logits=rows[0].cpu(),
                                         margins=(top2[..., 0] - top2[..., 1]).T.cpu(),
                                         launches=launches)
        for family, mode in (("t5", "weights"), ("lenet", "basic")):
            model = build_family(family, fc.get(family), dev, mode)
            x = replicated_inputs(torch, family, fc.get(family), dev)
            logits, launches = counted(lambda: model(*x))
            ref[family, mode] = dict(logits=logits.cpu(), launches=launches)
        del model
    torch.cuda.empty_cache()
    return ref


class _Warnings(logging.Handler):
    """The warnings ``parallel.mesh`` logs (its fallbacks)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def shard_logged(model, mesh):
    """``shard_state(model, mesh)``; returns the placement and what it logged."""
    from dmx_compressor_tpu_torch.parallel import shard_state

    handler = _Warnings()
    logger = logging.getLogger("dmx_compressor_tpu_torch.parallel.mesh")
    logger.addHandler(handler)
    try:
        return shard_state(model, mesh), handler.messages
    finally:
        logger.removeHandler(handler)


def _rank_llama(torch, dist, kernels, rank, tmp, card, dev, mesh, ref):
    """TinyLlama-1.1B at full width and depth over tp 2: weights mode's shard
    shapes, its prefill (B1 4L+1, B3 L), the engine over it (B1 4L+1 and B2
    L a forward), the sharded checkpoint (its merged q/k/v saved part by
    part where it has replicated KV heads; here its 2 KV heads a rank are
    sliced), then the BASIC forward (T1 and T2 as the unsharded forward)."""
    from dmx_compressor_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cfg = par_family_configs()["llama"]
    L = cfg.num_hidden_layers
    ids = family_prompt_ids(torch, cfg, dev)
    out, by_path = {}, {}
    t0 = time.perf_counter()
    with torch.no_grad():
        model = build_family("llama", cfg, dev, "weights")
        placement, _ = shard_logged(model, mesh)
    shapes, want_shapes = shard_shapes(model), family_tp2_shapes(cfg)
    log(f"parallel rank {rank}: TinyLlama {cfg.hidden_size}x{L} weights mode sharded tp {PAR_TP} "
        f"in {time.perf_counter() - t0:.2f} s; {sum(any(p) for p in placement.values())} sharded "
        f"keys; shard shapes {shapes}")
    if shapes != want_shapes:
        raise AssertionError(f"rank {rank}: TinyLlama's shard shapes {shapes}, expected "
                             f"{want_shapes}")
    with torch.no_grad():
        kernels.reset_launches()
        logits = model(ids)[:, -1]
        torch.cuda.synchronize()
    launches = nonzero(kernels.LAUNCHES)
    want = {"bfp_linear": 4 * L + 1, "flash_attention": L}
    err = (logits.cpu() - ref["llama", "weights"]["logits"]).abs().max().item()
    log(f"parallel rank {rank}: TinyLlama's sharded prefill launches {launches} (expected "
        f"{want}); last logits max_abs_err={err:.3g} against the unsharded card prefill "
        f"(tolerance {LOGIT_TOL})")
    if launches != want or not err <= LOGIT_TOL:
        raise AssertionError(f"rank {rank}: TinyLlama's sharded weights prefill is wrong")
    by_path["parallel_llama_prefill"], out["llama_prefill_err"] = launches, err
    by_path["parallel_llama_engine"], out["llama_engine"] = _rank_engine(
        torch, kernels, dist, model, cfg, ref["llama", "weights"], rank, card,
        llama_requests(cfg), name="TinyLlama engine", b3_per_admission=False,
        burst=PAR_LLAMA_BURST, profile=False)
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(tmp, "ckpt_llama"), model, step=5)
    with torch.no_grad():
        other = build_family("llama", cfg, dev, "weights", seed=1)
        shard_logged(other, mesh)
    step, _ = restore_checkpoint(os.path.join(tmp, "ckpt_llama"), other)
    a, b = (_greedy(torch, model, ids, PAR_LLAMA_CKPT_STEPS),
            _greedy(torch, other, ids, PAR_LLAMA_CKPT_STEPS))
    log(f"parallel rank {rank}: TinyLlama's sharded checkpoint saved and restored (step {step}) "
        f"in {time.perf_counter() - t0:.2f} s; {a.numel()} greedy tokens "
        f"{'equal' if torch.equal(a, b) else 'DIFFER'}")
    if step != 5 or not torch.equal(a, b):
        raise AssertionError(f"rank {rank}: TinyLlama's sharded checkpoint did not restore it")
    del model, other
    torch.cuda.empty_cache()
    with torch.no_grad():
        model = build_family("llama", cfg, dev, "basic")
        shard_logged(model, mesh)
        kernels.reset_launches()
        logits = model(ids)[:, -1]
        torch.cuda.synchronize()
    launches = nonzero(kernels.LAUNCHES)
    want = ref["llama", "basic"]["launches"]
    err = (logits.cpu() - ref["llama", "basic"]["logits"]).abs().max().item()
    log(f"parallel rank {rank}: TinyLlama's sharded BASIC forward launches {launches} (the "
        f"unsharded forward's {want}); last logits max_abs_err={err:.3g} against the unsharded "
        f"card forward (tolerance {BASIC_LOGIT_TOL})")
    if launches != want or not err <= BASIC_LOGIT_TOL:
        raise AssertionError(f"rank {rank}: TinyLlama's sharded BASIC forward is wrong")
    by_path["parallel_llama_basic"], out["llama_basic_err"] = launches, err
    del model
    torch.cuda.empty_cache()
    return by_path, out


def _rank_families(torch, dist, kernels, rank, dev, mesh, ref):
    """gemma-2b (MQA: its one KV head replicated), qwen3-0.6b and mistral-1b
    at full width over tp 2: shard shapes, the weights prefill's launches
    and last logits; whisper-small's greedy loop (6 heads a rank, the cross
    K/V at N 384, its odd vocabulary replicated and logged); t5-small (its
    linears replicated, its table sharded as JAX's rules place
    ``decoder.embed_tokens``) and LeNet-5 (replicated: fc2's 60 local inputs
    would cut a block), one forward each."""
    fc = par_family_configs()
    out, by_path = {}, {}
    for family in PAR_FAMILIES:
        cfg = fc[family]
        L = cfg.num_hidden_layers
        ids = family_prompt_ids(torch, cfg, dev)
        with torch.no_grad():
            model = build_family(family, cfg, dev, "weights")
            shard_logged(model, mesh)
            kernels.reset_launches()
            logits = model(ids)[:, -1]
            torch.cuda.synchronize()
        launches = nonzero(kernels.LAUNCHES)
        shapes, want_shapes = shard_shapes(model), family_tp2_shapes(cfg)
        # mistral's band keeps its prefill off B3
        want = {"bfp_linear": 4 * L + 1, **({"flash_attention": L} if family != "mistral" else {})}
        err = (logits.cpu() - ref[family, "weights"]["logits"]).abs().max().item()
        log(f"parallel rank {rank}: {family} {cfg.hidden_size}x{L} over tp {PAR_TP}: shard shapes "
            f"{shapes} (expected {want_shapes}); prefill launches {launches} (expected {want}); "
            f"last logits max_abs_err={err:.3g} against the unsharded card prefill (tolerance "
            f"{LOGIT_TOL})")
        if shapes != want_shapes or launches != want or not err <= LOGIT_TOL:
            raise AssertionError(f"rank {rank}: {family}'s sharded weights prefill is wrong")
        by_path[f"parallel_{family}_prefill"], out[f"{family}_prefill_err"] = launches, err
        del model
        torch.cuda.empty_cache()
    cfg = fc["whisper"]
    with torch.no_grad():
        model = build_family("whisper", cfg, dev, "weights")
        _, messages = shard_logged(model, mesh)
        kernels.reset_launches()
        toks, rows = whisper_run(torch, model, cfg, dev)
        torch.cuda.synchronize()
    launches = nonzero(kernels.LAUNCHES)
    r = ref["whisper", "weights"]
    cross = tuple(model.model.decoder.layers[0].encoder_attn.k_proj.weight_mantissa.shape)
    heads = {a.num_heads for a in model.modules() if hasattr(a, "num_heads")}
    head = tuple(model.proj_out.weight_mantissa.shape)
    vocab_logged = any("embed_tokens" in m and "vocabulary" in m for m in messages)
    err = (rows[0].cpu() - r["logits"]).abs().max().item()
    got = {i: t for i, t in enumerate(toks.cpu().tolist())}
    held = hold_tokens(f"parallel rank {rank} whisper", "the unsharded greedy loop", got,
                       {i: t for i, t in enumerate(r["tokens"].tolist())},
                       {i: m for i, m in enumerate(r["margins"].tolist())}, KV8_TOL)
    log(f"parallel rank {rank}: whisper-small {WHISPER_LAYERS} + {WHISPER_LAYERS} over tp "
        f"{PAR_TP}: heads {heads}, the cross K/V's shard {cross}, proj_out {head} (the vocabulary "
        f"of {cfg.vocab_size} replicated, logged: {vocab_logged}); launches {launches} (the "
        f"unsharded loop's {r['launches']}); the prefill's last logits max_abs_err={err:.3g} "
        f"(tolerance {LOGIT_TOL}), {held} tokens held")
    if (heads != {cfg.decoder_attention_heads // PAR_TP} or cross != (cfg.d_model // PAR_TP,
                                                                    cfg.d_model)
            or head != (cfg.vocab_size, cfg.d_model) or not vocab_logged
            or launches != r["launches"] or not err <= LOGIT_TOL):
        raise AssertionError(f"rank {rank}: whisper-small over tp {PAR_TP} is wrong")
    by_path["parallel_whisper"], out["whisper_prefill_err"] = launches, err
    del model
    for family, mode in (("t5", "weights"), ("lenet", "basic")):
        cfg = fc.get(family)
        with torch.no_grad():
            model = build_family(family, cfg, dev, mode)
            placement, messages = shard_logged(model, mesh)
            x = replicated_inputs(torch, family, cfg, dev)
            kernels.reset_launches()
            logits = model(*x)
            torch.cuda.synchronize()
        launches = nonzero(kernels.LAUNCHES)
        sharded = sorted({k.rsplit(".", 1)[0] for k, v in placement.items() if any(v)})
        r = ref[family, mode]
        err = (logits.cpu() - r["logits"]).abs().max().item()
        # t5: only the table and its tied head shard; LeNet-5 not at all
        want_sharded = (["decoder.embed_tokens", "encoder.embed_tokens", "lm_head", "shared"]
                        if family == "t5" else [])
        log(f"parallel rank {rank}: {family} {mode} over tp {PAR_TP}: sharded {sharded} "
            f"(expected {want_sharded}), logged {messages[:2]}; launches {launches} (the "
            f"unsharded forward's {r['launches']}); logits max_abs_err={err:.3g} against the "
            f"unsharded card forward (tolerance {LOGIT_TOL if family == 't5' else 0})")
        if (sharded != want_sharded or launches != r["launches"]
                or not err <= (LOGIT_TOL if family == "t5" else 0.0)):
            raise AssertionError(f"rank {rank}: {family} over tp {PAR_TP} is wrong")
        by_path[f"parallel_{family}"], out[f"{family}_err"] = launches, err
        del model
    torch.cuda.empty_cache()
    return by_path, out


def wait_for(path):
    """Waits until ``path`` exists (the parent writes it whole, by a
    rename); the parent ends the rank if it waits past PAR_TIMEOUT."""
    while not os.path.exists(path):
        time.sleep(0.2)
    return path


def _parallel_body(torch, dist, rank, tmp, card, full_cfg, dev):
    import dataclasses

    from dmx_compressor_tpu_torch import kernels
    from dmx_compressor_tpu_torch.examples import scaling_bench
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.ops.compress import build_basic_mode, build_weights_mode
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state
    from dmx_compressor_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    # OPT-125m's tp paths at PAR_OPT_LAYERS, its pipeline at full depth
    cfg = dataclasses.replace(full_cfg, num_hidden_layers=PAR_OPT_LAYERS)
    L, d, f = cfg.num_hidden_layers, cfg.hidden_size, cfg.ffn_dim
    # the parent computes the unsharded references while the ranks start
    ref = torch.load(wait_for(os.path.join(tmp, "ref.pt")), weights_only=False)
    ids = parallel_prompt_ids(torch, cfg, dev)
    mesh = make_mesh((1, PAR_TP), ("dp", "tp"), device_type=dev.type)
    out, by_path = {}, {}

    # weights mode over tp 2: the prefill's logits and launches, the engine
    t0 = time.perf_counter()
    with torch.no_grad():
        model = OPTForCausalLM(cfg, device=dev, seed=0)
        build_weights_mode(model)
        placement = shard_state(model, mesh)
    attn = model.model.decoder.layers[0].self_attn
    shapes = {"qkv_merged": tuple(attn.qkv_merged.weight_mantissa.shape),
              "out_proj": tuple(attn.out_proj.weight_mantissa.shape),
              "fc1": tuple(model.model.decoder.layers[0].fc1.weight_mantissa.shape),
              "fc2": tuple(model.model.decoder.layers[0].fc2.weight_mantissa.shape),
              "lm_head": tuple(model.lm_head.weight_mantissa.shape), "heads": attn.num_heads}
    want_shapes = {"qkv_merged": (3 * d // PAR_TP, d), "out_proj": (d, d // PAR_TP),
                   "fc1": (f // PAR_TP, d), "fc2": (d, f // PAR_TP),
                   "lm_head": (cfg.vocab_size // PAR_TP, d),
                   "heads": cfg.num_attention_heads // PAR_TP}
    log(f"parallel rank {rank}: OPT {d}x{L} weights mode sharded tp {PAR_TP} in "
        f"{time.perf_counter() - t0:.2f} s; {sum(any(p) for p in placement.values())} sharded "
        f"keys; shard shapes {shapes}")
    if shapes != want_shapes:
        raise AssertionError(f"rank {rank}: shard shapes {shapes}, expected {want_shapes}")
    with torch.no_grad():
        caches = model.init_cache(BATCH, CAPACITY, quantized=True, device=dev)
        kernels.reset_launches()
        logits = model(ids, caches=caches, position_offset=0)[:, -1]
        torch.cuda.synchronize()
    launches = nonzero(kernels.LAUNCHES)
    want = {"bfp_linear": 4 * L + 1, "flash_attention": L}
    err = (logits.cpu() - ref["weights_logits"]).abs().max().item()
    log(f"parallel rank {rank}: the sharded prefill's launches {launches} (expected {want}); "
        f"last logits max_abs_err={err:.3g} against the unsharded card prefill "
        f"(tolerance {LOGIT_TOL})")
    if launches != want or not err <= LOGIT_TOL:
        raise AssertionError(f"rank {rank}: the sharded weights prefill is wrong")
    del caches
    by_path["parallel_engine"], out["engine"] = _rank_engine(
        torch, kernels, dist, model, cfg, ref, rank, card, parallel_requests(cfg))
    out["weights_prefill_err"] = err

    # the sharded checkpoint: save, restore into a model of other weights
    # sharded the same way, the greedy tokens bit for bit
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(tmp, "ckpt"), model, step=3)
    with torch.no_grad():
        other = OPTForCausalLM(cfg, device=dev, seed=1)
        build_weights_mode(other)
        shard_state(other, mesh)
    step, _ = restore_checkpoint(os.path.join(tmp, "ckpt"), other)
    a, b = _greedy(torch, model, ids, PAR_CKPT_STEPS), _greedy(torch, other, ids, PAR_CKPT_STEPS)
    log(f"parallel rank {rank}: sharded checkpoint saved and restored (step {step}) in "
        f"{time.perf_counter() - t0:.2f} s; {a.numel()} greedy tokens "
        f"{'equal' if torch.equal(a, b) else 'DIFFER'}")
    if step != 3 or not torch.equal(a, b):
        raise AssertionError(f"rank {rank}: the sharded checkpoint did not restore the model")
    del model, other
    torch.cuda.empty_cache()

    # BASIC over tp 2: the forward's last logits and T1 / T2 launches
    with torch.no_grad():
        model = OPTForCausalLM(cfg, device=dev, seed=0)
        build_basic_mode(model)
        shard_state(model, mesh)
        kernels.reset_launches()
        logits = model(ids)[:, -1]
        torch.cuda.synchronize()
    launches = nonzero(kernels.LAUNCHES)
    err = (logits.cpu() - ref["basic_logits"]).abs().max().item()
    log(f"parallel rank {rank}: the sharded BASIC forward's launches {launches} (the unsharded "
        f"forward's {ref['basic_launches']}); last logits max_abs_err={err:.3g} against the "
        f"unsharded card forward (tolerance {BASIC_LOGIT_TOL})")
    if launches != ref["basic_launches"] or not err <= BASIC_LOGIT_TOL:
        raise AssertionError(f"rank {rank}: the sharded BASIC forward is wrong")
    by_path["parallel_basic"], out["basic_err"] = launches, err
    del model
    torch.cuda.empty_cache()

    # the Llama topology, Whisper, T5 and LeNet-5 over the same tp 2
    for part in (_rank_llama(torch, dist, kernels, rank, tmp, card, dev, mesh, ref["families"]),
                 _rank_families(torch, dist, kernels, rank, dev, mesh, ref["families"])):
        by_path.update(part[0])
        out.update(part[1])

    by_path["parallel_pipeline"], out["pipeline"] = _rank_pipeline(torch, kernels, dev,
                                                                   full_cfg, rank)
    torch.cuda.empty_cache()
    out["ring"] = _rank_ring(torch, dev, rank)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["scaling"] = scaling_bench.run_shapes(SCALING_SHAPES, cfg, dev, batch=BATCH, seq=PROMPT)
    log(f"parallel rank {rank}: scaling_bench {SCALING_SHAPES} in "
        f"{time.perf_counter() - t0:.1f} s: {json.dumps(out['scaling'])}")
    return by_path, out


def parallel_rank(rank, world, tmp, card, cfg, consts, setup=None):
    """One rank of the parallel phase's world (gloo, every rank on the one
    card): the parent's sizes ``consts`` (module constants), its results to
    ``rank<r>.pt``; a failure raises, so the spawn fails.  ``setup`` (None
    on the card) runs first: a CPU rehearsal's stubs and counters."""
    import torch
    import torch.distributed as dist

    globals().update(consts)
    if setup is not None:
        setup()
    dev = torch.device(consts.get("PAR_DEVICE", "cuda"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        by_path, out = _parallel_body(torch, dist, rank, tmp, card, cfg, dev)
        torch.save({"by_path": by_path, "out": out}, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def nccl_world1(torch, dev, kernels, cfg, tmp):
    """One NCCL group of world 1 through the tp code path at (1, 1): OPT-125m
    weights mode sharded over a one-rank tp axis (every collective runs on
    the card through NCCL) against the same model unsharded."""
    import os

    import torch.distributed as dist

    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state
    from dmx_compressor_tpu_torch.parallel.comm import stages_through_host

    ids = parallel_prompt_ids(torch, cfg, dev)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
                            rank=0, world_size=1)
    try:
        with torch.no_grad():
            plain = OPTForCausalLM(cfg, device=dev, seed=0)
            build_weights_mode(plain)
            a = _greedy(torch, plain, ids, PAR_CKPT_STEPS)
            del plain
            model = OPTForCausalLM(cfg, device=dev, seed=0)
            build_weights_mode(model)
            mesh = make_mesh((1, 1), ("dp", "tp"))
            shard_state(model, mesh)
            group = mesh.get_group("tp")
            kernels.reset_launches()
            b = _greedy(torch, model, ids, PAR_CKPT_STEPS)
            launches = nonzero(kernels.LAUNCHES)
        backend = dist.get_backend(group)
        log(f"nccl world 1: backend {backend}, mesh {mesh.device_type} (1, 1), staged through the "
            f"host: {stages_through_host(ids.float(), group)}; {a.numel()} greedy tokens "
            f"{'equal' if torch.equal(a, b) else 'DIFFER'} to the unsharded model's; "
            f"launches {launches}")
        if backend != "nccl" or not torch.equal(a, b) or mesh.device_type != "cuda":
            raise AssertionError("the tp code path over one NCCL rank is wrong")
        return launches
    finally:
        dist.destroy_process_group()


NCCL_PROBE_TIMEOUT = 120  # seconds the two-rank NCCL probe may take to raise


def nccl_two_ranks_rank(rank, world, tmp, address):
    """One of two NCCL ranks on the one card, through the port's own entry
    points (``parallel.initialize`` with ``backend="nccl"``, ``make_mesh``,
    ``comm.all_reduce``): the group must stay NCCL and its first collective
    must raise (NCCL refuses two ranks on one device); the backend and what
    was raised go to ``nccl<r>.txt``."""
    import torch
    import torch.distributed as dist

    from dmx_compressor_tpu_torch.parallel import comm, initialize, make_mesh

    torch.cuda.set_device(0)
    initialize(address, world, rank, backend="nccl")
    msg = f"backend {dist.get_backend()}: "
    try:
        mesh = make_mesh((world,), ("tp",))
        comm.all_reduce(torch.ones(4, device="cuda"), mesh.get_group("tp"))
        torch.cuda.synchronize()
        msg += "no error"
    except Exception as e:  # recorded; the parent accepts only NCCL's refusal
        msg += f"raised {type(e).__name__}: {str(e).splitlines()[0][:200]}"
    with open(os.path.join(tmp, f"nccl{rank}.txt"), "w") as f:
        f.write(msg)


def nccl_refused(msg: str) -> bool:
    """``msg`` (a probe rank's) is NCCL's refusal of two ranks on one card,
    raised by a group that stayed NCCL."""
    return (msg.startswith("backend nccl: raised DistBackendError")
            and ("invalid usage" in msg or "Duplicate GPU" in msg))


def start_nccl_two_ranks(tmp):
    """Spawns the two NCCL probe ranks (:func:`nccl_two_ranks_rank`); they
    run beside the gloo world.  Returns (their context, the deadline by
    which both must have raised)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:  # a free port for the rendezvous
        sock.bind(("localhost", 0))
        address = f"localhost:{sock.getsockname()[1]}"
    ctx = mp.start_processes(nccl_two_ranks_rank, args=(2, tmp, address), nprocs=2,
                             join=False, start_method="spawn")
    return ctx, time.monotonic() + NCCL_PROBE_TIMEOUT


def join_world(ctx, deadline, what):
    """Joins a spawned world; kills its processes and raises if it runs past
    ``deadline``, raises a rank's failure as the spawn context does."""
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            kill_world(ctx)
            raise AssertionError(f"{what} hung past its time limit")


def kill_world(ctx):
    for p in ctx.processes:
        if p.is_alive():
            p.kill()


def nccl_two_ranks(tmp, probe):
    """NCCL with two ranks on one card raises NCCL's own error, and the port
    does not switch to gloo: both ranks' first collective (``probe``, from
    :func:`start_nccl_two_ranks`) must fail so within NCCL_PROBE_TIMEOUT."""
    join_world(*probe, "NCCL with two ranks on one card (instead of raising)")
    msgs = [open(os.path.join(tmp, f"nccl{r}.txt")).read() for r in range(2)]
    log(f"nccl with two ranks on one card: {msgs}")
    if not all(nccl_refused(m) for m in msgs):
        raise AssertionError("NCCL with two ranks on one card did not raise NCCL's refusal")
    return msgs


def parallel_phase(torch, dev, kernels, cfg, card, setup=None):
    """OPT-125m (full width, PAR_OPT_LAYERS layers) over PAR_RANKS ranks
    sharing the card (gloo, collectives of CUDA tensors through host
    memory): the weights path's prefill and engine at tp 2, the sharded
    checkpoint, the BASIC forward at tp 2; TinyLlama-1.1B the same way at full width and depth,
    gemma-2b, qwen3-0.6b and mistral-1b prefills at full width, whisper-small,
    t5-small and LeNet-5 (_rank_llama, _rank_families); pipeline_forward at
    pp 2, ring_attention at sp 2 and scaling_bench; then one NCCL rank
    through the tp path, and two NCCL ranks on the card, which must raise.  Every rank holds
    its own checks and counts its own launches; a rank that fails or hangs
    past PAR_TIMEOUT fails the phase.  Returns the launches by path and
    rank, and the numbers.  The NCCL probe's ranks and the gloo world start
    first, and the parent computes the references while they start up."""
    import dataclasses
    import tempfile

    import torch.multiprocessing as mp

    ocfg = dataclasses.replace(cfg, num_hidden_layers=PAR_OPT_LAYERS)
    requests = parallel_requests(ocfg)
    capacity = PROMPT + max(g for _, g in requests) + PAR_BURST  # make_engine's max_len
    by_path, numbers, worlds = {}, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            probe = start_nccl_two_ranks(tmp) if dev.type == "cuda" else None
            worlds += [probe[0]] if probe else []
            t0 = time.perf_counter()
            consts = {k: globals()[k] for k in ("BATCH", "PROMPT", "GEN", "CAPACITY", "RING",
                                                "SCALING_SHAPES", "PAR_OPT_LAYERS")}
            consts["PAR_DEVICE"] = dev.type
            ctx = mp.start_processes(parallel_rank,
                                     args=(PAR_RANKS, tmp, card, cfg, consts, setup),
                                     nprocs=PAR_RANKS, join=False, start_method="spawn")
            worlds.append(ctx)
            deadline = time.monotonic() + PAR_TIMEOUT
            t1 = time.perf_counter()
            ref = parallel_references(torch, dev, kernels, ocfg, capacity)
            ref["families"] = family_references(torch, dev, kernels,
                                                PROMPT + PAR_LLAMA_GEN + PAR_LLAMA_BURST)
            torch.save(ref, os.path.join(tmp, "ref.part"))
            os.replace(os.path.join(tmp, "ref.part"), os.path.join(tmp, "ref.pt"))
            log(f"parallel: the unsharded references on the card in "
                f"{time.perf_counter() - t1:.1f} s; prefill launches {ref['weights_launches']}, "
                f"BASIC forward {ref['basic_launches']}; "
                + "; ".join(f"{f} {m} {r['launches']}" for (f, m), r in ref["families"].items()))
            join_world(ctx, deadline, "the parallel world")
            log(f"parallel: {PAR_RANKS} ranks ran in {time.perf_counter() - t0:.1f} s")
            for r in range(PAR_RANKS):
                res = torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for name, n in res["by_path"].items():
                    by_path[f"{name}_rank{r}"] = n
                numbers[f"rank{r}"] = res["out"]
            by_path["parallel_nccl_world1"] = nccl_world1(torch, dev, kernels, ocfg, tmp)
            if probe:
                numbers["nccl_two_ranks"] = nccl_two_ranks(tmp, probe)
        finally:
            for w in worlds:
                kill_world(w)
    return by_path, numbers


def native_phase(torch, dev, kernels):
    """The native C++ oracle (csrc/dmxq.cpp, built here with g++): T2's
    BFP16_64 cast on the card (magnitudes over 16 decades, a zero row, a
    row of subnormal blocks) and the port's bfp_pack of a card tensor, bit
    for bit.  No oracle fails the phase."""
    import numpy as np

    from dmx_compressor_tpu_torch import native
    from dmx_compressor_tpu_torch.ops import bfp_cast as T2
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, bfp_unpack

    t0 = time.perf_counter()
    if not native.is_available():
        raise AssertionError("the native oracle could not be built with g++")
    log(f"native: oracle built in {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device=dev).manual_seed(50)
    x = torch.randn(BATCH * PROMPT, 768, generator=g, device=dev)
    x *= torch.logspace(-8, 8, x.shape[0], device=dev)[:, None]
    x[0] = 0.0
    x[1, ::3] = 1e-40  # subnormal blocks
    kernels.reset_launches()
    got = T2.bfp_cast(x, 8, 64)
    xc = x.cpu().numpy()
    want = native.block_quantize_nearest(xc.reshape(-1, 64), 8).reshape(xc.shape)
    bfp_same = np.array_equal(got.cpu().numpy(), want)
    torch.cuda.synchronize()
    launches = nonzero(kernels.LAUNCHES)
    w = torch.randn(768, 3072, generator=g, device=dev) * 0.05
    p = bfp_pack(w, 8, 64)
    man, exp = native.bfp_pack(w.cpu().numpy(), 8, 64)
    pack_same = (np.array_equal(p.mantissa.cpu().numpy(), man)
                 and np.array_equal(p.exponent.cpu().numpy(), exp)
                 and np.array_equal(bfp_unpack(p).cpu().numpy(), native.bfp_unpack(man, exp, 8,
                                                                                    64)))
    log(f"native: T2 BFP16_64 cast of {tuple(x.shape)} on the card {'=' if bfp_same else '!='} "
        f"the oracle bit for bit; bfp_pack of a card [768, 3072] {'=' if pack_same else '!='} "
        f"the oracle's payload and unpacking; launches {launches}")
    if not (bfp_same and pack_same) or launches != {"bfp_cast": 1}:
        raise AssertionError("the card disagrees with the native oracle")
    return launches


@contextlib.contextmanager
def phase(name: str, seconds: dict):
    """Log and record the wall seconds of one phase of the run (the whole
    script has 1200 s)."""
    t0 = time.perf_counter()
    yield
    seconds[name] = round(time.perf_counter() - t0, 1)
    log(f"phase {name}: {seconds[name]} s")


def main(argv=None) -> int:
    import dataclasses

    import torch

    argv = sys.argv[1:] if argv is None else argv
    only = set()
    if argv:
        if len(argv) != 2 or argv[0] != "--only":
            print("usage: chip_smoke.py [--only word,word,...]  (runs the phases whose name, "
                  "spaces as underscores, holds a word; no kernels line)", file=sys.stderr)
            return 2
        only = {w for w in argv[1].split(",") if w}

    def run(name):
        return not only or any(w in name.replace(" ", "_") for w in only)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from dmx_compressor_tpu_torch import kernels
    from dmx_compressor_tpu_torch.models.clip import CLIPConfig
    from dmx_compressor_tpu_torch.models.gemma import GemmaConfig
    from dmx_compressor_tpu_torch.models.gpt2 import GPT2Config
    from dmx_compressor_tpu_torch.models.llama import LlamaConfig
    from dmx_compressor_tpu_torch.models.mistral import MistralConfig
    from dmx_compressor_tpu_torch.models.opt import OPTConfig
    from dmx_compressor_tpu_torch.models.qwen3 import Qwen3Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    log(card)
    # the profiler's first trace (CUPTI's start: ~8 s) runs while nvcc builds
    first_trace = threading.Thread(target=device_trace,
                                   args=(torch, lambda: torch.ones(1, device=dev).add_(1)))
    first_trace.start()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
        f"device count {torch.cuda.device_count()}" + (f"; only {sorted(only)}" if only else ""))

    t0, took = time.perf_counter(), {}
    seconds = kernels.build()
    first_trace.join()
    took_build = time.perf_counter() - t0
    log(f"kernels built in {took_build:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())})")
    for name in kernels.SIGNATURES:
        build_log = kernels.BUILD_DIR / f"{name}.log"
        for ln in build_log.read_text().splitlines() if build_log.exists() else []:
            if "Used" in ln or "spill" in ln:
                log(f"  ptxas {name}: {ln.strip()}")

    cfg = OPTConfig.opt_125m()
    # bench.py's Llama-topology families at full width and depth
    fams = {"llama": LlamaConfig.llama_1_1b(), "qwen3": Qwen3Config.qwen3_0_6b(),
            "gemma": GemmaConfig.gemma_2b()}
    # bench.py's gpt2 (GPT-2 124M, full width and depth) and mistral-1b (its
    # sliding window of 128 active within the 192 tokens: no attention
    # kernel on its paths, so it stays out of the B2-B4 phases)
    gcfg, mcfg = GPT2Config.gpt2(), MistralConfig.mistral_1b()
    linear_shapes_of = {**{f: family_linear_shapes(c) for f, c in fams.items()},
                        "mistral": family_linear_shapes(mcfg), "gpt2": gpt2_linear_shapes(gcfg)}
    # the sbfp paths' B5 shapes: q/k/v and gate/up unmerged (GPT-2's c_attn
    # born merged: its B1 shapes)
    sbfp_shapes_of = {**{f: family_sbfp_linear_shapes(c) for f, c in fams.items()},
                      "mistral": family_sbfp_linear_shapes(mcfg),
                      "gpt2": gpt2_linear_shapes(gcfg)}
    s2s = seq2seq_configs()  # t5-small, whisper-small
    # the paths' configs: t5-small and whisper-small cut to T5_LAYERS and
    # WHISPER_LAYERS a stack
    s2s_run = {f: seq2seq_layers(c, f, WHISPER_LAYERS if f == "whisper" else T5_LAYERS)
               for f, c in s2s.items()}
    clip_cfg = CLIPConfig.vit_b_32()
    results = {}
    for name, check in (("B1", lambda: check_b1(torch, dev, cfg)),
                        ("B2", lambda: check_b2(torch, dev, cfg, fams, s2s["whisper"])),
                        ("B3", lambda: check_b3(torch, dev, cfg, fams, s2s["whisper"])),
                        ("B3 wgmma", lambda: check_b3_wgmma(torch, dev, kernels)),
                        ("B4", lambda: check_b4(torch, dev, cfg, fams, s2s["whisper"])),
                        ("B5", lambda: check_b5(torch, dev, cfg)),
                        ("T1", lambda: check_t1(torch, dev, cfg)),
                        ("T2", lambda: check_t2(torch, dev, cfg))):
        if run(name):
            with phase(name, took):
                results[name] = check()
    fam_linears = {}  # family -> ((B1 step, cases), (T1 step, cases), (B5 step, cases))
    for seed, (family, shapes) in zip((22, 24, 26, 28, 30), linear_shapes_of.items()):
        # GPT-2's head (N 50257) also at a ragged M; B5 at a ragged M over
        # each family's longest K (its down_proj: Gemma's 16384)
        ragged = [(3, gcfg.n_embd, gcfg.vocab_size)] if family == "gpt2" else []
        K, N, _ = max(sbfp_shapes_of[family], key=lambda s: s[0])
        name = f"B1, T1 and B5 at the {family} shapes"
        if run(name):
            with phase(name, took):
                fam_linears[family] = check_family_linears(
                    torch, dev, shapes, sbfp_shapes_of[family], family, seed, ragged,
                    ragged + [(130, K, N)])
    s2s_linears = {}  # family -> ((B1 step, cases), (T1 step, cases), (B5 step, cases))
    for seed, (family, scfg) in zip((32, 34), s2s_run.items()):
        name = f"B1, T1 and B5 at the {family} shapes"
        if run(name):
            with phase(name, took):
                s2s_linears[family] = check_seq2seq_linears(torch, dev, scfg, family, seed)
    if run("B1, T1 and B5 at the clip shapes"):
        with phase("B1, T1 and B5 at the clip shapes", took):
            s2s_linears["clip"] = check_clip_linears(torch, dev, clip_cfg, 36)
    b1_tp2 = None  # (one decode step of a tp-2 rank, the cases)
    if run("B1 at the parallel tp2 shard shapes"):
        with phase("B1 at the parallel tp2 shard shapes", took):
            b1_tp2 = check_b1_tp2(torch, dev, cfg)

    # model_api's compiled() check compiles with Inductor in a process of its
    # own while the serving paths run
    compiled = start_compiled_check(dev) if run("model_api") else None
    by_path, tok_s = {}, {}
    fam_t2 = {}  # family or path -> (T2's per-step numbers, cases) at its recorded sites
    for spec in path_specs(cfg):
        name = spec["name"]
        if not run(f"{name} path"):
            continue
        with phase(f"{name} path", took):
            by_path[name], tok_s[name] = serve_path(torch, dev, kernels, cfg, spec)
        log(f"{name} path: decode {tok_s[name]:.1f} tokens/s on {card}")
        if spec.get("record_t2"):
            with phase(f"T2 at the {name} sites", took):
                fam_t2[name] = check_t2_sites(torch, dev, spec["t2_sites"], spec["t2_step"],
                                              name)
    if "baseline" in tok_s:
        log(f"bench.py's ratio, for information (host clock, batch {BATCH}, {card}): "
            + ", ".join(f"{m} / baseline {tok_s[m] / tok_s['baseline']:.4f}"
                        for m in ("weights", "sbfp", "sbfp_wide", "basic", "fp8") if m in tok_s))
    kv_repeat_ms = {c["path"]: c["repeat_ms"] for c in results.get("B3", ()) if "repeat_ms" in c}
    gcut = dataclasses.replace(gcfg, n_layer=GPT2_LAYERS)
    cut = {f: dataclasses.replace(c, num_hidden_layers=FAMILY_PATH_LAYERS)
           for f, c in {**fams, "mistral": mcfg}.items()}
    fam_paths = {**{f: (cut[f], family_path_specs(cut[f], f)) for f in fams},
                 "gpt2": (gcut, gpt2_path_specs(gcut)),
                 "mistral": (cut["mistral"], family_path_specs(cut["mistral"], "mistral")),
                 **{f: (c, seq2seq_path_specs(c, f)) for f, c in s2s_run.items()}}
    for family, (fcfg, specs) in fam_paths.items():
        for spec in specs:
            name = spec["name"]
            if not run(f"{name} path"):
                continue
            if "flash_attention" in spec["prefill"] and family in kv_repeat_ms:
                spec["kv_repeat_ms"] = kv_repeat_ms[family]
            with phase(f"{name} path", took):
                by_path[name], tok_s[name] = serve_path(torch, dev, kernels, fcfg, spec)
            log(f"{name} path: decode {tok_s[name]:.1f} tokens/s on {card}")
            if spec.get("record_t2"):
                with phase(f"T2 at the {name} sites", took):
                    fam_t2[family] = check_t2_sites(torch, dev, spec["t2_sites"],
                                                    spec["t2_step"], name,
                                                    spec.get("t2_steps", STEP_ITERS))
        if f"{family}_baseline" in tok_s:
            log(f"bench.py's ratio for the {family} family, for information (host clock, batch "
                f"{BATCH}, {card}): " + ", ".join(
                    f"{m} / baseline {tok_s[f'{family}_{m}'] / tok_s[f'{family}_baseline']:.4f}"
                    for m in ("weights", "sbfp", "basic") if f"{family}_{m}" in tok_s))
    vision = {}  # path -> its numbers
    for spec in clip_path_specs():
        name = spec["name"]
        if not run(f"{name} path"):
            continue
        with phase(f"{name} path", took):
            by_path[name], vision[name] = clip_path(torch, dev, kernels, clip_cfg, spec)
        if spec.get("record_t2"):
            with phase(f"T2 at the {name} sites", took):
                fam_t2["clip"] = check_t2_sites(torch, dev, spec["t2_sites"], spec["t2_sites"],
                                                name, CLIP_T2_TIMED, unit="forward")
    for spec in lenet_path_specs():
        name = spec["name"]
        if not run(f"{name} path"):
            continue
        with phase(f"{name} path", took):
            by_path[name], vision[name] = lenet_path(torch, dev, kernels, spec)
    if run("zoo"):
        with phase("zoo", took):
            by_path["zoo_basic"] = zoo_phase(torch, dev, kernels)
    if vision:
        log(f"the vision paths on {card}: {json.dumps(vision)}")

    # phase 7: the PTQ recipes
    cfg_cut = dataclasses.replace(cfg, num_hidden_layers=FAMILY_CPU_LAYERS)
    if run("recipes"):
        with phase("recipes", took):
            by_path["recipes"], _ = recipes_phase(torch, dev, kernels, cfg)
    if run("ptq_weights path"):
        ptq_stats, ptq_w = {}, {}
        with phase("ptq_weights path", took):
            by_path["ptq_weights"], tok_s["ptq_weights"] = serve_path(
                torch, dev, kernels, cfg, ptq_spec(cfg, ptq_stats, ptq_w))
        want = ptq_recipe_launches(cfg)
        log(f"ptq_weights path on {card}: decode {tok_s['ptq_weights']:.1f} tokens/s; "
            f"{ptq_stats['payloads_held']} payloads unpack to their GPTQ weights bit for bit; "
            + "; ".join(f"{k}: {v['seconds']} s, peak device memory {v['peak_gib']} GiB, "
                        f"launches {v['launches']} (expected {want[k]})"
                        for k, v in ptq_stats.items() if k in want))
        if any(ptq_stats[k]["launches"] != want[k] for k in want):
            raise AssertionError("the ptq_weights recipes did not launch the kernels the "
                                 "expected number of times")
        by_path["ptq_recipes"] = {k: sum(ptq_stats[r]["launches"].get(k, 0) for r in want)
                                  for k in kernels.LAUNCHES}
        with phase("ptq recipe parity", took):
            ptq_recipe_parity(torch, dev, kernels, cfg_cut)
    if run("calib_basic path"):
        with phase("calib_basic path", took):
            by_path["calib_basic"] = calib_basic_path(
                torch, dev, kernels, dataclasses.replace(cfg, num_hidden_layers=CALIB_LAYERS),
                cfg_cut)
    if run("int8kv_example path"):
        with phase("int8kv_example path", took):
            by_path["int8kv_example"] = int8kv_path(torch, dev, kernels, cfg)

    if run("engine paths"):
        with phase("engine paths", took):
            by_path.update(engine_paths(torch, dev, kernels, cfg, card))
    if run("engine_llama_weights path"):
        with phase("engine_llama_weights path", took):
            by_path["engine_llama_weights"] = engine_family_path(torch, dev, kernels,
                                                                 fams["llama"], card)
    for family, scfg in s2s_run.items():
        name = f"engine_{family}_weights"
        if run(f"{name} path"):
            with phase(f"{name} path", took):
                by_path[name] = engine_seq2seq_path(torch, dev, kernels, scfg, family, card)
    # phase 8: QAT, the model API and the benchmarking examples
    every = dict.fromkeys(kernels.LAUNCHES, 0)
    qat = None
    if run("qat_basic path"):
        with phase("qat_basic path", took):
            launched, qat = qat_basic_path(torch, dev, kernels, cfg)
        by_path["qat_basic"] = {**every, **launched}
        log(f"qat_basic path on {card}: {json.dumps(qat)}")
    if run("model_api"):
        with phase("model_api", took):
            by_path["model_api"] = {**every, **model_api_phase(torch, dev, kernels, cfg,
                                                               compiled)}
    if run("benchmarking_examples"):
        with phase("benchmarking_examples", took):
            bench, bench_modes = benchmarking_phase(torch, dev, kernels, cfg)
        by_path.update({name: {**every, **n} for name, n in bench.items()})
        log(f"the benchmarking examples' launches of one runner call by mode on {card}: "
            f"{json.dumps(bench_modes)}")

    # phase 9: HF checkpoints, the pipeline and training checkpoints
    hd80 = []
    if run("hf_pipeline path"):
        with phase("hf_pipeline path", took):
            launched, hf_numbers = hf_pipeline_path(torch, dev, kernels)
        by_path["hf_pipeline"] = {**every, **launched}
        log(f"hf_pipeline path on {card}: {json.dumps(hf_numbers)}")
    if run("hf_head_dim80 path"):
        with phase("hf_head_dim80 path", took):
            launched, hd80_numbers = hf_head_dim80_path(torch, dev, kernels)
        by_path["hf_head_dim80"] = {**every, **launched}
        hd80 = hd80_numbers["cases"]
        log(f"hf_head_dim80 path on {card}: {json.dumps(hd80_numbers)}")
    if run("checkpoint_resume path"):
        with phase("checkpoint_resume path", took):
            launched, ckpt_numbers = checkpoint_resume_path(torch, dev, kernels, cfg)
        by_path["checkpoint_resume"] = {**every, **launched}
        log(f"checkpoint_resume path on {card}: {json.dumps(ckpt_numbers)}")

    # phase 10: the export path and functional interception
    if run("export"):
        with phase("export", took):
            launched, export_numbers = export_phase(torch, dev, kernels, cfg)
        by_path["export"] = {**every, **launched}
        log(f"export phase on {card}: {json.dumps(export_numbers)}")
    if run("intercept"):
        with phase("intercept", took):
            launched, intercept_numbers = intercept_phase(torch, dev, kernels, cfg)
        by_path["intercept"] = {**every, **launched}
        log(f"intercept phase on {card}: {json.dumps(intercept_numbers)}")

    # phase 11: parallelism over ranks sharing the card, and the native oracle
    if run("parallel"):
        with phase("parallel", took):
            launched, par_numbers = parallel_phase(torch, dev, kernels, cfg, card)
        by_path.update({name: {**every, **n} for name, n in launched.items()})
        log(f"parallel phase on {card}: {json.dumps(par_numbers)}")
    if run("native"):
        with phase("native", took):
            by_path["native"] = {**every, **native_phase(torch, dev, kernels)}

    log(f"seconds by phase (after {took_build:.1f} s of kernel builds): {json.dumps(took)}")
    log(f"kernel builds and phases: {took_build + sum(took.values()):.1f} s")
    if only:
        log(f"launches by path: {json.dumps(by_path)}")
        return 0
    b1_step, b1 = results["B1"]
    b2, b3, b4 = results["B2"], results["B3"], results["B4"]
    b5_step, b5, b5_wide_step = results["B5"]
    t1_step, t1, t1_flush = results["T1"]
    t2_step, t2 = results["T2"]

    def launches(kern):
        """The kernel's launches over the paths' runs, in all and per path."""
        per = {p: n[kern] for p, n in by_path.items() if n[kern]}
        return dict(launches=sum(per.values()), launches_by_path=per)

    hd80_of = {k: [c for c in hd80 if c["kernel"] == k]
               for k in ("flash_attention", "flash_decode", "flash_decode_int8")}

    def top(cases):
        return {k: cases[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}

    # top-level times: B1, B5, T1 and T2 per launch over one decode step's
    # launches (B5's on the sbfp path, its tensor-core route; its f32 route's
    # over a sbfp_wide step under f32_route_step; B1's, T1's and T2's over a
    # step of each Llama-topology family under <family>_step), B2, B3 and B4
    # at their OPT path's shape (their first case)
    b1_fam = [c for f in fam_linears for c in fam_linears[f][0][1]]
    b1_fam += [c for f in s2s_linears for c in s2s_linears[f][0][1]]
    t1_fam = [c for f in fam_linears for c in fam_linears[f][1][1]]
    t1_fam += [c for f in s2s_linears for c in s2s_linears[f][1][1]]
    b5_fam = [c for f in fam_linears for c in fam_linears[f][2][1]]
    b5_fam += [c for f in s2s_linears for c in s2s_linears[f][2][1]]
    t2_fam = [c for f in fam_t2 for c in fam_t2[f][1]]
    entries = [
        dict(name="bfp_linear", route="cuda", source="dmx_compressor_tpu_torch/csrc/bfp_linear.cu",
             replaces="dmx_compressor_tpu/ops/bfp_linear.py:53", **launches("bfp_linear"),
             max_abs_err=max(c["max_abs_err"] for c in b1 + b1_fam + b1_tp2[1]), **b1_step,
             **{f"{f}_step": fam_linears[f][0][0] for f in fam_linears},
             **{f"{f}_step": s2s_linears[f][0][0] for f in s2s_linears},
             parallel_tp2_step=b1_tp2[0]["opt"],
             **{f"parallel_{f}_tp2_step": st for f, st in b1_tp2[0].items() if f != "opt"},
             cases=b1 + b1_fam + b1_tp2[1]),
        dict(name="flash_decode_int8", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/flash_decode_int8.cu",
             replaces="dmx_compressor_tpu/ops/flash_decode.py:305",
             **launches("flash_decode_int8"),
             max_abs_err=max(c["max_abs_err"] for c in b2 + hd80_of["flash_decode_int8"]),
             **top(b2), cases=b2, head_dim80=hd80_of["flash_decode_int8"]),
        dict(name="flash_attention", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/flash_attention.cu",
             replaces="dmx_compressor_tpu/ops/flash_attention.py:67",
             **launches("flash_attention"),
             max_abs_err=max(c["max_abs_err"] for c in b3 + hd80_of["flash_attention"]
                             + results["B3 wgmma"][:1]),
             **top(b3), cases=b3, head_dim80=hd80_of["flash_attention"],
             wgmma=results["B3 wgmma"]),
        dict(name="flash_decode", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/flash_decode.cu",
             replaces="dmx_compressor_tpu/ops/flash_decode.py:305",
             **launches("flash_decode"),
             max_abs_err=max(c["max_abs_err"] for c in b4 + hd80_of["flash_decode"]),
             **top(b4), cases=b4, head_dim80=hd80_of["flash_decode"]),
        dict(name="sbfp_linear", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/sbfp_linear.cu",
             replaces="dmx_compressor_tpu/ops/bfp_linear.py:199", **launches("sbfp_linear"),
             max_abs_err=max(c["max_abs_err"] for c in b5 + b5_fam), **b5_step,
             f32_route_step=b5_wide_step,
             **{f"{f}_step": fam_linears[f][2][0] for f in fam_linears},
             **{f"{f}_step": s2s_linears[f][2][0] for f in s2s_linears}, cases=b5 + b5_fam),
        dict(name="bfp_linear_bf16", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/bfp_linear_bf16.cu",
             replaces="tools/diag_bfpkernel_ab.py:30", **launches("bfp_linear_bf16"),
             max_abs_err=max(c["max_abs_err"] for c in t1 + t1_fam), **t1_step,
             **{f"{f}_step": fam_linears[f][1][0] for f in fam_linears},
             **{f"{f}_step": s2s_linears[f][1][0] for f in s2s_linears},
             subnormal_weights=t1_flush,
             cases=t1 + t1_fam),
        dict(name="bfp_cast", route="cuda", source="dmx_compressor_tpu_torch/csrc/bfp_cast.cu",
             replaces="tools/probe_fused_cast.py:9", **launches("bfp_cast"),
             max_abs_err=0.0, **t2_step, **{f"{f}_step": fam_t2[f][0] for f in fam_t2},
             qat_basic_step=qat,
             cases=t2 + t2_fam),
    ]
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
