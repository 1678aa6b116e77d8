#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dmx_compressor_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: the card's name and power limit (nvidia-smi), and the build of
   every kernel of ``dmx_compressor_tpu_torch/csrc`` (one nvcc per source,
   started together).
2. The seven kernels against their plain PyTorch versions on the card, at
   the paths' shapes and at ragged ones: max abs error against the stated
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
   kernel, an inner one; the eight probes).  B2 also at bench.py's long
   shape (S 2048, lengths 2016) and with GQA; B5 also on its f32 route, at
   the SBFP formats beyond SBFP12_16 that the JAX package serves (a 5-bit
   scale, blocks of 8 and 24), M = 8 and 1024.
3. Four serving paths of OPT-125m at full width from seeded random weights
   (seed 0), each a prefill of batch 8 x prompt 128 then 63 greedy decode
   steps, with the launch counters set to 0 just before and read just after
   (L = 12 layers):
   - weights mode (BFP16_64 packed weights, int8 KV cache): prefill
     4L+1 = 49 B1 + 12 B3, each decode step 49 B1 + 12 B2;
   - SBFP mode (SBFP12_16 packed weights, int8 KV cache): prefill
     6L+1 = 73 B5 + 12 B3, each decode step 73 B5 + 12 B2;
   - fp32 baseline (BASELINE rules, plain Linears, f32 KV cache): prefill
     12 B3, each decode step 12 B4;
   - BASIC mode (BFP16_64 casts on Linear and ActActMatMul inputs, FLOAT16
     module boundaries, the SOFTMAX and LAYER_NORM surrogates, packed
     BFP16_64 weights, a float16 split cache of 128 + 64 slots): prefill
     4L+1 = 49 T1 + 34L+6 = 414 T2, prepare_split_decode 2L = 24 T2, each
     decode step 49 T1 + 16L+3 = 195 T2 (19L+4 casts: 3L+1 launches are a
     FLOAT16 cast and the BFP cast of its output in one).
   Each path's prefill logits and first 8 greedy tokens are held against the
   same model moved to the CPU (``.to("cpu")``); each prints its decode
   tokens/s, the device time of one warm prefill (a second prefill call
   under torch.profiler, split into its packed linears' kernel, B3 and the
   rest), the device busy/idle split of a profiled decode step and a host
   cProfile of the same steps.  The JAX bench's ratios (weights, SBFP and
   basic over baseline tokens/s) follow.
4. A ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The script imports nothing of JAX and nothing of the JAX package.  Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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
B1_TOL = dict(rtol=1e-5, atol=1e-4)  # f32 sums of up to 3072 terms, another order
B2_TOL = dict(rtol=1e-5, atol=2e-5)
B3_TOL = dict(rtol=1e-5, atol=2e-5)
B4_TOL = dict(rtol=1e-5, atol=2e-5)
B5_TOL = dict(rtol=1e-5, atol=1e-4)  # as B1: exact weights, sums in another order
# (format, K, N) of SBFP weights beyond SBFP12_16 that the JAX package packs
# and serves, which B5 takes on its f32 route: a 5-bit scale (not exact in
# bf16) at OPT-125m's out_proj, blocks of 8 and 24
SBFP_OTHER_FORMATS = [("SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}", 768, 768),
                      ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{8}", 40, 48),
                      ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{24}", 72, 200)]
# B3's bf16 plane products per f32 product (csrc/flash_attention.cu)
B3_PLANE_PRODUCTS = 6
LINEAR_KERNELS = ("bfp_linear", "sbfp_linear", "bfp_linear_bf16")


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


def device_events(torch, run, calls: int = 0):
    """(name, device microseconds) of every device activity of ``run()``,
    from torch.profiler, the one timing source of this script.  The profiler
    now and then hands back an empty trace, or one that lost some of its
    kernels; an empty one, or with ``calls`` (``run`` makes that many calls
    that each launch the same kernels) one where a kernel's count is no
    multiple of ``calls``, is taken again, up to five times in all.  Returns
    the last non-empty trace (logged when it stayed uneven), empty if all
    five were."""
    from torch.profiler import ProfilerActivity, profile

    events = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        taken = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0]
        events = [(key, us) for key, us, _ in taken] or events
        if taken and not (calls and any(n % calls for _, _, n in taken)):
            return events
    if events:
        log(f"  (torch.profiler: no trace with every kernel {calls} times in five tries; "
            f"the last one is used)")
    return events


def time_ms(torch, fn, arg_sets, min_iters: int = 20) -> float:
    """Device ms per call of ``fn``: the device time of all the work the
    calls launched (torch.profiler), cycling through ``arg_sets`` whose
    inputs together exceed L2, so each call finds its inputs cold as on the
    main path.  Raises if the profiler saw no device time."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    iters = max(min_iters, len(arg_sets))

    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    events = device_events(torch, run, calls=iters)
    if not events:
        raise RuntimeError(f"torch.profiler recorded no whole trace of {fn}")
    return sum(us for _, us in events) / 1e3 / iters


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


def check_linear(torch, dev, label, kern, plain, pack, unpack, nbytes, step_shapes, ragged,
                 tol, seed, peak_flop_s=PEAK_F32_FLOP_S, lib_dtype=None, ab=None, planes=None):
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
    figure kept as ``bound_f32_ms``.
    Returns (the per-step numbers, the cases)."""
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
        ms = time_ms(torch, kern, sets)
        plain_ms = time_ms(torch, plain, sets)
        deq = [(s[0].to(lib_dtype), unpack(s[1]).T.contiguous().to(lib_dtype))
               for s in sets[:copies_for((M * K + N * K + M * N) * lib_size)]]
        lib_ms = time_ms(torch, torch.matmul, deq)
        sets_of[M, K, N], deq_of[M, K, N] = sets, deq
        bound_ms, by = bound(per_set, 2 * M * N * K, peak_flop_s)
        case = dict(shape=[M, K, N], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound_ms, bound_by=by)
        extra = ""
        if planes is not None:
            case["bound_f32_ms"] = bound_ms
            case["bound_ms"], case["bound_by"] = bound(per_set, planes * 2 * M * N * K,
                                                       PEAK_BF16_FLOP_S)
            bound_ms, by = case["bound_ms"], case["bound_by"]
            extra = (f" bound_f32_ms={case['bound_f32_ms']:.4f} (f32 SIMT; bound_ms is "
                     f"{planes} bf16 tensor-core products)")
        if ab is not None:
            case[f"{ab[0]}_ms"] = time_ms(torch, ab[1], sets)
            extra += f" {ab[0]}_ms(same payload)={case[f'{ab[0]}_ms']:.4f}"
        cases.append(case)
        log(f"{label} M={M} K={K} N={N}: max_abs_err={err:.3g} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(torch.matmul, dequantized W, {lib_dtype})="
            f"{lib_ms:.4f}{extra} bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{peak_flop_s/1e12} TFLOP/s)")

    step = [(BATCH, K, N, i) for K, N, n in step_shapes for i in range(n)]
    runs = {}
    timed = [("ms", kern, sets_of), ("plain_ms", plain, sets_of),
             ("library_ms", torch.matmul, deq_of)]
    if ab is not None:
        timed.append((f"{ab[0]}_ms", ab[1], sets_of))
    for what, fn, arg_of in timed:
        args = [arg_of[M, K, N][i % len(arg_of[M, K, N])] for M, K, N, i in step]
        runs[what] = time_ms(torch, lambda: [fn(*a) for a in args], [()]) / len(step)
    per_launch_bytes = sum(nbytes(M, K, N) for M, K, N, _ in step) / len(step)
    flops = sum(2 * M * N * K for M, K, N, _ in step) / len(step)
    runs["bound_ms"], runs["bound_by"] = bound(per_launch_bytes, flops, peak_flop_s)
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
        [(5, 192, 200), (12, 192, 129), (17, 768, 127), (65, 192, 129), (129, 256, 300)],
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
    # the SBFP formats beyond SBFP12_16 that the JAX package packs and
    # serves: the f32 route (sbfp_gemm_kernel) at every M; the library
    # yardstick is torch.addmm (bias + x W^T) on the dequantized weight
    for shorthand, K, N in SBFP_OTHER_FORMATS:
        ofmt = Format.from_shorthand(shorthand)
        for M in (BATCH, BATCH * PROMPT):
            sets = [(torch.randn(M, K, generator=g, device=dev),
                     sbfp_pack(torch.randn(N, K, generator=g, device=dev) * 0.05, ofmt),
                     torch.randn(N, generator=g, device=dev)) for _ in range(copies_for(
                         b5_bytes(M, K, N)))]
            if sbfp_tensor_cores(sets[0][1], K):
                raise AssertionError(f"{shorthand} would take B5's tensor cores")
            err = max_err(torch, sbfp_linear(*sets[0]), sbfp_linear_ref(*sets[0]), B5_TOL,
                          f"B5 f32 route {shorthand} {M}x{K}x{N}")
            ms = time_ms(torch, sbfp_linear, sets)
            plain_ms = time_ms(torch, sbfp_linear_ref, sets)
            deq = [(b, x, sbfp_unpack(w).T.contiguous()) for x, w, b in sets]
            lib_ms = time_ms(torch, torch.addmm, deq)
            bound_ms, by = bound(b5_bytes(M, K, N), 2 * M * N * K)
            cases.append(dict(shape=[M, K, N], format=shorthand, route="f32", max_abs_err=err,
                              ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                              bound_by=by))
            log(f"B5 sbfp_linear f32 route {shorthand} M={M} K={K} N={N}: max_abs_err={err:.3g} "
                f"(tolerance {B5_TOL}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms(torch.addmm, dequantized W, f32)={lib_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({by}; f32)")
    return step, cases


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


def check_t2(torch, dev, cfg):
    """T2 against its plain version, bit for bit, at the BASIC path's cast
    sites (the BFP, FLOAT16 and composed FLOAT16-then-BFP modes at each; the
    composed one timed beside its two launches), on special blocks along the
    last axis and along an inner axis (the tile kernel; 5 columns, no
    multiple of 4), and through the eight probes; then its time per launch
    over one decode step's launches.  Returns (the per-step numbers, the
    cases)."""
    from dmx_compressor_tpu_torch.ops import bfp_cast as T2

    def run(mode, x, axis, plain=False):
        if mode == "fp16":
            return (T2.fp16_cast_ref if plain else T2.fp16_cast)(x)
        if mode == "fp16bfp":
            if plain:
                return T2.bfp_cast_ref(T2.fp16_cast_ref(x), 8, 64, axis)
            return T2.bfp_cast(x, 8, 64, axis, fp16_first=True)
        return (T2.bfp_cast_ref if plain else T2.bfp_cast)(x, 8, 64, axis)

    def check(label, mode, x, axis):
        got, want = run(mode, x, axis), run(mode, x, axis, plain=True)
        if not same_bits(torch, got, want):
            bad = (got.view(torch.int32) != want.view(torch.int32)).sum().item()
            raise AssertionError(f"T2 {label}: {bad} elements differ from the plain version")

    g = torch.Generator(device=dev).manual_seed(19)
    d, f, H = cfg.hidden_size, cfg.ffn_dim, cfg.num_attention_heads
    D, B = d // H, BATCH
    sites = [("x", (B, d), -1), ("x", (B, f), -1), ("q", (B, H, 1, D), -1),
             ("tail k", (B, H, GEN, D), -1), ("scores", (B, H, 1, PROMPT + GEN), -1),
             ("tail v", (B, H, GEN, D), -2), ("prefill x", (B * PROMPT, d), -1),
             ("prefill x", (B * PROMPT, f), -1), ("prefill scores", (B, H, PROMPT, PROMPT), -1)]
    cases = []
    for label, shape, axis in sites:
        n = math.prod(shape)
        sets = [(torch.randn(shape, generator=g, device=dev)
                 * torch.exp(3 * torch.randn(shape, generator=g, device=dev)),)
                for _ in range(copies_for(8 * n))]
        for mode in ("bfp", "fp16", "fp16bfp"):
            check(f"{mode} {label} {list(shape)} axis {axis}", mode, sets[0][0], axis)
            ms = time_ms(torch, lambda x: run(mode, x, axis), sets)
            plain_ms = time_ms(torch, lambda x: run(mode, x, axis, plain=True), sets)
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
    inputs = [torch.randn(shape, generator=g, device=dev) for _, shape, _ in step]
    runs = {}
    for what, plain in (("ms", False), ("plain_ms", True)):
        runs[what] = time_ms(torch, lambda: [run(m, x, a, plain) for (m, _, a), x
                                             in zip(step, inputs)], [()]) / len(step)
    runs["step_ms"] = runs["ms"] * len(step)
    runs["library_ms"] = None
    runs["bound_ms"], runs["bound_by"] = bound(
        sum(8 * math.prod(shape) for _, shape, _ in step) / len(step), 0)
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


def b4_bytes_flops(B, H, Hkv, D, lengths):
    """q in and out written; the f32 K/V rows below each row's length; the
    lengths.  Two dot products of D per key and query head."""
    keys = sum(lengths)
    return 2 * B * H * D * 4 + keys * Hkv * 2 * D * 4 + B * 4, 4 * keys * H * D


def check_b2(torch, dev, cfg):
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops.flash_decode import flash_decode_int8, flash_decode_int8_ref
    from dmx_compressor_tpu_torch.ops.kv_cache import QuantizedKVCache, QuantKV

    g = torch.Generator(device=dev).manual_seed(12)
    cases = []
    # (Hkv, S, lengths): the main path's shape (its cache capacity at the
    # mean fill of its decode steps), ragged per-row lengths over an S that
    # is no multiple of a chunk, bench.py's long leg (prompt 1984 in a
    # 2048-slot cache, lengths 2016 half way through its 64 steps) and GQA
    # (12 query heads on 4 KV heads, ragged)
    B, H = BATCH, cfg.num_attention_heads
    D = cfg.hidden_size // H
    mean_fill = PROMPT + GEN // 2
    for Hkv, S, lengths in [(H, CAPACITY, [mean_fill] * B),
                            (H, 200, [1 + (199 * i) // (B - 1) for i in range(B)]),
                            (H, 2048, [2016] * B),
                            (max(1, H // 3), 300, [1 + (299 * i) // (B - 1) for i in range(B)])]:
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
        plain_ms = time_ms(torch, flash_decode_int8_ref, sets)
        lib_sets = []
        for q_, kv_, le_ in sets[:copies_for(B * Hkv * S * D * 8 + 2 * B * H * D * 4)]:
            k = kv_.k_q.float() * kv_.k_scale[..., None]
            v = kv_.v_q.float() * kv_.v_scale[..., None]
            mask = (torch.arange(S, device=dev)[None, :] < le_[:, None])[:, None, None, :]
            lib_sets.append((q_, k, v, mask))
        lib_ms = time_ms(torch, lambda q_, k, v, m: F.scaled_dot_product_attention(
            q_, k, v, attn_mask=m, enable_gqa=Hkv != H), lib_sets)
        bound_ms, by = bound(*b2_bytes_flops(B, H, Hkv, D, lengths))
        cases.append(dict(shape=[B, H, Hkv, S, D], lengths=lengths, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        log(f"B2 flash_decode_int8 B={B} H={H} Hkv={Hkv} S={S} D={D} lengths={lengths}: "
            f"max_abs_err={err:.3g} (the same bits on a second call) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} "
            f"library_ms(F.scaled_dot_product_attention, dequantized K/V)={lib_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{PEAK_F32_FLOP_S/1e12} f32 TFLOP/s)")
    return cases


def check_b3(torch, dev, cfg):
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(13)
    cases = []
    # the main path's prefill (L = S = prompt, causal), L < S with the
    # diagonal at S - L, and an additive bias
    B, H = BATCH, cfg.num_attention_heads
    D = cfg.hidden_size // H
    for L, S, with_bias in [(PROMPT, PROMPT, False), (64, 192, False), (100, 160, True)]:
        per_set = 4 * B * H * D * (2 * L + 2 * S) + (4 * B * H * L * S if with_bias else 0)
        sets = []
        for _ in range(copies_for(per_set)):
            q = torch.randn(B, H, L, D, generator=g, device=dev)
            k = torch.randn(B, H, S, D, generator=g, device=dev)
            v = torch.randn(B, H, S, D, generator=g, device=dev)
            bias = torch.randn(B, H, L, S, generator=g, device=dev) if with_bias else None
            sets.append((q, k, v, bias))

        def kern(q, k, v, bias):
            return flash_attention(q, k, v, bias, causal=True)

        def plain(q, k, v, bias):
            return flash_attention_ref(q, k, v, bias, causal=True)

        err = max_err(torch, kern(*sets[0]), plain(*sets[0]), B3_TOL,
                      f"B3 L={L} S={S} bias={with_bias}")
        ms = time_ms(torch, kern, sets)
        plain_ms = time_ms(torch, plain, sets)
        # the library yardstick: one SDPA call with a float mask, built
        # beforehand, that carries the bias and the causal diagonal at S - L
        allowed = torch.ones(L, S, dtype=torch.bool, device=dev).tril(S - L)
        lib_sets = []
        for q, k, v, bias in sets[:copies_for(per_set + 4 * B * H * L * S)]:
            mask = torch.zeros(L, S, device=dev) if bias is None else bias
            lib_sets.append((q, k, v, mask.masked_fill(~allowed, -math.inf)))

        def library(q, k, v, mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        lib_err = (library(*lib_sets[0]) - plain(*sets[0])).abs().max().item()
        lib_ms = time_ms(torch, library, lib_sets)
        pairs = sum(min(S, i + (S - L) + 1) for i in range(L))
        # the kernel takes each of its two products as B3_PLANE_PRODUCTS
        # bf16 tensor-core products; the f32 SIMT figure is kept beside
        bound_f32_ms, _ = bound(per_set, 4 * B * H * D * pairs)
        bound_ms, by = bound(per_set, B3_PLANE_PRODUCTS * 4 * B * H * D * pairs, PEAK_BF16_FLOP_S)
        cases.append(dict(shape=[B * H, L, S, D], bias=with_bias, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                          bound_f32_ms=bound_f32_ms))
        log(f"B3 flash_attention BH={B * H} L={L} S={S} D={D} causal bias={with_bias}: "
            f"max_abs_err={err:.3g} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(F.scaled_dot_product_attention, float mask)={lib_ms:.4f} "
            f"(its max_abs_err against the plain version {lib_err:.3g}) "
            f"bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{B3_PLANE_PRODUCTS} bf16 tensor-core products per f32 product at "
            f"{PEAK_BF16_FLOP_S/1e12} TFLOP/s) bound_f32_ms={bound_f32_ms:.4f} "
            f"({PEAK_F32_FLOP_S/1e12} f32 TFLOP/s)")
    return cases


def check_b4(torch, dev, cfg):
    import torch.nn.functional as F

    from dmx_compressor_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

    g = torch.Generator(device=dev).manual_seed(14)
    cases = []
    # (B, H, Hkv, S, D, lengths): the baseline path's shape (its cache
    # capacity at the mean fill of its decode steps), GQA with rep 4 and
    # ragged lengths, a scalar length at D 32, and D 128 over an S that is no
    # multiple of a tile
    H = cfg.num_attention_heads
    D = cfg.hidden_size // H
    for B, H_, Hkv, S, D_, lengths in [
        (BATCH, H, H, CAPACITY, D, [PROMPT + GEN // 2] * BATCH),
        (3, 8, 2, 256, 64, [17, 256, 130]),
        (2, 4, 4, 192, 32, 100),
        (2, 8, 8, 200, 128, [57, 200]),
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
        err = max_err(torch, flash_decode(*sets[0]), flash_decode_ref(*sets[0]), B4_TOL,
                      f"B4 B={B} H={H_} Hkv={Hkv} S={S} D={D_} lengths={lengths}")
        ms = time_ms(torch, flash_decode, sets)
        plain_ms = time_ms(torch, flash_decode_ref, sets)
        # the library yardstick: one SDPA call on the same f32 K/V with a
        # boolean length mask built beforehand
        mask = (torch.arange(S, device=dev)[None, :]
                < torch.tensor(rows, device=dev)[:, None])[:, None, None, :]
        lib_sets = [(q, k, v, mask) for q, k, v, _ in sets]

        def library(q, k, v, m, _gqa=H_ != Hkv):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=_gqa)

        lib_err = (library(*lib_sets[0]) - flash_decode_ref(*sets[0])).abs().max().item()
        lib_ms = time_ms(torch, library, lib_sets)
        bound_ms, by = bound(*b4_bytes_flops(B, H_, Hkv, D_, rows))
        cases.append(dict(shape=[B, H_, Hkv, S, D_], lengths=lengths, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        log(f"B4 flash_decode B={B} H={H_} Hkv={Hkv} S={S} D={D_} lengths={lengths}: "
            f"max_abs_err={err:.3g} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(F.scaled_dot_product_attention, boolean length mask)={lib_ms:.4f} "
            f"(its max_abs_err against the plain version {lib_err:.3g}) "
            f"bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{PEAK_F32_FLOP_S/1e12} f32 TFLOP/s)")
    return cases


# ---------------------------------------------------------------------------
# phase 3: the serving paths
# ---------------------------------------------------------------------------


def path_specs(cfg):
    """The four serving paths: name, build function, init_cache arguments,
    the launches at prefill, in prepare_split_decode (None: not called) and
    per decode step, the profiler's name marks of each kernel launched per
    step, and the logits' tolerance GPU vs CPU."""
    from dmx_compressor_tpu_torch.ops.compress import (
        build_baseline_mode,
        build_basic_mode,
        build_sbfp_mode,
        build_weights_mode,
    )

    L = cfg.num_hidden_layers
    t1_marks = ("bfp_decode_kernel", "bfp_wgmma_kernel", "split_planes_kernel",
                "bfp_bf16_ragged_kernel")
    t2_marks = ("bfp_rows_kernel", "bfp_rows_vec_kernel", "bfp_tile_kernel", "fp16_kernel",
                "fp16_vec_kernel")
    b2_marks = ("flash_decode_int8_kernel",)
    return [
        dict(name="weights", build=build_weights_mode,
             cache=dict(max_len=CAPACITY, quantized=True),
             prefill={"bfp_linear": 4 * L + 1, "flash_attention": L}, prepare=None,
             step={"bfp_linear": 4 * L + 1, "flash_decode_int8": L},
             marks={"bfp_linear": ("bfp_decode_kernel", "bfp_gemm_kernel", "bfp_wgmma_kernel",
                                   "split_planes_kernel"),
                    "flash_decode_int8": b2_marks},
             logit_tol=LOGIT_TOL),
        dict(name="sbfp", build=build_sbfp_mode, cache=dict(max_len=CAPACITY, quantized=True),
             prefill={"sbfp_linear": 6 * L + 1, "flash_attention": L}, prepare=None,
             step={"sbfp_linear": 6 * L + 1, "flash_decode_int8": L},
             marks={"sbfp_linear": ("bfp_decode_kernel", "sbfp_gemm_kernel", "bfp_wgmma_kernel",
                                    "split_planes_kernel"),
                    "flash_decode_int8": b2_marks},
             logit_tol=LOGIT_TOL),
        dict(name="baseline", build=build_baseline_mode, cache=dict(max_len=CAPACITY),
             prefill={"flash_attention": L}, prepare=None, step={"flash_decode": L},
             marks={"flash_decode": ("flash_decode_kernel",)}, logit_tol=LOGIT_TOL),
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
             marks={"bfp_linear_bf16": t1_marks, "bfp_cast": t2_marks},
             logit_tol=BASIC_LOGIT_TOL),
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
    """One serving path: OPT at full width from seed 0, built by
    ``spec["build"]``, prefill, [prepare_split_decode,] then GEN - 1 greedy
    decode steps with the launch counters set to 0 just before and read
    after each part; its profile; the CPU check.  Returns (the launch
    counts, decode tokens/s)."""
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM, greedy_decode, greedy_prefill
    from dmx_compressor_tpu_torch.ops.split_decode import prepare_split_decode

    name = spec["name"]
    cache_kw = dict(spec["cache"])
    if "dtype" in cache_kw:
        cache_kw["dtype"] = getattr(torch, cache_kw["dtype"])
    t0 = time.perf_counter()
    model = OPTForCausalLM(cfg, device=dev, seed=0)
    spec["build"](model)
    torch.cuda.synchronize()
    log(f"{name} path: OPT {cfg.hidden_size}x{cfg.num_hidden_layers} built in "
        f"{time.perf_counter() - t0:.2f} s")
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                        generator=torch.Generator().manual_seed(1))

    def prefill(caches, ids_):
        """Prefill [and prepare]; (logits, first token, launches after the
        prefill)."""
        logits, tok = greedy_prefill(model, caches, ids_)
        after = dict(kernels.LAUNCHES)
        if spec["prepare"] is not None:
            prepare_split_decode(model, caches)
        return logits, tok, after

    caches = model.init_cache(BATCH, device=dev, **cache_kw)
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits, tok, after_prefill = prefill(caches, ids.to(dev))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prepare = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    toks, _ = greedy_decode(model, caches, tok, PROMPT, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

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
    tokens = torch.cat([tok[:, None], toks], dim=1)
    if logits.shape != (BATCH, PROMPT, cfg.vocab_size) or not torch.isfinite(logits).all():
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
        b3_ms = sum(us for n, us in pre_events if "flash_attention_kernel" in n) / 1e3
        b3 = (f", flash_attention {b3_ms:.4f} ms over {spec['prefill']['flash_attention']} "
              f"launches")
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
                                                               PROMPT, 8)),
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
    host_profile(torch, name, lambda: greedy_decode(model, prof_caches, ptok, PROMPT, 8), 8)
    del prof_caches

    # the same model on the CPU: the plain PyTorch versions of the kernels
    gpu_logits, gpu_tokens = logits.float().cpu(), tokens.cpu()
    del logits, caches
    model.to("cpu")
    torch.cuda.empty_cache()
    cpu_caches = model.init_cache(BATCH, device="cpu", **cache_kw)
    t0 = time.perf_counter()
    cpu_logits, ctok, _ = prefill(cpu_caches, ids)
    n = min(8, GEN)  # the first n greedy tokens are held
    ctoks, rows = greedy_decode(model, cpu_caches, ctok, PROMPT, n - 1)
    log(f"{name} path: CPU reference run {time.perf_counter() - t0:.1f} s")
    tol = spec["logit_tol"]
    err = (gpu_logits - cpu_logits).abs().max().item()
    log(f"{name} path: prefill logits GPU vs CPU: max_abs_err={err:.3g} (tolerance {tol})")
    if not err <= tol:
        raise AssertionError(f"{name} path: prefill logits disagree with the CPU run")
    cpu_tokens = torch.cat([ctok[:, None], ctoks], dim=1)
    step_rows = torch.cat([cpu_logits[:, -1][None], rows])  # [n, B, V]
    top2 = step_rows.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]  # [n, B]
    held = 0
    for b in range(BATCH):
        for s in range(n):
            if margin[s, b] <= tol:
                break  # a near-tie: this row's later tokens are not held
            if gpu_tokens[b, s] != cpu_tokens[b, s]:
                raise AssertionError(f"{name} path: greedy token {s} of row {b} differs "
                                     f"from the CPU run")
            held += 1
    log(f"{name} path: greedy tokens GPU vs CPU: {held} of {BATCH * n} held (top-1/top-2 "
        f"margin > {tol}), all equal")
    del model, cpu_caches
    return launches, tok_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from dmx_compressor_tpu_torch import kernels
    from dmx_compressor_tpu_torch.models.opt import OPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
        f"device count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    seconds = kernels.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())})")
    for name in kernels.SIGNATURES:
        build_log = kernels.BUILD_DIR / f"{name}.log"
        for ln in build_log.read_text().splitlines() if build_log.exists() else []:
            if "Used" in ln or "spill" in ln:
                log(f"  ptxas {name}: {ln.strip()}")

    cfg = OPTConfig.opt_125m()
    b1_step, b1 = check_b1(torch, dev, cfg)
    b2 = check_b2(torch, dev, cfg)
    b3 = check_b3(torch, dev, cfg)
    b4 = check_b4(torch, dev, cfg)
    b5_step, b5 = check_b5(torch, dev, cfg)
    t1_step, t1, t1_flush = check_t1(torch, dev, cfg)
    t2_step, t2 = check_t2(torch, dev, cfg)

    by_path, tok_s = {}, {}
    for spec in path_specs(cfg):
        name = spec["name"]
        by_path[name], tok_s[name] = serve_path(torch, dev, kernels, cfg, spec)
        log(f"{name} path: decode {tok_s[name]:.1f} tokens/s on {card}")
    log(f"bench.py's ratio, for information (host clock, batch {BATCH}, {card}): "
        f"weights / baseline {tok_s['weights'] / tok_s['baseline']:.4f}, "
        f"sbfp / baseline {tok_s['sbfp'] / tok_s['baseline']:.4f}, "
        f"basic / baseline {tok_s['basic'] / tok_s['baseline']:.4f}")

    def launches(kern):
        """The kernel's launches over the paths' runs, in all and per path."""
        per = {p: n[kern] for p, n in by_path.items() if n[kern]}
        return dict(launches=sum(per.values()), launches_by_path=per)

    def top(cases):
        return {k: cases[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}

    # top-level times: B1, B5, T1 and T2 per launch over one decode step's
    # launches, B2, B3 and B4 at their path's shape (their first case)
    entries = [
        dict(name="bfp_linear", route="cuda", source="dmx_compressor_tpu_torch/csrc/bfp_linear.cu",
             replaces="dmx_compressor_tpu/ops/bfp_linear.py:53", **launches("bfp_linear"),
             max_abs_err=max(c["max_abs_err"] for c in b1), **b1_step, cases=b1),
        dict(name="flash_decode_int8", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/flash_decode_int8.cu",
             replaces="dmx_compressor_tpu/ops/flash_decode.py:305",
             **launches("flash_decode_int8"),
             max_abs_err=max(c["max_abs_err"] for c in b2), **top(b2), cases=b2),
        dict(name="flash_attention", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/flash_attention.cu",
             replaces="dmx_compressor_tpu/ops/flash_attention.py:67",
             **launches("flash_attention"),
             max_abs_err=max(c["max_abs_err"] for c in b3), **top(b3), cases=b3),
        dict(name="flash_decode", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/flash_decode.cu",
             replaces="dmx_compressor_tpu/ops/flash_decode.py:305",
             **launches("flash_decode"),
             max_abs_err=max(c["max_abs_err"] for c in b4), **top(b4), cases=b4),
        dict(name="sbfp_linear", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/sbfp_linear.cu",
             replaces="dmx_compressor_tpu/ops/bfp_linear.py:199", **launches("sbfp_linear"),
             max_abs_err=max(c["max_abs_err"] for c in b5), **b5_step, cases=b5),
        dict(name="bfp_linear_bf16", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/bfp_linear_bf16.cu",
             replaces="tools/diag_bfpkernel_ab.py:30", **launches("bfp_linear_bf16"),
             max_abs_err=max(c["max_abs_err"] for c in t1), **t1_step,
             subnormal_weights=t1_flush, cases=t1),
        dict(name="bfp_cast", route="cuda", source="dmx_compressor_tpu_torch/csrc/bfp_cast.cu",
             replaces="tools/probe_fused_cast.py:9", **launches("bfp_cast"),
             max_abs_err=0.0, **t2_step, cases=t2),
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
