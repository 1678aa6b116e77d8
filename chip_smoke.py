#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dmx_compressor_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: the card's name and power limit (nvidia-smi), and the build of
   every kernel of ``dmx_compressor_tpu_torch/csrc`` (one nvcc per source,
   started together).
2. The five kernels against their plain PyTorch versions on the card, at
   the paths' shapes and at ragged ones: max abs error against the stated
   tolerance, the kernel's time, its plain version's, one library call's
   (a yardstick the port never calls) and the bound (bytes or f32
   operations over the H100 SXM's published peaks).  B1 bfp_linear, B2
   flash_decode_int8, B3 flash_attention, B4 flash_decode, B5 sbfp_linear.
3. Three serving paths of OPT-125m at full width from seeded random weights
   (seed 0), each a prefill of batch 8 x prompt 128 then 63 greedy decode
   steps, with the launch counters set to 0 just before and read just after
   (L = 12 layers):
   - weights mode (BFP16_64 packed weights, int8 KV cache): prefill
     4L+1 = 49 B1 + 12 B3, each decode step 49 B1 + 12 B2;
   - SBFP mode (SBFP12_16 packed weights, int8 KV cache): prefill
     6L+1 = 73 B5 + 12 B3, each decode step 73 B5 + 12 B2;
   - fp32 baseline (BASELINE rules, plain Linears, f32 KV cache): prefill
     12 B3, each decode step 12 B4.
   Each path's prefill logits and first 8 greedy tokens are held against the
   same model moved to the CPU (``.to("cpu")``); each prints its decode
   tokens/s, the device busy/idle split of a profiled decode step and a host
   cProfile of the same steps.  The JAX bench's ratios (weights / baseline,
   SBFP / baseline tokens/s) follow.
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
L2_BYTES = 50 * 2**20

BATCH, PROMPT, GEN = 8, 128, 64  # prefill + GEN - 1 decode steps
# the cache capacity of the JAX bench's weights mode: the written slots,
# rounded up to a multiple of 128
CAPACITY = -(-(PROMPT + GEN - 1) // 128) * 128
LOGIT_TOL = 1e-3  # f32 logits, GPU vs CPU: the same math summed in another order
B1_TOL = dict(rtol=1e-5, atol=1e-4)  # f32 sums of up to 3072 terms, another order
B2_TOL = dict(rtol=1e-5, atol=2e-5)
B3_TOL = dict(rtol=1e-5, atol=2e-5)
B4_TOL = dict(rtol=1e-5, atol=2e-5)
B5_TOL = dict(rtol=1e-5, atol=1e-4)  # as B1: exact weights, sums in another order


def log(*args):
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_events(torch, run):
    """(name, device microseconds) of every device activity of ``run()``,
    from torch.profiler, the one timing source of this script.  The profiler
    now and then hands back an empty trace, so an empty one is taken again,
    up to five times in all; empty if all five were."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if events:
            return events
    return []


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

    events = device_events(torch, run)
    if not events:
        raise RuntimeError(f"torch.profiler recorded no device time for {fn}")
    return sum(us for _, us in events) / 1e3 / iters


def copies_for(nbytes: int) -> int:
    return max(2, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


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
                 tol, seed):
    """A dequant-matmul kernel against its plain version at the decode (M =
    batch) and prefill (M = batch x prompt) shapes of ``step_shapes`` and at
    ``ragged`` (M, K, N) shapes; then its time per launch over one decode
    step's launches as the path makes them (each linear of each layer, then
    the head, each launch on its own cold weight).  Returns (the per-step
    numbers, the cases)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cases, sets_of, deq_of = [], {}, {}
    shapes = [(M, K, N) for M in (BATCH, BATCH * PROMPT) for K, N, _ in step_shapes]
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
        deq = [(s[0], unpack(s[1]).T.contiguous())
               for s in sets[:copies_for(M * K * 4 + N * K * 4 + M * N * 4)]]
        lib_ms = time_ms(torch, torch.matmul, deq)
        sets_of[M, K, N], deq_of[M, K, N] = sets, deq
        bound_ms, by = bound(per_set, 2 * M * N * K)
        cases.append(dict(shape=[M, K, N], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        log(f"{label} M={M} K={K} N={N}: max_abs_err={err:.3g} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(torch.matmul, dequantized W)={lib_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{PEAK_F32_FLOP_S/1e12} f32 TFLOP/s)")

    step = [(BATCH, K, N, i) for K, N, n in step_shapes for i in range(n)]
    runs = {}
    for what, fn, arg_of in (("ms", kern, sets_of), ("plain_ms", plain, sets_of),
                             ("library_ms", torch.matmul, deq_of)):
        args = [arg_of[M, K, N][i % len(arg_of[M, K, N])] for M, K, N, i in step]
        runs[what] = time_ms(torch, lambda: [fn(*a) for a in args], [()]) / len(step)
    per_launch_bytes = sum(nbytes(M, K, N) for M, K, N, _ in step) / len(step)
    flops = sum(2 * M * N * K for M, K, N, _ in step) / len(step)
    runs["bound_ms"], runs["bound_by"] = bound(per_launch_bytes, flops)
    log(f"{label}, one decode step's {len(step)} launches, per launch: "
        f"kernel_ms={runs['ms']:.4f} plain_ms={runs['plain_ms']:.4f} "
        f"library_ms={runs['library_ms']:.4f} bound_ms={runs['bound_ms']:.4f} "
        f"({runs['bound_by']})")
    return runs, cases


def check_b1(torch, dev, cfg):
    from dmx_compressor_tpu_torch.ops.bfp_linear import bfp_linear, bfp_linear_ref
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, bfp_unpack

    return check_linear(torch, dev, "B1 bfp_linear", bfp_linear, bfp_linear_ref,
                        lambda w: bfp_pack(w, 8, 64), bfp_unpack, b1_bytes,
                        linear_shapes(cfg), [(5, 192, 200)], B1_TOL, seed=11)


def check_b5(torch, dev, cfg):
    from dmx_compressor_tpu_torch.numerics.format import Format
    from dmx_compressor_tpu_torch.ops.bfp_linear import sbfp_linear, sbfp_linear_ref
    from dmx_compressor_tpu_torch.ops.bfp_pack import sbfp_pack, sbfp_unpack
    from dmx_compressor_tpu_torch.ops.compress import SBFP12_16

    fmt = Format.from_shorthand(SBFP12_16)
    return check_linear(torch, dev, "B5 sbfp_linear", sbfp_linear, sbfp_linear_ref,
                        lambda w: sbfp_pack(w, fmt), sbfp_unpack, b5_bytes,
                        sbfp_linear_shapes(cfg), [(3, 48, 33), (130, 160, 256), (5, 80, 48)],
                        B5_TOL, seed=15)


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
    # the main path's shape (its cache capacity at the mean fill of its decode
    # steps) and ragged per-row lengths over an S that is no multiple of a tile
    B, H = BATCH, cfg.num_attention_heads
    Hkv, D = H, cfg.hidden_size // H
    mean_fill = PROMPT + GEN // 2
    for S, lengths in [(CAPACITY, [mean_fill] * B),
                       (200, [1 + (199 * i) // (B - 1) for i in range(B)])]:
        per_set = B * Hkv * S * (2 * D + 8) + 2 * B * H * D * 4
        sets = []
        for _ in range(copies_for(per_set)):
            kq, ks = QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g, device=dev))
            vq, vs = QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g, device=dev))
            sets.append((torch.randn(B, H, 1, D, generator=g, device=dev),
                         QuantKV(kq, vq, ks, vs),
                         torch.tensor(lengths, dtype=torch.int32, device=dev)))
        q, kv, le = sets[0]
        err = max_err(torch, flash_decode_int8(q, kv, le), flash_decode_int8_ref(q, kv, le),
                      B2_TOL, f"B2 S={S} lengths={lengths}")
        ms = time_ms(torch, flash_decode_int8, sets)
        plain_ms = time_ms(torch, flash_decode_int8_ref, sets)
        lib_sets = []
        for q_, kv_, le_ in sets[:copies_for(B * Hkv * S * D * 8 + 2 * B * H * D * 4)]:
            k = kv_.k_q.float() * kv_.k_scale[..., None]
            v = kv_.v_q.float() * kv_.v_scale[..., None]
            mask = (torch.arange(S, device=dev)[None, :] < le_[:, None])[:, None, None, :]
            lib_sets.append((q_, k, v, mask))
        lib_ms = time_ms(torch, lambda q_, k, v, m: F.scaled_dot_product_attention(
            q_, k, v, attn_mask=m), lib_sets)
        bound_ms, by = bound(*b2_bytes_flops(B, H, Hkv, D, lengths))
        cases.append(dict(shape=[B, H, S, D], lengths=lengths, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        log(f"B2 flash_decode_int8 B={B} H={H} S={S} D={D} lengths={lengths}: "
            f"max_abs_err={err:.3g} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
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
        bound_ms, by = bound(per_set, 4 * B * H * D * pairs)
        cases.append(dict(shape=[B * H, L, S, D], bias=with_bias, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        log(f"B3 flash_attention BH={B * H} L={L} S={S} D={D} causal bias={with_bias}: "
            f"max_abs_err={err:.3g} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(F.scaled_dot_product_attention, float mask)={lib_ms:.4f} "
            f"(its max_abs_err against the plain version {lib_err:.3g}) "
            f"bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{PEAK_F32_FLOP_S/1e12} f32 TFLOP/s)")
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
    """(name, build function, int8 cache, launches at prefill, launches per
    decode step, {kernel: profiler name marks}) of the three serving paths."""
    from dmx_compressor_tpu_torch.ops.compress import (
        build_baseline_mode,
        build_sbfp_mode,
        build_weights_mode,
    )

    L = cfg.num_hidden_layers
    return [
        ("weights", build_weights_mode, True,
         {"bfp_linear": 4 * L + 1, "flash_attention": L},
         {"bfp_linear": 4 * L + 1, "flash_decode_int8": L},
         {"bfp_linear": ("bfp_gemv_kernel", "bfp_gemm_kernel"),
          "flash_decode_int8": ("flash_decode_int8_kernel",)}),
        ("sbfp", build_sbfp_mode, True,
         {"sbfp_linear": 6 * L + 1, "flash_attention": L},
         {"sbfp_linear": 6 * L + 1, "flash_decode_int8": L},
         {"sbfp_linear": ("sbfp_gemv_kernel", "sbfp_gemm_kernel"),
          "flash_decode_int8": ("flash_decode_int8_kernel",)}),
        ("baseline", build_baseline_mode, False,
         {"flash_attention": L},
         {"flash_decode": L},
         {"flash_decode": ("flash_decode_kernel",)}),
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


def serve_path(torch, dev, kernels, cfg, name, build, quantized, want_prefill, want_step,
               marks):
    """One serving path: OPT at full width from seed 0, built by ``build``,
    prefill then GEN - 1 greedy decode steps with the launch counters set to
    0 just before and read just after; its profile; the CPU check.  Returns
    (the launch counts, decode tokens/s)."""
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM, greedy_decode, greedy_prefill

    t0 = time.perf_counter()
    model = OPTForCausalLM(cfg, device=dev, seed=0)
    build(model)
    torch.cuda.synchronize()
    log(f"{name} path: OPT {cfg.hidden_size}x{cfg.num_hidden_layers} built in "
        f"{time.perf_counter() - t0:.2f} s")
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                        generator=torch.Generator().manual_seed(1))
    caches = model.init_cache(BATCH, CAPACITY, quantized=quantized, device=dev)

    kernels.reset_launches()
    t0 = time.perf_counter()
    logits, tok = greedy_prefill(model, caches, ids.to(dev))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    toks, _ = greedy_decode(model, caches, tok, PROMPT, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    want_after_prefill = dict.fromkeys(kernels.LAUNCHES, 0)
    want_after_prefill.update(want_prefill)
    want_total = {k: v + want_step.get(k, 0) * (GEN - 1) for k, v in want_after_prefill.items()}
    log(f"{name} path: launches after prefill {after_prefill} (expected {want_after_prefill}); "
        f"after {GEN - 1} decode steps {launches} (expected {want_total})")
    if after_prefill != want_after_prefill or launches != want_total:
        raise AssertionError(f"the {name} path did not launch the kernels the expected "
                             f"number of times")
    tokens = torch.cat([tok[:, None], toks], dim=1)
    if logits.shape != (BATCH, PROMPT, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite or misshapen")
    if tokens.shape != (BATCH, GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError("greedy tokens out of range")
    tok_s = BATCH * (GEN - 1) / t_decode
    log(f"{name} path: prefill {t_prefill * 1e3:.1f} ms (first call, includes warm-up); "
        f"decode {tok_s:.1f} tokens/s over {GEN - 1} steps at batch {BATCH} "
        f"(host clock, synchronized)")

    # where a decode step's time goes: 8 more steps from a fresh prefill,
    # device time from torch.profiler against the unprofiled step time above
    prof_caches = model.init_cache(BATCH, CAPACITY, quantized=quantized, device=dev)
    _, ptok = greedy_prefill(model, prof_caches, ids.to(dev))
    torch.cuda.synchronize()
    events = sorted(device_events(torch, lambda: greedy_decode(model, prof_caches, ptok,
                                                               PROMPT, 8)),
                    key=lambda e: -e[1])
    busy_ms = sum(us for _, us in events) / 1e3 / 8
    step_ms = t_decode * 1e3 / (GEN - 1)
    if events:
        log(f"{name} decode step: {step_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
            f"(idle share {1 - busy_ms / step_ms:.3f})")
        for kern, names in marks.items():
            us = sum(t for n, t in events if any(m in n for m in names))
            per_step = want_step[kern]
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
    cpu_caches = model.init_cache(BATCH, CAPACITY, quantized=quantized, device="cpu")
    t0 = time.perf_counter()
    cpu_logits, ctok = greedy_prefill(model, cpu_caches, ids)
    n = min(8, GEN)  # the first n greedy tokens are held
    ctoks, rows = greedy_decode(model, cpu_caches, ctok, PROMPT, n - 1)
    log(f"{name} path: CPU reference run {time.perf_counter() - t0:.1f} s")
    err = (gpu_logits - cpu_logits).abs().max().item()
    log(f"{name} path: prefill logits GPU vs CPU: max_abs_err={err:.3g} "
        f"(tolerance {LOGIT_TOL})")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"{name} path: prefill logits disagree with the CPU run")
    cpu_tokens = torch.cat([ctok[:, None], ctoks], dim=1)
    step_rows = torch.cat([cpu_logits[:, -1][None], rows])  # [n, B, V]
    top2 = step_rows.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]  # [n, B]
    held = 0
    for b in range(BATCH):
        for s in range(n):
            if margin[s, b] <= LOGIT_TOL:
                break  # a near-tie: this row's later tokens are not held
            if gpu_tokens[b, s] != cpu_tokens[b, s]:
                raise AssertionError(f"{name} path: greedy token {s} of row {b} differs "
                                     f"from the CPU run")
            held += 1
    log(f"{name} path: greedy tokens GPU vs CPU: {held} of {BATCH * n} held (top-1/top-2 "
        f"margin > {LOGIT_TOL}), all equal")
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

    by_path, tok_s = {}, {}
    for name, build, quantized, want_prefill, want_step, marks in path_specs(cfg):
        by_path[name], tok_s[name] = serve_path(torch, dev, kernels, cfg, name, build, quantized,
                                                want_prefill, want_step, marks)
        log(f"{name} path: decode {tok_s[name]:.1f} tokens/s on {card}")
    log(f"bench.py's ratio, for information (host clock, batch {BATCH}, {card}): "
        f"weights / baseline {tok_s['weights'] / tok_s['baseline']:.4f}, "
        f"sbfp / baseline {tok_s['sbfp'] / tok_s['baseline']:.4f}")

    def launches(kern):
        """The kernel's launches over the paths' runs, in all and per path."""
        per = {p: n[kern] for p, n in by_path.items() if n[kern]}
        return dict(launches=sum(per.values()), launches_by_path=per)

    def top(cases):
        return {k: cases[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}

    # top-level times: B1 and B5 per launch over one decode step's launches,
    # B2, B3 and B4 at their path's shape (their first case)
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
