#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dmx_compressor_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: the card's name and power limit (nvidia-smi), and the build of
   every kernel of ``dmx_compressor_tpu_torch/csrc`` (one nvcc per source,
   started together).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes and at ragged ones: max abs error against the stated
   tolerance, the kernel's time, its plain version's, one library call's
   (a yardstick the port never calls) and the bound (bytes or f32
   operations over the H100 SXM's published peaks).
3. Main path: OPT-125m at full width from seeded random weights, weights-mode
   serving (BFP16_64 packed weights, int8 KV cache): prefill of batch 8 x
   prompt 128, then 63 greedy decode steps.  The launch counters must rise
   by exactly 49 (B1) + 12 (B3) at prefill and 63 x (49 B1 + 12 B2) over
   the decode.  The prefill logits and the first 8 greedy tokens are held
   against the same model moved to the CPU (``.to("cpu")``).
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
    """(K, N, launches per forward) of the main path's packed linears:
    merged qkv, out_proj, fc1 and fc2 per layer, then the LM head."""
    d, f, L = cfg.hidden_size, cfg.ffn_dim, cfg.num_hidden_layers
    return [(d, 3 * d, L), (d, d, L), (d, f, L), (f, d, L), (d, cfg.vocab_size, 1)]


def check_b1(torch, dev, cfg):
    from dmx_compressor_tpu_torch.ops.bfp_linear import bfp_linear, bfp_linear_ref
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, bfp_unpack

    g = torch.Generator(device=dev).manual_seed(11)
    cases, sets_of, deq_of = [], {}, {}
    # (M, K, N): the main path's decode (M = batch) and prefill (M = batch x
    # prompt) shapes, and a ragged one
    shapes = [(M, K, N) for M in (BATCH, BATCH * PROMPT) for K, N, _ in linear_shapes(cfg)]
    for M, K, N in shapes + [(5, 192, 200)]:
        per_set = b1_bytes(M, K, N)
        sets = []
        for _ in range(copies_for(per_set)):
            w = bfp_pack(torch.randn(N, K, generator=g, device=dev) * 0.05, 8, 64)
            sets.append((torch.randn(M, K, generator=g, device=dev), w,
                         torch.randn(N, generator=g, device=dev) * 0.1))
        x, w, b = sets[0]
        err = max_err(torch, bfp_linear(x, w, b), bfp_linear_ref(x, w, b), B1_TOL,
                      f"B1 {M}x{K}x{N}")
        ms = time_ms(torch, bfp_linear, sets)
        plain_ms = time_ms(torch, bfp_linear_ref, sets)
        deq = [(s[0], bfp_unpack(s[1]).T.contiguous())
               for s in sets[:copies_for(M * K * 4 + N * K * 4 + M * N * 4)]]
        lib_ms = time_ms(torch, torch.matmul, deq)
        sets_of[M, K, N], deq_of[M, K, N] = sets, deq
        bound_ms, by = bound(per_set, 2 * M * N * K)
        cases.append(dict(shape=[M, K, N], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        log(f"B1 bfp_linear M={M} K={K} N={N}: max_abs_err={err:.3g} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(torch.matmul, dequantized W)={lib_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({by}; {PEAK_BYTES_S/1e12} TB/s, "
            f"{PEAK_F32_FLOP_S/1e12} f32 TFLOP/s)")

    # one decode step's B1 launches as the main path makes them: each packed
    # linear of each layer, then the head, each launch on its own weight
    step = [(BATCH, K, N, i) for K, N, n in linear_shapes(cfg) for i in range(n)]
    runs = {}
    for what, fn, arg_of in (("ms", bfp_linear, sets_of), ("plain_ms", bfp_linear_ref, sets_of),
                             ("library_ms", torch.matmul, deq_of)):
        args = [arg_of[M, K, N][i % len(arg_of[M, K, N])] for M, K, N, i in step]
        runs[what] = time_ms(torch, lambda: [fn(*a) for a in args], [()]) / len(step)
    nbytes = sum(b1_bytes(M, K, N) for M, K, N, _ in step) / len(step)
    flops = sum(2 * M * N * K for M, K, N, _ in step) / len(step)
    runs["bound_ms"], runs["bound_by"] = bound(nbytes, flops)
    log(f"B1 bfp_linear, one decode step's {len(step)} launches, per launch: "
        f"kernel_ms={runs['ms']:.4f} plain_ms={runs['plain_ms']:.4f} "
        f"library_ms={runs['library_ms']:.4f} bound_ms={runs['bound_ms']:.4f} "
        f"({runs['bound_by']})")
    return runs, cases


def b1_bytes(M, K, N):
    """x, int8 mantissas, int8 exponents, bias in; y out."""
    return M * K * 4 + N * K + N * K // 64 + N * 4 + M * N * 4


def b2_bytes_flops(B, H, Hkv, D, lengths):
    keys = sum(lengths)
    nbytes = 2 * B * H * D * 4 + keys * Hkv * (2 * D + 8) + B * 4
    return nbytes, 4 * keys * (H // Hkv) * Hkv * D


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


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def main_path(torch, dev, kernels, cfg):
    from dmx_compressor_tpu_torch.models.opt import OPTForCausalLM, greedy_decode, greedy_prefill
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode

    t0 = time.perf_counter()
    model = OPTForCausalLM(cfg, device=dev, seed=0)
    build_weights_mode(model)
    torch.cuda.synchronize()
    log(f"main path: OPT {cfg.hidden_size}x{cfg.num_hidden_layers} built and packed in "
        f"{time.perf_counter() - t0:.2f} s")
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                        generator=torch.Generator().manual_seed(1))
    caches = model.init_cache(BATCH, CAPACITY, quantized=True, device=dev)

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

    L = cfg.num_hidden_layers
    want_prefill = {"bfp_linear": 4 * L + 1, "flash_attention": L, "flash_decode_int8": 0}
    want_total = {"bfp_linear": (4 * L + 1) * GEN, "flash_attention": L,
                  "flash_decode_int8": L * (GEN - 1)}
    log(f"launches after prefill {after_prefill} (expected {want_prefill}); "
        f"after {GEN - 1} decode steps {launches} (expected {want_total})")
    if after_prefill != want_prefill or launches != want_total:
        raise AssertionError("the main path did not launch the kernels the expected number of times")
    tokens = torch.cat([tok[:, None], toks], dim=1)
    if logits.shape != (BATCH, PROMPT, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite or misshapen")
    if tokens.shape != (BATCH, GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError("greedy tokens out of range")
    log(f"prefill {t_prefill * 1e3:.1f} ms (first call, includes warm-up); decode "
        f"{BATCH * (GEN - 1) / t_decode:.1f} tokens/s over {GEN - 1} steps at batch {BATCH} "
        f"(host clock, synchronized)")

    # where a decode step's time goes: 8 more steps from a fresh prefill,
    # device time from torch.profiler against the unprofiled step time above
    prof_caches = model.init_cache(BATCH, CAPACITY, quantized=True, device=dev)
    _, ptok = greedy_prefill(model, prof_caches, ids.to(dev))
    torch.cuda.synchronize()
    events = sorted(device_events(torch, lambda: greedy_decode(model, prof_caches, ptok,
                                                               PROMPT, 8)),
                    key=lambda e: -e[1])
    busy_ms = sum(us for _, us in events) / 1e3 / 8
    step_ms = t_decode * 1e3 / (GEN - 1)
    if events:
        log(f"decode step: {step_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
            f"(idle share {1 - busy_ms / step_ms:.3f})")
        L = cfg.num_hidden_layers
        for name, marks, per_step in (("bfp_linear", ("bfp_gemv_kernel", "bfp_gemm_kernel"),
                                       4 * L + 1),
                                      ("flash_decode_int8", ("flash_decode_int8_kernel",), L)):
            us = sum(t for n, t in events if any(m in n for m in marks))
            log(f"  {name} on the main path: {us / 1e3 / (8 * per_step):.4f} ms per launch "
                f"(its kernel's device time over {8 * per_step} launches)")
    else:
        log(f"decode step: {step_ms:.3f} ms wall; device busy not measured (empty profile)")
    for name, us in events[:8]:
        log(f"  device per step: {us / 1e3 / 8:.4f} ms  {name[:110]}")
    del prof_caches

    # the same model on the CPU: plain PyTorch versions of the three kernels
    gpu_logits, gpu_tokens = logits.float().cpu(), tokens.cpu()
    del logits, caches
    model.to("cpu")
    cpu_caches = model.init_cache(BATCH, CAPACITY, quantized=True, device="cpu")
    t0 = time.perf_counter()
    cpu_logits, ctok = greedy_prefill(model, cpu_caches, ids)
    n = min(8, GEN)  # the first n greedy tokens are held
    ctoks, rows = greedy_decode(model, cpu_caches, ctok, PROMPT, n - 1)
    log(f"CPU reference run: {time.perf_counter() - t0:.1f} s")
    err = (gpu_logits - cpu_logits).abs().max().item()
    log(f"prefill logits GPU vs CPU: max_abs_err={err:.3g} (tolerance {LOGIT_TOL})")
    if not err <= LOGIT_TOL:
        raise AssertionError("prefill logits disagree with the CPU run")
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
                raise AssertionError(f"greedy token {s} of row {b} differs from the CPU run")
            held += 1
    log(f"greedy tokens GPU vs CPU: {held} of {BATCH * n} held (top-1/top-2 margin > "
        f"{LOGIT_TOL}), all equal")
    return launches, BATCH * (GEN - 1) / t_decode


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
    launches, tok_s = main_path(torch, dev, kernels, cfg)
    log(f"decode {tok_s:.1f} tokens/s on {card}")

    # top-level times: B1 per launch over one decode step's launches, B2
    # and B3 at the main path's shape (their first case)
    entries = [
        dict(name="bfp_linear", route="cuda", source="dmx_compressor_tpu_torch/csrc/bfp_linear.cu",
             replaces="dmx_compressor_tpu/ops/bfp_linear.py:53", launches=launches["bfp_linear"],
             max_abs_err=max(c["max_abs_err"] for c in b1), **b1_step, cases=b1),
        dict(name="flash_decode_int8", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/flash_decode_int8.cu",
             replaces="dmx_compressor_tpu/ops/flash_decode.py:305",
             launches=launches["flash_decode_int8"],
             max_abs_err=max(c["max_abs_err"] for c in b2),
             **{k: b2[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
             cases=b2),
        dict(name="flash_attention", route="cuda",
             source="dmx_compressor_tpu_torch/csrc/flash_attention.cu",
             replaces="dmx_compressor_tpu/ops/flash_attention.py:67",
             launches=launches["flash_attention"],
             max_abs_err=max(c["max_abs_err"] for c in b3),
             **{k: b3[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
             cases=b3),
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
