"""Device times of B1 (``bfp_linear``), T1 (``bfp_linear_bf16``), B5
(``sbfp_linear``: SBFP12_16 as "B5", its f32 route as "B5f32"), B3
(``flash_attention``), T2 (``bfp_cast`` / ``fp16_cast``), B2
(``flash_decode_int8``) and B4 (``flash_decode``) of one checkout of the
port, at OPT-125m's shapes, for comparing two versions.

Two versions of a kernel compare fairly only within one call on one card (a
card set below its power maximum runs slower under load, and clocks differ
between machines).  This script times the package it finds under ``--root``
and appends one JSON line to ``--out``; run it over two checkouts in turn,
A B B A, then ``--report`` prints each shape's times side by side:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 dmx_compressor_tpu_torch/tools/ab_linears.py --root $r \\
            --out build/ab_linears.jsonl
    done
    python3 dmx_compressor_tpu_torch/tools/ab_linears.py --report build/ab_linears.jsonl

A time is torch.profiler device time per call (the wrapper's pre-pass
kernels included) over at least 20 calls that cycle through copies of the
inputs which together hold twice L2, so each call finds its weight cold: B1
and T1 at the weights path's decode (M = 8) and prefill (M = 1024) shapes
(merged qkv, out_proj, fc1, fc2, the LM head) and per launch over one
decode step's 49 launches; B5 likewise at the SBFP path's shapes (q, k, v
and out_proj unmerged, fc1, fc2, the head; 73 launches a step); B3 at the
prefill's attention (batch 8 x 12 heads, L = S = 128, D 64, causal) and
at Qwen3-0.6B's and Gemma-2B's (8 x 16 heads of 128, 8 x 8 of 256) where
the checkout takes them; T2 at
the BASIC path's cast sites (the S-blocked tail-v cast, the prefill's
[1024, 3072] and scores casts, the decode casts, the FLOAT16-then-BFP pairs
of the fused step: one composed call where the checkout has
``fp16_first``, else its two calls) and over one BASIC decode step's casts;
B2 at the weights path's decode attention (S 256, lengths 160), at
bench.py's long leg (S 2048, lengths 2016) and with GQA; B4 likewise on f32
K/V at the baseline path's shape, the long leg, one row of 8000 keys, GQA
(rep 4, ragged) and ragged rows; B5f32 at the SBFP formats off bf16 (a 5-bit scale, a 13-bit
one, blocks of 8 and 24) at M 8 and 1024, and per launch over one decode
step of the SBFP path's shapes at the 5-bit scale (73 launches).
``--kernels`` picks the kernels (default all).  Each shape is also held
against its plain version at the kernel's tolerance (T2: bit for bit).
It imports only ``torch`` and the package under ``--root``, and needs a
CUDA card; each checkout builds its kernels into its own ``build/``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

L2_BYTES = 50 * 2**20
TOL = dict(rtol=1e-5, atol=1e-4)
B3_TOL = dict(rtol=1e-5, atol=2e-5)
B2_TOL = dict(rtol=1e-5, atol=2e-5)
B4_TOL = dict(rtol=1e-5, atol=2e-5)
KERNELS = ("B1", "T1", "B5", "B3", "T2", "B2", "B4", "B5f32")
D, F, V, L = 768, 3072, 50272, 12  # OPT-125m: hidden, ffn, vocabulary, layers
H, HEAD = 12, 64  # its heads and head dim
# (K, N, launches per decode step): the weights path's, the SBFP path's
STEP = [(D, 3 * D, L), (D, D, L), (D, F, L), (F, D, L), (D, V, 1)]
SBFP_STEP = [(D, D, 4 * L), (D, F, L), (F, D, L), (D, V, 1)]
M_DECODE, M_PREFILL = 8, 8 * 128


def _device_ms(torch, fn, arg_sets, iters: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile

    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    n = max(iters, len(arg_sets))
    # the profiler now and then hands back an empty trace, or one that lost
    # some kernels: every kernel must appear a multiple of n times
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        taken = [(e.self_device_time_total, e.count) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0]
        if taken and not any(count % n for _, count in taken):
            return sum(us for us, _ in taken) / 1e3 / n
    raise RuntimeError(f"torch.profiler recorded no whole trace of {n} calls in five tries")


def measure(root: Path, label: str, which=KERNELS) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from dmx_compressor_tpu_torch import kernels

    if not Path(kernels.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {kernels.__file__}, not the package under {root}")
    names = {"B1": "bfp_linear", "T1": "bfp_linear_bf16", "B5": "sbfp_linear",
             "B3": "flash_attention", "T2": "bfp_cast", "B2": "flash_decode_int8",
             "B4": "flash_decode", "B5f32": "sbfp_linear"}
    kernels.build(sorted({names[k] for k in which}))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)

    out = dict(label=label, root=str(root), device=torch.cuda.get_device_name(0))
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except OSError:
        out["nvidia_smi"] = None
    linears = [k for k in ("B1", "T1", "B5") if k in which]
    if linears:
        out.update(_linears(torch, dev, g, linears))
    if "B3" in which:
        out.update(_b3(torch, dev, g))
    if "T2" in which:
        out["T2"] = _t2(torch, dev, g)
    if "B2" in which:
        out["B2"] = _b2(torch, dev, g)
    if "B4" in which:
        out["B4"] = _b4(torch, dev, g)
    if "B5f32" in which:
        out["B5f32"] = _b5f32(torch, dev, g)
    return out


def _linears(torch, dev, g, which) -> dict:
    from dmx_compressor_tpu_torch.numerics.format import Format
    from dmx_compressor_tpu_torch.ops.bfp_linear import (
        bfp_linear,
        bfp_linear_bf16,
        bfp_linear_bf16_ref,
        bfp_linear_ref,
        sbfp_linear,
        sbfp_linear_ref,
    )
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, sbfp_pack
    from dmx_compressor_tpu_torch.ops.compress import SBFP12_16

    fmt = Format.from_shorthand(SBFP12_16)

    def payloads(step, pack, weight_bytes):
        sets_of = {}
        for K, N, _ in step:
            for M in (M_DECODE, M_PREFILL):
                nbytes = weight_bytes(K, N) + N * 4 + M * (K + N) * 4
                sets_of[M, K, N] = [
                    (torch.randn(M, K, generator=g, device=dev),
                     pack(torch.randn(N, K, generator=g, device=dev) * 0.05),
                     torch.randn(N, generator=g, device=dev) * 0.1)
                    for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]
        return sets_of

    out = {}
    bfp_sets = (payloads(STEP, lambda w: bfp_pack(w, 8, 64), lambda K, N: N * K + N * K // 64)
                if {"B1", "T1"} & set(which) else None)
    sbfp_sets = (payloads(SBFP_STEP, lambda w: sbfp_pack(w, fmt),
                          lambda K, N: N * K // 2 + N * K // 16 * 4) if "B5" in which else None)
    for name, kern, plain, step_shapes, sets_of in (
            ("B1", bfp_linear, bfp_linear_ref, STEP, bfp_sets),
            ("T1", bfp_linear_bf16, bfp_linear_bf16_ref, STEP, bfp_sets),
            ("B5", sbfp_linear, sbfp_linear_ref, SBFP_STEP, sbfp_sets)):
        if name not in which:
            continue
        times = {}
        for (M, K, N), sets in sets_of.items():
            x, w, b = sets[0]
            torch.testing.assert_close(kern(x, w, b), plain(x, w, b), **TOL)
            times[f"{M}x{K}x{N}"] = _device_ms(torch, kern, sets)
        step = [sets_of[M_DECODE, K, N][i % len(sets_of[M_DECODE, K, N])]
                for K, N, n in step_shapes for i in range(n)]
        times["decode step, per launch"] = _device_ms(
            torch, lambda: [kern(*a) for a in step], [()]) / len(step)
        out[name] = times
    return out


def _b3(torch, dev, g) -> dict:
    from dmx_compressor_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    times = {}
    # OPT's prefill, then Qwen3-0.6B's (16 heads of 128) and Gemma-2B's (8
    # of 256) after flash_prefill's head repeat, where the checkout's kernel
    # takes that head_dim
    for shape in [(M_PREFILL // 128, H, 128, HEAD), (8, 16, 128, 128), (8, 8, 128, 256)]:
        attn_sets = [tuple(torch.randn(shape, generator=g, device=dev) for _ in range(3))
                     for _ in range(max(2, math.ceil(2 * L2_BYTES / (4 * 4 * math.prod(shape)))))]
        q, k, v = attn_sets[0]
        try:
            got = flash_attention(q, k, v, causal=True)
        except ValueError:  # a checkout whose kernel refuses this head_dim
            continue
        torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal=True), **B3_TOL)
        times["x".join(map(str, shape)) + " causal"] = _device_ms(
            torch, lambda q, k, v: flash_attention(q, k, v, causal=True), attn_sets)
    return {"B3": times}


# one BASIC decode step's casts at OPT-125m (batch 8, a 192-slot cache whose
# tail holds 64), (mode, shape, axis) in launch order; "fp16bfp" is a FLOAT16
# cast whose output the next BFP cast takes (chip_smoke.py t2_step_launches)
_X, _SC = ("fp16", (8, 1, D), -1), ("fp16", (8, H, 1, 192), -1)
T2_LAYER = [_X, ("fp16bfp", (8, 1, D), -1), ("bfp", (8, H, 1, HEAD), -1),
            ("bfp", (8, H, 64, HEAD), -1), _SC, ("fp16", (192,), -1), _SC, _SC,
            ("fp16bfp", (8, H, 1, 192), -1), ("bfp", (8, H, 64, HEAD), -2),
            ("fp16", (8, H, 1, HEAD), -1), ("bfp", (8, 1, D), -1), _X, _X,
            ("fp16bfp", (8, 1, D), -1), ("bfp", (8, 1, F), -1)]
T2_STEP = [_X, _X] + T2_LAYER * L + [("fp16bfp", (8, 1, D), -1)]
T2_SITES = [("tail v", "bfp", (8, H, 64, HEAD), -2), ("prefill x", "bfp", (M_PREFILL, F), -1),
            ("prefill x", "fp16", (M_PREFILL, F), -1),
            ("prefill scores", "bfp", (8, H, 128, 128), -1), ("decode x", "bfp", (8, D), -1),
            ("decode x", "fp16", (8, D), -1), ("decode x", "fp16bfp", (8, D), -1),
            ("decode scores", "fp16bfp", (8, H, 1, 192), -1),
            ("prefill scores", "fp16bfp", (8, H, 128, 128), -1)]


def _t2(torch, dev, g) -> dict:
    from dmx_compressor_tpu_torch.ops import bfp_cast as T2

    composed = "fp16_first" in inspect.signature(T2.bfp_cast).parameters

    def run(mode, x, axis):
        if mode == "fp16":
            return T2.fp16_cast(x)
        if mode == "fp16bfp":
            if composed:
                return T2.bfp_cast(x, 8, 64, axis, fp16_first=True)
            return T2.bfp_cast(T2.fp16_cast(x), 8, 64, axis)
        return T2.bfp_cast(x, 8, 64, axis)

    def plain(mode, x, axis):
        if mode == "fp16":
            return T2.fp16_cast_ref(x)
        if mode == "fp16bfp":
            x = T2.fp16_cast_ref(x)
        return T2.bfp_cast_ref(x, 8, 64, axis)

    times = {}
    for label, mode, shape, axis in T2_SITES:
        sets = [(torch.randn(shape, generator=g, device=dev) * 3,)
                for _ in range(max(2, math.ceil(2 * L2_BYTES / (8 * math.prod(shape)))))]
        x = sets[0][0]
        got, want = run(mode, x, axis), plain(mode, x, axis)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"T2 {mode} {shape} differs from its plain version")
        times[f"{label} {mode} {list(shape)} axis {axis}"] = _device_ms(
            torch, lambda x_: run(mode, x_, axis), sets)
    inputs = [torch.randn(shape, generator=g, device=dev) for _, shape, _ in T2_STEP]
    times["BASIC decode step, all casts"] = _device_ms(
        torch, lambda: [run(m, x, a) for (m, _, a), x in zip(T2_STEP, inputs)], [()])
    return times


def _b2(torch, dev, g) -> dict:
    from dmx_compressor_tpu_torch.ops import flash_decode as tfd
    from dmx_compressor_tpu_torch.ops.kv_cache import QuantizedKVCache, QuantKV

    shapes = {"path: B 8, H 12, S 256, lengths 160": (8, H, H, 256, [160] * 8),
              "long: B 8, H 12, S 2048, lengths 2016": (8, H, H, 2048, [2016] * 8),
              "GQA: B 8, H 12, Hkv 4, S 256, lengths 160": (8, H, 4, 256, [160] * 8)}
    sets_of = {}
    for key, (B, H_, Hkv, S, lengths) in shapes.items():
        per_set = B * Hkv * S * (2 * HEAD + 8)
        sets = []
        for _ in range(max(2, math.ceil(2 * L2_BYTES / per_set))):
            kq, ks = QuantizedKVCache._quantize(torch.randn(B, Hkv, S, HEAD, generator=g,
                                                            device=dev))
            vq, vs = QuantizedKVCache._quantize(torch.randn(B, Hkv, S, HEAD, generator=g,
                                                            device=dev))
            sets.append((torch.randn(B, H_, 1, HEAD, generator=g, device=dev),
                         QuantKV(kq, vq, ks, vs),
                         torch.tensor(lengths, dtype=torch.int32, device=dev)))
        sets_of[key] = sets

    times = {}
    for key, sets in sets_of.items():
        torch.testing.assert_close(tfd.flash_decode_int8(*sets[0]),
                                   tfd.flash_decode_int8_ref(*sets[0]), **B2_TOL)
        times[key] = _device_ms(torch, tfd.flash_decode_int8, sets)
    return times


def _b4(torch, dev, g) -> dict:
    from dmx_compressor_tpu_torch.ops import flash_decode as tfd

    shapes = {"path: B 8, H 12, S 256, lengths 160": (8, H, H, 256, [160] * 8),
              "long: B 8, H 12, S 2048, lengths 2016": (8, H, H, 2048, [2016] * 8),
              "long, batch 1: B 1, H 12, S 8192, lengths 8000": (1, H, H, 8192, [8000]),
              "GQA: B 3, H 8, Hkv 2, S 256, lengths 17, 256, 130": (3, 8, 2, 256, [17, 256, 130]),
              "ragged: B 8, H 12, S 200, lengths 1..200":
                  (8, H, H, 200, [1 + (199 * i) // 7 for i in range(8)])}
    times = {}
    for key, (B, H_, Hkv, S, lengths) in shapes.items():
        per_set = 2 * B * Hkv * S * HEAD * 4
        sets = [(torch.randn(B, H_, 1, HEAD, generator=g, device=dev),
                 torch.randn(B, Hkv, S, HEAD, generator=g, device=dev),
                 torch.randn(B, Hkv, S, HEAD, generator=g, device=dev),
                 torch.tensor(lengths, dtype=torch.int32, device=dev))
                for _ in range(max(2, math.ceil(2 * L2_BYTES / per_set)))]
        torch.testing.assert_close(tfd.flash_decode(*sets[0]), tfd.flash_decode_ref(*sets[0]),
                                   **B4_TOL)
        times[key] = _device_ms(torch, tfd.flash_decode, sets)
    return times


# (shorthand, K, N) of B5's f32 route: OPT-125m's out_proj at a 5-bit and a
# 13-bit scale, blocks of 8 and 24 at small K
B5F32_FORMATS = [("SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}", D, D),
                 ("SBFP<XP[4,0](CSN)><FP[0|4|13,16](FN)>{16}", D, D),
                 ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{8}", 40, 48),
                 ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{24}", 72, 200)]


def _b5f32(torch, dev, g) -> dict:
    from dmx_compressor_tpu_torch.numerics.format import Format
    from dmx_compressor_tpu_torch.ops.bfp_linear import sbfp_linear, sbfp_linear_ref
    from dmx_compressor_tpu_torch.ops.bfp_pack import sbfp_pack

    def payloads(fmt, M, K, N):
        nbytes = N * K // 2 + N * K // fmt.block_size * 4 + N * 4 + M * (K + N) * 4
        return [(torch.randn(M, K, generator=g, device=dev),
                 sbfp_pack(torch.randn(N, K, generator=g, device=dev) * 0.05, fmt),
                 torch.randn(N, generator=g, device=dev))
                for _ in range(max(2, min(64, math.ceil(2 * L2_BYTES / nbytes))))]

    times = {}
    for shorthand, K, N in B5F32_FORMATS:
        fmt = Format.from_shorthand(shorthand)
        for M in (M_DECODE, M_PREFILL):
            sets = payloads(fmt, M, K, N)
            torch.testing.assert_close(sbfp_linear(*sets[0]), sbfp_linear_ref(*sets[0]), **TOL)
            times[f"{shorthand} {M}x{K}x{N}"] = _device_ms(torch, sbfp_linear, sets)
    fmt = Format.from_shorthand(B5F32_FORMATS[0][0])
    sets_of = {(K, N): payloads(fmt, M_DECODE, K, N) for K, N, _ in SBFP_STEP}
    step = [sets_of[K, N][i % len(sets_of[K, N])] for K, N, n in SBFP_STEP for i in range(n)]
    times["5-bit scale, decode step, per launch"] = _device_ms(
        torch, lambda: [sbfp_linear(*a) for a in step], [()]) / len(step)
    return times


def report(path: Path) -> None:
    runs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    labels = list(dict.fromkeys(r["label"] for r in runs))
    print("cards:", sorted({r.get("nvidia_smi") or r["device"] for r in runs}))
    print("runs:", [r["label"] for r in runs])
    # each kernel's times, side by side for the versions whose runs have it
    names = list(dict.fromkeys(k for r in runs for k, v in r.items() if isinstance(v, dict)))
    for name in names:
        having = [r for r in runs if name in r]
        labs = list(dict.fromkeys(r["label"] for r in having))
        print(f"\n{name}, device ms per call (each run's time; median), " + " / ".join(labs))
        for shape in having[0][name]:
            cells = []
            for lab in labs:
                ts = [r[name][shape] for r in having if r["label"] == lab and shape in r[name]]
                cells.append(" ".join(f"{t:.4f}" for t in ts)
                             + (f" (median {statistics.median(ts):.4f})" if ts else "-"))
            print(f"  {shape}: " + " | ".join(cells))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, help="checkout whose package is timed")
    ap.add_argument("--label", help="name of this run's version (default: --root)")
    ap.add_argument("--out", type=Path, help="JSON lines file to append the run to")
    ap.add_argument("--report", type=Path, help="print the runs of this file side by side")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated kernels to time, of {','.join(KERNELS)}")
    args = ap.parse_args()
    if args.report is not None:
        report(args.report)
        return 0
    if args.root is None or args.out is None:
        ap.error("--root and --out are needed to measure")
    which = tuple(k for k in args.kernels.split(",") if k)
    if set(which) - set(KERNELS):
        ap.error(f"unknown kernels {sorted(set(which) - set(KERNELS))}")
    result = measure(args.root, args.label or str(args.root), which)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
