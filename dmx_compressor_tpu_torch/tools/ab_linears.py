"""Device times of B1 (``bfp_linear``), T1 (``bfp_linear_bf16``), B5
(``sbfp_linear``) and B3 (``flash_attention``) of one checkout of the port,
at OPT-125m's shapes, for comparing two versions.

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
prefill's attention (batch 8 x 12 heads, L = S = 128, D 64, causal).
Each shape is also held against its plain version at the kernel's
tolerance.  It imports only ``torch`` and the package under ``--root``, and
needs a CUDA card; each checkout builds its kernels into its own ``build/``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

L2_BYTES = 50 * 2**20
TOL = dict(rtol=1e-5, atol=1e-4)
B3_TOL = dict(rtol=1e-5, atol=2e-5)
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


def measure(root: Path, label: str) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from dmx_compressor_tpu_torch import kernels
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
    from dmx_compressor_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    if not Path(kernels.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {kernels.__file__}, not the package under {root}")
    kernels.build(["bfp_linear", "bfp_linear_bf16", "sbfp_linear", "flash_attention"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
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

    bfp_sets = payloads(STEP, lambda w: bfp_pack(w, 8, 64), lambda K, N: N * K + N * K // 64)
    sbfp_sets = payloads(SBFP_STEP, lambda w: sbfp_pack(w, fmt),
                         lambda K, N: N * K // 2 + N * K // 16 * 4)

    out = dict(label=label, root=str(root), device=torch.cuda.get_device_name(0))
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except OSError:
        out["nvidia_smi"] = None
    for name, kern, plain, step_shapes, sets_of in (
            ("B1", bfp_linear, bfp_linear_ref, STEP, bfp_sets),
            ("T1", bfp_linear_bf16, bfp_linear_bf16_ref, STEP, bfp_sets),
            ("B5", sbfp_linear, sbfp_linear_ref, SBFP_STEP, sbfp_sets)):
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

    shape = (M_PREFILL // 128, H, 128, HEAD)
    attn_sets = [tuple(torch.randn(shape, generator=g, device=dev) for _ in range(3))
                 for _ in range(max(2, math.ceil(2 * L2_BYTES / (4 * 4 * math.prod(shape)))))]
    q, k, v = attn_sets[0]
    torch.testing.assert_close(flash_attention(q, k, v, causal=True),
                               flash_attention_ref(q, k, v, causal=True), **B3_TOL)
    out["B3"] = {"x".join(map(str, shape)) + " causal": _device_ms(
        torch, lambda q, k, v: flash_attention(q, k, v, causal=True), attn_sets)}
    return out


def report(path: Path) -> None:
    runs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    labels = list(dict.fromkeys(r["label"] for r in runs))
    print("cards:", sorted({r.get("nvidia_smi") or r["device"] for r in runs}))
    print("runs:", [r["label"] for r in runs])
    for name in [n for n in ("B1", "T1", "B5", "B3") if all(n in r for r in runs)]:
        shapes = list(runs[0][name])
        print(f"\n{name}, device ms per call (each run's time; median), "
              + " / ".join(labels))
        for shape in shapes:
            cells = []
            for lab in labels:
                ts = [r[name][shape] for r in runs if r["label"] == lab]
                cells.append(" ".join(f"{t:.4f}" for t in ts)
                             + f" (median {statistics.median(ts):.4f})")
            print(f"  {shape}: " + " | ".join(cells))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, help="checkout whose package is timed")
    ap.add_argument("--label", help="name of this run's version (default: --root)")
    ap.add_argument("--out", type=Path, help="JSON lines file to append the run to")
    ap.add_argument("--report", type=Path, help="print the runs of this file side by side")
    args = ap.parse_args()
    if args.report is not None:
        report(args.report)
        return 0
    if args.root is None or args.out is None:
        ap.error("--root and --out are needed to measure")
    result = measure(args.root, args.label or str(args.root))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
