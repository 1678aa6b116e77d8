"""Device times of B1 (``bfp_linear``) and T1 (``bfp_linear_bf16``) of one
checkout of the port, at OPT-125m's shapes, for comparing two versions.

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
inputs which together hold twice L2, so each call finds its weight cold: at
the weights path's decode (M = 8) and prefill (M = 1024) shapes (merged
qkv, out_proj, fc1, fc2, the LM head), and per launch over one decode
step's 49 launches.
Each shape is also held against its plain version at B1's tolerance.  It
imports only ``torch`` and the package under ``--root``, and needs a CUDA
card; each checkout builds its kernels into its own ``build/``.
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
D, F, V, L = 768, 3072, 50272, 12  # OPT-125m: hidden, ffn, vocabulary, layers
# (K, N, launches per decode step)
STEP = [(D, 3 * D, L), (D, D, L), (D, F, L), (F, D, L), (D, V, 1)]
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
    from dmx_compressor_tpu_torch.ops.bfp_linear import (
        bfp_linear,
        bfp_linear_bf16,
        bfp_linear_bf16_ref,
        bfp_linear_ref,
    )
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack

    if not Path(kernels.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {kernels.__file__}, not the package under {root}")
    kernels.build(["bfp_linear", "bfp_linear_bf16"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    sets_of = {}
    for K, N, _ in STEP:
        for M in (M_DECODE, M_PREFILL):
            nbytes = N * K + N * K // 64 + N * 4 + M * (K + N) * 4
            sets_of[M, K, N] = [
                (torch.randn(M, K, generator=g, device=dev),
                 bfp_pack(torch.randn(N, K, generator=g, device=dev) * 0.05, 8, 64),
                 torch.randn(N, generator=g, device=dev) * 0.1)
                for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]

    out = dict(label=label, root=str(root), device=torch.cuda.get_device_name(0))
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except OSError:
        out["nvidia_smi"] = None
    for name, kern, plain in (("B1", bfp_linear, bfp_linear_ref),
                              ("T1", bfp_linear_bf16, bfp_linear_bf16_ref)):
        times = {}
        for (M, K, N), sets in sets_of.items():
            x, w, b = sets[0]
            torch.testing.assert_close(kern(x, w, b), plain(x, w, b), **TOL)
            times[f"{M}x{K}x{N}"] = _device_ms(torch, kern, sets)
        step = [sets_of[M_DECODE, K, N][i % len(sets_of[M_DECODE, K, N])]
                for K, N, n in STEP for i in range(n)]
        times["decode step, per launch"] = _device_ms(
            torch, lambda: [kern(*a) for a in step], [()]) / len(step)
        out[name] = times
    return out


def report(path: Path) -> None:
    runs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    labels = list(dict.fromkeys(r["label"] for r in runs))
    print("cards:", sorted({r.get("nvidia_smi") or r["device"] for r in runs}))
    print("runs:", [r["label"] for r in runs])
    for name in ("B1", "T1"):
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
