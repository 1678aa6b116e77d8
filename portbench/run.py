"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up (builds the kernels into the checkout's ``build/``, makes the
model's weights on the card from the seed, transforms and packs it, warms
the cell's own shapes), measures for ``--seconds``, frees the program,
checks what the window produced against the plain reference, and prints one
JSON line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; then ``check``, each
compared number beside its limit, also the last lines on standard error.
Exits non-zero without a result where the card is missing or the run loads
JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "dmx_compressor_tpu")
RETAKES = 2


def _process_start() -> float:
    """perf_counter at this process's start (its age from /proc)."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()


def _env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout; no
    library of the port's may load JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def jax_loaded() -> list:
    """Top-level names, compared whole, of the forbidden modules loaded."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a traffic kind's loop works with."""

    def __init__(self, cell, cfg, fam, ref, seed, device, spans):
        self.cell, self.cfg, self.fam, self.ref = cell, cfg, fam, ref
        self.seed, self.device, self.spans = seed, device, spans
        self.model = None
        self.phases = {}  # set-up: seconds since the process started, at each step's end

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def stamp(self, phase: str) -> None:
        self.sync()
        self.phases[phase] = round(time.perf_counter() - T_START, 3)


def build_program(ctx) -> None:
    """The port's model of the cell: its raw model built on the device, the
    seed's weights loaded, then the mode's transform (``build_<mode>_mode``
    of ``ops/compress.py``: the Dmx rules, packing, inference mode)."""
    import torch
    from dmx_compressor_tpu_torch.ops import compress

    from . import weights as W

    model = ctx.fam.port_model(ctx.cfg, ctx.device)
    ctx.stamp("construct")
    W.load_into(model, ctx.fam, ctx.cfg, ctx.seed)
    ctx.stamp("weights")
    getattr(compress, f"build_{ctx.cell['mode']}_mode")(model)
    model.eval()
    ctx.model = model
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.stamp("transform")


def free_program(ctx) -> None:
    import torch

    ctx.model = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def is_share(name: str) -> bool:
    """A share of a roofline or of a peak, which cannot pass 100 %."""
    return "roofline" in name or "mfu" in name


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cell: dict = None, cfg: dict = None, control: bool = False, man: dict = None,
             fault=None) -> dict:
    """One run; returns the result line's object.  ``cell`` / ``cfg`` replace
    the files of that name (the tests' tiny sizes); ``fault(ctx)``, called
    once the program is built, breaks it underneath (the tests).

    A traced window in which a share reads above 100 % lost records: it is
    taken again, up to ``RETAKES`` times, and then reported as measured."""
    import torch

    from . import catalog
    from .reference import judge
    from .trace import DeviceTrace, Spans, Trace, breakdown

    cell = cell or catalog.workload(cell_name)
    cfg = cfg or catalog.config(cell["config"])
    man = man or catalog.manifest()
    fam = catalog.family(cfg["family"])
    traffic = catalog.traffic(cell["traffic"])
    dev = torch.device(device)
    ctx = Context(cell, cfg, fam, catalog.reference(cfg["family"]), seed, dev, Spans(trace))
    ctx.stamp("start")
    if dev.type == "cuda":
        from dmx_compressor_tpu_torch import kernels

        kernels.build()
        torch.cuda.reset_peak_memory_stats()
        ctx.stamp("kernels")
    build_program(ctx)
    if fault is not None:
        fault(ctx)
    traffic.setup(ctx)
    ctx.stamp("warm")
    setup_s = time.perf_counter() - T_START
    per_layer = catalog.metrics_for(cell_name, "per_layer", man) if trace else []
    for take in range(1 + RETAKES):
        tracer = DeviceTrace() if trace and dev.type == "cuda" else None
        with tracer if tracer is not None else contextlib.nullcontext():
            win = traffic.run(ctx, seconds)
        if not trace:
            break
        tr = Trace(window_s=win.seconds, spans=ctx.spans, counters=win.counters, work=win.work,
                   t0=win.t0, t1=win.t1, kernels=tracer.kernels() if tracer is not None else [])
        metrics = {}
        for m in per_layer:
            v = catalog.metric_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        lost = [m for m in per_layer if is_share(m["name"]) and m["name"] in metrics
                and metrics[m["name"]]["value"] > 100.0]
        if not lost:
            break
        said = ", ".join(f"{m['name']} {metrics[m['name']]['value']!r} % ({m['layer']})"
                         for m in lost)
        if take < RETAKES:
            print(f"portbench: lost reading, {said}: the trace lost records; taking it again",
                  file=sys.stderr)
            ctx.spans.items.clear()
        else:
            print(f"portbench: {said} after {take + 1} takes: that layer's work is counted too "
                  f"high or its kernels' time misses part of it; reported as measured",
                  file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    free_program(ctx)
    readings = traffic.check(ctx, win, control=control)
    limits = cell["check"]["limits"]
    correct = judge.verdict(readings["program"], limits)

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win.attempted, "failed": win.failed}
    if trace:
        out["metrics"] = metrics
        out["device"] = dict(device_info, busy_s=tr.busy_s(), window_s=win.seconds)
        bd = breakdown(tr)
        if bd is not None:
            out["breakdown"] = bd
    else:
        values = dict(win.metrics, setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in catalog.metrics_for(cell_name, "end_to_end", man)}
        out["device"] = device_info
    out["check"] = judge.report(readings["program"], limits)
    out["_readings"] = readings
    if control:
        out["_control_correct"] = judge.verdict(readings["control"], limits)
    out["_counters"] = dict(win.counters, setup_s=setup_s, setup_phases=ctx.phases, takes=take + 1)
    return out


def _nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch

    from . import catalog

    cell = catalog.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = jax_loaded()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"portbench: {_nvidia_smi()}; readings {json.dumps(out.pop('_readings'))}; "
          f"counters {json.dumps(out.pop('_counters'))}", file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
