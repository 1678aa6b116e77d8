"""Benchmark harness: per-mode runtime, error and accuracy tables.

Port of ``dmx_compressor_tpu/utils/benchmark.py``.  The modes are
``EVALUATION_MODE``'s; a runtime is host wall time around work that ends in
:func:`device_sync` (on the card ``torch.cuda.synchronize`` and the readback
of one value); the per-layer runtimes come from
:class:`~.monitor.RuntimeMeasurement` (CUDA events on the card); memory is
``torch.cuda``'s allocator statistics, None without a card, where the JAX
package's are None when its backend reports nothing.  Tables print as GitHub
markdown with the JAX package's rows and columns.

The JAX package times a runner that runs under ``jit`` as a whole (its
``ConcretizationTypeError`` branch: no per-module readback inside a trace).
Every runner of the port is eager, and while a measurement is open the
fused BASIC plans call each module (``DmxModule.monitors``), so the port
times every Dmx mode per module and has no such branch.
"""

from __future__ import annotations

import enum
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class EVALUATION_MODE(str, enum.Enum):
    VANILLA = "Vanilla"  # the raw model, no Dmx wrapping
    BASELINE = "Baseline"  # Dmx-wrapped, SAME formats
    FP8 = "FP8"
    BASIC = "Basic"
    BASIC_NOVSIMD = "Basic_NoVSIMD"  # BASIC numerics without approximations


def _strip_approximations(dm) -> None:
    from ..functional.approximate import NoApproximation

    for _, m in dm.named_dmx_modules():
        m.approximator.function = NoApproximation()


def configure_mode(dm, mode: EVALUATION_MODE):
    """Apply a mode's rule set to a DmxModel."""
    from .. import config_rules

    if mode == EVALUATION_MODE.BASELINE:
        dm.configure(None, *config_rules.BASELINE)
    elif mode == EVALUATION_MODE.FP8:
        dm.configure(None, *config_rules.FP8)
    elif mode == EVALUATION_MODE.BASIC:
        dm.configure(None, *config_rules.BASIC)
    elif mode == EVALUATION_MODE.BASIC_NOVSIMD:
        dm.configure(None, *config_rules.BASIC)
        _strip_approximations(dm)
    return dm


def gather_tensors(tensor_collection) -> List[torch.Tensor]:
    """The tensors inside a nest of tuples, lists and dicts, in order."""
    if isinstance(tensor_collection, torch.Tensor):
        return [tensor_collection]
    if isinstance(tensor_collection, dict):
        tensor_collection = list(tensor_collection.values())
    if isinstance(tensor_collection, (list, tuple)):
        return [t for x in tensor_collection for t in gather_tensors(x)]
    return []


def device_sync(out) -> float:
    """A completion barrier: ``torch.cuda.synchronize`` where the output
    lies on the card, then the readback of one value (the sum of |x| over
    its first tensor, which depends on the whole step)."""
    leaves = gather_tensors(out)
    if any(x.is_cuda for x in leaves):
        torch.cuda.synchronize()
    acc = 0.0
    for x in leaves[:1]:
        acc += float(x.detach().abs().to(torch.float32).sum())
    return acc


def measure_runtime(fn: Callable, *args, reps: int = 5, warmup: int = 2) -> float:
    """Best wall time of a device-synchronized callable (seconds)."""
    for _ in range(warmup):
        device_sync(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        device_sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def peak_memory_bytes() -> Optional[int]:
    """The card's peak allocated bytes since the last
    ``torch.cuda.reset_peak_memory_stats``; None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated()


def live_memory_bytes() -> Optional[int]:
    """The card's allocated bytes now; None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_allocated()


def measure_mode_perf(
    build_fn: Callable[[EVALUATION_MODE], Callable],
    example_args,
    modes: Optional[List[EVALUATION_MODE]] = None,
    reps: int = 5,
    dm_for_mode: Optional[Callable[[EVALUATION_MODE], object]] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-mode runtime, peak memory and, with ``dm_for_mode(mode)``
    returning the mode's DmxModel, each DmxModule's seconds
    (``records[mode]["per_layer"]``).  ``build_fn(mode)`` returns the
    mode's ready forward."""
    modes = modes or list(EVALUATION_MODE)
    records: Dict[str, Dict[str, float]] = {}
    for mode in modes:
        fn = build_fn(mode)
        t = measure_runtime(fn, *example_args, reps=reps)
        records[mode.value] = {"total_runtime_s": t}
        mem = peak_memory_bytes()
        if mem is not None:
            records[mode.value]["peak_mem_gb"] = mem / 2**30
        if dm_for_mode is not None:
            from .monitor import RuntimeMeasurement

            with RuntimeMeasurement(dm_for_mode(mode)) as rt:
                device_sync(fn(*example_args))
            records[mode.value]["per_layer"] = {
                name: float(np.sum(times)) for name, times in rt.get_records().items() if times
            }
    return records


def per_layer_table(records: Dict[str, Dict], top: Optional[int] = None) -> str:
    """Markdown table of per-layer runtimes across modes, sorted by the last
    mode's cost."""
    modes = [m for m in records if "per_layer" in records[m]]
    if not modes:
        return ""
    layers = sorted(records[modes[-1]]["per_layer"],
                    key=lambda n: -records[modes[-1]]["per_layer"][n])
    if top:
        layers = layers[:top]
    lines = ["| layer | " + " | ".join(f"{m} (s)" for m in modes) + " |",
             "|---" * (len(modes) + 1) + "|"]
    for layer in layers:
        vals = [f"{records[m]['per_layer'].get(layer, 0.0):.6g}" for m in modes]
        lines.append(f"| {layer} | " + " | ".join(vals) + " |")
    return "\n".join(lines)


def top_cast_cost_layers(
    records: Dict[str, Dict],
    mode: str = EVALUATION_MODE.BASIC.value,
    baseline: str = EVALUATION_MODE.BASELINE.value,
    k: int = 10,
) -> List[tuple]:
    """The layers whose fake-quant pipeline costs the most: the per-layer
    runtime of ``mode`` over ``baseline``."""
    a = records.get(mode, {}).get("per_layer", {})
    b = records.get(baseline, {}).get("per_layer", {})
    deltas = [(name, t - b.get(name, 0.0)) for name, t in a.items()]
    deltas.sort(key=lambda kv: -kv[1])
    return deltas[:k]


def _numpy64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def mode_output_error(
    outputs: Dict[str, torch.Tensor], reference_mode: str = EVALUATION_MODE.VANILLA.value
) -> Dict[str, Dict[str, float]]:
    """Output error of each mode against a reference mode, from computed
    outputs."""
    ref = _numpy64(outputs[reference_mode])
    rows = {}
    for mode, out in outputs.items():
        err = np.abs(_numpy64(out) - ref)
        denom = np.abs(ref).max() or 1.0
        rows[mode] = {
            "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()),
            "rel_err": float(err.max() / denom),
        }
    return rows


def markdown_table(records: Dict[str, Dict[str, float]], title: str = "") -> str:
    """A GitHub-markdown table, a row a mode (nested per-layer entries
    print apart)."""
    if not records:
        return ""
    cols = [c for c, v in next(iter(records.values())).items() if not isinstance(v, dict)]
    lines = []
    if title:
        lines.append(f"### {title}")
    lines.append("| mode | " + " | ".join(cols) + " |")
    lines.append("|---" * (len(cols) + 1) + "|")
    for mode, row in records.items():
        vals = [f"{row[c]:.6g}" if isinstance(row[c], float) else str(row[c]) for c in cols]
        lines.append(f"| {mode} | " + " | ".join(vals) + " |")
    return "\n".join(lines)


def evaluate_vsimd_ops_deltas(basic_time: float, novsimd_time: float) -> Dict[str, float]:
    """The approximations' runtime: BASIC minus BASIC without them."""
    return {
        "basic_s": basic_time,
        "basic_novsimd_s": novsimd_time,
        "vsimd_delta_s": basic_time - novsimd_time,
    }


# ---------------------------------------------------------------------------
# The model_maker contract: a zero-argument callable returning ``(model,
# model_runner, model_evaluator)`` (a fourth member, a device, is accepted
# and ignored).  ``model_runner(model)`` pushes one sample input through;
# ``model_evaluator(model, mode_desc)`` returns a {metric: value} dict.
# ---------------------------------------------------------------------------


def _call_model_maker(model_maker):
    out = model_maker()
    if len(out) == 4:
        model, runner, evaluator, _ = out
    else:
        model, runner, evaluator = out
    return model, runner, evaluator


def prepare_model(model, evaluation_mode: EVALUATION_MODE, model_runner):
    """Wrap in a DmxModel and configure for the mode; returns ``(model,
    vsimd_modules_by_type)``.

    VANILLA returns the raw model untouched.  The other modes wrap with
    ``DmxModel.from_raw`` (unless wrapped already), apply the mode's rules
    and run one sample forward, so lazy state lands outside the measured
    region.  BASIC and BASIC_NOVSIMD record the modules that carry a
    surrogate, by type; BASIC_NOVSIMD then strips the surrogates."""
    vsimd_modules_by_type = defaultdict(list)
    if evaluation_mode == EVALUATION_MODE.VANILLA:
        return model, vsimd_modules_by_type

    from ..functional.approximate import NoApproximation
    from ..modeling.model import DmxModel

    dm = model if isinstance(model, DmxModel) else DmxModel.from_raw(model)
    if evaluation_mode in (EVALUATION_MODE.BASIC, EVALUATION_MODE.BASIC_NOVSIMD):
        configure_mode(dm, EVALUATION_MODE.BASIC)
        for name, m in dm.named_dmx_modules():
            if not isinstance(m.approximator.function, NoApproximation):
                if evaluation_mode == EVALUATION_MODE.BASIC_NOVSIMD:
                    m.approximator.function = NoApproximation()
                vsimd_modules_by_type[type(m).__name__].append(name)
    else:
        configure_mode(dm, evaluation_mode)
    model_runner(dm)
    return dm, vsimd_modules_by_type


def _measure_mode_perf_dm(model, model_runner, evaluation_mode,
                          n_warmup_runs: int = 1, n_measure_runs: int = 3):
    """One mode's runtime record: VANILLA times the whole runner; a Dmx
    mode times every DmxModule and reports their sum as the total."""
    model, vsimd_modules_by_type = prepare_model(model, evaluation_mode, model_runner)
    for _ in range(n_warmup_runs):
        device_sync(model_runner(model))

    if evaluation_mode == EVALUATION_MODE.VANILLA:
        t1 = time.perf_counter()
        for _ in range(n_measure_runs):
            device_sync(model_runner(model))
        t2 = time.perf_counter()
        return {"total_time": (t2 - t1) / n_measure_runs,
                "per_layer_times": {}, "vsimd_modules_by_type": {}}

    mod_names = [name for name, _ in model.named_dmx_modules()]
    all_runtimes = []
    for _ in range(n_measure_runs):
        with model.measure_runtimes(mod_names) as rt:
            device_sync(model_runner(model))
        all_runtimes.append(rt.get_records())
    per_layer = {
        k: sum(sum(run.get(k, [])) for run in all_runtimes) / n_measure_runs
        for k in mod_names
    }
    return {
        "total_time": sum(per_layer.values()),
        "per_layer_times": per_layer,
        "vsimd_modules_by_type": dict(vsimd_modules_by_type),
    }


def measure_model_runtime(model_maker, modes: List[EVALUATION_MODE],
                          n_measure_runs: int = 3) -> Dict[str, Dict]:
    """Per-mode runtime table: memory, total time and a column a layer, as
    GitHub markdown; the VSIMD table too when both BASIC and BASIC_NOVSIMD
    are measured.  Returns the records."""
    results: Dict[str, Dict] = {}
    layer_names: List[str] = []
    for mode in modes:
        print(f"Starting runtime measurements for mode {mode.value}")
        model, model_runner, _ = _call_model_maker(model_maker)
        results[mode.value] = _measure_mode_perf_dm(
            model, model_runner, mode, n_measure_runs=n_measure_runs
        )
        # the live bytes after the mode's run: the peak would carry earlier
        # modes' peaks into later ones
        mem = live_memory_bytes()
        results[mode.value]["max_memory"] = mem if mem is not None else 0
        if len(results[mode.value]["per_layer_times"]) > len(layer_names):
            layer_names = list(results[mode.value]["per_layer_times"].keys())

    header = ["mode", "live memory (GB)", "total time (s)", *layer_names]
    lines = ["| " + " | ".join(header) + " |", "|---" * len(header) + "|"]
    for k, rec in results.items():
        row = [k, f"{rec['max_memory'] / 2**30:.4g}", f"{rec['total_time']:.6g}"]
        row += [f"{rec['per_layer_times'].get(n, 0.0):.6g}" for n in layer_names]
        lines.append("| " + " | ".join(row) + " |")
    print("\n".join(lines))

    deltas = vsimd_ops_deltas(results)
    if deltas is not None:
        print("\n### VSIMD operations\n")
        base = results[EVALUATION_MODE.BASIC_NOVSIMD.value]["total_time"]
        print("| Layer type | Time delta (s) | Total run time (s) |")
        print("|---|---|---|")
        print(f"| (BASIC mode time without VSIMD ops) |  | {base:.6g} |")
        acc = base
        for type_name, d in deltas.items():
            acc += d
            print(f"| {type_name} | {d:.6g} | {acc:.6g} |")
    return results


def vsimd_ops_deltas(results: Dict[str, Dict]) -> Optional[Dict[str, float]]:
    """Per module type, the surrogates' runtime: BASIC minus BASIC_NOVSIMD
    over the layers of that type."""
    b = EVALUATION_MODE.BASIC.value
    nb = EVALUATION_MODE.BASIC_NOVSIMD.value
    if b not in results or nb not in results:
        return None
    out = {}
    for type_name, layer_names in results[nb]["vsimd_modules_by_type"].items():
        tb = sum(results[b]["per_layer_times"].get(n, 0.0) for n in layer_names)
        tn = sum(results[nb]["per_layer_times"].get(n, 0.0) for n in layer_names)
        out[type_name] = tb - tn
    return out


def measure_model_accuracy(model_maker, modes: List[EVALUATION_MODE]
                           ) -> Dict[str, Dict[str, float]]:
    """Accuracy metrics per mode: a fresh model a mode, configured, then the
    maker's evaluator; one metrics-by-mode markdown table."""
    results: Dict[str, Dict[str, float]] = {}
    for mode in modes:
        print(f"Starting evaluation for mode {mode.value}")
        model, model_runner, evaluation_fn = _call_model_maker(model_maker)
        model, _ = prepare_model(model, mode, model_runner)
        results[mode.value] = evaluation_fn(model, mode.value)
    metric_names = list(next(iter(results.values())).keys())
    lines = ["| metric | " + " | ".join(results) + " |", "|---" * (len(results) + 1) + "|"]
    for metric in metric_names:
        vals = [f"{results[k][metric]:.6g}" for k in results]
        lines.append(f"| {metric} | " + " | ".join(vals) + " |")
    print("\n".join(lines))
    return results


def collect_layer_activations(model_maker, mode: EVALUATION_MODE):
    """Every DmxModule's outputs for one mode: ``(mods_dict,
    monitoring_records, final_output)``; VANILLA has no DmxModule and
    returns empty dicts and the output."""
    model, model_runner, _ = _call_model_maker(model_maker)
    model, _ = prepare_model(model, mode, model_runner)
    if mode == EVALUATION_MODE.VANILLA:
        return {}, {}, model_runner(model)
    mods_dict = dict(model.named_dmx_modules())
    with model.monitoring(list(mods_dict)) as mon:
        final_output = model_runner(model)
    return mods_dict, mon.records, final_output


def compute_error(out1, out2) -> Dict[str, float]:
    """MSE (summed over the pairs) and the largest |delta| over paired
    tensor collections, in f32."""
    t1, t2 = gather_tensors(out1), gather_tensors(out2)
    pairs = [(x.detach().to("cpu", torch.float32), y.detach().to("cpu", torch.float32))
             for x, y in zip(t1, t2)]
    mse = sum(float(torch.mean((x - y) ** 2)) for x, y in pairs)
    maxdelta = max([float(torch.max(torch.abs(x - y))) for x, y in pairs] + [0.0])
    return {"mse": mse, "maxdelta": maxdelta}


def measure_model_error(model_maker, modes: List[EVALUATION_MODE],
                        reference_mode: EVALUATION_MODE = EVALUATION_MODE.BASELINE
                        ) -> Dict[str, Dict]:
    """Each DmxModule's and the final output's error of each mode against a
    reference mode; a per-layer mse / maxdelta table a mode."""
    print(f"collecting activations for reference {reference_mode.value}")
    _, ref_acts, ref_out = collect_layer_activations(model_maker, reference_mode)
    results: Dict[str, Dict] = {}
    for mode in modes:
        if mode == reference_mode:
            continue
        print(f"collecting activations for mode {mode.value}")
        _, acts, out = collect_layer_activations(model_maker, mode)
        per_layer = {}
        for name, rec in acts.items():
            if name in ref_acts:
                per_layer[name] = compute_error(list(rec.outputs), list(ref_acts[name].outputs))
        results[mode.value] = {
            "per_layer": per_layer,
            "final_output": compute_error(out, ref_out),
        }
        lines = [f"### {mode.value} vs {reference_mode.value}",
                 "| layer | mse | maxdelta |", "|---|---|---|"]
        for name, err in per_layer.items():
            lines.append(f"| {name} | {err['mse']:.6g} | {err['maxdelta']:.6g} |")
        fo = results[mode.value]["final_output"]
        lines.append(f"| (final output) | {fo['mse']:.6g} | {fo['maxdelta']:.6g} |")
        print("\n".join(lines))
    return results
