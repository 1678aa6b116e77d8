"""Finds the benchmark's parts by name: configurations, cells, traffic kinds
and per-layer metric readers are files of their own under this folder."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def config(name: str) -> dict:
    """``configs/<name>.json``: the model family, its source and every width."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["name"] = name
    return cfg


def workload(name: str) -> dict:
    """``workloads/<name>.json``: configuration, numerics mode, traffic kind and
    its parameters, the check's sample and limits."""
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cell["name"] = name
    return cell


def family(name: str):
    """``families/<name>.py``: how the port builds a model of that family."""
    return importlib.import_module(f"portbench.families.{name}")


def reference(name: str):
    """``reference/<name>.py``: the plain PyTorch forward of that family."""
    return importlib.import_module(f"portbench.reference.{name}")


def traffic(kind: str):
    """``traffic/<kind>.py``: the generator and measuring loop of a traffic kind."""
    return importlib.import_module(f"portbench.traffic.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(trace)``, loaded by file path (a metric's
    name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def manifest() -> dict:
    """The root ``BENCHMARK.json``."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metrics_for(cell: str, kind: str, man: dict = None) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics the manifest asks of
    ``cell``: those that list it, and those that list no cells."""
    man = manifest() if man is None else man
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]
