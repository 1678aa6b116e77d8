"""Rules of the port: it imports neither jax nor the JAX package, its kernel
wrappers have no fallback around a launch, its entry points default to the
card and raise without one, and ``chip_smoke.py`` fails without a card."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dmx_compressor_tpu_torch import kernels
from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from dmx_compressor_tpu_torch.ops.kv_cache import make_caches

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dmx_compressor_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "dmx_compressor_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dmx_compressor_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})]\n"
        "print(len([m for m in sys.modules if m.startswith('dmx_compressor_tpu_torch')]), bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split(maxsplit=1)
    assert int(out[0]) > 15 and out[1].strip() == "[]"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"


@pytest.mark.parametrize("name", ["kernels.py", "ops/bfp_linear.py", "ops/flash_decode.py",
                                  "ops/flash_attention.py"])
def test_kernel_wrappers_have_no_fallback(name):
    tree = ast.parse((PORT / name).read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), f"{name} has a try block"


def test_every_kernel_has_a_source_naming_its_tpu_kernel():
    for name, tpu in [("bfp_linear", "_bfp_matmul_pallas"),
                      ("flash_decode_int8", "_decode_grid_call"),
                      ("flash_attention", "_flash_pallas")]:
        src = (kernels.CSRC / f"{name}.cu").read_text()
        assert name in kernels.SIGNATURES and tpu in src
        assert kernels.library_path(name).parent == ROOT / "build" / "dmx_kernels"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OPTForCausalLM(OPTConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_caches(2, 1, 4, 16, 16, quantized=True)
    m = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 16, quantized=True)
    assert m.init_cache(1, 16, quantized=True, device="cpu")[0].k_q.device.type == "cpu"


def test_ab_linears_needs_a_card_and_reports_runs_side_by_side(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    script = PORT / "tools" / "ab_linears.py"
    out = tmp_path / "ab.jsonl"
    r = subprocess.run([sys.executable, str(script), "--root", str(ROOT), "--out", str(out)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and not out.exists()
    run = {"device": "card", "nvidia_smi": "card, 700.00 W"}
    out.write_text("\n".join(
        json.dumps(dict(run, label=label, B1={"8x768x768": t}, T1={"8x768x768": t}))
        for label, t in [("old", 0.5), ("new", 0.25), ("new", 0.75), ("old", 1.5)]))
    r = subprocess.run([sys.executable, str(script), "--report", str(out)],
                       capture_output=True, text=True, timeout=120, check=True)
    assert "card, 700.00 W" in r.stdout
    assert "0.5000 1.5000 (median 1.0000) | 0.2500 0.7500 (median 0.5000)" in r.stdout


def test_chip_smoke_fails_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:  # alone, without the rest of the repo
            script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
