"""Nothing the benchmark runs loads JAX, Flax or the JAX package: the
harness's imports for every cell, in a fresh process, compared by whole
top-level names (``dmx_compressor_tpu_torch`` is the port, not a match)."""

import subprocess
import sys

from portbench import catalog, run

PROBE = """
import sys, torch
from portbench import catalog, run
from portbench.trace import DeviceTrace, breakdown
from portbench.reference import judge
from dmx_compressor_tpu_torch.ops import compress
for w in catalog.manifest()["workloads"]:
    cell = catalog.workload(w["name"])
    cfg = catalog.config(cell["config"])
    catalog.family(cfg["family"])
    catalog.reference(cfg["family"])
    catalog.traffic(cell["traffic"])
    for m in catalog.metrics_for(w["name"], "per_layer"):
        catalog.metric_reader(m["name"])
assert "dmx_compressor_tpu_torch" in sys.modules
print(",".join(run.jax_loaded()))
"""


def test_no_jax_in_a_fresh_process():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         cwd=str(catalog.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dmx_compressor_tpu_torch_x", sys)
    assert "dmx_compressor_tpu" not in run.jax_loaded()
    monkeypatch.setitem(sys.modules, "dmx_compressor_tpu.ops", sys)
    assert "dmx_compressor_tpu" in run.jax_loaded()
