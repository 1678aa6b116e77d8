"""Tiny versions of the benchmark's cells for the CPU tests: the same files
with the widths and the traffic cut to what a test run holds."""

from __future__ import annotations

from portbench import catalog

# 512 wide: narrower, the bfloat16 control's NLL gap falls under the cells'
# limits (0.004-0.0042 at 64-128 wide, 0.0117-0.0132 at 512)
QWEN3 = dict(vocab_size=512, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=32, max_position_embeddings=256)
OPT = dict(vocab_size=512, hidden_size=512, ffn_dim=1024, num_hidden_layers=2,
           num_attention_heads=8, max_position_embeddings=512)
TRAFFIC = {"qwen3-0.6b.weights-score": dict(batch=2, seq=64),
           "opt-6.7b.weights-score": dict(batch=2, seq=128)}


def cell(name: str) -> tuple:
    """(cell, cfg) of ``name`` at a tiny size."""
    c = catalog.workload(name)
    cfg = catalog.config(c["config"])
    cfg.update(QWEN3 if cfg["family"] == "qwen3" else OPT)
    c["params"] = dict(c["params"], **TRAFFIC[name])
    return c, cfg


def run(name: str, seed: int = 20251018, trace: bool = False, control: bool = False,
        fault=None, seconds: float = 0.3) -> dict:
    from portbench import run as R

    c, cfg = cell(name)
    return R.run_cell(name, seed, seconds, trace, "cpu", cell=c, cfg=cfg, control=control,
                      fault=fault)
