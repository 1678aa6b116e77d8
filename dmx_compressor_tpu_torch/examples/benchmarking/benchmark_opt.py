"""Per-mode runtime and output-error benchmark for OPT, over the port.

Port of ``examples/benchmarking/benchmark_opt.py``: one DmxModel configured
in each ``EVALUATION_MODE`` in turn (Vanilla the raw model, then Baseline,
FP8, Basic and Basic without the surrogates), a forward of ids [4, 32] and
its best time over 3 device-synchronized runs each; prints the runtime table
and each mode's output error against Vanilla.  From the root of a checkout:

    python -m dmx_compressor_tpu_torch.examples.benchmarking.benchmark_opt \\
        [--full] [--device cuda|cpu]

``--full`` runs OPT-125m (the JAX example's OPT tiny otherwise).  The
weights are random (seed 0), the ids numpy's ``default_rng(0)``.  The model
runs on the card unless ``--device cpu``.  As in the JAX example, there is
no ``--ckpt``.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from ...modeling.model import DmxModel
from ...models.opt import OPTConfig, OPTForCausalLM
from ...utils.benchmark import (
    EVALUATION_MODE,
    configure_mode,
    markdown_table,
    measure_runtime,
    mode_output_error,
)

BATCH, SEQ = 4, 32


def build(full: bool, device):
    """The raw model (seed 0) and its ids [BATCH, SEQ]."""
    cfg = OPTConfig.opt_125m() if full else OPTConfig.tiny()
    model = OPTForCausalLM(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, SEQ)), dtype=torch.long,
                        device=model.model.decoder.embed_tokens.weight.device)
    return model, x


@torch.no_grad()
def run(model, x) -> Dict[str, Dict]:
    """Every mode's runtime record and output; the model is substituted in
    place after its Vanilla run."""
    outputs = {EVALUATION_MODE.VANILLA.value: model(x)}
    runtimes = {EVALUATION_MODE.VANILLA.value: {"total_runtime_s": measure_runtime(model, x,
                                                                                   reps=3)}}
    dm = DmxModel.from_raw(model)
    for mode in list(EVALUATION_MODE)[1:]:
        configure_mode(dm, mode)
        outputs[mode.value] = dm(x)
        runtimes[mode.value] = {"total_runtime_s": measure_runtime(dm, x, reps=3)}
    return dict(runtimes=runtimes, errors=mode_output_error(outputs), outputs=outputs)


def main(argv=None) -> Dict[str, Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="OPT-125m (OPT tiny otherwise)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(*build(args.full, args.device))
    print(markdown_table(out["runtimes"], "Per-mode runtime"))
    print()
    print(markdown_table(out["errors"], "Output error vs Vanilla"))
    return out


if __name__ == "__main__":
    main()
