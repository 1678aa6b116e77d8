"""OPT with INT8 per-group weights, SmoothQuant fused into them, and greedy
decode through the int8 KV cache, over the port.

Port of ``examples/opt_int8_smoothquant_kv.py``:

  1. build OPT and substitute the Dmx modules;
  2. INT8 weights on every Linear;
  3. static SmoothQuant on synthetic batches, fused into the weights;
  4. the weight casts calibrated per group of 64 inputs (MinMax, symmetric);
  5. the perplexity against f32, then greedy decode through the int8 KV cache.

From the root of a checkout:

    python -m dmx_compressor_tpu_torch.examples.opt_int8_smoothquant_kv \\
        [--config tiny|opt-125m] [--device cuda|cpu]

The model runs on the card unless ``--device cpu``; weights random (seed 0),
token streams numpy's ``default_rng(0)``, as in the JAX example.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from .. import format as fmt
from .. import nn as dmxnn
from ..advanced_recipe import (
    CastCalibrationHyperparams,
    DmxModuleQuantizerCalibrationHyperparams,
    DmxQuantizerCalibrationRecipe,
    DmxSmoothQuantRecipe,
    smoothquant_for_all_linears,
)
from ..modeling.hf import do_forward_on
from ..modeling.model import DmxConfigRule, DmxModel
from ..models.opt import OPTConfig, OPTForCausalLM
from ..numerics.observer import MinMaxObserver
from ..transform.substitute import named_dmx_modules

CONFIGS = {"tiny": OPTConfig.tiny, "opt-125m": OPTConfig.opt_125m}


def weight_group_calibration(group_size: int = 64):
    """Generator: calibrate every Linear's weight cast per group."""

    def gen(model):
        root = model.module if hasattr(model, "module") else model
        return {
            m: DmxModuleQuantizerCalibrationHyperparams(weight=CastCalibrationHyperparams(
                observer_cls=MinMaxObserver, qscheme_to_overload="per_tensor_symmetric",
                group_size=group_size, ch_axis=-1))
            for _, m in named_dmx_modules(root) if isinstance(m, dmxnn.Linear)
        }

    return gen


def build(model: OPTForCausalLM, rng: np.random.Generator, eval_len: int = 512,
          window: int = 32) -> Dict:
    """Steps 1-5 but the decode over ``model`` (substituted in place)."""
    cfg = model.cfg
    device = next(model.parameters()).device
    eval_ids = rng.integers(0, cfg.vocab_size, eval_len)
    ppl_fp32 = do_forward_on(model, eval_ids, max_length=window)["perplexity"]
    dm = DmxModel.from_raw(model)
    dm.configure(None, DmxConfigRule(module_types=(dmxnn.Linear,),
                                     module_config=dict(weight_format=fmt.INT8)))
    calib_ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)), dtype=torch.long,
                                device=device)
    with torch.no_grad():
        # SmoothQuant first (activation outliers migrate into the weights) ...
        with DmxSmoothQuantRecipe(smoothquant_for_all_linears(
                migration_strength=0.5, fuse_to_weight=True)).applied_to(dm):
            dm(calib_ids)
        # ... then the per-group weight scales of the smoothed weights
        with DmxQuantizerCalibrationRecipe(weight_group_calibration(64)).applied_to(dm):
            dm(calib_ids)
    ppl_q = do_forward_on(model, eval_ids, max_length=window)["perplexity"]
    return dict(fp32=ppl_fp32, quantized=ppl_q, dm=dm)


@torch.no_grad()
def generate(model: OPTForCausalLM, ids: torch.Tensor, new_tokens: int) -> torch.Tensor:
    """Greedy decode (first maximum, as ``jnp.argmax``) through an int8 KV
    cache: [B, new_tokens]."""
    B, T = ids.shape
    caches = model.init_cache(B, T + new_tokens, quantized=True, device=ids.device)
    logits = model(ids, caches=caches, position_offset=0)
    tok = torch.argmax(logits[:, -1], dim=-1)
    toks = [tok]
    for i in range(new_tokens - 1):
        logits = model(tok[:, None], caches=caches, position_offset=T + i)
        tok = torch.argmax(logits[:, -1], dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    model = OPTForCausalLM(CONFIGS[args.config](), device=args.device, seed=0)
    rng = np.random.default_rng(0)
    out = build(model, rng)
    print(f"fp32 ppl {out['fp32']:.3f} | int8-group+smoothquant ppl {out['quantized']:.3f} "
          f"| delta {out['quantized'] - out['fp32']:+.4f}")
    B, T, G = 2, 8, 8
    ids = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, (B, T)), dtype=torch.long,
                          device=next(model.parameters()).device)
    print("generated (int8 KV cache):", generate(model, ids, G).cpu().numpy())


if __name__ == "__main__":
    main()
