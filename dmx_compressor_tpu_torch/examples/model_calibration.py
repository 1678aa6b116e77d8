"""End-to-end PTQ walkthrough over the port: build OPT, apply the BASIC
rules, calibrate INT8 input quantizers (MinMax) and SmoothQuant on synthetic
data, measure the perplexity at each stage.

Port of ``examples/model_calibration.py``.  From the root of a checkout:

    python -m dmx_compressor_tpu_torch.examples.model_calibration \\
        [--config tiny|opt-125m] [--device cuda|cpu]

The model runs on the card unless ``--device cpu``; its weights are random
(seed 0), the token streams numpy's ``default_rng(0)``, as in the JAX
example.  Prints the three perplexities and the calibrated one's change.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from .. import format as fmt
from .. import nn as dmxnn
from ..advanced_recipe import (
    DmxQuantizerCalibrationRecipe,
    DmxSmoothQuantRecipe,
    input_calibration_for_all_linears,
    smoothquant_for_all_linears,
)
from ..modeling.hf import do_forward_on
from ..modeling.model import DmxConfigRule, DmxModel
from ..models.opt import OPTConfig, OPTForCausalLM
from ..numerics.observer import MinMaxObserver

CONFIGS = {"tiny": OPTConfig.tiny, "opt-125m": OPTConfig.opt_125m}


def calibrate(model: OPTForCausalLM, rng: np.random.Generator, eval_len: int = 512,
              window: int = 32) -> Dict:
    """The example's flow over ``model`` (a raw OPT, substituted in place);
    returns the perplexities and the DmxModel."""
    cfg = model.cfg
    device = next(model.parameters()).device
    eval_ids = rng.integers(0, cfg.vocab_size, eval_len)
    ppl_fp32 = do_forward_on(model, eval_ids, max_length=window)["perplexity"]

    dm = DmxModel.from_raw(model)
    dm.to_basic_mode()
    ppl_basic = do_forward_on(model, eval_ids, max_length=window)["perplexity"]

    # INT8 input quantization on every Linear, calibrated by MinMax observers
    dm.configure(None, DmxConfigRule(module_types=(dmxnn.Linear,),
                                     module_config=dict(input_formats=[fmt.INT8])))
    calib_ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)), dtype=torch.long,
                                device=device)
    with torch.no_grad():
        with DmxQuantizerCalibrationRecipe(
                input_calibration_for_all_linears(observer_cls=MinMaxObserver)).applied_to(dm):
            dm(calib_ids)
        with DmxSmoothQuantRecipe(
                smoothquant_for_all_linears(migration_strength=0.5)).applied_to(dm):
            dm(calib_ids)
    ppl_calib = do_forward_on(model, eval_ids, max_length=window)["perplexity"]
    return dict(fp32=ppl_fp32, basic=ppl_basic, calibrated=ppl_calib, dm=dm)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    model = OPTForCausalLM(CONFIGS[args.config](), device=args.device, seed=0)
    out = calibrate(model, np.random.default_rng(0))
    print(f"fp32 perplexity: {out['fp32']:.3f}")
    print(f"BASIC (uncalibrated) perplexity: {out['basic']:.3f}")
    print(f"BASIC + INT8-in (calibrated, smoothquant) perplexity: {out['calibrated']:.3f}")
    print(f"delta vs fp32: {out['calibrated'] - out['fp32']:+.4f}")


if __name__ == "__main__":
    main()
