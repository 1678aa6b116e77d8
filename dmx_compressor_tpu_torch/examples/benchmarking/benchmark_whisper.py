"""Whisper transcription benchmark across evaluation modes, over the port.

Port of ``examples/benchmarking/benchmark_whisper.py``: the runtime (each
DmxModule timed over an eager encoder-decoder forward of 4 decoder ids),
accuracy (greedy transcription of ``GEN_LEN`` tokens, its token agreement
with the Vanilla model's) and per-layer error tables of
``utils/benchmark.py``.  The features are synthetic, standard normal from
numpy's ``default_rng(0)``, as in the JAX example.  From the root of a
checkout:

    python -m dmx_compressor_tpu_torch.examples.benchmarking.benchmark_whisper \\
        [--full] [--layers N] [--device cuda|cpu] [--ckpt DIR]

``--full`` runs whisper-small (Whisper tiny otherwise), ``--layers N`` cuts
each stack to N layers; the weights are random (seed 0), or those of the
local HF checkpoint ``--ckpt DIR`` (``modeling.hf.read_hf_checkpoint`` and
``load_hf_state_dict``) at that width.  The model runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from ...modeling.hf import load_hf_state_dict, read_hf_checkpoint
from ...models.whisper import WhisperConfig, WhisperForConditionalGeneration
from ...utils.benchmark import (
    EVALUATION_MODE,
    measure_model_accuracy,
    measure_model_error,
    measure_model_runtime,
)

BATCH = 2
GEN_LEN = 12
MODES = [EVALUATION_MODE.VANILLA, EVALUATION_MODE.BASELINE, EVALUATION_MODE.BASIC_NOVSIMD,
         EVALUATION_MODE.BASIC]


def config(full: bool, layers: Optional[int] = None) -> WhisperConfig:
    cfg = WhisperConfig.small() if full else WhisperConfig.tiny()
    if layers is not None:
        cfg = dataclasses.replace(cfg, encoder_layers=layers, decoder_layers=layers)
    return cfg


def make_model_maker(cfg: WhisperConfig, device, ckpt=None):
    """The model_maker of ``utils/benchmark.py``: a fresh model a call (the
    checkpoint's weights loaded into it where ``ckpt`` names one), its
    runner (an eager forward) and its evaluator (a greedy transcription)."""
    tensors = (WhisperForConditionalGeneration.hf_tensor_converter(read_hf_checkpoint(ckpt))
               if ckpt is not None else None)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal(
        (BATCH, cfg.num_mel_bins, cfg.max_source_positions * 2), np.float32)).to(device)
    start = torch.zeros((BATCH, 1), dtype=torch.long, device=device)
    ids = torch.zeros((BATCH, 4), dtype=torch.long, device=device)
    vanilla = {}

    @torch.no_grad()
    def model_runner(m):
        return m(feats, ids)

    def model_evaluator(m, desc: str):
        """Token agreement with the Vanilla transcription."""
        print(f"evaluating whisper model {desc}")
        toks = m.generate(feats, start, max_new_tokens=GEN_LEN).cpu().numpy()
        if desc == EVALUATION_MODE.VANILLA.value:
            vanilla["tokens"] = toks
        ref = vanilla.get("tokens", toks)
        return {"token_agreement": float(np.mean(toks == ref)), "n_tokens": float(toks.size)}

    def model_maker():
        model = WhisperForConditionalGeneration(cfg, device=device, seed=0)
        if tensors is not None:
            load_hf_state_dict(model, tensors)
        return model, model_runner, model_evaluator

    return model_maker


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="whisper-small (Whisper tiny otherwise)")
    ap.add_argument("--layers", type=int, default=None, help="layers a stack (all otherwise)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None, help="a local HF checkpoint directory")
    args = ap.parse_args(argv)
    maker = make_model_maker(config(args.full, args.layers), torch.device(args.device),
                             args.ckpt)
    runtime = measure_model_runtime(maker, MODES)
    print()
    accuracy = measure_model_accuracy(maker, MODES)
    print()
    error = measure_model_error(maker, [EVALUATION_MODE.BASIC],
                                reference_mode=EVALUATION_MODE.BASELINE)
    return dict(runtime=runtime, accuracy=accuracy, error=error)


if __name__ == "__main__":
    main()
