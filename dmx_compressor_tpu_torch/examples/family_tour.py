"""Tour of the model-family surface over the port: every decoder family
BASIC-quantized, a seq2seq generation, and ATen-level interception of
un-authored code.

Port of ``examples/family_tour.py``, parts 1-3 (tiny configs, random
weights from seed 0).  From the root of a checkout:

    python -m dmx_compressor_tpu_torch.examples.family_tour [--device cuda|cpu]

The models run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..modeling.model import DmxModel


def ids(b, t, v, device, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, v, (b, t))).to(device)


def decoder_families():
    from ..models.gemma import GemmaConfig, GemmaForCausalLM
    from ..models.gpt2 import GPT2Config, GPT2LMHeadModel
    from ..models.llama import LlamaConfig, LlamaForCausalLM
    from ..models.mistral import MistralConfig, MistralForCausalLM
    from ..models.opt import OPTConfig, OPTForCausalLM
    from ..models.qwen3 import Qwen3Config, Qwen3ForCausalLM

    return [
        ("opt", OPTConfig.tiny(), OPTForCausalLM),
        ("gpt2", GPT2Config.tiny(), GPT2LMHeadModel),
        ("llama", LlamaConfig.tiny(), LlamaForCausalLM),
        ("mistral", MistralConfig.tiny(), MistralForCausalLM),
        ("gemma", GemmaConfig.tiny(), GemmaForCausalLM),
        ("qwen3", Qwen3Config.tiny(), Qwen3ForCausalLM),
    ]


@torch.no_grad()
def tour(device="cuda"):
    """The three parts; returns what each printed, by part."""
    from ..models.t5 import T5Config, T5ForConditionalGeneration

    out = {"families": {}}
    # 1. every decoder family under the BASIC rule set
    for name, cfg, cls in decoder_families():
        model = cls(cfg, device=device, seed=0)
        dm = DmxModel.from_raw(model)
        dm.to_basic_mode()
        x = ids(2, 16, cfg.vocab_size, device)
        fp32_ref = cls(cfg, device=device, seed=0)
        delta = float((dm(x) - fp32_ref(x)).abs().max())
        n_mods = sum(1 for _ in dm.named_dmx_modules())
        out["families"][name] = dict(dmx_modules=n_mods, delta=delta)
        print(f"{name:8s} BASIC ok: {n_mods:3d} dmx modules, |basic - fp32|max = {delta:.4f}")

    # 2. encoder-decoder generation (T5)
    t5 = T5ForConditionalGeneration(T5Config.tiny(), device=device, seed=0)
    DmxModel.from_raw(t5).to_basic_mode()
    gen = t5.generate(ids(2, 10, 512, device), torch.zeros((2, 1), dtype=torch.long,
                                                           device=device), max_new_tokens=6)
    out["t5_generate"] = tuple(gen.shape)
    print(f"t5       BASIC seq2seq generate ok: {tuple(gen.shape)}")

    # 3. ATen-level interception of un-authored torch code
    def third_party(x, w1, w2):
        return torch.relu(x @ w1) @ w2 + x

    rs = np.random.RandomState(0)
    args = tuple(torch.from_numpy(rs.randn(*s).astype(np.float32)).to(device)
                 for s in ((4, 64), (64, 64), (64, 64)))
    qf = DmxModel.from_function(third_party, args)
    d = float((qf(*args) - third_party(*args)).abs().max())
    out["intercept"] = dict(sites=qf.sites, delta=d)
    print(f"intercept ok: sites={qf.sites}, |quant - exact|max = {d:.4f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    tour(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
