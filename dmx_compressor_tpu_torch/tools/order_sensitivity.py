"""How far the BASIC and FP8 paths' logits move when their sums run in
another order.

The BASIC path's FLOAT16 and BFP casts round values that come out of f32
sums: the matmuls, the LayerNorm moments, the softmax sums.  Where a sum's
last bit differs, a cast may land one step apart, and the step propagates
through the layers.  A card sums in another order than the CPU, so the
BASIC path's logits on the card can only be held against a CPU run at a
tolerance of that size.

This script serves OPT, GPT-2, Llama, Qwen3, Gemma or Mistral in BASIC mode (``build_basic_mode``, a
float16 split cache) twice from the same seeded weights and prompt: as is,
and with every T1 matmul and every LayerNorm, RMSNorm, softmax and
attention reduction summed in float64 and rounded once.  It prints the
largest difference of the prefill logits between the two, and how many of
the greedy tokens agree (a token that differs where the top two logits
nearly tie changes every later step):

    python -m dmx_compressor_tpu_torch.tools.order_sensitivity --device cpu \\
        --layers 12 --vocab 2048 --seeds 0 1
    python -m dmx_compressor_tpu_torch.tools.order_sensitivity --family llama \\
        --device cpu --layers 4 --vocab 2048 --seeds 0 1

``--mode weights`` and ``--mode sbfp`` serve bench.py's int8-cache legs
(``build_weights_mode``, ``build_sbfp_mode``: packed BFP16_64 or SBFP12_16
weights, activations in f32), as is and with every packed linear summed in
float64 and rounded once: where a K or V value lands by one int8 step apart,
the step propagates in the same way.

``--mode fp8`` serves the model in FP8 mode (``DmxModel.to_fp8_mode``: AFLOAT8
Linear and ActActMatMul inputs and weights, FLOAT16 boundaries, an f32
cache) instead, as is and with the whole model in float64 (every sum in
float64, each value rounded to f32 before each cast), and compares the two
in the same way:

    python -m dmx_compressor_tpu_torch.tools.order_sensitivity --mode fp8 \\
        --device cpu --layers 12 --vocab 2048 --seeds 0 1

``--family t5`` and ``--family whisper`` serve the encoder-decoder families
(t5-small, whisper-small) in BASIC mode over an f32 cache, as chip_smoke.py's
t5_basic and whisper_basic paths do (``--mode weights`` / ``sbfp``: their
int8-cache legs, the float64 run summing the packed linears in float64):
encode seeded inputs (T5: ``--prompt`` token ids; Whisper: standard-normal
features [80, 3000]), prefill the start
tokens (T5 one, Whisper four) and decode; the float64 run is fed the first
run's tokens (teacher-forced, as chip_smoke.py holds the card against the
CPU), and the largest difference over the prefill's and every step's
logits is printed:

    python -m dmx_compressor_tpu_torch.tools.order_sensitivity --family whisper \
        --device cpu --layers 4 --vocab 2048 --batch 2 --seeds 0 1

``--family clip`` serves CLIP ViT-B/32 in BASIC mode as chip_smoke.py's
clip_basic path does: ``zero_shot_classify`` and ``__call__`` over seeded
standard-normal images [batch, 3, 224, 224] and ``batch`` prompts of 77
token ids, as is and with every sum above in float64 (the modular
attention's matmuls too); it prints the largest difference of the image and
text embeddings, the logits and the probabilities (``--layers`` cuts both
towers, ``--vocab`` the text vocabulary):

    python -m dmx_compressor_tpu_torch.tools.order_sensitivity --family clip \
        --layers 12 --batch 8 --seeds 0 1

``--family lenet`` serves LeNet-5 in BASIC mode over ``--batch`` seeded
standard-normal [1, 28, 28] images, as chip_smoke.py's lenet_basic path
does, as is and with the whole model in float64 (its convs summed in
float64, each value rounded to f32 before each cast, as ``--mode fp8``), and
prints the largest difference of the logits:

    python -m dmx_compressor_tpu_torch.tools.order_sensitivity --family lenet \
        --device cpu --batch 256 --seeds 0 1

Widths are OPT-125m's, or bench.py's ``gpt2`` (GPT-2 124M),
``llama-1.1b`` (TinyLlama-1.1B), ``qwen3-0.6b`` (Qwen3-0.6B), ``gemma-2b``
(Gemma-2B) or ``mistral-1b`` with ``--family gpt2``, ``llama``, ``qwen3``,
``gemma`` or ``mistral``; ``--layers`` and ``--vocab`` cut depth and the
vocabulary.
Without ``--device`` it runs on the card (the first run then goes through
the kernels).
"""

from __future__ import annotations

import argparse
import contextlib
from unittest import mock

import torch

from ..functional import simd_ops
from ..kernels import resolve_device
from ..models.clip import CLIPConfig, CLIPModel
from ..models.gemma import GemmaConfig, GemmaForCausalLM
from ..models.gpt2 import GPT2Config, GPT2LMHeadModel
from ..models.lenet import LeNet5
from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..models.mistral import MistralConfig, MistralForCausalLM
from ..models.opt import OPTConfig, OPTForCausalLM
from ..models.qwen3 import Qwen3Config, Qwen3ForCausalLM
from ..modeling.model import DmxModel
from ..models.shared import greedy_decode, greedy_prefill, greedy_token
from ..models.t5 import T5Config, T5ForConditionalGeneration
from ..models.whisper import WhisperConfig, WhisperForConditionalGeneration
from ..nn import modules as dmx_modules
from ..ops import basic_attention, basic_layer, basic_linear, compress
from ..ops.bfp_cast import fp16_cast_ref
from ..ops.bfp_pack import bfp_unpack, sbfp_unpack
from ..ops.compress import build_basic_mode, build_sbfp_mode, build_weights_mode
from ..ops.split_decode import prepare_split_decode


def _matmul_f64(x, w, bias=None, out_fp16=False, residual=None):
    """T1's function with the products summed in float64, rounded once."""
    y = torch.matmul(x.to(torch.bfloat16).double(), bfp_unpack(w).double().T).float()
    if bias is not None:
        y = y + bias.float()
    if out_fp16:
        y = fp16_cast_ref(y)
    if residual is not None:
        y = fp16_cast_ref(y + residual.float())
    return y


def _linear_f64(unpack):
    """A packed linear's function (B1's or B5's) with its products summed in
    float64, rounded once."""

    def linear(x, w, bias=None):
        y = torch.matmul(x.double(), unpack(w).double().T)
        if bias is not None:
            y = y + bias.double()
        return y.to(x.dtype)

    return linear


@contextlib.contextmanager
def float64_linears():
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(compress, "bfp_linear", _linear_f64(bfp_unpack)))
        stack.enter_context(mock.patch.object(compress, "sbfp_linear",
                                              _linear_f64(sbfp_unpack)))
        yield


class _Float64Sums:
    """``torch`` as the BASIC modules see it, with mean and sum in float64."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def mean(x, dim=None, keepdim=False):
        return torch.mean(x.double(), dim=dim, keepdim=keepdim).float()

    @staticmethod
    def sum(x, dim=None, keepdim=False):
        return torch.sum(x.double(), dim=dim, keepdim=keepdim).float()


class _Float64Matmuls(_Float64Sums):
    """... and matmul in float64 (the Dmx modules' activation matmuls)."""

    @staticmethod
    def matmul(a, b):
        return torch.matmul(a.double(), b.double()).to(torch.promote_types(a.dtype, b.dtype))


@contextlib.contextmanager
def float64_sums(matmuls: bool = False):
    """T1 and the BASIC modules' means and sums in float64; with
    ``matmuls`` the Dmx op modules' own matmuls too."""
    with contextlib.ExitStack() as stack:
        for mod in (compress, basic_linear):
            stack.enter_context(mock.patch.object(mod, "bfp_linear_bf16", _matmul_f64))
        for mod in (basic_layer, basic_attention, simd_ops):
            stack.enter_context(mock.patch.object(mod, "torch", _Float64Sums()))
        if matmuls:
            stack.enter_context(mock.patch.object(dmx_modules, "torch", _Float64Matmuls()))
        yield


FAMILIES = {
    "opt": (OPTConfig, OPTForCausalLM),
    "llama": (LlamaConfig.llama_1_1b, LlamaForCausalLM),
    "qwen3": (Qwen3Config.qwen3_0_6b, Qwen3ForCausalLM),
    "gemma": (GemmaConfig.gemma_2b, GemmaForCausalLM),
    "gpt2": (GPT2Config.gpt2, GPT2LMHeadModel),
    "mistral": (MistralConfig.mistral_1b, MistralForCausalLM),
    "t5": (T5Config.t5_small, T5ForConditionalGeneration),
    "whisper": (WhisperConfig.small, WhisperForConditionalGeneration),
    "clip": (CLIPConfig.vit_b_32, CLIPModel),
}
SEQ2SEQ = ("t5", "whisper")


def serve_seq2seq(family, cfg, seed, device, batch, prompt, steps, forced=None, mode="basic"):
    """An encoder-decoder family in BASIC mode over an f32 cache (or
    bench.py's weights or sbfp leg over an int8 cache) from ``seed``: every
    step's last-position logits [steps + 1, B, V] (the prefill's first) and
    the greedy tokens; with ``forced`` (tokens [B, steps + 1]) each step
    takes the forced token instead of its own."""
    model = FAMILIES[family][1](cfg, device=device, seed=seed)
    {"basic": build_basic_mode, "weights": build_weights_mode, "sbfp": build_sbfp_mode}[mode](
        model)
    g = torch.Generator().manual_seed(seed + 1)
    if family == "t5":
        x = torch.randint(1, cfg.vocab_size, (batch, prompt), generator=g)
        start = torch.zeros((batch, 1), dtype=torch.int64)
    else:
        x = torch.randn(batch, cfg.num_mel_bins, 2 * cfg.max_source_positions, generator=g)
        start = torch.randint(0, cfg.vocab_size, (batch, 4), generator=g)
    T0 = start.shape[1]
    caches = model.init_cache(batch, T0 + steps + 1, quantized=mode != "basic", device=device)
    with torch.no_grad():
        enc = model.encode(x.to(device))
        logits = model.decode(start.to(device), enc, caches=caches)
        rows, toks = [logits[:, -1]], [greedy_token(logits[:, -1])]
        for i in range(steps):
            tok = toks[-1] if forced is None else forced[:, i].to(device)
            logits = model.decode(tok[:, None], enc, caches=caches, position_offset=T0 + i)
            rows.append(logits[:, -1])
            toks.append(greedy_token(logits[:, -1]))
    return torch.stack(rows).float().cpu(), torch.stack(toks, dim=1).cpu()


def serve_clip(cfg, seed, device, batch):
    """CLIP in BASIC mode from ``seed``: (image embeddings, text embeddings,
    logits per image, probabilities), the embeddings those of the
    ``__call__``, all f32 on the CPU."""
    device = resolve_device(device)
    model = CLIPModel(cfg, device=device, seed=seed)
    build_basic_mode(model)
    g = torch.Generator().manual_seed(seed + 1)
    v = cfg.vision
    px = torch.randn(batch, v.num_channels, v.image_size, v.image_size, generator=g).to(device)
    ids = torch.randint(0, cfg.text.vocab_size, (batch, cfg.text.max_position_embeddings),
                        generator=g).to(device)
    feats = {}
    hooks = [proj.register_forward_hook(lambda m, i, o, k=k: feats.__setitem__(k, o))
             for k, proj in (("image", model.visual_projection),
                             ("text", model.text_projection))]
    with torch.no_grad():
        probs = model.zero_shot_classify(px, ids)
        logits = model(ids, px)[0]
    for h in hooks:
        h.remove()
    return [t.float().cpu() for t in (feats["image"], feats["text"], logits, probs)]


def serve_lenet(seed, device, batch, dtype=torch.float32):
    """LeNet-5 in BASIC mode from ``seed`` with its parameters and inputs in
    ``dtype``: the logits, f32 on the CPU."""
    device = resolve_device(device)
    model = LeNet5(device=device, seed=seed)
    build_basic_mode(model)
    model.to(dtype)
    x = torch.randn(batch, 1, 28, 28, generator=torch.Generator().manual_seed(seed + 1))
    conv = dmx_modules._ConvNd._conv

    def conv_in(self, x_, w):  # the Dmx conv computes in f32: here in dtype
        return conv(self, x_.to(dtype), w.to(dtype)).to(torch.float32)

    with torch.no_grad(), mock.patch.object(dmx_modules._ConvNd, "_conv", conv_in):
        return model(x.to(device=device, dtype=dtype)).float().cpu()


def serve(family, cfg, seed, device, batch, prompt, steps):
    """BASIC mode from ``seed``: the prefill logits and the greedy tokens
    (the prefill's, then ``steps`` decode steps')."""
    model = FAMILIES[family][1](cfg, device=device, seed=seed)
    build_basic_mode(model)
    caches = model.init_cache(batch, prompt + 64, dtype=torch.float16, split_base_len=prompt,
                              device=device)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt),
                        generator=torch.Generator().manual_seed(seed + 1)).to(device)
    logits, tok = greedy_prefill(model, caches, ids)
    prepare_split_decode(model, caches)
    toks, _ = greedy_decode(model, caches, tok, prompt, steps)
    return logits.float().cpu(), torch.cat([tok[:, None], toks], dim=1).cpu()


def serve_fp8(family, cfg, seed, device, batch, prompt, steps, dtype=torch.float32):
    """FP8 mode from ``seed`` with the model's parameters and cache in
    ``dtype``: the prefill logits and the greedy tokens."""
    model = FAMILIES[family][1](cfg, device=device, seed=seed)
    DmxModel.from_raw(model).to_fp8_mode()
    model.to(dtype)
    caches = model.init_cache(batch, prompt + steps, dtype=dtype, device=device)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt),
                        generator=torch.Generator().manual_seed(seed + 1)).to(device)
    with torch.no_grad():
        logits, tok = greedy_prefill(model, caches, ids)
        toks, _ = greedy_decode(model, caches, tok, prompt, steps)
    return logits.float().cpu(), torch.cat([tok[:, None], toks], dim=1).cpu()


def serve_int8(family, cfg, seed, device, batch, prompt, steps, mode):
    """bench.py's ``mode`` leg (weights or sbfp, int8 cache) from ``seed``:
    the prefill logits and the greedy tokens."""
    model = FAMILIES[family][1](cfg, device=device, seed=seed)
    (build_weights_mode if mode == "weights" else build_sbfp_mode)(model)
    caches = model.init_cache(batch, prompt + steps, quantized=True, device=device)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt),
                        generator=torch.Generator().manual_seed(seed + 1)).to(device)
    with torch.no_grad():
        logits, tok = greedy_prefill(model, caches, ids)
        toks, _ = greedy_decode(model, caches, tok, prompt, steps)
    return logits.float().cpu(), torch.cat([tok[:, None], toks], dim=1).cpu()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted([*FAMILIES, "lenet"]), default="opt")
    ap.add_argument("--mode", choices=("basic", "weights", "sbfp", "fp8"), default="basic")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=None, help="default: the family's")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    a = ap.parse_args(argv)
    if a.family == "lenet":
        for seed in a.seeds:
            d = (serve_lenet(seed, a.device, a.batch)
                 - serve_lenet(seed, a.device, a.batch, torch.float64)).abs()
            print(f"basic lenet seed {seed}, batch {a.batch}, on {a.device or 'cuda'}: logits "
                  f"max |diff| {d.max().item():.4g} (share of logits that differ "
                  f"{(d > 0).float().mean().item():.4f})")
        return
    cfg = FAMILIES[a.family][0]()
    if a.family == "clip":
        cfg.vision.num_hidden_layers = cfg.text.num_hidden_layers = a.layers
        cfg.text.vocab_size = a.vocab or cfg.text.vocab_size
    elif a.family == "t5":
        cfg.num_layers = cfg.num_decoder_layers = a.layers
    elif a.family == "whisper":
        cfg.encoder_layers = cfg.decoder_layers = a.layers
    else:
        setattr(cfg, "n_layer" if a.family == "gpt2" else "num_hidden_layers", a.layers)
    if a.family != "clip":
        cfg.vocab_size = a.vocab or cfg.vocab_size
    for seed in a.seeds:
        if a.family == "clip":
            if a.mode != "basic":
                raise SystemExit("--family clip takes --mode basic")
            base = serve_clip(cfg, seed, a.device, a.batch)
            with float64_sums(matmuls=True):
                other = serve_clip(cfg, seed, a.device, a.batch)
            diffs = [(x - y).abs().max().item() for x, y in zip(base, other)]
            print(f"basic clip seed {seed}, {a.layers} + {a.layers} layers, vocab "
                  f"{cfg.text.vocab_size}, batch {a.batch}, on {a.device or 'cuda'}: max |diff| "
                  f"image embeddings {diffs[0]:.4g}, text embeddings {diffs[1]:.4g}, logits "
                  f"{diffs[2]:.4g}, probabilities {diffs[3]:.4g} (largest |logit| "
                  f"{base[2].abs().max().item():.4g}); argmax classes equal "
                  f"{(base[3].argmax(-1) == other[3].argmax(-1)).sum().item()} of {a.batch}")
            continue
        run = (a.family, cfg, seed, a.device, a.batch, a.prompt, a.steps)
        if a.family in SEQ2SEQ:
            if a.mode == "fp8":
                raise SystemExit(f"--family {a.family} takes --mode basic, weights or sbfp")
            base = serve_seq2seq(*run, mode=a.mode)
            with float64_sums() if a.mode == "basic" else float64_linears():
                other = serve_seq2seq(*run, forced=base[1], mode=a.mode)
            d = (base[0] - other[0]).abs()
            print(f"{a.mode} {a.family} seed {seed}, {a.layers} layers, vocab {cfg.vocab_size}, "
                  f"batch {a.batch}, on {a.device or 'cuda'}: the prefill's and {a.steps} "
                  f"teacher-forced steps' logits max |diff| {d.max().item():.4g} (prefill "
                  f"{d[0].max().item():.4g}; share of logits that differ "
                  f"{(d > 0).float().mean().item():.4f}, largest |logit| "
                  f"{base[0].abs().max().item():.4g})")
            continue
        if a.mode == "fp8":
            base, other = serve_fp8(*run), serve_fp8(*run, dtype=torch.float64)
        elif a.mode in ("weights", "sbfp"):
            base = serve_int8(*run, a.mode)
            with float64_linears():
                other = serve_int8(*run, a.mode)
        else:
            base = serve(*run)
            with float64_sums():
                other = serve(*run)
        d = (base[0] - other[0]).abs()
        print(f"{a.mode} {a.family} seed {seed}, {a.layers} layers, vocab {cfg.vocab_size}, batch "
              f"{a.batch} x prompt "
              f"{a.prompt}, on {a.device or 'cuda'}: prefill logits max |diff| {d.max().item():.4g}"
              f" (share of logits that differ {(d > 0).float().mean().item():.4f}, largest "
              f"|logit| {base[0].abs().max().item():.4g}); greedy tokens equal "
              f"{(base[1] == other[1]).sum().item()} of {base[1].numel()}")


if __name__ == "__main__":
    main()
