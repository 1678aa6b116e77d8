"""Gemma-family decoder: the Llama topology with Gemma's deltas.

Port of ``dmx_compressor_tpu/models/gemma.py``.  Gemma differs from Llama
by:

- ``GemmaRMSNorm``: the (1 + weight) RMSNorm, its weight starting at zero;
- hidden states scaled by ``sqrt(hidden_size)`` after the embedding, in
  x's dtype;
- an explicit ``head_dim`` decoupled from ``hidden_size / num_heads``
  (Gemma-2B: 2048 hidden, 8 heads of 256 over one KV head, MQA);
- a GeGLU MLP with the tanh-approximated GELU (``gelu_pytorch_tanh``);
- input and output embeddings always tied.

Attention routing is the Llama family's (models/llama.py); the BASIC fused
step takes ``basic_gemma_layer_plan`` (the (1 + w) norms and the tanh-GELU
between its FLOAT16 casts) and the fused RMS head its ``gemma_norm`` form.
``load_jax_params`` copies a raw JAX Gemma's weights in.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import rawnn
from ..ops.basic_layer import basic_gemma_layer_plan
from .llama import LlamaAttention, LlamaDecoderLayer, LlamaForCausalLM, LlamaMLP, LlamaModel
from .shared import load_jax_params

__all__ = ["GemmaConfig", "GemmaAttention", "GemmaMLP", "GemmaDecoderLayer", "GemmaModel", "GemmaForCausalLM",
           "load_jax_params"]


@dataclasses.dataclass
class GemmaConfig:
    vocab_size: int = 256000
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: int = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_hf(cls, j):
        return cls(
            vocab_size=j["vocab_size"],
            hidden_size=j["hidden_size"],
            intermediate_size=j["intermediate_size"],
            num_hidden_layers=j["num_hidden_layers"],
            num_attention_heads=j["num_attention_heads"],
            num_key_value_heads=j.get("num_key_value_heads", 1),
            head_dim=j.get("head_dim", j["hidden_size"] // j["num_attention_heads"]),
            max_position_embeddings=j.get("max_position_embeddings", 8192),
            rms_norm_eps=j.get("rms_norm_eps", 1e-6),
            rope_theta=j.get("rope_theta", 10000.0),
        )

    @classmethod
    def gemma_2b(cls):
        """bench.py's ``gemma-2b``: google/gemma-2b's config (18 layers of
        2048, 8 query heads over 1 KV head of 256, GeGLU MLP 16384, vocab
        256000, tied)."""
        return cls(vocab_size=256000, hidden_size=2048, intermediate_size=16384,
                   num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1,
                   head_dim=256, max_position_embeddings=8192, rms_norm_eps=1e-6,
                   rope_theta=10000.0)

    @classmethod
    def tiny(cls):  # test-sized; head_dim 32, decoupled from hidden / heads (16)
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=1, head_dim=32,
                   max_position_embeddings=64)


class GemmaAttention(LlamaAttention):
    """Llama's attention at Gemma's widths: one KV head under all query
    heads (MQA) and the decoupled head_dim."""


class GemmaMLP(LlamaMLP):
    """The GeGLU MLP: merged gate / up, tanh-GELU on the gate, Mul."""

    def __init__(self, cfg: GemmaConfig, device):
        super().__init__(cfg, device)
        self.act_fn = rawnn.GELU(approximate="tanh")  # gelu_pytorch_tanh


class GemmaDecoderLayer(LlamaDecoderLayer):
    attention = GemmaAttention
    mlp_class = GemmaMLP
    norm = rawnn.GemmaRMSNorm
    layer_plan = staticmethod(basic_gemma_layer_plan)


class GemmaModel(LlamaModel):
    decoder_layer = GemmaDecoderLayer

    def _embed_scale(self, x):
        # HF GemmaModel scales the hidden states by sqrt(hidden) in x's dtype
        return x * float(torch.tensor(self.cfg.hidden_size**0.5, dtype=x.dtype))


class GemmaForCausalLM(LlamaForCausalLM):
    """Gemma with its head always tied to the embedding; returns logits.
    Built on the card unless ``device='cpu'``; random weights from ``seed``
    (normal(0, 0.02) linears and embedding, zero (1 + w) norm weights);
    :func:`load_jax_params` replaces them."""

    base_model = GemmaModel
    gemma_norm = True
