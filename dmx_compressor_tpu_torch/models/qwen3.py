"""Qwen3-family decoder: the Llama topology with per-head q / k RMSNorm.

Port of ``dmx_compressor_tpu/models/qwen3.py``.  Qwen3 differs from Llama
by:

- ``q_norm`` / ``k_norm``: RMSNorm over ``head_dim`` of the reshaped
  per-head q / k, before RoPE (HF ``modeling_qwen3.Qwen3Attention``);
- an explicit ``head_dim`` decoupled from ``hidden_size / num_heads``
  (Qwen3-0.6B: 1024 hidden, 16 heads of 128);
- an optional sliding window, applied to every layer as a banded mask (as
  the JAX package builds it); a banded model takes neither flash prefill
  nor flash decode (``plain_causal`` is False).

Attention routing, the BASIC fused step (``basic_qwen3_layer_plan``: the q /
k norms' surrogates between RoPE's casts) and the fused RMS head are the
Llama family's (models/llama.py).  ``load_jax_params`` copies a raw JAX
Qwen3's weights in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import rawnn
from ..ops.basic_layer import basic_qwen3_layer_plan
from .llama import LlamaAttention, LlamaDecoderLayer, LlamaForCausalLM, LlamaMLP, LlamaModel
from .shared import load_jax_params

__all__ = ["Qwen3Config", "Qwen3Attention", "Qwen3DecoderLayer", "Qwen3Model",
           "Qwen3ForCausalLM", "load_jax_params"]


@dataclasses.dataclass
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 4096
    intermediate_size: int = 12288
    num_hidden_layers: int = 36
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 40960
    sliding_window: Optional[int] = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_hf(cls, j):
        return cls(
            vocab_size=j["vocab_size"],
            hidden_size=j["hidden_size"],
            intermediate_size=j["intermediate_size"],
            num_hidden_layers=j["num_hidden_layers"],
            num_attention_heads=j["num_attention_heads"],
            num_key_value_heads=j.get("num_key_value_heads", 8),
            head_dim=j.get("head_dim", j["hidden_size"] // j["num_attention_heads"]),
            max_position_embeddings=j.get("max_position_embeddings", 40960),
            sliding_window=j.get("sliding_window") if j.get("use_sliding_window") else None,
            rms_norm_eps=j.get("rms_norm_eps", 1e-6),
            rope_theta=j.get("rope_theta", 1000000.0),
            tie_word_embeddings=j.get("tie_word_embeddings", False),
        )

    @classmethod
    def qwen3_0_6b(cls):
        """bench.py's ``qwen3-0.6b``: Qwen/Qwen3-0.6B's config (28 layers of
        1024, 16 query heads over 8 KV heads of 128, MLP 3072, vocab 151936,
        a tied head, rope_theta 1e6)."""
        return cls(vocab_size=151936, hidden_size=1024, intermediate_size=3072,
                   num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
                   head_dim=128, max_position_embeddings=40960, rms_norm_eps=1e-6,
                   rope_theta=1000000.0, tie_word_embeddings=True)

    @classmethod
    def tiny(cls):  # test-sized; head_dim 32, decoupled from hidden / heads (16)
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                   max_position_embeddings=64, tie_word_embeddings=True)


class Qwen3Attention(LlamaAttention):
    def __init__(self, cfg: Qwen3Config, device):
        super().__init__(cfg, device)
        # over head_dim, before RoPE (HF: "only on the head dim!")
        self.q_norm = rawnn.RMSNorm(self.head_dim, eps=cfg.rms_norm_eps, device=device)
        self.k_norm = rawnn.RMSNorm(self.head_dim, eps=cfg.rms_norm_eps, device=device)

    def _qk_norm(self, q, k):
        return self.q_norm(q), self.k_norm(k)


class Qwen3DecoderLayer(LlamaDecoderLayer):
    attention = Qwen3Attention
    mlp_class = LlamaMLP  # the same SiLU-gated MLP
    layer_plan = staticmethod(basic_qwen3_layer_plan)


class Qwen3Model(LlamaModel):
    decoder_layer = Qwen3DecoderLayer  # LlamaModel bands the mask by the sliding window


class Qwen3ForCausalLM(LlamaForCausalLM):
    """Qwen3 with its head tied to the embedding where the config says so;
    returns logits.  Built on the card unless ``device='cpu'``; random
    weights from ``seed`` (normal(0, 0.02) linears and embedding, unit
    norms); :func:`load_jax_params` replaces them."""

    base_model = Qwen3Model
