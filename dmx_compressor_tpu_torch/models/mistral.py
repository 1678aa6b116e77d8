"""Mistral-family decoder: the Llama topology with sliding-window attention.

Port of ``dmx_compressor_tpu/models/mistral.py``.  The module classes are
Llama's (models/llama.py): GQA projections, the rawnn RoPE wrappers,
RMSNorm, the SiLU-gated MLP, RoPE over ``hidden_size //
num_attention_heads``.  Mistral adds the banded causal mask: a token
attends to at most ``sliding_window`` previous positions (config.json
"sliding_window"; None disables the band).  A banded model takes neither
flash prefill nor flash decode (``plain_causal`` is False): its attention
runs the masked sdpa, ``quantized_sdpa`` over an int8 cache, and in BASIC
mode the fused split decode with the banded additive mask, as the JAX
package routes it.  The BASIC fused step and the fused RMS head are
Llama's; ``load_jax_params`` copies a raw JAX Mistral's weights in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .llama import LlamaDecoderLayer, LlamaForCausalLM, LlamaModel
from .shared import load_jax_params

__all__ = ["MistralConfig", "MistralDecoderLayer", "MistralModel", "MistralForCausalLM",
           "load_jax_params"]

MistralDecoderLayer = LlamaDecoderLayer  # the same block
# Llama's model: it bands the mask by the config's sliding_window, and a
# banded model sends no prefill to the flash kernels
MistralModel = LlamaModel


@dataclasses.dataclass
class MistralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 32768
    sliding_window: Optional[int] = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
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
            max_position_embeddings=j.get("max_position_embeddings", 32768),
            sliding_window=j.get("sliding_window", 4096),
            rms_norm_eps=j.get("rms_norm_eps", 1e-5),
            rope_theta=j.get("rope_theta", 10000.0),
            tie_word_embeddings=j.get("tie_word_embeddings", False),
        )

    @classmethod
    def mistral_1b(cls):
        """bench.py's ``mistral-1b``: Mistral-7B's 4:1 GQA and SiLU MLP at
        TinyLlama's widths (16 layers of 2048, 32 query heads over 8 KV
        heads of 64, MLP 5632, vocab 32000, untied), with a sliding window
        of 128, active within the bench's 192 tokens."""
        return cls(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                   num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
                   max_position_embeddings=4096, sliding_window=128)

    @classmethod
    def tiny(cls):  # test-sized
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                   sliding_window=16)


class MistralForCausalLM(LlamaForCausalLM):
    """Mistral with an untied head (tied where the config says so); returns
    logits.  Built on the card unless ``device='cpu'``; random weights from
    ``seed`` (normal(0, 0.02) linears and embedding, unit norms);
    :func:`load_jax_params` replaces them.  Its model is Llama's
    (``MistralModel``)."""
