"""Llama-family decoder (Llama-2/3, TinyLlama shapes) with GQA and RoPE.

Port of ``dmx_compressor_tpu/models/llama.py``.  Authored with torch
modules and ``rawnn`` op wrappers (RMSNorm, SiLU, Mul, RotaryEmbedding,
ApplyRotaryPosEmb, ScaledDotProductAttention) so the Dmx substitution pass
intercepts every op; module paths follow the HF checkpoint layout
(``model.layers.N.self_attn.q_proj``).

Attention routing, the JAX package's (the shared helpers of
ops/flash_attention.py and ops/flash_decode.py; OPT has its own):

- a prefill from position 0 goes through ``flash_prefill`` when the compound
  SDPA is transparent: the cache is written and B3 attends over the fresh
  K/V, the KV heads repeated to the query heads first.  An int8 cache is
  refused there (its contract attends over the dequantized K/V), so an int8
  prefill runs ``quantized_sdpa`` in ``cached_attend`` and launches no B3;
- a chunk at a later offset goes through ``flash_chunked_prefill`` (a float
  row or static cache);
- everything else goes through ``cached_attend``: a transparent
  plain-causal T == 1 step runs B2 (int8 cache) or B4 (f32 cache), query
  head h reading KV head h // rep; a split cache (the BASIC mode's) runs the
  fused BASIC split decode; else the modular compound SDPA.

In BASIC mode a decode step of a layer runs the fused step
(``ops/basic_layer.fused_llama_family_step``) and the LM head folds the
final RMSNorm in (``fused_rms_head``): casts through kernel T2, matmuls
through kernel T1.  Otherwise every packed linear runs ``bfp_linear`` (B1,
or T1 on bf16-exact activations) or ``sbfp_linear`` (B5).  Under SBFP the
q/k/v and gate/up projections stay unmerged (``merge_parallel_linears``
merges only packed BFP linears).

The classes are the Llama-topology base of models/qwen3.py,
models/gemma.py and models/mistral.py: a config's ``head_dim`` (where it
has one) decouples the heads' width from ``hidden_size /
num_attention_heads``, its ``sliding_window`` (where it has one) bands the
mask and keeps the flash kernels away, and each family names its layer
plan, norm, MLP and the hooks its deltas need (``_qk_norm``,
``_embed_scale``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .. import rawnn
from ..kernels import resolve_device
from ..ops.basic_layer import (
    basic_llama_layer_plan,
    basic_rms_head_plan,
    fused_llama_family_step,
    fused_rms_head,
)
from ..ops.compress import merge_parallel_linears
from ..ops.flash_attention import flash_chunked_prefill, flash_prefill
from ..ops.flash_decode import cached_attend
from ..ops.kv_cache import cache_seq_len, make_caches
from ..utils.tracing import span
from .positions import causal_mask, resolve_positions
from .shared import FrozenRouting, load_jax_params, take_rows

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM", "load_jax_params"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
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
            num_key_value_heads=j.get("num_key_value_heads", j["num_attention_heads"]),
            max_position_embeddings=j.get("max_position_embeddings", 4096),
            rms_norm_eps=j.get("rms_norm_eps", 1e-5),
            rope_theta=j.get("rope_theta", 10000.0),
            tie_word_embeddings=j.get("tie_word_embeddings", False),
        )

    @classmethod
    def llama_1_1b(cls):
        """bench.py's ``llama-1.1b``: TinyLlama-1.1B's shape (22 layers of
        2048, MLP 5632, GQA 32 query heads over 4 KV heads, vocab 32000,
        an untied head)."""
        return cls(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                   num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
                   max_position_embeddings=2048)

    @classmethod
    def tiny(cls):  # test-sized
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


def head_dim_of(cfg) -> int:
    """The heads' width: the config's ``head_dim`` where it has one (Qwen3,
    Gemma), else hidden / heads."""
    return getattr(cfg, "head_dim", None) or cfg.hidden_size // cfg.num_attention_heads


class LlamaAttention(FrozenRouting, nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = head_dim_of(cfg)
        q_dim = self.num_heads * self.head_dim
        kv_dim = self.num_kv_heads * self.head_dim
        self.q_proj = nn.Linear(d, q_dim, bias=False, device=device)
        self.k_proj = nn.Linear(d, kv_dim, bias=False, device=device)
        self.v_proj = nn.Linear(d, kv_dim, bias=False, device=device)
        self.o_proj = nn.Linear(q_dim, d, bias=False, device=device)
        self.apply_rope = rawnn.ApplyRotaryPosEmb()
        self.sdpa = rawnn.ScaledDotProductAttention()
        self.qkv_merged = None

    def _split(self, x, heads):
        B, T, _ = x.shape
        return x.reshape(B, T, heads, self.head_dim).transpose(1, 2)

    def fuse_for_inference(self) -> None:
        """Merge q/k/v into one packed projection when possible (called by
        ops.compress.compress_for_inference; bit-exact, GQA widths
        included), then freeze the routing."""
        merged = merge_parallel_linears([self.q_proj, self.k_proj, self.v_proj])
        if merged is not None:
            self.qkv_merged = merged
        self.freeze_routing()

    def _project_qkv(self, x):
        if self.qkv_merged is not None:
            qkv = self.qkv_merged(x)
            d = self.num_heads * self.head_dim
            kv = self.num_kv_heads * self.head_dim
            return qkv[..., :d], qkv[..., d:d + kv], qkv[..., d + kv:]
        return self.q_proj(x), self.k_proj(x), self.v_proj(x)

    def _qk_norm(self, q, k):
        """q [B, T, H, D] and k [B, T, Hkv, D] before RoPE: as they are
        (Qwen3 normalizes them here)."""
        return q, k

    def forward(self, x, cos, sin, attn_mask=None, cache=None,
                prefill_offset: Optional[int] = None, plain_causal: bool = True):
        B, T, _ = x.shape
        D = self.num_heads * self.head_dim
        _q, _k, _v = self._project_qkv(x)
        q, k = self._qk_norm(_q.reshape(B, T, self.num_heads, self.head_dim),
                             _k.reshape(B, T, self.num_kv_heads, self.head_dim))
        q, k = q.transpose(1, 2), k.transpose(1, 2)
        v = self._split(_v, self.num_kv_heads)
        q, k = self.apply_rope(q, k, cos, sin)
        with span("dmx.attention"):
            out = self._attend(q, k, v, attn_mask, cache, prefill_offset, plain_causal)
            out = out.transpose(1, 2).reshape(B, T, D)
        return self.o_proj(out)

    def _attend(self, q, k, v, attn_mask, cache, prefill_offset, plain_causal):
        """Attention over the normed and roped heads, [B, H, T, D] out."""
        transparent = self.sdpa_is_transparent  # None until frozen: the ops ask
        if prefill_offset is not None:
            # a causal prefill from 0, or a chunk at prefill_offset over the
            # cache's prefix (the kernel's diagonal at S - L)
            if prefill_offset == 0:
                out = flash_prefill(self.sdpa, q, k, v, cache=cache, transparent=transparent)
            else:
                out = flash_chunked_prefill(self.sdpa, q, k, v, cache=cache,
                                            offset=prefill_offset, transparent=transparent)
            if out is not None:
                return out
        return cached_attend(self.sdpa, q, k, v, cache, attn_mask,
                             enable_gqa=self.num_kv_heads != self.num_heads,
                             plain_causal=plain_causal, transparent=transparent)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        d, m = cfg.hidden_size, cfg.intermediate_size
        self.intermediate_size = m
        self.gate_proj = nn.Linear(d, m, bias=False, device=device)
        self.up_proj = nn.Linear(d, m, bias=False, device=device)
        self.down_proj = nn.Linear(m, d, bias=False, device=device)
        self.act_fn = rawnn.SiLU()
        self.mul = rawnn.Mul()
        self.gateup_merged = None

    def fuse_for_inference(self) -> None:
        """Merge gate/up into one packed projection (one kernel and one
        shared input cast; bit-exact, see merge_parallel_linears)."""
        merged = merge_parallel_linears([self.gate_proj, self.up_proj])
        if merged is not None:
            self.gateup_merged = merged

    def forward(self, x):
        if self.gateup_merged is not None:
            gu = self.gateup_merged(x)
            m = self.intermediate_size
            return self.down_proj(self.mul(self.act_fn(gu[..., :m]), gu[..., m:]))
        return self.down_proj(self.mul(self.act_fn(self.gate_proj(x)), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    attention = LlamaAttention
    mlp_class = LlamaMLP
    norm = rawnn.RMSNorm
    layer_plan = staticmethod(basic_llama_layer_plan)  # the fused BASIC step's check

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = self.attention(cfg, device)
        self.mlp = self.mlp_class(cfg, device)
        self.input_layernorm = self.norm(d, eps=cfg.rms_norm_eps, device=device)
        self.post_attention_layernorm = self.norm(d, eps=cfg.rms_norm_eps, device=device)
        self.resadd1 = rawnn.ResAdd()
        self.resadd2 = rawnn.ResAdd()

    def forward(self, x, cos, sin, attn_mask=None, cache=None,
                prefill_offset: Optional[int] = None, plain_causal: bool = True):
        if (x.shape[1] == 1 and cache is not None and attn_mask is not None
                and attn_mask.is_floating_point()):
            plan = self.layer_plan(self)
            if plan is not None:
                return fused_llama_family_step(self, x, cos, sin, attn_mask, cache, plan,
                                               plain_causal=plain_causal)
        x = self.resadd1(
            self.self_attn(self.input_layernorm(x), cos, sin, attn_mask, cache,
                           prefill_offset=prefill_offset, plain_causal=plain_causal), x)
        return self.resadd2(self.mlp(self.post_attention_layernorm(x)), x)


class LlamaModel(nn.Module):
    decoder_layer = LlamaDecoderLayer

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(
            self.decoder_layer(cfg, device) for _ in range(cfg.num_hidden_layers))
        self.norm = self.decoder_layer.norm(cfg.hidden_size, eps=cfg.rms_norm_eps, device=device)
        self.rotary_emb = rawnn.RotaryEmbedding(
            head_dim_of(cfg), cfg.max_position_embeddings, base=cfg.rope_theta, device=device)

    def _embed_scale(self, x):
        """The embedding's output as it enters the first layer (Gemma
        scales it)."""
        return x

    def _mask(self, T, S, position_offset, dtype, device):
        """The additive mask, banded where the config has a sliding window
        (Mistral's, a Qwen3's)."""
        return causal_mask(T, S, position_offset, dtype, device,
                           sliding_window=getattr(self.cfg, "sliding_window", None))

    def _plain_causal(self) -> bool:
        """Whether the mask is the plain causal one, so the flash kernels
        may serve it (False under a sliding window)."""
        return getattr(self.cfg, "sliding_window", None) is None

    def forward(self, input_ids, caches=None, position_offset=0,
                apply_final_norm: bool = True):
        B, T = input_ids.shape
        device = input_ids.device
        x = self._embed_scale(take_rows(self.embed_tokens, input_ids))
        pos, _ = resolve_positions(T, position_offset, device)
        cos, sin = self.rotary_emb(x, pos)
        if caches is not None:
            mask = self._mask(T, cache_seq_len(caches[0]), position_offset, x.dtype, device)
        else:
            mask = self._mask(T, T, 0, x.dtype, device)
        plain = self._plain_causal()
        # a prefill (T > 1 at one offset for the batch) from 0, or a chunk
        # at a later offset over a cache; a banded mask takes neither
        prefill_offset = (
            position_offset
            if (plain and T > 1 and isinstance(position_offset, int)
                and (position_offset == 0 or caches is not None))
            else None
        )
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, attn_mask=mask, cache=None if caches is None else caches[i],
                      prefill_offset=prefill_offset, plain_causal=plain)
        return self.norm(x) if apply_final_norm else x


class LlamaForCausalLM(nn.Module):
    """Llama with an untied LM head (tied when the config says so); returns
    logits.

    Built on the card unless ``device='cpu'``.  Weights are random, drawn
    from ``seed`` (HF's Llama init: normal(0, 0.02) for the linears and the
    embedding, unit RMSNorm scales); :func:`load_jax_params` replaces
    them."""

    base_model = LlamaModel
    gemma_norm = False  # the final norm's (1 + w) form, for the fused head

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.model = self.base_model(cfg, device)
        if getattr(cfg, "tie_word_embeddings", True):
            self.lm_head = rawnn.TiedLinear(self.model.embed_tokens)
        else:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, 0.02, generator=gen)

    @property
    def config(self):
        return self.cfg

    def forward(self, input_ids, caches=None, position_offset=0):
        """Logits [B, T, vocab]; recorded as the span ``dmx.forward``."""
        with span("dmx.forward"):
            return self._logits(input_ids, caches, position_offset)

    def _logits(self, input_ids, caches, position_offset):
        if input_ids.shape[1] == 1 and caches is not None:
            plan = basic_rms_head_plan(self.model.norm, self.lm_head,
                                       gemma_norm=self.gemma_norm)
            if plan is not None:
                # BASIC decode: the final RMSNorm folds into the head
                h = self.model(input_ids, caches=caches, position_offset=position_offset,
                               apply_final_norm=False)
                return fused_rms_head(h, self.model.norm, self.lm_head, plan,
                                      gemma_norm=self.gemma_norm)
        h = self.model(input_ids, caches=caches, position_offset=position_offset)
        return self.lm_head(h)

    def init_cache(self, batch: int, max_len: int, dtype=None, quantized: bool = False,
                   per_row: bool = False, split_base_len: Optional[int] = None, device=None):
        """One cache of the KV heads per layer, on the card unless
        ``device='cpu'``; ``per_row`` and ``split_base_len`` as
        ``ops.kv_cache.make_caches``.  The KV-head count is the attention's
        own: the local one on a tensor-parallel rank."""
        cfg = self.cfg
        attn = self.model.layers[0].self_attn
        return make_caches(
            cfg.num_hidden_layers, batch, attn.num_kv_heads, max_len,
            attn.head_dim, dtype or cfg.dtype,
            quantized=quantized, split_base_len=split_base_len, device=device, per_row=per_row,
        )
