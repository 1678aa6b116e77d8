"""T5 encoder-decoder (t5-small .. t5-11b shapes, plus the v1.1 gated GELU).

Port of ``dmx_compressor_tpu/models/t5.py``.  Authored with torch modules
and ``rawnn`` op wrappers (RMSNorm, ReLU, NewGELU, Mul, ResAdd, TiedLinear,
ScaledDotProductAttention) so the Dmx substitution pass intercepts every
op; module paths follow the JAX package's (``encoder.block.N.self_attn.q``),
and :meth:`T5ForConditionalGeneration.hf_tensor_converter` maps HF's names
onto them.  T5's specifics, as in the JAX package and HF's modeling_t5:

- pre-norm blocks with T5LayerNorm, an RMSNorm;
- *unscaled* attention: the SDPA is called with ``scale=1.0`` (the
  1/sqrt(d_kv) is folded into the initialisation), with an additive bias;
- an explicit ``d_kv`` decoupled from ``d_model / num_heads``;
- a bucketed relative-position bias, computed by the first self-attention
  of each stack and shared down it (bidirectional buckets in the encoder,
  causal ones in the decoder);
- ``DenseReluDense``, or v1.1's ``DenseGatedActDense``;
- one embedding table for the encoder, the decoder and the tied LM head,
  whose hidden states are rescaled by ``d_model**-0.5`` first.

T5's attention never reaches a flash kernel: it calls ``cache.update``
itself (an int8 cache hands back dequantized K/V) and runs the modular SDPA
over the whole cache, as in the JAX package.  Its packed linears run
``bfp_linear`` (B1, or T1 on bf16-exact activations) or ``sbfp_linear``
(B5); the cross-attention K/V are recomputed from the encoder output at
every decode step, the JAX package's semantics.

The bucket ids come from an f32 ``log`` truncated to an int, as in the JAX
package, so a ``log`` one ulp apart could move a relative position into the
next bucket at a boundary.  They are computed once per configuration on the
CPU (:func:`relative_position_bucket`, held bit for bit against the JAX
package) into a table by distance, which the card indexes: the card's
buckets are the CPU's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import rawnn
from ..kernels import resolve_device
from ..ops.kv_cache import cache_seq_len, make_caches
from .positions import causal_mask, is_per_row
from .shared import load_jax_seq2seq_params, seq2seq_generate, take_rows

__all__ = ["T5Config", "relative_position_bucket", "T5Attention", "T5DenseReluDense",
           "T5DenseGatedActDense", "T5Block", "T5Stack", "T5ForConditionalGeneration",
           "load_jax_params"]


@dataclasses.dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    is_gated_act: bool = False
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def hidden_size(self):
        return self.d_model

    @property
    def num_hidden_layers(self):
        return self.num_decoder_layers

    @classmethod
    def from_hf(cls, j):
        return cls(
            vocab_size=j["vocab_size"],
            d_model=j["d_model"],
            d_kv=j["d_kv"],
            d_ff=j["d_ff"],
            num_layers=j["num_layers"],
            num_decoder_layers=j.get("num_decoder_layers", j["num_layers"]),
            num_heads=j["num_heads"],
            relative_attention_num_buckets=j.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=j.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=j.get("layer_norm_epsilon", 1e-6),
            is_gated_act=str(j.get("feed_forward_proj", "relu")).startswith("gated"),
            tie_word_embeddings=j.get("tie_word_embeddings", True),
        )

    @classmethod
    def t5_small(cls):
        """t5-small: 6 + 6 layers of 512, 8 heads of 64, a ReLU feed-forward
        of 2048, vocab 32128, the head tied to the shared table."""
        return cls()

    @classmethod
    def tiny(cls):  # test-sized; d_kv decoupled from d_model / num_heads
        return cls(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                   num_decoder_layers=2, num_heads=4)


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF's ``T5Attention._relative_position_bucket`` in the JAX package's
    f32 arithmetic: ``relative_position`` = key position - query position
    (int32); returns int32 bucket ids."""
    rel = relative_position.to(torch.int32)
    buckets = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets = buckets + (rel > 0).to(torch.int32) * num_buckets
        rel = torch.abs(rel)
    else:
        rel = -torch.minimum(rel, torch.zeros_like(rel))
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    scaled = max_exact + (
        torch.log(rel.to(torch.float32) / max_exact + 1e-20)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    scaled = torch.clamp(scaled, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, scaled)


# (device, bidirectional, num_buckets, max_distance) -> the bucket of each
# distance 0..max_distance (past it every distance takes the last bucket)
_TABLES: Dict[tuple, torch.Tensor] = {}


def _distance_table(bidirectional: bool, num_buckets: int, max_distance: int,
                    device) -> torch.Tensor:
    key = (torch.device(device), bidirectional, num_buckets, max_distance)
    if key not in _TABLES:
        dist = torch.arange(max_distance + 1, dtype=torch.int32)
        # the distance branch of the formula (its query before its key, so
        # the bidirectional offset stays out), on the CPU
        table = relative_position_bucket(-dist, False, num_buckets // 2 if bidirectional
                                         else num_buckets, max_distance)
        _TABLES[key] = table.to(torch.int64).to(device)
    return _TABLES[key]


def position_buckets(relative_position: torch.Tensor, bidirectional: bool, num_buckets: int,
                     max_distance: int) -> torch.Tensor:
    """:func:`relative_position_bucket`'s ids from the CPU's table by
    distance, on ``relative_position``'s device (int64)."""
    rel = relative_position.to(torch.int64)
    table = _distance_table(bidirectional, num_buckets, max_distance, rel.device)
    if bidirectional:
        offset = (rel > 0).to(torch.int64) * (num_buckets // 2)
        dist = torch.abs(rel)
    else:
        offset = 0
        dist = -torch.clamp(rel, max=0)
    return offset + table[torch.clamp(dist, max=max_distance)]


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool = False,
                 bidirectional: bool = True, device=None):
        super().__init__()
        d = cfg.d_model
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.d_kv
        self.bidirectional = bidirectional
        self.num_buckets = cfg.relative_attention_num_buckets
        self.max_distance = cfg.relative_attention_max_distance
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(d, inner, bias=False, device=device)
        self.k = nn.Linear(d, inner, bias=False, device=device)
        self.v = nn.Linear(d, inner, bias=False, device=device)
        self.o = nn.Linear(inner, d, bias=False, device=device)
        self.relative_attention_bias = (nn.Embedding(self.num_buckets, cfg.num_heads,
                                                     device=device)
                                        if has_relative_attention_bias else None)
        self.sdpa = rawnn.ScaledDotProductAttention()

    def compute_bias(self, query_length: int, key_length: int, query_offset=0) -> torch.Tensor:
        """Additive position bias: [1, heads, Tq, Tk], or [B, heads, Tq, Tk]
        for a per-row ``query_offset`` tensor [B] (continuous batching; it
        stays on the device)."""
        device = self.relative_attention_bias.weight.device
        if is_per_row(query_offset):
            off = query_offset.to(torch.int64)
            q_pos = (torch.arange(query_length, device=off.device)[None, :]
                     + off[:, None])[..., None]
            k_pos = torch.arange(key_length, device=off.device)[None, None, :]
            buckets = position_buckets(k_pos - q_pos, self.bidirectional, self.num_buckets,
                                       self.max_distance)  # [B, Tq, Tk]
            return self.relative_attention_bias(buckets).permute(0, 3, 1, 2)
        q_pos = (torch.arange(query_length, device=device) + query_offset)[:, None]
        k_pos = torch.arange(key_length, device=device)[None, :]
        buckets = position_buckets(k_pos - q_pos, self.bidirectional, self.num_buckets,
                                   self.max_distance)  # [Tq, Tk]
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def _split(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, x, kv=None, position_bias=None, cache=None):
        B, T, _ = x.shape
        kv_in = x if kv is None else kv
        q = self._split(self.q(x))
        k = self._split(self.k(kv_in))
        v = self._split(self.v(kv_in))
        if cache is not None:
            k, v, _ = cache.update(k, v)  # an int8 cache dequantizes here
        # T5 attention is UNSCALED (the scale is folded into initialisation)
        out = self.sdpa(q, k, v, attn_mask=position_bias, scale=1.0)
        return self.o(out.transpose(1, 2).reshape(B, T, self.num_heads * self.head_dim))


class T5DenseReluDense(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, device=device)
        self.act = rawnn.ReLU()

    def forward(self, x):
        return self.wo(self.act(self.wi(x)))


class T5DenseGatedActDense(nn.Module):
    """v1.1 gated-GELU feed-forward."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, device=device)
        self.act = rawnn.NewGELU()
        self.mul = rawnn.Mul()

    def forward(self, x):
        return self.wo(self.mul(self.act(self.wi_0(x)), self.wi_1(x)))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool, has_relative_attention_bias: bool,
                 device=None):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_epsilon
        self.is_decoder = is_decoder
        self.self_attn = T5Attention(cfg, has_relative_attention_bias=has_relative_attention_bias,
                                     bidirectional=not is_decoder, device=device)
        self.self_attn_layer_norm = rawnn.RMSNorm(d, eps=eps, device=device)
        if is_decoder:
            self.cross_attn = T5Attention(cfg, bidirectional=True, device=device)
            self.cross_attn_layer_norm = rawnn.RMSNorm(d, eps=eps, device=device)
            self.resadd3 = rawnn.ResAdd()
        self.ff = (T5DenseGatedActDense(cfg, device) if cfg.is_gated_act
                   else T5DenseReluDense(cfg, device))
        self.ff_layer_norm = rawnn.RMSNorm(d, eps=eps, device=device)
        self.resadd1 = rawnn.ResAdd()
        self.resadd2 = rawnn.ResAdd()

    def forward(self, x, enc=None, position_bias=None, cache=None, enc_mask=None):
        x = self.resadd1(self.self_attn(self.self_attn_layer_norm(x),
                                        position_bias=position_bias, cache=cache), x)
        if self.is_decoder:
            x = self.resadd3(self.cross_attn(self.cross_attn_layer_norm(x), kv=enc,
                                             position_bias=enc_mask), x)
        return self.resadd2(self.ff(self.ff_layer_norm(x)), x)


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, embed_tokens: nn.Embedding, is_decoder: bool, device=None):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder
        self.embed_tokens = embed_tokens  # the shared table
        n = cfg.num_decoder_layers if is_decoder else cfg.num_layers
        self.block = nn.ModuleList(
            T5Block(cfg, is_decoder, has_relative_attention_bias=(i == 0), device=device)
            for i in range(n))
        self.final_layer_norm = rawnn.RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon,
                                              device=device)

    def forward(self, input_ids, enc=None, caches=None, position_offset=0, attn_mask=None,
                enc_mask=None):
        """``attn_mask``: an additive mask over THIS stack's keys (the
        encoder's padding); ``enc_mask``: an additive mask over the encoder's
        keys for the decoder's cross-attention (both broadcastable to [B,
        H, T, S])."""
        B, T = input_ids.shape
        x = take_rows(self.embed_tokens, input_ids)
        S = cache_seq_len(caches[0]) if caches is not None else T
        off = position_offset if caches is not None else 0
        bias = self.block[0].self_attn.compute_bias(T, S, query_offset=off).to(x.dtype)
        if self.is_decoder:
            bias = bias + causal_mask(T, S, off, x.dtype, x.device)  # [T, S] or [B, 1, T, S]
        if attn_mask is not None:
            bias = bias + attn_mask.to(x.dtype)
        for i, blk in enumerate(self.block):
            x = blk(x, enc=enc, position_bias=bias,
                    cache=None if caches is None else caches[i], enc_mask=enc_mask)
        return self.final_layer_norm(x)


class T5ForConditionalGeneration(nn.Module):
    """T5 with the shared table under ``shared``, ``encoder.embed_tokens``
    and ``decoder.embed_tokens`` (one Parameter) and, when tied, the LM
    head reading it too.

    Built on the card unless ``device='cpu'``.  Weights are random, drawn
    from ``seed`` with HF's T5 initialisation (factor 1): the table
    normal(0, 1), q normal(0, (d_model d_kv)^-0.5), k and v normal(0,
    d_model^-0.5), o normal(0, (heads d_kv)^-0.5), wi normal(0,
    d_model^-0.5), wo normal(0, d_ff^-0.5), the bias tables normal(0,
    d_model^-0.5), unit norms; :func:`load_jax_params` replaces them."""

    def __init__(self, cfg: T5Config, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.encoder = T5Stack(cfg, self.shared, is_decoder=False, device=device)
        self.decoder = T5Stack(cfg, self.shared, is_decoder=True, device=device)
        self.lm_head = (rawnn.TiedLinear(self.shared) if cfg.tie_word_embeddings
                        else nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, device=device))
        gen = torch.Generator(device=device).manual_seed(seed)
        d, kv, H, ff = cfg.d_model, cfg.d_kv, cfg.num_heads, cfg.d_ff
        std = {"q": (d * kv) ** -0.5, "k": d ** -0.5, "v": d ** -0.5, "o": (H * kv) ** -0.5,
               "wi": d ** -0.5, "wi_0": d ** -0.5, "wi_1": d ** -0.5, "wo": ff ** -0.5,
               "relative_attention_bias": d ** -0.5, "shared": 1.0, "lm_head": 1.0}
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, std[name.rsplit(".", 1)[-1]], generator=gen)

    @property
    def config(self):
        return self.cfg

    def encode(self, input_ids, attn_mask=None):
        return self.encoder(input_ids, attn_mask=attn_mask)

    def decode(self, decoder_input_ids, enc, caches=None, position_offset=0, enc_mask=None):
        h = self.decoder(decoder_input_ids, enc=enc, caches=caches,
                         position_offset=position_offset, enc_mask=enc_mask)
        if self.cfg.tie_word_embeddings:
            h = h * float(self.cfg.d_model ** -0.5)  # an f32 multiply, no host-to-device copy
        return self.lm_head(h)

    def forward(self, input_ids, decoder_input_ids, caches=None, position_offset=0):
        enc = self.encode(input_ids)
        return self.decode(decoder_input_ids, enc, caches, position_offset)

    def init_cache(self, batch: int, max_len: int, dtype=None, quantized: bool = False,
                   per_row: bool = False, device=None):
        """The decoder's self-attention caches, one per layer, on the card
        unless ``device='cpu'``; ``per_row`` as ``ops.kv_cache.make_caches``."""
        cfg = self.cfg
        return make_caches(cfg.num_decoder_layers, batch, cfg.num_heads, max_len, cfg.d_kv,
                           dtype or cfg.dtype, quantized=quantized, device=device,
                           per_row=per_row)

    def generate(self, input_ids, decoder_start_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, quantized_cache: bool = False):
        """Greedy seq2seq generation (``models.shared.seq2seq_generate``):
        encode once, prefill the start ids, decode greedily.  Returns [B, T0
        + max_new_tokens] token ids; after ``eos_token_id`` a row repeats
        it."""
        return seq2seq_generate(self, input_ids, decoder_start_ids, max_new_tokens,
                                eos_token_id, quantized_cache)

    @staticmethod
    def hf_tensor_converter(tensors):
        """HF T5 names (``block.{i}.layer.{j}.SelfAttention...``) -> this
        model's paths."""
        renames = [
            (".layer.0.SelfAttention.", ".self_attn."),
            (".layer.0.layer_norm.", ".self_attn_layer_norm."),
            (".layer.1.EncDecAttention.", ".cross_attn."),
            # the encoder's feed-forward lives in layer.1, the decoder's in layer.2
            (".layer.1.DenseReluDense.", ".ff."),
            (".layer.2.DenseReluDense.", ".ff."),
            (".layer.1.DenseGatedActDense.", ".ff."),
            (".layer.2.DenseGatedActDense.", ".ff."),
        ]
        out = {}
        for k, v in tensors.items():
            if ".layer.1.layer_norm." in k:
                new = ".cross_attn_layer_norm." if k.startswith("decoder.") else ".ff_layer_norm."
                k = k.replace(".layer.1.layer_norm.", new)
            k = k.replace(".layer.2.layer_norm.", ".ff_layer_norm.")
            for old, new in renames:
                k = k.replace(old, new)
            out[k] = v
        return out


def load_jax_params(model: T5ForConditionalGeneration, params: Dict[str, np.ndarray]) -> None:
    """Copy a raw JAX T5's weights into a raw port model, in place
    (``models.shared.load_jax_seq2seq_params``): nnx lists the shared table
    once (under ``decoder.embed_tokens``); it is written once, into
    ``shared``, whose Parameter every site reads."""
    load_jax_seq2seq_params(model, params, aliases={
        site: "shared" for site in ("encoder.embed_tokens", "decoder.embed_tokens",
                                         "lm_head.embed_ref")})
