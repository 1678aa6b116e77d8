"""OPT decoder-only transformer (facebook/opt-125m .. opt-1.3b shapes).

Port of ``dmx_compressor_tpu/models/opt.py`` for the serving paths of the
JAX bench and of the continuous-batching engine (``serving/engine.py``).
Authored with torch modules and ``rawnn`` op wrappers so the Dmx
substitution pass intercepts every op; module paths mirror the HF checkpoint
layout (``model.decoder.layers.N.self_attn.q_proj``).

Attention routing (the JAX package's opt.py:172-292), when the compound SDPA
is transparent (no cast, no surrogate):

- prefill at offset 0 with a cache: the cache is written (the int8 payload
  for an int8 cache) and attention runs over the fresh K/V through
  ``flash_attention`` (B3);
- decode (T == 1) with an int8 cache: ``flash_decode_int8`` (B2) over the
  int8 payload, masked by the cache's per-row lengths;
- decode (T == 1) with a float cache: ``flash_decode`` (B4) over the f32
  buffers, masked the same way;
- otherwise the modular compound SDPA (dequantized K/V for an int8 cache),
  except that a non-transparent decode step in the BASIC shape over a whole
  cache runs the fused ``basic_sdpa_decode``, as the JAX package does.

``position_offset`` is a Python int (one offset for the batch) or an int
tensor [B] of per-row offsets (the engine's row caches).  The embeddings
are looked up with ``jnp.take``'s default semantics, as in the JAX package:
an index in [-n, n) wraps and any other gives a row of NaN, so an idle slot
of the engine whose position has run past the table (it keeps decoding
garbage) yields NaN in its own row instead of failing the lookup.

A prefill/decode split cache (``SplitKVCache``, the BASIC mode's float16
cache) takes its own branch (``_attend_split``): prefill writes the base
segment and attends over the fresh K/V (B3 when transparent, else the
modular SDPA); a decode step appends to the tail and, when the SDPA is in
the BASIC shape, runs ``basic_sdpa_decode_split`` over the two segments.

In BASIC mode a decode step of a layer runs the fused step
(``OPTDecoderLayer._fused_basic_step``, ops/basic_layer.py) and the LM head
folds the final LayerNorm in (``fused_ln_linear``): casts through kernel T2,
matmuls through kernel T1.  Otherwise every packed linear runs
``bfp_linear`` (B1, or T1 on bf16-exact activations) through
PackedBFPLinear or ``sbfp_linear`` (B5) through PackedSBFPLinear.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import rawnn
from ..kernels import resolve_device
from ..ops.compress import merge_parallel_linears
from ..ops.basic_attention import basic_sdpa_decode, basic_sdpa_decode_split, basic_sdpa_shape
from ..ops.basic_layer import basic_head_plan, basic_layer_plan, fused_ln_linear
from ..ops.basic_linear import fused_basic_linear
from ..ops.flash_attention import flash_attention
from ..ops.flash_decode import flash_decode, flash_decode_int8, post_update_lengths
from ..ops.kv_cache import cache_seq_len, make_caches, quantized_sdpa
from ..utils.tracing import span
from .positions import causal_mask, resolve_positions
# greedy decoding is shared by every family; OPT's callers import it here
from .shared import FrozenRouting, load_jax_biased_params, take_rows
from .shared import greedy_decode, greedy_prefill, greedy_token  # noqa: F401


@dataclasses.dataclass
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    dtype: torch.dtype = torch.float32

    @classmethod
    def opt_125m(cls):
        return cls()

    @classmethod
    def opt_350m(cls):
        return cls(hidden_size=1024, ffn_dim=4096, num_hidden_layers=24, num_attention_heads=16,
                   do_layer_norm_before=False)

    @classmethod
    def opt_1_3b(cls):
        return cls(hidden_size=2048, ffn_dim=8192, num_hidden_layers=24, num_attention_heads=32)

    @classmethod
    def tiny(cls):  # test-sized
        return cls(vocab_size=512, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                   num_attention_heads=4, max_position_embeddings=64)


class OPTAttention(FrozenRouting, nn.Module):
    def __init__(self, cfg: OPTConfig, device):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = d // cfg.num_attention_heads
        self.scaling = self.head_dim**-0.5
        self.q_proj = nn.Linear(d, d, device=device)
        self.k_proj = nn.Linear(d, d, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)
        self.sdpa = rawnn.ScaledDotProductAttention()
        self.qkv_merged = None

    def _split(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

    def fuse_for_inference(self) -> None:
        """Merge q/k/v into one packed projection when possible (called by
        ops.compress.compress_for_inference; bit-exact), then freeze the
        routing."""
        merged = merge_parallel_linears([self.q_proj, self.k_proj, self.v_proj])
        if merged is not None:
            self.qkv_merged = merged
        self.freeze_routing()

    def _project_qkv(self, x):
        if self.qkv_merged is not None:
            qkv = self.qkv_merged(x)
            d = self.num_heads * self.head_dim
            return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        return self.q_proj(x), self.k_proj(x), self.v_proj(x)

    def forward(self, x, attn_mask=None, cache=None, position_offset=0):
        _q, _k, _v = self._project_qkv(x)
        return self.out_proj(self.attend(_q, _k, _v, attn_mask, cache, position_offset))

    def _attend_split(self, q, k, v, attn_mask, cache, position_offset):
        """Attention over a SplitKVCache, [B, H, T, D] in and out."""
        T = q.shape[2]
        if T > 1 and isinstance(position_offset, int) and position_offset == 0:
            # prefill: write the base, attend over the fresh K/V (the base
            # casts are made by prepare_split_decode before decoding)
            cache.write_base(k, v)
            if self._transparent():
                return flash_attention(q, k, v, causal=True, scale=self.scaling)
            m = attn_mask[..., :k.shape[2]] if attn_mask is not None else None
            return self.sdpa(q, k, v, attn_mask=m, scale=self.scaling)
        if T == 1 and attn_mask is not None:
            p = basic_sdpa_shape(self.sdpa, self.head_dim, cache.tail_len)
            if p is not None and cache.base_len % p.block == 0:
                bk, bv, tk, tv = cache.append_tail(k, v)
                precast = cache.base_cast_key == (p.wl, p.block)
                return basic_sdpa_decode_split(
                    q, bk, bv, tk, tv, attn_mask, scale=self.scaling, params=p,
                    base_k_cast=cache.base_k_cast if precast else None,
                    base_v_cast=cache.base_v_cast if precast else None,
                )
        # the modular path over the concatenated segments, in q's dtype (the
        # JAX package's matmuls promote a float16 cache the same way)
        kf, vf, _ = cache.update(k, v)
        return self.sdpa(q, kf.to(q.dtype), vf.to(q.dtype), attn_mask=attn_mask,
                         scale=self.scaling)

    def attend(self, _q, _k, _v, attn_mask=None, cache=None, position_offset=0):
        """Head-split attention over projected q/k/v [B, T, D]; returns the
        merged-head context [B, T, D] (before out_proj).  Recorded as the
        span ``dmx.attention``."""
        with span("dmx.attention"):
            return self._attend(_q, _k, _v, attn_mask, cache, position_offset)

    def _attend(self, _q, _k, _v, attn_mask, cache, position_offset):
        B, T, D = _q.shape
        q, k, v = self._split(_q), self._split(_k), self._split(_v)
        if cache is not None and getattr(cache, "split", False):
            out = self._attend_split(q, k, v, attn_mask, cache, position_offset)
            return out.transpose(1, 2).reshape(B, T, D)
        quant = cache is not None and cache.quantized
        prefill = (
            cache is not None and T > 1
            and isinstance(position_offset, int) and position_offset == 0
        )
        transparent = self._transparent()
        if prefill and transparent:
            if quant:
                cache.update_payload(k, v)
            else:
                cache.update(k, v)
            out = flash_attention(q, k, v, causal=True, scale=self.scaling)
        elif quant and transparent:
            kv = cache.update_quantized(k, v)
            if T == 1 and attn_mask is not None:
                out = flash_decode_int8(q, kv, post_update_lengths(cache), scale=self.scaling)
            else:
                out = quantized_sdpa(q, kv, attn_mask=attn_mask, scale=self.scaling)
        elif cache is not None and transparent and T == 1 and attn_mask is not None:
            cache.update(k, v)
            out = flash_decode(q, cache.k, cache.v, post_update_lengths(cache),
                               scale=self.scaling)
        else:
            out = None
            if cache is not None:
                k, v, _ = cache.update(k, v)  # an int8 cache dequantizes here
                if T == 1 and attn_mask is not None:
                    # the BASIC compound SDPA over the whole cache, fused
                    p = basic_sdpa_shape(self.sdpa, self.head_dim, k.shape[2])
                    if p is not None:
                        out = basic_sdpa_decode(q, k, v, attn_mask, scale=self.scaling, params=p)
            if out is None:
                # a 16-bit cache in q's dtype (the JAX package's matmuls promote it)
                out = self.sdpa(q, k.to(q.dtype), v.to(q.dtype), attn_mask=attn_mask,
                                scale=self.scaling)
        return out.transpose(1, 2).reshape(B, T, D)


class OPTDecoderLayer(nn.Module):
    def __init__(self, cfg: OPTConfig, device):
        super().__init__()
        d = cfg.hidden_size
        self.do_layer_norm_before = cfg.do_layer_norm_before
        self.self_attn = OPTAttention(cfg, device)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5, device=device)
        self.fc1 = nn.Linear(d, cfg.ffn_dim, device=device)
        self.activation_fn = rawnn.ReLU()
        self.fc2 = nn.Linear(cfg.ffn_dim, d, device=device)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5, device=device)
        self.resadd1 = rawnn.ResAdd()
        self.resadd2 = rawnn.ResAdd()

    def forward(self, x, attn_mask=None, cache=None, position_offset=0):
        if (x.shape[1] == 1 and cache is not None and attn_mask is not None
                and attn_mask.is_floating_point()):
            plan = basic_layer_plan(self)
            if plan is not None:
                return self._fused_basic_step(x, attn_mask, cache, position_offset, plan)
        residual = x
        if self.do_layer_norm_before:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(x, attn_mask=attn_mask, cache=cache, position_offset=position_offset)
        x = self.resadd1(x, residual)
        if not self.do_layer_norm_before:
            x = self.self_attn_layer_norm(x)
        residual = x
        if self.do_layer_norm_before:
            x = self.final_layer_norm(x)
        x = self.fc2(self.activation_fn(self.fc1(x)))
        x = self.resadd2(x, residual)
        if not self.do_layer_norm_before:
            x = self.final_layer_norm(x)
        return x

    def _fused_basic_step(self, x, attn_mask, cache, position_offset, plan):
        """The BASIC decode step as fused chains (ops/basic_layer.py):
        LN1 + qkv / fused SDPA / out_proj / resadd1 + LN2 + fc1 + ReLU /
        fc2 + resadd2, the modular pipeline's numerics up to the f32
        summation order of the LN moments and the matmuls."""
        attn = self.self_attn
        merged = attn.qkv_merged
        ln1, ln2 = self.self_attn_layer_norm, self.final_layer_norm
        qkv = fused_ln_linear(x, packed=merged.packed, bias=merged.bias, ln_w=ln1._weight,
                              ln_b=ln1._bias, eps=plan.ln1_eps, wl=plan.wl, in_block=plan.block)
        d = attn.num_heads * attn.head_dim
        ctx = attn.attend(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], attn_mask=attn_mask,
                          cache=cache, position_offset=position_offset)
        y = attn.out_proj(ctx)  # PackedBFPLinear's fused path
        h, r = fused_ln_linear(
            y, packed=self.fc1.packed, bias=self.fc1.bias, ln_w=ln2._weight, ln_b=ln2._bias,
            eps=plan.ln2_eps, wl=plan.wl, in_block=plan.block, residual=x, relu=True,
            emit_pre=True,
            input_on_grid=True,  # y: out_proj's FLOAT16 output cast
        )
        return fused_basic_linear(
            h, packed=self.fc2.packed, bias=self.fc2.bias, in_wl=plan.wl, in_block=plan.block,
            out_fp16=True, res_out=r,
            res_on_grid=True,  # r: resadd's FLOAT16 output cast
        )


class OPTDecoder(nn.Module):
    def __init__(self, cfg: OPTConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        # OPT's learned positions carry a +2 offset (HF convention)
        self.embed_positions = nn.Embedding(
            cfg.max_position_embeddings + 2, cfg.hidden_size, device=device
        )
        self.layers = nn.ModuleList(
            OPTDecoderLayer(cfg, device) for _ in range(cfg.num_hidden_layers)
        )
        self.final_layer_norm = (
            nn.LayerNorm(cfg.hidden_size, eps=1e-5, device=device)
            if cfg.do_layer_norm_before else None
        )

    def forward(self, input_ids, caches=None, position_offset=0, apply_final_ln=True):
        B, T = input_ids.shape
        device = input_ids.device
        x = take_rows(self.embed_tokens, input_ids)
        positions, _ = resolve_positions(T, position_offset, device)
        x = x + take_rows(self.embed_positions, positions + 2)
        if caches is not None:
            # with a cache, queries attend to all filled slots
            mask = causal_mask(T, cache_seq_len(caches[0]), position_offset, x.dtype, device)
        else:
            mask = causal_mask(T, T, 0, x.dtype, device)
        for i, layer in enumerate(self.layers):
            x = layer(x, attn_mask=mask, cache=None if caches is None else caches[i],
                      position_offset=position_offset)
        if apply_final_ln and self.final_layer_norm is not None:
            x = self.final_layer_norm(x)
        return x


class OPTModel(nn.Module):
    def __init__(self, cfg: OPTConfig, device):
        super().__init__()
        self.decoder = OPTDecoder(cfg, device)

    def forward(self, input_ids, caches=None, position_offset=0):
        return self.decoder(input_ids, caches=caches, position_offset=position_offset)


class OPTForCausalLM(nn.Module):
    """OPT with the LM head tied to the token embedding; returns logits.

    Built on the card unless ``device='cpu'``.  Weights are random, drawn
    from ``seed`` (HF's OPT init: normal(0, 0.02), zero biases, unit
    LayerNorm scales); :func:`load_jax_params` replaces them."""

    def __init__(self, cfg: OPTConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.model = OPTModel(cfg, device)
        self.lm_head = rawnn.TiedLinear(self.model.decoder.embed_tokens)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, 0.02, generator=gen)
                if isinstance(m, nn.Linear):
                    m.bias.zero_()

    @property
    def config(self) -> OPTConfig:
        return self.cfg

    def forward(self, input_ids, caches=None, position_offset=0):
        """Logits [B, T, vocab]; recorded as the span ``dmx.forward``."""
        with span("dmx.forward"):
            return self._logits(input_ids, caches, position_offset)

    def _logits(self, input_ids, caches, position_offset):
        if input_ids.shape[1] == 1 and caches is not None:
            final_ln = self.model.decoder.final_layer_norm
            plan = basic_head_plan(final_ln, self.lm_head)
            if plan is not None:
                # BASIC decode: the final LayerNorm folds into the head
                h = self.model.decoder(input_ids, caches=caches,
                                       position_offset=position_offset, apply_final_ln=False)
                return fused_ln_linear(
                    h, packed=self.lm_head.packed, bias=self.lm_head.bias,
                    ln_w=final_ln._weight, ln_b=final_ln._bias, eps=plan.ln_eps, wl=plan.wl,
                    in_block=plan.block,
                    input_on_grid=True,  # h: the last resadd's FLOAT16 output cast
                )
        h = self.model(input_ids, caches=caches, position_offset=position_offset)
        return self.lm_head(h)

    def init_cache(self, batch: int, max_len: int, dtype=None, quantized: bool = False,
                   split_base_len: Optional[int] = None, device=None, per_row: bool = False):
        """One cache per layer, on the card unless ``device='cpu'``; with
        ``per_row`` a row cache (one fill point per batch row); with
        ``split_base_len`` a SplitKVCache whose base holds that many slots
        and whose tail the rest of ``max_len``.  The head count is the
        attention's own: the local one on a tensor-parallel rank."""
        cfg = self.cfg
        attn = self.model.decoder.layers[0].self_attn
        return make_caches(
            cfg.num_hidden_layers, batch, attn.num_heads, max_len, attn.head_dim,
            dtype or cfg.dtype,
            quantized=quantized, split_base_len=split_base_len, device=device, per_row=per_row,
        )


def load_jax_params(model: OPTForCausalLM, params: Dict[str, np.ndarray]) -> None:
    """Copy the raw JAX OPT's weights into a raw port model, in place.

    ``params`` is the JAX model's flattened nnx state, dotted path -> numpy
    array (``model.decoder.layers.0.self_attn.q_proj.kernel`` ...); the LM
    head stays tied to ``embed_tokens``.  See
    :func:`.shared.load_jax_biased_params`."""
    load_jax_biased_params(model, params, "model.decoder.embed_tokens")


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (the perplexity numerator), HF-style shift:
    the logits at position t score the label at t + 1, in f32."""
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[:, 1:, None].long())[..., 0]
    return nll.mean()
