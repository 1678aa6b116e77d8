"""GPT-2 decoder (gpt2 .. gpt2-xl / distilgpt2 shapes).

Port of ``dmx_compressor_tpu/models/gpt2.py``.  Authored with torch
modules and ``rawnn`` op wrappers (NewGELU, ResAdd, TiedLinear,
ScaledDotProductAttention) so the Dmx substitution pass intercepts every
op; module paths follow the HF checkpoint layout
(``transformer.h.N.attn.c_attn``).  HF GPT-2 stores its matmul weights as
Conv1D [in, out]; the zoo keeps [out, in] Linears and
:meth:`GPT2LMHeadModel.hf_tensor_converter` transposes them.

The query, key and value projections are born merged (``c_attn``, one
Linear of 3 x hidden), so compression merges nothing.  Attention routing is
the Llama family's (the shared helpers of ops/flash_attention.py and
ops/flash_decode.py): a prefill from position 0 through ``flash_prefill``
(B3 when the compound SDPA is transparent; an int8 cache is refused there,
so an int8 prefill attends through ``quantized_sdpa``), a chunk at a later
offset through ``flash_chunked_prefill``, everything else through
``cached_attend`` (B2 / B4 on a transparent T == 1 step; the fused BASIC
split decode over a split cache).

In BASIC mode a decode step of a block runs the fused step
(:meth:`GPT2Block._fused_basic_step`: OPT's with the ReLU replaced by the
exact tanh-GELU between FLOAT16 casts) and the tied LM head folds the
final LayerNorm in (``fused_ln_linear``): casts through kernel T2, matmuls
through kernel T1.  Otherwise every packed linear runs ``bfp_linear`` (B1,
or T1 on bf16-exact activations) or ``sbfp_linear`` (B5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import rawnn
from ..kernels import resolve_device
from ..ops.basic_layer import (
    basic_gpt2_block_plan,
    basic_head_plan,
    fused_ln_linear,
    gelu_tanh_fp16,
)
from ..ops.basic_linear import fused_basic_linear
from ..ops.flash_attention import flash_chunked_prefill, flash_prefill
from ..ops.flash_decode import cached_attend
from ..ops.kv_cache import cache_seq_len, make_caches
from .positions import causal_mask, resolve_positions
from .shared import FrozenRouting, load_jax_biased_params, take_rows

__all__ = ["GPT2Config", "GPT2Attention", "GPT2MLP", "GPT2Block", "GPT2Model",
           "GPT2LMHeadModel", "load_jax_params"]


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_positions: int = 1024
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def max_position_embeddings(self):
        return self.n_positions

    @property
    def hidden_size(self):
        return self.n_embd

    @property
    def num_hidden_layers(self):
        return self.n_layer

    @classmethod
    def from_hf(cls, j):
        return cls(
            vocab_size=j["vocab_size"],
            n_embd=j["n_embd"],
            n_layer=j["n_layer"],
            n_head=j["n_head"],
            n_positions=j["n_positions"],
            layer_norm_epsilon=j.get("layer_norm_epsilon", 1e-5),
        )

    @classmethod
    def gpt2(cls):
        """bench.py's ``gpt2``: GPT-2 124M (12 layers of 768, 12 heads of
        64, 1024 positions, a head tied to the 50257-wide vocabulary)."""
        return cls()

    @classmethod
    def tiny(cls):  # test-sized
        return cls(vocab_size=512, n_embd=64, n_layer=2, n_head=4, n_positions=64)


class GPT2Attention(FrozenRouting, nn.Module):
    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        d = cfg.n_embd
        self.num_heads = cfg.n_head
        self.head_dim = d // cfg.n_head
        self.c_attn = nn.Linear(d, 3 * d, device=device)
        self.c_proj = nn.Linear(d, d, device=device)
        self.sdpa = rawnn.ScaledDotProductAttention()

    def fuse_for_inference(self) -> None:
        """Called by ops.compress.compress_for_inference: ``c_attn`` is
        merged already, so only the routing is frozen."""
        self.freeze_routing()

    def _split(self, t):
        B, T, _ = t.shape
        return t.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

    def attend(self, qkv, attn_mask=None, cache=None, prefill_offset: Optional[int] = None):
        """Head-split attention over the merged projection [B, T, 3D];
        returns the merged-head context [B, T, D] (before ``c_proj``)."""
        B, T, D3 = qkv.shape
        D = D3 // 3
        q, k, v = (self._split(t) for t in qkv.split(D, dim=-1))
        transparent = self.sdpa_is_transparent  # None until frozen: the ops ask
        out = None
        if prefill_offset is not None:
            if prefill_offset == 0:
                out = flash_prefill(self.sdpa, q, k, v, cache=cache, transparent=transparent)
            else:
                out = flash_chunked_prefill(self.sdpa, q, k, v, cache=cache,
                                            offset=prefill_offset, transparent=transparent)
        if out is None:
            out = cached_attend(self.sdpa, q, k, v, cache, attn_mask, transparent=transparent)
        return out.transpose(1, 2).reshape(B, T, D)

    def forward(self, x, attn_mask=None, cache=None, prefill_offset: Optional[int] = None):
        return self.c_proj(self.attend(self.c_attn(x), attn_mask, cache, prefill_offset))


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, device=device)
        self.act = rawnn.NewGELU()
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, device=device)

    def forward(self, x):
        return self.c_proj(self.act(self.c_fc(x)))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        d, eps = cfg.n_embd, cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(d, eps=eps, device=device)
        self.attn = GPT2Attention(cfg, device)
        self.ln_2 = nn.LayerNorm(d, eps=eps, device=device)
        self.mlp = GPT2MLP(cfg, device)
        self.resadd1 = rawnn.ResAdd()
        self.resadd2 = rawnn.ResAdd()

    def forward(self, x, attn_mask=None, cache=None, prefill_offset: Optional[int] = None):
        if (x.shape[1] == 1 and cache is not None and attn_mask is not None
                and attn_mask.is_floating_point()):
            plan = basic_gpt2_block_plan(self)
            if plan is not None:
                return self._fused_basic_step(x, attn_mask, cache, plan)
        x = self.resadd1(self.attn(self.ln_1(x), attn_mask=attn_mask, cache=cache,
                                   prefill_offset=prefill_offset), x)
        return self.resadd2(self.mlp(self.ln_2(x)), x)

    def _fused_basic_step(self, x, attn_mask, cache, plan):
        """The BASIC decode step as fused chains (ops/basic_layer.py): LN1 +
        c_attn / fused SDPA / c_proj / resadd1 + LN2 + c_fc / tanh-GELU /
        mlp.c_proj + resadd2, the modular pipeline's numerics up to the f32
        summation order of the LN moments and the matmuls.  OPT's fused
        step with the ReLU replaced by the exact tanh-GELU between its
        FLOAT16 casts (the BASIC rules leave GELUBase at approximation
        NONE)."""
        attn, mlp = self.attn, self.mlp
        qkv = fused_ln_linear(x, packed=attn.c_attn.packed, bias=attn.c_attn.bias,
                              ln_w=self.ln_1._weight, ln_b=self.ln_1._bias, eps=plan.ln1_eps,
                              wl=plan.wl, in_block=plan.block)
        y = attn.c_proj(attn.attend(qkv, attn_mask, cache))  # PackedBFPLinear's fused path
        h, r = fused_ln_linear(
            y, packed=mlp.c_fc.packed, bias=mlp.c_fc.bias, ln_w=self.ln_2._weight,
            ln_b=self.ln_2._bias, eps=plan.ln2_eps, wl=plan.wl, in_block=plan.block,
            residual=x, emit_pre=True,
            input_on_grid=True,  # y: c_proj's FLOAT16 output cast
        )
        h = gelu_tanh_fp16(h, on_grid=True)  # h: c_fc's FLOAT16 output cast
        return fused_basic_linear(
            h, packed=mlp.c_proj.packed, bias=mlp.c_proj.bias, in_wl=plan.wl,
            in_block=plan.block, out_fp16=True, res_out=r,
            res_on_grid=True,  # r: resadd's FLOAT16 output cast
        )


class GPT2Model(nn.Module):
    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, device=device)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd, device=device)
        self.h = nn.ModuleList(GPT2Block(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, device=device)

    def forward(self, input_ids, caches=None, position_offset=0, apply_final_ln: bool = True):
        B, T = input_ids.shape
        device = input_ids.device
        pos, _ = resolve_positions(T, position_offset, device)
        x = take_rows(self.wte, input_ids) + take_rows(self.wpe, pos)
        if caches is not None:
            mask = causal_mask(T, cache_seq_len(caches[0]), position_offset, x.dtype, device)
        else:
            mask = causal_mask(T, T, 0, x.dtype, device)
        # a prefill (T > 1 at one offset for the batch) from 0, or a chunk at
        # a later offset over a cache
        prefill_offset = (
            position_offset
            if (T > 1 and isinstance(position_offset, int)
                and (position_offset == 0 or caches is not None))
            else None
        )
        for i, block in enumerate(self.h):
            x = block(x, attn_mask=mask, cache=None if caches is None else caches[i],
                      prefill_offset=prefill_offset)
        return self.ln_f(x) if apply_final_ln else x


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with the LM head tied to ``wte``; returns logits.

    Built on the card unless ``device='cpu'``.  Weights are random, drawn
    from ``seed`` (HF's GPT-2 init: normal(0, 0.02) for the linears and
    both embeddings, zero biases, unit LayerNorm scales);
    :func:`load_jax_params` replaces them."""

    def __init__(self, cfg: GPT2Config, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.transformer = GPT2Model(cfg, device)
        self.lm_head = rawnn.TiedLinear(self.transformer.wte)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, 0.02, generator=gen)
                if isinstance(m, nn.Linear):
                    m.bias.zero_()

    @property
    def config(self):
        return self.cfg

    def forward(self, input_ids, caches=None, position_offset=0):
        if input_ids.shape[1] == 1 and caches is not None:
            final_ln = self.transformer.ln_f
            plan = basic_head_plan(final_ln, self.lm_head)
            if plan is not None:
                # BASIC decode: the final LayerNorm folds into the head
                h = self.transformer(input_ids, caches=caches, position_offset=position_offset,
                                     apply_final_ln=False)
                return fused_ln_linear(
                    h, packed=self.lm_head.packed, bias=self.lm_head.bias,
                    ln_w=final_ln._weight, ln_b=final_ln._bias, eps=plan.ln_eps, wl=plan.wl,
                    in_block=plan.block,
                    input_on_grid=True,  # h: the last resadd's FLOAT16 output cast
                )
        h = self.transformer(input_ids, caches=caches, position_offset=position_offset)
        return self.lm_head(h)

    def init_cache(self, batch: int, max_len: int, dtype=None, quantized: bool = False,
                   per_row: bool = False, split_base_len: Optional[int] = None, device=None):
        """One cache per layer, on the card unless ``device='cpu'``;
        ``per_row`` and ``split_base_len`` as ``ops.kv_cache.make_caches``;
        the head count is the attention's own (the local one on a
        tensor-parallel rank)."""
        cfg = self.cfg
        attn = self.transformer.h[0].attn
        return make_caches(
            cfg.n_layer, batch, attn.num_heads, max_len, attn.head_dim,
            dtype or cfg.dtype, quantized=quantized, split_base_len=split_base_len,
            device=device, per_row=per_row,
        )

    @staticmethod
    def hf_tensor_converter(tensors):
        """HF GPT-2's tensors for this model: the Conv1D weights [in, out]
        of ``c_attn``, ``c_proj`` and ``c_fc`` transposed to Linear's [out,
        in], the attention's mask buffers dropped."""
        out = {}
        for k, v in tensors.items():
            if k.endswith(".attn.bias") or k.endswith(".attn.masked_bias"):
                continue
            if any(k.endswith(f"{m}.weight") for m in ("c_attn", "c_proj", "c_fc")):
                v = v.T
            out[k] = v
        return out


def load_jax_params(model: GPT2LMHeadModel, params: Dict[str, np.ndarray]) -> None:
    """Copy the raw JAX GPT-2's weights into a raw port model, in place:
    ``nnx.Linear``'s kernel (transposed) and bias, ``nnx.LayerNorm``'s scale
    and bias, ``wte`` and ``wpe``; the head stays tied to ``wte``.  Every
    parameter of the port must be covered, and every array used."""
    load_jax_biased_params(model, params, "transformer.wte")
