"""Whisper encoder-decoder (whisper-tiny .. whisper-small shapes).

Port of ``dmx_compressor_tpu/models/whisper.py``.  The encoder's front-end
convolutions are ``nn.experimental.Conv1dUnfold`` (the unfold lowering of
the reference's Whisper recipe: a GEMM on the patches, its weight
``[out, in * 3]``); module paths follow HF's
``WhisperForConditionalGeneration``, and the raw model's state dict carries
HF's names (:meth:`WhisperForConditionalGeneration.hf_tensor_converter`
reshapes HF's conv weights).

Attention routing, the JAX package's (the shared helpers of
ops/flash_attention.py and ops/flash_decode.py):

- the decoder's prefill from position 0 goes through ``flash_prefill``:
  B3 over the fresh K/V when the compound SDPA is transparent and the cache
  is a float one (an int8 cache is refused there, so an int8 prefill
  attends through ``quantized_sdpa``); a chunk at a later offset through
  ``flash_chunked_prefill``;
- everything else goes through ``cached_attend``: a transparent T == 1
  decode step runs B2 (int8 cache) or B4 (f32 cache); the encoder's
  self-attention and the decoder's cross-attention (no cache, no mask) run
  the modular SDPA, as in the JAX package.

The cross-attention K/V are recomputed from the encoder output at every
decode step (the JAX package's semantics): at batch 8 they are the two
largest linears of a step, M = 8 x 1500 rows each.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import rawnn
from ..kernels import resolve_device
from ..nn.experimental import Conv1dUnfold
from ..ops.flash_attention import flash_chunked_prefill, flash_prefill
from ..ops.flash_decode import cached_attend
from ..ops.kv_cache import cache_seq_len, make_caches
from .positions import causal_mask, resolve_positions
from .shared import FrozenRouting, load_jax_seq2seq_params, seq2seq_generate, take_rows

__all__ = ["WhisperConfig", "sinusoids", "WhisperAttention", "WhisperEncoderLayer",
           "WhisperDecoderLayer", "WhisperEncoder", "WhisperDecoder", "WhisperModel",
           "WhisperForConditionalGeneration", "load_jax_params"]


@dataclasses.dataclass
class WhisperConfig:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 768
    encoder_layers: int = 12
    decoder_layers: int = 12
    encoder_attention_heads: int = 12
    decoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    decoder_ffn_dim: int = 3072
    max_source_positions: int = 1500
    max_target_positions: int = 448
    dtype: torch.dtype = torch.float32

    @property
    def hidden_size(self):
        return self.d_model

    @property
    def num_hidden_layers(self):
        return self.decoder_layers

    @classmethod
    def small(cls):
        """whisper-small: 12 + 12 layers of 768, 12 heads of 64, ffn 3072,
        vocab 51865 (the head tied to the token table), 80 mel bins, 1500
        source positions (3000 frames)."""
        return cls()

    @classmethod
    def tiny(cls):  # test-sized
        return cls(vocab_size=512, num_mel_bins=16, d_model=64, encoder_layers=2,
                   decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
                   encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=50,
                   max_target_positions=32)

    @classmethod
    def from_hf(cls, j):
        return cls(
            vocab_size=j["vocab_size"],
            num_mel_bins=j["num_mel_bins"],
            d_model=j["d_model"],
            encoder_layers=j["encoder_layers"],
            decoder_layers=j["decoder_layers"],
            encoder_attention_heads=j["encoder_attention_heads"],
            decoder_attention_heads=j["decoder_attention_heads"],
            encoder_ffn_dim=j["encoder_ffn_dim"],
            decoder_ffn_dim=j["decoder_ffn_dim"],
            max_source_positions=j["max_source_positions"],
            max_target_positions=j["max_target_positions"],
        )


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions, f32 [length, channels]."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class _FixedTable(nn.Module):
    """A fixed table as a buffer named ``weight`` (HF's name for the
    encoder's positions), outside the parameters.  A checkpoint's table is
    not loaded into it (``modeling.hf.load_hf_state_dict``): the JAX
    package keeps its sinusoids whatever a checkpoint holds."""

    from_checkpoints = False

    def __init__(self, table: np.ndarray, device=None):
        super().__init__()
        self.register_buffer("weight", torch.from_numpy(table).to(device))


class WhisperAttention(FrozenRouting, nn.Module):
    def __init__(self, d: int, heads: int, device=None):
        super().__init__()
        self.num_heads = heads
        self.head_dim = d // heads
        self.scaling = self.head_dim ** -0.5
        self.q_proj = nn.Linear(d, d, device=device)
        self.k_proj = nn.Linear(d, d, bias=False, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)
        self.sdpa = rawnn.ScaledDotProductAttention()

    def fuse_for_inference(self) -> None:
        """Called by ops.compress.compress_for_inference: q/k/v stay
        unmerged (the JAX model has no ``qkv_merged``); the routing is
        frozen."""
        self.freeze_routing()

    def _split(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, x, kv=None, attn_mask=None, cache=None,
                prefill_offset: Optional[int] = None):
        B, T, _ = x.shape
        kv = x if kv is None else kv
        q = self._split(self.q_proj(x))
        k = self._split(self.k_proj(kv))
        v = self._split(self.v_proj(kv))
        transparent = self.sdpa_is_transparent  # None until frozen: the ops ask
        out = None
        if prefill_offset is not None:
            if prefill_offset == 0:
                out = flash_prefill(self.sdpa, q, k, v, scale=self.scaling, cache=cache,
                                    transparent=transparent)
            else:
                out = flash_chunked_prefill(self.sdpa, q, k, v, cache=cache,
                                            offset=prefill_offset, scale=self.scaling,
                                            transparent=transparent)
        if out is None:
            out = cached_attend(self.sdpa, q, k, v, cache, attn_mask, scale=self.scaling,
                                transparent=transparent)
        # the local heads' width on a tensor-parallel rank
        return self.out_proj(out.transpose(1, 2).reshape(B, T, self.num_heads * self.head_dim))


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = WhisperAttention(d, cfg.encoder_attention_heads, device)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5, device=device)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim, device=device)
        self.activation_fn = rawnn.GELU()
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, d, device=device)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5, device=device)
        self.resadd1 = rawnn.ResAdd()
        self.resadd2 = rawnn.ResAdd()

    def forward(self, x):
        x = self.resadd1(self.self_attn(self.self_attn_layer_norm(x)), x)
        return self.resadd2(self.fc2(self.activation_fn(self.fc1(self.final_layer_norm(x)))), x)


class WhisperDecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = WhisperAttention(d, cfg.decoder_attention_heads, device)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5, device=device)
        self.encoder_attn = WhisperAttention(d, cfg.decoder_attention_heads, device)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=1e-5, device=device)
        self.fc1 = nn.Linear(d, cfg.decoder_ffn_dim, device=device)
        self.activation_fn = rawnn.GELU()
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, d, device=device)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5, device=device)
        self.resadd1 = rawnn.ResAdd()
        self.resadd2 = rawnn.ResAdd()
        self.resadd3 = rawnn.ResAdd()

    def forward(self, x, enc, attn_mask=None, cache=None, prefill_offset: Optional[int] = None):
        x = self.resadd1(self.self_attn(self.self_attn_layer_norm(x), attn_mask=attn_mask,
                                        cache=cache, prefill_offset=prefill_offset), x)
        x = self.resadd2(self.encoder_attn(self.encoder_attn_layer_norm(x), kv=enc), x)
        return self.resadd3(self.fc2(self.activation_fn(self.fc1(self.final_layer_norm(x)))), x)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        # the unfold-lowered convs (the Whisper recipe's hardware-friendly path)
        self.conv1 = Conv1dUnfold(cfg.num_mel_bins, cfg.d_model, 3, padding=1, device=device,
                                  generator=generator)
        self.conv2 = Conv1dUnfold(cfg.d_model, cfg.d_model, 3, stride=2, padding=1,
                                  device=device, generator=generator)
        self.gelu1 = rawnn.GELU()
        self.gelu2 = rawnn.GELU()
        self.embed_positions = _FixedTable(sinusoids(cfg.max_source_positions, cfg.d_model),
                                           device)
        self.layers = nn.ModuleList(WhisperEncoderLayer(cfg, device)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, device=device)

    def forward(self, input_features):
        """``input_features`` [B, mels, frames] -> [B, frames / 2, d_model]."""
        x = self.gelu1(self.conv1(input_features))
        x = self.gelu2(self.conv2(x))
        x = x.transpose(1, 2)  # [B, T, D]
        x = x + self.embed_positions.weight[None, :x.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, cfg.d_model, device=device)
        self.layers = nn.ModuleList(WhisperDecoderLayer(cfg, device)
                                    for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, device=device)

    def forward(self, input_ids, enc, caches=None, position_offset=0):
        B, T = input_ids.shape
        device = input_ids.device
        pos, _ = resolve_positions(T, position_offset, device)  # [1 or B, T]
        x = take_rows(self.embed_tokens, input_ids) + take_rows(self.embed_positions, pos)
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
        for i, layer in enumerate(self.layers):
            x = layer(x, enc, attn_mask=mask, cache=None if caches is None else caches[i],
                      prefill_offset=prefill_offset)
        return self.layer_norm(x)


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None, generator=None):
        super().__init__()
        self.encoder = WhisperEncoder(cfg, device, generator)
        self.decoder = WhisperDecoder(cfg, device)


class WhisperForConditionalGeneration(nn.Module):
    """Whisper with ``proj_out`` tied to ``model.decoder.embed_tokens``.

    Built on the card unless ``device='cpu'``.  Weights are random, drawn
    from ``seed`` with HF's Whisper initialisation: normal(0, 0.02) for the
    linears, the convs and both decoder embeddings, zero biases, unit
    LayerNorm scales, the encoder's positions the fixed sinusoids;
    :func:`load_jax_params` replaces them."""

    def __init__(self, cfg: WhisperConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        self.model = WhisperModel(cfg, device, gen)
        self.proj_out = rawnn.TiedLinear(self.model.decoder.embed_tokens)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding, Conv1dUnfold)):
                    m.weight.normal_(0.0, 0.02, generator=gen)
                if isinstance(m, (nn.Linear, Conv1dUnfold)) and m.bias is not None:
                    m.bias.zero_()

    @property
    def config(self):
        return self.cfg

    def encode(self, input_features):
        return self.model.encoder(input_features)

    def decode(self, decoder_input_ids, enc, caches=None, position_offset=0):
        return self.proj_out(self.model.decoder(decoder_input_ids, enc, caches, position_offset))

    def forward(self, input_features, decoder_input_ids, caches=None, position_offset=0):
        enc = self.encode(input_features)
        return self.decode(decoder_input_ids, enc, caches, position_offset)

    def init_cache(self, batch: int, max_len: int, dtype=None, quantized: bool = False,
                   per_row: bool = False, device=None):
        """The decoder's self-attention caches, one per layer, on the card
        unless ``device='cpu'``; ``per_row`` as ``ops.kv_cache.make_caches``.
        The head count is the attention's own: the local one on a
        tensor-parallel rank."""
        cfg = self.cfg
        attn = self.model.decoder.layers[0].self_attn
        return make_caches(cfg.decoder_layers, batch, attn.num_heads, max_len, attn.head_dim,
                           dtype or cfg.dtype,
                           quantized=quantized, device=device, per_row=per_row)

    def generate(self, input_features, decoder_start_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, quantized_cache: bool = False):
        """Greedy transcription (``models.shared.seq2seq_generate``): encode
        once, prefill the start ids, decode greedily.  Returns [B, T0 +
        max_new_tokens] token ids; after ``eos_token_id`` a row repeats it."""
        return seq2seq_generate(self, input_features, decoder_start_ids, max_new_tokens,
                                eos_token_id, quantized_cache)

    @staticmethod
    def hf_tensor_converter(tensors):
        """HF conv weights [out, in, k] -> the unfold GEMM layout [out, in * k]."""
        out = {}
        for k, v in tensors.items():
            if ".conv1.weight" in k or ".conv2.weight" in k:
                v = v.reshape(v.shape[0], -1)
            out[k] = v
        return out


def load_jax_params(model: WhisperForConditionalGeneration, params: Dict[str, np.ndarray]) -> None:
    """Copy a raw JAX Whisper's weights into a raw port model, in place
    (``models.shared.load_jax_seq2seq_params``): the convs' GEMM-shaped
    weights as they are (their cast state skipped), the encoder's position
    table into its buffer; the head stays tied to
    ``model.decoder.embed_tokens``."""
    load_jax_seq2seq_params(model, params,
                            aliases={"proj_out.embed_ref": "model.decoder.embed_tokens"},
                            buffers=("model.encoder.embed_positions",))
