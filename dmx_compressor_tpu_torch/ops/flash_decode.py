"""Single-query attention over a float KV cache (kernel B4) and an int8 one
(kernel B2).

Port of ``flash_decode_ref``, ``flash_decode``, ``flash_decode_int8_ref``,
``flash_decode_int8`` and ``post_update_lengths`` of
``dmx_compressor_tpu/ops/flash_decode.py``.  The CUDA kernels
(``csrc/flash_decode.cu``, ``csrc/flash_decode_int8.cu``) read the K/V rows
below each row's length and keep an online softmax in f32; the int8 one
dequantizes in registers with the per-position scales after the dot products
(``quantized_sdpa``'s factorization).  ``flash_decode`` and
``flash_decode_int8`` launch their kernel for CUDA tensors and run the plain
version for CPU tensors.  The port has no routing floor: every transparent
T == 1 decode step goes through one of them.  The JAX package's
``s_minor`` variants are a TPU layout; the port's caches are D-minor.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .kv_cache import QuantKV

NEG_INF = -1e30


def post_update_lengths(cache) -> torch.Tensor:
    """Per-row valid lengths after this step's append, int32 [B] on the
    cache's device: what the plain causal decode mask encodes."""
    return cache.lengths


def _lengths_1d(lengths, B: int, device) -> torch.Tensor:
    le = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return le.expand(B) if le.ndim == 0 else le


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: unblocked masked softmax attention for T == 1 queries.
    q [B, H, 1, D]; K/V [B, Hkv, S, D]."""
    B, H, _, D = q.shape
    scale = (D**-0.5) if scale is None else scale
    if k.shape[-3] != H:
        rep = H // k.shape[-3]
        k = torch.repeat_interleave(k, rep, dim=-3)
        v = torch.repeat_interleave(v, rep, dim=-3)
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    le = _lengths_1d(lengths, B, q.device)
    mask = torch.arange(k.shape[-2], device=q.device)[None, :] < le[:, None]  # [B, S]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, v.to(torch.float32)).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths,
                 scale: Optional[float] = None) -> torch.Tensor:
    """softmax((q k^T) * scale masked to col < lengths[b]) v over f32 K/V
    [B, Hkv, S, D], one query per row.  Returns [B, H, 1, D].  lengths:
    int32 [B] or a scalar, each >= 1.  On the card, K/V of another dtype or a
    head_dim other than 32/64/128 raise."""
    B, H, T, D = q.shape
    if T != 1:
        raise ValueError("flash_decode is the single-query decode kernel")
    if not kernels.plain_or_kernel(q):
        return flash_decode_ref(q, k, v, lengths, scale)
    Hkv, S = k.shape[1], k.shape[2]
    if D not in (32, 64, 128) or H % Hkv:
        raise ValueError(f"the decode kernel takes head_dim 32/64/128 and H % Hkv == 0, "
                         f"got D={D}, H={H}, Hkv={Hkv}")
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape:
        raise ValueError("K/V must be [B, Hkv, S, D]")
    scale = (D**-0.5) if scale is None else float(scale)
    q2 = q.to(torch.float32).contiguous()
    le = _lengths_1d(lengths, B, q.device).contiguous()
    kernels.check_cuda(q2, k, v, le,
                       dtypes=(torch.float32, torch.float32, torch.float32, torch.int32))
    out = torch.empty_like(q2)
    kernels.launch(
        "flash_decode",
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), le.data_ptr(), out.data_ptr(),
        B, H, Hkv, S, D, scale,
    )
    return out.to(q.dtype)


def flash_decode_int8_ref(q: torch.Tensor, kv: QuantKV, lengths,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: unblocked, with quantized_sdpa's factorization.
    q [B, H, 1, D]; payloads [B, Hkv, S, D]; scales [B, Hkv, S]."""
    B, H, _, D = q.shape
    scale = (D**-0.5) if scale is None else scale
    k_q, v_q, k_s, v_s = kv
    if k_q.shape[-3] != H:
        rep = H // k_q.shape[-3]
        k_q = torch.repeat_interleave(k_q, rep, dim=-3)
        v_q = torch.repeat_interleave(v_q, rep, dim=-3)
        k_s = torch.repeat_interleave(k_s, rep, dim=-2)
        v_s = torch.repeat_interleave(v_s, rep, dim=-2)
    logits = torch.matmul(q.to(torch.float32), k_q.to(torch.float32).transpose(-1, -2)) * (
        k_s[:, :, None, :] * scale
    )
    le = _lengths_1d(lengths, B, q.device)
    mask = torch.arange(k_q.shape[-2], device=q.device)[None, :] < le[:, None]  # [B, S]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w * v_s[:, :, None, :], v_q.to(torch.float32)).to(q.dtype)


def flash_decode_int8(q: torch.Tensor, kv: QuantKV, lengths,
                      scale: Optional[float] = None) -> torch.Tensor:
    """softmax((q k^T) * scale masked to col < lengths[b]) v over int8 K/V,
    one query per row.  Returns [B, H, 1, D].  lengths: int32 [B] or a
    scalar, each >= 1."""
    B, H, T, D = q.shape
    if T != 1:
        raise ValueError("flash_decode_int8 is the single-query decode kernel")
    if not kernels.plain_or_kernel(q):
        return flash_decode_int8_ref(q, kv, lengths, scale)
    Hkv, S = kv.k_q.shape[1], kv.k_q.shape[2]
    if D not in (32, 64, 128) or H % Hkv:
        raise ValueError(f"the decode kernel takes head_dim 32/64/128 and H % Hkv == 0, "
                         f"got D={D}, H={H}, Hkv={Hkv}")
    if kv.k_q.shape != (B, Hkv, S, D) or kv.v_q.shape != kv.k_q.shape:
        raise ValueError("int8 payloads must be [B, Hkv, S, D]")
    if kv.k_scale.shape != (B, Hkv, S) or kv.v_scale.shape != (B, Hkv, S):
        raise ValueError("scales must be [B, Hkv, S]")
    scale = (D**-0.5) if scale is None else float(scale)
    q2 = q.to(torch.float32).contiguous()
    le = _lengths_1d(lengths, B, q.device).contiguous()
    kernels.check_cuda(
        q2, kv.k_q, kv.v_q, kv.k_scale, kv.v_scale, le,
        dtypes=(torch.float32, torch.int8, torch.int8, torch.float32, torch.float32,
                torch.int32),
    )
    out = torch.empty_like(q2)
    kernels.launch(
        "flash_decode_int8",
        q2.data_ptr(), kv.k_q.data_ptr(), kv.v_q.data_ptr(), kv.k_scale.data_ptr(),
        kv.v_scale.data_ptr(), le.data_ptr(), out.data_ptr(), B, H, Hkv, S, D, scale,
    )
    return out.to(q.dtype)
