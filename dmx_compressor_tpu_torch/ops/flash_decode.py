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

# B2's split of S: keys per CUDA block, the CHUNK of csrc/flash_decode_int8.cu
B2_CHUNK = 256
# per device: B2's merge tickets, int32, zero between launches (the merging
# block resets its own); launches that share them run on one stream
_TICKETS = {}


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


def flash_decode_int8_split_ref(q: torch.Tensor, kv: QuantKV, lengths,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Plain transcription of B2's arithmetic, for tests: the keys below
    each row's length cut into chunks of ``B2_CHUNK``;
    per chunk and query head m = max logit, p = exp(logit - m), l = sum p,
    acc = sum (p * v_scale) v_q; then the chunks merged in chunk order:
    out = sum_c acc_c w_c / sum_c l_c w_c with w_c = exp(m_c - max_c m_c).
    Shapes as :func:`flash_decode_int8_ref`."""
    B, H, _, D = q.shape
    chunk = B2_CHUNK
    scale = (D**-0.5) if scale is None else scale
    k_q, v_q, k_s, v_s = kv
    S = k_q.shape[-2]
    if k_q.shape[-3] != H:
        rep = H // k_q.shape[-3]
        k_q = torch.repeat_interleave(k_q, rep, dim=-3)
        v_q = torch.repeat_interleave(v_q, rep, dim=-3)
        k_s = torch.repeat_interleave(k_s, rep, dim=-2)
        v_s = torch.repeat_interleave(v_s, rep, dim=-2)
    logits = torch.matmul(q.to(torch.float32), k_q.to(torch.float32).transpose(-1, -2))[:, :, 0]
    logits = logits * (k_s * scale)  # [B, H, S]
    le = _lengths_1d(lengths, B, q.device)
    n = -(-S // chunk)
    pad = n * chunk - S
    valid = torch.arange(n * chunk, device=q.device)[None, :] < le[:, None]  # [B, n * chunk]
    lg = torch.nn.functional.pad(logits, (0, pad)).reshape(B, H, n, chunk)
    lg = lg.masked_fill(~valid.reshape(B, 1, n, chunk), -torch.inf)
    m = torch.amax(lg, dim=-1)  # [B, H, n]; -inf for a chunk past the length
    live = torch.isfinite(m)
    p = torch.exp(lg - torch.where(live, m, 0.0)[..., None])
    l = p.sum(-1)
    pv = p * torch.nn.functional.pad(v_s, (0, pad)).reshape(B, H, n, chunk)
    vqf = torch.nn.functional.pad(v_q.to(torch.float32), (0, 0, 0, pad)).reshape(B, H, n, chunk, D)
    acc = torch.matmul(pv[..., None, :], vqf)[..., 0, :]  # [B, H, n, D]
    gm = torch.amax(m, dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - gm), 0.0)
    gl = torch.zeros(B, H, device=q.device)
    o = torch.zeros(B, H, D, device=q.device)
    for c in range(n):  # chunk order
        gl = gl + l[:, :, c] * w[:, :, c]
        o = o + acc[:, :, c] * w[:, :, c, None]
    return (o / torch.clamp(gl, min=1e-30)[..., None])[:, :, None].to(q.dtype)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


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
    if D not in (32, 64, 128) or H % Hkv or H // Hkv > 32:
        raise ValueError(f"the decode kernel takes head_dim 32/64/128 and H % Hkv == 0 with at "
                         f"most 32 query heads a KV head, got D={D}, H={H}, Hkv={Hkv}")
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
    n = -(-S // B2_CHUNK)
    acc = ml = tk = None  # one chunk a row: each block finishes its row
    if n > 1:
        # the chunks' (acc [B, H, n, D], then (m, l) [B, H, n, 2]) in one buffer
        part = torch.empty(B * H * n * (D + 2), dtype=torch.float32, device=q.device)
        acc, ml = part.data_ptr(), part.data_ptr() + B * H * n * D * 4
        tk = _tickets(q.device, B * Hkv).data_ptr()
    kernels.launch(
        "flash_decode_int8",
        q2.data_ptr(), kv.k_q.data_ptr(), kv.v_q.data_ptr(), kv.k_scale.data_ptr(),
        kv.v_scale.data_ptr(), le.data_ptr(), out.data_ptr(), acc, ml, tk, B, H, Hkv, S, D,
        scale,
    )
    return out.to(q.dtype)
