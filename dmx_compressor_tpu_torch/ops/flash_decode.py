"""Single-query attention over a float KV cache (kernel B4) and an int8 one
(kernel B2).

Port of ``flash_decode_ref``, ``flash_decode``, ``flash_decode_int8_ref``,
``flash_decode_int8``, ``post_update_lengths``, ``cached_attend`` and
``_split_cache_attend`` of ``dmx_compressor_tpu/ops/flash_decode.py``.  The CUDA kernels
(``csrc/flash_decode.cu``, ``csrc/flash_decode_int8.cu``) split the keys
below each row's length into chunks, one CUDA block each, and merge the
chunks' softmax states in chunk order (``csrc/decode_split.cuh``); the int8
one dequantizes with the per-position scales after the dot products
(``quantized_sdpa``'s factorization).  ``flash_decode_split_ref`` and
``flash_decode_int8_split_ref`` transcribe that arithmetic for the tests.
``flash_decode`` and ``flash_decode_int8`` launch their kernel for CUDA
tensors and run the plain version for CPU tensors.  The port has no routing floor: every transparent
plain-causal T == 1 decode step goes through one of them (the JAX package's
``flash_decode_viable`` is a TPU floor; OPT's attention routes itself,
``cached_attend`` routes the other families).  The JAX package's
``s_minor`` variants are a TPU layout; the port's caches are D-minor.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .flash_attention import attention_route, b2_group
from .kv_cache import QuantKV

NEG_INF = -1e30

# B2's split of S: keys per CUDA block, the CHUNK of csrc/flash_decode_int8.cu
B2_CHUNK = 256
# B4's: the CHUNK of csrc/flash_decode.cu
B4_CHUNK = 1024
# B2 and B4 are built for head_dim 32, 64, 128 and 256 (the HEAD_DIMS of
# ops/flash_attention.py); any other multiple of 8 up to 256 runs the next
# of them with its D taken at run time (the padded dims read as zeros); any
# other D takes the generic route of csrc/decode_split.cuh, whose blocks
# serve GENERIC_HEADS query heads of a KV head over GENERIC_CHUNK keys (its
# GEN_HEADS and GEN_CHUNK)
GENERIC_CHUNK = 256
GENERIC_HEADS = 8
# the K/V dtypes B4 reads as stored, by their code in csrc/flash_decode.cu
B4_KV_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# per device: the merge tickets of B2 and B4, int32, zero between launches
# (the merging block resets its own); launches that share them run on one
# stream
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
    q [B, H, 1, D]; K/V [B, Hkv, S, D].  Keys and values at col >= lengths[b]
    take no part, whatever they hold (the kernel does not read them)."""
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
    vf = v.to(torch.float32).masked_fill(~mask[:, None, :, None], 0.0)
    return torch.matmul(w, vf).to(q.dtype)


def _merge_chunks(m, l, acc, D: int) -> torch.Tensor:
    """The chunks' softmax states (m, l [B, H, n]; acc [B, H, n, D]) merged
    in chunk order, as csrc/decode_split.cuh does: sum_c acc_c w_c / sum_c
    l_c w_c with w_c = exp(m_c - max_c m_c), 0 for a chunk past the
    length.  Returns [B, H, 1, D]."""
    B, H, n = m.shape
    live = torch.isfinite(m)
    w = torch.where(live, torch.exp(m - torch.amax(m, dim=-1, keepdim=True)), 0.0)
    gl = torch.zeros(B, H, device=m.device)
    o = torch.zeros(B, H, D, device=m.device)
    for c in range(n):  # chunk order
        gl = gl + l[:, :, c] * w[:, :, c]
        o = o + acc[:, :, c] * w[:, :, c, None]
    return (o / torch.clamp(gl, min=1e-30)[..., None])[:, :, None]


def _chunk_probs(logits: torch.Tensor, lengths: torch.Tensor, chunk: int):
    """Logits [B, H, S] cut into chunks of ``chunk`` keys, masked to each
    row's length: (p [B, H, n, chunk] = exp(logit - m), m [B, H, n] the
    chunk's max logit (-inf past the length), l = sum p, the padding of S
    to n * chunk)."""
    B, H, S = logits.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    valid = torch.arange(n * chunk, device=logits.device)[None, :] < lengths[:, None]
    lg = torch.nn.functional.pad(logits, (0, pad)).reshape(B, H, n, chunk)
    lg = lg.masked_fill(~valid.reshape(B, 1, n, chunk), -torch.inf)
    m = torch.amax(lg, dim=-1)
    p = torch.exp(lg - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    return p, m, p.sum(-1), pad


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain transcription of B4's arithmetic, for tests: the keys below
    each row's length cut into chunks of ``B4_CHUNK``; per chunk and query
    head m = max logit, p = exp(logit - m), l = sum p, acc = sum p v; then
    the chunks merged in chunk order (:func:`_merge_chunks`).  Shapes as
    :func:`flash_decode_ref`."""
    B, H, _, D = q.shape
    scale = (D**-0.5) if scale is None else scale
    if k.shape[-3] != H:
        rep = H // k.shape[-3]
        k = torch.repeat_interleave(k, rep, dim=-3)
        v = torch.repeat_interleave(v, rep, dim=-3)
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))[:, :, 0]
    p, m, l, pad = _chunk_probs(logits * scale, _lengths_1d(lengths, B, q.device), B4_CHUNK)
    n = p.shape[2]
    vf = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, pad)).reshape(B, H, n, -1, D)
    acc = torch.matmul(p[..., None, :], vf)[..., 0, :]  # [B, H, n, D]
    return _merge_chunks(m, l, acc, D).to(q.dtype)


def _decode_grid(route: Optional[str], H: int, Hkv: int, S: int, D: int, chunk: int):
    """(chunks a row, tickets a batch row) of a decode launch: the main and
    grouped routes split S by ``chunk``, the generic route by GENERIC_CHUNK
    and its query heads into groups of GENERIC_HEADS; the grouped route
    (B2) into groups of at most ``b2_group(D)``."""
    rep = H // Hkv
    if route == "generic":
        return -(-S // GENERIC_CHUNK), Hkv * -(-rep // GENERIC_HEADS)
    if route == "grouped":
        return -(-S // chunk), Hkv * -(-rep // b2_group(D))
    return -(-S // chunk), Hkv


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths,
                 scale: Optional[float] = None) -> torch.Tensor:
    """softmax((q k^T) * scale masked to col < lengths[b]) v over K/V [B,
    Hkv, S, D], one query per row.  Returns [B, H, 1, D] in q's dtype.
    lengths: int32 [B] or a scalar, each >= 1.  On the card a float32,
    float16 or bfloat16 cache is read as stored (K and V of one dtype; any
    other K/V are widened to f32 first, as the plain version computes), q
    in f32; any head_dim (:func:`attention_route`)."""
    B, H, T, D = q.shape
    if T != 1:
        raise ValueError("flash_decode is the single-query decode kernel")
    if not kernels.plain_or_kernel(q):
        return flash_decode_ref(q, k, v, lengths, scale)
    Hkv, S = k.shape[1], k.shape[2]
    route = attention_route("flash_decode", H, Hkv, D, (q.dtype, k.dtype, v.dtype))
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape:
        raise ValueError("K/V must be [B, Hkv, S, D]")
    if k.dtype != v.dtype or k.dtype not in B4_KV_DTYPES:
        k, v = k.to(torch.float32), v.to(torch.float32)  # no cache stores these
    k, v = k.contiguous(), v.contiguous()
    scale = (D**-0.5) if scale is None else float(scale)
    q2 = q.to(torch.float32).contiguous()
    le = _lengths_1d(lengths, B, q.device).contiguous()
    kernels.check_cuda(q2, le, dtypes=(torch.float32, torch.int32))
    # the main kernel reads a lane's 16 dims with 16-byte loads, the generic
    # route element by element
    kernels.check_cuda(k, v, dtypes=(k.dtype, k.dtype),
                       align=k.element_size() if route == "generic" else 16)
    out = torch.empty_like(q2)
    n, tickets = _decode_grid(route, H, Hkv, S, D, B4_CHUNK)
    _part, acc, ml, tk = _partials(q.device, B, H, n, D, B * tickets)
    kernels.launch(
        "flash_decode",
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), le.data_ptr(), out.data_ptr(), acc, ml, tk,
        B, H, Hkv, S, D, scale, B4_KV_DTYPES[k.dtype], route=route,
    )
    return out.to(q.dtype)


def flash_decode_int8_ref(q: torch.Tensor, kv: QuantKV, lengths,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: unblocked, with quantized_sdpa's factorization.
    q [B, H, 1, D]; payloads [B, Hkv, S, D]; scales [B, Hkv, S].  Positions
    at col >= lengths[b] take no part, whatever they hold (the kernel does
    not read them)."""
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
    v_s = v_s.masked_fill(~mask[:, None, :], 0.0)
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
    p, m, l, pad = _chunk_probs(logits, _lengths_1d(lengths, B, q.device), chunk)
    n = p.shape[2]
    pv = p * torch.nn.functional.pad(v_s, (0, pad)).reshape(B, H, n, chunk)
    vqf = torch.nn.functional.pad(v_q.to(torch.float32), (0, 0, 0, pad)).reshape(B, H, n, chunk, D)
    acc = torch.matmul(pv[..., None, :], vqf)[..., 0, :]  # [B, H, n, D]
    return _merge_chunks(m, l, acc, D).to(q.dtype)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _partials(device, B: int, H: int, n: int, D: int, tickets: int):
    """The split kernels' scratch: (the buffer, which the caller keeps until
    the launch, then pointers to the chunks' acc [B, H, n, D] and (m, l)
    [B, H, n, 2] in it and to ``tickets`` tickets); all None where one chunk
    covers a row (each block finishes its row)."""
    if n <= 1:
        return None, None, None, None
    part = torch.empty(B * H * n * (D + 2), dtype=torch.float32, device=device)
    acc = part.data_ptr()
    return part, acc, acc + B * H * n * D * 4, _tickets(device, tickets).data_ptr()


def flash_decode_int8(q: torch.Tensor, kv: QuantKV, lengths,
                      scale: Optional[float] = None) -> torch.Tensor:
    """softmax((q k^T) * scale masked to col < lengths[b]) v over int8 K/V,
    one query per row.  Returns [B, H, 1, D] in q's dtype.  lengths: int32
    [B] or a scalar, each >= 1.  On the card any head_dim and any number of
    query heads a KV head (:func:`attention_route`)."""
    B, H, T, D = q.shape
    if T != 1:
        raise ValueError("flash_decode_int8 is the single-query decode kernel")
    if not kernels.plain_or_kernel(q):
        return flash_decode_int8_ref(q, kv, lengths, scale)
    Hkv, S = kv.k_q.shape[1], kv.k_q.shape[2]
    route = attention_route("flash_decode_int8", H, Hkv, D)
    if kv.k_q.shape != (B, Hkv, S, D) or kv.v_q.shape != kv.k_q.shape:
        raise ValueError("int8 payloads must be [B, Hkv, S, D]")
    if kv.k_scale.shape != (B, Hkv, S) or kv.v_scale.shape != (B, Hkv, S):
        raise ValueError("scales must be [B, Hkv, S]")
    scale = (D**-0.5) if scale is None else float(scale)
    q2 = q.to(torch.float32).contiguous()
    le = _lengths_1d(lengths, B, q.device).contiguous()
    kernels.check_cuda(
        q2, kv.k_scale, kv.v_scale, le,
        dtypes=(torch.float32, torch.float32, torch.float32, torch.int32),
    )
    # the main kernel stages rows with 8- and 16-byte copies, the generic
    # route reads them byte by byte
    kernels.check_cuda(kv.k_q, kv.v_q, dtypes=(torch.int8, torch.int8),
                       align=1 if route == "generic" else 16)
    out = torch.empty_like(q2)
    n, tickets = _decode_grid(route, H, Hkv, S, D, B2_CHUNK)
    _part, acc, ml, tk = _partials(q.device, B, H, n, D, B * tickets)
    kernels.launch(
        "flash_decode_int8",
        q2.data_ptr(), kv.k_q.data_ptr(), kv.v_q.data_ptr(), kv.k_scale.data_ptr(),
        kv.v_scale.data_ptr(), le.data_ptr(), out.data_ptr(), acc, ml, tk, B, H, Hkv, S, D,
        scale, route=route,
    )
    return out.to(q.dtype)


def cached_attend(sdpa, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache, attn_mask,
                  *, scale: Optional[float] = None, enable_gqa: bool = False,
                  plain_causal: bool = True, transparent: Optional[bool] = None
                  ) -> torch.Tensor:
    """The cached-attention tail shared by the decoder families other than
    OPT: q [B, H, T, D] (RoPE applied), the fresh k / v [B, Hkv, T, D].

    - a quantized cache under an sdpa with casts is dequantized and goes
      through the module's cast / surrogate pipeline (the fused BASIC decode
      where the shapes match): int8 changes the storage, never the cast
      points;
    - a transparent T == 1 step with the plain causal mask runs B2 (int8
      cache) or B4 (float cache) on the card, their plain versions on the
      CPU; query head h reads KV head h // rep, no repeat;
    - a transparent int8 step otherwise runs ``quantized_sdpa``;
    - a split cache takes :func:`_split_cache_attend`.

    ``transparent`` is the frozen ``sdpa_transparent(sdpa)`` (None: asked
    here)."""
    from .basic_attention import basic_sdpa_decode, basic_sdpa_shape
    from .flash_attention import sdpa_transparent
    from .kv_cache import quantized_sdpa

    T, D = q.shape[-2], q.shape[-1]
    scale_v = (D**-0.5) if scale is None else float(scale)
    if transparent is None:
        transparent = sdpa_transparent(sdpa)
    if cache is not None and getattr(cache, "split", False):
        return _split_cache_attend(sdpa, q, k, v, cache, attn_mask, scale_v, transparent,
                                   enable_gqa=enable_gqa)
    if cache is not None and cache.quantized and transparent:
        kv = cache.update_quantized(k, v)
        if T == 1 and plain_causal and attn_mask is not None:
            return flash_decode_int8(q, kv, post_update_lengths(cache), scale=scale_v)
        return quantized_sdpa(q, kv, attn_mask=attn_mask, scale=scale, enable_gqa=enable_gqa)
    if cache is not None:
        k, v, _ = cache.update(k, v)  # an int8 cache dequantizes here
    if transparent and cache is not None and T == 1 and plain_causal and attn_mask is not None:
        return flash_decode(q, k, v, post_update_lengths(cache), scale=scale_v)
    if (not transparent and cache is not None and T == 1 and attn_mask is not None
            and attn_mask.is_floating_point()):
        # query heads grouped per KV head inside, no repeat
        p = basic_sdpa_shape(sdpa, D, k.shape[-2])
        if p is not None:
            return basic_sdpa_decode(q, k, v, attn_mask, scale=scale_v, params=p)
    # a float16 cache in q's dtype (the JAX package's matmuls promote it)
    return sdpa(q, k.to(q.dtype), v.to(q.dtype), attn_mask=attn_mask, scale=scale,
                enable_gqa=enable_gqa)


def _split_cache_attend(sdpa, q, k, v, cache, attn_mask, scale: float, transparent: bool,
                        *, enable_gqa: bool = False) -> torch.Tensor:
    """Attention over a SplitKVCache for any decoder family: a T > 1 call is
    a fresh prefill from position 0 and writes the base (B3 over the fresh
    K/V when transparent, the heads repeated; else the masked sdpa); a
    T == 1 step appends to the tail and runs the fused BASIC split decode
    over the base's precomputed casts where the shapes match; else the
    modular sdpa over the concatenated segments."""
    from .basic_attention import basic_sdpa_decode_split, basic_sdpa_shape
    from .flash_attention import flash_attention

    T = q.shape[-2]
    if T > 1:
        cache.write_base(k, v)
        if transparent:
            return flash_attention(q, k, v, causal=True, scale=scale)
        m = attn_mask[..., :k.shape[-2]] if attn_mask is not None else None
        return sdpa(q, k, v, attn_mask=m, scale=scale, enable_gqa=enable_gqa)
    if attn_mask is not None:
        p = basic_sdpa_shape(sdpa, q.shape[-1], cache.tail_len)
        if p is not None and cache.base_len % p.block == 0:
            bk, bv, tk, tv = cache.append_tail(k, v)
            precast = cache.base_cast_key == (p.wl, p.block)
            return basic_sdpa_decode_split(
                q, bk, bv, tk, tv, attn_mask, scale=scale, params=p,
                base_k_cast=cache.base_k_cast if precast else None,
                base_v_cast=cache.base_v_cast if precast else None,
            )
    kf, vf, _ = cache.update(k, v)
    return sdpa(q, kf.to(q.dtype), vf.to(q.dtype), attn_mask=attn_mask, scale=scale,
                enable_gqa=enable_gqa)
