"""KV caches: full-precision and int8 static-capacity buffers.

Port of ``KVCache``, ``QuantizedKVCache``, ``SplitKVCache`` (its D-minor
form), ``RowKVCache``, ``RowQuantizedKVCache``, ``QuantKV``,
``quantized_sdpa``, ``make_caches`` and ``cache_seq_len`` of
``dmx_compressor_tpu/ops/kv_cache.py``.

Layout: the port keeps caches D-minor, ``[B, H, S, D]`` (the JAX package
stores them ``[B, H, D, S]``, a TPU lane-tiling choice).  A key row of D int8
values is then contiguous, which the decode kernel reads with 16-byte loads.
The int8 cache quantizes symmetrically over the head dim with one f32 scale
per (batch, head, position): ``scale = max(amax / 127, 1e-10)``,
``q = clip(round(x / scale), -127, 127)``.

The caches are updated in place (the JAX package returns new arrays).  In
the static caches ``length`` is a host integer, and ``lengths`` is the same
fill point as an int32 device tensor [B] for the decode kernel; a write past
the capacity raises.  The row caches of the serving engine keep one fill
point per row in ``lengths`` alone, on the device, and write there by
scatter, so that a decode step never reads it back; a row past its capacity
(an idle slot that keeps decoding) writes its last window and its fill point
keeps growing, as the JAX package's ``dynamic_update_slice`` does.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..kernels import resolve_device


class QuantKV(NamedTuple):
    """Int8 KV payloads [B, H, S, D] + per-(batch, head, position) scales [B, H, S]."""

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


def quantized_sdpa(q: torch.Tensor, kv: QuantKV, attn_mask=None, scale=None,
                   out_dtype=None, enable_gqa: bool = False) -> torch.Tensor:
    """Attention over int8 K/V, scales applied after the matmuls:
    logits = (q @ k_q^T) * k_scale * scale; out = (probs * v_scale) @ v_q."""
    out_dtype = out_dtype or q.dtype
    D = q.shape[-1]
    scale = (D**-0.5) if scale is None else scale
    if enable_gqa and q.shape[-3] != kv.k_q.shape[-3]:
        rep = q.shape[-3] // kv.k_q.shape[-3]
        kv = QuantKV(
            torch.repeat_interleave(kv.k_q, rep, dim=-3),
            torch.repeat_interleave(kv.v_q, rep, dim=-3),
            torch.repeat_interleave(kv.k_scale, rep, dim=-2),
            torch.repeat_interleave(kv.v_scale, rep, dim=-2),
        )
    logits = torch.matmul(q.to(torch.float32), kv.k_q.to(torch.float32).transpose(-1, -2)) * (
        kv.k_scale[..., None, :] * scale
    )
    if attn_mask is not None:
        logits = logits + attn_mask.to(torch.float32)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w * kv.v_scale[..., None, :], kv.v_q.to(torch.float32))
    return out.to(out_dtype)


def cache_seq_len(cache) -> int:
    """Sequence capacity of a cache."""
    return cache.max_len


class _StaticCache:
    """Capacity, fill point and the per-row lengths shared by both caches."""

    def __init__(self, batch: int, max_len: int, head_dim: int, device: torch.device):
        self.max_len = max_len
        self.head_dim = head_dim
        self.length = 0
        self.lengths = torch.zeros((batch,), dtype=torch.int32, device=device)

    @property
    def seq_len(self) -> int:
        return self.max_len

    def _advance(self, T: int) -> int:
        pos = self.length
        if pos + T > self.max_len:
            raise ValueError(f"cache overflow: {pos} + {T} > {self.max_len}")
        self.length = pos + T
        self.lengths.fill_(self.length)
        return pos


class KVCache(_StaticCache):
    """Full-precision static cache, [B, H, S_max, D]."""

    quantized = False

    def __init__(self, batch: int, heads: int, max_len: int, head_dim: int,
                 dtype=torch.float32, device=None):
        device = resolve_device(device)
        super().__init__(batch, max_len, head_dim, device)
        self.k = torch.zeros((batch, heads, max_len, head_dim), dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Append [B, H, T, D] at the fill point; returns the full buffers
        and the new length."""
        pos = self._advance(k_new.shape[2])
        self.k[:, :, pos:self.length] = k_new.to(self.k.dtype)
        self.v[:, :, pos:self.length] = v_new.to(self.v.dtype)
        return self.k, self.v, self.length


class QuantizedKVCache(_StaticCache):
    """INT8 KV cache with per-(batch, head, position) scales."""

    quantized = True

    def __init__(self, batch: int, heads: int, max_len: int, head_dim: int,
                 dtype=torch.float32, device=None):
        device = resolve_device(device)
        super().__init__(batch, max_len, head_dim, device)
        self.out_dtype = dtype
        self.k_q = torch.zeros((batch, heads, max_len, head_dim), dtype=torch.int8, device=device)
        self.v_q = torch.zeros_like(self.k_q)
        self.k_scale = torch.zeros((batch, heads, max_len), dtype=torch.float32, device=device)
        self.v_scale = torch.zeros_like(self.k_scale)

    @staticmethod
    def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        amax = torch.amax(torch.abs(x), dim=-1)
        scale = torch.clamp(amax / 127.0, min=1e-10)
        q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
        return q, scale.to(torch.float32)

    def update_payload(self, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        kq, ks = self._quantize(k_new.to(torch.float32))
        vq, vs = self._quantize(v_new.to(torch.float32))
        pos = self._advance(k_new.shape[2])
        end = self.length
        self.k_q[:, :, pos:end] = kq
        self.v_q[:, :, pos:end] = vq
        self.k_scale[:, :, pos:end] = ks
        self.v_scale[:, :, pos:end] = vs

    def update_quantized(self, k_new: torch.Tensor, v_new: torch.Tensor) -> QuantKV:
        """Append and return the int8 payloads and scales (no dequantization)."""
        self.update_payload(k_new, v_new)
        return QuantKV(self.k_q, self.v_q, self.k_scale, self.v_scale)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Append and return dequantized full buffers and the new length."""
        self.update_payload(k_new, v_new)
        k = (self.k_q.to(torch.float32) * self.k_scale[..., None]).to(self.out_dtype)
        v = (self.v_q.to(torch.float32) * self.v_scale[..., None]).to(self.out_dtype)
        return k, v, self.length


class SplitKVCache(_StaticCache):
    """Prefill/decode split cache: a base segment written once at prefill
    (then read-only while decoding) and a small tail that decode steps
    append to, [B, H, S, D] each.

    The BASIC decode attention (ops/basic_attention.py) reads the segments
    without concatenating them, and ``prepare_split_decode`` installs the
    base segment's BFP casts once (``set_base_cast``), so a decode step
    casts only the tail.  ``base_len`` and ``tail_len`` are multiples of
    the BASIC BFP block (64) so that sequence-blocked casts never straddle
    the boundary.  Decoding beyond the tail is not supported:
    :meth:`merge_tail` raises, as the JAX package's does.  The JAX
    package's ``s_minor`` layout (a TPU layout A/B) is not ported."""

    quantized = False
    split = True

    def __init__(self, batch: int, heads: int, base_len: int, tail_len: int, head_dim: int,
                 dtype=torch.float32, device=None):
        device = resolve_device(device)
        super().__init__(batch, base_len + tail_len, head_dim, device)
        self.base_len = base_len
        self.tail_len = tail_len
        self.base_k = torch.zeros((batch, heads, base_len, head_dim), dtype=dtype, device=device)
        self.base_v = torch.zeros_like(self.base_k)
        self.tail_k = torch.zeros((batch, heads, tail_len, head_dim), dtype=dtype, device=device)
        self.tail_v = torch.zeros_like(self.tail_k)
        # the base segment's BFP casts, installed by set_base_cast; the JAX
        # package keeps them in bf16, which holds the <= 8-bit cast values
        # exactly: the port keeps the same values in f32, ready for the f32
        # matmuls of the decode attention
        self.base_k_cast = None
        self.base_v_cast = None
        self.base_cast_key = None

    def set_base_cast(self, k_cast: torch.Tensor, v_cast: torch.Tensor, key) -> None:
        """Install precomputed base casts ([B, H, S0, D]) made with ``key``
        = (wl, block)."""
        self.base_k_cast = k_cast.to(torch.float32)
        self.base_v_cast = v_cast.to(torch.float32)
        self.base_cast_key = key

    def write_base(self, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Prefill: write [B, H, T, D] at the fill point of the base."""
        T = k_new.shape[2]
        if self.length + T > self.base_len:
            raise ValueError(f"base overflow: {self.length} + {T} > {self.base_len}")
        pos = self._advance(T)
        self.base_k[:, :, pos:self.length] = k_new.to(self.base_k.dtype)
        self.base_v[:, :, pos:self.length] = v_new.to(self.base_v.dtype)

    def append_tail(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Decode: append [B, H, T, D] into the tail; returns the four
        segment buffers (base_k, base_v, tail_k, tail_v)."""
        if self.length < self.base_len:
            raise ValueError("the tail is written after the base is full")
        pos = self._advance(k_new.shape[2]) - self.base_len
        end = self.length - self.base_len
        self.tail_k[:, :, pos:end] = k_new.to(self.tail_k.dtype)
        self.tail_v[:, :, pos:end] = v_new.to(self.tail_v.dtype)
        return self.base_k, self.base_v, self.tail_k, self.tail_v

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """KVCache-compatible: a T > 1 step writes the base, a T == 1 step
        the tail; returns the concatenated buffers and the new length."""
        if k_new.shape[2] > 1:
            self.write_base(k_new, v_new)
        else:
            self.append_tail(k_new, v_new)
        k = torch.cat([self.base_k, self.tail_k], dim=2)
        v = torch.cat([self.base_v, self.tail_v], dim=2)
        return k, v, self.length

    def merge_tail(self) -> None:
        """Fold the filled tail into the base, between decode windows: the
        base holds the prefill's fixed capacity, so this cannot grow it, and
        raises (callers size the tail for the whole generation)."""
        raise NotImplementedError("decode beyond tail_len: allocate a larger tail or re-prefill")


class _RowCache:
    """Capacity and the per-row fill points [B] (int32, on the device) of
    the row caches."""

    quantized = False
    row = True

    def __init__(self, batch: int, max_len: int, head_dim: int, device: torch.device):
        self.max_len = max_len
        self.head_dim = head_dim
        self.lengths = torch.zeros((batch,), dtype=torch.int32, device=device)

    @property
    def seq_len(self) -> int:
        return self.max_len

    @property
    def length(self) -> torch.Tensor:
        """The largest fill point, a device scalar (per-row readers use
        ``lengths``)."""
        return torch.amax(self.lengths)

    def _positions(self, T: int) -> torch.Tensor:
        """Where each row's T new entries go, int64 [B, T]: at its fill point,
        clamped to the last window (``dynamic_update_slice``'s start clamp)."""
        start = torch.clamp(self.lengths, max=self.max_len - T).to(torch.int64)
        return start[:, None] + torch.arange(T, device=start.device)

    def _set_length(self, b: int, length) -> None:
        self.lengths[b:b + 1].fill_(length)


def _scatter_rows(buf: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """buf [B, H, S(, D)] at each row's positions pos [B, T] <- new [B, H, T(, D)]."""
    idx = pos[:, None, :, None] if buf.ndim == 4 else pos[:, None, :]
    buf.scatter_(2, idx.expand(new.shape), new.to(buf.dtype))


class RowKVCache(_RowCache):
    """Continuous-batching cache, [B, H, S_max, D]: every row has its own
    fill point (``lengths``), so one decode step serves slots at different
    sequence positions.  The engine installs a prefilled batch-1 cache row
    with :meth:`write_row`."""

    def __init__(self, batch: int, heads: int, max_len: int, head_dim: int,
                 dtype=torch.float32, device=None):
        device = resolve_device(device)
        super().__init__(batch, max_len, head_dim, device)
        self.k = torch.zeros((batch, heads, max_len, head_dim), dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Append [B, H, T, D] at each row's fill point (a row past the
        capacity writes its last window; its outputs are garbage by
        construction); returns the full buffers and the new lengths."""
        pos = self._positions(k_new.shape[2])
        _scatter_rows(self.k, pos, k_new)
        _scatter_rows(self.v, pos, v_new)
        self.lengths += k_new.shape[2]
        return self.k, self.v, self.lengths

    def write_row(self, b: int, k_row: torch.Tensor, v_row: torch.Tensor,
                  length=None) -> None:
        """Install a prefilled row: ``k_row`` / ``v_row`` [H, T, D] from a
        batch-1 cache.  ``length`` resets the row's fill point (default T);
        bucket padding beyond it is masked, and later appends overwrite it."""
        T = k_row.shape[1]
        self.k[b, :, :T] = k_row.to(self.k.dtype)
        self.v[b, :, :T] = v_row.to(self.v.dtype)
        self._set_length(b, T if length is None else length)


class RowQuantizedKVCache(_RowCache):
    """INT8 continuous-batching cache: :class:`QuantizedKVCache` payloads
    and scales with :class:`RowKVCache` per-row fill points."""

    quantized = True

    def __init__(self, batch: int, heads: int, max_len: int, head_dim: int,
                 dtype=torch.float32, device=None):
        device = resolve_device(device)
        super().__init__(batch, max_len, head_dim, device)
        self.out_dtype = dtype
        self.k_q = torch.zeros((batch, heads, max_len, head_dim), dtype=torch.int8, device=device)
        self.v_q = torch.zeros_like(self.k_q)
        self.k_scale = torch.zeros((batch, heads, max_len), dtype=torch.float32, device=device)
        self.v_scale = torch.zeros_like(self.k_scale)

    def update_payload(self, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        kq, ks = QuantizedKVCache._quantize(k_new.to(torch.float32))
        vq, vs = QuantizedKVCache._quantize(v_new.to(torch.float32))
        pos = self._positions(k_new.shape[2])
        _scatter_rows(self.k_q, pos, kq)
        _scatter_rows(self.v_q, pos, vq)
        _scatter_rows(self.k_scale, pos, ks)
        _scatter_rows(self.v_scale, pos, vs)
        self.lengths += k_new.shape[2]

    def update_quantized(self, k_new: torch.Tensor, v_new: torch.Tensor) -> QuantKV:
        """Append and return the int8 payloads and scales (no dequantization)."""
        self.update_payload(k_new, v_new)
        return QuantKV(self.k_q, self.v_q, self.k_scale, self.v_scale)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Append and return dequantized full buffers and the new lengths."""
        self.update_payload(k_new, v_new)
        k = (self.k_q.to(torch.float32) * self.k_scale[..., None]).to(self.out_dtype)
        v = (self.v_q.to(torch.float32) * self.v_scale[..., None]).to(self.out_dtype)
        return k, v, self.lengths

    def write_row(self, b: int, k_q_row: torch.Tensor, v_q_row: torch.Tensor,
                  k_scale_row: torch.Tensor, v_scale_row: torch.Tensor, length=None) -> None:
        """Install a prefilled row's int8 payloads [H, T, D] and scales
        [H, T], from a batch-1 :class:`QuantizedKVCache`."""
        T = k_q_row.shape[1]
        self.k_q[b, :, :T] = k_q_row
        self.v_q[b, :, :T] = v_q_row
        self.k_scale[b, :, :T] = k_scale_row.to(torch.float32)
        self.v_scale[b, :, :T] = v_scale_row.to(torch.float32)
        self._set_length(b, T if length is None else length)


def make_caches(n_layers: int, batch: int, heads: int, max_len: int, head_dim: int,
                dtype=torch.float32, quantized: bool = False,
                split_base_len: Optional[int] = None, device=None,
                per_row: bool = False) -> List:
    """One cache per layer, on the card unless ``device='cpu'``; with
    ``per_row`` a row cache (a fill point per batch row, the serving
    engine's); with ``split_base_len`` a float :class:`SplitKVCache` whose
    base holds ``split_base_len`` slots and whose tail the rest of
    ``max_len``."""
    if per_row:
        if split_base_len is not None:
            raise ValueError("a row cache is not split")
        cls = RowQuantizedKVCache if quantized else RowKVCache
        return [cls(batch, heads, max_len, head_dim, dtype, device=device)
                for _ in range(n_layers)]
    if split_base_len is not None:
        if quantized:
            raise ValueError("a split cache is not quantized")
        return [SplitKVCache(batch, heads, split_base_len, max_len - split_base_len, head_dim,
                             dtype, device=device) for _ in range(n_layers)]
    cls = QuantizedKVCache if quantized else KVCache
    return [cls(batch, heads, max_len, head_dim, dtype, device=device) for _ in range(n_layers)]
