"""Fused BASIC-mode decode attention: the compound SDPA pipeline, inlined.

Port of ``BasicSDPAParams``, ``_poly2exp_inline``, ``basic_sdpa_decode``,
``cast_k_rows``, ``cast_v_sblocks``, ``basic_sdpa_decode_split`` (its D-minor
form) and ``basic_sdpa_shape`` of ``dmx_compressor_tpu/ops/basic_attention.py``.

The compound ScaledDotProductAttention decomposes into actmatmul -> resadd
-> mul -> softmax -> dropout -> actmatmul, each sub-op with its BASIC casts.
At T = 1 this module runs the same chain in f32 op for op: the BFP casts
(q and k rows along head_dim, scores and v along the sequence) and the
FLOAT16 boundaries through kernel T2 (``ops/bfp_cast.py``; the softmax
output cast and the weights' BFP cast in one launch), the SOFTMAX
surrogate inline.  The two products are f32 ``torch.matmul`` on
BFP16-cast operands, whose products are exact: the JAX package's
bf16 x bf16 -> f32 einsums, in another summation order.  (A bf16
``torch.matmul`` would round its output to bf16.)  Query heads are grouped
per KV head (GQA) without a repeat.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..functional import simd_ops
from ..numerics.format import _FLOAT16_REPR
from . import bfp_cast as T2
from .basic_linear import _fp16_cast_f32, cast_blocked_lastdim


class BasicSDPAParams(NamedTuple):
    """Static BASIC-shape parameters extracted from a compound SDPA module."""

    wl: int  # BFP mantissa bits of the actmatmul input casts
    block: int  # BFP block size (divides head_dim)
    input_clamp: float  # softmax wrapper clamp
    max_adjust: float  # surrogate max offset
    kmax: int  # exp shift clamp
    use_exp_large: bool


def _poly2exp_inline(x: torch.Tensor, kmax: int, use_exp_large: bool) -> torch.Tensor:
    """functional/simd_ops.poly2exp with knorm = 0 (the JAX package inlines
    a copy for Pallas; the port calls it)."""
    return simd_ops.poly2exp(x, 0, kmax, use_exp_large)


def cast_k_rows(k: torch.Tensor, wl: int, block: Optional[int] = None) -> torch.Tensor:
    """The BASIC k-cast: BFP blocks of ``block`` along head_dim (one block
    per cache row when ``block`` is None)."""
    return cast_blocked_lastdim(k, k.shape[-1] if block is None else block, wl)


def cast_v_sblocks(v: torch.Tensor, block: int, wl: int) -> torch.Tensor:
    """The BASIC v-cast: BFP blocks along the sequence axis of [B, H, S, D]."""
    return T2.bfp_cast(v.to(torch.float32), wl, block, -2)


def _softmax_chain(s: torch.Tensor, mask_row: torch.Tensor, scale: float,
                   params: BasicSDPAParams, out_cast: bool = True) -> torch.Tensor:
    """actmatmul output cast -> resadd(mask) -> mul(scale) -> SOFTMAX
    surrogate between its FLOAT16 casts, on f32 scores [..., S].
    ``out_cast=False`` leaves the softmax output cast to the consumer (the
    weights' BFP cast takes it in the same T2 launch)."""
    s = _fp16_cast_f32(s)  # actmatmul output cast
    bias = _fp16_cast_f32(mask_row)  # resadd(0, mask) with fp16 casts
    s = _fp16_cast_f32(s + bias)  # resadd output cast
    s = _fp16_cast_f32(s * scale)  # mul (casts SAME), softmax input cast
    s = torch.clamp(s, min=params.input_clamp)
    m = torch.amax(s, dim=-1, keepdim=True) - params.max_adjust
    e = _poly2exp_inline(s - m, params.kmax, params.use_exp_large)
    ssum = torch.sum(e, dim=-1, keepdim=True)
    r0 = 1.0 / ssum
    r = r0 * (2.0 - ssum * r0)
    return _fp16_cast_f32(e * r) if out_cast else e * r  # softmax output cast


def basic_sdpa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask_row: torch.Tensor, *, scale: float,
                      params: BasicSDPAParams) -> torch.Tensor:
    """Fused BASIC compound-SDPA decode step over one cache: q [B, H, 1, D],
    k/v [B, Hkv, S, D], an additive float mask broadcastable to [1, S] (or
    one row per batch row); returns [B, H, 1, D] in f32."""
    B, Hkv, S, D = k.shape
    H = q.shape[1]
    if q.shape != (B, H, 1, D) or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    rep = H // Hkv
    mask_row = mask_row.to(torch.float32)
    if mask_row.ndim >= 2 and mask_row.shape[0] == B and B > 1:
        mask_row = mask_row.reshape(B, 1, 1, S)
    else:
        mask_row = mask_row.reshape(-1)[-S:]
    qc = cast_blocked_lastdim(q, params.block, params.wl).reshape(B, Hkv, rep, D)
    kc = cast_k_rows(k, params.wl, params.block)
    s = torch.matmul(qc, kc.transpose(-1, -2)).reshape(B, H, 1, S)
    w = _softmax_chain(s, mask_row, scale, params, out_cast=False)
    wc = cast_blocked_lastdim(w, params.block, params.wl, fp16_first=True).reshape(B, Hkv, rep, S)
    vc = cast_v_sblocks(v, params.block, params.wl)
    out = torch.matmul(wc, vc).reshape(B, H, 1, D)
    return _fp16_cast_f32(out)  # actmatmul output cast


def basic_sdpa_decode_split(
    q: torch.Tensor,
    base_k: torch.Tensor,
    base_v: torch.Tensor,
    tail_k: torch.Tensor,
    tail_v: torch.Tensor,
    mask_row: torch.Tensor,
    *,
    scale: float,
    params: BasicSDPAParams,
    base_k_cast: Optional[torch.Tensor] = None,
    base_v_cast: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """BASIC compound-SDPA decode over a split KV cache (ops/kv_cache.py
    SplitKVCache, segments [B, Hkv, S0 / C, D]) without concatenating the
    segments: the numerics of :func:`basic_sdpa_decode` over the whole
    cache, since the per-row k-cast is segment-local and the S-blocked
    score and V casts stay segment-local (S0 and C are multiples of the
    block); only the final sum is taken in two parts.  ``base_*_cast`` are
    the base segment's precomputed casts (SplitKVCache.set_base_cast)."""
    B, Hkv, S0, D = base_k.shape
    C = tail_k.shape[2]
    H = q.shape[1]
    rep = H // Hkv
    wl, block = params.wl, params.block
    if S0 % block or C % block:
        raise ValueError(f"segments {S0} and {C} must be multiples of the block {block}")
    mask_row = mask_row.to(torch.float32).reshape(-1)[-(S0 + C):]
    qg = cast_blocked_lastdim(q, block, wl).reshape(B, Hkv, rep, D)

    def seg_scores(k_seg, precast):
        kc = precast if precast is not None else cast_k_rows(k_seg, wl, block)
        return torch.matmul(qg, kc.transpose(-1, -2)).reshape(B, H, 1, k_seg.shape[2])

    s = torch.cat([seg_scores(base_k, base_k_cast), seg_scores(tail_k, None)], dim=-1)
    wc = cast_blocked_lastdim(_softmax_chain(s, mask_row, scale, params, out_cast=False), block,
                              wl, fp16_first=True)

    def seg_out(w_seg, v_seg, precast):
        vc = precast if precast is not None else cast_v_sblocks(v_seg, block, wl)
        return torch.matmul(w_seg.reshape(B, Hkv, rep, -1), vc).reshape(B, H, 1, D)

    out = seg_out(wc[..., :S0], base_v, base_v_cast) + seg_out(wc[..., S0:], tail_v, None)
    return _fp16_cast_f32(out)  # actmatmul output cast


def basic_sdpa_shape(sdpa, head_dim: int, seq_len: int) -> Optional[BasicSDPAParams]:
    """The fused path's params when the compound SDPA module is in the exact
    BASIC decode shape it reproduces; None: the modular path.

    Checked: actmatmul BFP symmetric nearest on both inputs (blocks along
    head_dim for the first product, the block dividing head_dim and the
    sequence), FLOAT16 output; resadd and softmax io FLOAT16; mul and
    dropout SAME; the SOFTMAX[vsimd] surrogate in inference mode; the
    sdpa-level casts SAME."""
    from ..functional.approximate import NoApproximation
    from ..nn.core import DmxModule
    from ..numerics.format import BlockFloatingPoint, Same

    if not DmxModule.inference_mode or DmxModule.plugins:
        return None

    def cast_ok(c, want):
        if c.observer_enabled or c.pre_transform or not c.fake_quant_enabled:
            return False
        f = c.format
        if want == "same":
            return isinstance(f, Same)
        if want == "fp16":
            return repr(f) == _FLOAT16_REPR
        return isinstance(f, BlockFloatingPoint) and f.symmetric and f.rounding == "nearest"

    try:
        if not all(cast_ok(sdpa.input_casts[n], "same") for n in sdpa.input_cast_names):
            return None
        if not isinstance(sdpa.approximator.function, NoApproximation):
            return None
        am = sdpa.actmatmul
        ic, mc = am.input_casts["input_cast"], am.input_casts["multiplier_cast"]
        if not (cast_ok(ic, "bfp") and cast_ok(mc, "bfp")
                and cast_ok(am.output_casts["output_cast"], "fp16")):
            return None
        if not (ic.format == mc.format and ic.block_dim == -1 and mc.block_dim == -2
                and head_dim % ic.format.block_size == 0
                and seq_len % ic.format.block_size == 0
                and isinstance(am.approximator.function, NoApproximation)):
            return None
        if am.accum_cast is not None and not isinstance(am.accum_cast.format, Same):
            return None
        ra = sdpa.resadd
        if not all(cast_ok(c, "fp16") for c in (ra.input_casts["input_cast"],
                                                ra.input_casts["residual_cast"],
                                                ra.output_casts["output_cast"])):
            return None
        mu = sdpa.mul
        if not all(cast_ok(c, "same") for c in [mu.input_casts[n] for n in mu.input_cast_names]
                   + [mu.output_casts["output_cast"]]):
            return None
        sm = sdpa.softmax
        if not (cast_ok(sm.input_casts["input_cast"], "fp16")
                and cast_ok(sm.output_casts["output_cast"], "fp16") and sm.dim in (-1, 3)):
            return None
        fn = sm.approximator.function
        if isinstance(fn, NoApproximation) or getattr(fn, "func_name", None) != "softmax":
            return None
        wp, ep = dict(fn.wrapper_params), dict(fn.extra_params)
        if wp.keys() - {"input_clamp"} or ep.keys() - {"max_adjust", "knorm", "kmax",
                                                         "use_exp_large"}:
            return None
        if int(ep.get("knorm", 0)) != 0:
            return None
        dp = sdpa.dropout  # the port's Dropout is the identity at inference
        if not all(cast_ok(c, "same") for c in [dp.input_casts[n] for n in dp.input_cast_names]
                   + [dp.output_casts["output_cast"]]):
            return None
        return BasicSDPAParams(
            wl=ic.format.precision,
            block=ic.format.block_size,
            input_clamp=float(wp.get("input_clamp", -float("inf"))),
            max_adjust=float(ep.get("max_adjust", 0.0)),
            kmax=int(ep.get("kmax", 15)),
            use_exp_large=bool(ep.get("use_exp_large", True)),
        )
    except (KeyError, AttributeError):
        return None
