"""Fused fake-quant linear: input BFP cast + dequant matmul + FP16 epilogue.

Port of ``block_exponents``, ``_bfp_cast_with_exponents``, ``_fp16_cast_f32``,
``cast_blocked_lastdim`` and ``fused_basic_linear`` of
``dmx_compressor_tpu/ops/basic_linear.py``.  On the card the casts run
kernel T2 (``ops/bfp_cast.py``) and the matmul, with its FLOAT16 and
ResAdd epilogues, kernel T1 (``ops/bfp_linear.py:bfp_linear_bf16``); on the
CPU both run their plain versions.

Numerics contract (held against the JAX package in tests/test_torch_basic.py):

- input cast: bit-exact symmetric nearest BFP, blocks along the last axis
  (the reference rebase-add, f32 double rounding and zero-block passthrough
  included, through the sentinel exponent -128);
- output cast: bit-exact FLOAT16 (clamp to +-65504, nearest even onto the
  fp16 grid, flush below the smallest normal);
- matmul: bf16 operands (lossless for <= 8 quantized mantissa bits), f32
  accumulation.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import bfp_cast as T2
from .bfp_cast import bfp_cast_with_exponents as _bfp_cast_with_exponents  # noqa: F401
from .bfp_linear import bfp_linear_bf16
from .bfp_pack import PackedBFP


def block_exponents(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block shared exponents of ``x`` along the last axis, int8:
    floor(log2(max|block|)), -128 for a bit-level zero block."""
    *lead, K = x.shape
    xf = x.to(torch.float32).reshape(*lead, K // block_size, block_size)
    return T2.exponent_with_sentinel(torch.amax(torch.abs(xf), dim=-1)).to(torch.int8)


def _fp16_cast_f32(y: torch.Tensor) -> torch.Tensor:
    """The FLOAT16 cast of f32 values (T2 on the card)."""
    return T2.fp16_cast(y)


def cast_blocked_lastdim(x: torch.Tensor, block: int, wl: int,
                         fp16_first: bool = False) -> torch.Tensor:
    """Symmetric nearest BFP fake-quant, blocks along the last axis (T2 on
    the card); f32 out.  ``fp16_first`` applies the FLOAT16 cast first, in
    the same launch."""
    return T2.bfp_cast(x.to(torch.float32), wl, block, -1, fp16_first=fp16_first)


def fused_basic_linear(
    x: torch.Tensor,
    *,
    packed: PackedBFP,
    bias: Optional[torch.Tensor] = None,
    in_wl: int,
    in_block: int,
    out_fp16: bool = False,
    res_out: Optional[torch.Tensor] = None,
    res_on_grid: bool = False,
    in_fp16_first: bool = False,
) -> torch.Tensor:
    """y = fp16(cast_bfp(x) @ W_deq.T + b) [-> FLOAT16 ResAdd with ``res_out``].

    ``x`` may have any leading shape.  ``in_wl``/``in_block`` give the
    input BFP cast, which makes x exact in bf16 for ``in_wl`` <= 9 (the JAX
    package also takes None, an input used as is: not ported);
    ``packed`` is the int8 BFP payload; ``out_fp16`` applies the FLOAT16
    output cast; ``res_out`` (shaped like the output) adds a FLOAT16 ResAdd
    after it, its residual cast skipped when ``res_on_grid``;
    ``in_fp16_first`` applies the producer's FLOAT16 output cast to x in the
    input cast's launch (``fused_ln_linear``).  The JAX
    package's ``w_bf16`` form (a bf16 weight cache) is not ported: the port
    keeps the int8 payload only."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = packed.mantissa.shape[0]
    x2 = cast_blocked_lastdim(x.reshape(-1, K), in_block, in_wl, fp16_first=in_fp16_first)
    r = None
    if res_out is not None:
        r = res_out.reshape(-1, N).to(torch.float32)
        if not res_on_grid:
            r = _fp16_cast_f32(r)
    y = bfp_linear_bf16(x2, packed, bias=bias, out_fp16=out_fp16, residual=r)
    return y.reshape(*lead, N).to(x.dtype)
