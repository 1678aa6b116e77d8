"""Physical BFP and SBFP representations: packed integer mantissas + per-block
exponents or scales.

Port of ``dmx_compressor_tpu/ops/bfp_pack.py`` (``PackedBFP``, ``bfp_pack``,
``bfp_unpack``, ``PackedSBFP``, ``sbfp_pack``, ``sbfp_unpack``).  BFP16_64
weights are stored as int8 mantissas plus one int8 exponent per 64-block: a
quarter of the fp32 bytes, which is what a bandwidth-bound decode matmul pays
for.  SBFP12_16 weights are int4 mantissas, two per byte, plus one f32 scale
per 16-block: 0.75 bytes per weight.  ``bfp_unpack(bfp_pack(x))`` is bit for
bit the simulated ``block_quantize`` cast, ``sbfp_unpack(sbfp_pack(x, fmt))``
bit for bit ``fmt.cast(x, -1)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..numerics import rounding as R


class PackedBFP(NamedTuple):
    """BFP payload blocked along the last axis.

    mantissa: int8 (int32 above 8 bits) [..., N], in [-(2^(wl-1)-1), 2^(wl-1)-1]
    exponent: int8 [..., N // block_size], floor(log2(max|block|)), unbiased
    precision: wl
    block_size: B
    """

    mantissa: torch.Tensor
    exponent: torch.Tensor
    precision: int
    block_size: int

    @property
    def shape(self):
        return self.mantissa.shape


def bfp_pack(x: torch.Tensor, precision: int = 8, block_size: int = 64) -> PackedBFP:
    """Pack along the last axis, which must be a multiple of ``block_size``.
    Nearest-even rounding with the saturate-at-2^(e+1) clip."""
    *lead, n = x.shape
    if n % block_size:
        raise ValueError(f"{n} not a multiple of block {block_size}")
    xf = x.to(torch.float32).reshape(*lead, n // block_size, block_size)
    e = R._exponent_of(torch.amax(torch.abs(xf), dim=-1, keepdim=True))
    # mantissa = round((x + 6*2^e) / 2^(e+2-wl)) - 3*2^(wl-1): the reference
    # rebase-add, whose fp32 sum rounds first (double rounding), so packed
    # values equal the simulated cast bit for bit
    base = R._mul_pow2(torch.full_like(xf, 1.5), e + 2)
    man = torch.round(R._mul_pow2(xf + base, precision - 2 - e)) - float(3 * 2 ** (precision - 1))
    limit = float(2 ** (precision - 1))
    man = torch.where(torch.abs(man) >= limit, torch.sign(man) * (limit - 1), man)
    return PackedBFP(
        mantissa=man.reshape(*lead, n).to(torch.int8 if precision <= 8 else torch.int32),
        exponent=e[..., 0].to(torch.int8),
        precision=precision,
        block_size=block_size,
    )


def bfp_unpack(p: PackedBFP) -> torch.Tensor:
    """Reconstruct fp32 values: man * 2^(e + 2 - wl)."""
    *lead, n = p.mantissa.shape
    man = p.mantissa.to(torch.float32).reshape(*lead, n // p.block_size, p.block_size)
    e = p.exponent.to(torch.int32)[..., None]
    return R._mul_pow2(man, e + 2 - p.precision).reshape(*lead, n)


class PackedSBFP(NamedTuple):
    """SBFP payload blocked along the last axis (numerics/format.py
    ScaledBlockFloatingPoint).

    nibbles: uint8 [..., N // 2], two two's-complement int4 mantissas per
        byte (low nibble = even index); the mantissas are the integer values
        of ``block_format.cast(block / chunk_max)``, in [-7, 7]
    scale: float32 [..., N // block_size], the scaler_format-cast chunk max
        (zero for an all-zero block)
    block_size: B (16 for SBFP12_16)
    bf16_exact: every dequantized weight (mantissa x scale) is exact in
        bfloat16, decided from the format at pack time (:func:`sbfp_bf16_exact`);
        B5 serves only such weights on its bf16 tensor-core kernels
    """

    nibbles: torch.Tensor
    scale: torch.Tensor
    block_size: int
    bf16_exact: bool = False


def sbfp_bf16_exact(fmt) -> bool:
    """Whether every weight of SBFP format ``fmt`` is exact in bfloat16 once
    dequantized: a mantissa of at most 3 bits (int4) times a scale of at most
    5 significant bits has at most 8, bf16's count, and every scale the
    format can hold, times the mantissa, stays inside bf16's normal range
    (its smallest, subnormals included, >= 2^-126; its largest < 2^124)."""
    sf = fmt.scaler_format
    emin = 1 - sf.bias - (0 if sf.flush_subnormal else sf.mantissa)
    emax = 2**sf.exponent - sf.bias
    return (fmt.block_format.precision <= 4 and sf.mantissa <= 4
            and emin >= -126 and emax <= 124)


def sbfp_pack(x: torch.Tensor, fmt) -> PackedSBFP:
    """Pack along the last axis; ``sbfp_unpack`` of the result is bit for bit
    ``fmt.cast(x, -1)`` (all-zero blocks included).  Takes int4 mantissas
    (block_format precision <= 4) and any scale format, as the JAX
    package's packer does; the last axis must be even (two mantissas to a
    byte) and a multiple of the block."""
    *lead, n = x.shape
    B = fmt.block_size
    if n % B or n % 2:
        raise ValueError(f"{n} not an even multiple of block {B}")
    if fmt.block_format.precision > 4:
        raise ValueError("nibble packing is int4: block_format precision must be <= 4")
    xf = x.to(torch.float32).reshape(*lead, n // B, B)
    chunk_max = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / fmt.man_scaling
    safe_max = torch.where(chunk_max > 0.0, chunk_max, torch.ones_like(chunk_max))
    man = fmt.block_format.cast(xf / safe_max)  # integer-valued floats
    scale = torch.where(chunk_max > 0.0, fmt.scaler_format.cast(chunk_max),
                        torch.zeros_like(chunk_max))[..., 0]
    man = man.reshape(*lead, n).to(torch.int32)
    lo = man[..., 0::2] & 0xF
    hi = man[..., 1::2] & 0xF
    return PackedSBFP(nibbles=(lo | (hi << 4)).to(torch.uint8),
                      scale=scale.to(torch.float32), block_size=B,
                      bf16_exact=sbfp_bf16_exact(fmt))


def sbfp_unpack_mantissa_int8(nibbles: torch.Tensor) -> torch.Tensor:
    """Two's-complement nibble payload -> int8 mantissas [..., 2 * half]:
    ``v - ((v > 7) << 4)`` on each nibble, low nibble first."""
    b = nibbles.to(torch.int32)
    lo = b & 0xF
    hi = (b >> 4) & 0xF
    man = torch.stack([lo - ((lo > 7).to(torch.int32) << 4),
                       hi - ((hi > 7).to(torch.int32) << 4)], dim=-1)
    return man.reshape(*b.shape[:-1], b.shape[-1] * 2).to(torch.int8)


def sbfp_unpack(p: PackedSBFP) -> torch.Tensor:
    """Dequantize to f32: mantissa * block scale."""
    man = sbfp_unpack_mantissa_int8(p.nibbles).to(torch.float32)
    *lead, n = man.shape
    man = man.reshape(*lead, n // p.block_size, p.block_size)
    return (man * p.scale[..., None]).reshape(*lead, n)
