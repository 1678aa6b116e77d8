"""Physical BFP representation: packed integer mantissas + shared exponents.

Port of ``dmx_compressor_tpu/ops/bfp_pack.py`` (``PackedBFP``, ``bfp_pack``,
``bfp_unpack``).  BFP16_64 weights are stored as int8 mantissas plus one
int8 exponent per 64-block: a quarter of the fp32 bytes, which is what a
bandwidth-bound decode matmul pays for.  ``bfp_unpack(bfp_pack(x))`` is bit
for bit the simulated ``block_quantize`` cast.
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
