"""Frozen copies of the numerics the configurations state, written from
their definitions and kept apart from the port:

- BFP16_64 (``BFP[8|8]{64}``, symmetric, nearest): 8-bit two's-complement
  mantissas sharing the exponent of a block of 64 along an axis, values
  that round up to 2^(e+1) saturating to (2 - 2^-6) * 2^e;
- BFP32_1 (``BFP[24|8]{1}``, the biases): a float with 22 explicit mantissa
  bits and float32's exponent, nearest even, subnormals kept.
"""

from __future__ import annotations

import torch

def _bits(x):
    return x.contiguous().view(torch.int32)


def _pow2(k):
    """2^k as float32 for integer k in [-126, 127], built from its bits."""
    return ((k + 127).to(torch.int32) << 23).view(torch.float32)


def mul_pow2(x, k):
    """x * 2^k exactly, |k| up to 252 (two steps, the small one first)."""
    k = torch.as_tensor(k, dtype=torch.int32, device=x.device)
    k1 = torch.clamp(k, -126, 126)
    return x * _pow2(k - k1) * _pow2(k1)


def _exponent(x):
    """floor(log2|x|) of normal float32 x from its bits; 0 for x == 0, and
    a flag of bit-level zero."""
    b = _bits(x)
    zero = (b & 0x7FFFFFFF) == 0
    e = ((b >> 23) & 0xFF) - 127
    return torch.where(zero, torch.zeros_like(e), e), zero


def bfp(x: torch.Tensor, wl: int = 8, block: int = 64, axis: int = -1) -> torch.Tensor:
    """Symmetric nearest BFP fake-quant of ``x`` in float32, blocks of
    ``block`` along ``axis``: the rebase-add (x + 1.5 * 2^(e+2), whose
    float32 sum rounds first), rounding to the grid 2^(e+2-wl), and the clamp
    of values that reached 2^(e+1).  An all-zero block passes through."""
    ax = axis % x.ndim
    xf = torch.movedim(x.to(torch.float32), ax, -1)
    *lead, n = xf.shape
    xr = xf.reshape(*lead, n // block, block)
    amax = torch.amax(torch.abs(xr), dim=-1, keepdim=True)
    e, zero = _exponent(amax)
    base = mul_pow2(torch.full_like(amax, 1.5), e + 2)
    q = torch.round(mul_pow2(xr + base, wl - 2 - e))
    q = mul_pow2(q, e + 2 - wl) - base
    lim = mul_pow2(torch.ones_like(amax), e + 1)
    maxv = (2.0 - 2.0 ** (-(wl - 2))) * mul_pow2(torch.ones_like(amax), e)
    q = torch.where(torch.abs(q) >= lim, torch.sign(q) * maxv, q)
    q = torch.where(zero, xr, q).reshape(xf.shape)
    return torch.movedim(q, -1, ax)


def float_man(x: torch.Tensor, man: int = 22) -> torch.Tensor:
    """Round float32 ``x`` to ``man`` explicit mantissa bits, nearest even,
    keeping float32's exponent range (a one-element BFP block)."""
    xf = x.to(torch.float32)
    e, zero = _exponent(xf)
    e = torch.clamp(e, min=-126)
    q = mul_pow2(torch.round(mul_pow2(xf, man - e)), e - man)
    return torch.where(zero, xf, q)
