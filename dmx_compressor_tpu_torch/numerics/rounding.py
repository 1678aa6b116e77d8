"""Bit-exact low-precision rounding primitives on torch tensors.

Port of ``dmx_compressor_tpu/numerics/rounding.py``: the same fp32 grid
arithmetic, written with torch ops so it runs on the CPU and on the card.
Bit tests go through ``tensor.view(torch.int32)`` (never float compares),
so zero and subnormal handling does not depend on the device's
denormal mode.

Semantics (each matches the JAX function of the same name bit for bit):

- "nearest" = round-half-to-even on the quantization grid (``torch.round``
  rounds half to even, as ``jnp.round`` does);
- block (BFP) quantization rebases against the block max exponent ``e``
  with grid step ``2^(e+2-wl)`` and saturates to ``(2 - 2^-(wl-2)) * 2^e``
  only when the rounded value reaches ``2^(e+1)``;
- float quantization keeps ``man`` mantissa bits, handles subnormals with
  the reference's shift trick (double rounding included), and clips at the
  exponent of the *default* bias whatever the custom bias.

Stochastic rounding draws from an explicit ``torch.Generator``.  Its
stream differs from JAX's PRNG, so it is held to the JAX function by
statistics, not bits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_ROUNDINGS = ("nearest", "stochastic", "up", "down")


def _bits(x: Tensor) -> Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def _pow2f(k: Tensor) -> Tensor:
    """Exact 2^k as float32 for integer k in [-126, 127] (bit construction)."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def _mul_pow2(x: Tensor, k) -> Tensor:
    """x * 2^k, exact, supporting |k| up to 252 without overflow of 2^k."""
    k = torch.as_tensor(k, dtype=torch.int32, device=x.device)
    k1 = torch.clamp(k, -126, 126)
    k2 = k - k1
    # the small remainder first: going down through the subnormal range in
    # one final step avoids double rounding
    return x * _pow2f(k2) * _pow2f(k1)


def _is_zero(x: Tensor) -> Tensor:
    """Bit-level zero test (float compares may flush subnormals to zero)."""
    return (_bits(x) & 0x7FFFFFFF) == 0


def _exponent_of(x: Tensor) -> Tensor:
    """floor(log2(|x|)) for normal fp32 x via bit extraction; 0 where x == 0."""
    e = ((_bits(x) >> 23) & 0xFF) - 127
    return torch.where(_is_zero(x), torch.zeros_like(e), e)


def _round_int_on_grid(
    scaled: Tensor,
    rounding: str,
    generator: Optional[torch.Generator],
    bit_mode: bool = False,
) -> Tensor:
    """Round pre-scaled values to integers per the reference rounding mode.

    ``bit_mode`` selects the semantics of the reference's bitwise rounding
    (sign-magnitude: "down" truncates toward zero, "up" adds a full ulp to
    the magnitude), used by the float and block paths; fixed point uses
    true ceil/floor.
    """
    if rounding == "nearest":
        return torch.round(scaled)
    if rounding == "stochastic":
        if generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        r = torch.rand(
            scaled.shape, generator=generator, device=scaled.device,
            dtype=torch.float32,
        )
        return torch.round(scaled + r - 0.5)
    if rounding == "up":
        if bit_mode:
            # a NaN keeps its own bits, sign included, as under jnp.sign
            up = torch.sign(scaled) * (torch.floor(torch.abs(scaled)) + 1.0)
            return torch.where(torch.isnan(scaled), scaled, up)
        return torch.ceil(scaled)
    if rounding == "down":
        if bit_mode:
            return torch.trunc(scaled)
        return torch.floor(scaled)
    raise ValueError(f"unknown rounding mode: {rounding}")


# ---------------------------------------------------------------------------
# fixed point
# ---------------------------------------------------------------------------


def fixed_point_quantize(
    x: Tensor,
    wl: int,
    fl: int,
    clamp: bool = True,
    symmetric: bool = False,
    rounding: str = "nearest",
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Fake-quantize to a ``wl``-bit fixed point grid with ``fl`` fraction bits."""
    if rounding not in _ROUNDINGS:
        raise ValueError(f"unknown rounding mode: {rounding}")
    orig_dtype = x.dtype
    xf = x.to(torch.float32)
    q = _round_int_on_grid(_mul_pow2(xf, fl), rounding, generator)
    q = _mul_pow2(q, -fl)
    if clamp:
        t_min = -(2.0 ** (wl - fl - 1))
        t_max = -t_min - 2.0 ** (-fl)
        if symmetric:
            t_min = t_min + 2.0 ** (-fl)
        q = torch.clamp(q, t_min, t_max)
    return q.to(orig_dtype)


# ---------------------------------------------------------------------------
# low-bit floating point
# ---------------------------------------------------------------------------


def float_quantize(
    x: Tensor,
    man: int,
    exp: int,
    bias: Optional[int] = None,
    flush_subnormal: bool = True,
    rounding: str = "nearest",
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Fake-quantize to a float format with ``man`` mantissa / ``exp`` exponent bits."""
    if rounding not in _ROUNDINGS:
        raise ValueError(f"unknown rounding mode: {rounding}")
    if bias is None:
        bias = 2 ** (exp - 1) - 1
    orig_dtype = x.dtype
    xf = x.to(torch.float32)

    zero = _is_zero(xf)
    e = _exponent_of(xf)
    min_exp = -(bias - 1)
    subnormal = (e < min_exp) & ~zero

    # normal path: grid step 2^(e - man), e clamped for safe arithmetic
    e_n = torch.clamp(e, min=min_exp)
    q = _round_int_on_grid(_mul_pow2(xf, man - e_n), rounding, generator, bit_mode=True)
    q_norm = _mul_pow2(q, e_n - man)
    # overflow clip: max exponent from the DEFAULT bias, whatever the custom
    # bias (the reference's clip_exponent quirk)
    emax = 2 ** (exp - 1)
    maxv = (2.0 - 2.0 ** (-man)) * 2.0**emax if emax + 1 <= 127 else float("inf")
    # NaN's exponent passes the test; it keeps its value (jnp.sign keeps NaN)
    q_norm = torch.where(
        (_exponent_of(q_norm) > emax) & ~_is_zero(q_norm) & ~torch.isnan(q_norm),
        torch.sign(q_norm) * maxv,
        q_norm,
    )

    if flush_subnormal:
        q_sub = torch.zeros_like(xf)
    else:
        # fixed grid 2^(min_exp - man) via the integer mantissa, so no float
        # arithmetic ever sees a subnormal operand
        bits = _bits(xf)
        E = (bits >> 23) & 0xFF
        m_int = bits & 0x7FFFFF
        mant = torch.where(E > 0, m_int + (1 << 23), m_int).to(torch.float32)
        sc = torch.where(E > 0, E - 150, torch.full_like(E, -149))  # |x| = mant * 2^sc
        k1 = sc - (min_exp - man) + (23 - man)  # fp32-mantissa grid at min_exp
        # when the scaled magnitude underflows fp32, any stand-in in (0, 0.5)
        # rounds identically
        fine = torch.where(
            k1 >= -126,
            _mul_pow2(mant, torch.clamp(k1, min=-126)),
            torch.full_like(mant, 2.0**-103),
        )
        # the reference's fp32 add x + sign*2^min_exp rounds x onto the
        # 2^(min_exp-23) grid first, then bit-rounds to the format grid:
        # double rounding, replicated
        s1 = torch.round(torch.where(bits < 0, -fine, fine))
        qs = _round_int_on_grid(s1 * 2.0 ** (man - 23), rounding, generator, bit_mode=True)
        if rounding == "up":
            # bitwise-up bumps exact zeros away from zero with x's own sign
            qs = torch.where(
                qs == 0.0,
                torch.where(bits < 0, -torch.ones_like(qs), torch.ones_like(qs)),
                qs,
            )
        if min_exp - man >= -126:
            q_sub = _mul_pow2(qs, min_exp - man)
        else:
            # subnormal result: build the bits directly (mantissa carry into
            # the exponent field is the correct IEEE encoding)
            gb = (min_exp - man) + 149
            q_abs = torch.abs(qs).to(torch.int32) << gb
            q_bits = torch.where(qs < 0, q_abs | torch.iinfo(torch.int32).min, q_abs)
            q_sub = q_bits.view(torch.float32)

    out = torch.where(subnormal, q_sub, q_norm)
    out = torch.where(zero, xf, out)
    return out.to(orig_dtype)


# ---------------------------------------------------------------------------
# block floating point
# ---------------------------------------------------------------------------


def _block_round(xf: Tensor, e: Tensor, wl: int, rounding: str,
                 generator: Optional[torch.Generator]) -> Tensor:
    """The reference rebase trick: t = x + 6*2^e lies in [5*2^e, 7*2^e], so
    its fp32 exponent is e+2 and keeping wl bits gives step 2^(e+2-wl).  The
    fp32 ADD rounds first (the reference's double rounding)."""
    base = _mul_pow2(torch.full_like(xf, 1.5), e + 2)  # 6 * 2^e, exact
    t = xf + base
    q = _round_int_on_grid(_mul_pow2(t, wl - 2 - e), rounding, generator, bit_mode=True)
    return _mul_pow2(q, e + 2 - wl) - base


def block_quantize(
    x: Tensor,
    wl: int,
    rounding: str = "nearest",
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Symmetric BFP fake-quantization; each trailing-axis vector is one block."""
    if rounding not in _ROUNDINGS:
        raise ValueError(f"unknown rounding mode: {rounding}")
    orig_dtype = x.dtype
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    e = _exponent_of(amax)
    q = _block_round(xf, e, wl, rounding, generator)
    q = torch.where(_is_zero(amax), xf, q)  # all-zero blocks pass through
    # clip_max_exponent(wl-2, e): clamp only when the result reached 2^(e+1)
    lim = _mul_pow2(torch.ones_like(amax), e + 1)
    maxv = (2.0 - 2.0 ** (-(wl - 2))) * _mul_pow2(torch.ones_like(amax), e)
    q = torch.where(torch.abs(q) >= lim, torch.sign(q) * maxv, q)
    return q.to(orig_dtype)


def make_mantissa_asymmetric(q: Tensor, x: Tensor, n_mantissa_bits: int = 8) -> Tensor:
    """Asymmetric-mantissa post-pass for BFP blocks along the last axis: an
    element at the most negative symmetric mantissa moves one step down to
    ``-2^(n-1)`` when that does not increase its error (ties included)."""
    qf = q.to(torch.float32)
    xf = x.to(torch.float32)
    man, ex = torch.frexp(qf)
    ex = torch.where((ex == 0) & (man == 0.0), torch.full_like(ex, -200), ex)
    max_exp = torch.amax(ex, dim=-1, keepdim=True) - n_mantissa_bits + 1
    int_man = _mul_pow2(man, ex - max_exp).to(torch.int32)
    edge = int_man == -(2 ** (n_mantissa_bits - 1) - 1)
    old_err = qf - xf
    step = _mul_pow2(torch.ones_like(qf), max_exp)
    cand_err = old_err - step
    subtract = edge & (torch.abs(cand_err) <= torch.abs(old_err))
    return torch.where(subtract, qf - step, qf).to(q.dtype)


def block_quantize_lastdim(
    x: Tensor,
    wl: int,
    block_size: int,
    rounding: str = "nearest",
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Symmetric BFP over contiguous runs of ``block_size`` along the last
    axis, which must be a multiple of ``block_size`` (bit-identical to
    :func:`block_quantize` on the blocked view)."""
    if rounding not in _ROUNDINGS:
        raise ValueError(f"unknown rounding mode: {rounding}")
    if x.shape[-1] % block_size:
        raise ValueError(f"last dim {x.shape[-1]} not a multiple of {block_size}")
    orig_dtype = x.dtype
    xf = x.to(torch.float32)
    *lead, n = xf.shape
    amax = torch.amax(torch.abs(xf).reshape(*lead, n // block_size, block_size), dim=-1)
    e = torch.repeat_interleave(_exponent_of(amax), block_size, dim=-1)
    zero = torch.repeat_interleave(_is_zero(amax), block_size, dim=-1)
    q = _block_round(xf, e, wl, rounding, generator)
    lim = _mul_pow2(torch.ones_like(xf), e + 1)
    maxv = (2.0 - 2.0 ** (-(wl - 2))) * _mul_pow2(torch.ones_like(xf), e)
    q = torch.where(torch.abs(q) >= lim, torch.sign(q) * maxv, q)
    q = torch.where(zero, xf, q)
    return q.to(orig_dtype)


# ---------------------------------------------------------------------------
# shaping helper: blocks along an arbitrary dim with remainder handling
# ---------------------------------------------------------------------------


def apply_blockwise(x: Tensor, block_dim: int, block_size: int, fn) -> Tensor:
    """Apply ``fn`` to ``x`` viewed as [rows, n_blocks, block_size], blocks
    being contiguous runs along ``block_dim``; a short final block is
    zero-padded (zeros never change a block's max and quantize to zero)."""
    squeeze = x.ndim == 0
    if squeeze:
        x = x.reshape(1, 1)
    block_dim = block_dim % x.ndim
    xt = torch.movedim(x, block_dim, -1)
    shape = xt.shape
    L = shape[-1]
    pad = (-L) % block_size
    flat = xt.reshape(-1, L)
    if pad:
        flat = F.pad(flat, (0, pad))
    out = fn(flat.reshape(flat.shape[0], -1, block_size))
    out = out.reshape(flat.shape[0], L + pad)[:, :L].reshape(shape)
    out = torch.movedim(out, -1, block_dim)
    return out.reshape(()) if squeeze else out
