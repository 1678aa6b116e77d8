"""The BASIC fake-quant casts (kernel T2): symmetric nearest BFP and FLOAT16.

Port of the casts that the Pallas probes of
``dmx_compressor_tpu/tools/probe_fused_cast.py`` build up (the fused
BASIC-linear kernel's blocks (a)-(h)) and that
``dmx_compressor_tpu/ops/basic_linear.py`` computes inline: the BFP cast of
``_bfp_cast_with_exponents`` after per-block exponents, and the FLOAT16 cast
of ``_fp16_cast_f32``.  On a CUDA tensor :func:`bfp_cast` and
:func:`fp16_cast` launch ``csrc/bfp_cast.cu``, on a CPU tensor they run the
plain versions below; both are bit for bit the same function.

Every BASIC cast of the port goes through these two wrappers: the
``BlockFloatingPoint`` (symmetric, nearest, blocks dividing the axis) and
``FLOAT16`` casts of ``numerics/format.py``, and the casts of
``ops/basic_*.py``.  ``bfp_cast(..., fp16_first=True)`` is the FLOAT16 cast
followed by the BFP cast in one launch, for the fused decode step's sites
where a FLOAT16 output cast feeds a BFP input cast.  :func:`probe` runs the
eight building blocks one at a time through the same kernel.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..numerics import rounding as R

_OP_BFP, _OP_FP16, _OP_PROBE_A, _OP_FP16_BFP = 0, 1, 2, 10
PROBES = "abcdefgh"
_FP16_MIN_NORMAL = 6.103515625e-05
_MAX_ROW_BLOCK = 256  # the last-axis kernel keeps a block in registers


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def exponent_with_sentinel(amax: torch.Tensor) -> torch.Tensor:
    """floor(log2(amax)) as f32, with -128 marking bit-level zero blocks."""
    e = R._exponent_of(amax).to(torch.float32)
    return torch.where(R._is_zero(amax), torch.full_like(e, -128.0), e)


def bfp_cast_with_exponents(xf: torch.Tensor, e_full: torch.Tensor, wl: int) -> torch.Tensor:
    """Symmetric nearest BFP fake-quant of f32 ``xf`` given per-element
    shared exponents (``e_full`` == -128: a zero block, passed through): the
    reference rebase-add, whose f32 add rounds first, then the clamp to
    (2 - 2^-(wl-2)) * 2^e of values that reached 2^(e+1)."""
    zero = e_full == -128.0
    e = torch.where(zero, torch.zeros_like(e_full), e_full).to(torch.int32)
    base = R._mul_pow2(torch.full_like(xf, 1.5), e + 2)
    t = xf + base
    q = torch.round(R._mul_pow2(t, wl - 2 - e))
    q = R._mul_pow2(q, e + 2 - wl) - base
    lim = R._mul_pow2(torch.ones_like(xf), e + 1)
    maxv = (2.0 - 2.0 ** (-(wl - 2))) * R._mul_pow2(torch.ones_like(xf), e)
    q = torch.where(torch.abs(q) >= lim, torch.sign(q) * maxv, q)
    return torch.where(zero, xf, q)


def bfp_cast_ref(x: torch.Tensor, wl: int, block: int, axis: int = -1) -> torch.Tensor:
    """Plain version of the BFP cast: blocks of ``block`` along ``axis``."""
    ax = axis % x.ndim
    xf = torch.movedim(x.to(torch.float32), ax, -1)
    *lead, n = xf.shape
    xr = xf.reshape(*lead, n // block, block)
    amax = torch.amax(torch.abs(xr), dim=-1, keepdim=True)
    e = torch.broadcast_to(exponent_with_sentinel(amax), xr.shape)
    q = bfp_cast_with_exponents(xr, e, wl).reshape(xf.shape)
    return torch.movedim(q, -1, ax).to(x.dtype)


def fp16_cast_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the FLOAT16 cast: clamp to +-65504, round to the
    fp16 grid (nearest even), flush below the smallest normal; f32 out."""
    y = torch.clamp(x.to(torch.float32), -65504.0, 65504.0).to(torch.float16)
    y = torch.where(torch.abs(y) < _FP16_MIN_NORMAL, torch.zeros_like(y), y)
    return y.to(torch.float32)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _launch(src: torch.Tensor, op: int, outer: int, length: int, inner: int, block: int,
            wl: int, out_shape=None) -> torch.Tensor:
    out = torch.empty(src.shape if out_shape is None else out_shape, dtype=torch.float32,
                      device=src.device)
    kernels.check_cuda(src, out, dtypes=(torch.float32, torch.float32), align=4)
    kernels.launch("bfp_cast", src.data_ptr(), out.data_ptr(), op, outer, length, inner,
                   block, wl)
    return out


def bfp_cast(x: torch.Tensor, wl: int, block: int, axis: int = -1,
             fp16_first: bool = False) -> torch.Tensor:
    """Symmetric nearest BFP cast with ``wl``-bit mantissas, blocks of
    ``block`` consecutive positions along ``axis`` (a multiple of
    ``block``).  With ``fp16_first`` the FLOAT16 cast is applied first, in
    the same launch: ``bfp_cast_ref(fp16_cast_ref(x), ...)`` bit for bit.
    Returns ``x``'s dtype (f32 with ``fp16_first``)."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if n % block:
        raise ValueError(f"axis {axis} of length {n} is not a multiple of the block {block}")
    if not kernels.plain_or_kernel(x):
        if fp16_first:
            x = fp16_cast_ref(x)
        return bfp_cast_ref(x, wl, block, ax)
    if x.numel() == 0:
        return x.to(torch.float32) if fp16_first else x.clone()
    op = _OP_FP16_BFP if fp16_first else _OP_BFP
    dtype = torch.float32 if fp16_first else x.dtype
    xf = x.to(torch.float32)
    moved = torch.movedim(xf, ax, -1)
    if moved.is_contiguous() and block <= _MAX_ROW_BLOCK:
        # the blocked axis is innermost in memory (a kᵀ view blocked along
        # its rows, for one): a last-axis cast of the same storage
        out = _launch(moved, op, moved.numel() // n, n, 1, block, wl)
        return torch.movedim(out, -1, ax).to(dtype)
    src = xf.contiguous()
    inner = math.prod(src.shape[ax + 1:])
    if inner == 1 and block > _MAX_ROW_BLOCK:
        raise ValueError(f"last-axis BFP blocks of at most {_MAX_ROW_BLOCK}, got {block}")
    out = _launch(src, op, math.prod(src.shape[:ax]), n, inner, block, wl)
    return out.to(dtype)


def fp16_cast(x: torch.Tensor) -> torch.Tensor:
    """The FLOAT16 cast of f32 values (any float input), f32 out."""
    if not kernels.plain_or_kernel(x):
        return fp16_cast_ref(x)
    src = x.to(torch.float32).contiguous()
    if src.numel() == 0:
        return src.clone()
    return _launch(src, _OP_FP16, 1, src.numel(), 1, 1, 0)


# ---------------------------------------------------------------------------
# the building blocks (a)-(h), one at a time
# ---------------------------------------------------------------------------


def probe_ref(name: str, x: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Plain version of probe ``name`` on f32 [rows, cols] (on [rows,
    cols // block] for ``h``)."""
    rows, cols = x.shape
    if name == "a":  # block reshape and back
        return x.reshape(rows, cols // block, block).reshape(rows, cols).clone()
    if name == "b":  # per-block max|x|
        return torch.amax(torch.abs(x).reshape(rows, cols // block, block), dim=-1)
    if name == "c":  # exponent field by bitcast
        return (((x.contiguous().view(torch.int32) >> 23) & 0xFF) - 127).to(torch.float32)
    if name == "d":  # 2^k by shift and bitcast
        k = torch.clamp(x.to(torch.int32), -10, 10)
        return ((k + 127) << 23).view(torch.float32)
    if name == "e":  # round half to even
        return torch.round(x * 3.7)
    if name == "f":  # the FLOAT16 epilogue
        return fp16_cast_ref(x)
    if name == "g":  # block max broadcast over the block
        amax = torch.amax(torch.abs(x).reshape(rows, cols // block, block), dim=-1, keepdim=True)
        return torch.broadcast_to(amax, (rows, cols // block, block)).reshape(rows, cols)
    if name == "h":  # per-block values expanded to elements
        return torch.repeat_interleave(x, block, dim=-1)
    raise ValueError(f"unknown probe {name!r}; expected one of {PROBES}")


def probe(name: str, x: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Probe ``name`` of probe_fused_cast.py through the T2 kernel (a CUDA
    tensor) or its plain version (a CPU tensor)."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}; expected one of {PROBES}")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError("probes take f32 [rows, cols]")
    if not kernels.plain_or_kernel(x):
        return probe_ref(name, x, block)
    src = x.contiguous()
    rows, cols = src.shape
    if name == "h":  # the input holds one value per block
        cols *= block
    elif cols % block:
        raise ValueError(f"cols {cols} not a multiple of the block {block}")
    shape = (rows, cols // block) if name == "b" else (rows, cols)
    return _launch(src, _OP_PROBE_A + PROBES.index(name), rows, cols, 1, block, 0,
                   out_shape=shape)
