"""Tensor numerical formats and their shorthand grammar.

Port of ``dmx_compressor_tpu/numerics/format.py``: the same frozen,
hashable format classes and the same shorthand grammar; ``cast`` works on
torch tensors through :mod:`.rounding`.

The symmetric nearest BFP cast over blocks that divide the cast axis and
the FLOAT16 cast of f32 values run ``ops/bfp_cast.py`` (kernel T2 on the
card, its plain version on the CPU); every other format is plain torch.

Shorthand grammar:

- ``SAME``                                      identity
- ``XP[p,f](CSN)``                              fixed point; C=clamp, S=symmetric,
                                                last letter = rounding U/D/N/S
- ``FP[s|e|m,bias](FN)``                        float; F=flush subnormal
- ``BFP[p|8]{B}(SN)``                           block floating point (the legacy
                                                ``{B,dim}`` form is accepted)
- ``SBFP<XP[...]><FP[...]>{B}``                 scaled BFP
- ``MXFP8[E4M3]{32}`` / ``MXINT8{32}``          OCP microscaling
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import torch

from . import rounding as R
from .onnx_ids import BFP_TYPE_IDS
from ..ops import bfp_cast as T2

ROUNDING_MODE = {"U": "up", "D": "down", "N": "nearest", "S": "stochastic"}
ROUNDING_MODE_INV = {v: k for k, v in ROUNDING_MODE.items()}

_FLOAT16_REPR = "FP[1|5|10,15](FN)"
_FP16_MIN_NORMAL = 6.103515625e-05


def _rounding(letter: str) -> str:
    try:
        return ROUNDING_MODE[letter]
    except KeyError:
        raise ValueError(
            f"unknown rounding letter {letter!r}; expected one of "
            f"{sorted(ROUNDING_MODE)} (U=up, D=down, N=nearest, S=stochastic)"
        ) from None


def _parse(pattern: str, sh: str, what: str) -> re.Match:
    m = re.fullmatch(pattern, sh.strip())
    if m is None:
        raise ValueError(f"malformed {what} shorthand: {sh!r}")
    return m


class Format:
    """Abstract tensor numerical format.  ``bfp_id`` is the format's frozen
    id of the Q/DQ export contract (``numerics/onnx_ids.py``); a format
    without one has None, and a BFP or SBFP format outside the frozen enum
    raises KeyError, as in the JAX package."""

    blocked: bool = False
    bfp_id: Optional[int] = None

    def cast(self, x: torch.Tensor, block_dim: int = -1,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    @property
    def bytes_per_elem(self):
        raise NotImplementedError

    @property
    def bit_precision(self) -> Optional[float]:
        raise NotImplementedError

    @staticmethod
    def from_shorthand(sh: str) -> "Format":
        sh = sh.strip()
        for prefix, cls in (
            ("SAME", Same),
            ("XP", FixedPoint),
            ("FP", FloatingPoint),
            ("BFP", BlockFloatingPoint),
            ("SBFP", ScaledBlockFloatingPoint),
            ("MXFP", MXFP),
            ("MXINT", MXINT),
        ):
            if sh.startswith(prefix):
                return cls.from_shorthand(sh)
        raise ValueError(f"unrecognized format shorthand: {sh}")


@dataclass(frozen=True)
class Same(Format):
    """Identity format: cast is a no-op."""

    def cast(self, x, block_dim=-1, generator=None):
        return x

    @property
    def bytes_per_elem(self):
        return None

    @property
    def bit_precision(self):
        return None

    @classmethod
    def from_shorthand(cls, sh: str):
        return cls()

    def __repr__(self):
        return "SAME"


@dataclass(frozen=True)
class FixedPoint(Format):
    """Fixed point simulated in fp32."""

    precision: int
    fraction: int
    clamp: bool = True
    symmetric: bool = True
    rounding: str = "nearest"

    def __post_init__(self):
        if not 1 <= self.precision <= 24:
            raise ValueError(
                f"highest integer precision simulated by FP32 is 24, got {self.precision}"
            )

    def cast(self, x, block_dim=-1, generator=None):
        return R.fixed_point_quantize(
            x, wl=self.precision, fl=self.fraction, clamp=self.clamp,
            symmetric=self.symmetric, rounding=self.rounding, generator=generator,
        )

    @property
    def bytes_per_elem(self):
        return self.precision / 8.0

    @property
    def bit_precision(self):
        return float(self.precision)

    @classmethod
    def from_shorthand(cls, sh: str):
        m = _parse(r"XP\[(-?\d+),(-?\+?\d+)\]\((\w)(\w)(\w)\)", sh, "XP")
        return cls(
            precision=int(m.group(1)),
            fraction=int(m.group(2)),
            clamp=m.group(3) == "C",
            symmetric=m.group(4) == "S",
            rounding=_rounding(m.group(5)),
        )

    def __repr__(self):
        frac = "0" if self.fraction == 0 else f"{self.fraction:+d}"
        return (
            f"XP[{self.precision},{frac}]"
            f"({'C' if self.clamp else '_'}{'S' if self.symmetric else '_'}"
            f"{ROUNDING_MODE_INV[self.rounding]})"
        )


@dataclass(frozen=True)
class FloatingPoint(Format):
    """Low-bit float simulated in fp32."""

    mantissa: int = 23
    exponent: int = 8
    bias: Optional[int] = None
    flush_subnormal: bool = True
    unsigned: bool = False
    rounding: str = "nearest"

    def __post_init__(self):
        if not (0 <= self.mantissa <= 23 and 0 < self.exponent <= 8):
            raise ValueError(f"unsupported float format m={self.mantissa} e={self.exponent}")
        if self.bias is None:
            object.__setattr__(self, "bias", 2 ** (self.exponent - 1) - 1)
        bias_min = 127 if self.exponent == 8 else -128 + 2**self.exponent
        if not bias_min <= self.bias <= 127:
            raise ValueError(
                f"exponent bias for {self.exponent}-bit exponent must be within "
                f"[{bias_min}, 127], got {self.bias}"
            )

    def cast(self, x, block_dim=-1, generator=None):
        r = repr(self)
        if (x.dtype == torch.float32 and r == "FP[1|8|23,127](_N)") or (
            x.dtype == torch.float16 and r == _FLOAT16_REPR
        ):
            out = x
        elif r == _FLOAT16_REPR and x.dtype == torch.float32:
            # the hardware fp16 cast IS the format (nearest-even on the same
            # grid); saturate at the fp16 max and flush subnormals below
            return T2.fp16_cast(x)
        else:
            out = R.float_quantize(
                x.to(torch.float32), man=self.mantissa, exp=self.exponent,
                bias=self.bias, flush_subnormal=self.flush_subnormal,
                rounding=self.rounding, generator=generator,
            ).to(x.dtype)
        if r == _FLOAT16_REPR:
            out = torch.where(torch.abs(out) < _FP16_MIN_NORMAL, torch.zeros_like(out), out)
        return torch.abs(out) if self.unsigned else out

    @property
    def bytes_per_elem(self):
        return (self.mantissa + self.exponent + 1) / 8.0

    @property
    def bit_precision(self):
        return float(self.mantissa + self.exponent + (0 if self.unsigned else 1))

    @classmethod
    def from_shorthand(cls, sh: str):
        m = _parse(r"FP\[(\d)\|(\d+)\|(\d+),(-?\d+)\]\((\w)([A-Za-z])\)", sh, "FP")
        return cls(
            mantissa=int(m.group(3)),
            exponent=int(m.group(2)),
            bias=int(m.group(4)),
            flush_subnormal=m.group(5) == "F",
            unsigned=m.group(1) == "0",
            rounding=_rounding(m.group(6)),
        )

    def __repr__(self):
        return (
            f"FP[{'0' if self.unsigned else '1'}|{self.exponent}|{self.mantissa},"
            f"{self.bias}]({'F' if self.flush_subnormal else '_'}"
            f"{ROUNDING_MODE_INV[self.rounding]})"
        )


@dataclass(frozen=True)
class BlockFloatingPoint(Format):
    """``precision``-bit mantissas sharing an 8-bit exponent over blocks of
    ``block_size`` contiguous elements along the cast site's ``block_dim``."""

    precision: int = 8
    block_size: int = 64
    symmetric: bool = True
    rounding: str = "nearest"
    blocked = True

    def __post_init__(self):
        if not (2 <= self.precision <= 25 and self.block_size > 0):
            raise ValueError(f"unsupported BFP p={self.precision} B={self.block_size}")

    @property
    def bfp_id(self):
        name = (
            f"DMX_BFP_{self.precision + 8}"
            f"{'' if self.symmetric else 'A'}_{self.block_size}"
        )
        return BFP_TYPE_IDS[name]

    def cast(self, x, block_dim=-1, generator=None):
        if self.block_size == 1:
            # a one-element block is a float with an 8-bit exponent
            return R.float_quantize(
                x.to(torch.float32), man=self.precision - 2, exp=8, bias=127,
                flush_subnormal=False, rounding=self.rounding, generator=generator,
            ).to(x.dtype)
        if self.symmetric and x.ndim >= 1 and x.shape[block_dim] % self.block_size == 0:
            if self.rounding == "nearest":
                return T2.bfp_cast(x, self.precision, self.block_size, block_dim)
            bd = block_dim % x.ndim
            q = R.block_quantize_lastdim(
                torch.movedim(x, bd, -1), self.precision, self.block_size,
                self.rounding, generator,
            )
            return torch.movedim(q, -1, bd)

        def _fn(blocks):
            q = R.block_quantize(blocks, wl=self.precision, rounding=self.rounding,
                                 generator=generator)
            if not self.symmetric:
                q = R.make_mantissa_asymmetric(q, blocks, self.precision)
            return q

        return R.apply_blockwise(
            x.to(torch.float32), block_dim, self.block_size, _fn
        ).to(x.dtype)

    @property
    def bytes_per_elem(self):
        return (self.precision + 8.0 / self.block_size) / 8.0

    @property
    def bit_precision(self):
        return self.precision + 8.0 / self.block_size

    @classmethod
    def from_shorthand(cls, sh: str):
        # the legacy grammar carried the block dim inside the braces
        # ("BFP[8|8]{64,-1}(SN)"); the dim lives on the cast site, so it is
        # accepted and ignored
        m = _parse(r"BFP\[(\d+)\|8\]\{(\d+)(?:,(-?\d+))?\}\((\w)([A-Za-z])\)", sh, "BFP")
        return cls(
            precision=int(m.group(1)),
            block_size=int(m.group(2)),
            symmetric=m.group(4) == "S",
            rounding=_rounding(m.group(5)),
        )

    def __repr__(self):
        return (
            f"BFP[{self.precision}|8]{{{self.block_size}}}"
            f"({'S' if self.symmetric else '_'}{ROUNDING_MODE_INV[self.rounding]})"
        )


@dataclass(frozen=True)
class ScaledBlockFloatingPoint(Format):
    """Per-block integer mantissas times a low-bit float scale."""

    block_format: FixedPoint
    scaler_format: FloatingPoint
    block_size: int = 64
    blocked = True

    def __post_init__(self):
        if not (
            isinstance(self.block_format, FixedPoint)
            and isinstance(self.scaler_format, FloatingPoint)
            and self.block_format.fraction == 0
            and self.block_format.symmetric
            and self.block_size > 0
        ):
            raise ValueError(f"unsupported SBFP format {self!r}")

    @property
    def man_scaling(self):
        return 2 ** (self.block_format.precision - 1) - 1  # largest mantissa abs

    @property
    def bfp_id(self):
        name = (
            f"DMX_SBFP_{self.block_format.precision + 8}_"
            f"{self.block_size}_{self.scaler_format.bias}"
        )
        return BFP_TYPE_IDS[name]

    def cast(self, x, block_dim=-1, generator=None):
        def _fn(blocks):
            chunk_max = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / self.man_scaling
            safe_max = torch.where(chunk_max > 0.0, chunk_max, torch.ones_like(chunk_max))
            q = self.block_format.cast(blocks / safe_max, generator=generator) * (
                self.scaler_format.cast(chunk_max, generator=generator)
            )
            return torch.where(chunk_max > 0.0, q, blocks)

        return R.apply_blockwise(
            x.to(torch.float32), block_dim, self.block_size, _fn
        ).to(x.dtype)

    @property
    def bytes_per_elem(self):
        return (self.block_format.bytes_per_elem
                + self.scaler_format.bytes_per_elem / self.block_size)

    @property
    def bit_precision(self):
        return (
            self.block_format.bit_precision
            + self.scaler_format.bit_precision / self.block_size
        )

    @classmethod
    def from_shorthand(cls, sh: str):
        m = _parse(r"SBFP<([^>]+)><([^>]+)>\{(\d+)\}", sh, "SBFP")
        return cls(
            block_format=FixedPoint.from_shorthand(m.group(1)),
            scaler_format=FloatingPoint.from_shorthand(m.group(2)),
            block_size=int(m.group(3)),
        )

    def __repr__(self):
        return (
            f"SBFP<{repr(self.block_format)}><{repr(self.scaler_format)}>"
            f"{{{self.block_size}}}"
        )


@dataclass(frozen=True)
class MXFP(Format):
    """OCP microscaling float: power-of-two shared scale times low-bit floats."""

    element_format: FloatingPoint
    block_size: int = 32
    blocked = True

    def cast(self, x, block_dim=-1, generator=None):
        def _fn(blocks):
            chunk_max = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
            emax = 2 ** (self.element_format.exponent - 1)
            scale = R._mul_pow2(torch.ones_like(chunk_max), R._exponent_of(chunk_max) - emax)
            scale = torch.where(chunk_max > 0.0, scale, torch.ones_like(scale))
            q = self.element_format.cast(blocks / scale, generator=generator) * scale
            return torch.where(chunk_max > 0.0, q, blocks)

        return R.apply_blockwise(
            x.to(torch.float32), block_dim, self.block_size, _fn
        ).to(x.dtype)

    @property
    def bytes_per_elem(self):
        return self.element_format.bytes_per_elem + 1.0 / self.block_size

    @property
    def bit_precision(self):
        ef = self.element_format
        return (ef.mantissa + ef.exponent + 1) + 8.0 / self.block_size

    @classmethod
    def from_shorthand(cls, sh: str):
        m = _parse(r"MXFP(\d+)\[E(\d+)M(\d+)\]\{(\d+)\}", sh, "MXFP")
        precision, e_bits, m_bits = int(m.group(1)), int(m.group(2)), int(m.group(3))
        if precision != e_bits + m_bits + 1:
            raise ValueError(f"malformed MXFP shorthand: {sh!r}")
        return cls(
            element_format=FloatingPoint(
                mantissa=m_bits, exponent=e_bits, bias=2 ** (e_bits - 1) - 1,
                flush_subnormal=False, unsigned=False, rounding="nearest",
            ),
            block_size=int(m.group(4)),
        )

    def __repr__(self):
        ef = self.element_format
        return (
            f"MXFP{ef.exponent + ef.mantissa + 1}[E{ef.exponent}M{ef.mantissa}]"
            f"{{{self.block_size}}}"
        )


@dataclass(frozen=True)
class MXINT(BlockFloatingPoint):
    """OCP microscaling int: BFP with nearest rounding."""

    def __init__(self, precision: int = 8, block_size: int = 32):
        super().__init__(precision=precision, block_size=block_size,
                         symmetric=True, rounding="nearest")

    @classmethod
    def from_shorthand(cls, sh: str):
        m = _parse(r"MXINT(\d+)\{(\d+)\}", sh, "MXINT")
        return cls(precision=int(m.group(1)), block_size=int(m.group(2)))

    def __repr__(self):
        return f"MXINT{self.precision}{{{self.block_size}}}"
