"""Convolutions lowered to a GEMM on gathered patches.

Port of ``dmx_compressor_tpu/nn/experimental.py``: a convolution
re-expressed as im2col (or a gather) + matmul, so the hot op is a plain
GEMM with Linear's cast topology (input blocks along the patch axis, the
weight's along its input axis).  Whisper's encoder front end uses
``Conv1dUnfold``, CLIP's patch embedding ``Conv2dUnfold``.  The weight is
stored GEMM-shaped, ``[out, in * prod(k)]``, channel-major and tap-minor
along its second axis (``_im2col``'s patch layout, and a torch conv weight
``[out, in, *k]`` flattened).  The GEMM is ``torch.matmul``: the JAX package
computes it outside any Pallas kernel too.

- ``Conv1dUnfold`` / ``Conv2dUnfold``: the patches of ``_im2col``, one
  contraction;
- ``Conv1dScatter``: the same patch rows and casts, each kernel tap's
  channel-matmul an f32 partial, the partials summed in tap order (the
  scatter formulation's dataflow: the unfold form's products, summed in
  another order);
- ``Conv2dGather``: the patch rows fetched by one flat index gather (the
  gather formulation), bit-equal to the unfold form.

``from_conv`` re-lowers a Dmx conv (``nn.modules._ConvNd``), ``from_raw`` a
torch ``nn.Conv1d`` / ``nn.Conv2d``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn

from ..numerics.format import Same
from .core import DmxModule
from .modules import Conv1d, Conv2d, _ConvNd, _generator, _im2col, _init_weight, _pair


class _UnfoldConvBase(DmxModule):
    """Shared: conv as patches-matmul with Linear-style casts on the GEMM."""

    ch_axis = -1  # casts act on the unfolded patch axis
    win_ch_axis = -1
    wout_ch_axis = 0
    has_accum = True
    has_weight = True
    has_bias = True
    sparsifiable = True
    _nd = 1

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0,
                 dilation=1, groups: int = 1, bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        nd = self._nd
        if groups != 1:
            raise ValueError("the unfold lowering takes groups=1")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size, nd)
        self.stride = _pair(stride, nd)
        self.padding = _pair(padding, nd)
        self.dilation = _pair(dilation, nd)
        self.groups = groups
        self.has_bias = bias
        super().__init__()
        generator = _generator(generator, device)
        fan_in = in_channels * math.prod(self.kernel_size)
        # weight stored GEMM-shaped: [out, in * prod(k)]
        self.weight = nn.Parameter(_init_weight(generator, (out_channels, fan_in), fan_in, device))
        self.bias = (nn.Parameter(_init_weight(generator, (out_channels,), fan_in, device))
                     if bias else None)
        self.input_casts["input_cast"].block_dim = -1
        self.weight_cast.block_dim = -1

    def _out_spatial(self, in_sp):
        return tuple(
            (s + 2 * p - d * (k - 1) - 1) // st + 1
            for s, p, d, k, st in zip(in_sp, self.padding, self.dilation, self.kernel_size,
                                      self.stride)
        )

    def _patches(self, x: torch.Tensor) -> torch.Tensor:
        """The GEMM's rows: [B, L, C * prod(k)], channel-major."""
        return _im2col(x, self.kernel_size, self.stride, self.padding,
                       self.dilation).transpose(1, 2)

    def _contract(self, _x: torch.Tensor) -> torch.Tensor:
        """The cast patch rows times the cast weight: [B, L, out]."""
        if isinstance(self.accum_format, Same):
            return _x @ self._weight.T.to(_x.dtype)
        return self.accum_cast(_x @ self._weight.T)

    def forward(self, input, *args, **kwargs):
        """Gather the patches outside the cast pipeline: the casts see the
        GEMM operands (the patch rows and the weight), as in the JAX
        package."""
        _dtype = input.dtype
        B, in_sp = input.shape[0], input.shape[2:]
        _x, _, _ = self.input_casts(self._patches(input))
        y = self._contract(_x)
        if self.bias is not None:
            y = y + self._bias.to(y.dtype)
        y = self.output_casts(y, output=True)
        y = y.transpose(1, 2).reshape(B, self.out_channels, *self._out_spatial(in_sp))
        return y.to(_dtype)

    def _flops_for(self, input_shape, output_shape):
        return math.prod(output_shape) * self.in_channels * math.prod(self.kernel_size)

    @classmethod
    def from_conv(cls, conv: _ConvNd):
        """Re-lower a Dmx conv into this form: its weight reshaped to the
        GEMM layout (a copy), its bias copied; the casts start SAME."""
        mod = cls(conv.in_channels, conv.out_channels, conv.kernel_size, stride=conv.stride,
                  padding=conv.padding, dilation=conv.dilation, groups=conv.groups,
                  bias=conv.bias is not None, device="meta")
        mod.weight = nn.Parameter(conv.weight.detach().reshape(conv.out_channels, -1).clone())
        if conv.bias is not None:
            mod.bias = nn.Parameter(conv.bias.detach().clone())
        return mod

    @classmethod
    def from_raw(cls, raw):
        """Re-lower a torch ``nn.Conv1d`` / ``nn.Conv2d`` (through the Dmx
        conv of its dimension)."""
        return cls.from_conv({1: Conv1d, 2: Conv2d}[cls._nd].from_raw(raw))


class Conv1dUnfold(_UnfoldConvBase):
    """conv1d as unfold + matmul (the Whisper conv lowering)."""

    _nd = 1


class Conv2dUnfold(_UnfoldConvBase):
    """conv2d as im2col + matmul (the CLIP patch-embedding lowering)."""

    _nd = 2


class Conv1dScatter(Conv1dUnfold):
    """conv1d as per-tap matmuls accumulated in f32: each kernel tap's
    strided input slice through its own channel-matmul, the partials summed
    in tap order.  The patch rows (and so the input cast's blocks) are the
    unfold form's; the products too, summed in another order."""

    def _patches(self, x):
        B, C, T = x.shape
        (k,), (s,), (p,), (d,) = self.kernel_size, self.stride, self.padding, self.dilation
        (L,) = self._out_spatial((T,))
        xp = torch.nn.functional.pad(x, (p, p))
        taps = [xp[:, :, j * d: j * d + (L - 1) * s + 1: s] for j in range(k)]  # [B, C, L] each
        return torch.stack(taps, dim=2).permute(0, 3, 1, 2).reshape(B, L, C * k)

    def _contract(self, _x):
        B, L, _ = _x.shape
        (k,) = self.kernel_size
        _w = self._weight.reshape(self.out_channels, self.in_channels, k)
        _xt = _x.reshape(B, L, self.in_channels, k)
        y = None
        for j in range(k):  # scatter-accumulate the tap partials
            part = torch.einsum("blc,oc->blo", _xt[..., j].to(torch.float32),
                                _w[..., j].to(torch.float32))
            y = part if y is None else y + part
        return y if isinstance(self.accum_format, Same) else self.accum_cast(y)


class Conv2dGather(Conv2dUnfold):
    """conv2d as one flat index gather + matmul: the patch rows fetched
    through a precomputed spatial index table, in ``_im2col``'s element
    order, so the output is bit-equal to the unfold form's."""

    def _patches(self, x):
        B, C = x.shape[:2]
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        (ph, pw), (dh, dw) = self.padding, self.dilation
        Ho, Wo = self._out_spatial(x.shape[2:])
        xp = torch.nn.functional.pad(x, (pw, pw, ph, ph))
        Hp, Wp = xp.shape[2:]
        ar = functools.partial(torch.arange, device=x.device)
        oy = (ar(Ho) * sh)[:, None, None, None]
        ox = (ar(Wo) * sw)[None, :, None, None]
        ky = (ar(kh) * dh)[None, None, :, None]
        kx = (ar(kw) * dw)[None, None, None, :]
        idx = ((oy + ky) * Wp + (ox + kx)).reshape(-1)
        patches = xp.reshape(B, C, Hp * Wp).index_select(2, idx).reshape(B, C, Ho * Wo, kh * kw)
        return patches.permute(0, 2, 1, 3).reshape(B, Ho * Wo, C * kh * kw)
