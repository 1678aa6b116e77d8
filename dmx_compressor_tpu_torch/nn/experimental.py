"""Convolutions lowered to a GEMM on unfolded patches.

Port of ``_UnfoldConvBase`` and ``Conv1dUnfold`` of
``dmx_compressor_tpu/nn/experimental.py``: a convolution re-expressed as
im2col + matmul, so the hot op is a plain GEMM with Linear's cast topology
(input blocks along the patch axis, the weight's along its input axis).
Whisper's encoder front end uses it.  The weight is stored GEMM-shaped,
``[out, in * prod(k)]``, channel-major and tap-minor along its second axis
(``_im2col``'s patch layout, and HF's conv weight ``[out, in, k]``
flattened).  The GEMM is ``torch.matmul``: the JAX package computes it
outside any Pallas kernel too.

The JAX package's ``from_conv`` / ``from_raw`` re-lower a standard Dmx conv
(``_ConvNd``); they arrive with the conv modules of the op zoo, as do
``Conv2dUnfold``, ``Conv1dScatter`` and ``Conv2dGather``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..numerics.format import Same
from .core import DmxModule
from .modules import _im2col, _init_weight, _pair


class _UnfoldConvBase(DmxModule):
    """Shared: conv as patches-matmul with Linear-style casts on the GEMM."""

    ch_axis = -1  # casts act on the unfolded patch axis
    win_ch_axis = -1
    wout_ch_axis = 0
    has_accum = True
    has_weight = True
    has_bias = True
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
        if generator is None:
            generator = torch.Generator(device=device or "cpu").manual_seed(0)
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

    def forward(self, input, *args, **kwargs):
        """Unfold outside the cast pipeline: the casts see the GEMM operands
        (the patches [B, L, C * prod(k)] and the weight), as in the JAX
        package."""
        self._check_hooks()
        _dtype = input.dtype
        B, in_sp = input.shape[0], input.shape[2:]
        patches = _im2col(input, self.kernel_size, self.stride, self.padding, self.dilation)
        x = patches.transpose(1, 2)  # [B, L, C * prod(k)]
        _x, _, _ = self.input_casts(x)
        if isinstance(self.accum_format, Same):
            y = _x @ self._weight.T.to(_x.dtype)
        else:
            y = self.accum_cast(_x @ self._weight.T)
        if self.bias is not None:
            y = y + self._bias.to(y.dtype)
        y = self.output_casts(y, output=True)
        y = y.transpose(1, 2).reshape(B, self.out_channels, *self._out_spatial(in_sp))
        return y.to(_dtype)


class Conv1dUnfold(_UnfoldConvBase):
    """conv1d as unfold + matmul (the Whisper conv lowering)."""

    _nd = 1
