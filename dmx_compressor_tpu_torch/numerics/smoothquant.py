"""SmoothQuant: migration of quantization difficulty from activations to
weights (arXiv:2211.10438).

Port of ``dmx_compressor_tpu/numerics/smoothquant.py``.  The per-channel
scale is ``s = a_max^alpha / b_max^(1 - alpha)``, clamped below by
``scale_min`` and passed through the scale cast; input A is divided by ``s``
and input B multiplied by it, which keeps the product.  The running maxabs
and the scale are buffers, ``(0,)`` until the first observation; the flags
are plain attributes.  An idle SmoothQuant (not enabled, or no scale yet)
adds no operation to a forward.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from .cast import CastTo
from .format import Format


def _maxabs(x: torch.Tensor, dim: int) -> torch.Tensor:
    """max |x| over every axis but ``dim``."""
    dims = list(range(x.ndim))
    dims.pop(dim % x.ndim)
    return torch.amax(torch.abs(x), dim=dims)


def _empty() -> torch.Tensor:
    return torch.zeros(0, dtype=torch.float32)


class SmoothQuant(nn.Module):
    """Generic A x B scale migration."""

    def __init__(self, a_ch_axis: int, b_ch_axis: int, a_dynamic: bool = False,
                 b_dynamic: bool = False, migration_strength: float = 0.5,
                 scale_format: Union[str, Format] = "SAME", scale_min: float = 1e-5):
        super().__init__()
        self.a_ch_axis = a_ch_axis
        self.b_ch_axis = b_ch_axis
        self.a_dynamic = a_dynamic
        self.b_dynamic = b_dynamic
        self.enabled = False
        self.calibrating = False
        self.migration_strength = migration_strength
        self.scale_min = scale_min
        self.register_buffer("scale", _empty())
        self.register_buffer("a_maxabs", _empty())
        self.register_buffer("b_maxabs", _empty())
        self.scale_cast = CastTo()
        self.set_scale_format(scale_format)

    # -- config -------------------------------------------------------------

    def enable(self, enabled: bool = True) -> None:
        self.enabled = enabled

    def disable(self) -> None:
        self.enable(False)

    def set_dynamic(self, a_dynamic: bool = True, b_dynamic: bool = True) -> None:
        self.a_dynamic = a_dynamic
        self.b_dynamic = b_dynamic

    def set_scale_format(self, format: Union[str, Format] = "SAME") -> None:
        self.scale_cast.set_format(format)

    def set_migration_strength(self, migration_strength: float) -> None:
        if not 0.0 <= migration_strength <= 1.0:
            raise ValueError(
                f"migration_strength should be between 0 and 1, got {migration_strength}")
        self.migration_strength = migration_strength

    def reset_scale(self) -> None:
        self.scale = _empty()

    def reset_a_maxabs(self) -> None:
        self.a_maxabs = _empty()

    def reset_b_maxabs(self) -> None:
        self.b_maxabs = _empty()

    @property
    def a_maxabs_exists(self) -> bool:
        return self.a_maxabs.numel() > 0

    @property
    def b_maxabs_exists(self) -> bool:
        return self.b_maxabs.numel() > 0

    # -- scale math ---------------------------------------------------------

    def compute_scale(self, a_maxabs: torch.Tensor, b_maxabs: torch.Tensor) -> None:
        """scale = a^alpha / b^(1 - alpha), clamped below, then cast."""
        alpha = self.migration_strength
        b_maxabs = torch.clamp(b_maxabs, min=self.scale_min)
        scale = (a_maxabs ** alpha) / (b_maxabs ** (1.0 - alpha))
        scale = torch.clamp(scale, min=self.scale_min)
        self.scale = self.scale_cast(scale).to(torch.float32)

    def _scale_view(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        sz = [1] * x.ndim
        sz[dim % x.ndim] = self.scale.numel()
        return self.scale.reshape(sz)

    def scale_a(self, a: torch.Tensor) -> torch.Tensor:
        if self.enabled and self.scale.numel() > 0:
            return a / self._scale_view(a, self.a_ch_axis).to(a.dtype)
        return a

    def scale_b(self, b: torch.Tensor) -> torch.Tensor:
        if self.enabled and self.scale.numel() > 0:
            return b * self._scale_view(b, self.b_ch_axis).to(b.dtype)
        return b

    # -- observation --------------------------------------------------------

    def forward(self, a: torch.Tensor, b: torch.Tensor):
        """Update the running maxabs and the scale; A and B scaled."""
        a, b = a.detach(), b.detach()
        cur_a = _maxabs(a, self.a_ch_axis)
        cur_b = _maxabs(b, self.b_ch_axis)
        self.a_maxabs = (cur_a if not self.a_maxabs_exists or self.a_dynamic
                         else torch.maximum(cur_a, self.a_maxabs))
        self.b_maxabs = (cur_b if not self.b_maxabs_exists or self.b_dynamic
                         else torch.maximum(cur_b, self.b_maxabs))
        self.compute_scale(self.a_maxabs, self.b_maxabs)
        return self.scale_a(a), self.scale_b(b)


class ActivationWeightSmoothQuant(SmoothQuant):
    """The activation x weight specialization a DmxModule carries."""

    def __init__(self, ch_axis: int, win_ch_axis: int, migration_strength: float = 0.5,
                 scale_format: Union[str, Format] = "SAME", dynamic: bool = False,
                 scale_min: float = 1e-5):
        super().__init__(a_ch_axis=ch_axis, b_ch_axis=win_ch_axis,
                         migration_strength=migration_strength, scale_format=scale_format,
                         a_dynamic=dynamic, b_dynamic=False, scale_min=scale_min)
        self.ch_axis = ch_axis
        self.win_ch_axis = win_ch_axis
        self.fused_to_weight = False

    def set_dynamic(self, dynamic: bool = True) -> None:  # type: ignore[override]
        if dynamic and self.fused_to_weight:
            raise RuntimeError(
                "SmoothQuant cannot be dynamic as scale has been fused to weight already")
        super().set_dynamic(a_dynamic=dynamic, b_dynamic=False)

    def reset_weight_maxabs(self) -> None:
        self.reset_b_maxabs()

    @property
    def dynamic(self) -> bool:
        return self.a_dynamic

    @property
    def weight_maxabs_computed(self) -> bool:
        return self.b_maxabs_exists

    @property
    def input_maxabs_exists(self) -> bool:
        return self.a_maxabs_exists

    @property
    def weight_maxabs(self) -> torch.Tensor:
        return self.b_maxabs

    @property
    def input_maxabs(self) -> torch.Tensor:
        return self.a_maxabs

    def scale_weight(self, wgt: torch.Tensor) -> torch.Tensor:
        return self.scale_b(wgt)

    def scale_input(self, inp: torch.Tensor) -> torch.Tensor:
        return self.scale_a(inp)

    def fuse_to_weight(self, wgt: torch.Tensor) -> torch.Tensor:
        """The scale-fused weight; the fusion is recorded (the caller stores
        the weight)."""
        fused = self.scale_weight(wgt)
        self.fused_to_weight = True
        return fused

    def observe(self, inp: torch.Tensor, wgt: torch.Tensor) -> None:
        """Update the maxabs state and the scale."""
        inp, wgt = inp.detach(), wgt.detach()
        if not self.weight_maxabs_computed:
            self.b_maxabs = _maxabs(wgt, self.win_ch_axis)
        cur = _maxabs(inp, self.ch_axis)
        self.a_maxabs = (cur if not self.input_maxabs_exists or self.dynamic
                         else torch.maximum(cur, self.a_maxabs))
        self.compute_scale(self.a_maxabs, self.b_maxabs)

    def forward(self, inp: torch.Tensor, wgt: torch.Tensor):  # type: ignore[override]
        self.observe(inp, wgt)
