"""Fake-quantization cast modules.

Port of ``dmx_compressor_tpu/numerics/cast.py``.  A :class:`CastTo` owns a
target :class:`Format`, an observer (``numerics/observer.py``) and affine
qparams (``scale`` / ``zero_point`` buffers, per tensor, per channel or per
group).  The forward applies

    pre_transform -> observer step -> [affine normalize] -> format cast
    -> [affine denormalize] -> cast back to the caller's dtype

with a straight-through-estimator gradient (:class:`_STE`).
``enable_calibration`` swaps in a real observer and turns fake quantization
off until calibration ends.  :class:`Quantize` / :class:`DeQuantize` are the
drop-in integer quantize / dequantize ops.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from ..utils.tracing import try_set
from .format import FixedPoint, Format, Same
from .observer import (
    OBSERVERS,
    HistogramObserver,
    get_qmin_qmax,
    is_per_channel,
    is_per_tensor,
)


class _STE(torch.autograd.Function):
    """Value of ``q``, gradient of the identity on ``x``.  The value is
    computed as ``x + (q - x)``, the JAX package's form, so saturated and
    non-finite inputs round the same way on both sides."""

    @staticmethod
    def forward(ctx, x, q):
        return x + (q - x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return _STE.apply(x, q)


def _as_format(f: Union[str, Format]) -> Format:
    return Format.from_shorthand(f) if isinstance(f, str) else f


class CastTo(nn.Module):
    """Simulated numerical cast to a target format."""

    # on a rank-local activation of a tensor-parallel model: the gather that
    # shows the observer the whole tensor (parallel/mesh.py); None: unsharded
    tp_gather = None

    def __init__(
        self,
        format: Union[str, Format] = "SAME",
        observer: Union[str, type] = "dummy",
        group_size: Optional[int] = None,
        block_dim: int = -1,
        ch_axis: int = -1,
        qscheme: str = "per_tensor_affine",
    ):
        super().__init__()
        self.format = _as_format(format)
        self.qscheme = qscheme
        self.ch_axis = ch_axis if ch_axis is not None else -1
        if group_size and not is_per_tensor(qscheme):
            raise ValueError("group_size must be used with per tensor quantization scheme")
        self.group_size = group_size or None
        self.block_dim = block_dim
        self.fake_quant_enabled = True
        self.observer_enabled = False
        self.pre_transform: Dict[str, Any] = {}
        self.physical_dtype = None
        obs_cls = OBSERVERS[observer] if isinstance(observer, str) else observer
        self.observer = obs_cls(dtype=self.format, qscheme=qscheme, ch_axis=self.ch_axis)
        self.group_observers = []  # a ModuleList once group calibration starts
        self.register_buffer("scale", torch.ones(1, dtype=torch.float32))
        self.register_buffer("zero_point", torch.zeros(1, dtype=torch.int32))

    # -- configuration ------------------------------------------------------

    def set_format(self, format: Union[str, Format]) -> None:
        self.format = _as_format(format)
        self.observer.dtype = self.format
        self.observer.quant_min, self.observer.quant_max = get_qmin_qmax(self.format)

    def set_pre_transform(self, pre_transform: Dict) -> None:
        self.pre_transform = dict(pre_transform)
        if "format" in self.pre_transform:
            self.pre_transform["format"] = _as_format(self.pre_transform["format"])

    def enable_fake_quant(self, enabled: bool = True) -> None:
        self.fake_quant_enabled = enabled

    def disable_fake_quant(self) -> None:
        self.fake_quant_enabled = False

    def enable_observer(self, enabled: bool = True) -> None:
        self.observer_enabled = enabled

    def disable_observer(self) -> None:
        self.observer_enabled = False

    def enable_calibration(
        self,
        state: bool = True,
        observer_cls: type = HistogramObserver,
        qscheme_to_overload: Optional[str] = None,
        group_size: Optional[int] = None,
        ch_axis: Optional[int] = None,
    ) -> None:
        """Swap in a real observer and begin calibration (``state``), or end
        it: fake quantization back on, the observer off."""
        if state:
            if ch_axis is not None:
                self.ch_axis = ch_axis
            if qscheme_to_overload is not None:
                self.qscheme = qscheme_to_overload
            self.group_size = group_size or None
            if self.group_size and not is_per_tensor(self.qscheme):
                raise ValueError("group quantization is to be used with per tensor "
                                 "quantization")
            self._replace("observer", observer_cls(dtype=self.format, qscheme=self.qscheme,
                                                   ch_axis=self.ch_axis))
            self._replace("group_observers", [])
            self.disable_fake_quant()
            self.enable_observer()
        else:
            self.enable_fake_quant()
            self.disable_observer()

    def _replace(self, name: str, value) -> None:
        """Set attribute ``name`` whether it holds a submodule or a plain
        object now, and whether ``value`` is a module or not."""
        self._modules.pop(name, None)
        self.__dict__.pop(name, None)
        setattr(self, name, value)

    # -- observation --------------------------------------------------------

    def _observer_step(self, x: torch.Tensor) -> None:
        """Streaming qparam estimation: one observer, or one per group of
        ``group_size`` channels along ``ch_axis``."""
        if self.group_size:
            n = x.shape[self.ch_axis]
            group_num = math.ceil(n / self.group_size)
            if len(self.group_observers) != group_num:
                self._replace("group_observers", nn.ModuleList(
                    type(self.observer)(dtype=self.format, qscheme=self.qscheme,
                                        ch_axis=self.ch_axis)
                    for _ in range(group_num)))
            scales, zps = [], []
            ax = self.ch_axis % x.ndim
            for i, obs in enumerate(self.group_observers):
                lo = i * self.group_size
                obs(x.narrow(ax, lo, min(self.group_size, n - lo)))
                s, zp = obs.calculate_qparams()
                scales.append(s.reshape(-1))
                zps.append(zp.reshape(-1))
            self.scale = torch.cat(scales)
            self.zero_point = torch.cat(zps)
        else:
            self.observer(x.detach().to(torch.float32))
            s, zp = self.observer.calculate_qparams()
            self.scale = torch.atleast_1d(s)
            self.zero_point = torch.atleast_1d(zp)

    # -- affine qparams -----------------------------------------------------

    def _get_affine_params(self, x: torch.Tensor):
        # on x's device: a Dmx module substituted into a model on the card
        # holds its casts' initial qparams on the CPU until calibrated
        sc, zp = self.scale.to(x.device), self.zero_point.to(x.device)
        ax = self.ch_axis % x.ndim
        n = x.shape[ax]
        shape = [n if i == ax else 1 for i in range(x.ndim)]
        if self.qscheme.startswith("per_channel"):
            return sc[:n].reshape(shape), zp[:n].reshape(shape)
        if self.group_size:
            sc = torch.repeat_interleave(sc, self.group_size)[:n].reshape(shape)
            zp = torch.repeat_interleave(zp, self.group_size)[:n].reshape(shape)
        return sc, zp

    # -- shaping pre-transforms ---------------------------------------------

    @staticmethod
    def _apply_shaping_seq(x: torch.Tensor, shaping_list):
        reverse = []
        for op, args in shaping_list:
            orig_shape = tuple(x.shape)
            if op == "view":
                x = x.reshape(*args)
                reverse.append(("view", orig_shape))
            elif op == "permute":
                x = x.permute(*args)
                reverse.append(("permute", sorted(range(len(args)), key=lambda i: args[i])))
            elif op == "flatten":
                start = args[0] if args else 0
                end = args[1] if len(args) > 1 else -1
                x = torch.flatten(x, start, end)
                reverse.append(("view", orig_shape))
            else:
                raise ValueError(f"unknown shape op {op}")
        return x, reverse[::-1]

    # -- forward ------------------------------------------------------------

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point():
            return x
        physical_dtype = x.dtype
        try_set(self, "physical_dtype", physical_dtype)
        if isinstance(self.format, Same) and not self.pre_transform:
            return x  # a true identity: no STE node at all
        reverse_shaping = None
        shortcut_val = None
        if "shaping" in self.pre_transform:
            x, reverse_shaping = self._apply_shaping_seq(x, self.pre_transform["shaping"])
        if "noquant_shortcut" in self.pre_transform:
            shortcut_val = x[self.pre_transform["noquant_shortcut"]]
        if "format" in self.pre_transform:
            x = ste(x, self.pre_transform["format"].cast(x, self.block_dim, generator))
        if self.observer_enabled and not isinstance(self.format, Same):
            self._observer_step(x if self.tp_gather is None else self.tp_gather(x))
        if self.fake_quant_enabled:
            if isinstance(self.format, FixedPoint):
                sc, zp = self._get_affine_params(x)
                sc = sc.to(x.dtype)
                zp = zp.to(x.dtype)
                y = x / sc + zp
                y = ste(y, self.format.cast(y, self.block_dim, generator))
                x = (y - zp) * sc
            else:
                x = ste(x, self.format.cast(x, self.block_dim, generator))
        if shortcut_val is not None:
            x = x.clone()
            x[self.pre_transform["noquant_shortcut"]] = shortcut_val
        if reverse_shaping is not None:
            x, _ = self._apply_shaping_seq(x, reverse_shaping)
        return x.to(physical_dtype)

    def get_precision(self) -> Optional[float]:
        if isinstance(self.format, Same):
            if self.physical_dtype is not None:
                return torch.finfo(self.physical_dtype).bits
            raise RuntimeError(
                "physical_dtype has not been inferred, pass some data through first"
            )
        return self.format.bit_precision

    def extra_repr(self):
        return (
            f"format={repr(self.format)}, block_dim={self.block_dim}, "
            f"qscheme={self.qscheme}, ch_axis={self.ch_axis}, "
            f"group_size={self.group_size}, fake_quant={self.fake_quant_enabled}, "
            f"observer={self.observer_enabled}"
        )


class Quantize(nn.Module):
    """Drop-in quantize op producing integer payloads:
    ``clip(round(x / scale + zero_point))`` as int32."""

    def __init__(self, scale, zero_point, dtype: Union[str, Format]):
        super().__init__()
        self.register_buffer("scale", torch.atleast_1d(
            torch.as_tensor(scale, dtype=torch.float32)))
        self.register_buffer("zero_point", torch.atleast_1d(
            torch.as_tensor(zero_point).to(torch.int32)))
        self.dtype = _as_format(dtype)

    def forward(self, x):
        qmin, qmax = get_qmin_qmax(self.dtype)
        q = torch.round(x / self.scale.to(x.device) + self.zero_point.to(x.device))
        if qmin is not None:
            q = torch.clamp(q, qmin, qmax)
        return q.to(torch.int32)


class DeQuantize(nn.Module):
    """Drop-in dequantize op: ``(q - zero_point) * scale`` in f32."""

    def __init__(self, scale=None, zero_point=None, dtype=None):
        super().__init__()
        self.register_buffer("scale", torch.atleast_1d(torch.as_tensor(
            scale if scale is not None else 1.0, dtype=torch.float32)))
        self.register_buffer("zero_point", torch.atleast_1d(torch.as_tensor(
            zero_point if zero_point is not None else 0).to(torch.int32)))

    def forward(self, q):
        return ((q.to(torch.float32) - self.zero_point.to(q.device))
                * self.scale.to(q.device))


class CastToDict(nn.Module):
    """Named casts routing the inputs (or outputs) of a multi-input module."""

    def __init__(self, casts: Dict[str, CastTo]):
        super().__init__()
        self._names = list(casts.keys())
        for k, v in casts.items():
            self.add_module(k, v)

    def keys(self):
        return list(self._names)

    def items(self):
        return [(k, getattr(self, k)) for k in self._names]

    def __getitem__(self, k) -> CastTo:
        return getattr(self, k)

    def __contains__(self, k):
        return k in self._names

    def __len__(self):
        return len(self._names)

    def forward(self, x, *args, output: bool = False, **kwargs):
        keys = self._names
        if output:
            if isinstance(x, (tuple, list)):
                return type(x)(self[keys[i]](a) for i, a in enumerate(x))
            return self[keys[0]](x)
        i = 1
        new_args = []
        for a in args:
            if isinstance(a, torch.Tensor):
                new_args.append(self[keys[i]](a))
                i += 1
            else:
                new_args.append(a)
        new_kwargs = {
            k: self[f"{k}_cast"](v)
            if isinstance(v, torch.Tensor) and f"{k}_cast" in self else v
            for k, v in kwargs.items()
        }
        return self[keys[0]](x), new_args, new_kwargs

    def _pack_to_dict(self, param):
        if isinstance(param, (tuple, list)):
            return {self._names[i]: (p if p is not None else "SAME") for i, p in enumerate(param)}
        if not isinstance(param, dict):
            raise ValueError("format needs to be a dict, tuple or list!")
        return param

    def set_format(self, format) -> None:
        for k, f in self._pack_to_dict(format).items():
            if k not in self:
                raise RuntimeError(f"No CastTo with key {k}!")
            self[k].set_format(f)

    def set_pre_transform(self, pre_transforms) -> None:
        for k, t in self._pack_to_dict(pre_transforms).items():
            self[k].set_pre_transform(t)

    def disable_fake_quant(self):
        for k in self._names:
            self[k].disable_fake_quant()

    def enable_fake_quant(self):
        for k in self._names:
            self[k].enable_fake_quant()

    def enable_observer(self):
        for k in self._names:
            self[k].enable_observer()

    def disable_observer(self):
        for k in self._names:
            self[k].disable_observer()
