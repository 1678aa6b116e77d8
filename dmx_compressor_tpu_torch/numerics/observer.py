"""Calibration observers: streaming range / histogram statistics for the
quantizers.

Port of ``dmx_compressor_tpu/numerics/observer.py``.  Observers are
``nn.Module`` s whose statistics live in buffers.  Quantization schemes mirror
``torch.qscheme``: ``per_tensor_affine | per_tensor_symmetric |
per_channel_affine | per_channel_symmetric``.

Each statistic is computed where, and in the precision, the JAX package
computes it: ``MinMaxObserver`` and ``PercentileObserver`` in f32 on the
tensor's device; ``HistogramObserver``'s first batch as ``jnp.histogram`` does
(f32 edges by XLA's ``linspace`` arithmetic, ``searchsorted`` on the device),
every later batch and the range search in float64 numpy on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .format import FixedPoint, Format

EPS = float(np.finfo(np.float32).eps)

PER_TENSOR = ("per_tensor_affine", "per_tensor_symmetric")
PER_CHANNEL = ("per_channel_affine", "per_channel_symmetric")
SYMMETRIC = ("per_tensor_symmetric", "per_channel_symmetric")


def is_per_tensor(qscheme: str) -> bool:
    return qscheme in PER_TENSOR


def is_per_channel(qscheme: str) -> bool:
    return qscheme in PER_CHANNEL


def get_qmin_qmax(fmt: Format) -> Tuple[Optional[int], Optional[int]]:
    """Integer range implied by a format: a clamped integer fixed point only."""
    if isinstance(fmt, FixedPoint) and fmt.fraction == 0 and fmt.clamp:
        quant_min = -(2 ** (fmt.precision - 1))
        quant_max = 2 ** (fmt.precision - 1) - 1
        if fmt.symmetric:
            quant_min += 1
        return quant_min, quant_max
    return None, None


def _f32(v: float, device) -> torch.Tensor:
    """An f32 constant on ``device``: a divisor there, not a CPU scalar (CUDA
    divides by a CPU scalar as a product with its reciprocal)."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def _ones_zeros(device=None):
    return (torch.ones(1, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def calculate_qparams_from_min_max(min_val, max_val, quant_min: Optional[int],
                                   quant_max: Optional[int], qscheme: str):
    """Scale / zero-point from observed ranges, in f32."""
    if quant_min is None or quant_max is None:
        return _ones_zeros(min_val.device if isinstance(min_val, torch.Tensor) else None)
    min_val = torch.atleast_1d(torch.as_tensor(min_val, dtype=torch.float32))
    max_val = torch.atleast_1d(torch.as_tensor(max_val, dtype=torch.float32)).to(min_val.device)
    invalid = (min_val == torch.inf) | (max_val == -torch.inf) | (min_val > max_val)
    min_val_neg = torch.clamp(min_val, max=0.0)
    max_val_pos = torch.clamp(max_val, min=0.0)
    if qscheme in SYMMETRIC:
        amax = torch.maximum(-min_val_neg, max_val_pos)
        scale = amax / _f32(float(quant_max - quant_min) / 2, amax.device)
        scale = torch.clamp(scale, min=EPS)
        zero_point = torch.zeros_like(scale, dtype=torch.int32)
    else:
        scale = (max_val_pos - min_val_neg) / _f32(float(quant_max - quant_min),
                                                   min_val.device)
        scale = torch.clamp(scale, min=EPS)
        zero_point = quant_min - torch.round(min_val_neg / scale).to(torch.int32)
        zero_point = torch.clamp(zero_point, quant_min, quant_max)
    scale = torch.where(invalid, torch.ones_like(scale), scale)
    zero_point = torch.where(invalid, torch.zeros_like(zero_point), zero_point)
    return scale, zero_point


class ObserverBase(nn.Module):
    """Base: holds the format-derived quantization range."""

    def __init__(self, dtype: Format, qscheme: str = "per_tensor_affine", ch_axis: int = -1):
        super().__init__()
        if not isinstance(dtype, Format):
            raise TypeError(f"illegal format {dtype}")
        self.dtype = dtype
        self.qscheme = qscheme
        self.ch_axis = ch_axis
        self.quant_min, self.quant_max = get_qmin_qmax(dtype)

    def forward(self, x):
        raise NotImplementedError

    def calculate_qparams(self):
        raise NotImplementedError

    def reset(self):
        pass


class DummyObserver:
    """No-op observer: stateless, so a plain object rather than a module (a
    cast holds one until calibration swaps in a real observer; a module each
    would enlarge every model's module tree, which configuration walks)."""

    def __init__(self, dtype: Format, qscheme: str = "per_tensor_affine", ch_axis: int = -1):
        if not isinstance(dtype, Format):
            raise TypeError(f"illegal format {dtype}")
        self.dtype = dtype
        self.qscheme = qscheme
        self.ch_axis = ch_axis
        self.quant_min, self.quant_max = get_qmin_qmax(dtype)

    def __call__(self, x):
        return x

    def calculate_qparams(self):
        return _ones_zeros()

    def reset(self):
        pass


class _RangeObserver(ObserverBase):
    """min_val / max_val buffers, starting at +inf / -inf."""

    def __init__(self, dtype, qscheme="per_tensor_affine", ch_axis=-1):
        super().__init__(dtype, qscheme, ch_axis)
        self.register_buffer("min_val", torch.tensor(torch.inf, dtype=torch.float32))
        self.register_buffer("max_val", torch.tensor(-torch.inf, dtype=torch.float32))

    def calculate_qparams(self):
        return calculate_qparams_from_min_max(self.min_val, self.max_val, self.quant_min,
                                              self.quant_max, self.qscheme)

    def reset(self):
        self.min_val = torch.tensor(torch.inf, dtype=torch.float32)
        self.max_val = torch.tensor(-torch.inf, dtype=torch.float32)


class MinMaxObserver(_RangeObserver):
    """Running min / max, per tensor or per channel."""

    def forward(self, x):
        x = x.detach().to(torch.float32)
        if is_per_channel(self.qscheme):
            axes = list(range(x.ndim))
            axes.pop(self.ch_axis % x.ndim)
            cur_min = torch.amin(x, dim=axes)
            cur_max = torch.amax(x, dim=axes)
        else:
            cur_min = torch.amin(x)
            cur_max = torch.amax(x)
        prev_min, prev_max = self.min_val.to(x.device), self.max_val.to(x.device)
        if prev_min.shape != cur_min.shape:
            prev_min = torch.full_like(cur_min, torch.inf)
            prev_max = torch.full_like(cur_max, -torch.inf)
        self.min_val = torch.minimum(prev_min, cur_min)
        self.max_val = torch.maximum(prev_max, cur_max)
        return x


def _jnp_linspace_f32(lo: float, hi: float, bins: int) -> np.ndarray:
    """``jnp.linspace(lo, hi, bins + 1)`` in f32 as XLA on the CPU computes
    it: step = iota / bins, then fma(stop, step, start * (1 - step)) rounded
    once (the product and sum taken exactly with ``Fraction``: torch has no
    fused multiply-add that is one on every device)."""
    from fractions import Fraction

    start, stop = np.float32(lo), np.float32(hi)
    step = np.arange(bins, dtype=np.float32) / np.float32(bins)
    lead = start * (np.float32(1) - step)
    edges = [np.float32(float(Fraction(float(stop)) * Fraction(float(s)) + Fraction(float(c))))
             for s, c in zip(step, lead)]
    return np.array(edges + [stop], dtype=np.float32)


def _jnp_histogram_f32(x: torch.Tensor, bins: int, lo: float, hi: float) -> torch.Tensor:
    """``jnp.histogram(x, bins, range=(lo, hi))`` in f32, counts exact: the
    edges :func:`_jnp_linspace_f32`, the bin by ``searchsorted(edges, x,
    'right')``, a value on the last edge into the last bin, values outside
    dropped."""
    edges = torch.from_numpy(_jnp_linspace_f32(lo, hi, bins)).to(x.device)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, bins), idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1]
    return counts.to(torch.float32)


class HistogramObserver(_RangeObserver):
    """Histogram observer with the L2-error-minimizing range search of
    torch.ao's HistogramObserver."""

    def __init__(self, dtype: Format, qscheme: str = "per_tensor_affine", ch_axis: int = -1,
                 bins: int = 2048, upsample_rate: int = 128):
        if not is_per_tensor(qscheme):
            raise ValueError("HistogramObserver supports per-tensor only")
        super().__init__(dtype, qscheme, ch_axis)
        self.bins = bins
        self.upsample_rate = upsample_rate
        self.register_buffer("histogram", torch.zeros(bins, dtype=torch.float32))

    def forward(self, x):
        x = x.detach().to(torch.float32).reshape(-1)
        x_min = float(torch.amin(x))
        x_max = float(torch.amax(x))
        prev_min = float(self.min_val)
        prev_max = float(self.max_val)
        if prev_min == np.inf or prev_max == -np.inf:
            new_min, new_max = x_min, x_max
            if new_min == new_max:  # a degenerate range
                new_min, new_max = new_min - 0.5, new_max + 0.5
            self.histogram = _jnp_histogram_f32(x, self.bins, new_min, new_max)
        else:
            new_min = min(prev_min, x_min)
            new_max = max(prev_max, x_max)
            # the old histogram redistributed into the new range, in float64
            # numpy on the host, as the JAX package does
            old_hist = self.histogram.cpu().numpy()
            hist_new, edges = np.histogram(x.cpu().numpy(), bins=self.bins,
                                           range=(new_min, new_max))
            hist_new = hist_new.astype(np.float64)
            if old_hist.sum() > 0:
                old_edges = np.linspace(prev_min, prev_max, self.bins + 1)
                centers = (old_edges[:-1] + old_edges[1:]) / 2
                idx = np.clip(np.searchsorted(edges, centers, side="right") - 1, 0,
                              self.bins - 1)
                np.add.at(hist_new, idx, old_hist)
            self.histogram = torch.from_numpy(hist_new.astype(np.float32)).to(x.device)
        self.min_val = torch.tensor(new_min, dtype=torch.float32, device=x.device)
        self.max_val = torch.tensor(new_max, dtype=torch.float32, device=x.device)
        return x

    def _non_linear_param_search(self):
        """Greedy L2-error-minimizing [start, end] search over the histogram
        (float64 numpy, torch.ao's algorithm)."""
        hist = self.histogram.cpu().numpy().astype(np.float64)
        min_val = float(self.min_val)
        max_val = float(self.max_val)
        bin_width = (max_val - min_val) / self.bins
        total = hist.sum()
        if total == 0 or bin_width == 0:
            return min_val, max_val
        csum = np.cumsum(hist)
        dst_nbins = (2 ** int(np.ceil(np.log2(max(self.quant_max - self.quant_min + 1, 2))))
                     if self.quant_min is not None else 256)

        def _get_norm(delta_begin, delta_end, density):
            return (delta_end**3 - delta_begin**3) / 3 * density

        def quantization_error(next_start_bin, next_end_bin):
            dst_bin_width = bin_width * (next_end_bin - next_start_bin + 1) / dst_nbins
            if dst_bin_width == 0:
                return 0.0
            src_bin = np.arange(self.bins)
            src_bin_begin = (src_bin - next_start_bin) * bin_width
            src_bin_end = src_bin_begin + bin_width
            dst_bin_of_begin = np.clip(np.floor(src_bin_begin / dst_bin_width), 0, dst_nbins - 1)
            dst_bin_of_end = np.clip(np.floor(src_bin_end / dst_bin_width), 0, dst_nbins - 1)
            dst_bin_of_begin_center = (dst_bin_of_begin + 0.5) * dst_bin_width
            density = hist / bin_width
            norm = np.zeros(self.bins)
            delta_begin = src_bin_begin - dst_bin_of_begin_center
            delta_end = dst_bin_width / 2
            norm += _get_norm(delta_begin, np.full_like(delta_begin, delta_end), density)
            norm += (dst_bin_of_end - dst_bin_of_begin - 1) * _get_norm(
                -dst_bin_width / 2, dst_bin_width / 2, density)
            dst_bin_of_end_center = (dst_bin_of_end + 0.5) * dst_bin_width
            delta_begin = -dst_bin_width / 2
            delta_end = src_bin_end - dst_bin_of_end_center
            norm += _get_norm(np.full_like(delta_end, delta_begin), delta_end, density)
            return norm.sum()

        stepsize = 1e-5
        alpha, beta = 0.0, 1.0
        start_bin, end_bin = 0, self.bins - 1
        norm_min = float("inf")
        while alpha < beta:
            next_alpha = alpha + stepsize
            next_beta = beta - stepsize
            l, r = start_bin, end_bin
            while l < end_bin and csum[l] < next_alpha * total:
                l += 1
            while r > start_bin and csum[r] > next_beta * total:
                r -= 1
            if (l - start_bin) > (end_bin - r):
                next_start_bin, next_end_bin = l, end_bin
                alpha = next_alpha
            else:
                next_start_bin, next_end_bin = start_bin, r
                beta = next_beta
            if next_start_bin == start_bin and next_end_bin == end_bin:
                continue
            norm = quantization_error(next_start_bin, next_end_bin)
            if norm > norm_min:
                break
            norm_min = norm
            start_bin, end_bin = next_start_bin, next_end_bin
        return min_val + bin_width * start_bin, min_val + bin_width * (end_bin + 1)

    def calculate_qparams(self):
        if float(self.min_val) == np.inf:
            return _ones_zeros(self.histogram.device)
        new_min, new_max = self._non_linear_param_search()
        dev = self.histogram.device
        return calculate_qparams_from_min_max(
            torch.tensor(new_min, dtype=torch.float32, device=dev),
            torch.tensor(new_max, dtype=torch.float32, device=dev),
            self.quant_min, self.quant_max, self.qscheme)

    def reset(self):
        super().reset()
        self.histogram = torch.zeros(self.bins, dtype=torch.float32)


def _jnp_percentile_f32(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear interpolation) of a flat f32 tensor:
    the position q / 100 * (n - 1) in f32 arithmetic, as JAX computes it, the
    two order statistics by ``kthvalue`` (no full sort, no 2^24-element
    limit)."""
    dev = x.device
    if bool(torch.isnan(x).any()):
        return torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    n = x.numel()
    qf = (torch.tensor(q, dtype=torch.float32) / torch.tensor(100.0, dtype=torch.float32)
          * (torch.tensor(float(n), dtype=torch.float32) - 1))
    low = torch.floor(qf)
    high = torch.ceil(qf)
    high_weight = qf - low
    low_weight = 1 - high_weight
    lo_i = int(torch.clamp(low, 0, n - 1))
    hi_i = int(torch.clamp(high, 0, n - 1))
    low_value = torch.kthvalue(x, lo_i + 1).values
    high_value = low_value if hi_i == lo_i else torch.kthvalue(x, hi_i + 1).values
    return low_value * low_weight.to(dev) + high_value * high_weight.to(dev)


class PercentileObserver(_RangeObserver):
    """Percentile-clipped range observer."""

    def __init__(self, dtype: Format, qscheme: str = "per_tensor_affine", ch_axis: int = -1,
                 percentile: float = 99.99):
        if not is_per_tensor(qscheme):
            raise ValueError("PercentileObserver supports per-tensor only")
        super().__init__(dtype, qscheme, ch_axis)
        self.percentile = percentile

    def forward(self, x):
        x = x.detach().to(torch.float32).reshape(-1)
        lo = _jnp_percentile_f32(x, 100.0 - self.percentile)
        hi = _jnp_percentile_f32(x, self.percentile)
        self.min_val = torch.minimum(self.min_val.to(x.device), lo)
        self.max_val = torch.maximum(self.max_val.to(x.device), hi)
        return x


OBSERVERS = {
    "dummy": DummyObserver,
    "minmax": MinMaxObserver,
    "histogram": HistogramObserver,
    "percentile": PercentileObserver,
}
