"""Analytic FLOP / BOP / weight-byte proxies.

Port of ``dmx_compressor_tpu/perf_proxy.py``.  BOPs = flops x input bits x
weight bits; weight bytes come from the weight cast's format; both scale by
the sparsifier's density.  Counting runs on the host from the shapes of a
forward and launches nothing.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional


class PerformanceProxyMixin:
    """Mixed into DmxModule; counts matmul / conv flops at forward time."""

    flop_counter: Optional[int] = None
    flop_counter_enabled: bool = False
    last_input_shape = None
    last_output_shape = None

    def zero_flop_counter(self) -> None:
        self.flop_counter = 0

    def enable_flop_counter(self, state: bool = True) -> None:
        self.flop_counter_enabled = state
        if self.flop_counter_enabled and self.flop_counter is None:
            self.zero_flop_counter()

    def _flops_for(self, input_shape, output_shape) -> Optional[int]:
        """Per-module flop formula; Linear and the convs override it."""
        return None

    def count_flops(self, _input, _output) -> None:
        if self.flop_counter is not None:
            self.last_input_shape = tuple(_input.shape)
            self.last_output_shape = tuple(_output.shape)
            f = self._flops_for(self.last_input_shape, self.last_output_shape)
            self.flop_counter = None if f is None else self.flop_counter + f

    def _has_weight(self) -> bool:
        return getattr(self, "weight", None) is not None

    @property
    def weight_elem_count(self) -> Optional[float]:
        if not self._has_weight():
            return None
        n = float(math.prod(self.weight.shape))
        if self.weight_sparsifier is not None:
            n *= self.weight_sparsifier.density
        return n

    @property
    def weight_size_in_bytes(self) -> Optional[float]:
        if not self._has_weight():
            return None
        bytes_per_elem = None
        if self.weight_cast is not None:
            bytes_per_elem = self.weight_cast.format.bytes_per_elem
        if bytes_per_elem is None:
            bytes_per_elem = self.weight.element_size()
        return bytes_per_elem * self.weight_elem_count

    @property
    def flops(self) -> Optional[float]:
        f = self.flop_counter
        if f is not None and self._has_weight() and self.weight_sparsifier is not None:
            f *= self.weight_sparsifier.density
        return f

    @property
    def bops(self) -> Optional[float]:
        b = self.flops
        if b is not None and self._has_weight():
            b *= self.input_precision * self.weight_precision
        return b

    @contextmanager
    def counting_flops(self, zero: bool = True):
        self.enable_flop_counter(True)
        if zero:
            self.zero_flop_counter()
        yield self
        self.enable_flop_counter(False)
