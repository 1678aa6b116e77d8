"""Monitoring and runtime measurement context managers.

Port of ``dmx_compressor_tpu/utils/monitor.py``.  The JAX package wraps
each monitored module in a recorder (nnx has no hooks); here each gets a
forward hook (and a forward pre-hook for runtimes), PyTorch's idiom.
``records[name]`` holds ``inputs`` (each call's positional arguments),
``outputs`` and ``runtimes`` (seconds), one entry a call, under the names
and with the call counts of the JAX package for the same model, mode and
inputs.  A runtime is the time between two CUDA events recorded around the
module's call on the card (read when the context closes), and the host
clock around it on the CPU.

While a context is open, ``DmxModule.monitors`` is above 0 and the fused
BASIC plans (``ops/basic_layer.py``, ``ops/basic_attention.py``) take the
modular path, so every monitored module is called: in the JAX package a
wrapped module fails the plans' type checks, with the same effect.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from ..nn.core import DmxModule


def _first_tensor(args, kwargs) -> Optional[torch.Tensor]:
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a
    return None


class _MonitorBase:
    measure_runtime = False

    def __init__(self, model, submodules: Optional[List[str]] = None):
        self.model = model
        self.submodules = submodules
        self.records: Dict[str, SimpleNamespace] = {}
        self._handles = []

    def _targets(self):
        mods = dict(self.model.named_dmx_modules())
        if self.submodules is not None:
            mods = {k: v for k, v in mods.items() if k in self.submodules}
        return mods

    def _hook(self, mod, rec: SimpleNamespace):
        if not self.measure_runtime:
            def record(m, args, kwargs, output):
                rec.inputs.append(args)
                rec.outputs.append(output)

            self._handles.append(mod.register_forward_hook(record, with_kwargs=True))
            return

        def start(m, args, kwargs):
            x = _first_tensor(args, kwargs)
            if x is not None and x.is_cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                rec._open.append(ev)
            else:
                rec._open.append(time.perf_counter())

        def stop(m, args, kwargs, output):
            began = rec._open.pop()
            if isinstance(began, float):
                rec.runtimes.append(time.perf_counter() - began)
            else:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                rec._events.append((len(rec.runtimes), began, ev))
                rec.runtimes.append(None)

        self._handles.append(mod.register_forward_pre_hook(start, with_kwargs=True))
        self._handles.append(mod.register_forward_hook(stop, with_kwargs=True))

    def __enter__(self):
        for name, mod in self._targets().items():
            rec = SimpleNamespace(inputs=[], outputs=[], runtimes=[], _open=[], _events=[])
            self.records[name] = rec
            self._hook(mod, rec)
        DmxModule.monitors += 1
        return self

    def __exit__(self, *exc):
        DmxModule.monitors -= 1
        for h in self._handles:
            h.remove()
        self._handles.clear()
        if any(rec._events for rec in self.records.values()):
            torch.cuda.synchronize()
        for rec in self.records.values():
            for i, began, ended in rec._events:
                rec.runtimes[i] = began.elapsed_time(ended) / 1e3
            rec._events.clear()
        return False


class Monitoring(_MonitorBase):
    """Record each monitored module's inputs and outputs, a call at a time."""

    measure_runtime = False


class RuntimeMeasurement(_MonitorBase):
    """Record each monitored module's runtime (seconds), a call at a time."""

    measure_runtime = True

    def get_records(self) -> Dict[str, List[float]]:
        return {k: v.runtimes for k, v in self.records.items()}
