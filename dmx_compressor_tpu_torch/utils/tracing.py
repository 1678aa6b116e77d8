"""Trace-safety helpers for diagnostic state.

Port of ``dmx_compressor_tpu/utils/tracing.py``.  Dmx modules record
diagnostic side state during a forward (the physical dtype, the
approximation error, FLOP counts, a sparsifier's lazily made score).  Inside
a ``torch.compile`` trace these assignments are skipped, as the JAX package
skips them under a JAX trace: a compiled forward (``DmxModel.compiled``)
writes no diagnostic state, the state of the last eager forward stays.
"""

from __future__ import annotations

import torch


def eager() -> bool:
    """True when not inside a ``torch.compile`` trace."""
    return not torch.compiler.is_compiling()


def try_set(obj, name: str, value) -> None:
    """Set a diagnostic attribute; skipped inside a trace."""
    if eager():
        setattr(obj, name, value)
