"""Trace-safety helpers for diagnostic state, and the port's span recorder.

Port of ``dmx_compressor_tpu/utils/tracing.py``.  Dmx modules record
diagnostic side state during a forward (the physical dtype, the
approximation error, FLOP counts, a sparsifier's lazily made score).  Inside
a ``torch.compile`` trace these assignments are skipped, as the JAX package
skips them under a JAX trace: a compiled forward (``DmxModel.compiled``)
writes no diagnostic state, the state of the last eager forward stays.

Spans mark the host's stretches of work at the port's layer boundaries:
``dmx.forward`` (a causal LM's whole forward), ``dmx.linear`` (a packed
linear's whole call, casts included) and ``dmx.attention`` (the attention
core, from the projected heads to the merged context).  They are recorded
only inside :func:`recording`, on one thread; each record is
``(name, parent index, start, end)`` in ``time.perf_counter`` seconds, the
parent the innermost span open at the start (-1 for none).  A device
profile taken over the same stretch attributes each kernel to the innermost
span open when the host launched it: the card runs behind the host, so a
kernel usually runs after the span that launched it has closed.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Tuple

import torch

Record = Tuple[str, int, float, Optional[float]]

_records: Optional[List[Record]] = None  # the open recording's list; None when off
_open = -1  # index of the innermost open span in ``_records``


def eager() -> bool:
    """True when not inside a ``torch.compile`` trace."""
    return not torch.compiler.is_compiling()


def try_set(obj, name: str, value) -> None:
    """Set a diagnostic attribute; skipped inside a trace."""
    if eager():
        setattr(obj, name, value)


# what span() returns while nothing records: one shared object, which
# torch.compile traces through without a graph break
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("records", "name", "index", "parent", "start")

    def __init__(self, records: List[Record], name: str):
        self.records, self.name = records, name

    def __enter__(self):
        global _open
        self.parent, self.index = _open, len(self.records)
        self.start = time.perf_counter()
        self.records.append((self.name, self.parent, self.start, None))
        _open = self.index

    def __exit__(self, *exc):
        global _open
        self.records[self.index] = (self.name, self.parent, self.start, time.perf_counter())
        _open = self.parent


def span(name: str):
    """A context manager that records ``name`` over its block while
    :func:`recording` is on.  Off, or inside a ``torch.compile`` trace, it is
    one shared object that records nothing."""
    if _records is None or not eager():
        return _OFF
    return _Span(_records, name)


@contextlib.contextmanager
def recording():
    """Record every :func:`span` entered within the block; yields the list
    the records go into, which stays the caller's after the block."""
    global _records, _open
    prev = _records, _open
    _records, _open = [], -1
    try:
        yield _records
    finally:
        _records, _open = prev
