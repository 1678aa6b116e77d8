"""Traffic kinds (``traffic/<kind>.py``), each with a generator seeded from
the run's seed and a measuring loop: ``setup(ctx)`` warms the cell's own
shapes, ``run(ctx, seconds)`` measures and returns a :class:`Window`,
``check(ctx, window, control)`` reads the numbers that decide ``correct``."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Window:
    metrics: Dict[str, float]  # the end-to-end metrics this traffic measures
    attempted: int
    failed: int
    seconds: float
    t0: float
    t1: float
    record: object = None  # what the check reads
    counters: Dict[str, float] = field(default_factory=dict)
    work: Dict[str, float] = field(default_factory=dict)  # bound seconds by layer, model flops


def now() -> float:
    return time.perf_counter()
