"""Visualization helpers: braille sparsity masks and model trees.

Port of ``dmx_compressor_tpu/utils/visualization.py``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from torch import nn


def mask2braille(mask, dims: Sequence[int] = (0, 1), max_elems: int = 4096) -> str:
    """Render a binary mask as braille dot-art (each char = 4x2 cells)."""
    m = np.asarray(mask.detach().cpu() if hasattr(mask, "detach") else mask)
    if m.ndim > 2:
        keep = [d % m.ndim for d in dims]
        other = tuple(i for i in range(m.ndim) if i not in keep)
        m = m.transpose(*keep, *other).reshape(m.shape[keep[0]], -1)
    elif m.ndim == 1:
        m = m[None, :]
    if m.size > max_elems:
        factor = int(np.ceil(np.sqrt(m.size / max_elems)))
        H = (m.shape[0] // factor) * factor
        W = (m.shape[1] // factor) * factor
        m = m[:H, :W].reshape(H // factor, factor, W // factor, factor).max((1, 3))
    H, W = m.shape
    ph, pw = (-H) % 4, (-W) % 2
    m = np.pad(m, ((0, ph), (0, pw)))
    H, W = m.shape
    # braille bit layout per 4x2 cell
    weights = np.array([[0x01, 0x08], [0x02, 0x10], [0x04, 0x20], [0x40, 0x80]])
    rows = []
    for r in range(0, H, 4):
        chars = []
        for c in range(0, W, 2):
            cell = (m[r : r + 4, c : c + 2] > 0).astype(int)
            code = 0x2800 + int((cell * weights).sum())
            chars.append(chr(code))
        rows.append("".join(chars))
    return "\n".join(rows)


def print_model_tree(model, printer=print) -> str:
    """ASCII tree of the module hierarchy, two spaces a level, each line
    ``name: Type``; a Dmx module's carries its weight and first input
    formats, a cast its observer and group observers (plain objects in the
    port, modules in the JAX package: the same lines).  A ModuleList or a
    Python list is a ``list``.  ``model`` may be a ``DmxModel``."""
    from ..nn.core import DmxModule
    from ..numerics.cast import CastTo

    lines = []

    def walk(obj, name, depth, seen):
        if id(obj) in seen:
            return
        if isinstance(obj, nn.Module):
            seen.add(id(obj))
        tag = "list" if isinstance(obj, (nn.ModuleList, list)) else type(obj).__name__
        if isinstance(obj, DmxModule):
            fmts = []
            if obj.weight_format is not None:
                fmts.append(f"w={repr(obj.weight_format)}")
            inp = obj.input_formats.get("input_cast")
            if inp is not None:
                fmts.append(f"in={repr(inp)}")
            tag += " [" + ", ".join(fmts) + "]" if fmts else ""
        lines.append("  " * depth + f"{name}: {tag}")
        if isinstance(obj, list):
            children = list(enumerate(obj))
        elif isinstance(obj, nn.Module):
            children = list(obj._modules.items())
            if isinstance(obj, CastTo):
                children += [("observer", obj.observer), ("group_observers", obj.group_observers)]
        else:
            children = []
        for k, v in children:
            if v is not None:
                walk(v, str(k), depth + 1, seen)

    walk(getattr(model, "module", model), "model", 0, set())
    out = "\n".join(lines)
    if printer:
        printer(out)
    return out
