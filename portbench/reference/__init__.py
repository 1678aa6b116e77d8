"""The plain reference: each family's forward in plain PyTorch (float32, TF32
off), the numerics of each mode worked out again from frozen copies of the
casts (``numerics.py``), and the comparisons that decide ``correct``
(``judge.py``).  Nothing here imports the port or JAX, and nothing takes a
tensor the port made: the weights come again from ``weights.py`` and the
seed, one layer at a time."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Matmuls and convolutions in full float32 within (TF32 off)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
