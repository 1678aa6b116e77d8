"""What the three benchmarks share: the checkpoint flag, refused."""

from __future__ import annotations

CKPT_REFUSAL = ("--ckpt: reading a local HF checkpoint is modeling/hf.py's, ROADMAP Queue A "
                "item 9.2, which the port has not ported yet")


def refuse_ckpt(ckpt) -> None:
    """Raise where a checkpoint is asked for: the weights would otherwise be
    random without a word."""
    if ckpt is not None:
        raise NotImplementedError(CKPT_REFUSAL)
