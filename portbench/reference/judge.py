"""The numbers that decide ``correct``, each against its limit.

Scoring: the per-position negative log-likelihood of a sample of the
window's rows, the program's against the reference's over the same ids:
``nll_gap_max``, the widest gap at one position.

The control (``control=True``) reads the same number with the reference
computed in bfloat16 put in the program's place, and is judged by the same
limits (``verdict``): it has to come out as not correct.
"""

from __future__ import annotations

import math

import torch


def token_nll(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """-log p(ids[t + 1] | ids[:t + 1]) from logits [.., T, V], float32 [.., T - 1]."""
    lg = logits[..., :-1, :].float()
    return torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, ids[..., 1:, None].long())[..., 0]


def score_readings(prog_nll, ref_nll) -> dict:
    """The widest gap of two lists of per-row NLLs [T - 1] over the same rows."""
    gmax = 0.0
    for p, r in zip(prog_nll, ref_nll):
        p, r = p.float().cpu(), r.float().cpu()
        if not (torch.isfinite(p).all() and torch.isfinite(r).all()):
            return {"nll_gap_max": math.inf}
        gmax = max(gmax, (p - r).abs().max().item())
    return {"nll_gap_max": gmax}


def verdict(readings: dict, limits: dict) -> bool:
    """Correct when every number is finite and within its limit."""
    return all(k in readings and math.isfinite(readings[k]) and readings[k] <= lim
               for k, lim in limits.items())


def report(readings: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}``, what the run prints last."""
    return {k: {"value": readings.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
