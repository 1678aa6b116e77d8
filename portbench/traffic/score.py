"""Scoring: a closed loop of back-to-back batches of full-context windows,
the negative log-likelihood of every position computed from the forward's
logits, as perplexity and log-likelihood evaluations run.

Parameters: ``batch`` windows of ``seq`` token ids a forward, the ids drawn
uniformly from the vocabulary by a generator seeded from the run's seed.
Every seed runs the same shapes.  Each batch ends in a synchronisation (an
evaluation reads each batch's sums).  The window runs whole batches until
``seconds`` have passed; the rate is all their tokens over all that time.
"""

from __future__ import annotations

import torch

from .. import weights as W
from .. import work
from ..reference import full_f32, judge
from . import Window, now


def _next_ids(ctx):
    p = ctx.cell["params"]
    return torch.randint(0, ctx.cfg["vocab_size"], (p["batch"], p["seq"]), generator=ctx.ids_gen,
                         device=ctx.device)


@torch.no_grad()
def _batch(ctx, ids):
    with ctx.spans("score.batch"):
        with ctx.spans("model.forward"):
            logits = ctx.model(ids)
        with ctx.spans("score.loss"):
            nll = judge.token_nll(logits, ids)
            del logits
        ctx.sync()
    return nll


def ids_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(W.mix(seed, 1 << 20))


def setup(ctx) -> None:
    ctx.ids_gen = ids_generator(ctx.seed, ctx.device)
    _batch(ctx, _next_ids(ctx))  # warm: the window's one shape


def run(ctx, seconds: float) -> Window:
    p = ctx.cell["params"]
    B, T = p["batch"], p["seq"]
    done, ends = [], []
    t0 = now()
    while True:
        ids = _next_ids(ctx)
        done.append((ids, _batch(ctx, ids)))
        ends.append(now())
        if ends[-1] - t0 >= seconds:
            break
    t1 = ends[-1]
    batch_s = [e - s for s, e in zip([t0] + ends, ends)]
    n = len(done)
    fam, cfg = ctx.fam, ctx.cfg
    H, Hkv, D = fam.heads(cfg)
    L = cfg["num_hidden_layers"]
    win = Window(metrics={"score_tokens_per_s": n * B * T / (t1 - t0)}, attempted=n * B,
                 failed=0, seconds=t1 - t0, t0=t0, t1=t1, record=done)
    win.counters = {"batches": n, "batch_s_first": batch_s[0], "batch_s_min": min(batch_s),
                    "batch_s_max": max(batch_s)}
    win.work = {
        "model_flops": n * B * work.model_flops_prompt(fam, cfg, T),
        "linear": n * work.linears_bound_s(fam, cfg, B * T),
        "attention": n * L * work.bound_s(*work.attention_prefill(H, Hkv, D, T, B)),
    }
    return win


def check(ctx, win: Window, control: bool = False) -> dict:
    """The reference's NLL of ``rows`` rows drawn from the seed among the
    window's, against the program's; with ``control``, the bfloat16
    reference's against the float32 one's too."""
    rows = [(b, r) for b in range(len(win.record)) for r in range(win.record[b][0].shape[0])]
    g = torch.Generator().manual_seed(W.mix(ctx.seed, 2 << 20))
    pick = [rows[i] for i in torch.randperm(len(rows), generator=g)[:ctx.cell["check"]["rows"]]]
    ids = [win.record[b][0][r] for b, r in pick]
    prog = [win.record[b][1][r] for b, r in pick]

    def reference(dtype):
        out = [None] * len(ids)

        def keep(j, logits):
            out[j] = judge.token_nll(logits, ids[j])

        with full_f32():
            ctx.ref.score_logits(ctx.cfg, ctx.cell["mode"], ctx.seed, ids, ctx.device, dtype, keep)
        return out

    ref = reference(torch.float32)
    out = {"program": judge.score_readings(prog, ref)}
    if control:
        out["control"] = judge.score_readings(reference(torch.bfloat16), ref)
    return out
