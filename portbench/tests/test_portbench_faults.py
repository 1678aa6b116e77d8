"""Each fault a cell can have, planted under the timed path, turns
``correct`` false.  The run skips the harness's look for a card (the CPU
stands in) and is otherwise whole: set-up, window, reference, verdict.

Faults: an answer (a position's logits) altered where it is produced; half
of the batch left out, its outputs the mean of the rest.  A one-chip cell
has no exchange between chips to leave out, and scoring keeps no state that
a step could return unchanged."""

import pytest
import torch

from .tiny import run

SCORE = ["qwen3-0.6b.weights-score", "opt-6.7b.weights-score"]


def _wrap_forward(ctx, change):
    model = ctx.model
    forward = model.forward

    def broken(ids, *a, **k):
        return change(ids, forward(ids, *a, **k))

    model.forward = broken


def _alter_answer(ctx):
    def change(ids, logits):
        logits = logits.clone()
        logits[:, ids.shape[1] // 2] = logits[:, ids.shape[1] // 2].roll(1, dims=-1)
        return logits

    _wrap_forward(ctx, change)


def _half_batch(ctx):
    def change(ids, logits):
        h = max(1, logits.shape[0] // 2)
        if logits.shape[0] < 2:
            return logits
        return torch.cat([logits[:h], logits[:h].mean(0, keepdim=True).expand_as(logits[h:])])

    _wrap_forward(ctx, change)


@pytest.mark.parametrize("name", SCORE)
@pytest.mark.parametrize("fault", [_alter_answer, _half_batch])
def test_scoring_fault_is_caught(name, fault):
    assert run(name)["correct"]
    assert not run(name, fault=fault)["correct"]
