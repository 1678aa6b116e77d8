"""The plain reference against the port on the CPU at tiny sizes, in
weights-mode scoring (Qwen3, OPT); the bfloat16 control comes out as not
correct under the cell's own limits."""

import pytest

from .tiny import run


@pytest.mark.parametrize("name", ["qwen3-0.6b.weights-score", "opt-6.7b.weights-score"])
def test_scoring_matches_the_port(name):
    out = run(name, control=True)
    prog, ctrl = out["_readings"]["program"], out["_readings"]["control"]
    assert out["correct"]
    assert prog["nll_gap_max"] <= 1e-5
    assert ctrl["nll_gap_max"] > 10 * max(prog["nll_gap_max"], 1e-5)
    assert out["_control_correct"] is False
