"""The port's span recorder (``utils/tracing.py``) and its sites on the CPU.

Off, ``span`` hands out one shared object and records nothing; on, the
records carry names, nesting and parent indices; a function holding spans
compiles whole under ``torch.compile``.  A forward of tiny OPT and Qwen3
models in weights mode (packed BFP16_64 linears) records one ``dmx.forward``,
an ``dmx.attention`` a layer and 4L+1 ``dmx.linear`` (merged q/k/v, the out
projection, fc1 or merged gate/up, fc2 or down a layer, the tied head), all
inside the forward, and computes what it computes unrecorded.
"""

import pytest
import torch

from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from dmx_compressor_tpu_torch.models.qwen3 import Qwen3Config, Qwen3ForCausalLM
from dmx_compressor_tpu_torch.ops.compress import build_weights_mode
from dmx_compressor_tpu_torch.utils import tracing
from dmx_compressor_tpu_torch.utils.tracing import recording, span


def _nested():
    with span("outer"):
        with span("inner"):
            pass
        with span("inner2"):
            with span("leaf"):
                pass
    with span("next"):
        pass


def test_off_hands_out_one_object_and_records_nothing():
    assert span("a") is span("b")
    with recording() as rec:
        pass
    _nested()
    assert rec == [] and tracing._records is None


def test_on_records_names_nesting_and_parents():
    with recording() as rec:
        _nested()
    assert [(n, p) for n, p, _, _ in rec] == [
        ("outer", -1), ("inner", 0), ("inner2", 0), ("leaf", 2), ("next", -1)]
    for n, p, s, e in rec:
        assert s <= e
        if p >= 0:
            assert rec[p][2] <= s and e <= rec[p][3]
    assert rec[0][3] <= rec[4][2]
    assert span("x") is span("y")  # off again after the block


@pytest.mark.parametrize("on", [False, True])
def test_compiles_whole(on):
    def f(x):
        with span("a"):
            y = x * 2
            with span("b"):
                y = y + 1
        return y.sin()

    x = torch.randn(8)
    torch._dynamo.reset()
    fn = torch.compile(f, fullgraph=True, backend="eager")
    if on:
        with recording() as rec:
            got = fn(x)
        assert rec == []  # nothing inside the trace
    else:
        got = fn(x)
    torch.testing.assert_close(got, f(x))


@pytest.mark.parametrize("family", ["opt", "qwen3"])
def test_span_sites_of_a_forward(family):
    torch.manual_seed(0)
    if family == "opt":
        cfg = OPTConfig.tiny()
        model = OPTForCausalLM(cfg, device="cpu")
    else:
        cfg = Qwen3Config.tiny()
        model = Qwen3ForCausalLM(cfg, device="cpu")
    build_weights_mode(model)
    model.eval()
    ids = torch.randint(0, cfg.vocab_size, (2, 16))
    L = cfg.num_hidden_layers
    with torch.no_grad():
        want = model(ids)
        with recording() as rec:
            got = model(ids)
    assert torch.equal(got, want)
    names = [n for n, _, _, _ in rec]
    assert names.count("dmx.forward") == 1 and rec[0][:2] == ("dmx.forward", -1)
    assert names.count("dmx.attention") == L
    assert names.count("dmx.linear") == 4 * L + 1
    assert len(names) == 5 * L + 2
    # each inside the forward, none inside another
    assert all(p == 0 for _, p, _, _ in rec[1:])
