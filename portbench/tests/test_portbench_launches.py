"""The launch join (``launches.py``) on synthetic windows, and the port's
span sites against the count of packed linears ``work/`` assumes."""

import collections

import pytest
import torch

from portbench import catalog, launches as LJ
from portbench import weights as W
from portbench.trace import Spans, Trace

from .tiny import cell

# the harness's spans of one batch, and the port's records inside it:
# dmx.forward [1.1, 8.9] holds a linear [2, 3] and attention [4, 6], which
# holds another linear [4.5, 5]
HARNESS = [("score.batch", 0.0, 10.0), ("model.forward", 1.0, 9.0), ("score.loss", 9.2, 9.8)]
PORT = [("dmx.forward", -1, 1.1, 8.9), ("dmx.linear", 0, 2.0, 3.0),
        ("dmx.attention", 0, 4.0, 6.0), ("dmx.linear", 2, 4.5, 5.0)]


def _trace(work, batches):
    return Trace(window_s=10.0, spans=Spans(False), counters={"batches": batches}, work=work,
                 t0=0.0, t1=10.0, kernels=[])


def test_one_list_nests_harness_and_port_spans():
    spans = LJ.one_list(HARNESS, PORT)
    assert [n for n, _, _ in spans] == ["score.batch", "model.forward", "dmx.forward",
                                        "dmx.linear", "dmx.attention", "dmx.linear",
                                        "score.loss"]
    names = [n for n, _, _ in spans]
    assert [names[p] if p >= 0 else None for p in LJ.nest(spans)] == [
        None, "score.batch", "model.forward", "dmx.forward", "dmx.forward", "dmx.attention",
        "score.batch"]


def test_a_kernel_that_runs_after_its_span_is_that_spans():
    # launched at 2.5 inside the linear, run at 7-8 (inside the attention span
    # on the host's clock): by launch it is the linear's
    j = LJ.join([("bfp_wgmma_kernel", 1.0, 2.5)], LJ.one_list(HARNESS, PORT))
    assert j.device_s_under("dmx.linear") == 1.0
    assert j.device_s_under("dmx.attention") == 0.0
    assert j.by_span() == {"dmx.linear": 1.0}


def test_nested_spans_give_self_time():
    ks = [("embed", 0.1, 1.05), ("gemm", 1.0, 2.2), ("norm", 0.2, 3.5), ("qk", 0.5, 4.2),
          ("gemm", 1.0, 4.7), ("softmax", 0.3, 5.5), ("loss", 0.4, 9.5), ("sync", 0.05, 0.5),
          ("lost", 0.7, None)]
    j = LJ.join(ks, LJ.one_list(HARNESS, PORT))
    assert j.device_s_under("dmx.forward") == pytest.approx(0.2 + 1.0 + 0.5 + 1.0 + 0.3)
    assert j.device_s_under("dmx.forward", self_only=True) == pytest.approx(0.2)
    assert j.device_s_under("dmx.attention") == pytest.approx(0.5 + 1.0 + 0.3)
    assert j.device_s_under("dmx.attention", self_only=True) == pytest.approx(0.8)
    assert j.device_s_under("dmx.linear") == pytest.approx(2.0)
    assert j.device_s_under("model.forward", self_only=True) == pytest.approx(0.1)
    assert j.by_span() == pytest.approx({"model.forward": 0.1, "dmx.linear": 2.0,
                                         "dmx.forward": 0.2, "dmx.attention": 0.8,
                                         "score.loss": 0.4, "score.batch": 0.05,
                                         LJ.NO_SPAN: 0.7})
    assert j.unlaunched == 1


def test_the_readings_by_hand():
    ks = [("embed", 0.004, 1.5), ("gemm", 0.5, 2.2), ("flash", 0.2, 4.2), ("gemm", 0.5, 4.7),
          ("add", 0.002, 7.0)]
    j = LJ.join(ks, LJ.one_list(HARNESS, PORT))
    tr = _trace({"attention": 0.01}, 2)
    # 100 x 0.01 s of bound over the 0.2 + 0.5 s launched inside dmx.attention
    assert LJ.attn_span_roofline(tr, j) == pytest.approx(100 * 0.01 / 0.7)
    # (0.004 + 0.002) s over 2 batches
    assert LJ.forward_self_ms(tr, j) == pytest.approx(3.0)
    empty = LJ.join([], LJ.one_list(HARNESS, PORT))
    assert LJ.attn_span_roofline(tr, empty) is None
    assert LJ.forward_self_ms(tr, empty) is None


def test_idle_gaps_take_the_innermost_span():
    # kernels run over [0.5, 1.05], [1.2, 2.1], [2.6, 4.4], [4.6, 9.25], [9.9, 10];
    # the gaps begin at 0, 1.05, 2.1, 4.4, 9.25
    ran = [("k", 0.5, 1.05), ("k", 1.2, 2.1), ("k", 2.6, 4.4), ("k", 4.6, 9.25), ("k", 9.9, 10.0)]
    j = LJ.join([], LJ.one_list(HARNESS, PORT))
    assert j.idle_by_span(ran, 0.0, 10.0) == pytest.approx({
        "score.batch": 0.5, "model.forward": 0.15, "dmx.linear": 0.5, "dmx.attention": 0.2,
        "score.loss": 0.65})


@pytest.mark.parametrize("name", ["opt-6.7b.weights-score", "qwen3-0.6b.weights-score"])
def test_span_sites_count_what_work_counts(name):
    """One forward records an ``dmx.attention`` a layer and a ``dmx.linear``
    for each launch ``linears(cfg)`` counts, all inside one ``dmx.forward``."""
    from dmx_compressor_tpu_torch.ops import compress
    from dmx_compressor_tpu_torch.utils.tracing import recording

    c, cfg = cell(name)
    fam = catalog.family(cfg["family"])
    model = fam.port_model(cfg, torch.device("cpu"))
    W.load_into(model, fam, cfg, 7)
    compress.build_weights_mode(model)
    model.eval()
    ids = torch.randint(0, cfg["vocab_size"], (1, 16))
    with torch.no_grad(), recording() as rec:
        model(ids)
    counts = collections.Counter(n for n, _, _, _ in rec)
    assert counts == {"dmx.forward": 1, "dmx.attention": cfg["num_hidden_layers"],
                      "dmx.linear": sum(n for _, _, n in fam.linears(cfg))}
    assert all(p == 0 for _, p, _, _ in rec[1:])
