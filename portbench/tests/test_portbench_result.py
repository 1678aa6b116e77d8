"""The result line's keys, untraced and traced, and the check printed last."""

import json

import pytest

from .tiny import run


def _keys(out, traced):
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert {"correct", "attempted", "failed", "metrics", "device", "check"} <= set(out)
    shown = [k for k in out if not k.startswith("_")]
    assert shown[-1] == "check"
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert traced == ("busy_s" in dev and "window_s" in dev)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["check"].values():
        assert set(c) == {"value", "limit"}
    json.dumps({k: v for k, v in out.items() if not k.startswith("_")}, allow_nan=False)


def test_untraced_line_has_the_end_to_end_metrics():
    out = run("qwen3-0.6b.weights-score")
    _keys(out, False)
    assert set(out["metrics"]) == {"score_tokens_per_s", "setup_s"}


def test_traced_line_has_per_layer_metrics():
    out = run("qwen3-0.6b.weights-score", trace=True)
    _keys(out, True)
    assert "mfu.score" in out["metrics"]  # the CPU has no device trace for the rest


def _reading(values):
    """A reader of a share that gives ``values`` in turn, one a take."""
    it = iter(values)
    return lambda trace: next(it)


@pytest.mark.parametrize("values, takes", [([150.0, 42.0], 2), ([150.0, 130.0, 120.0], 3)])
def test_a_share_above_100_is_taken_again_then_kept(monkeypatch, values, takes):
    from portbench import catalog

    man = dict(catalog.manifest(), per_layer=[
        {"name": "linear_roofline.score", "unit": "%", "layer": "packed linears",
         "moves": "score_tokens_per_s"}])
    monkeypatch.setattr(catalog, "manifest", lambda: man)
    reader = _reading(values)
    monkeypatch.setattr(catalog, "metric_reader", lambda name: reader)
    out = run("qwen3-0.6b.weights-score", trace=True)
    assert out["_counters"]["takes"] == takes
    assert out["metrics"]["linear_roofline.score"]["value"] == values[-1]


def test_roofline_is_not_capped():
    from portbench.metrics import roofline
    from portbench.trace import Spans, Trace

    tr = Trace(window_s=1.0, spans=Spans(False), counters={}, work={"linear": 0.3}, t0=0.0,
               t1=1.0, kernels=[("bfp_wgmma_kernel<3>", 0.0, 0.2), ("other", 0.2, 0.9)])
    assert roofline(tr, "linear", ("bfp_wgmma_kernel",)) == pytest.approx(150.0)
    assert roofline(tr, "attention", ("flash_attention_kernel",)) is None
