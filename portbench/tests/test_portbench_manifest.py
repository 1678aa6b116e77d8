"""``BENCHMARK.json`` keeps to its contract's names and shapes, and every
name it gives has its file."""

import json
import re

from portbench import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_names_units_and_files():
    man = catalog.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert len(json.dumps(man)) < 64 * 1024
    names = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert catalog.config(c["name"])["source"] == c["source"]
        assert catalog.config(c["name"])["reduced"] == c["reduced"] == []
        names.add(c["name"])
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        cell = catalog.workload(w["name"])
        assert (cell["config"], cell["mix"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in names and w["chips"] == 1
        pairs.add((w["config"], w["traffic"]))
        catalog.traffic(cell["traffic"])
    assert len(pairs) == len(man["workloads"])
    cells = {w["name"] for w in man["workloads"]}
    metrics = man["end_to_end"] + man["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert callable(catalog.metric_reader(m["name"]))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        got = {m["name"] for m in catalog.metrics_for(c, "end_to_end", man)}
        assert "setup_s" in got and len(got) >= 2
        assert catalog.metrics_for(c, "per_layer", man)
