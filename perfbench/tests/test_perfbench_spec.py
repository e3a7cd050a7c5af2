"""`BENCHMARK.json` and the files it names, found by name."""

import json
import re

import pytest

from perfbench import spec
from perfbench.layouts import dense_decoder as layout
from perfbench.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"train_tokens_per_s", "peak_mem", "setup_s"} <= set(e2e)
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    c = spec.load_cell(name, ROOT)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "train_tokens_per_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    kind = spec.kind_module(c.config["kind"])
    for fn in ("build", "feed", "step", "grad_norms", "change_norms", "counts"):
        assert callable(getattr(kind, fn)), fn
    assert callable(spec.reference_module(c.config["kind"]).readings)
    assert c.traffic["kind"] == "train"
    limits_file = json.loads((spec.PACKAGE / "workloads" / f"{name}.json").read_text())
    compared, skipped = set(c.limits), set(limits_file["not_compared"])
    assert compared | skipped == {"loss_gap", "grad_gap", "change_gap"}
    assert not compared & skipped
    for n, limit in c.limits.items():
        r = limits_file["readings"][n]
        assert r["lower"] < limit < r["upper"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert cfg["assumed"] == {}
    for key, cut in cfg["reduced"].items():
        assert cfg[key] == cut["here"] != cut["published"]
    m = layout.dims(cfg)
    assert m["head_dim"] * m["heads"] == m["d"] == 4096


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell", ROOT)
