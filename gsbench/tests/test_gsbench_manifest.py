"""``BENCHMARK.json`` against the benchmark contract's shape, and every name
in it resolving to the file the harness finds it by."""
import json
import math
import re

import pytest
from conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["paths"] == ["gsbench"]
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(ONE_LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    cells = len(MANIFEST["workloads"])
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(MANIFEST["configs"]) <= 24


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keys_names_and_units(kind):
    entries = MANIFEST[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            assert key not in e or ONE_LINE.match(e[key]), e


def test_metric_names_are_unique_across_kinds():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)


def test_bounds_and_sources():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"


def test_configs_resolve_and_list_their_cuts():
    for c in MANIFEST["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("gsbench/") and path.is_file()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["published"]) & set(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert cfg[key] != cfg["published"][key]
            assert not key.endswith(("_dim", "_rank"))
        for key, value in cfg["published"].items():
            if key in cfg and key not in c["reduced"]:
                assert cfg[key] == value, key
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    assert len({c["file"] for c in MANIFEST["configs"]}) == len(MANIFEST["configs"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_resolve(cell):
    w = {w["name"]: w for w in MANIFEST["workloads"]}[cell]
    assert w["chips"] == 1
    traffic = json.loads((ROOT / "gsbench" / "traffic" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "gsbench" / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((ROOT / "gsbench" / "limits" / f"{cell}.json").read_text())
    assert limits.pop("reference", "float32") in ("float32", "float64")
    assert limits and all(math.isfinite(v) and v > 0 for v in limits.values())
    for m in METRICS:
        if cell in m.get("workloads", [cell]):
            assert (ROOT / "gsbench" / "metrics" / f"{m['name']}.py").is_file(), m
    pairs = [(x["config"], x["traffic"]) for x in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in MANIFEST["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), (m, cell)


def test_layers_are_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in MANIFEST["per_layer"]}:
        assert layer in perf, layer
