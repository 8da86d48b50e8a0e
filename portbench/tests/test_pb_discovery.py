"""Configurations, traffic mixes, drivers and metrics are found by the
names in BENCHMARK.json; a new cell needs new files and a workloads entry
only."""

import json
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import ROOT, merged_spec


def _spec():
    """BENCHMARK.json with the parked entries: every file is held to it."""
    return merged_spec()


@pytest.mark.parametrize("workload", [w["name"] for w in _spec()["workloads"]])
def test_every_cell_finds_its_files(workload):
    spec = _spec()
    wl = harness.find_workload(spec, workload)
    cfg = harness.load_config(ROOT, spec, wl["config"])
    mix = harness.load_traffic(ROOT, wl["traffic"])
    driver = harness.load_driver(ROOT, mix["entry"])
    for fn in ("setup", "unit", "work", "release", "check", "control"):
        assert callable(getattr(driver, fn)), fn
    assert cfg["name"] == wl["config"]
    for trace in (False, True):
        assert harness.metrics_of(spec, workload, trace)


@pytest.mark.parametrize("metric", [m["name"] for m in _spec()["per_layer"] + _spec()["end_to_end"]])
def test_metric_files_declare_what_benchmark_json_says(metric):
    spec = _spec()
    m = next(x for x in spec["per_layer"] + spec["end_to_end"] if x["name"] == metric)
    mod = harness.load_metric(ROOT, metric)
    assert mod.UNIT == m["unit"]
    assert mod.MOVES == m.get("moves", metric)
    if "layer" in m:
        assert mod.LAYER == m["layer"]


def test_parked_entries_are_not_in_benchmark_json():
    spec = harness.load_spec(ROOT)
    parked = json.loads((ROOT / "portbench" / "parked.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {x["name"] for x in spec[key]}
        assert not names & {x["name"] for x in parked[key]}, key


def test_configs_hold_what_benchmark_json_names():
    spec = _spec()
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert c["file"].startswith(spec["paths"][0] + "/")


def test_unknown_names_are_refused():
    spec = _spec()
    with pytest.raises(KeyError):
        harness.find_workload(spec, "no.such_cell")
    with pytest.raises(FileNotFoundError):
        harness.load_traffic(ROOT, "no_such_mix")
    with pytest.raises(FileNotFoundError):
        harness.load_metric(ROOT, "no.such_metric")


def test_a_cell_added_as_files_runs(tiny_root):
    """A configuration, a mix, a metric and a workloads entry, each added
    as files to a copy; no harness file is edited."""
    before = {p: p.read_bytes() for p in (tiny_root / "portbench").rglob("*.py")}
    cfg = json.loads((tiny_root / "portbench/configs/cfg4_dense_100k.json").read_text())
    cfg.update(name="cfg_new", n=200)
    (tiny_root / "portbench/configs/cfg_new.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny_root / "portbench/traffic/lookup64.json").read_text())
    mix.update(k=4, query_rows=32)
    (tiny_root / "portbench/traffic/lookup32.json").write_text(json.dumps(mix))
    (tiny_root / "portbench/metrics/new.requests.py").write_text(
        'LAYER = "end to end"\nUNIT = "requests"\nMOVES = "pairs_per_s"\n\n\n'
        "def read(run):\n    return len(run.units)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cfg_new", "source": "https://example.org/new",
                            "file": "portbench/configs/cfg_new.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "new.lookup32", "config": "cfg_new",
                              "traffic": "lookup32", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "new.requests", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "end to end",
                              "moves": "pairs_per_s", "workloads": ["new.lookup32"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run_cell(tiny_root, "new.lookup32", 5, 0.5, True, torch.device("cpu"),
                           time.perf_counter(), log=lambda m: None)
    assert out["correct"]
    assert out["metrics"]["new.requests"]["value"] >= 1
    assert "cross.merge_ms" not in out["metrics"]  # listed for c4.lookup64 only
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_every_cell_reports_what_its_per_layer_metrics_move():
    spec = _spec()
    for wl in spec["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(spec, wl["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, wl["name"]
        assert harness.metrics_of(spec, wl["name"], True), wl["name"]
    for m in spec["per_layer"]:
        for w in m["workloads"]:
            moved = {e["name"] for e in harness.metrics_of(spec, w, False)}
            assert m["moves"] in moved, (m["name"], w)
