"""The result line a run prints: its keys, the metrics of each kind of
run, and the compared numbers last. Runs at tiny sizes on the CPU."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import ROOT, merged_spec


def _run(root, workload, trace, seconds=0.5):
    return harness.run_cell(root, workload, 2**33 + 99, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys_and_metrics(tiny_root, trace):
    out = _run(tiny_root, "c4.lookup64", trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    names = {m["name"] for m in harness.metrics_of(merged_spec(), "c4.lookup64", trace)}
    assert set(out["metrics"]) <= names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "cross.merge_ms" in out["metrics"]
        # no device on the CPU: the device metrics are left out, never 0
        assert "device.idle_pct.lookup" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"lookup_pairs_per_s", "lookup_p95_ms", "setup_s"}  # p95 parked
    for v in out["compared"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(out)


def test_matrix_spans(tiny_root):
    out = _run(tiny_root, "c3b.matrix", True)
    assert out["correct"]
    assert {"layout.ingest_ms", "api.call_ms"} <= set(out["metrics"])


def test_without_a_card_the_command_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "c4.lookup64", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
