"""The four-rank cell ``c5.ring_topk_4chip`` at a tiny size on the CPU:
the real driver, its three ranks spawned as on the card, every rank a
gloo rank on the CPU. Each test ends with no rank process left."""

import json
import multiprocessing
import time

import numpy as np
import pytest
import torch

import stormtpu_torch.parallel

from portbench import harness

CELL = "c5.ring_topk_4chip"
TINY_CONFIG = {"n": 300, "m_bits": 4096}
TINY_TRAFFIC = {"warmup_rows_per_rank": 16, "check_rows": 64}
SEED = 2**31 + 17


@pytest.fixture
def ring_root(tiny_root):
    for path, over in ((tiny_root / "portbench/configs/cfg5_rows_1m_4chip.json", TINY_CONFIG),
                       (tiny_root / "portbench/traffic/ring_topk16.json", TINY_TRAFFIC)):
        d = json.loads(path.read_text())
        d.update(over)
        path.write_text(json.dumps(d))
    yield tiny_root
    assert not multiprocessing.active_children()


def _run(root, trace: bool):
    return harness.run_cell(root, CELL, SEED, 0.3, trace, torch.device("cpu"),
                            time.perf_counter(), log=lambda m: None)


def test_ring_cell_is_correct_and_reports_its_metrics(ring_root):
    out = _run(ring_root, False)
    assert out["correct"], out["compared"]
    assert out["compared"]["rows_wrong"] == {"value": 0, "limit": 0}
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    traced = _run(ring_root, True)
    assert traced["correct"], traced["compared"]
    # no device clock on the CPU: the device-time metrics are left out
    assert set(traced["metrics"]) == {"parallel.host_busy_ms"}
    assert traced["metrics"]["parallel.host_busy_ms"]["value"] > 0


def test_a_wrong_partner_is_not_correct(ring_root, monkeypatch):
    real = stormtpu_torch.parallel.distributed_topk_neighbors

    def planted(*a, **kw):
        vals, idx = real(*a, **kw)
        idx = idx.copy()
        idx[::5, 0] = (idx[::5, 0] + 1) % idx.shape[0]
        return vals, idx

    monkeypatch.setattr(stormtpu_torch.parallel, "distributed_topk_neighbors", planted)
    out = _run(ring_root, False)
    assert out["correct"] is False
    assert out["compared"]["rows_wrong"]["value"] > 0


def test_a_program_without_the_sharded_form_fails_before_any_rank_starts(ring_root,
                                                                         monkeypatch):
    monkeypatch.delattr(stormtpu_torch.parallel, "RowShard")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="no row-sharded input form"):
        _run(ring_root, False)
    assert time.perf_counter() - t0 < 10
    assert not multiprocessing.active_children()


def test_work_is_rank_zeros_quarter():
    from portbench import roofline
    from portbench.tests.tiny import ROOT

    spec = harness.load_spec(ROOT)
    wl = harness.find_workload(spec, CELL)
    cfg = harness.load_config(ROOT, spec, wl["config"])
    cell = harness.Cell(ROOT, CELL, cfg, harness.load_traffic(ROOT, wl["traffic"]), 1,
                        torch.device("cpu"))
    driver = harness.load_driver(ROOT, cell.traffic["entry"])
    ops, nbytes = driver.work(cell)
    whole = roofline.dense_allpairs_work(10**6, 2**20, 8 * 10**6 * 16)
    assert cfg["ranks"] == wl["chips"] == 4
    assert np.isclose(ops * 4, whole[0]) and np.isclose(nbytes * 4, whole[1])


@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_control_is_caught_at_a_tiny_size(ring_root, seed):
    """``test_pb_control`` runs each cell's control on ``tiny.py``'s
    sizes, which do not name this configuration: here at the tiny size."""
    spec = harness.load_spec(ring_root)
    wl = harness.find_workload(spec, CELL)
    mix = harness.load_traffic(ring_root, wl["traffic"])
    cell = harness.Cell(ring_root, CELL, harness.load_config(ring_root, spec, wl["config"]), mix,
                        seed, torch.device("cpu"))
    readings = harness.load_driver(ring_root, mix["entry"]).control(cell)
    assert readings["rows_wrong"] > 0
