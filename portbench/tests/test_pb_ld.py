"""The LD panel's generator, the r² reference's integer rule, and the cell
``c4ld.r2_screen`` at a tiny size on the CPU: correct with the program's
density order engaged (a CPU tuning cache prices K4 in), and its control
caught."""

import json
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

from portbench import generate, harness, ld_panel
from portbench.reference import ld

BIG = 2**33 + 12345
TINY = {"n": 1024, "m_bits": 8192, "layout": ld_panel.LAYOUT, "ld_block_rows": 32}


@pytest.mark.parametrize("seed", [3, BIG])
def test_panels_repeat_with_nested_carriers_and_their_counts(seed):
    chunks = list(ld_panel.panel_device(seed, TINY, "cpu"))
    again = list(ld_panel.panel_device(seed, TINY, "cpu"))
    words = torch.cat([w for _, w in chunks]).numpy().view(np.uint32)
    assert np.array_equal(words, torch.cat([w for _, w in again]).numpy().view(np.uint32))
    counts = ld_panel.carrier_counts(seed, TINY["n"], TINY["m_bits"], "cpu").numpy()
    assert np.array_equal(np.bitwise_count(words).sum(axis=1), counts)
    assert counts.min() >= 1 and counts.max() <= TINY["m_bits"] - 1
    for b0 in range(0, TINY["n"], 32):
        block = words[b0 : b0 + 32][np.argsort(counts[b0 : b0 + 32], kind="stable")]
        # each row's carriers hold those of every rarer row of its block
        assert np.all((block[:-1] & ~block[1:]) == 0)


def test_the_integer_rule_is_exact_at_the_threshold():
    rng = np.random.default_rng(5)
    m = 1 << 20
    a = rng.integers(1, m, 4000)
    b = rng.integers(1, m, 4000)
    c = np.minimum(a, b) - rng.integers(0, 3, 4000) * (np.minimum(a, b) > 2)
    hit, r2 = ld.r2_decide(c, a, b, m, 0.8)
    for k in range(c.size):
        exact = Fraction((m * int(c[k]) - int(a[k]) * int(b[k])) ** 2,
                         int(a[k]) * (m - int(a[k])) * int(b[k]) * (m - int(b[k])))
        assert bool(hit[k]) == (exact >= Fraction(4, 5))
        assert abs(r2[k] - float(exact)) <= 1e-12 * float(exact)
    assert 0 < hit.sum() < hit.size
    # a row with no or every bit set is in no hit
    assert not ld.r2_decide([0, 5], [0, m], [7, 5], m, 0.8)[0].any()


@pytest.fixture
def ld_root(tmp_path, monkeypatch):
    from portbench.tests import tiny

    cache = tmp_path / "tuning.json"
    cache.write_text(json.dumps({"device": "cpu", "k4_cost_model": {
        "c_k2_stripe_s_per_op": 1e-12, "c_k4_stripe_s": 1e-4, "c_emit_s_per_emission": 1e-8,
        "c_k4_gather_s_per_elem": 1e-10, "c_k4_gather_s_per_position": 1e-8}}))
    monkeypatch.setenv("STORMTPU_TORCH_TUNING_CACHE", str(cache))
    root = tiny.make_root(tmp_path / "root")
    for path, over in (("portbench/configs/cfg4_ld_neutral_100k.json",
                        {"n": 2048, "m_bits": 16384}),
                       ("portbench/traffic/ld_r2_screen.json",
                        {"superblock_rows": 256, "check_rows": 64})):
        got = json.loads((root / path).read_text())
        got.update(over)
        (root / path).write_text(json.dumps(got))
    return root


def test_the_cell_runs_correct_with_the_order_and_its_control_is_caught(ld_root):
    from stormtpu_torch.utils import profiling

    profiling.reset_profiled()
    out = harness.run_cell(ld_root, "c4ld.r2_screen", BIG, 0.5, True, torch.device("cpu"),
                           time.perf_counter(), log=lambda m: None)
    assert out["correct"], out["compared"]
    assert {"stream_query.order_ms", "stream_query.k4_stripe_ms"} <= set(out["metrics"])
    counters = profiling.profiled_recording().counters
    assert 0 < counters["routes.k4"] < counters["stripes"]
    spec = harness.load_spec(ld_root)
    wl = harness.find_workload(spec, "c4ld.r2_screen")
    mix = harness.load_traffic(ld_root, wl["traffic"])
    cell = harness.Cell(ld_root, "c4ld.r2_screen", harness.load_config(ld_root, spec, wl["config"]),
                        mix, 1, torch.device("cpu"))
    assert any(v > 0 for v in harness.load_driver(ld_root, mix["entry"]).control(cell).values())
    ops, nbytes = harness.load_driver(ld_root, mix["entry"]).work(cell)
    assert ops > 0 and nbytes > 0


def test_the_control_refuses_the_full_size_off_the_card():
    from portbench.tests.tiny import ROOT

    spec = harness.load_spec(ROOT)
    wl = harness.find_workload(spec, "c4ld.r2_screen")
    mix = harness.load_traffic(ROOT, wl["traffic"])
    cell = harness.Cell(ROOT, wl["name"], harness.load_config(ROOT, spec, wl["config"]), mix, 1,
                        torch.device("cpu"))
    with pytest.raises(RuntimeError, match="runs on the card"):
        harness.load_driver(ROOT, mix["entry"]).control(cell)
    assert generate.CHUNK_ROWS % cell.config["ld_block_rows"] == 0
