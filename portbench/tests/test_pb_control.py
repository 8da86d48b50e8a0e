"""Each cell's control, the reference one step below exact in the
program's place, comes out wrong by the same comparison that judges the
program: at tiny sizes here; at the cells' own sizes on the card with
``python3 portbench/control.py --workload <name> --seeds 1,2,3``."""

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import merged_spec


@pytest.mark.parametrize("workload", [w["name"] for w in merged_spec()["workloads"]])
@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_control_is_caught(tiny_root, workload, seed):
    spec = harness.load_spec(tiny_root)
    wl = harness.find_workload(spec, workload)
    mix = harness.load_traffic(tiny_root, wl["traffic"])
    cell = harness.Cell(tiny_root, workload, harness.load_config(tiny_root, spec, wl["config"]),
                        mix, seed, torch.device("cpu"))
    readings = harness.load_driver(tiny_root, mix["entry"]).control(cell)
    assert any(v > 0 for v in readings.values()), readings
