"""A copy of the benchmark at sizes the CPU runs in seconds: the real
drivers, metrics and traffic files under a temporary root, with
``BENCHMARK.json`` pointing at small configurations, and the parked cells
and metrics of ``portbench/parked.json`` enabled, so that they stay
tested until a benchmark PR enables them on the card."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "cfg4_dense_100k": {"n": 300, "m_bits": 4096},
    "cfg3_rare_10k": {"n": 300, "m_bits": 131072, "density": 0.001},
}
TINY_TRAFFIC = {
    "topk16_stream": {"superblock_rows": 256, "check_rows": 64},
    "screen_stream": {"superblock_rows": 256, "check_rows": 64, "pair_tail": 0.01},
    "lookup64": {"pool_batches": 4, "check_batches": 2, "warmup_units": 1, "stage_units": 2},
    "matrix": {"pool_panels": 2, "check_units": 2, "check_span": 4},
}


def merged_spec() -> dict:
    """BENCHMARK.json with the entries of portbench/parked.json added."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    parked = json.loads((ROOT / "portbench" / "parked.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        spec[key] = spec[key] + parked[key]
    return spec


def make_root(tmp: Path) -> Path:
    """A benchmark root under ``tmp`` whose cells run at tiny sizes."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    spec = merged_spec()
    for c in spec["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY_CONFIGS.get(c["name"], {}))
        path.write_text(json.dumps(cfg))
    for name, over in TINY_TRAFFIC.items():
        path = tmp / "portbench" / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(over)
        path.write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
