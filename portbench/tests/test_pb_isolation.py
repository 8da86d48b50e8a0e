"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
(``stormtpu``), compared by whole top-level names; the reference imports
nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.tiny import ROOT

PB = ROOT / "portbench"
SOURCES = sorted(p for p in PB.rglob("*.py") if "out" not in p.relative_to(PB).parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_whole_top_level_names(monkeypatch):
    assert harness.FORBIDDEN_TOP == ("jax", "jaxlib", "flax", "stormtpu")
    for name in ("stormtpu_torch_extra", "stormtpu_torch_extra.layout", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stormtpu.native", object())
    assert harness.forbidden_modules() == ["stormtpu"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN_TOP), path
    if "reference" in path.relative_to(PB).parts:
        assert "stormtpu_torch" not in tops, path


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
from portbench import harness
from portbench.tests import tiny
from pathlib import Path
root = tiny.make_root(Path({str(tmp_path)!r}))
out = harness.run_cell(root, "c4.lookup64", 3, 0.3, False, torch.device("cpu"),
                       time.perf_counter(), log=lambda m: None)
assert out["correct"], out
bad = sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "stormtpu"}})
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "BAD []"
