"""The port stands alone: ``stormtpu_torch``, ``chip_smoke.py``, the
port's examples (``examples/torch_*.py``) and its measuring scripts
(``scripts/torch_*.py``) import neither ``jax`` nor the
JAX package ``stormtpu`` (whose ``__init__`` imports JAX), checked both by
importing every module in a fresh interpreter and by scanning the
sources."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "stormtpu_torch"

_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import stormtpu_torch
names = [m.name for m in pkgutil.walk_packages(stormtpu_torch.__path__, "stormtpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
       or m == "stormtpu" or m.startswith("stormtpu.")]
assert not bad, bad
print(len(names))
"""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "stormtpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_importing_every_module_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 10  # every module was imported


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples").glob("torch_*.py"))
    + sorted((ROOT / "scripts").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_sources_import_no_jax(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


def test_the_five_examples_are_scanned():
    assert len(list((ROOT / "examples").glob("torch_*.py"))) == 5


def test_the_port_scripts_are_scanned():
    assert len(list((ROOT / "scripts").glob("torch_*.py"))) >= 6


def test_package_modules_are_all_scanned():
    import stormtpu_torch

    mods = {m.name for m in pkgutil.walk_packages(stormtpu_torch.__path__, "stormtpu_torch.")}
    assert {"stormtpu_torch.api", "stormtpu_torch.kernels.mxu",
            "stormtpu_torch.kernels._build", "stormtpu_torch.kernels.sparse",
            "stormtpu_torch.native", "stormtpu_torch.tuning", "stormtpu_torch.setops",
            "stormtpu_torch.query", "stormtpu_torch.cross", "stormtpu_torch.clump",
            "stormtpu_torch.stats", "stormtpu_torch.stream_hist",
            "stormtpu_torch.stream_query", "stormtpu_torch.parallel",
            "stormtpu_torch.parallel.mesh", "stormtpu_torch.parallel.allpairs",
            "stormtpu_torch.parallel.columns", "stormtpu_torch.parallel.setops",
            "stormtpu_torch.parallel.query", "stormtpu_torch.parallel.cross",
            "stormtpu_torch.parallel.stats", "stormtpu_torch.parallel.multihost",
            "stormtpu_torch.parallel.scaling", "stormtpu_torch.parallel.dryrun"} <= mods
