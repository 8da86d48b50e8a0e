"""The port's examples (``examples/torch_*.py``) run on the CPU: each
with ``--device cpu`` in a subprocess of its own (all five started
together, each with its own time limit), exiting 0 with its closing line,
and none of them, nor the ranks the distributed one spawns, importing JAX
or the JAX package (read from ``python -X importtime``)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_clustered", "torch_genotypes", "torch_streaming",
            "torch_distributed")
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def runs():
    procs = {name: subprocess.Popen(
        [sys.executable, "-X", "importtime", str(ROOT / "examples" / f"{name}.py"),
         "--device", "cpu"],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})  # five at once beside the other workers
        for name in EXAMPLES}
    out = {}
    try:
        for name, p in procs.items():
            try:
                stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
                stderr += f"\n{name}: killed after {TIMEOUT_S} s"
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _imported(stderr: str) -> set:
    """Top-level names of every module ``-X importtime`` reported."""
    return {line.rsplit("|", 1)[1].strip().split(".")[0]
            for line in stderr.splitlines() if line.startswith("import time:")}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(runs, name):
    rc, stdout, stderr = runs[name]
    tail = "\n".join(x for x in stderr.splitlines() if not x.startswith("import time:"))[-3000:]
    assert rc == 0, tail
    assert stdout.strip().splitlines()[-1] == f"{name}: all checks passed"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax(runs, name):
    imported = _imported(runs[name][2])
    assert "stormtpu_torch" in imported and "torch" in imported
    assert not imported & {"jax", "jaxlib", "stormtpu"}, imported & {"jax", "jaxlib", "stormtpu"}
