"""The port's acceptance runner on the CPU (configs 1 and 3 at their scaled
sizes; the card's full-scale parts run in ``chip_smoke.py``), held to the
JAX package's configs on the same inputs."""

import json

import numpy as np
import pytest

import stormtpu
import stormtpu.acceptance as jacc
from stormtpu import tuning as jtuning
from stormtpu.dispatch import choose_strategy as jax_choose
from stormtpu_torch import acceptance as tacc
from stormtpu_torch import tuning as ttuning


@pytest.fixture
def untuned(tmp_path, monkeypatch):
    """Both packages on their static routing (no tuning cache)."""
    monkeypatch.setenv(jtuning.CACHE_ENV, str(tmp_path / "none_jax.json"))
    monkeypatch.setenv(ttuning.CACHE_ENV, str(tmp_path / "none_torch.json"))


def test_config1_equals_jax(untuned):
    got = tacc.CONFIGS[1](False, lambda *a: None, "cpu")
    want = jacc.CONFIGS[1](False, lambda *a: None)
    assert got["exact"] is want["exact"] is True
    assert got["config"] == want["config"] == 1 and got["m_bits"] == want["m_bits"]
    assert got["seconds"] > 0


def test_config3_scaled_ingest_equals_jax(untuned):
    got = tacc.CONFIGS[3](False, lambda *a: None, "cpu")
    assert got["exact_sampled"] and "full" not in got  # the full pass runs on the card
    # the JAX package's ingest of the same positions: same density, same D1 choice
    n, m = 2000, 1_000_000
    rng = np.random.default_rng(103)
    rows = np.repeat(np.arange(n, dtype=np.int64), 8000)
    cols = rng.integers(0, m, n * 8000).astype(np.int64)
    bj = stormtpu.BitMatrix.from_positions(rows, cols, n, m)
    assert got["density"] == bj.density and 0.005 < got["density"] < 0.01
    assert got["dispatch"] == jax_choose(bj.n, bj.m_bits, bj.density) == "pallas_mxu"


def test_run_acceptance_merges_partial_runs(tmp_path, monkeypatch):
    out = tmp_path / "acceptance.json"
    out.write_text(json.dumps([{"config": 2, "keep": "me"},
                               {"config": 4, "full_stream": {"full": True}}]))
    monkeypatch.setattr(tacc, "CONFIGS", {3: lambda full, log, dev: {"config": 3, "fresh": 1}})
    ran = tacc.run_acceptance([3], log=lambda *a: None, out_path=str(out), device="cpu")
    assert ran[0]["config"] == 3 and ran[0]["device"] == "cpu"
    got = {e["config"]: e for e in json.loads(out.read_text())}
    assert set(got) == {2, 3, 4}
    assert got[2]["keep"] == "me" and got[4]["full_stream"]["full"] is True
    assert got[3]["fresh"] == 1 and got[3]["power_limit"] is None
    assert got[3]["wall_seconds"] >= 0
    # an unreadable artifact is overwritten
    out.write_text("{not json")
    tacc.run_acceptance([3], log=lambda *a: None, out_path=str(out), device="cpu")
    assert [e["config"] for e in json.loads(out.read_text())] == [3]


def test_config5_is_refused_and_the_default_runs_1_to_4(tmp_path, monkeypatch):
    """Config 5 runs (here a one-rank gloo group at 128 of its 2,048 rows:
    tests/test_torch_multihost.py runs its full scaled size over 8 ranks)
    and is sampled-exact; the default runs configs 1-5, as the JAX
    package's does."""
    out = tmp_path / "acceptance.json"
    monkeypatch.setattr(tacc, "CONFIG5_SCALED", (128, tacc.CONFIG5_SCALED[1]))
    ran = tacc.run_acceptance([5], log=lambda *a: None, out_path=str(out), device="cpu")
    assert set(ran[0]) - {"device", "power_limit", "wall_seconds"} == {
        "config", "n", "devices", "exact_sampled", "seconds", "pairs_per_s",
        "latency_bound", "sustained_pairs_per_s", "note"}
    assert ran[0]["config"] == 5 and ran[0]["n"] == 128 and ran[0]["devices"] == 1
    assert ran[0]["exact_sampled"] is True and ran[0]["sustained_pairs_per_s"] > 0
    assert [e["config"] for e in json.loads(out.read_text())] == [5]
    with pytest.raises(ValueError, match="unknown"):
        tacc.run_acceptance([6], log=lambda *a: None, out_path=str(out), device="cpu")
    assert set(jacc.CONFIGS) == set(tacc.CONFIGS)
    monkeypatch.setattr(tacc, "CONFIGS", {c: (lambda c: lambda full, log, dev: {"config": c})(c)
                                          for c in (1, 2, 3, 4, 5)})
    ran = tacc.run_acceptance(None, log=lambda *a: None, out_path=str(out), device="cpu")
    assert [r["config"] for r in ran] == [1, 2, 3, 4, 5]
    # no card here: the default device refuses, with nothing written
    out2 = tmp_path / "card.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        tacc.run_acceptance([1], log=lambda *a: None, out_path=str(out2))
    assert not out2.exists()
