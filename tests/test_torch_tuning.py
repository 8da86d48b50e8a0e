"""The port's tuning cache, its measured routing and its timers against
the JAX package's, on the CPU: one cache dict fed to both packages (only
its ``device`` field rewritten), shared shapes, exact equality."""

import json
import os

import jax
import numpy as np
import pytest

from stormtpu import tuning as jtuning
from stormtpu.dispatch import choose_strategy as jax_choose
from stormtpu.stream import _auto_stream_kernel as jax_stream_kernel
from stormtpu_torch import tuning as ttuning
from stormtpu_torch.dispatch import choose_strategy
from stormtpu_torch.stream import _auto_stream_kernel

from conftest import random_bitmatrix

SHAPES = [(n, m) for n in (1, 63, 64, 100, 256, 1000, 4096, 20000, 100_000)
          for m in (1000, 8192, 40_000, 65536, 131_072, 131_105, 300_000, 1 << 20, 1 << 22)]

# every winner leads the rest by more than the port's K2_MARGIN, so both
# packages name the same one (the margin has its own test below)
GRID_CACHE = {
    "grid": [[256, 8192], [256, 1048576], [4096, 65536], [16384, 8192], [16384, 1048576]],
    "buckets": {
        "256x8192": {"dense_pairs_per_s": {"popcount": 20.0, "mxu": 5.0, "pallas_mxu": 1.0}},
        "256x1048576": {"dense_pairs_per_s": {"mxu": 7.0, "pallas_dense": 6.0,
                                              "pallas_mxu": 2.0}},
        "4096x65536": {"dense_pairs_per_s": {"mxu": 3.0, "pallas_dense": 8.0,
                                             "pallas_mxu": 4.0}},
        "16384x8192": {"dense_pairs_per_s": {"mxu": 12.0, "pallas_mxu": 8.0}},
        "16384x1048576": {"dense_pairs_per_s": {"popcount": 0.1, "pallas_dense": 5.0,
                                                "pallas_mxu": 6.0}},
        "1024x1024": {"dense_pairs_per_s": {}},
    },
}
LEGACY_CACHE = {"dense_pairs_per_s": {"popcount": 1.0, "mxu": 3.0, "pallas_mxu": 2.0}}


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Pin both packages' cache paths into ``tmp_path`` (no snapshot) and
    return a writer of one dict to both, each with its own device name."""
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    monkeypatch.setenv(jtuning.CACHE_ENV, str(jpath))
    monkeypatch.setenv(ttuning.CACHE_ENV, str(tpath))

    def write(cache: dict) -> None:
        jpath.write_text(json.dumps({**cache, "device": str(jax.devices()[0])}))
        tpath.write_text(json.dumps({**cache, "device": "cpu"}))

    return write


@pytest.mark.parametrize("fmt", ("grid", "legacy"))
def test_measured_winner_and_d1_equal_jax_on_one_cache(caches, fmt):
    caches(GRID_CACHE if fmt == "grid" else LEGACY_CACHE)
    assert ttuning.measured_dense_winner(device="cpu") == jtuning.measured_dense_winner()
    for n, m in SHAPES:
        want = jtuning.measured_dense_winner(n, m)
        assert ttuning.measured_dense_winner(n, m, device="cpu") == want, (n, m)
        # D1 follows the winner, with the "mxu" memory guard above 2^17 bits
        # on the CPU in both packages
        assert choose_strategy(n, m, 0.5, device="cpu") == jax_choose(n, m, 0.5), (n, m)
        assert _auto_stream_kernel(m, n, "cpu") == jax_stream_kernel(m, n), (n, m)


@pytest.mark.parametrize("k1,want", [(1.0, "pallas_mxu"), (1.15, "pallas_mxu"),
                                     (1.25, "pallas_dense"), (0.5, "pallas_mxu")])
def test_k2_keeps_a_bucket_another_strategy_beats_by_less_than_the_margin(caches, k1, want):
    caches({"buckets": {"256x8192": {"dense_pairs_per_s": {
        "pallas_mxu": 10.0, "pallas_dense": 10.0 * k1, "mxu": 1.0}}}})
    assert ttuning.measured_dense_winner(256, 8192, device="cpu") == want
    assert ttuning.measured_dense_winner(device="cpu") == want
    assert choose_strategy(256, 8192, 0.5, device="cpu") == want
    # the JAX package takes the fastest
    assert jtuning.measured_dense_winner(256, 8192) == ("pallas_dense" if k1 > 1 else
                                                        "pallas_mxu")


def test_no_shape_gives_the_whole_cache_best(caches):
    caches(GRID_CACHE)
    assert ttuning.measured_dense_winner(device="cpu") == "popcount"
    caches({"buckets": {}})
    assert ttuning.measured_dense_winner(device="cpu") is None
    assert jtuning.measured_dense_winner() is None


def test_a_cache_applies_to_its_device_only(caches, monkeypatch):
    caches(GRID_CACHE)
    assert ttuning.measured_dense_winner(300, 10_000, device="cpu") == "popcount"
    # no card here: a cache for the CPU does not route the card
    assert ttuning.measured_dense_winner(300, 10_000, device="cuda") is None
    assert choose_strategy(300, 10_000, 0.5, device="cuda") == "pallas_mxu"  # untuned: K2
    # a card whose name the cache holds follows it
    monkeypatch.setattr(ttuning, "device_name",
                        lambda device=None: "cpu" if device is None else "other")
    assert ttuning.measured_dense_winner(300, 10_000) == "popcount"
    assert ttuning.measured_dense_winner(300, 10_000, device="cpu") is None


def test_stale_device_and_corrupt_caches_are_ignored(tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    monkeypatch.setenv(ttuning.CACHE_ENV, str(path))
    path.write_text(json.dumps({"device": "NVIDIA imaginary", **LEGACY_CACHE}))
    assert ttuning.measured_dense_winner(device="cpu") is None
    assert ttuning.k4_constants("cpu") == ttuning.K4_DEFAULTS
    path.write_text("{not json")
    assert ttuning.load_tuning() is None
    assert ttuning.measured_dense_winner(100, 1000, device="cpu") is None
    assert choose_strategy(100, 1000, 0.5, device="cpu") == jax_choose(100, 1000, 0.5)


def test_pinned_cache_path_opts_out_of_the_snapshot(tmp_path, monkeypatch):
    # the port never reads the JAX package's snapshot or cache
    assert ttuning._SNAPSHOT_CACHE != jtuning._SNAPSHOT_CACHE
    assert ttuning._DEFAULT_CACHE.endswith(
        os.path.join(".cache", "stormtpu_torch", "tuning.json"))
    assert ttuning.CACHE_ENV == "STORMTPU_TORCH_TUNING_CACHE"
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps({"device": "cpu", **LEGACY_CACHE}))
    monkeypatch.setattr(ttuning, "_SNAPSHOT_CACHE", str(snap))
    monkeypatch.setenv(ttuning.CACHE_ENV, str(tmp_path / "missing.json"))
    assert ttuning.load_tuning() is None
    monkeypatch.delenv(ttuning.CACHE_ENV)
    monkeypatch.setattr(ttuning, "_DEFAULT_CACHE", str(tmp_path / "nope" / "tuning.json"))
    assert ttuning.load_tuning()["device"] == "cpu"
    assert ttuning.measured_dense_winner(device="cpu") == "mxu"


def test_shipped_snapshot_names_a_card_and_never_routes_the_cpu(monkeypatch):
    with open(os.path.join(os.path.dirname(ttuning.__file__), "data",
                           "tuning_snapshot.json")) as f:
        snap = json.load(f)
    assert snap["device"].startswith("NVIDIA")
    assert sorted(map(tuple, snap["grid"])) == sorted(ttuning.DEFAULT_GRID)
    assert set(snap["buckets"]) == {f"{n}x{m}" for n, m in ttuning.DEFAULT_GRID}
    for b in snap["buckets"].values():
        assert set(b["dense_pairs_per_s"]) <= set(ttuning._DENSE_PATHS)
        assert min(b["dense_pairs_per_s"].values()) > 0
    assert set(snap["k4_cost_model"]) >= set(ttuning.K4_DEFAULTS) >= {
        "c_emit_host_s_per_emission", "c_download_s_per_elem", "c_k2_host_s_per_word",
        "c_stripe_n2_s_per_elem"}
    monkeypatch.delenv(ttuning.CACHE_ENV, raising=False)
    monkeypatch.setattr(ttuning, "_DEFAULT_CACHE", "/nonexistent/tuning.json")
    assert ttuning.load_tuning()["device"] == snap["device"]
    assert ttuning.measured_dense_winner(4096, 65536, device="cpu") is None
    assert ttuning.k4_constants("cpu") == ttuning.K4_DEFAULTS


def test_k4_constants_come_from_the_cache(caches):
    fit = {"c_sort_s_per_nnz": 1.0, "c_n2_s_per_elem": 2.0, "c_emit_s_per_emission": 3.0,
           "k2_int8_ops_per_s": 4.0, "dispatch_floor_s": 5.0}
    caches({"k4_cost_model": fit})
    assert ttuning.k4_cost_model("cpu") == fit == jtuning.k4_cost_model()
    assert ttuning.k4_constants("cpu") == {**ttuning.K4_DEFAULTS, **fit}
    assert ttuning.k4_cost_model() is None  # the card: absent here
    assert ttuning.tuned_variant("k2", "planes") == "planes"


@pytest.fixture
def quick(monkeypatch):
    """tune() on the CPU without its probes' full sizes: the K4 refit is
    left out (tested below at small sizes) and the dispatch floor taken at
    64 x 4096 bits."""
    monkeypatch.setattr(ttuning, "refit_k4_constants", lambda *a, **k: None)
    monkeypatch.setattr(ttuning, "FLOOR_SHAPE", (64, 4096))


def _tune_cpu(**kw):
    kw.setdefault("reps", 1)
    return ttuning.tune(device="cpu", log=lambda *a: None, **kw)


def test_tune_on_the_cpu_writes_a_cache_that_d1_follows(tmp_path, monkeypatch, quick):
    path = tmp_path / "t.json"
    monkeypatch.setenv(ttuning.CACHE_ENV, str(path))
    result = _tune_cpu(shapes=[(64, 4096)])
    assert path.exists() and ttuning.load_tuning() == json.loads(path.read_text())
    assert result["device"] == "cpu"
    rates = result["buckets"]["64x4096"]["dense_pairs_per_s"]
    assert set(rates) == set(ttuning._DENSE_PATHS) and min(rates.values()) > 0
    winner = ttuning._winner(rates)
    assert ttuning.measured_dense_winner(64, 4096, device="cpu") == winner
    assert choose_strategy(64, 4096, 0.5, device="cpu") == winner
    assert choose_strategy(70, 5000, 0.5, device="cpu") == winner
    assert result["dispatch_floor_s"] > 0
    # auto follows it and stays exact
    import stormtpu_torch as st

    bm = random_bitmatrix(64, 4096, 0.3, seed=3)
    bt = st.BitMatrix.from_packed(bm.packed, 4096)
    assert np.array_equal(st.intersect_count_matrix(bt, device="cpu"),
                          st.oracle_count_matrix(bm.packed))


def test_single_shape_tune_merges_into_a_grid_cache(tmp_path, monkeypatch, quick):
    path = tmp_path / "t.json"
    monkeypatch.setenv(ttuning.CACHE_ENV, str(path))
    prev = {"device": "cpu", "grid": [[16384, 1048576], [256, 8192]],
            "buckets": {"16384x1048576": {"dense_pairs_per_s": {"pallas_mxu": 100.0},
                                          "latency_bound": []},
                        "256x8192": {"dense_pairs_per_s": {"popcount": 5.0},
                                     "latency_bound": []}},
            "k4_cost_model": {"c_sort_s_per_nnz": 1.0}}
    path.write_text(json.dumps(prev))
    _tune_cpu(n=32, m_bits=1024)
    out = ttuning.load_tuning()
    assert set(out["buckets"]) == {"16384x1048576", "256x8192", "32x1024"}
    assert out["buckets"]["16384x1048576"]["dense_pairs_per_s"] == {"pallas_mxu": 100.0}
    assert sorted(map(tuple, out["grid"])) == [(32, 1024), (256, 8192), (16384, 1048576)]
    assert out["shape"] == {"n": 32, "m_bits": 1024}
    # the previous buckets' rates predict the new one's calls: at 5 pairs/s
    # the plain popcount would take hours, so it is not launched
    assert set(out["dense_pairs_per_s"]) == set(ttuning._DENSE_PATHS) - {"popcount"}
    assert out["buckets"]["32x1024"]["skipped"] == ["popcount"]
    assert out["k4_cost_model"] == prev["k4_cost_model"]  # no refit: the previous fit stays
    # a grid run writes no single-shape fields and drops a stale-device cache
    path.write_text(json.dumps({**prev, "device": "NVIDIA other"}))
    _tune_cpu(shapes=[(32, 1024), (64, 1024)])
    out = ttuning.load_tuning()
    assert "shape" not in out and "dense_pairs_per_s" not in out
    assert set(out["buckets"]) == {"32x1024", "64x1024"} and "k4_cost_model" not in out
    with pytest.raises(ValueError, match="both"):
        ttuning.tune(n=32, device="cpu")


def test_roofline_guard_flags_impossible_rates():
    bucket = ttuning._tune_shape(32, 1024, 1, 30.0, lambda *a: None, device="cpu",
                                 peak_ops_per_s=1.0)
    assert set(bucket["roofline_suspect"]) == set(ttuning._DENSE_PATHS)
    assert set(bucket["dense_pairs_per_s"]) == set(ttuning._DENSE_PATHS)


def test_a_candidate_predicted_past_the_budget_is_not_launched(monkeypatch):
    from stormtpu_torch.kernels import xla

    calls = []
    real = xla.count_block_popcount_xla
    monkeypatch.setattr(xla, "count_block_popcount_xla",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    expect = {"popcount": 1.0}  # one pair-bit a second: hours at 32 x 1024
    bucket = ttuning._tune_shape(32, 1024, 1, 1.0, lambda *a: None, device="cpu",
                                 expect=expect)
    assert calls == [] and bucket["skipped"] == ["popcount"]
    assert "popcount" not in bucket["dense_pairs_per_s"]
    # measured candidates raise the expectation for the next bucket
    assert expect["mxu"] == bucket["dense_pairs_per_s"]["mxu"] * 1024
    bucket = ttuning._tune_shape(32, 1024, 1, 0.0, lambda *a: None, device="cpu")
    assert set(bucket["latency_bound"]) == set(ttuning._DENSE_PATHS)


@pytest.mark.parametrize("ceiling", (0, 512))
def test_the_plain_product_above_its_ceiling_is_not_launched(monkeypatch, ceiling):
    # on the H100 kernels.MXU_XLA_MAX_BITS is 0: D1 never takes "mxu" there,
    # so the tuner does not measure it
    import stormtpu_torch.kernels as tk
    from stormtpu_torch.kernels import xla

    calls = []
    real = xla.count_block_int8_xla
    monkeypatch.setattr(xla, "count_block_int8_xla",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tk, "plain_product_max_bits", lambda device=None: ceiling)
    bucket = ttuning._tune_shape(32, 1024, 1, 30.0, lambda *a: None, device="cpu")
    assert calls == [] and bucket["skipped"] == ["mxu"]
    assert set(bucket["dense_pairs_per_s"]) == set(ttuning._DENSE_PATHS) - {"mxu"}


def test_an_inexact_candidate_fails_the_tune(monkeypatch):
    from stormtpu_torch.kernels import xla

    monkeypatch.setattr(xla, "count_block_int8_xla",
                        lambda a, b: xla.count_block_popcount_xla(a, b) + 1)
    with pytest.raises(AssertionError, match="mxu is INEXACT"):
        ttuning._tune_shape(32, 1024, 1, 30.0, lambda *a: None, device="cpu")


def test_refit_k4_constants_on_the_cpu(monkeypatch):
    from stormtpu_torch import native

    monkeypatch.setattr(ttuning, "K4_PROBE", {"sort_keys": 20_000, "n": 300,
                                              "m_bits": 1 << 15, "density": 1e-2,
                                              "slice_rows": 64})
    fit = ttuning.refit_k4_constants(lambda *a: None, device="cpu")
    assert native.have_native()
    for key in ("c_sort_s_per_nnz", "c_n2_s_per_elem", "c_emit_s_per_emission",
                "h2d_bytes_per_s", "c_stripe_n2_s_per_elem", "c_k2_stripe_s_per_op",
                "c_k4_stripe_s", "c_k4_gather_s_per_elem", "c_k4_gather_s_per_position"):
        assert fit[key] >= 0.0
    probe = fit["probe"]
    assert probe["emissions"] > 0 and probe["nnz"] == int(300 * (1 << 15) * 1e-2)


def test_the_grid_is_the_jax_packages():
    assert ttuning.DEFAULT_GRID == jtuning.DEFAULT_GRID
    assert set(ttuning._DENSE_PATHS) == set(jtuning._DENSE_PATHS)


def test_timers_on_the_cpu(tmp_path):
    import torch

    from stormtpu_torch.utils import profiling

    xs = [torch.full((64, 64), i, dtype=torch.int32) for i in range(3)]
    seen = []

    def fn(x):
        seen.append(int(x[0, 0]))
        return x @ x

    assert profiling.timeit_chain(fn, xs, 2) > 0
    assert seen == [0, 1, 1, 2, 2]  # warm on xs[0], then the chain over xs[1:]
    assert profiling.timeit_sustained(fn, xs, 1, 3) > 0
    assert profiling.timeit_sustained_auto(fn, xs) > 0
    with pytest.raises(ValueError):
        profiling.timeit_sustained(fn, xs, 3, 3)
    with profiling.trace(None):
        fn(xs[0])
    with profiling.trace(str(tmp_path / "tr")):
        fn(xs[0])
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())
