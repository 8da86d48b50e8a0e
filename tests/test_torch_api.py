"""The port's entry points and D1 dispatch against the JAX package's, on
the CPU (``device="cpu"``), with shared numpy inputs and exact equality."""

import numpy as np
import pytest
import torch

import stormtpu
import stormtpu_torch as st
from stormtpu.api import count_block as jax_count_block
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu.dispatch import choose_strategy as jax_choose
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.dispatch import choose_strategy
from stormtpu_torch.oracle import oracle_count_block, oracle_count_matrix

from conftest import DENSITY_SWEEP

BIG_M = (1 << 17) + 33     # above the routing constant: K2


def _pair(n, m, density, seed):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, m)) < density).astype(np.uint8)
    bj = stormtpu.BitMatrix.from_dense(dense)
    return bj, st.BitMatrix.from_packed(bj.packed, m)


@pytest.mark.parametrize("strategy", ("popcount", "mxu", "pallas_mxu", "auto"))
@pytest.mark.parametrize("m", (1001, BIG_M))
@pytest.mark.parametrize("n", (1, 2, 37, 300))
def test_intersect_count_matrix_equals_jax(n, m, strategy):
    bj, bt = _pair(n, m, 0.3, seed=n + m)
    got = st.intersect_count_matrix(bt, strategy=strategy, device="cpu")
    want = stormtpu.intersect_count_matrix(bj, strategy=strategy)
    assert got.dtype == np.int32 and got.shape == (n, n)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bj.packed))


@pytest.mark.parametrize("density", DENSITY_SWEEP)
def test_auto_equals_jax_across_densities(density):
    bj, bt = _pair(70, 3000, density, seed=11)
    got = st.intersect_count_matrix(bt, device="cpu")
    assert np.array_equal(got, stormtpu.intersect_count_matrix(bj))
    assert np.array_equal(got, oracle_count_matrix(bj.packed))


def test_multi_tile_k2_walk_equals_jax():
    bj, bt = _pair(70, BIG_M, 0.2, seed=12)
    cfg = EngineConfig(k2_tile_rows=32)
    got = st.intersect_count_matrix(bt, strategy="pallas_mxu", config=cfg, device="cpu")
    want = stormtpu.intersect_count_matrix(
        bj, strategy="pallas_mxu", config=JaxConfig(k2_tile_rows=32))
    assert np.array_equal(got, want)


def test_compaction_equals_jax():
    rng = np.random.default_rng(13)
    dense = np.zeros((40, 4096), np.uint8)
    dense[:, 100:400] = rng.random((40, 300)) < 0.5  # most word columns empty
    bj = stormtpu.BitMatrix.from_dense(dense)
    bt = st.BitMatrix.from_packed(bj.packed, 4096)
    for s in ("popcount", "mxu", "pallas_mxu"):
        assert np.array_equal(st.intersect_count_matrix(bt, strategy=s, device="cpu"),
                              stormtpu.intersect_count_matrix(bj, strategy=s))
    empty = st.BitMatrix.from_dense(np.zeros((5, 300), np.uint8))
    got = st.intersect_count_matrix(empty, strategy="pallas_mxu", device="cpu")
    assert got.dtype == np.int32 and not got.any() and got.shape == (5, 5)


@pytest.mark.parametrize("m", (1001, BIG_M))
def test_count_block_and_pair_count_equal_jax(m):
    aj, at = _pair(5, m, 0.3, seed=14)
    bj, bt = _pair(41, m, 0.6, seed=15)
    got = st.count_block(at, bt, device="cpu")
    assert got.dtype == np.int32 and got.shape == (5, 41)
    assert np.array_equal(got, jax_count_block(aj, bj))
    assert np.array_equal(got, oracle_count_block(aj.packed, bj.packed))
    dense_a, dense_b = at.to_dense()[0], bt.to_dense()[0]
    got = st.pair_count(dense_a, dense_b, device="cpu")
    assert isinstance(got, int)
    assert got == stormtpu.pair_count(dense_a, dense_b)
    assert st.pair_count(st.BitMatrix.from_packed(at.packed[:1], m),
                         st.BitMatrix.from_packed(bt.packed[:1], m),
                         device="cpu") == got


def test_choose_strategy_grid_equals_jax():
    cfg, jcfg = EngineConfig(), JaxConfig()
    for n in (1, 2, 63, 64, 500):
        for m in (100, 1 << 17, (1 << 17) + 1, 1 << 20):
            for density in (0.0, 0.0001, 0.001, 0.01, 0.5):
                want = jax_choose(n, m, density, jcfg)
                assert choose_strategy(n, m, density, cfg, device="cpu") == want, \
                    (n, m, density)


def test_choose_strategy_with_matrix_equals_jax():
    rng = np.random.default_rng(16)
    n, m = 96, 64 * 32 * 8
    dense = (rng.random((n, m)) < 0.3).astype(np.uint8)
    mask = np.zeros_like(dense)
    for blk in range(3):  # block-diagonal: the K5 regime
        mask[blk * 32:(blk + 1) * 32, blk * 4096:(blk + 1) * 4096] = 1
    cfg = EngineConfig(k2_tile_rows=32, k2_tile_words=128)
    jcfg = JaxConfig(k2_tile_rows=32, k2_tile_words=128)
    for d, want in ((dense & mask, "clustered"), (dense, "mxu")):
        bj = stormtpu.BitMatrix.from_dense(d)
        bt = st.BitMatrix.from_packed(bj.packed, m)
        assert jax_choose(bj.n, m, bj.density, jcfg, bm=bj) == want
        assert choose_strategy(bt.n, m, bt.density, cfg, bm=bt, device="cpu") == want
        # auto runs the strategy D1 names (K5 for the clustered input); the
        # counts stay exact
        got = st.intersect_count_matrix(bt, config=cfg, device="cpu")
        assert np.array_equal(got, oracle_count_matrix(bj.packed))


def test_choose_strategy_sparse_branch_by_device(monkeypatch):
    # on the CPU both packages name K3; on CUDA the port weighs K4 against
    # K2 with its own constants (K4_DEFAULTS, measured on the H100)
    from stormtpu_torch import native
    from stormtpu_torch.dispatch import k4_estimates

    assert jax_choose(500, 1 << 20, 0.0001) == "sparse"
    assert choose_strategy(500, 1 << 20, 0.0001, device="cpu") == "sparse"
    for n, m in ((500, 1 << 20), (500, 1000)):
        est_k4, est_k2 = k4_estimates(n, m, 0.0001)
        dense = "pallas_mxu"  # an untuned card takes K2 at every M
        want = "sparse_outer" if est_k4 < est_k2 and native.have_native() else dense
        assert choose_strategy(n, m, 0.0001, device="cuda") == want
        assert choose_strategy(n, m, 0.0001) == want
    bj, bt = _pair(70, 3000, 0.0001, seed=17)
    assert np.array_equal(st.intersect_count_matrix(bt, device="cpu"),
                          stormtpu.intersect_count_matrix(bj))


# cost constants under which K4 is cheap, and under which it is dear
K4_CHEAP = dict(c_sort_s_per_nnz=1e-12, c_n2_s_per_elem=1e-12, c_emit_s_per_emission=1e-12,
                k2_int8_ops_per_s=1e12, dispatch_floor_s=0.01)
K4_DEAR = dict(c_sort_s_per_nnz=1.0, c_n2_s_per_elem=1.0, c_emit_s_per_emission=1.0,
               k2_int8_ops_per_s=1e18, dispatch_floor_s=0.0)


@pytest.mark.parametrize("consts", ("cheap", "dear"))
@pytest.mark.parametrize("n,m,density", [
    (500, 1 << 20, 0.0001), (500, 1000, 0.0005), (2, 4096, 0.0009), (32768, 1 << 20, 1e-6),
    (32769, 1 << 20, 1e-6), (500, 1 << 20, 0.001), (1, 1 << 20, 0.0001),
])
def test_d1_on_cuda_weighs_k4_as_jax_does_on_its_chip(tmp_path, monkeypatch, n, m, density,
                                                       consts):
    """Scalar-only D1 on the card (no card needed: D1 only names a
    strategy) against the JAX package's D1 as it runs on its chip, both
    with the same constants: K4 below the density threshold where it is
    cheaper, N <= 32768 and the C++ tier is built; the dense choice else."""
    import json

    import jax

    import stormtpu.utils
    from stormtpu import tuning as jtuning
    from stormtpu_torch import native
    from stormtpu_torch import tuning as ttuning

    pinned = K4_CHEAP if consts == "cheap" else K4_DEAR
    cache = tmp_path / "tuning.json"
    cache.write_text(json.dumps({"device": str(jax.devices()[0]), "k4_cost_model": pinned}))
    monkeypatch.setenv(jtuning.CACHE_ENV, str(cache))
    monkeypatch.setattr(stormtpu.utils, "is_tpu_backend", lambda: True)
    for k, v in pinned.items():
        monkeypatch.setitem(ttuning.K4_DEFAULTS, k, v)
    assert native.have_native(), native.native_build_error()
    want = jax_choose(n, m, density)
    # where the chip's static rule takes the plain product, an untuned card
    # takes K2 (kernels.plain_product_max_bits is 0 there)
    assert choose_strategy(n, m, density, device="cuda") == (
        "pallas_mxu" if want == "mxu" else want)
    k4 = consts == "cheap" and n <= 32768 and 2 <= n and density < 0.001
    assert (want == "sparse_outer") == k4
    monkeypatch.setattr(native, "_load", lambda: None)  # without the C++ tier: dense
    assert choose_strategy(n, m, density, device="cuda") != "sparse_outer"


@pytest.mark.parametrize("strategy", ("sparse", "sparse_outer"))
@pytest.mark.parametrize("n", (1, 2, 37, 150))
def test_sparse_strategies_equal_jax(n, strategy):
    bj, bt = _pair(n, 1001, 0.02, seed=18 + n)
    got = st.intersect_count_matrix(bt, strategy=strategy, device="cpu")
    want = stormtpu.intersect_count_matrix(bj, strategy=strategy)
    assert got.dtype == np.int32 and got.shape == (n, n)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bj.packed))


def test_error_paths_match_jax(monkeypatch):
    raw = np.zeros((3, 4), np.uint32)
    aj, at = _pair(3, 100, 0.5, seed=19)
    bj, bt = _pair(3, 101, 0.5, seed=20)
    cases = [
        (TypeError, lambda: st.intersect_count_matrix(raw, device="cpu"),
         lambda: stormtpu.intersect_count_matrix(raw)),
        (TypeError, lambda: st.count_block(raw, at, device="cpu"),
         lambda: jax_count_block(raw, aj)),
        (ValueError, lambda: st.count_block(at, bt, device="cpu"),
         lambda: jax_count_block(aj, bj)),
        (ValueError, lambda: st.pair_count(at.to_dense()[0], bt.to_dense()[0], device="cpu"),
         lambda: stormtpu.pair_count(aj.to_dense()[0], bj.to_dense()[0])),
        (ValueError, lambda: st.pair_count(at, at, device="cpu"),
         lambda: stormtpu.pair_count(aj, aj)),
        (ValueError, lambda: st.intersect_count_matrix(at, strategy="bogus", device="cpu"),
         lambda: stormtpu.intersect_count_matrix(aj, strategy="bogus")),
        (ValueError, lambda: st.intersect_count_matrix(
            at, config=EngineConfig(max_bits=64), device="cpu"),
         lambda: stormtpu.intersect_count_matrix(aj, config=JaxConfig(max_bits=64))),
    ]
    for exc, port, ref in cases:
        with pytest.raises(exc):
            ref()
        with pytest.raises(exc):
            port()
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", "50")
    for s in ("popcount", "mxu", "pallas_mxu"):
        with pytest.raises(ValueError, match="device budget") as ref_err:
            stormtpu.intersect_count_matrix(aj, strategy=s)
        with pytest.raises(ValueError, match="device budget") as port_err:
            st.intersect_count_matrix(at, strategy=s, device="cpu")
        # both name their own streamed forms (the port's since stream_query is ported)
        assert "stormtpu_torch.stream_query" in str(port_err.value)
        assert "stormtpu.stream_query" in str(ref_err.value)


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, bt = _pair(3, 100, 0.5, seed=21)
    for call in (lambda: st.intersect_count_matrix(bt),
                 lambda: st.count_block(bt, bt),
                 lambda: st.pair_count(bt.to_dense()[0], bt.to_dense()[0]),
                 lambda: st.intersect_count_matrix(bt, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError):
        st.intersect_count_matrix(bt, device="meta")


# ------------------------------------------------------------ public surface
# What the JAX package has and the port leaves out on purpose (README.md,
# "Differences"): TPU and relay machinery. Every other public name of every
# module has its counterpart, with every parameter name of the reference.
ABSENT_NAMES = {
    "stormtpu.config": {"LANE", "SUBLANE"},
    "stormtpu.utils": {"V5E_INT8_PEAK_OPS", "enable_compilation_cache", "is_tpu_backend",
                       "pallas_interpret_default", "timeit_chain_salted",
                       "timeit_sustained_salted"},
    "stormtpu.utils.backend": {"V5E_INT8_PEAK_OPS", "enable_compilation_cache",
                               "is_tpu_backend", "pallas_interpret_default"},
    "stormtpu.utils.profiling": {"timeit_chain_salted", "timeit_sustained_salted"},
}
# parameters of the reference the port's counterpart does not take; no
# function of the port takes ``interpret`` (Pallas's interpret mode)
ABSENT_PARAMS = {
    ("stormtpu.utils", "timeit_sustained_auto"): {"dispatch_floor_s"},
    ("stormtpu.utils.profiling", "timeit_sustained_auto"): {"dispatch_floor_s"},
    ("stormtpu.parallel.mesh", "fetch_global"): {"x"},  # the port's takes (x_local, mesh)
    ("stormtpu.cli", "cmd_info"): {"_args"},  # the port's reads its device from args
}


def _reference_modules():
    import importlib.util
    import pkgutil

    names = ["stormtpu"] + [m.name for m in pkgutil.walk_packages(stormtpu.__path__, "stormtpu.")
                            if not m.name.endswith("__main__")]
    return [n for n in names if importlib.util.find_spec(n).origin.endswith(".py")]


def _public(mod) -> set:
    """``__all__``, else the functions and classes the module defines and
    its upper-case constants."""
    import inspect

    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, o in vars(mod).items() if not n.startswith("_") and (
        ((inspect.isfunction(o) or inspect.isclass(o)) and o.__module__ == mod.__name__)
        or (n.isupper() and isinstance(o, (int, float, str, tuple, frozenset, dict))))}


def _params(fn):
    import inspect

    try:
        return [p.name for p in inspect.signature(fn).parameters.values()]
    except (TypeError, ValueError):
        return None


@pytest.mark.parametrize("name", _reference_modules())
def test_every_public_name_and_parameter_has_its_counterpart(name):
    import importlib

    ref = importlib.import_module(name)
    port = importlib.import_module("stormtpu_torch" + name[len("stormtpu"):])
    missing = _public(ref) - _public(port)
    assert missing == ABSENT_NAMES.get(name, set()), missing
    for attr in sorted(_public(ref) & _public(port)):
        a, b = getattr(ref, attr), getattr(port, attr)
        pa, pb = (_params(a), _params(b)) if callable(a) and callable(b) else (None, None)
        if pa is None or pb is None:
            continue
        lost = set(pa) - set(pb) - {"interpret"}
        assert lost == ABSENT_PARAMS.get((name, attr), set()), (attr, lost)
        assert "interpret" not in pb, attr
