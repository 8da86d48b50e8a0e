"""``stormtpu_torch.parallel``'s streaming walk, ``extend_streamed_matrix(
mesh=...)``, the scaling harness, acceptance config 5 and the multi-rank
dry run on the CPU, against ``stormtpu.parallel`` and the oracle.

One spawned group of 8 gloo ranks runs every case
(``torch_parallel_cases.run_multihost``) into directories under a
temporary root; the tests read them back here with both packages'
loaders. Directories and manifests must equal the JAX package's.
"""

import functools
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_parallel_cases as cases
from stormtpu import parallel as jp
from stormtpu.layout import BitMatrix as JaxBitMatrix
from stormtpu.oracle import oracle_count_matrix
from stormtpu.stream import load_streamed_matrix as jax_load
from stormtpu.stream import stripe_path
from stormtpu_torch.parallel.dryrun import run_group
from stormtpu_torch.stream import load_streamed_matrix

GROUP_TIMEOUT_S = 400
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    return run_group(cases.WORLD, "gloo", "cpu", cases.run_multihost, str(root),
                     timeout=GROUP_TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _data():
    return cases.data()


def _jbm(name):
    packed, m = _data()[name]
    return JaxBitMatrix.from_packed(packed, m)


def _stream_name(case):
    return {"stream": "stream", "stream_zero_stripe": "stream_blocks"}[case]


STREAMS = [(case, shape) for case in ("stream", "stream_zero_stripe")
           for shape in cases.MULTIHOST[case][1]]


def _superblock(shape: str) -> int:
    """The walk's superblock on ``shape``: 64 rows rounded up to the row
    axis's ranks × 8 (the only part of the manifest the mesh decides)."""
    r = int(shape[1:].split("x")[0])
    return -(-64 // (8 * r)) * 8 * r


@functools.lru_cache(maxsize=None)
def _jax_manifest(name: str, sb: int, out_dir: str) -> dict:
    """The JAX package's manifest of ``name`` at superblock ``sb``, walked
    on the fewest devices that give it."""
    r = min(r for r in cases.ROWS if _superblock(f"r{r}") == sb)
    return jp.distributed_stream_count_matrix(_jbm(name), out_dir, superblock_rows=64,
                                              mesh=jp.make_row_mesh(r))


@pytest.mark.parametrize("case,shape", STREAMS, ids=[f"{c}-{s}" for c, s in STREAMS])
def test_stream_equals_jax(ranks, tmp_path_factory, case, shape):
    got = ranks[0][(case, shape)]
    name = _stream_name(case)
    want = oracle_count_matrix(_data()[name][0])
    # both packages load the port's directory to the counts
    np.testing.assert_array_equal(load_streamed_matrix(got["dir"]), want)
    np.testing.assert_array_equal(jax_load(got["dir"]), want)
    sb = _superblock(shape)
    jman = _jax_manifest(name, sb, str(tmp_path_factory.mktemp(f"jax_{name}_{sb}")))
    assert got["manifest"] == jman and jman["superblock_rows"] == sb
    total = jman["n_super"] * (jman["n_super"] + 1) // 2
    assert got["progress"] == list(range(1, total + 1))
    assert got["progress_resumed"] == []  # every stripe resumed from its file
    if case == "stream_zero_stripe":
        with np.load(stripe_path(got["dir"], 0, 1)) as z:
            assert "tiles" in z.files and z["tiles"].size == 0


EXTENDS = list(cases.MULTIHOST["extend"][1])


@pytest.fixture(scope="module")
def jax_extend(tmp_path_factory):
    """The JAX package's extend through a mesh, of a directory the JAX
    single-device walk wrote for the first 80 rows (the manifest does not
    depend on the mesh: the superblock comes from the directory)."""
    from stormtpu.config import EngineConfig
    from stormtpu.stream import extend_streamed_matrix, stream_count_matrix

    out = str(tmp_path_factory.mktemp("jax_extend"))
    packed, m = _data()["stream"]
    stream_count_matrix(JaxBitMatrix.from_packed(packed[:80], m), out, superblock_rows=64,
                        kernel="mxu", config=EngineConfig(k2_tile_rows=32))
    return extend_streamed_matrix(JaxBitMatrix.from_packed(packed, m), out,
                                  mesh=jp.make_row_mesh(8))


@pytest.mark.parametrize("shape", EXTENDS)
def test_extend_through_the_mesh_equals_jax(ranks, jax_extend, shape):
    got = ranks[0][("extend", shape)]
    want = oracle_count_matrix(_data()["stream"][0])
    np.testing.assert_array_equal(load_streamed_matrix(got["dir"]), want)
    np.testing.assert_array_equal(jax_load(got["dir"]), want)
    assert got["manifest"] == jax_extend


def test_every_rank_returns_the_same(ranks):
    for key, value in ranks[0].items():
        if key[1] == "world":
            continue
        members = [rk for rk in range(cases.WORLD) if key in ranks[rk]]
        for rk in members[1:]:
            assert ranks[rk][key]["manifest"] == value["manifest"], (key, rk)
    for what in ("scaling", "config5", "dryrun"):
        assert all((what, "world") in ranks[rk] for rk in range(cases.WORLD)), what


def test_scaling_has_the_jax_keys_and_says_it_is_no_figure(ranks):
    got = ranks[0][("scaling", "world")]
    want = jp.measure_scaling(n=128, m_bits=2048, device_counts=(1, 2), reps=1,
                              log=lambda *a: None)
    assert set(got) == set(want) and got["platform"] == want["platform"] == "cpu"
    assert (got["n"], got["m_bits"]) == (want["n"], want["m_bits"])
    assert set(got["results"]) == {1, 2, 4, 8}
    for r, d in got["results"].items():
        assert set(d) == set(want["results"][1])
        assert d["seconds"] > 0 and d["efficiency"] > 0
    assert "not a scaling figure" in got["note"]
    # every rank returns the first rank's times
    assert all(ranks[rk][("scaling", "world")] == got for rk in range(cases.WORLD))


#: the keys of the JAX package's config-5 entry (stormtpu/acceptance.py)
CONFIG5_KEYS = {"config", "n", "devices", "exact_sampled", "seconds", "pairs_per_s",
                "latency_bound", "sustained_pairs_per_s", "note"}


def test_config5_runs_sampled_exact_over_every_rank(ranks):
    got = ranks[0][("config5", "world")]
    assert set(got) == CONFIG5_KEYS
    assert got["config"] == 5 and got["n"] == cases.CONFIG5_ROWS
    assert got["devices"] == cases.WORLD
    assert got["exact_sampled"] is True and got["latency_bound"] is True
    assert got["seconds"] > 0 and got["sustained_pairs_per_s"] > 0


def test_dryrun_multichip_passes_on_every_rank(ranks):
    assert all(ranks[rk][("dryrun", "world")] is True for rk in range(cases.WORLD))


def test_run_group_reports_a_failing_rank_and_kills_the_group():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_group(2, "gloo", "cpu", cases.fail_on_rank_1, timeout=60)


def test_run_group_kills_a_group_past_its_timeout():
    with pytest.raises(TimeoutError, match="did not end within"):
        run_group(2, "gloo", "cpu", cases.hang_on_rank_1, timeout=6)


_JOIN = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch.distributed as dist
from stormtpu_torch.oracle import oracle_count_matrix
from stormtpu_torch.parallel import distributed_count_matrix, initialize_multihost, make_row_mesh

packed = np.random.default_rng(5).integers(0, 2**32, (20, 9), dtype=np.uint32)
for args in ((), ("127.0.0.1:{port_b}", 1, 0)):
    initialize_multihost(*args, device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    got = distributed_count_matrix(packed, mesh=make_row_mesh(device="cpu"))
    assert np.array_equal(got, oracle_count_matrix(packed))
    dist.destroy_process_group()
print("joined twice")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_multihost_joins_from_torchrun_env_and_from_arguments():
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0"}
    import os

    proc = subprocess.run(
        [sys.executable, "-c", _JOIN.format(root=str(ROOT), port_b=_free_port())],
        capture_output=True, text=True, timeout=120, env={**os.environ, **env})
    assert proc.returncode == 0 and "joined twice" in proc.stdout, proc.stderr
    from stormtpu_torch.parallel import initialize_multihost

    with pytest.raises(ValueError, match="pass all of"):
        initialize_multihost("127.0.0.1:1", None, None, device="cpu")
