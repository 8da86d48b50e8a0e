"""``python -m stormtpu_torch`` against ``python -m stormtpu`` on the CPU:
the same command on the same small files gives equal outputs (exact
equality: counts, bins and indices are integers), and the same argument
errors are refused."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import stormtpu
import stormtpu.io
from stormtpu.cli import main as jax_main
from stormtpu.io import save_bitmatrix
from stormtpu_torch.cli import main as torch_main

ROOT = Path(__file__).resolve().parents[1]


def port(*args) -> int:
    return torch_main(["--device", "cpu", *map(str, args)])


def _load(path):
    if str(path).endswith(".npy"):
        return {"": np.load(path)}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def both(tmp_path, name, *args, ties=()):
    """Run one command in both packages, ``{out}`` standing for each one's
    output file; assert both exit 0 and wrote equal arrays (but for the
    members named in ``ties``: top-k indices, whose order among equal
    values is each package's own)."""
    suffix = ".npy" if args[0] == "count" else ".npz"
    outs = [tmp_path / f"{name}_jax{suffix}", tmp_path / f"{name}_torch{suffix}"]
    fill = lambda out: [str(out) if a == "{out}" else str(a) for a in args]  # noqa: E731
    assert jax_main(fill(outs[0])) == 0
    assert port(*fill(outs[1])) == 0
    want, got = _load(outs[0]), _load(outs[1])
    assert set(got) == set(want)
    for k in want:
        if k in ties:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


@pytest.fixture
def files(tmp_path):
    rng = np.random.default_rng(3)
    dense = (rng.random((60, 1024)) < 0.3).astype(np.uint8)
    base = (rng.random(1024) < 0.3).astype(np.uint8)
    for r in range(4):  # a near-duplicate block: one clump
        row = base.copy()
        row[rng.random(1024) < 0.02] ^= 1
        dense[r] = row
    npy = tmp_path / "m.npy"
    np.save(npy, dense)
    npz = tmp_path / "m.npz"
    save_bitmatrix(stormtpu.BitMatrix.from_dense(dense), str(npz))
    rows, cols = np.nonzero(dense[:12, :300])
    coo = tmp_path / "coo.npz"
    np.savez(coo, row_ids=rows, positions=cols, n=12, m_bits=300)
    stat = tmp_path / "stat.npy"
    np.save(stat, rng.random(60))
    panel = tmp_path / "panel.npz"
    save_bitmatrix(stormtpu.BitMatrix.from_dense(
        (rng.random((40, 1024)) < 0.35).astype(np.uint8)), str(panel))
    return dict(dense=dense, npy=npy, npz=npz, coo=coo, stat=stat, panel=panel)


@pytest.mark.parametrize("op", ("intersect", "union", "xor"))
@pytest.mark.parametrize("src", ("npy", "npz", "coo"))
def test_count_equals_jax(tmp_path, files, src, op):
    got = both(tmp_path, "c", "count", "--in", files[src], "--out", "{out}", "--op", op)[""]
    if src == "npy" and op == "intersect":
        d = files["dense"].astype(np.int64)
        np.testing.assert_array_equal(got, d @ d.T)


@pytest.mark.parametrize("extra", ([], ["--measure", "jaccard"],
                                   ["--stream", "--superblock", "32"],
                                   ["--against", "PANEL"]))
def test_topk_equals_jax(tmp_path, files, extra):
    extra = [files["panel"] if a == "PANEL" else a for a in extra]
    got = both(tmp_path, "t", "topk", "--in", files["npz"], "--out", "{out}", "--k", "4",
               *extra, ties=("indices",))
    assert got["indices"].shape == (60, 4)
    if "--measure" not in extra:  # each index names a partner with that count
        d = files["dense"].astype(np.int64)
        if "--against" in extra:
            c = d @ stormtpu.io.load_bitmatrix(str(files["panel"])).to_dense().T
        else:
            c = d @ d.T
            assert (got["indices"] != np.arange(60)[:, None]).all()
        np.testing.assert_array_equal(np.take_along_axis(c, got["indices"], 1),
                                      got["counts"])


@pytest.mark.parametrize("extra", (["--threshold", "100"],
                                   ["--threshold", "0.3", "--measure", "jaccard"],
                                   ["--threshold", "0.5", "--measure", "r2"],
                                   ["--threshold", "100", "--stream", "--superblock", "32"],
                                   ["--threshold", "40", "--against", "PANEL"]))
def test_screen_equals_jax(tmp_path, files, extra):
    extra = [files["panel"] if a == "PANEL" else a for a in extra]
    got = both(tmp_path, "s", "screen", "--in", files["npy"], "--out", "{out}", *extra)
    assert got["ii"].size > 0


@pytest.mark.parametrize("extra", (["--bins", "8", "--row-sums"],
                                   ["--bins", "8", "--superblock", "32", "--method", "streamed"],
                                   ["--bins", "5", "--bin-width", "7"]))
def test_hist_equals_jax(tmp_path, files, extra):
    got = both(tmp_path, "h", "hist", "--in", files["npy"], "--out", "{out}", *extra)
    assert got["hist"].sum() == 60 * 59 // 2


@pytest.mark.parametrize("extra", (["--threshold", "0.5", "--stat", "STAT"],
                                   ["--threshold", "0.5", "--stat", "STAT", "--stream",
                                    "--superblock", "16"],
                                   ["--threshold", "20", "--measure", "count"]))
def test_clump_equals_jax(tmp_path, files, extra):
    extra = [files["stat"] if a == "STAT" else a for a in extra]
    got = both(tmp_path, "k", "clump", "--in", files["npy"], "--out", "{out}", *extra)
    assert got["sizes"].sum() == 60
    if "r2" in extra or "--measure" not in extra:
        block = got["leader"][:4]
        assert (block == block[0]).all()


def test_stream_extend_equals_jax(tmp_path, files):
    from stormtpu.stream import load_streamed_matrix as jax_load
    from stormtpu_torch.stream import load_streamed_matrix

    old, new = tmp_path / "old.npy", tmp_path / "new.npy"
    np.save(old, files["dense"][:40])
    np.save(new, files["dense"])
    dirs = [tmp_path / "sj", tmp_path / "st"]
    assert jax_main(["stream", "--in", str(old), "--out-dir", str(dirs[0]),
                     "--superblock", "32"]) == 0
    assert port("stream", "--in", old, "--out-dir", dirs[1], "--superblock", 32) == 0
    assert jax_main(["stream", "--in", str(new), "--out-dir", str(dirs[0]), "--extend"]) == 0
    assert port("stream", "--in", new, "--out-dir", dirs[1], "--extend") == 0
    d = files["dense"].astype(np.int64)
    for load, path in ((jax_load, dirs[0]), (load_streamed_matrix, dirs[1])):
        np.testing.assert_array_equal(load(str(path)), d @ d.T)
    # each package's directory is the other's too
    np.testing.assert_array_equal(load_streamed_matrix(str(dirs[0])), jax_load(str(dirs[1])))


def test_query_extend_equals_jax(tmp_path, files):
    old, new = tmp_path / "old.npy", tmp_path / "new.npy"
    np.save(old, files["dense"][:40])
    np.save(new, files["dense"])
    for cmd, first in (("screen", ["--threshold", "60"]), ("topk", ["--k", "4"])):
        outs = []
        for tag, run in (("jax", lambda *a: jax_main(list(map(str, a)))), ("torch", port)):
            ck, out = tmp_path / f"{cmd}_{tag}", tmp_path / f"{cmd}_{tag}.npz"
            assert run(cmd, "--in", old, "--out", out, *first, "--stream", "--superblock", 32,
                       "--ckpt-dir", ck) == 0
            assert run(cmd, "--in", new, "--out", out, "--stream", "--superblock", 32,
                       "--ckpt-dir", ck, "--extend") == 0
            outs.append(_load(out))
        for k in outs[0]:
            np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=(cmd, k))


@pytest.mark.parametrize("args,match", [
    (["topk", "--k", "2", "--against", "IN", "--stream"], "mutually exclusive"),
    (["screen", "--threshold", "1", "--against", "IN", "--stream"], "mutually exclusive"),
    (["topk", "--k", "2", "--ckpt-dir", "CK"], "requires --stream"),
    (["screen", "--threshold", "1", "--ckpt-dir", "CK"], "requires --stream"),
    (["clump", "--threshold", "0.5", "--ckpt-dir", "CK"], "requires --stream"),
    (["screen", "--threshold", "60", "--extend"], "--extend"),
    (["screen"], "--threshold"),
    (["screen", "--against", "IN", "--extend", "--stream", "--ckpt-dir", "CK"], "against"),
    (["topk", "--against", "IN", "--extend", "--stream", "--ckpt-dir", "CK"], "against"),
])
def test_argument_errors_equal_jax(tmp_path, files, args, match):
    args = [str(files["npy"]) if a == "IN" else str(tmp_path / "ck") if a == "CK" else a
            for a in args]
    full = [args[0], "--in", str(files["npy"]), "--out", str(tmp_path / "o.npz"), *args[1:]]
    for run in (jax_main, lambda a: torch_main(["--device", "cpu", *a])):
        with pytest.raises(SystemExit, match=match):
            run(full)


def test_ckpt_dirs_are_written(tmp_path, files):
    ck = tmp_path / "ck"
    assert port("topk", "--in", files["npz"], "--out", tmp_path / "t.npz", "--k", 3,
                "--stream", "--superblock", 16, "--ckpt-dir", ck) == 0
    assert (ck / "topk_ckpt.npz").exists()
    ck2 = tmp_path / "ck2"
    assert port("screen", "--in", files["npz"], "--out", tmp_path / "h.npz",
                "--threshold", 20, "--stream", "--superblock", 16, "--ckpt-dir", ck2) == 0
    assert (ck2 / "screen_manifest.json").exists()


def test_sweep_info_and_the_missing_card(capsys, tmp_path, monkeypatch, files):
    assert port("sweep", "--n", 40, "--m", 512, "--densities", "0.05,0.5",
                "--strategies", "popcount,mxu,pallas_mxu", "--reps", 1) == 0
    assert capsys.readouterr().out.count("exact") == 6
    monkeypatch.setenv("STORMTPU_TORCH_TUNING_CACHE", str(tmp_path / "none.json"))
    assert port("info") == 0
    out = capsys.readouterr().out
    assert "torch" in out and "C++ host tier" in out and "none.json" in out
    # no card here: the default device refuses, never falls back to the CPU
    assert torch_main(["info"]) == 2
    assert torch_main(["count", "--in", str(files["npy"]), "--out",
                       str(tmp_path / "c.npy")]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "c.npy").exists()
    assert port("tune", "--n", 64) == 2
    # scaling runs over the group this process is in (one gloo rank here)
    # and prints the JAX package's JSON keys
    capsys.readouterr()
    assert port("scaling", "--n", 64, "--m", 1024, "--reps", 1) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_main(["scaling", "--n", "64", "--m", "1024", "--reps", "1"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) and got["platform"] == want["platform"] == "cpu"
    assert list(got["results"]) == ["1"]
    assert set(got["results"]["1"]) == set(want["results"]["1"])
    assert "not a scaling figure" in got["note"]


def test_accept_config5_is_refused_and_writes_nothing(tmp_path, capsys, monkeypatch):
    """``accept --config 5`` runs config 5 (at 128 of its 2,048 rows here)
    and writes its entry."""
    from stormtpu_torch import acceptance as tacc

    monkeypatch.setattr(tacc, "CONFIG5_SCALED", (128, tacc.CONFIG5_SCALED[1]))
    out = tmp_path / "acc.json"
    assert port("accept", "--config", 5, "--out", out) == 0
    entries = json.loads(out.read_text())
    assert [e["config"] for e in entries] == [5]
    assert entries[0]["exact_sampled"] is True and entries[0]["device"] == "cpu"


def test_python_dash_m_runs_the_port(tmp_path, files):
    out = tmp_path / "c.npy"
    proc = subprocess.run(
        [sys.executable, "-m", "stormtpu_torch", "--device", "cpu", "count", "--in",
         str(files["npz"]), "--out", str(out)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    d = files["dense"].astype(np.int64)
    np.testing.assert_array_equal(np.load(out), d @ d.T)
    assert "jax" not in json.dumps(proc.stderr).lower()
