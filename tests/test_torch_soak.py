"""Opt-in randomized integration soak of the port (STORMTPU_SLOW_TESTS=1),
the counterpart of ``tests/test_soak.py``: one random panel an iteration
(an empty row, a duplicate row) driven through every public surface of
``stormtpu_torch`` on the CPU — counts (every strategy), set operations,
similarities (plain and pairwise-complete), queries (resident, streamed,
cross), aggregates, extends, and the distributed forms on a spawned group
of four gloo ranks (a row mesh and a 2 × 2 grid) — each held to the NumPy
oracle. Counts exactly; float64 similarities exactly against the same
formulas written here in NumPy.

    STORMTPU_SLOW_TESTS=1 python -m pytest tests/test_torch_soak.py --noconftest

``STORMTPU_SOAK_ITERS`` sets the number of panels (default 4)."""

import os
import tempfile

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    not os.environ.get("STORMTPU_SLOW_TESTS"),
    reason="~minutes of randomized sweeps; set STORMTPU_SLOW_TESTS=1",
)

CPU = "cpu"
RANKS = 4


def _panels(iters: int, seed: int = 20260818) -> list:
    """(dense, k, measure, threshold, n_bins, second panel, observed mask,
    grown rows) an iteration, all drawn from one generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(iters):
        n, m = int(rng.integers(24, 120)), int(rng.integers(200, 4000))
        density = float(10 ** rng.uniform(-2.2, -0.3))
        dense = (rng.random((n, m)) < density).astype(np.uint8)
        dense[n // 4] = 0          # an empty row
        dense[-1] = dense[0]       # a duplicate row
        c = _counts(dense, dense)
        out.append(dict(
            dense=dense, density=density, k=int(rng.integers(1, min(8, n - 1) + 1)),
            measure=str(rng.choice(["jaccard", "cosine", "r2"])),
            threshold=max(1, int(np.percentile(c[np.triu_indices(n, 1)], 90))),
            n_bins=int(rng.integers(2, 24)),
            second=(rng.random((int(rng.integers(16, 80)), m)) < density).astype(np.uint8),
            kx=None,
            observed=((rng.random((n, m)) > 0.15) | dense.astype(bool)).astype(np.uint8),
            grown=(rng.random((int(rng.integers(4, 40)), m)) < density).astype(np.uint8)))
        out[-1]["kx"] = int(rng.integers(1, min(5, out[-1]["second"].shape[0]) + 1))
    return out


def _counts(a, b):
    return a.astype(np.float64) @ b.T.astype(np.float64)


def _sim(c, ca, cb, m, measure):
    """The similarity formulas in the engine's operation order (0 where
    the denominator is 0)."""
    c, ca, cb = (np.asarray(x, dtype=np.float64) for x in (c, ca, cb))
    if measure == "jaccard":
        den = ca + cb - c
    elif measure == "cosine":
        den = np.sqrt(ca * cb)
    else:  # r2
        m = np.asarray(m, dtype=np.float64)
        c = m * c - ca * cb
        den = np.sqrt(ca * cb * (m - ca) * (m - cb))
        c, den = c * c, den * den
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(den > 0, c / np.where(den > 0, den, 1.0), 0.0)


def _topk_values(score, k):
    s = score.astype(np.float64).copy()
    np.fill_diagonal(s, -np.inf)
    return -np.sort(-s, axis=1)[:, :k]


def _valid(vals, idx, score, k, ctx):
    n = score.shape[0]
    assert np.array_equal(score[np.arange(n)[:, None], idx], vals), ctx
    assert all(len(set(r.tolist())) == k and i not in r for i, r in enumerate(idx)), ctx


def _distributed_rank(device: str, panels: list) -> list:
    """Every panel's distributed results on a row mesh of all ranks and a
    2 × 2 grid (every rank returns them whole)."""
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.parallel import (
        distributed_count_histogram,
        distributed_count_matrix,
        distributed_count_row_sums,
        distributed_pairs_above,
        distributed_topk_neighbors,
        make_grid_mesh,
        make_row_mesh,
    )

    row, grid = make_row_mesh(device=device), make_grid_mesh(2, 2, device=device)
    out = []
    for p in panels:
        bm = BitMatrix.from_dense(p["dense"])
        res = {"measure": distributed_topk_neighbors(bm, p["k"], mesh=row, block_rows=8,
                                                     measure=p["measure"]),
               "row_sums": distributed_count_row_sums(bm, mesh=row),
               "hist": distributed_count_histogram(bm, n_bins=p["n_bins"], mesh=grid,
                                                   block_rows=32)["hist"]}
        for name, mesh in (("row", row), ("grid", grid)):
            res[name] = (distributed_count_matrix(bm.packed, mesh=mesh),
                         distributed_topk_neighbors(bm, p["k"], mesh=mesh, block_rows=8),
                         distributed_pairs_above(bm, p["threshold"], mesh=mesh, block_rows=8))
        out.append(res)
    return out


def test_public_api_agreement_soak():
    import stormtpu_torch as st
    from stormtpu_torch.dispatch import STRATEGIES
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.native import have_native
    from stormtpu_torch.parallel.dryrun import run_group
    from stormtpu_torch.stream_query import (
        extend_stream_pairs_above,
        extend_stream_topk_neighbors,
        stream_pairs_above,
        stream_topk_neighbors,
    )

    panels = _panels(int(os.environ.get("STORMTPU_SOAK_ITERS", "4")))
    group = run_group(RANKS, "gloo", CPU, _distributed_rank, panels, timeout=900)
    for it, p in enumerate(panels):
        dense, k, meas, thr = p["dense"], p["k"], p["measure"], p["threshold"]
        n, m = dense.shape
        bm = BitMatrix.from_dense(dense)
        c = _counts(dense, dense).astype(np.int64)
        nnz = np.diag(c)
        ctx = f"iter {it} n={n} m={m} d={p['density']:.4f}"

        for strat in STRATEGIES:
            got = st.intersect_count_matrix(bm, strategy=strat, device=CPU)
            assert np.array_equal(got, c), f"{ctx} strategy={strat}"
        assert np.array_equal(st.pairwise_cardinality(bm, "union", device=CPU),
                              nnz[:, None] + nnz[None, :] - c), ctx
        assert np.array_equal(st.similarity_matrix(bm, "jaccard", device=CPU),
                              _sim(c, nnz[:, None], nnz[None, :], m, "jaccard")), ctx

        # queries, resident and streamed: values, and valid partners where
        # the route promises them (the streamed walk may report a zero
        # count as its (0, 0) "no partner" entry)
        want_topk = _topk_values(c, k).astype(np.int64)
        vals, idx = st.topk_neighbors(bm, k, device=CPU)
        assert np.array_equal(vals, want_topk), f"{ctx} topk"
        _valid(vals, idx, c, k, f"{ctx} topk partners")
        sv, _ = stream_topk_neighbors(bm, k, superblock_rows=32, device=CPU)
        assert np.array_equal(sv, want_topk), f"{ctx} stream topk"
        sim = _sim(c, nnz[:, None], nnz[None, :], m, meas)
        want_mv = _topk_values(sim, k)
        mv, midx = st.topk_neighbors(bm, k, measure=meas, device=CPU)
        assert np.array_equal(mv, want_mv), f"{ctx} measure topk {meas}"
        _valid(mv, midx, np.where(np.eye(n, dtype=bool), -np.inf, sim), k, f"{ctx} {meas}")
        smv, _ = stream_topk_neighbors(bm, k, superblock_rows=32, measure=meas, device=CPU)
        assert np.array_equal(smv, want_mv), f"{ctx} stream measure {meas}"
        wi, wj = np.nonzero(np.triu(c, 1) >= thr)
        for tag, (ii, jj, vv) in (
                ("screen", st.pairs_above(bm, thr, device=CPU)),
                ("stream screen", stream_pairs_above(bm, thr, superblock_rows=32, device=CPU))):
            assert np.array_equal(ii, wi) and np.array_equal(jj, wj), f"{ctx} {tag}"
            assert np.array_equal(vv, c[wi, wj]), f"{ctx} {tag}"

        # pairwise-complete forms: the screen is the matrix form's threshold
        bm_m = BitMatrix.from_dense(p["observed"])
        r2c = st.similarity_matrix_complete(bm, bm_m, "r2", device=CPU)
        obs = p["observed"]
        want_c = _sim(c, _counts(dense, obs), _counts(obs, dense), _counts(obs, obs), "r2")
        assert np.array_equal(r2c, want_c), f"{ctx} complete r2"
        ci, cj, _ = st.pairs_above_complete(bm, bm_m, 0.4, measure="r2", device=CPU)
        ewi, ewj = np.nonzero(np.triu(want_c, 1) >= 0.4)
        assert np.array_equal(ci, ewi) and np.array_equal(cj, ewj), f"{ctx} complete screen"

        # cross queries against a second panel
        bq = BitMatrix.from_dense(p["second"])
        cx = _counts(dense, p["second"]).astype(np.int64)
        kx = p["kx"]
        xv, xi = st.cross_topk_neighbors(bm, bq, kx, device=CPU)
        assert np.array_equal(xv, -np.sort(-cx, axis=1)[:, :kx]), f"{ctx} cross topk"
        assert np.array_equal(cx[np.arange(n)[:, None], xi], xv), f"{ctx} cross partners"
        cxs = _sim(cx, nnz[:, None], bq.row_nnz[None, :], m, meas)
        cmv, _ = st.cross_topk_neighbors(bm, bq, kx, measure=meas, device=CPU)
        assert np.array_equal(cmv, -np.sort(-cxs, axis=1)[:, :kx]), f"{ctx} cross {meas}"
        thx = max(1, int(cx.max()) - 1)
        xii, xjj, xvv = st.cross_pairs_above(bm, bq, thx, device=CPU)
        xwi, xwj = np.nonzero(cx >= thx)
        assert np.array_equal(xii, xwi) and np.array_equal(xjj, xwj), f"{ctx} cross screen"
        assert np.array_equal(xvv, cx[xwi, xwj]), f"{ctx} cross screen"

        # the distributed forms, from every rank of the group
        for rank, per_panel in enumerate(group):
            res, rctx = per_panel[it], f"{ctx} rank {rank}"
            for name in ("row", "grid"):
                dc, (dv, di), (dii, djj, dvv) = res[name]
                assert np.array_equal(dc, c), f"{rctx} dist counts {name}"
                assert np.array_equal(dv, want_topk), f"{rctx} dist topk {name}"
                _valid(dv, di, c, k, f"{rctx} dist topk partners {name}")
                assert np.array_equal(dii, wi) and np.array_equal(dvv, c[wi, wj]), \
                    f"{rctx} dist screen {name}"
            assert np.array_equal(res["measure"][0], want_mv), f"{rctx} dist measure {meas}"
            assert np.array_equal(res["row_sums"], c.sum(axis=1)), f"{rctx} dist row sums"

        # aggregates: every route agrees with the oracle's marginals and
        # distribution
        assert np.array_equal(st.count_row_sums(bm, device=CPU), c.sum(axis=1)), ctx
        assert np.array_equal(st.count_row_sums(bm, positions_budget_bytes=0, device=CPU),
                              c.sum(axis=1)), f"{ctx} row sums (bit-plane route)"
        nb = p["n_bins"]
        man_h = st.count_histogram(bm, n_bins=nb, device=CPU)
        want_h = np.bincount(np.minimum(c[np.triu_indices(n, 1)] // man_h["bin_width"], nb - 1),
                             minlength=nb)
        assert np.array_equal(man_h["hist"], want_h), f"{ctx} hist"
        assert all(np.array_equal(g[it]["hist"], want_h) for g in group), f"{ctx} dist hist"
        for route in ["streamed"] + (["sparse"] if have_native() else []):
            man_r = st.count_histogram(bm, n_bins=nb, method=route, device=CPU)
            assert np.array_equal(man_r["hist"], want_h), f"{ctx} hist route {route}"

        # panel growth: the extends reproduce the grown panel's answers
        dense_g = np.concatenate([dense, p["grown"]])
        bm_g = BitMatrix.from_dense(dense_g)
        cg = _counts(dense_g, dense_g).astype(np.int64)
        with tempfile.TemporaryDirectory() as td:
            sd = os.path.join(td, "scr")
            stream_pairs_above(bm, thr, superblock_rows=32, out_dir=sd, device=CPU)
            gii, gjj, gvv = extend_stream_pairs_above(bm_g, sd, device=CPU)
            wgi, wgj = np.nonzero(np.triu(cg, 1) >= thr)
            assert np.array_equal(gii, wgi) and np.array_equal(gvv, cg[wgi, wgj]), \
                f"{ctx} screen extend"
            tkd = os.path.join(td, "tk")
            stream_topk_neighbors(bm, k, superblock_rows=32, out_dir=tkd, device=CPU)
            gv2, _ = extend_stream_topk_neighbors(bm_g, tkd, device=CPU)
            assert np.array_equal(gv2, _topk_values(cg, k).astype(np.int64)), \
                f"{ctx} topk extend"
