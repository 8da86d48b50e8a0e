"""Whole streamed r² screens, back to back, on a resident LD panel:
``stormtpu_torch.stream_query.stream_pairs_above(bm, t, measure="r2")``
without a stripe directory, on the panel of ``ld_panel.py`` (rare and
common variant rows in blocks of nested carriers).

Checked: every listed hit of every distinct answer against its NumPy
popcount and the exact integer rule (``reference/ld.py``), its r² against
the reference's, its order and range; and, in every job, the complete hit
set of rows drawn from the seed, against the reference's exact counts of
those rows with every row."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import generate, harness, ld_panel, panel, roofline
from portbench.reference import counts, ld

# the control's reference past this many bits a panel runs on the card only
HOST_CONTROL_MAX_BITS = 1 << 34
# rows a group of the work's lower bound: K2's tile
WORK_GROUP_ROWS = 256


@dataclasses.dataclass
class State:
    cell: object
    bm: object
    rows: np.ndarray
    answers: list  # (ii, jj, r²), a job each


def _job(cell, state) -> None:
    from stormtpu_torch import stream_query

    mix = cell.traffic
    with harness.span("stream_pairs_above"):
        hits = stream_query.stream_pairs_above(
            state.bm, mix["threshold"], measure=mix["measure"],
            superblock_rows=mix["superblock_rows"], kernel=mix["kernel"], out_dir=None,
            device=cell.device)
    state.answers.append(tuple(np.asarray(h) for h in hits))


def setup(cell) -> State:
    c = cell.config
    with cell.timed("panel made and copied to the host"):
        words = ld_panel.host_panel(cell)
    with cell.timed("BitMatrix.from_packed"):
        bm = panel.bitmatrix(words, c["m_bits"])
    with cell.timed("the work's lower bound"):
        cell.work = _work(cell)
    state = State(cell, bm, generate.pick(cell.seed, "check_rows", c["n"],
                                          cell.traffic["check_rows"]), [])
    with cell.timed("warm-up"):
        for _ in range(cell.traffic["warmup_units"]):
            _job(cell, state)
    state.answers.clear()
    return state


def unit(state, index: int):
    _job(state.cell, state)
    return roofline.allpairs(state.cell.config["n"]), {}


def _work(cell) -> tuple[float, float]:
    """(ops, bytes) of the least work an answer needs: the rows in count
    order in groups of ``WORK_GROUP_ROWS``, each pair of groups at the
    cheaper of its dense pair count (2·pairs·M bit operations) and K4's
    emissions (8 bytes each: the exact Σ_c occ_I(c)·occ_J(c) of their
    column occupancies, a group's own pairs Σ_c occ(occ−1)/2). Summing the
    two sides apart, the larger of their times (``roofline.least_seconds``)
    is below what either form of the whole answer needs."""
    c, dev = cell.config, cell.device
    n, m, g = c["n"], c["m_bits"], WORK_GROUP_ROWS
    a = ld_panel.carrier_counts(cell.seed, n, m, dev)
    group = torch.empty(n, dtype=torch.int64, device=dev)
    group[torch.argsort(a, stable=True)] = torch.arange(n, device=dev) // g
    n_groups = -(-n // g)
    occ = torch.zeros((n_groups, m), dtype=torch.float32, device=dev)
    shifts = torch.arange(generate.WORD_BITS, dtype=torch.int32, device=dev)
    for r0, words in ld_panel.panel_device(cell.seed, c, dev):
        for b0 in range(0, words.shape[0], g):
            w = words[b0 : b0 + g]
            bits = ((w[:, :, None] >> shifts) & 1).view(w.shape[0], m).to(torch.float32)
            occ.index_add_(0, group[r0 + b0 : r0 + b0 + w.shape[0]], bits)
            del bits
    occ = occ.to(torch.float64)
    emit = (occ @ occ.T).cpu().numpy()
    size = torch.bincount(group, minlength=n_groups).cpu().numpy().astype(np.float64)
    sums = occ.sum(dim=1).cpu().numpy()
    del occ
    np.fill_diagonal(emit, (np.diag(emit) - sums) / 2)
    pairs = np.outer(size, size)
    np.fill_diagonal(pairs, size * (size - 1) / 2)
    upper = np.triu(np.ones_like(pairs, dtype=bool))
    ops = roofline.pair_ops(1, m) * pairs
    dense = ops / roofline.PEAK_B1_OPS <= 8 * emit / roofline.PEAK_HBM_BYTES
    return float(ops[upper & dense].sum()), float(8 * emit[upper & ~dense].sum())


def work(cell) -> tuple[float, float]:
    got = getattr(cell, "work", None)
    if got is None:
        got = cell.work = _work(cell)
    return got


def release(state) -> None:
    panel.free_device(state.bm)
    state.bm = None


def _hit_counts(ref: torch.Tensor, ii: np.ndarray, jj: np.ndarray, block: int = 256) -> np.ndarray:
    """Exact counts of the listed pairs: the rows copied down a block at a
    time and counted by NumPy popcount."""
    n = ref.shape[0]
    out = np.empty(ii.size, dtype=np.int64)
    for s in range(0, ii.size, block):
        a = torch.as_tensor(np.clip(ii[s : s + block], 0, n - 1), device=ref.device)
        b = torch.as_tensor(np.clip(jj[s : s + block], 0, n - 1), device=ref.device)
        both = torch.cat([ref[a], ref[b]]).cpu().numpy().view(np.uint32)
        k = a.numel()
        out[s : s + k] = counts.pair_counts(both, np.arange(k), np.arange(k) + k)
    return out


def _reference(cell, precision: str = "float32"):
    """(the reference panel on the device, every row's count, the sampled
    rows and their counts against every row in ``precision``)."""
    c = cell.config
    ref = ld_panel.reference_panel(cell)
    row_counts = ld_panel.carrier_counts(cell.seed, c["n"], c["m_bits"], cell.device)
    rows = generate.pick(cell.seed, "check_rows", c["n"], cell.traffic["check_rows"])
    ref_rows = counts.row_counts(ref[rows], panel.chunks_of(ref), c["n"], precision)
    return ref, row_counts.cpu().numpy(), rows, ref_rows


def _judge(cell, ref, row_counts, rows, want, answers) -> tuple[int, int]:
    c, t = cell.config, cell.traffic["threshold"]
    wrong = missed = 0
    seen: list = []  # distinct answers with their multiplicity: jobs mostly agree
    for ans in answers:
        for s in seen:
            if all(np.array_equal(x, y) for x, y in zip(s[0], ans)):
                s[1] += 1
                break
        else:
            seen.append([ans, 1])
    for (ii, jj, vv), times in seen:
        hw, pm = ld.screen_wrong((ii, jj, vv), c["n"], c["m_bits"], t, row_counts,
                                 _hit_counts(ref, ii, jj), rows, want)
        wrong += times * hw
        missed += times * pm
    return wrong, missed


def check(cell, state) -> dict:
    c = cell.config
    ref, row_counts, rows, ref_rows = _reference(cell)
    want = ld.sampled_hits(rows, ref_rows, row_counts, c["n"], c["m_bits"],
                           cell.traffic["threshold"])
    wrong, missed = _judge(cell, ref, row_counts, rows, want, state.answers)
    return {"hits_wrong": (wrong, 0), "pairs_missed_or_extra": (missed, 0)}


def control(cell) -> dict:
    """The reference in the program's place with bfloat16 counts: the r²
    hits of the checked rows that those counts give, judged as the
    program's are. A panel of more than ``HOST_CONTROL_MAX_BITS`` is
    refused off the card."""
    c = cell.config
    if cell.device.type != "cuda" and c["n"] * c["m_bits"] > HOST_CONTROL_MAX_BITS:
        raise RuntimeError(f"the control of a {c['n']} x {c['m_bits']}-bit panel runs on the "
                           f"card (control.py --device cuda)")
    t = cell.traffic["threshold"]
    ref, row_counts, rows, exact = _reference(cell)
    low = counts.row_counts(ref[rows], panel.chunks_of(ref), c["n"], "bfloat16")
    want = ld.sampled_hits(rows, exact, row_counts, c["n"], c["m_bits"], t)
    s_idx, j_idx = np.nonzero(low >= 0)
    a_row = rows[s_idx]
    _, r2 = ld.r2_decide(low[s_idx, j_idx], row_counts[a_row], row_counts[j_idx], c["m_bits"], t)
    keep = (r2 >= t) & (a_row != j_idx)
    lo = np.minimum(a_row[keep], j_idx[keep])
    hi = np.maximum(a_row[keep], j_idx[keep])
    key, first = np.unique(lo * c["n"] + hi, return_index=True)
    hits = (key // c["n"], key % c["n"], r2[keep][first])
    wrong, missed = _judge(cell, ref, row_counts, rows, want, [hits])
    return {"hits_wrong": wrong, "pairs_missed_or_extra": missed}
