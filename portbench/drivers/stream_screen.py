"""Whole streamed screens, back to back, on a resident panel:
``stormtpu_torch.stream_query.stream_pairs_above(bm, t)`` by count,
without a stripe directory. The threshold t is the least count whose
upper tail under Binomial(M, density²), the count of two independent
rows, holds ``pair_tail`` of the pairs.

Checked: every listed hit's count (NumPy popcount of the pair), its
order and range; and the complete hit set of rows drawn from the seed,
against the reference's exact counts of those rows with every row."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import generate, harness, panel, roofline
from portbench.reference import compare, counts, forms


@dataclasses.dataclass
class State:
    cell: object
    bm: object
    rows: np.ndarray
    threshold: int
    answers: list  # (ii, jj, counts), a job each


def threshold(cell) -> int:
    c = cell.config
    return generate.binomial_upper_threshold(c["m_bits"], c["density"] ** 2,
                                             cell.traffic["pair_tail"])


def _job(cell, state) -> None:
    from stormtpu_torch import stream_query

    mix = cell.traffic
    with harness.span("stream_pairs_above"):
        hits = stream_query.stream_pairs_above(
            state.bm, state.threshold, measure="count", superblock_rows=mix["superblock_rows"],
            kernel=mix["kernel"], out_dir=None, device=cell.device)
    state.answers.append(tuple(np.asarray(h) for h in hits))


def setup(cell) -> State:
    c = cell.config
    with cell.timed("panel made and copied to the host"):
        words = panel.host_panel(cell)
    with cell.timed("BitMatrix.from_packed"):
        bm = panel.bitmatrix(words, c["m_bits"])
    state = State(cell, bm,
                  generate.pick(cell.seed, "check_rows", c["n"], cell.traffic["check_rows"]),
                  threshold(cell), [])
    with cell.timed("warm-up"):
        for _ in range(cell.traffic["warmup_units"]):
            _job(cell, state)
    state.answers.clear()
    return state


def unit(state, index: int):
    _job(state.cell, state)
    return roofline.allpairs(state.cell.config["n"]), {}


def work(cell) -> tuple[float, float]:
    # the answer: about pair_tail of the pairs, 12 bytes a hit
    c = cell.config
    hits = roofline.allpairs(c["n"]) * cell.traffic["pair_tail"]
    return roofline.dense_allpairs_work(c["n"], c["m_bits"], int(12 * hits))


def release(state) -> None:
    panel.free_device(state.bm)
    state.bm = None


def _hit_counts(ref: torch.Tensor, ii: np.ndarray, jj: np.ndarray, block: int = 256) -> np.ndarray:
    """Exact counts of the listed pairs: the rows copied down a block at a
    time and counted by NumPy popcount."""
    n = ref.shape[0]
    out = np.empty(ii.size, dtype=np.int64)
    for s in range(0, ii.size, block):
        a = np.clip(ii[s : s + block], 0, n - 1)
        b = np.clip(jj[s : s + block], 0, n - 1)
        ia = torch.as_tensor(a, device=ref.device)
        ib = torch.as_tensor(b, device=ref.device)
        both = torch.cat([ref[ia], ref[ib]]).cpu().numpy().view(np.uint32)
        out[s : s + a.size] = counts.pair_counts(both, np.arange(a.size),
                                                 np.arange(a.size) + a.size)
    return out


def _judge(cell, ref, rows, ref_rows, t, answers) -> tuple[int, int]:
    n = cell.config["n"]
    wrong = missed = 0
    seen: list = []  # distinct answers with their multiplicity: jobs mostly agree
    for ans in answers:
        for s in seen:
            if all(np.array_equal(x, y) for x, y in zip(s[0], ans)):
                s[1] += 1
                break
        else:
            seen.append([ans, 1])
    for (ii, jj, cc), times in seen:
        hw, pm = compare.screen_wrong((ii, jj, cc), t, n, _hit_counts(ref, ii, jj), rows,
                                      ref_rows)
        wrong += times * hw
        missed += times * pm
    return wrong, missed


def check(cell, state) -> dict:
    ref = panel.reference_panel(cell)
    ref_rows = counts.row_counts(ref[state.rows], panel.chunks_of(ref), cell.config["n"])
    wrong, missed = _judge(cell, ref, state.rows, ref_rows, state.threshold, state.answers)
    return {"hits_wrong": (wrong, 0), "pairs_missed_or_extra": (missed, 0)}


def control(cell) -> dict:
    """The reference in the program's place with bfloat16 counts: its
    hits touching the checked rows, judged as the program's are."""
    c = cell.config
    rows = generate.pick(cell.seed, "check_rows", c["n"], cell.traffic["check_rows"])
    t = threshold(cell)
    ref = panel.reference_panel(cell)
    exact = counts.row_counts(ref[rows], panel.chunks_of(ref), c["n"])
    low = counts.row_counts(ref[rows], panel.chunks_of(ref), c["n"], "bfloat16")
    hits = forms.screen_hits(low, rows, c["n"], t)
    wrong, missed = _judge(cell, ref, rows, exact, t, [hits])
    return {"hits_wrong": wrong, "pairs_missed_or_extra": missed}
