"""Whole streamed top-k jobs, back to back, on a resident panel:
``stormtpu_torch.stream_query.stream_topk_neighbors(bm, k)`` by count,
without checkpoints. The panel is made once; its padded device operand
becomes resident on the warm-up job and serves every later one.

Checked: every job's answer at rows drawn from the seed, against the
reference's exact counts of those rows with every row."""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench import generate, harness, panel, roofline
from portbench.reference import compare, counts, forms


@dataclasses.dataclass
class State:
    cell: object
    bm: object
    rows: np.ndarray
    answers: list  # (vals, idx) at the checked rows, a job each


def _job(cell, state) -> None:
    from stormtpu_torch import stream_query

    mix = cell.traffic
    with harness.span("stream_topk_neighbors"):
        vals, idx = stream_query.stream_topk_neighbors(
            state.bm, mix["k"], superblock_rows=mix["superblock_rows"], kernel=mix["kernel"],
            out_dir=None, device=cell.device)
    state.answers.append((vals[state.rows].copy(), idx[state.rows].copy()))


def setup(cell) -> State:
    c = cell.config
    with cell.timed("panel made and copied to the host"):
        words = panel.host_panel(cell)
    with cell.timed("BitMatrix.from_packed"):
        bm = panel.bitmatrix(words, c["m_bits"])
    state = State(cell, bm,
                  generate.pick(cell.seed, "check_rows", c["n"], cell.traffic["check_rows"]), [])
    with cell.timed("warm-up"):
        for _ in range(cell.traffic["warmup_units"]):
            _job(cell, state)
    state.answers.clear()
    return state


def unit(state, index: int):
    _job(state.cell, state)
    return roofline.allpairs(state.cell.config["n"]), {}


def work(cell) -> tuple[float, float]:
    c = cell.config
    return roofline.dense_allpairs_work(c["n"], c["m_bits"], 8 * c["n"] * cell.traffic["k"])


def release(state) -> None:
    panel.free_device(state.bm)
    state.bm = None


def _reference_rows(cell, rows, precision: str) -> np.ndarray:
    ref = panel.reference_panel(cell)
    out = counts.row_counts(ref[rows], panel.chunks_of(ref), cell.config["n"], precision)
    del ref
    return out


def check(cell, state) -> dict:
    ref = _reference_rows(cell, state.rows, "float32")
    k = cell.traffic["k"]
    wrong = sum(compare.topk_rows_wrong(ref, state.rows, v, i, k, self_pairs=False)
                for v, i in state.answers)
    return {"rows_wrong": (wrong, 0)}


def control(cell) -> dict:
    """The reference in the program's place, its counts a bfloat16
    product: the readings it gives, judged as the program's are."""
    rows = generate.pick(cell.seed, "check_rows", cell.config["n"], cell.traffic["check_rows"])
    ref = _reference_rows(cell, rows, "float32")
    low = _reference_rows(cell, rows, "bfloat16")
    k = cell.traffic["k"]
    vals, idx = forms.topk_of(low, rows, k, self_pairs=False)
    return {"rows_wrong": compare.topk_rows_wrong(ref, rows, vals, idx, k, self_pairs=False)}

