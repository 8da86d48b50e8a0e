"""A panel that arrives as set-bit positions, ingested and counted in
full, closed loop, one client: each request takes the next panel of a
pool made at set-up, builds a new ``BitMatrix.from_positions`` (so no
device cache carries over) and calls
``stormtpu_torch.intersect_count_matrix(bm, strategy=...)``; the request
ends with the int32 N×N matrix on the host. Spans: ``ingest`` (the
``BitMatrix``) and ``call`` (the matrix).

Checked: the whole matrix of requests drawn from the seed, against the
reference's matrix of the same positions."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import generate, harness, roofline
from portbench.reference import compare, counts

POSITIONS = "positions"


@dataclasses.dataclass
class State:
    cell: object
    pool: list      # (row ids, positions) int64 host arrays, a panel each
    keep: set       # request indices whose answer is checked
    answers: list   # (panel, int32 [N, N] host matrix) of the kept requests


def _check_layout(config: dict) -> None:
    if config["layout"] != "uniform_positions":
        raise ValueError(f"this driver runs panels of uniform positions, not {config['layout']}")


def _panel(cell, p: int):
    c = cell.config
    return generate.positions_panel(cell.seed, POSITIONS, p, c["n"], c["m_bits"], c["density"],
                                    cell.device)


def _request(cell, state, index: int, keep: bool) -> dict:
    import stormtpu_torch as st

    c = cell.config
    p = index % len(state.pool)
    rows, pos = state.pool[p]
    t0 = time.perf_counter()
    with harness.span("from_positions"):
        bm = st.BitMatrix.from_positions(rows, pos, c["n"], c["m_bits"])
    t1 = time.perf_counter()
    with harness.span("intersect_count_matrix"):
        mat = st.intersect_count_matrix(bm, strategy=cell.traffic["strategy"], device=cell.device)
        mat = np.asarray(mat)
    t2 = time.perf_counter()
    if keep:
        state.answers.append((p, mat))
    return {"ingest": t1 - t0, "call": t2 - t1}


def setup(cell) -> State:
    _check_layout(cell.config)
    mix = cell.traffic
    with cell.timed("position pool"):
        pool = [_panel(cell, p) for p in range(mix["pool_panels"])]
    keep = {0} | set(generate.pick(cell.seed, "check_units", mix["check_span"],
                                   mix["check_units"]).tolist())
    state = State(cell, pool, keep, [])
    with cell.timed("warm-up"):
        for u in range(mix["warmup_units"]):
            _request(cell, state, u, keep=False)
    return state


def unit(state, index: int):
    spans = _request(state.cell, state, index, keep=index in state.keep)
    return roofline.allpairs(state.cell.config["n"]), spans


def work(cell) -> tuple[float, float]:
    c = cell.config
    return roofline.sparse_matrix_work(
        c["n"], generate.position_count(c["n"], c["m_bits"], c["density"]))


def release(state) -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _reference(cell, p: int, rows=None, pos=None) -> torch.Tensor:
    if rows is None:
        rows, pos = _panel(cell, p)
    return counts.sparse_matrix(rows, pos, cell.config["n"], cell.device)


def check(cell, state) -> dict:
    wrong = 0
    for p, mat in state.answers:
        want = _reference(cell, p)
        wrong += compare.entries_wrong(torch.from_numpy(mat).to(cell.device), want)
        del want
    return {"entries_wrong": (wrong, 0)}


def control(cell) -> dict:
    """The reference in the program's place with its matrix held in int8,
    the 4× smaller download a faster path would tempt one to take."""
    wrong = 0
    for p in range(cell.traffic["pool_panels"]):
        want = _reference(cell, p)
        wrong += compare.entries_wrong(want.to(torch.int8).to(torch.int32), want)
    return {"entries_wrong": wrong}
