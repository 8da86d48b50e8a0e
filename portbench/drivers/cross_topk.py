"""Lookups against a resident reference panel, closed loop, one client:
each request is a batch of new query bitmaps, made a ``BitMatrix`` of its
own, and ``stormtpu_torch.cross_topk_neighbors(q, panel, k)``; the answer
is back on the host when the request ends. The batches come from a pool
made at set-up, in turn.

Checked: every request whose batch is among batches drawn from the seed,
against the reference's exact counts of those queries with every panel
row."""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench import generate, harness, panel, roofline
from portbench.reference import compare, counts, forms

QUERIES = "queries"


@dataclasses.dataclass
class State:
    cell: object
    bm: object
    pool: list        # uint32 [query_rows, W] host batches
    answers: list     # (batch, vals, idx) of every request


def _batch(cell, b: int, device) -> "torch.Tensor":
    return generate.words_chunk(cell.seed, QUERIES, b, cell.traffic["query_rows"],
                                cell.config["m_bits"], device)


def _request(cell, state, index: int) -> None:
    import stormtpu_torch as st

    b = index % len(state.pool)
    with harness.span("from_packed"):
        q = st.BitMatrix.from_packed(state.pool[b], cell.config["m_bits"])
    with harness.span("cross_topk_neighbors"):
        vals, idx = st.cross_topk_neighbors(q, state.bm, cell.traffic["k"], device=cell.device)
    state.answers.append((b, vals, idx))


def setup(cell) -> State:
    c, mix = cell.config, cell.traffic
    pool = [_batch(cell, b, cell.device).cpu().numpy().view(np.uint32)
            for b in range(mix["pool_batches"])]
    with cell.timed("panel made and copied to the host"):
        words = panel.host_panel(cell)
    with cell.timed("BitMatrix.from_packed"):
        bm = panel.bitmatrix(words, c["m_bits"])
    state = State(cell, bm, pool, [])
    with cell.timed("warm-up"):
        for u in range(mix["warmup_units"]):
            _request(cell, state, u)
    state.answers.clear()
    return state


def unit(state, index: int):
    _request(state.cell, state, index)
    return state.cell.traffic["query_rows"] * state.cell.config["n"], {}


def work(cell) -> tuple[float, float]:
    c, mix = cell.config, cell.traffic
    return roofline.dense_cross_work(mix["query_rows"], c["n"], c["m_bits"],
                                     8 * mix["query_rows"] * mix["k"])


def release(state) -> None:
    panel.free_device(state.bm)
    state.bm = None


def _checked(cell):
    return generate.pick(cell.seed, "check_batches", cell.traffic["pool_batches"],
                         cell.traffic["check_batches"])


def _reference(cell, batches, precision: str) -> np.ndarray:
    """int64 [len(batches) · query_rows, N] exact (or control) counts."""
    import torch

    ref = panel.reference_panel(cell)
    q = torch.cat([_batch(cell, int(b), cell.device) for b in batches])
    out = counts.row_counts(q, panel.chunks_of(ref), cell.config["n"], precision)
    del ref
    return out


def check(cell, state) -> dict:
    batches = _checked(cell)
    ref = _reference(cell, batches, "float32")
    qr, k = cell.traffic["query_rows"], cell.traffic["k"]
    at = {int(b): i for i, b in enumerate(batches)}
    no_rows = np.zeros(qr, dtype=np.int64)
    wrong = 0
    for b, vals, idx in state.answers:
        if b in at:
            rows = ref[at[b] * qr : (at[b] + 1) * qr]
            wrong += compare.topk_rows_wrong(rows, no_rows, vals, idx, k, self_pairs=True)
    return {"rows_wrong": (wrong, 0)}


def control(cell) -> dict:
    """The reference in the program's place with bfloat16 counts, on the
    checked batches, judged as the program's answers are."""
    batches = _checked(cell)
    ref = _reference(cell, batches, "float32")
    low = _reference(cell, batches, "bfloat16")
    k = cell.traffic["k"]
    rows = np.zeros(ref.shape[0], dtype=np.int64)
    vals, idx = forms.topk_of(low, rows, k, self_pairs=True)
    return {"rows_wrong": compare.topk_rows_wrong(ref, rows, vals, idx, k, self_pairs=True)}
