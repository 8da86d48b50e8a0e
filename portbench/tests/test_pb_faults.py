"""A run whose timed path is broken underneath comes out not correct: the
program's entry point is wrapped to alter answers where they are made, or
to leave half of them out, and the rest of the run goes on as it does on
the card (CPU, tiny sizes, no look for a card)."""

import time

import numpy as np
import pytest
import torch

import stormtpu_torch
from stormtpu_torch import stream_query

from portbench import harness


def _topk_fault(kind):
    def wrap(fn):
        def broken(*a, **kw):
            vals, idx = fn(*a, **kw)
            vals, idx = vals.copy(), idx.copy()
            if kind == "alter":  # every eighth row's first partner changed
                idx[::8, 0] = (idx[::8, 0] + 1) % max(int(idx.max()) + 1, 2)
            else:  # the second half of the rows left out
                h = vals.shape[0] // 2
                vals[h:] = 0
                idx[h:] = 0
            return vals, idx
        return broken
    return wrap


def _screen_fault(kind):
    def wrap(fn):
        def broken(*a, **kw):
            ii, jj, cc = (np.array(x) for x in fn(*a, **kw))
            if kind == "alter":
                cc[len(cc) // 2] += 1
                return ii, jj, cc
            keep = np.arange(ii.size) % 2 == 0
            return ii[keep], jj[keep], cc[keep]
        return broken
    return wrap


def _matrix_fault(kind):
    def wrap(fn):
        def broken(*a, **kw):
            c = np.array(fn(*a, **kw))
            if kind == "alter":
                c[3, 7] += 1
            else:
                c[c.shape[0] // 2:] = 0
            return c
        return broken
    return wrap


CASES = {
    "c4.topk16_stream": (stream_query, "stream_topk_neighbors", _topk_fault),
    "c4.lookup64": (stormtpu_torch, "cross_topk_neighbors", _topk_fault),
    "c4.screen_stream": (stream_query, "stream_pairs_above", _screen_fault),
    "c3b.matrix": (stormtpu_torch, "intersect_count_matrix", _matrix_fault),
}


@pytest.mark.parametrize("kind", ["alter", "half"])
@pytest.mark.parametrize("workload", sorted(CASES))
def test_broken_path_is_not_correct(tiny_root, monkeypatch, workload, kind):
    mod, name, fault = CASES[workload]
    ok = harness.run_cell(tiny_root, workload, 4, 0.3, False, torch.device("cpu"),
                          time.perf_counter(), log=lambda m: None)
    assert ok["correct"], ok["compared"]
    monkeypatch.setattr(mod, name, fault(kind)(getattr(mod, name)))
    out = harness.run_cell(tiny_root, workload, 4, 0.3, False, torch.device("cpu"),
                           time.perf_counter(), log=lambda m: None)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["compared"].values())


def test_a_failing_call_is_counted_and_not_correct(tiny_root, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("device lost")

    out = None
    monkeypatch.setattr(stormtpu_torch, "cross_topk_neighbors", boom)
    with pytest.raises(RuntimeError):  # set-up's warm-up calls it too
        out = harness.run_cell(tiny_root, "c4.lookup64", 4, 0.3, False, torch.device("cpu"),
                               time.perf_counter(), log=lambda m: None)
    assert out is None
