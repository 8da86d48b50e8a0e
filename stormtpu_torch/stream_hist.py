"""Histogram helpers shared by the streaming sinks (the part of the JAX
package's ``stream_hist.py`` that ``stream.stream_count_histogram``
needs): the function that makes the manifest, with its mass check, and
the valid-pair arithmetic of a stripe. The three ``stream_hist_*`` walks
are not ported yet (ROADMAP.md, reduced queries).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__: list[str] = []


def _hist_manifest(n: int, m_bits: int, sb: int, n_super: int, kernel: str,
                   n_bins: int, bin_width: int, hist: np.ndarray,
                   extra: Optional[dict] = None) -> dict:
    expect = n * (n - 1) // 2
    got = int(hist.sum())
    if got != expect:
        raise AssertionError(
            f"histogram mass {got} != n*(n-1)/2 = {expect} — a pair was "
            "double-counted or dropped; this is a bug, not an input error"
        )
    edges = np.minimum(
        np.arange(n_bins + 1, dtype=np.int64) * bin_width, m_bits + 1
    )
    man = {
        "n": n,
        "m_bits": m_bits,
        "superblock_rows": sb,
        "n_super": n_super,
        "kernel": kernel,
        "sink": "histogram",
        "n_bins": n_bins,
        "bin_width": int(bin_width),
        "bin_edges": edges,
        "hist": hist,
        "pairs": got,
    }
    if extra:
        man.update(extra)
    return man


def _valid_rows(n: int, sb: int, i: int) -> int:
    return max(0, min(n - i * sb, sb))


def _stripe_pair_mass(n: int, sb: int, i: int, j: int) -> int:
    """Number of valid global pairs (r < c < n) inside stripe (i, j)."""
    vi, vj = _valid_rows(n, sb, i), _valid_rows(n, sb, j)
    return vi * (vi - 1) // 2 if i == j else vi * vj
