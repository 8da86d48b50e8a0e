"""Exact pair counts answered a second by whole-matrix requests: every pair of every answer of the measured loop, over its whole length."""

from portbench import readers

LAYER = "end to end"
UNIT = "pairs/s"
MOVES = "matrix_pairs_per_s"


def read(run):
    return readers.pairs_per_s(run)
