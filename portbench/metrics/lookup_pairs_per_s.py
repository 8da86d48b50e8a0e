"""Exact pair counts answered a second by lookups: every pair of every answer of the measured loop, over its whole length."""

from portbench import readers

LAYER = "end to end"
UNIT = "pairs/s"
MOVES = "lookup_pairs_per_s"


def read(run):
    return readers.pairs_per_s(run)
