"""The least time for the traced loop's answers over the summed time of every kernel in it."""

from portbench import readers

LAYER = "kernels (kernels/, csrc/)"
UNIT = "%"
MOVES = "matrix_pairs_per_s"


def read(run):
    return readers.roofline_pct(run)
