"""Share of the traced window with no kernel, copy or fill on the card."""

from portbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "lookup_pairs_per_s"


def read(run):
    return readers.idle_pct(run)
