"""Host ms a call of BitMatrix.from_packed (the span stpu.layout.from_packed) in the traced window."""

from portbench import progspans

LAYER = "layout (layout.py)"
UNIT = "ms"
MOVES = "lookup_pairs_per_s"


def read(run):
    return progspans.mean_ms(progspans.recording(), progspans.FROM_PACKED)
