"""Host ms a job in the density order of its walk: the mean length of the stpu.stream.order spans of the traced window (the row counts' sort, the pricing, the ordered operand, K4's held positions)."""

from portbench import progspans

LAYER = "streamed queries (stream_query.py, stream.py)"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(run):
    return progspans.mean_ms(progspans.recording(), "stpu.stream.order")
