"""Host ms a request of BitMatrix.from_positions, the benchmark's own span."""

from portbench import readers

LAYER = "layout (layout.py)"
UNIT = "ms"
MOVES = "matrix_pairs_per_s"


def read(run):
    return readers.span_ms(run, "ingest")
