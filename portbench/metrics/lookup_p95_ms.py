"""95th percentile of the latency of every request of the measured loop."""

from portbench import readers

LAYER = "end to end"
UNIT = "ms"
MOVES = "lookup_p95_ms"


def read(run):
    return readers.latency_ms(run, 95)
