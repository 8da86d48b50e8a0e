"""The program's host waits on the card (its waits counter) over the traced window's stpu.stream.stripe spans."""

from portbench import progspans

LAYER = "streamed queries (stream_query.py, stream.py)"
UNIT = "count"
MOVES = "pairs_per_s"


def read(run):
    return progspans.per_span(progspans.recording(), "waits", progspans.STRIPE)
