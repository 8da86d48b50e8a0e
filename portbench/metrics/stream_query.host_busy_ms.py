"""Host ms a stripe outside the program's waits on the card: the self time of stpu.stream.stripe less its stpu.wait.* spans, over the traced window's stripes."""

from portbench import progspans

LAYER = "streamed queries (stream_query.py, stream.py)"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(run):
    return progspans.busy_ms(progspans.recording(), progspans.STRIPE)
