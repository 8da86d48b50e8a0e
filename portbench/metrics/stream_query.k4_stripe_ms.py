"""Host ms a K4 stripe of the walk: the stpu.stream.k4 spans of the traced window over their count."""

from portbench import progspans

LAYER = "streamed queries (stream_query.py, stream.py)"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(run):
    return progspans.mean_ms(progspans.recording(), "stpu.stream.k4")
