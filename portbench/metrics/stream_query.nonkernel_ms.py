"""Host ms a stripe of every stage but kernel (plan, reduce, merge, download, ...), the device synchronised round each, from the stage pass."""

from portbench import readers

LAYER = "streamed queries (stream_query.py, stream.py)"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(run):
    return readers.stage_ms_per_stripe(run, {"kernel"}, inside=False, device_clock=False)
