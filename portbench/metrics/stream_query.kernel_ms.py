"""CUDA-event ms a stripe of the kernel stage, from the stage pass."""

from portbench import readers

LAYER = "streamed queries (stream_query.py, stream.py)"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(run):
    return readers.stage_ms_per_stripe(run, {"kernel"}, inside=True, device_clock=True)
