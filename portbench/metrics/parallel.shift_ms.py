"""Device ms a ring step of the hops of the partner shard: the program's shift_device_us counter (CUDA events round each shift) over its stpu.parallel.step spans, in the traced window."""

from portbench import progspans

LAYER = "parallel (parallel/query.py, parallel/mesh.py)"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(run):
    us = progspans.per_span(progspans.recording(), "shift_device_us", "stpu.parallel.step")
    return None if us is None else us / 1e3
