"""Device ms a ring step of the running top-k merge: the program's merge_device_us counter (CUDA events round each block's merge) over its stpu.parallel.step spans, in the traced window."""

from portbench import progspans

LAYER = "parallel (parallel/query.py, parallel/mesh.py)"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(run):
    us = progspans.per_span(progspans.recording(), "merge_device_us", "stpu.parallel.step")
    return None if us is None else us / 1e3
