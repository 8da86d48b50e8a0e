"""Host ms a ring step outside the program's waits on the card: the length of stpu.parallel.step less its stpu.wait.* spans, over the traced window's steps."""

from portbench import progspans

LAYER = "parallel (parallel/query.py, parallel/mesh.py)"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(run):
    return progspans.busy_ms(progspans.recording(), "stpu.parallel.step")
