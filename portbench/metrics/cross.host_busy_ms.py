"""Host ms a request outside the program's waits on the card: stpu.cross.request less its stpu.wait.* spans, over the traced window's requests."""

from portbench import progspans

LAYER = "cross queries (cross.py)"
UNIT = "ms"
MOVES = "lookup_pairs_per_s"


def read(run):
    return progspans.busy_ms(progspans.recording(), progspans.REQUEST)
