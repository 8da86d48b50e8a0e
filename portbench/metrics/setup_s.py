"""Set-up: from the start of the process to the start of the measured loop (imports, inputs, builds, uploads, warm-up)."""

from portbench import readers

LAYER = "end to end"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run.setup_s
