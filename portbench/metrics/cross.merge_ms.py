"""Host ms a request of the merge stage (torch.topk, the download and the host merge), from the stage pass."""

from portbench import readers

LAYER = "cross queries (cross.py)"
UNIT = "ms"
MOVES = "lookup_pairs_per_s"


def read(run):
    return readers.stage_ms_per_unit(run, "merge")
