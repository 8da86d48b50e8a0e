"""GB (1e9 B) of padded operands the program makes on the card (its pad_bytes counter) a request (stpu.cross.request) in the traced window."""

from portbench import progspans

LAYER = "kernels (kernels/, csrc/)"
UNIT = "GB"
MOVES = "lookup_pairs_per_s"


def read(run):
    per = progspans.per_span(progspans.recording(), "pad_bytes", progspans.REQUEST)
    return None if per is None else per / 1e9
