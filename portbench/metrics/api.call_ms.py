"""Host ms a request of intersect_count_matrix, ending with the matrix on the host, the benchmark's own span."""

from portbench import readers

LAYER = "API and D1 (api.py, dispatch.py, kernels/sparse.py)"
UNIT = "ms"
MOVES = "matrix_pairs_per_s"


def read(run):
    return readers.span_ms(run, "call")
