"""stormtpu_torch — the PyTorch/CUDA port of stormtpu's exact all-pairs
bitmap intersection-count engine, for one NVIDIA H100.

Same surface as the JAX package ``stormtpu`` (which it never imports):
build a :class:`BitMatrix`, then :func:`intersect_count_matrix`,
:func:`count_block` or :func:`pair_count`. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``; the kernels are
hand-written sm_90a CUDA kernels (``kernels/csrc/``), built with ``nvcc``
on first use. Matrices whose N×N result cannot be one array go through
``stormtpu_torch.stream`` (superblock stripes on disk, resumable; its
directories are interchangeable with ``stormtpu.stream``'s). The analytics surface rides on the same kernels:
set-operation and similarity matrices (``setops``), top-k neighbours, pair
counts and threshold screens (``query``, ``cross``), LD clumping
(``clump``), and row sums, column counts and pair-count histograms
(``stats``). ``stormtpu_torch.parallel`` runs them across the ranks of a
``torch.distributed`` group, a device a rank (NCCL on cards, gloo on the
CPU).
"""

from stormtpu_torch.api import count_block, intersect_count_matrix, pair_count
from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.layout import BitMatrix, BitMatrixBuilder, pack_bits, unpack_bits
from stormtpu_torch.oracle import (
    oracle_count_block,
    oracle_count_matrix,
    oracle_pair_count,
)
from stormtpu_torch.setops import (
    column_counts,
    pairs_above_complete,
    pairwise_cardinality,
    similarity_matrix,
    similarity_matrix_complete,
)
from stormtpu_torch.stats import count_histogram, count_row_sums
from stormtpu_torch.query import pair_counts, pairs_above, topk_neighbors
from stormtpu_torch.cross import cross_pairs_above, cross_topk_neighbors
from stormtpu_torch.clump import ClumpResult, clump, clump_from_pairs

__version__ = "0.1.0"

__all__ = [
    "BitMatrix",
    "BitMatrixBuilder",
    "EngineConfig",
    "default_config",
    "pack_bits",
    "unpack_bits",
    "oracle_pair_count",
    "oracle_count_matrix",
    "oracle_count_block",
    "intersect_count_matrix",
    "pair_count",
    "count_block",
    "column_counts",
    "pairwise_cardinality",
    "similarity_matrix",
    "similarity_matrix_complete",
    "pairs_above_complete",
    "count_row_sums",
    "count_histogram",
    "pair_counts",
    "pairs_above",
    "topk_neighbors",
    "cross_pairs_above",
    "cross_topk_neighbors",
    "ClumpResult",
    "clump",
    "clump_from_pairs",
    "__version__",
]
