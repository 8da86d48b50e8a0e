"""Distributed execution on ``torch.distributed`` (port of
``stormtpu.parallel``).

One process a device: every rank of a process group calls the same
``distributed_*`` function with the same host arrays, computes its shard
with the port's kernels on its own device, joins the collectives, and
returns the whole result. A :class:`~stormtpu_torch.parallel.mesh.Mesh`
names the ranks as the JAX mesh names devices (``make_row_mesh``,
``make_grid_mesh``); NCCL joins cards, gloo the CPU.

- ``mesh``      — meshes over a process group, and the three collectives
- ``allpairs``  — the ring-streaming row-sharded all-pairs walk, the
  bits axis (K2 tiles or K5 work lists, summed) and the 2-D form
- ``columns``, ``setops``, ``stats`` — column counts, set operations and
  similarity matrices, row sums and pair-count histograms on the mesh
- ``query``, ``cross`` — top-k partners and threshold screens; the top-k
  also over a panel no process holds whole (``RowShard``, ``shard_rows``,
  importable here beside the JAX package's 15 names of ``__all__``)
- ``multihost`` — joining a group, and the distributed streaming walk
- ``scaling``   — the scaling measurement harness
- ``dryrun``    — spawned process groups, and the multi-rank dry run
"""

from stormtpu_torch.parallel.mesh import make_grid_mesh, make_row_mesh
from stormtpu_torch.parallel.allpairs import distributed_count_matrix
from stormtpu_torch.parallel.columns import distributed_column_counts
from stormtpu_torch.parallel.cross import (
    distributed_cross_pairs_above,
    distributed_cross_topk_neighbors,
)
from stormtpu_torch.parallel.multihost import (
    distributed_stream_count_matrix,
    initialize_multihost,
)
from stormtpu_torch.parallel.query import (
    RowShard,
    distributed_pairs_above,
    distributed_topk_neighbors,
    shard_rows,
)
from stormtpu_torch.parallel.scaling import measure_scaling
from stormtpu_torch.parallel.setops import (
    distributed_pairwise_cardinality,
    distributed_similarity_matrix,
)
from stormtpu_torch.parallel.stats import (
    distributed_count_histogram,
    distributed_count_row_sums,
)

__all__ = [
    "make_grid_mesh",
    "make_row_mesh",
    "distributed_count_matrix",
    "distributed_column_counts",
    "distributed_count_histogram",
    "distributed_count_row_sums",
    "distributed_cross_pairs_above",
    "distributed_cross_topk_neighbors",
    "distributed_stream_count_matrix",
    "distributed_pairs_above",
    "distributed_pairwise_cardinality",
    "distributed_similarity_matrix",
    "distributed_topk_neighbors",
    "initialize_multihost",
    "measure_scaling",
]
