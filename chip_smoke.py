#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stormtpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises on failure (exit code != 0, no result line):

1. build the CUDA kernels from ``stormtpu_torch/kernels/csrc`` (one nvcc
   per source, all started together), and measure the back-to-back issue
   rate of the tensor-core instructions (``csrc/tc_rate.cu``): K2's
   operation bound is stated against the measured rate of the instruction
   its tile body issues;
2. hold each K2 kernel against its plain PyTorch version on the card, with
   exact equality (counts are integers: tolerance 0) — ragged small
   shapes, a mid shape at densities 0.001 / 0.5 / 1.0, and an all-ones
   matrix whose every count is 2^27;
3. the main path: ``intersect_count_matrix`` with ``strategy="auto"`` on
   16384 × 262144 bits of uniform random words; D1 must choose
   ``pallas_mxu`` and the K2 triangular kernel must launch; 4096 sampled
   pairs, the diagonal and symmetry are checked against numpy;
4. ``count_block`` of 4096 × 16384 rows at the same width; the K2
   rectangular kernel must launch; sampled pairs checked;
5. ``pair_count`` of one pair of 1,048,576 bits, checked against numpy;
6. timings at the main-path shapes (CUDA events): each kernel, its plain
   version (also compared, exactly), one ``torch._int_mm`` call on
   pre-unpacked int8 operands as a yardstick, and each kernel's bound; a ``[breakdown]`` of the warm call
   (kernel, assembly of the N×N matrix on the card, one download); and
   phase 35's first part: K2-topk and K2-hist (``csrc/k2_epilogue.cu``) on
   the first chunk of ``topk_neighbors``' tile walk (1024 tiles), held to
   their plain versions exactly (the top-k's values and indices), timed
   beside K2-tri alone, K2-tri followed by the same reduction in torch, the
   plain version and the bound;
7. hold K5 (work list), K1 (AND + popcount tiles) and K0 (pair stream)
   against their plain versions, exactly: K5 on plans of block-diagonal
   inputs at three tile configurations (pad slots, tail pad items, slots
   fed by several K-groups), through the wrapper's read-back route and
   through the work list checked at plan time, on an all-ones 128 × 2^27
   work list, and a malformed list must raise on both routes; K1 at ragged
   N and M, densities 0.001 / 0.5 / 1.0, all ones at 2^27, and at tile
   rows 8 / 40 / 128 / 136 on i-major, shuffled and odd-length tile lists;
   K0 at ragged W with salt 0 and 0xDEADBEEF and all ones;
8. the clustered path: ``intersect_count_matrix`` with ``strategy="auto"``
   on a 16384 × 1,048,576-bit LD-block panel (16 blocks, boundaries drawn
   from the seed); D1 must choose ``clustered``, K5 must launch and K2 must
   not; sampled pairs within and across blocks, the diagonal and symmetry
   are checked; a ``[breakdown]`` of the warm call, and K2's triangle on
   the same padded operand for the skip ratio;
9. the ``pallas_dense`` path at the main-path shape: K1 must launch and the
   matrix must equal phase 3's exactly;
10. K0 on 16384 pairs of 1,048,576 bits, sampled rows checked;
11. timings of K5, K1 and K0 as in phase 6; K5's launch alone, its wrapper
    with the checked work list and with the read-back, apart; K1 against
    the bound of the instruction it issues.
12. ``BASELINE.json`` config 4 at full scale through the checksum sink: an
    operand of 100,000 × 1,048,576 bits made on the card from the seed
    (12.5 GiB padded), ``stream_count_checksums`` at superblock 4096: 325
    stripes, 325 K2 launches, every sampled (i, j, count) triple equal to
    the popcount of the two rows' AND (on the card, and for 64 of them by
    numpy on downloaded rows); wall time, K2 time by CUDA events, G-pairs/s
    and the share of the operation bound;
13. ``stream_count_histogram`` on the same operand (mass n(n−1)/2) through
    K2-hist (325 launches, no K2-tri), equal to the store route's (K2-tri's
    tiles binned by torch) on the same operand, and on its last four
    superblocks against a histogram built from one K2-rect call on those
    rows; phase 35's second part: K2-topk and K2-hist on config-4 stripes
    (0, 1) (timed as in phase 6), (0, 0), and the ragged last stripe on two
    slices with global offsets, each held to its plain version;
14. the disk route on phase 8's LD panel into temporary directories,
    superblock 4096, uncompressed: ``kernel="mxu"`` with the operand
    resident, the same with operand streaming (every stripe equal), each
    recorded stage by stage and once more as a user runs it (stripe files
    written by background threads while the walk goes on),
    ``kernel="auto"`` (must resolve to ``clustered``: K5 launches, K2 does
    not); all three load to phase 8's matrix; resume after deleting two
    stripe files launches twice; a directory of the first 14,000 rows
    extended to 16,384 recomputes four stripes; ``[breakdown]`` of each
    route's stages as mean seconds a stripe;
15. ``stream_count_checksums_clustered`` on the LD panel, stripe for stripe
    equal to ``stream_count_checksums`` on the same padded operand;
16. ``BASELINE.json`` config 3, 10,000 × 1,048,576 bits made with
    ``BitMatrix.from_positions`` from positions drawn from the seed, in two
    versions: A at density 0.5% (about 52.4M set bits: no COO cache) and B
    at 1e-4 (about 1.05M: the COO cache kept); the C++ host tier must have
    built; ingest timed on the host;
17. on both versions, all exactly equal: ``intersect_count_matrix`` with
    ``auto`` (D1's choice and the two estimates it compared are printed),
    ``pallas_mxu`` (K2 must launch), ``sparse_outer`` (K4's emission and
    mirror kernels on the card, ``csrc/k4_sparse.cu``, must launch and the
    host K4 must not) and ``sparse`` (K3 on the card) — on B at full size,
    on A for its first 1,024 rows against all 10,000 through
    ``count_block_sparse`` (A's lists are about 5,400 long: the full matrix
    would take minutes); sampled pairs, the diagonal and symmetry against
    numpy; K4's kernels held exactly to their plain versions on the card at
    both versions in full, and timed apart (zeroing, emission, mirror; CUDA
    events) beside the plain versions, ``torch.sparse.mm`` (a yardstick the
    port never calls), the bound and emissions/s, with a ``[breakdown]`` of
    the call's stages (upload, sort, emit, mirror, download) and the host
    sort it replaces; at B the host C++ K4 timed and held to it too; K3 and
    K2 timed, K3 held against its CPU form;
18. the streamed K4 walk at config 3's shape, superblock 4096 (3
    superblocks, 6 stripes): a background at density 1e-4 and rows 0–4,095
    at 0.05 over bits 0–262,143, so that stripe (0, 0) has about 5e9
    emissions; at least one stripe must take K4 and one the dense walk, K4's
    kernels must launch, the directory must load to the K2 matrix, and a
    resume after deleting one stripe of each kind must write the same files
    and the same split; then stripes (0, 1), (0, 2) and (1, 1) by K4's
    kernels on the card, held to their plain versions on the card and to the
    host C++ stripes, and timed;
19. the ultra-sparse shape, 131,072 × 1,048,576 bits at density 1e-5,
    ``stream_count_matrix(kernel="auto")`` at superblock 4096 (528 stripes):
    ``auto`` must resolve to ``sparse_outer`` and every stripe file must
    equal scipy's ``csr @ csr.T`` on that stripe (65,536 rows when the host
    has under 48 GB available);
20. the analytics surface at the main-path shape, held to phase 3's
    matrix C exactly: ``topk_neighbors(k=16)`` (the K2 tile walk through
    K2-topk: values equal each row's top 16 of C off the diagonal and the
    store route's, indices valid on both),
    ``pairs_above`` by count (a threshold with 10^5-10^6 pairs: equal to
    ``np.nonzero(np.triu(C >= t, 1))`` with values) and by Jaccard (equal
    to the float64 filter of C), ``pair_counts`` of 10^6 pairs (K0),
    ``similarity_matrix("r2")``, ``pairwise_cardinality("xor")``,
    ``count_row_sums``, ``column_counts``, and ``count_histogram`` through
    the operand-streaming walk (a lowered operand budget; K2-hist, equal to
    the store route's) and ``dense`` (K2-hist);
21. the LD panel of phase 8: ``pairs_above(measure="r2", threshold=0.5)``
    and by count on the clustered host route (K5, no K2), ``clump`` on the
    r2 screen, ``count_histogram`` on the clustered route, all equal to
    phase 8's matrix;
22. config 3 version B: ``count_histogram(method="sparse")`` equal to the
    histogram of phase 17's K2 matrix;
23. ``cross_topk_neighbors(k=8)`` and ``cross_pairs_above`` of phase 4's
    rows held to phase 4's block; ``count_block``'s page-locked download
    timed against the pageable copy it replaced; on 2,048 x 262,144 bits
    with 5% of positions missing and pairs in strong LD,
    ``similarity_matrix_complete("r2")``, ``pairs_above_complete`` and
    ``cross_topk_neighbors(measure="r2")`` held to ``derive_similarity``
    over four count blocks;
24. config 4 at full scale, 100,000 x 1,048,576 bits of uniform words as a
    host ``BitMatrix`` (fewer rows when the host or the card cannot hold
    it, printed): ``count_histogram`` with the last bin starting 5.5 sd
    above the mean, ``pairs_above`` at that bin's start (its hit count must
    equal the bin, over all 5e9 pairs; each hit's count equal to numpy's),
    ``topk_neighbors(k=8)`` (256 sampled rows equal to their K2-rect counts'
    top 8);
25. the streamed queries (``stream_query``) on phase 24's matrix and its
    device operand, superblock 4096 (325 stripes): ``stream_topk_neighbors(k=8)``
    through K2-topk (no dense stripe) equal to phase 24's top-k on every row
    and to the store route's (dense stripes), ``stream_pairs_above`` equal to
    its 65 hits, and ``topk_neighbors(measure="jaccard", k=8)``, which
    takes the streamed walk above 32,768 rows: 256 sampled rows equal to
    the float64 ranking of their K2-rect counts;
26. the LD panel: ``stream_pairs_above`` and ``stream_topk_neighbors(k=8)``
    with the operand resident, then on two slices (a lowered
    ``STORMTPU_DEVICE_OPERAND_BUDGET_BYTES``) into a directory, a resume
    after deleting two hit files (two stripes computed), and the extend of
    a directory of the first 14,000 rows to 16,384: all equal to phase 8's
    matrix;
27. config 3 B through ``kernel="auto"`` (K4 for the stripes the cost
    model gives it: its kernels on the card, the few-emission ones on the
    host) and ``kernel="mxu"``: top-k, a count screen
    and an r2 screen equal across routes and to phase 17's matrix, each
    route's stripe split printed;
28. ``stream_pairs_above_complete`` on phase 23's panel at superblock 512
    (ten stripes of four count grids) equal to ``pairs_above_complete``;
29. ``tuning.tune()`` over ``DEFAULT_GRID`` (nine buckets, 256 x 8192 to
    16384 x 1,048,576 bits) into a temporary cache: every candidate exact on
    its 128 x 128 block; each bucket's pairs/s a strategy, its winner and
    its latency-bound and skipped candidates printed, with the K4 refit;
    for each bucket ``choose_strategy`` names the table's winner (after the
    "mxu" memory guard) and ``intersect_count_matrix("auto")`` at its N and
    M launches that winner's kernel (none for a plain winner) and equals
    numpy on sampled pairs; K2-rect timed against ``count_block_int8_xla``
    at 4096 x 4096 rows and M = 2^13 ... 2^17 bits, the crossover equal to
    ``kernels.MXU_XLA_MAX_BITS``; the table written to
    ``chiprun_out/tuning_snapshot.json`` (the run never writes into the
    package: the committed ``stormtpu_torch/data/tuning_snapshot.json`` is
    such a table copied over by hand);
30. ``python -m stormtpu_torch`` as subprocesses, all started together, on
    a PLINK trio of 16,384 variants x 2,504 samples in 16 LD blocks and an
    ``io.save_bitmatrix`` copy of its samples orientation: ``info``,
    ``count`` of both, ``topk --k 8``, ``screen --measure r2 --threshold
    0.5``, ``clump``, ``hist --row-sums``, ``stream`` of the first 12,288
    variants and then ``--extend`` to all, ``tune --n 4096 --m 65536`` into
    a copy of phase 29's cache (it must merge into the nine buckets), and
    ``scaling`` (one rank: its JSON must say it is no scaling figure): every
    output equal to the same call
    made in this process, ``count`` also to numpy on sampled pairs;
31. ``acceptance.run_acceptance([1, 2, 3, 4])`` on the card into a
    temporary file: configs 1-3 with config 3's full 10,000-row pass, and
    config 4's three full-scale parts at 100,000 x 1,000,000 bits (the K2
    rate, the checksum walk, the histograms and row sums); every check
    must pass; each entry's wall time and rate printed;
32. ``stormtpu_torch.parallel`` over a one-rank NCCL group in this process
    (run after phase 28, while the matrices it is held to are alive), at
    config 5's width of 1,048,576 bits with its rows cut to one card:
    ``distributed_count_matrix`` on the rows axis at 16,384 rows equal to
    ``intersect_count_matrix`` of the same rows (and the one-rank ring timed
    alone); the bits axis on phase 8's LD panel through the sharded K5 work
    list and, with the K5 test off, K2-tri, both equal to phase 8's matrix;
    ``distributed_count_histogram(method="stripes")`` on phase 24's
    100,000-row matrix equal to phase 24's histogram;
    ``distributed_topk_neighbors(k=16)`` and ``distributed_pairs_above`` at
    the main-path shape equal to phase 20's results;
    ``distributed_stream_count_matrix`` at 32,768 rows, superblock 8,192 (10
    stripes), each stripe equal to ``count_block`` of its two superblocks;
    acceptance config 5 at the JAX package's scaled size (2,048 × 65,536
    bits), sampled-exact;
33. a spawned group of four gloo ranks, every rank on this card (NCCL
    refuses two ranks on one card): the ring, the bits axis (K2-tri), a
    2 × 2 grid and the sharded K5 form at 8,192 × 262,144 bits (uniform
    words, and an LD panel of 8 blocks), each equal on every rank to the
    one-rank result of this process; K2-rect, K2-tri and K5 must launch on
    every rank; each rank's ring step split into kernel and collectives;
34. the repaired paths: ``topk_neighbors`` on config 3 B (phase 17's
    10,000 x 1,048,576 bits, run right after phase 28) on the route D1
    names (K2's tile walk), on the block form (K2-rect, D1 held to
    ``sparse_outer``) and through ``parallel.distributed_topk_neighbors`` on
    the one-rank NCCL mesh, at k = 16 and at k = 256 (past its rows' ~105
    partners of a positive count, so padded rows tie with real zero counts), values
    equal to phase 17's matrix's top k and every partner set valid
    (distinct, never the row, each realizing its count); then, with the
    tuning cache pointing at an absent file, D1 naming ``pallas_mxu`` at
    BASELINE.json config 2 (1,000 x 65,536 bits) and
    ``intersect_count_matrix`` launching K2-tri, equal to numpy's matrix;
    and each ``examples/torch_*.py`` as a subprocess on the card, all
    started together, each exiting 0 with its closing line;
36. (run right after phase 2) K2-rect on the TMA body:
    ``count_block_pallas_mxu`` at Na 1, 64, 128, 129, 200, 256, 384, 512
    against Nb 1, 255, 257, 4,099 at W 4, 36 and 8,192 words, both
    operands row views at an offset (as the rows ring's
    ``x_local[b0:b0 + 256]``), each equal to the plain version exactly; one
    launch a call, taken as it is (``rect_unpadded``), and ``rect_shared_b``
    counted on the launches in clusters of two (even sub-tile row counts)
    and on no other. Then the ring's block of config 5 at its size (256
    against 250,112 rows of 32,768 words, a 32.8-GB shard made on the card,
    both row views): one launch in clusters of two, equal to the plain
    version over every chunk of 8,192 B rows.
37. (run right after phase 36) the streamed screen's compaction
    (``kernels.screen.stripe_screen``, ``csrc/stripe_screen.cu``) at a
    config-4 stripe: 4096² counts about Binomial(2²⁰, 1/4), by count at
    ``c4.screen_stream``'s threshold and, with 4,096 planted pairs of r²
    about 0.74-0.88, by r² at 0.8, off and on the diagonal, and at a count
    threshold whose hits pass a buffer of 64: the same total, above 0, and
    hit set (row, column, count) as its plain version on the card; timed
    beside the plain version and its bound (one read of the stripe). The
    kernel table's ``launches`` are phase 25's config-4 screen's, one a
    stripe; this phase's own are ``timing_launches``.

Phases 20-28 print each call's wall time and a ``[breakdown]`` of its
stages (K2 by CUDA events, the screen, merge and bin passes, the summary
and word downloads, the refine), and K2's share of its bound; phases 25-28
also K2's and the reduction's milliseconds a stripe. A ``[breakdown]``
names the reduction routes its walk took over K2-tri's tiles
(``kernels.mxu.topk_route`` / ``hist_route``: ``k2_topk``, ``k2_hist``, or
a store route named by its rule), stripes or chunks each.

The lines before the last are a ``kernels`` JSON object (each kernel's
launches on its main path, and during the streaming, query, tuning,
acceptance, parallel and repaired-path phases; ``group_launches``: the
least over phase 33's ranks) and the card's ``name, power.limit``; the last line is the
result object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# NVIDIA H100 SXM data sheet, dense: int8 tensor-core rate and HBM3 rate
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES_PER_S = 3.35e12
# 32-bit population count: results per clock per SM for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instructions)
POPC_PER_CLOCK_PER_SM = 16

DEVICE = "cuda"
MAIN_N = 16384
MAIN_M = 262144
RAGGED = ((37, 1000), (37, 100_003), (300, 100_003))
MID_N, MID_M = 2053, 262_161
ALL_ONES_N, ALL_ONES_M = 128, 1 << 27
BLOCK_NA = 4096
PAIR_M = 1 << 20
N_SAMPLES = 4096
# K5 kernel checks: (label, k2_tile_rows, k2_tile_words, N, M, blocks);
# None tile sizes take the default configuration
K5_CASES = (
    ("default", None, None, 1000, 300_007, 5),
    ("ti32", 32, 128, 301, 100_003, 6),
    ("ti32 pad slots", 32, 128, 70, 13_000, 2),
    ("ti160", 160, 128, 997, 150_001, 4),
)
K1_NS = (37, 300, 2053)
K1_TILE_ROWS = (8, 40, 128, 136)
K1_LIST_BLOCKS = 5      # row blocks of the tile lists K1 is checked on: 15 tiles
K1_MS = (100_003, 262_161)
K0_CASES = ((37, 1001), (1000, 4093), (1000, 32_771))
LD_N, LD_M, LD_BLOCKS, LD_DENSITY = 16384, 1 << 20, 16, 0.3
STREAM_R, STREAM_M = 16384, 1 << 20
# BASELINE.json config 4, and the disk route's superblock and extend shapes
CFG4_N, CFG4_M = 100_000, 1 << 20
SUPERBLOCK = 4096
CFG4_NUMPY_SAMPLES = 64
HIST_BINS = 64
EXTEND_OLD_N = 14_000
# BASELINE.json config 3 (phases 16 to 18): version A is config 3's density
# bound, version B one below D1's sparse threshold
CFG3_N, CFG3_M = 10_000, 1 << 20
CFG3_VERSIONS = (("A", 0.005), ("B", 1e-4))
K3_A_ROWS = 1024         # version A's K3 check: these rows against all
K3_PLAIN_ROWS = 32       # K3's CPU form: these rows against all, for its time
# phase 18: a dense corner in a sparse panel
CORNER_ROWS, CORNER_BITS, CORNER_DENSITY, BACKGROUND_DENSITY = 4096, 1 << 18, 0.05, 1e-4
# phase 19: the README's ultra-sparse shape, and its cut on a smaller host
ULTRA_N, ULTRA_CUT_N, ULTRA_DENSITY = 131_072, 65_536, 1e-5
ULTRA_MIN_AVAILABLE = 48 << 30
# phases 20 to 24: the analytics surface
TOPK_K = 16
PAIR_COUNTS_P = 1_000_000
SIM_CHECK_ROWS = 2048   # rows (and bit positions) checked exactly against numpy
SCREEN_HITS = (100_000, 1_000_000)   # the count screens' thresholds give this many pairs
LD_R2, LD_BIN_WIDTH = 0.5, 256
CFG3_BINS = 8
CROSS_K = 8
COMPLETE_N, COMPLETE_M, COMPLETE_MISSING, COMPLETE_R2 = 2048, 1 << 18, 0.05, 0.5
COMPLETE_SB = 512       # phase 28: four superblocks, ten stripes
CFG3_R2 = 5e-5          # phase 27's r2 screen: pairs that share a bit
CFG4_BINS, CFG4_TAIL_SD = 64, 5.5
CFG4_TOPK_K, CFG4_TOPK_ROWS = 8, 256
CFG4_HOST_FACTOR = 2    # host bytes phase 24 needs per byte of its packed matrix
# phase 36: K2-rect on the TMA body, clusters of one (Na <= 128, 384) and two
RECT_TMA_NA = (1, 64, 128, 129, 200, 256, 384, 512)
RECT_TMA_NB = (1, 255, 257, 4099)
RECT_TMA_W = (4, 36, 8192)
# and the rows ring's block of config 5 at its size: query rows, shard rows,
# words (a 32.8-GB B operand), held to the plain version over chunks of
# RECT_RING_PLAIN rows and words
RECT_RING_BLOCK = (256, 250_112, 32_768)
RECT_RING_PLAIN = (8192, 4096)
# phase 29: the block kernels' crossover, K2-rect against the plain int8 product
CROSS_ROWS, CROSS_BITS = 4096, (1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17)
# phase 30: a PLINK trio of the 1000 Genomes phase 3 cohort's size
PLINK_SAMPLES, PLINK_VARIANTS, PLINK_GROUPS, PLINK_OLD_VARIANTS = 2504, 16384, 16, 12288
PLINK_FOUNDERS, PLINK_FREQ, PLINK_FLIP, PLINK_MISSING = 8, 0.3, 0.02, 0.002
CLI_TIMEOUT_S = 300
# phase 29: a candidate whose one call takes longer is recorded by that call
# (the plain popcount at 4096 x 65536 bits, 1.8 s, would take 20 s to time)
TUNE_SLOW_PATH_S = 1.0
# phase 32: a one-rank NCCL group; config 5's width, its rows cut to one card
PAR_N, PAR_M = 16_384, 1 << 20
PAR_STREAM_N, PAR_SB = 32_768, 8_192      # the streaming walk: 10 stripes
# phase 33: a spawned gloo group, every rank on this card
GROUP_RANKS, GROUP_N, GROUP_M = 4, 8_192, 262_144
GROUP_TIMEOUT_S = 420
# phase 31: rows of config 4's row-sum panel (its host bit-plane pass took 141 s
# at the spec's 100,000 rows)
ACCEPT_ROW_SUM_ROWS = 16_384
# phase 34: config 3 B's top-k at TOPK_K and at a k past its rows' ~105
# partners of a positive count (so that every row ranks zero counts, where
# padded rows tie); BASELINE.json config 2 for the untuned routing; the examples
REPAIR_THIN_K = 256
CFG2_N, CFG2_M = 1_000, 65_536
EXAMPLES = ("torch_quickstart", "torch_clustered", "torch_genotypes", "torch_streaming",
            "torch_distributed")
EXAMPLE_TIMEOUT_S = 180


def random_words(rng, n: int, m_bits: int, density: float) -> np.ndarray:
    """uint32 [n, ceil(m/32)] with bits beyond m_bits clear: all ones at
    density 1, uniform words at 0.5, else ~density·n·m uniform positions."""
    w = -(-m_bits // 32)
    if density >= 1.0:
        words = np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    elif density == 0.5:
        words = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint32)
    else:
        flat = rng.integers(0, n * m_bits, size=int(density * n * m_bits))
        words = np.zeros((n, w), dtype=np.uint32)
        rows, pos = flat // m_bits, flat % m_bits
        np.bitwise_or.at(words, (rows, pos >> 5), np.uint32(1) << (pos & 31).astype(np.uint32))
    if m_bits % 32:
        words[:, -1] &= np.uint32((1 << (m_bits % 32)) - 1)
    return words


def sampled_counts(a: np.ndarray, b: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    out = np.empty(i.size, dtype=np.int64)
    for s in range(0, i.size, 256):
        out[s : s + 256] = np.bitwise_count(a[i[s : s + 256]] & b[j[s : s + 256]]).sum(
            axis=1, dtype=np.int64
        )
    return out


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(ops: float, nbytes: float, ops_per_s: float = PEAK_INT8_OPS) -> tuple[float, str]:
    t_ops = ops / ops_per_s * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_cuts(rng, n: int, parts: int, jitter: int, avoid: int) -> np.ndarray:
    """``parts + 1`` ascending cut points of [0, n), the inner ones near
    equal spacing, moved by up to ``jitter`` and off multiples of ``avoid``."""
    cuts = np.linspace(0, n, parts + 1).astype(np.int64)
    for k in range(1, parts):
        c = int(cuts[k] + rng.integers(-jitter, jitter + 1))
        cuts[k] = c + 1 if c % avoid == 0 else c
    return cuts


def ld_panel(rng, n: int, m_bits: int, blocks: int, density: float, row_avoid: int = 256,
             bit_avoid: int = 8192):
    """An LD-block panel: uint32 [n, ceil(m/32)] words where row block b
    holds bits only in bit block b, at ``density`` inside its block. Cut
    points are drawn from ``rng`` and not aligned to ``row_avoid`` rows or
    ``bit_avoid`` bits. Returns (words, row cuts, bit cuts)."""
    w = -(-m_bits // 32)
    rows = block_cuts(rng, n, blocks, max(1, n // (4 * blocks)), row_avoid)
    bits = block_cuts(rng, m_bits, blocks, max(1, m_bits // (4 * blocks)), bit_avoid)
    words = np.zeros((n, w), dtype=np.uint32)
    level = int(round(density * 1000))
    for b in range(blocks):
        r0, r1, c0, c1 = rows[b], rows[b + 1], bits[b], bits[b + 1]
        w0, w1 = c0 // 32, -(-c1 // 32)
        on = rng.integers(0, 1000, size=(r1 - r0, (w1 - w0) * 32), dtype=np.uint16) < level
        on[:, : c0 - w0 * 32] = False
        on[:, c1 - w0 * 32 :] = False
        words[r0:r1, w0:w1] |= np.packbits(on, axis=1, bitorder="little").view("<u4")
    return words, rows, bits


def exact_diff(torch, got, want) -> int:
    """Max |got − want|; raises unless the two are exactly equal."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) if got.numel() else 0
    if err:
        raise AssertionError(f"kernel differs from its plain version by up to {err}")
    return err


def screen_kernel_phase(torch, dev, rng) -> dict:
    """Phase 37: ``kernels.screen.stripe_screen`` against its plain form on
    a config-4 stripe (see the module docstring); returns its kernel-table
    entry, timed on stripe (0, 1)."""
    from stormtpu_torch.kernels import launch_counts, reset_launches, screen
    from stormtpu_torch.query import _validate_screen

    sb, m = SUPERBLOCK, 1 << 20
    mean, sd = m / 4, (m * 0.25 * 0.75) ** 0.5
    counts_h = np.rint(rng.normal(mean, sd, (sb, sb))).astype(np.int32)
    nnz_h = np.rint(rng.normal(m / 2, (m / 4) ** 0.5, 2 * sb)).astype(np.int32)
    # independent rows give no pair r2 >= 0.8: 4096 planted pairs of r about
    # uniform on [0.86, 0.94] put hundreds on both sides of the threshold
    pi, pj = rng.integers(0, sb, 4096), rng.integers(0, sb, 4096)
    ca, cb = nnz_h[pi].astype(np.float64), nnz_h[sb + pj].astype(np.float64)
    r = rng.uniform(0.86, 0.94, pi.size)
    planted = counts_h.copy()
    planted[pi, pj] = np.rint(ca * cb / m + r * np.sqrt(ca * (m - ca) * cb * (m - cb)) / m)
    counts = torch.from_numpy(counts_h).to(dev)
    by_measure = {"count": counts, "r2": torch.from_numpy(planted).to(dev)}
    nnz = torch.from_numpy(nnz_h).to(dev)
    m_f = float(np.float32(m))
    cap = sb * sb // 4

    def screened(fn, args, room):
        out = screen.hit_buffer(room, dev)
        fn(*args, out)
        total = int(out[0])
        h = out[1:1 + 3 * min(total, room)].view(-1, 3).cpu().numpy().astype(np.int64)
        return total, h[np.lexsort((h[:, 1], h[:, 0]))]

    reset_launches()
    timed = {}
    for measure, thresh in (("count", 264_254), ("r2", 0.8)):
        t = float(_validate_screen(measure, thresh))
        for col0 in (sb, 0):  # stripe (0, 1), then the diagonal stripe (0, 0)
            args = (by_measure[measure], nnz[:sb], nnz[sb:], 0, col0, 10 * sb, t, m_f, measure)
            got_total, got = screened(screen.stripe_screen, args, cap)
            want_total, want = screened(screen.stripe_screen_plain, args, cap)
            if got_total != want_total or want_total == 0 or not np.array_equal(got, want):
                raise AssertionError(f"stripe_screen {measure} >= {thresh} at (0, {col0}): "
                                     f"{got_total} hits, the plain form {want_total}")
            print(f"[screen] {measure} >= {thresh} on stripe (0, {col0 // sb}): {got_total} "
                  f"hits, equal to the plain form")
            if col0:
                out = screen.hit_buffer(cap, dev)
                timed[measure] = dict(
                    ms=cuda_ms(torch, lambda: screen.stripe_screen(*args, out), reps=50,
                               warmup=3),
                    plain_ms=cuda_ms(torch, lambda: screen.stripe_screen_plain(*args, out),
                                     reps=3),
                    hits=want_total)
    # a buffer of 64 under thousands of hits: the whole total, 64 of the hits
    args = (counts, nnz[:sb], nnz[sb:], 0, sb, 10 * sb, float(np.float32(mean + 3 * sd)), m_f,
            "count")
    total, part = screened(screen.stripe_screen, args, 64)
    want_total, want = screened(screen.stripe_screen_plain, args, cap)
    keys = set(map(tuple, want.tolist()))
    if total != want_total or total <= 64 or len(part) != 64 \
            or not all(tuple(r) in keys for r in part.tolist()):
        raise AssertionError(f"stripe_screen past its buffer: total {total} of {want_total}")
    print(f"[screen] {total} hits into a buffer of 64: the total and 64 of them")
    b_ms, b_by = bound(0.0, 4.0 * sb * sb + 8.0 * sb)
    for measure, r in timed.items():
        print(f"[timing] stripe_screen {measure} {sb}x{sb}: kernel {r['ms']:.4f} ms "
              f"({4.0 * sb * sb / (r['ms'] * 1e-3) / 1e9:.0f} GB/s), plain {r['plain_ms']:.3f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), {r['hits']} hits")
    del counts, by_measure, nnz
    torch.cuda.empty_cache()
    return dict(name="stripe_screen", route="cuda",
                source="stormtpu_torch/kernels/csrc/stripe_screen.cu",
                replaces="none (stormtpu/stream_query.py stream_pairs_above screens a stripe "
                         "with jitted reductions)",
                timing_launches=launch_counts()["stripe_screen"], max_abs_err=0,
                library_ms=None,
                library="none: no one call screens and compacts a stripe's hits",
                ms=timed["count"]["ms"], plain_ms=timed["count"]["plain_ms"], r2=timed["r2"],
                bound_ms=b_ms, bound_by=b_by)


def rect_tma_phase(torch, dev, rng) -> int:
    """Phase 36: K2-rect at ragged shapes against the plain
    version; returns the largest difference (0, or it raises)."""
    from stormtpu_torch.kernels import launch_counts, mxu, reset_launches
    from stormtpu_torch.layout import to_device_words
    from stormtpu_torch.utils import profiling

    err, shared, calls = 0, 0, 0
    na_max, nb_max = max(RECT_TMA_NA), max(RECT_TMA_NB)
    for w in RECT_TMA_W:
        a = to_device_words(rng.integers(0, 1 << 32, (na_max + 5, w), dtype=np.uint32),
                            dev)[3 : 3 + na_max]
        b = to_device_words(rng.integers(0, 1 << 32, (nb_max + 7, w), dtype=np.uint32),
                            dev)[5 : 5 + nb_max]
        want = mxu.count_block_plain(a, b, tile_words=min(w, 1024))
        for na in RECT_TMA_NA:
            for nb in RECT_TMA_NB:
                reset_launches()
                with profiling.record() as rec:
                    got = mxu.count_block_pallas_mxu(a[:na], b[:nb])
                err = max(err, exact_diff(torch, got, want[:na, :nb]))
                paired = int(mxu.rect_cluster(na) == 2)
                if (launch_counts()["k2_rect"], rec.counters.get("rect_unpadded", 0),
                        rec.counters.get("rect_shared_b", 0)) != (1, 1, paired):
                    raise AssertionError(f"K2-rect {na} x {nb} x {w}: launches "
                                         f"{launch_counts()['k2_rect']}, counters {rec.counters}")
                shared += paired
                calls += 1
        del a, b, want, got
        torch.cuda.empty_cache()
    print(f"[rect tma] K2-rect at Na {RECT_TMA_NA} x Nb {RECT_TMA_NB} x W {RECT_TMA_W} words, "
          f"row views taken as they are: {calls} calls exact, {shared} in clusters of two "
          f"(rect_shared_b), the rest clusters of one")

    # the ring's block: x_local[b0:b0 + 256] of one shard against another
    # rank's whole shard, both views at a row offset, made on the card
    na, nb, w = RECT_RING_BLOCK
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))
    x_local = torch.empty((na + 1024, w), dtype=torch.int32, device=dev)
    shard = torch.empty((nb + 8, w), dtype=torch.int32, device=dev)
    for x in (x_local, shard):
        x.random_(-(1 << 31), 1 << 31, generator=gen)
    a, b = x_local[512 : 512 + na], shard[4 : 4 + nb]
    reset_launches()
    t0 = time.perf_counter()
    with profiling.record() as rec:
        got = mxu.count_block_pallas_mxu(a, b)
        torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    if (launch_counts()["k2_rect"], rec.counters.get("rect_unpadded", 0),
            rec.counters.get("rect_shared_b", 0)) != (1, 1, int(mxu.rect_cluster(na) == 2)):
        raise AssertionError(f"K2-rect {na} x {nb} x {w}: launches "
                             f"{launch_counts()['k2_rect']}, counters {rec.counters}")
    rows, words = RECT_RING_PLAIN
    for r0 in range(0, nb, rows):
        want = mxu.count_block_plain(a, b[r0 : r0 + rows], tile_words=words)
        err = max(err, exact_diff(torch, got[:, r0 : r0 + rows], want))
    print(f"[rect tma] the ring block {na} x {nb} x {w} words (row views at offsets 512 and 4; "
          f"B {4 * nb * w / 1e9:.1f} GB): one launch in clusters of "
          f"{mxu.rect_cluster(na)} (rect_shared_b {rec.counters.get('rect_shared_b', 0)}), "
          f"{call_s * 1e3:.1f} ms the first call, equal to the plain version over all "
          f"{-(-nb // rows)} chunks of {rows} B rows")
    del x_local, shard, a, b, got, want
    torch.cuda.empty_cache()
    return err


def breakdown(label: str, rec, per: int) -> None:
    """One ``[breakdown]`` line: a recorded walk's stages as mean seconds
    over ``per`` stripes (host clock, the device synchronised around each
    stage, each stripe's file awaited), the kernel stage also by CUDA events."""
    order = ("plan", "upload", "kernel", "k4", "assembly", "reduce", "read_back", "download",
             "save")
    parts = [f"{k} {rec.seconds[k] / per:.5f}" for k in order if k in rec.seconds]
    total = sum(rec.seconds.values())
    holder = max(rec.seconds, key=rec.seconds.get)
    print(f"[breakdown] {label}: mean s a stripe over {per} stripes: " + ", ".join(parts)
          + f"; sum {total / per:.5f}; kernel by CUDA events "
          f"{rec.device_ms.get('kernel', 0.0) / per:.3f} ms; the stage that holds a stripe: "
          f"{holder} ({rec.seconds[holder] / total:.0%})" + routes_of(rec))


def routes_of(rec) -> str:
    """The reduction routes a recorded walk took over K2-tri's tiles
    (``kernels.mxu.topk_route`` / ``hist_route``), stripes or chunks each."""
    return f"; routes {rec.routes}" if rec.routes else ""


def epilogue_kernels(torch, dev, x, ibs: np.ndarray, jbs: np.ndarray, tile_rows: int,
                     tile_words: int, *, n_real: int, k: int, n_bins: int, bin_width: int,
                     row_off: int = 0, col_off: int = 0, ops_per_s: float, label: str,
                     reps: int = 0) -> dict:
    """K2-topk and K2-hist on the tile list (ibs, jbs) of the card operand
    ``x``, each held to its plain version exactly (K2-topk's values and
    indices). ``reps`` > 0: also their CUDA-event ms, the plain version's,
    K2-tri's and K2-tri's followed by the same reduction in torch on its
    stored tiles (the yardstick), and the bound of the work: K2-tri's ``2·pairs·M``
    operations at the measured b1 rate, against the bytes of the operand
    rows the list touches, the ids and the outputs. ``cluster``: the blocks
    a cluster of the TMA body held at these tiles. Returns {"k2_topk":
    {...}, "k2_hist": {...}}."""
    from stormtpu_torch.kernels import mxu

    ids = mxu.device_tile_ids(ibs, jbs, x.shape[0] // tile_rows, dev)
    kw = dict(tile_rows=tile_rows, tile_words=tile_words, row_off=row_off, col_off=col_off,
              n_real=n_real)
    topk_kw = dict(k=k, **kw)
    hist_kw = dict(n_bins=n_bins, bin_width=bin_width, **kw)
    plain = mxu.count_tiles_topk_plain(x, *ids, **topk_kw)
    plain_h = mxu.count_tiles_hist_plain(x, *ids, **hist_kw)
    sets = mxu.count_tiles_topk(x, *ids, checked=ids, **topk_kw)
    hist = mxu.count_tiles_hist(x, *ids, checked=ids, **hist_kw)
    torch.cuda.synchronize()
    err_t = max(exact_diff(torch, g, w) for g, w in zip(sets, plain))
    err_h = exact_diff(torch, hist, plain_h)
    if int(hist.sum()) == 0 and n_real > 1:
        raise AssertionError(f"{label}: K2-hist binned no pair")
    del plain, plain_h, sets, hist
    cluster = mxu.epilogue_cluster(tile_rows)
    out = {"k2_topk": dict(max_abs_err=err_t, cluster=cluster),
           "k2_hist": dict(max_abs_err=err_h, cluster=cluster)}
    t, ti, w_pad = ibs.size, tile_rows, x.shape[1]
    print(f"[epilogue] {label}: T={t} tiles of {ti} rows at {w_pad} words, k={k}, {n_bins} "
          f"bins of width {bin_width}, row/col offsets {row_off}/{col_off}, n_real {n_real}: "
          f"K2-topk's sets (values and indices) and K2-hist's bins equal their plain versions "
          f"exactly (TMA body, clusters of {cluster})")
    if not reps:
        return out
    tri = lambda: mxu.count_tiles_pallas_mxu(x, *ids, tile_rows=ti, tile_words=tile_words,  # noqa: E731
                                             checked=ids)
    reduce_t = lambda tiles: mxu.tile_topk_sets(tiles, *ids, k=k, n_real=n_real,  # noqa: E731
                                                row_off=row_off, col_off=col_off)
    reduce_h = lambda tiles: mxu.tile_hist(tiles, *ids, n_real=n_real, bin_width=bin_width,  # noqa: E731
                                           n_bins=n_bins, row_off=row_off, col_off=col_off)
    tri_ms = cuda_ms(torch, tri, reps=reps)
    rows_touched = np.union1d(ibs, jbs).size * ti
    ops = 2.0 * t * ti * ti * w_pad * 32
    in_bytes = 4.0 * (rows_touched * w_pad + 2 * t)
    kk = min(k, ti)
    sides = -(-ti // mxu.EPI_BLOCK[0]) + -(-ti // mxu.EPI_BLOCK[1])
    for name, fn, plain_fn, red, out_bytes in (
            ("k2_topk", lambda: mxu.count_tiles_topk(x, *ids, checked=ids, **topk_kw),
             lambda: mxu.count_tiles_topk_plain(x, *ids, **topk_kw), reduce_t,
             4.0 * 2 * t * sides * ti * kk),
            ("k2_hist", lambda: mxu.count_tiles_hist(x, *ids, checked=ids, **hist_kw),
             lambda: mxu.count_tiles_hist_plain(x, *ids, **hist_kw), reduce_h, 8.0 * n_bins)):
        b_ms, b_by = bound(ops, in_bytes + out_bytes, ops_per_s)
        out[name].update(
            ms=cuda_ms(torch, fn, reps=reps),
            plain_ms=cuda_ms(torch, plain_fn, reps=1, warmup=0),
            library_ms=cuda_ms(torch, lambda: red(tri()), reps=reps), k2_tri_ms=tri_ms,
            bound_ms=b_ms, bound_by=b_by, bound_rate="measured wgmma_b1_n256",
            shape=f"{t} tiles of {ti} rows, {w_pad} words ({label})")
        r = out[name]
        print(f"[timing] {name} {label}: kernel {r['ms']:.3f} ms (TMA body, clusters of "
              f"{cluster}), K2-tri alone "
              f"{tri_ms:.3f} ms (the kernel is {r['ms'] - tri_ms:+.3f} ms beside it), K2-tri + "
              f"the torch reduction {r['library_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {b_ms:.3f} ms ({b_by}); the kernel at {b_ms / r['ms']:.1%} of its bound")
    return out


def stream_phases(torch, dev, cfg, rng, seed, bm_ld, ld_ref, k2_ops_per_s) -> dict:
    """Phases 12 to 15: the streaming walks. Returns the launches of the
    config-4 checksum walk (K2) and of the clustered disk route (K5)."""
    import stormtpu_torch as st
    from stormtpu_torch import stream
    from stormtpu_torch.kernels import clustered, launch_counts, mxu, reset_launches
    from stormtpu_torch.kernels.xla import pair_count_batch_xla
    from stormtpu_torch.utils import round_up

    sb = SUPERBLOCK
    w4 = CFG4_M // 32

    def expect_launches(what: str, **want) -> dict:
        got = launch_counts()
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"{what}: launches {got}, want {want}")
        return got

    # ------------------------------------------- 12 config 4, checksum sink
    n4 = CFG4_N
    need = 4 * round_up(n4, sb) * w4 + 4 * 4 * sb * sb + (1 << 30)
    free = torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev) \
        - torch.cuda.memory_allocated(dev)
    if need > free:
        n4 = int((free - 4 * 4 * sb * sb - (1 << 30)) // (4 * w4 * sb)) * sb
        print(f"[config 4] the card has {free / 2**30:.1f} GiB free, the operand and a stripe's "
              f"working set need {need / 2**30:.1f} GiB: taking {n4} rows instead of {CFG4_N}")
        if n4 < sb:
            raise AssertionError("not one superblock of 1,048,576 bits fits the card")
    n4_pad = round_up(n4, sb)
    n_super = n4_pad // sb
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    xd = torch.zeros((n4_pad, w4), dtype=torch.int32, device=dev)
    for r in range(0, n4, sb):
        rows = min(sb, n4 - r)
        xd[r : r + rows] = torch.randint(-(1 << 31), 1 << 31, (rows, w4), dtype=torch.int32,
                                         device=dev, generator=gen)
    torch.cuda.synchronize()
    print(f"[config 4] operand {n4} x {CFG4_M} bits, padded to {n4_pad} x {w4} words "
          f"({xd.numel() * 4 / 2**30:.2f} GiB), made on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    stripes = n_super * (n_super + 1) // 2
    tps = sb // cfg.k2_tile_rows
    tiles4 = n_super * tps * (tps + 1) // 2 + (stripes - n_super) * tps * tps
    ops4 = 2.0 * tiles4 * cfg.k2_tile_rows**2 * CFG4_M
    bound4 = ops4 / k2_ops_per_s
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    man = stream.stream_count_checksums(xd, n4, CFG4_M, superblock_rows=sb, device=dev)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    launches4 = expect_launches("config 4 checksum walk", k2_tri=stripes)["k2_tri"]
    if len(man["stripes"]) != stripes or man["n_super"] != n_super:
        raise AssertionError(f"config 4: {len(man['stripes'])} stripes, want {stripes}")
    ii = torch.from_numpy(man["sample_ii"].astype(np.int64)).to(dev)
    jj = torch.from_numpy(man["sample_jj"].astype(np.int64)).to(dev)
    want = torch.cat([pair_count_batch_xla(xd[ii[s : s + 256]], xd[jj[s : s + 256]])
                      for s in range(0, ii.numel(), 256)]).cpu().numpy()
    if not np.array_equal(man["sample_vals"], want):
        raise AssertionError("config 4: sampled counts differ from popcount(row AND row)")
    pick = rng.choice(ii.numel(), size=min(CFG4_NUMPY_SAMPLES, ii.numel()), replace=False)
    ah = xd[ii[pick]].cpu().numpy().view(np.uint32)
    bh = xd[jj[pick]].cpu().numpy().view(np.uint32)
    if not np.array_equal(man["sample_vals"][pick].astype(np.int64),
                          np.bitwise_count(ah & bh).sum(axis=1, dtype=np.int64)):
        raise AssertionError("config 4: sampled counts differ from numpy")
    with stream.record_stages() as rec:
        again = stream.stream_count_checksums(xd, n4, CFG4_M, superblock_rows=sb, device=dev)
    if again["stripes"] != man["stripes"]:
        raise AssertionError("config 4: a second walk gave other checksums")
    k2_s = rec.device_ms["kernel"] / 1e3
    pairs4 = n4 * (n4 - 1) // 2
    print(f"[config 4] stream_count_checksums {n4} x {CFG4_M} bits at superblock {sb}: "
          f"{stripes} stripes, k2_tri launches {launches4}, {tiles4} tiles; "
          f"{ii.numel()} sampled triples exact on the card, {pick.size} of them by numpy; wall "
          f"{wall4:.3f} s = {pairs4 / wall4 / 1e9:.3f} G-pairs/s; K2 summed by CUDA events "
          f"{k2_s:.3f} s (recorded walk); bound {bound4:.3f} s (operations at the measured "
          f"{k2_ops_per_s:.4g} op/s): the kernels stand at {bound4 / k2_s:.1%} of it, the walk "
          f"at {bound4 / wall4:.1%}")
    breakdown("config 4 checksum sink (recorded walk)", rec, rec.stripes)

    # ------------------------------------------------- 13 histogram sink
    reset_launches()
    t0 = time.perf_counter()
    hist = stream.stream_count_histogram(xd, n4, CFG4_M, n_bins=HIST_BINS, superblock_rows=sb,
                                         device=dev)
    torch.cuda.synchronize()
    wall_h = time.perf_counter() - t0
    launches_hist = expect_launches("config 4 histogram walk", k2_hist=stripes,
                                    k2_tri=0)["k2_hist"]
    if int(hist["hist"].sum()) != pairs4 or hist["pairs"] != pairs4:
        raise AssertionError("config 4 histogram: mass is not n(n-1)/2")
    # the store route on the same operand: K2-tri's tiles binned by torch
    with stream.record_stages() as rec_e:
        stream.stream_count_histogram(xd, n4, CFG4_M, n_bins=HIST_BINS, superblock_rows=sb,
                                      device=dev)
    def hist_wall() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream.stream_count_histogram(xd, n4, CFG4_M, n_bins=HIST_BINS, superblock_rows=sb,
                                      device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    store_bins = mxu.HIST_EPI_MAX_BINS
    walls_h = {"epilogue": [wall_h], "store": []}
    for turn in range(3):
        mxu.HIST_EPI_MAX_BINS = 0
        try:
            if turn == 0:
                reset_launches()
                hist_store = stream.stream_count_histogram(xd, n4, CFG4_M, n_bins=HIST_BINS,
                                                           superblock_rows=sb, device=dev)
                expect_launches("config 4 histogram walk, store route", k2_tri=stripes,
                                k2_hist=0)
                with stream.record_stages() as rec_s:
                    stream.stream_count_histogram(xd, n4, CFG4_M, n_bins=HIST_BINS,
                                                  superblock_rows=sb, device=dev)
            walls_h["store"].append(hist_wall())
        finally:
            mxu.HIST_EPI_MAX_BINS = store_bins
        if turn < 2:
            walls_h["epilogue"].append(hist_wall())
    if not np.array_equal(hist["hist"], hist_store["hist"]):
        raise AssertionError("config 4 histogram: K2-hist's differs from the store route's")
    print(f"[config 4] stream_count_histogram through K2-hist, {launches_hist} k2_hist "
          f"launches; walls in turns: K2-hist {', '.join(f'{w:.3f}' for w in walls_h['epilogue'])} "
          f"s (median {np.median(walls_h['epilogue']):.3f}), the store route (K2-tri, then "
          f"torch's bin count) on the same operand "
          f"{', '.join(f'{w:.3f}' for w in walls_h['store'])} s (median "
          f"{np.median(walls_h['store']):.3f}); equal histograms")
    breakdown("config 4 histogram sink, K2-hist (recorded walk)", rec_e, rec_e.stripes)
    breakdown("config 4 histogram sink, store route (recorded walk)", rec_s, rec_s.stripes)
    # K2-topk and K2-hist on config-4 stripes: an off-diagonal and a diagonal
    # stripe of the resident operand, and the ragged last stripe in the
    # two-slice form (local ids, global offsets), held to their plain versions
    tps_ = sb // cfg.k2_tile_rows
    ti4 = cfg.k2_tile_rows
    width4 = stream.default_hist_bin_width(CFG4_M, HIST_BINS)
    ek = dict(n_real=n4, k=CFG4_TOPK_K, n_bins=HIST_BINS, bin_width=width4,
              ops_per_s=k2_ops_per_s)
    loc_i, loc_j = stream._stripe_tile_ids(tps_, False)
    epi = epilogue_kernels(torch, dev, xd, loc_i, loc_j + tps_, ti4, cfg.k2_tile_words,
                           label="config-4 stripe (0, 1)", reps=10, **ek)
    di, dj = stream._stripe_tile_ids(tps_, True)
    epilogue_kernels(torch, dev, xd, di, dj, ti4, cfg.k2_tile_words,
                     label="config-4 stripe (0, 0)", **ek)
    last = n_super - 1
    pair = torch.cat([xd[(last - 1) * sb : last * sb], xd[last * sb :]])
    epilogue_kernels(torch, dev, pair, loc_i, loc_j + tps_, ti4, cfg.k2_tile_words,
                     row_off=(last - 1) * sb, col_off=(last - 1) * sb,
                     label=f"config-4 stripe ({last - 1}, {last}) on two slices", **ek)
    del pair
    # the last four superblocks (the ragged end of n among them) against one
    # K2-rect call on those rows
    r0 = max(0, n_super - 4) * sb
    sub, n_sub = xd[r0:], n4 - r0
    got = stream.stream_count_histogram(sub, n_sub, CFG4_M, n_bins=HIST_BINS,
                                        superblock_rows=sb, device=dev)
    full = mxu.count_block_pallas_mxu(sub, sub)
    idx = torch.arange(sub.shape[0], device=dev)
    upper = (idx[:, None] < idx[None, :]) & (idx[None, :] < n_sub)
    own = torch.bincount(torch.clamp(full[upper] // hist["bin_width"], max=HIST_BINS - 1),
                         minlength=HIST_BINS).cpu().numpy()
    if not np.array_equal(got["hist"], own):
        raise AssertionError("histogram of the last superblocks differs from the K2-rect one")
    top = int(np.argmax(hist["hist"]))
    print(f"[config 4] stream_count_histogram: {HIST_BINS} bins of width {hist['bin_width']}, "
          f"mass {pairs4} = n(n-1)/2, fullest bin {top} ({int(hist['hist'][top])} pairs); rows "
          f"{r0}.. ({got['n_super'] * (got['n_super'] + 1) // 2} stripes, n {n_sub}) equal a "
          f"histogram of one K2-rect call; wall {wall_h:.3f} s = "
          f"{pairs4 / wall_h / 1e9:.3f} G-pairs/s")
    del xd, sub, full, upper, ii, jj
    torch.cuda.empty_cache()

    # --------------------------------------------------- 14 the disk route
    n_ld = bm_ld.n
    ld_super = round_up(n_ld, sb) // sb
    ld_stripes = ld_super * (ld_super + 1) // 2

    def loads_to_reference(label: str, out: str) -> None:
        t0 = time.perf_counter()
        if not np.array_equal(stream.load_streamed_matrix(out), ld_ref):
            raise AssertionError(f"{label}: the loaded matrix differs from the clustered path's")
        print(f"[disk route] {label}: load_streamed_matrix equals the clustered path's "
              f"{n_ld} x {n_ld} matrix ({time.perf_counter() - t0:.2f} s)")

    with tempfile.TemporaryDirectory() as resident, tempfile.TemporaryDirectory() as streamed:
        walls = {}
        for label, out, streaming in (("mxu, operand resident", resident, False),
                                      ("mxu, operand streaming", streamed, True)):
            reset_launches()
            t0 = time.perf_counter()
            with stream.record_stages() as rec:
                man = stream.stream_count_matrix(
                    bm_ld, out, superblock_rows=sb, kernel="mxu", compress=False,
                    operand_streaming=streaming, device=dev)
            walls[label] = time.perf_counter() - t0
            expect_launches(label, k2_tri=ld_stripes, k5=0)
            if man["operand_streaming"] is not streaming or len(man["completed"]) != ld_stripes:
                raise AssertionError(f"{label}: manifest {man}")
            breakdown(f"stream_count_matrix {label}, compress off", rec, rec.stripes)
            with tempfile.TemporaryDirectory() as plain:  # the same walk, not recorded
                t0 = time.perf_counter()
                stream.stream_count_matrix(
                    bm_ld, plain, superblock_rows=sb, kernel="mxu", compress=False,
                    operand_streaming=streaming, device=dev)
                wall_plain = time.perf_counter() - t0
            print(f"[disk route] {label}: {ld_stripes} stripes of {sb} x {sb} int32 in "
                  f"{walls[label]:.2f} s recorded, {wall_plain:.2f} s not recorded "
                  f"({ld_stripes * 4 * sb * sb / wall_plain / 1e9:.2f} GB/s of stripes)")
        for i in range(ld_super):
            for j in range(i, ld_super):
                with np.load(stream.stripe_path(resident, i, j)) as a, \
                        np.load(stream.stripe_path(streamed, i, j)) as b:
                    if not np.array_equal(a["counts"], b["counts"]):
                        raise AssertionError(f"stripe ({i}, {j}) differs under operand streaming")
        loads_to_reference("mxu, operand resident", resident)
        loads_to_reference("mxu, operand streaming", streamed)
        # resume: two stripes gone, two launches; compress on for those two
        for i, j in ((0, 1), (ld_super - 1, ld_super - 1)):
            os.remove(stream.stripe_path(resident, i, j))
        reset_launches()
        with stream.record_stages() as rec:
            stream.stream_count_matrix(bm_ld, resident, superblock_rows=sb, kernel="mxu",
                                       compress=True, operand_streaming=False, device=dev)
        expect_launches("resume", k2_tri=2, k5=0)
        breakdown("stream_count_matrix resume of 2 stripes, compress on", rec, rec.stripes)
        for i, j in ((0, 1), (ld_super - 1, ld_super - 1)):
            with np.load(stream.stripe_path(resident, i, j)) as a, \
                    np.load(stream.stripe_path(streamed, i, j)) as b:
                if not np.array_equal(a["counts"], b["counts"]):
                    raise AssertionError(f"resumed stripe ({i}, {j}) differs")
        print("[disk route] resume: 2 deleted stripes recomputed with 2 K2 launches, equal to "
              "the streamed directory's")

    with tempfile.TemporaryDirectory() as auto:
        reset_launches()
        t0 = time.perf_counter()
        with stream.record_stages() as rec:
            man = stream.stream_count_matrix(bm_ld, auto, superblock_rows=sb, kernel="auto",
                                             compress=False, device=dev)
        wall_c = time.perf_counter() - t0
        if man["kernel"] != "clustered" or rec.launched < 1:
            raise AssertionError(f"kernel='auto' resolved to {man['kernel']}, "
                                 f"{rec.launched} stripes launched")
        launches_k5 = expect_launches("auto (clustered)", k5=rec.launched, k2_tri=0)["k5"]
        breakdown("stream_count_matrix auto -> clustered, compress off, a non-empty stripe "
                  "(the empty stripes' work lists and saves are in the sums)", rec, rec.launched)
        busy = sum(rec.seconds.values())
        print(f"[disk route] auto -> clustered: {ld_stripes} stripes, {rec.launched} non-empty "
              f"(k5 launches {launches_k5}), {man['work_items']} work items, {wall_c:.2f} s "
              f"(recorded walk); K5's host side (work list, check, schedule, upload) "
              f"{rec.seconds['plan'] / rec.launched * 1e3:.3f} ms a non-empty stripe against "
              f"{rec.device_ms['kernel'] / rec.launched:.3f} ms of kernel: "
              f"{rec.seconds['plan'] / busy:.1%} of the walk's stages")
        loads_to_reference("auto -> clustered", auto)

    with tempfile.TemporaryDirectory() as grown:
        head = st.BitMatrix.from_packed(np.ascontiguousarray(bm_ld.packed[:EXTEND_OLD_N]),
                                        bm_ld.m_bits)
        old = stream.stream_count_matrix(head, grown, superblock_rows=sb, kernel="mxu",
                                         compress=False, device=dev)
        head.clear_device_cache()
        last = EXTEND_OLD_N // sb
        stale = sum(1 for i in range(old["n_super"]) for j in range(i, old["n_super"])
                    if last in (i, j)) if EXTEND_OLD_N % sb else 0
        fresh = ld_stripes - old["n_super"] * (old["n_super"] + 1) // 2
        reset_launches()
        man = stream.extend_streamed_matrix(bm_ld, grown, kernel="mxu", compress=False,
                                            device=dev)
        expect_launches("extend", k2_tri=stale + fresh, k5=0)
        if man["n"] != n_ld:
            raise AssertionError(f"extend: manifest {man}")
        print(f"[disk route] extend {EXTEND_OLD_N} -> {n_ld} rows: {stale} stale and {fresh} "
              f"new stripes recomputed with {stale + fresh} K2 launches")
        loads_to_reference("extended directory", grown)

    # ------------------------------------- 15 the clustered checksum sink
    reset_launches()
    t0 = time.perf_counter()
    man_c = stream.stream_count_checksums_clustered(bm_ld, superblock_rows=sb, device=dev)
    torch.cuda.synchronize()
    wall_cc = time.perf_counter() - t0
    ran = sum(not r["skipped"] for r in man_c["stripes"])
    expect_launches("clustered checksum sink", k5=ran, k2_tri=0)
    ti5, wk5 = mxu.k2_tile_shape(cfg, bm_ld.n, bm_ld.n_words)
    w_pad5 = (-(-bm_ld.n_words // wk5) + 1) * wk5
    same = clustered.padded_operand(bm_ld, round_up(n_ld, sb), w_pad5, dev)
    t0 = time.perf_counter()
    man_d = stream.stream_count_checksums(same, n_ld, bm_ld.m_bits, superblock_rows=sb,
                                          device=dev)
    torch.cuda.synchronize()
    wall_cd = time.perf_counter() - t0
    if [(r["i"], r["j"], r["checksum"]) for r in man_c["stripes"]] != \
            [(r["i"], r["j"], r["checksum"]) for r in man_d["stripes"]]:
        raise AssertionError("the two checksum sinks differ")
    if any(r["checksum"] for r in man_c["stripes"] if r["skipped"]):
        raise AssertionError("a skipped stripe reports a checksum other than 0")
    for m in (man_c, man_d):
        if not np.array_equal(m["sample_vals"], ld_ref_samples(ld_ref, m)):
            raise AssertionError(f"{m['kernel']} checksum sink: samples differ from the matrix")
    print(f"[checksum sinks] LD panel at superblock {sb}: clustered sink {wall_cc:.3f} s "
          f"({ran} of {len(man_c['stripes'])} stripes ran K5, {man_c['work_items']} items), K2 "
          f"sink {wall_cd:.3f} s on the same padded operand: checksums equal stripe for stripe, "
          f"skipped stripes 0, all samples equal the clustered path's matrix")
    return {"k2_tri": launches4, "k5": launches_k5, "k2_hist": launches_hist,
            "epilogue": epi}


def host_available_bytes() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def column_emissions(bm) -> int:
    """K4's emissions on a whole matrix: Σ over columns of occ·(occ+1)/2."""
    _, indices = bm.positions_csr()
    occ = np.bincount(indices, minlength=bm.m_bits).astype(np.int64)
    return int((occ * (occ + 1) // 2).sum())


def sparse_phases(torch, dev, cfg, rng) -> tuple:
    """Phases 16 to 19: the sparse regime. Returns the ``kernels`` entries
    of K3 and K4, and version B of config 3 with its K2 matrix (for phase
    22)."""
    import stormtpu_torch as st
    from stormtpu_torch import native, stream
    from stormtpu_torch.dispatch import choose_strategy, k4_estimates
    from stormtpu_torch.kernels import launch_counts, mxu, reset_launches
    from stormtpu_torch.kernels import sparse as ksp
    from stormtpu_torch.layout import to_device_words
    from stormtpu_torch.utils import round_up, triangular_tile_ids

    n, m, sb = CFG3_N, CFG3_M, SUPERBLOCK

    def padded(words: np.ndarray, ti: int, wk: int):
        xp = np.zeros((round_up(words.shape[0], ti), round_up(words.shape[1], wk)), np.uint32)
        xp[: words.shape[0], : words.shape[1]] = words
        return to_device_words(xp, dev)

    def k2_tri_ms(bm) -> float:
        ti, wk = mxu.k2_tile_shape(cfg, bm.n, bm.n_words)
        xp = padded(bm.packed, ti, wk)
        ibs, jbs = triangular_tile_ids(xp.shape[0] // ti)
        ids = mxu.device_tile_ids(ibs, jbs, xp.shape[0] // ti, dev)
        ms = cuda_ms(torch, lambda: mxu.count_tiles_pallas_mxu(
            xp, *ids, tile_rows=ti, tile_words=wk, checked=ids), reps=3)
        del xp, ids
        return ms

    def sparse_mm(bm, ref):
        """torch.sparse.mm of X and its transpose, float32 CSR on the card
        (exact at these counts), held to ``ref``: its time (ms, CUDA
        events), or None where the card refuses it. A yardstick the port
        never calls."""
        try:
            cols, rows = ksp._k4_sorted_rows(bm, dev)
            x = torch.sparse_coo_tensor(torch.stack([rows.long(), cols]),
                                        torch.ones(rows.numel(), device=dev), (bm.n, bm.m_bits)
                                        ).coalesce().to_sparse_csr()
            xt = x.to_sparse_coo().t().coalesce().to_sparse_csr()
            del cols, rows
            prod = torch.sparse.mm(x, xt).to_dense()
            if not np.array_equal(prod.to(torch.int32).cpu().numpy(), ref):
                raise AssertionError("config 3: torch.sparse.mm differs from K4")
            del prod
            ms = cuda_ms(torch, lambda: torch.sparse.mm(x, xt), reps=2)
            del x, xt
            return ms
        except RuntimeError as e:  # out of memory included
            print(f"[config 3] torch.sparse.mm on the card raised: {str(e)[:300]}")
            return None
        finally:
            torch.cuda.empty_cache()

    def k4_on_card(bm, ref, ver) -> dict:
        """K4's kernels on the card at ``bm`` in full: held exactly to their
        plain versions and to ``ref``; zeroing, emission and mirror timed
        apart by CUDA events; the plain versions' time; the call's stages;
        the host sort the card's replaces; torch.sparse.mm; at B the host
        C++ K4 it replaces."""
        nb = bm.n
        cols, rows = ksp._k4_sorted_rows(bm, dev)
        off, lens = ksp.k4_runs(cols)
        del cols
        prefix = ksp._emission_prefix(lens * (lens - 1) // 2)
        pairs = int(prefix[-1])
        diag = torch.from_numpy(bm.row_nnz.astype(np.int32)).to(dev)
        out = torch.zeros((nb, nb), dtype=torch.int32, device=dev)

        def emit():
            ksp.k4_emit(rows, rows, off, lens, off, lens, prefix, out, triangle=True)

        emit()
        ksp.k4_mirror(out, diag)
        plain = torch.zeros((nb, nb), dtype=torch.int32, device=dev)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        ksp.k4_emit_plain(rows, rows, off, lens, off, lens, prefix, plain, triangle=True)
        ksp.k4_mirror_plain(plain, diag)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        err = exact_diff(torch, out, plain)
        if not np.array_equal(out.cpu().numpy(), ref):
            raise AssertionError(f"config 3 {ver}: K4's kernels differ from the K2 matrix")
        mirror_plain_ms = cuda_ms(torch, lambda: ksp.k4_mirror_plain(plain, diag), reps=1)
        del plain
        torch.cuda.empty_cache()
        zero_ms = cuda_ms(torch, out.zero_, reps=3)
        emit_ms = cuda_ms(torch, emit, reps=3)  # the repeats accumulate: same atomics
        mirror_ms = cuda_ms(torch, lambda: ksp.k4_mirror(out, diag), reps=3)
        del out, rows, off, lens, prefix, diag
        torch.cuda.empty_cache()
        with stream.record_stages() as rec:
            t0 = time.perf_counter()
            st.intersect_count_matrix(bm, strategy="sparse_outer", device=dev)
            call_s = time.perf_counter() - t0
        # the host sort the card's replaces: the COO's keys by unique_int64,
        # else the CSR's keys by np.sort
        if bm.coo is not None:
            keys = bm.coo[1] * np.int64(nb) + bm.coo[0]
            t0 = time.perf_counter()
            ksp.unique_int64(keys)
        else:
            indptr, indices = bm.positions_csr()
            keys = indices.astype(np.int64) * nb + np.repeat(np.arange(nb), np.diff(indptr))
            t0 = time.perf_counter()
            np.sort(keys)
        host_sort_s = time.perf_counter() - t0
        del keys
        lib_ms = sparse_mm(bm, ref)
        got = dict(k4_pairs=pairs, k4_err=err, k4_zero_ms=zero_ms, k4_emit_ms=emit_ms,
                   k4_mirror_ms=mirror_ms, k4_plain_ms=plain_ms,
                   k4_mirror_plain_ms=mirror_plain_ms, k4_call_s=call_s,
                   k4_stages={k: rec.seconds[k] for k in rec.seconds},
                   k4_stage_device_ms=dict(rec.device_ms), k4_host_sort_s=host_sort_s,
                   k4_library_ms=lib_ms)
        if ver == "B":
            t0 = time.perf_counter()
            host = ksp.count_matrix_sparse_outer(bm, device="cpu")
            got["k4_host_s"] = time.perf_counter() - t0
            if not np.array_equal(host, ref):
                raise AssertionError("config 3 B: the host C++ K4 differs from the card's")
            del host
        order = ("upload", "sort", "emit", "mirror", "download")
        print(f"[config 3] version {ver}: K4 on the card, {pairs} emissions (column pairs; "
              f"{column_emissions(bm)} with the diagonal): zeroing {zero_ms:.4f} ms, emission "
              f"{emit_ms:.4f} ms = {pairs / (emit_ms * 1e-3):.4g} emissions/s, mirror "
              f"{mirror_ms:.4f} ms (CUDA events); plain versions on the card {plain_ms:.2f} ms "
              f"(mirror alone {mirror_plain_ms:.3f} ms), equal exactly; torch.sparse.mm "
              f"{lib_ms} ms" + (f"; the host C++ K4 {got['k4_host_s']:.3f} s, equal"
                                if ver == "B" else ""))
        print(f"[breakdown] config 3 {ver} sparse_outer on the card, one recorded call "
              f"{call_s:.4f} s: " + ", ".join(f"{k} {rec.seconds.get(k, 0.0):.5f} s" for k in order)
              + "; by CUDA events " + ", ".join(f"{k} {rec.device_ms.get(k, 0.0):.3f} ms"
                                                for k in order)
              + f"; the host sort it replaces {host_sort_s:.4f} s ({keys_name(bm)})")
        return got

    def k4_stripes(bm, n_super) -> dict:
        """Phase 18's stripes (0, 1), (0, 2) and (1, 1) by K4's kernels on
        the card (``_SparseStripePlan.stripe_counts``), held to their plain
        versions on the card and to the host C++ stripes; the card form, its
        emission kernel alone and the plain form timed by CUDA events, the
        host C++ stripe by the host clock."""
        card = stream._SparseStripePlan(bm, sb, n_super, dev)
        host = stream._SparseStripePlan(bm, sb, n_super, "cpu")
        out = {}
        for i, j in ((0, 1), (0, 2), (1, 1)):
            got = card.stripe_counts(i, j)
            oa, p, ob, q = (torch.from_numpy(a).to(dev) for a in card._segments(i, j))
            rows_i, nnz_i = card._rows_on_card(i)
            rows_j = card._rows_on_card(j)[0]
            if i == j:
                keep = p >= 2
                oa, p = oa[keep].contiguous(), p[keep].contiguous()
                ob, q, rows_j = oa, p, rows_i
                per = p * (p - 1) // 2
            else:
                per = p * q
            prefix = ksp._emission_prefix(per)
            buf = torch.zeros((sb, sb), dtype=torch.int32, device=dev)

            def plain_form():
                buf.zero_()
                ksp.k4_emit_plain(rows_i, rows_j, oa, p, ob, q, prefix, buf, triangle=i == j)
                if i == j:
                    ksp.k4_mirror_plain(buf, nnz_i)

            plain_ms = cuda_ms(torch, plain_form, reps=1, warmup=0)
            err = exact_diff(torch, got, buf)
            t0 = time.perf_counter()
            ref = host.stripe_counts(i, j)
            host_s = time.perf_counter() - t0
            if not np.array_equal(got.cpu().numpy(), ref):
                raise AssertionError(f"stripe ({i}, {j}): K4's card stripe differs from the "
                                     f"host C++ stripe")
            form_ms = cuda_ms(torch, lambda: card.stripe_counts(i, j), reps=3)
            emit_ms = cuda_ms(torch, lambda: ksp.k4_emit(rows_i, rows_j, oa, p, ob, q, prefix, buf,
                                                         triangle=i == j), reps=3)
            e = int(prefix[-1])
            nnz_ij = int(card.subs[i][1].size + (0 if i == j else card.subs[j][1].size))
            out[(i, j)] = dict(emissions=e, nnz=nnz_ij, ms=form_ms, emit_ms=emit_ms,
                               plain_ms=plain_ms, host_ms=host_s * 1e3, max_abs_err=err,
                               use_k4=bool(card.use_k4(i, j, emission_path=True)),
                               eligible=bool(card.emission_eligible(i, j)))
            print(f"[config 3 stream] stripe ({i}, {j}) by K4's kernels on the card: {e} "
                  f"emissions, the card form {form_ms:.4f} ms (its emission kernel "
                  f"{emit_ms:.4f} ms = {e / max(emit_ms * 1e-3, 1e-12):.4g} emissions/s), the "
                  f"plain form on the card {plain_ms:.3f} ms, the host C++ stripe "
                  f"{host_s * 1e3:.2f} ms: all equal; the walk's cost model gives it "
                  f"{'K4' if out[(i, j)]['use_k4'] else 'K2'}"
                  f"{' (the host emission path)' if out[(i, j)]['eligible'] else ''}")
            del got, buf, ref
        torch.cuda.empty_cache()
        return out

    def keys_name(bm) -> str:
        return (f"unique_int64 of {len(bm.coo[0])} COO keys" if bm.coo is not None
                else f"np.sort of {bm.nnz} CSR keys")

    # ------------------------------------------------------- 16 config 3 ingest
    if not native.have_native():
        raise AssertionError(f"the C++ host tier did not build: {native.native_build_error()}")
    mats = {}
    for ver, density in CFG3_VERSIONS:
        k = int(density * n * m)
        rows, pos = rng.integers(0, n, k), rng.integers(0, m, k)
        t0 = time.perf_counter()
        bm = st.BitMatrix.from_positions(rows, pos, n, m)
        ingest = time.perf_counter() - t0
        del rows, pos
        if (bm.coo is None) != (k > st.layout._COO_CACHE_MAX_NNZ):
            raise AssertionError(f"config 3 {ver}: COO cache {bm.coo is not None} at {k} positions")
        print(f"[config 3] version {ver}: {n} x {m} bits, {k} positions drawn at density "
              f"{density}: nnz {bm.nnz} (density {bm.density:.6g}), longest row "
              f"{int(bm.row_nnz.max())}, COO cache {'kept' if bm.coo is not None else 'over the cap'}; "
              f"BitMatrix.from_positions {ingest:.3f} s on the host (C++ tier: "
              f"{native.library_path().name})")
        mats[ver] = bm

    # ----------------------------------------------------- 17 config 3, one matrix
    timing = {}
    for ver, density in CFG3_VERSIONS:
        bm = mats[ver]
        chosen = choose_strategy(bm.n, bm.m_bits, bm.density, cfg, bm=bm, device=dev)
        est_k4, est_k2 = k4_estimates(bm.n, bm.m_bits, bm.density)
        print(f"[config 3] version {ver}: D1 chose {chosen} (K4 estimate {est_k4:.4f} s against "
              f"K2 {est_k2:.4f} s; K4 is weighed below density "
              f"{cfg.sparse_density_threshold})")
        strategies = ("auto", "pallas_mxu", "sparse_outer") + (("sparse",) if ver == "B" else ())
        outs, walls, launched = {}, {}, {}
        for strategy in strategies:
            reset_launches()
            t0 = time.perf_counter()
            outs[strategy] = st.intersect_count_matrix(bm, strategy=strategy, device=dev)
            torch.cuda.synchronize()
            walls[strategy] = time.perf_counter() - t0
            launched[strategy] = {k: v for k, v in launch_counts().items() if v}
        ran = dict(pallas_mxu="k2_tri", sparse_outer="k4", sparse="k3", clustered="k5")
        for strategy in strategies:
            want = ran[chosen if strategy == "auto" else strategy]
            got = launched[strategy]
            if got.get(want, 0) < 1 or (want != "k2_tri" and "k2_tri" in got) or (
                    want == "k4" and ("k4_mirror" not in got or "k4_host" in got)):
                raise AssertionError(f"config 3 {ver} {strategy}: launches {got}, want {want}")
        ref = outs["pallas_mxu"]
        for strategy, out in outs.items():
            if out.shape != (n, n) or out.dtype != np.int32 or not np.array_equal(out, ref):
                raise AssertionError(f"config 3 {ver}: {strategy} differs from pallas_mxu")
        i, j = rng.integers(0, n, N_SAMPLES), rng.integers(0, n, N_SAMPLES)
        if not np.array_equal(ref[i, j], sampled_counts(bm.packed, bm.packed, i, j)):
            raise AssertionError(f"config 3 {ver}: sampled pairs differ from numpy")
        if not np.array_equal(np.diagonal(ref), bm.row_nnz) or not np.array_equal(ref, ref.T):
            raise AssertionError(f"config 3 {ver}: diagonal or symmetry")
        emissions = column_emissions(bm)
        t = timing[ver] = dict(walls=walls, launched=launched, emissions=emissions, nnz=bm.nnz,
                               k4_s=walls["sparse_outer"], k2_tri_ms=k2_tri_ms(bm), chosen=chosen,
                               est=(est_k4, est_k2))
        print(f"[config 3] version {ver}: " + ", ".join(
            f"{s} {walls[s]:.3f} s ({launched[s]})" for s in strategies)
            + f": all {n} x {n} matrices equal; {N_SAMPLES} sampled pairs, the diagonal and "
            f"symmetry exact; K2 triangle {t['k2_tri_ms']:.3f} ms (CUDA events)")
        del outs
        t.update(k4_on_card(bm, ref, ver))
        if ver == "B":
            cfg3_b = (bm, ref)
        pos = torch.from_numpy(ksp.padded_position_lists(bm)).to(dev)
        t["l_pad"] = pos.shape[1]
        if ver == "A":
            # K3 on the first rows against all, and K2's rectangle on the same block
            reset_launches()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            blk = ksp.count_block_sparse(pos[:K3_A_ROWS], pos, sentinel=m)
            stop.record()
            torch.cuda.synchronize()
            t["k3_ms"] = start.elapsed_time(stop)
            if launch_counts()["k3"] < 1 or not np.array_equal(blk.cpu().numpy(), ref[:K3_A_ROWS]):
                raise AssertionError("config 3 A: K3's block differs from the K2 matrix")
            ti, wk = mxu.k2_tile_shape(cfg, n, bm.n_words)
            xa, xb = padded(bm.packed[:K3_A_ROWS], ti, wk), padded(bm.packed, ti, wk)
            rect = mxu.count_block_pallas_mxu(xa, xb)
            if not torch.equal(rect[:K3_A_ROWS, :n], blk):
                raise AssertionError("config 3 A: K2's rectangle differs from K3's block")
            t["k2_rect_ms"] = cuda_ms(torch, lambda: mxu.count_block_pallas_mxu(xa, xb), reps=3)
            print(f"[config 3] version A: K3 on rows 0..{K3_A_ROWS - 1} against all {n} (lists "
                  f"of {pos.shape[1]}) {t['k3_ms']:.3f} ms, equal to the K2 matrix's rows; K2's "
                  f"rectangle on the same block {t['k2_rect_ms']:.3f} ms (CUDA events)")
            del blk, rect, xa, xb
        else:
            t["k3_ms"] = cuda_ms(torch, lambda: ksp.count_block_sparse(pos, pos, sentinel=m),
                                 reps=1, warmup=0)
            sub_cpu = pos[:K3_PLAIN_ROWS].cpu()
            all_cpu = pos.cpu()
            t0 = time.perf_counter()
            plain = ksp.count_block_sparse(sub_cpu, all_cpu, sentinel=m)
            t["k3_plain_ms"] = (time.perf_counter() - t0) * 1e3
            t["k3_err"] = exact_diff(torch, ksp.count_block_sparse(pos[:K3_PLAIN_ROWS], pos,
                                                                   sentinel=m).cpu(), plain)
            t["k3_sub_ms"] = cuda_ms(torch, lambda: ksp.count_block_sparse(
                pos[:K3_PLAIN_ROWS], pos, sentinel=m), reps=3)
            print(f"[config 3] version B: K3 on all {n} rows (lists of {pos.shape[1]}) "
                  f"{t['k3_ms']:.3f} ms against K2's triangle {t['k2_tri_ms']:.3f} ms (CUDA "
                  f"events); on {K3_PLAIN_ROWS} rows against all: card {t['k3_sub_ms']:.3f} ms, "
                  f"its CPU form {t['k3_plain_ms']:.1f} ms, equal")
        del pos
        torch.cuda.empty_cache()

    # ------------------------------------- 18 the streamed K4 walk, both kinds
    bg = int(BACKGROUND_DENSITY * n * m)
    kd = int(CORNER_DENSITY * CORNER_ROWS * CORNER_BITS)
    rows = np.concatenate([rng.integers(0, n, bg), rng.integers(0, CORNER_ROWS, kd)])
    pos = np.concatenate([rng.integers(0, m, bg), rng.integers(0, CORNER_BITS, kd)])
    bm18 = st.BitMatrix.from_positions(rows, pos, n, m)
    del rows, pos
    want = st.intersect_count_matrix(bm18, strategy="pallas_mxu", device=dev)
    n_super = round_up(n, sb) // sb
    with tempfile.TemporaryDirectory() as out:
        reset_launches()
        t0 = time.perf_counter()
        with stream.record_stages() as rec:
            man = stream.stream_count_matrix(bm18, out, superblock_rows=sb, kernel="sparse_outer",
                                             compress=False, device=dev)
        wall18 = time.perf_counter() - t0
        split = man["stripe_kernels"]
        launched18 = {k: v for k, v in launch_counts().items() if v}
        if (split["k4"] < 1 or split["dense"] < 1 or launched18.get("k2_tri") != split["dense"]
                or launched18.get("k4", 0) < 1 or "k4_host" in launched18):
            raise AssertionError(f"streamed K4 walk: split {split}, launches {launched18}")
        if not np.array_equal(stream.load_streamed_matrix(out), want):
            raise AssertionError("streamed K4 walk: the directory differs from the K2 matrix")
        kinds = {(i, j): stream._stripe_kind(stream.stripe_path(out, i, j))
                 for i, j in man["completed"]}
        print(f"[config 3 stream] {n} x {m} bits, background {BACKGROUND_DENSITY}, rows "
              f"0..{CORNER_ROWS - 1} at {CORNER_DENSITY} over bits 0..{CORNER_BITS - 1}: "
              f"{len(kinds)} stripes at superblock {sb}, split {split} "
              f"({', '.join(f'{k}: {v}' for k, v in sorted(kinds.items()))}), launches "
              f"{launched18}; loads to the K2 matrix; {wall18:.3f} s (recorded walk)")
        breakdown("streamed K4 walk, compress off (K4 and dense stripes together)", rec,
                  rec.stripes)
        gone = [next(s for s, k in kinds.items() if k == "k4"),
                next(s for s, k in kinds.items() if k == "dense")]
        kept = {}
        for i, j in gone:
            with np.load(stream.stripe_path(out, i, j)) as z:
                kept[(i, j)] = {name: z[name] for name in z.files}
            os.remove(stream.stripe_path(out, i, j))
        reset_launches()
        again = stream.stream_count_matrix(bm18, out, superblock_rows=sb, kernel="sparse_outer",
                                           compress=False, device=dev)
        if again != man or launch_counts()["k2_tri"] != 1:
            raise AssertionError(f"resume: manifest {again} against {man}")
        for (i, j), members in kept.items():
            with np.load(stream.stripe_path(out, i, j)) as z:
                if sorted(z.files) != sorted(members) or any(
                        not np.array_equal(z[k], v) for k, v in members.items()):
                    raise AssertionError(f"resume: stripe ({i}, {j}) differs")
        print(f"[config 3 stream] resume after deleting stripes {gone} (one of each kind): the "
              f"same files, the same split {again['stripe_kernels']}")
    stripes18 = k4_stripes(bm18, n_super)
    del want, bm18

    # ------------------------------------------- 19 the ultra-sparse shape
    import scipy.sparse

    avail = host_available_bytes()
    n19 = ULTRA_N if avail >= ULTRA_MIN_AVAILABLE else ULTRA_CUT_N
    if n19 != ULTRA_N:
        print(f"[ultra-sparse] the host has {avail / 2**30:.1f} GiB available, under "
              f"{ULTRA_MIN_AVAILABLE / 2**30:.0f}: taking {n19} rows instead of {ULTRA_N}")
    k = int(ULTRA_DENSITY * n19 * m)
    rows, pos = rng.integers(0, n19, k), rng.integers(0, m, k)
    t0 = time.perf_counter()
    bm19 = st.BitMatrix.from_positions(rows, pos, n19, m)
    ingest19 = time.perf_counter() - t0
    del rows, pos
    n_super = round_up(n19, sb) // sb
    with tempfile.TemporaryDirectory() as out:
        reset_launches()
        t0 = time.perf_counter()
        man = stream.stream_count_matrix(bm19, out, superblock_rows=sb, kernel="auto", device=dev)
        wall19 = time.perf_counter() - t0
        launched19 = {k: v for k, v in launch_counts().items() if v}
        stripes = n_super * (n_super + 1) // 2
        if man["kernel"] != "sparse_outer" or len(man["completed"]) != stripes:
            raise AssertionError(f"ultra-sparse: kernel {man['kernel']}, "
                                 f"{len(man['completed'])} of {stripes} stripes")
        t0 = time.perf_counter()
        if bm19.coo is not None:  # the positions as drawn, duplicates dropped
            keys = np.unique(bm19.coo[0] * m + bm19.coo[1])
            x = scipy.sparse.csr_matrix((np.ones(keys.size, np.int64), (keys // m, keys % m)),
                                        shape=(n19, m))
        else:
            indptr, indices = bm19.positions_csr()
            x = scipy.sparse.csr_matrix((np.ones(indices.size, np.int64), indices, indptr),
                                        shape=(n19, m))
        c = (x @ x.T).tocoo()
        si, sj = c.row // sb, c.col // sb
        up = si <= sj
        key = (si * n_super + sj)[up]
        local = ((c.row % sb) * sb + c.col % sb)[up]
        vals = c.data[up]
        order = np.lexsort((local, key))
        key, local, vals = key[order], local[order], vals[order]
        bounds = np.searchsorted(key, np.arange(n_super * n_super + 1))
        for i in range(n_super):
            for j in range(i, n_super):
                lo, hi = bounds[i * n_super + j], bounds[i * n_super + j + 1]
                with np.load(stream.stripe_path(out, i, j)) as z:
                    if "coo_i" not in z.files:
                        got_l = np.flatnonzero(z["counts"])
                        got_v = z["counts"].ravel()[got_l]
                    else:
                        got_l = z["coo_i"].astype(np.int64) * sb + z["coo_j"]
                        got_v = z["coo_v"]
                if not (np.array_equal(got_l, local[lo:hi]) and np.array_equal(got_v, vals[lo:hi])):
                    raise AssertionError(f"ultra-sparse: stripe ({i}, {j}) differs from scipy")
        check19 = time.perf_counter() - t0
    pairs = n19 * (n19 - 1) // 2
    print(f"[ultra-sparse] {n19} x {m} bits at density {ULTRA_DENSITY} (nnz {bm19.nnz}, "
          f"from_positions {ingest19:.3f} s): stream_count_matrix(kernel='auto') resolved to "
          f"{man['kernel']}; {stripes} stripes, split {man['stripe_kernels']}, launches "
          f"{launched19}; wall {wall19:.3f} s = {wall19 / stripes * 1e3:.3f} ms a stripe = "
          f"{pairs / wall19:.4g} pairs/s; every stripe equals scipy's csr @ csr.T "
          f"({c.nnz} nonzeros, {check19:.2f} s to check)")
    del bm19, x, c

    # ------------------------------------------------------ the kernels line
    a, b = timing["A"], timing["B"]
    # K3's bound: one int32 probe (4 bytes) a lookup at the HBM rate, or its
    # inputs read once and its output written once, whichever is longer
    lookups = float(n) * n * b["l_pad"]
    lookup_ms = 4.0 * lookups / PEAK_BYTES_PER_S * 1e3
    bytes_once_ms = (4.0 * (n * b["l_pad"] + n * n)) / PEAK_BYTES_PER_S * 1e3
    k3 = dict(name="k3", route="torch", source="stormtpu_torch/kernels/sparse.py",
              replaces="stormtpu/kernels/sparse.py:60", launches=b["launched"]["sparse"]["k3"],
              max_abs_err=b["k3_err"], ms=b["k3_ms"], plain_ms=b["k3_plain_ms"],
              bound_ms=max(lookup_ms, bytes_once_ms),
              bound_by="operations" if lookup_ms >= bytes_once_ms else "bytes",
              library_ms=b["k2_tri_ms"],
              library="K2's triangle (k2_tri) on the same matrix, by CUDA events",
              shape=f"{n} x {n} pairs, lists of {b['l_pad']} (config 3, version B)",
              bound_rule="one int32 probe read (4 bytes) a lookup at the HBM rate; "
                         f"bytes read once and written once: {bytes_once_ms:.4f} ms",
              plain_shape=f"{K3_PLAIN_ROWS} x {n} pairs on the CPU",
              ms_at_plain_shape=b["k3_sub_ms"],
              version_a=dict(shape=f"{K3_A_ROWS} x {n} pairs, lists of {a['l_pad']}",
                             ms=a["k3_ms"], k2_rect_ms=a["k2_rect_ms"]))
    # K4's bound: the least time the card could take for the same work, as
    # K3's: one int32 read-modify-write (8 bytes) an emission at the HBM rate,
    # or its nonzeros read once as int32 (row, column) and its int32 matrix
    # written once, whichever is longer. It reads no tuning cache. The
    # emissions are those the kernel makes: the strict pairs of a column's
    # run (the diagonal is written from the rows' nnz, inside the matrix's
    # write) or, off the diagonal, every pair of two runs.
    def k4_bound(emissions: float, nnz: float, out_entries: float) -> tuple[float, str]:
        emit_ms = 8.0 * emissions / PEAK_BYTES_PER_S * 1e3
        once_ms = (8.0 * nnz + 4.0 * out_entries) / PEAK_BYTES_PER_S * 1e3
        return max(emit_ms, once_ms), "operations" if emit_ms >= once_ms else "bytes"

    def k4_launches(key: str) -> dict:
        per = {f"phase17_{ver}": sum(v.get(key, 0) for v in timing[ver]["launched"].values())
               for ver in ("A", "B")}
        return dict(per, phase18=launched18.get(key, 0), phase19=launched19.get(key, 0))

    def call_ms(t: dict) -> float:
        return t["k4_zero_ms"] + t["k4_emit_ms"] + t["k4_mirror_ms"]

    src_k4 = "stormtpu_torch/kernels/csrc/k4_sparse.cu"
    k4_b_ms, k4_b_by = k4_bound(b["k4_pairs"], b["nnz"], float(n) * n)
    k4_a_ms, k4_a_by = k4_bound(a["k4_pairs"], a["nnz"], float(n) * n)
    s01 = stripes18[(0, 1)]
    per17 = k4_launches("k4")
    k4 = dict(name="k4", route="cuda", source=src_k4,
              replaces="stormtpu/kernels/sparse.py:117 (count_matrix_sparse_outer; its host "
                       "C++ stormtpu/native/packer.cpp:182 and :205)",
              launches=sum(per17.values()), launches_by_phase=per17,
              max_abs_err=max(a["k4_err"], b["k4_err"],
                              *(v["max_abs_err"] for v in stripes18.values())),
              ms=call_ms(b), plain_ms=b["k4_plain_ms"], bound_ms=k4_b_ms, bound_by=k4_b_by,
              library_ms=b["k4_library_ms"],
              library="torch.sparse.mm of X and its transpose, float32 CSR on the card",
              shape=f"config 3 version B, {b['emissions']} emissions with the diagonal, "
                    f"{b['k4_pairs']} column pairs",
              ms_is="zeroing + emission + mirror, CUDA events",
              zero_ms=b["k4_zero_ms"], emit_ms=b["k4_emit_ms"], mirror_ms=b["k4_mirror_ms"],
              emissions_per_s=b["k4_pairs"] / (b["k4_emit_ms"] * 1e-3),
              call_s=b["k4_call_s"], stages_s=b["k4_stages"], host_sort_s=b["k4_host_sort_s"],
              host_k4_s=b["k4_host_s"], k2_tri_ms=b["k2_tri_ms"], d1=b["chosen"],
              d1_estimates_s=b["est"],
              bound_rule="one int32 read-modify-write (8 bytes) an emission at the card's "
                         "HBM rate, or int32 (row, column) pairs read once and the int32 "
                         "matrix written once",
              version_a=dict(ms=call_ms(a), zero_ms=a["k4_zero_ms"], emit_ms=a["k4_emit_ms"],
                             mirror_ms=a["k4_mirror_ms"], plain_ms=a["k4_plain_ms"],
                             emissions=a["emissions"], pairs=a["k4_pairs"],
                             emissions_per_s=a["k4_pairs"] / (a["k4_emit_ms"] * 1e-3),
                             bound_ms=k4_a_ms, bound_by=k4_a_by,
                             library_ms=a["k4_library_ms"],
                             call_s=a["k4_call_s"], stages_s=a["k4_stages"],
                             host_sort_s=a["k4_host_sort_s"], k2_tri_ms=a["k2_tri_ms"],
                             d1=a["chosen"], d1_estimates_s=a["est"],
                             route="packed words (no COO cache)"),
              stripe_0_1=dict(s01, bound_ms=k4_bound(s01["emissions"], s01["nnz"],
                                                     float(sb) * sb)[0]),
              stripes={f"{i},{j}": v for (i, j), v in stripes18.items()})
    k4_mirror = dict(name="k4_mirror", route="cuda", source=src_k4,
                     replaces="stormtpu/native/packer.cpp:231 (stpu_mirror_upper, the host "
                              "mirror of stormtpu/kernels/sparse.py:117)",
                     launches=sum(k4_launches("k4_mirror").values()),
                     launches_by_phase=k4_launches("k4_mirror"),
                     max_abs_err=max(a["k4_err"], b["k4_err"]), ms=b["k4_mirror_ms"],
                     plain_ms=b["k4_mirror_plain_ms"],
                     bound_ms=4.0 * n * n / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                     library_ms=None, library="none: no one PyTorch call mirrors a triangle",
                     shape=f"{n} x {n} int32 (config 3)",
                     bound_rule="the strict upper triangle read once and the lower written "
                                "once (4·N² bytes) at the HBM rate")
    return [k3, k4, k4_mirror], cfg3_b


def query_phases(torch, dev, cfg, rng, seed, k2_ops_per_s, main, block, ld, cfg3_b) -> tuple:
    """Phases 20 to 24: the analytics surface (``setops``, ``query``,
    ``cross``, ``clump``, ``stats``). Returns the launches of every kernel
    over these phases' calls, those of phases 25 to 28, and what phase 32
    holds its results to: phase 20's top-k values and count screen, and
    phase 24's host matrix with its histogram."""
    import stormtpu_torch as st
    from stormtpu_torch import query, stream
    from stormtpu_torch.kernels import launch_counts, mxu, reset_launches
    from stormtpu_torch.query import _pack_bit_rows
    from stormtpu_torch.setops import derive_similarity
    from stormtpu_torch.utils import round_up

    total = dict.fromkeys(launch_counts(), 0)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run(label: str, fn, want=(), absent=(), again=False, into=None):
        """A recorded call of ``fn``: (result, wall s, stages, launches).
        Raises unless every kernel in ``want`` launched and none in
        ``absent``; the launches add to the phases' totals (``into``, else
        these phases'). ``again``: a second recorded call follows, and its
        wall and stages are returned (the first call's wall is printed):
        the first call of a shape pays for CUDA's module loads and the
        operand's upload."""
        reset_launches()
        sync()
        t0 = time.perf_counter()
        with stream.record_stages() as rec:
            out = fn()
        sync()
        wall = time.perf_counter() - t0
        got = launch_counts()
        for k, v in got.items():
            acc = total if into is None else into
            acc[k] = acc.get(k, 0) + v
        if any(got[k] < 1 for k in want) or any(got[k] for k in absent):
            raise AssertionError(f"{label}: launches {got}; want {want} and none of {absent}")
        if again:
            print(f"[query] {label}: first call {wall:.4f} s (recorded)")
            sync()
            t0 = time.perf_counter()
            with stream.record_stages() as rec:
                fn()
            sync()
            wall = time.perf_counter() - t0
        return out, wall, rec, {k: v for k, v in got.items() if v}

    def screen_ref(c: np.ndarray, nnz: np.ndarray, m: int, measure: str, threshold: float):
        """The strict-upper-triangle pairs with measure >= threshold, row-major,
        with their float64 values: the measure in float64 on the card as a
        prefilter (a margin of 1e-9), then ``derive_similarity`` (NumPy) on the
        candidates, exact."""
        nz = torch.from_numpy(nnz.astype(np.float64)).to(dev)
        cols = torch.arange(c.shape[0], device=dev)
        out_i, out_j = [], []
        for r0 in range(0, c.shape[0], 2048):
            x = torch.from_numpy(c[r0 : r0 + 2048]).to(dev).to(torch.float64)
            ca, cb = nz[r0 : r0 + x.shape[0], None], nz[None, :]
            if measure == "jaccard":
                v = x / (ca + cb - x)
            else:  # r2
                v = (m * x - ca * cb) ** 2 / (ca * cb * (m - ca) * (m - cb))
            hit = (torch.nan_to_num(v, nan=0.0) >= threshold - 1e-9) & \
                (cols[None, :] > cols[r0 : r0 + x.shape[0], None])
            si, sj = (t.cpu().numpy() for t in torch.nonzero(hit, as_tuple=True))
            out_i.append(si + r0)
            out_j.append(sj)
        ii, jj = np.concatenate(out_i), np.concatenate(out_j)
        vals = derive_similarity(c[ii, jj], nnz[ii], nnz[jj], m, measure)
        keep = vals >= threshold
        return ii[keep].astype(np.int32), jj[keep].astype(np.int32), vals[keep]

    def wall_of(fn) -> float:
        """Host seconds of one call that is not recorded (its stages overlap)."""
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    def stages(label: str, rec, wall: float, chunks: int = 0, bound_s: float = 0.0) -> None:
        """A ``[breakdown]`` line: each stage's host seconds (the device
        synchronised around it) with its CUDA-event milliseconds, per chunk
        where the call walks tile chunks, and K2's share of its bound."""
        parts = []
        for k, v in rec.seconds.items():
            ms = rec.device_ms.get(k)
            part = f"{k} {v:.4f} s" + (f" ({ms:.2f} ms by CUDA events" if ms is not None else "")
            if ms is not None and chunks:
                part += f", {ms / chunks:.3f} ms a chunk"
            parts.append(part + (")" if ms is not None else ""))
        line = f"[breakdown] {label}: wall {wall:.4f} s (recorded); " + ", ".join(parts)
        kern = rec.device_ms.get("kernel")
        if bound_s and kern:
            line += (f"; K2 {kern / 1e3:.4f} s against its bound {bound_s:.4f} s: "
                     f"{bound_s / (kern / 1e3):.1%} of it")
        print(line + routes_of(rec))

    def store_route(fn):
        """``fn`` with K2-topk and K2-hist switched off (their dispatch
        limits at 0): the tiles are stored and reduced by torch."""
        keep = mxu.TOPK_EPI_MAX, mxu.HIST_EPI_MAX_BINS
        mxu.TOPK_EPI_MAX = mxu.HIST_EPI_MAX_BINS = 0
        try:
            return fn()
        finally:
            mxu.TOPK_EPI_MAX, mxu.HIST_EPI_MAX_BINS = keep

    def tri_hist(c: np.ndarray, width: int) -> np.ndarray:
        """Counts of each value 0..width-1 over the strict upper triangle."""
        out = np.zeros(width, dtype=np.int64)
        cols = np.arange(c.shape[0])
        for r0 in range(0, c.shape[0], 1024):
            blk = c[r0 : r0 + 1024]
            out += np.bincount(blk[cols[None, :] > cols[r0 : r0 + blk.shape[0], None]],
                               minlength=width)
        return out

    def binned(full: np.ndarray, n_bins: int, bw: int) -> np.ndarray:
        h = np.zeros(n_bins, dtype=np.int64)
        np.add.at(h, np.minimum(np.arange(full.size) // bw, n_bins - 1), full)
        return h

    def same_pairs(label: str, got, want) -> None:
        for g, w in zip(got, want):
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"{label}: {got[0].size} pairs, want {want[0].size}, "
                                     "or other pairs or values")

    def topk_of(rows: np.ndarray, k: int, self_cols=None) -> np.ndarray:
        """Each row's k largest values, descending (``self_cols``: a column a
        row that is masked to -1 first)."""
        rows = rows.astype(np.int64)
        if self_cols is not None:
            rows[np.arange(rows.shape[0]), self_cols] = -1
        return -np.sort(-np.partition(rows, rows.shape[1] - k, axis=1)[:, -k:], axis=1)

    def valid_indices(label: str, c_rows: np.ndarray, vals, idx, self_cols=None) -> None:
        r = np.arange(idx.shape[0])[:, None]
        s = np.sort(idx, axis=1)
        if not (np.array_equal(c_rows[r, idx], vals) and (np.diff(s, axis=1) > 0).all()
                and (self_cols is None or (idx != np.asarray(self_cols)[:, None]).all())):
            raise AssertionError(f"{label}: an index does not realize its value, repeats, "
                                 "or is the row itself")

    # ----------------------------------------------- 20 the main-path shape
    bm, c = main
    n, m = bm.n, bm.m_bits
    nnz = bm.row_nnz
    ti, wk = mxu.k2_tile_shape(cfg, n, bm.n_words)
    nb = round_up(n, ti) // ti
    n_tiles = nb * (nb + 1) // 2
    chunks = -(-n_tiles // query._tile_chunk(ti))
    tri_bound = 2.0 * n_tiles * ti * ti * round_up(bm.n_words, wk) * 32 / k2_ops_per_s
    t0 = time.perf_counter()
    full = tri_hist(c, m + 1)
    tail = np.cumsum(full[::-1])[::-1]  # tail[t]: pairs with count >= t
    t_count = int(np.argmax(tail <= SCREEN_HITS[1] // 3))
    hits_count = int(tail[t_count])
    if not SCREEN_HITS[0] <= hits_count <= SCREEN_HITS[1]:
        raise AssertionError(f"no count threshold gives {SCREEN_HITS} hits ({hits_count})")
    print(f"[query] main path {n} x {m} bits: C's upper triangle binned on the host in "
          f"{time.perf_counter() - t0:.2f} s; count threshold {t_count} holds {hits_count} pairs; "
          f"tile walk {n_tiles} tiles of {ti} rows in {chunks} chunks of "
          f"{query._tile_chunk(ti)}")

    (vals, idx), wall, rec, launched = run(
        "topk_neighbors", lambda: st.topk_neighbors(bm, TOPK_K, device=dev),
        want=("k2_topk",), absent=("k2_rect", "k5", "k2_tri"), again=True)
    (sv, si), wall_st, rec_st, launched_st = store_route(lambda: run(
        "topk_neighbors store route", lambda: st.topk_neighbors(bm, TOPK_K, device=dev),
        want=("k2_tri",), absent=("k2_topk",), again=True, into={}))
    for r0 in range(0, n, 1024):
        r = np.arange(r0, min(r0 + 1024, n))
        if not np.array_equal(vals[r], topk_of(c[r], TOPK_K, r)):
            raise AssertionError(f"topk_neighbors: rows {r0}.. differ from C's top {TOPK_K}")
        valid_indices("topk_neighbors", c[r], vals[r], idx[r], r)
        valid_indices("topk_neighbors store route", c[r], sv[r], si[r], r)
    if not np.array_equal(vals, sv):
        raise AssertionError("topk_neighbors: K2-topk's values differ from the store route's")
    kept = {"topk20": vals, "topk20_launches": launched["k2_topk"]}
    # unrecorded calls in turns, the store route first (its stages overlap)
    as_run = {"epilogue": [], "store": []}
    for _ in range(5):
        as_run["store"].append(store_route(
            lambda: wall_of(lambda: st.topk_neighbors(bm, TOPK_K, device=dev))))
        as_run["epilogue"].append(wall_of(lambda: st.topk_neighbors(bm, TOPK_K, device=dev)))
    print(f"[query] topk_neighbors(k={TOPK_K}) {n} rows: tile walk through K2-topk, launches "
          f"{launched}; values equal C's top {TOPK_K} off the diagonal and the store route's "
          f"(K2-tri, then torch's top-k: launches {launched_st}), indices valid on both; warm "
          f"wall {wall:.4f} s, store route {wall_st:.4f} s (recorded); as run, five calls in "
          f"turns: K2-topk {', '.join(f'{w:.4f}' for w in as_run['epilogue'])} s (median "
          f"{np.median(as_run['epilogue']):.4f}), store route "
          f"{', '.join(f'{w:.4f}' for w in as_run['store'])} s (median "
          f"{np.median(as_run['store']):.4f})")
    stages(f"topk_neighbors {n} x {m}, k={TOPK_K}", rec, wall, chunks, tri_bound)
    stages(f"topk_neighbors {n} x {m}, k={TOPK_K}, store route", rec_st, wall_st, chunks,
           tri_bound)
    del sv, si

    got, wall, rec, launched = run(
        "pairs_above count", lambda: st.pairs_above(bm, t_count, device=dev),
        want=("k2_tri", "k0"), again=True)
    wi, wj = np.nonzero(np.triu(c >= t_count, 1))
    same_pairs("pairs_above count", got, (wi.astype(np.int32), wj.astype(np.int32), c[wi, wj]))
    kept["screen20"] = (t_count, got)
    print(f"[query] pairs_above(count >= {t_count}): {got[0].size} pairs, equal to "
          f"np.nonzero(np.triu(C >= t, 1)) with values; launches {launched}; warm wall "
          f"{wall:.4f} s (recorded)")
    stages(f"pairs_above count {n} x {m}", rec, wall, chunks, tri_bound)

    si, sj = rng.integers(0, n, 1 << 21), rng.integers(0, n, 1 << 21)
    keep = si != sj
    sample = derive_similarity(c[si[keep], sj[keep]], nnz[si[keep]], nnz[sj[keep]], m, "jaccard")
    t_jac = float(np.quantile(sample, 1.0 - 2 * SCREEN_HITS[0] / (n * (n - 1) / 2)))
    got, wall, rec, launched = run(
        "pairs_above jaccard", lambda: st.pairs_above(bm, t_jac, measure="jaccard", device=dev),
        want=("k2_tri", "k0"), again=True)
    same_pairs("pairs_above jaccard", got, screen_ref(c, nnz, m, "jaccard", t_jac))
    print(f"[query] pairs_above(jaccard >= {t_jac:.6f}): {got[0].size} pairs, equal to the "
          f"float64 filter of C; launches {launched}; warm wall {wall:.4f} s (recorded)")
    stages(f"pairs_above jaccard {n} x {m}", rec, wall, chunks, tri_bound)

    pi, pj = rng.integers(0, n, PAIR_COUNTS_P), rng.integers(0, n, PAIR_COUNTS_P)
    pc, wall, rec, launched = run("pair_counts", lambda: st.pair_counts(bm, pi, pj, device=dev),
                                  want=("k0",), again=True)
    if not np.array_equal(pc, c[pi, pj]):
        raise AssertionError("pair_counts differs from C")
    print(f"[query] pair_counts of {PAIR_COUNTS_P} pairs: equal to C[ii, jj]; launches "
          f"{launched}; warm wall {wall:.4f} s")
    del pc, pi, pj

    sim, wall, _, launched = run("similarity_matrix r2",
                                 lambda: st.similarity_matrix(bm, "r2", device=dev),
                                 want=("k2_tri",))
    xor, wall_x, _, _ = run("pairwise_cardinality xor",
                            lambda: st.pairwise_cardinality(bm, "xor", device=dev),
                            want=("k2_tri",))
    # exact on sampled rows (the host's float64 pass over all of C takes
    # as long again as the call)
    rows = np.sort(rng.choice(n, min(n, SIM_CHECK_ROWS), replace=False))
    if not np.array_equal(sim[rows], derive_similarity(c[rows], nnz[rows][:, None],
                                                       nnz[None, :], m, "r2")):
        raise AssertionError("similarity_matrix r2 differs from derive_similarity of C")
    for r0 in range(0, n, 1024):
        cb = c[r0 : r0 + 1024].astype(np.int64)
        if not np.array_equal(xor[r0 : r0 + cb.shape[0]],
                              nnz[r0 : r0 + cb.shape[0], None] + nnz[None, :] - 2 * cb):
            raise AssertionError("pairwise_cardinality xor differs from C")
    del sim, xor
    rs, wall_rs, _, _ = run("count_row_sums", lambda: st.count_row_sums(bm, device=dev))
    cc, wall_cc, _, _ = run("column_counts", lambda: st.column_counts(bm, device=dev))
    if not np.array_equal(rs, c.sum(axis=1, dtype=np.int64)):
        raise AssertionError("count_row_sums differs from C.sum(1)")
    pos = rng.integers(0, m, SIM_CHECK_ROWS)
    want_cc = ((bm.packed[:, pos >> 5] >> (pos & 31).astype(np.uint32)) & 1).sum(axis=0)
    if not (np.array_equal(cc[pos], want_cc) and int(cc.sum(dtype=np.int64)) == bm.nnz):
        raise AssertionError("column_counts differs from numpy")
    print(f"[query] similarity_matrix(r2) {wall:.3f} s ({launched}) and pairwise_cardinality(xor) "
          f"{wall_x:.3f} s equal derive_similarity on {SIM_CHECK_ROWS} sampled rows / the set "
          f"identity on C; count_row_sums {wall_rs:.3f} s equals C.sum(1); column_counts "
          f"{wall_cc:.3f} s equals numpy at {SIM_CHECK_ROWS} sampled positions, its sum nnz")

    hist_want = binned(full, HIST_BINS, -(-(m + 1) // HIST_BINS))
    os.environ["STORMTPU_DEVICE_OPERAND_BUDGET_BYTES"] = str(bm.packed.nbytes // 2)
    try:
        man_s, wall_s, rec_s, launched = run("count_histogram streamed",
                                             lambda: st.count_histogram(bm, n_bins=HIST_BINS,
                                                                        device=dev),
                                             want=("k2_hist",), absent=("k2_tri",))
        man_st, wall_st, rec_st, _ = store_route(lambda: run(
            "count_histogram streamed, store route",
            lambda: st.count_histogram(bm, n_bins=HIST_BINS, device=dev), want=("k2_tri",),
            absent=("k2_hist",), into={}))
    finally:
        del os.environ["STORMTPU_DEVICE_OPERAND_BUDGET_BYTES"]
    man_d, wall_d, rec_d, _ = run("count_histogram dense",
                                  lambda: st.count_histogram(bm, n_bins=HIST_BINS,
                                                             method="dense", device=dev),
                                  want=("k2_hist",), absent=("k2_tri",))
    if not (man_s.get("operand_streaming") and "operand_streaming" not in man_d):
        raise AssertionError("count_histogram: the lowered budget did not stream the operand")
    if not np.array_equal(man_s["hist"], man_st["hist"]):
        raise AssertionError("count_histogram streamed: K2-hist's differs from the store route's")
    print(f"[query] count_histogram streamed (two slices, _PairStripes) through K2-hist "
          f"{wall_s:.3f} s, the store route on the same matrix {wall_st:.3f} s: equal")
    stages("count_histogram streamed, store route", rec_st, wall_st,
           man_st["n_super"] * (man_st["n_super"] + 1) // 2)
    for man in (man_s, man_d):
        if not np.array_equal(man["hist"], hist_want):
            raise AssertionError(f"count_histogram ({man.get('operand_streaming')}) differs "
                                 "from the histogram of C's upper triangle")
    print(f"[query] count_histogram {HIST_BINS} bins: auto under a lowered operand budget took "
          f"the operand-streaming walk ({man_s['n_super']} superblocks, {launched}) in "
          f"{wall_s:.3f} s, method='dense' {wall_d:.3f} s; both equal C's upper-triangle "
          f"histogram")
    stripes = man_d["n_super"] * (man_d["n_super"] + 1) // 2
    stages("count_histogram streamed", rec_s, wall_s, stripes)
    stages("count_histogram dense", rec_d, wall_d, stripes)
    del full, tail

    # ---------------------------------------------------- 21 the LD panel
    bm_ld, ld_ref = ld
    n_ld = bm_ld.n
    got, wall, rec, launched = run(
        "LD r2 screen", lambda: st.pairs_above(bm_ld, LD_R2, measure="r2", device=dev),
        want=("k5",), absent=("k2_tri",))
    want_r = screen_ref(ld_ref, bm_ld.row_nnz, bm_ld.m_bits, "r2", LD_R2)
    same_pairs("LD r2 screen", got, want_r)
    print(f"[query] LD panel pairs_above(r2 >= {LD_R2}): clustered host route, launches "
          f"{launched}, {got[0].size} pairs (the panel's bits are independent, so r2 stays "
          f"near 0), equal to the float64 filter of phase 8's matrix; wall {wall:.3f} s")
    stages("LD pairs_above r2 (K5 matrix, host filter)", rec, wall)
    full_ld = tri_hist(ld_ref, int(ld_ref.max()) + 1)
    tail = np.cumsum(full_ld[::-1])[::-1]
    t_ld = int(np.argmax(tail <= SCREEN_HITS[1] // 3))
    got, wall, _, launched = run("LD count screen", lambda: st.pairs_above(bm_ld, t_ld, device=dev),
                                 want=("k5",), absent=("k2_tri",))
    wi, wj = np.nonzero(np.triu(ld_ref >= t_ld, 1))
    same_pairs("LD count screen", got, (wi.astype(np.int32), wj.astype(np.int32), ld_ref[wi, wj]))
    print(f"[query] LD panel pairs_above(count >= {t_ld}): {got[0].size} pairs equal to phase "
          f"8's matrix, launches {launched}; wall {wall:.3f} s")
    stat = np.random.default_rng(seed).random(n_ld)
    cl, wall, _, launched = run("clump", lambda: st.clump(bm_ld, stat, LD_R2, device=dev),
                                want=("k5",))
    want_cl = st.clump_from_pairs(want_r[0], want_r[1], stat, n=n_ld)
    if not (np.array_equal(cl.leader, want_cl.leader)
            and np.array_equal(cl.leaders, want_cl.leaders)):
        raise AssertionError("clump differs from the grouping of the filtered pairs")
    print(f"[query] LD panel clump(r2 >= {LD_R2}): {cl.n_clumps} clumps, equal to "
          f"clump_from_pairs of the reference pairs; launches {launched}; wall {wall:.3f} s")
    man, wall, rec, launched = run(
        "LD count_histogram", lambda: st.count_histogram(bm_ld, n_bins=HIST_BINS,
                                                         bin_width=LD_BIN_WIDTH, device=dev),
        want=("k5",), absent=("k2_tri",))
    if man["kernel"] != "clustered" or not np.array_equal(
            man["hist"], binned(full_ld, HIST_BINS, LD_BIN_WIDTH)):
        raise AssertionError(f"LD count_histogram ({man['kernel']}) differs from phase 8's matrix")
    print(f"[query] LD panel count_histogram(auto): route {man['kernel']}, launches {launched}, "
          f"{man['work_items']} work items, {man['stripes_skipped']} stripes skipped; equal to "
          f"the histogram of phase 8's matrix; wall {wall:.3f} s")
    stages("LD count_histogram (K5 work lists)", rec, wall)
    del full_ld, tail

    # -------------------------------------- 22 config 3, version B: K4 histogram
    bm_b, ref_b = cfg3_b
    man, wall, rec, launched = run(
        "config 3 B count_histogram sparse",
        lambda: st.count_histogram(bm_b, n_bins=CFG3_BINS, bin_width=1, method="sparse",
                                   device=dev))
    if not np.array_equal(man["hist"], binned(tri_hist(ref_b, int(ref_b.max()) + 1),
                                              CFG3_BINS, 1)):
        raise AssertionError("config 3 B: the sparse histogram differs from phase 17's matrix")
    print(f"[query] config 3 version B count_histogram(method='sparse', {CFG3_BINS} bins of "
          f"width 1): stripes {man['stripe_kernels']}, launches {launched}; equal to the "
          f"histogram of phase 17's K2 matrix: {man['hist'].tolist()}; wall {wall:.3f} s")
    stages("config 3 B sparse histogram", rec, wall)

    # ---------------------------------------- 23 cross and missing data
    bm_a, blk = block
    (cv, ci), wall, rec, launched = run(
        "cross_topk_neighbors", lambda: st.cross_topk_neighbors(bm_a, bm, CROSS_K, device=dev),
        want=("k2_rect",), absent=("k2_tri",))
    if not np.array_equal(cv, topk_of(blk, CROSS_K)):
        raise AssertionError("cross_topk_neighbors differs from phase 4's block")
    valid_indices("cross_topk_neighbors", blk, cv, ci)
    print(f"[query] cross_topk_neighbors(k={CROSS_K}) {bm_a.n} x {n}: launches {launched}; "
          f"values equal phase 4's block, indices valid; wall {wall:.3f} s")
    stages("cross_topk_neighbors", rec, wall)
    bc = np.bincount(blk.ravel())
    tail = np.cumsum(bc[::-1])[::-1]
    t_cross = int(np.argmax(tail <= SCREEN_HITS[1] // 3))
    got, wall, rec, launched = run("cross_pairs_above",
                                   lambda: st.cross_pairs_above(bm_a, bm, t_cross, device=dev),
                                   want=("k2_rect",), absent=("k2_tri",))
    wi, wj = np.nonzero(blk >= t_cross)
    same_pairs("cross_pairs_above", got, (wi.astype(np.int32), wj.astype(np.int32), blk[wi, wj]))
    print(f"[query] cross_pairs_above(count >= {t_cross}): {got[0].size} pairs equal to phase "
          f"4's block; launches {launched}; wall {wall:.3f} s")
    stages("cross_pairs_above", rec, wall)
    # count_block's download: page-locked (utils.download) against the pageable copy it made
    from stormtpu_torch.kernels import count_block_auto

    walls = [wall_of(lambda: st.count_block(bm_a, bm, device=dev)) for _ in range(3)]
    a_d, b_d = bm_a.device_padded(bm_a.n, device=dev), bm.device_padded(n, device=dev)
    pageable = [wall_of(lambda: count_block_auto(a_d, b_d, config=cfg).cpu().numpy())
                for _ in range(3)]
    print(f"[query] count_block {bm_a.n} x {n} wall, three calls: page-locked download "
          f"{', '.join(f'{w:.4f}' for w in walls)} s; the same product with the pageable .cpu() "
          f"download it had before {', '.join(f'{w:.4f}' for w in pageable)} s")
    del bc, tail

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 23)
    wc = COMPLETE_M // 32
    d = torch.randint(-(1 << 31), 1 << 31, (COMPLETE_N, wc), dtype=torch.int32, device=dev,
                      generator=gen)
    # odd rows: the row before with a tenth of the words redrawn (strong LD)
    redraw = torch.rand((COMPLETE_N // 2, wc), device=dev, generator=gen) < 0.1
    d[1::2] = torch.where(redraw, d[1::2], d[0::2])
    mask = torch.empty_like(d)
    for r0 in range(0, COMPLETE_N, 256):
        rows = min(256, COMPLETE_N - r0)
        mask[r0 : r0 + rows] = _pack_bit_rows(
            torch.rand((rows, COMPLETE_M), device=dev, generator=gen) >= COMPLETE_MISSING)
    d &= mask
    bm_d = st.BitMatrix.from_packed(d.cpu().numpy().view(np.uint32), COMPLETE_M)
    bm_m = st.BitMatrix.from_packed(mask.cpu().numpy().view(np.uint32), COMPLETE_M)
    del d, mask, redraw
    four = {k: st.count_block(x, y, device=dev)
            for k, (x, y) in dict(dd=(bm_d, bm_d), dm=(bm_d, bm_m), md=(bm_m, bm_d),
                                  mm=(bm_m, bm_m)).items()}
    i, j = rng.integers(0, COMPLETE_N, 64), rng.integers(0, COMPLETE_N, 64)
    for k, (x, y) in dict(dd=(bm_d, bm_d), dm=(bm_d, bm_m), md=(bm_m, bm_d),
                          mm=(bm_m, bm_m)).items():
        if not np.array_equal(four[k][i, j], sampled_counts(x.packed, y.packed, i, j)):
            raise AssertionError(f"pairwise-complete reference: count block {k} differs from numpy")
    sim_want = derive_similarity(four["dd"], four["dm"], four["md"], four["mm"], "r2")
    sim, wall, _, launched = run(
        "similarity_matrix_complete",
        lambda: st.similarity_matrix_complete(bm_d, bm_m, "r2", device=dev))
    if not np.array_equal(sim, sim_want):
        raise AssertionError("similarity_matrix_complete differs from the four count blocks")
    print(f"[query] similarity_matrix_complete(r2) {COMPLETE_N} x {COMPLETE_M} bits, "
          f"{COMPLETE_MISSING:.0%} missing: equal to derive_similarity over four count blocks; "
          f"launches {launched}; wall {wall:.3f} s")
    got, wall, rec, launched = run(
        "pairs_above_complete",
        lambda: st.pairs_above_complete(bm_d, bm_m, COMPLETE_R2, device=dev), want=("k2_rect",))
    wi, wj = np.nonzero(np.triu(sim_want >= COMPLETE_R2, 1))
    same_pairs("pairs_above_complete", got,
               (wi.astype(np.int32), wj.astype(np.int32), sim_want[wi, wj]))
    print(f"[query] pairs_above_complete(r2 >= {COMPLETE_R2}): {got[0].size} pairs equal to the "
          f"reference; launches {launched}; wall {wall:.3f} s")
    stages("pairs_above_complete", rec, wall)
    complete_pairs = got
    a_rows = COMPLETE_N // 4
    bm_q = st.BitMatrix.from_packed(bm_d.packed[:a_rows], COMPLETE_M)
    (mv, mi), wall, _, launched = run(
        "cross_topk_neighbors r2",
        lambda: st.cross_topk_neighbors(bm_q, bm_d, CROSS_K, measure="r2", device=dev),
        want=("k2_rect",))
    r2 = derive_similarity(four["dd"][:a_rows], bm_q.row_nnz[:, None], bm_d.row_nnz[None, :],
                           COMPLETE_M, "r2")
    order = np.lexsort((np.broadcast_to(np.arange(COMPLETE_N), r2.shape), -r2), axis=1)[:, :CROSS_K]
    if not (np.array_equal(mi, order) and np.array_equal(mv, np.take_along_axis(r2, order, 1))):
        raise AssertionError("cross_topk_neighbors(r2) differs from the exact float64 top-k")
    print(f"[query] cross_topk_neighbors(k={CROSS_K}, r2) {a_rows} x {COMPLETE_N}: values and "
          f"indices equal the exact float64 top-k (ties to the lower index); launches "
          f"{launched}; wall {wall:.3f} s")
    del four, sim, sim_want, r2, bm_q

    # -------------------------------- 24 config 4 at full scale
    w4 = CFG4_M // 32
    n4 = CFG4_N
    avail = host_available_bytes()
    if CFG4_HOST_FACTOR * 4 * n4 * w4 > avail:
        n4 = int(avail // (CFG4_HOST_FACTOR * 4 * w4)) // SUPERBLOCK * SUPERBLOCK
        print(f"[config 4 query] the host has {avail / 2**30:.1f} GiB available: taking {n4} "
              f"rows instead of {CFG4_N}")
    if on_card:
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        need = 4 * round_up(n4, SUPERBLOCK) * w4 + n4 * n4 // 8 + (6 << 30)
        if need > free:
            n4 = int((free - (6 << 30)) // (4 * w4 + n4 // 8)) // SUPERBLOCK * SUPERBLOCK
            print(f"[config 4 query] the card has {free / 2**30:.1f} GiB free: taking {n4} rows")
    gen.manual_seed(seed + 24)
    t0 = time.perf_counter()
    words4 = np.empty((n4, w4), dtype=np.uint32)
    for r0 in range(0, n4, SUPERBLOCK):
        rows = min(SUPERBLOCK, n4 - r0)
        words4[r0 : r0 + rows] = torch.randint(
            -(1 << 31), 1 << 31, (rows, w4), dtype=torch.int32, device=dev,
            generator=gen).cpu().numpy().view(np.uint32)
    bm4 = st.BitMatrix.from_packed(words4, CFG4_M)
    make4 = time.perf_counter() - t0
    mean, sd = CFG4_M / 4, (CFG4_M * 3 / 16) ** 0.5
    bw4 = int(np.ceil((mean + CFG4_TAIL_SD * sd) / (CFG4_BINS - 1)))
    t4 = bw4 * (CFG4_BINS - 1)
    pairs4 = n4 * (n4 - 1) // 2
    print(f"[config 4 query] {n4} x {CFG4_M} bits of uniform words, made on the card and "
          f"downloaded to a {words4.nbytes / 2**30:.2f} GiB host BitMatrix in {make4:.2f} s; "
          f"{pairs4} pairs; bins of width {bw4}, the last from {t4} = mean + "
          f"{(t4 - mean) / sd:.2f} sd")
    sb = SUPERBLOCK
    n_super = round_up(n4, sb) // sb
    tps = sb // cfg.k2_tile_rows
    hist_tiles = n_super * tps * (tps + 1) // 2 + (n_super * (n_super - 1) // 2) * tps * tps
    hist_bound = 2.0 * hist_tiles * cfg.k2_tile_rows ** 2 * CFG4_M / k2_ops_per_s
    ti4, wk4 = mxu.k2_tile_shape(cfg, n4, w4)
    nb4 = round_up(n4, ti4) // ti4
    tiles4 = nb4 * (nb4 + 1) // 2
    chunks4 = -(-tiles4 // query._tile_chunk(ti4))
    tri_bound4 = 2.0 * tiles4 * ti4 * ti4 * round_up(w4, wk4) * 32 / k2_ops_per_s
    man, wall_h, rec, launched = run(
        "config 4 count_histogram",
        lambda: st.count_histogram(bm4, n_bins=CFG4_BINS, bin_width=bw4, device=dev),
        want=("k2_hist",), absent=("k2_tri",), again=True)
    hist4 = man["hist"]
    if int(hist4.sum()) != pairs4:
        raise AssertionError("config 4 count_histogram: mass is not n(n-1)/2")
    print(f"[config 4 query] count_histogram: route {man['kernel']} (operand on the card), "
          f"launches {launched}, mass {pairs4}; last bin {int(hist4[-1])} pairs; warm wall "
          f"{wall_h:.3f} s (the first call, printed above, uploads the operand)")
    stages("config 4 count_histogram", rec, wall_h, n_super * (n_super + 1) // 2, hist_bound)
    got, wall_s, rec, launched = run("config 4 pairs_above",
                                     lambda: st.pairs_above(bm4, t4, device=dev),
                                     want=("k2_tri",), again=True)
    if got[0].size != int(hist4[-1]):
        raise AssertionError(f"config 4 pairs_above: {got[0].size} hits, the histogram's last "
                             f"bin holds {int(hist4[-1])}")
    if got[0].size:
        want4 = np.bitwise_count(words4[got[0]] & words4[got[1]]).sum(axis=1, dtype=np.int64)
        if not (np.array_equal(got[2], want4) and (got[0] < got[1]).all()):
            raise AssertionError("config 4 pairs_above: a hit's count differs from numpy")
    print(f"[config 4 query] pairs_above(count >= {t4}): {got[0].size} hits = the histogram's "
          f"last bin over all {pairs4} pairs, every count equal to numpy's popcount; launches "
          f"{launched}; warm wall {wall_s:.3f} s")
    stages("config 4 pairs_above (tile screen)", rec, wall_s, chunks4, tri_bound4)
    (v4, i4), wall_t, rec, launched = run(
        "config 4 topk_neighbors", lambda: st.topk_neighbors(bm4, CFG4_TOPK_K, device=dev),
        want=("k2_topk",), absent=("k2_tri",), again=True)
    rows = np.sort(rng.choice(n4, CFG4_TOPK_ROWS, replace=False))
    buf = bm4.device_padded(n4, device=dev, reuse_larger=True)
    b_rows = round_up(n4, ti4)
    a_pad = torch.zeros((round_up(rows.size, ti4), buf.shape[1]), dtype=torch.int32, device=dev)
    a_pad[: rows.size] = buf[torch.from_numpy(rows).to(dev)]
    b_pad = buf[:b_rows] if buf.shape[0] >= b_rows else mxu._pad(buf, b_rows, buf.shape[1])
    # the reference: K2-rect on those rows, a launch outside the path's calls
    rect = mxu.count_block_pallas_mxu(a_pad, b_pad)[: rows.size, :n4].cpu().numpy()
    if not np.array_equal(v4[rows], topk_of(rect, CFG4_TOPK_K, rows)):
        raise AssertionError("config 4 topk_neighbors: sampled rows differ from count_block")
    valid_indices("config 4 topk_neighbors", rect, v4[rows], i4[rows], rows)
    print(f"[config 4 query] topk_neighbors(k={CFG4_TOPK_K}) {n4} rows: launches {launched}; "
          f"{rows.size} sampled rows equal the top {CFG4_TOPK_K} of their K2-rect counts "
          f"against all rows, indices valid; warm wall {wall_t:.3f} s")
    stages("config 4 topk_neighbors (tile walk)", rec, wall_t, chunks4, tri_bound4)
    del buf, a_pad, b_pad
    print(f"[query] phases 20-24 launches: {total}")
    streamed, kept["screen_launches"] = stream_query_phases(
        torch, dev, cfg, k2_ops_per_s,
        (run, stages, wall_of, same_pairs, topk_of, valid_indices, store_route),
        cfg4=(bm4, got, v4, rows, rect, t4), ld=(bm_ld, ld_ref, t_ld), cfg3_b=cfg3_b,
        complete=(bm_d, bm_m, complete_pairs))
    bm4.clear_device_cache()
    kept["cfg4"] = (bm4, hist4, bw4)
    del words4, rect, v4, i4, bm_d, bm_m
    if on_card:
        torch.cuda.empty_cache()
    return total, streamed, kept


def stream_query_phases(torch, dev, cfg, k2_ops_per_s, helpers, cfg4, ld, cfg3_b,
                        complete) -> dict:
    """Phases 25 to 28: the streamed queries (``stream_query``) on the
    matrices of phases 24, 21, 22 and 23, each result held to the resident
    query's result or to the reference matrix. ``helpers`` are phases
    20-24's (run, stages, wall_of, same_pairs, topk_of, valid_indices,
    store_route).
    Returns the launches of every kernel over these phases' calls, and the
    screen kernel's on its main path (phase 25's config-4 screen)."""
    import stormtpu_torch as st
    from stormtpu_torch import stream_query as sq
    from stormtpu_torch.kernels import launch_counts
    from stormtpu_torch.setops import derive_similarity
    from stormtpu_torch.utils import round_up

    run, stages, wall_of, same_pairs, topk_of, valid_indices, store_route = helpers
    total = dict.fromkeys(launch_counts(), 0)
    sb = SUPERBLOCK
    t_phases = time.perf_counter()

    def per_stripe(label: str, rec, wall: float, plain: float = 0.0) -> None:
        """Wall, and K2's and the reduction's CUDA-event ms a card stripe."""
        on = max(rec.launched, 1)
        kern, red = rec.device_ms.get("kernel", 0.0), rec.device_ms.get("reduce", 0.0)
        line = (f"[stream query] {label}: wall {wall:.4f} s recorded"
                + (f", {plain:.4f} s as a user runs it" if plain else "")
                + f"; {rec.stripes} stripes computed, {rec.launched} on the card, "
                f"{rec.stripes - rec.launched} by K4 on the host; K2 {kern / on:.3f} ms and "
                f"reduction {red / on:.3f} ms a card stripe (CUDA events)")
        print(line)

    def walk_bound(n: int, m: int, sb_: int) -> float:
        """K2's operation bound of a stripe walk over n rows of m bits."""
        n_super = round_up(n, sb_) // sb_
        tps = sb_ // cfg.k2_tile_rows
        tiles = n_super * tps * (tps + 1) // 2 + n_super * (n_super - 1) // 2 * tps * tps
        return 2.0 * tiles * cfg.k2_tile_rows ** 2 * m / k2_ops_per_s

    # ------------------------------------- 25 config 4: the streamed queries
    bm4, hits4, v4, rows4, rect4, t4 = cfg4
    n4, m4 = bm4.n, bm4.m_bits
    k = CFG4_TOPK_K
    stripes4 = (round_up(n4, sb) // sb) * (round_up(n4, sb) // sb + 1) // 2
    bound4 = walk_bound(n4, m4, sb)
    (vals, idx), wall, rec, launched = run(
        "config 4 stream_topk_neighbors",
        lambda: sq.stream_topk_neighbors(bm4, k, superblock_rows=sb, device=dev),
        want=("k2_topk",), absent=("k2_rect", "k4", "k2_tri"), again=True, into=total)
    if not np.array_equal(vals, v4):
        raise AssertionError("config 4 stream_topk_neighbors: values differ from phase 24's")
    valid_indices("config 4 stream_topk_neighbors", rect4, vals[rows4], idx[rows4], rows4)
    plain = wall_of(lambda: sq.stream_topk_neighbors(bm4, k, superblock_rows=sb, device=dev))
    print(f"[stream query] config 4 stream_topk_neighbors(k={k}) {n4} x {m4} bits at superblock "
          f"{sb} ({stripes4} stripes) through K2-topk, no dense stripe assembled: launches "
          f"{launched}; values equal phase 24's topk_neighbors on all rows, indices valid on "
          f"its {rows4.size} K2-rect rows")
    per_stripe("config 4 stream_topk_neighbors", rec, wall, plain)
    stages("config 4 stream_topk_neighbors (a chunk is a stripe)", rec, wall, rec.launched,
           bound4)
    (svals, sidx), wall_st, rec_st, launched_st = store_route(lambda: run(
        "config 4 stream_topk_neighbors store route",
        lambda: sq.stream_topk_neighbors(bm4, k, superblock_rows=sb, device=dev),
        want=("k2_tri",), absent=("k2_topk",), into={}))
    if not np.array_equal(svals, vals):
        raise AssertionError("config 4 stream_topk_neighbors: K2-topk's values differ from the "
                             "store route's")
    valid_indices("config 4 stream_topk_neighbors store route", rect4, svals[rows4],
                  sidx[rows4], rows4)
    walls = {"epilogue": [plain], "store": []}
    for _ in range(3):
        walls["store"].append(store_route(lambda: wall_of(
            lambda: sq.stream_topk_neighbors(bm4, k, superblock_rows=sb, device=dev))))
        if len(walls["epilogue"]) < 3:
            walls["epilogue"].append(wall_of(
                lambda: sq.stream_topk_neighbors(bm4, k, superblock_rows=sb, device=dev)))
    plain_st = float(np.median(walls["store"]))
    print(f"[stream query] config 4 stream_topk_neighbors store route (dense stripes, torch's "
          f"top-k): launches {launched_st}, values equal the K2-topk route's; as run, in turns: "
          f"store route {', '.join(f'{w:.4f}' for w in walls['store'])} s (median "
          f"{plain_st:.4f}), K2-topk {', '.join(f'{w:.4f}' for w in walls['epilogue'])} s "
          f"(median {np.median(walls['epilogue']):.4f})")
    per_stripe("config 4 stream_topk_neighbors, store route", rec_st, wall_st, plain_st)
    stages("config 4 stream_topk_neighbors, store route (a chunk is a stripe)", rec_st,
           wall_st, rec_st.launched, bound4)
    del svals, sidx
    got, wall, rec, launched = run(
        "config 4 stream_pairs_above",
        lambda: sq.stream_pairs_above(bm4, t4, superblock_rows=sb, device=dev),
        want=("k2_tri", "stripe_screen"), absent=("k0", "k4"), again=True, into=total)
    same_pairs("config 4 stream_pairs_above", got, hits4)
    # the screen kernel's main path: one launch a dense stripe, none again
    screen_launches = launched["stripe_screen"]
    if screen_launches != stripes4:
        raise AssertionError(f"config 4 stream_pairs_above: {screen_launches} stripe_screen "
                             f"launches, want one a stripe ({stripes4})")
    plain = wall_of(lambda: sq.stream_pairs_above(bm4, t4, superblock_rows=sb, device=dev))
    print(f"[stream query] config 4 stream_pairs_above(count >= {t4}): {got[0].size} hits, "
          f"equal to phase 24's pairs_above; launches {launched}")
    per_stripe("config 4 stream_pairs_above", rec, wall, plain)
    stages("config 4 stream_pairs_above (a chunk is a stripe)", rec, wall, rec.launched, bound4)
    (jv, ji), wall, rec, launched = run(
        "config 4 topk_neighbors jaccard",
        lambda: st.topk_neighbors(bm4, k, measure="jaccard", device=dev),
        want=("k2_tri",), into=total)
    if not rec.stripes:
        raise AssertionError("config 4 topk_neighbors(jaccard) did not take the streamed walk")
    nnz4 = bm4.row_nnz
    sim = derive_similarity(rect4, nnz4[rows4][:, None], nnz4[None, :], m4, "jaccard")
    sim[np.arange(rows4.size), rows4] = -np.inf
    want_j = -np.sort(-np.partition(sim, sim.shape[1] - k, axis=1)[:, -k:], axis=1)
    if not (np.array_equal(jv[rows4], want_j)
            and np.array_equal(sim[np.arange(rows4.size)[:, None], ji[rows4]], jv[rows4])):
        raise AssertionError("config 4 topk_neighbors(jaccard): sampled rows differ from the "
                             "float64 ranking of their K2-rect counts")
    print(f"[stream query] config 4 topk_neighbors(k={k}, measure='jaccard') {n4} rows (above "
          f"the host ceiling: the streamed walk): launches {launched}; {rows4.size} sampled rows "
          f"equal the float64 ranking of their K2-rect counts against all rows, indices "
          f"realize them")
    per_stripe("config 4 topk_neighbors jaccard", rec, wall)
    stages("config 4 topk_neighbors jaccard (a chunk is a stripe)", rec, wall, rec.launched,
           bound4)
    del sim, jv, ji, vals, idx

    # ------------------ 26 the LD panel: operand streaming, out_dir, resume, extend
    bm_ld, ld_ref, t_ld = ld
    n_ld = bm_ld.n
    wi, wj = np.nonzero(np.triu(ld_ref >= t_ld, 1))
    want_ld = (wi.astype(np.int32), wj.astype(np.int32), ld_ref[wi, wj])
    res, wall, rec, launched = run(
        "LD stream_pairs_above resident",
        lambda: sq.stream_pairs_above(bm_ld, t_ld, superblock_rows=sb, device=dev),
        want=("k2_tri", "stripe_screen"), into=total)
    same_pairs("LD stream_pairs_above resident", res, want_ld)
    per_stripe("LD stream_pairs_above, operand resident", rec, wall)
    (tv, ti_), _, _, _ = run(
        "LD stream_topk resident",
        lambda: sq.stream_topk_neighbors(bm_ld, k, superblock_rows=sb, device=dev),
        want=("k2_topk",), absent=("k2_tri",), into=total)
    for r0 in range(0, n_ld, 2048):
        r = np.arange(r0, min(r0 + 2048, n_ld))
        if not np.array_equal(tv[r], topk_of(ld_ref[r], k, r)):
            raise AssertionError(f"LD stream_topk_neighbors: rows {r0}.. differ from phase 8's")
        valid_indices("LD stream_topk_neighbors", ld_ref[r], tv[r], ti_[r], r)
    head = st.BitMatrix.from_packed(np.ascontiguousarray(bm_ld.packed[:EXTEND_OLD_N]),
                                    bm_ld.m_bits)
    os.environ["STORMTPU_DEVICE_OPERAND_BUDGET_BYTES"] = str(bm_ld.packed.nbytes // 4)
    try:
        walk = sq._resolve_stripe_config(bm_ld, sb, "auto", cfg, bitmap=True)
        if not sq._wants_operand_streaming(walk.n_pad, walk.w_pad, walk.sb, dev):
            raise AssertionError("LD panel: the lowered budget does not stream the operand")
        with tempfile.TemporaryDirectory() as scr, tempfile.TemporaryDirectory() as grown, \
                tempfile.TemporaryDirectory() as tk, tempfile.TemporaryDirectory() as tk_grown:
            got, wall, rec, launched = run(
                "LD stream_pairs_above streamed",
                lambda: sq.stream_pairs_above(bm_ld, t_ld, superblock_rows=sb, out_dir=scr,
                                              device=dev),
                want=("k2_tri", "stripe_screen"), into=total)
            same_pairs("LD stream_pairs_above streamed", got, want_ld)
            per_stripe("LD stream_pairs_above, two slices, out_dir", rec, wall)
            n_files = len([f for f in os.listdir(scr) if f.startswith("hits_")])
            for name in ("hits_00000_00000.npz", "hits_00003_00003.npz"):
                os.remove(os.path.join(scr, name))
            got, wall, rec, launched = run(
                "LD stream_pairs_above resumed",
                lambda: sq.stream_pairs_above(bm_ld, t_ld, superblock_rows=sb, out_dir=scr,
                                              device=dev),
                want=("k2_tri", "stripe_screen"), into=total)
            same_pairs("LD stream_pairs_above resumed", got, want_ld)
            if rec.launched != 2:
                raise AssertionError(f"LD resume computed {rec.launched} stripes, want 2")
            sq.stream_pairs_above(head, t_ld, superblock_rows=sb, out_dir=grown, device=dev)
            got, wall, rec, launched = run(
                "LD extend_stream_pairs_above",
                lambda: sq.extend_stream_pairs_above(bm_ld, grown, device=dev),
                want=("k2_tri", "stripe_screen"), into=total)
            same_pairs("LD extend_stream_pairs_above", got, want_ld)
            print(f"[stream query] LD panel {n_ld} x {bm_ld.m_bits} bits, count >= {t_ld}: "
                  f"{want_ld[0].size} pairs from the resident walk, the two-slice walk into "
                  f"{n_files} hit files, a resume after deleting two of them (2 stripes "
                  f"computed) and the extend of {EXTEND_OLD_N} -> {n_ld} rows ({rec.launched} "
                  f"computed), all equal to phase 8's matrix")
            per_stripe(f"LD extend_stream_pairs_above {EXTEND_OLD_N} -> {n_ld}", rec, wall)
            (sv, si), wall, rec, _ = run(
                "LD stream_topk streamed",
                lambda: sq.stream_topk_neighbors(bm_ld, k, superblock_rows=sb, out_dir=tk,
                                                 device=dev),
                want=("k2_topk",), absent=("k2_tri",), into=total)
            sq.stream_topk_neighbors(head, k, superblock_rows=sb, out_dir=tk_grown, device=dev)
            (ev, ei), wall_e, rec_e, _ = run(
                "LD extend_stream_topk_neighbors",
                lambda: sq.extend_stream_topk_neighbors(bm_ld, tk_grown, device=dev),
                want=("k2_topk",), absent=("k2_tri",), into=total)
            for label, v, i in (("streamed", sv, si), ("extended", ev, ei)):
                if not np.array_equal(v, tv):
                    raise AssertionError(f"LD stream_topk_neighbors {label}: values differ "
                                         "from the resident walk's")
                for r0 in range(0, n_ld, 2048):
                    r = np.arange(r0, min(r0 + 2048, n_ld))
                    valid_indices(f"LD stream_topk {label}", ld_ref[r], v[r], i[r], r)
            print(f"[stream query] LD panel stream_topk_neighbors(k={k}): resident, two-slice "
                  f"with a checkpoint, and extended {EXTEND_OLD_N} -> {n_ld} rows: values equal "
                  f"phase 8's top {k} on every row, indices valid")
            per_stripe("LD stream_topk_neighbors, two slices, checkpoint", rec, wall)
            per_stripe(f"LD extend_stream_topk_neighbors {EXTEND_OLD_N} -> {n_ld}", rec_e,
                       wall_e)
    finally:
        del os.environ["STORMTPU_DEVICE_OPERAND_BUDGET_BYTES"]
    del tv, ti_, sv, si, ev, ei

    # ---------------------------------- 27 config 3 B: the sparse route against K2
    bm_b, ref_b = cfg3_b
    results = {}
    for kern in ("auto", "mxu"):
        (bv, bi), wall_t, rec_t, _ = run(
            f"config 3 B stream_topk {kern}",
            lambda: sq.stream_topk_neighbors(bm_b, k, superblock_rows=sb, kernel=kern,
                                             device=dev), into=total)
        scr, wall_s, rec_s, _ = run(
            f"config 3 B stream_pairs_above {kern}",
            lambda: sq.stream_pairs_above(bm_b, 1, superblock_rows=sb, kernel=kern, device=dev),
            into=total)
        r2s, _, _, _ = run(
            f"config 3 B stream_pairs_above r2 {kern}",
            lambda: sq.stream_pairs_above(bm_b, CFG3_R2, measure="r2", superblock_rows=sb,
                                          kernel=kern, device=dev),
            into=total)
        results[kern] = (bv, bi, scr, r2s, rec_t, rec_s)
        per_stripe(f"config 3 B stream_topk_neighbors(k={k}), kernel={kern!r}", rec_t, wall_t)
        per_stripe(f"config 3 B stream_pairs_above(count >= 1), kernel={kern!r}", rec_s, wall_s)
    auto, mxu_ = results["auto"], results["mxu"]
    if auto[4].launched == auto[4].stripes or mxu_[4].launched != mxu_[4].stripes:
        raise AssertionError("config 3 B: auto took no K4 stripe, or mxu took one")
    if not np.array_equal(auto[0], mxu_[0]):
        raise AssertionError("config 3 B: stream_topk_neighbors auto differs from mxu")
    for r0 in range(0, bm_b.n, 2500):
        r = np.arange(r0, min(r0 + 2500, bm_b.n))
        if not np.array_equal(auto[0][r], topk_of(ref_b[r], k, r)):
            raise AssertionError("config 3 B: stream_topk_neighbors differs from phase 17's")
        for v, i in ((auto[0], auto[1]), (mxu_[0], mxu_[1])):
            nz = v[r] > 0
            if not (np.array_equal(ref_b[r][np.nonzero(nz)[0], i[r][nz]], v[r][nz])):
                raise AssertionError("config 3 B: a top-k index does not realize its count")
    wi, wj = np.nonzero(np.triu(ref_b >= 1, 1))
    for kern in ("auto", "mxu"):
        same_pairs(f"config 3 B stream_pairs_above {kern}", results[kern][2],
                   (wi.astype(np.int32), wj.astype(np.int32), ref_b[wi, wj]))
    same_pairs("config 3 B r2 screen auto vs mxu", auto[3], mxu_[3])
    print(f"[stream query] config 3 B {bm_b.n} x {bm_b.m_bits} bits (density "
          f"{bm_b.density:.3g}): kernel='auto' took K4 on {auto[4].stripes - auto[4].launched} "
          f"of {auto[4].stripes} top-k stripes and {auto[5].stripes - auto[5].launched} of "
          f"{auto[5].stripes} screen stripes, kernel='mxu' K2 on {mxu_[4].launched} and "
          f"{mxu_[5].launched}; top-k values equal each other and phase 17's matrix, the count "
          f"screen's {wi.size} pairs equal phase 17's matrix on both routes, the r2 >= "
          f"{CFG3_R2} screen's {auto[3][0].size} pairs equal across routes")
    del results, auto, mxu_, wi, wj

    # ------------------------------ 28 the pairwise-complete streamed screen
    bm_d, bm_m, want_c = complete
    got, wall, rec, launched = run(
        "stream_pairs_above_complete",
        lambda: sq.stream_pairs_above_complete(bm_d, bm_m, COMPLETE_R2,
                                               superblock_rows=COMPLETE_SB, device=dev),
        want=("k2_tri",), absent=("k2_rect",), into=total)
    same_pairs("stream_pairs_above_complete", got, want_c)
    print(f"[stream query] stream_pairs_above_complete(r2 >= {COMPLETE_R2}) {bm_d.n} x "
          f"{bm_d.m_bits} bits, {COMPLETE_MISSING:.0%} missing, superblock {COMPLETE_SB}: "
          f"{got[0].size} pairs equal to phase 23's pairs_above_complete; launches {launched}")
    per_stripe("stream_pairs_above_complete (four grids a stripe)", rec, wall)
    print(f"[stream query] phases 25-28 launches: {total}; the phases took "
          f"{time.perf_counter() - t_phases:.1f} s")
    return total, screen_launches


def tuning_phase(torch, dev, seed, k2_ops_per_s) -> tuple[dict, dict]:
    """Phase 29: the tuner over ``DEFAULT_GRID`` into a temporary cache
    (``$STORMTPU_TORCH_TUNING_CACHE``, left set for phases 30 and 31), D1
    and ``auto`` held to its table, K2-rect timed against the plain int8
    product and the crossover held to ``kernels.MXU_XLA_MAX_BITS``, the
    table written to ``chiprun_out/tuning_snapshot.json``. Returns the
    tuner's launches and the crossover."""
    import stormtpu_torch as st
    from stormtpu_torch import tuning
    from stormtpu_torch.dispatch import choose_strategy
    from stormtpu_torch.kernels import (MXU_XLA_MAX_BITS, STATIC_MXU_XLA_MAX_BITS,
                                        launch_counts, mxu, reset_launches, xla)

    cache = os.path.join(tempfile.mkdtemp(prefix="stpu_tune_"), "tuning.json")
    os.environ[tuning.CACHE_ENV] = cache
    reset_launches()
    t0 = time.perf_counter()
    result = tuning.tune(log=print, device=dev, peak_ops_per_s=k2_ops_per_s,
                         slow_path_budget_s=TUNE_SLOW_PATH_S)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    print(f"[tune] {len(result['buckets'])} buckets and the K4 refit in {wall:.2f} s; "
          f"launches {launches}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kernel_of = {"pallas_mxu": "k2_tri", "pallas_dense": "k1"}
    for n, m in tuning.DEFAULT_GRID:
        b = result["buckets"][f"{n}x{m}"]
        rates = b["dense_pairs_per_s"]
        fastest = max(rates, key=rates.get)
        winner = tuning.measured_dense_winner(n, m, dev)
        want = "pallas_mxu" if winner == "mxu" and m > MXU_XLA_MAX_BITS else winner
        static = "mxu" if m <= STATIC_MXU_XLA_MAX_BITS else "pallas_mxu"
        chosen = choose_strategy(n, m, 0.5, device=dev)
        if chosen != want:
            raise AssertionError(f"D1 chose {chosen!r} at {n} x {m}; the table says {want!r}")
        words = torch.randint(-(1 << 31), 1 << 31, (n, m // 32), dtype=torch.int32, device=dev,
                              generator=gen).cpu().numpy().view(np.uint32)
        bm = st.BitMatrix.from_packed(words, m)
        reset_launches()
        t0 = time.perf_counter()
        out = st.intersect_count_matrix(bm, strategy="auto", device=dev)
        wall_b = time.perf_counter() - t0
        counts = launch_counts()
        kernel = kernel_of.get(want)
        if (counts[kernel] < 1) if kernel else (counts["k2_tri"] or counts["k1"]):
            raise AssertionError(f"auto at {n} x {m} launched {counts}; the table says {want}")
        i = np.random.default_rng(seed + n).integers(0, n, N_SAMPLES)
        j = np.random.default_rng(seed + m).integers(0, n, N_SAMPLES)
        if not np.array_equal(out[i, j], sampled_counts(words, words, i, j)):
            raise AssertionError(f"auto at {n} x {m}: sampled pairs differ from numpy")
        print(f"[tune] {n} x {m} bits: " + ", ".join(
            f"{k} {v:.4g}" for k, v in sorted(rates.items(), key=lambda kv: -kv[1]))
            + f" pairs/s; fastest {fastest}, winner {winner} (K2 unless another is over "
            f"{tuning.K2_MARGIN}x faster), D1 {chosen} (the static rule said {static}); "
            f"latency_bound {b['latency_bound']}, skipped {b['skipped']}; auto launched "
            f"{ {k: v for k, v in counts.items() if v} }, {N_SAMPLES} sampled pairs exact, "
            f"wall {wall_b:.3f} s")
        del out, bm, words
    # the block kernels' crossover: K2-rect against the plain int8 product
    a = torch.randint(-(1 << 31), 1 << 31, (CROSS_ROWS, CROSS_BITS[-1] // 32),
                      dtype=torch.int32, device=dev, generator=gen)
    rows = []
    for m in CROSS_BITS:
        x = a[:, : m // 32].contiguous()
        exact_diff(torch, mxu.count_block_pallas_mxu(x, x), xla.count_block_int8_xla(x, x))
        k2_ms = cuda_ms(torch, lambda: mxu.count_block_pallas_mxu(x, x), reps=10)
        plain_ms = cuda_ms(torch, lambda: xla.count_block_int8_xla(x, x), reps=5)
        rows.append({"m_bits": m, "k2_rect_ms": k2_ms, "plain_ms": plain_ms})
        print(f"[tune] crossover {CROSS_ROWS} x {CROSS_ROWS} rows at {m} bits: K2-rect "
              f"{k2_ms:.4f} ms, count_block_int8_xla {plain_ms:.4f} ms (exact, equal)")
    del a, x
    torch.cuda.empty_cache()
    crossover = max((r["m_bits"] for r in rows if r["plain_ms"] < r["k2_rect_ms"]), default=0)
    print(f"[tune] the plain int8 product wins up to {crossover} bits (0: at no M measured); "
          f"kernels.MXU_XLA_MAX_BITS = {MXU_XLA_MAX_BITS}")
    if crossover != MXU_XLA_MAX_BITS:
        raise AssertionError(f"the measured crossover ({crossover} bits) is not "
                             f"kernels.MXU_XLA_MAX_BITS ({MXU_XLA_MAX_BITS})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    snapshot = {**result, "nvidia_smi": smi.strip().splitlines()[0], "tune_seconds": wall,
                "plain_product_crossover": {"rows": CROSS_ROWS, "m_bits": crossover,
                                            "times": rows}}
    # the table goes beside the run's other outputs, never into the package
    # this run measures; copying it over stormtpu_torch/data/ is a separate step
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    snap = os.path.join(out_dir, "tuning_snapshot.json")
    with open(snap, "w") as f:
        json.dump(snapshot, f, indent=2)
    print(f"[tune] wrote {snap} (device {result['device']!r})")
    return launches, {"m_bits": crossover, "times": rows}


def write_bed(stem: str, codes: np.ndarray) -> str:
    """A PLINK1 trio ``stem.{bed,bim,fam}`` of 2-bit codes uint8 [V, N]
    (SNP-major, sample j at bits 2(j % 4) of byte j // 4)."""
    v, n = codes.shape
    c = np.pad(codes, ((0, 0), (0, -n % 4)))
    body = c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    with open(stem + ".bed", "wb") as f:
        f.write(b"\x6c\x1b\x01" + body.astype(np.uint8).tobytes())
    with open(stem + ".fam", "w") as f:
        f.write("".join(f"F{i} I{i} 0 0 0 -9\n" for i in range(n)))
    with open(stem + ".bim", "w") as f:
        f.write("".join(f"1 rs{i} 0 {i} A C\n" for i in range(v)))
    return stem + ".bed"


def plink_codes(rng, n_variants: int, n_samples: int, groups: int) -> np.ndarray:
    """Genotype codes of a panel in LD blocks: variant block b is private to
    sample group b (a population), and its variants copy one of
    ``PLINK_FOUNDERS`` founder carrier sets with a few flips; carriers are
    heterozygous or homozygous, a few calls missing."""
    codes = np.zeros((n_variants, n_samples), dtype=np.uint8)
    vc = np.linspace(0, n_variants, groups + 1).astype(int)
    sc = np.linspace(0, n_samples, groups + 1).astype(int)
    for b in range(groups):
        nv, ns = vc[b + 1] - vc[b], sc[b + 1] - sc[b]
        base = rng.random((PLINK_FOUNDERS, ns)) < PLINK_FREQ
        carrier = base[np.arange(nv) % PLINK_FOUNDERS] ^ (rng.random((nv, ns)) < PLINK_FLIP)
        hom = rng.random((nv, ns)) < 0.3
        codes[vc[b] : vc[b + 1], sc[b] : sc[b + 1]] = np.where(carrier, np.where(hom, 3, 2), 0)
    codes[rng.random(codes.shape) < PLINK_MISSING] = 1
    return codes


def cli_phase(torch, dev, seed) -> None:
    """Phase 30: ``python -m stormtpu_torch`` as subprocesses on a PLINK trio
    and an ``io.save_bitmatrix`` copy of its samples orientation, each
    output equal to the same call made in this process."""
    import shutil

    import stormtpu_torch as st
    from stormtpu_torch import tuning
    from stormtpu_torch.io import load_plink_bed, save_bitmatrix
    from stormtpu_torch.kernels import launch_counts, reset_launches
    from stormtpu_torch.stats import count_histogram, count_row_sums
    from stormtpu_torch.stream import load_streamed_matrix

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="stpu_cli_")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    codes = plink_codes(rng, PLINK_VARIANTS, PLINK_SAMPLES, PLINK_GROUPS)
    bed = write_bed(os.path.join(tmp, "panel"), codes)
    old_bed = write_bed(os.path.join(tmp, "head"), codes[:PLINK_OLD_VARIANTS])
    del codes
    bm = load_plink_bed(bed)
    bm_s = load_plink_bed(bed, rows="samples")
    npz = os.path.join(tmp, "samples.npz")
    save_bitmatrix(bm_s, npz)
    print(f"[cli] PLINK trio {PLINK_VARIANTS} variants x {PLINK_SAMPLES} samples in "
          f"{PLINK_GROUPS} LD blocks (density {bm.density:.4f}), its samples orientation "
          f"{bm_s.n} x {bm_s.m_bits} bits as .npz; written in {time.perf_counter() - t0:.2f} s")
    tune_cache = os.path.join(tmp, "tuning.json")
    shutil.copyfile(os.environ[tuning.CACHE_ENV], tune_cache)
    out = {k: os.path.join(tmp, k) for k in ("count_bed.npy", "count_npz.npy", "topk.npz",
                                            "screen.npz", "clump.npz", "hist.npz")}
    sdir = os.path.join(tmp, "stripes")
    commands = {
        "info": ["info"],
        "count .bed": ["count", "--in", bed, "--out", out["count_bed.npy"]],
        "count .npz": ["count", "--in", npz, "--out", out["count_npz.npy"]],
        "topk": ["topk", "--in", bed, "--out", out["topk.npz"], "--k", "8"],
        "screen": ["screen", "--in", bed, "--out", out["screen.npz"], "--measure", "r2",
                   "--threshold", "0.5"],
        "clump": ["clump", "--in", bed, "--out", out["clump.npz"], "--threshold", "0.5"],
        "hist": ["hist", "--in", npz, "--out", out["hist.npz"], "--row-sums"],
        "stream": ["stream", "--in", old_bed, "--out-dir", sdir, "--superblock",
                   str(SUPERBLOCK)],
        "tune": ["tune", "--n", "4096", "--m", "65536"],
        "scaling": ["scaling"],
    }

    def start(args, **env):
        return subprocess.Popen([sys.executable, "-m", "stormtpu_torch", "--device", dev.type,
                                 *args], cwd=root,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env={**os.environ, **env})

    t0 = time.perf_counter()
    procs = {name: start(args, **({tuning.CACHE_ENV: tune_cache} if name == "tune" else {}))
             for name, args in commands.items()}
    done = {}

    def wait(name):
        stdout, stderr = procs[name].communicate(timeout=CLI_TIMEOUT_S)
        done[name] = (procs[name].returncode, stdout, stderr, time.perf_counter() - t0)

    try:
        wait("stream")  # the extend needs the directory it writes
        procs["stream --extend"] = start(["stream", "--in", bed, "--out-dir", sdir,
                                          "--extend"])
        for name in list(procs):
            if name not in done:
                wait(name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, (rc, stdout, stderr, at) in done.items():
        if rc != 0:
            raise AssertionError(f"python -m stormtpu_torch {name}: exit {rc}\n{stderr[-3000:]}")
        print(f"[cli] python -m stormtpu_torch {' '.join(commands.get(name, [name]))[:60]}: "
              f"exit {rc}, done {at:.1f} s after the start")
    info = done["info"][1]
    if torch.cuda.get_device_name(0) not in info or "does not match" in info:
        raise AssertionError(f"info: {info}")
    scal = json.loads(done["scaling"][1])
    if (scal["platform"] != "gpu" or list(scal["results"]) != ["1"]
            or "not a scaling figure" not in scal["note"]):
        raise AssertionError(f"scaling: {done['scaling'][1]}")
    print(f"[cli] scaling over one rank: {scal['results']['1']['seconds'] * 1e3:.2f} ms a ring "
          f"of {scal['n']} x {scal['m_bits']} bits; {scal['note']}")

    def same(label, got, want):
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            raise AssertionError(f"[cli] {label} differs from the call made in this process")

    reset_launches()
    c_bed = st.intersect_count_matrix(bm, device=dev)
    same("count .bed", np.load(out["count_bed.npy"]), c_bed)
    i = rng.integers(0, bm.n, N_SAMPLES)
    j = rng.integers(0, bm.n, N_SAMPLES)
    same("count .bed against numpy", c_bed[i, j], sampled_counts(bm.packed, bm.packed, i, j))
    c_npz = st.intersect_count_matrix(bm_s, device=dev)
    same("count .npz", np.load(out["count_npz.npy"]), c_npz)
    same("count .npz against numpy", c_npz[i % bm_s.n, j % bm_s.n], sampled_counts(
        bm_s.packed, bm_s.packed, i % bm_s.n, j % bm_s.n))
    vals, idx = st.topk_neighbors(bm, 8, device=dev)
    with np.load(out["topk.npz"]) as z:
        same("topk counts", z["counts"], vals)
        same("topk indices", z["indices"], idx)
    ii, jj, vv = st.pairs_above(bm, 0.5, measure="r2", device=dev)
    with np.load(out["screen.npz"]) as z:
        for key, want in (("ii", ii), ("jj", jj), ("values", vv)):
            same(f"screen {key}", z[key], want)
    res = st.clump(bm, bm.row_nnz.astype(np.float64), 0.5, measure="r2", device=dev)
    with np.load(out["clump.npz"]) as z:
        same("clump leader", z["leader"], res.leader)
        same("clump leaders", z["leaders"], res.leaders)
    man = count_histogram(bm_s, n_bins=64, device=dev)
    sums = count_row_sums(bm_s, include_self=False, device=dev)
    with np.load(out["hist.npz"]) as z:
        same("hist", z["hist"], man["hist"])
        same("hist row sums", z["row_sums"], sums)
    same("hist row sums against the count matrix", sums,
         c_npz.astype(np.int64).sum(axis=1) - np.diagonal(c_npz))
    same("stream --extend", load_streamed_matrix(sdir), c_bed)
    counts = launch_counts()
    with open(tune_cache) as f:
        t = json.load(f)
    if len(t["buckets"]) != len(tuning.DEFAULT_GRID) or t["shape"] != {"n": 4096,
                                                                      "m_bits": 65536}:
        raise AssertionError(f"tune --n 4096 --m 65536 did not merge into the grid: {t.keys()}")
    print(f"[cli] every output equals the call made in this process (count .bed also numpy "
          f"on {N_SAMPLES} pairs); {ii.size} r2 pairs >= 0.5, {res.n_clumps} clumps, the .npz "
          f"route {man['kernel']}; the in-process calls launched "
          f"{ {k: v for k, v in counts.items() if v} }; tune merged one bucket into the "
          f"{len(t['buckets'])}-bucket table")
    shutil.rmtree(tmp, ignore_errors=True)


def acceptance_phase(torch, dev) -> dict:
    """Phase 31: ``run_acceptance([1, 2, 3, 4])`` on the card into a
    temporary file. Returns its launches."""
    from stormtpu_torch import acceptance
    from stormtpu_torch.kernels import launch_counts, reset_launches

    out = os.path.join(tempfile.mkdtemp(prefix="stpu_accept_"), "acceptance.json")
    acceptance.CONFIG4_ROW_SUM_ROWS = ACCEPT_ROW_SUM_ROWS
    reset_launches()
    t0 = time.perf_counter()
    entries = acceptance.run_acceptance([1, 2, 3, 4], log=print, out_path=out, device=dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    want = {1: ("exact",), 2: ("exact",), 3: ("exact_sampled", "full"),
            4: ("exact_sampled", "spec_rate_pairs_per_s", "full_stream", "aggregate_stats")}
    for e in entries:
        missing = [k for k in want[e["config"]] if not e.get(k)]
        if missing:
            raise AssertionError(f"acceptance config {e['config']} lacks {missing}")
        rate = e.get("pairs_per_s") or e.get("sustained_pairs_per_s")
        print(f"[accept] config {e['config']}: wall {e['wall_seconds']:.2f} s, timed part "
              f"{e.get('seconds', float('nan')):.4f} s" + (f", {rate:.4g} pairs/s" if rate else "")
              + f"; {e['device']}, {e['power_limit']}")
    c3, c4 = entries[2]["full"], entries[3]
    print(f"[accept] config 3 full 10,000 rows: {c3['seconds']:.4f} s = "
          f"{c3['pairs_per_s']:.4g} pairs/s; config 4: K2 at 100k x 1M "
          f"{c4['spec_rate_pairs_per_s']:.4g} pairs/s ({c4['spec_wgmma_b1_frac']:.1%} of the b1 "
          f"wgmma rate), full checksum walk {c4['full_stream']['seconds']:.2f} s, histogram "
          f"{c4['aggregate_stats']['hist_seconds']:.2f} s, row sums of "
          f"{c4['aggregate_stats']['row_sums_rows']} rows "
          f"{c4['aggregate_stats']['row_sums_seconds']:.2f} s; all four in {wall:.1f} s; "
          f"launches {launches}")
    return launches


def parallel_phase(torch, dev, cfg, seed, k2_ops_per_s, main, ld, kept) -> tuple:
    """Phase 32: ``stormtpu_torch.parallel`` over a one-rank NCCL group in
    this process, each call held to the single-device result of an earlier
    phase. Returns the launches of the phase's calls (reset before each,
    read after) and the one-rank ring's timings for phase 33."""
    import stormtpu_torch as st
    from stormtpu_torch import acceptance, parallel as par
    from stormtpu_torch.kernels import count_block_auto, launch_counts, mxu, reset_launches
    from stormtpu_torch.parallel.allpairs import ring_count_rows
    from stormtpu_torch.parallel.mesh import local_shard
    from stormtpu_torch.stream import stripe_path

    total = dict.fromkeys(("k2_tri", "k2_rect", "k5", "k1", "k0"), 0)

    def run(label, fn, want=(), absent=()):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        if any(got[k] < 1 for k in want) or any(got[k] for k in absent):
            raise AssertionError(f"{label}: launches {got}, want {want} and none of {absent}")
        for k in total:
            total[k] += got[k]
        return out, wall, {k: v for k, v in got.items() if v}

    mesh = par.make_row_mesh(device=dev)
    if mesh.backend != ("nccl" if dev.type == "cuda" else "gloo") or mesh.size != 1:
        raise AssertionError(f"want a one-rank NCCL group, got {mesh.backend} x {mesh.size}")
    print(f"[parallel] one-rank {mesh.backend} group on {mesh.device}")

    # rows axis at config 5's width, its rows cut to one card
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 32)
    xd = torch.randint(-(1 << 31), 1 << 31, (PAR_N, PAR_M // 32), dtype=torch.int32, device=dev,
                       generator=gen)
    words = xd.cpu().numpy().view(np.uint32)
    del xd
    bm = st.BitMatrix.from_packed(words, PAR_M)
    t0 = time.perf_counter()
    want = st.intersect_count_matrix(bm, device=dev)  # the reference, not counted
    wall_1 = time.perf_counter() - t0
    got, wall, launched = run("distributed_count_matrix rows", lambda: par.distributed_count_matrix(
        words, mesh=mesh), want=("k2_rect",))
    if not np.array_equal(got, want):
        raise AssertionError("distributed_count_matrix (rows) differs from intersect_count_matrix")
    print(f"[parallel] distributed_count_matrix rows {PAR_N} x {PAR_M} bits: equal to "
          f"intersect_count_matrix ({wall_1:.3f} s); wall {wall:.3f} s; launches {launched}")
    # the ring alone on a shard already on the card, by CUDA events: its
    # block kernel against the bound of the rectangle it computes
    x_local = local_shard(words, (0, PAR_N), (0, PAR_M // 32), dev)
    ring = ring_count_rows(mesh, "rows", PAR_N, count_block_auto)
    ring_ms = cuda_ms(torch, lambda: ring(x_local), reps=3)
    rect_bound = bound(2.0 * PAR_N * PAR_N * PAR_M, 4.0 * (2 * PAR_N * PAR_M // 32 + PAR_N ** 2),
                       k2_ops_per_s)
    print(f"[parallel] one-rank ring {PAR_N} x {PAR_M} bits: {ring_ms:.2f} ms a call (one step, "
          f"no collective); the K2 rectangle's bound {rect_bound[0]:.2f} ms ({rect_bound[1]})")
    del got, want, x_local, bm, words
    torch.cuda.empty_cache()

    # bits axis on phase 8's LD panel: K5's sharded work list, and K2-tri
    bm_ld, ld_ref = ld
    got, wall, launched = run("distributed_count_matrix bits (K5)", lambda:
                              par.distributed_count_matrix(bm_ld.packed, mesh=mesh,
                                                           shard_axis="bits"),
                              want=("k5",), absent=("k2_tri",))
    if not np.array_equal(got, ld_ref):
        raise AssertionError("distributed_count_matrix bits (K5) differs from phase 8's matrix")
    print(f"[parallel] distributed_count_matrix bits on the LD panel: the sharded K5 form, "
          f"equal to phase 8's matrix; wall {wall:.3f} s; launches {launched}")
    no_k5 = dataclasses.replace(cfg, clustered_work_fraction_threshold=0.0)
    got, wall, launched = run("distributed_count_matrix bits (K2-tri)", lambda:
                              par.distributed_count_matrix(bm_ld.packed, mesh=mesh, config=no_k5,
                                                           shard_axis="bits"),
                              want=("k2_tri",), absent=("k5",))
    if not np.array_equal(got, ld_ref):
        raise AssertionError("distributed_count_matrix bits (K2-tri) differs from phase 8's")
    print(f"[parallel] distributed_count_matrix bits on the LD panel with the K5 test off: "
          f"K2-tri and the sum, equal to phase 8's matrix; wall {wall:.3f} s; launches {launched}")
    del got
    torch.cuda.empty_cache()

    # the stripe histogram on phase 24's config-4 matrix
    bm4, hist4, bw4 = kept["cfg4"]
    man, wall, launched = run("distributed_count_histogram stripes", lambda:
                              par.distributed_count_histogram(
                                  bm4, n_bins=CFG4_BINS, bin_width=bw4, mesh=mesh,
                                  method="stripes", superblock_rows=SUPERBLOCK),
                              want=("k2_rect",))
    if not np.array_equal(man["hist"], hist4):
        raise AssertionError("distributed_count_histogram differs from phase 24's histogram")
    pairs4 = bm4.n * (bm4.n - 1) // 2
    print(f"[parallel] distributed_count_histogram(method='stripes') {bm4.n} x {bm4.m_bits} bits "
          f"({man['n_super'] * (man['n_super'] + 1) // 2} stripes of {man['superblock_rows']}): "
          f"equal to phase 24's count_histogram; wall {wall:.3f} s = "
          f"{pairs4 / wall / 1e9:.3f} G-pairs/s; launches {launched}")
    del kept["cfg4"], bm4, man
    torch.cuda.empty_cache()

    # the ring queries at the main path's shape, held to phase 20's
    bm_main, _ = main
    (vals, idx), wall, launched = run("distributed_topk_neighbors", lambda:
                                      par.distributed_topk_neighbors(bm_main, TOPK_K, mesh=mesh),
                                      want=("k2_rect",))
    if not np.array_equal(vals, kept["topk20"]):
        raise AssertionError("distributed_topk_neighbors differs from phase 20's top-k values")
    rows = np.repeat(np.arange(bm_main.n), TOPK_K)
    chk = np.random.default_rng(seed).choice(rows.size, min(rows.size, 1 << 16), replace=False)
    if not np.array_equal(sampled_counts(bm_main.packed, bm_main.packed, rows[chk],
                                         idx.ravel()[chk]), vals.ravel()[chk]):
        raise AssertionError("distributed_topk_neighbors: an index does not realize its count")
    print(f"[parallel] distributed_topk_neighbors(k={TOPK_K}) {bm_main.n} x {bm_main.m_bits}: "
          f"values equal phase 20's, {chk.size} sampled indices realize their counts; wall "
          f"{wall:.3f} s; launches {launched}")
    t20, screen20 = kept["screen20"]
    got, wall, launched = run("distributed_pairs_above", lambda: par.distributed_pairs_above(
        bm_main, t20, mesh=mesh), want=("k2_rect",))
    if not all(np.array_equal(a, b) for a, b in zip(got, screen20)):
        raise AssertionError("distributed_pairs_above differs from phase 20's pairs_above")
    print(f"[parallel] distributed_pairs_above(count >= {t20}): {got[0].size} pairs equal to "
          f"phase 20's; wall {wall:.3f} s; launches {launched}")

    # the streaming walk at config 5's width: each stripe against
    # count_block of its two superblocks
    gen.manual_seed(seed + 320)
    xd = torch.randint(-(1 << 31), 1 << 31, (PAR_STREAM_N, PAR_M // 32), dtype=torch.int32,
                       device=dev, generator=gen)
    bms = st.BitMatrix.from_packed(xd.cpu().numpy().view(np.uint32), PAR_M)
    out_dir = tempfile.mkdtemp(prefix="stpu_dstream_")
    try:
        man, wall, launched = run("distributed_stream_count_matrix", lambda:
                                  par.distributed_stream_count_matrix(
                                      bms, out_dir, superblock_rows=PAR_SB, mesh=mesh,
                                      compress=False), want=("k2_rect",))
        n_super = PAR_STREAM_N // PAR_SB
        if man["kernel"] != "distributed" or len(man["completed"]) != n_super * (n_super + 1) // 2:
            raise AssertionError(f"distributed_stream_count_matrix: {man['completed']}")
        for i, j in man["completed"]:
            with np.load(stripe_path(out_dir, i, j)) as z:
                stripe = z["counts"]
            ref = mxu.count_block_pallas_mxu(xd[i * PAR_SB : (i + 1) * PAR_SB],
                                             xd[j * PAR_SB : (j + 1) * PAR_SB])
            if not np.array_equal(stripe, ref.cpu().numpy()):
                raise AssertionError(f"stripe ({i}, {j}) differs from count_block")
        stripes = len(man["completed"])
        print(f"[parallel] distributed_stream_count_matrix {PAR_STREAM_N} x {PAR_M} bits at "
              f"superblock {PAR_SB}: {stripes} stripes, each equal to count_block of its two "
              f"superblocks; wall {wall:.3f} s ({wall / stripes:.3f} s a stripe, uncompressed "
              f"files); launches {launched}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del xd, bms
    torch.cuda.empty_cache()

    # acceptance config 5 at the JAX package's scaled size
    out = os.path.join(tempfile.mkdtemp(prefix="stpu_accept5_"), "acceptance.json")
    (entry,), wall, launched = run("acceptance config 5", lambda: acceptance.run_acceptance(
        [5], log=print, out_path=out, device=dev), want=("k2_rect",))
    if not entry["exact_sampled"] or entry["devices"] != 1:
        raise AssertionError(f"acceptance config 5: {entry}")
    print(f"[parallel] acceptance config 5 ({entry['n']} x 65536 bits, one rank): sampled-exact, "
          f"{entry['pairs_per_s']:.4g} pairs/s one call, {entry['sustained_pairs_per_s']:.4g} "
          f"sustained; wall {wall:.2f} s; launches {launched}; {entry['device']}, "
          f"{entry['power_limit']}")
    print(f"[parallel] phase 32 launches: {total}")
    return total, {"ring_ms": ring_ms, "rect_bound_ms": rect_bound[0]}


def _group_rank(device: str, paths: dict) -> dict:
    """One rank of phase 33's group: the ring, the bits axis, the 2×2 grid
    and the sharded K5 form, each held to the one-rank result; the launches
    of those calls; the ring's stages recorded on one more call."""
    from stormtpu_torch import parallel as par
    from stormtpu_torch.kernels import launch_counts, reset_launches
    from stormtpu_torch.stream import record_stages

    uni = np.load(paths["uniform"])
    ld = np.load(paths["ld"])
    row = par.make_row_mesh(GROUP_RANKS, device=device)
    grid = par.make_grid_mesh(2, 2, device=device)
    calls = {
        "rows": (lambda: par.distributed_count_matrix(uni, mesh=row), "c_uniform"),
        "bits": (lambda: par.distributed_count_matrix(uni, mesh=row, shard_axis="bits"),
                 "c_uniform"),
        "grid 2x2": (lambda: par.distributed_count_matrix(uni, mesh=grid), "c_uniform"),
        "bits K5": (lambda: par.distributed_count_matrix(ld, mesh=row, shard_axis="bits"),
                    "c_ld"),
    }
    out = {"wall": {}, "diff": {}}
    reset_launches()
    for name, (fn, ref) in calls.items():
        t0 = time.perf_counter()
        got = fn()
        out["wall"][name] = time.perf_counter() - t0
        out["diff"][name] = int((got != np.load(paths[ref], mmap_mode="r")).sum())
    out["launches"] = launch_counts()
    with record_stages() as rec:
        par.distributed_count_matrix(uni, mesh=row)
    out["stages_s"] = dict(rec.seconds)
    out["stages_ms"] = dict(rec.device_ms)
    return out


def group_phase(torch, dev, seed, par_timings) -> dict:
    """Phase 33: a spawned group of ``GROUP_RANKS`` gloo ranks, every rank on
    this card (NCCL refuses two ranks on one card), each running the ring,
    the bits axis, the 2×2 grid and the sharded K5 form at 8,192 × 262,144
    bits, held to the one-rank results of this process. Returns the least
    launches of each kernel over the ranks."""
    from stormtpu_torch import parallel as par
    from stormtpu_torch.parallel.dryrun import run_group

    torch.cuda.empty_cache()
    mesh = par.make_row_mesh(device=dev)
    rng = np.random.default_rng(seed + 33)
    uniform = rng.integers(0, 1 << 32, (GROUP_N, GROUP_M // 32), dtype=np.uint32)
    ld, _, _ = ld_panel(rng, GROUP_N, GROUP_M, 8, LD_DENSITY, bit_avoid=4096)
    tmp = tempfile.mkdtemp(prefix="stpu_group_")
    try:
        paths = {k: os.path.join(tmp, f"{k}.npy") for k in ("uniform", "ld", "c_uniform", "c_ld")}
        np.save(paths["uniform"], uniform)
        np.save(paths["ld"], ld)
        np.save(paths["c_uniform"], par.distributed_count_matrix(uniform, mesh=mesh))
        np.save(paths["c_ld"], par.distributed_count_matrix(ld, mesh=mesh, shard_axis="bits"))
        del uniform, ld
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        where = f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"
        ranks = run_group(GROUP_RANKS, "gloo", where, _group_rank, paths,
                          timeout=GROUP_TIMEOUT_S)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for rk, out in enumerate(ranks):
        bad = {k: v for k, v in out["diff"].items() if v}
        if bad:
            raise AssertionError(f"phase 33 rank {rk}: entries differ from one rank's: {bad}")
        low = [k for k in ("k2_rect", "k2_tri", "k5") if out["launches"][k] < 1]
        if low:
            raise AssertionError(f"phase 33 rank {rk}: {low} did not launch ({out['launches']})")
        steps = GROUP_RANKS // 2 + 1
        st_s, st_ms = out["stages_s"], out["stages_ms"]
        print(f"[group] rank {rk}: " + ", ".join(f"{k} {v:.2f} s" for k, v in out["wall"].items())
              + f", all equal to one rank's; launches {out['launches']}; a ring step: kernel "
              f"{st_ms.get('kernel', 0) / steps:.2f} ms by events ({st_s.get('kernel', 0) / steps * 1e3:.2f} "
              f"ms host), collectives {st_s.get('collective', 0) / steps * 1e3:.2f} ms host "
              f"(gloo through page-locked host memory)")
    least = {k: min(out["launches"][k] for out in ranks) for k in ("k2_rect", "k2_tri", "k5")}
    print(f"[group] {GROUP_RANKS} gloo ranks on one card, spawned and joined in {wall:.1f} s; "
          f"least launches over the ranks {least}; the one-rank ring at phase 32's shape took "
          f"{par_timings['ring_ms']:.2f} ms (bound {par_timings['rect_bound_ms']:.2f} ms)")
    return least


def check_topk(label: str, c: np.ndarray, k: int, vals: np.ndarray, idx: np.ndarray) -> int:
    """Hold a count top-k to the matrix ``c``: the values are each row's k
    largest counts off the diagonal, and each row's indices are distinct,
    never the row itself, and realize their values. Returns the rows whose
    k-th best count is 0 (where padded rows would tie with real partners)."""
    n = c.shape[0]
    rows = c.astype(np.int64)
    rows[np.arange(n), np.arange(n)] = -1
    want = -np.sort(-np.partition(rows, n - k, axis=1)[:, -k:], axis=1)
    if vals.shape != (n, k) or idx.shape != (n, k) or not np.array_equal(vals, want):
        raise AssertionError(f"{label}: values differ from the matrix's top {k}")
    r = np.arange(n)[:, None]
    s = np.sort(idx, axis=1)
    if not (np.array_equal(rows[r, idx], vals) and (np.diff(s, axis=1) > 0).all()
            and (idx != r).all()):
        raise AssertionError(f"{label}: an index does not realize its value, repeats, or is "
                             "the row itself")
    return int((want[:, -1] == 0).sum())


def repaired_topk_phase(torch, dev, cfg3_b) -> dict:
    """Phase 34, first part: ``topk_neighbors`` on config 3 B (phase 17's
    matrix: 10,000 rows, not a multiple of the block) on the route D1
    names, on the block form (K2-rect; D1 held to ``sparse_outer``, its
    name for panels where K4 wins), and through
    ``parallel.distributed_topk_neighbors`` on the one-rank NCCL mesh (the
    ring on K2-rect), at k = ``TOPK_K`` and at k = ``REPAIR_THIN_K``, where
    rows rank partners of count 0 beside the padded rows; each held to the
    top-k of phase 17's matrix, every partner set valid. Returns the
    launches."""
    import stormtpu_torch as st
    from stormtpu_torch import dispatch, parallel as par
    from stormtpu_torch.kernels import launch_counts, mxu, reset_launches

    bm, ref = cfg3_b
    strategy = dispatch.choose_strategy(bm.n, bm.m_bits, bm.density, bm=bm, device=dev)
    mesh = par.make_row_mesh(device=dev)

    def route_kernel(k):
        """The kernel D1's route launches at k: the tile walk takes K2-topk
        up to its limit, K2-tri's stored tiles above it."""
        if strategy == "pallas_mxu":
            return "k2_topk" if mxu.topk_route(k) == mxu.ROUTE_TOPK else "k2_tri"
        return {"clustered": "k5"}.get(strategy, "k2_rect")

    def block_form(k):
        d1 = dispatch.choose_strategy
        dispatch.choose_strategy = lambda *a, **kw: "sparse_outer"
        try:
            return st.topk_neighbors(bm, k, device=dev)
        finally:
            dispatch.choose_strategy = d1

    total: dict = {}
    for k, label, fn, kernel in (
            (k, label, fn, kernel) for k in (TOPK_K, REPAIR_THIN_K) for label, fn, kernel in (
                (f"topk_neighbors (D1: {strategy})",
                 lambda k=k: st.topk_neighbors(bm, k, device=dev), route_kernel(k)),
                ("topk_neighbors block form (D1 held to sparse_outer)",
                 lambda k=k: block_form(k), "k2_rect"),
                ("distributed_topk_neighbors (one-rank NCCL ring)",
                 lambda k=k: par.distributed_topk_neighbors(bm, k, mesh=mesh), "k2_rect"))):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        vals, idx = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        if got[kernel] < 1:
            raise AssertionError(f"[phase 34] config 3 B {label}: launches {got}, want {kernel}")
        thin = check_topk(f"config 3 B {label} k={k}", ref, k, vals, idx)
        if k == REPAIR_THIN_K and not thin:
            raise AssertionError(f"[phase 34] config 3 B k={k}: no row ranks a zero count")
        for key, v in got.items():
            total[key] = total.get(key, 0) + v
        print(f"[phase 34] config 3 B {bm.n} x {bm.m_bits} bits (density {bm.density:.2e}) "
              f"{label}, k={k}: wall {wall:.3f} s, launches "
              f"{ {key: v for key, v in got.items() if v} }; values equal phase 17's matrix's "
              f"top {k}, every row's partners distinct, never itself, each realizing its count "
              f"({thin} of {bm.n} rows have fewer than {k} partners of a positive count)")
    return total


def untuned_and_examples_phase(torch, dev, seed) -> dict:
    """Phase 34, second part: with ``$STORMTPU_TORCH_TUNING_CACHE`` naming an
    absent file, D1 names ``pallas_mxu`` at BASELINE.json config 2 (1,000 x
    65,536 bits) and ``intersect_count_matrix`` launches K2-tri and equals
    numpy's matrix; then each ``examples/torch_*.py`` as a subprocess on the
    card (all started together), each exiting 0 with its closing line.
    Returns the launches of the config 2 call."""
    import stormtpu_torch as st
    from stormtpu_torch import stream, tuning
    from stormtpu_torch.dispatch import choose_strategy
    from stormtpu_torch.kernels import launch_counts, plain_product_max_bits, reset_launches

    root = os.path.dirname(os.path.abspath(__file__))
    saved = os.environ.get(tuning.CACHE_ENV)
    os.environ[tuning.CACHE_ENV] = os.path.join(tempfile.mkdtemp(prefix="stpu_untuned_"),
                                                "absent.json")
    try:
        words = np.random.default_rng(seed + 34).integers(0, 1 << 32, (CFG2_N, CFG2_M // 32),
                                                          dtype=np.uint32)
        bm = st.BitMatrix.from_packed(words, CFG2_M)
        chosen = choose_strategy(bm.n, bm.m_bits, bm.density, bm=bm, device=dev)
        auto = stream._auto_stream_kernel(bm.m_bits, bm.n, dev)
        if chosen != "pallas_mxu" or auto != "mxu":
            raise AssertionError(f"[phase 34] untuned card at config 2: D1 {chosen!r}, stream "
                                 f"auto {auto!r}; want 'pallas_mxu' and 'mxu'")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = st.intersect_count_matrix(bm, device=dev)
        wall = time.perf_counter() - t0
        got = launch_counts()
        if got["k2_tri"] < 1:
            raise AssertionError(f"[phase 34] config 2 untuned: launches {got}, want k2_tri")
        bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little").astype(np.float32)
        want = (bits @ bits.T).astype(np.int64)  # float32 is exact below 2^24
        if not np.array_equal(out, want):
            raise AssertionError("[phase 34] config 2 untuned: the matrix differs from numpy's")
        print(f"[phase 34] untuned card (absent tuning cache), config 2 {CFG2_N} x {CFG2_M} "
              f"bits: plain_product_max_bits {plain_product_max_bits(dev)}, D1 {chosen}, stream "
              f"auto {auto}; intersect_count_matrix wall {wall:.3f} s, launches "
              f"{ {k: v for k, v in got.items() if v} }, equal to numpy's whole matrix")
        del bm, words, bits, want, out
    finally:
        if saved is None:
            os.environ.pop(tuning.CACHE_ENV, None)
        else:
            os.environ[tuning.CACHE_ENV] = saved
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, os.path.join(root, "examples", f"{name}.py")],
                                    cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name in EXAMPLES}
    failed = []
    try:
        for name, p in procs.items():
            try:
                stdout, stderr = p.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S
                                                           - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
                stderr += f"\nkilled after {EXAMPLE_TIMEOUT_S} s"
            lines = stdout.strip().splitlines()
            ok = p.returncode == 0 and lines and lines[-1] == f"{name}: all checks passed"
            print(f"[phase 34] examples/{name}.py on the card: exit {p.returncode}, done at "
                  f"{time.perf_counter() - t0:.1f} s; " + " | ".join(lines[-4:]))
            if not ok:
                print(stderr[-3000:], file=sys.stderr)
                failed.append(name)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError(f"[phase 34] examples failed on the card: {failed}")
    return got


def ld_ref_samples(ref: np.ndarray, man: dict) -> np.ndarray:
    """The reference matrix at a checksum manifest's sample coordinates
    (rows past n are padding: count 0)."""
    n = ref.shape[0]
    ii, jj = man["sample_ii"], man["sample_jj"]
    inside = (ii < n) & (jj < n)
    out = np.zeros(ii.size, dtype=np.int32)
    out[inside] = ref[ii[inside], jj[inside]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this run needs one", file=sys.stderr)
        return 1

    import stormtpu_torch as st
    from stormtpu_torch.config import default_config
    from stormtpu_torch.dispatch import choose_strategy
    from stormtpu_torch.config import EngineConfig
    from stormtpu_torch.kernels import (_build, clustered, dense, launch_counts, mxu,
                                        reset_launches, tc_rate)
    from stormtpu_torch.kernels.xla import unpack_to_int8
    from stormtpu_torch.layout import to_device_words
    from stormtpu_torch.oracle import oracle_pair_count
    from stormtpu_torch.stream import default_hist_bin_width
    from stormtpu_torch.utils import (assemble_triangular_torch, download, round_up,
                                      triangular_tile_ids)

    dev = torch.device(DEVICE)
    cfg = default_config()
    rng = np.random.default_rng(args.seed)
    max_err = {"k2_tri": 0, "k2_rect": 0, "k5": 0, "k1": 0, "k0": 0}

    # ---------------------------------------------------------------- 1 build
    t0 = time.perf_counter()
    logs = _build.build_all(tuple(_build.SOURCES))
    for name in _build.SOURCES:
        _build.library(name)
    print(f"[build] {len(_build.SOURCES)} source(s) in {time.perf_counter() - t0:.2f} s, "
          f"{len(logs)} compiled now")
    for name in _build.SOURCES:
        for symbol, used in _build.kernel_resources(name).items():
            print(f"[build] {name}: {symbol}: {used['registers']} registers, "
                  f"{used['spill_bytes']} spill bytes")
    # registers a thread of the kernels on B1Wgmma (csrc/tile_body.cuh) and of
    # K2-rect's on the TMA body
    used = {**_build.kernel_resources("k2_mxu"), **_build.kernel_resources("k1_dense")}

    def registers(kernel: str, struct: str = "") -> int:
        return next(v["registers"] for sym, v in used.items() if kernel in sym and struct in sym)

    regs = {"k2_tri": registers("k2_tri_kernel", "B1Wgmma"),
            "k5": registers("k5_stream_kernel", "B1Wgmma"),
            "k1": registers("k1_pair_kernel", "B1Wgmma")}
    rates = tc_rate.issue_rates(dev)
    for r in rates:
        print(f"[rate] {r['name']} issued back to back on every SM: {r['macs_per_s']:.4g} "
              f"MAC/s = {2 * r['macs_per_s'] / 1e12:.1f} TOP/s")
    k2_rate = rates[tc_rate.KINDS["wgmma_b1_n256"]]
    k2_ops_per_s = 2.0 * k2_rate["macs_per_s"]
    print(f"[rate] K2's tile body issues {k2_rate['name']}: its operation bound is "
          f"2*pairs*M / {k2_ops_per_s:.4g} /s; at the int8 data-sheet rate it would be "
          f"2*pairs*M / {PEAK_INT8_OPS:.4g} /s")

    def k2_bounds(ops: float, nbytes: float) -> dict:
        """Bound against the measured rate of the body's instruction, with the
        int8 data-sheet figure beside it."""
        b_ms, b_by = bound(ops, nbytes, k2_ops_per_s)
        return dict(bound_ms=b_ms, bound_by=b_by, bound_rate=f"measured {k2_rate['name']}",
                    operations_ms=ops / k2_ops_per_s * 1e3,
                    bytes_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                    bound_ms_int8=bound(ops, nbytes)[0])

    def tri_inputs(words: np.ndarray):
        n, w = words.shape
        ti, wk = mxu.k2_tile_shape(cfg, n, w)
        xp = np.zeros((round_up(n, ti), round_up(w, wk)), np.uint32)
        xp[:n, :w] = words
        ibs, jbs = triangular_tile_ids(xp.shape[0] // ti)
        return (to_device_words(xp, dev), torch.from_numpy(ibs).to(dev),
                torch.from_numpy(jbs).to(dev)), dict(tile_rows=ti, tile_words=wk)

    def rect_inputs(a: np.ndarray, b: np.ndarray):
        w = a.shape[1]
        ti, wk = mxu.k2_tile_shape(cfg, max(a.shape[0], b.shape[0]), w)
        pads = []
        for x in (a, b):
            xp = np.zeros((round_up(x.shape[0], ti), round_up(w, wk)), np.uint32)
            xp[: x.shape[0], :w] = x
            pads.append(to_device_words(xp, dev))
        return pads, dict(tile_rows=ti, tile_words=wk)

    def check_both(label: str, words: np.ndarray, expect_all=None) -> None:
        targs, tkw = tri_inputs(words)
        got = mxu.count_tiles_pallas_mxu(*targs, **tkw)
        want = mxu.count_tiles_plain(*targs, **tkw)
        torch.cuda.synchronize()
        max_err["k2_tri"] = max(max_err["k2_tri"], exact_diff(torch, got, want))
        a = words[: max(1, words.shape[0] // 3)]
        # K2-rect's card route on the operands as they are (true rows and
        # words), held to the plain version on the tile-padded operands
        (ap, bp), rkw = rect_inputs(a, words)
        reset_launches()
        got_r = mxu.count_block_pallas_mxu(to_device_words(a, dev), to_device_words(words, dev))
        want_r = mxu.count_block_plain(ap, bp, tile_words=rkw["tile_words"])[
            : a.shape[0], : words.shape[0]]
        torch.cuda.synchronize()
        if launch_counts()["k2_rect"] != 1:
            raise AssertionError(f"{label}: the card route did not launch K2-rect once")
        max_err["k2_rect"] = max(max_err["k2_rect"], exact_diff(torch, got_r, want_r))
        if expect_all is not None:
            n = words.shape[0]
            if not (bool((got[0, :n, :n] == expect_all).all())
                    and bool((got_r[: a.shape[0], :n] == expect_all).all())):
                raise AssertionError(f"{label}: counts are not all {expect_all}")
        print(f"[kernel vs plain] {label}: N={words.shape[0]} W={words.shape[1]} "
              f"tile={tkw['tile_rows']}x{tkw['tile_words']} T={targs[1].numel()} exact")
        del targs, got, want, ap, bp, got_r, want_r
        torch.cuda.empty_cache()

    # ------------------------------------------------------- 2 kernel vs plain
    for n, m in RAGGED:
        check_both(f"ragged N={n} M={m}", random_words(rng, n, m, 0.5))
    for density in (0.001, 0.5, 1.0):
        check_both(f"mid N={MID_N} M={MID_M} density={density}",
                   random_words(rng, MID_N, MID_M, density))
    check_both(f"all-ones N={ALL_ONES_N} M={ALL_ONES_M}",
               random_words(rng, ALL_ONES_N, ALL_ONES_M, 1.0), expect_all=ALL_ONES_M)
    # 36: K2-rect's TMA form at ragged shapes (its own generator: the later
    # phases draw what they drew before)
    max_err["k2_rect"] = max(max_err["k2_rect"],
                             rect_tma_phase(torch, dev, np.random.default_rng(args.seed + 36)))
    screen_entry = screen_kernel_phase(torch, dev, np.random.default_rng(args.seed + 37))

    # --------------------------------------------------------- 3 main path
    words = rng.integers(0, 1 << 32, size=(MAIN_N, MAIN_M // 32), dtype=np.uint32)
    bm = st.BitMatrix.from_packed(words, MAIN_M)
    chosen = choose_strategy(bm.n, bm.m_bits, bm.density, cfg, bm=bm, device=dev)
    if chosen != "pallas_mxu":
        raise AssertionError(f"D1 chose {chosen!r} at {MAIN_N} x {MAIN_M}, want 'pallas_mxu'")
    reset_launches()
    t0 = time.perf_counter()
    out = st.intersect_count_matrix(bm, strategy="auto", device=dev)
    wall_tri = time.perf_counter() - t0
    launches_tri = launch_counts()["k2_tri"]
    if launches_tri < 1:
        raise AssertionError("the main path did not launch the K2 triangular kernel")
    if out.shape != (MAIN_N, MAIN_N) or out.dtype != np.int32:
        raise AssertionError(f"result {out.shape} {out.dtype}")
    i = rng.integers(0, MAIN_N, N_SAMPLES)
    j = rng.integers(0, MAIN_N, N_SAMPLES)
    if not np.array_equal(out[i, j], sampled_counts(words, words, i, j)):
        raise AssertionError("sampled pairs differ from numpy")
    if not np.array_equal(np.diagonal(out), bm.row_nnz):
        raise AssertionError("diagonal differs from row_nnz")
    if not np.array_equal(out, out.T):
        raise AssertionError("count matrix is not symmetric")
    print(f"[main path] intersect_count_matrix {MAIN_N} x {MAIN_M} bits: D1 chose {chosen}, "
          f"k2_tri launches {launches_tri}, {N_SAMPLES} sampled pairs + diagonal + symmetry "
          f"exact; wall {wall_tri:.3f} s (first call: upload, kernel, assembly on the card, download)")
    # kept for phase 9 as a pageable copy, so that this result does not count
    # against the page-locked bytes that live results may hold (utils.download)
    main_out = out.copy()

    # --------------------------------------------------------- 4 count_block
    words_a = rng.integers(0, 1 << 32, size=(BLOCK_NA, MAIN_M // 32), dtype=np.uint32)
    bm_a = st.BitMatrix.from_packed(words_a, MAIN_M)
    reset_launches()
    t0 = time.perf_counter()
    blk = st.count_block(bm_a, bm, device=dev)
    wall_rect = time.perf_counter() - t0
    launches_rect = launch_counts()["k2_rect"]
    if launches_rect < 1:
        raise AssertionError("count_block did not launch the K2 rectangular kernel")
    if blk.shape != (BLOCK_NA, MAIN_N) or blk.dtype != np.int32:
        raise AssertionError(f"result {blk.shape} {blk.dtype}")
    i = rng.integers(0, BLOCK_NA, N_SAMPLES)
    j = rng.integers(0, MAIN_N, N_SAMPLES)
    if not np.array_equal(blk[i, j], sampled_counts(words_a, words, i, j)):
        raise AssertionError("count_block sampled pairs differ from numpy")
    print(f"[count_block] {BLOCK_NA} x {MAIN_N} rows at {MAIN_M} bits: k2_rect launches "
          f"{launches_rect}, {N_SAMPLES} sampled pairs exact; wall {wall_rect:.3f} s")

    # --------------------------------------------------------- 5 pair_count
    pa, pb = random_words(rng, 2, PAIR_M, 0.5)
    got = st.pair_count(st.BitMatrix.from_packed(pa[None], PAIR_M),
                        st.BitMatrix.from_packed(pb[None], PAIR_M), device=dev)
    if got != oracle_pair_count(pa, pb):
        raise AssertionError("pair_count differs from numpy")
    print(f"[pair_count] {PAIR_M} bits: {got} exact")

    # ------------------------------------------------------------ 6 timings
    # two warm calls: while an earlier result is alive its pinned host buffer
    # is in use, so the call pins a fresh one unless PyTorch's host cache
    # holds a released one of that size; once a result has been released,
    # the next call finds its buffer in that cache
    t0 = time.perf_counter()
    again = st.intersect_count_matrix(bm, device=dev)
    wall_tri_fresh = time.perf_counter() - t0
    del again, out
    t0 = time.perf_counter()
    st.intersect_count_matrix(bm, device=dev)
    wall_tri_warm = time.perf_counter() - t0
    # host-clock breakdown of the warm call's stages, in the order
    # api.intersect_count_matrix runs them (operand already cached on the card)
    stages = {}

    def stage(name, fn):
        s = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - s
        return r

    stage("dispatch", lambda: choose_strategy(bm.n, bm.m_bits, bm.density, cfg, bm=bm, device=dev))
    stage("compaction_scan", lambda: bm.packed.any(axis=0))
    ti_main, wk_main = mxu.k2_tile_shape(cfg, bm.n, bm.n_words)
    nb_main = round_up(MAIN_N, ti_main) // ti_main
    xp_main = stage("pad", lambda: mxu._pad(bm.device_padded(bm.n, device=dev),
                                            nb_main * ti_main, round_up(bm.n_words, wk_main)))
    ibs_np, jbs_np = triangular_tile_ids(nb_main)
    ids = stage("tile_ids_h2d", lambda: (torch.from_numpy(ibs_np).to(dev),
                                         torch.from_numpy(jbs_np).to(dev)))
    tiles = stage("k2_tri_kernel", lambda: mxu.count_tiles_pallas_mxu(
        xp_main, *ids, tile_rows=ti_main, tile_words=wk_main))
    full = stage("device_assembly", lambda: assemble_triangular_torch(
        tiles, ibs_np, jbs_np, nb_main, MAIN_N))
    stage("matrix_d2h", lambda: download(full))
    del tiles, full
    print("[breakdown] warm intersect_count_matrix stages (host clock, s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} of wall {wall_tri_warm:.4f}")
    timings = {}
    # triangular K2 at the main path's shapes
    targs, tkw = tri_inputs(words)
    t_tiles = targs[1].numel()
    n_pad, w_pad = targs[0].shape
    got = mxu.count_tiles_pallas_mxu(*targs, **tkw)
    want = mxu.count_tiles_plain(*targs, **tkw)
    torch.cuda.synchronize()
    max_err["k2_tri"] = max(max_err["k2_tri"], exact_diff(torch, got, want))
    del got, want
    plain_ms = cuda_ms(torch, lambda: mxu.count_tiles_plain(*targs, **tkw), reps=2)
    kern_ms = cuda_ms(torch, lambda: mxu.count_tiles_pallas_mxu(*targs, **tkw), reps=5)
    u = torch.empty((n_pad, w_pad * 32), dtype=torch.int8, device=dev)
    for r in range(0, n_pad, 2048):
        u[r : r + 2048] = unpack_to_int8(targs[0][r : r + 2048])
    lib_ms = cuda_ms(torch, lambda: torch._int_mm(u, u.t()), reps=3)
    int_mm_square_ms = lib_ms
    ti = tkw["tile_rows"]
    bounds = k2_bounds(2.0 * t_tiles * ti * ti * w_pad * 32,
                       4.0 * (n_pad * w_pad + 2 * t_tiles + t_tiles * ti * ti))
    timings["k2_tri"] = dict(ms=kern_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             registers=regs["k2_tri"], **bounds)
    print(f"[timing] k2_tri N_pad={n_pad} W_pad={w_pad} T={t_tiles} tile={ti}: kernel "
          f"{kern_ms:.3f} ms ({regs['k2_tri']} registers a thread), "
          f"plain {plain_ms:.3f} ms, _int_mm full square on unpacked "
          f"int8 {lib_ms:.3f} ms, bound {bounds['bound_ms']:.3f} ms ({bounds['bound_by']}, "
          f"{bounds['bound_rate']}; at the int8 data-sheet rate {bounds['bound_ms_int8']:.3f} ms)")
    # K2-topk and K2-hist at the main path's shapes: the first chunk of
    # topk_neighbors' tile walk (query._blocked_tile_ids, query._tile_chunk)
    from stormtpu_torch import query as q

    wib, wjb = q._blocked_tile_ids(n_pad // ti, q._TILE_GROUP)
    chunk = q._tile_chunk(ti)
    epi_main = epilogue_kernels(
        torch, dev, targs[0], wib[:chunk], wjb[:chunk], ti, tkw["tile_words"], n_real=MAIN_N,
        k=TOPK_K, n_bins=HIST_BINS, bin_width=default_hist_bin_width(MAIN_M, HIST_BINS),
        ops_per_s=k2_ops_per_s, label="main path, first tile-walk chunk", reps=10)
    # the same operand at tiles of 128 rows: one sub-tile row a tile, so the
    # TMA body launches its clusters of one (the shape rule)
    sib, sjb = q._blocked_tile_ids(n_pad // 128, q._TILE_GROUP)
    epi_single = epilogue_kernels(
        torch, dev, targs[0], sib[:q._tile_chunk(128)], sjb[:q._tile_chunk(128)], 128,
        tkw["tile_words"], n_real=MAIN_N, k=TOPK_K, n_bins=HIST_BINS,
        bin_width=default_hist_bin_width(MAIN_M, HIST_BINS), ops_per_s=k2_ops_per_s,
        label="main operand at 128-row tiles, first chunk", reps=5)
    if epi_single["k2_topk"]["cluster"] != 1 or epi_main["k2_topk"]["cluster"] != 2:
        raise AssertionError("the epilogues' shape rule: clusters of one at 128-row tiles, "
                             "of two at 256")
    # rectangular K2 at count_block's shapes: the card route on the operands
    # as they are, held to the plain version on the tile-padded operands
    (ap, bp), rkw = rect_inputs(words_a, words)
    ad, bd = to_device_words(words_a, dev), to_device_words(words, dev)
    rna, rnb, rw = ad.shape[0], bd.shape[0], ad.shape[1]
    got = mxu.count_block_pallas_mxu(ad, bd)
    want = mxu.count_block_plain(ap, bp, tile_words=rkw["tile_words"])[:rna, :rnb]
    torch.cuda.synchronize()
    max_err["k2_rect"] = max(max_err["k2_rect"], exact_diff(torch, got, want))
    del got, want
    kern_ms = cuda_ms(torch, lambda: mxu.count_block_pallas_mxu(ad, bd), reps=5)
    plain_ms = cuda_ms(torch, lambda: mxu.count_block_plain(ap, bp, tile_words=rkw["tile_words"]), reps=2)
    ua = torch.empty((ap.shape[0], w_pad * 32), dtype=torch.int8, device=dev)
    for r in range(0, ap.shape[0], 2048):
        ua[r : r + 2048] = unpack_to_int8(ap[r : r + 2048])
    lib_ms = cuda_ms(torch, lambda: torch._int_mm(ua, u.t()), reps=3)
    bounds = k2_bounds(2.0 * rna * rnb * rw * 32, 4.0 * ((rna + rnb) * rw + rna * rnb))
    # the kernel the shape rule launches at this Na
    rect_c = mxu.rect_cluster(rna)
    rect_kernel = f"k2_rect_tma_kernel<{rect_c}>"
    rect_regs = registers("k2_rect_tma_kernel", f"ILi{rect_c}E")
    timings["k2_rect"] = dict(ms=kern_ms, plain_ms=plain_ms, library_ms=lib_ms,
                              launch_kernel=rect_kernel, registers=rect_regs, **bounds)
    print(f"[timing] k2_rect card route (count_block_pallas_mxu) {rna} x {rnb} W={rw}: kernel "
          f"{kern_ms:.3f} ms ({rect_kernel}, {rect_regs} registers a thread), plain "
          f"{plain_ms:.3f} ms and _int_mm on unpacked int8 {lib_ms:.3f} ms (tile-padded "
          f"operands), bound {bounds['bound_ms']:.3f} ms ({bounds['bound_by']}, "
          f"{bounds['bound_rate']}; at the int8 data-sheet rate {bounds['bound_ms_int8']:.3f} ms)")
    print(f"[timing] intersect_count_matrix wall: first call {wall_tri:.3f} s, warm call "
          f"{wall_tri_fresh:.3f} s while the first result is alive (pins a fresh buffer) and "
          f"{wall_tri_warm:.3f} s after both were released (cached buffer); count_block wall "
          f"{wall_rect:.3f} s")
    del u, ua, targs, ap, bp, ad, bd
    torch.cuda.empty_cache()

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    popc_per_s = POPC_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
    print(f"[card] {sms} SMs, max SM clock {clock_mhz:.0f} MHz: popcount bound rate "
          f"{POPC_PER_CLOCK_PER_SM} x {sms} x {clock_mhz:.0f} MHz = {popc_per_s:.4g} /s")

    def padded(words: np.ndarray, rows: int, cols: int):
        xp = np.zeros((rows, cols), np.uint32)
        xp[: words.shape[0], : words.shape[1]] = words
        return to_device_words(xp, dev)

    # ------------------------------------------- 7 kernel vs plain: K5, K1, K0
    seen = {"pad slots": False, "tail pad items": False, "multi-group slot": False}
    for label, rows_cfg, words_cfg, n, m, blocks in K5_CASES:
        kcfg = cfg if rows_cfg is None else EngineConfig(k2_tile_rows=rows_cfg,
                                                         k2_tile_words=words_cfg)
        ti5, wk5 = mxu.k2_tile_shape(kcfg, n, -(-m // 32))
        kwords, _, _ = ld_panel(rng, n, m, blocks, 0.3, row_avoid=ti5, bit_avoid=wk5 * 32)
        plan5 = clustered.build_clustered_plan(st.BitMatrix.from_packed(kwords, m), kcfg)
        if plan5 is None:
            raise AssertionError(f"K5 {label}: no plan")
        p5 = plan5.slot_ibs.size
        seen["pad slots"] |= plan5.n_slots > p5
        seen["tail pad items"] |= plan5.ibs_w.size > plan5.n_work + plan5.n_slots - p5
        seen["multi-group slot"] |= bool(np.bincount(plan5.slots_w[: plan5.n_work]).max() > 1)
        args5 = [padded(kwords, plan5.n_pad, plan5.w_pad)] + [
            torch.from_numpy(x).to(dev)
            for x in (plan5.ibs_w, plan5.jbs_w, plan5.gsel_w, plan5.slots_w, plan5.first_w)]
        kw5 = dict(n_slots=plan5.n_slots, tile_rows=plan5.ti, tile_words=plan5.wk)
        got = clustered.count_tiles_worklist(*args5, **kw5)
        want = clustered.count_tiles_worklist_plain(*args5, **kw5)
        torch.cuda.synchronize()
        max_err["k5"] = max(max_err["k5"], exact_diff(torch, got, want))
        # the path's route: the plan's real items, checked on the host at plan time
        work5 = clustered.device_worklist(plan5, dev)
        kw5 = dict(n_slots=p5, tile_rows=plan5.ti, tile_words=plan5.wk)
        got = clustered.count_tiles_worklist(args5[0], *work5, checked=work5, **kw5)
        torch.cuda.synchronize()
        max_err["k5"] = max(max_err["k5"], exact_diff(torch, got, want[:p5]))
        print(f"[kernel vs plain] k5 {label}: N={n} M={m} tile={plan5.ti}x{plan5.wk} "
              f"items={plan5.n_work}/{plan5.ibs_w.size} slots={p5}/{plan5.n_slots} exact, "
              f"with the read-back and with the work list checked at plan time")
    # a malformed list (its slots reversed) must raise on both routes into the wrapper
    broken = dataclasses.replace(plan5, slots_w=np.ascontiguousarray(plan5.slots_w[::-1]))
    for route, call in (
            ("plan time", lambda: clustered.device_worklist(broken, dev)),
            ("read-back", lambda: clustered.count_tiles_worklist(
                args5[0], *(torch.from_numpy(np.ascontiguousarray(x[: plan5.n_work])).to(dev)
                            for x in (broken.ibs_w, broken.jbs_w, broken.gsel_w,
                                      broken.slots_w, broken.first_w)), **kw5))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"a malformed work list did not raise at {route}")
    print("[kernel vs plain] k5: a malformed work list raises at plan time and on the "
          "read-back route")
    if not all(seen.values()):
        raise AssertionError(f"K5 cases did not cover {seen}")
    ones = torch.full((ALL_ONES_N, ALL_ONES_M // 32), -1, dtype=torch.int32, device=dev)
    ti5, wk5 = mxu.k2_tile_shape(cfg, ALL_ONES_N, ALL_ONES_M // 32)
    ng5 = ones.shape[1] // wk5
    zeros_ids = torch.zeros(ng5, dtype=torch.int32, device=dev)
    first5 = torch.zeros(ng5, dtype=torch.int32, device=dev)
    first5[0] = 1
    args5 = [ones, zeros_ids, zeros_ids, torch.arange(ng5, dtype=torch.int32, device=dev),
             zeros_ids, first5]
    kw5 = dict(n_slots=1, tile_rows=ti5, tile_words=wk5)
    got = clustered.count_tiles_worklist(*args5, **kw5)
    want = clustered.count_tiles_worklist_plain(*args5, **kw5)
    torch.cuda.synchronize()
    max_err["k5"] = max(max_err["k5"], exact_diff(torch, got, want))
    if not bool((got == ALL_ONES_M).all()):
        raise AssertionError(f"k5 all-ones: counts are not all {ALL_ONES_M}")
    print(f"[kernel vs plain] k5 all-ones N={ALL_ONES_N} M={ALL_ONES_M}: {ng5} items "
          f"of one slot, every count {ALL_ONES_M}, exact")
    del args5, got, want

    def k1_inputs(words: np.ndarray):
        n, w = words.shape
        ti1, wk1 = dense.k1_tile_shape(cfg, n, w)
        ibs1, jbs1 = triangular_tile_ids(round_up(n, ti1) // ti1)
        return (padded(words, round_up(n, ti1), round_up(w, wk1)),
                torch.from_numpy(ibs1).to(dev), torch.from_numpy(jbs1).to(dev)), \
            dict(tile_rows=ti1, tile_words=wk1)

    def check_k1(label: str, words: np.ndarray, expect_all=None) -> None:
        args1, kw1 = k1_inputs(words)
        got1 = dense.count_tiles_pallas_dense(*args1, **kw1)
        want1 = dense.count_tiles_dense_plain(*args1, **kw1)
        torch.cuda.synchronize()
        max_err["k1"] = max(max_err["k1"], exact_diff(torch, got1, want1))
        n = words.shape[0]
        if expect_all is not None and not bool((got1[0, :n, :n] == expect_all).all()):
            raise AssertionError(f"k1 {label}: counts are not all {expect_all}")
        print(f"[kernel vs plain] k1 {label}: N={n} W={words.shape[1]} "
              f"tile={kw1['tile_rows']}x{kw1['tile_words']} T={args1[1].numel()} exact")

    for n in K1_NS:
        for m in K1_MS:
            for density in (0.001, 0.5, 1.0):
                check_k1(f"M={m} density={density}", random_words(rng, n, m, density))
    check_k1("all-ones", np.full((ALL_ONES_N, ALL_ONES_M // 32), 0xFFFFFFFF, np.uint32),
             expect_all=ALL_ONES_M)
    # tile rows that fill part of a block's half (8, 40), all of it (128) and two
    # sub-tile rows (136: the second 8 rows tall); tile lists whose neighbours
    # share their A rows (i-major), mostly do not (shuffled), and of odd length
    for ti1 in K1_TILE_ROWS:
        xp1 = padded(random_words(rng, K1_LIST_BLOCKS * ti1 - 3, 70 * 32, 0.5),
                     K1_LIST_BLOCKS * ti1, 72)
        ibs1, jbs1 = triangular_tile_ids(K1_LIST_BLOCKS)
        perm = rng.permutation(ibs1.size)
        for order, (ib, jb) in (("i-major", (ibs1, jbs1)),
                                ("shuffled", (ibs1[perm], jbs1[perm])),
                                ("odd length", (ibs1[:-2], jbs1[:-2]))):
            ids1 = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (ib, jb)]
            alone = int((dense.pair_units(ids1[0]) >= 0).sum()) * 2 - ib.size
            want1 = dense.count_tiles_dense_plain(xp1, *ids1, tile_rows=ti1, tile_words=24)
            got1 = dense.count_tiles_pallas_dense(xp1, *ids1, tile_rows=ti1, tile_words=24)
            torch.cuda.synchronize()
            max_err["k1"] = max(max_err["k1"], exact_diff(torch, got1, want1))
            print(f"[kernel vs plain] k1 tile rows {ti1}, {order} list of {ib.size} tiles "
                  f"({alone} without a partner): exact")

    for r, w in K0_CASES:
        a = random_words(rng, r, w * 32, 0.5)
        b = random_words(rng, r, w * 32, 0.5)
        a[r // 2] = 0
        for salt in (0, 0xDEADBEEF):
            ta, tb = to_device_words(a, dev), to_device_words(b, dev)
            got = dense.pair_count_stream_pallas(ta, tb, salt=salt)
            want = dense.pair_count_stream_plain(ta, tb, salt=salt)
            torch.cuda.synchronize()
            max_err["k0"] = max(max_err["k0"], exact_diff(torch, got, want))
            oracle = np.bitwise_count((a ^ np.uint32(salt)) & b).sum(axis=1, dtype=np.int64)
            if not np.array_equal(got.cpu().numpy().astype(np.int64), oracle):
                raise AssertionError(f"k0 R={r} W={w} salt={salt:#x} differs from numpy")
            print(f"[kernel vs plain] k0 R={r} W={w} salt={salt:#x}: exact, numpy exact")
    ta = torch.full((1000, 4096), -1, dtype=torch.int32, device=dev)
    for salt in (0, 0xDEADBEEF):
        got = dense.pair_count_stream_pallas(ta, ta, salt=salt)
        want = dense.pair_count_stream_plain(ta, ta, salt=salt)
        torch.cuda.synchronize()
        max_err["k0"] = max(max_err["k0"], exact_diff(torch, got, want))
        expect = 4096 * bin(~salt & 0xFFFFFFFF).count("1")
        if not bool((got == expect).all()):
            raise AssertionError(f"k0 all-ones salt={salt:#x}: counts are not all {expect}")
    print("[kernel vs plain] k0 all-ones R=1000 W=4096 at salt 0 and 0xdeadbeef: exact")
    del ones, ta
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 8 clustered path
    t0 = time.perf_counter()
    ld_words, ld_rows, ld_bits = ld_panel(rng, LD_N, LD_M, LD_BLOCKS, LD_DENSITY)
    bm_ld = st.BitMatrix.from_packed(ld_words, LD_M)
    occupancy = float(bm_ld.packed.any(axis=0).mean())
    print(f"[clustered] LD panel {LD_N} x {LD_M} bits, {LD_BLOCKS} blocks, density "
          f"{LD_DENSITY} inside blocks, global column occupancy {occupancy:.6f}; made in "
          f"{time.perf_counter() - t0:.2f} s; row cuts {ld_rows.tolist()}; bit cuts "
          f"{ld_bits.tolist()}")
    chosen = choose_strategy(bm_ld.n, bm_ld.m_bits, bm_ld.density, cfg, bm=bm_ld, device=dev)
    if chosen != "clustered":
        raise AssertionError(f"D1 chose {chosen!r} on the LD panel, want 'clustered'")
    plan = clustered.build_clustered_plan(bm_ld, cfg)
    n_vis = plan.slot_ibs.size
    reset_launches()
    t0 = time.perf_counter()
    ld_out = st.intersect_count_matrix(bm_ld, strategy="auto", device=dev)
    wall_ld = time.perf_counter() - t0
    counts = launch_counts()
    launches_k5 = counts["k5"]
    if launches_k5 < 1 or counts["k2_tri"] != 0:
        raise AssertionError(f"the clustered path launched {counts}; want k5 >= 1, k2_tri 0")
    if ld_out.shape != (LD_N, LD_N) or ld_out.dtype != np.int32:
        raise AssertionError(f"result {ld_out.shape} {ld_out.dtype}")
    half = N_SAMPLES // 2
    blk_of = np.searchsorted(ld_rows, np.arange(LD_N), side="right") - 1
    same = rng.integers(0, LD_BLOCKS, half)
    i = rng.integers(ld_rows[same], ld_rows[same + 1])
    j = rng.integers(ld_rows[same], ld_rows[same + 1])
    ai = rng.integers(0, LD_N, 4 * half)
    aj = rng.integers(0, LD_N, 4 * half)
    cross = blk_of[ai] != blk_of[aj]
    i = np.concatenate([i, ai[cross][:half]])
    j = np.concatenate([j, aj[cross][:half]])
    if i.size != N_SAMPLES:
        raise AssertionError("could not draw the cross-block samples")
    if not np.array_equal(ld_out[i, j], sampled_counts(ld_words, ld_words, i, j)):
        raise AssertionError("clustered path: sampled pairs differ from numpy")
    if not np.array_equal(np.diagonal(ld_out), bm_ld.row_nnz):
        raise AssertionError("clustered path: diagonal differs from row_nnz")
    if not np.array_equal(ld_out, ld_out.T):
        raise AssertionError("clustered path: count matrix is not symmetric")
    print(f"[clustered path] intersect_count_matrix {LD_N} x {LD_M} bits: D1 chose {chosen}, "
          f"launches {counts}; work fraction {plan.work_fraction:.6f}, n_work {plan.n_work}, "
          f"items with padding {plan.ibs_w.size}, visited slots {n_vis}, n_slots "
          f"{plan.n_slots}, tile {plan.ti}x{plan.wk}, {plan.nb} row blocks x {plan.ng} "
          f"K-groups; {half} within-block + {half} cross-block sampled pairs, diagonal, "
          f"symmetry exact; first call wall {wall_ld:.3f} s")
    # kept for the disk routes of phase 14, as a pageable copy (see main_out)
    ld_ref = ld_out.copy()
    t0 = time.perf_counter()
    again = st.intersect_count_matrix(bm_ld, device=dev)
    wall_ld_fresh = time.perf_counter() - t0
    del ld_out, again
    t0 = time.perf_counter()
    st.intersect_count_matrix(bm_ld, device=dev)
    wall_ld_warm = time.perf_counter() - t0
    stages = {}
    stage("dispatch", lambda: choose_strategy(bm_ld.n, bm_ld.m_bits, bm_ld.density, cfg,
                                              bm=bm_ld, device=dev))
    plan = stage("plan", lambda: clustered.build_clustered_plan(bm_ld, cfg))
    packed_ld = stage("operand_cached", lambda: clustered.device_operand(bm_ld, plan, dev))
    work = stage("worklist_h2d", lambda: clustered.device_worklist(plan, dev))
    kw5 = dict(n_slots=n_vis, tile_rows=plan.ti, tile_words=plan.wk)
    tiles5 = stage("k5_kernel", lambda: clustered.count_tiles_worklist(
        packed_ld, *work, checked=work, **kw5))
    full5 = stage("device_assembly", lambda: assemble_triangular_torch(
        tiles5, plan.slot_ibs, plan.slot_jbs, plan.nb, LD_N))
    stage("matrix_d2h", lambda: download(full5))
    del full5
    print("[breakdown] warm clustered intersect_count_matrix stages (host clock, s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} of wall {wall_ld_warm:.4f}")
    bm_ld.clear_device_cache()
    del packed_ld
    torch.cuda.empty_cache()
    stages = {}
    packed_ld = stage("pad_upload_cold", lambda: clustered.device_operand(bm_ld, plan, dev))
    print(f"[breakdown] first-call operand pad and upload ({plan.n_pad} x {plan.w_pad} words): "
          f"{stages['pad_upload_cold']:.4f} s")
    # K2's whole triangle on the same padded operand: the walk K5 skips
    ibs_all, jbs_all = triangular_tile_ids(plan.nb)
    ids_all = (torch.from_numpy(ibs_all).to(dev), torch.from_numpy(jbs_all).to(dev))
    tiles2 = mxu.count_tiles_pallas_mxu(packed_ld, *ids_all, tile_rows=plan.ti,
                                        tile_words=plan.wk)
    lut = np.full((plan.nb, plan.nb), -1, np.int64)
    lut[ibs_all, jbs_all] = np.arange(ibs_all.size)
    vis = torch.from_numpy(lut[plan.slot_ibs, plan.slot_jbs]).to(dev)
    if not (torch.equal(tiles2[vis], tiles5)
            and int(tiles2.sum(dtype=torch.int64)) == int(tiles5.sum(dtype=torch.int64))):
        raise AssertionError("K5 tiles differ from K2's, or a skipped tile pair is not zero")
    k2_same_ms = cuda_ms(torch, lambda: mxu.count_tiles_pallas_mxu(
        packed_ld, *ids_all, tile_rows=plan.ti, tile_words=plan.wk), reps=3)
    print(f"[clustered] K2 triangle on the same operand: T={ibs_all.size} tile pairs x "
          f"{plan.ng + 1} K-groups; its visited tiles equal K5's and the rest are zero; "
          f"{k2_same_ms:.3f} ms")
    del tiles2, tiles5, ids_all
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 9 pallas_dense path
    reset_launches()
    t0 = time.perf_counter()
    dense_out = st.intersect_count_matrix(bm, strategy="pallas_dense", device=dev)
    wall_k1 = time.perf_counter() - t0
    counts = launch_counts()
    launches_k1 = counts["k1"]
    if launches_k1 < 1:
        raise AssertionError(f"the pallas_dense path launched {counts}; want k1 >= 1")
    if not np.array_equal(dense_out, main_out):
        raise AssertionError("pallas_dense matrix differs from the K2 main path's")
    print(f"[pallas_dense path] intersect_count_matrix {MAIN_N} x {MAIN_M} bits: launches "
          f"{counts}; equal to the K2 main path's matrix; wall {wall_k1:.3f} s")
    del dense_out

    # ---------------------------------------------------- 10 K0 pair stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    w_st = STREAM_M // 32
    sa, sb = (torch.randint(-(1 << 31), 1 << 31, (STREAM_R, w_st), dtype=torch.int32,
                            device=dev, generator=gen) for _ in range(2))
    reset_launches()
    t0 = time.perf_counter()
    pc = dense.pair_count_stream_pallas(sa, sb)
    torch.cuda.synchronize()
    wall_k0 = time.perf_counter() - t0
    counts = launch_counts()
    launches_k0 = counts["k0"]
    if launches_k0 < 1:
        raise AssertionError(f"pair_count_stream_pallas launched {counts}; want k0 >= 1")
    rows = torch.from_numpy(rng.integers(0, STREAM_R, 256)).to(dev)
    ah = sa[rows].cpu().numpy().view(np.uint32)
    bh = sb[rows].cpu().numpy().view(np.uint32)
    if not np.array_equal(pc[rows].cpu().numpy().astype(np.int64),
                          np.bitwise_count(ah & bh).sum(axis=1, dtype=np.int64)):
        raise AssertionError("K0 sampled rows differ from numpy")
    print(f"[k0 path] pair_count_stream_pallas {STREAM_R} pairs x {STREAM_M} bits: launches "
          f"{counts}; 256 sampled rows exact; wall {wall_k0:.3f} s")

    # ---------------------------------------------------- 11 timings
    def checked5():
        return clustered.count_tiles_worklist(packed_ld, *work, checked=work, **kw5)

    def bare5():  # the wrapper reads the list back, checks it and schedules it
        return clustered.count_tiles_worklist(packed_ld, *work, **kw5)

    got = checked5()
    want = clustered.count_tiles_worklist_plain(packed_ld, *work, **kw5)
    torch.cuda.synchronize()
    max_err["k5"] = max(max_err["k5"], exact_diff(torch, got, want))
    exact_diff(torch, bare5(), want)
    ti5, wk5 = plan.ti, plan.wk
    # the launch alone: the C entry with the wrapper's own arguments, the units
    # longest first (the schedule) and in slot order (what the kernel's balance
    # owes to the schedule)
    out5 = torch.empty_like(got)
    by_slot = work.units[torch.argsort(work.units[:, 2], stable=True)].contiguous()

    def launch5(units):
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        mxu._launch("k2_mxu", "k5_launch", dev, packed_ld.data_ptr(),
                       *(t.data_ptr() for t in work.tensors[:3]), units.data_ptr(),
                       counter.data_ptr(), out5.data_ptr(), units.shape[0],
                       min(sms, units.shape[0]), ti5, wk5, packed_ld.shape[1])

    for units in (work.units, by_slot):
        out5.fill_(-1)
        launch5(units)
        torch.cuda.synchronize()
        exact_diff(torch, out5, want)
    del got, want
    plain_ms = cuda_ms(torch, lambda: clustered.count_tiles_worklist_plain(packed_ld, *work, **kw5),
                       reps=1, warmup=0)
    kern_ms = cuda_ms(torch, checked5, reps=20)
    launch_ms = cuda_ms(torch, lambda: launch5(work.units), reps=20)
    by_slot_ms = cuda_ms(torch, lambda: launch5(by_slot), reps=20)
    bare_ms = cuda_ms(torch, bare5, reps=20)
    host_ms = {}
    for name, fn in (("checked", checked5), ("read-back", bare5)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms[name] = (time.perf_counter() - t0) / 20 * 1e3  # not synchronised
        torch.cuda.synchronize()
    # bytes: each distinct (row block, K-group) slab that an item reads, as
    # its A or its B operand, once; the five work-list arrays; each slot's tile
    k = plan.n_work
    slabs = np.unique(np.concatenate([
        plan.ibs_w[:k].astype(np.int64) * (plan.ng + 1) + plan.gsel_w[:k],
        plan.jbs_w[:k].astype(np.int64) * (plan.ng + 1) + plan.gsel_w[:k]])).size
    bounds = k2_bounds(2.0 * k * ti5 * ti5 * wk5 * 32,
                       4.0 * (slabs * ti5 * wk5 + 5 * k + n_vis * ti5 * ti5))
    timings["k5"] = dict(ms=kern_ms, plain_ms=plain_ms, library_ms=None,
                         launch_alone_ms=launch_ms, launch_alone_slot_order_ms=by_slot_ms,
                         read_back_route_ms=bare_ms, wrapper_host_ms=host_ms["checked"],
                         wrapper_host_read_back_ms=host_ms["read-back"],
                         registers=regs["k5"], distinct_slabs=slabs, **bounds,
                         library="none: no one PyTorch call computes a "
                         "work-list accumulation")
    pad_args = [torch.from_numpy(x).to(dev)
                for x in (plan.ibs_w, plan.jbs_w, plan.gsel_w, plan.slots_w, plan.first_w)]
    pad_ms = cuda_ms(torch, lambda: clustered.count_tiles_worklist(
        packed_ld, *pad_args, n_slots=plan.n_slots, tile_rows=ti5, tile_words=wk5), reps=10)
    del pad_args, out5, by_slot
    print(f"[timing] k5 LD panel n_work={plan.n_work} slots={n_vis} tile={ti5}x{wk5}: kernel "
          f"through its wrapper with the work list checked at plan time {kern_ms:.3f} ms "
          f"({regs['k5']} registers a thread), of which the wrapper holds the host "
          f"{host_ms['checked']:.4f} ms a call; the launch alone {launch_ms:.3f} ms, with the "
          f"units in slot order {by_slot_ms:.3f} ms; through the wrapper's read-back route "
          f"{bare_ms:.3f} ms (host {host_ms['read-back']:.4f} ms a call; with the plan's "
          f"bucket padding, {plan.ibs_w.size} items into {plan.n_slots} slots: {pad_ms:.3f} "
          f"ms); plain "
          f"{plain_ms:.3f} ms, bound {bounds['bound_ms']:.3f} ms ({bounds['bound_by']}, "
          f"{bounds['bound_rate']}; bytes alone {bounds['bytes_ms']:.3f} ms for {slabs} "
          f"distinct slabs of {ti5} rows x {wk5} words; at the int8 data-sheet rate "
          f"{bounds['bound_ms_int8']:.3f} ms); K2 triangle on the same operand "
          f"{k2_same_ms:.3f} ms, skip ratio {k2_same_ms / kern_ms:.2f}x")
    del packed_ld, work
    torch.cuda.empty_cache()

    args1, kw1 = k1_inputs(words)
    t1 = args1[1].numel()
    n_pad1, w_pad1 = args1[0].shape
    ti1 = kw1["tile_rows"]
    kern_ms = cuda_ms(torch, lambda: dense.count_tiles_pallas_dense(*args1, **kw1), reps=5)
    # the work is K2's: 2 * pairs * M operations at the rate of the instruction
    # the kernel issues
    nbytes1 = 4.0 * (n_pad1 * w_pad1 + 2 * t1 + t1 * ti1 * ti1)
    bounds = k2_bounds(2.0 * t1 * ti1 * ti1 * w_pad1 * 32, nbytes1)
    del bounds["bound_ms_int8"]
    del args1
    mid_args, mid_kw = k1_inputs(random_words(rng, MID_N, MID_M, 0.5))
    got = dense.count_tiles_pallas_dense(*mid_args, **mid_kw)
    want = dense.count_tiles_dense_plain(*mid_args, **mid_kw)
    torch.cuda.synchronize()
    max_err["k1"] = max(max_err["k1"], exact_diff(torch, got, want))
    del got, want
    plain_mid_ms = cuda_ms(torch, lambda: dense.count_tiles_dense_plain(*mid_args, **mid_kw),
                           reps=1, warmup=0)
    kern_mid_ms = cuda_ms(torch, lambda: dense.count_tiles_pallas_dense(*mid_args, **mid_kw),
                          reps=5)
    timings["k1"] = dict(ms=kern_ms, plain_ms=plain_mid_ms, library_ms=int_mm_square_ms,
                         registers=regs["k1"], **bounds,
                         plain_shape=f"{MID_N} x {MID_M} bits", ms_at_plain_shape=kern_mid_ms,
                         library="torch._int_mm full square on unpacked int8 (phase 6)")
    print(f"[timing] k1 N_pad={n_pad1} W_pad={w_pad1} T={t1} tile={ti1}: kernel {kern_ms:.3f} "
          f"ms ({regs['k1']} registers a thread; {kern_ms / timings['k2_tri']['ms']:.2f}x "
          f"K2-tri's time on the same rows), bound {bounds['bound_ms']:.3f} ms "
          f"({bounds['bound_by']}, {bounds['bound_rate']}), _int_mm full square "
          f"{int_mm_square_ms:.3f} ms; at "
          f"{MID_N} x {MID_M} bits (T={mid_args[1].numel()}): kernel {kern_mid_ms:.3f} ms, "
          f"plain {plain_mid_ms:.3f} ms")
    del mid_args

    got = dense.pair_count_stream_pallas(sa, sb, salt=0xDEADBEEF)
    want = dense.pair_count_stream_plain(sa, sb, salt=0xDEADBEEF)
    torch.cuda.synchronize()
    max_err["k0"] = max(max_err["k0"], exact_diff(torch, got, want))
    del got, want
    plain_ms = cuda_ms(torch, lambda: dense.pair_count_stream_plain(sa, sb), reps=3)
    kern_ms = cuda_ms(torch, lambda: dense.pair_count_stream_pallas(sa, sb), reps=10)
    b_ms, b_by = bound(float(STREAM_R) * w_st, 2.0 * STREAM_R * w_st * 4 + STREAM_R * 4.0,
                       popc_per_s)
    timings["k0"] = dict(ms=kern_ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                         bound_by=b_by, library="none: torch has no popcount op")
    print(f"[timing] k0 R={STREAM_R} W={w_st}: kernel {kern_ms:.3f} ms "
          f"({2.0 * STREAM_R * w_st * 4 / (kern_ms * 1e-3) / 1e9:.1f} GB/s), plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by})")
    print(f"[timing] clustered intersect_count_matrix wall: first call {wall_ld:.3f} s, warm "
          f"call {wall_ld_fresh:.3f} s while the first result is alive and {wall_ld_warm:.3f} s "
          f"after both were released (both find a buffer the main path released in the host "
          f"cache); pallas_dense wall {wall_k1:.3f} s")
    del sa, sb, pc
    torch.cuda.empty_cache()

    stream_launches = stream_phases(torch, dev, cfg, rng, args.seed, bm_ld, ld_ref, k2_ops_per_s)
    sparse_kernels, cfg3_b = sparse_phases(torch, dev, cfg, rng)
    query_launches, sq_launches, kept = query_phases(
        torch, dev, cfg, rng, args.seed, k2_ops_per_s, main=(bm, main_out), block=(bm_a, blk),
        ld=(bm_ld, ld_ref), cfg3_b=cfg3_b)
    topk20_launches = kept["topk20_launches"]
    screen_main_launches = kept["screen_launches"]
    t0 = time.perf_counter()
    repair_launches = repaired_topk_phase(torch, dev, cfg3_b)
    print(f"[phase 34] config 3 B top-k and ring took {time.perf_counter() - t0:.1f} s")
    del blk, cfg3_b
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    par_launches, par_timings = parallel_phase(
        torch, dev, cfg, args.seed, k2_ops_per_s, main=(bm, main_out), ld=(bm_ld, ld_ref),
        kept=kept)
    print(f"[parallel] phase 32 took {time.perf_counter() - t0:.1f} s")
    del main_out, ld_ref, bm_ld, kept
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tune_launches, crossover = tuning_phase(torch, dev, args.seed, k2_ops_per_s)
    print(f"[tune] phase 29 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli_phase(torch, dev, args.seed)
    print(f"[cli] phase 30 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    accept_launches = acceptance_phase(torch, dev)
    print(f"[accept] phase 31 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    group_launches = group_phase(torch, dev, args.seed, par_timings)
    print(f"[group] phase 33 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    untuned_launches = untuned_and_examples_phase(torch, dev, args.seed)
    print(f"[phase 34] the untuned routing and the examples took "
          f"{time.perf_counter() - t0:.1f} s")
    later = {"tune_launches": tune_launches, "accept_launches": accept_launches,
             "parallel_launches": par_launches, "group_launches": group_launches,
             "repair_launches": {k: repair_launches.get(k, 0) + untuned_launches.get(k, 0)
                                 for k in set(repair_launches) | set(untuned_launches)}}

    src_k2 = "stormtpu_torch/kernels/csrc/k2_mxu.cu"
    src_k1 = "stormtpu_torch/kernels/csrc/k1_dense.cu"
    src_epi = "stormtpu_torch/kernels/csrc/k2_epilogue.cu"
    int_mm_note = "torch._int_mm on unpacked int8"
    kernels = [
        dict(name="k2_tri", route="cuda", source=src_k2,
             replaces="stormtpu/kernels/mxu.py:202", launches=launches_tri,
             max_abs_err=max_err["k2_tri"], library=int_mm_note + ", full square",
             stream_launches=stream_launches["k2_tri"], query_launches=query_launches["k2_tri"],
             stream_query_launches=sq_launches["k2_tri"],
             **timings["k2_tri"]),
        dict(name="k2_rect", route="cuda", source=src_k2,
             replaces="stormtpu/kernels/mxu.py:248", launches=launches_rect,
             max_abs_err=max_err["k2_rect"], library=int_mm_note,
             query_launches=query_launches["k2_rect"],
             stream_query_launches=sq_launches["k2_rect"], **timings["k2_rect"]),
        dict(name="k5", route="cuda", source=src_k2,
             replaces="stormtpu/kernels/clustered.py:165", launches=launches_k5,
             max_abs_err=max_err["k5"], stream_launches=stream_launches["k5"],
             query_launches=query_launches["k5"], stream_query_launches=sq_launches["k5"],
             **timings["k5"]),
        dict(name="k1", route="cuda", source=src_k1,
             replaces="stormtpu/kernels/dense.py:140", launches=launches_k1,
             max_abs_err=max_err["k1"], query_launches=query_launches["k1"],
             stream_query_launches=sq_launches["k1"], **timings["k1"]),
        dict(name="k0", route="cuda", source=src_k1,
             replaces="stormtpu/kernels/dense.py:239", launches=launches_k0,
             max_abs_err=max_err["k0"], query_launches=query_launches["k0"],
             stream_query_launches=sq_launches["k0"], **timings["k0"]),
        *(dict(k, query_launches=query_launches[k["name"]],
               stream_query_launches=sq_launches[k["name"]]) for k in sparse_kernels),
        # the epilogues: launches on each one's main path (phase 20's
        # topk_neighbors, phase 13's config-4 histogram sink); times at that
        # path's shape, the other shape's beside them
        dict(name="k2_topk", route="cuda", source=src_epi,
             replaces="stormtpu/query.py:548 (_topk_tile_walk; no pallas_call: the "
                      "device reduction round K2-tri)",
             launches=topk20_launches,
             max_abs_err=max(epi_main["k2_topk"]["max_abs_err"],
                             epi_single["k2_topk"]["max_abs_err"],
                             stream_launches["epilogue"]["k2_topk"]["max_abs_err"]),
             library="K2-tri + tile_topk_sets in torch on its stored tiles",
             stream_launches=stream_launches.get("k2_topk", 0),
             query_launches=query_launches["k2_topk"],
             stream_query_launches=sq_launches["k2_topk"],
             config4_stripe={key: v for key, v in stream_launches["epilogue"]["k2_topk"].items()
                             if key != "max_abs_err"},
             single_cta_tiles={key: v for key, v in epi_single["k2_topk"].items()
                               if key != "max_abs_err"},
             **{key: v for key, v in epi_main["k2_topk"].items() if key != "max_abs_err"}),
        dict(name="k2_hist", route="cuda", source=src_epi,
             replaces="stormtpu/stream_hist.py:112 (_make_pair_hist_fn) and "
                      "stormtpu/stream.py:1228 (stream_count_histogram; no pallas_call: the "
                      "device reduction round K2-tri)",
             launches=stream_launches["k2_hist"],
             max_abs_err=max(epi_main["k2_hist"]["max_abs_err"],
                             epi_single["k2_hist"]["max_abs_err"],
                             stream_launches["epilogue"]["k2_hist"]["max_abs_err"]),
             library="K2-tri + tile_hist (torch.bincount) on its stored tiles",
             stream_launches=stream_launches["k2_hist"],
             query_launches=query_launches["k2_hist"],
             stream_query_launches=sq_launches["k2_hist"],
             main_path_chunk={key: v for key, v in epi_main["k2_hist"].items()
                              if key != "max_abs_err"},
             single_cta_tiles={key: v for key, v in epi_single["k2_hist"].items()
                               if key != "max_abs_err"},
             **{key: v for key, v in stream_launches["epilogue"]["k2_hist"].items()
                if key != "max_abs_err"}),
        # launches on its main path (phase 25's config-4 stream_pairs_above),
        # phase 37's own beside them
        dict(screen_entry, launches=screen_main_launches,
             stream_query_launches=sq_launches["stripe_screen"]),
    ]
    for k in kernels:
        k.update({key: counts.get(k["name"], 0) for key, counts in later.items()})
    kernels[1]["plain_product_crossover_bits"] = crossover["m_bits"]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
