// K2 and K5 for Hopper: exact all-pairs intersection counts of packed bit
// rows on the tensor cores' binary product, straight from the packed words.
//
// Replaces the JAX package's Pallas kernels:
//   stormtpu/kernels/mxu.py        _k2_kernel / _k2_kernel_planes
//                                  (triangular tile list, count_tiles_pallas_mxu)
//   stormtpu/kernels/mxu.py        _k2_rect_concat / _k2_rect_planes
//                                  (rectangular grid, count_block_pallas_mxu)
//   stormtpu/kernels/clustered.py  _k5_kernel_concat / _k5_kernel_planes
//                                  (work list, count_tiles_worklist)
//
// What it computes: C[i, j] = popcount(A[i] AND B[j]), int32, exact for
// M < 2^31. The TPU kernels unpack bits to int8 {0,1} and take an int8
// product, because that is what the TPU's matrix unit has. Hopper's tensor
// cores have the function itself: the .b1 .and.popc product adds
// popcount(A_row AND B_row) over 256 bits a step, at eight times the int8
// rate in pairs (csrc/tc_rate.cu measures both). No bit is ever unpacked.
//
// What bounds it: 2·pairs·M bit operations at the binary product's issue
// rate, and before that the packed operand's trips from L2 into shared
// memory: a BM x BN block reads (BM + BN) rows for BM·BN pairs, so the
// traffic per pair falls as the block's tile grows. Device-memory bytes
// (each input once, each output once) are far below both.
//
// What the design does about it:
//  - One block owns a BM x BN sub-tile of output and loops over ALL of its
//    K range inside the block, keeping the int32 sums in registers. Blocks
//    run in any order with no atomics and no cross-block sums; the TPU's
//    sequential K grid axis becomes this loop.
//  - The K range comes from a "source": a flat list of chunks of KW = 32
//    words of an A row block and a B row block. K2's source is one
//    row-block pair over all words; K5's is a slot's work items one after
//    another (one K-group each), so the load pipeline runs across a slot's
//    items and the slot is stored once: no zeroing, no atomics.
//  - K2-tri's and K5's chunks arrive through a ring of shared-memory stages
//    filled by cp.async (16 bytes a thread) ahead of the products.
//    cp.async's source size zero-fills rows past the tile and words past the
//    K range (exact: zero bits add nothing), so one loader serves every tile
//    size and K5's K-groups.
//  - K2-rect runs on tile::B1WgmmaTma (csrc/tile_body_tma.cuh): TMA loads
//    through a tensor map per operand, whose zero fill stands in for the
//    rows and words past the operands, and blocks laid out A sub-tile row
//    fastest, so that the blocks that read one B tile run next to each
//    other and B (the lookups' 100,000-row panel, the rows ring's
//    250,112-row shard) streams from device memory once a call. When A has
//    an even number of sub-tile rows, rows 2q, 2q + 1 form a cluster that
//    loads each B tile once, multicast into both; else each block loads its
//    own (clusters of one; k2_rect_tma_kernel below).
//  - The tile body (tile::B1Wgmma in csrc/tile_body.cuh, which K1 shares)
//    is 128 x 256 a block, the widest tile whose sums fit the registers:
//    two warpgroups, each issuing wgmma.m64n256k256 with both operands read
//    from shared memory through matrix descriptors, so no fragment passes
//    through registers and the threads only issue loads and products. The
//    stage layout is the 128-byte swizzle the descriptors name.
//  - K5's slots differ in length by an order of magnitude (one item to
//    dozens), and a block holds a whole SM (192 KiB of stages). The host
//    hands the kernel a schedule of "units" (a slot's sub-tile and its
//    items), longest first; one block an SM takes them off it as it falls
//    free and streams them through the ring without a drain between units;
//    see k5_stream_kernel below.
//
// Launch interface: plain C functions taking device pointers and the
// stream as void*, returning cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_body_tma.cuh"

namespace {

using namespace tile;

// ------------------------------------------------------------- K2 kernels
// Triangular form: blockIdx.x = tile pair t, blockIdx.y = BM x BN sub-tile
// of the TI x TI output tile. Tile t counts row block ibs[t] against
// jbs[t] (the same rows when ibs[t] == jbs[t]); its source, RowPairSource,
// is in tile_body.cuh.
template <class Body>
__global__ void __launch_bounds__(Body::THREADS, Body::MIN_BLOCKS)
    k2_tri_kernel(const uint32_t* __restrict__ packed,
                  const int* __restrict__ ibs, const int* __restrict__ jbs,
                  int* __restrict__ out, int ti, int64_t w) {
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  constexpr int BM = Body::BM, BN = Body::BN;
  const int64_t t = blockIdx.x;
  const int nsub_n = (ti + BN - 1) / BN;
  const int si = blockIdx.y / nsub_n;
  const int sj = blockIdx.y % nsub_n;
  const int a_rows = min(BM, ti - si * BM);
  const int b_rows = min(BN, ti - sj * BN);
  const int64_t row_a = static_cast<int64_t>(ibs[t]) * ti + si * BM;
  const int64_t row_b = static_cast<int64_t>(jbs[t]) * ti + sj * BN;
  typename Body::Acc acc;
  zero_frags(acc.v);
  const RowPairSource src{packed + row_a * w, packed + row_b * w,
                          static_cast<int>(w)};
  Body::accumulate(acc, src, a_rows, b_rows, w, smem_dyn);
  Body::store(acc, a_rows, b_rows,
              out + t * ti * ti + static_cast<int64_t>(si) * BM * ti + sj * BN,
              ti);
}

// ------------------------------------------------------------- K5 kernels
// One unit of K5's schedule, an int4 in memory: items [x, x + y) of the work
// list add into BM x BN sub-tile w of output slot z's TI x TI tile. A unit
// with no items stores zeros. Every (slot, sub-tile) is in exactly one
// unit, so blocks store without zeroing or atomics. The host orders the
// units longest first.
//
// Where a block's loads stand in its run of units: chunk c of item t of
// the block's j-th unit, with what stays the same for a whole unit (its
// sub-tile) and for a whole item (its two row bases) worked out once. A
// unit with no items counts as one chunk of zeros.
//
// Which unit is a block's j-th: the blocks take units off the schedule as
// they fall free, through a counter in device memory, so the longest-first
// order balances the SMs whatever their pace. A block's first unit is its
// blockIdx. Thread 0 takes unit j + 1 when the block opens unit j and
// leaves it in `taken` (shared memory, a ring of 8: the loads run at most
// AHEAD units in front of the products); every unit has a chunk, hence a
// barrier, before the next is opened.
template <class Body>
struct UnitCursor {
  const uint32_t* packed;
  const int* ibs;
  const int* jbs;
  const int* gsel;
  const int4* units;
  int* counter;  // units taken beyond each block's first
  int* taken;    // shared: this block's unit ids by j % 8
  int n_units, per_item, nsub_n, ti, wk;
  int64_t w;
  int j, k, t, t_end, c, a_rows, b_rows;
  int64_t sub_a, sub_b;  // the unit's sub-tile, in words from a row block's start
  const uint32_t* pa;
  const uint32_t* pb;
  __device__ int unit_id(int jj) const { return taken[jj & 7]; }
  __device__ void open_item() {
    if (t < t_end) {
      const int64_t k0 = static_cast<int64_t>(gsel[t]) * wk;
      pa = packed + sub_a + static_cast<int64_t>(ibs[t]) * ti * w + k0;
      pb = packed + sub_b + static_cast<int64_t>(jbs[t]) * ti * w + k0;
    }
  }
  __device__ void open() {
    k = unit_id(j);
    if (k < n_units) {
      if (threadIdx.x == 0)
        taken[(j + 1) & 7] = gridDim.x + atomicAdd(counter, 1);
      const int4 u = units[k];
      t = u.x;
      t_end = u.x + u.y;
      const int si = u.w / nsub_n;
      const int sj = u.w % nsub_n;
      a_rows = min(Body::BM, ti - si * Body::BM);
      b_rows = min(Body::BN, ti - sj * Body::BN);
      sub_a = static_cast<int64_t>(si) * Body::BM * w;
      sub_b = static_cast<int64_t>(sj) * Body::BN * w;
      c = 0;
      pa = pb = packed;
      open_item();
    }
  }
  __device__ bool live() const { return k < n_units; }
  // words of this chunk that exist (0: a unit with no items)
  __device__ int valid() const { return t < t_end ? wk - c * KW : 0; }
  __device__ void advance() {
    if (t >= t_end || (c + 1 == per_item && t + 1 == t_end)) {
      ++j;
      open();
    } else if (++c == per_item) {
      c = 0;
      ++t;
      open_item();
    }
  }
};

// K5's kernel: a block runs its units as ONE chunk sequence. The cp.async ring never drains between units: the
// loads run AHEAD chunks in front of the products, into the next unit when
// this one ends, and after a unit's last chunk the block waits for its
// products, stores the sums and zeroes them while the next unit's chunks
// are already in flight. One block an SM; see UnitCursor for which units a
// block runs.
template <class Body>
__global__ void __launch_bounds__(Body::THREADS, Body::MIN_BLOCKS)
    k5_stream_kernel(const uint32_t* __restrict__ packed,
                     const int* __restrict__ ibs, const int* __restrict__ jbs,
                     const int* __restrict__ gsel,
                     const int4* __restrict__ units, int n_units,
                     int* __restrict__ counter, int* __restrict__ out, int ti,
                     int wk, int64_t w) {
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  __shared__ int taken[8];
  constexpr int BM = Body::BM, BN = Body::BN;
  if (threadIdx.x == 0) taken[0] = blockIdx.x;
  __syncthreads();
  UnitCursor<Body> lead{packed, ibs, jbs, gsel, units, counter, taken, n_units,
                        (wk + KW - 1) / KW, (ti + BN - 1) / BN, ti, wk, w, 0};
  lead.open();  // the loads' cursor; the products follow in the loops below

  auto load_next = [&](int pos) {
    if (lead.live()) {
      Body::load_stage(smem_dyn, pos, lead.pa + lead.c * KW,
                       lead.pb + lead.c * KW, lead.a_rows, lead.b_rows, w,
                       lead.valid());
      lead.advance();
    }
    cp_async_commit();
  };

  typename Body::Acc acc;
  zero_frags(acc.v);
#pragma unroll
  for (int s = 0; s < Body::AHEAD; ++s) {
    load_next(s);
    __syncthreads();  // a unit opened here may be read by the next call
  }
  int f = 0;  // chunks behind the products, over all units
  for (int j = 0;; ++j) {
    const int k = lead.unit_id(j);
    if (k >= n_units) break;
    const int4 u = units[k];
    // the sums are read only after the unit's last group is done, outside
    // the chunk loop, so that the product groups overlap inside it (read
    // inside it, the compiler puts a wait after every group)
    for (int left = max(1, u.y * lead.per_item); left > 0; --left, ++f) {
      Body::wait_chunk();
      load_next(f + Body::AHEAD);
      Body::issue(acc, smem_dyn, f);
      wgmma_wait<1>();  // the group before is done: its stage may be refilled
    }
    wgmma_wait<0>();
    const int si = u.w / lead.nsub_n;
    const int sj = u.w % lead.nsub_n;
    Body::store(acc, min(BM, ti - si * BM), min(BN, ti - sj * BN),
                out + static_cast<int64_t>(u.z) * ti * ti +
                    static_cast<int64_t>(si) * BM * ti + sj * BN,
                ti);
    zero_frags(acc.v);
  }
  cp_async_wait<0>();
}

// Rectangular form on the TMA body, A sub-tile fastest: block x is sub-tile
// row x % nsub_m of A against B tile x / nsub_m, so the blocks that read
// one B tile are neighbours in launch order, and with CLUSTER = 2 (nsub_m
// even) sub-tile rows 2q, 2q + 1 form a cluster that loads the tile's B rows
// once, each block half of them multicast into both. A and B each have
// their own tensor map, whose zero fill stands in for the rows past na or
// nb and the words past w; the store masks them.
template <int CLUSTER>
__global__ void __launch_bounds__(B1WgmmaTma<CLUSTER>::THREADS, 1)
    k2_rect_tma_kernel(__grid_constant__ const CUtensorMap map_a,
                       __grid_constant__ const CUtensorMap map_b, int* __restrict__ out,
                       int64_t na, int64_t nb, int64_t w, int64_t ldo, int nsub_m) {
  using Body = B1WgmmaTma<CLUSTER>;
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  const int64_t ra = static_cast<int64_t>(blockIdx.x % nsub_m) * Body::BM;
  const int64_t rb = static_cast<int64_t>(blockIdx.x / nsub_m) * Body::BN;
  const int chunks = static_cast<int>((w + KW - 1) / KW);
  // w >= 1 (the launcher refuses less). Told so, the compiler drops the
  // loop's zero-trip path, whose zeroed sums ptxas took for writes inside
  // the product pipeline: it then waited for each product before issuing
  // the next (C7515, "wgmma serialized"): 0.7 ms of a ring block's 13 on an
  // H100.
  __builtin_assume(chunks > 0);
  Body::init(smem_dyn);
  if (Body::is_producer()) {
    Body::produce(&map_a, &map_b, smem_dyn, chunks, static_cast<int>(ra),
                  static_cast<int>(rb));
  } else {
    typename Body::Acc acc;
    Body::consume(acc, smem_dyn, chunks);
    const int a_rows = static_cast<int>(min(static_cast<int64_t>(Body::BM), na - ra));
    const int b_rows = static_cast<int>(min(static_cast<int64_t>(Body::BN), nb - rb));
    B1Wgmma::store(acc, a_rows, b_rows, out + ra * ldo + rb, ldo);
    Body::finish();
  }
}

}  // namespace

extern "C" {

// Output rows per block: the wrappers' grid-limit check.
int k2_block_rows() { return B1Wgmma::BM; }

// Sub-tiles (blocks) of a ti x ti output tile: the sub-tile ids of K5's units.
int k2_sub_tiles(int ti) { return static_cast<int>(sub_tiles<B1Wgmma>(ti)); }

// packed: int32/uint32 [n_pad, w]; ibs, jbs: int32 [t]; out: int32 [t, ti, ti].
int k2_tri_launch(const void* packed, const void* ibs, const void* jbs,
                  void* out, int t, int ti, long long w, void* stream) {
  const dim3 grid(static_cast<unsigned>(t), sub_tiles<B1Wgmma>(ti));
  return launch<B1Wgmma>(k2_tri_kernel<B1Wgmma>, grid, stream,
                         static_cast<const uint32_t*>(packed),
                         static_cast<const int*>(ibs),
                         static_cast<const int*>(jbs), static_cast<int*>(out), ti,
                         static_cast<int64_t>(w));
}

// a: [na, w], b: [nb, w] words; out: int32 [na, ldo], the counts in its
// first nb columns. The blocks run in clusters of `cluster` (kernels/mxu.py's
// rect_cluster(na) says which: 2 when ceil(na / 128) is even, else 1).
// Refuses (cudaErrorInvalidValue, nothing launched) what TMA does not take:
// a base not 16-byte aligned, w % 4 != 0, a row coordinate or a block count
// past int32; and another cluster, an ldo that is odd or leaves no spare
// column for an odd nb (the stores go out as int2 at even columns: an odd
// nb writes column nb, which is never read).
int k2_rect_tma_launch(const void* a, const void* b, void* out, long long na,
                       long long nb, long long w, long long ldo, int cluster,
                       void* stream) {
  using Tma = B1WgmmaTma<1>;
  const long long nsub_m = (na + Tma::BM - 1) / Tma::BM;
  const long long nsub_n = (nb + Tma::BN - 1) / Tma::BN;
  if (na < 1 || nb < 1 || (cluster != 1 && cluster != 2) || nsub_m % cluster ||
      na + Tma::BM >= (1ll << 31) || nb + Tma::BN >= (1ll << 31) || w + KW >= (1ll << 31) ||
      nsub_m * nsub_n >= (1ll << 31) || ldo % 2 || ldo < nb + nb % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (const int e = encode_operand_map(&map_a, a, na, w)) return e;
  if (const int e = encode_operand_map(&map_b, b, nb, w)) return e;
  const dim3 grid(static_cast<unsigned>(nsub_m * nsub_n));
  auto* const o = static_cast<int*>(out);
  const int64_t na_ = na, nb_ = nb, w_ = w, ldo_ = ldo;
  const int m = static_cast<int>(nsub_m);
  if (cluster == 2)
    return launch_cluster<B1WgmmaTma<2>>(k2_rect_tma_kernel<2>, grid, dim3(2, 1, 1), stream,
                                         map_a, map_b, o, na_, nb_, w_, ldo_, m);
  return launch_cluster<B1WgmmaTma<1>>(k2_rect_tma_kernel<1>, grid, dim3(1, 1, 1), stream,
                                       map_a, map_b, o, na_, nb_, w_, ldo_, m);
}

// packed: int32/uint32 [n_pad, w]; ibs, jbs, gsel: int32 [t_work]; units:
// int32 [n_units, 4]; counter: one int32, 0 at the launch; out: int32
// [n_slots, ti, ti]. n_blocks <= n_units blocks (one an SM) stream the
// units, taking them in order as they fall free.
int k5_launch(const void* packed, const void* ibs, const void* jbs,
              const void* gsel, const void* units, void* counter, void* out,
              int n_units, int n_blocks, int ti, int wk, long long w,
              void* stream) {
  return launch<B1Wgmma>(k5_stream_kernel<B1Wgmma>,
                         dim3(static_cast<unsigned>(n_blocks)), stream,
                         static_cast<const uint32_t*>(packed),
                         static_cast<const int*>(ibs),
                         static_cast<const int*>(jbs),
                         static_cast<const int*>(gsel),
                         static_cast<const int4*>(units), n_units,
                         static_cast<int*>(counter), static_cast<int*>(out),
                         ti, wk, static_cast<int64_t>(w));
}

}  // extern "C"
