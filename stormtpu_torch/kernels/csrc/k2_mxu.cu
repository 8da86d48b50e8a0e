// K2 and K5 for Hopper: exact all-pairs intersection counts of packed bit
// rows on the tensor cores' binary product, straight from the packed words.
//
// Replaces the JAX package's Pallas kernels:
//   stormtpu/kernels/mxu.py        _k2_kernel / _k2_kernel_planes
//                                  (triangular tile list, count_tiles_pallas_mxu)
//   stormtpu/kernels/mxu.py        _k2_rect_concat / _k2_rect_planes
//                                  (rectangular grid, count_block_pallas_mxu
//                                  and _count_block_padded)
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
//  - Chunks arrive through a ring of shared-memory stages filled by
//    cp.async (16 bytes a thread) ahead of the products. cp.async's source
//    size zero-fills rows past the tile and words past the K range (exact:
//    zero bits add nothing), so one loader serves every tile size and K5's
//    K-groups; a tensor map per operand (TMA) would save the address
//    arithmetic but not the L2 traffic that sets the pace.
//  - K2-rect at more than one 128-row sub-tile row of A (Na > 128: the
//    rows ring's blocks of 256 query rows against a 250,112-row shard) runs
//    on tile::B1WgmmaTma instead (csrc/tile_body_tma.cuh): there the blocks
//    of every A sub-tile row read the same B tile, and in the cp.async
//    form's order (B tile fastest) a B tile's two readers run a whole pass
//    over B apart, so the shard came from device memory once per sub-tile
//    row. The TMA form lays the blocks of one B tile next to each other and
//    pairs sub-tile rows 2q, 2q + 1 in a cluster that multicasts the B rows
//    into both (k2_rect_tma_kernel below). Na <= 128 (the lookups' 64 query
//    rows: one sub-tile row, nothing to share) keeps the cp.async form.
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
//    see the K5 kernels below.
//  - The previous body (S8Body) stays for timing beside it only
//    (chip_smoke.py): the int8 mma.sync.m16n8k32 with the unpack fused into
//    the fragment load, which the integer pipe held at a quarter of the
//    int8 rate.
//
// Launch interface: plain C functions taking device pointers and the
// stream as void*, returning cudaGetLastError() of the launch. The
// functions ending in "_prev" launch the previous body.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_body_tma.cuh"

namespace {

using namespace tile;

// ------------------------------------------------------------- K sources
// K2's source, RowPairSource, lives in tile_body.cuh (the epilogue kernels
// of k2_epilogue.cu run the same main loop).

// K5 on the previous body: items [t0, t0 + n_items) of the work list; item t
// is row blocks ibs[t] x jbs[t] (rows off_a, off_b into the tile) over
// K-group gsel[t]: words [gsel*wk, gsel*wk + wk) of a row of w words. (On
// the tile body K5 walks its items with a UnitCursor, below.)
struct WorkListSource {
  const uint32_t* packed;
  const int* ibs;
  const int* jbs;
  const int* gsel;
  int t0, n_items, ti, off_a, off_b, wk;
  int64_t w;
  __device__ int chunks() const { return n_items * ((wk + KW - 1) / KW); }
  __device__ void chunk(int f, const uint32_t*& pa, const uint32_t*& pb,
                        int& valid) const {
    const int per_item = (wk + KW - 1) / KW;
    const int t = t0 + f / per_item;
    const int c = (f % per_item) * KW;
    const int64_t k = static_cast<int64_t>(gsel[t]) * wk + c;
    pa = packed + (static_cast<int64_t>(ibs[t]) * ti + off_a) * w + k;
    pb = packed + (static_cast<int64_t>(jbs[t]) * ti + off_b) * w + k;
    valid = wk - c;
  }
};

// out[r, c] = acc[r, c] for r < a_rows, c < b_rows; out has row stride ldo
// (even; an odd b_rows also writes column b_rows, which the pitch must
// hold). m16n8 accumulator layout: c0, c1 at (grp, 2q + {0,1}); c2, c3 at
// row grp + 8.
template <int WARPS_N, int MT, int NT>
__device__ __forceinline__ void store_frags(const int (&acc)[MT][NT][4],
                                            int a_rows, int b_rows,
                                            int* __restrict__ out,
                                            int64_t ldo) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int wm = (warp / WARPS_N) * (MT * 16);
  const int wn = (warp % WARPS_N) * (NT * 8);
  const int q2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + i * 16 + grp + h * 8;
      if (r < a_rows) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = wn + j * 8 + q2;
          if (c < b_rows) {
            *reinterpret_cast<int2*>(out + r * ldo + c) =
                make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          }
        }
      }
    }
  }
}

// ------------------------- the previous body: int8 product, fused unpack
struct S8Body {
  static constexpr int WARPS_M = 2;
  static constexpr int WARPS_N = 4;
  static constexpr int MT = 4;
  static constexpr int NT = 4;
  static constexpr int BM = 128;
  static constexpr int BN = 128;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int LDS = KW + 4;  // padded row stride in words: 16-B
                                      // aligned rows, conflict-free reads
  static constexpr int SMEM_BYTES = (BM + BN) * LDS * 4;

  struct Acc {
    int v[MT][NT][4];
  };

  static __device__ __forceinline__ uint32_t spread_nibble(uint32_t nib) {
    // bits b0..b3 of nib -> bytes 0..3 as 0/1 (shifts 0, 7, 14, 21 do not
    // overlap, so the multiply has no carries)
    return (nib * 0x00204081u) & 0x01010101u;
  }

  static __device__ __forceinline__ void mma_s8(int (&c)[4],
                                                const uint32_t (&a)[4],
                                                const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }

  static __device__ __forceinline__ void load_stage(uint32_t* sm,
                                                    const uint32_t* g, int rows,
                                                    int64_t ld, int valid) {
    constexpr int VEC = KW / 4;
    for (int v = threadIdx.x; v < BM * VEC; v += THREADS) {
      const int r = v / VEC;
      const int c = (v % VEC) * 4;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < valid) {
        val = *reinterpret_cast<const uint4*>(g + r * ld + c);
      }
      *reinterpret_cast<uint4*>(sm + r * LDS + c) = val;
    }
  }

  // One packed word is one k32 step. Within the word, fragment column
  // c = h*16 + q*4 + e holds bit q*8 + h*4 + e, so a thread takes one byte
  // of the word and spreads each nibble to four bytes with one multiply.
  template <class Source>
  static __device__ __forceinline__ void accumulate(Acc& acc, const Source& src,
                                                    int a_rows, int b_rows,
                                                    int64_t ld,
                                                    uint32_t* smem) {
    uint32_t* sa = smem;
    uint32_t* sb = smem + BM * LDS;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int grp = lane >> 2;
    const int shift = (lane & 3) * 8;
    const int wm = (warp / WARPS_N) * (MT * 16);
    const int wn = (warp % WARPS_N) * (NT * 8);
    const int n = src.chunks();
    for (int f = 0; f < n; ++f) {
      const uint32_t* pa;
      const uint32_t* pb;
      int valid;
      src.chunk(f, pa, pb, valid);
      load_stage(sa, pa, a_rows, ld, valid);
      load_stage(sb, pb, b_rows, ld, valid);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KW; ++kk) {
        uint32_t af[MT][4];
        uint32_t bf[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t lo = sa[(wm + i * 16 + grp) * LDS + kk] >> shift;
          const uint32_t hi = sa[(wm + i * 16 + grp + 8) * LDS + kk] >> shift;
          af[i][0] = spread_nibble(lo & 0xFu);
          af[i][1] = spread_nibble(hi & 0xFu);
          af[i][2] = spread_nibble((lo >> 4) & 0xFu);
          af[i][3] = spread_nibble((hi >> 4) & 0xFu);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t x = sb[(wn + j * 8 + grp) * LDS + kk] >> shift;
          bf[j][0] = spread_nibble(x & 0xFu);
          bf[j][1] = spread_nibble((x >> 4) & 0xFu);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc.v[i][j], af[i], bf[j]);
      }
      __syncthreads();
    }
  }

  static __device__ __forceinline__ void store(const Acc& acc, int a_rows,
                                               int b_rows, int* out,
                                               int64_t ldo) {
    store_frags<WARPS_N, MT, NT>(acc.v, a_rows, b_rows, out, ldo);
  }
};

static_assert(S8Body::BM == B1Wgmma::BM, "k2_block_rows() speaks for both");

// Triangular form: blockIdx.x = tile pair t, blockIdx.y = BM x BN sub-tile
// of the TI x TI output tile. Tile t counts row block ibs[t] against
// jbs[t] (the same rows when ibs[t] == jbs[t]).
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
// Per-unit form, which the previous body keeps: block b runs unit units[b].
template <class Body>
__global__ void __launch_bounds__(Body::THREADS, Body::MIN_BLOCKS)
    k5_kernel(const uint32_t* __restrict__ packed,
              const int* __restrict__ ibs, const int* __restrict__ jbs,
              const int* __restrict__ gsel, const int4* __restrict__ units,
              int* __restrict__ out, int ti, int wk, int64_t w) {
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  constexpr int BM = Body::BM, BN = Body::BN;
  const int4 u = units[blockIdx.x];
  const int nsub_n = (ti + BN - 1) / BN;
  const int si = u.w / nsub_n;
  const int sj = u.w % nsub_n;
  const int a_rows = min(BM, ti - si * BM);
  const int b_rows = min(BN, ti - sj * BN);
  typename Body::Acc acc;
  zero_frags(acc.v);
  const WorkListSource src{packed, ibs, jbs, gsel, u.x, u.y,
                           ti, si * BM, sj * BN, wk, w};
  Body::accumulate(acc, src, a_rows, b_rows, w, smem_dyn);
  Body::store(acc, a_rows, b_rows,
              out + static_cast<int64_t>(u.z) * ti * ti +
                  static_cast<int64_t>(si) * BM * ti + sj * BN,
              ti);
}

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

// Streaming form, which the tile body launches: a block runs its units as
// ONE chunk sequence. The cp.async ring never drains between units: the
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

// Rectangular form: blockIdx.x = BN-row block of B, blockIdx.y = BM-row
// block of A. The ragged edges of both are masked here (rows past na or nb
// load as zeros and are not stored), so the operands need no row padding.
template <class Body>
__global__ void __launch_bounds__(Body::THREADS, Body::MIN_BLOCKS)
    k2_rect_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, int* __restrict__ out,
                   int64_t na, int64_t nb, int64_t w, int64_t ldo) {
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  constexpr int BM = Body::BM, BN = Body::BN;
  const int64_t ra = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t rb = static_cast<int64_t>(blockIdx.x) * BN;
  const int a_rows = static_cast<int>(min(static_cast<int64_t>(BM), na - ra));
  const int b_rows = static_cast<int>(min(static_cast<int64_t>(BN), nb - rb));
  typename Body::Acc acc;
  zero_frags(acc.v);
  const RowPairSource src{a + ra * w, b + rb * w, static_cast<int>(w)};
  Body::accumulate(acc, src, a_rows, b_rows, w, smem_dyn);
  Body::store(acc, a_rows, b_rows, out + ra * ldo + rb, ldo);
}

// a: [na, w], b: [nb, w] words, w a multiple of 4 (a 16-byte vector is
// loaded whole, and must not reach into the next row); out: int32 [na, ldo]
// with ldo even and ldo > nb when nb is odd (the stores go out as int2 at
// even columns: an odd nb writes column nb, which is never read).
template <class Body>
int rect_launch(const void* a, const void* b, void* out, long long na,
                long long nb, long long w, long long ldo, void* stream) {
  const dim3 grid(static_cast<unsigned>((nb + Body::BN - 1) / Body::BN),
                  static_cast<unsigned>((na + Body::BM - 1) / Body::BM));
  return launch<Body>(k2_rect_kernel<Body>, grid, stream,
                      static_cast<const uint32_t*>(a),
                      static_cast<const uint32_t*>(b), static_cast<int*>(out),
                      static_cast<int64_t>(na), static_cast<int64_t>(nb),
                      static_cast<int64_t>(w), static_cast<int64_t>(ldo));
}

// Rectangular form on the TMA body, A sub-tile fastest: block x is sub-tile
// row x % nsub_m of A against B tile x / nsub_m, so the blocks that read
// one B tile are neighbours in launch order, and with CLUSTER = 2 (nsub_m
// even) sub-tile rows 2q, 2q + 1 form a cluster that loads the tile's B rows
// once, each block half of them multicast into both. A and B each have
// their own tensor map, whose zero fill stands in for the rows past na or
// nb and the words past w; the store masks them as k2_rect_kernel's does.
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

// packed: int32/uint32 [n_pad, w]; ibs, jbs: int32 [t]; out: int32 [t, ti, ti].
template <class Body>
int tri_launch(const void* packed, const void* ibs, const void* jbs, void* out,
               int t, int ti, long long w, void* stream) {
  const dim3 grid(static_cast<unsigned>(t), sub_tiles<Body>(ti));
  return launch<Body>(k2_tri_kernel<Body>, grid, stream,
                      static_cast<const uint32_t*>(packed),
                      static_cast<const int*>(ibs),
                      static_cast<const int*>(jbs), static_cast<int*>(out), ti,
                      static_cast<int64_t>(w));
}

}  // namespace

extern "C" {

// Output rows per block (of either body): the wrappers' grid-limit check.
int k2_block_rows() { return B1Wgmma::BM; }

// Sub-tiles (blocks) of a ti x ti output tile: the sub-tile ids of K5's units.
int k2_sub_tiles(int ti) { return static_cast<int>(sub_tiles<B1Wgmma>(ti)); }
int k2_sub_tiles_prev(int ti) { return static_cast<int>(sub_tiles<S8Body>(ti)); }

int k2_tri_launch(const void* packed, const void* ibs, const void* jbs,
                  void* out, int t, int ti, long long w, void* stream) {
  return tri_launch<B1Wgmma>(packed, ibs, jbs, out, t, ti, w, stream);
}

int k2_rect_launch(const void* a, const void* b, void* out, long long na,
                   long long nb, long long w, long long ldo, void* stream) {
  return rect_launch<B1Wgmma>(a, b, out, na, nb, w, ldo, stream);
}

// The same on the TMA body, in clusters of `cluster` blocks (kernels/mxu.py's
// rect_cluster(na) says which: 1, or 2 when ceil(na / 128) is even).
// Refuses (cudaErrorInvalidValue, nothing launched) what TMA does not take:
// a base not 16-byte aligned, w % 4 != 0, a row coordinate or a block count
// past int32; and another cluster, an ldo that is odd or leaves no spare
// column for an odd nb.
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

// K2's two kernels on the previous body, for timing beside the above, and
// K5 on it with one block per unit, in the order of units (whose sub-tiles
// are that body's: k2_sub_tiles_prev).
int k2_tri_launch_prev(const void* packed, const void* ibs, const void* jbs,
                       void* out, int t, int ti, long long w, void* stream) {
  return tri_launch<S8Body>(packed, ibs, jbs, out, t, ti, w, stream);
}

int k2_rect_launch_prev(const void* a, const void* b, void* out, long long na,
                        long long nb, long long w, long long ldo,
                        void* stream) {
  return rect_launch<S8Body>(a, b, out, na, nb, w, ldo, stream);
}

int k5_launch_prev(const void* packed, const void* ibs, const void* jbs,
                   const void* gsel, const void* units, void* out, int n_units,
                   int ti, int wk, long long w, void* stream) {
  return launch<S8Body>(k5_kernel<S8Body>, dim3(static_cast<unsigned>(n_units)),
                        stream, static_cast<const uint32_t*>(packed),
                        static_cast<const int*>(ibs),
                        static_cast<const int*>(jbs),
                        static_cast<const int*>(gsel),
                        static_cast<const int4*>(units), static_cast<int*>(out),
                        ti, wk, static_cast<int64_t>(w));
}

}  // extern "C"
