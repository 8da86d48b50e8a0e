// K2 and K5 for Hopper: exact all-pairs intersection counts of packed bit
// rows on the tensor cores' binary product, straight from the packed words.
//
// Replaces the JAX package's Pallas kernels:
//   stormtpu/kernels/mxu.py        _k2_kernel / _k2_kernel_planes
//                                  (triangular tile list, count_tiles_pallas_mxu)
//   stormtpu/kernels/mxu.py        _k2_rect_concat / _k2_rect_planes
//                                  (rectangular grid, _count_block_padded)
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
//    row-block pair over all words; K5's is its slot's work items one after
//    another (one K-group each), so the load pipeline runs across a slot's
//    items and the slot is stored once: no zeroing, no atomics.
//  - Chunks arrive through a ring of shared-memory stages filled by
//    cp.async (16 bytes a thread) ahead of the products. cp.async's source
//    size zero-fills rows past the tile and words past the K range (exact:
//    zero bits add nothing), so one loader serves every tile size and K5's
//    K-groups; a tensor map per operand (TMA) would save the address
//    arithmetic but not the L2 traffic that sets the pace.
//  - The tile body (B1Wgmma) is 128 x 256 a block, the widest tile whose
//    sums fit the registers: two warpgroups, each issuing
//    wgmma.m64n256k256 with both operands read from shared memory through
//    matrix descriptors, so no fragment passes through registers and the
//    threads only issue loads and products. The stage layout is the
//    128-byte swizzle the descriptors name.
//  - Any consistent permutation of the K axis is exact, so a body lays
//    bits out as its instruction likes, the same way for A and B.
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

#include "wgmma.cuh"

namespace {

constexpr int KW = 32;  // packed words of a row per chunk (one stage)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- K sources
// K2: rows a[0..], b[0..] (row stride ld) over words [0, k_len).
struct RowPairSource {
  const uint32_t* a;
  const uint32_t* b;
  int k_len;
  __device__ int chunks() const { return (k_len + KW - 1) / KW; }
  __device__ void chunk(int f, const uint32_t*& pa, const uint32_t*& pb,
                        int& valid) const {
    pa = a + f * KW;
    pb = b + f * KW;
    valid = k_len - f * KW;
  }
};

// K5: items [t0, t0 + n_items) of the work list; item t is row blocks
// ibs[t] x jbs[t] (rows off_a, off_b into the tile) over K-group gsel[t]:
// words [gsel*wk, gsel*wk + wk) of a row of w words.
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

// out[r, c] = acc[r, c] for r < a_rows, c < b_rows (b_rows is even); out has
// row stride ldo. m16n8 accumulator layout: c0, c1 at (grp, 2q + {0,1});
// c2, c3 at row grp + 8.
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


// ----------------------------- the tile body: binary product by warpgroups
// 128 x 256 a block: two warpgroups, each a 64 x 256 wgmma.m64n256k256 .b1
// .and.popc whose operands come straight from shared memory, so no fragment
// passes through registers. A stage holds KW = 32 words (128 bytes, four K
// steps) of every A and B row in the 128-byte swizzle the matrix descriptors
// name: 16-byte vector c of row r lies at r * 128 + ((c ^ (r % 8)) * 16).
// All threads fill the ring with cp.async, AHEAD = STAGES - 2 chunks ahead:
// one wgmma group stays in flight while the next is issued, so a stage is
// free to refill only two chunks after its products were issued.
struct B1Wgmma {
  static constexpr int BM = 128;
  static constexpr int BN = 256;
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 4;
  static constexpr int AHEAD = STAGES - 2;
  static constexpr int ROW_WORDS = KW;  // 128 bytes a row
  static constexpr int STAGE_WORDS = (BM + BN) * ROW_WORDS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_WORDS * 4;

  struct Acc {
    int v[BN / 2];
  };

  template <int ROWS>
  static __device__ __forceinline__ void load_rows(uint32_t* tile,
                                                   const uint32_t* g, int rows,
                                                   int64_t ld, int valid) {
    constexpr int VEC = KW / 4;  // 8 vectors of 16 bytes a row
    for (int v = threadIdx.x; v < ROWS * VEC; v += THREADS) {
      const int r = v / VEC;
      const int c = v % VEC;
      const bool ok = r < rows && c * 4 < valid;
      const uint32_t* src = ok ? g + r * ld + c * 4 : g;
      uint32_t* dst = tile + r * ROW_WORDS + ((c ^ (r & 7)) * 4);
      cp_async16(smem_u32(dst), src, ok ? 16 : 0);
    }
  }

  template <class Source>
  static __device__ __forceinline__ void load_chunk(uint32_t* smem,
                                                    const Source& src, int f,
                                                    int n, int a_rows,
                                                    int b_rows, int64_t ld) {
    if (f < n) {
      const uint32_t* pa;
      const uint32_t* pb;
      int valid;
      src.chunk(f, pa, pb, valid);
      uint32_t* st = smem + (f % STAGES) * STAGE_WORDS;
      load_rows<BM>(st, pa, a_rows, ld, valid);
      load_rows<BN>(st + BM * ROW_WORDS, pb, b_rows, ld, valid);
    }
    cp_async_commit();
  }

  template <class Source>
  static __device__ __forceinline__ void accumulate(Acc& acc, const Source& src,
                                                    int a_rows, int b_rows,
                                                    int64_t ld,
                                                    uint32_t* smem) {
    const int n = src.chunks();
    const uint32_t group_rows = (threadIdx.x >> 7) * 64;  // this warpgroup's A rows
#pragma unroll
    for (int s = 0; s < AHEAD; ++s)
      load_chunk(smem, src, s, n, a_rows, b_rows, ld);
    for (int f = 0; f < n; ++f) {
      cp_async_wait<AHEAD - 1>();  // chunk f has landed (this thread's part)
      // cp.async wrote through the generic proxy; wgmma reads through the
      // async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // everyone's part; every group before f - 1 is done
      load_chunk(smem, src, f + AHEAD, n, a_rows, b_rows, ld);
      const uint32_t st = smem_u32(smem + (f % STAGES) * STAGE_WORDS);
      const uint64_t da = wgmma_desc_sw128(st + group_rows * 128);
      const uint64_t db = wgmma_desc_sw128(st + BM * 128);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KW / 8; ++k)  // 32 bytes a K step: 2 descriptor units
        wgmma_b1_n256(acc.v, da + 2 * k, db + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();  // group f - 1 is done: its stage may be refilled
    }
    cp_async_wait<0>();
    wgmma_wait<0>();
  }

  // m64nN accumulator layout: warp w of the group owns rows 16w..16w+15;
  // v[4j], v[4j+1] at (row grp, columns 8j + 2q + {0,1}); v[4j+2], v[4j+3]
  // at row grp + 8.
  static __device__ __forceinline__ void store(const Acc& acc, int a_rows,
                                               int b_rows, int* out,
                                               int64_t ldo) {
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
    const int q2 = (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * 8;
      if (r < a_rows) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = j * 8 + q2;
          if (c < b_rows) {
            *reinterpret_cast<int2*>(out + r * ldo + c) =
                make_int2(acc.v[4 * j + 2 * h], acc.v[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
};

static_assert(S8Body::BM == B1Wgmma::BM, "k2_block_rows() speaks for both");

template <int N>
__device__ __forceinline__ void zero_frags(int (&acc)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0;
}

template <int MT, int NT>
__device__ __forceinline__ void zero_frags(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// Triangular form: blockIdx.x = tile pair t, blockIdx.y = BM x BN sub-tile
// of the TI x TI output tile. Tile t counts row block ibs[t] against
// jbs[t] (the same rows when ibs[t] == jbs[t]).
template <class Body>
__global__ void __launch_bounds__(Body::THREADS, 1)
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

// Rectangular form: blockIdx.y = BM-row block of A, blockIdx.x = BN-row
// block of B; out is [na, nb] row-major.
template <class Body>
__global__ void __launch_bounds__(Body::THREADS, 1)
    k2_rect_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, int* __restrict__ out,
                   int64_t na, int64_t nb, int64_t w) {
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
  Body::store(acc, a_rows, b_rows, out + ra * nb + rb, nb);
}

// Work-list form: blockIdx.x = output slot s, blockIdx.y = BM x BN
// sub-tile of its TI x TI tile. Items [slot_start[s], slot_start[s+1])
// are the slot's (sorted by slot). A slot with no items stores zeros.
template <class Body>
__global__ void __launch_bounds__(Body::THREADS, 1)
    k5_kernel(const uint32_t* __restrict__ packed,
              const int* __restrict__ ibs, const int* __restrict__ jbs,
              const int* __restrict__ gsel,
              const int* __restrict__ slot_start, int* __restrict__ out,
              int ti, int wk, int64_t w) {
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  constexpr int BM = Body::BM, BN = Body::BN;
  const int64_t s = blockIdx.x;
  const int nsub_n = (ti + BN - 1) / BN;
  const int si = blockIdx.y / nsub_n;
  const int sj = blockIdx.y % nsub_n;
  const int a_rows = min(BM, ti - si * BM);
  const int b_rows = min(BN, ti - sj * BN);
  typename Body::Acc acc;
  zero_frags(acc.v);
  const int t0 = slot_start[s];
  const WorkListSource src{packed, ibs, jbs, gsel, t0, slot_start[s + 1] - t0,
                           ti, si * BM, sj * BN, wk, w};
  Body::accumulate(acc, src, a_rows, b_rows, w, smem_dyn);
  Body::store(acc, a_rows, b_rows,
              out + s * ti * ti + static_cast<int64_t>(si) * BM * ti + sj * BN,
              ti);
}

template <class Body, class... KArgs, class... Args>
int launch(void (*kernel)(KArgs...), dim3 grid, void* stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, Body::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, Body::THREADS, Body::SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class Body>
unsigned sub_tiles(int ti) {
  return static_cast<unsigned>(((ti + Body::BM - 1) / Body::BM) *
                               ((ti + Body::BN - 1) / Body::BN));
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

// a: [na, w], b: [nb, w] words; out: int32 [na, nb].
template <class Body>
int rect_launch(const void* a, const void* b, void* out, long long na,
                long long nb, long long w, void* stream) {
  const dim3 grid(static_cast<unsigned>((nb + Body::BN - 1) / Body::BN),
                  static_cast<unsigned>((na + Body::BM - 1) / Body::BM));
  return launch<Body>(k2_rect_kernel<Body>, grid, stream,
                      static_cast<const uint32_t*>(a),
                      static_cast<const uint32_t*>(b), static_cast<int*>(out),
                      static_cast<int64_t>(na), static_cast<int64_t>(nb),
                      static_cast<int64_t>(w));
}

// packed: int32/uint32 [n_pad, w]; ibs, jbs, gsel: int32 [t_work];
// slot_start: int32 [n_slots + 1]; out: int32 [n_slots, ti, ti].
template <class Body>
int worklist_launch(const void* packed, const void* ibs, const void* jbs,
                    const void* gsel, const void* slot_start, void* out,
                    int n_slots, int ti, int wk, long long w, void* stream) {
  const dim3 grid(static_cast<unsigned>(n_slots), sub_tiles<Body>(ti));
  return launch<Body>(k5_kernel<Body>, grid, stream,
                      static_cast<const uint32_t*>(packed),
                      static_cast<const int*>(ibs),
                      static_cast<const int*>(jbs),
                      static_cast<const int*>(gsel),
                      static_cast<const int*>(slot_start),
                      static_cast<int*>(out), ti, wk, static_cast<int64_t>(w));
}

}  // namespace

extern "C" {

// Output rows per block (of either body): the wrappers' grid-limit check.
int k2_block_rows() { return B1Wgmma::BM; }

int k2_tri_launch(const void* packed, const void* ibs, const void* jbs,
                  void* out, int t, int ti, long long w, void* stream) {
  return tri_launch<B1Wgmma>(packed, ibs, jbs, out, t, ti, w, stream);
}

int k2_rect_launch(const void* a, const void* b, void* out, long long na,
                   long long nb, long long w, void* stream) {
  return rect_launch<B1Wgmma>(a, b, out, na, nb, w, stream);
}

int k5_launch(const void* packed, const void* ibs, const void* jbs,
              const void* gsel, const void* slot_start, void* out,
              int n_slots, int ti, int wk, long long w, void* stream) {
  return worklist_launch<B1Wgmma>(packed, ibs, jbs, gsel, slot_start, out,
                                  n_slots, ti, wk, w, stream);
}

// The same three on the previous body, for timing beside the above.
int k2_tri_launch_prev(const void* packed, const void* ibs, const void* jbs,
                       void* out, int t, int ti, long long w, void* stream) {
  return tri_launch<S8Body>(packed, ibs, jbs, out, t, ti, w, stream);
}

int k2_rect_launch_prev(const void* a, const void* b, void* out, long long na,
                        long long nb, long long w, void* stream) {
  return rect_launch<S8Body>(a, b, out, na, nb, w, stream);
}

int k5_launch_prev(const void* packed, const void* ibs, const void* jbs,
                   const void* gsel, const void* slot_start, void* out,
                   int n_slots, int ti, int wk, long long w, void* stream) {
  return worklist_launch<S8Body>(packed, ibs, jbs, gsel, slot_start, out,
                                 n_slots, ti, wk, w, stream);
}

}  // extern "C"
