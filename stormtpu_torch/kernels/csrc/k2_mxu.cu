// K2 and K5 for Hopper: exact all-pairs intersection counts of packed bit
// rows on the int8 tensor cores, with the bit unpack fused into the
// operand load.
//
// Replaces the JAX package's Pallas kernels:
//   stormtpu/kernels/mxu.py        _k2_kernel / _k2_kernel_planes
//                                  (triangular tile list, count_tiles_pallas_mxu)
//   stormtpu/kernels/mxu.py        _k2_rect_concat / _k2_rect_planes
//                                  (rectangular grid, _count_block_padded)
//   stormtpu/kernels/clustered.py  _k5_kernel_concat / _k5_kernel_planes
//                                  (work list, count_tiles_worklist)
//
// What it computes: C[i, j] = popcount(A[i] AND B[j]) = sum over bits of
// A_bit * B_bit, i.e. an int8 {0,1} product A·Bᵀ with int32 sums. Products
// are 0/1 and M < 2^31, so int32 accumulation is exact.
//
// What bounds it: the int8 tensor-core rate, 2·pairs·M operations at
// 1,979 TOP/s dense on an H100 SXM. The packed operand is 1/8 of the int8
// operand, so bytes are never the bound at the shapes the main path uses.
//
// What the design does about it:
//  - One block owns a BM x BN sub-tile of output and loops over ALL of its
//    K range inside the block, keeping the int32 sums in registers. Blocks
//    run in any order with no atomics and no cross-block sums; the TPU's
//    sequential K grid axis becomes this loop.
//  - The tile body is two parts: accumulate() adds the product over a word
//    range [k_begin, k_begin + k_len) of rows with stride ld, and
//    store_tile() writes the sums once. K2 calls accumulate() once over all
//    words; K5 calls it once per work item of its slot (one K-group each)
//    and stores once, so a slot needs neither zeroing nor atomics.
//  - Packed uint32 words of A and B row blocks are staged in shared
//    memory; each word is unpacked to int8 {0,1} in registers as it is
//    loaded into an mma.sync.m16n8k32 s8 fragment. The 8x-larger unpacked
//    operand exists neither in global nor in shared memory.
//  - K order: one packed word is one k32 step. Within the word, fragment
//    column c = h*16 + q*4 + e (the PTX A/B fragment layout, q = lane % 4)
//    holds bit q*8 + h*4 + e, so a thread takes one byte of the word and
//    spreads each nibble to four bytes with one multiply. A and B use the
//    same permutation, so the product is unchanged (any consistent K
//    permutation is exact).
//  - Simple first: single-stage shared memory, mma.sync, no TMA, wgmma or
//    warp specialisation yet.
//
// Launch interface: plain C functions taking device pointers and the
// stream as void*, returning cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;             // output rows per block (A rows)
constexpr int BN = 128;             // output columns per block (B rows)
constexpr int KW = 32;              // packed words per shared-memory stage
constexpr int LDS = KW + 4;         // padded row stride in words: 16-B aligned
                                    // rows, conflict-free fragment reads
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;   // 256
constexpr int WM = BM / WARPS_M;    // 64 rows per warp
constexpr int WN = BN / WARPS_N;    // 32 columns per warp
constexpr int MT = WM / 16;         // m16 tiles per warp
constexpr int NT = WN / 8;          // n8 tiles per warp

__device__ __forceinline__ uint32_t spread_nibble(uint32_t nib) {
  // bits b0..b3 of nib -> bytes 0..3 as 0/1 (shifts 0, 7, 14, 21 do not
  // overlap, so the multiply has no carries)
  return (nib * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [0, rows) x words [k0, k0 + KW) of a row-major packed matrix
// (row stride ld words) into shared memory; rows >= rows and words >=
// k_len are zero (exact: zero bits add nothing). ld, k_len and the base
// are multiples of 4 words, so each 16-B vector is wholly in or out.
__device__ __forceinline__ void load_stage(uint32_t* sm,
                                           const uint32_t* __restrict__ g,
                                           int rows, int64_t ld, int k0,
                                           int k_len) {
  constexpr int VEC_PER_ROW = KW / 4;
  for (int v = threadIdx.x; v < BM * VEC_PER_ROW; v += THREADS) {
    const int r = v / VEC_PER_ROW;
    const int c = (v % VEC_PER_ROW) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && k0 + c < k_len) {
      val = *reinterpret_cast<const uint4*>(g + r * ld + k0 + c);
    }
    *reinterpret_cast<uint4*>(sm + r * LDS + c) = val;
  }
}

using Acc = int[MT][NT][4];

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// acc[r, c] += popcount(a[r] & b[c]) over words [0, k_len) of a and b
// (each already offset to its first word), r < a_rows, c < b_rows.
__device__ __forceinline__ void accumulate(Acc& acc,
                                           const uint32_t* __restrict__ a,
                                           int a_rows,
                                           const uint32_t* __restrict__ b,
                                           int b_rows, int64_t ld,
                                           int k_len) {
  __shared__ __align__(16) uint32_t sa[BM * LDS];
  __shared__ __align__(16) uint32_t sb[BN * LDS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;             // fragment row (A) / column (B)
  const int shift = (lane & 3) * 8;      // this thread's byte of each word
  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;

  for (int k0 = 0; k0 < k_len; k0 += KW) {
    load_stage(sa, a, a_rows, ld, k0, k_len);
    load_stage(sb, b, b_rows, ld, k0, k_len);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KW; ++kk) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint32_t lo = sa[(wm + i * 16 + grp) * LDS + kk] >> shift;
        const uint32_t hi = sa[(wm + i * 16 + grp + 8) * LDS + kk] >> shift;
        af[i][0] = spread_nibble(lo & 0xFu);          // row grp,   h = 0
        af[i][1] = spread_nibble(hi & 0xFu);          // row grp+8, h = 0
        af[i][2] = spread_nibble((lo >> 4) & 0xFu);   // row grp,   h = 1
        af[i][3] = spread_nibble((hi >> 4) & 0xFu);   // row grp+8, h = 1
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
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }
}

// out[r, c] = acc[r, c] for r < a_rows, c < b_rows; out has row stride ldo.
__device__ __forceinline__ void store_tile(const Acc& acc, int a_rows,
                                           int b_rows, int* __restrict__ out,
                                           int64_t ldo) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;
  // accumulator layout: c0, c1 at (grp, 2q + {0,1}); c2, c3 at row grp + 8
  const int q2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r0 = wm + i * 16 + grp;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = wn + j * 8 + q2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + h * 8;
        if (r < a_rows) {
          if (c < b_rows) out[r * ldo + c] = acc[i][j][2 * h];
          if (c + 1 < b_rows) out[r * ldo + c + 1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

// One BM x BN count tile over all w words: out[r, c] = popcount(a[r] & b[c]).
__device__ __forceinline__ void count_tile(const uint32_t* __restrict__ a,
                                           int a_rows,
                                           const uint32_t* __restrict__ b,
                                           int b_rows, int64_t w,
                                           int* __restrict__ out, int64_t ldo) {
  Acc acc;
  zero_acc(acc);
  accumulate(acc, a, a_rows, b, b_rows, w, static_cast<int>(w));
  store_tile(acc, a_rows, b_rows, out, ldo);
}

// Triangular form: blockIdx.x = tile pair t, blockIdx.y = BM x BN sub-tile
// of the TI x TI output tile. Tile t counts row block ibs[t] against
// jbs[t] (the same rows when ibs[t] == jbs[t]).
__global__ void __launch_bounds__(THREADS)
    k2_tri_kernel(const uint32_t* __restrict__ packed,
                  const int* __restrict__ ibs, const int* __restrict__ jbs,
                  int* __restrict__ out, int ti, int64_t w) {
  const int64_t t = blockIdx.x;
  const int nsub = (ti + BN - 1) / BN;
  const int si = blockIdx.y / nsub;
  const int sj = blockIdx.y % nsub;
  const int64_t row_a = static_cast<int64_t>(ibs[t]) * ti + si * BM;
  const int64_t row_b = static_cast<int64_t>(jbs[t]) * ti + sj * BN;
  count_tile(packed + row_a * w, min(BM, ti - si * BM), packed + row_b * w,
             min(BN, ti - sj * BN), w,
             out + t * ti * ti + static_cast<int64_t>(si) * BM * ti + sj * BN,
             ti);
}

// Rectangular form: blockIdx.y = BM-row block of A, blockIdx.x = BN-row
// block of B; out is [na, nb] row-major.
__global__ void __launch_bounds__(THREADS)
    k2_rect_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, int* __restrict__ out,
                   int64_t na, int64_t nb, int64_t w) {
  const int64_t ra = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t rb = static_cast<int64_t>(blockIdx.x) * BN;
  count_tile(a + ra * w, static_cast<int>(min(static_cast<int64_t>(BM), na - ra)),
             b + rb * w, static_cast<int>(min(static_cast<int64_t>(BN), nb - rb)),
             w, out + ra * nb + rb, nb);
}

// Work-list form: blockIdx.x = output slot s, blockIdx.y = BM x BN
// sub-tile of its TI x TI tile. Items [slot_start[s], slot_start[s+1])
// are the slot's (sorted by slot); item t adds row blocks ibs[t] x jbs[t]
// over K-group gsel[t] (words [gsel*wk, gsel*wk + wk) of a row of w words).
// A slot with no items stores zeros.
__global__ void __launch_bounds__(THREADS)
    k5_kernel(const uint32_t* __restrict__ packed,
              const int* __restrict__ ibs, const int* __restrict__ jbs,
              const int* __restrict__ gsel,
              const int* __restrict__ slot_start, int* __restrict__ out,
              int ti, int wk, int64_t w) {
  const int64_t s = blockIdx.x;
  const int nsub = (ti + BN - 1) / BN;
  const int si = blockIdx.y / nsub;
  const int sj = blockIdx.y % nsub;
  const int a_rows = min(BM, ti - si * BM);
  const int b_rows = min(BN, ti - sj * BN);
  Acc acc;
  zero_acc(acc);
  const int end = slot_start[s + 1];
  for (int t = slot_start[s]; t < end; ++t) {
    const int64_t k_begin = static_cast<int64_t>(gsel[t]) * wk;
    const int64_t row_a = static_cast<int64_t>(ibs[t]) * ti + si * BM;
    const int64_t row_b = static_cast<int64_t>(jbs[t]) * ti + sj * BN;
    accumulate(acc, packed + row_a * w + k_begin, a_rows,
               packed + row_b * w + k_begin, b_rows, w, wk);
  }
  store_tile(acc, a_rows, b_rows,
             out + s * ti * ti + static_cast<int64_t>(si) * BM * ti + sj * BN,
             ti);
}

}  // namespace

extern "C" {

// Sub-tile edge the wrappers may rely on for grid limits.
int k2_block_rows() { return BM; }

// packed: int32/uint32 [n_pad, w]; ibs, jbs: int32 [t]; out: int32 [t, ti, ti].
int k2_tri_launch(const void* packed, const void* ibs, const void* jbs,
                  void* out, int t, int ti, long long w, void* stream) {
  const int nsub = (ti + BN - 1) / BN;
  const dim3 grid(static_cast<unsigned>(t), static_cast<unsigned>(nsub * nsub));
  k2_tri_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int*>(ibs),
      static_cast<const int*>(jbs), static_cast<int*>(out), ti, w);
  return static_cast<int>(cudaGetLastError());
}

// a: [na, w], b: [nb, w] words; out: int32 [na, nb].
int k2_rect_launch(const void* a, const void* b, void* out, long long na,
                   long long nb, long long w, void* stream) {
  const dim3 grid(static_cast<unsigned>((nb + BN - 1) / BN),
                  static_cast<unsigned>((na + BM - 1) / BM));
  k2_rect_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int*>(out), na, nb, w);
  return static_cast<int>(cudaGetLastError());
}

// packed: int32/uint32 [n_pad, w]; ibs, jbs, gsel: int32 [t_work];
// slot_start: int32 [n_slots + 1]; out: int32 [n_slots, ti, ti].
int k5_launch(const void* packed, const void* ibs, const void* jbs,
              const void* gsel, const void* slot_start, void* out,
              int n_slots, int ti, int wk, long long w, void* stream) {
  const int nsub = (ti + BN - 1) / BN;
  const dim3 grid(static_cast<unsigned>(n_slots),
                  static_cast<unsigned>(nsub * nsub));
  k5_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int*>(ibs),
      static_cast<const int*>(jbs), static_cast<const int*>(gsel),
      static_cast<const int*>(slot_start), static_cast<int*>(out), ti, wk, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
