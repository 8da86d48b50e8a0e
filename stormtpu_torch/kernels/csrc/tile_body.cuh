// The tile body that K2-tri, K5 and K1 share: exact popcount(A_row AND B_row)
// sums of packed bit rows on the tensor cores' binary product, straight
// from the packed words, with its cp.async ring and the launch helper.
//
// A kernel hands the body a "source": a flat list of chunks of KW = 32
// words of an A row block and a B row block (chunks(), chunk(f, ...), and
// SPLIT_B: whether the two halves of the B rows come from two bases). The
// body adds every chunk's products into the sums a block keeps in
// registers. Any consistent permutation of the K axis is exact, so the body
// lays bits out as its instruction likes, the same way for A and B.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace tile {

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

template <int N>
__device__ __forceinline__ void zero_frags(int (&acc)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0;
}

// ----------------------------- the tile body: binary product by warpgroups
// 128 x 256 a block: two warpgroups, each a 64 x 256 wgmma.m64n256k256 .b1
// .and.popc whose operands come straight from shared memory, so no fragment
// passes through registers. A stage holds KW = 32 words (128 bytes, four K
// steps) of every A and B row in the 128-byte swizzle the matrix descriptors
// name: 16-byte vector c of row r lies at r * 128 + ((c ^ (r % 8)) * 16).
// All threads fill the ring with cp.async, AHEAD = STAGES - 2 chunks ahead:
// one wgmma group stays in flight while the next is issued, so a stage is
// free to refill only two chunks after its products were issued. Four
// stages are 192 KiB: one block an SM.
struct B1Wgmma {
  static constexpr int BM = 128;
  static constexpr int BN = 256;
  static constexpr int THREADS = 256;
  static constexpr int MIN_BLOCKS = 1;  // blocks an SM to compile for
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

  // One chunk into stage `pos % STAGES`: a_rows rows from pa, b_rows from pb
  // (rows and words past them zero).
  static __device__ __forceinline__ void load_stage(uint32_t* smem, int pos,
                                                    const uint32_t* pa,
                                                    const uint32_t* pb,
                                                    int a_rows, int b_rows,
                                                    int64_t ld, int valid) {
    uint32_t* st = smem + (pos % STAGES) * STAGE_WORDS;
    load_rows<BM>(st, pa, a_rows, ld, valid);
    load_rows<BN>(st + BM * ROW_WORDS, pb, b_rows, ld, valid);
  }

  // Chunk f of src (nothing past the last) and one cp.async group either
  // way. A SPLIT_B source fills each half of the B rows from its own base,
  // b_rows of the lower half and src.hi_rows of the upper.
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
      if constexpr (Source::SPLIT_B) {
        uint32_t* st = smem + (f % STAGES) * STAGE_WORDS;
        load_rows<BM>(st, pa, a_rows, ld, valid);
        st += BM * ROW_WORDS;
        load_rows<BN / 2>(st, pb, b_rows, ld, valid);
        load_rows<BN / 2>(st + (BN / 2) * ROW_WORDS, src.hi(pb), src.hi_rows,
                          ld, valid);
      } else {
        load_stage(smem, f, pa, pb, a_rows, b_rows, ld, valid);
      }
    }
    cp_async_commit();
  }

  // The oldest chunk in flight has landed, for every thread, and every
  // product group but the newest is done.
  static __device__ __forceinline__ void wait_chunk() {
    cp_async_wait<AHEAD - 1>();  // this thread's part
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's part
  }

  // Issue the products of the chunk in stage `pos % STAGES` as one group.
  static __device__ __forceinline__ void issue(Acc& acc, uint32_t* smem,
                                               int pos) {
    const uint32_t group_rows = (threadIdx.x >> 7) * 64;  // this warpgroup's A rows
    const uint32_t st = smem_u32(smem + (pos % STAGES) * STAGE_WORDS);
    const uint64_t da = wgmma_desc_sw128(st + group_rows * 128);
    const uint64_t db = wgmma_desc_sw128(st + BM * 128);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KW / 8; ++k)  // 32 bytes a K step: 2 descriptor units
      wgmma_b1_n256(acc.v, da + 2 * k, db + 2 * k);
    wgmma_commit();
  }

  template <class Source>
  static __device__ __forceinline__ void accumulate(Acc& acc, const Source& src,
                                                    int a_rows, int b_rows,
                                                    int64_t ld,
                                                    uint32_t* smem) {
    const int n = src.chunks();
#pragma unroll
    for (int s = 0; s < AHEAD; ++s)
      load_chunk(smem, src, s, n, a_rows, b_rows, ld);
    for (int f = 0; f < n; ++f) {
      wait_chunk();  // chunk f has landed; every group before f - 1 is done
      load_chunk(smem, src, f + AHEAD, n, a_rows, b_rows, ld);
      issue(acc, smem, f);
      wgmma_wait<1>();  // group f - 1 is done: its stage may be refilled
    }
    cp_async_wait<0>();
    wgmma_wait<0>();
  }

  // m64nN accumulator layout: warp w of the group owns rows 16w..16w+15;
  // v[4j], v[4j+1] at (row grp, columns 8j + 2q + {0,1}); v[4j+2], v[4j+3]
  // at row grp + 8. Stores go out as int2 at even columns: the callers'
  // rows are 8-byte aligned (an even ldo) and a column count is even, or
  // the row pitch has a spare column past it (K2-rect's ragged B edge).
  //
  // out[r, c] = acc[r, c] for r < a_rows, c < b_rows; row stride ldo.
  static __device__ __forceinline__ void store(const Acc& acc, int a_rows,
                                               int b_rows, int* out,
                                               int64_t ldo) {
    store_split(acc, a_rows, b_rows, b_rows - BN / 2, out, out + BN / 2, ldo);
  }

  // The lower half of the columns to out_lo (cols_lo of them) and the upper
  // half to out_hi (cols_hi, <= 0: none): two output tiles for one block.
  static __device__ __forceinline__ void store_split(const Acc& acc,
                                                     int a_rows, int cols_lo,
                                                     int cols_hi, int* out_lo,
                                                     int* out_hi,
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
          const bool hi = j >= BN / 16;
          const int c = (hi ? j - BN / 16 : j) * 8 + q2;
          if (c < (hi ? cols_hi : cols_lo)) {
            *reinterpret_cast<int2*>((hi ? out_hi : out_lo) + r * ldo + c) =
                make_int2(acc.v[4 * j + 2 * h], acc.v[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
};

// K2-tri's source: rows a[0..], b[0..] (row stride ld) over words [0, k_len).
struct RowPairSource {
  static constexpr bool SPLIT_B = false;
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

}  // namespace tile
