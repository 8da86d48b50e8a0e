// The tile body of K2-topk and K2-hist (csrc/k2_epilogue.cu) and of K2-rect
// (csrc/k2_mxu.cu): the sums of tile::B1Wgmma (csrc/tile_body.cuh), exact
// popcount(A_row AND B_row) of packed bit rows on the tensor cores' binary
// product, with a main loop built for Hopper's copy engine instead of the
// threads' cp.async.
//
// Same block and same sums: 128 x 256 a block, two consumer warpgroups each
// issuing wgmma.m64n256k256 .b1 .and.popc on its 64 A rows against the 256
// B rows, both operands read from shared memory in the 128-byte swizzle the
// matrix descriptors name; the accumulators keep B1Wgmma's layout
// (tile_body.cuh, B1Wgmma::store_split), so an epilogue written against it
// runs on either body.
//
// What bounds it: the b1 wgmma rate, if the operands arrive in time. A
// chunk is 32 words of every A and B row (48 KiB) for 6.7e7 bit operations,
// so 132 SMs at the measured b1 rate need about 11.5 TB/s of operand from
// L2 into shared memory; B1Wgmma takes 44-48% of that rate.
//
// What the design does about it:
//  - TMA loads. One tensor map describes the packed operand ([rows, w]
//    uint32, a box of 32 words x 128 rows, CU_TENSOR_MAP_SWIZZLE_128B, whose
//    layout is the one wgmma_desc_sw128 names: vector c of row r at
//    r * 128 + ((c ^ r % 8) * 16) from a 1024-byte-aligned stage). One
//    elected thread issues a chunk's boxes; the hardware computes the
//    addresses and fills zeros outside the tensor (the K tail, rows past
//    the last), where B1Wgmma's threads masked their copies.
//  - Warp specialisation. A producer warpgroup (setmaxnreg.dec to 40
//    registers) keeps the ring of STAGES chunks full; the two consumer
//    warpgroups (setmaxnreg.inc to 232) only wait and issue products. Each
//    stage has a full mbarrier (the producer's arrival and the stage's
//    bytes) and an empty one (one arrival of each consumer warp once the
//    product group that read the stage has retired). No block-wide barrier
//    and no copy instruction sits in the consumers' loop.
//  - A cluster of two over a tile's two sub-tile rows (CLUSTER = 2). The
//    blocks of sub-tiles (2q, 2q + 1) of one column block read the same 256
//    B rows. Each loads its own A box and one 128-row half of the B rows,
//    multicast into both blocks' stages: an SM takes 32 KiB a chunk from L2
//    instead of 48. Each block's full barrier expects the 48 KiB that land
//    in it. A stage's empty barrier counts the consumer warps of both
//    blocks, because the next refill writes into both; a consumer warp
//    arrives on each block's barrier (mapa and a remote arrive).
//  - The shape rule. A tile of ti rows has nsub_m = ceil(ti / 128) sub-tile
//    rows. An even nsub_m launches clusters of two (blockIdx.y = sj * nsub_m
//    + si pairs si = 2q, 2q + 1 of one sj); an odd nsub_m (ti <= 128 gives
//    one) launches clusters of one, whose block loads all of its B rows.
//    Both are instances of one template; neither is a fallback for the
//    other (k2_epilogue.cu's launchers). K2-rect lays its blocks out the
//    same way over its A sub-tile rows (k2_mxu.cu), and reads A and B
//    through a map each (produce's two-map form).
//
// Host side: the launcher encodes the map with cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (no link against the
// driver library), and passes it by value as a __grid_constant__ parameter.
//
// On the card this loop holds K2-hist at 77-87% of the b1 bound, where
// B1Wgmma's loop held it at 40-49% (PERF.md, scripts/torch_epilogue_ab.py).
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "tile_body.cuh"

namespace tile {

// ------------------------------------------------------- barriers and copies
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// The producer's arrival, announcing the bytes the stage's copies bring.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One arrival on the barrier at this block's offset `bar` in cluster block
// `cta` (this one included). Default semantics (release at CTA scope): the
// arrival only has to follow this warp's retired wgmma reads. A release at
// cluster scope puts MEMBAR.ALL.GPU and ERRBAR before every arrival, which
// on the card cost more than the multicast saved.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Until the phase of parity `parity` of barrier `bar` has completed. Nothing
// else sits in the loop: a trap on a timeout there made the compiler retire
// every product group before each wait (ptxas C7515, C7517).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Box (col, row) of `map` into this block's shared memory at dst, completing
// its bytes on barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// The same box into dst of every cluster block in `mask`, completing its
// bytes on each one's barrier at offset bar.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int col, int row,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// Named barrier ID, complete when THREADS threads of the block have reached it.
template <int ID, int THREADS>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ------------------------------------------------------------------ the body
// Threads 0..255 are the consumers (warpgroup g takes A rows 64g..64g+63,
// as in B1Wgmma), threads 256..383 the producer. Shared memory: STAGES
// stages of 48 KiB (A's 128 rows, then B's 256, 128 bytes a row), then the
// STAGES full and STAGES empty barriers.
template <int CLUSTER>
struct B1WgmmaTma {
  static_assert(CLUSTER == 1 || CLUSTER == 2, "a block alone, or a pair sharing B rows");
  static constexpr int BM = 128;
  static constexpr int BN = 256;
  static constexpr int CONSUMERS = 256;
  static constexpr int CONSUMER_WARPS = CONSUMERS / 32;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int STAGES = 4;
  static constexpr int ROW_BYTES = KW * 4;
  static constexpr int BOX_ROWS = 128;  // a box: KW words x 128 rows
  static constexpr int BOX_BYTES = BOX_ROWS * ROW_BYTES;
  static constexpr int STAGE_BYTES = (BM + BN) * ROW_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES = RING_BYTES + 2 * STAGES * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <= 65536,
                "the rebalanced registers fit the SM");
  static_assert(BM == BOX_ROWS && BN == 2 * BOX_ROWS, "A is one box, B two");

  // B1Wgmma's accumulators, so that its store writes these sums too
  using Acc = B1Wgmma::Acc;
  static_assert(B1Wgmma::BM == BM && B1Wgmma::BN == BN, "one accumulator layout");

  static __device__ __forceinline__ uint32_t full_bar(uint32_t base, int s) {
    return base + RING_BYTES + s * 8;
  }
  static __device__ __forceinline__ uint32_t empty_bar(uint32_t base, int s) {
    return base + RING_BYTES + (STAGES + s) * 8;
  }

  static __device__ __forceinline__ bool is_producer() {
    return threadIdx.x >= CONSUMERS;
  }

  // The barriers, initialised by thread 0 and seen by the whole cluster
  // before any copy or remote arrival targets them.
  static __device__ __forceinline__ void init(uint32_t* smem) {
    if (threadIdx.x == 0) {
      const uint32_t base = smem_u32(smem);
#pragma unroll
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full_bar(base, s), 1);
        mbar_init(empty_bar(base, s), CLUSTER * CONSUMER_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync();
  }

  // The producer warpgroup's whole part: n chunks of A rows row_a.. and B
  // rows row_b.. of `map`, then the exit barrier.
  static __device__ __forceinline__ void produce(const CUtensorMap* map, uint32_t* smem,
                                                 int n, int row_a, int row_b) {
    produce(map, map, smem, n, row_a, row_b);
  }

  // The same with A's rows from map_a and B's from map_b.
  static __device__ __forceinline__ void produce(const CUtensorMap* map_a,
                                                 const CUtensorMap* map_b, uint32_t* smem,
                                                 int n, int row_a, int row_b) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_a))
                   : "memory");
      if (map_b != map_a)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_b))
                     : "memory");
      const uint32_t base = smem_u32(smem);
      const uint32_t half = CLUSTER == 2 ? cluster_rank() : 0u;
      for (int f = 0; f < n; ++f) {
        const int s = f % STAGES;
        // round f / STAGES refills the stage after the consumers of every
        // block it lands in released round f / STAGES - 1
        if (f >= STAGES) mbar_wait(empty_bar(base, s), ((f / STAGES) + 1) & 1);
        const uint32_t st = base + s * STAGE_BYTES;
        const uint32_t bar = full_bar(base, s);
        const int col = f * KW;
        mbar_arrive_expect_tx(bar, STAGE_BYTES);
        tma_load(st, map_a, bar, col, row_a);
        if constexpr (CLUSTER == 2) {
          const uint32_t off = (BM + half * BOX_ROWS) * ROW_BYTES;
          tma_load_multicast(st + off, map_b, bar, col, row_b + half * BOX_ROWS, 0x3);
        } else {
          tma_load(st + BM * ROW_BYTES, map_b, bar, col, row_b);
          tma_load(st + BM * ROW_BYTES + BOX_BYTES, map_b, bar, col, row_b + BOX_ROWS);
        }
      }
    }
    cluster_sync();  // no block exits while a remote arrival may target it
  }

  // The consumers' main loop: the sums of n chunks into acc. On return
  // every product group has retired and both consumer warpgroups are done
  // with the ring (the named barrier below), so the caller may overwrite
  // the stages: nothing lands in them after this block's last full wait.
  static __device__ __forceinline__ void consume(Acc& acc, uint32_t* smem, int n) {
    setmaxnreg_inc<CONSUMER_REGS>();
    zero_frags(acc.v);
    const uint32_t base = smem_u32(smem);
    const uint32_t group_rows = (threadIdx.x >> 7) * 64;  // this warpgroup's A rows
    for (int f = 0; f < n; ++f) {
      const int s = f % STAGES;
      mbar_wait(full_bar(base, s), (f / STAGES) & 1);
      const uint32_t st = base + s * STAGE_BYTES;
      const uint64_t da = wgmma_desc_sw128(st + group_rows * ROW_BYTES);
      const uint64_t db = wgmma_desc_sw128(st + BM * ROW_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KW / 8; ++k)  // 32 bytes a K step: 2 descriptor units
        wgmma_b1_n256(acc.v, da + 2 * k, db + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();  // the group of chunk f - 1 has retired
      if (f > 0) release(base, (f - 1) % STAGES);
    }
    wgmma_wait<0>();
    consumers_sync();
  }

  // This warp is done reading stage s: one arrival on the stage's empty
  // barrier of every block the next refill writes into.
  static __device__ __forceinline__ void release(uint32_t base, int s) {
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int c = 0; c < CLUSTER; ++c) mbar_arrive_cluster(empty_bar(base, s), c);
    }
  }

  // Named barrier 1 over the 256 consumer threads (the producer is not in it).
  static __device__ __forceinline__ void consumers_sync() { named_sync<1, CONSUMERS>(); }

  // The consumers' exit: the cluster barrier the producer waits at.
  static __device__ __forceinline__ void finish() { cluster_sync(); }
};

// cuTensorMapEncodeTiled's signature (cuda.h), reached through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a packed operand: `rows` rows of w uint32 words at `packed`
// (16-byte aligned, w % 4 == 0: TMA's strides are multiples of 16 bytes),
// boxes of KW words x 128 rows, 128-byte swizzle, zeros outside. Returns a
// CUDA error code (0: encoded).
inline int encode_operand_map(CUtensorMap* map, const void* packed, int64_t rows,
                              int64_t w) {
  if (rows < 1 || w < 1 || w % 4 || reinterpret_cast<uintptr_t>(packed) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(w) * 4};
  const cuuint32_t box[2] = {KW, 128};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(packed),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launch `kernel` in clusters of `cluster` blocks of Body::THREADS threads
// and Body::SMEM_BYTES of dynamic shared memory.
template <class Body, class... KArgs, class... Args>
int launch_cluster(void (*kernel)(KArgs...), dim3 grid, dim3 cluster, void* stream,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Body::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Body::THREADS);
  cfg.dynamicSmemBytes = Body::SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile
