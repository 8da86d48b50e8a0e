// Back-to-back issue rate of the tensor-core instructions K2 may use,
// measured from registers (mma.sync) or from one resident shared-memory
// tile (wgmma) on every SM: no global memory traffic, no unpack, no
// pipeline. The rate of the instruction a K2 body uses is the ceiling of
// that body, and the operation bound in PERF.md is stated against it.
//
// Kinds:
//   0  mma.sync.m16n8k32   s8 x s8          (the int8 product)
//   1  mma.sync.m16n8k256  b1 and.popc      (the binary product)
//   2  wgmma m64n256k256   b1 and.popc  (the one K2's tile body issues)
//
// A block is 256 threads: 8 warps that each issue 8 independent mma.sync an
// iteration, or 2 warpgroups that each issue 4 wgmma an iteration. One
// multiply-accumulate (MAC) is one bit pair for b1 and one int8 pair for s8.

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MMA_PER_ITER = 8;
constexpr int WGMMA_PER_ITER = 4;

template <bool B1>
__global__ void __launch_bounds__(THREADS)
    mma_sync_rate_kernel(int iters, int* __restrict__ out) {
  int c[MMA_PER_ITER][4];
#pragma unroll
  for (int i = 0; i < MMA_PER_ITER; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0;
  const uint32_t a0 = threadIdx.x * 0x9E3779B9u, a1 = a0 ^ 0x55555555u;
  const uint32_t a2 = a0 >> 3, a3 = a1 >> 5, b0 = a0 << 1, b1 = a1 << 2;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < MMA_PER_ITER; ++i) {
      if (B1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < MMA_PER_ITER; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += c[i][e];
  out[blockIdx.x * THREADS + threadIdx.x] = sum;
}

__global__ void __launch_bounds__(THREADS)
    wgmma_rate_kernel(int iters, int* __restrict__ out) {
  constexpr int N = 256;
  // A: 64 rows, B: N rows, 128 bytes a row (four K steps), all zero
  __shared__ __align__(1024) uint32_t tile[(64 + N) * 32];
  for (int i = threadIdx.x; i < (64 + N) * 32; i += THREADS) tile[i] = 0u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  const uint64_t da = wgmma_desc_sw128(base);
  const uint64_t db = wgmma_desc_sw128(base + 64 * 128);
  int d[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) d[e] = 0;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < WGMMA_PER_ITER; ++k) {
      // K step k of the 128-byte row: 32 bytes further, 2 in descriptor units
      wgmma_b1_n256(d, da + 2 * k, db + 2 * k);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  int sum = 0;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) sum += d[e];
  out[blockIdx.x * THREADS + threadIdx.x] = sum;
}

}  // namespace

extern "C" {

int tc_rate_kinds() { return 3; }

const char* tc_rate_name(int kind) {
  switch (kind) {
    case 0: return "mma.sync.m16n8k32.s8";
    case 1: return "mma.sync.m16n8k256.b1.and.popc";
    case 2: return "wgmma.m64n256k256.b1.and.popc";
    default: return "";
  }
}

int tc_rate_threads() { return THREADS; }

// Multiply-accumulates of one block in one iteration.
long long tc_rate_macs(int kind) {
  const long long warps = THREADS / 32, groups = THREADS / 128;
  switch (kind) {
    case 0: return warps * MMA_PER_ITER * 16 * 8 * 32;
    case 1: return warps * MMA_PER_ITER * 16 * 8 * 256;
    case 2: return groups * WGMMA_PER_ITER * 64 * 256 * 256;
    default: return 0;
  }
}

// out: int32 [blocks * tc_rate_threads()], a sink for the sums.
int tc_rate_launch(int kind, int blocks, int iters, void* out, void* stream) {
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: mma_sync_rate_kernel<false><<<blocks, THREADS, 0, s>>>(iters, o); break;
    case 1: mma_sync_rate_kernel<true><<<blocks, THREADS, 0, s>>>(iters, o); break;
    case 2: wgmma_rate_kernel<<<blocks, THREADS, 0, s>>>(iters, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
