// The streamed screen's compaction for Hopper: one int32 count stripe in, the
// pairs whose screen value reaches the threshold out, each as (local row,
// local column, count) in a bounded buffer that the host reads in one copy.
//
// Replaces no TPU kernel: the JAX package screens a stripe with jitted
// reductions (stormtpu/stream_query.py, stream_pairs_above: the float32
// screen values, the packed hit bitmap and its word summary), which the port
// ran as a dozen PyTorch elementwise and reduction kernels a stripe and then
// fetched in three dependent round trips. This kernel does the screen and
// the compaction in one pass, so that a stripe's hits come back in one copy.
//
// What bounds it on this card: bytes. It reads the stripe once (4·SB²
// bytes: 64 MB at SB = 4096, 0.02 ms at 3.35 TB/s; half of that on a
// diagonal stripe) and writes 12 bytes a hit; the float arithmetic, at most
// about 20 operations a pair, is far below the card's rate. What the design
// does about it:
//  - Lane l of a warp reads column c0 + 32q + l of one row, so each of a
//    thread's eight loads a row is one 128-byte segment of the warp, and
//    eight of them are in flight a thread before the first is used.
//  - A diagonal stripe (the pair (r, c) is global (row0 + r, col0 + c); on
//    the diagonal col0 = row0) is read only above its diagonal: a block
//    wholly at or below it returns at once, and the rest predicate each
//    load on c + col0 − row0 > r. Rows and columns past n are not read.
//  - Hits are rare. A warp whose ballot holds any takes their slots with
//    one atomicAdd by its lowest hitting lane, broadcast by __shfl_sync;
//    each lane writes its hit at its rank in the ballot. The total is
//    always added, past the buffer's end too, so the host sees an overflow
//    and screens the stripe again into a larger buffer. Slots follow the
//    atomics' order: the host sorts the hits.
//  - The values are query._screen_vals_core's, operation by operation and
//    in its order, in the round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
//    __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts into an
//    FMA: the kernel keeps exactly the pairs its plain form keeps.
//
// Launch interface: a plain C function taking device pointers and the
// stream as void*, returning the first CUDA error of the memset or launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS_PER_LANE = 8;
constexpr int BLOCK_COLS = 32 * COLS_PER_LANE;  // 256
constexpr int ROWS_PER_WARP = 4;
constexpr int BLOCK_ROWS = WARPS * ROWS_PER_WARP;  // 32

// the order of kernels/screen.py's MEASURES
enum Measure : int { kCount = 0, kJaccard, kDice, kCosine, kOverlap, kPhi, kR2 };

// query._screen_vals_core for one pair: count c, the row's and the column's
// set bits ca, cb, the universe m, all float32.
__device__ __forceinline__ float screen_value(int c, float ca, float cb, float m, int measure) {
  const float inter = __int2float_rn(c);
  if (measure == kCount) return inter;
  float num = inter, den;
  switch (measure) {
    case kJaccard:
      den = __fsub_rn(__fadd_rn(ca, cb), inter);
      break;
    case kDice:
      num = __fmul_rn(2.0f, inter);
      den = __fadd_rn(ca, cb);
      break;
    case kCosine:
      den = __fsqrt_rn(__fmul_rn(ca, cb));
      break;
    case kOverlap:
      den = fminf(ca, cb);
      break;
    default: {  // phi, r2: the numerator inflated by its rounding bound
      const float mi = __fmul_rn(m, inter);
      const float ab = __fmul_rn(ca, cb);
      const float err = __fadd_rn(__fmul_rn(2e-6f, __fadd_rn(mi, ab)), 1e-3f);
      const float d = __fsqrt_rn(__fmul_rn(__fmul_rn(ab, __fsub_rn(m, ca)), __fsub_rn(m, cb)));
      if (measure == kPhi) {
        num = __fadd_rn(__fsub_rn(mi, ab), err);
        den = d;
      } else {
        num = __fadd_rn(fabsf(__fsub_rn(mi, ab)), err);
        num = __fmul_rn(num, num);
        den = __fmul_rn(d, d);
      }
    }
  }
  return den > 0.0f ? __fdiv_rn(num, den) : 0.0f;
}

// counts: int32 [rows, cols] valid (row stride ldc); nnz_rows [rows],
// nnz_cols [cols]; a pair (r, c) is a candidate when c + diag_off > r.
// out[0] += hits; hit k at out[1 + 3k .. 3 + 3k] while k < cap.
__global__ void __launch_bounds__(THREADS) stripe_screen_kernel(
    const int32_t* __restrict__ counts, long long ldc, int rows, int cols,
    const int32_t* __restrict__ nnz_rows, const int32_t* __restrict__ nnz_cols,
    long long diag_off, int measure, float thresh, float m, int32_t* __restrict__ out,
    int cap) {
  const int c0 = blockIdx.x * BLOCK_COLS;
  const int r0 = blockIdx.y * BLOCK_ROWS;
  if (static_cast<long long>(c0 + BLOCK_COLS - 1) + diag_off <= r0) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float cb[COLS_PER_LANE];
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE; ++q) {
    const int c = c0 + 32 * q + lane;
    cb[q] = c < cols ? __int2float_rn(nnz_cols[c]) : 0.0f;
  }
  for (int p = 0; p < ROWS_PER_WARP; ++p) {
    const int r = r0 + warp * ROWS_PER_WARP + p;  // the same for the warp's lanes
    if (r >= rows) break;
    const float ca = __int2float_rn(nnz_rows[r]);
    const int32_t* row = counts + r * ldc;
    int v[COLS_PER_LANE];
    bool in[COLS_PER_LANE];
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q) {
      const int c = c0 + 32 * q + lane;
      in[q] = c < cols && static_cast<long long>(c) + diag_off > r;
      v[q] = in[q] ? __ldg(row + c) : 0;
    }
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q) {
      const bool hit = in[q] && screen_value(v[q], ca, cb[q], m, measure) >= thresh;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask == 0u) continue;
      const int leader = __ffs(mask) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(out, __popc(mask));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (hit) {
        const int slot = base + __popc(mask & ((1u << lane) - 1u));
        if (slot < cap) {
          int32_t* h = out + 1 + 3LL * slot;
          h[0] = r;
          h[1] = c0 + 32 * q + lane;
          h[2] = v[q];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// counts: int32, rows x cols valid of row stride ldc; nnz_rows, nnz_cols:
// int32; out: int32 [1 + 3·cap], its total zeroed here first. measure: the
// index of kernels/screen.py's MEASURES.
int stripe_screen_launch(const void* counts, long long ldc, int rows, int cols,
                         const void* nnz_rows, const void* nnz_cols, long long diag_off,
                         int measure, float thresh, float m, void* out, int cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || cols <= 0) return 0;
  const unsigned gy = static_cast<unsigned>((rows + BLOCK_ROWS - 1) / BLOCK_ROWS);
  if (gy > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((cols + BLOCK_COLS - 1) / BLOCK_COLS), gy);
  stripe_screen_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const int32_t*>(counts), ldc, rows, cols,
      static_cast<const int32_t*>(nnz_rows), static_cast<const int32_t*>(nnz_cols), diag_off,
      measure, thresh, m, static_cast<int32_t*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
