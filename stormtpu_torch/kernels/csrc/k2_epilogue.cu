// K2-topk and K2-hist for Hopper: K2's triangular tile walk with the tile
// store replaced by a reduction of the block's sums, so that the count
// tiles never reach device memory.
//
// Replaces the device work the JAX package's jitted programs run on K2's
// count tiles (there, XLA ops around the Pallas kernel):
//   stormtpu/query.py:548         _topk_tile_walk (tile_cands: the masks and
//                                 lax.top_k of each tile, both sides)
//   stormtpu/stream_query.py:308  _stripe_topk (a stripe's per-row top-k)
//   stormtpu/stream_hist.py:112   _make_pair_hist_fn and
//   stormtpu/stream.py:1228       stream_count_histogram (a masked bin count
//                                 of every valid pair)
//
// What it computes. Tile t counts row block ibs[t] against jbs[t] exactly as
// k2_tri_kernel does (csrc/k2_mxu.cu): the same grid of BM x BN sub-tiles,
// the same source and the same main loop (tile::B1Wgmma::accumulate), so the
// sums are K2's bit for bit. Global row and column of a tile's element
// (r, c) are row_off + ibs[t]*ti + r and col_off + jbs[t]*ti + c.
//  - K2-topk(kk): a cell is invalid when its global row equals its global
//    column or either is >= n_real; it ranks as -1. Each row of a block
//    gets its kk best (value, global column) over the block's columns;
//    each column its kk best (value, global row) over the block's rows,
//    except in a diagonal tile (global row block == global column block),
//    whose column side is all (-1, -1): its transpose is its row side.
//    Order: value descending, ties to the lower index (lax.top_k's).
//    Row side: row_v/row_i [T, nsub_n, ti, kk]; column side: col_v/col_i
//    [T, nsub_m, ti, kk] (nsub_m x nsub_n sub-tiles a tile).
//  - K2-hist(bin_width, n_bins): every pair with global row < global
//    column < n_real adds 1 to bin min(count / bin_width, n_bins - 1) of
//    the int64 total hist[n_bins].
//
// What bounds it: K2's work (2*pairs*M bit operations at the b1 wgmma
// rate); the epilogue adds no tensor-core work and writes O(ti*kk) a tile
// (top-k) or n_bins atomics a block (histogram) instead of ti^2 counts.
//
// What the design does about it:
//  - K2's main loop is called as it is; the tile body and K2's kernels are
//    unchanged. After the loop every product group has retired and every
//    cp.async has drained; one barrier more and the 192 KiB of stages are
//    free for the epilogue.
//  - Top-k: the block's 128 x 256 int32 sums, masked, are staged into the
//    stages with a row stride of 257 words, so a warp reads a row (lanes on
//    consecutive words) and a column (lanes on consecutive rows, banks
//    r + c mod 32) without bank conflicts. A warp then takes two lines at a
//    time: each lane sorts its 8 (row) or 4 (column) entries of each in
//    registers, and kk rounds of two warp reductions (redux.sync max of
//    value + 1, min of the index among the lanes at that value) pick each
//    line's next best; the lane that held it pops it. The rounds are a
//    chain of dependent reductions, so the two lines' chains interleave.
//    Lane r keeps round r's winners and the warp writes each line's kk
//    results in one coalesced store.
//  - Histogram: no staging. Each thread bins its own 128 sums straight from
//    the registers and counts runs of one bin (a histogram's counts crowd
//    into a bin or two), adding each run to its warp's sub-histogram in
//    shared memory with one atomic; the block then adds each bin's total to
//    the device total with one 64-bit atomic. A launch's count never leaves
//    int64.
//
// Launch interface: plain C functions taking device pointers and the stream
// as void*, returning cudaGetLastError() of the launch (cudaErrorInvalidValue,
// without a launch, for arguments the kernels do not take).

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_body.cuh"

namespace {

using namespace tile;
using Body = B1Wgmma;

constexpr int TOPK_MAX = 32;         // kk a launch may ask for
constexpr int LDS = Body::BN + 1;    // staged row stride, in words
constexpr int WARPS = Body::THREADS / 32;
constexpr int HIST_MAX_BINS = 4096;  // a sub-histogram a warp in the stages

static_assert(Body::BM * LDS * 4 <= Body::SMEM_BYTES, "the staged tile fits the stages");
static_assert(WARPS * HIST_MAX_BINS * 4 <= Body::SMEM_BYTES, "the sub-histograms fit");

// Where a block of the tile walk lies: its sub-tile (si, sj) of tile t, its
// extent, and the global row and column of its first element.
struct EpiBlock {
  int64_t t;
  int si, sj, nsub_m, nsub_n, a_rows, b_rows;
  int64_t g_row, g_col;
  bool diag;
};

// K2's main loop for this block (k2_tri_kernel's), then the barrier after
// which the stages may be overwritten.
__device__ __forceinline__ EpiBlock run_tile(Body::Acc& acc,
                                             const uint32_t* packed,
                                             const int* ibs, const int* jbs,
                                             int ti, int64_t w,
                                             int64_t row_off, int64_t col_off,
                                             uint32_t* smem) {
  constexpr int BM = Body::BM, BN = Body::BN;
  EpiBlock b;
  b.t = blockIdx.x;
  b.nsub_m = (ti + BM - 1) / BM;
  b.nsub_n = (ti + BN - 1) / BN;
  b.si = blockIdx.y / b.nsub_n;
  b.sj = blockIdx.y % b.nsub_n;
  b.a_rows = min(BM, ti - b.si * BM);
  b.b_rows = min(BN, ti - b.sj * BN);
  const int64_t ib = ibs[b.t], jb = jbs[b.t];
  const int64_t row_a = ib * ti + b.si * BM;
  const int64_t row_b = jb * ti + b.sj * BN;
  zero_frags(acc.v);
  const RowPairSource src{packed + row_a * w, packed + row_b * w,
                          static_cast<int>(w)};
  Body::accumulate(acc, src, b.a_rows, b.b_rows, w, smem);
  b.g_row = row_off + row_a;
  b.g_col = col_off + row_b;
  b.diag = row_off + ib * ti == col_off + jb * ti;
  __syncthreads();  // both warpgroups' products have read their last stage
  return b;
}

// The kk best (value, index) of LINES lines of the staged tile at once, by
// value descending and index ascending: lane l's entry e of line q is
// element l + 32e of it (line[q][(l + 32e) * stride]), present when below
// len[q] (a line with len 0 is skipped by its caller). Needs kk <= len[q].
// The lines' rounds are independent chains, so each hides the others'
// reduction latency. Lane r < kk returns line q's r-th best in v[q], ix[q].
template <int E, int LINES>
__device__ __forceinline__ void lines_topk(const int* const (&line)[LINES], int stride,
                                           const int (&len)[LINES], int kk, int lane,
                                           int (&v)[LINES], int (&ix)[LINES]) {
  uint32_t u[LINES][E], x[LINES][E];  // value + 1 (0: invalid or absent), index
#pragma unroll
  for (int q = 0; q < LINES; ++q) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + 32 * e;
      const bool here = i < len[q];
      u[q][e] = here ? static_cast<uint32_t>(line[q][i * stride] + 1) : 0u;
      x[q][e] = here ? static_cast<uint32_t>(i) : 0xFFFFFFFFu;
    }
    // each lane's entries, best first (a bubble network: static indices)
#pragma unroll
    for (int a = 0; a < E - 1; ++a) {
#pragma unroll
      for (int b = 0; b < E - 1 - a; ++b) {
        const bool up = u[q][b + 1] > u[q][b] ||
                        (u[q][b + 1] == u[q][b] && x[q][b + 1] < x[q][b]);
        const uint32_t hu = up ? u[q][b + 1] : u[q][b], hx = up ? x[q][b + 1] : x[q][b];
        const uint32_t lu = up ? u[q][b] : u[q][b + 1], lx = up ? x[q][b] : x[q][b + 1];
        u[q][b] = hu;
        x[q][b] = hx;
        u[q][b + 1] = lu;
        x[q][b + 1] = lx;
      }
    }
  }
  uint32_t keep_u[LINES], keep_x[LINES];
#pragma unroll
  for (int q = 0; q < LINES; ++q) {
    keep_u[q] = 0u;
    keep_x[q] = 0xFFFFFFFFu;
  }
  for (int r = 0; r < kk; ++r) {
#pragma unroll
    for (int q = 0; q < LINES; ++q) {
      const uint32_t bu = __reduce_max_sync(0xFFFFFFFFu, u[q][0]);
      const uint32_t bx =
          __reduce_min_sync(0xFFFFFFFFu, u[q][0] == bu ? x[q][0] : 0xFFFFFFFFu);
      if (lane == r) {
        keep_u[q] = bu;
        keep_x[q] = bx;
      }
      if (u[q][0] == bu && x[q][0] == bx) {  // this lane held it: pop
#pragma unroll
        for (int e = 0; e < E - 1; ++e) {
          u[q][e] = u[q][e + 1];
          x[q][e] = x[q][e + 1];
        }
        u[q][E - 1] = 0u;
        x[q][E - 1] = 0xFFFFFFFFu;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < LINES; ++q) {
    v[q] = static_cast<int>(keep_u[q]) - 1;
    ix[q] = static_cast<int>(keep_x[q]);
  }
}

__global__ void __launch_bounds__(Body::THREADS, Body::MIN_BLOCKS)
    k2_topk_kernel(const uint32_t* __restrict__ packed,
                   const int* __restrict__ ibs, const int* __restrict__ jbs,
                   int* __restrict__ row_v, int* __restrict__ row_i,
                   int* __restrict__ col_v, int* __restrict__ col_i, int ti,
                   int64_t w, int64_t row_off, int64_t col_off, int64_t n_real,
                   int kk) {
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  constexpr int BM = Body::BM, BN = Body::BN;
  Body::Acc acc;
  const EpiBlock b = run_tile(acc, packed, ibs, jbs, ti, w, row_off, col_off, smem_dyn);

  // stage the sums, invalid cells as -1 (accumulator layout: tile_body.cuh)
  int* stage = reinterpret_cast<int*>(smem_dyn);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * 16 + (lane >> 2);
  const int q2 = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h * 8;
    const int64_t gr = b.g_row + r;
    const bool row_ok = gr < n_real;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + q2 + e;
        const int64_t gc = b.g_col + c;
        const bool ok = row_ok && gc < n_real && gc != gr;
        stage[r * LDS + c] = ok ? acc.v[4 * j + 2 * h + e] : -1;
      }
    }
  }
  __syncthreads();

  // each row: its kk best over the block's columns; a warp takes rows
  // r and r + WARPS together
  for (int r = warp; r < b.a_rows; r += 2 * WARPS) {
    const int rows[2] = {r, r + WARPS};
    const int* line[2] = {stage + rows[0] * LDS, stage + rows[1] * LDS};
    const int len[2] = {b.b_rows, rows[1] < b.a_rows ? b.b_rows : 0};
    int v[2], ix[2];
    lines_topk<BN / 32, 2>(line, 1, len, kk, lane, v, ix);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (lane < kk && len[q]) {
        const int64_t o =
            ((b.t * b.nsub_n + b.sj) * ti + b.si * BM + rows[q]) * kk + lane;
        row_v[o] = v[q];
        row_i[o] = static_cast<int>(b.g_col + ix[q]);
      }
    }
  }
  // each column: its kk best over the block's rows (none in a diagonal
  // tile), columns c and c + WARPS together
  for (int c = warp; c < b.b_rows; c += 2 * WARPS) {
    const int cols[2] = {c, c + WARPS};
    const int* line[2] = {stage + cols[0], stage + cols[1]};
    const int len[2] = {b.a_rows, cols[1] < b.b_rows ? b.a_rows : 0};
    int v[2] = {-1, -1}, ix[2] = {-1, -1};
    if (!b.diag) {
      lines_topk<BM / 32, 2>(line, LDS, len, kk, lane, v, ix);
#pragma unroll
      for (int q = 0; q < 2; ++q) ix[q] = static_cast<int>(b.g_row + ix[q]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (lane < kk && len[q]) {
        const int64_t o =
            ((b.t * b.nsub_m + b.si) * ti + b.sj * BN + cols[q]) * kk + lane;
        col_v[o] = v[q];
        col_i[o] = ix[q];
      }
    }
  }
}

__global__ void __launch_bounds__(Body::THREADS, Body::MIN_BLOCKS)
    k2_hist_kernel(const uint32_t* __restrict__ packed,
                   const int* __restrict__ ibs, const int* __restrict__ jbs,
                   unsigned long long* __restrict__ hist, int ti, int64_t w,
                   int64_t row_off, int64_t col_off, int64_t n_real,
                   int bin_width, int n_bins) {
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  constexpr int BN = Body::BN;
  Body::Acc acc;
  const EpiBlock b = run_tile(acc, packed, ibs, jbs, ti, w, row_off, col_off, smem_dyn);

  unsigned* sub = smem_dyn;  // [WARPS][n_bins]
  for (int i = threadIdx.x; i < WARPS * n_bins; i += Body::THREADS) sub[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* mine = sub + warp * n_bins;
  const int r0 = warp * 16 + (lane >> 2);
  const int q2 = (lane & 3) * 2;
  const unsigned bw = static_cast<unsigned>(bin_width);
  const unsigned last = static_cast<unsigned>(n_bins - 1);
  unsigned cur = 0u, run = 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h * 8;
    const int64_t gr = b.g_row + r;
    const bool row_ok = r < b.a_rows;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + q2 + e;
        const int64_t gc = b.g_col + c;
        if (row_ok && c < b.b_rows && gr < gc && gc < n_real) {
          const unsigned bin =
              min(static_cast<unsigned>(acc.v[4 * j + 2 * h + e]) / bw, last);
          if (bin != cur) {
            if (run) atomicAdd(mine + cur, run);
            cur = bin;
            run = 0u;
          }
          ++run;
        }
      }
    }
  }
  if (run) atomicAdd(mine + cur, run);
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += Body::THREADS) {
    unsigned s = 0u;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += sub[q * n_bins + i];
    if (s) atomicAdd(hist + i, static_cast<unsigned long long>(s));
  }
}

}  // namespace

extern "C" {

// The sub-tile a block reduces (the wrappers' output layout) and the limits
// of the two epilogues.
int k2_epi_block_rows() { return Body::BM; }
int k2_epi_block_cols() { return Body::BN; }
int k2_topk_max_k() { return TOPK_MAX; }
int k2_hist_max_bins() { return HIST_MAX_BINS; }

// packed: int32/uint32 [n_pad, w]; ibs, jbs: int32 [t]; row_v, row_i: int32
// [t, nsub_n, ti, kk]; col_v, col_i: int32 [t, nsub_m, ti, kk]; ti a
// multiple of 32, 1 <= kk <= min(32, ti).
int k2_topk_launch(const void* packed, const void* ibs, const void* jbs,
                   void* row_v, void* row_i, void* col_v, void* col_i, int t,
                   int ti, long long w, long long row_off, long long col_off,
                   long long n_real, int kk, void* stream) {
  if (ti <= 0 || ti % 32 || kk < 1 || kk > TOPK_MAX || kk > ti)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(t), sub_tiles<Body>(ti));
  return launch<Body>(k2_topk_kernel, grid, stream,
                      static_cast<const uint32_t*>(packed),
                      static_cast<const int*>(ibs), static_cast<const int*>(jbs),
                      static_cast<int*>(row_v), static_cast<int*>(row_i),
                      static_cast<int*>(col_v), static_cast<int*>(col_i), ti,
                      static_cast<int64_t>(w), static_cast<int64_t>(row_off),
                      static_cast<int64_t>(col_off),
                      static_cast<int64_t>(n_real), kk);
}

// hist: int64 [n_bins], added into; 1 <= n_bins <= k2_hist_max_bins().
int k2_hist_launch(const void* packed, const void* ibs, const void* jbs,
                   void* hist, int t, int ti, long long w, long long row_off,
                   long long col_off, long long n_real, int bin_width,
                   int n_bins, void* stream) {
  if (ti <= 0 || ti % 32 || bin_width < 1 || n_bins < 1 || n_bins > HIST_MAX_BINS)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(t), sub_tiles<Body>(ti));
  return launch<Body>(k2_hist_kernel, grid, stream,
                      static_cast<const uint32_t*>(packed),
                      static_cast<const int*>(ibs), static_cast<const int*>(jbs),
                      static_cast<unsigned long long*>(hist), ti,
                      static_cast<int64_t>(w), static_cast<int64_t>(row_off),
                      static_cast<int64_t>(col_off),
                      static_cast<int64_t>(n_real), bin_width, n_bins);
}

}  // extern "C"
