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
// k2_tri_kernel does (csrc/k2_mxu.cu): the same BM x BN sub-tiles and the
// same sums, bit for bit. Global row and column of a tile's element (r, c)
// are row_off + ibs[t]*ti + r and col_off + jbs[t]*ti + c.
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
//  - The main loop is tile::B1WgmmaTma (csrc/tile_body_tma.cuh): TMA loads
//    into a 128-byte-swizzled ring signalled by mbarriers, a producer
//    warpgroup and two consumer warpgroups, and clusters of two blocks over
//    a tile's sub-tile rows 2q, 2q + 1, which share their B rows by
//    multicast whenever a tile has an even number of sub-tile rows (a
//    cluster of one otherwise: the shape rule, k2_epi_cluster below).
//    Blocks are laid out sj-major (blockIdx.y = sj * nsub_m + si), so a
//    cluster's two blocks are neighbours in the grid.
//  - The epilogues below run on the 256 threads that hold the sums (the
//    consumers); their barriers are named barrier 1 over those 256, and the
//    producer warpgroup waits at the cluster's exit barrier meanwhile. The
//    ring's 192 KiB are free once the consumers' last full wait and product
//    group are behind them (B1WgmmaTma::consume returns after a barrier).
//    TMA fills a short sub-tile's missing rows with the next row block's
//    rows: both epilogues read only rows < a_rows and columns < b_rows.
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
// as void*, returning the CUDA error of the launch (cudaErrorInvalidValue,
// without a launch, for arguments the kernels do not take).

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_body_tma.cuh"

namespace {

using namespace tile;

constexpr int BM = 128, BN = 256;    // a block's sub-tile
constexpr int EPI_THREADS = 256;     // the threads that hold a block's sums
constexpr int WARPS = EPI_THREADS / 32;
constexpr int TOPK_MAX = 32;         // kk a launch may ask for
constexpr int LDS = BN + 1;          // staged row stride, in words
constexpr int HIST_MAX_BINS = 4096;  // a sub-histogram a warp in the stages
constexpr int RING_BYTES = B1WgmmaTma<1>::RING_BYTES;

static_assert(B1WgmmaTma<2>::BM == BM && B1WgmmaTma<2>::BN == BN &&
                  B1WgmmaTma<2>::CONSUMERS == EPI_THREADS,
              "the consumers hold the sums");
static_assert(BM * LDS * 4 <= RING_BYTES, "the staged tile fits the ring");
static_assert(WARPS * HIST_MAX_BINS * 4 <= RING_BYTES, "the sub-histograms fit the ring");

__host__ __device__ constexpr int nsub_m(int ti) { return (ti + BM - 1) / BM; }
__host__ __device__ constexpr int nsub_n(int ti) { return (ti + BN - 1) / BN; }

// The shape rule: clusters of two blocks over sub-tile rows (2q, 2q + 1)
// when a tile has an even number of sub-tile rows, else blocks alone.
__host__ __device__ constexpr int epi_cluster(int ti) { return nsub_m(ti) % 2 == 0 ? 2 : 1; }

// Where a block of the tile walk lies: its sub-tile (si, sj) of tile t, its
// extent, its first A and B row in the operand, and the global row and
// column of its first element.
struct EpiBlock {
  int64_t t;
  int si, sj, nsub_m, nsub_n, a_rows, b_rows;
  int64_t row_a, row_b;
  int64_t g_row, g_col;
  bool diag;
};

__device__ __forceinline__ EpiBlock epi_block(int si, int sj, const int* ibs, const int* jbs,
                                              int ti, int64_t row_off, int64_t col_off) {
  EpiBlock b;
  b.t = blockIdx.x;
  b.nsub_m = nsub_m(ti);
  b.nsub_n = nsub_n(ti);
  b.si = si;
  b.sj = sj;
  b.a_rows = min(BM, ti - si * BM);
  b.b_rows = min(BN, ti - sj * BN);
  const int64_t ib = ibs[b.t], jb = jbs[b.t];
  b.row_a = ib * ti + si * BM;
  b.row_b = jb * ti + sj * BN;
  b.g_row = row_off + b.row_a;
  b.g_col = col_off + b.row_b;
  b.diag = row_off + ib * ti == col_off + jb * ti;
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

// K2-topk's reduction of one block's sums (accumulator layout: tile_body.cuh,
// B1Wgmma::store_split), staged in `smem`, the ring. Its barriers are named
// barrier 1 over the consumers, the threads that hold the sums.
__device__ __forceinline__ void topk_epilogue(const int (&acc)[BN / 2], const EpiBlock& b,
                                              uint32_t* smem, int* __restrict__ row_v,
                                              int* __restrict__ row_i, int* __restrict__ col_v,
                                              int* __restrict__ col_i, int ti, int64_t n_real,
                                              int kk) {
  // stage the sums, invalid cells as -1
  int* stage = reinterpret_cast<int*>(smem);
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
        stage[r * LDS + c] = ok ? acc[4 * j + 2 * h + e] : -1;
      }
    }
  }
  named_sync<1, EPI_THREADS>();

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

// K2-hist's reduction of one block's sums, its sub-histograms in `smem`;
// barriers as in topk_epilogue.
__device__ __forceinline__ void hist_epilogue(const int (&acc)[BN / 2], const EpiBlock& b,
                                              uint32_t* smem,
                                              unsigned long long* __restrict__ hist,
                                              int64_t n_real, int bin_width, int n_bins) {
  unsigned* sub = smem;  // [WARPS][n_bins]
  for (int i = threadIdx.x; i < WARPS * n_bins; i += EPI_THREADS) sub[i] = 0u;
  named_sync<1, EPI_THREADS>();
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
              min(static_cast<unsigned>(acc[4 * j + 2 * h + e]) / bw, last);
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
  named_sync<1, EPI_THREADS>();
  for (int i = threadIdx.x; i < n_bins; i += EPI_THREADS) {
    unsigned s = 0u;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += sub[q * n_bins + i];
    if (s) atomicAdd(hist + i, static_cast<unsigned long long>(s));
  }
}

// ------------------------------------------------------------- kernels
// Blocks sj-major: a cluster's two blocks are sub-tile rows 2q, 2q + 1 of
// one column block. Every thread reads its block's place; the producer
// warpgroup loads, the consumers sum and reduce.
template <int CLUSTER>
__global__ void __launch_bounds__(B1WgmmaTma<CLUSTER>::THREADS, 1)
    k2_topk_kernel(__grid_constant__ const CUtensorMap map, const int* __restrict__ ibs,
                   const int* __restrict__ jbs, int* __restrict__ row_v,
                   int* __restrict__ row_i, int* __restrict__ col_v,
                   int* __restrict__ col_i, int ti, int64_t w, int64_t row_off,
                   int64_t col_off, int64_t n_real, int kk) {
  using Body = B1WgmmaTma<CLUSTER>;
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  const EpiBlock b = epi_block(blockIdx.y % nsub_m(ti), blockIdx.y / nsub_m(ti), ibs, jbs,
                               ti, row_off, col_off);
  const int chunks = static_cast<int>((w + KW - 1) / KW);
  Body::init(smem_dyn);
  if (Body::is_producer()) {
    Body::produce(&map, smem_dyn, chunks, static_cast<int>(b.row_a),
                  static_cast<int>(b.row_b));
  } else {
    typename Body::Acc acc;
    Body::consume(acc, smem_dyn, chunks);
    topk_epilogue(acc.v, b, smem_dyn, row_v, row_i, col_v, col_i, ti, n_real, kk);
    Body::finish();
  }
}

template <int CLUSTER>
__global__ void __launch_bounds__(B1WgmmaTma<CLUSTER>::THREADS, 1)
    k2_hist_kernel(__grid_constant__ const CUtensorMap map, const int* __restrict__ ibs,
                   const int* __restrict__ jbs, unsigned long long* __restrict__ hist,
                   int ti, int64_t w, int64_t row_off, int64_t col_off, int64_t n_real,
                   int bin_width, int n_bins) {
  using Body = B1WgmmaTma<CLUSTER>;
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  const EpiBlock b = epi_block(blockIdx.y % nsub_m(ti), blockIdx.y / nsub_m(ti), ibs, jbs,
                               ti, row_off, col_off);
  const int chunks = static_cast<int>((w + KW - 1) / KW);
  Body::init(smem_dyn);
  if (Body::is_producer()) {
    Body::produce(&map, smem_dyn, chunks, static_cast<int>(b.row_a),
                  static_cast<int>(b.row_b));
  } else {
    typename Body::Acc acc;
    Body::consume(acc, smem_dyn, chunks);
    hist_epilogue(acc.v, b, smem_dyn, hist, n_real, bin_width, n_bins);
    Body::finish();
  }
}

bool topk_args_ok(int ti, int kk) {
  return ti > 0 && ti % 32 == 0 && kk >= 1 && kk <= TOPK_MAX && kk <= ti;
}

bool hist_args_ok(int ti, int bin_width, int n_bins) {
  return ti > 0 && ti % 32 == 0 && bin_width >= 1 && n_bins >= 1 && n_bins <= HIST_MAX_BINS;
}

// TMA's coordinates are int32: every box of the walk starts below 2^31.
bool coords_ok(long long rows, long long w) {
  return rows + 2 * BN < (1ll << 31) && w + KW < (1ll << 31);
}

dim3 epi_grid(int t, int ti) {
  return dim3(static_cast<unsigned>(t), static_cast<unsigned>(nsub_m(ti) * nsub_n(ti)));
}

struct TopkKernel {
  template <int CLUSTER>
  static auto of() { return &k2_topk_kernel<CLUSTER>; }
};
struct HistKernel {
  template <int CLUSTER>
  static auto of() { return &k2_hist_kernel<CLUSTER>; }
};

// The shape rule's instance of Kernel: clusters of two when a tile of ti
// rows has an even number of sub-tile rows, else blocks alone. A launch
// that fails returns its error; nothing is retried another way.
template <class Kernel, class... Args>
int launch_by_shape(int ti, dim3 grid, void* stream, Args... args) {
  if (epi_cluster(ti) == 2)
    return launch_cluster<B1WgmmaTma<2>>(Kernel::template of<2>(), grid, dim3(1, 2, 1), stream,
                                         args...);
  return launch_cluster<B1WgmmaTma<1>>(Kernel::template of<1>(), grid, dim3(1, 1, 1), stream,
                                       args...);
}

}  // namespace

extern "C" {

// The sub-tile a block reduces (the wrappers' output layout), the limits
// of the two epilogues, and the cluster a tile of ti rows launches.
int k2_epi_block_rows() { return BM; }
int k2_epi_block_cols() { return BN; }
int k2_topk_max_k() { return TOPK_MAX; }
int k2_hist_max_bins() { return HIST_MAX_BINS; }
int k2_epi_cluster(int ti) { return ti > 0 ? epi_cluster(ti) : 0; }

// packed: int32/uint32 [rows, w], 16-byte aligned, w % 4 == 0; ibs, jbs:
// int32 [t]; row_v, row_i: int32 [t, nsub_n, ti, kk]; col_v, col_i: int32
// [t, nsub_m, ti, kk]; ti a multiple of 32, 1 <= kk <= min(32, ti).
int k2_topk_launch(const void* packed, const void* ibs, const void* jbs, void* row_v,
                   void* row_i, void* col_v, void* col_i, int t, int ti, long long rows,
                   long long w, long long row_off, long long col_off, long long n_real,
                   int kk, void* stream) {
  if (!topk_args_ok(ti, kk) || !coords_ok(rows, w))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (const int e = encode_operand_map(&map, packed, rows, w)) return e;
  return launch_by_shape<TopkKernel>(
      ti, epi_grid(t, ti), stream, map, static_cast<const int*>(ibs),
      static_cast<const int*>(jbs), static_cast<int*>(row_v), static_cast<int*>(row_i),
      static_cast<int*>(col_v), static_cast<int*>(col_i), ti, static_cast<int64_t>(w),
      static_cast<int64_t>(row_off), static_cast<int64_t>(col_off),
      static_cast<int64_t>(n_real), kk);
}

// hist: int64 [n_bins], added into; 1 <= n_bins <= k2_hist_max_bins();
// packed as for k2_topk_launch.
int k2_hist_launch(const void* packed, const void* ibs, const void* jbs, void* hist, int t,
                   int ti, long long rows, long long w, long long row_off,
                   long long col_off, long long n_real, int bin_width, int n_bins,
                   void* stream) {
  if (!hist_args_ok(ti, bin_width, n_bins) || !coords_ok(rows, w))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (const int e = encode_operand_map(&map, packed, rows, w)) return e;
  return launch_by_shape<HistKernel>(
      ti, epi_grid(t, ti), stream, map, static_cast<const int*>(ibs),
      static_cast<const int*>(jbs), static_cast<unsigned long long*>(hist), ti,
      static_cast<int64_t>(w), static_cast<int64_t>(row_off), static_cast<int64_t>(col_off),
      static_cast<int64_t>(n_real), bin_width, n_bins);
}

}  // extern "C"
