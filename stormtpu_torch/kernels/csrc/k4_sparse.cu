// K4 for Hopper: the sparse regime's inverted-index count. For every
// occupied column, every pair of the rows that hold it adds 1 to its count.
//
// Replaces the JAX package's host kernels (it keeps K4 off its TPU, which
// cannot scatter):
//   stormtpu/kernels/sparse.py  count_matrix_sparse_outer
//   stormtpu/native/packer.cpp  stpu_sparse_outer_runs (single shot and a
//                               diagonal stripe), stpu_sparse_outer_runs_cross
//                               (an off-diagonal stripe), stpu_mirror_upper
//
// Input: a column-sorted, de-duplicated list of rows (rows ascend within a
// column), cut into segments: one per column shared by the two sides.
// Segment s holds its side-A rows at rows_a[off_a[s] .. off_a[s] + len_a[s])
// and its side-B rows at rows_b[off_b[s] .. off_b[s] + len_b[s]).
//  - Triangle form (triangle = 1; A and B are the same list): every x < y of
//    a segment adds 1 to out[rows[x], rows[y]], the strict upper triangle,
//    p(p-1)/2 emissions for a segment of p rows.
//  - Rectangle form (triangle = 0): every (x, y) adds 1 to
//    out[rows_a[x], rows_b[y]], p·q emissions.
// prefix (int64 [n_seg + 1]) is the exclusive prefix of the segments'
// emission counts, every count >= 1 (the wrapper drops empty segments).
//
// What bounds it on this card: bytes. Each emission is a read-modify-write
// of one int32 of the output (8 bytes at 3.35 TB/s); where emissions are
// few, the output written once (4·N² bytes: the zeroing, the mirror and the
// download) is the larger term. What the design does about it:
//  - Work is balanced by emissions, not by columns: run lengths are skewed
//    (an LD block, a dense corner), so the flat emission range [0, E) is
//    split evenly over a persistent grid of warps, each taking a contiguous
//    range in chunks of 32. A warp finds its first segment by binary search
//    over the prefix; after that it carries the segment along: the lanes
//    load the next 32 segment boundaries, a warp-wide OR of their offsets
//    tells each lane its own segment, and a ballot moves the warp on.
//  - A lane decodes its (x, y) from its index within the segment, row x
//    first and y fastest, so the 32 lanes of a warp take consecutive y of
//    one row x: their 32 red.global.add (atomicAdd with an unused result) fall
//    in one output row at ascending columns and touch few L2 sectors. The
//    counts are integers: the order of the atomics does not change them.
//  - Emission indices, prefixes and output offsets (a·ld + b) are int64:
//    a dense corner passes 2^31 emissions.
//  - The mirror is a second kernel: 32 x 32 tiles through shared memory
//    (rows padded to 33 words, no bank conflicts), only the tile pairs with
//    ib <= jb doing work; a diagonal tile reads its upper half and writes
//    its lower half after __syncthreads. It also writes the diagonal, from
//    the rows' nonzero counts, so no emission is spent on it.
//
// Launch interface: plain C functions taking device pointers and the
// stream as void*, returning cudaGetLastError() of the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int EMIT_WARPS = 8;                 // warps a block
constexpr int EMIT_THREADS = 32 * EMIT_WARPS;
constexpr int EMIT_BLOCKS_PER_SM = 8;         // the persistent grid's blocks an SM
constexpr int MIRROR_TILE = 32;
constexpr int MIRROR_ROWS = 8;                // blockDim.y: four rows a thread

// The segment s with prefix[s] <= e < prefix[s + 1] (prefix strictly
// ascending from 0).
__device__ __forceinline__ long long find_segment(const long long* __restrict__ prefix,
                                                  long long n_seg, long long e) {
  long long lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Emission t of a p-row triangle, row x first: row x holds the p - 1 - x
// pairs (x, x+1 .. p-1), and C(x) = x(2p - 1 - x)/2 of them precede it.
__device__ __forceinline__ void tri_decode(long long p, long long t, long long& x,
                                           long long& y) {
  const double b = 2.0 * static_cast<double>(p) - 1.0;
  long long r = static_cast<long long>((b - sqrt(b * b - 8.0 * static_cast<double>(t))) * 0.5);
  r = r < 0 ? 0 : (r > p - 2 ? p - 2 : r);
  // the square root is exact to a few ulps: step to the true row
  while (r > 0 && r * (2 * p - 1 - r) / 2 > t) --r;
  while (r < p - 2 && (r + 1) * (2 * p - 2 - r) / 2 <= t) ++r;
  x = r;
  y = r + 1 + (t - r * (2 * p - 1 - r) / 2);
}

__global__ void __launch_bounds__(EMIT_THREADS)
k4_emit_kernel(const int32_t* __restrict__ rows_a, const int32_t* __restrict__ rows_b,
               const long long* __restrict__ off_a, const long long* __restrict__ len_a,
               const long long* __restrict__ off_b, const long long* __restrict__ len_b,
               const long long* __restrict__ prefix, long long n_seg, long long total,
               long long chunks, long long warps, int triangle, int32_t* __restrict__ out,
               long long ld) {
  const int lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * EMIT_WARPS + (threadIdx.x >> 5);
  if (w >= warps) return;  // the whole warp leaves together
  const long long c0 = chunks * w / warps;
  const long long c1 = chunks * (w + 1) / warps;
  if (c0 >= c1) return;
  long long e = c0 * 32;
  const long long e_end = c1 * 32 < total ? c1 * 32 : total;
  long long seg = find_segment(prefix, n_seg, e);
  const unsigned upto = lane == 31 ? 0xffffffffu : ((2u << lane) - 1u);
  while (e < e_end) {
    // the boundaries after seg: lane k holds the start of segment seg + 1 + k
    const long long k = seg + 1 + lane;
    const long long bnd = k <= n_seg ? prefix[k] : LLONG_MAX;
    const long long d = bnd - e;
    const unsigned bits = __reduce_or_sync(0xffffffffu, (d >= 1 && d <= 31) ? (1u << d) : 0u);
    const long long s = seg + __popc(bits & upto);
    const long long my = e + lane;
    if (my < e_end) {
      const long long t = my - prefix[s];
      int32_t a, b;
      if (triangle) {
        long long x, y;
        tri_decode(len_a[s], t, x, y);
        const long long o = off_a[s];
        a = rows_a[o + x];
        b = rows_a[o + y];
      } else {
        const long long q = len_b[s];
        a = rows_a[off_a[s] + t / q];
        b = rows_b[off_b[s] + t % q];
      }
      atomicAdd(out + static_cast<long long>(a) * ld + b, 1);
    }
    seg += __popc(__ballot_sync(0xffffffffu, d <= 32));
    e += 32;
  }
}

__global__ void __launch_bounds__(MIRROR_TILE * MIRROR_ROWS)
k4_mirror_kernel(int32_t* __restrict__ c, const int32_t* __restrict__ diag, long long n,
                 long long ld) {
  const long long ib = blockIdx.y, jb = blockIdx.x;
  if (ib > jb) return;
  __shared__ int32_t tile[MIRROR_TILE][MIRROR_TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long i0 = ib * MIRROR_TILE, j0 = jb * MIRROR_TILE;
  // the upper tile: rows i0.., columns j0..
  for (int r = ty; r < MIRROR_TILE; r += MIRROR_ROWS) {
    const long long i = i0 + r, j = j0 + tx;
    tile[r][tx] = (i < n && j < n) ? c[i * ld + j] : 0;
  }
  __syncthreads();
  // its transpose into the lower tile: out[j, i] = upper[i, j]
  for (int r = ty; r < MIRROR_TILE; r += MIRROR_ROWS) {
    const long long j = j0 + r, i = i0 + tx;
    if (i >= n || j >= n) continue;
    if (ib < jb || tx < r) {
      c[j * ld + i] = tile[tx][r];
    } else if (tx == r && diag != nullptr) {
      c[j * ld + i] = diag[j];
    }
  }
}

}  // namespace

extern "C" {

int k4_emit_warps_per_block() { return EMIT_WARPS; }

// rows_a, rows_b: int32; off_a, len_a, off_b, len_b: int64 [n_seg];
// prefix: int64 [n_seg + 1], prefix[n_seg] = total; out: int32, row stride
// ld. Adds into out (the caller zeroes it). No launch when total is 0.
int k4_emit_launch(const void* rows_a, const void* rows_b, const void* off_a,
                   const void* len_a, const void* off_b, const void* len_b,
                   const void* prefix, long long n_seg, long long total, int triangle,
                   void* out, long long ld, void* stream) {
  if (total <= 0 || n_seg <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (total + 31) / 32;
  long long warps = static_cast<long long>(sms) * EMIT_BLOCKS_PER_SM * EMIT_WARPS;
  if (warps > chunks) warps = chunks;
  const unsigned blocks = static_cast<unsigned>((warps + EMIT_WARPS - 1) / EMIT_WARPS);
  k4_emit_kernel<<<blocks, EMIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows_a), static_cast<const int32_t*>(rows_b),
      static_cast<const long long*>(off_a), static_cast<const long long*>(len_a),
      static_cast<const long long*>(off_b), static_cast<const long long*>(len_b),
      static_cast<const long long*>(prefix), n_seg, total, chunks, warps, triangle,
      static_cast<int32_t*>(out), ld);
  return static_cast<int>(cudaGetLastError());
}

// c: int32 [n, ld] (ld >= n); diag: int32 [n], or null to leave the
// diagonal as it is. Writes the strict lower triangle from the upper.
int k4_mirror_launch(void* c, const void* diag, long long n, long long ld, void* stream) {
  if (n <= 0) return 0;
  const long long nb = (n + MIRROR_TILE - 1) / MIRROR_TILE;
  if (nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(nb));
  const dim3 block(MIRROR_TILE, MIRROR_ROWS);
  k4_mirror_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(c), static_cast<const int32_t*>(diag), n, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
