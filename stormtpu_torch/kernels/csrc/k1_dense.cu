// K1 and K0 for Hopper: exact intersection counts of packed bit rows by AND
// and population count. K1 takes the tensor cores' binary product (which IS
// AND + popcount); K0 the CUDA cores.
//
// Replaces the JAX package's Pallas kernels:
//   stormtpu/kernels/dense.py  _k1_kernel / _k1_kernel_chunk
//                              (triangular tile list, count_tiles_pallas_dense)
//   stormtpu/kernels/dense.py  _stream_kernel
//                              (row-wise pair stream, pair_count_stream_pallas)
//
// K1 computes out[t, r, c] = popcount(A[r] & B[c]) for the TI x TI tile of
// row blocks ibs[t] x jbs[t], TI any multiple of 8. That is what
// wgmma .b1 .and.popc computes, so K1 launches the tile body K2 and K5 use
// (tile::B1Wgmma, csrc/tile_body.cuh). What bounds it: 2·T·TI²·M bit
// operations at that instruction's issue rate, and before that the packed
// operand's trips from L2 into shared memory, which fall as a block's tile
// grows. What the design does about it:
//  - K1's tiles are at most half the body's 128 x 256 block, so a block
//    run on one tile would multiply zero-filled B rows half of the time.
//    One block therefore takes TWO tiles that share their A row block
//    (neighbours in an i-major tile list): B rows 0..127 come from the
//    first tile's B row block, 128..255 from the second's, and the store
//    sends each half of the columns to its own tile. The L2 traffic per
//    pair is then K2's. The wrapper hands the kernel the list of leading
//    tiles ("units", built on the device from ibs, no read-back): a tile
//    leads when an even number of tiles before it, back to back, share its
//    A row block, and it takes the next tile along when that one shares it
//    too. A tile without a partner runs with the upper half empty.
//  - Rows >= TI of a sub-tile load as zero and are not stored; words >= W
//    load as zero (W is a multiple of 4: the loader reads 16-byte vectors).
//    TI % 8 == 0 makes every stored row 8-byte aligned and every column
//    count even, which the body's int2 stores need.
//
// K0 computes out[r] = sum over words of popcount((A[r] ^ salt) & B[r]).
// What bounds it: bytes, each word of A and B read once (2·R·W·4 bytes at
// 3.35 TB/s). What the design does about it: one warp per row, grid-stride
// over rows, 16-byte loads (4 words a lane) and sums in registers, a
// warp-shuffle reduction and one store per row. A W that is not a multiple
// of 4 takes a one-word-a-lane loop.
//
// Launch interface: plain C functions taking device pointers and the
// stream as void*, returning cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_body.cuh"

namespace {

// --------------------------------------------- K1 on the binary product
// K1: one A row block against two B row blocks, b_lo for the lower half of
// the body's B rows and b_hi (hi_rows of them; 0: none, b_hi is not read)
// for the upper half, over words [0, k_len).
struct SplitBSource {
  static constexpr bool SPLIT_B = true;
  const uint32_t* a;
  const uint32_t* b_lo;
  const uint32_t* b_hi;
  int hi_rows;
  int k_len;
  __device__ int chunks() const { return (k_len + tile::KW - 1) / tile::KW; }
  __device__ void chunk(int f, const uint32_t*& pa, const uint32_t*& pb,
                        int& valid) const {
    pa = a + f * tile::KW;
    pb = b_lo + f * tile::KW;
    valid = k_len - f * tile::KW;
  }
  __device__ const uint32_t* hi(const uint32_t* pb) const {
    return b_hi + (pb - b_lo);
  }
};

// blockIdx.x = unit u, blockIdx.y = 128 x 128 sub-tile (si, sj) of the
// TI x TI tiles. Unit u is tile t = units[u] (< 0: no unit, the block
// leaves) and, when ibs[t + 1] == ibs[t], tile t + 1 beside it: the block
// counts sub-tile (si, sj) of both, A rows shared.
template <class Body>
__global__ void __launch_bounds__(Body::THREADS, Body::MIN_BLOCKS)
    k1_pair_kernel(const uint32_t* __restrict__ packed,
                   const int* __restrict__ ibs, const int* __restrict__ jbs,
                   const int* __restrict__ units, int* __restrict__ out,
                   int n_tiles, int ti, int64_t w) {
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  constexpr int SUB = Body::BM;
  static_assert(Body::BN == 2 * SUB, "two tiles' columns side by side");
  const int t = units[blockIdx.x];
  if (t < 0) return;
  const bool paired = t + 1 < n_tiles && ibs[t + 1] == ibs[t];
  const int nsub = (ti + SUB - 1) / SUB;
  const int si = blockIdx.y / nsub;
  const int sj = blockIdx.y % nsub;
  const int a_rows = min(SUB, ti - si * SUB);
  const int b_rows = min(SUB, ti - sj * SUB);
  const uint32_t* a = packed + (static_cast<int64_t>(ibs[t]) * ti + si * SUB) * w;
  const uint32_t* b_lo = packed + (static_cast<int64_t>(jbs[t]) * ti + sj * SUB) * w;
  const uint32_t* b_hi =
      paired ? packed + (static_cast<int64_t>(jbs[t + 1]) * ti + sj * SUB) * w : b_lo;
  typename Body::Acc acc;
  tile::zero_frags(acc.v);
  const SplitBSource src{a, b_lo, b_hi, paired ? b_rows : 0,
                               static_cast<int>(w)};
  Body::accumulate(acc, src, a_rows, b_rows, w, smem_dyn);
  int* o = out + static_cast<int64_t>(t) * ti * ti +
           static_cast<int64_t>(si) * SUB * ti + sj * SUB;
  Body::store_split(acc, a_rows, b_rows, paired ? b_rows : 0, o,
                    o + static_cast<int64_t>(ti) * ti, ti);
}

// ------------------------------------------------- K0 on the CUDA cores
constexpr int K0_THREADS = 256;
constexpr int K0_WARPS = K0_THREADS / 32;

// One warp per row, grid-stride over rows. VEC: w % 4 == 0 and both bases
// 16-byte aligned, so every row is read as uint4 vectors.
template <bool VEC>
__global__ void __launch_bounds__(K0_THREADS)
    k0_stream_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, int* __restrict__ out,
                     int64_t r, int64_t w, uint32_t salt) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * K0_WARPS + (threadIdx.x >> 5);
  const int64_t step = static_cast<int64_t>(gridDim.x) * K0_WARPS;
  for (int64_t row = first; row < r; row += step) {
    const uint32_t* pa = a + row * w;
    const uint32_t* pb = b + row * w;
    int s = 0;
    if (VEC) {
      const uint4* va = reinterpret_cast<const uint4*>(pa);
      const uint4* vb = reinterpret_cast<const uint4*>(pb);
      const int64_t nv = w / 4;
#pragma unroll 4
      for (int64_t v = lane; v < nv; v += 32) {
        const uint4 x = va[v];
        const uint4 y = vb[v];
        s += __popc((x.x ^ salt) & y.x) + __popc((x.y ^ salt) & y.y) +
             __popc((x.z ^ salt) & y.z) + __popc((x.w ^ salt) & y.w);
      }
    } else {
      for (int64_t k = lane; k < w; k += 32) s += __popc((pa[k] ^ salt) & pb[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
    if (lane == 0) out[row] = s;
  }
}

}  // namespace

extern "C" {

// Output rows per block: the wrapper's grid-limit check.
int k1_block_rows() { return tile::B1Wgmma::BM; }

// packed: int32/uint32 [n_pad, w], w % 4 == 0; ibs, jbs: int32 [t];
// units: int32 [t], the leading tiles first and -1 after them;
// out: int32 [t, ti, ti], ti % 8 == 0.
int k1_tri_launch(const void* packed, const void* ibs, const void* jbs,
                  const void* units, void* out, int t, int ti, long long w,
                  void* stream) {
  using Body = tile::B1Wgmma;
  const int nsub = (ti + Body::BM - 1) / Body::BM;
  const dim3 grid(static_cast<unsigned>(t), static_cast<unsigned>(nsub * nsub));
  return tile::launch<Body>(
      k1_pair_kernel<Body>, grid, stream, static_cast<const uint32_t*>(packed),
      static_cast<const int*>(ibs), static_cast<const int*>(jbs),
      static_cast<const int*>(units), static_cast<int*>(out), t, ti,
      static_cast<int64_t>(w));
}

// a, b: int32/uint32 [r, w]; out: int32 [r]. salt is the uint32 salt's
// int32 bit-view (a C int cannot hold a Python int >= 2^31).
int k0_stream_launch(const void* a, const void* b, void* out, long long r,
                     long long w, int salt, void* stream) {
  const long long want = (r + K0_WARPS - 1) / K0_WARPS;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t u = static_cast<uint32_t>(salt);
  if (vec) {
    k0_stream_kernel<true><<<blocks, K0_THREADS, 0, s>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<int*>(out), r, w, u);
  } else {
    k0_stream_kernel<false><<<blocks, K0_THREADS, 0, s>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<int*>(out), r, w, u);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
