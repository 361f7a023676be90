// block_gather: copy K (bh, bw) tiles of a 2-D operand, chosen by row-major
// grid id, into a (K, bh, bw) output. An id >= n_blocks gives a zero tile; a
// negative id reads tile 0 (the plain version clips ids into range the same
// way). Tiles that hang over the ragged edge of x are zero outside it.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_gather.py
// (block_gather, pallas_call at :54), which streams one tile per grid step
// through VMEM from a zero-padded copy of x.
//
// Bound on an H100: bytes. Each selected tile is read once and every output
// byte is written once; there is no arithmetic. At 3.35 TB/s a 3 GiB
// gather (the FTSF read of 256 images of 3x1024x1024 f32) needs ~2 ms.
//
// Design for that bound:
// * pure byte movement in words of W = 1/2/4/8/16 bytes: the host picks the
//   widest W that divides both pointers, x's row pitch and the tile width
//   in bytes, so every dtype (bool and complex included) is copied exactly
//   and the common case moves 16-byte vectors;
// * a 2-D grid of (tile, segment): the main path gathers (1, row_elems)
//   tiles of 12 MiB each with K = 256, so one block per tile would leave
//   most SMs idle; grid.y splits each tile over many blocks;
// * the ragged edge is masked in the kernel, so no padded copy of x exists;
// * bh == 1 (row tiles, the FTSF read) skips the 64-bit division per word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;

template <typename W>
__global__ void gather_tiles(const W* __restrict__ x,
                             const int32_t* __restrict__ ids,
                             W* __restrict__ out, long long m, long long n_w,
                             long long bh, long long bw_w, long long gw,
                             long long n_blocks) {
  const long long k = blockIdx.x;
  long long id = ids[k];
  const bool valid = id < n_blocks;
  if (id < 0) id = 0;
  const long long tr = id / gw;
  const long long col0 = (id - tr * gw) * bw_w;
  const long long rem = n_w - col0;
  const long long vw = rem < bw_w ? rem : bw_w;  // words of a tile row in x
  const long long tile_w = bh * bw_w;
  W* o = out + k * tile_w;
  const long long stride = (long long)gridDim.y * blockDim.x;
  const long long first = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (bh == 1) {
    const W* src = x + tr * n_w + col0;
    for (long long e = first; e < bw_w; e += stride)
      o[e] = (valid && e < vw) ? src[e] : W{};
    return;
  }
  for (long long e = first; e < tile_w; e += stride) {
    const long long r = e / bw_w;
    const long long c = e - r * bw_w;
    const long long xr = tr * bh + r;
    o[e] = (valid && xr < m && c < vw) ? x[xr * n_w + col0 + c] : W{};
  }
}

template <typename W>
void launch(const void* x, const int32_t* ids, void* out, long long m,
            long long n_w, long long bh, long long bw_w, long long k,
            cudaStream_t stream) {
  const long long gw = (n_w + bw_w - 1) / bw_w;
  const long long gh = (m + bh - 1) / bh;
  const long long tile_w = bh * bw_w;
  long long segs = (tile_w + kThreads * kWordsPerThread - 1) /
                   (kThreads * kWordsPerThread);
  if (segs > 65535) segs = 65535;
  const dim3 grid((unsigned)k, (unsigned)segs);
  gather_tiles<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(x), ids, static_cast<W*>(out), m, n_w, bh, bw_w,
      gw, gh * gw);
}

}  // namespace

// x: (m, n_w) words; ids: (k,) int32 on the device; out: (k, bh, bw_w)
// words. word_bytes is 1, 2, 4, 8 or 16. Returns cudaGetLastError().
extern "C" int rt_block_gather(const void* x, const int32_t* ids, void* out,
                               long long m, long long n_w, long long bh,
                               long long bw_w, long long k, int word_bytes,
                               void* stream) {
  if (k <= 0) return 0;
  if (k > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 1: launch<uint8_t>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    case 2: launch<uint16_t>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    case 4: launch<uint32_t>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    case 8: launch<unsigned long long>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    case 16: launch<uint4>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
