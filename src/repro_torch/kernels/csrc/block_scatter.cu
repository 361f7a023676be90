// block_scatter: write K (bh, bw) tiles over a 2-D operand at row-major grid
// ids. out starts as a copy of base (or is base itself, in place); tile j
// lands at grid id ids[j]. An id in [-n_blocks, 0) counts from the end
// (-1 is the last tile), as JAX's scatter does; any other id outside
// [0, n_blocks) drops. Tile parts beyond the ragged edge of the operand
// are dropped. Duplicate ids are unsupported (which of them lands is not
// defined), as in the reference.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_scatter.py
// (block_scatter, pallas_call at :59), which walks the whole output grid in
// order and pulls each output tile from either base or an incoming tile,
// through an inverse map (output tile -> incoming tile) built by a scatter
// outside the kernel, over a base zero-padded to whole tiles.
//
// Bound on an H100: bytes. base is read once and out written once (none of
// that in place), the K tiles are read once and written once, and the ids
// read once. At 3.35 TB/s the copy of a 12800 x 16384 f32 operand (839 MB)
// takes ~0.5 ms; the tiles of a 5 % top-k add 5 % of that.
//
// Design for that bound:
// * no inverse map: a vectorised copy of base into out (skipped in place),
//   then one block per tile and row segment (grid (K, segments)), each
//   block loading its own id. Blocks run in any order, so they write
//   disjoint tiles only because the ids are unique;
// * pure byte movement in words of W = 1/2/4/8/16 bytes: the host picks
//   the widest W that divides every pointer, the operand's row length and
//   the tile width in bytes, so any dtype is written exactly and the main
//   path's (8, 128) f32 tiles move as 16-byte vectors, one row of a tile
//   per 32 threads, coalesced;
// * the ragged edge is masked in the kernel, so no padded copy exists.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kCopyBlocks = 132 * 8;  // grid-stride copy: 8 blocks per SM

template <typename W>
__global__ void copy_words(const W* __restrict__ src, W* __restrict__ dst,
                           long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride)
    dst[i] = src[i];
}

template <typename W>
__global__ void scatter_tiles(const int32_t* __restrict__ ids,
                              const W* __restrict__ blocks,
                              W* __restrict__ out, long long m, long long n_w,
                              int bh, int bw_w, long long gw,
                              long long n_blocks) {
  const long long k = blockIdx.x;
  long long id = ids[k];
  if (id < 0) id += n_blocks;
  if (id < 0 || id >= n_blocks) return;
  const long long tr = id / gw;
  const long long row0 = tr * bh;
  const long long col0 = (id - tr * gw) * bw_w;
  const long long rem = n_w - col0;
  const int vw = rem < bw_w ? (int)rem : bw_w;  // words of a tile row in out
  const long long rleft = m - row0;
  const int vh = rleft < bh ? (int)rleft : bh;  // tile rows in out
  const int tile_w = bh * bw_w;
  const W* src = blocks + k * tile_w;
  W* dst = out + row0 * n_w + col0;
  const int stride = gridDim.y * blockDim.x;
  const int first = blockIdx.y * blockDim.x + threadIdx.x;
  if (bh == 1) {
    for (int e = first; e < vw; e += stride) dst[e] = src[e];
    return;
  }
  for (int e = first; e < tile_w; e += stride) {
    const int r = e / bw_w;
    const int c = e - r * bw_w;
    if (r < vh && c < vw) dst[(long long)r * n_w + c] = src[e];
  }
}

template <typename W>
void launch(const void* base, void* out, const int32_t* ids,
            const void* blocks, long long m, long long n_w, long long bh,
            long long bw_w, long long k, bool copy, cudaStream_t stream) {
  if (copy) {
    const long long count = m * n_w;
    long long grid = (count + kThreads - 1) / kThreads;
    if (grid > kCopyBlocks) grid = kCopyBlocks;
    copy_words<W><<<(unsigned)grid, kThreads, 0, stream>>>(
        static_cast<const W*>(base), static_cast<W*>(out), count);
  }
  if (k == 0) return;
  const long long gw = (n_w + bw_w - 1) / bw_w;
  const long long gh = (m + bh - 1) / bh;
  const long long tile_w = bh * bw_w;
  long long segs = (tile_w + kThreads * kWordsPerThread - 1) /
                   (kThreads * kWordsPerThread);
  if (segs > 65535) segs = 65535;
  const dim3 grid((unsigned)k, (unsigned)segs);
  scatter_tiles<W><<<grid, kThreads, 0, stream>>>(
      ids, static_cast<const W*>(blocks), static_cast<W*>(out), m, n_w,
      (int)bh, (int)bw_w, gw, gh * gw);
}

}  // namespace

// base, out: (m, n_w) words (the same pointer for in place, with copy = 0);
// ids: (k,) int32 on the device; blocks: (k, bh, bw_w) words. word_bytes is
// 1, 2, 4, 8 or 16. Returns cudaGetLastError().
extern "C" int rt_block_scatter(const void* base, void* out,
                                const int32_t* ids, const void* blocks,
                                long long m, long long n_w, long long bh,
                                long long bw_w, long long k, int word_bytes,
                                int copy, void* stream) {
  if (m <= 0 || n_w <= 0) return 0;
  if (bh <= 0 || bw_w <= 0 || bh * bw_w > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (k < 0 || k > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = copy != 0;
  switch (word_bytes) {
    case 1: launch<uint8_t>(base, out, ids, blocks, m, n_w, bh, bw_w, k, c, s); break;
    case 2: launch<uint16_t>(base, out, ids, blocks, m, n_w, bh, bw_w, k, c, s); break;
    case 4: launch<uint32_t>(base, out, ids, blocks, m, n_w, bh, bw_w, k, c, s); break;
    case 8: launch<unsigned long long>(base, out, ids, blocks, m, n_w, bh, bw_w, k, c, s); break;
    case 16: launch<uint4>(base, out, ids, blocks, m, n_w, bh, bw_w, k, c, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
