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
// gather (the FTSF read of 256 images of 3x1024x1024 f32) needs ~1.92 ms.
//
// Two variants; the host picks one from the shapes and pointers before the
// launch (kernels/block_gather.py variant()):
//
// * rows (bh == 1, no ragged edge, tile rows a multiple of 16 bytes, x and
//   out 16-byte aligned: the FTSF read's case): a TMA bulk-copy ring. A
//   persistent grid of one CTA per SM walks the (tile, piece of up to 32
//   KiB) pairs interleaved, CTA b taking pairs b, b + G, b + 2G, ..., so
//   the SMs stream neighbouring pieces together (measured on the card a
//   little faster than a contiguous share per CTA). One thread issues 1-D
//   bulk loads (cp.async.bulk ... mbarrier::complete_tx) into a ring of
//   kStages pieces in dynamic shared memory and, as each stage's mbarrier
//   phase completes, a bulk store of that stage back to out (bulk_group);
//   a stage is refilled once its store has read it (wait_group.read). So a
//   copy needs no registers, and every SM keeps ~kStages pieces in flight.
//   Tiles with an id >= n_blocks are zeroed by the CTA's other warps with
//   16-byte stores.
// * tiles (everything else: bh > 1, the compressor's (8, 128) tiles, a
//   ragged edge, narrower words): pure byte movement in words of W =
//   1/2/4/8/16 bytes (the host picks the widest W that divides both
//   pointers, x's row pitch and the tile width in bytes, so every dtype is
//   copied exactly); a 2-D grid of (tile, segment); the ragged edge is
//   masked in the kernel, so no padded copy of x exists.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- rows: the TMA bulk-copy ring ----------------------------------------------

constexpr int kStages = 6;
constexpr long long kPiece = 32 * 1024;  // bytes per ring stage
constexpr int kRingThreads = 128;        // warp 0: the ring; warps 1-3: zeros
constexpr int kRingSmem = kStages * (int)kPiece;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one bulk load of `bytes` from global src into shared dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one bulk store of `bytes` from shared src to global dst, as its own group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

struct RowGather {
  const uint8_t* x;
  const int32_t* ids;
  uint8_t* out;
  long long row_bytes;   // x's row pitch
  long long tile_bytes;  // bw * itemsize
  long long gw;          // tiles per row of x
  long long n_blocks;
  long long pieces;      // pieces per tile

  __device__ bool valid(long long k) const { return ids[k] < n_blocks; }

  // the first of items i, i + stride, ... whose tile is in range, or total
  __device__ long long next(long long i, long long stride, long long total) const {
    while (i < total && !valid(i / pieces)) i += stride;
    return i < total ? i : total;
  }

  __device__ uint32_t bytes(long long i) const {
    const long long left = tile_bytes - (i % pieces) * kPiece;
    return (uint32_t)(left < kPiece ? left : kPiece);
  }

  __device__ const uint8_t* src(long long i) const {
    long long id = ids[i / pieces];
    if (id < 0) id = 0;
    return x + (id / gw) * row_bytes + (id % gw) * tile_bytes + (i % pieces) * kPiece;
  }

  __device__ uint8_t* dst(long long i) const {
    return out + (i / pieces) * tile_bytes + (i % pieces) * kPiece;
  }
};

__global__ void __launch_bounds__(kRingThreads)
gather_rows_tma(RowGather g, long long total) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  const long long stride = gridDim.x;  // CTA b takes items b, b + G, ...
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // items are loaded and stored in the same order; the c-th item goes
    // through stage c % kStages, whose barrier completes phase c / kStages
    long long li = g.next(blockIdx.x, stride, total), si = li;
    long long loaded = 0, stored = 0;
    for (; loaded < kStages && li < total; ++loaded, li = g.next(li + stride, stride, total))
      bulk_load(ring + loaded * kPiece, g.src(li), g.bytes(li), &full[loaded]);
    for (; si < total; ++stored, si = g.next(si + stride, stride, total)) {
      const int s = (int)(stored % kStages);
      bar_wait(&full[s], (uint32_t)((stored / kStages) & 1));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_store(g.dst(si), ring + s * kPiece, g.bytes(si));
      if (stored >= 1 && li < total) {
        // refill the previous item's stage once its store has read it,
        // leaving this item's store in flight
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        const int r = (int)(loaded % kStages);
        bulk_load(ring + r * kPiece, g.src(li), g.bytes(li), &full[r]);
        ++loaded;
        li = g.next(li + stride, stride, total);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  } else if (threadIdx.x >= 32) {
    // the zero tiles (ids >= n_blocks) among this CTA's items
    const int lane = threadIdx.x - 32, nlanes = kRingThreads - 32;
    for (long long i = blockIdx.x; i < total; i += stride) {
      if (g.valid(i / g.pieces)) continue;
      uint4* o = reinterpret_cast<uint4*>(g.dst(i));
      const long long words = g.bytes(i) / 16;
      for (long long w = lane; w < words; w += nlanes) o[w] = make_uint4(0, 0, 0, 0);
    }
  }
}

int device_info(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  err = cudaFuncSetAttribute(gather_rows_tma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRingSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 64) cached[dev] = *sms;
  return 0;
}

// -- tiles: word copies ----------------------------------------------------------

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
void launch_tiles(const void* x, const int32_t* ids, void* out, long long m,
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
// words. word_bytes is 1, 2, 4, 8 or 16. variant 1 is the TMA ring (bh ==
// 1, n_w % bw_w == 0, word_bytes 16: the host checked the rest), 0 the
// word copies. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the variant does not take.
extern "C" int rt_block_gather(const void* x, const int32_t* ids, void* out,
                               long long m, long long n_w, long long bh,
                               long long bw_w, long long k, int word_bytes,
                               int variant, void* stream) {
  if (k <= 0) return 0;
  if (k > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (bh != 1 || word_bytes != 16 || n_w % bw_w != 0 ||
        (uintptr_t)x % 16 != 0 || (uintptr_t)out % 16 != 0)
      return (int)cudaErrorInvalidValue;
    int sms = 0;
    const int err = device_info(&sms);
    if (err != 0) return err;
    RowGather g;
    g.x = static_cast<const uint8_t*>(x);
    g.ids = ids;
    g.out = static_cast<uint8_t*>(out);
    g.row_bytes = n_w * 16;
    g.tile_bytes = bw_w * 16;
    g.gw = n_w / bw_w;
    g.n_blocks = m * g.gw;
    g.pieces = (g.tile_bytes + kPiece - 1) / kPiece;
    const long long total = k * g.pieces;
    const long long ctas = total < sms ? total : sms;
    gather_rows_tma<<<(unsigned)ctas, kRingThreads, kRingSmem, s>>>(g, total);
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  switch (word_bytes) {
    case 1: launch_tiles<uint8_t>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    case 2: launch_tiles<uint16_t>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    case 4: launch_tiles<uint32_t>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    case 8: launch_tiles<unsigned long long>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    case 16: launch_tiles<uint4>(x, ids, out, m, n_w, bh, bw_w, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
