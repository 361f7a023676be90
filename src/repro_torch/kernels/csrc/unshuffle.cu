// unshuffle: the byte-plane transpose of frame decode. planes is the
// (itemsize, n) uint8 matrix whose row p holds byte p of every item; out is
// the (n, itemsize) item matrix, i.e. the raw buffer.
//
// Replaces the Pallas TPU kernel src/repro/kernels/unshuffle.py
// (byte_unshuffle_planes, pallas_call at :36), which transposes one
// (itemsize, 512) slab per grid step in VMEM.
//
// Bound on an H100: bytes. n * itemsize bytes are read once and written
// once; a 12 MiB chunk needs ~7.5 us at 3.35 TB/s. On the read path the
// planes come from host memory and go back to it, so the hook
// (kernels/ops.py unshuffle_host) is bounded by that PCIe round trip and
// the host copies around it, not by this kernel.
//
// Design: one block per tile of kTile items goes through shared memory;
// the common item widths (2, 4, 8, 16) are compiled as constants.
// Loads walk each plane along n, so a warp reads consecutive bytes (4-byte
// words when every plane row is 4-byte aligned); stores walk the tile's
// contiguous output bytes and write 4-byte words. A plane row in shared
// memory is padded by 4 bytes so the itemsize rows fall in different banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;          // items per block
constexpr int kPitch = kTile + 4;    // shared-memory bytes per plane row
constexpr int kThreads = 256;

// kItemsize > 0 fixes the item width at compile time, so the byte
// addressing of the store loop is shifts; 0 reads `runtime_itemsize`.
template <int kItemsize>
__global__ void unshuffle_tiles(const uint8_t* __restrict__ planes,
                                uint8_t* __restrict__ out, long long n,
                                int runtime_itemsize, int vec_loads) {
  extern __shared__ uint8_t tile[];  // itemsize rows of kPitch bytes
  const int itemsize = kItemsize > 0 ? kItemsize : runtime_itemsize;
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long left = n - t0;
  const int cnt = left < kTile ? (int)left : kTile;
  if (vec_loads) {  // n % 4 == 0 and planes 4-byte aligned
    const int cw = cnt / 4;  // cnt is a multiple of 4 here
    for (int p = 0; p < itemsize; ++p) {
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(planes + p * n + t0);
      uint32_t* dst = reinterpret_cast<uint32_t*>(tile + p * kPitch);
      for (int i = threadIdx.x; i < cw; i += blockDim.x) dst[i] = src[i];
    }
  } else {
    for (int p = 0; p < itemsize; ++p) {
      const uint8_t* src = planes + p * n + t0;
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        tile[p * kPitch + i] = src[i];
    }
  }
  __syncthreads();
  // the tile's items are cnt * itemsize contiguous output bytes; t0 * itemsize
  // is a multiple of 4 because kTile is
  uint8_t* o = out + t0 * itemsize;
  const int nbytes = cnt * itemsize;
  const int nwords = nbytes / 4;
  uint32_t* ow = reinterpret_cast<uint32_t*>(o);
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = 4 * w + b;
      v |= (uint32_t)tile[(j % itemsize) * kPitch + j / itemsize] << (8 * b);
    }
    ow[w] = v;
  }
  for (int j = 4 * nwords + threadIdx.x; j < nbytes; j += blockDim.x)
    o[j] = tile[(j % itemsize) * kPitch + j / itemsize];
}

template <int kItemsize>
void launch(const uint8_t* planes, uint8_t* out, long long n, int itemsize,
            unsigned blocks, int vec, cudaStream_t s) {
  unshuffle_tiles<kItemsize><<<blocks, kThreads, itemsize * kPitch, s>>>(
      planes, out, n, itemsize, vec);
}

}  // namespace

// planes: (itemsize, n) uint8 with itemsize <= 32 (the tile stays under the
// 48 KiB of shared memory a block gets without opting in); out: (n,
// itemsize) uint8, 4-byte aligned. Returns cudaGetLastError().
extern "C" int rt_unshuffle(const uint8_t* planes, uint8_t* out, long long n,
                            int itemsize, void* stream) {
  if (n <= 0) return 0;
  if (itemsize < 1 || itemsize > 32) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int vec = (n % 4 == 0) && ((uintptr_t)planes % 4 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = (unsigned)blocks;
  switch (itemsize) {
    case 2: launch<2>(planes, out, n, itemsize, b, vec, s); break;
    case 4: launch<4>(planes, out, n, itemsize, b, vec, s); break;
    case 8: launch<8>(planes, out, n, itemsize, b, vec, s); break;
    case 16: launch<16>(planes, out, n, itemsize, b, vec, s); break;
    default: launch<0>(planes, out, n, itemsize, b, vec, s); break;
  }
  return (int)cudaGetLastError();
}
