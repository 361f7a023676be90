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
// (kernels/ops.py unshuffle_host) is bounded by those two PCIe transfers,
// not by this kernel.
//
// Two variants; the host picks one from the shapes and pointers before the
// launch (kernels/unshuffle.py variant()):
//
// * register (itemsize 2, 4, 8 or 16; out 16-byte aligned; any n, planes
//   at any alignment): no shared memory. Each thread makes 16 contiguous
//   output bytes, i.e. 16 / itemsize items: it loads 16 / itemsize bytes
//   from each plane at the same item offset (so a warp reads contiguous
//   bytes of every plane), transposes them in registers with __byte_perm
//   and writes one 16-byte store (a warp writes 512 contiguous bytes).
//   A plane row that is not aligned to its load width (a frame covers a
//   whole part file, so n, and with it every row after the first, is
//   rarely aligned) is read with aligned words and a funnel shift; the
//   last n % (16 / itemsize) items are copied byte by byte. Four units per
//   loop, unrolled, keep several independent loads in flight; the grid is
//   a fixed multiple of the SM count and strides over n.
// * shared (the other itemsizes, 1-32):
//   one block per tile of kTile items goes through shared memory. Loads
//   walk each plane along n (4-byte words when every plane row is 4-byte
//   aligned); stores walk the tile's contiguous output bytes and write
//   4-byte words. A plane row in shared memory is padded by 4 bytes so the
//   itemsize rows fall in different banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- register variant ----------------------------------------------------------

constexpr int kRegThreads = 256;
constexpr int kUnroll = 4;        // 16-byte units per thread per loop
constexpr int kBlocksPerSm = 8;   // 2048 threads: a full SM

// Bytes of each plane in one unit, loaded into r as 32-bit words: two words
// per plane for itemsize 2, one for 4, the low 16 / 8 bits of one for 8 / 16.
template <int B>
struct Unit {
  static constexpr int kPer = 16 / B;
  static constexpr int kWords = B * (kPer == 8 ? 2 : 1);
};

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// The bytes at src, at any alignment, from aligned loads only. Each aligned
// word loaded holds at least one wanted byte, so no load leaves the pages of
// the planes. A plane row's alignment is the same for every unit, so the
// branches are uniform across a warp.
__device__ __forceinline__ void load8(const uint8_t* src, uint32_t& lo, uint32_t& hi) {
  const unsigned s = (unsigned)(reinterpret_cast<uintptr_t>(src) & 7);
  if (s == 0) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
    lo = t.x;
    hi = t.y;
    return;
  }
  const uint8_t* base = src - (s & 3);
  const uint32_t w0 = ld32(base), w1 = ld32(base + 4);
  if ((s & 3) == 0) {
    lo = w0;
    hi = w1;
    return;
  }
  const uint32_t w2 = ld32(base + 8);
  lo = __funnelshift_r(w0, w1, 8 * (s & 3));
  hi = __funnelshift_r(w1, w2, 8 * (s & 3));
}

__device__ __forceinline__ uint32_t load4(const uint8_t* src) {
  const unsigned s = (unsigned)(reinterpret_cast<uintptr_t>(src) & 3);
  if (s == 0) return ld32(src);
  return __funnelshift_r(ld32(src - s), ld32(src - s + 4), 8 * s);
}

__device__ __forceinline__ uint32_t load2(const uint8_t* src) {
  if ((reinterpret_cast<uintptr_t>(src) & 1) == 0)
    return __ldg(reinterpret_cast<const unsigned short*>(src));
  return (uint32_t)__ldg(src) | ((uint32_t)__ldg(src + 1) << 8);
}

template <int B>
__device__ __forceinline__ void load_unit(const uint8_t* __restrict__ planes,
                                          long long n, long long u,
                                          uint32_t (&r)[Unit<B>::kWords]) {
  constexpr int kPer = Unit<B>::kPer;
  const uint8_t* src = planes + u * kPer;
#pragma unroll
  for (int p = 0; p < B; ++p, src += n) {
    if constexpr (kPer == 8) {
      load8(src, r[2 * p], r[2 * p + 1]);
    } else if constexpr (kPer == 4) {
      r[p] = load4(src);
    } else if constexpr (kPer == 2) {
      r[p] = load2(src);
    } else {
      r[p] = __ldg(src);
    }
  }
}

// __byte_perm(a, b, s): byte i of the result is byte (s >> 4i) & 7 of the
// pair (a = bytes 0-3, b = bytes 4-7).
template <int B>
__device__ __forceinline__ uint4 transpose_unit(const uint32_t (&r)[Unit<B>::kWords]) {
  if constexpr (B == 2) {  // r: plane a words 0-1, plane b words 2-3
    return make_uint4(__byte_perm(r[0], r[2], 0x5140), __byte_perm(r[0], r[2], 0x7362),
                      __byte_perm(r[1], r[3], 0x5140), __byte_perm(r[1], r[3], 0x7362));
  } else if constexpr (B == 4) {  // r[p]: byte p of items 0-3
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // a0 b0 a1 b1
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // a2 b2 a3 b3
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);  // c0 d0 c1 d1
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);  // c2 d2 c3 d3
    return make_uint4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                      __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
  } else if constexpr (B == 8) {  // r[p]: byte p of items 0-1 (low half)
    const uint32_t v0 = __byte_perm(r[0], r[1], 0x5140);  // p0 p1 of items 0, 1
    const uint32_t v1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t v2 = __byte_perm(r[4], r[5], 0x5140);
    const uint32_t v3 = __byte_perm(r[6], r[7], 0x5140);
    return make_uint4(__byte_perm(v0, v1, 0x5410), __byte_perm(v2, v3, 0x5410),
                      __byte_perm(v0, v1, 0x7632), __byte_perm(v2, v3, 0x7632));
  } else {  // B == 16, r[p]: byte p of the one item (low byte)
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = __byte_perm(__byte_perm(r[4 * q], r[4 * q + 1], 0x0040),
                         __byte_perm(r[4 * q + 2], r[4 * q + 3], 0x0040), 0x5410);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// units = n / (16 / B) whole output vectors; the last n % (16 / B) items
// (under 16 bytes of out) are copied byte by byte. out is 16-byte aligned;
// planes may have any alignment.
template <int B>
__global__ void __launch_bounds__(kRegThreads)
unshuffle_regs(const uint8_t* __restrict__ planes, uint8_t* __restrict__ out,
               long long n, long long units) {
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long u = first; u < units; u += kUnroll * stride) {
    uint32_t r[kUnroll][Unit<B>::kWords] = {};
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (u + k * stride < units) load_unit<B>(planes, n, u + k * stride, r[k]);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (u + k * stride < units) out4[u + k * stride] = transpose_unit<B>(r[k]);
  }
  const long long done = units * Unit<B>::kPer;
  for (long long j = first; j < (n - done) * B; j += stride)
    out[done * B + j] = planes[(j % B) * n + done + j / B];
}

// -- shared-memory variant -----------------------------------------------------

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
void launch_tiles(const uint8_t* planes, uint8_t* out, long long n,
                  int itemsize, unsigned blocks, int vec, cudaStream_t s) {
  unshuffle_tiles<kItemsize><<<blocks, kThreads, itemsize * kPitch, s>>>(
      planes, out, n, itemsize, vec);
}

template <int B>
void launch_regs(const uint8_t* planes, uint8_t* out, long long n, int sms,
                 cudaStream_t s) {
  const long long units = n / Unit<B>::kPer;
  long long blocks = (units + kRegThreads - 1) / kRegThreads;
  if (blocks > (long long)sms * kBlocksPerSm) blocks = (long long)sms * kBlocksPerSm;
  if (blocks < 1) blocks = 1;  // n < 16 / B: the tail alone
  unshuffle_regs<B><<<(unsigned)blocks, kRegThreads, 0, s>>>(planes, out, n, units);
}

int sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 64) cached[dev] = *sms;
  return 0;
}

}  // namespace

// The frame-decode hook's upload: `bytes` of host memory (the planes,
// straight from their pageable buffer) to the card, one transfer on stream.
extern "C" int rt_upload_planes(uint8_t* rows, const uint8_t* planes,
                                long long bytes, void* stream) {
  if (bytes <= 0) return 0;
  return (int)cudaMemcpyAsync(rows, planes, (size_t)bytes,
                              cudaMemcpyHostToDevice,
                              static_cast<cudaStream_t>(stream));
}

// planes: (itemsize, n) uint8; out: (n, itemsize) uint8, 4-byte aligned.
// variant 1 is the register transpose (itemsize 2/4/8/16, out 16-byte
// aligned; any n, planes at any alignment), 0 the shared-memory tiles (itemsize <=
// 32: the tile stays under the 48 KiB of shared memory a block gets
// without opting in). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments the variant does not take.
extern "C" int rt_unshuffle(const uint8_t* planes, uint8_t* out, long long n,
                            int itemsize, int variant, void* stream) {
  if (n <= 0) return 0;
  if (itemsize < 1 || itemsize > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if ((uintptr_t)out % 16 != 0) return (int)cudaErrorInvalidValue;
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != 0) return err;
    switch (itemsize) {
      case 2: launch_regs<2>(planes, out, n, sms, s); break;
      case 4: launch_regs<4>(planes, out, n, sms, s); break;
      case 8: launch_regs<8>(planes, out, n, sms, s); break;
      case 16: launch_regs<16>(planes, out, n, sms, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int vec = (n % 4 == 0) && ((uintptr_t)planes % 4 == 0);
  const unsigned b = (unsigned)blocks;
  switch (itemsize) {
    case 2: launch_tiles<2>(planes, out, n, itemsize, b, vec, s); break;
    case 4: launch_tiles<4>(planes, out, n, itemsize, b, vec, s); break;
    case 8: launch_tiles<8>(planes, out, n, itemsize, b, vec, s); break;
    case 16: launch_tiles<16>(planes, out, n, itemsize, b, vec, s); break;
    default: launch_tiles<0>(planes, out, n, itemsize, b, vec, s); break;
  }
  return (int)cudaGetLastError();
}
