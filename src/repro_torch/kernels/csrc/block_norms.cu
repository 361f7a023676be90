// block_norms: the squared L2 norm of every (bh, bw) tile of a 2-D operand,
// summed in f32, one f32 per tile in row-major grid order. Each element is
// cast to f32 first (f64 rounds to nearest), then squared and added with
// separate roundings, as the reference's square-then-sum does. Tiles that
// hang over the ragged edge read as zero outside it.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_norms.py
// (block_norms, pallas_call at :27), which reduces the rows of a (G, B)
// blocked view that its wrapper first materialises with a reshape and a
// transpose (src/repro/kernels/ops.py:153) and pads to whole 8-row tiles.
// The Pallas signature is the case (bh, bw) = (1, B) on that (G, B) view.
//
// Bound on an H100: bytes. Every input byte is read once and one f32 is
// written per tile; the arithmetic (two flops per element) is far below
// the card's rate. At 3.35 TB/s the embedding gradient of granite-3-8b
// (49155 x 4096 f32, 805 MB) needs ~0.24 ms.
//
// Design for that bound:
// * tiles are read in place from x, so the blocked copy never exists;
// * one warp per tile, 8 tiles per 256-thread block, for tiles of up to
//   kWarpTileVecs loads: at the main path's (8, 128) f32 tile each lane
//   loads one 16-byte vector per tile row, so each row is one coalesced
//   512-byte read, and 8 tiles per block keep all 132 SMs busy;
// * one 256-thread block per tile for longer tiles ((1, B) with a large
//   B), reduced through shared memory;
// * loads of V elements: 16 bytes where x's pointer, its row length and the
//   tile width allow it (the host decides), else one element;
// * partial sums combine by warp shuffle; no atomics, so a given launch
//   configuration sums in a fixed order.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kWarpTileVecs = 2048;  // above: one block per tile

// element storage type and its conversion to f32
struct F32 {
  using S = float;
  static __device__ __forceinline__ float f(S v) { return v; }
};
struct F64 {
  using S = double;
  static __device__ __forceinline__ float f(S v) { return __double2float_rn(v); }
};
struct F16 {
  using S = unsigned short;
  static __device__ __forceinline__ float f(S v) {
    return __half2float(__ushort_as_half(v));
  }
};
struct BF16 {
  using S = unsigned short;
  static __device__ __forceinline__ float f(S v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
};

template <typename S, int V>
struct alignas(sizeof(S) * V) Vec {
  S v[V];
};

// acc + the squares of the V elements at p (p aligned to V elements)
template <typename C, int V>
__device__ __forceinline__ float add_squares(float acc,
                                             const typename C::S* p) {
  const Vec<typename C::S, V> w =
      *reinterpret_cast<const Vec<typename C::S, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float f = C::f(w.v[i]);
    acc = __fadd_rn(acc, __fmul_rn(f, f));
  }
  return acc;
}

// This thread's share of one tile: thread `t` of `nt` threads on the tile.
// rows: tile rows inside x; vecs: V-element loads per row inside x.
template <typename C, int V>
__device__ __forceinline__ float tile_share(const typename C::S* base,
                                            long long n, int rows, int vecs,
                                            int t, int nt) {
  float acc = 0.f;
  if (vecs >= nt) {  // whole rows: no division per load
    for (int r = 0; r < rows; ++r) {
      const typename C::S* row = base + (long long)r * n;
      for (int c = t; c < vecs; c += nt) acc = add_squares<C, V>(acc, row + c * V);
    }
  } else {
    const int total = rows * vecs;
    for (int e = t; e < total; e += nt) {
      const int r = e / vecs;
      const int c = e - r * vecs;
      acc = add_squares<C, V>(acc, base + (long long)r * n + c * V);
    }
  }
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Tile {
  long long offset;  // element offset of the tile's first element in x
  int rows, vecs;    // rows and V-element loads per row inside x
};

template <int V>
__device__ __forceinline__ Tile locate(long long tile, long long m,
                                       long long n, int bh, int bw_v,
                                       long long gw) {
  const long long tr = tile / gw;
  const long long tc = tile - tr * gw;
  const long long row0 = tr * bh;
  const long long col0 = tc * (long long)bw_v * V;
  const long long rows = m - row0 < bh ? m - row0 : bh;
  const long long left = (n - col0 + V - 1) / V;
  Tile t;
  t.offset = row0 * n + col0;
  t.rows = (int)rows;
  t.vecs = (int)(left < bw_v ? left : bw_v);
  return t;
}

template <typename C, int V>
__global__ void norms_warp(const typename C::S* __restrict__ x,
                           float* __restrict__ out, long long m, long long n,
                           int bh, int bw_v, long long gw, long long n_tiles) {
  const long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const Tile t = locate<V>(tile, m, n, bh, bw_v, gw);
  const float acc = warp_sum(
      tile_share<C, V>(x + t.offset, n, t.rows, t.vecs, lane, 32));
  if (lane == 0) out[tile] = acc;
}

template <typename C, int V>
__global__ void norms_block(const typename C::S* __restrict__ x,
                            float* __restrict__ out, long long m, long long n,
                            int bh, int bw_v, long long gw) {
  __shared__ float partial[kWarps];
  const long long tile = blockIdx.x;
  const Tile t = locate<V>(tile, m, n, bh, bw_v, gw);
  const float acc = warp_sum(
      tile_share<C, V>(x + t.offset, n, t.rows, t.vecs, threadIdx.x, kThreads));
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, partial[w]);
    out[tile] = s;
  }
}

template <typename C, int V>
void launch(const void* x, float* out, long long m, long long n, int bh,
            int bw, cudaStream_t stream) {
  const long long gh = (m + bh - 1) / bh;
  const long long gw = (n + bw - 1) / bw;
  const long long n_tiles = gh * gw;
  const int bw_v = bw / V;
  const auto* xs = static_cast<const typename C::S*>(x);
  if ((long long)bh * bw_v <= kWarpTileVecs) {
    const long long blocks = (n_tiles + kWarps - 1) / kWarps;
    norms_warp<C, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xs, out, m, n, bh, bw_v, gw, n_tiles);
  } else {
    norms_block<C, V><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
        xs, out, m, n, bh, bw_v, gw);
  }
}

template <typename C>
int dispatch(const void* x, float* out, long long m, long long n, int bh,
             int bw, int vec, cudaStream_t s) {
  constexpr int kWide = 16 / (int)sizeof(typename C::S);
  if (vec == kWide)
    launch<C, kWide>(x, out, m, n, bh, bw, s);
  else if (vec == 1)
    launch<C, 1>(x, out, m, n, bh, bw, s);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x: (m, n) elements of `kind` (0 f32, 1 f64, 2 f16, 3 bf16); out:
// (ceil(m/bh) * ceil(n/bw),) f32. vec is 1 or 16 / itemsize; with 16 the
// caller guarantees x is 16-byte aligned and n and bw are multiples of vec.
// Returns cudaGetLastError().
extern "C" int rt_block_norms(const void* x, float* out, long long m,
                              long long n, long long bh, long long bw,
                              int kind, int vec, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bh <= 0 || bw <= 0 || bh * bw > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = ((m + bh - 1) / bh) * ((n + bw - 1) / bw);
  if (n_tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (kind) {
    case 0: err = dispatch<F32>(x, out, m, n, (int)bh, (int)bw, vec, s); break;
    case 1: err = dispatch<F64>(x, out, m, n, (int)bh, (int)bw, vec, s); break;
    case 2: err = dispatch<F16>(x, out, m, n, (int)bh, (int)bw, vec, s); break;
    case 3: err = dispatch<BF16>(x, out, m, n, (int)bh, (int)bw, vec, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
