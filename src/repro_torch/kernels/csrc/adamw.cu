// adamw: one AdamW step over one leaf, in place, in a single pass. Per
// element, in f32 and in the order of the port's per-op update
// (src/repro_torch/kernels/adamw.py `plain`), rounding wherever it rounds:
//
//   g32  = g * scale
//   m    = m * b1 + (1 - b1) * g32            (the add fused, as torch's
//   v    = v * b2 + (1 - b2) * (g32 * g32)     add with alpha is on the card)
//   step = (m / b1c) / (sqrt(v / b2c) + eps)
//   step = step + wd * p                       (leaves of ndim >= 2 only)
//   p    = p - lr * step, rounded to p's dtype
//
// Every operation is an explicit _rn intrinsic, so nvcc's contraction of a
// multiply and an add into an FMA cannot change a rounding. g is bf16, f16
// or f32 and may be a broadcast view: the caller passes its contiguous inner
// tensor of `inner` elements, and element i reads g[i % inner] (the
// compressed step's mean expanded over a leading pod axis is never
// materialised). p is bf16, f16 or f32; m and v are f32. scale, lr, b1c and
// b2c are 0-d f32 tensors on the card, read by pointer, so a step never
// waits on the host.
//
// Replaces no Pallas TPU kernel: the reference's update
// (src/repro/train/optimizer.py `update`) is plain jnp that XLA fuses under
// jit. It was added because the port's per-op update made ~16 passes over
// every parameter (~150 bytes of traffic each) where one pass suffices.
//
// Bound on an H100: bytes. Each element reads g, p, m and v once and writes
// m, v and p once: 22 bytes for bf16 g and p (the plain step), 24 for f32 g
// (the compressed step's decoded mean). Granite-3-8b's 2.19e9 parameters of
// the 10-layer stage take 14.4 / 15.7 ms at 3.35 TB/s; the ~30 f32
// operations an element are far below the card's rate.
//
// Design for that bound:
// * one pass with vector loads and stores of 4 elements (16 bytes of f32,
//   8 of bf16 or f16): a warp takes 256 elements a step, each lane two
//   groups of 4, 128 elements apart, so every access of the warp is one
//   contiguous run (512 bytes of f32). Lanes that each took 8 contiguous
//   elements, two 16-byte f32 accesses 32 bytes apart, ran 0.3-4 % slower
//   at granite-3-8b's leaf shapes on an H100 (700 W). The host takes this
//   path where every pointer is 16-byte aligned and `inner` a multiple of
//   4; a scalar tail covers the last n % 256 elements, and a scalar path
//   misaligned operands;
// * a grid-stride loop over one full wave (SMs x resident blocks a SM), so
//   no block waits for a second wave;
// * no shared memory, no atomics, nothing allocated.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;                 // elements of one vector access
constexpr int kTile = 32 * 2 * kGroup;    // elements a warp takes a step

// element storage type and its conversions to and from f32
struct F32 {
  using S = float;
  static __device__ __forceinline__ float f(S v) { return v; }
  static __device__ __forceinline__ S to(float x) { return x; }
};
struct F16 {
  using S = unsigned short;
  static __device__ __forceinline__ float f(S v) {
    return __half2float(__ushort_as_half(v));
  }
  static __device__ __forceinline__ S to(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};
struct BF16 {
  using S = unsigned short;
  static __device__ __forceinline__ float f(S v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ S to(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <typename S>
struct alignas(kGroup * sizeof(S)) Vec {
  S v[kGroup];
};

// kGroup elements at p (aligned to their size) as f32
template <typename C>
__device__ __forceinline__ void load_group(const typename C::S* p, float* out) {
  const Vec<typename C::S> w = *reinterpret_cast<const Vec<typename C::S>*>(p);
#pragma unroll
  for (int k = 0; k < kGroup; ++k) out[k] = C::f(w.v[k]);
}

// kGroup f32 values rounded into kGroup elements at p (aligned)
template <typename C>
__device__ __forceinline__ void store_group(typename C::S* p, const float* in) {
  Vec<typename C::S> w;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) w.v[k] = C::to(in[k]);
  *reinterpret_cast<Vec<typename C::S>*>(p) = w;
}

struct Hyper {
  float b1, c1, b2, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2 (from f64)
  int decay;
};

struct Scalars {
  float scale, lr, b1c, b2c;
};

// the new p of one element; m and v are updated in place
__device__ __forceinline__ float adamw_one(float g, float p, float& m,
                                           float& v, const Hyper& h,
                                           const Scalars& s) {
  const float g32 = __fmul_rn(g, s.scale);
  m = __fmaf_rn(h.c1, g32, __fmul_rn(m, h.b1));
  v = __fmaf_rn(h.c2, __fmul_rn(g32, g32), __fmul_rn(v, h.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), h.eps);
  float step = __fdiv_rn(__fdiv_rn(m, s.b1c), den);
  if (h.decay) step = __fmaf_rn(h.wd, p, step);
  return __fsub_rn(p, __fmul_rn(step, s.lr));
}

template <typename G, typename P, bool kVec>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const typename G::S* __restrict__ g, typename P::S* __restrict__ p,
             float* __restrict__ m, float* __restrict__ v,
             const float* __restrict__ scale, const float* __restrict__ lr,
             const float* __restrict__ b1c, const float* __restrict__ b2c,
             long long n, long long inner, Hyper h) {
  const Scalars s{*scale, *lr, *b1c, *b2c};
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const bool bcast = inner != n;
  long long done = 0;
  if (kVec) {
    // thread u is lane u % 32 of the warp that takes tile u / 32 (the
    // stride is a whole number of warps, so a thread keeps its lane)
    const long long lanes = n / kTile * 32;
    for (long long u = tid; u < lanes; u += stride) {
      const long long first = (u >> 5) * kTile + (u & 31) * kGroup;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long i = first + j * (kTile / 2);
        float gf[kGroup], pf[kGroup], mf[kGroup], vf[kGroup];
        load_group<G>(g + (bcast ? i % inner : i), gf);
        load_group<P>(p + i, pf);
        load_group<F32>(m + i, mf);
        load_group<F32>(v + i, vf);
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          pf[k] = adamw_one(gf[k], pf[k], mf[k], vf[k], h, s);
        store_group<F32>(m + i, mf);
        store_group<F32>(v + i, vf);
        store_group<P>(p + i, pf);
      }
    }
    done = n / kTile * kTile;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    const float pi = adamw_one(G::f(g[bcast ? i % inner : i]), P::f(p[i]),
                               mi, vi, h, s);
    m[i] = mi;
    v[i] = vi;
    p[i] = P::to(pi);
  }
}

template <typename G, typename P, bool kVec>
int launch(const void* g, void* p, float* m, float* v, const float* scale,
           const float* lr, const float* b1c, const float* b2c, long long n,
           long long inner, const Hyper& h, cudaStream_t stream) {
  auto kernel = adamw_kernel<G, P, kVec>;
  static int per_sm = 0;  // resident blocks a SM, per instantiation
  if (per_sm == 0) {
    int b = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    per_sm = b > 0 ? b : 1;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long work = kVec ? n / kTile * 32 + n % kTile : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long wave = (long long)sms * per_sm;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const typename G::S*>(g), static_cast<typename P::S*>(p), m,
      v, scale, lr, b1c, b2c, n, inner, h);
  return 0;
}

template <typename G, typename P>
int dispatch_vec(const void* g, void* p, float* m, float* v,
                 const float* scale, const float* lr, const float* b1c,
                 const float* b2c, long long n, long long inner, int vec,
                 const Hyper& h, cudaStream_t s) {
  if (vec == kGroup)
    return launch<G, P, true>(g, p, m, v, scale, lr, b1c, b2c, n, inner, h, s);
  if (vec == 1)
    return launch<G, P, false>(g, p, m, v, scale, lr, b1c, b2c, n, inner, h, s);
  return (int)cudaErrorInvalidValue;
}

template <typename G>
int dispatch_p(const void* g, void* p, float* m, float* v, const float* scale,
               const float* lr, const float* b1c, const float* b2c,
               long long n, long long inner, int p_kind, int vec,
               const Hyper& h, cudaStream_t s) {
  switch (p_kind) {
    case 0: return dispatch_vec<G, F32>(g, p, m, v, scale, lr, b1c, b2c, n, inner, vec, h, s);
    case 1: return dispatch_vec<G, F16>(g, p, m, v, scale, lr, b1c, b2c, n, inner, vec, h, s);
    case 2: return dispatch_vec<G, BF16>(g, p, m, v, scale, lr, b1c, b2c, n, inner, vec, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One AdamW step over n elements, in place in p, m and v. g: `inner`
// elements of `g_kind`, read at i % inner (inner divides n); p: n elements
// of `p_kind` (0 f32, 1 f16, 2 bf16); m, v: n f32; scale, lr, b1c, b2c: one
// f32 each on the card. c1 = 1 - b1 and c2 = 1 - b2 are rounded to f32 from
// their f64 values by the caller. decay: add wd * p to the step. vec is 1 or
// 4; with 4 the caller guarantees g, p, m and v 16-byte aligned and inner a
// multiple of 4. Returns cudaGetLastError().
extern "C" int rt_adamw(const void* g, void* p, float* m, float* v,
                        const float* scale, const float* lr, const float* b1c,
                        const float* b2c, long long n, long long inner,
                        int g_kind, int p_kind, float b1, float c1, float b2,
                        float c2, float eps, float wd, int decay, int vec,
                        void* stream) {
  if (n <= 0) return 0;
  if (inner <= 0 || n % inner != 0) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, c1, b2, c2, eps, wd, decay};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (g_kind) {
    case 0: err = dispatch_p<F32>(g, p, m, v, scale, lr, b1c, b2c, n, inner, p_kind, vec, h, s); break;
    case 1: err = dispatch_p<F16>(g, p, m, v, scale, lr, b1c, b2c, n, inner, p_kind, vec, h, s); break;
    case 2: err = dispatch_p<BF16>(g, p, m, v, scale, lr, b1c, b2c, n, inner, p_kind, vec, h, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
