// AdamW's update of one leaf in one elementwise pass, in place, rounding as
// the port's plain update (optim/optimizers.py) and so as the JAX package's
// jitted update.
//
//   adamw_update  replaces the XLA fusion of adamw.update (no Pallas
//                 kernel): src/repro/optim/optimizers.py:67, the update
//                 of every leaf in training.
//
// What it computes, per element, with r() rounding to float32, rM() to the
// moments' dtype, rG() to the grads' dtype and fma() the product and sum
// rounded once (taken in double, where the product of two floats is exact,
// as the plain update takes it):
//   g  = float(g), clipped: rG(r(g * scale))
//   m  = rM(fma(b1, m, r((1 - b1) * g)))
//   v  = rM(fma(b2, v, r((1 - b2) * r(g * g))))
//   q  = r(m / r(bc1 * r(sqrt(r(v / bc2)) + eps)))   XLA's folded form
//   q  = fma(wd, p32, q)                               with weight decay
//   p32 = fma(-lr, q, p32)
// where p32 is the float32 master copy (written back) or the parameter
// upcast, and the parameter is written as p32 rounded to its dtype.  The
// clip scale, bc1 = 1 - b1^step, bc2 and lr are float32 scalars on the
// card, computed there by the caller, so nothing waits on the host.
//
// What bounds it on an H100: bytes.  At qwen3-4b's width (4.41 B
// parameters in bfloat16, float32 grads and moments, no master copy) it
// reads 14 and writes 10 bytes an element, 106 GB, ~31.6 ms at 3.35 TB/s;
// its dozen float and four double operations an element are far below the
// card's rates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) { return __float2bfloat16_rn(v); }

template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// a * b + c rounded once to float32, through double as the plain update.
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__fma_rn((double)a, (double)b, (double)c));
}

struct Scalars {
  const float* scale;  // the clip scale, or null: no clipping
  const float* bc1;
  const float* bc2;
  const float* lr;
  float b1, omb1, b2, omb2, eps, wd;
  int has_wd;
};

// One thread: kUnroll elements, kThreads apart, of each tile of
// kThreads * kUnroll; the grid strides over the tiles.
template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g, M* __restrict__ m,
             M* __restrict__ v, float* __restrict__ w, long long n,
             Scalars s) {
  const bool clip = s.scale != nullptr;
  const float scale = clip ? *s.scale : 1.0f;
  const float bc1 = *s.bc1, bc2 = *s.bc2, nlr = -*s.lr;
  const long long tile = (long long)kThreads * kUnroll;
  for (long long base = blockIdx.x * tile; base < n;
       base += (long long)gridDim.x * tile) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      if (i >= n) break;
      float gf = to_f<G>(g[i]);
      if (clip) gf = rnd<G>(__fmul_rn(gf, scale));
      const float mu =
          rnd<M>(fma64(s.b1, to_f<M>(m[i]), __fmul_rn(s.omb1, gf)));
      const float nu = rnd<M>(fma64(s.b2, to_f<M>(v[i]),
                                    __fmul_rn(s.omb2, __fmul_rn(gf, gf))));
      m[i] = from_f<M>(mu);
      v[i] = from_f<M>(nu);
      float q = __fdiv_rn(
          mu, __fmul_rn(bc1, __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)),
                                       s.eps)));
      const float p32 = w ? w[i] : to_f<P>(p[i]);
      if (s.has_wd) q = fma64(s.wd, p32, q);
      const float out = fma64(nlr, q, p32);
      if (w) w[i] = out;
      p[i] = from_f<P>(out);
    }
  }
}

template <typename P, typename G, typename M>
cudaError_t launch(void* p, const void* g, void* m, void* v, float* w,
                   long long n, const Scalars& s, cudaStream_t stream) {
  const long long tile = (long long)kThreads * kUnroll;
  const long long tiles = (n + tile - 1) / tile;
  const int grid = (int)(tiles < 132 * 16 ? tiles : 132 * 16);
  adamw_kernel<P, G, M><<<grid, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(m),
      static_cast<M*>(v), w, n, s);
  return cudaGetLastError();
}

template <typename P, typename G>
cudaError_t by_m(int m_dtype, void* p, const void* g, void* m, void* v,
                 float* w, long long n, const Scalars& s,
                 cudaStream_t stream) {
  return m_dtype == 0
             ? launch<P, G, float>(p, g, m, v, w, n, s, stream)
             : launch<P, G, __nv_bfloat16>(p, g, m, v, w, n, s, stream);
}

template <typename P>
cudaError_t by_g(int g_dtype, int m_dtype, void* p, const void* g, void* m,
                 void* v, float* w, long long n, const Scalars& s,
                 cudaStream_t stream) {
  return g_dtype == 0
             ? by_m<P, float>(m_dtype, p, g, m, v, w, n, s, stream)
             : by_m<P, __nv_bfloat16>(m_dtype, p, g, m, v, w, n, s, stream);
}

}  // namespace

// One leaf's AdamW update in place: p (n) in p_dtype, g (n) in g_dtype,
// m and v (n) in m_dtype (0 float32 / 1 bfloat16, each), w (n) float32 or
// null (no master copy), all contiguous; scale (null: no clipping), bc1,
// bc2 and lr float32 scalars on the card.  Returns a cudaError_t.
extern "C" int adamw_update(void* p, int p_dtype, const void* g, int g_dtype,
                            void* m, void* v, int m_dtype, float* w,
                            long long n, const float* scale,
                            const float* bc1, const float* bc2,
                            const float* lr, float b1, float omb1, float b2,
                            float omb2, float eps, float wd, int has_wd,
                            cudaStream_t stream) {
  if (n < 0 || (p_dtype != 0 && p_dtype != 1) ||
      (g_dtype != 0 && g_dtype != 1) || (m_dtype != 0 && m_dtype != 1) ||
      !bc1 || !bc2 || !lr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Scalars s{scale, bc1, bc2, lr, b1, omb1, b2, omb2, eps, wd, has_wd};
  return p_dtype == 0
             ? (int)by_g<float>(g_dtype, m_dtype, p, g, m, v, w, n, s, stream)
             : (int)by_g<__nv_bfloat16>(g_dtype, m_dtype, p, g, m, v, w, n, s,
                                        stream);
}
