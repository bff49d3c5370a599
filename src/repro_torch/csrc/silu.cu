// silu in one elementwise pass, rounding as the JAX package's jax.nn.silu.
//
//   silu  replaces the XLA fusion of jax.nn.silu (no Pallas kernel):
//         src/repro/models/layers.py:142 (the SwiGLU gate, times x @ up)
//         and src/repro/models/ssm.py:71, :111 (the Mamba2 conv activation
//         and its output gate, times y)
//
// What it computes: for x (rows, cols) in float32 or bfloat16 (the last dim
// contiguous, rows at a stride), as jax.nn.silu writes it under jax.jit,
//   s = r(x * r(1 / r(1 + r(exp(-x)))))          r() rounds to x's dtype
// and, with a second operand u (rows, cols) in x's dtype or float32,
//   y = s * u                                    rounded to y's dtype
// else y = s; y is contiguous, in x's dtype or float32 (where the product
// feeds a norm's float32 unrounded).  Each op rounds once, as written: the
// library's silu rounds x * sigmoid(x) once, which in bfloat16 differs on
// ~37% of the elements; five eager ops round as here but read and write
// the tensor five times.
//
// What bounds it on an H100: bytes.  At qwen3-4b's prefill MLP (4 x 2048
// rows of 9728) x and u are read once and y written once in bfloat16,
// 0.48 GB, ~0.14 ms at 3.35 TB/s; the exp and divide per element are far
// below the CUDA cores' rate.  A thread moves 16 bytes of x a load where
// every operand's base, row stride and width allow it, one element
// otherwise.
//
//   silu_bwd  replaces the XLA fusion of jitted jax.vjp of
//             jax.nn.silu(g) * u (no Pallas kernel): the gradient of the
//             SwiGLU gate, src/repro/models/layers.py:142, and of the
//             Mamba2 output gate y * silu(z), src/repro/models/ssm.py:111
//             (its float32 output gradient rounded to bf16 first, as the
//             transpose of the upcast into the norm rounds it), in
//             training; and without u, of jax.nn.silu(g) alone: the Mamba2
//             conv's activation, src/repro/models/ssm.py:75.
//
// What it computes: for g, u, dy (rows, cols) in one dtype, float32 or
// bfloat16, at the rounding sites of the compiled vjp (r() rounds to the
// dtype, as XLA's CPU fusion converts after every op):
//   s  = r(1 / r(1 + r(exp(-g))))                 the forward's sigmoid
//   i  = r(dy * u)                                (dy without u)
//   dg = r(r(i * s) + r(r(g * i) * r(s * r(1 - s))))
//   du = r(r(g * s) * dy)                         (not without u)
// and in float32, where nothing rounds between the ops and LLVM contracts
// the outer sum, dg = fma(i, s, (g * i) * (s * (1 - s))).
// dg and du contiguous in the inputs' dtype.  What bounds it: bytes, as
// the forward; at qwen3-4b's training MLP (4096 x 9728, bf16) g, u and dy
// are read once and dg and du written once, 0.40 GB, ~0.12 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// v rounded to T, as float
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

// One thread: V consecutive elements of one row.  U = void: no product.
template <typename T, typename U, typename O, int V>
__global__ void __launch_bounds__(kThreads)
silu_kernel(const T* __restrict__ x, long long x_rs,
            const U* __restrict__ u, long long u_rs, O* __restrict__ y,
            long long rows, int cols) {
  const int packs = cols / V;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < packs;
         c += gridDim.x * kThreads) {
      const Pack<T, V> xp =
          reinterpret_cast<const Pack<T, V>*>(x + r * x_rs)[c];
      Pack<O, V> yp;
      float s[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xv = to_f<T>(xp.v[i]);
        const float e = rnd<T>(expf(-xv));
        const float d = rnd<T>(1.0f + e);
        const float q = rnd<T>(1.0f / d);
        s[i] = rnd<T>(xv * q);
      }
      if constexpr (sizeof(U) > 1) {
        const Pack<U, V> up =
            reinterpret_cast<const Pack<U, V>*>(u + r * u_rs)[c];
#pragma unroll
        for (int i = 0; i < V; ++i) yp.v[i] = from_f<O>(s[i] * to_f<U>(up.v[i]));
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) yp.v[i] = from_f<O>(s[i]);
      }
      reinterpret_cast<Pack<O, V>*>(y + r * (long long)cols)[c] = yp;
    }
  }
}

// One thread: V consecutive elements of one row of the gradient; without
// u (HasU false) u and du are not read or written.
template <typename T, int V, bool HasU>
__global__ void __launch_bounds__(kThreads)
silu_bwd_kernel(const T* __restrict__ g, long long g_rs,
                const T* __restrict__ u, long long u_rs,
                const T* __restrict__ dy, long long dy_rs,
                T* __restrict__ dg, T* __restrict__ du, long long rows,
                int cols) {
  const int packs = cols / V;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < packs;
         c += gridDim.x * kThreads) {
      const Pack<T, V> gp =
          reinterpret_cast<const Pack<T, V>*>(g + r * g_rs)[c];
      const Pack<T, V> dp =
          reinterpret_cast<const Pack<T, V>*>(dy + r * dy_rs)[c];
      Pack<T, V> up, gout, uout;
      if constexpr (HasU)
        up = reinterpret_cast<const Pack<T, V>*>(u + r * u_rs)[c];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float gv = to_f<T>(gp.v[k]), dyv = to_f<T>(dp.v[k]);
        const float e = rnd<T>(expf(-gv));
        const float s = rnd<T>(1.0f / rnd<T>(1.0f + e));
        const float i = HasU ? rnd<T>(dyv * to_f<T>(up.v[k])) : dyv;
        const float m = rnd<T>(rnd<T>(gv * i) * rnd<T>(s * rnd<T>(1.0f - s)));
        if constexpr (sizeof(T) == 4)
          gout.v[k] = from_f<T>(__fmaf_rn(i, s, m));
        else
          gout.v[k] = from_f<T>(rnd<T>(i * s) + m);
        if constexpr (HasU) uout.v[k] = from_f<T>(rnd<T>(s * gv) * dyv);
      }
      reinterpret_cast<Pack<T, V>*>(dg + r * (long long)cols)[c] = gout;
      if constexpr (HasU)
        reinterpret_cast<Pack<T, V>*>(du + r * (long long)cols)[c] = uout;
    }
  }
}

// A byte stands for "no second operand" (sizeof(U) == 1 above).
using None = unsigned char;

bool aligned(const void* p, long long row_stride, int elem, int v) {
  const long long bytes = (long long)elem * v;
  return p == nullptr || ((uintptr_t)p % bytes == 0 &&
                          (row_stride * elem) % bytes == 0);
}

template <typename T, typename U, typename O>
cudaError_t launch(const void* x, long long x_rs, const void* u,
                   long long u_rs, void* y, long long rows, int cols,
                   cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = cols % kV == 0 && aligned(x, x_rs, sizeof(T), kV) &&
                   aligned(u, u_rs, sizeof(U), kV) &&
                   aligned(y, cols, sizeof(O), kV);
  const int v = vec ? kV : 1;
  const int per_row = (cols / v + kThreads - 1) / kThreads;
  dim3 grid(per_row, (unsigned)(rows < 65535 ? rows : 65535));
  const T* xt = static_cast<const T*>(x);
  const U* ut = static_cast<const U*>(u);
  O* yt = static_cast<O*>(y);
  if (vec)
    silu_kernel<T, U, O, kV><<<grid, kThreads, 0, stream>>>(
        xt, x_rs, ut, u_rs, yt, rows, cols);
  else
    silu_kernel<T, U, O, 1><<<grid, kThreads, 0, stream>>>(
        xt, x_rs, ut, u_rs, yt, rows, cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, long long g_rs, const void* u,
                       long long u_rs, const void* dy, long long dy_rs,
                       void* dg, void* du, long long rows, int cols,
                       cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int e = sizeof(T);
  const bool vec = cols % kV == 0 && aligned(g, g_rs, e, kV) &&
                   aligned(u, u_rs, e, kV) && aligned(dy, dy_rs, e, kV) &&
                   aligned(dg, cols, e, kV) && aligned(du, cols, e, kV);
  const int v = vec ? kV : 1;
  const int per_row = (cols / v + kThreads - 1) / kThreads;
  dim3 grid(per_row, (unsigned)(rows < 65535 ? rows : 65535));
  const T* gt = static_cast<const T*>(g);
  const T* ut = static_cast<const T*>(u);
  const T* dt = static_cast<const T*>(dy);
  T* dgt = static_cast<T*>(dg);
  T* dut = static_cast<T*>(du);
  if (vec && u)
    silu_bwd_kernel<T, kV, true><<<grid, kThreads, 0, stream>>>(
        gt, g_rs, ut, u_rs, dt, dy_rs, dgt, dut, rows, cols);
  else if (vec)
    silu_bwd_kernel<T, kV, false><<<grid, kThreads, 0, stream>>>(
        gt, g_rs, ut, u_rs, dt, dy_rs, dgt, dut, rows, cols);
  else if (u)
    silu_bwd_kernel<T, 1, true><<<grid, kThreads, 0, stream>>>(
        gt, g_rs, ut, u_rs, dt, dy_rs, dgt, dut, rows, cols);
  else
    silu_bwd_kernel<T, 1, false><<<grid, kThreads, 0, stream>>>(
        gt, g_rs, ut, u_rs, dt, dy_rs, dgt, dut, rows, cols);
  return cudaGetLastError();
}

}  // namespace

// x (rows, cols) at row stride x_rs (elements), dtype 0 float32 / 1
// bfloat16; u null or (rows, cols) at row stride u_rs, u_dtype 0 / 1;
// y (rows, cols) contiguous, y_dtype 0 / 1.  Combinations: y in x's dtype
// with u absent or in x's dtype, or y float32 with u in x's dtype or
// float32.  Returns a cudaError_t.
extern "C" int silu(const void* x, long long x_rs, const void* u,
                    long long u_rs, int u_dtype, void* y, int y_dtype,
                    long long rows, int cols, int dtype,
                    cudaStream_t stream) {
  if (rows < 0 || cols < 0 || (dtype != 0 && dtype != 1) ||
      (y_dtype != 0 && y_dtype != 1) || (u && u_dtype != 0 && u_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  using BF = __nv_bfloat16;
  if (dtype == 0) {
    if (y_dtype != 0 || (u && u_dtype != 0)) return (int)cudaErrorInvalidValue;
    return u ? (int)launch<float, float, float>(x, x_rs, u, u_rs, y, rows,
                                                cols, stream)
             : (int)launch<float, None, float>(x, x_rs, nullptr, 0, y, rows,
                                               cols, stream);
  }
  if (!u) {
    if (y_dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch<BF, None, BF>(x, x_rs, nullptr, 0, y, rows, cols,
                                     stream);
  }
  if (y_dtype == 1) {
    if (u_dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch<BF, BF, BF>(x, x_rs, u, u_rs, y, rows, cols, stream);
  }
  return u_dtype == 1
             ? (int)launch<BF, BF, float>(x, x_rs, u, u_rs, y, rows, cols,
                                          stream)
             : (int)launch<BF, float, float>(x, x_rs, u, u_rs, y, rows, cols,
                                             stream);
}

// The gradient of silu(g) * u for dy: g, u, dy (rows, cols) at row
// strides g_rs, u_rs, dy_rs (elements), all of dtype 0 float32 / 1
// bfloat16; dg and du (rows, cols) contiguous in that dtype.  u and du both
// null: the gradient of silu(g).  Returns a cudaError_t.
extern "C" int silu_bwd(const void* g, long long g_rs, const void* u,
                        long long u_rs, const void* dy, long long dy_rs,
                        void* dg, void* du, long long rows, int cols,
                        int dtype, cudaStream_t stream) {
  if (rows < 0 || cols < 0 || (dtype != 0 && dtype != 1) || !u != !du)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  if (dtype == 0)
    return (int)launch_bwd<float>(g, g_rs, u, u_rs, dy, dy_rs, dg, du, rows,
                                  cols, stream);
  return (int)launch_bwd<__nv_bfloat16>(g, g_rs, u, u_rs, dy, dy_rs, dg, du,
                                        rows, cols, stream);
}
