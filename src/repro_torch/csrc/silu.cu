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
