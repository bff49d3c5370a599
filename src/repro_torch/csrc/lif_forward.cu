// Forward Engine without plasticity: psum-stationary product, LIF neuron with
// hard reset, post-trace update.
//
//   lif_forward_f32  replaces src/repro/kernels/lif/kernel.py:47
//   lif_forward_bf16 lif_forward_pallas (_lif_kernel :21), in float32 and
//                    in bfloat16 (the Pallas body's generic dtype,
//                    :36-44): bfloat16 operands are promoted to float32 on
//                    load, the product accumulates in float32 over the
//                    whole K, and each output is rounded once on store.
//
// What bounds it on an H100: bytes.  The product reads w (K, M) once; at
// the online-MNIST layer 784 x 1024 and B = 1 that is ~3.2 MB, ~1 us at
// 3.35 TB/s, against 2 operations per weight and row.
//
// Design: one CTA per tile of kCols output columns.  The TPU kernel walks
// the contraction in sequential K blocks with an fp32 scratch accumulator
// (the PE psum registers); here the K loop runs inside the block: kRows
// lanes per column each accumulate a strided share of K for up to kChunk
// batch rows in registers, and one thread per (row, column) folds the
// partials in lane order and runs the LIF + trace epilogue.  Ragged K and M
// are masked by the loop bounds; nothing is padded or copied.
#include "plasticity.cuh"

// Arguments of one launch; mirrored by kernels/lif/kernel.py _LifArgs.
// Every tensor is float32, or every one bfloat16.
struct LifArgs {
  const void* x;            // (B, K)
  const void* w;            // (K, M)
  const void* v;            // (B, M)
  const void* trace;        // (B, M)
  void* spikes;             // (B, M) out
  void* v_out;              // (B, M) out
  void* trace_out;          // (B, M) out
  int batch, k, m;
  ff::FParams f;
};

namespace {

constexpr int kCols = 8;                 // output columns per CTA
constexpr int kRows = 32;                // contraction lanes per column
constexpr int kThreads = kCols * kRows;
constexpr int kChunk = 8;                // batch rows per pass

template <typename T>
__global__ void __launch_bounds__(kThreads) lif_forward_kernel(LifArgs a) {
  using ff::cvt;
  __shared__ float red[kRows * kChunk * kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int K = a.k, M = a.m;
  const int col = blockIdx.x * kCols + tx;
  const T* __restrict__ x = (const T*)a.x;
  const T* __restrict__ w = (const T*)a.w;
  for (int b0 = 0; b0 < a.batch; b0 += kChunk) {
    const int nb = min(kChunk, a.batch - b0);
    float acc[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) acc[u] = 0.0f;
    if (col < M) {
      for (int r = ty; r < K; r += kRows) {
        const float wv = cvt<float>(w[(long)r * M + col]);
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (u < nb)
            acc[u] = acc[u] + cvt<float>(x[(long)(b0 + u) * K + r]) * wv;
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) red[(ty * kChunk + u) * kCols + tx] = acc[u];
    __syncthreads();
    for (int e = tid; e < nb * kCols; e += kThreads) {
      const int u = e / kCols, j = e % kCols;
      const int c = blockIdx.x * kCols + j;
      if (c >= M) continue;
      float s = red[u * kCols + j];
      for (int r = 1; r < kRows; ++r) s = s + red[(r * kChunk + u) * kCols + j];
      const long g = (long)(b0 + u) * M + c;
      float ev, vn;
      ff::neuron_f(cvt<float>(((const T*)a.v)[g]), s, true, a.f, &ev, &vn);
      ((T*)a.spikes)[g] = cvt<T>(ev);
      ((T*)a.v_out)[g] = cvt<T>(vn);
      ((T*)a.trace_out)[g] = cvt<T>(
          __fmaf_rn(a.f.decay, cvt<float>(((const T*)a.trace)[g]), ev));
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const LifArgs* a, cudaStream_t stream) {
  if (a->batch < 1 || a->m < 1) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((a->m + kCols - 1) / kCols);
  lif_forward_kernel<T><<<blocks, dim3(kCols, kRows), 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lif_forward_f32(const LifArgs* a, cudaStream_t stream) {
  return launch<float>(a, stream);
}

extern "C" int lif_forward_bf16(const LifArgs* a, cudaStream_t stream) {
  return launch<__nv_bfloat16>(a, stream);
}
