// Forward Engine without plasticity: psum-stationary product, LIF neuron with
// hard reset, post-trace update.
//
//   lif_forward_f32  replaces src/repro/kernels/lif/kernel.py:47
//                    lif_forward_pallas (_lif_kernel :21)
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
struct LifArgs {
  const float* x;           // (B, K)
  const float* w;           // (K, M)
  const float* v;           // (B, M)
  const float* trace;       // (B, M)
  float* spikes;            // (B, M) out
  float* v_out;             // (B, M) out
  float* trace_out;         // (B, M) out
  int batch, k, m;
  ff::FParams f;
};

namespace {

constexpr int kCols = 8;                 // output columns per CTA
constexpr int kRows = 32;                // contraction lanes per column
constexpr int kThreads = kCols * kRows;
constexpr int kChunk = 8;                // batch rows per pass

__global__ void __launch_bounds__(kThreads) lif_forward_kernel(LifArgs a) {
  __shared__ float red[kRows * kChunk * kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int K = a.k, M = a.m;
  const int col = blockIdx.x * kCols + tx;
  const float* __restrict__ x = a.x;
  const float* __restrict__ w = a.w;
  for (int b0 = 0; b0 < a.batch; b0 += kChunk) {
    const int nb = min(kChunk, a.batch - b0);
    float acc[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) acc[u] = 0.0f;
    if (col < M) {
      for (int r = ty; r < K; r += kRows) {
        const float wv = w[(long)r * M + col];
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (u < nb) acc[u] = acc[u] + x[(long)(b0 + u) * K + r] * wv;
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
      ff::neuron_f(a.v[g], s, true, a.f, &ev, &vn);
      a.spikes[g] = ev;
      a.v_out[g] = vn;
      a.trace_out[g] = __fmaf_rn(a.f.decay, a.trace[g], ev);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int lif_forward_f32(const LifArgs* a, cudaStream_t stream) {
  if (a->batch < 1 || a->m < 1) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((a->m + kCols - 1) / kCols);
  lif_forward_kernel<<<blocks, dim3(kCols, kRows), 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
