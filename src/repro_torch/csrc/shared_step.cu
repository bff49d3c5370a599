// Shared-weight dual-engine step: one SNN timestep of one synaptic layer for
// a batch of B activation rows that share ONE weight matrix (N, M), with
// the batch-averaged four-term dw.  Two kernels, one per datapath:
//
//   shared_step_f32  replaces src/repro/kernels/plasticity/kernel.py:132
//                    dual_engine_step_pallas (_dual_engine_kernel :98)
//   shared_step_q    replaces src/repro/kernels/plasticity/kernel.py:431
//                    dual_engine_step_q_pallas (_dual_engine_kernel_q :399)
//
// The float kernel is a template on its element type: shared_step_f32 runs
// it in float32 and shared_step_bf16 in bfloat16 (the Pallas body's generic
// dtype, kernel.py:118-122): operands promoted to float32 on load, the
// float32 instantiation's arithmetic, each output rounded once on store.
//
// What bounds it on an H100: bytes.  A step reads w and the four theta
// planes once and writes w once: at the online-MNIST layer 784 -> 1024 and
// B = 1 that is ~19 MB in float32 (~6 us at 3.35 TB/s) and ~14.5 MB in
// int8; the arithmetic is a handful of operations per synapse and row.
//
// Design: one CTA per tile of kCols output columns with the whole fan-in
// inside the block (the TPU kernel's (N, bm) tile), kRows lanes per column.
//   1. psum: each lane sums its strided share of the fan-in for up to kChunk
//      batch rows in registers; one thread per (row, column) folds the
//      kRows partials in lane order and runs the neuron and trace update
//      (the fresh post traces stay in shared memory for step 2);
//   2. plasticity: each lane walks its rows again; per synapse it loops over
//      the batch for the Hebbian sum and the presynaptic sum, and rewrites
//      the weight from theta.
// A warp covers 4 rows x 8 columns: 32-byte segments of w and of each theta
// plane, whole sectors, and 128 CTAs at M = 1024 keep every SM busy.
// The integer sums wrap in 32 bits and are order-free, so shared_step_q is
// bit-equal to ref.dual_engine_step_q; the float psum is summed in lane
// order (exact on grid-valued inputs, ULP-close otherwise).
#include <type_traits>

#include "plasticity.cuh"

using ff::Types;

// Arguments of one launch; mirrored by kernel.py _SharedStepArgs (ctypes).
struct SharedStepArgs {
  const void* x;            // (B, N) float32 | bfloat16 | int32
  const void* w;            // (N, M) float32 | bfloat16 | int8
  const void* theta;        // (4, N, M) float32 | bfloat16, or null
  const void* v;            // (B, M)
  const void* trace_pre;    // (B, N)
  const void* trace_post;   // (B, M)
  const void* teach;        // (B, M) float32 | int32, or null
  const float* scale;       // () int8 only
  const int* seed;          // () int8 only
  void* events;             // (B, M) out
  void* v_out;              // (B, M) out
  void* trace_post_out;     // (B, M) out
  void* w_out;              // (N, M) out
  int batch, n, m, plastic, spiking;
  float w_clip;
  ff::FParams f;
  ff::QParams q;            // inv1 / inv2 of this batch
  int theta_bf16;           // bfloat16 kernel: theta is bfloat16
};

namespace {

constexpr int kCols = 8;                 // output columns per CTA
constexpr int kRows = 32;                // fan-in lanes per column
constexpr int kThreads = kCols * kRows;
constexpr int kChunk = 8;                // batch rows per psum pass

// S: the compute type (float | int32); T: the float kernel's element type
// in device memory (float | bfloat16; unused in fixed point); TH: the
// rule's.  G and WG are the state's and the weights' types in memory.
template <bool Q, typename T, typename TH>
__global__ void __launch_bounds__(kThreads)
shared_step_kernel(SharedStepArgs a) {
  using ff::cvt;
  using S = typename Types<Q>::S;
  using G = std::conditional_t<Q, int, T>;
  using WG = std::conditional_t<Q, int8_t, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  S* red = (S*)smem;                           // (kRows, kChunk, kCols)
  S* tp_s = red + kRows * kChunk * kCols;      // (B, kCols) fresh traces
  S* post_s = tp_s + a.batch * kCols;          // (kCols,) batch sums
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int B = a.batch, N = a.n, M = a.m;
  const int col = blockIdx.x * kCols + tx;
  const bool in = col < M;
  const WG* __restrict__ w = (const WG*)a.w;
  const G* __restrict__ x = (const G*)a.x;
  const float scale = Q ? *a.scale : 0.0f;

  // ---- Forward Engine ---------------------------------------------------
  for (int b0 = 0; b0 < B; b0 += kChunk) {
    const int nb = min(kChunk, B - b0);
    S acc[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) acc[u] = S(0);
    if (in) {
      for (int r = ty; r < N; r += kRows) {
        const S wv = cvt<S>(w[(long)r * M + col]);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (u < nb) {
            const S xv = cvt<S>(x[(long)(b0 + u) * N + r]);
            if constexpr (Q) acc[u] = ff::wadd(acc[u], ff::wmul(xv, wv));
            else acc[u] = acc[u] + xv * wv;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) red[(ty * kChunk + u) * kCols + tx] = acc[u];
    __syncthreads();
    for (int e = tid; e < nb * kCols; e += kThreads) {
      const int u = e / kCols, j = e % kCols;
      const int c = blockIdx.x * kCols + j;
      if (c >= M) continue;
      S s = red[u * kCols + j];
      for (int r = 1; r < kRows; ++r) {
        if constexpr (Q) s = ff::wadd(s, red[(r * kChunk + u) * kCols + j]);
        else s = s + red[(r * kChunk + u) * kCols + j];
      }
      const long g = (long)(b0 + u) * M + c;
      S ev, vn, tp;
      if constexpr (Q) {
        int i_fx = ff::current_fx(s, scale);
        if (a.teach) i_fx = ff::wadd(i_fx, ((const int*)a.teach)[g]);
        ff::neuron_q(((const int*)a.v)[g], i_fx, a.spiking, a.q, &ev, &vn);
        tp = ff::trace_q(((const int*)a.trace_post)[g], ev, a.q);
      } else {
        if (a.teach) s = s + ((const float*)a.teach)[g];
        ff::neuron_f(cvt<float>(((const G*)a.v)[g]), s, a.spiking, a.f, &ev,
                     &vn);
        tp = __fmaf_rn(a.f.decay, cvt<float>(((const G*)a.trace_post)[g]),
                       ev);
      }
      ((G*)a.events)[g] = cvt<G>(ev);
      ((G*)a.v_out)[g] = cvt<G>(vn);
      ((G*)a.trace_post_out)[g] = cvt<G>(tp);
      tp_s[(b0 + u) * kCols + j] = tp;
    }
    __syncthreads();
  }

  WG* __restrict__ w_out = (WG*)a.w_out;
  if (!a.plastic) {
    if (in)
      for (int r = ty; r < N; r += kRows)
        w_out[(long)r * M + col] = w[(long)r * M + col];
    return;
  }

  // ---- Plasticity Engine ------------------------------------------------
  if (tid < kCols) {
    S s = S(0);
    for (int b = 0; b < B; ++b) {
      if constexpr (Q) s = ff::wadd(s, tp_s[b * kCols + tid]);
      else s = s + tp_s[b * kCols + tid];
    }
    post_s[tid] = s;
  }
  __syncthreads();
  if (!in) return;
  const G* __restrict__ pre = (const G*)a.trace_pre;
  const long nm = (long)N * M;
  int qmax = 0, seed = 0;
  if constexpr (Q) {
    qmax = ff::qclip(a.w_clip, scale);
    seed = *a.seed;
  }
  for (int r = ty; r < N; r += kRows) {
    const long o = (long)r * M + col;
    S hebb = S(0), pre_sum = S(0);
    for (int b = 0; b < B; ++b) {
      const S p = cvt<S>(pre[(long)b * N + r]);
      if constexpr (Q) {
        hebb = ff::wadd(hebb, ff::wmul(p, tp_s[b * kCols + tx]));
        pre_sum = ff::wadd(pre_sum, p);
      } else {
        hebb = hebb + p * tp_s[b * kCols + tx];
        pre_sum = pre_sum + p;
      }
    }
    if constexpr (Q) {
      // hash counter: the flat (row * M + col) index of the matrix
      w_out[o] = (int8_t)ff::plastic_q_sums(
          (int)w[o], (const float*)a.theta + o, nm, hebb, pre_sum, post_s[tx],
          scale, qmax, seed, (int)o, a.q);
    } else {
      const float fb = (float)B;
      w_out[o] = cvt<WG>(ff::plastic_f_terms(
          cvt<float>(w[o]), (const TH*)a.theta + o, nm, __fdiv_rn(hebb, fb),
          __fdiv_rn(pre_sum, fb), __fdiv_rn(post_s[tx], fb), a.w_clip));
    }
  }
}

template <bool Q, typename T = float, typename TH = float>
int launch(const SharedStepArgs* a, cudaStream_t stream) {
  using S = typename Types<Q>::S;
  if (a->batch < 1 || a->m < 1) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((a->m + kCols - 1) / kCols);
  const size_t smem =
      sizeof(S) * ((size_t)kRows * kChunk * kCols + (size_t)a->batch * kCols +
                   kCols);
  cudaError_t err = cudaFuncSetAttribute(
      shared_step_kernel<Q, T, TH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  shared_step_kernel<Q, T, TH><<<blocks, dim3(kCols, kRows), smem, stream>>>(
      *a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int shared_step_f32(const SharedStepArgs* a, cudaStream_t stream) {
  return launch<false>(a, stream);
}

extern "C" int shared_step_bf16(const SharedStepArgs* a,
                                cudaStream_t stream) {
  return a->theta_bf16 ? launch<false, __nv_bfloat16, __nv_bfloat16>(a, stream)
                       : launch<false, __nv_bfloat16, float>(a, stream);
}

extern "C" int shared_step_q(const SharedStepArgs* a, cudaStream_t stream) {
  return launch<true>(a, stream);
}
