// The backward of causal GQA flash attention (flash_attention.cu).
//
//   flash_attention_bwd  replaces no Pallas kernel: the JAX package's
//                        training loss differentiates its XLA attention
//                        (src/repro/launch/steps.py:31, attn_impl
//                        "xla_flash"), while the port's forward is the
//                        hand-written kernel that replaces
//                        src/repro/kernels/attention/kernel.py:79
//                        flash_attention_pallas, whose output autograd
//                        cannot see through; this is its gradient.
//
// What it computes.  Given q (B, Sq, H, D), k, v (B, Skv, HKV, D), the
// forward's output o (B, Sq, H, D) and row log-sum-exp lse (B, H, Sq,
// float32, natural log of the scaled scores' sum), and the output's
// gradient do (B, Sq, H, D):
//   P = exp(scale q k^T - lse) on the visible keys, 0 elsewhere
//   delta = rowsum(do * o)
//   dS = P * (do v^T - delta)
//   dq = scale dS k,  dk = scale dS^T q,  dv = P^T do
// with the forward's masks (the queries at the last Sq key positions,
// keys at or beyond kv_len hidden) and GQA by index: KV head j's dk and dv
// sum over its H / HKV query heads inside the kernel.  float32 or bfloat16
// inputs (each read in its own strides, the head dim contiguous); every
// product and sum in float32, each output rounded once to the inputs'
// dtype, written contiguous.  Head widths as the forward: D in 16, 24, 32,
// 64, 112, 128 at the padded width 64 or 128, the columns from D to the
// padded width staged as zeros and never stored.
//
// Two kernels, no atomics (the same inputs give the same bits):
//   dq_kernel    one CTA per (batch, head, 64-query block): stages its Q,
//                dO and O rows, computes delta for them (and stores it for
//                the second kernel), then walks the key blocks up to the
//                causal diagonal: S and dP by CUDA-core FMAs, dS into
//                shared memory, dq += dS K in registers.
//   dkdv_kernel  one CTA per (batch, KV head, 64-key block): stages its K
//                and V rows once, then walks every query head of its group
//                and every query block from the diagonal on: S and dP, P
//                and dS into shared memory, dv += P^T dO and dk += dS^T Q
//                in registers.  It runs after dq_kernel, on the same
//                stream, and reads the delta it stored.
// Both use the forward float32 kernel's layout: 256 threads as 16 x 16,
// thread (ty, tx) computing score rows 4ty..4ty+3 and columns tx + 16j of
// a 64 x 64 tile and owning a 4 x D/16 slice of its output tile, rows
// padded to DP + 4 floats so that float4 reads stay free of conflicts.
//
// What bounds it on an H100: operations.  At qwen3-4b's training shape
// (B 1, S 4096, H 32, HKV 8, D 128) a causal layer's backward is ~3.4e11
// FLOP in the 5 products of the FA2 backward (~0.35 ms at the 989 TFLOP/s
// bf16 tensor-core peak); this kernel computes S and dP twice (7 products)
// on the CUDA cores, whose float32 peak is 67 TFLOP/s.  It is the simple
// kernel that is right first; a wgmma version, with the float32 operands
// split hi + lo as the forward splits P, is ROADMAP Queue 2's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Arguments of one launch; mirrored by kernels/attention/kernel.py
// _AttnBwdArgs.  Strides are in elements; the head dim is contiguous.
struct AttnBwdArgs {
  const void* q;            // (B, Sq, H, D)
  const void* k;            // (B, Skv, HKV, D)
  const void* v;            // (B, Skv, HKV, D)
  const void* o;            // (B, Sq, H, D)
  const float* lse;         // (B, H, Sq), contiguous
  const void* dout;         // (B, Sq, H, D)
  void* dq;                 // (B, Sq, H, D) out, contiguous
  void* dk;                 // (B, Skv, HKV, D) out, contiguous
  void* dv;                 // (B, Skv, HKV, D) out, contiguous
  float* delta;             // (B, H, Sq) scratch, contiguous
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int batch, sq, skv, heads, kv_heads, head_dim;
  int causal, kv_len, q_offset;
  int dtype;                // 0 float32, 1 bfloat16
  float scale;
};

namespace {

constexpr int kB = 64;                   // queries or keys per tile
constexpr int kThreads = 256;            // 16 x 16
constexpr int kPer = kB / 16;            // tile rows (and columns) a thread
constexpr int LP = kB + 4;               // P / dS tile row stride (floats)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage kB rows of one head, starting at `src` (row stride `ss`), as a
// float32 tile of DP columns at row stride DP + 4; rows at or beyond `rows`
// and columns at or beyond `d` read zero.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int rows, int d) {
#pragma unroll 8
  for (int e = threadIdx.x; e < kB * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    dst[r * (DP + 4) + c] =
        r < rows && c < d ? to_f(src[(long long)r * ss + c]) : 0.0f;
  }
}

// s[i][j] = A[4ty + i] . B[tx + 16j] and t[i][j] = C[4ty + i] . E[tx + 16j]
// over DP columns of four staged tiles (the scores and dP of one tile pair).
template <int DP>
__device__ __forceinline__ void two_products(const float* sA, const float* sB,
                                             const float* sC, const float* sE,
                                             float (&s)[kPer][kPer],
                                             float (&t)[kPer][kPer]) {
  constexpr int LD = DP + 4;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = t[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      a[i] = *reinterpret_cast<const float4*>(&sA[(ty * kPer + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      b[j] = *reinterpret_cast<const float4*>(&sB[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float x = s[i][j];
        x = __fmaf_rn(a[i].x, b[j].x, x);
        x = __fmaf_rn(a[i].y, b[j].y, x);
        x = __fmaf_rn(a[i].z, b[j].z, x);
        x = __fmaf_rn(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      a[i] = *reinterpret_cast<const float4*>(&sC[(ty * kPer + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      b[j] = *reinterpret_cast<const float4*>(&sE[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float x = t[i][j];
        x = __fmaf_rn(a[i].x, b[j].x, x);
        x = __fmaf_rn(a[i].y, b[j].y, x);
        x = __fmaf_rn(a[i].z, b[j].z, x);
        x = __fmaf_rn(a[i].w, b[j].w, x);
        t[i][j] = x;
      }
  }
}

template <int DP>
constexpr int dq_smem_floats() {
  return 4 * kB * (DP + 4) + kB * LP + 2 * kB;
}

template <int DP>
constexpr int dkdv_smem_floats() {
  return 4 * kB * (DP + 4) + 2 * kB * LP + 2 * kB;
}

// ---- dq (and delta) --------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(AttnBwdArgs a) {
  constexpr int LD = DP + 4;
  constexpr int kVec = DP / 64;          // float4 output chunks per thread
  const int D = a.head_dim;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + kB * LD;
  float* sK = sDO + kB * LD;
  float* sV = sK + kB * LD;
  float* sS = sV + kB * LD;
  float* sLse = sS + kB * LP;
  float* sDelta = sLse + kB;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh_count = a.batch * a.heads;
  const int n_qb = (a.sq + kB - 1) / kB;
  // heaviest causal tiles (last query blocks) are scheduled first
  const int qb = n_qb - 1 - (int)(blockIdx.x / bh_count);
  const int bh = (int)(blockIdx.x % bh_count);
  const int b = bh / a.heads, h = bh % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const int q0 = qb * kB;
  const long long row_base = ((long long)b * a.heads + h) * a.sq;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* o = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  stage<T, DP>(sQ, q + (long long)q0 * a.q_ss, a.q_ss, a.sq - q0, D);
  stage<T, DP>(sDO, dout + (long long)q0 * a.do_ss, a.do_ss, a.sq - q0, D);
  stage<T, DP>(sK, o + (long long)q0 * a.o_ss, a.o_ss, a.sq - q0, D);
  __syncthreads();
  // delta = rowsum(dO * O): each warp 8 rows, lanes across the columns
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < kB; r += kThreads / 32) {
      float acc = 0.0f;
      for (int c = lane; c < DP; c += 32)
        acc = __fmaf_rn(sDO[r * LD + c], sK[r * LD + c], acc);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, w);
      if (lane == 0) {
        const int qi = q0 + r;
        const bool in = qi < a.sq;
        sDelta[r] = in ? acc : 0.0f;
        // a row beyond Sq gets lse +inf: its P is 0
        sLse[r] = in ? a.lse[row_base + qi] : __int_as_float(0x7f800000);
        if (in) a.delta[row_base + qi] = acc;
      }
    }
  }

  const int kv_lim = min(a.kv_len, a.skv);
  int kv_end = kv_lim;
  if (a.causal) kv_end = min(kv_end, q0 + kB + a.q_offset);
  const int n_kb = kv_end > 0 ? (kv_end + kB - 1) / kB : 0;

  float acc[kPer][4 * kVec];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kVec; ++c) acc[i][c] = 0.0f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();                     // last block's K and dS reads done
    stage<T, DP>(sK, k + (long long)k0 * a.k_ss, a.k_ss, a.skv - k0, D);
    stage<T, DP>(sV, v + (long long)k0 * a.v_ss, a.v_ss, a.skv - k0, D);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
    two_products<DP>(sQ, sK, sDO, sV, s, dp);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int row = ty * kPer + i;
      const int qpos = q0 + row + a.q_offset;
      const float lse = sLse[row], delta = sDelta[row];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool vis = kpos < kv_lim && (!a.causal || kpos <= qpos);
        const float p = vis ? expf(s[i][j] * a.scale - lse) : 0.0f;
        sS[row * LP + tx + 16 * j] = p * (dp[i][j] - delta);
      }
    }
    __syncthreads();

    // acc += dS K over this block's keys; columns (16u + tx) * 4 + e
#pragma unroll 2
    for (int c = 0; c < kB; c += 4) {
      float4 ds[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        ds[i] = *reinterpret_cast<const float4*>(&sS[(ty * kPer + i) * LP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 kv[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          kv[u] = *reinterpret_cast<const float4*>(
              &sK[(c + cc) * LD + (16 * u + tx) * 4]);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float w = cc == 0 ? ds[i].x : cc == 1 ? ds[i].y
                        : cc == 2 ? ds[i].z : ds[i].w;
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            acc[i][4 * u + 0] = __fmaf_rn(w, kv[u].x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = __fmaf_rn(w, kv[u].y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = __fmaf_rn(w, kv[u].z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = __fmaf_rn(w, kv[u].w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty * kPer + i;
    if (qi >= a.sq) continue;
    T* row = dq + (((long long)b * a.sq + qi) * a.heads + h) * D;
#pragma unroll
    for (int u = 0; u < kVec; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (16 * u + tx) * 4 + e;
        if (col < D) put(&row[col], acc[i][4 * u + e] * a.scale);
      }
  }
}

// ---- dk and dv -------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(AttnBwdArgs a) {
  constexpr int LD = DP + 4;
  constexpr int kVec = DP / 64;
  const int D = a.head_dim;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kB * LD;
  float* sQ = sV + kB * LD;
  float* sDO = sQ + kB * LD;
  float* sP = sDO + kB * LD;
  float* sS = sP + kB * LP;
  float* sLse = sS + kB * LP;
  float* sDelta = sLse + kB;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh_count = a.batch * a.kv_heads;
  // heaviest causal tiles (first key blocks) are scheduled first
  const int kb = (int)(blockIdx.x / bh_count);
  const int bh = (int)(blockIdx.x % bh_count);
  const int b = bh / a.kv_heads, hk = bh % a.kv_heads;
  const int group = a.heads / a.kv_heads;
  const int k0 = kb * kB;
  const int kv_lim = min(a.kv_len, a.skv);

  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  stage<T, DP>(sK, k + (long long)k0 * a.k_ss, a.k_ss, a.skv - k0, D);
  stage<T, DP>(sV, v + (long long)k0 * a.v_ss, a.v_ss, a.skv - k0, D);

  float dk[kPer][4 * kVec], dv[kPer][4 * kVec];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kVec; ++c) dk[i][c] = dv[i][c] = 0.0f;

  // query blocks that see a key of this block: from the one holding query
  // position k0 on (all of them without causality); none past kv_len
  const int n_qb = (a.sq + kB - 1) / kB;
  const int qb0 = a.causal ? max(0, k0 - a.q_offset) / kB : 0;
  const int qb_end = k0 < kv_lim ? n_qb : qb0;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long row_base = ((long long)b * a.heads + h) * a.sq;
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int qb = qb0; qb < qb_end; ++qb) {
      const int q0 = qb * kB;
      __syncthreads();                   // last block's Q, dO, P, dS reads done
      stage<T, DP>(sQ, q + (long long)q0 * a.q_ss, a.q_ss, a.sq - q0, D);
      stage<T, DP>(sDO, dout + (long long)q0 * a.do_ss, a.do_ss, a.sq - q0,
                   D);
      if (tid < kB) {
        const int qi = q0 + tid;
        const bool in = qi < a.sq;
        sLse[tid] = in ? a.lse[row_base + qi] : __int_as_float(0x7f800000);
        sDelta[tid] = in ? a.delta[row_base + qi] : 0.0f;
      }
      __syncthreads();

      // rows: queries 4ty + i; columns: this block's keys tx + 16j
      float s[kPer][kPer], dp[kPer][kPer];
      two_products<DP>(sQ, sK, sDO, sV, s, dp);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int row = ty * kPer + i;
        const int qpos = q0 + row + a.q_offset;
        const float lse = sLse[row], delta = sDelta[row];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const bool vis = kpos < kv_lim && (!a.causal || kpos <= qpos);
          const float p = vis ? expf(s[i][j] * a.scale - lse) : 0.0f;
          sP[row * LP + tx + 16 * j] = p;
          sS[row * LP + tx + 16 * j] = p * (dp[i][j] - delta);
        }
      }
      __syncthreads();

      // dv += P^T dO, dk += dS^T Q: key rows 4ty + i, columns
      // (16u + tx) * 4 + e
#pragma unroll 2
      for (int r = 0; r < kB; ++r) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&sP[r * LP + ty * kPer]);
        const float4 s4 =
            *reinterpret_cast<const float4*>(&sS[r * LP + ty * kPer]);
        const float pv[kPer] = {p4.x, p4.y, p4.z, p4.w};
        const float sv[kPer] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const float4 d4 = *reinterpret_cast<const float4*>(
              &sDO[r * LD + (16 * u + tx) * 4]);
          const float4 q4 = *reinterpret_cast<const float4*>(
              &sQ[r * LD + (16 * u + tx) * 4]);
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            dv[i][4 * u + 0] = __fmaf_rn(pv[i], d4.x, dv[i][4 * u + 0]);
            dv[i][4 * u + 1] = __fmaf_rn(pv[i], d4.y, dv[i][4 * u + 1]);
            dv[i][4 * u + 2] = __fmaf_rn(pv[i], d4.z, dv[i][4 * u + 2]);
            dv[i][4 * u + 3] = __fmaf_rn(pv[i], d4.w, dv[i][4 * u + 3]);
            dk[i][4 * u + 0] = __fmaf_rn(sv[i], q4.x, dk[i][4 * u + 0]);
            dk[i][4 * u + 1] = __fmaf_rn(sv[i], q4.y, dk[i][4 * u + 1]);
            dk[i][4 * u + 2] = __fmaf_rn(sv[i], q4.z, dk[i][4 * u + 2]);
            dk[i][4 * u + 3] = __fmaf_rn(sv[i], q4.w, dk[i][4 * u + 3]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ki = k0 + ty * kPer + i;
    if (ki >= a.skv) continue;
    const long long off = (((long long)b * a.skv + ki) * a.kv_heads + hk) * D;
#pragma unroll
    for (int u = 0; u < kVec; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (16 * u + tx) * 4 + e;
        if (col < D) {
          put(&dk_out[off + col], dk[i][4 * u + e] * a.scale);
          put(&dv_out[off + col], dv[i][4 * u + e]);
        }
      }
  }
}

template <typename T, int DP>
int launch(const AttnBwdArgs& a, cudaStream_t stream) {
  const int dq_bytes = dq_smem_floats<DP>() * (int)sizeof(float);
  const int kv_bytes = dkdv_smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_qb = (a.sq + kB - 1) / kB;
  const long long n_kb = (a.skv + kB - 1) / kB;
  dq_kernel<T, DP><<<(unsigned)(n_qb * a.batch * a.heads), kThreads,
                     dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, DP><<<(unsigned)(n_kb * a.batch * a.kv_heads), kThreads,
                       kv_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dtype(const AttnBwdArgs& a, cudaStream_t stream) {
  return a.dtype == 1 ? launch<__nv_bfloat16, DP>(a, stream)
                      : launch<float, DP>(a, stream);
}

}  // namespace

extern "C" int flash_attention_bwd(const AttnBwdArgs* a,
                                   cudaStream_t stream) {
  if (a->batch < 1 || a->sq < 1 || a->heads < 1) return (int)cudaSuccess;
  if (a->kv_heads < 1 || a->heads % a->kv_heads != 0 ||
      (a->dtype != 0 && a->dtype != 1))
    return (int)cudaErrorInvalidValue;
  switch (a->head_dim) {
    case 16: case 24: case 32: case 64:
      return launch_dtype<64>(*a, stream);
    case 112: case 128:
      return launch_dtype<128>(*a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
