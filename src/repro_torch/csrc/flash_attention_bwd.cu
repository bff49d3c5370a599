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
// sum in float32, each output rounded once to the inputs' dtype, written
// contiguous.  Head widths as the forward: D in 16, 24, 32, 64, 112, 128 at
// the padded width 64 or 128, the columns from D to the padded width read
// as zeros and never stored.  Two kernels a dtype, the dq one first (it
// stores delta, and in bf16 lse in log2 units, for the dk/dv one), and no
// atomics: the same inputs give the same bits.
//
// What bounds it on an H100: operations.  At qwen3-4b's training shape
// (B 1, S 4096, H 32, HKV 8, D 128) a causal layer's backward is ~3.4e11
// FLOP in the 5 products of the FA2 backward, ~0.35 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against ~0.1 GB of operands (~0.03 ms).  Only
// wgmma comes near that rate; the CUDA cores' float32 peak is 67 TFLOP/s.
//
// bfloat16 is two Hopper kernels of three warpgroups each: a producer,
// whose one elected thread issues TMA loads (4-D tensor maps over q, dO,
// k and v in their own strides, 128-byte swizzle, the hardware's zero fill
// for ragged S and for the columns from D to DP), and two consumers of 64
// rows each; setmaxnreg moves registers from the producer to them.  Each
// CTA loads its own 128-row tile pair once and streams 64-row stage pairs
// through a ring guarded by full/empty mbarriers, so the next stage's
// loads fly while one computes.  Every product is wgmma with a float32
// accumulator.
//   dq_wgmma_kernel    one CTA per (batch, head, 128-query tile), the
//                      heaviest causal tiles first; owns Q and dO, streams
//                      K and V blocks up to the diagonal (the blocks above
//                      it are skipped by the loop bound).  First it reads
//                      its rows of O and dO for delta and stores delta and
//                      lse * log2(e) in rows padded to 64 for the dk/dv
//                      kernel.  A consumer computes S = Q K^T and
//                      dP = dO V^T (both operands in shared memory, K and V
//                      K-major), P = exp2(S scale log2(e) - lse log2(e))
//                      and dS = P (dP - delta) on the accumulator fragments
//                      (masks only on diagonal, ragged and kv_len blocks),
//                      and dQ += dS K with dS from registers and K read
//                      MN-major from the same stage.
//   dkdv_wgmma_kernel  one CTA per (batch, KV head, 128-key tile), the
//                      heaviest (first) tiles first; owns K and V, streams
//                      Q and dO blocks, with their rows of lse and delta,
//                      of every query head of the GQA group from the
//                      diagonal on.  A consumer computes S^T = K Q^T and
//                      dP^T = V dO^T with its 64 keys as the accumulator's
//                      rows, so P^T and dS^T land in registers in the
//                      A-fragment layout (no P or dS tile goes through
//                      shared memory), and dV += P^T dO, dK += dS^T Q with
//                      dO and Q read MN-major from their stages.
//
// The split.  S and dP multiply bf16 inputs, exact as operands.  P and dS
// are float32, and rounding them once to bf16 before dV, dK and dQ leaves
// the bf16 gate (rtol 2e-2, atol 2e-3) once dO is large, as a single bf16
// P does in the forward.  So each is split into hi = bf16(x) and
// lo = bf16(x - hi), and the product takes hi B + lo B in float32: ~16
// significant bits.  That is ten products for the five of the FA2
// backward (S and dP in both kernels, dQ, dV and dK twice), ~2x the
// bound's operations.
//
// float32 keeps two CUDA-core kernels, because its 1e-5 contract cannot go
// through bf16 or TF32 tensor cores:
//   dq_kernel    one CTA per (batch, head, 64-query block): stages its Q,
//                dO and O rows, computes delta for them (and stores it for
//                the second kernel), then walks the key blocks up to the
//                causal diagonal: S and dP by CUDA-core FMAs, dS into
//                shared memory, dq += dS K in registers.
//   dkdv_kernel  one CTA per (batch, KV head, 64-key block): stages its K
//                and V rows once, then walks every query head of its group
//                and every query block from the diagonal on: S and dP, P
//                and dS into shared memory, dv += P^T dO and dk += dS^T Q
//                in registers.
// Both use the forward float32 kernel's layout: 256 threads as 16 x 16,
// thread (ty, tx) computing score rows 4ty..4ty+3 and columns tx + 16j of
// a 64 x 64 tile and owning a 4 x D/16 slice of its output tile, rows
// padded to DP + 4 floats so that float4 reads stay free of conflicts.
#include "hopper.cuh"

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
  float* delta;             // scratch: delta, (B, H, Sq) in float32 and
                            // (B, H, sq_pad) in bf16
  float* lse2;              // scratch, bf16 only: lse * log2(e), (B, H, sq_pad)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int batch, sq, skv, heads, kv_heads, head_dim;
  int causal, kv_len, q_offset;
  int dtype;                // 0 float32, 1 bfloat16
  int sq_pad;               // Sq rounded up to 64: the bf16 scratch rows
  float scale;
};

namespace {

// ---- float32: the CUDA-core kernels -----------------------------------------

constexpr int kB = 64;                   // queries or keys per tile
constexpr int kThreads = 256;            // 16 x 16
constexpr int kPer = kB / 16;            // tile rows (and columns) a thread
constexpr int LP = kB + 4;               // P / dS tile row stride (floats)

// Stage kB rows of one head, starting at `src` (row stride `ss`), as a
// float32 tile of DP columns at row stride DP + 4; rows at or beyond `rows`
// and columns at or beyond `d` read zero.
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ss, int rows, int d) {
#pragma unroll 8
  for (int e = threadIdx.x; e < kB * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    dst[r * (DP + 4) + c] =
        r < rows && c < d ? src[(long long)r * ss + c] : 0.0f;
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

// ---- dq (and delta) ---------------------------------------------------------

template <int DP>
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

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* o = static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;

  stage<DP>(sQ, q + (long long)q0 * a.q_ss, a.q_ss, a.sq - q0, D);
  stage<DP>(sDO, dout + (long long)q0 * a.do_ss, a.do_ss, a.sq - q0, D);
  stage<DP>(sK, o + (long long)q0 * a.o_ss, a.o_ss, a.sq - q0, D);
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
    stage<DP>(sK, k + (long long)k0 * a.k_ss, a.k_ss, a.skv - k0, D);
    stage<DP>(sV, v + (long long)k0 * a.v_ss, a.v_ss, a.skv - k0, D);
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

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty * kPer + i;
    if (qi >= a.sq) continue;
    float* row = dq + (((long long)b * a.sq + qi) * a.heads + h) * D;
#pragma unroll
    for (int u = 0; u < kVec; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (16 * u + tx) * 4 + e;
        if (col < D) row[col] = acc[i][4 * u + e] * a.scale;
      }
  }
}

// ---- dk and dv -------------------------------------------------------------

template <int DP>
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

  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  stage<DP>(sK, k + (long long)k0 * a.k_ss, a.k_ss, a.skv - k0, D);
  stage<DP>(sV, v + (long long)k0 * a.v_ss, a.v_ss, a.skv - k0, D);

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
    const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* dout =
        static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int qb = qb0; qb < qb_end; ++qb) {
      const int q0 = qb * kB;
      __syncthreads();                   // last block's Q, dO, P, dS reads done
      stage<DP>(sQ, q + (long long)q0 * a.q_ss, a.q_ss, a.sq - q0, D);
      stage<DP>(sDO, dout + (long long)q0 * a.do_ss, a.do_ss, a.sq - q0,
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

  float* dk_out = static_cast<float*>(a.dk);
  float* dv_out = static_cast<float*>(a.dv);
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
          dk_out[off + col] = dk[i][4 * u + e] * a.scale;
          dv_out[off + col] = dv[i][4 * u + e];
        }
      }
  }
}

template <int DP>
int launch_f32(const AttnBwdArgs& a, cudaStream_t stream) {
  const int dq_bytes = dq_smem_floats<DP>() * (int)sizeof(float);
  const int kv_bytes = dkdv_smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_qb = (a.sq + kB - 1) / kB;
  const long long n_kb = (a.skv + kB - 1) / kB;
  dq_kernel<DP><<<(unsigned)(n_qb * a.batch * a.heads), kThreads, dq_bytes,
                  stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<DP><<<(unsigned)(n_kb * a.batch * a.kv_heads), kThreads,
                    kv_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- bfloat16: the Hopper kernels (TMA, mbarrier ring, wgmma) ---------------

constexpr int kTile = 128;               // a CTA's own rows: 2 consumers x 64
constexpr int kRows = 64;                // a stage's rows; a consumer's rows
constexpr int kStages = 2;               // stage pairs in the ring
constexpr int kWThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kBox = 64;                 // TMA box width: 128 bytes of D
constexpr int kRowBytes = kBox * 2;      // one swizzled row of a box
constexpr int kTileHalf = kTile * kRowBytes;     // one box column of a tile
constexpr int kStageHalf = kRows * kRowBytes;    // one box column of a stage
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct BwdLayout {        // byte offsets from a 1024-aligned base
  static constexpr int kTileBytes = DP / kBox * kTileHalf;
  static constexpr int kStageBytes = DP / kBox * kStageHalf;
  static constexpr int kOwn = 0;             // Q and dO, or K and V
  static constexpr int kRing = 2 * kTileBytes;   // stage s, operand x at
                                                 // kRing + (2s + x) stage
  static constexpr int kRowVals = kRing + 2 * kStages * kStageBytes;
  static constexpr int kRowValBytes = 2 * kRows * 4;   // lse2, delta rows
  static constexpr int kBar = kRowVals + kStages * kRowValBytes;
  static constexpr int kBars = 1 + 2 * kStages;        // own, full, empty
  static constexpr int kBytes = kBar + 8 * kBars + 1024; // + alignment slack
};

// One row block of every D box of map `m` at (head, row, batch) into
// `dst`, box columns `half` bytes apart, counted on `bar`.
template <int DP>
__device__ __forceinline__ void load_block(uint32_t dst, int half,
                                           const CUtensorMap* m, uint32_t bar,
                                           int head, int row, int batch) {
#pragma unroll
  for (int x = 0; x < DP / kBox; ++x)
    tma_load(dst + x * half, m, bar, x * kBox, head, row, batch);
}

// A K-major operand's k-step kk (16 elements of D, 32 bytes into box kk / 4)
// in descriptor units, box columns `half` bytes apart.
__device__ __forceinline__ uint32_t kstep(int kk, int half) {
  return ((kk / 4) * half + (kk % 4) * 32) >> 4;
}

// d (64 x 64) = A B^T over DP: A 64 rows of a K-major tile (box columns
// kTileHalf apart), B the 64 rows of a K-major stage.
template <int DP>
__device__ __forceinline__ void product_nt(float (&d)[32], uint64_t da,
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64(d, da + kstep(kk, kTileHalf), db + kstep(kk, kStageHalf),
                 kk > 0);
}

// The 64 x 64 float32 accumulator x as the A fragments of its 4 k-steps of
// 16 columns, hi + lo: element 4i + e is row r (e < 2) or r + 8, column
// 8i + 2 quad + (e & 1), which is the A fragment's order.
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

// d (64 x DP) += (hi + lo) B over 64 rows of B: a stage read MN-major
// (16 rows a k-step, 2048 bytes).
template <int N>
__device__ __forceinline__ void product_split(float (&d)[N],
                                              const uint32_t (&hi)[4][4],
                                              const uint32_t (&lo)[4][4],
                                              uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, hi[kk], db + kk * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, lo[kk], db + kk * 128);
}

// Rows r and r + 8 (below n) of a 64 x DP accumulator times `mul` as bf16
// pairs into `out` (row 0, row stride ld elements); a pair at column
// 8i + 2 quad is stored where it lies below the true width d (a multiple
// of 8, so a pair is wholly in or out).
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld,
                                           int r, int n, int d,
                                           const float (&acc)[N], float mul) {
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (r + 8 * half >= n) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(
        out + (long long)(r + 8 * half) * ld + 2 * quad);
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      if (8 * i + 2 * quad < d)
        row[4 * i] = bf16_pair(acc[4 * i + 2 * half] * mul,
                               acc[4 * i + 2 * half + 1] * mul);
  }
}

// The barriers of a CTA: its own tile pair's, then each stage's full and
// empty (every consumer thread arrives on an empty one).
__device__ __forceinline__ void init_bars(uint32_t own) {
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(own + 8u * (1 + s), 1);
      mbar_init(own + 8u * (1 + kStages + s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

template <int DP>
__global__ void __launch_bounds__(kWThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, AttnBwdArgs a) {
  using L = BwdLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t own = base + L::kBar;
  auto full = [&](int s) { return own + 8u * (1 + s); };
  auto empty = [&](int s) { return own + 8u * (1 + kStages + s); };
  auto ring = [&](int s, int x) {
    return base + L::kRing + (2 * s + x) * L::kStageBytes;
  };

  const int bh_count = a.batch * a.heads;
  const int n_qt = (a.sq + kTile - 1) / kTile;
  // heaviest causal tiles (last query tiles) are scheduled first
  const int qt = n_qt - 1 - (int)(blockIdx.x / bh_count);
  const int bh = (int)(blockIdx.x % bh_count);
  const int b = bh / a.heads, h = bh % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const int q0 = qt * kTile;
  const int kv_lim = min(a.kv_len, a.skv);
  int kv_end = kv_lim;
  if (a.causal) kv_end = min(kv_end, q0 + kTile + a.q_offset);
  const int n_kb = kv_end > 0 ? (kv_end + kRows - 1) / kRows : 0;

  init_bars(own);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread loads Q and dO, then keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(own, 2 * L::kTileBytes);
      load_block<DP>(base + L::kOwn, kTileHalf, &tq, own, h, q0, b);
      load_block<DP>(base + L::kOwn + L::kTileBytes, kTileHalf, &tdo, own, h,
                     q0, b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        mbar_wait(empty(s), ((kb / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kStageBytes);
        load_block<DP>(ring(s, 0), kStageHalf, &tk, full(s), hk, kb * kRows,
                       b);
        load_block<DP>(ring(s, 1), kStageHalf, &tv, full(s), hk, kb * kRows,
                       b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int quad = lane % 4;
  const int r0 = c * 64 + warp * 16 + lane / 4;       // tile row, and r0 + 8
  const int wg_lo = q0 + c * 64 + a.q_offset;         // first query position
  const float cl2 = a.scale * kLog2e;
  const int D = a.head_dim;

  // each row's lse in log2 units and delta = rowsum(dO * O) in float32
  // from the bf16 values, the row's 4 threads taking every fourth 8-column
  // chunk; both stored for the dk/dv kernel (+inf and 0 past Sq)
  float l2[2], dl[2];
  const long long pad_base = ((long long)b * a.heads + h) * a.sq_pad;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qi = q0 + r0 + 8 * e;
    const bool in = qi < a.sq;
    float acc = 0.0f;
    if (in) {
      const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(a.o) +
                                  b * a.o_sb + qi * a.o_ss + h * a.o_sh;
      const __nv_bfloat16* drow = static_cast<const __nv_bfloat16*>(a.dout) +
                                  b * a.do_sb + qi * a.do_ss + h * a.do_sh;
      for (int j = quad; j < D / 8; j += 4) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * j);
        const uint4 gv = *reinterpret_cast<const uint4*>(drow + 8 * j);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 x = __bfloat1622float2(o2[u]);
          const float2 y = __bfloat1622float2(d2[u]);
          acc = __fmaf_rn(x.x, y.x, acc);
          acc = __fmaf_rn(x.y, y.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[e] = in ? acc : 0.0f;
    l2[e] = in ? a.lse[((long long)b * a.heads + h) * a.sq + qi] * kLog2e
               : __int_as_float(0x7f800000);
    if (quad == 0 && qi < a.sq_pad) {
      a.delta[pad_base + qi] = dl[e];
      a.lse2[pad_base + qi] = l2[e];
    }
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  const uint64_t dq_a = wgmma_desc(base + L::kOwn + c * 64 * kRowBytes, 16,
                                   1024);
  const uint64_t ddo_a = wgmma_desc(
      base + L::kOwn + L::kTileBytes + c * 64 * kRowBytes, 16, 1024);

  mbar_wait(own, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    const int k0 = kb * kRows;
    // a causal block wholly above this warpgroup's rows does nothing
    const bool skip = a.causal && k0 > wg_lo + 63;
    mbar_wait(full(s), (kb / kStages) & 1);
    if (!skip) {
      float sc[32], dp[32];
      wgmma_fence();
      product_nt<DP>(sc, dq_a, wgmma_desc(ring(s, 0), 16, 1024));
      product_nt<DP>(dp, ddo_a, wgmma_desc(ring(s, 1), 16, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      fence_regs(dp);
      // element 4i + e: query row r0 + 8 (e >> 1), key k0 + 8i + 2 quad +
      // (e & 1); dS in place of S
      const bool edge = k0 + kRows > kv_lim ||
                        (a.causal && k0 + kRows - 1 > wg_lo);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e, hf = e >> 1;
          float p = exp2f(sc[x] * cl2 - l2[hf]);
          if (edge) {
            const int key = k0 + 8 * i + 2 * quad + (e & 1);
            if (key >= kv_lim ||
                (a.causal && key > q0 + r0 + 8 * hf + a.q_offset))
              p = 0.0f;
          }
          sc[x] = p * (dp[x] - dl[hf]);
        }
      uint32_t hi[4][4], lo[4][4];
      split_frags(sc, hi, lo);
      fence_regs(acc);
      wgmma_fence();
      product_split(acc, hi, lo, wgmma_desc(ring(s, 0), kStageHalf, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    }
    mbar_arrive(empty(s));
  }

  store_rows(static_cast<__nv_bfloat16*>(a.dq) +
                 ((long long)b * a.sq * a.heads + h) * D,
             (long long)a.heads * D, q0 + r0, a.sq, D, acc, a.scale);
}

template <int DP>
__global__ void __launch_bounds__(kWThreads, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      AttnBwdArgs a) {
  using L = BwdLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t own = base + L::kBar;
  auto full = [&](int s) { return own + 8u * (1 + s); };
  auto empty = [&](int s) { return own + 8u * (1 + kStages + s); };
  auto ring = [&](int s, int x) {
    return base + L::kRing + (2 * s + x) * L::kStageBytes;
  };
  // each stage's 64 rows of lse2, then of delta (generic addresses)
  float* rows = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::kRowVals);

  const int bh_count = a.batch * a.kv_heads;
  // heaviest causal tiles (first key tiles) are scheduled first
  const int kt = (int)(blockIdx.x / bh_count);
  const int bh = (int)(blockIdx.x % bh_count);
  const int b = bh / a.kv_heads, hk = bh % a.kv_heads;
  const int group = a.heads / a.kv_heads;
  const int k0 = kt * kTile;
  const int kv_lim = min(a.kv_len, a.skv);
  // query blocks that see a key of this tile: from the one holding query
  // position k0 on (all of them without causality); none past kv_len
  const int n_qb = (a.sq + kRows - 1) / kRows;
  const int qb0 = a.causal ? max(0, k0 - a.q_offset) / kRows : 0;
  const int n_q = k0 < kv_lim ? n_qb - qb0 : 0;
  const int n_it = group * n_q;

  init_bars(own);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread loads K and V, then streams Q, dO and
    // their rows of lse2 and delta for each (query head, query block) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(own, 2 * L::kTileBytes);
      load_block<DP>(base + L::kOwn, kTileHalf, &tk, own, hk, k0, b);
      load_block<DP>(base + L::kOwn + L::kTileBytes, kTileHalf, &tv, own, hk,
                     k0, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int h = hk * group + it / n_q, q0 = (qb0 + it % n_q) * kRows;
        const long long row = ((long long)b * a.heads + h) * a.sq_pad + q0;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kStageBytes + L::kRowValBytes);
        load_block<DP>(ring(s, 0), kStageHalf, &tq, full(s), h, q0, b);
        load_block<DP>(ring(s, 1), kStageHalf, &tdo, full(s), h, q0, b);
        bulk_load(rows + s * 2 * kRows, a.lse2 + row, kRows * 4, full(s));
        bulk_load(rows + s * 2 * kRows + kRows, a.delta + row, kRows * 4,
                  full(s));
      }
    }
    return;
  }

  // ---- consumers: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int quad = lane % 4;
  const int r0 = c * 64 + warp * 16 + lane / 4;       // tile row, and r0 + 8
  const int kc = k0 + c * 64;                         // this consumer's keys
  const bool dead = kc >= kv_lim;                     // none of them visible
  const float cl2 = a.scale * kLog2e;
  const int D = a.head_dim;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;
  const uint64_t dk_a = wgmma_desc(base + L::kOwn + c * 64 * kRowBytes, 16,
                                   1024);
  const uint64_t dv_a = wgmma_desc(
      base + L::kOwn + L::kTileBytes + c * 64 * kRowBytes, 16, 1024);

  mbar_wait(own, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = (qb0 + it % n_q) * kRows;
    // a causal block wholly below this warpgroup's keys sees none of them
    const bool skip = dead || (a.causal && q0 + kRows - 1 + a.q_offset < kc);
    mbar_wait(full(s), (it / kStages) & 1);
    if (!skip) {
      float st[32], dpt[32];
      wgmma_fence();
      product_nt<DP>(st, dk_a, wgmma_desc(ring(s, 0), 16, 1024));
      product_nt<DP>(dpt, dv_a, wgmma_desc(ring(s, 1), 16, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(st);
      fence_regs(dpt);
      // element 4i + e: key row r0 + 8 (e >> 1), query q0 + 8i + 2 quad +
      // (e & 1); P^T in place of S^T, dS^T in place of dP^T
      const float* l2 = rows + s * 2 * kRows;
      const float* dl = l2 + kRows;
      const bool edge = kc + 63 >= kv_lim ||
                        (a.causal && q0 + a.q_offset < kc + 63);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e, col = 8 * i + 2 * quad + (e & 1);
          float p = exp2f(st[x] * cl2 - l2[col]);
          if (edge) {
            const int key = k0 + r0 + 8 * (e >> 1);
            if (key >= kv_lim ||
                (a.causal && key > q0 + col + a.q_offset))
              p = 0.0f;
          }
          st[x] = p;
          dpt[x] = p * (dpt[x] - dl[col]);
        }
      uint32_t phi[4][4], plo[4][4], shi[4][4], slo[4][4];
      split_frags(st, phi, plo);
      split_frags(dpt, shi, slo);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      product_split(dv, phi, plo, wgmma_desc(ring(s, 1), kStageHalf, 1024));
      product_split(dk, shi, slo, wgmma_desc(ring(s, 0), kStageHalf, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dv);
      fence_regs(dk);
    }
    mbar_arrive(empty(s));
  }

  const long long off = ((long long)b * a.skv * a.kv_heads + hk) * D;
  const long long ld = (long long)a.kv_heads * D;
  store_rows(static_cast<__nv_bfloat16*>(a.dk) + off, ld, k0 + r0, a.skv, D,
             dk, a.scale);
  store_rows(static_cast<__nv_bfloat16*>(a.dv) + off, ld, k0 + r0, a.skv, D,
             dv, 1.0f);
}

template <int DP>
int launch_bf16(const AttnBwdArgs& a, cudaStream_t stream) {
  // 4-D maps over (D, heads, S, B) in the tensors' own strides, the true D
  // as the extent (the boxes' columns from D to DP read the zero fill): a
  // CTA's own 128-row tiles and the ring's 64-row stages
  const int d = a.head_dim;
  auto map = [&](CUtensorMap* m, const void* p, int heads, int s,
                 long long sh, long long ss, long long sb, int rows) {
    return encode_bf16_4d(m, p, d, heads, s, a.batch, 2 * sh, 2 * ss, 2 * sb,
                          rows);
  };
  CUtensorMap tq, tdo, tk, tv, rq, rdo, rk, rv;
  if (!map(&tq, a.q, a.heads, a.sq, a.q_sh, a.q_ss, a.q_sb, kTile) ||
      !map(&tdo, a.dout, a.heads, a.sq, a.do_sh, a.do_ss, a.do_sb, kTile) ||
      !map(&tk, a.k, a.kv_heads, a.skv, a.k_sh, a.k_ss, a.k_sb, kTile) ||
      !map(&tv, a.v, a.kv_heads, a.skv, a.v_sh, a.v_ss, a.v_sb, kTile) ||
      !map(&rq, a.q, a.heads, a.sq, a.q_sh, a.q_ss, a.q_sb, kRows) ||
      !map(&rdo, a.dout, a.heads, a.sq, a.do_sh, a.do_ss, a.do_sb, kRows) ||
      !map(&rk, a.k, a.kv_heads, a.skv, a.k_sh, a.k_ss, a.k_sb, kRows) ||
      !map(&rv, a.v, a.kv_heads, a.skv, a.v_sh, a.v_ss, a.v_sb, kRows))
    return (int)cudaErrorInvalidValue;
  const int bytes = BwdLayout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dq_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_qt = (a.sq + kTile - 1) / kTile;
  const long long n_kt = (a.skv + kTile - 1) / kTile;
  dq_wgmma_kernel<DP><<<(unsigned)(n_qt * a.batch * a.heads), kWThreads,
                        bytes, stream>>>(tq, tdo, rk, rv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_wgmma_kernel<DP><<<(unsigned)(n_kt * a.batch * a.kv_heads), kWThreads,
                          bytes, stream>>>(tk, tv, rq, rdo, a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const AttnBwdArgs& a, cudaStream_t stream) {
  return a.dtype == 1 ? launch_bf16<DP>(a, stream) : launch_f32<DP>(a, stream);
}

// registers, local (spill) bytes a thread, dynamic shared bytes and threads
// of one kernel
template <typename K>
int attrs(K* kernel, int smem, int threads, int* out) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = smem;
  out[3] = threads;
  return (int)err;
}

}  // namespace

extern "C" int flash_attention_bwd(const AttnBwdArgs* a,
                                   cudaStream_t stream) {
  if (a->batch < 1 || a->sq < 1 || a->heads < 1) return (int)cudaSuccess;
  if (a->kv_heads < 1 || a->heads % a->kv_heads != 0 ||
      (a->dtype != 0 && a->dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (a->dtype == 1 && a->sq_pad < (a->sq + kRows - 1) / kRows * kRows)
    return (int)cudaErrorInvalidValue;
  switch (a->head_dim) {
    case 16: case 24: case 32: case 64:
      return launch<64>(*a, stream);
    case 112: case 128:
      return launch<128>(*a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The compiled kernels' attributes, 4 ints each (registers, local bytes a
// thread, dynamic shared bytes, threads) in the order of
// kernels/attention/kernel.py BWD_KERNELS: dq_wgmma_kernel<64>, <128>,
// dkdv_wgmma_kernel<64>, <128>, dq_kernel<64>, <128>, dkdv_kernel<64>,
// <128>.  `n` must be 8.
extern "C" int flash_attention_bwd_attrs(int* out, int n) {
  if (n != 8) return (int)cudaErrorInvalidValue;
  const int w64 = BwdLayout<64>::kBytes, w128 = BwdLayout<128>::kBytes;
  const int f = (int)sizeof(float);
  const int errs[8] = {
      attrs(dq_wgmma_kernel<64>, w64, kWThreads, out),
      attrs(dq_wgmma_kernel<128>, w128, kWThreads, out + 4),
      attrs(dkdv_wgmma_kernel<64>, w64, kWThreads, out + 8),
      attrs(dkdv_wgmma_kernel<128>, w128, kWThreads, out + 12),
      attrs(dq_kernel<64>, dq_smem_floats<64>() * f, kThreads, out + 16),
      attrs(dq_kernel<128>, dq_smem_floats<128>() * f, kThreads, out + 20),
      attrs(dkdv_kernel<64>, dkdv_smem_floats<64>() * f, kThreads, out + 24),
      attrs(dkdv_kernel<128>, dkdv_smem_floats<128>() * f, kThreads,
            out + 28)};
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}
