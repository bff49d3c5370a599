// Causal GQA flash attention with an online softmax.
//
//   flash_attention  replaces src/repro/kernels/attention/kernel.py:79
//                    flash_attention_pallas (_flash_kernel :26)
//
// What it computes: o = softmax(scale * q k^T + mask) v for q (B, Sq, H, D)
// and k, v (B, Skv, HKV, D), float32 or bfloat16, read in that layout through
// their strides (no transpose copy); query head h reads KV head
// h / (H / HKV) (GQA by index, K/V never repeated).  Scores, softmax and the
// PV accumulation are float32.  Masked scores are -1e30 and their
// probabilities exactly 0; the causal mask places the queries at the last Sq
// key positions (q_offset = Skv - Sq); keys at or beyond kv_len are hidden;
// a row with no visible key gives exactly 0.  The output is (B, Sq, H, D) in
// the inputs' dtype.
//
// What bounds it on an H100: operations.  At the prefill shape B = 4,
// S = 2048, H = 32, HKV = 8, D = 128, causal attention is ~1.4e11 FLOP per
// call against ~0.17 GB of q, k, v and o: ~0.14 ms at the 989 TFLOP/s bf16
// tensor-core peak, ~0.05 ms for the bytes.
//
// Design: the TPU kernel walks the KV axis as the innermost sequential grid
// dimension and carries the running max, sum and accumulator in VMEM
// scratch.  Here one CTA owns one (batch * head, 64-query) tile and loops
// over 64-key blocks itself; causal blocks above the diagonal are skipped by
// the loop bound, not visited.  The 64 x D query tile is staged in shared
// memory as float32 once; each KV block's K tile, then its V tile, pass
// through one shared buffer (so two CTAs fit an SM).  Thread (ty, tx) of 16 x
// 16 owns query rows 4ty..4ty+3: it computes their scores against keys
// tx + 16j with fp32 FMAs on the CUDA cores (float4 shared loads), keeps each
// row's running max and sum in registers (reduced over the 16 lanes of the
// row by shuffles), writes the probabilities to a shared P tile, and
// accumulates its 4 x D/16 slice of the output in registers.  Ragged Sq and
// Skv are masked in the kernel: out-of-range rows load zeros and are not
// stored.  This is a simple, correct first kernel: no tensor cores (wgmma),
// no TMA, no double buffering -- it runs at a fraction of the fp32 CUDA-core
// rate (67 TFLOP/s), far from the bf16 tensor-core bound above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Arguments of one launch; mirrored by kernels/attention/kernel.py _AttnArgs.
// Strides are in elements; the head dim is contiguous.
struct AttnArgs {
  const void* q;            // (B, Sq, H, D)
  const void* k;            // (B, Skv, HKV, D)
  const void* v;            // (B, Skv, HKV, D)
  void* o;                  // (B, Sq, H, D) out, contiguous
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int batch, sq, skv, heads, kv_heads, head_dim;
  int causal, kv_len, q_offset;
  int dtype;                // 0 float32, 1 bfloat16
  float scale;
};

namespace {

constexpr int kBQ = 64;                  // queries per CTA
constexpr int kBK = 64;                  // keys per KV block
constexpr int kThreads = 256;            // 16 x 16
constexpr int kRowsPer = kBQ / 16;       // query rows per thread
constexpr int kColsPer = kBK / 16;       // score columns per thread
constexpr float kNegInf = -1e30f;        // the Pallas kernel's NEG_INF
static_assert(kBQ == kBK, "stage() fills kBK rows of the Q tile too");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return 2 * kBQ * (D + 4) + kBQ * (kBK + 4);
}

// Stage the kBK rows of one head that start at `src` (a (B, S, heads, D)
// tensor, row stride `ss`) into a float32 tile of row stride D + 4; rows at
// or beyond `rows` read zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int rows) {
#pragma unroll 8
  for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * (D + 4) + d] = r < rows ? to_f(src[(long long)r * ss + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(AttnArgs a) {
  constexpr int LD = D + 4;              // Q, K, V tile row stride (floats)
  constexpr int LP = kBK + 4;            // P tile row stride
  constexpr int kVec = D / 64;           // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBQ * LD;
  float* sP = sKV + kBK * LD;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh_count = a.batch * a.heads;
  const int n_qb = (a.sq + kBQ - 1) / kBQ;
  // heaviest causal tiles (last query blocks) are scheduled first
  const int qb = n_qb - 1 - (int)(blockIdx.x / bh_count);
  const int bh = (int)(blockIdx.x % bh_count);
  const int b = bh / a.heads, h = bh % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const int q0 = qb * kBQ;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  stage<T, D>(sQ, q + (long long)q0 * a.q_ss, a.q_ss, a.sq - q0);

  // keys this tile can see: below kv_len and Skv, and under causality at
  // most the last query's position q0 + kBQ - 1 + q_offset
  const int kv_lim = min(a.kv_len, a.skv);
  int kv_end = kv_lim;
  if (a.causal) kv_end = min(kv_end, q0 + kBQ + a.q_offset);
  const int n_kb = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][4 * kVec];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kVec; ++c) acc[i][c] = 0.0f;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                       // last block's V and P reads done
    stage<T, D>(sKV, k + (long long)k0 * a.k_ss, a.k_ss, a.skv - k0);
    __syncthreads();

    float s[kRowsPer][kColsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRowsPer], kv[kColsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &sQ[(ty * kRowsPer + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < kColsPer; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &sKV[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kColsPer; ++j) {
          float t = s[i][j];
          t = __fmaf_rn(qv[i].x, kv[j].x, t);
          t = __fmaf_rn(qv[i].y, kv[j].y, t);
          t = __fmaf_rn(qv[i].z, kv[j].z, t);
          t = __fmaf_rn(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, then the online softmax of each of this thread's rows; the 16
    // lanes that share a row (one half-warp) reduce its max and sum
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int row = ty * kRowsPer + i;
      const int qpos = q0 + row + a.q_offset;
      bool vis[kColsPer];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        const int kpos = k0 + tx + 16 * j;
        vis[j] = kpos < kv_lim && (!a.causal || kpos <= qpos);
        s[i][j] = vis[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.0f;
        sP[row * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kVec; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                       // scores done with K; P written
    stage<T, D>(sKV, v + (long long)k0 * a.v_ss, a.v_ss, a.skv - k0);
    __syncthreads();

    // acc += P V over this block's keys; columns (16u + tx) * 4 + e
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &sP[(ty * kRowsPer + i) * LP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 vv[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          vv[u] = *reinterpret_cast<const float4*>(
              &sKV[(c + cc) * LD + (16 * u + tx) * 4]);
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                        : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            acc[i][4 * u + 0] = __fmaf_rn(p, vv[u].x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = __fmaf_rn(p, vv[u].y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = __fmaf_rn(p, vv[u].z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = __fmaf_rn(p, vv[u].w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }

  // epilogue: divide by the row sum (a row with no visible key has l = 0
  // and acc = 0, and stays 0) and store in the inputs' dtype
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int qi = q0 + ty * kRowsPer + i;
    if (qi >= a.sq) continue;
    const float den = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = o + (((long long)b * a.sq + qi) * a.heads + h) * D;
#pragma unroll
    for (int u = 0; u < kVec; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put(&orow[(16 * u + tx) * 4 + e], acc[i][4 * u + e] / den);
  }
}

template <typename T, int D>
int launch(const AttnArgs& a, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_qb = (a.sq + kBQ - 1) / kBQ;
  const long long blocks = n_qb * a.batch * a.heads;
  flash_kernel<T, D><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const AttnArgs* a, cudaStream_t stream) {
  if (a->batch < 1 || a->sq < 1 || a->heads < 1) return (int)cudaSuccess;
  if (a->kv_heads < 1 || a->heads % a->kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const bool bf16 = a->dtype == 1;
  if (a->dtype != 0 && !bf16) return (int)cudaErrorInvalidValue;
  switch (a->head_dim) {
    case 64:
      return bf16 ? launch<__nv_bfloat16, 64>(*a, stream)
                  : launch<float, 64>(*a, stream);
    case 128:
      return bf16 ? launch<__nv_bfloat16, 128>(*a, stream)
                  : launch<float, 128>(*a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
