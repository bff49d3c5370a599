// Causal GQA flash attention with an online softmax.
//
//   flash_attention  replaces src/repro/kernels/attention/kernel.py:79
//                    flash_attention_pallas (_flash_kernel :26)
//
// What it computes: o = softmax(scale * q k^T + mask) v for q (B, Sq, H, D)
// and k, v (B, Skv, HKV, D), float32 or bfloat16, read in that layout through
// their strides (no transpose copy); query head h reads KV head
// h / (H / HKV) (GQA by index, K/V never repeated).  Masked scores get
// probability exactly 0; the causal mask places the queries at the last Sq
// key positions (q_offset = Skv - Sq); keys at or beyond kv_len are hidden;
// a row with no visible key gives exactly 0.  The output is (B, Sq, H, D) in
// the inputs' dtype.  Where the caller asks for it (lse not null, a forward
// whose gradient will be taken), each row's float32 log-sum-exp of the
// scaled scores, lse (B, H, Sq), is written beside it for the backward
// (flash_attention_bwd.cu): m + log(l) in natural-log units, +inf for a row
// with no visible key.  D is any of 16, 24, 32, 64, 112 and 128 (the head
// widths of the repo's configs); the C entry refuses any other.
//
// Head widths.  Both kernels are built for a padded width DP, 64 or 128,
// and take the true D at run time: the columns from D up to DP load as
// zeros (the staging loop's bound in float32, TMA's out-of-bounds fill in
// bf16, whose maps carry the true D as the global extent), add nothing to
// Q K^T and give zero columns of P V, which the epilogue does not store; o
// is written at the row stride of the true D.  So D = 112 costs what
// D = 128 costs, and D = 16-32 what D = 64 costs.  (Skipping the k-steps
// of Q K^T that see only zeros, by a run-time bound on the unrolled wgmma
// loop, made every width 10-12% slower: ptxas then injects a
// warpgroup.arrive before each product, C7519.)  The bf16 kernel reads D
// at run time only where it pads (kPad); 64 and 128 keep the compile-time
// epilogue.
//
// What bounds it on an H100: operations.  At qwen3-4b's prefill shape B = 4,
// S = 2048, H = 32, HKV = 8, D = 128, causal attention is ~1.4e11 FLOP per
// call against ~0.17 GB of q, k, v and o: ~0.14 ms at the 989 TFLOP/s bf16
// tensor-core peak, ~0.05 ms for the bytes.  Only the tensor cores reach
// that: at the 67 TFLOP/s of the CUDA cores the same FLOP take >= 2 ms.
//
// bfloat16 (flash_wgmma_kernel) is a Hopper kernel.  One CTA owns one
// (batch, head, 128-query) tile and walks its 128-key blocks; causal blocks
// above the diagonal are skipped by the loop bound, and the heaviest tiles
// launch first.  Three warpgroups: a producer, whose one elected thread
// issues TMA loads (4-D tensor maps over q, k, v in their own strides,
// 128-byte swizzle, the hardware's zero fill for ragged Sq and Skv) into a
// ring of 2 K and 2 V stages guarded by full/empty mbarriers, so the loads
// of block j + 1 fly while block j computes; and two consumers of 64 query
// rows each.  A consumer computes S = Q K^T with wgmma m64n128k16 (both
// operands in shared memory, K K-major), runs the online softmax on the
// accumulator fragments in registers (row max over the 4 threads of a row,
// masks only on the diagonal, ragged and kv_len blocks, scores scaled by
// scale * log2(e) and exponentiated with exp2f), and adds P V with wgmma
// whose A operand is P in registers (the accumulator layout is the
// A-fragment layout) and whose B is V in shared memory, MN-major.
// setmaxnreg moves registers from the producer to the consumers.
//
// The split-P contract.  Both references multiply P by V in float32; a
// tensor-core product takes P in bf16, which alone leaves rtol 2e-2 /
// atol 2e-3 once |V| is large (0.17% of the elements at |V| ~ 8).  So P is
// split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and O accumulates
// P_hi V + P_lo V in float32: P carries ~16 significant bits.  The row sum
// l is the float32 sum of the unrounded P, as in the references.
//
// float32 (flash_kernel) keeps a CUDA-core kernel, because its 1e-5
// contract cannot go through bf16 or TF32 tensor cores: one CTA per
// (batch * head, 64-query) tile, Q staged in shared memory, K then V passed
// through one shared buffer, thread (ty, tx) of 16 x 16 owning query rows
// 4ty..4ty+3 with fp32 FMAs (float4 shared loads), the probabilities in a
// shared P tile and its 4 x D/16 output slice in registers.
#include "hopper.cuh"

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
  float* lse;               // (B, H, Sq) out, or null: not wanted
};

namespace {

constexpr float kNegInf = -1e30f;        // the Pallas kernel's NEG_INF

// ---- float32: the CUDA-core kernel ----------------------------------------

constexpr int kBQ = 64;                  // queries per CTA
constexpr int kBK = 64;                  // keys per KV block
constexpr int kThreads = 256;            // 16 x 16
constexpr int kRowsPer = kBQ / 16;       // query rows per thread
constexpr int kColsPer = kBK / 16;       // score columns per thread
static_assert(kBQ == kBK, "stage() fills kBK rows of the Q tile too");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

template <int DP>
constexpr int smem_floats() {
  return 2 * kBQ * (DP + 4) + kBQ * (kBK + 4);
}

// Stage the kBK rows of one head that start at `src` (a (B, S, heads, d)
// tensor, row stride `ss`) into a float32 tile of DP columns and row stride
// DP + 4; rows at or beyond `rows` and columns at or beyond `d` read zero.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int rows, int d) {
#pragma unroll 8
  for (int e = threadIdx.x; e < kBK * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    dst[r * (DP + 4) + c] =
        r < rows && c < d ? to_f(src[(long long)r * ss + c]) : 0.0f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(AttnArgs a) {
  constexpr int LD = DP + 4;             // Q, K, V tile row stride (floats)
  constexpr int LP = kBK + 4;            // P tile row stride
  constexpr int kVec = DP / 64;          // float4 output chunks per thread
  const int D = a.head_dim;              // the true width, <= DP
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

  stage<T, DP>(sQ, q + (long long)q0 * a.q_ss, a.q_ss, a.sq - q0, D);

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
    stage<T, DP>(sKV, k + (long long)k0 * a.k_ss, a.k_ss, a.skv - k0, D);
    __syncthreads();

    float s[kRowsPer][kColsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
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
    stage<T, DP>(sKV, v + (long long)k0 * a.v_ss, a.v_ss, a.skv - k0, D);
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
  // and acc = 0, and stays 0) and store the true D columns in the inputs'
  // dtype
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int qi = q0 + ty * kRowsPer + i;
    if (qi >= a.sq) continue;
    if (a.lse && tx == 0)
      a.lse[((long long)b * a.heads + h) * a.sq + qi] =
          l[i] == 0.0f ? __int_as_float(0x7f800000) : m[i] + logf(l[i]);
    const float den = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = o + (((long long)b * a.sq + qi) * a.heads + h) * D;
#pragma unroll
    for (int u = 0; u < kVec; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (16 * u + tx) * 4 + e;
        if (col < D) put(&orow[col], acc[i][4 * u + e] / den);
      }
  }
}

template <typename T, int DP>
int launch(const AttnArgs& a, cudaStream_t stream) {
  const int bytes = smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_qb = (a.sq + kBQ - 1) / kBQ;
  const long long blocks = n_qb * a.batch * a.heads;
  flash_kernel<T, DP><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- bfloat16: the Hopper kernel (TMA, mbarrier ring, wgmma) ---------------

constexpr int kWBQ = 128;                // queries per CTA: 2 consumers x 64
constexpr int kWBK = 128;                // keys per KV block (one stage)
constexpr int kStages = 2;               // K and V stages in the ring
constexpr int kWThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kBox = 64;                 // TMA box width: 128 bytes of D
constexpr int kRowBytes = kBox * 2;      // one swizzled row of a box
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct WLayout {          // byte offsets from a 1024-aligned base
  static constexpr int kHalves = DP / kBox;              // boxes along D
  static constexpr int kQHalf = kWBQ * kRowBytes;        // 16 KB
  static constexpr int kKVHalf = kWBK * kRowBytes;       // 16 KB
  static constexpr int kQ = kHalves * kQHalf;
  static constexpr int kKV = kHalves * kKVHalf;          // one K or V stage
  static constexpr int kK0 = kQ;
  static constexpr int kV0 = kK0 + kStages * kKV;
  static constexpr int kBar = kV0 + kStages * kKV;
  static constexpr int kBars = 1 + 4 * kStages;          // q, k/v full/empty
  static constexpr int kBytes = kBar + 8 * kBars + 1024; // + alignment slack
};

// kPad: D < DP, the true width read from the arguments; without it D is
// DP at compile time and the epilogue stores every pair unconditionally
// (a run-time D there cost the full widths 2-3%).
template <int DP, bool kPad>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, AttnArgs a) {
  using L = WLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;   // q_full, k_full[], k_empty[],
  const uint32_t q_full = bar;           // v_full[], v_empty[]
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto k_empty = [&](int s) { return bar + 8u * (1 + kStages + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8u * (1 + 3 * kStages + s); };

  const int bh_count = a.batch * a.heads;
  const int n_qb = (a.sq + kWBQ - 1) / kWBQ;
  // heaviest causal tiles (last query blocks) are scheduled first
  const int qb = n_qb - 1 - (int)(blockIdx.x / bh_count);
  const int bh = (int)(blockIdx.x % bh_count);
  const int b = bh / a.heads, h = bh % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const int q0 = qb * kWBQ;
  const int kv_lim = min(a.kv_len, a.skv);
  int kv_end = kv_lim;
  if (a.causal) kv_end = min(kv_end, q0 + kWBQ + a.q_offset);
  const int n_kb = kv_end > 0 ? (kv_end + kWBK - 1) / kWBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * 128);    // every consumer thread arrives
      mbar_init(v_empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQ);
      for (int x = 0; x < L::kHalves; ++x)
        tma_load(base + x * L::kQHalf, &tq, q_full, x * kBox, h, q0, b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        const uint32_t ph = (kb / kStages) & 1;
        const uint32_t ks = base + L::kK0 + s * L::kKV;
        const uint32_t vs = base + L::kV0 + s * L::kKV;
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), L::kKV);
        for (int x = 0; x < L::kHalves; ++x)
          tma_load(ks + x * L::kKVHalf, &tk, k_full(s), x * kBox, hk,
                   kb * kWBK, b);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), L::kKV);
        for (int x = 0; x < L::kHalves; ++x)
          tma_load(vs + x * L::kKVHalf, &tv, v_full(s), x * kBox, hk,
                   kb * kWBK, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int quad = lane % 4;
  const int row0 = c * 64 + warp * 16 + lane / 4;        // and row0 + 8
  const int qpos0 = q0 + row0 + a.q_offset, qpos1 = qpos0 + 8;
  const int wg_lo = q0 + c * 64 + a.q_offset;            // first query pos
  const float cl2 = a.scale * kLog2e;
  constexpr int kNO = DP / 2;                            // O floats/thread
  const int D = kPad ? a.head_dim : DP;                 // the true width

  // K-major operands: 16-element k-step kk is 32 bytes into box kk / 4;
  // 8-row groups 1024 bytes apart.  V is MN-major: 16 keys are 2048 bytes,
  // the two D boxes kKVHalf apart, 8-key groups 1024 bytes apart.
  const uint64_t dq = wgmma_desc(base + c * 64 * kRowBytes, 16, 1024);
  float o[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(q_full, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    const uint32_t ph = (kb / kStages) & 1;
    const int k0 = kb * kWBK;
    // a causal block wholly above this warpgroup's rows does nothing
    const bool skip = a.causal && k0 > wg_lo + 63;
    const uint64_t dk = wgmma_desc(base + L::kK0 + s * L::kKV, 16, 1024);
    const uint64_t dv = wgmma_desc(base + L::kV0 + s * L::kKV, L::kKVHalf,
                                   1024);
    float sc[64];
    mbar_wait(k_full(s), ph);
    if (!skip) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = ((kk / 4) * L::kQHalf + (kk % 4) * 32) >> 4;
        const uint32_t koff = ((kk / 4) * L::kKVHalf + (kk % 4) * 32) >> 4;
        wgmma_ss_n128(sc, dq + off, dk + koff, kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
    }
    mbar_arrive(k_empty(s));

    uint32_t phi[8][4], plo[8][4];
    if (!skip) {
      // scores in log2 units; element 4i + e is row row0 (e < 2) or
      // row0 + 8, key k0 + 8i + 2 quad + (e & 1)
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= cl2;
      const bool edge = k0 + kWBK > kv_lim ||
                        (a.causal && k0 + kWBK - 1 > wg_lo);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * i + 2 * quad + (e & 1);
            const int qp = e < 2 ? qpos0 : qpos1;
            if (key >= kv_lim || (a.causal && key > qp))
              sc[4 * i + e] = __int_as_float(0xff800000);   // -inf
          }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // masked scores are -inf: exp2f gives exactly 0 (a row with nothing
      // visible yet keeps m = -1e30 and alpha = 1)
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sc[4 * i] = exp2f(sc[4 * i] - mn0);
        sc[4 * i + 1] = exp2f(sc[4 * i + 1] - mn0);
        sc[4 * i + 2] = exp2f(sc[4 * i + 2] - mn1);
        sc[4 * i + 3] = exp2f(sc[4 * i + 3] - mn1);
        rs0 += sc[4 * i] + sc[4 * i + 1];
        rs1 += sc[4 * i + 2] + sc[4 * i + 3];
      }
      l0 = l0 * al0 + rs0;               // this thread's share of the row
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int i = 0; i < kNO / 4; ++i) {
        o[4 * i] *= al0;
        o[4 * i + 1] *= al0;
        o[4 * i + 2] *= al1;
        o[4 * i + 3] *= al1;
      }
      // the accumulator layout of keys 16kk..16kk+15 is the A fragment of
      // k-step kk: (row0, k 2q), (row0 + 8, k 2q), (row0, 8 + 2q), ...
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_pair(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], phi[kk][r],
                     plo[kk][r]);
    }

    mbar_wait(v_full(s), ph);
    if (!skip) {
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, phi[kk], dv + kk * 128);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, plo[kk], dv + kk * 128);
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
    }
    mbar_arrive(v_empty(s));
  }

  // epilogue: the row sums over the row's 4 threads, then O / l (a row with
  // no visible key has l = 0 and O = 0, and stays 0), stored as bf16 pairs;
  // a pair at column 8i + 2 quad is stored where it lies below the true D
  // (D is a multiple of 8, so a pair is wholly in or out)
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float den0 = l0 == 0.0f ? 1.0f : l0, den1 = l1 == 0.0f ? 1.0f : l1;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + row0 + 8 * half;
    if (qi >= a.sq) continue;
    const float den = half ? den1 : den0;
    if (a.lse && quad == 0) {
      // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2
      const float lr = half ? l1 : l0, mr = half ? m1 : m0;
      a.lse[((long long)b * a.heads + h) * a.sq + qi] =
          lr == 0.0f ? __int_as_float(0x7f800000)
                     : (mr + log2f(lr)) * 0.6931471805599453f;
    }
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        out + (((long long)b * a.sq + qi) * a.heads + h) * D + 2 * quad);
#pragma unroll
    for (int i = 0; i < kNO / 4; ++i)
      if (!kPad || 8 * i + 2 * quad < D)
        orow[4 * i] = bf16_pair(o[4 * i + 2 * half] / den,
                                o[4 * i + 2 * half + 1] / den);
  }
}

template <int DP, bool kPad>
int launch_bf16(const AttnArgs& a, cudaStream_t stream) {
  // 4-D maps over (D, heads, S, B) in the tensors' own strides, the true D
  // as the extent: the boxes' columns from D to DP read the zero fill
  const int d = a.head_dim;
  CUtensorMap tq, tk, tv;
  if (!encode_bf16_4d(&tq, a.q, d, a.heads, a.sq, a.batch, 2 * a.q_sh,
                      2 * a.q_ss, 2 * a.q_sb, kWBQ) ||
      !encode_bf16_4d(&tk, a.k, d, a.kv_heads, a.skv, a.batch, 2 * a.k_sh,
                      2 * a.k_ss, 2 * a.k_sb, kWBK) ||
      !encode_bf16_4d(&tv, a.v, d, a.kv_heads, a.skv, a.batch, 2 * a.v_sh,
                      2 * a.v_ss, 2 * a.v_sb, kWBK))
    return (int)cudaErrorInvalidValue;
  const int bytes = WLayout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_qb = (a.sq + kWBQ - 1) / kWBQ;
  const long long blocks = n_qb * a.batch * a.heads;
  flash_wgmma_kernel<DP, kPad>
      <<<(unsigned)blocks, kWThreads, bytes, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const AttnArgs* a, cudaStream_t stream) {
  if (a->batch < 1 || a->sq < 1 || a->heads < 1) return (int)cudaSuccess;
  if (a->kv_heads < 1 || a->heads % a->kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const bool bf16 = a->dtype == 1;
  if (a->dtype != 0 && !bf16) return (int)cudaErrorInvalidValue;
  // each head width runs the instantiation of its padded width DP
  switch (a->head_dim) {
    case 16: case 24: case 32:
      return bf16 ? launch_bf16<64, true>(*a, stream)
                  : launch<float, 64>(*a, stream);
    case 64:
      return bf16 ? launch_bf16<64, false>(*a, stream)
                  : launch<float, 64>(*a, stream);
    case 112:
      return bf16 ? launch_bf16<128, true>(*a, stream)
                  : launch<float, 128>(*a, stream);
    case 128:
      return bf16 ? launch_bf16<128, false>(*a, stream)
                  : launch<float, 128>(*a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
