// Mamba2 SSD (state-space duality) scan, chunked, one CTA per (batch, head).
//
//   ssd_scan  replaces src/repro/kernels/ssd/kernel.py:65 ssd_pallas
//             (_ssd_kernel :20, pallas_call :86)
//
// What it computes: for x (B, L, H, P), dt (B, L, H) float32, a (H,) float32
// and B, C (B, L, G, S), where head h reads group h / (H / G) (the groups
// are indexed, never repeated to heads), the recurrence from a zero state
//   state_t = exp(a_h dt_t) state_{t-1} + dt_t B_t (x) x_t,   y_t = C_t state_t
// in its chunked form.  x, B and C are float32 or bfloat16 (one dtype), read
// in that layout through their strides (the last dim contiguous).  All
// arithmetic is float32.  Out: y (B, L, H, P) in x's dtype and the final
// state (B, H, S, P) in float32.  Any L: rows at or beyond L load zeros and
// dt = 0, which are exact no-ops, and are not stored.
//
// What bounds it on an H100: operations.  At mamba2-1.3b's prefill of
// B = 4 prompts of 2048 tokens (H = 64, P = 64, S = 128, G = 1; chunk 256 in
// the model), the chunked SSD is ~4.3e10 FLOP per call against ~0.15 GB of
// x, y, B, C, dt and the final state: ~0.044 ms at the 989 TFLOP/s bf16
// tensor-core peak, ~0.044 ms for the bytes.
//
// Design: the TPU kernel walks the chunks of one (b, h) serially on its
// sequential grid axis with the (S, P) state in VMEM.  Here one CTA of 256
// threads owns one (b, h) and walks L itself in sub-blocks of 64 rows (the
// result does not depend on the chunk length up to rounding; 64 rows keep
// the working set small), with the state resident in shared memory for the
// whole walk.  Per sub-block, with lg = a cumsum(dt) (a warp scan):
//   1. one pass over S forms both C B^T (64 x 64) and C state (64 x P),
//      sharing the loads of C;
//   2. G = (C B^T) o exp(lg_t - lg_z) o dt_z for z <= t (the gate is formed
//      only there: its exponents are <= 0, nothing overflows) replaces C in
//      shared memory;
//   3. y = exp(lg) o (C state) + G x, over the causal triangle of G only;
//   4. state <- exp(lg_end) state + B^T (w o x), w = exp(lg_end - lg) dt.
// Tiles are float32 in shared memory (115,456 bytes: x, B, C/G and the
// state) so that two CTAs share an SM; B's float4 quads are XOR-swizzled by
// row so the 16 rows that step 1 reads together fall in distinct banks.
// At B = 4, H = 64 the grid is 256 CTAs on 132 SMs: one wave at two CTAs per
// SM.  A chunk-parallel form (chunk states in parallel, a short scan, then
// the inter-chunk output) would expose L/64 times more CTAs at B = 1; it
// costs two more passes over the states and is left for later.  This is a
// simple, correct first kernel: fp32 FMAs on the CUDA cores (no wgmma, no
// TMA, no double buffering), far from the bf16 tensor-core bound above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Arguments of one launch; mirrored by kernels/ssd/kernel.py _SsdArgs.
// Strides are in elements; x, B and C have a contiguous last dim.
struct SsdArgs {
  const void* x;            // (B, L, H, P)
  const float* dt;          // (B, L, H)
  const float* a;           // (H,)
  const void* b;            // (B, L, G, S)
  const void* c;            // (B, L, G, S)
  void* y;                  // (B, L, H, P) out, contiguous
  float* state;             // (B, H, S, P) out, contiguous
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl, b_sg, c_sb, c_sl, c_sg;
  int batch, length, heads, groups, head_dim, state_dim;
  int dtype;                // 0 float32, 1 bfloat16 (x, B, C and y)
};

namespace {

constexpr int kQ = 64;                   // rows per sub-block
constexpr int kP = 64;                   // largest head_dim (tile columns)
constexpr int kS = 128;                  // largest state
constexpr int kThreads = 256;            // 16 x 16
// x [kQ][kP], B [kQ][kS] (swizzled), C [kQ][kS] then G [kQ][kQ], the state
// [kS][kP], then dt, lg and w [kQ] each; kernel.py SMEM_BYTES is the same
constexpr int kSmemBytes =
    4 * (kQ * kP + 2 * kQ * kS + kS * kP + 3 * kQ);
static_assert(kThreads == 4 * kQ && kThreads == 2 * kS,
              "thread tiles: 4 rows x 4 columns of y, 8 x 4 of the state");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// float offset of the float4 quad q (columns 4q..4q+3) of row r of the B
// tile: stored at quad q ^ (r & 7)
__device__ __forceinline__ int bq(int r, int q) {
  return r * kS + ((q ^ (r & 7)) << 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_kernel(SsdArgs a) {
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);
  float* sB = sX + kQ * kP;
  float* sC = sB + kQ * kS;              // the C tile, then G (row stride kQ)
  float* sT = sC + kQ * kS;              // the state, [s][p]
  float* sDt = sT + kS * kP;
  float* sLg = sDt + kQ;
  float* sW = sLg + kQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int g = h / (a.heads / a.groups);
  const int P = a.head_dim, S = a.state_dim, L = a.length;
  const float A = a.a[h];
  const T* xp = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float* dtp = a.dt + b * a.dt_sb + h * a.dt_sh;
  const T* bp = static_cast<const T*>(a.b) + b * a.b_sb + g * a.b_sg;
  const T* cp = static_cast<const T*>(a.c) + b * a.c_sb + g * a.c_sg;
  const long long y_sl = (long long)a.heads * P;
  T* yp = static_cast<T*>(a.y) + (long long)b * L * y_sl + (long long)h * P;

  for (int e = tid; e < kS * kP; e += kThreads) sT[e] = 0.0f;

  const int n_blk = (L + kQ - 1) / kQ;
  for (int blk = 0; blk < n_blk; ++blk) {
    const int t0 = blk * kQ;
    const int rows = min(kQ, L - t0);
    __syncthreads();                     // last sub-block's reads are done

    // stage rows t0.. of x, B, C and dt as float32; rows at or beyond L and
    // columns at or beyond P or S read zero
    for (int e = tid; e < kQ * kP; e += kThreads) {
      const int r = e / kP, p = e % kP;
      sX[e] = (r < rows && p < P)
                  ? to_f(xp[(long long)(t0 + r) * a.x_sl + p]) : 0.0f;
    }
    for (int e = tid; e < kQ * kS; e += kThreads) {
      const int r = e / kS, s = e % kS;
      const bool in = r < rows && s < S;
      const long long t = t0 + r;
      sB[bq(r, s >> 2) + (s & 3)] = in ? to_f(bp[t * a.b_sl + s]) : 0.0f;
      sC[e] = in ? to_f(cp[t * a.c_sl + s]) : 0.0f;
    }
    if (tid < kQ)
      sDt[tid] = tid < rows ? dtp[(long long)(t0 + tid) * a.dt_sl] : 0.0f;
    __syncthreads();

    // warp 0: lg = a * cumsum(dt) over the sub-block (lane l owns rows 2l
    // and 2l + 1) and the state update's weights w = exp(lg_end - lg) dt
    if (tid < 32) {
      const float d0 = sDt[2 * tid], d1 = sDt[2 * tid + 1];
      float run = d0 + d1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, run, o);
        if (tid >= o) run += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, run, 1);
      if (tid == 0) excl = 0.0f;
      const float c0 = excl + d0, c1 = c0 + d1;
      const float lg0 = A * c0, lg1 = A * c1;
      const float lend = __shfl_sync(0xffffffffu, lg1, 31);
      sLg[2 * tid] = lg0;
      sLg[2 * tid + 1] = lg1;
      sW[2 * tid] = expf(lend - lg0) * d0;
      sW[2 * tid + 1] = expf(lend - lg1) * d1;
    }
    __syncthreads();

    // 1. C B^T and C state: thread (ty, tx) owns rows 4ty..4ty+3 and
    //    columns tx + 16j (keys z of C B^T, channels p of C state)
    float cb[4][4], cs[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] = cs[i][j] = 0.0f;
    const int nq = S / 4;
#pragma unroll 2
    for (int q = 0; q < nq; ++q) {
      float4 cv[4], bv[4];
      float st[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cv[i] = *reinterpret_cast<const float4*>(&sC[(4 * ty + i) * kS +
                                                     4 * q]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(&sB[bq(tx + 16 * j, q)]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          st[e][j] = sT[(4 * q + e) * kP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = cb[i][j];
          t = __fmaf_rn(cv[i].x, bv[j].x, t);
          t = __fmaf_rn(cv[i].y, bv[j].y, t);
          t = __fmaf_rn(cv[i].z, bv[j].z, t);
          t = __fmaf_rn(cv[i].w, bv[j].w, t);
          cb[i][j] = t;
          float u = cs[i][j];
          u = __fmaf_rn(cv[i].x, st[0][j], u);
          u = __fmaf_rn(cv[i].y, st[1][j], u);
          u = __fmaf_rn(cv[i].z, st[2][j], u);
          u = __fmaf_rn(cv[i].w, st[3][j], u);
          cs[i][j] = u;
        }
    }
    __syncthreads();                     // every read of C is done

    // 2. G replaces C; y starts as the inter-block term exp(lg) C state
    float* sG = sC;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float lr = sLg[r];
      const float er = expf(lr);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int z = tx + 16 * j;
        sG[r * kQ + z] = z <= r ? cb[i][j] * expf(lr - sLg[z]) * sDt[z]
                                : 0.0f;
        acc[i][j] = er * cs[i][j];
      }
    }
    __syncthreads();

    // 3. y += G x over keys z <= 4ty + 3 (G is 0 above the diagonal)
    for (int q = 0; q <= ty; ++q) {
      float4 gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        gv[i] = *reinterpret_cast<const float4*>(&sG[(4 * ty + i) * kQ +
                                                     4 * q]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sX[(4 * q + e) * kP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gi = e == 0 ? gv[i].x : e == 1 ? gv[i].y
                         : e == 2 ? gv[i].z : gv[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fmaf_rn(gi, xv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r >= rows) continue;
      T* yrow = yp + (long long)(t0 + r) * y_sl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < P) put(&yrow[p], acc[i][j]);
      }
    }

    // 4. state <- exp(lg_end) state + B^T (w o x): thread (ty, tx) owns
    //    state rows 8ty..8ty+7 and columns tx + 16j
    const float decay = expf(sLg[kQ - 1]);
    float up[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) up[k][j] = 0.0f;
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      const float wr = sW[r];
      float xw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) xw[j] = sX[r * kP + tx + 16 * j] * wr;
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[bq(r, 2 * ty)]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sB[bq(r, 2 * ty + 1)]);
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          up[k][j] = __fmaf_rn(bb[k], xw[j], up[k][j]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* st = &sT[(8 * ty + k) * kP + tx + 16 * j];
        *st = decay * *st + up[k][j];
      }
  }

  __syncthreads();
  float* out = a.state + ((long long)b * a.heads + h) * S * P;
  for (int e = tid; e < S * P; e += kThreads)
    out[e] = sT[(e / P) * kP + e % P];
}

template <typename T>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_kernel<T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const SsdArgs& a, cudaStream_t stream) {
  const cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.batch * a.heads;
  ssd_kernel<T><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// expected_smem: the wrapper's count (kernel.py SMEM_BYTES); a mismatch
// means the two layouts disagree, and the launch is refused.
extern "C" int ssd_scan(const SsdArgs* a, size_t expected_smem,
                        cudaStream_t stream) {
  if (expected_smem != (size_t)kSmemBytes) return (int)cudaErrorInvalidValue;
  if (a->batch < 1 || a->heads < 1) return (int)cudaSuccess;
  if (a->length < 0 || a->groups < 1 || a->heads % a->groups != 0 ||
      a->head_dim < 1 || a->head_dim > kP || a->state_dim < 4 ||
      a->state_dim > kS || a->state_dim % 4 != 0)
    return (int)cudaErrorInvalidValue;
  switch (a->dtype) {
    case 0:
      return launch<float>(*a, stream);
    case 1:
      return launch<__nv_bfloat16>(*a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// CTAs of ssd_kernel one SM holds at once, for the report.
extern "C" int ssd_blocks_per_sm(int dtype, int* out) {
  cudaError_t err;
  if (dtype == 1) {
    err = prepare<__nv_bfloat16>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, ssd_kernel<__nv_bfloat16>, kThreads, kSmemBytes);
  } else {
    err = prepare<float>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, ssd_kernel<float>, kThreads, kSmemBytes);
  }
  return (int)err;
}
