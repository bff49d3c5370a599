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
// in that layout through their strides (the last dim contiguous).  Out: y
// (B, L, H, P) in x's dtype and the final state (B, H, S, P) in float32.
// Any L: rows at or beyond L read zeros and dt = 0, which are exact no-ops,
// and are not stored.  Per chunk of 64 rows, with lg = a cumsum(dt):
//   G  = (C B^T) o exp(lg_t - lg_z) o dt_z for z <= t (the gate is formed
//        only there: its exponents are <= 0, nothing overflows);
//   y  = exp(lg) o (C state) + G x;
//   state <- exp(lg_end) state + B^T (w o x),  w = exp(lg_end - lg) dt.
//
// What bounds it on an H100: bytes, then operations.  At mamba2-1.3b's
// prefill of B = 4 prompts of 2048 tokens (H = 64, P = 64, S = 128, G = 1;
// chunk 256 in the model) the call moves ~0.15 GB (x and y in bf16 are
// 0.13 GB of it): ~0.044 ms at 3.35 TB/s.  Its ~4.3e10 FLOP of chunked SSD
// take ~0.044 ms at the 989 TFLOP/s bf16 tensor-core peak, and >= 0.6 ms
// at the 67 TFLOP/s of the CUDA cores: only the tensor cores come near.
//
// bfloat16 (ssd_wgmma_kernel) is a Hopper kernel.  One CTA of one
// warpgroup (128 threads) owns one (b, h) and walks its 64-row chunks in
// order, two CTAs an SM.  Its loads run one chunk ahead into a ring of two
// stages (x, B and C as bf16 tiles of 64-element rows with TMA's 128-byte
// swizzle, and dt): by TMA on the stage's mbarrier (4-D maps in the
// tensors' own strides; the hardware's zero fill covers the ragged tail,
// P < 64 and S < 128), or, for a view a map cannot describe (a base or a
// stride off 16 bytes), by 4-byte cp.async where both ends allow and
// 2-byte loads elsewhere; dt always by cp.async.  Each chunk's four
// products are wgmma with bf16 operands and float32 accumulators:
//   1. C B^T          (t x z, K = S): both operands the bf16 tiles, exact;
//   2. state^T C^T    (p x t, K = S): A = the state from registers;
//   3. x^T G^T        (p x t, K = z): A = x (ldmatrix.trans), B = G in
//                                     shared memory;
//   4. (w o x)^T B    (p x s, K = z): A from registers, B the B tile read
//                                     MN-major (transposed).
// The state lives in the accumulator of product 4, transposed (p x s): 64
// float32 registers a thread that never reach shared or device memory
// before the final store.  exp(lg_end) scales it in registers before each
// accumulate, and its accumulator layout is the A-fragment layout of
// product 2 (as flash_attention.cu feeds P to P V).  y comes out
// transposed (p x t), is scaled by exp(lg_t) by column before product 3
// accumulates onto it, and leaves through stmatrix.trans and one TMA store
// (element by element where P % 8 != 0 rules out a map).  Off the chain:
// products 1 and 2 are in flight while the next chunk's loads are issued
// and G forms (the gate as ex2 of log2(e)-scaled lg, formed only where
// z <= t, whole blocks above the diagonal skipped); products 3 and 4 while
// warp 0 forms the next chunk's lg, exp(lg) and w and y is stored.
//
// The split contract.  The references multiply G, the state and w o x in
// float32; a tensor core takes them in bf16, and a single rounding (8
// significant bits) leaves the gates (tests/test_torch_ssd.py shows it).
// So each goes in as hi = bf16(v) and lo = bf16(v - hi), two products
// summed in float32 (~16 bits), as flash_attention.cu splits P.  x, B and
// C are bf16 inputs and enter exactly.
//
// Budget: shared memory 110,096 bytes a CTA (two 40 KB stages; G hi, G lo
// and y, 8 KB each; dt, lg, exp(lg) and w per stage; the mbarriers; 1 KB
// alignment slack), so two CTAs share an SM and B = 4, H = 64 is one wave
// of 256 CTAs on 132 SMs.  __launch_bounds__(128, 2) lets ptxas use all
// 255 registers a thread: the state (64), its hi/lo fragments (64), C B^T
// (32) and y (32) are live together while G forms.  What bounds it, as
// measured: the chain of each chunk inside one warpgroup, ~3.4 us a chunk
// (PERF.md), not the tensor cores (~1.5 k cycles of wgmma a chunk at the
// peak rate).  The layout is mirrored by kernels/ssd/kernel.py SMEM_BYTES,
// and the launcher refuses a disagreeing count.  A chunk-parallel form
// (chunk states in parallel, a short scan, then the inter-chunk output)
// would give B = 1 (64 CTAs) more of the card; it is left for later.
//
// float32 (ssd_kernel) keeps a CUDA-core kernel: its 2e-3 contract against
// the float32 references cannot go through bf16 or TF32 tensor cores.  One
// CTA of 256 threads owns one (b, h) and walks L in 64-row sub-blocks with
// the state resident in shared memory; per sub-block one pass over S forms
// both C B^T and C state (sharing the loads of C), G replaces C in shared
// memory, then y and the state update, fp32 FMAs throughout.  Its float32
// tiles (115,456 bytes: x, B, C/G and the state) let two CTAs share an SM;
// B's float4 quads are XOR-swizzled by row so the 16 rows that the first
// pass reads together fall in distinct banks.
#include "ssd.cuh"

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
  int route;                // bfloat16 copies: 0 TMA, 1 cp.async
};

namespace {

// ---- float32: the CUDA-core kernel ----------------------------------------

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
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

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

// ---- bfloat16: the Hopper kernel (TMA / cp.async ring, wgmma) --------------

constexpr int kWThreads = 128;           // one warpgroup
constexpr int kStages = 2;               // x, B, C and dt stages in the ring
constexpr int kBox = kTileBytes;         // one 64 x 64 bf16 tile: 8 KB

struct WLayout {          // byte offsets from a 1024-aligned base
  static constexpr int kX = 0;                         // x: rows z, cols p
  static constexpr int kB = kBox;                      // B, C: rows z (t),
  static constexpr int kC = 3 * kBox;                  // s in two tiles
  static constexpr int kStage = 5 * kBox;              // 40 KB
  static constexpr int kGhi = kStages * kStage;        // G hi, lo: rows t,
  static constexpr int kGlo = kGhi + kBox;             // cols z
  static constexpr int kY = kGlo + kBox;               // y: rows t, cols p
  static constexpr int kVec = 4 * kStages * kQ;        // a float per row
  static constexpr int kDt = kY + kBox;                //   and stage: dt;
  static constexpr int kZ = kDt + kVec;                //   (lg log2(e), dt)
  static constexpr int kEl = kZ + 2 * kVec;            //   of row pairs;
  static constexpr int kW = kEl + kVec;                //   exp(lg); w
  static constexpr int kBar = kW + kVec;               // full[]
  static constexpr int kBytes = kBar + 8 * kStages + 1024;  // + slack
};
static_assert(WLayout::kBytes == 110096, "kernel.py SMEM_BYTES[bfloat16]");

// d (64 x 64) (+)= A B: A (64 x 16, bf16 pairs in registers), B (16 x 64)
// K-major in shared memory.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__global__ void __launch_bounds__(kWThreads, 2)
    ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const __grid_constant__ CUtensorMap ty, SsdArgs a) {
  using W = WLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));
  float* const sDt = reinterpret_cast<float*>(sm + W::kDt);   // [stage][64]
  float4* const sZ = reinterpret_cast<float4*>(sm + W::kZ);   // [stage][32]
  float2* const sEl = reinterpret_cast<float2*>(sm + W::kEl);
  float2* const sW = reinterpret_cast<float2*>(sm + W::kW);
  const uint32_t full = base + W::kBar;  // + 8 s: stage s's TMA has landed

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int g = h / (a.heads / a.groups);
  const int L = a.length, P = a.head_dim, S = a.state_dim;
  const int n_chunks = (L + kQ - 1) / kQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = lane % 4;
  const bool y_tma = P % 8 == 0;
  const int r0 = 16 * warp + lane / 4;   // accumulator rows r0 and r0 + 8
  const float A = a.a[h];
  const float* const dtp = a.dt + b * a.dt_sb + h * a.dt_sh;
  const unsigned short* const xp = static_cast<const unsigned short*>(a.x) +
                                   b * a.x_sb + h * a.x_sh;
  const unsigned short* const bp = static_cast<const unsigned short*>(a.b) +
                                   b * a.b_sb + g * a.b_sg;
  const unsigned short* const cp = static_cast<const unsigned short*>(a.c) +
                                   b * a.c_sb + g * a.c_sg;

  // Put chunk i's x, B, C and dt in flight into stage i % 2: TMA (thread 0,
  // completion on the stage's mbarrier) or cp.async (every thread, waited
  // for with cp.async.wait_all); dt by cp.async from warp 0.
  auto fetch = [&](int i) {
    const int s = i % kStages, t0 = i * kQ, rows = min(kQ, L - t0);
    uint8_t* const st = sm + s * W::kStage;
    if (a.route == 0) {
      if (tid == 0) {
        const uint32_t sa = base + s * W::kStage, bar = full + 8 * s;
        mbar_expect_tx(bar, W::kStage);
        tma_load(sa + W::kX, &tx, bar, 0, h, t0, b);
        for (int k = 0; k < 2; ++k) {
          tma_load(sa + W::kB + k * kBox, &tb, bar, 64 * k, g, t0, b);
          tma_load(sa + W::kC + k * kBox, &tc, bar, 64 * k, g, t0, b);
        }
      }
    } else {
      fetch_tile<kWThreads>(st + W::kX, xp + t0 * a.x_sl, a.x_sl, rows, P);
      for (int k = 0; k < 2; ++k) {
        fetch_tile<kWThreads>(st + W::kB + k * kBox,
                              bp + t0 * a.b_sl + 64 * k, a.b_sl, rows,
                              S - 64 * k);
        fetch_tile<kWThreads>(st + W::kC + k * kBox,
                              cp + t0 * a.c_sl + 64 * k, a.c_sl, rows,
                              S - 64 * k);
      }
    }
    if (warp == 0)
      for (int r = lane; r < kQ; r += 32) {
        float* const d = sDt + s * kQ + r;
        if (r < rows) cp_async4(d, dtp + (long long)(t0 + r) * a.dt_sl);
        else *d = 0.0f;
      }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // warp 0, once chunk i's dt has landed: lg = a cumsum(dt) over the chunk
  // (lane l owns rows 2l, 2l + 1), exp(lg) and the update's weights
  // w = exp(lg_end - lg) dt, into stage i % 2's vectors
  auto decays = [&](int i) {
    const int s = i % kStages;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    const float d0 = sDt[s * kQ + 2 * lane], d1 = sDt[s * kQ + 2 * lane + 1];
    float run = d0 + d1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, run, o);
      if (lane >= o) run += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) excl = 0.0f;
    const float c0 = excl + d0, c1 = c0 + d1;
    const float lg0 = A * c0, lg1 = A * c1;
    const float lend = __shfl_sync(0xffffffffu, lg1, 31);
    sZ[s * kQ / 2 + lane] = make_float4(lg0 * kLog2e, lg1 * kLog2e, d0, d1);
    sEl[s * kQ / 2 + lane] = make_float2(expf(lg0), expf(lg1));
    sW[s * kQ / 2 + lane] = make_float2(expf(lend - lg0) * d0,
                                        expf(lend - lg1) * d1);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the G tiles start at zero: a block of columns z > t of all a warp's
  // rows is never written, so it stays so
  for (int o = 16 * tid; o < 2 * kBox; o += 16 * kWThreads)
    *reinterpret_cast<uint4*>(sm + W::kGhi + o) = make_uint4(0, 0, 0, 0);
  if (n_chunks > 0) {
    fetch(0);
    if (warp == 0) decays(0);
  }

  // K-major tiles: 16-element k-step kk is 32 bytes into tile kk / 4, 8-row
  // groups 1024 bytes apart.  The B tile read MN-major for product 4: 16
  // rows (k) are 2048 bytes, its two 64-column tiles kBox apart.
  auto kmajor = [&](uint32_t tile, int kk) {
    return wgmma_desc(tile + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
  };

  // the state, transposed: element e is (p, s) = (r0 + 8 ((e / 2) % 2),
  // 8 (e / 4) + 2 q + e % 2), as every accumulator below (row, column)
  float st[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) st[e] = 0.0f;

  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages, t0 = i * kQ, rows = min(kQ, L - t0);
    const uint32_t sa = base + s * W::kStage;
    // row pair k = rows 2k, 2k + 1: (lg log2(e), lg log2(e), dt, dt)
    const float4* const zv = sZ + s * kQ / 2;
    const float2* const el = sEl + s * kQ / 2;       // exp(lg)
    const float2* const w = sW + s * kQ / 2;         // exp(lg_end - lg) dt
    if (a.route == 0) mbar_wait(full + 8 * s, (i / kStages) & 1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    fence_async_shared();                // the copies, to wgmma's proxy
    __syncthreads();   // stage s landed, its decays formed; chunk i - 1 done

    // the state's bf16 hi and lo as the A fragments of product 2 (the
    // accumulator layout of 16 columns is the fragment layout of a k-step)
    uint32_t shi[8][4], slo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1], shi[kk][r],
                   slo[kk][r]);

    // 1. C B^T (rows t, columns z) and 2. y^T = state^T C^T (rows p,
    //    columns t), in flight while the next chunk's loads are issued and
    //    G forms
    float cb[32], acc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64(cb, kmajor(sa + W::kC, kk), kmajor(sa + W::kB, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs64(acc, shi[kk], kmajor(sa + W::kC, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs64(acc, slo[kk], kmajor(sa + W::kC, kk), 1);
    wgmma_commit();
    if (i + 1 < n_chunks) fetch(i + 1);

    // G = C B^T o exp(lg_t - lg_z) o dt_z for z <= t, into the G tiles as
    // bf16 hi and lo (rows t, columns z: K-major B operand of product 3)
    wgmma_wait<1>();
    fence_regs(cb);
    const float lt[2] = {r0 % 2 ? zv[r0 / 2].y : zv[r0 / 2].x,
                         r0 % 2 ? zv[r0 / 2 + 4].y : zv[r0 / 2 + 4].x};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j > 16 * warp + 15) continue;  // z > t in all the warp's rows
      const float4 f = zv[4 * j + q];        // columns z = 8 j + 2 q, + 1
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = r0 + 8 * half, z = 8 * j + 2 * q;
        const float g0 = z <= t
            ? cb[4 * j + 2 * half] * ex2(lt[half] - f.x) * f.z : 0.0f;
        const float g1 = z + 1 <= t
            ? cb[4 * j + 2 * half + 1] * ex2(lt[half] - f.y) * f.w : 0.0f;
        uint32_t hi, lo;
        split_pair(g0, g1, hi, lo);
        *reinterpret_cast<uint32_t*>(sm + W::kGhi + swz(t, z)) = hi;
        *reinterpret_cast<uint32_t*>(sm + W::kGlo + swz(t, z)) = lo;
      }
    }
    fence_async_shared();

    // y^T scaled by exp(lg_t) by column
    wgmma_wait();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 e2 = el[4 * j + q];       // columns t = 8 j + 2 q, + 1
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= e % 2 ? e2.y : e2.x;
    }

    // x^T's A fragments (rows p, k-step kk: z = 16 kk + 2q + {0, 1} and
    // + 8), transposed out of the swizzled x tile 8 x 8 at a time (matrix
    // m: z from 16 kk + 8 (m / 2), p from 16 warp + 8 (m % 2)), and
    // (w o x)^T's split hi + lo
    uint32_t xf[4][4], whi[4][4], wlo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int m = lane / 8;
      ldmatrix_t(sa + W::kX + swz(16 * kk + 8 * (m / 2) + lane % 8,
                                  16 * warp + 8 * (m % 2)), xf[kk]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 wz = w[8 * kk + q + 4 * (r / 2)];  // z, z + 1
        split_pair(bf16_lo(xf[kk][r]) * wz.x, bf16_hi(xf[kk][r]) * wz.y,
                   whi[kk][r], wlo[kk][r]);
      }
    }
    const float decay = el[kQ / 2 - 1].y;
#pragma unroll
    for (int e = 0; e < 64; ++e) st[e] *= decay;
    if (tid == 0 && y_tma)      // the last y store has read its tile
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();   // every thread's G is in shared memory

    // 3. y^T += x^T G^T (hi, then lo); 4. state^T += (w o x)^T B, in
    //    flight while warp 0 forms the next chunk's decays and y is stored
    const uint64_t db = wgmma_desc(sa + W::kB, kBox, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64(acc, xf[kk], kmajor(base + W::kGhi, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64(acc, xf[kk], kmajor(base + W::kGlo, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(st, whi[kk], db + kk * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(st, wlo[kk], db + kk * 128);
    wgmma_commit();
    if (warp == 0 && i + 1 < n_chunks) decays(i + 1);
    wgmma_wait<1>();
    fence_regs(acc);

    // y: transposed into the y tile as rows t, columns p (bf16), then
    // stored by one TMA (rows t < rows, columns p < P: the map's bounds) or,
    // where P % 8 != 0 rules a map out, element by element
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = lane / 8, t = 8 * (2 * m + j / 2) + lane % 8;
      stmatrix_t(base + W::kY + swz(t, 16 * warp + 8 * (j % 2)),
                 bf16_pair(acc[8 * m], acc[8 * m + 1]),
                 bf16_pair(acc[8 * m + 2], acc[8 * m + 3]),
                 bf16_pair(acc[8 * m + 4], acc[8 * m + 5]),
                 bf16_pair(acc[8 * m + 6], acc[8 * m + 7]));
    }
    fence_async_shared();
    __syncthreads();
    if (y_tma) {
      if (tid == 0) tma_store(&ty, base + W::kY, 0, h, t0, b);
    } else {
      const long long y_sl = (long long)a.heads * P;
      uint16_t* const yp = static_cast<uint16_t*>(a.y) +
                           ((long long)b * L + t0) * y_sl + (long long)h * P;
      for (int c = tid; c < kQ * kQ; c += kWThreads) {
        const int t = c / kQ, p = c % kQ;
        if (t < rows && p < P)
          yp[t * y_sl + p] =
              *reinterpret_cast<const uint16_t*>(sm + W::kY + swz(t, p));
      }
    }
    wgmma_wait();
    fence_regs(st);
  }

  if (tid == 0 && y_tma)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  float* const out = a.state + ((long long)b * a.heads + h) * S * P;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int p = r0 + 8 * ((e / 2) % 2), sc = 8 * (e / 4) + 2 * q + e % 2;
    if (sc < S && p < P) out[sc * P + p] = st[e];
  }
}

cudaError_t prepare_bf16() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WLayout::kBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_wgmma_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

int launch_bf16(const SsdArgs& a, cudaStream_t stream) {
  // 4-D maps over x (P, H, L, B) and B, C (S, G, L, B) in their own
  // strides (the copy route leaves them unused), and over the contiguous y
  // (P, H, L, B) where its strides are whole 16 bytes (P % 8 == 0)
  CUtensorMap tx{}, tb{}, tc{}, ty{};
  const int rows = a.length > 0 ? a.length : 1;   // a map needs a row
  const long long y_row = 2LL * a.head_dim;      // bytes of one (t, h)
  if (a.head_dim % 8 == 0 &&
      !encode_bf16_4d(&ty, a.y, a.head_dim, a.heads, rows, a.batch, y_row,
                      y_row * a.heads, y_row * a.heads * rows, kQ))
    return (int)cudaErrorInvalidValue;
  if (a.route == 0 &&
      (!encode_bf16_4d(&tx, a.x, a.head_dim, a.heads, rows, a.batch,
                       2 * a.x_sh, 2 * a.x_sl, 2 * a.x_sb, kQ) ||
       !encode_bf16_4d(&tb, a.b, a.state_dim, a.groups, rows, a.batch,
                       2 * a.b_sg, 2 * a.b_sl, 2 * a.b_sb, kQ) ||
       !encode_bf16_4d(&tc, a.c, a.state_dim, a.groups, rows, a.batch,
                       2 * a.c_sg, 2 * a.c_sl, 2 * a.c_sb, kQ)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare_bf16();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.batch * a.heads;
  ssd_wgmma_kernel<<<(unsigned)blocks, kWThreads, WLayout::kBytes, stream>>>(
      tx, tb, tc, ty, a);
  return (int)cudaGetLastError();
}

}  // namespace

// expected_smem: the wrapper's count for the dtype (kernel.py SMEM_BYTES);
// a mismatch means the two layouts disagree, and the launch is refused.
extern "C" int ssd_scan(const SsdArgs* a, size_t expected_smem,
                        cudaStream_t stream) {
  if (a->dtype != 0 && a->dtype != 1) return (int)cudaErrorInvalidValue;
  const size_t smem = a->dtype == 1 ? (size_t)WLayout::kBytes
                                    : (size_t)kSmemBytes;
  if (expected_smem != smem) return (int)cudaErrorInvalidValue;
  if (a->batch < 1 || a->heads < 1) return (int)cudaSuccess;
  if (a->length < 0 || a->groups < 1 || a->heads % a->groups != 0 ||
      a->head_dim < 1 || a->head_dim > kP || a->state_dim < 4 ||
      a->state_dim > kS || a->state_dim % 4 != 0 ||
      (a->dtype == 1 && a->route != 0 && a->route != 1))
    return (int)cudaErrorInvalidValue;
  return a->dtype == 1 ? launch_bf16(*a, stream) : launch<float>(*a, stream);
}

// CTAs of the dtype's kernel one SM holds at once, for the report.
extern "C" int ssd_blocks_per_sm(int dtype, int* out) {
  cudaError_t err;
  if (dtype == 1) {
    err = prepare_bf16();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, ssd_wgmma_kernel, kWThreads, WLayout::kBytes);
  } else {
    err = prepare<float>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, ssd_kernel<float>, kThreads, kSmemBytes);
  }
  return (int)err;
}
