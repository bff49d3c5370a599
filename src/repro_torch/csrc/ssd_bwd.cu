// The backward of the Mamba2 SSD scan (#8's gradient).
//
//   ssd_scan_bwd  the gradient of src/repro/kernels/ssd/kernel.py:65
//                 ssd_pallas's port (csrc/ssd.cu).  The JAX package trains
//                 through its XLA chunked scan (ssd_impl="xla",
//                 src/repro/launch/steps.py:30,42 reaching ssd_chunked_ref,
//                 src/repro/kernels/ssd/ref.py:50) and differentiates it with
//                 autodiff; this writes that gradient out by hand.
//
// What it computes: for x (B, L, H, P), dt (B, L, H), a (H,), B and C
// (B, L, G, S) (head h reads group h / (H / G)), the output gradient dy
// (B, L, H, P) and the final state's gradient dstate (B, H, S, P) float32
// or null (zero): dx (B, L, H, P), ddt (B, L, H) float32, da (H,) float32,
// dB and dC (B, L, G, S), of y and the final state of the scan from a zero
// state, in its chunked form (64-row chunks; the chunk does not change the
// function).  x, B, C and dy are float32 or bfloat16 (one dtype), read in
// that layout through their strides (the last dim contiguous); dx, dB and
// dC come back contiguous in that dtype, each a float32 sum rounded once.
// Any L: rows at or beyond L read zeros and dt = 0 (exact no-ops, as the
// forward pads) and are not stored.  kernels/ssd/ref.py
// ssd_scan_bwd_plain is the same function.  Per (chunk, head), with
// lg = a cumsum(dt), w = exp(lg_last - lg) dt, S_in the state entering the
// chunk and dS_out the gradient of the state leaving it:
//   G   = C B^T o exp(lg_t - lg_z) o dt_z,  dG' = dy x^T o exp(..) o dt_z,
//   N   = dy x^T o C B^T o exp(..)       (all for z <= t, else 0);
//   dx  = G^T dy + w o (B dS_out);
//   dC  = exp(lg) o (dy S_in^T) + dG' B;   dB = w o (x dS_out^T) + dG'^T C;
//   d(lg) from N's row and column sums, dy_t . (C_t S_in), B_z . (dS_out
//   x_z) and <S_in, dS_out>; its reverse cumsum into ddt, times cumsum(dt)
//   into da; a group's heads add into its dB and dC.
// The carries: S_in(i + 1) = exp(lg_last) S_in(i) + B^T (w o x) forward
// from zero, dS_out(i - 1) = exp(lg_last) dS_out(i) + (exp(lg) o C)^T dy in
// reverse from dstate.  Every launch is free of atomics and adds every sum
// in a fixed order, so a second call gives the same bits.
//
// What bounds it on an H100.  At mamba2-1.3b's training shape (B = 1 row,
// L = 4096, H = 64, P = 64, S = 128, G = 1) each (chunk of q = 64 rows,
// head) takes q(q+1)(3S + 2P) FLOP for the causal triangles of C B^T,
// dy x^T, G^T dy, dG' B and dG'^T C, and 10 q S P for the five products
// with a chunk state: ~30 GFLOP a call, 0.031 ms at the bf16 tensor-core
// peak and 0.45 ms at the 67 TFLOP/s of the CUDA cores, against ~107 MB
// of inputs and outputs, 0.032 ms at 3.35 TB/s.
//
// bfloat16: four Hopper kernels, every product a wgmma with bf16 operands
// and float32 accumulators.  x, dy, B and C enter exactly; each float32
// operand (the carried states, G, dG' and the walks' w o x and
// exp(lg) o dy) goes in as hi = bf16(v) and lo = bf16(v - hi), two
// products summed in float32 (~16 significant bits), as ssd.cu does; a
// row scale of an output (exp(lg) on dy S_in^T, w on B dS_out and on
// x dS_out^T) is applied to the accumulator after its product instead.
//   1. ssd_bwd_walk_kernel, a warpgroup a (direction, batch, head, 64-wide
//      piece of S): the carries with each chunk's contribution folded in.
//      The state, transposed (p x s), lives in a wgmma accumulator; each
//      step stores the state entering (forward) or leaving (reverse) the
//      chunk as bf16 hi and lo tiles [s][p] in the 128-byte swizzle
//      (stmatrix.trans, one bulk store each), scales it by the chunk's
//      decay and accumulates (w o x)^T B (forward) or (exp(lg) o dy)^T C
//      (reverse), its A operand split from registers, B or C read
//      MN-major.  Loads run one chunk ahead (TMA or cp.async).  The split
//      by pieces of S puts 2 B H S/64 CTAs on the card (256 at
//      mamba2-1.3b, 224 at zamba2-7b), where B H alone would leave it
//      half empty.
//   2. ssd_bwd_grad_kernel<S/64>, a CTA a (batch, chunk, slab of a group's
//      heads): B and C once, then each head's x, dy and the two states'
//      hi/lo tiles through a two-stage ring (TMA and bulk copies on an
//      mbarrier, or cp.async), the next head's in flight while one
//      computes.  Two warpgroups, by the rows of their outputs:
//      warpgroup 0 (rows t) forms dy S_in^T -> dC's inter-chunk term and
//      dy_t . (C_t S_in), dy x^T -> dG', and <S_in, dS_out> from the
//      tiles; warpgroup 1 (rows z) forms B C^T (once a slab), x dy^T ->
//      G^T and N's sums, B dS_out -> dx with G^T dy, and x dS_out^T ->
//      dB's inter-chunk term.  dC and dB accumulate over the slab's heads
//      in float32, in head order, in the accumulators, as does dG'
//      (warpgroup 0); at the slab's end its split goes to warpgroup 1
//      through shared memory, so dG' B and dG'^T C run once a slab.  The
//      products with 128 columns of S run as two of 64, so that no
//      thread holds more than dC or dB, dG' and one product.  The slab's
//      dB and dC go out as float32 partials, the rows' d(lg) pieces to
//      scratch.  The slab width minimises waves x heads a CTA
//      (kernels/ssd/kernel.py bwd_plan; the launcher refuses another).
//   3. ssd_bwd_finish_kernel, a warp a (batch, head, chunk): d(lg) from
//      its pieces, its reverse cumsum into ddt, the chunk's share of da.
//   4. ssd_bwd_slab_kernel: the slabs' dB and dC partials summed in slab
//      order and rounded once; da summed over batch and chunks.
// Bytes: the states' hi/lo tiles are written once and read once, 2 x 2 x
// 134 MB at mamba2-1.3b (S = 128: ~0.54 GB, ~0.16 ms at 3.35 TB/s); the
// slabs' partials 2 x 8 MB.  Shared memory: the walk 50,976 bytes; the
// gradient CTA 217,632 at S = 128 (one an SM), 135,712 at S <= 64.
//
// float32 keeps the CUDA-core kernels: its 1e-5 contract cannot go
// through bf16 or TF32 tensor cores.  Four launches:
//   1. ssd_bwd_chunk_kernel, a CTA a (chunk, head, batch): the chunk's
//      state contribution B^T (w o x) and its state-gradient contribution
//      (exp(lg) o C)^T dy, each (S, P) float32 into scratch, and the
//      chunk's decay exp(lg_last);
//   2. ssd_bwd_scan_kernel, a thread an element of (S, P) of a (batch,
//      head): the forward carry over the chunks, replacing each chunk's
//      contribution by the state entering it, then the reverse carry from
//      dstate, replacing each by the state gradient leaving it;
//   3. ssd_bwd_kernel, a CTA a (chunk, head, batch): everything else,
//      local to the chunk given those two states, dB and dC per head into
//      float32 scratch;
//   4. ssd_bwd_reduce_kernel: each group's dB and dC summed over its heads
//      in head order and rounded once; da summed over batch and chunks.
// A CTA of 256 threads holds 4 x 4 (or 4 x 8) outputs a thread, reads each
// operand row or column at an odd row stride, so that every access of a
// warp (16 columns of one or two rows) falls in distinct banks, and
// accumulates with fused multiply-adds.  Shared memory: kernel 3 holds x,
// dy, B, C, S_in, dS_out, G and its gradient (201,536 bytes at S = 128, one
// CTA an SM; 135,488 at S <= 64); kernel 1 x, dy, B, C (100,608 / 67,840).
#include "ssd.cuh"

// Arguments of one call; mirrored by kernels/ssd/kernel.py _SsdBwdArgs.
// Strides are in elements; x, B, C and dy have a contiguous last dim.
struct SsdBwdArgs {
  const void* x;            // (B, L, H, P)
  const float* dt;          // (B, L, H)
  const float* a;           // (H,)
  const void* b;            // (B, L, G, S)
  const void* c;            // (B, L, G, S)
  const void* dy;           // (B, L, H, P)
  const float* dstate;      // (B, H, S, P) contiguous, or null (zero)
  void* dx;                 // (B, L, H, P) out, contiguous
  float* ddt;               // (B, L, H) out, contiguous
  float* da;                // (H,) out
  void* db;                 // (B, L, G, S) out, contiguous
  void* dc;                 // (B, L, G, S) out, contiguous
  // scratch.  float32: S_in and dS_out (B, H, n, S, P), the decays
  // (B, H, n), dB and dC per head (B, L, H, S).  bfloat16: S_in and
  // dS_out as bf16 tiles (B, H, n, hi/lo, S / 64, 64 x 64), no decays,
  // dB and dC per slab (slabs, B, L, G, S).  Both: da per chunk (B, H, n).
  float* states;
  float* dstates;
  float* decay;
  float* dbp;
  float* dcp;
  float* dap;
  float* rowp;              // bfloat16: d(lg)'s pieces (B, H, n, 4, 64)
  float* dotp;              // bfloat16: <S_in, dS_out> (B, H, n)
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl, b_sg, c_sb, c_sl, c_sg;
  long long dy_sb, dy_sl, dy_sh;
  int batch, length, heads, groups, head_dim, state_dim;
  int dtype;                // 0 float32, 1 bfloat16 (x, B, C, dy, dx, dB, dC)
  int slab;                 // bfloat16: heads a gradient CTA (bwd_plan)
  int route;                // bfloat16 copies of x, dy, B, C: 0 TMA, 1 cp.async
};

namespace {

// ---- float32: the CUDA-core kernels ----------------------------------------

constexpr int kQ = 64;                   // rows of a chunk
constexpr int kP = 64;                   // largest head_dim
constexpr int kLd = kQ + 1;              // odd row stride of 64-wide tiles
constexpr int kThreads = 256;            // 16 x 16
constexpr int kScanThreads = 256;

// the (batch, head, chunk) slot of the per-chunk scratch, (B, H, n):
// a (batch, head)'s chunks adjacent, for the carries' walk
__device__ __forceinline__ long long slot(const SsdBwdArgs& a, int b, int h,
                                          int chunk, int n) {
  return ((long long)b * a.heads + h) * n + chunk;
}

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// acc[i][j] += sum_k A(r_i, k) B(k, c_j) with r_i = ty + 16 i and
// c_j = tx + 16 j; A(r, k) = A[r * ar + k * ak], B(k, c) = Bm[k * bk + c * bc].
// Every stride is 1 or odd, so a warp's loads (two rows, 16 columns) fall
// in distinct banks or broadcast.
template <int I, int J>
__device__ __forceinline__ void mm(float (&acc)[I][J], const float* A,
                                   int ar, int ak, const float* Bm, int bk,
                                   int bc, int K, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[I], bv[J];
#pragma unroll
    for (int i = 0; i < I; ++i) av[i] = A[(ty + 16 * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = Bm[k * bk + (tx + 16 * j) * bc];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j)
        acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  }
}

template <int I, int J>
__device__ __forceinline__ void zero(float (&acc)[I][J]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.0f;
}

// rows x cols of a (row, col) tensor at row stride rs into a tile of
// `tile_cols` columns at row stride ld, zero past `rows` and `cols`.  A
// thread takes elements threadIdx.x + k blockDim.x, and issues kLoads of
// them before it stores any, so that their latencies overlap.
constexpr int kLoads = 8;

template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, long long rs,
                          int rows, int cols, int tile_rows, int tile_cols) {
  const int n = tile_rows * tile_cols;
  for (int e0 = threadIdx.x; e0 < n; e0 += kLoads * blockDim.x) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x, r = e / tile_cols;
      const int k = e % tile_cols;
      v[u] = (e < n && r < rows && k < cols) ? to_f(src[r * rs + k]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n) dst[(e / tile_cols) * ld + e % tile_cols] = v[u];
    }
  }
}

// The chunk's rows of x, dy, B, C and dt into shared memory, and per row
// cumsum(dt), lg = a cumsum(dt), exp(lg) and w = exp(lg_last - lg) dt.
template <typename T>
__device__ void load_chunk(const SsdBwdArgs& a, int b, int h, int chunk,
                           int sp, int lds, float* sX, float* sDy, float* sB,
                           float* sC, float* sDt, float* sCs, float* sLg,
                           float* sEl, float* sW) {
  const int l0 = chunk * kQ;
  const int rows = min(kQ, a.length - l0);
  const int g = h / (a.heads / a.groups);
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + l0 * a.x_sl +
               h * a.x_sh;
  const T* dy = static_cast<const T*>(a.dy) + b * a.dy_sb + l0 * a.dy_sl +
                h * a.dy_sh;
  const T* bm = static_cast<const T*>(a.b) + b * a.b_sb + l0 * a.b_sl +
                g * a.b_sg;
  const T* cm = static_cast<const T*>(a.c) + b * a.c_sb + l0 * a.c_sl +
                g * a.c_sg;
  load_tile(sX, kLd, x, a.x_sl, rows, a.head_dim, kQ, kP);
  load_tile(sDy, kLd, dy, a.dy_sl, rows, a.head_dim, kQ, kP);
  load_tile(sB, lds, bm, a.b_sl, rows, a.state_dim, kQ, sp);
  load_tile(sC, lds, cm, a.c_sl, rows, a.state_dim, kQ, sp);
  if (threadIdx.x < kQ) {
    const int t = threadIdx.x;
    sDt[t] = t < rows
                 ? a.dt[b * a.dt_sb + (l0 + t) * a.dt_sl + h * a.dt_sh]
                 : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {               // the cumsum in row order
    const float ah = a.a[h];
    float run = 0.0f;
    for (int t = 0; t < kQ; ++t) {
      run += sDt[t];
      sCs[t] = run;
      sLg[t] = ah * run;
    }
  }
  __syncthreads();
  if (threadIdx.x < kQ) {
    const int t = threadIdx.x;
    sEl[t] = expf(sLg[t]);
    sW[t] = expf(sLg[kQ - 1] - sLg[t]) * sDt[t];
  }
  __syncthreads();
}

// ---- 1. each chunk's contributions to the state and its gradient ---------

template <int NJS>
constexpr int chunk_smem_floats() {
  return 2 * kQ * kLd + 2 * kQ * (16 * NJS + 1) + 5 * kQ;
}

template <typename T, int NJS>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(SsdBwdArgs a) {
  constexpr int SP = 16 * NJS, LDS = SP + 1;
  extern __shared__ float smem[];
  float* sX = smem;
  float* sDy = sX + kQ * kLd;
  float* sB = sDy + kQ * kLd;
  float* sC = sB + kQ * LDS;
  float* sDt = sC + kQ * LDS;
  float* sCs = sDt + kQ;
  float* sLg = sCs + kQ;
  float* sEl = sLg + kQ;
  float* sW = sEl + kQ;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = (a.length + kQ - 1) / kQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_chunk<T>(a, b, h, chunk, SP, LDS, sX, sDy, sB, sC, sDt, sCs, sLg, sEl,
                sW);
  // B rows scaled by w, C rows by exp(lg)
  for (int e = tid; e < kQ * SP; e += kThreads) {
    const int r = e / SP, k = e % SP;
    sB[r * LDS + k] *= sW[r];
    sC[r * LDS + k] *= sEl[r];
  }
  __syncthreads();
  const long long at = slot(a, b, h, chunk, n);
  const long long base = at * a.state_dim * a.head_dim;
  // (S, P) outputs: rows s = ty + 16 i, columns p = tx + 16 j
  for (int which = 0; which < 2; ++which) {
    float acc[NJS][4];
    zero(acc);
    // state:  sum_z (w_z B_z)[s] x_z[p];  gradient: sum_t (el_t C_t)[s] dy_t[p]
    mm(acc, which ? sC : sB, 1, LDS, which ? sDy : sX, kLd, 1, kQ, ty, tx);
    float* out = (which ? a.dstates : a.states) + base;
#pragma unroll
    for (int i = 0; i < NJS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = ty + 16 * i, p = tx + 16 * j;
        if (s < a.state_dim && p < a.head_dim)
          out[s * a.head_dim + p] = acc[i][j];
      }
  }
  if (tid == 0) a.decay[at] = sEl[kQ - 1];
}

// ---- 2. the carries across chunks ----------------------------------------

__global__ void __launch_bounds__(kScanThreads)
ssd_bwd_scan_kernel(SsdBwdArgs a) {
  const int sp = a.state_dim * a.head_dim;
  const int e = blockIdx.x * kScanThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= sp) return;
  const int n = (a.length + kQ - 1) / kQ;
  const long long at = slot(a, b, h, 0, n);
  const float* __restrict__ dec = a.decay + at;
  // each chunk's element e, a chunk's (S, P) apart; the next chunk's is
  // loaded before this one's is replaced
  float* __restrict__ fwd = a.states + at * sp + e;
  float* __restrict__ rev = a.dstates + at * sp + e;
  float st = 0.0f, next = fwd[0];
  for (int i = 0; i < n; ++i) {          // S_in of chunk i
    const float contrib = next;
    if (i + 1 < n) next = fwd[(long long)(i + 1) * sp];
    fwd[(long long)i * sp] = st;
    st = dec[i] * st + contrib;
  }
  float ds = a.dstate ? a.dstate[((long long)b * a.heads + h) * sp + e]
                      : 0.0f;
  next = rev[(long long)(n - 1) * sp];
  for (int i = n - 1; i >= 0; --i) {     // dS_out of chunk i
    const float contrib = next;
    if (i > 0) next = rev[(long long)(i - 1) * sp];
    rev[(long long)i * sp] = ds;
    ds = dec[i] * ds + contrib;
  }
}

// ---- 3. the chunk's gradients --------------------------------------------

template <int NJS>
constexpr int bwd_smem_floats() {
  return 4 * kQ * kLd + 2 * kQ * (16 * NJS + 1) + 2 * (16 * NJS) * kLd +
         9 * kQ + 16;
}

// the sum of v over the 16 lanes of one thread row (tx = 0..15), in a fixed
// order (a butterfly)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <typename T, int NJS>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(SsdBwdArgs a) {
  constexpr int SP = 16 * NJS, LDS = SP + 1;
  extern __shared__ float smem[];
  float* sX = smem;
  float* sDy = sX + kQ * kLd;
  float* sG = sDy + kQ * kLd;            // G [t][z]
  float* sD = sG + kQ * kLd;             // dG' [t][z]
  float* sB = sD + kQ * kLd;
  float* sC = sB + kQ * LDS;
  float* sIn = sC + kQ * LDS;            // S_in [s][p]; first N [t][z]
  float* sOut = sIn + SP * kLd;          // dS_out [s][p]
  float* sDt = sOut + SP * kLd;
  float* sCs = sDt + kQ;
  float* sLg = sCs + kQ;
  float* sEl = sLg + kQ;
  float* sW = sEl + kQ;
  float* sRowM = sW + kQ;                // sum_z N_tz dt_z
  float* sColN = sRowM + kQ;             // sum_t N_tz
  float* sDlgI = sColN + kQ;             // dy_t . y_inter_t
  float* sDw = sDlgI + kQ;               // B_z . dS_out x_z
  float* sRed = sDw + kQ;                // 8 warps' partials, the dot
  float* sN = sIn;

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = (a.length + kQ - 1) / kQ;
  const int l0 = chunk * kQ, rows = min(kQ, a.length - l0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_chunk<T>(a, b, h, chunk, SP, LDS, sX, sDy, sB, sC, sDt, sCs, sLg, sEl,
                sW);

  // C B^T and dy x^T, then G, dG' and N = dG o C B^T o decay (z <= t)
  {
    float cb[4][4], dg[4][4];
    zero(cb);
    zero(dg);
    mm(cb, sC, LDS, 1, sB, 1, LDS, SP, ty, tx);
    mm(dg, sDy, kLd, 1, sX, 1, kLd, kQ, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, z = tx + 16 * j;
        float gv = 0.0f, dv = 0.0f, nv = 0.0f;
        if (z <= t) {
          const float dec = expf(sLg[t] - sLg[z]);
          gv = cb[i][j] * dec * sDt[z];
          nv = dg[i][j] * cb[i][j] * dec;
          dv = dg[i][j] * dec * sDt[z];
        }
        sG[t * kLd + z] = gv;
        sD[t * kLd + z] = dv;
        sN[t * kLd + z] = nv;
      }
  }
  __syncthreads();
  if (tid < kQ) {                        // column sums of N, t ascending
    const int z = tid;
    float s = 0.0f;
    for (int t = z; t < kQ; ++t) s += sN[t * kLd + z];
    sColN[z] = s;
  } else if (tid < 2 * kQ) {             // row sums of N o dt_z, z ascending
    const int t = tid - kQ;
    float s = 0.0f;
    for (int z = 0; z <= t; ++z) s += sN[t * kLd + z] * sDt[z];
    sRowM[t] = s;
  }
  __syncthreads();

  // S_in and dS_out (over N), and <S_in, dS_out>
  const long long at = slot(a, b, h, chunk, n);
  const int sp_n = a.state_dim * a.head_dim;
  {
    load_tile(sIn, kLd, a.states + at * sp_n, a.head_dim, a.state_dim,
              a.head_dim, SP, kP);
    load_tile(sOut, kLd, a.dstates + at * sp_n, a.head_dim, a.state_dim,
              a.head_dim, SP, kP);
    float dot = 0.0f;                    // the elements this thread stored
    for (int e = tid; e < SP * kP; e += kThreads) {
      const int o = (e / kP) * kLd + e % kP;
      dot = __fmaf_rn(sIn[o], sOut[o], dot);
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, m);
    if (tid % 32 == 0) sRed[tid / 32] = dot;
  }
  __syncthreads();

  // dx = G^T dy + w o (B dS_out)
  {
    float acc[4][4], st[4][4];
    zero(acc);
    zero(st);
    mm(acc, sG, 1, kLd, sDy, kLd, 1, kQ, ty, tx);
    mm(st, sB, LDS, 1, sOut, kLd, 1, SP, ty, tx);
    T* dx = static_cast<T*>(a.dx) +
            (((long long)b * a.length + l0) * a.heads + h) * a.head_dim;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int z = ty + 16 * i, p = tx + 16 * j;
        if (z < rows && p < a.head_dim)
          dx[(long long)z * a.heads * a.head_dim + p] =
              from_f<T>(acc[i][j] + sW[z] * st[i][j]);
      }
  }
  // dC = exp(lg) o (dy S_in^T) + dG' B, and dy_t . y_inter_t
  {
    float acc[4][NJS];
    zero(acc);
    mm(acc, sDy, kLd, 1, sIn, 1, kLd, kP, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < NJS; ++j)
        part = __fmaf_rn(sC[t * LDS + tx + 16 * j], acc[i][j], part);
      part = row_sum16(part);
      if (tx == 0) sDlgI[t] = sEl[t] * part;
#pragma unroll
      for (int j = 0; j < NJS; ++j) acc[i][j] *= sEl[t];
    }
    mm(acc, sD, kLd, 1, sB, LDS, 1, kQ, ty, tx);
    float* dcp = a.dcp + (((long long)b * a.length + l0) * a.heads + h) *
                             a.state_dim;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        if (t < rows && s < a.state_dim)
          dcp[(long long)t * a.heads * a.state_dim + s] = acc[i][j];
      }
  }
  // dB = w o (x dS_out^T) + dG'^T C, and B_z . dS_out x_z
  {
    float acc[4][NJS];
    zero(acc);
    mm(acc, sX, kLd, 1, sOut, 1, kLd, kP, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int z = ty + 16 * i;
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < NJS; ++j)
        part = __fmaf_rn(sB[z * LDS + tx + 16 * j], acc[i][j], part);
      part = row_sum16(part);
      if (tx == 0) sDw[z] = part;
#pragma unroll
      for (int j = 0; j < NJS; ++j) acc[i][j] *= sW[z];
    }
    mm(acc, sD, 1, kLd, sC, LDS, 1, kQ, ty, tx);
    float* dbp = a.dbp + (((long long)b * a.length + l0) * a.heads + h) *
                             a.state_dim;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        const int z = ty + 16 * i, s = tx + 16 * j;
        if (z < rows && s < a.state_dim)
          dbp[(long long)z * a.heads * a.state_dim + s] = acc[i][j];
      }
  }
  __syncthreads();

  // d(lg), its reverse cumsum into ddt, and the chunk's share of da
  if (tid == 0) {
    float dot = 0.0f;
    for (int k = 0; k < kThreads / 32; ++k) dot += sRed[k];
    float dww = 0.0f;
    for (int t = 0; t < kQ; ++t) {
      const float m = sDw[t] * sW[t];
      dww += m;
      // d(lg_t): the decays into row t less those out of column t, the
      // inter-chunk term, the state's
      sRowM[t] = sRowM[t] - sDt[t] * sColN[t] + sDlgI[t] - m;
    }
    sRowM[kQ - 1] += dww + sEl[kQ - 1] * dot;
    float run = 0.0f, dap = 0.0f;
    const float ah = a.a[h];
    for (int t = kQ - 1; t >= 0; --t) {
      run += sRowM[t];
      dap += sRowM[t] * sCs[t];
      sDlgI[t] = ah * run;               // a * reverse cumsum of d(lg)
    }
    a.dap[at] = dap;
  }
  __syncthreads();
  if (tid < rows) {
    const int z = tid;
    const float v = sColN[z] + sDw[z] * expf(sLg[kQ - 1] - sLg[z]) +
                    sDlgI[z];
    a.ddt[((long long)b * a.length + l0 + z) * a.heads + h] = v;
  }
}

// ---- 4. the heads of a group summed; da over batch and chunks ------------

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
ssd_bwd_reduce_kernel(SsdBwdArgs a) {
  const int per = a.heads / a.groups;
  const long long total = (long long)a.batch * a.length * a.groups *
                          a.state_dim;
  for (long long e = (long long)blockIdx.x * kScanThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kScanThreads) {
    const int s = e % a.state_dim;
    const long long r = e / a.state_dim;
    const int g = r % a.groups;
    const long long bl = r / a.groups;            // b * L + l
    const long long src = (bl * a.heads + (long long)g * per) * a.state_dim +
                          s;
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < per; ++k) {
      sb += a.dbp[src + (long long)k * a.state_dim];
      sc += a.dcp[src + (long long)k * a.state_dim];
    }
    static_cast<T*>(a.db)[e] = from_f<T>(sb);
    static_cast<T*>(a.dc)[e] = from_f<T>(sc);
  }
  if (blockIdx.x == 0) {
    const int n = (a.length + kQ - 1) / kQ;
    for (int h = threadIdx.x; h < a.heads; h += kScanThreads) {
      float s = 0.0f;
      for (int b = 0; b < a.batch; ++b)
        for (int i = 0; i < n; ++i) s += a.dap[slot(a, b, h, i, n)];
      a.da[h] = s;
    }
  }
}

template <typename T, int NJS>
cudaError_t launch(const SsdBwdArgs& a, cudaStream_t stream) {
  const int n = (a.length + kQ - 1) / kQ;
  const int cbytes = chunk_smem_floats<NJS>() * (int)sizeof(float);
  const int bbytes = bwd_smem_floats<NJS>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel<T, NJS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, cbytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_kernel<T, NJS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bbytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n, a.heads, a.batch);
  ssd_bwd_chunk_kernel<T, NJS><<<grid, kThreads, cbytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int sp = a.state_dim * a.head_dim;
  const dim3 sgrid((sp + kScanThreads - 1) / kScanThreads, a.heads, a.batch);
  ssd_bwd_scan_kernel<<<sgrid, kScanThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<T, NJS><<<grid, kThreads, bbytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)a.batch * a.length * a.groups *
                          a.state_dim;
  long long blocks = (total + kScanThreads - 1) / kScanThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  ssd_bwd_reduce_kernel<T><<<(int)blocks, kScanThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

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


// ---- bfloat16: the Hopper kernels ------------------------------------------

constexpr int kWT = 128;                 // one warpgroup
constexpr int kGT = 2 * kWT;             // the gradient CTA: two
constexpr int kBox = kTileBytes;         // one 64 x 64 bf16 tile: 8 KB

// K-major operand tile(s) (rows M or N, 64-element rows of K): k-step kk is
// 32 bytes into tile kk / 4, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return wgmma_desc(tile + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
}
// An opaque copy of v: what is formed from it is formed after this point,
// not hoisted out of a loop and kept live across it (where it would hold
// registers the accumulators need).
template <typename T>
__device__ __forceinline__ T opaque(T v) {
  if constexpr (sizeof(T) == 8) asm volatile("" : "+l"(v));
  else asm volatile("" : "+r"(v));
  return v;
}

// MN-major B tile(s) (rows K, 64-element rows of N, further 64 columns a
// tile on): k-step kk is 16 rows (2048 bytes, 128 in the descriptor) on
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile) {
  return wgmma_desc(tile, kBox, 1024);
}

// d (64 x 64) (+)= A B: A (64 x 16) K-major and B (16 x 64) MN-major, both
// in shared memory.  `acc` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64_tb(float (&d)[32], uint64_t da,
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_F32 : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64 NS) += A B: A (64 x 16) and B (16 x 64 NS) both MN-major in
// shared memory (A's rows, B's columns contiguous)
template <int NS>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32 * NS],
                                            uint64_t da, uint64_t db) {
  if constexpr (NS == 1)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : WG_F32 : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
        "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : WG_F64 : "l"(da), "l"(db), "r"(1));
}

// the accumulator's element e: (row, column) = (r0 + 8 ((e / 2) % 2),
// 8 (e / 4) + 2 q + e % 2), r0 = 16 warp + lane / 4, q = lane % 4
__device__ __forceinline__ int acc_row(int r0, int e) {
  return r0 + 8 * ((e / 2) % 2);
}
__device__ __forceinline__ int acc_col(int q, int e) {
  return 8 * (e / 4) + 2 * q + e % 2;
}

// The 32 accumulator values of a 64 x 64 product as the A fragments of
// the next (its columns are the next one's k), split hi + lo.
__device__ __forceinline__ void split_frags(const float (&v)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair(v[8 * kk + 2 * r], v[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// lane l of a warp: rows 2l and 2l + 1 of a chunk of dt (d0, d1 in, zero
// past L): their cumsum c0, c1, lg = a cumsum (lg0, lg1) and the chunk's
// last lg
struct RowPair {
  float c0, c1, lg0, lg1, lend;
};
__device__ __forceinline__ RowPair cumsum_pair(float d0, float d1, float A,
                                               int lane) {
  float run = d0 + d1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, run, o);
    if (lane >= o) run += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) excl = 0.0f;
  RowPair r;
  r.c0 = excl + d0;
  r.c1 = r.c0 + d1;
  r.lg0 = A * r.c0;
  r.lg1 = A * r.c1;
  r.lend = __shfl_sync(0xffffffffu, r.lg1, 31);
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// ---- 1. the carries, each chunk's contribution folded in ------------------

// byte offsets from a 1024-aligned base: two stages of the operand tile (x
// forward, dy in reverse: rows z, columns p) and the 64-column piece of B
// (C) (rows z, columns s), and dt; the emitted state's hi and lo tiles
// (rows s, columns p); the step's row coefficients and decay; mbarriers
struct KLayout {
  static constexpr int kOp = 0;
  static constexpr int kPc = kBox;
  static constexpr int kStage = 2 * kBox;
  static constexpr int kOut = 2 * kStage;
  static constexpr int kDt = kOut + 2 * kBox;          // [stage][64]
  static constexpr int kCoef = kDt + 2 * 4 * kQ;       // [64]
  static constexpr int kDecay = kCoef + 4 * kQ;        // 1 float, 16 bytes
  static constexpr int kBar = kDecay + 16;             // full[2]
  static constexpr int kBytes = kBar + 16 + 1024;      // + alignment slack
};
static_assert(KLayout::kBytes == 50976, "kernel.py BWD_SMEM_BYTES walk");

__global__ void __launch_bounds__(kWT)
    ssd_bwd_walk_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tdy,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap tc,
                        SsdBwdArgs a) {
  using K = KLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));
  float* const sDt = reinterpret_cast<float*>(sm + K::kDt);
  float* const sCoef = reinterpret_cast<float*>(sm + K::kCoef);
  float* const sDecay = reinterpret_cast<float*>(sm + K::kDecay);
  const uint32_t full = base + K::kBar;

  const int L = a.length, P = a.head_dim, S = a.state_dim;
  const int n = (L + kQ - 1) / kQ, pieces = (S + 63) / 64;
  int id = blockIdx.x;
  const int k = id % pieces;
  id /= pieces;
  const int h = id % a.heads;
  id /= a.heads;
  const int b = id % a.batch;
  const bool rev = id / a.batch == 1;
  const int g = h / (a.heads / a.groups);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = lane % 4, r0 = 16 * warp + lane / 4;
  const float A = a.a[h];
  const float* const dtp = a.dt + b * a.dt_sb + h * a.dt_sh;
  const unsigned short* const op =
      rev ? static_cast<const unsigned short*>(a.dy) + b * a.dy_sb +
                h * a.dy_sh
          : static_cast<const unsigned short*>(a.x) + b * a.x_sb +
                h * a.x_sh;
  const long long op_sl = rev ? a.dy_sl : a.x_sl;
  const unsigned short* const pc =
      (rev ? static_cast<const unsigned short*>(a.c) + b * a.c_sb +
                 g * a.c_sg
           : static_cast<const unsigned short*>(a.b) + b * a.b_sb +
                 g * a.b_sg) + 64 * k;
  const long long pc_sl = rev ? a.c_sl : a.b_sl;
  // this (b, h)'s tiles: chunk i's block of [hi/lo][piece] tiles
  const long long block = 2LL * pieces * kBox;
  uint8_t* const out =
      reinterpret_cast<uint8_t*>(rev ? a.dstates : a.states) +
      ((long long)b * a.heads + h) * n * block;

  // step j's chunk (forward j, reverse n - 1 - j) into stage j % 2: TMA
  // (thread 0, on the stage's mbarrier) or cp.async; dt by cp.async
  auto fetch = [&](int j) {
    const int s = j & 1, t0 = (rev ? n - 1 - j : j) * kQ;
    const int rows = min(kQ, L - t0);
    if (a.route == 0) {
      if (tid == 0) {
        const uint32_t sa = base + s * K::kStage, bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * kBox);
        if (rev) {
          tma_load(sa + K::kOp, &tdy, bar, 0, h, t0, b);
          tma_load(sa + K::kPc, &tc, bar, 64 * k, g, t0, b);
        } else {
          tma_load(sa + K::kOp, &tx, bar, 0, h, t0, b);
          tma_load(sa + K::kPc, &tb, bar, 64 * k, g, t0, b);
        }
      }
    } else {
      uint8_t* const st = sm + s * K::kStage;
      fetch_tile<kWT>(st + K::kOp, op + t0 * op_sl, op_sl, rows, P);
      fetch_tile<kWT>(st + K::kPc, pc + t0 * pc_sl, pc_sl, rows, S - 64 * k);
    }
    if (warp == 0)
      for (int r = lane; r < kQ; r += 32) {
        float* const d = sDt + s * kQ + r;
        if (r < rows) cp_async4(d, dtp + (long long)(t0 + r) * a.dt_sl);
        else *d = 0.0f;
      }
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  fetch(0);

  // the carried state, transposed: element e is (p, 64 k + s) at the
  // accumulator's (row, column); the reverse walk starts from dstate
  float st[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int p = acc_row(r0, e), sc = 64 * k + acc_col(q, e);
    st[e] = rev && a.dstate != nullptr && p < P && sc < S
                ? a.dstate[(((long long)b * a.heads + h) * S + sc) * P + p]
                : 0.0f;
  }

  for (int j = 0; j < n; ++j) {
    const int s = j & 1, i = rev ? n - 1 - j : j;
    const uint32_t sa = base + s * K::kStage;
    if (a.route == 0) mbar_wait(full + 8 * s, (j >> 1) & 1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    fence_async_shared();                // the copies, to wgmma's proxy
    if (tid == 0) bulk_wait_read();      // the last step's tiles are read
    __syncthreads();   // stage s landed; step j - 1 done with the other
    if (j + 1 < n) fetch(j + 1);
    if (warp == 0) {   // the step's coefficients: w forward, exp(lg) reverse
      const float d0 = sDt[s * kQ + 2 * lane], d1 = sDt[s * kQ + 2 * lane + 1];
      const RowPair rp = cumsum_pair(d0, d1, A, lane);
      sCoef[2 * lane] = rev ? expf(rp.lg0) : expf(rp.lend - rp.lg0) * d0;
      sCoef[2 * lane + 1] = rev ? expf(rp.lg1) : expf(rp.lend - rp.lg1) * d1;
      if (lane == 31) *sDecay = expf(rp.lend);
    }
    // the state entering (leaving) chunk i, as bf16 hi and lo tiles
    // [s][p]: transposed out of the accumulator 8 x 8 at a time
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(st[8 * m + 2 * r], st[8 * m + 2 * r + 1], hi[r], lo[r]);
      const int jj = lane / 8, row = 8 * (2 * m + jj / 2) + lane % 8;
      const uint32_t at = base + K::kOut + swz(row, 16 * warp + 8 * (jj % 2));
      stmatrix_t(at, hi[0], hi[1], hi[2], hi[3]);
      stmatrix_t(at + kBox, lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_shared();
    __syncthreads();   // the tiles and the coefficients are in place
    if (tid == 0) {
      uint8_t* const dst = out + i * block + k * kBox;
      bulk_store(dst, sm + K::kOut, kBox);
      bulk_store(dst + pieces * kBox, sm + K::kOut + kBox, kBox);
      bulk_commit();
    }
    const float decay = *sDecay;
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] *= decay;
    // A = (coef o operand)^T: rows p, k-step kk: z = 16 kk + 2 q + {0, 1}
    // (+ 8), transposed out of the operand tile (matrix m: z from
    // 16 kk + 8 (m / 2), p from 16 warp + 8 (m % 2)) and split
    uint32_t fhi[4][4], flo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int m = lane / 8;
      uint32_t f[4];
      ldmatrix_t(sa + K::kOp + swz(16 * kk + 8 * (m / 2) + lane % 8,
                                   16 * warp + 8 * (m % 2)), f);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int z = 16 * kk + 2 * q + 8 * (r / 2);
        split_pair(bf16_lo(f[r]) * sCoef[z], bf16_hi(f[r]) * sCoef[z + 1],
                   fhi[kk][r], flo[kk][r]);
      }
    }
    // state^T += A B (or C), the piece read MN-major
    const uint64_t db = mnmajor(sa + K::kPc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(st, fhi[kk], db + kk * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(st, flo[kk], db + kk * 128);
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
  }
  if (tid == 0) bulk_wait();
}

// ---- 2. the chunk's gradients, a slab of a group's heads a CTA ------------

// Warpgroup 0's running sum of dG' (rows t, columns z) lives in shared
// memory, a thread's elements of the 8-column blocks at or below the
// diagonal (z <= t somewhere in the warp's 16 rows: blocks 0..2 warp + 1).
// Warp w keeps 4 (2 w + 2) elements a lane from float 128 w (w + 1) on,
// lane l's element e at e x 32 + l.
constexpr int kDgsFloats = 128 * 4 * 5;           // a fifth warp's start
__device__ __forceinline__ int dgs_at(int warp, int lane, int e) {
  return 128 * warp * (warp + 1) + e * 32 + lane;
}

// byte offsets from a 1024-aligned base: B and C (NS tiles each, rows z or
// t, columns s); two stages of a head's x, dy (rows z or t, columns p),
// S_in's and dS_out's hi and lo tiles (NS each, rows s, columns p); C B^T
// (z x t) a thread's 32 values; dt per stage; per warpgroup lg log2(e),
// dt, exp(lg) and w; N's row sums per warp; <S_in, dS_out> per warp; dG''s
// sum; mbarriers.  Mirrored by kernels/ssd/kernel.py BWD_SMEM_BYTES.
template <int NS>
struct GLayout {
  static constexpr int kB = 0;
  static constexpr int kC = NS * kBox;
  static constexpr int kStages = 2 * NS * kBox;
  static constexpr int kX = 0;                         // within a stage
  static constexpr int kDy = kBox;
  static constexpr int kSin = 2 * kBox;                // hi, then lo
  static constexpr int kDs = (2 + 2 * NS) * kBox;      // hi, then lo
  static constexpr int kStage = (2 + 4 * NS) * kBox;
  static constexpr int kCB = kStages + 2 * kStage;     // [32][128] float
  static constexpr int kDt = kCB + 32 * kWT * 4;       // [stage][64]
  static constexpr int kVec = kDt + 2 * 4 * kQ;        // [wg][4][64]
  static constexpr int kRowM = kVec + 2 * 4 * 4 * kQ;  // [warp][64]
  static constexpr int kDot = kRowM + 4 * 4 * kQ;      // [warp]
  static constexpr int kDgs = kDot + 16;               // dG''s sum
  static constexpr int kBar = kDgs + kDgsFloats * 4;   // full[2]
  static constexpr int kBytes = kBar + 16 + 1024;      // + alignment slack
};
static_assert(GLayout<1>::kBytes == 145952 && GLayout<2>::kBytes == 227872,
              "kernel.py BWD_SMEM_BYTES");

// the rows' d(lg) pieces in scratch, (B, H, n, 4, 64)
enum { kRowMSum = 0, kColNSum = 1, kDlgInter = 2, kDw = 3 };

template <int NS>
__global__ void __launch_bounds__(kGT, 1)
    ssd_bwd_grad_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tdy,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap tc,
                        SsdBwdArgs a) {
  using W = GLayout<NS>;
  constexpr int NC = 32 * NS;            // a thread's dB or dC elements
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base_ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t base = base_;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));
  float* const sDt = reinterpret_cast<float*>(sm + W::kDt);
  float* const sCB = reinterpret_cast<float*>(sm + W::kCB);
  float* const sRowM = reinterpret_cast<float*>(sm + W::kRowM);
  float* const sDot = reinterpret_cast<float*>(sm + W::kDot);
  const uint32_t full = base + W::kBar;

  const int L = a.length, P = a.head_dim, S = a.state_dim, H = a.heads;
  const int n = (L + kQ - 1) / kQ, per = H / a.groups;
  const int slabs = (per + a.slab - 1) / a.slab;
  int id = blockIdx.x;
  const int j = id % slabs;
  id /= slabs;
  const int g = id % a.groups;
  id /= a.groups;
  const int i = id % n, b = id / n;
  const int h0 = g * per + j * a.slab, cnt = min(a.slab, per - j * a.slab);
  const int t0 = i * kQ, rows = min(kQ, L - t0);
  const int tid = threadIdx.x, wg = tid / kWT, wtid_ = tid % kWT;
  const int wtid = wtid_;
  const int warp = wtid / 32, lane = tid % 32, q_ = lane % 4;
  const int r0_ = 16 * warp + lane / 4, r0 = r0_, q = q_;
  float* const vLg = reinterpret_cast<float*>(sm + W::kVec) + wg * 4 * kQ;
  float* const vDt = vLg + kQ;
  float* const vEl = vLg + 2 * kQ;
  float* const vW = vLg + 3 * kQ;

  // head u's tiles into stage u % 2: the states' hi/lo blocks by bulk
  // copies and (TMA route) x, dy and, with the first head, B and C by TMA,
  // all on the stage's mbarrier (thread 0); or x, dy, B, C by cp.async;
  // dt by cp.async (warp 0)
  auto fetch = [&](int u) {
    const int s = u & 1, h = h0 + u;
    uint8_t* const st = sm + W::kStages + s * W::kStage;
    const uint32_t sa = base + W::kStages + s * W::kStage, bar = full + 8 * s;
    const long long blk = (((long long)b * H + h) * n + i) * (2LL * NS * kBox);
    if (tid == 0) {
      uint32_t bytes = 4 * NS * kBox;
      if (a.route == 0) bytes += 2 * kBox + (u == 0 ? 2 * NS * kBox : 0);
      mbar_expect_tx(bar, bytes);
      bulk_load(st + W::kSin, reinterpret_cast<const uint8_t*>(a.states) + blk,
                2 * NS * kBox, bar);
      bulk_load(st + W::kDs, reinterpret_cast<const uint8_t*>(a.dstates) + blk,
                2 * NS * kBox, bar);
      if (a.route == 0) {
        tma_load(sa + W::kX, &tx, bar, 0, h, t0, b);
        tma_load(sa + W::kDy, &tdy, bar, 0, h, t0, b);
        if (u == 0)
          for (int k = 0; k < NS; ++k) {
            tma_load(base + W::kB + k * kBox, &tb, bar, 64 * k, g, t0, b);
            tma_load(base + W::kC + k * kBox, &tc, bar, 64 * k, g, t0, b);
          }
      }
    }
    if (a.route == 1) {
      using us = unsigned short;
      fetch_tile<kGT>(st + W::kX, static_cast<const us*>(a.x) + b * a.x_sb +
                          t0 * a.x_sl + h * a.x_sh, a.x_sl, rows, P);
      fetch_tile<kGT>(st + W::kDy, static_cast<const us*>(a.dy) +
                          b * a.dy_sb + t0 * a.dy_sl + h * a.dy_sh,
                      a.dy_sl, rows, P);
      if (u == 0)
        for (int k = 0; k < NS; ++k) {
          fetch_tile<kGT>(sm + W::kB + k * kBox,
                          static_cast<const us*>(a.b) + b * a.b_sb +
                              t0 * a.b_sl + g * a.b_sg + 64 * k,
                          a.b_sl, rows, S - 64 * k);
          fetch_tile<kGT>(sm + W::kC + k * kBox,
                          static_cast<const us*>(a.c) + b * a.c_sb +
                              t0 * a.c_sl + g * a.c_sg + 64 * k,
                          a.c_sl, rows, S - 64 * k);
        }
    }
    if (tid < 32)
      for (int r = lane; r < kQ; r += 32) {
        float* const d = sDt + s * kQ + r;
        if (r < rows)
          cp_async4(d, a.dt + b * a.dt_sb + (long long)(t0 + r) * a.dt_sl +
                           h * a.dt_sh);
        else *d = 0.0f;
      }
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  fetch(0);

  // head u: its stage landed and head u - 1 is done with the other (the
  // whole CTA), the next head's loads go out, and each warpgroup's warp 0
  // forms the head's rows (lg log2(e), dt, exp(lg), w)
  auto begin_head = [&](int u) {
    const int s = u & 1;
    mbar_wait(full + 8 * s, (u >> 1) & 1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    fence_async_shared();                // the copies, to wgmma's proxy
    __syncthreads();
    if (u + 1 < cnt) fetch(u + 1);
    if (warp == 0) {
      const float d0 = sDt[s * kQ + 2 * lane], d1 = sDt[s * kQ + 2 * lane + 1];
      const RowPair rp = cumsum_pair(d0, d1, a.a[h0 + u], lane);
      vLg[2 * lane] = rp.lg0 * kLog2e;
      vLg[2 * lane + 1] = rp.lg1 * kLog2e;
      vDt[2 * lane] = d0;
      vDt[2 * lane + 1] = d1;
      vEl[2 * lane] = expf(rp.lg0);
      vEl[2 * lane + 1] = expf(rp.lg1);
      vW[2 * lane] = expf(rp.lend - rp.lg0) * d0;
      vW[2 * lane + 1] = expf(rp.lend - rp.lg1) * d1;
    }
    named_sync(1 + wg, kWT);
  };
  // the slab's float32 partial of dC (warpgroup 0) or dB (1): rows t or z
  // below `rows`, columns s below S; its place formed from the block's
  // index anew, not kept across the head loops
  auto store_partial = [&](const float (&acc)[NC]) {
    const long long blk = opaque((int)blockIdx.x);
    const long long sg = blk % (slabs * a.groups);   // slab j, group g
    const long long chunk_row = blk / (slabs * a.groups) * kQ;   // b L + t0
    const long long at_b = chunk_row / (n * kQ), at_t = chunk_row % (n * kQ);
    float* const part = (wg == 0 ? a.dcp : a.dbp) +
                        (((sg % slabs * a.batch + at_b) * L + at_t) *
                             a.groups + sg / slabs) * S;
    const long long ld = (long long)a.groups * S;
#pragma unroll
    for (int e = 0; e < NC; e += 2) {
      const int r = acc_row(r0, e), sc = acc_col(q, e);
      if (r < rows && sc < S)
        *reinterpret_cast<float2*>(part + r * ld + sc) =
            make_float2(acc[e], acc[e + 1]);
    }
  };
  // Each warpgroup keeps its own sums across the heads, in float32 and in
  // head order: warpgroup 0 dC (rows t, columns s) in its accumulator and
  // dG' (rows t, columns z) in shared memory, warpgroup 1 dB (rows z,
  // columns s).  The stage the last head left free takes dG''s split for
  // warpgroup 1.
  uint8_t* const free_st = sm + W::kStages + (cnt & 1) * W::kStage;
  if (wg == 0) {
    float acc[NC];
    float* const sDgs = reinterpret_cast<float*>(sm + W::kDgs);
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[e] = 0.0f;
    for (int u = 0; u < cnt; ++u) {
      begin_head(u);
      const int s = u & 1, h = h0 + u;
      // the thread's coordinates and the tiles' shared address, opaque a
      // head: the offsets formed from them are formed in the head, not
      // hoisted out of the loop and kept
      const int r0 = opaque(r0_), q = opaque(q_), wtid = opaque(wtid_);
      const int warp = wtid / 32, lane = wtid % 32;
      const uint32_t base = opaque(base_);
      const uint32_t sa = base + W::kStages + s * W::kStage;
      const uint8_t* const st = sm + W::kStages + s * W::kStage;
      const long long at = ((long long)b * H + h) * n + i;
      float* const rowp = a.rowp + at * 4 * kQ;
      // <S_in, dS_out> from the hi and lo tiles (one layout), 16 bytes of
      // each at a time
      {
        const uint8_t* const sin = st + W::kSin;
        const uint8_t* const dso = st + W::kDs;
        float dot = 0.0f;
        for (int c = wtid; c < NS * kBox / 16; c += kWT) {
          const uint4 sh = reinterpret_cast<const uint4*>(sin)[c];
          const uint4 sl = reinterpret_cast<const uint4*>(sin + NS * kBox)[c];
          const uint4 dh = reinterpret_cast<const uint4*>(dso)[c];
          const uint4 dl = reinterpret_cast<const uint4*>(dso + NS * kBox)[c];
          const uint32_t a4[4][4] = {{sh.x, sl.x, dh.x, dl.x},
                                     {sh.y, sl.y, dh.y, dl.y},
                                     {sh.z, sl.z, dh.z, dl.z},
                                     {sh.w, sl.w, dh.w, dl.w}};
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            dot += (bf16_lo(a4[v][0]) + bf16_lo(a4[v][1])) *
                   (bf16_lo(a4[v][2]) + bf16_lo(a4[v][3]));
            dot += (bf16_hi(a4[v][0]) + bf16_hi(a4[v][1])) *
                   (bf16_hi(a4[v][2]) + bf16_hi(a4[v][3]));
          }
        }
        dot = warp_sum(dot);
        if (lane == 0) sDot[warp] = dot;
      }
      // dy S_in^T (rows t, columns s) a 64-column piece at a time, then
      // dy x^T (rows t, columns z): one product at a time, so that a
      // thread holds dC's sum, dG''s and one 64-column product at most.
      // C_t . (dy S_in^T)_t = dy_t . (C_t S_in); dC += exp(lg) o dy S_in^T
      float part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        float y[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(y, kmajor(sa + W::kDy, kk),
                       kmajor(sa + W::kSin + k * kBox, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(y, kmajor(sa + W::kDy, kk),
                       kmajor(sa + W::kSin + (NS + k) * kBox, kk), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(y);
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const uint32_t cpair = *reinterpret_cast<const uint32_t*>(
              sm + W::kC + k * kBox + swz(acc_row(r0, e), acc_col(q, e)));
          part[(e / 2) % 2] += bf16_lo(cpair) * y[e];
          part[(e / 2) % 2] += bf16_hi(cpair) * y[e + 1];
        }
#pragma unroll
        for (int e = 0; e < 32; ++e)
          acc[32 * k + e] += vEl[acc_row(r0, e)] * y[e];
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        part[v] += __shfl_xor_sync(0xffffffffu, part[v], 1);
        part[v] += __shfl_xor_sync(0xffffffffu, part[v], 2);
      }
      if (q == 0) {
        rowp[kDlgInter * kQ + r0] = vEl[r0] * part[0];
        rowp[kDlgInter * kQ + r0 + 8] = vEl[r0 + 8] * part[1];
      }
      // dG' = dy x^T o exp(lg_t - lg_z) o dt_z (z <= t), into the sum
      float dg[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(dg, kmajor(sa + W::kDy, kk), kmajor(sa + W::kX, kk),
                     kk > 0);
      wgmma_commit();
      named_sync(1, kWT);
      if (wtid == 0)
        a.dotp[at] = sDot[0] + sDot[1] + sDot[2] + sDot[3];
      wgmma_wait();
      fence_regs(dg);
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        if (jb > 2 * warp + 1) break;    // z > t in all the warp's rows
#pragma unroll
        for (int e = 4 * jb; e < 4 * jb + 4; ++e) {
          const int t = acc_row(r0, e), z = acc_col(q, e);
          float* const d = sDgs + dgs_at(warp, lane, e);
          const float v = z <= t ? dg[e] * ex2(vLg[t] - vLg[z]) * vDt[z]
                                 : 0.0f;
          *d = u == 0 ? v : *d + v;
        }
      }
    }
    float dgs[32];
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dgs[e] = e / 4 <= 2 * warp + 1 ? sDgs[dgs_at(warp, lane, e)] : 0.0f;
    // the slab's dG' once, split hi + lo: dC += dG' B (B MN-major), and
    // the split into the free stage as tiles [t][z] for warpgroup 1
    uint32_t fhi[4][4], flo[4][4];
    split_frags(dgs, fhi, flo);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int off = swz(acc_row(r0, 8 * kk + 2 * r),
                            acc_col(q, 8 * kk + 2 * r));
        *reinterpret_cast<uint32_t*>(free_st + W::kX + off) = fhi[kk][r];
        *reinterpret_cast<uint32_t*>(free_st + W::kDy + off) = flo[kk][r];
      }
    fence_async_shared();
    __syncthreads();
    const uint64_t db = mnmajor(base + W::kB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, fhi[kk], db + kk * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, flo[kk], db + kk * 128);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    store_partial(acc);
  } else {
    float acc[NC];
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[e] = 0.0f;
    for (int u = 0; u < cnt; ++u) {
      begin_head(u);
      const int s = u & 1, h = h0 + u;
      // the thread's coordinates and the tiles' shared address, opaque a
      // head: the offsets formed from them are formed in the head, not
      // hoisted out of the loop and kept
      const int r0 = opaque(r0_), q = opaque(q_), wtid = opaque(wtid_);
      const int warp = wtid / 32, lane = wtid % 32;
      const uint32_t base = opaque(base_);
      const uint32_t sa = base + W::kStages + s * W::kStage;
      const uint8_t* const st = sm + W::kStages + s * W::kStage;
      const long long at = ((long long)b * H + h) * n + i;
      float* const rowp = a.rowp + at * 4 * kQ;
      if (u == 0) {   // C B^T transposed (rows z, columns t), once a slab
        float cb[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NS; ++kk)
          wgmma_ss_n64(cb, kmajor(base + W::kB, kk),
                       kmajor(base + W::kC, kk), kk > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(cb);
#pragma unroll
        for (int e = 0; e < 32; ++e) sCB[e * kWT + wtid] = cb[e];
      }
      // x dy^T (rows z, columns t) -> N^T for t >= z
      float dgt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(dgt, kmajor(sa + W::kX, kk), kmajor(sa + W::kDy, kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(dgt);
      // N's sums: over t (the columns) in the quad; over z (the rows)
      // across the warp's lanes as each 8-column block forms, then the
      // warps in order.  Blocks above the diagonal (t < z in all the
      // warp's rows: 0..2 warp - 1) add nothing.
      float coln[2] = {0.0f, 0.0f};
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        float rowm[2] = {0.0f, 0.0f};
        if (jb >= 2 * warp) {
#pragma unroll
          for (int e = 4 * jb; e < 4 * jb + 4; ++e) {
            const int z = acc_row(r0, e), t = acc_col(q, e);
            float nv = 0.0f;
            if (t >= z)
              nv = dgt[e] * sCB[e * kWT + wtid] * ex2(vLg[t] - vLg[z]);
            coln[(e / 2) % 2] += nv;
            rowm[e % 2] += nv * vDt[z];
          }
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            rowm[v] += __shfl_xor_sync(0xffffffffu, rowm[v], 4);
            rowm[v] += __shfl_xor_sync(0xffffffffu, rowm[v], 8);
            rowm[v] += __shfl_xor_sync(0xffffffffu, rowm[v], 16);
          }
        }
        if (lane < 4) {
          sRowM[warp * kQ + 8 * jb + 2 * q] = rowm[0];
          sRowM[warp * kQ + 8 * jb + 2 * q + 1] = rowm[1];
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        coln[v] += __shfl_xor_sync(0xffffffffu, coln[v], 1);
        coln[v] += __shfl_xor_sync(0xffffffffu, coln[v], 2);
      }
      if (q == 0) {
        rowp[kColNSum * kQ + r0] = coln[0];
        rowp[kColNSum * kQ + r0 + 8] = coln[1];
      }
      // B dS_out (rows z, columns p), dS_out read MN-major
      float dx[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NS; ++kk)
        wgmma_ss_n64_tb(dx, kmajor(base + W::kB, kk),
                        mnmajor(sa + W::kDs) + kk * 128, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * NS; ++kk)
        wgmma_ss_n64_tb(dx, kmajor(base + W::kB, kk),
                        mnmajor(sa + W::kDs + NS * kBox) + kk * 128, 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(dx);
      // B_z . (dS_out x_z) = x_z . (B dS_out)_z; dx = w o B dS_out + G^T dy
      float dwp[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int z = acc_row(r0, e), p = acc_col(q, e);
        const uint32_t xpair =
            *reinterpret_cast<const uint32_t*>(st + W::kX + swz(z, p));
        dwp[(e / 2) % 2] += bf16_lo(xpair) * dx[e];
        dwp[(e / 2) % 2] += bf16_hi(xpair) * dx[e + 1];
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        dwp[v] += __shfl_xor_sync(0xffffffffu, dwp[v], 1);
        dwp[v] += __shfl_xor_sync(0xffffffffu, dwp[v], 2);
      }
      if (q == 0) {
        rowp[kDw * kQ + r0] = dwp[0];
        rowp[kDw * kQ + r0 + 8] = dwp[1];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) dx[e] *= vW[acc_row(r0, e)];
      // G^T = (C B^T)^T o exp(lg_t - lg_z) o dt_z for t >= z, split as the
      // A fragments of G^T dy (k-step kk: columns t of blocks 2 kk, + 1)
      uint32_t ghi[4][4], glo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float gv[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int e = 8 * kk + 2 * r + v;
            const int z = acc_row(r0, e), t = acc_col(q, e);
            gv[v] = e / 4 >= 2 * warp && t >= z
                        ? sCB[e * kWT + wtid] * ex2(vLg[t] - vLg[z]) * vDt[z]
                        : 0.0f;
          }
          split_pair(gv[0], gv[1], ghi[kk][r], glo[kk][r]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dx, ghi[kk], mnmajor(sa + W::kDy) + kk * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dx, glo[kk], mnmajor(sa + W::kDy) + kk * 128);
      wgmma_commit();
      wgmma_wait();
      fence_regs(dx);
      {
        __nv_bfloat16* const dxp = static_cast<__nv_bfloat16*>(a.dx) +
                                   (((long long)b * L + t0) * H + h) * P;
        const long long ld = (long long)H * P;
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int z = acc_row(r0, e), p = acc_col(q, e);
          if (z >= rows || p >= P) continue;
          __nv_bfloat16* const o = dxp + z * ld + p;
          if (P % 2 == 0) {
            *reinterpret_cast<uint32_t*>(o) = bf16_pair(dx[e], dx[e + 1]);
          } else {
            o[0] = __float2bfloat16_rn(dx[e]);
            if (p + 1 < P) o[1] = __float2bfloat16_rn(dx[e + 1]);
          }
        }
      }
      named_sync(2, kWT);
      if (wtid < kQ)
        rowp[kRowMSum * kQ + wtid] = sRowM[wtid] + sRowM[kQ + wtid] +
                                     sRowM[2 * kQ + wtid] +
                                     sRowM[3 * kQ + wtid];
      // dB += w o x dS_out^T (rows z, columns s), a 64-column piece at a
      // time
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        float zz[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(zz, kmajor(sa + W::kX, kk),
                       kmajor(sa + W::kDs + k * kBox, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(zz, kmajor(sa + W::kX, kk),
                       kmajor(sa + W::kDs + (NS + k) * kBox, kk), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(zz);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          acc[32 * k + e] += vW[acc_row(r0, e)] * zz[e];
      }
    }
    // dB += dG'^T C: dG' from warpgroup 0's tiles [t][z] and C, both read
    // MN-major
    __syncthreads();
    const uint32_t fa = smem_u32(free_st);
    const uint64_t db = mnmajor(base + W::kC);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tt<NS>(acc, mnmajor(fa + W::kX) + kk * 128, db + kk * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tt<NS>(acc, mnmajor(fa + W::kDy) + kk * 128, db + kk * 128);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    store_partial(acc);
  }
}

// ---- 3. d(lg): ddt and the chunk's share of da ---------------------------

__global__ void __launch_bounds__(kScanThreads)
    ssd_bwd_finish_kernel(SsdBwdArgs a) {
  const int L = a.length, n = (L + kQ - 1) / kQ;
  const long long w =
      ((long long)blockIdx.x * kScanThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)a.batch * a.heads * n) return;
  const int i = w % n, h = (w / n) % a.heads, b = w / n / a.heads;
  const int t0 = i * kQ, rows = min(kQ, L - t0);
  const float A = a.a[h];
  const float* const rp = a.rowp + w * 4 * kQ;
  float d[2], lg[2], m[2], dlg[2], col[2], dw[2];
  for (int v = 0; v < 2; ++v) {
    const int t = 2 * lane + v;
    d[v] = t < rows
               ? a.dt[b * a.dt_sb + (long long)(t0 + t) * a.dt_sl +
                      h * a.dt_sh]
               : 0.0f;
  }
  const RowPair r = cumsum_pair(d[0], d[1], A, lane);
  lg[0] = r.lg0;
  lg[1] = r.lg1;
  for (int v = 0; v < 2; ++v) {
    const int t = 2 * lane + v;
    col[v] = rp[kColNSum * kQ + t];
    dw[v] = rp[kDw * kQ + t];
    m[v] = dw[v] * (expf(r.lend - lg[v]) * d[v]);
    // the decays into row t less those out of column t, the inter-chunk
    // term, the state's
    dlg[v] = rp[kRowMSum * kQ + t] - d[v] * col[v] + rp[kDlgInter * kQ + t] -
             m[v];
  }
  const float dww = warp_sum(m[0] + m[1]);
  if (lane == 31) dlg[1] += dww + expf(r.lend) * a.dotp[w];
  // the reverse cumsum of d(lg) over the chunk's rows
  float suf = dlg[0] + dlg[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, suf, o);
    if (lane + o < 32) suf += v;
  }
  float after = __shfl_down_sync(0xffffffffu, suf, 1);
  if (lane == 31) after = 0.0f;
  float rev[2];
  rev[1] = dlg[1] + after;
  rev[0] = dlg[0] + rev[1];
  for (int v = 0; v < 2; ++v) {
    const int t = 2 * lane + v;
    if (t < rows)
      a.ddt[((long long)b * L + t0 + t) * a.heads + h] =
          col[v] + dw[v] * expf(r.lend - lg[v]) + A * rev[v];
  }
  const float dap = warp_sum(dlg[0] * r.c0 + dlg[1] * r.c1);
  if (lane == 0) a.dap[w] = dap;
}

// ---- 4. the slabs' dB and dC summed; da over batch and chunks ------------

__global__ void __launch_bounds__(kScanThreads)
    ssd_bwd_slab_kernel(SsdBwdArgs a) {
  const int per = a.heads / a.groups;
  const int slabs = (per + a.slab - 1) / a.slab;
  const long long total = (long long)a.batch * a.length * a.groups *
                          a.state_dim;
  for (long long e = (long long)blockIdx.x * kScanThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kScanThreads) {
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < slabs; ++k) {
      sb += a.dbp[k * total + e];
      sc += a.dcp[k * total + e];
    }
    static_cast<__nv_bfloat16*>(a.db)[e] = __float2bfloat16_rn(sb);
    static_cast<__nv_bfloat16*>(a.dc)[e] = __float2bfloat16_rn(sc);
  }
  if (blockIdx.x == 0) {
    const int n = (a.length + kQ - 1) / kQ;
    for (int h = threadIdx.x; h < a.heads; h += kScanThreads) {
      float s = 0.0f;
      for (int b = 0; b < a.batch; ++b)
        for (int i = 0; i < n; ++i) s += a.dap[slot(a, b, h, i, n)];
      a.da[h] = s;
    }
  }
}

// The gradient CTA's heads: the slab width w in 1..per that minimises
// waves x (w + 1) (waves of batch n groups ceil(per / w) CTAs, one an SM;
// a CTA's own work counted as one more head), the widest at a tie.
// Mirrored by kernels/ssd/kernel.py slab_width.
int slab_width(int batch, int n, int groups, int per, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int w = 1; w <= per; ++w) {
    const long long ctas = (long long)batch * n * groups * ((per + w - 1) / w);
    const long long cost = (ctas + sms - 1) / sms * (w + 1);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = w;
    }
  }
  return best;
}

template <int NS>
cudaError_t prepare_bf16() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KLayout::kBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_bwd_grad_kernel<NS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              GLayout<NS>::kBytes);
}

template <int NS>
int launch_bf16(const SsdBwdArgs& a, cudaStream_t stream) {
  // 4-D maps over x and dy (P, H, L, B) and B, C (S, G, L, B) in their own
  // strides (the cp.async route leaves them unused)
  CUtensorMap tx{}, tdy{}, tb{}, tc{};
  const int rows = a.length;
  if (a.route == 0 &&
      (!encode_bf16_4d(&tx, a.x, a.head_dim, a.heads, rows, a.batch,
                       2 * a.x_sh, 2 * a.x_sl, 2 * a.x_sb, kQ) ||
       !encode_bf16_4d(&tdy, a.dy, a.head_dim, a.heads, rows, a.batch,
                       2 * a.dy_sh, 2 * a.dy_sl, 2 * a.dy_sb, kQ) ||
       !encode_bf16_4d(&tb, a.b, a.state_dim, a.groups, rows, a.batch,
                       2 * a.b_sg, 2 * a.b_sl, 2 * a.b_sb, kQ) ||
       !encode_bf16_4d(&tc, a.c, a.state_dim, a.groups, rows, a.batch,
                       2 * a.c_sg, 2 * a.c_sl, 2 * a.c_sb, kQ)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_bf16<NS>();
  if (err != cudaSuccess) return (int)err;
  const int n = (a.length + kQ - 1) / kQ, per = a.heads / a.groups;
  const long long walks = 2LL * a.batch * a.heads * NS;
  ssd_bwd_walk_kernel<<<(unsigned)walks, kWT, KLayout::kBytes, stream>>>(
      tx, tdy, tb, tc, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long ctas =
      (long long)a.batch * n * a.groups * ((per + a.slab - 1) / a.slab);
  ssd_bwd_grad_kernel<NS><<<(unsigned)ctas, kGT, GLayout<NS>::kBytes,
                            stream>>>(tx, tdy, tb, tc, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)a.batch * a.heads * n;
  ssd_bwd_finish_kernel<<<(unsigned)((warps * 32 + kScanThreads - 1) /
                                     kScanThreads),
                          kScanThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)a.batch * a.length * a.groups *
                          a.state_dim;
  long long blocks = (total + kScanThreads - 1) / kScanThreads;
  if (blocks > 4096) blocks = 4096;
  ssd_bwd_slab_kernel<<<(int)blocks, kScanThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// expected_smem: the wrapper's count of the chunk-gradient kernel's shared
// bytes for the dtype and S (kernels/ssd/kernel.py BWD_SMEM_BYTES);
// bfloat16 also the walks' count and `slab` the wrapper's plan
// (kernel.py bwd_plan, at this card's SM count).  A mismatch means the
// two disagree, and the launch is refused.
extern "C" int ssd_scan_bwd(const SsdBwdArgs* a, size_t expected_smem,
                            size_t expected_walk_smem, cudaStream_t stream) {
  if (a->dtype != 0 && a->dtype != 1) return (int)cudaErrorInvalidValue;
  if (a->groups < 1 || a->heads % a->groups != 0 || a->head_dim < 1 ||
      a->head_dim > kP || a->state_dim < 1 || a->state_dim > 128 ||
      (a->dtype == 1 &&
       (a->state_dim % 4 != 0 || (a->route != 0 && a->route != 1))))
    return (int)cudaErrorInvalidValue;
  const bool wide = a->state_dim > 64;
  const size_t smem =
      a->dtype == 1
          ? (size_t)(wide ? GLayout<2>::kBytes : GLayout<1>::kBytes)
          : sizeof(float) * (wide ? bwd_smem_floats<8>()
                                  : bwd_smem_floats<4>());
  const size_t walk_smem = a->dtype == 1 ? (size_t)KLayout::kBytes : 0;
  if (expected_smem != smem || expected_walk_smem != walk_smem)
    return (int)cudaErrorInvalidValue;
  if (a->batch < 1 || a->length < 1 || a->heads < 1) return (int)cudaSuccess;
  if (a->dtype == 0)
    return (int)(wide ? launch<float, 8>(*a, stream)
                      : launch<float, 4>(*a, stream));
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n = (a->length + kQ - 1) / kQ, per = a->heads / a->groups;
  if (a->slab != slab_width(a->batch, n, a->groups, per, sms))
    return (int)cudaErrorInvalidValue;
  return wide ? launch_bf16<2>(*a, stream) : launch_bf16<1>(*a, stream);
}

// {registers, local (spill) bytes a thread, shared bytes, threads} of each
// bfloat16 kernel, in the order kernels/ssd/kernel.py BWD_KERNELS names
// them.
extern "C" int ssd_scan_bwd_attrs(int* out, int n) {
  if (n != 5) return (int)cudaErrorInvalidValue;
  const int errs[5] = {
      attrs(ssd_bwd_walk_kernel, KLayout::kBytes, kWT, out),
      attrs(ssd_bwd_grad_kernel<2>, GLayout<2>::kBytes, kGT, out + 4),
      attrs(ssd_bwd_grad_kernel<1>, GLayout<1>::kBytes, kGT, out + 8),
      attrs(ssd_bwd_finish_kernel, 0, kScanThreads, out + 12),
      attrs(ssd_bwd_slab_kernel, 0, kScanThreads, out + 16)};
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}
