// The backward of the Mamba2 SSD scan (#8's gradient), on the CUDA cores.
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
// ssd_scan_bwd_plain is the same function, written in the same order.
//
// Four launches on the caller's stream, no atomics (a second call gives
// the same bits), every sum in a fixed order:
//   1. ssd_bwd_chunk_kernel, a CTA a (chunk, head, batch): the chunk's
//      state contribution B^T (w o x) and its state-gradient contribution
//      (exp(lg) o C)^T dy, each (S, P) float32 into scratch, and the
//      chunk's decay exp(lg_last);
//   2. ssd_bwd_scan_kernel, a thread an element of (S, P) of a (batch,
//      head): the forward carry over the chunks, replacing each chunk's
//      contribution by the state entering it, then the reverse carry from
//      dstate, replacing each by the state gradient leaving it (the
//      scratch is laid out (batch, head, chunk), so a walk steps 32 KB at
//      S = 128, and each step's load is issued before the previous
//      element is replaced);
//   3. ssd_bwd_kernel, a CTA a (chunk, head, batch): everything else,
//      local to the chunk given those two states: the quadratic term's
//      C B^T, dy x^T and from them G = C B^T o exp(lg_t - lg_z) o dt_z and
//      its gradient (z <= t), then dx = G^T dy + w o (B dS_out),
//      dC = exp(lg) o (dy S_in^T) + dG' B, dB = w o (x dS_out^T) + dG'^T C
//      (dG' = dy x^T o exp(lg_t - lg_z) o dt_z), and d(lg) by row and
//      column sums, its reverse cumsum into ddt and a per-chunk share of
//      da; dB and dC per head into float32 scratch;
//   4. ssd_bwd_reduce_kernel: each group's dB and dC summed over its heads
//      in head order and rounded once; da summed over batch and chunks.
//
// What bounds it on an H100.  At mamba2-1.3b's training shape (B = 1 row,
// L = 4096, H = 64, P = 64, S = 128, G = 1) each (chunk of q = 64 rows,
// head) takes q(q+1)(3S + 2P) FLOP for the causal triangles of C B^T,
// dy x^T, G^T dy, dG' B and dG'^T C, and 10 q S P for the five products
// with a chunk state: ~30 GFLOP a call, 0.031 ms at the bf16 tensor-core
// peak and 0.45 ms at the 67 TFLOP/s of the CUDA cores, against ~107 MB
// of inputs and outputs, 0.032 ms at 3.35 TB/s (and ~0.54 GB of float32
// scratch, written and read once).  So on the CUDA cores, where this
// first design runs every product in float32, operations bound it.  From
// shared memory: a CTA of 256 threads holds 4 x 4 (or 4 x 8) outputs a
// thread, reads each operand row or column at an odd row stride, so that
// every access of a warp (16 columns of one or two rows) falls in
// distinct banks, and accumulates with fused multiply-adds.  Shared
// memory: kernel 3 holds x, dy, B, C, S_in, dS_out, G and its gradient
// (201,536 bytes at S = 128, one CTA an SM; 135,488 at S <= 64); kernel 1
// x, dy, B, C (100,608 / 67,840 bytes).
// A tensor-core (wgmma) design with float32 operands split hi + lo is a
// ROADMAP follow-up.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  float* states;            // scratch (B, H, n, S, P): S_in
  float* dstates;           // scratch (B, H, n, S, P): dS_out
  float* decay;             // scratch (B, H, n): exp(lg_last)
  float* dbp;               // scratch (B, L, H, S): dB per head
  float* dcp;               // scratch (B, L, H, S): dC per head
  float* dap;               // scratch (B, H, n): da per chunk
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl, b_sg, c_sb, c_sl, c_sg;
  long long dy_sb, dy_sl, dy_sh;
  int batch, length, heads, groups, head_dim, state_dim;
  int dtype;                // 0 float32, 1 bfloat16 (x, B, C, dy, dx, dB, dC)
};

namespace {

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
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
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

}  // namespace

extern "C" int ssd_scan_bwd(const SsdBwdArgs* a, cudaStream_t stream) {
  if (a->dtype != 0 && a->dtype != 1) return (int)cudaErrorInvalidValue;
  if (a->groups < 1 || a->heads % a->groups != 0 || a->head_dim < 1 ||
      a->head_dim > kP || a->state_dim < 1 || a->state_dim > 128)
    return (int)cudaErrorInvalidValue;
  if (a->batch < 1 || a->length < 1 || a->heads < 1) return (int)cudaSuccess;
  const bool wide = a->state_dim > 64;
  if (a->dtype == 0)
    return (int)(wide ? launch<float, 8>(*a, stream)
                      : launch<float, 4>(*a, stream));
  return (int)(wide ? launch<__nv_bfloat16, 8>(*a, stream)
                    : launch<__nv_bfloat16, 4>(*a, stream));
}

// {registers, local (spill) bytes a thread, shared bytes, threads} of each
// kernel, in the order kernels/ssd/kernel.py BWD_KERNELS names them.
extern "C" int ssd_scan_bwd_attrs(int* out, int n) {
  if (n != 5) return (int)cudaErrorInvalidValue;
  const int f = (int)sizeof(float);
  const int errs[5] = {
      attrs(ssd_bwd_chunk_kernel<__nv_bfloat16, 8>,
            chunk_smem_floats<8>() * f, kThreads, out),
      attrs(ssd_bwd_scan_kernel, 0, kScanThreads, out + 4),
      attrs(ssd_bwd_kernel<__nv_bfloat16, 8>, bwd_smem_floats<8>() * f,
            kThreads, out + 8),
      attrs(ssd_bwd_kernel<__nv_bfloat16, 4>, bwd_smem_floats<4>() * f,
            kThreads, out + 12),
      attrs(ssd_bwd_reduce_kernel<__nv_bfloat16>, 0, kScanThreads,
            out + 16)};
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}
