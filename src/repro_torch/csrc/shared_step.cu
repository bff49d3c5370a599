// Shared-weight dual-engine step: one SNN timestep of one synaptic layer for
// a batch of B activation rows that share ONE weight matrix (N, M), with
// the batch-averaged four-term dw.  One kernel template, three entry points:
//
//   shared_step_f32   replaces src/repro/kernels/plasticity/kernel.py:132
//   shared_step_bf16  dual_engine_step_pallas (_dual_engine_kernel :98), in
//                     float32 and in bfloat16 (the Pallas body's generic
//                     dtype, kernel.py:118-122)
//   shared_step_q     replaces src/repro/kernels/plasticity/kernel.py:431
//                     dual_engine_step_q_pallas (_dual_engine_kernel_q :399)
//
// What bounds it on an H100: bytes.  A step reads w and the four rule planes
// once and writes w once: at the online learner's 784 -> 1024 and B = 1,
// 19.3 MB in float32 (5.8 us at 3.35 TB/s), 14.5 MB in int8; the arithmetic
// is a handful of operations a synapse and row.  At 1024 -> 10 the bytes are
// ~0.2 MB and a launch's latency is the floor.
//
// Design (the launch is kernel.py shared_step_plan's; this file checks its
// shared-memory count; the Forward Engine is csrc/forward.cuh's, shared with
// lif_forward.cu):
//  * The grid is column tiles x fan-in shares: a CTA owns `cols` columns of
//    `rows` consecutive input rows.  Where the column tiles leave SMs idle
//    (the readout, M = 10), the fan-in is cut across the CTAs of a thread
//    block cluster of `split` CTAs, one column tile each.
//  * Bytes in flight do not depend on warps: at the start a CTA issues its
//    whole w slab on one mbarrier and its rule slab, in row chunks of four
//    planes, on one mbarrier a chunk: 2-D TMA boxes where the 16-byte rules
//    hold, else one 1-D bulk copy where the block is contiguous, else
//    cp.async of the widest piece the alignment allows, each thread
//    arriving on the chunk's barrier when its pieces land; else (rows not
//    4-byte aligned) w by plain loads and the rule read through L2.  Where
//    the rule does not fit, it streams through a ring of `stages` chunks,
//    each refilled once every thread has left it.  The psum waits for w
//    alone; the rule arrives behind the forward pass and is awaited before
//    the update.  The input events and pre traces of the CTA's rows are
//    staged beside them where they fit, and each thread's first neuron's
//    membrane, trace and teaching current are fetched meanwhile.
//  * Forward Engine: up to 512 threads, about 4 synapses each (no thread
//    walks a long chain).  A lane sums 4
//    weights of a row (one where M's rows are not in 16-byte pieces) over
//    strided rows of the fan-in, for up to 8 batch rows at once (32 sums in
//    registers); the lanes sharing those weights fold by a reduce-scatter
//    of warp shuffles (5 to 31 shuffles, not 32 partials a lane), the
//    warps in warp order, the cluster's CTAs in rank order through
//    distributed shared memory, every peer's partial loaded at once.  Every
//    CTA of a cluster runs the neuron and trace update of its tile (rank 0
//    stores them), so the fresh post traces reach every CTA without a
//    second exchange.
//  * Plasticity Engine: the batch means of the post traces once a step, of
//    a row's pre traces once a row and piece (x / 1 is x: B = 1 divides
//    nothing); a thread takes 16-byte pieces of w (4 float32, 8 bfloat16 or
//    16 int8 weights) and each piece's synapses read w and the rule from
//    shared memory and leave by one 16-byte store (element stores at a
//    ragged edge).  In fixed point a row's pre term is scaled once, and
//    dw / scale is dw * (1 / scale) where that is exact (a power-of-two
//    scale), as csrc/fleet.cuh does.
// Arithmetic, operation for operation as the plain versions: sources built
// with -fmad=false, explicit __fmaf_rn where XLA contracts; integer sums
// wrap in 32 bits and are order-free, so shared_step_q equals
// ref.dual_engine_step_q bit for bit at any plan (IEEE division for
// dw / scale or its exact reciprocal, the hash counter the flat row * M +
// col index); the float psum is folded in one fixed order, with no atomics.
// bfloat16 operands are promoted to float32 on load and each output is
// rounded once, on store.
#include <cuda.h>
#include <type_traits>

#include "forward.cuh"

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
  const float* scale;       // int8: () on the card, or null for scale_val
  const int* seed;          // int8: () on the card, or null for seed_val
  void* events;             // (B, M) out
  void* v_out;              // (B, M) out
  void* trace_post_out;     // (B, M) out
  void* w_out;              // (N, M) out
  int batch, n, m, plastic, spiking;
  float w_clip;
  ff::FParams f;
  ff::QParams q;            // inv1 / inv2 of this batch
  int theta_bf16;           // bfloat16 kernel: theta is bfloat16
  float scale_val;
  int seed_val;
  // the launch's plan (kernel.py shared_step_plan)
  int cols;                 // columns of a tile
  int split;                // CTAs of a cluster sharing a tile's fan-in
  int rows;                 // input rows of a CTA (the last: what is left)
  int threads;
  int vec;                  // weights of a thread's piece (1: one weight)
  int chunk_rows;           // rows of a TMA box and of a rule chunk
  int stages;               // rule chunks held at once (0: rule not staged)
  int stage_x;              // 1: input events and pre traces staged
  int w_route, w_width;     // slab.cuh Route and piece bytes of w
  int th_route, th_width;   // the same for the rule
  int smem;                 // the wrapper's count of shared memory
};

namespace {

// The kernel's parameter: the arguments and the TMA maps of w and of the
// rule viewed as (4 N, M), where their route is kTma.
struct Params {
  SharedStepArgs a;
  CUtensorMap w_map;
  CUtensorMap th_map;
};
static_assert(sizeof(Params) <= 4096, "kernel parameters exceed 4 KB");

// Shared-memory layout (bytes); kernel.py shared_step_plan counts the same
// and the launcher refuses a launch whose total disagrees.
struct Layout {
  size_t w, th, stage, xs, pres, ps, tp, post, red, bars, total;
  int pw, pt, chunks;
};

__host__ __device__ inline Layout layout(const SharedStepArgs& a, int we,
                                         int sb, int tb) {
  Layout l;
  const size_t B = a.batch, c = a.cols, R = a.chunk_rows;
  l.pw = a.w_route == kBulk ? a.m : a.cols;
  l.pt = a.th_route == kBulk ? a.m : a.cols;
  l.chunks = (a.rows + a.chunk_rows - 1) / a.chunk_rows;
  size_t off = 0;
  l.w = off;
  off += align_up((size_t)l.chunks * R * l.pw * we, 128);
  l.th = off;
  l.stage = staged(a.th_route) ? align_up(4 * R * l.pt * tb, 128) : 0;
  off += (size_t)a.stages * l.stage;
  l.xs = off;
  if (a.stage_x) off += align_up(B * a.rows * sb, 16);
  l.pres = off;
  if (a.stage_x) off += align_up(B * a.rows * sb, 16);
  l.ps = off;
  off += align_up(B * c * 4, 16);
  l.tp = off;
  off += align_up(B * c * 4, 16);
  l.post = off;
  off += align_up(c * 4, 16);
  l.red = off;
  off += align_up((size_t)(a.threads / 32) * kChunk * c * 4, 16);
  l.bars = off;
  off += align_up((size_t)(1 + a.stages) * 8, 16);
  l.total = off + 128;                // slack to align the base to 128
  return l;
}

// ff::plastic_q_coef with the row's pre term already scaled, and dw / scale
// as dw * inv where inv = 1 / scale is exact (a power-of-two scale; else
// inv is 0 and the division is IEEE's): the same correctly rounded steps.
__device__ __forceinline__ int plastic_q_row(int w, const float* coef,
                                            int hebb, float pre_f, int post,
                                            float scale, float inv, int qmax,
                                            int seed, int idx,
                                            const ff::QParams& q) {
  const float dw = ff::four_term(
      coef[0], coef[1], coef[2], coef[3],
      __fmul_rn(__int2float_rn(hebb), q.inv2), pre_f,
      __fmul_rn(__int2float_rn(post), q.inv1));
  const float st = inv != 0.0f ? __fmul_rn(dw, inv) : __fdiv_rn(dw, scale);
  return ff::q_steps_clip(w, st, qmax, seed, idx, q);
}

// S and W: the compute types; G and WG: state and weights in device memory
// (T = float | bfloat16 on the float path); TH: the rule's type; V: weights
// of a thread's piece.
template <bool Q, typename T, typename TH, int V>
__global__ void __launch_bounds__(512, 1)
shared_step_kernel(const __grid_constant__ Params p) {
  using ff::cvt;
  using S = typename Types<Q>::S;
  using G = std::conditional_t<Q, int, T>;
  using WG = std::conditional_t<Q, int8_t, T>;
  constexpr int kG = V < 4 ? V : 4;       // synapses a rule load covers
  const SharedStepArgs& a = p.a;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int we = sizeof(WG), tb = sizeof(TH);
  const Layout lay = layout(a, we, sizeof(G), tb);

  // ---- this CTA: columns [col0, col0 + own) of rows [r0, r0 + rows) -----
  const int B = a.batch, N = a.n, M = a.m, c = a.cols, R = a.chunk_rows;
  const int split = a.split, rank = split > 1 ? cluster_rank() : 0;
  const int col0 = blockIdx.x * c, own = min(c, M - col0);
  const int r0 = rank * a.rows, rows = min(a.rows, N - r0);
  const int chunks = (rows + R - 1) / R;
  const int tid = threadIdx.x, T_ = blockDim.x;
  const bool plastic = a.plastic != 0;
  const int th_route = a.th_route, stages = a.stages;
  // where one thread issues the rule's copies (TMA, bulk), it is lane 0 of
  // a warp of its own, which waits out the copy engine's queue while the
  // other TC threads stage the rows and run the forward pass
  const bool lone =
      plastic && (th_route == kTma || th_route == kBulk) && T_ > 32;
  const int TC = lone ? T_ - 32 : T_, issuer = lone ? TC : 0;
  const bool fwd = tid < TC;
  // the update's pieces: V weights (16 bytes) of a row a thread
  const int P = c / V, pj = (tid % P) * V, lr = tid / P, L = T_ / P;
  // the psum's pieces: kF weights of a row a lane (forward.cuh)
  constexpr int kF = V < 4 ? V : 4;
  const int pw = lay.pw, pt = lay.pt;
  const bool ring = staged(th_route) && stages < chunks;

  WG* ws = (WG*)(smem + lay.w);
  unsigned char* th_s = smem + lay.th;
  G* xs_s = (G*)(smem + lay.xs);
  G* pre_s = (G*)(smem + lay.pres);
  S* ps = (S*)(smem + lay.ps);
  S* tp_s = (S*)(smem + lay.tp);
  S* post_s = (S*)(smem + lay.post);
  S* red = (S*)(smem + lay.red);
  const uint32_t bar_w = smem_u32(smem + lay.bars);
  auto bar_th = [&](int s) { return bar_w + 8u * (uint32_t)(1 + s); };

  // ---- issue every load at once --------------------------------------------
  if (tid == 0) {
    mbar_init(bar_w, a.w_route == kCpAsync ? TC : 1);
    for (int s = 0; s < stages; ++s)
      mbar_init(bar_th(s), th_route == kCpAsync ? T_ : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  issue_slab((unsigned char*)ws, a.w, &p.w_map, a.w_route, a.w_width, bar_w,
             r0, rows, M, c, own, col0, R, chunks, we, tid, fwd ? TC : 0);
  // rule chunk k into stage s (every thread calls it; the issuer alone
  // acts on a TMA or bulk route)
  const unsigned char* th_in = (const unsigned char*)a.theta;
  auto issue_theta = [&](int k, int s) {
    unsigned char* dst = th_s + (long)s * lay.stage;
    const int rk = min(R, rows - k * R);
    if (th_route == kTma) {
      if (tid == issuer) {
        mbar_expect_tx(bar_th(s), 4 * R * c * tb);
        for (int q = 0; q < 4; ++q)
          tma_load_2d(smem_u32(dst + (long)q * R * c * tb), &p.th_map,
                      bar_th(s), col0, q * N + r0 + k * R);
      }
    } else if (th_route == kBulk) {
      if (tid == issuer) {
        const uint32_t bytes = (uint32_t)rk * M * tb;
        mbar_expect_tx(bar_th(s), 4 * bytes);
        for (int q = 0; q < 4; ++q)
          bulk_load(dst + (long)q * R * M * tb,
                    th_in + ((long)q * N + r0 + k * R) * M * tb, bytes,
                    bar_th(s));
      }
    } else {
      for (int q = 0; q < 4; ++q)
        copy_async(dst + (long)q * R * c * tb,
                   th_in + ((long)q * N + r0 + k * R) * M * tb, rk, M, c,
                   own, col0, tb, kCpAsync, a.th_width, 0, T_);
      cp_async_arrive(bar_th(s));
    }
  };
  if (plastic && staged(th_route))
    for (int k = 0; k < min(stages, chunks); ++k) issue_theta(k, k);

  // the rows' events and pre traces, and w where no copy engine takes it
  const G* x_in = (const G*)a.x;
  const G* pre_in = (const G*)a.trace_pre;
  if (a.stage_x && fwd) {
    for (int e = tid; e < B * rows; e += TC) {
      const int b = e / rows, r = e - b * rows;
      xs_s[e] = x_in[(long)b * N + r0 + r];
      if (plastic) pre_s[e] = pre_in[(long)b * N + r0 + r];
    }
  }
  if (a.w_route == kL2 && fwd)
    fill_slab(ws, (const WG*)a.w, r0, rows, M, c, own, col0, tid, TC);
  // the thread's first neuron's operands, fetched while the slabs land
  S v0 = S(0), tpo0 = S(0), teach0 = S(0);
  const bool have0 = fwd && tid < B * c && tid % c < own;
  if (have0) {
    const long g = (long)(tid / c) * M + col0 + tid % c;
    v0 = cvt<S>(((const G*)a.v)[g]);
    tpo0 = cvt<S>(((const G*)a.trace_post)[g]);
    if (a.teach) teach0 = ((const S*)a.teach)[g];
  }
  const G* xs = a.stage_x ? xs_s : x_in + r0;
  const G* pres = a.stage_x ? pre_s : pre_in + r0;
  const long xstride = a.stage_x ? rows : N;
  const float sc = Q ? (a.scale ? *a.scale : a.scale_val) : 0.0f;
  const int seed = Q ? (a.seed ? *a.seed : a.seed_val) : 0;

  // ---- 1. Forward Engine: this CTA's partial psums of every batch row ------
  if (fwd) {
    sync_first(TC);
    if (staged(a.w_route)) mbar_wait(bar_w, 0);
    for (int b0 = 0; b0 < B; b0 += kChunk)
      forward_psums<Q, kF>(ps + b0 * c, red, ws, pw, xs + b0 * xstride,
                           xstride, rows, min(kChunk, B - b0), c, tid, TC);
  }

  // ---- the cluster's partials in rank order; neuron and trace -------------
  if (split > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  const uint32_t ps_addr = smem_u32(ps);
  for (int e = tid; e < B * c; e += T_) {
    const int b = e / c, j = e - b * c;
    S tp = S(0);
    if (j < own) {
      S s = split > 1 ? fold_peers<Q, S>(ps_addr + 4 * e, split) : ps[e];
      const long g = (long)b * M + col0 + j;
      const bool first = e == tid && have0;
      const S vv = first ? v0 : cvt<S>(((const G*)a.v)[g]);
      const S tpo = first ? tpo0 : cvt<S>(((const G*)a.trace_post)[g]);
      S ev, vn;
      if constexpr (Q) {
        int i_fx = ff::current_fx(s, sc);
        if (a.teach)
          i_fx = ff::wadd(i_fx, first ? teach0 : ((const int*)a.teach)[g]);
        ff::neuron_q(vv, i_fx, a.spiking, a.q, &ev, &vn);
        tp = ff::trace_q(tpo, ev, a.q);
      } else {
        if (a.teach) s = s + (first ? teach0 : ((const float*)a.teach)[g]);
        ff::neuron_f(vv, s, a.spiking, a.f, &ev, &vn);
        tp = __fmaf_rn(a.f.decay, tpo, ev);
      }
      if (rank == 0) {
        ((G*)a.events)[g] = cvt<G>(ev);
        ((G*)a.v_out)[g] = cvt<G>(vn);
        ((G*)a.trace_post_out)[g] = cvt<G>(tp);
      }
    }
    tp_s[e] = tp;
  }
  if (split > 1) cluster_arrive();    // done reading the peers' partials
  __syncthreads();
  const float fb = (float)B;
  for (int j = tid; j < c; j += T_) {
    S s = S(0);
    for (int b = 0; b < B; ++b) {
      if constexpr (Q) s = ff::wadd(s, tp_s[b * c + j]);
      else s = s + tp_s[b * c + j];
    }
    if constexpr (Q) post_s[j] = s;
    else post_s[j] = B == 1 ? s : __fdiv_rn(s, fb);
  }
  __syncthreads();

  // ---- 2. Plasticity Engine: this CTA's synapses, piece by piece ----------
  int qmax = 0;
  float inv = 0.0f;
  if constexpr (Q) {
    qmax = ff::qclip(a.w_clip, sc);
    inv = ff::exact_inverse(sc);
  }
  WG* w_out = (WG*)a.w_out;
  // the piece [pj, pj + V) of row r; the rule's planes at th + q * plane
  auto update = [&](int r, const TH* th, long plane) {
    S wv[V];
    load_cvt<V>(wv, ws + (long)r * pw + pj);
    WG out[V];
    if (plastic) {
      S hebb[V], pre = S(0);
#pragma unroll
      for (int v = 0; v < V; ++v) hebb[v] = S(0);
      for (int b = 0; b < B; ++b) {
        const S x = cvt<S>(pres[b * xstride + r]);
        S tp[V];
        lds<V>(tp, tp_s + b * c + pj);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if constexpr (Q) hebb[v] = ff::wadd(hebb[v], ff::wmul(x, tp[v]));
          else hebb[v] = hebb[v] + x * tp[v];
        }
        if constexpr (Q) pre = ff::wadd(pre, x);
        else pre = pre + x;
      }
      float pre_f;
      if constexpr (Q) pre_f = __fmul_rn(__int2float_rn(pre), a.q.inv1);
      else pre_f = B == 1 ? pre : __fdiv_rn(pre, fb);
#pragma unroll
      for (int g0 = 0; g0 < V; g0 += kG) {
        TH t[4][kG];
#pragma unroll
        for (int q = 0; q < 4; ++q) lds<kG>(t[q], th + q * plane + pj + g0);
#pragma unroll
        for (int v = 0; v < kG; ++v) {
          const float coef[4] = {cvt<float>(t[0][v]), cvt<float>(t[1][v]),
                                 cvt<float>(t[2][v]), cvt<float>(t[3][v])};
          const int jv = pj + g0 + v;
          if constexpr (Q)
            out[g0 + v] = (int8_t)plastic_q_row(
                wv[g0 + v], coef, hebb[g0 + v], pre_f, post_s[jv], sc, inv,
                qmax, seed, (r0 + r) * M + col0 + jv, a.q);
          else
            out[g0 + v] = cvt<WG>(ff::plastic_f_coef(
                wv[g0 + v], coef,
                B == 1 ? hebb[g0 + v] : __fdiv_rn(hebb[g0 + v], fb), pre_f,
                post_s[jv], a.w_clip));
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = cvt<WG>(wv[v]);
    }
    WG* dst = w_out + (long)(r0 + r) * M + col0 + pj;
    if (V > 1 && pj + V <= own) {
      st_vec<V>(dst, out);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (pj + v < own) dst[v] = out[v];
    }
  };
  const TH* th_g = (const TH*)a.theta + (long)r0 * M + col0;  // through L2
  if (pj < own) {
    if (!plastic || !staged(th_route)) {
      for (int r = lr; r < rows; r += L)
        update(r, th_g + (long)r * M, (long)N * M);
    } else if (!ring) {               // every chunk resident
      for (int k = lr / R; k < chunks; ++k) mbar_wait(bar_th(k), 0);
#pragma unroll 2
      for (int r = lr; r < rows; r += L) {
        const int k = r / R;
        update(r, (const TH*)(th_s + (long)k * lay.stage) +
                      (long)(r - k * R) * pt,
               (long)R * pt);
      }
    }
  }
  if (plastic && ring) {              // chunk by chunk through the stages
    for (int k = 0; k < chunks; ++k) {
      const int s = k % stages;
      mbar_wait(bar_th(s), (uint32_t)((k / stages) & 1));
      const TH* th = (const TH*)(th_s + (long)s * lay.stage);
      if (pj < own)
        for (int r = k * R + lr; r < min(rows, (k + 1) * R); r += L)
          update(r, th + (long)(r - k * R) * pt, (long)R * pt);
      if (k + stages < chunks) {
        __syncthreads();              // every thread has left stage s
        if (tid == 0) fence_async_shared();
        issue_theta(k + stages, s);
      }
    }
  }
  if (split > 1) cluster_wait();      // the peers are done with this CTA
}

// ---- host side ------------------------------------------------------------

// The plan's constraints (kernel.py shared_step_plan builds them).
bool valid(const SharedStepArgs* a, int pv, int we, int tb) {
  if (!route_ok(a->w_route, a->w_width, a->n, a->m, a->cols, we) ||
      (a->plastic && a->th_route != kL2 &&
       !route_ok(a->th_route, a->th_width, a->n, a->m, a->cols, tb)))
    return false;
  const int c = a->cols, v = a->vec;
  const int pieces = v > 0 ? c / v : 0;
  const bool th_ok = a->plastic
                         ? (staged(a->th_route) ? a->stages >= 1
                                                : a->th_route == kL2 &&
                                                      a->stages == 0)
                         : a->th_route == kNone && a->stages == 0;
  return a->batch >= 1 && a->n >= 1 && a->m >= 1 && (v == 1 || v == pv) &&
         c >= v && c % v == 0 && pieces <= 32 &&
         (pieces & (pieces - 1)) == 0 && a->threads >= 32 &&
         a->threads <= 512 && a->threads % 32 == 0 &&
         a->threads % pieces == 0 && a->split >= 1 && a->split <= 8 &&
         a->rows >= 1 && a->rows % 8 == 0 &&
         (long)a->split * a->rows >= a->n &&
         (long)(a->split - 1) * a->rows < a->n && a->chunk_rows >= 1 &&
         a->chunk_rows <= 256 &&
         ((a->w_route != kBulk && a->th_route != kBulk) ||
          (a->chunk_rows % 16 == 0 && a->rows % 16 == 0)) &&
         (staged(a->w_route) || a->w_route == kL2) && th_ok;
}

// Launches the instantiation, or (with `blocks`) lets it use the card's
// shared memory and asks how many of its CTAs one SM holds and, for a
// cluster launch, how many clusters the card holds at once.
template <bool Q, typename T, typename TH, int V>
int run(const SharedStepArgs* a, int* blocks, int* clusters,
        cudaStream_t stream) {
  using G = std::conditional_t<Q, int, T>;
  using WG = std::conditional_t<Q, int8_t, T>;
  const int we = sizeof(WG), tb = sizeof(TH);
  const Layout l = layout(*a, we, sizeof(G), tb);
  if ((int)l.total != a->smem) return (int)cudaErrorInvalidValue;
  auto kernel = shared_step_kernel<Q, T, TH, V>;
  const unsigned tiles = (unsigned)((a->m + a->cols - 1) / a->cols);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, (unsigned)a->split);
  cfg.blockDim = dim3((unsigned)a->threads);
  cfg.dynamicSmemBytes = (size_t)a->smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (a->split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = (unsigned)a->split;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t err;
  if (blocks != nullptr) {
    int device = 0, optin = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             blocks, kernel, a->threads, (size_t)a->smem)) != cudaSuccess)
      return (int)err;
    *clusters = 0;
    if (a->split > 1)
      return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    return (int)cudaSuccess;
  }
  if ((a->theta != nullptr) != (a->plastic != 0))
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.a = *a;
  if (a->w_route == kTma &&
      !encode(&prm.w_map, a->w, a->n, a->m, we, a->cols, a->chunk_rows))
    return (int)cudaErrorInvalidValue;
  if (a->plastic && a->th_route == kTma &&
      !encode(&prm.th_map, a->theta, 4 * a->n, a->m, tb, a->cols,
              a->chunk_rows))
    return (int)cudaErrorInvalidValue;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, prm)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

template <bool Q, typename T, typename TH, int PV>
int run_vec(const SharedStepArgs* a, int* blocks, int* clusters,
            cudaStream_t stream) {
  if (!valid(a, PV, Q ? 1 : (int)sizeof(T), (int)sizeof(TH)))
    return (int)cudaErrorInvalidValue;
  return a->vec == 1 ? run<Q, T, TH, 1>(a, blocks, clusters, stream)
                     : run<Q, T, TH, PV>(a, blocks, clusters, stream);
}

// kind 0: float32, 1: bfloat16, 2: int8.
int dispatch(const SharedStepArgs* a, int kind, int* blocks, int* clusters,
             cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  switch (kind) {
    case 0:
      return run_vec<false, float, float, 4>(a, blocks, clusters, stream);
    case 1:
      return a->theta_bf16
                 ? run_vec<false, bf16, bf16, 8>(a, blocks, clusters, stream)
                 : run_vec<false, bf16, float, 8>(a, blocks, clusters, stream);
    case 2:
      return run_vec<true, float, float, 16>(a, blocks, clusters, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int shared_step_f32(const SharedStepArgs* a, cudaStream_t stream) {
  return dispatch(a, 0, nullptr, nullptr, stream);
}

extern "C" int shared_step_bf16(const SharedStepArgs* a,
                                cudaStream_t stream) {
  return dispatch(a, 1, nullptr, nullptr, stream);
}

extern "C" int shared_step_q(const SharedStepArgs* a, cudaStream_t stream) {
  return dispatch(a, 2, nullptr, nullptr, stream);
}

// The instantiation `a` and kind (as `dispatch`) select may use the card's
// shared memory; CTAs of it one SM holds, and clusters the card holds (0
// without a cluster).
extern "C" int shared_step_occupancy(const SharedStepArgs* a, int kind,
                                     int* blocks, int* clusters) {
  return dispatch(a, kind, blocks, clusters, nullptr);
}
