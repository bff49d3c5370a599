// The Forward Engine of the shared-weight step kernels: a CTA's partial
// psums of B input rows over its slab of w (`cols` columns of `rows`
// consecutive input rows), folded in one fixed order, with no atomics.
// Shared by the plastic step (shared_step.cu, #4 and #5) and the forward
// pass without plasticity (lif_forward.cu, #6):
//  * the w slab issued at once on one mbarrier (slab.cuh's routes: 2-D TMA
//    boxes, one 1-D bulk copy, cp.async pieces), or by plain loads where no
//    copy engine takes the rows; `stage_rows`: a CTA's input events;
//  * `psum_rows`: a lane sums a piece of up to 4 weights of a row over
//    strided rows of the fan-in, for up to kChunk batch rows at once;
//  * `warp_fold`: the lanes sharing a piece fold by a reduce-scatter of
//    warp shuffles; `fold_warps`: the warps in warp order;
//  * `fold_peers`: the CTAs of a thread-block cluster in rank order,
//    every peer's partial loaded through distributed shared memory at once.
// bfloat16 weights and events are promoted to float32 on load; integer sums
// wrap in 32 bits (ff::wadd, ff::wmul) and are order-free.
#pragma once

#include "slab.cuh"

namespace {

// Batch rows of one psum pass: with a lane's piece of at most 4 weights,
// at most 32 partial sums a thread.
constexpr int kChunk = 8;

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

__host__ __device__ inline bool staged(int route) {
  return route == kTma || route == kBulk || route == kCpAsync;
}

// A plane's route against its rows: TMA's 16-byte rules, one contiguous
// block for a bulk copy, whole pieces for cp.async.
bool route_ok(int route, int width, long n, int m, int c, int e) {
  switch (route) {
    case kTma: return (m * e) % 16 == 0 && (c * e) % 16 == 0 && c <= 256;
    case kBulk: return c >= m && (n * m * e) % 16 == 0 && (m * e) % 16 != 0;
    case kCpAsync:
      return (width == 4 || width == 8 || width == 16) &&
             (m * e) % width == 0 && (c * e) % width == 0;
    default: return route == kL2;
  }
}

// ---- clusters ---------------------------------------------------------------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The .aligned forms need the whole warp converged (a lane may have
// issued copies alone just before).
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A 4-byte word of CTA `rank`'s shared memory at this CTA's address `addr`.
template <typename S>
__device__ __forceinline__ S ld_peer(uint32_t addr, int rank) {
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.b32 %0, [%1];\n"
               : "=r"(v) : "r"(remote) : "memory");
  S s;
  memcpy(&s, &v, 4);
  return s;
}

// Barrier 1 over threads [0, n) (n a multiple of 32).
__device__ __forceinline__ void sync_first(int n) {
  __syncwarp();
  asm volatile("bar.sync 1, %0;\n" :: "r"(n) : "memory");
}

// The thread's cp.async copies so far arrive on `bar` when they land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// ---- the w slab -------------------------------------------------------------
// Issue the CTA's block of w, rows [r0, r0 + rows) x columns [col0, col0 +
// own) of the row-major (n, m) plane, into ws on `bar` (initialised for 1
// arrival, threads [0, nt) for cp.async): `chunks` TMA boxes of R rows
// (thread 0), one bulk copy of whole rows (thread 0), or cp.async pieces of
// `width` bytes (threads [0, nt)).  The kL2 route loads nothing here
// (`fill_slab`).
__device__ __forceinline__ void issue_slab(unsigned char* ws, const void* w,
                                           const CUtensorMap* map, int route,
                                           int width, uint32_t bar, int r0,
                                           int rows, int m, int c, int own,
                                           int col0, int R, int chunks,
                                           int e, int tid, int nt) {
  const unsigned char* w_in = (const unsigned char*)w;
  if (route == kTma) {
    if (tid == 0) {
      mbar_expect_tx(bar, chunks * R * c * e);
      for (int k = 0; k < chunks; ++k)
        tma_load_2d(smem_u32(ws + (long)k * R * c * e), map, bar, col0,
                    r0 + k * R);
    }
  } else if (route == kBulk) {
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)rows * m * e;
      mbar_expect_tx(bar, bytes);
      bulk_load(ws, w_in + (long)r0 * m * e, bytes, bar);
    }
  } else if (route == kCpAsync && tid < nt) {
    copy_async(ws, w_in + (long)r0 * m * e, rows, m, c, own, col0, e,
               kCpAsync, width, 0, nt);
    cp_async_arrive(bar);
  }
}

// The kL2 route: the block by plain loads into ws[rows][c], zeros past
// `own`, by threads [0, nt).
template <typename WG>
__device__ __forceinline__ void fill_slab(WG* ws, const WG* w, int r0,
                                          int rows, int m, int c, int own,
                                          int col0, int tid, int nt) {
  for (int o = tid; o < rows * c; o += nt) {
    const int r = o / c, j = o - r * c;
    ws[o] = j < own ? w[(long)(r0 + r) * m + col0 + j] : WG(0);
  }
}

// The events of rows [r0, r0 + rows) of B input rows (row stride k) into
// xs[b][rows], by threads [0, nt): kStage loads in flight a thread before
// their stores (a store to shared memory would otherwise wait for each
// load in turn: the compiler cannot tell the two apart).
template <typename G>
__device__ __forceinline__ void stage_rows(G* xs, const G* x, int batch,
                                           int rows, int k, int r0, int tid,
                                           int nt) {
  constexpr int kStage = 8;
  const int n = batch * rows;
  for (int i0 = tid; i0 < n; i0 += kStage * nt) {
    G v[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = i0 + q * nt, b = i / rows;
      if (i < n) v[q] = x[(long)b * k + r0 + (i - b * rows)];
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q)
      if (i0 + q * nt < n) xs[i0 + q * nt] = v[q];
  }
}

// ---- vector loads -----------------------------------------------------------
// N elements from 16-byte aligned memory (8-byte for 8 bytes), as few loads
// as their bytes allow.
template <int N, typename X>
__device__ __forceinline__ void lds(X* dst, const X* src) {
  constexpr int kBytes = N * (int)sizeof(X);
  if constexpr (kBytes > 16) {
    constexpr int kPer = 16 / (int)sizeof(X);
#pragma unroll
    for (int i = 0; i < N / kPer; ++i)
      ld_vec<kPer>(dst + i * kPer, src + i * kPer);
  } else {
    ld_vec<N>(dst, src);
  }
}

// N weights of type WG converted to the compute type S.
template <int N, typename S, typename WG>
__device__ __forceinline__ void load_cvt(S* dst, const WG* src) {
  WG raw[N];
  lds<N>(raw, src);
#pragma unroll
  for (int v = 0; v < N; ++v) dst[v] = ff::cvt<S>(raw[v]);
}

template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}

// ---- the psum ---------------------------------------------------------------
// Partial psums of U batch rows (nb real) over the piece [pj, pj + V) of
// the w slab (pitch pw), rows lr, lr + L, ... < rows; xs holds the rows'
// events at b * xstride + r in their device type.
template <bool Q, int U, int V, typename S, typename WG, typename G>
__device__ __forceinline__ void psum_rows(S (&acc)[U][V], const WG* ws,
                                          int pw, const G* xs, long xstride,
                                          int rows, int lr, int L, int pj,
                                          int nb) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[u][v] = S(0);
#pragma unroll 4
  for (int r = lr; r < rows; r += L) {
    S wv[V];
    load_cvt<V>(wv, ws + (long)r * pw + pj);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (U == 1 || u < nb) {
        const S xv = ff::cvt<S>(xs[u * xstride + r]);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if constexpr (Q) acc[u][v] = ff::wadd(acc[u][v], ff::wmul(xv, wv[v]));
          else acc[u][v] = acc[u][v] + xv * wv[v];
        }
      }
    }
  }
}

// One level of warp_fold's reduce-scatter at xor distance 16 >> L, then
// the next; f holds the lane's K >> L sums still being folded.
template <bool Q, int K, int L, typename S>
__device__ __forceinline__ void fold_level(S (&f)[K], int& base, int& n,
                                           int lane, int P) {
  if constexpr (L < 5) {
    constexpr int off = 16 >> L;
    if (off < P) return;
    const bool up = (lane & off) != 0;
    if constexpr ((K >> L) >= 2) {
      constexpr int half = K >> (L + 1);
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const S keep = up ? f[i + half] : f[i];
        const S give = up ? f[i] : f[i + half];
        const S got = shfl_xor(give, off);
        if constexpr (Q) f[i] = ff::wadd(keep, got);
        else f[i] = keep + got;
      }
      if (up) base += half;
      n = half;
    } else {
      const S got = shfl_xor(f[0], off);
      if constexpr (Q) f[0] = ff::wadd(f[0], got);
      else f[0] = f[0] + got;
    }
    fold_level<Q, K, L + 1>(f, base, n, lane, P);
  }
}

// The lanes sharing this lane's piece (lane % P) fold its U x V sums by a
// reduce-scatter: at each xor distance 16, 8, ..., P a lane keeps one half
// of its sums (the upper where its lane bit is set), adds its partner's
// copy of that half and sends the other, so the shuffles halve level by
// level; once one sum is left the levels add it across (both partners get
// the same sum).  The adds run in one fixed order, the same bits on every
// run.  Each lane then writes the sums it holds, [base, base + n), to
// red[warp][u][column].
template <bool Q, int U, int V, typename S>
__device__ __forceinline__ void warp_fold(S (&acc)[U][V], S* red, int P,
                                          int c, int lane, int warp,
                                          int pj) {
  constexpr int K = U * V;
  S f[K];
#pragma unroll
  for (int i = 0; i < K; ++i) f[i] = acc[i / V][i % V];
  int base = 0, n = K;
  fold_level<Q, K, 0>(f, base, n, lane, P);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < n) {
      const int k = base + i;
      red[(warp * kChunk + k / V) * c + pj + k % V] = f[i];
    }
  }
}

// This CTA's partial psums of nb <= kChunk batch rows (events xs[u *
// xstride + r]) into ps[u][c], by threads [0, TC): a lane's piece of kF
// weights over strided rows, the lanes folded by `warp_fold`, then the
// warps in warp order.  Ends with barrier 1 over the TC threads.
template <bool Q, int kF, typename S, typename WG, typename G>
__device__ __forceinline__ void forward_psums(S* ps, S* red, const WG* ws,
                                              int pw, const G* xs,
                                              long xstride, int rows, int nb,
                                              int c, int tid, int TC) {
  const int lane = tid & 31, warp = tid >> 5;
  const int fP = c / kF, fj = (tid % fP) * kF, flr = tid / fP, fL = TC / fP;
  if (nb == 1) {
    S acc[1][kF];
    psum_rows<Q, 1, kF>(acc, ws, pw, xs, xstride, rows, flr, fL, fj, 1);
    warp_fold<Q, 1, kF>(acc, red, fP, c, lane, warp, fj);
  } else {
    S acc[kChunk][kF];
    psum_rows<Q, kChunk, kF>(acc, ws, pw, xs, xstride, rows, flr, fL, fj,
                             nb);
    warp_fold<Q, kChunk, kF>(acc, red, fP, c, lane, warp, fj);
  }
  sync_first(TC);
  for (int e = tid; e < nb * c; e += TC) {
    const int u = e / c, j = e - u * c;
    S s = red[u * c + j];
    for (int wp = 1; wp < TC / 32; ++wp) {
      if constexpr (Q) s = ff::wadd(s, red[(wp * kChunk + u) * c + j]);
      else s = s + red[(wp * kChunk + u) * c + j];
    }
    ps[u * c + j] = s;
  }
  sync_first(TC);
}

// The psum of one neuron: the cluster's `split` partials at this CTA's
// shared address `addr`, every peer's load in flight at once, added in
// rank order.
template <bool Q, typename S>
__device__ __forceinline__ S fold_peers(uint32_t addr, int split) {
  S part[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (q < split) part[q] = ld_peer<S>(addr, q);
  S s = part[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) {
    if (q >= split) break;
    if constexpr (Q) s = ff::wadd(s, part[q]);
    else s = s + part[q];
  }
  return s;
}

}  // namespace
