// Device pieces shared by the two fleet kernels, the per-step fleet_step.cu
// and the time-fused rollout.cu: one layer's thread split, a stream's arrays
// copied into shared memory (1-D bulk copies on an mbarrier, cp.async for
// the rest), the group barrier, the Forward Engine's fan-in split across
// lanes and the Plasticity Engine's walk over a stream's synapses in
// 16-byte chunks.  The arithmetic is plasticity.cuh's, operation for
// operation.
#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "plasticity.cuh"

namespace {

using ff::Types;

constexpr int kMaxThreads = 1024;
constexpr int kMaxBarrierGroups = 15;   // named barriers 1..15
constexpr int kBarBytes = 16;           // two 8-byte mbarriers

inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

int floor_log2(int x) {
  int l = 0;
  while (x >>= 1) ++l;
  return l;
}

// One layer's constants for a launch.
struct LayerPlan {
  int n, m, nm;
  int lg_r;          // log2 of the lanes that split a column's rows
  int cmaj;          // 1: one warp, lane = column + M * split (M = 2^k < 32)
  int vec;           // synapses per update chunk: 4, or 1 when M % 4 != 0
  int d_row, d_col;  // the update's stride of vec * T synapses as rows, cols
  int w, v;          // byte offsets of w_i and v_i in a state buffer
  int th;            // byte offset of the resident rule, or -1 (L2)
  int flags;         // 1: plastic, 2: spiking
};

// The split of an n x m layer over a group of `threads` threads.  A
// power-of-two M < 32 takes the group's last warp, adjacent lanes on
// adjacent columns: 32 distinct banks a load.  Any other M < T splits rows
// across adjacent lanes of every warp; M >= T gives each thread whole
// columns.  The update walks chunks of 4 synapses where M % 4 == 0.
void split_layer(LayerPlan& lp, int n, int m, int threads) {
  lp.n = n;
  lp.m = m;
  lp.nm = n * m;
  lp.cmaj = m < 32 && (m & (m - 1)) == 0;
  lp.lg_r = lp.cmaj ? 5 - floor_log2(m)
            : m >= threads ? 0
            : floor_log2(threads / m < 32 ? threads / m : 32);
  lp.vec = m % 4 == 0 ? 4 : 1;
  lp.d_row = lp.vec * threads / m;
  lp.d_col = lp.vec * threads % m;
}

// One per-stream array: stream s's copy is at in + s * raw in device memory
// (out + s * raw for the write-back; null for an input alone), at byte
// offset `off` of a state buffer in the compute type and `soff` of the
// buffer it is fetched into.
struct Seg {
  const void* in;
  void* out;
  int raw, count, off, soff;
  int fetch16, store16;   // whole 16-byte pieces from every stream's start
};

// ---- copies -----------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// `bytes` not in whole 16-byte pieces from device memory into shared
// memory by threads [0, nt): cp.async in 4-byte pieces where both ends and
// the length allow, else byte by byte (synchronously).
__device__ inline void fetch_bytes(unsigned char* dst,
                                   const unsigned char* src, int bytes,
                                   int gt, int nt) {
  if ((((uintptr_t)dst | (uintptr_t)src | (uintptr_t)bytes) & 3) == 0) {
    for (int o = 4 * gt; o < bytes; o += 4 * nt) cp_async4(dst + o, src + o);
  } else {
    for (int o = gt; o < bytes; o += nt) dst[o] = src[o];
  }
}

// The group's barrier: its warp alone, or named barrier 1 + group.
__device__ __forceinline__ void group_sync(int group, int nt) {
  if (nt == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(nt) : "memory");
}

// Eight bfloat16 <-> eight floats.
__device__ __forceinline__ void bf16x8_to_f32(const uint4& r, float* f) {
  const __nv_bfloat162* h = (const __nv_bfloat162*)&r;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 x = __bfloat1622float2(h[u]);
    f[2 * u] = x.x;
    f[2 * u + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 f32x8_to_bf16(const float* f) {
  uint4 r;
  __nv_bfloat162* h = (__nv_bfloat162*)&r;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    h[u] = __halves2bfloat162(__float2bfloat16_rn(f[2 * u]),
                              __float2bfloat16_rn(f[2 * u + 1]));
  return r;
}

// `count` elements converted from S to D (16-byte aligned shared memory at
// the float32 end): 16-byte pieces where `vec` says the other end allows,
// then the tail one element at a time.  Moves a stream's state between
// device memory and shared memory, and promotes a staged bfloat16 stream.
template <typename D, typename S>
__device__ inline void convert_copy(D* __restrict__ dst,
                                    const S* __restrict__ src, int count,
                                    bool vec, int gt, int nt) {
  if constexpr (std::is_same_v<D, S>) {
    constexpr int kPer = 16 / sizeof(D);
    const int cv = vec ? count / kPer * kPer : 0;
    for (int o = kPer * gt; o < cv; o += kPer * nt)
      *(int4*)(dst + o) = *(const int4*)(src + o);
    for (int o = cv + gt; o < count; o += nt) dst[o] = src[o];
  } else if constexpr (std::is_same_v<D, float>) {   // bfloat16 -> float
    const int cv = vec ? count & ~7 : 0;
    for (int o = 8 * gt; o < cv; o += 8 * nt) {
      float f[8];
      bf16x8_to_f32(*(const uint4*)(src + o), f);
      *(float4*)(dst + o) = make_float4(f[0], f[1], f[2], f[3]);
      *(float4*)(dst + o + 4) = make_float4(f[4], f[5], f[6], f[7]);
    }
    for (int o = cv + gt; o < count; o += nt) dst[o] = ff::cvt<D>(src[o]);
  } else {                                            // float -> bfloat16
    const int cv = vec ? count & ~7 : 0;
    for (int o = 8 * gt; o < cv; o += 8 * nt)
      *(uint4*)(dst + o) = f32x8_to_bf16(src + o);
    for (int o = cv + gt; o < count; o += nt) dst[o] = ff::cvt<D>(src[o]);
  }
}

// ---- one update chunk's loads and stores -------------------------------------

template <int V>
__device__ __forceinline__ void load_f(float* d, const float* s) {
  if constexpr (V == 4) {
    const float4 x = *(const float4*)s;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  } else {
    d[0] = s[0];
  }
}

template <int V>
__device__ __forceinline__ void load_f(float* d, const __nv_bfloat16* s) {
  if constexpr (V == 4) {
    const uint2 r = *(const uint2*)s;
    const float2 lo = __bfloat1622float2(*(const __nv_bfloat162*)&r.x);
    const float2 hi = __bfloat1622float2(*(const __nv_bfloat162*)&r.y);
    d[0] = lo.x; d[1] = lo.y; d[2] = hi.x; d[3] = hi.y;
  } else {
    d[0] = __bfloat162float(s[0]);
  }
}

template <int V>
__device__ __forceinline__ void load_i(int* d, const int* s) {
  if constexpr (V == 4) {
    const int4 x = *(const int4*)s;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  } else {
    d[0] = s[0];
  }
}

template <int V>
__device__ __forceinline__ void load_i(int* d, const int8_t* s) {
  if constexpr (V == 4) {
    const int x = *(const int*)s;
#pragma unroll
    for (int u = 0; u < 4; ++u) d[u] = (int)(int8_t)(x >> (8 * u));
  } else {
    d[0] = s[0];
  }
}

template <int V>
__device__ __forceinline__ void store_f(float* dst, const float* w) {
  if constexpr (V == 4)
    *(float4*)dst = make_float4(w[0], w[1], w[2], w[3]);
  else
    dst[0] = w[0];
}

// Rounded to bfloat16 once, as it is stored.
template <int V>
__device__ __forceinline__ void store_f(__nv_bfloat16* dst, const float* w) {
  if constexpr (V == 4) {
    uint2 r;
    *(__nv_bfloat162*)&r.x = __halves2bfloat162(__float2bfloat16_rn(w[0]),
                                                __float2bfloat16_rn(w[1]));
    *(__nv_bfloat162*)&r.y = __halves2bfloat162(__float2bfloat16_rn(w[2]),
                                                __float2bfloat16_rn(w[3]));
    *(uint2*)dst = r;
  } else {
    dst[0] = __float2bfloat16_rn(w[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_i8(int8_t* dst, const int* w) {
  if constexpr (V == 4) {
    *(int*)dst = (int)((w[0] & 0xff) | ((w[1] & 0xff) << 8) |
                       ((w[2] & 0xff) << 16) | ((unsigned)w[3] << 24));
  } else {
    dst[0] = (int8_t)w[0];
  }
}

// Fixed-point scalars of one (stream, layer): the weight scale, the clip,
// and 1 / scale where the scale is a power of two with a normal reciprocal
// (then dw * inv is dw / scale exactly), else 0.
struct QLayer {
  float scale, inv;
  int qmax;
};

__device__ inline QLayer q_layer(float scale, float w_clip) {
  return QLayer{scale, ff::exact_inverse(scale), ff::qclip(w_clip, scale)};
}

// ---- Forward Engine: one layer's psums ----------------------------------------

// Rows r, r + step, ... of column c of the (n, m) weights w against the
// input x, in row order: an exact int32 sum with wrap-around in fixed point
// (S = int), else float32 (bfloat16 operands promoted).
template <typename S, typename X, typename WT>
__device__ __forceinline__ S psum_rows(const X* __restrict__ x,
                                       const WT* __restrict__ w, int n, int m,
                                       int c, int r, int step) {
  S acc = 0;
#pragma unroll 4
  for (; r < n; r += step) {
    if constexpr (std::is_same_v<S, int>)
      acc = ff::wadd(acc, ff::wmul((int)x[r], (int)w[r * m + c]));
    else
      acc = acc + ff::cvt<float>(x[r]) * ff::cvt<float>(w[r * m + c]);
  }
  return acc;
}

// Phase 1 of one layer for one stream: every column's psum by the group's
// threads in the split of `lp`, the lanes that share a column summed by a
// fixed-order xor-shuffle tree (exact in int32, whose adds wrap); then
// `column(c, acc)` once per column, by one thread.  Every thread of the
// group calls it (the shuffles need whole warps).
template <typename S, typename X, typename WT, typename F>
__device__ __forceinline__ void forward_engine(const X* x, const WT* w,
                                               const LayerPlan& lp, int gt,
                                               int nt, F&& column) {
  const int n = lp.n, m = lp.m;
  auto tree = [&](S acc, int from, int to) {
    for (int off = from; off >= to; off >>= 1) {
      const S o = __shfl_xor_sync(0xffffffffu, acc, off);
      if constexpr (std::is_same_v<S, int>) acc = ff::wadd(acc, o);
      else acc = acc + o;
    }
    return acc;
  };
  if (lp.cmaj) {
    const int lane = gt - (nt - 32);
    if (lane >= 0) {
      const int c = lane & (m - 1), q = lane >> (5 - lp.lg_r);
      const S acc = tree(psum_rows<S>(x, w, n, m, c, q, 1 << lp.lg_r), 16,
                         m);
      if (q == 0) column(c, acc);
    }
  } else if (lp.lg_r == 0) {
    for (int c = gt; c < m; c += nt) column(c, psum_rows<S>(x, w, n, m, c, 0,
                                                            1));
  } else {
    const int rs = 1 << lp.lg_r;
    const int c = gt >> lp.lg_r, q = gt & (rs - 1);
    const S acc = tree(c < m ? psum_rows<S>(x, w, n, m, c, q, rs) : S(0),
                       rs >> 1, 1);
    if (c < m && q == 0) column(c, acc);
  }
}

// ---- Plasticity Engine: one layer's synapses ----------------------------------

// Phase 2 of one layer for one stream, in place on the stream's weights in
// shared memory: the group's threads walk the synapses in chunks of V,
// thread gt starting at chunk gt, i.e. at (r, c), and stepping V * T
// synapses = (d_row, d_col).  WS: the weights' type in shared memory
// (float | int8, or bfloat16: promoted on load, rounded once on store); P:
// the pre traces' (the compute type, or bfloat16); the post traces are in
// the compute type.  kPow2: dw / scale as dw * (1 / scale), exact for a
// power-of-two scale.  kTel: also add each synapse's |w_new - w_old| to
// *tel_dw (float32 before rounding; int8 grid steps).
template <bool Q, int V, bool kPow2, bool kTel, typename WS, typename P,
          typename TH>
__device__ __forceinline__ void update_layer(
    WS* __restrict__ w, const TH* __restrict__ th, const P* __restrict__ pre,
    const typename Types<Q>::S* __restrict__ post, const LayerPlan& lp,
    int r, int c, int gt, int nt, float w_clip, const QLayer& ql, int seed,
    const ff::QParams& q, typename Types<Q>::S* tel_dw) {
  const int nm = lp.nm, m = lp.m, d_row = lp.d_row, d_col = lp.d_col;
#pragma unroll 2
  for (int o = V * gt; o < nm; o += V * nt) {
    float co[4][V];
#pragma unroll
    for (int p = 0; p < 4; ++p) load_f<V>(co[p], th + (long)p * nm + o);
    if constexpr (Q) {
      int wv[V], pv[V];
      load_i<V>(wv, w + o);
      load_i<V>(pv, post + c);
      const int pr = pre[r];
      const float pre_f = __fmul_rn(__int2float_rn(pr), q.inv1);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float dw = ff::four_term(
            co[0][u], co[1][u], co[2][u], co[3][u],
            __fmul_rn(__int2float_rn(ff::wmul(pr, pv[u])), q.inv2), pre_f,
            __fmul_rn(__int2float_rn(pv[u]), q.inv1));
        const float st = kPow2 ? __fmul_rn(dw, ql.inv)
                               : __fdiv_rn(dw, ql.scale);
        const int wn = ff::q_steps_clip(wv[u], st, ql.qmax, seed, o + u, q);
        if constexpr (kTel) *tel_dw += abs(wn - wv[u]);
        wv[u] = wn;
      }
      store_i8<V>(w + o, wv);
    } else {
      float wv[V], pv[V];
      load_f<V>(wv, w + o);
      load_f<V>(pv, post + c);
      const float pr = ff::cvt<float>(pre[r]);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float coef[4] = {co[0][u], co[1][u], co[2][u], co[3][u]};
        const float wn = ff::plastic_f_coef(wv[u], coef, __fmul_rn(pr, pv[u]),
                                            pr, pv[u], w_clip);
        if constexpr (kTel) *tel_dw = *tel_dw + fabsf(wn - wv[u]);
        wv[u] = wn;
      }
      store_f<V>(w + o, wv);
    }
    c += d_col;
    r += d_row;
    if (c >= m) {
      c -= m;
      ++r;
    }
  }
}

template <bool Q, int V, bool kTel = false, typename WS, typename P,
          typename TH>
__device__ __forceinline__ void update_q(
    WS* w, const TH* th, const P* pre, const typename Types<Q>::S* post,
    const LayerPlan& lp, int r, int c, int gt, int nt, float w_clip,
    const QLayer& ql, int seed, const ff::QParams& q,
    typename Types<Q>::S* tel_dw = nullptr) {
  if constexpr (Q) {
    if (ql.inv != 0.0f) {
      update_layer<Q, V, true, kTel>(w, th, pre, post, lp, r, c, gt, nt,
                                     w_clip, ql, seed, q, tel_dw);
      return;
    }
  }
  update_layer<Q, V, false, kTel>(w, th, pre, post, lp, r, c, gt, nt, w_clip,
                                  ql, seed, q, tel_dw);
}

// Sum of one value per lane over a warp, in a fixed tree order.
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1)
    x = x + __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// |x| with the reference's int32 wrap-around (|INT_MIN| stays INT_MIN).
__device__ __forceinline__ int wabs(int x) { return x < 0 ? ff::wsub(0, x) : x; }

}  // namespace
