// One recorded step of a controller fleet in one launch: the flight
// recorder and its streaming detectors.
//
//   recorder  replaces the part of the JAX package's jitted record-variant
//             pool step that XLA fuses around the rollout (no Pallas
//             kernel): src/repro/serving/scheduler.py:870 `_record`, i.e.
//             obs/recorder.py:136 `network_weight_norm`, :71
//             `recorder_update` and obs/health.py:145 `health_update`.
//
// What it computes, for each slot b of B:
//   wnorm   = sum over layers l of  mean |w_l[b]|   (int8 planes as
//             float(sum |w|) / (N M) * w_scale_l[b]; the layers added in
//             order, the first one alone)
//   wnorm0  latches wnorm at the slot's first active recorded step
//   x       = (spike_rate, mean_abs_dw, sat_frac, |wnorm - wnorm0|),
//             exact zeros where the slot is inactive
//   ring[b, row, :] = x
//   the four detectors and the winsorized EWMA update of obs/health.py in
//   the same order of operations, four threads a slot (thread c holds
//   channel c and detector c); the detectors' any/all across channels are
//   the four bits of the slot in a warp ballot.
// Every float operation rounds once, as written: the build passes
// -fmad=false, and sqrt and division are the IEEE ones (__fsqrt_rn,
// __fdiv_rn), so the detectors equal the plain version's given the same
// channels.
//
// What bounds it on an H100: bytes.  At 8-128-8, B = 4096 the weights are
// 33.5 MB in float32 (16.8 MB bf16, 8.4 MB int8), the ring row, telemetry
// and state under 0.5 MB: ~10 us (2.5 us) at 3.35 TB/s.  So the design
// keeps the weights' bytes in flight and nothing else in their way; the
// plan (obs/recorder.py `recorder_plan`, mirrored by `make_plan` below,
// which refuses a launch whose plan differs) picks one of two routes:
//
//   tiles    many small slots (the fleet).  A CTA takes tiles of k
//            consecutive slots, whose weights are one contiguous span a
//            layer (w_l + s0 N M), and one thread brings each span in by a
//            1-D bulk copy on the stage's mbarrier.  A persistent grid
//            walks the tiles through two stages where the card cannot
//            hold them all at once; a warp sums one (slot, layer) from
//            shared memory: lane-strided 16-byte words (a lane's j-th into
//            accumulator j mod 4), then a butterfly across the warp.  The
//            CTA reads the detector state (and int8 scales) of all its
//            slots, at most 64, while the weights stream, and runs every
//            detector once after its last tile: a detector pass between
//            tiles held the next tile's copy behind it.
//   cluster  few large slots (the LM adapter, B <= 8).  A slot runs on a
//            cluster of 2-8 CTAs; each brings its share of every layer in
//            the same way and sums it: lane-strided words over the CTA's
//            256 threads, a butterfly a warp, the warps in warp order; the
//            partials meet in cluster-rank order through distributed
//            shared memory, and rank 0 runs the detectors.
// A layer whose span breaks the copy engine's 16-byte rules (N M bytes not
// a multiple of 16, or a base off 16 bytes) comes in as the cp.async words
// of slab.cuh instead, and is summed element by element.
//
// int8 sums are 32-bit: each byte's sign selects a multiplier of +1 or -1
// and one signed dp4a adds the four |q| (its products are formed in 32
// bits, so -128 counts 128), and a warp's lanes add with redux.sync; the
// plan bounds a warp's bytes by its stage, so neither can overflow.  They
// widen to 64 bits where warps and CTAs combine.  Float sums run in the
// order above, which is not the plain version's; int8 is exact.
//
// The recorder state is updated in place: each slot's rows are read and
// written by its own four threads only, every read before any write.
// `row` (the ring cursor mod W) and every detector constant are arguments
// by value: no host sync, no copy, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "forward.cuh"

namespace {

constexpr int kC = 4;                 // channels == detectors
constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = kThreads / kC;          // slots a CTA
constexpr int kMaxCluster = 8;                   // portable
constexpr int kMaxCtasSm = 4;
constexpr long long kSmemMax = 232448;           // a CTA's shared bytes
constexpr long long kSmemSm = 233472;            // an SM's, 1 KB a CTA kept
constexpr long long kStageTarget = 32768;        // a tile's bytes
constexpr long long kMinShare = 2048;            // a cluster rank's least

struct Layers {
  const void* w[kMaxLayers];
  const float* scale[kMaxLayers];   // int8 only: (B,) per-slot scales
  long long nm[kMaxLayers];         // N * M of each layer
  int count;
};

struct Config {
  float alpha, one_minus_alpha, z_thr, floor2, stuck_eps, dead_floor;
  float lo[kC], hi[kC];
  int hyst[kC];
  int warmup;
};

struct Channels {
  const float* col[3];              // spike_rate, mean_abs_dw, sat_frac
  long long stride[3];
};

struct State {
  float* ring;                      // (B, W, C)
  float* wnorm0;                    // (B,)
  float* mean;                      // (B, C)
  float* var;                       // (B, C)
  float* last;                      // (B, C)
  int* streaks;                     // (B, D)
  unsigned char* flagged;           // (B, D) bool
  int* steps;                       // (B,)
};

// obs/recorder.py recorder_plan, field for field.
struct Plan {
  int cluster;                // CTAs a slot; 1 on the tile route
  int slots;                  // slots a tile; 1 on the cluster route
  int tiles;                  // tiles, or slots on the cluster route
  int stages;                 // stages of the tile route's ring
  int ctas;                   // CTAs launched
  int stage;                  // bytes of a stage
  int smem;                   // dynamic shared bytes
  int words;                  // bit l: layer l by cp.async words
  int share[kMaxLayers];      // elements of a slot's layer a CTA takes
  int off[kMaxLayers];        // byte offset of a layer in a stage
};

struct Args {
  Layers layers;
  Channels ch;
  const unsigned char* active;
  State s;
  long long row;
  int window, b, e;
  Config cfg;
  unsigned char* verdict;
  Plan p;
};

// A layer as the kernels read it, copied to shared memory once (a
// parameter array indexed at run time would go through local memory).
struct LayerInfo {
  const unsigned char* w;
  const float* scale;
  long long nm;
  int off, share;
};

__host__ __device__ __forceinline__ long long lmin(long long x,
                                                   long long y) {
  return x < y ? x : y;
}

long long align16(long long x) { return (x + 15) / 16 * 16; }

// The bytes after the stages: the per-(slot, layer) sums of a CTA's slots
// (at most kMaxTile), or a cluster CTA's warp sums and partials; two
// mbarriers; the layer table.
__host__ __device__ __forceinline__ long long sums_bytes(int n_layers) {
  return 8LL * kMaxTile * n_layers;
}
__host__ __device__ __forceinline__ long long extra_bytes(int n_layers) {
  return sums_bytes(n_layers) + 16 + sizeof(LayerInfo) * kMaxLayers;
}

// A stage of k slots whose layers a CTA takes `share` elements of; sets
// the shares and offsets.
long long stage_bytes(const long long* nm, int n_layers, int e, int k,
                      int c, Plan* p) {
  long long s = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long v = 16 / e;
    const long long share =
        c == 1 ? nm[l] : ((nm[l] + c - 1) / c + v - 1) / v * v;
    p->share[l] = (int)std::min<long long>(share, 1LL << 30);
    p->off[l] = (int)std::min<long long>(s, 1LL << 30);
    s += align16((long long)k * share * e + 4);
  }
  return s;
}

// obs/recorder.py recorder_plan: false where no plan fits.
bool make_plan(int b, const long long* nm, int n_layers, int e, int sms,
               int words, Plan* p) {
  *p = Plan{};
  if (b < 1 || sms < 1) return false;
  long long per_slot = 0;
  for (int l = 0; l < n_layers; ++l) per_slot += nm[l] * e;
  p->words = words;
  long long c = std::min<long long>(kMaxCluster, (sms + b - 1) / b);
  c = std::min<long long>(c, std::max<long long>(1, per_slot / kMinShare));
  if (c == 1 && 2 * stage_bytes(nm, n_layers, e, 1, 1, p) +
                        extra_bytes(n_layers) <= kSmemMax) {
    const long long k = std::max<long long>(
        1, std::min<long long>({kMaxTile, kStageTarget / per_slot,
                                (b + sms - 1) / sms}));
    const long long tiles = (b + k - 1) / k;
    const long long stage = stage_bytes(nm, n_layers, e, (int)k, 1, p);
    const long long extra = extra_bytes(n_layers);
    long long per_sm = std::min<long long>(
        kMaxCtasSm, kSmemSm / (stage + extra + 1024));
    p->stages = tiles <= sms * per_sm ? 1 : 2;
    if (p->stages == 2)
      per_sm = std::min<long long>(
          kMaxCtasSm, kSmemSm / (2 * stage + extra + 1024));
    // a CTA holds the detector state of at most kMaxTile slots
    const long long ctas = std::max<long long>(
        std::min<long long>(tiles, sms * per_sm),
        (tiles + kMaxTile / k - 1) / (kMaxTile / k));
    p->cluster = 1;
    p->slots = (int)k;
    p->tiles = (int)tiles;
    p->ctas = (int)ctas;
    p->stage = (int)stage;
    p->smem = (int)(p->stages * stage + extra);
    return per_sm >= 1;
  }
  c = std::max<long long>(c, 2);
  while (c <= kMaxCluster && stage_bytes(nm, n_layers, e, 1, (int)c, p) +
                                     extra_bytes(n_layers) > kSmemMax)
    ++c;
  if (c > kMaxCluster) return false;
  const long long stage = stage_bytes(nm, n_layers, e, 1, (int)c, p);
  p->cluster = (int)c;
  p->slots = 1;
  p->tiles = b;
  p->stages = 1;
  p->ctas = (int)(b * c);
  p->stage = (int)stage;
  p->smem = (int)(stage + extra_bytes(n_layers));
  return b * c < (1LL << 31);
}

// ---- sums of |w| ------------------------------------------------------------

// A lane's partial: float for float32 and bfloat16 (a word's elements
// added in order), 32-bit for int8; a warp's total; a CTA's or a
// cluster's `Part`.
template <typename W> struct Sum;

__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <> struct Sum<float> {
  using Lane = float;
  using Part = float;
  static __device__ __forceinline__ float add1(float v, float acc) {
    return acc + fabsf(v);
  }
  static __device__ __forceinline__ float add(uint4 q, float acc) {
    acc = add1(__uint_as_float(q.x), acc);
    acc = add1(__uint_as_float(q.y), acc);
    acc = add1(__uint_as_float(q.z), acc);
    return add1(__uint_as_float(q.w), acc);
  }
  static __device__ __forceinline__ float warp(float v) {
    return warp_total(v);
  }
};

// A bfloat16 is the top half of its float32.
template <> struct Sum<__nv_bfloat16> {
  using Lane = float;
  using Part = float;
  static __device__ __forceinline__ float pair(unsigned u, float acc) {
    acc = acc + fabsf(__uint_as_float(u << 16));
    return acc + fabsf(__uint_as_float(u & 0xffff0000u));
  }
  static __device__ __forceinline__ float add1(__nv_bfloat16 v, float acc) {
    return acc + fabsf(__bfloat162float(v));
  }
  static __device__ __forceinline__ float add(uint4 q, float acc) {
    return pair(q.w, pair(q.z, pair(q.y, pair(q.x, acc))));
  }
  static __device__ __forceinline__ float warp(float v) {
    return warp_total(v);
  }
};

// Four signed bytes' |q| added to acc: each byte's sign bit picks a
// multiplier byte of +1 (0x01) or -1 (0xff).
__device__ __forceinline__ int abs4(unsigned q, int acc) {
  const unsigned neg = (q >> 7) & 0x01010101u;
  return __dp4a((int)q, (int)(0x01010101u | (neg * 0xfeu)), acc);
}

template <> struct Sum<int8_t> {
  using Lane = int;
  using Part = unsigned long long;
  static __device__ __forceinline__ int add1(int8_t v, int acc) {
    return acc + (v < 0 ? -(int)v : (int)v);
  }
  static __device__ __forceinline__ int add(uint4 q, int acc) {
    return abs4(q.w, abs4(q.z, abs4(q.y, abs4(q.x, acc))));
  }
  static __device__ __forceinline__ unsigned long long warp(int v) {
    return __reduce_add_sync(0xffffffffu, (unsigned)v);
  }
};

// Lane i of n sums |w| over `count` elements at `src` in shared memory:
// 16-byte words i, i + n, ... where `vec` (each word's elements in order),
// else elements i, i + n, ...; the lane's j-th word or element goes to
// accumulator j mod 4, and the four add as (a0 + a1) + (a2 + a3).
template <typename W>
__device__ __forceinline__ typename Sum<W>::Lane
run_sum(const unsigned char* src, int count, bool vec, int i, int n) {
  using Lane = typename Sum<W>::Lane;
  Lane a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(src);
    const int words = count / (16 / (int)sizeof(W));
    int v = i;
    for (; v + 3 * n < words; v += 4 * n) {
      a0 = Sum<W>::add(p[v], a0);
      a1 = Sum<W>::add(p[v + n], a1);
      a2 = Sum<W>::add(p[v + 2 * n], a2);
      a3 = Sum<W>::add(p[v + 3 * n], a3);
    }
    if (v < words) a0 = Sum<W>::add(p[v], a0);
    if (v + n < words) a1 = Sum<W>::add(p[v + n], a1);
    if (v + 2 * n < words) a2 = Sum<W>::add(p[v + 2 * n], a2);
  } else {
    const W* p = reinterpret_cast<const W*>(src);
    int v = i;
    for (; v + 3 * n < count; v += 4 * n) {
      a0 = Sum<W>::add1(p[v], a0);
      a1 = Sum<W>::add1(p[v + n], a1);
      a2 = Sum<W>::add1(p[v + 2 * n], a2);
      a3 = Sum<W>::add1(p[v + 3 * n], a3);
    }
    if (v < count) a0 = Sum<W>::add1(p[v], a0);
    if (v + n < count) a1 = Sum<W>::add1(p[v + n], a1);
    if (v + 2 * n < count) a2 = Sum<W>::add1(p[v + 2 * n], a2);
  }
  return (a0 + a1) + (a2 + a3);
}

// ---- loads -----------------------------------------------------------------

// Layer l's elements [lo, ...) of slots from s0, in device memory.
__device__ __forceinline__ const unsigned char* span_of(const LayerInfo& li,
                                                        int e, long long s0,
                                                        long long lo) {
  return li.w + (s0 * li.nm + lo) * e;
}

// Layer l's elements a CTA takes: whole slots on the tile route, the
// rank's share of one slot on the cluster route.
__device__ __forceinline__ void extent(const LayerInfo& li, int cluster,
                                       int k, int rank, long long& lo,
                                       long long& len) {
  lo = cluster == 1 ? 0 : lmin(li.nm, (long long)rank * li.share);
  len = cluster == 1 ? (long long)k * li.nm : lmin(li.nm - lo, li.share);
}

// Issue the spans of k slots from s0 (or one slot's share) into a stage:
// one thread the bulk copies on `bar`, every thread the cp.async words.  A
// cp.async span starts at byte (address & 3) of its region.
__device__ __forceinline__ void issue(const LayerInfo* info, int n_layers,
                                      int e, int words, int cluster,
                                      unsigned char* stage, uint32_t bar,
                                      long long s0, int k, int rank) {
  long long lo, len;
  if (threadIdx.x == 0) {
    uint32_t bytes = 0;
    for (int l = 0; l < n_layers; ++l) {
      extent(info[l], cluster, k, rank, lo, len);
      if (!((words >> l) & 1)) bytes += (uint32_t)(len * e);
    }
    mbar_expect_tx(bar, bytes);
    for (int l = 0; l < n_layers; ++l) {
      extent(info[l], cluster, k, rank, lo, len);
      if (!((words >> l) & 1) && len > 0)
        bulk_load(stage + info[l].off, span_of(info[l], e, s0, lo),
                  (uint32_t)(len * e), bar);
    }
  }
  for (int l = 0; l < n_layers; ++l) {
    extent(info[l], cluster, k, rank, lo, len);
    if (((words >> l) & 1) && len > 0) {
      const unsigned char* src = span_of(info[l], e, s0, lo);
      const int pitch = (int)(((uintptr_t)src & 3) + len * e + 3) / 4 * 4;
      copy_async(stage + info[l].off, src, 1, 0, 0, (int)len, 0, e, kWords,
                 4, pitch);
    }
  }
}

// v[c] with c known only at run time, without indexing the array.
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[kC], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

// One (slot, channel)'s detector state, read before the weights land;
// int8: thread c also holds the slot's scales of layers c and c + 4.
struct Det {
  float x, mean, var, last, w0, sc0, sc1;
  int streak, steps;
  bool act, flagged;
};

__device__ __forceinline__ Det load_det(const Args& a, const LayerInfo* info,
                                        int slot, int c) {
  Det d;
  const int n_layers = a.layers.count;
  d.sc0 = a.e == 1 && c < n_layers ? info[c].scale[slot] : 0.f;
  d.sc1 = a.e == 1 && c + kC < n_layers ? info[c + kC].scale[slot] : 0.f;
  const long long sc = (long long)slot * kC + c;
  d.act = a.active == nullptr || a.active[slot] != 0;
  d.steps = a.s.steps[slot];
  d.w0 = a.s.wnorm0[slot];
  const float* col = c == 0 ? a.ch.col[0] : c == 1 ? a.ch.col[1]
                                                   : a.ch.col[2];
  const long long stride = c == 0 ? a.ch.stride[0]
                           : c == 1 ? a.ch.stride[1] : a.ch.stride[2];
  d.x = c < 3 ? col[slot * stride] : 0.f;
  d.mean = a.s.mean[sc];
  d.var = a.s.var[sc];
  d.last = a.s.last[sc];
  d.streak = a.s.streaks[sc];
  d.flagged = a.s.flagged[sc] != 0;
  return d;
}

// The slot's network weight norm from its layers' sums (`sum_of(l)`), on
// every lane of a warp: mean |w| a layer (int8 scaled by the slot's scale,
// shuffled from the lane that holds it), the layers added in order.
template <typename W, typename F>
__device__ __forceinline__ float weight_norm(const LayerInfo* info,
                                             int n_layers, const Det& d,
                                             F sum_of) {
  const int base = (threadIdx.x & 31) & ~3;
  float wnorm = 0.f;
  for (int l = 0; l < n_layers; ++l) {
    const float nm = (float)info[l].nm;
    float m;
    if constexpr (sizeof(W) == 1) {
      const float sc = __shfl_sync(0xffffffffu, l < kC ? d.sc0 : d.sc1,
                                   base + (l & 3));
      m = __fmul_rn(__fdiv_rn((float)sum_of(l), nm), sc);
    } else {
      m = __fdiv_rn(sum_of(l), nm);
    }
    wnorm = l == 0 ? m : __fadd_rn(wnorm, m);
  }
  return wnorm;
}

// The detectors and the state's write-back of one (slot, channel), on
// every lane of a warp (ballots); lanes 4g..4g+3 hold one slot's channels
// and `mine` is false on a lane without one.
__device__ __forceinline__ void detect(const Args& a, const Det& d, int slot,
                                       int c, bool mine, float wnorm) {
  const Config& cfg = a.cfg;
  const int lane = threadIdx.x & 31, base = lane & ~3;
  const bool warm = d.steps >= cfg.warmup;
  const float w0 = (d.act && d.steps == 0) ? wnorm : d.w0;
  float x = c < 3 ? d.x : fabsf(__fsub_rn(wnorm, w0));
  if (!d.act) x = 0.f;

  // detection against the baseline from before the update
  const float sd = __fsqrt_rn(__fadd_rn(d.var, cfg.floor2));
  const float z = __fdiv_rn(fabsf(__fsub_rn(x, d.mean)), sd);
  auto bits = [&](bool v) {
    return (__ballot_sync(0xffffffffu, mine && v) >> base) & 0xfu;
  };
  const unsigned fz = bits(z > cfg.z_thr);
  const unsigned fb = bits(x < pick(cfg.lo, c) || x > pick(cfg.hi, c));
  const unsigned fs = bits(fabsf(__fsub_rn(x, d.last)) <= cfg.stuck_eps);
  const float x0 = __shfl_sync(0xffffffffu, x, base);
  const bool fire_bound = fb != 0u;
  const bool fire =
      d.act && (c == 1 ? fire_bound
                       : warm && (c == 0   ? fz != 0u
                                  : c == 2 ? fs == (1u << kC) - 1u
                                           : x0 < cfg.dead_floor));
  const int new_streak = fire ? d.streak + 1 : 0;
  const bool flag = d.flagged || new_streak >= pick(cfg.hyst, c);
  const unsigned flags = bits(flag);

  // the winsorized baseline update; inactive slots hold their state
  const bool learn = d.act && !fire_bound;
  float dd = __fsub_rn(x, d.mean);
  if (warm) {
    const float cap = __fmul_rn(cfg.z_thr, sd);
    dd = fminf(fmaxf(dd, -cap), cap);
  }
  const float al = cfg.alpha;
  const float new_mean = learn ? __fadd_rn(d.mean, __fmul_rn(al, dd)) : d.mean;
  const float new_var =
      learn ? __fmul_rn(cfg.one_minus_alpha,
                        __fadd_rn(d.var, __fmul_rn(__fmul_rn(al, dd), dd)))
            : d.var;

  if (mine) {
    const long long sc = (long long)slot * kC + c;
    a.s.ring[((long long)slot * a.window + a.row) * kC + c] = x;
    a.s.mean[sc] = new_mean;
    a.s.var[sc] = new_var;
    a.s.last[sc] = d.act ? x : d.last;
    a.s.streaks[sc] = new_streak;
    a.s.flagged[sc] = flag ? 1 : 0;
    if (c == 0) {
      a.s.wnorm0[slot] = w0;
      a.s.steps[slot] = d.steps + (d.act ? 1 : 0);
      a.verdict[slot] = flags != 0u ? 1 : 0;
    }
  }
}

// The mbarriers and the layer table after the stages and the sums; the
// table filled from the arguments with constant indices.
__device__ __forceinline__ LayerInfo* setup(const Args& a,
                                            unsigned char* smem,
                                            uint32_t& bar0) {
  const Plan& p = a.p;
  const int n_layers = a.layers.count;
  unsigned char* tail = smem + (long long)p.stages * p.stage +
                        sums_bytes(n_layers);
  bar0 = smem_u32(tail);
  LayerInfo* info = reinterpret_cast<LayerInfo*>(tail + 16);
  const int tid = threadIdx.x;
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l)
    if (tid == l + 1 && l < n_layers)
      info[l] = LayerInfo{static_cast<const unsigned char*>(a.layers.w[l]),
                          a.layers.scale[l], a.layers.nm[l], p.off[l],
                          p.share[l]};
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bar0 + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return info;
}

// ---- the tile route ---------------------------------------------------------

// at most 64 registers: the plan puts up to kMaxCtasSm CTAs on an SM
template <typename W>
__global__ void __launch_bounds__(kThreads, kMaxCtasSm)
recorder_tiles_kernel(const Args a) {
  using Part = typename Sum<W>::Part;
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = a.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_layers = a.layers.count, grid = gridDim.x, e = a.e;
  // the sums of the CTA's slots in the order it takes them: tile i's slot
  // j at i * slots + j
  Part* sums = reinterpret_cast<Part*>(smem + (long long)p.stages * p.stage);
  uint32_t bar0;
  const LayerInfo* info = setup(a, smem, bar0);
  auto start = [&](int t, int s) {
    const long long s0 = (long long)t * p.slots;
    issue(info, n_layers, e, p.words, 1, smem + (long long)s * p.stage,
          bar0 + 8u * s, s0, (int)lmin(p.slots, a.b - s0), 0);
  };
  for (int s = 0; s < p.stages; ++s) {
    if ((int)blockIdx.x + s * grid < p.tiles) start(blockIdx.x + s * grid, s);
    cp_async_commit();
  }
  // the detector state of every slot the CTA takes, read while the
  // weights stream (thread 4q + c: the CTA's q-th slot, channel c)
  const int n_tiles = (p.tiles - (int)blockIdx.x + grid - 1) / grid;
  const int q = tid >> 2, c = tid & 3, it = q / p.slots;
  const int slot = (blockIdx.x + it * grid) * p.slots + (q - it * p.slots);
  const bool mine = it < n_tiles && slot < a.b;
  Det d{};
  if (mine) d = load_det(a, info, slot, c);

  for (int i = 0, t = blockIdx.x; t < p.tiles; ++i, t += grid) {
    const int s = p.stages == 2 ? (i & 1) : 0;
    const uint32_t parity = (uint32_t)(p.stages == 2 ? i >> 1 : i) & 1u;
    const int s0 = t * p.slots, k = min(p.slots, a.b - s0);
    mbar_wait(bar0 + 8u * s, parity);
    if (p.stages == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();

    // a warp a (slot, layer)
    const unsigned char* stage = smem + (long long)s * p.stage;
    for (int r = warp; r < k * n_layers; r += kWarps) {
      const int j = r / n_layers, l = r - j * n_layers;
      const LayerInfo& li = info[l];
      const bool vec = !((p.words >> l) & 1);
      const unsigned char* src =
          stage + li.off + (long long)j * li.nm * e +
          (vec ? 0 : ((uintptr_t)span_of(li, e, s0, 0) & 3));
      const Part tot =
          Sum<W>::warp(run_sum<W>(src, (int)li.nm, vec, lane, 32));
      if (lane == 0) sums[(i * p.slots + j) * n_layers + l] = tot;
    }
    __syncthreads();                  // the stage is free
    if (t + p.stages * grid < p.tiles) start(t + p.stages * grid, s);
    cp_async_commit();
  }

  // the detectors of all the CTA's slots at once
  if ((tid & ~31) < kC * n_tiles * p.slots) {
    const float wnorm = weight_norm<W>(
        info, n_layers, d, [&](int l) { return sums[q * n_layers + l]; });
    detect(a, d, slot, c, mine, wnorm);
  }
}

// ---- the cluster route ------------------------------------------------------

// one CTA an SM at least: without it ptxas aims at fewer registers and
// spills the detector state
template <typename W>
__global__ void __launch_bounds__(kThreads, 1)
recorder_cluster_kernel(const Args a) {
  using Part = typename Sum<W>::Part;
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = a.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_layers = a.layers.count, rank = cluster_rank(), e = a.e;
  const int slot = blockIdx.x / p.cluster;
  Part* wsum = reinterpret_cast<Part*>(smem + p.stage);   // [warp][layer]
  Part* part = wsum + kWarps * n_layers;                   // [layer]
  uint32_t bar;
  const LayerInfo* info = setup(a, smem, bar);
  issue(info, n_layers, e, p.words, p.cluster, smem, bar, slot, 1, rank);
  cp_async_commit();
  const int c = tid & 3;
  const bool mine = rank == 0 && tid < kC;
  Det d{};
  if (mine) d = load_det(a, info, slot, c);
  mbar_wait(bar, 0);
  cp_async_wait<0>();
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    const LayerInfo& li = info[l];
    long long lo, len;
    extent(li, p.cluster, 1, rank, lo, len);
    const bool vec = !((p.words >> l) & 1);
    const unsigned char* src =
        smem + li.off + (vec ? 0 : ((uintptr_t)span_of(li, e, slot, lo) & 3));
    const Part tot =
        Sum<W>::warp(run_sum<W>(src, (int)len, vec, tid, kThreads));
    if (lane == 0) wsum[warp * n_layers + l] = tot;
  }
  __syncthreads();
  if (tid < n_layers) {               // the warps in warp order
    Part s = wsum[tid];
    for (int w = 1; w < kWarps; ++w) s += wsum[w * n_layers + tid];
    part[tid] = s;
  }
  cluster_arrive();                   // the partials are in
  cluster_wait();
  if (rank == 0 && warp == 0) {       // the ranks in rank order
    const float wnorm = weight_norm<W>(info, n_layers, d, [&](int l) {
      Part s = part[l];
      const uint32_t addr = smem_u32(part + l);
      for (int r = 1; r < p.cluster; ++r) {
        if constexpr (sizeof(Part) == 8)
          s += (unsigned long long)ld_peer<uint32_t>(addr, r) |
               ((unsigned long long)ld_peer<uint32_t>(addr + 4, r) << 32);
        else
          s += __uint_as_float(ld_peer<uint32_t>(addr, r));
      }
      return s;
    });
    detect(a, d, slot, c, mine, wnorm);
  }
  cluster_arrive();                   // rank 0 is done with the peers'
  cluster_wait();                     // shared memory
}

__global__ void recorder_empty_kernel() {}

template <typename W>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = a.p.cluster == 1 ? recorder_tiles_kernel<W>
                                 : recorder_cluster_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.p.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)a.p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (a.p.cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  if ((err = cudaLaunchKernelEx(&cfg, kernel, a)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

template <typename K>
int attrs(K* kernel, int* out) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  return (int)err;
}

}  // namespace

// w[l]: layer l's (B, N_l, M_l) weights, contiguous, dtype 0 float32 /
// 1 bfloat16 / 2 int8 (then scales[l] its (B,) float32 scales); nm[l] =
// N_l * M_l.  chan[3] / chan_stride[3]: the (B,) spike_rate, mean_abs_dw
// and sat_frac at their element strides.  active: (B,) bytes or null.
// The recorder state (ring (B, W, 4) float32, wnorm0 (B,), ewma_mean,
// ewma_var, last (B, 4) float32, streaks (B, 4) int32, flagged (B, 4)
// bool, steps (B,) int32) is updated in place; verdict (B,) bool out.
// fcfg: alpha, 1 - alpha, z_threshold, z_floor^2, stuck_eps, dead_floor,
// lo[4], hi[4] (float32); icfg: warmup, hysteresis[4].  plan: the
// wrapper's recorder_plan at this card's SM count (cluster, slots, tiles,
// stages, ctas, stage, smem, words); a plan that differs from make_plan's
// is refused.  Returns a cudaError_t.
extern "C" int recorder_step(const void* const* w, const float* const* scales,
                             const long long* nm, int n_layers, int w_dtype,
                             const float* const* chan,
                             const long long* chan_stride,
                             const unsigned char* active, float* ring,
                             float* wnorm0, float* mean, float* var,
                             float* last, int* streaks,
                             unsigned char* flagged, int* steps,
                             unsigned char* verdict, long long row,
                             int window, int b, const float* fcfg,
                             const int* icfg, const int* plan,
                             cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || b < 1 || window < 1 ||
      row < 0 || row >= window || w_dtype < 0 || w_dtype > 2)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.e = w_dtype == 0 ? 4 : w_dtype == 1 ? 2 : 1;
  int words = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (nm[l] < 1 || (w_dtype == 2 && scales[l] == nullptr))
      return (int)cudaErrorInvalidValue;
    a.layers.w[l] = w[l];
    a.layers.scale[l] = scales[l];
    a.layers.nm[l] = nm[l];
    if ((uintptr_t)w[l] % 16 != 0 || nm[l] * a.e % 16 != 0) words |= 1 << l;
  }
  a.layers.count = n_layers;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!make_plan(b, nm, n_layers, a.e, sms, words, &a.p))
    return (int)cudaErrorInvalidValue;
  const Plan& p = a.p;
  const int mine[8] = {p.cluster, p.slots, p.tiles, p.stages,
                       p.ctas,    p.stage, p.smem,  p.words};
  for (int i = 0; i < 8; ++i)
    if (plan[i] != mine[i]) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    a.ch.col[i] = chan[i];
    a.ch.stride[i] = chan_stride[i];
  }
  a.active = active;
  Config& cfg = a.cfg;
  cfg.alpha = fcfg[0];
  cfg.one_minus_alpha = fcfg[1];
  cfg.z_thr = fcfg[2];
  cfg.floor2 = fcfg[3];
  cfg.stuck_eps = fcfg[4];
  cfg.dead_floor = fcfg[5];
  for (int i = 0; i < kC; ++i) {
    cfg.lo[i] = fcfg[6 + i];
    cfg.hi[i] = fcfg[10 + i];
    cfg.hyst[i] = icfg[1 + i];
  }
  cfg.warmup = icfg[0];
  a.s = State{ring, wnorm0, mean, var, last, streaks, flagged, steps};
  a.row = row;
  a.window = window;
  a.b = b;
  a.verdict = verdict;
  if (w_dtype == 0) return launch<float>(a, stream);
  if (w_dtype == 1) return launch<__nv_bfloat16>(a, stream);
  return launch<int8_t>(a, stream);
}

// An empty kernel on one warp: what a launch costs with nothing to do.
extern "C" int recorder_empty(cudaStream_t stream) {
  recorder_empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

// {registers, local (spill) bytes a thread} of each kernel, in the order
// obs/recorder.py RECORDER_KERNELS names them.
extern "C" int recorder_attrs(int* out, int n) {
  if (n != 6) return (int)cudaErrorInvalidValue;
  const int errs[6] = {attrs(recorder_tiles_kernel<float>, out),
                       attrs(recorder_tiles_kernel<__nv_bfloat16>, out + 2),
                       attrs(recorder_tiles_kernel<int8_t>, out + 4),
                       attrs(recorder_cluster_kernel<float>, out + 6),
                       attrs(recorder_cluster_kernel<__nv_bfloat16>, out + 8),
                       attrs(recorder_cluster_kernel<int8_t>, out + 10)};
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}
