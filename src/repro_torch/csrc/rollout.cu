// Time-fused rollout window, fleet mode: K timesteps x L layers for every
// request stream of the fleet in ONE launch.
//
// Replaces src/repro/kernels/plasticity/fused.py:304 rollout_pallas
// (_rollout_kernel :79), fleet grid, and its fleet telemetry variant (the
// time-loop accumulator :133/:230 and the finalized window means :256-283);
// the shared-weight grid (1,) is csrc/rollout_shared.cu.
//
// What bounds it on an H100: bytes, once the steps are cheap.  The least
// traffic is one read and one write of every stream's weights, membranes
// and traces per WINDOW, plus the K drive rows and K readout rows; the
// arithmetic is a few operations per synapse per step (~35 in fixed point,
// whose stochastic round hashes every synapse).  At the paper's 8-128-8
// controller, B = 4096 and K = 4 that is 77 MB, 0.023 ms at 3.35 TB/s.
// Streams never interact: nothing but the rule is shared between them.
//
// Design: a persistent grid of stream groups.
//  * A CTA holds `block_b` groups of `warps` warps; a group runs one
//    stream's whole window, then the group's next stream (stream +=
//    ctas * block_b).  The wrapper launches as many CTAs as the card holds
//    at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), so the rule
//    planes, loaded into shared memory once per CTA, serve every stream the
//    CTA walks.  The host computes the launch's Plan (offsets, copy routes,
//    per-layer splits) once and passes it as a kernel parameter.
//  * Double-buffered streams: a group's slot holds two state buffers (the
//    stream's weights, membranes and traces).  While the group computes one
//    stream, one of its threads has the copy engine bring the group's next
//    stream into the other buffer (1-D bulk copies completing on that
//    buffer's mbarrier; cp.async for an array not in whole 16-byte pieces,
//    and for the fixed-point scales and seed).  In float32 and int8 the
//    finished stream leaves by bulk copies too; a bfloat16 window rounds it
//    on the way out with 16-byte stores, and lands its next stream raw in a
//    staging buffer, promoted to the float32 state buffer on arrival.  Where
//    two buffers do not fit, one: the next stream is loaded once the last
//    has left.  The next stream's active flag and first drive row are read
//    a stream ahead too.
//  * Warp-level steps: every handoff inside a window synchronises the
//    group alone (__syncwarp, or a named barrier of the group's threads),
//    never the CTA.  A layer is two phases:
//      1. the Forward Engine: with M >= the group's T threads each thread
//         sums whole columns; a power-of-two M < 32 takes one warp, lane
//         c + M * q summing column c's rows q, q + 32 / M, ... (a load hits
//         32 banks); any other M < T has R = T / M (a power of two <= 32)
//         adjacent lanes split a column's rows.  A fixed-order xor-shuffle
//         tree sums the partials (exact in int32, whose adds wrap; a float
//         window is no bit contract, as the Pallas body's own psum order
//         is not XLA's); then the neuron, the trace and the gated output
//         on the group's event bus;
//      2. the Plasticity Engine: the stream's synapses in chunks of 4
//         (16-byte loads of weights, rule planes and post traces) when M is
//         a multiple of 4, else one at a time; each thread's first (row,
//         column) is computed once per launch and advanced by a fixed
//         stride, so the step loop does no division.  A fixed-point scale
//         that is a power of two divides by multiplying with its exact
//         reciprocal (the same correctly rounded quotient).
//    Inactive streams skip the steps and keep their state bit for bit
//    (their readout rows are zero, as the reference's select makes them).
//    Step k of layer i draws its stochastic round from fold_seed(seed + k,
//    i) and the layer's own flat (row * M + col) index.
//
// Telemetry variant (template flag kTel, set when `tel` is given): after
// phase 1 of each layer the group's first warp sums the layer's |events|
// and saturated membranes (lanes stride the columns, then a shuffle tree:
// the same order on every run) into accumulators in its lane 0; after the
// window it reduces each plastic layer's net weight motion
// sum |w_end - w_start| the same way against w_in (one more read of the
// stream's weights), divides by K * L (and K * n_plastic) and writes the
// (B, 3) row, zero for an inactive stream.  The fixed-point terms are
// summed in int32 and converted once, so the int8 row equals the plain
// version's bit for bit.
//
// bfloat16 (the Pallas body's generic dtype: fused.py:112-122, :251,
// :275-278): drives, weights, membranes and traces are bfloat16 in device
// memory and promoted to float32 in shared memory, where the window runs in
// float32 exactly as the float32 instantiation does; each step's readout
// row is rounded to bfloat16 as it is stored, and weights, membranes and
// traces once, at write-back.  The rule may be float32 or bfloat16 and stays
// in its own type in shared memory.  Telemetry's net weight motion is
// float32 |w_end - w_start|, w_start promoted from the bfloat16 input.
#include <type_traits>

#include "plasticity.cuh"

using ff::kMaxLayers;

// Arguments of one launch; mirrored by fused.py _RolloutArgs (ctypes).
// Outside the anonymous namespace so the C entry point is exported.
struct RolloutArgs {
  const void* drives;               // (K, B, N0) float32 | bfloat16 | int32
  void* outs;                       // (K, B, M_last) out, as the drives
  const void* teach;                // (K, B, M_last) float32 | int32, or null
  const uint8_t* active;            // (B,) or null
  const int* seed;                  // (B,) int8 only
  const void* w_in[kMaxLayers];     // (B, N_i, M_i)
  void* w_out[kMaxLayers];
  const void* theta[kMaxLayers];    // (4, N_i, M_i) or null
  const float* scale[kMaxLayers];   // (B,) int8 only
  const void* v_in[kMaxLayers];     // (B, M_i)
  void* v_out[kMaxLayers];
  const void* tr_in[kMaxLayers + 1];  // (B, N_i); tr[0] is the input
  void* tr_out[kMaxLayers + 1];
  int sizes[kMaxLayers + 1];
  int n_layers, k_steps, batch, block_b;
  int spiking_mask, plastic_mask, theta_in_smem;
  float w_clip;
  ff::FParams f;
  ff::QParams q;
  float* tel;                       // (B, 3) out, or null
  int telemetry;                    // 1 when tel is set
  int sat_q;                        // fixed-point saturation threshold
  float sat_f;                      // float saturation threshold
  int bf16;                         // float state and weights in bfloat16
  int theta_bf16;                   // the rules in bfloat16
  int warps;                        // warps of one stream's group
  int double_buffer;                // 1: the next stream lands beside
  int ctas;                         // CTAs of the persistent grid
};

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxBarrierGroups = 15;   // named barriers 1..15
constexpr int kMaxSegs = 4 * kMaxLayers + 2;
constexpr int kBarBytes = 16;           // two 8-byte mbarriers
constexpr long long kSpinCycles = 1ll << 35;   // ~19 s: a hang is a fault

inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

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

// Everything a launch derives from its arguments, computed on the host.
// Segments: the L weight slabs, then the L membranes and L+1 traces, then
// (fixed point) the L scales and the seed, copied raw.
struct Plan {
  LayerPlan layer[kMaxLayers];
  Seg seg[kMaxSegs];
  int n_seg, tr[kMaxLayers + 1];   // trace offsets in a state buffer
  int scal;                        // offset of the fixed-point scalars
  int widest;
  int bulk;                        // bytes a stream's 16-byte segments hold
  // shared memory: the rules' mbarrier (16 bytes), the resident rules, then
  // `block_b` slots of a state buffer in the compute types, the spare
  // buffer the next stream is fetched into (a second state buffer; a
  // bfloat16 window's raw staging buffer; none with one buffer a stream),
  // the double-buffered bus and, with a spare buffer, the two buffers'
  // mbarriers (16 bytes)
  int slots, state, spare, bars, slot, total;
};

int floor_log2(int x) {
  int l = 0;
  while (x >>= 1) ++l;
  return l;
}

// The Plan of `a`; repro_torch/kernels/plasticity/fused.py fleet_plan
// computes the same shared memory and the launcher checks that both agree.
Plan make_plan(const RolloutArgs& a, bool quant) {
  Plan p{};
  const int L = a.n_layers, threads = 32 * a.warps;
  const bool staged = !quant && a.bf16;
  const int wb = quant ? 1 : 4;                   // compute types
  const int rwb = quant ? 1 : a.bf16 ? 2 : 4;     // device types
  const int rsb = staged ? 2 : 4;
  int off = 0, soff = 0, n = 0;
  auto add = [&](const void* in, void* out, int count, int cb, int rb) {
    Seg& sg = p.seg[n++];
    sg.in = in;
    sg.out = out;
    sg.count = count;
    sg.raw = count * rb;
    sg.off = off;
    sg.soff = soff;
    sg.fetch16 = ((uintptr_t)in % 16 == 0) && sg.raw % 16 == 0;
    sg.store16 = ((uintptr_t)out % 16 == 0) && sg.raw % 16 == 0;
    off += (int)align16((size_t)count * cb);
    soff += (int)align16((size_t)sg.raw);
  };
  for (int i = 0; i < L; ++i) {
    LayerPlan& lp = p.layer[i];
    lp.n = a.sizes[i];
    lp.m = a.sizes[i + 1];
    lp.nm = lp.n * lp.m;
    lp.w = off;
    add(a.w_in[i], a.w_out[i], lp.nm, wb, rwb);
  }
  for (int i = 0; i < L; ++i) {
    p.layer[i].v = off;
    add(a.v_in[i], a.v_out[i], a.sizes[i + 1], 4, rsb);
  }
  for (int i = 0; i <= L; ++i) {
    p.tr[i] = off;
    add(a.tr_in[i], a.tr_out[i], a.sizes[i], 4, rsb);
    p.widest = a.sizes[i] > p.widest ? a.sizes[i] : p.widest;
  }
  if (quant) {         // one 16-byte aligned block: the scales, the seed
    p.scal = off;
    const int base = off, sbase = soff;
    for (int i = 0; i <= L; ++i) {
      off = base + 4 * i;
      soff = sbase + 4 * i;
      if (i < L) add(a.scale[i], nullptr, 1, 4, 4);
      else add(a.seed, nullptr, 1, 4, 4);
    }
    off = base + (int)align16(4 * (L + 1));
    soff = sbase + (int)align16(4 * (L + 1));
  }
  p.n_seg = n;
  for (int g = 0; g < n; ++g)
    if (p.seg[g].fetch16) p.bulk += p.seg[g].raw;
  int th = kBarBytes;
  for (int i = 0; i < L; ++i) {
    LayerPlan& lp = p.layer[i];
    const int m = lp.m;
    // A power-of-two M < 32 takes the group's last warp, adjacent lanes
    // on adjacent columns: 32 distinct banks a load.  Any other M < T
    // splits rows across adjacent lanes of every warp.
    lp.cmaj = m < 32 && (m & (m - 1)) == 0;
    lp.lg_r = lp.cmaj ? 5 - floor_log2(m)
              : m >= threads ? 0
              : floor_log2(threads / m < 32 ? threads / m : 32);
    lp.vec = m % 4 == 0 ? 4 : 1;
    lp.d_row = lp.vec * threads / m;
    lp.d_col = lp.vec * threads % m;
    const bool plastic = (a.plastic_mask >> i) & 1;
    lp.flags = (plastic ? 1 : 0) | (((a.spiking_mask >> i) & 1) ? 2 : 0);
    lp.th = -1;
    if (plastic && a.theta_in_smem) {
      lp.th = th;
      th += 4 * lp.nm * (a.theta_bf16 ? 2 : 4);
    }
  }
  p.slots = (int)align16(th);
  p.state = off;
  p.spare = !a.double_buffer ? 0 : staged ? soff : off;
  p.bars = p.state + p.spare + (int)align16(2 * (size_t)p.widest * 4);
  p.slot = p.bars + (a.double_buffer ? kBarBytes : 0);
  p.total = p.slots + a.block_b * p.slot;
  return p;
}

using ff::Types;

// ---- copies -----------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
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

// ---- mbarriers and 1-D bulk copies (TMA) ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed; trap after
// kSpinCycles rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > kSpinCycles) __trap();
  }
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// into shared memory by the copy engine; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The same from shared memory to device memory, in the thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

// The thread's bulk stores: committed; their shared memory read; done.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// ---- one update chunk's loads ------------------------------------------------

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
  const unsigned bits = __float_as_uint(scale);
  const unsigned e = (bits >> 23) & 0xff;
  const bool pow2 = (bits & 0x7fffff) == 0 && e >= 1 && e <= 253;
  return QLayer{scale, pow2 ? __fdiv_rn(1.0f, scale) : 0.0f,
                ff::qclip(w_clip, scale)};
}

// Phase 2 of one layer for one stream: the group's threads walk the
// synapses in chunks of V, thread gt starting at chunk gt, i.e. at (r, c),
// and stepping V * T synapses = (d_row, d_col).  kPow2: dw / scale as
// dw * (1 / scale), exact for a power-of-two scale.
template <bool Q, int V, bool kPow2, typename TH>
__device__ __forceinline__ void update_layer(
    typename Types<Q>::W* __restrict__ w, const TH* __restrict__ th,
    const typename Types<Q>::S* __restrict__ pre,
    const typename Types<Q>::S* __restrict__ post, const LayerPlan& lp,
    int r, int c, int gt, int nt, float w_clip, const QLayer& ql, int seed,
    const ff::QParams& q) {
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
        wv[u] = ff::q_steps_clip(wv[u], st, ql.qmax, seed, o + u, q);
      }
      store_i8<V>(w + o, wv);
    } else {
      float wv[V], pv[V];
      load_f<V>(wv, w + o);
      load_f<V>(pv, post + c);
      const float pr = pre[r];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float coef[4] = {co[0][u], co[1][u], co[2][u], co[3][u]};
        wv[u] = ff::plastic_f_coef(wv[u], coef, __fmul_rn(pr, pv[u]), pr,
                                   pv[u], w_clip);
      }
      if constexpr (V == 4)
        *(float4*)(w + o) = make_float4(wv[0], wv[1], wv[2], wv[3]);
      else
        w[o] = wv[0];
    }
    c += d_col;
    r += d_row;
    if (c >= m) {
      c -= m;
      ++r;
    }
  }
}

template <bool Q, int V, typename TH>
__device__ __forceinline__ void update_q(
    typename Types<Q>::W* w, const TH* th, const typename Types<Q>::S* pre,
    const typename Types<Q>::S* post, const LayerPlan& lp, int r, int c,
    int gt, int nt, float w_clip, const QLayer& ql, int seed,
    const ff::QParams& q) {
  if constexpr (Q) {
    if (ql.inv != 0.0f) {
      update_layer<Q, V, true>(w, th, pre, post, lp, r, c, gt, nt, w_clip,
                               ql, seed, q);
      return;
    }
  }
  update_layer<Q, V, false>(w, th, pre, post, lp, r, c, gt, nt, w_clip, ql,
                            seed, q);
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

// S and W: state and weights as held in shared memory (float | int32, float
// | int8); G and WG: as held in device memory (T = float | bfloat16 on the
// float path); TH: the rules' type (float | bfloat16).
template <bool Q, bool kTel, typename T, typename TH>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rollout_kernel(const __grid_constant__ RolloutArgs a,
                   const __grid_constant__ Plan p) {
  using ff::cvt;
  using S = typename Types<Q>::S;
  using W = typename Types<Q>::W;
  using G = std::conditional_t<Q, int, T>;
  using WG = std::conditional_t<Q, int8_t, T>;
  constexpr bool kStaged = !std::is_same_v<G, S>;  // bfloat16 lands raw
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.n_layers, B = a.batch, K = a.k_steps, n0 = a.sizes[0];
  const int nt = 32 * a.warps;                    // threads of a group
  const int group = threadIdx.x / nt, gt = threadIdx.x - group * nt;
  const int n_arrays = 3 * L + 1;                 // w, v, traces

  constexpr bool kSame = std::is_same_v<G, S> && std::is_same_v<WG, W>;
  unsigned char* work = smem + p.slots + group * p.slot;
  unsigned char* spare = work + p.state;
  S* const bus0 = (S*)(spare + p.spare);
  S* const bus1 = bus0 + p.widest;
  const uint32_t rules_bar = smem_u32(smem);
  const uint32_t slot_bar = smem_u32(work + p.bars);   // + 8 * buffer
  int cur = 0;           // the slot's buffer `work` is (two state buffers)
  uint32_t phase = 0;    // the parity each buffer's mbarrier waits on next

  // The group's stream `s` into `buf` (at the fetch offsets), in flight:
  // the 16-byte segments by one thread through the copy engine, counted on
  // buffer b's mbarrier, the rest by cp.async of the group's threads.
  auto fetch = [&](int s, unsigned char* buf, int b) {
    if (gt == 0 && p.bulk) {
      mbar_expect_tx(slot_bar + 8 * b, p.bulk);
      for (int g = 0; g < p.n_seg; ++g) {
        const Seg& sg = p.seg[g];
        if (sg.fetch16)
          bulk_load(buf + sg.soff,
                    (const unsigned char*)sg.in + (long)s * sg.raw, sg.raw,
                    slot_bar + 8 * b);
      }
    }
    for (int g = 0; g < p.n_seg; ++g) {
      const Seg& sg = p.seg[g];
      if (!sg.fetch16)
        fetch_bytes(buf + sg.soff,
                    (const unsigned char*)sg.in + (long)s * sg.raw, sg.raw,
                    gt, nt);
    }
  };
  auto arrive = [&](int b) {       // buffer b's fetch, complete
    if (p.bulk) {
      mbar_wait(slot_bar + 8 * b, (phase >> b) & 1);
      phase ^= 1u << b;
    }
    cp_async_wait_all();
  };
  // With one buffer a stream: stream `s` loaded into the state buffer at
  // once (promoted on the way), once the last stream has left it.
  auto load = [&](int s) {
    for (int g = 0; g < p.n_seg; ++g) {
      const Seg& sg = p.seg[g];
      if (g < L)
        convert_copy((W*)(work + sg.off), (const WG*)sg.in + (long)s * sg.count,
                     sg.count, sg.fetch16, gt, nt);
      else if (g < n_arrays)
        convert_copy((S*)(work + sg.off), (const G*)sg.in + (long)s * sg.count,
                     sg.count, sg.fetch16, gt, nt);
      else
        convert_copy((int*)(work + sg.off), (const int*)sg.in + s, 1, false,
                     gt, nt);
    }
  };
  // A stream's active flag and first drive row, read a stream ahead with
  // no branch on either until they are used.
  const G* drives = (const G*)a.drives;
  auto flag = [&](int s) {
    return s < B ? (a.active == nullptr ? 1 : (int)a.active[s]) : 0;
  };
  auto drive0 = [&](int s) {
    return s < B && gt < n0 ? drives[(long)s * n0 + gt] : G{};
  };

  const int stride = gridDim.x * a.block_b;
  const bool ahead = a.double_buffer;
  int s = blockIdx.x * a.block_b + group;
  int on_flag = flag(s);
  G d0 = drive0(s);
  if (threadIdx.x == 0) mbar_init(rules_bar);
  if (ahead && gt == 0) {
    mbar_init(slot_bar);
    mbar_init(slot_bar + 8);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  // the rules, once per CTA: whole 16-byte pieces through the copy engine
  auto rule_bytes = [&](int i) { return 4 * p.layer[i].nm * (int)sizeof(TH); };
  auto rule_bulk = [&](int i) {
    return (((uintptr_t)a.theta[i] | p.layer[i].th | rule_bytes(i)) & 15)
           == 0;
  };
  uint32_t rules = 0;
  for (int i = 0; i < L; ++i)
    if (p.layer[i].th >= 0 && rule_bulk(i)) rules += rule_bytes(i);
  if (threadIdx.x == 0 && rules) mbar_expect_tx(rules_bar, rules);
  for (int i = 0; i < L; ++i) {
    if (p.layer[i].th < 0) continue;
    if (!rule_bulk(i))
      fetch_bytes(smem + p.layer[i].th, (const unsigned char*)a.theta[i],
                  rule_bytes(i), threadIdx.x, blockDim.x);
    else if (threadIdx.x == 0)
      bulk_load(smem + p.layer[i].th, a.theta[i], rule_bytes(i), rules_bar);
  }
  if (s < B) {
    if (ahead) fetch(s, kStaged ? spare : work, kStaged ? 1 : 0);
    else load(s);
  }
  cp_async_commit();
  if (rules) mbar_wait(rules_bar, 0);
  cp_async_wait_all();
  __syncthreads();

  // Each thread's first update chunk of each layer, as (row, column).
  int r0[kMaxLayers], c0[kMaxLayers];
  for (int i = 0; i < L; ++i) {
    const int o = p.layer[i].vec * gt, m = p.layer[i].m;
    r0[i] = o / m;
    c0[i] = o - r0[i] * m;
  }

  for (; s < B; s += stride) {
    if (ahead) arrive(kStaged ? 1 : cur);
    if (kSame && ahead && gt == 0) bulk_wait_read();   // the last stream's
    group_sync(group, nt);
    if constexpr (kStaged) {
      if (ahead) {
        for (int g = 0; g < n_arrays; ++g) {
          const Seg& sg = p.seg[g];
          convert_copy((float*)(work + sg.off), (const G*)(spare + sg.soff),
                       sg.count, true, gt, nt);
        }
        group_sync(group, nt);
      }
    }
    const int s_next = s + stride;
    if (ahead && s_next < B) fetch(s_next, spare, kStaged ? 1 : cur ^ 1);
    cp_async_commit();
    const int on_next = flag(s_next);
    const G d0_next = drive0(s_next);
    const bool on = on_flag != 0;

    float tel_ev = 0.0f, tel_sat = 0.0f;          // kTel: lane 0 of warp 0
    if (on) {
      QLayer ql[kMaxLayers];
      int seed0 = 0;
      if constexpr (Q) {
        const float* sc = (const float*)(work + p.scal);
        for (int i = 0; i < L; ++i) ql[i] = q_layer(sc[i], a.w_clip);
        seed0 = ((const int*)(work + p.scal))[L];
      }
      G d_next = d0;                              // the drive, a step ahead
      for (int k = 0; k < K; ++k) {
        // ---- input population: drive onto the bus, trace update ---------
        const G d_cur = d_next;
        if (k + 1 < K && gt < n0)
          d_next = drives[((long)(k + 1) * B + s) * n0 + gt];
        const G* row = drives + ((long)k * B + s) * n0;
        S* tr0 = (S*)(work + p.tr[0]);
        for (int e = gt; e < n0; e += nt) {
          const S x = cvt<S>(e == gt ? d_cur : row[e]);
          bus0[e] = x;
          if constexpr (Q) tr0[e] = ff::trace_q(tr0[e], x, a.q);
          else tr0[e] = __fmaf_rn(a.f.decay, tr0[e], x);
        }
        group_sync(group, nt);

        S* x_bus = bus0;
        S* y_bus = bus1;
        for (int i = 0; i < L; ++i) {
          const LayerPlan& lp = p.layer[i];
          const int n = lp.n, m = lp.m;
          const bool spiking = lp.flags & 2, last = i == L - 1;
          const W* w = (const W*)(work + lp.w);
          S* v = (S*)(work + lp.v);
          S* tpost = (S*)(work + p.tr[i + 1]);
          // ---- phase 1: Forward Engine --------------------------------
          auto column = [&](int c, S acc) {
            S ev, vn;
            const long at = ((long)k * B + s) * m + c;
            if constexpr (Q) {
              int i_fx = ff::current_fx(acc, ql[i].scale);
              if (last && a.teach)
                i_fx = ff::wadd(i_fx, ((const int*)a.teach)[at]);
              ff::neuron_q(v[c], i_fx, spiking, a.q, &ev, &vn);
              tpost[c] = ff::trace_q(tpost[c], ev, a.q);
            } else {
              if (last && a.teach) acc = acc + ((const float*)a.teach)[at];
              ff::neuron_f(v[c], acc, spiking, a.f, &ev, &vn);
              tpost[c] = __fmaf_rn(a.f.decay, tpost[c], ev);
            }
            v[c] = vn;
            const S out = spiking ? ev : vn;
            y_bus[c] = out;
            if (last) ((G*)a.outs)[at] = cvt<G>(out);
          };
          auto psum = [&](int c, int r, int step) {
            S acc = 0;
#pragma unroll 4
            for (; r < n; r += step) {
              if constexpr (Q)
                acc = ff::wadd(acc, ff::wmul(x_bus[r], (int)w[r * m + c]));
              else
                acc = acc + x_bus[r] * w[r * m + c];
            }
            return acc;
          };
          if (lp.cmaj) {
            const int lane = gt - (nt - 32);
            if (lane >= 0) {
              const int c = lane & (m - 1), q = lane >> (5 - lp.lg_r);
              S acc = psum(c, q, 1 << lp.lg_r);
              for (int off = 16; off >= m; off >>= 1) {
                const S o = __shfl_xor_sync(0xffffffffu, acc, off);
                if constexpr (Q) acc = ff::wadd(acc, o);
                else acc = acc + o;
              }
              if (q == 0) column(c, acc);
            }
          } else if (lp.lg_r == 0) {
            for (int c = gt; c < m; c += nt) column(c, psum(c, 0, 1));
          } else {
            const int rs = 1 << lp.lg_r;
            const int c = gt >> lp.lg_r, q = gt & (rs - 1);
            S acc = c < m ? psum(c, q, rs) : S(0);
            for (int off = rs >> 1; off > 0; off >>= 1) {
              const S o = __shfl_xor_sync(0xffffffffu, acc, off);
              if constexpr (Q) acc = ff::wadd(acc, o);
              else acc = acc + o;
            }
            if (c < m && q == 0) column(c, acc);
          }
          group_sync(group, nt);
          // ---- telemetry: this layer's event and saturation means -------
          // Events from the bus in event units (a readout's output is its
          // membrane: back through tanh or the fixed-point clip); saturation
          // on the updated membrane.  The group's first warp reads what no
          // thread rewrites before the step's last barrier.
          if constexpr (kTel) {
            if (gt < 32) {
              if constexpr (Q) {
                int ev = 0, sat = 0;
                for (int c = gt; c < m; c += 32) {
                  const int x = y_bus[c];
                  ev += wabs(spiking ? x : min(max(x, -a.q.one), a.q.one));
                  sat += wabs(v[c]) >= a.sat_q;
                }
                ev = warp_sum(ev);
                sat = warp_sum(sat);
                tel_ev = tel_ev +
                    __int2float_rn(ev) / (float)a.q.one / (float)m;
                tel_sat = tel_sat + __int2float_rn(sat) / (float)m;
              } else {
                float ev = 0.0f, sat = 0.0f;
                for (int c = gt; c < m; c += 32) {
                  ev = ev + fabsf(spiking ? y_bus[c] : tanhf(y_bus[c]));
                  sat = sat + (fabsf(v[c]) >= a.sat_f ? 1.0f : 0.0f);
                }
                ev = warp_sum(ev);
                sat = warp_sum(sat);
                tel_ev = tel_ev + ev / (float)m;
                tel_sat = tel_sat + sat / (float)m;
              }
            }
          }
          // ---- phase 2: Plasticity Engine on the resident weights -------
          // It writes w_i alone and the next layer's phase 1 reads w_i+1,
          // so no barrier divides them.
          if (lp.flags & 1) {
            W* wm = (W*)(work + lp.w);
            const S* pre = (const S*)(work + p.tr[i]);
            const int seed = Q ? ff::fold_seed(ff::wadd(seed0, k), i) : 0;
            const int r = r0[i], c = c0[i];
            const TH* th_l2 = (const TH*)a.theta[i];
            if (lp.vec == 4) {
              if (lp.th >= 0)
                update_q<Q, 4>(wm, (const TH*)(smem + lp.th), pre, tpost, lp,
                               r, c, gt, nt, a.w_clip, ql[i], seed, a.q);
              else
                update_q<Q, 4>(wm, th_l2, pre, tpost, lp, r, c, gt, nt,
                               a.w_clip, ql[i], seed, a.q);
            } else {
              if (lp.th >= 0)
                update_q<Q, 1>(wm, (const TH*)(smem + lp.th), pre, tpost, lp,
                               r, c, gt, nt, a.w_clip, ql[i], seed, a.q);
              else
                update_q<Q, 1>(wm, th_l2, pre, tpost, lp, r, c, gt, nt,
                               a.w_clip, ql[i], seed, a.q);
            }
          }
          S* t = x_bus;
          x_bus = y_bus;
          y_bus = t;
        }
        // the next step's drive rewrites the bus and the input trace
        group_sync(group, nt);
      }
    } else {
      // an inactive stream keeps its state; its readout rows are zero
      const int ml = a.sizes[L];
      for (int k = 0; k < K; ++k)
        for (int c = gt; c < ml; c += nt)
          ((G*)a.outs)[((long)k * B + s) * ml + c] = cvt<G>(S(0));
    }

    // ---- telemetry: net weight motion, finalize, gate, write -----------
    if constexpr (kTel) {
      if (gt < 32) {
        int n_plastic = 0;
        for (int i = 0; i < L; ++i) n_plastic += (a.plastic_mask >> i) & 1;
        float mean_dw = 0.0f;
        for (int i = 0; on && i < L; ++i) {
          const LayerPlan& lp = p.layer[i];
          if (!(lp.flags & 1)) continue;
          const W* w_end = (const W*)(work + lp.w);
          const WG* w_start = (const WG*)a.w_in[i] + (long)s * lp.nm;
          float per_slot;
          if constexpr (Q) {
            int d = 0;
            for (int o = gt; o < lp.nm; o += 32)
              d += abs((int)w_end[o] - (int)w_start[o]);
            per_slot = __int2float_rn(warp_sum(d)) *
                       ((const float*)(work + p.scal))[i];
          } else {
            float d = 0.0f;
            for (int o = gt; o < lp.nm; o += 32)
              d = d + fabsf(w_end[o] - cvt<float>(w_start[o]));
            per_slot = warp_sum(d);
          }
          mean_dw = mean_dw + per_slot / (float)lp.nm;
        }
        if (n_plastic) mean_dw = mean_dw / (float)(K * n_plastic);
        if (gt == 0) {
          const float kl = (float)(K * L);
          float* row = a.tel + (long)s * 3;
          row[0] = on ? tel_ev / kl : 0.0f;
          row[1] = on ? mean_dw : 0.0f;
          row[2] = on ? tel_sat / kl : 0.0f;
        }
      }
    }

    // ---- single write-back of the window's state ------------------------
    // In float32 and int8 the 16-byte segments leave through the copy
    // engine (after the step's last barrier; the fence makes the group's
    // stores visible to it); the rest, and bfloat16's rounding, by the
    // group's threads.
    const bool bulk_out = kSame && ahead;
    if (bulk_out && gt == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int g = 0; g < n_arrays; ++g) {
        const Seg& sg = p.seg[g];
        if (sg.store16)
          bulk_store((unsigned char*)sg.out + (long)s * sg.raw, work + sg.off,
                     sg.raw);
      }
      bulk_commit();
    }
    for (int g = 0; g < n_arrays; ++g) {
      const Seg& sg = p.seg[g];
      if (bulk_out && sg.store16) continue;
      if (g < L)
        convert_copy((WG*)sg.out + (long)s * sg.count,
                     (const W*)(work + sg.off), sg.count, sg.store16, gt, nt);
      else
        convert_copy((G*)sg.out + (long)s * sg.count,
                     (const S*)(work + sg.off), sg.count, sg.store16, gt, nt);
    }
    group_sync(group, nt);           // the buffer is fetched into next
    if (!ahead) {
      if (s_next < B) load(s_next);
    } else if constexpr (!kStaged) {
      unsigned char* t = work;
      work = spare;
      spare = t;
      cur ^= 1;
    }
    on_flag = on_next;
    d0 = d0_next;
  }
  cp_async_wait_all();
  if (gt == 0) bulk_wait();
}

template <bool Q, bool kTel, typename T, typename TH>
struct Launch {
  static int run(const RolloutArgs* a, const Plan* p, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        rollout_kernel<Q, kTel, T, TH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p->total);
    if (err != cudaSuccess) return (int)err;
    rollout_kernel<Q, kTel, T, TH>
        <<<a->ctas, 32 * a->warps * a->block_b, p->total, stream>>>(*a, *p);
    return (int)cudaGetLastError();
  }
};

template <bool Q, bool kTel, typename T, typename TH>
struct Occupancy {
  static int run(const RolloutArgs* a, const Plan* p, int* blocks) {
    const cudaError_t err = cudaFuncSetAttribute(
        rollout_kernel<Q, kTel, T, TH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p->total);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, rollout_kernel<Q, kTel, T, TH>, 32 * a->warps * a->block_b,
        p->total);
  }
};

// F<Q, kTel, T, TH>::run(args...) for the instantiation `a` selects.
template <template <bool, bool, typename, typename> class F, typename... A>
int dispatch(const RolloutArgs* a, int quant, A... args) {
  using bf16 = __nv_bfloat16;
  const bool tel = a->telemetry != 0;
  if (quant)
    return tel ? F<true, true, float, float>::run(args...)
               : F<true, false, float, float>::run(args...);
  if (!a->bf16)
    return tel ? F<false, true, float, float>::run(args...)
               : F<false, false, float, float>::run(args...);
  if (a->theta_bf16)
    return tel ? F<false, true, bf16, bf16>::run(args...)
               : F<false, false, bf16, bf16>::run(args...);
  return tel ? F<false, true, bf16, float>::run(args...)
             : F<false, false, bf16, float>::run(args...);
}

bool valid(const RolloutArgs* a, int quant) {
  const int threads = 32 * a->warps * a->block_b;
  return a->n_layers >= 1 && a->n_layers <= kMaxLayers && a->block_b >= 1 &&
         a->warps >= 1 && (a->warps & (a->warps - 1)) == 0 &&
         threads <= kMaxThreads &&
         (a->warps == 1 || a->block_b <= kMaxBarrierGroups) &&
         !(quant && (a->bf16 || a->theta_bf16)) &&
         !(a->theta_bf16 && !a->bf16);
}

}  // namespace

// expected_smem: the wrapper's count; a mismatch means the two layouts have
// drifted apart and the launch is refused.
extern "C" int rollout(const RolloutArgs* a, int quant, size_t expected_smem,
                       cudaStream_t stream) {
  if (!valid(a, quant) || (a->telemetry != 0) != (a->tel != nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(*a, quant != 0);
  if ((size_t)p.total != expected_smem) return (int)cudaErrorInvalidValue;
  if (a->batch == 0) return (int)cudaSuccess;
  if (a->ctas < 1) return (int)cudaErrorInvalidValue;
  return dispatch<Launch>(a, quant, a, &p, stream);
}

// CTAs of the launch `a` describes (threads and shared memory as its plan
// gives them) that one SM holds at once, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int rollout_occupancy(const RolloutArgs* a, int quant,
                                 size_t expected_smem, int* blocks) {
  if (!valid(a, quant)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(*a, quant != 0);
  if ((size_t)p.total != expected_smem) return (int)cudaErrorInvalidValue;
  return dispatch<Occupancy>(a, quant, a, &p, blocks);
}
