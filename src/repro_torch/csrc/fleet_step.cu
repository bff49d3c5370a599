// Fleet dual-engine step: one SNN timestep of one synaptic layer for B
// request streams, each with its own weights (B, N, M) under one shared rule
// theta (4, N, M).  Two kernels, one per datapath:
//
//   fleet_step_f32  replaces src/repro/kernels/plasticity/kernel.py:256
//                   dual_engine_fleet_step_pallas (_fleet_kernel :188)
//   fleet_step_q    replaces src/repro/kernels/plasticity/kernel.py:559
//                   dual_engine_fleet_step_q_pallas (_fleet_kernel_q :493)
//
// The float kernel is a template on its element type: fleet_step_f32 runs
// it in float32, fleet_step_bf16 in bfloat16 (the Pallas body's generic
// dtype, kernel.py:330-333).  In bfloat16 every operand is promoted to
// float32 on load (the rule may be float32 or bfloat16), the arithmetic is
// the float32 instantiation's operation for operation, and each output is
// rounded to bfloat16 once, on store; the dw reads the unrounded float32
// post trace.  Only the bytes change: 4 per synapse each way instead of 8.
//
// What bounds it on an H100: bytes.  Per call the step reads each stream's
// weights once and writes them once (8 bytes per synapse in fp32, 2 in
// int8); the psum and the four-term update are a few operations per synapse,
// about 1 operation per byte, far below the card's balance point.
//
// Design: one thread per (stream b, postsynaptic column m).  The thread
// loops over the fan-in N for the psum — w[b, n, m] is contiguous in m, so a
// warp's loads are coalesced — runs the neuron and trace update in
// registers, then loops over N again to write the clipped new weights.  The
// second pass reads the same weight column again, now from L1/L2, so device
// memory sees each weight byte once in each direction.  theta is indexed by
// (n, m) only: every stream reads the same planes, and L2 serves them to the
// whole fleet (the counterpart of the TPU kernel's theta DMA elided across
// streams).  Inactive slots compute nothing and copy their state through,
// which is bit-identical to the reference's compute-then-select.
//
// Telemetry variant (a template flag; the entry points take it when
// `tel` is set): the same program also emits the per-slot raw telemetry sums
// [sum |events|, sum |dw|, #|v| >= 0.9 v_th], gated like the state writes,
// replacing _fleet_kernel's telemetry (kernel.py:239) and _fleet_kernel_q's
// (kernel.py:538).  In bfloat16 the event and saturation terms read the
// rounded outputs back, as the Pallas body does (kernel.py:245-246), and
// |dw| the float32 weights before their rounding (:247).  Each thread
// reduces its own column while the values are in registers (|dw|
// accumulates in the write loop), then a warp segments its 32 flat (b, m)
// elements by stream and sums each segment toward its first lane with
// shuffles.  That lane writes one partial per (stream, warp
// piece) into a zeroed (B, tiles, 3) buffer, tiles = (M - 1) / 32 + 2 (the
// most warps M contiguous elements can touch); the wrapper folds the tile
// axis.  No atomics: the float partials come out in the same order on every
// run, and the fixed-point terms stay int32 counts (events in 0/one units,
// dw in grid steps) until the wrapper's one division and scaling.
#include "plasticity.cuh"

// Arguments of one launch; mirrored by kernel.py _FleetStepArgs (ctypes).
// Outside the anonymous namespace: the C entry points below take it, and a
// parameter type with internal linkage would keep them from being exported.
struct FleetStepArgs {
  const void* x;            // (B, N) float32 | bfloat16 | int32
  const void* w;            // (B, N, M) float32 | bfloat16 | int8
  const void* theta;        // (4, N, M) float32 | bfloat16, or null
  const void* v;            // (B, M)
  const void* trace_pre;    // (B, N)
  const void* trace_post;   // (B, M)
  const void* teach;        // (B, M) float32 | int32, or null
  const uint8_t* active;    // (B,) or null
  const float* scale;       // (B,) int8 only
  const int* seed;          // (B,) int8 only
  void* events;             // (B, M) out
  void* v_out;              // (B, M) out
  void* trace_post_out;     // (B, M) out
  void* w_out;              // (B, N, M) out
  int batch, n, m, plastic, spiking;
  float w_clip;
  ff::FParams f;
  ff::QParams q;
  void* tel;                // (B, tiles, 3) float32 | int32 out, or null
  int tiles;                // (M - 1) / 32 + 2
  int sat_q;                // fixed-point saturation threshold on |v|
  float sat_f;              // float saturation threshold on |v|
  int theta_bf16;           // bfloat16 kernel: theta is bfloat16, not float32
};

namespace {

constexpr int kThreads = 128;

// Sum each stream's elements of this warp toward the stream's first lane
// and write them as one partial of the (B, tiles, 3) buffer.  Every lane of
// the warp calls it (lanes past B * M with zeros), since shuffles need the
// whole warp.
template <typename T>
__device__ __forceinline__ void tel_partials(const FleetStepArgs& a, long gid,
                                             T ev, T dw, T sat) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool valid = gid < (long)a.batch * a.m;
  const int seg = valid ? (int)(gid / a.m) : -1;     // the stream
  // segments are contiguous runs of lanes, so after step `off` each lane
  // holds the sum of its segment's lanes in [lane, lane + 2 * off)
  for (int off = 1; off < 32; off <<= 1) {
    const T e2 = __shfl_down_sync(kAll, ev, off);
    const T d2 = __shfl_down_sync(kAll, dw, off);
    const T s2 = __shfl_down_sync(kAll, sat, off);
    const int g2 = __shfl_down_sync(kAll, seg, off);
    if (lane + off < 32 && g2 == seg) {
      ev = ev + e2;
      dw = dw + d2;
      sat = sat + s2;
    }
  }
  const int prev = __shfl_up_sync(kAll, seg, 1);
  if (valid && (lane == 0 || prev != seg)) {
    const long piece = (gid >> 5) - (((long)seg * a.m) >> 5);
    T* out = (T*)a.tel + ((long)seg * a.tiles + piece) * 3;
    out[0] = ev;
    out[1] = dw;
    out[2] = sat;
  }
}

// T: the element type of x, w, v and the traces (float | bfloat16); TH:
// the rule's; teach is float32.  Compute is float32 throughout.
template <typename T, typename TH, bool kTel>
__global__ void __launch_bounds__(kThreads)
fleet_step_float_kernel(FleetStepArgs a) {
  using ff::cvt;
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  float t_ev = 0.0f, t_dw = 0.0f, t_sat = 0.0f;
  if (gid < (long)a.batch * a.m) {
    const int b = (int)(gid / a.m), col = (int)(gid % a.m);
    const long nm = (long)a.n * a.m;
    const T* __restrict__ x = (const T*)a.x + (long)b * a.n;
    const T* __restrict__ w = (const T*)a.w + b * nm + col;
    T* __restrict__ w_out = (T*)a.w_out + b * nm + col;

    float acc = 0.0f;                       // psum, fan-in order
    for (int i = 0; i < a.n; ++i)
      acc = acc + cvt<float>(x[i]) * cvt<float>(w[(long)i * a.m]);
    if (a.teach) acc = acc + ((const float*)a.teach)[gid];

    const T v_raw = ((const T*)a.v)[gid];
    const T tp_raw = ((const T*)a.trace_post)[gid];
    const bool on = a.active == nullptr || a.active[b] != 0;
    float ev, v_new;
    ff::neuron_f(cvt<float>(v_raw), acc, a.spiking, a.f, &ev, &v_new);
    const float tp = __fmaf_rn(a.f.decay, cvt<float>(tp_raw), ev);
    const T ev_t = cvt<T>(on ? ev : 0.0f), v_t = on ? cvt<T>(v_new) : v_raw;
    ((T*)a.events)[gid] = ev_t;
    ((T*)a.v_out)[gid] = v_t;
    ((T*)a.trace_post_out)[gid] = on ? cvt<T>(tp) : tp_raw;
    if constexpr (kTel) {                   // the stored (rounded) values
      t_ev = fabsf(cvt<float>(ev_t));
      t_sat = on && fabsf(cvt<float>(v_t)) >= a.sat_f ? 1.0f : 0.0f;
    }

    if (a.plastic && on) {
      const T* pre = (const T*)a.trace_pre + (long)b * a.n;
      const TH* th = (const TH*)a.theta + col;
      for (int i = 0; i < a.n; ++i) {
        const long o = (long)i * a.m;
        const float w_old = cvt<float>(w[o]);
        const float wn = ff::plastic_f(w_old, th + o, nm, cvt<float>(pre[i]),
                                       tp, a.w_clip);
        w_out[o] = cvt<T>(wn);
        if constexpr (kTel) t_dw = t_dw + fabsf(wn - w_old);
      }
    } else {
      for (int i = 0; i < a.n; ++i) w_out[(long)i * a.m] = w[(long)i * a.m];
    }
  }
  if constexpr (kTel) tel_partials<float>(a, gid, t_ev, t_dw, t_sat);
}

// |x| with the reference's int32 wrap-around (|INT_MIN| stays INT_MIN).
__device__ __forceinline__ int wabs(int x) { return x < 0 ? ff::wsub(0, x) : x; }

template <bool kTel>
__global__ void __launch_bounds__(kThreads)
fleet_step_q_kernel(FleetStepArgs a) {
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  int t_ev = 0, t_dw = 0, t_sat = 0;
  if (gid < (long)a.batch * a.m) {
    const int b = (int)(gid / a.m), col = (int)(gid % a.m);
    const long nm = (long)a.n * a.m;
    const int* __restrict__ x = (const int*)a.x + (long)b * a.n;
    const int8_t* __restrict__ w = (const int8_t*)a.w + b * nm + col;
    int8_t* __restrict__ w_out = (int8_t*)a.w_out + b * nm + col;
    const float scale = a.scale[b];

    int acc = 0;                            // exact int32 psum
    for (int i = 0; i < a.n; ++i)
      acc = ff::wadd(acc, ff::wmul(x[i], (int)w[(long)i * a.m]));
    int i_fx = ff::current_fx(acc, scale);
    if (a.teach) i_fx = ff::wadd(i_fx, ((const int*)a.teach)[gid]);

    const int v = ((const int*)a.v)[gid];
    const int tp_old = ((const int*)a.trace_post)[gid];
    const bool on = a.active == nullptr || a.active[b] != 0;
    int ev, v_new;
    ff::neuron_q(v, i_fx, a.spiking, a.q, &ev, &v_new);
    const int tp = ff::trace_q(tp_old, ev, a.q);
    ((int*)a.events)[gid] = on ? ev : 0;
    ((int*)a.v_out)[gid] = on ? v_new : v;
    ((int*)a.trace_post_out)[gid] = on ? tp : tp_old;
    if constexpr (kTel) {
      t_ev = on ? wabs(ev) : 0;
      t_sat = on && wabs(v_new) >= a.sat_q ? 1 : 0;
    }

    if (a.plastic && on) {
      const int* pre = (const int*)a.trace_pre + (long)b * a.n;
      const float* th = (const float*)a.theta + col;
      const int qmax = ff::qclip(a.w_clip, scale);
      const int seed = a.seed[b];
      for (int i = 0; i < a.n; ++i) {
        const long o = (long)i * a.m;
        // hash counter: the GLOBAL (row * M + col) index, never the slot
        const int wn = ff::plastic_q((int)w[o], th + o, nm, pre[i], tp,
                                     scale, qmax, seed, (int)o + col, a.q);
        w_out[o] = (int8_t)wn;
        if constexpr (kTel) t_dw += abs(wn - (int)w[o]);
      }
    } else {
      for (int i = 0; i < a.n; ++i) w_out[(long)i * a.m] = w[(long)i * a.m];
    }
  }
  if constexpr (kTel) tel_partials<int>(a, gid, t_ev, t_dw, t_sat);
}

int launch(void (*kernel)(FleetStepArgs), const FleetStepArgs* a,
           cudaStream_t stream) {
  const long work = (long)a->batch * a->m;
  if (work == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((work + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

template <typename T, typename TH>
int launch_float(const FleetStepArgs* a, cudaStream_t stream) {
  return launch(a->tel ? fleet_step_float_kernel<T, TH, true>
                       : fleet_step_float_kernel<T, TH, false>, a, stream);
}

}  // namespace

// With a->tel set, the telemetry variant runs; the wrapper zeroes a->tel.
extern "C" int fleet_step_f32(const FleetStepArgs* a, cudaStream_t stream) {
  return launch_float<float, float>(a, stream);
}

extern "C" int fleet_step_bf16(const FleetStepArgs* a, cudaStream_t stream) {
  return a->theta_bf16 ? launch_float<__nv_bfloat16, __nv_bfloat16>(a, stream)
                       : launch_float<__nv_bfloat16, float>(a, stream);
}

extern "C" int fleet_step_q(const FleetStepArgs* a, cudaStream_t stream) {
  return launch(a->tel ? fleet_step_q_kernel<true>
                       : fleet_step_q_kernel<false>, a, stream);
}
