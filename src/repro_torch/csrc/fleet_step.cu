// Fleet dual-engine step: one SNN timestep of one synaptic layer for B
// request streams, each with its own weights (B, N, M) under one shared rule
// theta (4, N, M).  Two kernels, one per datapath:
//
//   fleet_step_f32  replaces src/repro/kernels/plasticity/kernel.py:256
//                   dual_engine_fleet_step_pallas (_fleet_kernel :188)
//   fleet_step_q    replaces src/repro/kernels/plasticity/kernel.py:559
//                   dual_engine_fleet_step_q_pallas (_fleet_kernel_q :493)
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
#include "plasticity.cuh"

// Arguments of one launch; mirrored by kernel.py _FleetStepArgs (ctypes).
// Outside the anonymous namespace: the C entry points below take it, and a
// parameter type with internal linkage would keep them from being exported.
struct FleetStepArgs {
  const void* x;            // (B, N) float32 | int32
  const void* w;            // (B, N, M) float32 | int8
  const float* theta;       // (4, N, M) or null (not plastic)
  const void* v;            // (B, M)
  const void* trace_pre;    // (B, N)
  const void* trace_post;   // (B, M)
  const void* teach;        // (B, M) or null
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
};

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fleet_step_f32_kernel(FleetStepArgs a) {
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long)a.batch * a.m) return;
  const int b = (int)(gid / a.m), col = (int)(gid % a.m);
  const long nm = (long)a.n * a.m;
  const float* __restrict__ x = (const float*)a.x + (long)b * a.n;
  const float* __restrict__ w = (const float*)a.w + b * nm + col;
  float* __restrict__ w_out = (float*)a.w_out + b * nm + col;

  float acc = 0.0f;                         // psum, fan-in order
  for (int i = 0; i < a.n; ++i) acc = acc + x[i] * w[(long)i * a.m];
  if (a.teach) acc = acc + ((const float*)a.teach)[gid];

  const float v = ((const float*)a.v)[gid];
  const float tp_old = ((const float*)a.trace_post)[gid];
  const bool on = a.active == nullptr || a.active[b] != 0;
  float ev, v_new;
  ff::neuron_f(v, acc, a.spiking, a.f, &ev, &v_new);
  const float tp = __fmaf_rn(a.f.decay, tp_old, ev);
  ((float*)a.events)[gid] = on ? ev : 0.0f;
  ((float*)a.v_out)[gid] = on ? v_new : v;
  ((float*)a.trace_post_out)[gid] = on ? tp : tp_old;

  if (a.plastic && on) {
    const float* pre = (const float*)a.trace_pre + (long)b * a.n;
    const float* th = a.theta + col;
    for (int i = 0; i < a.n; ++i) {
      const long o = (long)i * a.m;
      w_out[o] = ff::plastic_f(w[o], th + o, nm, pre[i], tp, a.w_clip);
    }
  } else {
    for (int i = 0; i < a.n; ++i) w_out[(long)i * a.m] = w[(long)i * a.m];
  }
}

__global__ void __launch_bounds__(kThreads)
fleet_step_q_kernel(FleetStepArgs a) {
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long)a.batch * a.m) return;
  const int b = (int)(gid / a.m), col = (int)(gid % a.m);
  const long nm = (long)a.n * a.m;
  const int* __restrict__ x = (const int*)a.x + (long)b * a.n;
  const int8_t* __restrict__ w = (const int8_t*)a.w + b * nm + col;
  int8_t* __restrict__ w_out = (int8_t*)a.w_out + b * nm + col;
  const float scale = a.scale[b];

  int acc = 0;                              // exact int32 psum
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

  if (a.plastic && on) {
    const int* pre = (const int*)a.trace_pre + (long)b * a.n;
    const float* th = a.theta + col;
    const int qmax = ff::qclip(a.w_clip, scale);
    const int seed = a.seed[b];
    for (int i = 0; i < a.n; ++i) {
      const long o = (long)i * a.m;
      // hash counter: the GLOBAL (row * M + col) index, never the slot
      w_out[o] = (int8_t)ff::plastic_q((int)w[o], th + o, nm, pre[i], tp,
                                       scale, qmax, seed, (int)o + col, a.q);
    }
  } else {
    for (int i = 0; i < a.n; ++i) w_out[(long)i * a.m] = w[(long)i * a.m];
  }
}

int launch(void (*kernel)(FleetStepArgs), const FleetStepArgs* a,
           cudaStream_t stream) {
  const long work = (long)a->batch * a->m;
  if (work == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((work + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fleet_step_f32(const FleetStepArgs* a, cudaStream_t stream) {
  return launch(fleet_step_f32_kernel, a, stream);
}

extern "C" int fleet_step_q(const FleetStepArgs* a, cudaStream_t stream) {
  return launch(fleet_step_q_kernel, a, stream);
}
