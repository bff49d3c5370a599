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
// post trace.
//
// What bounds it on an H100: bytes.  A step reads each stream's weights
// once and writes them once (8 bytes a synapse in float32, 4 in bfloat16, 2
// in int8) beside a few bytes of state a neuron; the psum and the four-term
// update are a few operations a synapse (~35 in fixed point, whose
// stochastic round hashes every synapse).  At the 8-128-8 controller and
// B = 4096 that is ~40 MB in float32, 0.012 ms at 3.35 TB/s.
//
// Design: a persistent grid of per-stream warp groups (the layout of
// rollout.cu's fleet window, one layer and one step deep).
//  * The unit of work is one stream's (N, M) tile.  A CTA holds `tile`
//    groups of `warps` warps; a group runs one stream, then the group's next
//    (stream += ctas * tile).  The wrapper sizes the warps to ~16 synapses a
//    thread in float, ~32 in fixed point, the tile to the streams an SM
//    takes in one wave where their buffers fit (else double-buffered), and
//    the grid from the occupancy query (kernel.py fleet_step_plan); this
//    file checks that both layouts agree.
//  * A stream arrives in shared memory by 1-D bulk copies completing on its
//    buffer's mbarrier (weights, input, pre traces, membranes and post
//    traces in their device types; cp.async for an array not in whole
//    16-byte pieces).  With two buffers a group the next stream is fetched
//    while this one computes.  The rule, where it fits a quarter of the
//    CTA's shared memory, is loaded once per CTA and serves every stream
//    the CTA walks; else it is read through L2.
//  * Phase 1, the Forward Engine (fleet.cuh forward_engine): the fan-in is
//    split across lanes (whole columns a thread for M >= T; a power-of-two
//    M < 32 on one warp, lane c + M * q summing column c's rows q, q + 32 / M,
//    ...; else adjacent lanes splitting a column's rows), the partials
//    summed by a fixed-order shuffle tree: exact in int32, whose adds wrap,
//    and the same float order on every run.  The column's thread runs the
//    neuron and the trace and writes the events, membrane and post trace;
//    the unrounded post trace stays in shared memory for phase 2.
//  * Phase 2, the Plasticity Engine (fleet.cuh update_layer): the stream's
//    synapses in chunks of 4 (16-byte loads of the weights and of each rule
//    plane) where M % 4 == 0, else one at a time, rewritten in place in
//    shared memory, and the tile leaves by one bulk copy (element by element
//    where it is not in whole 16-byte pieces).
//  * Inactive slots compute nothing and copy their state through bit for
//    bit, with zero events.
//
// Arithmetic, operation for operation as the plain versions and the Pallas
// bodies: sources built with -fmad=false, explicit __fmaf_rn where XLA
// contracts; IEEE division for dw / scale (an exact reciprocal only for a
// power-of-two scale); rintf, arithmetic shifts and the uint32 wrap of the
// hash, whose counter is the GLOBAL (row * M + col) index, never the slot.
//
// Telemetry variant (template flag kTel, set when `tel` is given): the
// kernel writes the finished (B, 3) raw row [sum |events|, sum |dw|,
// #|v| >= 0.9 v_th], zero for an inactive slot, replacing _fleet_kernel's
// telemetry (kernel.py:239) and _fleet_kernel_q's (:538).  Each thread sums
// its columns' terms in phase 1 and its synapses' |dw| in phase 2; a warp
// shuffle tree and the group's warps in order finish the row, the same
// order on every run.  In bfloat16 the event and saturation terms read the
// rounded outputs back and |dw| the float32 weights before their rounding
// (kernel.py:245-247).  In fixed point the terms are int32 counts (events
// in 0/one units, dw in grid steps) converted once, so the row equals the
// plain version's bit for bit.
#include "fleet.cuh"

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
  const uint8_t* active;    // (B,) bytes, nonzero = active; or null
  const float* scale;       // int8: (B,) or one for all (scale_stride 0)
  const int* seed;          // int8: (B,) or one for all (seed_stride 0)
  void* events;             // (B, M) out
  void* v_out;              // (B, M) out
  void* trace_post_out;     // (B, M) out
  void* w_out;              // (B, N, M) out
  float* tel;               // (B, 3) out, or null
  int batch, n, m, plastic, spiking;
  float w_clip;
  ff::FParams f;
  ff::QParams q;
  int telemetry;            // 1 when tel is set
  int sat_q;                // fixed-point saturation threshold on |v|
  float sat_f;              // float saturation threshold on |v|
  int theta_bf16;           // bfloat16 kernel: theta is bfloat16, not float32
  int scale_stride, seed_stride;   // 1: one a stream; 0: one for all
  float scale_val;          // the scale where `scale` is null
  int seed_val;             // the seed where `seed` is null
  // the launch's plan (kernel.py fleet_step_plan)
  int warps;                // warps of one stream's group
  int tile;                 // groups of a CTA
  int ctas;                 // CTAs of the persistent grid
  int theta_in_smem;        // 1: the rule is resident in shared memory
  int double_buffer;        // 1: two stream buffers a group
  int smem;                 // the wrapper's count of shared memory
};

namespace {

constexpr int kSegs = 5;        // w, x, pre traces, membranes, post traces

// Everything a launch derives from its arguments, computed on the host.
// Shared memory: the rule's mbarrier (16 bytes), the resident rule, then
// `tile` slots: one or two stream buffers (the segments in their device
// types), the new post traces in the compute type, the telemetry partials
// of the group's warps and the buffers' two mbarriers.
struct StepPlan {
  LayerPlan lp;
  Seg seg[kSegs];
  int bulk;                 // bytes of a stream's 16-byte segments
  int buf;                  // bytes of one stream buffer
  int post, red, bars, slot, slots, total;
};

StepPlan make_plan(const FleetStepArgs& a, bool quant, bool bf16,
                   bool theta_bf16) {
  StepPlan p{};
  const int wb = quant ? 1 : bf16 ? 2 : 4;   // device types
  const int sb = quant ? 4 : bf16 ? 2 : 4;
  const int threads = 32 * a.warps;
  LayerPlan& lp = p.lp;
  split_layer(lp, a.n, a.m, threads);
  lp.flags = (a.plastic ? 1 : 0) | (a.spiking ? 2 : 0);
  int off = 0;
  auto add = [&](int g, const void* in, void* out, int count, int eb) {
    Seg& sg = p.seg[g];
    sg.in = in;
    sg.out = out;
    sg.count = count;
    sg.raw = count * eb;
    sg.off = sg.soff = off;
    sg.fetch16 = ((uintptr_t)in % 16 == 0) && sg.raw % 16 == 0;
    sg.store16 = ((uintptr_t)out % 16 == 0) && sg.raw % 16 == 0;
    off += (int)align16((size_t)sg.raw);
  };
  add(0, a.w, a.w_out, lp.nm, wb);
  add(1, a.x, nullptr, a.n, sb);
  add(2, a.trace_pre, nullptr, a.n, sb);
  add(3, a.v, nullptr, a.m, sb);
  add(4, a.trace_post, nullptr, a.m, sb);
  for (int g = 0; g < kSegs; ++g)
    if (p.seg[g].fetch16) p.bulk += p.seg[g].raw;
  p.buf = off;
  int th = kBarBytes;
  lp.th = -1;
  if (a.plastic && a.theta_in_smem) {
    lp.th = th;
    th += 4 * lp.nm * (theta_bf16 ? 2 : 4);
  }
  p.slots = (int)align16(th);
  p.post = (a.double_buffer ? 2 : 1) * p.buf;
  p.red = p.post + (int)align16((size_t)a.m * 4);
  p.bars = p.red + (int)align16((size_t)a.warps * 3 * 4);
  p.slot = p.bars + kBarBytes;
  p.total = p.slots + a.tile * p.slot;
  return p;
}

// Q: fixed point; T: the float element type (float | bfloat16); TH: the
// rule's.  S is the compute type (float | int32), G and WG the state's and
// the weights' types in device memory and in a stream buffer.
template <bool Q, bool kTel, typename T, typename TH>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fleet_step_kernel(const __grid_constant__ FleetStepArgs a,
                      const __grid_constant__ StepPlan p) {
  using ff::cvt;
  using S = typename Types<Q>::S;
  using G = std::conditional_t<Q, int, T>;
  using WG = std::conditional_t<Q, int8_t, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const LayerPlan& lp = p.lp;
  const int B = a.batch, m = lp.m;
  const int nt = 32 * a.warps;                    // threads of a group
  const int group = threadIdx.x / nt, gt = threadIdx.x - group * nt;
  unsigned char* const slot = smem + p.slots + group * p.slot;
  S* const post_new = (S*)(slot + p.post);
  S* const red = (S*)(slot + p.red);
  const uint32_t rules_bar = smem_u32(smem);
  const uint32_t slot_bar = smem_u32(slot + p.bars);   // + 8 * buffer
  const bool ahead = a.double_buffer;
  int cur = 0;           // the buffer this stream is in
  uint32_t phase = 0;    // the parity each buffer's mbarrier waits on next

  // Stream `s` into buffer `b`, in flight: the 16-byte segments by one
  // thread through the copy engine, counted on the buffer's mbarrier, the
  // rest by cp.async of the group's threads.
  auto fetch = [&](int s, int b) {
    unsigned char* buf = slot + b * p.buf;
    if (gt == 0 && p.bulk) {
      mbar_expect_tx(slot_bar + 8 * b, p.bulk);
      for (int g = 0; g < kSegs; ++g) {
        const Seg& sg = p.seg[g];
        if (sg.fetch16)
          bulk_load(buf + sg.off,
                    (const unsigned char*)sg.in + (long)s * sg.raw, sg.raw,
                    slot_bar + 8 * b);
      }
    }
    for (int g = 0; g < kSegs; ++g) {
      const Seg& sg = p.seg[g];
      if (!sg.fetch16)
        fetch_bytes(buf + sg.off,
                    (const unsigned char*)sg.in + (long)s * sg.raw, sg.raw,
                    gt, nt);
    }
    cp_async_commit();
  };
  auto arrive = [&](int b) {       // buffer b's fetch, complete
    if (p.bulk) {
      mbar_wait(slot_bar + 8 * b, (phase >> b) & 1);
      phase ^= 1u << b;
    }
    cp_async_wait_all();
  };

  const int stride = gridDim.x * a.tile;
  int s = blockIdx.x * a.tile + group;
  if (threadIdx.x == 0) mbar_init(rules_bar, 1);
  if (gt == 0) {
    mbar_init(slot_bar, 1);
    mbar_init(slot_bar + 8, 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  // the rule, once per CTA: whole 16-byte pieces through the copy engine
  const int rule_bytes = 4 * lp.nm * (int)sizeof(TH);
  const bool rule_bulk =
      lp.th >= 0 && (((uintptr_t)a.theta | rule_bytes) & 15) == 0;
  if (lp.th >= 0) {
    if (!rule_bulk) {
      fetch_bytes(smem + lp.th, (const unsigned char*)a.theta, rule_bytes,
                  threadIdx.x, blockDim.x);
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(rules_bar, rule_bytes);
      bulk_load(smem + lp.th, a.theta, rule_bytes, rules_bar);
    }
  }
  if (s < B) fetch(s, 0);
  cp_async_commit();
  if (rule_bulk) mbar_wait(rules_bar, 0);
  cp_async_wait_all();
  __syncthreads();

  const TH* const th = lp.th >= 0 ? (const TH*)(smem + lp.th)
                                  : (const TH*)a.theta;
  const int r0 = lp.vec * gt / m, c0 = lp.vec * gt - r0 * m;
  for (; s < B; s += stride) {
    arrive(cur);
    if (ahead && gt == 0) bulk_wait_read();   // the last stream has left
    group_sync(group, nt);
    const int s_next = s + stride;
    if (ahead && s_next < B) fetch(s_next, cur ^ 1);
    unsigned char* const buf = slot + cur * p.buf;
    WG* const w = (WG*)(buf + p.seg[0].off);
    const G* const x = (const G*)(buf + p.seg[1].off);
    const G* const pre = (const G*)(buf + p.seg[2].off);
    const G* const v = (const G*)(buf + p.seg[3].off);
    const G* const post = (const G*)(buf + p.seg[4].off);
    G* const ev_out = (G*)a.events + (long)s * m;
    G* const v_out = (G*)a.v_out + (long)s * m;
    G* const tp_out = (G*)a.trace_post_out + (long)s * m;
    const bool on = a.active == nullptr || a.active[s] != 0;
    const float scale = !Q ? 0.0f : a.scale ? a.scale[(long)s * a.scale_stride]
                                            : a.scale_val;
    S t_ev = 0, t_dw = 0, t_sat = 0;
    if (on) {
      // ---- phase 1: Forward Engine --------------------------------------
      auto column = [&](int c, S acc) {
        S ev, vn, tp;
        if constexpr (Q) {
          int i_fx = ff::current_fx(acc, scale);
          if (a.teach)
            i_fx = ff::wadd(i_fx, ((const int*)a.teach)[(long)s * m + c]);
          ff::neuron_q(v[c], i_fx, lp.flags & 2, a.q, &ev, &vn);
          tp = ff::trace_q(post[c], ev, a.q);
          ev_out[c] = ev;
          v_out[c] = vn;
          tp_out[c] = tp;
          if constexpr (kTel) {
            t_ev += wabs(ev);
            t_sat += wabs(vn) >= a.sat_q ? 1 : 0;
          }
        } else {
          if (a.teach) acc = acc + ((const float*)a.teach)[(long)s * m + c];
          ff::neuron_f(cvt<float>(v[c]), acc, lp.flags & 2, a.f, &ev, &vn);
          tp = __fmaf_rn(a.f.decay, cvt<float>(post[c]), ev);
          const G ev_t = cvt<G>(ev), v_t = cvt<G>(vn);
          ev_out[c] = ev_t;
          v_out[c] = v_t;
          tp_out[c] = cvt<G>(tp);
          if constexpr (kTel) {   // the stored (rounded) values
            t_ev = t_ev + fabsf(cvt<float>(ev_t));
            t_sat = t_sat + (fabsf(cvt<float>(v_t)) >= a.sat_f ? 1.0f : 0.0f);
          }
        }
        post_new[c] = tp;
      };
      forward_engine<S>(x, w, lp, gt, nt, column);
      group_sync(group, nt);
      // ---- phase 2: Plasticity Engine, in place ---------------------------
      if (lp.flags & 1) {
        QLayer ql{};
        int seed = 0;
        if constexpr (Q) {
          ql = q_layer(scale, a.w_clip);
          seed = a.seed ? a.seed[(long)s * a.seed_stride] : a.seed_val;
        }
        if (lp.vec == 4)
          update_q<Q, 4, kTel>(w, th, pre, post_new, lp, r0, c0, gt, nt,
                               a.w_clip, ql, seed, a.q, &t_dw);
        else
          update_q<Q, 1, kTel>(w, th, pre, post_new, lp, r0, c0, gt, nt,
                               a.w_clip, ql, seed, a.q, &t_dw);
      }
    } else {
      for (int c = gt; c < m; c += nt) {
        ev_out[c] = cvt<G>(S(0));
        v_out[c] = v[c];
        tp_out[c] = post[c];
      }
    }
    fence_async_shared();            // the new weights, for the copy engine

    // ---- telemetry: the group's sums, in a fixed order -------------------
    if constexpr (kTel) {
      t_ev = warp_sum(t_ev);
      t_dw = warp_sum(t_dw);
      t_sat = warp_sum(t_sat);
      if ((gt & 31) == 0) {
        S* r = red + 3 * (gt >> 5);
        r[0] = t_ev;
        r[1] = t_dw;
        r[2] = t_sat;
      }
    }
    group_sync(group, nt);
    if constexpr (kTel) {
      if (gt == 0) {
        S e = 0, d = 0, n_sat = 0;
        for (int i = 0; i < a.warps; ++i) {
          e = e + red[3 * i];
          d = d + red[3 * i + 1];
          n_sat = n_sat + red[3 * i + 2];
        }
        float* row = a.tel + (long)s * 3;
        if constexpr (Q) {
          row[0] = on ? __fdiv_rn(__int2float_rn(e), (float)a.q.one) : 0.0f;
          row[1] = on ? __fmul_rn(__int2float_rn(d), scale) : 0.0f;
          row[2] = on ? __int2float_rn(n_sat) : 0.0f;
        } else {
          row[0] = on ? e : 0.0f;
          row[1] = on ? d : 0.0f;
          row[2] = on ? n_sat : 0.0f;
        }
      }
    }

    // ---- the stream's weights leave from shared memory ------------------
    const Seg& sw = p.seg[0];
    if (sw.store16) {
      if (gt == 0) {
        bulk_store((unsigned char*)sw.out + (long)s * sw.raw, w, sw.raw);
        bulk_commit();
      }
    } else {
      convert_copy((WG*)sw.out + (long)s * sw.count, (const WG*)w, sw.count,
                   false, gt, nt);
    }
    if (!ahead) {
      if (s_next < B) {
        if (gt == 0) bulk_wait_read();
        group_sync(group, nt);       // the buffer is free to be fetched into
        fetch(s_next, 0);
      }
    } else {
      cur ^= 1;
    }
  }
  cp_async_wait_all();
  if (gt == 0) bulk_wait();
}

// The plan's constraints; a launch also needs its outputs consistent.
bool valid(const FleetStepArgs* a, bool launch) {
  const int threads = 32 * a->warps * a->tile;
  const bool plan =
      a->warps >= 1 && a->warps <= 32 && (a->warps & (a->warps - 1)) == 0 &&
      a->tile >= 1 && threads <= kMaxThreads &&
      (a->warps == 1 || a->tile <= kMaxBarrierGroups) && a->n >= 1 &&
      a->m >= 1;
  return plan && (!launch || ((a->telemetry != 0) == (a->tel != nullptr) &&
                              !(a->plastic && a->theta == nullptr)));
}

// Launches the instantiation, or (with `blocks`) asks how many of its CTAs
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <bool Q, bool kTel, typename T, typename TH>
int run(const FleetStepArgs* a, int* blocks, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr bool kThBf16 = std::is_same_v<TH, __nv_bfloat16>;
  const StepPlan p = make_plan(*a, Q, kBf16, kThBf16);
  if (p.total != a->smem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fleet_step_kernel<Q, kTel, T, TH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.total);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * a->warps * a->tile;
  if (blocks != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fleet_step_kernel<Q, kTel, T, TH>, threads, p.total);
  if (a->batch == 0) return (int)cudaSuccess;
  if (a->ctas < 1) return (int)cudaErrorInvalidValue;
  fleet_step_kernel<Q, kTel, T, TH>
      <<<a->ctas, threads, p.total, stream>>>(*a, p);
  return (int)cudaGetLastError();
}

template <bool Q, typename T, typename TH>
int run_tel(const FleetStepArgs* a, int* blocks, cudaStream_t stream) {
  return a->telemetry ? run<Q, true, T, TH>(a, blocks, stream)
                      : run<Q, false, T, TH>(a, blocks, stream);
}

// kind 0: float32, 1: bfloat16, 2: int8.
int dispatch(const FleetStepArgs* a, int kind, int* blocks,
             cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (!valid(a, blocks == nullptr)) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case 0:
      return run_tel<false, float, float>(a, blocks, stream);
    case 1:
      return a->theta_bf16 ? run_tel<false, bf16, bf16>(a, blocks, stream)
                           : run_tel<false, bf16, float>(a, blocks, stream);
    case 2:
      return run_tel<true, float, float>(a, blocks, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fleet_step_f32(const FleetStepArgs* a, cudaStream_t stream) {
  return dispatch(a, 0, nullptr, stream);
}

extern "C" int fleet_step_bf16(const FleetStepArgs* a, cudaStream_t stream) {
  return dispatch(a, 1, nullptr, stream);
}

extern "C" int fleet_step_q(const FleetStepArgs* a, cudaStream_t stream) {
  return dispatch(a, 2, nullptr, stream);
}

// CTAs of the launch `a` describes (kind as `dispatch`) that one SM holds.
extern "C" int fleet_step_occupancy(const FleetStepArgs* a, int kind,
                                    int* blocks) {
  return dispatch(a, kind, blocks, nullptr);
}
