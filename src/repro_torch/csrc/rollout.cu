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
#include "fleet.cuh"

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

constexpr int kMaxSegs = 4 * kMaxLayers + 2;

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
    split_layer(lp, lp.n, lp.m, threads);
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
  if (threadIdx.x == 0) mbar_init(rules_bar, 1);
  if (ahead && gt == 0) {
    mbar_init(slot_bar, 1);
    mbar_init(slot_bar + 8, 1);
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
          const int m = lp.m;
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
          forward_engine<S>(x_bus, w, lp, gt, nt, column);
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
