// Time-fused rollout window, fleet mode: K timesteps x L layers for a block
// of request streams in ONE launch.
//
// Replaces src/repro/kernels/plasticity/fused.py:304 rollout_pallas
// (_rollout_kernel :79), fleet grid, and its fleet telemetry variant (the
// time-loop accumulator :133/:230 and the finalized window means :256-283);
// the shared-weight grid (1,) is csrc/rollout_shared.cu.
//
// What bounds it on an H100: bytes, and only when the window is long enough.
// The least traffic is one read and one write of the block's weights,
// membranes and traces per WINDOW, plus the K drive rows and K readout rows;
// the arithmetic is a few operations per synapse per step.  At the paper's
// 8-128-8 controller and K = 4 that is ~0.4 operations per byte moved.
//
// Design: one CTA runs the whole window for `block_b` streams.  Their
// weights, the shared theta planes (when they fit), membranes, all L+1
// traces and the inter-layer event bus live in shared memory for the whole
// window: loaded once, written back once (the counterpart of the 16 MB VMEM
// residency the TPU kernel relies on, in 227 KB).  Within a step the CTA
// walks the layers; each layer is two phases separated by a barrier:
//   1. one thread per (stream, column): psum over the event bus, neuron,
//      trace, gated outputs onto the bus;
//   2. one thread per (stream, synapse): the four-term update of the
//      resident weights from the pre trace and the UNGATED post trace.
// Inactive streams skip phase 2 and keep their state, which equals the
// reference's compute-then-select bit for bit.  Step k of layer i draws its
// stochastic round from fold_seed(seed + k, i) and the layer's own flat
// (row * M + col) index, as the per-step kernels do.
//
// Telemetry variant (template flag kTel, set when `tel` is given): a
// (block_b, 2) float accumulator in shared memory carries, per stream,
// sum over steps and layers of [sum |event| / M_i, #|v| >= 0.9 v_th / M_i].
// After phase 1 of each layer one warp per stream reduces the layer's
// columns (lanes stride the columns, then a shuffle tree: the same order on
// every run) from the event bus and the membranes.  At write-back each
// stream's net weight motion sum |w_end - w_start| per plastic layer is
// reduced the same way against w_in, which the launch never overwrites
// (one more read of the block's weights per window); then the row is
// divided by K * L (and K * n_plastic), gated by the active flag and
// written to tel (B, 3).  The fixed-point terms are summed in int32 and
// converted once, so they are exact and the int8 row equals the plain
// version's bit for bit.
#include "plasticity.cuh"

using ff::kMaxLayers;

// Arguments of one launch; mirrored by fused.py _RolloutArgs (ctypes).
// Outside the anonymous namespace so the C entry point is exported.
struct RolloutArgs {
  const void* drives;               // (K, B, N0)
  void* outs;                       // (K, B, M_last) out
  const void* teach;                // (K, B, M_last) or null
  const uint8_t* active;            // (B,) or null
  const int* seed;                  // (B,) int8 only
  const void* w_in[kMaxLayers];     // (B, N_i, M_i)
  void* w_out[kMaxLayers];
  const float* theta[kMaxLayers];   // (4, N_i, M_i) or null
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
};

namespace {

constexpr int kThreads = 512;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared-memory layout; repro_torch/kernels/plasticity/fused.py computes the
// same total (rollout_smem_bytes) and the launcher checks that both agree.
struct Layout {
  size_t theta, v, tr, bus, act, w, tel, total;
};

__host__ __device__ inline Layout layout(const RolloutArgs& a, bool quant) {
  size_t th = 0, syn = 0, post = 0, pop = 0;
  int widest = 0;
  for (int i = 0; i < a.n_layers; ++i) {
    const size_t nm = (size_t)a.sizes[i] * a.sizes[i + 1];
    syn += nm;
    post += a.sizes[i + 1];
    if (a.theta_in_smem && ((a.plastic_mask >> i) & 1)) th += 4 * nm;
  }
  for (int i = 0; i <= a.n_layers; ++i) {
    pop += a.sizes[i];
    widest = a.sizes[i] > widest ? a.sizes[i] : widest;
  }
  const size_t bb = a.block_b;
  Layout l;
  l.theta = 0;
  l.v = l.theta + align16(th * 4);
  l.tr = l.v + align16(bb * post * 4);
  l.bus = l.tr + align16(bb * pop * 4);
  l.act = l.bus + align16(2 * bb * widest * 4);
  l.w = l.act + align16(bb * 4);
  l.tel = l.w + align16(bb * syn * (quant ? 1 : 4));
  l.total = l.tel + (a.telemetry ? align16(bb * 8) : 0);
  return l;
}

using ff::Types;

// Cooperative copy of `count` elements by the whole CTA.  16-byte vectors,
// four in flight per thread, when both ends and the length allow it (the
// state loads are latency-bound otherwise: one CTA per SM at block_b = 8).
template <typename T>
__device__ inline void copy_block(T* __restrict__ dst, const T* __restrict__ src,
                            long count) {
  const long tid = threadIdx.x, nt = blockDim.x;
  if ((((uintptr_t)dst | (uintptr_t)src | (count * sizeof(T))) & 15) == 0) {
    int4* d = (int4*)dst;
    const int4* s = (const int4*)src;
    const long n = count * sizeof(T) / 16;
    for (long i = tid; i < n; i += 4 * nt) {
      int4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * nt < n) r[u] = s[i + u * nt];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * nt < n) d[i + u * nt] = r[u];
    }
  } else {
    for (long i = tid; i < count; i += nt) dst[i] = src[i];
  }
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

template <bool Q, bool kTel>
__global__ void __launch_bounds__(kThreads) rollout_kernel(RolloutArgs a) {
  using S = typename Types<Q>::S;
  using W = typename Types<Q>::W;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(a, Q);
  const int L = a.n_layers, B = a.batch, bb = a.block_b;
  const int b0 = blockIdx.x * bb;
  const int nb = min(bb, B - b0);                 // streams in this CTA
  const int tid = threadIdx.x, nt = blockDim.x;

  // ---- carve shared memory and load the window's working set ONCE ------
  const float* th[kMaxLayers];
  S* v[kMaxLayers];
  S* tr[kMaxLayers + 1];
  W* w[kMaxLayers];
  {
    float* th_s = (float*)(smem + lay.theta);
    S* v_s = (S*)(smem + lay.v);
    S* tr_s = (S*)(smem + lay.tr);
    W* w_s = (W*)(smem + lay.w);
    for (int i = 0; i < L; ++i) {
      const int n = a.sizes[i], m = a.sizes[i + 1];
      const long nm = (long)n * m;
      th[i] = a.theta[i];
      if (a.theta_in_smem && ((a.plastic_mask >> i) & 1)) {
        copy_block(th_s, a.theta[i], 4 * nm);
        th[i] = th_s;
        th_s += 4 * nm;
      }
      w[i] = w_s;
      copy_block(w_s, (const W*)a.w_in[i] + (long)b0 * nm, nb * nm);
      w_s += bb * nm;
      v[i] = v_s;
      copy_block(v_s, (const S*)a.v_in[i] + (long)b0 * m, (long)nb * m);
      v_s += bb * m;
    }
    for (int i = 0; i <= L; ++i) {
      tr[i] = tr_s;
      copy_block(tr_s, (const S*)a.tr_in[i] + (long)b0 * a.sizes[i],
              (long)nb * a.sizes[i]);
      tr_s += bb * a.sizes[i];
    }
  }
  int widest = 0;
  for (int i = 0; i <= L; ++i) widest = max(widest, a.sizes[i]);
  S* bus_in = (S*)(smem + lay.bus);
  S* bus_out = bus_in + bb * widest;
  int* act = (int*)(smem + lay.act);
  for (int s = tid; s < nb; s += nt)
    act[s] = a.active == nullptr || a.active[b0 + s] != 0;
  float* tel_acc = (float*)(smem + lay.tel);     // (bb, 2), kTel only
  if constexpr (kTel)
    for (int e = tid; e < 2 * nb; e += nt) tel_acc[e] = 0.0f;
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;

  const int n0 = a.sizes[0];
  for (int k = 0; k < a.k_steps; ++k) {
    // ---- input population: drive onto the bus, gated trace update -----
    const S* drive = (const S*)a.drives + ((long)k * B + b0) * n0;
    for (int e = tid; e < nb * n0; e += nt) {
      const S x = drive[e];
      bus_in[e] = x;
      if (act[e / n0]) {
        if constexpr (Q) tr[0][e] = ff::trace_q(tr[0][e], x, a.q);
        else tr[0][e] = __fmaf_rn(a.f.decay, tr[0][e], x);
      }
    }
    __syncthreads();

    for (int i = 0; i < L; ++i) {
      const int n = a.sizes[i], m = a.sizes[i + 1];
      const long nm = (long)n * m;
      const bool spiking = (a.spiking_mask >> i) & 1;
      const bool last = i == L - 1;
      // ---- phase 1: Forward Engine, one thread per (stream, column) ----
      for (int e = tid; e < nb * m; e += nt) {
        const int s = e / m, col = e % m;
        const S* x = bus_in + s * n;
        const W* ws = w[i] + s * nm + col;
        const bool on = act[s];
        S out, ev, v_new;
        if constexpr (Q) {
          int acc = 0;
          for (int r = 0; r < n; ++r)
            acc = ff::wadd(acc, ff::wmul(x[r], (int)ws[(long)r * m]));
          int i_fx = ff::current_fx(acc, a.scale[i][b0 + s]);
          if (last && a.teach)
            i_fx = ff::wadd(
                i_fx, ((const int*)a.teach)[((long)k * B + b0) * m + e]);
          ff::neuron_q(v[i][e], i_fx, spiking, a.q, &ev, &v_new);
          if (on) tr[i + 1][e] = ff::trace_q(tr[i + 1][e], ev, a.q);
        } else {
          float acc = 0.0f;
          for (int r = 0; r < n; ++r) acc = acc + x[r] * ws[(long)r * m];
          if (last && a.teach)
            acc = acc + ((const float*)a.teach)[((long)k * B + b0) * m + e];
          ff::neuron_f(v[i][e], acc, spiking, a.f, &ev, &v_new);
          if (on) tr[i + 1][e] = __fmaf_rn(a.f.decay, tr[i + 1][e], ev);
        }
        if (on) v[i][e] = v_new;
        out = on ? (spiking ? ev : v_new) : S(0);
        bus_out[e] = out;
        if (last) ((S*)a.outs)[((long)k * B + b0) * m + e] = out;
      }
      __syncthreads();
      // ---- telemetry: this layer's event and saturation means ---------
      // Events from the bus in event units (a readout's output is its
      // membrane: back through tanh or the fixed-point clip); saturation
      // on the updated membrane (frozen for inactive streams, whose row the
      // final gate zeroes).
      if constexpr (kTel) {
        for (int s = warp; s < nb; s += n_warps) {
          const S* o = bus_out + s * m;
          const S* vs = v[i] + s * m;
          if constexpr (Q) {
            int ev = 0, sat = 0;
            for (int c = lane; c < m; c += 32) {
              const int x = o[c];
              ev += wabs(spiking ? x : min(max(x, -a.q.one), a.q.one));
              sat += wabs(vs[c]) >= a.sat_q;
            }
            ev = warp_sum(ev);
            sat = warp_sum(sat);
            if (lane == 0) {
              tel_acc[2 * s] = tel_acc[2 * s] +
                  __int2float_rn(ev) / (float)a.q.one / (float)m;
              tel_acc[2 * s + 1] =
                  tel_acc[2 * s + 1] + __int2float_rn(sat) / (float)m;
            }
          } else {
            float ev = 0.0f, sat = 0.0f;
            for (int c = lane; c < m; c += 32) {
              ev = ev + fabsf(spiking ? o[c] : tanhf(o[c]));
              sat = sat + (fabsf(vs[c]) >= a.sat_f ? 1.0f : 0.0f);
            }
            ev = warp_sum(ev);
            sat = warp_sum(sat);
            if (lane == 0) {
              tel_acc[2 * s] = tel_acc[2 * s] + ev / (float)m;
              tel_acc[2 * s + 1] = tel_acc[2 * s + 1] + sat / (float)m;
            }
          }
        }
        // the bus and membranes are rewritten before the next barrier
        // when this layer is not plastic
        __syncthreads();
      }
      // ---- phase 2: Plasticity Engine on the resident weights ---------
      // Synapse o = row * M + col of stream s; the thread's (row, col)
      // advances by a fixed step, so the loop does no integer division.
      if ((a.plastic_mask >> i) & 1) {
        const int d_row = nt / m, d_col = nt % m;
        for (int s = 0; s < nb; ++s) {
          if (!act[s]) continue;                  // uniform across the CTA
          W* ws = w[i] + s * nm;
          const S* pre = tr[i] + s * n;
          const S* post = tr[i + 1] + s * m;
          float sc = 0.0f;
          int qmax = 0, seed_i = 0;
          if constexpr (Q) {
            sc = a.scale[i][b0 + s];
            qmax = ff::qclip(a.w_clip, sc);
            seed_i = ff::fold_seed(ff::wadd(a.seed[b0 + s], k), i);
          }
          int r = tid / m, col = tid % m;
          for (int o = tid; o < nm; o += nt) {
            if constexpr (Q)
              ws[o] = (int8_t)ff::plastic_q((int)ws[o], th[i] + o, nm, pre[r],
                                            post[col], sc, qmax, seed_i, o,
                                            a.q);
            else
              ws[o] = ff::plastic_f(ws[o], th[i] + o, nm, pre[r], post[col],
                                    a.w_clip);
            r += d_row;
            col += d_col;
            if (col >= m) {
              col -= m;
              ++r;
            }
          }
        }
        __syncthreads();
      }
      S* t = bus_in;
      bus_in = bus_out;
      bus_out = t;
    }
  }

  // ---- telemetry: net weight motion, finalize, gate, write -------------
  if constexpr (kTel) {
    int n_plastic = 0;
    for (int i = 0; i < L; ++i) n_plastic += (a.plastic_mask >> i) & 1;
    const float kl = (float)(a.k_steps * L);
    for (int s = warp; s < nb; s += n_warps) {
      float mean_dw = 0.0f;
      for (int i = 0; i < L; ++i) {
        if (!((a.plastic_mask >> i) & 1)) continue;
        const long nm = (long)a.sizes[i] * a.sizes[i + 1];
        const W* w_end = w[i] + s * nm;
        const W* w_start = (const W*)a.w_in[i] + (long)(b0 + s) * nm;
        float per_slot;
        if constexpr (Q) {
          int d = 0;
          for (long o = lane; o < nm; o += 32)
            d += abs((int)w_end[o] - (int)w_start[o]);
          per_slot = __int2float_rn(warp_sum(d)) * a.scale[i][b0 + s];
        } else {
          float d = 0.0f;
          for (long o = lane; o < nm; o += 32)
            d = d + fabsf(w_end[o] - w_start[o]);
          per_slot = warp_sum(d);
        }
        mean_dw = mean_dw + per_slot / (float)nm;
      }
      if (n_plastic) mean_dw = mean_dw / (float)(a.k_steps * n_plastic);
      if (lane == 0) {
        const float g = act[s] ? 1.0f : 0.0f;
        float* row = a.tel + (long)(b0 + s) * 3;
        row[0] = tel_acc[2 * s] / kl * g;
        row[1] = mean_dw * g;
        row[2] = tel_acc[2 * s + 1] / kl * g;
      }
    }
  }

  // ---- single write-back of the window's state ------------------------
  for (int i = 0; i < L; ++i) {
    const int n = a.sizes[i], m = a.sizes[i + 1];
    const long nm = (long)n * m;
    copy_block((W*)a.w_out[i] + (long)b0 * nm, (const W*)w[i], nb * nm);
    copy_block((S*)a.v_out[i] + (long)b0 * m, (const S*)v[i], (long)nb * m);
  }
  for (int i = 0; i <= L; ++i)
    copy_block((S*)a.tr_out[i] + (long)b0 * a.sizes[i], (const S*)tr[i],
         (long)nb * a.sizes[i]);
}

template <bool Q, bool kTel>
int launch_window(const RolloutArgs* a, size_t smem, unsigned blocks,
                  cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rollout_kernel<Q, kTel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rollout_kernel<Q, kTel><<<blocks, kThreads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

// expected_smem: the wrapper's count; a mismatch means the two layouts have
// drifted apart and the launch is refused.
extern "C" int rollout(const RolloutArgs* a, int quant, size_t expected_smem,
                       cudaStream_t stream) {
  if (a->n_layers < 1 || a->n_layers > kMaxLayers || a->block_b < 1 ||
      (a->telemetry != 0) != (a->tel != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout(*a, quant != 0).total;
  if (smem != expected_smem) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((a->batch + a->block_b - 1) / a->block_b);
  if (blocks == 0) return (int)cudaSuccess;
  if (quant)
    return a->telemetry ? launch_window<true, true>(a, smem, blocks, stream)
                        : launch_window<true, false>(a, smem, blocks, stream);
  return a->telemetry ? launch_window<false, true>(a, smem, blocks, stream)
                      : launch_window<false, false>(a, smem, blocks, stream);
}
