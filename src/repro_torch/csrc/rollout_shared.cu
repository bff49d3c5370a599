// Time-fused rollout window, shared-weight mode: K timesteps x L layers of
// one network whose weights (N_i, M_i) are shared by a batch of B activation
// rows, batch-averaged dw, in ONE cooperative launch.
//
// Replaces src/repro/kernels/plasticity/fused.py:304 rollout_pallas
// (_rollout_kernel :79) on its shared-weight grid (1,) (fused.py:193-200,
// :210-216); the fleet grid is csrc/rollout.cu.
//
// What bounds it on an H100: bytes once per window, latency per step.  The
// least traffic is one read and one write of w, one read of theta, the state
// and the K drive and readout rows: at the online-MNIST 784-1024-10 network
// ~19.6 MB in float32 (~6 us).  Every timestep is a chain of dependent
// layers, so a window costs at least K * (L - 1) grid-wide barriers.
//
// Design: the TPU runs the window as one program holding everything in
// VMEM.  At 784-1024-10, w1 is 3.2 MB and theta1 12.8 MB: far beyond one
// CTA's 227 KB, within the ~30 MB of all 132 SMs' shared memory together.
// So the window runs on a grid of co-resident CTAs (a cooperative launch;
// the launcher refuses a grid that cannot be resident).  CTA g owns columns
// [g * c_i, (g + 1) * c_i) of every layer i (c_i a power of two <= 32) and
// keeps their weights, theta (when the whole layout fits), membranes and
// post traces in shared memory for the whole window: loaded once, written
// back once.  Per step and layer i:
//   1. psum of the owned columns over the staged input events (lanes
//      sharing a column reduce by warp shuffle, then across warps in warp
//      order), neuron and trace update; the events and fresh post traces go
//      to a small global bus (double-buffered by step parity);
//   2. the owned synapses' batch-averaged update from the pre trace of the
//      layer's input population and the owned post traces;
//   3. one grid barrier, after which every CTA stages the bus as the next
//      layer's input events and pre traces.
// The input population's trace is updated redundantly (identically) by
// every CTA.  Step k of layer i draws its stochastic round from
// fold_seed(seed + k, i) and the synapse's flat (row * M + col) index, as
// the per-step kernels do.
//
// bfloat16 (the Pallas body's generic dtype, fused.py:112-122, :251,
// :275-278): the owned weights, membranes and traces and the input trace
// are promoted to float32 as they are loaded, the window runs in float32
// as the float32 instantiation does (the bus carries float32 events and
// traces), each step's readout row is rounded to bfloat16 on store, and
// the state once, at write-back.  The rule may be float32 or bfloat16 and
// stays in its own type in shared memory.
#include <cooperative_groups.h>
#include <type_traits>

#include "plasticity.cuh"

namespace cg = cooperative_groups;
using ff::kMaxLayers;
using ff::Types;

// Arguments of one launch; mirrored by fused.py _SharedRolloutArgs (ctypes).
struct SharedRolloutArgs {
  const void* drives;                 // (K, B, N0) float32 | bfloat16 | int32
  void* outs;                         // (K, B, M_last) out, as the drives
  const void* teach;                  // (K, B, M_last) float32 | int32, or null
  const int* seed;                    // () int8 only
  const void* w_in[kMaxLayers];       // (N_i, M_i)
  void* w_out[kMaxLayers];
  const void* theta[kMaxLayers];      // (4, N_i, M_i) or null
  const float* scale[kMaxLayers];     // () int8 only
  const void* v_in[kMaxLayers];       // (B, M_i)
  void* v_out[kMaxLayers];
  const void* tr_in[kMaxLayers + 1];  // (B, N_i); tr[0] is the input
  void* tr_out[kMaxLayers + 1];
  void* bus[kMaxLayers];              // (2 parities, 2 [events|trace], B,
                                      // M_i) float32 | int32
  int sizes[kMaxLayers + 1];
  int cols[kMaxLayers];               // columns per CTA, power of two <= 32
  int n_layers, k_steps, batch;
  int spiking_mask, plastic_mask, theta_in_smem;
  float w_clip;
  ff::FParams f;
  ff::QParams q;                      // inv1 / inv2 of this batch
  int bf16;                           // float state and weights in bfloat16
  int theta_bf16;                     // the rules in bfloat16
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;             // batch rows per psum pass

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared-memory layout (bytes); fused.py shared_smem_bytes computes the same
// total and the launcher refuses a launch where the two disagree.
struct Layout {
  size_t theta[kMaxLayers], w[kMaxLayers], v[kMaxLayers], tp[kMaxLayers];
  size_t tr0, xs, pres, pre_sum, post_sum, red, total;
};

__host__ __device__ inline Layout layout(const SharedRolloutArgs& a,
                                         bool quant) {
  Layout l;
  size_t off = 0;
  const size_t bsz = a.batch;
  int widest = 0;
  for (int i = 0; i < a.n_layers; ++i)
    widest = a.sizes[i] > widest ? a.sizes[i] : widest;
  for (int i = 0; i < a.n_layers; ++i) {
    const size_t nc = (size_t)a.sizes[i] * a.cols[i];
    l.theta[i] = off;
    if (a.theta_in_smem && ((a.plastic_mask >> i) & 1))
      off += align16(4 * nc * (a.theta_bf16 ? 2 : 4));
    l.w[i] = off;
    off += align16(nc * (quant ? 1 : 4));
    l.v[i] = off;
    off += align16(bsz * a.cols[i] * 4);
    l.tp[i] = off;
    off += align16(bsz * a.cols[i] * 4);
  }
  l.tr0 = off;
  off += align16(bsz * a.sizes[0] * 4);
  l.xs = off;
  off += align16(bsz * widest * 4);
  l.pres = off;
  off += align16(bsz * widest * 4);
  l.pre_sum = off;
  off += align16((size_t)widest * 4);
  l.post_sum = off;
  off += align16(32 * 4);
  l.red = off;
  off += align16((size_t)kWarps * kChunk * 32 * 4);
  l.total = off;
  return l;
}

__device__ inline int log2i(int c) { return 31 - __clz(c); }

template <typename T>
__device__ inline T shfl_xor(T v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}

// S and W: state and weights in shared memory; G and WG: in device memory
// (T = float | bfloat16 on the float path); TH: the rules' type.
template <bool Q, typename T, typename TH>
__global__ void __launch_bounds__(kThreads)
rollout_shared_kernel(SharedRolloutArgs a) {
  using ff::cvt;
  using S = typename Types<Q>::S;
  using W = typename Types<Q>::W;
  using G = std::conditional_t<Q, int, T>;
  using WG = std::conditional_t<Q, int8_t, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const Layout lay = layout(a, Q);
  const int L = a.n_layers, B = a.batch, n0 = a.sizes[0];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;

  S* tr0 = (S*)(smem + lay.tr0);
  S* xs = (S*)(smem + lay.xs);
  S* pres = (S*)(smem + lay.pres);
  S* pre_sum = (S*)(smem + lay.pre_sum);
  S* post_sum = (S*)(smem + lay.post_sum);
  S* red = (S*)(smem + lay.red);

  // ---- load the owned columns' working set ONCE ------------------------
  for (int i = 0; i < L; ++i) {
    const int n = a.sizes[i], m = a.sizes[i + 1], c = a.cols[i];
    const int col0 = blockIdx.x * c, own = max(0, min(c, m - col0));
    const int lc = log2i(c);
    W* ws = (W*)(smem + lay.w[i]);
    for (int o = tid; o < n * c; o += nt) {
      const int r = o >> lc, j = o & (c - 1);
      ws[o] = j < own ? cvt<W>(((const WG*)a.w_in[i])[(long)r * m + col0 + j])
                      : W(0);
    }
    if (a.theta_in_smem && ((a.plastic_mask >> i) & 1)) {
      TH* th = (TH*)(smem + lay.theta[i]);
      const TH* src = (const TH*)a.theta[i];
      for (int o = tid; o < 4 * n * c; o += nt) {
        const int p = o / (n * c), rj = o % (n * c);
        const int r = rj >> lc, j = rj & (c - 1);
        th[o] = j < own ? src[((long)p * n + r) * m + col0 + j]
                        : cvt<TH>(0.0f);
      }
    }
    S* vs = (S*)(smem + lay.v[i]);
    S* tps = (S*)(smem + lay.tp[i]);
    for (int e = tid; e < B * c; e += nt) {
      const int b = e >> lc, j = e & (c - 1);
      const long g = (long)b * m + col0 + j;
      vs[e] = j < own ? cvt<S>(((const G*)a.v_in[i])[g]) : S(0);
      tps[e] = j < own ? cvt<S>(((const G*)a.tr_in[i + 1])[g]) : S(0);
    }
  }
  for (int e = tid; e < B * n0; e += nt)
    tr0[e] = cvt<S>(((const G*)a.tr_in[0])[e]);
  float sc[kMaxLayers];
  for (int i = 0; i < L; ++i) sc[i] = Q ? *a.scale[i] : 0.0f;
  const int base_seed = Q ? *a.seed : 0;
  __syncthreads();

  for (int k = 0; k < a.k_steps; ++k) {
    const int par = k & 1;
    // ---- input population: drive onto the staging bus, trace update ---
    const G* drive = (const G*)a.drives + (long)k * B * n0;
    for (int e = tid; e < B * n0; e += nt) {
      const S x = cvt<S>(drive[e]);
      xs[e] = x;
      if constexpr (Q) tr0[e] = ff::trace_q(tr0[e], x, a.q);
      else tr0[e] = __fmaf_rn(a.f.decay, tr0[e], x);
    }
    __syncthreads();

    for (int i = 0; i < L; ++i) {
      const int n = a.sizes[i], m = a.sizes[i + 1], c = a.cols[i];
      const int col0 = blockIdx.x * c, own = max(0, min(c, m - col0));
      const int lc = log2i(c);
      const bool spiking = (a.spiking_mask >> i) & 1;
      const bool last = i == L - 1;
      const S* pre = i == 0 ? tr0 : pres;
      W* ws = (W*)(smem + lay.w[i]);
      S* vs = (S*)(smem + lay.v[i]);
      S* tps = (S*)(smem + lay.tp[i]);
      S* bus_ev = last ? nullptr : (S*)a.bus[i] + (long)(2 * par) * B * m;
      S* bus_tr = last ? nullptr : bus_ev + (long)B * m;

      if (own > 0) {                       // uniform across the CTA
        // ---- 1. Forward Engine on the owned columns ------------------
        const int j = tid & (c - 1), r0 = tid >> lc, lanes = nt >> lc;
        for (int b0 = 0; b0 < B; b0 += kChunk) {
          const int nb = min(kChunk, B - b0);
          S acc[kChunk];
#pragma unroll
          for (int u = 0; u < kChunk; ++u) acc[u] = S(0);
          for (int r = r0; r < n; r += lanes) {
            const S wv = (S)ws[r * c + j];
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
              if (u < nb) {
                const S xv = xs[(b0 + u) * n + r];
                if constexpr (Q) acc[u] = ff::wadd(acc[u], ff::wmul(xv, wv));
                else acc[u] = acc[u] + xv * wv;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            for (int off = 16; off >= c; off >>= 1) {
              if constexpr (Q) acc[u] = ff::wadd(acc[u], shfl_xor(acc[u], off));
              else acc[u] = acc[u] + shfl_xor(acc[u], off);
            }
            if (lane < c) red[(warp * kChunk + u) * 32 + lane] = acc[u];
          }
          __syncthreads();
          for (int e = tid; e < nb * own; e += nt) {
            const int u = e / own, jj = e % own, b = b0 + u;
            S s = red[u * 32 + jj];
            for (int wp = 1; wp < kWarps; ++wp) {
              if constexpr (Q) s = ff::wadd(s, red[(wp * kChunk + u) * 32 + jj]);
              else s = s + red[(wp * kChunk + u) * 32 + jj];
            }
            const long gt = ((long)k * B + b) * m + col0 + jj;
            const int li = b * c + jj;
            S ev, vn, tp;
            if constexpr (Q) {
              int i_fx = ff::current_fx(s, sc[i]);
              if (last && a.teach)
                i_fx = ff::wadd(i_fx, ((const int*)a.teach)[gt]);
              ff::neuron_q(vs[li], i_fx, spiking, a.q, &ev, &vn);
              tp = ff::trace_q(tps[li], ev, a.q);
            } else {
              if (last && a.teach) s = s + ((const float*)a.teach)[gt];
              ff::neuron_f(vs[li], s, spiking, a.f, &ev, &vn);
              tp = __fmaf_rn(a.f.decay, tps[li], ev);
            }
            vs[li] = vn;
            tps[li] = tp;
            const S out = spiking ? ev : vn;
            if (last) {
              ((G*)a.outs)[gt] = cvt<G>(out);
            } else {
              bus_ev[(long)b * m + col0 + jj] = out;
              bus_tr[(long)b * m + col0 + jj] = tp;
            }
          }
          __syncthreads();
        }

        // ---- 2. Plasticity Engine on the owned synapses --------------
        if ((a.plastic_mask >> i) & 1) {
          for (int r = tid; r < n; r += nt) {
            S s = S(0);
            for (int b = 0; b < B; ++b) {
              if constexpr (Q) s = ff::wadd(s, pre[b * n + r]);
              else s = s + pre[b * n + r];
            }
            pre_sum[r] = s;
          }
          if (tid < own) {
            S s = S(0);
            for (int b = 0; b < B; ++b) {
              if constexpr (Q) s = ff::wadd(s, tps[b * c + tid]);
              else s = s + tps[b * c + tid];
            }
            post_sum[tid] = s;
          }
          __syncthreads();
          const bool resident = a.theta_in_smem;
          const TH* th_base = resident
                                  ? (const TH*)(smem + lay.theta[i])
                                  : (const TH*)a.theta[i];
          const long plane = resident ? (long)n * c : (long)n * m;
          int qmax = 0, seed_i = 0;
          if constexpr (Q) {
            qmax = ff::qclip(a.w_clip, sc[i]);
            seed_i = ff::fold_seed(ff::wadd(base_seed, k), i);
          }
          const float fb = (float)B;
          for (int o = tid; o < n * c; o += nt) {
            const int r = o >> lc, jj = o & (c - 1);
            if (jj >= own) continue;
            const TH* th =
                th_base + (resident ? (long)o : (long)r * m + col0 + jj);
            S hebb = S(0);
            for (int b = 0; b < B; ++b) {
              if constexpr (Q)
                hebb = ff::wadd(hebb, ff::wmul(pre[b * n + r], tps[b * c + jj]));
              else hebb = hebb + pre[b * n + r] * tps[b * c + jj];
            }
            if constexpr (Q)
              ws[o] = (int8_t)ff::plastic_q_sums(
                  (int)ws[o], th, plane, hebb, pre_sum[r], post_sum[jj], sc[i],
                  qmax, seed_i, r * m + col0 + jj, a.q);
            else
              ws[o] = ff::plastic_f_terms(ws[o], th, plane, __fdiv_rn(hebb, fb),
                                          __fdiv_rn(pre_sum[r], fb),
                                          __fdiv_rn(post_sum[jj], fb),
                                          a.w_clip);
          }
          __syncthreads();
        }
      }

      // ---- 3. grid barrier, then stage the next layer's inputs ---------
      if (!last) {
        grid.sync();
        const S* ev_in = (const S*)a.bus[i] + (long)(2 * par) * B * m;
        const S* tr_in = ev_in + (long)B * m;
        for (int e = tid; e < B * m; e += nt) {
          xs[e] = __ldcg(ev_in + e);
          pres[e] = __ldcg(tr_in + e);
        }
        __syncthreads();
      }
    }
  }

  // ---- single write-back of the owned state -----------------------------
  for (int i = 0; i < L; ++i) {
    const int n = a.sizes[i], m = a.sizes[i + 1], c = a.cols[i];
    const int col0 = blockIdx.x * c, own = max(0, min(c, m - col0));
    const int lc = log2i(c);
    const W* ws = (const W*)(smem + lay.w[i]);
    const S* vs = (const S*)(smem + lay.v[i]);
    const S* tps = (const S*)(smem + lay.tp[i]);
    for (int o = tid; o < n * c; o += nt) {
      const int r = o >> lc, j = o & (c - 1);
      if (j < own)
        ((WG*)a.w_out[i])[(long)r * m + col0 + j] = cvt<WG>(ws[o]);
    }
    for (int e = tid; e < B * c; e += nt) {
      const int b = e >> lc, j = e & (c - 1);
      if (j < own) {
        ((G*)a.v_out[i])[(long)b * m + col0 + j] = cvt<G>(vs[e]);
        ((G*)a.tr_out[i + 1])[(long)b * m + col0 + j] = cvt<G>(tps[e]);
      }
    }
  }
  if (blockIdx.x == 0)
    for (int e = tid; e < B * n0; e += nt)
      ((G*)a.tr_out[0])[e] = cvt<G>(tr0[e]);
}

template <bool Q, typename T, typename TH>
int launch(const SharedRolloutArgs* a, int grid_size, size_t expected_smem,
           cudaStream_t stream) {
  const size_t smem = layout(*a, Q).total;
  if (smem != expected_smem) return (int)cudaErrorInvalidValue;
  void (*kernel)(SharedRolloutArgs) = rollout_shared_kernel<Q, T, TH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  // every CTA must be resident at once for the grid barriers
  if ((long)per_sm * sms < grid_size)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  SharedRolloutArgs args = *a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid_size),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// grid_size: the CTAs the wrapper planned (max over layers of M_i / c_i);
// expected_smem: its count of the layout, checked against this file's.
extern "C" int rollout_shared(const SharedRolloutArgs* a, int quant,
                              int grid_size, size_t expected_smem,
                              cudaStream_t stream) {
  if (a->n_layers < 1 || a->n_layers > kMaxLayers || a->batch < 1 ||
      grid_size < 1 || (quant && (a->bf16 || a->theta_bf16)) ||
      (a->theta_bf16 && !a->bf16))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a->n_layers; ++i) {
    const int c = a->cols[i];
    if (c < 1 || c > 32 || (c & (c - 1)) != 0 ||
        (long)c * grid_size < a->sizes[i + 1])
      return (int)cudaErrorInvalidValue;
  }
  using bf16 = __nv_bfloat16;
  if (quant) return launch<true, float, float>(a, grid_size, expected_smem,
                                               stream);
  if (!a->bf16)
    return launch<false, float, float>(a, grid_size, expected_smem, stream);
  return a->theta_bf16
             ? launch<false, bf16, bf16>(a, grid_size, expected_smem, stream)
             : launch<false, bf16, float>(a, grid_size, expected_smem, stream);
}
