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
// ~19.6 MB in float32 (5.8 us at 3.35 TB/s).  Each step is a chain of
// dependent layers, but the network is feed-forward: layer i's step k + 1
// needs nothing from layer i + 1's step k.
//
// Design.  The TPU runs the window as one program holding everything in
// VMEM.  At 784-1024-10, w1 is 3.2 MB and theta1 12.8 MB: far beyond one
// CTA's 227 KB, within the ~30 MB of all 132 SMs' shared memory together.
// So the window runs on a grid of co-resident CTAs (a cooperative launch;
// the launcher refuses a grid that cannot be resident), and the layers are
// PIPELINED across them instead of run in lockstep:
//   * Each CTA owns c_i columns of ONE layer i (fused.py shared_plan: at
//     784-1024-10 on 132 SMs, 128 CTAs of 8 columns for layer 0 and 3 of 4
//     for layer 1) and keeps their weights, theta, membranes and post
//     traces in shared memory for the whole window: loaded once, written
//     back once.
//   * The owned slabs arrive asynchronously, all issued at the start: TMA
//     boxes into shared memory with one mbarrier for w and one for theta
//     where the 16-byte rules hold (16-byte aligned base, row stride and
//     box width multiples of 16 bytes), else cp.async of the widest piece
//     the alignment allows (16, 8 or 4 bytes), or of the 4-byte words that
//     cover each row's span, repacked (int8 rows of 10 bytes).  The plan
//     picks each plane's route; the kernel takes it.  Step 0's forward pass
//     waits for w only; theta is awaited before the first update.  bf16
//     weights land in a staging area and are promoted to float32 there.
//   * Layer i hands step k's events and post traces to layer i + 1 through
//     a bus in device memory, `bus_depth` steps deep (one slot per step;
//     with K > depth a producer first takes a credit: every consumer has
//     finished step k - depth).  Each CTA publishes its progress, the stamp
//     base + k + 1 of the last step it finished, with a fence and a store
//     at the end of the step (by then its slot's stores are long done, so
//     the fence is cheap); a consumer polls every producer CTA's stamp with
//     relaxed loads, all in flight at once, then fences (acquire) and reads
//     the slot with L1-bypassing 16-byte loads.  The stamps grow across
//     launches (the wrapper keeps the words per plan and stream and passes
//     each launch its base), so no counter is zeroed and no zeroing step
//     runs.  Every spin traps after ~2^35 cycles: a broken protocol ends
//     the process with an error instead of hanging the card.
//   * So layer 0 runs its K steps back to back and layer i follows one
//     step behind: a step costs about the slowest layer's step, not the
//     sum of the layers' steps plus a grid barrier.
//   * A step is a chain of short dependent phases in one CTA, so it is
//     latency that bounds it, not bytes: 512 threads a CTA, the update
//     takes 4 consecutive columns a thread (16-byte loads of w and of each
//     theta plane, four independent chains), the batch means of the pre
//     and post traces are taken once a step (a division by B = 1 is
//     skipped: x / 1 is x), the psum of a single batch row is not unrolled
//     over 8, and layer 0's next drive row is loaded into registers during
//     the update.
//   * The write-back is vector stores of 16 (or the route's width) bytes.
// Per step and layer the arithmetic is unchanged from one layout to the
// next (int8 bit for bit with fused.rollout_plain at any plan): the psum of
// the owned columns over the staged input events (strided row partials,
// lanes sharing a column reduce by warp shuffle, then across warps in warp
// order), neuron and trace update, then the owned synapses' batch-averaged
// update from the layer's pre trace and the owned post traces.  The input
// population's trace is updated redundantly (identically) by every layer-0
// CTA.  Step k of layer i draws its stochastic round from
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
#include <cuda.h>
#include <cstring>
#include <mutex>
#include <type_traits>

#include "slab.cuh"

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
  void* bus[kMaxLayers];              // boundary i: (depth, 2 [events|trace],
                                      // B, M_i) float32 | int32
  unsigned* progress;                 // one stamp per CTA
  int sizes[kMaxLayers + 1];
  int first_cta[kMaxLayers + 1];      // layer i: CTAs [first[i], first[i+1])
  int cols[kMaxLayers];               // columns per CTA, power of two <= 32
  int w_route[kMaxLayers];            // Route of w, its piece bytes and its
  int w_width[kMaxLayers];            // TMA box rows
  int w_box[kMaxLayers];
  int th_route[kMaxLayers];           // the same for theta's (4 N_i, M_i)
  int th_width[kMaxLayers];           // rows; kNone where not plastic
  int th_box[kMaxLayers];
  int n_layers, k_steps, batch, bus_depth;
  int spiking_mask, plastic_mask;
  unsigned base;                      // stamp of the step before step 0
  float w_clip;
  ff::FParams f;
  ff::QParams q;                      // inv1 / inv2 of this batch
  int bf16;                           // float state and weights in bfloat16
  int theta_bf16;                     // the rules in bfloat16
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;             // batch rows per psum pass
constexpr long long kSpinCycles = 1ll << 35;   // ~19 s: a hang is a fault

// The kernel's parameter: the arguments and a TMA map of w and of theta
// (viewed as (4 N, M)) for each layer whose route is kTma.
struct Params {
  SharedRolloutArgs a;
  CUtensorMap w_map[kMaxLayers];
  CUtensorMap th_map[kMaxLayers];
};
static_assert(sizeof(Params) <= 4096, "kernel parameters exceed 4 KB");

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

__host__ __device__ inline size_t box_rows(size_t rows, int box) {
  return box > 0 ? align_up(rows, (size_t)box) : rows;
}

// Shared-memory layout (bytes) of one CTA of layer i; fused.py
// shared_smem_bytes computes the same and the launcher refuses a launch
// whose largest role disagrees with the wrapper's count.
struct Layout {
  size_t th, w, stage, pitch, v, tp, tr0, xs, pres, pre_sum, post_sum, red,
      bars, total;
};

__host__ __device__ inline Layout layout(const SharedRolloutArgs& a, int i,
                                         bool quant) {
  Layout l;
  size_t off = 0;
  const size_t bsz = a.batch, n = a.sizes[i], c = a.cols[i];
  const size_t we = quant ? 1 : (a.bf16 ? 2 : 4);   // w's bytes in memory
  const size_t held = quant ? 1 : 4;                 // w's bytes on chip
  const size_t tb = a.theta_bf16 ? 2 : 4;
  l.th = off;
  if (a.th_route[i] == kTma || a.th_route[i] == kCpAsync)
    off += align_up(box_rows(4 * n, a.th_route[i] == kTma ? a.th_box[i] : 0)
                    * c * tb, 128);
  const size_t w_rows = box_rows(n, a.w_route[i] == kTma ? a.w_box[i] : 0);
  const bool staged = a.bf16 || a.w_route[i] == kWords;
  l.w = off;
  off += align_up((staged ? n : w_rows) * c * held, 128);
  l.stage = off;
  l.pitch = a.w_route[i] == kWords ? 4 * ((c * we + 3) / 4 + 1) : c * we;
  if (staged) off += align_up(w_rows * l.pitch, 128);
  l.v = off;
  off += align_up(bsz * c * 4, 16);
  l.tp = off;
  off += align_up(bsz * c * 4, 16);
  l.tr0 = off;
  if (i == 0) off += align_up(bsz * n * 4, 16);
  l.xs = off;
  off += align_up(bsz * n * 4, 16);
  l.pres = off;
  if (i > 0) off += align_up(bsz * n * 4, 16);
  l.pre_sum = off;
  off += align_up(n * 4, 16);
  l.post_sum = off;
  off += align_up(32 * 4, 16);
  l.red = off;
  off += align_up((size_t)kWarps * kChunk * 32 * 4, 16);
  l.bars = off;
  off += 16;
  l.total = off + 128;                // slack to align the base to 128
  return l;
}

__device__ inline int log2i(int c) { return 31 - __clz(c); }

template <typename T>
__device__ inline T shfl_xor(T v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}

// ---- the handoff between layers ------------------------------------------
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// Stamps compare modulo 2^32 (they grow across launches).
__device__ __forceinline__ bool reached(unsigned stamp, unsigned want) {
  return (int)(stamp - want) >= 0;
}

// The whole CTA waits until CTAs [first, first + count) have all published
// a stamp >= want: warp 0 polls with relaxed loads (all in flight at once),
// then one acquire fence orders the reads of what they published.
__device__ void wait_for(const unsigned* progress, int first, int count,
                         unsigned want) {
  if (threadIdx.x < 32) {
    long long start = 0;
    for (;;) {
      bool ok = true;
      for (int g = threadIdx.x; g < count; g += 32)
        ok &= reached(ld_relaxed(progress + first + g), want);
      if (__all_sync(0xffffffffu, ok)) break;
      if (start == 0) start = clock64();
      else if (clock64() - start > kSpinCycles) __trap();
    }
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
}

// After every thread's stores of this step: publish the CTA's stamp.
__device__ __forceinline__ void publish(unsigned* word, unsigned stamp) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    st_relaxed(word, stamp);
  }
}

// dst[e] = src[e] for e < count through L2 (not L1): 16-byte loads where
// the count allows (src and dst are 16-byte aligned).
template <typename S>
__device__ void stage_l2(S* dst, const S* src, int count) {
  if ((count & 3) == 0) {
    using V = std::conditional_t<std::is_same<S, int>::value, int4, float4>;
    for (int e = threadIdx.x; e < count / 4; e += blockDim.x)
      reinterpret_cast<V*>(dst)[e] = __ldcg(reinterpret_cast<const V*>(src) + e);
  } else {
    for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = __ldcg(src + e);
  }
}

// Layer 0 reads each step's drive row before the step: the first
// kPrefetch of each thread's elements are loaded during the previous
// step's update, into registers.
constexpr int kPrefetch = 4;

template <typename G>
__device__ __forceinline__ void prefetch(G* pf, const G* row, int count) {
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u) {
    const int e = threadIdx.x + u * blockDim.x;
    if (e < count) pf[u] = __ldg(row + e);
  }
}

// Partial psums of U batch rows (nb of them real) of this thread's column
// j over its rows r0, r0 + lanes, ... in order.
template <bool Q, int U, typename S, typename W>
__device__ __forceinline__ void row_partials(S* acc, const W* ws,
                                             const S* xs, int n, int c, int j,
                                             int r0, int lanes, int nb) {
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = S(0);
#pragma unroll 4
  for (int r = r0; r < n; r += lanes) {
    const S wv = (S)ws[r * c + j];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (U == 1 || u < nb) {
        const S xv = xs[u * n + r];
        if constexpr (Q) acc[u] = ff::wadd(acc[u], ff::wmul(xv, wv));
        else acc[u] = acc[u] + xv * wv;
      }
    }
  }
}

// Lanes sharing a column reduce by shuffle; one partial per warp, column
// and batch row goes to red[warp][u][column].
template <bool Q, int U, typename S>
__device__ __forceinline__ void column_partials(S* acc, S* red, int c,
                                                int lane, int warp) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    for (int off = 16; off >= c; off >>= 1) {
      if constexpr (Q) acc[u] = ff::wadd(acc[u], shfl_xor(acc[u], off));
      else acc[u] = acc[u] + shfl_xor(acc[u], off);
    }
    if (lane < c) red[(warp * kChunk + u) * 32 + lane] = acc[u];
  }
}

// The batch-averaged update of one thread's synapses: columns [jv, jv + V)
// of rows r0, r0 + r_step, ... < n, theta's planes at th[r * row] (the
// resident slab, or device memory with V = 1), `plane` apart.  Each
// synapse's arithmetic is the per-step kernels'; V of them are loaded,
// computed and stored together.
template <bool Q, typename S, typename W>
struct Update {
  W* ws;
  const S *pre, *tps, *pre_sum, *post_sum;
  int n, c, m, B, col0, r0, r_step;
  float w_clip, sc;
  int qmax, seed;
  ff::QParams q;

  template <int V, typename TH>
  __device__ __forceinline__ void rows(const TH* th, int jv, int row,
                                       long plane) {
    const float fb = (float)B;
    S post[V];
#pragma unroll
    for (int v = 0; v < V; ++v) post[v] = post_sum[jv + v];
#pragma unroll 2
    for (int r = r0; r < n; r += r_step) {
      const int o = r * c + jv;
      S hebb[V];
#pragma unroll
      for (int v = 0; v < V; ++v) hebb[v] = S(0);
      for (int b = 0; b < B; ++b) {
        const S p = pre[b * n + r];
        S tp[V];
        ld_vec<V>(tp, tps + b * c + jv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if constexpr (Q) hebb[v] = ff::wadd(hebb[v], ff::wmul(p, tp[v]));
          else hebb[v] = hebb[v] + p * tp[v];
        }
      }
      TH t[4][V];
      const TH* tr = th + (long)r * row;
#pragma unroll
      for (int k = 0; k < 4; ++k) ld_vec<V>(t[k], tr + k * plane);
      W w[V];
      ld_vec<V>(w, ws + o);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float coef[4] = {ff::cvt<float>(t[0][v]), ff::cvt<float>(t[1][v]),
                               ff::cvt<float>(t[2][v]), ff::cvt<float>(t[3][v])};
        if constexpr (Q)
          w[v] = (int8_t)ff::plastic_q_coef((int)w[v], coef, hebb[v],
                                            pre_sum[r], post[v], sc, qmax,
                                            seed, r * m + col0 + jv + v, q);
        else
          w[v] = ff::plastic_f_coef(w[v], coef,
                                    B == 1 ? hebb[v] : __fdiv_rn(hebb[v], fb),
                                    pre_sum[r], post[v], w_clip);
      }
      st_vec<V>(ws + o, w);
    }
  }
};

// S and W: state and weights in shared memory; G and WG: in device memory
// (T = float | bfloat16 on the float path); TH: the rules' type.
template <bool Q, typename T, typename TH>
__global__ void __launch_bounds__(kThreads, 1)
rollout_shared_kernel(const __grid_constant__ Params p) {
  using ff::cvt;
  using S = typename Types<Q>::S;
  using W = typename Types<Q>::W;
  using G = std::conditional_t<Q, int, T>;
  using WG = std::conditional_t<Q, int8_t, T>;
  const SharedRolloutArgs& a = p.a;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);

  // ---- this CTA's role: columns [col0, col0 + own) of layer i ----------
  int i = 0;
  while ((int)blockIdx.x >= a.first_cta[i + 1]) ++i;
  const Layout lay = layout(a, i, Q);
  const int L = a.n_layers, B = a.batch, K = a.k_steps, D = a.bus_depth;
  const int n = a.sizes[i], m = a.sizes[i + 1], c = a.cols[i];
  const int lc = log2i(c);
  const int col0 = ((int)blockIdx.x - a.first_cta[i]) * c;
  const int own = min(c, m - col0);
  const bool last = i == L - 1, spiking = (a.spiking_mask >> i) & 1;
  const bool plastic = (a.plastic_mask >> i) & 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int we = Q ? 1 : (int)sizeof(T);
  const int w_route = a.w_route[i], th_route = a.th_route[i];
  const bool staged = (!Q && sizeof(T) == 2) || w_route == kWords;
  const bool resident = th_route == kTma || th_route == kCpAsync;

  TH* th = (TH*)(smem + lay.th);
  W* ws = (W*)(smem + lay.w);
  unsigned char* stage = smem + lay.stage;
  S* vs = (S*)(smem + lay.v);
  S* tps = (S*)(smem + lay.tp);
  S* tr0 = (S*)(smem + lay.tr0);
  S* xs = (S*)(smem + lay.xs);
  S* pres = (S*)(smem + lay.pres);
  S* pre_sum = (S*)(smem + lay.pre_sum);
  S* post_sum = (S*)(smem + lay.post_sum);
  S* red = (S*)(smem + lay.red);
  const uint32_t bar_w = smem_u32(smem + lay.bars);
  const uint32_t bar_th = bar_w + 8;

  // ---- issue every load of the owned slabs at once ---------------------
  if (tid == 0) {
    mbar_init(bar_w, 1);
    mbar_init(bar_th, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned char* w_dst = staged ? stage : (unsigned char*)ws;
  if (w_route == kTma) {
    if (tid == 0) {
      const int r_box = a.w_box[i], boxes = (n + r_box - 1) / r_box;
      mbar_expect_tx(bar_w, boxes * r_box * c * we);
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(smem_u32(w_dst + (long)b * r_box * c * we), &p.w_map[i],
                    bar_w, col0, b * r_box);
    }
  } else {
    copy_async(w_dst, a.w_in[i], n, m, c, own, col0, we, w_route,
               a.w_width[i], (int)lay.pitch);
  }
  cp_async_commit();
  const int tb = sizeof(TH);
  if (th_route == kTma) {
    if (tid == 0) {
      const int r_box = a.th_box[i], boxes = (4 * n + r_box - 1) / r_box;
      mbar_expect_tx(bar_th, boxes * r_box * c * tb);
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(smem_u32((unsigned char*)th + (long)b * r_box * c * tb),
                    &p.th_map[i], bar_th, col0, b * r_box);
    }
  } else if (th_route == kCpAsync) {
    copy_async((unsigned char*)th, a.theta[i], 4 * n, m, c, own, col0, tb,
               kCpAsync, a.th_width[i], 0);
  }
  cp_async_commit();

  // the small state while the slabs are in flight
  for (int e = tid; e < B * c; e += nt) {
    const int b = e >> lc, j = e & (c - 1);
    const long g = (long)b * m + col0 + j;
    vs[e] = j < own ? cvt<S>(((const G*)a.v_in[i])[g]) : S(0);
    tps[e] = j < own ? cvt<S>(((const G*)a.tr_in[i + 1])[g]) : S(0);
  }
  if (i == 0)
    for (int e = tid; e < B * n; e += nt)
      tr0[e] = cvt<S>(((const G*)a.tr_in[0])[e]);
  const float sc = Q ? *a.scale[i] : 0.0f;
  const int base_seed = Q ? *a.seed : 0;

  // ---- w must be in before the first forward pass ----------------------
  if (w_route == kTma) mbar_wait(bar_w, 0);
  cp_async_wait<1>();
  __syncthreads();
  if (staged) {                       // repack and / or promote to W
    for (int o = tid; o < n * c; o += nt) {
      const int r = o >> lc, j = o & (c - 1);
      W x = W(0);
      if (j < own) {
        const unsigned char* s =
            w_route == kWords
                ? stage + (long)r * lay.pitch +
                      ((uintptr_t)at(a.w_in[i], r, m, col0, we) & 3) + j * we
                : stage + (long)o * we;
        x = cvt<W>(*(const WG*)s);
      }
      ws[o] = x;
    }
    __syncthreads();
  }
  bool th_in = !resident;             // theta resident and arrived

  const unsigned* prog = a.progress;
  unsigned* mine = a.progress + blockIdx.x;
  const G* drives = (const G*)a.drives;
  G pf[kPrefetch];                    // layer 0: this thread's next drives
  if (i == 0) prefetch(pf, drives, B * n);
  for (int k = 0; k < K; ++k) {
    const unsigned stamp = a.base + (unsigned)k + 1u;
    const int slot = D > 0 ? k % D : 0;
    // a credit: every consumer has finished the step that used this slot
    if (!last && k >= D)
      wait_for(prog, a.first_cta[i + 1],
               a.first_cta[i + 2] - a.first_cta[i + 1], stamp - D);
    // ---- this step's input events and pre traces -----------------------
    if (i == 0) {
      const G* drive = drives + (long)k * B * n;
      auto put = [&](int e, G g) {
        const S x = cvt<S>(g);
        xs[e] = x;
        if constexpr (Q) tr0[e] = ff::trace_q(tr0[e], x, a.q);
        else tr0[e] = __fmaf_rn(a.f.decay, tr0[e], x);
      };
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u)
        if (tid + u * nt < B * n) put(tid + u * nt, pf[u]);
      for (int e = tid + kPrefetch * nt; e < B * n; e += nt) put(e, drive[e]);
    } else {
      wait_for(prog, a.first_cta[i - 1], a.first_cta[i] - a.first_cta[i - 1],
               stamp);
      const S* ev_in = (const S*)a.bus[i - 1] + (long)(2 * slot) * B * n;
      stage_l2(xs, ev_in, B * n);
      stage_l2(pres, ev_in + (long)B * n, B * n);
    }
    __syncthreads();
    const S* pre = i == 0 ? tr0 : pres;
    S* bus_ev = last ? nullptr : (S*)a.bus[i] + (long)(2 * slot) * B * m;
    S* bus_tr = last ? nullptr : bus_ev + (long)B * m;

    // ---- 1. Forward Engine on the owned columns ------------------------
    {
      const int j = tid & (c - 1), r0 = tid >> lc, lanes = nt >> lc;
      for (int b0 = 0; b0 < B; b0 += kChunk) {
        const int nb = min(kChunk, B - b0);
        S acc[kChunk];
        if (nb == 1) {
          row_partials<Q, 1>(acc, ws, xs + (long)b0 * n, n, c, j, r0, lanes,
                             1);
          column_partials<Q, 1>(acc, red, c, lane, warp);
        } else {
          row_partials<Q, kChunk>(acc, ws, xs + (long)b0 * n, n, c, j, r0,
                                  lanes, nb);
          column_partials<Q, kChunk>(acc, red, c, lane, warp);
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
            int i_fx = ff::current_fx(s, sc);
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
    }
    if (i == 0 && k + 1 < K)
      prefetch(pf, drives + (long)(k + 1) * B * n, B * n);

    // ---- 2. Plasticity Engine on the owned synapses --------------------
    if (plastic) {
      if (!th_in) {
        if (th_route == kTma) mbar_wait(bar_th, 0);
        cp_async_wait<0>();
        th_in = true;
      }
      const float fb = (float)B;
      // the batch means of the pre and post traces, once per step (x / 1
      // is x: B = 1 divides nothing)
      for (int r = tid; r < n; r += nt) {
        S s = S(0);
        for (int b = 0; b < B; ++b) {
          if constexpr (Q) s = ff::wadd(s, pre[b * n + r]);
          else s = s + pre[b * n + r];
        }
        if constexpr (Q) pre_sum[r] = s;
        else pre_sum[r] = B == 1 ? s : __fdiv_rn(s, fb);
      }
      if (tid < c) {
        S s = S(0);
        for (int b = 0; b < B; ++b) {
          if constexpr (Q) s = ff::wadd(s, tps[b * c + tid]);
          else s = s + tps[b * c + tid];
        }
        if constexpr (Q) post_sum[tid] = s;
        else post_sum[tid] = B == 1 ? s : __fdiv_rn(s, fb);
      }
      __syncthreads();
      // V consecutive columns a thread (all c of them: the slab's columns
      // past `own` are zeros and never written back), or one column of the
      // owned ones with theta in device memory
      Update<Q, S, W> up;
      up.ws = ws; up.pre = pre; up.tps = tps; up.pre_sum = pre_sum;
      up.post_sum = post_sum; up.n = n; up.c = c; up.m = m; up.B = B;
      up.col0 = col0; up.w_clip = a.w_clip; up.q = a.q;
      if constexpr (Q) {
        up.sc = sc;
        up.qmax = ff::qclip(a.w_clip, sc);
        up.seed = ff::fold_seed(ff::wadd(base_seed, k), i);
      }
      const int vw = !resident ? 1 : (c & 3) == 0 ? 4 : (c & 1) == 0 ? 2 : 1;
      const int groups = c / vw, jv = (tid % groups) * vw;
      up.r0 = tid / groups;
      up.r_step = nt / groups;
      if (!resident) {
        if (jv < own)
          up.template rows<1>((const TH*)a.theta[i] + col0 + jv, jv, m,
                              (long)n * m);
      } else if (vw == 4) {
        up.template rows<4>(th + jv, jv, c, (long)n * c);
      } else if (vw == 2) {
        up.template rows<2>(th + jv, jv, c, (long)n * c);
      } else {
        up.template rows<1>(th + jv, jv, c, (long)n * c);
      }
      __syncthreads();
    }
    // this step's slot is written (and its inputs consumed); published
    // after the update, when the fence finds the bus stores long done
    publish(mine, stamp);
  }

  // ---- single write-back of the owned state -----------------------------
  if (!staged) {
    store_pieces(a.w_out[i], (const unsigned char*)ws, n, m, c, own, col0, we,
                 a.w_width[i]);
  } else if (w_route != kWords) {     // bfloat16: round into the stage first
    for (int o = tid; o < n * c; o += nt) ((WG*)stage)[o] = cvt<WG>(ws[o]);
    __syncthreads();
    store_pieces(a.w_out[i], stage, n, m, c, own, col0, we, a.w_width[i]);
  } else {
    for (int o = tid; o < n * c; o += nt) {
      const int r = o >> lc, j = o & (c - 1);
      if (j < own) ((WG*)a.w_out[i])[(long)r * m + col0 + j] = cvt<WG>(ws[o]);
    }
  }
  for (int e = tid; e < B * c; e += nt) {
    const int b = e >> lc, j = e & (c - 1);
    if (j < own) {
      ((G*)a.v_out[i])[(long)b * m + col0 + j] = cvt<G>(vs[e]);
      ((G*)a.tr_out[i + 1])[(long)b * m + col0 + j] = cvt<G>(tps[e]);
    }
  }
  if (blockIdx.x == 0)
    for (int e = tid; e < B * n; e += nt)
      ((G*)a.tr_out[0])[e] = cvt<G>(tr0[e]);
}

// ---- host side ---------------------------------------------------------------

// The residency of one instantiation at one shared-memory size on one
// device, found once: the attribute set and the CTAs the card can hold.
struct Residency {
  const void* kernel;
  int device;
  size_t smem;
  long ctas;
};

int resident_ctas(const void* kernel, size_t smem, long* ctas) {
  static std::mutex mu;
  static Residency seen[32];
  static int n_seen = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  for (int s = 0; s < n_seen; ++s)
    if (seen[s].kernel == kernel && seen[s].device == device &&
        seen[s].smem == smem) {
      *ctas = seen[s].ctas;
      return 0;
    }
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  *ctas = (long)per_sm * sms;
  if (n_seen < 32) seen[n_seen++] = {kernel, device, smem, *ctas};
  return 0;
}

template <bool Q, typename T, typename TH>
int launch(const SharedRolloutArgs* a, size_t expected_smem,
           cudaStream_t stream) {
  size_t smem = 0;
  for (int i = 0; i < a->n_layers; ++i) {
    const size_t role = layout(*a, i, Q).total;
    smem = role > smem ? role : smem;
  }
  if (smem != expected_smem) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)rollout_shared_kernel<Q, T, TH>;
  const int grid = a->first_cta[a->n_layers];
  long ctas = 0;
  const int err = resident_ctas(kernel, smem, &ctas);
  if (err != 0) return err;
  // every CTA must be resident at once: consumers spin on producers
  if (ctas < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params prm;
  prm.a = *a;
  const int we = Q ? 1 : (int)sizeof(T), tb = sizeof(TH);
  for (int i = 0; i < a->n_layers; ++i) {
    const int n = a->sizes[i], m = a->sizes[i + 1], c = a->cols[i];
    if (a->w_route[i] == kTma &&
        !encode(&prm.w_map[i], a->w_in[i], n, m, we, c, a->w_box[i]))
      return (int)cudaErrorInvalidValue;
    if (a->th_route[i] == kTma &&
        !encode(&prm.th_map[i], a->theta[i], 4 * n, m, tb, c, a->th_box[i]))
      return (int)cudaErrorInvalidValue;
  }
  void* params[] = {&prm};
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid),
                                              dim3(kThreads), params, smem,
                                              stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// expected_smem: the wrapper's count of the largest role's layout, checked
// against this file's.
extern "C" int rollout_shared(const SharedRolloutArgs* a, int quant,
                              size_t expected_smem, cudaStream_t stream) {
  const int L = a->n_layers;
  if (L < 1 || L > kMaxLayers || a->batch < 1 || a->k_steps < 1 ||
      (L > 1 && a->bus_depth < 1) || a->first_cta[0] != 0 ||
      (quant && (a->bf16 || a->theta_bf16)) || (a->theta_bf16 && !a->bf16))
    return (int)cudaErrorInvalidValue;
  const int we = quant ? 1 : (a->bf16 ? 2 : 4);
  const int tb = a->theta_bf16 ? 2 : 4;
  for (int i = 0; i < L; ++i) {
    const int c = a->cols[i], m = a->sizes[i + 1];
    const bool plastic = (a->plastic_mask >> i) & 1;
    if (c < 1 || c > 32 || (c & (c - 1)) != 0 ||
        a->first_cta[i + 1] - a->first_cta[i] != (m + c - 1) / c ||
        (a->w_route[i] != kTma && a->w_route[i] != kCpAsync &&
         a->w_route[i] != kWords) ||
        (plastic ? a->th_route[i] == kNone || a->th_route[i] == kWords
                 : a->th_route[i] != kNone))
      return (int)cudaErrorInvalidValue;
    // the 16-byte rules of a TMA box, and whole pieces of a cp.async
    if ((a->w_route[i] == kTma && ((m * we) % 16 || (c * we) % 16)) ||
        (a->th_route[i] == kTma && ((m * tb) % 16 || (c * tb) % 16)) ||
        (a->w_route[i] == kCpAsync &&
         ((m * we) % a->w_width[i] || (c * we) % a->w_width[i])) ||
        (a->th_route[i] == kCpAsync &&
         ((m * tb) % a->th_width[i] || (c * tb) % a->th_width[i])))
      return (int)cudaErrorInvalidValue;
  }
  using bf16 = __nv_bfloat16;
  if (quant) return launch<true, float, float>(a, expected_smem, stream);
  if (!a->bf16) return launch<false, float, float>(a, expected_smem, stream);
  return a->theta_bf16
             ? launch<false, bf16, bf16>(a, expected_smem, stream)
             : launch<false, bf16, float>(a, expected_smem, stream);
}
