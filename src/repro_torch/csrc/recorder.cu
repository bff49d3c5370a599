// One recorded step of a controller fleet in one launch: the flight
// recorder and its streaming detectors.
//
//   recorder  replaces the part of the JAX package's jitted record-variant
//             pool step that XLA fuses around the rollout (no Pallas
//             kernel): src/repro/serving/scheduler.py:870 `_record`, i.e.
//             obs/recorder.py:136 `network_weight_norm`, :71
//             `recorder_update` and obs/health.py:145 `health_update`.
//
// What it computes, for each slot b of B (one warp a slot):
//   wnorm   = sum over layers l of  mean |w_l[b]|   (int8 planes as
//             float(sum |w|) / (N M) * w_scale_l[b]; the layers added in
//             order, the first one alone)
//   wnorm0  latches wnorm at the slot's first active recorded step
//   x       = (spike_rate, mean_abs_dw, sat_frac, |wnorm - wnorm0|),
//             exact zeros where the slot is inactive
//   ring[b, row, :] = x
//   the four detectors and the winsorized EWMA update of obs/health.py in
//   the same order of operations, one lane a channel (lane c < 4 holds
//   channel c and detector c); the detectors' any/all across channels are
//   warp ballots.
// Every float operation rounds once, as written: the build passes
// -fmad=false, and sqrt and division are the IEEE ones (__fsqrt_rn,
// __fdiv_rn), so the detectors equal the plain version's given the same
// channels; float32 weight norms are summed in another order than the
// plain version's (lane-strided, then a butterfly across the warp).
//
// The recorder state is updated in place: each slot's rows are read and
// written by its own warp only.  `row` (the ring cursor mod W) and every
// detector constant are arguments by value: no host sync, no copy.
//
// What bounds it on an H100: bytes.  At 8-128-8, B = 4096 the weights are
// 33.5 MB in float32 (8.4 MB in int8), the ring row, telemetry and state
// under 0.5 MB: ~10 us (2.5 us) at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 4;            // channels == detectors
constexpr int kMaxLayers = 8;
constexpr int kWarps = 8;        // slots a CTA

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum |w| over one slot's N*M weights, lane-strided (16-byte loads where
// the row and its length allow), then across the warp
template <typename W> struct Abs;
template <> struct Abs<float> {
  using Acc = float;
  static __device__ __forceinline__ float of(float v) { return fabsf(v); }
};
template <> struct Abs<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float of(__nv_bfloat16 v) {
    return fabsf(__bfloat162float(v));
  }
};
template <> struct Abs<int8_t> {
  using Acc = long long;
  static __device__ __forceinline__ long long of(int8_t v) {
    return v < 0 ? -(long long)v : (long long)v;
  }
};

template <typename W>
__device__ typename Abs<W>::Acc slot_abs_sum(const W* w, long long nm,
                                             int lane) {
  using Acc = typename Abs<W>::Acc;
  constexpr int kV = 16 / sizeof(W);
  Acc acc = 0;
  if (nm % kV == 0 && (uintptr_t)w % 16 == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(w);
    for (long long i = lane; i < nm / kV; i += 32) {
      const uint4 q = p[i];
      const W* e = reinterpret_cast<const W*>(&q);
#pragma unroll
      for (int j = 0; j < kV; ++j) acc += Abs<W>::of(e[j]);
    }
  } else {
    for (long long i = lane; i < nm; i += 32) acc += Abs<W>::of(w[i]);
  }
  return warp_sum(acc);
}

template <typename W>
__global__ void __launch_bounds__(kWarps * 32)
recorder_kernel(Layers layers, Channels ch, const unsigned char* active,
                State s, long long row, int window, int b, Config cfg,
                unsigned char* verdict) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= b) return;                    // whole warps leave together

  // the network weight norm, layer by layer in order
  float wnorm = 0.f;
  for (int l = 0; l < layers.count; ++l) {
    const long long nm = layers.nm[l];
    const W* w = static_cast<const W*>(layers.w[l]) + (long long)slot * nm;
    float a;
    if constexpr (sizeof(W) == 1) {
      const float sum = (float)slot_abs_sum<W>(w, nm, lane);
      a = __fmul_rn(__fdiv_rn(sum, (float)nm), layers.scale[l][slot]);
    } else {
      a = __fdiv_rn(slot_abs_sum<W>(w, nm, lane), (float)nm);
    }
    wnorm = l == 0 ? a : __fadd_rn(wnorm, a);
  }

  // every read of the slot's state before any write
  const bool act = active == nullptr || active[slot] != 0;
  const int steps = s.steps[slot];
  const bool warm = steps >= cfg.warmup;
  const float w0 = (act && steps == 0) ? wnorm : s.wnorm0[slot];
  const int c = lane < kC ? lane : 0;
  const long long sc = (long long)slot * kC + c;
  float x = c < 3 ? ch.col[c][slot * ch.stride[c]] : fabsf(wnorm - w0);
  if (!act) x = 0.f;
  const float mean = s.mean[sc], var = s.var[sc], last = s.last[sc];
  const int streak = s.streaks[sc];
  const bool was_flagged = s.flagged[sc] != 0;
  __syncwarp();

  // detection against the baseline from before the update
  const float sd = __fsqrt_rn(__fadd_rn(var, cfg.floor2));
  const float z = __fdiv_rn(fabsf(__fsub_rn(x, mean)), sd);
  const bool mine = lane < kC;
  const unsigned fz = __ballot_sync(0xffffffffu, mine && z > cfg.z_thr);
  const unsigned fb = __ballot_sync(
      0xffffffffu, mine && (x < cfg.lo[c] || x > cfg.hi[c]));
  const unsigned fs = __ballot_sync(
      0xffffffffu, mine && fabsf(__fsub_rn(x, last)) <= cfg.stuck_eps);
  const float x0 = __shfl_sync(0xffffffffu, x, 0);
  const bool fire_bound = fb != 0u;
  bool fire[kC];
  fire[0] = act && warm && fz != 0u;
  fire[1] = act && fire_bound;
  fire[2] = act && warm && fs == (1u << kC) - 1u;
  fire[3] = act && warm && x0 < cfg.dead_floor;
  const int new_streak = fire[c] ? streak + 1 : 0;
  const bool flag = was_flagged || new_streak >= cfg.hyst[c];
  const unsigned flags = __ballot_sync(0xffffffffu, mine && flag);

  // the winsorized baseline update; inactive slots hold their state
  const bool learn = act && !fire_bound;
  float d = __fsub_rn(x, mean);
  if (warm) {
    const float cap = __fmul_rn(cfg.z_thr, sd);
    d = fminf(fmaxf(d, -cap), cap);
  }
  const float a = cfg.alpha;
  const float new_mean = learn ? __fadd_rn(mean, __fmul_rn(a, d)) : mean;
  const float new_var =
      learn ? __fmul_rn(cfg.one_minus_alpha,
                        __fadd_rn(var, __fmul_rn(__fmul_rn(a, d), d)))
            : var;

  if (mine) {
    s.ring[((long long)slot * window + row) * kC + c] = x;
    s.mean[sc] = new_mean;
    s.var[sc] = new_var;
    s.last[sc] = act ? x : last;
    s.streaks[sc] = new_streak;
    s.flagged[sc] = flag ? 1 : 0;
  }
  if (lane == 0) {
    s.wnorm0[slot] = w0;
    s.steps[slot] = steps + (act ? 1 : 0);
    verdict[slot] = flags != 0u ? 1 : 0;
  }
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
// lo[4], hi[4] (float32); icfg: warmup, hysteresis[4].  Returns a
// cudaError_t.
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
                             const int* icfg, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || b < 0 || window < 1 ||
      row < 0 || row >= window || w_dtype < 0 || w_dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  Layers layers{};
  for (int l = 0; l < n_layers; ++l) {
    if (nm[l] < 1 || (w_dtype == 2 && scales[l] == nullptr))
      return (int)cudaErrorInvalidValue;
    layers.w[l] = w[l];
    layers.scale[l] = scales[l];
    layers.nm[l] = nm[l];
  }
  layers.count = n_layers;
  Channels ch{};
  for (int i = 0; i < 3; ++i) {
    ch.col[i] = chan[i];
    ch.stride[i] = chan_stride[i];
  }
  Config cfg{};
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
  State s{ring, wnorm0, mean, var, last, streaks, flagged, steps};
  const dim3 grid((b + kWarps - 1) / kWarps);
  if (w_dtype == 0)
    recorder_kernel<float><<<grid, kWarps * 32, 0, stream>>>(
        layers, ch, active, s, row, window, b, cfg, verdict);
  else if (w_dtype == 1)
    recorder_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, stream>>>(
        layers, ch, active, s, row, window, b, cfg, verdict);
  else
    recorder_kernel<int8_t><<<grid, kWarps * 32, 0, stream>>>(
        layers, ch, active, s, row, window, b, cfg, verdict);
  return (int)cudaGetLastError();
}
