// Device helpers shared by the fleet-step, shared-step and rollout kernels.
//
// Each helper repeats, operation for operation, the arithmetic of
// repro_torch/kernels/plasticity/quant.py (and of the JAX reference it is
// held against).  The sources are compiled with -fmad=false and without
// --use_fast_math, so every +, * and / below is one IEEE round-to-nearest
// operation and the only fused multiply-adds are the explicit __fmaf_rn
// calls: the places where XLA contracts the reference's dw and trace sums.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ff {

constexpr int kAlpha = 0, kBeta = 1, kGamma = 2, kDelta = 3;
constexpr int kMaxLayers = 8;

// Fixed-point parameters (QuantConfig plus the derived constants).
struct QParams {
  int one;           // 2**frac_bits
  int tau_shift;
  int trace_shift;
  int vth_fx;        // round(v_th * one)
  int vres_fx;       // round(v_reset * one)
  int stoch_round;
  float inv1;        // fp32(1 / (one * B)): B = 1 in fleet mode, the batch
  float inv2;        // fp32(1 / (one**2 * B))   of a shared-weight step
};

// Float-datapath scalars shared by every layer of a call.
struct FParams {
  float inv_tau;     // fp32(1 / tau_m)
  float v_th;
  float v_reset;
  float decay;       // trace decay lambda
};

// Element conversions between device memory and the compute types.  A
// bfloat16 operand is promoted to float32 on load (exactly) and a float32
// result rounded to bfloat16 on store with round-to-nearest-even, the
// rounding of the reference's astype; every other pair is a plain cast.
template <typename D, typename S>
__device__ __forceinline__ D cvt(S x) { return (D)x; }
template <>
__device__ __forceinline__ float cvt<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16, float>(float x) {
  return __float2bfloat16_rn(x);
}

// State type S (float | int32) and weight type W (float | int8) of the
// float and fixed-point datapaths, as computed and as kept on chip.
template <bool Q>
struct Types;
template <>
struct Types<false> { using S = float; using W = float; };
template <>
struct Types<true> { using S = int; using W = int8_t; };

// ---- int32 arithmetic with defined wrap-around (signed overflow is
// undefined in C++; the reference wraps) ---------------------------------
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// quant.fold_seed: seed * 1000003 + layer, int32 wrap-around.
__device__ __forceinline__ int fold_seed(int seed, int layer) {
  return (int)((uint32_t)seed * 1000003u + (uint32_t)layer);
}

// quant.uniform_hash: uniform in [0, 1) from (seed, flat weight index).
__device__ __forceinline__ float uniform_hash(int seed, int idx) {
  uint32_t h = (uint32_t)idx * 0x9E3779B1u;
  h ^= ((uint32_t)seed + 0x7F4A7C15u) * 0x85EBCA6Bu;
  h ^= h >> 15;
  h *= 0xC2B2AE35u;
  h ^= h >> 13;
  h *= 0x27D4EB2Fu;
  h ^= h >> 16;
  return __uint2float_rn(h >> 8) * 5.9604644775390625e-08f;  // 2**-24
}

// quant.current_fx: round_half_even(float(acc) * scale).
__device__ __forceinline__ int current_fx(int acc, float scale) {
  return __float2int_rn(__fmul_rn(__int2float_rn(acc), scale));
}

// quant.neuron_update_q (arithmetic shift; hard reset or clip readout).
__device__ __forceinline__ void neuron_q(int v, int i_fx, bool spiking,
                                         const QParams& q, int* event,
                                         int* v_out) {
  int vn = wadd(v, wsub(i_fx, v) >> q.tau_shift);
  if (spiking) {
    bool sp = vn >= q.vth_fx;
    *event = sp ? q.one : 0;
    *v_out = sp ? q.vres_fx : vn;
  } else {
    *event = min(max(vn, -q.one), q.one);
    *v_out = vn;
  }
}

// quant.trace_update_q: tp - (tp >> k) + event.
__device__ __forceinline__ int trace_q(int tp, int event, const QParams& q) {
  return wadd(wsub(tp, tp >> q.trace_shift), event);
}

// The float neuron: v + (I - v) / tau, LIF hard reset or tanh readout.
__device__ __forceinline__ void neuron_f(float v, float current, bool spiking,
                                         const FParams& f, float* event,
                                         float* v_out) {
  float vn = v + (current - v) * f.inv_tau;
  if (spiking) {
    bool sp = vn >= f.v_th;
    *event = sp ? 1.0f : 0.0f;
    *v_out = sp ? f.v_reset : vn;
  } else {
    *event = tanhf(vn);
    *v_out = vn;
  }
}

// fma(g, post, fma(a, hebb, b * pre)) + d — the contracted four-term sum,
// from the rule's four coefficients of one synapse.
__device__ __forceinline__ float four_term(float a, float b, float g, float d,
                                          float hebb, float pre, float post) {
  float inner = __fmaf_rn(a, hebb, __fmul_rn(b, pre));
  return __fadd_rn(__fmaf_rn(g, post, inner), d);
}

// Float plasticity for one synapse from its Hebbian, pre and post terms:
// clip(w + dw, +-w_clip); `coef` holds its (alpha, beta, gamma, delta).
__device__ __forceinline__ float plastic_f_coef(float w, const float* coef,
                                               float hebb, float pre,
                                               float post, float w_clip) {
  float dw = four_term(coef[0], coef[1], coef[2], coef[3], hebb, pre, post);
  return fminf(fmaxf(w + dw, -w_clip), w_clip);
}

// The same with the rule's planes at th (plane apart; float32 or bfloat16,
// promoted on load).
template <typename TH>
__device__ __forceinline__ float plastic_f_terms(float w, const TH* th,
                                                long plane, float hebb,
                                                float pre, float post,
                                                float w_clip) {
  const float coef[4] = {
      cvt<float>(th[kAlpha * plane]), cvt<float>(th[kBeta * plane]),
      cvt<float>(th[kGamma * plane]), cvt<float>(th[kDelta * plane])};
  return plastic_f_coef(w, coef, hebb, pre, post, w_clip);
}

// Per-stream (fleet) float plasticity: hebb = pre * post.
template <typename TH>
__device__ __forceinline__ float plastic_f(float w, const TH* th,
                                          long plane, float pre, float post,
                                          float w_clip) {
  return plastic_f_terms(w, th, plane, __fmul_rn(pre, post), pre, post,
                         w_clip);
}

// The fixed-point tail of one synapse's update from st = dw / scale: st
// rounded to grid steps (stochastically from the synapse's hash, or to
// nearest), added to w and clipped to +-qmax.
__device__ __forceinline__ int q_steps_clip(int w, float st, int qmax,
                                           int seed, int idx,
                                           const QParams& q) {
  int steps;
  if (q.stoch_round) {
    float fl = floorf(st);
    float up = (__fsub_rn(st, fl) > uniform_hash(seed, idx)) ? 1.0f : 0.0f;
    steps = (int)__fadd_rn(fl, up);
  } else {
    steps = __float2int_rn(st);
  }
  return min(max(wadd(w, steps), -qmax), qmax);
}

__device__ __forceinline__ int q_round_clip(int w, float dw, float scale,
                                           int qmax, int seed, int idx,
                                           const QParams& q) {
  return q_steps_clip(w, __fdiv_rn(dw, scale), qmax, seed, idx, q);
}

// Fixed-point plasticity for one synapse from EXACT integer trace
// reductions (quant.dw_from_int_reductions): hebb = sum_b pre_b * post_b,
// pre/post = the batch sums, scaled by q.inv2 / q.inv1.  Then the
// stochastic round to grid steps and the clip to qclip(w_clip, scale).
// `coef` holds the synapse's (alpha, beta, gamma, delta).
__device__ __forceinline__ int plastic_q_coef(int w, const float* coef,
                                             int hebb, int pre, int post,
                                             float scale, int qmax, int seed,
                                             int idx, const QParams& q) {
  float dw = four_term(coef[0], coef[1], coef[2], coef[3],
                       __fmul_rn(__int2float_rn(hebb), q.inv2),
                       __fmul_rn(__int2float_rn(pre), q.inv1),
                       __fmul_rn(__int2float_rn(post), q.inv1));
  return q_round_clip(w, dw, scale, qmax, seed, idx, q);
}

// The same with the rule's planes at th (plane apart).
__device__ __forceinline__ int plastic_q_sums(int w, const float* th,
                                             long plane, int hebb, int pre,
                                             int post, float scale, int qmax,
                                             int seed, int idx,
                                             const QParams& q) {
  const float coef[4] = {th[kAlpha * plane], th[kBeta * plane],
                         th[kGamma * plane], th[kDelta * plane]};
  return plastic_q_coef(w, coef, hebb, pre, post, scale, qmax, seed, idx, q);
}

// Per-stream (fleet) fixed-point plasticity: the exact outer product.
__device__ __forceinline__ int plastic_q(int w, const float* th, long plane,
                                        int pre, int post, float scale,
                                        int qmax, int seed, int idx,
                                        const QParams& q) {
  return plastic_q_sums(w, th, plane, wmul(pre, post), pre, post, scale,
                        qmax, seed, idx, q);
}

// 1 / scale where the scale is a power of two with a normal reciprocal
// (then dw * inv is dw / scale exactly: the same correctly rounded
// quotient), else 0.
__device__ __forceinline__ float exact_inverse(float scale) {
  const unsigned bits = __float_as_uint(scale);
  const unsigned e = (bits >> 23) & 0xff;
  return (bits & 0x7fffff) == 0 && e >= 1 && e <= 253
             ? __fdiv_rn(1.0f, scale) : 0.0f;
}

// quant.qclip: min(floor(w_clip / scale), 127).
__device__ __forceinline__ int qclip(float w_clip, float scale) {
  return (int)fminf(floorf(__fdiv_rn(w_clip, scale)), 127.0f);
}

}  // namespace ff
