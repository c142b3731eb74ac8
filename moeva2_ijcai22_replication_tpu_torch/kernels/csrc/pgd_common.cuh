// Device helpers the constrained-PGD kernels K7 (pgd_lcld.cu) and K7b
// (pgd_botnet.cu) share: attacks/pgd/engine.py's plain operations and
// core/vjp.py's backward rules, one rounded float32 operation at a time
// (__fadd_rn / __fmul_rn / __fdiv_rn, so nvcc cannot contract them into
// FMAs).
#pragma once

#include <cmath>

#include "kernels.h"

__device__ __forceinline__ int padded_stride(int in_w) { return in_w | 1; }

// torch.relu, which keeps a NaN
__device__ __forceinline__ float relu_keep_nan(float x) {
  return !(x > 0.0f) && !isnan(x) ? 0.0f : x;
}

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return nan_min(nan_max(x, lo), hi);
}

__device__ __forceinline__ float exp_rn(float x) { return __double2float_rn(exp(static_cast<double>(x))); }

// __fdiv_rn(n, d), with n = ±0 over a d that is neither 0 nor NaN answered
// as the signed zero it is: the division's range check (FCHK) sends a zero
// numerator down its slow path, and the elementwise phases divide many
__device__ __forceinline__ float div_rn(float n, float d) {
  const bool zero = n == 0.0f && d == d && d != 0.0f;
  const float q = __fdiv_rn(zero ? 1.0f : n, d);
  return zero ? __int_as_float((__float_as_int(n) ^ __float_as_int(d)) & 0x80000000) : q;
}

// the scaler's inverse: (x - min_) / scale
__device__ __forceinline__ float unscale(float x, float mn, float sc) { return div_rn(__fsub_rn(x, mn), sc); }

// jax.grad's abs: the cotangent where v >= 0, its negation elsewhere
__device__ __forceinline__ float abs_vjp(float v, float ct) { return v >= 0.0f ? ct : -ct; }

// jnp.clip(v, 0, inf)'s cotangent: (ct * minimum's factor) * maximum's
__device__ __forceinline__ float clip_vjp(float v, float ct) {
  const float lo = v == INFINITY ? 0.5f : (isnan(v) ? 0.0f : 1.0f);
  const float hi = v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
  return __fmul_rn(__fmul_rn(ct, lo), hi);
}

// cotangents of num / den: ct / den and -((ct * (1 / (den * den))) * num)
__device__ __forceinline__ void div_vjp(float ct, float num, float den, float& c_num, float& c_den) {
  c_num = div_rn(ct, den);
  c_den = -__fmul_rn(__fmul_rn(ct, __fdiv_rn(1.0f, __fmul_rn(den, den))), num);
}

// the momentum step x + alpha (z - x) + (1 - alpha)(x - x_prev), added left
// to right
__device__ __forceinline__ float momentum(float x, float z, float xp, float alpha) {
  return __fadd_rn(__fadd_rn(x, __fmul_rn(alpha, __fsub_rn(z, x))), __fmul_rn(__fsub_rn(1.0f, alpha), __fsub_rn(x, xp)));
}

// clip(pre, 0, inf) as torch.clamp gives it: a NaN stays
__device__ __forceinline__ float clip_smooth(float pre) { return isnan(pre) ? pre : fmaxf(pre, 0.0f); }

// The cross-entropy of the logits `lg` of a 1- or 2-class head at label
// `yv` (negated when targeted) and the cotangent of the logits into `ct_l`,
// for the class loss weight wc: grad_and_terms_plain's operations (exp and
// log in float64 rounded once; ct_l = ct_ls + (sum(-ct_ls) / sum(e)) * e)
__device__ __forceinline__ float cross_entropy(int classes, bool targeted, const float* lg, int yv, float wc,
                                               float* ct_l) {
  const int c = classes;
  const float l0 = lg[0];
  const float l1 = c == 2 ? lg[1] : 0.0f;
  const float mx = c == 2 ? nan_max(l0, l1) : l0;
  const float s0 = __fsub_rn(l0, mx);
  const float s1 = __fsub_rn(l1, mx);
  const float e0 = exp_rn(s0);
  const float e1 = exp_rn(s1);
  const float tot = c == 2 ? __fadd_rn(e0, e1) : e0;
  const float lse = __double2float_rn(log(static_cast<double>(tot)));
  const float y0 = yv == 0 ? 1.0f : 0.0f;
  const float y1 = yv == 1 ? 1.0f : 0.0f;
  const float p0 = __fmul_rn(y0, __fsub_rn(s0, lse));
  const float sum = c == 2 ? __fadd_rn(p0, __fmul_rn(y1, __fsub_rn(s1, lse))) : p0;
  const float ce = -sum;
  const float cs = targeted ? wc : -wc;
  const float cl0 = __fmul_rn(cs, y0);
  const float cl1 = __fmul_rn(cs, y1);
  const float c_total = __fdiv_rn(c == 2 ? __fadd_rn(-cl0, -cl1) : -cl0, tot);
  ct_l[0] = __fadd_rn(cl0, __fmul_rn(c_total, e0));
  if (c == 2) ct_l[1] = __fadd_rn(cl1, __fmul_rn(c_total, e1));
  return targeted ? -ce : ce;
}

// The class at the logits `lg`: mlp_proba_plain's probabilities (softmax,
// or [1 - p, p] for a 1-column head), the first largest (a NaN counts as
// the largest), as engine.py::predict_plain takes it
__device__ __forceinline__ int64_t predicted_class(int classes, const float* lg) {
  float p0, p1;
  if (classes == 1) {
    p1 = __fdiv_rn(1.0f, __fadd_rn(1.0f, exp_rn(-lg[0])));
    p0 = __fsub_rn(1.0f, p1);
  } else {
    const float mx = nan_max(lg[0], lg[1]);
    const float e0 = exp_rn(__fsub_rn(lg[0], mx));
    const float e1 = exp_rn(__fsub_rn(lg[1], mx));
    const float sum = __fadd_rn(e0, e1);
    p0 = __fdiv_rn(e0, sum);
    p1 = __fdiv_rn(e1, sum);
  }
  return p1 > p0 || (isnan(p1) && !isnan(p0)) ? 1 : 0;
}
