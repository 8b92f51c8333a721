// Device functions shared by the core-loop kernels (rotated_fused_tc.cu
// and streaming_fused_tc.cu): the dot-product tiers and the f32 density
// formulas of picard_ica_tpu/ops/densities.py.
//
// Tiers: F32 = exact f32 products; BF16 = both operands rounded to bf16
// (__float2bfloat16_rn), f32 accumulation; BF16X3 = the hi/lo split, hi*hi
// + lo*hi + hi*lo, f32 accumulation (split: an operand's parts at the
// tier). Products of bf16 values are exact in f32, so only the order of
// the sums differs from the plain PyTorch versions in ops/kernels.py.
//
// The density functions take any parameter struct P with the f32 fields
// a (alpha), m2a (f32(-2 alpha)) and mha (f32(-alpha / 2)).

#pragma once

#include <cuda_bf16.h>

namespace {

enum Tier { F32 = 0, BF16X3 = 1, BF16 = 2 };
enum Dens { TANH = 0, EXP = 1, CUBE = 2 };

struct Sp {
  float hi, lo;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int TIER>
__device__ __forceinline__ Sp split(float v) {
  Sp s;
  if (TIER == F32) {
    s.hi = v;
    s.lo = 0.f;
  } else if (TIER == BF16) {
    s.hi = bf16_round(v);
    s.lo = 0.f;
  } else {
    s.hi = bf16_round(v);
    s.lo = bf16_round(v - s.hi);
  }
  return s;
}

// ---- densities: the f32 formulas of picard_ica_tpu/ops/densities.py ----

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float expm1_poly(float t) {
  return t * (1.0f + t * ((float)(1.0 / 2) + t * ((float)(1.0 / 6) +
         t * ((float)(1.0 / 24) + t * ((float)(1.0 / 120) +
         t * ((float)(1.0 / 720) + t * ((float)(1.0 / 5040) +
         t * (float)(1.0 / 40320))))))));
}

// score_and_der (moments kernel)
template <int D, class P>
__device__ __forceinline__ void score_der(const P& p, float y, float& psi,
                                          float& psid) {
  if (D == TANH) {
    float s = tanhf(p.a * y);
    psi = s;
    psid = p.a * (1.f - s * s);
  } else if (D == EXP) {
    float ysq = y * y;
    float k = expf(p.mha * ysq);
    psi = y * k;
    psid = (1.f - p.a * ysq) * k;
  } else {
    psi = (y * y) * y;
    psid = (3.f * y) * y;
  }
}

// log_lik (loglik kernel)
template <int D, class P>
__device__ __forceinline__ float log_lik(const P& p, float y) {
  if (D == TANH) {
    float ay = fabsf(y);
    return ay + log1pf(expf(p.m2a * ay)) / p.a;
  } else if (D == EXP) {
    return -expf(((-p.a) * y) * y / 2.f) / p.a;
  } else {
    float y2 = y * y;
    return y2 * y2 / 4.f;
  }
}

// score_der_loglik (plain fused mode)
template <int D, class P>
__device__ __forceinline__ void score_der_loglik(const P& p, float y,
                                                 float& psi, float& psid,
                                                 float& ll) {
  if (D == TANH) {
    float ay = fabsf(y);
    float e = expf(p.m2a * ay);
    float t = (1.f - e) / (1.f + e);
    psi = sign_of(y) * t;
    psid = p.a * (1.f - t * t);
    ll = ay + log1pf(e) / p.a;
  } else if (D == EXP) {
    float ysq = y * y;
    float k = expf(p.mha * ysq);
    psi = y * k;
    psid = (1.f - p.a * ysq) * k;
    ll = -k / p.a;
  } else {
    float y2 = y * y;
    psi = y2 * y;
    psid = 3.f * y2;
    ll = y2 * y2 / 4.f;
  }
}

// score_der_loglik_delta (delta fused mode); f32 branch of densities.py,
// including tanh's native-tanh form (densities.py:174-193).
template <int D, class P>
__device__ __forceinline__ void score_der_loglik_delta(const P& p,
                                                       float y_old, float dy,
                                                       float& psi, float& psid,
                                                       float& dll) {
  float y_new = y_old + dy;
  if (D == TANH) {
    float abs_old = fabsf(y_old);
    float e_b = expf(p.m2a * abs_old);
    bool crossing = abs_old <= fabsf(dy);
    float d_abs = crossing ? fabsf(y_new) - abs_old : sign_of(y_old) * dy;
    float t = p.m2a * d_abs;
    bool small = fabsf(t) < 0.5f;
    float score = tanhf(p.a * y_new);
    psi = score;
    psid = p.a * (1.f - score * score);
    float abs_th = fabsf(score);
    float e_a = (1.f - abs_th) / (1.f + abs_th);
    float num = small ? e_b * expm1_poly(fminf(fmaxf(t, -0.5f), 0.5f))
                      : e_a - e_b;
    dll = d_abs + log1pf(num / (1.f + e_b)) / p.a;
  } else if (D == EXP) {
    float y_sq = y_new * y_new;
    float k_a = expf(p.mha * y_sq);
    float k_b = expf((p.mha * y_old) * y_old);
    psi = y_new * k_a;
    psid = (1.f - p.a * y_sq) * k_a;
    float q = (p.mha * (2.f * y_old + dy)) * dy;
    bool small = fabsf(q) < 0.5f;
    dll = small ? (-k_b * expm1_poly(fminf(fmaxf(q, -0.5f), 0.5f))) / p.a
                : (k_b - k_a) / p.a;
  } else {
    float y2 = y_new * y_new;
    psi = y2 * y_new;
    psid = 3.f * y2;
    dll = ((y_new * y_new + y_old * y_old) * (y_new + y_old)) * dy / 4.f;
  }
}

}  // namespace
