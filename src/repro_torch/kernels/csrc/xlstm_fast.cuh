// The sLSTM cell's short forms, shared by the forward (xlstm_scan.cu)
// and its backward (xlstm_scan_bwd.cu), so that the backward's f', i',
// tanh z and sigmoid o round as the forward's own: in place of the
// accurate expf, log1pf, tanhf and IEEE divisions, e^x as ex2.approx of
// x log2(e), 1 / x by rcp.approx and one Newton step, and log1p by a
// series that keeps its relative accuracy down to e = 0.
#pragma once

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x for finite x in [1, 2^127]
__device__ __forceinline__ float fast_rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(fmaf(-x, r, 1.f), r, r);
}

__device__ __forceinline__ float fast_exp(float x) {
  return ex2_approx(x * kLog2e);
}

// log(1 + e) for e in [0, 1]: 2 atanh(s), s = e / (2 + e) <= 1/3, by its
// series to s^15 (the next term is below 2^-25 of the sum)
__device__ __forceinline__ float fast_log1p(float e) {
  const float s = e * fast_rcp(2.f + e);
  const float w = s * s;
  float p = 1.f / 15.f;
  p = fmaf(p, w, 1.f / 13.f);
  p = fmaf(p, w, 1.f / 11.f);
  p = fmaf(p, w, 1.f / 9.f);
  p = fmaf(p, w, 1.f / 7.f);
  p = fmaf(p, w, 1.f / 5.f);
  p = fmaf(p, w, 1.f / 3.f);
  p = fmaf(p, w, 1.f);
  return 2.f * s * p;
}

__device__ __forceinline__ float fast_log_sigmoid(float x) {
  return fminf(x, 0.f) - fast_log1p(fast_exp(-fabsf(x)));
}

// tanh z = 1 - 2 / (1 + e^{2z}), e^{2z} capped at 2^126
__device__ __forceinline__ float fast_tanh(float z) {
  return 1.f - 2.f * fast_rcp(1.f + ex2_approx(fminf(2.f * kLog2e * z,
                                                      126.f)));
}

// 1 / (1 + e^{-x}), e^{-x} capped at 2^126
__device__ __forceinline__ float fast_sigmoid(float x) {
  return fast_rcp(1.f + ex2_approx(fminf(-kLog2e * x, 126.f)));
}
