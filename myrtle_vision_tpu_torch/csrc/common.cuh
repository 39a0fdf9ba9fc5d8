// Shared helpers of the port's CUDA kernels (built for sm_90a, bound with
// ctypes: every entry point has a plain C interface and returns
// cudaGetLastError() after its launch).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MVT_EXPORT extern "C" __attribute__((visibility("default")))

namespace mvt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// erf(h / sqrt 2) by Abramowitz & Stegun 7.1.26 with exact divides
// (`_erf_f32` of myrtle_vision_tpu/ops/fused_mlp.py with `_exact_div`), in
// the operation order of the plain version (ops/_kernels.py erf_poly), every
// product and sum rounded on its own
__device__ __forceinline__ float erf_poly_scaled(float h) {
  const float a = h / 1.4142135623730951f;
  const float ax = fabsf(a);
  const float t = 1.0f / __fadd_rn(1.0f, __fmul_rn(0.3275911f, ax));
  float p = __fmul_rn(t, 1.061405429f);
  p = __fmul_rn(t, __fadd_rn(-1.453152027f, p));
  p = __fmul_rn(t, __fadd_rn(1.421413741f, p));
  p = __fmul_rn(t, __fadd_rn(-0.284496736f, p));
  p = __fmul_rn(t, __fadd_rn(0.254829592f, p));
  const float sg = (a > 0.f) ? 1.f : ((a < 0.f) ? -1.f : 0.f);
  return __fmul_rn(sg,
                   __fsub_rn(1.0f, __fmul_rn(p, expf(__fmul_rn(-ax, ax)))));
}

// GELU(h) = 0.5 h (1 + erf(h / sqrt 2)) (`gelu_erf_poly`)
__device__ __forceinline__ float gelu_poly(float h) {
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, erf_poly_scaled(h)));
}

// (GELU(h), GELU'(h)) from one erf, `_gelu_and_grad_f32` with exact divides:
// cdf = 0.5 (1 + erf(h / sqrt 2)), pdf = exp(-h^2 / 2) / sqrt(2 pi),
// GELU = h cdf, GELU' = cdf + h pdf (ops/_kernels.py gelu_and_grad_poly)
__device__ __forceinline__ float gelu_and_grad_poly(float h, float* grad) {
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, erf_poly_scaled(h)));
  const float pdf =
      __fmul_rn(expf(__fmul_rn(-0.5f, __fmul_rn(h, h))), 0.3989422804014327f);
  *grad = __fadd_rn(cdf, __fmul_rn(h, pdf));
  return __fmul_rn(h, cdf);
}

}  // namespace mvt
