// layernorm_quant_rows: fp32 (rows, cols) -> int8 q - 128, the uint8 grid
// of one PyTorchINT8 observer site of LayerNorm(x) * scale + bias.
//
// The prologue of both converted-INT8 TPU block kernels
// (myrtle_vision_tpu/ops/fused_int8_block.py `_attn_kernel` and
// `_mlp_kernel`: `_layernorm_f32`, then `_quantize_i8` at site 0):
//   mu = mean(x), var = mean((x - mu)^2), rstd = rsqrt(var + eps)
//   y  = (x - mu) * rstd * scale + bias                       fp32
//   q  = clip(rint(y / s) + zp, 0, 255) - 128                 int8
// with the site's (s, zp) read from its (scale, zero point, has_stats)
// row, and s = 1, zp = 128 when the site has no statistics (the guard of
// `_quantize_i8`).  Every product and sum rounds on its own (no FMA
// contraction) and the divide is IEEE, so the result differs from the
// plain version only where the fp32 sums of mu and var are ordered
// differently.  One warp per row; the row is read three times, from L1
// after the first pass.  Memory bound: 5 bytes moved per element.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
layernorm_quant_rows_kernel(const float* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            const float* __restrict__ site,
                            signed char* __restrict__ out, int rows,
                            int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const bool has = site[2] > 0.5f;
  const float s = has ? site[0] : 1.0f;
  const float zp = has ? site[1] : 128.0f;
  const float* xr = x + static_cast<size_t>(row) * cols;
  float acc = 0.f;
  for (int c = lane; c < cols; c += 32) acc = __fadd_rn(acc, xr[c]);
  const float mu = mvt::warp_sum(acc) / static_cast<float>(cols);
  float v = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = __fsub_rn(xr[c], mu);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  const float var = mvt::warp_sum(v) / static_cast<float>(cols);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  signed char* orow = out + static_cast<size_t>(row) * cols;
  for (int c = lane; c < cols; c += 32) {
    const float xhat = __fmul_rn(__fsub_rn(xr[c], mu), rstd);
    const float y = __fadd_rn(__fmul_rn(xhat, scale[c]), bias[c]);
    const float q = fminf(fmaxf(__fadd_rn(rintf(y / s), zp), 0.f), 255.f);
    orow[c] = static_cast<signed char>(static_cast<int>(q) - 128);
  }
}

}  // namespace

// site: (scale, zero point, has_stats) fp32
MVT_EXPORT int mvt_layernorm_quant_rows(const void* x, const void* scale,
                                        const void* bias, const void* site,
                                        void* out, int rows, int cols,
                                        float eps, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  layernorm_quant_rows_kernel<<<blocks, kWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(site),
      static_cast<signed char*>(out), rows, cols, eps);
  return static_cast<int>(cudaGetLastError());
}
