// layernorm_snap_rows: fp32 (rows, cols) -> fp32, the LayerNorm prologue of
// both TPU block kernels in a stateless float format (qspec = (exp_bits,
// man_bits, all_sites): FP16_16, FP16_32, TF32).
//
// `_qkv_rows` of myrtle_vision_tpu/ops/fused_attention_block.py and `fc1`
// of myrtle_vision_tpu/ops/fused_mlp.py with qspec set, in their order:
//   xs  = snap(x)                                  norm act_in (pre_linear)
//   mu  = mean(xs), var = mean((xs - mu)^2), rstd = rsqrt(var + eps)
//   y   = (xs - mu) * rstd * scale + bias          fp32, no FMA contraction
//   out = snap(snap_all(y))          norm act_out (post_op), then the
//                                    projection's act_in (pre_linear)
// snap and snap_all are fake_quant.cuh's, the code of K11.  One warp per
// row; the row is read three times, from L1 after the first pass, and
// snapped on each read.  Memory bound: 8 bytes moved per element.
#include "fake_quant.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
layernorm_snap_rows_kernel(const float* __restrict__ x,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int rows, int cols,
                           float eps, mvt::QSpec q) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const float* xr = x + static_cast<size_t>(row) * cols;
  float acc = 0.f;
  for (int c = lane; c < cols; c += 32)
    acc = __fadd_rn(acc, mvt::snap(xr[c], q));
  const float mu = mvt::warp_sum(acc) / static_cast<float>(cols);
  float v = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = __fsub_rn(mvt::snap(xr[c], q), mu);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  const float var = mvt::warp_sum(v) / static_cast<float>(cols);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  float* orow = out + static_cast<size_t>(row) * cols;
  for (int c = lane; c < cols; c += 32) {
    const float xhat = __fmul_rn(__fsub_rn(mvt::snap(xr[c], q), mu), rstd);
    const float y = __fadd_rn(__fmul_rn(xhat, scale[c]), bias[c]);
    orow[c] = mvt::snap(mvt::snap_all(y, q), q);
  }
}

}  // namespace

// x, out fp32 (rows, cols); scale, bias fp32 (cols,); qspec (exp_bits,
// man_bits, all_sites)
MVT_EXPORT int mvt_layernorm_snap_rows(const void* x, const void* scale,
                                       const void* bias, void* out, int rows,
                                       int cols, float eps, int exp_bits,
                                       int man_bits, int all_sites,
                                       void* stream) {
  if (rows <= 0 || cols <= 0 || !mvt::float_fmt_ok(exp_bits, man_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  layernorm_snap_rows_kernel<<<blocks, kWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), rows, cols,
      eps, mvt::QSpec(exp_bits, man_bits, all_sites));
  return static_cast<int>(cudaGetLastError());
}
