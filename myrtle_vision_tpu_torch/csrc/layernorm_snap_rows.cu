// layernorm_snap_rows: fp32 (rows, cols) -> fp32, the LayerNorm prologue of
// both TPU block kernels in a stateless float format (qspec = (exp_bits,
// man_bits, all_sites): FP16_16, FP16_32, TF32) and in PyTorchINT8's
// two-pass QAT (qspec "int8": the frozen observer sites).
//
// `_qkv_rows` of myrtle_vision_tpu/ops/fused_attention_block.py and `fc1`
// of myrtle_vision_tpu/ops/fused_mlp.py with qspec set, in their order:
//   xs  = snap(x)                                  norm act_in (pre_linear)
//   mu  = mean(xs), var = mean((xs - mu)^2), rstd = rsqrt(var + eps)
//   y   = (xs - mu) * rstd * scale + bias          fp32, no FMA contraction
//   out = site0(snap(snap_all(y)))   norm act_out (post_op), then the
//                                    projection's act_in (pre_linear); for
//                                    INT8 the norm's act_out observer
// snap, snap_all and site are fake_quant.cuh's policies (K11's code, or the
// INT8 site snap; each the identity under the other policy).
//
// Memory bound: 8 bytes moved per element (at ViT-S/16, B=256, 50,432 rows
// of 384: 155 MB, 0.0462 ms at 3.35 TB/s).  One warp a row, four rows a
// block.  Lane l holds the columns l, l + 32, ... of its row in registers
// (kValues = cols / 32 of them, a template argument, so that no column
// needs a bounds check): it issues every load of the row, and of scale and
// bias, before the row's first sum, 4 bytes a lane and so one 128-byte
// line a warp instruction; it snaps each value once, and the mean, the
// variance and the output all come from those registers, the output
// written once, each lane its own columns.  Each lane sums its columns in
// turn, then mvt::warp_sum, as the design before did, so the outputs are
// bit for bit that design's.  The design before read the row three times
// (for the mean, the variance and the output, each pass a loop of one
// value a lane waiting on the last pass's sum) and snapped x on every
// read: at ViT-S/16, B=256, FP16_32, on one "NVIDIA H100 80GB HBM3" at
// 700.00 W, 0.0953 ms of device time a call (0.48 of the bound) against
// 0.0532 now (0.87), the two measured in turns in one run of
// tools/perf/core_long_bench.py.
#include <type_traits>

#include "fake_quant.cuh"

namespace {

constexpr int kWarps = 4;      // a block's warps, one row each
constexpr int kMaxCols = 768;  // ViT-B width
constexpr int kMaxValues = kMaxCols / 32;

// the blocks an SM that a kernel of kValues values a lane is built for:
// 64 registers a thread up to 12 values, 128 above
template <int kValues>
constexpr int kBlocksPerSm = kValues <= 12 ? 8 : 4;

template <int kValues, class Snaps>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm<kValues>)
layernorm_snap_rows_kernel(const float* __restrict__ x,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int rows, float eps,
                           Snaps policy) {
  constexpr int cols = 32 * kValues;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const size_t at = static_cast<size_t>(row) * cols + lane;
  float v[kValues], sc[kValues], bi[kValues];
#pragma unroll
  for (int i = 0; i < kValues; ++i) v[i] = __ldg(x + at + 32 * i);
#pragma unroll
  for (int i = 0; i < kValues; ++i) {
    sc[i] = scale[lane + 32 * i];
    bi[i] = bias[lane + 32 * i];
  }
  const auto q = mvt::resolve(policy);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kValues; ++i) {
    v[i] = mvt::snap(v[i], q);
    acc = __fadd_rn(acc, v[i]);
  }
  const float mu = mvt::warp_sum(acc) / static_cast<float>(cols);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kValues; ++i) {
    v[i] = __fsub_rn(v[i], mu);
    ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
  }
  const float var = mvt::warp_sum(ss) / static_cast<float>(cols);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  float* orow = out + at;
#pragma unroll
  for (int i = 0; i < kValues; ++i) {
    const float y =
        __fadd_rn(__fmul_rn(__fmul_rn(v[i], rstd), sc[i]), bi[i]);
    orow[32 * i] = mvt::site(mvt::snap(mvt::snap_all(y, q), q), q, 0);
  }
}

// f(std::integral_constant<int, k>{}) for k = cols / 32, or an error for
// a width the kernels do not take
template <class F>
int with_values(int cols, F&& f) {
  if (cols <= 0 || cols > kMaxCols || cols % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (cols / 32) {
#define MVT_LN_SNAP(k) \
  case k:              \
    return f(std::integral_constant<int, k>{});
    MVT_LN_SNAP(1) MVT_LN_SNAP(2) MVT_LN_SNAP(3) MVT_LN_SNAP(4)
    MVT_LN_SNAP(5) MVT_LN_SNAP(6) MVT_LN_SNAP(7) MVT_LN_SNAP(8)
    MVT_LN_SNAP(9) MVT_LN_SNAP(10) MVT_LN_SNAP(11) MVT_LN_SNAP(12)
    MVT_LN_SNAP(13) MVT_LN_SNAP(14) MVT_LN_SNAP(15) MVT_LN_SNAP(16)
    MVT_LN_SNAP(17) MVT_LN_SNAP(18) MVT_LN_SNAP(19) MVT_LN_SNAP(20)
    MVT_LN_SNAP(21) MVT_LN_SNAP(22) MVT_LN_SNAP(23) MVT_LN_SNAP(24)
#undef MVT_LN_SNAP
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
static_assert(kMaxValues == 24, "with_values lists every width");

int grid(int rows) { return (rows + kWarps - 1) / kWarps; }

template <class Snaps>
int launch(const void* x, const void* scale, const void* bias, void* out,
           int rows, int cols, float eps, Snaps q, void* stream) {
  return with_values(cols, [&](auto values) {
    layernorm_snap_rows_kernel<decltype(values)::value, Snaps>
        <<<grid(rows), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(x), static_cast<const float*>(scale),
            static_cast<const float*>(bias), static_cast<float*>(out), rows,
            eps, q);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

MVT_EXPORT int mvt_layernorm_snap_rows_max_cols() { return kMaxCols; }

// x, out fp32 (rows, cols), cols a multiple of 32 up to kMaxCols; scale,
// bias fp32 (cols,); the policy: site, a (3,) fp32 row (scale, zero point,
// has_stats) of the INT8 site table on the device, or null for the float
// format qspec (exp_bits, man_bits, all_sites)
MVT_EXPORT int mvt_layernorm_snap_rows(const void* x, const void* scale,
                                       const void* bias, void* out, int rows,
                                       int cols, float eps, int exp_bits,
                                       int man_bits, int all_sites,
                                       const void* site, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (site != nullptr)
    return launch(x, scale, bias, out, rows, cols, eps,
                  mvt::Int8Sites{static_cast<const float*>(site), nullptr},
                  stream);
  if (!mvt::float_fmt_ok(exp_bits, man_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, scale, bias, out, rows, cols, eps,
                mvt::QSpec(exp_bits, man_bits, all_sites), stream);
}

// the launch of a (rows, cols) call, in the order of the wrapper's plan
// (layernorm_snap_plan in ops/_kernels.py): values a lane, a block's warps,
// the grid, the blocks an SM the kernel is built for, and the runtime's
// occupancy of the float-format and the INT8 instantiation
MVT_EXPORT int mvt_layernorm_snap_rows_plan(int rows, int cols,
                                            int* figures) {
  return with_values(cols, [&](auto values) {
    constexpr int kValues = decltype(values)::value;
    figures[0] = kValues;
    figures[1] = kWarps;
    figures[2] = grid(rows);
    figures[3] = kBlocksPerSm<kValues>;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &figures[4], layernorm_snap_rows_kernel<kValues, mvt::QSpec>,
        kWarps * 32, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &figures[5], layernorm_snap_rows_kernel<kValues, mvt::Int8Sites>,
          kWarps * 32, 0);
    return static_cast<int>(e);
  });
}
