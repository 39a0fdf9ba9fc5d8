// layernorm_rows_bwd and colsum_rows: the LayerNorm backward and the
// cross-row sums (bias and LayerNorm-parameter gradients) of both TPU
// block backward kernels (myrtle_vision_tpu/ops/fused_attention_block.py
// `_bwd_one_image`, myrtle_vision_tpu/ops/fused_mlp.py `_bwd_one_image`).
//
// layernorm_rows_bwd, one warp per row, from x (bf16), the LayerNorm scale
// (bf16), dxn (fp32, the gradient at the LayerNorm output) and the block's
// upstream gradient do (bf16):
//   mu, rstd, xhat recomputed in fp32 as the forward does
//   dxhat = dxn * scale
//   dx    = bf16(do + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat*xhat)))
// and per block the column partial sums of dxn * xhat (dscale) and dxn
// (dbias) over its rows, (blocks, 2, cols) fp32, which colsum_rows adds.
// Memory bound: about 12 bytes moved per element.
//
// colsum_rows: fp32 column sums of a (rows, cols) bf16 or fp32 matrix, one
// thread per column.  Where the TPU kernels accumulate these sums across
// their sequential grid, blocks here run in parallel, so the sum takes two
// passes: chunks of kChunk rows into (ceil(rows / kChunk), cols) partials,
// then one pass over the partials.  Every sum runs in a fixed order, so
// results are bitwise reproducible.
#include "common.cuh"

namespace {

using mvt::bf16;

constexpr int kWarps = 8;
constexpr int kMaxCols = 768;  // ViT-B width
constexpr int kPer = kMaxCols / 32;  // columns per lane
constexpr int kChunk = 64;           // rows per colsum partial

__global__ void __launch_bounds__(kWarps * 32)
layernorm_rows_bwd_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ scale,
                          const float* __restrict__ dxn,
                          const bf16* __restrict__ d_out,
                          bf16* __restrict__ dx, float* __restrict__ part,
                          int rows, int cols, float eps) {
  extern __shared__ float wsum[];  // kWarps x 2 x cols
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float n = static_cast<float>(cols);
  float ds_acc[kPer], db_acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) ds_acc[i] = db_acc[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const size_t off = static_cast<size_t>(row) * cols;
    float xv[kPer], gv[kPer];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < cols ? __bfloat162float(x[off + c]) : 0.f;
      s += xv[i];
    }
    const float mu = mvt::warp_sum(s) / n;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      const float d = c < cols ? xv[i] - mu : 0.f;
      v += d * d;
    }
    const float rstd = rsqrtf(mvt::warp_sum(v) / n + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < cols) {
        xv[i] = (xv[i] - mu) * rstd;  // xhat
        const float g = dxn[off + c];
        ds_acc[i] += g * xv[i];
        db_acc[i] += g;
        gv[i] = g * __bfloat162float(scale[c]);  // dxhat
        m1 += gv[i];
        m2 += gv[i] * xv[i];
      }
    }
    m1 = mvt::warp_sum(m1) / n;
    m2 = mvt::warp_sum(m2) / n;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < cols)
        dx[off + c] = __float2bfloat16_rn(
            __bfloat162float(d_out[off + c]) +
            rstd * (gv[i] - m1 - xv[i] * m2));
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < cols) {
      wsum[(warp * 2) * cols + c] = ds_acc[i];
      wsum[(warp * 2 + 1) * cols + c] = db_acc[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * cols; c += blockDim.x) {
    const int which = c / cols, col = c % cols;
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += wsum[(w * 2 + which) * cols + col];
    part[static_cast<size_t>(blockIdx.x) * 2 * cols + c] = acc;
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

// out[blockIdx.y, c] = sum of in[r, c] over rows r of chunk blockIdx.y
template <typename T>
__global__ void __launch_bounds__(256)
colsum_kernel(const T* __restrict__ in, float* __restrict__ out, int rows,
              int cols, int chunk) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(rows, r0 + chunk);
  float acc = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r)
    acc += to_f32(in[static_cast<size_t>(r) * cols + c]);
  out[static_cast<size_t>(blockIdx.y) * cols + c] = acc;
}

// *launched: the kernels launched, one for at most kChunk rows, else two
template <typename T>
int colsum(const void* in, void* scratch, void* out, int rows, int cols,
           int* launched, cudaStream_t stream) {
  const dim3 block(256);
  const int col_blocks = (cols + 255) / 256;
  *launched = 0;
  if (rows <= kChunk) {
    colsum_kernel<T><<<dim3(col_blocks, 1), block, 0, stream>>>(
        static_cast<const T*>(in), static_cast<float*>(out), rows, cols,
        rows);
    *launched = 1;
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = (rows + kChunk - 1) / kChunk;
  colsum_kernel<T><<<dim3(col_blocks, chunks), block, 0, stream>>>(
      static_cast<const T*>(in), static_cast<float*>(scratch), rows, cols,
      kChunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<float><<<dim3(col_blocks, 1), block, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), chunks,
      cols, chunks);
  *launched = 2;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

MVT_EXPORT int mvt_colsum_chunk() { return kChunk; }

MVT_EXPORT int mvt_layernorm_rows_bwd_max_cols() { return kMaxCols; }

// part: (blocks, 2, cols) fp32, blocks as the caller chose them
MVT_EXPORT int mvt_layernorm_rows_bwd(const void* x, const void* scale,
                                      const void* dxn, const void* d_out,
                                      void* dx, void* part, int rows,
                                      int cols, int blocks, float eps,
                                      void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kMaxCols || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kWarps * 2 * cols;
  cudaError_t err = cudaFuncSetAttribute(
      layernorm_rows_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  layernorm_rows_bwd_kernel<<<blocks, kWarps * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const float*>(dxn), static_cast<const bf16*>(d_out),
      static_cast<bf16*>(dx), static_cast<float*>(part), rows, cols, eps);
  return static_cast<int>(cudaGetLastError());
}

// out (cols,) fp32 = column sums of in (rows, cols), bf16 (in_bf16 = 1) or
// fp32; scratch holds ceil(rows / mvt_colsum_chunk()) x cols fp32;
// *launched receives the number of kernels launched
MVT_EXPORT int mvt_colsum_rows(const void* in, int in_bf16, void* scratch,
                               void* out, int rows, int cols, int* launched,
                               void* stream) {
  *launched = 0;
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return colsum<bf16>(in, scratch, out, rows, cols, launched, s);
  return colsum<float>(in, scratch, out, rows, cols, launched, s);
}
