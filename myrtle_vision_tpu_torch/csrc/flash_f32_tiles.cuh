// What the fp32 flash kernels share (flash_attention_f32_fwd.cu,
// flash_attention_f32_bwd.cu): 64-row tiles of fp32 (B, H, N, D) rows in
// shared memory, and a 64 x W product of two such tiles on the CUDA cores.
//
// Every product is true fp32: SIMT FFMA, one rounding per multiply-add, the
// terms summed in order of the contracted index.  So the kernels differ from
// their plain versions (ops/flash_attention.py, fp32 matmuls) only in the
// order of fp32 sums, about 2^-23 of the sum of the terms' magnitudes each,
// where a 3-pass bf16 split of each operand would lose about 2^-16 of every
// product.
//
// A CTA is 256 threads as a 16 x 16 grid: thread (ty, tx) = (tid / 16,
// tid % 16) owns rows 4 ty .. 4 ty + 3 and columns tx W/16 .. of a 64 x W
// output, so the 16 threads of one row of the grid are one half of a warp
// and reduce a row with four shuffles.  A product C += A^T B reads both
// operands from shared memory with the contracted index major: a[k][m] (m
// the output's row) and b[k][n], one float4 of a and W/16 floats of b a
// step, 4 W/16 FFMA for them.
#pragma once

#include "common.cuh"

namespace mvt {
namespace f32flash {

constexpr int kRows = 64;       // a CTA's own rows, and a walked tile's
constexpr int kThreads = 256;   // the 16 x 16 thread grid
constexpr int kLd = kRows + 4;  // row stride (floats) of a d-major tile
constexpr float kNeg = -1e30f;  // a masked key's score (the JAX kernels')

// a (B, H, N, D) fp32 view: element (b, h, i, d) at
// p + b sb + h sh + i sn + d, rows 16-byte aligned
struct View {
  const float* p;
  long long sb;
  int sh, sn;
  __device__ __forceinline__ const float* row(int b, int h, int i) const {
    return p + b * sb + static_cast<long long>(h) * sh +
           static_cast<long long>(i) * sn;
  }
};

// rows i0 .. i0 + 63 of (b, h) into shared memory, zeros past n: row-major
// (dst[r][d], stride D) or, with `dmajor`, transposed (dst[d][r], stride
// kLd); 16-byte loads, consecutive threads along a row
template <int D>
__device__ __forceinline__ void load_tile(float* dst, bool dmajor,
                                          const View& v, int b, int h, int i0,
                                          int n) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < kRows * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i0 + r < n)
      x = *reinterpret_cast<const float4*>(v.row(b, h, i0 + r) + c);
    if (dmajor) {
      dst[(c + 0) * kLd + r] = x.x;
      dst[(c + 1) * kLd + r] = x.y;
      dst[(c + 2) * kLd + r] = x.z;
      dst[(c + 3) * kLd + r] = x.w;
    } else {
      *reinterpret_cast<float4*>(dst + r * D + c) = x;
    }
  }
}

// one fp32 value a row of a (B, H, N) tensor into dst[0 .. 63], zeros past n
__device__ __forceinline__ void load_stat(float* dst, const float* src,
                                          int bh, int n, int i0) {
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    dst[r] = i0 + r < n ? src[static_cast<long long>(bh) * n + i0 + r] : 0.f;
}

// acc[i][j] += sum_k a[k][4 ty + i] b[k][tx W + j] over k < kdim, W = 4 or 2
template <int W>
__device__ __forceinline__ void mma_tile(const float* __restrict__ a, int lda,
                                         const float* __restrict__ b, int ldb,
                                         int kdim, float (&acc)[4][W], int ty,
                                         int tx) {
  static_assert(W == 4 || W == 2, "a thread's columns: 4 or 2");
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda + ty * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    float br[W];
    if constexpr (W == 4) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b + k * ldb + tx * 4);
      br[0] = bv.x;
      br[1] = bv.y;
      br[2] = bv.z;
      br[3] = bv.w;
    } else {
      const float2 bv =
          *reinterpret_cast<const float2*>(b + k * ldb + tx * 2);
      br[0] = bv.x;
      br[1] = bv.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// a thread's 4 x 4 block of a 64 x 64 tile, stored transposed: dst[c][r]
// for its rows r = 4 ty + i and columns c = 4 tx + j (stride kLd)
__device__ __forceinline__ void store_transposed(float* dst,
                                                 const float (&t)[4][4],
                                                 int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (tx * 4 + j) * kLd + ty * 4) =
        make_float4(t[0][j], t[1][j], t[2][j], t[3][j]);
}

// max and sum over the 16 threads of a row of the thread grid
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a thread's rows 4 ty + i, columns tx W + j of a 64 x D tile into the
// (B, N, H, D) output rows i0 + r < n of (b, h)
template <int W, int D>
__device__ __forceinline__ void store_rows(float* out, const float (&t)[4][W],
                                           int b, int h, int heads, int n,
                                           int i0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
    if (r >= n) continue;
    float* dst = out + ((static_cast<long long>(b) * n + r) * heads + h) * D +
                 tx * W;
#pragma unroll
    for (int j = 0; j < W; ++j) dst[j] = t[i][j];
  }
}

// dynamic shared memory above 48 KB, asked for once a kernel
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

}  // namespace f32flash
}  // namespace mvt
