// layernorm_rows_bwd and colsum_rows: the LayerNorm backward and the
// cross-row sums (bias and LayerNorm-parameter gradients) of both TPU
// block backward kernels (myrtle_vision_tpu/ops/fused_attention_block.py
// `_bwd_one_image`, myrtle_vision_tpu/ops/fused_mlp.py `_bwd_one_image`),
// also with qspec set (a stateless float format).
//
// layernorm_rows_bwd, one warp per row, from x (bf16), the LayerNorm scale
// (bf16), dxn (fp32, the gradient at the LayerNorm output) and the block's
// upstream gradient do (bf16):
//   mu, rstd, xhat recomputed in fp32 as the forward does
//   dxhat = dxn * scale
//   dx    = bf16(do * res_scale
//                + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat*xhat)))
// (res_scale 1/n_tp under head-sharded tensor parallelism, the TPU
// kernels' `do * res_scale + dx_ln`, else 1, whose product is exact)
// and per block the column partial sums of dxn * xhat (dscale) and dxn
// (dbias) over its rows, (blocks, 2, cols) fp32, which colsum_rows adds.
// Memory bound: about 12 bytes moved per element.  Its float-format form,
// layernorm_snap_rows_bwd, takes fp32 x, scale and do, gives fp32 dx, and
// recomputes xhat and rstd from snap(x) (the norm's act_in site, whose
// gradient is straight-through; fake_quant.cuh), about 16 bytes moved per
// element (at ViT-S/16, 50,432 rows of 384, 310 MB: 0.093 ms at 3.35
// TB/s); in INT8 QAT (qspec "int8", whose `snap` is the identity) from x.
// Each lane takes chunks of four columns, so every load is 16 bytes of
// fp32 (8 of bf16), and issues all of a row's loads (x, dxn, d_out)
// before the row's first sum.  The design before loaded one value a lane
// and waited on x's sums before it read dxn and d_out, three round trips
// to memory a row: 0.3717 ms for the snap form at ViT-S/16 on one H100 at
// 700 W, 4x the bytes' bound, against 0.1144 ms now.
//
// colsum_rows: fp32 column sums of a (rows, cols) bf16 or fp32 matrix, in a
// fixed order, so results are bitwise reproducible.  Where the TPU kernels
// accumulate these sums across their sequential grid, blocks here run in
// parallel, so a tall matrix takes two passes: pass 1 sums chunks of
// `chunk` rows into (ceil(rows / chunk), cols) partials, pass 2 adds the
// partials up; up to one chunk, pass 1 writes the sums directly.  The
// wrapper picks the chunk (`colsum_plan` in ops/_kernels.py) from the
// rows, the columns and the SM count, so that pass 1 fills the card.  A
// pass-1 block of 256 threads takes 128 columns: each thread loads 16
// bytes of a row (8 bf16 or 4 fp32 columns; one column where the width
// does not allow it), four rows in flight, and walks every 16th (bf16)
// or 8th (fp32) row of the chunk, and the row groups' sums meet in
// shared memory in order.  A pass-2 block takes 32 columns: its 8 warps
// split each column's partials, then meet the same way.  Memory bound:
// at ViT-S/16 (50,432 x 384 bf16, the bias gradients dbp and db2) 39 MB,
// 0.0116 ms at 3.35 TB/s.  The design before ran one thread per column with 2-byte loads,
// and its pass 2 had 2 blocks in which each thread added 788 partials.
#include <cmath>
#include <cstdint>

#include "fake_quant.cuh"

namespace {

using mvt::bf16;

constexpr int kWarps = 8;
constexpr int kMaxCols = 768;  // ViT-B width

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

// four consecutive values of a row as fp32: 16 bytes of fp32, 8 of bf16
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<bf16>(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void to_array(float4 v, float (&a)[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// One warp a row; lane l takes the kChunks chunks of four columns 4 (l +
// 32 i) ... + 3 (cols a multiple of 4; chunks at or past cols idle), so
// every load is 16 bytes of fp32 or 8 of bf16 and a row's x, dxn and
// d_out are all in flight before its first sum.  kSnap: x through the
// format's snap first (fp32 in and out).
template <typename T, bool kSnap, int kChunks>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_rows_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                          const float* __restrict__ dxn,
                          const T* __restrict__ d_out, T* __restrict__ dx,
                          float* __restrict__ part, int rows, int cols,
                          float eps, mvt::QSpec q, float res_scale) {
  extern __shared__ float wsum[];  // kWarps x 2 x cols
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float n = static_cast<float>(cols);
  bool ok[kChunks];
  float sc[kChunks][4], ds_acc[kChunks][4], db_acc[kChunks][4];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = 4 * (lane + 32 * i);
    ok[i] = c < cols;
    to_array(ok[i] ? load4(scale + c) : make_float4(0.f, 0.f, 0.f, 0.f),
             sc[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) ds_acc[i][e] = db_acc[i][e] = 0.f;
  }

  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const size_t off = static_cast<size_t>(row) * cols;
    float xv[kChunks][4], gv[kChunks][4], dv[kChunks][4];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = 4 * (lane + 32 * i);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      to_array(ok[i] ? load4(x + off + c) : z, xv[i]);
      to_array(ok[i] ? load4(dxn + off + c) : z, gv[i]);
      to_array(ok[i] ? load4(d_out + off + c) : z, dv[i]);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kSnap) xv[i][e] = mvt::snap(xv[i][e], q);
        s += xv[i][e];
      }
    const float mu = mvt::warp_sum(s) / n;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = ok[i] ? xv[i][e] - mu : 0.f;
        v += d * d;
      }
    const float rstd = rsqrtf(mvt::warp_sum(v) / n + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // zero in idle chunks: dxn is zero there
        const float xh = (xv[i][e] - mu) * rstd;
        const float g = gv[i][e];
        xv[i][e] = xh;
        ds_acc[i][e] += g * xh;
        db_acc[i][e] += g;
        gv[i][e] = g * sc[i][e];  // dxhat
        m1 += gv[i][e];
        m2 += gv[i][e] * xh;
      }
    m1 = mvt::warp_sum(m1) / n;
    m2 = mvt::warp_sum(m2) / n;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      if (!ok[i]) continue;
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // __fmul_rn: the scaled gradient is rounded on its own, as the
        // plain version rounds it, and then enters the sum as do did
        const float dr = __fmul_rn(dv[i][e], res_scale);
        o[e] = dr + rstd * (gv[i][e] - m1 - xv[i][e] * m2);
      }
      store4(dx + off + 4 * (lane + 32 * i),
             make_float4(o[0], o[1], o[2], o[3]));
    }
  }
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (!ok[i]) continue;
    const int c = 4 * (lane + 32 * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wsum[(warp * 2) * cols + c + e] = ds_acc[i][e];
      wsum[(warp * 2 + 1) * cols + c + e] = db_acc[i][e];
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

// kVec values of a row from p: 16 bytes (8 bf16 or 4 fp32), or one value
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    v[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// out[blockIdx.y, c] = sum of in[r, c] over the rows r of chunk blockIdx.y,
// for the kCols columns of block blockIdx.x.  kVec columns a thread (16
// bytes, or 1 column for the scalar path), kCols / kVec threads across a
// row, the block's 256 / (kCols / kVec) row groups each taking every
// such row in order (the loads of kBatch rows in flight together), then
// added group by group.
template <typename T, int kVec, int kCols>
__global__ void __launch_bounds__(256)
colsum_kernel(const T* __restrict__ in, float* __restrict__ out, int rows,
              int cols, int chunk) {
  constexpr int kAcross = kCols / kVec;
  constexpr int kGroups = 256 / kAcross;
  constexpr int kBatch = 4;
  __shared__ float part[kGroups][kCols];
  const int across = threadIdx.x % kAcross, group = threadIdx.x / kAcross;
  const int c0 = blockIdx.x * kCols + across * kVec;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(rows, r0 + chunk);
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  if (c0 < cols) {
    const size_t step = static_cast<size_t>(kGroups) * cols;
    const T* p = in + static_cast<size_t>(r0 + group) * cols + c0;
    int r = r0 + group;
    for (; r + (kBatch - 1) * kGroups < r1; r += kBatch * kGroups) {
      float v[kBatch][kVec];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) load_vec<T, kVec>(p + b * step, v[b]);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] += v[b][i];
      p += kBatch * step;
    }
    for (; r < r1; r += kGroups, p += step) {
      float v[kVec];
      load_vec<T, kVec>(p, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += v[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) part[group][across * kVec + i] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < kCols; c += 256) {
    const int col = blockIdx.x * kCols + c;
    if (col >= cols) continue;
    float v = 0.f;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) v += part[gi][c];
    out[static_cast<size_t>(blockIdx.y) * cols + col] = v;
  }
}

constexpr int kPass1Cols = 128;  // columns of a pass-1 block
constexpr int kPass2Cols = 32;   // of a pass-2 block: 8 warps of 32

// pass 1: chunks of `chunk` rows of `in` into `dst`, 16-byte loads where
// the width and the base allow them
template <typename T>
int colsum_pass1(const void* in, float* dst, int rows, int cols, int chunk,
                 cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const dim3 grid((cols + kPass1Cols - 1) / kPass1Cols,
                  (rows + chunk - 1) / chunk);
  const T* src = static_cast<const T*>(in);
  if (cols % kV == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0)
    colsum_kernel<T, kV, kPass1Cols><<<grid, 256, 0, stream>>>(
        src, dst, rows, cols, chunk);
  else
    colsum_kernel<T, 1, kPass1Cols><<<grid, 256, 0, stream>>>(
        src, dst, rows, cols, chunk);
  return static_cast<int>(cudaGetLastError());
}

// pass 2: the (chunks, cols) partials into out (cols,)
int colsum_pass2(const float* part, float* out, int chunks, int cols,
                 cudaStream_t stream) {
  colsum_kernel<float, 1, kPass2Cols>
      <<<dim3((cols + kPass2Cols - 1) / kPass2Cols, 1), 256, 0, stream>>>(
          part, out, chunks, cols, chunks);
  return static_cast<int>(cudaGetLastError());
}

// *launched: the kernels launched, one for a single chunk, else two
template <typename T>
int colsum(const void* in, void* scratch, void* out, int rows, int cols,
           int chunk, int* launched, cudaStream_t stream) {
  const int chunks = (rows + chunk - 1) / chunk;
  float* part = static_cast<float*>(chunks == 1 ? out : scratch);
  int err = colsum_pass1<T>(in, part, rows, cols, chunk, stream);
  if (err != 0) return err;
  ++*launched;
  if (chunks == 1) return 0;
  err = colsum_pass2(part, static_cast<float*>(out), chunks, cols, stream);
  if (err != 0) return err;
  ++*launched;
  return 0;
}

}  // namespace

MVT_EXPORT int mvt_layernorm_rows_bwd_max_cols() { return kMaxCols; }

namespace {

template <typename T, bool kSnap, int kChunks>
int launch_chunks(const void* x, const void* scale, const void* dxn,
                  const void* d_out, void* dx, void* part, int rows, int cols,
                  int blocks, float eps, mvt::QSpec q, float res_scale,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * 2 * cols;
  cudaError_t err = cudaFuncSetAttribute(
      layernorm_rows_bwd_kernel<T, kSnap, kChunks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  layernorm_rows_bwd_kernel<T, kSnap, kChunks><<<blocks, kWarps * 32, smem,
                                                 stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const float*>(dxn), static_cast<const T*>(d_out),
      static_cast<T*>(dx), static_cast<float*>(part), rows, cols, eps, q,
      res_scale);
  return static_cast<int>(cudaGetLastError());
}

// cols a multiple of 4, at most kMaxCols: ceil(cols / 128) chunks a lane
template <typename T, bool kSnap>
int launch_ln_bwd(const void* x, const void* scale, const void* dxn,
                  const void* d_out, void* dx, void* part, int rows, int cols,
                  int blocks, float eps, mvt::QSpec q, float res_scale,
                  void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kMaxCols || cols % 4 != 0 ||
      blocks <= 0 || !std::isfinite(res_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((cols + 127) / 128) {
#define MVT_LN_BWD(k)                                                    \
  case k:                                                                \
    return launch_chunks<T, kSnap, k>(x, scale, dxn, d_out, dx, part,   \
                                      rows, cols, blocks, eps, q,       \
                                      res_scale, s);
    MVT_LN_BWD(1)
    MVT_LN_BWD(2)
    MVT_LN_BWD(3)
    MVT_LN_BWD(4)
    MVT_LN_BWD(5)
    MVT_LN_BWD(6)
#undef MVT_LN_BWD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// part: (blocks, 2, cols) fp32, blocks as the caller chose them;
// res_scale (finite) scales d_out in dx
MVT_EXPORT int mvt_layernorm_rows_bwd(const void* x, const void* scale,
                                      const void* dxn, const void* d_out,
                                      void* dx, void* part, int rows,
                                      int cols, int blocks, float eps,
                                      float res_scale, void* stream) {
  return launch_ln_bwd<bf16, false>(x, scale, dxn, d_out, dx, part, rows,
                                    cols, blocks, eps, mvt::QSpec(8, 10, 0),
                                    res_scale, stream);
}

// the float-format form: x, dxn, d_out, dx fp32 (rows, cols); scale fp32
// (cols,); qspec (exp_bits, man_bits, all_sites); int8 1 for PyTorchINT8's
// sites, whose `snap` is the identity (x unsnapped, the qspec not read)
MVT_EXPORT int mvt_layernorm_snap_rows_bwd(const void* x, const void* scale,
                                           const void* dxn, const void* d_out,
                                           void* dx, void* part, int rows,
                                           int cols, int blocks, float eps,
                                           int exp_bits, int man_bits,
                                           int all_sites, int int8,
                                           float res_scale, void* stream) {
  if (int8)
    return launch_ln_bwd<float, false>(x, scale, dxn, d_out, dx, part, rows,
                                       cols, blocks, eps, mvt::QSpec(8, 10, 0),
                                       res_scale, stream);
  if (!mvt::float_fmt_ok(exp_bits, man_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_ln_bwd<float, true>(x, scale, dxn, d_out, dx, part, rows,
                                    cols, blocks, eps,
                                    mvt::QSpec(exp_bits, man_bits, all_sites),
                                    res_scale, stream);
}

// out (cols,) fp32 = column sums of in (rows, cols), bf16 (in_bf16 = 1) or
// fp32, in chunks of `chunk` rows; scratch holds ceil(rows / chunk) x cols
// fp32 when that is more than one; *launched receives the number of
// kernels launched
MVT_EXPORT int mvt_colsum_rows(const void* in, int in_bf16, void* scratch,
                               void* out, int rows, int cols, int chunk,
                               int* launched, void* stream) {
  *launched = 0;
  if (rows <= 0 || cols <= 0 || chunk <= 0 ||
      (chunk < rows && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return colsum<bf16>(in, scratch, out, rows, cols, chunk, launched, s);
  return colsum<float>(in, scratch, out, rows, cols, chunk, launched, s);
}
