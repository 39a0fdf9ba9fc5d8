// gemm_s8_epilogue: the int8 projections of the converted-INT8 model.
//
//   acc[M, N] = A[M, K] @ W[K, N]     int8 x int8 -> int32, exact
//   v = (s_x * s_w) * (acc + (128 - zp_x) * colsum[N]) + bias[N]
//
// A holds q - 128 for the input's uint8 grid q (site `a_site`: scale s_x,
// zero point zp_x, 1 and 128 without statistics), W the int8 weight with
// its per-tensor scale s_w, colsum the weight's column sums: the
// shifted-zero-point identity of the TPU kernels' `_i8_dot`
// (myrtle_vision_tpu/ops/fused_int8_block.py; QDense._int8_forward in
// myrtle_vision_tpu/models/vit.py).  Then one of three epilogues:
//   0  requant(v, site), fp32 out              (qkv, patch embedding, head)
//   1  the int8 grid of site2 of GELU(requant(v, site))           (fc1)
//   2  requant(requant(v, site) + residual, site2), fp32 out   (out, fc2)
// requant is the site's uint8 affine fake-quant (clip(rint(v/s) + zp, 0,
// 255) - zp) * s, or v itself without statistics; GELU the Abramowitz &
// Stegun erf with an exact divide.  Each product and sum rounds on its
// own, in the plain version's order, and the divides are IEEE, so kernel
// and plain version agree but where the plain GELU's fp32 operations are
// reordered by PyTorch.
//
// W is read in place as the (in, out) view of the torch (out, in) weight,
// i.e. column-major: both operands run along K in memory.  Int8 products
// go to the tensor cores (WMMA 16x16x16, signed char in, int32 out).  At
// ViT-S/16 shapes (K, N in {384, 768, 1152, 1536}) the products are
// compute bound.  Each block of eight warps owns a 128x128 output tile
// (each warp 64x32) and walks K in 64-deep steps through a three-stage
// cp.async ring; a stage keeps each 16-deep slice of the tile as its own
// contiguous panel, so that every fragment starts on a 32-byte boundary.
// Ragged M and N are zero-filled on load and masked on store; K must be a
// multiple of 16.  wgmma and TMA are not used yet.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using s8 = signed char;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kPanels = BK / 16;  // 16-deep slices of a stage
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kATile = kPanels * BM * 16;  // bytes: [panel][row][16]
constexpr int kBTile = kPanels * BN * 16;
constexpr int kStageBytes = kATile + kBTile;
constexpr int E_LD = 16 + 4;  // per-warp int32 staging of one fragment
constexpr size_t kSmemBytes =
    static_cast<size_t>(kStages) * kStageBytes + sizeof(int) * kWarps * 16 * E_LD;

enum Epilogue { kRequant = 0, kRequantGeluQuant = 1, kRequantResidual = 2 };

struct Site {
  float s, zp;
  bool has;
};

__device__ __forceinline__ Site load_site(const float* p) {
  return Site{p[0], p[1], p[2] > 0.5f};
}

// the integer products' guard: scale 1 and zero point 128 without stats
__device__ __forceinline__ Site guarded(Site t) {
  return t.has ? t : Site{1.0f, 128.0f, false};
}

__device__ __forceinline__ float grid_q(float v, float s, float zp) {
  return fminf(fmaxf(__fadd_rn(rintf(v / s), zp), 0.f), 255.f);
}

__device__ __forceinline__ float requant(float v, Site t) {
  if (!t.has) return v;
  return __fmul_rn(__fsub_rn(grid_q(v, t.s, t.zp), t.zp), t.s);
}

// 16-byte asynchronous copy; when !ok nothing is read and zeros are written
__device__ __forceinline__ void cp_async16(s8* dst, const s8* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// one BK-deep step of both tiles; A (M, K) and W^T (N, K) both run along K
__device__ __forceinline__ void load_stage(s8* stage, const s8* A,
                                           const s8* Wt, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
  s8* As = stage;
  s8* Bs = stage + kATile;
  for (int c = tid; c < BM * kPanels; c += kThreads) {
    const int r = c / kPanels, p = c % kPanels;
    const int gr = m0 + r, gk = k0 + 16 * p;
    const bool ok = gr < M && gk < K;
    cp_async16(&As[(p * BM + r) * 16],
               ok ? A + static_cast<size_t>(gr) * K + gk : A, ok);
  }
  for (int c = tid; c < BN * kPanels; c += kThreads) {
    const int r = c / kPanels, p = c % kPanels;
    const int gn = n0 + r, gk = k0 + 16 * p;
    const bool ok = gn < N && gk < K;
    cp_async16(&Bs[(p * BN + r) * 16],
               ok ? Wt + static_cast<size_t>(gn) * K + gk : Wt, ok);
  }
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads)
gemm_s8_kernel(const s8* __restrict__ A, const s8* __restrict__ Wt,
               const float* __restrict__ colsum,
               const float* __restrict__ w_scale,
               const float* __restrict__ a_site,
               const float* __restrict__ bias,
               const float* __restrict__ site,
               const float* __restrict__ site2,
               const float* __restrict__ residual, void* __restrict__ out,
               int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  s8* stages = reinterpret_cast<s8*>(smem);
  int* Es = reinterpret_cast<int*>(smem + kStages * kStageBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64;  // 2 warps down M
  const int wn = (warp & 3) * 32;   // 4 warps across N

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int k_tiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles)
      load_stage(stages + s * kStageBytes, A, Wt, M, N, K, m0, n0, s * BK,
                 tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    // step kt has landed, and every warp is done with step kt - 1, whose
    // stage the prefetch below overwrites
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles)
      load_stage(stages + (next % kStages) * kStageBytes, A, Wt, M, N, K, m0,
                 n0, next * BK, tid);
    cp_async_commit();

    const s8* As = stages + (kt % kStages) * kStageBytes;
    const s8* Bs = As + kATile;
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, s8, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, s8, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[(p * BM + wm + 16 * i) * 16], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[(p * BN + wn + 16 * j) * 16], 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  const Site in = guarded(load_site(a_site));
  const Site t1 = load_site(site);
  const Site t2 = kEpi == kRequant ? t1 : load_site(site2);
  const Site t2g = guarded(t2);
  const float sxw = __fmul_rn(in.s, w_scale[0]);
  const float shift = __fsub_rn(128.0f, in.zp);

  // epilogue, one 16x16 fragment at a time through the warp's staging area;
  // lane handles column (lane & 15) of rows 2t + (lane >> 4)
  int* e_w = Es + warp * 16 * E_LD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(e_w, acc[i][j], E_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int gr = m0 + wm + 16 * i + r;
        const int gc = n0 + wn + 16 * j + c;
        if (gr < M && gc < N) {
          const size_t o = static_cast<size_t>(gr) * N + gc;
          const float a = __int2float_rn(e_w[r * E_LD + c]);
          float v = __fmul_rn(sxw, __fadd_rn(a, __fmul_rn(shift, colsum[gc])));
          v = requant(__fadd_rn(v, bias[gc]), t1);
          if (kEpi == kRequant) {
            static_cast<float*>(out)[o] = v;
          } else if (kEpi == kRequantGeluQuant) {
            const float q = grid_q(mvt::gelu_poly(v), t2g.s, t2g.zp);
            static_cast<s8*>(out)[o] = static_cast<s8>(static_cast<int>(q) - 128);
          } else {
            static_cast<float*>(out)[o] = requant(__fadd_rn(v, residual[o]), t2);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int kEpi>
int launch(dim3 grid, cudaStream_t stream, const void* a, const void* w,
           const void* colsum, const void* w_scale, const void* a_site,
           const void* bias, const void* site, const void* site2,
           const void* residual, void* out, int M, int N, int K) {
  auto kernel = gemm_s8_kernel<kEpi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const s8*>(a), static_cast<const s8*>(w),
      static_cast<const float*>(colsum), static_cast<const float*>(w_scale),
      static_cast<const float*>(a_site), static_cast<const float*>(bias),
      static_cast<const float*>(site), static_cast<const float*>(site2),
      static_cast<const float*>(residual), out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) int8 row-major; w the (N, K) int8 torch weight, row-major;
// colsum, bias fp32 (N,); w_scale one fp32; a_site, site, site2 fp32
// (scale, zero point, has_stats) rows; residual fp32 (M, N) (epilogue 2);
// out fp32 (M, N), int8 for epilogue 1.
MVT_EXPORT int mvt_gemm_s8(const void* a, const void* w, const void* colsum,
                           const void* w_scale, const void* a_site,
                           const void* bias, const void* site,
                           const void* site2, const void* residual, void* out,
                           int M, int N, int K, int epilogue, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || epilogue < kRequant ||
      epilogue > kRequantResidual ||
      (epilogue != kRequant && site2 == nullptr) ||
      (epilogue == kRequantResidual && residual == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kRequant:
      return launch<kRequant>(grid, s, a, w, colsum, w_scale, a_site, bias,
                              site, site2, residual, out, M, N, K);
    case kRequantGeluQuant:
      return launch<kRequantGeluQuant>(grid, s, a, w, colsum, w_scale, a_site,
                                       bias, site, site2, residual, out, M, N,
                                       K);
    default:
      return launch<kRequantResidual>(grid, s, a, w, colsum, w_scale, a_site,
                                      bias, site, site2, residual, out, M, N,
                                      K);
  }
}
