// gemm_bf16_epilogue: out[M, N] = epilogue(A[M, K] @ B[K, N] (+ bias[N])).
//
// The projections inside the TPU block kernels, forward and backward
// (myrtle_vision_tpu/ops/fused_attention_block.py `_fwd_kernel` and
// `_bwd_one_image`; myrtle_vision_tpu/ops/fused_mlp.py `_fwd_kernel` and
// `_bwd_one_image`).  bf16 operands, fp32 accumulation on the tensor cores
// (WMMA 16x16x16), one rounding of each output.  Epilogues:
//   0  + bias, bf16 out                       (QKV projection)
//   1  + bias, GELU, bf16 out                 (fc1; the Abramowitz & Stegun
//      7.1.26 erf with an exact divide, `_gelu_f32` in interpret mode)
//   2  + bias + residual, bf16 out            (output projection and fc2)
//   3  fp32 out, no bias                      (d_o, dxn and the weight
//      gradients; with split K, one partial product per blockIdx.z)
//   4  + bias, bf16 GELU out and the fp32 GELU derivative into `aux`
//                                             (the backward's fc1 remat,
//                                             `_gelu_and_grad_f32`)
//   5  x aux (fp32), bf16 out, fp32 column sums of the product per 128-row
//      tile into `colpart`                    (dh = dg * gelu'(h), db1)
// A is read row-major (M, K), or column-major -- the (K, M) activation as
// it is stored -- so that a weight gradient dW^T = dY^T X reads both
// activations in place.  B is read row-major (K, N) -- the JAX (in, out)
// layout -- or column-major, i.e. the (N, K) torch (out, in) weight as it
// is stored; no transposed copy is ever made.
//
// At ViT-S/16 shapes (M = B*197, K, N in {384, 1152, 1536}) these products
// are compute bound.  Each block of eight warps owns a 128x128 output tile
// (each warp 64x32) and walks K in 32-deep steps through a three-stage
// cp.async ring in shared memory, so the loads of the next two steps
// overlap the tensor-core work of this one.  The ragged edges (197 rows
// per image in M, and in K for a weight gradient, whose K is B*197) are
// zero-filled on load and masked on store.  A weight gradient has few
// output tiles (27 at 1152x384) and a long K, so it splits K over
// blockIdx.z and the caller sums the partial products.  wgmma and TMA are
// not used yet.
//
// Probe instantiations (mvt_gemm_bf16_probe), for the K12 / K13 probes of
// tools/perf/{attn,mlp}_microbench.py; the production ones above are
// these templates at their defaults, unchanged:
//   - the GELU of epilogue 1 in the modes of `_erf_variant`
//     (mlp_microbench.py:54): 0 base (the erf above), 1 nogelu (h as it
//     is), 2 noexp (s (1 - poly 0.1), wrong on purpose: a diagnostic of
//     the exp's cost), 3 nodiv (t from the approximate reciprocal
//     rcp.approx.ftz.f32 and one Newton step r (2 - y r), ~2^-24 relative);
//   - epilogue 6, a bf16 store with no bias and no residual (the
//     `dotonly` probe's projections);
//   - B read head-major: (3, H, K, 64) panels of 64 columns, column
//     (t, h, d) of the (K, 3 H 64) operand at ((t H + h) K + k) 64 + d
//     (attn_microbench.py's `pvrow` weight w3).
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;
using mvt::bf16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int A_LD = BK + 8;   // A tile, row-major BM x BK
constexpr int AC_LD = BM + 8;  // A tile, column-major (stored BK x BM)
constexpr int BR_LD = BN + 8;  // B tile, row-major BK x BN
constexpr int BC_LD = BK + 8;  // B tile, column-major (stored BN x BK)
constexpr int kATile = (BM * A_LD > BK * AC_LD) ? BM * A_LD : BK * AC_LD;
constexpr int kBTile = (BK * BR_LD > BN * BC_LD) ? BK * BR_LD : BN * BC_LD;
constexpr int kStageElems = kATile + kBTile;
constexpr int E_LD = 16 + 4;   // per-warp fp32 staging of one fragment
constexpr size_t kSmemBytes = sizeof(bf16) * kStages * kStageElems +
                              sizeof(float) * kWarps * 16 * E_LD +
                              sizeof(float) * 2 * BN;  // column sums

enum Epilogue {
  kBias = 0,
  kBiasGelu = 1,
  kBiasResidual = 2,
  kF32 = 3,
  kBiasGeluGrad = 4,
  kMulAuxColsum = 5,
  kStore = 6,  // probes only
};

// GELU modes of the probe (the header); production takes kGeluBase
enum GeluMode { kGeluBase = 0, kGeluNone = 1, kGeluNoExp = 2, kGeluNoDiv = 3 };

// the approximate reciprocal of the special-function unit (not __frcp_rn,
// which is the exact IEEE one)
__device__ __forceinline__ float rcp_approx(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

template <int kGelu = kGeluBase>
__device__ __forceinline__ float erf_as(float x) {
  const float s = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float ax = fabsf(x);
  float t;
  if constexpr (kGelu == kGeluNoDiv) {
    const float y = 1.0f + 0.3275911f * ax;
    const float r = rcp_approx(y);
    t = r * (2.0f - y * r);
  } else {
    t = 1.0f / (1.0f + 0.3275911f * ax);
  }
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  if constexpr (kGelu == kGeluNoExp) return s * (1.0f - poly * 0.1f);
  return s * (1.0f - poly * expf(-ax * ax));
}

template <int kGelu = kGeluBase>
__device__ __forceinline__ float gelu_as(float h) {
  if constexpr (kGelu == kGeluNone) return h;
  return 0.5f * h * (1.0f + erf_as<kGelu>(h / 1.4142135623730951f));
}

// 16-byte asynchronous copy; when !ok nothing is read and zeros are written
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool ok) {
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

// one BK-deep step of both tiles; rows of K at or past k_end read as zero;
// kBPanel > 0: B row-major in panels of kBPanel columns (head-major)
template <bool kAColMajor, bool kBColMajor, int kBPanel = 0>
__device__ __forceinline__ void load_stage(bf16* stage, const bf16* A,
                                           const bf16* B, int M, int N, int K,
                                           int k_end, int m0, int n0, int k0,
                                           int tid) {
  bf16* As = stage;
  bf16* Bs = stage + kATile;
  // a 16-byte chunk runs along K (row-major A, column-major B: K % 8 == 0
  // and k_end a multiple of 8) or along M / N (multiples of 8), so it is
  // all in or all out
  if (kAColMajor) {
    for (int c = tid; c < BK * (BM / 8); c += kThreads) {
      const int r = c / (BM / 8), mc = (c % (BM / 8)) * 8;
      const int gk = k0 + r, gm = m0 + mc;
      const bool ok = gk < k_end && gm < M;
      cp_async16(&As[r * AC_LD + mc],
                 ok ? A + static_cast<size_t>(gk) * M + gm : A, ok);
    }
  } else {
    for (int c = tid; c < BM * (BK / 8); c += kThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < k_end;
      cp_async16(&As[r * A_LD + kc],
                 ok ? A + static_cast<size_t>(gr) * K + gk : A, ok);
    }
  }
  if (kBColMajor) {
    for (int c = tid; c < BN * (BK / 8); c += kThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gn = n0 + r, gk = k0 + kc;
      const bool ok = gn < N && gk < k_end;
      cp_async16(&Bs[r * BC_LD + kc],
                 ok ? B + static_cast<size_t>(gn) * K + gk : B, ok);
    }
  } else {
    for (int c = tid; c < BK * (BN / 8); c += kThreads) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < k_end && gn < N;
      if constexpr (kBPanel > 0) {
        // a chunk of 8 columns lies in one panel (kBPanel % 8 == 0)
        const size_t at = (static_cast<size_t>(gn / kBPanel) * K + gk) *
                              kBPanel + gn % kBPanel;
        cp_async16(&Bs[r * BR_LD + nc], ok ? B + at : B, ok);
      } else {
        cp_async16(&Bs[r * BR_LD + nc],
                   ok ? B + static_cast<size_t>(gk) * N + gn : B, ok);
      }
    }
  }
}

template <bool kAColMajor, bool kBColMajor, int kEpi,
          int kGelu = kGeluBase, int kBPanel = 0>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            const float* __restrict__ bias, const bf16* __restrict__ residual,
            void* __restrict__ out, float* __restrict__ aux,
            float* __restrict__ colpart, int M, int N, int K, int k_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* Es = reinterpret_cast<float*>(stages + kStages * kStageElems);
  float* colbuf = Es + kWarps * 16 * E_LD;  // 2 x BN
  using ALayout =
      typename std::conditional<kAColMajor, wmma::col_major,
                                wmma::row_major>::type;
  using BLayout =
      typename std::conditional<kBColMajor, wmma::col_major,
                                wmma::row_major>::type;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64;  // 2 warps down M
  const int wn = (warp & 3) * 32;   // 4 warps across N
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int k_tiles = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles)
      load_stage<kAColMajor, kBColMajor, kBPanel>(
          stages + s * kStageElems, A, B, M, N, K, k_end, m0, n0,
          k_begin + s * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    // step kt has landed, and every warp is done with step kt - 1, whose
    // stage the prefetch below overwrites
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles)
      load_stage<kAColMajor, kBColMajor, kBPanel>(
          stages + (next % kStages) * kStageElems, A, B, M, N, K, k_end, m0,
          n0, k_begin + next * BK, tid);
    cp_async_commit();

    const bf16* As = stages + (kt % kStages) * kStageElems;
    const bf16* Bs = As + kATile;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kAColMajor)
          wmma::load_matrix_sync(a[i], &As[kk * AC_LD + wm + 16 * i], AC_LD);
        else
          wmma::load_matrix_sync(a[i], &As[(wm + 16 * i) * A_LD + kk], A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (kBColMajor)
          wmma::load_matrix_sync(b[j], &Bs[(wn + 16 * j) * BC_LD + kk],
                                 BC_LD);
        else
          wmma::load_matrix_sync(b[j], &Bs[kk * BR_LD + wn + 16 * j], BR_LD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue, one 16x16 fragment at a time through the warp's staging area;
  // lane handles column (lane & 15) of rows 2t + (lane >> 4)
  float* e_w = Es + warp * 16 * E_LD;
  float col_acc[2] = {0.f, 0.f};
  const size_t out_base = static_cast<size_t>(blockIdx.z) * M * N;
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
          float v = e_w[r * E_LD + c];
          if (kEpi == kF32) {
            static_cast<float*>(out)[out_base + o] = v;
            continue;
          }
          if constexpr (kEpi == kStore) {
            static_cast<bf16*>(out)[o] = __float2bfloat16_rn(v);
            continue;
          }
          if (kEpi == kMulAuxColsum) {
            v *= aux[o];
            col_acc[j] += v;
          } else {
            v += bias[gc];
          }
          if (kEpi == kBiasGelu) {
            v = gelu_as<kGelu>(v);
          } else if (kEpi == kBiasResidual) {
            v = __bfloat162float(residual[o]) + v;
          } else if (kEpi == kBiasGeluGrad) {
            const float cdf =
                0.5f * (1.0f + erf_as(v / 1.4142135623730951f));
            const float pdf = expf(-0.5f * (v * v)) * 0.3989422804014327f;
            aux[o] = cdf + v * pdf;
            v = v * cdf;
          }
          static_cast<bf16*>(out)[o] = __float2bfloat16_rn(v);
        }
      }
      __syncwarp();
    }
  }
  if (kEpi == kMulAuxColsum) {
    // the warp's 64-row sums of its 32 columns, then the two warps that
    // share those columns, in a fixed order
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float s = col_acc[j] + __shfl_xor_sync(0xffffffffu, col_acc[j], 16);
      if (lane < 16) colbuf[(warp >> 2) * BN + wn + 16 * j + lane] = s;
    }
    __syncthreads();
    if (tid < BN && n0 + tid < N)
      colpart[static_cast<size_t>(blockIdx.y) * N + n0 + tid] =
          colbuf[tid] + colbuf[BN + tid];
  }
}

template <bool kAColMajor, bool kBColMajor, int kEpi, int kGelu = kGeluBase,
          int kBPanel = 0>
int launch(dim3 grid, cudaStream_t stream, const void* a, const void* b,
           const void* bias, const void* residual, void* out, void* aux,
           void* colpart, int M, int N, int K, int k_split) {
  auto kernel = gemm_kernel<kAColMajor, kBColMajor, kEpi, kGelu, kBPanel>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const float*>(bias), static_cast<const bf16*>(residual),
      out, static_cast<float*>(aux), static_cast<float*>(colpart), M, N, K,
      k_split);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBColMajor>
int launch_epi(int epilogue, dim3 grid, cudaStream_t s, const void* a,
               const void* b, const void* bias, const void* residual,
               void* out, void* aux, void* colpart, int M, int N, int K) {
  switch (epilogue) {
    case kBias:
      return launch<false, kBColMajor, kBias>(grid, s, a, b, bias, residual,
                                              out, aux, colpart, M, N, K, K);
    case kBiasGelu:
      return launch<false, kBColMajor, kBiasGelu>(
          grid, s, a, b, bias, residual, out, aux, colpart, M, N, K, K);
    case kBiasResidual:
      return launch<false, kBColMajor, kBiasResidual>(
          grid, s, a, b, bias, residual, out, aux, colpart, M, N, K, K);
    case kF32:
      return launch<false, kBColMajor, kF32>(grid, s, a, b, bias, residual,
                                             out, aux, colpart, M, N, K, K);
    case kBiasGeluGrad:
      return launch<false, kBColMajor, kBiasGeluGrad>(
          grid, s, a, b, bias, residual, out, aux, colpart, M, N, K, K);
    default:
      return launch<false, kBColMajor, kMulAuxColsum>(
          grid, s, a, b, bias, residual, out, aux, colpart, M, N, K, K);
  }
}

// the probe instantiations: B row-major, or head-major panels of kBPanel
// columns (the QKV product of `pvrow` only)
template <int kBPanel>
int launch_probe(int epilogue, int gelu, dim3 grid, cudaStream_t s,
                 const void* a, const void* b, const void* bias,
                 const void* residual, void* out, int M, int N, int K) {
  if (kBPanel > 0 || epilogue == kBias)
    return launch<false, false, kBias, kGeluBase, kBPanel>(
        grid, s, a, b, bias, residual, out, nullptr, nullptr, M, N, K, K);
  switch (epilogue) {
    case kBiasResidual:
      return launch<false, false, kBiasResidual>(
          grid, s, a, b, bias, residual, out, nullptr, nullptr, M, N, K, K);
    case kStore:
      return launch<false, false, kStore>(grid, s, a, b, bias, residual, out,
                                          nullptr, nullptr, M, N, K, K);
    default:
      break;
  }
  switch (gelu) {  // epilogue kBiasGelu
    case kGeluBase:
      return launch<false, false, kBiasGelu>(
          grid, s, a, b, bias, residual, out, nullptr, nullptr, M, N, K, K);
    case kGeluNone:
      return launch<false, false, kBiasGelu, kGeluNone>(
          grid, s, a, b, bias, residual, out, nullptr, nullptr, M, N, K, K);
    case kGeluNoExp:
      return launch<false, false, kBiasGelu, kGeluNoExp>(
          grid, s, a, b, bias, residual, out, nullptr, nullptr, M, N, K, K);
    default:
      return launch<false, false, kBiasGelu, kGeluNoDiv>(
          grid, s, a, b, bias, residual, out, nullptr, nullptr, M, N, K, K);
  }
}

}  // namespace

// Row-major A.  `out` is bf16 except for epilogue 3 (fp32); `aux` is the
// fp32 (M, N) GELU derivative (written by 4, read by 5); `colpart` the
// fp32 (ceil(M / 128), N) column sums of epilogue 5.
MVT_EXPORT int mvt_gemm_bf16(const void* a, const void* b, const void* bias,
                             const void* residual, void* out, void* aux,
                             void* colpart, int M, int N, int K,
                             int b_col_major, int epilogue, void* stream) {
  const bool needs_bias = epilogue != kF32 && epilogue != kMulAuxColsum;
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      epilogue < kBias || epilogue > kMulAuxColsum ||
      (needs_bias && bias == nullptr) ||
      (epilogue == kBiasResidual && residual == nullptr) ||
      ((epilogue == kBiasGeluGrad || epilogue == kMulAuxColsum) &&
       aux == nullptr) ||
      (epilogue == kMulAuxColsum && colpart == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_col_major)
    return launch_epi<true>(epilogue, grid, s, a, b, bias, residual, out, aux,
                            colpart, M, N, K);
  return launch_epi<false>(epilogue, grid, s, a, b, bias, residual, out, aux,
                           colpart, M, N, K);
}

// Weight gradient: out = A^T-stored x B, i.e. A stored (K, M) row-major and
// B (K, N) row-major, K ragged, fp32 out.  K is split into chunks of
// k_split rows (a multiple of 32); chunk z writes out[z] of (splits, M, N).
MVT_EXPORT int mvt_gemm_bf16_at(const void* a, const void* b, void* out,
                                int M, int N, int K, int k_split,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 8 != 0 || N % 8 != 0 ||
      k_split <= 0 || k_split % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM,
                  (K + k_split - 1) / k_split);
  return launch<true, false, kF32>(grid, static_cast<cudaStream_t>(stream),
                                   a, b, nullptr, nullptr, out, nullptr,
                                   nullptr, M, N, K, k_split);
}

// The probes' GEMMs (see the header): row-major A; epilogue 0, 1 (with
// GELU mode `gelu`, 0-3), 2 or 6, bf16 out; b_layout 0 row-major (K, N),
// or 64: head-major panels of 64 columns with epilogue 0.
MVT_EXPORT int mvt_gemm_bf16_probe(const void* a, const void* b,
                                   const void* bias, const void* residual,
                                   void* out, int M, int N, int K,
                                   int b_layout, int epilogue, int gelu,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      !(epilogue == kBias || epilogue == kBiasGelu ||
        epilogue == kBiasResidual || epilogue == kStore) ||
      gelu < kGeluBase || gelu > kGeluNoDiv ||
      (gelu != kGeluBase && epilogue != kBiasGelu) ||
      (epilogue != kStore && bias == nullptr) ||
      (epilogue == kBiasResidual && residual == nullptr) ||
      !(b_layout == 0 || (b_layout == 64 && epilogue == kBias &&
                          N % 64 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_layout == 64)
    return launch_probe<64>(epilogue, gelu, grid, s, a, b, bias, residual,
                            out, M, N, K);
  return launch_probe<0>(epilogue, gelu, grid, s, a, b, bias, residual, out,
                         M, N, K);
}
