// gemm_bf16_probe: the WMMA design of gemm_bf16_epilogue, kept for the
// K12 / K13 probes of tools/perf/{attn,mlp}_microbench.py.  The production
// GEMM is csrc/gemm_bf16_wgmma.cu (wgmma, TMA); this file's kernel is the
// one it replaced, in the probes' instantiations only, so that each probe
// compares its variants within one design.
//
// out[M, N] = epilogue(A[M, K] @ B[K, N] (+ bias[N])), A row-major, bf16
// operands, fp32 accumulation on the tensor cores (WMMA 16x16x16), one
// rounding of each output.  Each block of eight warps owns a 128x128
// output tile (each warp 64x32) and walks K in 32-deep steps through a
// three-stage cp.async ring in shared memory; the ragged edges are
// zero-filled on load and masked on store.  Epilogues:
//   0  + bias, bf16 out
//   1  + bias, GELU, bf16 out, the GELU in the modes of `_erf_variant`
//      (mlp_microbench.py:54): 0 base (the Abramowitz & Stegun 7.1.26 erf
//      with an exact divide, as production), 1 nogelu (h as it is),
//      2 noexp (s (1 - poly 0.1), wrong on purpose: a diagnostic of the
//      exp's cost), 3 nodiv (t from the approximate reciprocal
//      rcp.approx.ftz.f32 and one Newton step r (2 - y r), ~2^-24
//      relative)
//   2  + bias + residual, bf16 out
//   6  a bf16 store with no bias and no residual (the `dotonly` probe's
//      projections)
// B is read row-major (K, N), or head-major: (3, H, K, 64) panels of 64
// columns, column (t, h, d) of the (K, 3 H 64) operand at
// ((t H + h) K + k) 64 + d (attn_microbench.py's `pvrow` weight w3).
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
constexpr int BR_LD = BN + 8;  // B tile, row-major BK x BN
constexpr int kATile = BM * A_LD;
constexpr int kBTile = BK * BR_LD;
constexpr int kStageElems = kATile + kBTile;
constexpr int E_LD = 16 + 4;   // per-warp fp32 staging of one fragment
constexpr size_t kSmemBytes = sizeof(bf16) * kStages * kStageElems +
                              sizeof(float) * kWarps * 16 * E_LD;

enum Epilogue {
  kBias = 0,
  kBiasGelu = 1,
  kBiasResidual = 2,
  kStore = 6,
};

// GELU modes of the probe (the header); production's is kGeluBase
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

// one BK-deep step of both tiles; rows of K at or past K read as zero;
// kBPanel > 0: B row-major in panels of kBPanel columns (head-major)
template <int kBPanel>
__device__ __forceinline__ void load_stage(bf16* stage, const bf16* A,
                                           const bf16* B, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
  bf16* As = stage;
  bf16* Bs = stage + kATile;
  // a 16-byte chunk runs along K (A: K % 8 == 0) or along N (a multiple
  // of 8), so it is all in or all out
  for (int c = tid; c < BM * (BK / 8); c += kThreads) {
    const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    const int gr = m0 + r, gk = k0 + kc;
    const bool ok = gr < M && gk < K;
    cp_async16(&As[r * A_LD + kc],
               ok ? A + static_cast<size_t>(gr) * K + gk : A, ok);
  }
  for (int c = tid; c < BK * (BN / 8); c += kThreads) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const int gk = k0 + r, gn = n0 + nc;
    const bool ok = gk < K && gn < N;
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

template <int kEpi, int kGelu = kGeluBase, int kBPanel = 0>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            const float* __restrict__ bias, const bf16* __restrict__ residual,
            bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* Es = reinterpret_cast<float*>(stages + kStages * kStageElems);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64;  // 2 warps down M
  const int wn = (warp & 3) * 32;   // 4 warps across N

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int k_tiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles)
      load_stage<kBPanel>(stages + s * kStageElems, A, B, M, N, K, m0, n0,
                          s * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    // step kt has landed, and every warp is done with step kt - 1, whose
    // stage the prefetch below overwrites
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles)
      load_stage<kBPanel>(stages + (next % kStages) * kStageElems, A, B, M,
                          N, K, m0, n0, next * BK, tid);
    cp_async_commit();

    const bf16* As = stages + (kt % kStages) * kStageElems;
    const bf16* Bs = As + kATile;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm + 16 * i) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * BR_LD + wn + 16 * j], BR_LD);
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
          if constexpr (kEpi != kStore) v += bias[gc];
          if constexpr (kEpi == kBiasGelu) {
            v = gelu_as<kGelu>(v);
          } else if constexpr (kEpi == kBiasResidual) {
            v = __bfloat162float(residual[o]) + v;
          }
          out[o] = __float2bfloat16_rn(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int kEpi, int kGelu = kGeluBase, int kBPanel = 0>
int launch(dim3 grid, cudaStream_t stream, const void* a, const void* b,
           const void* bias, const void* residual, void* out, int M, int N,
           int K) {
  auto kernel = gemm_kernel<kEpi, kGelu, kBPanel>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const float*>(bias), static_cast<const bf16*>(residual),
      static_cast<bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// the probe instantiations: B row-major, or head-major panels of kBPanel
// columns (the QKV product of `pvrow` only)
template <int kBPanel>
int launch_probe(int epilogue, int gelu, dim3 grid, cudaStream_t s,
                 const void* a, const void* b, const void* bias,
                 const void* residual, void* out, int M, int N, int K) {
  if (kBPanel > 0 || epilogue == kBias)
    return launch<kBias, kGeluBase, kBPanel>(grid, s, a, b, bias, residual,
                                             out, M, N, K);
  switch (epilogue) {
    case kBiasResidual:
      return launch<kBiasResidual>(grid, s, a, b, bias, residual, out, M, N,
                                   K);
    case kStore:
      return launch<kStore>(grid, s, a, b, bias, residual, out, M, N, K);
    default:
      break;
  }
  switch (gelu) {  // epilogue kBiasGelu
    case kGeluBase:
      return launch<kBiasGelu>(grid, s, a, b, bias, residual, out, M, N, K);
    case kGeluNone:
      return launch<kBiasGelu, kGeluNone>(grid, s, a, b, bias, residual, out,
                                          M, N, K);
    case kGeluNoExp:
      return launch<kBiasGelu, kGeluNoExp>(grid, s, a, b, bias, residual,
                                           out, M, N, K);
    default:
      return launch<kBiasGelu, kGeluNoDiv>(grid, s, a, b, bias, residual,
                                           out, M, N, K);
  }
}

}  // namespace

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
