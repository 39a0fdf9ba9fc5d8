// gemm_layout_probe: the per-image contractions of the block backwards, with
// each transposed operand read in one of two layouts.
//
// The H100 counterpart of the TPU probe tools/perf/layout_probe.py
// (`run_case` :37, its `pallas_call` :81, the bodies of `main` :136-224 via
// `_dot` :30), K14: per image, and per head where the operands are stacks
// of head slices, out = A . B with bf16 operands, fp32 accumulation on the
// tensor cores (WMMA 16x16x16) and an fp32 output, for the backward's
// contractions dv = e^T du, dp = du v^T, dW = xn^T dy, dxn = dy W^T and
// the forward's s = q k^T and qkv = xn W.  A transposed operand (A stored
// (K, M), or B stored (N, K)) is staged into shared memory
//   implicit  as it is stored, and read by column-major fragments, as the
//             port's backward GEMMs read theirs (gemm_bf16_epilogue.cu's
//             kAColMajor / kBColMajor);
//   explicit  transposed on the way in, so that the fragments load
//             row-major (the counterpart of the TPU probe's explicit .T);
// a pre-transposed operand is stored the natural way and needs neither.
//
// Operands: image z of a batch at z * img elements, head h at h * head
// elements (columns of the stored stack) and a row stride ld; an operand
// with img 0 is shared by every image (a weight).  Output head h of image z
// at z * o_img + h * o_head, row stride ldo (the heads concatenated along
// the last axis).  One block of four warps computes a 64 x 64 output tile
// in 32-deep steps; elements are staged one by one (a head slice starts at
// any column, e.g. h * 197, so 16-byte vectors do not apply), masked at
// the ragged edges in M, N and K.  At the probe's shapes (B=512, N=197,
// C=384) every case is bound by its fp32 output bytes, not by the tensor
// cores: dW alone writes 906 MB a call.  A simple kernel, not a fast one.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;
using mvt::bf16;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int kThreads = 128;  // four warps, each a 32 x 32 output tile
constexpr int OK_LD = BK + 8;  // a tile held [outer][k]
constexpr int KO_LD = BM + 8;  // a tile held [k][outer]
constexpr int kTile = (BM * OK_LD > BK * KO_LD) ? BM * OK_LD : BK * KO_LD;
constexpr int E_LD = 16 + 4;   // per-warp fp32 staging of one fragment

struct Operand {
  const bf16* p;
  long long img, head;
  int ld;
};

// One BK-deep step of an operand whose "outer" index is m (A) or n (B):
// element (o, k) is stored at o * ld + k (kKCont) or k * ld + o, and is put
// at sm[o][k] (kOK) or sm[k][o].  Outside [0, extent) x [0, K) it reads 0.
template <bool kKCont, bool kOK>
__device__ __forceinline__ void stage(bf16* sm, const bf16* src, int ld,
                                      int o0, int extent, int k0, int K,
                                      int tid) {
  for (int c = tid; c < BM * BK; c += kThreads) {
    // the stored-contiguous index runs fastest, so a warp reads one run
    const int o = kKCont ? c / BK : c % BM;
    const int k = kKCont ? c % BK : c / BM;
    const int go = o0 + o, gk = k0 + k;
    bf16 v = __float2bfloat16_rn(0.f);
    if (go < extent && gk < K)
      v = src[kKCont ? static_cast<size_t>(go) * ld + gk
                     : static_cast<size_t>(gk) * ld + go];
    sm[kOK ? o * OK_LD + k : k * KO_LD + o] = v;
  }
}

// kATrans: A stored (K, M); kBTrans: B stored (N, K); kExplicit: such an
// operand is transposed as it is staged
template <bool kATrans, bool kBTrans, bool kExplicit>
__global__ void __launch_bounds__(kThreads)
layout_kernel(Operand a, Operand b, float* __restrict__ out, long long o_img,
              long long o_head, int ldo, int M, int N, int K, int heads) {
  // A held [m][k] (row-major fragments) unless read implicitly transposed
  constexpr bool kAOK = !(kATrans && !kExplicit);
  // B held [k][n] (row-major fragments) unless read implicitly transposed
  constexpr bool kBOK = kBTrans && !kExplicit;
  using ALayout = typename std::conditional<kAOK, wmma::row_major,
                                            wmma::col_major>::type;
  using BLayout = typename std::conditional<kBOK, wmma::col_major,
                                            wmma::row_major>::type;
  __shared__ __align__(128) bf16 As[kTile];
  __shared__ __align__(128) bf16 Bs[kTile];
  __shared__ __align__(128) float Es[4 * 16 * E_LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int z = blockIdx.z;
  const int img = z / heads, h = z % heads;
  const bf16* pa = a.p + img * a.img + h * a.head;
  const bf16* pb = b.p + img * b.img + h * b.head;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<!kATrans, kAOK>(As, pa, a.ld, m0, M, k0, K, tid);
    stage<kBTrans, kBOK>(Bs, pb, b.ld, n0, N, k0, K, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (kAOK)
          wmma::load_matrix_sync(fa[i], &As[(wm + 16 * i) * OK_LD + kk],
                                 OK_LD);
        else
          wmma::load_matrix_sync(fa[i], &As[kk * KO_LD + wm + 16 * i], KO_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (kBOK)
          wmma::load_matrix_sync(fb[j], &Bs[(wn + 16 * j) * OK_LD + kk],
                                 OK_LD);
        else
          wmma::load_matrix_sync(fb[j], &Bs[kk * KO_LD + wn + 16 * j], KO_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are rewritten by the next step
  }

  // one 16 x 16 fragment at a time through the warp's staging area; lane
  // handles column (lane & 15) of rows 2t + (lane >> 4)
  float* e_w = Es + warp * 16 * E_LD;
  float* o = out + img * o_img + h * o_head;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(e_w, acc[i][j], E_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int gr = m0 + wm + 16 * i + r, gc = n0 + wn + 16 * j + c;
        if (gr < M && gc < N)
          o[static_cast<size_t>(gr) * ldo + gc] = e_w[r * E_LD + c];
      }
      __syncwarp();
    }
  }
}

template <bool kATrans, bool kBTrans, bool kExplicit>
int launch(const Operand& a, const Operand& b, void* out, long long o_img,
           long long o_head, int ldo, int M, int N, int K, int batch,
           int heads, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch * heads);
  layout_kernel<kATrans, kBTrans, kExplicit><<<grid, kThreads, 0, stream>>>(
      a, b, static_cast<float*>(out), o_img, o_head, ldo, M, N, K, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (fp32) = A . B per image z < batch and head h < heads, as the header
// says; a_trans: A stored (K, M) with row stride lda, else (M, K); b_trans:
// B stored (N, K), else (K, N); explicit_t: a transposed operand is
// transposed as it is staged (else read by column-major fragments).
MVT_EXPORT int mvt_gemm_layout_probe(
    const void* a, const void* b, void* out, int M, int N, int K, int batch,
    int heads, long long a_img, long long a_head, int lda, long long b_img,
    long long b_head, int ldb, long long o_img, long long o_head, int ldo,
    int a_trans, int b_trans, int explicit_t, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || batch <= 0 || heads <= 0 ||
      static_cast<long long>(batch) * heads > 65535 || lda <= 0 ||
      ldb <= 0 || ldo < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operand oa{static_cast<const bf16*>(a), a_img, a_head, lda};
  const Operand ob{static_cast<const bf16*>(b), b_img, b_head, ldb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = (a_trans ? 4 : 0) | (b_trans ? 2 : 0) |
                   ((a_trans || b_trans) && explicit_t ? 1 : 0);
#define MVT_LAYOUT_CASE(c, at, bt, ex)                                     \
  case c:                                                                  \
    return launch<at, bt, ex>(oa, ob, out, o_img, o_head, ldo, M, N, K,   \
                              batch, heads, s);
  switch (code) {
    MVT_LAYOUT_CASE(0, false, false, false)
    MVT_LAYOUT_CASE(2, false, true, false)
    MVT_LAYOUT_CASE(3, false, true, true)
    MVT_LAYOUT_CASE(4, true, false, false)
    MVT_LAYOUT_CASE(5, true, false, true)
    MVT_LAYOUT_CASE(6, true, true, false)
    MVT_LAYOUT_CASE(7, true, true, true)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MVT_LAYOUT_CASE
}
