// gemm_f32x3_epilogue: the fp32 projections of the float-format block
// halves, out[M, N] = epilogue(A[M, K] @ W[K, N] + bias[N]).
//
// The projections inside the TPU block kernels with qspec set
// (myrtle_vision_tpu/ops/fused_attention_block.py `_qkv_rows` and the
// output projection of `_fwd_kernel`; myrtle_vision_tpu/ops/fused_mlp.py
// `fc1` and `fc2`): fp32 operands through the 3-pass bf16 product of
// `dot_high3` (myrtle_vision_tpu/ops/high_precision.py).  Each operand is
// split on load, x = hi + lo with hi = bf16(x), lo = bf16(x - hi); the
// three products ah.bh, ah.bl and al.bh each run over the whole K on the
// tensor cores (WMMA 16x16x16, bf16 in, fp32 accumulators: every term is
// exact, only the fp32 sum order is the hardware's), and are added as
// (P1 + P2) + P3, the order of `dot_high3`.  Epilogues, with the snaps of
// fake_quant.cuh (qspec = (exp_bits, man_bits, all_sites) at run time),
// each rounding in the plain version's order:
//   0  snap_all(P + bias)                                    (QKV)
//   1  snap(snap_all(GELU(snap_all(P + bias))))              (fc1: fc1
//      act_out, GELU act_out, fc2 act_in; the polynomial erf, exact divide)
//   2  snap_all(residual + snap_all(P + bias))       (output projection
//      and fc2: act_out, then the residual add's functional site)
// A is row-major (M, K); W is read in place as the (in, out) view of the
// torch (out, in) weight, i.e. the (N, K) weight row-major, so both
// operands run along K in memory.
//
// The three passes triple the bf16 tensor-core work of the FP32 format's
// products, so at ViT-S/16 shapes they are compute bound (3 x 2MNK bf16
// operations against 4 (MK + NK + MN) bytes).  Each block of eight warps
// owns a 128x64 output tile (each warp 32x32, with three accumulators per
// fragment) and walks K in 32-deep steps: the next step's fp32 values are
// loaded into registers while the tensor cores work on this one, then
// split into bf16 hi and lo tiles in shared memory.  Ragged M and N are
// zero-filled on load and masked on store; K must be a multiple of 4.
// wgmma and TMA are not used yet.
#include <mma.h>

#include "fake_quant.cuh"

namespace {

using namespace nvcuda;
using mvt::bf16;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int LD = BK + 8;     // bf16 row stride of a split tile
constexpr int E_LD = 16 + 4;   // per-warp fp32 staging of one fragment
constexpr int kARegs = BM * BK / 4 / kThreads;  // float4 loads a thread
constexpr int kBRegs = BN * BK / 4 / kThreads;
constexpr int kATile = BM * LD;  // bf16 elements of one A half
constexpr int kBTile = BN * LD;
constexpr size_t kSmemBytes =
    sizeof(bf16) * 2 * (kATile + kBTile) + sizeof(float) * kWarps * 16 * E_LD;

enum Epilogue {
  kBiasSnap = 0,
  kBiasSnapGeluSnap = 1,
  kBiasSnapResidualSnap = 2,
};

// the next BK-deep step of A (BM rows) and W^T (BN rows), 16 bytes a load,
// zeros outside the matrices (K % 4 == 0: a 4-float chunk is all in or out)
__device__ __forceinline__ void load_step(float4 (&ra)[kARegs],
                                          float4 (&rb)[kBRegs],
                                          const float* A, const float* Wt,
                                          int M, int N, int K, int m0, int n0,
                                          int k0, int tid) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kARegs; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (BK / 4), gk = k0 + (c % (BK / 4)) * 4;
    const int gr = m0 + r;
    ra[i] = (gr < M && gk < K)
                ? *reinterpret_cast<const float4*>(
                      A + static_cast<size_t>(gr) * K + gk)
                : zero;
  }
#pragma unroll
  for (int i = 0; i < kBRegs; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (BK / 4), gk = k0 + (c % (BK / 4)) * 4;
    const int gn = n0 + r;
    rb[i] = (gn < N && gk < K)
                ? *reinterpret_cast<const float4*>(
                      Wt + static_cast<size_t>(gn) * K + gk)
                : zero;
  }
}

// hi = bf16(x), lo = bf16(x - hi) of four values, stored at hi[0..3],
// lo[0..3] (8-byte aligned)
__device__ __forceinline__ void split4(float4 v, bf16* hi, bf16* lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  const __nv_bfloat162 l01 =
      __floats2bfloat162_rn(__fsub_rn(v.x, __low2float(h01)),
                            __fsub_rn(v.y, __high2float(h01)));
  const __nv_bfloat162 l23 =
      __floats2bfloat162_rn(__fsub_rn(v.z, __low2float(h23)),
                            __fsub_rn(v.w, __high2float(h23)));
  reinterpret_cast<__nv_bfloat162*>(hi)[0] = h01;
  reinterpret_cast<__nv_bfloat162*>(hi)[1] = h23;
  reinterpret_cast<__nv_bfloat162*>(lo)[0] = l01;
  reinterpret_cast<__nv_bfloat162*>(lo)[1] = l23;
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads)
gemm_f32x3_kernel(const float* __restrict__ A, const float* __restrict__ Wt,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ out,
                  int M, int N, int K, mvt::QSpec q) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* Ah = reinterpret_cast<bf16*>(smem);
  bf16* Al = Ah + kATile;
  bf16* Bh = Al + kATile;
  bf16* Bl = Bh + kBTile;
  float* Es = reinterpret_cast<float*>(Bl + kBTile);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32;  // 4 warps down M
  const int wn = (warp & 1) * 32;   // 2 warps across N

  // the three passes, each summed over all of K: hi.hi, hi.lo, lo.hi
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> hh[2][2], hl[2][2],
      lh[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(hh[i][j], 0.0f);
      wmma::fill_fragment(hl[i][j], 0.0f);
      wmma::fill_fragment(lh[i][j], 0.0f);
    }

  float4 ra[kARegs], rb[kBRegs];
  const int k_tiles = (K + BK - 1) / BK;
  load_step(ra, rb, A, Wt, M, N, K, m0, n0, 0, tid);
  for (int kt = 0; kt < k_tiles; ++kt) {
    __syncthreads();  // every warp is done with the previous step's tiles
#pragma unroll
    for (int i = 0; i < kARegs; ++i) {
      const int c = tid + i * kThreads;
      const int off = (c / (BK / 4)) * LD + (c % (BK / 4)) * 4;
      split4(ra[i], Ah + off, Al + off);
    }
#pragma unroll
    for (int i = 0; i < kBRegs; ++i) {
      const int c = tid + i * kThreads;
      const int off = (c / (BK / 4)) * LD + (c % (BK / 4)) * 4;
      split4(rb[i], Bh + off, Bl + off);
    }
    __syncthreads();
    if (kt + 1 < k_tiles)  // in flight while the tensor cores work
      load_step(ra, rb, A, Wt, M, N, K, m0, n0, (kt + 1) * BK, tid);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          ah[2], al[2];
      // W^T rows (n, k) read as the column-major (K, N) operand
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
          bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ah[i], Ah + (wm + 16 * i) * LD + ks, LD);
        wmma::load_matrix_sync(al[i], Al + (wm + 16 * i) * LD + ks, LD);
        wmma::load_matrix_sync(bh[i], Bh + (wn + 16 * i) * LD + ks, LD);
        wmma::load_matrix_sync(bl[i], Bl + (wn + 16 * i) * LD + ks, LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(hh[i][j], ah[i], bh[j], hh[i][j]);
          wmma::mma_sync(hl[i][j], ah[i], bl[j], hl[i][j]);
          wmma::mma_sync(lh[i][j], al[i], bh[j], lh[i][j]);
        }
    }
  }

  // epilogue, one 16x16 fragment at a time through the warp's staging area;
  // lane handles column (lane & 15) of rows 2t + (lane >> 4)
  float* e_w = Es + warp * 16 * E_LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < hh[i][j].num_elements; ++e)
        hh[i][j].x[e] = __fadd_rn(__fadd_rn(hh[i][j].x[e], hl[i][j].x[e]),
                                  lh[i][j].x[e]);
      wmma::store_matrix_sync(e_w, hh[i][j], E_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int gr = m0 + wm + 16 * i + r;
        const int gc = n0 + wn + 16 * j + c;
        if (gr < M && gc < N) {
          const size_t o = static_cast<size_t>(gr) * N + gc;
          float v = mvt::snap_all(__fadd_rn(e_w[r * E_LD + c], bias[gc]), q);
          if (kEpi == kBiasSnapGeluSnap)
            v = mvt::snap(mvt::snap_all(mvt::gelu_poly(v), q), q);
          else if (kEpi == kBiasSnapResidualSnap)
            v = mvt::snap_all(__fadd_rn(residual[o], v), q);
          out[o] = v;
        }
      }
      __syncwarp();
    }
  }
}

template <int kEpi>
int launch(const void* a, const void* w, const void* bias,
           const void* residual, void* out, int M, int N, int K,
           mvt::QSpec q, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32x3_kernel<kEpi><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<float*>(out), M, N, K, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) fp32 row-major, 16-byte aligned; w the (N, K) fp32 torch weight,
// row-major, 16-byte aligned; bias fp32 (N,); residual fp32 (M, N)
// (epilogue 2); out fp32 (M, N); qspec (exp_bits, man_bits, all_sites)
MVT_EXPORT int mvt_gemm_f32x3(const void* a, const void* w, const void* bias,
                              const void* residual, void* out, int M, int N,
                              int K, int epilogue, int exp_bits, int man_bits,
                              int all_sites, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || bias == nullptr ||
      epilogue < kBiasSnap || epilogue > kBiasSnapResidualSnap ||
      (epilogue == kBiasSnapResidualSnap && residual == nullptr) ||
      !mvt::float_fmt_ok(exp_bits, man_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const mvt::QSpec q(exp_bits, man_bits, all_sites);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kBiasSnap:
      return launch<kBiasSnap>(a, w, bias, residual, out, M, N, K, q, s);
    case kBiasSnapGeluSnap:
      return launch<kBiasSnapGeluSnap>(a, w, bias, residual, out, M, N, K, q,
                                       s);
    default:
      return launch<kBiasSnapResidualSnap>(a, w, bias, residual, out, M, N, K,
                                           q, s);
  }
}
