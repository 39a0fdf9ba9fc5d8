// gemm_f32x3_epilogue: the fp32 products of the float-format and INT8 QAT
// block halves, forward and backward, out[M, N] = epilogue(A[M, K] @ B[K, N]
// (+ bias[N])).
//
// The products inside the TPU block kernels with qspec set (a float format,
// or "int8", the two-pass INT8 QAT variants `fused_attention_block_i8` and
// `fused_mlp_block_i8`)
// (myrtle_vision_tpu/ops/fused_attention_block.py `_qkv_rows`, the output
// projection of `_fwd_kernel` and the products of `_bwd_one_image`;
// myrtle_vision_tpu/ops/fused_mlp.py `fc1`, `fc2` and `_bwd_one_image`):
// fp32 operands through the 3-pass bf16 product of `dot_high3`
// (myrtle_vision_tpu/ops/high_precision.py).  Each operand, the incoming
// gradient included, is split on load, x = hi + lo with hi = bf16(x), lo =
// bf16(x - hi); the three products ah.bh, ah.bl and al.bh each run over the
// whole K on the tensor cores (WMMA 16x16x16, bf16 in, fp32 accumulators:
// every term is exact, only the fp32 sum order is the hardware's), and are
// added as (P1 + P2) + P3, the order of `dot_high3`.  Epilogues, with the
// snap policies of fake_quant.cuh (a float format's qspec = (exp_bits,
// man_bits, all_sites), or PyTorchINT8's frozen observer sites, site0 and
// site1 the epilogue's first and second; each snap the identity under the
// other policy), each rounding in the plain version's order:
//   0  site0(snap_all(P + bias))                             (QKV)
//   1  h = site0(snap_all(P + bias)), site1(snap(snap_all(GELU(h))))
//      (fc1: fc1 act_out, GELU act_out, fc2 act_in; the polynomial erf,
//      exact divide)
//   2  site1(snap_all(residual + site0(snap_all(P + bias))))  (output
//      projection and fc2: act_out, then the residual add's functional site)
//   3  P, no bias, no snap                 (d_o, dxn, dg and the weight
//      gradients; with split K, one partial product per blockIdx.z)
//   4  h = site0(snap_all(P + bias)): site1(snap(snap_all(GELU(h)))) out and
//      GELU'(h) into `aux`     (the backward's fc1 recompute, one erf)
//   5  P * aux, and the fp32 column sums of that per 128-row tile into
//      `colpart`               (dh = dg * GELU'(h), db1)
// Layouts: A is row-major (M, K), or column-major -- the (K, M) activation
// as it is stored, for a weight gradient dW^T = dY^T X -- and B is read as
// the (N, K) torch (out, in) weight row-major (the forward epilogues 0, 1,
// 2, 4: the (in, out) view of the weight) or row-major (K, N) (3 and 5: the
// weight as it is stored, for dX = dY W^T, and an activation for a weight
// gradient); no transposed copy is ever made.
//
// The three passes triple the bf16 tensor-core work of the FP32 format's
// products, so at ViT-S/16 shapes they are compute bound (3 x 2MNK bf16
// operations against 4 (MK + NK + MN) bytes).  Each block of eight warps
// owns a 128x64 output tile (each warp 32x32, with three accumulators per
// fragment) and walks K in 32-deep steps: the next step's fp32 values are
// loaded into registers while the tensor cores work on this one, then
// split into bf16 hi and lo tiles in shared memory.  Ragged edges are
// zero-filled on load and masked on store; a 4-float load runs along K or
// along M / N, so that dimension must be a multiple of 4.  A weight
// gradient has few output tiles (18 at 384x384) and a long K (B*N rows),
// so it splits K over blockIdx.z and the caller sums the partial products
// in a fixed order (no atomics: bitwise reproducible).  wgmma and TMA are
// not used yet.
#include <mma.h>

#include <type_traits>

#include "fake_quant.cuh"

namespace {

using namespace nvcuda;
using mvt::bf16;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int LD = BK + 8;      // row-major A / (N, K) B split tile stride
constexpr int AC_LD = BM + 8;   // column-major A, stored BK x BM
constexpr int BR_LD = BN + 8;   // row-major B, stored BK x BN
constexpr int E_LD = 16 + 4;    // per-warp fp32 staging of one fragment
constexpr int kARegs = BM * BK / 4 / kThreads;  // float4 loads a thread
constexpr int kBRegs = BN * BK / 4 / kThreads;
constexpr int kATile = (BM * LD > BK * AC_LD) ? BM * LD : BK * AC_LD;
constexpr int kBTile = (BN * LD > BK * BR_LD) ? BN * LD : BK * BR_LD;
constexpr size_t kSmemBytes = sizeof(bf16) * 2 * (kATile + kBTile) +
                              sizeof(float) * kWarps * 16 * E_LD +
                              sizeof(float) * 4 * BN;  // column sums

enum Epilogue {
  kBiasSnap = 0,
  kBiasSnapGeluSnap = 1,
  kBiasSnapResidualSnap = 2,
  kF32 = 3,
  kBiasSnapGeluSnapGrad = 4,
  kMulAux = 5,
};

// one 4-float chunk of a (rows, cols) row-major matrix at (r, c), zeros
// outside [0, rows) x [0, cols) (cols % 4 == 0 or c < cols - 3)
__device__ __forceinline__ float4 load4(const float* p, int r, int c,
                                        int rows, int cols, size_t ld) {
  return (r < rows && c < cols)
             ? *reinterpret_cast<const float4*>(p + static_cast<size_t>(r) *
                                                        ld + c)
             : make_float4(0.f, 0.f, 0.f, 0.f);
}

// the next BK-deep step of A (BM rows of M) and B (BN columns of N) into
// registers, 16 bytes a load, K bounded by k_end
template <bool kACol, bool kBRow>
__device__ __forceinline__ void load_step(float4 (&ra)[kARegs],
                                          float4 (&rb)[kBRegs],
                                          const float* A, const float* B,
                                          int M, int N, int K, int k_end,
                                          int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kARegs; ++i) {
    const int c = tid + i * kThreads;
    if (kACol)  // (K, M) stored: rows of K, 4 columns of M
      ra[i] = load4(A, k0 + c / (BM / 4), m0 + (c % (BM / 4)) * 4, k_end, M,
                    M);
    else
      ra[i] = load4(A, m0 + c / (BK / 4), k0 + (c % (BK / 4)) * 4, M, k_end,
                    K);
  }
#pragma unroll
  for (int i = 0; i < kBRegs; ++i) {
    const int c = tid + i * kThreads;
    if (kBRow)  // (K, N) stored: rows of K, 4 columns of N
      rb[i] = load4(B, k0 + c / (BN / 4), n0 + (c % (BN / 4)) * 4, k_end, N,
                    N);
    else  // (N, K) stored
      rb[i] = load4(B, n0 + c / (BK / 4), k0 + (c % (BK / 4)) * 4, N, k_end,
                    K);
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

template <bool kACol, bool kBRow, int kEpi, class Snaps>
__global__ void __launch_bounds__(kThreads)
gemm_f32x3_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ out,
                  float* __restrict__ aux, float* __restrict__ colpart, int M,
                  int N, int K, int k_split, Snaps policy) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* Ah = reinterpret_cast<bf16*>(smem);
  bf16* Al = Ah + kATile;
  bf16* Bh = Al + kATile;
  bf16* Bl = Bh + kBTile;
  float* Es = reinterpret_cast<float*>(Bl + kBTile);
  float* colbuf = Es + kWarps * 16 * E_LD;  // 4 x BN
  using ALayout = typename std::conditional<kACol, wmma::col_major,
                                            wmma::row_major>::type;
  using BLayout = typename std::conditional<kBRow, wmma::row_major,
                                            wmma::col_major>::type;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32;  // 4 warps down M
  const int wn = (warp & 1) * 32;   // 2 warps across N
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

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
  const int k_tiles = (k_end - k_begin + BK - 1) / BK;
  load_step<kACol, kBRow>(ra, rb, A, B, M, N, K, k_end, m0, n0, k_begin,
                          tid);
  for (int kt = 0; kt < k_tiles; ++kt) {
    __syncthreads();  // every warp is done with the previous step's tiles
#pragma unroll
    for (int i = 0; i < kARegs; ++i) {
      const int c = tid + i * kThreads;
      const int off = kACol ? (c / (BM / 4)) * AC_LD + (c % (BM / 4)) * 4
                            : (c / (BK / 4)) * LD + (c % (BK / 4)) * 4;
      split4(ra[i], Ah + off, Al + off);
    }
#pragma unroll
    for (int i = 0; i < kBRegs; ++i) {
      const int c = tid + i * kThreads;
      const int off = kBRow ? (c / (BN / 4)) * BR_LD + (c % (BN / 4)) * 4
                            : (c / (BK / 4)) * LD + (c % (BK / 4)) * 4;
      split4(rb[i], Bh + off, Bl + off);
    }
    __syncthreads();
    if (kt + 1 < k_tiles)  // in flight while the tensor cores work
      load_step<kACol, kBRow>(ra, rb, A, B, M, N, K, k_end, m0, n0,
                              k_begin + (kt + 1) * BK, tid);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> ah[2], al[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // column-major A: element (m, k) at k * AC_LD + m; the (N, K) B read
        // as the column-major (K, N) operand; row-major B: (k, n) at
        // k * BR_LD + n
        const int a_off = kACol ? ks * AC_LD + wm + 16 * i
                                : (wm + 16 * i) * LD + ks;
        const int b_off = kBRow ? ks * BR_LD + wn + 16 * i
                                : (wn + 16 * i) * LD + ks;
        const int a_ld = kACol ? AC_LD : LD;
        const int b_ld = kBRow ? BR_LD : LD;
        wmma::load_matrix_sync(ah[i], Ah + a_off, a_ld);
        wmma::load_matrix_sync(al[i], Al + a_off, a_ld);
        wmma::load_matrix_sync(bh[i], Bh + b_off, b_ld);
        wmma::load_matrix_sync(bl[i], Bl + b_off, b_ld);
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
  // lane handles column (lane & 15) of rows 2t + (lane >> 4); the INT8
  // sites' rows are read here, after the main loop has released its
  // registers
  const auto q = mvt::resolve(policy);
  float* e_w = Es + warp * 16 * E_LD;
  float col_acc[2] = {0.f, 0.f};
  const size_t out_base = static_cast<size_t>(blockIdx.z) * M * N;
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
          float v = e_w[r * E_LD + c];
          if (kEpi == kF32) {
            out[out_base + o] = v;
            continue;
          }
          if (kEpi == kMulAux) {
            v = __fmul_rn(v, aux[o]);
            col_acc[j] += v;
            out[o] = v;
            continue;
          }
          v = mvt::site(mvt::snap_all(__fadd_rn(v, bias[gc]), q), q, 0);
          if (kEpi == kBiasSnapGeluSnap) {
            v = mvt::site(mvt::snap(mvt::snap_all(mvt::gelu_poly(v), q), q),
                          q, 1);
          } else if (kEpi == kBiasSnapGeluSnapGrad) {
            float grad;
            v = mvt::site(
                mvt::snap(mvt::snap_all(mvt::gelu_and_grad_poly(v, &grad), q),
                          q),
                q, 1);
            aux[o] = grad;
          } else if (kEpi == kBiasSnapResidualSnap) {
            v = mvt::site(mvt::snap_all(__fadd_rn(residual[o], v), q), q, 1);
          }
          out[o] = v;
        }
      }
      __syncwarp();
    }
  }
  if (kEpi == kMulAux) {
    // the warp's 32-row sums of its 32 columns, then the four warps that
    // share those columns, in a fixed order
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float s = col_acc[j] + __shfl_xor_sync(0xffffffffu, col_acc[j], 16);
      if (lane < 16) colbuf[(warp >> 1) * BN + wn + 16 * j + lane] = s;
    }
    __syncthreads();
    if (tid < BN && n0 + tid < N)
      colpart[static_cast<size_t>(blockIdx.y) * N + n0 + tid] =
          ((colbuf[tid] + colbuf[BN + tid]) + colbuf[2 * BN + tid]) +
          colbuf[3 * BN + tid];
  }
}

template <bool kACol, bool kBRow, int kEpi, class Snaps = mvt::QSpec>
int launch(dim3 grid, const void* a, const void* b, const void* bias,
           const void* residual, void* out, void* aux, void* colpart, int M,
           int N, int K, int k_split, Snaps q, cudaStream_t stream) {
  gemm_f32x3_kernel<kACol, kBRow, kEpi, Snaps><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<float*>(out), static_cast<float*>(aux),
      static_cast<float*>(colpart), M, N, K, k_split, q);
  return static_cast<int>(cudaGetLastError());
}

// the forward epilogues (0, 1, 2, 4) under snap policy q
template <class Snaps>
int launch_snapping(dim3 grid, int epilogue, const void* a, const void* b,
                    const void* bias, const void* residual, void* out,
                    void* aux, int M, int N, int K, Snaps q,
                    cudaStream_t s) {
  switch (epilogue) {
    case kBiasSnap:
      return launch<false, false, kBiasSnap>(grid, a, b, bias, residual, out,
                                             aux, nullptr, M, N, K, K, q, s);
    case kBiasSnapGeluSnap:
      return launch<false, false, kBiasSnapGeluSnap>(
          grid, a, b, bias, residual, out, aux, nullptr, M, N, K, K, q, s);
    case kBiasSnapResidualSnap:
      return launch<false, false, kBiasSnapResidualSnap>(
          grid, a, b, bias, residual, out, aux, nullptr, M, N, K, K, q, s);
    default:
      return launch<false, false, kBiasSnapGeluSnapGrad>(
          grid, a, b, bias, residual, out, aux, nullptr, M, N, K, K, q, s);
  }
}

}  // namespace

// a (M, K) fp32 row-major, 16-byte aligned; b fp32, 16-byte aligned: the
// (N, K) torch weight row-major for epilogues 0, 1, 2 and 4 (b_row_major
// 0), a row-major (K, N) matrix for 3 and 5 (b_row_major 1); bias fp32 (N,)
// (0, 1, 2, 4); residual fp32 (M, N) (2); aux fp32 (M, N), written by 4 and
// read by 5; colpart fp32 (ceil(M / 128), N) (5); out fp32 (M, N).  The
// snap policy of 0, 1, 2 and 4: site0 (and for 1, 2, 4 site1), (3,) fp32
// rows (scale, zero point, has_stats) of the INT8 site table on the device,
// or site0 null for the float format qspec (exp_bits, man_bits,
// all_sites).  K % 4 == 0, and N % 4 == 0 for a row-major b.
MVT_EXPORT int mvt_gemm_f32x3(const void* a, const void* b, const void* bias,
                              const void* residual, void* out, void* aux,
                              void* colpart, int M, int N, int K,
                              int b_row_major, int epilogue, int exp_bits,
                              int man_bits, int all_sites, const void* site0,
                              const void* site1, void* stream) {
  const bool row_b = epilogue == kF32 || epilogue == kMulAux;
  const bool int8 = site0 != nullptr;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || epilogue < kBiasSnap ||
      epilogue > kMulAux || (b_row_major != 0) != row_b ||
      (row_b && N % 4 != 0) || (!row_b && bias == nullptr) ||
      (epilogue == kBiasSnapResidualSnap && residual == nullptr) ||
      ((epilogue == kBiasSnapGeluSnapGrad || epilogue == kMulAux) &&
       aux == nullptr) ||
      (epilogue == kMulAux && colpart == nullptr) ||
      (int8 && (row_b || (epilogue != kBiasSnap && site1 == nullptr))) ||
      (!int8 && !row_b && !mvt::float_fmt_ok(exp_bits, man_bits)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const mvt::QSpec none(8, 10, 0);  // the unsnapped epilogues read no snap
  if (epilogue == kF32)
    return launch<false, true, kF32>(grid, a, b, bias, residual, out, aux,
                                     colpart, M, N, K, K, none, s);
  if (epilogue == kMulAux)
    return launch<false, true, kMulAux>(grid, a, b, bias, residual, out, aux,
                                        colpart, M, N, K, K, none, s);
  if (int8)
    return launch_snapping(
        grid, epilogue, a, b, bias, residual, out, aux, M, N, K,
        mvt::Int8Sites{static_cast<const float*>(site0),
                       static_cast<const float*>(site1)},
        s);
  return launch_snapping(grid, epilogue, a, b, bias, residual, out, aux, M, N,
                         K, mvt::QSpec(exp_bits, man_bits, all_sites), s);
}

// Weight gradient: out = A^T-stored x B, i.e. A stored (K, M) row-major and
// B (K, N) row-major, K ragged, fp32 out, no epilogue.  K is split into
// chunks of k_split rows (a multiple of 32); chunk z writes out[z] of
// (splits, M, N).  M % 4 == 0 and N % 4 == 0.
MVT_EXPORT int mvt_gemm_f32x3_at(const void* a, const void* b, void* out,
                                 int M, int N, int K, int k_split,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 4 != 0 || N % 4 != 0 ||
      k_split <= 0 || k_split % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM,
                  (K + k_split - 1) / k_split);
  return launch<true, true, kF32>(grid, a, b, nullptr, nullptr, out, nullptr,
                                  nullptr, M, N, K, k_split,
                                  mvt::QSpec(8, 10, 0),
                                  static_cast<cudaStream_t>(stream));
}
