// attention_core_f32: the fp32 softmax attention core of the converted-INT8
// attention block, ending on the int8 grid of the next observer site, and
// of the float-format and INT8 QAT attention blocks, ending on their snap.
//
// The per-head loop of the TPU kernels `_attn_kernel`
// (myrtle_vision_tpu/ops/fused_int8_block.py; the same ops as
// multi_head_attention's xla path, myrtle_vision_tpu/ops/attention.py) and
// `_attn_heads_fwd` with qspec set, followed by the to_out.act_in snap of
// `_fwd_kernel` (myrtle_vision_tpu/ops/fused_attention_block.py).
// Input qkv (B, N, 3C) fp32, feature order [3][h][d]; output (B, N, C),
// head h at columns h*D...  For each query row:
//   s   = (qh.kh + qh.kl) + ql.kh, times scale AFTER the product
//   p   = exp(s - rowmax(s)) / rowsum          true fp32 divide
//   ctx = (ph.vh + ph.vl) + pl.vh
//   int8 mode:  out = clip(rint(ctx / s2) + zp2, 0, 255) - 128, int8
//               (site 2, quant_out)
//   snap mode:  out = site0(snap(ctx)), fp32, under a snap policy of
//               fake_quant.cuh: a float format's FloatingPoint(exp, man)
//               snap (the pre_linear site of the projection), or INT8
//               QAT's affine site snap with the quant_out observer's frozen
//               row (`_snap_int8` of `_fwd_kernel`, qspec "int8");
//               when the caller records for the backward, also the rowmax
//               m and rs = 1 / rowsum (a true divide) of each query row,
//               (B, H, N) fp32, as `_attn_heads_fwd` returns them (null
//               pointers, as inference passes, write nothing)
// where x = xh + xl splits an fp32 value into two bf16 values, xh =
// bf16(x), xl = bf16(x - xh): the 3-pass products of the JAX package
// (ops/high_precision.py dot_high3), each pass an exact bf16 product
// summed in fp32 on the tensor cores (WMMA 16x16x16), the passes added in
// the plain version's order.  Without statistics at site 2 the output
// grid has scale 1 and zero point 128 (the guard of `_quantize_i8`).
//
// One block of four warps per (image, head) holds the hi and lo halves of
// K and V (rows padded to a multiple of 16, zero-filled) in shared memory;
// each warp takes a 16-query tile at a time.  A warp's fp32 buffer holds
// the tile's Q halves while their fragments load, then the scores, then
// P's hi and lo halves (the two halves of each fp32 score slot's row),
// then the context.  The three passes triple the tensor-core work of a
// bf16 core: at ViT-S/16 and batch 256 the core is ~46 GFLOP of bf16
// products, well under the projections around it; what bounds this
// design is shared-memory traffic and the fp32 softmax between the two
// products, and the four warps that the shared memory leaves room for.
#include <mma.h>

#include "fake_quant.cuh"

namespace {

using namespace nvcuda;
using mvt::bf16;

constexpr int kWarps = 4;
constexpr int kMaxN = 256;
constexpr int kMaxI = kMaxN / 32;  // score columns per lane

template <int D>
struct Layout {
  static constexpr int KLD = D + 8;  // padded bf16 rows of K and V halves
  // key rows; fp32 row stride of a warp's 16-row buffer, a multiple of 16
  // so that P's lo half (sld bf16 into a row) starts 32-byte aligned
  int n_pad, sld;
  __host__ __device__ explicit Layout(int n)
      : n_pad((n + 15) / 16 * 16),
        sld(((n + 15) / 16 * 16 > D ? (n + 15) / 16 * 16 : D) + 16) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(bf16) * 4 * static_cast<size_t>(n_pad) * KLD +
           sizeof(float) * kWarps * 16 * static_cast<size_t>(sld);
  }
};

__device__ __forceinline__ void split(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(h)));
}

// kSnap: fp32 out through the snap policy `policy`; else int8 out on the
// grid of `site`
template <int D, bool kSnap, class Snaps>
__global__ void __launch_bounds__(kWarps * 32)
attention_core_f32_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ site,
                          void* __restrict__ out, float* __restrict__ m_out,
                          float* __restrict__ rs_out, int N, int heads,
                          float scale, Snaps policy) {
  constexpr int KLD = Layout<D>::KLD;
  constexpr int KT = D / 16;
  const Layout<D> lay(N);
  const int n_pad = lay.n_pad, sld = lay.sld;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kh = reinterpret_cast<bf16*>(smem);  // n_pad x KLD each
  bf16* Kl = Kh + n_pad * KLD;
  bf16* Vh = Kl + n_pad * KLD;
  bf16* Vl = Vh + n_pad * KLD;
  float* Ss = reinterpret_cast<float*>(Vl + n_pad * KLD);  // kWarps x 16 x sld

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const float* base = qkv + static_cast<size_t>(b) * N * row_stride + h * D;
  float s_out = 1.0f, zp_out = 128.0f;
  if (!kSnap && site[2] > 0.5f) {
    s_out = site[0];
    zp_out = site[1];
  }

  for (int c = tid; c < n_pad * D; c += blockDim.x) {
    const int j = c / D, d = c % D;
    float kf = 0.f, vf = 0.f;
    if (j < N) {
      const float* row = base + static_cast<size_t>(j) * row_stride + d;
      kf = row[C];
      vf = row[2 * C];
    }
    split(kf, &Kh[j * KLD + d], &Kl[j * KLD + d]);
    split(vf, &Vh[j * KLD + d], &Vl[j * KLD + d]);
  }
  __syncthreads();

  float* s_w = Ss + warp * 16 * sld;
  bf16* p_w = reinterpret_cast<bf16*>(s_w);  // row r: hi at 2r*sld, lo + sld
  bf16* qh_w = p_w;                          // 16 x KLD, then the lo half
  bf16* ql_w = p_w + 16 * KLD;
  const int n_tiles = n_pad / 16;

  for (int q0 = warp * 16; q0 < N; q0 += kWarps * 16) {
    for (int c = lane; c < 16 * D; c += 32) {
      const int i = c / D, d = c % D;
      const float v =
          (q0 + i < N) ? base[static_cast<size_t>(q0 + i) * row_stride + d]
                       : 0.f;
      split(v, &qh_w[i * KLD + d], &ql_w[i * KLD + d]);
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qh[KT],
        ql[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      wmma::load_matrix_sync(qh[k], qh_w + k * 16, KLD);
      wmma::load_matrix_sync(ql[k], ql_w + k * 16, KLD);
    }
    __syncwarp();  // the scores overwrite the Q halves

    for (int nt = 0; nt < n_tiles; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hh, hl, lh;
      wmma::fill_fragment(hh, 0.0f);
      wmma::fill_fragment(hl, 0.0f);
      wmma::fill_fragment(lh, 0.0f);
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        // K row-major (key, d) read as the column-major K^T operand
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kh,
            kl;
        wmma::load_matrix_sync(kh, Kh + nt * 16 * KLD + k * 16, KLD);
        wmma::load_matrix_sync(kl, Kl + nt * 16 * KLD + k * 16, KLD);
        wmma::mma_sync(hh, qh[k], kh, hh);
        wmma::mma_sync(hl, qh[k], kl, hl);
        wmma::mma_sync(lh, ql[k], kh, lh);
      }
#pragma unroll
      for (int e = 0; e < hh.num_elements; ++e)
        hh.x[e] = __fmul_rn(__fadd_rn(__fadd_rn(hh.x[e], hl.x[e]), lh.x[e]),
                            scale);
      wmma::store_matrix_sync(s_w + nt * 16, hh, sld, wmma::mem_row_major);
    }
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const float* srow = s_w + r * sld;
      float s[kMaxI];
      float m = mvt::neg_inf();
#pragma unroll
      for (int i = 0; i < kMaxI; ++i) {
        const int j = lane + 32 * i;
        s[i] = (j < N) ? srow[j] : mvt::neg_inf();
        m = fmaxf(m, s[i]);
      }
      m = mvt::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxI; ++i) {
        const int j = lane + 32 * i;
        s[i] = (j < N) ? expf(__fsub_rn(s[i], m)) : 0.f;
        sum = __fadd_rn(sum, s[i]);
      }
      sum = mvt::warp_sum(sum);
      if (kSnap && m_out != nullptr && lane == 0 && q0 + r < N) {
        const size_t o = static_cast<size_t>(blockIdx.x) * N + q0 + r;
        m_out[o] = m;
        rs_out[o] = __fdiv_rn(1.0f, sum);
      }
      __syncwarp();  // the row is read in full before P overwrites it
      bf16* prow = p_w + r * 2 * sld;
#pragma unroll
      for (int i = 0; i < kMaxI; ++i) {
        const int j = lane + 32 * i;
        if (j < n_pad) split(s[i] / sum, &prow[j], &prow[sld + j]);
      }
    }
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> u[KT][3];
#pragma unroll
    for (int dt = 0; dt < KT; ++dt)
#pragma unroll
      for (int t = 0; t < 3; ++t) wmma::fill_fragment(u[dt][t], 0.0f);
    for (int kt = 0; kt < n_tiles; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ph,
          pl;
      wmma::load_matrix_sync(ph, p_w + kt * 16, 2 * sld);
      wmma::load_matrix_sync(pl, p_w + sld + kt * 16, 2 * sld);
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vh,
            vl;
        wmma::load_matrix_sync(vh, Vh + kt * 16 * KLD + dt * 16, KLD);
        wmma::load_matrix_sync(vl, Vl + kt * 16 * KLD + dt * 16, KLD);
        wmma::mma_sync(u[dt][0], ph, vh, u[dt][0]);
        wmma::mma_sync(u[dt][1], ph, vl, u[dt][1]);
        wmma::mma_sync(u[dt][2], pl, vh, u[dt][2]);
      }
    }
    __syncwarp();  // every P read is done before the context overwrites it
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
#pragma unroll
      for (int e = 0; e < u[dt][0].num_elements; ++e)
        u[dt][0].x[e] =
            __fadd_rn(__fadd_rn(u[dt][0].x[e], u[dt][1].x[e]), u[dt][2].x[e]);
      wmma::store_matrix_sync(s_w + dt * 16, u[dt][0], D, wmma::mem_row_major);
    }
    __syncwarp();
    const auto q = mvt::resolve(policy);
    for (int c = lane; c < 16 * D; c += 32) {
      const int i = c / D, d = c % D;
      if (q0 + i < N) {
        const size_t o = (static_cast<size_t>(b) * N + q0 + i) * C + h * D + d;
        if (kSnap) {
          static_cast<float*>(out)[o] = mvt::site(mvt::snap(s_w[c], q), q, 0);
        } else {
          const float q = fminf(
              fmaxf(__fadd_rn(rintf(s_w[c] / s_out), zp_out), 0.f), 255.f);
          static_cast<signed char*>(out)[o] =
              static_cast<signed char>(static_cast<int>(q) - 128);
        }
      }
    }
    __syncwarp();  // the buffer is rewritten by the next tile
  }
}

template <int D, bool kSnap, class Snaps>
int launch(const void* qkv, const void* site, void* out, void* m, void* rs,
           int B, int N, int heads, float scale, Snaps policy,
           cudaStream_t stream) {
  const size_t smem = Layout<D>(N).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_f32_kernel<D, kSnap, Snaps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_core_f32_kernel<D, kSnap, Snaps>
      <<<B * heads, kWarps * 32, smem, stream>>>(
          static_cast<const float*>(qkv), static_cast<const float*>(site),
          out, static_cast<float*>(m), static_cast<float*>(rs), N, heads,
          scale, policy);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSnap, class Snaps>
int launch_d(const void* qkv, const void* site, void* out, void* m, void* rs,
             int B, int N, int heads, int D, float scale, Snaps policy,
             cudaStream_t stream) {
  if (B <= 0 || heads <= 0 || N <= 0 || N > kMaxN ||
      (m == nullptr) != (rs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch<64, kSnap>(qkv, site, out, m, rs, B, N, heads, scale,
                             policy, stream);
  if (D == 32)
    return launch<32, kSnap>(qkv, site, out, m, rs, B, N, heads, scale,
                             policy, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

MVT_EXPORT int mvt_attention_core_f32_max_n() { return kMaxN; }

// qkv (B, N, 3C) fp32; site the (scale, zero point, has_stats) fp32 row of
// the output grid; out (B, N, C) int8
MVT_EXPORT int mvt_attention_core_f32(const void* qkv, const void* site,
                                      void* out, int B, int N, int heads,
                                      int D, float scale, void* stream) {
  if (site == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_d<false>(qkv, site, out, nullptr, nullptr, B, N, heads, D,
                         scale, mvt::QSpec(8, 22, 0),
                         static_cast<cudaStream_t>(stream));
}

// qkv (B, N, 3C) fp32; out (B, N, C) fp32, the context through the snap
// policy: site, the (3,) fp32 row (scale, zero point, has_stats) of the
// INT8 site table on the device, or null for the FloatingPoint(exp_bits,
// man_bits) snap; m and rs (B, H, N) fp32, the rowmax and reciprocal
// rowsum, or both null
MVT_EXPORT int mvt_attention_core_f32_snap(const void* qkv, void* out,
                                           void* m, void* rs, int B, int N,
                                           int heads, int D, float scale,
                                           int exp_bits, int man_bits,
                                           const void* site, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (site != nullptr)
    return launch_d<true>(
        qkv, nullptr, out, m, rs, B, N, heads, D, scale,
        mvt::Int8Sites{static_cast<const float*>(site), nullptr}, s);
  if (!mvt::float_fmt_ok(exp_bits, man_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_d<true>(qkv, nullptr, out, m, rs, B, N, heads, D, scale,
                        mvt::QSpec(exp_bits, man_bits, 0), s);
}
